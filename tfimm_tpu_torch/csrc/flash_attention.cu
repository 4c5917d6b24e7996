// Flash attention, forward.
//
// Replaces: tfimm_tpu/ops/pallas/flash_attention_kernel.py ·
// _flash_forward_call (the Pallas TPU kernel behind flash_attention). Per
// row b of B = images * heads, with q, k, v (N, d):
//
//     s[i, c] = qs_i . k_c                         (f32; keys >= N: -1e30)
//     online softmax with a running max m (from -1e30), row sum l (f32)
//     o = (sum_c p.astype(io) v_c) / max(l, 1e-30)     (f32 sums, rounded once)
//     lse = m + log(max(l, 1e-30))                                    (f32)
//
// qs arrives scaled and rounded to the io dtype (the wrapper scales it, as
// the JAX package scales q outside its kernel). The softmax is exact: no
// clamp at 80, a running max instead. The (N, N) scores never reach device
// memory.
//
// Row b of the kernel is (b / heads, b % heads) of a (B, H, N, d) view, and
// every operand is read or written through its own three strides (image,
// head, token), so that the attention layer hands over q, k and v as views
// of its packed (B, N, 3 * H * d) projection and takes o as (B, N, H * d):
// no head transpose and no copy. A plain (B, N, d) operand is H = 1.
//
// Two kernels, one per io dtype; both take one thread block per (64 query
// rows, row b) and stream K and V through shared memory in 64-key tiles.
//
// - bf16 (the serving path): tensor cores through mma.sync m16n8k16 (bf16
//   in, f32 accumulate), as in flash_attention_relpos.cu without the bias.
//   4 warps, each owning 16 query rows; up to d = 128 a warp keeps its q
//   fragments in registers for the whole key loop. A warp takes its 16 x 64
//   score tile's row maxima across the 4 lanes of a row, rescales its
//   output accumulator and row sums by exp(m_old - m_new), and feeds the
//   bf16 probabilities straight back to the tensor cores as the A operand
//   of p @ v (the accumulator layout of two 8-key score tiles is the A
//   layout of one 16-key step). Above d = 128 the 16 x d f32 accumulator
//   would need 128 registers a thread beside the scores: there each block
//   writes half of the head columns (gridDim.z = 2), recomputing the scores
//   from the whole d, and reads its q fragments from shared memory.
// - f32: exact f32 FMAs (TF32 would not hold the f32 results to 1e-5). 256
//   threads as a 16 x 16 grid, each owning 4 query rows x 4 keys of a score
//   tile and 4 query rows x up to 8 (16 above d = 128) head columns of o.
//
// What bounds it on an H100: at ViT-B/16 on 512x512 images (B = 64 images
// x 12 heads, N = 1025, d = 64) one call does 4 * B * N^2 * d = 206.6 GFLOP
// and moves 403 MB (q, k, v read, o written, the lse): about 510 flops per
// byte, above the card's ~295 flops/byte ridge, so an ideal kernel is
// bounded by the tensor cores, at 0.209 ms at 989 TFLOP/s. This simple form
// is not near that: synchronous tile loads (no cp.async or TMA pipelining)
// and mma.sync rather than wgmma. N = 1025 is 16 full 64-key tiles and one
// key: the last tile is 98% padding, about 6% of the products.
//
// Shared memory (bf16): 27.6 KB at d = 64, 52.2 KB at d = 128 and 85.0 KB
// at d = 256; (f32) 66.6 KB at d = 64, up to 214.0 KB at d = 256. Above the
// 48 KB static limit a launch needs the dynamic limit raised, so the
// launcher sets cudaFuncAttributeMaxDynamicSharedMemorySize before every
// launch and returns cudaGetLastError() after it.
//
// Coverage: any B (launched in slices of 65535 rows), any N (ragged tails
// masked), every head dim d that is a multiple of 8 up to 256 (the bf16
// kernel pads d to a multiple of 16 in shared memory with zeros). bf16
// operands need 16-byte aligned rows (strides a multiple of 8 elements).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockQ = 64;               // query rows per block
constexpr int kBlockK = 64;               // keys per shared-memory tile
constexpr int kMaxHeadDim = 256;
constexpr int kMaxRowsPerLaunch = 65535;  // gridDim.y
constexpr float kNegInf = -1e30f;         // the running max's start
constexpr float kMinSum = 1e-30f;

// Strides, in elements, of one (B, H, N, d) operand (d has stride 1).
struct Rows {
  int64_t b, h, n;
};

struct Layout {
  Rows q, k, v, o;
};

// The offset of row b = (b / heads, b % heads) of an operand.
__device__ __forceinline__ int64_t row_base(const Rows& r, int64_t b,
                                            int heads) {
  return (b / heads) * r.b + (b % heads) * r.h;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync)

constexpr int kMmaThreads = 128;          // 4 warps x 16 query rows

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 values in one register, the lower column (or k index) in the
// low half, as the mma fragments expect.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// DP: the head dim rounded up to a multiple of 16 (the mma k depth); DH:
// the head columns of o a block writes (DP, or DP / 2 above 128).
template <int DP, int DH>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * ((size_t)(kBlockQ + kBlockK) * (DP + 8) +
                         (size_t)kBlockK * (DH + 8));
}

// Rows [r0, r0 + 64) and columns [0, COLS) of one operand into shared
// memory (row stride COLS + 8), 16 bytes per load; rows at or beyond n and
// columns at or beyond d become zeros.
template <int COLS>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src,
                                          bf16* dst, int r0, int n, int d,
                                          int64_t row_stride) {
  constexpr int kChunks = COLS / 8;
  for (int i = threadIdx.x; i < kBlockQ * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int row = r0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < n && c < d)
      v = *reinterpret_cast<const uint4*>(src + (int64_t)row * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * (COLS + 8) + c) = v;
  }
}

template <int DP, int DH>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, Layout L,
                      bf16* __restrict__ out, float* __restrict__ lse, int n,
                      int d, int heads, int b0) {
  constexpr int LDP = DP + 8;
  constexpr int LDH = DH + 8;
  constexpr int kSteps = DP / 16;          // k steps of q @ k^T
  constexpr int kDimTiles = DH / 8;        // 8-column tiles of the output
  constexpr int kKeyTiles = kBlockK / 8;   // 8-key tiles of a score tile
  constexpr bool kQInRegs = DP <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kBlockQ * LDP;
  bf16* v_s = k_s + kBlockK * LDP;

  const int q0 = blockIdx.x * kBlockQ;
  const int64_t b = (int64_t)b0 + blockIdx.y;
  const int c0 = blockIdx.z * DH;          // this block's first head column
  const bf16* q_g = q + row_base(L.q, b, heads);
  const bf16* k_g = k + row_base(L.k, b, heads);
  const bf16* v_g = v + row_base(L.v, b, heads) + c0;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                  // fragment row group
  const int t = lane % 4;                  // thread in group
  const int wr = warp * 16;                // this warp's first row in the tile
  const bool active = q0 + wr < n;
  const int r_lo = wr + g, r_hi = r_lo + 8;

  load_tile<DP>(q_g, q_s, q0, n, d, L.q.n);

  uint32_t qf[kQInRegs ? kSteps : 1][4];
  float o[kDimTiles][4];
#pragma unroll
  for (int j = 0; j < kDimTiles; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[j][r] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf;    // rows g and g + 8
  float l_lo = 0.f, l_hi = 0.f;            // this lane's share of the sums

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // previous tile fully read (and q_s written)
    load_tile<DP>(k_g, k_s, k0, n, d, L.k.n);
    load_tile<DH>(v_g, v_s, k0, n, d - c0, L.v.n);
    __syncthreads();
    if (!active) continue;
    if constexpr (kQInRegs) {
      if (k0 == 0) {
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          const bf16* p = q_s + r_lo * LDP + ks * 16 + 2 * t;
          qf[ks][0] = ld_u32(p);
          qf[ks][1] = ld_u32(p + 8 * LDP);
          qf[ks][2] = ld_u32(p + 8);
          qf[ks][3] = ld_u32(p + 8 * LDP + 8);
        }
      }
    }

    float s[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qf[ks][r];
      } else {
        const bf16* p = q_s + r_lo * LDP + ks * 16 + 2 * t;
        a[0] = ld_u32(p);
        a[1] = ld_u32(p + 8 * LDP);
        a[2] = ld_u32(p + 8);
        a[3] = ld_u32(p + 8 * LDP + 8);
      }
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        const bf16* p = k_s + (8 * j + g) * LDP + ks * 16 + 2 * t;
        mma_16816(s[j], a, ld_u32(p), ld_u32(p + 8));
      }
    }

    // Keys at or beyond n get -1e30 (and below, p = 0); then the tile's
    // row maxima, each row spread over the 4 lanes of its group.
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (k0 + 8 * j + 2 * t + e >= n) {
          s[j][e] = kNegInf;
          s[j][2 + e] = kNegInf;
        }
        mx_lo = fmaxf(mx_lo, s[j][e]);
        mx_hi = fmaxf(mx_hi, s[j][2 + e]);
      }
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float a_lo = expf(m_lo - mn_lo), a_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;

    uint32_t pf[kKeyTiles / 2][4];
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      const int key = k0 + 8 * j + 2 * t;
      const bool ok0 = key < n, ok1 = key + 1 < n;
      const float e0 = ok0 ? expf(s[j][0] - mn_lo) : 0.f;
      const float e1 = ok1 ? expf(s[j][1] - mn_lo) : 0.f;
      const float e2 = ok0 ? expf(s[j][2] - mn_hi) : 0.f;
      const float e3 = ok1 ? expf(s[j][3] - mn_hi) : 0.f;
      ps_lo += e0 + e1;
      ps_hi += e2 + e3;
      pf[j / 2][(j % 2) * 2 + 0] = pack_bf16(e0, e1);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(e2, e3);
    }
    l_lo = l_lo * a_lo + ps_lo;
    l_hi = l_hi * a_hi + ps_hi;
#pragma unroll
    for (int jd = 0; jd < kDimTiles; ++jd) {
      o[jd][0] *= a_lo;
      o[jd][1] *= a_lo;
      o[jd][2] *= a_hi;
      o[jd][3] *= a_hi;
    }

#pragma unroll
    for (int mk = 0; mk < kKeyTiles / 2; ++mk) {
      if (k0 + 16 * mk >= n) break;        // all 16 keys are padding
#pragma unroll
      for (int jd = 0; jd < kDimTiles; ++jd) {
        const bf16* p = v_s + (16 * mk + 2 * t) * LDH + 8 * jd + g;
        mma_16816(o[jd], pf[mk], pack_bf16(p[0], p[LDH]),
                  pack_bf16(p[8 * LDH], p[9 * LDH]));
      }
    }
  }
  if (!active) return;

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  l_lo = fmaxf(l_lo, kMinSum);
  l_hi = fmaxf(l_hi, kMinSum);
  const int row_lo = q0 + r_lo, row_hi = q0 + r_hi;
  bf16* o_lo = out + row_base(L.o, b, heads) + (int64_t)row_lo * L.o.n + c0;
  bf16* o_hi = o_lo + 8 * L.o.n;
#pragma unroll
  for (int jd = 0; jd < kDimTiles; ++jd) {
    const int c = 8 * jd + 2 * t;
    if (c0 + c >= d) break;
    if (row_lo < n)
      *reinterpret_cast<__nv_bfloat162*>(o_lo + c) =
          __floats2bfloat162_rn(o[jd][0] / l_lo, o[jd][1] / l_lo);
    if (row_hi < n)
      *reinterpret_cast<__nv_bfloat162*>(o_hi + c) =
          __floats2bfloat162_rn(o[jd][2] / l_hi, o[jd][3] / l_hi);
  }
  if (t == 0 && blockIdx.z == 0) {
    if (row_lo < n) lse[b * n + row_lo] = m_lo + logf(l_lo);
    if (row_hi < n) lse[b * n + row_hi] = m_hi + logf(l_hi);
  }
}

template <int DP, int DH>
int launch_bf16(const void* q, const void* k, const void* v, const Layout& L,
                void* out, void* lse, int batch, int n, int d, int heads,
                cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<DP, DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<DP, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < batch; b0 += kMaxRowsPerLaunch) {
    const dim3 grid((n + kBlockQ - 1) / kBlockQ,
                    batch - b0 < kMaxRowsPerLaunch ? batch - b0
                                                   : kMaxRowsPerLaunch,
                    DP / DH);
    flash_fwd_bf16_kernel<DP, DH><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), L, static_cast<bf16*>(out),
        static_cast<float*>(lse), n, d, heads, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int dispatch_bf16(const void* q, const void* k, const void* v,
                  const Layout& L, void* out, void* lse, int batch, int n,
                  int d, int heads, cudaStream_t s) {
#define TFIMM_FLASH_BF16(DP, DH) \
  launch_bf16<DP, DH>(q, k, v, L, out, lse, batch, n, d, heads, s)
  switch ((d + 15) / 16) {
    case 1: return TFIMM_FLASH_BF16(16, 16);
    case 2: return TFIMM_FLASH_BF16(32, 32);
    case 3: return TFIMM_FLASH_BF16(48, 48);
    case 4: return TFIMM_FLASH_BF16(64, 64);
    case 5: return TFIMM_FLASH_BF16(80, 80);
    case 6: return TFIMM_FLASH_BF16(96, 96);
    case 7: return TFIMM_FLASH_BF16(112, 112);
    case 8: return TFIMM_FLASH_BF16(128, 128);
    case 9: return TFIMM_FLASH_BF16(144, 72);
    case 10: return TFIMM_FLASH_BF16(160, 80);
    case 11: return TFIMM_FLASH_BF16(176, 88);
    case 12: return TFIMM_FLASH_BF16(192, 96);
    case 13: return TFIMM_FLASH_BF16(208, 104);
    case 14: return TFIMM_FLASH_BF16(224, 112);
    case 15: return TFIMM_FLASH_BF16(240, 120);
    case 16: return TFIMM_FLASH_BF16(256, 128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TFIMM_FLASH_BF16
}

// ---------------------------------------------------------------------------
// f32: FMA

constexpr int kFmaThreads = 256;          // 16 x 16
constexpr int kRows = kBlockQ / 16;       // query rows per thread
constexpr int kKeys = kBlockK / 16;       // keys per thread in a score tile

size_t fma_smem_bytes(int d) {
  return sizeof(float) * ((size_t)(kBlockQ + 2 * kBlockK) * (d + 1) +
                          (size_t)kBlockQ * (kBlockK + 1));
}

// KC: head columns of o per thread (8 up to d = 128, 16 above).
template <int KC>
__global__ void __launch_bounds__(kFmaThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, Layout L,
                     float* __restrict__ out, float* __restrict__ lse, int n,
                     int d, int heads, int b0) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int ldp = kBlockK + 1;
  float* q_s = smem;                  // kBlockQ x ld
  float* k_s = q_s + kBlockQ * ld;    // kBlockK x ld
  float* v_s = k_s + kBlockK * ld;    // kBlockK x ld
  float* p_s = v_s + kBlockK * ld;    // kBlockQ x ldp

  const int q0 = blockIdx.x * kBlockQ;
  const int64_t b = (int64_t)b0 + blockIdx.y;
  const float* q_g = q + row_base(L.q, b, heads);
  const float* k_g = k + row_base(L.k, b, heads);
  const float* v_g = v + row_base(L.v, b, heads);

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  for (int i = tid; i < kBlockQ * d; i += kFmaThreads) {
    const int r = i / d, c = i % d;
    const int row = q0 + r;
    q_s[r * ld + c] = row < n ? q_g[(int64_t)row * L.q.n + c] : 0.f;
  }

  float acc[kRows][KC];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < KC; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // previous tile fully read (and q_s written)
    for (int i = tid; i < kBlockK * d; i += kFmaThreads) {
      const int r = i / d, c = i % d;
      const int row = k0 + r;
      const bool ok = row < n;
      k_s[r * ld + c] = ok ? k_g[(int64_t)row * L.k.n + c] : 0.f;
      v_s[r * ld + c] = ok ? v_g[(int64_t)row * L.v.n + c] : 0.f;
    }
    __syncthreads();

    // Scores for rows ty + 16 i and keys tx + 16 j of this tile.
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_s[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = k_s[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // The tile's row maxima (over the 16 tx lanes of a half-warp), the
    // rescale and the probabilities; keys at or beyond n get -1e30, p = 0.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        if (k0 + tx + 16 * j >= n) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      m[i] = mn;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float e = k0 + tx + 16 * j < n ? expf(s[i][j] - mn) : 0.f;
        ps += e;
        p_s[r * ldp + tx + 16 * j] = e;
      }
      l[i] = l[i] * alpha + ps;
#pragma unroll
      for (int j = 0; j < KC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += p @ v for rows ty + 16 i and head columns tx + 16 j.
    const int kmax = min(kBlockK, n - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_s[(ty + 16 * i) * ldp + kk];
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int c = tx + 16 * j;
        if (c < d) {
          const float vv = v_s[kk * ld + c];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    l[i] = fmaxf(l[i], kMinSum);
  }

  float* o_b = out + row_base(L.o, b, heads);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
    float* o = o_b + (int64_t)row * L.o.n;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const int c = tx + 16 * j;
      if (c < d) o[c] = acc[i][j] / l[i];
    }
    if (tx == 0) lse[b * n + row] = m[i] + logf(l[i]);
  }
}

template <int KC>
int launch_f32(const void* q, const void* k, const void* v, const Layout& L,
               void* out, void* lse, int batch, int n, int d, int heads,
               cudaStream_t stream) {
  const size_t smem = fma_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < batch; b0 += kMaxRowsPerLaunch) {
    const dim3 grid((n + kBlockQ - 1) / kBlockQ,
                    batch - b0 < kMaxRowsPerLaunch ? batch - b0
                                                   : kMaxRowsPerLaunch);
    flash_fwd_f32_kernel<KC><<<grid, kFmaThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), L, static_cast<float*>(out),
        static_cast<float*>(lse), n, d, heads, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// q, k, v and out are (B, H, N, d) operands given by their pointers and the
// 12 strides of `strides` (elements; image, head and token strides of q,
// k, v, out in turn; d has stride 1); lse is a contiguous f32 (B * H, N).
// batch = B * H. dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t
// value (0 = ok).
extern "C" int tfimm_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         const int64_t* strides, int batch,
                                         int heads, int n, int head_dim,
                                         int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || batch % heads != 0 || n <= 0 ||
      head_dim <= 0 || head_dim % 8 != 0 || head_dim > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  const Layout L{{strides[0], strides[1], strides[2]},
                 {strides[3], strides[4], strides[5]},
                 {strides[6], strides[7], strides[8]},
                 {strides[9], strides[10], strides[11]}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return head_dim <= 128
                 ? launch_f32<8>(q, k, v, L, out, lse, batch, n, head_dim,
                                 heads, s)
                 : launch_f32<16>(q, k, v, L, out, lse, batch, n, head_dim,
                                  heads, s);
    case 1: {
      for (int i = 0; i < 9; ++i)   // q, k, v: 16-byte loads
        if (strides[i] % 8 != 0) return (int)cudaErrorMisalignedAddress;
      for (int i = 9; i < 12; ++i)  // out: 4-byte stores
        if (strides[i] % 2 != 0) return (int)cudaErrorMisalignedAddress;
      const void* ptrs[3] = {q, k, v};
      for (const void* p : ptrs)
        if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
          return (int)cudaErrorMisalignedAddress;
      if (reinterpret_cast<uintptr_t>(out) % 4 != 0)
        return (int)cudaErrorMisalignedAddress;
      return dispatch_bf16(q, k, v, L, out, lse, batch, n, head_dim, heads, s);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
