// Flash attention with the decomposed relative-position bias, forward.
//
// Replaces: tfimm_tpu/ops/pallas/flash_attention_relpos.py ·
// _relpos_forward_call and _relpos_forward_call_paired (the Pallas TPU
// kernels; the paired one packs two heads into the 128 lanes and computes
// the same function). Per row b of (B, N, d), B = images * heads, N = gh*gw:
//
//     s[i, c] = qs_i . k_c + (rh[i, c / gw] + rw[i, c % gw])        (f32)
//     online softmax with a running max m (from -1e30), row sum l (f32)
//     o = (sum_c p.astype(io) v_c) / max(l, 1e-30)     (f32 sums, rounded once)
//     lse = m + log(max(l, 1e-30))                                    (f32)
//
// qs arrives scaled and rounded to the io dtype (the wrapper scales it, as
// the JAX package scales q outside its kernel); rh (B, N, gh) and rw
// (B, N, gw) are the decomposed bias terms in the io dtype. The bias tile
// of a key tile is rebuilt from them: the (B, N, N) scores and bias never
// reach device memory. Unlike the other attention kernels of this package
// the softmax is exact: no clamp at 80, a running max instead.
//
// Two kernels, one per io dtype; both take one thread block per (64 query
// rows, row b) and stream K and V through shared memory in 64-key tiles.
// The rel terms of the block's 64 query rows are staged in shared memory
// once, in the io dtype, with a row stride chosen so that the 8 rows a warp
// reads at once fall in different banks.
//
// - bf16 (the serving path): tensor cores through mma.sync m16n8k16 (bf16
//   in, f32 accumulate), as in fused_mha.cu. 4 warps, each owning 16 query
//   rows, keep their q fragments in registers for the whole key loop. A
//   warp adds the bias to its 16 x 64 score tile in registers, takes the
//   tile's row maxima across the 4 lanes of a row, rescales its output
//   accumulator and row sums by exp(m_old - m_new), and feeds the bf16
//   probabilities straight back to the tensor cores as the A operand of
//   p @ v (the accumulator layout of two 8-key score tiles is the A layout
//   of one 16-key step).
// - f32: exact f32 FMAs (TF32 would not hold the f32 results to 1e-5). 256
//   threads as a 16 x 16 grid, each owning 4 query rows x 4 keys of a score
//   tile and 4 query rows x up to 8 head columns of the output.
//
// What bounds it on an H100: at SAM-B's global blocks (B = 12 heads of one
// image, N = 4096, d = 64) one call reads 18.9 MB and writes 6.5 MB but does
// 4 * B * N^2 * d = 51.5 GFLOP: about 2000 flops per byte, far above the
// card's ~295 flops/byte ridge, so an ideal kernel is bounded by the tensor
// cores, at about 52 us at 989 TFLOP/s. This simple form is not near that:
// synchronous tile loads (no cp.async or TMA pipelining), mma.sync rather
// than wgmma, and a per-element integer division for the bias index. At the
// windowed blocks (N = 196, 300 rows per image) the bound is bytes, about
// 10 us per image, and N rounds up to 256 keys (23% of the products are
// padding).
//
// Shared memory (bf16): 27.6 KB of tiles at d = 64 and 52.2 KB at d = 128,
// plus 0.25 KB per grid column of gh and gw (16.9 KB at gh = gw = 64). Above
// the 48 KB static limit a launch needs the dynamic limit raised, so the
// launcher sets cudaFuncAttributeMaxDynamicSharedMemorySize before every
// launch and returns cudaGetLastError() after it.
//
// Coverage: any B (launched in slices of 65535 rows), any N = gh * gw
// (ragged tails masked), gh and gw up to 128, every head dim d that is a
// multiple of 8 up to 128 (the bf16 kernel pads d to a multiple of 16 in
// shared memory with zeros). q, k and v are read through their batch and
// row strides (bf16: 16-byte aligned rows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;               // query rows per block
constexpr int kBlockK = 64;               // keys per shared-memory tile
constexpr int kMaxHeadDim = 128;
constexpr int kMaxGridSide = 128;
constexpr int kMaxRowsPerLaunch = 65535;  // gridDim.y
constexpr float kNegInf = -1e30f;         // the running max's start
constexpr float kMinSum = 1e-30f;

struct Strides {
  int64_t q_b, q_n, k_b, k_n, v_b, v_n;
};

// Row stride, in elements, of a staged rel-term tile with `cols` columns:
// an odd number of 32-bit words, so 8 consecutive rows start in 8 banks.
template <typename T>
__host__ __device__ inline int rel_ld(int cols) {
  if (sizeof(T) == 4) return cols | 1;
  return cols + ((2 - cols % 4) + 4) % 4;   // cols = 2 (mod 4)
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The rel terms of query rows [q0, q0 + 64) of one row b into shared
// memory; rows at or beyond n become zeros.
template <typename T>
__device__ __forceinline__ void load_rel(const T* __restrict__ src, T* dst,
                                         int q0, int n, int cols, int ld,
                                         int nthreads) {
  for (int i = threadIdx.x; i < kBlockQ * cols; i += nthreads) {
    const int r = i / cols, c = i - r * cols;
    const int row = q0 + r;
    dst[r * ld + c] = row < n ? src[(int64_t)row * cols + c] : T(0.f);
  }
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

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 values in one register, the lower column (or k index) in the
// low half, as the mma fragments expect.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <int DP>
__host__ __device__ constexpr int mma_ld() { return DP + 8; }  // padded smem row

template <int DP>
size_t mma_smem_bytes(int gh, int gw) {
  return sizeof(__nv_bfloat16) *
         ((size_t)(kBlockQ + 2 * kBlockK) * mma_ld<DP>() +
          (size_t)kBlockQ * (rel_ld<__nv_bfloat16>(gh) +
                             rel_ld<__nv_bfloat16>(gw)));
}

// Rows [r0, r0 + 64) of one row's q, k or v into shared memory, 16 bytes
// per load; rows at or beyond n and columns at or beyond d become zeros.
template <int DP>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src,
                                          __nv_bfloat16* dst, int r0, int n,
                                          int d, int64_t row_stride) {
  constexpr int kChunks = DP / 8;
  for (int i = threadIdx.x; i < kBlockQ * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int row = r0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < n && c < d)
      v = *reinterpret_cast<const uint4*>(src + (int64_t)row * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * mma_ld<DP>() + c) = v;
  }
}

// DP: the head dim rounded up to a multiple of 16 (the mma k depth).
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
relpos_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, Strides st,
                       const __nv_bfloat16* __restrict__ rh,
                       const __nv_bfloat16* __restrict__ rw,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                       int n, int d, int gh, int gw, int b0) {
  constexpr int LD = mma_ld<DP>();
  constexpr int kSteps = DP / 16;          // k steps of q @ k^T
  constexpr int kDimTiles = DP / 8;        // 8-column tiles of the output
  constexpr int kKeyTiles = kBlockK / 8;   // 8-key tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kBlockQ * LD;
  __nv_bfloat16* v_s = k_s + kBlockK * LD;
  const int ldh = rel_ld<__nv_bfloat16>(gh), ldw = rel_ld<__nv_bfloat16>(gw);
  __nv_bfloat16* rh_s = v_s + kBlockK * LD;
  __nv_bfloat16* rw_s = rh_s + kBlockQ * ldh;

  const int q0 = blockIdx.x * kBlockQ;
  const int64_t b = (int64_t)b0 + blockIdx.y;
  const __nv_bfloat16* q_g = q + b * st.q_b;
  const __nv_bfloat16* k_g = k + b * st.k_b;
  const __nv_bfloat16* v_g = v + b * st.v_b;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                  // fragment row group
  const int t = lane % 4;                  // thread in group
  const int wr = warp * 16;                // this warp's first row in the tile
  const bool active = q0 + wr < n;
  const int r_lo = wr + g, r_hi = r_lo + 8;

  load_tile<DP>(q_g, q_s, q0, n, d, st.q_n);
  load_rel(rh + b * n * gh, rh_s, q0, n, gh, ldh, kMmaThreads);
  load_rel(rw + b * n * gw, rw_s, q0, n, gw, ldw, kMmaThreads);

  uint32_t qf[kSteps][4];
  float o[kDimTiles][4];
#pragma unroll
  for (int j = 0; j < kDimTiles; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[j][r] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf;    // rows g and g + 8
  float l_lo = 0.f, l_hi = 0.f;            // this lane's share of the sums

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // previous tile fully read (and q_s, rh_s, rw_s written)
    load_tile<DP>(k_g, k_s, k0, n, d, st.k_n);
    load_tile<DP>(v_g, v_s, k0, n, d, st.v_n);
    __syncthreads();
    if (!active) continue;
    if (k0 == 0) {
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const __nv_bfloat16* p = q_s + r_lo * LD + ks * 16 + 2 * t;
        qf[ks][0] = ld_u32(p);
        qf[ks][1] = ld_u32(p + 8 * LD);
        qf[ks][2] = ld_u32(p + 8);
        qf[ks][3] = ld_u32(p + 8 * LD + 8);
      }
    }

    float s[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        const __nv_bfloat16* p = k_s + (8 * j + g) * LD + ks * 16 + 2 * t;
        mma_16816(s[j], qf[ks], ld_u32(p), ld_u32(p + 8));
      }
    }

    // The bias of each key column from its (kh, kw) grid index; keys at or
    // beyond n get -1e30 (and below, p = 0). Then the tile's row maxima.
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        if (key < n) {
          const int kh = key / gw, kw = key - kh * gw;
          s[j][e] += to_f32(rh_s[r_lo * ldh + kh]) + to_f32(rw_s[r_lo * ldw + kw]);
          s[j][2 + e] +=
              to_f32(rh_s[r_hi * ldh + kh]) + to_f32(rw_s[r_hi * ldw + kw]);
        } else {
          s[j][e] = kNegInf;
          s[j][2 + e] = kNegInf;
        }
        mx_lo = fmaxf(mx_lo, s[j][e]);
        mx_hi = fmaxf(mx_hi, s[j][2 + e]);
      }
    }
    // Each row is spread over the 4 lanes of its group.
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
        const __nv_bfloat16* p = v_s + (16 * mk + 2 * t) * LD + 8 * jd + g;
        mma_16816(o[jd], pf[mk], pack_bf16(p[0], p[LD]),
                  pack_bf16(p[8 * LD], p[9 * LD]));
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
  __nv_bfloat16* o_lo = out + (b * n + row_lo) * d;
  __nv_bfloat16* o_hi = o_lo + 8 * (int64_t)d;
#pragma unroll
  for (int jd = 0; jd < kDimTiles; ++jd) {
    const int c = 8 * jd + 2 * t;
    if (c >= d) break;
    if (row_lo < n)
      *reinterpret_cast<__nv_bfloat162*>(o_lo + c) =
          __floats2bfloat162_rn(o[jd][0] / l_lo, o[jd][1] / l_lo);
    if (row_hi < n)
      *reinterpret_cast<__nv_bfloat162*>(o_hi + c) =
          __floats2bfloat162_rn(o[jd][2] / l_hi, o[jd][3] / l_hi);
  }
  if (t == 0) {
    if (row_lo < n) lse[b * n + row_lo] = m_lo + logf(l_lo);
    if (row_hi < n) lse[b * n + row_hi] = m_hi + logf(l_hi);
  }
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, Strides st,
                const void* rh, const void* rw, void* out, void* lse,
                int batch, int n, int d, int gh, int gw, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<DP>(gh, gw);
  cudaError_t err = cudaFuncSetAttribute(
      relpos_fwd_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < batch; b0 += kMaxRowsPerLaunch) {
    const dim3 grid((n + kBlockQ - 1) / kBlockQ,
                    batch - b0 < kMaxRowsPerLaunch ? batch - b0
                                                   : kMaxRowsPerLaunch);
    relpos_fwd_bf16_kernel<DP><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), st,
        static_cast<const __nv_bfloat16*>(rh),
        static_cast<const __nv_bfloat16*>(rw),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), n, d, gh,
        gw, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int dispatch_bf16(const void* q, const void* k, const void* v, Strides st,
                  const void* rh, const void* rw, void* out, void* lse,
                  int batch, int n, int d, int gh, int gw, cudaStream_t s) {
#define TFIMM_RELPOS_BF16(DP) \
  launch_bf16<DP>(q, k, v, st, rh, rw, out, lse, batch, n, d, gh, gw, s)
  switch ((d + 15) / 16) {
    case 1: return TFIMM_RELPOS_BF16(16);
    case 2: return TFIMM_RELPOS_BF16(32);
    case 3: return TFIMM_RELPOS_BF16(48);
    case 4: return TFIMM_RELPOS_BF16(64);
    case 5: return TFIMM_RELPOS_BF16(80);
    case 6: return TFIMM_RELPOS_BF16(96);
    case 7: return TFIMM_RELPOS_BF16(112);
    case 8: return TFIMM_RELPOS_BF16(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TFIMM_RELPOS_BF16
}

// ---------------------------------------------------------------------------
// f32: FMA

constexpr int kFmaThreads = 256;          // 16 x 16
constexpr int kRows = kBlockQ / 16;       // query rows per thread
constexpr int kKeys = kBlockK / 16;       // keys per thread in a score tile
constexpr int kCols = kMaxHeadDim / 16;   // output columns per thread (max)

size_t fma_smem_bytes(int d, int gh, int gw) {
  const int ld = d + 1;
  return sizeof(float) *
         ((size_t)kBlockQ * ld + 2 * (size_t)kBlockK * ld +
          (size_t)kBlockQ * (kBlockK + 1) +
          (size_t)kBlockQ * (rel_ld<float>(gh) + rel_ld<float>(gw)));
}

__global__ void __launch_bounds__(kFmaThreads)
relpos_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, Strides st,
                      const float* __restrict__ rh,
                      const float* __restrict__ rw, float* __restrict__ out,
                      float* __restrict__ lse, int n, int d, int gh, int gw,
                      int b0) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int ldp = kBlockK + 1;
  const int ldh = rel_ld<float>(gh), ldw = rel_ld<float>(gw);
  float* q_s = smem;                  // kBlockQ x ld
  float* k_s = q_s + kBlockQ * ld;    // kBlockK x ld
  float* v_s = k_s + kBlockK * ld;    // kBlockK x ld
  float* p_s = v_s + kBlockK * ld;    // kBlockQ x ldp
  float* rh_s = p_s + kBlockQ * ldp;  // kBlockQ x ldh
  float* rw_s = rh_s + kBlockQ * ldh; // kBlockQ x ldw

  const int q0 = blockIdx.x * kBlockQ;
  const int64_t b = (int64_t)b0 + blockIdx.y;
  const float* q_g = q + b * st.q_b;
  const float* k_g = k + b * st.k_b;
  const float* v_g = v + b * st.v_b;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  for (int i = tid; i < kBlockQ * d; i += kFmaThreads) {
    const int r = i / d, c = i % d;
    const int row = q0 + r;
    q_s[r * ld + c] = row < n ? q_g[(int64_t)row * st.q_n + c] : 0.f;
  }
  load_rel(rh + b * n * gh, rh_s, q0, n, gh, ldh, kFmaThreads);
  load_rel(rw + b * n * gw, rw_s, q0, n, gw, ldw, kFmaThreads);

  float acc[kRows][kCols];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // previous tile fully read (and q_s, rh_s, rw_s written)
    for (int i = tid; i < kBlockK * d; i += kFmaThreads) {
      const int r = i / d, c = i % d;
      const int row = k0 + r;
      const bool ok = row < n;
      k_s[r * ld + c] = ok ? k_g[(int64_t)row * st.k_n + c] : 0.f;
      v_s[r * ld + c] = ok ? v_g[(int64_t)row * st.v_n + c] : 0.f;
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

    // The bias, the tile's row maxima (over the 16 tx lanes of a
    // half-warp), the rescale and the probabilities.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int key = k0 + tx + 16 * j;
        if (key < n) {
          const int kh = key / gw, kw = key - kh * gw;
          s[i][j] += rh_s[r * ldh + kh] + rw_s[r * ldw + kw];
        } else {
          s[i][j] = kNegInf;
        }
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
        const int key = k0 + tx + 16 * j;
        const float e = key < n ? expf(s[i][j] - mn) : 0.f;
        ps += e;
        p_s[r * ldp + tx + 16 * j] = e;
      }
      l[i] = l[i] * alpha + ps;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += p @ v for rows ty + 16 i and head columns tx + 16 j.
    const int kmax = min(kBlockK, n - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_s[(ty + 16 * i) * ldp + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
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

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
    float* o = out + (b * n + row) * d;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 16 * j;
      if (c < d) o[c] = acc[i][j] / l[i];
    }
    if (tx == 0) lse[b * n + row] = m[i] + logf(l[i]);
  }
}

int launch_f32(const void* q, const void* k, const void* v, Strides st,
               const void* rh, const void* rw, void* out, void* lse,
               int batch, int n, int d, int gh, int gw, cudaStream_t stream) {
  const size_t smem = fma_smem_bytes(d, gh, gw);
  cudaError_t err = cudaFuncSetAttribute(
      relpos_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < batch; b0 += kMaxRowsPerLaunch) {
    const dim3 grid((n + kBlockQ - 1) / kBlockQ,
                    batch - b0 < kMaxRowsPerLaunch ? batch - b0
                                                   : kMaxRowsPerLaunch);
    relpos_fwd_f32_kernel<<<grid, kFmaThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), st, static_cast<const float*>(rh),
        static_cast<const float*>(rw), static_cast<float*>(out),
        static_cast<float*>(lse), n, d, gh, gw, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns a
// cudaError_t value (0 = ok).
extern "C" int tfimm_flash_attention_relpos_fwd(
    const void* q, const void* k, const void* v, int64_t q_sb, int64_t q_sn,
    int64_t k_sb, int64_t k_sn, int64_t v_sb, int64_t v_sn, const void* rh,
    const void* rw, void* out, void* lse, int batch, int n, int head_dim,
    int gh, int gw, int dtype, void* stream) {
  if (batch <= 0 || n <= 0 || head_dim <= 0 || head_dim % 8 != 0 ||
      head_dim > kMaxHeadDim || gh <= 0 || gw <= 0 || gh > kMaxGridSide ||
      gw > kMaxGridSide || n != gh * gw)
    return (int)cudaErrorInvalidValue;
  const Strides st{q_sb, q_sn, k_sb, k_sn, v_sb, v_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_f32(q, k, v, st, rh, rw, out, lse, batch, n, head_dim, gh,
                        gw, s);
    case 1: {
      const int64_t strides[6] = {q_sb, q_sn, k_sb, k_sn, v_sb, v_sn};
      for (int64_t x : strides)
        if (x % 8 != 0) return (int)cudaErrorMisalignedAddress;
      const void* ptrs[3] = {q, k, v};
      for (const void* p : ptrs)
        if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
          return (int)cudaErrorMisalignedAddress;
      return dispatch_bf16(q, k, v, st, rh, rw, out, lse, batch, n, head_dim,
                           gh, gw, s);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
