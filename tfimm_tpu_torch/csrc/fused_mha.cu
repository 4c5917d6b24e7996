// Fused multi-head attention forward, straight from the packed qkv projection.
//
// Replaces: tfimm_tpu/ops/pallas/fused_mha.py · fused_mha (the Pallas TPU
// kernel). Same function: qkv (B, N, 3*D) with the last dim in timm's
// (3, H, d) order -> out (B, N, D) with the heads already concatenated, so
// it feeds the output projection directly. Per head:
//
//     s = (q_f32 * scale) @ k_f32^T                 (f32)
//     p = exp(min(s, 80)) / rowsum                  (clamped no-max softmax)
//     o = p.astype(io) @ v, accumulated in f32
//
// q, k and v are read in place out of the packed rows (row stride 3*D) and
// the output is written in place into (B, N, D): no transposes, no
// contiguous copies, and the (B, H, N, N) scores never reach device memory.
//
// Normalisation order: p is rounded to the io dtype BEFORE it is divided by
// the row sum (the reference divides first). Because the softmax subtracts
// no running max, key tiles accumulate exp(min(s, 80)) @ v and the row sum
// directly, with no online rescale, and one division at the end. This
// changes bf16 rounding only; in f32 the two orders agree to rounding. The
// row sum is taken over the unrounded f32 exponentials. Masked keys (the
// ragged edge of N) add exactly 0 to both sums. The unnormalised
// accumulator holds at most N * e^80 * max|v|, finite while
// N * max|v| < 6e3 on rows that saturate the clamp.
//
// Two kernels, one per io dtype; both take one thread block per (64 query
// rows, head, batch row) and stream K and V through shared memory in
// 64-key tiles.
//
// - bf16 (the serving path): tensor cores through mma.sync m16n8k16 (bf16
//   in, f32 accumulate). 4 warps, each owning 16 query rows. A warp keeps
//   its q fragments in registers for the whole key loop, computes its
//   16 x 64 score tile, exponentiates it in registers, and reuses those
//   registers as the A operand of p @ v (the accumulator layout of two
//   adjacent 8-key score tiles is the A layout of one 16-key step), so p
//   never touches shared memory. q . k is exact in f32 per product; the
//   scale is applied to the f32 score, which differs from scaling q first
//   by f32 rounding only. Shared memory rows are padded by 8 elements so
//   the fragment loads are free of bank conflicts.
// - f32: plain f32 FMAs (the tensor cores' TF32 would not hold the f32
//   results to 1e-5). 256 threads as a 16 x 16 grid, each owning 4 query
//   rows x 4 keys of a score tile and 4 query rows x up to 8 head columns
//   of the output; tiles kept as f32 with a padded row stride (d + 1).
//
// What bounds it on an H100: at ViT-B/16 (B = 128, N = 197, H = 12, d = 64)
// one call reads 116 MB of qkv, writes 39 MB and does 4 * B * H * N^2 * d =
// 15.3 GFLOP, about 100 flops per byte: under the card's ~295 flops/byte
// ridge for bf16 tensor cores, so an ideal kernel is bounded by device
// memory, at about 46 us at 3.35 TB/s. This
// simple form is not there yet: each block loads its K/V tiles once per 64
// query rows with plain synchronous loads (no cp.async/TMA pipelining), and
// N = 197 rounds up to 256 rows and keys (23% of the products are padding;
// warps whose 16 rows all lie beyond N skip their products). The f32 kernel
// is bounded by shared-memory loads feeding the FMA units.
//
// Shared memory: bf16 27.6 KB at d = 64 and 52.2 KB at d = 128; f32 66.5 KB
// at d = 64 and 115.7 KB at d = 128. Above the 48 KB static limit a launch
// needs the dynamic limit raised, so the launcher sets
// cudaFuncAttributeMaxDynamicSharedMemorySize before every launch and
// returns cudaGetLastError() after it.
//
// Coverage: any B, any N (ragged edge masked), any H, and every head dim d
// that is a multiple of 8 up to 128 (the bf16 kernel pads d to a multiple
// of 16 in shared memory with zeros). bf16 needs qkv 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;               // query rows per block
constexpr int kBlockK = 64;               // keys per shared-memory tile
constexpr int kMaxHeadDim = 128;
constexpr float kSoftmaxClamp = 80.0f;    // dispatch.py SOFTMAX_CLAMP

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
__host__ __device__ constexpr int mma_ld() { return DP + 8; }  // padded smem row, bf16 elements

template <int DP>
size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(kBlockQ + 2 * kBlockK) * mma_ld<DP>();
}

// Rows [r0, r0 + 64) of one head's q, k or v into shared memory, 16 bytes
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
fused_mha_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ qkv,
                          __nv_bfloat16* __restrict__ out, int n,
                          int nb_heads, int d, float scale) {
  constexpr int LD = mma_ld<DP>();
  constexpr int kSteps = DP / 16;          // k steps of q @ k^T
  constexpr int kDimTiles = DP / 8;        // 8-column tiles of the output
  constexpr int kKeyTiles = kBlockK / 8;   // 8-key tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kBlockQ * LD;
  __nv_bfloat16* v_s = k_s + kBlockK * LD;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int dim = nb_heads * d;
  const int64_t row_stride = 3 * (int64_t)dim;
  const __nv_bfloat16* q_g = qkv + (int64_t)b * n * row_stride + (int64_t)h * d;
  const __nv_bfloat16* k_g = q_g + dim;
  const __nv_bfloat16* v_g = q_g + 2 * dim;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                  // fragment row group
  const int t = lane % 4;                  // thread in group
  const int wr = warp * 16;                // this warp's first row in the tile
  const bool active = q0 + wr < n;

  load_tile<DP>(q_g, q_s, q0, n, d, row_stride);

  uint32_t qf[kSteps][4];
  float o[kDimTiles][4];
#pragma unroll
  for (int j = 0; j < kDimTiles; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[j][r] = 0.f;
  float l_lo = 0.f, l_hi = 0.f;            // rows g and g + 8

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // previous tile fully read (and q_s written)
    load_tile<DP>(k_g, k_s, k0, n, d, row_stride);
    load_tile<DP>(v_g, v_s, k0, n, d, row_stride);
    __syncthreads();
    if (!active) continue;
    if (k0 == 0) {
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const __nv_bfloat16* p = q_s + (wr + g) * LD + ks * 16 + 2 * t;
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

    // exp(min(scale * s, 80)) in f32; keys at or beyond n give 0. The
    // accumulator layout of score tiles 2m and 2m + 1 is the A layout of
    // the m-th 16-key step of p @ v.
    uint32_t pf[kKeyTiles / 2][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      const int key = k0 + 8 * j + 2 * t;
      const bool ok0 = key < n, ok1 = key + 1 < n;
      const float e0 = ok0 ? expf(fminf(s[j][0] * scale, kSoftmaxClamp)) : 0.f;
      const float e1 = ok1 ? expf(fminf(s[j][1] * scale, kSoftmaxClamp)) : 0.f;
      const float e2 = ok0 ? expf(fminf(s[j][2] * scale, kSoftmaxClamp)) : 0.f;
      const float e3 = ok1 ? expf(fminf(s[j][3] * scale, kSoftmaxClamp)) : 0.f;
      l_lo += e0 + e1;
      l_hi += e2 + e3;
      pf[j / 2][(j % 2) * 2 + 0] = pack_bf16(e0, e1);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(e2, e3);
    }

#pragma unroll
    for (int m = 0; m < kKeyTiles / 2; ++m) {
      if (k0 + 16 * m >= n) break;         // all 16 keys are padding
#pragma unroll
      for (int jd = 0; jd < kDimTiles; ++jd) {
        const __nv_bfloat16* p = v_s + (16 * m + 2 * t) * LD + 8 * jd + g;
        mma_16816(o[jd], pf[m], pack_bf16(p[0], p[LD]),
                  pack_bf16(p[8 * LD], p[9 * LD]));
      }
    }
  }
  if (!active) return;

  // Each row's sum is spread over the 4 lanes of its group.
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  const int row_lo = q0 + wr + g, row_hi = row_lo + 8;
  __nv_bfloat16* o_lo = out + ((int64_t)b * n + row_lo) * dim + (int64_t)h * d;
  __nv_bfloat16* o_hi = o_lo + 8 * (int64_t)dim;
#pragma unroll
  for (int jd = 0; jd < kDimTiles; ++jd) {
    const int c = 8 * jd + 2 * t;
    if (c >= d) break;
    if (row_lo < n)
      *reinterpret_cast<__nv_bfloat162*>(o_lo + c) =
          __floats2bfloat162_rn(o[jd][0] * inv_lo, o[jd][1] * inv_lo);
    if (row_hi < n)
      *reinterpret_cast<__nv_bfloat162*>(o_hi + c) =
          __floats2bfloat162_rn(o[jd][2] * inv_hi, o[jd][3] * inv_hi);
  }
}

template <int DP>
int launch_bf16(const void* qkv, void* out, int batch, int n, int nb_heads,
                int d, float scale, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_mha_fwd_bf16_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, nb_heads, batch);
  fused_mha_fwd_bf16_kernel<DP><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
      n, nb_heads, d, scale);
  return (int)cudaGetLastError();
}

int dispatch_bf16(const void* qkv, void* out, int batch, int n, int nb_heads,
                  int d, float scale, cudaStream_t s) {
  switch ((d + 15) / 16) {
    case 1: return launch_bf16<16>(qkv, out, batch, n, nb_heads, d, scale, s);
    case 2: return launch_bf16<32>(qkv, out, batch, n, nb_heads, d, scale, s);
    case 3: return launch_bf16<48>(qkv, out, batch, n, nb_heads, d, scale, s);
    case 4: return launch_bf16<64>(qkv, out, batch, n, nb_heads, d, scale, s);
    case 5: return launch_bf16<80>(qkv, out, batch, n, nb_heads, d, scale, s);
    case 6: return launch_bf16<96>(qkv, out, batch, n, nb_heads, d, scale, s);
    case 7: return launch_bf16<112>(qkv, out, batch, n, nb_heads, d, scale, s);
    case 8: return launch_bf16<128>(qkv, out, batch, n, nb_heads, d, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// f32: FMA

constexpr int kFmaThreads = 256;          // 16 x 16
constexpr int kRows = kBlockQ / 16;       // query rows per thread
constexpr int kKeys = kBlockK / 16;       // keys per thread in a score tile
constexpr int kCols = kMaxHeadDim / 16;   // output columns per thread (max)

size_t fma_smem_bytes(int d) {
  const int ld = d + 1;
  return sizeof(float) *
         (size_t)(kBlockQ * ld + 2 * kBlockK * ld + kBlockQ * (kBlockK + 1));
}

__global__ void __launch_bounds__(kFmaThreads)
fused_mha_fwd_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                         int n, int nb_heads, int d, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int ldp = kBlockK + 1;
  float* q_s = smem;                  // kBlockQ x ld, pre-scaled
  float* k_s = q_s + kBlockQ * ld;    // kBlockK x ld
  float* v_s = k_s + kBlockK * ld;    // kBlockK x ld
  float* p_s = v_s + kBlockK * ld;    // kBlockQ x ldp

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int dim = nb_heads * d;
  const int64_t row_stride = 3 * (int64_t)dim;
  const float* q_g = qkv + (int64_t)b * n * row_stride + (int64_t)h * d;
  const float* k_g = q_g + dim;
  const float* v_g = q_g + 2 * dim;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  for (int i = tid; i < kBlockQ * d; i += kFmaThreads) {
    const int r = i / d, c = i % d;
    const int row = q0 + r;
    q_s[r * ld + c] = row < n ? q_g[(int64_t)row * row_stride + c] * scale : 0.f;
  }

  float acc[kRows][kCols];
  float l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // previous tile fully read (and q_s written)
    for (int i = tid; i < kBlockK * d; i += kFmaThreads) {
      const int r = i / d, c = i % d;
      const int row = k0 + r;
      const bool ok = row < n;
      const int64_t off = (int64_t)row * row_stride + c;
      k_s[r * ld + c] = ok ? k_g[off] : 0.f;
      v_s[r * ld + c] = ok ? v_g[off] : 0.f;
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
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int key = k0 + tx + 16 * j;
        const float e = key < n ? expf(fminf(s[i][j], kSoftmaxClamp)) : 0.f;
        l[i] += e;
        p_s[(ty + 16 * i) * ldp + tx + 16 * j] = e;
      }
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

  // Each row's sum is spread over the 16 tx lanes of one half-warp.
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
    const float inv = 1.f / l[i];
    float* o = out + ((int64_t)b * n + row) * dim + (int64_t)h * d;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 16 * j;
      if (c < d) o[c] = acc[i][j] * inv;
    }
  }
}

int launch_f32(const void* qkv, void* out, int batch, int n, int nb_heads,
               int d, float scale, cudaStream_t stream) {
  const size_t smem = fma_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mha_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, nb_heads, batch);
  fused_mha_fwd_f32_kernel<<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), n, nb_heads, d,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value (0 = ok).
extern "C" int tfimm_fused_mha_fwd(const void* qkv, void* out, int batch,
                                   int n, int nb_heads, int head_dim,
                                   float scale, int dtype, void* stream) {
  if (batch <= 0 || n <= 0 || nb_heads <= 0 || head_dim <= 0 ||
      head_dim % 8 != 0 || head_dim > kMaxHeadDim || batch > 65535 ||
      nb_heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_f32(qkv, out, batch, n, nb_heads, head_dim, scale, s);
    case 1:
      if (reinterpret_cast<uintptr_t>(qkv) % 16 != 0)
        return (int)cudaErrorMisalignedAddress;
      return dispatch_bf16(qkv, out, batch, n, nb_heads, head_dim, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
