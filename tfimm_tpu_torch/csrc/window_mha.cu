// Windowed multi-head attention with the relative-position bias and the
// shifted-window mask (Swin).
//
// Replaces: tfimm_tpu/ops/pallas/window_mha.py · window_mha (the Pallas TPU
// kernel). Same function: q, k, v (BW, N, C) with BW = batch * nb_windows
// (the window index inner), C = H * d, bias (H, N, N) f32, an optional
// additive mask (nW, N, N) f32 applied to window row r as mask[r % nW].
// Per window and head:
//
//     s = (q_f32 * scale) @ k_f32^T + bias[h] (+ mask[r % nW])     (f32)
//     p = exp(min(s, 80)) / rowsum                  (clamped no-max softmax)
//     o = p.astype(io) @ v, summed in f32, rounded once to the io dtype
//
// A whole row of keys (N <= 144) fits one tile, so each row's sum is taken
// before p is rounded: p is normalised first and then rounded, as the TPU
// kernel and the plain version do (unlike fused_mha.cu, which streams keys
// and rounds the unnormalised exponentials).
//
// q, k and v are read with their own batch and row strides, so the three
// slices of a packed (BW, N, 3C) qkv need no copy; the output is written
// contiguous, (BW, N, C), with the heads concatenated.
//
// Two kernels, one per io dtype, each with one thread block per (window,
// head):
//
// - bf16: tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate).
//   q, k, v of the window's head are stored in shared memory with N padded
//   to NP (32, 64 or 144) rows and d padded to DP (16, 32, 64 or 128)
//   columns with zeros. 4 warps, each owning 16-row query tiles in turn: the
//   warp computes the 16 x NP score tile in registers, adds the bias and the
//   mask in f32, exponentiates, sums each row over the lanes of its group,
//   normalises, and reuses the registers as the A operand of p @ v (the
//   accumulator layout of two adjacent 8-key score tiles is the A layout of
//   one 16-key step). Pad keys are left out of the row sum (their p is 0)
//   and pad query rows are not stored. q . k is exact in f32 per product;
//   the scale multiplies the f32 score, which differs from scaling q first
//   by f32 rounding only.
// - f32: plain f32 FMAs (TF32 would miss the 1e-5 bar). k and v in shared
//   memory with a padded row (d + 1); one warp per query row in turn, the
//   lanes over keys for the scores and over head columns for p @ v.
//
// What bounds it on an H100: at Swin-T's stage 4 (BW = 128 windows at batch
// 128, N = 49, C = 768, H = 24, no mask) one call reads 28.9 MB of q, k, v,
// 0.23 MB of bias and writes 9.6 MB, against 4 * BW * H * N^2 * d = 0.94
// GFLOP: under 25 flops a byte, so device memory bounds it (about 11.5 us at
// 3.35 TB/s). This first form loads each block's tiles with plain
// synchronous loads and reads the bias (and the mask) from L2 per block;
// N = 49 pads to 64 rows and keys (41% of the products are padding).
//
// Coverage: any BW, N <= 144, any H, d a multiple of 8 up to 128, any
// strides whose last dimension is 1. 16-byte loads when every base and
// stride allow them, element loads otherwise. Every launch is followed by
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;             // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr float kSoftmaxClamp = 80.0f;    // dispatch.py SOFTMAX_CLAMP
constexpr int kMaxN = 144;
constexpr int kMaxHeadDim = 128;

struct WinArgs {
  const void* q;
  const void* k;
  const void* v;
  int64_t q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;  // batch and row strides
  const float* bias;   // (H, N, N)
  const float* mask;   // (nW, N, N) or null
  void* out;           // (BW, N, H * d)
  int n, nb_heads, d, nb_win;
  float scale;
  int vec;             // 16-byte loads allowed
};

// s + bias (+ mask) for score (row, col) of window w, head h; both < n.
__device__ __forceinline__ float biased(const WinArgs& a, int w, int h,
                                        int row, int col, float s) {
  const int64_t nn = (int64_t)a.n * a.n;
  const int64_t rc = (int64_t)row * a.n + col;
  s += __ldg(a.bias + h * nn + rc);
  if (a.mask != nullptr) s += __ldg(a.mask + (w % a.nb_win) * nn + rc);
  return s;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync)

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

template <int DP, int NP>
size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * 3 * (size_t)NP * mma_ld<DP>();
}

// The window's rows of one head of q, k or v into shared memory (NP x DP);
// rows at or beyond n and columns at or beyond d become zeros.
template <int DP, int NP>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src,
                                          int64_t row_stride,
                                          __nv_bfloat16* dst, int n, int d,
                                          int vec) {
  constexpr int kChunks = DP / 8;
  for (int i = threadIdx.x; i < NP * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r < n && c < d) {
      const __nv_bfloat16* p = src + (int64_t)r * row_stride + c;
      if (vec) {
        u = *reinterpret_cast<const uint4*>(p);
      } else {
        unsigned short e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = __bfloat16_as_ushort(p[j]);
        u = make_uint4(e[0] | ((uint32_t)e[1] << 16), e[2] | ((uint32_t)e[3] << 16),
                       e[4] | ((uint32_t)e[5] << 16), e[6] | ((uint32_t)e[7] << 16));
      }
    }
    *reinterpret_cast<uint4*>(dst + r * mma_ld<DP>() + c) = u;
  }
}

// DP: d rounded up (16, 32, 64, 128); NP: N rounded up (32, 64, 144).
template <int DP, int NP>
__global__ void __launch_bounds__(kThreads)
window_mha_bf16_kernel(WinArgs a) {
  constexpr int LD = mma_ld<DP>();
  constexpr int kSteps = DP / 16;          // k steps of q @ k^T
  constexpr int kDimTiles = DP / 8;        // 8-column tiles of the output
  constexpr int kKeyTiles = NP / 8;        // 8-key tiles of a score row
  constexpr int kRowTiles = NP / 16;       // 16-row query tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + NP * LD;
  __nv_bfloat16* v_s = k_s + NP * LD;

  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int n = a.n, d = a.d;
  const int64_t hd = (int64_t)h * d;
  load_tile<DP, NP>(static_cast<const __nv_bfloat16*>(a.q) + w * a.q_bs + hd,
                    a.q_rs, q_s, n, d, a.vec);
  load_tile<DP, NP>(static_cast<const __nv_bfloat16*>(a.k) + w * a.k_bs + hd,
                    a.k_rs, k_s, n, d, a.vec);
  load_tile<DP, NP>(static_cast<const __nv_bfloat16*>(a.v) + w * a.v_bs + hd,
                    a.v_rs, v_s, n, d, a.vec);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                  // fragment row group
  const int t = lane % 4;                  // thread in group
  const int dim = a.nb_heads * d;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) + (int64_t)w * n * dim + hd;

  for (int rt = warp; rt < kRowTiles; rt += kWarps) {
    const int wr = rt * 16;
    if (wr >= n) break;
    uint32_t qf[kSteps][4];
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const __nv_bfloat16* p = q_s + (wr + g) * LD + ks * 16 + 2 * t;
      qf[ks][0] = ld_u32(p);
      qf[ks][1] = ld_u32(p + 8 * LD);
      qf[ks][2] = ld_u32(p + 8);
      qf[ks][3] = ld_u32(p + 8 * LD + 8);
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

    // exp(min(scale * s + bias (+ mask), 80)) in f32; pad keys and pad rows
    // give 0. Elements 0, 1 lie on row wr + g, elements 2, 3 on row
    // wr + g + 8, at keys 8 j + 2 t and 8 j + 2 t + 1.
    const int row_lo = wr + g, row_hi = row_lo + 8;
    float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row_lo : row_hi;
        const int col = 8 * j + 2 * t + (e & 1);
        float p = 0.f;
        if (row < n && col < n)
          p = expf(fminf(biased(a, w, h, row, col, s[j][e] * a.scale),
                         kSoftmaxClamp));
        s[j][e] = p;
        if (e < 2) l_lo += p; else l_hi += p;
      }
    }
    // Each row's sum is spread over the 4 lanes of its group.
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
    if (row_lo >= n) l_lo = 1.f;           // pad rows: all zeros, not stored
    if (row_hi >= n) l_hi = 1.f;

    // p = e / rowsum, rounded to bf16, as the A operand of p @ v.
    uint32_t pf[kKeyTiles / 2][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      pf[j / 2][(j % 2) * 2 + 0] = pack_bf16(s[j][0] / l_lo, s[j][1] / l_lo);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[j][2] / l_hi, s[j][3] / l_hi);
    }
    float o[kDimTiles][4];
#pragma unroll
    for (int jd = 0; jd < kDimTiles; ++jd)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[jd][r] = 0.f;
#pragma unroll
    for (int m = 0; m < kKeyTiles / 2; ++m) {
      if (16 * m >= n) break;              // all 16 keys are padding
#pragma unroll
      for (int jd = 0; jd < kDimTiles; ++jd) {
        const __nv_bfloat16* p = v_s + (16 * m + 2 * t) * LD + 8 * jd + g;
        mma_16816(o[jd], pf[m], pack_bf16(p[0], p[LD]),
                  pack_bf16(p[8 * LD], p[9 * LD]));
      }
    }

#pragma unroll
    for (int jd = 0; jd < kDimTiles; ++jd) {
      const int c = 8 * jd + 2 * t;
      if (c >= d) break;
      if (row_lo < n)
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row_lo * dim + c) =
            __floats2bfloat162_rn(o[jd][0], o[jd][1]);
      if (row_hi < n)
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row_hi * dim + c) =
            __floats2bfloat162_rn(o[jd][2], o[jd][3]);
    }
  }
}

template <int DP, int NP>
int launch_bf16(const WinArgs& a, int bw, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<DP, NP>();
  cudaError_t err = cudaFuncSetAttribute(
      window_mha_bf16_kernel<DP, NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_mha_bf16_kernel<DP, NP><<<dim3(bw, a.nb_heads), kThreads, smem,
                                   stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DP>
int dispatch_n(const WinArgs& a, int bw, cudaStream_t s) {
  if (a.n <= 32) return launch_bf16<DP, 32>(a, bw, s);
  if (a.n <= 64) return launch_bf16<DP, 64>(a, bw, s);
  return launch_bf16<DP, kMaxN>(a, bw, s);
}

int dispatch_bf16(const WinArgs& a, int bw, cudaStream_t s) {
  if (a.d <= 16) return dispatch_n<16>(a, bw, s);
  if (a.d <= 32) return dispatch_n<32>(a, bw, s);
  if (a.d <= 64) return dispatch_n<64>(a, bw, s);
  return dispatch_n<kMaxHeadDim>(a, bw, s);
}

// ---------------------------------------------------------------------------
// f32: FMA

size_t fma_smem_bytes(int n, int d) {
  return sizeof(float) * ((size_t)2 * n * (d + 1) + (size_t)kWarps * (n + d));
}

__global__ void __launch_bounds__(kThreads)
window_mha_f32_kernel(WinArgs a) {
  extern __shared__ float smem[];
  const int n = a.n, d = a.d, ld = d + 1;
  float* k_s = smem;                       // n x ld
  float* v_s = k_s + n * ld;               // n x ld
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p_s = v_s + n * ld + warp * (n + d);  // this warp's p row ...
  float* q_s = p_s + n;                        // ... and its scaled q row

  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int64_t hd = (int64_t)h * d;
  const float* q = static_cast<const float*>(a.q) + w * a.q_bs + hd;
  const float* k = static_cast<const float*>(a.k) + w * a.k_bs + hd;
  const float* v = static_cast<const float*>(a.v) + w * a.v_bs + hd;
  for (int i = threadIdx.x; i < n * d; i += kThreads) {
    const int r = i / d, c = i % d;
    k_s[r * ld + c] = k[(int64_t)r * a.k_rs + c];
    v_s[r * ld + c] = v[(int64_t)r * a.v_rs + c];
  }
  __syncthreads();

  const int dim = a.nb_heads * d;
  for (int row = warp; row < n; row += kWarps) {
    for (int c = lane; c < d; c += 32) q_s[c] = q[(int64_t)row * a.q_rs + c] * a.scale;
    __syncwarp();
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      float s = 0.f;
      for (int c = 0; c < d; ++c) s = fmaf(q_s[c], k_s[j * ld + c], s);
      const float e = expf(fminf(biased(a, w, h, row, j, s), kSoftmaxClamp));
      p_s[j] = e;
      l += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    for (int j = lane; j < n; j += 32) p_s[j] = p_s[j] / l;
    __syncwarp();
    float* o = static_cast<float*>(a.out) + ((int64_t)w * n + row) * dim + hd;
    for (int c = lane; c < d; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(p_s[j], v_s[j * ld + c], acc);
      o[c] = acc;
    }
    __syncwarp();                          // p_s and q_s are rewritten next
  }
}

int launch_f32(const WinArgs& a, int bw, cudaStream_t stream) {
  const size_t smem = fma_smem_bytes(a.n, a.d);
  cudaError_t err = cudaFuncSetAttribute(
      window_mha_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_mha_f32_kernel<<<dim3(bw, a.nb_heads), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// q, k, v: (BW, N, H * d) with batch strides *_bs and row strides *_rs in
// elements (the last dimension contiguous); bias (H, N, N) f32; mask
// (nb_win, N, N) f32 or null; out (BW, N, H * d) contiguous. dtype: 0 =
// float32, 1 = bfloat16. Returns a cudaError_t value (0 = ok).
extern "C" int tfimm_window_mha(const void* q, const void* k, const void* v,
                                int64_t q_bs, int64_t q_rs, int64_t k_bs,
                                int64_t k_rs, int64_t v_bs, int64_t v_rs,
                                const void* bias, const void* mask, void* out,
                                int bw, int n, int nb_heads, int head_dim,
                                int nb_win, float scale, int dtype,
                                void* stream) {
  if (bw <= 0 || n <= 0 || n > kMaxN || nb_heads <= 0 || nb_heads > 65535 ||
      head_dim <= 0 || head_dim % 8 != 0 || head_dim > kMaxHeadDim ||
      nb_win <= 0 || bw % nb_win != 0)
    return (int)cudaErrorInvalidValue;
  WinArgs a = {q, k, v, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
               static_cast<const float*>(bias), static_cast<const float*>(mask),
               out, n, nb_heads, head_dim, nb_win, scale, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_f32(a, bw, s);
    case 1:
      a.vec = aligned16(q) && aligned16(k) && aligned16(v) &&
              (q_bs | q_rs | k_bs | k_rs | v_bs | v_rs) % 8 == 0;
      return dispatch_bf16(a, bw, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
