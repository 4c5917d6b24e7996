// A whole Swin transformer block on window-partitioned tokens (inference).
//
// Replaces: tfimm_tpu/ops/pallas/swin_block.py · swin_block_fused (the
// Pallas TPU kernel). Same function, on x (BW, N, C) flattened to M = BW * N
// rows:
//
//     H1  = LN1(x) in f32 (one-pass variance, eps), rounded to the dtype
//     qkv = H1 @ w_qkv^T + b_qkv, summed in f32, rounded to the dtype
//     A   = window attention of q, k, v with the rel-pos bias (H, N, N) and
//           the shift mask (nW, N, N): window_mha.cu's kernel, rounded
//     P   = A @ w_proj^T + b_proj, rounded to the dtype
//     X2  = x + P in f32, never rounded
//     H2  = LN2(X2) in f32, rounded to the dtype
//     M1  = gelu(round(H2 @ w1^T + b1)), the GELU of the kernel's dtype
//           policy (tanh form in bf16, exact erf in f32), rounded
//     out = X2 + (M1 @ w2^T + b2) in f32, rounded once
//
// Weights are in the dtype and in the port's Dense layout (out, in), so
// every product is "A row-major times B row-major transposed"; the LN
// weights and the biases are f32 vectors.
//
// What bounds it on an H100: one block at Swin-T's stages 1-3 at batch 128
// (M = 401408, 100352, 25088 rows; C = 96, 192, 384) does 24 * M * C^2
// product flops plus 4 * M * N * C in the attention: 96.3, 92.6 and 90.7
// GFLOP, about 0.097, 0.094 and 0.092 ms at the 989 TFLOP/s bf16 peak,
// while x and out are 4 * M * C bytes (154 MB at stage 1, 46 us at 3.35
// TB/s). So the fused function is bound by the tensor cores.
//
// Design. The TPU kernel keeps a window group's every intermediate in VMEM.
// This first form runs the block as seven launches on one stream instead,
// with the intermediates through device memory (qkv and M1 in the dtype,
// X2 in f32):
//
// 1. row statistics of x: one warp per row, f32 mean and rstd;
// 2. qkv: a tiled GEMM whose A tiles are normalised (LN1) as they are
//    stored to shared memory, so H1 never reaches device memory;
// 3. window attention: tfimm_window_mha (window_mha.cu) on the three slices
//    of the packed qkv, read in place through their strides;
// 4. proj, with the epilogue X2 = x + round(acc + b_proj), written in f32;
// 5. row statistics of X2;
// 6. fc1, with the LN2 prologue on the f32 X2 and the bias + GELU epilogue;
// 7. fc2, with the epilogue out = X2 + (acc + b2).
//
// The GEMMs follow convnext_mlp.cu: in bf16, mma.sync m16n8k16 with
// ldmatrix fragments, a 128 x 128 output tile, 32-deep k tiles staged
// through registers into two shared buffers, 8 warps as 2 x 4; in f32,
// plain FMAs (TF32 would miss the bar) on 64 x 64 tiles. A single launch
// per window group that keeps every intermediate on chip is the design a
// later PR makes fast.
//
// Coverage: any BW, N <= 144, any C that the attention takes (C = H * d, d
// a multiple of 8 up to 128), any hidden width. Rows beyond M and the tail
// of k are zero-filled in shared memory (the LN transform writes 0 there);
// edges of the output are not stored. Every launch is followed by
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" int tfimm_window_mha(const void* q, const void* k, const void* v,
                                int64_t q_bs, int64_t q_rs, int64_t k_bs,
                                int64_t k_rs, int64_t v_bs, int64_t v_rs,
                                const void* bias, const void* mask, void* out,
                                int bw, int n, int nb_heads, int head_dim,
                                int nb_win, float scale, int dtype,
                                void* stream);

namespace {

constexpr int kThreads = 256;

// The epilogues, one per product of the block.
enum Epilogue { kQkv = 0, kProj = 1, kFc1 = 2, kFc2 = 3 };

struct GemmArgs {
  const void* a;         // (M, K): x, A, X2 (f32) or M1
  const void* b;         // (N, K) weight in the dtype
  void* out;             // (M, N): qkv, X2 (f32), M1 or out
  const void* resid;     // proj: x (M, N) in the dtype; fc2: X2 (M, N) f32
  const float* mean;     // LN prologue: (M,)
  const float* rstd;     // LN prologue: (M,)
  const float* ln_w;     // LN prologue: (K,)
  const float* ln_b;     // LN prologue: (K,)
  const float* bias;     // (N,)
  int m, n, k;           // output rows, output columns, depth
  int vec_a, vec_b;      // 16-byte loads of A and B allowed
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back to f32.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// The GELU of the kernel's dtype policy, in f32: exact erf for f32 io, the
// tanh form for bf16 io.
template <typename T>
__device__ __forceinline__ float gelu(float s);
template <>
__device__ __forceinline__ float gelu<float>(float s) {
  return 0.5f * s * (1.f + erff(s * 0.70710678118654752f));
}
template <>
__device__ __forceinline__ float gelu<__nv_bfloat16>(float s) {
  const float u = 0.7978845608028654f * (s + 0.044715f * s * s * s);
  return 0.5f * s * (1.f + tanhf(u));
}

// One output element (row < M, col < N) through the epilogue EPI.
template <typename T, int EPI>
__device__ __forceinline__ void store_out(const GemmArgs& p, int row, int col,
                                          float acc) {
  const int64_t off = (int64_t)row * p.n + col;
  const float y = acc + __ldg(p.bias + col);
  if (EPI == kQkv) {
    static_cast<T*>(p.out)[off] = from_f<T>(y);
  } else if (EPI == kProj) {
    const float x = to_f(static_cast<const T*>(p.resid)[off]);
    static_cast<float*>(p.out)[off] = x + round_to<T>(y);
  } else if (EPI == kFc1) {
    static_cast<T*>(p.out)[off] = from_f<T>(gelu<T>(round_to<T>(y)));
  } else {
    const float x2 = static_cast<const float*>(p.resid)[off];
    static_cast<T*>(p.out)[off] = from_f<T>(x2 + y);
  }
}

// ---------------------------------------------------------------------------
// Row statistics: one warp per row of a (M, C) matrix of TA.

template <typename TA>
__global__ void __launch_bounds__(kThreads)
swin_row_stats_kernel(const TA* __restrict__ x, float* __restrict__ mean,
                      float* __restrict__ rstd, int m, int c, float eps) {
  const int64_t row = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;
  const TA* xr = x + row * c;
  float s = 0.f, ss = 0.f;
  for (int k = lane; k < c; k += 32) {
    const float v = to_f(xr[k]);
    s += v;
    ss += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  if (lane == 0) {
    const float mu = s / (float)c;
    const float var = fmaxf(ss / (float)c - mu * mu, 0.f);
    mean[row] = mu;
    rstd[row] = rsqrtf(var + eps);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, ldmatrix)

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kLd = kBK + 8;                         // padded smem row
constexpr int kCpr = kBK / 8;                        // 8-element chunks per row
constexpr int kChunksA = kBM * kCpr / kThreads;      // per thread
constexpr int kChunksB = kBN * kCpr / kThreads;
constexpr int kTileElems = (kBM + kBN) * kLd;        // one buffer, A then B
constexpr size_t kMmaSmem =
    2 * kTileElems * sizeof(__nv_bfloat16) + 2 * kBM * sizeof(float);

using bf16 = __nv_bfloat16;

// 8 consecutive elements (row, k .. k + 7) of a row-major (rows, depth)
// bf16 matrix, as one 16-byte register chunk; zeros outside it.
__device__ __forceinline__ uint4 load8_raw(const bf16* __restrict__ src,
                                           int row, int rows, int k, int depth,
                                           int vec) {
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows || k >= depth) return u;
  const bf16* p = src + (int64_t)row * depth + k;
  if (vec) return *reinterpret_cast<const uint4*>(p);
  unsigned short e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = k + j < depth ? __bfloat16_as_ushort(p[j]) : 0;
  return make_uint4(e[0] | ((uint32_t)e[1] << 16), e[2] | ((uint32_t)e[3] << 16),
                    e[4] | ((uint32_t)e[5] << 16), e[6] | ((uint32_t)e[7] << 16));
}

// The same 8 elements of a bf16 or f32 matrix as f32 (for the LN prologue).
template <typename TA>
__device__ __forceinline__ void load8_f(float (&e)[8], const TA* __restrict__ src,
                                        int row, int rows, int k, int depth,
                                        int vec);
template <>
__device__ __forceinline__ void load8_f<bf16>(float (&e)[8],
                                              const bf16* __restrict__ src,
                                              int row, int rows, int k,
                                              int depth, int vec) {
  const uint4 u = load8_raw(src, row, rows, k, depth, vec);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    e[2 * j] = __bfloat162float(__ushort_as_bfloat16((unsigned short)(w[j] & 0xffffu)));
    e[2 * j + 1] = __bfloat162float(__ushort_as_bfloat16((unsigned short)(w[j] >> 16)));
  }
}
template <>
__device__ __forceinline__ void load8_f<float>(float (&e)[8],
                                               const float* __restrict__ src,
                                               int row, int rows, int k,
                                               int depth, int vec) {
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = 0.f;
  if (row >= rows || k >= depth) return;
  const float* p = src + (int64_t)row * depth + k;
  if (vec) {
    const float4 lo = *reinterpret_cast<const float4*>(p);
    const float4 hi = *reinterpret_cast<const float4*>(p + 4);
    e[0] = lo.x; e[1] = lo.y; e[2] = lo.z; e[3] = lo.w;
    e[4] = hi.x; e[5] = hi.y; e[6] = hi.z; e[7] = hi.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (k + j < depth) e[j] = p[j];
  }
}

// LN of 8 elements of row `row` at depth k .., rounded to bf16 and packed;
// 0 outside the matrix.
__device__ __forceinline__ uint4 layer_norm8(const float (&e)[8], int row,
                                             int k, const GemmArgs& p,
                                             float mu, float rs) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float z[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kk = k + 2 * j + i;
      z[i] = 0.f;
      if (row < p.m && kk < p.k)
        z[i] = ((e[2 * j + i] - mu) * rs) * __ldg(p.ln_w + kk) + __ldg(p.ln_b + kk);
    }
    const __nv_bfloat162 v = __floats2bfloat162_rn(z[0], z[1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&v);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// This thread's share of the next k tile, from global memory to registers:
// A as raw bf16 chunks, or (LN) as f32 to be normalised on the way to
// shared memory.
template <bool LN>
struct MmaStage {
  uint4 a[LN ? 1 : kChunksA];
  float af[LN ? kChunksA : 1][8];
  uint4 b[kChunksB];
};

template <bool LN, typename TA>
__device__ __forceinline__ void mma_load(MmaStage<LN>& st, const GemmArgs& p,
                                         int m0, int n0, int k0) {
#pragma unroll
  for (int i = 0; i < kChunksA; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = m0 + c / kCpr, k = k0 + (c % kCpr) * 8;
    if constexpr (LN)
      load8_f<TA>(st.af[i], static_cast<const TA*>(p.a), row, p.m, k, p.k,
                  p.vec_a);
    else
      st.a[i] = load8_raw(static_cast<const bf16*>(p.a), row, p.m, k, p.k,
                          p.vec_a);
  }
#pragma unroll
  for (int i = 0; i < kChunksB; ++i) {
    const int c = threadIdx.x + i * kThreads;
    st.b[i] = load8_raw(static_cast<const bf16*>(p.b), n0 + c / kCpr, p.n,
                        k0 + (c % kCpr) * 8, p.k, p.vec_b);
  }
}

// Registers to one shared buffer (A rows then B rows), applying the LN
// prologue on the way.
template <bool LN>
__device__ __forceinline__ void mma_store(const MmaStage<LN>& st,
                                          const GemmArgs& p, bf16* buf, int m0,
                                          int k0, const float* mean_s,
                                          const float* rstd_s) {
#pragma unroll
  for (int i = 0; i < kChunksA; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kCpr, kc = (c % kCpr) * 8;
    uint4 u;
    if constexpr (LN)
      u = layer_norm8(st.af[i], m0 + r, k0 + kc, p, mean_s[r], rstd_s[r]);
    else
      u = st.a[i];
    *reinterpret_cast<uint4*>(buf + r * kLd + kc) = u;
  }
  bf16* bs = buf + kBM * kLd;
#pragma unroll
  for (int i = 0; i < kChunksB; ++i) {
    const int c = threadIdx.x + i * kThreads;
    *reinterpret_cast<uint4*>(bs + (c / kCpr) * kLd + (c % kCpr) * 8) = st.b[i];
  }
}

template <int EPI, bool LN, typename TA>
__global__ void __launch_bounds__(kThreads)
swin_gemm_bf16_kernel(GemmArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);
  float* mean_s = reinterpret_cast<float*>(tiles + 2 * kTileElems);
  float* rstd_s = mean_s + kBM;

  const int n_blocks = (p.n + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / n_blocks) * kBM;
  const int n0 = (blockIdx.x % n_blocks) * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * 64;   // warp's first row in the tile
  const int wn = (warp % 4) * 32;   // warp's first column in the tile

  if (LN) {
    for (int r = tid; r < kBM; r += kThreads) {
      const int row = m0 + r;
      mean_s[r] = row < p.m ? p.mean[row] : 0.f;
      rstd_s[r] = row < p.m ? p.rstd[row] : 0.f;
    }
    __syncthreads();
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  MmaStage<LN> st;
  const int k_tiles = (p.k + kBK - 1) / kBK;
  mma_load<LN, TA>(st, p, m0, n0, 0);
  mma_store<LN>(st, p, tiles, m0, 0, mean_s, rstd_s);
  __syncthreads();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < k_tiles;
    if (more) mma_load<LN, TA>(st, p, m0, n0, (kt + 1) * kBK);
    const bf16* as = tiles + buf * kTileElems;
    const bf16* bs = as + kBM * kLd;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], as + (wm + mt * 16 + lane % 16) * kLd + ks +
                                (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, bs + (wn + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                           ks + ((lane >> 3) & 1) * 8);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_16816(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
    // The other buffer was last read before the previous barrier.
    if (more) mma_store<LN>(st, p, tiles + (buf ^ 1) * kTileElems, m0,
                            (kt + 1) * kBK, mean_s, rstd_s);
    __syncthreads();
  }

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn + nt * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mt * 16 + g + 8 * half;
        if (row >= p.m) continue;
        if (col < p.n) store_out<bf16, EPI>(p, row, col, acc[mt][nt][2 * half]);
        if (col + 1 < p.n)
          store_out<bf16, EPI>(p, row, col + 1, acc[mt][nt][2 * half + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA

constexpr int kFBM = 64;
constexpr int kFBN = 64;
constexpr int kFBK = 16;
constexpr int kFLd = kFBM + 4;                       // k-major smem row
constexpr int kFCpr = kFBK / 4;                      // 4-element chunks per row
constexpr int kFTileElems = kFBK * kFLd * 2;         // one buffer, A then B
constexpr size_t kFmaSmem =
    2 * kFTileElems * sizeof(float) + 2 * kFBM * sizeof(float);
static_assert(kFBM == kFBN, "A and B tiles share a k-major row length");
static_assert(kFBM * kFCpr == kThreads, "one A chunk and one B chunk per thread");

// 4 consecutive elements (row, k .. k + 3) of a row-major f32 matrix; zeros
// outside it.
__device__ __forceinline__ float4 load4(const float* __restrict__ src, int row,
                                        int rows, int k, int depth, int vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= rows || k >= depth) return v;
  const float* p = src + (int64_t)row * depth + k;
  if (vec) return *reinterpret_cast<const float4*>(p);
  float e[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (k + j < depth) e[j] = p[j];
  return make_float4(e[0], e[1], e[2], e[3]);
}

__device__ __forceinline__ float layer_norm1(float x, int row, int k,
                                             const GemmArgs& p, float mu,
                                             float rs) {
  if (row >= p.m || k >= p.k) return 0.f;
  return ((x - mu) * rs) * __ldg(p.ln_w + k) + __ldg(p.ln_b + k);
}

template <int EPI, bool LN>
__global__ void __launch_bounds__(kThreads)
swin_gemm_f32_kernel(GemmArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tiles = reinterpret_cast<float*>(smem_raw);
  float* mean_s = tiles + 2 * kFTileElems;
  float* rstd_s = mean_s + kFBM;

  const int n_blocks = (p.n + kFBN - 1) / kFBN;
  const int m0 = (blockIdx.x / n_blocks) * kFBM;
  const int n0 = (blockIdx.x % n_blocks) * kFBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* a = static_cast<const float*>(p.a);
  const float* b = static_cast<const float*>(p.b);

  if (LN) {
    for (int r = tid; r < kFBM; r += kThreads) {
      const int row = m0 + r;
      mean_s[r] = row < p.m ? p.mean[row] : 0.f;
      rstd_s[r] = row < p.m ? p.rstd[row] : 0.f;
    }
    __syncthreads();
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // This thread's chunk of each tile: row lr, depth lk .. lk + 3.
  const int lr = tid / kFCpr, lk = (tid % kFCpr) * 4;
  const int k_tiles = (p.k + kFBK - 1) / kFBK;
  float4 ra = load4(a, m0 + lr, p.m, lk, p.k, p.vec_a);
  float4 rb = load4(b, n0 + lr, p.n, lk, p.k, p.vec_b);
  for (int kt = 0; kt < k_tiles; ++kt) {
    // Store tile kt (loaded one iteration earlier) to buffer kt & 1, whose
    // last readers finished before the previous barrier, then load tile
    // kt + 1 and multiply tile kt.
    float* as = tiles + (kt & 1) * kFTileElems;
    float* bs = as + kFBK * kFLd;
    float ea[4] = {ra.x, ra.y, ra.z, ra.w};
    const float eb[4] = {rb.x, rb.y, rb.z, rb.w};
    if (LN) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ea[j] = layer_norm1(ea[j], m0 + lr, kt * kFBK + lk + j, p, mean_s[lr],
                            rstd_s[lr]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      as[(lk + j) * kFLd + lr] = ea[j];
      bs[(lk + j) * kFLd + lr] = eb[j];
    }
    __syncthreads();
    if (kt + 1 < k_tiles) {
      const int k0 = (kt + 1) * kFBK;
      ra = load4(a, m0 + lr, p.m, k0 + lk, p.k, p.vec_a);
      rb = load4(b, n0 + lr, p.n, k0 + lk, p.k, p.vec_b);
    }
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk * kFLd + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk * kFLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // The next iteration stores into the other buffer, whose last readers
    // finished before this iteration's barrier.
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < p.n) store_out<float, EPI>(p, row, col, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <typename T, int EPI, bool LN, typename TA>
int launch_gemm(GemmArgs args, cudaStream_t stream) {
  constexpr bool kMma = sizeof(T) == 2;
  const int bm = kMma ? kBM : kFBM, bn = kMma ? kBN : kFBN;
  const size_t smem = kMma ? kMmaSmem : kFmaSmem;
  // 16 bytes hold 8 bf16 (4 f32) elements of a row; an f32 A of the bf16
  // kernel is read 8 elements at a time as two 16-byte loads.
  const int va = kMma ? 8 : 4;
  args.vec_a = args.k % va == 0 && aligned16(args.a);
  args.vec_b = args.k % (kMma ? 8 : 4) == 0 && aligned16(args.b);
  cudaError_t err;
  if constexpr (kMma)
    err = cudaFuncSetAttribute(swin_gemm_bf16_kernel<EPI, LN, TA>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  else
    err = cudaFuncSetAttribute(swin_gemm_f32_kernel<EPI, LN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks =
      (int64_t)((args.m + bm - 1) / bm) * ((args.n + bn - 1) / bn);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  if constexpr (kMma)
    swin_gemm_bf16_kernel<EPI, LN, TA><<<(unsigned)blocks, kThreads, smem,
                                         stream>>>(args);
  else
    swin_gemm_f32_kernel<EPI, LN><<<(unsigned)blocks, kThreads, smem,
                                    stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename TA>
int launch_stats(const void* x, float* mean, float* rstd, int m, int c,
                 float eps, cudaStream_t stream) {
  const int blocks = (int)(((int64_t)m * 32 + kThreads - 1) / kThreads);
  swin_row_stats_kernel<TA><<<blocks, kThreads, 0, stream>>>(
      static_cast<const TA*>(x), mean, rstd, m, c, eps);
  return (int)cudaGetLastError();
}

struct BlockArgs {
  const void* x;
  const float *ln1_w, *ln1_b;
  const void* w_qkv;
  const float* b_qkv;
  const void* bias;
  const void* mask;
  const void* w_proj;
  const float* b_proj;
  const float *ln2_w, *ln2_b;
  const void* w1;
  const float* b1;
  const void* w2;
  const float* b2;
  void *qkv, *attn, *x2, *hid;
  float *mean, *rstd;
  void* out;
  int bw, n, c, nb_heads, hidden, nb_win;
  float eps, scale;
};

template <typename T>
int launch_block(const BlockArgs& b, int dtype, cudaStream_t s) {
  const int m = b.bw * b.n, c = b.c;
  int err = launch_stats<T>(b.x, b.mean, b.rstd, m, c, b.eps, s);
  if (err != 0) return err;
  GemmArgs qkv = {b.x, b.w_qkv, b.qkv, nullptr, b.mean, b.rstd, b.ln1_w,
                  b.ln1_b, b.b_qkv, m, 3 * c, c, 0, 0};
  err = launch_gemm<T, kQkv, true, T>(qkv, s);
  if (err != 0) return err;
  const T* q = static_cast<const T*>(b.qkv);
  const int64_t bs = (int64_t)b.n * 3 * c, rs = 3 * (int64_t)c;
  err = tfimm_window_mha(q, q + c, q + 2 * c, bs, rs, bs, rs, bs, rs, b.bias,
                         b.mask, b.attn, b.bw, b.n, b.nb_heads,
                         c / b.nb_heads, b.nb_win, b.scale, dtype, s);
  if (err != 0) return err;
  GemmArgs proj = {b.attn, b.w_proj, b.x2, b.x, nullptr, nullptr, nullptr,
                   nullptr, b.b_proj, m, c, c, 0, 0};
  err = launch_gemm<T, kProj, false, T>(proj, s);
  if (err != 0) return err;
  err = launch_stats<float>(b.x2, b.mean, b.rstd, m, c, b.eps, s);
  if (err != 0) return err;
  GemmArgs fc1 = {b.x2, b.w1, b.hid, nullptr, b.mean, b.rstd, b.ln2_w,
                  b.ln2_b, b.b1, m, b.hidden, c, 0, 0};
  err = launch_gemm<T, kFc1, true, float>(fc1, s);
  if (err != 0) return err;
  GemmArgs fc2 = {b.hid, b.w2, b.out, b.x2, nullptr, nullptr, nullptr,
                  nullptr, b.b2, m, c, b.hidden, 0, 0};
  return launch_gemm<T, kFc2, false, T>(fc2, s);
}

}  // namespace

// x, out (BW, N, C) in the dtype; w_qkv (3C, C), w_proj (C, C), w1
// (hidden, C), w2 (C, hidden) in the dtype; ln weights and biases, b_qkv,
// b_proj, b1, b2 f32; bias (H, N, N) f32; mask (nb_win, N, N) f32 or null.
// Scratch the caller allocates: qkv (M, 3C) and attn (M, C) and hid
// (M, hidden) in the dtype, x2 (M, C) f32, mean and rstd (M,) f32. dtype:
// 0 = float32, 1 = bfloat16. Returns a cudaError_t value (0 = ok).
extern "C" int tfimm_swin_block(
    const void* x, const void* ln1_w, const void* ln1_b, const void* w_qkv,
    const void* b_qkv, const void* bias, const void* mask, const void* w_proj,
    const void* b_proj, const void* ln2_w, const void* ln2_b, const void* w1,
    const void* b1, const void* w2, const void* b2, void* qkv, void* attn,
    void* x2, void* hid, void* mean, void* rstd, void* out, int bw, int n,
    int c, int nb_heads, int hidden, int nb_win, float eps, float scale,
    int dtype, void* stream) {
  if (bw <= 0 || n <= 0 || c <= 0 || hidden <= 0 || nb_heads <= 0 ||
      c % nb_heads != 0)
    return (int)cudaErrorInvalidValue;
  const BlockArgs b = {
      x, static_cast<const float*>(ln1_w), static_cast<const float*>(ln1_b),
      w_qkv, static_cast<const float*>(b_qkv), bias, mask, w_proj,
      static_cast<const float*>(b_proj), static_cast<const float*>(ln2_w),
      static_cast<const float*>(ln2_b), w1, static_cast<const float*>(b1), w2,
      static_cast<const float*>(b2), qkv, attn, x2, hid,
      static_cast<float*>(mean), static_cast<float*>(rstd), out, bw, n, c,
      nb_heads, hidden, nb_win, eps, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_block<float>(b, dtype, s);
    case 1:
      return launch_block<__nv_bfloat16>(b, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
