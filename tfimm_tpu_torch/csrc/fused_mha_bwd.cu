// Fused multi-head attention backward, straight into the packed qkv layout.
//
// Replaces: tfimm_tpu/ops/pallas/fused_mha.py · _fused_mha_bwd_call (the
// Pallas TPU backward of fused_mha). Same function: from qkv (B, N, 3*D),
// last dim in timm's (3, H, d) order, and g = dL/dout (B, N, D), compute
// dqkv (B, N, 3*D) in qkv's layout and dtype. Per head, with the softmax
// recomputed (nothing from the forward is stored):
//
//     s  = (q * scale) @ k^T                        (f32)
//     p  = exp(min(s, 80)) / rowsum                 (clamped no-max softmax)
//     dv = p^T @ g
//     dp = g @ v^T
//     ds = where(s < 80, p * (dp - rowsum(dp * p)), 0)   (clamp mask)
//     dq = scale * ds @ k,   dk = scale * ds^T @ q
//
// q, k, v and g are read in place out of their packed rows, and dq, dk and
// dv are written in place into the packed rows of dqkv: no transposes and
// no concatenation afterwards. Scores never reach device memory.
//
// Two launches per call, deterministic, no atomics:
//
// (A) dq: one block per (64 query rows, head, image). It streams the head's
//     keys in 32-key tiles three times: pass 1 sums l = rowsum(exp(min(s,
//     80))); pass 2 forms p = e / l and dp = g v^T and sums delta =
//     rowsum(p * dp); pass 3 forms ds and accumulates dq = scale * ds k. It
//     writes dq, and l and delta to an f32 (B, H, N) scratch.
// (B) dk, dv: one block per (64 keys, head, image). It keeps its k and v
//     rows in shared memory and streams the queries in 32-query tiles with
//     their l and delta, recomputes s^T = k q^T, p^T (from l), dp^T = v g^T
//     and ds^T (from delta), and accumulates dk = scale * ds^T q and
//     dv = p^T g in f32 registers.
//
// Both kernels share one shape: a block owns 64 rows (queries in A, keys in
// B), each of its 4 warps 16 of them, and computes 16 x 32 products of its
// own rows against a streamed tile, then multiplies those products with the
// streamed tile's rows. The accumulator layout of two adjacent 8-column
// tiles of an mma.sync product is the A layout of one 16-deep step, so p and
// ds go from one product to the next in registers.
//
// - bf16 (the training path): tensor cores through mma.sync m16n8k16 (bf16
//   in, f32 accumulate). p and ds are rounded to bf16 before their products
//   (the reference keeps them in f32); s, l, dp, delta and every sum stay
//   f32. Shared memory rows are padded by 8 elements, so fragment loads are
//   free of bank conflicts.
// - f32: plain f32 FMAs (TF32 would not hold the f32 results), 256 threads
//   as a 16 x 16 grid, each owning 4 own rows x 4 streamed columns of a
//   product and 4 own rows x up to 8 head columns of the outputs; p and ds
//   pass through shared memory.
//
// What bounds it on an H100: at ViT-B/16 training (B = 64, N = 197, H = 12,
// d = 64) one N x N x d product is 2 * B * H * N^2 * d = 3.8 GFLOP. The
// function needs five (19 GFLOP, 19 us at the bf16 tensor-core peak); with
// the recomputation this design does ten (s three times and dp twice in A,
// s, dp, dv and dk in B), about 38 GFLOP, and 56 GFLOP with the padding of
// N = 197 to 224 streamed and 256 own rows (57 us at peak). It reads about
// 77 MB (qkv and g; the streamed tiles again come from L2) and writes 58 MB
// of dqkv: 135 MB, about 40 us at 3.35 TB/s. So the function is bound by
// device memory, and this design's recomputation would make an ideal form
// of it bound by compute; this simple form is bound by shared-memory
// fragment loads feeding mma.sync (plain synchronous tile loads, no
// cp.async/TMA, no wgmma). The f32 kernels are bound by shared-memory loads
// feeding FMAs.
//
// Shared memory: bf16 27.9 KB at d = 64 and 52.5 KB at d = 128; f32 100 KB
// at d = 64 and 166 KB at d = 128. Above the 48 KB static limit a launch
// needs the dynamic limit raised, so the launcher sets
// cudaFuncAttributeMaxDynamicSharedMemorySize before every launch and
// returns cudaGetLastError() after each.
//
// Coverage: the forward's. Any B, any N (ragged edges masked), any H, and
// every head dim d that is a multiple of 8 up to 128 (bf16 pads d to a
// multiple of 16 in shared memory with zeros). bf16 needs qkv, g and dqkv
// 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                 // a block's own rows
constexpr int kMaxHeadDim = 128;
constexpr float kSoftmaxClamp = 80.0f;    // dispatch.py SOFTMAX_CLAMP

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync)

constexpr int kCols = 32;                 // streamed rows per tile
constexpr int kColTiles = kCols / 8;      // 8-column tiles of a 16 x 32 product
constexpr int kColSteps = kCols / 16;     // 16-deep steps over a streamed tile
constexpr int kMmaThreads = 128;          // 4 warps x 16 own rows

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

// Two f32 vectors of kCols (l and delta of the streamed queries in B), then
// two own tiles of kRows rows and two streamed tiles of kCols rows.
template <int DP>
size_t mma_smem_bytes() {
  return 2 * kCols * sizeof(float) +
         sizeof(__nv_bfloat16) * (size_t)(2 * kRows + 2 * kCols) * mma_ld<DP>();
}

// Rows [r0, r0 + ROWS) of one head's slice of a packed tensor into shared
// memory, 16 bytes per load; rows at or beyond n and columns at or beyond d
// become zeros.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src,
                                          __nv_bfloat16* dst, int r0, int n,
                                          int d, int64_t row_stride) {
  constexpr int kChunks = DP / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int row = r0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < n && c < d)
      v = *reinterpret_cast<const uint4*>(src + (int64_t)row * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * mma_ld<DP>() + c) = v;
  }
}

// c[j] = A[r, r + 16) . B[8j, 8j + 8)^T over the (padded) head dim: the
// warp's 16 own rows against the 32 rows of a streamed tile. Element
// c[j][i] sits at own row r + g + 8 * (i / 2), streamed row 8j + 2t + i % 2.
template <int DP>
__device__ __forceinline__ void warp_abt(const __nv_bfloat16* a_s, int r,
                                         const __nv_bfloat16* b_s,
                                         float (&c)[kColTiles][4]) {
  constexpr int LD = mma_ld<DP>();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < kColTiles; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const __nv_bfloat16* pa = a_s + (r + g) * LD + ks * 16 + 2 * t;
    const uint32_t a[4] = {ld_u32(pa), ld_u32(pa + 8 * LD), ld_u32(pa + 8),
                           ld_u32(pa + 8 * LD + 8)};
#pragma unroll
    for (int j = 0; j < kColTiles; ++j) {
      const __nv_bfloat16* pb = b_s + (8 * j + g) * LD + ks * 16 + 2 * t;
      mma_16816(c[j], a, ld_u32(pb), ld_u32(pb + 8));
    }
  }
}

// acc += X @ B: X (16 own rows x kCols) given as A fragments, one per
// 16-deep step, times the streamed tile B (kCols rows x DP). Steps whose
// 16 streamed rows all lie at or beyond the end (live <= 16 m) are skipped.
template <int DP>
__device__ __forceinline__ void warp_ab(const uint32_t (&x)[kColSteps][4],
                                        const __nv_bfloat16* b_s, int live,
                                        float (&acc)[DP / 8][4]) {
  constexpr int LD = mma_ld<DP>();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int m = 0; m < kColSteps; ++m) {
    if (16 * m >= live) break;
#pragma unroll
    for (int jd = 0; jd < DP / 8; ++jd) {
      const __nv_bfloat16* p = b_s + (16 * m + 2 * t) * LD + 8 * jd + g;
      mma_16816(acc[jd], x[m], pack_bf16(p[0], p[LD]),
                pack_bf16(p[8 * LD], p[9 * LD]));
    }
  }
}

// The value of c[j][i] (see warp_abt) into the A fragments of warp_ab.
__device__ __forceinline__ void pack_frag(uint32_t (&x)[kColSteps][4], int j,
                                          const float (&v)[4]) {
  x[j / 2][(j % 2) * 2 + 0] = pack_bf16(v[0], v[1]);
  x[j / 2][(j % 2) * 2 + 1] = pack_bf16(v[2], v[3]);
}

// Sum over the 4 lanes that hold one row of a warp_abt product.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows r and r + 8 of a 16-row accumulator, times mul, into the packed
// rows of out (row stride ld_out) where they lie below n.
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, int64_t ld_out,
                                           int row, int n, int d, float mul,
                                           const float (&acc)[DP / 8][4]) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int jd = 0; jd < DP / 8; ++jd) {
    const int c = 8 * jd + 2 * t;
    if (c >= d) break;
    if (row < n)
      *reinterpret_cast<__nv_bfloat162*>(out + row * ld_out + c) =
          __floats2bfloat162_rn(acc[jd][0] * mul, acc[jd][1] * mul);
    if (row + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(out + (row + 8) * ld_out + c) =
          __floats2bfloat162_rn(acc[jd][2] * mul, acc[jd][3] * mul);
  }
}

// (A): dq, l and delta. DP: the head dim rounded up to a multiple of 16.
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
fused_mha_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ qkv,
                             const __nv_bfloat16* __restrict__ grad,
                             __nv_bfloat16* __restrict__ dqkv,
                             float* __restrict__ row_sum,
                             float* __restrict__ row_delta, int n,
                             int nb_heads, int d, float scale) {
  constexpr int LD = mma_ld<DP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + 2 * kCols * sizeof(float));
  __nv_bfloat16* g_s = q_s + kRows * LD;
  __nv_bfloat16* k_s = g_s + kRows * LD;
  __nv_bfloat16* v_s = k_s + kCols * LD;

  const int r0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int dim = nb_heads * d;
  const int64_t qkv_stride = 3 * (int64_t)dim;
  const int64_t head = (int64_t)b * n * qkv_stride + (int64_t)h * d;
  const __nv_bfloat16* q_g = qkv + head;
  const __nv_bfloat16* k_g = q_g + dim;
  const __nv_bfloat16* v_g = q_g + 2 * dim;
  const __nv_bfloat16* g_g = grad + (int64_t)b * n * dim + (int64_t)h * d;

  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int wr = (threadIdx.x / 32) * 16;  // this warp's first own row
  const bool active = r0 + wr < n;

  load_tile<DP, kRows>(q_g, q_s, r0, n, d, qkv_stride);
  load_tile<DP, kRows>(g_g, g_s, r0, n, d, dim);

  float s[kColTiles][4], dp[kColTiles][4];

  // Pass 1: l = rowsum(exp(min(s, 80))) over the keys below n.
  float l[2] = {0.f, 0.f};                 // rows g and g + 8
  for (int c0 = 0; c0 < n; c0 += kCols) {
    __syncthreads();  // previous tile fully read (and own tiles written)
    load_tile<DP, kCols>(k_g, k_s, c0, n, d, qkv_stride);
    __syncthreads();
    if (!active) continue;
    warp_abt<DP>(q_s, wr, k_s, s);
#pragma unroll
    for (int j = 0; j < kColTiles; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c0 + 8 * j + 2 * t + i % 2 < n)
          l[i / 2] += expf(fminf(s[j][i] * scale, kSoftmaxClamp));
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};

  // Pass 2: delta = rowsum(p * dp).
  float delta[2] = {0.f, 0.f};
  for (int c0 = 0; c0 < n; c0 += kCols) {
    __syncthreads();
    load_tile<DP, kCols>(k_g, k_s, c0, n, d, qkv_stride);
    load_tile<DP, kCols>(v_g, v_s, c0, n, d, qkv_stride);
    __syncthreads();
    if (!active) continue;
    warp_abt<DP>(q_s, wr, k_s, s);
    warp_abt<DP>(g_s, wr, v_s, dp);
#pragma unroll
    for (int j = 0; j < kColTiles; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c0 + 8 * j + 2 * t + i % 2 < n)
          delta[i / 2] += expf(fminf(s[j][i] * scale, kSoftmaxClamp)) *
                          inv_l[i / 2] * dp[j][i];
  }
  delta[0] = quad_sum(delta[0]);
  delta[1] = quad_sum(delta[1]);

  // Pass 3: dq += ds @ k.
  float acc[DP / 8][4];
#pragma unroll
  for (int jd = 0; jd < DP / 8; ++jd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[jd][i] = 0.f;
  for (int c0 = 0; c0 < n; c0 += kCols) {
    __syncthreads();
    load_tile<DP, kCols>(k_g, k_s, c0, n, d, qkv_stride);
    load_tile<DP, kCols>(v_g, v_s, c0, n, d, qkv_stride);
    __syncthreads();
    if (!active) continue;
    warp_abt<DP>(q_s, wr, k_s, s);
    warp_abt<DP>(g_s, wr, v_s, dp);
    uint32_t dsf[kColSteps][4];
#pragma unroll
    for (int j = 0; j < kColTiles; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = s[j][i] * scale;
        const bool ok = c0 + 8 * j + 2 * t + i % 2 < n;
        const float p = ok ? expf(fminf(x, kSoftmaxClamp)) * inv_l[i / 2] : 0.f;
        ds[i] = x < kSoftmaxClamp ? p * (dp[j][i] - delta[i / 2]) : 0.f;
      }
      pack_frag(dsf, j, ds);
    }
    warp_ab<DP>(dsf, k_s, n - c0, acc);
  }
  if (!active) return;

  const int row = r0 + wr + lane / 4;
  store_rows<DP>(dqkv + head, qkv_stride, row, n, d, scale, acc);
  if (t == 0) {
    float* l_g = row_sum + ((int64_t)b * nb_heads + h) * n;
    float* dl_g = row_delta + ((int64_t)b * nb_heads + h) * n;
    if (row < n) { l_g[row] = l[0]; dl_g[row] = delta[0]; }
    if (row + 8 < n) { l_g[row + 8] = l[1]; dl_g[row + 8] = delta[1]; }
  }
}

// (B): dk and dv, from the l and delta that (A) wrote.
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
fused_mha_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ qkv,
                              const __nv_bfloat16* __restrict__ grad,
                              __nv_bfloat16* __restrict__ dqkv,
                              const float* __restrict__ row_sum,
                              const float* __restrict__ row_delta, int n,
                              int nb_heads, int d, float scale) {
  constexpr int LD = mma_ld<DP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* l_s = reinterpret_cast<float*>(smem_raw);
  float* dl_s = l_s + kCols;
  __nv_bfloat16* k_s =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + 2 * kCols * sizeof(float));
  __nv_bfloat16* v_s = k_s + kRows * LD;
  __nv_bfloat16* q_s = v_s + kRows * LD;
  __nv_bfloat16* g_s = q_s + kCols * LD;

  const int r0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int dim = nb_heads * d;
  const int64_t qkv_stride = 3 * (int64_t)dim;
  const int64_t head = (int64_t)b * n * qkv_stride + (int64_t)h * d;
  const __nv_bfloat16* q_g = qkv + head;
  const __nv_bfloat16* k_g = q_g + dim;
  const __nv_bfloat16* v_g = q_g + 2 * dim;
  const __nv_bfloat16* g_g = grad + (int64_t)b * n * dim + (int64_t)h * d;
  const float* l_g = row_sum + ((int64_t)b * nb_heads + h) * n;
  const float* dl_g = row_delta + ((int64_t)b * nb_heads + h) * n;

  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int wr = (threadIdx.x / 32) * 16;  // this warp's first own key
  const bool active = r0 + wr < n;

  load_tile<DP, kRows>(k_g, k_s, r0, n, d, qkv_stride);
  load_tile<DP, kRows>(v_g, v_s, r0, n, d, qkv_stride);

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int jd = 0; jd < DP / 8; ++jd)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[jd][i] = dv[jd][i] = 0.f;

  float s[kColTiles][4], dp[kColTiles][4];
  for (int c0 = 0; c0 < n; c0 += kCols) {
    __syncthreads();  // previous tile fully read (and own tiles written)
    load_tile<DP, kCols>(q_g, q_s, c0, n, d, qkv_stride);
    load_tile<DP, kCols>(g_g, g_s, c0, n, d, dim);
    for (int i = threadIdx.x; i < kCols; i += kMmaThreads) {
      const bool ok = c0 + i < n;
      l_s[i] = ok ? l_g[c0 + i] : 1.f;
      dl_s[i] = ok ? dl_g[c0 + i] : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    warp_abt<DP>(k_s, wr, q_s, s);    // s^T: own keys x streamed queries
    warp_abt<DP>(v_s, wr, g_s, dp);   // dp^T
    uint32_t pf[kColSteps][4], dsf[kColSteps][4];
#pragma unroll
    for (int j = 0; j < kColTiles; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = 8 * j + 2 * t + i % 2;
        const float x = s[j][i] * scale;
        p[i] = c0 + q < n ? expf(fminf(x, kSoftmaxClamp)) / l_s[q] : 0.f;
        ds[i] = x < kSoftmaxClamp ? p[i] * (dp[j][i] - dl_s[q]) : 0.f;
      }
      pack_frag(pf, j, p);
      pack_frag(dsf, j, ds);
    }
    warp_ab<DP>(pf, g_s, n - c0, dv);
    warp_ab<DP>(dsf, q_s, n - c0, dk);
  }
  if (!active) return;

  const int row = r0 + wr + lane / 4;
  store_rows<DP>(dqkv + head + dim, qkv_stride, row, n, d, scale, dk);
  store_rows<DP>(dqkv + head + 2 * dim, qkv_stride, row, n, d, 1.f, dv);
}

template <int DP>
int launch_bf16(const void* qkv, const void* grad, void* dqkv, float* row_sum,
                float* row_delta, int batch, int n, int nb_heads, int d,
                float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t smem = mma_smem_bytes<DP>();
  const dim3 grid((n + kRows - 1) / kRows, nb_heads, batch);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mha_bwd_dq_bf16_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_mha_bwd_dq_bf16_kernel<DP><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(grad),
      static_cast<bf16*>(dqkv), row_sum, row_delta, n, nb_heads, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fused_mha_bwd_dkv_bf16_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_mha_bwd_dkv_bf16_kernel<DP><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(grad),
      static_cast<bf16*>(dqkv), row_sum, row_delta, n, nb_heads, d, scale);
  return (int)cudaGetLastError();
}

int dispatch_bf16(const void* qkv, const void* grad, void* dqkv,
                  float* row_sum, float* row_delta, int batch, int n,
                  int nb_heads, int d, float scale, cudaStream_t s) {
#define TFIMM_BWD_CASE(k)                                                     \
  case k:                                                                     \
    return launch_bf16<16 * k>(qkv, grad, dqkv, row_sum, row_delta, batch, n, \
                               nb_heads, d, scale, s);
  switch ((d + 15) / 16) {
    TFIMM_BWD_CASE(1)
    TFIMM_BWD_CASE(2)
    TFIMM_BWD_CASE(3)
    TFIMM_BWD_CASE(4)
    TFIMM_BWD_CASE(5)
    TFIMM_BWD_CASE(6)
    TFIMM_BWD_CASE(7)
    TFIMM_BWD_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef TFIMM_BWD_CASE
}

// ---------------------------------------------------------------------------
// f32: FMA

constexpr int kFmaThreads = 256;          // 16 x 16
constexpr int kFmaCols = 64;              // streamed rows per tile
constexpr int kOwn = kRows / 16;          // own rows per thread
constexpr int kStr = kFmaCols / 16;       // streamed columns per thread
constexpr int kDims = kMaxHeadDim / 16;   // head columns per thread (max)
constexpr int kLdt = kFmaCols + 1;        // row stride of the p / ds tiles

// Four (64, d + 1) tiles, two (64, 65) product tiles, two vectors of 64.
size_t fma_smem_bytes(int d) {
  return sizeof(float) * ((size_t)4 * kRows * (d + 1) +
                          (size_t)2 * kRows * kLdt + 2 * kFmaCols);
}

// Rows [r0, r0 + 64) of one head's slice into a (64, d + 1) tile, times
// mul; rows at or beyond n become zeros.
__device__ __forceinline__ void load_rows_f32(const float* __restrict__ src,
                                              float* dst, int r0, int n, int d,
                                              int64_t row_stride, float mul) {
  for (int i = threadIdx.x; i < kRows * d; i += kFmaThreads) {
    const int r = i / d, c = i % d;
    const int row = r0 + r;
    dst[r * (d + 1) + c] = row < n ? src[(int64_t)row * row_stride + c] * mul : 0.f;
  }
}

// c[i][j] = a row (ty + 16 i) . b row (tx + 16 j), over d.
__device__ __forceinline__ void fma_abt(const float* a_s, const float* b_s,
                                        int d, float (&c)[kOwn][kStr]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, ld = d + 1;
#pragma unroll
  for (int i = 0; i < kOwn; ++i)
#pragma unroll
    for (int j = 0; j < kStr; ++j) c[i][j] = 0.f;
  for (int c0 = 0; c0 < d; ++c0) {
    float av[kOwn], bv[kStr];
#pragma unroll
    for (int i = 0; i < kOwn; ++i) av[i] = a_s[(ty + 16 * i) * ld + c0];
#pragma unroll
    for (int j = 0; j < kStr; ++j) bv[j] = b_s[(tx + 16 * j) * ld + c0];
#pragma unroll
    for (int i = 0; i < kOwn; ++i)
#pragma unroll
      for (int j = 0; j < kStr; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
  }
}

// acc[i][c] += sum over the first `live` streamed rows kk of
// x[ty + 16 i][kk] * b[kk][tx + 16 c].
__device__ __forceinline__ void fma_ab(const float* x_s, const float* b_s,
                                       int live, int d,
                                       float (&acc)[kOwn][kDims]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, ld = d + 1;
  const int kmax = min(kFmaCols, live);
  for (int kk = 0; kk < kmax; ++kk) {
    float xv[kOwn];
#pragma unroll
    for (int i = 0; i < kOwn; ++i) xv[i] = x_s[(ty + 16 * i) * kLdt + kk];
#pragma unroll
    for (int c = 0; c < kDims; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        const float bv = b_s[kk * ld + col];
#pragma unroll
        for (int i = 0; i < kOwn; ++i) acc[i][c] = fmaf(xv[i], bv, acc[i][c]);
      }
    }
  }
}

// Sum over the 16 tx lanes (one half-warp) that share a row.
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void store_rows_f32(float* out, int64_t ld_out,
                                               int r0, int n, int d, float mul,
                                               const float (&acc)[kOwn][kDims]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < kDims; ++c) {
      const int col = tx + 16 * c;
      if (col < d) out[row * ld_out + col] = acc[i][c] * mul;
    }
  }
}

__global__ void __launch_bounds__(kFmaThreads)
fused_mha_bwd_dq_f32_kernel(const float* __restrict__ qkv,
                            const float* __restrict__ grad,
                            float* __restrict__ dqkv, float* __restrict__ row_sum,
                            float* __restrict__ row_delta, int n, int nb_heads,
                            int d, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* q_s = smem;                  // pre-scaled
  float* g_s = q_s + kRows * ld;
  float* k_s = g_s + kRows * ld;
  float* v_s = k_s + kRows * ld;
  float* ds_s = v_s + kRows * ld;     // kRows x kLdt

  const int r0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int dim = nb_heads * d;
  const int64_t qkv_stride = 3 * (int64_t)dim;
  const int64_t head = (int64_t)b * n * qkv_stride + (int64_t)h * d;
  const float* q_g = qkv + head;
  const float* k_g = q_g + dim;
  const float* v_g = q_g + 2 * dim;
  const float* g_g = grad + (int64_t)b * n * dim + (int64_t)h * d;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_rows_f32(q_g, q_s, r0, n, d, qkv_stride, scale);
  load_rows_f32(g_g, g_s, r0, n, d, dim, 1.f);

  float s[kOwn][kStr], dp[kOwn][kStr];
  float l[kOwn], inv_l[kOwn], delta[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) l[i] = delta[i] = 0.f;

  // Pass 1: l.
  for (int c0 = 0; c0 < n; c0 += kFmaCols) {
    __syncthreads();  // previous tile fully read (and own tiles written)
    load_rows_f32(k_g, k_s, c0, n, d, qkv_stride, 1.f);
    __syncthreads();
    fma_abt(q_s, k_s, d, s);
#pragma unroll
    for (int i = 0; i < kOwn; ++i)
#pragma unroll
      for (int j = 0; j < kStr; ++j)
        if (c0 + tx + 16 * j < n) l[i] += expf(fminf(s[i][j], kSoftmaxClamp));
  }
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    l[i] = half_warp_sum(l[i]);
    inv_l[i] = 1.f / l[i];
  }

  // Pass 2: delta.
  for (int c0 = 0; c0 < n; c0 += kFmaCols) {
    __syncthreads();
    load_rows_f32(k_g, k_s, c0, n, d, qkv_stride, 1.f);
    load_rows_f32(v_g, v_s, c0, n, d, qkv_stride, 1.f);
    __syncthreads();
    fma_abt(q_s, k_s, d, s);
    fma_abt(g_s, v_s, d, dp);
#pragma unroll
    for (int i = 0; i < kOwn; ++i)
#pragma unroll
      for (int j = 0; j < kStr; ++j)
        if (c0 + tx + 16 * j < n)
          delta[i] += expf(fminf(s[i][j], kSoftmaxClamp)) * inv_l[i] * dp[i][j];
  }
#pragma unroll
  for (int i = 0; i < kOwn; ++i) delta[i] = half_warp_sum(delta[i]);

  // Pass 3: dq += ds @ k.
  float acc[kOwn][kDims];
#pragma unroll
  for (int i = 0; i < kOwn; ++i)
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[i][c] = 0.f;
  for (int c0 = 0; c0 < n; c0 += kFmaCols) {
    __syncthreads();
    load_rows_f32(k_g, k_s, c0, n, d, qkv_stride, 1.f);
    load_rows_f32(v_g, v_s, c0, n, d, qkv_stride, 1.f);
    __syncthreads();
    fma_abt(q_s, k_s, d, s);
    fma_abt(g_s, v_s, d, dp);
#pragma unroll
    for (int i = 0; i < kOwn; ++i)
#pragma unroll
      for (int j = 0; j < kStr; ++j) {
        const bool ok = c0 + tx + 16 * j < n;
        const float p = ok ? expf(fminf(s[i][j], kSoftmaxClamp)) * inv_l[i] : 0.f;
        ds_s[(ty + 16 * i) * kLdt + tx + 16 * j] =
            s[i][j] < kSoftmaxClamp ? p * (dp[i][j] - delta[i]) : 0.f;
      }
    __syncthreads();
    fma_ab(ds_s, k_s, n - c0, d, acc);
  }

  store_rows_f32(dqkv + head, qkv_stride, r0, n, d, scale, acc);
  if (tx == 0) {
    float* l_g = row_sum + ((int64_t)b * nb_heads + h) * n;
    float* dl_g = row_delta + ((int64_t)b * nb_heads + h) * n;
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int row = r0 + ty + 16 * i;
      if (row < n) { l_g[row] = l[i]; dl_g[row] = delta[i]; }
    }
  }
}

__global__ void __launch_bounds__(kFmaThreads)
fused_mha_bwd_dkv_f32_kernel(const float* __restrict__ qkv,
                             const float* __restrict__ grad,
                             float* __restrict__ dqkv,
                             const float* __restrict__ row_sum,
                             const float* __restrict__ row_delta, int n,
                             int nb_heads, int d, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* k_s = smem;
  float* v_s = k_s + kRows * ld;
  float* q_s = v_s + kRows * ld;      // not scaled
  float* g_s = q_s + kRows * ld;
  float* p_s = g_s + kRows * ld;      // kRows x kLdt
  float* ds_s = p_s + kRows * kLdt;   // kRows x kLdt
  float* l_s = ds_s + kRows * kLdt;
  float* dl_s = l_s + kFmaCols;

  const int r0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int dim = nb_heads * d;
  const int64_t qkv_stride = 3 * (int64_t)dim;
  const int64_t head = (int64_t)b * n * qkv_stride + (int64_t)h * d;
  const float* q_g = qkv + head;
  const float* k_g = q_g + dim;
  const float* v_g = q_g + 2 * dim;
  const float* g_g = grad + (int64_t)b * n * dim + (int64_t)h * d;
  const float* l_g = row_sum + ((int64_t)b * nb_heads + h) * n;
  const float* dl_g = row_delta + ((int64_t)b * nb_heads + h) * n;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_rows_f32(k_g, k_s, r0, n, d, qkv_stride, 1.f);
  load_rows_f32(v_g, v_s, r0, n, d, qkv_stride, 1.f);

  float dk[kOwn][kDims], dv[kOwn][kDims];
#pragma unroll
  for (int i = 0; i < kOwn; ++i)
#pragma unroll
    for (int c = 0; c < kDims; ++c) dk[i][c] = dv[i][c] = 0.f;

  float s[kOwn][kStr], dp[kOwn][kStr];
  for (int c0 = 0; c0 < n; c0 += kFmaCols) {
    __syncthreads();  // previous tile fully read (and own tiles written)
    load_rows_f32(q_g, q_s, c0, n, d, qkv_stride, 1.f);
    load_rows_f32(g_g, g_s, c0, n, d, dim, 1.f);
    for (int i = threadIdx.x; i < kFmaCols; i += kFmaThreads) {
      const bool ok = c0 + i < n;
      l_s[i] = ok ? l_g[c0 + i] : 1.f;
      dl_s[i] = ok ? dl_g[c0 + i] : 0.f;
    }
    __syncthreads();
    fma_abt(k_s, q_s, d, s);     // s^T / scale: own keys x streamed queries
    fma_abt(v_s, g_s, d, dp);    // dp^T
#pragma unroll
    for (int i = 0; i < kOwn; ++i)
#pragma unroll
      for (int j = 0; j < kStr; ++j) {
        const int q = tx + 16 * j;
        const float x = s[i][j] * scale;
        const float p = c0 + q < n ? expf(fminf(x, kSoftmaxClamp)) / l_s[q] : 0.f;
        p_s[(ty + 16 * i) * kLdt + q] = p;
        ds_s[(ty + 16 * i) * kLdt + q] =
            x < kSoftmaxClamp ? p * (dp[i][j] - dl_s[q]) : 0.f;
      }
    __syncthreads();
    fma_ab(p_s, g_s, n - c0, d, dv);
    fma_ab(ds_s, q_s, n - c0, d, dk);
  }

  store_rows_f32(dqkv + head + dim, qkv_stride, r0, n, d, scale, dk);
  store_rows_f32(dqkv + head + 2 * dim, qkv_stride, r0, n, d, 1.f, dv);
}

int launch_f32(const void* qkv, const void* grad, void* dqkv, float* row_sum,
               float* row_delta, int batch, int n, int nb_heads, int d,
               float scale, cudaStream_t stream) {
  const size_t smem = fma_smem_bytes(d);
  const dim3 grid((n + kRows - 1) / kRows, nb_heads, batch);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mha_bwd_dq_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_mha_bwd_dq_f32_kernel<<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(grad),
      static_cast<float*>(dqkv), row_sum, row_delta, n, nb_heads, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fused_mha_bwd_dkv_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_mha_bwd_dkv_f32_kernel<<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(grad),
      static_cast<float*>(dqkv), row_sum, row_delta, n, nb_heads, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. row_sum and row_delta: f32 (B, H, N)
// scratch. Returns a cudaError_t value (0 = ok).
extern "C" int tfimm_fused_mha_bwd(const void* qkv, const void* grad,
                                   void* dqkv, void* row_sum, void* row_delta,
                                   int batch, int n, int nb_heads,
                                   int head_dim, float scale, int dtype,
                                   void* stream) {
  if (batch <= 0 || n <= 0 || nb_heads <= 0 || head_dim <= 0 ||
      head_dim % 8 != 0 || head_dim > kMaxHeadDim || batch > 65535 ||
      nb_heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(row_sum);
  float* dl = static_cast<float*>(row_delta);
  switch (dtype) {
    case 0:
      return launch_f32(qkv, grad, dqkv, l, dl, batch, n, nb_heads, head_dim,
                        scale, s);
    case 1:
      if (reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
          reinterpret_cast<uintptr_t>(grad) % 16 != 0 ||
          reinterpret_cast<uintptr_t>(dqkv) % 16 != 0)
        return (int)cudaErrorMisalignedAddress;
      return dispatch_bf16(qkv, grad, dqkv, l, dl, batch, n, nb_heads,
                           head_dim, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
