// Backward of the windowed multi-head attention with the relative-position
// bias and the shifted-window mask (Swin), straight into the packed qkv
// layout, with the bias gradient summed over every window.
//
// Replaces: tfimm_tpu/ops/pallas/window_mha.py · _window_mha_bwd_call (the
// Pallas TPU backward of window_mha_diff). Same function: from qkv
// (BW, N, 3C) in timm's (3, H, d) order, g = dL/dout (BW, N, C), the bias
// (H, N, N) f32 and the optional mask (nW, N, N) f32 applied to window row r
// as mask[r % nW], compute dqkv (BW, N, 3C) in qkv's layout and dtype and
// dbias (H, N, N) f32. Per window and head, with the softmax recomputed
// (nothing from the forward is stored):
//
//     s  = (q_f32 * scale) @ k_f32^T + bias[h] (+ mask[r % nW])   (f32)
//     p  = exp(min(s, 80)) / rowsum                 (clamped no-max softmax)
//     dv = p^T @ g,   dp = g @ v^T
//     ds = where(s < 80, p * (dp - rowsum(dp * p)), 0)   (clamp mask)
//     dq = scale * ds @ k,   dk = scale * ds^T @ q
//     dbias[h] += ds                                 (summed over windows)
//
// The mask gets no gradient: it is a constant, as in the JAX package.
//
// The bias gradient is a reduction over all BW windows, which the TPU
// kernel keeps resident across its sequential grid. Here it is a
// deterministic two-level sum without atomics: a block owns one head and a
// group of windows, every element of its (N, N) f32 sum belongs to one
// thread, which adds its windows' ds in a fixed order; at the end of the
// group the sum goes to an f32 partial (groups, H, N, N), and a second
// launch sums the partials over the groups in a fixed order (the two
// launches count as one). Writing ds per window instead would add
// 2 * BW * H * N^2 * 4 bytes of traffic.
//
// What bounds it on an H100: at Swin-T's stage 1 in training (BW = 4096
// windows at batch 64, N = 49, C = 96, H = 3, the shift mask of 64 windows)
// one call reads q, k, v and g and writes dq, dk and dv, 7 * BW * N * C * 2
// = 270 MB, against 5 products of 2 * BW * H * N^2 * d = 1.9 GFLOP each:
// device memory bounds it (about 80 us at 3.35 TB/s). Three bodies:
//
// - bf16 on Hopper (tma.py · window_route, as the forward's;
//   window_mha_common.cuh): TMA + wgmma, five products in one pass, one
//   64-row tile a window. qkv is a 5-D TMA tensor (d, H, 3, N, BW) through
//   its own strides and g a 4-D one (d, H, N, BW), so a box is one head of
//   one window's q, k, v or g, with zeros past N and past d; dq, dk and dv
//   go out from the warpgroup's own tiles by plain 16-byte stores of their
//   first N rows and d columns (a TMA store queues behind the ring's loads,
//   window_mha.cu's note). A
//   block owns one head and a group of its windows in the order of the
//   mask positions; the wrapper sizes the groups so that one block runs on
//   each SM. One producer warp streams each window's q, k, v and g through
//   a ring of kStages stages; two consumer warpgroups take alternate
//   windows. Per window a consumer computes S = q k^T and dP = g v^T in one
//   wgmma group (both K-major), adds the resident bias + mask (summed in
//   f32, scaled by log2(e), loaded once a mask position), takes p = e /
//   rowsum with e = 2^min(scale log2(e) s + bm, 80 log2(e)): a row lies in
//   one tile, so l and delta = rowsum(p dp) (f32 p and dp) are complete in
//   registers, and ds = where(at the clamp, 0, p (dp - delta)) in f32 is
//   added to its bias-gradient sum, held in the layout of S in shared
//   memory (in registers it made ptxas spill). p and ds are
//   rounded to bf16 into shared memory, the A operands of dq = scale ds k
//   (K-major), then dk = scale ds^T q and dv = p^T g (transposed) in a
//   second group, k, q and g as MN-major B operands. So five products
//   where the first body takes seven. At the end the second warpgroup hands
//   its sum to the first through shared memory, which adds the two (a fixed
//   order) and writes the partial. Departures: as the forward's (the bias
//   and mask summed first, log2(e) folded in, p = e (1 / rowsum), d = 32 in
//   64-column boxes).
// - bf16 off that route (N up to 144, d up to 128, misaligned operands):
//   the first design, one thread block per (group of windows, head) of 4
//   warps, tensor cores through mma.sync m16n8k16 (bf16 in, f32
//   accumulate). Per window it holds q, k, v and g of its head in shared
//   memory and runs two phases:
//   1. Query rows, 16 to a warp: s = q k^T and dp = g v^T in registers; l
//      and delta are complete before p is rounded; ds is formed, added to
//      the block's f32 bias-gradient tile, and multiplied with k into dq.
//      l and delta go to shared memory.
//   2. Key rows, 16 to a warp: s^T = k q^T and dp^T = v g^T again, p^T and
//      ds^T from l and delta, then dv = p^T g and dk = scale * ds^T q.
//   Up to N = 64 the block stages bias[h] + mask[w % nW] (added in f32
//   first) in shared memory for each window. q, k, v and g are stored with
//   N padded to NP (64 or 144) rows and d padded to DP (32, 64 or 128)
//   columns with zeros, rows padded by 8 elements against bank conflicts
//   (not at NP = 144 with DP = 128, where the padding would not fit beside
//   the bias tile). The wrapper picks the group size so that about 1024
//   blocks run.
// - f32: plain f32 FMAs (TF32 would miss the f32 bar). Phase 1 holds k and
//   v, phase 2 q and g, each (N, d + 1) in shared memory; one warp per row,
//   the lanes over the other side's rows for the scores and over head
//   columns for the products. Its bias tile would not fit beside them at
//   N = 144, d = 128, so each thread adds its elements straight into the
//   block's partial in device memory (still one owner per element).
//
// In bf16 both bodies keep s, l, dp, delta, the bias sums and every
// accumulation in f32, and round p and ds to bf16 before the products dv,
// dq and dk (the tensor cores take bf16 operands), where the JAX backward
// computes all five products in f32.
//
// Coverage: the forward's. Any BW, N <= 144, any H, d a multiple of 8 up to
// 128, nW dividing BW, qkv with any batch and row strides whose last
// dimension is 1; g contiguous (BW, N, C); dqkv written contiguous. Every
// launch is followed by cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "window_mha_common.cuh"

namespace {

constexpr int kThreads = 128;             // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr float kSoftmaxClamp = 80.0f;    // dispatch.py SOFTMAX_CLAMP
constexpr int kMaxN = 144;
constexpr int kMaxHeadDim = 128;

struct BwdArgs {
  const void* qkv;      // (BW, N, 3 H d), last dimension contiguous
  int64_t qkv_bs, qkv_rs;
  const void* g;        // (BW, N, H d) contiguous
  const float* bias;    // (H, N, N)
  const float* mask;    // (nW, N, N) or null
  void* dqkv;           // (BW, N, 3 H d) contiguous
  float* partial;       // (groups, H, N, N)
  int bw, n, nb_heads, d, nb_win, group;
  float scale;
  int vec_qkv, vec_g;   // 16-byte loads allowed
};

// x + bias[h][q][k] (+ mask[w % nW][q][k]) for the scaled score x of query
// q and key k of window w, both < n.
__device__ __forceinline__ float biased(const BwdArgs& a, int w, int h, int q,
                                        int k, float x) {
  const int64_t nn = (int64_t)a.n * a.n;
  const int64_t qk = (int64_t)q * a.n + k;
  x += __ldg(a.bias + h * nn + qk);
  if (a.mask != nullptr) x += __ldg(a.mask + (w % a.nb_win) * nn + qk);
  return x;
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

// Row stride of a shared-memory tile, in bf16 elements.
template <int DP, int NP>
__host__ __device__ constexpr int tile_ld() {
  return (DP == kMaxHeadDim && NP == kMaxN) ? DP : DP + 8;
}

// Whether a block stages the window's bias plus mask in shared memory (up
// to N = 64; the N = 144 tiles leave no room and read both from L2).
template <int NP>
__host__ __device__ constexpr bool staged() { return NP <= 64; }

// q, k, v, g tiles, then l and delta (NP each, f32), then the (n, n) f32
// bias-gradient tile and, if staged, the (n, n) f32 bias plus mask.
template <int DP, int NP>
size_t mma_smem_bytes(int n) {
  return sizeof(__nv_bfloat16) * 4 * (size_t)NP * tile_ld<DP, NP>() +
         sizeof(float) * (2 * (size_t)NP + (staged<NP>() ? 2 : 1) * (size_t)n * n);
}

// One head of a window's rows into shared memory (NP x DP); rows at or
// beyond n and columns at or beyond d become zeros.
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
    *reinterpret_cast<uint4*>(dst + r * tile_ld<DP, NP>() + c) = u;
  }
}

// c[j] = A[r, r + 16) . B[8j, 8j + 8)^T over the (padded) head dim: the
// warp's 16 rows of A against all NP rows of B. Element c[j][i] sits at A
// row r + g + 8 * (i / 2), B row 8j + 2t + i % 2.
template <int DP, int NP>
__device__ __forceinline__ void warp_abt(const __nv_bfloat16* a_s, int r,
                                         const __nv_bfloat16* b_s,
                                         float (&c)[NP / 8][4]) {
  constexpr int LD = tile_ld<DP, NP>();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const __nv_bfloat16* pa = a_s + (r + g) * LD + ks * 16 + 2 * t;
    const uint32_t af[4] = {ld_u32(pa), ld_u32(pa + 8 * LD), ld_u32(pa + 8),
                            ld_u32(pa + 8 * LD + 8)};
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const __nv_bfloat16* pb = b_s + (8 * j + g) * LD + ks * 16 + 2 * t;
      mma_16816(c[j], af, ld_u32(pb), ld_u32(pb + 8));
    }
  }
}

// acc += X @ B: X (16 rows x NP) given as A fragments, one per 16-deep
// step, times B (NP rows x DP). Steps whose 16 rows of B all lie at or
// beyond n are skipped.
template <int DP, int NP>
__device__ __forceinline__ void warp_ab(const uint32_t (&x)[NP / 16][4],
                                        const __nv_bfloat16* b_s, int n,
                                        float (&acc)[DP / 8][4]) {
  constexpr int LD = tile_ld<DP, NP>();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int jd = 0; jd < DP / 8; ++jd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[jd][i] = 0.f;
#pragma unroll
  for (int m = 0; m < NP / 16; ++m) {
    if (16 * m >= n) break;
#pragma unroll
    for (int jd = 0; jd < DP / 8; ++jd) {
      const __nv_bfloat16* p = b_s + (16 * m + 2 * t) * LD + 8 * jd + g;
      mma_16816(acc[jd], x[m], pack_bf16(p[0], p[LD]),
                pack_bf16(p[8 * LD], p[9 * LD]));
    }
  }
}

// The values v of c[j] (see warp_abt) into the A fragments of warp_ab.
template <int NP>
__device__ __forceinline__ void pack_frag(uint32_t (&x)[NP / 16][4], int j,
                                          const float (&v)[4]) {
  x[j / 2][(j % 2) * 2 + 0] = pack_bf16(v[0], v[1]);
  x[j / 2][(j % 2) * 2 + 1] = pack_bf16(v[2], v[3]);
}

// Sum over the 4 lanes that hold one row of a warp_abt product.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows row and row + 8 of a 16-row accumulator, times mul, into out (row
// stride ld_out) where they lie below n.
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

// Up to N = 64, four blocks share an SM (at most 128 registers a thread);
// the N = 144 tiles take what registers they need.
template <int DP, int NP>
__global__ void __launch_bounds__(kThreads, NP <= 64 ? 4 : 1)
window_mha_bwd_bf16_kernel(BwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = tile_ld<DP, NP>();
  constexpr int kTiles = NP / 8;           // 8-wide tiles of a score row
  constexpr int kRowTiles = NP / 16;       // 16-row tiles
  constexpr int kBits = (kTiles * 4 + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + NP * LD;
  bf16* v_s = k_s + NP * LD;
  bf16* g_s = v_s + NP * LD;
  float* l_s = reinterpret_cast<float*>(g_s + NP * LD);
  float* dl_s = l_s + NP;
  float* db_s = dl_s + NP;                 // n x n

  const int h = blockIdx.y;
  const int w0 = blockIdx.x * a.group;
  const int w1 = min(w0 + a.group, a.bw);
  const int n = a.n, d = a.d, dim = a.nb_heads * d;
  const int64_t hd = (int64_t)h * d;
  float* bm_s = db_s + n * n;              // n x n, if staged
  for (int i = threadIdx.x; i < n * n; i += kThreads) db_s[i] = 0.f;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  for (int w = w0; w < w1; ++w) {
    __syncthreads();  // the previous window fully read (and db_s zeroed)
    const bf16* src = static_cast<const bf16*>(a.qkv) + w * a.qkv_bs + hd;
    load_tile<DP, NP>(src, a.qkv_rs, q_s, n, d, a.vec_qkv);
    load_tile<DP, NP>(src + dim, a.qkv_rs, k_s, n, d, a.vec_qkv);
    load_tile<DP, NP>(src + 2 * dim, a.qkv_rs, v_s, n, d, a.vec_qkv);
    load_tile<DP, NP>(static_cast<const bf16*>(a.g) + (int64_t)w * n * dim + hd,
                      dim, g_s, n, d, a.vec_g);
    if constexpr (staged<NP>()) {
      const float* bias = a.bias + (int64_t)h * n * n;
      const float* mask =
          a.mask == nullptr ? nullptr : a.mask + (int64_t)(w % a.nb_win) * n * n;
      for (int i = threadIdx.x; i < n * n; i += kThreads)
        bm_s[i] = __ldg(bias + i) + (mask == nullptr ? 0.f : __ldg(mask + i));
    }
    __syncthreads();
    // The scaled score x of query q and key k with the bias and mask added.
    auto add_bias = [&](int q, int k, float x) {
      if constexpr (staged<NP>()) return x + bm_s[q * n + k];
      return biased(a, w, h, q, k, x);
    };
    bf16* out = static_cast<bf16*>(a.dqkv) + (int64_t)w * n * 3 * dim + hd;
    const int64_t ld_out = 3 * (int64_t)dim;

    // Phase 1: query rows. dq, the bias gradient, l and delta.
    for (int rt = warp; rt < kRowTiles; rt += kWarps) {
      const int wr = rt * 16;
      if (wr >= n) break;
      float s[kTiles][4], dp[kTiles][4];
      warp_abt<DP, NP>(q_s, wr, k_s, s);
      warp_abt<DP, NP>(g_s, wr, v_s, dp);
      // Elements 0, 1 lie on row wr + g, elements 2, 3 on row wr + g + 8,
      // at keys 8 j + 2 t and 8 j + 2 t + 1.
      const int row_lo = wr + g, row_hi = row_lo + 8;
      uint32_t clamped[kBits] = {};
      float l[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? row_lo : row_hi;
          const int col = 8 * j + 2 * t + (e & 1);
          float p = 0.f;
          if (row < n && col < n) {
            const float x = add_bias(row, col, s[j][e] * a.scale);
            if (x >= kSoftmaxClamp) clamped[(4 * j + e) / 32] |= 1u << ((4 * j + e) % 32);
            p = expf(fminf(x, kSoftmaxClamp));
          }
          s[j][e] = p;
          l[e / 2] += p;
        }
      l[0] = quad_sum(l[0]);
      l[1] = quad_sum(l[1]);
      if (row_lo >= n) l[0] = 1.f;         // pad rows: all zeros
      if (row_hi >= n) l[1] = 1.f;
      float delta[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] /= l[e / 2];
          delta[e / 2] += s[j][e] * dp[j][e];
        }
      delta[0] = quad_sum(delta[0]);
      delta[1] = quad_sum(delta[1]);

      uint32_t dsf[kRowTiles][4];
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? row_lo : row_hi;
          const int col = 8 * j + 2 * t + (e & 1);
          const bool clamp = (clamped[(4 * j + e) / 32] >> ((4 * j + e) % 32)) & 1u;
          ds[e] = clamp ? 0.f : s[j][e] * (dp[j][e] - delta[e / 2]);
          if (row < n && col < n) db_s[row * n + col] += ds[e];
        }
        pack_frag<NP>(dsf, j, ds);
      }
      float acc[DP / 8][4];
      warp_ab<DP, NP>(dsf, k_s, n, acc);
      store_rows<DP>(out, ld_out, row_lo, n, d, a.scale, acc);
      if (t == 0) {
        if (row_lo < n) { l_s[row_lo] = l[0]; dl_s[row_lo] = delta[0]; }
        if (row_hi < n) { l_s[row_hi] = l[1]; dl_s[row_hi] = delta[1]; }
      }
    }
    __syncthreads();  // l and delta of every query row

    // Phase 2: key rows. dk and dv.
    for (int rt = warp; rt < kRowTiles; rt += kWarps) {
      const int wr = rt * 16;
      if (wr >= n) break;
      float s[kTiles][4], dp[kTiles][4];
      warp_abt<DP, NP>(k_s, wr, q_s, s);   // s^T: keys x queries
      warp_abt<DP, NP>(v_s, wr, g_s, dp);  // dp^T
      const int key_lo = wr + g, key_hi = key_lo + 8;
      uint32_t pf[kRowTiles][4], dsf[kRowTiles][4];
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? key_lo : key_hi;
          const int query = 8 * j + 2 * t + (e & 1);
          p[e] = ds[e] = 0.f;
          if (key < n && query < n) {
            const float x = add_bias(query, key, s[j][e] * a.scale);
            p[e] = expf(fminf(x, kSoftmaxClamp)) / l_s[query];
            if (x < kSoftmaxClamp) ds[e] = p[e] * (dp[j][e] - dl_s[query]);
          }
        }
        pack_frag<NP>(pf, j, p);
        pack_frag<NP>(dsf, j, ds);
      }
      float acc[DP / 8][4];
      warp_ab<DP, NP>(pf, g_s, n, acc);
      store_rows<DP>(out + 2 * dim, ld_out, key_lo, n, d, 1.f, acc);
      warp_ab<DP, NP>(dsf, q_s, n, acc);
      store_rows<DP>(out + dim, ld_out, key_lo, n, d, a.scale, acc);
    }
  }

  __syncthreads();
  float* part = a.partial + ((int64_t)blockIdx.x * a.nb_heads + h) * n * n;
  for (int i = threadIdx.x; i < n * n; i += kThreads) part[i] = db_s[i];
}

template <int DP, int NP>
int launch_bf16(const BwdArgs& a, int groups, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<DP, NP>(a.n);
  cudaError_t err = cudaFuncSetAttribute(
      window_mha_bwd_bf16_kernel<DP, NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_mha_bwd_bf16_kernel<DP, NP><<<dim3(groups, a.nb_heads), kThreads,
                                       smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Fewer tile shapes than the forward (N <= 64 pads to 64, d <= 32 to 32),
// which halves this file's build time; only the edges pay for the padding.
template <int DP>
int dispatch_n(const BwdArgs& a, int groups, cudaStream_t s) {
  if (a.n <= 64) return launch_bf16<DP, 64>(a, groups, s);
  return launch_bf16<DP, kMaxN>(a, groups, s);
}

int dispatch_bf16(const BwdArgs& a, int groups, cudaStream_t s) {
  if (a.d <= 32) return dispatch_n<32>(a, groups, s);
  if (a.d <= 64) return dispatch_n<64>(a, groups, s);
  return dispatch_n<kMaxHeadDim>(a, groups, s);
}

// ---------------------------------------------------------------------------
// bf16 on Hopper: TMA + wgmma (window_mha_common.cuh)

constexpr int kStages = 4;                // ring stages of (q, k, v, g)

struct TcArgs {
  const float* bias;    // (H, N, N)
  const float* mask;    // (nW, N, N) or null
  __nv_bfloat16* dqkv;  // (BW, N, 3 H d) contiguous
  float* partial;       // (groups, H, N, N)
  int bw, n, d, nb_heads;
  int per_pos, nb_pos;  // windows a mask position, positions (1 unmasked)
  int group;            // list entries a block
  float scale, scale_log2;
};

struct TcTiles {
  static constexpr int kStage = 4 * wtc::kTileBytes;   // q, k, v, g
  static constexpr int kRing = 0;
  // A consumer's own tiles: p, ds and dq (then dv, dk and dq for the
  // stores; p's and ds's stage the bias + mask when it is reloaded).
  static constexpr int kOwn = kRing + kStages * kStage;
  static constexpr int kOwnBytes = 3 * wtc::kTileBytes;
  // A consumer's bias-gradient sum (f32, thread-major: entry i of thread t
  // at 128 i + t, the layout of S).
  static constexpr int kSum = kOwn + wtc::kConsumers * kOwnBytes;
  static constexpr int kSumBytes = 32 * 128 * 4;
  static constexpr int kBars = kSum + wtc::kConsumers * kSumBytes;
  // full[stages], empty[stages]; 1024 bytes of slack for alignment.
  static constexpr int kBytes = kBars + 8 * 2 * kStages + 1024;
};

__global__ void __launch_bounds__(wtc::kThreads, 1)
window_mha_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap qkv_map,
                            const __grid_constant__ CUtensorMap g_map,
                            TcArgs a) {
  using L = TcTiles;
  using wtc::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* ring = smem + L::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;

  const int h = blockIdx.y;
  const int i0 = blockIdx.x * a.group;
  const int count = min(a.group, a.bw - i0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], 4);   // one arrival a warp of a consumer
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {
    // Producer: each window's q, k, v and g tiles of head h, in list order.
    hopper::setmaxnreg_dec<wtc::kProducerRegs>();
    if (threadIdx.x == 0) {
      for (int t = 0; t < count; ++t) {
        const int st = t % kStages;
        if (t >= kStages) hopper::mbar_wait(&empty[st], ((t / kStages) & 1) ^ 1);
        int pos;
        const int r = wtc::window_at(i0 + t, a.per_pos, a.nb_pos, &pos);
        uint8_t* stage = ring + st * L::kStage;
        hopper::mbar_expect_tx(&full[st], L::kStage);
        for (int part = 0; part < 3; ++part)
          hopper::tma_load_5d(stage + part * kTileBytes, &qkv_map, &full[st],
                              0, h, part, 0, r);
        hopper::tma_load_4d(stage + 3 * kTileBytes, &g_map, &full[st], 0, h, 0,
                            r);
      }
    }
    return;
  }

  // Consumer warpgroup wg: list entries wg, wg + 2, ...
  hopper::setmaxnreg_inc<wtc::kConsumerRegs>();
  const int wg = warp / 4 - 1, tid = threadIdx.x % 128;
  const int row = (tid / 32) * 16 + lane / 4, t4 = lane % 4;   // and row + 8
  const int nb_k = (a.d + 15) / 16;             // k16 steps over the head dim
  const int nb_keys = (a.n + 15) / 16;          // k16 steps over the window
  const int64_t nn = (int64_t)a.n * a.n;
  uint8_t* own = smem + L::kOwn + wg * L::kOwnBytes;
  uint8_t* p_s = own;                    // p, then dv
  uint8_t* ds_s = own + kTileBytes;      // ds, then dk
  uint8_t* dq_s = own + 2 * kTileBytes;  // dq
  // The bias gradient's sum waits in shared memory between windows, so that
  // the products' accumulators fit the registers beside the bias.
  float* db_s = reinterpret_cast<float*>(smem + L::kSum) + wg * 32 * 128;
#pragma unroll
  for (int i = 0; i < 32; ++i) db_s[128 * i + tid] = 0.f;
  float bm[32];
  int bm_pos = -1;
  for (int t = wg; t < count; t += wtc::kConsumers) {
    const int st = t % kStages;
    int pos;
    const int r = wtc::window_at(i0 + t, a.per_pos, a.nb_pos, &pos);
    if (pos != bm_pos) {
      // Staged in the p and ds tiles (16 KB), free once the last window's
      // gradients are stored (load_bias's first barrier).
      wtc::load_bias(bm, reinterpret_cast<float*>(p_s), a.bias + h * nn,
                     a.mask == nullptr ? nullptr : a.mask + pos * nn, a.n,
                     tid, 1 + wg);
      bm_pos = pos;
    }
    const uint8_t* stage = ring + st * L::kStage;
    const uint8_t* q_t = stage;
    const uint8_t* k_t = stage + kTileBytes;
    const uint8_t* v_t = stage + 2 * kTileBytes;
    const uint8_t* g_t = stage + 3 * kTileBytes;
    hopper::mbar_wait(&full[st], (t / kStages) & 1);

    // S = q k^T and dP = g v^T, one group.
    float s[32], dp[32];
    wtc::zero(s);
    wtc::zero(dp);
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      if (ks < nb_k) {
        hopper::wgmma_m64n64k16_ss<0>(s, hopper::sw128_desc(q_t) + 2 * ks,
                                      hopper::sw128_desc(k_t) + 2 * ks, ks > 0);
        hopper::wgmma_m64n64k16_ss<0>(dp, hopper::sw128_desc(g_t) + 2 * ks,
                                      hopper::sw128_desc(v_t) + 2 * ks, ks > 0);
      }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);

    // p (f32, in s), delta = rowsum(p dp), ds (f32, in dp) and its sum.
    const uint32_t clamped =
        wtc::softmax_tile(s, bm, a.scale_log2, row < a.n, row + 8 < a.n);
    float d_lo = 0.f, d_hi = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) d_hi += s[i] * dp[i]; else d_lo += s[i] * dp[i];
    }
    d_lo = wtc::quad_sum(d_lo);
    d_hi = wtc::quad_sum(d_hi);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      dp[i] = (clamped >> i) & 1u ? 0.f : s[i] * (dp[i] - (i & 2 ? d_hi : d_lo));
      db_s[128 * i + tid] += dp[i];
    }
    // p and ds (bf16) into this warpgroup's tiles once every thread has
    // stored the last window's gradients from them.
    hopper::named_barrier(1 + wg, 128);
    wtc::write_tile(p_s, s, 1.f, tid);
    wtc::write_tile(ds_s, dp, 1.f, tid);
    hopper::fence_proxy_async();
    hopper::named_barrier(1 + wg, 128);

    // dq = ds k (ds K-major) into its tile, then dk = ds^T q and dv = p^T g
    // (p and ds transposed) in one group; all from shared memory, k, q and
    // g MN-major. Two groups keep two accumulators live beside the bias:
    // with all three ptxas spilled.
    float dq[32];
    wtc::zero(dq);
    hopper::fence_regs(dq);
    hopper::wgmma_fence();
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (m < nb_keys)
        hopper::wgmma_m64n64k16_ss<1>(dq, hopper::sw128_desc(ds_s) + 2 * m,
                                      hopper::sw128_desc(k_t) + 128 * m, m > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dq);
    wtc::write_tile(dq_s, dq, a.scale, tid);
    float dk[32], dv[32];
    wtc::zero(dk);
    wtc::zero(dv);
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
    hopper::wgmma_fence();
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (m < nb_keys) {
        hopper::wgmma_m64n64k16_ss<1, 1>(dk, hopper::sw128_desc(ds_s) + 128 * m,
                                         hopper::sw128_desc(q_t) + 128 * m,
                                         m > 0);
        hopper::wgmma_m64n64k16_ss<1, 1>(dv, hopper::sw128_desc(p_s) + 128 * m,
                                         hopper::sw128_desc(g_t) + 128 * m,
                                         m > 0);
      }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);

    // dk and dv into the own tiles (every warp's products have read p and
    // ds), then dq, dk and dv's first n rows and d columns into the packed
    // dqkv.
    hopper::named_barrier(1 + wg, 128);
    wtc::write_tile(ds_s, dk, a.scale, tid);
    wtc::write_tile(p_s, dv, 1.f, tid);
    hopper::named_barrier(1 + wg, 128);
    const int64_t ld = 3 * (int64_t)a.nb_heads * a.d;
    __nv_bfloat16* out = a.dqkv + (int64_t)r * a.n * ld + h * a.d;
    wtc::store_rows(dq_s, out, ld, a.n, a.d, tid);
    wtc::store_rows(ds_s, out + ld / 3, ld, a.n, a.d, tid);
    wtc::store_rows(p_s, out + 2 * (ld / 3), ld, a.n, a.d, tid);
  }

  // The first warpgroup adds the second's sum to its own (a fixed order)
  // and writes the block's partial.
  hopper::named_barrier(3, 256);
  if (wg == 1) return;
  const float* other = db_s + 32 * 128;
  float* part = a.partial + ((int64_t)blockIdx.x * a.nb_heads + h) * nn;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = row + (e & 2 ? 8 : 0), c = 8 * j + 2 * t4 + (e & 1);
      const int i = 4 * j + e;
      if (rr < a.n && c < a.n)
        part[rr * a.n + c] = db_s[128 * i + tid] + other[128 * i + tid];
    }
}

// maps: the qkv and g geometries of tma.py · window_bwd_maps.
int launch_wgmma(const BwdArgs& b, const int64_t* maps, int groups,
                 cudaStream_t stream) {
  CUtensorMap tmaps[2];
  const void* bases[2] = {b.qkv, b.g};
  for (int i = 0; i < 2; ++i) {
    const int err = hopper::encode_bf16_map(&tmaps[i], bases[i],
                                            maps + i * hopper::kGeometrySize);
    if (err != 0) return err;
  }
  const int nb_pos = b.mask == nullptr ? 1 : b.nb_win;
  const TcArgs a = {b.bias, b.mask, static_cast<__nv_bfloat16*>(b.dqkv),
                    b.partial, b.bw, b.n, b.d, b.nb_heads,
                    b.bw / nb_pos, nb_pos, b.group, b.scale,
                    b.scale * wtc::kLog2e};
  constexpr int smem = TcTiles::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      window_mha_bwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  window_mha_bwd_wgmma_kernel<<<dim3(groups, b.nb_heads), wtc::kThreads, smem,
                                stream>>>(tmaps[0], tmaps[1], a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: FMA

constexpr int kLaneRows = (kMaxN + 31) / 32;   // other-side rows per lane
constexpr int kLaneCols = kMaxHeadDim / 32;    // head columns per lane

// Two (n, d + 1) tiles, l and delta, and per warp two head rows and two
// score rows.
size_t fma_smem_bytes(int n, int d) {
  return sizeof(float) * ((size_t)2 * n * (d + 1) + 2 * (size_t)n +
                          (size_t)kWarps * (2 * d + 2 * n));
}

// One head of a window's rows into an (n, d + 1) tile, times mul.
__device__ __forceinline__ void load_rows_f32(const float* __restrict__ src,
                                              int64_t row_stride, float* dst,
                                              int n, int d, float mul) {
  for (int i = threadIdx.x; i < n * d; i += kThreads) {
    const int r = i / d, c = i % d;
    dst[r * (d + 1) + c] = src[(int64_t)r * row_stride + c] * mul;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
window_mha_bwd_f32_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int n = a.n, d = a.d, ld = d + 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* x_s = smem;                 // phase 1: k; phase 2: q * scale
  float* y_s = x_s + n * ld;         // phase 1: v; phase 2: g
  float* l_s = y_s + n * ld;
  float* dl_s = l_s + n;
  float* r0 = dl_s + n + warp * (2 * d + 2 * n);  // this warp's head rows ...
  float* r1 = r0 + d;
  float* p_row = r1 + d;                          // ... and score rows
  float* ds_row = p_row + n;

  const int h = blockIdx.y;
  const int w0 = blockIdx.x * a.group;
  const int w1 = min(w0 + a.group, a.bw);
  const int dim = a.nb_heads * d;
  const int64_t hd = (int64_t)h * d;
  const int64_t ld_out = 3 * (int64_t)dim;
  float* part = a.partial + ((int64_t)blockIdx.x * a.nb_heads + h) * n * n;

  for (int w = w0; w < w1; ++w) {
    const float* q = static_cast<const float*>(a.qkv) + w * a.qkv_bs + hd;
    const float* k = q + dim;
    const float* v = q + 2 * dim;
    const float* gr = static_cast<const float*>(a.g) + (int64_t)w * n * dim + hd;
    float* out = static_cast<float*>(a.dqkv) + (int64_t)w * n * ld_out + hd;

    __syncthreads();  // the previous window's phase 2 fully read
    load_rows_f32(k, a.qkv_rs, x_s, n, d, 1.f);
    load_rows_f32(v, a.qkv_rs, y_s, n, d, 1.f);
    __syncthreads();

    // Phase 1: one warp per query row; lanes over keys, then over columns.
    for (int row = warp; row < n; row += kWarps) {
      for (int c = lane; c < d; c += 32) {
        r0[c] = q[(int64_t)row * a.qkv_rs + c] * a.scale;
        r1[c] = gr[(int64_t)row * dim + c];
      }
      __syncwarp();
      float xs[kLaneRows], es[kLaneRows], dps[kLaneRows];
      float l = 0.f;
#pragma unroll
      for (int m = 0; m < kLaneRows; ++m) {
        const int j = lane + 32 * m;
        xs[m] = es[m] = dps[m] = 0.f;
        if (j < n) {
          float s = 0.f, dp = 0.f;
          for (int c = 0; c < d; ++c) {
            s = fmaf(r0[c], x_s[j * ld + c], s);
            dp = fmaf(r1[c], y_s[j * ld + c], dp);
          }
          xs[m] = biased(a, w, h, row, j, s);
          es[m] = expf(fminf(xs[m], kSoftmaxClamp));
          dps[m] = dp;
          l += es[m];
        }
      }
      l = warp_sum(l);
      float delta = 0.f;
#pragma unroll
      for (int m = 0; m < kLaneRows; ++m) {
        es[m] /= l;
        delta += es[m] * dps[m];
      }
      delta = warp_sum(delta);
#pragma unroll
      for (int m = 0; m < kLaneRows; ++m) {
        const int j = lane + 32 * m;
        if (j < n) {
          const float ds = xs[m] < kSoftmaxClamp ? es[m] * (dps[m] - delta) : 0.f;
          ds_row[j] = ds;
          float* dst = part + row * n + j;
          *dst = w == w0 ? ds : *dst + ds;
        }
      }
      __syncwarp();
#pragma unroll
      for (int m = 0; m < kLaneCols; ++m) {
        const int c = lane + 32 * m;
        if (c < d) {
          float acc = 0.f;
          for (int j = 0; j < n; ++j) acc = fmaf(ds_row[j], x_s[j * ld + c], acc);
          out[(int64_t)row * ld_out + c] = acc * a.scale;
        }
      }
      if (lane == 0) { l_s[row] = l; dl_s[row] = delta; }
      __syncwarp();                        // r0, r1, ds_row are rewritten next
    }
    __syncthreads();
    load_rows_f32(q, a.qkv_rs, x_s, n, d, a.scale);
    load_rows_f32(gr, dim, y_s, n, d, 1.f);
    __syncthreads();

    // Phase 2: one warp per key row; lanes over queries, then columns.
    for (int key = warp; key < n; key += kWarps) {
      for (int c = lane; c < d; c += 32) {
        r0[c] = k[(int64_t)key * a.qkv_rs + c];
        r1[c] = v[(int64_t)key * a.qkv_rs + c];
      }
      __syncwarp();
#pragma unroll
      for (int m = 0; m < kLaneRows; ++m) {
        const int i = lane + 32 * m;
        if (i < n) {
          float s = 0.f, dp = 0.f;
          for (int c = 0; c < d; ++c) {
            s = fmaf(x_s[i * ld + c], r0[c], s);
            dp = fmaf(y_s[i * ld + c], r1[c], dp);
          }
          const float x = biased(a, w, h, i, key, s);
          const float p = expf(fminf(x, kSoftmaxClamp)) / l_s[i];
          p_row[i] = p;
          ds_row[i] = x < kSoftmaxClamp ? p * (dp - dl_s[i]) : 0.f;
        }
      }
      __syncwarp();
#pragma unroll
      for (int m = 0; m < kLaneCols; ++m) {
        const int c = lane + 32 * m;
        if (c < d) {
          float dv = 0.f, dk = 0.f;
          for (int i = 0; i < n; ++i) {
            dv = fmaf(p_row[i], y_s[i * ld + c], dv);
            dk = fmaf(ds_row[i], x_s[i * ld + c], dk);
          }
          out[(int64_t)key * ld_out + dim + c] = dk;
          out[(int64_t)key * ld_out + 2 * dim + c] = dv;
        }
      }
      __syncwarp();
    }
  }
}

int launch_f32(const BwdArgs& a, int groups, cudaStream_t stream) {
  const size_t smem = fma_smem_bytes(a.n, a.d);
  cudaError_t err = cudaFuncSetAttribute(
      window_mha_bwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_mha_bwd_f32_kernel<<<dim3(groups, a.nb_heads), kThreads, smem,
                              stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dbias = the partials summed over the groups, in a fixed order.

constexpr int kSumThreads = 256;

__global__ void __launch_bounds__(kSumThreads)
dbias_sum_kernel(const float* __restrict__ partial, float* __restrict__ dbias,
                 int groups, int count) {
  const int i = blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= count) return;
  // Four running sums over interleaved groups, so that four loads are in
  // flight; then combined in a fixed order.
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int gi = 0;
  for (; gi + 4 <= groups; gi += 4)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u] += partial[(int64_t)(gi + u) * count + i];
  for (; gi < groups; ++gi) acc[0] += partial[(int64_t)gi * count + i];
  dbias[i] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// qkv: (BW, N, 3 H d) with batch stride qkv_bs and row stride qkv_rs in
// elements (the last dimension contiguous); g (BW, N, H d) contiguous; bias
// (H, N, N) f32; mask (nb_win, N, N) f32 or null; dqkv (BW, N, 3 H d)
// contiguous; partial: f32 scratch of (ceil(BW / group), H, N, N); dbias
// (H, N, N) f32. group: windows per block. dtype: 0 = float32, 1 =
// bfloat16. maps: bf16 on tma.py · window_route only, else null: the
// geometries of the qkv and g tensor maps (hopper::kGeometrySize int64
// values each) of tma.py · packed_window_bwd_maps; they select the TMA +
// wgmma body. Returns a cudaError_t value (0 = ok).
extern "C" int tfimm_window_mha_bwd(const void* qkv, int64_t qkv_bs,
                                    int64_t qkv_rs, const void* g,
                                    const void* bias, const void* mask,
                                    void* dqkv, void* partial, void* dbias,
                                    int bw, int n, int nb_heads, int head_dim,
                                    int nb_win, int group, float scale,
                                    int dtype, const int64_t* maps,
                                    void* stream) {
  if (bw <= 0 || n <= 0 || n > kMaxN || nb_heads <= 0 || nb_heads > 65535 ||
      head_dim <= 0 || head_dim % 8 != 0 || head_dim > kMaxHeadDim ||
      nb_win <= 0 || bw % nb_win != 0 || group <= 0)
    return (int)cudaErrorInvalidValue;
  const int groups = (bw + group - 1) / group;
  BwdArgs a = {qkv, qkv_bs, qkv_rs, g,
               static_cast<const float*>(bias), static_cast<const float*>(mask),
               dqkv, static_cast<float*>(partial),
               bw, n, nb_heads, head_dim, nb_win, group, scale, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (maps != nullptr) {
    if (dtype != 1 || n > wtc::kTile || head_dim > wtc::kTile)
      return (int)cudaErrorInvalidValue;
    if (!aligned16(qkv) || !aligned16(g) || !aligned16(dqkv))
      return (int)cudaErrorMisalignedAddress;
    err = launch_wgmma(a, maps, groups, s);
  } else {
    switch (dtype) {
      case 0:
        err = launch_f32(a, groups, s);
        break;
      case 1:
        a.vec_qkv = aligned16(qkv) && (qkv_bs | qkv_rs) % 8 == 0;
        a.vec_g = aligned16(g);
        err = dispatch_bf16(a, groups, s);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (err != 0) return err;
  const int count = nb_heads * n * n;
  dbias_sum_kernel<<<(count + kSumThreads - 1) / kSumThreads, kSumThreads, 0,
                     s>>>(static_cast<const float*>(partial),
                          static_cast<float*>(dbias), groups, count);
  return (int)cudaGetLastError();
}
