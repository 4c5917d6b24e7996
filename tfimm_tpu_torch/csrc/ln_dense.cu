// Fused LayerNorm + Dense, forward and backward.
//
// Replaces: tfimm_tpu/ops/pallas/ln_dense.py · ln_dense (the forward),
// _bwd_dx_call (dx, dgamma, dbeta) and _bwd_dw_call (dW, db), the Pallas
// TPU kernels. Same functions, on x (M, C) and g (M, O) in the dtype, the
// weight w (O, C) in the port's Dense layout, and gamma, beta (C,) and the
// bias (O,) as f32 vectors:
//
//   mean, rstd = per-row f32 statistics, the one-pass variance
//                rstd = rsqrt(max(E[x^2] - mean^2, 0) + eps)
//   z  = ((x - mean) * rstd) * gamma + beta in f32, rounded to the dtype
//   y  = z @ w^T (+ bias), summed in f32, rounded once
//   dz = g @ w, summed in f32 and never rounded; xhat = (x - mean) * rstd;
//   dxn = dz * gamma;
//   dx = rstd * (dxn - mean_c(dxn) - xhat * mean_c(dxn * xhat)), rounded
//   dgamma = sum_rows dz * xhat, dbeta = sum_rows dz (f32)
//   dW = g^T @ z with z recomputed from x as in the forward, db = sum_rows g
//        (f32; dW rounded to the dtype once)
//
// What bounds it on an H100: at ViT-B/16's LN1 -> qkv in training (M = 64
// x 197 = 12,608 rows, C = 768, O = 2,304) the forward is 2 M C O = 44.6
// GFLOP, 45 us at the 989 TFLOP/s bf16 dense peak, against 81 MB of x, w
// and y (24 us at 3.35 TB/s); the backward's two products are twice that.
// So every launch here is bound by the tensor cores.
//
// Design. The TPU kernels walk a sequential row grid and carry dgamma,
// dbeta, dW and db in VMEM-resident outputs from one row block to the next.
// Hopper blocks run in parallel and in no order, so each cross-row sum is
// written as per-block f32 partials and added up by a second small launch
// in a fixed order: runs repeat bit for bit, with no float atomics.
//
// - forward (2 launches): row statistics, then the mlp_gemm.cuh GEMM (as
//   convnext_mlp's fc1) with the LayerNorm prologue on the A operand and
//   the bias epilogue. z never reaches device memory. In bf16 where
//   tma.py · gemm_route takes x, w and the output (C and O multiples of 8,
//   16-byte aligned, C up to 4096: ViT-B/16's widths) the GEMM runs
//   mlp_gemm.cuh's TMA-fed wgmma body, else (C = 100, O = 36) its mma.sync
//   body (see its note).
// - backward (7 launches, counted as one): row_stats once, shared by the
//   dx and dW passes (the JAX kernels recompute the same formula in each);
//   - dx: a block owns BM rows and every column. It loops over 128-column
//     chunks of dz = g @ w (the k loop runs over O) and keeps the f32 dz of
//     its rows in shared memory (BM x C x 4 bytes: 192 KB at BM = 64,
//     C = 768, above the 48 KB static limit, so dynamic and raised), then
//     the LayerNorm backward runs on whole rows: one warp per row for dx,
//     one thread per column for the block's dgamma and dbeta partials.
//     BM is 64, 32 or 16, the largest whose tile fits (C <= 3,318).
//   - the dgamma and dbeta partials summed over the blocks, in order;
//   - dW: a block owns a 128 x 128 tile of dW (O rows, C columns) and one
//     of `splits` slices of the rows, so no block walks all M rows alone; z
//     is formed in shared memory from the staged x tile with the forward's
//     formula and rounding. The blocks of the first column tile also sum g
//     over their rows for db. Partials (splits, O, C) in f32;
//   - the dW and db partials summed over the slices, in order.
//
// The backward's products: bf16 through mma.sync m16n8k16 (f32
// accumulate) with ldmatrix fragments (.trans for the operands stored
// k-major: w in dz = g @ w, and both of dW's); f32 through plain FMAs
// (TF32 would miss the 1e-5 bar). Tiles are staged in shared memory by
// cp.async, two buffers deep, 64 bytes of depth per stage; rows padded by
// 16 bytes, which keeps the ldmatrix row addresses on distinct banks. The
// backward uses neither wgmma nor TMA yet.
//
// Coverage: any M, O >= 1, 1 <= C <= 3,318 (the dx tile). Rows, columns and
// depth beyond the edges are zero-filled in shared memory (the LN transform
// writes 0, not beta, there) and never stored. 16-byte copies when C and O
// are multiples of 8 (bf16) or 4 (f32) and the operands 16-byte aligned,
// element copies otherwise. Every launch is followed by cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_gemm.cuh"

namespace {

using namespace cnx;
using bf16 = __nv_bfloat16;

constexpr int kTile = 128;                 // dz column chunk; dW tile edge
constexpr size_t kMaxSmem = 232448;        // a block's dynamic shared memory

template <typename T>
__host__ __device__ constexpr int depth() { return 64 / (int)sizeof(T); }  // k per stage
template <typename T>
__host__ __device__ constexpr int pad() { return 16 / (int)sizeof(T); }    // row padding

// ---------------------------------------------------------------------------
// Staging

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage the (ROWS, COLS) window at (r0, c0) of a row-major matrix with
// `cols` columns into shared memory (row stride ld); zeros at rows >= rows
// and columns >= cols. Thread t handles chunks t, t + kThreads, ... (the
// LN transform below relies on that mapping).
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void stage_tile(T* dst, int ld,
                                           const T* __restrict__ src,
                                           int rows, int cols, int r0, int c0,
                                           int vec) {
  constexpr int V = vec_len<T>();
  constexpr int kCpr = COLS / V;
  for (int ch = threadIdx.x; ch < ROWS * kCpr; ch += kThreads) {
    const int r = ch / kCpr, cc = (ch % kCpr) * V;
    const int gr = r0 + r, gc = c0 + cc;
    T* d = dst + r * ld + cc;
    if (vec && gr < rows && gc < cols) {
      cp_async16(d, src + (int64_t)gr * cols + gc);
    } else {
      *reinterpret_cast<uint4*>(d) =
          load_chunk<T>(src, gr, rows, gc, cols, 0).u;
    }
  }
}

// Replace the staged x window at (r0, c0) (written by stage_tile with the
// same thread mapping) by z = LN(x), rounded to T; 0 outside the matrix.
// gam_s, bet_s: the window's columns of gamma and beta.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void layer_norm_tile(T* buf, int ld, int rows,
                                                int cols, int r0, int c0,
                                                const float* __restrict__ mean,
                                                const float* __restrict__ rstd,
                                                const float* gam_s,
                                                const float* bet_s) {
  constexpr int V = vec_len<T>();
  constexpr int kCpr = COLS / V;
  for (int ch = threadIdx.x; ch < ROWS * kCpr; ch += kThreads) {
    const int r = ch / kCpr, cc = (ch % kCpr) * V;
    const int row = r0 + r;
    Chunk<T> c;
    c.u = *reinterpret_cast<const uint4*>(buf + r * ld + cc);
    const float mu = row < rows ? mean[row] : 0.f;
    const float rs = row < rows ? rstd[row] : 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float z = 0.f;
      if (row < rows && c0 + cc + j < cols)
        z = ((c.get(j) - mu) * rs) * gam_s[cc + j] + bet_s[cc + j];
      c.set(j, z);
    }
    *reinterpret_cast<uint4*>(buf + r * ld + cc) = c.u;
  }
}

// ---------------------------------------------------------------------------
// One staged k tile of a (BM, BN) block product: acc += A @ B. A is stored
// [BM][K] (KAT false) or [K][BM] (KAT true), B [K][BN], with row strides
// lda and ldb. acc holds BM * BN / kThreads values a thread; acc_coord maps
// its index to the tile's (row, col).

template <int BM, int BN>
struct MmaLayout {
  static constexpr int kWM = BM >= 32 ? 2 : 1;   // warps along rows
  static constexpr int kWN = 8 / kWM;
  static constexpr int kMT = BM / (16 * kWM);    // m16 tiles a warp
  static constexpr int kNT = BN / (8 * kWN);     // n8 tiles a warp
  static_assert(kMT >= 1 && kNT >= 2 && kNT % 2 == 0, "tile too small");
};

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BM, int BN, bool KAT>
__device__ __forceinline__ void stage_product(float* acc, const bf16* as,
                                              int lda, const bf16* bs,
                                              int ldb) {
  using L = MmaLayout<BM, BN>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / L::kWN) * (BM / L::kWM);
  const int wn = (warp % L::kWN) * (BN / L::kWN);
  const int q = lane / 8, l8 = lane % 8;
#pragma unroll
  for (int ks = 0; ks < depth<bf16>(); ks += 16) {
    uint32_t af[L::kMT][4], bfr[L::kNT][2];
#pragma unroll
    for (int mt = 0; mt < L::kMT; ++mt) {
      if (KAT)
        ldmatrix_x4_trans(af[mt], as + (ks + (q >> 1) * 8 + l8) * lda + wm +
                                      mt * 16 + (q & 1) * 8);
      else
        ldmatrix_x4(af[mt], as + (wm + mt * 16 + lane % 16) * lda + ks +
                                (lane / 16) * 8);
    }
#pragma unroll
    for (int np = 0; np < L::kNT / 2; ++np) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, bs + (ks + (q & 1) * 8 + l8) * ldb + wn + np * 16 +
                               (q >> 1) * 8);
      bfr[2 * np][0] = r[0];
      bfr[2 * np][1] = r[1];
      bfr[2 * np + 1][0] = r[2];
      bfr[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < L::kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < L::kNT; ++nt)
        mma_bf16(acc + (mt * L::kNT + nt) * 4, af[mt], bfr[nt][0], bfr[nt][1]);
  }
}

template <int BM, int BN, bool KAT>
__device__ __forceinline__ void stage_product(float* acc, const float* as,
                                              int lda, const float* bs,
                                              int ldb) {
  constexpr int TM = BM / 16, TN = BN / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int k = 0; k < depth<float>(); ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      av[i] = KAT ? as[k * lda + ty + 16 * i] : as[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = bs[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i * TN + j] = fmaf(av[i], bv[j], acc[i * TN + j]);
  }
}

template <typename T, int BM, int BN>
__device__ __forceinline__ void acc_coord(int idx, int* row, int* col) {
  if constexpr (sizeof(T) == 2) {
    using L = MmaLayout<BM, BN>;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int mt = idx / (4 * L::kNT), nt = (idx / 4) % L::kNT, e = idx % 4;
    *row = (warp / L::kWN) * (BM / L::kWM) + mt * 16 + lane / 4 + 8 * (e >> 1);
    *col = (warp % L::kWN) * (BN / L::kWN) + nt * 8 + 2 * (lane % 4) + (e & 1);
  } else {
    constexpr int TN = BN / 16;
    *row = threadIdx.x / 16 + 16 * (idx / TN);
    *col = threadIdx.x % 16 + 16 * (idx % TN);
  }
}

// ---------------------------------------------------------------------------
// Kernels

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_stats_kernel(const T* __restrict__ x, float* __restrict__ mean,
                float* __restrict__ rstd, int m, int c, float eps, int vec) {
  row_stats<T>(x, mean, rstd, m, c, eps, vec);
}

CNX_WGMMA_KERNEL(ln_dense_fwd_wgmma_kernel, true, kBias)

template <typename T>
__global__ void __launch_bounds__(kThreads) ln_dense_fwd_kernel(GemmArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (sizeof(T) == 2)
    gemm_bf16_tile<true, kBias>(p, smem_raw);
  else
    gemm_f32_tile<true, kBias>(p, smem_raw);
}

struct DxArgs {
  const void* x;        // (M, C)
  const void* g;        // (M, O)
  const void* w;        // (O, C)
  const float* gamma;   // (C,)
  const float* mean;    // (M,)
  const float* rstd;    // (M,)
  void* dx;             // (M, C)
  float* part_g;        // (gridDim.x, C): the block's sum of dz * xhat
  float* part_b;        // (gridDim.x, C): the block's sum of dz
  int m, c, o;
  int vec;
};

template <typename T, int BM>
constexpr size_t dx_smem(int c) {
  return 2 * (size_t)(BM * (depth<T>() + pad<T>()) +
                      depth<T>() * (kTile + pad<T>())) * sizeof(T) +
         2 * BM * sizeof(float) + (size_t)BM * c * sizeof(float);
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads) ln_dense_dx_kernel(DxArgs p) {
  constexpr int BK = depth<T>(), LDA = BK + pad<T>(), LDB = kTile + pad<T>();
  constexpr int kStage = BM * LDA + BK * LDB;
  constexpr int kAcc = BM * kTile / kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);
  float* mean_s = reinterpret_cast<float*>(tiles + 2 * kStage);
  float* rstd_s = mean_s + BM;
  float* dz = rstd_s + BM;   // [BM][C]
  const T* x = static_cast<const T*>(p.x);
  const T* g = static_cast<const T*>(p.g);
  const T* w = static_cast<const T*>(p.w);
  const int m0 = blockIdx.x * BM, tid = threadIdx.x;

  for (int r = tid; r < BM; r += kThreads) {
    const int row = m0 + r;
    mean_s[r] = row < p.m ? p.mean[row] : 0.f;
    rstd_s[r] = row < p.m ? p.rstd[row] : 0.f;
  }

  // dz = g @ w, one 128-column chunk at a time; the k loop runs over O.
  const int k_tiles = (p.o + BK - 1) / BK;
  for (int n0 = 0; n0 < p.c; n0 += kTile) {
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    stage_tile<T, BM, BK>(tiles, LDA, g, p.m, p.o, m0, 0, p.vec);
    stage_tile<T, BK, kTile>(tiles + BM * LDA, LDB, w, p.o, p.c, 0, n0, p.vec);
    cp_async_commit();
    for (int kt = 0; kt < k_tiles; ++kt) {
      const T* cur = tiles + (kt & 1) * kStage;
      if (kt + 1 < k_tiles) {
        T* nxt = tiles + ((kt + 1) & 1) * kStage;
        const int k0 = (kt + 1) * BK;
        stage_tile<T, BM, BK>(nxt, LDA, g, p.m, p.o, m0, k0, p.vec);
        stage_tile<T, BK, kTile>(nxt + BM * LDA, LDB, w, p.o, p.c, k0, n0,
                                 p.vec);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      stage_product<BM, kTile, false>(acc, cur, LDA, cur + BM * LDA, LDB);
      __syncthreads();   // the buffer is staged again two tiles on
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      int r, cc;
      acc_coord<T, BM, kTile>(i, &r, &cc);
      if (n0 + cc < p.c) dz[r * p.c + n0 + cc] = acc[i];
    }
  }
  __syncthreads();

  // The block's dgamma and dbeta partials: one thread per column.
  const int rows = min(BM, p.m - m0);
  for (int col = tid; col < p.c; col += kThreads) {
    float sg = 0.f, sb = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float d = dz[r * p.c + col];
      const float xh =
          (to_f(x[(int64_t)(m0 + r) * p.c + col]) - mean_s[r]) * rstd_s[r];
      sg += d * xh;
      sb += d;
    }
    p.part_g[(int64_t)blockIdx.x * p.c + col] = sg;
    p.part_b[(int64_t)blockIdx.x * p.c + col] = sb;
  }

  // dx: one warp per row.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < rows; r += kThreads / 32) {
    const float mu = mean_s[r], rs = rstd_s[r];
    const T* xr = x + (int64_t)(m0 + r) * p.c;
    const float* dzr = dz + r * p.c;
    float s1 = 0.f, s2 = 0.f;
    for (int col = lane; col < p.c; col += 32) {
      const float xh = (to_f(xr[col]) - mu) * rs;
      const float dxn = dzr[col] * __ldg(p.gamma + col);
      s1 += dxn;
      s2 += dxn * xh;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float m1 = s1 / (float)p.c, m2 = s2 / (float)p.c;
    T* dxr = static_cast<T*>(p.dx) + (int64_t)(m0 + r) * p.c;
    for (int col = lane; col < p.c; col += 32) {
      const float xh = (to_f(xr[col]) - mu) * rs;
      const float dxn = dzr[col] * __ldg(p.gamma + col);
      dxr[col] = from_f<T>(rs * (dxn - m1 - xh * m2));
    }
  }
}

struct DwArgs {
  const void* x;        // (M, C)
  const void* g;        // (M, O)
  const float* gamma;   // (C,)
  const float* beta;    // (C,)
  const float* mean;    // (M,)
  const float* rstd;    // (M,)
  float* part_dw;       // (splits, O, C)
  float* part_db;       // (splits, O)
  int m, c, o;
  int rows_per_split;   // a multiple of depth<T>()
  int vec;
};

template <typename T>
constexpr size_t dw_smem() {
  return 4 * (size_t)depth<T>() * (kTile + pad<T>()) * sizeof(T) +
         2 * kTile * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ln_dense_dw_kernel(DwArgs p) {
  constexpr int BK = depth<T>(), LD = kTile + pad<T>();
  constexpr int kStage = 2 * BK * LD;   // the g tile, then the x / z tile
  constexpr int kAcc = kTile * kTile / kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);
  float* gam_s = reinterpret_cast<float*>(tiles + 2 * kStage);
  float* bet_s = gam_s + kTile;
  const T* x = static_cast<const T*>(p.x);
  const T* g = static_cast<const T*>(p.g);
  const int c_tiles = (p.c + kTile - 1) / kTile;
  const int o0 = (blockIdx.x / c_tiles) * kTile;
  const int c0 = (blockIdx.x % c_tiles) * kTile;
  const bool with_db = blockIdx.x % c_tiles == 0;
  const int r_begin = blockIdx.y * p.rows_per_split;
  const int r_end = min(p.m, r_begin + p.rows_per_split);
  const int tid = threadIdx.x;

  for (int i = tid; i < kTile; i += kThreads) {
    gam_s[i] = c0 + i < p.c ? p.gamma[c0 + i] : 0.f;
    bet_s[i] = c0 + i < p.c ? p.beta[c0 + i] : 0.f;
  }
  __syncthreads();

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float db = 0.f;
  const int k_tiles = r_end > r_begin ? (r_end - r_begin + BK - 1) / BK : 0;
  if (k_tiles > 0) {
    stage_tile<T, BK, kTile>(tiles, LD, g, r_end, p.o, r_begin, o0, p.vec);
    stage_tile<T, BK, kTile>(tiles + BK * LD, LD, x, r_end, p.c, r_begin, c0,
                             p.vec);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    T* cur = tiles + (kt & 1) * kStage;
    if (kt + 1 < k_tiles) {
      T* nxt = tiles + ((kt + 1) & 1) * kStage;
      const int r0 = r_begin + (kt + 1) * BK;
      stage_tile<T, BK, kTile>(nxt, LD, g, r_end, p.o, r0, o0, p.vec);
      stage_tile<T, BK, kTile>(nxt + BK * LD, LD, x, r_end, p.c, r0, c0,
                               p.vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    layer_norm_tile<T, BK, kTile>(cur + BK * LD, LD, r_end, p.c,
                                  r_begin + kt * BK, c0, p.mean, p.rstd, gam_s,
                                  bet_s);
    __syncthreads();
    if (with_db && tid < kTile)
      for (int k = 0; k < BK; ++k) db += to_f(cur[k * LD + tid]);
    stage_product<kTile, kTile, true>(acc, cur, LD, cur + BK * LD, LD);
    __syncthreads();   // the buffer is staged again two tiles on
  }

  float* part = p.part_dw + (int64_t)blockIdx.y * p.o * p.c;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    int r, cc;
    acc_coord<T, kTile, kTile>(i, &r, &cc);
    if (o0 + r < p.o && c0 + cc < p.c)
      part[(int64_t)(o0 + r) * p.c + c0 + cc] = acc[i];
  }
  if (with_db && tid < kTile && o0 + tid < p.o)
    p.part_db[(int64_t)blockIdx.y * p.o + o0 + tid] = db;
}

// out[i] = sum over b of part[b * n + i], in the order b = 0, 1, ...
template <typename TOut>
__global__ void __launch_bounds__(kThreads)
sum_parts_kernel(const float* __restrict__ part, int parts, int64_t n,
                 TOut* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < parts; ++b) s += part[b * n + i];
  out[i] = from_f<TOut>(s);
}

// ---------------------------------------------------------------------------
// Launches

int launch_checked(const void* fn, dim3 grid, size_t smem, void** params,
                   cudaStream_t stream) {
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel(fn, grid, dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_stats(const T* x, float* mean, float* rstd, int m, int c,
                 float eps, cudaStream_t stream) {
  const int vec = c % vec_len<T>() == 0 && aligned16(x);
  ln_stats_kernel<T><<<stats_blocks<T>(m, c, vec), kThreads, 0, stream>>>(
      x, mean, rstd, m, c, eps, vec);
  return (int)cudaGetLastError();
}

template <typename TOut>
int launch_sum(const float* part, int parts, int64_t n, TOut* out,
               cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  sum_parts_kernel<TOut><<<(unsigned)blocks, kThreads, 0, stream>>>(
      part, parts, n, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const T* x, const float* gamma, const float* beta, const T* w,
               const float* bias, float* mean, float* rstd, T* out, int m,
               int c, int o, float eps, const int64_t* maps,
               cudaStream_t stream) {
  int err = launch_stats<T>(x, mean, rstd, m, c, eps, stream);
  if (err != 0) return err;
  GemmArgs args = {x, w, out, nullptr, mean, rstd, gamma, beta, bias, nullptr,
                   m, o, c,
                   c % vec_len<T>() == 0 && aligned16(x) && aligned16(w)};
  if constexpr (sizeof(T) == 2) {
    if (maps != nullptr)
      return launch_ln_dense_fwd_wgmma_kernel(args, maps, stream);
  }
  return launch_gemm<T>(ln_dense_fwd_kernel<T>, args, stream);
}

template <typename T, int BM>
int launch_dx(DxArgs args, cudaStream_t stream) {
  void* params[] = {&args};
  const unsigned blocks = (unsigned)((args.m + BM - 1) / BM);
  return launch_checked(reinterpret_cast<const void*>(ln_dense_dx_kernel<T, BM>),
                        dim3(blocks), dx_smem<T, BM>(args.c), params, stream);
}

template <typename T>
int launch_bwd(const T* x, const float* gamma, const float* beta, const T* w,
               const T* g, float* mean, float* rstd, T* dx, float* part_gb,
               float* dgb, float* part_dw, float* part_db, T* dw, float* db,
               int m, int c, int o, int dx_rows, int splits, float eps,
               cudaStream_t stream) {
  constexpr int V = vec_len<T>();
  const int vec = c % V == 0 && o % V == 0 && aligned16(x) && aligned16(w) &&
                  aligned16(g);
  int err = launch_stats<T>(x, mean, rstd, m, c, eps, stream);
  if (err != 0) return err;

  const int dx_blocks = (m + dx_rows - 1) / dx_rows;
  float* part_g = part_gb;
  float* part_b = part_gb + (int64_t)dx_blocks * c;
  DxArgs dxa = {x, g, w, gamma, mean, rstd, dx, part_g, part_b, m, c, o, vec};
  switch (dx_rows) {
    case 64: err = launch_dx<T, 64>(dxa, stream); break;
    case 32: err = launch_dx<T, 32>(dxa, stream); break;
    case 16: err = launch_dx<T, 16>(dxa, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  if ((err = launch_sum<float>(part_g, dx_blocks, c, dgb, stream)) != 0)
    return err;
  if ((err = launch_sum<float>(part_b, dx_blocks, c, dgb + c, stream)) != 0)
    return err;

  constexpr int BK = depth<T>();
  const int per_split = (m + splits - 1) / splits;
  DwArgs dwa = {x, g, gamma, beta, mean, rstd, part_dw, part_db, m, c, o,
                (per_split + BK - 1) / BK * BK, vec};
  void* params[] = {&dwa};
  const int tiles = ((o + kTile - 1) / kTile) * ((c + kTile - 1) / kTile);
  err = launch_checked(reinterpret_cast<const void*>(ln_dense_dw_kernel<T>),
                       dim3(tiles, splits), dw_smem<T>(), params, stream);
  if (err != 0) return err;
  if ((err = launch_sum<T>(part_dw, splits, (int64_t)o * c, dw, stream)) != 0)
    return err;
  return launch_sum<float>(part_db, splits, o, db, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. gamma, beta and bias are f32 (bias may
// be NULL); mean, rstd (M,) f32 are scratch the caller allocates. maps:
// NULL for the mma.sync body, or (bf16) the product's maps of tma.py ·
// packed_gemm_maps (x, w, out and out again, then its grid), which select
// the TMA + wgmma body.
// Returns a cudaError_t value (0 = ok).
extern "C" int tfimm_ln_dense_fwd(const void* x, const void* gamma,
                                  const void* beta, const void* w,
                                  const void* bias, void* mean, void* rstd,
                                  void* out, int m, int c, int o, float eps,
                                  int dtype, const int64_t* maps,
                                  void* stream) {
  if (m <= 0 || c <= 0 || o <= 0) return (int)cudaErrorInvalidValue;
  if (maps != nullptr && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  const float* bs = static_cast<const float*>(bias);
  float* mu = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  switch (dtype) {
    case 0:
      return launch_fwd<float>(static_cast<const float*>(x), gm, bt,
                               static_cast<const float*>(w), bs, mu, rs,
                               static_cast<float*>(out), m, c, o, eps,
                               nullptr, s);
    case 1:
      return launch_fwd<bf16>(static_cast<const bf16*>(x), gm, bt,
                              static_cast<const bf16*>(w), bs, mu, rs,
                              static_cast<bf16*>(out), m, c, o, eps, maps,
                              s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The backward from g (M, O) in the dtype: dx (M, C) and dw (O, C) in the
// dtype, dgb (2, C) = (dgamma, dbeta) and db (O,) in f32. Scratch the
// caller allocates: mean, rstd (M,); part_gb (2, ceil(M / dx_rows), C);
// part_dw (splits, O, C); part_db (splits, O), all f32. dx_rows is 64, 32
// or 16, the dx block's rows (its f32 dz tile must fit shared memory).
extern "C" int tfimm_ln_dense_bwd(const void* x, const void* gamma,
                                  const void* beta, const void* w,
                                  const void* g, void* mean, void* rstd,
                                  void* dx, void* part_gb, void* dgb,
                                  void* part_dw, void* part_db, void* dw,
                                  void* db, int m, int c, int o, int dx_rows,
                                  int splits, float eps, int dtype,
                                  void* stream) {
  if (m <= 0 || c <= 0 || o <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  float* f[] = {static_cast<float*>(mean), static_cast<float*>(rstd),
                static_cast<float*>(part_gb), static_cast<float*>(dgb),
                static_cast<float*>(part_dw), static_cast<float*>(part_db),
                static_cast<float*>(db)};
  switch (dtype) {
    case 0:
      return launch_bwd<float>(
          static_cast<const float*>(x), gm, bt, static_cast<const float*>(w),
          static_cast<const float*>(g), f[0], f[1], static_cast<float*>(dx),
          f[2], f[3], f[4], f[5], static_cast<float*>(dw), f[6], m, c, o,
          dx_rows, splits, eps, s);
    case 1:
      return launch_bwd<bf16>(
          static_cast<const bf16*>(x), gm, bt, static_cast<const bf16*>(w),
          static_cast<const bf16*>(g), f[0], f[1], static_cast<bf16*>(dx),
          f[2], f[3], f[4], f[5], static_cast<bf16*>(dw), f[6], m, c, o,
          dx_rows, splits, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
