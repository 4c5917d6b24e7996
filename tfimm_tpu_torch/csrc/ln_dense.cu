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
// - backward in bf16 on Hopper (tma.py · ln_dense_bwd_route: C and O
//   multiples of 8, C up to 1,024, contiguous 16-byte aligned operands;
//   ViT-B/16's and ViT-L's widths): 4 to 7 launches (the statistics' below
//   C = 256, the slice sums' above one slice of M), counted as one.
//   - below C = 256, row_stats, as the forward's (from C = 256, where
//     row_stats gives a row 32 lanes, the dx pass takes the statistics
//     itself in its order, bit for bit the forward's);
//   - dz = g w on TMA-fed wgmma (bwd_gemm, below: a persistent producer /
//     two-consumer body on an mbarrier ring, as mlp_gemm.cuh's, with w as
//     an MN-major B of BN / 64 64-column boxes), 128 x BN tiles (BN 128,
//     192 or 256, tma.py · ln_dense_bwd_plan; 192 at ViT-B/16's C = 768:
//     396 tiles, three whole rounds of 132 SMs, where 197 blocks of 64
//     whole rows would leave a 65-block tail), written to device memory
//     in f32. The LayerNorm backward needs whole rows of dz: a block that
//     owned 64 rows and every column would re-read all of w from L2 for
//     each 64 rows (700 MB at bs64) and leave no room for a ring beside its
//     96 KB stages; the f32 round trip costs 77 MB of traffic (23 us at
//     3.35 TB/s) at bs64 instead;
//   - dx, z and the dgamma and dbeta partials, a 64-row block each, from
//     dz, x and the statistics (ln_dense_dx_rows_kernel: a warp a row, 16
//     bytes a lane access, gamma and beta in shared memory, the partials
//     in registers); z = LN(x) in the forward's formula and rounding goes
//     to a bf16 scratch;
//   - the two partials summed over the blocks, in order;
//   - dW = g^T z on the same body, A = g^T M-major from 64-column boxes of
//     g, B = z MN-major, each tile over one of `splits` slices of M (a
//     multiple of 64 rows) into f32 partials (splits, O, C); the consumers
//     also sum g's columns as each stage retires, written for the first
//     column tile as the slice's db partials (splits, O);
//   - the dW and db partials summed over the slices, in order (dW rounded
//     once); in one slice (ViT-B/16's LN1 -> qkv at bs1) the GEMM writes dW,
//     rounded once, and db itself, and these two launches drop out.
//   Every cross-block sum runs in a fixed order: two calls agree bit for
//   bit.
// - backward elsewhere (7 launches, counted as one: f32, C or O not a
//   multiple of 8, C above 1,024, misaligned operands): the first design.
//   row_stats once, shared by the dx and dW passes (the JAX kernels
//   recompute the same formula in each);
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
//   Its products: bf16 through mma.sync m16n8k16 (f32 accumulate) with
//   ldmatrix fragments (.trans for the operands stored k-major: w in dz =
//   g @ w, and both of dW's); f32 through plain FMAs (TF32 would miss the
//   1e-5 bar). Tiles are staged in shared memory by cp.async, two buffers
//   deep, 64 bytes of depth per stage; rows padded by 16 bytes, which keeps
//   the ldmatrix row addresses on distinct banks.
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
// bf16 backward on Hopper (see the note at the top)

constexpr int kBwRows = 128;               // output tile rows: 64 a consumer
constexpr int kBwDepth = 64;               // k step: one 128-byte swizzle row
constexpr int kBwBox = 64 * 128;           // a 64 x 64 bf16 box
constexpr int kDxRows = 64;                // rows of a dx block (the partials')
constexpr int kDxMaxChunks = 4;            // C up to 1024: 256 columns a chunk

// The ring of the backward's GEMMs at BN-column tiles: stages of A (128
// rows x 64 deep) and B (64 deep x BN), as many as fit up to 6, then the
// barriers and the two consumers' db halves.
template <int BN>
struct BwdTiles {
  static constexpr int kABytes = kBwRows * kBwDepth * 2;
  static constexpr int kStageBytes = kABytes + BN * kBwDepth * 2;
  static constexpr int kFixed = 1024 + 8 * 12 + 2 * 64 * 4;
  static constexpr int kStages = (kMaxSmem - kFixed) / kStageBytes < 6
                                     ? (kMaxSmem - kFixed) / kStageBytes : 6;
  static constexpr int kBars = kStages * kStageBytes;
  static constexpr int kDb = kBars + 8 * 2 * kStages;
  static constexpr int kBytes = kDb + 2 * 64 * 4 + 1024;
  static_assert(kStages >= 3, "a ring of at least three stages");
};

struct BwdGemmArgs {
  float* out;          // dz (M, C), or the dW partials (splits, O, C)
  bf16* dw;            // the dW GEMM in one slice: dW itself (out unused)
  float* part_db;      // the dW GEMM: the db partials (splits, O)
  int rows, cols;      // the output's (M or O, C)
  int depth;           // O or M
  int splits;          // slices of the depth: 1 for dz
  int per_split;       // depth a slice, a multiple of kBwDepth
};

// The two products as one body. dz = g w (kDw false): A = g (M, O) K-major
// from a (128-row, 64-deep) box, B = w (O, C) MN-major. dW = g^T z (kDw
// true), one slice of M a tile: A = g^T M-major from two (64-column,
// 64-deep) boxes of g, B = z (M, C) MN-major. B is BN / 64 boxes of 64
// columns. A persistent grid walks the tiles (slice, row tile, column tile;
// the columns innermost); a producer thread streams the k steps through the
// ring, two consumer warpgroups own 64 rows each and keep one group of
// m64nBNk16 in flight. The f32 output goes out by plain stores (8-byte
// pairs, rows past `rows` and columns past `cols` dropped). kDw: every
// consumer thread also sums one column of its g^T box over 32 of the 64
// rows of each k step, as the stage retires; the two halves are added in
// order and, in the first column tile, written as the slice's db partial.
template <bool kDw, int BN>
__device__ __forceinline__ void bwd_gemm(const CUtensorMap* a_map,
                                         const CUtensorMap* b_map,
                                         const BwdGemmArgs& p,
                                         uint8_t* smem_raw) {
  using L = BwdTiles<BN>;
  constexpr int S = L::kStages;
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + S;
  float* db_s = reinterpret_cast<float*>(smem + L::kDb);

  const int n_tiles = (p.cols + BN - 1) / BN;
  const int split_tiles = (p.rows + kBwRows - 1) / kBwRows * n_tiles;
  const int tiles = split_tiles * p.splits;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);   // one arrival a consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {
    hopper::setmaxnreg_dec<kWgProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int split = tile / split_tiles, rest = tile % split_tiles;
        const int m0 = rest / n_tiles * kBwRows, n0 = rest % n_tiles * BN;
        const int k0 = split * p.per_split;
        const int steps =
            (min(p.depth - k0, p.per_split) + kBwDepth - 1) / kBwDepth;
        for (int kt = 0; kt < steps; ++kt, ++it) {
          const int s = it % S;
          if (it >= S) hopper::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          uint8_t* stage = smem + s * L::kStageBytes;
          const int k = k0 + kBwDepth * kt;
          hopper::mbar_expect_tx(&full[s], L::kStageBytes);
          if (kDw) {
            hopper::tma_load_2d(stage, a_map, &full[s], m0, k);
            hopper::tma_load_2d(stage + kBwBox, a_map, &full[s], m0 + 64, k);
          } else {
            hopper::tma_load_2d(stage, a_map, &full[s], k, m0);
          }
          for (int b = 0; b < BN / 64; ++b)
            hopper::tma_load_2d(stage + L::kABytes + b * kBwBox, b_map,
                                &full[s], n0 + 64 * b, k);
        }
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<kWgConsumerRegs>();
  const int wg = warp / 4 - 1, wl = warp % 4, tid = threadIdx.x % 128;
  const int g = lane / 4, t = lane % 4;
  const int row = 16 * wl + g;
  // kDw: this thread's db column of the warpgroup's g^T box, and its half
  // of the box's 64 rows.
  const int db_col = tid % 64, db_half = tid / 64;
  float acc[BN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int split = tile / split_tiles, rest = tile % split_tiles;
    const int m0 = rest / n_tiles * kBwRows, n0 = rest % n_tiles * BN;
    const int k0 = split * p.per_split;
    const int steps = (min(p.depth - k0, p.per_split) + kBwDepth - 1) / kBwDepth;
    float db = 0.f;
    auto retire = [&](int s) {
      if (kDw) {
        const uint8_t* box = smem + s * L::kStageBytes + wg * kBwBox;
        for (int r = 32 * db_half; r < 32 * db_half + 32; ++r)
          db += __bfloat162float(*reinterpret_cast<const bf16*>(
              box + r * 128 + (((db_col >> 3) ^ (r & 7)) << 4) +
              (db_col & 7) * 2));
        __syncwarp();
      }
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    };
    for (int kt = 0; kt < steps; ++kt, ++it) {
      const int s = it % S;
      hopper::mbar_wait(&full[s], (it / S) & 1);
      uint8_t* stage = smem + s * L::kStageBytes;
      const uint64_t ad = hopper::sw128_desc(stage + wg * kBwBox);
      const uint64_t bd = hopper::sw128_desc_mn(stage + L::kABytes, kBwBox);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_ss<1, kDw ? 1 : 0>(acc, ad + (kDw ? 128 : 2) * kk,
                                         bd + 128 * kk, kt > 0 || kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      if (kt > 0) retire((it - 1) % S);
    }
    hopper::wgmma_wait<0>();
    retire((it - 1) % S);
    hopper::fence_regs(acc);

    const int r0 = m0 + 64 * wg;   // the warpgroup's first output row
    if (kDw && n0 == 0) {
      // db: the two halves of each column, in order.
      hopper::named_barrier(1 + wg, 128);
      if (db_half == 1) db_s[wg * 64 + db_col] = db;
      hopper::named_barrier(1 + wg, 128);
      if (db_half == 0 && r0 + db_col < p.rows)
        p.part_db[(int64_t)split * p.rows + r0 + db_col] =
            db + db_s[wg * 64 + db_col];
    }
    float* out = p.out + (int64_t)split * p.rows * p.cols;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= p.cols) continue;   // cols % 8 == 0: pairs whole
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = r0 + row + 8 * rr;
        if (r >= p.rows) continue;
        const int64_t at = (int64_t)r * p.cols + col;
        const float v0 = acc[4 * j + 2 * rr], v1 = acc[4 * j + 2 * rr + 1];
        if (kDw && p.dw != nullptr)
          *reinterpret_cast<uint32_t*>(p.dw + at) = hopper::pack_bf16(v0, v1);
        else
          *reinterpret_cast<float2*>(out + at) = make_float2(v0, v1);
      }
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
ln_dense_dz_wgmma_kernel(const __grid_constant__ CUtensorMap a,
                         const __grid_constant__ CUtensorMap b,
                         BwdGemmArgs p) {
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  bwd_gemm<false, BN>(&a, &b, p, bwd_smem);
}

template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
ln_dense_dw_wgmma_kernel(const __grid_constant__ CUtensorMap a,
                         const __grid_constant__ CUtensorMap b,
                         BwdGemmArgs p) {
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  bwd_gemm<true, BN>(&a, &b, p, bwd_smem);
}

struct DxRowsArgs {
  const bf16* x;        // (M, C)
  const float* dz;      // (M, C)
  const float* gamma;   // (C,)
  const float* beta;    // (C,)
  const float* mean;    // (M,): read, or (own_stats) not used
  const float* rstd;    // (M,)
  bf16* dx;             // (M, C)
  bf16* z;              // (M, C): the forward's z, for the dW GEMM
  float* part_g;        // (blocks, C): the block's sum of dz * xhat
  float* part_b;        // (blocks, C): the block's sum of dz
  int m, c;
  int own_stats;        // the pass takes the row statistics itself
  float eps;
};

// dx, z and the block's dgamma and dbeta partials, from dz and x: a block
// of kThreads owns kDxRows rows, a warp 8 consecutive ones in turn, a lane
// the columns 256 i + 8 lane .. + 7 (i < NCH) of each (0 past C), with
// gamma and beta staged in shared memory. With own_stats (C >= 256, where
// row_stats gives a row 32 lanes) the row's mean and rstd are taken here
// from the same loads, in row_stats' order (a lane's columns in order,
// then xor shuffles), so they are the forward's bit for bit; else they come
// from a row_stats launch. A row's two sums of the LayerNorm backward run
// the same way. Each warp adds dz * xhat and dz of its rows, in order, in
// registers; the block's partial is the sum of the 8 warps' in order.
template <int NCH>
__global__ void __launch_bounds__(kThreads) ln_dense_dx_rows_kernel(DxRowsArgs p) {
  constexpr int kQuads = 64 * NCH;         // float4s of 256 NCH columns
  extern __shared__ float4 dx_smem[];      // gamma, beta, then [warp][2][kQuads]
  float4* gam = dx_smem;
  float4* bet = gam + kQuads;
  float4* red = bet + kQuads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < 4 * kQuads; i += kThreads) {
    reinterpret_cast<float*>(gam)[i] = i < p.c ? __ldg(p.gamma + i) : 0.f;
    reinterpret_cast<float*>(bet)[i] = i < p.c ? __ldg(p.beta + i) : 0.f;
  }
  __syncthreads();

  float dg[NCH][8], db[NCH][8];
#pragma unroll
  for (int i = 0; i < NCH; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) dg[i][e] = db[i][e] = 0.f;
  const int m0 = blockIdx.x * kDxRows;
  for (int rr = 0; rr < kDxRows / 8; ++rr) {
    const int row = m0 + 8 * warp + rr;
    if (row >= p.m) break;
    const float* dz_row = p.dz + (int64_t)row * p.c;
    const bf16* x_row = p.x + (int64_t)row * p.c;
    float xs[NCH][8], dv[NCH][8];
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int col = 256 * i + 8 * lane;
      Chunk<bf16> xc;
      xc.u = make_uint4(0u, 0u, 0u, 0u);
      float4 d0 = make_float4(0.f, 0.f, 0.f, 0.f), d1 = d0;
      if (col < p.c) {
        xc.u = *reinterpret_cast<const uint4*>(x_row + col);
        d0 = *reinterpret_cast<const float4*>(dz_row + col);
        d1 = *reinterpret_cast<const float4*>(dz_row + col + 4);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) xs[i][e] = xc.get(e);
      dv[i][0] = d0.x; dv[i][1] = d0.y; dv[i][2] = d0.z; dv[i][3] = d0.w;
      dv[i][4] = d1.x; dv[i][5] = d1.y; dv[i][6] = d1.z; dv[i][7] = d1.w;
    }
    float mu, rs;
    if (p.own_stats) {
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int i = 0; i < NCH; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s += xs[i][e];
          ss += xs[i][e] * xs[i][e];
        }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
      }
      mu = s / (float)p.c;
      rs = rsqrtf(fmaxf(ss / (float)p.c - mu * mu, 0.f) + p.eps);
    } else {
      mu = p.mean[row];
      rs = p.rstd[row];
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int col = 256 * i + 8 * lane;
      const float4 g0 = gam[col / 4], g1 = gam[col / 4 + 1];
      const float4 b0 = bet[col / 4], b1 = bet[col / 4 + 1];
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      Chunk<bf16> zc;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xh = (xs[i][e] - mu) * rs;
        dg[i][e] += dv[i][e] * xh;
        db[i][e] += dv[i][e];
        zc.set(e, fmaf(xh, gv[e], bv[e]));
        xs[i][e] = xh;                      // now xhat
        dv[i][e] *= gv[e];                  // now dxn
        s1 += dv[i][e];
        s2 += dv[i][e] * xh;
      }
      if (col < p.c)
        *reinterpret_cast<uint4*>(p.z + (int64_t)row * p.c + col) = zc.u;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float m1 = s1 / (float)p.c, m2 = s2 / (float)p.c;
    bf16* dx_row = p.dx + (int64_t)row * p.c;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int col = 256 * i + 8 * lane;
      Chunk<bf16> dc;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dc.set(e, rs * (dv[i][e] - m1 - xs[i][e] * m2));
      if (col < p.c) *reinterpret_cast<uint4*>(dx_row + col) = dc.u;
    }
  }
  float4* mine = red + warp * 2 * kQuads;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int q = 64 * i + 2 * lane;
    mine[q] = make_float4(dg[i][0], dg[i][1], dg[i][2], dg[i][3]);
    mine[q + 1] = make_float4(dg[i][4], dg[i][5], dg[i][6], dg[i][7]);
    mine[kQuads + q] = make_float4(db[i][0], db[i][1], db[i][2], db[i][3]);
    mine[kQuads + q + 1] = make_float4(db[i][4], db[i][5], db[i][6], db[i][7]);
  }
  __syncthreads();
  const float* redf = reinterpret_cast<const float*>(red);
  for (int col = threadIdx.x; col < p.c; col += kThreads) {
    float sg = 0.f, sb = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      sg += redf[w * 8 * kQuads + col];
      sb += redf[w * 8 * kQuads + 4 * kQuads + col];
    }
    p.part_g[(int64_t)blockIdx.x * p.c + col] = sg;
    p.part_b[(int64_t)blockIdx.x * p.c + col] = sb;
  }
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

// The packed maps of tma.py · packed_ln_dense_bwd_maps: the dz GEMM's
// a (g in 128-row boxes) and b (w), the dW GEMM's a (g in 64-row boxes)
// and b (z), then the plan: dz's blocks and tile width, dW's blocks, tile
// width, slices of M and rows a slice.
constexpr int kBwdPlan = 4 * hopper::kGeometrySize;

template <int BN>
int launch_bwd_gemm(const void* kernel, const CUtensorMap& a,
                    const CUtensorMap& b, const BwdGemmArgs& args,
                    int64_t blocks, cudaStream_t stream) {
  const int64_t tiles = (int64_t)((args.rows + kBwRows - 1) / kBwRows) *
                        ((args.cols + BN - 1) / BN) * args.splits;
  if (blocks <= 0 || blocks > tiles) return (int)cudaErrorInvalidConfiguration;
  constexpr int smem = BwdTiles<BN>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap ma = a, mb = b;
  BwdGemmArgs pa = args;
  void* params[] = {&ma, &mb, &pa};
  err = cudaLaunchKernel(kernel, dim3((unsigned)blocks), dim3(kWgThreads),
                         params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool kDw>
int launch_bwd_width(int width, const CUtensorMap& a, const CUtensorMap& b,
                     const BwdGemmArgs& args, int64_t blocks,
                     cudaStream_t stream) {
  switch (width) {
#define LN_BWD_WIDTH(BN)                                                      \
  case BN:                                                                    \
    return launch_bwd_gemm<BN>(                                               \
        kDw ? reinterpret_cast<const void*>(ln_dense_dw_wgmma_kernel<BN>)     \
            : reinterpret_cast<const void*>(ln_dense_dz_wgmma_kernel<BN>),    \
        a, b, args, blocks, stream);
    LN_BWD_WIDTH(128)
    LN_BWD_WIDTH(192)
    LN_BWD_WIDTH(256)
#undef LN_BWD_WIDTH
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int launch_dx_rows(DxRowsArgs args, cudaStream_t stream) {
  void* params[] = {&args};
  const dim3 grid((unsigned)((args.m + kDxRows - 1) / kDxRows));
  const int chunks = (args.c + 255) / 256;
  // gamma, beta and the warps' two partial rows, 256 columns a chunk.
  const size_t smem =
      (2 + 2 * (size_t)kThreads / 32) * 256 * chunks * sizeof(float);
  switch (chunks) {
#define LN_DX_CHUNKS(N)                                                       \
  case N:                                                                     \
    return launch_checked(                                                    \
        reinterpret_cast<const void*>(ln_dense_dx_rows_kernel<N>), grid,      \
        smem, params, stream);
    LN_DX_CHUNKS(1)
    LN_DX_CHUNKS(2)
    LN_DX_CHUNKS(3)
    LN_DX_CHUNKS(4)
#undef LN_DX_CHUNKS
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The bf16 backward on Hopper: row statistics (below C = 256); dz = g w
// (f32, into the scratch dz); dx, z and the dgamma / dbeta partials by 64-row blocks;
// their sums; dW = g^T z by slices of M with the db partials; their sums.
int launch_bwd_wgmma(const bf16* x, const float* gamma, const float* beta,
                     const bf16* w, const bf16* g, float* mean, float* rstd,
                     bf16* dx, float* part_gb, float* dgb, float* part_dw,
                     float* part_db, bf16* dw, float* db, bf16* z, float* dz,
                     int m, int c, int o, float eps, const int64_t* maps,
                     cudaStream_t stream) {
  if (c % 8 != 0 || o % 8 != 0 || c > 256 * kDxMaxChunks)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, w, g, dx, z, dz};
  for (const void* ptr : ptrs)
    if (!aligned16(ptr)) return (int)cudaErrorMisalignedAddress;
  const int64_t* plan = maps + kBwdPlan;
  const int splits = (int)plan[4], per_split = (int)plan[5];
  if (splits <= 0 || per_split <= 0 || per_split % kBwDepth != 0 ||
      (int64_t)splits * per_split < m || (int64_t)(splits - 1) * per_split >= m)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tmaps[4];
  const void* bases[4] = {g, w, g, z};
  for (int i = 0; i < 4; ++i) {
    const int err = hopper::encode_bf16_map(&tmaps[i], bases[i],
                                            maps + i * hopper::kGeometrySize);
    if (err != 0) return err;
  }
  // Where row_stats gives a row 32 lanes (C >= 256) the dx pass takes the
  // statistics itself, in its order; elsewhere from its launch.
  const int own_stats = stats_lanes<bf16>(c, 1) == 32;
  int err = 0;
  if (!own_stats && (err = launch_stats<bf16>(x, mean, rstd, m, c, eps,
                                              stream)) != 0)
    return err;
  const BwdGemmArgs dza = {dz, nullptr, nullptr, m, c, o, 1,
                           (o + kBwDepth - 1) / kBwDepth * kBwDepth};
  if ((err = launch_bwd_width<false>((int)plan[1], tmaps[0], tmaps[1], dza,
                                     plan[0], stream)) != 0)
    return err;
  const int dx_blocks = (m + kDxRows - 1) / kDxRows;
  float* part_g = part_gb;
  float* part_b = part_gb + (int64_t)dx_blocks * c;
  if ((err = launch_dx_rows({x, dz, gamma, beta, mean, rstd, dx, z, part_g,
                             part_b, m, c, own_stats, eps}, stream)) != 0)
    return err;
  if ((err = launch_sum<float>(part_g, dx_blocks, c, dgb, stream)) != 0)
    return err;
  if ((err = launch_sum<float>(part_b, dx_blocks, c, dgb + c, stream)) != 0)
    return err;
  // In one slice the GEMM writes dW (rounded once) and db itself.
  const bool one = splits == 1;
  const BwdGemmArgs dwa = {part_dw, one ? dw : nullptr, one ? db : part_db,
                           o, c, m, splits, per_split};
  if ((err = launch_bwd_width<true>((int)plan[3], tmaps[2], tmaps[3], dwa,
                                    plan[2], stream)) != 0 || one)
    return err;
  if ((err = launch_sum<bf16>(part_dw, splits, (int64_t)o * c, dw, stream)) != 0)
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
// maps: NULL for the first bodies, or (bf16) tma.py ·
// packed_ln_dense_bwd_maps, which select the TMA + wgmma body; it then
// takes dx_rows 64 and splits and needs the scratch z (M, C) in the dtype
// and dz (M, C) in f32 (both NULL otherwise).
extern "C" int tfimm_ln_dense_bwd(const void* x, const void* gamma,
                                  const void* beta, const void* w,
                                  const void* g, void* mean, void* rstd,
                                  void* dx, void* part_gb, void* dgb,
                                  void* part_dw, void* part_db, void* dw,
                                  void* db, int m, int c, int o, int dx_rows,
                                  int splits, float eps, int dtype, void* z,
                                  void* dz, const int64_t* maps,
                                  void* stream) {
  if (m <= 0 || c <= 0 || o <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (maps != nullptr) {
    if (dtype != 1 || dx_rows != kDxRows || splits != (int)maps[kBwdPlan + 4])
      return (int)cudaErrorInvalidValue;
    return launch_bwd_wgmma(
        static_cast<const bf16*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<const bf16*>(w),
        static_cast<const bf16*>(g), static_cast<float*>(mean),
        static_cast<float*>(rstd), static_cast<bf16*>(dx),
        static_cast<float*>(part_gb), static_cast<float*>(dgb),
        static_cast<float*>(part_dw), static_cast<float*>(part_db),
        static_cast<bf16*>(dw), static_cast<float*>(db), static_cast<bf16*>(z),
        static_cast<float*>(dz), m, c, o, eps, maps, s);
  }
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
