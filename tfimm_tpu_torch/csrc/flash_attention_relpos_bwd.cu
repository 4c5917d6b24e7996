// Flash attention with the decomposed relative-position bias, backward.
//
// Replaces: tfimm_tpu/ops/pallas/flash_attention_relpos.py ·
// _relpos_backward_call (its single-pass window-sized kernel and the
// streaming dq/drh/drw and dk/dv kernels) and _relpos_backward_call_paired
// (the same function with two heads packed into 128 lanes). Per row b of
// (B, N, d), B = images * heads, N = gh * gw, everything in f32:
//
//     s[i, c] = qs_i . k_c + (rh[i, c / gw] + rw[i, c % gw])
//     p = exp(s - lse)                     (the forward's f32 lse: exact)
//     dv = p^T do,   ds = p * (do v^T - delta)
//     dqs = ds k,    dk = ds^T qs
//     drh[i, h] = sum_{c / gw = h} ds[i, c],  drw[i, w] = sum_{c % gw = w} ds[i, c]
//
// delta_i = do_i . o_i arrives from the wrapper (f32 (B, N)), as the JAX
// package computes it outside its pallas_call; qs arrives scaled (autograd
// chains the scale). No clamp: the softmax is exact, so ds needs no mask.
//
// Two launches per call, deterministic, no atomics (fused_mha_bwd.cu's
// layout; neither reads the other's output, so their order is free):
//
// (A) dqs, drh, drw: one block per (64 query rows, row b). It streams the
//     keys in tiles, recomputes s from the staged rel terms of its rows and
//     p from the lse, forms ds and accumulates dqs = ds k. Each query row's
//     gh + gw f32 sums live in shared memory across the whole key loop. In
//     bf16 each tile's ds is added from registers, one key-grid row of the
//     tile at a time: within one, every key has its own column, so no two
//     lanes add into the same drw entry, and drh takes the sum over the 4
//     lanes that hold a query row. In f32 the ds tile passes through shared
//     memory, and one thread adds a row's keys into drw column by column,
//     another into drh by key-grid row. Every sum runs in a fixed order.
// (B) dk, dv: one block per (64 keys, row b). It keeps its k and v rows,
//     streams the queries in tiles with their lse, delta and rel terms,
//     recomputes s^T and p^T, and accumulates dv = p^T do and dk = ds^T qs.
//
// - bf16 (the training path): tensor cores through mma.sync m16n8k16 (bf16
//   in, f32 accumulate), 4 warps each owning 16 rows, 32-row streamed
//   tiles; the accumulator layout of two 8-column product tiles is the A
//   layout of one 16-deep step, so p and ds go from one product to the
//   next in registers. p and ds are rounded to bf16 before dv = p^T do,
//   dqs = ds k and dk = ds^T qs (the reference keeps them in f32); s, p,
//   dp, delta, the rel sums and every accumulator stay f32.
// - f32: exact f32 FMAs, 256 threads as a 16 x 16 grid, 64-row streamed
//   tiles; p and ds pass through shared memory; the rel terms are read
//   from device memory (L1/L2), which keeps shared memory within 227 KB at
//   d = 128 and gh = gw = 128.
//
// What bounds it on an H100: the function needs five N x N x d products,
// 10 * B * N^2 * d operations: 128.8 GFLOP at SAM-B's global blocks (B =
// 12, N = 4096, d = 64), 0.130 ms at the bf16 tensor-core peak, while it
// moves about 76 MB (bound by operations); 7.4 GFLOP against about 67 MB at
// the windowed blocks (B = 300, N = 196), 0.020 ms (bound by bytes). This
// design recomputes s and dp in both launches (seven products), pads the
// 196 keys to 224 and the rows to 256, and is bound by shared-memory
// fragment loads feeding mma.sync: synchronous tile loads (no cp.async or
// TMA), no wgmma, an integer division per key for the bias index, and the
// rel sums' shared-memory adds.
//
// Shared memory, bf16 at d = 64 and gh = gw = 64: (A) 76.0 KiB, (B) 35.5
// KiB; at d = 128 and gh = gw = 128: (A) 148.0 KiB, (B) 67.5 KiB; f32 at
// d = 128 and gh = gw = 128: (A) 209.8 KiB, (B) 162.0 KiB. Above the 48 KB
// static limit a launch needs the dynamic limit raised, so the launcher
// sets cudaFuncAttributeMaxDynamicSharedMemorySize before every launch and
// returns cudaGetLastError() after each.
//
// Coverage: the forward's. Any B (launched in slices of 65535 rows), any N
// = gh * gw (ragged tails masked: keys past N add nothing to any gradient,
// queries past N write nothing), gh and gw up to 128, every head dim d that
// is a multiple of 8 up to 128 (bf16 pads d to a multiple of 16 in shared
// memory with zeros). qs, k and v are read through their batch and row
// strides (bf16: 16-byte aligned rows); do, the rel terms and the outputs
// are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                 // a block's own rows
constexpr int kMaxHeadDim = 128;
constexpr int kMaxGridSide = 128;
constexpr int kMaxRowsPerLaunch = 65535;  // gridDim.y

struct Strides {
  int64_t q_b, q_n, k_b, k_n, v_b, v_n;
};

// Row stride, in elements, of a staged rel-term tile or rel-sum row with
// `cols` columns: an odd number of 32-bit words, so 8 consecutive rows
// start in 8 banks.
template <typename T>
__host__ __device__ inline int rel_ld(int cols) {
  if (sizeof(T) == 4) return cols | 1;
  return cols + ((2 - cols % 4) + 4) % 4;   // cols = 2 (mod 4)
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// The rel terms of rows [r0, r0 + ROWS) of one row b into shared memory;
// rows at or beyond n become zeros.
template <typename T, int ROWS, int NT>
__device__ __forceinline__ void load_rel(const T* __restrict__ src, T* dst,
                                         int r0, int n, int cols, int ld) {
  for (int i = threadIdx.x; i < ROWS * cols; i += NT) {
    const int r = i / cols, c = i - r * cols;
    const int row = r0 + r;
    dst[r * ld + c] = row < n ? src[(int64_t)row * cols + c] : T(0.f);
  }
}

// f32: adds the ds of one query row over `live` keys starting at key c0
// (ds_row in shared memory) into the row's rel sums: drw by key column (dw_row),
// or drh by key-grid row (dh_row, one add per run of a key row). The keys
// are taken in order, so the sums are deterministic.
__device__ __forceinline__ void add_rel_sums(const float* ds_row, float* dh_row,
                                             float* dw_row, int c0, int live,
                                             int gw, bool to_h) {
  int kw = c0 % gw;
  if (!to_h) {
    for (int c = 0; c < live; ++c) {
      dw_row[kw] += ds_row[c];
      if (++kw == gw) kw = 0;
    }
    return;
  }
  int kh = c0 / gw;
  float run = 0.f;
  for (int c = 0; c < live; ++c) {
    run += ds_row[c];
    if (++kw == gw) {
      dh_row[kh++] += run;
      run = 0.f;
      kw = 0;
    }
  }
  if (kw != 0) dh_row[kh] += run;
}

// The accumulated rel sums of rows [r0, r0 + ROWS) of the block's tile
// (from row `first` of the shared-memory sums) to device memory, in the io
// dtype; rows at or beyond n are skipped.
template <typename T>
__device__ __forceinline__ void store_rel(T* __restrict__ dst, const float* src,
                                          int first, int rows, int r0, int n,
                                          int cols, int ld, int tid, int nt) {
  for (int i = tid; i < rows * cols; i += nt) {
    const int r = i / cols, c = i - r * cols;
    const int row = r0 + first + r;
    if (row < n) dst[(int64_t)row * cols + c] = T(src[(first + r) * ld + c]);
  }
}

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

template <int DP>
__host__ __device__ constexpr int mma_ld() { return DP + 8; }  // padded smem row

// (A): the f32 rel sums, then q, do (own), k, v (streamed) and the own
// rows' rel terms.
template <int DP>
size_t rows_smem_bytes(int gh, int gw) {
  return sizeof(float) * (size_t)kRows * (rel_ld<float>(gh) + rel_ld<float>(gw)) +
         sizeof(bf16) * ((size_t)(2 * kRows + 2 * kCols) * mma_ld<DP>() +
                         (size_t)kRows * (rel_ld<bf16>(gh) + rel_ld<bf16>(gw)));
}

// (B): lse and delta of the streamed queries, then k, v (own), q, do
// (streamed) and the streamed queries' rel terms.
template <int DP>
size_t keys_smem_bytes(int gh, int gw) {
  return sizeof(float) * 2 * kCols +
         sizeof(bf16) * ((size_t)(2 * kRows + 2 * kCols) * mma_ld<DP>() +
                         (size_t)kCols * (rel_ld<bf16>(gh) + rel_ld<bf16>(gw)));
}

// Rows [r0, r0 + ROWS) of one row's q, k, v or do into shared memory, 16
// bytes per load; rows at or beyond n and columns at or beyond d become
// zeros.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src,
                                          bf16* dst, int r0, int n, int d,
                                          int64_t row_stride) {
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
__device__ __forceinline__ void warp_abt(const bf16* a_s, int r,
                                         const bf16* b_s,
                                         float (&c)[kColTiles][4]) {
  constexpr int LD = mma_ld<DP>();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < kColTiles; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const bf16* pa = a_s + (r + g) * LD + ks * 16 + 2 * t;
    const uint32_t a[4] = {ld_u32(pa), ld_u32(pa + 8 * LD), ld_u32(pa + 8),
                           ld_u32(pa + 8 * LD + 8)};
#pragma unroll
    for (int j = 0; j < kColTiles; ++j) {
      const bf16* pb = b_s + (8 * j + g) * LD + ks * 16 + 2 * t;
      mma_16816(c[j], a, ld_u32(pb), ld_u32(pb + 8));
    }
  }
}

// acc += X @ B: X (16 own rows x kCols) given as A fragments, one per
// 16-deep step, times the streamed tile B (kCols rows x DP). Steps whose
// 16 streamed rows all lie at or beyond the end (live <= 16 m) are skipped.
template <int DP>
__device__ __forceinline__ void warp_ab(const uint32_t (&x)[kColSteps][4],
                                        const bf16* b_s, int live,
                                        float (&acc)[DP / 8][4]) {
  constexpr int LD = mma_ld<DP>();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int m = 0; m < kColSteps; ++m) {
    if (16 * m >= live) break;
#pragma unroll
    for (int jd = 0; jd < DP / 8; ++jd) {
      const bf16* p = b_s + (16 * m + 2 * t) * LD + 8 * jd + g;
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

// Rows row and row + 8 of a 16-row accumulator into the contiguous (n, d)
// rows of out where they lie below n.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* out, int row, int n, int d,
                                           const float (&acc)[DP / 8][4]) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int jd = 0; jd < DP / 8; ++jd) {
    const int c = 8 * jd + 2 * t;
    if (c >= d) break;
    if (row < n)
      *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * d + c) =
          __floats2bfloat162_rn(acc[jd][0], acc[jd][1]);
    if (row + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)(row + 8) * d + c) =
          __floats2bfloat162_rn(acc[jd][2], acc[jd][3]);
  }
}

// (A): dqs, drh, drw. DP: the head dim rounded up to a multiple of 16.
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
relpos_bwd_rows_bf16_kernel(const bf16* __restrict__ qs,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, Strides st,
                            const bf16* __restrict__ rh,
                            const bf16* __restrict__ rw,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dq, bf16* __restrict__ drh,
                            bf16* __restrict__ drw, int n, int d, int gh,
                            int gw, int b0) {
  constexpr int LD = mma_ld<DP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldh = rel_ld<bf16>(gh), ldw = rel_ld<bf16>(gw);
  const int ah = rel_ld<float>(gh), aw = rel_ld<float>(gw);
  float* dh_s = reinterpret_cast<float*>(smem_raw);   // kRows x ah
  float* dw_s = dh_s + kRows * ah;                     // kRows x aw
  bf16* q_s = reinterpret_cast<bf16*>(dw_s + kRows * aw);
  bf16* g_s = q_s + kRows * LD;
  bf16* k_s = g_s + kRows * LD;
  bf16* v_s = k_s + kCols * LD;
  bf16* rh_s = v_s + kCols * LD;                       // kRows x ldh
  bf16* rw_s = rh_s + kRows * ldh;                     // kRows x ldw

  const int q0 = blockIdx.x * kRows;
  const int64_t b = (int64_t)b0 + blockIdx.y;
  const int64_t bn = b * n;
  const bf16* q_g = qs + b * st.q_b;
  const bf16* k_g = k + b * st.k_b;
  const bf16* v_g = v + b * st.v_b;

  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = (threadIdx.x / 32) * 16;  // this warp's first own row
  const bool active = q0 + wr < n;
  const int r_lo = wr + g;

  load_tile<DP, kRows>(q_g, q_s, q0, n, d, st.q_n);
  load_tile<DP, kRows>(dout + bn * d, g_s, q0, n, d, d);
  load_rel<bf16, kRows, kMmaThreads>(rh + bn * gh, rh_s, q0, n, gh, ldh);
  load_rel<bf16, kRows, kMmaThreads>(rw + bn * gw, rw_s, q0, n, gw, ldw);
  for (int i = threadIdx.x; i < kRows * (ah + aw); i += kMmaThreads)
    dh_s[i] = 0.f;                         // dh_s and dw_s are adjacent

  // lse and delta of rows r_lo and r_lo + 8; rows past n get 0 and 0, so
  // that their ds is exactly 0 (do is 0 there).
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = q0 + r_lo + 8 * e;
    row_lse[e] = row < n ? lse[bn + row] : 0.f;
    row_delta[e] = row < n ? delta[bn + row] : 0.f;
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int jd = 0; jd < DP / 8; ++jd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[jd][i] = 0.f;

  float s[kColTiles][4], dp[kColTiles][4];
  for (int c0 = 0; c0 < n; c0 += kCols) {
    __syncthreads();  // previous tile fully read (and own tiles written)
    load_tile<DP, kCols>(k_g, k_s, c0, n, d, st.k_n);
    load_tile<DP, kCols>(v_g, v_s, c0, n, d, st.v_n);
    __syncthreads();
    if (!active) continue;
    warp_abt<DP>(q_s, wr, k_s, s);
    warp_abt<DP>(g_s, wr, v_s, dp);
    // ds in the layout of s; keys past n get 0. The tile's keys c0 + col
    // lie in key-grid rows kh0 + wrap, wrap = (kw0 + col) / gw.
    const int kh0 = c0 / gw, kw0 = c0 - kh0 * gw;
    float ds[kColTiles][4];
    int wrap[kColTiles][2];
    uint32_t dsf[kColSteps][4];
#pragma unroll
    for (int j = 0; j < kColTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const bool ok = c0 + col < n;
        const int w = (kw0 + col) / gw, kw = kw0 + col - w * gw;
        wrap[j][e] = ok ? w : -1;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r_lo + 8 * h;
          const float sc = s[j][2 * h + e] +
                           (to_f32(rh_s[r * ldh + (ok ? kh0 + w : 0)]) +
                            to_f32(rw_s[r * ldw + kw]));
          ds[j][2 * h + e] =
              ok ? expf(sc - row_lse[h]) * (dp[j][2 * h + e] - row_delta[h])
                 : 0.f;
        }
      }
      pack_frag(dsf, j, ds[j]);
    }
    warp_ab<DP>(dsf, k_s, n - c0, acc);
    // The rel sums, one key-grid row of the tile at a time: within one,
    // every key has its own column, so no two lanes add into the same drw
    // entry; drh takes the row's sum over the 4 lanes that hold it.
    const int wraps = (kw0 + min(kCols, n - c0) - 1) / gw + 1;
    for (int w = 0; w < wraps; ++w) {
      float h_lo = 0.f, h_hi = 0.f;
#pragma unroll
      for (int j = 0; j < kColTiles; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (wrap[j][e] == w) {
            const int kw = kw0 + 8 * j + 2 * t + e - w * gw;
            dw_s[r_lo * aw + kw] += ds[j][e];
            dw_s[(r_lo + 8) * aw + kw] += ds[j][2 + e];
            h_lo += ds[j][e];
            h_hi += ds[j][2 + e];
          }
      h_lo = quad_sum(h_lo);
      h_hi = quad_sum(h_hi);
      if (t == 0) {
        dh_s[r_lo * ah + kh0 + w] += h_lo;
        dh_s[(r_lo + 8) * ah + kh0 + w] += h_hi;
      }
      __syncwarp();   // this row's adds land before the next one's
    }
  }
  if (!active) return;

  store_rows<DP>(dq + bn * d, q0 + r_lo, n, d, acc);
  // Each warp added into its own 16 rows' sums only.
  store_rel(drh + bn * gh, dh_s, wr, 16, q0, n, gh, ah, lane, 32);
  store_rel(drw + bn * gw, dw_s, wr, 16, q0, n, gw, aw, lane, 32);
}

// (B): dk and dv.
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
relpos_bwd_keys_bf16_kernel(const bf16* __restrict__ qs,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, Strides st,
                            const bf16* __restrict__ rh,
                            const bf16* __restrict__ rw,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int n, int d, int gh, int gw, int b0) {
  constexpr int LD = mma_ld<DP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldh = rel_ld<bf16>(gh), ldw = rel_ld<bf16>(gw);
  float* lse_s = reinterpret_cast<float*>(smem_raw);
  float* dl_s = lse_s + kCols;
  bf16* k_s = reinterpret_cast<bf16*>(dl_s + kCols);
  bf16* v_s = k_s + kRows * LD;
  bf16* q_s = v_s + kRows * LD;
  bf16* g_s = q_s + kCols * LD;
  bf16* rh_s = g_s + kCols * LD;                       // kCols x ldh
  bf16* rw_s = rh_s + kCols * ldh;                     // kCols x ldw

  const int k0 = blockIdx.x * kRows;
  const int64_t b = (int64_t)b0 + blockIdx.y;
  const int64_t bn = b * n;
  const bf16* q_g = qs + b * st.q_b;
  const bf16* g_g = dout + bn * d;

  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = (threadIdx.x / 32) * 16;  // this warp's first own key
  const bool active = k0 + wr < n;

  load_tile<DP, kRows>(k + b * st.k_b, k_s, k0, n, d, st.k_n);
  load_tile<DP, kRows>(v + b * st.v_b, v_s, k0, n, d, st.v_n);

  // Grid row and column of own keys k0 + wr + g and + 8 (0 past n, whose
  // gradients are not stored).
  int kh[2], kw[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int key = k0 + wr + g + 8 * e;
    kh[e] = key < n ? key / gw : 0;
    kw[e] = key < n ? key - kh[e] * gw : 0;
  }

  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
#pragma unroll
  for (int jd = 0; jd < DP / 8; ++jd)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[jd][i] = dv_acc[jd][i] = 0.f;

  float s[kColTiles][4], dp[kColTiles][4];
  for (int c0 = 0; c0 < n; c0 += kCols) {
    __syncthreads();  // previous tile fully read (and own tiles written)
    load_tile<DP, kCols>(q_g, q_s, c0, n, d, st.q_n);
    load_tile<DP, kCols>(g_g, g_s, c0, n, d, d);
    load_rel<bf16, kCols, kMmaThreads>(rh + bn * gh, rh_s, c0, n, gh, ldh);
    load_rel<bf16, kCols, kMmaThreads>(rw + bn * gw, rw_s, c0, n, gw, ldw);
    for (int i = threadIdx.x; i < kCols; i += kMmaThreads) {
      const bool ok = c0 + i < n;
      lse_s[i] = ok ? lse[bn + c0 + i] : 0.f;
      dl_s[i] = ok ? delta[bn + c0 + i] : 0.f;
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
        const int qc = 8 * j + 2 * t + i % 2;
        const int e = i / 2;
        p[i] = 0.f;
        if (c0 + qc < n)
          p[i] = expf(s[j][i] + (to_f32(rh_s[qc * ldh + kh[e]]) +
                                 to_f32(rw_s[qc * ldw + kw[e]])) - lse_s[qc]);
        ds[i] = p[i] * (dp[j][i] - dl_s[qc]);
      }
      pack_frag(pf, j, p);
      pack_frag(dsf, j, ds);
    }
    warp_ab<DP>(pf, g_s, n - c0, dv_acc);
    warp_ab<DP>(dsf, q_s, n - c0, dk_acc);
  }
  if (!active) return;

  const int row = k0 + wr + g;
  store_rows<DP>(dk + bn * d, row, n, d, dk_acc);
  store_rows<DP>(dv + bn * d, row, n, d, dv_acc);
}

struct Args {
  const void *qs, *k, *v;
  Strides st;
  const void *rh, *rw, *dout, *lse, *delta;
  void *dq, *dk, *dv, *drh, *drw;
  int batch, n, d, gh, gw;
};

template <int DP>
int launch_bf16(const Args& a, cudaStream_t stream) {
  const size_t smem_a = rows_smem_bytes<DP>(a.gh, a.gw);
  const size_t smem_b = keys_smem_bytes<DP>(a.gh, a.gw);
  cudaError_t err = cudaFuncSetAttribute(
      relpos_bwd_rows_bf16_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(relpos_bwd_keys_bf16_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < a.batch; b0 += kMaxRowsPerLaunch) {
    const dim3 grid((a.n + kRows - 1) / kRows,
                    a.batch - b0 < kMaxRowsPerLaunch ? a.batch - b0
                                                     : kMaxRowsPerLaunch);
    relpos_bwd_rows_bf16_kernel<DP><<<grid, kMmaThreads, smem_a, stream>>>(
        static_cast<const bf16*>(a.qs), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), a.st, static_cast<const bf16*>(a.rh),
        static_cast<const bf16*>(a.rw), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<bf16*>(a.dq), static_cast<bf16*>(a.drh),
        static_cast<bf16*>(a.drw), a.n, a.d, a.gh, a.gw, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    relpos_bwd_keys_bf16_kernel<DP><<<grid, kMmaThreads, smem_b, stream>>>(
        static_cast<const bf16*>(a.qs), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), a.st, static_cast<const bf16*>(a.rh),
        static_cast<const bf16*>(a.rw), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.n, a.d, a.gh,
        a.gw, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int dispatch_bf16(const Args& a, cudaStream_t s) {
  switch ((a.d + 15) / 16) {
    case 1: return launch_bf16<16>(a, s);
    case 2: return launch_bf16<32>(a, s);
    case 3: return launch_bf16<48>(a, s);
    case 4: return launch_bf16<64>(a, s);
    case 5: return launch_bf16<80>(a, s);
    case 6: return launch_bf16<96>(a, s);
    case 7: return launch_bf16<112>(a, s);
    case 8: return launch_bf16<128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// f32: FMA

constexpr int kFmaThreads = 256;          // 16 x 16
constexpr int kFmaCols = 64;              // streamed rows per tile
constexpr int kOwn = kRows / 16;          // own rows per thread
constexpr int kStr = kFmaCols / 16;       // streamed columns per thread
constexpr int kDims = kMaxHeadDim / 16;   // head columns per thread (max)
constexpr int kLdt = kFmaCols + 1;        // row stride of the p / ds tiles

// (A): q, do, k, v tiles (64, d + 1), the ds tile and the rel sums.
size_t rows_f32_smem_bytes(int d, int gh, int gw) {
  return sizeof(float) * ((size_t)4 * kRows * (d + 1) + (size_t)kRows * kLdt +
                          (size_t)kRows * (rel_ld<float>(gh) + rel_ld<float>(gw)));
}

// (B): k, v, q, do tiles, the p and ds tiles, lse and delta.
size_t keys_f32_smem_bytes(int d) {
  return sizeof(float) * ((size_t)4 * kRows * (d + 1) +
                          (size_t)2 * kRows * kLdt + 2 * kFmaCols);
}

// Rows [r0, r0 + 64) of one row's q, k, v or do into a (64, d + 1) tile;
// rows at or beyond n become zeros.
__device__ __forceinline__ void load_rows_f32(const float* __restrict__ src,
                                              float* dst, int r0, int n, int d,
                                              int64_t row_stride) {
  for (int i = threadIdx.x; i < kRows * d; i += kFmaThreads) {
    const int r = i / d, c = i % d;
    const int row = r0 + r;
    dst[r * (d + 1) + c] = row < n ? src[(int64_t)row * row_stride + c] : 0.f;
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

__device__ __forceinline__ void store_rows_f32(float* out, int r0, int n,
                                               int d,
                                               const float (&acc)[kOwn][kDims]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < kDims; ++c) {
      const int col = tx + 16 * c;
      if (col < d) out[(int64_t)row * d + col] = acc[i][c];
    }
  }
}

__global__ void __launch_bounds__(kFmaThreads)
relpos_bwd_rows_f32_kernel(const float* __restrict__ qs,
                           const float* __restrict__ k,
                           const float* __restrict__ v, Strides st,
                           const float* __restrict__ rh,
                           const float* __restrict__ rw,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, float* __restrict__ drh,
                           float* __restrict__ drw, int n, int d, int gh,
                           int gw, int b0) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int ah = rel_ld<float>(gh), aw = rel_ld<float>(gw);
  float* q_s = smem;
  float* g_s = q_s + kRows * ld;
  float* k_s = g_s + kRows * ld;
  float* v_s = k_s + kRows * ld;
  float* ds_s = v_s + kRows * ld;     // kRows x kLdt
  float* dh_s = ds_s + kRows * kLdt;  // kRows x ah
  float* dw_s = dh_s + kRows * ah;    // kRows x aw

  const int q0 = blockIdx.x * kRows;
  const int64_t b = (int64_t)b0 + blockIdx.y;
  const int64_t bn = b * n;
  const float* k_g = k + b * st.k_b;
  const float* v_g = v + b * st.v_b;
  const float* rh_g = rh + bn * gh;
  const float* rw_g = rw + bn * gw;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  load_rows_f32(qs + b * st.q_b, q_s, q0, n, d, st.q_n);
  load_rows_f32(dout + bn * d, g_s, q0, n, d, d);
  for (int i = tid; i < kRows * (ah + aw); i += kFmaThreads) dh_s[i] = 0.f;

  float row_lse[kOwn], row_delta[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int row = q0 + ty + 16 * i;
    row_lse[i] = row < n ? lse[bn + row] : 0.f;
    row_delta[i] = row < n ? delta[bn + row] : 0.f;
  }

  float acc[kOwn][kDims];
#pragma unroll
  for (int i = 0; i < kOwn; ++i)
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[i][c] = 0.f;

  float s[kOwn][kStr], dp[kOwn][kStr];
  for (int c0 = 0; c0 < n; c0 += kFmaCols) {
    __syncthreads();  // previous tile fully read (and own tiles written)
    load_rows_f32(k_g, k_s, c0, n, d, st.k_n);
    load_rows_f32(v_g, v_s, c0, n, d, st.v_n);
    __syncthreads();
    fma_abt(q_s, k_s, d, s);
    fma_abt(g_s, v_s, d, dp);
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kStr; ++j) {
        const int key = c0 + tx + 16 * j;
        float x = 0.f;
        if (key < n && row < n) {
          const int kh = key / gw, kw = key - kh * gw;
          const float sc = s[i][j] + (rh_g[(int64_t)row * gh + kh] +
                                      rw_g[(int64_t)row * gw + kw]);
          x = expf(sc - row_lse[i]) * (dp[i][j] - row_delta[i]);
        }
        ds_s[(ty + 16 * i) * kLdt + tx + 16 * j] = x;
      }
    }
    __syncthreads();
    fma_ab(ds_s, k_s, n - c0, d, acc);
    // Threads 0-63 add their row's ds into drw, 64-127 into drh.
    if (tid < 2 * kRows) {
      const int r = tid % kRows;
      add_rel_sums(ds_s + r * kLdt, dh_s + r * ah, dw_s + r * aw, c0,
                   min(kFmaCols, n - c0), gw, tid >= kRows);
    }
  }
  __syncthreads();

  store_rows_f32(dq + bn * d, q0, n, d, acc);
  store_rel(drh + bn * gh, dh_s, 0, kRows, q0, n, gh, ah, tid, kFmaThreads);
  store_rel(drw + bn * gw, dw_s, 0, kRows, q0, n, gw, aw, tid, kFmaThreads);
}

__global__ void __launch_bounds__(kFmaThreads)
relpos_bwd_keys_f32_kernel(const float* __restrict__ qs,
                           const float* __restrict__ k,
                           const float* __restrict__ v, Strides st,
                           const float* __restrict__ rh,
                           const float* __restrict__ rw,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int n, int d, int gh, int gw, int b0) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* k_s = smem;
  float* v_s = k_s + kRows * ld;
  float* q_s = v_s + kRows * ld;
  float* g_s = q_s + kRows * ld;
  float* p_s = g_s + kRows * ld;      // kRows x kLdt
  float* ds_s = p_s + kRows * kLdt;   // kRows x kLdt
  float* lse_s = ds_s + kRows * kLdt;
  float* dl_s = lse_s + kFmaCols;

  const int k0 = blockIdx.x * kRows;
  const int64_t b = (int64_t)b0 + blockIdx.y;
  const int64_t bn = b * n;
  const float* q_g = qs + b * st.q_b;
  const float* g_g = dout + bn * d;
  const float* rh_g = rh + bn * gh;
  const float* rw_g = rw + bn * gw;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_rows_f32(k + b * st.k_b, k_s, k0, n, d, st.k_n);
  load_rows_f32(v + b * st.v_b, v_s, k0, n, d, st.v_n);

  int kh[kOwn], kw[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int key = k0 + ty + 16 * i;
    kh[i] = key < n ? key / gw : 0;
    kw[i] = key < n ? key - kh[i] * gw : 0;
  }

  float dk_acc[kOwn][kDims], dv_acc[kOwn][kDims];
#pragma unroll
  for (int i = 0; i < kOwn; ++i)
#pragma unroll
    for (int c = 0; c < kDims; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  float s[kOwn][kStr], dp[kOwn][kStr];
  for (int c0 = 0; c0 < n; c0 += kFmaCols) {
    __syncthreads();  // previous tile fully read (and own tiles written)
    load_rows_f32(q_g, q_s, c0, n, d, st.q_n);
    load_rows_f32(g_g, g_s, c0, n, d, d);
    for (int i = threadIdx.x; i < kFmaCols; i += kFmaThreads) {
      const bool ok = c0 + i < n;
      lse_s[i] = ok ? lse[bn + c0 + i] : 0.f;
      dl_s[i] = ok ? delta[bn + c0 + i] : 0.f;
    }
    __syncthreads();
    fma_abt(k_s, q_s, d, s);     // s^T: own keys x streamed queries
    fma_abt(v_s, g_s, d, dp);    // dp^T
#pragma unroll
    for (int i = 0; i < kOwn; ++i)
#pragma unroll
      for (int j = 0; j < kStr; ++j) {
        const int q = tx + 16 * j;
        const int64_t query = c0 + q;
        float p = 0.f;
        if (query < n)
          p = expf(s[i][j] + (rh_g[query * gh + kh[i]] +
                              rw_g[query * gw + kw[i]]) - lse_s[q]);
        p_s[(ty + 16 * i) * kLdt + q] = p;
        ds_s[(ty + 16 * i) * kLdt + q] = p * (dp[i][j] - dl_s[q]);
      }
    __syncthreads();
    fma_ab(p_s, g_s, n - c0, d, dv_acc);
    fma_ab(ds_s, q_s, n - c0, d, dk_acc);
  }

  store_rows_f32(dk + bn * d, k0, n, d, dk_acc);
  store_rows_f32(dv + bn * d, k0, n, d, dv_acc);
}

int launch_f32(const Args& a, cudaStream_t stream) {
  const size_t smem_a = rows_f32_smem_bytes(a.d, a.gh, a.gw);
  const size_t smem_b = keys_f32_smem_bytes(a.d);
  cudaError_t err = cudaFuncSetAttribute(
      relpos_bwd_rows_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(relpos_bwd_keys_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < a.batch; b0 += kMaxRowsPerLaunch) {
    const dim3 grid((a.n + kRows - 1) / kRows,
                    a.batch - b0 < kMaxRowsPerLaunch ? a.batch - b0
                                                     : kMaxRowsPerLaunch);
    relpos_bwd_rows_f32_kernel<<<grid, kFmaThreads, smem_a, stream>>>(
        static_cast<const float*>(a.qs), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), a.st, static_cast<const float*>(a.rh),
        static_cast<const float*>(a.rw), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.dq), static_cast<float*>(a.drh),
        static_cast<float*>(a.drw), a.n, a.d, a.gh, a.gw, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    relpos_bwd_keys_f32_kernel<<<grid, kFmaThreads, smem_b, stream>>>(
        static_cast<const float*>(a.qs), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), a.st, static_cast<const float*>(a.rh),
        static_cast<const float*>(a.rw), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.n, a.d, a.gh,
        a.gw, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; do, the rel
// terms, dq, dk, dv, drh and drw are contiguous in the io dtype, lse and
// delta contiguous f32 (B, N). Returns a cudaError_t value (0 = ok).
extern "C" int tfimm_flash_attention_relpos_bwd(
    const void* qs, const void* k, const void* v, int64_t q_sb, int64_t q_sn,
    int64_t k_sb, int64_t k_sn, int64_t v_sb, int64_t v_sn, const void* rh,
    const void* rw, const void* dout, const void* lse, const void* delta,
    void* dq, void* dk, void* dv, void* drh, void* drw, int batch, int n,
    int head_dim, int gh, int gw, int dtype, void* stream) {
  if (batch <= 0 || n <= 0 || head_dim <= 0 || head_dim % 8 != 0 ||
      head_dim > kMaxHeadDim || gh <= 0 || gw <= 0 || gh > kMaxGridSide ||
      gw > kMaxGridSide || n != gh * gw)
    return (int)cudaErrorInvalidValue;
  const Args a{qs,   k,  v,  {q_sb, q_sn, k_sb, k_sn, v_sb, v_sn},
               rh,   rw, dout, lse, delta, dq, dk, dv, drh, drw,
               batch, n, head_dim, gh, gw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_f32(a, s);
    case 1: {
      const int64_t strides[6] = {q_sb, q_sn, k_sb, k_sn, v_sb, v_sn};
      for (int64_t x : strides)
        if (x % 8 != 0) return (int)cudaErrorMisalignedAddress;
      const void* ptrs[7] = {qs, k, v, dout, dq, dk, dv};
      for (const void* p : ptrs)
        if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
          return (int)cudaErrorMisalignedAddress;
      return dispatch_bf16(a, s);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
