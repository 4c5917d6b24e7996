// Flash attention with the decomposed relative-position bias, backward.
//
// Replaces: tfimm_tpu/ops/pallas/flash_attention_relpos.py ·
// _relpos_backward_call (its single-pass window-sized kernel and the
// streaming dq/drh/drw and dk/dv kernels) and _relpos_backward_call_paired
// (the same function with two heads packed into 128 lanes: TPU layout, not
// carried over). Per row b of (B, N, d), B = images * heads, N = gh * gw,
// everything in f32:
//
//     s[i, c] = qs_i . k_c + (rh[i, c / gw] + rw[i, c % gw])
//     p = exp(s - lse)                     (the forward's f32 lse: exact)
//     dv = p^T do,   ds = p * (do v^T - delta),   delta_i = do_i . o_i
//     dqs = ds k,    dk = ds^T qs
//     drh[i, h] = sum_{c / gw = h} ds[i, c],  drw[i, w] = sum_{c % gw = w} ds[i, c]
//
// qs arrives scaled (autograd chains the scale). No clamp: the softmax is
// exact, so ds needs no mask. Two launches per call, deterministic, no
// atomics: (A) dqs, drh, drw over blocks of 64 query rows, (B) dk, dv over
// blocks of 64 keys.
//
// - bf16 (the training path), for Hopper: attention_bwd.cuh with the bias
//   (its note has the design), the flash backward's loop plus the bias and
//   its two sums. Where gw = 64 and d <= 64 (SAM-B's global blocks at
//   1024 x 1024) a 64-key tile is one key-grid row: (A) keeps rw's terms
//   and drw in registers and takes drh as a row sum a tile; (B) reads rw as
//   a TMA box a stage. Otherwise (the windowed 14 x 14 blocks, d = 80, any
//   grid up to 128 x 128) the general bias: (A) steps each column's
//   (c / gw, c % gw) from tile to tile with no division and adds the sums
//   in shared memory in a fixed order; (B) stages the streamed queries'
//   rel terms a tile at a time. (A) also forms delta from o and do, and
//   writes it with lse * log2(e) into an f32 scratch padded to 64 rows
//   that (B) reads.
// - f32: exact f32 FMAs, 256 threads as a 16 x 16 grid, 64-row streamed
//   tiles loaded synchronously; p and ds pass through shared memory; the
//   rel terms are read from device memory (L1/L2), which keeps shared
//   memory within 227 KB at d = 128 and gh = gw = 128; delta from the
//   wrapper.
//
// What bounds it on an H100: the function needs five N x N x d products,
// 10 * B * N^2 * d operations: 128.8 GFLOP at SAM-B's global blocks (B =
// 12, N = 4096, d = 64), 0.130 ms at the bf16 tensor-core peak, while it
// moves about 76 MB (bound by operations); 7.4 GFLOP against about 67 MB at
// the windowed blocks (B = 300, N = 196), 0.020 ms (bound by bytes). The
// Hopper design does seven products (0.182 ms at SAM-B's global blocks),
// plus about 3 FADDs an element in (A) and 1 in (B) on the CUDA cores for
// the bias and the sums. What holds it back: each warpgroup's serial chain
// (scores, exponentials, product) with two warpgroups an SM under 168
// registers a thread (ptxas' report in chip_smoke.py's build log), the
// exponentials, and at the windowed blocks the padding (196 rows and keys
// round up to 256) and the general path's per-key-row passes over the sums.
// On an H100 80GB HBM3 at 700 W the bf16 kernel takes 0.67 ms at SAM-B's
// global blocks (19% of the bound, 0.27-0.28x SDPA's backward with a float
// mask plus the two sums; the mma.sync design before it 4.13) and 0.22 ms
// at the windowed ones (9%, before 0.39-0.40) (chip_smoke.py phase 17;
// PERF.md, row 10).
//
// Shared memory, bf16 at d = 64: (A) 107 KB at gw = 64, 103 KB at 14 x 14;
// (B) 98 KB at 64 x 64, 108 KB at 14 x 14 (every query's rel terms); at most 214 KB (d = 128, 128 x
// 128); f32 at d = 128 and gh = gw = 128: (A) 209.8 KiB, (B) 162.0 KiB.
// Above the 48 KB static limit a launch needs the dynamic limit raised, so
// the launcher sets cudaFuncAttributeMaxDynamicSharedMemorySize before
// every launch and returns cudaGetLastError() after each (and the error of
// a tensor map that does not encode).
//
// Coverage: the forward's. Any B (launched in slices of 65535 rows), any N
// = gh * gw (ragged tails masked: keys past N add nothing to any gradient,
// queries past N write nothing), gh and gw up to 128, every head dim d that
// is a multiple of 8 up to 128. qs, k and v are read through their batch
// and row strides (bf16: 16-byte aligned rows and starts); do, out, the
// rel terms and the outputs are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_bwd.cuh"

namespace {

constexpr int kRows = 64;                 // a block's own rows
constexpr int kMaxHeadDim = 128;
constexpr int kMaxGridSide = 128;
constexpr int kMaxRowsPerLaunch = 65535;  // gridDim.y

struct Strides {
  int64_t q_b, q_n, k_b, k_n, v_b, v_n;
};

// Row stride, in f32 elements, of a rel-sum row with `cols` columns: odd,
// so 8 consecutive rows start in 8 banks.
__host__ __device__ inline int rel_ld(int cols) { return cols | 1; }

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

struct Args {
  const void *qs, *k, *v;
  Strides st;
  const void *rh, *rw, *dout, *lse, *delta;
  void *dq, *dk, *dv, *drh, *drw;
  int batch, n, d, gh, gw;
};

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
                          (size_t)kRows * (rel_ld(gh) + rel_ld(gw)));
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
  const int ah = rel_ld(gh), aw = rel_ld(gw);
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

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; do, out,
// the rel terms, dq, dk, dv, drh and drw are contiguous in the io dtype,
// lse contiguous f32 (B, N). bf16: `maps` holds the geometries of the
// tensor maps of qs, k, v, do, out, dq, dk and dv as (B, 1, N, d) operands,
// and where gw = 64 of rw (tma.py · heads_map); `stats` an f32 scratch
// (2, B, N rounded up to 64); `delta` is not read. f32: `maps`, `stats` and
// `out` are not read, and delta is contiguous f32 (B, N). Returns a
// cudaError_t value (0 = ok).
extern "C" int tfimm_flash_attention_relpos_bwd(
    const void* qs, const void* k, const void* v, int64_t q_sb, int64_t q_sn,
    int64_t k_sb, int64_t k_sn, int64_t v_sb, int64_t v_sn, const void* rh,
    const void* rw, const void* dout, const void* out, const void* lse,
    const void* delta, void* dq, void* dk, void* dv, void* drh, void* drw,
    const int64_t* maps, void* stats, int batch, int n, int head_dim, int gh,
    int gw, int dtype, void* stream) {
  if (batch <= 0 || n <= 0 || head_dim <= 0 || head_dim % 8 != 0 ||
      head_dim > kMaxHeadDim || gh <= 0 || gw <= 0 || gh > kMaxGridSide ||
      gw > kMaxGridSide || n != gh * gw)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: {
      const Args a{qs,   k,  v,  {q_sb, q_sn, k_sb, k_sn, v_sb, v_sn},
                   rh,   rw, dout, lse, delta, dq, dk, dv, drh, drw,
                   batch, n, head_dim, gh, gw};
      return launch_f32(a, s);
    }
    case 1: {
      const int64_t strides[6] = {q_sb, q_sn, k_sb, k_sn, v_sb, v_sn};
      for (int64_t x : strides)
        if (x % 8 != 0) return (int)cudaErrorMisalignedAddress;
      const void* ptrs[9] = {qs, k, v, dout, out, dq, dk, dv, rw};
      for (const void* p : ptrs)
        if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
          return (int)cudaErrorMisalignedAddress;
      if (maps == nullptr || stats == nullptr)
        return (int)cudaErrorInvalidValue;
      attn_bwd::Args args{};
      args.lse = static_cast<const float*>(lse);
      args.stats = static_cast<float*>(stats);
      args.rh = static_cast<const attn_bwd::bf16*>(rh);
      args.rw = static_cast<const attn_bwd::bf16*>(rw);
      args.drh = static_cast<attn_bwd::bf16*>(drh);
      args.drw = static_cast<attn_bwd::bf16*>(drw);
      args.rows = batch;
      args.n = n;
      args.n_pad = (n + attn_bwd::kTile - 1) / attn_bwd::kTile * attn_bwd::kTile;
      args.heads = 1;
      args.d = head_dim;
      args.gh = gh;
      args.gw = gw;
      const void* bases[9] = {qs, k, v, dout, out, dq, dk, dv, rw};
      if (head_dim > attn_bwd::kTile)
        return attn_bwd::launch<2, attn_bwd::kGeneral>(bases, maps, args, s);
      // gw = 64 (SAM-B's global blocks): 0.66-0.67 ms at (12, 64 x 64, 64)
      // on an H100 80GB HBM3 at 700 W, against 2.95-2.97 for the general
      // bias at the same shape, which stages every query tile's rh and rw
      // rows by hand in (B) (chip_smoke.py phase 17; PERF.md §6).
      if (gw == attn_bwd::kTile)
        return attn_bwd::launch<1, attn_bwd::kGrid64>(bases, maps, args, s);
      return attn_bwd::launch<1, attn_bwd::kGeneral>(bases, maps, args, s);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
