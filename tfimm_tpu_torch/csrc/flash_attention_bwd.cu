// Flash attention, backward.
//
// Replaces: tfimm_tpu/ops/pallas/flash_attention_kernel.py ·
// _flash_backward_call (its dq kernel and its dk/dv kernel). Per row b of
// B = images * heads, with qs, k, v, do (N, d), everything in f32:
//
//     s = qs k^T,  p = exp(s - lse)        (the forward's f32 lse: exact)
//     dv = p^T do,   ds = p * (do v^T - delta),   delta_i = do_i . o_i
//     dqs = ds k,    dk = ds^T qs
//
// qs arrives scaled (autograd chains the scale). No clamp: the softmax is
// exact, so ds needs no mask. Keys at or beyond N add nothing to any
// gradient; query rows at or beyond N contribute nothing and write nothing.
// Operands are (B, H, N, d) views read or written through their image,
// head and token strides, row b of the kernel being (b / heads, b % heads),
// as in flash_attention.cu. Two launches per call, deterministic, no
// atomics: (A) dqs over blocks of 64 query rows, (B) dk and dv over blocks
// of 64 keys.
//
// - bf16 up to d = 128 (the training path), for Hopper: attention_bwd.cuh
//   without the bias (its note has the design). (A) also forms delta from
//   o and do, and writes it with lse * log2(e) into an f32 scratch padded
//   to 64 rows that (B) reads, so delta is not a separate reduction.
// - bf16 above d = 128 (no timed path reaches it): tensor cores through
//   mma.sync m16n8k16, 4 warps each owning 16 rows, 32-row streamed tiles
//   loaded synchronously; each block writes half of the head columns
//   (gridDim.z = 2), recomputing s and dp from the whole d. delta comes
//   from the wrapper.
// - f32: exact f32 FMAs, 256 threads as a 16 x 16 grid, 64-row streamed
//   tiles (32 above d = 128, which keeps shared memory within 227 KB); p
//   and ds pass through shared memory; delta from the wrapper.
//
// What bounds it on an H100: the function needs five N x N x d products,
// 10 * B * N^2 * d operations: 258.2 GFLOP for ViT-B/16 training on 512x512
// images (B = 32 images x 12 heads, N = 1025, d = 64), 0.261 ms at the bf16
// tensor-core peak, while it moves about 405 MB (qs, k, v, o, do and the
// lse read, dqs, dk, dv written; 0.121 ms at 3.35 TB/s): bound by
// operations. The Hopper design does seven products (s and dp in both
// launches), and N = 1025 rounds up to 1088 rows and keys: 0.41 ms at the
// peak. What holds it back: each warpgroup's serial chain (scores, then
// the exponentials, then the product, each waiting for the last) with two
// warpgroups an SM to hide it, at the 168 registers a thread that allows
// (ptxas' report in chip_smoke.py's build log), and the 4096 exponentials
// a tile in each launch at a sixteenth of the FMA rate. On an H100 80GB
// HBM3 at 700 W the bf16 kernel takes 1.17-1.19 ms there, operands out of
// L2 (22% of the bound, 0.72-0.73x SDPA's flash backward; the mma.sync
// design before it 3.65-3.67), and 0.50 ms at SAM-B's (1, 12, 4096, 64),
// 1.01-1.02x SDPA (chip_smoke.py phase 27; PERF.md, row 12).
//
// Shared memory, bf16 (Hopper): (A) 89 KB up to d = 64, 113 KB above; (B)
// 83 KB and 98 KB; mma.sync above d = 128: 101.6 KB at d = 256; f32: (A)
// 148.7 KB and (B) 165.9 KB at d = 128, 205.8 and 214.5 KB at d = 256.
// Above the 48 KB static limit a launch needs the dynamic limit raised, so
// the launcher sets cudaFuncAttributeMaxDynamicSharedMemorySize before
// every launch and returns cudaGetLastError() after each (and the error of
// a tensor map that does not encode).
//
// Coverage: the forward's. Any B (launched in slices of 65535 rows), any
// N, every head dim d that is a multiple of 8 up to 256. bf16 operands
// need 16-byte aligned rows and starts (strides a multiple of 8 elements);
// lse and delta are contiguous f32 (B, N).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_bwd.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                 // a block's own rows
constexpr int kMaxHeadDim = 256;
constexpr int kMaxRowsPerLaunch = 65535;  // gridDim.y

// Strides, in elements, of one (B, H, N, d) operand (d has stride 1).
struct Rows {
  int64_t b, h, n;
};

struct Layout {
  Rows q, k, v, g, dq, dk, dv;
};

// The offset of row b = (b / heads, b % heads) of an operand.
__device__ __forceinline__ int64_t row_base(const Rows& r, int64_t b,
                                            int heads) {
  return (b / heads) * r.b + (b % heads) * r.h;
}

// ---------------------------------------------------------------------------
// bf16 above d = 128: tensor cores (mma.sync)

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

// Both launches: two own (64, DP) tiles and two streamed (32, DP) tiles
// (row stride DP + 8), then (B) the streamed rows' lse and delta.
template <int DP>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (size_t)(2 * kRows + 2 * kCols) * (DP + 8) +
         sizeof(float) * 2 * kCols;
}

// Rows [r0, r0 + ROWS) of one operand into shared memory (row stride
// DP + 8), 16 bytes per load; rows at or beyond n and columns at or beyond
// d become zeros.
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
    *reinterpret_cast<uint4*>(dst + r * (DP + 8) + c) = v;
  }
}

// c[j] = A[r, r + 16) . B[8j, 8j + 8)^T over the (padded) head dim: the
// warp's 16 own rows against the 32 rows of a streamed tile. Element
// c[j][i] sits at own row r + g + 8 * (i / 2), streamed row 8j + 2t + i % 2.
template <int DP>
__device__ __forceinline__ void warp_abt(const bf16* a_s, int r,
                                         const bf16* b_s,
                                         float (&c)[kColTiles][4]) {
  constexpr int LD = DP + 8;
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

// acc += X @ B[:, 0:DH]: X (16 own rows x kCols) given as A fragments, one
// per 16-deep step, times DH columns of the streamed tile B (kCols rows,
// row stride LD). Steps whose 16 streamed rows all lie at or beyond the end
// (live <= 16 m) are skipped.
template <int DH, int LD>
__device__ __forceinline__ void warp_ab(const uint32_t (&x)[kColSteps][4],
                                        const bf16* b_s, int live,
                                        float (&acc)[DH / 8][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int m = 0; m < kColSteps; ++m) {
    if (16 * m >= live) break;
#pragma unroll
    for (int jd = 0; jd < DH / 8; ++jd) {
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

// Rows row and row + 8 of a 16-row accumulator (head columns c0 + [0, DH))
// into out (row stride ld) where they lie below n and the columns below d.
template <int DH>
__device__ __forceinline__ void store_rows(bf16* out, int64_t ld, int row,
                                           int n, int d, int c0,
                                           const float (&acc)[DH / 8][4]) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int jd = 0; jd < DH / 8; ++jd) {
    const int c = c0 + 8 * jd + 2 * t;
    if (c >= d) break;
    if (row < n)
      *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * ld + c) =
          __floats2bfloat162_rn(acc[jd][0], acc[jd][1]);
    if (row + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)(row + 8) * ld + c) =
          __floats2bfloat162_rn(acc[jd][2], acc[jd][3]);
  }
}

// (A): dqs. DP: the head dim rounded up to a multiple of 16; DH: the head
// columns a block writes (DP, or DP / 2 above 128).
template <int DP, int DH>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_rows_bf16_kernel(const bf16* __restrict__ qs,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout, Layout L,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dq, int n, int d, int heads,
                           int b0) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* g_s = q_s + kRows * LD;
  bf16* k_s = g_s + kRows * LD;
  bf16* v_s = k_s + kCols * LD;

  const int q0 = blockIdx.x * kRows;
  const int64_t b = (int64_t)b0 + blockIdx.y;
  const int64_t bn = b * n;
  const int c0 = blockIdx.z * DH;          // this block's first head column
  const bf16* k_g = k + row_base(L.k, b, heads);
  const bf16* v_g = v + row_base(L.v, b, heads);

  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = (threadIdx.x / 32) * 16;  // this warp's first own row
  const bool active = q0 + wr < n;
  const int r_lo = wr + g;

  load_tile<DP, kRows>(qs + row_base(L.q, b, heads), q_s, q0, n, d, L.q.n);
  load_tile<DP, kRows>(dout + row_base(L.g, b, heads), g_s, q0, n, d, L.g.n);

  // lse and delta of rows r_lo and r_lo + 8; rows past n get 0 and 0, so
  // that their ds is exactly 0 (do is 0 there).
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = q0 + r_lo + 8 * e;
    row_lse[e] = row < n ? lse[bn + row] : 0.f;
    row_delta[e] = row < n ? delta[bn + row] : 0.f;
  }

  float acc[DH / 8][4];
#pragma unroll
  for (int jd = 0; jd < DH / 8; ++jd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[jd][i] = 0.f;

  float s[kColTiles][4], dp[kColTiles][4];
  for (int k0 = 0; k0 < n; k0 += kCols) {
    __syncthreads();  // previous tile fully read (and own tiles written)
    load_tile<DP, kCols>(k_g, k_s, k0, n, d, L.k.n);
    load_tile<DP, kCols>(v_g, v_s, k0, n, d, L.v.n);
    __syncthreads();
    if (!active) continue;
    warp_abt<DP>(q_s, wr, k_s, s);
    warp_abt<DP>(g_s, wr, v_s, dp);
    // ds in the layout of s; keys past n get 0.
    uint32_t dsf[kColSteps][4];
#pragma unroll
    for (int j = 0; j < kColTiles; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i / 2;
        ds[i] = k0 + 8 * j + 2 * t + i % 2 < n
                    ? expf(s[j][i] - row_lse[h]) * (dp[j][i] - row_delta[h])
                    : 0.f;
      }
      pack_frag(dsf, j, ds);
    }
    warp_ab<DH, LD>(dsf, k_s + c0, n - k0, acc);
  }
  if (!active) return;

  store_rows<DH>(dq + row_base(L.dq, b, heads), L.dq.n, q0 + r_lo, n, d, c0,
                 acc);
}

// (B): dk and dv.
template <int DP, int DH>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_keys_bf16_kernel(const bf16* __restrict__ qs,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout, Layout L,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int n, int d, int heads, int b0) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kRows * LD;
  bf16* q_s = v_s + kRows * LD;
  bf16* g_s = q_s + kCols * LD;
  float* lse_s = reinterpret_cast<float*>(g_s + kCols * LD);
  float* dl_s = lse_s + kCols;

  const int k0 = blockIdx.x * kRows;
  const int64_t b = (int64_t)b0 + blockIdx.y;
  const int64_t bn = b * n;
  const int c0 = blockIdx.z * DH;          // this block's first head column
  const bf16* q_g = qs + row_base(L.q, b, heads);
  const bf16* g_g = dout + row_base(L.g, b, heads);

  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = (threadIdx.x / 32) * 16;  // this warp's first own key
  const bool active = k0 + wr < n;

  load_tile<DP, kRows>(k + row_base(L.k, b, heads), k_s, k0, n, d, L.k.n);
  load_tile<DP, kRows>(v + row_base(L.v, b, heads), v_s, k0, n, d, L.v.n);

  float dk_acc[DH / 8][4], dv_acc[DH / 8][4];
#pragma unroll
  for (int jd = 0; jd < DH / 8; ++jd)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[jd][i] = dv_acc[jd][i] = 0.f;

  float s[kColTiles][4], dp[kColTiles][4];
  for (int q0 = 0; q0 < n; q0 += kCols) {
    __syncthreads();  // previous tile fully read (and own tiles written)
    load_tile<DP, kCols>(q_g, q_s, q0, n, d, L.q.n);
    load_tile<DP, kCols>(g_g, g_s, q0, n, d, L.g.n);
    for (int i = threadIdx.x; i < kCols; i += kMmaThreads) {
      const bool ok = q0 + i < n;
      lse_s[i] = ok ? lse[bn + q0 + i] : 0.f;
      dl_s[i] = ok ? delta[bn + q0 + i] : 0.f;
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
        p[i] = q0 + qc < n ? expf(s[j][i] - lse_s[qc]) : 0.f;
        ds[i] = p[i] * (dp[j][i] - dl_s[qc]);
      }
      pack_frag(pf, j, p);
      pack_frag(dsf, j, ds);
    }
    warp_ab<DH, LD>(pf, g_s + c0, n - q0, dv_acc);
    warp_ab<DH, LD>(dsf, q_s + c0, n - q0, dk_acc);
  }
  if (!active) return;

  const int row = k0 + wr + g;
  store_rows<DH>(dk + row_base(L.dk, b, heads), L.dk.n, row, n, d, c0, dk_acc);
  store_rows<DH>(dv + row_base(L.dv, b, heads), L.dv.n, row, n, d, c0, dv_acc);
}

struct Args {
  const void *qs, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  Layout L;
  int batch, heads, n, d;
};

dim3 grid_of(const Args& a, int b0, int slices) {
  return dim3((a.n + kRows - 1) / kRows,
              a.batch - b0 < kMaxRowsPerLaunch ? a.batch - b0
                                               : kMaxRowsPerLaunch,
              slices);
}

template <int DP, int DH>
int launch_bf16(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_rows_bf16_kernel<DP, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_keys_bf16_kernel<DP, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < a.batch; b0 += kMaxRowsPerLaunch) {
    const dim3 grid = grid_of(a, b0, DP / DH);
    flash_bwd_rows_bf16_kernel<DP, DH><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const bf16*>(a.qs), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.L,
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<bf16*>(a.dq), a.n, a.d, a.heads, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_keys_bf16_kernel<DP, DH><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const bf16*>(a.qs), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.L,
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.n, a.d,
        a.heads, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Above d = 128 (the Hopper kernels take d up to 128).
int dispatch_mma(const Args& a, cudaStream_t s) {
  switch ((a.d + 15) / 16) {
    case 9: return launch_bf16<144, 72>(a, s);
    case 10: return launch_bf16<160, 80>(a, s);
    case 11: return launch_bf16<176, 88>(a, s);
    case 12: return launch_bf16<192, 96>(a, s);
    case 13: return launch_bf16<208, 104>(a, s);
    case 14: return launch_bf16<224, 112>(a, s);
    case 15: return launch_bf16<240, 120>(a, s);
    case 16: return launch_bf16<256, 128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// f32: FMA

constexpr int kFmaThreads = 256;          // 16 x 16
constexpr int kOwn = kRows / 16;          // own rows per thread

// (A): q, do (own) and k, v (streamed) tiles, row stride d + 1, and the ds
// tile; STR streamed rows per tile.
size_t rows_f32_smem_bytes(int d, int str) {
  return sizeof(float) * ((size_t)2 * (kRows + str) * (d + 1) +
                          (size_t)kRows * (str + 1));
}

// (B): k, v (own), q, do (streamed), the p and ds tiles, lse and delta.
size_t keys_f32_smem_bytes(int d, int str) {
  return sizeof(float) * ((size_t)2 * (kRows + str) * (d + 1) +
                          (size_t)2 * kRows * (str + 1) + 2 * str);
}

// Rows [r0, r0 + ROWS) of one operand into a (ROWS, d + 1) tile; rows at
// or beyond n become zeros.
template <int ROWS>
__device__ __forceinline__ void load_rows_f32(const float* __restrict__ src,
                                              float* dst, int r0, int n, int d,
                                              int64_t row_stride) {
  for (int i = threadIdx.x; i < ROWS * d; i += kFmaThreads) {
    const int r = i / d, c = i % d;
    const int row = r0 + r;
    dst[r * (d + 1) + c] = row < n ? src[(int64_t)row * row_stride + c] : 0.f;
  }
}

// c[i][j] = a row (ty + 16 i) . b row (tx + 16 j), over d.
template <int STR>
__device__ __forceinline__ void fma_abt(const float* a_s, const float* b_s,
                                        int d, float (&c)[kOwn][STR / 16]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, ld = d + 1;
#pragma unroll
  for (int i = 0; i < kOwn; ++i)
#pragma unroll
    for (int j = 0; j < STR / 16; ++j) c[i][j] = 0.f;
  for (int c0 = 0; c0 < d; ++c0) {
    float av[kOwn], bv[STR / 16];
#pragma unroll
    for (int i = 0; i < kOwn; ++i) av[i] = a_s[(ty + 16 * i) * ld + c0];
#pragma unroll
    for (int j = 0; j < STR / 16; ++j) bv[j] = b_s[(tx + 16 * j) * ld + c0];
#pragma unroll
    for (int i = 0; i < kOwn; ++i)
#pragma unroll
      for (int j = 0; j < STR / 16; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
  }
}

// acc[i][c] += sum over the first `live` streamed rows kk of
// x[ty + 16 i][kk] * b[kk][tx + 16 c] (x with row stride STR + 1).
template <int STR, int KD>
__device__ __forceinline__ void fma_ab(const float* x_s, const float* b_s,
                                       int live, int d,
                                       float (&acc)[kOwn][KD]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, ld = d + 1;
  const int kmax = min(STR, live);
  for (int kk = 0; kk < kmax; ++kk) {
    float xv[kOwn];
#pragma unroll
    for (int i = 0; i < kOwn; ++i) xv[i] = x_s[(ty + 16 * i) * (STR + 1) + kk];
#pragma unroll
    for (int c = 0; c < KD; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        const float bv = b_s[kk * ld + col];
#pragma unroll
        for (int i = 0; i < kOwn; ++i) acc[i][c] = fmaf(xv[i], bv, acc[i][c]);
      }
    }
  }
}

template <int KD>
__device__ __forceinline__ void store_rows_f32(float* out, int64_t ld, int r0,
                                               int n, int d,
                                               const float (&acc)[kOwn][KD]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < KD; ++c) {
      const int col = tx + 16 * c;
      if (col < d) out[(int64_t)row * ld + col] = acc[i][c];
    }
  }
}

// STR: streamed rows per tile (64, or 32 above d = 128); KD: head columns
// per thread (8, or 16 above d = 128).
template <int STR, int KD>
__global__ void __launch_bounds__(kFmaThreads)
flash_bwd_rows_f32_kernel(const float* __restrict__ qs,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout, Layout L,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dq, int n, int d, int heads,
                          int b0) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* q_s = smem;                  // kRows x ld
  float* g_s = q_s + kRows * ld;      // kRows x ld
  float* k_s = g_s + kRows * ld;      // STR x ld
  float* v_s = k_s + STR * ld;        // STR x ld
  float* ds_s = v_s + STR * ld;       // kRows x (STR + 1)

  const int q0 = blockIdx.x * kRows;
  const int64_t b = (int64_t)b0 + blockIdx.y;
  const int64_t bn = b * n;
  const float* k_g = k + row_base(L.k, b, heads);
  const float* v_g = v + row_base(L.v, b, heads);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_rows_f32<kRows>(qs + row_base(L.q, b, heads), q_s, q0, n, d, L.q.n);
  load_rows_f32<kRows>(dout + row_base(L.g, b, heads), g_s, q0, n, d, L.g.n);

  float row_lse[kOwn], row_delta[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int row = q0 + ty + 16 * i;
    row_lse[i] = row < n ? lse[bn + row] : 0.f;
    row_delta[i] = row < n ? delta[bn + row] : 0.f;
  }

  float acc[kOwn][KD];
#pragma unroll
  for (int i = 0; i < kOwn; ++i)
#pragma unroll
    for (int c = 0; c < KD; ++c) acc[i][c] = 0.f;

  float s[kOwn][STR / 16], dp[kOwn][STR / 16];
  for (int k0 = 0; k0 < n; k0 += STR) {
    __syncthreads();  // previous tile fully read (and own tiles written)
    load_rows_f32<STR>(k_g, k_s, k0, n, d, L.k.n);
    load_rows_f32<STR>(v_g, v_s, k0, n, d, L.v.n);
    __syncthreads();
    fma_abt<STR>(q_s, k_s, d, s);
    fma_abt<STR>(g_s, v_s, d, dp);
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < STR / 16; ++j) {
        const int key = k0 + tx + 16 * j;
        ds_s[(ty + 16 * i) * (STR + 1) + tx + 16 * j] =
            key < n && row < n
                ? expf(s[i][j] - row_lse[i]) * (dp[i][j] - row_delta[i])
                : 0.f;
      }
    }
    __syncthreads();
    fma_ab<STR, KD>(ds_s, k_s, n - k0, d, acc);
  }

  store_rows_f32<KD>(dq + row_base(L.dq, b, heads), L.dq.n, q0, n, d, acc);
}

template <int STR, int KD>
__global__ void __launch_bounds__(kFmaThreads)
flash_bwd_keys_f32_kernel(const float* __restrict__ qs,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout, Layout L,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int n, int d, int heads, int b0) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* k_s = smem;                  // kRows x ld
  float* v_s = k_s + kRows * ld;      // kRows x ld
  float* q_s = v_s + kRows * ld;      // STR x ld
  float* g_s = q_s + STR * ld;        // STR x ld
  float* p_s = g_s + STR * ld;        // kRows x (STR + 1)
  float* ds_s = p_s + kRows * (STR + 1);
  float* lse_s = ds_s + kRows * (STR + 1);
  float* dl_s = lse_s + STR;

  const int k0 = blockIdx.x * kRows;
  const int64_t b = (int64_t)b0 + blockIdx.y;
  const int64_t bn = b * n;
  const float* q_g = qs + row_base(L.q, b, heads);
  const float* g_g = dout + row_base(L.g, b, heads);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_rows_f32<kRows>(k + row_base(L.k, b, heads), k_s, k0, n, d, L.k.n);
  load_rows_f32<kRows>(v + row_base(L.v, b, heads), v_s, k0, n, d, L.v.n);

  float dk_acc[kOwn][KD], dv_acc[kOwn][KD];
#pragma unroll
  for (int i = 0; i < kOwn; ++i)
#pragma unroll
    for (int c = 0; c < KD; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  float s[kOwn][STR / 16], dp[kOwn][STR / 16];
  for (int q0 = 0; q0 < n; q0 += STR) {
    __syncthreads();  // previous tile fully read (and own tiles written)
    load_rows_f32<STR>(q_g, q_s, q0, n, d, L.q.n);
    load_rows_f32<STR>(g_g, g_s, q0, n, d, L.g.n);
    for (int i = threadIdx.x; i < STR; i += kFmaThreads) {
      const bool ok = q0 + i < n;
      lse_s[i] = ok ? lse[bn + q0 + i] : 0.f;
      dl_s[i] = ok ? delta[bn + q0 + i] : 0.f;
    }
    __syncthreads();
    fma_abt<STR>(k_s, q_s, d, s);     // s^T: own keys x streamed queries
    fma_abt<STR>(v_s, g_s, d, dp);    // dp^T
#pragma unroll
    for (int i = 0; i < kOwn; ++i)
#pragma unroll
      for (int j = 0; j < STR / 16; ++j) {
        const int qc = tx + 16 * j;
        const float p = q0 + qc < n ? expf(s[i][j] - lse_s[qc]) : 0.f;
        p_s[(ty + 16 * i) * (STR + 1) + qc] = p;
        ds_s[(ty + 16 * i) * (STR + 1) + qc] = p * (dp[i][j] - dl_s[qc]);
      }
    __syncthreads();
    fma_ab<STR, KD>(p_s, g_s, n - q0, d, dv_acc);
    fma_ab<STR, KD>(ds_s, q_s, n - q0, d, dk_acc);
  }

  store_rows_f32<KD>(dk + row_base(L.dk, b, heads), L.dk.n, k0, n, d, dk_acc);
  store_rows_f32<KD>(dv + row_base(L.dv, b, heads), L.dv.n, k0, n, d, dv_acc);
}

template <int STR, int KD>
int launch_f32(const Args& a, cudaStream_t stream) {
  const size_t smem_a = rows_f32_smem_bytes(a.d, STR);
  const size_t smem_b = keys_f32_smem_bytes(a.d, STR);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_rows_f32_kernel<STR, KD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_keys_f32_kernel<STR, KD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < a.batch; b0 += kMaxRowsPerLaunch) {
    const dim3 grid = grid_of(a, b0, 1);
    flash_bwd_rows_f32_kernel<STR, KD><<<grid, kFmaThreads, smem_a, stream>>>(
        static_cast<const float*>(a.qs), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.L, static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<float*>(a.dq), a.n,
        a.d, a.heads, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_keys_f32_kernel<STR, KD><<<grid, kFmaThreads, smem_b, stream>>>(
        static_cast<const float*>(a.qs), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.L, static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), a.n, a.d, a.heads, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// qs, k, v, do, out (inputs) and dq, dk, dv (outputs) are (B, H, N, d)
// operands given by their pointers and the 21 strides of `strides`
// (elements; image, head and token strides of qs, k, v, do, dq, dk, dv in
// turn; d has stride 1); lse is contiguous f32 (B * H, N). batch = B * H.
// dtype: 0 = float32, 1 = bfloat16. bf16 up to d = 128 (the Hopper
// kernels): `maps` holds the geometries of the tensor maps of qs, k, v, do,
// out, dq, dk and dv (tma.py · heads_map), `stats` an f32 scratch
// (2, B * H, N rounded up to 64) and `delta` is not read. Otherwise `maps`,
// `stats` and `out` are not read, and delta is contiguous f32 (B * H, N).
// Returns a cudaError_t value (0 = ok).
extern "C" int tfimm_flash_attention_bwd(
    const void* qs, const void* k, const void* v, const void* dout,
    const void* out, const void* lse, const void* delta, void* dq, void* dk,
    void* dv, const int64_t* strides, const int64_t* maps, void* stats,
    int batch, int heads, int n, int head_dim, int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || batch % heads != 0 || n <= 0 ||
      head_dim <= 0 || head_dim % 8 != 0 || head_dim > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  Layout L;
  Rows* rows[7] = {&L.q, &L.k, &L.v, &L.g, &L.dq, &L.dk, &L.dv};
  for (int i = 0; i < 7; ++i)
    *rows[i] = Rows{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Args a{qs, k, v, dout, lse, delta, dq, dk, dv,
               L,  batch, heads, n, head_dim};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return head_dim <= 128 ? launch_f32<64, 8>(a, s)
                             : launch_f32<32, 16>(a, s);
    case 1: {
      const bool tma = head_dim <= attn_bwd::kMaxHeadDim;
      // qs, k, v, do (and out, dq, dk, dv for the tensor maps): 16-byte rows;
      // above d = 128 dq, dk, dv take 4-byte stores.
      for (int i = 0; i < 21; ++i)
        if (strides[i] % (i < 12 || tma ? 8 : 2) != 0)
          return (int)cudaErrorMisalignedAddress;
      const void* ptrs[8] = {qs, k, v, dout, out, dq, dk, dv};
      for (int i = 0; i < 8; ++i)
        if (reinterpret_cast<uintptr_t>(ptrs[i]) % (i < 4 || tma ? 16 : 4) != 0)
          return (int)cudaErrorMisalignedAddress;
      if (!tma) return dispatch_mma(a, s);
      if (maps == nullptr || stats == nullptr || out == nullptr)
        return (int)cudaErrorInvalidValue;
      attn_bwd::Args args{};
      args.lse = static_cast<const float*>(lse);
      args.stats = static_cast<float*>(stats);
      args.rows = batch;
      args.n = n;
      args.n_pad = (n + attn_bwd::kTile - 1) / attn_bwd::kTile * attn_bwd::kTile;
      args.heads = heads;
      args.d = head_dim;
      const void* bases[8] = {qs, k, v, dout, out, dq, dk, dv};
      if (head_dim <= attn_bwd::kTile)
        return attn_bwd::launch<1, attn_bwd::kNoBias>(bases, maps, args, s);
      return attn_bwd::launch<2, attn_bwd::kNoBias>(bases, maps, args, s);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
