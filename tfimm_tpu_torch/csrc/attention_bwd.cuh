// The bf16 attention backward for Hopper, shared by flash_attention_bwd.cu
// (no bias) and flash_attention_relpos_bwd.cu (the decomposed rel-pos bias
// and its two sums), up to d = 128. Per row b of the kernel (b / heads,
// b % heads of a (B, H, N, d) view; the rel-pos operands are H = 1), with
// qs, k, v, do, o (N, d) and the forward's f32 lse:
//
//     s  = qs k^T (+ rh[i, c / gw] + rw[i, c % gw])
//     p  = exp(s - lse)                         (exact: no clamp, no mask)
//     dv = p^T do,  ds = p * (do v^T - delta),  delta_i = do_i . o_i
//     dqs = ds k,   dk = ds^T qs
//     drh[i, h] = sum_{c / gw = h} ds[i, c],  drw[i, w] = sum_{c % gw = w} ds[i, c]
//
// Two launches a call, deterministic, no atomics: seven N x N x d products
// (three in A, four in B) where the function needs five.
//
// - (A) rows: a block owns 64 query rows. It loads qs, do and o once and
//   forms delta = rowsum(do * o) and lse * log2(e) for its rows, which it
//   writes into an f32 scratch (2, rows, N rounded up to 64): lse * log2(e)
//   = +inf and delta = 0 on the padded rows, so that (B) gives them p = 0
//   without a mask. It streams K and V; per tile S = qs k^T and dP = do v^T
//   (one wgmma group, both operands K-major), p = 2^(S log2(e) + bias
//   log2(e) - lse log2(e)) (one FMA and one exponential), ds = p (dP -
//   delta) in registers, dqs += bf16(ds) k (A from registers, k as an
//   MN-major B). The rel-pos sums take ds from the same registers while
//   dqs's product is in flight.
// - (B) keys: a block owns 64 keys. It loads k and v once and streams the
//   qs and do tiles with their scratch statistics (two 256-byte bulk
//   copies a stage); per tile S^T = k qs^T and dP^T = v do^T (one group),
//   p^T and ds^T, then dv += bf16(p^T) do and dk += bf16(ds^T) qs.
//
// One consumer warpgroup and one producer warp a block (160 threads); the
// producer TMA-loads the own tiles once and streams the other operand
// through a ring of 64-row stages (4 up to d = 64, 3 for (B) with the
// rel-pos boxes, 2 above), each signalled on a "full" mbarrier by TMA's
// transaction count and released on an "empty" one by the consumer's four
// warps. Two blocks an SM up to d = 64 (at most 168 registers a thread),
// one above (two 64 x 128 f32 accumulators in (B)). Operands are 4-D TMA
// tensors (d, N, H, B) through their own strides (tma.py · heads_map): rows
// past N and columns past d arrive as zeros, so every product in which a
// padded row or key takes part has a zero factor (k and v for dqs, qs and
// do for dk and dv), with no branch. Only the ragged key tile of (A)
// selects ds = 0 past N, where lse of a row far below zero would make p
// overflow on a zero score, and where the rel-pos sums must not see them.
// The gradients go out from the own tiles by TMA stores, which clip rows
// past N and columns past d.
//
// The bias (template parameter BIAS):
// - kGrid64 (gw = 64, d <= 64; SAM-B's global blocks at 1024 x 1024): a
//   64-key tile is one key-grid row h = t, its column c is w = c. (A) keeps
//   rw of its two rows as bf16 pairs in registers and reads rh[i, t] from
//   its staged rows; drw is a 64 x 64 f32 accumulator in the layout of S
//   (+= ds every tile) and drh[:, t] the tile's row sum of ds over the 4
//   lanes of a row, kept in a bf16 tile. (B)'s keys are one key-grid row
//   h = k0 / 64: the bias of query i and key c is rh[i, h] + rw[i, c],
//   from the column h of rh (staged once for all N queries) and a TMA box
//   of rw a stage (64 queries x 64).
// - kGeneral (any gh, gw up to 128): (A) stages its rows' rel terms once
//   and steps each column's (c / gw, c % gw) from tile to tile, no
//   division in the loop; the sums go into f32 rows in shared memory, one
//   key-grid row of a tile at a time (within one, every key has its own
//   column, so no two lanes add into one entry; drh takes the row's sum
//   over the 4 lanes of a row): a fixed order. (B) stages the streamed
//   queries' rel terms, all of them once where they fit in 32 KB (the
//   windowed blocks), else a tile at a time (double-buffered, loaded while
//   the previous tile's product runs), and reads its keys' (c / gw,
//   c % gw), fixed for the block. At gw = 64 it is 4.4x slower than
//   kGrid64 (flash_attention_relpos_bwd.cu's launcher).
//
// What bounds it on an H100 and what holds it back: see the notes of the
// two .cu files for each function's bound (operations: the five N x N x d
// products; this design does seven, and pads N to whole 64-row tiles).
// Each warpgroup's chain is serial (scores, then the exponentials, then
// the product, each waiting for the last) and two warpgroups an SM hide
// it, at 168 registers a thread. (A) takes 126 registers without the bias
// and 164-167 with it; (B), which holds four 64 x 64 f32 accumulators (dk,
// dv, S^T, dP^T) and two bf16 operands, 158-168: it forms p^T first, in
// S^T's registers, then ds^T, where forming both in one pass held 168 and
// spilled 16-80 bytes (ptxas' report in chip_smoke.py's build log). Tried
// in development builds on the card (H100 80GB HBM3, 700 W), not kept:
// (B) at one block an SM (no spill) 7-25% slower; S and dP zeroed before
// each group 3-6% slower; a write-only first wgmma step, two product
// groups in (B) (dv's issued before ds^T is formed), and the next tile's
// scores issued before the product's wait: no change. Fences on S and dP
// before the group keep (A) with the bias spill-free, and cost the kernel
// without the bias 1-5%, so only the bias variants take them. Staging the
// rel terms row by row (a load round trip per 4 rows) made the windowed
// blocks 2x slower than staging them flat, 8 loads in flight.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace attn_bwd {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;                 // rows, keys and columns of a tile
constexpr int kTileBytes = kTile * kTile * 2;
constexpr int kThreads = 128 + 32;        // a consumer warpgroup, a producer warp
constexpr int kStatBytes = kTile * 4;     // 64 f32 statistics
constexpr int kMaxRowsPerLaunch = 65535;  // gridDim.y
constexpr int kMaxHeadDim = 2 * kTile;
constexpr float kLog2e = 1.4426950408889634f;

enum Bias : int { kNoBias = 0, kGrid64 = 1, kGeneral = 2 };


// The tensor maps of a call, in the order of the geometries tma.py packs:
// qs, k, v, do, o, dqs, dk, dv, and rw (kGrid64 only).
struct Maps {
  CUtensorMap q, k, v, g, o, dq, dk, dv, rw;
};
constexpr int kMaps = 9;

struct Args {
  const float* lse;   // (rows, n), the forward's
  float* stats;       // (2, rows, n_pad): lse * log2(e), then delta
  const bf16* rh;     // (rows, n, gh), rel-pos only
  const bf16* rw;     // (rows, n, gw)
  bf16* drh;
  bf16* drw;
  int rows, n, n_pad, heads, b0, d, gh, gw;
};

// Row stride, in bf16 elements, of staged rel terms: 4 (mod 8) words, so
// that 8 rows start 4 banks apart.
__host__ __device__ inline int rel_ld(int cols) {
  return cols + ((8 - cols) % 16 + 16) % 16;
}

// Row stride, in f32 elements, of the rel sums: odd.
__host__ __device__ inline int sum_ld(int cols) { return cols | 1; }

// (B), kGeneral: whether the rel terms of all of a row's queries are staged
// once (the windowed blocks), else a tile at a time. Once: 0.2197-0.2215 ms
// out of L2 at (300, 14 x 14, 64) on an H100 80GB HBM3 at 700 W, a tile at
// a time 0.2252-0.2261 (chip_smoke.py phase 17; PERF.md §6).
constexpr int kWholeRelBytes = 32 * 1024;
__host__ __device__ inline bool rel_whole(int n_pad, int gh, int gw) {
  return n_pad * (rel_ld(gh) + rel_ld(gw)) * 2 <= kWholeRelBytes;
}

// ---------------------------------------------------------------------------
// Shared memory

// (A): own qs, do, o; the ring's k and v.
template <int DC>
struct TilesA {
  static constexpr int kStages = DC == 1 ? 4 : 2;
  static constexpr int kG = DC * kTileBytes;
  static constexpr int kO = 2 * DC * kTileBytes;
  static constexpr int kRing0 = 3 * DC * kTileBytes;
  static constexpr int kRing1 = kRing0 + kStages * DC * kTileBytes;
  static constexpr int kBars = kRing1 + kStages * DC * kTileBytes;
  static constexpr int kExtra = kBars + 8 * (1 + 2 * kStages);
  // The rel-pos extras: the staged rh and rw rows (bf16; kGrid64's drh
  // takes rh's place), then kGeneral's f32 sums.
  static int bytes(int bias, int gh, int gw) {
    int extra = 0;
    if (bias != kNoBias) extra = kTile * (rel_ld(gh) + rel_ld(gw)) * 2;
    if (bias == kGeneral) extra += kTile * (sum_ld(gh) + sum_ld(gw)) * 4;
    return kExtra + extra + 1024;   // 1024 bytes of slack for the alignment
  }
};

// (B): own k, v; the ring's qs, do (and kGrid64's rw boxes) and statistics.
template <int DC, int BIAS>
struct TilesB {
  static constexpr int kStages = DC == 2 ? 2 : (BIAS == kGrid64 ? 3 : 4);
  static constexpr int kRing0 = 2 * DC * kTileBytes;
  static constexpr int kRing1 = kRing0 + kStages * DC * kTileBytes;
  static constexpr int kRing2 = kRing1 + kStages * DC * kTileBytes;
  static constexpr int kStats =
      kRing2 + (BIAS == kGrid64 ? kStages * kTileBytes : 0);
  static constexpr int kBars = kStats + kStages * 2 * kStatBytes;
  static constexpr int kExtra = kBars + 8 * (1 + 2 * kStages);
  // kGrid64: rh's column of the block's key-grid row for every query;
  // kGeneral: the rel terms of every query, or two stages of a tile's.
  static int bytes(int gh, int gw, int n_pad) {
    int extra = 0;
    if (BIAS == kGrid64) extra = n_pad * 2;
    if (BIAS == kGeneral)
      extra = (rel_whole(n_pad, gh, gw) ? n_pad : 2 * kTile) *
              (rel_ld(gh) + rel_ld(gw)) * 2;
    return kExtra + extra + 1024;
  }
};

// The barriers of a block and the ring's handshakes: own_full (the own
// tiles), full[stage] (completed by TMA's byte count) and empty[stage]
// (one arrival from each consumer warp).
template <int STAGES>
struct Ring {
  uint64_t* own_full;
  uint64_t* full;
  uint64_t* empty;

  __device__ explicit Ring(uint8_t* bars) {
    own_full = reinterpret_cast<uint64_t*>(bars);
    full = own_full + 1;
    empty = full + STAGES;
    if (threadIdx.x == 0) {
      hopper::mbar_init(own_full, 1);
      for (int s = 0; s < STAGES; ++s) {
        hopper::mbar_init(&full[s], 1);
        hopper::mbar_init(&empty[s], 4);
      }
      hopper::fence_barrier_init();
    }
    __syncthreads();
  }
  // Producer: wait until tile t's stage is free and announce `bytes` on
  // its full barrier.
  __device__ void produce(int t, uint32_t bytes) const {
    const int st = t % STAGES;
    if (t >= STAGES) hopper::mbar_wait(&empty[st], ((t / STAGES) & 1) ^ 1);
    hopper::mbar_expect_tx(&full[st], bytes);
  }
  __device__ uint64_t* bar(int t) const { return &full[t % STAGES]; }
  __device__ void consume(int t) const {
    hopper::mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
  }
  __device__ void release(int t) const {
    if (threadIdx.x % 32 == 0) hopper::mbar_arrive(&empty[t % STAGES]);
  }
};

// ---------------------------------------------------------------------------
// Products and small helpers

// acc = A B^T over the head dim: A a 64 x d tile, B a 64 x d tile, both
// K-major, as part of the caller's wgmma group. The first step overwrites.
template <int DC>
__device__ __forceinline__ void product_abt(float (&acc)[32], const uint8_t* a,
                                            const uint8_t* b, int nb_steps) {
#pragma unroll
  for (int ks = 0; ks < 4 * DC; ++ks) {
    if (ks < nb_steps) {
      const int dc = ks / 4, kk = ks % 4;
      hopper::wgmma_m64n64k16_ss<0>(
          acc, hopper::sw128_desc(a + dc * kTileBytes) + 2 * kk,
          hopper::sw128_desc(b + dc * kTileBytes) + 2 * kk, ks > 0);
    }
  }
}

// acc[dc] += X B over 64 streamed rows: X (64 x 64 bf16) from registers in
// the A layout, B a 64 x d tile read MN-major (16 rows a k16 step).
template <int DC>
__device__ __forceinline__ void product_xb(float (&acc)[DC][32],
                                           uint32_t (&x)[16],
                                           const uint8_t* b) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int dc = 0; dc < DC; ++dc)
      hopper::wgmma_m64n64k16_rs<1>(
          acc[dc], &x[4 * m], hopper::sw128_desc(b + dc * kTileBytes) + 128 * m,
          1);
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// Sum over the 4 lanes that hold one row of an accumulator.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The A register of accumulator elements (4 j + 2 hi, + 1): column blocks
// 2 m and 2 m + 1 are the registers of k16 step m.
__device__ __forceinline__ int a_reg(int j, int hi) {
  return (j / 2) * 4 + (j % 2) * 2 + hi;
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ float bf16_at(const bf16* p, int i) {
  return __bfloat162float(p[i]);
}

// acc of the warpgroup into its own swizzled tile(s), then one thread
// stores them through the 4-D map at (64 dc, r0, h, img).
template <int DC>
__device__ __forceinline__ void store_tiles(const float (&acc)[DC][32],
                                            uint8_t* tile,
                                            const CUtensorMap* map, int r0,
                                            int h, int img) {
  const int lane = threadIdx.x % 32;
  const int row = (threadIdx.x / 32) * 16 + lane / 4, t4 = lane % 4;
#pragma unroll
  for (int dc = 0; dc < DC; ++dc) {
    uint8_t* out = tile + dc * kTileBytes;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int j2 = 4 * j + t4;
      *reinterpret_cast<uint32_t*>(out + hopper::sw128_offset(row, j2)) =
          hopper::pack_bf16(acc[dc][4 * j], acc[dc][4 * j + 1]);
      *reinterpret_cast<uint32_t*>(out + hopper::sw128_offset(row + 8, j2)) =
          hopper::pack_bf16(acc[dc][4 * j + 2], acc[dc][4 * j + 3]);
    }
  }
  hopper::fence_proxy_async();
  hopper::named_barrier(1, 128);
  if (threadIdx.x == 0) {
    for (int dc = 0; dc < DC; ++dc)
      hopper::tma_store_4d(map, tile + dc * kTileBytes, kTile * dc, r0, h, img);
    hopper::tma_store_commit_and_wait();
  }
}

// Rows [0, rows_total) of `cols` rel terms at src (contiguous rows) into
// dst (row stride ld) by the consumer's 128 threads, zeros from row `rows`
// on: element tid + 128 u of the flat span, its row and column stepped
// without a division, 8 loads in flight a thread before their stores.
__device__ __forceinline__ void stage_rows(const bf16* __restrict__ src,
                                           bf16* dst, int rows, int rows_total,
                                           int cols, int ld) {
  constexpr int kBatch = 8;
  const bf16 zero_bf16 = __float2bfloat16(0.f);
  const int total = rows_total * cols, live = rows * cols;
  const int tid = threadIdx.x % 128;
  int r = tid / cols, c = tid - r * cols;
  const int dr = 128 / cols, dc = 128 - dr * cols;
  for (int base = tid; base < total; base += 128 * kBatch) {
    bf16 v[kBatch];
    int at[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + 128 * u;
      at[u] = r * ld + c;
      v[u] = i < live ? src[i] : zero_bf16;
      r += dr;
      c += dc;
      if (c >= cols) {
        c -= cols;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (base + 128 * u < total) dst[at[u]] = v[u];
  }
}

// The f32 rel sums of rows [0, 64) (row stride ld) as bf16 into the rows
// r0... of dst (rows of `cols`) that lie below n.
__device__ __forceinline__ void store_sums(bf16* __restrict__ dst,
                                           const float* src, int r0, int n,
                                           int cols, int ld) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kTile && r0 + r < n; r += 4)
    for (int c = lane; c < cols; c += 32)
      dst[(int64_t)(r0 + r) * cols + c] = __float2bfloat16(src[r * ld + c]);
}

// ---------------------------------------------------------------------------
// (A): dqs (and drh, drw); the statistics for (B). Two blocks an SM up to
// d = 64 (168 registers a thread), one above, where (B)'s two 64 x 128 f32
// accumulators need more.

template <int DC, int BIAS>
__global__ void __launch_bounds__(kThreads, DC == 1 ? 2 : 1)
attn_bwd_rows_kernel(const __grid_constant__ Maps maps, const Args a) {
  using L = TilesA<DC>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  const Ring<kStages> ring(smem + L::kBars);
  uint8_t* q_s = smem;
  uint8_t* g_s = smem + L::kG;
  uint8_t* o_s = smem + L::kO;
  uint8_t* k_s = smem + L::kRing0;
  uint8_t* v_s = smem + L::kRing1;
  auto slot = [&](uint8_t* base, int t) {
    return base + (t % kStages) * DC * kTileBytes;
  };

  const int n = a.n;
  const int q0 = blockIdx.x * kTile;
  const int b = a.b0 + blockIdx.y;
  const int img = b / a.heads, h = b % a.heads;
  const int nb_tiles = a.n_pad / kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == 4) {
    // Producer: qs, do and o, then K and V of every key tile.
    if (lane == 0) {
      hopper::mbar_expect_tx(ring.own_full, 3 * DC * kTileBytes);
      for (int dc = 0; dc < DC; ++dc) {
        hopper::tma_load_4d(q_s + dc * kTileBytes, &maps.q, ring.own_full,
                            kTile * dc, q0, h, img);
        hopper::tma_load_4d(g_s + dc * kTileBytes, &maps.g, ring.own_full,
                            kTile * dc, q0, h, img);
        hopper::tma_load_4d(o_s + dc * kTileBytes, &maps.o, ring.own_full,
                            kTile * dc, q0, h, img);
      }
      for (int t = 0; t < nb_tiles; ++t) {
        ring.produce(t, 2 * DC * kTileBytes);
        for (int dc = 0; dc < DC; ++dc) {
          hopper::tma_load_4d(slot(k_s, t) + dc * kTileBytes, &maps.k,
                              ring.bar(t), kTile * dc, kTile * t, h, img);
          hopper::tma_load_4d(slot(v_s, t) + dc * kTileBytes, &maps.v,
                              ring.bar(t), kTile * dc, kTile * t, h, img);
        }
      }
    }
    return;
  }

  const int row = warp * 16 + lane / 4;   // and row + 8
  const int t4 = lane % 4;
  const int r_lo = q0 + row, r_hi = r_lo + 8;
  const int64_t bn = (int64_t)b * n;
  const int nb_steps = (a.d + 15) / 16;
  const float inf = __int_as_float(0x7f800000);
  const float l2_lo = r_lo < n ? a.lse[bn + r_lo] * kLog2e : inf;
  const float l2_hi = r_hi < n ? a.lse[bn + r_hi] * kLog2e : inf;

  // The rel-pos state: the staged rel terms of the block's rows, the sums.
  const int gh = a.gh, gw = a.gw;
  const int ldh = rel_ld(gh), ldw = rel_ld(gw);
  const int sh = sum_ld(gh), sw = sum_ld(gw);
  bf16* rh_s = reinterpret_cast<bf16*>(smem + L::kExtra);   // kGrid64: and drh
  bf16* rw_s = rh_s + kTile * ldh;
  float* dh_s = reinterpret_cast<float*>(rw_s + kTile * ldw);
  float* dw_s = dh_s + kTile * sh;
  constexpr int kDrw = BIAS == kGrid64 ? 32 : 1;
  float drw[kDrw];
  // kGeneral: (c / gw) << 16 | c % gw of the tile's key 0, stepped by 64
  // keys a tile; this thread's column 2 t4 and the steps of 1 and 7
  // columns in the same form (one wrap each: every step's column part is
  // below gw).
  uint32_t tile_idx = 0, col0 = 0, step1 = 0, step7 = 0, step64 = 0;
  const uint32_t wrap = (1u << 16) - (uint32_t)gw;
  auto packed = [&](int c) {
    return ((uint32_t)(c / gw) << 16) | (uint32_t)(c % gw);
  };
  auto advance = [&](uint32_t idx, uint32_t by) {
    idx += by;
    return (idx & 0xFFFFu) >= (uint32_t)gw ? idx + wrap : idx;
  };
  if constexpr (BIAS != kNoBias) {
    const int rows = min(kTile, n - q0);
    stage_rows(a.rh + (bn + q0) * gh, rh_s, rows, kTile, gh, ldh);
    stage_rows(a.rw + (bn + q0) * gw, rw_s, rows, kTile, gw, ldw);
    if constexpr (BIAS == kGrid64) {
      zero(drw);
    } else {
      for (int i = threadIdx.x; i < kTile * (sh + sw); i += 128)
        dh_s[i] = 0.f;                  // dh_s and dw_s are adjacent
      col0 = packed(2 * t4);
      step1 = packed(1);
      step7 = packed(7);
      step64 = packed(kTile);
    }
    hopper::named_barrier(1, 128);
  }
  const bf16* rh_lo = rh_s + row * ldh;
  const bf16* rh_hi = rh_lo + 8 * ldh;
  const bf16* rw_lo = rw_s + row * ldw;
  const bf16* rw_hi = rw_lo + 8 * ldw;

  // delta = rowsum(do * o) from the own tiles at this thread's accumulator
  // positions; lse * log2(e) and delta into the scratch for (B), +inf and 0
  // on rows past n (do and o are zeros there).
  hopper::mbar_wait(ring.own_full, 0);
  float dl_lo = 0.f, dl_hi = 0.f;
#pragma unroll
  for (int dc = 0; dc < DC; ++dc) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int j2 = 4 * j + t4;
      const uint32_t off_lo = dc * kTileBytes + hopper::sw128_offset(row, j2);
      const uint32_t off_hi = dc * kTileBytes + hopper::sw128_offset(row + 8, j2);
      const float2 g_lo = unpack_bf16(*reinterpret_cast<const uint32_t*>(g_s + off_lo));
      const float2 o_lo = unpack_bf16(*reinterpret_cast<const uint32_t*>(o_s + off_lo));
      const float2 g_hi = unpack_bf16(*reinterpret_cast<const uint32_t*>(g_s + off_hi));
      const float2 o_hi = unpack_bf16(*reinterpret_cast<const uint32_t*>(o_s + off_hi));
      dl_lo += g_lo.x * o_lo.x + g_lo.y * o_lo.y;
      dl_hi += g_hi.x * o_hi.x + g_hi.y * o_hi.y;
    }
  }
  dl_lo = quad_sum(dl_lo);
  dl_hi = quad_sum(dl_hi);
  if (t4 == 0) {
    float* lse2 = a.stats + (int64_t)b * a.n_pad;
    float* delta = lse2 + (int64_t)a.rows * a.n_pad;
    lse2[r_lo] = l2_lo;
    lse2[r_hi] = l2_hi;
    delta[r_lo] = dl_lo;
    delta[r_hi] = dl_hi;
  }

  // S and dP of a key tile, the dqs accumulator, ds as A registers.
  float s[32], dp[32], acc[DC][32];
  uint32_t x[16];
#pragma unroll
  for (int dc = 0; dc < DC; ++dc) zero(acc[dc]);
  auto fence_scores = [&] {
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
  };
  auto fence_product = [&] {
    hopper::fence_regs(x);
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) hopper::fence_regs(acc[dc]);
  };
  auto issue_scores = [&](int t) {
    ring.consume(t);
    // With the bias, fencing S and dP before the group keeps (A) within
    // 168 registers (no spill); without, the kernel is faster unfenced.
    if constexpr (BIAS != kNoBias) {
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
    }
    hopper::wgmma_fence();
    product_abt<DC>(s, q_s, slot(k_s, t), nb_steps);
    product_abt<DC>(dp, g_s, slot(v_s, t), nb_steps);
    hopper::wgmma_commit();
  };
  auto issue_product = [&](int t) {
    hopper::fence_regs(x);
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) hopper::fence_regs(acc[dc]);
    hopper::wgmma_fence();
    product_xb<DC>(acc, x, slot(k_s, t));
    hopper::wgmma_commit();
  };

  // ds of tile t into s (f32, for the sums) and x (bf16, for dqs); keys at
  // or beyond n of the ragged tile get ds = 0.
  auto form = [&](int t) {
    const bool ragged = kTile * (t + 1) > n;
    uint32_t idx = BIAS == kGeneral ? advance(tile_idx, col0) : 0u;
    float h_lo = 0.f, h_hi = 0.f;
    if constexpr (BIAS == kGrid64) {
      h_lo = bf16_at(rh_lo, t);
      h_hi = bf16_at(rh_hi, t);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float bias[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (BIAS == kGrid64) {
        const float2 wl = unpack_bf16(
            *reinterpret_cast<const uint32_t*>(rw_lo + 8 * j + 2 * t4));
        const float2 wh = unpack_bf16(
            *reinterpret_cast<const uint32_t*>(rw_hi + 8 * j + 2 * t4));
        bias[0] = h_lo + wl.x;
        bias[1] = h_lo + wl.y;
        bias[2] = h_hi + wh.x;
        bias[3] = h_hi + wh.y;
      } else if constexpr (BIAS == kGeneral) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // Past n the key-grid row may pass gh: clamped (ds is 0 there).
          const int kh = min((int)(idx >> 16), gh - 1);
          const int kw = (int)(idx & 0xFFFFu);
          bias[e] = bf16_at(rh_lo, kh) + bf16_at(rw_lo, kw);
          bias[2 + e] = bf16_at(rh_hi, kh) + bf16_at(rw_hi, kw);
          idx = advance(idx, e == 0 ? step1 : step7);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float sc = BIAS == kNoBias ? s[4 * j + i] : s[4 * j + i] + bias[i];
        const float p = hopper::exp2_approx(
            fmaf(sc, kLog2e, -(i < 2 ? l2_lo : l2_hi)));
        float ds = p * (dp[4 * j + i] - (i < 2 ? dl_lo : dl_hi));
        if (ragged && kTile * t + 8 * j + 2 * t4 + i % 2 >= n) ds = 0.f;
        s[4 * j + i] = ds;
      }
      x[a_reg(j, 0)] = hopper::pack_bf16(s[4 * j], s[4 * j + 1]);
      x[a_reg(j, 1)] = hopper::pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
  };

  // The rel sums of tile t from ds in s, while dqs's product runs.
  auto sums = [&](int t) {
    if constexpr (BIAS == kGrid64) {
      float hs_lo = 0.f, hs_hi = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          drw[4 * j + e] += s[4 * j + e];
          drw[4 * j + 2 + e] += s[4 * j + 2 + e];
          hs_lo += s[4 * j + e];
          hs_hi += s[4 * j + 2 + e];
        }
      }
      hs_lo = quad_sum(hs_lo);
      hs_hi = quad_sum(hs_hi);
      // drh[:, t] takes the place of rh[:, t], which form(t) read: the
      // shuffles above ordered the quad's reads before this write.
      if (t4 == 0) {
        rh_s[row * ldh + t] = __float2bfloat16(hs_lo);
        rh_s[(row + 8) * ldh + t] = __float2bfloat16(hs_hi);
      }
    } else if constexpr (BIAS == kGeneral) {
      // One key-grid row kh0 + w of the tile at a time: its columns are
      // [lo, lo + gw) with lo = w gw - kw0, and column c is key-grid column
      // c - lo. The rows the live keys span (keys past n lie beyond them).
      const int kh0 = (int)(tile_idx >> 16), kw0 = (int)(tile_idx & 0xFFFFu);
      const int live = min(kTile, n - kTile * t);
      for (int w = 0, lo = -kw0; lo < live; ++w, lo += gw) {
        float hs_lo = 0.f, hs_hi = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * t4 + e;
            if (c >= lo && c < lo + gw) {
              dw_s[row * sw + c - lo] += s[4 * j + e];
              dw_s[(row + 8) * sw + c - lo] += s[4 * j + 2 + e];
              hs_lo += s[4 * j + e];
              hs_hi += s[4 * j + 2 + e];
            }
          }
        }
        hs_lo = quad_sum(hs_lo);
        hs_hi = quad_sum(hs_hi);
        if (t4 == 0) {
          dh_s[row * sh + kh0 + w] += hs_lo;
          dh_s[(row + 8) * sh + kh0 + w] += hs_hi;
        }
        __syncwarp();   // this key-grid row's adds land before the next's
      }
      tile_idx = advance(tile_idx, step64);
    }
  };

  issue_scores(0);
  for (int t = 0; t < nb_tiles; ++t) {
    hopper::wgmma_wait<0>();
    fence_scores();
    form(t);
    issue_product(t);
    sums(t);
    hopper::wgmma_wait<0>();
    fence_product();
    ring.release(t);
    if (t + 1 < nb_tiles) issue_scores(t + 1);
  }

  // The qs tile is free once every warp is past its last product.
  hopper::named_barrier(1, 128);
  store_tiles<DC>(acc, q_s, &maps.dq, q0, h, img);
  if constexpr (BIAS == kGrid64) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t4;
      if (r_lo < n)
        *reinterpret_cast<uint32_t*>(a.drw + (bn + r_lo) * kTile + c) =
            hopper::pack_bf16(drw[4 * j], drw[4 * j + 1]);
      if (r_hi < n)
        *reinterpret_cast<uint32_t*>(a.drw + (bn + r_hi) * kTile + c) =
            hopper::pack_bf16(drw[4 * j + 2], drw[4 * j + 3]);
    }
    // drh's tile, in rh's place (store_tiles' barriers ordered its writes).
    for (int r = warp; r < kTile && q0 + r < n; r += 4)
      for (int c = lane; c < gh; c += 32)
        a.drh[(bn + q0 + r) * gh + c] = rh_s[r * ldh + c];
  } else if constexpr (BIAS == kGeneral) {
    store_sums(a.drh + bn * gh, dh_s, q0, n, gh, sh);
    store_sums(a.drw + bn * gw, dw_s, q0, n, gw, sw);
  }
}

// ---------------------------------------------------------------------------
// (B): dk and dv, from (A)'s statistics.

template <int DC, int BIAS>
__global__ void __launch_bounds__(kThreads, DC == 1 ? 2 : 1)
attn_bwd_keys_kernel(const __grid_constant__ Maps maps, const Args a) {
  using L = TilesB<DC, BIAS>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  const Ring<kStages> ring(smem + L::kBars);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + DC * kTileBytes;
  uint8_t* q_s = smem + L::kRing0;
  uint8_t* g_s = smem + L::kRing1;
  uint8_t* rwt_s = smem + L::kRing2;   // kGrid64
  float* stats_s = reinterpret_cast<float*>(smem + L::kStats);
  auto slot = [&](uint8_t* base, int t) {
    return base + (t % kStages) * DC * kTileBytes;
  };

  const int n = a.n;
  const int k0 = blockIdx.x * kTile;
  const int b = a.b0 + blockIdx.y;
  const int img = b / a.heads, h = b % a.heads;
  const int nb_tiles = a.n_pad / kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t bn = (int64_t)b * n;

  if (warp == 4) {
    // Producer: k and v, then qs, do, their statistics (and the rw box) of
    // every query tile.
    if (lane == 0) {
      hopper::mbar_expect_tx(ring.own_full, 2 * DC * kTileBytes);
      for (int dc = 0; dc < DC; ++dc) {
        hopper::tma_load_4d(k_s + dc * kTileBytes, &maps.k, ring.own_full,
                            kTile * dc, k0, h, img);
        hopper::tma_load_4d(v_s + dc * kTileBytes, &maps.v, ring.own_full,
                            kTile * dc, k0, h, img);
      }
      const float* lse2 = a.stats + (int64_t)b * a.n_pad;
      const float* delta = lse2 + (int64_t)a.rows * a.n_pad;
      constexpr uint32_t kBytes = 2 * DC * kTileBytes + 2 * kStatBytes +
                                  (BIAS == kGrid64 ? kTileBytes : 0);
      for (int t = 0; t < nb_tiles; ++t) {
        ring.produce(t, kBytes);
        for (int dc = 0; dc < DC; ++dc) {
          hopper::tma_load_4d(slot(q_s, t) + dc * kTileBytes, &maps.q,
                              ring.bar(t), kTile * dc, kTile * t, h, img);
          hopper::tma_load_4d(slot(g_s, t) + dc * kTileBytes, &maps.g,
                              ring.bar(t), kTile * dc, kTile * t, h, img);
        }
        float* st = stats_s + (t % kStages) * 2 * kTile;
        hopper::bulk_load(st, lse2 + kTile * t, kStatBytes, ring.bar(t));
        hopper::bulk_load(st + kTile, delta + kTile * t, kStatBytes,
                          ring.bar(t));
        if constexpr (BIAS == kGrid64)
          hopper::tma_load_4d(rwt_s + (t % kStages) * kTileBytes, &maps.rw,
                              ring.bar(t), 0, kTile * t, h, img);
      }
    }
    return;
  }

  const int row = warp * 16 + lane / 4;   // own keys k0 + row, + 8
  const int t4 = lane % 4;
  const int nb_steps = (a.d + 15) / 16;
  const int gh = a.gh, gw = a.gw;
  const int ldh = rel_ld(gh), ldw = rel_ld(gw);
  bf16* extra_s = reinterpret_cast<bf16*>(smem + L::kExtra);

  // kGrid64: the block's keys are key-grid row kh = k0 / 64; rh[i, kh] of
  // every query i, staged once. kGeneral: the own keys' grid row and
  // column (0 past n, whose gradients are not stored), and the queries'
  // rel terms: all of them once where they fit (rh rows, then rw rows),
  // else tile t's into stage t % 2.
  uint32_t own_lo = 0, own_hi = 0;   // kGeneral: kh << 16 | kw
  const bool whole = BIAS == kGeneral && rel_whole(a.n_pad, gh, gw);
  if constexpr (BIAS == kGrid64) {
    constexpr int kBatch = 8;
    const int kh = k0 / kTile;
    for (int base = threadIdx.x; base < a.n_pad; base += 128 * kBatch) {
      bf16 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + 128 * u;
        v[u] = i < n ? a.rh[(bn + i) * gh + kh] : __float2bfloat16(0.f);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (base + 128 * u < a.n_pad) extra_s[base + 128 * u] = v[u];
    }
  } else if constexpr (BIAS == kGeneral) {
    const int key_lo = k0 + row, key_hi = key_lo + 8;
    if (key_lo < n)
      own_lo = ((uint32_t)(key_lo / gw) << 16) | (uint32_t)(key_lo % gw);
    if (key_hi < n)
      own_hi = ((uint32_t)(key_hi / gw) << 16) | (uint32_t)(key_hi % gw);
  }
  // kGeneral: where query tile t's rh and rw rows lie.
  auto rel_h = [&](int t) {
    return whole ? extra_s + kTile * t * ldh
                 : extra_s + (t % 2) * kTile * (ldh + ldw);
  };
  auto rel_w = [&](int t) {
    return whole ? extra_s + a.n_pad * ldh + kTile * t * ldw
                 : rel_h(t) + kTile * ldh;
  };
  auto stage_rel = [&](int t) {
    const int rows = min(kTile, n - kTile * t);
    stage_rows(a.rh + (bn + kTile * t) * gh, rel_h(t), rows, kTile, gh, ldh);
    stage_rows(a.rw + (bn + kTile * t) * gw, rel_w(t), rows, kTile, gw, ldw);
  };

  float s[32], dp[32], dk[DC][32], dv[DC][32];
  uint32_t xp[16], xs[16];
#pragma unroll
  for (int dc = 0; dc < DC; ++dc) {
    zero(dk[dc]);
    zero(dv[dc]);
  }
  auto fence_scores = [&] {
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
  };
  auto fence_product = [&] {
    hopper::fence_regs(xp);
    hopper::fence_regs(xs);
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      hopper::fence_regs(dk[dc]);
      hopper::fence_regs(dv[dc]);
    }
  };
  auto issue_scores = [&](int t) {
    ring.consume(t);
    if constexpr (BIAS != kNoBias) {   // as in (A)
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
    }
    hopper::wgmma_fence();
    product_abt<DC>(s, k_s, slot(q_s, t), nb_steps);
    product_abt<DC>(dp, v_s, slot(g_s, t), nb_steps);
    hopper::wgmma_commit();
  };
  auto issue_product = [&](int t) {
    hopper::fence_regs(xp);
    hopper::fence_regs(xs);
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      hopper::fence_regs(dk[dc]);
      hopper::fence_regs(dv[dc]);
    }
    hopper::wgmma_fence();
    product_xb<DC>(dv, xp, slot(g_s, t));
    product_xb<DC>(dk, xs, slot(q_s, t));
    hopper::wgmma_commit();
  };
  // p^T of query tile t into s (f32) and xp (bf16). Query rows past n: qs
  // and do are zeros, lse * log2(e) = +inf and delta = 0, so p = ds = 0.
  auto form_p = [&](int t) {
    const float* lse2 = stats_s + (t % kStages) * 2 * kTile;
    const uint8_t* rwt = rwt_s + (t % kStages) * kTileBytes;
    const bf16* rhc = extra_s + kTile * t;
    const bf16* rel_hs = rel_h(t);
    const bf16* rel_ws = rel_w(t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t4;   // the tile's queries col, col + 1
      const float2 ll = *reinterpret_cast<const float2*>(lse2 + col);
      float bias[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (BIAS == kGrid64) {
        // rw[i, c] of query i = col + e and own key c = row (+ 8): the
        // swizzled box's row i, column c.
        const float2 hv = unpack_bf16(*reinterpret_cast<const uint32_t*>(rhc + col));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = col + i % 2, c = row + 8 * (i / 2);
          const float wv = __bfloat162float(*reinterpret_cast<const bf16*>(
              rwt + q * 128 + ((((c >> 3) ^ (q & 7))) << 4) + (c & 7) * 2));
          bias[i] = (i % 2 ? hv.y : hv.x) + wv;
        }
      } else if constexpr (BIAS == kGeneral) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bf16* rq = rel_hs + (col + i % 2) * ldh;
          const bf16* wq = rel_ws + (col + i % 2) * ldw;
          const uint32_t own = i / 2 ? own_hi : own_lo;
          bias[i] = bf16_at(rq, (int)(own >> 16)) +
                    bf16_at(wq, (int)(own & 0xFFFFu));
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float sc = BIAS == kNoBias ? s[4 * j + i] : s[4 * j + i] + bias[i];
        s[4 * j + i] =
            hopper::exp2_approx(fmaf(sc, kLog2e, -(i % 2 ? ll.y : ll.x)));
      }
      xp[a_reg(j, 0)] = hopper::pack_bf16(s[4 * j], s[4 * j + 1]);
      xp[a_reg(j, 1)] = hopper::pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
  };
  // ds^T = p^T (dP^T - delta) of query tile t into xs (bf16).
  auto form_ds = [&](int t) {
    const float* delta = stats_s + (t % kStages) * 2 * kTile + kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl =
          *reinterpret_cast<const float2*>(delta + 8 * j + 2 * t4);
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ds[i] = s[4 * j + i] * (dp[4 * j + i] - (i % 2 ? dl.y : dl.x));
      xs[a_reg(j, 0)] = hopper::pack_bf16(ds[0], ds[1]);
      xs[a_reg(j, 1)] = hopper::pack_bf16(ds[2], ds[3]);
    }
  };

  if constexpr (BIAS == kGeneral) {
    if (whole) {
      stage_rows(a.rh + bn * gh, rel_h(0), n, a.n_pad, gh, ldh);
      stage_rows(a.rw + bn * gw, rel_w(0), n, a.n_pad, gw, ldw);
    } else {
      stage_rel(0);
    }
  }
  if constexpr (BIAS != kNoBias) hopper::named_barrier(1, 128);
  hopper::mbar_wait(ring.own_full, 0);
  issue_scores(0);
  for (int t = 0; t < nb_tiles; ++t) {
    hopper::wgmma_wait<0>();
    fence_scores();
    form_p(t);
    form_ds(t);
    issue_product(t);
    // The next tile's rel terms while the products run: its stage was last
    // read in form(t - 1), which every warp finished before the barrier
    // of tile t.
    if constexpr (BIAS == kGeneral)
      if (!whole && t + 1 < nb_tiles) stage_rel(t + 1);
    hopper::wgmma_wait<0>();
    fence_product();
    ring.release(t);
    if (t + 1 < nb_tiles) {
      if constexpr (BIAS == kGeneral)
        if (!whole) hopper::named_barrier(1, 128);
      issue_scores(t + 1);
    }
  }

  // The own tiles are free once every warp is past its last product.
  hopper::named_barrier(1, 128);
  store_tiles<DC>(dk, k_s, &maps.dk, k0, h, img);
  store_tiles<DC>(dv, v_s, &maps.dv, k0, h, img);
}

// ---------------------------------------------------------------------------
// Host

// Both launches over every slice of at most 65535 rows. `geometry`: tma.py's
// packed maps, kMaps - 1 (kMaps with kGrid64) of them; `bases` the tensors'
// pointers in the same order. Returns a cudaError_t value.
template <int DC, int BIAS>
int launch(const void* const* bases, const int64_t* geometry, Args args,
           cudaStream_t stream) {
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  CUtensorMap* list[kMaps] = {&maps.q,  &maps.k,  &maps.v,  &maps.g, &maps.o,
                              &maps.dq, &maps.dk, &maps.dv, &maps.rw};
  const int nb_maps = BIAS == kGrid64 ? kMaps : kMaps - 1;
  for (int i = 0; i < nb_maps; ++i) {
    const int err = hopper::encode_bf16_map(
        list[i], bases[i], geometry + i * hopper::kGeometrySize);
    if (err != 0) return err;
  }
  const int smem_a = TilesA<DC>::bytes(BIAS, args.gh, args.gw);
  const int smem_b = TilesB<DC, BIAS>::bytes(args.gh, args.gw, args.n_pad);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_rows_kernel<DC, BIAS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_keys_kernel<DC, BIAS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_b);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < args.rows; b0 += kMaxRowsPerLaunch) {
    args.b0 = b0;
    const dim3 grid(args.n_pad / kTile, args.rows - b0 < kMaxRowsPerLaunch
                                            ? args.rows - b0
                                            : kMaxRowsPerLaunch);
    attn_bwd_rows_kernel<DC, BIAS><<<grid, kThreads, smem_a, stream>>>(maps,
                                                                       args);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    attn_bwd_keys_kernel<DC, BIAS><<<grid, kThreads, smem_b, stream>>>(maps,
                                                                       args);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace attn_bwd
