// Flash attention with the decomposed relative-position bias, forward.
//
// Replaces: tfimm_tpu/ops/pallas/flash_attention_relpos.py ·
// _relpos_forward_call and _relpos_forward_call_paired (the Pallas TPU
// kernels; the paired one packs two heads into the 128 lanes and computes
// the same function). Per row b of (B, N, d), B = images * heads, N = gh*gw:
//
//     s[i, c] = qs_i . k_c + (rh[i, c / gw] + rw[i, c % gw])        (f32)
//     online softmax with a running max m (from -1e30), row sum l (f32)
//     o = (sum_c p.astype(io) v_c) / max(l, 1e-30)     (f32 sums, rounded once)
//     lse = m + log(max(l, 1e-30))                                    (f32)
//
// qs is q scaled and rounded to the io dtype (by the wrapper, as the JAX
// package scales q outside its kernel); rh (B, N, gh) and rw (B, N, gw)
// are the decomposed bias terms in the io dtype. The bias of a key tile is
// rebuilt from them: the (B, N, N) scores and bias never reach device
// memory. Unlike the other attention kernels of this package the
// softmax is exact: no clamp at 80, a running max instead.
//
// Two kernels, one per io dtype.
//
// - bf16 (the serving path), for Hopper (hopper.cuh): q, k and v are each
//   a 3-D TMA tensor (d, N, B) with their own row and batch byte strides
//   (so strided views of a packed projection need no copy), read in boxes
//   of 64 rows x 64 columns, 128-byte swizzled; rows at or beyond N and
//   columns at or beyond d arrive as zeros, so d = 80 and d = 128 are two
//   column chunks and a box never reads the next row b. A block owns 128
//   query rows of one row b: one producer warp and two consumer warpgroups
//   of 64 rows each (288 threads). The producer loads both q tiles once and
//   streams K and V through a ring of 64-key stages (4 up to d = 64, which
//   hold all of N <= 256 at once: the windowed blocks; 2 above), each
//   signalled on a "full" mbarrier by TMA's transaction count and released
//   on an "empty" one by the consumers' warps. Per key tile a consumer
//   computes the 64 x 64 scores with wgmma (both operands K-major from
//   shared memory), adds the bias, takes the tile's row maxima across the
//   4 lanes of a row, rescales its row sums and output by
//   exp(m_old - m_new), and keeps the bf16 probabilities in registers as
//   the A operand of p @ v, with v read from shared memory as an MN-major B
//   operand. The products overlap the softmax: the scores of tile t and
//   p @ v of tile t - 1 are issued together, and the softmax of t runs
//   while p @ v of t - 1 is in flight (p alternates between two register
//   sets). At the end it writes its 64 x d output into its q tile
//   (swizzled) for one TMA store a chunk, which clips rows beyond N and
//   columns beyond d, and the lse from registers. rh and rw (rows of gh or
//   gw bf16 values, not 16-byte strided, so not TMA boxes) are staged for
//   the block's 128 rows in shared memory once, 8 loads in flight a
//   thread, with a row stride of 4 (mod 8) words so that the 8 rows x 4
//   lanes of a warp's lookups hit 32 banks. The bias index has no division
//   in the key loop: where gw = 64 (SAM's global blocks), c / gw is the
//   tile index and c % gw a column's own, so each column's rw terms stay in
//   registers and a row reads one rh value a tile; otherwise each thread
//   keeps (c / gw, c % gw) of its 16 key columns in registers and steps
//   them by (64 / gw, 64 % gw) a tile.
// - f32: exact f32 FMAs (TF32 would not hold the f32 results to 1e-5). 256
//   threads as a 16 x 16 grid, each owning 4 query rows x 4 keys of a score
//   tile and 4 query rows x up to 8 head columns of the output; 64 query
//   rows a block, 64-key tiles loaded synchronously.
//
// What bounds it on an H100: at SAM-B's global blocks (B = 12 heads of one
// image, N = 4096, d = 64) one call reads 18.9 MB and writes 6.5 MB but does
// 4 * B * N^2 * d = 51.5 GFLOP: about 2000 flops per byte, far above the
// card's ~295 flops/byte ridge, so an ideal kernel is bounded by the tensor
// cores, at about 52 us at 989 TFLOP/s. The bf16 kernel takes 0.22 ms
// there, 23% of that bound and 1.02-1.04x SDPA's time with the bias as a
// float mask (0.98-0.99x with the operands out of L2; the general bias
// path alone, without the gw = 64 variant, 0.29 ms; chip_smoke.py phase 15
// on an H100 80GB HBM3 at 700 W; PERF.md). What holds it back: one block an
// SM (its registers, ptxas' report in chip_smoke.py's build log), so 384
// blocks run in three waves on 132 SMs, the third 120 blocks; two
// warpgroups an SM, each of which waits for its scores before its softmax;
// and the softmax itself (bias, maxima, 4096 exponentials a tile and
// warpgroup, at an eighth of the FMA units' rate). At the windowed blocks
// (N = 196, 300 rows per image) the bound is bytes, about 10 us per image;
// the kernel takes 0.065 ms out of L2, 1.4x SDPA: N rounds up to 256 keys
// and rows, and of each row's two blocks the second holds 68 rows of 128.
//
// Shared memory (bf16): 81 KB of tiles up to d = 64 and 97 KB above, plus
// 0.25 KB per grid column of gh and gw, padded to 8 (mod 16) columns
// (36 KB at gh = gw = 64, 12 KB at 14). Above the 48 KB static limit a
// launch needs the dynamic limit raised, so the launcher sets
// cudaFuncAttributeMaxDynamicSharedMemorySize before every launch and
// returns cudaGetLastError() after it (and the error of a tensor map that
// does not encode).
//
// Coverage: any B (launched in slices of 65535 rows), any N = gh * gw
// (ragged tails masked), gh and gw up to 128, every head dim d that is a
// multiple of 8 up to 128. q, k and v are read through their batch and row
// strides (bf16: 16-byte aligned rows and starts).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 64;               // query rows per block (f32)
constexpr int kBlockK = 64;               // keys per shared-memory tile (f32)
constexpr int kMaxHeadDim = 128;
constexpr int kMaxGridSide = 128;
constexpr int kMaxRowsPerLaunch = 65535;  // gridDim.y
constexpr float kNegInf = -1e30f;         // the running max's start
constexpr float kMinSum = 1e-30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  int64_t q_b, q_n, k_b, k_n, v_b, v_n;
};

// Row stride, in elements, of a staged f32 rel-term tile with `cols`
// columns: an odd number of words, so 8 consecutive rows start in 8 banks.
__host__ __device__ inline int rel_ld(int cols) { return cols | 1; }

// The rel terms of query rows [q0, q0 + 64) of one row b into shared
// memory; rows at or beyond n become zeros.
__device__ __forceinline__ void load_rel(const float* __restrict__ src,
                                         float* dst, int q0, int n, int cols,
                                         int ld, int nthreads) {
  for (int i = threadIdx.x; i < kBlockQ * cols; i += nthreads) {
    const int r = i / cols, c = i - r * cols;
    const int row = q0 + r;
    dst[r * ld + c] = row < n ? src[(int64_t)row * cols + c] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma

constexpr int kTile = 64;                 // q rows, keys and columns of a tile
constexpr int kTileBytes = kTile * kTile * 2;
constexpr int kConsumers = 2;             // warpgroups of 64 query rows
constexpr int kRowsPerBlock = kTile * kConsumers;
constexpr int kTmaThreads = 128 * kConsumers + 32;

// Row stride, in bf16 elements, of a staged rel-term tile: 4 (mod 8)
// words, so that 8 rows start 4 banks apart (4 r (2 k + 1) mod 32 takes 8
// values) and 8 rows x 4 neighbouring word columns fall in 32 banks.
__host__ __device__ inline int rel_ld_bf16(int cols) {
  return cols + ((8 - cols) % 16 + 16) % 16;
}

// DC: 64-column chunks of the head dim (1 up to d = 64, 2 up to 128).
template <int DC>
struct RelposTiles {
  static constexpr int kStages = DC == 1 ? 4 : 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kConsumers * DC * kTileBytes;
  static constexpr int kV = kK + kStages * DC * kTileBytes;
  static constexpr int kBars = kV + kStages * DC * kTileBytes;
  static constexpr int kRel = kBars + 16 * (1 + kStages);  // q_full, full, empty
  // 1024 bytes of slack for the alignment of the tiles.
  static int bytes(int gh, int gw) {
    return kRel + 2 * kRowsPerBlock * (rel_ld_bf16(gh) + rel_ld_bf16(gw)) +
           1024;
  }
};

// The first `rows` rows of `cols` rel terms at src (contiguous) into the
// 128-row tile dst of row stride ld, zeros below; by the 256 consumer
// threads, 8 loads in flight per thread before their stores.
__device__ __forceinline__ void stage_rel(const __nv_bfloat16* __restrict__ src,
                                          __nv_bfloat16* dst, int rows,
                                          int cols, int ld) {
  constexpr int kThreads = 128 * kConsumers, kBatch = 8;
  const int total = kRowsPerBlock * cols;
  for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
    __nv_bfloat16 v[kBatch];
    int r[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + kThreads * u;
      r[u] = i / cols;
      v[u] = i < total && r[u] < rows ? src[i] : __float2bfloat16(0.f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + kThreads * u;
      if (i < total) dst[r[u] * ld + i - r[u] * cols] = v[u];
    }
  }
}

__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

template <int DC, bool GRID64>
__global__ void __launch_bounds__(kTmaThreads, 1)
relpos_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap out_map,
                       const __nv_bfloat16* __restrict__ rh,
                       const __nv_bfloat16* __restrict__ rw,
                       float* __restrict__ lse, int n, int d, int gh, int gw,
                       int b0) {
  using L = RelposTiles<DC>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* q_s = smem + L::kQ;
  uint8_t* k_s = smem + L::kK;
  uint8_t* v_s = smem + L::kV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  const int ldh = rel_ld_bf16(gh), ldw = rel_ld_bf16(gw);
  __nv_bfloat16* rh_s = reinterpret_cast<__nv_bfloat16*>(smem + L::kRel);
  __nv_bfloat16* rw_s = rh_s + kRowsPerBlock * ldh;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kRowsPerBlock;
  const int b = b0 + blockIdx.y;
  const int nb_tiles = (n + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * kConsumers);   // one arrival a warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {
    // Producer: both q tiles, then K and V a 64-key tile at a time.
    if (lane == 0) {
      hopper::mbar_expect_tx(q_full, kConsumers * DC * kTileBytes);
      for (int c = 0; c < kConsumers; ++c)
        for (int dc = 0; dc < DC; ++dc)
          hopper::tma_load_3d(q_s + (c * DC + dc) * kTileBytes, &q_map,
                              q_full, kTile * dc, q0 + kTile * c, b);
      for (int t = 0; t < nb_tiles; ++t) {
        const int st = t % kStages;
        const uint32_t phase = (t / kStages) & 1;
        if (t >= kStages) hopper::mbar_wait(&empty[st], phase ^ 1);
        hopper::mbar_expect_tx(&full[st], 2 * DC * kTileBytes);
        for (int dc = 0; dc < DC; ++dc) {
          const int slot = (st * DC + dc) * kTileBytes;
          hopper::tma_load_3d(k_s + slot, &k_map, &full[st], kTile * dc,
                              kTile * t, b);
          hopper::tma_load_3d(v_s + slot, &v_map, &full[st], kTile * dc,
                              kTile * t, b);
        }
      }
    }
    return;
  }

  // The rel terms of the block's rows (contiguous in rh and rw), while the
  // first tiles arrive; rows at or beyond n become zeros.
  {
    const int rows = min(kRowsPerBlock, n - q0);
    stage_rel(rh + ((int64_t)b * n + q0) * gh, rh_s, rows, gh, ldh);
    stage_rel(rw + ((int64_t)b * n + q0) * gw, rw_s, rows, gw, ldw);
    hopper::named_barrier(1, 128 * kConsumers);
  }

  // Consumer warpgroup wg: query rows q0 + 64 wg ... + 63.
  const int wg = warp / 4;
  const int row = (warp % 4) * 16 + lane / 4;   // and row + 8
  const int t4 = lane % 4;
  const int nb_steps = (d + 15) / 16;          // k16 steps of q . k
  uint8_t* my_q = q_s + wg * DC * kTileBytes;
  const __nv_bfloat16* rh_lo = rh_s + (kTile * wg + row) * ldh;
  const __nv_bfloat16* rh_hi = rh_lo + 8 * ldh;
  const __nv_bfloat16* rw_lo = rw_s + (kTile * wg + row) * ldw;
  const __nv_bfloat16* rw_hi = rw_lo + 8 * ldw;

  // The bias index of this thread's 16 key columns c = 8 j + 2 t4 + e of a
  // tile. GRID64 (gw = 64, the tile width): c / gw is the tile index and
  // c % gw does not change from tile to tile, so the rw terms of the
  // columns stay in registers. Otherwise (c / gw) << 16 | (c % gw) of each
  // column, stepped by 64 keys a tile.
  constexpr int kIdx = GRID64 ? 1 : 16;
  constexpr int kRw = GRID64 ? 32 : 1;
  uint32_t grid_idx[kIdx];
  float rw_reg[kRw];
  if constexpr (GRID64) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = 8 * (i / 2) + 2 * t4 + i % 2;
      rw_reg[2 * i] = bf16_at(rw_lo, c);
      rw_reg[2 * i + 1] = bf16_at(rw_hi, c);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = 8 * (i / 2) + 2 * t4 + i % 2;
      grid_idx[i] = ((uint32_t)(c / gw) << 16) | (uint32_t)(c % gw);
    }
  }
  const uint32_t step = ((uint32_t)(kTile / gw) << 16) | (uint32_t)(kTile % gw);
  const uint32_t wrap = (1u << 16) - (uint32_t)gw;

  float o[DC][32];
#pragma unroll
  for (int dc = 0; dc < DC; ++dc)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[dc][i] = 0.f;
  float s[32];
  float m_lo = kNegInf, m_hi = kNegInf;   // rows row and row + 8
  float l_lo = 0.f, l_hi = 0.f;           // this lane's share of the sums
  float a_lo = 0.f, a_hi = 0.f;           // the latest tile's rescale

  // s = q k^T of tile t, issued as one wgmma group.
  auto issue_scores = [&](int t) {
    const int st = t % kStages;
    hopper::mbar_wait(&full[st], (t / kStages) & 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    hopper::fence_regs(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4 * DC; ++ks) {
      if (ks < nb_steps) {
        const int dc = ks / 4, kk = ks % 4;
        const uint64_t a = hopper::sw128_desc(my_q + dc * kTileBytes) + 2 * kk;
        const uint64_t bk =
            hopper::sw128_desc(k_s + (st * DC + dc) * kTileBytes) + 2 * kk;
        hopper::wgmma_m64n64k16_ss<0>(s, a, bk, ks > 0);
      }
    }
    hopper::wgmma_commit();
  };

  // o += p v of tile t, issued as one wgmma group (v MN-major, 16 key rows
  // of 128 bytes a step).
  auto issue_pv = [&](int t, uint32_t (&p)[16]) {
    const int st = t % kStages;
    hopper::fence_regs(p);
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) hopper::fence_regs(o[dc]);
    hopper::wgmma_fence();
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const uint64_t bv =
            hopper::sw128_desc(v_s + (st * DC + dc) * kTileBytes) + 128 * m;
        hopper::wgmma_m64n64k16_rs<1>(o[dc], &p[4 * m], bv, 1);
      }
    }
    hopper::wgmma_commit();
  };

  // Tile t's scores (complete in s) -> its bf16 probabilities p relative to
  // the new running max, the row sums' update and the rescale a of the
  // output so far, which the caller applies once the previous p @ v is done.
  auto softmax = [&](int t, uint32_t (&p)[16]) {
    // The bias; keys at or beyond n get -1e30 (and below, p = 0). Then the
    // tile's row maxima, each row spread over the 4 lanes of its group.
    const bool ragged = kTile * (t + 1) > n;
    float h_lo = 0.f, h_hi = 0.f;
    if constexpr (GRID64) {
      h_lo = bf16_at(rh_lo, t);
      h_hi = bf16_at(rh_hi, t);
    }
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = i / 2, e = i % 2;
      float lo, hi;
      if constexpr (GRID64) {
        lo = s[4 * j + e] + (h_lo + rw_reg[2 * i]);
        hi = s[4 * j + 2 + e] + (h_hi + rw_reg[2 * i + 1]);
      } else {
        const int kh = (int)(grid_idx[i] >> 16);
        const int kw = (int)(grid_idx[i] & 0xFFFFu);
        lo = s[4 * j + e] + (bf16_at(rh_lo, kh) + bf16_at(rw_lo, kw));
        hi = s[4 * j + 2 + e] + (bf16_at(rh_hi, kh) + bf16_at(rw_hi, kw));
        grid_idx[i] += step;
        if ((grid_idx[i] & 0xFFFFu) >= (uint32_t)gw) grid_idx[i] += wrap;
      }
      const bool ok = !ragged || kTile * t + 8 * j + 2 * t4 + e < n;
      s[4 * j + e] = ok ? lo : kNegInf;
      s[4 * j + 2 + e] = ok ? hi : kNegInf;
      mx_lo = fmaxf(mx_lo, s[4 * j + e]);
      mx_hi = fmaxf(mx_hi, s[4 * j + 2 + e]);
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    a_lo = hopper::exp2_approx((m_lo - mn_lo) * kLog2e);
    a_hi = hopper::exp2_approx((m_hi - mn_hi) * kLog2e);
    m_lo = mn_lo;
    m_hi = mn_hi;
    const float ml_lo = mn_lo * kLog2e, ml_hi = mn_hi * kLog2e;

    // p = exp(s - m), rounded to bf16 as the A operand of p @ v (column
    // blocks 2m and 2m + 1 are the registers of k16 step m); the sums take
    // the unrounded values.
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float e0 = hopper::exp2_approx(fmaf(s[4 * j], kLog2e, -ml_lo));
      const float e1 = hopper::exp2_approx(fmaf(s[4 * j + 1], kLog2e, -ml_lo));
      const float e2 = hopper::exp2_approx(fmaf(s[4 * j + 2], kLog2e, -ml_hi));
      const float e3 = hopper::exp2_approx(fmaf(s[4 * j + 3], kLog2e, -ml_hi));
      ps_lo += e0 + e1;
      ps_hi += e2 + e3;
      p[(j / 2) * 4 + (j % 2) * 2] = hopper::pack_bf16(e0, e1);
      p[(j / 2) * 4 + (j % 2) * 2 + 1] = hopper::pack_bf16(e2, e3);
    }
    l_lo = l_lo * a_lo + ps_lo;
    l_hi = l_hi * a_hi + ps_hi;
  };

  // One key tile t >= 1 with the products overlapped: the scores of t and
  // p @ v of t - 1 go to the tensor cores together; the softmax of t runs
  // while p @ v of t - 1 is in flight (so its p has its own registers);
  // then stage t - 1 is released and the output rescaled.
  auto key_tile = [&](int t, uint32_t (&p_prev)[16], uint32_t (&p)[16]) {
    issue_scores(t);
    issue_pv(t - 1, p_prev);
    hopper::wgmma_wait<1>();
    hopper::fence_regs(s);
    softmax(t, p);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(p_prev);
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) hopper::fence_regs(o[dc]);
    if (lane == 0) hopper::mbar_arrive(&empty[(t - 1) % kStages]);
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[dc][4 * j] *= a_lo;
        o[dc][4 * j + 1] *= a_lo;
        o[dc][4 * j + 2] *= a_hi;
        o[dc][4 * j + 3] *= a_hi;
      }
    }
  };

  hopper::mbar_wait(q_full, 0);
  uint32_t p_even[16], p_odd[16];
  issue_scores(0);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(s);
  softmax(0, p_even);
  for (int t = 1; t < nb_tiles; t += 2) {
    key_tile(t, p_even, p_odd);
    if (t + 1 < nb_tiles) key_tile(t + 1, p_odd, p_even);
  }
  if ((nb_tiles - 1) % 2 == 0)
    issue_pv(nb_tiles - 1, p_even);
  else
    issue_pv(nb_tiles - 1, p_odd);
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int dc = 0; dc < DC; ++dc) hopper::fence_regs(o[dc]);

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  l_lo = fmaxf(l_lo, kMinSum);
  l_hi = fmaxf(l_hi, kMinSum);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  const int row_lo = q0 + kTile * wg + row, row_hi = row_lo + 8;
  if (t4 == 0) {
    if (row_lo < n) lse[(int64_t)b * n + row_lo] = m_lo + logf(l_lo);
    if (row_hi < n) lse[(int64_t)b * n + row_hi] = m_hi + logf(l_hi);
  }

  // The q tile is free once every warp of the group is past its last score
  // product; it takes the output, which one thread stores.
  hopper::named_barrier(2 + wg, 128);
#pragma unroll
  for (int dc = 0; dc < DC; ++dc) {
    uint8_t* out_tile = my_q + dc * kTileBytes;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int j2 = 4 * j + t4;
      *reinterpret_cast<uint32_t*>(out_tile + hopper::sw128_offset(row, j2)) =
          hopper::pack_bf16(o[dc][4 * j] * inv_lo, o[dc][4 * j + 1] * inv_lo);
      *reinterpret_cast<uint32_t*>(out_tile + hopper::sw128_offset(row + 8, j2)) =
          hopper::pack_bf16(o[dc][4 * j + 2] * inv_hi,
                            o[dc][4 * j + 3] * inv_hi);
    }
  }
  hopper::fence_proxy_async();
  hopper::named_barrier(2 + wg, 128);
  if (threadIdx.x % 128 == 0) {
    for (int dc = 0; dc < DC; ++dc)
      hopper::tma_store_3d(&out_map, my_q + dc * kTileBytes, kTile * dc,
                           q0 + kTile * wg, b);
    hopper::tma_store_commit_and_wait();
  }
}

template <int DC>
int launch_bf16(const void* q, const void* k, const void* v, const void* rh,
                const void* rw, void* out, void* lse, const int64_t* maps,
                int batch, int n, int d, int gh, int gw, cudaStream_t stream) {
  CUtensorMap tmaps[4];
  const void* bases[4] = {q, k, v, out};
  for (int i = 0; i < 4; ++i) {
    const int err = hopper::encode_bf16_map(&tmaps[i], bases[i],
                                            maps + i * hopper::kGeometrySize);
    if (err != 0) return err;
  }
  const int smem = RelposTiles<DC>::bytes(gh, gw);
  // gw = 64 takes the variant that keeps the rw terms in registers: at
  // SAM-B's global blocks it is the faster one (PERF.md, section 6).
  auto kernel = gw == kTile ? relpos_fwd_bf16_kernel<DC, true>
                            : relpos_fwd_bf16_kernel<DC, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < batch; b0 += kMaxRowsPerLaunch) {
    const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock,
                    batch - b0 < kMaxRowsPerLaunch ? batch - b0
                                                   : kMaxRowsPerLaunch);
    kernel<<<grid, kTmaThreads, smem, stream>>>(
        tmaps[0], tmaps[1], tmaps[2], tmaps[3],
        static_cast<const __nv_bfloat16*>(rh),
        static_cast<const __nv_bfloat16*>(rw), static_cast<float*>(lse), n, d,
        gh, gw, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// f32: FMA

constexpr int kFmaThreads = 256;          // 16 x 16
constexpr int kRows = kBlockQ / 16;       // query rows per thread
constexpr int kKeys = kBlockK / 16;       // keys per thread in a score tile
constexpr int kCols = kMaxHeadDim / 16;   // output columns per thread (max)

size_t fma_smem_bytes(int d, int gh, int gw) {
  const int ld = d + 1;
  return sizeof(float) *
         ((size_t)kBlockQ * ld + 2 * (size_t)kBlockK * ld +
          (size_t)kBlockQ * (kBlockK + 1) +
          (size_t)kBlockQ * (rel_ld(gh) + rel_ld(gw)));
}

__global__ void __launch_bounds__(kFmaThreads)
relpos_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, Strides st,
                      const float* __restrict__ rh,
                      const float* __restrict__ rw, float* __restrict__ out,
                      float* __restrict__ lse, int n, int d, int gh, int gw,
                      int b0) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int ldp = kBlockK + 1;
  const int ldh = rel_ld(gh), ldw = rel_ld(gw);
  float* q_s = smem;                  // kBlockQ x ld
  float* k_s = q_s + kBlockQ * ld;    // kBlockK x ld
  float* v_s = k_s + kBlockK * ld;    // kBlockK x ld
  float* p_s = v_s + kBlockK * ld;    // kBlockQ x ldp
  float* rh_s = p_s + kBlockQ * ldp;  // kBlockQ x ldh
  float* rw_s = rh_s + kBlockQ * ldh; // kBlockQ x ldw

  const int q0 = blockIdx.x * kBlockQ;
  const int64_t b = (int64_t)b0 + blockIdx.y;
  const float* q_g = q + b * st.q_b;
  const float* k_g = k + b * st.k_b;
  const float* v_g = v + b * st.v_b;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  for (int i = tid; i < kBlockQ * d; i += kFmaThreads) {
    const int r = i / d, c = i % d;
    const int row = q0 + r;
    q_s[r * ld + c] = row < n ? q_g[(int64_t)row * st.q_n + c] : 0.f;
  }
  load_rel(rh + b * n * gh, rh_s, q0, n, gh, ldh, kFmaThreads);
  load_rel(rw + b * n * gw, rw_s, q0, n, gw, ldw, kFmaThreads);

  float acc[kRows][kCols];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // previous tile fully read (and q_s, rh_s, rw_s written)
    for (int i = tid; i < kBlockK * d; i += kFmaThreads) {
      const int r = i / d, c = i % d;
      const int row = k0 + r;
      const bool ok = row < n;
      k_s[r * ld + c] = ok ? k_g[(int64_t)row * st.k_n + c] : 0.f;
      v_s[r * ld + c] = ok ? v_g[(int64_t)row * st.v_n + c] : 0.f;
    }
    __syncthreads();

    // Scores for rows ty + 16 i and keys tx + 16 j of this tile.
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_s[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = k_s[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // The bias, the tile's row maxima (over the 16 tx lanes of a
    // half-warp), the rescale and the probabilities.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int key = k0 + tx + 16 * j;
        if (key < n) {
          const int kh = key / gw, kw = key - kh * gw;
          s[i][j] += rh_s[r * ldh + kh] + rw_s[r * ldw + kw];
        } else {
          s[i][j] = kNegInf;
        }
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      m[i] = mn;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int key = k0 + tx + 16 * j;
        const float e = key < n ? expf(s[i][j] - mn) : 0.f;
        ps += e;
        p_s[r * ldp + tx + 16 * j] = e;
      }
      l[i] = l[i] * alpha + ps;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += p @ v for rows ty + 16 i and head columns tx + 16 j.
    const int kmax = min(kBlockK, n - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_s[(ty + 16 * i) * ldp + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        if (c < d) {
          const float vv = v_s[kk * ld + c];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    l[i] = fmaxf(l[i], kMinSum);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
    float* o = out + (b * n + row) * d;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 16 * j;
      if (c < d) o[c] = acc[i][j] / l[i];
    }
    if (tx == 0) lse[b * n + row] = m[i] + logf(l[i]);
  }
}

int launch_f32(const void* q, const void* k, const void* v, Strides st,
               const void* rh, const void* rw, void* out, void* lse,
               int batch, int n, int d, int gh, int gw, cudaStream_t stream) {
  const size_t smem = fma_smem_bytes(d, gh, gw);
  cudaError_t err = cudaFuncSetAttribute(
      relpos_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < batch; b0 += kMaxRowsPerLaunch) {
    const dim3 grid((n + kBlockQ - 1) / kBlockQ,
                    batch - b0 < kMaxRowsPerLaunch ? batch - b0
                                                   : kMaxRowsPerLaunch);
    relpos_fwd_f32_kernel<<<grid, kFmaThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), st, static_cast<const float*>(rh),
        static_cast<const float*>(rw), static_cast<float*>(out),
        static_cast<float*>(lse), n, d, gh, gw, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements (read by the
// f32 kernel; the bf16 kernel reads its operands through the tensor maps).
// maps (bf16 only): the geometries of the q, k, v and out tensor maps,
// hopper::kGeometrySize int64 values each, as
// tfimm_tpu_torch/ops/kernels/tma.py computes them. Returns a cudaError_t
// value (0 = ok).
extern "C" int tfimm_flash_attention_relpos_fwd(
    const void* q, const void* k, const void* v, int64_t q_sb, int64_t q_sn,
    int64_t k_sb, int64_t k_sn, int64_t v_sb, int64_t v_sn, const void* rh,
    const void* rw, void* out, void* lse, const int64_t* maps, int batch,
    int n, int head_dim, int gh, int gw, int dtype, void* stream) {
  if (batch <= 0 || n <= 0 || head_dim <= 0 || head_dim % 8 != 0 ||
      head_dim > kMaxHeadDim || gh <= 0 || gw <= 0 || gh > kMaxGridSide ||
      gw > kMaxGridSide || n != gh * gw)
    return (int)cudaErrorInvalidValue;
  const Strides st{q_sb, q_sn, k_sb, k_sn, v_sb, v_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_f32(q, k, v, st, rh, rw, out, lse, batch, n, head_dim, gh,
                        gw, s);
    case 1: {
      const int64_t strides[6] = {q_sb, q_sn, k_sb, k_sn, v_sb, v_sn};
      for (int64_t x : strides)
        if (x % 8 != 0) return (int)cudaErrorMisalignedAddress;
      const void* ptrs[4] = {q, k, v, out};
      for (const void* p : ptrs)
        if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
          return (int)cudaErrorMisalignedAddress;
      if (maps == nullptr) return (int)cudaErrorInvalidValue;
      if (head_dim <= kTile)
        return launch_bf16<1>(q, k, v, rh, rw, out, lse, maps, batch, n,
                              head_dim, gh, gw, s);
      return launch_bf16<2>(q, k, v, rh, rw, out, lse, maps, batch, n,
                            head_dim, gh, gw, s);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
