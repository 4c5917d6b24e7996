// Flash attention, forward.
//
// Replaces: tfimm_tpu/ops/pallas/flash_attention_kernel.py ·
// _flash_forward_call (the Pallas TPU kernel behind flash_attention). Per
// row b of B = images * heads, with q, k, v (N, d):
//
//     s[i, c] = qs_i . k_c                         (f32; keys >= N: -1e30)
//     online softmax with a running max m (from -1e30), row sum l (f32)
//     o = (sum_c p.astype(io) v_c) / max(l, 1e-30)     (f32 sums, rounded once)
//     lse = m + log(max(l, 1e-30))                                    (f32)
//
// qs arrives scaled and rounded to the io dtype (the wrapper scales it, as
// the JAX package scales q outside its kernel). The softmax is exact: no
// clamp at 80, a running max instead. The (N, N) scores never reach device
// memory.
//
// Row b of the kernel is (b / heads, b % heads) of a (B, H, N, d) view, and
// every operand is read or written through its own three strides (image,
// head, token), so that the attention layer hands over q, k and v as views
// of its packed (B, N, 3 * H * d) projection and takes o as (B, N, H * d):
// no head transpose and no copy. A plain (B, N, d) operand is H = 1.
//
// Three kernels.
//
// - bf16 up to d = 128 (the serving and training paths), for Hopper
//   (hopper.cuh): flash_attention_relpos.cu's forward loop without the
//   bias. Each operand is a 4-D TMA tensor (d, N, H, B), innermost first,
//   with its own token, head and image byte strides (tma.py · heads_map),
//   read in boxes of 64 rows x 64 columns, 128-byte swizzled; rows at or
//   beyond N and columns at or beyond d arrive as zeros, so d up to 64 is
//   one column chunk and up to 128 two, and a box never reads the next
//   head's or image's rows. A block owns 64 x NC query rows of one row b:
//   one producer warp and NC consumer warpgroups of 64 rows each. NC = 3
//   up to d = 64 (416 threads: at 123 registers a thread the 13 warps fit
//   an SM, and the third warpgroup hides more of each one's chain: faster
//   than two at ViT-B/16-512 in a development build), 2 above (162
//   registers). The producer loads the q tiles once and streams K and V
//   through a ring of 64-key stages (4 up to d = 64, 2 above), each
//   signalled on a "full" mbarrier by TMA's transaction count and released
//   on an "empty" one by the consumers' warps. Per key tile a consumer
//   computes the 64 x 64 scores with wgmma (both operands K-major from
//   shared memory), takes the tile's row maxima across the 4 lanes of a
//   row, rescales its row sums and output by exp(m_old - m_new), and keeps
//   the bf16 probabilities in registers as the A operand of p @ v, with v
//   read from shared memory as an MN-major B operand. The products overlap
//   the softmax: the scores of tile t and p @ v of tile t - 1 are issued
//   together, and the softmax of t runs while p @ v of t - 1 is in flight
//   (p alternates between two register sets). At the end it writes its
//   64 x d output into its q tile (swizzled) for one TMA store a chunk,
//   which clips rows beyond N and columns beyond d, and the lse from
//   registers. The ragged tail: a warpgroup whose 64 rows all lie at or
//   beyond N (the third of N = 1025's last block, rows 960-1151) runs no
//   loop, its q tile is not loaded, and the "empty" barriers count only the
//   live warpgroups: decided once, before the loop.
// - bf16 above d = 128 (no timed path reaches it): tensor cores through
//   mma.sync m16n8k16, 4 warps each owning 16 query rows of 64 a block,
//   synchronous 64-key tile loads. The 16 x d f32 accumulator would need
//   up to 128 registers a thread beside the scores, so each block writes
//   half of the head columns (gridDim.z = 2), recomputing the scores from
//   the whole d.
// - f32: exact f32 FMAs (TF32 would not hold the f32 results to 1e-5). 256
//   threads as a 16 x 16 grid, each owning 4 query rows x 4 keys of a score
//   tile and 4 query rows x up to 8 (16 above d = 128) head columns of o.
//
// What bounds it on an H100: at ViT-B/16 on 512x512 images (B = 64 images
// x 12 heads, N = 1025, d = 64) one call does 4 * B * N^2 * d = 206.6 GFLOP
// and moves 403 MB (q, k, v read, o written, the lse): about 510 flops per
// byte, above the card's ~295 flops/byte ridge, so an ideal kernel is
// bounded by the tensor cores, at 0.209 ms at 989 TFLOP/s. N = 1025 is 16
// full 64-key tiles and one key, and 5 full 192-row blocks and 65 rows:
// the padded products are 1.13x the function's (1.19x if the last block
// ran every warpgroup). What holds the TMA kernel back: one block an SM
// (its registers; ptxas' report in chip_smoke.py's build log), so three
// warpgroups an SM, each of which waits for its scores before its
// softmax; and the softmax itself (maxima, rescale and 4096 exponentials a
// tile and warpgroup, at an eighth of the FMA units' rate).
//
// Shared memory: bf16 89 KB up to d = 64, 97 KB up to 128, and 85.0 KB at
// d = 256 (mma.sync); f32 66.6 KB at d = 64, up to 214.0 KB at d = 256.
// Above the 48 KB static limit a launch needs the dynamic limit raised, so
// the launcher sets cudaFuncAttributeMaxDynamicSharedMemorySize before
// every launch and returns cudaGetLastError() after it (and the error of a
// tensor map that does not encode).
//
// Coverage: any B (launched in slices of 65535 rows), any N (ragged tails
// masked), every head dim d that is a multiple of 8 up to 256. bf16
// operands need 16-byte aligned rows and starts (strides a multiple of 8
// elements; up to d = 128 the output's too).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockQ = 64;               // query rows per block (mma.sync, f32)
constexpr int kBlockK = 64;               // keys per shared-memory tile
constexpr int kMaxHeadDim = 256;
constexpr int kMaxRowsPerLaunch = 65535;  // gridDim.y
constexpr float kNegInf = -1e30f;         // the running max's start
constexpr float kMinSum = 1e-30f;
constexpr float kLog2e = 1.4426950408889634f;

// Strides, in elements, of one (B, H, N, d) operand (d has stride 1).
struct Rows {
  int64_t b, h, n;
};

struct Layout {
  Rows q, k, v, o;
};

// The offset of row b = (b / heads, b % heads) of an operand.
__device__ __forceinline__ int64_t row_base(const Rows& r, int64_t b,
                                            int heads) {
  return (b / heads) * r.b + (b % heads) * r.h;
}

// ---------------------------------------------------------------------------
// bf16 up to d = 128: TMA + wgmma

constexpr int kTile = 64;                 // q rows, keys and columns of a tile
constexpr int kTileBytes = kTile * kTile * 2;
constexpr int kTmaMaxHeadDim = 2 * kTile;

// DC: 64-column chunks of the head dim (1 up to d = 64, 2 up to 128); NC:
// consumer warpgroups of 64 query rows.
template <int DC, int NC>
struct FlashTiles {
  static constexpr int kThreads = 128 * NC + 32;
  static constexpr int kRows = kTile * NC;
  static constexpr int kStages = DC == 1 ? 4 : 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + NC * DC * kTileBytes;
  static constexpr int kV = kK + kStages * DC * kTileBytes;
  static constexpr int kBars = kV + kStages * DC * kTileBytes;
  // q_full, full[stages], empty[stages]; 1024 bytes of slack for alignment.
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int DC, int NC>
__global__ void __launch_bounds__(FlashTiles<DC, NC>::kThreads, 1)
flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap out_map,
                     float* __restrict__ lse, int n, int d, int heads,
                     int b0) {
  using L = FlashTiles<DC, NC>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* q_s = smem + L::kQ;
  uint8_t* k_s = smem + L::kK;
  uint8_t* v_s = smem + L::kV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * L::kRows;
  const int64_t b = (int64_t)b0 + blockIdx.y;
  const int img = (int)(b / heads), h = (int)(b % heads);
  const int nb_tiles = (n + kTile - 1) / kTile;
  // Consumer warpgroups with a query row below n: those of a block whose
  // 64 rows all lie at or beyond n have no work.
  const int live = min(NC, (n - q0 + kTile - 1) / kTile);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * live);   // one arrival a live warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * NC) {
    // Producer: the live q tiles, then K and V a 64-key tile at a time.
    if (lane == 0) {
      hopper::mbar_expect_tx(q_full, live * DC * kTileBytes);
      for (int c = 0; c < live; ++c)
        for (int dc = 0; dc < DC; ++dc)
          hopper::tma_load_4d(q_s + (c * DC + dc) * kTileBytes, &q_map,
                              q_full, kTile * dc, q0 + kTile * c, h, img);
      for (int t = 0; t < nb_tiles; ++t) {
        const int st = t % kStages;
        const uint32_t phase = (t / kStages) & 1;
        if (t >= kStages) hopper::mbar_wait(&empty[st], phase ^ 1);
        hopper::mbar_expect_tx(&full[st], 2 * DC * kTileBytes);
        for (int dc = 0; dc < DC; ++dc) {
          const int slot = (st * DC + dc) * kTileBytes;
          hopper::tma_load_4d(k_s + slot, &k_map, &full[st], kTile * dc,
                              kTile * t, h, img);
          hopper::tma_load_4d(v_s + slot, &v_map, &full[st], kTile * dc,
                              kTile * t, h, img);
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: query rows q0 + 64 wg ... + 63.
  const int wg = warp / 4;
  if (wg >= live) return;
  const int row = (warp % 4) * 16 + lane / 4;   // and row + 8
  const int t4 = lane % 4;
  const int nb_steps = (d + 15) / 16;          // k16 steps of q . k
  uint8_t* my_q = q_s + wg * DC * kTileBytes;

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
    // Keys at or beyond n get -1e30 (and below, p = 0). Then the tile's row
    // maxima, each row spread over the 4 lanes of its group.
    const bool ragged = kTile * (t + 1) > n;
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = i / 2, e = i % 2;
      const bool ok = !ragged || kTile * t + 8 * j + 2 * t4 + e < n;
      s[4 * j + e] = ok ? s[4 * j + e] : kNegInf;
      s[4 * j + 2 + e] = ok ? s[4 * j + 2 + e] : kNegInf;
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
    if (row_lo < n) lse[b * n + row_lo] = m_lo + logf(l_lo);
    if (row_hi < n) lse[b * n + row_hi] = m_hi + logf(l_hi);
  }

  // The q tile is free once every warp of the group is past its last score
  // product; it takes the output, which one thread stores.
  hopper::named_barrier(1 + wg, 128);
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
  hopper::named_barrier(1 + wg, 128);
  if (threadIdx.x % 128 == 0) {
    for (int dc = 0; dc < DC; ++dc)
      hopper::tma_store_4d(&out_map, my_q + dc * kTileBytes, kTile * dc,
                           q0 + kTile * wg, h, img);
    hopper::tma_store_commit_and_wait();
  }
}

template <int DC, int NC>
int launch_tma(const void* q, const void* k, const void* v, void* out,
               void* lse, const int64_t* maps, int batch, int n, int d,
               int heads, cudaStream_t stream) {
  CUtensorMap tmaps[4];
  const void* bases[4] = {q, k, v, out};
  for (int i = 0; i < 4; ++i) {
    const int err = hopper::encode_bf16_map(&tmaps[i], bases[i],
                                            maps + i * hopper::kGeometrySize);
    if (err != 0) return err;
  }
  using L = FlashTiles<DC, NC>;
  constexpr int smem = L::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tma_kernel<DC, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < batch; b0 += kMaxRowsPerLaunch) {
    const dim3 grid((n + L::kRows - 1) / L::kRows,
                    batch - b0 < kMaxRowsPerLaunch ? batch - b0
                                                   : kMaxRowsPerLaunch);
    flash_fwd_tma_kernel<DC, NC><<<grid, L::kThreads, smem, stream>>>(
        tmaps[0], tmaps[1], tmaps[2], tmaps[3], static_cast<float*>(lse), n,
        d, heads, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// bf16 above d = 128: tensor cores (mma.sync)

constexpr int kMmaThreads = 128;          // 4 warps x 16 query rows

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

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// DP: the head dim rounded up to a multiple of 16 (the mma k depth); DH:
// the head columns of o a block writes (DP / 2).
template <int DP, int DH>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * ((size_t)(kBlockQ + kBlockK) * (DP + 8) +
                         (size_t)kBlockK * (DH + 8));
}

// Rows [r0, r0 + 64) and columns [0, COLS) of one operand into shared
// memory (row stride COLS + 8), 16 bytes per load; rows at or beyond n and
// columns at or beyond d become zeros.
template <int COLS>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src,
                                          bf16* dst, int r0, int n, int d,
                                          int64_t row_stride) {
  constexpr int kChunks = COLS / 8;
  for (int i = threadIdx.x; i < kBlockQ * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int row = r0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < n && c < d)
      v = *reinterpret_cast<const uint4*>(src + (int64_t)row * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * (COLS + 8) + c) = v;
  }
}

template <int DP, int DH>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, Layout L,
                      bf16* __restrict__ out, float* __restrict__ lse, int n,
                      int d, int heads, int b0) {
  constexpr int LDP = DP + 8;
  constexpr int LDH = DH + 8;
  constexpr int kSteps = DP / 16;          // k steps of q @ k^T
  constexpr int kDimTiles = DH / 8;        // 8-column tiles of the output
  constexpr int kKeyTiles = kBlockK / 8;   // 8-key tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kBlockQ * LDP;
  bf16* v_s = k_s + kBlockK * LDP;

  const int q0 = blockIdx.x * kBlockQ;
  const int64_t b = (int64_t)b0 + blockIdx.y;
  const int c0 = blockIdx.z * DH;          // this block's first head column
  const bf16* q_g = q + row_base(L.q, b, heads);
  const bf16* k_g = k + row_base(L.k, b, heads);
  const bf16* v_g = v + row_base(L.v, b, heads) + c0;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                  // fragment row group
  const int t = lane % 4;                  // thread in group
  const int wr = warp * 16;                // this warp's first row in the tile
  const bool active = q0 + wr < n;
  const int r_lo = wr + g, r_hi = r_lo + 8;

  load_tile<DP>(q_g, q_s, q0, n, d, L.q.n);

  float o[kDimTiles][4];
#pragma unroll
  for (int j = 0; j < kDimTiles; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[j][r] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf;    // rows g and g + 8
  float l_lo = 0.f, l_hi = 0.f;            // this lane's share of the sums

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // previous tile fully read (and q_s written)
    load_tile<DP>(k_g, k_s, k0, n, d, L.k.n);
    load_tile<DH>(v_g, v_s, k0, n, d - c0, L.v.n);
    __syncthreads();
    if (!active) continue;

    float s[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const bf16* pa = q_s + r_lo * LDP + ks * 16 + 2 * t;
      const uint32_t a[4] = {ld_u32(pa), ld_u32(pa + 8 * LDP), ld_u32(pa + 8),
                             ld_u32(pa + 8 * LDP + 8)};
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        const bf16* p = k_s + (8 * j + g) * LDP + ks * 16 + 2 * t;
        mma_16816(s[j], a, ld_u32(p), ld_u32(p + 8));
      }
    }

    // Keys at or beyond n get -1e30 (and below, p = 0); then the tile's
    // row maxima, each row spread over the 4 lanes of its group.
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (k0 + 8 * j + 2 * t + e >= n) {
          s[j][e] = kNegInf;
          s[j][2 + e] = kNegInf;
        }
        mx_lo = fmaxf(mx_lo, s[j][e]);
        mx_hi = fmaxf(mx_hi, s[j][2 + e]);
      }
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float a_lo = expf(m_lo - mn_lo), a_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;

    uint32_t pf[kKeyTiles / 2][4];
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      const int key = k0 + 8 * j + 2 * t;
      const bool ok0 = key < n, ok1 = key + 1 < n;
      const float e0 = ok0 ? expf(s[j][0] - mn_lo) : 0.f;
      const float e1 = ok1 ? expf(s[j][1] - mn_lo) : 0.f;
      const float e2 = ok0 ? expf(s[j][2] - mn_hi) : 0.f;
      const float e3 = ok1 ? expf(s[j][3] - mn_hi) : 0.f;
      ps_lo += e0 + e1;
      ps_hi += e2 + e3;
      pf[j / 2][(j % 2) * 2 + 0] = hopper::pack_bf16(e0, e1);
      pf[j / 2][(j % 2) * 2 + 1] = hopper::pack_bf16(e2, e3);
    }
    l_lo = l_lo * a_lo + ps_lo;
    l_hi = l_hi * a_hi + ps_hi;
#pragma unroll
    for (int jd = 0; jd < kDimTiles; ++jd) {
      o[jd][0] *= a_lo;
      o[jd][1] *= a_lo;
      o[jd][2] *= a_hi;
      o[jd][3] *= a_hi;
    }

#pragma unroll
    for (int mk = 0; mk < kKeyTiles / 2; ++mk) {
      if (k0 + 16 * mk >= n) break;        // all 16 keys are padding
#pragma unroll
      for (int jd = 0; jd < kDimTiles; ++jd) {
        const bf16* p = v_s + (16 * mk + 2 * t) * LDH + 8 * jd + g;
        mma_16816(o[jd], pf[mk], pack_bf16(p[0], p[LDH]),
                  pack_bf16(p[8 * LDH], p[9 * LDH]));
      }
    }
  }
  if (!active) return;

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  l_lo = fmaxf(l_lo, kMinSum);
  l_hi = fmaxf(l_hi, kMinSum);
  const int row_lo = q0 + r_lo, row_hi = q0 + r_hi;
  bf16* o_lo = out + row_base(L.o, b, heads) + (int64_t)row_lo * L.o.n + c0;
  bf16* o_hi = o_lo + 8 * L.o.n;
#pragma unroll
  for (int jd = 0; jd < kDimTiles; ++jd) {
    const int c = 8 * jd + 2 * t;
    if (c0 + c >= d) break;
    if (row_lo < n)
      *reinterpret_cast<__nv_bfloat162*>(o_lo + c) =
          __floats2bfloat162_rn(o[jd][0] / l_lo, o[jd][1] / l_lo);
    if (row_hi < n)
      *reinterpret_cast<__nv_bfloat162*>(o_hi + c) =
          __floats2bfloat162_rn(o[jd][2] / l_hi, o[jd][3] / l_hi);
  }
  if (t == 0 && blockIdx.z == 0) {
    if (row_lo < n) lse[b * n + row_lo] = m_lo + logf(l_lo);
    if (row_hi < n) lse[b * n + row_hi] = m_hi + logf(l_hi);
  }
}

template <int DP, int DH>
int launch_mma(const void* q, const void* k, const void* v, const Layout& L,
               void* out, void* lse, int batch, int n, int d, int heads,
               cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<DP, DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<DP, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < batch; b0 += kMaxRowsPerLaunch) {
    const dim3 grid((n + kBlockQ - 1) / kBlockQ,
                    batch - b0 < kMaxRowsPerLaunch ? batch - b0
                                                   : kMaxRowsPerLaunch,
                    DP / DH);
    flash_fwd_bf16_kernel<DP, DH><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), L, static_cast<bf16*>(out),
        static_cast<float*>(lse), n, d, heads, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int dispatch_bf16(const void* q, const void* k, const void* v,
                  const Layout& L, void* out, void* lse, const int64_t* maps,
                  int batch, int n, int d, int heads, cudaStream_t s) {
  if (d <= kTmaMaxHeadDim) {
    if (maps == nullptr) return (int)cudaErrorInvalidValue;
    return d <= kTile
               ? launch_tma<1, 3>(q, k, v, out, lse, maps, batch, n, d, heads,
                                  s)
               : launch_tma<2, 2>(q, k, v, out, lse, maps, batch, n, d, heads,
                                  s);
  }
#define TFIMM_FLASH_BF16(DP) \
  launch_mma<DP, DP / 2>(q, k, v, L, out, lse, batch, n, d, heads, s)
  switch ((d + 15) / 16) {
    case 9: return TFIMM_FLASH_BF16(144);
    case 10: return TFIMM_FLASH_BF16(160);
    case 11: return TFIMM_FLASH_BF16(176);
    case 12: return TFIMM_FLASH_BF16(192);
    case 13: return TFIMM_FLASH_BF16(208);
    case 14: return TFIMM_FLASH_BF16(224);
    case 15: return TFIMM_FLASH_BF16(240);
    case 16: return TFIMM_FLASH_BF16(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TFIMM_FLASH_BF16
}

// ---------------------------------------------------------------------------
// f32: FMA

constexpr int kFmaThreads = 256;          // 16 x 16
constexpr int kRows = kBlockQ / 16;       // query rows per thread
constexpr int kKeys = kBlockK / 16;       // keys per thread in a score tile

size_t fma_smem_bytes(int d) {
  return sizeof(float) * ((size_t)(kBlockQ + 2 * kBlockK) * (d + 1) +
                          (size_t)kBlockQ * (kBlockK + 1));
}

// KC: head columns of o per thread (8 up to d = 128, 16 above).
template <int KC>
__global__ void __launch_bounds__(kFmaThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, Layout L,
                     float* __restrict__ out, float* __restrict__ lse, int n,
                     int d, int heads, int b0) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int ldp = kBlockK + 1;
  float* q_s = smem;                  // kBlockQ x ld
  float* k_s = q_s + kBlockQ * ld;    // kBlockK x ld
  float* v_s = k_s + kBlockK * ld;    // kBlockK x ld
  float* p_s = v_s + kBlockK * ld;    // kBlockQ x ldp

  const int q0 = blockIdx.x * kBlockQ;
  const int64_t b = (int64_t)b0 + blockIdx.y;
  const float* q_g = q + row_base(L.q, b, heads);
  const float* k_g = k + row_base(L.k, b, heads);
  const float* v_g = v + row_base(L.v, b, heads);

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  for (int i = tid; i < kBlockQ * d; i += kFmaThreads) {
    const int r = i / d, c = i % d;
    const int row = q0 + r;
    q_s[r * ld + c] = row < n ? q_g[(int64_t)row * L.q.n + c] : 0.f;
  }

  float acc[kRows][KC];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < KC; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // previous tile fully read (and q_s written)
    for (int i = tid; i < kBlockK * d; i += kFmaThreads) {
      const int r = i / d, c = i % d;
      const int row = k0 + r;
      const bool ok = row < n;
      k_s[r * ld + c] = ok ? k_g[(int64_t)row * L.k.n + c] : 0.f;
      v_s[r * ld + c] = ok ? v_g[(int64_t)row * L.v.n + c] : 0.f;
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

    // The tile's row maxima (over the 16 tx lanes of a half-warp), the
    // rescale and the probabilities; keys at or beyond n get -1e30, p = 0.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        if (k0 + tx + 16 * j >= n) s[i][j] = kNegInf;
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
        const float e = k0 + tx + 16 * j < n ? expf(s[i][j] - mn) : 0.f;
        ps += e;
        p_s[r * ldp + tx + 16 * j] = e;
      }
      l[i] = l[i] * alpha + ps;
#pragma unroll
      for (int j = 0; j < KC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += p @ v for rows ty + 16 i and head columns tx + 16 j.
    const int kmax = min(kBlockK, n - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_s[(ty + 16 * i) * ldp + kk];
#pragma unroll
      for (int j = 0; j < KC; ++j) {
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

  float* o_b = out + row_base(L.o, b, heads);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
    float* o = o_b + (int64_t)row * L.o.n;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const int c = tx + 16 * j;
      if (c < d) o[c] = acc[i][j] / l[i];
    }
    if (tx == 0) lse[b * n + row] = m[i] + logf(l[i]);
  }
}

template <int KC>
int launch_f32(const void* q, const void* k, const void* v, const Layout& L,
               void* out, void* lse, int batch, int n, int d, int heads,
               cudaStream_t stream) {
  const size_t smem = fma_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < batch; b0 += kMaxRowsPerLaunch) {
    const dim3 grid((n + kBlockQ - 1) / kBlockQ,
                    batch - b0 < kMaxRowsPerLaunch ? batch - b0
                                                   : kMaxRowsPerLaunch);
    flash_fwd_f32_kernel<KC><<<grid, kFmaThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), L, static_cast<float*>(out),
        static_cast<float*>(lse), n, d, heads, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// q, k, v and out are (B, H, N, d) operands given by their pointers and the
// 12 strides of `strides` (elements; image, head and token strides of q,
// k, v, out in turn; d has stride 1); lse is a contiguous f32 (B * H, N).
// batch = B * H. maps (bf16 up to d = 128): the geometries of the q, k, v
// and out tensor maps, hopper::kGeometrySize int64 values each, as
// tfimm_tpu_torch/ops/kernels/tma.py computes them. dtype: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t value (0 = ok).
extern "C" int tfimm_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         const int64_t* strides,
                                         const int64_t* maps, int batch,
                                         int heads, int n, int head_dim,
                                         int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || batch % heads != 0 || n <= 0 ||
      head_dim <= 0 || head_dim % 8 != 0 || head_dim > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  const Layout L{{strides[0], strides[1], strides[2]},
                 {strides[3], strides[4], strides[5]},
                 {strides[6], strides[7], strides[8]},
                 {strides[9], strides[10], strides[11]}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return head_dim <= 128
                 ? launch_f32<8>(q, k, v, L, out, lse, batch, n, head_dim,
                                 heads, s)
                 : launch_f32<16>(q, k, v, L, out, lse, batch, n, head_dim,
                                  heads, s);
    case 1: {
      // q, k, v: 16-byte loads or TMA boxes; out: TMA boxes up to d = 128,
      // 4-byte stores above.
      const int out_align = head_dim <= kTmaMaxHeadDim ? 8 : 2;
      for (int i = 0; i < 12; ++i)
        if (strides[i] % (i < 9 ? 8 : out_align) != 0)
          return (int)cudaErrorMisalignedAddress;
      const void* ptrs[4] = {q, k, v, out};
      for (int i = 0; i < 4; ++i)
        if (reinterpret_cast<uintptr_t>(ptrs[i]) % (i < 3 ? 16 : 2 * out_align) != 0)
          return (int)cudaErrorMisalignedAddress;
      return dispatch_bf16(q, k, v, L, out, lse, maps, batch, n, head_dim,
                           heads, s);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
