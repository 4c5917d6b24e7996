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
// no concatenation afterwards. Scores never reach device memory. Two
// launches per call, deterministic, no atomics: (A) dq, and the row sums l
// and delta = rowsum(dp * p) for (B) in an f32 (B, H, N) scratch; (B) dk and
// dv.
//
// - bf16 (the training path), for Hopper (hopper.cuh): a block owns 64 rows
//   of one (image, head), one consumer warpgroup and one producer warp (160
//   threads), two blocks an SM. The producer TMA-loads the block's own
//   tiles once and streams the other operand through a ring of 64-row
//   stages, each signalled on a "full" mbarrier by TMA's transaction count
//   and released on an "empty" one by the consumer's warps (4 stages up to
//   d = 64, 2 above). q, k and v come through fused_mha's 5-D map of the
//   packed qkv, (d, H, 3, N, B); g through its output map, (d, H, N, B),
//   since g has the output's layout; dq, dk and dv go out by TMA stores of
//   the 5-D map over dqkv, from the consumer's own tiles, which clip rows
//   beyond N and columns beyond d. Boxes are zero-filled past N and d, so
//   padded rows and keys enter every product as zeros; only the row sum l
//   masks them.
//   (A) owns 64 query rows and streams K and V twice. Pass 1 is the
//   forward's loop: S = q k^T (wgmma, both operands K-major),
//   e = exp(min(scale S, 80)), l = sum e, and o~ = sum e v (wgmma with A
//   from registers and v as an MN-major B), with e in two bf16 parts,
//   bf16(e) and bf16(e - bf16(e)), two products. Then delta = g . o~ / l:
//   since dp = g v^T, rowsum(p * dp) = g . (p v), exactly, so the dp of a
//   third pass over the keys goes. (With one bf16 part delta carries bf16's
//   rounding, which dp - delta magnifies where it cancels: at d = 8 with
//   scores near the clamp it misses the bar; two parts hold it like f32.) Pass 2 computes S and dP = g v^T (K-major) as one group,
//   ds = where(s < 80, p * (dP - delta), 0) in registers with
//   p = 2^(min(scale log2(e) S, 80 log2(e)) - log2 l), and dq += ds k (A
//   from registers, k MN-major). log2 l and delta go to the scratch, its
//   rows padded to 64 (the wrapper's).
//   (B) owns 64 keys and streams the query tiles with their log2 l and
//   delta (two 256-byte bulk copies a stage beside the q and g boxes). Per
//   tile: S^T = k q^T and dP^T = v g^T (K-major, one group), p^T and ds^T
//   through the clamp mask (log2 l makes p one subtraction and one
//   exponential, no division), then dv += p^T g and dk += ds^T q (A from
//   registers, g and q MN-major).
//   e (in two parts), p and ds are rounded to bf16 as the A operands of
//   their products (the reference keeps them in f32); s, l, dP, delta and
//   every sum stay f32.
// - f32: plain f32 FMAs (TF32 would not hold the f32 results), 256 threads
//   as a 16 x 16 grid, each owning 4 own rows x 4 streamed columns of a
//   product and 4 own rows x up to 8 head columns of the outputs; p and ds
//   pass through shared memory. (A) streams the keys three times (l, then
//   delta from p and dp, then dq).
//
// What bounds it on an H100: at ViT-B/16 training (B = 64, N = 197, H = 12,
// d = 64) one N x N x d product is 2 * B * H * N^2 * d = 3.8 GFLOP, and the
// function needs five (19 GFLOP, 19 us at the bf16 tensor-core peak). It
// reads qkv and g (77 MB) and writes dqkv (58 MB): 135 MB, 40.5 us at 3.35
// TB/s, so the function is bound by device memory. This design does ten
// products (six in (A), four in (B)), and N = 197 rounds up to 256 rows and
// keys (41% of the exponentials are padding, as in fused_mha): 64 GFLOP,
// 65 us at the tensor cores' peak, so even at that peak it sits above the
// byte bound; the padding, the recomputation and the low part of e are
// the work past it. What holds it back beyond that: each warpgroup's chain
// (the scores, then the exponentials, then the product, each waiting for
// the last) with two warpgroups an SM to hide it, at the 168 registers a
// thread that allows (ptxas' report in chip_smoke.py's build log; the
// variants that overlapped a tile's exponentials with the previous
// product, or split the tiles into 32-key halves, or put two consumer
// warpgroups in one block, were slower in development builds). The f32
// kernels are bound by shared-memory loads feeding FMAs.
//
// Shared memory: bf16 (A) 83 KB up to d = 64 and 98 KB above, (B) the
// same; f32 100 KB at d = 64 and 166 KB at d = 128. Above the 48 KB static
// limit a launch needs the dynamic limit raised, so the launcher sets
// cudaFuncAttributeMaxDynamicSharedMemorySize before every launch and
// returns cudaGetLastError() after each (and the error of a tensor map that
// does not encode).
//
// Coverage: the forward's. Any B, any N, any H, and every head dim d that
// is a multiple of 8 up to 128. bf16 needs qkv, g and dqkv 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kRows = 64;                 // a block's own rows (f32)
constexpr int kMaxHeadDim = 128;
constexpr float kSoftmaxClamp = 80.0f;    // dispatch.py SOFTMAX_CLAMP
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma

constexpr int kTile = 64;                 // rows, streamed rows and columns
constexpr int kTileBytes = kTile * kTile * 2;
constexpr int kTmaThreads = 128 + 32;    // a consumer warpgroup, a producer warp
constexpr int kBlocksPerSm = 2;           // 10 warps: 168 registers a thread
constexpr int kStatBytes = kTile * 4;     // 64 f32 log2 l or delta values

// DC: 64-column chunks of the head dim (1 up to d = 64, 2 up to 128). Own
// tiles (A: q and g; B: k and v), then the ring's two streamed operands
// (A: k and v; B: q and g), then (B) log2 l and delta of each stage.
template <int DC>
struct BwdTiles {
  static constexpr int kStages = DC == 1 ? 4 : 2;
  static constexpr int kOwn0 = 0;
  static constexpr int kOwn1 = kOwn0 + DC * kTileBytes;
  static constexpr int kRing0 = kOwn1 + DC * kTileBytes;
  static constexpr int kRing1 = kRing0 + kStages * DC * kTileBytes;
  static constexpr int kStats = kRing1 + kStages * DC * kTileBytes;
  static constexpr int kBars = kStats + kStages * 2 * kStatBytes;
  // own_full, full[stages], empty[stages]; 1024 bytes of slack for alignment.
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// The shared memory of one block of either launch (its tiles and
// barriers) and the ring's handshakes.
template <int DC>
struct BwdBlock {
  using L = BwdTiles<DC>;
  static constexpr int kStages = L::kStages;
  uint8_t* own0;
  uint8_t* own1;
  uint8_t* ring0;
  uint8_t* ring1;
  float* stats;
  uint64_t* own_full;
  uint64_t* full;
  uint64_t* empty;

  __device__ explicit BwdBlock(uint8_t* smem_raw) {
    uint8_t* smem = hopper::align_1024(smem_raw);
    own0 = smem + L::kOwn0;
    own1 = smem + L::kOwn1;
    ring0 = smem + L::kRing0;
    ring1 = smem + L::kRing1;
    stats = reinterpret_cast<float*>(smem + L::kStats);
    own_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
    full = own_full + 1;
    empty = full + kStages;
    if (threadIdx.x == 0) {
      hopper::mbar_init(own_full, 1);
      for (int s = 0; s < kStages; ++s) {
        hopper::mbar_init(&full[s], 1);
        hopper::mbar_init(&empty[s], 4);   // one arrival a consumer warp
      }
      hopper::fence_barrier_init();
    }
    __syncthreads();
  }

  __device__ uint8_t* ring(uint8_t* base, int it, int dc) const {
    return base + ((it % kStages) * DC + dc) * kTileBytes;
  }
  // Producer: wait until ring iteration it's stage is free, and announce
  // `bytes` on its full barrier.
  __device__ void produce(int it, uint32_t bytes) const {
    const int st = it % kStages;
    if (it >= kStages) hopper::mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
    hopper::mbar_expect_tx(&full[st], bytes);
  }
  // Consumer: wait until ring iteration it's stage has arrived.
  __device__ void consume(int it) const {
    hopper::mbar_wait(&full[it % kStages], (it / kStages) & 1);
  }
  __device__ void release(int it) const {
    if (threadIdx.x % 32 == 0) hopper::mbar_arrive(&empty[it % kStages]);
  }
};

// acc (=)= A B^T over the head dim: A a warpgroup's own 64 x d tile, B a
// 64 x d tile, both K-major, as part of the caller's wgmma group. The first
// step overwrites acc.
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

// acc[dc] += X B over 64 streamed rows: X (64 x 64, bf16) from registers
// in the A layout, B a 64 x d tile read MN-major (16 rows a k16 step).
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

// The packed register of accumulator elements (4 j + 2 hi, + 1) in the A
// layout: column blocks 2 m and 2 m + 1 are the registers of k16 step m.
__device__ __forceinline__ int a_reg(int j, int hi) {
  return (j / 2) * 4 + (j % 2) * 2 + hi;
}

// e0 and e1 as the sums of two bf16 values each: hi = bf16(e) and
// lo = bf16(e - hi), packed as A registers.
__device__ __forceinline__ void split_bf16(float e0, float e1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = hopper::pack_bf16(e0, e1);
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = hopper::pack_bf16(e0 - h.x, e1 - h.y);
}

// acc * mul of a warpgroup into its own swizzled tile(s), then one thread
// stores them through the 5-D map at (64 dc, h, part, r0, b).
template <int DC>
__device__ __forceinline__ void store_tiles(const float (&acc)[DC][32],
                                            float mul, uint8_t* tile,
                                            const CUtensorMap* map, int h,
                                            int part, int r0, int b) {
  const int lane = threadIdx.x % 32;
  const int row = (threadIdx.x / 32 % 4) * 16 + lane / 4, t4 = lane % 4;
#pragma unroll
  for (int dc = 0; dc < DC; ++dc) {
    uint8_t* out = tile + dc * kTileBytes;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int j2 = 4 * j + t4;
      *reinterpret_cast<uint32_t*>(out + hopper::sw128_offset(row, j2)) =
          hopper::pack_bf16(acc[dc][4 * j] * mul, acc[dc][4 * j + 1] * mul);
      *reinterpret_cast<uint32_t*>(out + hopper::sw128_offset(row + 8, j2)) =
          hopper::pack_bf16(acc[dc][4 * j + 2] * mul, acc[dc][4 * j + 3] * mul);
    }
  }
  hopper::fence_proxy_async();
  hopper::named_barrier(1, 128);
  if (threadIdx.x == 0) {
    for (int dc = 0; dc < DC; ++dc)
      hopper::tma_store_5d(map, tile + dc * kTileBytes, kTile * dc, h, part,
                           r0, b);
    hopper::tma_store_commit_and_wait();
  }
}

// A registers of one streamed tile: two 64 x 64 bf16 operands (A: e's high
// and low parts in pass 1, ds in `a` in pass 2; B: p^T and ds^T).
struct Operands {
  uint32_t a[16], b[16];
};

__device__ __forceinline__ void fence_operands(Operands& r) {
  hopper::fence_regs(r.a);
  hopper::fence_regs(r.b);
}

// The consumer loop of either launch over ring iterations [begin, end),
// one at a time: an iteration's scores (`issue_scores`, one wgmma group)
// become its A registers (`form`), which its product (`issue_product`, one
// group) takes into the accumulators; then its ring stage is released and
// the next iteration's scores issued. `fence_all` fences every register a
// group has written or read.
template <int DC, class Fence, class Form, class Product, class Scores>
__device__ __forceinline__ void stream(const BwdBlock<DC>& blk, int begin,
                                       int end, Fence&& fence_all, Form&& form,
                                       Product&& issue_product,
                                       Scores&& issue_scores) {
  issue_scores(begin);
  for (int it = begin; it < end; ++it) {
    hopper::wgmma_wait<0>();
    fence_all();
    form(it);
    issue_product(it);
    hopper::wgmma_wait<0>();
    fence_all();
    blk.release(it);
    if (it + 1 < end) issue_scores(it + 1);
  }
}

// (A): dq, and log2 l and delta into (B, H, n_pad) f32 rows.
template <int DC>
__global__ void __launch_bounds__(kTmaThreads, kBlocksPerSm)
fused_mha_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap qkv_map,
                             const __grid_constant__ CUtensorMap g_map,
                             const __grid_constant__ CUtensorMap dqkv_map,
                             float* __restrict__ row_sum,
                             float* __restrict__ row_delta, int n, int n_pad,
                             int d, float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const BwdBlock<DC> blk(smem_raw);
  const int nb_tiles = (n + kTile - 1) / kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == 4) {
    // Producer: q and g, then K and V of every key tile, twice.
    if (lane == 0) {
      hopper::mbar_expect_tx(blk.own_full, 2 * DC * kTileBytes);
      for (int dc = 0; dc < DC; ++dc) {
        hopper::tma_load_5d(blk.own0 + dc * kTileBytes, &qkv_map, blk.own_full,
                            kTile * dc, h, 0, q0, b);
        hopper::tma_load_4d(blk.own1 + dc * kTileBytes, &g_map, blk.own_full,
                            kTile * dc, h, q0, b);
      }
      for (int it = 0; it < 2 * nb_tiles; ++it) {
        uint64_t* bar = &blk.full[it % BwdBlock<DC>::kStages];
        blk.produce(it, 2 * DC * kTileBytes);
        for (int dc = 0; dc < DC; ++dc) {
          hopper::tma_load_5d(blk.ring(blk.ring0, it, dc), &qkv_map, bar,
                              kTile * dc, h, 1, kTile * (it % nb_tiles), b);
          hopper::tma_load_5d(blk.ring(blk.ring1, it, dc), &qkv_map, bar,
                              kTile * dc, h, 2, kTile * (it % nb_tiles), b);
        }
      }
    }
    return;
  }

  const int row = warp * 16 + lane / 4;   // and row + 8
  const int t4 = lane % 4;
  const int nb_steps = (d + 15) / 16;
  const float clamp_log2 = kSoftmaxClamp * kLog2e;
  uint8_t* my_q = blk.own0;
  const uint8_t* my_g = blk.own1;

  // Scores of 64 keys (s; in pass 2 also dP = g v^T), the dq (in pass 1
  // o~) accumulators, and the A registers.
  float s[32], dp[32], acc[DC][32];
  Operands r;
  zero(s);
  zero(dp);
#pragma unroll
  for (int dc = 0; dc < DC; ++dc) zero(acc[dc]);
  auto fence_all = [&] {
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    fence_operands(r);
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) hopper::fence_regs(acc[dc]);
  };
  // Ring iteration it's scores, one wgmma group; pass 2 from nb_tiles.
  auto issue_scores = [&](int it) {
    blk.consume(it);
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
    product_abt<DC>(s, my_q, blk.ring(blk.ring0, it, 0), nb_steps);
    if (it >= nb_tiles)
      product_abt<DC>(dp, my_g, blk.ring(blk.ring1, it, 0), nb_steps);
    hopper::wgmma_commit();
  };
  // acc += (a + b) v in pass 1, acc += a k in pass 2.
  auto issue_product = [&](int it) {
    fence_operands(r);
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) hopper::fence_regs(acc[dc]);
    hopper::wgmma_fence();
    if (it >= nb_tiles) {
      product_xb<DC>(acc, r.a, blk.ring(blk.ring0, it, 0));
    } else {
      product_xb<DC>(acc, r.a, blk.ring(blk.ring1, it, 0));
      product_xb<DC>(acc, r.b, blk.ring(blk.ring1, it, 0));
    }
    hopper::wgmma_commit();
  };

  // Pass 1: l = sum e over the keys below n, o~ = sum e v with e in two
  // bf16 parts (one part alone would leave delta off by bf16's rounding,
  // which dp - delta can magnify: scores near the clamp at small d).
  float l_lo = 0.f, l_hi = 0.f;   // this lane's share of rows row, row + 8
  hopper::mbar_wait(blk.own_full, 0);
  stream(blk, 0, nb_tiles, fence_all, [&](int t) {
    const bool ragged = kTile * (t + 1) > n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = kTile * t + 8 * j + 2 * t4;
      float e0 = hopper::exp2_approx(fminf(s[4 * j] * scale_log2, clamp_log2));
      float e1 = hopper::exp2_approx(fminf(s[4 * j + 1] * scale_log2, clamp_log2));
      float e2 = hopper::exp2_approx(fminf(s[4 * j + 2] * scale_log2, clamp_log2));
      float e3 = hopper::exp2_approx(fminf(s[4 * j + 3] * scale_log2, clamp_log2));
      if (ragged) {
        if (key >= n) e0 = e2 = 0.f;
        if (key + 1 >= n) e1 = e3 = 0.f;
      }
      l_lo += e0 + e1;
      l_hi += e2 + e3;
      split_bf16(e0, e1, r.a[a_reg(j, 0)], r.b[a_reg(j, 0)]);
      split_bf16(e2, e3, r.a[a_reg(j, 1)], r.b[a_reg(j, 1)]);
    }
  }, issue_product, issue_scores);
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  const float log_lo = __log2f(l_lo), log_hi = __log2f(l_hi);

  // delta = g . o~ / l, with g read from the swizzled own tile at this
  // thread's accumulator positions.
  float dl_lo = 0.f, dl_hi = 0.f;
#pragma unroll
  for (int dc = 0; dc < DC; ++dc) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int j2 = 4 * j + t4;
      const float2 g_lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          my_g + dc * kTileBytes + hopper::sw128_offset(row, j2)));
      const float2 g_hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          my_g + dc * kTileBytes + hopper::sw128_offset(row + 8, j2)));
      dl_lo += g_lo.x * acc[dc][4 * j] + g_lo.y * acc[dc][4 * j + 1];
      dl_hi += g_hi.x * acc[dc][4 * j + 2] + g_hi.y * acc[dc][4 * j + 3];
    }
  }
  const float delta_lo = quad_sum(dl_lo) / l_lo;
  const float delta_hi = quad_sum(dl_hi) / l_hi;

  // Pass 2: dq += ds k, ds = where(s < 80, e / l * (dP - delta), 0), with
  // e / l as 2^(min(scale log2(e) s, 80 log2(e)) - log2 l). Keys at or
  // beyond n meet zero rows of k.
#pragma unroll
  for (int dc = 0; dc < DC; ++dc) zero(acc[dc]);
  stream(blk, nb_tiles, 2 * nb_tiles, fence_all, [&](int) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xl = s[4 * j + i] * scale_log2;
        const float p = hopper::exp2_approx(fminf(xl, clamp_log2) -
                                            (i < 2 ? log_lo : log_hi));
        const float delta = i < 2 ? delta_lo : delta_hi;
        ds[i] = xl < clamp_log2 ? p * (dp[4 * j + i] - delta) : 0.f;
      }
      r.a[a_reg(j, 0)] = hopper::pack_bf16(ds[0], ds[1]);
      r.a[a_reg(j, 1)] = hopper::pack_bf16(ds[2], ds[3]);
    }
  }, issue_product, issue_scores);

  const int row_lo = q0 + row;
  if (t4 == 0) {
    const int64_t base = ((int64_t)b * gridDim.y + h) * n_pad;
    row_sum[base + row_lo] = log_lo;
    row_sum[base + row_lo + 8] = log_hi;
    row_delta[base + row_lo] = delta_lo;
    row_delta[base + row_lo + 8] = delta_hi;
  }
  // The q tile is free once every warp of the group is past its last
  // product; it takes dq.
  hopper::named_barrier(1, 128);
  store_tiles<DC>(acc, scale, my_q, &dqkv_map, h, 0, q0, b);
}

// (B): dk and dv, from the log2 l and delta that (A) wrote.
template <int DC>
__global__ void __launch_bounds__(kTmaThreads, kBlocksPerSm)
fused_mha_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap qkv_map,
                              const __grid_constant__ CUtensorMap g_map,
                              const __grid_constant__ CUtensorMap dqkv_map,
                              const float* __restrict__ row_sum,
                              const float* __restrict__ row_delta, int n,
                              int n_pad, int d, float scale,
                              float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const BwdBlock<DC> blk(smem_raw);
  const int nb_tiles = (n + kTile - 1) / kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == 4) {
    // Producer: k and v, then q, g, log2 l and delta of every query tile.
    if (lane == 0) {
      hopper::mbar_expect_tx(blk.own_full, 2 * DC * kTileBytes);
      for (int dc = 0; dc < DC; ++dc) {
        hopper::tma_load_5d(blk.own0 + dc * kTileBytes, &qkv_map, blk.own_full,
                            kTile * dc, h, 1, k0, b);
        hopper::tma_load_5d(blk.own1 + dc * kTileBytes, &qkv_map, blk.own_full,
                            kTile * dc, h, 2, k0, b);
      }
      const int64_t base = ((int64_t)b * gridDim.y + h) * n_pad;
      for (int t = 0; t < nb_tiles; ++t) {
        uint64_t* bar = &blk.full[t % BwdBlock<DC>::kStages];
        blk.produce(t, 2 * DC * kTileBytes + 2 * kStatBytes);
        for (int dc = 0; dc < DC; ++dc) {
          hopper::tma_load_5d(blk.ring(blk.ring0, t, dc), &qkv_map, bar,
                              kTile * dc, h, 0, kTile * t, b);
          hopper::tma_load_4d(blk.ring(blk.ring1, t, dc), &g_map, bar,
                              kTile * dc, h, kTile * t, b);
        }
        float* stats = blk.stats + (t % BwdBlock<DC>::kStages) * 2 * kTile;
        hopper::bulk_load(stats, row_sum + base + kTile * t, kStatBytes, bar);
        hopper::bulk_load(stats + kTile, row_delta + base + kTile * t,
                          kStatBytes, bar);
      }
    }
    return;
  }

  const int t4 = threadIdx.x % 4;
  const int nb_steps = (d + 15) / 16;
  const float clamp_log2 = kSoftmaxClamp * kLog2e;
  uint8_t* my_k = blk.own0;
  uint8_t* my_v = blk.own1;

  // S^T and dP^T of 64 queries, the dk and dv accumulators, and p^T and
  // ds^T as bf16 A registers (a and b).
  float s[32], dp[32], dk[DC][32], dv[DC][32];
  Operands r;
  zero(s);
  zero(dp);
#pragma unroll
  for (int dc = 0; dc < DC; ++dc) {
    zero(dk[dc]);
    zero(dv[dc]);
  }
  auto fence_all = [&] {
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    fence_operands(r);
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      hopper::fence_regs(dk[dc]);
      hopper::fence_regs(dv[dc]);
    }
  };
  // S^T = k q^T and dP^T = v g^T of query tile t, one wgmma group.
  auto issue_scores = [&](int t) {
    blk.consume(t);
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
    product_abt<DC>(s, my_k, blk.ring(blk.ring0, t, 0), nb_steps);
    product_abt<DC>(dp, my_v, blk.ring(blk.ring1, t, 0), nb_steps);
    hopper::wgmma_commit();
  };
  // dv += p^T g and dk += ds^T q.
  auto issue_product = [&](int t) {
    fence_operands(r);
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      hopper::fence_regs(dk[dc]);
      hopper::fence_regs(dv[dc]);
    }
    hopper::wgmma_fence();
    product_xb<DC>(dv, r.a, blk.ring(blk.ring1, t, 0));
    product_xb<DC>(dk, r.b, blk.ring(blk.ring0, t, 0));
    hopper::wgmma_commit();
  };

  // Query rows at or beyond n: q and g are zero rows, and their l (finite,
  // from (A)'s padded rows) and delta (0) give them no weight.
  hopper::mbar_wait(blk.own_full, 0);
  stream(blk, 0, nb_tiles, fence_all, [&](int t) {
    const float* log_l = blk.stats + (t % BwdBlock<DC>::kStages) * 2 * kTile;
    const float* delta = log_l + kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t4;   // the tile's queries col, col + 1
      const float2 ll = *reinterpret_cast<const float2*>(log_l + col);
      const float2 dl = *reinterpret_cast<const float2*>(delta + col);
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xl = s[4 * j + i] * scale_log2;
        p[i] = hopper::exp2_approx(fminf(xl, clamp_log2) -
                                   (i % 2 ? ll.y : ll.x));
        ds[i] = xl < clamp_log2 ? p[i] * (dp[4 * j + i] - (i % 2 ? dl.y : dl.x))
                                : 0.f;
      }
      r.a[a_reg(j, 0)] = hopper::pack_bf16(p[0], p[1]);
      r.a[a_reg(j, 1)] = hopper::pack_bf16(p[2], p[3]);
      r.b[a_reg(j, 0)] = hopper::pack_bf16(ds[0], ds[1]);
      r.b[a_reg(j, 1)] = hopper::pack_bf16(ds[2], ds[3]);
    }
  }, issue_product, issue_scores);

  // The own tiles are free once every warp of the group is past its last
  // product; they take dk and dv.
  hopper::named_barrier(1, 128);
  store_tiles<DC>(dk, scale, my_k, &dqkv_map, h, 1, k0, b);
  store_tiles<DC>(dv, 1.f, my_v, &dqkv_map, h, 2, k0, b);
}

template <int DC>
int launch_bf16(const void* qkv, const void* grad, void* dqkv, float* row_sum,
                float* row_delta, const int64_t* maps, int batch, int n,
                int nb_heads, int d, float scale, cudaStream_t stream) {
  // qkv and dqkv share the first geometry, g (the output's layout) takes
  // the second.
  CUtensorMap tmaps[3];
  const void* bases[3] = {qkv, grad, dqkv};
  const int geometry[3] = {0, 1, 0};
  for (int i = 0; i < 3; ++i) {
    const int err = hopper::encode_bf16_map(
        &tmaps[i], bases[i], maps + geometry[i] * hopper::kGeometrySize);
    if (err != 0) return err;
  }
  constexpr int smem = BwdTiles<DC>::kBytes;
  const int n_pad = (n + kTile - 1) / kTile * kTile;
  const dim3 grid(n_pad / kTile, nb_heads, batch);
  const float scale_log2 = scale * kLog2e;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mha_bwd_dq_bf16_kernel<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  fused_mha_bwd_dq_bf16_kernel<DC><<<grid, kTmaThreads, smem, stream>>>(
      tmaps[0], tmaps[1], tmaps[2], row_sum, row_delta, n, n_pad, d, scale,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fused_mha_bwd_dkv_bf16_kernel<DC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_mha_bwd_dkv_bf16_kernel<DC><<<grid, kTmaThreads, smem, stream>>>(
      tmaps[0], tmaps[1], tmaps[2], row_sum, row_delta, n, n_pad, d, scale,
      scale_log2);
  return (int)cudaGetLastError();
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

// dtype: 0 = float32, 1 = bfloat16. row_sum and row_delta: f32 scratch,
// (B, H, N) in f32 and (B, H, N rounded up to 64) in bf16, where row_sum
// takes log2 of the row sums. maps (bf16
// only): the geometries of the qkv (and dqkv) and g tensor maps,
// hopper::kGeometrySize int64 values each, as
// tfimm_tpu_torch/ops/kernels/tma.py · fused_mha_maps computes them. Returns a cudaError_t
// value (0 = ok).
extern "C" int tfimm_fused_mha_bwd(const void* qkv, const void* grad,
                                   void* dqkv, void* row_sum, void* row_delta,
                                   const int64_t* maps, int batch, int n,
                                   int nb_heads, int head_dim, float scale,
                                   int dtype, void* stream) {
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
    case 1: {
      const void* ptrs[5] = {qkv, grad, dqkv, row_sum, row_delta};
      for (const void* p : ptrs)
        if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
          return (int)cudaErrorMisalignedAddress;
      if (maps == nullptr) return (int)cudaErrorInvalidValue;
      if (head_dim <= kTile)
        return launch_bf16<1>(qkv, grad, dqkv, l, dl, maps, batch, n,
                              nb_heads, head_dim, scale, s);
      return launch_bf16<2>(qkv, grad, dqkv, l, dl, maps, batch, n, nb_heads,
                            head_dim, scale, s);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
