// Talking-head attention (CaiT) forward, straight from the packed qkv
// projection, with both (H, H) head mixes done on the chip.
//
// Replaces: tfimm_tpu/ops/pallas/cait_attention.py · talking_head_attention
// (the Pallas TPU kernel). Same function: from qkv (B, N, 3D) in timm's
// (3, H, d) order, w_l, w_w (H, H) in the (in, out) orientation of the JAX
// package's kernels and b_l, b_w (H,), all f32 or all bf16, compute out
// (B, N, D) in qkv's dtype. Per image, query q and key k, with raw_h = q_h . k_h:
//
//     s'_g = sum_h scale * w_l[h, g] * raw_h + b_l[g]             (f32)
//     p_g  = exp(min(s'_g, 80)) / rowsum               (clamped no-max softmax)
//     a_h  = sum_g w_w[g, h] * p_g                                (f32)
//     out_h = a_h.astype(dtype) @ v_h + b_w[h] * colsum(v_h)  (f32, rounded once)
//
// The (B, H, N, N) scores never reach device memory.
//
// Form. The Pallas kernel folds each mix into lane scalings of q and v, so
// that its products run over all D lanes of the TPU's 128-lane unit: 2 H N^2
// D multiply-adds an image, H times the per-head count. That exists to avoid
// d = 48 lanes on the TPU. Here the per-head form is the natural one: the
// products QK^T and PV run per head (2 N^2 d each), and the mixes couple
// the heads of one (query, key) entry, so a block owns every head of its
// tiles and mixes the H scores of an entry in registers.
//
// Two bodies. The post-softmax mix needs each p_g normalised before the
// heads mix, so both walk the keys twice: pass 1 sums the row sums l_g,
// pass 2 forms the mixed probabilities and a v.
//
// The Hopper body: bf16 with qkv contiguous and 16-byte aligned, H <= 8
// heads of d <= 64 (tma.py · cait_route: every registered CaiT below
// cait_m36, and the golden fixture's d = 8); TMA, mbarriers and wgmma from
// hopper.cuh, the shared pieces in cait_attention_common.cuh · tc. One
// block per (64 queries, image), all heads: two consumer warpgroups and a
// producer warpgroup (384 threads; setmaxnreg gives the consumers 232
// registers, the producer 40). The producer loads the block's q tiles (a
// 64-row box a head) and streams the keys through a ring of 3 stages of 16
// keys (a 16-row box a head: k in pass 1, k and v in pass 2), each stage
// completed on a "full" mbarrier by TMA's transaction count and released
// on an "empty" one by the warps that read it; its three spare warps sum
// v's columns over pass 2's stages (16-byte reads of the swizzled rows).
// Each consumer warpgroup takes 8 keys of a stage: one m64n8k16 wgmma
// group gives it the H raw scores of its four entries a thread (rows row
// and row + 8, two keys) at the same register positions of H accumulators,
// which it mixes in registers, f32: s2_g = sum_h (scale log2(e) w_l[h, g])
// raw_h + log2(e) b_l[g], with log2(e) folded into the mixes, so that
// pass 1 adds 2^min(s2_g, 80 log2(e)) to its row sums (quad shuffles and
// the two warpgroups' sums through shared memory give log2 l), and pass 2
// forms p_g = 2^(min(s2_g, 80 log2(e)) - log2 l_g), one subtraction and one
// exponential, no division, and a_h = sum_g w_w[g, h] p_g, rounded once to
// bf16 into a double-buffered shared tile (4 heads' 16 keys a 128-byte
// swizzled row). Once both warpgroups wrote theirs (a named barrier),
// each issues acc_h += a_h v_h for its H / 2 heads (wgmma with a from
// shared memory and v's 16-row tile as an MN-major B), left in flight while
// the next stage's scores are issued. At the end out_h = acc_h + b_w[h]
// colsum(v_h), rounded once, goes through the (now free) q tiles to a TMA
// store that clips rows past N and columns past d. Heads H ... NH - 1 (H
// rounded up to NH = 4, 6 or 8) have zero tiles and zero mixes. Under
// autograd (a `stats` pointer) it also writes log2 l of every row of its
// tiles, f32 (B, H, N rounded up to 64, 0 past N), so that the backward
// skips the pass that would recompute it; serving writes out alone.
//
// The first design (f32, and the bf16 calls off that route): one block of
// 256 threads per (16 queries, image), all H heads, walking the keys 16
// at a time:
// 1. raw = q k^T for every head into a shared f32 score tile; each thread
//    owns one (query, key) entry of the tile, mixes its H raw scores into
//    the H s'_g, and adds exp(min(s'_g, 80)) to its f32 row sums. The 16
//    threads of a query row then sum theirs.
// 2. raw again, then p_g = e_g / l_g and a_h = sum_g w_w[g, h] p_g, rounded
//    to the dtype, back into the score tile; then out += a v, and the block
//    sums v's columns (each column has one owner, so the sums are
//    deterministic). At the end out + b_w[h] colsum(v_h) is rounded once.
// The mixes sit in shared memory, zero-padded to NH = 8 or 16 heads so that
// the per-entry loops unroll with no test of H (cait_attention_common.cuh).
// - bf16: q, k and v tiles stay bf16 in shared memory, and q k^T and a v
//   run on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate;
//   warp w owns head w, and w + 8 when H > 8). The next k or v tile is
//   copied with cp.async while the current one is used.
// - f32: f32 tiles and scalar FMAs (the tensor cores' TF32 would miss the
//   f32 bar), loaded synchronously.
//
// What bounds it on an H100: at cait_s24_224 at batch 128 (N = 196, H = 8,
// d = 48) one call reads qkv (57.8 MB bf16) and writes out (19.3 MB): 77 MB,
// 0.023 ms at 3.35 TB/s; the per-head products and the mixes are 8.8 GFLOP,
// 0.009 ms on the tensor cores. So device memory bounds it. Both bodies are
// far from that: the mixes and the softmax are scalar f32 work per (query,
// key) entry (about 3 H^2 FMAs and 2 H exponentials an entry over the two
// passes, about 0.05-0.06 ms of the CUDA cores' issue at batch 128), and
// q k^T is computed twice. The Hopper body reads each image's k and v from
// L2 once per 64 queries (the first design once per 16), keeps the scores
// in registers and feeds every product by TMA; it took 0.23-0.24 ms
// there, out of L2 and back to back, against the first design's 0.46-0.47
// (H100 80GB HBM3 at 700 W, development builds; chip_smoke.py phase 11
// and PERF.md give the figures of record). What holds it back, from
// development builds that left parts out (before the score products were
// issued a k16 step of every head at a time, which took 4% off): the
// m64n8k16 score groups (24 a warpgroup and stage, about 50 cycles each,
// waited for before the stage's scalar work: 0.07 ms), pass 2's mixes
// (0.055 ms), pass 1's (0.037), and the rest (a v, the barriers, the
// epilogue: about 0.08); one block an SM (202 KB of shared memory), so 8
// consumer warps; the two warpgroups meet at a barrier each stage of
// pass 2, so one's scalar work never hides the other's wait.
//
// Coverage: any B (up to 65535), any N, H <= 16, d a multiple of 8 up to
// 128, D = H d <= 768 (every registered CaiT), bf16 and f32; qkv with any
// batch and row strides whose last dimension is contiguous (16-byte copies
// where qkv and its strides allow, element loads otherwise; the Hopper
// body takes contiguous qkv only); the (H, H) mixes through their strides,
// in f32 or bf16; out contiguous. Shared memory: the Hopper body 202 KB at
// NH = 8; the first design 3 row tiles and 1 score tile, 167 KB at most
// (f32, H = 16, D = 768). The launchers raise the dynamic limit first and
// return cudaGetLastError() (and the error of a tensor map that does not
// encode).

#include "cait_attention_common.cuh"

namespace {

using namespace cait;

struct FwdArgs {
  const void* qkv;
  int64_t qkv_bs, qkv_rs;
  MixSrc mix;
  void* out;              // (B, N, D) contiguous
  int n, H, d;
  float scale;
  bool vec;               // 16-byte loads of qkv (see load_rows)
};

// Pass 2 for entry e (query eq): the raw scores in s_s replaced by the
// mixed probabilities a_h = sum_g w_w[g, h] p_g, rounded to T (0 where the
// key is padding).
template <typename T, int NH>
__device__ __forceinline__ void mix_probs(const Mix& mix, float* s_s, int e,
                                          int eq, int H, bool valid,
                                          const float (*l_s)[kTile]) {
  float raw[NH], mixed[NH];
  read_entry<NH>(s_s, e, H, raw);
#pragma unroll
  for (int h = 0; h < NH; ++h) mixed[h] = 0.f;
  if (valid) {
#pragma unroll
    for (int g = 0; g < NH; ++g) {
      const float p = expf(fminf(mixed_score<NH>(mix, raw, g), kSoftmaxClamp)) /
                      l_s[g][eq];
#pragma unroll
      for (int h = 0; h < NH; ++h)
        mixed[h] = fmaf(mix.ww[g * NH + h], p, mixed[h]);
    }
  }
#pragma unroll
  for (int h = 0; h < NH; ++h)
    if (h < H) s_s[h * kScoreStride + e] = to_f32(from_f32<T>(mixed[h]));
}

// T: the io dtype; P: the tile policy (FmaTiles for f32, MmaTiles for bf16);
// NH: the padded head count of the mixes (see Mix).
template <typename T, typename P, int NH>
__global__ void __launch_bounds__(kThreads)
talking_head_fwd_kernel(FwdArgs a) {
  using Tile = typename P::Tile;
  __shared__ Mix mix;
  __shared__ float l_s[kMaxHeads][kTile];      // row sums
  __shared__ float cs[kMaxDim];                // column sums of v
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, H = a.H, d = a.d, dim = H * d;
  const int tile = H * kTile * P::ld(d);
  Tile* q_s = reinterpret_cast<Tile*>(smem_raw);    // [H][kTile][ld]
  Tile* buf[2] = {q_s + tile, q_s + 2 * tile};      // k and v tiles
  float* s_s = reinterpret_cast<float*>(q_s + 3 * tile);  // [H][kScoreStride]

  const int b = blockIdx.y, q0 = blockIdx.x * kTile;
  const T* base = static_cast<const T*>(a.qkv) + (int64_t)b * a.qkv_bs;
  const T* k_g = base + dim;
  const T* v_g = base + 2 * dim;
  load_mix<NH>(mix, a.mix, H, a.scale);
  for (int i = threadIdx.x; i < dim; i += kThreads) cs[i] = 0.f;
  P::load(base, a.qkv_rs, q0, n, H, d, q_s, a.vec);
  // This thread's entry of every score tile.
  const int eq = threadIdx.x / kTile, ek = threadIdx.x % kTile;
  const int e = eq * kTile + ek;

  // Pass 1: the row sums of exp(min(s'_g, 80)). Key tile i + 1 is copied
  // while tile i is used.
  float lsum[NH];
#pragma unroll
  for (int g = 0; g < NH; ++g) lsum[g] = 0.f;
  P::load(k_g, a.qkv_rs, 0, n, H, d, buf[0], a.vec);
  for (int i = 0, k0 = 0; k0 < n; ++i, k0 += kTile) {
    P::wait();
    __syncthreads();  // tile i landed; tile i - 1 and the entries read
    if (k0 + kTile < n)
      P::load(k_g, a.qkv_rs, k0 + kTile, n, H, d, buf[(i + 1) % 2],
                    a.vec);
    P::abt(q_s, buf[i % 2], s_s, H, d);
    __syncthreads();
    if (k0 + ek < n) add_exps<NH>(mix, s_s, e, H, lsum);
  }
  store_row_sums<NH>(lsum, eq, ek, l_s);

  // Pass 2: the mixed probabilities, times v: k tiles in buf[0], v tiles
  // in buf[1], each copied while the other is used.
  typename P::Acc acc;
  P::zero(acc);
  __syncthreads();  // pass 1's last tile read
  P::load(k_g, a.qkv_rs, 0, n, H, d, buf[0], a.vec);
  for (int k0 = 0; k0 < n; k0 += kTile) {
    P::wait();
    __syncthreads();  // k tile landed; the previous v tile read, l_s written
    P::load(v_g, a.qkv_rs, k0, n, H, d, buf[1], a.vec);
    P::abt(q_s, buf[0], s_s, H, d);
    __syncthreads();
    mix_probs<T, NH>(mix, s_s, e, eq, H, k0 + ek < n, l_s);
    P::wait();
    __syncthreads();  // v tile landed; the k tile read, mixes written
    if (k0 + kTile < n)
      P::load(k_g, a.qkv_rs, k0 + kTile, n, H, d, buf[0], a.vec);
    P::template ab<false>(s_s, buf[1], H, d, acc);
    P::colsums(buf[1], H, d, cs);
  }
  __syncthreads();
  P::store(acc, static_cast<T*>(a.out) + ((int64_t)b * n + q0) * dim, dim,
           n - q0, H, d, mix.bw, cs);
}

template <typename T, typename P, int NH>
struct Launch {
  static int run(const FwdArgs& a, int batch, cudaStream_t stream) {
    const size_t smem = smem_bytes<P>(a.H, a.d, 3, 1);
    cudaError_t err = cudaFuncSetAttribute(
        talking_head_fwd_kernel<T, P, NH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.n + kTile - 1) / kTile, batch);
    talking_head_fwd_kernel<T, P, NH><<<grid, kThreads, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
};

// ---------------------------------------------------------------------------
// bf16 on Hopper: TMA + wgmma (see the note at the top)

namespace hop {

using namespace cait::tc;

constexpr int kStages = 3;
constexpr int kABuffers = 2;
constexpr int kColsumWarps = 3;           // the producer warpgroup's spare warps
constexpr int kColsumThreads = 32 * kColsumWarps;

// Shared memory: the q tiles of every head; the ring (per stage the k
// tiles of every head, then the v tiles); two buffers of a (4 heads' 16
// keys a 128-byte row); the mix tables; the row sums of the two
// warpgroups, log2 l, the column sums of v; the barriers. 202 KB at NH = 8.
template <int NH>
struct FwdTiles {
  static constexpr int kATiles = (NH + 3) / 4;
  static constexpr int kStageBytes = 2 * NH * kKeyTile;
  static constexpr int kQ = 0;
  static constexpr int kRing = kQ + NH * kRowTile;
  static constexpr int kA = kRing + kStages * kStageBytes;
  static constexpr int kTables = kA + kABuffers * kATiles * kRowTile;
  static constexpr int kSums = kTables + (int)sizeof(Tables<NH>);
  static constexpr int kLog2l = kSums + 2 * NH * kRows * 4;
  static constexpr int kColsums = kLog2l + NH * kRows * 4;
  static constexpr int kBars = kColsums + NH * kMaxD * 4;
  // q_full, full[kStages], empty[kStages]; 1024 bytes of slack to align.
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
  static_assert(NH * kMaxD / 8 <= kColsumThreads,
                "a column-sum thread a chunk of 8 columns");
};

// NH: H rounded up to 4, 6 or 8 (the mixes' loops unroll over NH; heads
// H ... NH - 1 have zero tiles and zero mixes).
template <int NH>
__global__ void __launch_bounds__(kWgThreads, 1)
talking_head_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap rows_map,
                              const __grid_constant__ CUtensorMap keys_map,
                              const __grid_constant__ CUtensorMap out_map,
                              MixSrc mix, float* stats, int n, int H, int d,
                              float scale) {
  using L = FwdTiles<NH>;
  constexpr int S = kStages;
  constexpr int HW = NH / 2;             // output heads of a warpgroup
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* q_s = smem + L::kQ;
  uint8_t* ring = smem + L::kRing;
  uint8_t* a_s = smem + L::kA;
  Tables<NH>& tab = *reinterpret_cast<Tables<NH>*>(smem + L::kTables);
  float* sums = reinterpret_cast<float*>(smem + L::kSums);
  float* log2l = reinterpret_cast<float*>(smem + L::kLog2l);
  float* colsum = reinterpret_cast<float*>(smem + L::kColsums);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int q0 = blockIdx.x * kRows, b = blockIdx.y;
  const int T = (n + kKeys - 1) / kKeys;          // key stages of a pass
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8 + kColsumWarps);
    }
    hopper::fence_barrier_init();
  }
  load_tables<NH>(tab, mix, H, scale);
  zero_smem(q_s + H * kRowTile, q_s + NH * kRowTile);
  for (int st = 0; st < S; ++st)
    for (int p = 0; p < 2; ++p) {
      uint8_t* t = ring + st * L::kStageBytes + p * NH * kKeyTile;
      zero_smem(t + H * kKeyTile, t + NH * kKeyTile);
    }
  hopper::fence_proxy_async();
  __syncthreads();

  if (warp >= 8) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (warp == 8) {
      // Producer: q once, then k of every stage (pass 1), then k and v.
      if (lane == 0) {
        hopper::mbar_expect_tx(q_full, H * kRowTile);
        for (int h = 0; h < H; ++h)
          hopper::tma_load_5d(q_s + h * kRowTile, &rows_map, q_full, 0, h, 0,
                              q0, b);
        for (int it = 0; it < 2 * T; ++it) {
          const int st = it % S;
          if (it >= S) hopper::mbar_wait(&empty[st], ((it / S) & 1) ^ 1);
          const int parts = it < T ? 1 : 2, k0 = kKeys * (it % T);
          uint8_t* stage = ring + st * L::kStageBytes;
          hopper::mbar_expect_tx(&full[st], parts * H * kKeyTile);
          for (int p = 0; p < parts; ++p)
            for (int h = 0; h < H; ++h)
              hopper::tma_load_5d(stage + (p * NH + h) * kKeyTile, &keys_map,
                                  &full[st], 0, h, 1 + p, k0, b);
        }
      }
      return;
    }
    // Warps 9-11: the column sums of v over every key, from pass 2's
    // stages, 8 columns of one head a thread (one 16-byte chunk of each
    // swizzled row; one owner, a fixed order).
    const int chunk = threadIdx.x - 9 * 32, per_head = d / 8;
    const bool owner = chunk < H * per_head;
    const int head = owner ? chunk / per_head : 0;
    const int j8 = owner ? chunk % per_head : 0;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int it = 0; it < 2 * T; ++it) {
      const int st = it % S;
      hopper::mbar_wait(&full[st], (it / S) & 1);
      if (it >= T && owner) {
        const uint8_t* v = ring + st * L::kStageBytes + (NH + head) * kKeyTile;
#pragma unroll
        for (int r = 0; r < kKeys; ++r) {
          const uint4 u = *reinterpret_cast<const uint4*>(
              v + r * 128 + ((j8 ^ (r & 7)) << 4));
          const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[2 * k] += __uint_as_float(w[k] << 16);
            acc[2 * k + 1] += __uint_as_float(w[k] & 0xffff0000u);
          }
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }
    if (owner)
#pragma unroll
      for (int j = 0; j < 8; ++j) colsum[head * d + 8 * j8 + j] = acc[j];
    hopper::named_barrier(kBarColsums, kConsumers + kColsumThreads);
    return;
  }

  // Consumer warpgroup wg: keys 8 wg ... + 7 of each stage, output heads
  // wg HW ... + HW - 1. Thread (warp wl of the group, lane 4 g + t4) holds
  // rows row and row + 8. (Issuing stage it + 1's scores into a second
  // register set before stage it's scalar work made ptxas serialise every
  // wgmma (C7514) and took 0.39 ms against 0.24 at cait_s24 bs128, H100,
  // development builds.)
  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4, row = 16 * (warp % 4) + lane / 4, t4 = lane % 4;
  const int nb_steps = (d + 15) / 16;
  float raw[NH][4];
  // The raw scores of stage it (its ring slot full), one wgmma group. In
  // pass 2 the previous stage's a v is still in flight here: no fence
  // defines raw now (a register defined then makes ptxas serialise every
  // wgmma, C7515); the products' own operands order them after the last
  // reads of raw.
  auto issue_raw = [&](int it) {
    const uint8_t* keys = ring + (it % S) * L::kStageBytes + 1024 * wg;
    hopper::wgmma_fence();
    products_n8<NH>(raw, q_s, keys, nb_steps);
    hopper::wgmma_commit();
  };

  // Pass 1: the row sums l_g over the keys below n.
  float lsum[NH][2];
#pragma unroll
  for (int g = 0; g < NH; ++g) lsum[g][0] = lsum[g][1] = 0.f;
  hopper::mbar_wait(q_full, 0);
  for (int it = 0; it < T; ++it) {
    hopper::mbar_wait(&full[it % S], (it / S) & 1);
    issue_raw(it);
    hopper::wgmma_wait<0>();
    fence_heads<NH>(raw);
    if (lane == 0) hopper::mbar_arrive(&empty[it % S]);
    add_exp2s<NH>(tab, raw, kKeys * it + 8 * wg + 2 * t4, n, lsum);
  }
  combine_rows<NH, true>(lsum, sums, log2l, q0, n);
  // Under autograd, log2 l of every row of the block's tile (0 past n) for
  // the backward, which then skips its first pass: (B, H, N rounded up to
  // 64) f32.
  if (stats != nullptr)
    for (int i = threadIdx.x; i < H * kRows; i += kConsumers)
      stats[((int64_t)b * H + i / kRows) * gridDim.x * kRows + q0 + i % kRows] =
          log2l[i];

  // Pass 2: per stage, a_h = sum_g w_w[g][h] p_g with
  // p_g = 2^(min(s2_g, 80 log2(e)) - log2 l_g), rounded to bf16 into this
  // stage's a buffer (head h at tile h / 4, columns 16 (h % 4) + the key),
  // then, with both warpgroups' keys written, acc += a_h v_h for the
  // group's heads (a from shared memory, v MN-major), left in flight
  // while the next stage's scores are issued. Keys past n meet zero rows
  // of v. (48-column products at d = 48 spared 32 registers and no time.)
  float acc[HW][32];
#pragma unroll
  for (int i = 0; i < HW; ++i)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[i][j] = 0.f;
  auto fence_acc = [&] {
#pragma unroll
    for (int i = 0; i < HW; ++i) hopper::fence_regs(acc[i]);
  };
  // The zeros are set here, not sunk into a group in flight (C7515).
  fence_acc();
  auto issue_pv = [&](int it) {
    const uint8_t* v = ring + (it % S) * L::kStageBytes + NH * kKeyTile;
    const uint8_t* a = a_s + (it % kABuffers) * L::kATiles * kRowTile;
    fence_acc();
    hopper::wgmma_fence();
#pragma unroll
    for (int i = 0; i < HW; ++i) {
      const int h = wg * HW + i;
      hopper::wgmma_m64n64k16_ss<1>(
          acc[i], hopper::sw128_desc(a + (h / 4) * kRowTile) + 2 * (h % 4),
          hopper::sw128_desc(v + h * kKeyTile), 1);
    }
    hopper::wgmma_commit();
  };
  hopper::mbar_wait(&full[T % S], (T / S) & 1);
  for (int it = T; it < 2 * T; ++it) {
    issue_raw(it);
    hopper::wgmma_wait<0>();   // also the previous stage's a v
    fence_heads<NH>(raw);
    fence_acc();
    if (it > T && lane == 0) hopper::mbar_arrive(&empty[(it - 1) % S]);
    uint8_t* a = a_s + (it % kABuffers) * L::kATiles * kRowTile;
    {
      // The four entries at once: more independent work a head.
      float am[NH][4];
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) am[h][i] = 0.f;
#pragma unroll
      for (int g = 0; g < NH; ++g) {
        float c[NH], w[NH];
        table_row<NH>(tab.c2, g, c);
        const float l2a = log2l[g * kRows + row];
        const float l2b = log2l[g * kRows + row + 8];
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[i] = hopper::exp2_approx(
              fminf(mixed2<NH>(c, tab.bl2[g], raw, i), kClamp2) -
              (i < 2 ? l2a : l2b));
        table_row<NH>(tab.ww, g, w);
#pragma unroll
        for (int h = 0; h < NH; ++h)
#pragma unroll
          for (int i = 0; i < 4; ++i) am[h][i] = fmaf(w[h], p[i], am[h][i]);
      }
#pragma unroll
      for (int ep = 0; ep < 2; ++ep)
#pragma unroll
        for (int h = 0; h < NH; ++h)
          *reinterpret_cast<uint32_t*>(
              a + (h / 4) * kRowTile +
              hopper::sw128_offset(row + 8 * ep, (h % 4) * 8 + 4 * wg + t4)) =
              hopper::pack_bf16(am[h][2 * ep], am[h][2 * ep + 1]);
    }
    hopper::fence_proxy_async();
    hopper::named_barrier(kBarConsumers, kConsumers);
    if (it + 1 < 2 * T)
      hopper::mbar_wait(&full[(it + 1) % S], ((it + 1) / S) & 1);
    issue_pv(it);
  }
  hopper::wgmma_wait<0>();
  fence_acc();

  // out_h = acc + b_w[h] colsum(v_h), rounded once, into the (now free) q
  // tile of head h, stored by one thread of the group (the box clips rows
  // past n and columns past d).
  hopper::named_barrier(kBarConsumers, kConsumers);
  hopper::named_barrier(kBarColsums, kConsumers + kColsumThreads);
#pragma unroll
  for (int i = 0; i < HW; ++i) {
    const int h = wg * HW + i;
    if (h >= H) break;
    uint8_t* o = q_s + h * kRowTile;
    const float bias = tab.bw[h];
    const float* cs = colsum + h * d;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t4;
      const float b0 = col < d ? bias * cs[col] : 0.f;
      const float b1 = col + 1 < d ? bias * cs[col + 1] : 0.f;
      *reinterpret_cast<uint32_t*>(o + hopper::sw128_offset(row, 4 * j + t4)) =
          hopper::pack_bf16(acc[i][4 * j] + b0, acc[i][4 * j + 1] + b1);
      *reinterpret_cast<uint32_t*>(o + hopper::sw128_offset(row + 8, 4 * j + t4)) =
          hopper::pack_bf16(acc[i][4 * j + 2] + b0, acc[i][4 * j + 3] + b1);
    }
  }
  hopper::fence_proxy_async();
  hopper::named_barrier(kBarGroup + wg, 128);
  if (threadIdx.x % 128 == 0) {
    for (int i = 0; i < HW; ++i) {
      const int h = wg * HW + i;
      if (h < H)
        hopper::tma_store_4d(&out_map, q_s + h * kRowTile, 0, h, q0, b);
    }
    hopper::tma_store_commit_and_wait();
  }
}

template <int NH>
int launch_wgmma(const FwdArgs& a, const int64_t* maps, float* stats,
                 int batch, cudaStream_t stream) {
  CUtensorMap tmaps[3];
  const void* bases[3] = {a.qkv, a.qkv, a.out};
  for (int i = 0; i < 3; ++i) {
    const int err = hopper::encode_bf16_map(
        &tmaps[i], bases[i], maps + i * hopper::kGeometrySize);
    if (err != 0) return err;
  }
  constexpr int smem = FwdTiles<NH>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      talking_head_fwd_wgmma_kernel<NH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + kRows - 1) / kRows, batch);
  talking_head_fwd_wgmma_kernel<NH><<<grid, kWgThreads, smem, stream>>>(
      tmaps[0], tmaps[1], tmaps[2], a.mix, stats, a.n, a.H, a.d, a.scale);
  return (int)cudaGetLastError();
}

int launch_wgmma_nh(const FwdArgs& a, const int64_t* maps, float* stats,
                    int batch, cudaStream_t stream) {
  if (a.H <= 4) return launch_wgmma<4>(a, maps, stats, batch, stream);
  if (a.H <= 6) return launch_wgmma<6>(a, maps, stats, batch, stream);
  return launch_wgmma<8>(a, maps, stats, batch, stream);
}

}  // namespace hop

}  // namespace

// qkv: (B, N, 3 H d) with batch stride qkv_bs and row stride qkv_rs in
// elements (the last dimension contiguous); w_l, w_w (H, H) with row and
// column strides in elements, b_l, b_w (H,) contiguous, all four f32
// (mix_dtype 0) or bf16 (1); out (B, N, H d) contiguous. dtype: 0 = float32,
// 1 = bfloat16. maps: NULL for the first design's bodies, or (bf16 on the
// route of tma.py · cait_route: qkv contiguous, H <= 8, d <= 64) the
// geometries of the Hopper body's three tensor maps (tma.py · cait_maps:
// qkv in 64-row and 16-row boxes, out), hopper::kGeometrySize int64 values
// each. stats: NULL, or (with maps) f32 (B, H, N rounded up to 64) that
// takes log2 l of every row for the backward. Returns a cudaError_t value
// (0 = ok).
extern "C" int tfimm_talking_head_fwd(const void* qkv, int64_t qkv_bs,
                                      int64_t qkv_rs, const void* w_l,
                                      int64_t wl_rs, int64_t wl_cs,
                                      const void* b_l, const void* w_w,
                                      int64_t ww_rs, int64_t ww_cs,
                                      const void* b_w, int mix_dtype,
                                      void* out, int batch, int n,
                                      int nb_heads, int head_dim, float scale,
                                      int dtype, const int64_t* maps,
                                      void* stats, void* stream) {
  if (batch <= 0 || batch > 65535 || !supported(n, nb_heads, head_dim) ||
      (dtype != 0 && dtype != 1) || (mix_dtype != 0 && mix_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const FwdArgs a = {qkv, qkv_bs, qkv_rs,
                     {w_l, b_l, w_w, b_w, wl_rs, wl_cs, ww_rs, ww_cs, mix_dtype},
                     out, n, nb_heads, head_dim, scale,
                     vec_ok(qkv, qkv_bs, qkv_rs, dtype == 0 ? 4 : 2)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (maps != nullptr) {
    if (dtype != 1 || nb_heads > tc::kMaxNH || head_dim > tc::kMaxD)
      return (int)cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    return hop::launch_wgmma_nh(a, maps, static_cast<float*>(stats), batch,
                                s);
  }
  return dispatch<Launch>(dtype, head_dim, nb_heads, a, batch, s);
}
