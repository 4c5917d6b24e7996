// Backward of the talking-head attention (CaiT), straight into the packed
// qkv layout, with the gradients of both (H, H) mixes.
//
// Replaces: tfimm_tpu/ops/pallas/cait_attention.py · _thattn_bwd_call (the
// Pallas TPU backward of talking_head_diff). Same function: from qkv
// (B, N, 3D), the f32 mixes w_l, b_l, w_w, b_w and g = dL/dout (B, N, D),
// compute dqkv (B, N, 3D) in qkv's layout and dtype, and dw_l, dw_w (H, H)
// and db_w (H,) in f32, summed over the batch (db_l is exactly zero: the
// softmax is shift-invariant, and the wrapper returns zeros as the JAX
// package does). With the forward's raw_h, s'_g, p_g, a_h (cait_attention.cu),
// recomputed, and nothing stored by the forward:
//
//     da_h  = g_h v_h^T                         dv_h = a_h^T g_h + b_w[h] colsum(g_h)
//     dp_g  = sum_h w_w[g, h] da_h              dw_w[g, h] = sum p_g da_h
//     delta_g = rowsum(p_g dp_g)                db_w[h] = sum colsum(g_h) . colsum(v_h)
//     ds_g  = where(s'_g < 80, p_g (dp_g - delta_g), 0)      (clamp mask)
//     draw_h = sum_g scale w_l[h, g] ds_g       dw_l[h, g] = sum scale raw_h ds_g
//     dq_h  = draw_h k_h,   dk_h = draw_h^T q_h
//
// In f32 every product and sum is f32, as in the JAX backward. In bf16
// the raw scores and da come from bf16 q, k, v and g with f32 sums (exact
// products), so s', p, ds, delta and both mix gradients are as in f32; a_h
// and draw_h are rounded to bf16 before the products dv = a^T g, dq =
// draw k and dk = draw^T q (the tensor cores take bf16 operands), where
// the JAX backward keeps them f32.
//
// Every body runs without atomics: the mix gradients' partials of each
// block are summed in a fixed order by a last launch (mix_sum_kernel: a
// block an output, a fixed tree), so two calls give bit-identical results.
//
// The Hopper body: bf16 on the forward's route (tma.py · cait_route: qkv
// and g contiguous and 16-byte aligned, H <= 8 heads of d <= 64), TMA,
// mbarriers and wgmma from hopper.cuh. It splits the work into query rows
// and key rows as the first design does, but hands a and draw from the
// first launch to the second in a bf16 scratch (2, B, H, N, N rounded up
// to 8: tma.py · cait_scratch_map), rounded as the products take them,
// where the first design recomputes them from l and delta: the second
// launch's dk and dv of all H heads (2 H 64 x d f32 accumulators a 64-key
// tile, 512 registers a thread of one warpgroup at H = 8) do not fit
// beside the per-entry mixes, and the scratch costs two writes and reads
// of B H N^2 bf16 values (80 MB at batch 64, about 0.05 ms of device
// memory) instead.
// (A) Query rows: one block per (64 queries, image), all heads: two
//     consumer warpgroups (240 registers by setmaxnreg) and a producer
//     warpgroup (24) that loads the block's q and g tiles and streams k
//     (then k and v) through a ring of 2 stages of 16 keys, as the forward
//     does. Each consumer warpgroup takes 8 keys of a stage; one wgmma group
//     (m64n8k16) gives a thread the H raw scores and the H da = g v^T of its
//     four entries, which it mixes in registers, f32, in three passes over
//     the keys: l (log2 l); then dp_g = sum_h w_w[g, h] da_h,
//     delta_g = rowsum(p_g dp_g), dw_w[g, h] += p_g da_h and a_h, rounded
//     to bf16 into the scratch; then ds_g = where(s2_g < 80 log2(e),
//     p_g (dp_g - delta_g), 0), draw_h = sum_g scale w_l[h, g] ds_g, rounded
//     into the scratch, and dw_l[h, g] += raw_h ds_g. p is 2^(min(s2, 80
//     log2(e)) - log2 l) with log2(e) folded into the mixes, as in the
//     forward. The mix-gradient sums are H^2 registers a thread, summed
//     over each warp with shuffles and over the block's 8 warps in order:
//     one partial a block, no pass over staged tiles. l and delta stay in
//     shared memory (rows past N get log2 l = 0 and delta = 0, finite, so
//     that p of a padded row is finite and meets zero rows of q and g).
//     Under autograd the forward's Hopper body hands over log2 l, f32
//     (B, H, N rounded up to 64), every row written (0 past N), and (A)
//     skips its first pass (kSaved), with the same l bit for bit.
// (B) One block of a consumer warpgroup and a producer warp per (64 rows,
//     head, image), in two kinds: key blocks stream the query tiles of a
//     and draw (64 x 64 boxes of the scratch, zeros past N) with q and g
//     for dk += draw^T q and dv += a^T g (wgmma with A read M-major from
//     the scratch's tiles, q and g MN-major), then add b_w[h] colsum(g)
//     (summed from the g tiles as they pass) and write db_w's partial;
//     query blocks stream the key tiles of draw and k for dq += draw k.
//     dq, dk and dv leave by TMA stores into dqkv.
//
// The first design (f32, and the bf16 calls off that route): three
// launches.
// 1. Query rows: one block of 256 threads per (16 queries, image), all H
//    heads, walking the keys 16 at a time in three passes: the row sums
//    l_g; then delta_g, with dw_w's sum; then ds, dq and dw_l's sum. l and
//    delta go to a scratch (2, B, H, N) for launch 2. Each thread owns one
//    (query, key) entry of a tile and holds its H raw scores, H da values
//    and the mixes' results in registers. The mix gradients are sums over
//    every (image, query, key): each thread of the block owns one (g, h)
//    pair (and a share of the tile's entries when H^2 < 256) and adds the
//    tile's products, staged in shared memory, in a fixed order; at the end
//    the shares are summed in order into one partial per block.
// 2. Key rows: one block per (16 keys, image) walks the queries 16 at a
//    time with l and delta from launch 1, recomputes p, a and ds^T, and
//    accumulates dk and dv (4 keys x 1 column a thread, in registers), the
//    column sums of g and one partial of db_w per block.
// 3. The partials summed over the blocks in a fixed order.
// The tiles and products follow the forward's policies: bf16 tiles (copied
// with cp.async, waited for at once) and mma.sync in bf16, f32 tiles and
// scalar FMAs in f32.
//
// What bounds it on an H100: at cait_s24_224 in training (B = 64, N = 196,
// H = 8, d = 48) one call reads qkv and g and writes dqkv, 7 B N D 2 bytes =
// 67 MB, 0.020 ms at 3.35 TB/s; its per-head products (q k^T, g v^T, dq,
// dk, dv) are 5 x 2 B H N^2 d = 9.4 GFLOP, 0.010 ms on the tensor cores.
// Device memory bounds it. Both bodies are far from that: the mixes and
// the softmax are scalar f32 work per entry (in the Hopper body about
// 7 H^2 FMAs and 3 H exponentials an entry over launch A's three passes),
// q k^T is computed three times and g v^T twice. The Hopper body took
// about 0.43 ms out of L2 there (launch A 0.34, launch B 0.09), 0.37 with
// the forward's log2 l, the first design 1.25 (H100 80GB HBM3 at 700 W,
// development builds; chip_smoke.py phase 13 and PERF.md give the figures
// of record). What holds launch A
// back: one block an SM (206 KB of shared memory), 8 consumer warps, each
// stage's products waited for before its scalar work, and the two row
// halves of a thread's entries worked one after the other (interleaved,
// ptxas spilled 1.8 KB at H = 8).
//
// Coverage: the forward's (any B up to 65535, any N, H <= 16, d a multiple
// of 8 up to 128, D <= 768, bf16 and f32, qkv and the mixes through their
// strides); g contiguous (B, N, D); dqkv written contiguous. Shared memory:
// the Hopper body's (A) 206 KB at NH = 8, (B) 109 KB (two blocks an SM);
// the first design's launch 1 3 row tiles and 3 score tiles, 200 KB at most
// (f32, H = 16, D = 768). Every launch is followed by cudaGetLastError().

#include "cait_attention_common.cuh"

namespace {

using namespace cait;

struct BwdArgs {
  const void* qkv;
  int64_t qkv_bs, qkv_rs;
  MixSrc mix;
  const void* g;          // (B, N, D) contiguous
  void* dqkv;             // (B, N, 3D) contiguous
  float* stats;           // (2, B, H, N): l, delta
  float* part_rows;       // (B * tiles, 2 H^2): dw_l (h, g), dw_w (g, h)
  float* part_keys;       // (B * tiles, H): db_w
  int batch, n, H, d;
  float scale;
  bool vec_qkv, vec_g;    // 16-byte loads (see load_rows)
};

// p_g of this thread's entry from its raw scores (0 where the entry is
// padding); s'_g into s.
template <int NH>
__device__ __forceinline__ float prob(const Mix& mix, const float* raw, int g,
                                      bool valid, float l, float& s) {
  s = mixed_score<NH>(mix, raw, g);
  return valid ? expf(fminf(s, kSoftmaxClamp)) / l : 0.f;
}

// dp_g = sum_h w_w[g, h] da_h.
template <int NH>
__device__ __forceinline__ float mixed_grad(const Mix& mix, const float* da,
                                            int g) {
  float dp = 0.f;
#pragma unroll
  for (int h = 0; h < NH; ++h) dp = fmaf(mix.ww[g * NH + h], da[h], dp);
  return dp;
}

// This thread's share of a mix gradient over one score tile:
// sum_e X[x][e] * Y[y][e] for its pair (x, y) = (pair / H, pair % H).
__device__ __forceinline__ float pair_dot(const float* X, const float* Y,
                                          int H, int pair, int part,
                                          int parts) {
  const float* x = X + (pair / H) * kScoreStride;
  const float* y = Y + (pair % H) * kScoreStride;
  float sum = 0.f;
  for (int e = part; e < kTile * kTile; e += parts) sum = fmaf(x[e], y[e], sum);
  return sum;
}

// T: the io dtype; P: the tile policy (FmaTiles for f32, MmaTiles for bf16).
template <typename T, typename P, int NH>
__global__ void __launch_bounds__(kThreads)
rows_kernel(BwdArgs a) {
  using Tile = typename P::Tile;
  __shared__ Mix mix;
  __shared__ float l_s[kMaxHeads][kTile], dl_s[kMaxHeads][kTile];
  __shared__ float red[2][kThreads];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, H = a.H, d = a.d, dim = H * d;
  const int tile = H * kTile * P::ld(d), score = H * kScoreStride;
  Tile* q_s = reinterpret_cast<Tile*>(smem_raw);
  Tile* g_s = q_s + tile;
  Tile* kv_s = g_s + tile;                   // k or v
  float* raw_s = reinterpret_cast<float*>(kv_s + tile);
  float* da_s = raw_s + score;               // da, then draw
  float* x_s = da_s + score;                 // p, then ds

  const int b = blockIdx.y, q0 = blockIdx.x * kTile;
  const T* base = static_cast<const T*>(a.qkv) + (int64_t)b * a.qkv_bs;
  const T* gb = static_cast<const T*>(a.g) + (int64_t)b * n * dim;
  load_mix<NH>(mix, a.mix, H, a.scale);
  P::load(base, a.qkv_rs, q0, n, H, d, q_s, a.vec_qkv);
  P::load(gb, dim, q0, n, H, d, g_s, a.vec_g);
  const int eq = threadIdx.x / kTile, ek = threadIdx.x % kTile;
  const int e = eq * kTile + ek;
  const bool qok = q0 + eq < n;
  // This thread's (g, h) pair of the mix gradients and its share of a tile.
  const int pairs = H * H, parts = kThreads / pairs;
  const bool owner = threadIdx.x < parts * pairs;
  const int pair = threadIdx.x % pairs, part = threadIdx.x / pairs;
  float dww_acc = 0.f, dwl_acc = 0.f;
  float raw[NH], da[NH];

  // Pass 1: the row sums l_g.
  float sum[NH];
#pragma unroll
  for (int g = 0; g < NH; ++g) sum[g] = 0.f;
  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();
    P::load(base + dim, a.qkv_rs, k0, n, H, d, kv_s, a.vec_qkv);
    P::wait();
    __syncthreads();
    P::abt(q_s, kv_s, raw_s, H, d);
    __syncthreads();
    if (k0 + ek < n) add_exps<NH>(mix, raw_s, e, H, sum);
  }
  store_row_sums<NH>(sum, eq, ek, l_s);
  __syncthreads();
  float* stats = a.stats + (int64_t)b * H * n;
  for (int i = threadIdx.x; i < H * kTile; i += kThreads)
    if (q0 + i % kTile < n)
      stats[(int64_t)(i / kTile) * n + q0 + i % kTile] = l_s[i / kTile][i % kTile];
  float l[NH];
#pragma unroll
  for (int g = 0; g < NH; ++g) {
    l[g] = l_s[g][eq];
    sum[g] = 0.f;
  }

  // Pass 2: delta_g = rowsum(p_g dp_g), and dw_w's sum of p_g da_h.
  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();  // the previous tile read
    P::load(base + dim, a.qkv_rs, k0, n, H, d, kv_s, a.vec_qkv);
    P::wait();
    __syncthreads();
    P::abt(q_s, kv_s, raw_s, H, d);
    __syncthreads();
    P::load(base + 2 * dim, a.qkv_rs, k0, n, H, d, kv_s, a.vec_qkv);
    P::wait();
    __syncthreads();
    P::abt(g_s, kv_s, da_s, H, d);
    __syncthreads();
    read_entry<NH>(raw_s, e, H, raw);
    read_entry<NH>(da_s, e, H, da);
#pragma unroll
    for (int g = 0; g < NH; ++g) {
      float sg;
      const float p = prob<NH>(mix, raw, g, qok && k0 + ek < n, l[g], sg);
      sum[g] = fmaf(p, mixed_grad<NH>(mix, da, g), sum[g]);
      if (g < H) x_s[g * kScoreStride + e] = p;
    }
    __syncthreads();
    if (owner) dww_acc += pair_dot(x_s, da_s, H, pair, part, parts);
  }
  store_row_sums<NH>(sum, eq, ek, dl_s);
  __syncthreads();
  float* deltas = a.stats + ((int64_t)a.batch + b) * H * n;
  for (int i = threadIdx.x; i < H * kTile; i += kThreads)
    if (q0 + i % kTile < n)
      deltas[(int64_t)(i / kTile) * n + q0 + i % kTile] =
          dl_s[i / kTile][i % kTile];

  // Pass 3: ds, dq = draw k, and dw_l's sum of raw_h ds_g.
  typename P::Acc acc;
  P::zero(acc);
  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();
    P::load(base + 2 * dim, a.qkv_rs, k0, n, H, d, kv_s, a.vec_qkv);
    P::wait();
    __syncthreads();
    P::abt(g_s, kv_s, da_s, H, d);
    __syncthreads();
    P::load(base + dim, a.qkv_rs, k0, n, H, d, kv_s, a.vec_qkv);
    P::wait();
    __syncthreads();
    P::abt(q_s, kv_s, raw_s, H, d);
    __syncthreads();
    read_entry<NH>(raw_s, e, H, raw);
    read_entry<NH>(da_s, e, H, da);
    float draw[NH];
#pragma unroll
    for (int h = 0; h < NH; ++h) draw[h] = 0.f;
#pragma unroll
    for (int g = 0; g < NH; ++g) {
      float sg;
      const float p = prob<NH>(mix, raw, g, qok && k0 + ek < n, l[g], sg);
      const float dp = mixed_grad<NH>(mix, da, g);
      const float ds = sg < kSoftmaxClamp ? p * (dp - dl_s[g][eq]) : 0.f;
      if (g < H) x_s[g * kScoreStride + e] = ds;
#pragma unroll
      for (int h = 0; h < NH; ++h) draw[h] = fmaf(mix.c[h * NH + g], ds, draw[h]);
    }
#pragma unroll
    for (int h = 0; h < NH; ++h)
      if (h < H) da_s[h * kScoreStride + e] = draw[h];
    __syncthreads();
    if (owner) dwl_acc += pair_dot(x_s, raw_s, H, pair, part, parts);
    P::template ab<false>(da_s, kv_s, H, d, acc);
  }

  // dq into the first third of dqkv.
  P::store(acc, static_cast<T*>(a.dqkv) + ((int64_t)b * n + q0) * 3 * dim,
           3 * dim, n - q0, H, d, mix.bw, nullptr);
  // The block's partial mix gradients: the shares of each pair in order.
  red[0][threadIdx.x] = dwl_acc;
  red[1][threadIdx.x] = dww_acc;
  __syncthreads();
  float* part_out =
      a.part_rows + ((int64_t)b * gridDim.x + blockIdx.x) * 2 * pairs;
  if (threadIdx.x < pairs) {
    float wl = 0.f, ww = 0.f;
    for (int k = 0; k < parts; ++k) {
      wl += red[0][k * pairs + threadIdx.x];
      ww += red[1][k * pairs + threadIdx.x];
    }
    // pair (x, y) of dw_l's products is (g, h) of raw_h ds_g: dw_l[h][g].
    const int x = threadIdx.x / H, y = threadIdx.x % H;
    part_out[y * H + x] = a.scale * wl;
    part_out[pairs + threadIdx.x] = ww;   // dw_w[g][h], (g, h) = (x, y)
  }
}

template <typename T, typename P, int NH>
__global__ void __launch_bounds__(kThreads)
keys_kernel(BwdArgs a) {
  using Tile = typename P::Tile;
  __shared__ Mix mix;
  __shared__ float l_s[kMaxHeads][kTile], dl_s[kMaxHeads][kTile];
  __shared__ float gcol[kMaxDim], vcol[kMaxDim];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, H = a.H, d = a.d, dim = H * d;
  const int tile = H * kTile * P::ld(d), score = H * kScoreStride;
  Tile* k_s = reinterpret_cast<Tile*>(smem_raw);
  Tile* v_s = k_s + tile;
  Tile* x_s = v_s + tile;                    // q or g of a query tile
  float* raw_s = reinterpret_cast<float*>(x_s + tile);  // raw, then a
  float* da_s = raw_s + score;               // da, then draw

  const int b = blockIdx.y, k0 = blockIdx.x * kTile;
  const T* base = static_cast<const T*>(a.qkv) + (int64_t)b * a.qkv_bs;
  const T* gb = static_cast<const T*>(a.g) + (int64_t)b * n * dim;
  const float* l_g = a.stats + (int64_t)b * H * n;
  const float* dl_g = a.stats + ((int64_t)a.batch + b) * H * n;
  load_mix<NH>(mix, a.mix, H, a.scale);
  for (int i = threadIdx.x; i < dim; i += kThreads) gcol[i] = vcol[i] = 0.f;
  P::load(base + dim, a.qkv_rs, k0, n, H, d, k_s, a.vec_qkv);
  P::load(base + 2 * dim, a.qkv_rs, k0, n, H, d, v_s, a.vec_qkv);
  // Score tiles are indexed [query][key]: this thread's entry.
  const int eq = threadIdx.x / kTile, ek = threadIdx.x % kTile;
  const int e = eq * kTile + ek;
  const bool kok = k0 + ek < n;
  typename P::Acc dk, dv;
  P::zero(dk);
  P::zero(dv);
  float raw[NH], da[NH];

  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();  // the previous query tile read
    P::load(base, a.qkv_rs, q0, n, H, d, x_s, a.vec_qkv);
    for (int i = threadIdx.x; i < NH * kTile; i += kThreads) {
      const int g = i / kTile, r = i % kTile;
      const bool ok = q0 + r < n && g < H;
      l_s[g][r] = ok ? l_g[(int64_t)g * n + q0 + r] : 1.f;
      dl_s[g][r] = ok ? dl_g[(int64_t)g * n + q0 + r] : 0.f;
    }
    P::wait();
    __syncthreads();
    P::abt(x_s, k_s, raw_s, H, d);
    __syncthreads();
    P::load(gb, dim, q0, n, H, d, x_s, a.vec_g);
    P::wait();
    __syncthreads();
    P::abt(x_s, v_s, da_s, H, d);
    P::colsums(x_s, H, d, gcol);
    __syncthreads();
    read_entry<NH>(raw_s, e, H, raw);
    read_entry<NH>(da_s, e, H, da);
    const bool valid = q0 + eq < n && kok;
    float mixed[NH], draw[NH];
#pragma unroll
    for (int h = 0; h < NH; ++h) mixed[h] = draw[h] = 0.f;
#pragma unroll
    for (int g = 0; g < NH; ++g) {
      float sg;
      const float p = prob<NH>(mix, raw, g, valid, l_s[g][eq], sg);
      const float dp = mixed_grad<NH>(mix, da, g);
      const float ds = sg < kSoftmaxClamp ? p * (dp - dl_s[g][eq]) : 0.f;
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        mixed[h] = fmaf(mix.ww[g * NH + h], p, mixed[h]);
        draw[h] = fmaf(mix.c[h * NH + g], ds, draw[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < NH; ++h)
      if (h < H) {
        raw_s[h * kScoreStride + e] = mixed[h];
        da_s[h * kScoreStride + e] = draw[h];
      }
    __syncthreads();
    P::template ab<true>(raw_s, x_s, H, d, dv);     // dv += a^T g
    __syncthreads();
    P::load(base, a.qkv_rs, q0, n, H, d, x_s, a.vec_qkv);
    P::wait();
    __syncthreads();
    P::template ab<true>(da_s, x_s, H, d, dk);      // dk += draw^T q
  }

  // dk, and dv with b_w[h] times the column sums of g (over every query).
  P::colsums(v_s, H, d, vcol);
  __syncthreads();
  T* out = static_cast<T*>(a.dqkv) + ((int64_t)b * n + k0) * 3 * dim;
  P::store(dk, out + dim, 3 * dim, n - k0, H, d, mix.bw, nullptr);
  P::store(dv, out + 2 * dim, 3 * dim, n - k0, H, d, mix.bw, gcol);
  // db_w's partial: sum over each head's columns, in order, of the column
  // sums of g times those of this key tile's v.
  if (threadIdx.x < H) {
    float sum = 0.f;
    for (int c = threadIdx.x * d; c < (threadIdx.x + 1) * d; ++c)
      sum += gcol[c] * vcol[c];
    a.part_keys[((int64_t)b * gridDim.x + blockIdx.x) * H + threadIdx.x] = sum;
  }
}

// mix_out = [dw_l (H, H), dw_w (H, H), db_w (H,), db_l (H,)]: one block an
// output; thread t sums the partials of blocks t, t + 128, ... in order,
// then the block adds the 128 sums in a fixed tree; db_l exact zeros.
constexpr int kSumThreads = 128;

__global__ void __launch_bounds__(kSumThreads)
mix_sum_kernel(const float* __restrict__ part_rows,
               const float* __restrict__ part_keys, float* __restrict__ out,
               int blocks, int H) {
  __shared__ float red[kSumThreads];
  const int i = blockIdx.x, t = threadIdx.x;
  const int rows = 2 * H * H;
  if (i >= rows + H) {
    if (t == 0) out[i] = 0.f;
    return;
  }
  const float* src = i < rows ? part_rows + i : part_keys + (i - rows);
  const int stride = i < rows ? rows : H;
  float acc = 0.f;
  for (int k = t; k < blocks; k += kSumThreads)
    acc += src[(int64_t)k * stride];
  red[t] = acc;
  __syncthreads();
#pragma unroll
  for (int off = kSumThreads / 2; off > 0; off >>= 1) {
    if (t < off) red[t] += red[t + off];
    __syncthreads();
  }
  if (t == 0) out[i] = red[0];
}

template <typename T, typename P, int NH>
struct Launch {
  static int run(const BwdArgs& a, cudaStream_t stream) {
    const dim3 grid((a.n + kTile - 1) / kTile, a.batch);
    size_t smem = smem_bytes<P>(a.H, a.d, 3, 3);
    cudaError_t err = cudaFuncSetAttribute(
        rows_kernel<T, P, NH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    rows_kernel<T, P, NH><<<grid, kThreads, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    smem = smem_bytes<P>(a.H, a.d, 3, 2);
    err = cudaFuncSetAttribute(
        keys_kernel<T, P, NH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    keys_kernel<T, P, NH><<<grid, kThreads, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
};

// ---------------------------------------------------------------------------
// bf16 on Hopper: TMA + wgmma (see the note at the top)

namespace hop {

using namespace cait::tc;

// (A): the query rows.
constexpr int kRowsStages = 2;

// Shared memory of (A): the q and g tiles of every head; the ring (per
// stage the k tiles of every head, then the v tiles); the mix tables; the
// two warpgroups' row partials, log2 l and delta; the warps' mix-gradient
// partials; the barriers. 206 KB at NH = 8.
template <int NH>
struct RowsTiles {
  static constexpr int kStageBytes = 2 * NH * kKeyTile;
  static constexpr int kQ = 0;
  static constexpr int kG = kQ + NH * kRowTile;
  static constexpr int kRing = kG + NH * kRowTile;
  static constexpr int kTables = kRing + kRowsStages * kStageBytes;
  static constexpr int kSums = kTables + (int)sizeof(Tables<NH>);
  static constexpr int kLog2l = kSums + 2 * NH * kRows * 4;
  static constexpr int kDelta = kLog2l + NH * kRows * 4;
  static constexpr int kRed = kDelta + NH * kRows * 4;
  static constexpr int kBars = kRed + 8 * 2 * NH * NH * 4;
  // own_full, full[stages], empty[stages]; 1024 bytes of slack to align.
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kRowsStages) + 1024;
};

struct RowsArgs {
  MixSrc mix;
  const float* stats;       // NULL, or the forward's log2 l (B, H, N_pad)
  __nv_bfloat16* scratch;   // (2, B, H, N, cols): a, then draw
  float* part_rows;         // (B * tiles, 2 H^2): dw_l (h, g), dw_w (g, h)
  int batch, n, H, d, cols;
  float scale;
};

// Sum over the 32 lanes of a warp, the same value on every lane.
template <int NH>
__device__ __forceinline__ void warp_sum(float (&v)[NH][NH]) {
#pragma unroll
  for (int i = 0; i < NH; ++i)
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v[i][j] += __shfl_xor_sync(0xffffffffu, v[i][j], off);
}

// (A): one block per 64 query rows of an image, every head. Three passes
// over the keys, 16 a stage (8 a consumer warpgroup): l; then delta, dw_w's
// sum and a (rounded to bf16 into the scratch); then ds, draw (rounded to
// bf16 into the scratch) and dw_l's sum. NH: H rounded up to 4, 6 or 8;
// kSaved: l comes from the forward (a.stats), and the first pass goes.
template <int NH, bool kSaved>
__global__ void __launch_bounds__(kWgThreads, 1)
talking_head_bwd_rows_wgmma_kernel(const __grid_constant__ CUtensorMap rows_map,
                                   const __grid_constant__ CUtensorMap keys_map,
                                   const __grid_constant__ CUtensorMap g_map,
                                   RowsArgs a) {
  using L = RowsTiles<NH>;
  constexpr int S = kRowsStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* q_s = smem + L::kQ;
  uint8_t* g_s = smem + L::kG;
  uint8_t* ring = smem + L::kRing;
  Tables<NH>& tab = *reinterpret_cast<Tables<NH>*>(smem + L::kTables);
  float* sums = reinterpret_cast<float*>(smem + L::kSums);
  float* log2l = reinterpret_cast<float*>(smem + L::kLog2l);
  float* delta = reinterpret_cast<float*>(smem + L::kDelta);
  float* red = reinterpret_cast<float*>(smem + L::kRed);
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + S;

  const int n = a.n, H = a.H;
  const int q0 = blockIdx.x * kRows, b = blockIdx.y;
  const int T = (n + kKeys - 1) / kKeys;
  // With the forward's log2 l, pass 1 is skipped: the ring's first stage
  // is pass 2's.
  const int first = kSaved ? T : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(own_full, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);   // one arrival a consumer warp
    }
    hopper::fence_barrier_init();
  }
  load_tables<NH>(tab, a.mix, H, a.scale);
  zero_smem(q_s + H * kRowTile, q_s + NH * kRowTile);
  zero_smem(g_s + H * kRowTile, g_s + NH * kRowTile);
  for (int st = 0; st < S; ++st)
    for (int p = 0; p < 2; ++p) {
      uint8_t* t = ring + st * L::kStageBytes + p * NH * kKeyTile;
      zero_smem(t + H * kKeyTile, t + NH * kKeyTile);
    }
  hopper::fence_proxy_async();
  __syncthreads();

  if (warp >= 8) {
    hopper::setmaxnreg_dec<kRowsProducerRegs>();
    // Producer: q and g once, then k of every stage (pass 1), then k and
    // v, twice (passes 2 and 3).
    if (warp == 8 && lane == 0) {
      hopper::mbar_expect_tx(own_full, 2 * H * kRowTile);
      for (int h = 0; h < H; ++h) {
        hopper::tma_load_5d(q_s + h * kRowTile, &rows_map, own_full, 0, h, 0,
                            q0, b);
        hopper::tma_load_4d(g_s + h * kRowTile, &g_map, own_full, 0, h, q0, b);
      }
      for (int it = first; it < 3 * T; ++it) {
        const int u = it - first, st = u % S;   // the ring's own count
        if (u >= S) hopper::mbar_wait(&empty[st], ((u / S) & 1) ^ 1);
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

  hopper::setmaxnreg_inc<kRowsConsumerRegs>();
  const int wg = warp / 4, row = 16 * (warp % 4) + lane / 4, t4 = lane % 4;
  const int nb_steps = (a.d + 15) / 16;
  float raw[NH][4], da[NH][4];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) raw[h][i] = da[h][i] = 0.f;
  // Stage it's raw scores (and da = g v^T), one wgmma group, retired; the
  // stage is then released.
  auto scores = [&](int it, bool with_da) {
    const int u = it - first, st = u % S;
    const uint8_t* keys = ring + st * L::kStageBytes + 1024 * wg;
    hopper::mbar_wait(&full[st], (u / S) & 1);
    fence_heads<NH>(raw);
    fence_heads<NH>(da);
    hopper::wgmma_fence();
    products_n8<NH>(raw, q_s, keys, nb_steps);
    if (with_da) products_n8<NH>(da, g_s, keys + NH * kKeyTile, nb_steps);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_heads<NH>(raw);
    fence_heads<NH>(da);
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  };
  // The bf16 pair (key, key + 1) of query row r of every head into part
  // `part` of the scratch, for rows and keys below n.
  auto store_pairs = [&](int part, int r, int key, const float (&x)[NH][2]) {
    if (q0 + r >= n || key >= n) return;
    __nv_bfloat16* dst = a.scratch +
        (((int64_t)part * a.batch + b) * H * n + q0 + r) * a.cols + key;
#pragma unroll
    for (int h = 0; h < NH; ++h)
      if (h < H)
        *reinterpret_cast<uint32_t*>(dst + (int64_t)h * n * a.cols) =
            hopper::pack_bf16(x[h][0], x[h][1]);
  };

  // Pass 1: the row sums l_g over the keys below n.
  float part[NH][2];
#pragma unroll
  for (int g = 0; g < NH; ++g) part[g][0] = part[g][1] = 0.f;
  hopper::mbar_wait(own_full, 0);
  if constexpr (!kSaved) {
    for (int it = 0; it < T; ++it) {
      scores(it, false);
      add_exp2s<NH>(tab, raw, kKeys * it + 8 * wg + 2 * t4, n, part);
    }
    combine_rows<NH, true>(part, sums, log2l, q0, n);
  } else {
    // The forward's log2 l (its padded rows written too: 0 past n).
    for (int i = threadIdx.x; i < NH * kRows; i += kConsumers) {
      const int g = i / kRows;
      log2l[i] = g < H ? a.stats[((int64_t)b * H + g) * gridDim.x * kRows +
                                 q0 + i % kRows]
                       : 0.f;
    }
    hopper::named_barrier(kBarConsumers, kConsumers);
  }

  // Pass 2: with p_g = 2^(min(s2_g, 80 log2(e)) - log2 l_g) and
  // dp_g = sum_h w_w[g][h] da_h: delta_g = rowsum(p_g dp_g), dw_w[g][h] +=
  // p_g da_h, and a_h = sum_g w_w[g][h] p_g into the scratch. Keys and rows
  // past n have raw = da = 0: they add nothing to either sum.
  float dw[NH][NH];
#pragma unroll
  for (int g = 0; g < NH; ++g) {
    part[g][0] = part[g][1] = 0.f;
#pragma unroll
    for (int h = 0; h < NH; ++h) dw[g][h] = 0.f;
  }
  for (int it = T; it < 2 * T; ++it) {
    scores(it, true);
    const int key = kKeys * (it - T) + 8 * wg + 2 * t4;
#pragma unroll
    for (int ep = 0; ep < 2; ++ep) {
      pin_loads();
      __syncwarp();
      const int r = row + 8 * ep, e0 = 2 * ep, e1 = 2 * ep + 1;
      float am[NH][2];
#pragma unroll
      for (int h = 0; h < NH; ++h) am[h][0] = am[h][1] = 0.f;
#pragma unroll
      for (int g = 0; g < NH; ++g) {
        pin_loads();
        float c[NH], w[NH];
        table_row<NH>(tab.c2, g, c);
        const float l2 = log2l[g * kRows + r];
        const float p0 = hopper::exp2_approx(
            fminf(mixed2<NH>(c, tab.bl2[g], raw, e0), kClamp2) - l2);
        const float p1 = hopper::exp2_approx(
            fminf(mixed2<NH>(c, tab.bl2[g], raw, e1), kClamp2) - l2);
        table_row<NH>(tab.ww, g, w);
        const float dp0 = head_dot<NH>(w, da, e0);
        const float dp1 = head_dot<NH>(w, da, e1);
        part[g][ep] = fmaf(p1, dp1, fmaf(p0, dp0, part[g][ep]));
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          am[h][0] = fmaf(w[h], p0, am[h][0]);
          am[h][1] = fmaf(w[h], p1, am[h][1]);
          dw[g][h] = fmaf(p1, da[h][e1], fmaf(p0, da[h][e0], dw[g][h]));
        }
      }
      store_pairs(0, r, key, am);
    }
  }
  combine_rows<NH, false>(part, sums, delta, q0, n);
  warp_sum<NH>(dw);
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < NH; ++g)
#pragma unroll
      for (int h = 0; h < NH; ++h)
        red[(warp * 2) * NH * NH + g * NH + h] = dw[g][h];

  // Pass 3: ds_g = where(s2_g < 80 log2(e), p_g (dp_g - delta_g), 0),
  // draw_h = sum_g scale w_l[h][g] ds_g into the scratch, and
  // dw_l[h][g] += raw_h ds_g (times scale at the end).
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int g = 0; g < NH; ++g) dw[h][g] = 0.f;
  for (int it = 2 * T; it < 3 * T; ++it) {
    scores(it, true);
    const int key = kKeys * (it - 2 * T) + 8 * wg + 2 * t4;
#pragma unroll
    for (int ep = 0; ep < 2; ++ep) {
      pin_loads();
      __syncwarp();
      const int r = row + 8 * ep, e0 = 2 * ep, e1 = 2 * ep + 1;
      float dr[NH][2];
#pragma unroll
      for (int h = 0; h < NH; ++h) dr[h][0] = dr[h][1] = 0.f;
#pragma unroll
      for (int g = 0; g < NH; ++g) {
        pin_loads();
        float c[NH], w[NH];
        table_row<NH>(tab.c2, g, c);
        const float l2 = log2l[g * kRows + r], dl = delta[g * kRows + r];
        const float s0 = mixed2<NH>(c, tab.bl2[g], raw, e0);
        const float s1 = mixed2<NH>(c, tab.bl2[g], raw, e1);
        const float p0 = hopper::exp2_approx(fminf(s0, kClamp2) - l2);
        const float p1 = hopper::exp2_approx(fminf(s1, kClamp2) - l2);
        table_row<NH>(tab.ww, g, w);
        const float dp0 = head_dot<NH>(w, da, e0);
        const float dp1 = head_dot<NH>(w, da, e1);
        const float ds0 = s0 < kClamp2 ? p0 * (dp0 - dl) : 0.f;
        const float ds1 = s1 < kClamp2 ? p1 * (dp1 - dl) : 0.f;
        table_row<NH>(tab.cs, g, c);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          dr[h][0] = fmaf(c[h], ds0, dr[h][0]);
          dr[h][1] = fmaf(c[h], ds1, dr[h][1]);
          dw[h][g] = fmaf(raw[h][e1], ds1, fmaf(raw[h][e0], ds0, dw[h][g]));
        }
      }
      store_pairs(1, r, key, dr);
    }
  }
  warp_sum<NH>(dw);
  if (lane == 0)
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int g = 0; g < NH; ++g)
        red[(warp * 2 + 1) * NH * NH + h * NH + g] = dw[h][g];
  hopper::named_barrier(kBarConsumers, kConsumers);

  // The block's partials, the eight warps' summed in order: dw_l[h][g]
  // at h H + g, then dw_w[g][h] at H^2 + g H + h.
  float* out = a.part_rows + ((int64_t)b * gridDim.x + blockIdx.x) * 2 * H * H;
  for (int i = threadIdx.x; i < H * H; i += kConsumers) {
    const int x = i / H, y = i % H;
    float wl = 0.f, ww = 0.f;
    for (int w8 = 0; w8 < 8; ++w8) {
      wl += red[(w8 * 2 + 1) * NH * NH + x * NH + y];
      ww += red[(w8 * 2) * NH * NH + x * NH + y];
    }
    out[i] = a.scale * wl;
    out[H * H + i] = ww;
  }
}

// (B): products of the scratch. One block of a consumer warpgroup and a
// producer warp per (64 rows, head, image): blocks x < tiles own 64 keys
// and stream the query tiles (dk += draw^T q, dv += a^T g, with a and
// draw read M-major), blocks x >= tiles own 64 query rows and stream the
// key tiles (dq += draw k).
constexpr int kKvThreads = 160;
constexpr int kKvStages = 3;

struct DqkvTiles {
  static constexpr int kOwn = 0;                    // v (the key blocks)
  static constexpr int kRing = kOwn + kRowTile;
  static constexpr int kStageBytes = 4 * kRowTile;  // draw, q or k, a, g
  static constexpr int kSums = kRing + kKvStages * kStageBytes;  // [2][2][64]
  static constexpr int kBars = kSums + 4 * kRows * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kKvStages) + 1024;
};

// Sum of column col of a 128-byte-swizzled bf16 tile over rows
// 32 half ... + 31.
__device__ __forceinline__ float column_half(const uint8_t* tile, int col,
                                             int half) {
  float s = 0.f;
#pragma unroll
  for (int r = 32 * half; r < 32 * half + 32; ++r)
    s += smem_bf16(tile + sw128_elem(r, col));
  return s;
}

// acc (64 x 64 f32, the accumulator layout) into a swizzled tile, then one
// thread stores it through the 5-D map of dqkv at (0, h, part, r0, b),
// clipped to rows below N and columns below d.
__device__ __forceinline__ void store_tile(const float (&acc)[32],
                                           uint8_t* tile,
                                           const CUtensorMap* map, int h,
                                           int part, int r0, int b) {
  const int lane = threadIdx.x % 32;
  const int row = 16 * (threadIdx.x / 32) + lane / 4, t4 = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(tile + hopper::sw128_offset(row, 4 * j + t4)) =
        hopper::pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(tile + hopper::sw128_offset(row + 8, 4 * j + t4)) =
        hopper::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
  hopper::fence_proxy_async();
  hopper::named_barrier(kBarConsumers, 128);
  if (threadIdx.x == 0) {
    hopper::tma_store_5d(map, tile, 0, h, part, r0, b);
    hopper::tma_store_commit_and_wait();
  }
}

__global__ void __launch_bounds__(kKvThreads, 2)
talking_head_bwd_dqkv_wgmma_kernel(const __grid_constant__ CUtensorMap rows_map,
                                   const __grid_constant__ CUtensorMap g_map,
                                   const __grid_constant__ CUtensorMap scr_map,
                                   const __grid_constant__ CUtensorMap dqkv_map,
                                   MixSrc mix, float* part_keys, int batch,
                                   int n) {
  using L = DqkvTiles;
  constexpr int S = kKvStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* own = smem + L::kOwn;
  uint8_t* ring = smem + L::kRing;
  float* sums = reinterpret_cast<float*>(smem + L::kSums);
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + S;

  const int tiles = (n + kRows - 1) / kRows;
  const bool kv = (int)blockIdx.x < tiles;
  const int r0 = kRows * (kv ? blockIdx.x : blockIdx.x - tiles);
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(own_full, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);   // one arrival a consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {
    if (lane == 0) {
      if (kv) {
        hopper::mbar_expect_tx(own_full, kRowTile);
        hopper::tma_load_5d(own, &rows_map, own_full, 0, h, 2, r0, b);
      }
      for (int t = 0; t < tiles; ++t) {
        const int st = t % S;
        if (t >= S) hopper::mbar_wait(&empty[st], ((t / S) & 1) ^ 1);
        uint8_t* stage = ring + st * L::kStageBytes;
        if (kv) {
          // draw and a: keys r0 ..., query rows 64 t ...; q and g rows.
          hopper::mbar_expect_tx(&full[st], 4 * kRowTile);
          hopper::tma_load_4d(stage, &scr_map, &full[st], r0, kRows * t, h,
                              batch + b);
          hopper::tma_load_5d(stage + kRowTile, &rows_map, &full[st], 0, h, 0,
                              kRows * t, b);
          hopper::tma_load_4d(stage + 2 * kRowTile, &scr_map, &full[st], r0,
                              kRows * t, h, b);
          hopper::tma_load_4d(stage + 3 * kRowTile, &g_map, &full[st], 0, h,
                              kRows * t, b);
        } else {
          // draw: keys 64 t ..., query rows r0 ...; k rows.
          hopper::mbar_expect_tx(&full[st], 2 * kRowTile);
          hopper::tma_load_4d(stage, &scr_map, &full[st], kRows * t, r0, h,
                              batch + b);
          hopper::tma_load_5d(stage + kRowTile, &rows_map, &full[st], 0, h, 1,
                              kRows * t, b);
        }
      }
    }
    return;
  }

  float acc0[32], acc1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
  const int tid = threadIdx.x, col = tid % 64, half = tid / 64;
  float gsum = 0.f, vsum = 0.f;
  if (kv) {
    hopper::mbar_wait(own_full, 0);
    vsum = column_half(own, col, half);
  }
  for (int t = 0; t < tiles; ++t) {
    const int st = t % S;
    const uint8_t* stage = ring + st * L::kStageBytes;
    hopper::mbar_wait(&full[st], (t / S) & 1);
    hopper::fence_regs(acc0);
    hopper::fence_regs(acc1);
    hopper::wgmma_fence();
    if (kv) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        hopper::wgmma_m64n64k16_ss<1, 1>(
            acc0, hopper::sw128_desc(stage) + 128 * m,
            hopper::sw128_desc(stage + kRowTile) + 128 * m, 1);
        hopper::wgmma_m64n64k16_ss<1, 1>(
            acc1, hopper::sw128_desc(stage + 2 * kRowTile) + 128 * m,
            hopper::sw128_desc(stage + 3 * kRowTile) + 128 * m, 1);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_m64n64k16_ss<1>(
            acc0, hopper::sw128_desc(stage) + 2 * kk,
            hopper::sw128_desc(stage + kRowTile) + 128 * kk, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc0);
    hopper::fence_regs(acc1);
    if (kv) gsum += column_half(stage + 3 * kRowTile, col, half);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  if (!kv) {
    // dq (draw carries the scale) into ring stage 0's first tile.
    hopper::named_barrier(kBarConsumers, 128);
    store_tile(acc0, ring, &dqkv_map, h, 0, r0, b);
    return;
  }
  // dv += b_w[h] colsum(g) (over every query row of the image); db_w's
  // partial: colsum(g) . (v summed over this block's keys).
  sums[tid] = gsum;
  sums[128 + tid] = vsum;
  hopper::named_barrier(kBarConsumers, 128);
  const float bw = mix_at(mix.b_w, h, mix.bf16);
  const int t4 = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t4;
    const float g0 = bw * (sums[c] + sums[64 + c]);
    const float g1 = bw * (sums[c + 1] + sums[64 + c + 1]);
    acc1[4 * j] += g0;
    acc1[4 * j + 1] += g1;
    acc1[4 * j + 2] += g0;
    acc1[4 * j + 3] += g1;
  }
  if (tid == 0) {
    float s = 0.f;
    for (int c = 0; c < 64; ++c)
      s += (sums[c] + sums[64 + c]) * (sums[128 + c] + sums[192 + c]);
    part_keys[((int64_t)b * tiles + blockIdx.x) * gridDim.y + h] = s;
  }
  store_tile(acc0, own, &dqkv_map, h, 1, r0, b);
  store_tile(acc1, ring, &dqkv_map, h, 2, r0, b);
}

template <int NH, bool kSaved>
int launch_rows(const CUtensorMap* tmaps, const RowsArgs& a,
                cudaStream_t stream) {
  constexpr int smem = RowsTiles<NH>::kBytes;
  const auto kernel = talking_head_bwd_rows_wgmma_kernel<NH, kSaved>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + kRows - 1) / kRows, a.batch);
  kernel<<<grid, kWgThreads, smem, stream>>>(tmaps[0], tmaps[1], tmaps[2], a);
  return (int)cudaGetLastError();
}

template <int NH>
int launch_rows_saved(const CUtensorMap* tmaps, const RowsArgs& a,
                      cudaStream_t stream) {
  return a.stats != nullptr ? launch_rows<NH, true>(tmaps, a, stream)
                            : launch_rows<NH, false>(tmaps, a, stream);
}

// Launches (A) and (B). maps: the geometries of qkv in 64-row and 16-row
// boxes, g, and the scratch (tma.py · packed_cait_maps).
int launch_wgmma(const void* qkv, const void* g, void* dqkv,
                 const RowsArgs& a, float* part_keys, const int64_t* maps,
                 cudaStream_t stream) {
  CUtensorMap tmaps[5];   // rows, keys, g, scratch, dqkv
  const void* bases[5] = {qkv, qkv, g, a.scratch, dqkv};
  const int geometry[5] = {0, 1, 2, 3, 0};
  for (int i = 0; i < 5; ++i) {
    const int err = hopper::encode_bf16_map(
        &tmaps[i], bases[i], maps + geometry[i] * hopper::kGeometrySize);
    if (err != 0) return err;
  }
  int err = a.H <= 4 ? launch_rows_saved<4>(tmaps, a, stream)
          : a.H <= 6 ? launch_rows_saved<6>(tmaps, a, stream)
                     : launch_rows_saved<8>(tmaps, a, stream);
  if (err != 0) return err;
  constexpr int smem = DqkvTiles::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      talking_head_bwd_dqkv_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (a.n + kRows - 1) / kRows;
  const dim3 grid(2 * tiles, a.H, a.batch);
  talking_head_bwd_dqkv_wgmma_kernel<<<grid, kKvThreads, smem, stream>>>(
      tmaps[0], tmaps[2], tmaps[3], tmaps[4], a.mix, part_keys, a.batch, a.n);
  return (int)cudaGetLastError();
}

}  // namespace hop

}  // namespace

// qkv: (B, N, 3 H d) with batch stride qkv_bs and row stride qkv_rs in
// elements (the last dimension contiguous); the mixes as in
// tfimm_talking_head_fwd; g (B, N, H d) contiguous; dqkv (B, N, 3 H d)
// contiguous; mix_out f32 (2 H^2 + 2 H). dtype: 0 = float32, 1 = bfloat16.
// maps NULL (the first design's bodies): stats f32 scratch of (2, B, H, N);
// part_rows f32 scratch of (B ceil(N / 16), 2 H^2), part_keys of
// (B ceil(N / 16), H); scratch unused. maps given (bf16 on the route of
// tma.py · cait_route: qkv and g contiguous, H <= 8, d <= 64): the
// geometries of tma.py · cait_maps and cait_scratch_map, four maps of
// hopper::kGeometrySize int64 values; scratch bf16 of (2, B, H, N,
// cait_scratch_cols(N)); part_rows of (B ceil(N / 64), 2 H^2), part_keys of
// (B ceil(N / 64), H); stats unused; row_stats NULL, or the forward's
// log2 l, f32 (B, H, N rounded up to 64), which skips (A)'s first pass.
// Returns a cudaError_t value (0 = ok).
extern "C" int tfimm_talking_head_bwd(const void* qkv, int64_t qkv_bs,
                                      int64_t qkv_rs, const void* w_l,
                                      int64_t wl_rs, int64_t wl_cs,
                                      const void* b_l, const void* w_w,
                                      int64_t ww_rs, int64_t ww_cs,
                                      const void* b_w, int mix_dtype,
                                      const void* g, void* dqkv, void* stats,
                                      void* part_rows, void* part_keys,
                                      void* mix_out, void* scratch,
                                      const int64_t* maps,
                                      const void* row_stats, int batch, int n,
                                      int nb_heads, int head_dim, float scale,
                                      int dtype, void* stream) {
  if (batch <= 0 || batch > 65535 || !supported(n, nb_heads, head_dim) ||
      (dtype != 0 && dtype != 1) || (mix_dtype != 0 && mix_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const MixSrc mix = {w_l, b_l, w_w, b_w, wl_rs, wl_cs, ww_rs, ww_cs,
                      mix_dtype};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int tile = kTile;
  if (maps != nullptr) {
    if (dtype != 1 || nb_heads > tc::kMaxNH || head_dim > tc::kMaxD ||
        scratch == nullptr)
      return (int)cudaErrorInvalidValue;
    const void* ptrs[4] = {qkv, g, dqkv, scratch};
    for (const void* p : ptrs)
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
        return (int)cudaErrorMisalignedAddress;
    const hop::RowsArgs a = {mix, static_cast<const float*>(row_stats),
                             static_cast<__nv_bfloat16*>(scratch),
                             static_cast<float*>(part_rows), batch, n,
                             nb_heads, head_dim, (n + 7) / 8 * 8, scale};
    const int err = hop::launch_wgmma(qkv, g, dqkv, a,
                                      static_cast<float*>(part_keys), maps, s);
    if (err != 0) return err;
    tile = tc::kRows;
  } else {
    const BwdArgs a = {qkv, qkv_bs, qkv_rs, mix,
                       g, dqkv, static_cast<float*>(stats),
                       static_cast<float*>(part_rows),
                       static_cast<float*>(part_keys), batch, n, nb_heads,
                       head_dim, scale,
                       vec_ok(qkv, qkv_bs, qkv_rs, dtype == 0 ? 4 : 2),
                       vec_ok(g, 0, 0, 16)};
    const int err = dispatch<Launch>(dtype, head_dim, nb_heads, a, s);
    if (err != 0) return err;
  }
  const int blocks = batch * ((n + tile - 1) / tile);
  const int outs = 2 * nb_heads * nb_heads + 2 * nb_heads;
  mix_sum_kernel<<<outs, kSumThreads, 0, s>>>(
      static_cast<const float*>(part_rows), static_cast<const float*>(part_keys),
      static_cast<float*>(mix_out), blocks, nb_heads);
  return (int)cudaGetLastError();
}
