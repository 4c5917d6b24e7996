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
// draw k and dk = draw^T q (mma.sync takes bf16 operands), where the JAX
// backward keeps them f32.
//
// Design: three launches, no atomics, so two calls give bit-identical
// results.
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
// Device memory bounds it. This form is far from that: the mixes and the
// softmax are scalar f32 work per entry, in every pass; launch 1 computes
// q k^T three times and g v^T twice, launch 2 both again; the mix-gradient
// sums read the staged tiles once per (g, h) pair; and k and v (q and g)
// are read from L2 once per 16 queries (keys), with no copy in flight while
// a tile is used.
//
// Coverage: the forward's (any B up to 65535, any N, H <= 16, d a multiple
// of 8 up to 128, D <= 768, bf16 and f32, qkv and the mixes through their
// strides); g
// contiguous (B, N, D); dqkv written contiguous. Shared memory of launch 1:
// 3 row tiles and 3 score tiles, 200 KB at most (f32, H = 16, D = 768). Every launch
// is followed by cudaGetLastError().

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

// mix_out = [dw_l (H, H), dw_w (H, H), db_w (H,), db_l (H,)]: the partials
// of every block summed in a fixed order, four running sums interleaved;
// db_l exact zeros.
__global__ void __launch_bounds__(kThreads)
mix_sum_kernel(const float* __restrict__ part_rows,
               const float* __restrict__ part_keys, float* __restrict__ out,
               int blocks, int H) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int rows = 2 * H * H;
  if (i >= rows + H) {
    if (i < rows + 2 * H) out[i] = 0.f;
    return;
  }
  const float* src = i < rows ? part_rows + i : part_keys + (i - rows);
  const int stride = i < rows ? rows : H;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int k = 0;
  for (; k + 4 <= blocks; k += 4)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u] += src[(int64_t)(k + u) * stride];
  for (; k < blocks; ++k) acc[0] += src[(int64_t)k * stride];
  out[i] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
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

}  // namespace

// qkv: (B, N, 3 H d) with batch stride qkv_bs and row stride qkv_rs in
// elements (the last dimension contiguous); the mixes as in
// tfimm_talking_head_fwd; g (B, N, H d) contiguous; dqkv (B, N, 3 H d)
// contiguous; stats f32 scratch of (2, B, H, N); part_rows f32 scratch of
// (B ceil(N / 16), 2 H^2), part_keys of (B ceil(N / 16), H); mix_out f32
// (2 H^2 + 2 H). dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t
// value (0 = ok).
extern "C" int tfimm_talking_head_bwd(const void* qkv, int64_t qkv_bs,
                                      int64_t qkv_rs, const void* w_l,
                                      int64_t wl_rs, int64_t wl_cs,
                                      const void* b_l, const void* w_w,
                                      int64_t ww_rs, int64_t ww_cs,
                                      const void* b_w, int mix_dtype,
                                      const void* g, void* dqkv, void* stats,
                                      void* part_rows, void* part_keys,
                                      void* mix_out, int batch, int n,
                                      int nb_heads, int head_dim, float scale,
                                      int dtype, void* stream) {
  if (batch <= 0 || batch > 65535 || !supported(n, nb_heads, head_dim) ||
      (dtype != 0 && dtype != 1) || (mix_dtype != 0 && mix_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a = {qkv, qkv_bs, qkv_rs,
                     {w_l, b_l, w_w, b_w, wl_rs, wl_cs, ww_rs, ww_cs, mix_dtype},
                     g, dqkv, static_cast<float*>(stats),
                     static_cast<float*>(part_rows), static_cast<float*>(part_keys),
                     batch, n, nb_heads, head_dim, scale,
                     vec_ok(qkv, qkv_bs, qkv_rs, dtype == 0 ? 4 : 2),
                     vec_ok(g, 0, 0, 16)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = dispatch<Launch>(dtype, head_dim, nb_heads, a, s);
  if (err != 0) return err;
  const int blocks = batch * ((n + kTile - 1) / kTile);
  const int outs = 2 * nb_heads * nb_heads + 2 * nb_heads;
  mix_sum_kernel<<<(outs + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(part_rows), static_cast<const float*>(part_keys),
      static_cast<float*>(mix_out), blocks, nb_heads);
  return (int)cudaGetLastError();
}
