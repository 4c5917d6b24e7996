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
// Design. One block of 256 threads per (16 queries, image), all H heads.
// The post-softmax mix needs each p_g normalised before the heads mix, so
// the block walks the keys twice, 16 at a time:
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
// - bf16 (the serving and training path): q, k and v tiles stay bf16 in
//   shared memory, and q k^T and a v run on the tensor cores (mma.sync
//   m16n8k16, bf16 in, f32 accumulate; warp w owns head w, and w + 8 when
//   H > 8). The next k or v tile is copied with cp.async while the current
//   one is used.
// - f32: f32 tiles and scalar FMAs (the tensor cores' TF32 would miss the
//   f32 bar), loaded synchronously.
//
// What bounds it on an H100: at cait_s24_224 at batch 128 (N = 196, H = 8,
// d = 48) one call reads qkv (57.8 MB bf16) and writes out (19.3 MB): 77 MB,
// 0.023 ms at 3.35 TB/s; the per-head products and the mixes are 8.8 GFLOP,
// 0.009 ms on the tensor cores. So device memory bounds it. This form is far
// from that: the mixes and the softmax are scalar f32 work per (query, key)
// entry (about 3 H^2 FMAs and 2 H exponentials an entry, over the two
// passes), q k^T is computed twice, a block of 16 queries reads each
// image's k and v from L2 once per pass (at H = 8, d = 48 a thread holds
// 75 registers and a block 57 KB of shared memory: three blocks an SM).
//
// Coverage: any B (up to 65535), any N, H <= 16, d a multiple of 8 up to
// 128, D = H d <= 768 (every registered CaiT), bf16 and f32; qkv with any
// batch and row strides whose last dimension is contiguous (16-byte copies
// where qkv and its strides allow, element loads otherwise); the (H, H)
// mixes through their strides, in f32 or bf16; out contiguous. Shared memory: 3 row tiles and 1 score tile, 167 KB at most
// (f32, H = 16, D = 768); the launcher raises the dynamic limit first and
// returns cudaGetLastError().

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

}  // namespace

// qkv: (B, N, 3 H d) with batch stride qkv_bs and row stride qkv_rs in
// elements (the last dimension contiguous); w_l, w_w (H, H) with row and
// column strides in elements, b_l, b_w (H,) contiguous, all four f32
// (mix_dtype 0) or bf16 (1); out (B, N, H d) contiguous. dtype: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t value (0 = ok).
extern "C" int tfimm_talking_head_fwd(const void* qkv, int64_t qkv_bs,
                                      int64_t qkv_rs, const void* w_l,
                                      int64_t wl_rs, int64_t wl_cs,
                                      const void* b_l, const void* w_w,
                                      int64_t ww_rs, int64_t ww_cs,
                                      const void* b_w, int mix_dtype,
                                      void* out, int batch, int n,
                                      int nb_heads, int head_dim, float scale,
                                      int dtype, void* stream) {
  if (batch <= 0 || batch > 65535 || !supported(n, nb_heads, head_dim) ||
      (dtype != 0 && dtype != 1) || (mix_dtype != 0 && mix_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const FwdArgs a = {qkv, qkv_bs, qkv_rs,
                     {w_l, b_l, w_w, b_w, wl_rs, wl_cs, ww_rs, ww_cs, mix_dtype},
                     out, n, nb_heads, head_dim, scale,
                     vec_ok(qkv, qkv_bs, qkv_rs, dtype == 0 ? 4 : 2)};
  return dispatch<Launch>(dtype, head_dim, nb_heads, a, batch,
                          static_cast<cudaStream_t>(stream));
}
