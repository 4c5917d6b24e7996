// A whole Swin transformer block on window-partitioned tokens (inference).
//
// Replaces: tfimm_tpu/ops/pallas/swin_block.py · swin_block_fused (the
// Pallas TPU kernel). Same function, on x (BW, N, C) flattened to M = BW * N
// rows:
//
//     H1  = LN1(x) in f32 (one-pass variance, eps), rounded to the dtype
//     qkv = H1 @ w_qkv^T + b_qkv, summed in f32, rounded to the dtype
//     A   = window attention of q, k, v with the rel-pos bias (H, N, N) and
//           the shift mask (nW, N, N): window_mha.cu's kernel, rounded
//     P   = A @ w_proj^T + b_proj, rounded to the dtype
//     X2  = x + P in f32, never rounded
//     H2  = LN2(X2) in f32, rounded to the dtype
//     M1  = gelu(round(H2 @ w1^T + b1)), the GELU of the kernel's dtype
//           policy (tanh form in bf16, exact erf in f32), rounded
//     out = X2 + (M1 @ w2^T + b2) in f32, rounded once
//
// Weights are in the dtype and in the port's Dense layout (out, in), so
// every product is "A row-major times B row-major transposed"; the LN
// weights and the biases are f32 vectors.
//
// What bounds it on an H100: one block at Swin-T's stages 1-3 at batch 128
// (M = 401408, 100352, 25088 rows; C = 96, 192, 384) does 24 * M * C^2
// product flops plus 4 * M * N * C in the attention: 96.3, 92.6 and 90.7
// GFLOP, about 0.097, 0.094 and 0.092 ms at the 989 TFLOP/s bf16 peak,
// while x and out are 4 * M * C bytes (154 MB at stage 1, 46 us at 3.35
// TB/s). So the fused function is bound by the tensor cores. The seven
// launches below pass their intermediates through device memory (x read
// three times; qkv, A and M1 written and read once; X2 in f32 written once
// and read three times, twice where proj takes its statistics): about 2.16
// GB a block at stage 1 (2.0 GB with two reads), 0.64 ms at 3.35 TB/s,
// which bounds this form.
//
// Design. The TPU kernel keeps a window group's every intermediate in VMEM.
// This form runs the block as seven launches (six where proj takes X2's
// statistics) on one stream instead, with the intermediates through device
// memory (qkv and M1 in the dtype, X2 in f32):
//
// 1. row statistics of x (mlp_gemm.cuh · row_stats: 8 or 16 bf16 rows a
//    warp below C = 256), f32 mean and rstd;
// 2. qkv: a GEMM whose A tiles are normalised (LN1) in registers, so H1
//    never reaches device memory;
// 3. window attention: tfimm_window_mha (window_mha.cu) on the three slices
//    of the packed qkv, read in place through their strides (in bf16 with
//    N <= 64 and d <= 64, every registered Swin at window 7, its TMA +
//    wgmma body, through the maps the wrapper hands over);
// 4. proj, with the epilogue X2 = x + round(acc + b_proj), written in f32;
// 5. row statistics of X2, or (bf16, C no wider than proj's tiles) none:
//    proj's epilogue takes them from its f32 X2 tile, one-pass and in f32
//    as row_stats does, its four threads of a row summed by shuffles;
// 6. fc1, with the LN2 prologue on the f32 X2 and the bias + GELU epilogue;
// 7. fc2, with the epilogue out = X2 + (acc + b2).
//
// The four GEMMs run mlp_gemm.cuh's bodies (see its note). In bf16 every
// one takes the TMA + wgmma body: C = H * d is a multiple of 8 (window_mha
// takes d % 8 == 0), and the wrapper hands the kernel contiguous 16-byte
// aligned operands and the tensor maps (tma.py · packed_gemm_maps), or
// raises. fc1 reads X2 in f32 through two 32-column boxes a k step
// (kNormF32), proj writes it in f32 (kProj) and fc2 reads it as an f32
// shortcut (kResidualF32). On that body fc1's tanh GELU is s / (1 +
// e^(-2u)) after the rounding (mlp_gemm.cuh · gelu_tanh_wgmma). In f32 they
// run the FMA body (TF32 would miss the bar), 64 x 64 tiles.
//
// Coverage: any BW, N <= 144, any C that the attention takes (C = H * d, d
// a multiple of 8 up to 128), any hidden width in f32 and a multiple of 8
// in bf16. Rows beyond M and the tail of k are zero-filled (TMA's fill; the
// LN affine is zero past K); edges of the output are not stored. Every
// launch is followed by cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_gemm.cuh"

extern "C" int tfimm_window_mha(const void* q, const void* k, const void* v,
                                int64_t q_bs, int64_t q_rs, int64_t k_bs,
                                int64_t k_rs, int64_t v_bs, int64_t v_rs,
                                const void* bias, const void* mask, void* out,
                                int bw, int n, int nb_heads, int head_dim,
                                int nb_win, float scale, int dtype,
                                const int64_t* maps, void* stream);

namespace {

using namespace cnx;

template <typename T>
__global__ void __launch_bounds__(kThreads)
swin_row_stats_kernel(const T* __restrict__ x, float* __restrict__ mean,
                      float* __restrict__ rstd, int m, int c, float eps,
                      int vec) {
  row_stats<T>(x, mean, rstd, m, c, eps, vec);
}

template <typename T>
int launch_stats(const void* x, float* mean, float* rstd, int m, int c,
                 float eps, cudaStream_t stream) {
  const int vec = c % vec_len<T>() == 0 && aligned16(x);
  swin_row_stats_kernel<T><<<stats_blocks<T>(m, c, vec), kThreads, 0,
                             stream>>>(static_cast<const T*>(x), mean, rstd,
                                       m, c, eps, vec);
  return (int)cudaGetLastError();
}

// The four products: bf16 on the TMA + wgmma body, f32 on the FMA body
// (CNX_TILE_KERNEL's f32 instantiation).
CNX_WGMMA_KERNEL_192(swin_qkv_wgmma_kernel, kLnRows, kBias)
CNX_WGMMA_KERNEL_192(swin_proj_wgmma_kernel, kPlain, kProj)
CNX_WGMMA_KERNEL_192(swin_fc1_wgmma_kernel, kNormF32, kGeluRounded)
CNX_WGMMA_KERNEL_192(swin_fc2_wgmma_kernel, kPlain, kResidualF32)
CNX_TILE_KERNEL(swin_qkv_tile_kernel, kLnRows, kBias)
CNX_TILE_KERNEL(swin_proj_tile_kernel, kPlain, kProj)
CNX_TILE_KERNEL(swin_fc1_tile_kernel, kNormF32, kGeluRounded)
CNX_TILE_KERNEL(swin_fc2_tile_kernel, kPlain, kResidualF32)

struct BlockArgs {
  const void* x;
  const float *ln1_w, *ln1_b;
  const void* w_qkv;
  const float* b_qkv;
  const void* bias;
  const void* mask;
  const void* w_proj;
  const float* b_proj;
  const float *ln2_w, *ln2_b;
  const void* w1;
  const float* b1;
  const void* w2;
  const float* b2;
  void *qkv, *attn, *x2, *hid;
  float *mean, *rstd;
  void* out;
  int bw, n, c, nb_heads, hidden, nb_win;
  float eps, scale;
};

// 16-byte loads of A (depth k) and B by the FMA body (and a flag the wgmma
// body does not read).
template <typename T>
int vec_ab(const void* a, const void* b, int k) {
  return k % vec_len<T>() == 0 && aligned16(a) && aligned16(b);
}

template <typename T>
int launch_block(const BlockArgs& b, int dtype, const int64_t* maps,
                 const int64_t* attn_maps, cudaStream_t s) {
  // bf16: every product on the wgmma body, with its maps (kGemmMapsSize
  // values each, in launch order); f32: the FMA body.
  constexpr bool kWgmma = sizeof(T) == 2;
  const int m = b.bw * b.n, c = b.c, hid = b.hidden;
  int err = launch_stats<T>(b.x, b.mean, b.rstd, m, c, b.eps, s);
  if (err != 0) return err;
  const GemmArgs qkv = {b.x, b.w_qkv, b.qkv, nullptr, b.mean, b.rstd,
                        b.ln1_w, b.ln1_b, b.b_qkv, nullptr, m, 3 * c, c,
                        vec_ab<T>(b.x, b.w_qkv, c), 1};
  if constexpr (kWgmma)
    err = launch_swin_qkv_wgmma_kernel(qkv, maps, s);
  else
    err = launch_gemm<T>(swin_qkv_tile_kernel<T>, qkv, s);
  if (err != 0) return err;
  const T* q = static_cast<const T*>(b.qkv);
  const int64_t bs = (int64_t)b.n * 3 * c, rs = 3 * (int64_t)c;
  err = tfimm_window_mha(q, q + c, q + 2 * c, bs, rs, bs, rs, bs, rs, b.bias,
                         b.mask, b.attn, b.bw, b.n, b.nb_heads,
                         c / b.nb_heads, b.nb_win, b.scale, dtype, attn_maps,
                         s);
  if (err != 0) return err;
  // On the wgmma body, where proj's tiles hold whole rows (C <= their
  // width: Swin-T's stages 1-2), proj's epilogue also takes X2's row
  // statistics, and launch 5 is left out (faster on the H100:
  // scripts/perf/torch_swin_x2_stats.py builds and times both forms).
  const bool x2_stats =
      kWgmma && wgmma_width(maps + kGemmMapsSize) >= c;
  const GemmArgs proj = {b.attn, b.w_proj, b.x2, b.x, nullptr, nullptr,
                         nullptr, nullptr, b.b_proj, nullptr, m, c, c,
                         vec_ab<T>(b.attn, b.w_proj, c), 1,
                         x2_stats ? b.mean : nullptr,
                         x2_stats ? b.rstd : nullptr, b.eps};
  if constexpr (kWgmma)
    err = launch_swin_proj_wgmma_kernel(proj, maps + kGemmMapsSize, s);
  else
    err = launch_gemm<T>(swin_proj_tile_kernel<T>, proj, s);
  if (err != 0) return err;
  if (!x2_stats) {
    err = launch_stats<float>(b.x2, b.mean, b.rstd, m, c, b.eps, s);
    if (err != 0) return err;
  }
  const GemmArgs fc1 = {b.x2, b.w1, b.hid, nullptr, b.mean, b.rstd,
                        b.ln2_w, b.ln2_b, b.b1, nullptr, m, hid, c,
                        vec_ab<T>(b.x2, b.w1, c), 1};
  if constexpr (kWgmma)
    err = launch_swin_fc1_wgmma_kernel(fc1, maps + 2 * kGemmMapsSize, s);
  else
    err = launch_gemm<T>(swin_fc1_tile_kernel<T>, fc1, s);
  if (err != 0) return err;
  const GemmArgs fc2 = {b.hid, b.w2, b.out, b.x2, nullptr, nullptr, nullptr,
                        nullptr, b.b2, nullptr, m, c, hid,
                        vec_ab<T>(b.hid, b.w2, hid), 1};
  if constexpr (kWgmma)
    return launch_swin_fc2_wgmma_kernel(fc2, maps + 3 * kGemmMapsSize, s);
  else
    return launch_gemm<T>(swin_fc2_tile_kernel<T>, fc2, s);
}

}  // namespace

// x, out (BW, N, C) in the dtype; w_qkv (3C, C), w_proj (C, C), w1
// (hidden, C), w2 (C, hidden) in the dtype; ln weights and biases, b_qkv,
// b_proj, b1, b2 f32; bias (H, N, N) f32; mask (nb_win, N, N) f32 or null.
// Scratch the caller allocates: qkv (M, 3C) and attn (M, C) and hid
// (M, hidden) in the dtype, x2 (M, C) f32, mean and rstd (M,) f32. dtype:
// 0 = float32, 1 = bfloat16. maps: bf16 only, and there required: the four
// products' maps of tma.py · packed_gemm_maps (qkv: x, w_qkv, qkv; proj:
// attn, w_proj, x2, x; fc1: x2, w1, hid; fc2: hid, w2, out, x2), each with
// its grid. attn_maps: bf16 on tma.py · window_route only, else null: the
// attention's maps over the qkv scratch and attn (tma.py ·
// packed_window_maps), which select window_mha.cu's TMA + wgmma body.
// Returns a cudaError_t value (0 = ok).
extern "C" int tfimm_swin_block(
    const void* x, const void* ln1_w, const void* ln1_b, const void* w_qkv,
    const void* b_qkv, const void* bias, const void* mask, const void* w_proj,
    const void* b_proj, const void* ln2_w, const void* ln2_b, const void* w1,
    const void* b1, const void* w2, const void* b2, void* qkv, void* attn,
    void* x2, void* hid, void* mean, void* rstd, void* out, int bw, int n,
    int c, int nb_heads, int hidden, int nb_win, float eps, float scale,
    int dtype, const int64_t* maps, const int64_t* attn_maps, void* stream) {
  if (bw <= 0 || n <= 0 || c <= 0 || hidden <= 0 || nb_heads <= 0 ||
      c % nb_heads != 0 || (int64_t)bw * n > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if ((maps != nullptr) != (dtype == 1) || (attn_maps != nullptr && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const BlockArgs b = {
      x, static_cast<const float*>(ln1_w), static_cast<const float*>(ln1_b),
      w_qkv, static_cast<const float*>(b_qkv), bias, mask, w_proj,
      static_cast<const float*>(b_proj), static_cast<const float*>(ln2_w),
      static_cast<const float*>(ln2_b), w1, static_cast<const float*>(b1), w2,
      static_cast<const float*>(b2), qkv, attn, x2, hid,
      static_cast<float*>(mean), static_cast<float*>(rstd), out, bw, n, c,
      nb_heads, hidden, nb_win, eps, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_block<float>(b, dtype, nullptr, nullptr, s);
    case 1:
      return launch_block<__nv_bfloat16>(b, dtype, maps, attn_maps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
