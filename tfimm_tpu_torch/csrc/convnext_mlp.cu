// Fused ConvNeXt LayerNorm + MLP + layer scale + residual.
//
// Replaces: tfimm_tpu/ops/pallas/convnext_mlp.py · convnext_mlp (the Pallas
// TPU kernel). Same function, on tokens flattened to rows:
//
//     z   = LN(x) in f32 (one-pass variance max(E[x^2] - E[x]^2, 0)),
//           rounded to the io dtype
//     h   = gelu(z @ w1^T + b1), sums and GELU in f32, rounded to the dtype
//           (tanh form in bf16, exact erf in f32: the kernel's dtype policy)
//     out = shortcut + gamma * (h @ w2^T + b2), in f32, rounded once
//
// x, shortcut, out (M, C); w1 (H, C) and w2 (C, H) in the dtype (the port's
// Dense layout, so both products are "A row-major times B row-major
// transposed"); ln weight/bias, b1, b2, gamma as f32 vectors.
//
// What bounds it on an H100: at ConvNeXt-B, batch 128, 224x224, every
// block's MLP is 16 * M * C^2 = 105.2 GFLOP (M * C^2 = 6.58e9 at every
// stage), about 106 us at the 989 TFLOP/s bf16 dense peak; x, shortcut and
// out are 6 * M * C bytes, 308 MB at stage 0 (92 us at 3.35 TB/s). So the
// fused function is bound by the tensor cores, and by device memory only
// at stage 0, where the two nearly meet.
//
// Design. On the TPU one program keeps a token block's f32 accumulator over
// all of C in VMEM and loops over hidden chunks. A Hopper block cannot hold
// that accumulator (64 rows x 1024 x 4 B = 256 KB at C = 1024), so the
// function runs as three launches on the same stream:
//
// 1. row_stats: one warp per row writes the row's f32 mean and
//    rstd = rsqrt(max(E[x^2] - mean^2, 0) + eps) to an (M,) scratch pair.
// 2. fc1: a tiled GEMM h = gelu(z @ w1^T + b1) whose A tiles are formed
//    from the x tile as it is stored to shared memory: normalised with the
//    row statistics and the LN affine, rounded to the dtype. z never reaches
//    device memory (that fusion is the point of the TPU kernel); h does, in
//    the dtype, as the TPU kernel also rounds it: 2 * M * H bytes each way.
// 3. fc2: a tiled GEMM with the epilogue shortcut + gamma * (acc + b2).
//
// Both GEMMs share one kernel template per dtype, whose tile bodies live in
// mlp_gemm.cuh (convnext_block.cu runs the same tiles):
//
// - bf16: tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate),
//   fragments through ldmatrix. 128 x 128 output tile, 32-deep k tiles,
//   8 warps as 2 x 4, each owning 64 x 32 outputs. Tiles are staged through
//   registers: the global loads of k tile t + 1 are in flight while the
//   warps multiply tile t out of shared memory (two buffers, one barrier
//   per k tile). Shared rows are padded by 8 elements, which keeps the
//   ldmatrix row addresses on distinct banks.
// - f32: plain f32 FMAs (the tensor cores' TF32 would miss the 1e-5 bar).
//   64 x 64 output tile, 16-deep k tiles, 256 threads as 16 x 16 each owning
//   4 x 4 outputs; tiles stored k-major in shared memory.
//
// This first form uses neither wgmma nor TMA nor cp.async, and does the
// fc1/fc2 split in two launches; those are the next steps toward the bound.
//
// Coverage: any M >= 1, C >= 1, H >= 1. Rows beyond M and the tail of the
// k dimension are zero-filled in shared memory (the LN transform writes 0,
// not the LN bias, there), and output rows and columns beyond the edges
// are not stored. 16-byte loads are used when the depth is a multiple of 8
// (bf16) or 4 (f32) and the operands are 16-byte aligned, element loads
// otherwise. Shared memory: bf16 41 KB, f32 17.5 KB, dynamic, with the
// launch limit raised before each launch; every launch is followed by
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_gemm.cuh"

namespace {

using namespace cnx;

// ---------------------------------------------------------------------------
// Row statistics: one warp per row.

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_stats_kernel(const T* __restrict__ x, float* __restrict__ mean,
                 float* __restrict__ rstd, int m, int c, float eps, int vec) {
  const int64_t row = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / 32;
  if (row >= m) return;
  row_stats_warp<T>(x + row * c, c, eps, vec, threadIdx.x % 32, mean + row,
                    rstd + row);
}

// ---------------------------------------------------------------------------
// The GEMMs: fc1 (FC1, the LN prologue and the GELU of the dtype policy)
// and fc2 (the residual epilogue).

template <bool FC1>
__global__ void __launch_bounds__(kThreads)
mlp_gemm_bf16_kernel(GemmArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  gemm_bf16_tile<FC1, FC1 ? kGeluTanh : kResidual>(p, smem_raw);
}

template <bool FC1>
__global__ void __launch_bounds__(kThreads)
mlp_gemm_f32_kernel(GemmArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  gemm_f32_tile<FC1, FC1 ? kGeluErf : kResidual>(p, smem_raw);
}

template <typename T, bool FC1>
int launch_mlp_gemm(const GemmArgs& args, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2)
    return launch_gemm<T>(mlp_gemm_bf16_kernel<FC1>, args, stream);
  else
    return launch_gemm<T>(mlp_gemm_f32_kernel<FC1>, args, stream);
}

template <typename T>
int launch_all(const void* x, const void* shortcut, const float* ln_w,
               const float* ln_b, const void* w1, const float* b1,
               const void* w2, const float* b2, const float* gamma, void* h,
               float* mean, float* rstd, void* out, int m, int c, int hidden,
               float eps, cudaStream_t stream) {
  constexpr int V = vec_len<T>();
  const int stats_blocks = (int)(((int64_t)m * 32 + kThreads - 1) / kThreads);
  row_stats_kernel<T><<<stats_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), mean, rstd, m, c, eps,
      c % V == 0 && aligned16(x));
  int err = (int)cudaGetLastError();
  if (err != 0) return err;

  GemmArgs fc1 = {x, w1, h, nullptr, mean, rstd, ln_w, ln_b, b1, nullptr,
                  m, hidden, c, c % V == 0 && aligned16(x) && aligned16(w1)};
  err = launch_mlp_gemm<T, true>(fc1, stream);
  if (err != 0) return err;

  GemmArgs fc2 = {h, w2, out, shortcut, nullptr, nullptr, nullptr, nullptr,
                  b2, gamma, m, c, hidden,
                  hidden % V == 0 && aligned16(h) && aligned16(w2)};
  return launch_mlp_gemm<T, false>(fc2, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. ln_w, ln_b, b1, b2, gamma are f32;
// h (M, H) in the dtype and mean, rstd (M,) f32 are scratch the caller
// allocates. Returns a cudaError_t value (0 = ok).
extern "C" int tfimm_convnext_mlp(const void* x, const void* shortcut,
                                  const void* ln_w, const void* ln_b,
                                  const void* w1, const void* b1,
                                  const void* w2, const void* b2,
                                  const void* gamma, void* h, void* mean,
                                  void* rstd, void* out, int m, int c,
                                  int hidden, float eps, int dtype,
                                  void* stream) {
  if (m <= 0 || c <= 0 || hidden <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(ln_w),
                      static_cast<const float*>(ln_b),
                      static_cast<const float*>(b1),
                      static_cast<const float*>(b2),
                      static_cast<const float*>(gamma)};
  switch (dtype) {
    case 0:
      return launch_all<float>(x, shortcut, f[0], f[1], w1, f[2], w2, f[3],
                               f[4], h, static_cast<float*>(mean),
                               static_cast<float*>(rstd), out, m, c, hidden,
                               eps, s);
    case 1:
      return launch_all<__nv_bfloat16>(x, shortcut, f[0], f[1], w1, f[2], w2,
                                       f[3], f[4], h, static_cast<float*>(mean),
                                       static_cast<float*>(rstd), out, m, c,
                                       hidden, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
