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
// at stage 0, where the two nearly meet. h between the launches adds
// 4 * M * H bytes (411 MB each way at stage 0), which the bound leaves
// out.
//
// Design. On the TPU one program keeps a token block's f32 accumulator over
// all of C in VMEM and loops over hidden chunks. A Hopper block cannot hold
// that accumulator (64 rows x 1024 x 4 B = 256 KB at C = 1024), so the
// function runs as three launches on the same stream:
//
// 1. row statistics: the row's f32 mean and
//    rstd = rsqrt(max(E[x^2] - mean^2, 0) + eps) into an (M,) scratch pair
//    (a warp a row; in bf16 rows of 16-byte chunks below C = 256, 8 or 16
//    rows a warp with all their loads in flight).
// 2. fc1: a tiled GEMM h = gelu(z @ w1^T + b1) whose A operand is formed
//    from the x tile in shared memory: normalised with the row statistics
//    and the LN affine, rounded to the dtype. z never reaches device memory
//    (that fusion is the point of the TPU kernel); h does, in the dtype, as
//    the TPU kernel also rounds it: 2 * M * H bytes each way.
// 3. fc2: a tiled GEMM with the epilogue shortcut + gamma * (acc + b2).
//
// Both GEMMs run the bodies of mlp_gemm.cuh (see its note), which
// convnext_block.cu and ln_dense.cu share:
//
// - bf16 where tma.py · gemm_route takes x, shortcut, w1, w2, h and out (C
//   and H multiples of 8, 16-byte aligned, C up to 4096: every registered
//   ConvNeXt): TMA-fed wgmma on an mbarrier ring, a persistent grid of
//   warp-specialised blocks; fc1 at 256-column tiles where they cost no
//   more rounds, with z formed in registers as the A operand; fc2 at
//   128-column tiles (a five-stage ring), its shortcut loaded by TMA while
//   the products run. The wrapper passes the tensor maps (tma.py ·
//   gemm_maps); their absence selects the next body.
// - bf16 elsewhere (C = 12 in the golden fixture, an operand off 16
//   bytes): mma.sync m16n8k16 with ldmatrix, 128 x 128 tiles staged
//   through registers.
// - f32: plain f32 FMAs (the tensor cores' TF32 would miss the 1e-5 bar),
//   64 x 64 tiles.
//
// The tanh GELU is evaluated as s / (1 + e^(-2u)) on the wgmma body (with
// __expf and __fdividef; the bound is at mlp_gemm.cuh · gelu_tanh_wgmma)
// and with tanhf on the others, so the bodies can differ in h's last bf16
// bit.
//
// Coverage: any M >= 1, C >= 1, H >= 1. Rows beyond M and the tail of the
// k dimension are zero-filled in shared memory (TMA's fill on the wgmma
// body; there the LN affine is zero past K, elsewhere the transform writes
// 0), and output rows and columns beyond the edges are not stored. Shared
// memory, dynamic with the launch limit raised before each launch: up to
// 225.1 KB on the wgmma body, 41 KB (bf16 mma.sync) and 17.5 KB (f32) on
// the others; every launch is followed by cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_gemm.cuh"

namespace {

using namespace cnx;

// ---------------------------------------------------------------------------
// Row statistics (mlp_gemm.cuh · row_stats).

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_stats_kernel(const T* __restrict__ x, float* __restrict__ mean,
                 float* __restrict__ rstd, int m, int c, float eps, int vec) {
  row_stats<T>(x, mean, rstd, m, c, eps, vec);
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

CNX_WGMMA_KERNEL(mlp_gemm_fc1_wgmma_kernel, true, kGeluTanh)
CNX_WGMMA_KERNEL(mlp_gemm_fc2_wgmma_kernel, false, kResidual)

// maps: NULL, or the product's maps (kGemmMapsSize values, bf16 only),
// which select the TMA + wgmma body.
template <typename T, bool FC1>
int launch_mlp_gemm(const GemmArgs& args, const int64_t* maps,
                    cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (maps != nullptr)
      return FC1 ? launch_mlp_gemm_fc1_wgmma_kernel(args, maps, stream)
                 : launch_mlp_gemm_fc2_wgmma_kernel(args, maps, stream);
    return launch_gemm<T>(mlp_gemm_bf16_kernel<FC1>, args, stream);
  } else {
    return launch_gemm<T>(mlp_gemm_f32_kernel<FC1>, args, stream);
  }
}

template <typename T>
int launch_all(const void* x, const void* shortcut, const float* ln_w,
               const float* ln_b, const void* w1, const float* b1,
               const void* w2, const float* b2, const float* gamma, void* h,
               float* mean, float* rstd, void* out, int m, int c, int hidden,
               float eps, const int64_t* maps, cudaStream_t stream) {
  constexpr int V = vec_len<T>();
  const int vec = c % V == 0 && aligned16(x);
  row_stats_kernel<T><<<stats_blocks<T>(m, c, vec), kThreads, 0, stream>>>(
      static_cast<const T*>(x), mean, rstd, m, c, eps, vec);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;

  GemmArgs fc1 = {x, w1, h, nullptr, mean, rstd, ln_w, ln_b, b1, nullptr,
                  m, hidden, c, c % V == 0 && aligned16(x) && aligned16(w1)};
  err = launch_mlp_gemm<T, true>(fc1, maps, stream);
  if (err != 0) return err;

  GemmArgs fc2 = {h, w2, out, shortcut, nullptr, nullptr, nullptr, nullptr,
                  b2, gamma, m, c, hidden,
                  hidden % V == 0 && aligned16(h) && aligned16(w2)};
  return launch_mlp_gemm<T, false>(
      fc2, maps ? maps + kGemmMapsSize : nullptr, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. ln_w, ln_b, b1, b2, gamma are f32;
// h (M, H) in the dtype and mean, rstd (M,) f32 are scratch the caller
// allocates. maps: NULL for the mma.sync body, or (bf16) two products'
// maps of tma.py · packed_gemm_maps, fc1's (x, w1, h) then fc2's (h, w2,
// out, shortcut), each with its grid, which select the TMA + wgmma body.
// Returns a cudaError_t value (0 = ok).
extern "C" int tfimm_convnext_mlp(const void* x, const void* shortcut,
                                  const void* ln_w, const void* ln_b,
                                  const void* w1, const void* b1,
                                  const void* w2, const void* b2,
                                  const void* gamma, void* h, void* mean,
                                  void* rstd, void* out, int m, int c,
                                  int hidden, float eps, int dtype,
                                  const int64_t* maps, void* stream) {
  if (m <= 0 || c <= 0 || hidden <= 0) return (int)cudaErrorInvalidValue;
  if (maps != nullptr && dtype != 1) return (int)cudaErrorInvalidValue;
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
                               eps, nullptr, s);
    case 1:
      return launch_all<__nv_bfloat16>(x, shortcut, f[0], f[1], w1, f[2], w2,
                                       f[3], f[4], h, static_cast<float*>(mean),
                                       static_cast<float*>(rstd), out, m, c,
                                       hidden, eps, maps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
