// The whole ConvNeXt block at inference.
//
// Replaces: tfimm_tpu/ops/pallas/convnext_block.py · fused_convnext_block
// (the Pallas TPU kernel). On the NHWC map x (B, H, W, C):
//
//     d   = dw7x7(x) + dw_b        depthwise 7x7 conv, zero padding 3,
//                                  products and sums in f32, the bias in f32
//     z   = LN(d)                  f32 statistics of the unrounded d (one-pass
//                                  variance max(E[d^2] - E[d]^2, 0)), the
//                                  affine in f32, rounded once to the dtype
//     h   = gelu(z @ w1^T + b1)    f32 sums, the tanh GELU in f32 in every
//                                  dtype, rounded to the dtype
//     out = x + gamma * (h @ w2^T + b2)   in f32, rounded once
//
// The depthwise weight is read as an f32 (49, C) tap table (the wrapper
// transposes the port's (C, 1, 7, 7)); w1 (hidden, C) and w2 (C, hidden) in
// the dtype (the port's Dense layout); dw_b, the LN weight and bias, b1, b2
// and gamma as f32 vectors. The default ConvNeXt path is another function:
// it rounds d to the dtype before the LayerNorm and takes the erf GELU in
// f32.
//
// What bounds it on an H100: at ConvNeXt-B, batch 128, 224x224, each block's
// MLP is 16 * M * C^2 = 105.2 GFLOP at every stage (M * C^2 = 6.58e9),
// 0.106 ms at the 989 TFLOP/s bf16 dense peak; the 49 taps are 98 * M * C
// f32 operations on the CUDA cores (5.03 GFLOP at stage 0, 0.075 ms at 67
// TFLOP/s); x and out are 4 * M * C bytes in bf16 (205.5 MB at stage 0,
// 0.061 ms at 3.35 TB/s). So the block is bound by the tensor cores at
// every stage, with the taps and the bytes close behind at stage 0.
//
// Design. On the TPU one program holds one image's padded map and its MLP
// hidden layer in VMEM (5 MB at ConvNeXt-B's stage 0), runs the taps as 49
// shifted FMAs and the MLP on the MXU. A Hopper block cannot hold an image
// (a 56 x 56 x 512 hidden layer is 3.2 MB), so the block runs as three
// launches on one stream:
//
// 1. dw_ln: one thread block per run of up to 8 pixels of one image row.
//    Each thread owns (channel, 4 consecutive pixels) items: for each of the
//    7 input rows it loads 10 neighbouring values of its channel once
//    (coalesced across the warp, which holds neighbouring channels) and
//    applies that row's 7 taps to its 4 outputs, skipping the taps that fall
//    outside the map (zero padding). d + dw_b goes to shared memory in f32;
//    then one warp per pixel reduces E[d] and E[d^2] over C and writes z,
//    rounded to the dtype. That is exactly the operand the Pallas kernel
//    feeds its first product, so z in device memory costs 2 * M * C bytes
//    each way but no accuracy.
// 2. fc1: the tiled GEMM of mlp_gemm.cuh (shared with convnext_mlp.cu) with
//    no prologue and the tanh GELU epilogue; h goes to device memory in the
//    dtype, as the TPU kernel also rounds it.
// 3. fc2: the same GEMM with the epilogue x + gamma * (acc + b2).
//
// The GEMMs: bf16 on the tensor cores through mma.sync m16n8k16 with
// ldmatrix, 128 x 128 output tiles, 32-deep k tiles staged through
// registers into two shared buffers; f32 on plain FMAs (TF32 would miss the
// f32 bar), 64 x 64 tiles. Folding the taps into fc1's A tiles, keeping h
// on chip, wgmma, TMA and cp.async are the next steps toward the bound.
//
// Coverage: any B, H, W, hidden width and C up to 58,112 (one pixel's f32
// row in shared memory); bf16 and f32. A block holds 8 pixels while 8 rows
// of C f32 fit in 96 KB (C <= 3072), fewer above. 16-byte GEMM loads where
// the depth is a multiple of 8 (bf16) or 4 (f32) and the operands are
// 16-byte aligned, element loads otherwise. Every launch is followed by
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_gemm.cuh"

namespace {

using namespace cnx;

constexpr int kDwThreads = 256;
constexpr int kDwMaxPix = 8;        // pixels of one image row per block
constexpr int kDwSub = 4;           // consecutive pixels of one thread item
constexpr int kDwSmemTarget = 96 * 1024;
constexpr int kDwSmemMax = 232448;  // an H100 block's shared memory

// Pixels per dw_ln block for C channels (0: C is too wide).
inline int dw_pixels(int c) {
  int pix = kDwSmemTarget / (4 * c);
  if (pix > kDwMaxPix) pix = kDwMaxPix;
  if (pix < 1) pix = (int64_t)4 * c <= kDwSmemMax ? 1 : 0;
  return pix;
}

// ---------------------------------------------------------------------------
// Depthwise 7x7 + bias + LayerNorm -> z (M, C) in the dtype.

template <typename T>
__global__ void __launch_bounds__(kDwThreads)
convnext_block_dw_ln_kernel(const T* __restrict__ x,
                            const float* __restrict__ taps,  // (49, C)
                            const float* __restrict__ dw_b,
                            const float* __restrict__ ln_w,
                            const float* __restrict__ ln_b,
                            T* __restrict__ z, int h, int w, int c, int pix,
                            float eps) {
  extern __shared__ float d_s[];   // [pix][c]
  const int tiles_w = (w + pix - 1) / pix;
  const int64_t row = blockIdx.x / tiles_w;   // b * H + i
  const int j0 = (int)(blockIdx.x % tiles_w) * pix;
  const int i = (int)(row % h);
  const int64_t b = row / h;
  const int npix = min(pix, w - j0);
  const T* xb = x + b * h * (int64_t)w * c;
  const int subs = (npix + kDwSub - 1) / kDwSub;

  for (int item = threadIdx.x; item < c * subs; item += kDwThreads) {
    const int ch = item % c, sub = item / c;
    const int js = j0 + sub * kDwSub;
    float acc[kDwSub];
#pragma unroll
    for (int q = 0; q < kDwSub; ++q) acc[q] = 0.f;
    for (int di = 0; di < 7; ++di) {
      const int r = i + di - 3;
      if (r < 0 || r >= h) continue;
      const T* xr = xb + (int64_t)r * w * c + ch;
      float xv[kDwSub + 6];
#pragma unroll
      for (int t = 0; t < kDwSub + 6; ++t) {
        const int col = js + t - 3;
        xv[t] = (col >= 0 && col < w) ? to_f(xr[(int64_t)col * c]) : 0.f;
      }
#pragma unroll
      for (int dj = 0; dj < 7; ++dj) {
        const float tap = __ldg(taps + (di * 7 + dj) * c + ch);
#pragma unroll
        for (int q = 0; q < kDwSub; ++q) acc[q] = fmaf(xv[q + dj], tap, acc[q]);
      }
    }
    const float bias = __ldg(dw_b + ch);
#pragma unroll
    for (int q = 0; q < kDwSub; ++q)
      if (sub * kDwSub + q < npix) d_s[(sub * kDwSub + q) * c + ch] = acc[q] + bias;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = warp; p < npix; p += kDwThreads / 32) {
    const float* d = d_s + p * c;
    float s = 0.f, ss = 0.f;
    for (int k = lane; k < c; k += 32) {
      const float v = d[k];
      s += v;
      ss += v * v;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    const float mu = s / (float)c;
    const float rs = rsqrtf(fmaxf(ss / (float)c - mu * mu, 0.f) + eps);
    T* zr = z + (row * w + j0 + p) * (int64_t)c;
    for (int k = lane; k < c; k += 32)
      zr[k] = from_f<T>(((d[k] - mu) * rs) * __ldg(ln_w + k) + __ldg(ln_b + k));
  }
}

// ---------------------------------------------------------------------------
// The GEMMs: fc1 (FC1: no prologue, the tanh GELU) and fc2 (the residual).

template <bool FC1>
__global__ void __launch_bounds__(kThreads)
convnext_block_gemm_bf16_kernel(GemmArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  gemm_bf16_tile<false, FC1 ? kGeluTanh : kResidual>(p, smem_raw);
}

template <bool FC1>
__global__ void __launch_bounds__(kThreads)
convnext_block_gemm_f32_kernel(GemmArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  gemm_f32_tile<false, FC1 ? kGeluTanh : kResidual>(p, smem_raw);
}

template <typename T, bool FC1>
int launch_block_gemm(const GemmArgs& args, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2)
    return launch_gemm<T>(convnext_block_gemm_bf16_kernel<FC1>, args, stream);
  else
    return launch_gemm<T>(convnext_block_gemm_f32_kernel<FC1>, args, stream);
}

template <typename T>
int launch_all(const void* x, const float* taps, const float* dw_b,
               const float* ln_w, const float* ln_b, const void* w1,
               const float* b1, const void* w2, const float* b2,
               const float* gamma, void* z, void* h, void* out, int b,
               int height, int width, int c, int hidden, float eps,
               cudaStream_t stream) {
  constexpr int V = vec_len<T>();
  const int pix = dw_pixels(c);
  if (pix == 0) return (int)cudaErrorInvalidValue;
  const int64_t m = (int64_t)b * height * width;
  const int64_t dw_blocks = (int64_t)b * height * ((width + pix - 1) / pix);
  if (m > 0x7fffffff || dw_blocks > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  const int smem = pix * c * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      convnext_block_dw_ln_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  convnext_block_dw_ln_kernel<T><<<(unsigned)dw_blocks, kDwThreads, smem,
                                   stream>>>(
      static_cast<const T*>(x), taps, dw_b, ln_w, ln_b, static_cast<T*>(z),
      height, width, c, pix, eps);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;

  GemmArgs fc1 = {z, w1, h, nullptr, nullptr, nullptr, nullptr, nullptr, b1,
                  nullptr, (int)m, hidden, c,
                  c % V == 0 && aligned16(z) && aligned16(w1)};
  err = launch_block_gemm<T, true>(fc1, stream);
  if (err != 0) return err;

  GemmArgs fc2 = {h, w2, out, x, nullptr, nullptr, nullptr, nullptr, b2,
                  gamma, (int)m, c, hidden,
                  hidden % V == 0 && aligned16(h) && aligned16(w2)};
  return launch_block_gemm<T, false>(fc2, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. taps (49, C), dw_b, ln_w, ln_b, b1, b2
// and gamma are f32; z (B*H*W, C) and h (B*H*W, hidden) in the dtype are
// scratch the caller allocates. Returns a cudaError_t value (0 = ok).
extern "C" int tfimm_convnext_block(const void* x, const void* taps,
                                    const void* dw_b, const void* ln_w,
                                    const void* ln_b, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, const void* gamma,
                                    void* z, void* h, void* out, int b,
                                    int height, int width, int c, int hidden,
                                    float eps, int dtype, void* stream) {
  if (b <= 0 || height <= 0 || width <= 0 || c <= 0 || hidden <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(taps),
                      static_cast<const float*>(dw_b),
                      static_cast<const float*>(ln_w),
                      static_cast<const float*>(ln_b),
                      static_cast<const float*>(b1),
                      static_cast<const float*>(b2),
                      static_cast<const float*>(gamma)};
  switch (dtype) {
    case 0:
      return launch_all<float>(x, f[0], f[1], f[2], f[3], w1, f[4], w2, f[5],
                               f[6], z, h, out, b, height, width, c, hidden,
                               eps, s);
    case 1:
      return launch_all<__nv_bfloat16>(x, f[0], f[1], f[2], f[3], w1, f[4],
                                       w2, f[5], f[6], z, h, out, b, height,
                                       width, c, hidden, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
