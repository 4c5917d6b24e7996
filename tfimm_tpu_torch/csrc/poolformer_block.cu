// The whole PoolFormer block at inference.
//
// Replaces: tfimm_tpu/ops/pallas/poolformer_block.py ·
// poolformer_block_or_none (the Pallas TPU kernel). Per image, on the
// (H, W, C) map x:
//
//     y   = GN1(x)                      GroupNorm over the whole map: f32,
//                                       two-pass variance, eps
//     x1  = x + ls1 * (pool(y) - y)     SAME 3x3 average of the normalised map
//                                       over its in-bounds taps; kept in f32
//     z   = GN2(x1)                     f32, rounded to the io dtype
//     h   = gelu(z @ w1^T + b1)         f32 sums, GELU in the tanh form in
//                                       every dtype, rounded to the dtype
//     out = x1 + ls2 * (h @ w2^T + b2)  f32, rounded once
//
// w1 (hidden, C) and w2 (C, hidden) in the dtype (the port's Dense layout,
// so both products are "A row-major times B row-major transposed"); the
// norms' weights and biases, ls1, ls2, b1 and b2 as f32 vectors.
//
// What bounds it on an H100: the block is two whole-image reductions in
// series around a pool and a (HW x C) . (C x 4C) . (4C x C) MLP. At
// poolformer_s12's stage 1 (56 x 56 x 64) at batch 128 it reads x and writes
// out, 102.8 MB in bf16 (31 us at 3.35 TB/s), against 4 * B * H * W * C *
// 4C = 6.6 GFLOP (7 us at 989 TFLOP/s): bound by device memory. Stages 2-4
// (C = 128, 320, 512) have the same or more operations per image on fewer
// bytes and are bound by the tensor cores (27-42 us). The five launches
// below read x three times (bf16) and pass x1 (f32, written once and read
// three times) and h (written and read once) through device memory: about
// 1.5 ms a poolformer_s12 bs128 request at 3.35 TB/s bounds this form.
//
// Design. On the TPU one program holds an image's whole map in VMEM. A
// Hopper block cannot (a stage-1 map is 401 KB in bf16), and blocks cannot
// wait for each other, so the block runs as five launches on one stream,
// each reduction finished before the next launch reads it:
//
// 1. gn_stats over x: one thread block per image, a fixed-order two-pass
//    sum (per-thread partial sums, then a tree in shared memory) gives the
//    f32 mean and rstd = rsqrt(mean((x - mean)^2) + eps). No atomics: the
//    result does not depend on scheduling.
// 2. pool_x1: a thread takes a 16-byte chunk of a pixel's channels (8 bf16
//    or 4 f32; 1 channel where C is no multiple of that or x is unaligned),
//    recomputes y at its 3x3 taps from x and the statistics, adds the
//    in-bounds ones in the Pallas kernel's order, divides by their count
//    and writes x1 in f32 to a workspace.
// 3. gn_stats over x1, as in 1, but for its first pass: the pool launch
//    leaves each block's sum of its x1 values (a fixed-order tree), which
//    this launch adds in block order for the mean, so x1 is read once here.
// 4. fc1: a GEMM whose A tiles are z, formed from the f32 x1 with each
//    row's image statistics (its group of H * W rows) and GN2's affine,
//    rounded to the dtype; epilogue gelu(acc + b1), rounded; h goes to
//    device memory in the dtype, as the TPU kernel also rounds it.
// 5. fc2: a GEMM with the epilogue x1 + ls2 * (acc + b2), x1 its f32
//    shortcut.
//
// The GEMMs run mlp_gemm.cuh's bodies (see its note): in bf16 the TMA +
// wgmma body where tma.py · gemm_route takes x1, w1, w2, h and out (C and
// hidden multiples of 8, 16-byte aligned: every registered PoolFormer;
// fc1 reads x1 through two 32-column f32 boxes a k step, fc2 its f32
// shortcut likewise), else mma.sync with ldmatrix on 128 x 128 tiles; f32
// on plain FMAs (TF32 would miss the 1e-5 bar), 64 x 64 tiles. On the
// wgmma body the tanh GELU is s / (1 + e^(-2u)) (mlp_gemm.cuh ·
// gelu_tanh_wgmma), on the others tanhf: the bodies can differ in h's last
// bf16 bit.
//
// Coverage: any B, H, W, C (an image's H * W * C below 2^31) and hidden
// width. Every launch is followed by cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_gemm.cuh"

namespace {

using namespace cnx;

constexpr int kStatsThreads = 512;

// ---------------------------------------------------------------------------
// GroupNorm statistics: one block per image, fixed order.

// Sum of v over the block, the same order in every run; every thread gets
// the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();   // red is free (an earlier call has finished reading it)
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kStatsThreads / 32; ++w) s += red[w];
  return s;
}

// part: NULL, or the image's sum already taken in `parts` partial sums
// (pool_x1's, one a block), added here in block order, in place of the
// first pass.
template <typename T>
__global__ void __launch_bounds__(kStatsThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ mean,
                float* __restrict__ rstd, int64_t size, float eps, int vec,
                const float* __restrict__ part, int parts) {
  __shared__ float red[kStatsThreads / 32];
  constexpr int V = vec_len<T>();
  const T* xi = x + blockIdx.x * size;
  const int64_t chunks = vec ? size / V : 0;   // vec: size % V == 0
  const int64_t tail = chunks * V;

  float mu;
  if (part != nullptr) {
    float s = 0.f;
    if (threadIdx.x == 0)
      for (int i = 0; i < parts; ++i) s += part[(int64_t)blockIdx.x * parts + i];
    mu = block_sum(threadIdx.x == 0 ? s : 0.f, red) / (float)size;
  } else {
    float s = 0.f;
    for (int64_t i = threadIdx.x; i < chunks; i += kStatsThreads) {
      Chunk<T> c;
      c.u = reinterpret_cast<const uint4*>(xi)[i];
#pragma unroll
      for (int j = 0; j < V; ++j) s += c.get(j);
    }
    for (int64_t i = tail + threadIdx.x; i < size; i += kStatsThreads)
      s += to_f(xi[i]);
    mu = block_sum(s, red) / (float)size;
  }

  float ss = 0.f;
  for (int64_t i = threadIdx.x; i < chunks; i += kStatsThreads) {
    Chunk<T> c;
    c.u = reinterpret_cast<const uint4*>(xi)[i];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = c.get(j) - mu;
      ss += d * d;
    }
  }
  for (int64_t i = tail + threadIdx.x; i < size; i += kStatsThreads) {
    const float d = to_f(xi[i]) - mu;
    ss += d * d;
  }
  const float var = block_sum(ss, red) / (float)size;
  if (threadIdx.x == 0) {
    mean[blockIdx.x] = mu;
    rstd[blockIdx.x] = rsqrtf(var + eps);
  }
}

// ---------------------------------------------------------------------------
// The token mixer: x1 = x + ls1 * (pool3x3(GN1(x)) - GN1(x)), f32.

// V consecutive elements of T from p, as f32: one 16-byte load where V is
// 16 bytes of T (8 bf16 or 4 f32).
template <typename T, int V>
__device__ __forceinline__ void load_run(float (&e)[V], const T* p) {
  if constexpr (V * sizeof(T) == 16) {
    Chunk<T> c;
    c.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int v = 0; v < V; ++v) e[v] = c.get(v);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) e[v] = to_f(p[v]);
  }
}

// x1 of one run of V channels of a pixel of image blockIdx.y (q, the run's
// index in its image), with 32-bit index arithmetic within the image and
// each element's arithmetic the one-element form's; returns the sum of the
// V values.
template <typename T, int V>
__device__ __forceinline__ float pool_x1_run(
    const T* __restrict__ x, const float* __restrict__ mean,
    const float* __restrict__ rstd, const float* __restrict__ n_w,
    const float* __restrict__ n_b, const float* __restrict__ ls,
    float* __restrict__ x1, int q, int h, int w, int c) {
  const int runs = c / V;
  const int ch = q % runs * V;
  const int pix = q / runs;
  const int j = pix % w, i = pix / w;
  const int img = blockIdx.y;
  const int64_t base = (int64_t)img * h * w * c;
  const T* xi = x + base;
  const float mu = mean[img], rs = rstd[img];
  float gw[V], gb[V], xc[V], y[V], acc[V];
  load_run<T, V>(xc, xi + pix * c + ch);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    gw[v] = n_w[ch + v];
    gb[v] = n_b[ch + v];
    y[v] = (xc[v] - mu) * rs * gw[v] + gb[v];
    acc[v] = y[v];
  }
  // The Pallas kernel's order: the centre, then the 8 neighbours row by
  // row; its tap (dh, dw) reads y[i - dh, j - dw].
#pragma unroll
  for (int dh = -1; dh <= 1; ++dh) {
#pragma unroll
    for (int dw = -1; dw <= 1; ++dw) {
      if (dh == 0 && dw == 0) continue;
      const int ii = i - dh, jj = j - dw;
      if (ii < 0 || ii >= h || jj < 0 || jj >= w) continue;
      float e[V];
      load_run<T, V>(e, xi + (ii * w + jj) * c + ch);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += (e[v] - mu) * rs * gw[v] + gb[v];
    }
  }
  const float rc = 1.f + (i > 0) + (i < h - 1);
  const float cc = 1.f + (j > 0) + (j < w - 1);
  float out[V];
#pragma unroll
  for (int v = 0; v < V; ++v)
    out[v] = xc[v] + (acc[v] / (rc * cc) - y[v]) * ls[ch + v];
  float* o = x1 + base + pix * c + ch;
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int v = 0; v < V; v += 4)
      *reinterpret_cast<float4*>(o + v) =
          make_float4(out[v], out[v + 1], out[v + 2], out[v + 3]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = out[v];
  }
  float sum = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) sum += out[v];
  return sum;
}

// A thread takes a run of V consecutive channels (V = 16 bytes of T where
// C % V == 0 and x and x1 allow 16-byte loads and stores, else 1); each
// block also leaves the sum of its x1 values in part[image][block] (GN2's
// first pass, gn_stats_kernel's part).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
pool_x1_kernel(const T* __restrict__ x, const float* __restrict__ mean,
               const float* __restrict__ rstd, const float* __restrict__ n_w,
               const float* __restrict__ n_b, const float* __restrict__ ls,
               float* __restrict__ x1, float* __restrict__ part, int h,
               int w, int c) {
  __shared__ float red[kThreads / 32];
  const int runs = c / V;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  float sum = 0.f;   // this thread's x1 values, for GN2's mean
  if (q < h * w * runs)
    sum = pool_x1_run<T, V>(x, mean, rstd, n_w, n_b, ls, x1, q, h, w, c);
  // The block's sum, in a fixed order: the warps' by shuffles, then the
  // warps' in order.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) s += red[i];
    part[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// Blocks of the pool launch a image at V channels a thread: its partial
// sums an image.
template <int V>
int pool_blocks(int h, int w, int c) {
  return (int)(((int64_t)h * w * (c / V) + kThreads - 1) / kThreads);
}

// The images in launches of at most 65535 (the grid's y); part (B,
// pool_blocks) f32.
template <typename T, int V>
int launch_pool(const T* x, const float* mean, const float* rstd,
                const float* n_w, const float* n_b, const float* ls,
                float* x1, float* part, int batch, int h, int w, int c,
                cudaStream_t stream) {
  const int64_t size = (int64_t)h * w * c;
  const int blocks = pool_blocks<V>(h, w, c);
  for (int b0 = 0; b0 < batch; b0 += 65535) {
    const dim3 grid((unsigned)blocks,
                    (unsigned)(batch - b0 < 65535 ? batch - b0 : 65535));
    pool_x1_kernel<T, V><<<grid, kThreads, 0, stream>>>(
        x + b0 * size, mean + b0, rstd + b0, n_w, n_b, ls, x1 + b0 * size,
        part + (int64_t)b0 * blocks, h, w, c);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// The MLP GEMMs: fc1 (the GN2 prologue on the f32 x1, the tanh GELU) and
// fc2 (the f32 shortcut x1, the layer scale ls2).

CNX_WGMMA_KERNEL(pf_fc1_wgmma_kernel, kNormF32, kGeluTanh)
CNX_WGMMA_KERNEL(pf_fc2_wgmma_kernel, kPlain, kResidualF32)
CNX_TILE_KERNEL(pf_fc1_tile_kernel, kNormF32, kGeluTanh)
CNX_TILE_KERNEL(pf_fc2_tile_kernel, kPlain, kResidualF32)

// maps: NULL, or the product's maps (kGemmMapsSize values, bf16 only),
// which select the TMA + wgmma body.
template <typename T, bool FC1>
int launch_pf_gemm(const GemmArgs& args, const int64_t* maps,
                   cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (maps != nullptr)
      return FC1 ? launch_pf_fc1_wgmma_kernel(args, maps, stream)
                 : launch_pf_fc2_wgmma_kernel(args, maps, stream);
  }
  return FC1 ? launch_gemm<T>(pf_fc1_tile_kernel<T>, args, stream)
             : launch_gemm<T>(pf_fc2_tile_kernel<T>, args, stream);
}

template <typename T>
int launch_all(const T* x, const float* const* vecs, const void* w1,
               const void* w2, float* x1, void* hid, float* stats, void* out,
               int batch, int h, int w, int c, int hidden, float eps,
               const int64_t* maps, cudaStream_t stream) {
  constexpr int V = vec_len<T>();
  const float *n1_w = vecs[0], *n1_b = vecs[1], *ls1 = vecs[2];
  const float *n2_w = vecs[3], *n2_b = vecs[4], *b1 = vecs[5], *b2 = vecs[6];
  const float* ls2 = vecs[7];
  float *mean1 = stats, *rstd1 = stats + batch;
  float *mean2 = stats + 2 * batch, *rstd2 = stats + 3 * batch;
  float* part = stats + 4 * batch;
  const int64_t size = (int64_t)h * w * c;   // one image
  const int m = batch * h * w;

  gn_stats_kernel<T><<<batch, kStatsThreads, 0, stream>>>(
      x, mean1, rstd1, size, eps, size % V == 0 && aligned16(x), nullptr, 0);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;

  // One image's elements in 32-bit indices; runs of a 16-byte chunk of x
  // where the loads and stores are aligned. The pool leaves GN2's partial
  // sums in part.
  if (size > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const bool runs = c % V == 0 && aligned16(x) && aligned16(x1);
  const int parts = runs ? pool_blocks<V>(h, w, c) : pool_blocks<1>(h, w, c);
  err = runs ? launch_pool<T, V>(x, mean1, rstd1, n1_w, n1_b, ls1, x1, part,
                                 batch, h, w, c, stream)
             : launch_pool<T, 1>(x, mean1, rstd1, n1_w, n1_b, ls1, x1, part,
                                 batch, h, w, c, stream);
  if (err != 0) return err;

  gn_stats_kernel<float><<<batch, kStatsThreads, 0, stream>>>(
      x1, mean2, rstd2, size, eps, size % 4 == 0 && aligned16(x1), part,
      parts);
  err = (int)cudaGetLastError();
  if (err != 0) return err;

  // fc1's A is x1 in f32, its statistics those of row / (H * W); the
  // mma.sync body reads a bf16 chunk's 8 f32 elements as two 16-byte loads.
  const GemmArgs fc1 = {x1, w1, hid, nullptr, mean2, rstd2, n2_w, n2_b, b1,
                        nullptr, m, hidden, c,
                        c % V == 0 && c % 4 == 0 && aligned16(x1) &&
                            aligned16(w1),
                        h * w};
  err = launch_pf_gemm<T, true>(fc1, maps, stream);
  if (err != 0) return err;

  const GemmArgs fc2 = {hid, w2, out, x1, nullptr, nullptr, nullptr, nullptr,
                        b2, ls2, m, c, hidden,
                        hidden % V == 0 && aligned16(hid) && aligned16(w2)};
  return launch_pf_gemm<T, false>(
      fc2, maps ? maps + kGemmMapsSize : nullptr, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The eight vectors (n1 weight, n1 bias,
// ls1, n2 weight, n2 bias, b1, b2, ls2) are f32; x1 (B, H, W, C) f32, hid
// (B * H * W, hidden) in the dtype and stats (4 + ceil(H * W * C / 256), B)
// f32 (the two norms' mean and rstd, then the pool's partial sums) are
// scratch the caller allocates. maps: NULL for the mma.sync GEMM body, or (bf16) two
// products' maps of tma.py · packed_gemm_maps, fc1's (x1, w1, hid) then
// fc2's (hid, w2, out, x1), each with its grid, which select the TMA +
// wgmma body. Returns a cudaError_t value (0 = ok).
extern "C" int tfimm_poolformer_block(
    const void* x, const void* n1_w, const void* n1_b, const void* ls1,
    const void* n2_w, const void* n2_b, const void* b1, const void* b2,
    const void* ls2, const void* w1, const void* w2, void* x1, void* hid,
    void* stats, void* out, int batch, int h, int w, int c, int hidden,
    float eps, int dtype, const int64_t* maps, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0 || hidden <= 0 ||
      (int64_t)batch * h * w > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (maps != nullptr && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* vecs[8] = {
      static_cast<const float*>(n1_w), static_cast<const float*>(n1_b),
      static_cast<const float*>(ls1), static_cast<const float*>(n2_w),
      static_cast<const float*>(n2_b), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<const float*>(ls2)};
  float* x1f = static_cast<float*>(x1);
  float* st = static_cast<float*>(stats);
  switch (dtype) {
    case 0:
      return launch_all<float>(static_cast<const float*>(x), vecs, w1, w2, x1f,
                               hid, st, out, batch, h, w, c, hidden, eps,
                               nullptr, s);
    case 1:
      return launch_all<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x),
                                       vecs, w1, w2, x1f, hid, st, out, batch,
                                       h, w, c, hidden, eps, maps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
