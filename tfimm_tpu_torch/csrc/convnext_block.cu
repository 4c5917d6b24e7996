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
// f32. The tanh GELU is evaluated as s / (1 + e^(-2u)) on the wgmma GEMM
// (mlp_gemm.cuh · gelu_tanh_wgmma gives the bound) and with tanhf on the
// others, so the bodies can differ in h's last bf16 bit.
//
// What bounds it on an H100: at ConvNeXt-B, batch 128, 224x224, each block's
// MLP is 16 * M * C^2 = 105.2 GFLOP at every stage (M * C^2 = 6.58e9),
// 0.106 ms at the 989 TFLOP/s bf16 dense peak; the 49 taps are 98 * M * C
// f32 operations on the CUDA cores (5.03 GFLOP at stage 0, 0.075 ms at 67
// TFLOP/s); x and out are 4 * M * C bytes in bf16 (205.5 MB at stage 0,
// 0.061 ms at 3.35 TB/s). So the block is bound by the tensor cores at
// every stage, with the taps and the bytes close behind at stage 0. The
// tiled dw_ln launch runs far from its own bound (the taps' f32 work and
// z's bytes): one block an SM at the widest tiles, whose 49 taps a chunk
// are read from shared memory (PERF.md row 14).
//
// Design. On the TPU one program holds one image's padded map and its MLP
// hidden layer in VMEM (5 MB at ConvNeXt-B's stage 0), runs the taps as 49
// shifted FMAs and the MLP on the MXU. A Hopper block cannot hold an image
// (a 56 x 56 x 512 hidden layer is 3.2 MB), so the block runs as three
// launches on one stream:
//
// 1. dw_ln, d + dw_b in f32 and its LayerNorm, z rounded once to the dtype:
//    exactly the operand the Pallas kernel feeds its first product, so z in
//    device memory costs 2 * M * C bytes each way but no accuracy.
//    - In bf16 with C % 8 == 0 and x, z, the taps and the LN vectors
//      16-byte aligned, whatever body the GEMMs take: a block owns a TH x P
//      tile of one image's output pixels (P = 7 columns on maps of a
//      multiple of 7, else 8; TH up to 8 rows, fewer where a tile's f32
//      rows would not fit 227 KB, as at C = 1024 on 7 x 7) and walks C in
//      chunks of 64 channels. cp.async stages each chunk's input with its
//      3-pixel halo (16 bytes a copy, zeros outside the map) and its 49
//      taps, one chunk ahead of the taps' products (two buffers), so each
//      element comes from device memory about once and from L2 about
//      (TH + 6)(P + 6) / (TH P) times. Thread (pair cp, row r) owns
//      channels 2 cp, 2 cp + 1 of the tile's row r and applies each input
//      row's 7 taps to its P outputs from registers. d stays in shared
//      memory in f32 for all of C; one warp a pixel then takes the
//      statistics and writes z, 8 channels (16 bytes) a lane.
//    - Else (f32, the golden fixture's C = 12, an operand off 16 bytes, C
//      above the tile's budget up to 58,112): one block per run of up to 8
//      pixels of one image row, each thread (channel, 4 consecutive
//      pixels) loading 10 neighbouring values of each of the 7 input rows,
//      d in shared memory; one warp per pixel for the LayerNorm.
// 2. fc1: the GEMM of mlp_gemm.cuh (shared with convnext_mlp.cu) with no
//    prologue and the tanh GELU epilogue; h goes to device memory in the
//    dtype, as the TPU kernel also rounds it.
// 3. fc2: the same GEMM with the epilogue x + gamma * (acc + b2).
//
// The GEMMs (mlp_gemm.cuh's note): on the TMA route (tma.py · gemm_route
// takes x, z, h, the output and both weights: C and hidden multiples of 8,
// 16-byte aligned) TMA-fed wgmma on an mbarrier ring in a persistent grid
// of warp-specialised blocks, fc1 at 256-column tiles, fc2 at 128 (a
// five-stage ring) with the shortcut x loaded by TMA while the products
// run; else mma.sync m16n8k16 with ldmatrix (bf16) or plain FMAs (f32:
// TF32 would miss the f32 bar). Folding the taps into fc1's A tiles and
// keeping h on chip are the next steps toward the bound.
//
// Coverage: any B, H, W, hidden width and C up to 58,112 (one pixel's f32
// row in shared memory); bf16 and f32. Every launch is followed by
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
// Depthwise 7x7 + bias + LayerNorm -> z, bf16 with 16-byte rows: a block
// owns a TH x P tile of output pixels of one image and walks C in chunks
// of kDwChunk channels. Per chunk, cp.async stages the tile's input with
// its 3-pixel halo ((TH + 6) x (P + 6) pixels x 64 channels, 16 bytes a
// copy, zero-filled outside the map) and the chunk's 49 taps, one chunk
// ahead of the taps' products (two buffers). Thread (pair cp, row r) owns
// channels 2 cp, 2 cp + 1 of the tile's row r: per input row it reads the
// P + 6 pixels once and applies the row's 7 taps to its P outputs from
// registers. d + dw_b stays in shared memory in f32 for all of C; then one
// warp a pixel takes the LayerNorm and writes z, 8 channels a lane.

constexpr int kDwChunk = 64;           // channels a stage
constexpr int kDwTileRows = 8;         // at most: 32 pairs x 8 rows = 256

template <int P>
struct DwTile {
  static constexpr int kCols = P + 6;                         // halo width
  static constexpr int kTapBytes = 49 * kDwChunk * 4;
  __host__ __device__ static size_t in_bytes(int th) {
    return (size_t)(th + 6) * kCols * kDwChunk * 2;
  }
  static size_t bytes(int th, int c) {
    return 2 * (in_bytes(th) + kTapBytes) + (size_t)th * P * c * 4;
  }
};

// Rows of a tile of P columns at C channels (0: the f32 rows of even one
// row of pixels do not fit), balanced over the map's H rows.
template <int P>
inline int dw_tile_rows(int c, int h) {
  int th = kDwTileRows;
  while (th > 0 && DwTile<P>::bytes(th, c) > (size_t)kDwSmemMax) --th;
  if (th == 0) return 0;
  const int tiles = (h + th - 1) / th;
  return (h + tiles - 1) / tiles;
}

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool in) {
  const uint32_t s = hopper::smem_u32(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(in ? 16 : 0)
               : "memory");
}

template <int P>
__global__ void __launch_bounds__(kDwThreads)
convnext_block_dw_ln_tile_kernel(const __nv_bfloat16* __restrict__ x,
                                 const float* __restrict__ taps,  // (49, C)
                                 const float* __restrict__ dw_b,
                                 const float* __restrict__ ln_w,
                                 const float* __restrict__ ln_b,
                                 __nv_bfloat16* __restrict__ z, int h, int w,
                                 int c, int th, float eps) {
  using L = DwTile<P>;
  extern __shared__ __align__(16) uint8_t dw_smem[];
  // Two input buffers, two tap buffers, then d.
  const size_t in_bytes = L::in_bytes(th);
  uint8_t* taps_base = dw_smem + 2 * in_bytes;
  float* d_s = reinterpret_cast<float*>(taps_base + 2 * L::kTapBytes);

  const int tiles_w = (w + P - 1) / P, tiles_h = (h + th - 1) / th;
  const int64_t img = blockIdx.x / (tiles_w * tiles_h);
  const int i0 = (int)(blockIdx.x / tiles_w % tiles_h) * th;
  const int j0 = (int)(blockIdx.x % tiles_w) * P;
  const __nv_bfloat16* xb = x + img * h * (int64_t)w * c;
  const int chunks = (c + kDwChunk - 1) / kDwChunk;
  const int cp = threadIdx.x % 32, r = threadIdx.x / 32;

  // Chunk ck's input and taps into buffer ck & 1, as one cp.async group.
  auto stage = [&](int ck) {
    const int c0 = ck * kDwChunk;
    uint8_t* dst = dw_smem + (ck & 1) * in_bytes;
    const int copies = (th + 6) * L::kCols * (kDwChunk / 8);
    for (int i = threadIdx.x; i < copies; i += kDwThreads) {
      const int pix = i / (kDwChunk / 8), q = i % (kDwChunk / 8);
      const int gi = i0 - 3 + pix / L::kCols, gj = j0 - 3 + pix % L::kCols;
      const int ch = c0 + 8 * q;
      const bool in = gi >= 0 && gi < h && gj >= 0 && gj < w && ch < c;
      const __nv_bfloat16* src =
          in ? xb + ((int64_t)gi * w + gj) * c + ch : xb;
      cp_async16_zfill(dst + pix * (kDwChunk * 2) + q * 16, src, in);
    }
    float* tdst = reinterpret_cast<float*>(taps_base + (ck & 1) * L::kTapBytes);
    for (int i = threadIdx.x; i < 49 * (kDwChunk / 4); i += kDwThreads) {
      const int tap = i / (kDwChunk / 4), q = i % (kDwChunk / 4);
      const int ch = c0 + 4 * q;
      const bool in = ch < c;
      cp_async16_zfill(tdst + tap * kDwChunk + 4 * q,
                       in ? taps + (int64_t)tap * c + ch : taps, in);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  stage(0);
  for (int ck = 0; ck < chunks; ++ck) {
    if (ck + 1 < chunks) {
      stage(ck + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int ch = ck * kDwChunk + 2 * cp;
    if (r < th && ch < c) {
      const uint8_t* in = dw_smem + (ck & 1) * in_bytes;
      const float* tp =
          reinterpret_cast<const float*>(taps_base + (ck & 1) * L::kTapBytes);
      float acc0[P], acc1[P];
#pragma unroll
      for (int q = 0; q < P; ++q) acc0[q] = acc1[q] = 0.f;
#pragma unroll
      for (int di = 0; di < 7; ++di) {
        float x0[P + 6], x1[P + 6];
        const uint8_t* row_s = in + (r + di) * L::kCols * (kDwChunk * 2) + 4 * cp;
#pragma unroll
        for (int jj = 0; jj < P + 6; ++jj) {
          const uint32_t v =
              *reinterpret_cast<const uint32_t*>(row_s + jj * (kDwChunk * 2));
          x0[jj] = __uint_as_float(v << 16);
          x1[jj] = __uint_as_float(v & 0xffff0000u);
        }
#pragma unroll
        for (int dj = 0; dj < 7; ++dj) {
          const float2 t =
              *reinterpret_cast<const float2*>(tp + (di * 7 + dj) * kDwChunk + 2 * cp);
#pragma unroll
          for (int q = 0; q < P; ++q) {
            acc0[q] = fmaf(x0[q + dj], t.x, acc0[q]);
            acc1[q] = fmaf(x1[q + dj], t.y, acc1[q]);
          }
        }
      }
      const float b0 = __ldg(dw_b + ch), b1 = __ldg(dw_b + ch + 1);
#pragma unroll
      for (int q = 0; q < P; ++q)
        *reinterpret_cast<float2*>(d_s + (r * P + q) * c + ch) =
            make_float2(acc0[q] + b0, acc1[q] + b1);
    }
    __syncthreads();   // the buffer is staged again two chunks on
  }

  // The LayerNorm of each pixel of the tile that lies on the map.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = warp; p < th * P; p += kDwThreads / 32) {
    const int pi = i0 + p / P, pj = j0 + p % P;
    if (pi >= h || pj >= w) continue;
    const float* d = d_s + p * c;
    float s = 0.f, ss = 0.f;
    for (int k = 8 * lane; k < c; k += 256) {
#pragma unroll
      for (int e = 0; e < 8; e += 4) {
        const float4 v = *reinterpret_cast<const float4*>(d + k + e);
        s += v.x + v.y + v.z + v.w;
        ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    const float mu = s / (float)c;
    const float rs = rsqrtf(fmaxf(ss / (float)c - mu * mu, 0.f) + eps);
    __nv_bfloat16* zr = z + ((img * h + pi) * (int64_t)w + pj) * c;
    for (int k = 8 * lane; k < c; k += 256) {
      float dv[8], wv[8], bv[8];
#pragma unroll
      for (int e = 0; e < 8; e += 4) {
        *reinterpret_cast<float4*>(dv + e) =
            *reinterpret_cast<const float4*>(d + k + e);
        *reinterpret_cast<float4*>(wv + e) =
            __ldg(reinterpret_cast<const float4*>(ln_w + k + e));
        *reinterpret_cast<float4*>(bv + e) =
            __ldg(reinterpret_cast<const float4*>(ln_b + k + e));
      }
      uint32_t packed[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2)
        packed[e / 2] =
            hopper::pack_bf16(((dv[e] - mu) * rs) * wv[e] + bv[e],
                              ((dv[e + 1] - mu) * rs) * wv[e + 1] + bv[e + 1]);
      *reinterpret_cast<uint4*>(zr + k) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  }
}

template <int P>
int launch_dw_ln_tile(const void* x, const float* taps, const float* dw_b,
                      const float* ln_w, const float* ln_b, void* z, int b,
                      int height, int width, int c, int th, float eps,
                      cudaStream_t stream) {
  const size_t smem = DwTile<P>::bytes(th, c);
  const int64_t blocks = (int64_t)b * ((height + th - 1) / th) *
                         ((width + P - 1) / P);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      convnext_block_dw_ln_tile_kernel<P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  convnext_block_dw_ln_tile_kernel<P><<<(unsigned)blocks, kDwThreads, smem,
                                        stream>>>(
      static_cast<const __nv_bfloat16*>(x), taps, dw_b, ln_w, ln_b,
      static_cast<__nv_bfloat16*>(z), height, width, c, th, eps);
  return (int)cudaGetLastError();
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

CNX_WGMMA_KERNEL(convnext_block_fc1_wgmma_kernel, false, kGeluTanh)
CNX_WGMMA_KERNEL(convnext_block_fc2_wgmma_kernel, false, kResidual)

// maps: NULL, or the product's maps (kGemmMapsSize values, bf16 only),
// which select the TMA + wgmma body.
template <typename T, bool FC1>
int launch_block_gemm(const GemmArgs& args, const int64_t* maps,
                      cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (maps != nullptr)
      return FC1 ? launch_convnext_block_fc1_wgmma_kernel(args, maps, stream)
                 : launch_convnext_block_fc2_wgmma_kernel(args, maps, stream);
    return launch_gemm<T>(convnext_block_gemm_bf16_kernel<FC1>, args, stream);
  } else {
    return launch_gemm<T>(convnext_block_gemm_f32_kernel<FC1>, args, stream);
  }
}

template <typename T>
int launch_all(const void* x, const float* taps, const float* dw_b,
               const float* ln_w, const float* ln_b, const void* w1,
               const float* b1, const void* w2, const float* b2,
               const float* gamma, void* z, void* h, void* out, int b,
               int height, int width, int c, int hidden, float eps,
               const int64_t* maps, cudaStream_t stream) {
  constexpr int V = vec_len<T>();
  const int64_t m = (int64_t)b * height * width;
  if (m > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  int err;
  // The tiled depthwise launch where its 16-byte copies and loads hold (bf16,
  // C % 8 == 0, x, z, the taps and the LN vectors 16-byte aligned) and a
  // tile's f32 rows fit; else the row-run form.
  const int tile_cols = width % 7 == 0 ? 7 : 8;
  const bool tiled = sizeof(T) == 2 && c % 8 == 0 && aligned16(x) &&
                     aligned16(z) && aligned16(taps) && aligned16(ln_w) &&
                     aligned16(ln_b);
  const int th = !tiled ? 0
                 : tile_cols == 7 ? dw_tile_rows<7>(c, height)
                                  : dw_tile_rows<8>(c, height);
  if (th > 0) {
    err = tile_cols == 7
              ? launch_dw_ln_tile<7>(x, taps, dw_b, ln_w, ln_b, z, b, height,
                                     width, c, th, eps, stream)
              : launch_dw_ln_tile<8>(x, taps, dw_b, ln_w, ln_b, z, b, height,
                                     width, c, th, eps, stream);
  } else {
    const int pix = dw_pixels(c);
    if (pix == 0) return (int)cudaErrorInvalidValue;
    const int64_t dw_blocks = (int64_t)b * height * ((width + pix - 1) / pix);
    if (dw_blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    const int smem = pix * c * (int)sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        convnext_block_dw_ln_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    convnext_block_dw_ln_kernel<T><<<(unsigned)dw_blocks, kDwThreads, smem,
                                     stream>>>(
        static_cast<const T*>(x), taps, dw_b, ln_w, ln_b, static_cast<T*>(z),
        height, width, c, pix, eps);
    err = (int)cudaGetLastError();
  }
  if (err != 0) return err;

  GemmArgs fc1 = {z, w1, h, nullptr, nullptr, nullptr, nullptr, nullptr, b1,
                  nullptr, (int)m, hidden, c,
                  c % V == 0 && aligned16(z) && aligned16(w1)};
  err = launch_block_gemm<T, true>(fc1, maps, stream);
  if (err != 0) return err;

  GemmArgs fc2 = {h, w2, out, x, nullptr, nullptr, nullptr, nullptr, b2,
                  gamma, (int)m, c, hidden,
                  hidden % V == 0 && aligned16(h) && aligned16(w2)};
  return launch_block_gemm<T, false>(
      fc2, maps ? maps + kGemmMapsSize : nullptr, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. taps (49, C), dw_b, ln_w, ln_b, b1, b2
// and gamma are f32; z (B*H*W, C) and h (B*H*W, hidden) in the dtype are
// scratch the caller allocates. maps: NULL for the mma.sync GEMM body, or
// (bf16) two products' maps of tma.py · packed_gemm_maps, fc1's (z, w1, h)
// then fc2's (h, w2, out, x), each with its grid, which select the TMA +
// wgmma body. The depthwise launch picks its own form (launch_all).
// Returns a cudaError_t value (0 = ok).
extern "C" int tfimm_convnext_block(const void* x, const void* taps,
                                    const void* dw_b, const void* ln_w,
                                    const void* ln_b, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, const void* gamma,
                                    void* z, void* h, void* out, int b,
                                    int height, int width, int c, int hidden,
                                    float eps, int dtype, const int64_t* maps,
                                    void* stream) {
  if (b <= 0 || height <= 0 || width <= 0 || c <= 0 || hidden <= 0)
    return (int)cudaErrorInvalidValue;
  if (maps != nullptr && dtype != 1) return (int)cudaErrorInvalidValue;
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
                               eps, nullptr, s);
    case 1:
      return launch_all<__nv_bfloat16>(x, f[0], f[1], f[2], f[3], w1, f[4],
                                       w2, f[5], f[6], z, h, out, b, height,
                                       width, c, hidden, eps, maps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
