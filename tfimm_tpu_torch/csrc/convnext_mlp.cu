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
// Both GEMMs share one kernel template per dtype:
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

namespace {

constexpr int kThreads = 256;

struct GemmArgs {
  const void* a;         // fc1: x (M, C); fc2: h (M, H)
  const void* b;         // fc1: w1 (H, C); fc2: w2 (C, H)
  void* out;             // fc1: h (M, H); fc2: out (M, C)
  const void* shortcut;  // fc2: (M, C)
  const float* mean;     // fc1: (M,)
  const float* rstd;     // fc1: (M,)
  const float* ln_w;     // fc1: (C,)
  const float* ln_b;     // fc1: (C,)
  const float* bias;     // fc1: b1 (H,); fc2: b2 (C,)
  const float* gamma;    // fc2: (C,)
  int m, n, k;           // output rows, output columns, depth
  int vec;               // 16-byte loads of A and B allowed
};

// Elements of T per 16-byte load.
template <typename T>
__host__ __device__ constexpr int vec_len() { return 16 / (int)sizeof(T); }

// One 16-byte chunk of a tile, kept in registers between its global load
// and its store to shared memory; elements read and written as f32.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  union {
    uint4 u;
    float e[4];
  };
  __device__ __forceinline__ float get(int j) const { return e[j]; }
  __device__ __forceinline__ void set(int j, float v) { e[j] = v; }
  __device__ __forceinline__ void copy(int j, const float* p) { e[j] = *p; }
};

template <>
struct Chunk<__nv_bfloat16> {
  union {
    uint4 u;
    unsigned short e[8];
  };
  __device__ __forceinline__ float get(int j) const {
    return __bfloat162float(__ushort_as_bfloat16(e[j]));
  }
  __device__ __forceinline__ void set(int j, float v) {
    e[j] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ __forceinline__ void copy(int j, const __nv_bfloat16* p) {
    e[j] = __bfloat16_as_ushort(*p);
  }
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The GELU of the kernel's dtype policy, in f32: exact erf for f32 io, the
// tanh form for bf16 io.
template <typename T>
__device__ __forceinline__ float gelu(float s);
template <>
__device__ __forceinline__ float gelu<float>(float s) {
  return 0.5f * s * (1.f + erff(s * 0.70710678118654752f));
}
template <>
__device__ __forceinline__ float gelu<__nv_bfloat16>(float s) {
  const float u = 0.7978845608028654f * (s + 0.044715f * s * s * s);
  return 0.5f * s * (1.f + tanhf(u));
}

// Load vec_len<T>() consecutive elements (row, k .. k + V - 1) of a
// row-major (rows, depth) matrix; zeros outside it.
template <typename T>
__device__ __forceinline__ Chunk<T> load_chunk(const T* __restrict__ src,
                                               int row, int rows, int k,
                                               int depth, int vec) {
  constexpr int V = vec_len<T>();
  Chunk<T> c;
  c.u = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows) return c;
  const T* p = src + (int64_t)row * depth + k;
  if (vec) {
    if (k < depth) c.u = *reinterpret_cast<const uint4*>(p);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (k + j < depth) c.copy(j, p + j);
  }
  return c;
}

// The fc1 prologue: chunk (row, k ..) of x -> z, rounded to T; 0 outside
// the matrix.
template <typename T>
__device__ __forceinline__ void layer_norm_chunk(Chunk<T>& c, int row, int k,
                                                 const GemmArgs& p, float mu,
                                                 float rs) {
  constexpr int V = vec_len<T>();
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float z = 0.f;
    if (row < p.m && k + j < p.k)
      z = ((c.get(j) - mu) * rs) * __ldg(p.ln_w + k + j) +
          __ldg(p.ln_b + k + j);
    c.set(j, z);
  }
}

// The two epilogues, for one output element (row < M, col < N).
template <typename T, bool FC1>
__device__ __forceinline__ void store_out(const GemmArgs& p, int row, int col,
                                          float acc) {
  const int64_t off = (int64_t)row * p.n + col;
  float v;
  if (FC1) {
    v = gelu<T>(acc + __ldg(p.bias + col));
  } else {
    const T sc = static_cast<const T*>(p.shortcut)[off];
    v = to_f(sc) + __ldg(p.gamma + col) * (acc + __ldg(p.bias + col));
  }
  static_cast<T*>(p.out)[off] = from_f<T>(v);
}

// ---------------------------------------------------------------------------
// Row statistics: one warp per row.

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_stats_kernel(const T* __restrict__ x, float* __restrict__ mean,
                 float* __restrict__ rstd, int m, int c, float eps, int vec) {
  constexpr int V = vec_len<T>();
  const int64_t row = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;
  const T* xr = x + row * c;
  float s = 0.f, ss = 0.f;
  if (vec) {
    for (int k = lane * V; k < c; k += 32 * V) {
      Chunk<T> ch;
      ch.u = *reinterpret_cast<const uint4*>(xr + k);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float v = ch.get(j);
        s += v;
        ss += v * v;
      }
    }
  } else {
    for (int k = lane; k < c; k += 32) {
      const float v = to_f(xr[k]);
      s += v;
      ss += v * v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  if (lane == 0) {
    const float mu = s / (float)c;
    const float var = fmaxf(ss / (float)c - mu * mu, 0.f);
    mean[row] = mu;
    rstd[row] = rsqrtf(var + eps);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, ldmatrix)

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kLd = kBK + 8;                         // padded smem row
constexpr int kCpr = kBK / 8;                        // 16-byte chunks per row
constexpr int kChunksA = kBM * kCpr / kThreads;      // per thread
constexpr int kChunksB = kBN * kCpr / kThreads;
constexpr int kTileElems = (kBM + kBN) * kLd;        // one buffer, A then B
constexpr size_t kMmaSmem =
    2 * kTileElems * sizeof(__nv_bfloat16) + 2 * kBM * sizeof(float);

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// This thread's share of the next k tile, from global memory to registers.
struct MmaStage {
  Chunk<__nv_bfloat16> a[kChunksA], b[kChunksB];
};

__device__ __forceinline__ void mma_load(MmaStage& st, const GemmArgs& p,
                                         int m0, int n0, int k0) {
  using T = __nv_bfloat16;
#pragma unroll
  for (int i = 0; i < kChunksA; ++i) {
    const int c = threadIdx.x + i * kThreads;
    st.a[i] = load_chunk<T>(static_cast<const T*>(p.a), m0 + c / kCpr, p.m,
                            k0 + (c % kCpr) * 8, p.k, p.vec);
  }
#pragma unroll
  for (int i = 0; i < kChunksB; ++i) {
    const int c = threadIdx.x + i * kThreads;
    st.b[i] = load_chunk<T>(static_cast<const T*>(p.b), n0 + c / kCpr, p.n,
                            k0 + (c % kCpr) * 8, p.k, p.vec);
  }
}

// Registers to one shared buffer (A rows then B rows), forming z on the way
// for fc1.
template <bool FC1>
__device__ __forceinline__ void mma_store(MmaStage& st, const GemmArgs& p,
                                          __nv_bfloat16* buf, int m0, int k0,
                                          const float* mean_s,
                                          const float* rstd_s) {
#pragma unroll
  for (int i = 0; i < kChunksA; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kCpr, kc = (c % kCpr) * 8;
    if (FC1) layer_norm_chunk(st.a[i], m0 + r, k0 + kc, p, mean_s[r], rstd_s[r]);
    *reinterpret_cast<uint4*>(buf + r * kLd + kc) = st.a[i].u;
  }
  __nv_bfloat16* bs = buf + kBM * kLd;
#pragma unroll
  for (int i = 0; i < kChunksB; ++i) {
    const int c = threadIdx.x + i * kThreads;
    *reinterpret_cast<uint4*>(bs + (c / kCpr) * kLd + (c % kCpr) * 8) = st.b[i].u;
  }
}

template <bool FC1>
__global__ void __launch_bounds__(kThreads)
mlp_gemm_bf16_kernel(GemmArgs p) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);
  float* mean_s = reinterpret_cast<float*>(tiles + 2 * kTileElems);
  float* rstd_s = mean_s + kBM;

  const int n_blocks = (p.n + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / n_blocks) * kBM;
  const int n0 = (blockIdx.x % n_blocks) * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * 64;   // warp's first row in the tile
  const int wn = (warp % 4) * 32;   // warp's first column in the tile

  if (FC1) {
    for (int r = tid; r < kBM; r += kThreads) {
      const int row = m0 + r;
      mean_s[r] = row < p.m ? p.mean[row] : 0.f;
      rstd_s[r] = row < p.m ? p.rstd[row] : 0.f;
    }
    __syncthreads();
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  MmaStage st;
  const int k_tiles = (p.k + kBK - 1) / kBK;
  mma_load(st, p, m0, n0, 0);
  mma_store<FC1>(st, p, tiles, m0, 0, mean_s, rstd_s);
  __syncthreads();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < k_tiles;
    if (more) mma_load(st, p, m0, n0, (kt + 1) * kBK);
    const T* as = tiles + buf * kTileElems;
    const T* bs = as + kBM * kLd;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], as + (wm + mt * 16 + lane % 16) * kLd + ks +
                                (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, bs + (wn + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                           ks + ((lane >> 3) & 1) * 8);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_16816(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
    // The other buffer was last read before the previous barrier.
    if (more) mma_store<FC1>(st, p, tiles + (buf ^ 1) * kTileElems, m0,
                             (kt + 1) * kBK, mean_s, rstd_s);
    __syncthreads();
  }

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn + nt * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mt * 16 + g + 8 * half;
        if (row >= p.m) continue;
        if (col < p.n) store_out<T, FC1>(p, row, col, acc[mt][nt][2 * half]);
        if (col + 1 < p.n)
          store_out<T, FC1>(p, row, col + 1, acc[mt][nt][2 * half + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA

constexpr int kFBM = 64;
constexpr int kFBN = 64;
constexpr int kFBK = 16;
constexpr int kFLd = kFBM + 4;                       // k-major smem row
constexpr int kFCpr = kFBK / 4;                      // 16-byte chunks per row
constexpr int kFTileElems = kFBK * kFLd * 2;         // one buffer, A then B
constexpr size_t kFmaSmem =
    2 * kFTileElems * sizeof(float) + 2 * kFBM * sizeof(float);
static_assert(kFBM == kFBN, "A and B tiles share a k-major row length");
static_assert(kFBM * kFCpr == kThreads, "one A chunk and one B chunk per thread");

template <bool FC1>
__global__ void __launch_bounds__(kThreads)
mlp_gemm_f32_kernel(GemmArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tiles = reinterpret_cast<float*>(smem_raw);
  float* mean_s = tiles + 2 * kFTileElems;
  float* rstd_s = mean_s + kFBM;

  const int n_blocks = (p.n + kFBN - 1) / kFBN;
  const int m0 = (blockIdx.x / n_blocks) * kFBM;
  const int n0 = (blockIdx.x % n_blocks) * kFBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* a = static_cast<const float*>(p.a);
  const float* b = static_cast<const float*>(p.b);

  if (FC1) {
    for (int r = tid; r < kFBM; r += kThreads) {
      const int row = m0 + r;
      mean_s[r] = row < p.m ? p.mean[row] : 0.f;
      rstd_s[r] = row < p.m ? p.rstd[row] : 0.f;
    }
    __syncthreads();
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // This thread's chunk of each tile: row lr, depth lk .. lk + 3.
  const int lr = tid / kFCpr, lk = (tid % kFCpr) * 4;
  const int k_tiles = (p.k + kFBK - 1) / kFBK;
  Chunk<float> ra = load_chunk<float>(a, m0 + lr, p.m, lk, p.k, p.vec);
  Chunk<float> rb = load_chunk<float>(b, n0 + lr, p.n, lk, p.k, p.vec);
  for (int kt = 0; kt < k_tiles; ++kt) {
    // Store tile kt (loaded one iteration earlier) to buffer kt & 1, whose
    // last readers finished before the previous barrier, then load tile
    // kt + 1 and multiply tile kt.
    float* as = tiles + (kt & 1) * kFTileElems;
    float* bs = as + kFBK * kFLd;
    if (FC1) layer_norm_chunk(ra, m0 + lr, kt * kFBK + lk, p, mean_s[lr], rstd_s[lr]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      as[(lk + j) * kFLd + lr] = ra.get(j);
      bs[(lk + j) * kFLd + lr] = rb.get(j);
    }
    __syncthreads();
    if (kt + 1 < k_tiles) {
      const int k0 = (kt + 1) * kFBK;
      ra = load_chunk<float>(a, m0 + lr, p.m, k0 + lk, p.k, p.vec);
      rb = load_chunk<float>(b, n0 + lr, p.n, k0 + lk, p.k, p.vec);
    }
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk * kFLd + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk * kFLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < p.n) store_out<float, FC1>(p, row, col, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <typename T, bool FC1>
int launch_gemm(const GemmArgs& args, cudaStream_t stream) {
  constexpr bool kMma = sizeof(T) == 2;
  const int bm = kMma ? kBM : kFBM, bn = kMma ? kBN : kFBN;
  const size_t smem = kMma ? kMmaSmem : kFmaSmem;
  cudaError_t err;
  if constexpr (kMma)
    err = cudaFuncSetAttribute(mlp_gemm_bf16_kernel<FC1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  else
    err = cudaFuncSetAttribute(mlp_gemm_f32_kernel<FC1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)((args.m + bm - 1) / bm) * ((args.n + bn - 1) / bn);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  if constexpr (kMma)
    mlp_gemm_bf16_kernel<FC1><<<(unsigned)blocks, kThreads, smem, stream>>>(args);
  else
    mlp_gemm_f32_kernel<FC1><<<(unsigned)blocks, kThreads, smem, stream>>>(args);
  return (int)cudaGetLastError();
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
  err = launch_gemm<T, true>(fc1, stream);
  if (err != 0) return err;

  GemmArgs fc2 = {h, w2, out, shortcut, nullptr, nullptr, nullptr, nullptr,
                  b2, gamma, m, c, hidden,
                  hidden % V == 0 && aligned16(h) && aligned16(w2)};
  return launch_gemm<T, false>(fc2, stream);
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
