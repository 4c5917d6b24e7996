// The MLP GEMM tiles shared by convnext_mlp.cu, convnext_block.cu and
// ln_dense.cu (its forward): a
// tiled "A row-major times B row-major transposed" product, out = epi(A @
// B^T), with an optional LayerNorm prologue on the A tiles. See the note at
// the top of convnext_mlp.cu for the tiling. Every function here is inline
// (or a template), so the two objects that include it link together; the
// __global__ kernels that call the bodies live in each source's anonymous
// namespace.
//
// Prologues (kLn): false, A is read as it is; true, A is x and the tile is
// formed as LN(x) = ((x - mean) * rstd) * ln_w + ln_b from per-row f32
// statistics, rounded to the dtype (0 outside the matrix).
// Epilogues (Epi): kGeluErf and kGeluTanh give gelu(acc + bias) in f32,
// rounded to the dtype; kResidual gives shortcut + gamma * (acc + bias) in
// f32, rounded once; kBias gives acc + bias in f32 (acc alone where bias is
// NULL), rounded once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cnx {

constexpr int kThreads = 256;

enum Epi { kGeluErf = 0, kGeluTanh = 1, kResidual = 2, kBias = 3 };

struct GemmArgs {
  const void* a;         // (M, K): x (LN prologue), z or h
  const void* b;         // (N, K): w1 or w2
  void* out;             // (M, N)
  const void* shortcut;  // kResidual: (M, N)
  const float* mean;     // LN prologue: (M,)
  const float* rstd;     // LN prologue: (M,)
  const float* ln_w;     // LN prologue: (K,)
  const float* ln_b;     // LN prologue: (K,)
  const float* bias;     // (N,); kBias: may be NULL
  const float* gamma;    // kResidual: (N,)
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

// The exact erf GELU and its tanh form, in f32.
__device__ __forceinline__ float gelu_erf(float s) {
  return 0.5f * s * (1.f + erff(s * 0.70710678118654752f));
}
__device__ __forceinline__ float gelu_tanh(float s) {
  const float u = 0.7978845608028654f * (s + 0.044715f * s * s * s);
  return 0.5f * s * (1.f + tanhf(u));
}

// One row's LayerNorm statistics, by the 32 lanes of a warp: the f32 mean
// and rstd = rsqrt(max(E[x^2] - mean^2, 0) + eps), the one-pass variance of
// the JAX package's LayerNorm. vec: 16-byte loads (c % vec_len == 0 and x
// 16-byte aligned).
template <typename T>
__device__ __forceinline__ void row_stats_warp(const T* __restrict__ xr, int c,
                                               float eps, int vec, int lane,
                                               float* mean, float* rstd) {
  constexpr int V = vec_len<T>();
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
    *mean = mu;
    *rstd = rsqrtf(var + eps);
  }
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

// The LN prologue: chunk (row, k ..) of x -> z, rounded to T; 0 outside
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

// The epilogue, for one output element (row < M, col < N).
template <typename T, int E>
__device__ __forceinline__ void store_out(const GemmArgs& p, int row, int col,
                                          float acc) {
  const int64_t off = (int64_t)row * p.n + col;
  float v;
  if (E == kGeluErf) {
    v = gelu_erf(acc + __ldg(p.bias + col));
  } else if (E == kGeluTanh) {
    v = gelu_tanh(acc + __ldg(p.bias + col));
  } else if (E == kBias) {
    v = p.bias ? acc + __ldg(p.bias + col) : acc;
  } else {
    const T sc = static_cast<const T*>(p.shortcut)[off];
    v = to_f(sc) + __ldg(p.gamma + col) * (acc + __ldg(p.bias + col));
  }
  static_cast<T*>(p.out)[off] = from_f<T>(v);
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
// under the LN prologue.
template <bool kLn>
__device__ __forceinline__ void mma_store(MmaStage& st, const GemmArgs& p,
                                          __nv_bfloat16* buf, int m0, int k0,
                                          const float* mean_s,
                                          const float* rstd_s) {
#pragma unroll
  for (int i = 0; i < kChunksA; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kCpr, kc = (c % kCpr) * 8;
    if (kLn) layer_norm_chunk(st.a[i], m0 + r, k0 + kc, p, mean_s[r], rstd_s[r]);
    *reinterpret_cast<uint4*>(buf + r * kLd + kc) = st.a[i].u;
  }
  __nv_bfloat16* bs = buf + kBM * kLd;
#pragma unroll
  for (int i = 0; i < kChunksB; ++i) {
    const int c = threadIdx.x + i * kThreads;
    *reinterpret_cast<uint4*>(bs + (c / kCpr) * kLd + (c % kCpr) * 8) = st.b[i].u;
  }
}

// One 128 x 128 output tile of a kThreads block; smem_raw holds kMmaSmem
// bytes of dynamic shared memory.
template <bool kLn, int E>
__device__ __forceinline__ void gemm_bf16_tile(const GemmArgs& p,
                                               unsigned char* smem_raw) {
  using T = __nv_bfloat16;
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

  if (kLn) {
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
  mma_store<kLn>(st, p, tiles, m0, 0, mean_s, rstd_s);
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
    if (more) mma_store<kLn>(st, p, tiles + (buf ^ 1) * kTileElems, m0,
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
        if (col < p.n) store_out<T, E>(p, row, col, acc[mt][nt][2 * half]);
        if (col + 1 < p.n)
          store_out<T, E>(p, row, col + 1, acc[mt][nt][2 * half + 1]);
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

// One 64 x 64 output tile of a kThreads block; smem_raw holds kFmaSmem
// bytes of dynamic shared memory.
template <bool kLn, int E>
__device__ __forceinline__ void gemm_f32_tile(const GemmArgs& p,
                                              unsigned char* smem_raw) {
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

  if (kLn) {
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
    if (kLn) layer_norm_chunk(ra, m0 + lr, kt * kFBK + lk, p, mean_s[lr], rstd_s[lr]);
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
      if (col < p.n) store_out<float, E>(p, row, col, acc[i][j]);
    }
  }
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// Launch ``kernel``, a __global__ wrapper of gemm_bf16_tile (T = bf16) or
// gemm_f32_tile (T = f32) that passes it its dynamic shared memory, for one
// product. Returns a cudaError_t value.
template <typename T>
inline int launch_gemm(void (*kernel)(GemmArgs), const GemmArgs& args,
                       cudaStream_t stream) {
  constexpr bool kMma = sizeof(T) == 2;
  const int bm = kMma ? kBM : kFBM, bn = kMma ? kBN : kFBN;
  const size_t smem = kMma ? kMmaSmem : kFmaSmem;
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)((args.m + bm - 1) / bm) * ((args.n + bn - 1) / bn);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  GemmArgs a = args;
  void* params[] = {&a};
  err = cudaLaunchKernel(fn, dim3((unsigned)blocks), dim3(kThreads), params,
                         smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace cnx
