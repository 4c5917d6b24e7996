// The MLP GEMM tiles shared by convnext_mlp.cu, convnext_block.cu,
// ln_dense.cu (its forward), swin_block.cu and poolformer_block.cu: a tiled
// "A row-major times B row-major transposed" product, out = epi(A @ B^T),
// with an optional norm prologue on the A tiles. Every function here is
// inline (or a template), so the objects that include it link together; the
// __global__ kernels that call the bodies live in each source's anonymous
// namespace (CNX_WGMMA_KERNEL declares the wgmma body's there). row_stats
// gives the LN prologue its per-row statistics.
//
// Prologues (Pro): kPlain, A is read as it is, in the dtype; kLnRows, A is
// x in the dtype and the tile is formed as LN(x) = ((x - mean) * rstd) *
// ln_w + ln_b from its row's f32 statistics; kNormF32, A is x in f32 and
// the tile is formed the same way from the statistics of row / p.group
// (p.group rows share them: 1 for Swin's LN2 on X2, an image's H * W rows
// for PoolFormer's GroupNorm on x1). z is rounded to the dtype, 0 outside
// the matrix.
// Epilogues (Epi), in f32 from acc: kGeluErf and kGeluTanh give gelu(acc +
// bias), rounded to the dtype; kResidual gives shortcut + gamma * (acc +
// bias), the shortcut in the dtype, rounded once; kBias gives acc + bias
// (acc alone where bias is NULL), rounded once; kResidualF32 is kResidual
// with an f32 shortcut and gamma NULL meaning 1 (the fc2 of PoolFormer and
// Swin); kProj writes f32 shortcut + round(acc + bias), the shortcut in the
// dtype (Swin's X2 = x + P), and on the wgmma body, where one tile holds
// whole rows, also their statistics for the next LayerNorm (row_mean,
// row_rstd); kGeluRounded gives gelu(round(acc + bias)) of
// the dtype policy (tanh form in bf16, exact erf in f32: Swin's fc1),
// rounded.
//
// Three bodies:
//
// - bf16 on Hopper (gemm_bf16_wgmma), the route of every operand set that
//   tma.py · gemm_route takes (bf16 A, B and outputs, f32 A, shortcut or
//   output where the prologue or epilogue reads or writes f32, all
//   contiguous with 16-byte aligned rows of 16 bytes' multiple; the norm
//   prologue up to K = 4096): every registered ConvNeXt width, ViT-B/16's
//   ln_dense, every Swin block in bf16 and PoolFormer's registered widths.
//   A persistent grid of one block an SM walks 128 x BN output tiles (BN =
//   128, 192 or 256, tma.py · gemm_width) in 64-deep k steps (one 128-byte
//   swizzle row of bf16; two of f32). A producer warpgroup (40 registers a
//   thread by setmaxnreg) has one thread stream A (128 x 64) and B (BN x 64)
//   tiles by TMA into a ring of stages (WgmmaTiles: as many as fit, up to
//   5), signalled on a "full" mbarrier by the transaction count and
//   released on an "empty" one by the consumers' warps. Two consumer
//   warpgroups (232 registers) own 64 rows each and run wgmma m64nBNk16
//   with the accumulator in registers (BN / 2 a thread), one group in
//   flight. The norm prologue reads the landed x tile (bf16, or f32 in two
//   32-column boxes) from shared memory, normalises it in f32 with the
//   row's mean and rstd and the column pair's affine (kept in shared
//   memory for all of K) and feeds wgmma A from registers. The epilogue
//   runs in f32 from the accumulator, writes the rounded tile into a
//   swizzled staging buffer (64-column boxes of bf16, 32-column ones of
//   f32) and leaves it to one TMA store a box, which drops rows past M and
//   columns past N; a shortcut tile is loaded by TMA into the same buffer
//   while the products run (where the shortcut and the output differ in
//   type, each thread forms its outputs in its accumulator before a
//   warpgroup barrier, then writes them over the shortcut). TMA's zero
//   fill past M, N and K stands in for masked loads.
//   What bounds it (PERF.md row 3): at ConvNeXt-B bs128 its products run
//   at about half of the bf16 peak, below cuBLAS's mainloop on the same
//   shapes, and fc1 adds its GELU epilogue (an exponential and a
//   reciprocal on the special-function unit an element, not overlapped
//   with the products) and, in convnext_mlp, the LN prologue's f32 work.
//   Swin's and PoolFormer's products are narrow (K or N = C = 64-384) and
//   move more bytes than they do operations: device memory bounds them
//   (PERF.md rows 6, 15).
//   Tried on the H100 and dropped, each slower or no faster than this form
//   in development builds at ConvNeXt-B's shapes: z formed in shared
//   memory by the producer warpgroup's three spare warps (the consumers
//   then on shared-memory A); clusters of two blocks sharing B by TMA
//   multicast; stores and shortcut loads from registers, to free the
//   staging for a fourth stage at BN = 256; two accumulator sets at
//   BN = 128, the GELU of one tile between the next tile's k steps (and
//   with a divergent path around the wgmmas, ptxas serialises them:
//   C7518); A registers formed while the previous group runs (ptxas
//   serialises every wgmma: C7513). At Swin-T's and PoolFormer-S12's
//   shapes, 64-row tiles with the two consumer warpgroups on
//   alternate tiles, each on a ring of its own (so that one's epilogue runs
//   beside the other's products): slower for both blocks.
// - bf16 elsewhere (gemm_bf16_tile: C or H not a multiple of 8, an
//   operand off 16 bytes, K above 4096 with the norm prologue): mma.sync
//   m16n8k16 fed by ldmatrix, 128 x 128 tiles, 32-deep k tiles staged
//   through registers into two shared buffers.
// - f32 (gemm_f32_tile): plain FMAs (TF32 would miss the 1e-5 bar), 64 x
//   64 tiles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cnx {

constexpr int kThreads = 256;

enum Pro { kPlain = 0, kLnRows = 1, kNormF32 = 2 };

enum Epi {
  kGeluErf = 0,
  kGeluTanh = 1,
  kResidual = 2,
  kBias = 3,
  kResidualF32 = 4,
  kProj = 5,
  kGeluRounded = 6
};

// What an epilogue reads or writes in f32 besides its accumulator.
__host__ __device__ constexpr bool f32_shortcut(int e) { return e == kResidualF32; }
__host__ __device__ constexpr bool f32_out(int e) { return e == kProj; }
__host__ __device__ constexpr bool has_shortcut(int e) {
  return e == kResidual || e == kResidualF32 || e == kProj;
}

struct GemmArgs {
  const void* a;         // (M, K): x (norm prologue), z or h
  const void* b;         // (N, K): w1 or w2
  void* out;             // (M, N)
  const void* shortcut;  // kResidual, kResidualF32, kProj: (M, N)
  const float* mean;     // norm prologue: (M,), or (M / group,)
  const float* rstd;     // norm prologue: as mean
  const float* ln_w;     // norm prologue: (K,)
  const float* ln_b;     // norm prologue: (K,)
  const float* bias;     // (N,); kBias: may be NULL
  const float* gamma;    // kResidual: (N,); kResidualF32: (N,) or NULL
  int m, n, k;           // output rows, output columns, depth
  int vec;               // 16-byte loads of A and B allowed
  int group;             // kNormF32: rows a statistic (1: each row)
  // kProj on the wgmma body, where the tile holds whole rows (N <= BN):
  // NULL, or the f32 output's row statistics (M,), as row_stats gives them.
  float* row_mean;
  float* row_rstd;
  float eps;
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

// v rounded to T and back to f32.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// The GELU of the dtype policy: exact erf for f32, the tanh form for bf16.
template <typename T>
__device__ __forceinline__ float gelu_of(float s) {
  return sizeof(T) == 4 ? gelu_erf(s) : gelu_tanh(s);
}

// The statistics' index of A's row `row` under prologue P: the row, or
// under kNormF32 its group of p.group rows.
template <int P>
__device__ __forceinline__ int stat_index(const GemmArgs& p, int row) {
  return P == kNormF32 ? row / p.group : row;
}

// LayerNorm statistics of the rows of x (M, C): each row's f32 mean and
// rstd = rsqrt(max(E[x^2] - mean^2, 0) + eps), the one-pass variance of
// the JAX package's LayerNorm. vec: 16-byte loads (c % vec_len == 0 and x
// 16-byte aligned). A warp takes its rows in groups of G lanes a row, each
// group R rows with all their loads in flight before the sums: G = 32 and
// R = 1 (a warp a row), but for bf16 rows of 16-byte chunks below C = 256
// (512 bytes), which would leave most of a warp's lanes idle: there G = 16
// (C >= 128) or 8 and R = 4, so a warp covers 8 or 16 rows.
template <typename T>
__host__ __device__ inline int stats_lanes(int c, int vec) {
  return sizeof(T) == 2 && vec && c < 256 ? (c >= 128 ? 16 : 8) : 32;
}
__host__ __device__ inline int stats_rows_a_warp(int lanes) {
  return lanes == 32 ? 1 : 4 * 32 / lanes;
}

// Blocks of kThreads that row_stats needs for M rows.
template <typename T>
inline unsigned stats_blocks(int m, int c, int vec) {
  const int64_t rows_a_block =
      (int64_t)kThreads / 32 * stats_rows_a_warp(stats_lanes<T>(c, vec));
  return (unsigned)((m + rows_a_block - 1) / rows_a_block);
}

// Rows row0 + lane / G + (32 / G) i (i < R) of x, by groups of G lanes.
template <typename T, int G, int R>
__device__ __forceinline__ void row_stats_groups(const T* __restrict__ x,
                                                 float* __restrict__ mean,
                                                 float* __restrict__ rstd,
                                                 int64_t row0, int m, int c,
                                                 float eps, int vec) {
  constexpr int V = vec_len<T>();
  const int lane = threadIdx.x % 32, gl = lane % G;
  int64_t row[R];
  float s[R], ss[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    row[i] = row0 + lane / G + (int64_t)(32 / G) * i;
    s[i] = ss[i] = 0.f;
  }
  if (vec) {
    for (int k = V * gl; k < c; k += V * G) {
      Chunk<T> ch[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        ch[i].u = row[i] < m
                      ? *reinterpret_cast<const uint4*>(x + row[i] * c + k)
                      : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float v = ch[i].get(j);
          s[i] += v;
          ss[i] += v * v;
        }
      }
    }
  } else {
    for (int k = gl; k < c; k += G) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (row[i] >= m) continue;
        const float v = to_f(x[row[i] * c + k]);
        s[i] += v;
        ss[i] += v * v;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
      ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], off);
    }
    if (gl == 0 && row[i] < m) {
      const float mu = s[i] / (float)c;
      mean[row[i]] = mu;
      rstd[row[i]] = rsqrtf(fmaxf(ss[i] / (float)c - mu * mu, 0.f) + eps);
    }
  }
}

// The body of a row-statistics kernel of stats_blocks<T>(m, c, vec) blocks
// of kThreads.
template <typename T>
__device__ __forceinline__ void row_stats(const T* __restrict__ x,
                                          float* __restrict__ mean,
                                          float* __restrict__ rstd, int m,
                                          int c, float eps, int vec) {
  const int lanes = stats_lanes<T>(c, vec);
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int64_t row0 = warp * stats_rows_a_warp(lanes);
  if (row0 >= m) return;   // the whole warp
  if constexpr (sizeof(T) == 2) {
    if (lanes == 8)
      return row_stats_groups<T, 8, 4>(x, mean, rstd, row0, m, c, eps, vec);
    if (lanes == 16)
      return row_stats_groups<T, 16, 4>(x, mean, rstd, row0, m, c, eps, vec);
  }
  row_stats_groups<T, 32, 1>(x, mean, rstd, row0, m, c, eps, vec);
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

// The norm prologue of element (row, k) of x, given as the f32 value v:
// z in f32; 0 outside the matrix.
__device__ __forceinline__ float norm_value(float v, int row, int k,
                                            const GemmArgs& p, float mu,
                                            float rs) {
  if (row >= p.m || k >= p.k) return 0.f;
  return ((v - mu) * rs) * __ldg(p.ln_w + k) + __ldg(p.ln_b + k);
}

// The norm prologue: chunk (row, k ..) of x -> z, rounded to T; 0 outside
// the matrix.
template <typename T>
__device__ __forceinline__ void layer_norm_chunk(Chunk<T>& c, int row, int k,
                                                 const GemmArgs& p, float mu,
                                                 float rs) {
  constexpr int V = vec_len<T>();
#pragma unroll
  for (int j = 0; j < V; ++j)
    c.set(j, norm_value(c.get(j), row, k + j, p, mu, rs));
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
  } else if (E == kResidual) {
    const T sc = static_cast<const T*>(p.shortcut)[off];
    v = to_f(sc) + __ldg(p.gamma + col) * (acc + __ldg(p.bias + col));
  } else if (E == kResidualF32) {
    const float sc = static_cast<const float*>(p.shortcut)[off];
    v = sc + (p.gamma ? __ldg(p.gamma + col) : 1.f) *
                 (acc + __ldg(p.bias + col));
  } else if (E == kGeluRounded) {
    v = gelu_of<T>(round_to<T>(acc + __ldg(p.bias + col)));
  } else {   // kProj: an f32 output
    const T sc = static_cast<const T*>(p.shortcut)[off];
    static_cast<float*>(p.out)[off] =
        to_f(sc) + round_to<T>(acc + __ldg(p.bias + col));
    return;
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

// This thread's share of the next k tile, from global memory to registers;
// under kNormF32 A as f32 (two chunks for each bf16 one), normalised on its
// way to shared memory.
template <int P>
struct MmaStage {
  Chunk<__nv_bfloat16> a[P == kNormF32 ? 1 : kChunksA], b[kChunksB];
  Chunk<float> af[P == kNormF32 ? 2 * kChunksA : 1];
};

template <int P>
__device__ __forceinline__ void mma_load(MmaStage<P>& st, const GemmArgs& p,
                                         int m0, int n0, int k0) {
  using T = __nv_bfloat16;
#pragma unroll
  for (int i = 0; i < kChunksA; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = m0 + c / kCpr, k = k0 + (c % kCpr) * 8;
    if constexpr (P == kNormF32) {
      const float* a = static_cast<const float*>(p.a);
      st.af[2 * i] = load_chunk<float>(a, row, p.m, k, p.k, p.vec);
      st.af[2 * i + 1] = load_chunk<float>(a, row, p.m, k + 4, p.k, p.vec);
    } else {
      st.a[i] = load_chunk<T>(static_cast<const T*>(p.a), row, p.m, k, p.k,
                              p.vec);
    }
  }
#pragma unroll
  for (int i = 0; i < kChunksB; ++i) {
    const int c = threadIdx.x + i * kThreads;
    st.b[i] = load_chunk<T>(static_cast<const T*>(p.b), n0 + c / kCpr, p.n,
                            k0 + (c % kCpr) * 8, p.k, p.vec);
  }
}

// Registers to one shared buffer (A rows then B rows), forming z on the way
// under the norm prologue.
template <int P>
__device__ __forceinline__ void mma_store(MmaStage<P>& st, const GemmArgs& p,
                                          __nv_bfloat16* buf, int m0, int k0,
                                          const float* mean_s,
                                          const float* rstd_s) {
#pragma unroll
  for (int i = 0; i < kChunksA; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kCpr, kc = (c % kCpr) * 8;
    if constexpr (P == kNormF32) {
      Chunk<__nv_bfloat16> z;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        z.set(j, norm_value(st.af[2 * i + j / 4].get(j % 4), m0 + r,
                            k0 + kc + j, p, mean_s[r], rstd_s[r]));
      *reinterpret_cast<uint4*>(buf + r * kLd + kc) = z.u;
    } else {
      if (P == kLnRows)
        layer_norm_chunk(st.a[i], m0 + r, k0 + kc, p, mean_s[r], rstd_s[r]);
      *reinterpret_cast<uint4*>(buf + r * kLd + kc) = st.a[i].u;
    }
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
template <int P, int E>
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

  if (P != kPlain) {
    for (int r = tid; r < kBM; r += kThreads) {
      const int row = m0 + r;
      mean_s[r] = row < p.m ? p.mean[stat_index<P>(p, row)] : 0.f;
      rstd_s[r] = row < p.m ? p.rstd[stat_index<P>(p, row)] : 0.f;
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

  MmaStage<P> st;
  const int k_tiles = (p.k + kBK - 1) / kBK;
  mma_load<P>(st, p, m0, n0, 0);
  mma_store<P>(st, p, tiles, m0, 0, mean_s, rstd_s);
  __syncthreads();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < k_tiles;
    if (more) mma_load<P>(st, p, m0, n0, (kt + 1) * kBK);
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
    if (more) mma_store<P>(st, p, tiles + (buf ^ 1) * kTileElems, m0,
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
template <int P, int E>
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

  if (P != kPlain) {
    for (int r = tid; r < kFBM; r += kThreads) {
      const int row = m0 + r;
      mean_s[r] = row < p.m ? p.mean[stat_index<P>(p, row)] : 0.f;
      rstd_s[r] = row < p.m ? p.rstd[stat_index<P>(p, row)] : 0.f;
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
    if (P != kPlain)
      layer_norm_chunk(ra, m0 + lr, kt * kFBK + lk, p, mean_s[lr], rstd_s[lr]);
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

// ---------------------------------------------------------------------------
// bf16 on Hopper: TMA-fed wgmma on an mbarrier ring (operands with 16-byte
// rows; see the note at the top)

constexpr int kWgThreads = 384;   // a producer warpgroup, two consumer ones
constexpr int kWgRows = 128;      // output tile rows: 64 a consumer warpgroup
constexpr int kWgDepth = 64;      // k step: one 128-byte swizzle row of bf16
// One TMA box of the staging and of an f32 A: 64 x 64 bf16 or 64 x 32 f32,
// 64 rows of one 128-byte swizzle row each.
constexpr int kWgTileBytes = 64 * 128;
constexpr int kLnMaxDepth = 4096;           // the norm affine in shared memory
constexpr int kLnMaxDepthWide = 2048;       // ... beside wider tiles
constexpr int kWgProducerRegs = 40;
constexpr int kWgConsumerRegs = 232;
constexpr int kWgSmemMax = 232448;          // a block's shared memory (H100)

// Shared memory of a block with BN-column output tiles under prologue P and
// epilogue E: the ring of kStages (A 128 x 64, bf16 or f32; B BN x 64)
// stages, the output staging (each consumer warpgroup's 64 x BN of the
// wider of the output and the shortcut, in 128-byte-wide swizzled boxes),
// the barriers, then (a norm prologue) its affine, one float4 (w[2i],
// w[2i + 1], b[2i], b[2i + 1]) a column pair, for up to kMaxDepth columns.
// The ring takes as many stages as fit, up to 5: 5 at BN = 128 and 3 at 256
// for bf16 A and outputs (225.1 KB at most: BN = 128, K = 4096).
template <int BN, int P = kLnRows, int E = kBias>
struct WgmmaTiles {
  static constexpr int kABytes = kWgRows * kWgDepth * (P == kNormF32 ? 4 : 2);
  static constexpr int kStageBytes = kABytes + BN * kWgDepth * 2;
  static constexpr int kOutBytes =
      kWgRows * BN * (f32_shortcut(E) || f32_out(E) ? 4 : 2);
  static constexpr int kMaxDepth =
      P == kPlain ? 0 : BN == 128 ? kLnMaxDepth : kLnMaxDepthWide;
  static constexpr int kFixed = 1024 + kOutBytes + 8 * 12 + 8 * kMaxDepth;
  static constexpr int kStages =
      (kWgSmemMax - kFixed) / kStageBytes < 5
          ? (kWgSmemMax - kFixed) / kStageBytes : 5;
  static constexpr int kOut = kStages * kStageBytes;
  static constexpr int kBars = kOut + kOutBytes;
  // full[kStages], empty[kStages], the two warpgroups' shortcut barriers.
  static constexpr int kAffine = kBars + 8 * (2 * kStages + 2);
  static_assert(kStages >= 2, "a ring of at least two stages");

  // 1024 bytes of slack align the ring to the swizzle's 1024-byte period.
  static size_t bytes(int k) {
    const int k_pad = (k + kWgDepth - 1) / kWgDepth * kWgDepth;
    return (size_t)kAffine + (P != kPlain ? (size_t)k_pad * 8 : 0) + 1024;
  }
};
static_assert(WgmmaTiles<128, kLnRows>::kStages == 5 &&
                  WgmmaTiles<128, kPlain>::kStages == 5 &&
                  WgmmaTiles<256, kLnRows>::kStages == 3 &&
                  WgmmaTiles<256, kPlain>::kStages == 3,
              "the rings of convnext_mlp, convnext_block and ln_dense");

// 1 / (1 + e^-2u) = (1 + tanh u) / 2, so the tanh GELU 0.5 s (1 + tanh u)
// is s / (1 + e^-2u): one exponential and one division on the special
// function unit, where tanhf costs several more instructions. The same
// function, evaluated otherwise than the other bodies' gelu_tanh: __expf
// is within 2 + floor(1.173 |2u|) ulp (CUDA's bound, growing with the
// argument) and __fdividef within 2, so the result is within about
// 5 + 2.35 |u| ulp of s / (1 + e^-2u), relative; it matters only for
// u << 0, where h is tiny and 1 + tanhf(u) loses more to cancellation.
// Rounded to bf16, the two forms can differ in h's last bit.
__device__ __forceinline__ float gelu_tanh_wgmma(float s) {
  const float u = 0.7978845608028654f * (s + 0.044715f * s * s * s);
  return __fdividef(s, 1.f + __expf(-2.f * u));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// out = epi(A @ B^T) over every (128, BN) output tile, the tiles walked by
// a persistent grid (tile blockIdx.x, + gridDim.x, ...; the columns of a
// row block in a row). Maps (tma.py · gemm_maps): a (M, K) with 128-row
// boxes, b (N, K) with BN-row boxes, out and sc (M, N) with 64-row boxes,
// all 128 bytes wide (64 bf16 or 32 f32 columns). smem_raw holds
// WgmmaTiles<BN, P, E>::bytes(K).
template <int P, int E, int BN>
__device__ __forceinline__ void gemm_bf16_wgmma(const CUtensorMap* a_map,
                                                const CUtensorMap* b_map,
                                                const CUtensorMap* out_map,
                                                const CUtensorMap* sc_map,
                                                const GemmArgs& p,
                                                uint8_t* smem_raw) {
  static_assert(E != kGeluErf, "the erf GELU is the f32 body's");
  using L = WgmmaTiles<BN, P, E>;
  constexpr int S = L::kStages;
  constexpr bool kNorm = P != kPlain;
  constexpr bool kF32A = P == kNormF32;
  constexpr bool kSc = has_shortcut(E);
  // Columns of a staging box of the shortcut and of the output.
  constexpr int kScCols = f32_shortcut(E) ? 32 : 64;
  constexpr int kOutCols = f32_out(E) ? 32 : 64;
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + S;
  uint64_t* sc_full = empty + S;
  float4* affine = reinterpret_cast<float4*>(smem + L::kAffine);

  const int n_tiles = (p.n + BN - 1) / BN;
  const int tiles = (p.m + kWgRows - 1) / kWgRows * n_tiles;
  const int k_steps = (p.k + kWgDepth - 1) / kWgDepth;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);   // one arrival a consumer warp
    }
    hopper::mbar_init(&sc_full[0], 1);
    hopper::mbar_init(&sc_full[1], 1);
    hopper::fence_barrier_init();
  }
  if (kNorm) {
    // Zeros past K: z is then (-mean) * rstd * 0 + 0, finite, and meets
    // B's zero fill there.
    for (int i = (int)threadIdx.x; i < k_steps * kWgDepth / 2;
         i += kWgThreads) {
      const int c = 2 * i;
      const bool in = c < p.k;   // K % 8 == 0 on this route: pairs whole
      affine[i] = in ? make_float4(__ldg(p.ln_w + c), __ldg(p.ln_w + c + 1),
                                   __ldg(p.ln_b + c), __ldg(p.ln_b + c + 1))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();

  if (warp < 4) {
    // Producer: one thread streams A and B k steps through the ring, tile
    // after tile, ahead of the consumers by up to S stages (so the next
    // tile's first stages load during this tile's epilogue). An f32 A k
    // step is two 32-column boxes.
    hopper::setmaxnreg_dec<kWgProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * kWgRows, n0 = tile % n_tiles * BN;
        for (int kt = 0; kt < k_steps; ++kt, ++it) {
          const int s = it % S;
          if (it >= S) hopper::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          uint8_t* stage = smem + s * L::kStageBytes;
          hopper::mbar_expect_tx(&full[s], L::kStageBytes);
          hopper::tma_load_2d(stage, a_map, &full[s], kWgDepth * kt, m0);
          if (kF32A)
            hopper::tma_load_2d(stage + L::kABytes / 2, a_map, &full[s],
                                kWgDepth * kt + 32, m0);
          hopper::tma_load_2d(stage + L::kABytes, b_map, &full[s],
                              kWgDepth * kt, n0);
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: rows 64 wg ... + 63 of each tile. Thread (warp
  // wl of the group, lane g * 4 + t) holds rows row and row + 8 of them.
  hopper::setmaxnreg_inc<kWgConsumerRegs>();
  const int wg = warp / 4 - 1, wl = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int row = 16 * wl + g;
  const bool leader = threadIdx.x % 128 == 0;

  // The epilogue follows each tile's k steps (the producer meanwhile
  // loads the next tile's first stages).
  uint8_t* out_s = smem + L::kOut + wg * (L::kOutBytes / 2);
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int it = 0, sc_uses = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * kWgRows, n0 = tile % n_tiles * BN;
    const int r0 = m0 + 64 * wg;   // the warpgroup's first row
    const bool live = r0 < p.m;
    if (kSc && live && leader) {
      // The shortcut tile into the staging buffer, once the previous
      // tile's store has read it; it lands while the products run.
      const int boxes = min(BN / kScCols, (p.n - n0 + kScCols - 1) / kScCols);
      hopper::tma_store_wait_read();
      hopper::mbar_expect_tx(&sc_full[wg], boxes * kWgTileBytes);
      for (int c = 0; c < boxes; ++c)
        hopper::tma_load_2d(out_s + c * kWgTileBytes, sc_map, &sc_full[wg],
                            n0 + kScCols * c, r0);
    }
    // This thread's rows' statistics (the norm prologue).
    float mu[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + row + 8 * h;
      if (kNorm && r < p.m) {
        mu[h] = __ldg(p.mean + stat_index<P>(p, r));
        rs[h] = __ldg(p.rstd + stat_index<P>(p, r));
      }
    }

    // The k steps. With the norm prologue, z = LN(x) is formed from the
    // staged x tile in the A registers (the k16 step kk's four: rows row,
    // row + 8 at columns 16 kk + 2 t, then + 8), rounded to bf16, and each
    // step's products are retired before the next step defines A again:
    // issued with a group in flight, a product whose A registers were
    // defined during that group makes ptxas serialise every wgmma (C7513);
    // forming A during the previous step's products in a second register
    // set, retired before the issue, measured no faster. Without it, one
    // group stays in flight.
    for (int kt = 0; kt < k_steps; ++kt, ++it) {
      const int s = it % S;
      hopper::mbar_wait(&full[s], (it / S) & 1);
      uint8_t* stage = smem + s * L::kStageBytes;
      const uint64_t bd = hopper::sw128_desc(stage + L::kABytes);
      if constexpr (kNorm) {
        uint32_t a[16];
        const uint8_t* x_s = stage + wg * kWgTileBytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j2 = 8 * kk + 4 * h + t;   // the column pair
            const float4 af = affine[kWgDepth / 2 * kt + j2];
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              float x0, x1;
              if constexpr (kF32A) {
                // Columns 2 j2, + 1: box kk / 2 (columns 32 (kk / 2) ...).
                const float2 v = *reinterpret_cast<const float2*>(
                    x_s + (kk / 2) * (L::kABytes / 2) +
                    hopper::sw128_offset_f32(row + 8 * rr,
                                             2 * j2 - 32 * (kk / 2)));
                x0 = v.x;
                x1 = v.y;
              } else {
                const uint32_t v = *reinterpret_cast<const uint32_t*>(
                    x_s + hopper::sw128_offset(row + 8 * rr, j2));
                x0 = __uint_as_float(v << 16);
                x1 = __uint_as_float(v & 0xffff0000u);
              }
              const float z0 = ((x0 - mu[rr]) * rs[rr]) * af.x + af.z;
              const float z1 = ((x1 - mu[rr]) * rs[rr]) * af.y + af.w;
              a[4 * kk + 2 * h + rr] = hopper::pack_bf16(z0, z1);
            }
          }
        }
        hopper::fence_regs(a);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_rs<0>(acc, &a[4 * kk], bd + 2 * kk, kt > 0 || kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(a);
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
      } else {
        const uint64_t ad = hopper::sw128_desc(stage + wg * kWgTileBytes);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_ss<0>(acc, ad + 2 * kk, bd + 2 * kk, kt > 0 || kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[(it - 1) % S]);
      }
    }
    if constexpr (!kNorm) {
      hopper::wgmma_wait<0>();
      if (lane == 0) hopper::mbar_arrive(&empty[(it - 1) % S]);
    }
    hopper::fence_regs(acc);
    if (!live) continue;

    // Epilogue in f32 from the accumulator, rounded once into the
    // staging boxes (column block j: a bf16 box j / 8 at column pair
    // 4 (j % 8) + t, an f32 box j / 4 at column 8 (j % 4) + 2 t), then
    // one TMA store a box, which drops rows >= M and columns >= N.
    if (kSc) {
      hopper::mbar_wait(&sc_full[wg], sc_uses & 1);
      ++sc_uses;
    } else {
      if (leader) hopper::tma_store_wait_read();
      hopper::named_barrier(1 + wg, 128);
    }
    if constexpr (E == kResidualF32 || E == kProj) {
      // The shortcut and the output differ in type: every thread forms its
      // outputs in its accumulator from the staged shortcut, and writes
      // them over it once the warpgroup has read it all.
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (n0 + 8 * j >= p.n) continue;   // N % 8 == 0: blocks whole
        const float b0 = __ldg(p.bias + col), b1 = __ldg(p.bias + col + 1);
        float g0 = 1.f, g1 = 1.f;
        if (E == kResidualF32 && p.gamma) {
          g0 = __ldg(p.gamma + col);
          g1 = __ldg(p.gamma + col + 1);
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float& v0 = acc[4 * j + 2 * rr];
          float& v1 = acc[4 * j + 2 * rr + 1];
          if constexpr (E == kResidualF32) {
            const float2 sc = *reinterpret_cast<const float2*>(
                out_s + (j / 4) * kWgTileBytes +
                hopper::sw128_offset_f32(row + 8 * rr, 8 * (j % 4) + 2 * t));
            v0 = sc.x + g0 * (v0 + b0);
            v1 = sc.y + g1 * (v1 + b1);
          } else {
            const uint32_t sc = *reinterpret_cast<const uint32_t*>(
                out_s + (j / 8) * kWgTileBytes +
                hopper::sw128_offset(row + 8 * rr, 4 * (j % 8) + t));
            v0 = __uint_as_float(sc << 16) + round_bf16(v0 + b0);
            v1 = __uint_as_float(sc & 0xffff0000u) + round_bf16(v1 + b1);
          }
        }
      }
      if (E == kProj && p.row_mean != nullptr) {
        // The f32 output's row statistics (the next LayerNorm's), one-pass
        // as row_stats: each thread's sums over its columns, then over the
        // four threads of its rows' quad.
        float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          if (n0 + 8 * j >= p.n) continue;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const float v0 = acc[4 * j + 2 * rr], v1 = acc[4 * j + 2 * rr + 1];
            sum[rr] += v0 + v1;
            sq[rr] += v0 * v0 + v1 * v1;
          }
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], off);
            sq[rr] += __shfl_xor_sync(0xffffffffu, sq[rr], off);
          }
          const int r = r0 + row + 8 * rr;
          if (t == 0 && r < p.m) {
            const float mu = sum[rr] / (float)p.n;
            p.row_mean[r] = mu;
            p.row_rstd[r] =
                rsqrtf(fmaxf(sq[rr] / (float)p.n - mu * mu, 0.f) + p.eps);
          }
        }
      }
      hopper::named_barrier(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (n0 + 8 * j >= p.n) continue;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float v0 = acc[4 * j + 2 * rr], v1 = acc[4 * j + 2 * rr + 1];
          if constexpr (E == kProj) {
            *reinterpret_cast<float2*>(
                out_s + (j / 4) * kWgTileBytes +
                hopper::sw128_offset_f32(row + 8 * rr, 8 * (j % 4) + 2 * t)) =
                make_float2(v0, v1);
          } else {
            *reinterpret_cast<uint32_t*>(
                out_s + (j / 8) * kWgTileBytes +
                hopper::sw128_offset(row + 8 * rr, 4 * (j % 8) + t)) =
                hopper::pack_bf16(v0, v1);
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (n0 + 8 * j >= p.n) continue;   // N % 8 == 0: blocks whole
        float b0 = 0.f, b1 = 0.f;
        if (E != kBias || p.bias) {
          b0 = __ldg(p.bias + col);
          b1 = __ldg(p.bias + col + 1);
        }
        uint8_t* tile_s = out_s + (j / 8) * kWgTileBytes;
        const int j2 = 4 * (j % 8) + t;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          uint32_t* o = reinterpret_cast<uint32_t*>(
              tile_s + hopper::sw128_offset(row + 8 * rr, j2));
          const float s0 = acc[4 * j + 2 * rr], s1 = acc[4 * j + 2 * rr + 1];
          float v0, v1;
          if (E == kGeluTanh) {
            v0 = gelu_tanh_wgmma(s0 + b0);
            v1 = gelu_tanh_wgmma(s1 + b1);
          } else if (E == kGeluRounded) {
            v0 = gelu_tanh_wgmma(round_bf16(s0 + b0));
            v1 = gelu_tanh_wgmma(round_bf16(s1 + b1));
          } else if (E == kBias) {
            v0 = s0 + b0;
            v1 = s1 + b1;
          } else {   // kResidual: the bf16 shortcut in place
            const uint32_t sc = *o;
            v0 = __uint_as_float(sc << 16) + __ldg(p.gamma + col) * (s0 + b0);
            v1 = __uint_as_float(sc & 0xffff0000u) +
                 __ldg(p.gamma + col + 1) * (s1 + b1);
          }
          *o = hopper::pack_bf16(v0, v1);
        }
      }
    }
    hopper::fence_proxy_async();
    hopper::named_barrier(1 + wg, 128);
    if (leader) {
      const int boxes =
          min(BN / kOutCols, (p.n - n0 + kOutCols - 1) / kOutCols);
      for (int c = 0; c < boxes; ++c)
        hopper::tma_store_2d(out_map, out_s + c * kWgTileBytes,
                             n0 + kOutCols * c, r0);
      hopper::tma_store_commit();
    }
  }

  // The staging must outlive the stores' reads of it.
  if (leader) hopper::tma_store_wait_read();
}

// A product's maps (tma.py · packed_gemm_maps): four geometries (a, b,
// out, the shortcut), then the persistent grid's blocks.
constexpr int kGemmMapsSize = 4 * hopper::kGeometrySize + 1;

// The b map's box rows: the output tile's columns (tma.py · gemm_width).
inline int wgmma_width(const int64_t* maps) {
  return (int)maps[hopper::kGeometrySize + 11];
}

// Launch ``kernel``, a __global__ wrapper of gemm_bf16_wgmma<P, E, BN>
// that takes the four maps by value (as const __grid_constant__
// CUtensorMap) and then the arguments, for one product: the maps encoded
// from `maps` (kGemmMapsSize values: four geometries, a, b, out, the
// shortcut, the out map again where there is no shortcut, over the
// arguments' bases, each f32 where P or E reads or writes that operand in
// f32; then the grid's blocks, at most one an SM, which the wrapper sizes
// from the device's SM count as it picks the width). Returns a
// cudaError_t value.
template <int BN, int P, int E>
inline int launch_gemm_wgmma(const void* kernel, const int64_t* maps,
                             const GemmArgs& args, cudaStream_t stream) {
  if (wgmma_width(maps) != BN) return (int)cudaErrorInvalidValue;
  CUtensorMap tmaps[4];
  const void* bases[4] = {args.a, args.b, args.out,
                          args.shortcut ? args.shortcut : args.out};
  const bool f32[4] = {P == kNormF32, false, f32_out(E),
                       args.shortcut ? f32_shortcut(E) : f32_out(E)};
  for (int i = 0; i < 4; ++i) {
    const int err = hopper::encode_map(&tmaps[i], bases[i],
                                       maps + i * hopper::kGeometrySize,
                                       f32[i]);
    if (err != 0) return err;
  }
  const size_t smem = WgmmaTiles<BN, P, E>::bytes(args.k);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (int64_t)((args.m + kWgRows - 1) / kWgRows) *
                        ((args.n + BN - 1) / BN);
  const int64_t blocks = maps[4 * hopper::kGeometrySize];
  if (blocks <= 0 || blocks > tiles) return (int)cudaErrorInvalidConfiguration;
  GemmArgs a = args;
  void* params[] = {&tmaps[0], &tmaps[1], &tmaps[2], &tmaps[3], &a};
  err = cudaLaunchKernel(kernel, dim3((unsigned)blocks), dim3(kWgThreads),
                         params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Declares a __global__ wrapper `name`<BN> of gemm_bf16_wgmma<PRO, EPI, BN>
// and `launch_<name>`, which launches its instantiation at the maps' width:
// 128 or 256 columns, and with W192 (CNX_WGMMA_KERNEL_192, the products
// tma.py marks GemmProduct.w192) also 192.
#define CNX_WGMMA_KERNEL_WIDTHS(name, PRO, EPI, W192)                        \
  template <int BN>                                                          \
  __global__ void __launch_bounds__(cnx::kWgThreads, 1)                      \
      name(const __grid_constant__ CUtensorMap a,                            \
           const __grid_constant__ CUtensorMap b,                            \
           const __grid_constant__ CUtensorMap out,                          \
           const __grid_constant__ CUtensorMap sc, cnx::GemmArgs p) {        \
    extern __shared__ __align__(16) uint8_t wgmma_smem[];                    \
    cnx::gemm_bf16_wgmma<PRO, EPI, BN>(&a, &b, &out, &sc, p, wgmma_smem);    \
  }                                                                          \
  template <bool kW192 = W192>                                               \
  inline int launch_##name(const cnx::GemmArgs& args, const int64_t* maps,   \
                           cudaStream_t stream) {                            \
    const int width = cnx::wgmma_width(maps);                                \
    if (width == 256)                                                        \
      return cnx::launch_gemm_wgmma<256, PRO, EPI>(                          \
          reinterpret_cast<const void*>(name<256>), maps, args, stream);     \
    if constexpr (kW192) {                                                   \
      if (width == 192)                                                      \
        return cnx::launch_gemm_wgmma<192, PRO, EPI>(                        \
            reinterpret_cast<const void*>(name<192>), maps, args, stream);   \
    }                                                                        \
    return cnx::launch_gemm_wgmma<128, PRO, EPI>(                            \
        reinterpret_cast<const void*>(name<128>), maps, args, stream);       \
  }
#define CNX_WGMMA_KERNEL(name, PRO, EPI) \
  CNX_WGMMA_KERNEL_WIDTHS(name, PRO, EPI, false)
#define CNX_WGMMA_KERNEL_192(name, PRO, EPI) \
  CNX_WGMMA_KERNEL_WIDTHS(name, PRO, EPI, true)

// Declares a __global__ wrapper `name`<T> of gemm_bf16_tile<PRO, EPI> (T =
// bf16) or gemm_f32_tile<PRO, EPI> (T = f32), for launch_gemm<T>.
#define CNX_TILE_KERNEL(name, PRO, EPI)                                   \
  template <typename T>                                                    \
  __global__ void __launch_bounds__(cnx::kThreads) name(cnx::GemmArgs p) { \
    extern __shared__ __align__(16) unsigned char tile_smem[];             \
    if constexpr (sizeof(T) == 2)                                          \
      cnx::gemm_bf16_tile<PRO, EPI>(p, tile_smem);                         \
    else                                                                   \
      cnx::gemm_f32_tile<PRO, EPI>(p, tile_smem);                          \
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
