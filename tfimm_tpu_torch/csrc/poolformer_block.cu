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
// bytes and are bound by the tensor cores (27-42 us).
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
// 2. pool_x1: one thread per element recomputes y at its 3x3 taps from x
//    and the statistics, adds the in-bounds ones in the Pallas kernel's
//    order, divides by their count and writes x1 in f32 to a workspace.
// 3. gn_stats over x1, as in 1.
// 4. fc1: a tiled GEMM whose A tiles are z, formed from the f32 x1 with
//    each row's image statistics and GN2's affine as they are loaded,
//    rounded to the dtype; epilogue gelu(acc + b1), rounded; h goes to
//    device memory in the dtype, as the TPU kernel also rounds it.
// 5. fc2: a tiled GEMM with the epilogue x1 + ls2 * (acc + b2).
//
// The GEMMs are convnext_mlp.cu's: bf16 on the tensor cores through
// mma.sync m16n8k16 with ldmatrix, 128 x 128 output tiles, 32-deep k tiles
// staged through registers into two shared buffers; f32 on plain FMAs
// (TF32 would miss the 1e-5 bar), 64 x 64 tiles. x1 (4 bytes an element)
// and h (4C a row) each cross device memory twice: this first form is far
// from the bound by design, and fusing the pool into the GEMM prologue is
// the next step.
//
// Coverage: any B, H, W, C and hidden width. 16-byte loads where the depth
// is a multiple of 8 and the operands are 16-byte aligned, element loads
// otherwise. Shared memory: bf16 41 KB, f32 17 KB, dynamic, with the launch
// limit raised before each launch; every launch is followed by
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStatsThreads = 512;

struct GemmArgs {
  const void* a;         // fc1: x1 (M, C) f32; fc2: h (M, H)
  const void* b;         // fc1: w1 (H, C); fc2: w2 (C, H)
  void* out;             // fc1: h (M, H); fc2: out (M, C)
  const float* x1;       // fc2: (M, C)
  const float* mean;     // fc1: GN2 mean of each image (B,)
  const float* rstd;     // fc1: GN2 rstd of each image (B,)
  const float* n_w;      // fc1: GN2 weight (C,)
  const float* n_b;      // fc1: GN2 bias (C,)
  const float* bias;     // fc1: b1 (H,); fc2: b2 (C,)
  const float* ls;       // fc2: ls2 (C,)
  int m, n, k;           // output rows, output columns, depth
  int hw;                // rows per image
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

// jax.nn.gelu's default, the tanh form, in every dtype.
__device__ __forceinline__ float gelu_tanh(float s) {
  const float u = 0.7978845608028654f * (s + 0.044715f * s * s * s);
  return 0.5f * s * (1.f + tanhf(u));
}

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

template <typename T>
__global__ void __launch_bounds__(kStatsThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ mean,
                float* __restrict__ rstd, int64_t size, float eps, int vec) {
  __shared__ float red[kStatsThreads / 32];
  constexpr int V = vec_len<T>();
  const T* xi = x + blockIdx.x * size;
  const int64_t chunks = vec ? size / V : 0;   // vec: size % V == 0
  const int64_t tail = chunks * V;

  float s = 0.f;
  for (int64_t i = threadIdx.x; i < chunks; i += kStatsThreads) {
    Chunk<T> c;
    c.u = reinterpret_cast<const uint4*>(xi)[i];
#pragma unroll
    for (int j = 0; j < V; ++j) s += c.get(j);
  }
  for (int64_t i = tail + threadIdx.x; i < size; i += kStatsThreads)
    s += to_f(xi[i]);
  const float mu = block_sum(s, red) / (float)size;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_x1_kernel(const T* __restrict__ x, const float* __restrict__ mean,
               const float* __restrict__ rstd, const float* __restrict__ n_w,
               const float* __restrict__ n_b, const float* __restrict__ ls,
               float* __restrict__ x1, int64_t total, int h, int w, int c) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int ch = (int)(idx % c);
  int64_t rest = idx / c;
  const int j = (int)(rest % w);
  rest /= w;
  const int i = (int)(rest % h);
  const int64_t img = rest / h;
  const float mu = mean[img], rs = rstd[img];
  const float gw = n_w[ch], gb = n_b[ch];
  const int64_t row_stride = (int64_t)w * c;
  const float xc = to_f(x[idx]);
  const float y = (xc - mu) * rs * gw + gb;
  // The Pallas kernel's order: the centre, then the 8 neighbours row by
  // row; its tap (dh, dw) reads y[i - dh, j - dw].
  float acc = y;
#pragma unroll
  for (int dh = -1; dh <= 1; ++dh) {
#pragma unroll
    for (int dw = -1; dw <= 1; ++dw) {
      if (dh == 0 && dw == 0) continue;
      const int ii = i - dh, jj = j - dw;
      if (ii < 0 || ii >= h || jj < 0 || jj >= w) continue;
      const float v = to_f(x[idx - dh * row_stride - (int64_t)dw * c]);
      acc += (v - mu) * rs * gw + gb;
    }
  }
  const float rc = 1.f + (i > 0) + (i < h - 1);
  const float cc = 1.f + (j > 0) + (j < w - 1);
  x1[idx] = xc + (acc / (rc * cc) - y) * ls[ch];
}

// ---------------------------------------------------------------------------
// The MLP GEMMs (the tiles of convnext_mlp.cu).

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

// z of elements (row, k .. k + n - 1) of x1, given as f32 values v: GN2 with
// the row's image statistics and the affine; 0 outside the matrix.
__device__ __forceinline__ float gn2(const GemmArgs& p, int row, int k, float v,
                                     float mu, float rs) {
  if (row >= p.m || k >= p.k) return 0.f;
  return ((v - mu) * rs) * __ldg(p.n_w + k) + __ldg(p.n_b + k);
}

// The fc1 A chunk in bf16: 8 f32 elements of x1 (two 16-byte loads) ->
// z, rounded to bf16.
__device__ __forceinline__ Chunk<__nv_bfloat16> load_z_chunk(const GemmArgs& p,
                                                             int row, int k) {
  Chunk<__nv_bfloat16> out;
  out.u = make_uint4(0u, 0u, 0u, 0u);
  if (row >= p.m) return out;
  const float* src = static_cast<const float*>(p.a);
  const int img = row / p.hw;
  const float mu = __ldg(p.mean + img), rs = __ldg(p.rstd + img);
  Chunk<float> lo, hi;
  lo = load_chunk<float>(src, row, p.m, k, p.k, p.vec);
  hi = load_chunk<float>(src, row, p.m, k + 4, p.k, p.vec);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out.set(j, gn2(p, row, k + j, lo.get(j), mu, rs));
    out.set(4 + j, gn2(p, row, k + 4 + j, hi.get(j), mu, rs));
  }
  return out;
}

// The two epilogues, for one output element (row < M, col < N).
template <typename T, bool FC1>
__device__ __forceinline__ void store_out(const GemmArgs& p, int row, int col,
                                          float acc) {
  const int64_t off = (int64_t)row * p.n + col;
  float v;
  if (FC1)
    v = gelu_tanh(acc + __ldg(p.bias + col));
  else
    v = p.x1[off] + __ldg(p.ls + col) * (acc + __ldg(p.bias + col));
  static_cast<T*>(p.out)[off] = from_f<T>(v);
}

// bf16: tensor cores (mma.sync m16n8k16, ldmatrix)

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kLd = kBK + 8;                         // padded smem row
constexpr int kCpr = kBK / 8;                        // 16-byte chunks per row
constexpr int kChunksA = kBM * kCpr / kThreads;      // per thread
constexpr int kChunksB = kBN * kCpr / kThreads;
constexpr int kTileElems = (kBM + kBN) * kLd;        // one buffer, A then B
constexpr size_t kMmaSmem = 2 * kTileElems * sizeof(__nv_bfloat16);

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

// This thread's share of the next k tile, from global memory to registers
// (fc1's A chunks already z, rounded).
struct MmaStage {
  Chunk<__nv_bfloat16> a[kChunksA], b[kChunksB];
};

template <bool FC1>
__device__ __forceinline__ void mma_load(MmaStage& st, const GemmArgs& p,
                                         int m0, int n0, int k0) {
  using T = __nv_bfloat16;
#pragma unroll
  for (int i = 0; i < kChunksA; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = m0 + c / kCpr, k = k0 + (c % kCpr) * 8;
    if (FC1)
      st.a[i] = load_z_chunk(p, row, k);
    else
      st.a[i] = load_chunk<T>(static_cast<const T*>(p.a), row, p.m, k, p.k,
                              p.vec);
  }
#pragma unroll
  for (int i = 0; i < kChunksB; ++i) {
    const int c = threadIdx.x + i * kThreads;
    st.b[i] = load_chunk<T>(static_cast<const T*>(p.b), n0 + c / kCpr, p.n,
                            k0 + (c % kCpr) * 8, p.k, p.vec);
  }
}

// Registers to one shared buffer (A rows then B rows).
__device__ __forceinline__ void mma_store(const MmaStage& st,
                                          __nv_bfloat16* buf) {
#pragma unroll
  for (int i = 0; i < kChunksA; ++i) {
    const int c = threadIdx.x + i * kThreads;
    *reinterpret_cast<uint4*>(buf + (c / kCpr) * kLd + (c % kCpr) * 8) = st.a[i].u;
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
pf_gemm_bf16_kernel(GemmArgs p) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);

  const int n_blocks = (p.n + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / n_blocks) * kBM;
  const int n0 = (blockIdx.x % n_blocks) * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * 64;   // warp's first row in the tile
  const int wn = (warp % 4) * 32;   // warp's first column in the tile

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  MmaStage st;
  const int k_tiles = (p.k + kBK - 1) / kBK;
  mma_load<FC1>(st, p, m0, n0, 0);
  mma_store(st, tiles);
  __syncthreads();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < k_tiles;
    if (more) mma_load<FC1>(st, p, m0, n0, (kt + 1) * kBK);
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
    if (more) mma_store(st, tiles + (buf ^ 1) * kTileElems);
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

// f32: FMA

constexpr int kFBM = 64;
constexpr int kFBN = 64;
constexpr int kFBK = 16;
constexpr int kFLd = kFBM + 4;                       // k-major smem row
constexpr int kFCpr = kFBK / 4;                      // 16-byte chunks per row
constexpr int kFTileElems = kFBK * kFLd * 2;         // one buffer, A then B
constexpr size_t kFmaSmem = 2 * kFTileElems * sizeof(float);
static_assert(kFBM == kFBN, "A and B tiles share a k-major row length");
static_assert(kFBM * kFCpr == kThreads, "one A chunk and one B chunk per thread");

template <bool FC1>
__global__ void __launch_bounds__(kThreads)
pf_gemm_f32_kernel(GemmArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tiles = reinterpret_cast<float*>(smem_raw);

  const int n_blocks = (p.n + kFBN - 1) / kFBN;
  const int m0 = (blockIdx.x / n_blocks) * kFBM;
  const int n0 = (blockIdx.x % n_blocks) * kFBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* a = static_cast<const float*>(p.a);
  const float* b = static_cast<const float*>(p.b);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // This thread's chunk of each tile: row lr, depth lk .. lk + 3; fc1's
  // rows take their image's GN2 statistics.
  const int lr = tid / kFCpr, lk = (tid % kFCpr) * 4;
  float mu = 0.f, rs = 0.f;
  if (FC1 && m0 + lr < p.m) {
    const int img = (m0 + lr) / p.hw;
    mu = __ldg(p.mean + img);
    rs = __ldg(p.rstd + img);
  }
  const int k_tiles = (p.k + kFBK - 1) / kFBK;
  Chunk<float> ra = load_chunk<float>(a, m0 + lr, p.m, lk, p.k, p.vec);
  Chunk<float> rb = load_chunk<float>(b, n0 + lr, p.n, lk, p.k, p.vec);
  for (int kt = 0; kt < k_tiles; ++kt) {
    // Store tile kt (loaded one iteration earlier) to buffer kt & 1, whose
    // last readers finished before the previous barrier, then load tile
    // kt + 1 and multiply tile kt.
    float* as = tiles + (kt & 1) * kFTileElems;
    float* bs = as + kFBK * kFLd;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = ra.get(j);
      as[(lk + j) * kFLd + lr] =
          FC1 ? gn2(p, m0 + lr, kt * kFBK + lk + j, v, mu, rs) : v;
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
    err = cudaFuncSetAttribute(pf_gemm_bf16_kernel<FC1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  else
    err = cudaFuncSetAttribute(pf_gemm_f32_kernel<FC1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)((args.m + bm - 1) / bm) * ((args.n + bn - 1) / bn);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  if constexpr (kMma)
    pf_gemm_bf16_kernel<FC1><<<(unsigned)blocks, kThreads, smem, stream>>>(args);
  else
    pf_gemm_f32_kernel<FC1><<<(unsigned)blocks, kThreads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_all(const T* x, const float* const* vecs, const void* w1,
               const void* w2, float* x1, void* hid, float* stats, void* out,
               int batch, int h, int w, int c, int hidden, float eps,
               cudaStream_t stream) {
  constexpr int V = vec_len<T>();
  const float *n1_w = vecs[0], *n1_b = vecs[1], *ls1 = vecs[2];
  const float *n2_w = vecs[3], *n2_b = vecs[4], *b1 = vecs[5], *b2 = vecs[6];
  const float* ls2 = vecs[7];
  float *mean1 = stats, *rstd1 = stats + batch;
  float *mean2 = stats + 2 * batch, *rstd2 = stats + 3 * batch;
  const int64_t size = (int64_t)h * w * c;   // one image
  const int64_t total = size * batch;
  const int m = batch * h * w;

  gn_stats_kernel<T><<<batch, kStatsThreads, 0, stream>>>(
      x, mean1, rstd1, size, eps, size % V == 0 && aligned16(x));
  int err = (int)cudaGetLastError();
  if (err != 0) return err;

  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  pool_x1_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, mean1, rstd1, n1_w, n1_b, ls1, x1, total, h, w, c);
  err = (int)cudaGetLastError();
  if (err != 0) return err;

  gn_stats_kernel<float><<<batch, kStatsThreads, 0, stream>>>(
      x1, mean2, rstd2, size, eps, size % 4 == 0 && aligned16(x1));
  err = (int)cudaGetLastError();
  if (err != 0) return err;

  // fc1's bf16 A chunks are 8 f32 elements, two 16-byte loads.
  GemmArgs fc1 = {x1, w1, hid, nullptr, mean2, rstd2, n2_w, n2_b, b1, nullptr,
                  m, hidden, c, h * w,
                  c % V == 0 && c % 4 == 0 && aligned16(x1) && aligned16(w1)};
  err = launch_gemm<T, true>(fc1, stream);
  if (err != 0) return err;

  GemmArgs fc2 = {hid, w2, out, x1, nullptr, nullptr, nullptr, nullptr, b2,
                  ls2, m, c, hidden, h * w,
                  hidden % V == 0 && aligned16(hid) && aligned16(w2)};
  return launch_gemm<T, false>(fc2, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The eight vectors (n1 weight, n1 bias,
// ls1, n2 weight, n2 bias, b1, b2, ls2) are f32; x1 (B, H, W, C) f32, hid
// (B * H * W, hidden) in the dtype and stats (4, B) f32 are scratch the
// caller allocates. Returns a cudaError_t value (0 = ok).
extern "C" int tfimm_poolformer_block(
    const void* x, const void* n1_w, const void* n1_b, const void* ls1,
    const void* n2_w, const void* n2_b, const void* b1, const void* b2,
    const void* ls2, const void* w1, const void* w2, void* x1, void* hid,
    void* stats, void* out, int batch, int h, int w, int c, int hidden,
    float eps, int dtype, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0 || hidden <= 0 ||
      (int64_t)batch * h * w > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
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
                               hid, st, out, batch, h, w, c, hidden, eps, s);
    case 1:
      return launch_all<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x),
                                       vecs, w1, w2, x1f, hid, st, out, batch,
                                       h, w, c, hidden, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
