// Single-head PVT spatial-reduction attention with its q and output
// projections, at inference.
//
// Replaces: tfimm_tpu/ops/pallas/pvt_sra.py · sra_attention_or_none (the
// Pallas TPU kernel). Per image, x (N, C), k and v (S, C), wq and wp (C, C)
// in the port's Dense layout (out, in), bq and bp f32:
//
//     q = ((x @ wq^T + bq) * scale)        f32, rounded to the io dtype
//     p = softmax(q @ k^T)                 standard softmax with its max, f32,
//                                          rounded to the io dtype
//     o = p @ v                            f32 sums, rounded
//     y = o @ wp^T + bp                    f32, rounded once
//
// k and v are read in place from the kv projection (B, S, 2C): k is its
// first C columns, v its last C, through its batch and row strides. The
// softmax is exact (a row max, no clamp), unlike the other attention
// kernels of this package.
//
// What bounds it on an H100: at pvt_v2_b2's stage 1 (N = 3136, S = 49,
// C = 64) at batch 128 one call reads x and writes y, 102.8 MB in bf16, and
// reads 1.6 MB of k and v, but does 2 * B * N * C * (2C + 2S) = 11.6 GFLOP:
// about 110 flops per byte, below the card's ~295 flops/byte ridge. So an
// ideal kernel is bound by device memory, at about 31 us. The (N, S) scores
// never reach device memory, which is the point of the fusion.
//
// Three bodies:
//
// - bf16 on Hopper (tma.py · sra_route: C a multiple of 16 up to 64, S up
//   to 64, x and out contiguous, kv's rows dense, 16-byte bases and
//   strides; every registered PVT and PVTv2 at its single-head stage 1 at
//   224, C = 64 or 32 and S = 49): TMA + wgmma. A persistent grid of one
//   block an SM walks the B * ceil(N / 64) 64-row tiles of x in image
//   order, each block a run of consecutive tiles, so that it loads k and v
//   once for each image it meets, not once a tile. One producer thread
//   streams the x tiles through a ring of kStages (full / empty mbarriers)
//   and each new image's k and v, through one 3-D map over kv (2C, S, B)
//   with a 64-row box (rows past S arrive as zeros, so no pad row of v
//   holds what an earlier image left there), into one of two buffers;
//   wq and wp stay resident for the whole kernel. Two consumer warpgroups
//   take alternate tiles (window_mha_common.cuh's layout and helpers).
//   Each tile is a chain of four products, the accumulator of one the A
//   operand of the next: q = x wq^T (m64n64k16 from shared memory; the
//   x stage is released as soon as it is read), + bq, x scale, rounded to
//   bf16; s = q k^T (A in registers, k K-major); the softmax in registers
//   with the row max over the 4 lanes of a row and keys >= S at -inf, p
//   normalised and rounded; o = p v (v MN-major), rounded; y = o wp^T,
//   + bp, rounded into the warpgroup's swizzled tile and out by one TMA
//   store a tile (a map of x's geometry over the output, which drops rows
//   past N and columns past C). Measured on the H100 against plain 16-byte
//   stores of the tile's rows (scripts/perf/torch_sra_parts.py), the TMA
//   store was 6% faster here, where window_mha.cu found it slower: this
//   ring's loads are fewer and larger. At C = 32 the boxes stay
//   64 columns wide: x's columns past C and the v box's past 2C arrive as
//   zeros, and each product runs C / 16 k steps, so the k box's columns
//   past C (v's) are never read; the n64 products then carry 32 zero
//   columns, which costs little where memory bounds the kernel.
//   Departures from the first body, each a rounding at the last f32 ulp
//   before a round to bf16: the exponentials are 2^((s - max) log2(e)) by
//   ex2.approx, and p is e times the reciprocal of the row sum.
// - bf16 off that route (S above 64, C above 64, misaligned operands): the
//   first design, one thread block per 64 query rows of one image (a 1-D
//   grid over images x row blocks), everything between x and y in shared
//   memory: 4 warps, each owning 16 rows, run all four products on the
//   tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate), 64
//   output columns at a time (16 x 64 per warp, 32 f32 registers). The A
//   operands live in shared memory: the x tile (later overwritten by o),
//   the q tile and p. The B operands (wq's rows, k's rows, v transposed,
//   wp's rows) are streamed synchronously through one 64 x 32 tile,
//   zero-filled past the edges. The scores of the 64 rows go to shared
//   memory in f32 (S padded to a multiple of 64); each warp takes the
//   softmax of its own rows with warp shuffles and writes p as bf16 over
//   the row's own scores. C is padded to a multiple of 64 with zeros.
// - f32: exact f32 FMAs (TF32 would not hold the f32 result to 1e-5).
//   32 rows per block, 8 warps; a lane owns a row, a warp a set of
//   columns, so that the weights, k and v are read as warp-wide
//   broadcasts; x, q, the scores and o stay in shared memory.
//
// Shared memory of the first bf16 body: 2 * 64 * (CP + 8) * 2 + 64 * (SP +
// 4) * 4 + 5 KB bytes for C padded to CP and S to SP (41 KB at C = 64,
// S = 49; 200 KB at C = 512, S = 256); f32: 2 * 32 * (C + 1) * 4 + 32 *
// (S + 1) * 4 (164 KB at the largest); the Hopper body's, TcTiles.
// Dynamic, with the launch limit raised before each launch; every launch
// is followed by cudaGetLastError().
//
// Coverage: any B and N (ragged row blocks masked), S from 1 to 256, every
// C that is a multiple of 8 up to 512. bf16 needs 16-byte aligned x, kv,
// wq, wp and out, and kv strides that are multiples of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_mha_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxDim = 512;
constexpr int kMaxKeys = 256;
constexpr int kChunk = 64;        // output columns (or keys) of one product pass
constexpr int kKTile = 32;        // depth of a streamed B tile
constexpr int kLdB = kKTile + 8;  // padded row of a B tile (bank-conflict free)

struct SraArgs {
  const void* x;      // (B, N, C)
  const void* kv;     // (B, S, 2C) through kv_b, kv_n
  int64_t kv_b, kv_n;
  const void* wq;     // (C, C), (out, in)
  const float* bq;    // (C,)
  const void* wp;     // (C, C)
  const float* bp;    // (C,)
  void* out;          // (B, N, C)
  int n, s, c;
  float scale;
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync)

constexpr int kRows = 64;        // query rows per block
constexpr int kThreads = 128;    // 4 warps x 16 rows

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

union Pack8 {
  uint4 u;
  unsigned short e[8];
};

// B tile dst[r][kk] = src[n0 + r][k0 + kk] of a row-major (rows, depth)
// matrix with row stride ld; zeros at rows >= rows and depths >= depth (a
// multiple of 8).
__device__ __forceinline__ void load_b_rows(bf16* dst, const bf16* __restrict__ src,
                                            int64_t ld, int n0, int rows,
                                            int k0, int depth) {
  constexpr int kCpr = kKTile / 8;
  for (int i = threadIdx.x; i < kChunk * kCpr; i += kThreads) {
    const int r = i / kCpr, kc = (i % kCpr) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + r < rows && k0 + kc < depth)
      v = *reinterpret_cast<const uint4*>(src + (int64_t)(n0 + r) * ld + k0 + kc);
    *reinterpret_cast<uint4*>(dst + r * kLdB + kc) = v;
  }
}

// B tile of v transposed: dst[c][kk] = v[k0 + kk][n0 + c] for the (depth,
// cols) matrix v with row stride ld; zeros past its edges (cols is a
// multiple of 8).
__device__ __forceinline__ void load_b_cols(bf16* dst, const bf16* __restrict__ src,
                                            int64_t ld, int n0, int cols,
                                            int k0, int depth) {
  constexpr int kCpr = kChunk / 8;
  for (int i = threadIdx.x; i < kKTile * kCpr; i += kThreads) {
    const int kk = i / kCpr, c = (i % kCpr) * 8;
    Pack8 v;
    v.u = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + kk < depth && n0 + c < cols)
      v.u = *reinterpret_cast<const uint4*>(src + (int64_t)(k0 + kk) * ld + n0 + c);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * kLdB + kk] = __ushort_as_bfloat16(v.e[j]);
  }
}

// acc (this warp's 16 rows x 64 columns) += A[wr .. wr + 16, k0 .. k0 + 32)
// times the B tile (64 columns x 32 deep).
__device__ __forceinline__ void warp_tile(float (&acc)[8][4], const bf16* a_s,
                                          int lda, int wr, int k0,
                                          const bf16* b_s) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int ks = 0; ks < kKTile; ks += 16) {
    const bf16* pa = a_s + (wr + g) * lda + k0 + ks + 2 * t;
    const uint32_t af[4] = {ld_u32(pa), ld_u32(pa + 8 * lda), ld_u32(pa + 8),
                            ld_u32(pa + 8 * lda + 8)};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bf16* pb = b_s + (8 * j + g) * kLdB + ks + 2 * t;
      mma_16816(acc[j], af, ld_u32(pb), ld_u32(pb + 8));
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

size_t bf16_smem_bytes(int c, int s) {
  const int lda = round_up(c, kChunk) + 8, lds = round_up(s, kChunk) + 4;
  return 2 * (size_t)kRows * lda * sizeof(bf16) +
         (size_t)kRows * lds * sizeof(float) + (size_t)kChunk * kLdB * sizeof(bf16);
}

__global__ void __launch_bounds__(kThreads) pvt_sra_bf16_kernel(SraArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cp = round_up(p.c, kChunk);     // C padded: output columns
  const int kp = round_up(p.c, kKTile);     // C padded: product depth
  const int sp = round_up(p.s, kChunk);     // S padded: score columns
  const int skp = round_up(p.s, kKTile);    // S padded: depth of p @ v
  const int lda = cp + 8, lds = sp + 4;
  bf16* xo_s = reinterpret_cast<bf16*>(smem_raw);          // x, later o
  bf16* q_s = xo_s + kRows * lda;
  float* s_s = reinterpret_cast<float*>(q_s + kRows * lda);  // scores; p in place
  bf16* b_s = reinterpret_cast<bf16*>(s_s + kRows * lds);
  const bf16* p_s = reinterpret_cast<const bf16*>(s_s);
  const int ldp = 2 * lds;

  const int blocks_per_image = (p.n + kRows - 1) / kRows;
  const int64_t img = blockIdx.x / blocks_per_image;
  const int r0 = (blockIdx.x % blocks_per_image) * kRows;
  const bf16* x = static_cast<const bf16*>(p.x) + img * p.n * p.c;
  const bf16* kg = static_cast<const bf16*>(p.kv) + img * p.kv_b;
  const bf16* vg = kg + p.c;
  const bf16* wq = static_cast<const bf16*>(p.wq);
  const bf16* wp = static_cast<const bf16*>(p.wp);
  bf16* out = static_cast<bf16*>(p.out) + img * p.n * p.c;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;                 // this warp's first row
  const int r_lo = wr + g, r_hi = r_lo + 8;

  // The x tile, zeros past the last row and column.
  for (int i = threadIdx.x; i < kRows * (cp / 8); i += kThreads) {
    const int r = i / (cp / 8), c = (i % (cp / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < p.n && c < p.c)
      v = *reinterpret_cast<const uint4*>(x + (int64_t)(r0 + r) * p.c + c);
    *reinterpret_cast<uint4*>(xo_s + r * lda + c) = v;
  }

  float acc[8][4];
  // 1. q = ((x @ wq^T + bq) * scale), rounded; zeros in the padding columns.
  for (int n0 = 0; n0 < cp; n0 += kChunk) {
    zero(acc);
    for (int k0 = 0; k0 < kp; k0 += kKTile) {
      __syncthreads();
      load_b_rows(b_s, wq, p.c, n0, p.c, k0, p.c);
      __syncthreads();
      warp_tile(acc, xo_s, lda, wr, k0, b_s);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (col < p.c) {   // C is a multiple of 8: col + 1 < C too
        const float b0 = p.bq[col], b1 = p.bq[col + 1];
        v[0] = (acc[j][0] + b0) * p.scale;
        v[1] = (acc[j][1] + b1) * p.scale;
        v[2] = (acc[j][2] + b0) * p.scale;
        v[3] = (acc[j][3] + b1) * p.scale;
      }
      *reinterpret_cast<__nv_bfloat162*>(q_s + r_lo * lda + col) =
          __floats2bfloat162_rn(v[0], v[1]);
      *reinterpret_cast<__nv_bfloat162*>(q_s + r_hi * lda + col) =
          __floats2bfloat162_rn(v[2], v[3]);
    }
  }

  // 2. The scores q @ k^T, 64 keys at a time, in f32.
  for (int n0 = 0; n0 < sp; n0 += kChunk) {
    zero(acc);
    for (int k0 = 0; k0 < kp; k0 += kKTile) {
      __syncthreads();
      load_b_rows(b_s, kg, p.kv_n, n0, p.s, k0, p.c);
      __syncthreads();
      warp_tile(acc, q_s, lda, wr, k0, b_s);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(s_s + r_lo * lds + col) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(s_s + r_hi * lds + col) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }

  // 3. Each warp's rows: p = softmax(s) with the row max, rounded, written
  //    as bf16 over the row's own scores; zeros at the padding keys.
  __syncwarp();
  for (int r = wr; r < wr + 16; ++r) {
    float* srow = s_s + r * lds;
    float e[kMaxKeys / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kMaxKeys / 32; ++i) {
      const int j = lane + 32 * i;
      e[i] = j < p.s ? srow[j] : -INFINITY;
      mx = fmaxf(mx, e[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxKeys / 32; ++i) {
      e[i] = lane + 32 * i < p.s ? expf(e[i] - mx) : 0.f;
      sum += e[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    __syncwarp();   // every lane has read the row before it is overwritten
    bf16* prow = reinterpret_cast<bf16*>(srow);
#pragma unroll
    for (int i = 0; i < kMaxKeys / 32; ++i) {
      const int j = lane + 32 * i;
      if (j < sp) prow[j] = __float2bfloat16_rn(e[i] / sum);
    }
    __syncwarp();
  }

  // 4. o = p @ v, rounded, over the x tile (no longer needed).
  for (int n0 = 0; n0 < cp; n0 += kChunk) {
    zero(acc);
    for (int k0 = 0; k0 < skp; k0 += kKTile) {
      __syncthreads();
      load_b_cols(b_s, vg, p.kv_n, n0, p.c, k0, p.s);
      __syncthreads();
      warp_tile(acc, p_s, ldp, wr, k0, b_s);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(xo_s + r_lo * lda + col) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(xo_s + r_hi * lda + col) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
    }
  }

  // 5. y = o @ wp^T + bp, to device memory.
  for (int n0 = 0; n0 < cp; n0 += kChunk) {
    zero(acc);
    for (int k0 = 0; k0 < kp; k0 += kKTile) {
      __syncthreads();
      load_b_rows(b_s, wp, p.c, n0, p.c, k0, p.c);
      __syncthreads();
      warp_tile(acc, xo_s, lda, wr, k0, b_s);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= p.c) continue;
      const float b0 = p.bp[col], b1 = p.bp[col + 1];
      if (r0 + r_lo < p.n)
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)(r0 + r_lo) * p.c + col) =
            __floats2bfloat162_rn(acc[j][0] + b0, acc[j][1] + b1);
      if (r0 + r_hi < p.n)
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)(r0 + r_hi) * p.c + col) =
            __floats2bfloat162_rn(acc[j][2] + b0, acc[j][3] + b1);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA

constexpr int kFRows = 32;       // query rows per block: one a lane
constexpr int kFThreads = 256;   // 8 warps, each a set of columns
constexpr int kFWarps = kFThreads / 32;

size_t f32_smem_bytes(int c, int s) {
  return sizeof(float) * (2 * (size_t)kFRows * (c + 1) + (size_t)kFRows * (s + 1));
}

__global__ void __launch_bounds__(kFThreads) pvt_sra_f32_kernel(SraArgs p) {
  extern __shared__ float fsmem[];
  const int ldx = p.c + 1, lds = p.s + 1;
  float* xo_s = fsmem;                  // x, later o: kFRows x ldx
  float* q_s = xo_s + kFRows * ldx;
  float* s_s = q_s + kFRows * ldx;      // scores, then p: kFRows x lds

  const int blocks_per_image = (p.n + kFRows - 1) / kFRows;
  const int64_t img = blockIdx.x / blocks_per_image;
  const int r0 = (blockIdx.x % blocks_per_image) * kFRows;
  const float* x = static_cast<const float*>(p.x) + img * p.n * p.c;
  const float* kg = static_cast<const float*>(p.kv) + img * p.kv_b;
  const float* vg = kg + p.c;
  const float* wq = static_cast<const float*>(p.wq);
  const float* wp = static_cast<const float*>(p.wp);
  float* out = static_cast<float*>(p.out) + img * p.n * p.c;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kFRows * p.c; i += kFThreads) {
    const int r = i / p.c, c = i % p.c;
    xo_s[r * ldx + c] = r0 + r < p.n ? x[(int64_t)(r0 + r) * p.c + c] : 0.f;
  }
  __syncthreads();

  const float* xr = xo_s + lane * ldx;
  for (int col = warp; col < p.c; col += kFWarps) {
    const float* w = wq + (int64_t)col * p.c;
    float a = 0.f;
    for (int k = 0; k < p.c; ++k) a = fmaf(xr[k], __ldg(w + k), a);
    q_s[lane * ldx + col] = (a + p.bq[col]) * p.scale;
  }
  __syncthreads();

  const float* qr = q_s + lane * ldx;
  for (int j = warp; j < p.s; j += kFWarps) {
    const float* kr = kg + (int64_t)j * p.kv_n;
    float a = 0.f;
    for (int k = 0; k < p.c; ++k) a = fmaf(qr[k], __ldg(kr + k), a);
    s_s[lane * lds + j] = a;
  }
  __syncthreads();

  for (int r = warp; r < kFRows; r += kFWarps) {
    float* srow = s_s + r * lds;
    float mx = -INFINITY;
    for (int j = lane; j < p.s; j += 32) mx = fmaxf(mx, srow[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < p.s; j += 32) {
      const float e = expf(srow[j] - mx);
      srow[j] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < p.s; j += 32) srow[j] = srow[j] / sum;
  }
  __syncthreads();

  const float* pr = s_s + lane * lds;
  for (int col = warp; col < p.c; col += kFWarps) {
    float a = 0.f;
    for (int j = 0; j < p.s; ++j)
      a = fmaf(pr[j], __ldg(vg + (int64_t)j * p.kv_n + col), a);
    xo_s[lane * ldx + col] = a;
  }
  __syncthreads();

  const float* orow = xo_s + lane * ldx;
  for (int col = warp; col < p.c; col += kFWarps) {
    const float* w = wp + (int64_t)col * p.c;
    float a = 0.f;
    for (int k = 0; k < p.c; ++k) a = fmaf(orow[k], __ldg(w + k), a);
    if (r0 + lane < p.n) out[(int64_t)(r0 + lane) * p.c + col] = a + p.bp[col];
  }
}

// ---------------------------------------------------------------------------
// bf16 on Hopper: TMA + wgmma (see the note at the top)

constexpr int kStages = 8;                // ring stages of x tiles

struct TcArgs {
  const float* bq;      // (C,)
  const float* bp;      // (C,)
  int n, s, c;
  int tiles_per_image;  // ceil(N / 64)
  int64_t tiles;        // B * tiles_per_image
  float scale;
};

struct TcTiles {
  static constexpr int kRing = 0;                            // x stages
  static constexpr int kKv = kRing + kStages * wtc::kTileBytes;  // (k, v) x 2
  static constexpr int kW = kKv + 4 * wtc::kTileBytes;       // wq, wp
  static constexpr int kOut = kW + 2 * wtc::kTileBytes;      // a consumer's y
  static constexpr int kBars = kOut + wtc::kConsumers * wtc::kTileBytes;
  // full[kStages], empty[kStages], kv_full[2], kv_empty[2], w_full; 1024
  // bytes of slack for alignment.
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 5) + 1024;
};

// The row maximum over the 4 lanes that hold one row of the tile.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// The scores s of this thread's 32 entries (its rows' keys 8 j + 2 t4 +
// {0, 1}) into p = e (1 / rowsum), e = 2^((s - max) log2(e)) over the keys
// below `keys`, 0 at the others.
__device__ __forceinline__ void softmax_rows(float (&s)[32], int keys,
                                             int t4) {
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (8 * (i / 4) + 2 * t4 + (i & 1) >= keys) s[i] = -INFINITY;
    if (i & 2) mx_hi = fmaxf(mx_hi, s[i]); else mx_lo = fmaxf(mx_lo, s[i]);
  }
  mx_lo = quad_max(mx_lo);
  mx_hi = quad_max(mx_hi);
  float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = hopper::exp2_approx((s[i] - (i & 2 ? mx_hi : mx_lo)) * wtc::kLog2e);
    if (i & 2) l_hi += s[i]; else l_lo += s[i];
  }
  const float inv_lo = 1.f / wtc::quad_sum(l_lo);
  const float inv_hi = 1.f / wtc::quad_sum(l_hi);
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] *= i & 2 ? inv_hi : inv_lo;
}

// One 64 x 64 product of a warpgroup, d = A B over `steps` k16 steps, A
// from registers (the accumulator layout of the product before, packed)
// and B the swizzled tile at b: K-major (TRANS_B 0, 32 bytes a step) or
// MN-major (1, 16 rows a step). Retired before it returns.
template <int TRANS_B>
__device__ __forceinline__ void product_rs(float (&d)[32], uint32_t (&a)[16],
                                           const uint8_t* b, int steps) {
  wtc::zero(d);
  hopper::fence_regs(a);
  hopper::fence_regs(d);
  hopper::wgmma_fence();
#pragma unroll
  for (int m = 0; m < 4; ++m)
    if (m < steps)
      hopper::wgmma_m64n64k16_rs<TRANS_B>(
          d, &a[4 * m], hopper::sw128_desc(b) + (TRANS_B ? 128 : 2) * m,
          m > 0);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(a);
  hopper::fence_regs(d);
}

// The block's tiles are [begin, end) of the B * tiles_per_image in image
// order; its images img0, img0 + 1, ... are numbered j = 0, 1, ... and
// take the kv buffers j % 2. A consumer waits for each image's kv_full in
// order and arrives on its kv_empty once it is done with it (at once for
// an image none of its tiles falls in), always before it waits for the x
// of a later image's tile, so that the producer overwrites a buffer only
// after both consumers released the image two before, and never waits on
// a consumer that waits on it (tests/test_torch_pvt_sra_order.py walks the
// barriers).
__global__ void __launch_bounds__(wtc::kThreads, 1)
pvt_sra_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap kv_map,
                     const __grid_constant__ CUtensorMap wq_map,
                     const __grid_constant__ CUtensorMap wp_map,
                     const __grid_constant__ CUtensorMap out_map, TcArgs a) {
  using L = TcTiles;
  using wtc::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* ring = smem + L::kRing;
  uint8_t* kv_s = smem + L::kKv;            // image j: k at 2 (j % 2), v after
  uint8_t* wq_s = smem + L::kW;
  uint8_t* wp_s = wq_s + kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;
  uint64_t* kv_empty = kv_full + 2;
  uint64_t* w_full = kv_empty + 2;

  const int64_t begin = a.tiles * blockIdx.x / gridDim.x;
  const int64_t end = a.tiles * (blockIdx.x + 1) / gridDim.x;
  const int count = (int)(end - begin);
  const int64_t img0 = begin / a.tiles_per_image;
  const int images = (int)((end - 1) / a.tiles_per_image - img0) + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], 4);   // one arrival a warp of a consumer
    }
    for (int j = 0; j < 2; ++j) {
      hopper::mbar_init(&kv_full[j], 1);
      hopper::mbar_init(&kv_empty[j], 4 * wtc::kConsumers);
    }
    hopper::mbar_init(w_full, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {
    // Producer: the weights once, then each tile's x and, before the first
    // tile of an image, the image's k and v.
    hopper::setmaxnreg_dec<wtc::kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(w_full, 2 * kTileBytes);
      hopper::tma_load_2d(wq_s, &wq_map, w_full, 0, 0);
      hopper::tma_load_2d(wp_s, &wp_map, w_full, 0, 0);
      int64_t loaded = img0 - 1;
      for (int t = 0; t < count; ++t) {
        const int64_t tile = begin + t;
        const int64_t img = tile / a.tiles_per_image;
        const int r0 = (int)(tile - img * a.tiles_per_image) * wtc::kTile;
        if (img != loaded) {
          const int j = (int)(img - img0);
          if (j >= 2) hopper::mbar_wait(&kv_empty[j & 1], ((j >> 1) & 1) ^ 1);
          uint8_t* dst = kv_s + 2 * (j & 1) * kTileBytes;
          hopper::mbar_expect_tx(&kv_full[j & 1], 2 * kTileBytes);
          hopper::tma_load_3d(dst, &kv_map, &kv_full[j & 1], 0, 0, (int)img);
          hopper::tma_load_3d(dst + kTileBytes, &kv_map, &kv_full[j & 1], a.c,
                              0, (int)img);
          loaded = img;
        }
        const int st = t % kStages;
        if (t >= kStages) hopper::mbar_wait(&empty[st], ((t / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[st], kTileBytes);
        hopper::tma_load_3d(ring + st * kTileBytes, &x_map, &full[st], 0, r0,
                            (int)img);
      }
    }
    return;
  }

  // Consumer warpgroup wg: the block's tiles wg, wg + 2, ...
  hopper::setmaxnreg_inc<wtc::kConsumerRegs>();
  const int wg = warp / 4 - 1, tid = threadIdx.x % 128, t4 = lane % 4;
  const int nb_c = a.c / 16;                  // k16 steps over C
  const int nb_keys = (a.s + 15) / 16;        // k16 steps over S
  uint8_t* out_s = smem + L::kOut + wg * kTileBytes;
  // The biases at this thread's columns 8 j + 2 t4 + {0, 1}; 0 past C.
  float bq[16], bp[16];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * t4 + e;
      bq[2 * j + e] = col < a.c ? __ldg(a.bq + col) : 0.f;
      bp[2 * j + e] = col < a.c ? __ldg(a.bp + col) : 0.f;
    }
  int have = -1, done = 0;   // images whose kv_full it waited for, released
  auto reach = [&](int j) {
    for (; have < j; ) {
      ++have;
      hopper::mbar_wait(&kv_full[have & 1], (have >> 1) & 1);
    }
  };
  auto release_to = [&](int j) {   // release images done .. j - 1
    for (; done < j; ++done) {
      reach(done);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&kv_empty[done & 1]);
    }
  };
  hopper::mbar_wait(w_full, 0);
  for (int t = wg; t < count; t += wtc::kConsumers) {
    const int st = t % kStages;
    const int64_t tile = begin + t;
    const int64_t img = tile / a.tiles_per_image;
    const int r0 = (int)(tile - img * a.tiles_per_image) * wtc::kTile;
    const int j = (int)(img - img0);
    const uint8_t* x_s = ring + st * kTileBytes;
    // The images before this tile's go back before its x is awaited: the
    // producer may be waiting for them to issue that x (with one tile an
    // image, the other consumer's images fall between this one's).
    release_to(j);
    hopper::mbar_wait(&full[st], (t / kStages) & 1);

    // q = x wq^T, then the x stage goes back to the producer.
    float acc[32];
    wtc::zero(acc);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      if (ks < nb_c)
        hopper::wgmma_m64n64k16_ss<0>(acc, hopper::sw128_desc(x_s) + 2 * ks,
                                      hopper::sw128_desc(wq_s) + 2 * ks,
                                      ks > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      acc[i] = (acc[i] + bq[(i / 4) * 2 + (i & 1)]) * a.scale;
    uint32_t op[16];
    wtc::pack_a(op, acc);                     // q, rounded

    reach(j);
    const uint8_t* k_s = kv_s + 2 * (j & 1) * kTileBytes;
    product_rs<0>(acc, op, k_s, nb_c);        // s = q k^T
    softmax_rows(acc, a.s, t4);
    wtc::pack_a(op, acc);                     // p, rounded
    product_rs<1>(acc, op, k_s + kTileBytes, nb_keys);   // o = p v
    wtc::pack_a(op, acc);                     // o, rounded
    product_rs<0>(acc, op, wp_s, nb_c);       // y = o wp^T
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += bp[(i / 4) * 2 + (i & 1)];

    // y into this warpgroup's tile once the last tile's store has read it;
    // then one TMA store of the tile, which drops rows past N and columns
    // past C.
    if (tid == 0) hopper::tma_store_wait_read();
    hopper::named_barrier(1 + wg, 128);
    wtc::write_tile(out_s, acc, 1.f, tid);
    hopper::fence_proxy_async();
    hopper::named_barrier(1 + wg, 128);
    if (tid == 0) {
      hopper::tma_store_3d(&out_map, out_s, 0, r0, (int)img);
      hopper::tma_store_commit();
    }
  }
  release_to(images);
  if (tid == 0) hopper::tma_store_wait_read();   // the tile outlives its read
}

// maps: the x, kv, wq and wp geometries of tma.py · sra_maps, then the
// grid's blocks (tma.py · sra_grid). The output's map is x's geometry over
// out.
int launch_wgmma(const SraArgs& p, int batch, const int64_t* maps,
                 cudaStream_t stream) {
  CUtensorMap tmaps[5];
  const void* bases[5] = {p.x, p.kv, p.wq, p.wp, p.out};
  for (int i = 0; i < 5; ++i) {
    const int err = hopper::encode_bf16_map(
        &tmaps[i], bases[i], maps + (i % 4) * hopper::kGeometrySize);
    if (err != 0) return err;
  }
  const int tiles_per_image = (p.n + wtc::kTile - 1) / wtc::kTile;
  const int64_t tiles = (int64_t)batch * tiles_per_image;
  const int64_t blocks = maps[4 * hopper::kGeometrySize];
  if (blocks <= 0 || blocks > tiles) return (int)cudaErrorInvalidConfiguration;
  const TcArgs a = {p.bq, p.bp, p.n, p.s, p.c, tiles_per_image, tiles,
                    p.scale};
  constexpr int smem = TcTiles::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      pvt_sra_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  pvt_sra_wgmma_kernel<<<(unsigned)blocks, wtc::kThreads, smem, stream>>>(
      tmaps[0], tmaps[1], tmaps[2], tmaps[3], tmaps[4], a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <typename Kernel>
int launch(Kernel kernel, int rows_per_block, int threads, size_t smem,
           int batch, const SraArgs& args, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks =
      (int64_t)batch * ((args.n + rows_per_block - 1) / rows_per_block);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bq and bp are f32 (C,). maps: bf16 on
// tma.py · sra_route only, else null: the packed maps of tma.py ·
// packed_sra_maps, which select the TMA + wgmma body. Returns a cudaError_t
// value (0 = ok).
extern "C" int tfimm_pvt_sra(const void* x, const void* kv, int64_t kv_b,
                             int64_t kv_n, const void* wq, const void* bq,
                             const void* wp, const void* bp, void* out,
                             int batch, int n, int s, int c, float scale,
                             int dtype, const int64_t* maps, void* stream) {
  if (batch <= 0 || n <= 0 || s <= 0 || s > kMaxKeys || c <= 0 || c % 8 != 0 ||
      c > kMaxDim)
    return (int)cudaErrorInvalidValue;
  const SraArgs args{x, kv, kv_b, kv_n, wq, static_cast<const float*>(bq), wp,
                     static_cast<const float*>(bp), out, n, s, c, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (maps != nullptr) {
    if (dtype != 1 || c % 16 != 0 || c > wtc::kTile || s > wtc::kTile)
      return (int)cudaErrorInvalidValue;
    const void* ptrs[5] = {x, kv, wq, wp, out};
    for (const void* ptr : ptrs)
      if (!aligned16(ptr)) return (int)cudaErrorMisalignedAddress;
    return launch_wgmma(args, batch, maps, st);
  }
  switch (dtype) {
    case 0:
      return launch(pvt_sra_f32_kernel, kFRows, kFThreads, f32_smem_bytes(c, s),
                    batch, args, st);
    case 1: {
      if (kv_b % 8 != 0 || kv_n % 8 != 0) return (int)cudaErrorMisalignedAddress;
      const void* ptrs[5] = {x, kv, wq, wp, out};
      for (const void* ptr : ptrs)
        if (!aligned16(ptr)) return (int)cudaErrorMisalignedAddress;
      return launch(pvt_sra_bf16_kernel, kRows, kThreads, bf16_smem_bytes(c, s),
                    batch, args, st);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
