// Pieces shared by the talking-head attention kernels (cait_attention.cu,
// cait_attention_bwd.cu): constants, the (H, H) mixes in shared memory,
// the per-entry mix arithmetic, the tile loads and products of the two
// tile policies of the first design (FmaTiles for f32, MmaTiles for bf16),
// and, at the end, the pieces of the Hopper bodies (namespace cait::tc:
// TMA-fed wgmma, the bf16 route of tma.py · cait_route). See the notes at
// the top of cait_attention.cu and cait_attention_bwd.cu for the designs.
// Every function here is inline (or a template), so the two objects that
// include it link together.
//
// Layouts in shared memory:
// - a row tile of kTile tokens of one part of qkv (or of g) with all H heads,
//   [H][kTile][ld]: f32 with ld = d + 1 (odd, so that threads that read one
//   column of neighbouring rows hit distinct banks), or bf16 with ld = DP + 8
//   (see MmaTiles);
// - a score tile, [H][kTile][kTile] with a per-head stride of kScoreStride
//   = kTile^2 + 1 (odd, for the mix-gradient reductions that read one
//   element of every head).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cait {

constexpr int kThreads = 256;
constexpr int kTile = 16;                          // query and key tile
constexpr int kMaxHeads = 16;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxDim = 768;                       // H * d
constexpr int kMaxItems = 4 * kMaxDim / kThreads;  // see tile_ab
constexpr int kScoreStride = kTile * kTile + 1;
constexpr float kSoftmaxClamp = 80.0f;             // dispatch.py SOFTMAX_CLAMP

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The (H, H) mixes in the JAX package's kernel orientation (in, out),
// padded with zeros to NH x NH, NH (8 or 16) a compile-time bound of H: the
// per-entry loops over the heads then unroll with no test of H. A padded
// head g gets s'_g = 0, so its row sum is finite, and its mixes are zero,
// so it adds nothing.
struct Mix {
  float c[kMaxHeads * kMaxHeads];    // scale * w_l[h][g] at h * NH + g
  float ww[kMaxHeads * kMaxHeads];   // w_w[g][h] at g * NH + h
  float bl[kMaxHeads], bw[kMaxHeads];
};

// Where the mixes lie in device memory: w_l and w_w (H, H) through their
// row and column strides (the model passes its Dense weights transposed,
// as views), b_l and b_w (H,) contiguous, all four f32 or all bf16.
struct MixSrc {
  const void *w_l, *b_l, *w_w, *b_w;
  int64_t wl_rs, wl_cs, ww_rs, ww_cs;
  int bf16;
};

__device__ __forceinline__ float mix_at(const void* p, int64_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

template <int NH>
__device__ __forceinline__ void load_mix(Mix& m, const MixSrc& src, int H,
                                         float scale) {
  for (int i = threadIdx.x; i < NH * NH; i += kThreads) {
    const int r = i / NH, c = i % NH;
    const bool ok = r < H && c < H;
    m.c[i] = ok ? scale * mix_at(src.w_l, r * src.wl_rs + c * src.wl_cs,
                                 src.bf16)
                : 0.f;
    m.ww[i] = ok ? mix_at(src.w_w, r * src.ww_rs + c * src.ww_cs, src.bf16)
                 : 0.f;
  }
  for (int i = threadIdx.x; i < NH; i += kThreads) {
    m.bl[i] = i < H ? mix_at(src.b_l, i, src.bf16) : 0.f;
    m.bw[i] = i < H ? mix_at(src.b_w, i, src.bf16) : 0.f;
  }
}

// s'_g = sum_h scale * w_l[h][g] * raw[h] + b_l[g].
template <int NH>
__device__ __forceinline__ float mixed_score(const Mix& m, const float* raw,
                                             int g) {
  float s = 0.f;
#pragma unroll
  for (int h = 0; h < NH; ++h) s = fmaf(m.c[h * NH + g], raw[h], s);
  return s + m.bl[g];
}

// The H raw scores of entry e of a score tile, zero beyond H.
template <int NH>
__device__ __forceinline__ void read_entry(const float* s_s, int e, int H,
                                           float* raw) {
#pragma unroll
  for (int h = 0; h < NH; ++h) raw[h] = h < H ? s_s[h * kScoreStride + e] : 0.f;
}

// Pass 1 for this thread's score-tile entry e: exp(min(s'_g, 80)) added to
// its partial row sums.
template <int NH>
__device__ __forceinline__ void add_exps(const Mix& mix, const float* s_s,
                                         int e, int H, float* lsum) {
  float raw[NH];
  read_entry<NH>(s_s, e, H, raw);
#pragma unroll
  for (int g = 0; g < NH; ++g)
    lsum[g] += expf(fminf(mixed_score<NH>(mix, raw, g), kSoftmaxClamp));
}

// Rows [r0, r0 + kTile) of one (N, H d) f32 part (rows rs elements apart,
// the H d columns contiguous from src) into dst [H][kTile][d + 1]; rows at
// or beyond n become zeros. With vec (src and rs 16-byte aligned), each
// thread issues its 16-byte loads four at a time before it stores any, so
// that they are in flight together; otherwise one element at a time.
__device__ inline void load_rows(const float* __restrict__ src, int64_t rs,
                                 int r0, int n, int H, int d, float* dst,
                                 bool vec) {
  const int dim = H * d, ld = d + 1;
  if (!vec) {
    for (int i = threadIdx.x; i < kTile * dim; i += kThreads) {
      const int r = i / dim, col = i % dim;
      dst[((col / d) * kTile + r) * ld + col % d] =
          r0 + r < n ? src[(int64_t)(r0 + r) * rs + col] : 0.f;
    }
    return;
  }
  constexpr int kBatch = 4;
  const int chunks = dim / 4, total = kTile * chunks;   // d % 8 == 0
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kThreads) {
    float4 u[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kThreads, r = i / chunks;
      u[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < total && r0 + r < n)
        u[j] = *reinterpret_cast<const float4*>(
            src + (int64_t)(r0 + r) * rs + (i % chunks) * 4);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kThreads;
      if (i >= total) break;
      const int r = i / chunks, col = (i % chunks) * 4;
      float* out = dst + ((col / d) * kTile + r) * ld + col % d;
      out[0] = u[j].x;
      out[1] = u[j].y;
      out[2] = u[j].z;
      out[3] = u[j].w;
    }
  }
}

// Whether 16-byte loads may read rows of a tensor at ptr with row stride
// rs and batch stride bs (elements of size `size`).
inline bool vec_ok(const void* ptr, int64_t bs, int64_t rs, int size) {
  const int64_t per = 16 / size;
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && bs % per == 0 &&
         rs % per == 0;
}

// S[h][r][c] = sum_i A[h][r][i] * B[h][c][i] over the head dim, for every
// head and r, c < kTile. Each thread computes 2 rows x 4 columns of one
// head: 6 shared-memory loads for 8 FMAs.
__device__ inline void tile_abt(const float* A, const float* B, float* S,
                                int H, int d) {
  const int ld = d + 1;
  for (int it = threadIdx.x; it < 32 * H; it += kThreads) {
    const int cg = it % 4, rg = (it / 4) % 8, h = it / 32;
    const float* a0 = A + (h * kTile + 2 * rg) * ld;
    const float* b0 = B + (h * kTile + 4 * cg) * ld;
    float s[2][4] = {};
    for (int i = 0; i < d; ++i) {
      const float x0 = a0[i], x1 = a0[ld + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float y = b0[j * ld + i];
        s[0][j] = fmaf(x0, y, s[0][j]);
        s[1][j] = fmaf(x1, y, s[1][j]);
      }
    }
    float* out = S + h * kScoreStride + 2 * rg * kTile + 4 * cg;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[j] = s[0][j];
      out[kTile + j] = s[1][j];
    }
  }
}

// acc[it][j] += sum_m X(h, 4 rg + j, m) * B[h][m][c] for this thread's
// items: item i = threadIdx.x + kThreads * it is column col = i % (H d)
// (head h = col / d, c = col % d) of rows 4 rg .. 4 rg + 3, rg = i / (H d).
// X(h, r, m) is the score tile's X[h][r][m], or X[h][m][r] with kTrans.
template <bool kTrans>
__device__ __forceinline__ void tile_ab(const float* X, const float* B, int H,
                                        int d, float (&acc)[kMaxItems][4]) {
  const int dim = H * d, ld = d + 1;
#pragma unroll
  for (int it = 0; it < kMaxItems; ++it) {
    const int i = threadIdx.x + kThreads * it;
    if (i >= 4 * dim) break;
    const int col = i % dim, rg = i / dim, h = col / d;
    const float* x = X + h * kScoreStride;
    const float* b = B + h * kTile * ld + col % d;
    for (int m = 0; m < kTile; ++m) {
      const float y = b[m * ld];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * rg + j;
        acc[it][j] = fmaf(kTrans ? x[m * kTile + r] : x[r * kTile + m], y,
                          acc[it][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the per-head products on the tensor cores (mma.sync m16n8k16, bf16
// in, f32 accumulate). Row tiles are bf16 [H][kTile][DP + 8] (DP: d rounded
// up to 48, 64, 80 or 128; the 8 extra elements keep the fragment loads
// free of bank conflicts), zero beyond row n and column d. Warp w owns heads
// w, w + 8, ..., HPW = NH / 8 of them, so the warps cover every head up to
// NH.

constexpr int kWarps = kThreads / 32;

template <int DP>
__host__ __device__ constexpr int mma_ld() { return DP + 8; }

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two values in one register, the lower column (or k index) in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Rows [r0, r0 + kTile) of one (N, H d) bf16 part into the bf16 layout
// above, 16 bytes a chunk: copied with cp.async (zero-filled beyond row n
// and column d), which the threads go on past, where vec (src and rs
// 16-byte aligned) allows; element by element otherwise. Either way
// cp_wait() and a __syncthreads() must come before the tile is read.
template <int DP>
__device__ inline void load_rows_bf16(const __nv_bfloat16* __restrict__ src,
                                      int64_t rs, int r0, int n, int H, int d,
                                      __nv_bfloat16* dst, bool vec) {
  constexpr int kChunks = DP / 8, LD = mma_ld<DP>();
  for (int i = threadIdx.x; i < H * kTile * kChunks; i += kThreads) {
    const int h = i / (kTile * kChunks), r = (i / kChunks) % kTile;
    const int c = (i % kChunks) * 8;
    const bool ok = r0 + r < n && c < d;
    const __nv_bfloat16* p = ok ? src + (int64_t)(r0 + r) * rs + h * d + c : src;
    __nv_bfloat16* out = dst + (h * kTile + r) * LD + c;
    if (vec) {
      const unsigned addr = (unsigned)__cvta_generic_to_shared(out);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(addr), "l"(p), "r"(ok ? 16 : 0));
    } else {
      *reinterpret_cast<uint4*>(out) =
          ok ? make_uint4(pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]),
                          pack_bf16(p[4], p[5]), pack_bf16(p[6], p[7]))
             : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Waits for all of this thread's cp.async copies.
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// S[h][r][c] = sum_i A[h][r][i] * B[h][c][i] for every head (as tile_abt),
// from bf16 row tiles, in f32.
template <int DP, int HPW>
__device__ inline void tile_abt_mma(const __nv_bfloat16* A,
                                    const __nv_bfloat16* B, float* S, int H) {
  constexpr int LD = mma_ld<DP>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    const int h = warp + kWarps * hh;
    if (h >= H) break;
    const __nv_bfloat16* a = A + h * kTile * LD;
    const __nv_bfloat16* b = B + h * kTile * LD;
    float c[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const __nv_bfloat16* pa = a + g * LD + ks * 16 + 2 * t;
      const uint32_t af[4] = {ld_u32(pa), ld_u32(pa + 8 * LD), ld_u32(pa + 8),
                              ld_u32(pa + 8 * LD + 8)};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __nv_bfloat16* pb = b + (8 * j + g) * LD + ks * 16 + 2 * t;
        mma_16816(c[j], af, ld_u32(pb), ld_u32(pb + 8));
      }
    }
    float* out = S + h * kScoreStride;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        out[(g + 8 * (i / 2)) * kTile + 8 * j + 2 * t + (i & 1)] = c[j][i];
  }
}

// acc[hh] += X_h @ B_h for the warp's heads h = warp + 8 hh: X_h the 16 x 16
// score tile of head h (X[h][r][m], or X[h][m][r] with kTrans), whose values
// are rounded to bf16 here, and B_h the head's 16-row bf16 tile. acc holds
// the m16n8 fragments of the 16 x DP result.
template <int DP, int HPW, bool kTrans>
__device__ inline void tile_ab_mma(const float* X, const __nv_bfloat16* B,
                                   int H, float (&acc)[HPW][DP / 8][4]) {
  constexpr int LD = mma_ld<DP>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    const int h = warp + kWarps * hh;
    if (h >= H) break;
    const float* x = X + h * kScoreStride;
    auto at = [&](int r, int m) {
      return kTrans ? x[m * kTile + r] : x[r * kTile + m];
    };
    const uint32_t af[4] = {
        pack_bf16(at(g, 2 * t), at(g, 2 * t + 1)),
        pack_bf16(at(g + 8, 2 * t), at(g + 8, 2 * t + 1)),
        pack_bf16(at(g, 2 * t + 8), at(g, 2 * t + 9)),
        pack_bf16(at(g + 8, 2 * t + 8), at(g + 8, 2 * t + 9))};
    const __nv_bfloat16* b = B + h * kTile * LD;
#pragma unroll
    for (int jd = 0; jd < DP / 8; ++jd) {
      const __nv_bfloat16* p = b + 2 * t * LD + 8 * jd + g;
      mma_16816(acc[hh][jd], af, pack_bf16(p[0], p[LD]),
                pack_bf16(p[8 * LD], p[9 * LD]));
    }
  }
}

// Column sums of a bf16 row tile (over its kTile rows) added to cs[col].
template <int DP>
__device__ inline void add_colsums_bf16(const __nv_bfloat16* T_s, int H, int d,
                                        float* cs) {
  constexpr int LD = mma_ld<DP>();
  for (int col = threadIdx.x; col < H * d; col += kThreads) {
    const __nv_bfloat16* v = T_s + (col / d) * kTile * LD + col % d;
    float sum = 0.f;
    for (int m = 0; m < kTile; ++m) sum += __bfloat162float(v[m * LD]);
    cs[col] += sum;
  }
}

// Sum over the 16 threads of one score-tile row (a half warp).
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = kTile / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A query tile's row sums, in l_s[g][row] for all NH heads, from the
// threads' partial sums (the 16 threads of a row are a half warp; every
// thread must call this).
template <int NH>
__device__ __forceinline__ void store_row_sums(const float* part, int eq,
                                               int ek, float (*l_s)[kTile]) {
#pragma unroll
  for (int g = 0; g < NH; ++g) {
    const float l = row_sum(part[g]);
    if (ek == 0) l_s[g][eq] = l;
  }
}

// ---------------------------------------------------------------------------
// The two tile policies the kernels are written against: FmaTiles (f32
// tiles, scalar FMAs: the f32 kernels, where the tensor cores' TF32 would
// miss the f32 bar) and MmaTiles<DP, NH> (bf16 tiles, mma.sync: the bf16
// kernels). Each gives its row-tile element and stride, the tile load (which
// may still be in flight until wait() and a __syncthreads()), the two
// products, an accumulator of a 16 x H d result with its store, and column
// sums.

struct FmaTiles {
  using Tile = float;
  struct Acc { float v[kMaxItems][4]; };
  static __host__ __device__ int ld(int d) { return d + 1; }
  // Synchronous (the padded f32 rows are not 16-byte aligned, so no
  // cp.async): wait() has nothing to wait for.
  static __device__ void load(const float* src, int64_t rs, int r0, int n,
                              int H, int d, float* dst, bool vec) {
    load_rows(src, rs, r0, n, H, d, dst, vec);
  }
  static __device__ void wait() {}
  static __device__ void abt(const float* A, const float* B, float* S, int H,
                             int d) {
    tile_abt(A, B, S, H, d);
  }
  template <bool kTrans>
  static __device__ void ab(const float* X, const float* B, int H, int d,
                            Acc& acc) {
    tile_ab<kTrans>(X, B, H, d, acc.v);
  }
  static __device__ void zero(Acc& acc) {
#pragma unroll
    for (int it = 0; it < kMaxItems; ++it)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc.v[it][j] = 0.f;
  }
  // out[r * rs + col] = acc(r, col) (+ bw[col / d] * cs[col] with cs) for
  // the rows r < rows.
  template <typename T>
  static __device__ void store(const Acc& acc, T* out, int64_t rs, int rows,
                               int H, int d, const float* bw, const float* cs) {
    const int dim = H * d;
#pragma unroll
    for (int it = 0; it < kMaxItems; ++it) {
      const int i = threadIdx.x + kThreads * it;
      if (i >= 4 * dim) break;
      const int col = i % dim, rg = i / dim;
      const float bias = cs != nullptr ? bw[col / d] * cs[col] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * rg + j < rows)
          out[(int64_t)(4 * rg + j) * rs + col] = from_f32<T>(acc.v[it][j] + bias);
    }
  }
  // cs[col] += the column's sum over the tile's rows (one owner a column).
  static __device__ void colsums(const float* t, int H, int d, float* cs) {
    for (int col = threadIdx.x; col < H * d; col += kThreads) {
      const float* v = t + (col / d) * kTile * (d + 1) + col % d;
      float sum = 0.f;
      for (int m = 0; m < kTile; ++m) sum += v[m * (d + 1)];
      cs[col] += sum;
    }
  }
};

// DP: the padded head dim; NH: the padded head count of the launch, which
// sets the heads a warp owns.
template <int DP, int NH>
struct MmaTiles {
  using Tile = __nv_bfloat16;
  static constexpr int HPW = NH / kWarps;
  static_assert(HPW * kWarps == NH, "the warps must cover every head");
  struct Acc { float v[HPW][DP / 8][4]; };
  static __host__ __device__ int ld(int) { return mma_ld<DP>(); }
  static __device__ void load(const __nv_bfloat16* src, int64_t rs, int r0,
                              int n, int H, int d, __nv_bfloat16* dst,
                              bool vec) {
    load_rows_bf16<DP>(src, rs, r0, n, H, d, dst, vec);
  }
  static __device__ void wait() { cp_wait(); }
  static __device__ void abt(const __nv_bfloat16* A, const __nv_bfloat16* B,
                             float* S, int H, int) {
    tile_abt_mma<DP, HPW>(A, B, S, H);
  }
  template <bool kTrans>
  static __device__ void ab(const float* X, const __nv_bfloat16* B, int H, int,
                            Acc& acc) {
    tile_ab_mma<DP, HPW, kTrans>(X, B, H, acc.v);
  }
  static __device__ void zero(Acc& acc) {
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh)
#pragma unroll
      for (int jd = 0; jd < DP / 8; ++jd)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc.v[hh][jd][i] = 0.f;
  }
  // As FmaTiles::store, from the m16n8 fragments: rows g and g + 8,
  // columns 8 jd + 2 t and + 1 of each of the warp's heads.
  template <typename T>
  static __device__ void store(const Acc& acc, T* out, int64_t rs, int rows,
                               int H, int d, const float* bw, const float* cs) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const int h = warp + kWarps * hh;
      if (h >= H) break;
#pragma unroll
      for (int jd = 0; jd < DP / 8; ++jd) {
        if (8 * jd + 2 * t >= d) break;
        const int col = h * d + 8 * jd + 2 * t;
        const float b0 = cs != nullptr ? bw[h] * cs[col] : 0.f;
        const float b1 = cs != nullptr ? bw[h] * cs[col + 1] : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = g + 8 * half;
          if (r < rows)
            *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)r * rs + col) =
                __floats2bfloat162_rn(acc.v[hh][jd][2 * half] + b0,
                                      acc.v[hh][jd][2 * half + 1] + b1);
        }
      }
    }
  }
  static __device__ void colsums(const __nv_bfloat16* t, int H, int d,
                                 float* cs) {
    add_colsums_bf16<DP>(t, H, d, cs);
  }
};

// Dynamic shared memory of `tiles` row tiles and `scores` score tiles.
template <typename P>
size_t smem_bytes(int H, int d, int tiles, int scores) {
  return sizeof(typename P::Tile) * (size_t)tiles * H * kTile * P::ld(d) +
         sizeof(float) * (size_t)scores * H * kScoreStride;
}

// Run Launch<T, P, NH>::run(args...): T the io dtype, P its tile policy
// (FmaTiles for f32; MmaTiles<DP, NH> for bf16, DP the head dim d rounded up
// to 48, 64, 80 or 128: d <= 32 runs at 48, padded with zeros), NH = 8 for
// H <= 8 and 16 above. Above 8 heads, D <= 768 leaves d <= 80, so DP = 128
// is built for NH = 8 only and DP = 80 for NH = 16 only. Returns a
// cudaError_t value.
template <template <typename, typename, int> class Launch, int NH,
          typename... Args>
int dispatch_nh(int dtype, int d, Args&&... args) {
  using bf16 = __nv_bfloat16;
  switch (dtype) {
    case 0: return Launch<float, FmaTiles, NH>::run(args...);
    case 1:
      if (d <= 48) return Launch<bf16, MmaTiles<48, NH>, NH>::run(args...);
      if (d <= 64) return Launch<bf16, MmaTiles<64, NH>, NH>::run(args...);
      if constexpr (NH == 8) {
        return Launch<bf16, MmaTiles<128, NH>, NH>::run(args...);
      } else {
        if (d <= 80) return Launch<bf16, MmaTiles<80, NH>, NH>::run(args...);
        return (int)cudaErrorInvalidValue;
      }
    default: return (int)cudaErrorInvalidValue;
  }
}

template <template <typename, typename, int> class Launch, typename... Args>
int dispatch(int dtype, int d, int H, Args&&... args) {
  if (H <= 8) return dispatch_nh<Launch, 8>(dtype, d, args...);
  return dispatch_nh<Launch, 16>(dtype, d, args...);
}

inline bool supported(int n, int H, int d) {
  return n > 0 && H > 0 && H <= kMaxHeads && d > 0 && d % 8 == 0 &&
         d <= kMaxHeadDim && H * d <= kMaxDim;
}

// ---------------------------------------------------------------------------
// The Hopper bodies (bf16, H <= 8 heads of d <= 64, operands contiguous and
// 16-byte aligned: tma.py · cait_route). A block owns 64 query rows of one
// image and every head; its two consumer warpgroups split each stage of 16
// keys, 8 keys each, so that one thread holds the H raw scores of each of
// its four entries (rows row and row + 8, keys 2 (l % 4) and + 1 of the
// warpgroup's 8) at the same register positions of H m64n8 accumulators.
// A producer warpgroup streams the keys through a ring of stages by TMA
// (hopper.cuh), one 16-row box a head and part. Tiles are 128-byte
// swizzled, 64 columns wide: d <= 64 is one chunk, zeros past d.

namespace tc {

constexpr int kRows = 64;                 // query rows of a block
constexpr int kKeys = 16;                 // keys of a stage (tma.py CAIT_KEYS)
constexpr int kMaxNH = 8;                 // heads of the route (CAIT_MAX_HEADS)
constexpr int kMaxD = 64;                 // head dim of the route
constexpr int kWgThreads = 384;           // two consumer warpgroups, a producer
constexpr int kConsumers = 256;
// setmaxnreg: the forward's producer warpgroup sums v's columns on three
// warps (40 registers); the backward's only issues copies (24), which
// leaves its consumers 240. Either split fills at most the SM's 65536.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kRowsProducerRegs = 24;
constexpr int kRowsConsumerRegs = 240;
constexpr int kRowTile = kRows * 128;     // one head's 64 rows: 8 KB
constexpr int kKeyTile = kKeys * 128;     // one head's 16 keys: 2 KB
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClamp2 = kSoftmaxClamp * kLog2e;
// Named barriers (0 is __syncthreads): both consumer warpgroups; one
// warpgroup (+ wg); the consumers and the forward's column-sum warps.
constexpr int kBarConsumers = 1;
constexpr int kBarGroup = 2;
constexpr int kBarColsums = 4;

// The mixes as f32 rows in shared memory, zero past H: row g of each holds
// what output head g of the pre-softmax mix (c2, cs) or input head g of the
// post-softmax mix (ww) takes from every head h.
template <int NH>
struct Tables {
  float c2[NH * NH];   // [g][h]: scale log2(e) w_l[h][g]
  float cs[NH * NH];   // [g][h]: scale w_l[h][g]
  float ww[NH * NH];   // [g][h]: w_w[g][h]
  float bl2[NH];       // log2(e) b_l[g]
  float bw[NH];        // b_w[h]
};

template <int NH>
__device__ __forceinline__ void load_tables(Tables<NH>& t, const MixSrc& src,
                                            int H, float scale) {
  const float scale2 = scale * kLog2e;
  for (int i = threadIdx.x; i < NH * NH; i += blockDim.x) {
    const int g = i / NH, h = i % NH;
    const bool ok = g < H && h < H;
    const float wl =
        ok ? mix_at(src.w_l, h * src.wl_rs + g * src.wl_cs, src.bf16) : 0.f;
    t.c2[i] = scale2 * wl;
    t.cs[i] = scale * wl;
    t.ww[i] = ok ? mix_at(src.w_w, g * src.ww_rs + h * src.ww_cs, src.bf16)
                 : 0.f;
  }
  for (int i = threadIdx.x; i < NH; i += blockDim.x) {
    t.bl2[i] = i < H ? kLog2e * mix_at(src.b_l, i, src.bf16) : 0.f;
    t.bw[i] = i < H ? mix_at(src.b_w, i, src.bf16) : 0.f;
  }
}

// Row g of a table into registers.
template <int NH>
__device__ __forceinline__ void table_row(const float* t, int g,
                                          float (&r)[NH]) {
#pragma unroll
  for (int h = 0; h < NH; h += 2) {
    const float2 v = *reinterpret_cast<const float2*>(t + g * NH + h);
    r[h] = v.x;
    r[h + 1] = v.y;
  }
}

// sum_h w[h] x[h][i] for entry i, as two chains (even and odd heads)
// that the scheduler can interleave.
template <int NH>
__device__ __forceinline__ float head_dot(const float (&w)[NH],
                                          const float (&x)[NH][4], int i) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int h = 0; h < NH; h += 2) {
    s0 = fmaf(w[h], x[h][i], s0);
    s1 = fmaf(w[h + 1], x[h + 1][i], s1);
  }
  return s0 + s1;
}

// s2_g of entry i: log2(e) s'_g = sum_h c2[g][h] raw_h + log2(e) b_l[g].
template <int NH>
__device__ __forceinline__ float mixed2(const float (&c)[NH], float bl,
                                        const float (&raw)[NH][4], int i) {
  return head_dot<NH>(c, raw, i) + bl;
}

// Zeros over [begin, end) bytes of shared memory (16-byte multiples): the
// tiles of heads H ... NH - 1, which no copy fills.
__device__ __forceinline__ void zero_smem(uint8_t* begin, uint8_t* end) {
  for (uint8_t* p = begin + 16 * threadIdx.x; p < end; p += 16 * blockDim.x)
    *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
}

template <int NH>
__device__ __forceinline__ void fence_heads(float (&r)[NH][4]) {
#pragma unroll
  for (int h = 0; h < NH; ++h) hopper::fence_regs(r[h]);
}

// acc[h] (=)= a warpgroup's 64 own rows of head h (at own + h kRowTile)
// times 8 key rows of head h (at keys + h kKeyTile), over the head dim:
// nb_steps k16 steps a head, all part of the caller's wgmma group, issued
// a step of every head at a time so that consecutive products write other
// accumulators. The first step overwrites acc.
template <int NH>
__device__ __forceinline__ void products_n8(float (&acc)[NH][4],
                                            const uint8_t* own,
                                            const uint8_t* keys, int nb_steps) {
#pragma unroll
  for (int ks = 0; ks < kMaxD / 16; ++ks) {
    if (ks < nb_steps) {
#pragma unroll
      for (int h = 0; h < NH; ++h)
        hopper::wgmma_m64n8k16_ss(
            acc[h], hopper::sw128_desc(own + h * kRowTile) + 2 * ks,
            hopper::sw128_desc(keys + h * kKeyTile) + 2 * ks, ks > 0);
    }
  }
}

// Keeps the compiler from moving shared-memory reads (the mix rows)
// across this point. The backward's rows kernel pins each head of its
// unrolled loops, and (with a __syncwarp) each row half: ptxas
// interleaved the two halves' independent work and spilled 1.8 KB at
// NH = 8, and nothing with both pinned (development builds on the H100).
__device__ __forceinline__ void pin_loads() { asm volatile("" ::: "memory"); }

// Sum over the 4 lanes that hold one row of an accumulator.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Pass 1 for a thread's four entries (keys key and key + 1 of rows row and
// row + 8): 2^min(s2_g, 80 log2(e)) added to lsum[g][row half] where the
// key is below n.
template <int NH>
__device__ __forceinline__ void add_exp2s(const Tables<NH>& t,
                                          const float (&raw)[NH][4], int key,
                                          int n, float (&lsum)[NH][2]) {
#pragma unroll
  for (int g = 0; g < NH; ++g) {
    float c[NH];
    table_row<NH>(t.c2, g, c);
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      e[i] = hopper::exp2_approx(fminf(mixed2<NH>(c, t.bl2[g], raw, i),
                                       kClamp2));
    lsum[g][0] += (key < n ? e[0] : 0.f) + (key + 1 < n ? e[1] : 0.f);
    lsum[g][1] += (key < n ? e[2] : 0.f) + (key + 1 < n ? e[3] : 0.f);
  }
}

// The block's row totals from each consumer thread's partial sums
// part[g][row half] (its keys of one warpgroup): quad sums, then the two
// warpgroups' through `sums` ([2][NH][64]) into out[g][row] ([NH][64]),
// as log2 with kLog2; rows at or past n get 0. Every consumer thread
// calls it; out is ready on return.
template <int NH, bool kLog2>
__device__ __forceinline__ void combine_rows(float (&part)[NH][2], float* sums,
                                             float* out, int q0, int n) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, row = 16 * (warp % 4) + lane / 4;
#pragma unroll
  for (int g = 0; g < NH; ++g) {
    const float lo = quad_sum(part[g][0]), hi = quad_sum(part[g][1]);
    if (lane % 4 == 0) {
      sums[(wg * NH + g) * kRows + row] = lo;
      sums[(wg * NH + g) * kRows + row + 8] = hi;
    }
  }
  hopper::named_barrier(kBarConsumers, kConsumers);
  for (int i = threadIdx.x; i < NH * kRows; i += kConsumers) {
    const float v = sums[i] + sums[NH * kRows + i];
    out[i] = q0 + i % kRows < n ? (kLog2 ? __log2f(v) : v) : 0.f;
  }
  hopper::named_barrier(kBarConsumers, kConsumers);
}

// Byte offset of the bf16 element (row, col) of a 128-byte-swizzled tile.
__device__ __forceinline__ uint32_t sw128_elem(int row, int col) {
  return (uint32_t)(row * 128 + ((((col >> 3) ^ (row & 7))) << 4) +
                    (col & 7) * 2);
}

__device__ __forceinline__ float smem_bf16(const uint8_t* p) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}

}  // namespace tc

}  // namespace cait
