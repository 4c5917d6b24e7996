// Fused multi-head attention forward, straight from the packed qkv projection.
//
// Replaces: tfimm_tpu/ops/pallas/fused_mha.py · fused_mha (the Pallas TPU
// kernel). Same function: qkv (B, N, 3*D) with the last dim in timm's
// (3, H, d) order -> out (B, N, D) with the heads already concatenated, so
// it feeds the output projection directly. Per head:
//
//     s = (q_f32 * scale) @ k_f32^T                 (f32)
//     p = exp(min(s, 80)) / rowsum                  (clamped no-max softmax)
//     o = p.astype(io) @ v, accumulated in f32
//
// q, k and v are read in place out of the packed rows and the output is
// written in place into (B, N, D): no transposes, no contiguous copies, and
// the (B, H, N, N) scores never reach device memory.
//
// Normalisation order: p is rounded to the io dtype BEFORE it is divided by
// the row sum (the reference divides first). Because the softmax subtracts
// no running max, key tiles accumulate exp(min(s, 80)) @ v and the row sum
// directly, with no online rescale, and one division at the end. This
// changes bf16 rounding only; in f32 the two orders agree to rounding. The
// row sum is taken over the unrounded f32 exponentials. Masked keys (the
// ragged edge of N) add exactly 0 to both sums. The unnormalised
// accumulator holds at most N * e^80 * max|v|, finite while
// N * max|v| < 6e3 on rows that saturate the clamp.
//
// Two kernels, one per io dtype.
//
// - bf16 (the serving path), for Hopper (hopper.cuh): the packed qkv is a
//   5-D TMA tensor (d, H, 3, N, B), innermost first, with byte strides 2d,
//   2Hd, 6Hd and 6HdN, so a box of (64, 1, 1, 64, 1) is one head's 64 rows
//   x 64 columns of q, k or v, read straight from the projection's output.
//   Rows at or beyond N and columns at or beyond d fall out of bounds and
//   arrive as zeros, so every d up to 128 takes one layout: 64-column,
//   128-byte-swizzled chunks (one up to d = 64, two above), and a box that
//   runs past N never reads the next image's rows. A block owns 128 query
//   rows of one (image, head): one producer warp and two consumer
//   warpgroups of 64 rows each (288 threads). The producer loads both q
//   tiles once, then streams the head's K and V through a ring of 64-key
//   stages (4 stages up to d = 64, which hold all of N <= 256 at once, 2
//   above), each signalled on a "full" mbarrier by TMA's transaction count
//   and released on an "empty" one by the consumers' warps. A consumer
//   computes its 64 x 64 score tile with wgmma (q and k both K-major from
//   shared memory, d / 16 steps), applies scale and clamp and exponentiates
//   in registers, keeps the bf16 p in registers as the A operand of p @ v
//   (the accumulator layout is the A layout, note in hopper.cuh) and reads
//   v from shared memory as an MN-major (transposed) B operand. Since there
//   is no running max, tiles just add up. At the end it divides by the row
//   sum, writes its 64 x d output into its own q tile (swizzled) and stores
//   it with one TMA store per chunk, which clips rows beyond N and columns
//   beyond d. One key tile at a time, in few enough registers (ptxas'
//   report in chip_smoke.py's build log) that two blocks share an SM.
// - f32: plain f32 FMAs (the tensor cores' TF32 would not hold the f32
//   results to 1e-5). 256 threads as a 16 x 16 grid, each owning 4 query
//   rows x 4 keys of a score tile and 4 query rows x up to 8 head columns
//   of the output; tiles kept as f32 with a padded row stride (d + 1).
//
// What bounds it on an H100: at ViT-B/16 (B = 128, N = 197, H = 12, d = 64)
// one call reads 116 MB of qkv, writes 39 MB and does 4 * B * H * N^2 * d =
// 15.3 GFLOP, about 100 flops per byte: under the card's ~295 flops/byte
// ridge for bf16 tensor cores, so an ideal kernel is bounded by device
// memory, at about 46 us at 3.35 TB/s. The bf16 kernel takes 0.095 ms
// there, 49% of that bound and 1.04-1.07x SDPA's time (chip_smoke.py
// phase 2 on an H100 80GB HBM3 at 700 W; PERF.md). What holds it back:
// each block is a chain (TMA latency, then per key tile the scores, the
// exponentials and p @ v, each waiting for the last, then the store) with
// four warpgroups an SM to hide it; N = 197 rounds up to 256 rows and keys
// (the padding is 41% of the exponentials, which the special-function
// units take at an eighth of the FMA units' rate); and the two blocks of a
// head each read its K and V. The f32 kernel is bounded by shared-memory loads
// feeding the FMA units.
//
// Shared memory: bf16 81 KB up to d = 64 (two blocks an SM) and 97 KB above;
// f32 66.5 KB at d = 64 and 115.7 KB at d = 128. Above the 48 KB static
// limit a launch needs the dynamic limit raised, so the launcher sets
// cudaFuncAttributeMaxDynamicSharedMemorySize before every launch and
// returns cudaGetLastError() after it (and the error of a tensor map that
// does not encode).
//
// Coverage: any B, any N (ragged edge masked), any H, and every head dim d
// that is a multiple of 8 up to 128. bf16 needs qkv 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 64;               // query rows per block (f32)
constexpr int kBlockK = 64;               // keys per shared-memory tile (f32)
constexpr int kMaxHeadDim = 128;
constexpr float kSoftmaxClamp = 80.0f;    // dispatch.py SOFTMAX_CLAMP
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma

constexpr int kTile = 64;                 // q rows, keys and columns of a tile
constexpr int kTileBytes = kTile * kTile * 2;
constexpr int kConsumers = 2;             // warpgroups of 64 query rows
constexpr int kTmaThreads = 128 * kConsumers + 32;

// DC: 64-column chunks of the head dim (1 up to d = 64, 2 up to 128).
template <int DC>
struct MhaTiles {
  static constexpr int kStages = DC == 1 ? 4 : 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kConsumers * DC * kTileBytes;
  static constexpr int kV = kK + kStages * DC * kTileBytes;
  static constexpr int kBars = kV + kStages * DC * kTileBytes;
  // q_full, full[stages], empty[stages]; 1024 bytes of slack for alignment.
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int DC>
__global__ void __launch_bounds__(kTmaThreads, 1)
fused_mha_fwd_bf16_kernel(const __grid_constant__ CUtensorMap qkv_map,
                          const __grid_constant__ CUtensorMap out_map, int n,
                          int d, float scale_log2) {
  using L = MhaTiles<DC>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* q_s = smem + L::kQ;
  uint8_t* k_s = smem + L::kK;
  uint8_t* v_s = smem + L::kV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kTile * kConsumers;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nb_tiles = (n + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * kConsumers);   // one arrival a warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {
    // Producer: both q tiles, then K and V a 64-key tile at a time.
    if (lane == 0) {
      hopper::mbar_expect_tx(q_full, kConsumers * DC * kTileBytes);
      for (int c = 0; c < kConsumers; ++c)
        for (int dc = 0; dc < DC; ++dc)
          hopper::tma_load_5d(q_s + (c * DC + dc) * kTileBytes, &qkv_map,
                              q_full, kTile * dc, h, 0, q0 + kTile * c, b);
      for (int t = 0; t < nb_tiles; ++t) {
        const int st = t % kStages;
        const uint32_t phase = (t / kStages) & 1;
        if (t >= kStages) hopper::mbar_wait(&empty[st], phase ^ 1);
        hopper::mbar_expect_tx(&full[st], 2 * DC * kTileBytes);
        for (int dc = 0; dc < DC; ++dc) {
          const int slot = (st * DC + dc) * kTileBytes;
          hopper::tma_load_5d(k_s + slot, &qkv_map, &full[st], kTile * dc, h,
                              1, kTile * t, b);
          hopper::tma_load_5d(v_s + slot, &qkv_map, &full[st], kTile * dc, h,
                              2, kTile * t, b);
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: query rows q0 + 64 wg ... + 63.
  const int wg = warp / 4;
  const int row = (warp % 4) * 16 + lane / 4;   // and row + 8
  const int t4 = lane % 4;
  const int nb_steps = (d + 15) / 16;          // k16 steps of q . k
  const float clamp_log2 = kSoftmaxClamp * kLog2e;
  uint8_t* my_q = q_s + wg * DC * kTileBytes;

  float o[DC][32];
#pragma unroll
  for (int dc = 0; dc < DC; ++dc)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[dc][i] = 0.f;
  float s[32];
  float l_lo = 0.f, l_hi = 0.f;   // this lane's share of the two rows' sums

  // s = q k^T of tile t, issued as one wgmma group.
  auto issue_scores = [&](int t) {
    const int st = t % kStages;
    hopper::mbar_wait(&full[st], (t / kStages) & 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    hopper::fence_regs(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4 * DC; ++ks) {
      if (ks < nb_steps) {
        const int dc = ks / 4, kk = ks % 4;
        const uint64_t a = hopper::sw128_desc(my_q + dc * kTileBytes) + 2 * kk;
        const uint64_t bk =
            hopper::sw128_desc(k_s + (st * DC + dc) * kTileBytes) + 2 * kk;
        hopper::wgmma_m64n64k16_ss<0>(s, a, bk, ks > 0);
      }
    }
    hopper::wgmma_commit();
  };

  // o += p v of tile t, issued as one wgmma group (v MN-major, 16 key rows
  // of 128 bytes a step).
  auto issue_pv = [&](int t, uint32_t (&p)[16]) {
    const int st = t % kStages;
    hopper::fence_regs(p);
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) hopper::fence_regs(o[dc]);
    hopper::wgmma_fence();
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const uint64_t bv =
            hopper::sw128_desc(v_s + (st * DC + dc) * kTileBytes) + 128 * m;
        hopper::wgmma_m64n64k16_rs<1>(o[dc], &p[4 * m], bv, 1);
      }
    }
    hopper::wgmma_commit();
  };

  // exp(min(scale * s, 80)) of tile t as 2^min(scale log2(e) s, 80 log2(e));
  // keys at or beyond n give 0. Column blocks 2m and 2m + 1 are the A
  // registers of k16 step m of p @ v; the sums take the unrounded values.
  auto softmax = [&](int t, uint32_t (&p)[16]) {
    const bool ragged = kTile * (t + 1) > n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = kTile * t + 8 * j + 2 * t4;
      float e0 = hopper::exp2_approx(fminf(s[4 * j] * scale_log2, clamp_log2));
      float e1 = hopper::exp2_approx(fminf(s[4 * j + 1] * scale_log2, clamp_log2));
      float e2 = hopper::exp2_approx(fminf(s[4 * j + 2] * scale_log2, clamp_log2));
      float e3 = hopper::exp2_approx(fminf(s[4 * j + 3] * scale_log2, clamp_log2));
      if (ragged) {
        if (key >= n) e0 = e2 = 0.f;
        if (key + 1 >= n) e1 = e3 = 0.f;
      }
      l_lo += e0 + e1;
      l_hi += e2 + e3;
      p[(j / 2) * 4 + (j % 2) * 2] = hopper::pack_bf16(e0, e1);
      p[(j / 2) * 4 + (j % 2) * 2 + 1] = hopper::pack_bf16(e2, e3);
    }
  };

  // One key tile at a time: the scores, the exponentials, then p @ v, in
  // few enough registers that two blocks share an SM. (Overlapping p @ v of
  // one tile with the next tile's exponentials, as the rel-pos kernel does
  // over its 64 key tiles, needs a second p and too many registers for
  // that, and over 4 key tiles it gains less than the second block.)
  uint32_t p[16];
  hopper::mbar_wait(q_full, 0);
  for (int t = 0; t < nb_tiles; ++t) {
    issue_scores(t);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    softmax(t, p);
    issue_pv(t, p);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(p);
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) hopper::fence_regs(o[dc]);
    if (lane == 0) hopper::mbar_arrive(&empty[t % kStages]);
  }

  // Each row's sum is spread over the 4 lanes of its group.
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;

  // The q tile is free once every warp of the group is past its last score
  // product; it takes the output, which one thread stores.
  hopper::named_barrier(1 + wg, 128);
#pragma unroll
  for (int dc = 0; dc < DC; ++dc) {
    uint8_t* out_tile = my_q + dc * kTileBytes;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int j2 = 4 * j + t4;
      *reinterpret_cast<uint32_t*>(out_tile + hopper::sw128_offset(row, j2)) =
          hopper::pack_bf16(o[dc][4 * j] * inv_lo, o[dc][4 * j + 1] * inv_lo);
      *reinterpret_cast<uint32_t*>(out_tile + hopper::sw128_offset(row + 8, j2)) =
          hopper::pack_bf16(o[dc][4 * j + 2] * inv_hi,
                            o[dc][4 * j + 3] * inv_hi);
    }
  }
  hopper::fence_proxy_async();
  hopper::named_barrier(1 + wg, 128);
  if (threadIdx.x % 128 == 0) {
    for (int dc = 0; dc < DC; ++dc)
      hopper::tma_store_4d(&out_map, my_q + dc * kTileBytes, kTile * dc, h,
                           q0 + kTile * wg, b);
    hopper::tma_store_commit_and_wait();
  }
}

template <int DC>
int launch_bf16(const void* qkv, void* out, const int64_t* maps, int batch,
                int n, int nb_heads, int d, float scale, cudaStream_t stream) {
  CUtensorMap qkv_map, out_map;
  int err = hopper::encode_bf16_map(&qkv_map, qkv, maps);
  if (err != 0) return err;
  err = hopper::encode_bf16_map(&out_map, out, maps + hopper::kGeometrySize);
  if (err != 0) return err;
  constexpr int smem = MhaTiles<DC>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      fused_mha_fwd_bf16_kernel<DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + kTile * kConsumers - 1) / (kTile * kConsumers),
                  nb_heads, batch);
  fused_mha_fwd_bf16_kernel<DC><<<grid, kTmaThreads, smem, stream>>>(
      qkv_map, out_map, n, d, scale * kLog2e);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: FMA

constexpr int kFmaThreads = 256;          // 16 x 16
constexpr int kRows = kBlockQ / 16;       // query rows per thread
constexpr int kKeys = kBlockK / 16;       // keys per thread in a score tile
constexpr int kCols = kMaxHeadDim / 16;   // output columns per thread (max)

size_t fma_smem_bytes(int d) {
  const int ld = d + 1;
  return sizeof(float) *
         (size_t)(kBlockQ * ld + 2 * kBlockK * ld + kBlockQ * (kBlockK + 1));
}

__global__ void __launch_bounds__(kFmaThreads)
fused_mha_fwd_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                         int n, int nb_heads, int d, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int ldp = kBlockK + 1;
  float* q_s = smem;                  // kBlockQ x ld, pre-scaled
  float* k_s = q_s + kBlockQ * ld;    // kBlockK x ld
  float* v_s = k_s + kBlockK * ld;    // kBlockK x ld
  float* p_s = v_s + kBlockK * ld;    // kBlockQ x ldp

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int dim = nb_heads * d;
  const int64_t row_stride = 3 * (int64_t)dim;
  const float* q_g = qkv + (int64_t)b * n * row_stride + (int64_t)h * d;
  const float* k_g = q_g + dim;
  const float* v_g = q_g + 2 * dim;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  for (int i = tid; i < kBlockQ * d; i += kFmaThreads) {
    const int r = i / d, c = i % d;
    const int row = q0 + r;
    q_s[r * ld + c] = row < n ? q_g[(int64_t)row * row_stride + c] * scale : 0.f;
  }

  float acc[kRows][kCols];
  float l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // previous tile fully read (and q_s written)
    for (int i = tid; i < kBlockK * d; i += kFmaThreads) {
      const int r = i / d, c = i % d;
      const int row = k0 + r;
      const bool ok = row < n;
      const int64_t off = (int64_t)row * row_stride + c;
      k_s[r * ld + c] = ok ? k_g[off] : 0.f;
      v_s[r * ld + c] = ok ? v_g[off] : 0.f;
    }
    __syncthreads();

    // Scores for rows ty + 16 i and keys tx + 16 j of this tile.
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_s[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = k_s[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int key = k0 + tx + 16 * j;
        const float e = key < n ? expf(fminf(s[i][j], kSoftmaxClamp)) : 0.f;
        l[i] += e;
        p_s[(ty + 16 * i) * ldp + tx + 16 * j] = e;
      }
    }
    __syncthreads();

    // acc += p @ v for rows ty + 16 i and head columns tx + 16 j.
    const int kmax = min(kBlockK, n - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_s[(ty + 16 * i) * ldp + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        if (c < d) {
          const float vv = v_s[kk * ld + c];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

  // Each row's sum is spread over the 16 tx lanes of one half-warp.
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
    const float inv = 1.f / l[i];
    float* o = out + ((int64_t)b * n + row) * dim + (int64_t)h * d;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 16 * j;
      if (c < d) o[c] = acc[i][j] * inv;
    }
  }
}

int launch_f32(const void* qkv, void* out, int batch, int n, int nb_heads,
               int d, float scale, cudaStream_t stream) {
  const size_t smem = fma_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mha_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, nb_heads, batch);
  fused_mha_fwd_f32_kernel<<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), n, nb_heads, d,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. maps (bf16 only): the geometries of
// the qkv and out tensor maps, hopper::kGeometrySize int64 values each, as
// tfimm_tpu_torch/ops/kernels/tma.py computes them. Returns a cudaError_t
// value (0 = ok).
extern "C" int tfimm_fused_mha_fwd(const void* qkv, void* out,
                                   const int64_t* maps, int batch, int n,
                                   int nb_heads, int head_dim, float scale,
                                   int dtype, void* stream) {
  if (batch <= 0 || n <= 0 || nb_heads <= 0 || head_dim <= 0 ||
      head_dim % 8 != 0 || head_dim > kMaxHeadDim || batch > 65535 ||
      nb_heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_f32(qkv, out, batch, n, nb_heads, head_dim, scale, s);
    case 1:
      if (reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
          reinterpret_cast<uintptr_t>(out) % 16 != 0)
        return (int)cudaErrorMisalignedAddress;
      if (maps == nullptr) return (int)cudaErrorInvalidValue;
      if (head_dim <= kTile)
        return launch_bf16<1>(qkv, out, maps, batch, n, nb_heads, head_dim,
                              scale, s);
      return launch_bf16<2>(qkv, out, maps, batch, n, nb_heads, head_dim,
                            scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
