// Windowed multi-head attention with the relative-position bias and the
// shifted-window mask (Swin).
//
// Replaces: tfimm_tpu/ops/pallas/window_mha.py · window_mha (the Pallas TPU
// kernel). Same function: q, k, v (BW, N, C) with BW = batch * nb_windows
// (the window index inner), C = H * d, bias (H, N, N) f32, an optional
// additive mask (nW, N, N) f32 applied to window row r as mask[r % nW].
// Per window and head:
//
//     s = (q_f32 * scale) @ k_f32^T + bias[h] (+ mask[r % nW])     (f32)
//     p = exp(min(s, 80)) / rowsum                  (clamped no-max softmax)
//     o = p.astype(io) @ v, summed in f32, rounded once to the io dtype
//
// A whole row of keys (N <= 144) fits one tile, so each row's sum is taken
// before p is rounded: p is normalised first and then rounded, as the TPU
// kernel and the plain version do (unlike fused_mha.cu, which streams keys
// and rounds the unnormalised exponentials).
//
// q, k and v are read with their own batch and row strides, so the three
// slices of a packed (BW, N, 3C) qkv need no copy; the output is written
// contiguous, (BW, N, C), with the heads concatenated.
//
// What bounds it on an H100: at Swin-T's stage 1 at batch 128 (BW = 8192
// windows, N = 49, C = 96, H = 3, the shift mask of 64 windows) one call
// reads 231 MB of q, k, v and writes 77 MB, against 4 * BW * N^2 * C = 7.6
// GFLOP: under 25 flops a byte, so device memory bounds it (about 92 us at
// 3.35 TB/s; 11.6 us at stage 4). Three bodies:
//
// - bf16 on Hopper (tma.py · window_route: N <= 64, d a multiple of 8 up to
//   64, 16-byte aligned operands and strides; every registered Swin at
//   window 7, and hf_swin's N = 16, d = 8): TMA + wgmma, one 64-row tile a
//   window and one 64-column chunk a head (window_mha_common.cuh). q, k and
//   v are 4-D TMA tensors (d, H, N, BW) through their own strides, so a
//   (64, 1, 64, 1) box is one head of one window, with zeros past N and
//   past d. A block owns one head and a group of that head's windows, in
//   the order of the mask positions (window_mha_common.cuh); the wrapper
//   sizes the groups so that one block runs on each SM. One producer warp
//   streams each window's q, k and v through a ring of kStages stages
//   (full / empty mbarriers); two consumer warpgroups take alternate
//   windows. A consumer computes S = q k^T (wgmma m64n64k16, both operands
//   K-major, d / 16 steps), adds the bias and mask it holds in registers
//   in the layout of S (bias[h] + mask[p] summed in f32 and scaled by
//   log2(e), loaded once a mask position: the shifted blocks read their
//   mask once a block, not once a score), takes p = 2^min(scale log2(e) s
//   + bm, 80 log2(e)) (ex2.approx), the row sum over the 4 lanes of a row,
//   p = e (1 / rowsum), rounded to bf16 in registers as the A operand of
//   o = p v (wgmma, v MN-major), and writes o (bf16) into its own swizzled
//   tile, from which its first N rows and d columns go out by plain 16-byte
//   stores. The release of a stage waits only for the products. Measured on
//   the H100 in development builds: a division an entry, and a TMA store of
//   o that queued behind the ring's loads on the SM's TMA unit, each held
//   an earlier build of this body above the first design's time
//   (scripts/perf/torch_window_parts.py times the body with a part left
//   out).
//   Departures from the first body: the bias and the mask are summed
//   before the score is added (the first body adds them one at a time; the
//   mask is 0 or -100, so only masked entries differ, and their p is below
//   1e-40 either way); log2(e) is folded in; p is e times the row sum's
//   reciprocal (a rounding of f32 p before its rounding to bf16); at d = 32
//   the products run 64 deep and wide, half of it zeros (TMA's fill), which
//   costs little where memory bounds the kernel.
// - bf16 off that route (N up to 144, d up to 128, misaligned operands):
//   the first design, tensor cores through mma.sync m16n8k16 (bf16 in, f32
//   accumulate), one thread block per (window, head). q, k, v of the
//   window's head are stored in shared memory with N padded to NP (32, 64
//   or 144) rows and d padded to DP (16, 32, 64 or 128) columns with zeros.
//   4 warps, each owning 16-row query tiles in turn: the warp computes the
//   16 x NP score tile in registers, adds the bias and the mask in f32,
//   exponentiates, sums each row over the lanes of its group, normalises,
//   and reuses the registers as the A operand of p @ v (the accumulator
//   layout of two adjacent 8-key score tiles is the A layout of one 16-key
//   step). Pad keys are left out of the row sum (their p is 0) and pad
//   query rows are not stored. It loads each block's tiles with plain
//   synchronous loads and reads the bias (and the mask) from L2 per score.
// - f32: plain f32 FMAs (TF32 would miss the 1e-5 bar). k and v in shared
//   memory with a padded row (d + 1); one warp per query row in turn, the
//   lanes over keys for the scores and over head columns for p @ v.
//
// Coverage: any BW, N <= 144, any H, d a multiple of 8 up to 128, any
// strides whose last dimension is 1. 16-byte loads in the mma.sync body
// when every base and stride allow them, element loads otherwise. Every
// launch is followed by cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "window_mha_common.cuh"

namespace {

constexpr int kThreads = 128;             // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr float kSoftmaxClamp = 80.0f;    // dispatch.py SOFTMAX_CLAMP
constexpr int kMaxN = 144;
constexpr int kMaxHeadDim = 128;

struct WinArgs {
  const void* q;
  const void* k;
  const void* v;
  int64_t q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;  // batch and row strides
  const float* bias;   // (H, N, N)
  const float* mask;   // (nW, N, N) or null
  void* out;           // (BW, N, H * d)
  int n, nb_heads, d, nb_win;
  float scale;
  int vec;             // 16-byte loads allowed
};

// s + bias (+ mask) for score (row, col) of window w, head h; both < n.
__device__ __forceinline__ float biased(const WinArgs& a, int w, int h,
                                        int row, int col, float s) {
  const int64_t nn = (int64_t)a.n * a.n;
  const int64_t rc = (int64_t)row * a.n + col;
  s += __ldg(a.bias + h * nn + rc);
  if (a.mask != nullptr) s += __ldg(a.mask + (w % a.nb_win) * nn + rc);
  return s;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync)

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

// Two bf16 values in one register, the lower column (or k index) in the
// low half, as the mma fragments expect.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <int DP>
__host__ __device__ constexpr int mma_ld() { return DP + 8; }  // padded smem row

template <int DP, int NP>
size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * 3 * (size_t)NP * mma_ld<DP>();
}

// The window's rows of one head of q, k or v into shared memory (NP x DP);
// rows at or beyond n and columns at or beyond d become zeros.
template <int DP, int NP>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src,
                                          int64_t row_stride,
                                          __nv_bfloat16* dst, int n, int d,
                                          int vec) {
  constexpr int kChunks = DP / 8;
  for (int i = threadIdx.x; i < NP * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r < n && c < d) {
      const __nv_bfloat16* p = src + (int64_t)r * row_stride + c;
      if (vec) {
        u = *reinterpret_cast<const uint4*>(p);
      } else {
        unsigned short e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = __bfloat16_as_ushort(p[j]);
        u = make_uint4(e[0] | ((uint32_t)e[1] << 16), e[2] | ((uint32_t)e[3] << 16),
                       e[4] | ((uint32_t)e[5] << 16), e[6] | ((uint32_t)e[7] << 16));
      }
    }
    *reinterpret_cast<uint4*>(dst + r * mma_ld<DP>() + c) = u;
  }
}

// DP: d rounded up (16, 32, 64, 128); NP: N rounded up (32, 64, 144).
template <int DP, int NP>
__global__ void __launch_bounds__(kThreads)
window_mha_bf16_kernel(WinArgs a) {
  constexpr int LD = mma_ld<DP>();
  constexpr int kSteps = DP / 16;          // k steps of q @ k^T
  constexpr int kDimTiles = DP / 8;        // 8-column tiles of the output
  constexpr int kKeyTiles = NP / 8;        // 8-key tiles of a score row
  constexpr int kRowTiles = NP / 16;       // 16-row query tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + NP * LD;
  __nv_bfloat16* v_s = k_s + NP * LD;

  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int n = a.n, d = a.d;
  const int64_t hd = (int64_t)h * d;
  load_tile<DP, NP>(static_cast<const __nv_bfloat16*>(a.q) + w * a.q_bs + hd,
                    a.q_rs, q_s, n, d, a.vec);
  load_tile<DP, NP>(static_cast<const __nv_bfloat16*>(a.k) + w * a.k_bs + hd,
                    a.k_rs, k_s, n, d, a.vec);
  load_tile<DP, NP>(static_cast<const __nv_bfloat16*>(a.v) + w * a.v_bs + hd,
                    a.v_rs, v_s, n, d, a.vec);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                  // fragment row group
  const int t = lane % 4;                  // thread in group
  const int dim = a.nb_heads * d;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) + (int64_t)w * n * dim + hd;

  for (int rt = warp; rt < kRowTiles; rt += kWarps) {
    const int wr = rt * 16;
    if (wr >= n) break;
    uint32_t qf[kSteps][4];
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const __nv_bfloat16* p = q_s + (wr + g) * LD + ks * 16 + 2 * t;
      qf[ks][0] = ld_u32(p);
      qf[ks][1] = ld_u32(p + 8 * LD);
      qf[ks][2] = ld_u32(p + 8);
      qf[ks][3] = ld_u32(p + 8 * LD + 8);
    }
    float s[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        const __nv_bfloat16* p = k_s + (8 * j + g) * LD + ks * 16 + 2 * t;
        mma_16816(s[j], qf[ks], ld_u32(p), ld_u32(p + 8));
      }
    }

    // exp(min(scale * s + bias (+ mask), 80)) in f32; pad keys and pad rows
    // give 0. Elements 0, 1 lie on row wr + g, elements 2, 3 on row
    // wr + g + 8, at keys 8 j + 2 t and 8 j + 2 t + 1.
    const int row_lo = wr + g, row_hi = row_lo + 8;
    float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row_lo : row_hi;
        const int col = 8 * j + 2 * t + (e & 1);
        float p = 0.f;
        if (row < n && col < n)
          p = expf(fminf(biased(a, w, h, row, col, s[j][e] * a.scale),
                         kSoftmaxClamp));
        s[j][e] = p;
        if (e < 2) l_lo += p; else l_hi += p;
      }
    }
    // Each row's sum is spread over the 4 lanes of its group.
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
    if (row_lo >= n) l_lo = 1.f;           // pad rows: all zeros, not stored
    if (row_hi >= n) l_hi = 1.f;

    // p = e / rowsum, rounded to bf16, as the A operand of p @ v.
    uint32_t pf[kKeyTiles / 2][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      pf[j / 2][(j % 2) * 2 + 0] = pack_bf16(s[j][0] / l_lo, s[j][1] / l_lo);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[j][2] / l_hi, s[j][3] / l_hi);
    }
    float o[kDimTiles][4];
#pragma unroll
    for (int jd = 0; jd < kDimTiles; ++jd)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[jd][r] = 0.f;
#pragma unroll
    for (int m = 0; m < kKeyTiles / 2; ++m) {
      if (16 * m >= n) break;              // all 16 keys are padding
#pragma unroll
      for (int jd = 0; jd < kDimTiles; ++jd) {
        const __nv_bfloat16* p = v_s + (16 * m + 2 * t) * LD + 8 * jd + g;
        mma_16816(o[jd], pf[m], pack_bf16(p[0], p[LD]),
                  pack_bf16(p[8 * LD], p[9 * LD]));
      }
    }

#pragma unroll
    for (int jd = 0; jd < kDimTiles; ++jd) {
      const int c = 8 * jd + 2 * t;
      if (c >= d) break;
      if (row_lo < n)
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row_lo * dim + c) =
            __floats2bfloat162_rn(o[jd][0], o[jd][1]);
      if (row_hi < n)
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row_hi * dim + c) =
            __floats2bfloat162_rn(o[jd][2], o[jd][3]);
    }
  }
}

template <int DP, int NP>
int launch_bf16(const WinArgs& a, int bw, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<DP, NP>();
  cudaError_t err = cudaFuncSetAttribute(
      window_mha_bf16_kernel<DP, NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_mha_bf16_kernel<DP, NP><<<dim3(bw, a.nb_heads), kThreads, smem,
                                   stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DP>
int dispatch_n(const WinArgs& a, int bw, cudaStream_t s) {
  if (a.n <= 32) return launch_bf16<DP, 32>(a, bw, s);
  if (a.n <= 64) return launch_bf16<DP, 64>(a, bw, s);
  return launch_bf16<DP, kMaxN>(a, bw, s);
}

int dispatch_bf16(const WinArgs& a, int bw, cudaStream_t s) {
  if (a.d <= 16) return dispatch_n<16>(a, bw, s);
  if (a.d <= 32) return dispatch_n<32>(a, bw, s);
  if (a.d <= 64) return dispatch_n<64>(a, bw, s);
  return dispatch_n<kMaxHeadDim>(a, bw, s);
}

// ---------------------------------------------------------------------------
// bf16 on Hopper: TMA + wgmma (window_mha_common.cuh)

constexpr int kStages = 6;                // ring stages of (q, k, v)

struct TcArgs {
  const float* bias;    // (H, N, N)
  const float* mask;    // (nW, N, N) or null
  __nv_bfloat16* out;   // (BW, N, C) contiguous
  int bw, n, d, c;
  int per_pos, nb_pos;  // windows a mask position, positions (1 unmasked)
  int group;            // list entries a block
  float scale_log2;     // scale * log2(e)
};

struct TcTiles {
  static constexpr int kRing = 0;                      // stages x (q, k, v)
  static constexpr int kOut = kRing + kStages * 3 * wtc::kTileBytes;
  // A consumer's staging of the bias + mask (N^2 f32).
  static constexpr int kStaging = kOut + wtc::kConsumers * wtc::kTileBytes;
  static constexpr int kStagingBytes = wtc::kTile * wtc::kTile * 4;
  static constexpr int kBars = kStaging + wtc::kConsumers * kStagingBytes;
  // full[stages], empty[stages]; 1024 bytes of slack for alignment.
  static constexpr int kBytes = kBars + 8 * 2 * kStages + 1024;
};

__global__ void __launch_bounds__(wtc::kThreads, 1)
window_mha_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        TcArgs a) {
  using L = TcTiles;
  using wtc::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* ring = smem + L::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;

  const int h = blockIdx.y;
  const int i0 = blockIdx.x * a.group;
  const int count = min(a.group, a.bw - i0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], 4);   // one arrival a warp of a consumer
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {
    // Producer: each window's q, k and v tiles of head h, in list order.
    hopper::setmaxnreg_dec<wtc::kProducerRegs>();
    if (threadIdx.x == 0) {
      for (int t = 0; t < count; ++t) {
        const int st = t % kStages;
        if (t >= kStages) hopper::mbar_wait(&empty[st], ((t / kStages) & 1) ^ 1);
        int pos;
        const int r = wtc::window_at(i0 + t, a.per_pos, a.nb_pos, &pos);
        uint8_t* stage = ring + st * 3 * kTileBytes;
        hopper::mbar_expect_tx(&full[st], 3 * kTileBytes);
        hopper::tma_load_4d(stage, &q_map, &full[st], 0, h, 0, r);
        hopper::tma_load_4d(stage + kTileBytes, &k_map, &full[st], 0, h, 0, r);
        hopper::tma_load_4d(stage + 2 * kTileBytes, &v_map, &full[st], 0, h,
                            0, r);
      }
    }
    return;
  }

  // Consumer warpgroup wg: list entries wg, wg + 2, ...
  hopper::setmaxnreg_inc<wtc::kConsumerRegs>();
  const int wg = warp / 4 - 1, tid = threadIdx.x % 128;
  const int row = (tid / 32) * 16 + lane / 4;   // and row + 8
  const int nb_k = (a.d + 15) / 16;             // k16 steps of q . k
  const int nb_keys = (a.n + 15) / 16;          // k16 steps of p @ v
  const int64_t nn = (int64_t)a.n * a.n;
  uint8_t* out_s = smem + L::kOut + wg * kTileBytes;
  float* staging =
      reinterpret_cast<float*>(smem + L::kStaging + wg * L::kStagingBytes);
  float bm[32];
  int bm_pos = -1;
  for (int t = wg; t < count; t += wtc::kConsumers) {
    const int st = t % kStages;
    int pos;
    const int r = wtc::window_at(i0 + t, a.per_pos, a.nb_pos, &pos);
    if (pos != bm_pos) {
      wtc::load_bias(bm, staging, a.bias + h * nn,
                     a.mask == nullptr ? nullptr : a.mask + pos * nn, a.n,
                     tid, 1 + wg);
      bm_pos = pos;
    }
    const uint8_t* stage = ring + st * 3 * kTileBytes;
    hopper::mbar_wait(&full[st], (t / kStages) & 1);

    float s[32];
    wtc::zero(s);
    hopper::fence_regs(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      if (ks < nb_k)
        hopper::wgmma_m64n64k16_ss<0>(
            s, hopper::sw128_desc(stage) + 2 * ks,
            hopper::sw128_desc(stage + kTileBytes) + 2 * ks, ks > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);

    wtc::softmax_tile(s, bm, a.scale_log2, row < a.n, row + 8 < a.n);
    uint32_t p[16];
    wtc::pack_a(p, s);
    float o[32];
    wtc::zero(o);
    hopper::fence_regs(p);
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (m < nb_keys)
        hopper::wgmma_m64n64k16_rs<1>(
            o, &p[4 * m], hopper::sw128_desc(stage + 2 * kTileBytes) + 128 * m,
            m > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(p);
    hopper::fence_regs(o);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);

    // o into this warpgroup's tile once every thread has stored the last
    // window's from it; then its first n rows and d columns out.
    hopper::named_barrier(1 + wg, 128);
    wtc::write_tile(out_s, o, 1.f, tid);
    hopper::named_barrier(1 + wg, 128);
    wtc::store_rows(out_s, a.out + (int64_t)r * a.n * a.c + h * a.d, a.c, a.n,
                    a.d, tid);
  }
}

// maps: the q, k and v geometries of tma.py · window_maps, then the list
// entries a block.
int launch_wgmma(const WinArgs& w, int bw, const int64_t* maps,
                 cudaStream_t stream) {
  CUtensorMap tmaps[3];
  const void* bases[3] = {w.q, w.k, w.v};
  for (int i = 0; i < 3; ++i) {
    const int err = hopper::encode_bf16_map(&tmaps[i], bases[i],
                                            maps + i * hopper::kGeometrySize);
    if (err != 0) return err;
  }
  const int group = (int)maps[3 * hopper::kGeometrySize];
  if (group <= 0) return (int)cudaErrorInvalidValue;
  const int nb_pos = w.mask == nullptr ? 1 : w.nb_win;
  const TcArgs a = {w.bias, w.mask, static_cast<__nv_bfloat16*>(w.out), bw,
                    w.n, w.d, w.nb_heads * w.d, bw / nb_pos, nb_pos, group,
                    w.scale * wtc::kLog2e};
  constexpr int smem = TcTiles::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      window_mha_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((bw + group - 1) / group, w.nb_heads);
  window_mha_wgmma_kernel<<<grid, wtc::kThreads, smem, stream>>>(
      tmaps[0], tmaps[1], tmaps[2], a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: FMA

size_t fma_smem_bytes(int n, int d) {
  return sizeof(float) * ((size_t)2 * n * (d + 1) + (size_t)kWarps * (n + d));
}

__global__ void __launch_bounds__(kThreads)
window_mha_f32_kernel(WinArgs a) {
  extern __shared__ float smem[];
  const int n = a.n, d = a.d, ld = d + 1;
  float* k_s = smem;                       // n x ld
  float* v_s = k_s + n * ld;               // n x ld
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p_s = v_s + n * ld + warp * (n + d);  // this warp's p row ...
  float* q_s = p_s + n;                        // ... and its scaled q row

  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int64_t hd = (int64_t)h * d;
  const float* q = static_cast<const float*>(a.q) + w * a.q_bs + hd;
  const float* k = static_cast<const float*>(a.k) + w * a.k_bs + hd;
  const float* v = static_cast<const float*>(a.v) + w * a.v_bs + hd;
  for (int i = threadIdx.x; i < n * d; i += kThreads) {
    const int r = i / d, c = i % d;
    k_s[r * ld + c] = k[(int64_t)r * a.k_rs + c];
    v_s[r * ld + c] = v[(int64_t)r * a.v_rs + c];
  }
  __syncthreads();

  const int dim = a.nb_heads * d;
  for (int row = warp; row < n; row += kWarps) {
    for (int c = lane; c < d; c += 32) q_s[c] = q[(int64_t)row * a.q_rs + c] * a.scale;
    __syncwarp();
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      float s = 0.f;
      for (int c = 0; c < d; ++c) s = fmaf(q_s[c], k_s[j * ld + c], s);
      const float e = expf(fminf(biased(a, w, h, row, j, s), kSoftmaxClamp));
      p_s[j] = e;
      l += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    for (int j = lane; j < n; j += 32) p_s[j] = p_s[j] / l;
    __syncwarp();
    float* o = static_cast<float*>(a.out) + ((int64_t)w * n + row) * dim + hd;
    for (int c = lane; c < d; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(p_s[j], v_s[j * ld + c], acc);
      o[c] = acc;
    }
    __syncwarp();                          // p_s and q_s are rewritten next
  }
}

int launch_f32(const WinArgs& a, int bw, cudaStream_t stream) {
  const size_t smem = fma_smem_bytes(a.n, a.d);
  cudaError_t err = cudaFuncSetAttribute(
      window_mha_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_mha_f32_kernel<<<dim3(bw, a.nb_heads), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// q, k, v: (BW, N, H * d) with batch strides *_bs and row strides *_rs in
// elements (the last dimension contiguous); bias (H, N, N) f32; mask
// (nb_win, N, N) f32 or null; out (BW, N, H * d) contiguous. dtype: 0 =
// float32, 1 = bfloat16. maps: bf16 on tma.py · window_route only, else
// null: the geometries of the q, k and v tensor maps
// (hopper::kGeometrySize int64 values each) and the windows a block, as
// tma.py · packed_window_maps computes them; they select the TMA + wgmma
// body. Returns a cudaError_t value (0 = ok).
extern "C" int tfimm_window_mha(const void* q, const void* k, const void* v,
                                int64_t q_bs, int64_t q_rs, int64_t k_bs,
                                int64_t k_rs, int64_t v_bs, int64_t v_rs,
                                const void* bias, const void* mask, void* out,
                                int bw, int n, int nb_heads, int head_dim,
                                int nb_win, float scale, int dtype,
                                const int64_t* maps, void* stream) {
  if (bw <= 0 || n <= 0 || n > kMaxN || nb_heads <= 0 || nb_heads > 65535 ||
      head_dim <= 0 || head_dim % 8 != 0 || head_dim > kMaxHeadDim ||
      nb_win <= 0 || bw % nb_win != 0)
    return (int)cudaErrorInvalidValue;
  WinArgs a = {q, k, v, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
               static_cast<const float*>(bias), static_cast<const float*>(mask),
               out, n, nb_heads, head_dim, nb_win, scale, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (maps != nullptr) {
    if (dtype != 1 || n > wtc::kTile || head_dim > wtc::kTile)
      return (int)cudaErrorInvalidValue;
    if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
      return (int)cudaErrorMisalignedAddress;
    return launch_wgmma(a, bw, maps, s);
  }
  switch (dtype) {
    case 0:
      return launch_f32(a, bw, s);
    case 1:
      a.vec = aligned16(q) && aligned16(k) && aligned16(v) &&
              (q_bs | q_rs | k_bs | k_rs | v_bs | v_rs) % 8 == 0;
      return dispatch_bf16(a, bw, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
