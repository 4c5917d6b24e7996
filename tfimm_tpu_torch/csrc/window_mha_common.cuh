// What the window attention's Hopper bodies (window_mha.cu's forward and
// window_mha_bwd.cu's backward, bf16 on tma.py · window_route) share: the
// order in which a block walks its windows, the bias and mask it keeps
// resident in the layout of the scores, and the softmax of one 64 x 64
// score tile.
//
// A call is BW = B * nW windows of N <= 64 tokens, H heads of d <= 64
// columns; window r takes mask[r % nW]. One 64-row tile holds a window, and
// one 64-column chunk a head, so every row of scores lies in one tile and
// its sum is complete before p is rounded. Rows past N and columns past d
// arrive as zeros (TMA's fill), so every product in which a pad row or pad
// key takes part has a zero factor; only the softmax must leave the pad
// keys out, which the resident bias does by holding -inf there.
//
// The walk: a block owns one head h and a group of consecutive entries of
// the head's window list, which runs over the mask positions p = r % nW and,
// within one, over the images: entry i is window (i % B) nW + i / B, with
// B = BW / nW (nW = 1 without a mask). So a block meets a new mask position
// once every B windows, and only then loads bias[h] + mask[p] again.
//
// The layout of a warpgroup's 64 x 64 accumulator (hopper.cuh's note):
// thread t (warp t / 32 of the group, lane l) holds rows 16 (t / 32) + l / 4
// and that + 8; registers 4 j + {0, 1} are the first row at columns
// 8 j + 2 (l % 4) + {0, 1}, 4 j + {2, 3} the second row at the same columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace wtc {

constexpr int kTile = 64;                 // rows, keys and columns of a tile
constexpr int kTileBytes = kTile * kTile * 2;
constexpr int kConsumers = 2;             // warpgroups a block, on alternate windows
// A producer warpgroup (one thread issues the loads) and the consumers.
// setmaxnreg hands the producer's registers to the consumers: 384 threads
// launch at 168 registers (a quarter of the SM holds three warps), and
// 128 x 40 + 256 x 232 fit the SM's 65536.
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClampLog2 = 80.0f * kLog2e;      // dispatch.py SOFTMAX_CLAMP

// The window of entry i of a head's list (see the note at the top), and its
// mask position.
__device__ __forceinline__ int window_at(int i, int per_pos, int nb_pos,
                                         int* pos) {
  *pos = i / per_pos;
  return (i - *pos * per_pos) * nb_pos + *pos;
}

// bm = (bias + mask) log2(e) at this thread's 32 entries of the score tile
// (tid: the thread's index in its warpgroup): the bias and the mask summed
// in f32 first; -inf at keys past n (their exponential is 0), 0 at the pad
// rows' real keys. bias and mask point at the head's and the position's
// (N, N) rows; mask may be null. The warpgroup first sums them into
// `staging` (n * n f32 in shared memory, a few coalesced loads a thread),
// then each thread reads its entries: loading them straight into registers
// kept 64 loads and their addresses in flight at once, and ptxas spilled
// the backward. The named barrier `bar` (the warpgroup's 128 threads)
// orders the writes after the warpgroup's last reads of `staging` and the
// reads after the writes; the caller orders its next writes there.
__device__ __forceinline__ void load_bias(float (&bm)[32], float* staging,
                                          const float* __restrict__ bias,
                                          const float* __restrict__ mask,
                                          int n, int tid, int bar) {
  hopper::named_barrier(bar, 128);
  for (int i = tid; i < n * n; i += 128)
    staging[i] = __ldg(bias + i) + (mask == nullptr ? 0.f : __ldg(mask + i));
  hopper::named_barrier(bar, 128);
  const int row = (tid / 32) * 16 + (tid % 32) / 4, t4 = tid % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + (e & 2 ? 8 : 0), c = 8 * j + 2 * t4 + (e & 1);
      bm[4 * j + e] = c >= n ? -INFINITY
                             : r >= n ? 0.f : staging[r * n + c] * kLog2e;
    }
}

// Sum over the 4 lanes that hold one row of the tile.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The raw scores s = q k^T of this thread's 32 entries into p = e (1 /
// rowsum) in place, with e = 2^min(scale log2(e) s + bm, 80 log2(e))
// (exp(min(scale s + bias + mask, 80)) with log2(e) folded in): each row's
// sum is complete before p is formed, and p stays f32. Rows at or past n
// (lo: the thread's first row, hi: its second) give p = 0. Returns the
// entries at the clamp, bit i for register i (the backward's ds is 0
// there).
__device__ __forceinline__ uint32_t softmax_tile(float (&s)[32],
                                                 const float (&bm)[32],
                                                 float scale_log2,
                                                 bool lo_valid,
                                                 bool hi_valid) {
  uint32_t clamped = 0;
  float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float x = fmaf(s[i], scale_log2, bm[i]);
    if (x >= kClampLog2) clamped |= 1u << i;
    s[i] = hopper::exp2_approx(fminf(x, kClampLog2));
    if (i & 2) l_hi += s[i]; else l_lo += s[i];
  }
  // Every lane takes part in the shuffles. One reciprocal a row: a division
  // an entry took most of the kernel's time (its slow path on the pad rows'
  // and the masked entries' operands). A pad row's reciprocal is 0.
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  const float inv_lo = lo_valid ? 1.f / l_lo : 0.f;
  const float inv_hi = hi_valid ? 1.f / l_hi : 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] *= i & 2 ? inv_hi : inv_lo;
  return clamped;
}

// The bf16 A operand of a product with the tile's 64 keys as its depth
// (hopper.cuh's A-in-registers layout: k16 step m in registers 4 m ...).
__device__ __forceinline__ void pack_a(uint32_t (&a)[16], const float (&v)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[(j / 2) * 4 + (j % 2) * 2] = hopper::pack_bf16(v[4 * j], v[4 * j + 1]);
    a[(j / 2) * 4 + (j % 2) * 2 + 1] =
        hopper::pack_bf16(v[4 * j + 2], v[4 * j + 3]);
  }
}

// v * mul, rounded to bf16, into a 128-byte-swizzled 64 x 64 tile in the
// layout of the accumulator (the caller fences and synchronises).
__device__ __forceinline__ void write_tile(uint8_t* tile, const float (&v)[32],
                                           float mul, int tid) {
  const int row = (tid / 32) * 16 + (tid % 32) / 4, t4 = tid % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(tile + hopper::sw128_offset(row, 4 * j + t4)) =
        hopper::pack_bf16(v[4 * j] * mul, v[4 * j + 1] * mul);
    *reinterpret_cast<uint32_t*>(tile +
                                 hopper::sw128_offset(row + 8, 4 * j + t4)) =
        hopper::pack_bf16(v[4 * j + 2] * mul, v[4 * j + 3] * mul);
  }
}

// The first n rows and d columns (d a multiple of 8) of a swizzled 64 x 64
// bf16 tile to device memory at dst, ld elements between rows, 16 bytes a
// thread at a time (tid: the thread's index in its warpgroup). Plain stores:
// a TMA store would queue behind the ring's loads on the SM's TMA unit, and
// the tile could not take the next window before it ran.
__device__ __forceinline__ void store_rows(const uint8_t* tile,
                                           __nv_bfloat16* dst, int64_t ld,
                                           int n, int d, int tid) {
  const int chunks = d / 8;
  for (int i = tid; i < n * chunks; i += 128) {
    const int row = i / chunks, c = i - row * chunks;
    *reinterpret_cast<uint4*>(dst + row * ld + 8 * c) =
        *reinterpret_cast<const uint4*>(tile + row * 128 +
                                        ((c ^ (row & 7)) << 4));
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = 0.f;
}

}  // namespace wtc
