// The segment OR kernel shared by K5 (staircase_segment.cu) and K6
// (stream_segment.cu):
//
//   words[b*rows + offs[e]] |= vals[v(e)]    for every slot e with offs[e] >= 0,
//   sums [b*rows + offs[e]] += bill[e]       b = tile_block[e / 1024],
//
// where v(e) = e for K5 and, for K6 (kWindowed), position e % 1024 of window
// window_idx[e / 1024] of a flat word stream. K6 has no bill.
//
// Design. The TPU kernels contract an (m, 1024) x (1024, rows) one-hot
// staircase on the MXU and revisit each output block in a sequential grid,
// zeroing it on the first visit. Here the wrapper zeroes the outputs and one
// block of 256 threads takes one tile in any order. Each thread loads 4
// consecutive slots with one 16-byte load per array and reduces its runs of
// equal offs (a tile is grouped by destination row, so a row's slots are
// adjacent). A run that starts and ends inside the thread is complete and is
// written with one atomic. The thread's last run is carried across the warp
// by a segmented inclusive scan (__shfl_up_sync, a new segment where the key
// changes or a lane holds several runs); the lane where that run ends writes
// it, and a lane whose first run continues the previous lane's last run takes
// the scanned prefix into it. A row split across warps or tiles gets one
// atomic per piece, so a hub (the sentinel row holds 124,066 slots over about
// 121 tiles at 1M) costs about 8 atomics a tile instead of 1,024. OR and
// integer SUM are associative and commutative, so the result is exact in any
// order; zero words and zero counts write nothing. Correct for any offs
// order: only adjacent equal keys are merged. K6's wrapper refuses a
// window outside the stream, as its plain version does.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace staircase {

constexpr int kTile = 1024;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTile == 4 * kThreads, "each thread takes 4 slots, one int4 per array");

template <bool kBilled>
__device__ __forceinline__ void flush(int key, uint32_t word, int count, int rows,
                                      int32_t* __restrict__ words, int32_t* __restrict__ sums) {
  if (key < 0 || key >= rows) return;
  if (word != 0u) atomicOr(reinterpret_cast<unsigned int*>(words + key), word);
  if (kBilled && count != 0) atomicAdd(sums + key, count);
}

template <bool kBilled, bool kWindowed>
__global__ void __launch_bounds__(kThreads)
segment_kernel(const int32_t* __restrict__ tile_block, const int32_t* __restrict__ window_idx,
               const int4* __restrict__ offs, const int4* __restrict__ vals,
               const int4* __restrict__ bill, int32_t* __restrict__ out_words,
               int32_t* __restrict__ out_sums, int rows, int n_blocks) {
  const int b = tile_block[blockIdx.x];
  if (b < 0 || b >= n_blocks) return;
  const long long v_at = kWindowed ? static_cast<long long>(window_idx[blockIdx.x])
                                   : static_cast<long long>(blockIdx.x);
  const long long base = static_cast<long long>(b) * rows;
  int32_t* words = out_words + base;
  int32_t* sums = kBilled ? out_sums + base : nullptr;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int4 o4 = offs[i];
  const int4 v4 = vals[v_at * kThreads + threadIdx.x];
  const int4 c4 = kBilled ? bill[i] : make_int4(0, 0, 0, 0);
  const int k[4] = {o4.x, o4.y, o4.z, o4.w};
  const uint32_t v[4] = {static_cast<uint32_t>(v4.x), static_cast<uint32_t>(v4.y),
                         static_cast<uint32_t>(v4.z), static_cast<uint32_t>(v4.w)};
  const int c[4] = {c4.x, c4.y, c4.z, c4.w};

  // runs inside the thread: the first (head), the last (tail), the middle
  // ones complete here
  int tail_key = k[0];
  uint32_t tail_word = v[0];
  int tail_count = c[0];
  int head_key = tail_key;
  uint32_t head_word = 0u;
  int head_count = 0;
  bool multi = false;
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    if (k[j] == tail_key) {
      tail_word |= v[j];
      tail_count += c[j];
      continue;
    }
    if (!multi) {
      head_word = tail_word;
      head_count = tail_count;
      multi = true;
    } else {
      flush<kBilled>(tail_key, tail_word, tail_count, rows, words, sums);
    }
    tail_key = k[j];
    tail_word = v[j];
    tail_count = c[j];
  }

  // segmented inclusive scan of the tail runs along the warp
  const int lane = threadIdx.x & 31;
  const int prev_tail = __shfl_up_sync(kFull, tail_key, 1);
  const int next_head = __shfl_down_sync(kFull, head_key, 1);
  bool seg = multi || lane == 0 || prev_tail != tail_key;
  uint32_t sw = tail_word;
  int sc = tail_count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t w_up = __shfl_up_sync(kFull, sw, d);
    const int c_up = __shfl_up_sync(kFull, sc, d);
    const int f_up = __shfl_up_sync(kFull, static_cast<int>(seg), d);
    if (lane >= d) {
      if (!seg) {
        sw |= w_up;
        sc += c_up;
      }
      seg = seg || f_up;
    }
  }
  const uint32_t prev_sw = __shfl_up_sync(kFull, sw, 1);
  const int prev_sc = __shfl_up_sync(kFull, sc, 1);
  if (multi) {
    if (lane > 0 && prev_tail == head_key) {
      head_word |= prev_sw;
      head_count += prev_sc;
    }
    flush<kBilled>(head_key, head_word, head_count, rows, words, sums);
  }
  if (lane == 31 || next_head != tail_key) flush<kBilled>(tail_key, sw, sc, rows, words, sums);
}

}  // namespace staircase
