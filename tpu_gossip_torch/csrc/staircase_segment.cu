// K5: staircase segment OR, with an optional segment SUM of a per-slot bill.
//
//   words[b*rows + offs[e]] |= vals[e]      for every slot e with offs[e] >= 0,
//   sums [b*rows + offs[e]] += bill[e]      b = tile_block[e / 1024].
//
// Replaces the Pallas kernel tpu_gossip/kernels/pallas_segment.py:_launch
// (_kernel / _tile_contract_accumulate): the CSR delivery of every
// staircase round (segment_or for flood, segment_sampled for push and
// push-pull, whose pull bill is the SUM plane).
//
// Bound: bytes. Each slot's offs, vals (and bill) are read once, each output
// row written once: at the 1M plan (6,016 tiles, 977 blocks of 1,024 rows)
// 6,160,384 slots x 12 B + 1,000,448 rows x 8 B, about 81.9 MB billed, 24.5 us
// at 3.35 TB/s; 53.3 MB, 15.9 us unbilled.
//
// Design: staircase_segment.cuh, shared with K6 (stream_segment.cu).

#include "staircase_segment.cuh"

extern "C" int staircase_segment(const void* tile_block, const void* offs, const void* vals,
                                 const void* bill, void* out_words, void* out_sums,
                                 long long n_tiles, int rows, int n_blocks, void* stream) {
  using staircase::kThreads;
  using staircase::segment_kernel;
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(static_cast<unsigned>(n_tiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* tb = static_cast<const int32_t*>(tile_block);
  const auto* o = static_cast<const int4*>(offs);
  const auto* v = static_cast<const int4*>(vals);
  if (bill != nullptr) {
    segment_kernel<true, false><<<grid, kThreads, 0, s>>>(
        tb, nullptr, o, v, static_cast<const int4*>(bill), static_cast<int32_t*>(out_words),
        static_cast<int32_t*>(out_sums), rows, n_blocks);
  } else {
    segment_kernel<false, false><<<grid, kThreads, 0, s>>>(
        tb, nullptr, o, v, nullptr, static_cast<int32_t*>(out_words), nullptr, rows, n_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
