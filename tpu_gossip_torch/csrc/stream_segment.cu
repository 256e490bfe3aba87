// K6: the streaming segment OR, the windowed form of K5.
//
//   words[b*rows + offs[t*1024 + j]] |= vals[window_idx[t]*1024 + j]
//       for every tile t, position j with offs >= 0,  b = tile_block[t].
//
// Replaces the Pallas kernel tpu_gossip/kernels/pallas_segment.py:
// stream_segment_or (_stream_kernel): the receive of the bucketed sharded
// engine (tpu_gossip/dist/mesh.py _exchange). Each destination shard's
// exchange result is S destination-sorted runs padded to whole 1024-word
// windows; tile t streams its words straight from window window_idx[t] of
// that flat result (no per-edge gather), and offs, indexed by the tile,
// masks every window position outside the tile's (block, run) segment with
// -1. A window shared by two output blocks is read by two tiles.
//
// Bound: bytes. Each tile's offs is read once (4 B a slot), each distinct
// window of the stream once (4 B a word; a window two tiles share counts
// once) and each output row written once (4 B): at the 1M one-shard plan
// (6,336 tiles, at most 5,332 windows, 977 blocks of 1,024 rows) at most
// about 51.8 MB, 15.5 us at 3.35 TB/s; chip_smoke.py counts the windows
// the plan it times reads.
//
// Design: K5's kernel (staircase_segment.cuh) with kWindowed set, which
// changes only the address of the vals load, and no bill.

#include "staircase_segment.cuh"

extern "C" int stream_segment(const void* tile_block, const void* window_idx, const void* offs,
                              const void* vals, void* out_words, long long n_tiles, int rows, int n_blocks,
                              void* stream) {
  using staircase::kThreads;
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  staircase::segment_kernel<false, true><<<dim3(static_cast<unsigned>(n_tiles)), kThreads, 0,
                                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tile_block), static_cast<const int32_t*>(window_idx),
      static_cast<const int4*>(offs), static_cast<const int4*>(vals), nullptr,
      static_cast<int32_t*>(out_words), nullptr, rows, n_blocks);
  return static_cast<int>(cudaGetLastError());
}
