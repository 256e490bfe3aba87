// K1: per-row 128-lane shuffle, out[r, l] = x[r, idx[r, l]].
//
// Replaces the Pallas kernel tpu_gossip/kernels/permute.py:lane_shuffle
// (_shuffle_call / _shuffle_kernel), the pass every MatchingPlan.partner
// pipeline is built from (2K+1 launches per pass, K transpose stages).
//
// Bound: bytes. Each launch reads x (4 B/slot) and idx (1 or 4 B/slot) once
// and writes out (4 B/slot) once and does no arithmetic worth counting; at
// the 1M headline plan (R = 43,424 rows, int8 tables) that is 22.2 + 5.6 +
// 22.2 MB, about 15 us at 3.35 TB/s.
//
// Design: the TPU kernel relied on the vreg-local lane gather over (2048,
// 128) blocks. Here a block stages ROWS whole rows (512 B each) in shared
// memory with coalesced loads, one thread per output lane, and each thread
// then reads its source lane from shared memory and writes its output lane
// coalesced. Global traffic is exactly one read of x and idx and one write of
// out; the random access stays inside shared memory. There is no 2048-row
// block split: the grid covers every row, with the ragged last block masked.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 8;  // rows per block: 1024 threads, 4 KB of shared memory

template <typename IdxT>
__global__ void lane_shuffle_kernel(const int32_t* __restrict__ x,
                                    const IdxT* __restrict__ idx,
                                    int32_t* __restrict__ out,
                                    long long rows) {
  __shared__ int32_t tile[kRows][kLanes];
  const int lane = threadIdx.x;
  const int sub = threadIdx.y;
  const long long r = static_cast<long long>(blockIdx.x) * kRows + sub;
  const bool live = r < rows;
  const long long off = r * kLanes + lane;
  if (live) tile[sub][lane] = x[off];
  __syncthreads();
  if (live) {
    const int src = static_cast<int>(idx[off]) & (kLanes - 1);
    out[off] = tile[sub][src];
  }
}

template <typename IdxT>
int launch(const void* x, const void* idx, void* out, long long rows,
           void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 block(kLanes, kRows);
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows));
  lane_shuffle_kernel<IdxT><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const IdxT*>(idx),
      static_cast<int32_t*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lane_shuffle_i8(const void* x, const void* idx, void* out,
                               long long rows, void* stream) {
  return launch<int8_t>(x, idx, out, rows, stream);
}

extern "C" int lane_shuffle_i32(const void* x, const void* idx, void* out,
                                long long rows, void* stream) {
  return launch<int32_t>(x, idx, out, rows, stream);
}
