// K1: per-row 128-lane shuffle, out[r, l] = x[r, idx[r, l]], with the
// matching pipeline's transposes folded in.
//
// Replaces the Pallas kernel tpu_gossip/kernels/permute.py:lane_shuffle
// (_shuffle_call / _shuffle_kernel), the pass every MatchingPlan.partner
// pipeline is built from (2K+1 launches per pass, K transpose stages). Three
// entries share one kernel:
//   lane_shuffle       out[r, l]          = x[r, idx[r, l]]
//   lane_shuffle_t     out_flat[l*R + r]  = x[r, idx[r, l]]
//                      (transpose_pass(lane_shuffle(x, idx)))
//   tinv_lane_shuffle  out[r, l]          = x_flat[idx[r, l]*R + r]
//                      (lane_shuffle(untranspose_pass(x), idx))
// so a pipeline's ("lane", t), ("t",) and ("tinv",), ("lane", t) pairs each
// run as one launch, and a pass moves no data through a separate transpose.
//
// Bound: bytes. Each launch reads x (4 B/slot) and idx (1 or 4 B/slot) once
// and writes out (4 B/slot) once, whichever entry; at the 1M headline plan
// (R = 43,424 rows, int8 tables) that is 22.2 + 5.6 + 22.2 MB, about 15 us
// at 3.35 TB/s. The fused entries have exactly that bound: the transpose
// they absorb costs no bytes of its own.
//
// Design: a block of 256 threads owns a tile of 32 rows (16 KB of x and
// 4 KB of int8 idx, or 16 KB of int32 idx). It stages both in shared memory
// with 16-byte loads, every load of a thread issued before the first
// store, so a block keeps its whole tile in flight and several blocks fit
// on an SM. The random lane picks then hit shared memory. Row-major
// entries read and write rows with 16-byte accesses; the transposed side
// of the fused entries moves, for each lane l, the tile's rows as one run
// of 32 words at l*R + r0 (128 aligned bytes when R % 32 == 0), four rows a
// 16-byte access. Reading or writing a tile column would conflict 32 ways
// on the banks, so the 16-byte chunk q of tile row r is stored at chunk
// q ^ ((r >> 2) & 7): the eight row groups a warp touches in one column
// step land on eight distinct chunks, and row accesses stay conflict-free.
// A ragged last tile (R % 32 != 0, only on small int32 plans; R % 8 == 0)
// is masked in groups of four rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 32;     // rows a tile
constexpr int kThreads = 256;
constexpr int kChunks = 32;   // 16-byte chunks of an x row
constexpr int kVecs = kRows * kChunks / kThreads;  // 16-byte vectors of x a thread moves: 4

enum Mode { kPlain = 0, kOutT = 1, kInT = 2 };

__device__ __forceinline__ int swz(int r) { return (r >> 2) & 7; }

// word of tile element (r, l) in a swizzled tile of 4-byte elements
__device__ __forceinline__ int xword(int r, int l) {
  return r * kLanes + (((l >> 2) ^ swz(r)) << 2) + (l & 3);
}

template <typename IdxT>
struct IdxTile {
  static constexpr int kPer = 16 / sizeof(IdxT);       // lanes a 16-byte chunk
  static constexpr int kRowChunks = kLanes / kPer;     // chunks a row: 8 or 32
  static constexpr int kLoads = kRows * kRowChunks / kThreads;  // 1 or 4 a thread

  // element offset of (r, l)
  __device__ static __forceinline__ int at(int r, int l) {
    return r * kLanes + (((l / kPer) ^ swz(r)) * kPer) + (l % kPer);
  }
};

// the source lanes of lanes l0..l0+3 of tile row r (l0 % 4 == 0): one word
// of int8 lanes or one 16-byte chunk of int32 lanes
__device__ __forceinline__ int4 four_src(const int8_t* tile, int r, int l0) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(tile + IdxTile<int8_t>::at(r, l0));
  return make_int4(w & 127, (w >> 8) & 127, (w >> 16) & 127, (w >> 24) & 127);
}

__device__ __forceinline__ int4 four_src(const int32_t* tile, int r, int l0) {
  const int4 v = *reinterpret_cast<const int4*>(tile + IdxTile<int32_t>::at(r, l0));
  return make_int4(v.x & 127, v.y & 127, v.z & 127, v.w & 127);
}

template <typename IdxT, int kMode>
__global__ void __launch_bounds__(kThreads) lane_shuffle_kernel(const int32_t* __restrict__ x,
                                                                const IdxT* __restrict__ idx,
                                                                int32_t* __restrict__ out,
                                                                long long rows) {
  using Tile = IdxTile<IdxT>;
  __shared__ int4 xs[kRows * kChunks];
  __shared__ int4 is[kRows * Tile::kRowChunks];
  int32_t* xw = reinterpret_cast<int32_t*>(xs);
  const IdxT* iw = reinterpret_cast<const IdxT*>(is);
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const int live = static_cast<int>(rows - r0 < kRows ? rows - r0 : kRows);
  const int t = threadIdx.x;

  // stage: every 16-byte load issued, then stored to shared memory
  int4 xv[kVecs];
  int4 iv[Tile::kLoads];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = t + i * kThreads;
    if (kMode == kInT) {  // lane v >> 3, rows 4g..4g+3 of the column slab
      const int g = v & 7;
      if (4 * g < live) xv[i] = __ldg(reinterpret_cast<const int4*>(x + (v >> 3) * rows + r0 + 4 * g));
    } else {  // row v >> 5, chunk v & 31
      if ((v >> 5) < live) xv[i] = __ldg(reinterpret_cast<const int4*>(x + (r0 + (v >> 5)) * kLanes) + (v & 31));
    }
  }
#pragma unroll
  for (int i = 0; i < Tile::kLoads; ++i) {
    const int v = t + i * kThreads;
    if (v / Tile::kRowChunks < live)
      iv[i] = __ldg(reinterpret_cast<const int4*>(idx + r0 * kLanes) + v);
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = t + i * kThreads;
    if (kMode == kInT) {
      const int l = v >> 3, r = 4 * (v & 7);
      if (r < live) {
        xw[xword(r, l)] = xv[i].x;
        xw[xword(r + 1, l)] = xv[i].y;
        xw[xword(r + 2, l)] = xv[i].z;
        xw[xword(r + 3, l)] = xv[i].w;
      }
    } else {
      const int r = v >> 5;
      if (r < live) xs[r * kChunks + ((v & 31) ^ swz(r))] = xv[i];
    }
  }
#pragma unroll
  for (int i = 0; i < Tile::kLoads; ++i) {
    const int v = t + i * kThreads;
    const int r = v / Tile::kRowChunks;
    if (r < live) is[r * Tile::kRowChunks + ((v % Tile::kRowChunks) ^ swz(r))] = iv[i];
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = t + i * kThreads;
    if (kMode == kOutT) {  // lane l, rows 4g..4g+3 -> out_flat[l*R + r0 + 4g]
      const int l = v >> 3, r = 4 * (v & 7);
      if (r < live) {
        int4 o;
        o.x = xw[xword(r, static_cast<int>(iw[Tile::at(r, l)]) & 127)];
        o.y = xw[xword(r + 1, static_cast<int>(iw[Tile::at(r + 1, l)]) & 127)];
        o.z = xw[xword(r + 2, static_cast<int>(iw[Tile::at(r + 2, l)]) & 127)];
        o.w = xw[xword(r + 3, static_cast<int>(iw[Tile::at(r + 3, l)]) & 127)];
        *reinterpret_cast<int4*>(out + l * rows + r0 + r) = o;
      }
    } else {  // row r, lanes 4c..4c+3
      const int r = v >> 5, l0 = 4 * (v & 31);
      if (r < live) {
        const int4 s = four_src(reinterpret_cast<const IdxT*>(is), r, l0);
        int4 o;
        o.x = xw[xword(r, s.x)];
        o.y = xw[xword(r, s.y)];
        o.z = xw[xword(r, s.z)];
        o.w = xw[xword(r, s.w)];
        reinterpret_cast<int4*>(out + (r0 + r) * kLanes)[v & 31] = o;
      }
    }
  }
}

template <typename IdxT, int kMode>
int launch(const void* x, const void* idx, void* out, long long rows, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned grid = static_cast<unsigned>((rows + kRows - 1) / kRows);
  lane_shuffle_kernel<IdxT, kMode><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const IdxT*>(idx), static_cast<int32_t*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lane_shuffle_i8(const void* x, const void* idx, void* out, long long rows, void* stream) {
  return launch<int8_t, kPlain>(x, idx, out, rows, stream);
}

extern "C" int lane_shuffle_i32(const void* x, const void* idx, void* out, long long rows, void* stream) {
  return launch<int32_t, kPlain>(x, idx, out, rows, stream);
}

extern "C" int lane_shuffle_t_i8(const void* x, const void* idx, void* out, long long rows, void* stream) {
  return launch<int8_t, kOutT>(x, idx, out, rows, stream);
}

extern "C" int lane_shuffle_t_i32(const void* x, const void* idx, void* out, long long rows, void* stream) {
  return launch<int32_t, kOutT>(x, idx, out, rows, stream);
}

extern "C" int tinv_lane_shuffle_i8(const void* x, const void* idx, void* out, long long rows, void* stream) {
  return launch<int8_t, kInT>(x, idx, out, rows, stream);
}

extern "C" int tinv_lane_shuffle_i32(const void* x, const void* idx, void* out, long long rows, void* stream) {
  return launch<int32_t, kInT>(x, idx, out, rows, stream);
}
