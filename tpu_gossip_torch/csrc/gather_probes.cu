// The gather and shuffle probes P1-P5: two gathers over int32 rows.
//
// lane_gather:    out[r, w] = tab[r mod T, idx[r, w]]     tab (T, W), idx (N, W)
// sublane_gather: out[r, l] = tab[base(r) + idx[r, l], l] over 128 lanes,
//                 base(r) = (r / group) * group, or 0 when group == 0
//
// Replaces the five Pallas probe kernels of experiments/:
//   P1 pallas_gather_caps.py:28 (try_shape.run, body :24-25): axis 1 is
//      lane_gather with T = N, axis 0 is sublane_gather with group 0;
//   P2 pallas_wide_lane_gather.py:30 (probe.run, body :26-27): lane_gather
//      with T = S, the table shared by all `steps` blocks of S rows;
//   P3 gather_probe.py:140 (pallas_run, body :121-132): sublane_gather with
//      group 0 from a resident (8192, 128) table;
//   P4 perm_pipeline_probe.py:69 (lane_shuffle, body :65-66): lane_gather
//      with T = N, W = 128 (K1's function, its own kernel and count);
//   P5 perm_pipeline_probe.py:97 (sub_shuffle, body :88-94): sublane_gather
//      with group 8.
//
// Bound: bytes. idx is read once and out written once (4 B an element
// each), the table read once (it is at most 4 MB at every probe shape and
// stays in the 50 MB L2). At 3.35 TB/s: P1 at 8192 rows 12,582,912 B, 3.76
// us; P2 at (8, 131072, 4) 37,748,736 B, 11.27 us; P3 52,428,800 B, 15.65
// us; P4 and P5 100,663,296 B, 30.05 us.
//
// Design: the TPU kernels held the table in VMEM for the whole grid. Here
// idx and out stream through coalesced 16-byte accesses (four elements a
// thread where W is a multiple of 4), and the table's random reads go
// through L2, where every probe's table fits: that residency is the card's
// answer to the question P2 and P3 asked of VMEM. Only the 8-row groups of
// P5 are staged in shared memory (4 KB a block, one thread an element, as
// K1 stages its rows), so each group is read from device memory once and
// its random row picks hit shared memory without bank conflicts (one warp
// reads 32 neighbouring lanes). An index outside the table is outside the
// contract, as in Mosaic: nothing clamps it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kGroup = 8;  // the staged sublane group: 8 rows x 128 lanes, 1024 threads

// Index math in 32 bits: the wrapper keeps every operand under 2^31 elements.
template <int VEC>
__global__ void lane_gather_kernel(const int32_t* __restrict__ tab, const int32_t* __restrict__ idx,
                                   int32_t* __restrict__ out, unsigned n_vec, unsigned t_rows,
                                   unsigned width) {
  const unsigned v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= n_vec) return;
  const unsigned e = v * VEC;
  const unsigned r = e / width;  // a vector never crosses a row: width % VEC == 0
  const int32_t* row = tab + (r % t_rows) * width;
  if constexpr (VEC == 4) {
    const int4 i = reinterpret_cast<const int4*>(idx)[v];
    int4 o;
    o.x = __ldg(row + i.x);
    o.y = __ldg(row + i.y);
    o.z = __ldg(row + i.z);
    o.w = __ldg(row + i.w);
    reinterpret_cast<int4*>(out)[v] = o;
  } else {
    out[e] = __ldg(row + idx[e]);
  }
}

// group 0 (the whole table) or any group but the staged one: four lanes a thread
__global__ void sublane_gather_kernel(const int32_t* __restrict__ tab, const int32_t* __restrict__ idx,
                                      int32_t* __restrict__ out, unsigned n_vec, unsigned group) {
  const unsigned v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= n_vec) return;
  const unsigned r = v / (kLanes / 4);
  const unsigned l = (v % (kLanes / 4)) * 4;
  const unsigned base = group > 0 ? (r / group) * group : 0;
  const int32_t* col = tab + base * kLanes + l;
  const int4 i = reinterpret_cast<const int4*>(idx)[v];
  int4 o;
  o.x = __ldg(col + i.x * kLanes);
  o.y = __ldg(col + i.y * kLanes + 1);
  o.z = __ldg(col + i.z * kLanes + 2);
  o.w = __ldg(col + i.w * kLanes + 3);
  reinterpret_cast<int4*>(out)[v] = o;
}

// group 8: one block stages one (8, 128) group, one thread an element
__global__ void sublane_group8_kernel(const int32_t* __restrict__ tab, const int32_t* __restrict__ idx,
                                      int32_t* __restrict__ out) {
  __shared__ int32_t tile[kGroup][kLanes];
  const int lane = threadIdx.x;
  const int sub = threadIdx.y;
  const unsigned off = (blockIdx.x * kGroup + sub) * kLanes + lane;
  tile[sub][lane] = tab[off];
  __syncthreads();
  out[off] = tile[idx[off]][lane];
}

unsigned blocks_for(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int lane_gather(const void* tab, const void* idx, void* out, long long n_rows, long long t_rows,
                           long long width, void* stream) {
  const long long n = n_rows * width;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  auto t = static_cast<const int32_t*>(tab);
  auto i = static_cast<const int32_t*>(idx);
  auto o = static_cast<int32_t*>(out);
  if (width % 4 == 0) {
    lane_gather_kernel<4><<<blocks_for(n / 4), kThreads, 0, s>>>(t, i, o, static_cast<unsigned>(n / 4),
                                                                 static_cast<unsigned>(t_rows),
                                                                 static_cast<unsigned>(width));
  } else {
    lane_gather_kernel<1><<<blocks_for(n), kThreads, 0, s>>>(t, i, o, static_cast<unsigned>(n),
                                                             static_cast<unsigned>(t_rows),
                                                             static_cast<unsigned>(width));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sublane_gather(const void* tab, const void* idx, void* out, long long n_rows, int group,
                              void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  auto t = static_cast<const int32_t*>(tab);
  auto i = static_cast<const int32_t*>(idx);
  auto o = static_cast<int32_t*>(out);
  if (group == kGroup) {
    sublane_group8_kernel<<<static_cast<unsigned>(n_rows / kGroup), dim3(kLanes, kGroup), 0, s>>>(t, i, o);
  } else {
    const long long n_vec = n_rows * kLanes / 4;
    sublane_gather_kernel<<<blocks_for(n_vec), kThreads, 0, s>>>(t, i, o, static_cast<unsigned>(n_vec),
                                                                 static_cast<unsigned>(group));
  }
  return static_cast<int>(cudaGetLastError());
}
