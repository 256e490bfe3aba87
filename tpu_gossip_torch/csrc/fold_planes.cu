// K2: the class fold, out[node_off + k] = OP over i < pad_deg of
// flat[slot_off + i*plane_stride + k*node_stride], for every row of a class
// table and every k < count, OP = OR or SUM. One launch folds a whole plan.
//
// Replaces the Pallas kernel tpu_gossip/kernels/permute.py:fold_planes
// (_fold_kernel), the reduce of every position-major degree class, and the
// XLA bitwise_or/sum reduce over the node-major classes around it
// (tpu_gossip/core/matching_topology.py:reduce_classes): the OR of the
// delivered words each round and the SUM of the realized degrees in the
// plan build. A row with pad_deg 0 (a node gap, the tail up to n_out)
// writes zeros, so the launch writes each of the n_out outputs exactly once.
//
// Bound: bytes. Each row's count*pad_deg slots are read once (a plane's
// stride padding is not part of the function) and every output is written
// once; chip_smoke.py (fold_bytes) computes it from the plan's table.
//
// Design: the TPU kernel revisits one (8, 128) output block across a
// sequential plane axis and runs once per class. Here the host builds a
// work table at plan time, one entry (row, k0, k1, kind) per block, so a
// block knows its share without a search, and all kinds share one grid
// (kernels/permute.py fold_work sizes the entries with this file's kThreads,
// kChunk and kHubDeg; an entry that does not fit traps):
//   kHub    (node-major, pad_deg >= kHubDeg; first in the table, they are the
//            longest): one node a block, 16-byte loads over its aligned
//            interior, unrolled by four, then a warp and a block combine.
//   kStaged (node-major, pad_deg < kHubDeg): the contiguous words of nodes
//            [k0, k1), at most kChunk, staged in shared memory by 16-byte
//            loads all issued before the first store, then one thread a
//            node (pad_deg < 32) or one warp a node and __reduce_*_sync.
//   kPlane  (position-major): one thread per 4 consecutive nodes, one
//            16-byte load per plane (slot_off and plane_stride are
//            1024-aligned, so every run is), accumulated in registers.
//   kZero   : zeros.
// SUM wraps modulo 2^32 like the int32 add it replaces.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4096;                 // words of a staged block
constexpr int kHubDeg = 1024;                // node-major rows from this pad_deg fold a node a block
constexpr int kStage = (kChunk + 6) / 4;     // 16-byte slots: the chunk plus alignment slack
constexpr int kStageLoads = (kStage + kThreads - 1) / kThreads;

enum Kind : int { kZero = 0, kPlane = 1, kStaged = 2, kHub = 3 };

template <bool kOr>
__device__ __forceinline__ uint32_t op(uint32_t a, uint32_t b) { return kOr ? (a | b) : (a + b); }

template <bool kOr>
__device__ __forceinline__ uint4 op4(uint4 a, uint4 b) {
  return make_uint4(op<kOr>(a.x, b.x), op<kOr>(a.y, b.y), op<kOr>(a.z, b.z), op<kOr>(a.w, b.w));
}

template <bool kOr>
__device__ __forceinline__ uint32_t fold4(uint4 a) { return op<kOr>(op<kOr>(a.x, a.y), op<kOr>(a.z, a.w)); }

template <bool kOr>
__device__ __forceinline__ uint32_t warp_fold(uint32_t v) {
  return kOr ? __reduce_or_sync(0xffffffffu, v) : __reduce_add_sync(0xffffffffu, v);
}

struct Row {
  long long node_off, slot_off, count, pad_deg, plane_stride, node_stride;
};

// position-major: nodes k0 + 4t .. k0 + 4t + 3 of the row (k1 - k0 <= 1024)
template <bool kOr>
__device__ void fold_plane(const uint32_t* __restrict__ flat, uint32_t* __restrict__ o, const Row& r, int k0,
                           int k1) {
  if (k1 - k0 > 4 * kThreads) __trap();
  const int k = k0 + 4 * static_cast<int>(threadIdx.x);
  if (k >= k1) return;
  // k + 3 < the plane stride, a multiple of 1024 past count: the load stays in the class
  const uint4* p = reinterpret_cast<const uint4*>(flat + r.slot_off + k);
  const long long step = r.plane_stride / 4;
  const int pd = static_cast<int>(r.pad_deg);
  uint4 acc = __ldg(p);
  int i = 1;
  for (; i + 3 < pd; i += 4) {
    const uint4 a = __ldg(p + i * step), b = __ldg(p + (i + 1) * step);
    const uint4 c = __ldg(p + (i + 2) * step), d = __ldg(p + (i + 3) * step);
    acc = op4<kOr>(acc, op4<kOr>(op4<kOr>(a, b), op4<kOr>(c, d)));
  }
  for (; i < pd; ++i) acc = op4<kOr>(acc, __ldg(p + i * step));
  uint32_t* dst = o + r.node_off + k;
  if (k + 4 <= k1 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = acc;
    return;
  }
  const uint32_t v[4] = {acc.x, acc.y, acc.z, acc.w};
  for (int j = 0; j < 4 && k + j < k1; ++j) dst[j] = v[j];
}

// node-major, pad_deg < kHubDeg: nodes [k0, k1), (k1 - k0) * pad_deg <= kChunk words
template <bool kOr>
__device__ void fold_staged(const uint32_t* __restrict__ flat, uint32_t* __restrict__ o, const Row& r, int k0,
                            int k1, uint4* stage) {
  const int pd = static_cast<int>(r.pad_deg);
  const long long a = r.slot_off + static_cast<long long>(k0) * pd;
  const long long a0 = a & ~3LL;  // the slot buffer starts 16-byte aligned and holds whole 16-byte runs
  const int n4 = static_cast<int>((a + static_cast<long long>(k1 - k0) * pd - a0 + 3) >> 2);
  if (n4 > kStage) __trap();
  const uint4* src = reinterpret_cast<const uint4*>(flat + a0);
  uint4 v[kStageLoads];
#pragma unroll
  for (int j = 0; j < kStageLoads; ++j) {
    const int q = static_cast<int>(threadIdx.x) + j * kThreads;
    if (q < n4) v[j] = __ldg(src + q);
  }
#pragma unroll
  for (int j = 0; j < kStageLoads; ++j) {
    const int q = static_cast<int>(threadIdx.x) + j * kThreads;
    if (q < n4) stage[q] = v[j];
  }
  __syncthreads();
  const uint32_t* words = reinterpret_cast<const uint32_t*>(stage) + (a - a0);
  uint32_t* dst = o + r.node_off + k0;
  const int nodes = k1 - k0;
  if (pd < 32) {
    for (int j = threadIdx.x; j < nodes; j += kThreads) {
      const uint32_t* w = words + j * pd;
      uint32_t acc = w[0];
      for (int i = 1; i < pd; ++i) acc = op<kOr>(acc, w[i]);
      dst[j] = acc;
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < nodes; j += kWarps) {  // warp-uniform: every lane folds
    const uint32_t* w = words + j * pd;
    uint32_t acc = 0;
    for (int i = lane; i < pd; i += 32) acc = op<kOr>(acc, w[i]);
    acc = warp_fold<kOr>(acc);
    if (lane == 0) dst[j] = acc;
  }
}

// node-major, pad_deg >= kHubDeg: node k0 alone
template <bool kOr>
__device__ void fold_hub(const uint32_t* __restrict__ flat, uint32_t* __restrict__ o, const Row& r, int k0,
                         uint32_t* part) {
  if (r.pad_deg < kHubDeg) __trap();
  const long long a = r.slot_off + static_cast<long long>(k0) * r.pad_deg;
  const long long b = a + r.pad_deg;
  const long long a4 = (a + 3) & ~3LL, b4 = b & ~3LL;  // a4 < b4: pad_deg >= kHubDeg
  const int t = threadIdx.x;
  uint32_t acc = 0;
  if (t < a4 - a) acc = flat[a + t];
  if (t < b - b4) acc = op<kOr>(acc, flat[b4 + t]);
  const uint4* p = reinterpret_cast<const uint4*>(flat + a4);
  const int n4 = static_cast<int>((b4 - a4) >> 2);
  uint4 acc4 = make_uint4(0u, 0u, 0u, 0u);
  int q = t;
  for (; q + 3 * kThreads < n4; q += 4 * kThreads) {
    const uint4 w0 = __ldg(p + q), w1 = __ldg(p + q + kThreads);
    const uint4 w2 = __ldg(p + q + 2 * kThreads), w3 = __ldg(p + q + 3 * kThreads);
    acc4 = op4<kOr>(acc4, op4<kOr>(op4<kOr>(w0, w1), op4<kOr>(w2, w3)));
  }
  for (; q < n4; q += kThreads) acc4 = op4<kOr>(acc4, __ldg(p + q));
  acc = warp_fold<kOr>(op<kOr>(acc, fold4<kOr>(acc4)));
  if ((t & 31) == 0) part[t >> 5] = acc;
  __syncthreads();
  if (t < 32) {
    acc = warp_fold<kOr>(t < kWarps ? part[t] : 0u);
    if (t == 0) o[r.node_off + k0] = acc;
  }
}

template <bool kOr>
__global__ void __launch_bounds__(kThreads) fold_classes_kernel(const int32_t* __restrict__ flat_words,
                                                                 int32_t* __restrict__ out,
                                                                 const long long* __restrict__ table,
                                                                 const int32_t* __restrict__ work) {
  __shared__ uint4 stage[kStage];
  const int32_t* w = work + 4 * static_cast<long long>(blockIdx.x);
  const int kind = w[3], k0 = w[1], k1 = w[2];
  const long long* t = table + 6 * static_cast<long long>(w[0]);
  const Row r{t[0], t[1], t[2], t[3], t[4], t[5]};
  const uint32_t* flat = reinterpret_cast<const uint32_t*>(flat_words);
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
  switch (kind) {
    case kPlane:
      fold_plane<kOr>(flat, o, r, k0, k1);
      break;
    case kStaged:
      fold_staged<kOr>(flat, o, r, k0, k1, stage);
      break;
    case kHub:
      fold_hub<kOr>(flat, o, r, k0, reinterpret_cast<uint32_t*>(stage));
      break;
    default:
      for (int k = k0 + static_cast<int>(threadIdx.x); k < k1; k += kThreads) o[r.node_off + k] = 0u;
  }
}

template <bool kOr>
int launch(const void* flat, void* out, const void* table, const void* work, long long n_work, void* stream) {
  if (n_work <= 0) return static_cast<int>(cudaGetLastError());
  fold_classes_kernel<kOr><<<static_cast<unsigned>(n_work), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(flat), static_cast<int32_t*>(out), static_cast<const long long*>(table),
      static_cast<const int32_t*>(work));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fold_planes_or(const void* flat, void* out, const void* table, const void* work, long long n_work,
                              void* stream) {
  return launch<true>(flat, out, table, work, n_work, stream);
}

extern "C" int fold_planes_sum(const void* flat, void* out, const void* table, const void* work, long long n_work,
                               void* stream) {
  return launch<false>(flat, out, table, work, n_work, stream);
}
