// The gather and shuffle probes P1-P5: two gathers over int32 rows.
//
// lane_gather:    out[r, w] = tab[r mod T, idx[r, w]]     tab (T, W), idx (N, W)
// sublane_gather: out[r, l] = tab[base(r) + idx[r, l], l] over 128 lanes,
//                 base(r) = (r / group) * group, or 0 when group == 0
//
// Replaces the five Pallas probe kernels of experiments/:
//   P1 pallas_gather_caps.py:29 (try_shape.run, body :24-25): axis 1 is
//      lane_gather with T = N, axis 0 is sublane_gather with group 0;
//   P2 pallas_wide_lane_gather.py:31 (probe.run, body :26-27): lane_gather
//      with T = S, the table shared by all `steps` blocks of S rows;
//   P3 gather_probe.py:141 (pallas_run, body :121-132): sublane_gather with
//      group 0 from a resident (8192, 128) table;
//   P4 perm_pipeline_probe.py:70 (lane_shuffle, body :65-66): lane_gather
//      with T = N, W = 128 (K1's function, its own kernel and count);
//   P5 perm_pipeline_probe.py:98 (sub_shuffle, body :88-94): sublane_gather
//      with group 8.
//
// Bound: bytes. idx is read once and out written once (4 B an element
// each), the table read once. At 3.35 TB/s: P1 at 8192 rows 12,582,912 B,
// 3.76 us; P2 at (8, 131072, 4) 37,748,736 B, 11.27 us; P3 52,428,800 B,
// 15.65 us; P4 and P5 100,663,296 B, 30.05 us.
//
// Design. A random 4-byte read from L2 costs a whole 32-byte sector request,
// and the card's L2 serves about 136 G of them a second (random reads by 132
// SMs; ~1.95 G an SM up to 66 SMs), whatever the bytes. A gather whose table
// sits in L2 is bound by that rate, not by device memory. The TPU kernels
// held the table in VMEM; the staged routes hold it in shared memory, where
// 32 random reads of a warp cost a few bank cycles (~2.4 T a second):
//
// - lane_gather with T < N and W >= 8192 (P2), lane_gather_staged: table
//   row s (W words) serves the idx rows j*T + s. A block of 1024 threads stages the first
//   min(W, 57,344) words (224 KB) of its row with 16-byte loads, then
//   streams `per` positions of those rows, idx and out by coalesced 16-byte
//   accesses, about 128 blocks in all. A lookup past the staged words (rows
//   of 256 and 512 KB) reads the row through L2. Distributed shared memory
//   was measured as the other home for such a row and lost: random 4-byte
//   reads of a cluster's blocks ran at 158 G/s with 2 blocks and 56 G/s with
//   4, against 2,440 G/s within a block.
// - sublane_gather group 0 with at most 8192 table rows and at least two idx
//   rows a table row (P3), sublane_slab: a block stages one 4-lane column
//   slab of the table (16 B a row, 128 KB at 8192 rows) and walks a range of
//   idx rows. A slab's lanes are 16 bytes of each 512-byte row, so every
//   access to the table, idx and out is one 16-byte piece a row: a request
//   each. The tensor memory accelerator makes those requests (boxes of 4
//   lanes x 256 rows), faster than the load/store units did. Row i's four
//   words are rotated by (i >> 3) & 3 in the slab, so the lookups of one
//   lane by 32 threads fall on all 32 banks, not 8.
//
// The other shapes keep the L2 route: lane_gather with T = N (P1 axis 1, P4:
// each table row serves one idx row, so staging it gains nothing), W not a
// multiple of 4, or rows under 32 KB (P2's 4 KB rows ran faster on it); sublane_gather group 0 with larger tables or with fewer
// than two idx rows a table row (P1 axis 0: staging the slabs would cost as
// many L2 requests as the gather), and group > 0. P5's 8-row groups are
// staged in shared memory (4 KB a block, one thread an element, as K1 stages
// its rows). An index outside the table is outside the contract, as in
// Mosaic: nothing clamps it. On the L2 route it reads whatever lies there;
// on a staged route it reads outside the block's shared memory and may trap
// the kernel.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;  // the L2 route
constexpr int kGroup = 8;  // the staged sublane group: 8 rows x 128 lanes, 1024 threads
constexpr int kStageThreads = 1024;  // the staged routes: one block an SM
constexpr int kStageBytes = 229376;  // a block's staged table slice: 224 KB of the SM's 227
constexpr int kStageWords = kStageBytes / 4;
constexpr int kSlabLanes = 4;  // the sublane slab: 4 lanes, 16 B a table row
constexpr int kSlabs = kLanes / kSlabLanes;
constexpr int kSlabRows = 8192;  // the slab route's largest table: 128 KB a slab
constexpr unsigned kBoxRows = 256;  // a TMA box: 4 lanes x 256 rows, 4 KB
constexpr unsigned kBoxBytes = kBoxRows * kSlabLanes * 4;
constexpr unsigned kStepRows = kStageThreads;  // idx rows a slab step: one a thread, 4 boxes
constexpr int kUnroll = 4;  // 16-byte loads a thread keeps in flight

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

// Block b serves table row s = b / blocks_per_row: it stages the first
// min(width, kStageWords) words of the row, then gathers the positions
// [part * per, part * per + per) of the row's uses, position p being element
// p mod width of idx row (p / width) * t_rows + s. With kPartial, a lookup
// past the staged words reads the row through L2.
template <bool kPartial>
__global__ void __launch_bounds__(kStageThreads, 1)
    lane_gather_staged_kernel(const int32_t* __restrict__ tab, const int4* __restrict__ idx,
                              int4* __restrict__ out, unsigned t_rows, unsigned width, unsigned uses,
                              unsigned per, unsigned blocks_per_row) {
  extern __shared__ int4 stage4[];
  const int32_t* stage = reinterpret_cast<const int32_t*>(stage4);
  const unsigned s = blockIdx.x / blocks_per_row;
  const unsigned part = blockIdx.x % blocks_per_row;
  const int32_t* row = tab + s * width;
  const unsigned n4 = min(width, static_cast<unsigned>(kStageWords)) / 4;
  for (unsigned v0 = threadIdx.x; v0 < n4; v0 += kStageThreads * kUnroll) {
    int4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned v = v0 + u * kStageThreads;
      if (v < n4) r[u] = __ldg(reinterpret_cast<const int4*>(row) + v);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned v = v0 + u * kStageThreads;
      if (v < n4) stage4[v] = r[u];
    }
  }
  __syncthreads();
  auto look = [&](int i) -> int32_t {
    if constexpr (kPartial) {
      return static_cast<unsigned>(i) < kStageWords ? stage[i] : __ldg(row + i);
    } else {
      return stage[i];
    }
  };
  const unsigned begin = part * per;
  const unsigned end = min(begin + per, uses);
  for (unsigned p0 = begin + threadIdx.x * 4; p0 < end; p0 += kStageThreads * 4 * kUnroll) {
    int4 ix[kUnroll];
    unsigned at[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned p = p0 + u * kStageThreads * 4;
      if (p < end) {
        const unsigned j = p / width;
        at[u] = ((j * t_rows + s) * width + (p - j * width)) / 4;
        ix[u] = idx[at[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p0 + u * kStageThreads * 4 < end) {
        int4 o;
        o.x = look(ix[u].x);
        o.y = look(ix[u].y);
        o.z = look(ix[u].z);
        o.w = look(ix[u].w);
        out[at[u]] = o;
      }
    }
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

// The slab's word of table row i, lane k (both in range): row i's four
// words are rotated by (i >> 3) & 3.
__device__ __forceinline__ unsigned slab_word(unsigned i, unsigned k) { return 4 * i + (k ^ ((i >> 3) & 3)); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait for phase `parity` of `bar` to complete; traps after about a second
// of spinning, so a lost transfer ends the kernel with an error, not a hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (unsigned spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1u << 22)) __trap();
  }
}

// One box of 4 lanes x kBoxRows rows at (lane, row) of `map` into shared memory.
__device__ __forceinline__ void box_load(void* dst, const CUtensorMap* map, uint64_t* bar, int lane, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(
          smem_addr(dst)),
      "l"(map), "r"(smem_addr(bar)), "r"(lane), "r"(row)
      : "memory");
}

__device__ __forceinline__ void box_store(const CUtensorMap* map, const void* src, int lane, int row) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(map),
               "r"(smem_addr(src)), "r"(lane), "r"(row)
               : "memory");
}

// Block b stages lanes [4 * (b % kSlabs), +4) of every table row and gathers
// those lanes of idx rows [(b / kSlabs) * rows_per, +rows_per), rows_per a
// multiple of kStepRows. The table slab and idx arrive, and out leaves, by
// the tensor memory accelerator in boxes of 4 lanes x kBoxRows rows (a
// step's out goes as 4 box stores); thread t looks up row t of a step. Rows
// past the tensor's end load as zeros and are not stored.
__global__ void __launch_bounds__(kStageThreads, 1)
    sublane_slab_kernel(const __grid_constant__ CUtensorMap tab_map, const __grid_constant__ CUtensorMap idx_map,
                        const __grid_constant__ CUtensorMap out_map, unsigned t_rows, unsigned n_rows,
                        unsigned rows_per) {
  extern __shared__ int4 smem[];
  const unsigned slab_rows = (t_rows + kBoxRows - 1) / kBoxRows * kBoxRows;
  int4* slab4 = smem;                         // [slab_rows]: lanes 4s..4s+3 of each table row
  int4* idx_ring = smem + slab_rows;          // [2][kStepRows]
  int4* out_ring = idx_ring + 2 * kStepRows;  // [2][kStepRows]
  uint64_t* bars = reinterpret_cast<uint64_t*>(out_ring + 2 * kStepRows);  // stage, full[2]
  const int lane = static_cast<int>(blockIdx.x % kSlabs) * kSlabLanes;
  const unsigned r0 = blockIdx.x / kSlabs * rows_per;
  const unsigned r1 = min(r0 + rows_per, n_rows);
  const unsigned steps = (r1 - r0 + kStepRows - 1) / kStepRows;
  auto load_step = [&](unsigned j) {  // one thread: the boxes of step j inside the rows
    const unsigned row = r0 + j * kStepRows;
    const unsigned boxes = (min(kStepRows, r1 - row) + kBoxRows - 1) / kBoxRows;
    mbar_expect(&bars[1 + (j & 1)], boxes * kBoxBytes);
    for (unsigned m = 0; m < boxes; ++m)
      box_load(idx_ring + (j & 1) * kStepRows + m * kBoxRows, &idx_map, &bars[1 + (j & 1)], lane, row + m * kBoxRows);
  };
  if (threadIdx.x == 0) {
    for (int k = 0; k < 3; ++k) mbar_init(&bars[k]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(&bars[0], slab_rows / kBoxRows * kBoxBytes);
    for (unsigned i = 0; i < slab_rows; i += kBoxRows) box_load(slab4 + i, &tab_map, &bars[0], lane, i);
    for (unsigned j = 0; j < 2 && j < steps; ++j) load_step(j);
  }
  __syncthreads();
  mbar_wait(&bars[0], 0);
  for (unsigned i = threadIdx.x; i < t_rows; i += kStageThreads) {  // rotate row i's words by (i >> 3) & 3
    int4 v = slab4[i];
    const unsigned sw = (i >> 3) & 3;
    if (sw & 1) v = make_int4(v.y, v.x, v.w, v.z);
    if (sw & 2) v = make_int4(v.z, v.w, v.x, v.y);
    slab4[i] = v;
  }
  __syncthreads();
  const int32_t* slab = reinterpret_cast<const int32_t*>(slab4);
  for (unsigned j = 0; j < steps; ++j) {
    const unsigned b = j & 1;
    const unsigned live = min(kStepRows, r1 - r0 - j * kStepRows);  // rows of the step, a box loaded for each
    mbar_wait(&bars[1 + b], (j >> 1) & 1);
    if (threadIdx.x < (live + kBoxRows - 1) / kBoxRows * kBoxRows) {
      const int4 ix = idx_ring[b * kStepRows + threadIdx.x];
      int4 o;
      o.x = slab[slab_word(ix.x, 0)];
      o.y = slab[slab_word(ix.y, 1)];
      o.z = slab[slab_word(ix.z, 2)];
      o.w = slab[slab_word(ix.w, 3)];
      out_ring[b * kStepRows + threadIdx.x] = o;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the box stores read it through the TMA
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned row = r0 + j * kStepRows;
      for (unsigned m = 0; m * kBoxRows < live; ++m)
        box_store(&out_map, out_ring + b * kStepRows + m * kBoxRows, lane, row + m * kBoxRows);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      if (j + 2 < steps) load_step(j + 2);  // every thread has read this idx buffer
      // out buffer b is written again at step j + 2, after the next step's barrier
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
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

// A tensor map of an int32 (rows, 128) tensor in boxes of 4 lanes x
// kBoxRows rows; cuTensorMapEncodeTiled is looked up once, at first use.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

int lane_boxes(CUtensorMap* map, const void* base, long long rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kLanes), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {kLanes * 4};
  const cuuint32_t box[2] = {kSlabLanes, kBoxRows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<void*>(base), dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

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

// lane_gather with the table staged (T < N, W % 4 == 0): each block gathers
// `per` positions of a table row's uses, `blocks_per_row` blocks a table
// row. The wrapper picks the geometry (kernels/probes.py, lane_plan); one
// that does not cover the uses returns cudaErrorInvalidValue.
extern "C" int lane_gather_staged(const void* tab, const void* idx, void* out, long long n_rows, long long t_rows,
                                  long long width, long long per, long long blocks_per_row, void* stream) {
  const long long uses = n_rows / t_rows * width;
  if (width % 4 || per <= 0 || per % 4 || blocks_per_row <= 0 || n_rows % t_rows || per * blocks_per_row < uses ||
      t_rows * blocks_per_row > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (uses <= 0) return static_cast<int>(cudaGetLastError());
  const bool partial = width > kStageWords;
  auto kernel = partial ? lane_gather_staged_kernel<true> : lane_gather_staged_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(t_rows * blocks_per_row), kStageThreads,
           static_cast<size_t>(partial ? kStageWords : width) * 4, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tab), static_cast<const int4*>(idx), static_cast<int4*>(out),
      static_cast<unsigned>(t_rows), static_cast<unsigned>(width), static_cast<unsigned>(uses),
      static_cast<unsigned>(per), static_cast<unsigned>(blocks_per_row));
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

// sublane_gather group 0 with the table staged in 4-lane slabs (at most
// kSlabRows table rows): one block a slab and `rows_per` idx rows, a
// multiple of kStepRows (kernels/probes.py, sublane_plan).
extern "C" int sublane_gather_slab(const void* tab, const void* idx, void* out, long long t_rows, long long n_rows,
                                   long long rows_per, void* stream) {
  if (t_rows < 1 || t_rows > kSlabRows || rows_per <= 0 || rows_per % kStepRows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  CUtensorMap maps[3];
  int err = lane_boxes(&maps[0], tab, t_rows);
  if (err == 0) err = lane_boxes(&maps[1], idx, n_rows);
  if (err == 0) err = lane_boxes(&maps[2], out, n_rows);
  if (err != 0) return err;
  const size_t smem = static_cast<size_t>((t_rows + kBoxRows - 1) / kBoxRows * kBoxRows + 4 * kStepRows) * 16 + 64;
  const cudaError_t attr =
      cudaFuncSetAttribute(sublane_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long chunks = (n_rows + rows_per - 1) / rows_per;
  sublane_slab_kernel<<<static_cast<unsigned>(chunks * kSlabs), kStageThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1], maps[2], static_cast<unsigned>(t_rows),
                                                            static_cast<unsigned>(n_rows),
                                                            static_cast<unsigned>(rows_per));
  return static_cast<int>(cudaGetLastError());
}
