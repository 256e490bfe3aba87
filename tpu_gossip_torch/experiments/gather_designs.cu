// Rates and designs behind the staged probe gathers of csrc/gather_probes.cu,
// measured by experiments/gather_designs.py. None of these kernels is on a
// path of the port:
//
//   smem_reads      random 4-byte reads of a block's own shared memory, or
//                   of its cluster's (2, 4 or 8 blocks) through distributed
//                   shared memory;
//   l2_reads        random 4-byte reads of an L2-resident table, or 16-byte
//                   reads 512 bytes apart, by a chosen number of SMs;
//   box_stores      TMA stores of 4-lane or 8-lane boxes (16 or 32 bytes a
//                   row) over an (N, 128) int32 tensor;
//   lane_cluster    P2 with a row over a cluster of 2-8 blocks' shared
//                   memory, lookups through distributed shared memory;
//   sublane_lsu     P3 with the 4-lane slab moved by the load/store units;
//   sublane_pair    P3 with two slabs a cluster, the out tile of 8 lanes
//                   (32 B a row) written through distributed shared memory
//                   and stored by the TMA;
//   sublane_cluster8  P3 with a cluster of 8 slabs (32 lanes), a warp reading
//                   128 B of an idx row, lookups through distributed shared
//                   memory.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kSlabWords = 32768;  // 128 KB
constexpr int kBoxRows = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ int ld_cluster(uint32_t a) {
  int v;
  asm volatile("ld.shared::cluster.b32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ unsigned slab_word(unsigned i, unsigned k) { return 4 * i + (k ^ ((i >> 3) & 3)); }

__device__ __forceinline__ int4 rotate(int4 v, unsigned i) {
  const unsigned sw = (i >> 3) & 3;
  if (sw & 1) v = make_int4(v.y, v.x, v.w, v.z);
  if (sw & 2) v = make_int4(v.z, v.w, v.x, v.y);
  return v;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

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

// ---- rates ----------------------------------------------------------------

template <int kCluster, bool kLocal>
__global__ void __launch_bounds__(kThreads, 1) smem_reads_kernel(int* out, unsigned iters) {
  extern __shared__ int stage[];
  for (int w = threadIdx.x; w < kSlabWords; w += kThreads) stage[w] = w * 7 + blockIdx.x;
  constexpr unsigned bits = 15 + (kCluster == 8 ? 3 : kCluster == 4 ? 2 : kCluster == 2 ? 1 : 0);
  cluster_sync();
  unsigned x = (blockIdx.x * kThreads + threadIdx.x) * 2654435761u;
  int acc = 0;
  for (unsigned it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      x = x * 1664525u + 1013904223u;
      const unsigned i = x >> (32 - bits);
      if (kLocal)
        acc += stage[i & (kSlabWords - 1)];
      else
        acc += ld_cluster(map_rank(stage + (i & (kSlabWords - 1)), i >> 15));
    }
  }
  out[blockIdx.x * kThreads + threadIdx.x] = acc;
  cluster_sync();
}

// one block an SM: the dynamic shared memory keeps a second one off
__global__ void __launch_bounds__(kThreads, 1) l2_random_kernel(const int* __restrict__ tab, unsigned mask, int* out,
                                                                unsigned iters) {
  unsigned x = (blockIdx.x * kThreads + threadIdx.x) * 2654435761u;
  int acc = 0;
  for (unsigned it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      x = x * 1664525u + 1013904223u;
      acc += __ldg(tab + ((x >> 8) & mask));
    }
  }
  out[blockIdx.x * kThreads + threadIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads, 1) l2_strided_kernel(const int4* __restrict__ src, unsigned rows,
                                                                 int4* out, unsigned iters) {
  int4 acc = make_int4(0, 0, 0, 0);
  const unsigned col = blockIdx.x % 32;
  for (unsigned it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned r = ((blockIdx.x / 32) * 4096 + it * 4096 + k * 1024 + threadIdx.x) % rows;
      const int4 v = __ldg(src + r * 32 + col);
      acc.x += v.x;
      acc.y ^= v.y;
      acc.z += v.z;
      acc.w ^= v.w;
    }
  }
  out[blockIdx.x * kThreads + threadIdx.x] = acc;
}

// each block stores its column of `lanes` lanes over rows [r0, r0 + rows_per) from one shared tile
__global__ void box_stores_kernel(const __grid_constant__ CUtensorMap out, int lanes, unsigned rows_per) {
  __shared__ alignas(128) int4 buf[kBoxRows * 2];
  for (int i = threadIdx.x; i < kBoxRows * 2; i += blockDim.x) buf[i] = make_int4(i, i, i, i);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int cols = 128 / lanes;
  const int r0 = blockIdx.x / cols * rows_per;
  for (unsigned j = 0; j < (rows_per + kBoxRows - 1) / kBoxRows; ++j)
    box_store(&out, buf, blockIdx.x % cols * lanes, r0 + j * kBoxRows);
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group 0;" ::: "memory");
}

// ---- P2: the row over a cluster ---------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
    lane_cluster_kernel(const int32_t* __restrict__ tab, const int4* __restrict__ idx, int4* __restrict__ out,
                        unsigned t_rows, unsigned width, unsigned uses, unsigned per, unsigned blocks_per_row) {
  extern __shared__ int4 stage4[];
  int32_t* stage = reinterpret_cast<int32_t*>(stage4);
  const unsigned s = blockIdx.x / blocks_per_row;
  const unsigned part = blockIdx.x % blocks_per_row;
  const unsigned lo = min(cluster_rank() * kSlabWords, width);
  const unsigned n4 = min(width - lo, static_cast<unsigned>(kSlabWords)) / 4;
  const int4* src = reinterpret_cast<const int4*>(tab + s * width + lo);
  for (unsigned v = threadIdx.x; v < n4; v += kThreads) stage4[v] = __ldg(src + v);
  cluster_sync();
  const unsigned begin = part * per, end = min(begin + per, uses);
  for (unsigned p = begin + threadIdx.x * 4; p < end; p += kThreads * 4) {
    const unsigned j = p / width;
    const unsigned at = ((j * t_rows + s) * width + (p - j * width)) / 4;
    const int4 i = idx[at];
    int4 o;
    o.x = ld_cluster(map_rank(stage + (i.x & (kSlabWords - 1)), static_cast<unsigned>(i.x) >> 15));
    o.y = ld_cluster(map_rank(stage + (i.y & (kSlabWords - 1)), static_cast<unsigned>(i.y) >> 15));
    o.z = ld_cluster(map_rank(stage + (i.z & (kSlabWords - 1)), static_cast<unsigned>(i.z) >> 15));
    o.w = ld_cluster(map_rank(stage + (i.w & (kSlabWords - 1)), static_cast<unsigned>(i.w) >> 15));
    out[at] = o;
  }
  cluster_sync();
}

// ---- P3: three slab designs ----------------------------------------------------

// the load/store units move the 4-lane slab, idx and out (16 B a row each)
__global__ void __launch_bounds__(kThreads, 1)
    sublane_lsu_kernel(const int4* __restrict__ tab, const int4* __restrict__ idx, int4* __restrict__ out,
                       unsigned t_rows, unsigned n_rows, unsigned rows_per) {
  extern __shared__ int4 stage4[];
  const int32_t* stage = reinterpret_cast<const int32_t*>(stage4);
  const unsigned slab = blockIdx.x % 32, chunk = blockIdx.x / 32;
  for (unsigned i = threadIdx.x; i < t_rows; i += kThreads) stage4[i] = rotate(__ldg(tab + i * 32 + slab), i);
  __syncthreads();
  const unsigned r0 = chunk * rows_per, r1 = min(r0 + rows_per, n_rows);
  for (unsigned r = r0 + threadIdx.x; r < r1; r += kThreads) {
    const int4 ix = idx[r * 32 + slab];
    out[r * 32 + slab] = make_int4(stage[slab_word(ix.x, 0)], stage[slab_word(ix.y, 1)], stage[slab_word(ix.z, 2)],
                                   stage[slab_word(ix.w, 3)]);
  }
}

// two slabs a cluster: TMA-loaded slab and idx (4-lane boxes), out written
// into the step owner's 8-lane tile (the other half through distributed
// shared memory) and stored in 8-lane boxes
__global__ void __launch_bounds__(kThreads, 1)
    sublane_pair_kernel(const __grid_constant__ CUtensorMap tab_map, const __grid_constant__ CUtensorMap idx_map,
                        const __grid_constant__ CUtensorMap out_map, unsigned t_rows, unsigned n_rows,
                        unsigned rows_per) {
  extern __shared__ int4 smem[];
  const unsigned slab_rows = (t_rows + kBoxRows - 1) / kBoxRows * kBoxRows;
  int4* slab4 = smem;
  int4* idx_ring = smem + slab_rows;
  int4* out_tile = idx_ring + 2 * kThreads;
  uint64_t* bars = reinterpret_cast<uint64_t*>(out_tile + 2 * kThreads);
  const unsigned rank = cluster_rank();
  const unsigned pair = blockIdx.x / 2;
  const int lane = static_cast<int>((pair % 16) * 2 + rank) * 4;
  const unsigned r0 = pair / 16 * rows_per, r1 = min(r0 + rows_per, n_rows);
  const unsigned steps = (r1 - r0 + kThreads - 1) / kThreads;
  const uint32_t tile0 = map_rank(out_tile, 0), tile1 = map_rank(out_tile, 1);
  auto load_step = [&](unsigned j) {
    const unsigned row = r0 + j * kThreads;
    const unsigned boxes = (min(static_cast<unsigned>(kThreads), r1 - row) + kBoxRows - 1) / kBoxRows;
    mbar_expect(&bars[1 + (j & 1)], boxes * kBoxRows * 16);
    for (unsigned m = 0; m < boxes; ++m)
      box_load(idx_ring + (j & 1) * kThreads + m * kBoxRows, &idx_map, &bars[1 + (j & 1)], lane, row + m * kBoxRows);
  };
  if (threadIdx.x == 0) {
    for (int k = 0; k < 3; ++k) mbar_init(&bars[k]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(&bars[0], slab_rows * 16);
    for (unsigned i = 0; i < slab_rows; i += kBoxRows) box_load(slab4 + i, &tab_map, &bars[0], lane, i);
    for (unsigned j = 0; j < 2 && j < steps; ++j) load_step(j);
  }
  __syncthreads();
  mbar_wait(&bars[0], 0);
  for (unsigned i = threadIdx.x; i < t_rows; i += kThreads) slab4[i] = rotate(slab4[i], i);
  cluster_sync();
  const int32_t* slab = reinterpret_cast<const int32_t*>(slab4);
  for (unsigned j = 0; j < steps; ++j) {
    const unsigned b = j & 1;
    const unsigned live = min(static_cast<unsigned>(kThreads), r1 - r0 - j * kThreads);
    mbar_wait(&bars[1 + b], (j >> 1) & 1);
    if (threadIdx.x < (live + kBoxRows - 1) / kBoxRows * kBoxRows) {
      const int4 ix = idx_ring[b * kThreads + threadIdx.x];
      const uint32_t at = (b ? tile1 : tile0) + (threadIdx.x * 2 + rank) * 16;
      asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(at), "r"(slab[slab_word(ix.x, 0)]),
                   "r"(slab[slab_word(ix.y, 1)]), "r"(slab[slab_word(ix.z, 2)]), "r"(slab[slab_word(ix.w, 3)])
                   : "memory");
      asm volatile("fence.proxy.async.shared::cluster;" ::: "memory");
    }
    cluster_sync();
    if (threadIdx.x == 0) {
      if (rank == b) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        for (unsigned m = 0; m * kBoxRows < live; ++m)
          box_store(&out_map, out_tile + m * kBoxRows * 2, lane - static_cast<int>(rank) * 4,
                    r0 + j * kThreads + m * kBoxRows);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
      if (j + 2 < steps) load_step(j + 2);
      if (rank == b) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// a cluster of 8 slabs (32 lanes): a warp reads 128 B of an idx row, each
// lookup sent to the block holding its lane's slab
__global__ void __launch_bounds__(kThreads, 1)
    sublane_cluster8_kernel(const int4* __restrict__ tab, const int* __restrict__ idx, int* __restrict__ out,
                            unsigned t_rows, unsigned n_rows, unsigned rows_per) {
  extern __shared__ int4 stage4[];
  int* stage = reinterpret_cast<int*>(stage4);
  const unsigned q = cluster_rank();
  const unsigned c = blockIdx.x / 8;
  const unsigned g = c % 4, chunk = c / 4;
  for (unsigned i = threadIdx.x; i < t_rows; i += kThreads) stage4[i] = rotate(__ldg(tab + i * 32 + 8 * g + q), i);
  cluster_sync();
  const unsigned r0 = chunk * rows_per, r1 = min(r0 + rows_per, n_rows);
  const unsigned sub = (rows_per + 7) / 8;
  const unsigned b0 = min(r0 + q * sub, r1), b1 = min(b0 + sub, r1);
  const unsigned t = threadIdx.x % 32;
  for (unsigned r = b0 + threadIdx.x / 32; r < b1; r += 32) {
    const int v = idx[r * 128 + 32 * g + t];
    out[r * 128 + 32 * g + t] = ld_cluster(map_rank(stage + slab_word(v, t & 3), t >> 2));
  }
  cluster_sync();
}

// ---- launches ------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

int boxes_of(CUtensorMap* map, const void* base, long long rows, unsigned lanes) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {128, static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {512};
  const cuuint32_t box[2] = {lanes, kBoxRows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : static_cast<int>(cudaErrorInvalidValue);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, unsigned blocks, unsigned threads, size_t smem, unsigned cluster, void* stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;  // a cluster of 1 too: the kernels' cluster barriers need one
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" int smem_reads(int cluster, int local, void* out, unsigned blocks, unsigned iters, void* stream) {
  auto o = static_cast<int*>(out);
  const size_t smem = kSlabWords * 4;
  if (local) return launch(smem_reads_kernel<1, true>, blocks, kThreads, smem, 1, stream, o, iters);
  switch (cluster) {
    case 2: return launch(smem_reads_kernel<2, false>, blocks, kThreads, smem, 2, stream, o, iters);
    case 4: return launch(smem_reads_kernel<4, false>, blocks, kThreads, smem, 4, stream, o, iters);
    case 8: return launch(smem_reads_kernel<8, false>, blocks, kThreads, smem, 8, stream, o, iters);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int l2_reads(int strided, const void* src, unsigned mask_or_rows, void* out, unsigned blocks, unsigned iters,
                        void* stream) {
  const size_t smem = 120 * 1024;
  if (strided)
    return launch(l2_strided_kernel, blocks, kThreads, smem, 1, stream, static_cast<const int4*>(src), mask_or_rows,
                  static_cast<int4*>(out), iters);
  return launch(l2_random_kernel, blocks, kThreads, smem, 1, stream, static_cast<const int*>(src), mask_or_rows,
                static_cast<int*>(out), iters);
}

extern "C" int box_stores(int lanes, void* out, long long n_rows, long long rows_per, void* stream) {
  CUtensorMap map;
  const int err = boxes_of(&map, out, n_rows, static_cast<unsigned>(lanes));
  if (err != 0) return err;
  const long long chunks = (n_rows + rows_per - 1) / rows_per;
  return launch(box_stores_kernel, static_cast<unsigned>(chunks * (128 / lanes)), 32, 0, 1, stream, map, lanes,
                static_cast<unsigned>(rows_per));
}

extern "C" int lane_cluster(const void* tab, const void* idx, void* out, long long n_rows, long long t_rows,
                            long long width, int cluster, long long per, long long blocks_per_row, void* stream) {
  return launch(lane_cluster_kernel, static_cast<unsigned>(t_rows * blocks_per_row), kThreads, kSlabWords * 4,
                static_cast<unsigned>(cluster), stream, static_cast<const int32_t*>(tab), static_cast<const int4*>(idx),
                static_cast<int4*>(out), static_cast<unsigned>(t_rows), static_cast<unsigned>(width),
                static_cast<unsigned>(n_rows / t_rows * width), static_cast<unsigned>(per),
                static_cast<unsigned>(blocks_per_row));
}

// design 0: load/store units, 1: slab pairs, 2: clusters of 8 (rows_per: idx rows a row chunk)
extern "C" int sublane_design(int design, const void* tab, const void* idx, void* out, long long t_rows,
                              long long n_rows, long long rows_per, void* stream) {
  const long long chunks = (n_rows + rows_per - 1) / rows_per;
  const auto t = static_cast<unsigned>(t_rows), n = static_cast<unsigned>(n_rows),
             rp = static_cast<unsigned>(rows_per);
  if (design == 0)
    return launch(sublane_lsu_kernel, static_cast<unsigned>(chunks * 32), kThreads, t_rows * 16, 1, stream,
                  static_cast<const int4*>(tab), static_cast<const int4*>(idx), static_cast<int4*>(out), t, n, rp);
  if (design == 2)
    return launch(sublane_cluster8_kernel, static_cast<unsigned>(chunks * 32), kThreads, t_rows * 16, 8, stream,
                  static_cast<const int4*>(tab), static_cast<const int*>(idx), static_cast<int*>(out), t, n, rp);
  if (rows_per % kThreads) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  int err = boxes_of(&maps[0], tab, t_rows, 4);
  if (err == 0) err = boxes_of(&maps[1], idx, n_rows, 4);
  if (err == 0) err = boxes_of(&maps[2], out, n_rows, 8);
  if (err != 0) return err;
  const size_t smem = static_cast<size_t>((t_rows + kBoxRows - 1) / kBoxRows * kBoxRows + 4 * kThreads) * 16 + 64;
  return launch(sublane_pair_kernel, static_cast<unsigned>(chunks * 32), kThreads, smem, 2, stream, maps[0], maps[1],
                maps[2], t, n, rp);
}
