// K2: plane fold, out[j] = OP over i < pad_deg of flat[slot_off + i*cstride + j].
//
// Replaces the Pallas kernel tpu_gossip/kernels/permute.py:fold_planes
// (_fold_kernel): the reduce of every position-major degree class, OR of the
// delivered words each round and SUM of the realized degrees in the plan build.
//
// Bound: bytes. The fold reads pad_deg planes of cstride int32 words once
// and writes one plane: (pad_deg + 1) * cstride * 4 bytes. At the 1M plan the
// largest class (pad_deg 2, cstride 455,680) moves 5.5 MB, about 1.6 us at
// 3.35 TB/s; one OR reduce over all 10 position-major classes moves about
// 16.4 MB.
//
// Design: the TPU kernel revisits one (8, 128) output block across a
// sequential plane grid axis. Blocks on this card run in no order, so the
// plane axis becomes a loop inside one thread: one thread per output column
// j < cstride keeps the accumulator in a register and reads plane after plane;
// neighbouring threads read neighbouring words, so every plane read is
// coalesced. The [:count] slice is taken by the wrapper. SUM wraps modulo
// 2^32 like the int32 add it replaces.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <bool kOr>
__global__ void fold_planes_kernel(const int32_t* __restrict__ flat,
                                   int32_t* __restrict__ out,
                                   long long slot_off, long long cstride,
                                   int pad_deg) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= cstride) return;
  const int32_t* p = flat + slot_off + j;
  uint32_t acc = static_cast<uint32_t>(p[0]);
  for (int i = 1; i < pad_deg; ++i) {
    const uint32_t v = static_cast<uint32_t>(p[static_cast<long long>(i) * cstride]);
    acc = kOr ? (acc | v) : (acc + v);
  }
  out[j] = static_cast<int32_t>(acc);
}

template <bool kOr>
int launch(const void* flat, void* out, long long slot_off, long long cstride,
           int pad_deg, void* stream) {
  if (cstride <= 0 || pad_deg <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int kThreads = 256;
  const unsigned grid = static_cast<unsigned>((cstride + kThreads - 1) / kThreads);
  fold_planes_kernel<kOr><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(flat), static_cast<int32_t*>(out), slot_off,
      cstride, pad_deg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fold_planes_or(const void* flat, void* out, long long slot_off,
                              long long cstride, int pad_deg, void* stream) {
  return launch<true>(flat, out, slot_off, cstride, pad_deg, stream);
}

extern "C" int fold_planes_sum(const void* flat, void* out, long long slot_off,
                               long long cstride, int pad_deg, void* stream) {
  return launch<false>(flat, out, slot_off, cstride, pad_deg, stream);
}
