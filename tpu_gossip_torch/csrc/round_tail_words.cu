// K4: the packed round tail over LSB-first uint8 word planes in one launch.
//
// Replaces the Pallas kernel tpu_gossip/kernels/round_tail.py:
// round_tail_words(pallas=True) (_tail_words_kernel): K3's algebra (merge,
// the int16 first-infection latch, per-slot SIR recovery, forward-once
// bookkeeping, the churn fresh-row and streaming expired-column resets) with
// seen, forwarded, recovered, incoming, receptive and transmit as (N, W)
// uint8 words, W = ceil(M / 8), bit k of word j holding slot 8j + k, and
// infected_round as the full-width (N, M) int16 plane.
//
// Bound: bytes. Per row, at M = 16 with neither forward-once nor a reset,
// it reads seen, recovered, incoming and receptive (2 B each) and
// infected_round (32 B), and writes seen and recovered (2 B each) and
// infected_round (32 B): 76 B a row, 76 MB at 1M rows, about 22.7 us at
// 3.35 TB/s. The int16 latch plane is 64 of the 76 bytes.
//
// Design: one thread per (row, word), neighbouring threads on neighbouring
// words. It reads one byte of each word plane and the word's 8 int16 of
// infected_round: one 16-byte load when M % 8 == 0 and both int16 planes
// are 16-byte aligned (every word then starts a 16-byte group), scalar
// loads for a ragged last word otherwise. The keep word is 0x00 on a fresh
// row and the packed ~expired bits of word j otherwise, so padding bits
// (slots M..8W) are never set: the inputs conform and every output is an
// AND with them or with keep. The round arrives twice, as one-element
// device buffers (rnd16 saturated at the plane width, what the latch
// stores; rnd32 wide), and age_saturated picks the SIR age as in K3: 0 for
// the XLA word chain (wide), 1 for the Pallas kernel (saturated). fresh and
// expired are null when absent; forwarded is read and written only when
// needs_fwd (forward-once or a reset), else the wrapper passes it through.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void round_tail_words_kernel(
    const uint8_t* __restrict__ seen, const int16_t* __restrict__ ir,
    const uint8_t* __restrict__ rec, const uint8_t* __restrict__ inc,
    const uint8_t* __restrict__ recp, const uint8_t* __restrict__ fwd,
    const uint8_t* __restrict__ tx, const uint8_t* __restrict__ fresh,
    const uint8_t* __restrict__ expired, uint8_t* __restrict__ o_seen,
    int16_t* __restrict__ o_ir, uint8_t* __restrict__ o_rec,
    uint8_t* __restrict__ o_fwd, const int16_t* __restrict__ rnd16_ptr,
    const int32_t* __restrict__ rnd32_ptr, long long n, int m, int w,
    int forward_once, int sir, int needs_fwd, int age_saturated, int vec) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n * w) return;
  const long long row = e / w;
  const int j = static_cast<int>(e - row * w);
  const int nb = min(8, m - 8 * j);  // real slots in this word
  const int16_t rnd16 = *rnd16_ptr;
  const int age = age_saturated ? static_cast<int>(rnd16) : *rnd32_ptr;

  const bool fresh_row = fresh != nullptr && fresh[row] != 0;
  unsigned col_keep = (1u << nb) - 1u;  // real bits of word j
  if (expired != nullptr) {
    for (int k = 0; k < nb; ++k) {
      if (expired[8 * j + k] != 0) col_keep &= ~(1u << k);
    }
  }
  const unsigned keep = fresh_row ? 0u : (expired != nullptr ? col_keep : 0xFFu);

  const unsigned s = seen[e];
  const unsigned in = inc[e] & recp[e];
  o_seen[e] = static_cast<uint8_t>((s | in) & keep);
  const unsigned newly = in & ~s;

  const long long base = row * m + 8 * j;
  int16_t v[8];
  if (vec) {
    const int4 raw = *reinterpret_cast<const int4*>(ir + base);
    const int16_t* p = reinterpret_cast<const int16_t*>(&raw);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = p[k];
  } else {
    for (int k = 0; k < nb; ++k) v[k] = ir[base + k];
  }
  unsigned rec_bits = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k < nb) {
      int16_t x = v[k];
      if (((newly >> k) & 1u) && x < 0) x = rnd16;
      if (sir > 0 && x >= 0 && age - static_cast<int>(x) >= sir) rec_bits |= 1u << k;
      if (!((col_keep >> k) & 1u) || fresh_row) x = -1;
      v[k] = x;
    }
  }
  if (vec) {
    int4 raw;
    int16_t* p = reinterpret_cast<int16_t*>(&raw);
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = v[k];
    *reinterpret_cast<int4*>(o_ir + base) = raw;
  } else {
    for (int k = 0; k < nb; ++k) o_ir[base + k] = v[k];
  }
  o_rec[e] = static_cast<uint8_t>((rec[e] | rec_bits) & keep);

  if (needs_fwd) {
    unsigned f = fwd[e];
    if (forward_once) f |= tx[e];
    o_fwd[e] = static_cast<uint8_t>(f & keep);
  }
}

}  // namespace

extern "C" int round_tail_words(const void* seen, const void* ir, const void* rec,
                                const void* inc, const void* recp, const void* fwd,
                                const void* tx, const void* fresh, const void* expired,
                                void* o_seen, void* o_ir, void* o_rec, void* o_fwd,
                                const void* rnd16, const void* rnd32, long long n,
                                int m, int forward_once, int sir, int needs_fwd,
                                int age_saturated, void* stream) {
  const int w = (m + 7) / 8;
  const long long total = n * w;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  const int vec = (m % 8 == 0) && (reinterpret_cast<uintptr_t>(ir) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(o_ir) % 16 == 0);
  constexpr int kThreads = 256;
  const unsigned grid = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  round_tail_words_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seen), static_cast<const int16_t*>(ir),
      static_cast<const uint8_t*>(rec), static_cast<const uint8_t*>(inc),
      static_cast<const uint8_t*>(recp), static_cast<const uint8_t*>(fwd),
      static_cast<const uint8_t*>(tx), static_cast<const uint8_t*>(fresh),
      static_cast<const uint8_t*>(expired), static_cast<uint8_t*>(o_seen),
      static_cast<int16_t*>(o_ir), static_cast<uint8_t*>(o_rec),
      static_cast<uint8_t*>(o_fwd), static_cast<const int16_t*>(rnd16),
      static_cast<const int32_t*>(rnd32), n, m, w, forward_once, sir, needs_fwd,
      age_saturated, vec);
  return static_cast<int>(cudaGetLastError());
}
