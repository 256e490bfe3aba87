// K3: the post-delivery round tail over the (N, M) slot planes in one launch.
//
// Replaces the Pallas kernel tpu_gossip/kernels/round_tail.py:tail_pallas
// (_tail_kernel), which is also the single-launch form of the default "fused"
// tail: merge (seen |= incoming & receptive), the int16 first-infection
// latch, per-slot SIR recovery, forward-once bookkeeping, and the churn
// fresh-row and streaming expired-column resets.
//
// Bound: bytes. Per (row, slot) element it reads seen, recovered, incoming
// and receptive (1 B each) and infected_round (2 B), and writes seen,
// recovered (1 B) and infected_round (2 B); forwarded and transmit add 1 B
// each when forward-once or a reset touches them. At 1M peers x 16 slots
// that is about 96 MB read and 64 MB written, about 48 us at 3.35 TB/s.
//
// Design: one thread per element, every plane read once and written once;
// the TPU's (512, M) row blocks become a flat grid, the (blk, 1) fresh and
// (1, M) expired operands become per-row and per-column byte reads (both
// optional, null when absent). Bools are the 0/1 bytes torch stores. The
// round arrives twice, as one-element device buffers so the round cursor
// never leaves the card: saturated at the int16 plane width (rnd16, what
// the latch stores) and wide (rnd32). The SIR age is rnd32 - ir when
// age_saturated is 0 (the XLA tail_fused) and rnd16 - ir when it is 1
// (the Pallas tail_pallas, which sees only the saturated cursor); the two
// differ once a run passes ROUND_CAP. It is computed in int32 so the -1
// sentinel cannot wrap. When nothing touches forwarded the kernel neither
// reads nor writes it (the wrapper passes it through).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void round_tail_kernel(
    const uint8_t* __restrict__ seen, const int16_t* __restrict__ ir,
    const uint8_t* __restrict__ rec, const uint8_t* __restrict__ inc,
    const uint8_t* __restrict__ recp, const uint8_t* __restrict__ fwd,
    const uint8_t* __restrict__ tx, const uint8_t* __restrict__ fresh,
    const uint8_t* __restrict__ expired, uint8_t* __restrict__ o_seen,
    int16_t* __restrict__ o_ir, uint8_t* __restrict__ o_rec,
    uint8_t* __restrict__ o_fwd, const int16_t* __restrict__ rnd16_ptr,
    const int32_t* __restrict__ rnd32_ptr, long long n, int m,
    int forward_once, int sir, int needs_fwd, int age_saturated) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n * m) return;
  const int rnd16 = *rnd16_ptr;
  const int age = age_saturated ? rnd16 : *rnd32_ptr;
  const long long row = e / m;
  const int col = static_cast<int>(e - row * m);

  bool keep = true;
  if (fresh != nullptr) keep = keep && fresh[row] == 0;
  if (expired != nullptr) keep = keep && expired[col] == 0;

  const bool s = seen[e] != 0;
  const bool in = (inc[e] != 0) && (recp[e] != 0);
  o_seen[e] = static_cast<uint8_t>((s || in) && keep);

  const int16_t old_ir = ir[e];
  int16_t new_ir = (in && !s && old_ir < 0) ? static_cast<int16_t>(rnd16) : old_ir;
  bool r = rec[e] != 0;
  if (sir > 0) {
    r = r || (new_ir >= 0 && age - static_cast<int>(new_ir) >= sir);
  }
  if (!keep) {
    new_ir = -1;
    r = false;
  }
  o_ir[e] = new_ir;
  o_rec[e] = static_cast<uint8_t>(r);

  if (needs_fwd) {
    bool f = fwd[e] != 0;
    if (forward_once) f = f || (tx[e] != 0);
    o_fwd[e] = static_cast<uint8_t>(f && keep);
  }
}

}  // namespace

extern "C" int round_tail(const void* seen, const void* ir, const void* rec,
                          const void* inc, const void* recp, const void* fwd,
                          const void* tx, const void* fresh, const void* expired,
                          void* o_seen, void* o_ir, void* o_rec, void* o_fwd,
                          const void* rnd16, const void* rnd32, long long n,
                          int m, int forward_once, int sir, int needs_fwd,
                          int age_saturated, void* stream) {
  const long long total = n * m;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int kThreads = 256;
  const unsigned grid = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  round_tail_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seen), static_cast<const int16_t*>(ir),
      static_cast<const uint8_t*>(rec), static_cast<const uint8_t*>(inc),
      static_cast<const uint8_t*>(recp), static_cast<const uint8_t*>(fwd),
      static_cast<const uint8_t*>(tx), static_cast<const uint8_t*>(fresh),
      static_cast<const uint8_t*>(expired), static_cast<uint8_t*>(o_seen),
      static_cast<int16_t*>(o_ir), static_cast<uint8_t*>(o_rec),
      static_cast<uint8_t*>(o_fwd), static_cast<const int16_t*>(rnd16),
      static_cast<const int32_t*>(rnd32), n, m, forward_once, sir, needs_fwd,
      age_saturated);
  return static_cast<int>(cudaGetLastError());
}
