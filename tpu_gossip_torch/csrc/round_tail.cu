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
// Design: the TPU's (512, M) row blocks become a flat grid over the N*M
// elements, 16 consecutive elements a thread: one 16-byte load of each
// bool plane (forwarded and transmit only when something touches them),
// two of infected_round, and the matching 16-byte stores, so the kernel
// issues a sixteenth of the memory instructions of one thread an element.
// The bool planes are combined four bytes at a time (each byte made 0x00 or
// 0xFF by __vcmpne4, so any nonzero byte reads as true, as torch's bools
// do); only the latch and the SIR age go element by element. The (blk, 1)
// fresh and (1, M) expired operands become per-row and per-column byte
// reads (both optional, null when absent); their row and column come from
// one division a thread, stepped through the thread's 16 elements, and not
// at all when neither is given. The last N*M mod 16 elements are taken one
// at a time by the thread past the last whole vector, in the same launch.
// The wrapper passes 16-byte-aligned planes. The round arrives twice, as
// one-element device buffers so the round cursor never leaves the card:
// saturated at the int16 plane width (rnd16, what the latch stores) and
// wide (rnd32). The SIR age is rnd32 - ir when age_saturated is 0 (the XLA
// tail_fused) and rnd16 - ir when it is 1 (the Pallas tail_pallas, which
// sees only the saturated cursor); the two differ once a run passes
// ROUND_CAP. It is computed in int32 so the -1 sentinel cannot wrap. When
// nothing touches forwarded the kernel neither reads nor writes it (the
// wrapper passes it through).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kVec = 16;  // elements a thread
constexpr int kThreads = 256;

struct Planes {
  const uint8_t* seen;
  const int16_t* ir;
  const uint8_t* rec;
  const uint8_t* inc;
  const uint8_t* recp;
  const uint8_t* fwd;
  const uint8_t* tx;
  const uint8_t* fresh;
  const uint8_t* expired;
  uint8_t* o_seen;
  int16_t* o_ir;
  uint8_t* o_rec;
  uint8_t* o_fwd;
};

union Bytes16 {
  uint4 v;
  uint32_t w[4];
};

union Shorts16 {
  int4 v[2];
  int16_t s[kVec];
};

__device__ __forceinline__ uint32_t mask4(uint32_t w) { return __vcmpne4(w, 0u); }  // 0xFF a nonzero byte

__device__ __forceinline__ Bytes16 load16(const uint8_t* p) {
  Bytes16 b;
  b.v = __ldg(reinterpret_cast<const uint4*>(p));
  return b;
}

__device__ __forceinline__ bool byte_bit(const uint32_t* w, int j) { return (w[j >> 2] >> (8 * (j & 3))) & 1u; }

// one element the old way: the remainder past the last whole vector
__device__ void tail_one(const Planes& p, long long e, int m, int rnd16, int age, int forward_once,
                         int sir, int needs_fwd) {
  const long long row = e / m;
  const int col = static_cast<int>(e - row * m);
  bool keep = true;
  if (p.fresh != nullptr) keep = keep && p.fresh[row] == 0;
  if (p.expired != nullptr) keep = keep && p.expired[col] == 0;
  const bool s = p.seen[e] != 0;
  const bool in = (p.inc[e] != 0) && (p.recp[e] != 0);
  p.o_seen[e] = static_cast<uint8_t>((s || in) && keep);
  const int16_t old_ir = p.ir[e];
  int16_t new_ir = (in && !s && old_ir < 0) ? static_cast<int16_t>(rnd16) : old_ir;
  bool r = p.rec[e] != 0;
  if (sir > 0) r = r || (new_ir >= 0 && age - static_cast<int>(new_ir) >= sir);
  if (!keep) {
    new_ir = -1;
    r = false;
  }
  p.o_ir[e] = new_ir;
  p.o_rec[e] = static_cast<uint8_t>(r);
  if (needs_fwd) {
    bool f = p.fwd[e] != 0;
    if (forward_once) f = f || (p.tx[e] != 0);
    p.o_fwd[e] = static_cast<uint8_t>(f && keep);
  }
}

__global__ void __launch_bounds__(kThreads) round_tail_kernel(
    Planes p, const int16_t* __restrict__ rnd16_ptr, const int32_t* __restrict__ rnd32_ptr, long long total,
    int m, int forward_once, int sir, int needs_fwd, int age_saturated) {
  const long long e0 = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  if (e0 >= total) return;
  const int rnd16 = *rnd16_ptr;
  const int age = age_saturated ? rnd16 : *rnd32_ptr;
  if (e0 + kVec > total) {
    for (long long e = e0; e < total; ++e) tail_one(p, e, m, rnd16, age, forward_once, sir, needs_fwd);
    return;
  }

  const Bytes16 sv = load16(p.seen + e0), rv = load16(p.rec + e0);
  const Bytes16 iv = load16(p.inc + e0), pv = load16(p.recp + e0);
  Shorts16 ir;
  ir.v[0] = __ldg(reinterpret_cast<const int4*>(p.ir + e0));
  ir.v[1] = __ldg(reinterpret_cast<const int4*>(p.ir + e0) + 1);
  Bytes16 fv, tv;
  if (needs_fwd) {
    fv = load16(p.fwd + e0);
    tv.v = make_uint4(0u, 0u, 0u, 0u);
    if (forward_once) tv = load16(p.tx + e0);
  }

  uint32_t keep[4] = {~0u, ~0u, ~0u, ~0u};
  if (p.fresh != nullptr || p.expired != nullptr) {
    long long row = e0 / m;
    int col = static_cast<int>(e0 - row * m);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const bool k = (p.fresh == nullptr || p.fresh[row] == 0) && (p.expired == nullptr || p.expired[col] == 0);
      if (!k) keep[j >> 2] &= ~(0xFFu << (8 * (j & 3)));
      if (++col == m) {
        col = 0;
        ++row;
      }
    }
  }

  Bytes16 os, orec, ofwd;
  uint32_t newly[4], rec[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t s = mask4(sv.w[w]);
    const uint32_t in = mask4(iv.w[w]) & mask4(pv.w[w]);
    os.w[w] = (s | in) & keep[w] & 0x01010101u;
    newly[w] = in & ~s;
    rec[w] = mask4(rv.w[w]);
    if (needs_fwd) ofwd.w[w] = (mask4(fv.w[w]) | mask4(tv.w[w])) & keep[w] & 0x01010101u;
    orec.w[w] = 0u;
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int16_t old_ir = ir.s[j];
    int16_t new_ir = (byte_bit(newly, j) && old_ir < 0) ? static_cast<int16_t>(rnd16) : old_ir;
    bool r = byte_bit(rec, j);
    if (sir > 0) r = r || (new_ir >= 0 && age - static_cast<int>(new_ir) >= sir);
    if (!byte_bit(keep, j)) {
      new_ir = -1;
      r = false;
    }
    ir.s[j] = new_ir;
    orec.w[j >> 2] |= static_cast<uint32_t>(r) << (8 * (j & 3));
  }

  *reinterpret_cast<uint4*>(p.o_seen + e0) = os.v;
  *reinterpret_cast<uint4*>(p.o_rec + e0) = orec.v;
  reinterpret_cast<int4*>(p.o_ir + e0)[0] = ir.v[0];
  reinterpret_cast<int4*>(p.o_ir + e0)[1] = ir.v[1];
  if (needs_fwd) *reinterpret_cast<uint4*>(p.o_fwd + e0) = ofwd.v;
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
  const Planes p{static_cast<const uint8_t*>(seen), static_cast<const int16_t*>(ir),
                 static_cast<const uint8_t*>(rec), static_cast<const uint8_t*>(inc),
                 static_cast<const uint8_t*>(recp), static_cast<const uint8_t*>(fwd),
                 static_cast<const uint8_t*>(tx), static_cast<const uint8_t*>(fresh),
                 static_cast<const uint8_t*>(expired), static_cast<uint8_t*>(o_seen),
                 static_cast<int16_t*>(o_ir), static_cast<uint8_t*>(o_rec),
                 static_cast<uint8_t*>(o_fwd)};
  const long long threads = (total + kVec - 1) / kVec;
  const unsigned grid = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  round_tail_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int16_t*>(rnd16), static_cast<const int32_t*>(rnd32), total, m,
      forward_once, sir, needs_fwd, age_saturated);
  return static_cast<int>(cudaGetLastError());
}
