// Barabási–Albert preferential-attachment edge generator (C ABI).
//
// The reference's graph-construction intent (Seed.py:151-185 dead code /
// demonstrate_powerlaw.py:5-39) implemented correctly and at scale: growth
// is inherently sequential, so at 1M-10M nodes this loop dominates host-side
// setup time — hence C++ (the device protocol rounds never touch this).
//
// Degree-proportional sampling uses the repeated-endpoints array: a uniform
// index into the list of all edge endpoints selects a node with probability
// proportional to its degree. Same construction as the Python loop of
// tpu_gossip_torch/core/topology.py::preferential_attachment
// (use_native=False), though the two draw different numbers. A copy of the
// JAX package's tpu_gossip/native/csrc/pa_edges.cc: same seed, same edges.
//
// Exported symbol:
//   int64_t pa_edges(int64_t n, int64_t m, uint64_t seed,
//                    int64_t* out /* capacity*2 */, int64_t capacity);
// Returns the number of edge pairs written, or a negative error code.

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

// xoshiro256** — fast, high-quality, dependency-free PRNG
struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    // splitmix64 init
    uint64_t x = seed;
    for (auto& v : s) {
      x += 0x9e3779b97f4a7c15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      v = z ^ (z >> 31);
    }
  }
  static uint64_t rotl(uint64_t x, int k) { return (x << k) | (x >> (64 - k)); }
  uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  // uniform in [0, bound) without modulo bias (Lemire)
  uint64_t bounded(uint64_t bound) {
    uint64_t x = next();
    __uint128_t mu = static_cast<__uint128_t>(x) * bound;
    uint64_t lo = static_cast<uint64_t>(mu);
    if (lo < bound) {
      uint64_t threshold = (0ULL - bound) % bound;
      while (lo < threshold) {
        x = next();
        mu = static_cast<__uint128_t>(x) * bound;
        lo = static_cast<uint64_t>(mu);
      }
    }
    return static_cast<uint64_t>(mu >> 64);
  }
};

}  // namespace

extern "C" int64_t pa_edges(int64_t n, int64_t m, uint64_t seed,
                            int64_t* out, int64_t capacity) {
  if (n <= 0 || m <= 0 || n < m + 1 || out == nullptr) return -1;
  Rng rng(seed);

  std::vector<int64_t> endpoints;
  endpoints.reserve(2 * (static_cast<size_t>(m) * (m + 1) / 2 +
                         static_cast<size_t>(n - m - 1) * m));
  int64_t written = 0;
  auto emit = [&](int64_t a, int64_t b) -> bool {
    if (written >= capacity) return false;
    out[2 * written] = a;
    out[2 * written + 1] = b;
    ++written;
    endpoints.push_back(a);
    endpoints.push_back(b);
    return true;
  };

  // seed clique over the first m+1 nodes
  for (int64_t a = 0; a <= m; ++a)
    for (int64_t b = a + 1; b <= m; ++b)
      if (!emit(a, b)) return -2;

  // growth: each arriving node attaches m edges to m DISTINCT targets,
  // sampled with probability proportional to current degree
  std::vector<int64_t> targets;
  targets.reserve(m);
  for (int64_t v = m + 1; v < n; ++v) {
    targets.clear();
    while (static_cast<int64_t>(targets.size()) < m) {
      int64_t t = endpoints[rng.bounded(endpoints.size())];
      bool dup = false;
      for (int64_t u : targets)
        if (u == t) { dup = true; break; }
      if (!dup) targets.push_back(t);
    }
    for (int64_t t : targets)
      if (!emit(t, v)) return -2;
  }
  return written;
}
