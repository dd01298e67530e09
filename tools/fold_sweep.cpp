// Exhaustive u32 inverse-property sweep for the fold and msb mappings.
//
// lane_ans counterpart of the reference's (unbuilt) src/test.cpp:49-72,
// which sweeps all 2^32 inputs checking undo(fold(x)) == x for every
// fidelity.  This tool re-expresses the mappings independently
// (reference semantics: ans_fold.hpp:38-65 fold, :150-175 undo;
// ans_msb.hpp:41-50, :156-176) and verifies, for every x in [0, 2^32):
//
//   * the exception count k matches the strip loop,
//   * the folded symbol id stays below the 2^(fidelity+9) alphabet bound,
//   * unmap(sym) reports exactly k exception bytes,
//   * high(sym) + (x & ((1 << 8k) - 1)) == x   (exact inverse).
//
// Build:  g++ -O3 -march=native -std=c++17 -pthread tools/fold_sweep.cpp
//         -o /tmp/fold_sweep
// Run:    /tmp/fold_sweep            (~1 min with 8 threads)
//
// The committed result of the one-shot run lives in
// tools/fold_sweep_result.txt; tests/test_primitives.py keeps the fast
// sampled version of the same property.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

static std::atomic<uint64_t> g_failures{0};

struct FoldParams {
  uint32_t thres;  // 1 << (fidelity + 7)
  uint32_t step;   // (1 << (fidelity - 1)) * 255
  uint32_t sigma;  // 1 << (fidelity + 9)
};

static inline void check_fold(uint32_t x, const FoldParams& p) {
  uint32_t v = x, k = 0;
  while (v >= p.thres) {  // strip loop (ans_fold.hpp:44-48)
    v >>= 8;
    ++k;
  }
  uint32_t sym = v + p.step * k;
  if (sym >= p.sigma) {
    ++g_failures;
    return;
  }
  // undo (ans_fold.hpp:150-161)
  uint32_t nb = sym >= p.thres ? (sym - p.thres) / p.step + 1 : 0;
  uint32_t high = sym >= p.thres ? (sym - p.step * nb) << (8 * nb) : sym;
  uint64_t mask = (nb ? ((1ull << (8 * nb)) - 1) : 0);
  if (nb != k || high + (x & mask) != x) ++g_failures;
}

static inline void check_msb(uint32_t x) {
  // mapping (ans_msb.hpp:41-50): NOTE the <= comparisons
  uint32_t sym, k;
  if (x <= 256) {
    sym = x;
    k = 0;
  } else if (x <= (1u << 16)) {
    sym = (x >> 8) + 256;
    k = 1;
  } else if (x <= (1u << 24)) {
    sym = (x >> 16) + 512;
    k = 2;
  } else {
    sym = (x >> 24) + 768;
    k = 3;
  }
  if (sym >= 1280) {
    ++g_failures;
    return;
  }
  // undo (ans_msb.hpp:156-176)
  uint32_t nb = (sym > 256) + (sym > 512) + (sym > 768);
  uint32_t high;
  if (sym <= 256)
    high = sym;
  else if (sym <= 512)
    high = (sym - 256) << 8;
  else if (sym <= 768)
    high = (sym - 512) << 16;
  else
    high = (sym - 768) << 24;
  uint64_t mask = (nb ? ((1ull << (8 * nb)) - 1) : 0);
  if (nb != k || high + (x & mask) != x) ++g_failures;
}

int main() {
  unsigned nthreads = std::thread::hardware_concurrency();
  if (!nthreads) nthreads = 4;
  for (int fid = 1; fid <= 8; ++fid) {
    FoldParams p{1u << (fid + 7), (1u << (fid - 1)) * 255u,
                 1u << (fid + 9)};
    g_failures = 0;
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < nthreads; ++t) {
      ts.emplace_back([=] {
        uint64_t lo = (uint64_t)t * (1ull << 32) / nthreads;
        uint64_t hi = (uint64_t)(t + 1) * (1ull << 32) / nthreads;
        for (uint64_t x = lo; x < hi; ++x) check_fold((uint32_t)x, p);
      });
    }
    for (auto& th : ts) th.join();
    uint64_t fails = g_failures.load();
    std::printf("fold fidelity=%d: %s (2^32 inputs, %llu failures)\n",
                fid, fails ? "FAIL" : "OK", (unsigned long long)fails);
    if (fails) return 1;
  }
  g_failures = 0;
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < nthreads; ++t) {
    ts.emplace_back([=] {
      uint64_t lo = (uint64_t)t * (1ull << 32) / nthreads;
      uint64_t hi = (uint64_t)(t + 1) * (1ull << 32) / nthreads;
      for (uint64_t x = lo; x < hi; ++x) check_msb((uint32_t)x);
    });
  }
  for (auto& th : ts) th.join();
  uint64_t fails = g_failures.load();
  std::printf("msb: %s (2^32 inputs, %llu failures)\n",
              fails ? "FAIL" : "OK", (unsigned long long)fails);
  return fails ? 1 : 0;
}
