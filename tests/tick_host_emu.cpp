// K6's device code (madraft_tpu_torch/csrc/tick.cuh) built for the host, so
// that the CPU tests can run the kernel's own arithmetic: each cluster's
// warp is 32 std::threads, a barrier stands in for __syncwarp() and the
// warp collectives exchange through a buffer between two barriers. The
// entry point has tick_launch's signature (the stream is ignored) and runs
// the clusters one after another.
//
//   g++ -std=c++20 -O1 -ffp-contract=off -fPIC -shared
//       -I madraft_tpu_torch/csrc -o libtick_host.so tests/tick_host_emu.cpp
//
// (tests/test_torch_tick.py builds it so.)

#include <barrier>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __forceinline__ inline

namespace {

struct Warp {
  std::barrier<> *bar;
  unsigned *buf;
  int lane;
};
thread_local Warp warp;

}  // namespace

inline void __syncwarp(unsigned = 0xffffffffu) { warp.bar->arrive_and_wait(); }

template <typename Fold>
inline unsigned exchange(unsigned v, Fold fold) {
  warp.buf[warp.lane] = v;
  __syncwarp();
  const unsigned r = fold(warp.buf);
  __syncwarp();
  return r;
}

inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  return exchange(v, [](const unsigned *b) {
    unsigned r = 0;
    for (int i = 0; i < 32; ++i) r |= b[i];
    return r;
  });
}

inline int __reduce_add_sync(unsigned, int v) {
  const unsigned sum =
      exchange(static_cast<unsigned>(v), [](const unsigned *b) {
        unsigned r = 0;
        for (int i = 0; i < 32; ++i) r += b[i];
        return r;
      });
  return static_cast<int>(sum);
}

inline int __shfl_xor_sync(unsigned, int v, int m) {
  const int lane = warp.lane;
  const unsigned r = exchange(static_cast<unsigned>(v),
                              [&](const unsigned *b) { return b[lane ^ m]; });
  return static_cast<int>(r);
}

// -ffp-contract=off keeps these single roundings
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }

#include "tick.cuh"

extern "C" int tick_launch(const int64_t *ins, const int64_t *outs,
                           const int *kinds, int n_leaves, const void *words,
                           const void *kf, const void *ki, const int *draws,
                           int n_draws, int b, int n, int cap, int ae_max,
                           int m, int bug, void *) {
  if (n_leaves != k6::kLeaves || n_draws != k6::kDraws) return 1;
  k6::Params p;
  for (int l = 0; l < k6::kLeaves; ++l) {
    if (kinds[l] != k6::kLeafKind[l]) return 1;
    p.kind[l] = kinds[l];
    p.in[l] = reinterpret_cast<const void *>(ins[l]);
    p.out[l] = reinterpret_cast<void *>(outs[l]);
  }
  for (int i = 0; i < k6::kDraws; ++i) p.draw[i] = draws[i];
  p.words = static_cast<const long long *>(words);
  p.kf = static_cast<const float *>(kf);
  p.ki = static_cast<const int *>(ki);
  p.b = b;
  p.n = n;
  p.cap = cap;
  p.ae_max = ae_max;
  p.m = m;
  p.bug = bug;
  p.total = 11 * n + 3 + 3 * n * n;
  p.cluster_bytes = k6::layout(n, cap, ae_max, p.off);
  std::vector<uint8_t> block(p.cluster_bytes);
  for (int c = 0; c < b; ++c) {
    std::barrier<> bar(32);
    unsigned buf[32];
    std::vector<std::thread> lanes;
    for (int lane = 0; lane < 32; ++lane)
      lanes.emplace_back([&, lane] {
        warp = Warp{&bar, buf, lane};
        k6::run_cluster(p, block.data(), c, lane);
      });
    for (auto &x : lanes) x.join();
  }
  return 0;
}
