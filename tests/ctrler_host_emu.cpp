// K10's device code (madraft_tpu_torch/csrc/ctrler.cuh) built for the
// host, so that the CPU tests run the kernel's own arithmetic:
// ctrler_launch has the kernel entry's C signature (the stream is
// ignored), so the wrapper's _launch drives this library as it drives the
// card's. Within a phase of the tick a cluster's kThreads threads share
// only commutative updates, so they run one after another, a phase after
// another (the block barrier after each phase orders them so on the
// card); the staging's asynchronous copies are plain copies here.
//
//   g++ -std=c++20 -O1 -ffp-contract=off -fPIC -shared -pthread
//       [-DMADRAFT_K10_METRICS] -I madraft_tpu_torch/csrc
//       -o libctrler_host.so tests/ctrler_host_emu.cpp
//
// (tests/_kernel_host.py build_ctrler builds it so.)

#include <cstdint>
#include <algorithm>
#include <vector>

#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))

#include "ctrler.cuh"

extern "C" int ctrler_launch(const int64_t *desc, int n_desc, void *) {
  static k10::Params p;
  if (!k10::set_params(p, desc, n_desc)) return 1;
  std::vector<int32_t> region(p.L.words);
  uint64_t bar = 0;
  for (int c = 0; c < p.b; ++c) {
    // shared memory starts undefined: a word the tick reads before it
    // writes it shows as a mismatch
    std::fill(region.begin(), region.end(), 0x5A5A5A5A);
    for (int phase = 0; phase < k10::kTickPhases; ++phase)
      for (int k = 0; k < k10::kThreads; ++k)  // odd clusters: reversed
        k10::run_phase(p, p.plan, region.data(), &bar, c,
                       c % 2 ? k10::kThreads - 1 - k : k, phase);
  }
  return 0;
}

// k10::rebalance and k10::min_moves on b instances of ng gids (member
// [b] bit masks, owner [b, kShards], tie_rot [b]), for the exhaustive
// test against the plain _rebalance / _min_moves: out [b, kShards],
// moves [b]
extern "C" int ctrler_rebalance_batch(int ng, int b, const int32_t *member,
                                      const int32_t *owner,
                                      const int32_t *tie_rot, int greedy,
                                      int reshuffle, int32_t *out,
                                      int32_t *moves) {
  if (ng < 1 || ng > k10::kMaxGids) return 1;
  for (int i = 0; i < b; ++i) {
    const uint32_t m = static_cast<uint32_t>(member[i]);
    const k10::Loads l = k10::loads_of(ng, m, owner + i * k10::kShards);
    const uint64_t next =
        k10::rebalance(ng, m, l, tie_rot[i], greedy != 0, reshuffle != 0);
    for (int s = 0; s < k10::kShards; ++s)
      out[i * k10::kShards + s] = k10::nib(next, s) - 1;
    moves[i] = k10::min_moves(ng, m, l);
  }
  return 0;
}
