// K11's device code (madraft_tpu_torch/csrc/shardkv.cuh) built for the
// host, so that the CPU tests run the kernel's own arithmetic:
// shardkv_launch has the kernel entry's C signature (the stream is
// ignored), so the wrapper's _launch drives this library as it drives the
// card's, each mode through its own instance of the device code. Within a
// phase of the tick a deployment's kThreads threads share only commutative
// updates, so they run one after another, a phase after another (the
// block barrier after each phase orders them so on the card); the
// staging's asynchronous copies are plain copies here.
//
//   g++ -std=c++20 -O1 -ffp-contract=off -fPIC -shared -pthread
//       [-DMADRAFT_K11_METRICS] -I madraft_tpu_torch/csrc
//       -o libshardkv_host.so tests/shardkv_host_emu.cpp
//
// (tests/_kernel_host.py build_shardkv builds it so.)

#include <cmath>
#include <cstdint>
#include <algorithm>
#include <vector>

#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))

#include "shardkv.cuh"

namespace {

template <int M>
void run(const k11::Params &p) {
  std::vector<int32_t> region(p.words);
  uint64_t bar = 0;
  for (int c = 0; c < p.b; ++c) {
    // shared memory starts undefined: a word the tick reads before it
    // writes it shows as a mismatch
    std::fill(region.begin(), region.end(), 0x5A5A5A5A);
    for (int phase = 0; phase < k11::kTickPhases; ++phase)
      for (int k = 0; k < k11::kThreads; ++k)  // odd deployments: reversed
        k11::run_phase<M>(p, p.plan, region.data(), &bar, c,
                          c % 2 ? k11::kThreads - 1 - k : k, phase);
  }
}

}  // namespace

extern "C" int shardkv_launch(const int64_t *desc, int n_desc, void *) {
  static k11::Params p;
  if (!k11::set_params(p, desc, n_desc)) return 1;
  switch (p.mode) {
    case k11::kSchedule: run<k11::kSchedule>(p); break;
    case k11::kLive: run<k11::kLive>(p); break;
    default: run<k11::kComputed>(p); break;
  }
  return 0;
}
