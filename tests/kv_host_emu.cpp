// K9's device code (madraft_tpu_torch/csrc/kv.cuh) built for the host, so
// that the CPU tests run the kernel's own arithmetic: kv_launch has the
// kernel entry's C signature (the stream is ignored), so the wrapper's
// _launch drives this library as it drives the card's. Within a phase of
// the tick a cluster's 32 lanes share only commutative updates, so they
// run one after another, a phase after another (the warp barrier after
// each phase orders them so on the card).
//
//   g++ -std=c++20 -O1 -ffp-contract=off -fPIC -shared -pthread
//       [-DMADRAFT_K9_METRICS] -I madraft_tpu_torch/csrc
//       -o libkv_host.so tests/kv_host_emu.cpp
//
// (tests/_kernel_host.py build_kv builds it so.)

#include <cmath>
#include <cstdint>
#include <algorithm>
#include <vector>

#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))

#include "kv.cuh"

extern "C" int kv_launch(const int64_t *desc, int n_desc, void *) {
  static k9::Params p;
  if (!k9::set_params(p, desc, n_desc)) return 1;
  std::vector<int32_t> region(p.L.words);
  for (int c = 0; c < p.b; ++c) {
    // shared memory starts undefined: a word the tick reads before it
    // writes it shows as a mismatch
    std::fill(region.begin(), region.end(), 0x5A5A5A5A);
    for (int phase = 0; phase < k9::kTickPhases; ++phase)
      for (int k = 0; k < k9::kLanes; ++k)  // odd clusters: lanes reversed
        k9::run_phase(p, p.leaf, region.data(), c,
                      c % 2 ? k9::kLanes - 1 - k : k, phase);
  }
  return 0;
}
