// K7's and K8's device code (madraft_tpu_torch/csrc/harvest.cuh and
// trace.cuh) built for the host, so that the CPU tests run the kernels' own
// arithmetic: harvest_launch, refill_grid_launch and record_launch have the
// kernel entries' C signatures (the stream is ignored), so the wrappers'
// _launch drives this library as it drives the card's.
//
// The per-lane device functions exchange nothing between a lane's threads
// but memory, so a lane's threads run one after another here, each phase
// for all of them before the next (as the warp barrier orders them on the
// card). ids_block, the batch-wide scan, runs on std::threads: a block of
// harvest_host_threads() threads (64 by default: two warps, so the
// warps' totals and the carry from tile to tile are exercised), a barrier
// for __syncthreads() and for a ballot's exchange.
//
//   g++ -std=c++20 -O1 -ffp-contract=off -fPIC -shared
//       -I madraft_tpu_torch/csrc -o libkernel_host.so
//       tests/kernel_host_emu.cpp
//
// (tests/_kernel_host.py builds it so.)

#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __forceinline__ inline

namespace {

struct Block {
  std::barrier<> *bar;
  unsigned *buf;
  int tid;
};
thread_local Block block;
int host_threads = 64;

}  // namespace

inline void __syncthreads() { block.bar->arrive_and_wait(); }

inline unsigned __ballot_sync(unsigned, int pred) {
  block.buf[block.tid] = pred ? 1u : 0u;
  __syncthreads();
  const int w0 = block.tid / 32 * 32;
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= block.buf[w0 + i] << i;
  __syncthreads();
  return r;
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }

inline int atomicAdd(int *at, int v) {
  return __atomic_fetch_add(at, v, __ATOMIC_SEQ_CST);
}

#include "harvest.cuh"
#include "trace.cuh"

extern "C" void harvest_host_threads(int t) { host_threads = t; }

extern "C" int harvest_launch(const int64_t *desc, int n_desc,
                              const float *consts, void *) {
  static k7::Params p;  // large: off the stack
  if (!k7::set_params(p, desc, n_desc, consts)) return 1;
  const int T = host_threads;
  std::barrier<> bar(T);
  std::vector<unsigned> buf(T);
  k7::IdsShared sh;
  std::vector<std::thread> threads;
  for (int tid = 0; tid < T; ++tid)
    threads.emplace_back([&, tid] {
      block = {&bar, buf.data(), tid};
      k7::ids_block(p, sh, tid, T);
    });
  for (auto &th : threads) th.join();
  for (int lane = 0; lane < p.b; ++lane) {
    for (int t = 0; t < 32; ++t) k7::read_lane(p, lane, t, 32);
    for (int t = 0; t < 32; ++t) k7::write_lane(p, lane, t, 32);
  }
  return 0;
}

extern "C" int refill_grid_launch(const float *consts, void *mut,
                                  void *fresh, int count, void *) {
  if (count < 1 || count > (1 << 23)) return 1;
  k7::Consts k;
  std::memcpy(&k, consts, sizeof(k));
  for (int i = 0; i < count; ++i) {
    const float u = k7::uniform(static_cast<uint32_t>(i) << 9);
    static_cast<float *>(mut)[i] = k7::mutation_factor(u, k);
    static_cast<float *>(fresh)[i] = k7::fresh_factor(u, k);
  }
  return 0;
}

extern "C" int record_launch(const int64_t *desc, int n_desc, void *) {
  static k8::Params p;
  if (!k8::set_params(p, desc, n_desc)) return 1;
  for (int c = 0; c < p.b; ++c)
    for (int t = 0; t < 32; ++t) k8::record_cluster(p, c, t, 32);
  return 0;
}
