// K6's device code (madraft_tpu_torch/csrc/tick.cuh) built for the host, so
// that the CPU tests can run the kernel's own arithmetic, draws included:
// a warp is 32 std::threads (two clusters of 16 lanes in the template
// instances, tick.cuh kTile, one cluster in the runtime one, as in the
// kernel), a barrier stands in for __syncwarp() and the warp collectives
// exchange through a buffer between two barriers. tick_launch and
// credit_launch have the kernel entries' signatures (the stream is
// ignored); tick_launch picks the same template instance and runs the
// warps one after another (so a later warp's cluster stamps the coverage
// seen-set after an earlier warp's whole chunk: the order a credit rule
// must not depend on; a trace buffer gets each tick's row, K6-trace);
// tick_words draws a chunk's words as the kernel does. -DMADRAFT_K6_METRICS,
// -DMADRAFT_K6_COVERAGE, -DMADRAFT_K6_KV and -DMADRAFT_K6_CTRLER build the
// variants, as for tick.cu (the service phases of K6-kv and K6-ctrler,
// kv.cuh and ctrler.cuh, update the region with the shared atomics' twins
// below, MADRAFT_HOST_ATOMICS). -DMADRAFT_K6_SHARDKV builds K6-shardkv's
// shardkv_chunk_launch alone: a deployment's tiles as 16 lanes each of
// warps of 32 std::threads, a std::barrier the block's barrier, and K11's
// phases (whose threads share only commutative updates) run by thread 0
// for all of K11's threads one after another, reversed on odd
// deployments, as tests/shardkv_host_emu.cpp runs them:
//
//   g++ -std=c++20 -O1 -ffp-contract=off -fPIC -shared
//       -I madraft_tpu_torch/csrc -o libtick_host.so tests/tick_host_emu.cpp
//
// (tests/_tick_host.py builds it so.)

#include <algorithm>
#include <array>
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define MADRAFT_HOST_ATOMICS

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

inline unsigned __ballot_sync(unsigned, int pred) {
  return exchange(pred ? 1u : 0u, [](const unsigned *b) {
    unsigned r = 0;
    for (int i = 0; i < 32; ++i) r |= b[i] << i;
    return r;
  });
}

template <typename T>
inline T __shfl_sync(unsigned, T v, int src) {
  return static_cast<T>(exchange(static_cast<unsigned>(v),
                                 [&](const unsigned *b) { return b[src]; }));
}

inline int __shfl_xor_sync(unsigned, int v, int m) {
  const int lane = warp.lane;
  return static_cast<int>(exchange(
      static_cast<unsigned>(v), [&](const unsigned *b) { return b[lane ^ m]; }));
}

inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  return exchange(v, [](const unsigned *b) {
    unsigned r = 0;
    for (int i = 0; i < 32; ++i) r |= b[i];
    return r;
  });
}

inline unsigned __reduce_xor_sync(unsigned, unsigned v) {
  return exchange(v, [](const unsigned *b) {
    unsigned r = 0;
    for (int i = 0; i < 32; ++i) r ^= b[i];
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

inline int __reduce_min_sync(unsigned, int v) {
  return static_cast<int>(
      exchange(static_cast<unsigned>(v), [](const unsigned *b) {
        int r = static_cast<int>(b[0]);
        for (int i = 1; i < 32; ++i)
          r = static_cast<int>(b[i]) < r ? static_cast<int>(b[i]) : r;
        return static_cast<unsigned>(r);
      }));
}

inline int __reduce_max_sync(unsigned, int v) {
  return static_cast<int>(
      exchange(static_cast<unsigned>(v), [](const unsigned *b) {
        int r = static_cast<int>(b[0]);
        for (int i = 1; i < 32; ++i)
          r = static_cast<int>(b[i]) > r ? static_cast<int>(b[i]) : r;
        return static_cast<unsigned>(r);
      }));
}

// the lanes whose value equals this lane's (64-bit values in two rounds)
template <typename T>
inline unsigned __match_any_sync(unsigned, T v) {
  const auto u = static_cast<unsigned long long>(v);
  unsigned lo[32], hi[32];
  exchange(static_cast<unsigned>(u), [&](const unsigned *b) {
    for (int i = 0; i < 32; ++i) lo[i] = b[i];
    return 0u;
  });
  exchange(static_cast<unsigned>(u >> 32), [&](const unsigned *b) {
    for (int i = 0; i < 32; ++i) hi[i] = b[i];
    return 0u;
  });
  unsigned m = 0;
  for (int i = 0; i < 32; ++i)
    if (lo[i] == static_cast<unsigned>(u) &&
        hi[i] == static_cast<unsigned>(u >> 32))
      m |= 1u << i;
  return m;
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline int __clz(int x) {
  return x ? __builtin_clz(static_cast<unsigned>(x)) : 32;
}

// a tile's lanes add to one counter of their block
inline int atomicAdd(int *a, int v) {
  return std::atomic_ref<int>(*a).fetch_add(v);
}

// K6-kv's and K6-ctrler's lanes or and max into words of their region
inline int atomicOr(int *a, int v) {
  return std::atomic_ref<int>(*a).fetch_or(v);
}

inline int atomicMax(int *a, int v) {
  std::atomic_ref<int> r(*a);
  int old = r.load();
  while (v > old && !r.compare_exchange_weak(old, v)) {
  }
  return old;
}

// the two tiles of a warp stamp the seen-set from two threads
inline int atomicMin(int *a, int v) {
  std::atomic_ref<int> r(*a);
  int old = r.load();
  while (v < old && !r.compare_exchange_weak(old, v)) {
  }
  return old;
}

inline long long clock64() {
  return std::chrono::steady_clock::now().time_since_epoch().count();
}

// -ffp-contract=off keeps these single roundings
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }

#ifdef MADRAFT_K6_SHARDKV
#define MADRAFT_STAGE_IN_PLACE
#ifdef MADRAFT_K6_METRICS
#define MADRAFT_K11_METRICS
#endif
#endif
#include "tick.cuh"

namespace {

#ifdef MADRAFT_K6_METRICS
constexpr bool kMet = true;
#else
constexpr bool kMet = false;
#endif
#ifdef MADRAFT_K6_COVERAGE
constexpr bool kCov = true;
#else
constexpr bool kCov = false;
#endif
#if defined(MADRAFT_K6_KV)
constexpr int kSvc = k6::kSvcKv;
#elif defined(MADRAFT_K6_CTRLER)
constexpr int kSvc = k6::kSvcCtrler;
#else
constexpr int kSvc = k6::kNoSvc;
#endif
constexpr int kBuildShapes =
    kSvc == k6::kSvcCtrler ? k6::kCtrlerShapes : k6::kShapes;

#ifdef MADRAFT_K6_SHARDKV
// Deployment after deployment: its tiles' lanes as threads, K11's phases
// on thread 0 (see the header note)
template <int N_, int CAP_, int AE_, int M>
void run_skv(const k6::ShardKvParams &sp) {
  const size_t bytes = static_cast<size_t>(sp.tiles) * sp.g.cluster_bytes;
  std::vector<uint8_t> shared(bytes);
  std::vector<int32_t> region(sp.s.words);
  uint64_t bar = 0;
  const int warps = sp.threads / 32;
  for (int c = 0; c < sp.b; ++c) {
    // shared memory starts undefined: a word read before it is written
    // shows as a mismatch
    std::fill(region.begin(), region.end(), 0x5A5A5A5A);
    uint8_t *blocks = sp.blocks ? sp.blocks + c * bytes : shared.data();
    std::barrier<> block(sp.threads);
    std::vector<std::unique_ptr<std::barrier<>>> wbar;
    std::vector<std::array<unsigned, 32>> wbuf(warps);
    for (int w = 0; w < warps; ++w)
      wbar.push_back(std::make_unique<std::barrier<>>(32));
    std::vector<std::thread> lanes;
    for (int tid = 0; tid < sp.threads; ++tid)
      lanes.emplace_back([&, tid] {
        warp = Warp{wbar[tid / 32].get(), wbuf[tid / 32].data(), tid % 32};
        k6::run_deployment<N_, CAP_, AE_, k6::kTile, kMet, M>(
            sp, blocks, c, tid, [&] { block.arrive_and_wait(); },
            [&](int phase) {
              if (tid != 0) return;
              for (int k = 0; k < k11::kThreads; ++k)
                k11::run_phase<M>(sp.s, sp.s.plan, region.data(), &bar, c,
                                  c % 2 ? k11::kThreads - 1 - k : k, phase);
            });
      });
    for (auto &x : lanes) x.join();
  }
}

template <int M>
void run_skv_mode(const k6::ShardKvParams &sp) {
  if (k6::shardkv_instance(sp.g.n, sp.g.cap, sp.g.ae_max))
    run_skv<5, 64, k6::kShapeAe, M>(sp);
  else
    run_skv<0, 0, 0, M>(sp);
}

k6::ShardKvParams g_skv;
#endif

#ifndef MADRAFT_K6_SHARDKV
// Each warp of TILE-lane tiles in turn, as 32 threads: tile t of warp w
// runs body(c, active, tile, its block) on cluster c = w * (32 / TILE) + t,
// or on a copy of the last one when the batch ends first (as the kernel)
template <int TILE, typename Body>
void each_warp(const k6::Params &p, Body body) {
  constexpr int kPerWarp = 32 / TILE;
  std::vector<uint8_t> blocks(static_cast<size_t>(kPerWarp) * p.cluster_bytes);
  for (int first = 0; first < p.b; first += kPerWarp) {
    std::barrier<> bar(32);
    unsigned buf[32];
    std::vector<std::thread> lanes;
    for (int lane = 0; lane < 32; ++lane)
      lanes.emplace_back([&, lane] {
        warp = Warp{&bar, buf, lane};
        const int t = lane / TILE, c = first + t;
        body(c < p.b ? c : p.b - 1, c < p.b,
             k6::Tile<TILE>{lane % TILE, t * TILE},
             blocks.data() + static_cast<size_t>(t) * p.cluster_bytes);
      });
    for (auto &x : lanes) x.join();
  }
}

template <int N_, int CAP_, int AE_>
void run(const k6::Params &p) {
  constexpr int kTile = k6::kTile;
  each_warp<kTile>(p, [&](int c, bool active, const k6::Tile<kTile> &tile,
                          uint8_t *cl) {
    k6::run_cluster<N_, CAP_, AE_, kTile, false, kMet, kCov, kSvc>(
        p, cl, c, active, tile, nullptr);
  });
}

template <int I>
void run_shape(const k6::Params &p) {
  run<k6::shape_n(I), k6::shape_cap(I), k6::kShapeAe>(p);
}

template <int N_>
void words(const k6::Params &p, const int *t1, uint32_t *out) {
  constexpr int kTile = k6::kTile;
  each_warp<kTile>(p, [&](int c, bool active, const k6::Tile<kTile> &tile,
                          uint8_t *cl) {
    k6::draw_chunk<N_, kTile>(p, cl, c, t1[c], active, tile, out);
  });
}

}  // namespace

extern "C" int tick_launch(const int64_t *ins, const int64_t *outs,
                           const int *kinds, int n_leaves, const void *keys,
                           const void *kf, const void *ki, const int *draws,
                           int n_draws, int b, int n, int cap, int ae_max,
                           int m, int bug, int partitionable,
                           const int64_t *mptrs, const int64_t *cov,
                           void *trace, int trace_w, const int64_t *svc,
                           int n_svc, void *) {
  if (n_leaves != k6::kLeaves || n_draws != k6::kDraws) return 1;
  if ((mptrs != nullptr) != kMet || (cov != nullptr) != kCov) return 1;
  if (kMet && m > k6::kMaxMetricTicks) return 1;
  k6::Params p;
  if (!k6::set_variant(p, mptrs, cov)) return 1;
  for (int l = 0; l < k6::kLeaves; ++l) {
    if (kinds[l] != k6::kLeafKind[l]) return 1;
    p.kind[l] = kinds[l];
    p.in[l] = reinterpret_cast<const void *>(ins[l]);
    p.out[l] = reinterpret_cast<void *>(outs[l]);
  }
  const int inst = k6::instance(n, cap, ae_max, kBuildShapes);
  if (!k6::set_shape(p, n, cap, ae_max, inst ? k6::kShapeAe : ae_max, kMet,
                     draws) ||
      !k6::set_trace(p, trace, trace_w, kMet) ||
      !k6::set_service(p, svc, n_svc, partitionable, kMet, kSvc))
    return 1;
  p.keys = static_cast<const long long *>(keys);
  p.kf = static_cast<const float *>(kf);
  p.ki = static_cast<const int *>(ki);
  p.b = b;
  p.m = m;
  p.bug = bug;
  p.partitionable = partitionable;
  p.one = 1u;
  switch (inst) {
    case 1: run_shape<0>(p); break;
    case 2: run_shape<1>(p); break;
    case 3: run_shape<2>(p); break;
    case 4: run_shape<3>(p); break;
    case 5: run_shape<4>(p); break;
    case 6: run_shape<5>(p); break;
    case 7:
      if constexpr (kBuildShapes > k6::kShapes) {
        run_shape<6>(p);
        break;
      }
      [[fallthrough]];
    default: run<0, 0, 0>(p);
  }
  return 0;
}

extern "C" int tick_instance(int n, int cap, int ae_max) {
  return k6::instance(n, cap, ae_max, kBuildShapes);
}

extern "C" int credit_launch(const void *fp, const void *seen, void *new_fps,
                             int b, int m, int t0, void *) {
  if (b < 1 || m < 1 || t0 < 0) return 1;
  for (int c = 0; c < b; ++c)
    static_cast<int *>(new_fps)[c] += k6::credits(
        static_cast<const int *>(fp), static_cast<const int *>(seen), b, c, m,
        t0);
  return 0;
}

// keys [b, 2] int64-held u32, t1 [b] each cluster's first tick -> out
// [m, b, total] u32: the words run_cluster draws for those ticks in the
// instance tick_launch runs at (n, cap, ae_max)
extern "C" int tick_words(const void *keys, const int *t1, int b, int n,
                          int cap, int ae_max, int m, int partitionable,
                          void *out) {
  k6::Params p;
  int draws[k6::kDraws];
  for (int i = 0; i < k6::kDraws; ++i) draws[i] = k6::draw_offset(i, n);
  k6::set_shape(p, n, 16, 0, 0, false, draws);
  p.keys = static_cast<const long long *>(keys);
  p.b = b;
  p.m = m;
  p.partitionable = partitionable;
  p.one = 1u;
  auto *w = static_cast<uint32_t *>(out);
  const bool shaped = k6::instance(n, cap, ae_max) != 0;
  if (shaped && n == 5)
    words<5>(p, t1, w);
  else if (shaped && n == 3)
    words<3>(p, t1, w);
  else if (shaped && n == 7)
    words<7>(p, t1, w);
  else
    words<0>(p, t1, w);
  return 0;
}
#endif  // MADRAFT_K6_SHARDKV

#ifdef MADRAFT_K6_SHARDKV
}  // namespace

// tick.cu's shardkv_chunk_launch on the host: scratch is host memory
// (the parameters' room in it unused), the stream ignored
extern "C" int shardkv_chunk_launch(const int64_t *ga, const int64_t *ca,
                                    const int *kinds, int n_leaves,
                                    const int *draws, int n_draws, int b,
                                    int groups, int n, int cap, int ae_max,
                                    int m, int bug, int partitionable,
                                    const int64_t *desc, int n_desc,
                                    void *scratch, int64_t *scratch_bytes,
                                    void *) {
  if (n_leaves != k6::kLeaves || n_draws != k6::kDraws ||
      !k6::set_shardkv(g_skv, ga, ca, kinds, draws, b, groups, n, cap,
                       ae_max, m, bug, partitionable, desc, n_desc, kMet))
    return 1;
  const size_t bytes = k6::shardkv_scratch(
      g_skv, static_cast<uint8_t *>(scratch), kMet, 227 * 1024);
  if (!scratch) {
    *scratch_bytes = static_cast<int64_t>(bytes);
    return 0;
  }
  if (*scratch_bytes < static_cast<int64_t>(bytes)) return 1;
  g_skv.threads = g_skv.tiles * k6::kTile;  // the tiles' lanes
  switch (g_skv.s.mode) {
    case k11::kSchedule: run_skv_mode<k11::kSchedule>(g_skv); break;
    case k11::kLive: run_skv_mode<k11::kLive>(g_skv); break;
    default: run_skv_mode<k11::kComputed>(g_skv); break;
  }
  return 0;
}
#endif
