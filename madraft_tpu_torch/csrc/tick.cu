// Kernel K6: a chunk of raft ticks for a batch of clusters, one launch,
// the tick's threefry words drawn inside it.
//
// Replaces the rest of the JAX reference's tick (B2-rest),
// madraft_tpu/tpusim/step.py step_cluster lines 293-960 and 1082-1156:
// faults, the five delivery passes, election win, timers, client
// injection, heartbeat and replication, commit advance, compaction and
// fsync; the oracle block (961-1081, kernel K2 on its own) runs inside it
// as device code, and so does the tick's draw (_DrawBlock.__init__,
// step.py:128, kernel K1's tick_blocks on its own). It runs m ticks in a
// row for every cluster; its variants add the metrics plane and the
// coverage fingerprint (below). The port's twin is
// tpusim/step.py step_cluster; the Python side is kernels/tick.py, which
// holds the plain version (the chunk's words drawn by
// threefry.tick_blocks_plain, that step looped over the chunk), and the
// device code is tick.cuh.
//
// Bound. Per chunk K6 reads the wide state once and writes it once (5477
// B a lane each way at n = 5, cap = 64), reads the cluster's key and knob
// rows (128 B): at B = 4096 that is 45.4 MB, 13.5 us at 3.35 TB/s. Its
// hashes take longer: each tick hashes total + 2 counter pairs (135 at n
// = 5; 41 ALU-pipe instructions a hash as ptxas issues threefry2x32, the
// adds going to the FMA pipe), 0.74 G operations a 32-tick chunk at B =
// 4096: 44 us at 64 lanes x 132 SMs x 1.98 GHz. So the operations bound
// it. The raft logic around them is not counted from the code and is
// left out of the bound; chip_smoke.py prints an estimate of it beside.
//
// Design. A first version (a warp a cluster, its words read from a K1
// buffer, runtime shapes, one lane walking each ring) was bound by each
// warp's dependent chain; once steps 1-3 below shortened the chain, the
// flagship's 31 warps an SM saturated the issue slots instead (clock64
// splits and 1-31 warp scaling runs in chip_smoke.py, PERF.md §6):
// - the cluster's state and knob rows are staged into shared memory at
//   the chunk's start and written back at its end, so device memory is
//   touched at chunk edges only;
// - 1. the tick's words are hashed into shared memory at the tick's start
//   by the cluster's lanes, from per-tick keys the lanes derive a tile's
//   width of ticks at a time; no draw buffer exists;
// - 2. the tick is a template on n, cap and an ae_max bound: the six
//   shapes the repository runs (n = 3, 5, 7; cap 16, 64; ae_max <= 4)
//   unroll their node, pair and slot loops, drop the divisions and find
//   every shared slot at a compile-time offset; a runtime instance serves
//   every other n <= 16, power-of-two cap <= 256;
// - 3. the ring scans take all the cluster's lanes (a lane per ring slot,
//   then a reduction), node values no other lane reads stay in registers
//   for the chunk, per-node flags go by ballot, fewer phases need a sync;
// - 4. every instance packs two clusters a warp, 16 lanes each (n <= 16),
//   so the node phases (n of the lanes busy) cost half the issue slots a
//   cluster, and the launch bounds cap a thread at 128 registers where
//   32 clusters an SM fit (more where a shape's shared blocks fit fewer:
//   blocks_per_sm), which holds every instance of every build free of
//   spills;
// - a block holds up to kWarps warps, as many as fit in shared memory
//   (dynamic, raised above 48 KB with cudaFuncSetAttribute).
// The profile build (-DMADRAFT_K6_PROFILE) adds tick_launch_profile, the
// same kernel with clock64() sums per phase group.
//
// Variants (B2-metrics, B2-coverage). -DMADRAFT_K6_METRICS builds K6-metrics:
// the tick with the metrics plane (reference step.py 748-760, 838-842,
// 886-889, the shadow record and fold 1008-1056, the event counters
// 1141-1153; the eager tick runs them with K2's metrics instance and K4).
// Only a delivery's stamps join the cluster's shared block (+80 B at n =
// 5, cap = 64, ae 4: 7040 B, so 4 blocks, 32 clusters, fit an SM and the
// 4096-cluster flagship runs in one wave). The stamp ring log_tick [n,
// cap] and the shadow's record stamps [cap] stay in the state's own rows
// in device memory (tick.cuh Stamps: 1.5 kB a cluster, in L2 at the
// flagship), read and written where the shared copies were, so the tick
// issues no more instructions for them; the latency is hidden by the
// other warps of an SM, which the tick keeps issue-bound (in the shared
// block the rings took it to 8576 B a cluster: 24 clusters an SM, and a
// second wave at 4096 took 42% of a launch's time). The fold's sums,
// histogram (a bucket a lane), event counts and worst-op register stay in
// registers and are written once at the chunk's end. Bound: the metric
// leaves add 1948 B a lane read and written at n = 5; the fold adds a few
// operations a ring slot a tick.
// -DMADRAFT_K6_COVERAGE builds K6-coverage: after each tick the cluster's
// coverage fingerprint (K5's function, coverage.cuh) and its seen-set
// stamp, atomicMin with the run-wide tick, and each lane-tick's flat
// index into fp [m, B]; credit_launch then counts the credits (the credit
// pass, tick.cuh credits()). A lane-tick credited at its own stamp would
// be wrong here: within a launch the warps run their ticks in no common
// order, so a later tick's stamp may land first. Bound: per lane-tick an
// atomic on the seen-set and a 4-byte fp write (4 MB for 256 ticks at B =
// 4096, read again by the credit pass with the stamps it names), about 40
// operations for the code and hash. Both flags give K6-metrics-coverage.
//
// K6-kv (B1 for kv: the reference's kv_step, madraft_tpu/tpusim/kv.py
// 407-423, the raft tick then _kv_service_tick 425-989, scanned by
// _kv_program 1226-1283; K9's function with K6's): -DMADRAFT_K6_KV (with
// -DMADRAFT_K6_METRICS, K6-metrics-kv) runs the kv service tick after
// every raft tick of the chunk, on the same tile (tick.cuh kv_tick, on
// kv.cuh's phase functions, which K9 runs a warp a cluster). The service
// leaves are staged into the cluster's block after K6's slots once a
// chunk and written back once (1.6 KB a cluster at the kv flagship's n =
// 5, cap = 64, 4 clients, 4 keys; 2.5 KB with metrics: 1024 clusters are
// about 8 an SM, so the chain, not shared memory, limits it); the raft
// leaves the service writes stay where K6 holds them (the log rows and
// log_len in the block, appended in place; durable_len and compact_floor
// in the node lane's registers; violations), and the clerks' metric sums
// and the worst-op register sit in the kv region until metric_rows
// writes the metric leaves once. Bound: per chunk K6's state and the
// service leaves read and written once, the keys and both knob tables
// (about 12 MB a 256-tick chunk at 1024 clusters, 4 us); per
// cluster-tick K6's 2 + total hashes and the service's 57, 41 ALU
// operations each (about 2 G operations, 0.12 ms): operations bound it.
// A run of T kv ticks is ceil(T / 256) launches, where K6 and K9 made two
// checked launches a tick.
//
// K6-ctrler (B1 for the shard controller: the reference's ctrler_step,
// madraft_tpu/tpusim/ctrler.py 576-591, the raft tick then
// _ctrler_service_tick 593-954, scanned by _ctrler_program 1151-1206;
// K10's function with K6's): -DMADRAFT_K6_CTRLER (with
// -DMADRAFT_K6_METRICS, K6-metrics-ctrler) runs the controller's service
// tick after every raft tick of the chunk, on the same tile (tick.cuh
// ctrler_tick, on ctrler.cuh's phase functions, which K10 runs a block a
// cluster). The service leaves are staged into the cluster's block after
// K6's slots once a chunk and written back once, but for the nodes' two
// [n, n_configs] history tables, which stay in the new state's rows in
// device memory (up to 16 KB each at n = 16 and 256 configs: the block
// could not hold them beside K6's at the largest shapes K10 takes; 480 B
// each at the flagship, read by a node's Query and its divergence check,
// written by a new config); an install's tick copies the snapshot tables
// first, since the sender's pre-tick snapshot is the one adopted. The
// raft leaves the service writes stay where K6 holds them, and the
// clerks' metric sums and the worst-op register sit in the ctrler region
// until metric_rows writes the metric leaves once, as in K6-kv. These
// builds add the template instance (5, 32), ctrler-fuzz's ring. Bound:
// per chunk K6's state and the service leaves read and written once, the
// keys and both knob tables; per cluster-tick K6's 2 + total hashes and
// the service's (the eight draw keys, the clerks' words), the shadow
// search and the restore's cells, and a rebalance a node's apply round
// and a walker step (chip_smoke.py _k6ctrler_timing counts this run's).
// A run of T ctrler ticks is ceil(T / 256) launches, where K6 and K10
// made two checked launches a tick.
//
// K6-shardkv (B1 for shardkv: the reference's shardkv_step,
// madraft_tpu/tpusim/shardkv.py 876-905, the groups' and the
// controller's raft ticks then _shardkv_service_tick 907-2140, scanned by
// _shardkv_program 2559-2618; K11's function with K6's):
// -DMADRAFT_K6_SHARDKV (with -DMADRAFT_K6_METRICS, K6-metrics-shardkv,
// whose service tick is K11-metrics') runs a deployment a block: its G
// group clusters and, in a controller mode, its controller cluster on
// tiles of the block (a copy tile where the count is odd), each tick their
// raft ticks, then K11's service tick over the block (tick.cuh
// run_deployment; shardkv.cuh's phases, K11's own code, with its mode a
// template parameter), m ticks a launch. The clusters' blocks sit in
// shared memory beside K11's region (in device memory where they do not
// fit: the largest shapes K11 takes); K11 stages its region from the new
// state's rows and writes it back every tick, in place
// (MADRAFT_STAGE_IN_PLACE: no TMA, coherent loads), so the tiles hand it
// the rows it reads and writes through those rows (tick.cuh skv_export,
// skv_import). The instances: (5, 64), the shardkv CLI's ring at the
// flagship's n, and the runtime one, in each of the three modes. Bound:
// per chunk the clusters' state and the service leaves read and written
// once, the keys, knob tables and schedule read once; per cluster-tick
// K6's hashes and per tick the service's operations on this run's data
// (chip_smoke.py _k6shardkv_timing). Restaging K11's region every tick is
// this design's cost, not the function's. A run of T shardkv ticks is
// ceil(T / 256) launches, where K6 (twice in a controller mode) and K11
// made two or three checked launches a tick.
//
// K6-trace (B10, the reference's traced scan, madraft_tpu/tpusim/trace.py
// 160-195, with its per-tick record _pack_rows / _deliveries / _record
// 108-158, kernel K8's function on its own): given a trace buffer, any
// build writes each tick's flight-recorder row from inside the chunk
// (tick.cuh record), so the traced replay of T ticks is ceil(T / 256)
// launches and no K8 launch. Off that path the buffer is null and the
// row costs one uniform branch a tick.
//
// In place or not: the kernel stages a cluster fully before it writes, so
// out may alias in; the wrapper writes one fresh allocation, because
// chip_smoke.py and the tests hold the input state beside the result.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#ifdef MADRAFT_K6_SHARDKV
// K11's service tick runs in place inside the chunk, K11-metrics' in the
// metrics build
#define MADRAFT_STAGE_IN_PLACE
#ifdef MADRAFT_K6_METRICS
#define MADRAFT_K11_METRICS
#endif
#endif
#include "tick.cuh"

namespace {

constexpr int kWarps = 4;              // warps a block at most
constexpr int kMaxShared = 227 * 1024; // dynamic shared memory a block

// The variant this file builds (see the header note)
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
// The service tick the build runs after each raft tick (tick.cuh Svc)
#if defined(MADRAFT_K6_KV) + defined(MADRAFT_K6_CTRLER) + \
        defined(MADRAFT_K6_SHARDKV) > 1
#error "one service a build"
#elif defined(MADRAFT_K6_KV)
constexpr int kSvc = k6::kSvcKv;
#elif defined(MADRAFT_K6_CTRLER)
constexpr int kSvc = k6::kSvcCtrler;
#else
constexpr int kSvc = k6::kNoSvc;
#endif
// The template instances of the build: the ctrler builds add (5, 32)
constexpr int kBuildShapes =
    kSvc == k6::kSvcCtrler ? k6::kCtrlerShapes : k6::kShapes;

// Lanes a cluster takes: k6::kTile (n <= 16), two clusters a warp
constexpr int kTile = k6::kTile;

// ---- the per-cluster kernel and its entries: every build but
// K6-shardkv's, which lays a deployment out a block (below)

// Blocks an SM should hold (the launch bounds): as many blocks of
// kWarps warps as a template instance's shared blocks let an SM hold
// (228 KB, 1 KB a block reserved), at most kMost (4: 32 clusters, what
// n = 5, cap = 64 fits); kMost for the runtime instance. That caps a
// thread at 128 registers where 4 blocks fit, and gives the shapes whose
// shared blocks fit fewer the registers that their occupancy leaves.
// K6-ctrler's service tick (a rebalance a node and on the walker's lane,
// the clerks' draws) spilled 4-104 bytes under 128 registers: its builds
// take kMost = 2 (16 clusters an SM, its flagship's 1024 clusters still
// one wave), 136-220 registers, no spill, the same time a launch (H100:
// 14.90 ms at the flagship against 14.76-14.95 with 4)
#ifndef MADRAFT_K6_SHARDKV
template <int N_, int CAP_, int AE_>
constexpr int blocks_per_sm() {
  constexpr int kMost = kSvc == k6::kSvcCtrler ? 2 : 4;
  if constexpr (N_ == 0) {
    return kMost;
  } else {
    const int per_block = kWarps * (k6::kWarp / kTile) *
                              k6::slot_offset(k6::kSlots, N_, CAP_, AE_,
                                              kMet) +
                          1024;
    const int fit = 228 * 1024 / per_block;
    return fit < 1 ? 1 : fit > kMost ? kMost : fit;
  }
}

template <int N_, int CAP_, int AE_, bool kProf>
__global__ void __launch_bounds__(kWarps * k6::kWarp,
                                  blocks_per_sm<N_, CAP_, AE_>())
    tick_chunk_kernel(const __grid_constant__ k6::Params p, long long *prof) {
  constexpr int kPerWarp = k6::kWarp / kTile;
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / k6::kWarp, lane = threadIdx.x % k6::kWarp;
  const int first = (blockIdx.x * (blockDim.x / k6::kWarp) + warp) * kPerWarp;
  if (first >= p.b) return;  // the whole warp leaves together
  const int tile = lane / kTile, b = first + tile;
  const bool active = b < p.b;  // else a copy of the last cluster, unwritten
  k6::run_cluster<N_, CAP_, AE_, kTile, kProf, kMet, kCov, kSvc>(
      p, smem + static_cast<size_t>(warp * kPerWarp + tile) * p.cluster_bytes,
      active ? b : p.b - 1, active, k6::Tile<kTile>{lane % kTile, tile * kTile},
      prof);
}

// Warps a block: as many clusters' shared memory as fits, at most kWarps
// warps (0 when not one warp's clusters fit); tile: lanes a cluster
int warps_a_block(const k6::Params &p, int tile) {
  const int warps = kMaxShared / (k6::kWarp / tile * p.cluster_bytes);
  return warps < kWarps ? warps : kWarps;
}

// Launches the instance on p, or with occ, launches nothing and writes
// the blocks an SM can hold (the occupancy API) there
template <int N_, int CAP_, int AE_, bool kProf>
int go(const k6::Params &p, cudaStream_t stream, long long *prof,
       int *occ = nullptr) {
  constexpr int kPerWarp = k6::kWarp / kTile;
  const int warps = warps_a_block(p, kTile);
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int shared = warps * kPerWarp * p.cluster_bytes;
  auto kernel = tick_chunk_kernel<N_, CAP_, AE_, kProf>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (occ)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occ, kernel, warps * k6::kWarp, shared));
  const int per_block = warps * kPerWarp;
  const int blocks = (p.b + per_block - 1) / per_block;
  kernel<<<blocks, warps * k6::kWarp, shared, stream>>>(p, prof);
  return static_cast<int>(cudaGetLastError());
}

template <int I, bool kProf>
int go_shape(const k6::Params &p, cudaStream_t stream, long long *prof,
             int *occ) {
  return go<k6::shape_n(I), k6::shape_cap(I), k6::kShapeAe, kProf>(
      p, stream, prof, occ);
}

// The instance that takes p's shape (launched, or its occupancy into occ)
template <bool kProf>
int dispatch(const k6::Params &p, cudaStream_t st, long long *prof,
             int *occ) {
  switch (k6::instance(p.n, p.cap, p.ae_max, kBuildShapes)) {
    case 1: return go_shape<0, kProf>(p, st, prof, occ);
    case 2: return go_shape<1, kProf>(p, st, prof, occ);
    case 3: return go_shape<2, kProf>(p, st, prof, occ);
    case 4: return go_shape<3, kProf>(p, st, prof, occ);
    case 5: return go_shape<4, kProf>(p, st, prof, occ);
    case 6: return go_shape<5, kProf>(p, st, prof, occ);
    case 7:
      if constexpr (kBuildShapes > k6::kShapes)
        return go_shape<6, kProf>(p, st, prof, occ);
      [[fallthrough]];
    default: return go<0, 0, 0, kProf>(p, st, prof, occ);
  }
}

// Checks the arguments, fills the parameters and launches the instance
// that takes the shape
template <bool kProf>
int launch(const int64_t *ins, const int64_t *outs, const int *kinds,
           int n_leaves, const void *keys, const void *kf, const void *ki,
           const int *draws, int n_draws, int b, int n, int cap, int ae_max,
           int m, int bug, int partitionable, const int64_t *mptrs,
           const int64_t *cov, void *trace, int trace_w, const int64_t *svc,
           int n_svc, void *stream, long long *prof) {
  if (n_leaves != k6::kLeaves || n_draws != k6::kDraws || b < 1 || m < 1 ||
      n < 1 || n > k6::kMaxNodes || cap < 1 || cap > k6::kMaxCap ||
      (cap & (cap - 1)) || ae_max < 0 || ae_max > k6::kMaxAe || bug < 0 ||
      bug > k6::kAckBeforeFsync || (kMet && m > k6::kMaxMetricTicks))
    return static_cast<int>(cudaErrorInvalidValue);
  k6::Params p;
  for (int l = 0; l < k6::kLeaves; ++l) {
    if (kinds[l] != k6::kLeafKind[l])
      return static_cast<int>(cudaErrorInvalidValue);
    p.kind[l] = kinds[l];
    p.in[l] = reinterpret_cast<const void *>(ins[l]);
    p.out[l] = reinterpret_cast<void *>(outs[l]);
  }
  const int inst = k6::instance(n, cap, ae_max, kBuildShapes);
  if (!k6::set_shape(p, n, cap, ae_max, inst ? k6::kShapeAe : ae_max, kMet,
                     draws) ||
      (mptrs != nullptr) != kMet || (cov != nullptr) != kCov ||
      !k6::set_variant(p, mptrs, cov) ||
      !k6::set_trace(p, trace, trace_w, kMet) ||
      !k6::set_service(p, svc, n_svc, partitionable, kMet, kSvc))
    return static_cast<int>(cudaErrorInvalidValue);
  p.keys = static_cast<const long long *>(keys);
  p.kf = static_cast<const float *>(kf);
  p.ki = static_cast<const int *>(ki);
  p.b = b;
  p.m = m;
  p.bug = bug;
  p.partitionable = partitionable;
  p.one = 1u;
  return dispatch<kProf>(p, static_cast<cudaStream_t>(stream), prof,
                         nullptr);
}

constexpr int kCreditThreads = 256;

// The credit pass after a K6-coverage launch: a thread a cluster adds its
// lane-ticks' credits (k6::credits) to new_fps
__global__ void __launch_bounds__(kCreditThreads)
    credit_kernel(const int *fp, const int *seen, int *new_fps, int b, int m,
                  int t0) {
  const int c = blockIdx.x * kCreditThreads + threadIdx.x;
  if (c < b) new_fps[c] += k6::credits(fp, seen, b, c, m, t0);
}
#endif  // MADRAFT_K6_SHARDKV

}  // namespace

#ifndef MADRAFT_K6_SHARDKV
// kinds: the wrapper's leaf table (shape class, + 8 for a bool leaf), held
// against the one compiled here; keys: [b, 2] int64-held u32 cluster keys;
// draws: each draw's offset in a tick's words, held against tick.cuh's;
// partitionable: the threefry counter layout; mptrs: the metric leaves'
// pointers in and out, then the spare stamp rows (the metrics variant's,
// else null); cov: the coverage arguments (the coverage variant's, else
// null: set_variant); trace: int32 [m, b, trace_w] rows, each tick's
// flight-recorder row (null: none; trace_w held against the row's width;
// a service build writes none); svc: a service build's descriptor of
// n_svc words (K6-kv's kv.cuh set_side, K6-ctrler's ctrler.cuh set_side;
// else null). Returns cudaGetLastError() after the launch.
extern "C" int tick_launch(const int64_t *ins, const int64_t *outs,
                           const int *kinds, int n_leaves, const void *keys,
                           const void *kf, const void *ki, const int *draws,
                           int n_draws, int b, int n, int cap, int ae_max,
                           int m, int bug, int partitionable,
                           const int64_t *mptrs, const int64_t *cov,
                           void *trace, int trace_w, const int64_t *svc,
                           int n_svc, void *stream) {
  return launch<false>(ins, outs, kinds, n_leaves, keys, kf, ki, draws,
                       n_draws, b, n, cap, ae_max, m, bug, partitionable,
                       mptrs, cov, trace, trace_w, svc, n_svc, stream,
                       nullptr);
}

// The credit pass: fp [m, b] the launch's flat seen indices (-1: none),
// seen the stamps after it, new_fps [b] += each cluster's credits
extern "C" int credit_launch(const void *fp, const void *seen, void *new_fps,
                             int b, int m, int t0, void *stream) {
  if (b < 1 || m < 1 || t0 < 0) return static_cast<int>(cudaErrorInvalidValue);
  credit_kernel<<<(b + kCreditThreads - 1) / kCreditThreads, kCreditThreads,
                  0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int *>(fp), static_cast<const int *>(seen),
      static_cast<int *>(new_fps), b, m, t0);
  return static_cast<int>(cudaGetLastError());
}

// The instance tick_launch runs for a shape in this build: 1 + its index
// in tick.cuh's shape list, 0 for the runtime one
extern "C" int tick_instance(int n, int cap, int ae_max) {
  return k6::instance(n, cap, ae_max, kBuildShapes);
}

// How tick_launch lays a shape's clusters out in this build: out[0]
// clusters a warp, out[1] warps a block, out[2] dynamic shared bytes a
// block, out[3] the blocks an SM holds (the occupancy API). Returns 0, or
// a CUDA error (cudaErrorInvalidValue for a shape it does not take)
extern "C" int tick_grid(int n, int cap, int ae_max, int *out) {
  if (n < 1 || n > k6::kMaxNodes || cap < 1 || cap > k6::kMaxCap ||
      (cap & (cap - 1)) || ae_max < 0 || ae_max > k6::kMaxAe)
    return static_cast<int>(cudaErrorInvalidValue);
  int draws[k6::kDraws];
  for (int i = 0; i < k6::kDraws; ++i) draws[i] = k6::draw_offset(i, n);
  const int inst = k6::instance(n, cap, ae_max, kBuildShapes);
  k6::Params p;
  k6::set_shape(p, n, cap, ae_max, inst ? k6::kShapeAe : ae_max, kMet,
                draws);
  out[0] = k6::kWarp / kTile;
  out[1] = warps_a_block(p, kTile);
  out[2] = out[1] * out[0] * p.cluster_bytes;
  if (out[1] < 1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<false>(p, nullptr, nullptr, out + 3);
}

#endif  // MADRAFT_K6_SHARDKV

#ifdef MADRAFT_K6_SHARDKV
namespace {

// A block: up to five warps, the tiles of eight groups and the
// controller's (K11's phases take its first k11::kThreads threads)
constexpr int kSkvThreads = 160;

template <int N_, int CAP_, int AE_, int M>
__global__ void __launch_bounds__(kSkvThreads, 2)
    shardkv_chunk_kernel(const k6::ShardKvParams *sp) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int c = blockIdx.x, tid = threadIdx.x;
  const size_t blocks = static_cast<size_t>(sp->tiles) * sp->g.cluster_bytes;
  const bool in_shared = sp->blocks == nullptr;
  int32_t *ws = reinterpret_cast<int32_t *>(smem + (in_shared ? blocks : 0));
  k6::run_deployment<N_, CAP_, AE_, kTile, kMet, M>(
      *sp, in_shared ? smem : sp->blocks + c * blocks, c, tid,
      [] { __syncthreads(); },
      [&](int phase) {
        if (tid < k11::kThreads)
          k11::run_phase<M>(sp->s, sp->s.plan, ws, nullptr, c, tid, phase);
      });
}

// Launches the instance for sp (its copy on the card at dev), or with
// occ, launches nothing and writes the blocks an SM can hold there
template <int N_, int CAP_, int AE_, int M>
int skv_go(const k6::ShardKvParams &sp, const k6::ShardKvParams *dev,
           cudaStream_t stream, int *occ) {
  auto kernel = shardkv_chunk_kernel<N_, CAP_, AE_, M>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sp.shared);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (occ)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occ, kernel, sp.threads, sp.shared));
  kernel<<<sp.b, sp.threads, sp.shared, stream>>>(dev);
  return static_cast<int>(cudaGetLastError());
}

template <int M>
int skv_mode(const k6::ShardKvParams &sp, const k6::ShardKvParams *dev,
             cudaStream_t stream, int *occ) {
  if (k6::shardkv_instance(sp.g.n, sp.g.cap, sp.g.ae_max))
    return skv_go<5, 64, k6::kShapeAe, M>(sp, dev, stream, occ);
  return skv_go<0, 0, 0, M>(sp, dev, stream, occ);
}

int skv_dispatch(const k6::ShardKvParams &sp, const k6::ShardKvParams *dev,
                 cudaStream_t stream, int *occ) {
  switch (sp.s.mode) {
    case k11::kSchedule: return skv_mode<k11::kSchedule>(sp, dev, stream, occ);
    case k11::kLive: return skv_mode<k11::kLive>(sp, dev, stream, occ);
    default: return skv_mode<k11::kComputed>(sp, dev, stream, occ);
  }
}

// The host copy of a launch's parameters (too large for a kernel's)
k6::ShardKvParams g_skv;

}  // namespace

// K6-shardkv: m deployment ticks of b deployments of `groups` groups. ga
// / ca: the group clusters' and (controller modes, else null) the
// controller clusters' arguments (tick.cuh kClusterArgs words: the leaves
// in and out, keys, knob tables, the metric leaves' pointers); kinds and
// draws as tick_launch takes them; desc: K11's descriptor (shardkv.cuh
// Desc), each service leaf's input the state in and its output the new
// state, the raft leaves' both the new clusters' rows. With scratch null
// writes the device scratch's bytes into *scratch_bytes and launches
// nothing; else copies the parameters into the scratch (of
// *scratch_bytes bytes) and launches. Returns a CUDA error, or
// cudaErrorInvalidValue for arguments the build does not take
extern "C" int shardkv_chunk_launch(const int64_t *ga, const int64_t *ca,
                                    const int *kinds, int n_leaves,
                                    const int *draws, int n_draws, int b,
                                    int groups, int n, int cap, int ae_max,
                                    int m, int bug, int partitionable,
                                    const int64_t *desc, int n_desc,
                                    void *scratch, int64_t *scratch_bytes,
                                    void *stream) {
  if (n_leaves != k6::kLeaves || n_draws != k6::kDraws ||
      !k6::set_shardkv(g_skv, ga, ca, kinds, draws, b, groups, n, cap,
                       ae_max, m, bug, partitionable, desc, n_desc, kMet))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = k6::shardkv_scratch(
      g_skv, static_cast<uint8_t *>(scratch), kMet, kMaxShared);
  if (!scratch) {
    *scratch_bytes = static_cast<int64_t>(bytes);
    return 0;
  }
  if (*scratch_bytes < static_cast<int64_t>(bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemcpyAsync(scratch, &g_skv, sizeof(g_skv),
                                        cudaMemcpyHostToDevice, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return skv_dispatch(g_skv, static_cast<const k6::ShardKvParams *>(scratch),
                      st, nullptr);
}

// How shardkv_chunk_launch lays these arguments out: out = [threads a
// block, deployments a block, dynamic shared bytes a block, blocks an SM
// holds (the occupancy API), 1 if the clusters' blocks are in shared
// memory]
extern "C" int shardkv_chunk_grid(const int64_t *ga, const int64_t *ca,
                                  const int *kinds, int n_leaves,
                                  const int *draws, int n_draws, int b,
                                  int groups, int n, int cap, int ae_max,
                                  int m, int bug, int partitionable,
                                  const int64_t *desc, int n_desc, int *out) {
  if (n_leaves != k6::kLeaves || n_draws != k6::kDraws ||
      !k6::set_shardkv(g_skv, ga, ca, kinds, draws, b, groups, n, cap,
                       ae_max, m, bug, partitionable, desc, n_desc, kMet))
    return static_cast<int>(cudaErrorInvalidValue);
  k6::shardkv_scratch(g_skv, nullptr, kMet, kMaxShared);
  out[0] = g_skv.threads;
  out[1] = 1;
  out[2] = g_skv.shared;
  out[4] = g_skv.shared > 4 * g_skv.s.words;  // the blocks beside the region
  return skv_dispatch(g_skv, nullptr, nullptr, out + 3);
}
#endif  // MADRAFT_K6_SHARDKV

#if defined(MADRAFT_K6_PROFILE) && !defined(MADRAFT_K6_SHARDKV)
// The profile build's entry: tick_launch, and each cluster's clock64()
// cycles per phase group summed over the chunk into prof [b, kPhases]
extern "C" int tick_launch_profile(const int64_t *ins, const int64_t *outs,
                                   const int *kinds, int n_leaves,
                                   const void *keys, const void *kf,
                                   const void *ki, const int *draws,
                                   int n_draws, int b, int n, int cap,
                                   int ae_max, int m, int bug,
                                   int partitionable, const int64_t *mptrs,
                                   const int64_t *cov, void *trace,
                                   int trace_w, const int64_t *svc,
                                   int n_svc, void *stream, void *prof) {
  return launch<true>(ins, outs, kinds, n_leaves, keys, kf, ki, draws,
                      n_draws, b, n, cap, ae_max, m, bug, partitionable,
                      mptrs, cov, trace, trace_w, svc, n_svc, stream,
                      static_cast<long long *>(prof));
}
#endif
