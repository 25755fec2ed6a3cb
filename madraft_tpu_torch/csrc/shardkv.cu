// Kernel K11: the shardkv service tick of a batch of deployments, one
// tick, after the raft tick of their groups (K6 over the B x G group
// clusters) and, in a controller mode, of their controller clusters (K6
// over the B controller clusters).
//
// Replaces the JAX reference's service tick (queues B9 and B9-rest),
// madraft_tpu/tpusim/shardkv.py _shardkv_service_tick (907-2140) in its
// three config modes, with _unpack (416-430), the freeze epochs
// (1172-1194) and _net_pair (1516-1527): the apply machines' crash reset,
// compaction capture and snapshot install, apply_max rounds of each
// (group, node) apply machine (Append / Put / Get with the per-shard dup
// tables, CONFIG with the freeze and pull phases, INSTALL from the staged
// payload, DELETE at its freeze epoch), the truth walker's walk_max steps
// over each group's commit shadow with the freeze snapshots and the
// install stall, the divergence, ownership and storage oracles, the
// leader views, the inter-group pull, staging and GC confirm mailboxes
// with their lossy delayed sends, the CONFIG advance gate, the clerks
// (acks, the read oracle, the re-learn and the WrongGroup re-query, the
// open-loop arrivals, fresh ops with the Zipf shard draw, retries,
// targets, the bug mode's local serve), the CONFIG, INSTALL, DELETE and
// client appends at each node in order, and the raft leaves the service
// writes (log_term, log_val, log_len, durable_len, compact_floor). In the
// live and computed controller modes (the mode is a descriptor field) also
// the controller branches (942-1084, 1093-1107, 1245-1275, 1365-1423,
// 1628-1726, 1944-1949): the controller walker over the stepped
// controller's commit shadow with its sticky stall, the live mode's
// first-committed announce per config, the computed mode's resolving flip
// and the 4A rebalance once per replica (ctrler.py _rebalance 270-343,
// ctrler.cuh rebalance) into the write-once map history and the canonical
// config, the announcers' appends to the controller's log, the Query
// mailboxes with the stale log-tail answer of bug_stale_ctrler_read, the
// adopted source in the CONFIG entries, and the walker's CTRL_STALE
// checks. The tick's draws (fold_in(key, t), then the sites 17, 18 and
// 20, and 22 in a controller mode) are hashed here, under either threefry
// layout. Built with -DMADRAFT_K11_METRICS (K11-metrics,
// kernels/shardkv.py variant) it also keeps the clerks' five stamps and
// folds each acked op's latency into the deployment's histogram, its
// five-phase split with the migration row (_shardkv_phase_matrix), the
// per-shard and per-client axes and the worst-op register (shardkv.py
// 1768-2118). The Python side is kernels/shardkv.py, whose plain version
// is tpusim/shardkv.py _shardkv_service_tick; the device code is
// shardkv.cuh.
//
// Bound. The tick must read and write every service leaf it writes and
// every raft leaf it writes but the two log rows, read the stepped raft
// rows, the pre-tick views, the schedule, keys and knob rows, read the
// log_val slots its apply rounds reach (at most G * n * apply_max a
// deployment) and the shadow slots its walker reaches (G * walk_max), and
// write the appended entries; in a controller mode likewise the
// controller's leaves and rows, the controller shadow slots its walker
// steps over and the shadow (and, under the stale-read bug, log) row of a
// controller node a Query reaches. chip_smoke.py _shardkv_bytes counts
// this run's bytes: at the shardkv flagship's shape (B = 1024, G = 3,
// n = 5, cap = 64, 10 shards, 4 clients, 6 configs) some 34 KB a
// deployment, the dup tables ([G, n, NS, NC], live and snapshot) and the
// mailboxes most of it. The operations (a threefry hash or four for each
// draw a send or a clerk makes, the apply rounds, the walker steps, a
// resolving slot's rebalance on each replica) come to well under that at
// the card's integer rate. So bytes bound it.
//
// Design. K10's (ctrler.cu): a block of kThreads threads a deployment (128;
// 96 for K11-metrics, whose folds spill at the 64 registers eight blocks of
// 128 leave a thread), the tick in eleven phases with a block barrier after
// each (shardkv.cuh Phase), one kernel instance a config mode (the
// schedule's carries no controller branch); the flagship's 1024 deployments
// are one wave (8 blocks an SM, 32 or 24 warps), so a launch's time is its
// slowest block's chain of phases. The stage issues every copy at once and
// waits once: the staged rows by stage.cuh's plan (TMA bulk copies for the
// aligned rows of 128 bytes or more, the dup tables among them, cp.async
// words for the other 4-byte rows, byte loads for the byte rows), the
// groups' and the controller's shadow windows and the schedule's owner maps
// by cp.async words, while the threads copy the log rows to their outputs in
// 16-byte quads (the controller's here, the groups' in the apply phase),
// stage the stepped raft rows and hash the tick's draw keys; the write-back
// stores the region the same way (the state is written out of place, so the
// pre-tick values the tick reads stay in the inputs: the apply rounds read
// the pre-tick staging and clerk seqs, the clerks the pre-tick clerk rows).
// In a controller mode the controller walker is sequential on the last
// thread over the staged controller shadow while four threads draw the
// announcers' submits and targets; then a controller node a thread runs its
// replica's rebalance (in registers, ctrler.cuh) and its announcers'
// appends. The restore is a cell a thread from the staged rows (a cell reads
// only itself) and, for an install, from the inputs (the sender's snapshot
// as its own reset and capture left it); an applier a thread runs its apply
// rounds while the warps between the appliers' and the last copy the groups'
// log rows to their outputs and hash the clerks' draws, and the last thread
// runs the walker over the staged shadows (every group's entry of a step,
// then the freeze snapshots, then the phases, as the plain version orders
// them; a step in which no group walks ends the walk); a (group, slot) pair
// a thread counts the controller's announces above a queried node's commit
// and, under the stale-read bug, the first log index of the asked announce
// (shared adds and mins), a (group, shard) pair a thread runs the mailboxes
// (each pair owns every box cell it writes) and a group a thread its CONFIG
// gate and Query mailboxes; a clerk a thread runs the clerks, taking a Get's
// answer from the first round any applier gave one (the largest there); a
// node a thread runs its appends in order.
//
// Where the time goes (the profile build, -DMADRAFT_K11_PROFILE:
// clock64() after each phase and the truth walker's own cycles, read by
// shardkv_phase_cycles; chip_smoke.py shardkv_phases; PERF.md section 6).

#include <cstdint>
#include <cuda_runtime.h>

#include "shardkv.cuh"

namespace {

constexpr int kSmemMax = 227 * 1024;      // shared bytes a block may take
constexpr int kSmemDefault = 48 * 1024;   // without the opt-in
// The blocks an SM must hold for the flagship's 1024 deployments to run
// in one wave on 132 SMs (the launch bounds cap the registers to fit them)
constexpr int kMinBlocks = 8;

#ifdef MADRAFT_K11_PROFILE
// The profile build, for the first kProfile deployments of a launch: the
// SM's clock64() at the block's start, at each phase's end, and at the
// walker thread's start and end of the apply phase (stored as read, so
// that no register holds a clock across the tick)
constexpr int kProfile = 4096;
constexpr int kProfileCols = k11::kTickPhases + 3;
__device__ long long g_cycles[kProfile][kProfileCols];
#endif

// One instance a config mode M (k11::Mode): the schedule's carries no
// controller branch
template <int M>
__global__ void __launch_bounds__(k11::kThreads, kMinBlocks)
    shardkv_kernel(const __grid_constant__ k11::Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar;
  k11::Plan *pl = reinterpret_cast<k11::Plan *>(smem);
  {
    const int32_t *src = reinterpret_cast<const int32_t *>(&p.plan);
    int32_t *dst = reinterpret_cast<int32_t *>(smem);
    for (int w = threadIdx.x; w < static_cast<int>(sizeof(k11::Plan)) / 4;
         w += k11::kThreads)
      dst[w] = src[w];
  }
  if (threadIdx.x == 0) stage::arm(&bar, p.plan.bulk_bytes);
  __syncthreads();
  const int tid = threadIdx.x, c = blockIdx.x;
  int32_t *ws = reinterpret_cast<int32_t *>(smem + k11::kPlanBytes);
#ifdef MADRAFT_K11_PROFILE
  if (tid == 0 && c < kProfile) g_cycles[c][k11::kTickPhases] = clock64();
#endif
#pragma unroll 1
  for (int phase = 0; phase < k11::kTickPhases; ++phase) {
#ifdef MADRAFT_K11_PROFILE
    if (phase == k11::kApply && tid == k11::kWalker && c < kProfile)
      g_cycles[c][k11::kTickPhases + 1] = clock64();
#endif
    k11::run_phase<M>(p, *pl, ws, &bar, c, tid, phase);
#ifdef MADRAFT_K11_PROFILE
    if (phase == k11::kApply && tid == k11::kWalker && c < kProfile)
      g_cycles[c][k11::kTickPhases + 2] = clock64();
#endif
    __syncthreads();
#ifdef MADRAFT_K11_PROFILE
    if (tid == 0 && c < kProfile) g_cycles[c][phase] = clock64();
#endif
  }
}

using Kernel = void (*)(const k11::Params);

Kernel kernel_of(int mode) {
  return mode == k11::kSchedule ? shardkv_kernel<k11::kSchedule>
         : mode == k11::kLive   ? shardkv_kernel<k11::kLive>
                                : shardkv_kernel<k11::kComputed>;
}

// The launch's shared bytes a block, after the opt-in above 48 KB; < 0 a
// CUDA error, 0 a region past what a block may take
int shared_bytes(const k11::Params &p) {
  const int smem = k11::kPlanBytes + p.words * 4;
  if (smem > kSmemMax) return 0;
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel_of(p.mode), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return -static_cast<int>(e);
  }
  return smem;
}

}  // namespace

// desc: the wrapper's descriptor (shardkv.cuh Desc). Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a
// descriptor it does not take (another build's metrics flag among them)
// or a deployment's region past the shared memory a block may take
extern "C" int shardkv_launch(const int64_t *desc, int n_desc, void *stream) {
  k11::Params p;
  if (!k11::set_params(p, desc, n_desc))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = shared_bytes(p);
  if (smem <= 0)
    return smem < 0 ? -smem : static_cast<int>(cudaErrorInvalidValue);
  kernel_of(p.mode)<<<p.b, k11::kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The launch's layout: out = [threads a block, deployments a block, shared
// bytes a block, blocks an SM holds (the occupancy API)]
extern "C" int shardkv_grid(const int64_t *desc, int n_desc, int *out) {
  k11::Params p;
  if (!k11::set_params(p, desc, n_desc))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = shared_bytes(p);
  if (smem <= 0)
    return smem < 0 ? -smem : static_cast<int>(cudaErrorInvalidValue);
  out[0] = k11::kThreads;
  out[1] = 1;
  out[2] = smem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 3, kernel_of(p.mode), k11::kThreads, smem));
}

#ifdef MADRAFT_K11_PROFILE
// The profile build's cycles of the last launch's first b deployments (at
// most kProfile): out is [b, kTickPhases + 1] int64 on the host, each
// phase's end from the block's start, then the walker's own cycles
extern "C" int shardkv_phase_cycles(int64_t *out, int b) {
  if (b < 1 || b > kProfile) return static_cast<int>(cudaErrorInvalidValue);
  static long long raw[kProfile][kProfileCols];
  const cudaError_t e = cudaMemcpyFromSymbol(
      raw, g_cycles, sizeof(long long) * kProfileCols * b);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int n = k11::kTickPhases;
  for (int c = 0; c < b; ++c) {
    for (int ph = 0; ph < n; ++ph)
      out[c * (n + 1) + ph] = raw[c][ph] - raw[c][n];
    out[c * (n + 1) + n] = raw[c][n + 2] - raw[c][n + 1];
  }
  return 0;
}
#endif
