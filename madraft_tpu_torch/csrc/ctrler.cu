// Kernel K10: the shard controller's service tick of a batch of clusters,
// one tick, after the raft tick (K6).
//
// Replaces the JAX reference's service tick (queue B8),
// madraft_tpu/tpusim/ctrler.py _ctrler_service_tick (593-954) with
// _apply_entry (382-463), _rebalance (270-343), _min_moves (345-360) and
// _hash_config (372-379): the apply machines' crash reset, compaction
// capture and snapshot install, apply_max rounds of the apply loop (Join /
// Leave with the closed-form canonical rebalance, Move, Query, the dedup
// table, the config history and its hashes, the balance and minimality
// oracles), the truth walker's walk_max steps over the commit shadow with
// its sticky stall, the divergence oracle, the clerks (acks, the Query
// answer and its oracle, fresh ops with the Query / Move / Join-Leave
// split and their args, retries, targets), the submits appended at
// self-believed leaders one clerk after another, and the raft leaves the
// service writes (log_term, log_val, log_len, durable_len, violations,
// first_violation_tick, compact_floor). The tick's draws (fold_in(key, t),
// then the sites 24 and 27) are hashed here, under either threefry layout.
// Built with -DMADRAFT_K10_METRICS (K10-metrics, kernels/ctrler.py
// variant) it also keeps the clerks' four stamps and folds each acked
// op's latency into the cluster's histogram, its phase split
// (clerk_phase_matrix) and the worst-op register (ctrler.py 750-795,
// 857-864, 897-901). The Python side is kernels/ctrler.py, whose plain
// version is tpusim/ctrler.py _ctrler_service_tick; the device code is
// ctrler.cuh, whose phase functions K6-ctrler (tick.cu
// -DMADRAFT_K6_CTRLER) runs too. Since K6-ctrler no ctrler run launches
// K10: it is the per-tick design K6-ctrler is held against, tested on its
// own.
//
// Bound. The tick must read and write every service leaf and every raft
// leaf it writes but the two log rows, read the stepped raft leaves it
// reads, the pre-tick views, keys and knob rows, read the log_val slots
// its apply rounds reach (at most n * apply_max a cluster) and write the
// appended entries (at most n_clients, a term and a value each).
// chip_smoke.py _ctrler_bytes counts this run's bytes. At the ctrler
// flagship's shape (B = 1024, n = 5, cap = 32, 4 clients, 5 gids, 24
// configs) that is about 4.3 KB a cluster, 4.4 MB a launch, 1.3 us at
// 3.35 TB/s; the config histories ([n, 24] live and snapshot, 960 B a
// cluster each way) are most of it. The operations (some 30 threefry
// hashes a clerk when a clerk starts an op, the shadow search, the apply
// rounds and walker steps with a rebalance each) come to well under that
// at the card's integer rate. So bytes bound it.
//
// Design. A block of kThreads (64) threads a cluster, the tick in six phases
// with a block barrier after each (ctrler.cuh Phase); a launch of the
// flagship's 1024 clusters is one wave (the launch bounds ask for 8 blocks
// an SM, 16 warps), so its time is its slowest block's chain of phases, the
// truth walker's chain of rebalances the longest. Blocks of 128 threads took
// the same time and spilled at the 64 registers eight of them leave a thread
// (PERF.md section 6). The stage issues every copy at once and waits once:
// the staged rows by the plan of stage.cuh (TMA bulk copies on the block's
// mbarrier for the aligned rows of 128 bytes or more, cp.async words for the
// other 4-byte rows, byte loads for the byte rows) and the shadow window by
// cp.async words, while the threads copy the two log rows to their outputs
// in 16-byte quads, stage the stepped raft rows and hash the tick's draw
// keys; the write-back stores the region the same way. The state is written
// out of place, so the pre-tick values the tick reads stay in the inputs;
// the restore reads the staged rows where a cell reads only itself and the
// input for an install (the PRE-tick snapshot of the sender), and the Query
// match reads the staged pre-tick clerk rows. Then the threads stride the
// clerks' shadow search (nc x cap) and the node tables' restore; a thread a
// node runs the apply rounds (sequential for a node, independent across
// nodes), each node noting the round it answered each clerk's Query, while
// the last thread (another warp's) runs the truth walker over the staged
// shadow; a thread a node checks the divergence oracle while a thread a
// clerk of the second warp runs the clerks, taking the Query answer of the
// first round any node gave one (the largest there); one thread appends the
// submits, one clerk after another. The rebalance and the minimal-move count
// (a Join or Leave's, the walker's chain of them its longest path) keep
// their per-gid and per-shard counts as nibble rows in registers
// (ctrler.cuh).
//
// Where the time goes (the profile build, -DMADRAFT_K10_PROFILE:
// clock64() after each phase and the walker's own cycles, read by
// ctrler_phase_cycles; chip_smoke.py ctrler_phases; PERF.md section 6).

#include <cstdint>
#include <cuda_runtime.h>

#include "ctrler.cuh"

namespace {

constexpr int kSmemMax = 227 * 1024;      // shared bytes a block may take
constexpr int kSmemDefault = 48 * 1024;   // without the opt-in
// The blocks an SM must hold for the flagship's 1024 clusters to run in
// one wave on 132 SMs (the launch bounds cap the registers to fit them)
constexpr int kMinBlocks = 8;

#ifdef MADRAFT_K10_PROFILE
// The profile build, for the first kProfile clusters of a launch: the
// SM's clock64() at the block's start, at each phase's end, and at the
// walker thread's start and end of the apply phase (stored as read, so
// that no register holds a clock across the tick)
constexpr int kProfile = 4096;
constexpr int kProfileCols = k10::kTickPhases + 3;
__device__ long long g_cycles[kProfile][kProfileCols];
#endif

__global__ void __launch_bounds__(k10::kThreads, kMinBlocks)
    ctrler_kernel(const __grid_constant__ k10::Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar;
  k10::Plan *pl = reinterpret_cast<k10::Plan *>(smem);
  {
    const int32_t *src = reinterpret_cast<const int32_t *>(&p.plan);
    int32_t *dst = reinterpret_cast<int32_t *>(smem);
    for (int w = threadIdx.x; w < static_cast<int>(sizeof(k10::Plan)) / 4;
         w += k10::kThreads)
      dst[w] = src[w];
  }
  if (threadIdx.x == 0) stage::arm(&bar, p.plan.bulk_bytes);
  __syncthreads();
  const int tid = threadIdx.x, c = blockIdx.x;
  int32_t *ws = reinterpret_cast<int32_t *>(smem + k10::kPlanBytes);
#ifdef MADRAFT_K10_PROFILE
  if (tid == 0 && c < kProfile) g_cycles[c][k10::kTickPhases] = clock64();
#endif
#pragma unroll 1
  for (int phase = 0; phase < k10::kTickPhases; ++phase) {
#ifdef MADRAFT_K10_PROFILE
    if (phase == k10::kApply && tid == k10::kWalker && c < kProfile)
      g_cycles[c][k10::kTickPhases + 1] = clock64();
#endif
    k10::run_phase(p, *pl, ws, &bar, c, tid, phase);
#ifdef MADRAFT_K10_PROFILE
    if (phase == k10::kApply && tid == k10::kWalker && c < kProfile)
      g_cycles[c][k10::kTickPhases + 2] = clock64();
#endif
    __syncthreads();
#ifdef MADRAFT_K10_PROFILE
    if (tid == 0 && c < kProfile) g_cycles[c][phase] = clock64();
#endif
  }
}

// The launch's shared bytes a block, after the opt-in above 48 KB; < 0 a
// CUDA error, 0 a region past what a block may take
int shared_bytes(const k10::Params &p) {
  const int smem = k10::kPlanBytes + p.L.words * 4;
  if (smem > kSmemMax) return 0;
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        ctrler_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return -static_cast<int>(e);
  }
  return smem;
}

}  // namespace

// desc: the wrapper's descriptor (ctrler.cuh Desc). Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a
// descriptor it does not take (another build's metrics flag among them)
// or a cluster's region past the shared memory a block may take
extern "C" int ctrler_launch(const int64_t *desc, int n_desc, void *stream) {
  k10::Params p;
  if (!k10::set_params(p, desc, n_desc))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = shared_bytes(p);
  if (smem <= 0)
    return smem < 0 ? -smem : static_cast<int>(cudaErrorInvalidValue);
  ctrler_kernel<<<p.b, k10::kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The launch's layout: out = [threads a block, clusters a block, shared
// bytes a block, blocks an SM holds (the occupancy API)]
extern "C" int ctrler_grid(const int64_t *desc, int n_desc, int *out) {
  k10::Params p;
  if (!k10::set_params(p, desc, n_desc))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = shared_bytes(p);
  if (smem <= 0)
    return smem < 0 ? -smem : static_cast<int>(cudaErrorInvalidValue);
  out[0] = k10::kThreads;
  out[1] = 1;
  out[2] = smem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 3, ctrler_kernel, k10::kThreads, smem));
}

#ifdef MADRAFT_K10_PROFILE
// The profile build's cycles of the last launch's first b clusters (at
// most kProfile): out is [b, kTickPhases + 1] int64 on the host, each
// phase's end from the block's start, then the walker's own cycles
extern "C" int ctrler_phase_cycles(int64_t *out, int b) {
  if (b < 1 || b > kProfile) return static_cast<int>(cudaErrorInvalidValue);
  static long long raw[kProfile][kProfileCols];
  const cudaError_t e = cudaMemcpyFromSymbol(
      raw, g_cycles, sizeof(long long) * kProfileCols * b);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int n = k10::kTickPhases;
  for (int c = 0; c < b; ++c) {
    for (int ph = 0; ph < n; ++ph)
      out[c * (n + 1) + ph] = raw[c][ph] - raw[c][n];
    out[c * (n + 1) + n] = raw[c][n + 2] - raw[c][n + 1];
  }
  return 0;
}
#endif
