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
// ctrler.cuh.
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
// Design. K9's (kv.cu): a warp a cluster, the tick in six phases with a
// warp barrier after each (ctrler.cuh Phase). The lanes stage every
// leaf's row but the two log rows in the warp's region of shared memory,
// and copy the log rows to their outputs (the state is written out of
// place, so the pre-tick values the tick reads stay in the inputs: the
// install path adopts the PRE-tick snapshots after the compaction capture
// rewrote them, and the Query match reads the pre-tick clerk_seq). Then
// the lanes stride the clerks' shadow search (nc x cap) and the node
// tables' restore (n x (nc + ng + 10 + 1 + n_configs) cells); a lane a
// node runs the apply rounds (sequential for a node, independent across
// nodes), each node noting the round it answered each clerk's Query, while
// the last lane runs the truth walker (sequential over the shadow); a
// lane a node checks the divergence oracle and a lane a clerk runs the
// clerks, taking the Query answer of the first round any node gave one
// (the largest there); one lane appends the submits, one clerk after
// another; the lanes write the region back. The rebalance runs on a
// lane's registers over the 10 shards and at most 10 gids.

#include <cstdint>
#include <cuda_runtime.h>

#include "ctrler.cuh"

namespace {

constexpr int kWarps = 4;                 // clusters a block, at most
constexpr int kSmemMax = 227 * 1024;      // shared bytes a block may take
constexpr int kSmemDefault = 48 * 1024;   // without the opt-in

__global__ void __launch_bounds__(kWarps * 32)
    ctrler_kernel(const __grid_constant__ k10::Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  k10::LeafRef *tab = reinterpret_cast<k10::LeafRef *>(smem);
  for (int l = threadIdx.x; l < k10::kLeaves; l += blockDim.x)
    tab[l] = p.leaf[l];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * (blockDim.x / 32) + warp;
  if (c >= p.b) return;  // the whole warp: no barrier waits on it
  int32_t *ws = reinterpret_cast<int32_t *>(smem + k10::kTableBytes) +
                warp * p.words;
#pragma unroll 1
  for (int phase = 0; phase < k10::kTickPhases; ++phase) {
    k10::run_phase(p, tab, ws, c, lane, phase);
    __syncwarp();
  }
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
  const int bytes = p.words * 4;
  if (k10::kTableBytes + bytes > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  int warps = kWarps;
  while (warps > 1 && k10::kTableBytes + warps * bytes > kSmemMax) --warps;
  const int smem = k10::kTableBytes + warps * bytes;
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        ctrler_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ctrler_kernel<<<(p.b + warps - 1) / warps, warps * 32, smem,
                  static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
