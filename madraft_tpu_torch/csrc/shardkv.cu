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
// Design. K10's (ctrler.cu): a warp a deployment, the tick in eleven
// phases with a warp barrier after each (shardkv.cuh Phase). The lanes
// stage every leaf's row but the log rows in the warp's region of shared
// memory and copy the log rows to their outputs (the state is written out
// of place, so the pre-tick values the tick reads stay in the inputs: the
// apply rounds read the pre-tick staging and clerk seqs, the clerks the
// pre-tick clerk rows). In a controller mode the controller walker is
// sequential on the last lane while four lanes draw the announcers'
// submits and targets; then a controller node a lane runs its replica's
// rebalance and its announcers' appends. The restore is computed a cell a
// thread from the inputs alone (the install adopts the sender's snapshot
// as its own reset and capture left it); an applier a lane runs its apply
// rounds while the last lane runs the walker (every group's entry of a
// step, then the freeze snapshots, then the phases, as the plain version
// orders them); a (group, shard) pair a lane runs the mailboxes (each
// pair owns every box cell it writes) and a group a lane its CONFIG gate
// and, in a controller mode, its Query mailboxes (the stale-read scan
// reads the queried node's log row from device memory); a clerk a lane
// runs the clerks, taking a Get's answer from the first round any applier
// gave one (the largest there); a node a lane runs its appends in order.

#include <cstdint>
#include <cuda_runtime.h>

#include "shardkv.cuh"

namespace {

constexpr int kWarps = 4;                 // deployments a block, at most
constexpr int kSmemMax = 227 * 1024;      // shared bytes a block may take
constexpr int kSmemDefault = 48 * 1024;   // without the opt-in

__global__ void __launch_bounds__(kWarps * 32)
    shardkv_kernel(const __grid_constant__ k11::Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  k11::LeafRef *tab = reinterpret_cast<k11::LeafRef *>(smem);
  for (int l = threadIdx.x; l < k11::kLeaves; l += blockDim.x)
    tab[l] = p.leaf[l];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * (blockDim.x / 32) + warp;
  if (c >= p.b) return;  // the whole warp: no barrier waits on it
  int32_t *ws = reinterpret_cast<int32_t *>(smem + k11::kTableBytes) +
                warp * p.words;
#pragma unroll 1
  for (int phase = 0; phase < k11::kTickPhases; ++phase) {
    k11::run_phase(p, tab, ws, c, lane, phase);
    __syncwarp();
  }
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
  const int bytes = p.words * 4;
  if (k11::kTableBytes + bytes > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  int warps = kWarps;
  while (warps > 1 && k11::kTableBytes + warps * bytes > kSmemMax) --warps;
  const int smem = k11::kTableBytes + warps * bytes;
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        shardkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  shardkv_kernel<<<(p.b + warps - 1) / warps, warps * 32, smem,
                   static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
