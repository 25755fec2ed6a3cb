// Kernel K9: the kv service tick of a batch of clusters, one tick, after
// the raft tick (K6).
//
// Replaces the JAX reference's service tick (queue B7),
// madraft_tpu/tpusim/kv.py _kv_service_tick (425-989): the deduped
// committed truth from the commit shadow, the apply machines' crash reset,
// compaction capture and snapshot install, apply_max rounds of the apply
// loop with the exactly-once, order and Get-observation logic, the
// exactly-once and agreement oracles, the clerks (acks, the stale-read
// oracle, open-loop arrivals, fresh ops with the Zipf key and the
// Get/Put/Append split, retries, hint routing, the bug-mode local serve),
// the submits appended at self-believed leaders one client after another,
// the hint replies and the await countdown, and the raft leaves the
// service writes (log_term, log_val, log_len, durable_len, violations,
// first_violation_tick, compact_floor). The tick's draws (fold_in(key, t),
// then the sites 8, 14 and 15) are hashed here, under either threefry
// layout. Built with -DMADRAFT_K9_METRICS (K9-metrics, kernels/kv.py
// variant) it also keeps the clerks' stamps, the open-loop stamp ring and
// the retry counters, and folds each acked op's latency into the cluster's
// histogram, its phase split (clerk_phase_matrix), the worst-op register
// and the per-key and per-client rows (B5': metrics.py fold_latencies_by,
// clerk_phase_matrix, kv.py 662-679 and 830-849). The Python side is
// kernels/kv.py, whose plain version is tpusim/kv.py _kv_service_tick; the
// device code is kv.cuh, whose phase functions K6-kv (tick.cu
// -DMADRAFT_K6_KV) runs too. Since K6-kv no kv run launches K9: it is the
// per-tick design K6-kv is held against, tested on its own.
//
// Bound. At the kv flagship's shape (B = 1024, n = 5, cap = 64, 4
// clients, 4 keys) the tick must read and write every service leaf and
// every raft leaf it writes but the two log rows (972 B a cluster, 2064 B
// with metrics), read the stepped raft leaves it reads, the pre-tick
// views, keys and knob rows (474 B), read the log_val slots its apply
// rounds reach (at most n * apply_max = 20 a cluster) and write the
// appended entries (at most 4, a term and a value each): about 2.4 KB a
// cluster, 2.5 MB a launch, 0.74 us at 3.35 TB/s (4.7 MB and 1.41 us with
// metrics). chip_smoke.py _kv_bytes counts this run's bytes, the slots and
// entries included. The operations are some 57 threefry hashes a cluster
// (about 41 integer operations each), the shadow and log scans and the
// apply rounds: about 0.2 us at the card's integer rate. So bytes bound
// it.
//
// Design. A warp a cluster, the tick in seven phases with a warp barrier
// after each (kv.cuh Phase). The lanes stage every leaf's row but the two
// log rows in the warp's region of shared memory, and copy the log rows
// to their outputs (the state is written out of place, so the pre-tick
// values the tick reads stay in the inputs: the install path adopts the
// PRE-tick snapshots after the compaction capture rewrote them, and the
// Get match reads the pre-tick clerk_seq). Then the lanes stride the
// shadow window's dedup (cap x cap compares), the clerks' shadow search
// (nc x cap) and the node tables (n x (2 nc + 2 nk) cells); a lane a node
// runs the apply rounds (sequential for a node, independent across
// nodes); a lane a clerk runs the clerks; one lane appends the submits,
// one client after another (client c's append reads the log_len client
// c - 1 moved); the lanes write the region back. A cluster's region is
// about 1.6 KB (2.5 KB with metrics) at the flagship's shape; a block of
// four clusters also keeps the leaf table there, since the copy loops
// read a leaf's fields at a runtime index.
//
// Where the time goes (the profile build, -DMADRAFT_K9_PROFILE: clock64()
// after each phase, read by kv_phase_cycles; chip_smoke.py kv_phases;
// PERF.md section 6): with
// about eight warps an SM, each running the code once, a warp's time is
// its chain of latencies, so the kernel is kept small and its loops
// rolled (unrolling the 49-leaf copy loops made it slower), the draws'
// hashes are functions called, not inlined, and the copies keep 8 leaves'
// loads in flight. Staging and writing back the 49 leaves take most of
// it. The log rows' copy (5 KB a cluster read and written) is traffic
// above the bound; K6-kv, which keeps the kv leaves in K6's block for a
// chunk and appends to the log rows in place, has neither.

#include <cstdint>
#include <cuda_runtime.h>

#include "kv.cuh"

namespace {

constexpr int kWarps = 4;                 // clusters a block, at most
constexpr int kSmemMax = 227 * 1024;      // shared bytes a block may take
constexpr int kSmemDefault = 48 * 1024;   // without the opt-in

#ifdef MADRAFT_K9_PROFILE
// The profile build: each phase's end in clock64() cycles from the warp's
// start, for the first kProfileClusters clusters of a launch
constexpr int kProfileClusters = 4096;
__device__ long long g_cycles[kProfileClusters][k9::kTickPhases];
#endif

__global__ void __launch_bounds__(kWarps * 32)
    kv_kernel(const __grid_constant__ k9::Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  k9::LeafRef *tab = reinterpret_cast<k9::LeafRef *>(smem);
  for (int l = threadIdx.x; l < k9::kLeaves; l += blockDim.x)
    tab[l] = p.leaf[l];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * (blockDim.x / 32) + warp;
  if (c >= p.b) return;  // the whole warp: no barrier waits on it
  int32_t *ws = reinterpret_cast<int32_t *>(smem + k9::kTableBytes) +
                warp * p.L.words;
#ifdef MADRAFT_K9_PROFILE
  const long long t0 = clock64();
#endif
#pragma unroll 1
  for (int phase = 0; phase < k9::kTickPhases; ++phase) {
    k9::run_phase(p, tab, ws, c, lane, phase);
    __syncwarp();
#ifdef MADRAFT_K9_PROFILE
    if (lane == 0 && c < kProfileClusters)
      g_cycles[c][phase] = clock64() - t0;
#endif
  }
}

}  // namespace

// desc: the wrapper's descriptor (kv.cuh Desc). Returns cudaGetLastError()
// after the launch, cudaErrorInvalidValue for a descriptor it does not take
// (another build's metrics flag among them) or a cluster's region past the
// shared memory a block may take
extern "C" int kv_launch(const int64_t *desc, int n_desc, void *stream) {
  k9::Params p;
  if (!k9::set_params(p, desc, n_desc))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = p.L.words * 4;
  if (k9::kTableBytes + bytes > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  int warps = kWarps;
  while (warps > 1 && k9::kTableBytes + warps * bytes > kSmemMax) --warps;
  const int smem = k9::kTableBytes + warps * bytes;
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kv_kernel<<<(p.b + warps - 1) / warps, warps * 32, smem,
              static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

#ifdef MADRAFT_K9_PROFILE
// The profile build's cycles of the last launch's first b clusters (at
// most kProfileClusters): out is [b, kTickPhases] int64 on the host
extern "C" int kv_phase_cycles(int64_t *out, int b) {
  if (b < 1 || b > kProfileClusters)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_cycles, sizeof(long long) * k9::kTickPhases * b));
}
#endif
