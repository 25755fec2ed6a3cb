// Kernel K6: a chunk of raft ticks for a batch of clusters, one launch.
//
// Replaces the rest of the JAX reference's tick (B2-rest),
// madraft_tpu/tpusim/step.py step_cluster lines 293-960 and 1082-1156:
// faults, the five delivery passes, election win, timers, client
// injection, heartbeat and replication, commit advance, compaction and
// fsync; the oracle block (961-1081, kernel K2 on its own) runs inside it
// as device code. It runs m ticks in a row for every cluster with the
// metrics plane off. The port's twin is tpusim/step.py step_cluster; the
// Python side is kernels/tick.py, which holds the plain version (that
// step looped over the chunk), and the device code is tick.cuh.
//
// Bound. Per chunk K6 reads the wide state once and writes it once (5477
// B a lane each way at n = 5, cap = 64) and reads each tick's draw words
// (133 int64 words, 1064 B, a tick a cluster); the knob rows add 112 B a
// lane. At B = 4096 and m = 32 that is 4096 x (2 x 5477 + 112 + 32 x 1064)
// = 184.8 MB a chunk, 55.2 us at 3.35 TB/s, so 1.72 us a tick. Its
// integer work is about 11600 32-bit operations a cluster a tick at n = 5
// (the oracle's pair scan, 10 pairs x 64 lanes x ~8; the shadow walk,
// compaction and the AppendEntries hint, 5 x 64 x ~15; the deliveries and
// sends, ~60 n^2): 4096 x 32 x 11620 = 1.52 G operations a chunk, 22.7 us
// at 67 T/s. The bytes bound it: 55.2 us a chunk.
//
// Design, for correctness first:
// - one warp per cluster; the cluster's state and knob rows are staged
//   into shared memory at the chunk's start and written back at its end,
//   so device memory is touched at chunk edges and by the draw words;
// - inside a tick lanes stride over nodes, the [n, n] pairs and the cap
//   ring slots, with __syncwarp() between phases (tick.cuh); serial steps
//   (the crash budget's running count, the first live leader, the commit
//   rank) run on each node's lane over the n nodes;
// - a block holds up to kWarps clusters, as many as fit in shared memory
//   (dynamic, raised above 48 KB with cudaFuncSetAttribute);
// - the node count, ring size and bug are runtime values: one kernel
//   serves every n <= 16 and power-of-two cap <= 256.
// What this design leaves: most lanes idle in the per-node phases (5 of
// 32 at n = 5), the per-tick words read from device memory, and K1's
// int64 words themselves (ROADMAP: threefry inside K6).
//
// In place or not: the kernel stages a cluster fully before it writes, so
// out may alias in; the wrapper writes one fresh allocation, because
// chip_smoke.py and the tests hold the input state beside the result.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "tick.cuh"

namespace {

constexpr int kWarps = 4;              // clusters a block at most
constexpr int kMaxShared = 227 * 1024; // dynamic shared memory a block

__global__ void __launch_bounds__(kWarps * k6::kWarp)
    tick_chunk_kernel(const __grid_constant__ k6::Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / k6::kWarp, lane = threadIdx.x % k6::kWarp;
  const int b = blockIdx.x * (blockDim.x / k6::kWarp) + warp;
  if (b >= p.b) return;  // the whole warp leaves together
  k6::run_cluster(p, smem + static_cast<size_t>(warp) * p.cluster_bytes, b,
                  lane);
}

}  // namespace

// kinds: the wrapper's leaf table (shape class, + 8 for a bool leaf), held
// against the one compiled here; draws: each draw's offset in a tick's
// words. Returns cudaGetLastError() after the launch.
extern "C" int tick_launch(const int64_t *ins, const int64_t *outs,
                           const int *kinds, int n_leaves, const void *words,
                           const void *kf, const void *ki, const int *draws,
                           int n_draws, int b, int n, int cap, int ae_max,
                           int m, int bug, void *stream) {
  if (n_leaves != k6::kLeaves || n_draws != k6::kDraws || b < 1 || m < 1 ||
      n < 1 || n > k6::kMaxNodes || cap < 1 || cap > k6::kMaxCap ||
      (cap & (cap - 1)) || ae_max < 0 || ae_max > k6::kMaxAe || bug < 0 ||
      bug > k6::kAckBeforeFsync)
    return static_cast<int>(cudaErrorInvalidValue);
  k6::Params p;
  for (int l = 0; l < k6::kLeaves; ++l) {
    if (kinds[l] != k6::kLeafKind[l])
      return static_cast<int>(cudaErrorInvalidValue);
    p.kind[l] = kinds[l];
    p.in[l] = reinterpret_cast<const void *>(ins[l]);
    p.out[l] = reinterpret_cast<void *>(outs[l]);
  }
  for (int i = 0; i < k6::kDraws; ++i) p.draw[i] = draws[i];
  p.words = static_cast<const long long *>(words);
  p.kf = static_cast<const float *>(kf);
  p.ki = static_cast<const int *>(ki);
  p.b = b;
  p.n = n;
  p.cap = cap;
  p.ae_max = ae_max;
  p.m = m;
  p.bug = bug;
  p.total = 11 * n + 3 + 3 * n * n;  // step._block_total
  p.cluster_bytes = k6::layout(n, cap, ae_max, p.off);
  int warps = kMaxShared / p.cluster_bytes;
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  warps = warps < kWarps ? warps : kWarps;
  const int shared = warps * p.cluster_bytes;
  cudaError_t e = cudaFuncSetAttribute(
      tick_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (b + warps - 1) / warps;
  tick_chunk_kernel<<<blocks, warps * k6::kWarp, shared,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
