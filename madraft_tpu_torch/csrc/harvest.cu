// Kernel K7: the pool harvest, retire -> ids -> keys -> snapshot -> refill
// -> fresh lanes, over the whole batch in two launches.
//
// Replaces the JAX reference's harvest programs (B4):
// madraft_tpu/tpusim/engine.py _harvest_program (837-884) with
// _retire_and_reseed (801-815), _lane_harvest_program (927-955) with
// _lane_reseed (886-898), _cov_harvest_program (1368-1409) with
// coverage.refill_knobs (coverage.py:195-244), and _fresh_batch (729-739),
// the init_cluster of the refilled lanes. The Python side is
// kernels/harvest.py, whose harvest_plain is the plain version; the device
// code is harvest.cuh.
//
// What a harvest computes, per lane of the chunk's wide state:
//   retired  = violations != 0 | tick >= horizon;
//   new id   = monotone: next_id + the lane's exclusive rank among the
//              retired lanes (a batch-wide scan), lane scheme: gen * B +
//              lane after gens += retired; kept lanes keep theirs;
//   new key  = fold_in(PRNGKey(seed), new id) for every lane;
//   snapshot = one int32 row [K]: the retire flag, the old id, the nine
//              scalars and the metric rows in engine._pool_snapshot's
//              column order, with coverage new_fps, kinds, the seen-set's
//              union popcount and the nine knob rows' bits, all as they
//              stood before the refill, so the host fetches it in one copy;
//   refill   = with guided coverage, a retired lane's nine knobs from
//              uniform(fold_in(PRNGKey(seed ^ COVG), new id), 9): the
//              parent times exp2((2u - 1) span) (XLA's Cephes expf, a
//              true FMA each step, __fmaf_rn) when it found fingerprints,
//              else base * (lo + u * width) as one FMA; clipped to [0, 1];
//              new_fps reset;
//   fresh    = a retired lane's init_cluster state written in place: every
//              leaf's constant, and the election timers randint(key, n,
//              eto_min, eto_max + 1) + i * eto_skew under its refilled row.
//
// Bound. At the flagship (B = 4096, n = 5, cap = 64, metrics off) when
// every lane retires, the harvest writes the fresh wide state (5477 B a
// lane), the snapshot, ids and keys, and reads the scalars it snapshots:
// about 22.6 MB, 6.7 us at 3.35 TB/s. Its hashes (a key, then 4 for each
// timer element; 18 more with coverage) are some 25 x 41 ALU operations a
// lane, 4.2 M at B = 4096: 0.25 us at the card's integer rate. So the
// bytes bound it; a harvest with few retired lanes writes little more
// than the snapshot and is launch-bound.
//
// Design. Two launches on the caller's stream, nothing copied from the
// host (the descriptor travels as the kernels' parameters):
// - ids_kernel, one block of 1024 threads: the monotone ranks as a ballot
//   and popcount a warp, the warps' totals in shared memory and a carry
//   from one 1024-lane tile to the next, so the ids count lanes left to
//   right across the whole batch; the lane scheme's generation bump; and
//   with coverage the seen-set's union popcount (one row at the flagship,
//   65536 stamps read once);
// - lane_kernel, a warp a lane: the threads share out the snapshot's
//   columns, then (a __syncwarp between) the refilled knobs (a thread a
//   knob) and the fresh state's elements, so a retired lane's rows are
//   written by neighbouring threads at neighbouring addresses. Every value
//   the second half needs it reads back from the snapshot row, so the
//   in-place refill never reads what it overwrote.
// The refill's float32 arithmetic is written with __fmul_rn, __fadd_rn and
// __fmaf_rn, which nvcc never contracts, so the product x * ln2 rounds
// before the exp and the scalings stay plain products. refill_grid_kernel
// evaluates the same device functions over every uniform the refill can
// draw (the 2^23 values k / 2^23), the card's half of the check against
// coverage.grid_sha256.

#include <cstdint>
#include <cuda_runtime.h>

#include "harvest.cuh"

namespace {

constexpr int kIdsThreads = 1024;
constexpr int kLaneWarps = 8;  // lanes a block of lane_kernel

__global__ void __launch_bounds__(kIdsThreads)
    ids_kernel(const __grid_constant__ k7::Params p) {
  __shared__ k7::IdsShared sh;
  k7::ids_block(p, sh, threadIdx.x, blockDim.x);
}

__global__ void __launch_bounds__(kLaneWarps * 32)
    lane_kernel(const __grid_constant__ k7::Params p) {
  const int lane = blockIdx.x * kLaneWarps + threadIdx.x / 32;
  if (lane >= p.b) return;
  const int t = threadIdx.x % 32;
  k7::read_lane(p, lane, t, 32);
  __syncwarp();
  k7::write_lane(p, lane, t, 32);
}

__global__ void refill_grid_kernel(const __grid_constant__ k7::Consts k,
                                   float *mut, float *fresh, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const float u = k7::uniform(static_cast<uint32_t>(i) << 9);
  mut[i] = k7::mutation_factor(u, k);
  fresh[i] = k7::fresh_factor(u, k);
}

}  // namespace

// desc: the wrapper's descriptor (harvest.cuh Desc), consts: the refill's
// float32 constants (k7::Consts). Returns cudaGetLastError() after the
// two launches, cudaErrorInvalidValue for a descriptor it does not take
extern "C" int harvest_launch(const int64_t *desc, int n_desc,
                              const float *consts, void *stream) {
  k7::Params p;
  if (!k7::set_params(p, desc, n_desc, consts))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ids_kernel<<<1, kIdsThreads, 0, s>>>(p);
  lane_kernel<<<(p.b + kLaneWarps - 1) / kLaneWarps, kLaneWarps * 32, 0, s>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

// The refill's two float32 factors over the uniforms k / 2^23, k < count
extern "C" int refill_grid_launch(const float *consts, void *mut,
                                  void *fresh, int count, void *stream) {
  if (count < 1 || count > (1 << 23))
    return static_cast<int>(cudaErrorInvalidValue);
  k7::Consts k;
  std::memcpy(&k, consts, sizeof(k));
  refill_grid_kernel<<<(count + 255) / 256, 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      k, static_cast<float *>(mut), static_cast<float *>(fresh), count);
  return static_cast<int>(cudaGetLastError());
}
