// Kernel K4: the metrics plane's latency fold for the PyTorch port.
//
// Replaces the JAX reference's madraft_tpu/tpusim/metrics.py fold_latencies,
// fold_phases and update_worst (lines 45-142), which its tick calls in a
// row on the commit latencies (ref step.py:1034-1053): one launch per tick
// over the batch does what the three do together. The Python side is
// madraft_tpu_torch/kernels/metrics.py; the plain versions are
// madraft_tpu_torch/tpusim/metrics.py. The signature is generic: any
// per-cluster vector of latencies with a mask, a phase matrix and the
// key/client/submit columns of each op, so the kv and shardkv clerks can
// fold through it too.
//
// Per cluster c, over its m ops (lat, mask, phases [P][m], keys, clients,
// subs) it updates, into fresh outputs:
//   lat_hist[16]      += one-hot of bucket(lat) over masked ops;
//   phase_hist[P][16] += the same for each phase row (a zero phase lands
//                        in bucket 0, so each row's mass is the acked count);
//   phase_ticks[P], lat_ticks += the masked sums (int32, wrapping);
//   the worst-op register: i = argmax over where(mask, lat, -1), lowest
//   index on ties; it replaces the register when some op is masked and
//   lat[i] > worst_lat or worst_sub == 0.
// bucket(x) is the count of the edges 2^1 .. 2^15 at or below x, computed
// as 31 - clz(x) clamped to [1, 15] for x >= 2, and 0 below.
//
// Bound: memory. At the flagship shape (B = 4096, m = 64, P = 4) a cluster
// reads 2112 B of ops and 372 B of registers and writes 372 B, 11.7 MB in
// all, 3.5 us at 3.35 TB/s. Design: a warp per cluster, eight to a block;
// each lane takes the ops lane, lane + 32, ...; a row's histogram is 16
// warp ballots per 32 ops, lane q keeping bucket q's count, so no shared
// memory and no atomics; the sums are warp reductions and the argmax a
// butterfly of (value, index) pairs. Outputs must not alias inputs.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBuckets = 16;  // config.HIST_BUCKETS
constexpr int kWarps = 8;     // clusters per block
constexpr unsigned kFull = 0xffffffffu;

struct FoldArgs {
  // ops: [B, m] (phases [B, P, m]); mask is one byte per op
  const int *lat, *phases, *keys, *clients, *subs;
  const uint8_t *mask;
  // registers in: [B, 16], [B, P, 16], [B, P], [B]; worst_* [B] / [B, P]
  const int *lat_hist, *phase_hist, *phase_ticks, *lat_ticks;
  const int *worst_lat, *worst_phases, *worst_key, *worst_client, *worst_sub;
  // registers out, same shapes
  int *lat_hist_out, *phase_hist_out, *phase_ticks_out, *lat_ticks_out;
  int *worst_lat_out, *worst_phases_out, *worst_key_out, *worst_client_out;
  int *worst_sub_out;
  int b, m, p;
};

__device__ __forceinline__ int bucket(int x) {
  return x < 2 ? 0 : min(31 - __clz(x), kBuckets - 1);
}

// One histogram row and its masked sum: hist_out[q] = hist_in[q] + the
// count of masked ops of vals in bucket q, for lane q < 16; returns the
// masked sum of vals (mod 2^32) on every lane.
__device__ __forceinline__ unsigned fold_row(const int *vals,
                                             const uint8_t *mask, int m,
                                             int lane, const int *hist_in,
                                             int *hist_out) {
  unsigned count = 0, sum = 0;
  for (int j0 = 0; j0 < m; j0 += 32) {
    const int i = j0 + lane;
    const bool ok = i < m && mask[i];
    const int v = ok ? vals[i] : 0;
    sum += static_cast<unsigned>(v);
    const int bk = ok ? bucket(v) : -1;
#pragma unroll
    for (int q = 0; q < kBuckets; ++q) {
      const unsigned hit = __popc(__ballot_sync(kFull, bk == q));
      if (lane == q) count += hit;
    }
  }
  if (lane < kBuckets)
    hist_out[lane] = static_cast<int>(
        static_cast<unsigned>(hist_in[lane]) + count);
  return __reduce_add_sync(kFull, sum);
}

__global__ void __launch_bounds__(kWarps * 32)
    latency_fold_kernel(const FoldArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  if (c >= a.b) return;  // whole warps leave together
  const int m = a.m, P = a.p;
  const int *lat = a.lat + c * m;
  const int *ph = a.phases + c * P * m;
  const uint8_t *mask = a.mask + c * m;

  // e2e row, then each phase row
  const unsigned lat_sum = fold_row(lat, mask, m, lane,
                                    a.lat_hist + c * kBuckets,
                                    a.lat_hist_out + c * kBuckets);
  for (int r = 0; r < P; ++r) {
    const int64_t row = c * P + r;
    const unsigned s = fold_row(ph + r * m, mask, m, lane,
                                a.phase_hist + row * kBuckets,
                                a.phase_hist_out + row * kBuckets);
    if (lane == 0)
      a.phase_ticks_out[row] =
          static_cast<int>(static_cast<unsigned>(a.phase_ticks[row]) + s);
  }
  if (lane == 0)
    a.lat_ticks_out[c] =
        static_cast<int>(static_cast<unsigned>(a.lat_ticks[c]) + lat_sum);

  // argmax over where(mask, lat, -1), lowest index on ties
  int best = INT_MIN, at = INT_MAX;
  unsigned any = 0;
  for (int i = lane; i < m; i += 32) {
    const int v = mask[i] ? lat[i] : -1;
    any |= mask[i];
    if (at == INT_MAX || v > best) {  // the lane's first op, then strict >
      best = v;
      at = i;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, at, off);
    if (ob > best || (ob == best && oi < at)) {
      best = ob;
      at = oi;
    }
  }
  any = __any_sync(kFull, any);
  const int held = a.worst_lat[c], held_sub = a.worst_sub[c];
  const int cand = lat[at];  // the raw latency at the argmax, as the reference
  const bool better = any && (cand > held || held_sub == 0);
  if (lane == 0) {
    a.worst_lat_out[c] = better ? cand : held;
    a.worst_key_out[c] = better ? a.keys[c * m + at] : a.worst_key[c];
    a.worst_client_out[c] = better ? a.clients[c * m + at] : a.worst_client[c];
    a.worst_sub_out[c] = better ? a.subs[c * m + at] : held_sub;
  }
  for (int r = lane; r < P; r += 32)
    a.worst_phases_out[c * P + r] =
        better ? ph[r * m + at] : a.worst_phases[c * P + r];
}

}  // namespace

extern "C" int latency_fold_launch(
    const void *lat, const void *mask, const void *phases, const void *keys,
    const void *clients, const void *subs, const void *lat_hist,
    const void *phase_hist, const void *phase_ticks, const void *lat_ticks,
    const void *worst_lat, const void *worst_phases, const void *worst_key,
    const void *worst_client, const void *worst_sub, void *lat_hist_out,
    void *phase_hist_out, void *phase_ticks_out, void *lat_ticks_out,
    void *worst_lat_out, void *worst_phases_out, void *worst_key_out,
    void *worst_client_out, void *worst_sub_out, int b, int m, int p,
    void *stream) {
  if (b < 0 || m < 1 || p < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  FoldArgs a;
  a.lat = static_cast<const int *>(lat);
  a.mask = static_cast<const uint8_t *>(mask);
  a.phases = static_cast<const int *>(phases);
  a.keys = static_cast<const int *>(keys);
  a.clients = static_cast<const int *>(clients);
  a.subs = static_cast<const int *>(subs);
  a.lat_hist = static_cast<const int *>(lat_hist);
  a.phase_hist = static_cast<const int *>(phase_hist);
  a.phase_ticks = static_cast<const int *>(phase_ticks);
  a.lat_ticks = static_cast<const int *>(lat_ticks);
  a.worst_lat = static_cast<const int *>(worst_lat);
  a.worst_phases = static_cast<const int *>(worst_phases);
  a.worst_key = static_cast<const int *>(worst_key);
  a.worst_client = static_cast<const int *>(worst_client);
  a.worst_sub = static_cast<const int *>(worst_sub);
  a.lat_hist_out = static_cast<int *>(lat_hist_out);
  a.phase_hist_out = static_cast<int *>(phase_hist_out);
  a.phase_ticks_out = static_cast<int *>(phase_ticks_out);
  a.lat_ticks_out = static_cast<int *>(lat_ticks_out);
  a.worst_lat_out = static_cast<int *>(worst_lat_out);
  a.worst_phases_out = static_cast<int *>(worst_phases_out);
  a.worst_key_out = static_cast<int *>(worst_key_out);
  a.worst_client_out = static_cast<int *>(worst_client_out);
  a.worst_sub_out = static_cast<int *>(worst_sub_out);
  a.b = b;
  a.m = m;
  a.p = p;
  const int grid = (b + kWarps - 1) / kWarps;
  latency_fold_kernel<<<grid, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
