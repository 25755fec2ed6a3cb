// Kernel K8: the flight recorder's row for one tick, from a cluster's
// state before and after it.
//
// Replaces the JAX reference's per-tick record (B10),
// madraft_tpu/tpusim/trace.py _pack_rows (108), _deliveries (115-136) and
// _record (138-158), which its traced scan emits after every step. The
// Python side is kernels/trace.py, whose record_plain is the plain version;
// the device code is trace.cuh. One row a cluster, int32, in TickRecord's
// field order: the post-tick node rows (role, term, commit, log_len, base,
// durable_len, alive as 0 / 1), the adjacency as n row bitmasks, the five
// exact delivery counts (a slot due this tick, its destination alive and
// its link up after the faults; install-snapshot also a live sender), the
// install outcomes, shadow_len, msg_count, violations and, with the
// metrics plane, its leaves (zero columns when it is off).
//
// Bound. At n = 5 with metrics off a row is 58 int32 (232 B); a launch
// reads the post-tick rows it copies (about 240 B), the adjacency and the
// five pre-tick mailboxes (6 x 100 B) and writes the row: under 1.1 kB a
// cluster, a third of a nanosecond at 3.35 TB/s, and some 5 x 25 compares
// for the deliveries. One cluster's tick is all a traced replay asks of
// it, so the launch's latency is what it costs; the replay therefore
// writes the same row from inside K6 (tick.cuh record, K6-trace), and
// this kernel serves a caller that holds two states.
//
// Design. A warp a cluster, the row's columns shared out over its
// threads; the row goes into a device buffer [T, B, W] the wrapper holds
// for the whole replay, so the host copies the trace once at the end.

#include <cstdint>
#include <cuda_runtime.h>

#include "trace.cuh"

namespace {

constexpr int kWarps = 4;  // clusters a block

__global__ void __launch_bounds__(kWarps * 32)
    record_kernel(const __grid_constant__ k8::Params p) {
  const int c = blockIdx.x * kWarps + threadIdx.x / 32;
  if (c < p.b) k8::record_cluster(p, c, threadIdx.x % 32, 32);
}

}  // namespace

// desc: the wrapper's descriptor (trace.cuh Desc). Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a
// descriptor it does not take
extern "C" int record_launch(const int64_t *desc, int n_desc, void *stream) {
  k8::Params p;
  if (!k8::set_params(p, desc, n_desc))
    return static_cast<int>(cudaErrorInvalidValue);
  record_kernel<<<(p.b + kWarps - 1) / kWarps, kWarps * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
