// Kernel K5: the coverage fingerprint and seen-set update for the PyTorch
// port.
//
// Replaces the JAX reference's madraft_tpu/tpusim/coverage.py
// abstract_code / _fold_code / _mix32 / bitmap_index (lines 100-180) and
// the seen-set update its coverage chunks run after every tick
// (engine.py:1342-1361, sharded 1429-1446). The Python side is
// madraft_tpu_torch/kernels/coverage.py; the plain version is
// madraft_tpu_torch/tpusim/coverage.py seen_update_plain.
//
// Per lane c, from its post-step node rows role, alive, term, commit [n]
// (the arithmetic in coverage.cuh, which K6's coverage variant shares):
//   rank_i  = #{j : term_j < term_i}, clipped to levels_r - 1;
//   delta_i = commit_i - min(commit), clipped to levels_c - 1;
//   node_i  = ((role_i * 2 + alive_i) * levels_r + rank_i) * levels_c
//             + delta_i;
//   code    = sum node_i * a^(n-1-i) mod 2^32 (Horner in uint32, a the
//             node alphabet: the same value, the reference's wraparound);
//   idx     = code in identity mode, else mix32(code) & (bits - 1).
// A lane with no violation then stamps its bit of its seen-set row:
// old = atomicMin(&seen[row][idx], t), and earns a new-fingerprint credit
// iff old >= t. t is the pool's run-wide tick, rising, and seen holds
// INT32_MAX for a bit no lane has set, so old >= t exactly when the bit
// was unset before this tick: every lane reads the seen-set as it stood
// before the tick's writes, as the reference's bm[idx] does, in one pass
// and in any order. new_fps[c] and seen are updated in place.
//
// Bound: memory, and launch latency in practice. At n = 5 and 4096 lanes
// a lane reads 4 x 5 x 4 B of node rows and its violation word, reads and
// writes its credit and one stamp: about 0.4 MB, 0.12 us at 3.35 TB/s.
// Design: a thread per lane, its node rows in registers (a template on n),
// the n^2 term compares unrolled; the atomics go to the L2. Early ticks put
// many lanes on a few codes, so a handful of addresses take many atomics.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "coverage.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNodes = 16;  // the packed layout's node limit

struct SeenArgs {
  const int *role, *term, *commit, *violations, *rows;  // rows may be null
  const uint8_t *alive;
  int *seen, *new_fps;
  int b, levels_r, levels_c, bits, identity, t;
  unsigned alphabet;
};

template <int N>
__global__ void __launch_bounds__(kThreads)
    seen_update_kernel(const SeenArgs a) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= a.b) return;
  if (a.violations[c] != 0) return;  // a violated lane neither writes nor earns
  const long base = static_cast<long>(c) * N;
  int term[N], commit[N];
  int cmin = INT_MAX;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    term[i] = a.term[base + i];
    commit[i] = a.commit[base + i];
    cmin = min(cmin, commit[i]);
  }
  unsigned code = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    int rank = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) rank += term[j] < term[i];
    code = code * a.alphabet +
           cov::node_code(a.role[base + i], a.alive[base + i], rank,
                          commit[i] - cmin, a.levels_r, a.levels_c);
  }
  const unsigned idx = cov::bit_index(code, a.identity, a.bits);
  const long row = a.rows ? a.rows[c] : 0;
  const int old = atomicMin(&a.seen[row * a.bits + idx], a.t);
  if (old >= a.t) a.new_fps[c] += 1;
}

template <int N>
void launch(const SeenArgs &a, cudaStream_t stream) {
  const int grid = (a.b + kThreads - 1) / kThreads;
  seen_update_kernel<N><<<grid, kThreads, 0, stream>>>(a);
}

template <int N>
bool dispatch(int n, const SeenArgs &a, cudaStream_t stream) {
  if (n == N) {
    launch<N>(a, stream);
    return true;
  }
  if constexpr (N < kMaxNodes) {
    return dispatch<N + 1>(n, a, stream);
  } else {
    return false;
  }
}

}  // namespace

extern "C" int seen_update_launch(
    const void *role, const void *alive, const void *term, const void *commit,
    const void *violations, const void *rows, void *seen, void *new_fps,
    int b, int n, int levels_r, int levels_c, unsigned alphabet, int bits,
    int identity, int t, void *stream) {
  if (b < 0 || n < 1 || n > kMaxNodes || bits < 1 || (bits & (bits - 1)) ||
      t < 0 || t == INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  SeenArgs a;
  a.role = static_cast<const int *>(role);
  a.alive = static_cast<const uint8_t *>(alive);
  a.term = static_cast<const int *>(term);
  a.commit = static_cast<const int *>(commit);
  a.violations = static_cast<const int *>(violations);
  a.rows = static_cast<const int *>(rows);
  a.seen = static_cast<int *>(seen);
  a.new_fps = static_cast<int *>(new_fps);
  a.b = b;
  a.levels_r = levels_r;
  a.levels_c = levels_c;
  a.alphabet = alphabet;
  a.bits = bits;
  a.identity = identity;
  a.t = t;
  dispatch<1>(n, a, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
