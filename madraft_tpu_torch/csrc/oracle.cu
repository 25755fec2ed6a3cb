// Kernel K2: the per-tick safety oracle for the PyTorch port.
//
// Replaces the oracle block of the JAX reference's tick,
// madraft_tpu/tpusim/step.py step_cluster lines 961-1081: election
// safety, log matching over the ring overlap, the commit-durability shadow
// walk, the prefix-hash checks, and the block's tail (violations |=,
// first_violation_tick, first_leader_tick). With the metrics plane on
// (ref step.py:1008-1023) the walk also carries the entries' submit stamps:
// it takes log_tick [B, n, cap] and writes shadow_sub [B, cap], this tick's
// scratch, 0 except where a lane is newly recorded, which copies the
// recording node's stamp. The Python side is
// madraft_tpu_torch/kernels/oracle.py, which holds the plain version.
//
// Bound: memory. Per cluster it reads the two [n, cap] logs, the [cap]
// shadow and a few [n] and scalar rows, and writes the [cap] shadow and
// seven scalars: 15.4 MB at B = 4096, n = 5, cap = 64, so 4.6 us at
// 3.35 TB/s. The work per byte is small, but it comes in short dependent
// steps, and a block that loads its clusters and then computes leaves the
// memory idle while it computes. Design:
// - a block takes a group of G consecutive clusters (G x cap = 256
//   threads, one per ring lane), whose inputs are one contiguous span per
//   array; the grid is persistent (as many blocks as fit on the card) and
//   each block walks groups with a stride of the grid;
// - each group's arrays are staged into shared memory with cp.async, 16
//   bytes a copy where the span is aligned (4 bytes otherwise), double-
//   buffered, so group g + grid loads while group g computes. Every thread
//   copies the logs; each small span goes to one warp. cp.async rather
//   than a TMA bulk copy: the spans are a few KB, the callers' tensors are
//   not always 16-byte aligned and the alive bytes never are, and cp.async
//   takes any 4-byte-aligned span with the same code;
// - each lane thread holds its lane of every node's log (term, value,
//   absolute index) in registers; log matching is then lane-parallel: per
//   unordered node pair ((i, j) and (j, i) have the same overlap, minimum
//   bad index and maximum term-matched index, and (i, i) never fires),
//   one hardware warp reduction (REDUX) per bound gives the minimum and
//   maximum over the warp's lanes;
// - the commit-shadow walk stays sequential in node order within each
//   lane's thread, so a same-tick disagreement is seen before a later
//   node's write;
// - the first warp segment of each cluster folds the pairs' partials, the
//   lanes' window-slide XOR and disagreement flags and the per-node checks
//   with REDUX, and one lane writes the cluster's scalars.
// Where it stands (H100, clock64 stamps per phase): 15.4 us a launch at
// the flagship shape, 30% of the bound. Of a block's first group, staging
// and the wait for its loads take some 5.4k cycles and the pair checks'
// twenty REDUX per warp some 5.7k; a thread per pair walking the lanes in
// turn took 6.6k, and 17.1 us a launch.
// Node rows are cached in registers: the kernel is compiled for n = 3, 5
// and 7 exactly (every pair check unrolled), and for up to 8 or 16 nodes
// with the count read at run time; each of these five comes with and
// without the metrics plane (a template flag). The metrics instance stages
// log_tick beside the logs (a third [n, cap] span a cluster) and reads a
// node's stamp from shared memory only where the walk records a lane, so
// the stamps take no register row; it moves 1.5 x the log bytes of the
// plain instance, and writes the [cap] scratch.
// _entry_mix is computed in uint32 (signed overflow is undefined in C++)
// and the result reinterpreted as int32.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxNodes = 16;
constexpr int kMaxCap = 256;    // one ring lane per thread
constexpr int kBig = 1 << 30;
constexpr int kLeader = 2;
constexpr int kThreads = 256;   // per block: G clusters x cap lanes
constexpr int kMinBlocks = 4;   // resident blocks per SM (64 registers)

struct OracleArgs {
  // inputs: per-node [B, n], logs [B, n, cap], shadow [B, cap], scalars [B]
  const uint8_t *alive;
  const int *role, *term, *log_term, *log_val, *log_len, *base, *commit;
  const int *prefix_hash, *shadow_term, *shadow_val, *shadow_base;
  const int *shadow_len, *shadow_prefix_hash, *violations, *first_viol;
  const int *first_leader, *tick;
  const int *log_tick;  // metrics instance only: [B, n, cap] submit stamps
  // outputs
  int *viol, *st, *sv, *sb, *sl, *sh, *violations_out, *first_viol_out;
  int *first_leader_out;
  int *shadow_sub;      // metrics instance only: [B, cap]
  int b, n, cap, group, groups;
};

// Offsets (in ints) of one stage buffer's arrays; each starts 16-byte
// aligned. The per-cluster spans of a group are contiguous in device
// memory, so each array of a group is one copy.
struct Layout {
  int lt, lv, lk, st, sv, role, term, len, base, commit, hash;
  int sbase, slen, shash, viol, fvt, flt, tick, alive, size;

  __host__ __device__ static int take(int &o, int ints) {
    const int at = o;
    o += (ints + 3) & ~3;
    return at;
  }

  __host__ __device__ Layout(int g, int n, int cap, bool metrics) {
    int o = 0;
    lt = take(o, g * n * cap);
    lv = take(o, g * n * cap);
    lk = take(o, metrics ? g * n * cap : 0);
    st = take(o, g * cap);
    sv = take(o, g * cap);
    role = take(o, g * n);
    term = take(o, g * n);
    len = take(o, g * n);
    base = take(o, g * n);
    commit = take(o, g * n);
    hash = take(o, g * n);
    sbase = take(o, g);
    slen = take(o, g);
    shash = take(o, g);
    viol = take(o, g);
    fvt = take(o, g);
    flt = take(o, g);
    tick = take(o, g);
    alive = take(o, (g * n + 3) / 4 + 1);  // bytes, from a 4-aligned word
    size = o;
  }
};

// Threads t = 0 .. nt - 1 copy count ints from device memory into shared
// memory, asynchronously: 16 bytes a copy where both spans are aligned.
__device__ __forceinline__ void copy_ints(int *dst, const int *src, int count,
                                          int t, int nt) {
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const int vec = count >> 2;
    for (int i = t; i < vec; i += nt)
      __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
    for (int i = 4 * vec + t; i < count; i += nt)
      __pipeline_memcpy_async(dst + i, src + i, 4);
  } else {
    for (int i = t; i < count; i += nt)
      __pipeline_memcpy_async(dst + i, src + i, 4);
  }
}

// Issue the copies of group g (clusters g*G .. g*G + gc - 1) into buf;
// the caller commits the batch. Every thread copies the logs, which are
// most of the bytes; each of the sixteen small spans goes to one warp, so
// that a thread spends a few instructions on them, not a loop per span.
template <bool kMetrics>
__device__ __forceinline__ void stage_group(const OracleArgs &a,
                                            const Layout &L, int *buf, int g) {
  const int G = a.group, n = a.n, cap = a.cap;
  const int c0 = g * G;
  const int gc = min(G, a.b - c0);
  const int64_t nc = (int64_t)c0 * n, nl = nc * cap, cl = (int64_t)c0 * cap;
  copy_ints(buf + L.lt, a.log_term + nl, gc * n * cap, threadIdx.x, blockDim.x);
  copy_ints(buf + L.lv, a.log_val + nl, gc * n * cap, threadIdx.x, blockDim.x);
  if (kMetrics)
    copy_ints(buf + L.lk, a.log_tick + nl, gc * n * cap, threadIdx.x,
              blockDim.x);
  for (int q = threadIdx.x >> 5; q < 16; q += blockDim.x >> 5) {
    int *dst;
    const int *src;
    int count = gc;
    switch (q) {
      case 0: dst = buf + L.st; src = a.shadow_term + cl; count = gc * cap; break;
      case 1: dst = buf + L.sv; src = a.shadow_val + cl; count = gc * cap; break;
      case 2: dst = buf + L.role; src = a.role + nc; count = gc * n; break;
      case 3: dst = buf + L.term; src = a.term + nc; count = gc * n; break;
      case 4: dst = buf + L.len; src = a.log_len + nc; count = gc * n; break;
      case 5: dst = buf + L.base; src = a.base + nc; count = gc * n; break;
      case 6: dst = buf + L.commit; src = a.commit + nc; count = gc * n; break;
      case 7: dst = buf + L.hash; src = a.prefix_hash + nc; count = gc * n; break;
      case 8: dst = buf + L.sbase; src = a.shadow_base + c0; break;
      case 9: dst = buf + L.slen; src = a.shadow_len + c0; break;
      case 10: dst = buf + L.shash; src = a.shadow_prefix_hash + c0; break;
      case 11: dst = buf + L.viol; src = a.violations + c0; break;
      case 12: dst = buf + L.fvt; src = a.first_viol + c0; break;
      case 13: dst = buf + L.flt; src = a.first_leader + c0; break;
      case 14: dst = buf + L.tick; src = a.tick + c0; break;
      default: {
        // alive bytes [c0*n, (c0+gc)*n): the 4-byte words that hold them.
        // A device allocation starts 256-byte aligned and spans whole
        // words, so these words lie inside the tensor's allocation.
        const uintptr_t at = reinterpret_cast<uintptr_t>(a.alive + nc);
        const int skew = static_cast<int>(at & 3);
        dst = buf + L.alive;
        src = reinterpret_cast<const int *>(at - skew);
        count = (skew + gc * n + 3) >> 2;
      }
    }
    copy_ints(dst, src, count, threadIdx.x & 31, 32);
  }
}

__device__ __forceinline__ int lane_abs(int base, int lane, int cap) {
  return base + static_cast<int>(static_cast<unsigned>(lane - base) &
                                 static_cast<unsigned>(cap - 1)) + 1;
}

__device__ __forceinline__ int entry_mix(int term, int val, int abs_idx) {
  const uint32_t h =
      (static_cast<uint32_t>(val) ^
       (static_cast<uint32_t>(abs_idx) * 0x9E3779B9u)) * 0x85EBCA6Bu;
  return static_cast<int>(h ^ (static_cast<uint32_t>(term) * 0xC2B2AE35u));
}

// N: node rows cached in registers; kExact: n == N, known when compiled;
// kMetrics: the walk carries the submit stamps into shadow_sub
template <int N, bool kExact, bool kMetrics>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    oracle_kernel(const OracleArgs a) {
  extern __shared__ int4 smem4[];
  int *smem = reinterpret_cast<int *>(smem4);
  const int G = a.group, n = kExact ? N : a.n, cap = a.cap;
  const Layout L(G, n, cap, kMetrics);
  const int npairs = n * (n - 1) / 2;
  const int parts = (cap + 31) / 32;   // warps (or warp segments) per cluster
  const int seg = cap < 32 ? cap : 32; // a cluster's lanes in one warp
  int *s_min = smem + 2 * L.size;      // [G][N][N][parts] min bad index
  int *s_max = s_min + G * N * N * parts;  // [G][N][N][parts] max matched
  int *s_xor = s_max + G * N * N * parts;  // [G][parts] window-slide XOR
  int *s_dif = s_xor + G * parts;      // [G][parts] shadow disagreement
  const int tid = threadIdx.x;
  const int c = tid / cap;             // this thread's cluster in the group
  const int k = tid - c * cap;         // and its ring lane
  const int part = k / 32;             // its warp among the cluster's
  const bool head = (k & (seg - 1)) == 0;  // first lane of its segment
  const unsigned seg_mask =            // the warp lanes of this cluster
      seg == 32 ? 0xffffffffu : ((1u << seg) - 1) << ((tid & 31) & ~(seg - 1));

  int g = blockIdx.x;
  if (g < a.groups) stage_group<kMetrics>(a, L, smem, g);
  __pipeline_commit();
  for (int it = 0; g < a.groups; g += gridDim.x, ++it) {
    const int *s = smem + (it & 1) * L.size;
    __pipeline_wait_prior(0);
    __syncthreads();  // group g staged; the other buffer is free again
    if (g + (int)gridDim.x < a.groups)
      stage_group<kMetrics>(a, L, smem + ((it + 1) & 1) * L.size,
                            g + gridDim.x);
    __pipeline_commit();

    const int c0 = g * G;
    const int gc = min(G, a.b - c0);
    const uint8_t *alive = reinterpret_cast<const uint8_t *>(s + L.alive) +
        (reinterpret_cast<uintptr_t>(a.alive + (int64_t)c0 * n) & 3) + c * n;
    const int cn = c * n;
    // a cluster past the batch's end: its lanes skip whole warp segments
    if (c < gc) {
      // ---- this lane of every node's log
      int lt[N], lv[N], ab[N];
      unsigned live = 0;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if (i < n) {
          ab[i] = lane_abs(s[L.base + cn + i], k, cap);
          lt[i] = s[L.lt + (cn + i) * cap + k];
          lv[i] = s[L.lv + (cn + i) * cap + k];
          if (ab[i] <= s[L.len + cn + i]) live |= 1u << i;
        }
      }

      // ---- log matching, one REDUX per pair and bound
#pragma unroll
      for (int i = 0; i < N - 1; ++i) {
#pragma unroll
        for (int j = i + 1; j < N; ++j) {
          if (j < n) {
            const bool ov = ((live >> i) & (live >> j) & 1u) && ab[i] == ab[j];
            const bool teq = lt[i] == lt[j];
            int mb = ov && !(teq && lv[i] == lv[j]) ? ab[i] : kBig;
            int mt = ov && teq ? ab[i] : 0;
            mb = __reduce_min_sync(seg_mask, mb);
            mt = __reduce_max_sync(seg_mask, mt);
            if (head) {
              s_min[((c * N + i) * N + j) * parts + part] = mb;
              s_max[((c * N + i) * N + j) * parts + part] = mt;
            }
          }
        }
      }

      // ---- window slide, then the commit-shadow walk in node order
      int need = 0;
      for (int i = k & (seg - 1); i < n; i += seg)
        if (alive[i]) need = max(need, s[L.commit + cn + i]);
      need = __reduce_max_sync(seg_mask, need);
      const int old_base = s[L.sbase + c], old_len = s[L.slen + c];
      const int new_base = max(old_base, need - cap);
      int st = s[L.st + c * cap + k], sv = s[L.sv + c * cap + k];
      const int old_abs = lane_abs(old_base, k, cap);
      unsigned mix = old_abs <= min(new_base, old_len)
                         ? static_cast<unsigned>(entry_mix(st, sv, old_abs)) : 0u;
      const int sh_abs = lane_abs(new_base, k, cap);
      int sl = old_len, ss = 0;
      unsigned differ = 0;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if (i < n) {
          const int ci = s[L.commit + cn + i];
          if (sh_abs == ab[i]) {
            if (sh_abs <= min(ci, sl) && (st != lt[i] || sv != lv[i]))
              differ = 1;
            if (sh_abs > sl && sh_abs <= ci) {
              st = lt[i];
              sv = lv[i];
              if (kMetrics) ss = s[L.lk + (cn + i) * cap + k];
            }
          }
          sl = max(sl, ci);
        }
      }
      a.st[(int64_t)c0 * cap + tid] = st;
      a.sv[(int64_t)c0 * cap + tid] = sv;
      if (kMetrics) a.shadow_sub[(int64_t)c0 * cap + tid] = ss;
      mix = __reduce_xor_sync(seg_mask, mix);
      differ = __reduce_or_sync(seg_mask, differ);
      if (head) {
        s_xor[c * parts + part] = static_cast<int>(mix);
        s_dif[c * parts + part] = static_cast<int>(differ);
      }
    }
    __syncthreads();

    // ---- per cluster, its first warp segment: fold and write the scalars
    if (c < gc && k < seg) {
      const int ob = s[L.sbase + c], oh = s[L.shash + c];
      unsigned v = 0, lead = 0, slide = 0;
      int live_top = 0, top = s[L.slen + c];
      for (int q0 = k; q0 < npairs; q0 += seg) {  // pair (i, j), i < j
        int q = q0, i = 0;
        while (q >= n - 1 - i) {
          q -= n - 1 - i;
          ++i;
        }
        const int j = i + 1 + q;
        const int at = ((c * N + i) * N + j) * parts;
        int min_bad = s_min[at], max_tm = s_max[at];
        for (int w = 1; w < parts; ++w) {
          min_bad = min(min_bad, s_min[at + w]);
          max_tm = max(max_tm, s_max[at + w]);
        }
        if (min_bad <= max_tm) v |= 2;
        if (alive[i] && alive[j]) {
          if (s[L.role + cn + i] == kLeader && s[L.role + cn + j] == kLeader &&
              s[L.term + cn + i] == s[L.term + cn + j])
            v |= 1;
          if (s[L.base + cn + i] == s[L.base + cn + j] && s[L.base + cn + i] > 0 &&
              s[L.hash + cn + i] != s[L.hash + cn + j])
            v |= 512;
        }
      }
      for (int i = k; i < n; i += seg) {
        const int ci = s[L.commit + cn + i];
        top = max(top, ci);
        if (!alive[i]) continue;
        live_top = max(live_top, ci);
        const int bi = s[L.base + cn + i];
        if (bi == ob && bi > 0 && s[L.hash + cn + i] != oh) v |= 512;
        if (s[L.role + cn + i] == kLeader) lead = 1;
      }
      for (int w = k; w < parts; w += seg) {
        slide ^= static_cast<unsigned>(s_xor[c * parts + w]);
        if (s_dif[c * parts + w]) v |= 4;
      }
      v = __reduce_or_sync(seg_mask, v);
      lead = __reduce_or_sync(seg_mask, lead);
      live_top = __reduce_max_sync(seg_mask, live_top);
      top = __reduce_max_sync(seg_mask, top);
      slide = __reduce_xor_sync(seg_mask, slide);
      if (k == 0) {
        const int out = c0 + c, t = s[L.tick + c], vi = static_cast<int>(v);
        const int fv = s[L.fvt + c], fl = s[L.flt + c];
        a.viol[out] = vi;
        a.sb[out] = max(ob, live_top - cap);
        a.sl[out] = top;
        a.sh[out] = oh ^ static_cast<int>(slide);
        a.violations_out[out] = s[L.viol + c] | vi;
        a.first_viol_out[out] = (fv < 0 && vi != 0) ? t : fv;
        a.first_leader_out[out] = (fl < 0 && lead) ? t : fl;
      }
    }
  }
  __pipeline_wait_prior(0);
}

// The persistent grid of one kernel instance (every block that fits),
// found once per device and shared-memory size.
struct GridCache {
  int dev = -1, smem = -1, blocks = 0;
};

template <int N, bool kExact, bool kMetrics>
cudaError_t launch(const OracleArgs &a, cudaStream_t stream) {
  static GridCache cache;
  const Layout L(a.group, a.n, a.cap, kMetrics);
  const int parts = (a.cap + 31) / 32;
  const size_t smem = sizeof(int) * (2 * (size_t)L.size +
                                     (size_t)a.group * parts * (2 * N * N + 2));
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (cache.dev != dev || cache.smem != static_cast<int>(smem)) {
    e = cudaFuncSetAttribute(oracle_kernel<N, kExact, kMetrics>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, oracle_kernel<N, kExact, kMetrics>, kThreads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache.dev = dev;
    cache.smem = static_cast<int>(smem);
    cache.blocks = sms * per_sm;
  }
  const int grid = a.groups < cache.blocks ? a.groups : cache.blocks;
  oracle_kernel<N, kExact, kMetrics><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kMetrics>
cudaError_t dispatch(const OracleArgs &a, cudaStream_t s) {
  switch (a.n) {
    case 3: return launch<3, true, kMetrics>(a, s);
    case 5: return launch<5, true, kMetrics>(a, s);
    case 7: return launch<7, true, kMetrics>(a, s);
    default:
      return a.n <= 8 ? launch<8, false, kMetrics>(a, s)
                      : launch<16, false, kMetrics>(a, s);
  }
}

}  // namespace

extern "C" int oracle_launch(
    const void *alive, const void *role, const void *term,
    const void *log_term, const void *log_val, const void *log_len,
    const void *base, const void *commit, const void *prefix_hash,
    const void *shadow_term, const void *shadow_val, const void *shadow_base,
    const void *shadow_len, const void *shadow_prefix_hash,
    const void *violations, const void *first_violation_tick,
    const void *first_leader_tick, const void *tick, const void *log_tick,
    void *viol, void *st, void *sv, void *sb, void *sl, void *sh,
    void *violations_out, void *first_violation_tick_out,
    void *first_leader_tick_out, void *shadow_sub, int b, int n, int cap,
    void *stream) {
  // log_tick and shadow_sub: both given (the metrics instance) or both null
  if (n < 1 || n > kMaxNodes || cap < 1 || (cap & (cap - 1)) || cap > kMaxCap)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((log_tick == nullptr) != (shadow_sub == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  OracleArgs a;
  a.alive = static_cast<const uint8_t *>(alive);
  a.role = static_cast<const int *>(role);
  a.term = static_cast<const int *>(term);
  a.log_term = static_cast<const int *>(log_term);
  a.log_val = static_cast<const int *>(log_val);
  a.log_len = static_cast<const int *>(log_len);
  a.base = static_cast<const int *>(base);
  a.commit = static_cast<const int *>(commit);
  a.prefix_hash = static_cast<const int *>(prefix_hash);
  a.shadow_term = static_cast<const int *>(shadow_term);
  a.shadow_val = static_cast<const int *>(shadow_val);
  a.shadow_base = static_cast<const int *>(shadow_base);
  a.shadow_len = static_cast<const int *>(shadow_len);
  a.shadow_prefix_hash = static_cast<const int *>(shadow_prefix_hash);
  a.violations = static_cast<const int *>(violations);
  a.first_viol = static_cast<const int *>(first_violation_tick);
  a.first_leader = static_cast<const int *>(first_leader_tick);
  a.tick = static_cast<const int *>(tick);
  a.log_tick = static_cast<const int *>(log_tick);
  a.viol = static_cast<int *>(viol);
  a.st = static_cast<int *>(st);
  a.sv = static_cast<int *>(sv);
  a.sb = static_cast<int *>(sb);
  a.sl = static_cast<int *>(sl);
  a.sh = static_cast<int *>(sh);
  a.violations_out = static_cast<int *>(violations_out);
  a.first_viol_out = static_cast<int *>(first_violation_tick_out);
  a.first_leader_out = static_cast<int *>(first_leader_tick_out);
  a.shadow_sub = static_cast<int *>(shadow_sub);
  a.b = b;
  a.n = n;
  a.cap = cap;
  a.group = kThreads / cap;
  a.groups = (b + a.group - 1) / a.group;
  if (b == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(log_tick != nullptr ? dispatch<true>(a, s)
                                              : dispatch<false>(a, s));
}
