// K7's device code: the pool harvest (harvest.cu holds the kernels, their
// launch and the note on what they replace, their bound and design).
//
// Written so that g++ builds it too (tests/harvest_host_emu.cpp): the
// per-lane work is two functions of (lane, thread t of T), read_lane and
// write_lane, with nothing exchanged between the threads of a lane but
// device memory, so the host runs a lane's threads one after another;
// only ids_block, the batch-wide scan, uses warp ballots, shared memory
// and block barriers (the host build runs it on std::threads). The
// float32 refill goes through fmul / fadd / ffma, which are __fmul_rn,
// __fadd_rn and __fmaf_rn on the card (no contraction) and the plain
// operations and std::fmaf on the host (built with -ffp-contract=off).

#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>

#include "threefry.cuh"

namespace k7 {

constexpr int kMaxLeaves = 72;   // ClusterState has 68
constexpr int kMaxSegs = 32;     // snapshot segments (31 with coverage)
constexpr int kMutable = 9;      // coverage.MUTABLE_KNOBS
constexpr uint32_t kCovSalt = 0x434F5647u;  // coverage._COV_SALT
constexpr int kRefillFresh = 1, kRefillMutate = 2;
constexpr int32_t kUnseen = 0x7fffffff;     // coverage.UNSEEN
constexpr int kConsts = 14;      // the refill's float32 constants

// The wrapper's descriptor (kernels/harvest.py _descriptor): int64 words
// at these positions, then 4 a leaf, then 3 a snapshot segment
enum Desc {
  kB, kN, kHorizon, kSeed, kPartitionable, kLaneIds, kCols, kNLeaves,
  kNSegs, kTimer, kCov, kGuided, kColCov, kSeenRows, kSeenBitsN,
  kEtoStride, kViolations, kTick, kIds, kIdsOut, kBook, kBookOut, kKeysOut,
  kSnap, kEtoMin, kEtoMax, kEtoSkew, kSeen, kSeenBits, kKinds, kNewFps,
  kKnob, kBase = kKnob + kMutable, kHeader = kBase + kMutable
};

struct Leaf {     // one state leaf, [B, elems] contiguous
  void *ptr;
  int elems;      // elements a lane
  int bytes;      // 4 (int32) or 1 (bool)
  int init;       // init_cluster's value (unused for the timer leaf)
};

struct Seg {      // snapshot columns: src[lane * stride + e], e < count
  const int32_t *src;  // null: the lane's retire flag
  int count, stride;
};

// The refill's float32 constants, rounded on the host as the plain
// version rounds them (kernels/harvest.py _refill_consts)
struct Consts {
  float span, lo, width;  // log2(mut_span), fresh_lo, fresh_hi - fresh_lo
  float log2e, c1, c2, p0, poly[5], ln2, one;
};

struct Params {
  Leaf leaf[kMaxLeaves];
  Seg seg[kMaxSegs];
  Consts k;
  int b, n, horizon, partitionable, lane_ids, cols, n_leaves, n_segs, timer;
  int cov, guided, col_cov, seen_rows, seen_bits_n, eto_stride;
  uint32_t seed;
  const int32_t *violations, *tick, *ids, *book;
  int32_t *ids_out, *book_out, *snap, *seen_bits, *kinds, *new_fps;
  int64_t *keys_out;
  const int32_t *eto_min, *eto_max, *eto_skew, *seen;
  float *knob[kMutable];
  const float *base[kMutable];
};

template <typename T>
inline T *ptr_of(int64_t w) {
  return reinterpret_cast<T *>(static_cast<intptr_t>(w));
}

// Params from the wrapper's descriptor; false on a shape it does not take
inline bool set_params(Params &p, const int64_t *d, int n_desc,
                       const float *consts) {
  if (n_desc < kHeader) return false;
  p.b = static_cast<int>(d[kB]);
  p.n = static_cast<int>(d[kN]);
  p.horizon = static_cast<int>(d[kHorizon]);
  p.seed = static_cast<uint32_t>(d[kSeed]);
  p.partitionable = static_cast<int>(d[kPartitionable]);
  p.lane_ids = static_cast<int>(d[kLaneIds]);
  p.cols = static_cast<int>(d[kCols]);
  p.n_leaves = static_cast<int>(d[kNLeaves]);
  p.n_segs = static_cast<int>(d[kNSegs]);
  p.timer = static_cast<int>(d[kTimer]);
  p.cov = static_cast<int>(d[kCov]);
  p.guided = static_cast<int>(d[kGuided]);
  p.col_cov = static_cast<int>(d[kColCov]);
  p.seen_rows = static_cast<int>(d[kSeenRows]);
  p.seen_bits_n = static_cast<int>(d[kSeenBitsN]);
  p.eto_stride = static_cast<int>(d[kEtoStride]);
  if (p.b < 1 || p.n < 1 || p.n_leaves < 1 || p.n_leaves > kMaxLeaves ||
      p.n_segs < 1 || p.n_segs > kMaxSegs || p.timer < 0 ||
      p.timer >= p.n_leaves ||
      n_desc != kHeader + 4 * p.n_leaves + 3 * p.n_segs)
    return false;
  p.violations = ptr_of<const int32_t>(d[kViolations]);
  p.tick = ptr_of<const int32_t>(d[kTick]);
  p.ids = ptr_of<const int32_t>(d[kIds]);
  p.ids_out = ptr_of<int32_t>(d[kIdsOut]);
  p.book = ptr_of<const int32_t>(d[kBook]);
  p.book_out = ptr_of<int32_t>(d[kBookOut]);
  p.keys_out = ptr_of<int64_t>(d[kKeysOut]);
  p.snap = ptr_of<int32_t>(d[kSnap]);
  p.eto_min = ptr_of<const int32_t>(d[kEtoMin]);
  p.eto_max = ptr_of<const int32_t>(d[kEtoMax]);
  p.eto_skew = ptr_of<const int32_t>(d[kEtoSkew]);
  p.seen = ptr_of<const int32_t>(d[kSeen]);
  p.seen_bits = ptr_of<int32_t>(d[kSeenBits]);
  p.kinds = ptr_of<int32_t>(d[kKinds]);
  p.new_fps = ptr_of<int32_t>(d[kNewFps]);
  for (int j = 0; j < kMutable; ++j) {
    p.knob[j] = ptr_of<float>(d[kKnob + j]);
    p.base[j] = ptr_of<const float>(d[kBase + j]);
  }
  if (p.cov && (!p.seen || !p.seen_bits || p.seen_rows < 1 ||
                p.seen_bits_n < 1 || !p.kinds || !p.new_fps))
    return false;
  int cols = 0;
  const int64_t *w = d + kHeader;
  for (int l = 0; l < p.n_leaves; ++l, w += 4) {
    p.leaf[l] = {ptr_of<void>(w[0]), static_cast<int>(w[1]),
                 static_cast<int>(w[2]), static_cast<int>(w[3])};
    if (p.leaf[l].bytes != 1 && p.leaf[l].bytes != 4) return false;
  }
  for (int s = 0; s < p.n_segs; ++s, w += 3) {
    p.seg[s] = {ptr_of<const int32_t>(w[0]), static_cast<int>(w[1]),
                static_cast<int>(w[2])};
    cols += p.seg[s].count;
  }
  if (cols != p.cols || p.leaf[p.timer].elems != p.n ||
      p.leaf[p.timer].bytes != 4)
    return false;
  std::memcpy(&p.k, consts, sizeof(Consts));
  return true;
}

// ------------------------------------------------- float32 without fusion
__device__ __forceinline__ float fmul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

__device__ __forceinline__ float fadd(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

__device__ __forceinline__ float ffma(float a, float b, float c) {
#ifdef __CUDA_ARCH__
  return __fmaf_rn(a, b, c);
#else
  return std::fmaf(a, b, c);
#endif
}

using madraft::as_float;
using madraft::bits_word;
using madraft::randint_elem;
using madraft::uniform;

// XLA's float32 exp on the CPU (coverage.xla_exp_f32): m = floor(x log2e
// + 1/2), the reduced argument in two steps, a degree-6 polynomial by
// FMAs, times 2^m
__device__ __forceinline__ float xla_exp(float x, const Consts &k) {
  const float m = floorf(ffma(x, k.log2e, 0.5f));
  float r = ffma(m, k.c1, x);
  r = ffma(m, k.c2, r);
  float p = k.p0;
#pragma unroll
  for (int i = 0; i < 5; ++i) p = ffma(p, r, k.poly[i]);
  const float y = fadd(ffma(p, fmul(r, r), r), k.one);
  const uint32_t scale = static_cast<uint32_t>(static_cast<int>(m) + 127)
                         << 23;
  return fmul(y, as_float(scale));
}

// exp2((2u - 1) span) as XLA lowers it: exp(fl32(ln2 x))
__device__ __forceinline__ float mutation_factor(float u, const Consts &k) {
  const float x = fmul(fadd(fmul(u, 2.0f), -1.0f), k.span);
  return xla_exp(fmul(x, k.ln2), k);
}

// fresh_lo + u (fresh_hi - fresh_lo), contracted into one FMA as XLA does
__device__ __forceinline__ float fresh_factor(float u, const Consts &k) {
  return ffma(u, k.width, k.lo);
}

// ----------------------------------------------------------- the harvest
__device__ __forceinline__ bool retired_of(const Params &p, int lane) {
  return p.violations[lane] != 0 || p.tick[lane] >= p.horizon;
}

// Shared memory of ids_block
struct IdsShared {
  int warp_total[32];
  int carry;
  int seen;
};

// The batch-wide pass, one block of T threads (T a multiple of 32): new
// ids and the id bookkeeping, and the seen-set's union popcount. Monotone
// ids: a retired lane gets book[0] + its exclusive rank among the retired
// lanes, in lane order (a ballot and popcount a warp, the warps' totals
// in shared memory, a carry from tile to tile), and book_out[0] = book[0]
// + the retired count; lane ids: gens + retired, id gen * B + lane
__device__ __forceinline__ void ids_block(const Params &p, IdsShared &sh,
                                          int tid, int T) {
  const int warp = tid / 32, wl = tid % 32;
  if (tid == 0) {
    sh.carry = 0;
    sh.seen = 0;
  }
  __syncthreads();
  for (int base = 0; base < p.b; base += T) {
    const int lane = base + tid;
    const bool r = lane < p.b && retired_of(p, lane);
    if (p.lane_ids) {
      if (lane < p.b) {
        const uint32_t g = static_cast<uint32_t>(p.book[lane]) + (r ? 1u : 0u);
        p.book_out[lane] = static_cast<int32_t>(g);
        p.ids_out[lane] =
            r ? static_cast<int32_t>(g * static_cast<uint32_t>(p.b) +
                                     static_cast<uint32_t>(lane))
              : p.ids[lane];
      }
      continue;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, r);
    if (wl == 0) sh.warp_total[warp] = __popc(mask);
    __syncthreads();
    int off = sh.carry + __popc(mask & ((1u << wl) - 1u));
    for (int w = 0; w < warp; ++w) off += sh.warp_total[w];
    if (lane < p.b)
      p.ids_out[lane] =
          r ? static_cast<int32_t>(static_cast<uint32_t>(p.book[0]) +
                                   static_cast<uint32_t>(off))
            : p.ids[lane];
    __syncthreads();
    if (tid == 0) {
      int sum = 0;
      for (int w = 0; w < T / 32; ++w) sum += sh.warp_total[w];
      sh.carry += sum;
    }
    __syncthreads();
  }
  if (!p.lane_ids && tid == 0)
    p.book_out[0] = static_cast<int32_t>(static_cast<uint32_t>(p.book[0]) +
                                         static_cast<uint32_t>(sh.carry));
  if (!p.cov) return;
  int seen = 0;
  for (int bit = tid; bit < p.seen_bits_n; bit += T) {
    bool any = false;
    for (int r = 0; r < p.seen_rows; ++r)
      any |= p.seen[static_cast<int64_t>(r) * p.seen_bits_n + bit] != kUnseen;
    seen += any;
  }
  atomicAdd(&sh.seen, seen);
  __syncthreads();
  if (tid == 0) p.seen_bits[0] = sh.seen;
}

// Before the lane's refill, thread t of T: the snapshot row's columns e
// = t, t + T, ... of each segment (the state, ids, coverage rows as they
// stand: PRE-refill) and, thread 0, the lane's new key fold_in(PRNGKey(
// seed), new id). Reads the state, writes the snapshot and keys_out only
__device__ __forceinline__ void read_lane(const Params &p, int lane, int t,
                                         int T) {
  int32_t *row = p.snap + static_cast<int64_t>(lane) * p.cols;
  int col = 0;
  for (int s = 0; s < p.n_segs; ++s) {
    const Seg &g = p.seg[s];
    for (int e = t; e < g.count; e += T)
      row[col + e] = g.src ? g.src[static_cast<int64_t>(lane) * g.stride + e]
                           : static_cast<int32_t>(retired_of(p, lane));
    col += g.count;
  }
  if (t == 0) {
    uint32_t k0 = 0u, k1 = p.seed;
    madraft::fold_in(k0, k1, static_cast<uint32_t>(p.ids_out[lane]));
    p.keys_out[2 * static_cast<int64_t>(lane)] = k0;
    p.keys_out[2 * static_cast<int64_t>(lane) + 1] = k1;
  }
}

// The refilled float32 knob j of a retired lane (coverage.refill_knobs):
// a productive lane's child jitters the parent, an unproductive one
// redraws base * fresh factor; clipped to [0, 1]
__device__ __forceinline__ float child_knob(const Params &p, int lane, int j,
                                            float parent, bool productive) {
  uint32_t k0 = 0u, k1 = p.seed ^ kCovSalt;
  madraft::fold_in(k0, k1, static_cast<uint32_t>(p.ids_out[lane]));
  const float u = uniform(bits_word(k0, k1, j, kMutable, p.partitionable));
  const float c = productive ? fmul(parent, mutation_factor(u, p.k))
                             : fmul(p.base[j][0], fresh_factor(u, p.k));
  return c < 0.0f ? 0.0f : (c > 1.0f ? 1.0f : c);
}

// After read_lane of every thread of the lane (a warp barrier between),
// thread t of T on a retired lane: the coverage refill (knob rows, kinds,
// new_fps, read back from the snapshot row) and init_cluster's fresh
// state written in place, element e = t, t + T, ... of each leaf; the
// election timers randint(key, n, eto_min, eto_max + 1) + i * eto_skew
// under the lane's new key and knob row
__device__ __forceinline__ void write_lane(const Params &p, int lane, int t,
                                          int T) {
  const int32_t *row = p.snap + static_cast<int64_t>(lane) * p.cols;
  if (!row[0]) return;
  if (p.cov) {
    const bool productive = row[p.col_cov] > 0;
    if (p.guided) {
      for (int j = t; j < kMutable; j += T)
        p.knob[j][lane] = child_knob(
            p, lane, j, as_float(static_cast<uint32_t>(row[p.col_cov + 3 + j])),
            productive);
      if (t == 0) p.kinds[lane] = productive ? kRefillMutate : kRefillFresh;
    }
    if (t == 0) p.new_fps[lane] = 0;
  }
  const uint32_t k0 = static_cast<uint32_t>(p.keys_out[2 * static_cast<int64_t>(lane)]);
  const uint32_t k1 =
      static_cast<uint32_t>(p.keys_out[2 * static_cast<int64_t>(lane) + 1]);
  const int64_t eto = static_cast<int64_t>(lane) * p.eto_stride;
  for (int l = 0; l < p.n_leaves; ++l) {
    const Leaf &f = p.leaf[l];
    const int64_t at = static_cast<int64_t>(lane) * f.elems;
    if (l == p.timer) {
      const int32_t lo = p.eto_min[eto];
      const int32_t hi = static_cast<int32_t>(
          static_cast<uint32_t>(p.eto_max[eto]) + 1u);
      for (int e = t; e < f.elems; e += T)
        static_cast<int32_t *>(f.ptr)[at + e] = static_cast<int32_t>(
            static_cast<uint32_t>(randint_elem(k0, k1, e, p.n, lo, hi,
                                               p.partitionable)) +
            static_cast<uint32_t>(e) * static_cast<uint32_t>(p.eto_skew[eto]));
    } else if (f.bytes == 4) {
      for (int e = t; e < f.elems; e += T)
        static_cast<int32_t *>(f.ptr)[at + e] = f.init;
    } else {
      for (int e = t; e < f.elems; e += T)
        static_cast<uint8_t *>(f.ptr)[at + e] = static_cast<uint8_t>(f.init);
    }
  }
}

}  // namespace k7
