// The kv service tick's device code (the JAX reference's _kv_service_tick),
// once, for two kernels: K9 runs it on the 32 lanes of a warp, one tick a
// launch (kv.cu holds that kernel, its launch and the note on what it
// replaces, its bound and design), and K6-kv runs it on K6's 16-lane tile
// after each raft tick of a chunk (tick.cuh, -DMADRAFT_K6_KV). Built by
// nvcc through kv.cu and tick.cu, and by g++ through tests/kv_host_emu.cpp
// and tests/tick_host_emu.cpp.
//
// The tick runs as phases (scan, apply, observe, clerks, submit), a warp
// barrier after each. Each phase is a function of the lane and an
// environment (K9Env here, tick.cuh KvEnv): the lane count, the cluster's
// region (its rows of the service leaves and the tick's scratch, Layout),
// the raft leaves the tick reads and writes, and the pre-tick values.
// K9 stages its region from the inputs each tick and writes a new state,
// so its pre-tick values are the inputs; K6-kv keeps the region for a
// whole chunk and updates it in place, so it copies the two its phases
// need after rewriting them (the truth's max seq, and the snapshots an
// install adopts). Within a phase the lanes share nothing but commutative
// updates of the region (atomic add, or, max): so K9's host build runs a
// phase's lanes one after another, and gets the card's result.
//
// The arithmetic is the plain version's (tpusim/kv.py _kv_service_tick),
// written per cluster: int32 values that may wrap are computed in uint32
// (signed overflow is undefined in C++), the ops' unpacking uses floor
// division and modulo, as Python's // and %, float32 sums and products go
// through fadd / fmul (no contraction into an FMA), and the zipf map's
// powf is the card's correctly rounded-or-close one (no fast math).

#pragma once

#include <cmath>
#include <cstdint>

#include "threefry.cuh"

namespace k9 {

#ifdef MADRAFT_K9_METRICS
constexpr bool kMetrics = true;
#else
constexpr bool kMetrics = false;
#endif

constexpr int kLanes = 32;       // K9: a warp a cluster
constexpr int kMaxNodes = 16;    // a node a lane in apply
constexpr int kMaxCap = 256;
constexpr int kMaxClients = 32;
constexpr int kMaxKeys = 64;
constexpr int kQueueSlots = 8;   // config.OPEN_QUEUE_SLOTS
constexpr int kPhases = 4;       // config.LATENCY_PHASES
constexpr int kSeqLim = 1 << 15;
constexpr int32_t kNoop = 1 << 30;  // config.NOOP_CMD
constexpr int32_t kLeader = 2;
constexpr int kGet = 1, kPut = 2, kAppend = 0;
constexpr int32_t kViolExactlyOnce = 8, kViolDiverge = 16, kViolStale = 32;
constexpr uint32_t kSiteStart = 8, kSiteKind = 14, kSiteHint = 15;

// The leaves the service tick writes: the service leaves in KvState order,
// then the raft leaves it writes (kernels/kv.py RAFT_WRITES)
enum Leaf {
  kClerkSeq, kClerkOut, kClerkKey, kClerkKind, kClerkAcked, kClerkLeader,
  kClerkWait, kOpenArr, kOpenSrv, kOpenDrop, kOpenStamp, kClerkSub,
  kClerkApp, kClerkCmt, kClerkApl, kClientRetries, kKeyLatHist,
  kClientLatHist, kTruthCount, kTruthMaxSeq, kClerkGetLo, kClerkGetObs,
  kClerkLastObs, kGetsDone, kApplied, kLastSeq, kApplyCount, kKeyHash,
  kKeyCount, kSnapLastSeq, kSnapApplyCount, kSnapKeyHash, kSnapKeyCount,
  kLogTerm, kLogVal, kLogLen, kDurableLen, kViolations, kFirstViolation,
  kCompactFloor, kLatHist, kPhaseHist, kPhaseTicks, kLatTicks, kWorstLat,
  kWorstPhases, kWorstKey, kWorstClient, kWorstSub,
  kLeaves
};
// The service leaves are the first kServiceLeaves
constexpr int kServiceLeaves = kLogTerm;

// K9's read-only inputs: the stepped raft state's leaves, the pre-tick
// views, the keys and the knob table (kernels/kv.py RAFT_READS)
enum Read {
  kTick, kTerm, kRole, kAlive, kBase, kCommit, kSnapSrc, kShadowVal,
  kShadowBase, kShadowLen, kPreAlive, kPreBase, kPreShadowLen, kKeys,
  kKnobF, kKnobI,
  kReads
};

// The knob table's columns (kernels/kv.py KNOB_F32 / KNOB_I32)
enum KnobF { kPOp, kPGet, kPPut, kPRetry, kPFollow, kOpenRate, kZipfA, kNF };
enum KnobI {
  kRetryWait, kQueueCap, kBugSkipDedup, kBugApplyUncommitted,
  kBugStaleRead, kBugStaleHint, kFlowCap, kNI
};

// K9's descriptor (kernels/kv.py _launch): this header, the kReads
// pointers, then 4 words a leaf (in, out, count a cluster, bytes an
// element). K6-kv's (kernels/kv.py _side) has the header's kNc ..
// kMetricsOn, the knob table's two pointers, then the same 4 words a leaf
enum Desc {
  kB, kN, kCap, kNc, kNk, kApplyMax, kHb, kNph, kPartitionable, kMetricsOn,
  kHeader
};

// K9's phases of a tick, in order (run_phase)
enum Phase { kStage, kScan, kApply, kObserve, kClerks, kSubmit, kWriteBack,
             kTickPhases };

// A worst-op candidate's words in the region: mask, lat, key, sub, then
// the kPhases phases
constexpr int kWorstWords = 4 + kPhases;

// The tick's draw keys, from fold_in(cluster key, t): the four splits of
// site 8 (the start word, the key draw, the retry, the target), site 14
// (the op's kind) and the first split of site 15 (hint following)
constexpr int kDrawKeys = 6;

// K9's stepped raft rows by node, staged in the region (alive as 0 / 1)
enum RaftRow { kRTerm, kRRole, kRAlive, kRBase, kRCommit, kRaftRows };

// A leaf: its input and output, its count of elements a cluster, its
// bytes an element, and its row's offset in the region (-1 for a leaf the
// region does not hold)
struct LeafRef {
  const void *in;
  void *out;
  int count, bytes, off;
};

// The run's shape
struct Dims {
  int n, cap, nc, nk, apply_max, hb, nph, part;
};

// The region's scratch after the leaves' rows, in int32 words from its
// start (a size 0 where the kernel keeps none)
struct Layout {
  int sh_val;     // K9: [cap] the shadow window's values
  int viol;       // the tick's violation bits
  int flag;       // [nc] the clerk's op is in the live shadow
  int first;      // [n, nc] the first apply round a node observed the
                  // clerk's Get (apply_max when none)
  int first_obs;  // [n, nc] what it observed then
  int target;     // [nc] the node the clerk contacts
  int retry;      // [nc] the clerk submits
  int worst;      // [2, nc, kWorstWords] the ack's and the serve's
                  // worst-op candidates
  int draws;      // [kDrawKeys, 2] the tick's draw keys
  int raft;       // K9: [kRaftRows, n] the stepped raft rows (RaftRow)
  int pre_base;   // K6-kv: [n] the pre-tick base
  int pre_tmax;   // K6-kv: [nc] the pre-tick truth_max_seq
  int snap_pre;   // K6-kv: [n, 2 nc + 2 nk] the pre-tick snapshots
  int knobs;      // K6-kv: [kNF + kNI] the cluster's knob rows
  int words;      // the region's size
};

// Lays a region out for d: a row for each leaf with a region row (K9: all
// but the two log rows; K6-kv, k6: the service leaves and the metric
// leaves, whose raft leaves live in K6's block), each leaf's count and
// bytes already set, then the scratch. False for a leaf K9 does not take
inline bool lay_out(LeafRef *leaf, Layout &L, const Dims &d, bool k6) {
  int words = 0;
  for (int l = 0; l < kLeaves; ++l) {
    const bool held = k6 ? (l < kServiceLeaves || l >= kLatHist)
                         : (l != kLogTerm && l != kLogVal);
    if (leaf[l].bytes != 1 && leaf[l].bytes != 4) return false;
    if (leaf[l].count < 0 || leaf[l].count > (1 << 16)) return false;
    leaf[l].off = held ? words : -1;
    if (held) words += (leaf[l].count * leaf[l].bytes + 3) / 4;
  }
  auto take = [&](int size) {
    const int at = words;
    words += size;
    return at;
  };
  L.sh_val = take(k6 ? 0 : d.cap);
  L.viol = take(1);
  L.flag = take(d.nc);
  L.first = take(d.n * d.nc);
  L.first_obs = take(d.n * d.nc);
  L.target = take(d.nc);
  L.retry = take(d.nc);
  L.worst = take(2 * d.nc * kWorstWords);
  L.draws = take(2 * kDrawKeys);
  L.raft = take(k6 ? 0 : kRaftRows * d.n);
  L.pre_base = take(k6 ? d.n : 0);
  L.pre_tmax = take(k6 ? d.nc : 0);
  L.snap_pre = take(k6 ? d.n * (2 * d.nc + 2 * d.nk) : 0);
  L.knobs = take(k6 ? int(kNF) + int(kNI) : 0);
  L.words = words;
  return true;
}

// Dims from the descriptor header's words nc .. metrics_on (Desc kNc ..
// kMetricsOn) and the raft shape; false when they are out of the
// kernels' range or the metrics flag is not met (the build's)
inline bool set_dims(Dims &d, const int64_t *h, int n, int cap, int part,
                     bool met) {
  d.n = n;
  d.cap = cap;
  d.nc = static_cast<int>(h[0]);
  d.nk = static_cast<int>(h[kNk - kNc]);
  d.apply_max = static_cast<int>(h[kApplyMax - kNc]);
  d.hb = static_cast<int>(h[kHb - kNc]);
  d.nph = static_cast<int>(h[kNph - kNc]);
  d.part = part;
  if (n < 1 || n > kMaxNodes || cap < 1 || cap > kMaxCap ||
      (cap & (cap - 1)) || d.nc < 1 || d.nc > kMaxClients || d.nk < 1 ||
      d.nk > kMaxKeys || d.apply_max < 0 ||
      (h[kMetricsOn - kNc] != 0) != met)
    return false;
  return !met || (d.hb >= 1 && d.hb <= 31 && d.nph == kPhases);
}

template <typename T>
inline T *ptr_of(int64_t w) {
  return reinterpret_cast<T *>(static_cast<intptr_t>(w));
}

// The leaves of a descriptor's 4 words a leaf (in, out, count, bytes)
inline void set_leaves(LeafRef *leaf, const int64_t *g) {
  for (int l = 0; l < kLeaves; ++l, g += 4)
    leaf[l] = {ptr_of<const void>(g[0]), ptr_of<void>(g[1]),
               static_cast<int>(g[2]), static_cast<int>(g[3]), -1};
}

// K9's parameters: the leaves, the reads, the shape and the region
struct Params {
  LeafRef leaf[kLeaves];
  const void *read[kReads];
  Dims d;
  Layout L;
  int b;
};

inline bool set_params(Params &p, const int64_t *d, int n_desc) {
  constexpr int kWords = int(kHeader) + int(kReads) + 4 * int(kLeaves);
  if (n_desc != kWords) return false;
  p.b = static_cast<int>(d[kB]);
  if (p.b < 1 ||
      !set_dims(p.d, d + kNc, static_cast<int>(d[kN]),
                static_cast<int>(d[kCap]),
                static_cast<int>(d[kPartitionable]), kMetrics))
    return false;
  for (int r = 0; r < kReads; ++r)
    p.read[r] = ptr_of<const void>(d[kHeader + r]);
  set_leaves(p.leaf, d + kHeader + kReads);
  return lay_out(p.leaf, p.L, p.d, false);
}

// K6-kv's share of K6's parameters (tick.cuh Params::kv): the service
// leaves in and out (a metric leaf's row has no in or out: K6 keeps the
// metric leaves), the kv knob table, the shape and the region (tick.cuh
// places it in a cluster's block)
struct Side {
  LeafRef leaf[kLeaves];
  const float *kf;  // [B, kNF]
  const int *ki;    // [B, kNI]
  Dims d;
  Layout L;
};

// Side from K6-kv's descriptor (kNc .. kMetricsOn, kf, ki, then 4 words a
// leaf) at raft shape (n, cap); false where K6-kv does not take it
inline bool set_side(Side &s, const int64_t *d, int n_desc, int n, int cap,
                     int part, bool met) {
  constexpr int kWords = int(kHeader) - int(kNc) + 2 + 4 * int(kLeaves);
  if (n_desc != kWords) return false;
  if (!set_dims(s.d, d, n, cap, part, met)) return false;
  s.kf = ptr_of<const float>(d[kHeader - kNc]);
  s.ki = ptr_of<const int>(d[kHeader - kNc + 1]);
  set_leaves(s.leaf, d + kHeader - kNc + 2);
  return lay_out(s.leaf, s.L, s.d, true);
}

// ------------------------------------------------------------- arithmetic
__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

// Python's a // b and a % b for b > 0
__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {
  const int32_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int32_t floor_mod(int32_t a, int32_t b) {
  const int32_t r = a % b;
  return (r != 0 && r < 0) ? r + b : r;
}

__device__ __forceinline__ float fadd(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

__device__ __forceinline__ float fmul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

__device__ __forceinline__ float fdiv(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}

// The lanes' commutative updates of a word of the cluster's region (on
// the host K9's lanes run one after another; K6-kv's run as threads, and
// its host build defines MADRAFT_HOST_ATOMICS and the atomics' twins)
__device__ __forceinline__ void shared_add(int32_t *a, int32_t v) {
#if defined(__CUDA_ARCH__) || defined(MADRAFT_HOST_ATOMICS)
  atomicAdd(a, v);
#else
  *a = wrap_add(*a, v);
#endif
}

__device__ __forceinline__ void shared_or(int32_t *a, int32_t v) {
#if defined(__CUDA_ARCH__) || defined(MADRAFT_HOST_ATOMICS)
  atomicOr(a, v);
#else
  *a |= v;
#endif
}

__device__ __forceinline__ void shared_max(int32_t *a, int32_t v) {
#if defined(__CUDA_ARCH__) || defined(MADRAFT_HOST_ATOMICS)
  atomicMax(a, v);
#else
  if (v > *a) *a = v;
#endif
}

struct Op {
  int32_t client, seq, key, kind;
};

// The packed op's fields (kv.py _unpack), client clipped to [0, nc)
__device__ __forceinline__ Op unpack(int32_t val, int nk, int nc) {
  int32_t v = wrap_sub(val, 1);
  Op o;
  o.kind = floor_mod(v, 4);
  v = floor_div(v, 4);
  o.key = floor_mod(v, nk);
  const int32_t cs = floor_div(v, nk);
  const int32_t client = floor_div(cs, kSeqLim);
  o.client = client < 0 ? 0 : (client > nc - 1 ? nc - 1 : client);
  o.seq = floor_mod(cs, kSeqLim);
  return o;
}

__device__ __forceinline__ int32_t pack(int32_t client, int32_t seq,
                                        int32_t key, int32_t kind, int nk) {
  uint32_t v = static_cast<uint32_t>(client) * kSeqLim +
               static_cast<uint32_t>(seq);
  v = v * static_cast<uint32_t>(nk) + static_cast<uint32_t>(key);
  return static_cast<int32_t>(v * 4u + static_cast<uint32_t>(kind) + 1u);
}

// The metrics plane's bucket of a latency: the edges 2^k (k = 1 .. hb-1)
// at or below it
__device__ __forceinline__ int bucket_of(int32_t lat, int hb) {
  int k = 0;
  for (int e = 1; e < hb; ++e) k += lat >= (1 << e);
  return k;
}

// config.zipf_map of one draw: floor(nk * ((d + 0.5) / nk) ** a), clipped;
// a == 1 is the identity
__device__ __forceinline__ int32_t zipf_map(int32_t draw, int nk, float a) {
  if (a == 1.0f) return draw;
  const float nf = static_cast<float>(nk);
  const float u = fdiv(fadd(static_cast<float>(draw), 0.5f), nf);
  const float y = floorf(fmul(nf, powf(u, a)));
  int32_t k = static_cast<int32_t>(y);
  return k < 0 ? 0 : (k > nk - 1 ? nk - 1 : k);
}

// The absolute log index of shadow lane i: the window's lanes hold
// base + 1 .. base + cap, lane i the one congruent to it mod cap
__device__ __forceinline__ int32_t shadow_abs(int32_t base, int i, int cap) {
  return base + static_cast<int32_t>(static_cast<uint32_t>(i - base) &
                                     static_cast<uint32_t>(cap - 1)) + 1;
}

// ------------------------------------------------------------- the draws
// The hashes behind the tick's draws, each compiled once and called: a
// warp runs the kernel's code once, so its time goes with the code's size
// (every instruction is fetched for the warps of an SM together), and the
// inlined threefry rounds would be most of it
__device__ __noinline__ void fold_in(uint32_t &k0, uint32_t &k1,
                                     uint32_t data) {
  madraft::fold_in(k0, k1, data);
}

__device__ __noinline__ void split_key(uint32_t k0, uint32_t k1, int num,
                                       int j, int part, uint32_t &o0,
                                       uint32_t &o1) {
  madraft::split_key(k0, k1, num, j, part, o0, o1);
}

__device__ __noinline__ uint32_t bits_word(uint32_t k0, uint32_t k1, int i,
                                           int total, int part) {
  return madraft::bits_word(k0, k1, i, total, part);
}

__device__ __noinline__ int32_t randint_elem(uint32_t k0, uint32_t k1, int i,
                                             int size, int32_t minval,
                                             int32_t maxval, int part) {
  return madraft::randint_elem(k0, k1, i, size, minval, maxval, part);
}


// Draw key j (< kDrawKeys) of the tick from (k0, k1) = fold_in(cluster
// key, t): its site folded in, then its split; into out[0..1]
__device__ __forceinline__ void draw_key(uint32_t k0, uint32_t k1, int j,
                                         int part, int32_t *out) {
  fold_in(k0, k1, j < 4 ? kSiteStart : j == 4 ? kSiteKind : kSiteHint);
  uint32_t d0 = k0, d1 = k1;
  if (j < 4) split_key(k0, k1, 4, j, part, d0, d1);
  if (j == 5) split_key(k0, k1, 2, 0, part, d0, d1);
  out[0] = static_cast<int32_t>(d0);
  out[1] = static_cast<int32_t>(d1);
}

// ------------------------------------------------------------ leaf access
// A load from an input of K9: the inputs stay as they are for the whole
// launch (K9 writes a new state), so the loads go through the read-only
// cache and the compiler may issue them ahead of the stores
template <typename T>
__device__ __forceinline__ T ld(const T *x) {
#ifdef __CUDA_ARCH__
  return __ldg(x);
#else
  return *x;
#endif
}

// A row of an input, read through ld
template <typename T>
struct Ro {
  const T *x;
  __device__ __forceinline__ T operator[](int i) const { return ld(x + i); }
  __device__ __forceinline__ Ro operator+(int i) const { return {x + i}; }
};

template <typename T>
__device__ __forceinline__ Ro<T> in_row(const Params &p, int l, int c) {
  return {static_cast<const T *>(p.leaf[l].in) +
          static_cast<int64_t>(c) * p.leaf[l].count};
}

template <typename T>
__device__ __forceinline__ T *out_row(const Params &p, int l, int c) {
  return static_cast<T *>(p.leaf[l].out) +
         static_cast<int64_t>(c) * p.leaf[l].count;
}

template <typename T>
__device__ __forceinline__ Ro<T> read_row(const Params &p, int r, int c,
                                          int count) {
  return {static_cast<const T *>(p.read[r]) +
          static_cast<int64_t>(c) * count};
}

// K9's environment for cluster c: its region ws in the warp's shared
// memory (every leaf's new row but the two log rows, which K9 writes to
// their outputs), the pre-tick values from the inputs, the stepped raft
// rows staged in ws
struct K9Env {
  static constexpr bool kMet = kMetrics;
  const Params &p;
  int32_t *ws;
  int c;
  __device__ int lanes() const { return kLanes; }
  __device__ const Dims &d() const { return p.d; }
  __device__ const Layout &L() const { return p.L; }
  __device__ int n() const { return p.d.n; }
  __device__ int cap() const { return p.d.cap; }
  // leaf l's row in the region (the tick's new values), a scratch word
  __device__ int32_t *w(int l) const { return ws + p.leaf[l].off; }
  __device__ int32_t *s(int off) const { return ws + off; }
  __device__ uint8_t *wb(int l) const {
    return reinterpret_cast<uint8_t *>(ws + p.leaf[l].off);
  }
  // leaf l's pre-tick row
  __device__ Ro<int32_t> pre(int l) const { return in_row<int32_t>(p, l, c); }
  __device__ Ro<uint8_t> pre_b(int l) const {
    return in_row<uint8_t>(p, l, c);
  }
  // the stepped raft state
  __device__ int32_t tick() const {
    return read_row<int32_t>(p, kTick, c, 1)[0];
  }
  __device__ const int32_t *raft(int r) const {
    return ws + p.L.raft + r * p.d.n;
  }
  __device__ const int32_t *term() const { return raft(kRTerm); }
  __device__ const int32_t *role() const { return raft(kRRole); }
  __device__ const int32_t *base() const { return raft(kRBase); }
  __device__ const int32_t *commit() const { return raft(kRCommit); }
  __device__ bool alive(int i) const { return raft(kRAlive)[i] != 0; }
  __device__ int32_t snap_src(int i) const {
    return read_row<int32_t>(p, kSnapSrc, c, p.d.n)[i];
  }
  __device__ const int32_t *shadow_val() const { return ws + p.L.sh_val; }
  __device__ int32_t shadow_base() const {
    return read_row<int32_t>(p, kShadowBase, c, 1)[0];
  }
  __device__ int32_t shadow_len() const {
    return read_row<int32_t>(p, kShadowLen, c, 1)[0];
  }
  // the pre-tick views
  __device__ bool pre_alive(int i) const {
    return read_row<uint8_t>(p, kPreAlive, c, p.d.n)[i] != 0;
  }
  __device__ int32_t pre_base(int i) const {
    return read_row<int32_t>(p, kPreBase, c, p.d.n)[i];
  }
  __device__ int32_t pre_shadow_len() const {
    return read_row<int32_t>(p, kPreShadowLen, c, 1)[0];
  }
  __device__ float kf(int k) const {
    return read_row<float>(p, kKnobF, c, kNF)[k];
  }
  __device__ int32_t ki(int k) const {
    return read_row<int32_t>(p, kKnobI, c, kNI)[k];
  }
  // the log: node i's log_val row before the submits (the input), the
  // log_len the submits move, an appended entry (to the outputs)
  __device__ Ro<int32_t> log_val(int i) const {
    return in_row<int32_t>(p, kLogVal, c) + i * p.d.cap;
  }
  __device__ int32_t *log_len() const { return w(kLogLen); }
  __device__ void append(int i, int pos, int32_t term, int32_t val) const {
    out_row<int32_t>(p, kLogTerm, c)[i * p.d.cap + pos] = term;
    out_row<int32_t>(p, kLogVal, c)[i * p.d.cap + pos] = val;
  }
  __device__ int32_t &violations() const { return w(kViolations)[0]; }
  __device__ int32_t &first_violation() const {
    return w(kFirstViolation)[0];
  }
  // after the submits: the fsync watermark follows the log where it grew
  // (state.durable_after_append) and the compaction floor is the apply
  // cursor
  __device__ void submitted() const {
    const Ro<int32_t> log_len0 = pre(kLogLen);
    const int32_t *len = w(kLogLen), *applied = w(kApplied);
    int32_t *durable = w(kDurableLen), *floor_ = w(kCompactFloor);
    for (int i = 0; i < p.d.n; ++i) {
      if (len[i] > log_len0[i]) durable[i] = len[i];
      floor_[i] = applied[i];
    }
  }
};

// ------------------------------------------------------- the service tick
// The worst-op register's candidate: the argmax of where(mask, lat, -1)
// over the clerks (the first on ties) with that clerk's fields
struct Worst {
  bool any;
  int32_t best, lat, key, client, sub;
  int32_t ph[kPhases];
};

__device__ __forceinline__ void worst_see(Worst &w, int cl, bool mask,
                                          int32_t lat, const int32_t ph[],
                                          int32_t key, int32_t sub) {
  const int32_t v = mask ? lat : -1;
  if (cl == 0 || v > w.best) {
    w.best = v;
    w.lat = lat;
    w.key = key;
    w.client = cl;
    w.sub = sub;
    for (int q = 0; q < kPhases; ++q) w.ph[q] = ph[q];
  }
  w.any |= mask;
}

// The worst-op register after one fold: the clerks' candidates (cand,
// [nc, kWorstWords]) reduced in client order, then the register updated
template <class E>
__device__ __forceinline__ void worst_apply(const E &e, const int32_t *cand) {
  Worst w{};
  for (int cl = 0; cl < e.d().nc; ++cl) {
    const int32_t *x = cand + cl * kWorstWords;
    worst_see(w, cl, x[0] != 0, x[1], x + 4, x[2], x[3]);
  }
  int32_t *lat = e.w(kWorstLat);
  int32_t *sub = e.w(kWorstSub);
  if (!(w.any && (w.lat > lat[0] || sub[0] == 0))) return;
  lat[0] = w.lat;
  e.w(kWorstKey)[0] = w.key;
  e.w(kWorstClient)[0] = w.client;
  sub[0] = w.sub;
  int32_t *ph = e.w(kWorstPhases);
  for (int q = 0; q < kPhases; ++q) ph[q] = w.ph[q];
}

__device__ __forceinline__ void worst_put(int32_t *x, bool mask, int32_t lat,
                                          const int32_t ph[], int32_t key,
                                          int32_t sub) {
  x[0] = mask;
  x[1] = lat;
  x[2] = key;
  x[3] = sub;
  for (int q = 0; q < kPhases; ++q) x[4 + q] = ph[q];
}

// One acked op into the clerk folds (fold_latencies, fold_phases and the
// per-key / per-client rows of fold_latencies_by); the clerks' lanes fold
// at once, so every add is a shared one
template <class E>
__device__ __forceinline__ void fold_op(const E &e, int32_t lat,
                                        const int32_t ph[], int32_t key,
                                        int cl) {
  const int hb = e.d().hb;
  const int b = bucket_of(lat, hb);
  shared_add(e.w(kLatHist) + b, 1);
  int32_t *phist = e.w(kPhaseHist);
  int32_t *pticks = e.w(kPhaseTicks);
  for (int q = 0; q < kPhases; ++q) {
    shared_add(phist + q * hb + bucket_of(ph[q], hb), 1);
    shared_add(pticks + q, ph[q]);
  }
  shared_add(e.w(kLatTicks), lat);
  if (key >= 0 && key < e.d().nk)
    shared_add(e.w(kKeyLatHist) + key * hb + b, 1);
  shared_add(e.w(kClientLatHist) + cl * hb + b, 1);
}

// The tick's scratch that starts cleared: the clerks' shadow flags and
// the violation bits
__device__ __forceinline__ void clear_tick(const Layout &L, int32_t *ws,
                                           int nc, int lane, int lanes) {
  for (int cl = lane; cl < nc; cl += lanes) ws[L.flag + cl] = 0;
  if (lane == 0) ws[L.viol] = 0;
}

// Phase scan: the committed truth per key (a shadow lane a thread, each
// deduped against the whole window), whether each clerk's op is in the
// live shadow (a (clerk, lane) pair a thread), and the apply machines'
// crash reset, compaction capture and install-snapshot (a table cell a
// thread; an install adopts the sender's PRE-tick snapshot)
template <class E>
__device__ __forceinline__ void scan(const E &e, int lane) {
  const Layout &L = e.L();
  const int n = e.n(), cap = e.cap(), nc = e.d().nc, nk = e.d().nk;
  const int lanes = e.lanes();
  const int32_t *val = e.shadow_val();
  const int32_t sh_base = e.shadow_base();
  const int32_t sh_len = e.shadow_len();
  const int32_t pre_len = e.pre_shadow_len();
  const auto tmax0 = e.pre(kTruthMaxSeq);
  int32_t *truth = e.w(kTruthCount);
  int32_t *tmax = e.w(kTruthMaxSeq);
  for (int q = lane; q < cap; q += lanes) {
    const int32_t aq = shadow_abs(sh_base, q, cap);
    const int32_t v = val[q];
    if (!(aq > pre_len && aq <= sh_len && v != kNoop)) continue;
    // a lane new this tick with the same value at an earlier index
    bool dup_earlier = false;
    for (int r = 0; r < cap; ++r) {
      const int32_t ar = shadow_abs(sh_base, r, cap);
      dup_earlier |= val[r] == v && ar > pre_len && ar < aq;
    }
    const Op o = unpack(v, nk, nc);
    if (o.seq > tmax0[o.client] && !dup_earlier && o.kind != kGet)
      shared_add(truth + o.key, 1);
    shared_max(tmax + o.client, o.seq);
  }

  const auto clerk_seq0 = e.pre(kClerkSeq);
  const auto clerk_key0 = e.pre(kClerkKey);
  const auto clerk_kind0 = e.pre(kClerkKind);
  for (int x = lane; x < nc * cap; x += lanes) {
    const int cl = x / cap, i = x % cap;
    const int32_t want = pack(cl, clerk_seq0[cl], clerk_key0[cl],
                              clerk_kind0[cl], nk);
    if (val[i] == want && shadow_abs(sh_base, i, cap) <= sh_len)
      shared_or(e.s(L.flag) + cl, 1);
  }

  const int32_t *base = e.base();
  for (int i = lane; i < n; i += lanes) {
    const bool fresh = !e.pre_alive(i) || !e.alive(i);
    const bool inst = e.snap_src(i) >= 0;
    if (fresh || inst) e.w(kApplied)[i] = base[i];
  }
  // the live tables (nc columns: last_seq, apply_count; nk: key_hash,
  // key_count) and their snapshots, a table after another
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int wd = g < 2 ? nc : nk;
    const int live = kLastSeq + g, snap = kSnapLastSeq + g;
    const auto sn0 = e.pre(snap);
    int32_t *lv = e.w(live);
    int32_t *sn = e.w(snap);
    for (int x = lane; x < n * wd; x += lanes) {
      const int i = x / wd, el = x % wd;
      const bool fresh = !e.pre_alive(i) || !e.alive(i);
      const int src = e.snap_src(i);
      const bool inst = src >= 0;
      const bool comp = base[i] != e.pre_base(i) && !inst && e.alive(i);
      if (fresh) lv[x] = sn0[x];
      if (comp) sn[x] = lv[x];
      if (inst) {
        // the sender's PRE-tick snapshot (0 for a sender out of range)
        lv[x] = sn[x] = src < n ? sn0[src * wd + el] : 0;
      }
    }
  }
}

// Phase apply: apply_max rounds of the apply loop, a node a thread (a
// node's rounds are sequential, the nodes independent), then the node's
// exactly-once check. The rounds' Get observations go to the scratch
// (first, first_obs) for observe. The log rows are the raft tick's, read
// before any submit appends
template <class E>
__device__ __forceinline__ void apply(const E &e, int lane) {
  const Layout &L = e.L();
  const int n = e.n(), cap = e.cap(), nc = e.d().nc, nk = e.d().nk;
  const int apply_max = e.d().apply_max;
  if (lane >= n) return;
  const int i = lane;
  const bool stale_read = e.ki(kBugStaleRead) != 0;
  const bool uncommitted = e.ki(kBugApplyUncommitted) != 0;
  const bool skip_dedup = e.ki(kBugSkipDedup) != 0;
  const bool alive = e.alive(i);
  const int32_t limit = uncommitted ? e.log_len()[i] : e.commit()[i];
  const auto log_val0 = e.log_val(i);
  const auto clerk_seq0 = e.pre(kClerkSeq);
  int32_t *last_seq = e.w(kLastSeq) + i * nc;
  int32_t *apply_count = e.w(kApplyCount) + i * nc;
  int32_t *key_hash = e.w(kKeyHash) + i * nk;
  int32_t *key_count = e.w(kKeyCount) + i * nk;
  int32_t *first = e.s(L.first) + i * nc;
  int32_t *first_obs = e.s(L.first_obs) + i * nc;
  int32_t &applied = e.w(kApplied)[i];
  int32_t viol = 0;
  for (int cl = 0; cl < nc; ++cl) first[cl] = apply_max;
  // one round that runs (the cursor below its limit): the cursor's slot
  auto round_of = [&](int round, int32_t val) {
    applied = wrap_add(applied, 1);
    if (val == kNoop) return;
    const Op o = unpack(val, nk, nc);
    int32_t &ls = last_seq[o.client];
    const int32_t prev = ls;
    const bool dup = o.seq <= prev;
    if (!stale_read && !dup && o.seq > wrap_add(prev, 1))
      viol |= kViolExactlyOnce;
    const bool d = skip_dedup || !dup;
    if (d && o.kind != kGet) {
      key_hash[o.key] = static_cast<int32_t>(
          static_cast<uint32_t>(key_hash[o.key]) * 1000003u +
          static_cast<uint32_t>(val));
      key_count[o.key] = wrap_add(key_count[o.key], 1);
    }
    if (d) apply_count[o.client] = wrap_add(apply_count[o.client], 1);
    ls = prev > o.seq ? prev : o.seq;
    if (d && o.kind == kGet && o.seq == clerk_seq0[o.client] &&
        key_count[o.key] >= 0 && first[o.client] == apply_max) {
      first[o.client] = round;
      first_obs[o.client] = key_count[o.key];
    }
  };
  const auto slot = [&](uint32_t a) {
    return static_cast<int>(a & static_cast<uint32_t>(cap - 1));
  };
  // a round that runs advances the cursor by one, and one that does not
  // leaves it, so every later round, as it was: the first kAhead rounds'
  // slots are the cursor's next ones, loaded at once
  constexpr int kAhead = 8;
  int32_t ahead[kAhead];
  const uint32_t a0 = static_cast<uint32_t>(applied);
#pragma unroll
  for (int r = 0; r < kAhead; ++r)
    ahead[r] = r < apply_max ? log_val0[slot(a0 + r)] : 0;
#pragma unroll
  for (int round = 0; round < kAhead; ++round) {
    if (round >= apply_max || !(alive && applied < limit)) break;
    round_of(round, ahead[round]);
  }
  for (int round = kAhead; round < apply_max && alive && applied < limit;
       ++round)
    round_of(round, log_val0[slot(static_cast<uint32_t>(applied))]);
  // exactly-once: ops applied per client == highest seq applied
  if (!stale_read && alive)
    for (int cl = 0; cl < nc; ++cl)
      if (apply_count[cl] != last_seq[cl]) viol |= kViolExactlyOnce;
  if (viol) shared_or(e.s(L.viol), viol);
}

// Phase observe: each clerk's Get observation (the largest a node made
// in the first round any made one), a clerk a thread; the agreement check
// (equal cursors => identical applied state), a node pair a thread
template <class E>
__device__ __forceinline__ void observe(const E &e, int lane) {
  const Layout &L = e.L();
  const int n = e.n(), nc = e.d().nc, nk = e.d().nk;
  const int apply_max = e.d().apply_max, lanes = e.lanes();
  int32_t *get_obs = e.w(kClerkGetObs);
  for (int cl = lane; cl < nc; cl += lanes) {
    if (get_obs[cl] >= 0) continue;
    int round = apply_max;
    int32_t obs = -1;
    for (int i = 0; i < n; ++i) {
      const int r = e.s(L.first)[i * nc + cl];
      const int32_t o = e.s(L.first_obs)[i * nc + cl];
      if (r < round || (r == round && r < apply_max && o > obs)) {
        round = r;
        obs = o;
      }
    }
    if (round < apply_max) get_obs[cl] = obs;
  }
  const int32_t *applied = e.w(kApplied);
  const int32_t *key_hash = e.w(kKeyHash);
  const int32_t *key_count = e.w(kKeyCount);
  for (int x = lane; x < n * n; x += lanes) {
    const int i = x / n, j = x % n;
    if (!(i < j && applied[i] == applied[j] && applied[i] > 0 &&
          e.alive(i) && e.alive(j)))
      continue;
    for (int k = 0; k < nk; ++k)
      if (key_hash[i * nk + k] != key_hash[j * nk + k] ||
          key_count[i * nk + k] != key_count[j * nk + k]) {
        shared_or(e.s(L.viol), kViolDiverge);
        break;
      }
  }
}

// Clerk cl of phase clerks: the ack, the stale-read oracle, the open-loop
// arrival, a fresh op or a retry, the hint routing, the bug mode's local
// serve, and the reply to the submit (the hint and the await countdown;
// the reply reads nothing the submits write). It reads its own pre-tick
// values before it writes any
template <class E>
__device__ __forceinline__ void clerk(const E &e, int cl) {
  const Layout &L = e.L();
  const int n = e.n(), nc = e.d().nc, nk = e.d().nk, part = e.d().part;
  const int32_t t = e.tick();
  const int32_t *term = e.term();
  const int32_t *role = e.role();
  const bool stale_read = e.ki(kBugStaleRead) != 0;
  const int32_t *truth = e.w(kTruthCount);
  const int32_t *k_count = e.w(kKeyCount);
  int32_t *get_obs = e.w(kClerkGetObs);
  int32_t viol = 0;

  const int32_t ck = e.pre(kClerkKey)[cl];
  const int32_t cs = e.pre(kClerkSeq)[cl];
  const int32_t kind0 = e.pre(kClerkKind)[cl];
  const bool out0 = e.pre_b(kClerkOut)[cl] != 0;
  int32_t obs = get_obs[cl];
  const int32_t truth_at = ck >= 0 && ck < nk ? truth[ck] : 0;
  const bool in_shadow = e.s(L.flag)[cl] != 0;
  const bool is_get = kind0 == kGet;
  int32_t sub = 0, app = 0, cmt = 0, apl = 0;
  if constexpr (E::kMet) {
    sub = e.pre(kClerkSub)[cl];
    app = e.pre(kClerkApp)[cl];
    cmt = e.pre(kClerkCmt)[cl];
    apl = e.pre(kClerkApl)[cl];
    if (out0 && in_shadow && cmt == 0) cmt = t;
    if (out0 && obs >= 0 && apl == 0) apl = t;
  }
  const bool newly = out0 && in_shadow && (!is_get || obs >= 0);
  const bool done_get = newly && is_get;
  if (done_get && (obs < e.pre(kClerkGetLo)[cl] || obs > truth_at))
    viol |= kViolStale;
  int32_t acked = newly ? cs : e.pre(kClerkAcked)[cl];
  bool cout = out0 && !newly;
  int32_t gets = wrap_add(e.pre(kGetsDone)[cl], done_get);
  int32_t last_obs = done_get ? obs : e.pre(kClerkLastObs)[cl];
  if constexpr (E::kMet) {
    const int32_t e2e = wrap_sub(t, sub);
    // clerk_phase_matrix: the stamps clamped monotone
    const int32_t app_e = app > sub ? app : sub;
    const int32_t cmt_e = cmt > app_e ? cmt : app_e;
    const int32_t b3 = is_get ? (apl > cmt_e ? apl : cmt_e) : cmt_e;
    const int32_t ph[kPhases] = {wrap_sub(app_e, sub), wrap_sub(cmt_e, app_e),
                                 wrap_sub(b3, cmt_e), wrap_sub(t, b3)};
    if (newly) fold_op(e, e2e, ph, ck, cl);
    worst_put(e.s(L.worst) + cl * kWorstWords, newly, e2e, ph, ck, sub);
  }

  // the draws, from the tick's keys
  uint32_t kk[kDrawKeys][2];
  for (int j = 0; j < kDrawKeys; ++j) {
    kk[j][0] = static_cast<uint32_t>(e.s(L.draws)[2 * j]);
    kk[j][1] = static_cast<uint32_t>(e.s(L.draws)[2 * j + 1]);
  }

  // open-loop arrivals (from the start word's free low 9 bits)
  const uint32_t w_start = bits_word(kk[0][0], kk[0][1], cl, nc, part);
  const float u_start = madraft::as_float((w_start >> 9) | 0x3F800000u) - 1.0f;
  const int32_t qcap = e.ki(kQueueCap);
  const bool openloop = qcap > 0;
  const bool arrive = openloop &&
      fmul(static_cast<float>(w_start & 0x1FFu), 1.0f / 512.0f) <
          e.kf(kOpenRate);
  const int32_t arr0 = e.pre(kOpenArr)[cl];
  const int32_t srv0 = e.pre(kOpenSrv)[cl];
  const bool drop = arrive && wrap_sub(arr0, srv0) >= qcap;
  const bool enq = arrive && !drop;
  const int32_t arr = wrap_add(arr0, enq);
  int32_t *stamp = E::kMet ? e.w(kOpenStamp) + cl * kQueueSlots : nullptr;
  if (E::kMet && enq) stamp[floor_mod(arr0, kQueueSlots)] = t;
  const bool start = !cout &&
      (openloop ? arr > srv0 : u_start < e.kf(kPOp)) && cs < kSeqLim - 1;
  const int32_t seq = start ? wrap_add(cs, 1) : cs;
  const int32_t draw = randint_elem(kk[1][0], kk[1][1], cl, nc, 0, nk, part);
  const int32_t ckey = start ? zipf_map(draw, nk, e.kf(kZipfA)) : ck;
  const float u_kind = madraft::uniform(
      bits_word(kk[4][0], kk[4][1], cl, nc, part));
  const int32_t kind = !start ? kind0
      : u_kind < e.kf(kPGet) ? kGet
      : u_kind < fadd(e.kf(kPGet), e.kf(kPPut)) ? kPut : kAppend;
  const int32_t truth_new = ckey >= 0 && ckey < nk ? truth[ckey] : 0;
  const int32_t get_lo = start ? truth_new : e.pre(kClerkGetLo)[cl];
  if (start) obs = -1;
  if (E::kMet && start) {
    sub = openloop ? stamp[floor_mod(srv0, kQueueSlots)] : t;
    app = cmt = apl = 0;
  }
  cout = cout || start;
  const float u_retry = madraft::uniform(
      bits_word(kk[2][0], kk[2][1], cl, nc, part));
  const int32_t wait0 = e.pre(kClerkWait)[cl];
  bool rt = cout && (start || (u_retry < e.kf(kPRetry) && wait0 <= 0));
  if constexpr (E::kMet) {
    int32_t &rr = e.w(kClientRetries)[cl];
    rr = wrap_add(rr, rt);
  }
  int32_t tgt = randint_elem(kk[3][0], kk[3][1], cl, nc, 0, n, part);
  const int32_t leader0 = e.pre(kClerkLeader)[cl];
  const float u_follow = madraft::uniform(
      bits_word(kk[5][0], kk[5][1], cl, nc, part));
  if (u_follow < e.kf(kPFollow) && leader0 >= 0)
    tgt = leader0 > n - 1 ? n - 1 : leader0;

  // the bug mode: the contacted node serves a Get from its own state
  const int32_t local_cnt =
      ckey >= 0 && ckey < nk ? k_count[tgt * nk + ckey] : 0;
  const bool served = stale_read && rt && !start && kind == kGet &&
                      e.alive(tgt);
  if (served && (local_cnt < get_lo || local_cnt > truth_new))
    viol |= kViolStale;
  if (served) {
    acked = seq;
    cout = false;
    gets = wrap_add(gets, 1);
    rt = false;
    last_obs = local_cnt;
  }
  if constexpr (E::kMet) {
    const int32_t e2e_s = wrap_sub(t, sub);
    const int32_t ph[kPhases] = {0, 0, e2e_s, 0};
    if (served) fold_op(e, e2e_s, ph, ckey, cl);
    worst_put(e.s(L.worst) + (nc + cl) * kWorstWords, served, e2e_s, ph,
              ckey, sub);
    e.w(kClerkSub)[cl] = sub;
    e.w(kClerkApp)[cl] = app;
    e.w(kClerkCmt)[cl] = cmt;
    e.w(kClerkApl)[cl] = apl;
  }
  e.w(kClerkSeq)[cl] = seq;
  e.wb(kClerkOut)[cl] = cout;
  e.w(kClerkKey)[cl] = ckey;
  e.w(kClerkKind)[cl] = kind;
  e.w(kClerkAcked)[cl] = acked;
  e.w(kOpenArr)[cl] = arr;
  e.w(kOpenSrv)[cl] = wrap_add(srv0, openloop && start);
  e.w(kOpenDrop)[cl] = wrap_add(e.pre(kOpenDrop)[cl], drop);
  e.w(kClerkGetLo)[cl] = get_lo;
  get_obs[cl] = obs;
  e.w(kClerkLastObs)[cl] = last_obs;
  e.w(kGetsDone)[cl] = gets;
  e.s(L.target)[cl] = tgt;
  e.s(L.retry)[cl] = rt;
  if (viol) shared_or(e.s(L.viol), viol);

  // the submit's reply: the leader hint (argmax picks the first node of
  // the highest live leader term, 0 when there is none) and the countdown
  int32_t lead_term = -1;
  bool any_lead = false;
  for (int i = 0; i < n; ++i)
    if (e.alive(i) && role[i] == kLeader) {
      any_lead = true;
      if (term[i] > lead_term) lead_term = term[i];
    }
  int lead_node = 0;
  for (int i = n - 1; i >= 0; --i)
    if (e.alive(i) && role[i] == kLeader && term[i] == lead_term)
      lead_node = i;
  const bool is_lead = e.alive(tgt) && role[tgt] == kLeader;
  int32_t hint;
  if (e.ki(kBugStaleHint) != 0) {
    int ring = (tgt + 1) % n;
    if (any_lead && ring == lead_node) ring = (ring + 1) % n;
    hint = ring;
  } else {
    hint = any_lead && term[tgt] == lead_term ? lead_node : -1;
  }
  e.w(kClerkLeader)[cl] =
      !rt ? leader0 : is_lead ? tgt : e.alive(tgt) ? hint : -1;
  e.w(kClerkWait)[cl] =
      rt && is_lead ? e.ki(kRetryWait) : (wait0 - 1 > 0 ? wait0 - 1 : 0);
}

// Phase clerks: a clerk a thread (K6-kv's 16 lanes take clerks 16 on
// twice)
template <class E>
__device__ __forceinline__ void clerks(const E &e, int lane) {
  for (int cl = lane; cl < e.d().nc; cl += e.lanes()) clerk(e, cl);
}

// Phase submit, one thread: the worst-op register, the violation bits,
// the submits appended at self-believed leaders one client after another
// (client c's append reads the log_len client c - 1 moved), and the raft
// leaves they move
template <class E>
__device__ __forceinline__ void submit(const E &e) {
  const Layout &L = e.L();
  const int cap = e.cap(), nc = e.d().nc;
  const int32_t t = e.tick();
  const int32_t *term = e.term();
  const int32_t *role = e.role();
  const int32_t *base = e.base();
  const int32_t *commit = e.commit();
  const int32_t flow_cap = e.ki(kFlowCap);
  if constexpr (E::kMet) {
    worst_apply(e, e.s(L.worst));
    worst_apply(e, e.s(L.worst) + nc * kWorstWords);
  }
  const int32_t viol = e.s(L.viol)[0];
  e.violations() |= viol;
  int32_t &fvt = e.first_violation();
  if (fvt < 0 && viol != 0) fvt = t;

  int32_t *log_len = e.log_len();
  for (int cl = 0; cl < nc; ++cl) {
    const int i = e.s(L.target)[cl];
    const bool ok = e.s(L.retry)[cl] && e.alive(i) && role[i] == kLeader &&
                    wrap_sub(log_len[i], base[i]) < cap &&
                    wrap_sub(log_len[i], commit[i]) < flow_cap;
    if (!ok) continue;
    const int pos = static_cast<int>(static_cast<uint32_t>(log_len[i]) &
                                     static_cast<uint32_t>(cap - 1));
    e.append(i, pos, term[i],
             pack(cl, e.w(kClerkSeq)[cl], e.w(kClerkKey)[cl],
                  e.w(kClerkKind)[cl], e.d().nk));
    log_len[i] = wrap_add(log_len[i], 1);
    if (E::kMet && e.wb(kClerkOut)[cl]) {
      int32_t &app = e.w(kClerkApp)[cl];
      if (app == 0) app = t;
    }
  }
  e.submitted();
}

// ------------------------------------------------------------ K9's tick
// The region's staged element e of leaf g (the truth's max seq clamped at
// 0: the reference's max takes in a 0), its load from cluster c's input
// row and its store to c's output row
__device__ __forceinline__ int32_t load_elem(const LeafRef &g, int c, int e) {
  const int64_t at = static_cast<int64_t>(c) * g.count + e;
  return g.bytes == 4 ? ld(static_cast<const int32_t *>(g.in) + at)
                      : ld(static_cast<const uint8_t *>(g.in) + at);
}

__device__ __forceinline__ void stage_elem(const LeafRef &g, int32_t *ws,
                                           int e, int32_t v, bool clamp) {
  if (g.bytes == 4)
    ws[g.off + e] = clamp && v < 0 ? 0 : v;
  else
    reinterpret_cast<uint8_t *>(ws + g.off)[e] = static_cast<uint8_t>(v);
}

__device__ __forceinline__ void store_elem(const LeafRef &g,
                                           const int32_t *ws, int c, int e) {
  const int64_t at = static_cast<int64_t>(c) * g.count + e;
  if (g.bytes == 4)
    static_cast<int32_t *>(g.out)[at] = ws[g.off + e];
  else
    static_cast<uint8_t *>(g.out)[at] =
        reinterpret_cast<const uint8_t *>(ws + g.off)[e];
}

// The leaf table's copy in shared memory, before the warps' regions: the
// copy loops read a leaf's fields at a runtime index, which the kernel's
// parameters serve slowly
constexpr int kTableBytes = (kLeaves * static_cast<int>(sizeof(LeafRef)) +
                             15) / 16 * 16;
// The leaves whose loads the copy loops keep in flight at once
constexpr int kGroup = 8;

// K9's phase kStage: every leaf's row from its input into the warp's
// region (the two log rows straight to their outputs), the stepped raft
// rows, the shadow window's values and the tick's draw keys, the scratch
// cleared. The tick then updates the region, and reads the pre-tick
// values from the inputs (K9Env)
__device__ __forceinline__ void stage(const Params &p, const LeafRef *tab,
                                      int32_t *ws, int c, int lane) {
  const Dims &d = p.d;
  const Layout &L = p.L;
  const int32_t sv = lane < d.cap ? read_row<int32_t>(p, kShadowVal, c,
                                                      d.cap)[lane] : 0;
  int32_t rr[kRaftRows] = {};
  if (lane < d.n) {
    rr[kRTerm] = read_row<int32_t>(p, kTerm, c, d.n)[lane];
    rr[kRRole] = read_row<int32_t>(p, kRole, c, d.n)[lane];
    rr[kRAlive] = read_row<uint8_t>(p, kAlive, c, d.n)[lane] != 0;
    rr[kRBase] = read_row<int32_t>(p, kBase, c, d.n)[lane];
    rr[kRCommit] = read_row<int32_t>(p, kCommit, c, d.n)[lane];
  }
  // the tick's keys: fold_in(key, t), then the sites, a key a lane while
  // the loads are in flight
  if (lane < kDrawKeys) {
    const Ro<uint32_t> key = read_row<uint32_t>(p, kKeys, c, 4);
    uint32_t k0 = key[0], k1 = key[2];  // the int64 words' low halves
    fold_in(k0, k1, static_cast<uint32_t>(
        read_row<int32_t>(p, kTick, c, 1)[0]));
    draw_key(k0, k1, lane, d.part, ws + L.draws + 2 * lane);
  }
  if (lane < d.cap) ws[L.sh_val + lane] = sv;
  if (lane < d.n)
    for (int r = 0; r < kRaftRows; ++r) ws[L.raft + r * d.n + lane] = rr[r];
  // every staged row's element `lane`, kGroup leaves' loads in flight at
  // once (a leaf's load and store after another's would wait out the
  // memory's latency once a leaf), then the rows' elements from kLanes on
  // and the log rows
#pragma unroll 1
  for (int l0 = 0; l0 < kLeaves; l0 += kGroup) {
    int32_t v[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int l = l0 + k;
      v[k] = l < kLeaves && tab[l].off >= 0 && lane < tab[l].count
                 ? load_elem(tab[l], c, lane) : 0;
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int l = l0 + k;
      if (l < kLeaves && tab[l].off >= 0 && lane < tab[l].count)
        stage_elem(tab[l], ws, lane, v[k], l == kTruthMaxSeq);
    }
  }
#pragma unroll 1
  for (int l = 0; l < kLeaves; ++l) {
    const LeafRef g = tab[l];
    if (g.off >= 0) {
      for (int e = lane + kLanes; e < g.count; e += kLanes)
        stage_elem(g, ws, e, load_elem(g, c, e), l == kTruthMaxSeq);
      continue;
    }
    const Ro<int32_t> src = {static_cast<const int32_t *>(g.in) +
                             static_cast<int64_t>(c) * g.count};
    int32_t *dst = static_cast<int32_t *>(g.out) +
                   static_cast<int64_t>(c) * g.count;
#pragma unroll 4
    for (int e = lane; e < g.count; e += kLanes) dst[e] = src[e];
  }
  const Ro<int32_t> shadow_val = read_row<int32_t>(p, kShadowVal, c, d.cap);
  for (int i = lane + kLanes; i < d.cap; i += kLanes)
    ws[L.sh_val + i] = shadow_val[i];
  clear_tick(L, ws, d.nc, lane, kLanes);
}

// K9's phase kWriteBack: the region's rows to the leaves' outputs, kGroup
// leaves at once, then the rows' elements from kLanes on
__device__ __forceinline__ void write_back(const LeafRef *tab, int32_t *ws,
                                           int c, int lane) {
#pragma unroll 1
  for (int l0 = 0; l0 < kLeaves; l0 += kGroup) {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int l = l0 + k;
      if (l < kLeaves && tab[l].off >= 0 && lane < tab[l].count)
        store_elem(tab[l], ws, c, lane);
    }
  }
#pragma unroll 1
  for (int l = 0; l < kLeaves; ++l) {
    const LeafRef g = tab[l];
    if (g.off >= 0)
      for (int e = lane + kLanes; e < g.count; e += kLanes)
        store_elem(g, ws, c, e);
  }
}

// Lane `lane` of cluster c's warp in K9's phase `phase` (kSubmit runs on
// lane 0 alone); tab is the leaf table (p.leaf, or its copy in shared
// memory), ws the warp's region of Layout::words words
__device__ __forceinline__ void run_phase(const Params &p,
                                          const LeafRef *tab, int32_t *ws,
                                          int c, int lane, int phase) {
  const K9Env e{p, ws, c};
  switch (phase) {
    case kStage: stage(p, tab, ws, c, lane); break;
    case kScan: scan(e, lane); break;
    case kApply: apply(e, lane); break;
    case kObserve: observe(e, lane); break;
    case kClerks: clerks(e, lane); break;
    case kSubmit: if (lane == 0) submit(e); break;
    default: write_back(tab, ws, c, lane); break;
  }
}

}  // namespace k9
