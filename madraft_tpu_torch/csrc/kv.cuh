// K9's device code: one kv service tick of one cluster, by the 32 lanes
// of a warp (kv.cu holds the kernel, its launch and the note on what it
// replaces, its bound and design). Built by nvcc through kv.cu, and by g++
// through tests/kv_host_emu.cpp.
//
// The tick runs as seven phases (Phase), a warp barrier after each. Within
// a phase the lanes share nothing but commutative updates of the warp's
// shared region (atomic add, or, max): so the host runs a phase's 32 lanes
// one after another, then the next phase, and gets the card's result.
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

constexpr int kLanes = 32;
constexpr int kMaxNodes = 16;    // a node a lane in kApply
constexpr int kMaxCap = 256;
constexpr int kMaxClients = 32;  // a clerk a lane in kClerks
constexpr int kMaxKeys = 64;
constexpr int kQueueSlots = 8;   // config.OPEN_QUEUE_SLOTS
constexpr int kPhases = 4;       // config.LATENCY_PHASES
constexpr int kSeqLim = 1 << 15;
constexpr int32_t kNoop = 1 << 30;  // config.NOOP_CMD
constexpr int32_t kLeader = 2;
constexpr int kGet = 1, kPut = 2, kAppend = 0;
constexpr int32_t kViolExactlyOnce = 8, kViolDiverge = 16, kViolStale = 32;
constexpr uint32_t kSiteStart = 8, kSiteKind = 14, kSiteHint = 15;

// The leaves K9 writes: the service leaves in KvState order, then the raft
// leaves the service tick writes (kernels/kv.py LEAVES)
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

// The read-only inputs: the stepped raft state's leaves, the pre-tick
// views, the keys and the knob table (kernels/kv.py READS)
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

// The wrapper's descriptor (kernels/kv.py _descriptor): this header, the
// kReads pointers, then 4 words a leaf (in, out, count a cluster, bytes an
// element)
enum Desc {
  kB, kN, kCap, kNc, kNk, kApplyMax, kHb, kNph, kPartitionable, kMetricsOn,
  kHeader
};

// The phases of a tick, in order (run_phase)
enum Phase { kStage, kScan, kApply, kObserve, kClerks, kSubmit, kWriteBack,
             kTickPhases };

// A worst-op candidate's words in the warp's region: mask, lat, key, sub,
// then the kPhases phases
constexpr int kWorstWords = 4 + kPhases;

// The tick's draw keys, from fold_in(cluster key, t): the four splits of
// site 8 (the start word, the key draw, the retry, the target), site 14
// (the op's kind) and the first split of site 15 (hint following)
constexpr int kDrawKeys = 6;

// The stepped raft rows the tick reads by node, staged in the warp's
// region (alive as 0 / 1)
enum RaftRow { kRTerm, kRRole, kRAlive, kRBase, kRCommit, kRaftRows };

// A leaf: its input and output, its count of elements a cluster, its
// bytes an element, and its row's offset in a warp's region (-1 for a log
// row: see Params)
struct LeafRef {
  const void *in;
  void *out;
  int count, bytes, off;
};

// The leaf table's copy in shared memory, before the warps' regions: the
// copy loops read a leaf's fields at a runtime index, which the kernel's
// parameters serve slowly
constexpr int kTableBytes = (kLeaves * static_cast<int>(sizeof(LeafRef)) +
                             15) / 16 * 16;
// The leaves whose loads the copy loops keep in flight at once
constexpr int kGroup = 8;

// The warp's shared region, in int32 words: every leaf but the two log
// rows staged at its off (-1 for the log rows, which stay in device
// memory: the tick reads n * apply_max of their slots and appends at most
// nc), then the tick's scratch
struct Params {
  LeafRef leaf[kLeaves];
  const void *read[kReads];
  int b, n, cap, nc, nk, apply_max, hb, nph, partitionable;
  int sh_val;     // [cap] the shadow window's values
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
  int raft;       // [kRaftRows, n] the stepped raft rows (RaftRow)
  int words;      // the region's size
};

template <typename T>
inline T *ptr_of(int64_t w) {
  return reinterpret_cast<T *>(static_cast<intptr_t>(w));
}

inline bool set_params(Params &p, const int64_t *d, int n_desc) {
  constexpr int kWords = int(kHeader) + int(kReads) + 4 * int(kLeaves);
  if (n_desc != kWords) return false;
  p.b = static_cast<int>(d[kB]);
  p.n = static_cast<int>(d[kN]);
  p.cap = static_cast<int>(d[kCap]);
  p.nc = static_cast<int>(d[kNc]);
  p.nk = static_cast<int>(d[kNk]);
  p.apply_max = static_cast<int>(d[kApplyMax]);
  p.hb = static_cast<int>(d[kHb]);
  p.nph = static_cast<int>(d[kNph]);
  p.partitionable = static_cast<int>(d[kPartitionable]);
  if (p.b < 1 || p.n < 1 || p.n > kMaxNodes || p.cap < 1 ||
      p.cap > kMaxCap || (p.cap & (p.cap - 1)) || p.nc < 1 ||
      p.nc > kMaxClients || p.nk < 1 || p.nk > kMaxKeys ||
      p.apply_max < 0 || (d[kMetricsOn] != 0) != kMetrics)
    return false;
  if (kMetrics && (p.hb < 1 || p.hb > 31 || p.nph != kPhases)) return false;
  for (int r = 0; r < kReads; ++r)
    p.read[r] = ptr_of<const void>(d[kHeader + r]);
  int words = 0;
  for (int l = 0; l < kLeaves; ++l) {
    const int64_t *g = d + kHeader + kReads + 4 * l;
    const bool log_row = l == kLogTerm || l == kLogVal;
    p.leaf[l] = {ptr_of<const void>(g[0]), ptr_of<void>(g[1]),
                 static_cast<int>(g[2]), static_cast<int>(g[3]),
                 log_row ? -1 : words};
    if (p.leaf[l].bytes != 1 && p.leaf[l].bytes != 4) return false;
    if (p.leaf[l].count < 0 || p.leaf[l].count > (1 << 16)) return false;
    if (!log_row) words += (p.leaf[l].count * p.leaf[l].bytes + 3) / 4;
  }
  p.sh_val = words;
  p.viol = p.sh_val + p.cap;
  p.flag = p.viol + 1;
  p.first = p.flag + p.nc;
  p.first_obs = p.first + p.n * p.nc;
  p.target = p.first_obs + p.n * p.nc;
  p.retry = p.target + p.nc;
  p.worst = p.retry + p.nc;
  p.draws = p.worst + 2 * p.nc * kWorstWords;
  p.raft = p.draws + 2 * kDrawKeys;
  p.words = p.raft + kRaftRows * p.n;
  return true;
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

// The lanes' commutative updates of a word of the warp's region (on the
// host the lanes run one after another)
__device__ __forceinline__ void shared_add(int32_t *a, int32_t v) {
#ifdef __CUDA_ARCH__
  atomicAdd(a, v);
#else
  *a = wrap_add(*a, v);
#endif
}

__device__ __forceinline__ void shared_or(int32_t *a, int32_t v) {
#ifdef __CUDA_ARCH__
  atomicOr(a, v);
#else
  *a |= v;
#endif
}

__device__ __forceinline__ void shared_max(int32_t *a, int32_t v) {
#ifdef __CUDA_ARCH__
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

// ------------------------------------------------------------ leaf access
// A load from an input: the inputs stay as they are for the whole launch
// (the state is written out of place), so the loads go through the
// read-only cache and the compiler may issue them ahead of the stores
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

// The staged (new) row of leaf l in the warp's region ws
template <typename T>
__device__ __forceinline__ T *work(const Params &p, int32_t *ws, int l) {
  return reinterpret_cast<T *>(ws + p.leaf[l].off);
}

// A staged raft row (RaftRow) in the warp's region ws
__device__ __forceinline__ const int32_t *raft_row(const Params &p,
                                                   const int32_t *ws, int r) {
  return ws + p.raft + r * p.n;
}

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
__device__ __forceinline__ void worst_apply(const Params &p, int32_t *ws,
                                            const int32_t *cand) {
  Worst w{};
  for (int cl = 0; cl < p.nc; ++cl) {
    const int32_t *x = cand + cl * kWorstWords;
    worst_see(w, cl, x[0] != 0, x[1], x + 4, x[2], x[3]);
  }
  int32_t *lat = work<int32_t>(p, ws, kWorstLat);
  int32_t *sub = work<int32_t>(p, ws, kWorstSub);
  if (!(w.any && (w.lat > lat[0] || sub[0] == 0))) return;
  lat[0] = w.lat;
  work<int32_t>(p, ws, kWorstKey)[0] = w.key;
  work<int32_t>(p, ws, kWorstClient)[0] = w.client;
  sub[0] = w.sub;
  int32_t *ph = work<int32_t>(p, ws, kWorstPhases);
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
__device__ __forceinline__ void fold_op(const Params &p, int32_t *ws,
                                        int32_t lat, const int32_t ph[],
                                        int32_t key, int cl) {
  const int hb = p.hb;
  const int b = bucket_of(lat, hb);
  shared_add(work<int32_t>(p, ws, kLatHist) + b, 1);
  int32_t *phist = work<int32_t>(p, ws, kPhaseHist);
  int32_t *pticks = work<int32_t>(p, ws, kPhaseTicks);
  for (int q = 0; q < kPhases; ++q) {
    shared_add(phist + q * hb + bucket_of(ph[q], hb), 1);
    shared_add(pticks + q, ph[q]);
  }
  shared_add(work<int32_t>(p, ws, kLatTicks), lat);
  if (key >= 0 && key < p.nk)
    shared_add(work<int32_t>(p, ws, kKeyLatHist) + key * hb + b, 1);
  shared_add(work<int32_t>(p, ws, kClientLatHist) + cl * hb + b, 1);
}

// Element e of cluster c's input row of leaf g
__device__ __forceinline__ int32_t load_elem(const LeafRef &g, int c, int e) {
  const int64_t at = static_cast<int64_t>(c) * g.count + e;
  return g.bytes == 4 ? ld(static_cast<const int32_t *>(g.in) + at)
                      : ld(static_cast<const uint8_t *>(g.in) + at);
}

// Element e of leaf g's staged row (the truth's max seq clamped at 0: the
// reference's max takes in a 0)
__device__ __forceinline__ void stage_elem(const LeafRef &g, int32_t *ws,
                                           int e, int32_t v, bool clamp) {
  if (g.bytes == 4)
    ws[g.off + e] = clamp && v < 0 ? 0 : v;
  else
    reinterpret_cast<uint8_t *>(ws + g.off)[e] = static_cast<uint8_t>(v);
}

// Element e of leaf g's staged row to cluster c's output row
__device__ __forceinline__ void store_elem(const LeafRef &g,
                                           const int32_t *ws, int c, int e) {
  const int64_t at = static_cast<int64_t>(c) * g.count + e;
  if (g.bytes == 4)
    static_cast<int32_t *>(g.out)[at] = ws[g.off + e];
  else
    static_cast<uint8_t *>(g.out)[at] =
        reinterpret_cast<const uint8_t *>(ws + g.off)[e];
}

// ------------------------------------------------------- the service tick
// Phase kStage: every leaf's row from its input into the warp's region
// (the two log rows straight to their outputs), the stepped raft rows,
// the shadow window's values and the tick's draw keys, the scratch
// cleared. The tick then updates the region, and reads the pre-tick
// values from the inputs: the install path adopts the PRE-tick snapshots
// after the compaction capture rewrote them, and the Get match reads the
// pre-tick clerk_seq.
__device__ __forceinline__ void stage(const Params &p, const LeafRef *tab,
                                      int32_t *ws, int c, int lane) {
  const int32_t sv = lane < p.cap ? read_row<int32_t>(p, kShadowVal, c,
                                                      p.cap)[lane] : 0;
  int32_t rr[kRaftRows] = {};
  if (lane < p.n) {
    rr[kRTerm] = read_row<int32_t>(p, kTerm, c, p.n)[lane];
    rr[kRRole] = read_row<int32_t>(p, kRole, c, p.n)[lane];
    rr[kRAlive] = read_row<uint8_t>(p, kAlive, c, p.n)[lane] != 0;
    rr[kRBase] = read_row<int32_t>(p, kBase, c, p.n)[lane];
    rr[kRCommit] = read_row<int32_t>(p, kCommit, c, p.n)[lane];
  }
  // the tick's keys (kDraws): fold_in(key, t), then the sites, a key a
  // lane while the loads are in flight
  if (lane < kDrawKeys) {
    const Ro<uint32_t> key = read_row<uint32_t>(p, kKeys, c, 4);
    uint32_t k0 = key[0], k1 = key[2];  // the int64 words' low halves
    fold_in(k0, k1, static_cast<uint32_t>(
        read_row<int32_t>(p, kTick, c, 1)[0]));
    const uint32_t site = lane < 4 ? kSiteStart
                          : lane == 4 ? kSiteKind : kSiteHint;
    fold_in(k0, k1, site);
    uint32_t d0 = k0, d1 = k1;
    if (lane < 4) split_key(k0, k1, 4, lane, p.partitionable, d0, d1);
    if (lane == 5) split_key(k0, k1, 2, 0, p.partitionable, d0, d1);
    ws[p.draws + 2 * lane] = static_cast<int32_t>(d0);
    ws[p.draws + 2 * lane + 1] = static_cast<int32_t>(d1);
  }
  if (lane < p.cap) ws[p.sh_val + lane] = sv;
  if (lane < p.n)
    for (int r = 0; r < kRaftRows; ++r) ws[p.raft + r * p.n + lane] = rr[r];
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
  const Ro<int32_t> shadow_val = read_row<int32_t>(p, kShadowVal, c, p.cap);
  for (int i = lane + kLanes; i < p.cap; i += kLanes)
    ws[p.sh_val + i] = shadow_val[i];
  for (int cl = lane; cl < p.nc; cl += kLanes) ws[p.flag + cl] = 0;
  if (lane == 0) ws[p.viol] = 0;
}

// Phase kScan: the committed truth per key (a shadow lane a thread, each
// deduped against the whole window), whether each clerk's op is in the
// live shadow (a (clerk, lane) pair a thread), and the apply machines'
// crash reset, compaction capture and install-snapshot (a table cell a
// thread)
__device__ __forceinline__ void scan(const Params &p, int32_t *ws, int c,
                                     int lane) {
  const int n = p.n, cap = p.cap, nc = p.nc, nk = p.nk;
  const int32_t *val = ws + p.sh_val;
  const int32_t sh_base = read_row<int32_t>(p, kShadowBase, c, 1)[0];
  const int32_t sh_len = read_row<int32_t>(p, kShadowLen, c, 1)[0];
  const int32_t pre_len = read_row<int32_t>(p, kPreShadowLen, c, 1)[0];
  const Ro<int32_t> tmax0 = in_row<int32_t>(p, kTruthMaxSeq, c);
  int32_t *truth = work<int32_t>(p, ws, kTruthCount);
  int32_t *tmax = work<int32_t>(p, ws, kTruthMaxSeq);
  for (int q = lane; q < cap; q += kLanes) {
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

  const Ro<int32_t> clerk_seq0 = in_row<int32_t>(p, kClerkSeq, c);
  const Ro<int32_t> clerk_key0 = in_row<int32_t>(p, kClerkKey, c);
  const Ro<int32_t> clerk_kind0 = in_row<int32_t>(p, kClerkKind, c);
  for (int x = lane; x < nc * cap; x += kLanes) {
    const int cl = x / cap, i = x % cap;
    const int32_t want = pack(cl, clerk_seq0[cl], clerk_key0[cl],
                              clerk_kind0[cl], nk);
    if (val[i] == want && shadow_abs(sh_base, i, cap) <= sh_len)
      shared_or(ws + p.flag + cl, 1);
  }

  const int32_t *alive = raft_row(p, ws, kRAlive);
  const Ro<uint8_t> pre_alive = read_row<uint8_t>(p, kPreAlive, c, n);
  const int32_t *base = raft_row(p, ws, kRBase);
  const Ro<int32_t> pre_base = read_row<int32_t>(p, kPreBase, c, n);
  const Ro<int32_t> snap_src = read_row<int32_t>(p, kSnapSrc, c, n);
  for (int i = lane; i < n; i += kLanes) {
    const bool fresh = !pre_alive[i] || !alive[i];
    const bool inst = snap_src[i] >= 0;
    if (fresh || inst) work<int32_t>(p, ws, kApplied)[i] = base[i];
  }
  // the live tables (nc columns: last_seq, apply_count; nk: key_hash,
  // key_count) and their snapshots, a table after another
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int w = g < 2 ? nc : nk;
    const int live = kLastSeq + g, snap = kSnapLastSeq + g;
    const Ro<int32_t> sn0 = in_row<int32_t>(p, snap, c);
    int32_t *lv = work<int32_t>(p, ws, live);
    int32_t *sn = work<int32_t>(p, ws, snap);
    for (int x = lane; x < n * w; x += kLanes) {
      const int i = x / w, e = x % w;
      const bool fresh = !pre_alive[i] || !alive[i];
      const bool inst = snap_src[i] >= 0;
      const bool comp = base[i] != pre_base[i] && !inst && alive[i];
      if (fresh) lv[x] = sn0[x];
      if (comp) sn[x] = lv[x];
      if (inst) {
        // the sender's PRE-tick snapshot (0 for a sender out of range)
        const int src = snap_src[i];
        lv[x] = sn[x] = src < n ? sn0[src * w + e] : 0;
      }
    }
  }
}

// Phase kApply: apply_max rounds of the apply loop, a node a thread (a
// node's rounds are sequential, the nodes independent), then the node's
// exactly-once check. The rounds' Get observations go to the scratch
// (first, first_obs) for kObserve.
__device__ __forceinline__ void apply(const Params &p, int32_t *ws, int c,
                                      int lane) {
  const int n = p.n, cap = p.cap, nc = p.nc, nk = p.nk;
  if (lane >= n) return;
  const int i = lane;
  const Ro<int32_t> ki = read_row<int32_t>(p, kKnobI, c, kNI);
  const bool stale_read = ki[kBugStaleRead] != 0;
  const bool uncommitted = ki[kBugApplyUncommitted] != 0;
  const bool skip_dedup = ki[kBugSkipDedup] != 0;
  const bool alive = raft_row(p, ws, kRAlive)[i] != 0;
  const int32_t limit = uncommitted ? in_row<int32_t>(p, kLogLen, c)[i]
                                    : raft_row(p, ws, kRCommit)[i];
  const Ro<int32_t> log_val0 = in_row<int32_t>(p, kLogVal, c) + i * cap;
  const Ro<int32_t> clerk_seq0 = in_row<int32_t>(p, kClerkSeq, c);
  int32_t *last_seq = work<int32_t>(p, ws, kLastSeq) + i * nc;
  int32_t *apply_count = work<int32_t>(p, ws, kApplyCount) + i * nc;
  int32_t *key_hash = work<int32_t>(p, ws, kKeyHash) + i * nk;
  int32_t *key_count = work<int32_t>(p, ws, kKeyCount) + i * nk;
  int32_t *first = ws + p.first + i * nc;
  int32_t *first_obs = ws + p.first_obs + i * nc;
  int32_t &applied = work<int32_t>(p, ws, kApplied)[i];
  int32_t viol = 0;
  for (int cl = 0; cl < nc; ++cl) first[cl] = p.apply_max;
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
        key_count[o.key] >= 0 && first[o.client] == p.apply_max) {
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
    ahead[r] = r < p.apply_max ? log_val0[slot(a0 + r)] : 0;
#pragma unroll
  for (int round = 0; round < kAhead; ++round) {
    if (round >= p.apply_max || !(alive && applied < limit)) break;
    round_of(round, ahead[round]);
  }
  for (int round = kAhead; round < p.apply_max && alive && applied < limit;
       ++round)
    round_of(round, log_val0[slot(static_cast<uint32_t>(applied))]);
  // exactly-once: ops applied per client == highest seq applied
  if (!stale_read && alive)
    for (int cl = 0; cl < nc; ++cl)
      if (apply_count[cl] != last_seq[cl]) viol |= kViolExactlyOnce;
  if (viol) shared_or(ws + p.viol, viol);
}

// Phase kObserve: each clerk's Get observation (the largest a node made
// in the first round any made one), a clerk a thread; the agreement check
// (equal cursors => identical applied state), a node pair a thread
__device__ __forceinline__ void observe(const Params &p, int32_t *ws, int c,
                                        int lane) {
  const int n = p.n, nc = p.nc, nk = p.nk;
  int32_t *get_obs = work<int32_t>(p, ws, kClerkGetObs);
  for (int cl = lane; cl < nc; cl += kLanes) {
    if (get_obs[cl] >= 0) continue;
    int round = p.apply_max;
    int32_t obs = -1;
    for (int i = 0; i < n; ++i) {
      const int r = ws[p.first + i * nc + cl];
      const int32_t o = ws[p.first_obs + i * nc + cl];
      if (r < round || (r == round && r < p.apply_max && o > obs)) {
        round = r;
        obs = o;
      }
    }
    if (round < p.apply_max) get_obs[cl] = obs;
  }
  const int32_t *alive = raft_row(p, ws, kRAlive);
  const int32_t *applied = work<int32_t>(p, ws, kApplied);
  const int32_t *key_hash = work<int32_t>(p, ws, kKeyHash);
  const int32_t *key_count = work<int32_t>(p, ws, kKeyCount);
  for (int x = lane; x < n * n; x += kLanes) {
    const int i = x / n, j = x % n;
    if (!(i < j && applied[i] == applied[j] && applied[i] > 0 && alive[i] &&
          alive[j]))
      continue;
    for (int k = 0; k < nk; ++k)
      if (key_hash[i * nk + k] != key_hash[j * nk + k] ||
          key_count[i * nk + k] != key_count[j * nk + k]) {
        shared_or(ws + p.viol, kViolDiverge);
        break;
      }
  }
}

// Phase kClerks, a clerk a thread: the ack, the stale-read oracle, the
// open-loop arrival, a fresh op or a retry, the hint routing, the bug
// mode's local serve, and the reply to the submit (the hint and the await
// countdown; the reply reads nothing the submits write)
__device__ __forceinline__ void clerks(const Params &p, int32_t *ws, int c,
                                       int lane) {
  const int n = p.n, nc = p.nc, nk = p.nk, part = p.partitionable;
  if (lane >= nc) return;
  const int cl = lane;
  const int32_t t = read_row<int32_t>(p, kTick, c, 1)[0];
  const int32_t *term = raft_row(p, ws, kRTerm);
  const int32_t *role = raft_row(p, ws, kRRole);
  const int32_t *alive = raft_row(p, ws, kRAlive);
  const Ro<float> kf = read_row<float>(p, kKnobF, c, kNF);
  const Ro<int32_t> ki = read_row<int32_t>(p, kKnobI, c, kNI);
  const bool stale_read = ki[kBugStaleRead] != 0;
  const int32_t *truth = work<int32_t>(p, ws, kTruthCount);
  const int32_t *k_count = work<int32_t>(p, ws, kKeyCount);
  int32_t *get_obs = work<int32_t>(p, ws, kClerkGetObs);
  int32_t viol = 0;

  const int32_t ck = in_row<int32_t>(p, kClerkKey, c)[cl];
  const int32_t cs = in_row<int32_t>(p, kClerkSeq, c)[cl];
  const int32_t kind0 = in_row<int32_t>(p, kClerkKind, c)[cl];
  const bool out0 = in_row<uint8_t>(p, kClerkOut, c)[cl] != 0;
  int32_t obs = get_obs[cl];
  const int32_t truth_at = ck >= 0 && ck < nk ? truth[ck] : 0;
  const bool in_shadow = ws[p.flag + cl] != 0;
  const bool is_get = kind0 == kGet;
  int32_t sub = 0, app = 0, cmt = 0, apl = 0;
  if (kMetrics) {
    sub = in_row<int32_t>(p, kClerkSub, c)[cl];
    app = in_row<int32_t>(p, kClerkApp, c)[cl];
    cmt = in_row<int32_t>(p, kClerkCmt, c)[cl];
    apl = in_row<int32_t>(p, kClerkApl, c)[cl];
    if (out0 && in_shadow && cmt == 0) cmt = t;
    if (out0 && obs >= 0 && apl == 0) apl = t;
  }
  const bool newly = out0 && in_shadow && (!is_get || obs >= 0);
  const bool done_get = newly && is_get;
  if (done_get && (obs < in_row<int32_t>(p, kClerkGetLo, c)[cl] ||
                   obs > truth_at))
    viol |= kViolStale;
  int32_t acked = newly ? cs : in_row<int32_t>(p, kClerkAcked, c)[cl];
  bool cout = out0 && !newly;
  int32_t gets = wrap_add(in_row<int32_t>(p, kGetsDone, c)[cl], done_get);
  int32_t last_obs = done_get ? obs : in_row<int32_t>(p, kClerkLastObs, c)[cl];
  if (kMetrics) {
    const int32_t e2e = wrap_sub(t, sub);
    // clerk_phase_matrix: the stamps clamped monotone
    const int32_t app_e = app > sub ? app : sub;
    const int32_t cmt_e = cmt > app_e ? cmt : app_e;
    const int32_t b3 = is_get ? (apl > cmt_e ? apl : cmt_e) : cmt_e;
    const int32_t ph[kPhases] = {wrap_sub(app_e, sub), wrap_sub(cmt_e, app_e),
                                 wrap_sub(b3, cmt_e), wrap_sub(t, b3)};
    if (newly) fold_op(p, ws, e2e, ph, ck, cl);
    worst_put(ws + p.worst + cl * kWorstWords, newly, e2e, ph, ck, sub);
  }

  // the draws, from the tick's keys (kStage)
  uint32_t kk[kDrawKeys][2];
  for (int j = 0; j < kDrawKeys; ++j) {
    kk[j][0] = static_cast<uint32_t>(ws[p.draws + 2 * j]);
    kk[j][1] = static_cast<uint32_t>(ws[p.draws + 2 * j + 1]);
  }

  // open-loop arrivals (from the start word's free low 9 bits)
  const uint32_t w_start = bits_word(kk[0][0], kk[0][1], cl, nc, part);
  const float u_start = madraft::as_float((w_start >> 9) | 0x3F800000u) - 1.0f;
  const int32_t qcap = ki[kQueueCap];
  const bool openloop = qcap > 0;
  const bool arrive = openloop &&
      fmul(static_cast<float>(w_start & 0x1FFu), 1.0f / 512.0f) < kf[kOpenRate];
  const int32_t arr0 = in_row<int32_t>(p, kOpenArr, c)[cl];
  const int32_t srv0 = in_row<int32_t>(p, kOpenSrv, c)[cl];
  const bool drop = arrive && wrap_sub(arr0, srv0) >= qcap;
  const bool enq = arrive && !drop;
  const int32_t arr = wrap_add(arr0, enq);
  int32_t *stamp = kMetrics ? work<int32_t>(p, ws, kOpenStamp) + cl * kQueueSlots
                            : nullptr;
  if (kMetrics && enq) stamp[floor_mod(arr0, kQueueSlots)] = t;
  const bool start = !cout &&
      (openloop ? arr > srv0 : u_start < kf[kPOp]) && cs < kSeqLim - 1;
  const int32_t seq = start ? wrap_add(cs, 1) : cs;
  const int32_t draw = randint_elem(kk[1][0], kk[1][1], cl, nc, 0,
                                             nk, part);
  const int32_t ckey = start ? zipf_map(draw, nk, kf[kZipfA]) : ck;
  const float u_kind = madraft::uniform(
      bits_word(kk[4][0], kk[4][1], cl, nc, part));
  const int32_t kind = !start ? kind0
      : u_kind < kf[kPGet] ? kGet
      : u_kind < fadd(kf[kPGet], kf[kPPut]) ? kPut : kAppend;
  const int32_t truth_new = ckey >= 0 && ckey < nk ? truth[ckey] : 0;
  const int32_t get_lo = start ? truth_new : in_row<int32_t>(p, kClerkGetLo, c)[cl];
  if (start) obs = -1;
  if (kMetrics && start) {
    sub = openloop ? stamp[floor_mod(srv0, kQueueSlots)] : t;
    app = cmt = apl = 0;
  }
  cout = cout || start;
  const float u_retry = madraft::uniform(
      bits_word(kk[2][0], kk[2][1], cl, nc, part));
  const int32_t wait0 = in_row<int32_t>(p, kClerkWait, c)[cl];
  bool rt = cout && (start || (u_retry < kf[kPRetry] && wait0 <= 0));
  if (kMetrics) {
    int32_t &rr = work<int32_t>(p, ws, kClientRetries)[cl];
    rr = wrap_add(rr, rt);
  }
  int32_t tgt = randint_elem(kk[3][0], kk[3][1], cl, nc, 0, n, part);
  const int32_t leader0 = in_row<int32_t>(p, kClerkLeader, c)[cl];
  const float u_follow = madraft::uniform(
      bits_word(kk[5][0], kk[5][1], cl, nc, part));
  if (u_follow < kf[kPFollow] && leader0 >= 0)
    tgt = leader0 > n - 1 ? n - 1 : leader0;

  // the bug mode: the contacted node serves a Get from its own state
  const int32_t local_cnt =
      ckey >= 0 && ckey < nk ? k_count[tgt * nk + ckey] : 0;
  const bool served = stale_read && rt && !start && kind == kGet &&
                      alive[tgt];
  if (served && (local_cnt < get_lo || local_cnt > truth_new))
    viol |= kViolStale;
  if (served) {
    acked = seq;
    cout = false;
    gets = wrap_add(gets, 1);
    rt = false;
    last_obs = local_cnt;
  }
  if (kMetrics) {
    const int32_t e2e_s = wrap_sub(t, sub);
    const int32_t ph[kPhases] = {0, 0, e2e_s, 0};
    if (served) fold_op(p, ws, e2e_s, ph, ckey, cl);
    worst_put(ws + p.worst + (nc + cl) * kWorstWords, served, e2e_s, ph,
              ckey, sub);
    work<int32_t>(p, ws, kClerkSub)[cl] = sub;
    work<int32_t>(p, ws, kClerkApp)[cl] = app;
    work<int32_t>(p, ws, kClerkCmt)[cl] = cmt;
    work<int32_t>(p, ws, kClerkApl)[cl] = apl;
  }
  work<int32_t>(p, ws, kClerkSeq)[cl] = seq;
  work<uint8_t>(p, ws, kClerkOut)[cl] = cout;
  work<int32_t>(p, ws, kClerkKey)[cl] = ckey;
  work<int32_t>(p, ws, kClerkKind)[cl] = kind;
  work<int32_t>(p, ws, kClerkAcked)[cl] = acked;
  work<int32_t>(p, ws, kOpenArr)[cl] = arr;
  work<int32_t>(p, ws, kOpenSrv)[cl] = wrap_add(srv0, openloop && start);
  work<int32_t>(p, ws, kOpenDrop)[cl] =
      wrap_add(in_row<int32_t>(p, kOpenDrop, c)[cl], drop);
  work<int32_t>(p, ws, kClerkGetLo)[cl] = get_lo;
  get_obs[cl] = obs;
  work<int32_t>(p, ws, kClerkLastObs)[cl] = last_obs;
  work<int32_t>(p, ws, kGetsDone)[cl] = gets;
  ws[p.target + cl] = tgt;
  ws[p.retry + cl] = rt;
  if (viol) shared_or(ws + p.viol, viol);

  // the submit's reply: the leader hint (argmax picks the first node of
  // the highest live leader term, 0 when there is none) and the countdown
  int32_t lead_term = -1;
  bool any_lead = false;
  for (int i = 0; i < n; ++i)
    if (alive[i] && role[i] == kLeader) {
      any_lead = true;
      if (term[i] > lead_term) lead_term = term[i];
    }
  int lead_node = 0;
  for (int i = n - 1; i >= 0; --i)
    if (alive[i] && role[i] == kLeader && term[i] == lead_term) lead_node = i;
  const bool is_lead = alive[tgt] && role[tgt] == kLeader;
  int32_t hint;
  if (ki[kBugStaleHint] != 0) {
    int ring = (tgt + 1) % n;
    if (any_lead && ring == lead_node) ring = (ring + 1) % n;
    hint = ring;
  } else {
    hint = any_lead && term[tgt] == lead_term ? lead_node : -1;
  }
  work<int32_t>(p, ws, kClerkLeader)[cl] =
      !rt ? leader0 : is_lead ? tgt : alive[tgt] ? hint : -1;
  work<int32_t>(p, ws, kClerkWait)[cl] =
      rt && is_lead ? ki[kRetryWait] : (wait0 - 1 > 0 ? wait0 - 1 : 0);
}

// Phase kSubmit, one thread: the worst-op register, the violation bits,
// the submits appended at self-believed leaders one client after another
// (client c's append reads the log_len client c - 1 moved), and the raft
// leaves they move
__device__ __forceinline__ void submit(const Params &p, int32_t *ws, int c) {
  const int n = p.n, cap = p.cap, nc = p.nc;
  const int32_t t = read_row<int32_t>(p, kTick, c, 1)[0];
  const int32_t *term = raft_row(p, ws, kRTerm);
  const int32_t *role = raft_row(p, ws, kRRole);
  const int32_t *alive = raft_row(p, ws, kRAlive);
  const int32_t *base = raft_row(p, ws, kRBase);
  const int32_t *commit = raft_row(p, ws, kRCommit);
  const int32_t flow_cap = read_row<int32_t>(p, kKnobI, c, kNI)[kFlowCap];
  if (kMetrics) {
    worst_apply(p, ws, ws + p.worst);
    worst_apply(p, ws, ws + p.worst + nc * kWorstWords);
  }
  const int32_t viol = ws[p.viol];
  work<int32_t>(p, ws, kViolations)[0] |= viol;
  int32_t &fvt = work<int32_t>(p, ws, kFirstViolation)[0];
  if (fvt < 0 && viol != 0) fvt = t;

  int32_t *log_term = out_row<int32_t>(p, kLogTerm, c);
  int32_t *log_val = out_row<int32_t>(p, kLogVal, c);
  int32_t *log_len = work<int32_t>(p, ws, kLogLen);
  for (int cl = 0; cl < nc; ++cl) {
    const int i = ws[p.target + cl];
    const bool ok = ws[p.retry + cl] && alive[i] && role[i] == kLeader &&
                    wrap_sub(log_len[i], base[i]) < cap &&
                    wrap_sub(log_len[i], commit[i]) < flow_cap;
    if (!ok) continue;
    const int pos = static_cast<int>(static_cast<uint32_t>(log_len[i]) &
                                     static_cast<uint32_t>(cap - 1));
    log_term[i * cap + pos] = term[i];
    log_val[i * cap + pos] = pack(
        cl, work<int32_t>(p, ws, kClerkSeq)[cl],
        work<int32_t>(p, ws, kClerkKey)[cl],
        work<int32_t>(p, ws, kClerkKind)[cl], p.nk);
    log_len[i] = wrap_add(log_len[i], 1);
    if (kMetrics && work<uint8_t>(p, ws, kClerkOut)[cl]) {
      int32_t &app = work<int32_t>(p, ws, kClerkApp)[cl];
      if (app == 0) app = t;
    }
  }
  const Ro<int32_t> log_len0 = in_row<int32_t>(p, kLogLen, c);
  int32_t *durable = work<int32_t>(p, ws, kDurableLen);
  int32_t *floor_ = work<int32_t>(p, ws, kCompactFloor);
  const int32_t *applied = work<int32_t>(p, ws, kApplied);
  for (int i = 0; i < n; ++i) {
    if (log_len[i] > log_len0[i]) durable[i] = log_len[i];
    floor_[i] = applied[i];
  }
}

// Phase kWriteBack: the region's rows to the leaves' outputs, kGroup
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

// Lane `lane` of cluster c's warp in phase `phase` (kSubmit runs on lane 0
// alone); tab is the leaf table (p.leaf, or its copy in shared memory), ws
// the warp's region of Params::words words
__device__ __forceinline__ void run_phase(const Params &p,
                                          const LeafRef *tab, int32_t *ws,
                                          int c, int lane, int phase) {
  switch (phase) {
    case kStage: stage(p, tab, ws, c, lane); break;
    case kScan: scan(p, ws, c, lane); break;
    case kApply: apply(p, ws, c, lane); break;
    case kObserve: observe(p, ws, c, lane); break;
    case kClerks: clerks(p, ws, c, lane); break;
    case kSubmit: if (lane == 0) submit(p, ws, c); break;
    default: write_back(tab, ws, c, lane); break;
  }
}

}  // namespace k9
