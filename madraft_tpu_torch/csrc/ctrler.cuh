// The shard controller's service tick's device code (the JAX reference's
// _ctrler_service_tick), once, for two kernels: K10 runs it on the
// kThreads threads of a block, one tick a launch (ctrler.cu holds that
// kernel, its launch and the note on what it replaces, its bound and
// design), and K6-ctrler runs it on K6's 16-lane tile after each raft tick
// of a chunk (tick.cuh, -DMADRAFT_K6_CTRLER). Built by nvcc through
// ctrler.cu and tick.cu, and by g++ through tests/ctrler_host_emu.cpp and
// tests/tick_host_emu.cpp.
//
// The tick runs as phases (restore, apply, clerks, submit; K10 stages its
// region before them and writes it back after), a barrier after each.
// Each phase is a function of the lane and an environment (K10Env here,
// tick.cuh CtrlerEnv): the lane count and the lanes the walker and the
// first clerk take, the cluster's region (its rows of the service leaves
// and the tick's scratch, Layout), where each of the other rows lives, the
// raft leaves the tick reads and writes, and the pre-tick values. K10
// stages its region from the inputs each tick and writes a new state, so
// its pre-tick values are the inputs; K6-ctrler keeps the region for a
// whole chunk and updates it in place, so it copies the snapshot tables an
// install adopts (the sender's PRE-tick snapshot, which its own compaction
// may rewrite first) on a tick with an install. Within a phase the lanes
// share nothing but commutative updates of the region (atomic add, or): so
// K10's host build runs a phase's threads one after another, and gets the
// card's result.
//
// The arithmetic is the plain version's (tpusim/ctrler.py
// _ctrler_service_tick), written per cluster: int32 values that may wrap
// are computed in uint32 (signed overflow is undefined in C++), the ops'
// unpacking uses floor division and modulo, as Python's // and %, and the
// float32 sums and products of the op-kind split go through fadd / fsub /
// fmul (no contraction into an FMA).

#pragma once

#include <cstdint>

#include "stage.cuh"
#include "threefry.cuh"

namespace k10 {

#ifdef MADRAFT_K10_METRICS
constexpr bool kMetrics = true;
#else
constexpr bool kMetrics = false;
#endif

// K10's block: two warps (four took the same time and spilled at the 64
// registers that eight blocks of four warps leave a thread)
constexpr int kThreads = 64;
constexpr int kWalker = kThreads - 1;  // the truth walker's thread
constexpr int kClerk0 = 32;      // the first clerk's thread in kClerks
static_assert(kThreads >= 64 && kThreads % 32 == 0, "two warps or more");
constexpr int kMaxNodes = 16;    // a node a lane in apply
constexpr int kMaxCap = 256;
constexpr int kMaxClients = 32;  // a clerk a thread in K10's kClerks
constexpr int kShards = 10;      // ctrler.N_SHARDS
constexpr int kMaxGids = kShards;
constexpr int kMaxConfigs = 256;
constexpr int kPhases = 4;       // config.LATENCY_PHASES
constexpr int kSeqLim = 1 << 10;
constexpr int32_t kBig = 1 << 30;
constexpr int32_t kNoop = 1 << 30;  // config.NOOP_CMD
constexpr int32_t kLeader = 2;
constexpr int kJoin = 0, kLeave = 1, kMove = 2, kQuery = 3;
constexpr int32_t kViolDiverge = 2048, kViolBalance = 4096,
                  kViolMinimal = 8192, kViolQuery = 16384;
constexpr uint32_t kSiteStart = 24, kSiteKind = 27;
constexpr uint32_t kHashW = 1000003u;

// The leaves the service tick writes: the service leaves in CtrlerState
// order, then the raft leaves it writes (kernels/ctrler.py RAFT_WRITES)
enum Leaf {
  kClerkSeq, kClerkOut, kClerkArg, kClerkKind, kClerkAcked, kClerkQObs,
  kQueriesDone, kClerkSub, kClerkApp, kClerkCmt, kClerkApl, kApplied,
  kLastSeq, kMember, kOwner, kCfgNum, kHist, kSnapLastSeq, kSnapMember,
  kSnapOwner, kSnapCfgNum, kSnapHist, kWFrontier, kWLastSeq, kWMember,
  kWOwner, kWCfgNum, kWHist, kWQSeq, kWQObs, kWStalled,
  kLogTerm, kLogVal, kLogLen, kDurableLen, kViolations, kFirstViolation,
  kCompactFloor, kLatHist, kPhaseHist, kPhaseTicks, kLatTicks, kWorstLat,
  kWorstPhases, kWorstKey, kWorstClient, kWorstSub,
  kLeaves
};
// The service leaves are the first kServiceLeaves
constexpr int kServiceLeaves = kLogTerm;

// K6-ctrler keeps the nodes' two [n, n_configs] history tables in device
// memory (the new state's rows: up to 16 KB each, which the tile's shared
// block could not hold beside K6's at the largest shapes), every other
// service leaf in its region
__host__ __device__ constexpr bool in_device(int l) {
  return l == kHist || l == kSnapHist;
}

// K10's read-only inputs: the stepped raft state's leaves, the pre-tick
// views, the keys and the knob table (kernels/ctrler.py RAFT_READS)
enum Read {
  kTick, kTerm, kRole, kAlive, kBase, kCommit, kSnapSrc, kShadowVal,
  kShadowBase, kShadowLen, kPreAlive, kPreBase, kKeys, kKnobF, kKnobI,
  kReads
};

// The knob table's columns (kernels/ctrler.py KNOB_F32 / KNOB_I32)
enum KnobF { kPOp, kPQuery, kPMove, kPRetry, kNF };
enum KnobI { kBugRotate, kBugGreedy, kBugReshuffle, kFlowCap, kNI };

// K10's descriptor (kernels/ctrler.py _launch): this header, the kReads
// pointers, then 4 words a leaf (in, out, count a cluster, bytes an
// element). K6-ctrler's (kernels/ctrler.py Side) has the header's kNc ..
// kMetricsOn, the knob table's two pointers, its device rows (Side), then
// the same 4 words a leaf
enum Desc {
  kB, kN, kCap, kNc, kNg, kNcfg, kJoinMax, kArgLim, kApplyMax, kWalkMax,
  kHb, kNph, kPartitionable, kMetricsOn,
  kHeader
};

// K10's phases of a tick, in order (run_phase)
enum Phase { kStage, kRestore, kApply, kClerks, kSubmit, kWriteBack,
             kTickPhases };

// A worst-op candidate's words in the region: mask, lat, key, sub, then
// the kPhases phases
constexpr int kWorstWords = 4 + kPhases;

// The tick's draw keys, from fold_in(cluster key, t): the seven splits of
// site 24 (the start, the arg draw, the retry, the target, the Query num,
// the gid set, the gid count) and site 27 (the op's kind)
constexpr int kDrawKeys = 8;

// K10's stepped raft rows by node, the install sources and the pre-tick
// views, staged in the region (alive as 0 / 1)
enum RaftRow { kRTerm, kRRole, kRAlive, kRBase, kRCommit, kRSnapSrc,
               kRPreAlive, kRPreBase, kRaftRows };

// A leaf: its input and output, its count of elements a cluster, its
// bytes an element, and its row's offset in words in the region (-1 for a
// leaf the region does not hold)
struct LeafRef {
  const void *in;
  void *out;
  int count, bytes, off;
};

// The run's shape
struct Dims {
  int n, cap, nc, ng, ncfg, join_max, arg_lim, apply_max, walk_max, hb,
      nph, part;
};

// The region's scratch after the leaves' rows, in int32 words from its
// start (a size 0 where the kernel keeps none)
struct Layout {
  int sh_val;     // K10: [cap] the shadow window's values
  int viol;       // the tick's violation bits
  int flag;       // [nc] the clerk's op is in the live shadow
  int first;      // [n, nc] the apply round a node answered the clerk's
                  // Query (apply_max when none)
  int first_obs;  // [n, nc] its answer then
  int target;     // [nc] the node the clerk contacts
  int retry;      // [nc] the clerk submits
  int worst;      // [nc, kWorstWords] the acks' worst-op candidates
  int draws;      // [kDrawKeys, 2] the tick's draw keys
  int raft;       // K10: [kRaftRows, n] the stepped raft rows (RaftRow)
  int pre_base;   // K6-ctrler: [n] the pre-tick base
  int snap_pre;   // K6-ctrler: the pre-tick snapshot tables held in the
                  // region (snap_last_seq .. snap_cfg_num, as laid out)
  int knobs;      // K6-ctrler: [kNF + kNI] the cluster's knob rows
  int words;      // the region's size
};

// The scratch after the leaves' rows (words of them) for d; k6: K6-ctrler's
inline void lay_scratch(Layout &L, const Dims &d, int words, int snap_words,
                        bool k6) {
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
  L.worst = take(d.nc * kWorstWords);
  L.draws = take(2 * kDrawKeys);
  L.raft = take(k6 ? 0 : kRaftRows * d.n);
  L.pre_base = take(k6 ? d.n : 0);
  L.snap_pre = take(k6 ? snap_words : 0);
  L.knobs = take(k6 ? int(kNF) + int(kNI) : 0);
  L.words = words;
}

// Dims from the descriptor header's words nc .. metrics_on (Desc kNc ..
// kMetricsOn) and the raft shape; false when they are out of the
// kernels' range or the metrics flag is not met (the build's)
inline bool set_dims(Dims &d, const int64_t *h, int n, int cap, int part,
                     bool met) {
  d.n = n;
  d.cap = cap;
  d.nc = static_cast<int>(h[0]);
  d.ng = static_cast<int>(h[kNg - kNc]);
  d.ncfg = static_cast<int>(h[kNcfg - kNc]);
  d.join_max = static_cast<int>(h[kJoinMax - kNc]);
  d.arg_lim = static_cast<int>(h[kArgLim - kNc]);
  d.apply_max = static_cast<int>(h[kApplyMax - kNc]);
  d.walk_max = static_cast<int>(h[kWalkMax - kNc]);
  d.hb = static_cast<int>(h[kHb - kNc]);
  d.nph = static_cast<int>(h[kNph - kNc]);
  d.part = part;
  if (n < 1 || n > kMaxNodes || cap < 1 || cap > kMaxCap ||
      (cap & (cap - 1)) || d.nc < 1 || d.nc > kMaxClients || d.ng < 2 ||
      d.ng > kMaxGids || d.ncfg < 1 || d.ncfg > kMaxConfigs ||
      d.join_max < 1 || d.join_max > d.ng || d.arg_lim < 1 ||
      d.apply_max < 0 || d.walk_max < 0 ||
      (h[kMetricsOn - kNc] != 0) != met)
    return false;
  return !met || (d.hb >= 1 && d.hb <= 31 && d.nph == kPhases);
}

template <typename T>
inline T *ptr_of(int64_t w) {
  return reinterpret_cast<T *>(static_cast<intptr_t>(w));
}

// The leaves of a descriptor's 4 words a leaf (in, out, count, bytes);
// false for a leaf's count or bytes out of range
inline bool set_leaves(LeafRef *leaf, const int64_t *g) {
  for (int l = 0; l < kLeaves; ++l, g += 4) {
    leaf[l] = {ptr_of<const void>(g[0]), ptr_of<void>(g[1]),
               static_cast<int>(g[2]), static_cast<int>(g[3]), -1};
    if (leaf[l].bytes != 1 && leaf[l].bytes != 4) return false;
    if (leaf[l].count < 0 || leaf[l].count > (1 << 16)) return false;
  }
  return true;
}

using Plan = stage::Plan<kLeaves>;

// The staging plan's copy in shared memory, before K10's region: the copy
// loops read a row's fields at a runtime index, which the kernel's
// parameters serve slowly
constexpr int kPlanBytes = (static_cast<int>(sizeof(Plan)) + 15) / 16 * 16;

// K10's parameters: the leaves (every leaf but the two log rows staged in
// the block's region at its off, a bulk row's off a multiple of 4; the log
// rows stay in device memory: the tick reads n * apply_max of their slots
// and appends at most nc), the staging plan, the reads, the shape and the
// region
struct Params {
  LeafRef leaf[kLeaves];
  Plan plan;       // the staged rows' copies (stage.cuh)
  const void *read[kReads];
  Dims d;
  Layout L;
  int b;
  int log_quads;  // the two log rows' 16-byte quads a cluster (0: copied
                  // by words)
};

inline bool set_params(Params &p, const int64_t *d, int n_desc) {
  constexpr int kWords = int(kHeader) + int(kReads) + 4 * int(kLeaves);
  if (n_desc != kWords) return false;
  p.b = static_cast<int>(d[kB]);
  if (p.b < 1 ||
      !set_dims(p.d, d + kNc, static_cast<int>(d[kN]),
                static_cast<int>(d[kCap]),
                static_cast<int>(d[kPartitionable]), kMetrics) ||
      !set_leaves(p.leaf, d + kHeader + kReads))
    return false;
  for (int r = 0; r < kReads; ++r)
    p.read[r] = ptr_of<const void>(d[kHeader + r]);
  int words = 0;
  stage::Row rows[kLeaves];
  int n_rows = 0;
  for (int l = 0; l < kLeaves; ++l) {
    LeafRef &x = p.leaf[l];
    if (l == kLogTerm || l == kLogVal) continue;
    if (stage::bulk(x.in, x.out, x.count, x.bytes)) words = (words + 3) & ~3;
    x.off = words;
    rows[n_rows++] = {x.in, x.out, x.count, x.bytes, 4 * x.off, 0};
    words += (x.count * x.bytes + 3) / 4;
  }
  if (!stage::plan(p.plan, rows, n_rows)) return false;
  // the log rows move in quads where both are 16-byte rows at 16-byte
  // aligned inputs and outputs
  const int n = p.d.n, cap = p.d.cap;
  bool quads = n * cap % 4 == 0;
  for (int l = kLogTerm; l <= kLogVal; ++l)
    quads = quads && (reinterpret_cast<uintptr_t>(p.leaf[l].in) |
                      reinterpret_cast<uintptr_t>(p.leaf[l].out)) % 16 == 0;
  p.log_quads = quads ? n * cap / 4 : 0;
  lay_scratch(p.L, p.d, words, 0, false);
  return true;
}

// K6-ctrler's share of K6's parameters (tick.cuh Params::ctrler): the
// service leaves in and out (a raft leaf's and a metric leaf's row has
// no in or out: K6 keeps those leaves), the knob table, the device rows,
// the shape and the region. The device rows: the two history tables'
// rows are the new state's (in_device: staged there from the input at
// the chunk's start); dev holds [B + 1, n * n_configs] words, cluster c's
// row the copy of its pre-tick snap_hist on a tick with an install, then
// the hist and snap_hist rows [2, n * n_configs] of a tile past the
// batch's end (row B its copy), which writes nothing of the state
struct Side {
  LeafRef leaf[kLeaves];
  const float *kf;  // [B, kNF]
  const int *ki;    // [B, kNI]
  int32_t *dev;
  Dims d;
  Layout L;
};

// Side from K6-ctrler's descriptor (kNc .. kMetricsOn, kf, ki, dev, then
// 4 words a leaf) at raft shape (n, cap); false where K6-ctrler does not
// take it. The region holds the service leaves but the history tables and
// the metric leaves (the clerks' sums and the worst-op register), then
// the scratch
inline bool set_side(Side &s, const int64_t *d, int n_desc, int n, int cap,
                     int part, bool met) {
  constexpr int kWords = int(kHeader) - int(kNc) + 3 + 4 * int(kLeaves);
  if (n_desc != kWords) return false;
  if (!set_dims(s.d, d, n, cap, part, met)) return false;
  s.kf = ptr_of<const float>(d[kHeader - kNc]);
  s.ki = ptr_of<const int>(d[kHeader - kNc + 1]);
  s.dev = ptr_of<int32_t>(d[kHeader - kNc + 2]);
  if (!set_leaves(s.leaf, d + kHeader - kNc + 3)) return false;
  int words = 0;
  for (int l = 0; l < kLeaves; ++l) {
    const bool held = (l < kServiceLeaves && !in_device(l)) || l >= kLatHist;
    s.leaf[l].off = held ? words : -1;
    if (held) words += (s.leaf[l].count * s.leaf[l].bytes + 3) / 4;
  }
  // the snapshot tables the region holds, in a row from snap_last_seq
  const int snap_words = s.leaf[kSnapCfgNum].off + s.leaf[kSnapCfgNum].count -
                         s.leaf[kSnapLastSeq].off;
  lay_scratch(s.L, s.d, words, snap_words, true);
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

__device__ __forceinline__ float fsub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

__device__ __forceinline__ float fmul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

// The lanes' commutative updates of a word of the cluster's region (on
// the host K10's threads run one after another; K6-ctrler's run as
// threads, and its host build defines MADRAFT_HOST_ATOMICS and the
// atomics' twins)
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

struct Op {
  int32_t client, seq, arg, kind;
};

// The packed op's fields (ctrler.py _unpack), client clipped to [0, nc)
__device__ __forceinline__ Op unpack(int32_t val, int arg_lim, int nc) {
  int32_t v = wrap_sub(val, 1);
  Op o;
  o.kind = floor_mod(v, 4);
  v = floor_div(v, 4);
  o.arg = floor_mod(v, arg_lim);
  const int32_t cs = floor_div(v, arg_lim);
  const int32_t client = floor_div(cs, kSeqLim);
  o.client = client < 0 ? 0 : (client > nc - 1 ? nc - 1 : client);
  o.seq = floor_mod(cs, kSeqLim);
  return o;
}

__device__ __forceinline__ int32_t pack(int32_t client, int32_t seq,
                                        int32_t arg, int32_t kind,
                                        int arg_lim) {
  uint32_t v = static_cast<uint32_t>(client) * kSeqLim +
               static_cast<uint32_t>(seq);
  v = v * static_cast<uint32_t>(arg_lim) + static_cast<uint32_t>(arg);
  return static_cast<int32_t>(v * 4u + static_cast<uint32_t>(kind) + 1u);
}

// The metrics plane's bucket of a latency: the edges 2^k (k = 1 .. hb-1)
// at or below it
__device__ __forceinline__ int bucket_of(int32_t lat, int hb) {
  int k = 0;
  for (int e = 1; e < hb; ++e) k += lat >= (1 << e);
  return k;
}

// The absolute log index of shadow lane i: the window's lanes hold
// base + 1 .. base + cap, lane i the one congruent to it mod cap
__device__ __forceinline__ int32_t shadow_abs(int32_t base, int i, int cap) {
  return base + static_cast<int32_t>(static_cast<uint32_t>(i - base) &
                                     static_cast<uint32_t>(cap - 1)) + 1;
}

// ------------------------------------------------------------- the draws
// The hashes behind the tick's draws, each compiled once and called (a
// block runs the kernel's code once, so its time goes with the code's
// size; the inlined threefry rounds would be most of it)
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
  fold_in(k0, k1, j < 7 ? kSiteStart : kSiteKind);
  uint32_t d0 = k0, d1 = k1;
  if (j < 7) split_key(k0, k1, 7, j, part, d0, d1);
  out[0] = static_cast<int32_t>(d0);
  out[1] = static_cast<int32_t>(d1);
}

// --------------------------------------------------- the config service
// The config hash (ctrler.py _hash_config): the Horner fold
// h = ((bits + 1) * W + (o_0 + 2)) * W + (o_1 + 2) ..., then h * 31 + num,
// mod 2^32 (the reference's multiply-sum is its expanded form)
__device__ __forceinline__ int32_t hash_config(uint32_t member,
                                               const int32_t owner[],
                                               int32_t num) {
  uint32_t h = member + 1u;
  for (int s = 0; s < kShards; ++s)
    h = h * kHashW + static_cast<uint32_t>(owner[s] + 2);
  return static_cast<int32_t>(h * 31u + static_cast<uint32_t>(num));
}

__device__ __forceinline__ int popcount(uint32_t x, int ng) {
  const uint32_t m = x & ((uint32_t{1} << ng) - 1u);
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

// ------------------------------------------------ the rebalance in registers
// The rebalance keeps its per-gid and per-shard arrays (at most ten small
// counts each) as nibble rows: ten 4-bit fields of a uint64_t, field i at
// bits 4i..4i+3, read and written at any index by shifts. So they stay in
// registers where the arrays indexed by a runtime owner lived in local
// memory.
__device__ __forceinline__ int nib(uint64_t x, int i) {
  return static_cast<int>((x >> (4 * i)) & 15u);
}

__device__ __forceinline__ uint64_t nib_at(int i, int v) {
  return static_cast<uint64_t>(v) << (4 * i);
}

// owner with the shards whose owner is not a member cut: a nibble row of
// the owner + 1 (0 for none)
__device__ __forceinline__ uint64_t valid_owners(int ng, uint32_t member,
                                                 const int32_t owner[]) {
  uint64_t own0 = 0;
  for (int s = 0; s < kShards; ++s) {
    const int32_t o = owner[s];
    if (o >= 0 && o < ng && ((member >> o) & 1u)) own0 |= nib_at(s, o + 1);
  }
  return own0;
}

// The retained loads and balanced targets (ctrler.py _retained_targets) as
// nibble rows by gid: the ceil targets to the r biggest retainers, ties by
// the lowest gid
__device__ __forceinline__ void retained_targets(int ng, uint32_t member,
                                                 uint64_t own0, int k,
                                                 uint64_t &retained,
                                                 uint64_t &target) {
  const int ksafe = k > 1 ? k : 1;
  const int q = kShards / ksafe, r = kShards % ksafe;
  retained = 0;
  for (int s = 0; s < kShards; ++s) {
    const int o = nib(own0, s);
    if (o) retained += nib_at(o - 1, 1);
  }
  target = 0;
  for (int g = 0; g < ng; ++g) {
    if (!((member >> g) & 1u)) continue;
    // the sort key (kShards - retained) * ng + gid, members only
    const int key = (kShards - nib(retained, g)) * ng + g;
    int rank = 0;
    for (int h = 0; h < ng; ++h)
      rank += ((member >> h) & 1u) && (kShards - nib(retained, h)) * ng + h < key;
    target |= nib_at(g, q + (rank < r));
  }
}

// What a membership's rebalance and its minimal move count share, from
// the owners before it: the valid owners, the members' count, the
// retained loads and the targets
struct Loads {
  uint64_t own0, retained, target;
  int k;
};

__device__ __forceinline__ Loads loads_of(int ng, uint32_t member,
                                          const int32_t owner[]) {
  Loads l;
  l.k = popcount(member, ng);
  l.own0 = valid_owners(ng, member, owner);
  retained_targets(ng, member, l.own0, l.k, l.retained, l.target);
  return l;
}

// The canonical rebalance (ctrler.py _rebalance) of one instance, with the
// two planted-bug variants: the new owners as a nibble row of owner + 1
// (0 for none, every shard's when no gid is a member)
__device__ __forceinline__ uint64_t rebalance(int ng, uint32_t member,
                                              const Loads &l, int tie_rot,
                                              bool greedy, bool reshuffle) {
  const int k = l.k;
  const int ksafe = k > 1 ? k : 1;
  const uint64_t own0 = l.own0, retained = l.retained, target = l.target;
  // members ordered by (gid + rot) mod ng; 15 above every member
  uint64_t akey = 0;
  for (int g = 0; g < ng; ++g)
    akey |= nib_at(g, (member >> g) & 1u ? (g + tie_rot) % ng : 15);
  uint64_t out = 0;
  if (reshuffle) {
    // shard s -> the (s mod k)-th member, round robin
    uint64_t rank = 0;
    for (int g = 0; g < ng; ++g)
      for (int h = 0; h < ng; ++h)
        rank += nib_at(g, ((member >> h) & 1u) && nib(akey, h) < nib(akey, g));
    for (int s = 0; s < kShards && k >= 1; ++s) {
      int dst = 0;
      for (int g = 0; g < ng; ++g)
        if (((member >> g) & 1u) && nib(rank, g) == s % ksafe) dst += g;
      out |= nib_at(s, dst + 1);
    }
    return out;
  }
  if (greedy) {
    // every orphan to the least-loaded member
    int gmin = kBig, dst0 = 0;
    for (int g = 0; g < ng; ++g) {
      if (!((member >> g) & 1u)) continue;
      const int key = nib(retained, g) * ng + nib(akey, g) % ng;
      if (key < gmin) {
        gmin = key;
        dst0 = g;
      }
    }
    for (int s = 0; s < kShards; ++s)
      out |= nib_at(s, nib(own0, s) == 0 && k >= 1 ? dst0 + 1 : nib(own0, s));
    return out;
  }
  // the keep set: shard s stays iff its ordinal among its group's shards
  // is below min(retained, target) of its group; the m-th moving shard
  // goes to the member at the m-th deficit slot
  uint64_t need = 0, start = 0, seen = 0;
  for (int g = 0; g < ng; ++g) {
    const int rg = nib(retained, g), tg = nib(target, g);
    need |= nib_at(g, tg - (rg < tg ? rg : tg));
  }
  for (int g = 0; g < ng; ++g) {
    int st = 0;
    for (int h = 0; h < ng; ++h)
      st += nib(akey, h) < nib(akey, g) ? nib(need, h) : 0;
    start |= nib_at(g, st);
  }
  int m = 0;
  for (int s = 0; s < kShards && k >= 1; ++s) {
    const int o = nib(own0, s) - 1;
    if (o >= 0) {
      const int ro = nib(retained, o), to = nib(target, o);
      const int n_seen = nib(seen, o);
      seen += nib_at(o, 1);
      if (n_seen < (ro < to ? ro : to)) {
        out |= nib_at(s, o + 1);
        continue;
      }
    }
    int dst = 0;
    for (int g = 0; g < ng; ++g)
      if (((member >> g) & 1u) && m >= nib(start, g) &&
          m < nib(start, g) + nib(need, g))
        dst += g;
    out |= nib_at(s, dst + 1);
    ++m;
  }
  return out;
}

// The closed-form minimal move count (ctrler.py _min_moves)
__device__ __forceinline__ int32_t min_moves(int ng, uint32_t member,
                                             const Loads &l) {
  int32_t moves = 0;
  for (int s = 0; s < kShards; ++s) moves += nib(l.own0, s) == 0;
  for (int g = 0; g < ng; ++g) {
    const int rg = nib(l.retained, g), tg = nib(l.target, g);
    if (((member >> g) & 1u) && rg > tg) moves += rg - tg;
  }
  return moves;
}

// A controller state machine instance: a node's rows or the walker's (in
// the region, or a history row in device memory: the environment's
// machine())
struct Machine {
  uint8_t *member;   // [ng] 0 / 1
  int32_t *owner;    // [kShards]
  int32_t *hist;     // [ncfg]
  int32_t *cfg_num;
  int32_t *last_seq;  // [nc]
};

// What applying one entry did (the fields ctrler.py _apply_entry returns
// beside the state)
struct Applied {
  bool fresh;
  int32_t client, seq, q_obs, viol;
};

// Apply one committed log entry (ctrler.py _apply_entry) to the instance
// m: the nodes and the walker share it, only tie_rot differs
__device__ __noinline__ Applied apply_entry(const Dims &d, Machine m,
                                            int tie_rot, bool greedy,
                                            bool reshuffle, int32_t val) {
  const int ng = d.ng;
  Applied a{false, 0, 0, -1, 0};
  if (val == kNoop) return a;
  const Op o = unpack(val, d.arg_lim, d.nc);
  a.client = o.client;
  a.seq = o.seq;
  const int32_t prev = m.last_seq[o.client];
  if (o.seq <= prev) return a;
  m.last_seq[o.client] = o.seq;
  a.fresh = true;
  const int32_t num = *m.cfg_num;
  if (o.kind == kQuery) {
    // the config at min(num, latest), masked to 31 bits
    const int32_t eff = o.arg < num ? o.arg : num;
    a.q_obs = m.hist[eff] & 0x7FFFFFFF;
    return a;
  }
  if (num >= d.ncfg - 1) return a;  // the history is full
  uint32_t member = 0;
  for (int g = 0; g < ng; ++g) member |= (m.member[g] ? 1u : 0u) << g;
  if (o.kind == kMove) {
    const int32_t gid = o.arg % ng;
    const int32_t shard = o.arg / ng < kShards - 1 ? o.arg / ng : kShards - 1;
    if (!((member >> gid) & 1u)) return a;
    m.owner[shard] = gid;
    *m.cfg_num = num + 1;
    m.hist[num + 1] = hash_config(member, m.owner, num + 1);
    return a;
  }
  const uint32_t mask = static_cast<uint32_t>(o.arg) & ((1u << ng) - 1u);
  if (o.kind == kJoin ? !(mask & ~member) : !(mask & member)) return a;
  const uint32_t next_member = o.kind == kJoin ? member | mask : member & ~mask;
  const Loads l = loads_of(ng, next_member, m.owner);
  const uint64_t next = rebalance(ng, next_member, l, tie_rot, greedy,
                                  reshuffle);
  // the balance and minimality oracles (k >= 1), against the old owners
  if (popcount(next_member, ng) >= 1) {
    bool owners_ok = true;
    int32_t moved = 0;
    uint64_t load = 0;
    for (int s = 0; s < kShards; ++s) {
      const int x = nib(next, s) - 1;
      owners_ok &= x >= 0 && x < ng && ((next_member >> x) & 1u);
      moved += x != m.owner[s];
      if (x >= 0) load += nib_at(x, 1);
    }
    int32_t cmax = -1, cmin = kBig;
    for (int g = 0; g < ng; ++g) {
      if (!((next_member >> g) & 1u)) continue;
      const int32_t c = nib(load, g);
      cmax = c > cmax ? c : cmax;
      cmin = c < cmin ? c : cmin;
    }
    if (!owners_ok || cmax - cmin > 1) a.viol |= kViolBalance;
    if (moved != min_moves(ng, next_member, l)) a.viol |= kViolMinimal;
  }
  *m.cfg_num = num + 1;
  for (int s = 0; s < kShards; ++s) m.owner[s] = nib(next, s) - 1;
  m.hist[num + 1] = hash_config(next_member, m.owner, num + 1);
  for (int g = 0; g < ng; ++g) m.member[g] = (next_member >> g) & 1u;
  return a;
}

// ------------------------------------------------------------ leaf access
// A load from an input of K10: the inputs stay as they are for the whole
// launch (K10 writes a new state), so the loads go through the read-only
// cache
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

// Node i's state machine (or, with i < 0, the walker's), its rows from
// the environment e
template <class E>
__device__ __forceinline__ Machine machine_of(const E &e, int i) {
  const Dims &d = e.d();
  if (i < 0)
    return {e.template w<uint8_t>(kWMember), e.template w<int32_t>(kWOwner),
            e.template w<int32_t>(kWHist), e.template w<int32_t>(kWCfgNum),
            e.template w<int32_t>(kWLastSeq)};
  return {e.template w<uint8_t>(kMember) + i * d.ng,
          e.template w<int32_t>(kOwner) + i * kShards,
          e.template w<int32_t>(kHist) + i * d.ncfg,
          e.template w<int32_t>(kCfgNum) + i,
          e.template w<int32_t>(kLastSeq) + i * d.nc};
}

// K10's environment for cluster c: its region ws in the block's shared
// memory (every leaf's new row but the two log rows, which K10 writes to
// their outputs), the pre-tick values from the inputs, the stepped raft
// rows staged in ws
struct K10Env {
  static constexpr bool kMet = kMetrics;
  const Params &p;
  int32_t *ws;
  int c;
  __device__ int lanes() const { return kThreads; }
  __device__ int walker() const { return kWalker; }
  __device__ int clerk0() const { return kClerk0; }
  __device__ const Dims &d() const { return p.d; }
  __device__ const Layout &L() const { return p.L; }
  // leaf l's row in the region (the tick's new values), a scratch word
  template <typename T>
  __device__ T *w(int l) const {
    return reinterpret_cast<T *>(ws + p.leaf[l].off);
  }
  __device__ int32_t *s(int off) const { return ws + off; }
  // leaf l's pre-tick row
  template <typename T>
  __device__ Ro<T> pre(int l) const { return in_row<T>(p, l, c); }
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
  __device__ int32_t snap_src(int i) const { return raft(kRSnapSrc)[i]; }
  __device__ const int32_t *shadow_val() const { return ws + p.L.sh_val; }
  __device__ int32_t shadow_base() const {
    return read_row<int32_t>(p, kShadowBase, c, 1)[0];
  }
  __device__ int32_t shadow_len() const {
    return read_row<int32_t>(p, kShadowLen, c, 1)[0];
  }
  // the pre-tick views
  __device__ bool pre_alive(int i) const { return raft(kRPreAlive)[i] != 0; }
  __device__ int32_t pre_base(int i) const { return raft(kRPreBase)[i]; }
  __device__ float kf(int k) const {
    return read_row<float>(p, kKnobF, c, kNF)[k];
  }
  __device__ int32_t ki(int k) const {
    return read_row<int32_t>(p, kKnobI, c, kNI)[k];
  }
  __device__ Machine machine(int i) const { return machine_of(*this, i); }
  // the log: node i's log_val row before the submits (the input), the
  // log_len the submits move, an appended entry (to the outputs)
  __device__ Ro<int32_t> log_val(int i) const {
    return in_row<int32_t>(p, kLogVal, c) + i * p.d.cap;
  }
  __device__ int32_t *log_len() const { return w<int32_t>(kLogLen); }
  __device__ void append(int i, int pos, int32_t term, int32_t val) const {
    out_row<int32_t>(p, kLogTerm, c)[i * p.d.cap + pos] = term;
    out_row<int32_t>(p, kLogVal, c)[i * p.d.cap + pos] = val;
  }
  __device__ int32_t &violations() const { return w<int32_t>(kViolations)[0]; }
  __device__ int32_t &first_violation() const {
    return w<int32_t>(kFirstViolation)[0];
  }
  // after the submits: the fsync watermark follows the log where it grew
  // (state.durable_after_append) and the compaction floor is the apply
  // cursor
  __device__ void submitted() const {
    const Ro<int32_t> log_len0 = pre<int32_t>(kLogLen);
    const int32_t *len = w<int32_t>(kLogLen), *applied = w<int32_t>(kApplied);
    int32_t *durable = w<int32_t>(kDurableLen);
    int32_t *floor_ = w<int32_t>(kCompactFloor);
    for (int i = 0; i < p.d.n; ++i) {
      if (len[i] > log_len0[i]) durable[i] = len[i];
      floor_[i] = applied[i];
    }
  }
};

// The worst-op register after the acks' fold: the clerks' candidates
// (cand, [nc, kWorstWords]) reduced in client order (the first of the
// largest masked latency), then the register updated (metrics.py
// update_worst)
template <class E>
__device__ __forceinline__ void worst_apply(const E &e, const int32_t *cand) {
  bool any = false;
  int best_cl = 0;
  int32_t best = 0;
  for (int cl = 0; cl < e.d().nc; ++cl) {
    const int32_t *x = cand + cl * kWorstWords;
    const int32_t v = x[0] ? x[1] : -1;
    if (cl == 0 || v > best) {
      best = v;
      best_cl = cl;
    }
    any |= x[0] != 0;
  }
  const int32_t *w = cand + best_cl * kWorstWords;
  int32_t *lat = e.template w<int32_t>(kWorstLat);
  int32_t *sub = e.template w<int32_t>(kWorstSub);
  if (!(any && (w[1] > lat[0] || sub[0] == 0))) return;
  lat[0] = w[1];
  e.template w<int32_t>(kWorstKey)[0] = w[2];
  e.template w<int32_t>(kWorstClient)[0] = best_cl;
  sub[0] = w[3];
  int32_t *ph = e.template w<int32_t>(kWorstPhases);
  for (int q = 0; q < kPhases; ++q) ph[q] = w[4 + q];
}

// ------------------------------------------------------- the service tick
// The tick's scratch that starts cleared: the clerks' shadow flags and
// the violation bits
__device__ __forceinline__ void clear_tick(const Layout &L, int32_t *ws,
                                           int nc, int lane, int lanes) {
  for (int cl = lane; cl < nc; cl += lanes) ws[L.flag + cl] = 0;
  if (lane == 0) ws[L.viol] = 0;
}

// One node table of the restore (the live rows `live`, their snapshot
// `snap`, w elements a node), a cell a lane: the crash reset to the
// persisted snapshot and the compaction capture (a cell reads only
// itself), and the install of the sender's PRE-tick snapshot (`none` for
// a sender out of range)
template <typename T, class E>
__device__ __forceinline__ void restore_table(const E &e, int lane,
                                              int live, int snap, int w,
                                              T none) {
  const int n = e.d().n;
  const auto sn0 = e.template pre<T>(snap);
  T *lv = e.template w<T>(live);
  T *sn = e.template w<T>(snap);
  for (int x = lane; x < n * w; x += e.lanes()) {
    const int i = x / w;
    const int32_t src = e.snap_src(i);
    if (src >= 0) {
      lv[x] = sn[x] = src < n ? sn0[src * w + x % w] : none;
      continue;
    }
    const bool alive = e.alive(i);
    if (!e.pre_alive(i) || !alive) lv[x] = sn[x];
    if (e.base()[i] != e.pre_base(i) && alive) sn[x] = lv[x];
  }
}

// Phase restore: whether each clerk's op is in the live shadow (a
// (clerk, slot) pair a lane, the clerks' pre-tick rows from the region,
// which no phase before clerks writes), and the apply machines' crash
// reset, compaction capture and install-snapshot (a table cell a lane)
template <class E>
__device__ __forceinline__ void restore(const E &e, int lane) {
  const Dims &d = e.d();
  const int n = d.n, cap = d.cap, nc = d.nc;
  const int32_t *val = e.shadow_val();
  const int32_t sh_base = e.shadow_base();
  const int32_t sh_len = e.shadow_len();
  const int32_t *clerk_seq = e.template w<int32_t>(kClerkSeq);
  const int32_t *clerk_arg = e.template w<int32_t>(kClerkArg);
  const int32_t *clerk_kind = e.template w<int32_t>(kClerkKind);
  for (int x = lane; x < nc * cap; x += e.lanes()) {
    const int cl = x / cap, i = x % cap;
    const int32_t want = pack(cl, clerk_seq[cl], clerk_arg[cl],
                              clerk_kind[cl], d.arg_lim);
    if (val[i] == want && shadow_abs(sh_base, i, cap) <= sh_len)
      shared_or(e.s(e.L().flag) + cl, 1);
  }
  for (int i = lane; i < n; i += e.lanes())
    if (!e.pre_alive(i) || !e.alive(i) || e.snap_src(i) >= 0)
      e.template w<int32_t>(kApplied)[i] = e.base()[i];
  restore_table<int32_t>(e, lane, kLastSeq, kSnapLastSeq, nc, 0);
  restore_table<uint8_t>(e, lane, kMember, kSnapMember, d.ng, 0);
  restore_table<int32_t>(e, lane, kOwner, kSnapOwner, kShards, -1);
  restore_table<int32_t>(e, lane, kCfgNum, kSnapCfgNum, 1, 0);
  restore_table<int32_t>(e, lane, kHist, kSnapHist, d.ncfg, 0);
}

// Phase apply: apply_max rounds of the apply loop, a node a lane (a
// node's rounds are sequential, the nodes independent), each round's
// Query answers to the scratch (first, first_obs) for the clerks; and on
// the walker's lane the truth walker's walk_max steps over the shadow
// window, with the sticky stall. The log rows are the raft tick's, read
// before any submit appends
template <class E>
__device__ __forceinline__ void apply(const E &e, int lane) {
  const Dims &d = e.d();
  const Layout &L = e.L();
  const int n = d.n, cap = d.cap, nc = d.nc;
  const bool greedy = e.ki(kBugGreedy) != 0;
  const bool reshuffle = e.ki(kBugReshuffle) != 0;
  int32_t viol = 0;
  if (lane < n) {
    const int i = lane;
    const bool alive = e.alive(i);
    const int32_t commit = e.commit()[i];
    const int rot = e.ki(kBugRotate) != 0 ? i : 0;
    const auto log_val0 = e.log_val(i);
    const auto clerk_seq0 = e.template pre<int32_t>(kClerkSeq);
    const Machine m = e.machine(i);
    int32_t *first = e.s(L.first) + i * nc;
    int32_t *first_obs = e.s(L.first_obs) + i * nc;
    int32_t &applied = e.template w<int32_t>(kApplied)[i];
    for (int cl = 0; cl < nc; ++cl) first[cl] = d.apply_max;
    for (int round = 0; round < d.apply_max && alive && applied < commit;
         ++round) {
      const int32_t val = log_val0[static_cast<int>(
          static_cast<uint32_t>(applied) & static_cast<uint32_t>(cap - 1))];
      const Applied a = apply_entry(d, m, rot, greedy, reshuffle, val);
      viol |= a.viol;
      if (a.q_obs >= 0 && a.seq == clerk_seq0[a.client] &&
          first[a.client] == d.apply_max) {
        first[a.client] = round;
        first_obs[a.client] = a.q_obs;
      }
      applied = wrap_add(applied, 1);
    }
  }
  if (lane == e.walker()) {
    const int32_t sh_base = e.shadow_base();
    const int32_t sh_len = e.shadow_len();
    const int32_t *sh_val = e.shadow_val();
    const Machine w = e.machine(-1);
    int32_t &frontier = e.template w<int32_t>(kWFrontier)[0];
    uint8_t &stalled = e.template w<uint8_t>(kWStalled)[0];
    int32_t *q_seq = e.template w<int32_t>(kWQSeq);
    int32_t *q_obs = e.template w<int32_t>(kWQObs);
    for (int step = 0; step < d.walk_max && frontier < sh_len; ++step) {
      const int pos = static_cast<int>(static_cast<uint32_t>(frontier) &
                                       static_cast<uint32_t>(cap - 1));
      // the entry needed was overwritten by the ring: the walk stops, and
      // the stall is sticky
      if (shadow_abs(sh_base, pos, cap) != wrap_add(frontier, 1)) {
        stalled = 1;
        break;
      }
      const Applied a = apply_entry(d, w, 0, greedy, reshuffle, sh_val[pos]);
      viol |= a.viol;
      if (a.q_obs >= 0) {
        q_seq[a.client] = a.seq;
        q_obs[a.client] = a.q_obs;
      }
      frontier = wrap_add(frontier, 1);
    }
  }
  if (viol) shared_or(e.s(L.viol), viol);
}

// Node i's divergence oracle: at the walker's frontier and alive, its
// state machine must equal the walker's bit for bit
template <class E>
__device__ __forceinline__ void diverge(const E &e, int i) {
  const Dims &d = e.d();
  const Machine m = e.machine(i), w = e.machine(-1);
  if (!(e.alive(i) && e.template w<int32_t>(kApplied)[i] ==
                          e.template w<int32_t>(kWFrontier)[0]))
    return;
  bool same = *m.cfg_num == *w.cfg_num;
  for (int g = 0; g < d.ng; ++g) same &= m.member[g] == w.member[g];
  for (int s = 0; s < kShards; ++s) same &= m.owner[s] == w.owner[s];
  for (int h = 0; h < d.ncfg; ++h) same &= m.hist[h] == w.hist[h];
  for (int cl = 0; cl < d.nc; ++cl) same &= m.last_seq[cl] == w.last_seq[cl];
  if (!same) shared_or(e.s(e.L().viol), kViolDiverge);
}

// Clerk cl of phase clerks: the Query answer (the largest a node gave in
// the first round any gave one), the ack, the query oracle, the metric
// folds, a fresh op or a retry and its target. It reads its own pre-tick
// values before it writes any
template <class E>
__device__ __forceinline__ void clerk(const E &e, int cl) {
  const Dims &d = e.d();
  const Layout &L = e.L();
  const int n = d.n, nc = d.nc, ng = d.ng, part = d.part;
  const int32_t t = e.tick();
  int32_t viol = 0;

  const int32_t cs = e.template pre<int32_t>(kClerkSeq)[cl];
  const int32_t kind0 = e.template pre<int32_t>(kClerkKind)[cl];
  const bool out0 = e.template pre<uint8_t>(kClerkOut)[cl] != 0;
  int32_t obs = e.template w<int32_t>(kClerkQObs)[cl];
  if (obs < 0) {
    int round = d.apply_max;
    for (int i = 0; i < n; ++i) {
      const int r = e.s(L.first)[i * nc + cl];
      const int32_t o = e.s(L.first_obs)[i * nc + cl];
      if (r < round || (r == round && r < d.apply_max && o > obs)) {
        round = r;
        obs = o;
      }
    }
  }
  const bool in_shadow = e.s(L.flag)[cl] != 0;
  const bool is_q = kind0 == kQuery;
  const bool ready =
      obs >= 0 && e.template w<int32_t>(kWQSeq)[cl] == cs;
  int32_t sub = 0, app = 0, cmt = 0, apl = 0;
  if constexpr (E::kMet) {
    sub = e.template pre<int32_t>(kClerkSub)[cl];
    app = e.template pre<int32_t>(kClerkApp)[cl];
    cmt = e.template pre<int32_t>(kClerkCmt)[cl];
    apl = e.template pre<int32_t>(kClerkApl)[cl];
    if (out0 && in_shadow && cmt == 0) cmt = t;
    if (out0 && ready && apl == 0) apl = t;
  }
  const bool newly = out0 && in_shadow && (!is_q || ready);
  const bool done_q = newly && is_q;
  if (done_q && obs != e.template w<int32_t>(kWQObs)[cl]) viol |= kViolQuery;
  const int32_t acked =
      newly ? cs : e.template pre<int32_t>(kClerkAcked)[cl];
  bool cout = out0 && !newly;
  const int32_t done =
      wrap_add(e.template pre<int32_t>(kQueriesDone)[cl], done_q);
  if constexpr (E::kMet) {
    // the ack's submit->ack latency, its phases (clerk_phase_matrix: the
    // stamps clamped monotone) and its worst-op candidate (key -1)
    const int hb = d.hb;
    const int32_t e2e = wrap_sub(t, sub);
    const int32_t app_e = app > sub ? app : sub;
    const int32_t cmt_e = cmt > app_e ? cmt : app_e;
    const int32_t b3 = is_q ? (apl > cmt_e ? apl : cmt_e) : cmt_e;
    const int32_t ph[kPhases] = {wrap_sub(app_e, sub), wrap_sub(cmt_e, app_e),
                                 wrap_sub(b3, cmt_e), wrap_sub(t, b3)};
    if (newly) {
      shared_add(e.template w<int32_t>(kLatHist) + bucket_of(e2e, hb), 1);
      int32_t *phist = e.template w<int32_t>(kPhaseHist);
      int32_t *pticks = e.template w<int32_t>(kPhaseTicks);
      for (int q = 0; q < kPhases; ++q) {
        shared_add(phist + q * hb + bucket_of(ph[q], hb), 1);
        shared_add(pticks + q, ph[q]);
      }
      shared_add(e.template w<int32_t>(kLatTicks), e2e);
    }
    int32_t *x = e.s(L.worst) + cl * kWorstWords;
    x[0] = newly;
    x[1] = e2e;
    x[2] = -1;
    x[3] = sub;
    for (int q = 0; q < kPhases; ++q) x[4 + q] = ph[q];
  }

  // the draws, from the tick's keys; each only where its value is used
  uint32_t kk[kDrawKeys][2];
  for (int j = 0; j < kDrawKeys; ++j) {
    kk[j][0] = static_cast<uint32_t>(e.s(L.draws)[2 * j]);
    kk[j][1] = static_cast<uint32_t>(e.s(L.draws)[2 * j + 1]);
  }
  const bool start =
      !cout && cs < kSeqLim - 1 &&
      madraft::uniform(bits_word(kk[0][0], kk[0][1], cl, nc, part)) <
          e.kf(kPOp);
  int32_t kind = kind0, arg = e.template pre<int32_t>(kClerkArg)[cl];
  if (start) {
    const float u = madraft::uniform(
        bits_word(kk[7][0], kk[7][1], cl, nc, part));
    const float pq = e.kf(kPQuery), pm = e.kf(kPMove);
    const float pqm = fadd(pq, pm);
    // Join / Leave split the residual mass evenly
    kind = u < pq ? kQuery
           : u < pqm ? kMove
           : u < fadd(pqm, fmul(fsub(fsub(1.0f, pq), pm), 0.5f)) ? kJoin
                                                                 : kLeave;
    const int32_t raw = randint_elem(kk[1][0], kk[1][1], cl, nc, 0,
                                     kShards * ng, part);
    if (kind == kQuery) {
      arg = raw % 4 == 0 ? d.arg_lim - 1
                         : randint_elem(kk[4][0], kk[4][1], cl, nc, 0,
                                        d.ncfg + 1, part);
    } else if (kind == kMove) {
      arg = raw;
    } else {
      // a gid set: the first gcnt of the clerk's join_max draws
      const int jm = d.join_max;
      const int32_t cnt = randint_elem(kk[6][0], kk[6][1], cl, nc, 1, jm + 1,
                                       part);
      arg = 0;
      for (int j = 0; j < jm && j < cnt; ++j)
        arg |= 1 << randint_elem(kk[5][0], kk[5][1], cl * jm + j, nc * jm,
                                 0, ng, part);
    }
    obs = -1;
    if constexpr (E::kMet) {
      sub = t;
      app = cmt = apl = 0;
    }
  }
  cout = cout || start;
  const bool rt = cout && (start || madraft::uniform(bits_word(
                                        kk[2][0], kk[2][1], cl, nc, part)) <
                                        e.kf(kPRetry));
  if constexpr (E::kMet) {
    e.template w<int32_t>(kClerkSub)[cl] = sub;
    e.template w<int32_t>(kClerkApp)[cl] = app;
    e.template w<int32_t>(kClerkCmt)[cl] = cmt;
    e.template w<int32_t>(kClerkApl)[cl] = apl;
  }
  e.template w<int32_t>(kClerkSeq)[cl] = start ? wrap_add(cs, 1) : cs;
  e.template w<uint8_t>(kClerkOut)[cl] = cout;
  e.template w<int32_t>(kClerkArg)[cl] = arg;
  e.template w<int32_t>(kClerkKind)[cl] = kind;
  e.template w<int32_t>(kClerkAcked)[cl] = acked;
  e.template w<int32_t>(kClerkQObs)[cl] = obs;
  e.template w<int32_t>(kQueriesDone)[cl] = done;
  e.s(L.target)[cl] =
      rt ? randint_elem(kk[3][0], kk[3][1], cl, nc, 0, n, part) : 0;
  e.s(L.retry)[cl] = rt;
  if (viol) shared_or(e.s(L.viol), viol);
}

// Phase clerks: the divergence oracle, a node a lane, and the clerks, a
// clerk a lane from the environment's clerk0() on (K10: the second warp;
// K6-ctrler's 16 lanes take clerks 16 on twice)
template <class E>
__device__ __forceinline__ void clerks(const E &e, int lane) {
  if (lane < e.d().n) diverge(e, lane);
  for (int cl = lane - e.clerk0(); cl < e.d().nc; cl += e.lanes())
    if (cl >= 0) clerk(e, cl);
}

// Phase submit, one lane: the worst-op register, the violation bits, the
// submits appended at self-believed leaders one clerk after another
// (clerk c's append reads the log_len clerk c - 1 moved), and the raft
// leaves they move
template <class E>
__device__ __forceinline__ void submit(const E &e) {
  const Dims &d = e.d();
  const Layout &L = e.L();
  const int cap = d.cap, nc = d.nc;
  const int32_t t = e.tick();
  const int32_t *term = e.term();
  const int32_t *role = e.role();
  const int32_t *base = e.base();
  const int32_t *commit = e.commit();
  const int32_t flow_cap = e.ki(kFlowCap);
  if constexpr (E::kMet) worst_apply(e, e.s(L.worst));
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
             pack(cl, e.template w<int32_t>(kClerkSeq)[cl],
                  e.template w<int32_t>(kClerkArg)[cl],
                  e.template w<int32_t>(kClerkKind)[cl], d.arg_lim));
    log_len[i] = wrap_add(log_len[i], 1);
    if (E::kMet && e.template w<uint8_t>(kClerkOut)[cl]) {
      int32_t &app = e.template w<int32_t>(kClerkApp)[cl];
      if (app == 0) app = t;
    }
  }
  e.submitted();
}

// ------------------------------------------------------------ K10's tick
// K10's phase kStage: every leaf's row from its input into the block's
// region by the staging plan (stage.cuh), the shadow window's values by
// cp.async words, the two log rows straight to their outputs, the stepped
// raft rows and the tick's draw keys, the scratch cleared; then the wait
// for the copies. The tick then updates the region, and reads the
// pre-tick values from the inputs (K10Env)
__device__ __forceinline__ void stage(const Params &p, const Plan &pl,
                                      int32_t *ws, uint64_t *bar, int c,
                                      int tid) {
  const int n = p.d.n, cap = p.d.cap;
  const Layout &L = p.L;
  stage::load(pl, reinterpret_cast<unsigned char *>(ws), bar, c, tid,
              kThreads);
  const int32_t *sv = static_cast<const int32_t *>(p.read[kShadowVal]) +
                      static_cast<int64_t>(c) * cap;
  for (int i = tid; i < cap; i += kThreads)
    stage::word_load(ws + L.sh_val + i, sv + i);
  stage::copy_row(p.leaf[kLogTerm].in, p.leaf[kLogTerm].out, n * cap, c,
                  p.log_quads > 0, tid, kThreads);
  stage::copy_row(p.leaf[kLogVal].in, p.leaf[kLogVal].out, n * cap, c,
                  p.log_quads > 0, tid, kThreads);
  // the tick's keys (kDrawKeys): fold_in(key, t), then the sites, a key a
  // thread while the copies are in flight
  if (tid < kDrawKeys) {
    const Ro<uint32_t> key = read_row<uint32_t>(p, kKeys, c, 4);
    uint32_t k0 = key[0], k1 = key[2];  // the int64 words' low halves
    fold_in(k0, k1, static_cast<uint32_t>(
        read_row<int32_t>(p, kTick, c, 1)[0]));
    draw_key(k0, k1, tid, p.d.part, ws + L.draws + 2 * tid);
  }
  for (int i = tid; i < n; i += kThreads) {
    int32_t *rr = ws + L.raft + i;
    rr[kRTerm * n] = read_row<int32_t>(p, kTerm, c, n)[i];
    rr[kRRole * n] = read_row<int32_t>(p, kRole, c, n)[i];
    rr[kRAlive * n] = read_row<uint8_t>(p, kAlive, c, n)[i] != 0;
    rr[kRBase * n] = read_row<int32_t>(p, kBase, c, n)[i];
    rr[kRCommit * n] = read_row<int32_t>(p, kCommit, c, n)[i];
    rr[kRSnapSrc * n] = read_row<int32_t>(p, kSnapSrc, c, n)[i];
    rr[kRPreAlive * n] = read_row<uint8_t>(p, kPreAlive, c, n)[i] != 0;
    rr[kRPreBase * n] = read_row<int32_t>(p, kPreBase, c, n)[i];
  }
  clear_tick(L, ws, p.d.nc, tid, kThreads);
  stage::wait(bar, pl.bulk_bytes);
}

// Thread tid of cluster c's block in K10's phase `phase` (kSubmit runs on
// thread 0 alone); pl is the staging plan (its copy in shared memory), ws
// the block's region of Layout::words words, bar its mbarrier
__device__ __forceinline__ void run_phase(const Params &p, const Plan &pl,
                                          int32_t *ws, uint64_t *bar, int c,
                                          int tid, int phase) {
  const K10Env e{p, ws, c};
  switch (phase) {
    case kStage: stage(p, pl, ws, bar, c, tid); break;
    case kRestore: restore(e, tid); break;
    case kApply: apply(e, tid); break;
    case kClerks: clerks(e, tid); break;
    case kSubmit: if (tid == 0) submit(e); break;
    default:
      stage::store(pl, reinterpret_cast<const unsigned char *>(ws), c, tid,
                   kThreads);
      break;
  }
}

}  // namespace k10
