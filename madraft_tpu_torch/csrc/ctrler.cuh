// K10's device code: one shard-controller service tick of one cluster, by
// the kThreads threads of a block (ctrler.cu holds the kernel, its launch
// and the note on what it replaces, its bound and design). Built by nvcc
// through ctrler.cu, and by g++ through tests/ctrler_host_emu.cpp.
//
// The tick runs as six phases (Phase), a block barrier after each. Within
// a phase the threads share nothing but commutative updates of the
// block's shared region (atomic add, or): so the host runs a phase's
// threads one after another, then the next phase, and gets the card's
// result.
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

// A cluster's block: two warps (four took the same time and spilled at
// the 64 registers that eight blocks of four warps leave a thread)
constexpr int kThreads = 64;
constexpr int kWalker = kThreads - 1;  // the truth walker's thread
constexpr int kClerk0 = 32;      // the first clerk's thread in kClerks
static_assert(kThreads >= 64 && kThreads % 32 == 0, "two warps or more");
constexpr int kMaxNodes = 16;    // a node a thread in kApply
constexpr int kMaxCap = 256;
constexpr int kMaxClients = 32;  // a clerk a thread in kClerks
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

// The leaves K10 writes: the service leaves in CtrlerState order, then the
// raft leaves the service tick writes (kernels/ctrler.py RAFT_WRITES)
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

// The read-only inputs: the stepped raft state's leaves, the pre-tick
// views, the keys and the knob table (kernels/ctrler.py RAFT_READS)
enum Read {
  kTick, kTerm, kRole, kAlive, kBase, kCommit, kSnapSrc, kShadowVal,
  kShadowBase, kShadowLen, kPreAlive, kPreBase, kKeys, kKnobF, kKnobI,
  kReads
};

// The knob table's columns (kernels/ctrler.py KNOB_F32 / KNOB_I32)
enum KnobF { kPOp, kPQuery, kPMove, kPRetry, kNF };
enum KnobI { kBugRotate, kBugGreedy, kBugReshuffle, kFlowCap, kNI };

// The wrapper's descriptor (kernels/ctrler.py _launch): this header, the
// kReads pointers, then 4 words a leaf (in, out, count a cluster, bytes an
// element)
enum Desc {
  kB, kN, kCap, kNc, kNg, kNcfg, kJoinMax, kArgLim, kApplyMax, kWalkMax,
  kHb, kNph, kPartitionable, kMetricsOn,
  kHeader
};

// The phases of a tick, in order (run_phase)
enum Phase { kStage, kRestore, kApply, kClerks, kSubmit, kWriteBack,
             kTickPhases };

// A worst-op candidate's words in the block's region: mask, lat, key, sub,
// then the kPhases phases
constexpr int kWorstWords = 4 + kPhases;

// The tick's draw keys, from fold_in(cluster key, t): the seven splits of
// site 24 (the start, the arg draw, the retry, the target, the Query num,
// the gid set, the gid count) and site 27 (the op's kind)
constexpr int kDrawKeys = 8;

// The stepped raft rows the tick reads by node, the install sources and
// the pre-tick views, staged in the block's region (alive as 0 / 1)
enum RaftRow { kRTerm, kRRole, kRAlive, kRBase, kRCommit, kRSnapSrc,
               kRPreAlive, kRPreBase, kRaftRows };

// A leaf: its input and output, its count of elements a cluster, its
// bytes an element, and its row's offset in words in the block's region
// (-1 for a log row: see Params)
struct LeafRef {
  const void *in;
  void *out;
  int count, bytes, off;
};

using Plan = stage::Plan<kLeaves>;

// The staging plan's copy in shared memory, before the block's region: the
// copy loops read a row's fields at a runtime index, which the kernel's
// parameters serve slowly
constexpr int kPlanBytes = (static_cast<int>(sizeof(Plan)) + 15) / 16 * 16;

// The block's shared region, in int32 words: every leaf but the two log
// rows staged at its off (-1 for the log rows, which stay in device
// memory: the tick reads n * apply_max of their slots and appends at most
// nc; a bulk row's off a multiple of 4), then the tick's scratch
struct Params {
  LeafRef leaf[kLeaves];
  Plan plan;       // the staged rows' copies (stage.cuh)
  const void *read[kReads];
  int b, n, cap, nc, ng, ncfg, join_max, arg_lim, apply_max, walk_max, hb,
      nph, partitionable;
  int sh_val;     // [cap] the shadow window's values
  int viol;       // the tick's violation bits
  int flag;       // [nc] the clerk's op is in the live shadow
  int first;      // [n, nc] the apply round a node answered the clerk's
                  // Query (apply_max when none)
  int first_obs;  // [n, nc] its answer then
  int target;     // [nc] the node the clerk contacts
  int retry;      // [nc] the clerk submits
  int worst;      // [nc, kWorstWords] the acks' worst-op candidates
  int draws;      // [kDrawKeys, 2] the tick's draw keys
  int raft;       // [kRaftRows, n] the stepped raft rows (RaftRow)
  int log_quads;  // the two log rows' 16-byte quads a cluster (0: copied
                  // by words)
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
  p.ng = static_cast<int>(d[kNg]);
  p.ncfg = static_cast<int>(d[kNcfg]);
  p.join_max = static_cast<int>(d[kJoinMax]);
  p.arg_lim = static_cast<int>(d[kArgLim]);
  p.apply_max = static_cast<int>(d[kApplyMax]);
  p.walk_max = static_cast<int>(d[kWalkMax]);
  p.hb = static_cast<int>(d[kHb]);
  p.nph = static_cast<int>(d[kNph]);
  p.partitionable = static_cast<int>(d[kPartitionable]);
  if (p.b < 1 || p.n < 1 || p.n > kMaxNodes || p.cap < 1 ||
      p.cap > kMaxCap || (p.cap & (p.cap - 1)) || p.nc < 1 ||
      p.nc > kMaxClients || p.ng < 2 || p.ng > kMaxGids || p.ncfg < 1 ||
      p.ncfg > kMaxConfigs || p.join_max < 1 || p.join_max > p.ng ||
      p.arg_lim < 1 || p.apply_max < 0 || p.walk_max < 0 ||
      (d[kMetricsOn] != 0) != kMetrics)
    return false;
  if (kMetrics && (p.hb < 1 || p.hb > 31 || p.nph != kPhases)) return false;
  for (int r = 0; r < kReads; ++r)
    p.read[r] = ptr_of<const void>(d[kHeader + r]);
  int words = 0;
  stage::Row rows[kLeaves];
  int n_rows = 0;
  for (int l = 0; l < kLeaves; ++l) {
    const int64_t *g = d + kHeader + kReads + 4 * l;
    const bool log_row = l == kLogTerm || l == kLogVal;
    LeafRef &x = p.leaf[l];
    x = {ptr_of<const void>(g[0]), ptr_of<void>(g[1]),
         static_cast<int>(g[2]), static_cast<int>(g[3]), -1};
    if (x.bytes != 1 && x.bytes != 4) return false;
    if (x.count < 0 || x.count > (1 << 16)) return false;
    if (log_row) continue;
    if (stage::bulk(x.in, x.out, x.count, x.bytes)) words = (words + 3) & ~3;
    x.off = words;
    rows[n_rows++] = {x.in, x.out, x.count, x.bytes, 4 * x.off, 0};
    words += (x.count * x.bytes + 3) / 4;
  }
  if (!stage::plan(p.plan, rows, n_rows)) return false;
  // the log rows move in quads where both are 16-byte rows at 16-byte
  // aligned inputs and outputs
  bool quads = p.n * p.cap % 4 == 0;
  for (int l = kLogTerm; l <= kLogVal; ++l)
    quads = quads && (reinterpret_cast<uintptr_t>(p.leaf[l].in) |
                      reinterpret_cast<uintptr_t>(p.leaf[l].out)) % 16 == 0;
  p.log_quads = quads ? p.n * p.cap / 4 : 0;
  p.sh_val = words;
  p.viol = p.sh_val + p.cap;
  p.flag = p.viol + 1;
  p.first = p.flag + p.nc;
  p.first_obs = p.first + p.n * p.nc;
  p.target = p.first_obs + p.n * p.nc;
  p.retry = p.target + p.nc;
  p.worst = p.retry + p.nc;
  p.draws = p.worst + p.nc * kWorstWords;
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

// The threads' commutative updates of a word of the block's region (on
// the host the threads run one after another)
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

// A controller state machine instance in the block's region: a node's rows
// or the walker's
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
__device__ __noinline__ Applied apply_entry(const Params &p, Machine m,
                                            int tie_rot, bool greedy,
                                            bool reshuffle, int32_t val) {
  const int ng = p.ng;
  Applied a{false, 0, 0, -1, 0};
  if (val == kNoop) return a;
  const Op o = unpack(val, p.arg_lim, p.nc);
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
  if (num >= p.ncfg - 1) return a;  // the history is full
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
// A load from an input: the inputs stay as they are for the whole launch
// (the state is written out of place), so the loads go through the
// read-only cache
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

// The staged (new) row of leaf l in the block's region ws
template <typename T>
__device__ __forceinline__ T *work(const Params &p, int32_t *ws, int l) {
  return reinterpret_cast<T *>(ws + p.leaf[l].off);
}

// A staged raft row (RaftRow) in the block's region ws
__device__ __forceinline__ const int32_t *raft_row(const Params &p,
                                                   const int32_t *ws, int r) {
  return ws + p.raft + r * p.n;
}

// Node i's state machine (or, with i < 0, the walker's) in the region
__device__ __forceinline__ Machine machine(const Params &p, int32_t *ws,
                                          int i) {
  if (i < 0)
    return {work<uint8_t>(p, ws, kWMember), work<int32_t>(p, ws, kWOwner),
            work<int32_t>(p, ws, kWHist), work<int32_t>(p, ws, kWCfgNum),
            work<int32_t>(p, ws, kWLastSeq)};
  return {work<uint8_t>(p, ws, kMember) + i * p.ng,
          work<int32_t>(p, ws, kOwner) + i * kShards,
          work<int32_t>(p, ws, kHist) + i * p.ncfg,
          work<int32_t>(p, ws, kCfgNum) + i,
          work<int32_t>(p, ws, kLastSeq) + i * p.nc};
}

// The worst-op register after the acks' fold: the clerks' candidates
// (cand, [nc, kWorstWords]) reduced in client order (the first of the
// largest masked latency), then the register updated (metrics.py
// update_worst)
__device__ __forceinline__ void worst_apply(const Params &p, int32_t *ws,
                                            const int32_t *cand) {
  bool any = false;
  int best_cl = 0;
  int32_t best = 0;
  for (int cl = 0; cl < p.nc; ++cl) {
    const int32_t *x = cand + cl * kWorstWords;
    const int32_t v = x[0] ? x[1] : -1;
    if (cl == 0 || v > best) {
      best = v;
      best_cl = cl;
    }
    any |= x[0] != 0;
  }
  const int32_t *w = cand + best_cl * kWorstWords;
  int32_t *lat = work<int32_t>(p, ws, kWorstLat);
  int32_t *sub = work<int32_t>(p, ws, kWorstSub);
  if (!(any && (w[1] > lat[0] || sub[0] == 0))) return;
  lat[0] = w[1];
  work<int32_t>(p, ws, kWorstKey)[0] = w[2];
  work<int32_t>(p, ws, kWorstClient)[0] = best_cl;
  sub[0] = w[3];
  int32_t *ph = work<int32_t>(p, ws, kWorstPhases);
  for (int q = 0; q < kPhases; ++q) ph[q] = w[4 + q];
}

// ------------------------------------------------------- the service tick
// Phase kStage: every leaf's row from its input into the block's region
// by the staging plan (stage.cuh), the shadow window's values by cp.async
// words, the two log rows straight to their outputs, the stepped raft
// rows and the tick's draw keys, the scratch cleared; then the wait for
// the copies. The tick then updates the region, and reads the pre-tick
// values from the inputs where a cell's value may already have changed:
// the install path adopts the sender's PRE-tick snapshot after the
// compaction capture rewrote it.
__device__ __forceinline__ void stage(const Params &p, const Plan &pl,
                                      int32_t *ws, uint64_t *bar, int c,
                                      int tid) {
  const int n = p.n;
  stage::load(pl, reinterpret_cast<unsigned char *>(ws), bar, c, tid,
              kThreads);
  const int32_t *sv = static_cast<const int32_t *>(p.read[kShadowVal]) +
                      static_cast<int64_t>(c) * p.cap;
  for (int i = tid; i < p.cap; i += kThreads)
    stage::word_load(ws + p.sh_val + i, sv + i);
  stage::copy_row(p.leaf[kLogTerm].in, p.leaf[kLogTerm].out, p.n * p.cap, c,
                  p.log_quads > 0, tid, kThreads);
  stage::copy_row(p.leaf[kLogVal].in, p.leaf[kLogVal].out, p.n * p.cap, c,
                  p.log_quads > 0, tid, kThreads);
  // the tick's keys (kDrawKeys): fold_in(key, t), then the sites, a key a
  // thread while the copies are in flight
  if (tid < kDrawKeys) {
    const Ro<uint32_t> key = read_row<uint32_t>(p, kKeys, c, 4);
    uint32_t k0 = key[0], k1 = key[2];  // the int64 words' low halves
    fold_in(k0, k1, static_cast<uint32_t>(
        read_row<int32_t>(p, kTick, c, 1)[0]));
    fold_in(k0, k1, tid < 7 ? kSiteStart : kSiteKind);
    uint32_t d0 = k0, d1 = k1;
    if (tid < 7) split_key(k0, k1, 7, tid, p.partitionable, d0, d1);
    ws[p.draws + 2 * tid] = static_cast<int32_t>(d0);
    ws[p.draws + 2 * tid + 1] = static_cast<int32_t>(d1);
  }
  for (int i = tid; i < n; i += kThreads) {
    int32_t *rr = ws + p.raft + i;
    rr[kRTerm * n] = read_row<int32_t>(p, kTerm, c, n)[i];
    rr[kRRole * n] = read_row<int32_t>(p, kRole, c, n)[i];
    rr[kRAlive * n] = read_row<uint8_t>(p, kAlive, c, n)[i] != 0;
    rr[kRBase * n] = read_row<int32_t>(p, kBase, c, n)[i];
    rr[kRCommit * n] = read_row<int32_t>(p, kCommit, c, n)[i];
    rr[kRSnapSrc * n] = read_row<int32_t>(p, kSnapSrc, c, n)[i];
    rr[kRPreAlive * n] = read_row<uint8_t>(p, kPreAlive, c, n)[i] != 0;
    rr[kRPreBase * n] = read_row<int32_t>(p, kPreBase, c, n)[i];
  }
  for (int cl = tid; cl < p.nc; cl += kThreads) ws[p.flag + cl] = 0;
  if (tid == 0) ws[p.viol] = 0;
  stage::wait(bar, pl.bulk_bytes);
}

// One node table of the restore (the live rows `live`, their snapshot
// `snap`, w elements a node), a cell a thread: the crash reset to the
// persisted snapshot and the compaction capture from the staged rows (a
// cell reads only itself), and the install of the sender's PRE-tick
// snapshot from the input (`none` for a sender out of range)
template <typename T>
__device__ __forceinline__ void restore_table(const Params &p, int32_t *ws,
                                              int c, int tid, int live,
                                              int snap, int w, T none) {
  const int n = p.n;
  const int32_t *alive = raft_row(p, ws, kRAlive);
  const int32_t *base = raft_row(p, ws, kRBase);
  const int32_t *pre_alive = raft_row(p, ws, kRPreAlive);
  const int32_t *pre_base = raft_row(p, ws, kRPreBase);
  const int32_t *snap_src = raft_row(p, ws, kRSnapSrc);
  const Ro<T> sn0 = in_row<T>(p, snap, c);
  T *lv = work<T>(p, ws, live);
  T *sn = work<T>(p, ws, snap);
  for (int x = tid; x < n * w; x += kThreads) {
    const int i = x / w;
    const int32_t src = snap_src[i];
    if (src >= 0) {
      lv[x] = sn[x] = src < n ? sn0[src * w + x % w] : none;
      continue;
    }
    if (!pre_alive[i] || !alive[i]) lv[x] = sn[x];
    if (base[i] != pre_base[i] && alive[i]) sn[x] = lv[x];
  }
}

// Phase kRestore: whether each clerk's op is in the live shadow (a
// (clerk, slot) pair a thread, the clerks' pre-tick rows from the region,
// which no phase before kClerks writes), and the apply machines' crash
// reset, compaction capture and install-snapshot (a table cell a thread)
__device__ __forceinline__ void restore(const Params &p, int32_t *ws, int c,
                                        int tid) {
  const int n = p.n, cap = p.cap, nc = p.nc;
  const int32_t *val = ws + p.sh_val;
  const int32_t sh_base = read_row<int32_t>(p, kShadowBase, c, 1)[0];
  const int32_t sh_len = read_row<int32_t>(p, kShadowLen, c, 1)[0];
  const int32_t *clerk_seq = work<int32_t>(p, ws, kClerkSeq);
  const int32_t *clerk_arg = work<int32_t>(p, ws, kClerkArg);
  const int32_t *clerk_kind = work<int32_t>(p, ws, kClerkKind);
  for (int x = tid; x < nc * cap; x += kThreads) {
    const int cl = x / cap, i = x % cap;
    const int32_t want = pack(cl, clerk_seq[cl], clerk_arg[cl],
                              clerk_kind[cl], p.arg_lim);
    if (val[i] == want && shadow_abs(sh_base, i, cap) <= sh_len)
      shared_or(ws + p.flag + cl, 1);
  }
  const int32_t *alive = raft_row(p, ws, kRAlive);
  const int32_t *base = raft_row(p, ws, kRBase);
  const int32_t *pre_alive = raft_row(p, ws, kRPreAlive);
  const int32_t *snap_src = raft_row(p, ws, kRSnapSrc);
  for (int i = tid; i < n; i += kThreads)
    if (!pre_alive[i] || !alive[i] || snap_src[i] >= 0)
      work<int32_t>(p, ws, kApplied)[i] = base[i];
  restore_table<int32_t>(p, ws, c, tid, kLastSeq, kSnapLastSeq, nc, 0);
  restore_table<uint8_t>(p, ws, c, tid, kMember, kSnapMember, p.ng, 0);
  restore_table<int32_t>(p, ws, c, tid, kOwner, kSnapOwner, kShards, -1);
  restore_table<int32_t>(p, ws, c, tid, kCfgNum, kSnapCfgNum, 1, 0);
  restore_table<int32_t>(p, ws, c, tid, kHist, kSnapHist, p.ncfg, 0);
}

// Phase kApply: apply_max rounds of the apply loop, a node a thread (a
// node's rounds are sequential, the nodes independent), each round's
// Query answers to the scratch (first, first_obs) for the clerks; and on
// the last thread (kWalker, the last warp) the truth walker's walk_max
// steps over the staged shadow window, with the sticky stall
__device__ __forceinline__ void apply(const Params &p, int32_t *ws, int c,
                                      int tid) {
  const int n = p.n, cap = p.cap, nc = p.nc;
  const Ro<int32_t> ki = read_row<int32_t>(p, kKnobI, c, kNI);
  const bool greedy = ki[kBugGreedy] != 0;
  const bool reshuffle = ki[kBugReshuffle] != 0;
  int32_t viol = 0;
  if (tid < n) {
    const int i = tid;
    const bool alive = raft_row(p, ws, kRAlive)[i] != 0;
    const int32_t commit = raft_row(p, ws, kRCommit)[i];
    const int rot = ki[kBugRotate] != 0 ? i : 0;
    const Ro<int32_t> log_val0 = in_row<int32_t>(p, kLogVal, c) + i * cap;
    const Ro<int32_t> clerk_seq0 = in_row<int32_t>(p, kClerkSeq, c);
    const Machine m = machine(p, ws, i);
    int32_t *first = ws + p.first + i * nc;
    int32_t *first_obs = ws + p.first_obs + i * nc;
    int32_t &applied = work<int32_t>(p, ws, kApplied)[i];
    for (int cl = 0; cl < nc; ++cl) first[cl] = p.apply_max;
    for (int round = 0; round < p.apply_max && alive && applied < commit;
         ++round) {
      const int32_t val = log_val0[static_cast<int>(
          static_cast<uint32_t>(applied) & static_cast<uint32_t>(cap - 1))];
      const Applied a = apply_entry(p, m, rot, greedy, reshuffle, val);
      viol |= a.viol;
      if (a.q_obs >= 0 && a.seq == clerk_seq0[a.client] &&
          first[a.client] == p.apply_max) {
        first[a.client] = round;
        first_obs[a.client] = a.q_obs;
      }
      applied = wrap_add(applied, 1);
    }
  }
  if (tid == kWalker) {
    const int32_t sh_base = read_row<int32_t>(p, kShadowBase, c, 1)[0];
    const int32_t sh_len = read_row<int32_t>(p, kShadowLen, c, 1)[0];
    const Machine w = machine(p, ws, -1);
    int32_t &frontier = work<int32_t>(p, ws, kWFrontier)[0];
    uint8_t &stalled = work<uint8_t>(p, ws, kWStalled)[0];
    int32_t *q_seq = work<int32_t>(p, ws, kWQSeq);
    int32_t *q_obs = work<int32_t>(p, ws, kWQObs);
    for (int step = 0; step < p.walk_max && frontier < sh_len; ++step) {
      const int pos = static_cast<int>(static_cast<uint32_t>(frontier) &
                                       static_cast<uint32_t>(cap - 1));
      // the entry needed was overwritten by the ring: the walk stops, and
      // the stall is sticky
      if (shadow_abs(sh_base, pos, cap) != wrap_add(frontier, 1)) {
        stalled = 1;
        break;
      }
      const Applied a = apply_entry(p, w, 0, greedy, reshuffle,
                                    ws[p.sh_val + pos]);
      viol |= a.viol;
      if (a.q_obs >= 0) {
        q_seq[a.client] = a.seq;
        q_obs[a.client] = a.q_obs;
      }
      frontier = wrap_add(frontier, 1);
    }
  }
  if (viol) shared_or(ws + p.viol, viol);
}

// Node i's divergence oracle: at the walker's frontier and alive, its
// state machine must equal the walker's bit for bit
__device__ __forceinline__ void diverge(const Params &p, int32_t *ws, int i) {
  const Machine m = machine(p, ws, i), w = machine(p, ws, -1);
  if (!(raft_row(p, ws, kRAlive)[i] &&
        work<int32_t>(p, ws, kApplied)[i] ==
            work<int32_t>(p, ws, kWFrontier)[0]))
    return;
  bool same = *m.cfg_num == *w.cfg_num;
  for (int g = 0; g < p.ng; ++g) same &= m.member[g] == w.member[g];
  for (int s = 0; s < kShards; ++s) same &= m.owner[s] == w.owner[s];
  for (int h = 0; h < p.ncfg; ++h) same &= m.hist[h] == w.hist[h];
  for (int cl = 0; cl < p.nc; ++cl) same &= m.last_seq[cl] == w.last_seq[cl];
  if (!same) shared_or(ws + p.viol, kViolDiverge);
}

// Phase kClerks: the divergence oracle, a node a thread of the first
// warp, and a clerk a thread from kClerk0 on: the Query answer (the
// largest a node gave in the first round any gave one), the ack, the
// query oracle, the metric folds, a fresh op or a retry and its target
__device__ __forceinline__ void clerks(const Params &p, int32_t *ws, int c,
                                       int tid) {
  const int n = p.n, nc = p.nc, ng = p.ng, part = p.partitionable;
  if (tid < n) diverge(p, ws, tid);
  const int cl = tid - kClerk0;
  if (cl < 0 || cl >= nc) return;
  const int32_t t = read_row<int32_t>(p, kTick, c, 1)[0];
  const Ro<float> kf = read_row<float>(p, kKnobF, c, kNF);
  int32_t viol = 0;

  const int32_t cs = in_row<int32_t>(p, kClerkSeq, c)[cl];
  const int32_t kind0 = in_row<int32_t>(p, kClerkKind, c)[cl];
  const bool out0 = in_row<uint8_t>(p, kClerkOut, c)[cl] != 0;
  int32_t obs = work<int32_t>(p, ws, kClerkQObs)[cl];
  if (obs < 0) {
    int round = p.apply_max;
    for (int i = 0; i < n; ++i) {
      const int r = ws[p.first + i * nc + cl];
      const int32_t o = ws[p.first_obs + i * nc + cl];
      if (r < round || (r == round && r < p.apply_max && o > obs)) {
        round = r;
        obs = o;
      }
    }
  }
  const bool in_shadow = ws[p.flag + cl] != 0;
  const bool is_q = kind0 == kQuery;
  const bool ready = obs >= 0 && work<int32_t>(p, ws, kWQSeq)[cl] == cs;
  int32_t sub = 0, app = 0, cmt = 0, apl = 0;
  if (kMetrics) {
    sub = in_row<int32_t>(p, kClerkSub, c)[cl];
    app = in_row<int32_t>(p, kClerkApp, c)[cl];
    cmt = in_row<int32_t>(p, kClerkCmt, c)[cl];
    apl = in_row<int32_t>(p, kClerkApl, c)[cl];
    if (out0 && in_shadow && cmt == 0) cmt = t;
    if (out0 && ready && apl == 0) apl = t;
  }
  const bool newly = out0 && in_shadow && (!is_q || ready);
  const bool done_q = newly && is_q;
  if (done_q && obs != work<int32_t>(p, ws, kWQObs)[cl]) viol |= kViolQuery;
  const int32_t acked = newly ? cs : in_row<int32_t>(p, kClerkAcked, c)[cl];
  bool cout = out0 && !newly;
  const int32_t done = wrap_add(in_row<int32_t>(p, kQueriesDone, c)[cl],
                                done_q);
  if (kMetrics) {
    // the ack's submit->ack latency, its phases (clerk_phase_matrix: the
    // stamps clamped monotone) and its worst-op candidate (key -1)
    const int hb = p.hb;
    const int32_t e2e = wrap_sub(t, sub);
    const int32_t app_e = app > sub ? app : sub;
    const int32_t cmt_e = cmt > app_e ? cmt : app_e;
    const int32_t b3 = is_q ? (apl > cmt_e ? apl : cmt_e) : cmt_e;
    const int32_t ph[kPhases] = {wrap_sub(app_e, sub), wrap_sub(cmt_e, app_e),
                                 wrap_sub(b3, cmt_e), wrap_sub(t, b3)};
    if (newly) {
      shared_add(work<int32_t>(p, ws, kLatHist) + bucket_of(e2e, hb), 1);
      int32_t *phist = work<int32_t>(p, ws, kPhaseHist);
      int32_t *pticks = work<int32_t>(p, ws, kPhaseTicks);
      for (int q = 0; q < kPhases; ++q) {
        shared_add(phist + q * hb + bucket_of(ph[q], hb), 1);
        shared_add(pticks + q, ph[q]);
      }
      shared_add(work<int32_t>(p, ws, kLatTicks), e2e);
    }
    int32_t *x = ws + p.worst + cl * kWorstWords;
    x[0] = newly;
    x[1] = e2e;
    x[2] = -1;
    x[3] = sub;
    for (int q = 0; q < kPhases; ++q) x[4 + q] = ph[q];
  }

  // the draws, from the tick's keys (kStage); each only where its value
  // is used
  uint32_t kk[kDrawKeys][2];
  for (int j = 0; j < kDrawKeys; ++j) {
    kk[j][0] = static_cast<uint32_t>(ws[p.draws + 2 * j]);
    kk[j][1] = static_cast<uint32_t>(ws[p.draws + 2 * j + 1]);
  }
  const bool start =
      !cout && cs < kSeqLim - 1 &&
      madraft::uniform(bits_word(kk[0][0], kk[0][1], cl, nc, part)) < kf[kPOp];
  int32_t kind = kind0, arg = in_row<int32_t>(p, kClerkArg, c)[cl];
  if (start) {
    const float u = madraft::uniform(
        bits_word(kk[7][0], kk[7][1], cl, nc, part));
    const float pq = kf[kPQuery], pm = kf[kPMove];
    const float pqm = fadd(pq, pm);
    // Join / Leave split the residual mass evenly
    kind = u < pq ? kQuery
           : u < pqm ? kMove
           : u < fadd(pqm, fmul(fsub(fsub(1.0f, pq), pm), 0.5f)) ? kJoin
                                                                 : kLeave;
    const int32_t raw = randint_elem(kk[1][0], kk[1][1], cl, nc, 0,
                                     kShards * ng, part);
    if (kind == kQuery) {
      arg = raw % 4 == 0 ? p.arg_lim - 1
                         : randint_elem(kk[4][0], kk[4][1], cl, nc, 0,
                                        p.ncfg + 1, part);
    } else if (kind == kMove) {
      arg = raw;
    } else {
      // a gid set: the first gcnt of the clerk's join_max draws
      const int jm = p.join_max;
      const int32_t cnt = randint_elem(kk[6][0], kk[6][1], cl, nc, 1, jm + 1,
                                       part);
      arg = 0;
      for (int j = 0; j < jm && j < cnt; ++j)
        arg |= 1 << randint_elem(kk[5][0], kk[5][1], cl * jm + j, nc * jm,
                                 0, ng, part);
    }
    obs = -1;
    if (kMetrics) {
      sub = t;
      app = cmt = apl = 0;
    }
  }
  cout = cout || start;
  const bool rt = cout && (start || madraft::uniform(bits_word(
                                        kk[2][0], kk[2][1], cl, nc, part)) <
                                        kf[kPRetry]);
  if (kMetrics) {
    work<int32_t>(p, ws, kClerkSub)[cl] = sub;
    work<int32_t>(p, ws, kClerkApp)[cl] = app;
    work<int32_t>(p, ws, kClerkCmt)[cl] = cmt;
    work<int32_t>(p, ws, kClerkApl)[cl] = apl;
  }
  work<int32_t>(p, ws, kClerkSeq)[cl] = start ? wrap_add(cs, 1) : cs;
  work<uint8_t>(p, ws, kClerkOut)[cl] = cout;
  work<int32_t>(p, ws, kClerkArg)[cl] = arg;
  work<int32_t>(p, ws, kClerkKind)[cl] = kind;
  work<int32_t>(p, ws, kClerkAcked)[cl] = acked;
  work<int32_t>(p, ws, kClerkQObs)[cl] = obs;
  work<int32_t>(p, ws, kQueriesDone)[cl] = done;
  ws[p.target + cl] =
      rt ? randint_elem(kk[3][0], kk[3][1], cl, nc, 0, n, part) : 0;
  ws[p.retry + cl] = rt;
  if (viol) shared_or(ws + p.viol, viol);
}

// Phase kSubmit, one thread: the worst-op register, the violation bits,
// the submits appended at self-believed leaders one clerk after another
// (clerk c's append reads the log_len clerk c - 1 moved), and the raft
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
  if (kMetrics) worst_apply(p, ws, ws + p.worst);
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
        work<int32_t>(p, ws, kClerkArg)[cl],
        work<int32_t>(p, ws, kClerkKind)[cl], p.arg_lim);
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

// Thread tid of cluster c's block in phase `phase` (kSubmit runs on
// thread 0 alone); pl is the staging plan (its copy in shared memory), ws
// the block's region of Params::words words, bar its mbarrier
__device__ __forceinline__ void run_phase(const Params &p, const Plan &pl,
                                          int32_t *ws, uint64_t *bar, int c,
                                          int tid, int phase) {
  switch (phase) {
    case kStage: stage(p, pl, ws, bar, c, tid); break;
    case kRestore: restore(p, ws, c, tid); break;
    case kApply: apply(p, ws, c, tid); break;
    case kClerks: clerks(p, ws, c, tid); break;
    case kSubmit: if (tid == 0) submit(p, ws, c); break;
    default:
      stage::store(pl, reinterpret_cast<const unsigned char *>(ws), c, tid,
                   kThreads);
      break;
  }
}

}  // namespace k10
