// K11's device code: one shardkv service tick of one deployment, in any of
// the three config modes (schedule, live controller, computed controller:
// the template parameter M of the functions whose work differs by mode),
// by the kThreads threads of a block (shardkv.cu holds the kernel, its
// launch and the note on what it replaces, its bound and design). Built
// by nvcc through shardkv.cu, and by g++ through
// tests/shardkv_host_emu.cpp.
//
// The tick runs as eleven phases (Phase), a block barrier after each.
// Within a phase the threads share nothing but commutative updates of the
// block's shared region (atomic add, or, min, max) and rows of device
// memory each thread owns: so the host runs a phase's threads one after
// another, then the next phase, and gets the card's result.
//
// The arithmetic is the plain version's (tpusim/shardkv.py
// _shardkv_service_tick), written per deployment: int32 values that may
// wrap are computed in uint32 (signed overflow is undefined in C++), log
// values unpack with floor division and modulo, as Python's // and %, and
// the float32 sums and products go through fadd / fmul (no contraction
// into an FMA); the Zipf map's powf is the card's (no fast math).

#pragma once

#include <cmath>
#include <cstdint>

#include "ctrler.cuh"  // k10::rebalance, the computed controller's apply
#include "stage.cuh"
#include "threefry.cuh"

namespace k11 {

#ifdef MADRAFT_K11_METRICS
constexpr bool kMetrics = true;
#else
constexpr bool kMetrics = false;
#endif

// A deployment's block: four warps (three took 6% longer); three for
// K11-metrics, whose folds spill at the 64 registers that eight blocks of
// four warps leave a thread
constexpr int kThreads = kMetrics ? 96 : 128;
constexpr int kWalker = kThreads - 1;     // the truth walker's and the
                                          // controller walker's thread; the
                                          // appliers stride the others
static_assert(kThreads >= 64 && kThreads % 32 == 0, "two warps or more");
constexpr int kMaxGroups = 8;
constexpr int kMaxNodes = 16;
constexpr int kMaxCap = 256;
constexpr int kMaxShards = 32;
constexpr int kMaxClients = 32;  // a clerk a thread in kClerks
constexpr int kMaxConfigs = 64;
constexpr int kPhases = 5;       // config.SHARDKV_PHASES
constexpr int kQueueSlots = 8;   // config.OPEN_QUEUE_SLOTS
constexpr int32_t kSeqLim = 1 << 13;
constexpr int32_t kLeader = 2;
constexpr int32_t kNoop = 1 << 30;  // config.NOOP_CMD
constexpr int32_t kBig = 1 << 30;
constexpr int kAppend = 0, kConfig = 1, kInstall = 2, kDelete = 3, kGet = 4,
              kPut = 5;
constexpr int32_t kAbsent = 0, kOwned = 1, kPulling = 2, kFrozen = 3;
constexpr int32_t kViolDiverge = 64, kViolOwnership = 128,
                  kViolStorage = 256, kViolStaleRead = 1024,
                  kViolCtrlStale = 32768;
constexpr uint32_t kSitePull = 17, kSiteClerk = 18, kSiteNet = 20,
                   kSiteAnn = 22;
// The config modes (kernels/shardkv.py mode): the pre-drawn schedule, the
// live controller (announces through a controller raft cluster), the
// computed controller (the 4A rebalance over committed flips)
enum Mode { kSchedule, kLive, kComputed };
constexpr uint32_t kHashW = 1000003u;

// The leaves K11 writes: the service leaves every mode's tick changes, in
// ShardKvState order, the controller modes' service leaves, the group
// raft leaves it writes, then the controller cluster's (kernels/shardkv.py
// LEAVES). A leaf the mode leaves alone has count 0: nothing of it is
// staged, read or written
enum Leaf {
  kNodeSrc, kSnapSrc, kApplied, kNodeCfg, kPhase, kKeyHash, kKeyCount,
  kLastSeq, kSnapCfg, kSnapPhase, kSnapHash, kSnapCount, kSnapLastSeq,
  kStagedCfg, kStagedHash, kStagedCount, kStagedLastSeq, kPullReqT,
  kPullReqCfg, kPullRspT, kPullRspCfg, kPullRspHash, kPullRspCount,
  kPullRspLastSeq, kGcqReqT, kGcqReqCfg, kGcqRspT, kGcqRspCfg, kClerkSeq,
  kClerkOut, kClerkShard, kClerkKind, kClerkCfg, kClerkWrong, kClerkAcked,
  kClerkGetLo, kClerkGetObs, kGetsDone, kOpenArr, kOpenSrv, kOpenDrop,
  kOpenStamp, kClerkSub, kLatHist, kClerkApp, kClerkCmt, kClerkApl,
  kClerkMig, kClientRetries, kPhaseHist, kPhaseTicks, kLatTicks, kWorstLat,
  kWorstPhases, kWorstKey, kWorstClient, kWorstSub, kKeyLatHist,
  kClientLatHist, kWFrontier, kWCfg, kWPhase, kWHash, kWCount, kWLastSeq,
  kFrzCfg, kFrzHash, kFrzCount, kFrzLastSeq, kTruthCount, kWClerkAcked,
  kInstallsDone, kDeletesDone, kMaxCfgLag, kViolations, kFirstViolation,
  kCtrlWFrontier, kCtrlWStalled, kWinVar, kSlotTick, kCmem, kCtrlNodeOwner,
  kCtrlMaps, kCfgOwnerW, kWSrc, kCqReqT, kCqReqNode, kCqReqJ, kCqRspT,
  kCqRspJ, kCqRspFound, kCqRspVar,
  kLogTerm, kLogVal, kLogLen, kDurableLen, kCompactFloor,
  kCLogTerm, kCLogVal, kCLogLen, kCDurableLen,
  kLeaves
};

// The read-only inputs: the stepped group rafts' leaves, the stepped
// controller cluster's, the pre-tick views, the schedule, the flip
// schedule, the keys and the knob table (kernels/shardkv.py READS)
enum Read {
  kTick, kTerm, kRole, kAlive, kBase, kCommit, kSnapInst, kShadowVal,
  kShadowBase, kShadowLen, kCTerm, kCRole, kCAlive, kCBase, kCCommit,
  kCShadowVal, kCShadowBase, kCShadowLen, kPreAlive, kPreBase, kCfgTick,
  kCfgOwner, kFlipA, kFlipB, kKeys, kKnobF, kKnobI,
  kReads
};

// The knob table's columns (kernels/shardkv.py KNOB_F32 / KNOB_I32)
enum KnobF { kPOp, kPGet, kPPut, kPRetry, kPCfgLearn, kPPull, kPAck,
             kPullLoss, kOpenRate, kZipfA, kPAnnounce, kPPhantom, kNF };
enum KnobI { kDelayMin, kDelayMax, kBugSkipFreeze, kBugDropDup,
             kBugServeFrozen, kRequery, kQueueCap, kBugStaleCtrl,
             kBugRotate, kFlowCap, kNI };

// The wrapper's descriptor (kernels/shardkv.py _launch): this header, the
// kReads pointers, then 4 words a leaf (in, out, count a deployment, bytes
// an element)
enum Desc {
  kB, kG, kN, kCap, kNs, kNc, kNcfg, kApplyMax, kWalkMax, kHb,
  kPartitionable, kMetricsOn, kModeOf,
  kHeader
};

// The phases of a tick, in order (run_phase)
enum Phase { kStage, kCtrlWalk, kCtrlApply, kRestore, kApply, kOracle,
             kMailbox, kClerks, kAppendLog, kLanded, kWriteBack, kTickPhases };

// The tick's draw keys (fold_in(deployment key, t), then a site and a
// split): kp 0-3 (site 17, four), knet 0-3 (site 20, the first four of
// six), kc 0-5 (site 18, six), and in a controller mode knet 4-5 (the
// Query hops) and ka 0-5 (site 22, six: the announcers and the Query
// targets)
constexpr int kKp = 0, kKnet = 4, kKc = 8, kKnetQ = 14, kKa = 16,
              kDrawKeys = 22;

// A worst-op candidate's words in the block's region: mask, lat, key, sub,
// then the kPhases phases
constexpr int kWorstWords = 4 + kPhases;

// A clerk's draws, hashed ahead by the threads kApply leaves idle: the
// split kKc + k for each (the learn word, the start word, the shard, the
// retry word, the target, the kind word)
constexpr int kClerkDraws = 6;

// The stepped raft rows the tick reads by (group, node), staged in the
// block's region (alive as 0 / 1)
enum RaftRow { kRTerm, kRRole, kRAlive, kRBase, kRCommit, kRSnapInst,
               kRPreAlive, kRPreBase, kRaftRows };

// A leaf: its input and output, its count of elements a deployment, its
// bytes an element, and its row's offset in words in the block's region
// (-1 for a log row: see Params)
struct LeafRef {
  const void *in;
  void *out;
  int count, bytes, off;
};

using Plan = stage::Plan<kLeaves>;

// The staging plan's copy in shared memory, before the block's region
constexpr int kPlanBytes = (static_cast<int>(sizeof(Plan)) + 15) / 16 * 16;

// The block's shared region, in int32 words: every leaf but the log rows
// staged at its off (a bulk row's a multiple of 4; the log rows stay in
// device memory: the tick reads G * n * apply_max of their slots and
// appends a few), then the tick's scratch
struct Params {
  LeafRef leaf[kLeaves];
  Plan plan;       // the staged rows' copies (stage.cuh)
  const void *read[kReads];
  int b, g, n, cap, ns, nc, ncfg, apply_max, walk_max, hb, partitionable;
  int mode;        // Mode
  int src_lim;     // a CONFIG payload's source range: n computed, else 2
  int viol;        // the tick's violation bits
  int owner;       // [ncfg, ns] the owner maps: the schedule's (staged from
                   // the input), or in computed mode the cfg_owner leaf's
                   // staged row, which the controller's resolution writes
  int view;        // the controller's view of the latest config: the
                   // schedule's active config, or the controller's
                   // committed frontier
  int cfound;      // computed mode: a slot resolved this tick
  int cflip;       // its committed flip's gid
  int cmem;        // the member mask after it (bit g: group g)
  int cslot;       // the slot it resolved (resolved + 1, clipped)
  int ann;         // [4] the announcers' draws: truth submits, its
                   // target, phantom submits, its target
  int adopt;       // [g] the source a group's CONFIG append adopts
  int raft;        // [kRaftRows, g * n] the stepped raft rows (RaftRow)
  int first;       // [g * n, nc] the apply round an applier answered the
                   // clerk's Get (apply_max when none)
  int first_obs;   // [g * n, nc] its answer then
  int lead;        // [g] the leader view's node
  int lead_any;    // [g] the group has an alive leader
  int can_adv;     // [g] the leader appends the next CONFIG
  int want_pull;   // [g, ns] the leader pulls the shard
  int ack_del;     // [g, ns] a GC confirm arrived: the leader appends DELETE
  int frz_epoch;   // [g, ns] the leader view's freeze epoch
  int target;      // [nc] the node the clerk contacts
  int grp;         // [nc] the group the clerk believes owns its shard
  int retry;       // [nc] the clerk submits
  int landed;      // [nc] its submit landed at a leader
  int worst;       // [2, nc, kWorstWords] the acks' and the local serves'
                   // worst-op candidates
  int draws;       // [kDrawKeys, 2] the tick's draw keys
  int cdraw;       // [nc, kClerkDraws] the clerks' draws
  int sh_val;      // [g, cap] the groups' shadow windows
  int sh_pos;      // [2, g] their bases, then their lengths
  int csh_val;     // [cap] the controller's shadow window (controller
                   // modes)
  int lag;         // the restore's largest config lag of a restarting node
  int q_above;     // [g] the committed announces above the queried node's
                   // commit (controller modes)
  int q_amin;      // [g] the queried node's first log index of the asked
                   // announce (the stale-read bug)
  bool log_quads;  // the log rows move in 16-byte quads
  int words;       // the region's size
};

template <typename T>
inline T *ptr_of(int64_t w) {
  return reinterpret_cast<T *>(static_cast<intptr_t>(w));
}

inline bool set_params(Params &p, const int64_t *d, int n_desc) {
  constexpr int kWords = int(kHeader) + int(kReads) + 4 * int(kLeaves);
  if (n_desc != kWords) return false;
  p.b = static_cast<int>(d[kB]);
  p.g = static_cast<int>(d[kG]);
  p.n = static_cast<int>(d[kN]);
  p.cap = static_cast<int>(d[kCap]);
  p.ns = static_cast<int>(d[kNs]);
  p.nc = static_cast<int>(d[kNc]);
  p.ncfg = static_cast<int>(d[kNcfg]);
  p.apply_max = static_cast<int>(d[kApplyMax]);
  p.walk_max = static_cast<int>(d[kWalkMax]);
  p.hb = static_cast<int>(d[kHb]);
  p.partitionable = static_cast<int>(d[kPartitionable]);
  p.mode = static_cast<int>(d[kModeOf]);
  p.src_lim = p.mode == kComputed ? p.n : 2;
  if (p.mode < kSchedule || p.mode > kComputed ||
      (p.mode == kComputed && (p.ns != k10::kShards || p.g > k10::kMaxGids)))
    return false;
  if (p.b < 1 || p.g < 1 || p.g > kMaxGroups || p.n < 1 ||
      p.n > kMaxNodes || p.cap < 1 || p.cap > kMaxCap ||
      (p.cap & (p.cap - 1)) || p.ns < 1 || p.ns > kMaxShards || p.nc < 1 ||
      p.nc > kMaxClients || p.ncfg < 1 || p.ncfg > kMaxConfigs ||
      p.apply_max < 0 || p.walk_max < 0 ||
      (d[kMetricsOn] != 0) != kMetrics)
    return false;
  if (kMetrics && (p.hb < 1 || p.hb > 31)) return false;
  for (int r = 0; r < kReads; ++r)
    p.read[r] = ptr_of<const void>(d[kHeader + r]);
  int words = 0;
  stage::Row rows[kLeaves];
  int n_rows = 0;
  p.log_quads = true;
  for (int l = 0; l < kLeaves; ++l) {
    const int64_t *q = d + kHeader + kReads + 4 * l;
    const bool log_row =
        l == kLogTerm || l == kLogVal || l == kCLogTerm || l == kCLogVal;
    LeafRef &x = p.leaf[l];
    x = {ptr_of<const void>(q[0]), ptr_of<void>(q[1]),
         static_cast<int>(q[2]), static_cast<int>(q[3]), -1};
    if (x.bytes != 1 && x.bytes != 4) return false;
    if (x.count < 0 || x.count > (1 << 16)) return false;
    if (log_row) {
      // quads where every log row the mode writes is 16-byte rows at
      // aligned ends
      if (x.count)
        p.log_quads = p.log_quads && x.count % 4 == 0 &&
                      (reinterpret_cast<uintptr_t>(x.in) |
                       reinterpret_cast<uintptr_t>(x.out)) % 16 == 0;
      continue;
    }
    if (stage::bulk(x.in, x.out, x.count, x.bytes)) words = (words + 3) & ~3;
    x.off = words;
    rows[n_rows++] = {x.in, x.out, x.count, x.bytes, 4 * x.off, 0};
    words += (x.count * x.bytes + 3) / 4;
  }
  if (!stage::plan(p.plan, rows, n_rows)) return false;
  const int gn = p.g * p.n, gs = p.g * p.ns;
  // a controller leaf is written in its modes and only there
  for (int l = kCtrlWFrontier; l <= kCqRspVar; ++l) {
    const bool computed_only = l == kSlotTick || l == kCmem ||
                               l == kCtrlNodeOwner || l == kCtrlMaps ||
                               l == kCfgOwnerW || l == kWSrc;
    const bool on = p.mode == kComputed ||
                    (p.mode == kLive && !computed_only);
    if ((p.leaf[l].count != 0) != on) return false;
  }
  for (int l = kCLogTerm; l <= kCDurableLen; ++l)
    if ((p.leaf[l].count != 0) != (p.mode != kSchedule)) return false;
  if (p.mode == kComputed &&
      (p.leaf[kCfgOwnerW].count != p.ncfg * p.ns ||
       p.leaf[kCtrlMaps].count != p.n * p.ncfg * p.ns))
    return false;
  p.viol = words;
  p.owner = p.mode == kComputed ? p.leaf[kCfgOwnerW].off : p.viol + 1;
  p.view = p.viol + 1 + p.ncfg * p.ns;
  p.cfound = p.view + 1;
  p.cflip = p.cfound + 1;
  p.cmem = p.cflip + 1;
  p.cslot = p.cmem + 1;
  p.ann = p.cslot + 1;
  p.adopt = p.ann + 4;
  p.raft = p.adopt + p.g;
  p.first = p.raft + kRaftRows * gn;
  p.first_obs = p.first + gn * p.nc;
  p.lead = p.first_obs + gn * p.nc;
  p.lead_any = p.lead + p.g;
  p.can_adv = p.lead_any + p.g;
  p.want_pull = p.can_adv + p.g;
  p.ack_del = p.want_pull + gs;
  p.frz_epoch = p.ack_del + gs;
  p.target = p.frz_epoch + gs;
  p.grp = p.target + p.nc;
  p.retry = p.grp + p.nc;
  p.landed = p.retry + p.nc;
  p.worst = p.landed + p.nc;
  p.draws = p.worst + 2 * p.nc * kWorstWords;
  p.cdraw = p.draws + 2 * kDrawKeys;
  p.sh_val = p.cdraw + p.nc * kClerkDraws;
  p.sh_pos = p.sh_val + p.g * p.cap;
  p.csh_val = p.sh_pos + 2 * p.g;
  p.lag = p.csh_val + p.cap;
  p.q_above = p.lag + 1;
  p.q_amin = p.q_above + p.g;
  p.words = p.q_amin + p.g;
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

__device__ __forceinline__ int32_t clampi(int32_t x, int32_t lo, int32_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
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

__device__ __forceinline__ void shared_min(int32_t *a, int32_t v) {
#ifdef __CUDA_ARCH__
  atomicMin(a, v);
#else
  *a = v < *a ? v : *a;
#endif
}

__device__ __forceinline__ void shared_max(int32_t *a, int32_t v) {
#ifdef __CUDA_ARCH__
  atomicMax(a, v);
#else
  *a = v > *a ? v : *a;
#endif
}

// A log value's fields (shardkv.py _unpack), client clipped; a CONFIG's
// payload is cfg_c * src_lim + var
struct Entry {
  int32_t kind, client, seq, shard, cfg_c, cfg_i, var;
};

__device__ __forceinline__ Entry unpack(int32_t val, int ns, int nc,
                                        int src_lim) {
  const int32_t v = wrap_sub(val, 1);
  Entry e;
  e.kind = floor_mod(v, 8);
  const int32_t payload = floor_div(v, 8);
  e.shard = floor_mod(payload, ns);
  const int32_t cs = floor_div(payload, ns);
  e.client = clampi(floor_div(cs, kSeqLim), 0, nc - 1);
  e.seq = floor_mod(cs, kSeqLim);
  e.cfg_c = floor_div(payload, src_lim);
  e.var = floor_mod(payload, src_lim);
  e.cfg_i = floor_div(payload, ns);
  return e;
}

__device__ __forceinline__ int32_t pack_op(int32_t client, int32_t seq,
                                           int32_t shard, int32_t kind,
                                           int ns) {
  uint32_t v = static_cast<uint32_t>(client) * kSeqLim +
               static_cast<uint32_t>(seq);
  v = v * static_cast<uint32_t>(ns) + static_cast<uint32_t>(shard);
  return static_cast<int32_t>(v * 8u + static_cast<uint32_t>(kind) + 1u);
}

// CONFIG (cfg_idx, adopted source `shard`: payload cfg_idx * src_lim +
// source), INSTALL and DELETE (cfg_idx, shard)
__device__ __forceinline__ int32_t pack_marker(int32_t cfg_idx, int32_t shard,
                                               int32_t kind, int ns,
                                               int src_lim) {
  const uint32_t payload =
      kind == kConfig ? static_cast<uint32_t>(cfg_idx) * src_lim +
                            static_cast<uint32_t>(shard)
                      : static_cast<uint32_t>(cfg_idx) * ns +
                            static_cast<uint32_t>(shard);
  return static_cast<int32_t>(payload * 8u + static_cast<uint32_t>(kind) +
                              1u);
}

// The metrics plane's bucket of a latency: the edges 2^k (k = 1 .. hb-1)
// at or below it
__device__ __forceinline__ int bucket_of(int32_t lat, int hb) {
  int k = 0;
  for (int e = 1; e < hb; ++e) k += lat >= (1 << e);
  return k;
}

// config.zipf_map of one draw: floor(ns * ((d + 0.5) / ns) ** a), clipped;
// a == 1 is the identity
__device__ __forceinline__ int32_t zipf_map(int32_t draw, int ns, float a) {
  if (a == 1.0f) return draw;
  const float nf = static_cast<float>(ns);
  const float u = fdiv(fadd(static_cast<float>(draw), 0.5f), nf);
  const float y = floorf(fmul(nf, powf(u, a)));
  return clampi(static_cast<int32_t>(y), 0, ns - 1);
}

// The absolute log index of shadow lane i: the window's lanes hold
// base + 1 .. base + cap, lane i the one congruent to it mod cap
__device__ __forceinline__ int32_t shadow_abs(int32_t base, int i, int cap) {
  return base + static_cast<int32_t>(static_cast<uint32_t>(i - base) &
                                     static_cast<uint32_t>(cap - 1)) + 1;
}

__device__ __forceinline__ int slot_of(int32_t abs_idx, int cap) {
  return static_cast<int>(static_cast<uint32_t>(abs_idx - 1) &
                          static_cast<uint32_t>(cap - 1));
}

// ------------------------------------------------------------- the draws
// The hashes behind the tick's draws, each compiled once and called (a
// block runs the kernel's code once, so its time goes with the code's
// size)
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
// read-only cache; in K6-shardkv (MADRAFT_STAGE_IN_PLACE) the launch
// rewrites them every tick, so they are plain loads
template <typename T>
__device__ __forceinline__ T ld(const T *x) {
#if defined(__CUDA_ARCH__) && !defined(MADRAFT_STAGE_IN_PLACE)
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

// A staged raft row (RaftRow) in the block's region ws, [g * n]
__device__ __forceinline__ const int32_t *raft_row(const Params &p,
                                                   const int32_t *ws, int r) {
  return ws + p.raft + r * p.g * p.n;
}

__device__ __forceinline__ int32_t tick_of(const Params &p, int c) {
  return read_row<int32_t>(p, kTick, c, p.g)[0];
}

// The schedule's owner of shard s at config j, j clipped to the schedule
__device__ __forceinline__ int32_t owner_at(const Params &p,
                                            const int32_t *ws, int32_t j,
                                            int s) {
  return ws[p.owner + clampi(j, 0, p.ncfg - 1) * p.ns + s];
}

// Replica src's computed owner map of config j at shard s (shardkv.py
// _map_at; src and j clipped), from the staged write-once history
__device__ __forceinline__ int32_t map_at(const Params &p, const int32_t *ws,
                                          int32_t src, int32_t j, int s) {
  return ws[p.leaf[kCtrlMaps].off +
            (clampi(src, 0, p.n - 1) * p.ncfg + clampi(j, 0, p.ncfg - 1)) *
                p.ns +
            s];
}

// The owner of shard s a CONFIG(cfg_c) from source var installs, and the
// one before it (the adopter's previous config prev_cfg from source
// prev_src): the adopted replica's maps in computed mode, else the
// schedule's rows cfg_c and cfg_c - 1
template <int M>
__device__ __forceinline__ int32_t new_owner(const Params &p,
                                             const int32_t *ws, int32_t var,
                                             int32_t cfg_c, int s) {
  return M == kComputed ? map_at(p, ws, var, cfg_c, s)
                        : owner_at(p, ws, cfg_c, s);
}

template <int M>
__device__ __forceinline__ int32_t prev_owner(const Params &p,
                                              const int32_t *ws,
                                              int32_t prev_src,
                                              int32_t prev_cfg, int32_t cfg_c,
                                              int s) {
  return M == kComputed ? map_at(p, ws, prev_src, prev_cfg, s)
                        : owner_at(p, ws, wrap_sub(cfg_c, 1), s);
}

// The latest config c <= view whose adoption moved shard s away from
// group g (shardkv.py _freeze_epoch); 0 when none
__device__ __forceinline__ int32_t freeze_epoch(const Params &p,
                                                const int32_t *ws, int g,
                                                int32_t view, int s) {
  int32_t best = 0;
  for (int c = 1; c < p.ncfg; ++c)
    if (c <= view && ws[p.owner + (c - 1) * p.ns + s] == g &&
        ws[p.owner + c * p.ns + s] != g)
      best = c;
  return best;
}

// The active config of the controller's schedule at tick t
__device__ __forceinline__ int32_t active_cfg(const Params &p, int c,
                                              int32_t t) {
  const Ro<int32_t> cfg_tick = read_row<int32_t>(p, kCfgTick, c, p.ncfg);
  int32_t k = 0;
  for (int j = 0; j < p.ncfg; ++j) k += cfg_tick[j] <= t;
  return k - 1;
}

// Word i of the draw stream j's bits over `total` words
__device__ __forceinline__ uint32_t draw_word(const Params &p,
                                              const int32_t *ws, int j, int i,
                                              int total) {
  return bits_word(static_cast<uint32_t>(ws[p.draws + 2 * j]),
                   static_cast<uint32_t>(ws[p.draws + 2 * j + 1]), i, total,
                   p.partitionable);
}

__device__ __forceinline__ int32_t draw_randint(const Params &p,
                                                const int32_t *ws, int j,
                                                int i, int size,
                                                int32_t minval,
                                                int32_t maxval) {
  return randint_elem(static_cast<uint32_t>(ws[p.draws + 2 * j]),
                      static_cast<uint32_t>(ws[p.draws + 2 * j + 1]), i,
                      size, minval, maxval, p.partitionable);
}

// (delay, lost) of an inter-group send from its word (shardkv.py
// _net_pair): loss from the top 24 bits, delay from the low byte
__device__ __forceinline__ bool net_lost(const Params &p, int c,
                                         uint32_t w) {
  const float loss = read_row<float>(p, kKnobF, c, kNF)[kPullLoss];
  return fmul(static_cast<float>(w >> 8), 5.9604644775390625e-08f) < loss;
}

__device__ __forceinline__ int32_t net_delay(const Params &p, int c,
                                             uint32_t w) {
  const Ro<int32_t> ki = read_row<int32_t>(p, kKnobI, c, kNI);
  const int32_t lo = ki[kDelayMin];
  int32_t span = ki[kDelayMax] + 1 - lo;
  span = span > 1 ? span : 1;
  return lo + static_cast<int32_t>((w & 0xFFu) % static_cast<uint32_t>(span));
}

// ------------------------------------------------------- the service tick
// Phase kStage: every leaf's row from its input into the block's region
// by the staging plan (stage.cuh), the groups' shadow windows (and in a
// controller mode the controller's) and the schedule's owner maps by
// cp.async words, the controller's log rows straight to their outputs,
// the stepped
// raft rows, the shadows' bases and lengths and the tick's draw keys, the
// scratch set; then the wait for the copies. The tick then updates the
// region, and reads pre-tick values from the inputs where a cell's value
// may already have changed in the phase that reads it.
template <int M>
__device__ __forceinline__ void stage(const Params &p, const Plan &pl,
                                      int32_t *ws, uint64_t *bar, int c,
                                      int tid) {
  const int gn = p.g * p.n;
  stage::load(pl, reinterpret_cast<unsigned char *>(ws), bar, c, tid,
              kThreads);
  const int32_t *sv = static_cast<const int32_t *>(p.read[kShadowVal]) +
                      static_cast<int64_t>(c) * p.g * p.cap;
  for (int x = tid; x < p.g * p.cap; x += kThreads)
    stage::word_load(ws + p.sh_val + x, sv + x);
  if (M != kSchedule) {
    const int32_t *cv = static_cast<const int32_t *>(p.read[kCShadowVal]) +
                        static_cast<int64_t>(c) * p.cap;
    for (int x = tid; x < p.cap; x += kThreads)
      stage::word_load(ws + p.csh_val + x, cv + x);
  }
  // the schedule's owner maps (in computed mode the cfg_owner leaf's row,
  // staged with the leaves)
  if (M != kComputed) {
    const int32_t *own = static_cast<const int32_t *>(p.read[kCfgOwner]) +
                         static_cast<int64_t>(c) * p.ncfg * p.ns;
    for (int x = tid; x < p.ncfg * p.ns; x += kThreads)
      stage::word_load(ws + p.owner + x, own + x);
  }
  // the controller's log rows (the announcers append to them in
  // kCtrlApply; the groups' move in kApply)
  if (M != kSchedule)
    for (int l = kCLogTerm; l <= kCLogVal; ++l)
      stage::copy_row(p.leaf[l].in, p.leaf[l].out, p.leaf[l].count, c,
                      p.log_quads, tid, kThreads);
  // the tick's keys, a key a thread while the copies are in flight (the
  // controller's only in a controller mode)
  if (tid < (M != kSchedule ? kDrawKeys : kKnetQ)) {
    const Ro<uint32_t> key = read_row<uint32_t>(p, kKeys, c, 4);
    uint32_t k0 = key[0], k1 = key[2];  // the int64 words' low halves
    fold_in(k0, k1, static_cast<uint32_t>(tick_of(p, c)));
    const uint32_t site = tid < kKnet    ? kSitePull
                          : tid < kKc    ? kSiteNet
                          : tid < kKnetQ ? kSiteClerk
                          : tid < kKa    ? kSiteNet
                                         : kSiteAnn;
    const int num = tid < kKnet ? 4 : 6;
    const int j = tid < kKnet    ? tid
                  : tid < kKc    ? tid - kKnet
                  : tid < kKnetQ ? tid - kKc
                  : tid < kKa    ? tid - kKnetQ + 4
                                 : tid - kKa;
    fold_in(k0, k1, site);
    uint32_t d0, d1;
    split_key(k0, k1, num, j, p.partitionable, d0, d1);
    ws[p.draws + 2 * tid] = static_cast<int32_t>(d0);
    ws[p.draws + 2 * tid + 1] = static_cast<int32_t>(d1);
  }
  for (int x = tid; x < gn; x += kThreads) {
    ws[p.raft + kRTerm * gn + x] = read_row<int32_t>(p, kTerm, c, gn)[x];
    ws[p.raft + kRRole * gn + x] = read_row<int32_t>(p, kRole, c, gn)[x];
    ws[p.raft + kRAlive * gn + x] = read_row<uint8_t>(p, kAlive, c, gn)[x] != 0;
    ws[p.raft + kRBase * gn + x] = read_row<int32_t>(p, kBase, c, gn)[x];
    ws[p.raft + kRCommit * gn + x] = read_row<int32_t>(p, kCommit, c, gn)[x];
    ws[p.raft + kRSnapInst * gn + x] =
        read_row<int32_t>(p, kSnapInst, c, gn)[x];
    ws[p.raft + kRPreAlive * gn + x] =
        read_row<uint8_t>(p, kPreAlive, c, gn)[x] != 0;
    ws[p.raft + kRPreBase * gn + x] = read_row<int32_t>(p, kPreBase, c, gn)[x];
  }
  for (int g = tid; g < p.g; g += kThreads) {
    ws[p.sh_pos + g] = read_row<int32_t>(p, kShadowBase, c, p.g)[g];
    ws[p.sh_pos + p.g + g] = read_row<int32_t>(p, kShadowLen, c, p.g)[g];
    ws[p.q_above + g] = 0;
    ws[p.q_amin + g] = kBig;
  }
  for (int x = tid; x < gn * p.nc; x += kThreads)
    ws[p.first + x] = p.apply_max;
  for (int cl = tid; cl < p.nc; cl += kThreads) ws[p.landed + cl] = 0;
  if (tid == 0) {
    ws[p.viol] = 0;
    ws[p.lag] = INT32_MIN;
  }
  stage::wait(bar, pl.bulk_bytes);
}

// ------------------------------------------------------- the controller
// The resolved prefix of win_var, less one: the controller's committed
// frontier (announces resolve in slot order)
__device__ __forceinline__ int32_t resolved_prefix(const Params &p,
                                                   const int32_t *win_var) {
  int32_t k = 0;
  while (k < p.ncfg && win_var[k] >= 0) ++k;
  return k - 1;
}

// Phase kCtrlWalk. In schedule mode thread 0 sets the view, the
// schedule's active config. In a controller mode thread kWalker runs the
// controller walker's walk_max steps over the stepped controller
// cluster's staged commit shadow, with the sticky stall (the entry it
// needs slid out of the shadow window): live, the first committed
// announce of a config sets its variant; computed, the one flip that
// resolves the next slot (at most one a tick) is found and the canonical
// member mask flipped (never emptied); the view is then the committed
// frontier. A step that cannot walk leaves the walker as it was, so the
// walk stops there. Threads 0-3 draw the announcers' submits and targets.
template <int M>
__device__ __forceinline__ void ctrl_walk(const Params &p, int32_t *ws, int c,
                                          int tid) {
  if (M == kSchedule) {
    if (tid == 0) ws[p.view] = active_cfg(p, c, tick_of(p, c));
    return;
  }
  const int cap = p.cap;
  if (tid < 4) {
    const int k = kKa + tid;
    const uint32_t k0 = static_cast<uint32_t>(ws[p.draws + 2 * k]);
    const uint32_t k1 = static_cast<uint32_t>(ws[p.draws + 2 * k + 1]);
    const Ro<float> kf = read_row<float>(p, kKnobF, c, kNF);
    ws[p.ann + tid] =
        tid % 2 == 0
            ? madraft::uniform(bits_word(k0, k1, 0, 1, p.partitionable)) <
                  kf[tid == 0 ? kPAnnounce : kPPhantom]
            : randint_elem(k0, k1, 0, 1, 0, p.n, p.partitionable);
  }
  if (tid != kWalker) return;
  const int32_t *sval = ws + p.csh_val;
  const int32_t sbase = read_row<int32_t>(p, kCShadowBase, c, 1)[0];
  const int32_t slen = read_row<int32_t>(p, kCShadowLen, c, 1)[0];
  int32_t &frontier = work<int32_t>(p, ws, kCtrlWFrontier)[0];
  uint8_t &stalled = work<uint8_t>(p, ws, kCtrlWStalled)[0];
  int32_t *win_var = work<int32_t>(p, ws, kWinVar);
  const int32_t resolved = resolved_prefix(p, win_var);
  bool found = false;
  int32_t flip = 0;
  for (int step = 0; step < p.walk_max; ++step) {
    const int32_t f1 = wrap_add(frontier, 1);
    const int pos = slot_of(f1, cap);
    const bool in_win = shadow_abs(sbase, pos, cap) == f1;
    bool canw = frontier < slen;
    if (canw && !in_win) stalled = 1;
    canw = canw && in_win;
    if (!canw) break;
    const int32_t val = sval[pos];
    const bool is_op = val > 0 && val != kNoop;
    const int32_t v1 = wrap_sub(val, 1);
    if (M == kLive) {
      const int32_t aj = clampi(floor_div(v1, 2), 0, p.ncfg - 1);
      if (is_op && win_var[aj] < 0) win_var[aj] = floor_mod(v1, 2);
    } else if (is_op && !found && floor_div(v1, p.g) == resolved + 1 &&
               resolved + 1 < p.ncfg) {
      flip = clampi(floor_mod(v1, p.g), 0, p.g - 1);
      found = true;
    }
    frontier = f1;
  }
  if (M == kLive) {
    ws[p.view] = resolved_prefix(p, win_var);
    return;
  }
  const uint8_t *cmem = work<uint8_t>(p, ws, kCmem);
  uint32_t mem = 0;
  for (int g = 0; g < p.g; ++g)
    mem |= static_cast<uint32_t>(cmem[g] != 0) << g;
  uint32_t flipped = mem ^ (1u << flip);
  if (flipped == 0) flipped = mem;
  ws[p.cfound] = found;
  ws[p.cflip] = flip;
  ws[p.cmem] = static_cast<int32_t>(found ? flipped : mem);
  ws[p.cslot] = clampi(resolved + 1, 0, p.ncfg - 1);
  ws[p.view] = found ? resolved + 1 : resolved;
}

// Phase kCtrlApply, a controller node a thread (controller modes).
// Computed mode, when a slot resolved: replica i's 4A rebalance of its
// own owner chain under the new member mask, its ties rotated by i under
// bug_rotate_tiebreak (k10::rebalance, in registers), into its chain and
// its write-once map of the slot; replica 0's is the canonical config
// (cfg_owner), and thread 0 records the slot's flip, tick and the member
// mask. Then node i's
// announcer appends, the truth's proposal then the phantom's for the slot
// after the view (live: ANNOUNCE(j, variant); computed: FLIP(j, gid),
// the two competing flips), each where node i is its target, an alive
// leader, with room, into the controller's log rows in device memory.
template <int M>
__device__ __forceinline__ void ctrl_apply(const Params &p, int32_t *ws,
                                           int c, int tid) {
  if (M == kSchedule || tid >= p.n) return;
  const int i = tid, cap = p.cap, ns = p.ns;
  const int32_t t = tick_of(p, c);
  const Ro<int32_t> ki = read_row<int32_t>(p, kKnobI, c, kNI);
  if (M == kComputed && ws[p.cfound]) {
    int32_t *own = work<int32_t>(p, ws, kCtrlNodeOwner) + i * ns;
    const uint32_t mem = static_cast<uint32_t>(ws[p.cmem]);
    const uint64_t out =
        k10::rebalance(p.g, mem, k10::loads_of(p.g, mem, own),
                       ki[kBugRotate] ? i : 0, false, false);
    const int slot = ws[p.cslot];
    int32_t *map = work<int32_t>(p, ws, kCtrlMaps) + (i * p.ncfg + slot) * ns;
    for (int s = 0; s < ns; ++s) own[s] = map[s] = k10::nib(out, s) - 1;
    if (i == 0) {
      for (int s = 0; s < ns; ++s) ws[p.owner + slot * ns + s] = own[s];
      work<int32_t>(p, ws, kWinVar)[slot] = ws[p.cflip];
      work<int32_t>(p, ws, kSlotTick)[slot] = t;
      uint8_t *cmem = work<uint8_t>(p, ws, kCmem);
      for (int g = 0; g < p.g; ++g) cmem[g] = (ws[p.cmem] >> g) & 1;
    }
  }
  const int32_t view = ws[p.view];
  const int32_t jnext = clampi(wrap_add(view, 1), 0, p.ncfg - 1);
  const bool can_ann =
      view + 1 < p.ncfg &&
      read_row<int32_t>(p, kCfgTick, c, p.ncfg)[jnext] <= t;
  const bool leader = read_row<uint8_t>(p, kCAlive, c, p.n)[i] != 0 &&
                      read_row<int32_t>(p, kCRole, c, p.n)[i] == kLeader;
  const int32_t base = read_row<int32_t>(p, kCBase, c, p.n)[i];
  const int32_t commit = read_row<int32_t>(p, kCCommit, c, p.n)[i];
  const int32_t term = read_row<int32_t>(p, kCTerm, c, p.n)[i];
  int32_t &len = work<int32_t>(p, ws, kCLogLen)[i];
  const int32_t len0 = len;
  int32_t *log_term = out_row<int32_t>(p, kCLogTerm, c) + i * cap;
  int32_t *log_val = out_row<int32_t>(p, kCLogVal, c) + i * cap;
  for (int vb = 0; vb < 2; ++vb) {
    if (!(can_ann && ws[p.ann + 2 * vb] && ws[p.ann + 2 * vb + 1] == i &&
          leader && wrap_sub(len, base) < cap &&
          wrap_sub(len, commit) < ki[kFlowCap]))
      continue;
    const int32_t av =
        M == kComputed
            ? jnext * p.g +
                  read_row<int32_t>(p, vb ? kFlipB : kFlipA, c, p.ncfg)[jnext] +
                  1
            : jnext * 2 + vb + 1;
    const int pos = slot_of(wrap_add(len, 1), cap);
    log_term[pos] = term;
    log_val[pos] = av;
    len = wrap_add(len, 1);
  }
  if (len > len0) work<int32_t>(p, ws, kCDurableLen)[i] = len;
}

// One node table of the restore (live rows `live`, their snapshot `snap`,
// w elements a node), a cell a thread: the crash reset to the persisted
// snapshot and the compaction capture from the staged rows (a cell reads
// only itself there), then the install of the in-group sender's snapshot
// as just captured, from the inputs (the sender's cells may change in this
// phase)
template <typename T>
__device__ __forceinline__ void restore_table(const Params &p, int32_t *ws,
                                              int c, int tid, int live,
                                              int snap, int w) {
  const int n = p.n, gn = p.g * p.n;
  const int32_t *alive = raft_row(p, ws, kRAlive);
  const int32_t *pre_alive = raft_row(p, ws, kRPreAlive);
  const int32_t *base = raft_row(p, ws, kRBase);
  const int32_t *pre_base = raft_row(p, ws, kRPreBase);
  const int32_t *inst_src = raft_row(p, ws, kRSnapInst);
  T *lv = work<T>(p, ws, live);
  T *sn = work<T>(p, ws, snap);
  for (int x = tid; x < gn * w; x += kThreads) {
    const int gi = x / w;
    const int32_t src = inst_src[gi];
    if (src >= 0) {
      // the sender's row after its own reset and capture
      T v = 0;
      if (src < n) {
        const int j = gi - gi % n + src, at = j * w + x % w;
        const Ro<T> lv0 = in_row<T>(p, live, c), sn0 = in_row<T>(p, snap, c);
        const bool fresh = !pre_alive[j] || !alive[j];
        const bool comp = base[j] != pre_base[j] && inst_src[j] < 0 &&
                          alive[j];
        v = comp && !fresh ? lv0[at] : sn0[at];
      }
      lv[x] = sn[x] = v;
      continue;
    }
    const bool fresh = !pre_alive[gi] || !alive[gi];
    const bool comp = base[gi] != pre_base[gi] && alive[gi];
    const T live1 = fresh ? sn[x] : lv[x];
    lv[x] = live1;
    if (comp) sn[x] = live1;
  }
}

// Phase kRestore: the apply machines' crash reset, compaction capture and
// install-snapshot (a table cell a thread), and the largest config lag of
// a restarting node (a shared max, applied in kApply)
__device__ __forceinline__ void restore(const Params &p, int32_t *ws, int c,
                                        int tid) {
  const int gn = p.g * p.n, ns = p.ns;
  const int32_t *alive = raft_row(p, ws, kRAlive);
  const int32_t *pre_alive = raft_row(p, ws, kRPreAlive);
  const int32_t *base = raft_row(p, ws, kRBase);
  const int32_t *inst_src = raft_row(p, ws, kRSnapInst);
  // a restarting node's missed configs, against its reset config (the
  // pre-tick snapshot's, read before the table's restore below)
  const int32_t ac = ws[p.view];
  const int32_t *snap_cfg = work<int32_t>(p, ws, kSnapCfg);
  for (int x = tid; x < gn; x += kThreads) {
    shared_max(ws + p.lag, !pre_alive[x] && alive[x]
                               ? wrap_sub(ac, snap_cfg[x]) : 0);
    if (!pre_alive[x] || !alive[x] || inst_src[x] >= 0)
      work<int32_t>(p, ws, kApplied)[x] = base[x];
  }
  restore_table<int32_t>(p, ws, c, tid, kNodeCfg, kSnapCfg, 1);
  restore_table<int32_t>(p, ws, c, tid, kNodeSrc, kSnapSrc, 1);
  restore_table<int32_t>(p, ws, c, tid, kPhase, kSnapPhase, ns);
  restore_table<int32_t>(p, ws, c, tid, kKeyHash, kSnapHash, ns);
  restore_table<int32_t>(p, ws, c, tid, kKeyCount, kSnapCount, ns);
  restore_table<int32_t>(p, ws, c, tid, kLastSeq, kSnapLastSeq, ns * p.nc);
}

// One apply round's entry at applier (g, i): the service state machine's
// Append / Put / Get, CONFIG, INSTALL and DELETE (shardkv.py's apply loop)
template <int M>
__device__ __forceinline__ void apply_node(const Params &p, int32_t *ws,
                                           int c, int gi) {
  const int n = p.n, ns = p.ns, nc = p.nc, cap = p.cap;
  const int g = gi / n;
  const int32_t *alive = raft_row(p, ws, kRAlive);
  const int32_t commit = raft_row(p, ws, kRCommit)[gi];
  const Ro<int32_t> ki = read_row<int32_t>(p, kKnobI, c, kNI);
  const bool skip_freeze = ki[kBugSkipFreeze] != 0;
  const bool drop_dup = ki[kBugDropDup] != 0;
  const Ro<int32_t> log_val0 = {in_row<int32_t>(p, kLogVal, c).x + gi * cap};
  const Ro<int32_t> clerk_seq0 = in_row<int32_t>(p, kClerkSeq, c);
  const Ro<int32_t> stg_cfg0 = in_row<int32_t>(p, kStagedCfg, c);
  const Ro<int32_t> stg_hash0 = in_row<int32_t>(p, kStagedHash, c);
  const Ro<int32_t> stg_count0 = in_row<int32_t>(p, kStagedCount, c);
  const Ro<int32_t> stg_ls0 = in_row<int32_t>(p, kStagedLastSeq, c);
  int32_t *phase = work<int32_t>(p, ws, kPhase) + gi * ns;
  int32_t *hash = work<int32_t>(p, ws, kKeyHash) + gi * ns;
  int32_t *count = work<int32_t>(p, ws, kKeyCount) + gi * ns;
  int32_t *last_seq = work<int32_t>(p, ws, kLastSeq) + gi * ns * nc;
  int32_t &node_cfg = work<int32_t>(p, ws, kNodeCfg)[gi];
  int32_t &applied = work<int32_t>(p, ws, kApplied)[gi];
  int32_t *first = ws + p.first + gi * nc;
  int32_t *first_obs = ws + p.first_obs + gi * nc;
  for (int round = 0; round < p.apply_max && alive[gi] && applied < commit;
       ++round) {
    const int32_t val = log_val0[slot_of(wrap_add(applied, 1), cap)];
    const Entry e = unpack(val, ns, nc, p.src_lim);
    const int s = e.shard;
    if (e.kind == kAppend || e.kind == kPut || e.kind == kGet) {
      int32_t &ls = last_seq[s * nc + e.client];
      if (phase[s] == kOwned && e.seq > ls) {
        if (e.kind != kGet) {
          hash[s] = static_cast<int32_t>(static_cast<uint32_t>(hash[s]) *
                                             kHashW +
                                         static_cast<uint32_t>(val));
          count[s] = wrap_add(count[s], 1);
        } else if (e.seq == clerk_seq0[e.client] &&
                   first[e.client] == p.apply_max) {
          first[e.client] = round;
          first_obs[e.client] = count[s];
        }
        ls = e.seq;
      }
    } else if (e.kind == kConfig && e.cfg_c == wrap_add(node_cfg, 1)) {
      // computed mode: the adopted replica's map, and the node's own last
      // adoption before it
      int32_t &node_src = work<int32_t>(p, ws, kNodeSrc)[gi];
      for (int x = 0; x < ns; ++x) {
        const int32_t now = new_owner<M>(p, ws, e.var, e.cfg_c, x);
        const int32_t before =
            prev_owner<M>(p, ws, node_src, node_cfg, e.cfg_c, x);
        if (now == g && phase[x] == kAbsent)
          phase[x] = before == now ? kOwned : kPulling;
        else if (now != g && phase[x] == kOwned && !skip_freeze)
          phase[x] = kFrozen;
      }
      node_cfg = e.cfg_c;
      if (M == kComputed) node_src = clampi(e.var, 0, p.n - 1);
    } else if (e.kind == kInstall && stg_cfg0[g * ns + s] == e.cfg_i &&
               phase[s] == kPulling) {
      hash[s] = stg_hash0[g * ns + s];
      count[s] = stg_count0[g * ns + s];
      for (int cl = 0; cl < nc; ++cl)
        last_seq[s * nc + cl] = drop_dup ? 0 : stg_ls0[(g * ns + s) * nc + cl];
      phase[s] = kOwned;
    } else if (e.kind == kDelete &&
               e.cfg_i == freeze_epoch(p, ws, g, node_cfg, s) &&
               phase[s] == kFrozen) {
      phase[s] = kAbsent;
      hash[s] = count[s] = 0;
      for (int cl = 0; cl < nc; ++cl) last_seq[s * nc + cl] = 0;
    }
    applied = wrap_add(applied, 1);
  }
}

// The truth walker's walk_max steps over every group's commit shadow (the
// plain version's order within a step: every group's entry, its
// controller check and its Append / Put / Get accept, then the freeze
// snapshots of every CONFIG, then each group's phases, INSTALL and
// DELETE). A CONFIG's owners are new_owner / prev_owner's; in a
// controller mode its adopted source is checked against the controller's
// decision: live, the variant must be the first-committed announce's;
// computed, the adopted map must be the canonical one (replica 0's). The
// shadows are the staged ones; a step in which no group walks leaves the
// walker as it was, so the walk stops there.
template <int M>
__device__ __forceinline__ void walk(const Params &p, int32_t *ws) {
  const int G = p.g, ns = p.ns, nc = p.nc, cap = p.cap;
  const int32_t *sh_val = ws + p.sh_val;
  const int32_t *sh_base = ws + p.sh_pos;
  const int32_t *sh_len = ws + p.sh_pos + G;
  int32_t *frontier = work<int32_t>(p, ws, kWFrontier);
  int32_t *w_cfg = work<int32_t>(p, ws, kWCfg);
  int32_t *w_phase = work<int32_t>(p, ws, kWPhase);
  int32_t *w_hash = work<int32_t>(p, ws, kWHash);
  int32_t *w_count = work<int32_t>(p, ws, kWCount);
  int32_t *w_ls = work<int32_t>(p, ws, kWLastSeq);
  int32_t *frz_cfg = work<int32_t>(p, ws, kFrzCfg);
  int32_t *frz_hash = work<int32_t>(p, ws, kFrzHash);
  int32_t *frz_count = work<int32_t>(p, ws, kFrzCount);
  int32_t *frz_ls = work<int32_t>(p, ws, kFrzLastSeq);
  int32_t *truth = work<int32_t>(p, ws, kTruthCount);
  int32_t *w_acked = work<int32_t>(p, ws, kWClerkAcked);
  int32_t &installs = work<int32_t>(p, ws, kInstallsDone)[0];
  int32_t &deletes = work<int32_t>(p, ws, kDeletesDone)[0];
  int32_t *w_src = M == kComputed ? work<int32_t>(p, ws, kWSrc) : nullptr;
  const int32_t *win_var =
      M == kLive ? work<int32_t>(p, ws, kWinVar) : nullptr;
  Entry ent[kMaxGroups];
  int32_t viol = 0;
  for (int step = 0; step < p.walk_max; ++step) {
    uint32_t canw = 0, is_cfg = 0;  // bit g: group g walks, its CONFIG
    for (int g = 0; g < G; ++g) {
      const int32_t f1 = wrap_add(frontier[g], 1);
      const int pos = slot_of(f1, cap);
      const int32_t val = sh_val[g * cap + pos];
      const Entry e = unpack(val, ns, nc, p.src_lim);
      const int s = e.shard;
      bool can = frontier[g] < sh_len[g] &&
                 shadow_abs(sh_base[g], pos, cap) == f1;
      const int32_t cur = w_phase[g * ns + s];
      // an INSTALL waits for its freeze snapshot
      can = can && !(e.kind == kInstall && cur == kPulling &&
                     frz_cfg[s] != e.cfg_i);
      if (can && (e.kind == kAppend || e.kind == kPut || e.kind == kGet)) {
        int32_t &ls = w_ls[(g * ns + s) * nc + e.client];
        if (cur == kOwned && e.seq > ls) {
          if (e.kind != kGet) {
            w_hash[g * ns + s] = static_cast<int32_t>(
                static_cast<uint32_t>(w_hash[g * ns + s]) * kHashW +
                static_cast<uint32_t>(val));
            w_count[g * ns + s] = wrap_add(w_count[g * ns + s], 1);
            truth[s] = wrap_add(truth[s], 1);
          }
          ls = e.seq;
          if (e.seq > w_acked[e.client]) w_acked[e.client] = e.seq;
        }
      }
      ent[g] = e;
      const bool cfg = can && e.kind == kConfig &&
                       e.cfg_c == wrap_add(w_cfg[g], 1);
      canw |= static_cast<uint32_t>(can) << g;
      is_cfg |= static_cast<uint32_t>(cfg) << g;
      if (cfg && M == kLive &&
          e.var != win_var[clampi(e.cfg_c, 0, p.ncfg - 1)])
        viol |= kViolCtrlStale;
      if (cfg && M == kComputed)
        for (int x = 0; x < ns; ++x)
          if (map_at(p, ws, e.var, e.cfg_c, x) != owner_at(p, ws, e.cfg_c, x))
            viol |= kViolCtrlStale;
    }
    if (!canw) break;
    // the freeze snapshots: a shard a CONFIG takes from its owner
    for (int s = 0; s < ns && is_cfg; ++s) {
      bool any = false;
      int32_t fc = -1, fh = 0, fn = 0;
      for (int g = 0; g < G; ++g) {
        if (!((is_cfg >> g) & 1u) ||
            new_owner<M>(p, ws, ent[g].var, ent[g].cfg_c, s) == g ||
            w_phase[g * ns + s] != kOwned)
          continue;
        any = true;
        fc = ent[g].cfg_c > fc ? ent[g].cfg_c : fc;
        fh = wrap_add(fh, w_hash[g * ns + s]);
        fn = wrap_add(fn, w_count[g * ns + s]);
      }
      if (!any) continue;
      frz_cfg[s] = fc;
      frz_hash[s] = fh;
      frz_count[s] = fn;
      for (int cl = 0; cl < nc; ++cl) {
        int32_t v = 0;
        for (int g = 0; g < G; ++g)
          if (((is_cfg >> g) & 1u) &&
              new_owner<M>(p, ws, ent[g].var, ent[g].cfg_c, s) != g &&
              w_phase[g * ns + s] == kOwned)
            v = wrap_add(v, w_ls[(g * ns + s) * nc + cl]);
        frz_ls[s * nc + cl] = v;
      }
    }
    for (int g = 0; g < G; ++g) {
      if (!((canw >> g) & 1u)) continue;
      const Entry &e = ent[g];
      const int s = e.shard;
      int32_t *ph = w_phase + g * ns;
      if ((is_cfg >> g) & 1u) {
        const int32_t src0 = w_src ? w_src[g] : 0;
        for (int x = 0; x < ns; ++x) {
          const int32_t now = new_owner<M>(p, ws, e.var, e.cfg_c, x);
          const int32_t before =
              prev_owner<M>(p, ws, src0, w_cfg[g], e.cfg_c, x);
          if (now == g && ph[x] == kAbsent)
            ph[x] = before == now ? kOwned : kPulling;
          else if (now != g && ph[x] == kOwned)
            ph[x] = kFrozen;
        }
        w_cfg[g] = e.cfg_c;
        if (w_src) w_src[g] = clampi(e.var, 0, p.n - 1);
      }
      if (e.kind == kInstall && ph[s] == kPulling) {
        w_hash[g * ns + s] = frz_hash[s];
        w_count[g * ns + s] = frz_count[s];
        for (int cl = 0; cl < nc; ++cl)
          w_ls[(g * ns + s) * nc + cl] = frz_ls[s * nc + cl];
        ph[s] = kOwned;
        installs = wrap_add(installs, 1);
      }
      if (e.kind == kDelete &&
          e.cfg_i == freeze_epoch(p, ws, g, w_cfg[g], s) && ph[s] == kFrozen) {
        ph[s] = kAbsent;
        w_hash[g * ns + s] = w_count[g * ns + s] = 0;
        for (int cl = 0; cl < nc; ++cl) w_ls[(g * ns + s) * nc + cl] = 0;
        deletes = wrap_add(deletes, 1);
      }
      frontier[g] = wrap_add(frontier[g], 1);
    }
  }
  if (viol) shared_or(ws + p.viol, viol);
}

// The threads kApply leaves idle, the warps after the appliers' and
// before the walker's (at least one warp): the groups' log rows straight
// to their outputs (the appends of kAppendLog land on them; the apply
// rounds read the inputs), then the clerks' draws (a pure function of the
// tick's keys and the clerk, so the clerks phase reads what it would have
// hashed)
__device__ __forceinline__ void apply_helpers(const Params &p, int32_t *ws,
                                              int c, int tid) {
  const int gn = p.g * p.n, nc = p.nc, end = kThreads - 32;
  const int h0 = (gn + 31) / 32 * 32 < end - 32 ? (gn + 31) / 32 * 32
                                                : end - 32;
  if (tid < h0 || tid >= end) return;
  const int at = tid - h0, helpers = end - h0;
  for (int l = kLogTerm; l <= kLogVal; ++l)
    stage::copy_row(p.leaf[l].in, p.leaf[l].out, p.leaf[l].count, c,
                    p.log_quads, at, helpers);
  for (int u = at; u < nc * kClerkDraws; u += helpers) {
    const int cl = u / kClerkDraws, k = u % kClerkDraws;
    ws[p.cdraw + u] =
        k == 2   ? draw_randint(p, ws, kKc + 2, cl, nc, 0, p.ns)
        : k == 4 ? draw_randint(p, ws, kKc + 4, cl, nc, 0, p.n)
                 : static_cast<int32_t>(draw_word(p, ws, kKc + k, cl, nc));
  }
}

// Phase kApply: apply_max rounds of the apply loop, an applier (group,
// node) a thread on the threads but the last (an applier's rounds are
// sequential, the appliers independent), each round's Get answers to the
// scratch (first, first_obs) for the clerks; on thread kWalker (the last
// warp) the truth walker; thread 0 also folds the restore's config lag
// into max_cfg_lag; the idle threads' apply_helpers
template <int M>
__device__ __forceinline__ void apply(const Params &p, int32_t *ws, int c,
                                      int tid) {
  if (tid == kWalker) {
    walk<M>(p, ws);
    return;
  }
  apply_helpers(p, ws, c, tid);
  if (tid == 0) {
    int32_t &m = work<int32_t>(p, ws, kMaxCfgLag)[0];
    m = ws[p.lag] > m ? ws[p.lag] : m;
  }
  for (int gi = tid; gi < p.g * p.n; gi += kThreads - 1)
    apply_node<M>(p, ws, c, gi);
}

// The controller's scans for the Query mailboxes (controller modes), a
// (group, slot) pair a thread: the committed announces of the staged
// controller shadow above the queried node's commit, and under
// bug_stale_ctrler_read (live) the least log index in the queried node's
// log window (its row after this tick's announces) holding the asked
// announce; shared adds and mins into q_above and q_amin
template <int M>
__device__ __forceinline__ void query_scan(const Params &p, int32_t *ws,
                                           int c, int tid) {
  if (M == kSchedule) return;
  const int cap = p.cap, n = p.n;
  const int32_t sbase = read_row<int32_t>(p, kCShadowBase, c, 1)[0];
  const int32_t slen = read_row<int32_t>(p, kCShadowLen, c, 1)[0];
  const bool stale =
      M == kLive && read_row<int32_t>(p, kKnobI, c, kNI)[kBugStaleCtrl];
  for (int u = tid; u < p.g * cap; u += kThreads) {
    const int g = u / cap, x = u % cap;
    const int32_t node = work<int32_t>(p, ws, kCqReqNode)[g];
    if (node < 0 || node >= n) continue;
    const int32_t v = ws[p.csh_val + x];
    const int32_t a = shadow_abs(sbase, x, cap);
    if (v > 0 && v != kNoop && a <= slen &&
        a > read_row<int32_t>(p, kCCommit, c, n)[node])
      shared_add(ws + p.q_above + g, 1);
    if (!stale) continue;
    const int32_t lv = out_row<int32_t>(p, kCLogVal, c)[node * cap + x];
    const int32_t la =
        shadow_abs(read_row<int32_t>(p, kCBase, c, n)[node], x, cap);
    if (lv > 0 && lv != kNoop && la <= work<int32_t>(p, ws, kCLogLen)[node] &&
        floor_div(wrap_sub(lv, 1), 2) == work<int32_t>(p, ws, kCqReqJ)[g])
      shared_min(ws + p.q_amin + g, la);
  }
}

// Phase kOracle: each applier's divergence (alive and at the walker's
// frontier: its state must equal the walker's) and storage leak, a thread
// an applier; the ownership check on thread kWalker; each group's leader
// view (the alive leader with the most applied, the first on a tie; node
// 0 when there is none), a thread a group; the controller's scans
template <int M>
__device__ __forceinline__ void oracle(const Params &p, int32_t *ws, int c,
                                       int tid) {
  query_scan<M>(p, ws, c, tid);
  const int n = p.n, ns = p.ns, nc = p.nc, gn = p.g * p.n;
  const int32_t *alive = raft_row(p, ws, kRAlive);
  const int32_t *role = raft_row(p, ws, kRRole);
  const int32_t *applied = work<int32_t>(p, ws, kApplied);
  int32_t viol = 0;
  for (int gi = tid; gi < gn; gi += kThreads) {
    if (!alive[gi]) continue;
    const int g = gi / n;
    const int32_t *phase = work<int32_t>(p, ws, kPhase) + gi * ns;
    const int32_t *hash = work<int32_t>(p, ws, kKeyHash) + gi * ns;
    const int32_t *count = work<int32_t>(p, ws, kKeyCount) + gi * ns;
    const int32_t *ls = work<int32_t>(p, ws, kLastSeq) + gi * ns * nc;
    for (int s = 0; s < ns; ++s)
      if (phase[s] == kAbsent && (hash[s] != 0 || count[s] != 0))
        viol |= kViolStorage;
    if (applied[gi] != work<int32_t>(p, ws, kWFrontier)[g]) continue;
    const int32_t *w_phase = work<int32_t>(p, ws, kWPhase) + g * ns;
    const int32_t *w_hash = work<int32_t>(p, ws, kWHash) + g * ns;
    const int32_t *w_count = work<int32_t>(p, ws, kWCount) + g * ns;
    const int32_t *w_ls = work<int32_t>(p, ws, kWLastSeq) + g * ns * nc;
    bool same = work<int32_t>(p, ws, kNodeCfg)[gi] ==
                work<int32_t>(p, ws, kWCfg)[g];
    for (int s = 0; s < ns; ++s)
      same &= phase[s] == w_phase[s] && hash[s] == w_hash[s] &&
              count[s] == w_count[s];
    for (int x = 0; x < ns * nc; ++x) same &= ls[x] == w_ls[x];
    if (!same) viol |= kViolDiverge;
  }
  if (tid == kWalker) {
    const int32_t *w_phase = work<int32_t>(p, ws, kWPhase);
    for (int s = 0; s < ns; ++s) {
      int owned = 0;
      for (int g = 0; g < p.g; ++g) owned += w_phase[g * ns + s] == kOwned;
      if (owned > 1) viol |= kViolOwnership;
    }
  }
  for (int g = tid; g < p.g; g += kThreads) {
    int best = 0;
    int32_t score = -1;
    bool any = false;
    for (int i = 0; i < n; ++i) {
      const int gi = g * n + i;
      const bool lead = alive[gi] && role[gi] == kLeader;
      const int32_t v = lead ? applied[gi] : -1;
      if (i == 0 || v > score) {
        score = v;
        best = i;
      }
      any |= lead;
    }
    ws[p.lead + g] = best;
    ws[p.lead_any + g] = any;
  }
  if (viol) shared_or(ws + p.viol, viol);
}

// The leader view of group g: its lead node's row of a staged node table
// of w elements a node
__device__ __forceinline__ const int32_t *lead_row(const Params &p,
                                                   const int32_t *ws, int l,
                                                   int g, int w) {
  return reinterpret_cast<const int32_t *>(ws + p.leaf[l].off) +
         (g * p.n + ws[p.lead + g]) * w;
}

// One (group, shard) pair's mailboxes: as the destination, the pull
// requests it sent that arrive at their source (and the responses sent
// back), the responses that arrive (the staging), its new pull requests;
// as a holder, the GC confirms that arrive, the confirm requests it sent
// that arrive at the gain owner (and the confirms sent back), its new
// confirm polls. Every cell the pair writes is its own: the pull boxes
// [g, *, s], the confirm responses [g, *, s], the confirm requests
// [*, g, s].
__device__ __forceinline__ void mailbox_pair(const Params &p, int32_t *ws,
                                             int c, int g, int s) {
  const int G = p.g, ns = p.ns, nc = p.nc;
  const int32_t t = tick_of(p, c);
  const int total = G * G * ns;
  const float *kf_row = static_cast<const float *>(p.read[kKnobF]) +
                        static_cast<int64_t>(c) * kNF;
  int32_t *req_t = work<int32_t>(p, ws, kPullReqT);
  int32_t *req_cfg = work<int32_t>(p, ws, kPullReqCfg);
  int32_t *rsp_t = work<int32_t>(p, ws, kPullRspT);
  int32_t *rsp_cfg = work<int32_t>(p, ws, kPullRspCfg);
  int32_t *rsp_hash = work<int32_t>(p, ws, kPullRspHash);
  int32_t *rsp_count = work<int32_t>(p, ws, kPullRspCount);
  int32_t *rsp_ls = work<int32_t>(p, ws, kPullRspLastSeq);
  const Ro<int32_t> req_t0 = in_row<int32_t>(p, kPullReqT, c);
  const Ro<int32_t> req_cfg0 = in_row<int32_t>(p, kPullReqCfg, c);
  const int32_t *lead_any = ws + p.lead_any;
  const int32_t my_cfg = lead_row(p, ws, kNodeCfg, g, 1)[0];
  const int32_t my_phase = lead_row(p, ws, kPhase, g, ns)[s];

  // pull requests arriving at their source: its leader answers for a
  // FROZEN shard at the requested config with its frozen state
  for (int src = 0; src < G; ++src) {
    const int cell = (g * G + src) * ns + s;
    if (req_t0[cell] != t) continue;
    req_t[cell] = 0;
    if (!(lead_any[src] && lead_row(p, ws, kPhase, src, ns)[s] == kFrozen &&
          lead_row(p, ws, kNodeCfg, src, 1)[0] >= req_cfg0[cell]))
      continue;
    const uint32_t w = draw_word(p, ws, kKnet + 0, cell, total);
    if (net_lost(p, c, w)) continue;
    rsp_t[cell] = wrap_add(t, net_delay(p, c, w));
    rsp_cfg[cell] = req_cfg0[cell];
    rsp_hash[cell] = lead_row(p, ws, kKeyHash, src, ns)[s];
    rsp_count[cell] = lead_row(p, ws, kKeyCount, src, ns)[s];
    const int32_t *ls = lead_row(p, ws, kLastSeq, src, ns * nc) + s * nc;
    for (int cl = 0; cl < nc; ++cl) rsp_ls[cell * nc + cl] = ls[cl];
  }
  // responses arriving here: stage the payload
  bool got = false;
  int32_t scfg = -1, shash = 0, scount = 0;
  for (int src = 0; src < G; ++src) {
    const int cell = (g * G + src) * ns + s;
    if (rsp_t[cell] != t) continue;
    got = true;
    scfg = rsp_cfg[cell] > scfg ? rsp_cfg[cell] : scfg;
    shash = wrap_add(shash, rsp_hash[cell]);
    scount = wrap_add(scount, rsp_count[cell]);
  }
  if (got) {
    work<int32_t>(p, ws, kStagedCfg)[g * ns + s] = scfg;
    work<int32_t>(p, ws, kStagedHash)[g * ns + s] = shash;
    work<int32_t>(p, ws, kStagedCount)[g * ns + s] = scount;
    for (int cl = 0; cl < nc; ++cl) {
      int32_t v = 0;
      for (int src = 0; src < G; ++src) {
        const int cell = (g * G + src) * ns + s;
        if (rsp_t[cell] == t) v = wrap_add(v, rsp_ls[cell * nc + cl]);
      }
      work<int32_t>(p, ws, kStagedLastSeq)[(g * ns + s) * nc + cl] = v;
    }
    for (int src = 0; src < G; ++src) {
      const int cell = (g * G + src) * ns + s;
      if (rsp_t[cell] == t) rsp_t[cell] = 0;
    }
  }

  const int32_t fe = freeze_epoch(p, ws, g, my_cfg, s);
  ws[p.frz_epoch + g * ns + s] = fe;
  // GC confirms arriving at this holder: the leader deletes the copy if
  // the confirmed epoch is its current one
  int32_t *grsp_t = work<int32_t>(p, ws, kGcqRspT);
  int32_t *grsp_cfg = work<int32_t>(p, ws, kGcqRspCfg);
  int32_t *greq_t = work<int32_t>(p, ws, kGcqReqT);
  int32_t *greq_cfg = work<int32_t>(p, ws, kGcqReqCfg);
  const Ro<int32_t> grsp_t0 = in_row<int32_t>(p, kGcqRspT, c);
  const Ro<int32_t> grsp_cfg0 = in_row<int32_t>(p, kGcqRspCfg, c);
  const Ro<int32_t> greq_t0 = in_row<int32_t>(p, kGcqReqT, c);
  const Ro<int32_t> greq_cfg0 = in_row<int32_t>(p, kGcqReqCfg, c);
  bool ack = false;
  for (int o = 0; o < G; ++o) {
    const int cell = (g * G + o) * ns + s;
    if (grsp_t0[cell] != t) continue;
    ack |= grsp_cfg0[cell] == fe;
    grsp_t[cell] = 0;
  }
  ws[p.ack_del + g * ns + s] = ack && my_phase == kFrozen;
  // this holder's confirm requests arriving at their gain owner o: its
  // leader answers "installed" from its applied state (keep-oldest on
  // the response box)
  for (int o = 0; o < G; ++o) {
    const int cell = (o * G + g) * ns + s;
    if (greq_t0[cell] != t) continue;
    greq_t[cell] = 0;
    const int32_t oc = lead_row(p, ws, kNodeCfg, o, 1)[0];
    const bool installed =
        lead_any[o] &&
        (oc > greq_cfg0[cell] ||
         (oc == greq_cfg0[cell] && lead_row(p, ws, kPhase, o, ns)[s] == kOwned));
    if (!installed) continue;
    if (net_lost(p, c, draw_word(p, ws, kKnet + 1, cell, total))) continue;
    const int back = (g * G + o) * ns + s;
    if (grsp_t[back] != 0) continue;
    grsp_t[back] = wrap_add(
        t, net_delay(p, c, draw_word(p, ws, kKnet + 1, back, total)));
    grsp_cfg[back] = greq_cfg0[cell];
  }

  // new pull requests for a PULLING shard, to its previous owner
  const bool want = my_phase == kPulling && lead_any[g];
  ws[p.want_pull + g * ns + s] = want;
  if (want && madraft::uniform(draw_word(p, ws, kKp + 1, g * ns + s,
                                         G * ns)) < kf_row[kPPull]) {
    const int32_t prev = owner_at(p, ws, wrap_sub(my_cfg, 1), s);
    for (int src = 0; src < G; ++src) {
      if (prev != src) continue;
      const int cell = (g * G + src) * ns + s;
      const uint32_t w = draw_word(p, ws, kKnet + 2, cell, total);
      if (net_lost(p, c, w)) continue;
      req_t[cell] = wrap_add(t, net_delay(p, c, w));
      req_cfg[cell] = my_cfg;
    }
  }
  // new confirm polls of a FROZEN copy, to its gain-config owner
  if (my_phase == kFrozen && fe > 0 && lead_any[g] &&
      madraft::uniform(draw_word(p, ws, kKp + 3, g * ns + s, G * ns)) <
          kf_row[kPAck]) {
    const int32_t o = owner_at(p, ws, fe, s);
    if (o >= 0 && o < G) {
      const int cell = (o * G + g) * ns + s;
      const uint32_t w = draw_word(p, ws, kKnet + 3, cell, total);
      if (!net_lost(p, c, w) && greq_t[cell] == 0) {
        greq_t[cell] = wrap_add(t, net_delay(p, c, w));
        greq_cfg[cell] = fe;
      }
    }
  }
}

// Group g's Query protocol to the controller (controller modes), one
// outstanding Query a group: a response arriving that says config
// l_cfg + 1 exists lets the gated leader append its CONFIG, adopting the
// source it names; a request arriving at an alive controller node is
// answered, over a lossy delayed hop, from the node's committed prefix
// (live, under bug_stale_ctrler_read, from the first announce of the
// asked config in its log tail, the announcers' appends included;
// computed, the answer is the replica itself: the scans are query_scan's);
// an idle group with a leader and a poll asks a random node for config
// l_cfg + 1
template <int M>
__device__ __forceinline__ void query(const Params &p, int32_t *ws, int c,
                                      int g, int32_t t, bool gate, bool poll,
                                      int32_t l_cfg) {
  const int cap = p.cap, n = p.n;
  int32_t &req_t = work<int32_t>(p, ws, kCqReqT)[g];
  int32_t &req_node = work<int32_t>(p, ws, kCqReqNode)[g];
  int32_t &req_j = work<int32_t>(p, ws, kCqReqJ)[g];
  int32_t &rsp_t = work<int32_t>(p, ws, kCqRspT)[g];
  int32_t &rsp_j = work<int32_t>(p, ws, kCqRspJ)[g];
  uint8_t &rsp_found = work<uint8_t>(p, ws, kCqRspFound)[g];
  int32_t &rsp_var = work<int32_t>(p, ws, kCqRspVar)[g];
  const int32_t *win_var = work<int32_t>(p, ws, kWinVar);
  const int32_t view = ws[p.view];
  const bool rsp_arr = rsp_t == t;
  const bool adopt =
      rsp_arr && rsp_found != 0 && rsp_j == wrap_add(l_cfg, 1);
  ws[p.can_adv + g] = gate && adopt;
  ws[p.adopt + g] = adopt ? rsp_var : 0;
  if (rsp_arr) rsp_t = 0;
  const bool req_arr = req_t == t;
  const int32_t node = req_node, jreq = req_j;
  const bool in_range = node >= 0 && node < n;
  int32_t cnt_at = 0;
  bool alive_at = false;
  if (in_range) {
    // the committed announces the node has not yet covered
    const int32_t cnt = wrap_sub(view, ws[p.q_above + g]);
    cnt_at = cnt < 0 ? 0 : (cnt > view ? view : cnt);
    alive_at = read_row<uint8_t>(p, kCAlive, c, n)[node] != 0;
  }
  const int32_t wv = win_var[clampi(jreq, 0, p.ncfg - 1)];
  bool found = jreq <= cnt_at && wv >= 0;
  int32_t var = wv > 0 ? wv : 0;
  if (M == kComputed) {
    var = clampi(node, 0, n - 1);
  } else if (read_row<int32_t>(p, kKnobI, c, kNI)[kBugStaleCtrl] &&
             in_range) {
    // the node's first log occurrence of announce jreq: the variant in
    // its slot
    const int32_t amin = ws[p.q_amin + g];
    if (amin < kBig) {
      found = true;
      var = floor_mod(wrap_sub(out_row<int32_t>(p, kCLogVal, c)[
                                   node * cap + slot_of(amin, cap)], 1), 2);
    }
  }
  const uint32_t rw = draw_word(p, ws, kKnetQ + 0, g, p.g);
  if (req_arr && alive_at && !net_lost(p, c, rw)) {
    rsp_t = wrap_add(t, net_delay(p, c, rw));
    rsp_j = jreq;
    rsp_found = found;
    rsp_var = var;
  }
  if (req_arr) req_t = 0;
  if (ws[p.lead_any + g] && poll && req_t == 0 && rsp_t == 0 &&
      wrap_add(l_cfg, 1) < p.ncfg) {
    const uint32_t qw = draw_word(p, ws, kKnetQ + 1, g, p.g);
    if (!net_lost(p, c, qw)) {
      req_t = wrap_add(t, net_delay(p, c, qw));
      req_node = draw_randint(p, ws, kKa + 4, g, p.g, 0, n);
      req_j = wrap_add(l_cfg, 1);
    }
  }
}

// Group g's CONFIG advance, once the leader's pulls are done and no
// FROZEN shard of its would come back to it: in schedule mode on a poll
// while the schedule is ahead, in a controller mode by the Query protocol
// (query)
template <int M>
__device__ __forceinline__ void advance_gate(const Params &p, int32_t *ws,
                                             int c, int g) {
  const int ns = p.ns;
  const int32_t t = tick_of(p, c);
  const int32_t l_cfg = lead_row(p, ws, kNodeCfg, g, 1)[0];
  const int32_t *l_phase = lead_row(p, ws, kPhase, g, ns);
  bool gate = ws[p.lead_any + g] != 0;
  for (int s = 0; s < ns; ++s)
    gate &= l_phase[s] != kPulling &&
            !(l_phase[s] == kFrozen && owner_at(p, ws, wrap_add(l_cfg, 1), s) == g);
  const float p_learn = read_row<float>(p, kKnobF, c, kNF)[kPCfgLearn];
  const bool poll =
      madraft::uniform(draw_word(p, ws, kKp + 0, g, p.g)) < p_learn;
  if (M == kSchedule) {
    ws[p.can_adv + g] = gate && poll && l_cfg < ws[p.view];
    ws[p.adopt + g] = 0;
  } else {
    query<M>(p, ws, c, g, t, gate, poll, l_cfg);
  }
}

// Phase kMailbox: a thread a (group, shard) pair (mailbox_pair), then a
// thread a group (advance_gate)
template <int M>
__device__ __forceinline__ void mailbox(const Params &p, int32_t *ws, int c,
                                        int tid) {
  const int pairs = p.g * p.ns;
  for (int u = tid; u < pairs + p.g; u += kThreads) {
    if (u < pairs)
      mailbox_pair(p, ws, c, u / p.ns, u % p.ns);
    else
      advance_gate<M>(p, ws, c, u - pairs);
  }
}

// A metrics fold of one op (fold_latencies, fold_phases, fold_latencies_by
// by shard and by client) and its worst-op candidate in `cand`
__device__ __forceinline__ void fold_op(const Params &p, int32_t *ws,
                                        bool mask, int32_t lat,
                                        const int32_t ph[kPhases],
                                        int32_t shard, int cl, int32_t sub,
                                        int32_t *cand) {
  const int hb = p.hb;
  if (mask) {
    shared_add(work<int32_t>(p, ws, kLatHist) + bucket_of(lat, hb), 1);
    int32_t *phist = work<int32_t>(p, ws, kPhaseHist);
    int32_t *pticks = work<int32_t>(p, ws, kPhaseTicks);
    for (int q = 0; q < kPhases; ++q) {
      shared_add(phist + q * hb + bucket_of(ph[q], hb), 1);
      shared_add(pticks + q, ph[q]);
    }
    shared_add(work<int32_t>(p, ws, kLatTicks), lat);
    if (shard >= 0 && shard < p.ns)
      shared_add(work<int32_t>(p, ws, kKeyLatHist) + shard * hb +
                     bucket_of(lat, hb), 1);
    shared_add(work<int32_t>(p, ws, kClientLatHist) + cl * hb +
                   bucket_of(lat, hb), 1);
  }
  cand[0] = mask;
  cand[1] = lat;
  cand[2] = shard;
  cand[3] = sub;
  for (int q = 0; q < kPhases; ++q) cand[4 + q] = ph[q];
}

// Phase kClerks, a clerk a thread: the ack (the walker's accept, a Get's
// answer from the first apply round that gave one, the largest there), the
// read oracle, the metric folds, the re-learn, the open-loop arrival, a
// fresh op or a retry and its target, the bug mode's local serve and the
// WrongGroup mark
__device__ __forceinline__ void clerks(const Params &p, int32_t *ws, int c,
                                       int tid) {
  if (tid >= p.nc) return;
  const int cl = tid, n = p.n, ns = p.ns, nc = p.nc, gn = p.g * p.n;
  const int32_t t = tick_of(p, c);
  const Ro<float> kf = read_row<float>(p, kKnobF, c, kNF);
  const Ro<int32_t> ki = read_row<int32_t>(p, kKnobI, c, kNI);
  const int32_t *truth = work<int32_t>(p, ws, kTruthCount);
  int32_t viol = 0;

  const int32_t cs = in_row<int32_t>(p, kClerkSeq, c)[cl];
  const bool out0 = in_row<uint8_t>(p, kClerkOut, c)[cl] != 0;
  const int32_t kind0 = in_row<int32_t>(p, kClerkKind, c)[cl];
  const int32_t shard0 = in_row<int32_t>(p, kClerkShard, c)[cl];
  const int32_t get_lo0 = in_row<int32_t>(p, kClerkGetLo, c)[cl];
  const bool wrong0 = in_row<uint8_t>(p, kClerkWrong, c)[cl] != 0;
  int32_t obs = in_row<int32_t>(p, kClerkGetObs, c)[cl];
  if (obs < 0) {
    int round = p.apply_max;
    for (int a = 0; a < gn; ++a) {
      const int r = ws[p.first + a * nc + cl];
      const int32_t o = ws[p.first_obs + a * nc + cl];
      if (r < round || (r == round && r < p.apply_max && o > obs)) {
        round = r;
        obs = o;
      }
    }
  }
  const int32_t wacked = work<int32_t>(p, ws, kWClerkAcked)[cl];
  const bool is_get0 = kind0 == kGet;
  const int32_t truth_at = shard0 >= 0 && shard0 < ns ? truth[shard0] : 0;
  int32_t sub = 0, app = 0, cmt = 0, apl = 0, mig = 0;
  if (kMetrics) {
    sub = in_row<int32_t>(p, kClerkSub, c)[cl];
    app = in_row<int32_t>(p, kClerkApp, c)[cl];
    cmt = in_row<int32_t>(p, kClerkCmt, c)[cl];
    apl = in_row<int32_t>(p, kClerkApl, c)[cl];
    mig = in_row<int32_t>(p, kClerkMig, c)[cl];
    if (out0 && wacked >= cs && cmt == 0) cmt = t;
    if (out0 && obs >= 0 && apl == 0) apl = t;
  }
  const bool newly = out0 && wacked >= cs && (!is_get0 || obs >= 0);
  const bool done_get = newly && is_get0;
  if (done_get && (obs < get_lo0 || obs > truth_at)) viol |= kViolStaleRead;
  int32_t acked = newly ? cs : in_row<int32_t>(p, kClerkAcked, c)[cl];
  bool cout = out0 && !newly;
  int32_t gets = wrap_add(in_row<int32_t>(p, kGetsDone, c)[cl], done_get);
  if (kMetrics) {
    // the ack's submit->ack latency, its five phases (the stamps clamped
    // monotone, the migration wait clipped into the pre-append window)
    const int32_t e2e = wrap_sub(t, sub);
    const int32_t app_e = app > sub ? app : sub;
    const int32_t pre = wrap_sub(app_e, sub);
    const int32_t mig_e = mig < pre ? mig : pre;
    const int32_t cmt_e = cmt > app_e ? cmt : app_e;
    const int32_t b3 = is_get0 ? (apl > cmt_e ? apl : cmt_e) : cmt_e;
    const int32_t ph[kPhases] = {wrap_sub(pre, mig_e), wrap_sub(cmt_e, app_e),
                                 wrap_sub(b3, cmt_e), wrap_sub(t, b3), mig_e};
    fold_op(p, ws, newly, e2e, ph, shard0, cl, sub,
            ws + p.worst + cl * kWorstWords);
  }

  // the re-learn (a WrongGroup mark re-learns now), the start word (its
  // low 9 bits the open-loop arrival), each other draw only where used;
  // the draws hashed in kApply (apply_helpers)
  const int32_t *dr = ws + p.cdraw + cl * kClerkDraws;
  const bool learn =
      madraft::uniform(static_cast<uint32_t>(dr[0])) < kf[kPCfgLearn] ||
      (ki[kRequery] != 0 && wrong0);
  const int32_t ccfg =
      learn ? ws[p.view] : in_row<int32_t>(p, kClerkCfg, c)[cl];
  const uint32_t w = static_cast<uint32_t>(dr[1]);
  const bool openloop = ki[kQueueCap] > 0;
  const bool arrive = openloop &&
                      fmul(static_cast<float>(w & 0x1FFu), 0.001953125f) <
                          kf[kOpenRate];
  const int32_t arr0 = in_row<int32_t>(p, kOpenArr, c)[cl];
  const int32_t srv0 = in_row<int32_t>(p, kOpenSrv, c)[cl];
  const bool drop = arrive && wrap_sub(arr0, srv0) >= ki[kQueueCap];
  const bool enq = arrive && !drop;
  const int32_t arr = wrap_add(arr0, enq);
  int32_t *stamp = kMetrics ? work<int32_t>(p, ws, kOpenStamp) +
                                  cl * kQueueSlots : nullptr;
  if (kMetrics && enq) stamp[floor_mod(arr0, kQueueSlots)] = t;
  const bool start = !cout &&
                     (openloop ? arr > srv0
                               : madraft::uniform(w) < kf[kPOp]) &&
                     cs < kSeqLim - 1;
  const int32_t seq = start ? wrap_add(cs, 1) : cs;
  int32_t shard = shard0, kind = kind0;
  if (start) {
    shard = zipf_map(dr[2], ns, kf[kZipfA]);
    const float u = madraft::uniform(static_cast<uint32_t>(dr[5]));
    kind = u < kf[kPGet] ? kGet
           : u < fadd(kf[kPGet], kf[kPPut]) ? kPut : kAppend;
    obs = -1;
    if (kMetrics) {
      sub = openloop ? stamp[floor_mod(srv0, kQueueSlots)] : t;
      app = cmt = apl = mig = 0;
    }
  }
  const int32_t truth_new = truth[shard];
  const int32_t get_lo = start ? truth_new : get_lo0;
  cout = cout || start;
  bool rt = cout && (start || madraft::uniform(static_cast<uint32_t>(
                                  dr[3])) < kf[kPRetry]);
  const int32_t retries = kMetrics ? wrap_add(in_row<int32_t>(
                              p, kClientRetries, c)[cl], rt) : 0;
  const int32_t tgt = dr[4];
  const int32_t grp = owner_at(p, ws, ccfg, shard);
  const int at = (grp * n + tgt);
  const int32_t ph_at = work<int32_t>(p, ws, kPhase)[at * ns + shard];
  const int32_t cnt_at = work<int32_t>(p, ws, kKeyCount)[at * ns + shard];
  const int32_t *alive = raft_row(p, ws, kRAlive);
  const bool served = ki[kBugServeFrozen] != 0 && rt && !start &&
                      kind == kGet && alive[at] && ph_at != kOwned;
  if (served && (cnt_at < get_lo || cnt_at > truth_new)) viol |= kViolStaleRead;
  if (served) {
    acked = seq;
    cout = false;
    gets = wrap_add(gets, 1);
    rt = false;
  }
  if (kMetrics) {
    // a local serve's whole latency is the apply phase
    const int32_t e2e = wrap_sub(t, sub);
    const int32_t ph[kPhases] = {0, 0, e2e, 0, 0};
    fold_op(p, ws, served, e2e, ph, shard, cl, sub,
            ws + p.worst + (nc + cl) * kWorstWords);
  }
  const bool lead_at = alive[at] && raft_row(p, ws, kRRole)[at] == kLeader;
  const bool wrong = rt ? lead_at && ph_at != kOwned : wrong0 && !learn;
  if (kMetrics && cout && app == 0 && wrong) mig = wrap_add(mig, 1);

  work<int32_t>(p, ws, kClerkSeq)[cl] = seq;
  work<uint8_t>(p, ws, kClerkOut)[cl] = cout;
  work<int32_t>(p, ws, kClerkShard)[cl] = shard;
  work<int32_t>(p, ws, kClerkKind)[cl] = kind;
  work<int32_t>(p, ws, kClerkCfg)[cl] = ccfg;
  work<uint8_t>(p, ws, kClerkWrong)[cl] = wrong;
  work<int32_t>(p, ws, kClerkAcked)[cl] = acked;
  work<int32_t>(p, ws, kClerkGetLo)[cl] = get_lo;
  work<int32_t>(p, ws, kClerkGetObs)[cl] = obs;
  work<int32_t>(p, ws, kGetsDone)[cl] = gets;
  work<int32_t>(p, ws, kOpenArr)[cl] = arr;
  work<int32_t>(p, ws, kOpenSrv)[cl] =
      wrap_add(srv0, openloop && start);
  work<int32_t>(p, ws, kOpenDrop)[cl] =
      wrap_add(in_row<int32_t>(p, kOpenDrop, c)[cl], drop);
  if (kMetrics) {
    work<int32_t>(p, ws, kClerkSub)[cl] = sub;
    work<int32_t>(p, ws, kClerkApp)[cl] = app;
    work<int32_t>(p, ws, kClerkCmt)[cl] = cmt;
    work<int32_t>(p, ws, kClerkApl)[cl] = apl;
    work<int32_t>(p, ws, kClerkMig)[cl] = mig;
    work<int32_t>(p, ws, kClientRetries)[cl] = retries;
  }
  ws[p.target + cl] = tgt;
  ws[p.grp + cl] = grp;
  ws[p.retry + cl] = rt;
  if (viol) shared_or(ws + p.viol, viol);
}

// The worst-op register after one fold: the clerks' candidates (cand,
// [nc, kWorstWords]) reduced in client order (the first of the largest
// masked latency), then the register updated (metrics.py update_worst)
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

// Phase kAppendLog, a node a thread: the node's appends in the plain
// version's order (CONFIG, INSTALL for shards 0..ns-1, DELETE for shards
// 0..ns-1 at the group's leader view node, then the clerks' ops 0..nc-1
// that target it), each re-deriving its room from the running log_len
// under the flow-cap gate, and the raft leaves they move; thread 0 then
// the worst-op register and the violation bits
__device__ __forceinline__ void append_log(const Params &p, int32_t *ws,
                                           int c, int tid) {
  const int n = p.n, ns = p.ns, nc = p.nc, cap = p.cap, gn = p.g * p.n;
  const int32_t *term = raft_row(p, ws, kRTerm);
  const int32_t *role = raft_row(p, ws, kRRole);
  const int32_t *alive = raft_row(p, ws, kRAlive);
  const int32_t *base = raft_row(p, ws, kRBase);
  const int32_t *commit = raft_row(p, ws, kRCommit);
  const int32_t flow_cap = read_row<int32_t>(p, kKnobI, c, kNI)[kFlowCap];
  int32_t *log_len = work<int32_t>(p, ws, kLogLen);
  const Ro<int32_t> log_len0 = in_row<int32_t>(p, kLogLen, c);
  for (int gi = tid; gi < gn; gi += kThreads) {
    const int g = gi / n, i = gi % n;
    int32_t len = log_len[gi];
    if (alive[gi] && role[gi] == kLeader) {
      int32_t *log_term = out_row<int32_t>(p, kLogTerm, c) + gi * cap;
      int32_t *log_val = out_row<int32_t>(p, kLogVal, c) + gi * cap;
      auto append = [&](int32_t v) {
        if (!(wrap_sub(len, base[gi]) < cap &&
              wrap_sub(len, commit[gi]) < flow_cap))
          return false;
        const int pos = slot_of(wrap_add(len, 1), cap);
        log_term[pos] = term[gi];
        log_val[pos] = v;
        len = wrap_add(len, 1);
        return true;
      };
      if (ws[p.lead + g] == i) {
        const int32_t node_cfg = work<int32_t>(p, ws, kNodeCfg)[gi];
        const int32_t l_cfg = node_cfg;
        if (ws[p.can_adv + g])
          append(pack_marker(wrap_add(node_cfg, 1), ws[p.adopt + g], kConfig,
                             ns, p.src_lim));
        for (int s = 0; s < ns; ++s)
          if (ws[p.want_pull + g * ns + s] &&
              work<int32_t>(p, ws, kStagedCfg)[g * ns + s] == l_cfg)
            append(pack_marker(node_cfg, s, kInstall, ns, p.src_lim));
        for (int s = 0; s < ns; ++s)
          if (ws[p.ack_del + g * ns + s])
            append(pack_marker(ws[p.frz_epoch + g * ns + s], s, kDelete, ns,
                               p.src_lim));
      }
      for (int cl = 0; cl < nc; ++cl) {
        if (!ws[p.retry + cl] || ws[p.grp + cl] != g ||
            ws[p.target + cl] != i)
          continue;
        const int32_t v = pack_op(cl, work<int32_t>(p, ws, kClerkSeq)[cl],
                                  work<int32_t>(p, ws, kClerkShard)[cl],
                                  work<int32_t>(p, ws, kClerkKind)[cl], ns);
        if (append(v)) shared_or(ws + p.landed + cl, 1);
      }
    }
    log_len[gi] = len;
    if (len > log_len0[gi]) work<int32_t>(p, ws, kDurableLen)[gi] = len;
    work<int32_t>(p, ws, kCompactFloor)[gi] = work<int32_t>(p, ws, kApplied)[gi];
  }
  if (tid == 0) {
    if (kMetrics) {
      worst_apply(p, ws, ws + p.worst);
      worst_apply(p, ws, ws + p.worst + nc * kWorstWords);
    }
    const int32_t viol = ws[p.viol];
    work<int32_t>(p, ws, kViolations)[0] |= viol;
    int32_t &fvt = work<int32_t>(p, ws, kFirstViolation)[0];
    if (fvt < 0 && viol != 0) fvt = tick_of(p, c);
  }
}

// Phase kLanded, a clerk a thread: the leader_wait boundary stamp of an
// op that landed at a leader this tick
__device__ __forceinline__ void landed(const Params &p, int32_t *ws, int c,
                                       int tid) {
  if (!kMetrics || tid >= p.nc) return;
  int32_t &app = work<int32_t>(p, ws, kClerkApp)[tid];
  if (ws[p.landed + tid] && work<uint8_t>(p, ws, kClerkOut)[tid] &&
      app == 0)
    app = tick_of(p, c);
}

// Thread tid of deployment c's block in phase `phase`, in mode M; pl is
// the staging plan (its copy in shared memory), ws the block's region of
// Params::words words, bar its mbarrier
template <int M>
__device__ __forceinline__ void run_phase(const Params &p, const Plan &pl,
                                          int32_t *ws, uint64_t *bar, int c,
                                          int tid, int phase) {
  switch (phase) {
    case kStage: stage<M>(p, pl, ws, bar, c, tid); break;
    case kCtrlWalk: ctrl_walk<M>(p, ws, c, tid); break;
    case kCtrlApply: ctrl_apply<M>(p, ws, c, tid); break;
    case kRestore: restore(p, ws, c, tid); break;
    case kApply: apply<M>(p, ws, c, tid); break;
    case kOracle: oracle<M>(p, ws, c, tid); break;
    case kMailbox: mailbox<M>(p, ws, c, tid); break;
    case kClerks: clerks(p, ws, c, tid); break;
    case kAppendLog: append_log(p, ws, c, tid); break;
    case kLanded: landed(p, ws, c, tid); break;
    default:
      stage::store(pl, reinterpret_cast<const unsigned char *>(ws), c, tid,
                   kThreads);
      break;
  }
}

}  // namespace k11
