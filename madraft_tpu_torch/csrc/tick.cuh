// Kernel K6's device code: raft ticks of one cluster, run by a tile of a
// warp on the cluster's state staged in shared memory, each tick's
// threefry words drawn by the tile itself. The kernel and its launch are in tick.cu,
// whose header note gives the region K6 replaces, its bound and its
// design; the Python side (kernels/tick.py) holds the tables this file's
// enums mirror and the plain version (the chunk's words drawn, step.py
// step_cluster looped).
//
// The phases follow the port's step.py step_cluster line for line, in its
// order; each comment names the lines. A cluster takes a tile of the warp
// (Tile: 16 lanes, two clusters a warp). Tile lane d is node d (n <= 16);
// the lanes also stride over the
// (dst, src) pairs of the [n, n] mailboxes and over the cap ring slots. A node's values that no other lane reads stay
// in its lane's registers for the whole chunk (Own); per-node flags other
// lanes need travel as warp ballots; __syncwarp() parts a phase's reads of
// another lane's shared values from that lane's writes. A phase that reads
// a node's values while that node's lane rewrites them (install-snapshot,
// AppendEntries) computes first, syncs, then writes. The scans over a
// node's ring (the AppendEntries hint, the compaction hash, log matching)
// take the whole tile: each lane a few slots, then a tile reduction.
//
// Shapes: the tick is a template on the node count N, the ring size CAP
// and a bound AE on ae_max; 0 means the value comes at run time. tick.cu
// instantiates the configurations the repository runs and one runtime
// instance for the rest; a template instance lays its block out for AE
// and finds each slot at a compile-time offset.
//
// Variants: two more template flags add the metrics plane (kMet: the
// submit-stamp ring beside the log, the shadow's record stamps, the
// commit-latency fold and the event counters, step.py's cfg.metrics) and
// the coverage fingerprint (kCov: after each tick the cluster's seen-set
// bit is stamped with the run-wide tick and the bit's flat index kept for
// the credit pass, credits()); tick.cu compiles each as its own build.
// In any build but a service's a trace buffer (Params::trace, null
// elsewhere) gets each tick's flight-recorder row (record(): K6-trace). A
// third parameter (kSvc) names a service tick that runs after every raft
// tick, on the same tile, with the service's leaves in the cluster's block
// for the chunk: kv's (kSvcKv, the K6-kv builds: kv.cuh's phases, the
// reference's _kv_service_tick; kv_tick()) or the shard controller's
// (kSvcCtrler, the K6-ctrler builds: ctrler.cuh's phases, the reference's
// _ctrler_service_tick; ctrler_tick()). The K6-shardkv builds
// (MADRAFT_K6_SHARDKV) run a deployment a block instead: its group
// clusters' (and controller's) raft ticks on tiles of the block, then the
// shardkv service tick of shardkv.cuh over the block (run_deployment()).
//
// Arithmetic as the reference's: int32 wraps where it wraps there (sums
// that can wrap go through uint32, the entry hash too), floor division and
// modulo where Python's apply, float32 uniforms are exact, and the float
// products and sums go through __fmul_rn / __fadd_rn so that nothing is
// contracted.

#pragma once

#include <cstdint>

#include "coverage.cuh"
#include "ctrler.cuh"
#include "kv.cuh"
#ifdef MADRAFT_K6_SHARDKV
#include "shardkv.cuh"
#endif
#include "threefry.cuh"

namespace k6 {

constexpr int kMaxNodes = 16;
constexpr int kMaxCap = 256;
constexpr int kMaxAe = 64;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBig = 1 << 30;  // sentinel above any absolute log index
constexpr int kIntMin = -2147483647 - 1;
constexpr int kFollower = 0, kCandidate = 1, kLeader = 2;
constexpr int kNoopCmd = 1 << 30;
constexpr int kViolDual = 1, kViolLogMatch = 2, kViolShadow = 4;
constexpr int kViolPrefix = 512;

// The service tick a build runs after each raft tick of a chunk (the
// template parameter kSvc): none, kv's (K6-kv) or the shard controller's
// (K6-ctrler)
enum Svc { kNoSvc, kSvcKv, kSvcCtrler };

// config.RAFT_BUGS, by index
enum Bug { kNoBug, kCommitAnyTerm, kGrantAnyVote, kForgetVotedFor,
           kNoTruncate, kAckBeforeFsync };

// Per-lane shape classes (kernels/tick.py ONE .. C); a leaf's kind adds
// kBool when it is one byte an element
enum Shape { kOne, kN, kNC, kNN, kC };
constexpr int kBool = 8;

// The leaves, in ClusterState order (kernels/tick.py LEAVES)
enum Leaf {
  L_TICK, L_TERM, L_VOTED_FOR, L_ROLE, L_TIMER, L_HB, L_ALIVE, L_LIMP,
  L_FSYNC_STALL, L_LOG_TERM, L_LOG_VAL, L_LOG_LEN, L_BASE, L_SNAP_TERM,
  L_PREFIX_HASH, L_COMMIT, L_DURABLE_LEN, L_DURABLE_TERM,
  L_DURABLE_VOTED_FOR, L_COMPACT_FLOOR, L_VOTES, L_NEXT_IDX, L_MATCH_IDX,
  L_ADJ, L_RV_REQ_T, L_RV_REQ_TERM, L_RV_REQ_LLI, L_RV_REQ_LLT, L_RV_RSP_T,
  L_RV_RSP_TERM, L_RV_RSP_GRANTED, L_AE_REQ_T, L_AE_REQ_TERM, L_AE_REQ_PREV,
  L_AE_REQ_PREV_TERM, L_AE_REQ_N, L_AE_REQ_COMMIT, L_AE_RSP_T,
  L_AE_RSP_TERM, L_AE_RSP_SUCCESS, L_AE_RSP_MATCH, L_SN_REQ_T,
  L_SN_REQ_TERM, L_SNAP_INSTALLED_SRC, L_SNAP_INSTALLED_LEN, L_NEXT_CMD,
  L_SHADOW_TERM, L_SHADOW_VAL, L_SHADOW_BASE, L_SHADOW_LEN,
  L_SHADOW_PREFIX_HASH, L_VIOLATIONS, L_FIRST_VIOLATION_TICK,
  L_FIRST_LEADER_TICK, L_MSG_COUNT, L_SNAP_INSTALL_COUNT, kLeaves
};

constexpr int kLeafKind[kLeaves] = {
    kOne, kN, kN, kN, kN, kN, kN | kBool, kN, kN, kNC, kNC, kN, kN, kN, kN,
    kN, kN, kN, kN, kN, kNN | kBool, kNN, kNN, kNN | kBool, kNN, kNN, kNN,
    kNN, kNN, kNN, kNN | kBool, kNN, kNN, kNN, kNN, kNN, kNN, kNN, kNN,
    kNN | kBool, kNN, kNN, kNN, kN, kN, kOne, kC, kC, kOne, kOne, kOne,
    kOne, kOne, kOne, kOne, kOne};

// kLeafKind four bits a leaf, sixteen to a word: device code may read
// scalar constexpr values only, so the compile-time layout reads these
constexpr uint64_t pack_kinds(int w) {
  uint64_t r = 0;
  for (int i = 0; i < 16 && 16 * w + i < kLeaves; ++i)
    r |= static_cast<uint64_t>(kLeafKind[16 * w + i]) << (4 * i);
  return r;
}
constexpr uint64_t kKinds0 = pack_kinds(0), kKinds1 = pack_kinds(1);
constexpr uint64_t kKinds2 = pack_kinds(2), kKinds3 = pack_kinds(3);
__host__ __device__ constexpr int leaf_kind(int l) {
  const uint64_t w = l < 16 ? kKinds0 : l < 32 ? kKinds1
                     : l < 48 ? kKinds2 : kKinds3;
  return static_cast<int>(w >> (4 * (l % 16)) & 15u);
}

// Scratch slots after the leaves in a cluster's shared block: the knob
// rows, what a vote request carries, a delivery's entries, the tick's
// draw words; in the metrics variant (else empty) a delivery's stamps
// (the stamp rings themselves live in device memory: Stamps)
enum Scratch {
  S_KF = kLeaves,    // float32 knobs (KNOB_F32 order)
  S_KI,              // int32 knobs (KNOB_I32 order)
  S_LLT, S_LLI,      // [n]
  S_ENT_T, S_ENT_V,  // [n, ae_max]
  S_WORDS,           // [total] u32
  S_ENT_S,           // [n, ae_max]
  kSlots
};

// The metric leaves, in ClusterState order (kernels/tick.py
// METRIC_LEAVES), and their per-lane sizes past the stamp rings
enum MetricLeaf {
  M_LOG_TICK, M_SHADOW_SUB, M_LAT_HIST, M_EV_COUNTS, M_PHASE_HIST,
  M_PHASE_TICKS, M_LAT_TICKS, M_WORST_LAT, M_WORST_PHASES, M_WORST_KEY,
  M_WORST_CLIENT, M_WORST_SUB, kMetricLeaves
};
constexpr int kHist = 16;       // config.HIST_BUCKETS
constexpr int kLatPhases = 4;   // config.LATENCY_PHASES
constexpr int kReplicate = 1;   // the phase a raft command's latency takes

// The event counters, in config.METRIC_EVENTS order
enum Event {
  E_ELECTIONS_WON, E_TERM_BUMPS, E_CRASHES, E_RESTARTS, E_RV_REQ_DELIVERED,
  E_RV_RSP_DELIVERED, E_AE_REQ_DELIVERED, E_AE_RSP_DELIVERED,
  E_SNAP_DELIVERED, E_COMMIT_ADVANCES, kEvents
};

// The delivery passes, in the trace row's order (kernels/trace.py
// DELIVERED): a node's bit of each in Own::dv
enum Delivery { DV_RV_REQ, DV_RV_RSP, DV_AE_REQ, DV_AE_RSP, DV_SNAP,
                kDeliveries };

// The trace row's width (kernels/trace.py record_width): the node rows
// role, term, commit, log_len, base, durable_len, alive and the adjacency
// masks (8n), the deliveries, the install outcomes (2n), shadow_len,
// msg_count, violations and, in the metrics variant, shadow_sub [cap],
// lat_hist, ev_counts, phase_ticks, worst_lat, worst_phases, worst_key,
// worst_client and worst_sub
__host__ __device__ constexpr int trace_width(int n, int cap, bool met) {
  return 10 * n + kDeliveries + 3 +
         (met ? cap + kHist + kEvents + 2 * kLatPhases + 4 : 0);
}
// A metric leaf's first column in the trace row, -1 for the leaves the
// row leaves out (phase_hist, lat_ticks) and the stamp rings'
__host__ __device__ constexpr int trace_col(int leaf, int n, int cap) {
  const int c = trace_width(n, cap, false) + cap;  // past shadow_sub
  return leaf == M_LAT_HIST       ? c
         : leaf == M_EV_COUNTS    ? c + kHist
         : leaf == M_PHASE_TICKS  ? c + kHist + kEvents
         : leaf == M_WORST_LAT    ? c + kHist + kEvents + kLatPhases
         : leaf == M_WORST_PHASES ? c + kHist + kEvents + kLatPhases + 1
         : leaf == M_WORST_KEY    ? c + kHist + kEvents + 2 * kLatPhases + 1
         : leaf == M_WORST_CLIENT ? c + kHist + kEvents + 2 * kLatPhases + 2
         : leaf == M_WORST_SUB    ? c + kHist + kEvents + 2 * kLatPhases + 3
                                  : -1;
}

enum KnobF { KF_LOSS_PROB, KF_P_CRASH, KF_P_RESTART, KF_P_REPARTITION,
             KF_P_HEAL, KF_P_LEADER_PART, KF_P_ASYM_CUT, KF_P_CLIENT_CMD,
             KF_P_LOSE_UNSYNCED, KF_P_LIMP, KF_P_LIMP_HEAL, KF_P_FSYNC_STALL,
             kKnobF };
enum KnobI { KI_FSYNC_EVERY, KI_ETO_MIN, KI_ETO_MAX, KI_DELAY_MIN,
             KI_DELAY_MAX, KI_HEARTBEAT_TICKS, KI_COMPACT_EVERY, KI_FLOW_CAP,
             KI_MAX_DEAD, KI_MAJORITY, KI_COMPACT_AT_COMMIT, KI_LIMP_MULT_MAX,
             KI_ETO_SKEW, KI_FSYNC_STALL_TICKS, KI_ROLLING_PERIOD,
             KI_ROLLING_DOWN, kKnobI };

// The tick's draws in _DrawBlock._take order (kernels/tick.py DRAWS)
enum Draw { D_RESTART, D_CRASH, D_RST_TMR, D_U_PART, D_COLORS, D_ASYM_DST,
            D_ASYM_OFF, D_SNAP_TMR, D_GRANT_TMR, D_RV_RSP_NET, D_AE_TMR,
            D_AE_RSP_NET, D_ELECT_TMR, D_RV_REQ_NET, D_CLIENT, D_AE_REQ_NET,
            D_SN_REQ_NET, kDraws };

// Words a draw takes at n nodes, and its offset in the tick's words (the
// launch holds these against the wrapper's draw_offsets);
// draw_offset(kDraws, n) is the tick's total, step._block_total
__host__ __device__ constexpr int draw_size(int d, int n) {
  return d == D_U_PART || d == D_ASYM_DST || d == D_ASYM_OFF ? 1
         : d == D_RV_REQ_NET || d == D_AE_REQ_NET || d == D_SN_REQ_NET
             ? n * n
             : n;
}
__host__ __device__ constexpr int draw_offset(int d, int n) {
  int o = 0;
  for (int i = 0; i < d; ++i) o += draw_size(i, n);
  return o;
}

// The template instances tick.cu compiles: (N, CAP) = (3 | 5 | 7, 16 |
// 64), each for ae_max <= kShapeAe, and in the K6-ctrler builds (5, 32),
// ctrler-fuzz's ring (kCtrlerShapes); instance 0 takes its shape at run
// time
constexpr int kShapes = 6;
constexpr int kCtrlerShapes = kShapes + 1;
constexpr int kShapeAe = 4;
__host__ __device__ constexpr int shape_n(int i) {
  return i < kShapes ? 3 + 2 * (i / 2) : 5;
}
__host__ __device__ constexpr int shape_cap(int i) {
  return i < kShapes ? (i % 2 ? 64 : 16) : 32;
}
// The instance that runs (n, cap, ae_max) in a build of `shapes`
// instances: 1 + its index, or 0
__host__ __device__ constexpr int instance(int n, int cap, int ae_max,
                                           int shapes = kShapes) {
  for (int i = 0; i < shapes; ++i)
    if (n == shape_n(i) && cap == shape_cap(i) && ae_max <= kShapeAe)
      return 1 + i;
  return 0;
}

// The profile instance's phase groups (kernels/tick.py PHASES): the lanes'
// clock64() time in each, summed over the chunk's ticks
enum Phase { P_STAGE, P_DRAWS, P_FAULTS, P_RV_RSP, P_AE_RSP, P_SNAP,
             P_RV_REQ, P_AE_REQ, P_ELECT, P_SENDS, P_COMMIT, P_ORACLE,
             P_COMPACT, kPhases };

// Per-phase clock64() sums, kept only in the profile instance, which also
// syncs the warp at each mark so that a phase's time is the warp's (its
// lanes read the clock together): tile lane `phase` sums that phase, so a
// lane holds one sum. A phase's cycles over a chunk stay far below 2^32
// (a launch takes milliseconds), so clock differences and sums are 32-bit
template <bool kOn>
struct Clock {
  unsigned last = 0u, acc = 0u;
  int lane = 0;
  __device__ __forceinline__ void start(int tile_lane) {
    if constexpr (kOn) {
      lane = tile_lane;
      last = static_cast<unsigned>(clock64());
    }
  }
  __device__ __forceinline__ void mark(int phase) {
    if constexpr (kOn) {
      __syncwarp();
      const unsigned now = static_cast<unsigned>(clock64());
      if (lane == phase) acc += now - last;
      last = now;
    }
  }
};

struct Params {
  const void *in[kLeaves];   // [B, ...] leaves of the state in
  void *out[kLeaves];        // and of the state out (may alias in)
  const int *m_in[kMetricLeaves];  // metrics: [B, ...] metric leaves in
  int *m_out[kMetricLeaves];       // and out
  const long long *keys;     // [B, 2] int64-held u32 cluster keys
  const float *kf;           // [B, kKnobF]
  const int *ki;             // [B, kKnobI]
  int kind[kLeaves];         // each leaf's kind (kLeafKind)
  int off[kSlots];           // byte offset of each slot in a cluster block
  int draw[kDraws];          // offset of each draw in a tick's words
  int b, n, cap, ae_max, m, bug, total, cluster_bytes;
  int partitionable;         // the threefry counter layout (prng)
  unsigned one;              // 1, unknown to the compiler (threefry.cuh)
  // coverage: seen [rows, bits] first-tick stamps, fp [m, B] each
  // lane-tick's flat seen index (-1: violated), rows [B] each cluster's
  // seen-set row (null: row 0), t0 the run-wide tick of the chunk's first
  int *seen, *fp;
  const int *rows;
  int bits, levels_r, levels_c, identity, t0;
  unsigned alphabet;
  // metrics: spare stamp rows [n * cap + cap] for a tile that holds no
  // cluster (Stamps)
  int *spare;
  // K6-trace (null on every other path): rows [m, B, trace_w], each
  // tick's flight-recorder row
  int *trace;
  int trace_w;
  // A service build's side (set_service; unset elsewhere): the service
  // leaves, its knobs, its shape and its region, which starts svc_off
  // bytes into a cluster's block, after K6's slots
  union {
    k9::Side kv;       // K6-kv (kv.cuh Side)
    k10::Side ctrler;  // K6-ctrler (ctrler.cuh Side)
  };
  int svc_off;
};

__host__ __device__ constexpr int shape_elems(int kind, int n, int cap) {
  switch (kind & 7) {
    case kOne: return 1;
    case kN: return n;
    case kNC: return n * cap;
    case kNN: return n * n;
    default: return cap;
  }
}

// A cluster block's layout: slot s's bytes, 16-byte aligned, and its
// offset; ae is the delivery entries' row length (ae_max, or the template
// instance's bound), met whether the metrics variant's slots are there
__host__ __device__ constexpr int slot_bytes(int s, int n, int cap, int ae,
                                            bool met) {
  if (s < kLeaves) {
    const int e = shape_elems(leaf_kind(s), n, cap);
    return ((leaf_kind(s) & kBool ? e : 4 * e) + 15) & ~15;
  }
  const int e = s == S_KF           ? kKnobF
                : s == S_KI         ? kKnobI
                : s == S_WORDS      ? draw_offset(kDraws, n)
                : s == S_ENT_S      ? (met ? n * ae : 0)
                : s >= S_ENT_T      ? n * ae
                                    : n;
  return (4 * e + 15) & ~15;
}
__host__ __device__ constexpr int slot_offset(int s, int n, int cap, int ae,
                                              bool met) {
  int o = 0;
  for (int i = 0; i < s; ++i) o += slot_bytes(i, n, cap, ae, met);
  return o;
}
// Slot S's offset in a template instance's block, fixed at compile time
template <int N, int CAP, int AE, bool MET, int S>
inline constexpr int kSlotOffset = slot_offset(S, N, CAP, AE, MET);

// Fills off with every slot's offset; returns the block's bytes
inline int layout(int n, int cap, int ae, bool met, int *off) {
  for (int s = 0; s < kSlots; ++s) off[s] = slot_offset(s, n, cap, ae, met);
  return slot_offset(kSlots, n, cap, ae, met);
}

// Fills p's shape, layout (entry rows of ae_layout; the metrics variant's
// slots when met) and draw table for (n, cap, ae_max) from the wrapper's
// draw offsets; false if they are not this file's
inline bool set_shape(Params &p, int n, int cap, int ae_max, int ae_layout,
                      bool met, const int *draws) {
  for (int i = 0; i < kDraws; ++i) {
    if (draws[i] != draw_offset(i, n)) return false;
    p.draw[i] = draws[i];
  }
  p.n = n;
  p.cap = cap;
  p.ae_max = ae_max;
  p.total = draw_offset(kDraws, n);
  p.cluster_bytes = layout(n, cap, ae_layout, met, p.off);
  return true;
}

// Fills p's metric leaves from mptrs (the kMetricLeaves in, then out,
// then the spare stamp rows) and coverage arguments from cov (seen, fp,
// rows or 0, bits, levels_r, levels_c, alphabet, identity, t0), each null
// when the build has no such variant; false if the coverage arguments are
// out of range
inline bool set_variant(Params &p, const int64_t *mptrs, const int64_t *cov) {
  for (int l = 0; l < kMetricLeaves; ++l) {
    p.m_in[l] = mptrs ? reinterpret_cast<const int *>(mptrs[l]) : nullptr;
    p.m_out[l] =
        mptrs ? reinterpret_cast<int *>(mptrs[kMetricLeaves + l]) : nullptr;
  }
  p.spare =
      mptrs ? reinterpret_cast<int *>(mptrs[2 * kMetricLeaves]) : nullptr;
  p.seen = cov ? reinterpret_cast<int *>(cov[0]) : nullptr;
  p.fp = cov ? reinterpret_cast<int *>(cov[1]) : nullptr;
  p.rows = cov ? reinterpret_cast<const int *>(cov[2]) : nullptr;
  p.bits = cov ? static_cast<int>(cov[3]) : 1;
  p.levels_r = cov ? static_cast<int>(cov[4]) : 1;
  p.levels_c = cov ? static_cast<int>(cov[5]) : 1;
  p.alphabet = cov ? static_cast<unsigned>(cov[6]) : 1u;
  p.identity = cov ? static_cast<int>(cov[7]) : 0;
  p.t0 = cov ? static_cast<int>(cov[8]) : 0;
  return !cov || (p.bits > 0 && !(p.bits & (p.bits - 1)) && p.t0 >= 0);
}

// Fills p's trace rows (null: none) of width w; false if w is not the
// row's width at p's shape (set_shape first)
inline bool set_trace(Params &p, void *trace, int w, bool met) {
  p.trace = static_cast<int *>(trace);
  p.trace_w = w;
  return !trace || w == trace_width(p.n, p.cap, met);
}

// Fills p's service side from its descriptor of n_svc words (kv.cuh or
// ctrler.cuh set_side; null in the other builds) for the build's service
// svc, after set_shape and set_trace: the service's region goes after
// K6's slots in a cluster's block. False where the build and the
// descriptor disagree, for a descriptor the build does not take, or with
// a trace buffer (a service build writes no trace rows)
inline bool set_service(Params &p, const int64_t *desc, int n_svc, int part,
                        bool met, int svc) {
  p.svc_off = p.cluster_bytes;
  if ((desc != nullptr) != (svc != kNoSvc)) return false;
  if (svc == kNoSvc) return true;
  if (p.trace) return false;
  int words = 0;
  if (svc == kSvcKv) {
    if (!k9::set_side(p.kv, desc, n_svc, p.n, p.cap, part, met) ||
        (met && p.kv.d.hb != kHist))
      return false;
    words = p.kv.L.words;
  } else {
    if (!k10::set_side(p.ctrler, desc, n_svc, p.n, p.cap, part, met) ||
        (met && p.ctrler.d.hb != kHist))
      return false;
    words = p.ctrler.L.words;
  }
  p.cluster_bytes += (4 * words + 15) & ~15;
  return true;
}

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
// a + b with int32 wrap-around
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int pmod(int a, int m) {  // Python's a % m
  const int r = a % m;
  return r < 0 ? r + m : r;
}
__device__ __forceinline__ int fdiv(int a, int m) {  // Python's a // m, m > 0
  const int q = a / m;
  return q * m != a && a < 0 ? q - 1 : q;
}

// u32 word -> exact float32 uniform in [0, 1) from bits 8..31
__device__ __forceinline__ float u01(uint32_t w) {
  return static_cast<float>(w >> 8) * 5.9604644775390625e-08f;
}
// Bernoulli(p) from the free low byte of an already-consumed word
__device__ __forceinline__ bool bern8(uint32_t w, float p) {
  return static_cast<float>(w & 0xffu) * 0.00390625f < p;
}
// lo + floor(u01 * (hi - lo)) with a float32 product (step.randint_w)
__device__ __forceinline__ int randint(uint32_t w, int lo, int hi) {
  const float span = static_cast<float>(hi - lo);
  return lo + static_cast<int>(floorf(__fmul_rn(u01(w), span)));
}
// lo + floor(low_byte / 256 * span) in u32 arithmetic (step._randint8)
__device__ __forceinline__ int randint8(uint32_t w, int lo, int span) {
  const uint32_t s = span < 0 ? 0u : static_cast<uint32_t>(span);
  return lo + static_cast<int>(((w & 0xffu) * s) >> 8);
}
// A send's loss and delay from one word (step._net_draws): bits 8..31
// decide the loss, the low byte the delay by multiply-shift over a span
// clamped to 1..256
__device__ __forceinline__ bool lost(uint32_t w, const float *kf) {
  return u01(w) < kf[KF_LOSS_PROB];
}
__device__ __forceinline__ int net_delay(uint32_t w, const int *ki) {
  const int span =
      imin(imax(ki[KI_DELAY_MAX] + 1 - ki[KI_DELAY_MIN], 1), 256);
  return ki[KI_DELAY_MIN] + static_cast<int>(((w & 0xffu) * span) >> 8);
}
// Canonical ring lane of absolute (1-based) index: (a - 1) mod cap
__device__ __forceinline__ int slot(int a, int cap) {
  return (a - 1) & (cap - 1);
}
// Absolute index ring lane k holds for a window anchored at base
__device__ __forceinline__ int lane_abs(int base, int k, int cap) {
  return base + ((k - base) & (cap - 1)) + 1;
}
// The reference's _entry_mix: int32 multiplies that wrap
__device__ __forceinline__ int entry_mix(int term, int val, int abs_idx) {
  uint32_t h = (static_cast<uint32_t>(val) ^
                (static_cast<uint32_t>(abs_idx) * 0x9E3779B9u)) * 0x85EBCA6Bu;
  return static_cast<int>(h ^ (static_cast<uint32_t>(term) * 0xC2B2AE35u));
}
__device__ __forceinline__ bool bit(unsigned m, int i) { return m >> i & 1u; }
// t - sub with int32 wrap-around
__device__ __forceinline__ int wsub(int t, int sub) {
  return static_cast<int>(static_cast<uint32_t>(t) -
                          static_cast<uint32_t>(sub));
}
// A latency's histogram bucket: the count of edges 2^1 .. 2^15 at or below
// it (metrics.bucket_of)
__device__ __forceinline__ int bucket_of(int lat) {
  return lat < 2 ? 0 : imin(31 - __clz(lat), kHist - 1);
}

// Lanes a cluster takes: two clusters a warp (16 and 8 lanes ran alike at
// the flagship, 16 with the shorter chain and fewer registers: PERF.md
// §6); every n <= kMaxNodes fits
constexpr int kTile = 16;

// A cluster's lanes: TILE consecutive lanes of the warp (kTile; the tile
// code also serves a whole-warp TILE). The warp's
// collectives run on all 32 lanes at once and each tile takes its part:
// its bits of a ballot or a match, a shuffle from its own lanes, a
// reduction over its lanes (one REDUX for a whole-warp tile, else a
// butterfly of shuffles that stays inside the tile)
template <int TILE>
struct Tile {
  static constexpr unsigned kMask =
      TILE == kWarp ? kFull : (1u << TILE) - 1u;
  int lane;  // in the tile
  int base;  // the tile's first lane in the warp
  __device__ __forceinline__ unsigned ballot(bool pred) const {
    return __ballot_sync(kFull, pred) >> base & kMask;
  }
  // true when pred holds on any lane of the warp (a loop every tile steps)
  __device__ __forceinline__ bool any_lane(bool pred) const {
    return __ballot_sync(kFull, pred) != 0u;
  }
  template <typename T>
  __device__ __forceinline__ T shfl(T v, int j) const {
    return __shfl_sync(kFull, v, base + j);
  }
  __device__ __forceinline__ unsigned match(uint64_t key) const {
    return __match_any_sync(kFull, key) >> base & kMask;
  }
  template <typename F>
  __device__ __forceinline__ int fold(int v, F f) const {
#pragma unroll
    for (int m = TILE / 2; m; m >>= 1) v = f(v, __shfl_xor_sync(kFull, v, m));
    return v;
  }
  __device__ __forceinline__ int min(int v) const {
    if constexpr (TILE == kWarp) return __reduce_min_sync(kFull, v);
    else return fold(v, [](int a, int b) { return a < b ? a : b; });
  }
  __device__ __forceinline__ int max(int v) const {
    if constexpr (TILE == kWarp) return __reduce_max_sync(kFull, v);
    else return fold(v, [](int a, int b) { return a > b ? a : b; });
  }
  __device__ __forceinline__ int sum(int v) const {
    if constexpr (TILE == kWarp) return __reduce_add_sync(kFull, v);
    else return fold(v, [](int a, int b) { return wadd(a, b); });
  }
  __device__ __forceinline__ int any_bits(int v) const {
    if constexpr (TILE == kWarp)
      return static_cast<int>(
          __reduce_or_sync(kFull, static_cast<unsigned>(v)));
    else return fold(v, [](int a, int b) { return a | b; });
  }
  __device__ __forceinline__ int xor_all(int v) const {
    if constexpr (TILE == kWarp)
      return static_cast<int>(
          __reduce_xor_sync(kFull, static_cast<unsigned>(v)));
    else return fold(v, [](int a, int b) { return a ^ b; });
  }
};

// One cluster's block in shared memory: a slot's address by its runtime
// offset (I, B, F), or by a compile-time one in a template instance (the
// free I<S>, B<S>, F<S>, U<S>, which then read no parameter); MET_ lays
// out the metrics variant's slots
template <int N_, int CAP_, int AE_, bool MET_ = false>
struct Block {
  const Params &p;
  uint8_t *cl;
  __device__ int *I(int slot) const {
    return reinterpret_cast<int *>(cl + p.off[slot]);
  }
  __device__ uint8_t *B(int slot) const { return cl + p.off[slot]; }
  __device__ float *F(int slot) const {
    return reinterpret_cast<float *>(cl + p.off[slot]);
  }
  template <int S>
  __device__ __forceinline__ uint8_t *at() const {
    if constexpr (N_ > 0)
      return cl + kSlotOffset<N_, CAP_, AE_, MET_, S>;
    else
      return cl + p.off[S];
  }
  // A service build's region, after the slots
  __device__ __forceinline__ int32_t *svc() const {
    if constexpr (N_ > 0)
      return reinterpret_cast<int32_t *>(
          cl + kSlotOffset<N_, CAP_, AE_, MET_, kSlots>);
    else
      return reinterpret_cast<int32_t *>(cl + p.svc_off);
  }
};
template <int S, typename Blk>
__device__ __forceinline__ int *I(const Blk &s) {
  return reinterpret_cast<int *>(s.template at<S>());
}
template <int S, typename Blk>
__device__ __forceinline__ uint8_t *B(const Blk &s) {
  return s.template at<S>();
}
template <int S, typename Blk>
__device__ __forceinline__ float *F(const Blk &s) {
  return reinterpret_cast<float *>(s.template at<S>());
}
template <int S, typename Blk>
__device__ __forceinline__ uint32_t *U(const Blk &s) {
  return reinterpret_cast<uint32_t *>(s.template at<S>());
}

// Stage the cluster's leaves and knob rows in (load) or, for a tile that
// holds a cluster (active), its leaves out; TILE lanes stride the rows
template <int TILE, typename Blk>
__device__ void stage(const Params &p, const Blk &s, int b, int lane,
                      bool load, bool active) {
  for (int l = 0; l < kLeaves; ++l) {
    const int e = shape_elems(p.kind[l], p.n, p.cap);
    const size_t row = static_cast<size_t>(b) * e;
    if (p.kind[l] & kBool) {
      uint8_t *sh = s.B(l);
      if (load) {
        const uint8_t *g = static_cast<const uint8_t *>(p.in[l]) + row;
        for (int i = lane; i < e; i += TILE) sh[i] = g[i];
      } else if (active) {
        uint8_t *g = static_cast<uint8_t *>(p.out[l]) + row;
        for (int i = lane; i < e; i += TILE) g[i] = sh[i];
      }
    } else {
      int *sh = s.I(l);
      if (load) {
        const int *g = static_cast<const int *>(p.in[l]) + row;
        for (int i = lane; i < e; i += TILE) sh[i] = g[i];
      } else if (active) {
        int *g = static_cast<int *>(p.out[l]) + row;
        for (int i = lane; i < e; i += TILE) g[i] = sh[i];
      }
    }
  }
  if (load) {
    for (int i = lane; i < kKnobF; i += TILE)
      s.F(S_KF)[i] = p.kf[static_cast<size_t>(b) * kKnobF + i];
    for (int i = lane; i < kKnobI; i += TILE)
      s.I(S_KI)[i] = p.ki[static_cast<size_t>(b) * kKnobI + i];
  }
  __syncwarp();
}

// A node's values that only its own lane reads, in that lane's registers
// for the chunk; votes as a bit per voter
struct Own {
  int voted_for = 0, timer = 0, hb = 0, durable_len = 0, durable_term = 0;
  int durable_voted_for = 0, fsync_stall = 0, compact_floor = 0;
  unsigned votes = 0u;
  unsigned dv = 0u;  // the passes that delivered to the node this tick
};

// The metrics variant's stamp rings in device memory, so that the shared
// block holds 32 clusters an SM at n = 5, cap = 64: the cluster's rows of
// the log_tick [n, cap] and shadow_sub [cap] leaves out (log_tick filled
// from the state in at the chunk's start, shadow_sub written whole by the
// oracle every tick), or the launch's spare rows for a tile that holds no
// cluster (in K6-shardkv's builds the rows of the deployment's copy
// tile). Replication, the no-op and injections write log_tick; the
// shadow's walk reads it and writes shadow_sub, which the fold reads
// back. A lane reads another's writes only across a __syncwarp, which
// orders them in device memory as in shared
struct Stamps {
  const Params &p;
  int b;        // the cluster
  bool active;  // the tile holds it
#ifdef MADRAFT_K6_SHARDKV
  int *spare;   // the copy tile's rows (ShardKvParams::spare)
#endif
  // the rows' addresses, computed where they are used (held for the
  // chunk they would take four registers)
  __device__ __forceinline__ int *spare_rows() const {
#ifdef MADRAFT_K6_SHARDKV
    return spare;
#else
    return p.spare;
#endif
  }
  __device__ __forceinline__ int *log_tick() const {
    return active ? p.m_out[M_LOG_TICK] + static_cast<size_t>(b) * p.n * p.cap
                  : spare_rows();
  }
  __device__ __forceinline__ int *shadow_sub() const {
    return active ? p.m_out[M_SHADOW_SUB] + static_cast<size_t>(b) * p.cap
                  : spare_rows() + p.n * p.cap;
  }
};

// The metrics plane's sums over a chunk, in a lane's registers (the
// metrics variant): its node's event counts, its ring slots' acks and
// their latencies' sum, the tile's acks in histogram bucket `lane` (lanes
// below kHist), and the worst-op register, the same on the tile's lanes.
// A node counts each event at most once a tick, so a count fits 16 bits
// in a launch of up to kMaxMetricTicks ticks: two to a register
constexpr int kMaxMetricTicks = 65535;
struct Meter {
  unsigned ev2[(kEvents + 1) / 2] = {};
  int acked = 0, lat_sum = 0, hist = 0;
  int worst_lat = 0, worst_sub = 0;
  bool worst_new = false;  // the register changed in this chunk
  __device__ __forceinline__ void add(int e, int x) {
    ev2[e / 2] += static_cast<unsigned>(x) << (16 * (e % 2));
  }
  __device__ __forceinline__ int ev(int e) const {
    return static_cast<int>(ev2[e / 2] >> (16 * (e % 2)) & 0xffffu);
  }
};

template <typename Blk>
__device__ void own_load(const Blk &s, Own &o, int d, int n) {
  o.voted_for = I<L_VOTED_FOR>(s)[d];
  o.timer = I<L_TIMER>(s)[d];
  o.hb = I<L_HB>(s)[d];
  o.durable_len = I<L_DURABLE_LEN>(s)[d];
  o.durable_term = I<L_DURABLE_TERM>(s)[d];
  o.durable_voted_for = I<L_DURABLE_VOTED_FOR>(s)[d];
  o.fsync_stall = I<L_FSYNC_STALL>(s)[d];
  o.compact_floor = I<L_COMPACT_FLOOR>(s)[d];
  o.votes = 0u;
  for (int j = 0; j < n; ++j)
    o.votes |= static_cast<unsigned>(B<L_VOTES>(s)[d * n + j] != 0) << j;
}

template <typename Blk>
__device__ void own_store(const Blk &s, const Own &o, int d, int n) {
  I<L_VOTED_FOR>(s)[d] = o.voted_for;
  I<L_TIMER>(s)[d] = o.timer;
  I<L_HB>(s)[d] = o.hb;
  I<L_DURABLE_LEN>(s)[d] = o.durable_len;
  I<L_DURABLE_TERM>(s)[d] = o.durable_term;
  I<L_DURABLE_VOTED_FOR>(s)[d] = o.durable_voted_for;
  I<L_FSYNC_STALL>(s)[d] = o.fsync_stall;
  I<L_COMPACT_FLOOR>(s)[d] = o.compact_floor;
  for (int j = 0; j < n; ++j) B<L_VOTES>(s)[d * n + j] = bit(o.votes, j);
}

// The keys of a chunk's ticks: at tick i of the chunk, tick t (as u32),
// and every TILE ticks, tile lane l derives the key of tick t + l
// (fold_in(fold_in(key, t), 0)) from cluster b's key, and a shuffle hands
// tick i's key to the tile's lanes. A service build (kSvc) keeps
// fold_in(key, t + l) too, the key the service tick's draws fold their
// sites into (svc)
template <int TILE, bool kSvc = false>
struct TickKeys {
  uint32_t k0 = 0u, k1 = 0u;
  uint32_t f0 = 0u, f1 = 0u;  // kSvc: fold_in(key, t + lane)
  __device__ __forceinline__ void get(const Params &p, int b, int i,
                                      uint32_t t, const Tile<TILE> &tile,
                                      uint32_t &tk0, uint32_t &tk1) {
    if ((i & (TILE - 1)) == 0) {
      k0 = static_cast<uint32_t>(p.keys[2 * static_cast<size_t>(b)]);
      k1 = static_cast<uint32_t>(p.keys[2 * static_cast<size_t>(b) + 1]);
      if constexpr (kSvc) {
        madraft::fold_in(k0, k1, t + static_cast<uint32_t>(tile.lane));
        f0 = k0;
        f1 = k1;
        madraft::fold_in(k0, k1, 0u);
      } else {
        madraft::tick_key(k0, k1, t + static_cast<uint32_t>(tile.lane));
      }
    }
    tk0 = tile.shfl(k0, i & (TILE - 1));
    tk1 = tile.shfl(k1, i & (TILE - 1));
  }
  // kSvc: tick i's fold_in(key, t), after get
  __device__ __forceinline__ void svc(int i, const Tile<TILE> &tile,
                                      uint32_t &s0, uint32_t &s1) const {
    s0 = tile.shfl(f0, i & (TILE - 1));
    s1 = tile.shfl(f1, i & (TILE - 1));
  }
};

// The tick's draw words under its key (k0, k1), the tile's lanes taking
// the counter pairs in turn (threefry.tick_blocks_plain's layouts):
// partitionable, pair j = (0, j) gives word j = y0 ^ y1; legacy, pair j =
// (j, j + h) gives words j and j + h, h = ceil(total / 2)
template <int N_, int TILE>
__device__ __forceinline__ void draw_words(const Params &p, uint32_t *w,
                                           uint32_t k0, uint32_t k1,
                                           int lane) {
  const int total = N_ ? draw_offset(kDraws, N_) : p.total;
  const uint32_t one = p.one;
  if (p.partitionable) {
#pragma unroll
    for (int j0 = 0; j0 < total; j0 += TILE) {
      const int j = j0 + lane;
      if (j < total) {
        uint32_t x0 = 0u, x1 = static_cast<uint32_t>(j);
        madraft::threefry2x32(k0, k1, x0, x1, one);
        w[j] = x0 ^ x1;
      }
    }
  } else {
    const int h = (total + 1) / 2;
#pragma unroll
    for (int j0 = 0; j0 < h; j0 += TILE) {
      const int j = j0 + lane;
      if (j < h) {
        const bool hi = j + h < total;
        uint32_t x0 = static_cast<uint32_t>(j);
        uint32_t x1 = hi ? static_cast<uint32_t>(j + h) : 0u;
        madraft::threefry2x32(k0, k1, x0, x1, one);
        w[j] = x0;
        if (hi) w[j + h] = x1;
      }
    }
  }
}

// The picked source of mailbox row d: among the messages due now at a
// live dst over a usable link (and, for install-snapshot, from a live
// src), the one whose tick-rotated rank (src + t) mod n is least; -1 if
// none (step.py pick_one)
__device__ __forceinline__ int pick_src(const int *mail_t, const uint8_t *adj,
                                        unsigned alive, int d, int n, int t,
                                        bool src_alive) {
  if (!bit(alive, d)) return -1;
  int best = -1, best_rank = n;
  for (int s = 0; s < n; ++s) {
    if (mail_t[d * n + s] != t || !adj[d * n + s]) continue;
    if (src_alive && !bit(alive, s)) continue;
    const int rank = pmod(wadd(s, t), n);
    if (rank < best_rank) best_rank = rank, best = s;
  }
  return best;
}

// The term of absolute index a at node d (snap_term at the boundary)
__device__ __forceinline__ int term_at(const int *log_term,
                                       const int *snap_term, const int *base,
                                       int d, int a, int cap) {
  return a <= base[d] ? snap_term[d] : log_term[d * cap + slot(a, cap)];
}

// The oracle's ring checks at a shape a template instance knows, over the
// lane's ring slots: log matching over each unordered pair's overlap
// (kViolLogMatch) and the commit shadow's walk (kViolShadow), the shadow
// slid to new_base and the entries that slid out folded into xh. Each
// slot's entries of every node are loaded once, and the slot's checks are
// selects, not branches. A pair violates iff some lane's least mismatch
// is at most the tile's greatest term match (both as ring offsets 1..CAP
// from node i's base: an overlap index of the pair lies in (base_i,
// base_i + CAP]), so each pair takes one maximum over the tile
template <int N, int CAP, int TILE, bool kMet, typename Blk>
__device__ __forceinline__ int ring_checks(const Blk &s,
                                           const Tile<TILE> &tile, int sb,
                                           int sl0, int new_base, int &xh,
                                           const Stamps &st) {
  constexpr int kPairs = N * (N - 1) / 2;
  const int lane = tile.lane;
  const int *log_term = I<L_LOG_TERM>(s), *log_val = I<L_LOG_VAL>(s);
  int *sht = I<L_SHADOW_TERM>(s), *sv = I<L_SHADOW_VAL>(s);
  int bs[N], ls[N], cs[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    bs[i] = I<L_BASE>(s)[i];
    ls[i] = I<L_LOG_LEN>(s)[i];
    cs[i] = I<L_COMMIT>(s)[i];
  }
  int max_tm[kPairs], min_bad[kPairs];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) max_tm[q] = 0, min_bad[q] = kBig;
  bool shadow_bad = false;
#pragma unroll
  for (int k0 = 0; k0 < CAP; k0 += TILE) {
    const int k = k0 + lane;
    if (k >= CAP) continue;
    int a[N], lt_i[N], lv_i[N];
    bool in[N];  // the slot's index is in node i's log
#pragma unroll
    for (int i = 0; i < N; ++i) {
      a[i] = lane_abs(bs[i], k, CAP);
      in[i] = a[i] <= ls[i];
      lt_i[i] = log_term[i * CAP + k];
      lv_i[i] = log_val[i * CAP + k];
    }
    int q = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r = a[i] - bs[i];  // 1..CAP
#pragma unroll
      for (int j = i + 1; j < N; ++j, ++q) {
        const bool both = a[i] == a[j] && in[i] && in[j];
        const bool t_eq = lt_i[i] == lt_i[j];
        max_tm[q] = both && t_eq ? imax(max_tm[q], r) : max_tm[q];
        min_bad[q] = both && !(t_eq && lv_i[i] == lv_i[j])
                         ? imin(min_bad[q], r)
                         : min_bad[q];
      }
    }
    const int old_abs = lane_abs(sb, k, CAP);
    int lt = sht[k], lv = sv[k];
    if (old_abs <= imin(new_base, sl0)) xh ^= entry_mix(lt, lv, old_abs);
    const int sh_abs = lane_abs(new_base, k, CAP);
    int sl = sl0, src = -1;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool at = sh_abs == a[i];
      shadow_bad |= at && sh_abs <= imin(cs[i], sl) &&
                    (lt != lt_i[i] || lv != lv_i[i]);
      const bool take = at && sh_abs > sl && sh_abs <= cs[i];
      lt = take ? lt_i[i] : lt;
      lv = take ? lv_i[i] : lv;
      src = take ? i : src;  // a later node's winning
      sl = imax(sl, cs[i]);
    }
    sht[k] = lt;
    sv[k] = lv;
    if constexpr (kMet)  // the record's stamp: the winning node's
      st.shadow_sub()[k] = src >= 0 ? st.log_tick()[src * CAP + k] : 0;
  }
  int viol = shadow_bad ? kViolShadow : 0;
#pragma unroll
  for (int q = 0; q < kPairs; ++q)
    if (min_bad[q] <= tile.max(max_tm[q])) viol |= kViolLogMatch;
  return viol;
}

// A service build's region row of a metric leaf: m counts from lat_hist in
// the order both services hold them (SvcMetric), after the service's own
// leaves; the clerks' folds add to the sums there and the worst-op
// register lives there for the chunk (metric_rows writes them out)
enum SvcMetric { SM_LAT_HIST, SM_PHASE_HIST, SM_PHASE_TICKS, SM_LAT_TICKS,
                 SM_WORST_LAT, SM_WORST_PHASES, SM_WORST_KEY,
                 SM_WORST_CLIENT, SM_WORST_SUB, kSvcMetrics };
static_assert(k9::kWorstSub - k9::kLatHist == SM_WORST_SUB &&
                  k10::kWorstSub - k10::kLatHist == SM_WORST_SUB,
              "the services' metric leaves in SvcMetric order");
template <int kSvc>
__device__ __forceinline__ int32_t *svc_metric(const Params &p, int32_t *svc,
                                               int m) {
  if constexpr (kSvc == kSvcKv)
    return svc + p.kv.leaf[k9::kLatHist + m].off;
  else
    return svc + p.ctrler.leaf[k10::kLatHist + m].off;
}

// The tick's commit-latency fold (step.py 663-690; K4's function, which
// the eager tick launches), on the shadow's record stamps the oracle just
// wrote (in device memory, Stamps): each ring slot with a stamp sub > 0
// acks an op of latency t - sub
// (int32 wrap). Each lane sums its slots' acks and latencies; a slot's
// histogram bucket goes to the lane of that bucket by a shuffle per acked
// slot; the worst-op candidate is the argmax over the slots of (acked ?
// latency : -1), the lowest slot on ties (a maximum over the tile, then
// the least slot that holds it), and it replaces the register when it is
// greater or the register is empty (worst_sub 0). A warp with no ack this
// tick only scans its slots. In a service build (kSvc) the register is
// the service region's rows (svc), where the service's clerks fold into
// it too: every lane reads it, then tile lane 0 writes the candidate that
// wins
template <int CAP_, int TILE, int kSvc = kNoSvc>
__device__ void fold(const Params &p, const Stamps &st,
                     const Tile<TILE> &tile, int t, Meter &mt,
                     int32_t *svc = nullptr) {
  const int cap = CAP_ ? CAP_ : p.cap, lane = tile.lane;
  const int *ss = st.shadow_sub();
  int best = kIntMin, best_k = kBig;  // best_k kBig: the lane has no slot
  bool mine = false;
#pragma unroll
  for (int k0 = 0; k0 < cap; k0 += TILE) {
    const int k = k0 + lane;
    if (k >= cap) continue;
    const int sub = ss[k];
    const int lat = wsub(t, sub);
    const int key = sub > 0 ? lat : -1;
    if (best_k == kBig || key > best) best = key, best_k = k;
    if (sub > 0) {
      mine = true;
      ++mt.acked;
      mt.lat_sum = wadd(mt.lat_sum, lat);
    }
  }
  if (!tile.any_lane(mine)) return;  // the whole warp together
  const bool any = tile.ballot(mine) != 0u;
  const int top = tile.max(best);
  const int at = tile.min(best == top ? best_k : kBig);
  if constexpr (kSvc != kNoSvc) {
    auto row = [&](int m) { return svc_metric<kSvc>(p, svc, m); };
    const int cand = any ? wsub(t, ss[at]) : 0;
    const bool better =
        any && (cand > row(SM_WORST_LAT)[0] || row(SM_WORST_SUB)[0] == 0);
    __syncwarp();  // the register is read
    if (better && lane == 0) {
      row(SM_WORST_LAT)[0] = cand;
      row(SM_WORST_SUB)[0] = ss[at];
      row(SM_WORST_KEY)[0] = -1;
      row(SM_WORST_CLIENT)[0] = -1;
      for (int q = 0; q < kLatPhases; ++q)
        row(SM_WORST_PHASES)[q] = q == kReplicate ? cand : 0;
    }
  } else if (any) {
    const int cand = wsub(t, ss[at]);
    if (cand > mt.worst_lat || mt.worst_sub == 0) {
      mt.worst_lat = cand;
      mt.worst_sub = ss[at];
      mt.worst_new = true;
    }
  }
#pragma unroll
  for (int k0 = 0; k0 < cap; k0 += TILE) {
    const int k = k0 + lane;
    const int sub = k < cap ? ss[k] : 0;
    const int bk = sub > 0 ? bucket_of(wsub(t, sub)) : 0;
    for (unsigned pend = tile.ballot(sub > 0); tile.any_lane(pend != 0u);
         pend &= pend - 1u) {
      const int j = pend ? __ffs(pend) - 1 : 0;
      const int bj = tile.shfl(bk, j);
      if (pend && lane == bj) ++mt.hist;
    }
  }
}

// One tick of the cluster (step.py step_cluster, with cfg.metrics as kMet)
// under the tick's key (tk0, tk1); alive is the warp's mask of live nodes,
// carried from tick to tick; st the metrics variant's stamp rings; kSvc
// a service build's (the worst-op register in the service's region)
template <int N_, int CAP_, int AE_, int TILE, bool kProf, bool kMet,
          int kSvc = kNoSvc>
__device__ void tick(const Params &p, const Block<N_, CAP_, AE_, kMet> &s,
                     const Stamps &st, Own &o, Meter &mt, unsigned &alive,
                     const Tile<TILE> &tile, Clock<kProf> &clk, uint32_t tk0,
                     uint32_t tk1) {
  const int lane = tile.lane;
  const int n = N_ ? N_ : p.n, cap = CAP_ ? CAP_ : p.cap;
  // ae_lim bounds the entry loops; ent is the entry rows' stride
  const int ae_max = p.ae_max, ae_lim = AE_ ? AE_ : p.ae_max, ent = ae_lim;
  const int nn = n * n;
  uint32_t *w = U<S_WORDS>(s);
  auto word = [&](int draw, int i) {
    return w[(N_ ? draw_offset(draw, N_) : p.draw[draw]) + i];
  };
  const float *kf = F<S_KF>(s);
  const int *ki = I<S_KI>(s);
  int *term = I<L_TERM>(s), *role = I<L_ROLE>(s);
  int *limp = I<L_LIMP>(s);
  int *log_term = I<L_LOG_TERM>(s), *log_val = I<L_LOG_VAL>(s);
  int *log_len = I<L_LOG_LEN>(s), *base = I<L_BASE>(s);
  int *snap_term = I<L_SNAP_TERM>(s), *prefix_hash = I<L_PREFIX_HASH>(s);
  int *commit = I<L_COMMIT>(s);
  uint8_t *adj = B<L_ADJ>(s);
  int *next_idx = I<L_NEXT_IDX>(s), *match_idx = I<L_MATCH_IDX>(s);
  const int t = wadd(I<L_TICK>(s)[0], 1);
  const int me = lane, d = lane;  // a node lane's node
  const bool node = lane < n;
  const int skew = me * ki[KI_ETO_SKEW];
  o.dv = 0u;
  // the event counters' baselines, taken before the suffix-loss rollback
  [[maybe_unused]] const int term0 = node ? term[d] : 0;
  [[maybe_unused]] const int commit0 = node ? commit[d] : 0;

  // -------------------------------------------------- the tick's words
  draw_words<N_, TILE>(p, w, tk0, tk1, lane);
  __syncwarp();
  clk.mark(P_DRAWS);

  // ---------------------------------------------- faults (step.py 198-271)
  bool restart = false;
  {
    const unsigned was = alive;
    bool crash_bern = false, down = false;
    if (node) {
      const int period = ki[KI_ROLLING_PERIOD];
      bool up = false;
      if (period > 0) {  // the rolling wave (its divisions) only when on
        const int wave = fdiv(t, period);
        const int wave_i = wadd(wave, -pmod(wadd(wave, -me), n));
        const int age = static_cast<int>(
            static_cast<uint32_t>(t) -
            static_cast<uint32_t>(wave_i) * static_cast<uint32_t>(period));
        const bool sched = wave_i >= 0;
        down = sched && age < ki[KI_ROLLING_DOWN];
        up = sched && age == ki[KI_ROLLING_DOWN];
      }
      restart = !bit(was, d) &&
                ((u01(word(D_RESTART, d)) < kf[KF_P_RESTART] && !down) || up);
      crash_bern = bit(was, d) && u01(word(D_CRASH, d)) < kf[KF_P_CRASH];
    }
    const unsigned restart_m = tile.ballot(restart);
    const unsigned crash_m = tile.ballot(crash_bern);
    bool now = false, crash = false, lead_pre = false;
    if (node) {
      const unsigned nodes = (1u << n) - 1u;
      const int dead = __popc(nodes & ~was & ~restart_m);
      const int cum = __popc(crash_m & ((2u << d) - 1u));
      crash = (crash_bern && cum <= ki[KI_MAX_DEAD] - dead) ||
              (bit(was, d) && down);
      now = (bit(was, d) || restart) && !crash;
      lead_pre = now && role[d] == kLeader;  // the tick-start role
      if constexpr (kMet) {
        mt.add(E_CRASHES, crash);
        mt.add(E_RESTARTS, restart);
      }
    }
    alive = tile.ballot(now);
    const unsigned lead_pre_m = tile.ballot(lead_pre);
    if (node) {
      B<L_ALIVE>(s)[d] = now;
      if (restart) role[d] = kFollower;
      if (p.bug == kForgetVotedFor && restart) o.voted_for = -1;
      const uint32_t w_restart = word(D_RESTART, d);
      const uint32_t w_crash = word(D_CRASH, d);
      const uint32_t w_rst_tmr = word(D_RST_TMR, d);
      if (restart) {
        o.timer =
            randint(w_rst_tmr, ki[KI_ETO_MIN], ki[KI_ETO_MAX] + 1) + skew;
        o.hb = 0;
        commit[d] = base[d];
        o.compact_floor = base[d];
        o.votes = 0u;
        for (int j = 0; j < n; ++j) {
          next_idx[d * n + j] = 1;
          match_idx[d * n + j] = 0;
        }
      }
      // limping nodes (222-232): draws from the free low bytes
      const int mult_max = ki[KI_LIMP_MULT_MAX];
      const bool limp_on =
          now && mult_max >= 2 && bern8(w_crash, kf[KF_P_LIMP]);
      if (restart)
        limp[d] = 1;
      else if (limp_on)
        limp[d] = randint8(w_restart, 2, mult_max - 1);
      else if (bern8(w_rst_tmr, kf[KF_P_LIMP_HEAL]))
        limp[d] = 1;
      // lossy persistence (267-271)
      if (crash && bern8(word(D_COLORS, d), kf[KF_P_LOSE_UNSYNCED])) {
        term[d] = o.durable_term;
        o.voted_for = o.durable_voted_for;
        log_len[d] = o.durable_len;
      }
    }
    // partitions (240-265): one mutually exclusive event a tick
    const float u_part = u01(word(D_U_PART, 0));
    const int asym_dst = randint(word(D_ASYM_DST, 0), 0, n);
    const int asym_off = randint(word(D_ASYM_OFF, 0), 1, n);
    const float th1 = kf[KF_P_REPARTITION];
    const float th2 = __fadd_rn(th1, kf[KF_P_HEAL]);
    const float th3 = __fadd_rn(th2, kf[KF_P_LEADER_PART]);
    const float th4 = __fadd_rn(th3, kf[KF_P_ASYM_CUT]);
    const bool do_part = u_part < th1;
    const bool do_heal = !do_part && u_part < th2;
    const bool do_lpart = u_part >= th2 && u_part < th3 && lead_pre_m != 0u;
    const int lid = lead_pre_m ? __ffs(lead_pre_m) - 1 : 0;
    const int lid1 = lid + 1 == n ? 0 : lid + 1;
    const bool do_asym = u_part >= th3 && u_part < th4;
    const int cut_src = (asym_dst + asym_off) % n;
    for (int q = lane; q < nn; q += TILE) {
      const int dst = q / n, src = q - dst * n;
      bool a;
      if (do_part) {
        a = (u01(word(D_COLORS, dst)) < 0.5f) ==
            (u01(word(D_COLORS, src)) < 0.5f);
      } else if (do_heal) {
        a = true;
      } else if (do_lpart) {
        a = (dst == lid || dst == lid1) == (src == lid || src == lid1);
      } else {
        a = adj[q] && !(do_asym && dst == asym_dst && src == cut_src);
      }
      adj[q] = a || dst == src;
    }
  }
  __syncwarp();
  clk.mark(P_FAULTS);

  // Deliveries: up to install-snapshot's sync each lane reads and rewrites
  // only its own mailbox rows and its own node

  // ------------------------------- deliver: RV responses (step.py 311-330)
  if (node) {
    int *mail = I<L_RV_RSP_T>(s);
    const int ps = pick_src(mail, adj, alive, d, n, t, false);
    for (int j = 0; j < n; ++j) {
      const int v = mail[d * n + j];
      const bool ok = bit(alive, d) && v == t && adj[d * n + j];
      mail[d * n + j] = ok && j != ps ? wadd(t, 1) : v <= t ? 0 : v;
    }
    if (ps >= 0) {
      o.dv |= 1u << DV_RV_RSP;
      if constexpr (kMet) mt.add(E_RV_RSP_DELIVERED, 1);
      const int mterm = I<L_RV_RSP_TERM>(s)[d * n + ps];
      if (mterm > term[d]) {
        term[d] = mterm;
        role[d] = kFollower;
        o.voted_for = -1;
      }
      if (B<L_RV_RSP_GRANTED>(s)[d * n + ps] && role[d] == kCandidate &&
          mterm == term[d])
        o.votes |= 1u << ps;
    }
  }
  clk.mark(P_RV_RSP);

  // ------------------------------- deliver: AE responses (step.py 332-359)
  if (node) {
    int *mail = I<L_AE_RSP_T>(s);
    const int ps = pick_src(mail, adj, alive, d, n, t, false);
    for (int j = 0; j < n; ++j) {
      const int v = mail[d * n + j];
      const bool ok = bit(alive, d) && v == t && adj[d * n + j];
      mail[d * n + j] = ok && j != ps ? wadd(t, 1) : v <= t ? 0 : v;
    }
    if (ps >= 0) {
      o.dv |= 1u << DV_AE_RSP;
      if constexpr (kMet) mt.add(E_AE_RSP_DELIVERED, 1);
      const int q = d * n + ps;
      const int mterm = I<L_AE_RSP_TERM>(s)[q];
      if (mterm > term[d]) {
        term[d] = mterm;
        role[d] = kFollower;
        o.voted_for = -1;
      }
      if (role[d] == kLeader && mterm == term[d]) {
        const int m = I<L_AE_RSP_MATCH>(s)[q];
        if (B<L_AE_RSP_SUCCESS>(s)[q]) {
          match_idx[q] = imax(match_idx[q], m);
          next_idx[q] = imax(next_idx[q], m + 1);
        } else {
          next_idx[q] = imax(imin(next_idx[q], m + 1), 1);
        }
      }
    }
  }
  clk.mark(P_AE_RSP);

  // ------------------------- deliver: install-snapshot (step.py 361-395)
  {
    int ps = -1, slen = 0, sterm = 0, shash = 0;
    bool inst = false, keep = false;
    if (node) {
      int *mail = I<L_SN_REQ_T>(s);
      ps = pick_src(mail, adj, alive, d, n, t, true);
      for (int j = 0; j < n; ++j) {
        const int v = mail[d * n + j];
        const bool ok =
            bit(alive, d) && v == t && adj[d * n + j] && bit(alive, j);
        mail[d * n + j] = ok && j != ps ? wadd(t, 1) : v == t ? 0 : v;
      }
      if (ps >= 0) {
        o.dv |= 1u << DV_SNAP;
        if constexpr (kMet) mt.add(E_SNAP_DELIVERED, 1);
        const int mterm = I<L_SN_REQ_TERM>(s)[d * n + ps];
        if (mterm > term[d]) {
          term[d] = mterm;
          role[d] = kFollower;
          o.voted_for = -1;
        }
        const bool acc = mterm == term[d];
        if (acc && role[d] == kCandidate) role[d] = kFollower;
        if (acc)
          o.timer = randint(word(D_SNAP_TMR, d), ki[KI_ETO_MIN],
                            ki[KI_ETO_MAX] + 1) + skew;
        slen = base[ps];
        sterm = snap_term[ps];
        shash = prefix_hash[ps];
        inst = acc && slen > commit[d];
        keep = inst && log_len[d] > slen &&
               term_at(log_term, snap_term, base, d, slen, cap) == sterm;
      }
    }
    __syncwarp();  // the sources' base, snap_term and prefix_hash are read
    if (node) {
      if (inst) {
        if (!keep) log_len[d] = slen;
        base[d] = slen;
        snap_term[d] = sterm;
        prefix_hash[d] = shash;
        commit[d] = imax(commit[d], slen);
        o.compact_floor = slen;
        o.durable_len = log_len[d];
        o.durable_term = term[d];
        o.durable_voted_for = o.voted_for;
        atomicAdd(I<L_SNAP_INSTALL_COUNT>(s), 1);  // int32 wrap
      }
      I<L_SNAP_INSTALLED_SRC>(s)[d] = inst ? ps : -1;
      I<L_SNAP_INSTALLED_LEN>(s)[d] = inst ? slen : 0;
    }
  }
  clk.mark(P_SNAP);

  // ------------------------------ deliver: RV requests (step.py 400-437)
  if (node) {
    int *mail = I<L_RV_REQ_T>(s);
    const int ps = pick_src(mail, adj, alive, d, n, t, false);
    for (int j = 0; j < n; ++j) {
      const int v = mail[d * n + j];
      const bool ok = bit(alive, d) && v == t && adj[d * n + j];
      mail[d * n + j] = ok && j != ps ? wadd(t, 1) : v == t ? 0 : v;
    }
    if (ps >= 0) {
      o.dv |= 1u << DV_RV_REQ;
      if constexpr (kMet) mt.add(E_RV_REQ_DELIVERED, 1);
      const int q = d * n + ps;
      const int mterm = I<L_RV_REQ_TERM>(s)[q];
      if (mterm > term[d]) {
        term[d] = mterm;
        role[d] = kFollower;
        o.voted_for = -1;
      }
      const int my_llt = log_len[d] > base[d]
                             ? log_term[d * cap + slot(log_len[d], cap)]
                             : snap_term[d];
      const int cand_llt = I<L_RV_REQ_LLT>(s)[q];
      const int cand_lli = I<L_RV_REQ_LLI>(s)[q];
      const bool log_ok = p.bug == kGrantAnyVote || cand_llt > my_llt ||
                          (cand_llt == my_llt && cand_lli >= log_len[d]);
      const bool grant = mterm == term[d] &&
                         (o.voted_for == -1 || o.voted_for == ps) && log_ok;
      if (grant) {
        o.voted_for = ps;
        o.timer = randint(word(D_GRANT_TMR, d), ki[KI_ETO_MIN],
                          ki[KI_ETO_MAX] + 1) + skew;
      }
      if (p.bug != kAckBeforeFsync) {
        o.durable_term = term[d];
        o.durable_voted_for = o.voted_for;
        o.durable_len = log_len[d];
      }
      // the vote goes back in slot [candidate, voter], in a row the
      // candidate's lane read before install-snapshot's sync
      const uint32_t wn = word(D_RV_RSP_NET, d);
      if (!lost(wn, kf)) {
        const int r = ps * n + d;
        I<L_RV_RSP_T>(s)[r] = wadd(t, net_delay(wn, ki) * limp[d]);
        I<L_RV_RSP_TERM>(s)[r] = term[d];
        B<L_RV_RSP_GRANTED>(s)[r] = grant;
      }
    }
  }
  __syncwarp();  // the installed snapshots are written
  clk.mark(P_RV_REQ);

  // ------------------------------ deliver: AE requests (step.py 439-551)
  {
    int ps = -1, prev = 0, nent = 0, batch_end = 0, ae_commit = 0;
    bool success = false, conflict = false;
    uint64_t in_batch = 0;
    if (node) {
      int *mail = I<L_AE_REQ_T>(s);
      ps = pick_src(mail, adj, alive, d, n, t, false);
      for (int j = 0; j < n; ++j) {
        const int v = mail[d * n + j];
        const bool ok = bit(alive, d) && v == t && adj[d * n + j];
        mail[d * n + j] = ok && j != ps ? wadd(t, 1) : v == t ? 0 : v;
      }
      if (ps >= 0) {
        o.dv |= 1u << DV_AE_REQ;
        if constexpr (kMet) mt.add(E_AE_REQ_DELIVERED, 1);
        const int q = d * n + ps;
        const int mterm = I<L_AE_REQ_TERM>(s)[q];
        if (mterm > term[d]) {
          term[d] = mterm;
          role[d] = kFollower;
          o.voted_for = -1;
        }
        const bool acc = mterm == term[d];
        if (acc && role[d] == kCandidate) role[d] = kFollower;
        if (acc)
          o.timer = randint(word(D_AE_TMR, d), ki[KI_ETO_MIN],
                            ki[KI_ETO_MAX] + 1) + skew;
        prev = I<L_AE_REQ_PREV>(s)[q];
        const int mprev_term = I<L_AE_REQ_PREV_TERM>(s)[q];
        const int len = log_len[d], my_base = base[d];
        success = acc && prev <= len &&
                  (prev <= my_base ||
                   term_at(log_term, snap_term, base, d, prev, cap) ==
                       mprev_term);
        // the picked sender's log, base and length at delivery
        const int src_base = base[ps], src_len = log_len[ps];
        const int cur_prev_term = prev == src_base
                                      ? snap_term[ps]
                                      : log_term[ps * cap + slot(prev, cap)];
        const bool still = src_base <= prev && prev <= src_len &&
                           cur_prev_term == mprev_term;
        nent = still ? imin(imax(imin(I<L_AE_REQ_N>(s)[q], src_len - prev), 0),
                            ae_max)
                     : 0;
        int first_conf = kBig;
#pragma unroll
        for (int e = 0; e < ae_lim; ++e) {
          if (e >= ae_max) break;
          const int a = prev + e + 1;
          bool inb = success && e < nent && a > my_base && a <= my_base + cap;
          if (p.bug == kNoTruncate) inb = inb && a > len;
          const int k = slot(a, cap);
          const int et = log_term[ps * cap + k];
          I<S_ENT_T>(s)[d * ent + e] = et;
          I<S_ENT_V>(s)[d * ent + e] = log_val[ps * cap + k];
          if constexpr (kMet)  // the submit stamp replicates with the entry
            I<S_ENT_S>(s)[d * ent + e] = st.log_tick()[ps * cap + k];
          if (inb) {
            in_batch |= uint64_t{1} << e;
            if (a <= len && log_term[d * cap + k] != et) {
              conflict = true;
              first_conf = imin(first_conf, a);
            }
          }
        }
        if (conflict)
          o.durable_len = imin(o.durable_len, first_conf - 1);
        // ring overflow: drop the tail
        batch_end = imin(prev + nent, my_base + cap);
        ae_commit = I<L_AE_REQ_COMMIT>(s)[q];
      }
    }
    __syncwarp();  // the senders' logs are read
    if (node && ps >= 0) {
#pragma unroll
      for (int e = 0; e < ae_lim; ++e) {
        if (e >= ae_max) break;
        if (!(in_batch >> e & 1)) continue;
        const int k = slot(prev + e + 1, cap);
        log_term[d * cap + k] = I<S_ENT_T>(s)[d * ent + e];
        log_val[d * cap + k] = I<S_ENT_V>(s)[d * ent + e];
        if constexpr (kMet)
          st.log_tick()[d * cap + k] = I<S_ENT_S>(s)[d * ent + e];
      }
      if (success) {
        log_len[d] = conflict ? batch_end : imax(log_len[d], batch_end);
        commit[d] = imax(commit[d], imin(ae_commit, batch_end));
      }
    }
    __syncwarp();  // the receivers' logs are written
    // failure hint for fast backtracking (term skip), which only a failed
    // append sends: the first index of the conflicting term in the
    // receiver's ring, the warp scanning the ring of each receiver that
    // needs one
    const bool scan = node && ps >= 0 && !success && prev <= log_len[d];
    const int conf_term =
        scan ? term_at(log_term, snap_term, base, d, prev, cap) : 0;
    int hint = node && ps >= 0 ? log_len[d] : 0;
    // every tile steps while any has a receiver left (the shuffles and
    // reductions run on the whole warp)
    for (unsigned pend = tile.ballot(scan); tile.any_lane(pend != 0u);
         pend &= pend - 1u) {
      const int j = pend ? __ffs(pend) - 1 : 0;
      const int ct = tile.shfl(conf_term, j);
      const int bj = base[j], lj = log_len[j];
      int first_abs = kBig;
#pragma unroll
      for (int k0 = 0; k0 < cap; k0 += TILE) {
        const int k = k0 + lane;
        if (k < cap) {
          const int a = lane_abs(bj, k, cap);
          if (a <= lj && log_term[j * cap + k] == ct)
            first_abs = imin(first_abs, a);
        }
      }
      first_abs = tile.min(first_abs);
      if (pend && lane == j)
        hint = imax(first_abs < kBig ? first_abs - 1 : bj, bj);
    }
    __syncwarp();  // the receivers' rings are read
    if (node && ps >= 0) {
      const int rsp_match = success ? batch_end : hint;
      if (p.bug != kAckBeforeFsync) {
        o.durable_len = log_len[d];
        o.durable_term = term[d];
        o.durable_voted_for = o.voted_for;
      }
      // keep-oldest: an occupied response slot keeps its message
      const uint32_t wn = word(D_AE_RSP_NET, d);
      const int r = ps * n + d;
      if (!lost(wn, kf) && I<L_AE_RSP_T>(s)[r] == 0) {
        I<L_AE_RSP_T>(s)[r] = wadd(t, net_delay(wn, ki) * limp[d]);
        I<L_AE_RSP_TERM>(s)[r] = term[d];
        B<L_AE_RSP_SUCCESS>(s)[r] = success;
        I<L_AE_RSP_MATCH>(s)[r] = rsp_match;
      }
    }
  }
  clk.mark(P_AE_REQ);

  // ------- election win, timers, client injection, heartbeat (553-612)
  bool fired = false, inject = false, lead = false, fire_hb = false;
  if (node) {
    if (bit(alive, d) && role[d] == kCandidate &&
        __popc(o.votes) >= ki[KI_MAJORITY]) {
      role[d] = kLeader;
      if constexpr (kMet) mt.add(E_ELECTIONS_WON, 1);
      for (int j = 0; j < n; ++j) {
        next_idx[d * n + j] = log_len[d] + 1;
        match_idx[d * n + j] = 0;
      }
      o.hb = 0;
      if (log_len[d] - base[d] < cap) {  // the current-term no-op
        const int k = slot(log_len[d] + 1, cap);
        log_term[d * cap + k] = term[d];
        log_val[d * cap + k] = kNoopCmd;
        if constexpr (kMet) st.log_tick()[d * cap + k] = 0;  // not a client op
        o.durable_len = ++log_len[d];
      }
    }
    // election timeout (568-579)
    const bool running = bit(alive, d) && role[d] != kLeader;
    if (running) --o.timer;
    fired = running && o.timer <= 0;
    if (fired) {
      ++term[d];
      role[d] = kCandidate;
      o.voted_for = me;
      o.votes = 1u << d;
      o.timer = randint(word(D_ELECT_TMR, d), ki[KI_ETO_MIN],
                        ki[KI_ETO_MAX] + 1) + skew;
      o.durable_term = term[d];
      o.durable_voted_for = o.voted_for;
      o.durable_len = log_len[d];
    }
    I<S_LLI>(s)[d] = log_len[d];  // what a vote request carries: pre-inject
    I<S_LLT>(s)[d] = log_len[d] > base[d]
                        ? log_term[d * cap + slot(log_len[d], cap)]
                        : snap_term[d];
    // client command injection at leaders (592-607)
    lead = bit(alive, d) && role[d] == kLeader;
    inject = lead && u01(word(D_CLIENT, d)) < kf[KF_P_CLIENT_CMD] &&
             log_len[d] - base[d] < cap &&
             log_len[d] - commit[d] < ki[KI_FLOW_CAP];
    if (inject) {
      const int k = slot(log_len[d] + 1, cap);
      log_term[d * cap + k] = term[d];
      log_val[d * cap + k] = I<L_NEXT_CMD>(s)[0] * n + me + 1;
      if constexpr (kMet) st.log_tick()[d * cap + k] = t;  // submitted now
      o.durable_len = ++log_len[d];
    }
    // heartbeat (610-612)
    if (lead) --o.hb;
    fire_hb = lead && o.hb <= 0;
    if (fire_hb) o.hb = ki[KI_HEARTBEAT_TICKS];
  }
  const unsigned fired_m = tile.ballot(fired);
  const unsigned lead_m = tile.ballot(lead);
  const unsigned fire_hb_m = tile.ballot(fire_hb);
  const bool any_inject = tile.ballot(inject) != 0u;
  __syncwarp();  // the candidates' and leaders' values are written
  clk.mark(P_ELECT);

  // ------------- sends per (dst, src): vote requests (584-590), append
  // entries and install-snapshot from leaders (613-643)
  for (int q = lane; q < nn; q += TILE) {
    const int dst = q / n, src = q - dst * n;
    const bool link = dst != src && adj[q];
    uint32_t wn = word(D_RV_REQ_NET, q);
    if (bit(fired_m, src) && link && !lost(wn, kf)) {
      I<L_RV_REQ_T>(s)[q] = wadd(t, net_delay(wn, ki) * limp[src]);
      I<L_RV_REQ_TERM>(s)[q] = term[src];
      I<L_RV_REQ_LLI>(s)[q] = I<S_LLI>(s)[src];
      I<L_RV_REQ_LLT>(s)[q] = I<S_LLT>(s)[src];
    }
    const int r = src * n + dst;  // the leader's next index for dst
    const int next_t = next_idx[r];
    const bool need_snap = next_t <= base[src];
    const int prev_m = next_t - 1;
    wn = word(D_AE_REQ_NET, q);
    const bool pending = bit(lead_m, src) && next_t <= log_len[src];
    if ((bit(fire_hb_m, src) || pending) && link && !lost(wn, kf) &&
        !need_snap && I<L_AE_REQ_T>(s)[q] == 0) {
      I<L_AE_REQ_T>(s)[q] = wadd(t, net_delay(wn, ki) * limp[src]);
      I<L_AE_REQ_TERM>(s)[q] = term[src];
      I<L_AE_REQ_PREV>(s)[q] = prev_m;
      I<L_AE_REQ_PREV_TERM>(s)[q] =
          prev_m > base[src] ? log_term[src * cap + slot(prev_m, cap)]
                             : snap_term[src];
      I<L_AE_REQ_N>(s)[q] = imin(imax(log_len[src] - prev_m, 0), ae_max);
      I<L_AE_REQ_COMMIT>(s)[q] = commit[src];
    }
    wn = word(D_SN_REQ_NET, q);
    if (bit(fire_hb_m, src) && link && !lost(wn, kf) && need_snap &&
        I<L_SN_REQ_T>(s)[q] == 0) {
      I<L_SN_REQ_T>(s)[q] = wadd(t, net_delay(wn, ki) * limp[src]);
      I<L_SN_REQ_TERM>(s)[q] = term[src];
      next_idx[r] = base[src] + 1;
    }
  }
  if (lane == 0) I<L_NEXT_CMD>(s)[0] += any_inject;
  __syncwarp();  // the leaders' commits are read
  clk.mark(P_SENDS);

  // ---------------------------------- commit advance (step.py 645-658)
  if (node && bit(lead_m, d)) {
    // the rank-th largest of the row, log_len on the diagonal
    const int rank = imin(imax(ki[KI_MAJORITY] - 1, 0), n - 1);
    int kth = 0;
    for (int j = 0; j < n; ++j) {
      const int v = j == d ? log_len[d] : match_idx[d * n + j];
      int pos = 0;
      for (int i = 0; i < n; ++i) {
        const int u = i == d ? log_len[d] : match_idx[d * n + i];
        pos += u > v || (u == v && i < j);
      }
      if (pos == rank) kth = v;
    }
    const bool ok = kth > base[d] &&
                    (p.bug == kCommitAnyTerm ||
                     term_at(log_term, snap_term, base, d, kth, cap) ==
                         term[d]);
    if (ok) commit[d] = imax(commit[d], kth);
  }
  __syncwarp();
  clk.mark(P_COMMIT);

  // -------------------------------- oracle (step.py 660-667; oracle.py)
  {
    int viol = 0, xh = 0;
    {
      // two live leaders in one term; two live nodes at one snapshot
      // boundary with other prefix hashes. A match gives the tile's lanes
      // holding the same key; a lane out of the check holds a key no
      // node's can equal
      const uint64_t other = (uint64_t{1} << 32) | static_cast<uint32_t>(lane);
      const bool lead_d = node && bit(alive, d) && role[d] == kLeader;
      const unsigned same_term = tile.match(
          lead_d ? static_cast<uint64_t>(static_cast<uint32_t>(term[d]))
                 : other);
      if (lead_d && __popc(same_term) > 1) viol |= kViolDual;
      const bool snap_d = node && bit(alive, d) && base[d] > 0;
      const uint64_t b64 = static_cast<uint32_t>(snap_d ? base[d] : 0);
      const unsigned same_base = tile.match(snap_d ? b64 : other);
      const unsigned same_hash = tile.match(
          snap_d ? b64 << 32 | static_cast<uint32_t>(prefix_hash[d])
                 : static_cast<uint64_t>(lane));
      if (snap_d && (same_base & ~same_hash) != 0u) viol |= kViolPrefix;
      if (snap_d && base[d] == I<L_SHADOW_BASE>(s)[0] &&
          prefix_hash[d] != I<L_SHADOW_PREFIX_HASH>(s)[0])
        viol |= kViolPrefix;
    }
    // commit durability: slide the shadow window, fold what slid out, then
    // walk the nodes in order over each ring lane; log matching over each
    // unordered pair's ring overlap
    const int sb = I<L_SHADOW_BASE>(s)[0], sl0 = I<L_SHADOW_LEN>(s)[0];
    int need = 0, sl = sl0;
    for (int j = 0; j < n; ++j) {
      if (bit(alive, j)) need = imax(need, commit[j]);
      sl = imax(sl, commit[j]);
    }
    const int new_base = imax(sb, need - cap);
    if constexpr (N_ > 0 && CAP_ > 0) {
      viol |= ring_checks<N_, CAP_, TILE, kMet>(s, tile, sb, sl0, new_base,
                                                xh, st);
    } else {
      // the runtime shape: each lane a few ring slots, the pair's least
      // mismatch and greatest term match reduced over the warp
      for (int i = 0; i < n; ++i) {
        const int bi = base[i], li = log_len[i];
        for (int j = i + 1; j < n; ++j) {
          const int bj = base[j], lj = log_len[j];
          int min_bad = kBig, max_tm = 0;
          for (int k = lane; k < cap; k += TILE) {
            const int a = lane_abs(bi, k, cap);
            if (a == lane_abs(bj, k, cap) && a <= li && a <= lj) {
              const bool t_eq = log_term[i * cap + k] == log_term[j * cap + k];
              const bool v_eq = log_val[i * cap + k] == log_val[j * cap + k];
              if (t_eq) max_tm = imax(max_tm, a);
              if (!(t_eq && v_eq)) min_bad = imin(min_bad, a);
            }
          }
          min_bad = tile.min(min_bad);
          max_tm = tile.max(max_tm);
          if (min_bad <= max_tm) viol |= kViolLogMatch;
        }
      }
      int *sht = I<L_SHADOW_TERM>(s), *sv = I<L_SHADOW_VAL>(s);
      for (int k = lane; k < cap; k += TILE) {
        const int old_abs = lane_abs(sb, k, cap);
        if (old_abs <= imin(new_base, sl0))
          xh ^= entry_mix(sht[k], sv[k], old_abs);
        const int sh_abs = lane_abs(new_base, k, cap);
        int lt = sht[k], lv = sv[k], slw = sl0, src = -1;
        for (int i = 0; i < n; ++i) {
          const int c = commit[i];
          if (sh_abs == lane_abs(base[i], k, cap)) {
            const int it = log_term[i * cap + k], iv = log_val[i * cap + k];
            if (sh_abs <= imin(c, slw) && (lt != it || lv != iv))
              viol |= kViolShadow;
            if (sh_abs > slw && sh_abs <= c) lt = it, lv = iv, src = i;
          }
          slw = imax(slw, c);
        }
        sht[k] = lt;
        sv[k] = lv;
        if constexpr (kMet)
          st.shadow_sub()[k] = src >= 0 ? st.log_tick()[src * cap + k] : 0;
      }
    }
    viol = tile.any_bits(viol);
    xh = tile.xor_all(xh);
    __syncwarp();  // the old shadow scalars are read
    if (lane == 0) {
      I<L_SHADOW_BASE>(s)[0] = new_base;
      I<L_SHADOW_LEN>(s)[0] = sl;
      I<L_SHADOW_PREFIX_HASH>(s)[0] ^= xh;
      I<L_VIOLATIONS>(s)[0] |= viol;
      int *fvt = I<L_FIRST_VIOLATION_TICK>(s), *flt = I<L_FIRST_LEADER_TICK>(s);
      if (fvt[0] < 0 && viol != 0) fvt[0] = t;
      if (flt[0] < 0 && lead_m != 0u) flt[0] = t;
    }
  }
  __syncwarp();
  if constexpr (kMet) fold<CAP_, TILE, kSvc>(p, st, tile, t, mt, s.svc());
  clk.mark(P_ORACLE);

  // ------------------ compaction (691-705), background fsync (707-722)
  {
    int boundary = 0;
    bool compact = false;
    if (node) {
      boundary = ki[KI_COMPACT_AT_COMMIT]
                     ? commit[d]
                     : imin(o.compact_floor, commit[d]);
      compact = bit(alive, d) && boundary - base[d] >= ki[KI_COMPACT_EVERY];
    }
    // the prefix hash of each compacting node's cut, the warp over its ring
    int h = 0;
    for (unsigned pend = tile.ballot(compact); tile.any_lane(pend != 0u);
         pend &= pend - 1u) {
      const int j = pend ? __ffs(pend) - 1 : 0;
      const int bd = tile.shfl(boundary, j);
      const int bj = base[j];
      int x = 0;
#pragma unroll
      for (int k0 = 0; k0 < cap; k0 += TILE) {
        const int k = k0 + lane;
        if (k < cap) {
          const int a = lane_abs(bj, k, cap);
          if (a <= bd)
            x ^= entry_mix(log_term[j * cap + k], log_val[j * cap + k], a);
        }
      }
      x = tile.xor_all(x);
      if (pend && lane == j) h = x;
    }
    __syncwarp();  // the rings and bases are read
    if (node) {
      if (compact) {
        const int snap = term_at(log_term, snap_term, base, d, boundary, cap);
        prefix_hash[d] ^= h;
        snap_term[d] = snap;
        base[d] = boundary;
        o.durable_len = imax(o.durable_len, boundary);
      }
      const bool stall_on = bit(alive, d) && ki[KI_FSYNC_STALL_TICKS] >= 1 &&
                            bern8(word(D_SNAP_TMR, d), kf[KF_P_FSYNC_STALL]);
      if (restart)
        o.fsync_stall = 0;
      else if (stall_on)
        o.fsync_stall =
            randint8(word(D_GRANT_TMR, d), 1, ki[KI_FSYNC_STALL_TICKS]);
      else
        o.fsync_stall = imax(o.fsync_stall - 1, 0);
      if (bit(alive, d) && wadd(t, me) % ki[KI_FSYNC_EVERY] == 0 &&
          o.fsync_stall == 0) {
        o.durable_len = log_len[d];
        o.durable_term = term[d];
        o.durable_voted_for = o.voted_for;
      }
    }
  }
  if constexpr (kMet) {
    if (node) {
      mt.add(E_TERM_BUMPS, term[d] > term0);
      mt.add(E_COMMIT_ADVANCES, commit[d] > commit0);
    }
  }
  if (o.dv) atomicAdd(I<L_MSG_COUNT>(s), __popc(o.dv));  // int32 wrap
  if (lane == 0) I<L_TICK>(s)[0] = t;
  __syncwarp();  // the tick's words and scalars are read
  clk.mark(P_COMPACT);
}

// The metrics variant's stamp rings for cluster b on a tile: log_tick
// filled from the state in
template <int TILE>
__device__ void stamps_load(const Stamps &st, int lane) {
  const int nc = st.p.n * st.p.cap;
  const int *g = st.p.m_in[M_LOG_TICK] + static_cast<size_t>(st.b) * nc;
  int *lt = st.log_tick();
  for (int i = lane; i < nc; i += TILE) lt[i] = g[i];
  __syncwarp();
}

// The chunk's metric registers so far: each register leaf of cluster b is
// its input plus the chunk's sums (int32 wrap, as the eager tick's), or,
// for the worst op, the register the chunk left. A replicate-phase
// latency is the whole latency and the other phases fold zeros (bucket
// 0), so each phase row's mass is the acked count (step.py 666-685).
// out(leaf, i, v) takes element i of cluster b's row of the leaf; the
// tile's lanes all call this (its sums are tile reductions), and only a
// tile that holds a cluster (active) writes. A service build (kSvc) adds
// the service region svc's sums of the clerks' folds, and its worst-op
// register is the region's
template <int TILE, int kSvc = kNoSvc, typename Out>
__device__ void metric_rows(const Params &p, int b, bool active,
                            const Tile<TILE> &tile, const Meter &mt,
                            Out out, int32_t *svc = nullptr) {
  const int lane = tile.lane;
  int ev = 0;
#pragma unroll
  for (int e = 0; e < kEvents; ++e) {
    const int sum = tile.sum(mt.ev(e));
    if (lane == e) ev = sum;
  }
  const int acked = tile.sum(mt.acked), lat_sum = tile.sum(mt.lat_sum);
  if (!active) return;
  const size_t c = b;
  auto in = [&](int leaf, int size, int i) {
    return p.m_in[leaf][c * size + i];
  };
  // the service region's row of a metric leaf
  auto svc_row = [&](int m) { return svc_metric<kSvc>(p, svc, m); };
  constexpr bool kOn = kSvc != kNoSvc;
  if (lane < kHist) {
    int lh = wadd(in(M_LAT_HIST, kHist, lane), mt.hist);
    if constexpr (kOn) lh = wadd(lh, svc_row(SM_LAT_HIST)[lane]);
    out(M_LAT_HIST, lane, lh);
    for (int ph = 0; ph < kLatPhases; ++ph) {
      const int i = ph * kHist + lane;
      int add = ph == kReplicate ? mt.hist : lane == 0 ? acked : 0;
      if constexpr (kOn) add = wadd(add, svc_row(SM_PHASE_HIST)[i]);
      out(M_PHASE_HIST, i, wadd(in(M_PHASE_HIST, kLatPhases * kHist, i),
                                add));
    }
  }
  if (lane < kEvents)
    out(M_EV_COUNTS, lane, wadd(in(M_EV_COUNTS, kEvents, lane), ev));
  if (lane < kLatPhases) {
    int pt = lane == kReplicate ? lat_sum : 0;
    if constexpr (kOn) pt = wadd(pt, svc_row(SM_PHASE_TICKS)[lane]);
    out(M_PHASE_TICKS, lane, wadd(in(M_PHASE_TICKS, kLatPhases, lane), pt));
    if constexpr (kOn)
      out(M_WORST_PHASES, lane, svc_row(SM_WORST_PHASES)[lane]);
    else
      out(M_WORST_PHASES, lane,
          mt.worst_new ? (lane == kReplicate ? mt.worst_lat : 0)
                       : in(M_WORST_PHASES, kLatPhases, lane));
  }
  if (lane == 0) {
    int lt = lat_sum;
    if constexpr (kOn) lt = wadd(lt, svc_row(SM_LAT_TICKS)[0]);
    out(M_LAT_TICKS, 0, wadd(in(M_LAT_TICKS, 1, 0), lt));
    if constexpr (kOn) {
      out(M_WORST_LAT, 0, svc_row(SM_WORST_LAT)[0]);
      out(M_WORST_KEY, 0, svc_row(SM_WORST_KEY)[0]);
      out(M_WORST_CLIENT, 0, svc_row(SM_WORST_CLIENT)[0]);
      out(M_WORST_SUB, 0, svc_row(SM_WORST_SUB)[0]);
    } else {
      out(M_WORST_LAT, 0,
          mt.worst_new ? mt.worst_lat : in(M_WORST_LAT, 1, 0));
      out(M_WORST_KEY, 0, mt.worst_new ? -1 : in(M_WORST_KEY, 1, 0));
      out(M_WORST_CLIENT, 0, mt.worst_new ? -1 : in(M_WORST_CLIENT, 1, 0));
      out(M_WORST_SUB, 0,
          mt.worst_new ? mt.worst_sub : in(M_WORST_SUB, 1, 0));
    }
  }
}

// The chunk's metric registers out, into the metric leaves out (a
// service build: with the service region svc's)
template <int TILE, int kSvc = kNoSvc>
__device__ void write_metrics(const Params &p, int b, bool active,
                              const Tile<TILE> &tile, const Meter &mt,
                              int32_t *svc = nullptr) {
  const int per[kMetricLeaves] = {0, 0, kHist, kEvents, kLatPhases * kHist,
                                  kLatPhases, 1, 1, kLatPhases, 1, 1, 1};
  metric_rows<TILE, kSvc>(p, b, active, tile, mt, [&](int leaf, int i, int v) {
    p.m_out[leaf][static_cast<size_t>(b) * per[leaf] + i] = v;
  }, svc);
}

// K6-trace after tick i of the chunk: cluster b's flight-recorder row
// (kernel K8's function, kernels/trace.py record_plain) into trace[i, b]:
// the post-tick node rows role, term, commit, log_len and base from the
// block, durable_len from the node lane's registers, alive, the
// adjacency's row masks, the tick's deliveries by type, the install
// outcomes, shadow_len, msg_count, violations and, in the metrics
// variant, the record stamps and the metric registers so far. K8 counts a type's deliveries as the
// destinations with a message due in its pre-tick mailbox over a link
// that is up after the tick, the destination (and for install-snapshot
// the sender) live after it. The tick's faults set liveness and links
// before its delivery passes and nothing after them changes either, and
// each pass reads its own mailbox before any pass writes it, so that is
// the count of nodes the pass delivered to (Own::dv). A tile that holds
// no cluster writes nothing
template <int N_, int CAP_, int TILE, bool kMet, typename Blk>
__device__ void record(const Params &p, const Blk &s, const Tile<TILE> &tile,
                       const Own &o, const Meter &mt, const Stamps &st,
                       unsigned alive, int b, bool active, int i) {
  const int n = N_ ? N_ : p.n, cap = CAP_ ? CAP_ : p.cap, lane = tile.lane;
  int *row = p.trace + (static_cast<size_t>(i) * p.b + b) * p.trace_w;
  int count = 0;  // lane k: pass k's deliveries
#pragma unroll
  for (int k = 0; k < kDeliveries; ++k) {
    const int c = __popc(tile.ballot(lane < n && (o.dv >> k & 1u)));
    if (lane == k) count = c;
  }
  if constexpr (kMet) {
    metric_rows(p, b, active, tile, mt, [&](int leaf, int j, int v) {
      const int col = trace_col(leaf, n, cap);
      if (col >= 0) row[col + j] = v;
    });
  }
  if (!active) return;
  if (lane < n) {
    const int d = lane;
    row[d] = I<L_ROLE>(s)[d];
    row[n + d] = I<L_TERM>(s)[d];
    row[2 * n + d] = I<L_COMMIT>(s)[d];
    row[3 * n + d] = I<L_LOG_LEN>(s)[d];
    row[4 * n + d] = I<L_BASE>(s)[d];
    row[5 * n + d] = o.durable_len;
    row[6 * n + d] = bit(alive, d);
    int mask = 0;
    for (int j = 0; j < n; ++j) mask |= (B<L_ADJ>(s)[d * n + j] != 0) << j;
    row[7 * n + d] = mask;
    row[8 * n + kDeliveries + d] = I<L_SNAP_INSTALLED_SRC>(s)[d];
    row[9 * n + kDeliveries + d] = I<L_SNAP_INSTALLED_LEN>(s)[d];
  }
  if (lane < kDeliveries) row[8 * n + lane] = count;
  const int c = 10 * n + kDeliveries;
  if (lane == 0) {
    row[c] = I<L_SHADOW_LEN>(s)[0];
    row[c + 1] = I<L_MSG_COUNT>(s)[0];
    row[c + 2] = I<L_VIOLATIONS>(s)[0];
  }
  if constexpr (kMet)
    for (int k = lane; k < cap; k += TILE) row[c + 3 + k] = st.shadow_sub()[k];
}

// The coverage variant after tick i of the chunk (K5's function, engine.py
// 1342-1361 in the reference): the cluster's code from its post-tick node
// rows, each node lane's code times its weight pw = alphabet^(n-1-node)
// summed over the tile (u32 wrap, Horner's value); a cluster with no
// violation stamps its bit of its seen-set row with the run-wide tick
// (atomicMin: a stamp only falls). Every lane-tick's flat index, -1 when
// violated, goes to fp for the credit pass, which needs the launch's
// final stamps: warps and blocks run their ticks in no common order
template <int N_, int TILE, typename Blk>
__device__ void stamp(const Params &p, const Blk &s, const Tile<TILE> &tile,
                      unsigned alive, int b, bool active, int i) {
  const int n = N_ ? N_ : p.n, lane = tile.lane;
  const bool node = lane < n;
  uint32_t pw = 1u;  // the lane's node's weight
  for (int j = lane + 1; j < n; ++j) pw *= p.alphabet;
  const int *term = I<L_TERM>(s), *commit = I<L_COMMIT>(s);
  int rank = 0;
  if (node)
    for (int j = 0; j < n; ++j) rank += term[j] < term[lane];
  const int cmin = tile.min(node ? commit[lane] : 0x7fffffff);
  const uint32_t part =
      node ? cov::node_code(I<L_ROLE>(s)[lane], bit(alive, lane), rank,
                            commit[lane] - cmin, p.levels_r, p.levels_c) *
                 pw
           : 0u;
  const uint32_t code =
      static_cast<uint32_t>(tile.sum(static_cast<int>(part)));
  if (lane == 0 && active) {
    const int row = p.rows ? p.rows[b] : 0;
    const int flat = static_cast<int>(
        static_cast<uint32_t>(row) * static_cast<uint32_t>(p.bits) +
        cov::bit_index(code, p.identity, p.bits));
    const bool ok = I<L_VIOLATIONS>(s)[0] == 0;
    if (ok) atomicMin(p.seen + flat, p.t0 + i);
    p.fp[static_cast<size_t>(i) * p.b + b] = ok ? flat : -1;
  }
}

// The credits of cluster c over a launch of m ticks (the credit pass):
// lane-tick (c, i) earns one iff it stamped (fp >= 0) and its bit's final
// stamp is its own tick t0 + i. Stamps only fall and earlier launches' are
// below t0, so that holds exactly when no stamp of an earlier tick reached
// the bit: the bit was unset before the tick, the reference's rule
// (engine.py:1356, ok & ~bm[idx]), whatever order the lanes ran in
__host__ __device__ inline int credits(const int *fp, const int *seen, int b,
                                       int c, int m, int t0) {
  int k = 0;
  for (int i = 0; i < m; ++i) {
    const int f = fp[static_cast<size_t>(i) * b + c];
    k += f >= 0 && seen[f] == t0 + i;
  }
  return k;
}

// K6-kv's environment for kv.cuh's phases on a cluster's tile: the kv
// region kv (the service leaves' rows, updated in place for the chunk,
// and the tick's scratch) in the cluster's block; the stepped raft state
// K6's block as the tick left it, the raft leaves the service writes
// (the log rows and log_len, violations, first_violation_tick) written
// there in place; the pre-tick views as run_cluster kept them before the
// tick (liveness a mask, base in the region, shadow_len). Two pre-tick
// values the phases read after rewriting them come from copies
// (kv_tick): the truth's max seqs, and the snapshot tables when a node
// installs a snapshot this tick (an install adopts the sender's PRE-tick
// snapshot, which its own compaction may have rewritten)
template <int N_, int CAP_, int TILE, bool MET, typename Blk>
struct KvEnv {
  static constexpr bool kMet = MET;
  const Params &p;
  const Blk &blk;
  int32_t *kv;
  unsigned alive_m, pre_alive_m;
  int pre_sl;
  bool any_inst;
  __device__ int lanes() const { return TILE; }
  __device__ const k9::Dims &d() const { return p.kv.d; }
  __device__ const k9::Layout &L() const { return p.kv.L; }
  __device__ int n() const { return N_ ? N_ : p.n; }
  __device__ int cap() const { return CAP_ ? CAP_ : p.cap; }
  __device__ int32_t *w(int l) const { return kv + p.kv.leaf[l].off; }
  __device__ uint8_t *wb(int l) const {
    return reinterpret_cast<uint8_t *>(kv + p.kv.leaf[l].off);
  }
  __device__ int32_t *s(int off) const { return kv + off; }
  __device__ const int32_t *pre(int l) const {
    if (l == k9::kTruthMaxSeq) return kv + p.kv.L.pre_tmax;
    if (l >= k9::kSnapLastSeq && l <= k9::kSnapKeyCount && any_inst) {
      const int g = l - k9::kSnapLastSeq, nc = p.kv.d.nc, nk = p.kv.d.nk;
      return kv + p.kv.L.snap_pre +
             n() * (g < 2 ? g * nc : 2 * nc + (g - 2) * nk);
    }
    return w(l);
  }
  __device__ const uint8_t *pre_b(int l) const { return wb(l); }
  __device__ int32_t tick() const { return I<L_TICK>(blk)[0]; }
  __device__ const int32_t *term() const { return I<L_TERM>(blk); }
  __device__ const int32_t *role() const { return I<L_ROLE>(blk); }
  __device__ const int32_t *base() const { return I<L_BASE>(blk); }
  __device__ const int32_t *commit() const { return I<L_COMMIT>(blk); }
  __device__ bool alive(int i) const { return bit(alive_m, i); }
  __device__ int32_t snap_src(int i) const {
    return I<L_SNAP_INSTALLED_SRC>(blk)[i];
  }
  __device__ const int32_t *shadow_val() const {
    return I<L_SHADOW_VAL>(blk);
  }
  __device__ int32_t shadow_base() const { return I<L_SHADOW_BASE>(blk)[0]; }
  __device__ int32_t shadow_len() const { return I<L_SHADOW_LEN>(blk)[0]; }
  __device__ bool pre_alive(int i) const { return bit(pre_alive_m, i); }
  __device__ int32_t pre_base(int i) const {
    return kv[p.kv.L.pre_base + i];
  }
  __device__ int32_t pre_shadow_len() const { return pre_sl; }
  __device__ float kf(int k) const {
    return reinterpret_cast<const float *>(kv + p.kv.L.knobs)[k];
  }
  __device__ int32_t ki(int k) const {
    return kv[p.kv.L.knobs + k9::kNF + k];
  }
  __device__ const int32_t *log_val(int i) const {
    return I<L_LOG_VAL>(blk) + i * cap();
  }
  __device__ int32_t *log_len() const { return I<L_LOG_LEN>(blk); }
  __device__ void append(int i, int pos, int32_t term, int32_t val) const {
    I<L_LOG_TERM>(blk)[i * cap() + pos] = term;
    I<L_LOG_VAL>(blk)[i * cap() + pos] = val;
  }
  __device__ int32_t &violations() const { return I<L_VIOLATIONS>(blk)[0]; }
  __device__ int32_t &first_violation() const {
    return I<L_FIRST_VIOLATION_TICK>(blk)[0];
  }
  // the fsync watermark and the compaction floor are the node lanes'
  // registers (Own): kv_tick sets them after the submits
  __device__ void submitted() const {}
};

// A service build's metrics variant at the chunk's start: the clerks'
// metric sums in the region ws cleared and the worst-op register from the
// metric leaves in; leaf is the service's lat_hist leaf (SvcMetric order
// from it)
template <int TILE, typename Ref>
__device__ void svc_metrics_in(const Params &p, const Ref *leaf, int32_t *ws,
                               int b, int lane) {
  for (int m = SM_LAT_HIST; m <= SM_LAT_TICKS; ++m)
    for (int i = lane; i < leaf[m].count; i += TILE) ws[leaf[m].off + i] = 0;
  const int reg[] = {M_WORST_LAT, M_WORST_PHASES, M_WORST_KEY,
                     M_WORST_CLIENT, M_WORST_SUB};
  for (int r = 0; r < 5; ++r) {
    const Ref &g = leaf[SM_WORST_LAT + r];
    for (int i = lane; i < g.count; i += TILE)
      ws[g.off + i] = p.m_in[reg[r]][static_cast<size_t>(b) * g.count + i];
  }
}

// A service leaf's row g of cluster b between its input or output and
// the service region ws: in (load) or out
template <int TILE, typename Ref>
__device__ void svc_row_copy(const Ref &g, int32_t *ws, int b, int lane,
                             bool load) {
  const size_t row = static_cast<size_t>(b) * g.count;
  if (g.bytes == 4) {
    if (load) {
      const int *src = static_cast<const int *>(g.in) + row;
      for (int i = lane; i < g.count; i += TILE) ws[g.off + i] = src[i];
    } else {
      int *dst = static_cast<int *>(g.out) + row;
      for (int i = lane; i < g.count; i += TILE) dst[i] = ws[g.off + i];
    }
  } else {
    uint8_t *w8 = reinterpret_cast<uint8_t *>(ws + g.off);
    if (load) {
      const uint8_t *src = static_cast<const uint8_t *>(g.in) + row;
      for (int i = lane; i < g.count; i += TILE) w8[i] = src[i];
    } else {
      uint8_t *dst = static_cast<uint8_t *>(g.out) + row;
      for (int i = lane; i < g.count; i += TILE) dst[i] = w8[i];
    }
  }
}

// K6-kv at the chunk's start: cluster b's service leaves into the kv
// region, the clerks' metric sums cleared and the worst-op register from
// the metric leaves in (K6-metrics-kv), the kv knob rows
template <int TILE, bool kMet, typename Blk>
__device__ void kv_stage(const Params &p, const Blk &s, int b, int lane) {
  const k9::Side &kv = p.kv;
  int32_t *ws = s.svc();
  for (int l = 0; l < k9::kServiceLeaves; ++l)
    svc_row_copy<TILE>(kv.leaf[l], ws, b, lane, true);
  if constexpr (kMet)
    svc_metrics_in<TILE>(p, kv.leaf + k9::kLatHist, ws, b, lane);
  for (int i = lane; i < k9::kNF; i += TILE)
    reinterpret_cast<float *>(ws + kv.L.knobs)[i] =
        kv.kf[static_cast<size_t>(b) * k9::kNF + i];
  for (int i = lane; i < k9::kNI; i += TILE)
    ws[kv.L.knobs + k9::kNF + i] = kv.ki[static_cast<size_t>(b) * k9::kNI + i];
  __syncwarp();
}

// K6-kv at the chunk's end: the service leaves out, for a tile that holds
// a cluster (the metric leaves go with write_metrics)
template <int TILE, typename Blk>
__device__ void kv_write(const Params &p, const Blk &s, int b, int lane,
                         bool active) {
  if (!active) return;
  for (int l = 0; l < k9::kServiceLeaves; ++l)
    svc_row_copy<TILE>(p.kv.leaf[l], s.svc(), b, lane, false);
}

// K6-kv after the raft tick: the kv service tick of the cluster on its
// tile (the reference's _kv_service_tick after step_cluster), kv.cuh's
// phases on KvEnv, a warp barrier after each; (s0, s1) is fold_in(key, t),
// alive the post-tick liveness, pre_alive, pre_sl and the region's
// pre_base row the pre-tick views. After the submits each node lane takes
// the service's fsync watermark (the log's length where it grew,
// state.durable_after_append) and compaction floor (the apply cursor)
// into its registers, where the next raft tick reads them
template <int N_, int CAP_, int AE_, int TILE, bool kMet>
__device__ void kv_tick(const Params &p, const Block<N_, CAP_, AE_, kMet> &s,
                        Own &o, unsigned alive, unsigned pre_alive,
                        int pre_sl, const Tile<TILE> &tile, uint32_t s0,
                        uint32_t s1) {
  const int lane = tile.lane, n = N_ ? N_ : p.n, d = lane;
  const bool node = lane < n;
  const k9::Side &kv = p.kv;
  const int nc = kv.d.nc, nk = kv.d.nk;
  int32_t *ws = s.svc();
  // the tick's draw keys and cleared scratch; the truth's pre-tick max
  // seqs, then the max clamped at 0 (the reference's max takes in a 0)
  if (lane < k9::kDrawKeys)
    k9::draw_key(s0, s1, lane, p.partitionable, ws + kv.L.draws + 2 * lane);
  k9::clear_tick(kv.L, ws, nc, lane, TILE);
  int32_t *tmax = ws + kv.leaf[k9::kTruthMaxSeq].off;
  for (int cl = lane; cl < nc; cl += TILE) {
    const int32_t v = tmax[cl];
    ws[kv.L.pre_tmax + cl] = v;
    tmax[cl] = v < 0 ? 0 : v;
  }
  // the snapshot tables (four rows in a row in the region) as they were
  // before the tick, where an install adopts one
  const bool any_inst =
      tile.ballot(node && I<L_SNAP_INSTALLED_SRC>(s)[d] >= 0) != 0u;
  if (any_inst) {
    const int32_t *snap = ws + kv.leaf[k9::kSnapLastSeq].off;
    for (int i = lane; i < n * (2 * nc + 2 * nk); i += TILE)
      ws[kv.L.snap_pre + i] = snap[i];
  }
  const int len0 = node ? I<L_LOG_LEN>(s)[d] : 0;  // before the submits
  __syncwarp();
  const KvEnv<N_, CAP_, TILE, kMet, Block<N_, CAP_, AE_, kMet>> e{
      p, s, ws, alive, pre_alive, pre_sl, any_inst};
  k9::scan(e, lane);
  __syncwarp();
  k9::apply(e, lane);
  __syncwarp();
  k9::observe(e, lane);
  __syncwarp();
  k9::clerks(e, lane);
  __syncwarp();
  if (lane == 0) k9::submit(e);
  __syncwarp();
  if (node) {
    const int len = I<L_LOG_LEN>(s)[d];
    if (len > len0) o.durable_len = len;
    o.compact_floor = ws[kv.leaf[k9::kApplied].off + d];
  }
  __syncwarp();  // the region's rows are read before the next tick's
}

// K6-ctrler's device rows of cluster b on a tile: the two history tables'
// rows (the new state's; a tile past the batch's end, !active, works on
// the side's spare rows, ctrler.cuh Side) and the row that takes the
// pre-tick snap_hist an install adopts
struct CtrlerRows {
  int32_t *hist, *snap_hist, *snap_pre;
};

__device__ __forceinline__ CtrlerRows ctrler_rows(const Params &p, int b,
                                                  bool active) {
  const k10::Side &cs = p.ctrler;
  const int w = cs.leaf[k10::kHist].count;
  int32_t *spare = cs.dev + static_cast<size_t>(p.b + 1) * w;
  auto out = [&](int l) {
    return static_cast<int32_t *>(cs.leaf[l].out) + static_cast<size_t>(b) * w;
  };
  return {active ? out(k10::kHist) : spare,
          active ? out(k10::kSnapHist) : spare + w,
          cs.dev + static_cast<size_t>(active ? b : p.b) * w};
}

// K6-ctrler's environment for ctrler.cuh's phases on a cluster's tile:
// the ctrler region ws (the service leaves' rows but the history tables,
// updated in place for the chunk, the metric sums, the worst-op register
// and the tick's scratch) in the cluster's block, the history tables'
// rows in device memory (dev); the stepped raft state K6's block as the
// tick left it, the raft leaves the service writes (the log rows and
// log_len, violations, first_violation_tick) written there in place; the
// pre-tick views as run_cluster kept them before the tick (liveness a
// mask, base in the region). The phases read a clerk's and a table
// cell's pre-tick values before they rewrite them; the snapshot tables an
// install adopts come from copies (ctrler_tick) on a tick with an install
// (the sender's PRE-tick snapshot, which its own compaction may rewrite)
template <int N_, int CAP_, int TILE, bool MET, typename Blk>
struct CtrlerEnv {
  static constexpr bool kMet = MET;
  const Params &p;
  const Blk &blk;
  int32_t *ws;
  CtrlerRows dev;
  unsigned alive_m, pre_alive_m;
  bool any_inst;
  __device__ int lanes() const { return TILE; }
  __device__ int walker() const { return TILE - 1; }
  __device__ int clerk0() const { return 0; }
  __device__ const k10::Dims &d() const { return p.ctrler.d; }
  __device__ const k10::Layout &L() const { return p.ctrler.L; }
  __device__ int cap() const { return CAP_ ? CAP_ : p.cap; }
  template <typename T>
  __device__ T *w(int l) const {
    int32_t *r = l == k10::kHist       ? dev.hist
                 : l == k10::kSnapHist ? dev.snap_hist
                                       : ws + p.ctrler.leaf[l].off;
    return reinterpret_cast<T *>(r);
  }
  __device__ int32_t *s(int off) const { return ws + off; }
  template <typename T>
  __device__ const T *pre(int l) const {
    if (!any_inst || l < k10::kSnapLastSeq || l > k10::kSnapHist)
      return w<T>(l);
    if (l == k10::kSnapHist) return reinterpret_cast<const T *>(dev.snap_pre);
    const k10::LeafRef *leaf = p.ctrler.leaf;
    return reinterpret_cast<const T *>(ws + p.ctrler.L.snap_pre + leaf[l].off -
                                       leaf[k10::kSnapLastSeq].off);
  }
  __device__ int32_t tick() const { return I<L_TICK>(blk)[0]; }
  __device__ const int32_t *term() const { return I<L_TERM>(blk); }
  __device__ const int32_t *role() const { return I<L_ROLE>(blk); }
  __device__ const int32_t *base() const { return I<L_BASE>(blk); }
  __device__ const int32_t *commit() const { return I<L_COMMIT>(blk); }
  __device__ bool alive(int i) const { return bit(alive_m, i); }
  __device__ int32_t snap_src(int i) const {
    return I<L_SNAP_INSTALLED_SRC>(blk)[i];
  }
  __device__ const int32_t *shadow_val() const {
    return I<L_SHADOW_VAL>(blk);
  }
  __device__ int32_t shadow_base() const { return I<L_SHADOW_BASE>(blk)[0]; }
  __device__ int32_t shadow_len() const { return I<L_SHADOW_LEN>(blk)[0]; }
  __device__ bool pre_alive(int i) const { return bit(pre_alive_m, i); }
  __device__ int32_t pre_base(int i) const {
    return ws[p.ctrler.L.pre_base + i];
  }
  __device__ float kf(int k) const {
    return reinterpret_cast<const float *>(ws + p.ctrler.L.knobs)[k];
  }
  __device__ int32_t ki(int k) const {
    return ws[p.ctrler.L.knobs + k10::kNF + k];
  }
  __device__ k10::Machine machine(int i) const {
    return k10::machine_of(*this, i);
  }
  __device__ const int32_t *log_val(int i) const {
    return I<L_LOG_VAL>(blk) + i * cap();
  }
  __device__ int32_t *log_len() const { return I<L_LOG_LEN>(blk); }
  __device__ void append(int i, int pos, int32_t term, int32_t val) const {
    I<L_LOG_TERM>(blk)[i * cap() + pos] = term;
    I<L_LOG_VAL>(blk)[i * cap() + pos] = val;
  }
  __device__ int32_t &violations() const { return I<L_VIOLATIONS>(blk)[0]; }
  __device__ int32_t &first_violation() const {
    return I<L_FIRST_VIOLATION_TICK>(blk)[0];
  }
  // the fsync watermark and the compaction floor are the node lanes'
  // registers (Own): ctrler_tick sets them after the submits
  __device__ void submitted() const {}
};

// K6-ctrler at the chunk's start: cluster b's service leaves into the
// ctrler region, the history tables' rows from the input into their
// device rows dev, the clerks' metric sums cleared and the worst-op
// register from the metric leaves in (K6-metrics-ctrler), the ctrler knob
// rows
template <int TILE, bool kMet, typename Blk>
__device__ void ctrler_stage(const Params &p, const Blk &s,
                             const CtrlerRows &dev, int b, int lane) {
  const k10::Side &cs = p.ctrler;
  int32_t *ws = s.svc();
  for (int l = 0; l < k10::kServiceLeaves; ++l) {
    const k10::LeafRef &g = cs.leaf[l];
    if (!k10::in_device(l)) {
      svc_row_copy<TILE>(g, ws, b, lane, true);
      continue;
    }
    const int *src = static_cast<const int *>(g.in) +
                     static_cast<size_t>(b) * g.count;
    int32_t *dst = l == k10::kHist ? dev.hist : dev.snap_hist;
    for (int i = lane; i < g.count; i += TILE) dst[i] = src[i];
  }
  if constexpr (kMet)
    svc_metrics_in<TILE>(p, cs.leaf + k10::kLatHist, ws, b, lane);
  for (int i = lane; i < k10::kNF; i += TILE)
    reinterpret_cast<float *>(ws + cs.L.knobs)[i] =
        cs.kf[static_cast<size_t>(b) * k10::kNF + i];
  for (int i = lane; i < k10::kNI; i += TILE)
    ws[cs.L.knobs + k10::kNF + i] =
        cs.ki[static_cast<size_t>(b) * k10::kNI + i];
  __syncwarp();
}

// K6-ctrler at the chunk's end: the service leaves in the region out, for
// a tile that holds a cluster (the history tables are already in their
// output rows; the metric leaves go with write_metrics)
template <int TILE, typename Blk>
__device__ void ctrler_write(const Params &p, const Blk &s, int b, int lane,
                             bool active) {
  if (!active) return;
  for (int l = 0; l < k10::kServiceLeaves; ++l)
    if (!k10::in_device(l))
      svc_row_copy<TILE>(p.ctrler.leaf[l], s.svc(), b, lane, false);
}

// K6-ctrler after the raft tick: the shard controller's service tick of
// the cluster on its tile (the reference's _ctrler_service_tick after
// step_cluster), ctrler.cuh's phases on CtrlerEnv, a warp barrier after
// each; (s0, s1) is fold_in(key, t), alive the post-tick liveness,
// pre_alive and the region's pre_base row the pre-tick views. On a tick
// with an install the snapshot tables are copied first (the region's to
// its snap_pre rows, snap_hist to its device row). After the submits each
// node lane takes the service's fsync watermark (the log's length where
// it grew, state.durable_after_append) and compaction floor (the apply
// cursor) into its registers, where the next raft tick reads them
template <int N_, int CAP_, int AE_, int TILE, bool kMet>
__device__ void ctrler_tick(const Params &p,
                            const Block<N_, CAP_, AE_, kMet> &s,
                            const CtrlerRows &dev, Own &o, unsigned alive,
                            unsigned pre_alive, const Tile<TILE> &tile,
                            uint32_t s0, uint32_t s1) {
  const int lane = tile.lane, n = N_ ? N_ : p.n, d = lane;
  const bool node = lane < n;
  const k10::Side &cs = p.ctrler;
  int32_t *ws = s.svc();
  if (lane < k10::kDrawKeys)
    k10::draw_key(s0, s1, lane, p.partitionable, ws + cs.L.draws + 2 * lane);
  k10::clear_tick(cs.L, ws, cs.d.nc, lane, TILE);
  const bool any_inst =
      tile.ballot(node && I<L_SNAP_INSTALLED_SRC>(s)[d] >= 0) != 0u;
  if (any_inst) {
    const int32_t *snap = ws + cs.leaf[k10::kSnapLastSeq].off;
    for (int i = lane; i < cs.L.knobs - cs.L.snap_pre; i += TILE)
      ws[cs.L.snap_pre + i] = snap[i];
    for (int i = lane; i < cs.leaf[k10::kSnapHist].count; i += TILE)
      dev.snap_pre[i] = dev.snap_hist[i];
  }
  const int len0 = node ? I<L_LOG_LEN>(s)[d] : 0;  // before the submits
  __syncwarp();
  const CtrlerEnv<N_, CAP_, TILE, kMet, Block<N_, CAP_, AE_, kMet>> e{
      p, s, ws, dev, alive, pre_alive, any_inst};
  k10::restore(e, lane);
  __syncwarp();
  k10::apply(e, lane);
  __syncwarp();
  k10::clerks(e, lane);
  __syncwarp();
  if (lane == 0) k10::submit(e);
  __syncwarp();
  if (node) {
    const int len = I<L_LOG_LEN>(s)[d];
    if (len > len0) o.durable_len = len;
    o.compact_floor = ws[cs.leaf[k10::kApplied].off + d];
  }
  __syncwarp();  // the region's rows are read before the next tick's
}

// The chunk for cluster b on a tile: stage in, m ticks, stage out (a
// tile past the batch's end, !active, runs a copy of the last cluster and
// writes nothing); the metrics variant also fills its stamp rings and
// writes the metric registers, the coverage variant stamps the seen-set
// after each tick, a trace buffer gets each tick's row, a service build
// (kSvc) runs its service tick after each tick with its leaves staged for
// the chunk (K6-kv, K6-ctrler); the profile instance writes its per-phase
// sums to prof[b, kPhases]
template <int N_, int CAP_, int AE_, int TILE, bool kProf, bool kMet,
          bool kCov, int kSvc = kNoSvc>
__device__ void run_cluster(const Params &p, uint8_t *cl, int b, bool active,
                            const Tile<TILE> &tile, long long *prof) {
  const Block<N_, CAP_, AE_, kMet> s{p, cl};
  const int n = N_ ? N_ : p.n, lane = tile.lane;
  Clock<kProf> clk;
  clk.start(lane);
  stage<TILE>(p, s, b, lane, true, active);
  [[maybe_unused]] CtrlerRows dev{};
  if constexpr (kSvc == kSvcKv) kv_stage<TILE, kMet>(p, s, b, lane);
  if constexpr (kSvc == kSvcCtrler) {
    dev = ctrler_rows(p, b, active);
    ctrler_stage<TILE, kMet>(p, s, dev, b, lane);
  }
  const Stamps st{p, b, active};
  if constexpr (kMet) stamps_load<TILE>(st, lane);
  Own o;
  if (lane < n) own_load(s, o, lane, n);
  Meter mt;
  if constexpr (kMet) {
    mt.worst_lat = p.m_in[M_WORST_LAT][b];
    mt.worst_sub = p.m_in[M_WORST_SUB][b];
  }
  unsigned alive = tile.ballot(lane < n && B<L_ALIVE>(s)[lane]);
  TickKeys<TILE, kSvc != kNoSvc> keys;
  clk.mark(P_STAGE);
  for (int i = 0; i < p.m; ++i) {
    uint32_t tk0, tk1;  // the block's tick is the chunk's first + i
    keys.get(p, b, i, static_cast<uint32_t>(I<L_TICK>(s)[0]) + 1u, tile, tk0,
             tk1);
    if constexpr (kSvc != kNoSvc) {
      uint32_t s0, s1;
      keys.svc(i, tile, s0, s1);
      // the pre-tick views the service tick reads
      const unsigned pre_alive = alive;
      const int pre_base =
          kSvc == kSvcKv ? p.kv.L.pre_base : p.ctrler.L.pre_base;
      if (lane < n) s.svc()[pre_base + lane] = I<L_BASE>(s)[lane];
      if constexpr (kSvc == kSvcKv) {
        const int pre_sl = I<L_SHADOW_LEN>(s)[0];
        tick<N_, CAP_, AE_, TILE, kProf, kMet, kSvc>(p, s, st, o, mt, alive,
                                                     tile, clk, tk0, tk1);
        kv_tick<N_, CAP_, AE_, TILE, kMet>(p, s, o, alive, pre_alive, pre_sl,
                                           tile, s0, s1);
      } else {
        tick<N_, CAP_, AE_, TILE, kProf, kMet, kSvc>(p, s, st, o, mt, alive,
                                                     tile, clk, tk0, tk1);
        ctrler_tick<N_, CAP_, AE_, TILE, kMet>(p, s, dev, o, alive,
                                               pre_alive, tile, s0, s1);
      }
      continue;
    }
    tick<N_, CAP_, AE_, TILE, kProf, kMet>(p, s, st, o, mt, alive, tile, clk,
                                           tk0, tk1);
    if constexpr (kCov) {  // the profile counts the stamp with compact
      stamp<N_>(p, s, tile, alive, b, active, i);
      clk.mark(P_COMPACT);
    }
    if (p.trace)  // the whole warp or none
      record<N_, CAP_, TILE, kMet>(p, s, tile, o, mt, st, alive, b, active,
                                   i);
  }
  if (lane < n) own_store(s, o, lane, n);
  __syncwarp();
  stage<TILE>(p, s, b, lane, false, active);
  if constexpr (kSvc == kSvcKv) kv_write<TILE>(p, s, b, lane, active);
  if constexpr (kSvc == kSvcCtrler) ctrler_write<TILE>(p, s, b, lane, active);
  if constexpr (kMet)
    write_metrics<TILE, kSvc>(p, b, active, tile, mt, s.svc());
  clk.mark(P_STAGE);
  if constexpr (kProf) {
    if (lane < kPhases && active) prof[b * kPhases + lane] = clk.acc;
  }
}

// The chunk's draw words alone, drawn as run_cluster draws them, for
// cluster b from tick t1 on into words [m, B, total] (the host build's
// tests hold them against the plain draw)
template <int N_, int TILE>
__device__ void draw_chunk(const Params &p, uint8_t *cl, int b, int t1,
                           bool active, const Tile<TILE> &tile,
                           uint32_t *words) {
  const Block<0, 0, 0> s{p, cl};  // the words' slot by its runtime offset
  const int total = N_ ? draw_offset(kDraws, N_) : p.total;
  TickKeys<TILE> keys;
  for (int i = 0; i < p.m; ++i) {
    uint32_t tk0, tk1;
    keys.get(p, b, i, static_cast<uint32_t>(t1) + static_cast<uint32_t>(i),
             tile, tk0, tk1);
    draw_words<N_, TILE>(p, U<S_WORDS>(s), tk0, tk1, tile.lane);
    __syncwarp();
    uint32_t *row = words + (static_cast<size_t>(i) * p.b + b) * total;
    for (int j = tile.lane; active && j < total; j += TILE)
      row[j] = U<S_WORDS>(s)[j];
    __syncwarp();
  }
}

#ifdef MADRAFT_K6_SHARDKV
// ------------------------------------------------------------ K6-shardkv
// A deployment a block: tile t < G runs group t's cluster (c * G + t of
// the group clusters), tile G in a controller mode the controller's (c of
// the controller clusters), and a last tile, where the count is odd, a
// copy of group 0 that writes nothing (a warp's two tiles run the tick's
// collectives together). Each tick the tiles run their raft ticks, write
// the rows K11's service tick reads and writes to the new state's rows
// (skv_export), the block runs K11's phases on them in place (shardkv.cuh
// under MADRAFT_STAGE_IN_PLACE: a phase reads a leaf's pre-tick value
// from its row, which only the tick's last phase rewrites), and the tiles
// take the service's appends, log lengths, fsync watermarks and
// compaction floors back (skv_import). The schedule mode's placeholder
// controller has no tile: its leaves pass through.
struct ShardKvParams {
  Params g;       // the group clusters (b = B * G)
  Params c;       // the controller clusters (b = B; controller modes)
  k11::Params s;  // K11's, each leaf's input its output (the new state)
  // each service leaf's input, copied to its output at the chunk's start
  // (null where the input is the output: K6's raft leaves)
  const void *svc_in[k11::kLeaves];
  uint8_t *pre_alive;  // [B, G, n] the groups' pre-tick liveness (s reads)
  int32_t *pre_base;   // [B, G, n] and bases
  uint8_t *blocks;     // [B, tiles, cluster_bytes] the clusters' blocks in
                       // device memory, or null: in shared memory
  int *spare;          // metrics: [B, n * cap + cap] the copy tile's
                       // stamp rows
  int b, groups, tiles, m, shared, threads;
};

// The K6-shardkv template instances: the shardkv CLI's ring at the
// flagship's n (5, 64) and the runtime one
__host__ __device__ constexpr int shardkv_instance(int n, int cap,
                                                   int ae_max) {
  return n == 5 && cap == 64 && ae_max <= kShapeAe ? 1 : 0;
}

// The arguments of a cluster kind (groups or controller) as the wrapper
// packs them: the kLeaves inputs, then outputs, the keys, the two knob
// tables, then the metric leaves' inputs, outputs and the spare rows (0
// outside the metrics builds)
constexpr int kClusterArgs = 2 * kLeaves + 3 + 2 * kMetricLeaves + 1;

// Fills p for b clusters of the shape from a's pointers; false for
// arguments the build does not take
inline bool set_clusters(Params &p, const int64_t *a, const int *kinds,
                         const int *draws, int b, int n, int cap, int ae_max,
                         int m, int bug, int part, bool met) {
  for (int l = 0; l < kLeaves; ++l) {
    if (kinds[l] != kLeafKind[l]) return false;
    p.kind[l] = kinds[l];
    p.in[l] = reinterpret_cast<const void *>(a[l]);
    p.out[l] = reinterpret_cast<void *>(a[kLeaves + l]);
  }
  const int inst = shardkv_instance(n, cap, ae_max);
  if (!set_shape(p, n, cap, ae_max, inst ? kShapeAe : ae_max, met, draws) ||
      !set_variant(p, met ? a + 2 * kLeaves + 3 : nullptr, nullptr) ||
      !set_trace(p, nullptr, 0, met) ||
      !set_service(p, nullptr, 0, part, met, kNoSvc))
    return false;
  p.keys = reinterpret_cast<const long long *>(a[2 * kLeaves]);
  p.kf = reinterpret_cast<const float *>(a[2 * kLeaves + 1]);
  p.ki = reinterpret_cast<const int *>(a[2 * kLeaves + 2]);
  p.b = b;
  p.m = m;
  p.bug = bug;
  p.partitionable = part;
  p.one = 1u;
  return true;
}

// The launch's scratch in device memory, after the parameters: the
// pre-tick rows, the copy tiles' stamp rows, and the blocks where they do
// not fit beside K11's region in shared memory (max_shared: what a block
// may take). Returns its bytes and sets sp's pointers from base (null:
// the offsets alone), K11's reads of the pre-tick rows among them
inline size_t shardkv_scratch(ShardKvParams &sp, uint8_t *base, bool met,
                              int max_shared) {
  auto up = [](size_t x) { return (x + 255) / 256 * 256; };
  const size_t gn = static_cast<size_t>(sp.b) * sp.groups * sp.g.n;
  const size_t ring = static_cast<size_t>(sp.g.n) * sp.g.cap + sp.g.cap;
  const size_t blocks = static_cast<size_t>(sp.tiles) * sp.g.cluster_bytes;
  const bool in_shared =
      blocks + 4 * static_cast<size_t>(sp.s.words) <=
      static_cast<size_t>(max_shared);
  size_t at = up(sizeof(ShardKvParams));
  auto take = [&](size_t bytes) {
    uint8_t *x = base ? base + at : nullptr;
    at += up(bytes);
    return x;
  };
  sp.pre_alive = take(gn);
  sp.pre_base = reinterpret_cast<int32_t *>(take(4 * gn));
  sp.s.read[k11::kPreAlive] = sp.pre_alive;
  sp.s.read[k11::kPreBase] = sp.pre_base;
  sp.spare = met ? reinterpret_cast<int *>(take(4 * ring * sp.b)) : nullptr;
  sp.blocks = in_shared ? nullptr : take(blocks * sp.b);
  sp.shared = static_cast<int>((in_shared ? blocks : 0) + 4 * sp.s.words);
  return at;
}

// Fills sp from the wrapper's arguments (ga / ca the groups' and the
// controller's as set_clusters reads them, ca null in schedule mode; desc
// K11's descriptor over the new state, each leaf's input the state in);
// false for arguments the build does not take
inline bool set_shardkv(ShardKvParams &sp, const int64_t *ga,
                        const int64_t *ca, const int *kinds,
                        const int *draws, int b, int groups, int n, int cap,
                        int ae_max, int m, int bug, int part,
                        const int64_t *desc, int n_desc, bool met) {
  constexpr int kHead = int(k11::kHeader) + int(k11::kReads);
  constexpr int kWords = kHead + 4 * k11::kLeaves;
  if (n_desc != kWords || b < 1 || m < 1 || groups < 1 ||
      (met && m > kMaxMetricTicks))
    return false;
  int64_t d[kWords];
  for (int i = 0; i < kWords; ++i) d[i] = desc[i];
  for (int l = 0; l < k11::kLeaves; ++l) {  // in place over the new state
    int64_t *q = d + kHead + 4 * l;
    sp.svc_in[l] = q[0] != q[1] && q[2] ? reinterpret_cast<const void *>(q[0])
                                        : nullptr;
    q[0] = q[1];
  }
  if (!k11::set_params(sp.s, d, n_desc) || sp.s.b != b ||
      sp.s.g != groups || sp.s.n != n || sp.s.cap != cap ||
      (ca != nullptr) != (sp.s.mode != k11::kSchedule) ||
      !set_clusters(sp.g, ga, kinds, draws, b * groups, n, cap, ae_max, m,
                    bug, part, met) ||
      (ca && !set_clusters(sp.c, ca, kinds, draws, b, n, cap, ae_max, m, bug,
                           part, met)))
    return false;
  if (!ca) sp.c = sp.g;  // never read
  sp.b = b;
  sp.groups = groups;
  sp.tiles = (groups + (ca != nullptr) + 1) / 2 * 2;
  sp.m = m;
  // the block: K11's threads, or more where the tiles take more
  const int warps = sp.tiles / (kWarp / kTile);
  sp.threads = kWarp * (warps > k11::kThreads / kWarp ? warps
                                                      : k11::kThreads / kWarp);
  return true;
}

// Leaf l's row of cluster b from its block to the new state
template <int TILE, typename Blk>
__device__ void leaf_out(const Params &p, const Blk &s, int l, int b,
                         int lane) {
  const int e = shape_elems(p.kind[l], p.n, p.cap);
  const size_t row = static_cast<size_t>(b) * e;
  if (p.kind[l] & kBool) {
    uint8_t *g = static_cast<uint8_t *>(p.out[l]) + row;
    for (int i = lane; i < e; i += TILE) g[i] = s.B(l)[i];
  } else {
    int *g = static_cast<int *>(p.out[l]) + row;
    for (int i = lane; i < e; i += TILE) g[i] = s.I(l)[i];
  }
}

// After the raft tick: the rows of cluster b that K11 reads (its stepped
// rows) and writes (the log rows and length, and from the node lanes'
// registers the fsync watermark and compaction floor), into the new
// state, where K11's reads and leaves point
template <int TILE, typename Blk>
__device__ void skv_export(const Params &p, const Blk &s, const Own &o, int b,
                           int lane, int n) {
  leaf_out<TILE>(p, s, L_TICK, b, lane);
  leaf_out<TILE>(p, s, L_TERM, b, lane);
  leaf_out<TILE>(p, s, L_ROLE, b, lane);
  leaf_out<TILE>(p, s, L_ALIVE, b, lane);
  leaf_out<TILE>(p, s, L_BASE, b, lane);
  leaf_out<TILE>(p, s, L_COMMIT, b, lane);
  leaf_out<TILE>(p, s, L_SNAP_INSTALLED_SRC, b, lane);
  leaf_out<TILE>(p, s, L_SHADOW_VAL, b, lane);
  leaf_out<TILE>(p, s, L_SHADOW_BASE, b, lane);
  leaf_out<TILE>(p, s, L_SHADOW_LEN, b, lane);
  leaf_out<TILE>(p, s, L_LOG_TERM, b, lane);
  leaf_out<TILE>(p, s, L_LOG_VAL, b, lane);
  leaf_out<TILE>(p, s, L_LOG_LEN, b, lane);
  if (lane < n) {
    const size_t r = static_cast<size_t>(b) * n + lane;
    static_cast<int *>(p.out[L_DURABLE_LEN])[r] = o.durable_len;
    static_cast<int *>(p.out[L_COMPACT_FLOOR])[r] = o.compact_floor;
  }
}

// After the service tick: node lane d takes the entries the service
// appended (the ring slots past its pre-service length), its log length,
// fsync watermark and (a group's, floor) compaction floor; the caller
// syncs the warp
template <int CAP_, typename Blk>
__device__ void skv_import(const Params &p, const Blk &s, Own &o, int b,
                           int d, int n, bool floor) {
  const int cap = CAP_ ? CAP_ : p.cap;
  const size_t r = static_cast<size_t>(b) * n + d;
  int *len = I<L_LOG_LEN>(s);
  const int len1 = static_cast<const int *>(p.out[L_LOG_LEN])[r];
  const int *term = static_cast<const int *>(p.out[L_LOG_TERM]) + r * cap;
  const int *val = static_cast<const int *>(p.out[L_LOG_VAL]) + r * cap;
  for (int a = len[d] + 1; a <= len1; ++a) {
    const int k = slot(a, cap);
    I<L_LOG_TERM>(s)[d * cap + k] = term[k];
    I<L_LOG_VAL>(s)[d * cap + k] = val[k];
  }
  len[d] = len1;
  o.durable_len = static_cast<const int *>(p.out[L_DURABLE_LEN])[r];
  if (floor)
    o.compact_floor = static_cast<const int *>(p.out[L_COMPACT_FLOOR])[r];
}

// Deployment c's chunk on thread tid of its block (sp.threads threads:
// the tiles' lanes first), its clusters' blocks at `blocks`: the service
// leaves' rows copied to the new state, the clusters staged, then m ticks
// (the raft ticks, skv_export, a barrier, K11's phases with a barrier
// after each, skv_import), then the clusters written out. sync() is the
// block's barrier, svc(phase) this thread's share of K11's phase
template <int N_, int CAP_, int AE_, int TILE, bool kMet, int M,
          typename Sync, typename Svc>
__device__ void run_deployment(const ShardKvParams &sp, uint8_t *blocks,
                               int c, int tid, Sync sync, Svc svc) {
  constexpr bool kCtrl = M != k11::kSchedule;
  const int G = sp.groups, t = tid / TILE, lane = tid % TILE;
  const bool raft = t < sp.tiles;
  const bool is_ctrl = kCtrl && t == G;
  const bool active = t < G + kCtrl;
  const Params &p = is_ctrl ? sp.c : sp.g;
  const int b = is_ctrl ? c : c * G + (active ? t : 0);
  const int n = N_ ? N_ : p.n;
  const Block<N_, CAP_, AE_, kMet> s{
      p, blocks + static_cast<size_t>(raft ? t : 0) * p.cluster_bytes};
  const Tile<TILE> tile{lane, t % (kWarp / TILE) * TILE};
  for (int l = 0; l < k11::kLeaves; ++l) {
    const k11::LeafRef &x = sp.s.leaf[l];
    if (!sp.svc_in[l]) continue;
    const size_t bytes = static_cast<size_t>(x.count) * x.bytes;
    const uint8_t *src = static_cast<const uint8_t *>(sp.svc_in[l]) + c * bytes;
    uint8_t *dst = static_cast<uint8_t *>(x.out) + c * bytes;
    if (x.bytes == 4) {
      for (size_t i = tid; i < bytes / 4; i += sp.threads)
        reinterpret_cast<int32_t *>(dst)[i] =
            reinterpret_cast<const int32_t *>(src)[i];
    } else {
      for (size_t i = tid; i < bytes; i += sp.threads) dst[i] = src[i];
    }
  }
  const Stamps st{p, b, active,
                  sp.spare ? sp.spare + static_cast<size_t>(c) *
                                            (p.n * p.cap + p.cap)
                           : nullptr};
  Own o;
  Meter mt;
  unsigned alive = 0u;
  TickKeys<TILE> keys;
  Clock<false> clk;
  if (raft) {
    stage<TILE>(p, s, b, lane, true, active);
    if constexpr (kMet) stamps_load<TILE>(st, lane);
    if (lane < n) own_load(s, o, lane, n);
    if constexpr (kMet) {
      mt.worst_lat = p.m_in[M_WORST_LAT][b];
      mt.worst_sub = p.m_in[M_WORST_SUB][b];
    }
    alive = tile.ballot(lane < n && B<L_ALIVE>(s)[lane]);
  }
  sync();  // the service leaves' rows are in place
  for (int i = 0; i < sp.m; ++i) {
    if (raft) {
      uint32_t tk0, tk1;
      keys.get(p, b, i, static_cast<uint32_t>(I<L_TICK>(s)[0]) + 1u, tile,
               tk0, tk1);
      if (active && !is_ctrl && lane < n) {
        const size_t r = static_cast<size_t>(b) * n + lane;
        sp.pre_alive[r] = bit(alive, lane);
        sp.pre_base[r] = I<L_BASE>(s)[lane];
      }
      tick<N_, CAP_, AE_, TILE, false, kMet>(p, s, st, o, mt, alive, tile,
                                             clk, tk0, tk1);
      if (active) skv_export<TILE>(p, s, o, b, lane, n);
    }
    sync();
    for (int phase = 0; phase < k11::kTickPhases; ++phase) {
      svc(phase);
      sync();
    }
    if (raft) {
      if (active && lane < n) skv_import<CAP_>(p, s, o, b, lane, n, !is_ctrl);
      __syncwarp();
    }
  }
  if (raft) {
    if (lane < n) own_store(s, o, lane, n);
    __syncwarp();
    stage<TILE>(p, s, b, lane, false, active);
    if constexpr (kMet) write_metrics<TILE>(p, b, active, tile, mt);
  }
}
#endif

}  // namespace k6
