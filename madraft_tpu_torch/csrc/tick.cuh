// Kernel K6's device code: raft ticks of one cluster, run by one warp on
// the cluster's state staged in shared memory. The kernel and its launch
// are in tick.cu, whose header note gives the region K6 replaces and its
// bound; the Python side (kernels/tick.py) holds the tables this file's
// enums mirror and the plain version, step.py step_cluster looped.
//
// The phases follow the port's step.py step_cluster line for line, in its
// order; each comment names the lines. Lanes stride over nodes (lane d is
// node d: n <= 16 < 32), over the (dst, src) pairs of the [n, n] mailboxes
// and over the cap ring slots; __syncwarp() parts a phase's reads of
// another lane's values from that lane's writes. A phase that reads a
// node's values while that node's lane rewrites them (install-snapshot,
// AppendEntries) computes first, syncs, then writes.
//
// Arithmetic as the reference's: int32 wraps where it wraps there (the
// entry hash is computed in uint32 and reinterpreted), float32 uniforms
// are exact, and the float products and sums go through __fmul_rn /
// __fadd_rn so that nothing is contracted.

#pragma once

#include <cstdint>

namespace k6 {

constexpr int kMaxNodes = 16;
constexpr int kMaxCap = 256;
constexpr int kMaxAe = 64;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBig = 1 << 30;  // sentinel above any absolute log index
constexpr int kFollower = 0, kCandidate = 1, kLeader = 2;
constexpr int kNoopCmd = 1 << 30;
constexpr int kViolDual = 1, kViolLogMatch = 2, kViolShadow = 4;
constexpr int kViolPrefix = 512;

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

// Scratch slots after the leaves in a cluster's shared block: the knob
// rows, per-node values that cross lanes, a delivery's entries
enum Scratch {
  S_KF = kLeaves,  // float32 knobs (KNOB_F32 order)
  S_KI,            // int32 knobs (KNOB_I32 order)
  S_RESTART, S_CRASH_BERN, S_ROLL_DOWN, S_NEW_ALIVE, S_LEAD_PRE, S_FIRED,
  S_LLT, S_LLI, S_LEAD, S_FIRE_HB, S_INJECT,
  S_ENT_T, S_ENT_V,  // [n, ae_max]
  kSlots
};

enum KnobF { KF_LOSS_PROB, KF_P_CRASH, KF_P_RESTART, KF_P_REPARTITION,
             KF_P_HEAL, KF_P_LEADER_PART, KF_P_ASYM_CUT, KF_P_CLIENT_CMD,
             KF_P_LOSE_UNSYNCED, KF_P_LIMP, KF_P_LIMP_HEAL, KF_P_FSYNC_STALL,
             kKnobF };
enum KnobI { KI_FSYNC_EVERY, KI_ETO_MIN, KI_ETO_MAX, KI_DELAY_MIN,
             KI_DELAY_MAX, KI_HEARTBEAT_TICKS, KI_COMPACT_EVERY, KI_FLOW_CAP,
             KI_MAX_DEAD, KI_MAJORITY, KI_COMPACT_AT_COMMIT, KI_LIMP_MULT_MAX,
             KI_ETO_SKEW, KI_FSYNC_STALL_TICKS, KI_ROLLING_PERIOD,
             KI_ROLLING_DOWN, kKnobI };

// The tick's draws in _DrawBlock._take order (kernels/tick.py DRAWS); the
// offsets come from the wrapper
enum Draw { D_RESTART, D_CRASH, D_RST_TMR, D_U_PART, D_COLORS, D_ASYM_DST,
            D_ASYM_OFF, D_SNAP_TMR, D_GRANT_TMR, D_RV_RSP_NET, D_AE_TMR,
            D_AE_RSP_NET, D_ELECT_TMR, D_RV_REQ_NET, D_CLIENT, D_AE_REQ_NET,
            D_SN_REQ_NET, kDraws };

struct Params {
  const void *in[kLeaves];   // [B, ...] leaves of the state in
  void *out[kLeaves];        // and of the state out (may alias in)
  const long long *words;    // [m, B, total] int64-held u32 draw words
  const float *kf;           // [B, kKnobF]
  const int *ki;             // [B, kKnobI]
  int kind[kLeaves];         // each leaf's kind (kLeafKind)
  int off[kSlots];           // byte offset of each slot in a cluster block
  int draw[kDraws];          // offset of each draw in a tick's words
  int b, n, cap, ae_max, m, bug, total, cluster_bytes;
};

__host__ __device__ inline int shape_elems(int kind, int n, int cap) {
  switch (kind & 7) {
    case kOne: return 1;
    case kN: return n;
    case kNC: return n * cap;
    case kNN: return n * n;
    default: return cap;
  }
}

// A cluster block's layout: each slot 16-byte aligned; returns its bytes
inline int layout(int n, int cap, int ae_max, int *off) {
  int o = 0;
  for (int l = 0; l < kLeaves; ++l) {
    off[l] = o;
    const int e = shape_elems(kLeafKind[l], n, cap);
    o += ((kLeafKind[l] & kBool ? e : 4 * e) + 15) & ~15;
  }
  for (int s = kLeaves; s < kSlots; ++s) {
    off[s] = o;
    const int e = s == S_KF ? kKnobF : s == S_KI ? kKnobI
                  : s >= S_ENT_T ? n * ae_max : n;
    o += (4 * e + 15) & ~15;
  }
  return o;
}

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int pmod(int a, int m) {  // Python's a % m
  const int r = a % m;
  return r < 0 ? r + m : r;
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
__device__ __forceinline__ int xor_all(int v) {
  for (int m = kWarp / 2; m; m >>= 1) v ^= __shfl_xor_sync(kFull, v, m);
  return v;
}

// One cluster's block in shared memory
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
};

// Stage the cluster's leaves and knob rows in (load) or its leaves out
__device__ void stage(const Params &p, const Block &s, int b, int lane,
                      bool load) {
  for (int l = 0; l < kLeaves; ++l) {
    const int e = shape_elems(p.kind[l], p.n, p.cap);
    const size_t row = static_cast<size_t>(b) * e;
    if (p.kind[l] & kBool) {
      uint8_t *sh = s.B(l);
      if (load) {
        const uint8_t *g = static_cast<const uint8_t *>(p.in[l]) + row;
        for (int i = lane; i < e; i += kWarp) sh[i] = g[i];
      } else {
        uint8_t *g = static_cast<uint8_t *>(p.out[l]) + row;
        for (int i = lane; i < e; i += kWarp) g[i] = sh[i];
      }
    } else {
      int *sh = s.I(l);
      if (load) {
        const int *g = static_cast<const int *>(p.in[l]) + row;
        for (int i = lane; i < e; i += kWarp) sh[i] = g[i];
      } else {
        int *g = static_cast<int *>(p.out[l]) + row;
        for (int i = lane; i < e; i += kWarp) g[i] = sh[i];
      }
    }
  }
  if (load) {
    for (int i = lane; i < kKnobF; i += kWarp)
      s.F(S_KF)[i] = p.kf[static_cast<size_t>(b) * kKnobF + i];
    for (int i = lane; i < kKnobI; i += kWarp)
      s.I(S_KI)[i] = p.ki[static_cast<size_t>(b) * kKnobI + i];
  }
  __syncwarp();
}

// The picked source of a mailbox row: among the messages due now at a
// live dst over a usable link (and, for install-snapshot, from a live
// src), the one whose tick-rotated rank (src + t) mod n is least; -1 if
// none (step.py pick_one)
__device__ __forceinline__ int pick_src(const int *mail_t, const uint8_t *adj,
                                        const uint8_t *alive, int d, int n,
                                        int t, bool src_alive) {
  if (!alive[d]) return -1;
  int best = -1, best_rank = n;
  for (int s = 0; s < n; ++s) {
    if (mail_t[d * n + s] != t || !adj[d * n + s]) continue;
    if (src_alive && !alive[s]) continue;
    const int rank = pmod(s + t, n);
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

// One tick of the cluster (step.py step_cluster with cfg.metrics off);
// w are this cluster's words of the tick
__device__ void tick(const Params &p, const Block &s, const long long *w,
                     int lane) {
  const int n = p.n, cap = p.cap, ae_max = p.ae_max, nn = n * n;
  const int *dr = p.draw;
  auto word = [&](int draw, int i) {
    return static_cast<uint32_t>(w[dr[draw] + i]);
  };
  const float *kf = s.F(S_KF);
  const int *ki = s.I(S_KI);
  int *term = s.I(L_TERM), *voted_for = s.I(L_VOTED_FOR);
  int *role = s.I(L_ROLE), *timer = s.I(L_TIMER), *hb = s.I(L_HB);
  uint8_t *alive = s.B(L_ALIVE);
  int *limp = s.I(L_LIMP), *fsync_stall = s.I(L_FSYNC_STALL);
  int *log_term = s.I(L_LOG_TERM), *log_val = s.I(L_LOG_VAL);
  int *log_len = s.I(L_LOG_LEN), *base = s.I(L_BASE);
  int *snap_term = s.I(L_SNAP_TERM), *prefix_hash = s.I(L_PREFIX_HASH);
  int *commit = s.I(L_COMMIT), *durable_len = s.I(L_DURABLE_LEN);
  int *durable_term = s.I(L_DURABLE_TERM);
  int *durable_voted_for = s.I(L_DURABLE_VOTED_FOR);
  int *compact_floor = s.I(L_COMPACT_FLOOR);
  uint8_t *votes = s.B(L_VOTES), *adj = s.B(L_ADJ);
  int *next_idx = s.I(L_NEXT_IDX), *match_idx = s.I(L_MATCH_IDX);
  const int t = s.I(L_TICK)[0] + 1;
  const int me = lane, d = lane;  // a node lane's node
  const bool node = lane < n;
  const int skew = me * ki[KI_ETO_SKEW];
  int delivered = 0, installs = 0;  // this lane's node's, summed at the end

  // ---------------------------------------------- faults (step.py 191-221)
  if (node) {
    const int period = ki[KI_ROLLING_PERIOD];
    const int rp = imax(period, 1);
    const int wave = t / rp;
    const int wave_i = wave - pmod(wave - me, n);
    const int age = t - wave_i * rp;
    const bool sched = period > 0 && wave_i >= 0;
    const bool down = sched && age < ki[KI_ROLLING_DOWN];
    const bool up = sched && age == ki[KI_ROLLING_DOWN];
    const bool was = alive[d];
    s.I(S_RESTART)[d] =
        !was && ((u01(word(D_RESTART, d)) < kf[KF_P_RESTART] && !down) || up);
    s.I(S_CRASH_BERN)[d] = was && u01(word(D_CRASH, d)) < kf[KF_P_CRASH];
    s.I(S_ROLL_DOWN)[d] = down;
  }
  __syncwarp();
  if (node) {
    const int *restart_v = s.I(S_RESTART), *cb = s.I(S_CRASH_BERN);
    int dead = 0, cum = 0;
    for (int j = 0; j < n; ++j) {
      dead += !alive[j] && !restart_v[j];
      cum += j <= d && cb[j];
    }
    const bool restart = restart_v[d];
    const bool was = alive[d];
    const bool crash = (cb[d] && cum <= ki[KI_MAX_DEAD] - dead) ||
                       (was && s.I(S_ROLL_DOWN)[d]);
    const bool now = (was || restart) && !crash;
    s.I(S_NEW_ALIVE)[d] = now;
    s.I(S_LEAD_PRE)[d] = now && role[d] == kLeader;  // the tick-start role
    if (restart) role[d] = kFollower;
    if (p.bug == kForgetVotedFor && restart) voted_for[d] = -1;
    const uint32_t w_restart = word(D_RESTART, d), w_crash = word(D_CRASH, d);
    const uint32_t w_rst_tmr = word(D_RST_TMR, d);
    if (restart) {
      timer[d] = randint(w_rst_tmr, ki[KI_ETO_MIN], ki[KI_ETO_MAX] + 1) + skew;
      hb[d] = 0;
      commit[d] = base[d];
      compact_floor[d] = base[d];
      for (int j = 0; j < n; ++j) {
        votes[d * n + j] = 0;
        next_idx[d * n + j] = 1;
        match_idx[d * n + j] = 0;
      }
    }
    // limping nodes (222-232): draws from the free low bytes
    const int mult_max = ki[KI_LIMP_MULT_MAX];
    const bool limp_on = now && mult_max >= 2 && bern8(w_crash, kf[KF_P_LIMP]);
    if (restart)
      limp[d] = 1;
    else if (limp_on)
      limp[d] = randint8(w_restart, 2, mult_max - 1);
    else if (bern8(w_rst_tmr, kf[KF_P_LIMP_HEAL]))
      limp[d] = 1;
    // lossy persistence (267-271)
    if (crash && bern8(word(D_COLORS, d), kf[KF_P_LOSE_UNSYNCED])) {
      term[d] = durable_term[d];
      voted_for[d] = durable_voted_for[d];
      log_len[d] = durable_len[d];
    }
  }
  __syncwarp();
  {  // partitions (234-265): one mutually exclusive event a tick
    if (node) alive[d] = s.I(S_NEW_ALIVE)[d];
    const float u_part = u01(word(D_U_PART, 0));
    const int asym_dst = randint(word(D_ASYM_DST, 0), 0, n);
    const int asym_off = randint(word(D_ASYM_OFF, 0), 1, n);
    const float th1 = kf[KF_P_REPARTITION];
    const float th2 = __fadd_rn(th1, kf[KF_P_HEAL]);
    const float th3 = __fadd_rn(th2, kf[KF_P_LEADER_PART]);
    const float th4 = __fadd_rn(th3, kf[KF_P_ASYM_CUT]);
    const bool do_part = u_part < th1;
    const bool do_heal = !do_part && u_part < th2;
    int lid = -1;
    for (int j = n - 1; j >= 0; --j)
      if (s.I(S_LEAD_PRE)[j]) lid = j;
    const bool do_lpart = u_part >= th2 && u_part < th3 && lid >= 0;
    lid = imax(lid, 0);
    const bool do_asym = u_part >= th3 && u_part < th4;
    const int cut_src = (asym_dst + asym_off) % n;
    for (int q = lane; q < nn; q += kWarp) {
      const int dst = q / n, src = q % n;
      bool a;
      if (do_part) {
        a = (u01(word(D_COLORS, dst)) < 0.5f) ==
            (u01(word(D_COLORS, src)) < 0.5f);
      } else if (do_heal) {
        a = true;
      } else if (do_lpart) {
        const bool ld = dst == lid || dst == (lid + 1) % n;
        const bool ls = src == lid || src == (lid + 1) % n;
        a = ld == ls;
      } else {
        a = adj[q] && !(do_asym && dst == asym_dst && src == cut_src);
      }
      adj[q] = a || dst == src;
    }
  }
  __syncwarp();

  // ------------------------------- deliver: RV responses (step.py 303-319)
  {
    int *mail = s.I(L_RV_RSP_T);
    if (node) {
      const int ps = pick_src(mail, adj, alive, d, n, t, false);
      for (int j = 0; j < n; ++j) {
        const int v = mail[d * n + j];
        const bool ok = alive[d] && v == t && adj[d * n + j];
        mail[d * n + j] = ok && j != ps ? t + 1 : v <= t ? 0 : v;
      }
      if (ps >= 0) {
        ++delivered;
        const int mterm = s.I(L_RV_RSP_TERM)[d * n + ps];
        if (mterm > term[d]) {
          term[d] = mterm;
          role[d] = kFollower;
          voted_for[d] = -1;
        }
        if (s.B(L_RV_RSP_GRANTED)[d * n + ps] && role[d] == kCandidate &&
            mterm == term[d])
          votes[d * n + ps] = 1;
      }
    }
  }
  __syncwarp();

  // ------------------------------- deliver: AE responses (step.py 321-348)
  {
    int *mail = s.I(L_AE_RSP_T);
    if (node) {
      const int ps = pick_src(mail, adj, alive, d, n, t, false);
      for (int j = 0; j < n; ++j) {
        const int v = mail[d * n + j];
        const bool ok = alive[d] && v == t && adj[d * n + j];
        mail[d * n + j] = ok && j != ps ? t + 1 : v <= t ? 0 : v;
      }
      if (ps >= 0) {
        ++delivered;
        const int q = d * n + ps;
        const int mterm = s.I(L_AE_RSP_TERM)[q];
        if (mterm > term[d]) {
          term[d] = mterm;
          role[d] = kFollower;
          voted_for[d] = -1;
        }
        if (role[d] == kLeader && mterm == term[d]) {
          const int m = s.I(L_AE_RSP_MATCH)[q];
          if (s.B(L_AE_RSP_SUCCESS)[q]) {
            match_idx[q] = imax(match_idx[q], m);
            next_idx[q] = imax(next_idx[q], m + 1);
          } else {
            next_idx[q] = imax(imin(next_idx[q], m + 1), 1);
          }
        }
      }
    }
  }
  __syncwarp();

  // ------------------------- deliver: install-snapshot (step.py 350-384)
  {
    int ps = -1, slen = 0, sterm = 0, shash = 0;
    bool inst = false, keep = false;
    if (node) {
      int *mail = s.I(L_SN_REQ_T);
      ps = pick_src(mail, adj, alive, d, n, t, true);
      for (int j = 0; j < n; ++j) {
        const int v = mail[d * n + j];
        const bool ok = alive[d] && v == t && adj[d * n + j] && alive[j];
        mail[d * n + j] = ok && j != ps ? t + 1 : v == t ? 0 : v;
      }
      if (ps >= 0) {
        ++delivered;
        const int mterm = s.I(L_SN_REQ_TERM)[d * n + ps];
        if (mterm > term[d]) {
          term[d] = mterm;
          role[d] = kFollower;
          voted_for[d] = -1;
        }
        const bool acc = mterm == term[d];
        if (acc && role[d] == kCandidate) role[d] = kFollower;
        if (acc)
          timer[d] = randint(word(D_SNAP_TMR, d), ki[KI_ETO_MIN],
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
        compact_floor[d] = slen;
        durable_len[d] = log_len[d];
        durable_term[d] = term[d];
        durable_voted_for[d] = voted_for[d];
        ++installs;
      }
      s.I(L_SNAP_INSTALLED_SRC)[d] = inst ? ps : -1;
      s.I(L_SNAP_INSTALLED_LEN)[d] = inst ? slen : 0;
    }
  }
  __syncwarp();

  // ------------------------------ deliver: RV requests (step.py 389-426)
  if (node) {
    int *mail = s.I(L_RV_REQ_T);
    const int ps = pick_src(mail, adj, alive, d, n, t, false);
    for (int j = 0; j < n; ++j) {
      const int v = mail[d * n + j];
      const bool ok = alive[d] && v == t && adj[d * n + j];
      mail[d * n + j] = ok && j != ps ? t + 1 : v == t ? 0 : v;
    }
    if (ps >= 0) {
      ++delivered;
      const int q = d * n + ps;
      const int mterm = s.I(L_RV_REQ_TERM)[q];
      if (mterm > term[d]) {
        term[d] = mterm;
        role[d] = kFollower;
        voted_for[d] = -1;
      }
      const int my_llt = log_len[d] > base[d]
                             ? log_term[d * cap + slot(log_len[d], cap)]
                             : snap_term[d];
      const int cand_llt = s.I(L_RV_REQ_LLT)[q];
      const int cand_lli = s.I(L_RV_REQ_LLI)[q];
      const bool log_ok = p.bug == kGrantAnyVote || cand_llt > my_llt ||
                          (cand_llt == my_llt && cand_lli >= log_len[d]);
      const bool grant = mterm == term[d] &&
                         (voted_for[d] == -1 || voted_for[d] == ps) && log_ok;
      if (grant) {
        voted_for[d] = ps;
        timer[d] = randint(word(D_GRANT_TMR, d), ki[KI_ETO_MIN],
                           ki[KI_ETO_MAX] + 1) + skew;
      }
      if (p.bug != kAckBeforeFsync) {
        durable_term[d] = term[d];
        durable_voted_for[d] = voted_for[d];
        durable_len[d] = log_len[d];
      }
      // the vote goes back in slot [candidate, voter]
      const uint32_t wn = word(D_RV_RSP_NET, d);
      if (!lost(wn, kf)) {
        const int r = ps * n + d;
        s.I(L_RV_RSP_T)[r] = t + net_delay(wn, ki) * limp[d];
        s.I(L_RV_RSP_TERM)[r] = term[d];
        s.B(L_RV_RSP_GRANTED)[r] = grant;
      }
    }
  }
  __syncwarp();

  // ------------------------------ deliver: AE requests (step.py 428-540)
  {
    int ps = -1, prev = 0, nent = 0, batch_end = 0, ae_commit = 0;
    bool success = false, conflict = false;
    uint64_t in_batch = 0;
    if (node) {
      int *mail = s.I(L_AE_REQ_T);
      ps = pick_src(mail, adj, alive, d, n, t, false);
      for (int j = 0; j < n; ++j) {
        const int v = mail[d * n + j];
        const bool ok = alive[d] && v == t && adj[d * n + j];
        mail[d * n + j] = ok && j != ps ? t + 1 : v == t ? 0 : v;
      }
      if (ps >= 0) {
        ++delivered;
        const int q = d * n + ps;
        const int mterm = s.I(L_AE_REQ_TERM)[q];
        if (mterm > term[d]) {
          term[d] = mterm;
          role[d] = kFollower;
          voted_for[d] = -1;
        }
        const bool acc = mterm == term[d];
        if (acc && role[d] == kCandidate) role[d] = kFollower;
        if (acc)
          timer[d] = randint(word(D_AE_TMR, d), ki[KI_ETO_MIN],
                             ki[KI_ETO_MAX] + 1) + skew;
        prev = s.I(L_AE_REQ_PREV)[q];
        const int mprev_term = s.I(L_AE_REQ_PREV_TERM)[q];
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
        nent = still ? imin(imax(imin(s.I(L_AE_REQ_N)[q], src_len - prev), 0),
                            ae_max)
                     : 0;
        int first_conf = kBig;
        for (int e = 0; e < ae_max; ++e) {
          const int a = prev + e + 1;
          bool inb = success && e < nent && a > my_base && a <= my_base + cap;
          if (p.bug == kNoTruncate) inb = inb && a > len;
          const int k = slot(a, cap);
          const int et = log_term[ps * cap + k];
          s.I(S_ENT_T)[d * ae_max + e] = et;
          s.I(S_ENT_V)[d * ae_max + e] = log_val[ps * cap + k];
          if (inb) {
            in_batch |= uint64_t{1} << e;
            if (a <= len && log_term[d * cap + k] != et) {
              conflict = true;
              first_conf = imin(first_conf, a);
            }
          }
        }
        if (conflict)
          durable_len[d] = imin(durable_len[d], first_conf - 1);
        // ring overflow: drop the tail
        batch_end = imin(prev + nent, my_base + cap);
        ae_commit = s.I(L_AE_REQ_COMMIT)[q];
      }
    }
    __syncwarp();  // the senders' logs are read
    if (node && ps >= 0) {
      for (int e = 0; e < ae_max; ++e) {
        if (!(in_batch >> e & 1)) continue;
        const int k = slot(prev + e + 1, cap);
        log_term[d * cap + k] = s.I(S_ENT_T)[d * ae_max + e];
        log_val[d * cap + k] = s.I(S_ENT_V)[d * ae_max + e];
      }
      if (success) {
        log_len[d] = conflict ? batch_end : imax(log_len[d], batch_end);
        commit[d] = imax(commit[d], imin(ae_commit, batch_end));
      }
      // failure hint for fast backtracking (term skip)
      int hint;
      if (prev > log_len[d]) {
        hint = log_len[d];
      } else {
        const int conf_term = term_at(log_term, snap_term, base, d, prev, cap);
        int first_abs = kBig;
        for (int k = 0; k < cap; ++k) {
          const int a = lane_abs(base[d], k, cap);
          if (a <= log_len[d] && log_term[d * cap + k] == conf_term)
            first_abs = imin(first_abs, a);
        }
        hint = imax(first_abs < kBig ? first_abs - 1 : base[d], base[d]);
      }
      const int rsp_match = success ? batch_end : hint;
      if (p.bug != kAckBeforeFsync) {
        durable_len[d] = log_len[d];
        durable_term[d] = term[d];
        durable_voted_for[d] = voted_for[d];
      }
      // keep-oldest: an occupied response slot keeps its message
      const uint32_t wn = word(D_AE_RSP_NET, d);
      const int r = ps * n + d;
      if (!lost(wn, kf) && s.I(L_AE_RSP_T)[r] == 0) {
        s.I(L_AE_RSP_T)[r] = t + net_delay(wn, ki) * limp[d];
        s.I(L_AE_RSP_TERM)[r] = term[d];
        s.B(L_AE_RSP_SUCCESS)[r] = success;
        s.I(L_AE_RSP_MATCH)[r] = rsp_match;
      }
    }
  }
  __syncwarp();

  // ------- election win, timers, client injection, heartbeat (542-601)
  if (node) {
    int nvotes = 0;
    for (int j = 0; j < n; ++j) nvotes += votes[d * n + j];
    if (alive[d] && role[d] == kCandidate && nvotes >= ki[KI_MAJORITY]) {
      role[d] = kLeader;
      for (int j = 0; j < n; ++j) {
        next_idx[d * n + j] = log_len[d] + 1;
        match_idx[d * n + j] = 0;
      }
      hb[d] = 0;
      if (log_len[d] - base[d] < cap) {  // the current-term no-op
        const int k = slot(log_len[d] + 1, cap);
        log_term[d * cap + k] = term[d];
        log_val[d * cap + k] = kNoopCmd;
        durable_len[d] = ++log_len[d];
      }
    }
    // election timeout (557-568)
    const bool running = alive[d] && role[d] != kLeader;
    if (running) --timer[d];
    const bool fired = running && timer[d] <= 0;
    if (fired) {
      ++term[d];
      role[d] = kCandidate;
      voted_for[d] = me;
      for (int j = 0; j < n; ++j) votes[d * n + j] = j == d;
      timer[d] = randint(word(D_ELECT_TMR, d), ki[KI_ETO_MIN],
                         ki[KI_ETO_MAX] + 1) + skew;
      durable_term[d] = term[d];
      durable_voted_for[d] = voted_for[d];
      durable_len[d] = log_len[d];
    }
    s.I(S_FIRED)[d] = fired;
    s.I(S_LLI)[d] = log_len[d];  // what a vote request carries: pre-inject
    s.I(S_LLT)[d] = log_len[d] > base[d]
                        ? log_term[d * cap + slot(log_len[d], cap)]
                        : snap_term[d];
    // client command injection at leaders (581-596)
    const bool lead = alive[d] && role[d] == kLeader;
    const bool inject = lead && u01(word(D_CLIENT, d)) < kf[KF_P_CLIENT_CMD] &&
                        log_len[d] - base[d] < cap &&
                        log_len[d] - commit[d] < ki[KI_FLOW_CAP];
    if (inject) {
      const int k = slot(log_len[d] + 1, cap);
      log_term[d * cap + k] = term[d];
      log_val[d * cap + k] = s.I(L_NEXT_CMD)[0] * n + me + 1;
      durable_len[d] = ++log_len[d];
    }
    s.I(S_INJECT)[d] = inject;
    // heartbeat (599-601)
    if (lead) --hb[d];
    const bool fire_hb = lead && hb[d] <= 0;
    if (fire_hb) hb[d] = ki[KI_HEARTBEAT_TICKS];
    s.I(S_LEAD)[d] = lead;
    s.I(S_FIRE_HB)[d] = fire_hb;
  }
  __syncwarp();

  // ------------- sends per (dst, src): vote requests (573-579), append
  // entries and install-snapshot from leaders (602-632)
  {
    for (int q = lane; q < nn; q += kWarp) {
      const int dst = q / n, src = q % n;
      const bool link = dst != src && adj[q];
      uint32_t wn = word(D_RV_REQ_NET, q);
      if (s.I(S_FIRED)[src] && link && !lost(wn, kf)) {
        s.I(L_RV_REQ_T)[q] = t + net_delay(wn, ki) * limp[src];
        s.I(L_RV_REQ_TERM)[q] = term[src];
        s.I(L_RV_REQ_LLI)[q] = s.I(S_LLI)[src];
        s.I(L_RV_REQ_LLT)[q] = s.I(S_LLT)[src];
      }
      const int r = src * n + dst;  // the leader's next index for dst
      const int next_t = next_idx[r];
      const bool need_snap = next_t <= base[src];
      const int prev_m = next_t - 1;
      wn = word(D_AE_REQ_NET, q);
      const bool pending = s.I(S_LEAD)[src] && next_t <= log_len[src];
      if ((s.I(S_FIRE_HB)[src] || pending) && link && !lost(wn, kf) &&
          !need_snap && s.I(L_AE_REQ_T)[q] == 0) {
        s.I(L_AE_REQ_T)[q] = t + net_delay(wn, ki) * limp[src];
        s.I(L_AE_REQ_TERM)[q] = term[src];
        s.I(L_AE_REQ_PREV)[q] = prev_m;
        s.I(L_AE_REQ_PREV_TERM)[q] =
            prev_m > base[src] ? log_term[src * cap + slot(prev_m, cap)]
                               : snap_term[src];
        s.I(L_AE_REQ_N)[q] = imin(imax(log_len[src] - prev_m, 0), ae_max);
        s.I(L_AE_REQ_COMMIT)[q] = commit[src];
      }
      wn = word(D_SN_REQ_NET, q);
      if (s.I(S_FIRE_HB)[src] && link && !lost(wn, kf) && need_snap &&
          s.I(L_SN_REQ_T)[q] == 0) {
        s.I(L_SN_REQ_T)[q] = t + net_delay(wn, ki) * limp[src];
        s.I(L_SN_REQ_TERM)[q] = term[src];
        next_idx[r] = base[src] + 1;
      }
    }
    if (lane == 0) {
      int any = 0;
      for (int j = 0; j < n; ++j) any |= s.I(S_INJECT)[j];
      s.I(L_NEXT_CMD)[0] += any;
    }
  }
  __syncwarp();

  // ---------------------------------- commit advance (step.py 634-647)
  if (node && s.I(S_LEAD)[d]) {
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

  // -------------------------------- oracle (step.py 649-656; oracle.py)
  {
    int viol = 0, xh = 0;
    if (node) {
      const bool lead = alive[d] && role[d] == kLeader;
      for (int j = 0; j < n; ++j) {
        if (j == d) continue;
        if (lead && alive[j] && role[j] == kLeader && term[j] == term[d])
          viol |= kViolDual;
        if (alive[d] && alive[j] && base[d] == base[j] && base[d] > 0 &&
            prefix_hash[d] != prefix_hash[j])
          viol |= kViolPrefix;
      }
      if (alive[d] && base[d] == s.I(L_SHADOW_BASE)[0] && base[d] > 0 &&
          prefix_hash[d] != s.I(L_SHADOW_PREFIX_HASH)[0])
        viol |= kViolPrefix;
    }
    // log matching over each unordered pair's ring overlap
    const int pairs = n * (n - 1) / 2;
    for (int q = lane; q < pairs; q += kWarp) {
      int i = 0, r = q;
      while (r >= n - 1 - i) r -= n - 1 - i, ++i;
      const int j = i + 1 + r;
      int min_bad = kBig, max_tm = 0;
      for (int k = 0; k < cap; ++k) {
        const int a = lane_abs(base[i], k, cap);
        if (a != lane_abs(base[j], k, cap) || a > log_len[i] || a > log_len[j])
          continue;
        const bool t_eq = log_term[i * cap + k] == log_term[j * cap + k];
        const bool v_eq = log_val[i * cap + k] == log_val[j * cap + k];
        if (t_eq) max_tm = imax(max_tm, a);
        if (!(t_eq && v_eq)) min_bad = imin(min_bad, a);
      }
      if (min_bad <= max_tm) viol |= kViolLogMatch;
    }
    // commit durability: slide the shadow window, fold what slid out, then
    // walk the nodes in order over each ring lane
    const int sb = s.I(L_SHADOW_BASE)[0], sl0 = s.I(L_SHADOW_LEN)[0];
    int need = 0;
    for (int j = 0; j < n; ++j)
      if (alive[j]) need = imax(need, commit[j]);
    const int new_base = imax(sb, need - cap);
    int *st = s.I(L_SHADOW_TERM), *sv = s.I(L_SHADOW_VAL);
    int sl = sl0;
    for (int k = lane; k < cap; k += kWarp) {
      const int old_abs = lane_abs(sb, k, cap);
      if (old_abs <= imin(new_base, sl0))
        xh ^= entry_mix(st[k], sv[k], old_abs);
      const int sh_abs = lane_abs(new_base, k, cap);
      int lt = st[k], lv = sv[k];
      sl = sl0;
      for (int i = 0; i < n; ++i) {
        const int c = commit[i];
        if (sh_abs == lane_abs(base[i], k, cap)) {
          const int it = log_term[i * cap + k], iv = log_val[i * cap + k];
          if (sh_abs <= imin(c, sl) && (lt != it || lv != iv))
            viol |= kViolShadow;
          if (sh_abs > sl && sh_abs <= c) lt = it, lv = iv;
        }
        sl = imax(sl, c);
      }
      st[k] = lt;
      sv[k] = lv;
    }
    for (int i = 0; i < n; ++i) sl = imax(sl, commit[i]);  // every lane's
    viol = static_cast<int>(
        __reduce_or_sync(kFull, static_cast<unsigned>(viol)));
    xh = xor_all(xh);
    int any_lead = 0;
    for (int j = 0; j < n; ++j) any_lead |= alive[j] && role[j] == kLeader;
    __syncwarp();  // the old shadow scalars are read
    if (lane == 0) {
      s.I(L_SHADOW_BASE)[0] = new_base;
      s.I(L_SHADOW_LEN)[0] = sl;
      s.I(L_SHADOW_PREFIX_HASH)[0] ^= xh;
      s.I(L_VIOLATIONS)[0] |= viol;
      int *fvt = s.I(L_FIRST_VIOLATION_TICK), *flt = s.I(L_FIRST_LEADER_TICK);
      if (fvt[0] < 0 && viol != 0) fvt[0] = t;
      if (flt[0] < 0 && any_lead) flt[0] = t;
    }
  }
  __syncwarp();

  // ------------------ compaction (680-694), background fsync (696-711)
  if (node) {
    const int boundary = ki[KI_COMPACT_AT_COMMIT]
                             ? commit[d]
                             : imin(compact_floor[d], commit[d]);
    if (alive[d] && boundary - base[d] >= ki[KI_COMPACT_EVERY]) {
      const int snap = term_at(log_term, snap_term, base, d, boundary, cap);
      int h = 0;
      for (int k = 0; k < cap; ++k) {
        const int a = lane_abs(base[d], k, cap);
        if (a <= boundary)
          h ^= entry_mix(log_term[d * cap + k], log_val[d * cap + k], a);
      }
      prefix_hash[d] ^= h;
      snap_term[d] = snap;
      base[d] = boundary;
      durable_len[d] = imax(durable_len[d], boundary);
    }
    const bool stall_on = alive[d] && ki[KI_FSYNC_STALL_TICKS] >= 1 &&
                          bern8(word(D_SNAP_TMR, d), kf[KF_P_FSYNC_STALL]);
    int stall;
    if (s.I(S_RESTART)[d])
      stall = 0;
    else if (stall_on)
      stall = randint8(word(D_GRANT_TMR, d), 1, ki[KI_FSYNC_STALL_TICKS]);
    else
      stall = imax(fsync_stall[d] - 1, 0);
    fsync_stall[d] = stall;
    if (alive[d] && (t + me) % ki[KI_FSYNC_EVERY] == 0 && stall == 0) {
      durable_len[d] = log_len[d];
      durable_term[d] = term[d];
      durable_voted_for[d] = voted_for[d];
    }
  }
  delivered = __reduce_add_sync(kFull, delivered);
  installs = __reduce_add_sync(kFull, installs);
  __syncwarp();
  if (lane == 0) {
    s.I(L_MSG_COUNT)[0] += delivered;
    s.I(L_SNAP_INSTALL_COUNT)[0] += installs;
    s.I(L_TICK)[0] = t;
  }
  __syncwarp();
}

// The chunk for cluster b: stage in, m ticks, stage out
__device__ void run_cluster(const Params &p, uint8_t *cl, int b, int lane) {
  const Block s{p, cl};
  stage(p, s, b, lane, true);
  for (int i = 0; i < p.m; ++i)
    tick(p, s, p.words + (static_cast<size_t>(i) * p.b + b) * p.total, lane);
  stage(p, s, b, lane, false);
}

}  // namespace k6
