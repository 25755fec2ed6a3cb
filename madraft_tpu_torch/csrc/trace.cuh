// K8's device code: one tick's flight-recorder row (trace.cu holds the
// kernel, its launch and the note on what it replaces, its bound and
// design). Built by nvcc through trace.cu and by g++ through
// tests/kernel_host_emu.cpp: record_cluster is a function of (cluster,
// thread t of T) whose threads share nothing, so the host runs them one
// after another.

#pragma once

#include <cstdint>

namespace k8 {

constexpr int kMaxSegs = 32;   // TickRecord has 27 fields
constexpr int kMail = 5;       // rv_req, rv_rsp, ae_req, ae_rsp, sn_req

// How a segment of the row is computed from the states
enum Kind {
  kCopy32 = 0,  // an int32 leaf of the post-tick state, count a lane
  kCopyBool = 1,  // a bool leaf, as 0 / 1
  kAdjMask = 2,  // n row bitmasks of the post-tick adj: bit s of row d
  kDeliveries = 3,  // the five exact delivery counts of the tick
};

// The wrapper's descriptor (kernels/trace.py _descriptor): these int64
// words, then 3 a segment (kind, source pointer, count a lane)
enum Desc {
  kB, kN, kW, kNSegs, kOut, kTick, kAlive, kAdj, kMailT,
  kHeader = kMailT + kMail
};

struct Seg {
  int kind, count;
  const void *src;
};

struct Params {
  Seg seg[kMaxSegs];
  int b, n, w, n_segs;
  int32_t *out;                 // [b, w], this tick's rows
  const int32_t *tick;          // post-tick state [b]
  const uint8_t *alive, *adj;   // post-tick [b, n], [b, n, n]
  const int32_t *mail[kMail];   // pre-tick mailbox stamps [b, n, n]
};

template <typename T>
inline T *ptr_of(int64_t w) {
  return reinterpret_cast<T *>(static_cast<intptr_t>(w));
}

inline bool set_params(Params &p, const int64_t *d, int n_desc) {
  if (n_desc < kHeader) return false;
  p.b = static_cast<int>(d[kB]);
  p.n = static_cast<int>(d[kN]);
  p.w = static_cast<int>(d[kW]);
  p.n_segs = static_cast<int>(d[kNSegs]);
  if (p.b < 1 || p.n < 1 || p.n > 31 || p.n_segs < 1 ||
      p.n_segs > kMaxSegs || n_desc != kHeader + 3 * p.n_segs)
    return false;
  p.out = ptr_of<int32_t>(d[kOut]);
  p.tick = ptr_of<const int32_t>(d[kTick]);
  p.alive = ptr_of<const uint8_t>(d[kAlive]);
  p.adj = ptr_of<const uint8_t>(d[kAdj]);
  for (int k = 0; k < kMail; ++k)
    p.mail[k] = ptr_of<const int32_t>(d[kMailT + k]);
  int cols = 0;
  for (int s = 0; s < p.n_segs; ++s) {
    const int64_t *g = d + kHeader + 3 * s;
    p.seg[s] = {static_cast<int>(g[0]), static_cast<int>(g[2]),
                ptr_of<const void>(g[1])};
    if (p.seg[s].kind < kCopy32 || p.seg[s].kind > kDeliveries) return false;
    cols += p.seg[s].count;
  }
  return cols == p.w;
}

// Mailbox k's deliveries this tick: a slot due now (stamp == the post-tick
// tick) is delivered iff its destination is alive and the link src -> dst
// is up after the tick's faults; one source a destination is delivered,
// so the count is the destinations with any such slot. An install-snapshot
// slot also needs a live sender (the reference's trace.py _deliveries)
__device__ __forceinline__ int32_t deliveries(const Params &p, int c,
                                              int k) {
  const int n = p.n;
  const int32_t t = p.tick[c];
  const uint8_t *alive = p.alive + static_cast<int64_t>(c) * n;
  const uint8_t *adj = p.adj + static_cast<int64_t>(c) * n * n;
  const int32_t *mail = p.mail[k] + static_cast<int64_t>(c) * n * n;
  int32_t count = 0;
  for (int d = 0; d < n; ++d) {
    bool any = false;
    for (int s = 0; s < n; ++s)
      any |= mail[d * n + s] == t && alive[d] && adj[d * n + s] &&
             (k != kMail - 1 || alive[s]);
    count += any;
  }
  return count;
}

// Thread t of T writes columns e = t, t + T, ... of each segment of
// cluster c's row
__device__ __forceinline__ void record_cluster(const Params &p, int c, int t,
                                              int T) {
  int32_t *row = p.out + static_cast<int64_t>(c) * p.w;
  const int n = p.n;
  int col = 0;
  for (int s = 0; s < p.n_segs; ++s) {
    const Seg &g = p.seg[s];
    for (int e = t; e < g.count; e += T) {
      int32_t v = 0;
      if (g.kind == kCopy32) {
        v = static_cast<const int32_t *>(g.src)[static_cast<int64_t>(c) *
                                                    g.count + e];
      } else if (g.kind == kCopyBool) {
        v = static_cast<const uint8_t *>(g.src)[static_cast<int64_t>(c) *
                                                    g.count + e] != 0;
      } else if (g.kind == kAdjMask) {
        const uint8_t *adj = p.adj + (static_cast<int64_t>(c) * n + e) * n;
        for (int j = 0; j < n; ++j) v |= (adj[j] != 0) << j;
      } else {
        v = deliveries(p, c, e);
      }
      row[col + e] = v;
    }
    col += g.count;
  }
}

}  // namespace k8
