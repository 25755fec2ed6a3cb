// The staging K10 and K11 share: a cluster's (or deployment's) rows of
// the leaves a service tick writes, copied into the block's region of
// shared memory at the tick's start and back to the outputs at its end,
// by every thread of the block. Built by nvcc through ctrler.cu and
// shardkv.cu, and by g++ through the tests' host builds, where each copy
// is a plain one.
//
// A launch's plan (Plan, made on the host by plan()) sorts the rows into
// three kinds, each concatenated: bulk rows (4-byte elements, a row a
// multiple of 16 bytes and at least kBulkMin, its input and output 16-byte
// aligned) move by one TMA bulk copy each into the region, completing on
// the block's mbarrier, and back by 16-byte stores; word rows (the other
// 4-byte rows) move by 4-byte cp.async copies, a word a thread, and back
// by 4-byte stores; byte rows (1-byte elements, whose rows start at any
// byte) move a word of the region a thread, by byte loads and stores.
// The threads stride over each kind's concatenated units (a bulk row, a
// word, a byte row's word), so every copy of the tick is in flight at
// once and the block waits once, at the end of load().
//
// In place (MADRAFT_STAGE_IN_PLACE, K6-shardkv's builds of tick.cu, where
// the service tick runs every tick of a chunk on rows that the launch
// itself rewrote the tick before): every row is a word or byte row, every
// load a plain coherent one (no TMA, no read-only cache, no cp.async), and
// a row whose input is its output is not copied.

#pragma once

#include <cstdint>
#include <cstring>

namespace stage {

enum Kind { kBulk, kWord, kByte };

// A bulk row's least size: a TMA copy of a few bytes costs more than the
// cp.async words it replaces
constexpr int kBulkMin = 128;

// One leaf's row of a cluster: its input and output (rows of count
// elements of `bytes` bytes, cluster c's at c * count * bytes), its byte
// offset in the region, and its first unit in its kind's concatenation
// (bulk: 16-byte quads, at write-back; word: words; byte: the region's
// words)
struct Row {
  const void *in;
  void *out;
  int count, bytes, off, first;
};

template <int N>
struct Plan {
  Row row[N];         // the bulk rows, then the word rows, then the byte
                      // rows
  int n[3];           // rows of each kind
  int units[3];       // bulk: rows; word: words; byte: words
  int quads;          // the bulk rows' 16-byte quads
  int bulk_bytes;     // a cluster's bulk bytes: the mbarrier's transaction
                      // count
};

// Whether a row of count elements of `bytes` bytes a cluster, at in and
// out, moves as a bulk row (its region offset then 16-byte aligned)
inline bool bulk(const void *in, const void *out, int count, int bytes) {
#ifdef MADRAFT_STAGE_IN_PLACE
  return false;
#endif
  return bytes == 4 && count * 4 % 16 == 0 && count * 4 >= kBulkMin &&
         (reinterpret_cast<uintptr_t>(in) |
          reinterpret_cast<uintptr_t>(out)) % 16 == 0;
}

// The plan of `rows` rows (in, out, count, bytes, off as the leaf table
// gives them; a row of count 0 is left out). Returns false for a row
// whose region offset does not keep its kind's alignment.
template <int N>
inline bool plan(Plan<N> &pl, const Row *rows, int n_rows) {
  int at = 0;
  for (int k = 0; k < 3; ++k) {
    pl.n[k] = pl.units[k] = 0;
    for (int r = 0; r < n_rows; ++r) {
      Row x = rows[r];
      if (x.count == 0) continue;
      const int kind = x.bytes == 1 ? kByte
                       : bulk(x.in, x.out, x.count, x.bytes) ? kBulk
                                                             : kWord;
      if (kind != k) continue;
      if (x.off % (kind == kBulk ? 16 : 4)) return false;
      x.first = pl.units[k];
      pl.units[k] += kind == kBulk ? 1 : kind == kWord ? x.count
                                                       : (x.count + 3) / 4;
      pl.row[at++] = x;
      ++pl.n[k];
    }
  }
  pl.quads = pl.bulk_bytes = 0;
  for (int r = 0; r < pl.n[kBulk]; ++r) {
    pl.row[r].first = pl.quads;  // write-back counts the bulk rows' quads
    pl.quads += pl.row[r].count / 4;
    pl.bulk_bytes += pl.row[r].count * 4;
  }
  return true;
}

// ------------------------------------------------------ the copies
__device__ __forceinline__ uint32_t smem_addr(const void *p) {
#ifdef __CUDA_ARCH__
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
#else
  return 0;
#endif
}

// The block's mbarrier, by one thread before the block's first barrier:
// armed for the bulk rows' bytes
__device__ __forceinline__ void arm(uint64_t *bar, int bulk_bytes) {
#ifdef __CUDA_ARCH__
  const uint32_t a = smem_addr(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(a)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(a), "r"(bulk_bytes)
               : "memory");
#else
  (void)bar;
  (void)bulk_bytes;
#endif
}

__device__ __forceinline__ void bulk_load(void *dst, const void *src,
                                          int bytes, uint64_t *bar) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
#else
  (void)bar;
  std::memcpy(dst, src, bytes);
#endif
}

__device__ __forceinline__ void word_load(void *dst, const void *src) {
#if defined(__CUDA_ARCH__) && !defined(MADRAFT_STAGE_IN_PLACE)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
#else
  std::memcpy(dst, src, 4);
#endif
}

// Every copy of load() landed in the region (the caller's barrier then
// shows it to the block)
__device__ __forceinline__ void wait(uint64_t *bar, int bulk_bytes) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (bulk_bytes == 0) return;
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a)
        : "memory");
#else
  (void)bar;
  (void)bulk_bytes;
#endif
}

// Loads from an input, which stays as it is for the whole launch (the
// state is written out of place): through the read-only cache
__device__ __forceinline__ uint32_t ld_byte(const uint8_t *x) {
#if defined(__CUDA_ARCH__) && !defined(MADRAFT_STAGE_IN_PLACE)
  return __ldg(x);
#else
  return *x;
#endif
}

__device__ __forceinline__ int32_t ld_word(const int32_t *x) {
#if defined(__CUDA_ARCH__) && !defined(MADRAFT_STAGE_IN_PLACE)
  return __ldg(x);
#else
  return *x;
#endif
}

// 16 bytes of an input to an output
__device__ __forceinline__ void copy16g(void *dst, const void *src) {
#if defined(__CUDA_ARCH__) && !defined(MADRAFT_STAGE_IN_PLACE)
  *reinterpret_cast<uint4 *>(dst) = __ldg(reinterpret_cast<const uint4 *>(src));
#else
  std::memcpy(dst, src, 16);
#endif
}

// The row of a kind's concatenation that holds unit u: from the row `at`
// on (the units a thread visits only grow), below `end`, the kind's last
// row plus one
template <int N>
__device__ __forceinline__ int row_of(const Plan<N> &pl, int end, int u,
                                      int at) {
  while (at + 1 < end && u >= pl.row[at + 1].first) ++at;
  return at;
}

// 16 bytes of the region to an output
__device__ __forceinline__ void copy16(void *dst, const void *src) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4 *>(dst) = *reinterpret_cast<const uint4 *>(src);
#else
  std::memcpy(dst, src, 16);
#endif
}

// Cluster c's row of count words from an input straight to its output
// (a row the tick does not stage), by the block: in 16-byte quads when
// `quads` (the row a multiple of 16 bytes, both ends 16-byte aligned),
// else in words, four loads in flight a thread
__device__ __forceinline__ void copy_row(const void *in, void *out,
                                         int count, int c, bool quads,
                                         int tid, int T) {
  if (in == out) return;  // in place: the row is already there
  const int64_t at = static_cast<int64_t>(c) * count;
  const int32_t *src = static_cast<const int32_t *>(in) + at;
  int32_t *dst = static_cast<int32_t *>(out) + at;
  if (quads) {
#pragma unroll 4
    for (int q = tid; q < count / 4; q += T) copy16g(dst + 4 * q, src + 4 * q);
    return;
  }
#pragma unroll 4
  for (int e = tid; e < count; e += T) dst[e] = ld_word(src + e);
}

// Cluster c's rows into the region (thread tid of T): the bulk rows'
// TMA copies, the word rows' cp.async words, the byte rows' words. The
// caller waits for them (wait()) after issuing its other loads
template <int N>
__device__ __forceinline__ void load(const Plan<N> &pl, unsigned char *region,
                                     uint64_t *bar, int c, int tid, int T) {
  for (int r = tid; r < pl.n[kBulk]; r += T) {
    const Row &x = pl.row[r];
    const int bytes = x.count * 4;
    bulk_load(region + x.off,
              static_cast<const unsigned char *>(x.in) +
                  static_cast<int64_t>(c) * bytes,
              bytes, bar);
  }
  const int w_end = pl.n[kBulk] + pl.n[kWord], b_end = w_end + pl.n[kByte];
  int r = pl.n[kBulk];
  for (int u = tid; u < pl.units[kWord]; u += T) {
    r = row_of(pl, w_end, u, r);
    const Row &x = pl.row[r];
    const int e = u - x.first;
    word_load(region + x.off + 4 * e,
              static_cast<const int32_t *>(x.in) +
                  static_cast<int64_t>(c) * x.count + e);
  }
  r = w_end;
  for (int u = tid; u < pl.units[kByte]; u += T) {
    r = row_of(pl, b_end, u, r);
    const Row &x = pl.row[r];
    const int e = 4 * (u - x.first);
    const uint8_t *src = static_cast<const uint8_t *>(x.in) +
                         static_cast<int64_t>(c) * x.count;
    uint32_t w = 0;
    for (int j = 0; j < 4 && e + j < x.count; ++j)
      w |= ld_byte(src + e + j) << (8 * j);
    *reinterpret_cast<uint32_t *>(region + x.off + e) = w;
  }
}

// The region's rows to cluster c's outputs (thread tid of T): the bulk
// rows by 16-byte stores, the word rows by words, the byte rows' bytes
template <int N>
__device__ __forceinline__ void store(const Plan<N> &pl,
                                      const unsigned char *region, int c,
                                      int tid, int T) {
  const int w_end = pl.n[kBulk] + pl.n[kWord], b_end = w_end + pl.n[kByte];
  int r = 0;
  for (int u = tid; u < pl.quads; u += T) {
    r = row_of(pl, pl.n[kBulk], u, r);
    const Row &x = pl.row[r];
    const int q = u - x.first;
    copy16(static_cast<unsigned char *>(x.out) +
               (static_cast<int64_t>(c) * x.count + 4 * q) * 4,
           region + x.off + 16 * q);
  }
  r = pl.n[kBulk];
  for (int u = tid; u < pl.units[kWord]; u += T) {
    r = row_of(pl, w_end, u, r);
    const Row &x = pl.row[r];
    const int e = u - x.first;
    (static_cast<int32_t *>(x.out) + static_cast<int64_t>(c) * x.count)[e] =
        *reinterpret_cast<const int32_t *>(region + x.off + 4 * e);
  }
  r = w_end;
  for (int u = tid; u < pl.units[kByte]; u += T) {
    r = row_of(pl, b_end, u, r);
    const Row &x = pl.row[r];
    const int e = 4 * (u - x.first);
    uint8_t *dst = static_cast<uint8_t *>(x.out) +
                   static_cast<int64_t>(c) * x.count;
    for (int j = 0; j < 4 && e + j < x.count; ++j)
      dst[e + j] = region[x.off + e + j];
  }
}

}  // namespace stage
