// Kernel K3: the packed carry's pack and unpack for the PyTorch port.
//
// Replaces the JAX reference's madraft_tpu/tpusim/state.py pack_state /
// unpack_state (vmapped over the lanes): wide ClusterState (int32 and bool
// leaves) <-> PackedClusterState (u8/u16/u32/i8/i16/i32 leaves). The Python
// side is madraft_tpu_torch/kernels/pack.py; the plain versions are
// madraft_tpu_torch/tpusim/state.py pack_state / unpack_state.
//
// One launch per direction covers every leaf. The wrapper passes a leaf
// table (source, destination, item count, kind, the two element types and
// the leaf's first block) as one kernel parameter; block b finds its leaf by
// a binary search of the table's first blocks, and each thread handles
// kItemsPerThread items of that leaf. An item is one OUTPUT element, so a
// pack of an [n, n] bool matrix reads a row of n flags per item and an
// unpack of it reads one row word per item. Kinds:
//   CAST   narrow <-> wide by value (signed types sign-extend on unpack, so
//          the -1 sentinels of voted_for and the first-tick fields hold);
//   CMD    the same, with NOOP_CMD <-> the cmd type's reserved max;
//   REL    mailbox stamps stored tick-relative in a u8: stamp > 0 ?
//          stamp - tick : 0, and back r > 0 ? tick + r : 0, with the lane's
//          tick read from the tick leaf;
//   BITS1  n flags <-> one u32 word (alive and the [n, n] row masks);
//   BITS2  n roles of 2 bits <-> one u32 word.
// Exactness needs every value inside config.packed_bounds, which
// state.packed_layout_reason checks for a run before the engine packs; the
// kernel computes in 64 bits and truncates on store, as the reference's
// casts do, and never relies on a wrap.
//
// Bound: at 4096 lanes of the 5-node flagship one direction reads one form
// and writes the other, 4096 x (5477 + 2612) B = 33.1 MB, about 9.9 us at
// 3.35 TB/s; the arithmetic is a few operations a byte, far under the
// integer rate, so the bytes bound it. This first version is the simple
// one: one item per thread and step, byte-wide loads and stores of the
// narrow leaves, the per-element type switch uniform over a block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLeaves = 72;
constexpr int kThreads = 256;
constexpr int kItemsPerThread = 4;
constexpr int kItemsPerBlock = kThreads * kItemsPerThread;
constexpr int64_t kNoopCmd = 1 << 30;  // config.NOOP_CMD

enum Type : int { U8 = 0, I8 = 1, U16 = 2, I16 = 3, U32 = 4, I32 = 5 };
enum Kind : int { CAST = 0, CMD = 1, REL = 2, BITS1 = 3, BITS2 = 4 };

struct Leaf {
  const void *src;
  void *dst;
  int items;     // output elements
  int per_lane;  // output elements per lane (REL reads the lane's tick)
  int kind;
  int src_type;
  int dst_type;
  int block0;    // first block of this leaf
};

struct Params {
  Leaf leaf[kMaxLeaves];
  const void *tick;  // the source form's tick leaf
  int tick_type;
  int n_leaves;
  int n;             // nodes: flags or roles per BITS word
  int64_t noop_code;
};

__device__ __forceinline__ int64_t load(const void *p, unsigned i, int t) {
  switch (t) {
    case U8: return static_cast<const uint8_t *>(p)[i];
    case I8: return static_cast<const int8_t *>(p)[i];
    case U16: return static_cast<const uint16_t *>(p)[i];
    case I16: return static_cast<const int16_t *>(p)[i];
    case U32: return static_cast<const uint32_t *>(p)[i];
    default: return static_cast<const int32_t *>(p)[i];
  }
}

// Stores the low bits of v: signed and unsigned types of one width write
// the same bytes.
__device__ __forceinline__ void store(void *p, unsigned i, int t, int64_t v) {
  switch (t) {
    case U8:
    case I8: static_cast<uint8_t *>(p)[i] = static_cast<uint8_t>(v); break;
    case U16:
    case I16: static_cast<uint16_t *>(p)[i] = static_cast<uint16_t>(v); break;
    default: static_cast<uint32_t *>(p)[i] = static_cast<uint32_t>(v); break;
  }
}

template <bool kPack>
__device__ __forceinline__ void convert(const Params &p) {
  const int b = static_cast<int>(blockIdx.x);
  int lo = 0, hi = p.n_leaves - 1;
  while (lo < hi) {  // the last leaf whose first block is <= b
    const int mid = (lo + hi + 1) >> 1;
    if (p.leaf[mid].block0 <= b) lo = mid; else hi = mid - 1;
  }
  const Leaf &L = p.leaf[lo];
  const unsigned n = static_cast<unsigned>(p.n);
  const unsigned first =
      static_cast<unsigned>(b - L.block0) * kItemsPerBlock + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kItemsPerThread; ++k) {
    const unsigned i = first + k * kThreads;
    if (i >= static_cast<unsigned>(L.items)) return;
    int64_t v;
    switch (L.kind) {
      case CAST:
        v = load(L.src, i, L.src_type);
        break;
      case CMD: {
        const int64_t x = load(L.src, i, L.src_type);
        v = kPack ? (x == kNoopCmd ? p.noop_code : x)
                  : (x == p.noop_code ? kNoopCmd : x);
        break;
      }
      case REL: {
        const int64_t x = load(L.src, i, L.src_type);
        const int64_t t =
            load(p.tick, i / static_cast<unsigned>(L.per_lane), p.tick_type);
        v = x > 0 ? (kPack ? x - t : t + x) : 0;
        break;
      }
      default: {
        const unsigned w = L.kind == BITS2 ? 2 : 1;
        if (kPack) {
          v = 0;
          for (unsigned j = 0; j < n; ++j)
            v |= load(L.src, i * n + j, L.src_type) << (w * j);
        } else {
          v = (load(L.src, i / n, L.src_type) >> (w * (i % n))) &
              ((1 << w) - 1);
        }
      }
    }
    store(L.dst, i, L.dst_type, v);
  }
}

__global__ void __launch_bounds__(kThreads)
    pack_kernel(const __grid_constant__ Params p) {
  convert<true>(p);
}

__global__ void __launch_bounds__(kThreads)
    unpack_kernel(const __grid_constant__ Params p) {
  convert<false>(p);
}

}  // namespace

// table: n_leaves rows of 8 int64 (src, dst, items, per_lane, kind,
// src_type, dst_type, block0), leaves in block order; pack = 1 packs,
// 0 unpacks. Returns the launch's cudaGetLastError().
extern "C" int pack_launch(const int64_t *table, int n_leaves, int n_nodes,
                           const void *tick, int tick_type, int64_t noop_code,
                           int total_blocks, int pack, void *stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_nodes < 1 || n_nodes > 16 ||
      total_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  for (int l = 0; l < n_leaves; ++l) {
    const int64_t *r = table + 8 * l;
    p.leaf[l].src = reinterpret_cast<const void *>(r[0]);
    p.leaf[l].dst = reinterpret_cast<void *>(r[1]);
    p.leaf[l].items = static_cast<int>(r[2]);
    p.leaf[l].per_lane = static_cast<int>(r[3]);
    p.leaf[l].kind = static_cast<int>(r[4]);
    p.leaf[l].src_type = static_cast<int>(r[5]);
    p.leaf[l].dst_type = static_cast<int>(r[6]);
    p.leaf[l].block0 = static_cast<int>(r[7]);
  }
  p.tick = tick;
  p.tick_type = tick_type;
  p.n_leaves = n_leaves;
  p.n = n_nodes;
  p.noop_code = noop_code;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pack)
    pack_kernel<<<total_blocks, kThreads, 0, s>>>(p);
  else
    unpack_kernel<<<total_blocks, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
