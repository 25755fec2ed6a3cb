// Kernel K1: threefry2x32 (20 rounds) for the PyTorch port.
//
// Replaces the JAX reference's draw sites: madraft_tpu/tpusim/step.py
// _DrawBlock.__init__ (jax.random.bits of the tick's whole budget under
// fold_in(fold_in(cluster_key, t), 0)) and madraft_tpu/tpusim/engine.py
// _cluster_keys (fold_in of PRNGKey(seed) by cluster id). The Python side is
// madraft_tpu_torch/kernels/threefry.py, which holds the plain versions; the
// hash itself is in threefry.cuh.
//
// tick_blocks_kernel draws the words of a chunk of ticks in one launch:
// [n_ticks, B, total] words, row (i, c) under the key of cluster c at tick
// t0[c] + i. Bound: one chunk of T = 32 ticks at B = 4096, total = 133
// writes 139 MB of int64-held words (41.6 us at 3.35 TB/s) and hashes
// T x B x 135 pairs (about 2.1 G 32-bit operations, 31.7 us at 67 T/s), so
// its bound is the bytes it writes. What sets its time is the integer ALU
// pipe, 64 lanes per SM per clock against some 70 instructions a hash: 78
// us a chunk on the H100, 53% of the bound. Design:
// - one launch per chunk instead of one per tick, so the launch latency
//   (several microseconds) no longer exceeds the work it carries;
// - a warp owns a tile of 16 consecutive (tick, cluster) rows: lane l < 16
//   derives the key of row l (the two fold_in hashes, at once), then the
//   warp walks the tile's words flat, each lane taking its row's key from
//   the owning lane with one shuffle, so every lane hashes on every step
//   and each warp store is 32 consecutive words; 16 rows rather than 32
//   give the SMs twice the warps to hide the hash's latency (78 vs 80 us
//   a chunk on the H100);
// - the hash's additions run on the FMA pipe (threefry.cuh);
// - the kernel reads the int64-held keys and writes the int64-held words
//   the step consumes, so no conversion pass runs before or after it.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

using madraft::threefry2x32;

__global__ void hash_pairs_kernel(const uint32_t *__restrict__ keys,
                                  const uint32_t *__restrict__ x0,
                                  const uint32_t *__restrict__ x1,
                                  uint32_t *__restrict__ y0,
                                  uint32_t *__restrict__ y1, int64_t total,
                                  int m) {
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = idx / m;
    uint32_t a = x0[idx], b = x1[idx];
    threefry2x32(keys[2 * row], keys[2 * row + 1], a, b);
    y0[idx] = a;
    y1[idx] = b;
  }
}

constexpr int kTickThreads = 128;
constexpr int kTileRows = 16;  // rows a warp draws; at most 32

__global__ void __launch_bounds__(kTickThreads)
    tick_blocks_kernel(const int64_t *__restrict__ keys,
                       const int32_t *__restrict__ t0,
                       int64_t *__restrict__ out, int b, int n_ticks,
                       int total, int partitionable) {
  const int lane = threadIdx.x & 31;
  const int64_t rows = (int64_t)n_ticks * b;
  const int64_t tiles = (rows + kTileRows - 1) / kTileRows;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x / 32);
  // legacy layout: pair j = (j, j + h) gives words j and j + h
  const int h = (total + 1) / 2;
  const int per = partitionable ? total : h;  // hashes per row
  const uint32_t one = n_ticks > 0 ? 1u : 0u;  // 1, unknown at compile time
  for (int64_t tile = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) / 32;
       tile < tiles; tile += warps) {
    const int64_t row0 = tile * kTileRows;
    const int nrows = rows - row0 < kTileRows ? static_cast<int>(rows - row0)
                                              : kTileRows;
    uint32_t k0 = 0u, k1 = 0u;
    if (lane < nrows) {
      const int64_t row = row0 + lane;
      const int i = static_cast<int>(row / b);
      const int c = static_cast<int>(row - (int64_t)i * b);
      k0 = static_cast<uint32_t>(keys[2 * c]);
      k1 = static_cast<uint32_t>(keys[2 * c + 1]);
      madraft::tick_key(k0, k1,
                        static_cast<uint32_t>(t0[c]) + static_cast<uint32_t>(i));
    }
    int64_t *dst = out + row0 * total;
    const int work = nrows * per;
    // flat index f = lane + 32 * step over the tile, as (row r, hash j)
    int r = 0, j = lane;
    while (j >= per) {
      j -= per;
      ++r;
    }
    const int steps = (work + 31) / 32;
    for (int s = 0; s < steps; ++s) {
      const uint32_t a = __shfl_sync(0xffffffffu, k0, r & 31);
      const uint32_t bk = __shfl_sync(0xffffffffu, k1, r & 31);
      if (s * 32 + lane < work) {
        int64_t *w = dst + (int64_t)r * total;
        if (partitionable) {
          // counters (0, j); word j = y0 ^ y1
          uint32_t x0 = 0u, x1 = static_cast<uint32_t>(j);
          threefry2x32(a, bk, x0, x1, one);
          w[j] = static_cast<int64_t>(x0 ^ x1);
        } else {
          // counters 0..total-1 (+ one 0 pad when odd) split in halves;
          // words = [y0 outputs, y1 outputs][:total]
          const bool hi_ok = j + h < total;
          uint32_t x0 = static_cast<uint32_t>(j);
          uint32_t x1 = hi_ok ? static_cast<uint32_t>(j + h) : 0u;
          threefry2x32(a, bk, x0, x1, one);
          w[j] = static_cast<int64_t>(x0);
          if (hi_ok) w[j + h] = static_cast<int64_t>(x1);
        }
      }
      j += 32;
      while (j >= per) {
        j -= per;
        ++r;
      }
    }
  }
}

}  // namespace

extern "C" int threefry_hash_pairs(const void *keys, const void *x0,
                                   const void *x1, void *y0, void *y1, int b,
                                   int m, void *stream) {
  const int64_t total = (int64_t)b * m;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  hash_pairs_kernel<<<(unsigned)blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t *>(keys), static_cast<const uint32_t *>(x0),
      static_cast<const uint32_t *>(x1), static_cast<uint32_t *>(y0),
      static_cast<uint32_t *>(y1), total, m);
  return static_cast<int>(cudaGetLastError());
}

// keys [b, 2] int64 (u32 values), t0 [b] int32 -> out [n_ticks, b, total]
// int64 (u32 values).
extern "C" int threefry_tick_blocks(const void *keys, const void *t0,
                                    void *out, int b, int n_ticks, int total,
                                    int partitionable, void *stream) {
  const int64_t tiles = ((int64_t)n_ticks * b + kTileRows - 1) / kTileRows;
  const int64_t warps_per_block = kTickThreads / 32;
  int64_t blocks = (tiles + warps_per_block - 1) / warps_per_block;
  if (blocks > (1 << 30)) blocks = 1 << 30;
  tick_blocks_kernel<<<(unsigned)blocks, kTickThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t *>(keys), static_cast<const int32_t *>(t0),
      static_cast<int64_t *>(out), b, n_ticks, total, partitionable);
  return static_cast<int>(cudaGetLastError());
}
