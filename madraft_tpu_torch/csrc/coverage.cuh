// The coverage fingerprint's arithmetic, shared by kernel K5 (coverage.cu,
// once a tick over the batch) and K6's coverage variant (tick.cuh, inside
// the tick): the JAX reference's madraft_tpu/tpusim/coverage.py
// abstract_code / _fold_code / _mix32 / bitmap_index (lines 100-180).
//
// A cluster's code is sum node_i * a^(n-1-i) mod 2^32 over its nodes, a
// the node alphabet; node_i is node i's quantized tuple (node_code). The
// seen-set bit is the code itself in identity mode, else mix32(code)
// masked to the bitmap.

#pragma once

#include <cstdint>

namespace cov {

// murmur3 finalizer: full-avalanche u32 -> u32
__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// Node i's code in [0, alphabet): its role, alive flag, term rank (the
// nodes with a smaller term) and commit delta (commit - the cluster's least
// commit), rank and delta clipped below their level counts
__host__ __device__ __forceinline__ uint32_t node_code(int role, int alive,
                                                       int rank, int delta,
                                                       int levels_r,
                                                       int levels_c) {
  rank = rank < levels_r - 1 ? rank : levels_r - 1;
  delta = delta < 0 ? 0 : delta < levels_c - 1 ? delta : levels_c - 1;
  return static_cast<uint32_t>(((role * 2 + alive) * levels_r + rank) *
                                   levels_c + delta);
}

// The seen-set bit of a cluster's code
__host__ __device__ __forceinline__ uint32_t bit_index(uint32_t code,
                                                       bool identity,
                                                       int bits) {
  return identity ? code : mix32(code) & static_cast<uint32_t>(bits - 1);
}

}  // namespace cov
