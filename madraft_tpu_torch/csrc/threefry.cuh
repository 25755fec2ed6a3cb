// threefry2x32 (20 rounds) as device functions, shared by the kernels that
// draw the simulator's random words (threefry.cu, and K6's tick in
// tick.cuh, K7's harvest in harvest.cuh and K9's kv service tick in kv.cuh,
// which the host tests also build with g++: the intrinsics have host
// twins), and the jax.random operations K7 and K9 draw with (bits, split,
// uniform, randint) under both counter layouts.
//
// Bit-exact with JAX's threefry2x32 (jax/_src/prng.py). All arithmetic is
// uint32, where wrap-around is defined; a rotation is one funnel shift.
//
// A hash is some 70 integer instructions, and a kernel that does little
// else is bound by the integer ALU pipe (64 lanes per SM per clock on
// Hopper). Given a 1 the compiler cannot fold (``one``, read at run time),
// the additions become multiply-adds a * one + c, which ptxas issues on
// the FMA pipe; the rotations and XORs stay on the ALU pipe. On the H100
// this took a 32-tick draw chunk from 89 to 80 us. With the default
// ``one`` = 1 the multiply folds away and the adds are plain adds.

#pragma once

#include <cstdint>

namespace madraft {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(x, x, r);
#else
  return (x << r) | (x >> (32 - r));  // r is 6..29
#endif
}

// a * one + c, as one multiply-add
__device__ __forceinline__ uint32_t mad_one(uint32_t a, uint32_t one,
                                            uint32_t c) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(one), "r"(c));
  return d;
#else
  return a * one + c;
#endif
}

// Hashes the counter pair (x0, x1) in place under the key (k0, k1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t &x0, uint32_t &x1,
                                             uint32_t one = 1u) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 = mad_one(x1, one, x0);
      x1 = rotl32(x1, rot[i & 1][j]) ^ x0;
    }
    x0 = mad_one(ks[(i + 1) % 3], one, x0);
    x1 = mad_one(ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1), one, x1);
  }
}

// fold_in(key, data) = threefry(key, (0, data)).
__device__ __forceinline__ void fold_in(uint32_t &k0, uint32_t &k1,
                                        uint32_t data) {
  uint32_t x0 = 0u, x1 = data;
  threefry2x32(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

// The key a tick draws its words under: fold_in(fold_in(key, t), 0).
__device__ __forceinline__ void tick_key(uint32_t &k0, uint32_t &k1,
                                         uint32_t t) {
  fold_in(k0, k1, t);
  fold_in(k0, k1, 0u);
}

// The float32 of a 32-bit pattern
__device__ __forceinline__ float as_float(uint32_t w) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(w);
#else
  float f;
  __builtin_memcpy(&f, &w, sizeof f);
  return f;
#endif
}

// jax.random.uniform's float32 on [0, 1) from a word: the top 23 bits as
// the mantissa of a float in [1, 2), minus 1 (exact), floored at 0
__device__ __forceinline__ float uniform(uint32_t w) {
  const float u = as_float((w >> 9) | 0x3F800000u) - 1.0f;
  return u > 0.0f ? u : 0.0f;
}

// Word i of jax.random.bits(key, (total,)): partitionable, pair (0, i)
// gives y0 ^ y1; legacy, counters 0..total-1 (a 0 pads an odd count) in
// halves of h, word i < h is y0 of pair (i, i + h), word i >= h y1 of
// pair (i - h, i)
__device__ __forceinline__ uint32_t bits_word(uint32_t k0, uint32_t k1,
                                              int i, int total, int part) {
  if (part) {
    uint32_t x0 = 0u, x1 = static_cast<uint32_t>(i);
    threefry2x32(k0, k1, x0, x1);
    return x0 ^ x1;
  }
  const int h = (total + 1) / 2;
  const int j = i < h ? i : i - h;
  uint32_t x0 = static_cast<uint32_t>(j);
  uint32_t x1 = static_cast<uint32_t>(j + h < total ? j + h : 0);
  threefry2x32(k0, k1, x0, x1);
  return i < h ? x0 : x1;
}

// Key j of jax.random.split(key, num): partitionable, the hash of (0, j);
// legacy, words 2j and 2j + 1 of the hash of the counters 0..2 num - 1
__device__ __forceinline__ void split_key(uint32_t k0, uint32_t k1, int num,
                                          int j, int part, uint32_t &o0,
                                          uint32_t &o1) {
  if (part) {
    uint32_t x0 = 0u, x1 = static_cast<uint32_t>(j);
    threefry2x32(k0, k1, x0, x1);
    o0 = x0;
    o1 = x1;
    return;
  }
  o0 = bits_word(k0, k1, 2 * j, 2 * num, 0);
  o1 = bits_word(k0, k1, 2 * j + 1, 2 * num, 0);
}

// jax.random.split(key, 2), both keys from two hashes: partitionable, key
// j = hash of (0, j); legacy, the pairs (0, 2), (1, 3), key 0 = their
// y0s, key 1 their y1s
__device__ __forceinline__ void split2(uint32_t k0, uint32_t k1, int part,
                                       uint32_t out[4]) {
  uint32_t a0 = 0u, a1 = part ? 0u : 2u;
  uint32_t b0 = part ? 0u : 1u, b1 = part ? 1u : 3u;
  threefry2x32(k0, k1, a0, a1);
  threefry2x32(k0, k1, b0, b1);
  if (part) {
    out[0] = a0, out[1] = a1, out[2] = b0, out[3] = b1;
  } else {
    out[0] = a0, out[1] = b0, out[2] = a1, out[3] = b1;
  }
}

// Element i of jax.random.randint(key, (size,), minval, maxval) (int32):
// two bit streams from split(key) and the u32 rem reduction, no
// rejection (prng.randint)
__device__ __forceinline__ int32_t randint_elem(uint32_t k0, uint32_t k1,
                                                int i, int size,
                                                int32_t minval,
                                                int32_t maxval, int part) {
  uint32_t ks[4];
  split2(k0, k1, part, ks);
  const uint32_t hi = bits_word(ks[0], ks[1], i, size, part);
  const uint32_t lo = bits_word(ks[2], ks[3], i, size, part);
  uint32_t span = static_cast<uint32_t>(maxval) - static_cast<uint32_t>(minval);
  if (maxval <= minval) span = 1u;
  uint32_t mult = (1u << 16) % span;
  mult = (mult * mult) % span;
  uint32_t off = (hi % span) * mult;
  off = (off + lo % span) % span;
  return static_cast<int32_t>(static_cast<uint32_t>(minval) + off);
}

}  // namespace madraft
