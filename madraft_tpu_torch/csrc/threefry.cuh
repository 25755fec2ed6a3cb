// threefry2x32 (20 rounds) as device functions, shared by the kernels that
// draw the simulator's random words (threefry.cu, and K6's tick in
// tick.cuh, which the host tests also build with g++: the two intrinsics
// have host twins).
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

}  // namespace madraft
