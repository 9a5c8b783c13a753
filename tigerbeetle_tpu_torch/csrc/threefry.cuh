// JAX's threefry-2x32 random numbers as device functions, bit for bit.
//
// The same generator as sim/prng.py (its docstring names the JAX 0.9.0
// source lines): jax_threefry_partitionable = True and jax_enable_x64 = True,
// so a split's key i and element i of a draw hash the counter
// (i >> 32, i & 0xFFFFFFFF); a Bernoulli draw compares a float64 uniform
// made from 64 bits; randint draws int64 from two 64-bit draws.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

struct TfKey {
  uint32_t a, b;
};

static __device__ __forceinline__ uint32_t tf_rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// jax/_src/prng.py _threefry2x32_lowering: 20 rounds, 5 key injections.
static __device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                                    uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = tf_rotl(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// Counter i under key k: (bits1, bits2).
static __device__ __forceinline__ TfKey tf_hash(TfKey k, uint64_t i) {
  uint32_t x0 = (uint32_t)(i >> 32), x1 = (uint32_t)i;
  threefry2x32(k.a, k.b, x0, x1);
  return TfKey{x0, x1};
}

// jax.random.split(k, n)[i] (for any n > i) and jax.random.fold_in(k, d).
static __device__ __forceinline__ TfKey tf_split(TfKey k, uint64_t i) {
  return tf_hash(k, i);
}
static __device__ __forceinline__ TfKey tf_fold_in(TfKey k, uint32_t d) {
  return tf_hash(k, d);
}

// Element i of jax.random.bits(k, shape, uint64).
static __device__ __forceinline__ uint64_t tf_bits64(TfKey k, uint64_t i) {
  const TfKey h = tf_hash(k, i);
  return ((uint64_t)h.a << 32) | h.b;
}

// Element i of jax.random.bernoulli(k, p, shape), p a float64: the uniform
// is the top 52 of 64 bits as a mantissa, exactly m * 2^-52.
static __device__ __forceinline__ bool tf_bernoulli(TfKey k, uint64_t i,
                                                    double p) {
  const uint64_t m = tf_bits64(k, i) >> 12;
  return (double)m * 0x1p-52 < p;
}

// Element i of jax.random.randint(k, shape, lo, hi) as int64, given k's
// split(k)[0] and split(k)[1] (u64 wrapping arithmetic, as
// jax/_src/random.py _randint).
static __device__ __forceinline__ int64_t tf_randint_split(TfKey k0, TfKey k1,
                                                           uint64_t i,
                                                           int64_t lo,
                                                           int64_t hi) {
  const uint64_t high = tf_bits64(k0, i);
  const uint64_t low = tf_bits64(k1, i);
  const uint64_t span = hi <= lo ? 1ull : (uint64_t)(hi - lo);
  uint64_t mult = (1ull << 32) % span;
  mult = (mult * mult) % span;
  const uint64_t off = ((high % span) * mult + low % span) % span;
  return lo + (int64_t)off;
}

static __device__ __forceinline__ int64_t tf_randint(TfKey k, uint64_t i,
                                                     int64_t lo, int64_t hi) {
  return tf_randint_split(tf_split(k, 0), tf_split(k, 1), i, lo, hi);
}
