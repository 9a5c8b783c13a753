// JAX's threefry-2x32 random numbers as device functions, bit for bit.
//
// The same generator as sim/prng.py (its docstring names the JAX 0.9.0
// source lines): jax_threefry_partitionable = True and jax_enable_x64 = True,
// so a split's key i and element i of a draw hash the counter
// (i >> 32, i & 0xFFFFFFFF); a Bernoulli draw compares a float64 uniform
// made from 64 bits; randint draws int64 from two 64-bit draws.
//
// The draws use no floating point and no 64-bit division: a Bernoulli
// gate compares the draw's top 52 bits with an integer threshold, and a
// randint reduces by its span with a multiplier (TfSpan); the host makes
// both once a launch (sim/prng.py bernoulli_threshold and span_consts).
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
// is the top 52 of 64 bits m as a mantissa, exactly m * 2^-52, and the draw
// is (double)m * 0x1p-52 < p.  Here that compare is m < thresh, with
// thresh = ceil(p * 2^52) clamped to [0, 2^52] (sim/prng.py
// bernoulli_threshold; tests/test_torch_vopr_draw_ahead.py holds the two
// forms equal).
static const uint64_t TF_HALF = 1ull << 51;  // the threshold of p = 0.5

static __device__ __forceinline__ bool tf_bernoulli(TfKey k, uint64_t i,
                                                    uint64_t thresh) {
  return (tf_bits64(k, i) >> 12) < thresh;
}

// A randint span d (1 <= d < 2^16) and its launch constants (sim/prng.py
// span_consts): r32 = 2^32 mod d, mult = r32^2 mod d (= 2^64 mod d), and
// magic = ceil(2^64 / d) mod 2^64 (0 for d = 1) for the remainder below.
struct TfSpan {
  uint64_t magic;
  uint32_t d, r32, mult;
};

// x mod d for a u32 x, by one multiply and one high product (Lemire, Kaser
// and Kurz, "Faster remainder by direct computation", 2019): exact for
// every 32-bit x and d.
static __device__ __forceinline__ uint32_t tf_mod32(uint32_t x,
                                                    const TfSpan& s) {
  return (uint32_t)__umul64hi(s.magic * x, (uint64_t)s.d);
}

// (hi * 2^32 + lo) mod d from the 32-bit halves.
static __device__ __forceinline__ uint32_t tf_mod64(uint32_t hi, uint32_t lo,
                                                    const TfSpan& s) {
  return tf_mod32(tf_mod32(hi, s) * s.r32 + tf_mod32(lo, s), s);
}

// Element i of jax.random.randint(k, shape, 0, d) as int64, given k's
// split(k)[0] and split(k)[1]: jax/_src/random.py _randint's
// (high % d * (2^64 % d) + low % d) % d, each term below d^2 < 2^32.
static __device__ __forceinline__ int tf_randint_split(TfKey k0, TfKey k1,
                                                       uint64_t i,
                                                       const TfSpan& s) {
  const TfKey high = tf_hash(k0, i), low = tf_hash(k1, i);
  return (int)tf_mod32(tf_mod64(high.a, high.b, s) * s.mult +
                           tf_mod64(low.a, low.b, s),
                       s);
}

static __device__ __forceinline__ int tf_randint(TfKey k, uint64_t i,
                                                 const TfSpan& s) {
  return tf_randint_split(tf_split(k, 0), tf_split(k, 1), i, s);
}
