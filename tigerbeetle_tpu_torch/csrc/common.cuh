// Shared device helpers for the ledger kernels (sm_90a).
//
// Every u64 of the port rides in an int64 tensor holding the same bits and
// every u32 in an int32 tensor; the kernels read them as uint64_t/uint32_t.
// Bool tensors are one byte per element.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long ull;

// splitmix64 finalizer over a xor-fold of a u128's lanes: bit for bit
// tigerbeetle_tpu/u128.py:118 mix64 (the JAX function it replaces).
static __device__ __forceinline__ uint64_t mix64(uint64_t lo, uint64_t hi) {
  uint64_t x = lo ^ (hi * 0x9E3779B97F4A7C15ull);
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// A list of columns to copy element by element (gather or scatter).
#define TB_MAX_COLS 24
struct ColList {
  int n;
  const void* src[TB_MAX_COLS];
  void* dst[TB_MAX_COLS];
  int width[TB_MAX_COLS];  // bytes per element: 1, 4 or 8
};

static inline int pack_cols(ColList* c, int n, const void* const* src,
                            void* const* dst, const int* width) {
  if (n < 0 || n > TB_MAX_COLS) return (int)cudaErrorInvalidValue;
  c->n = n;
  for (int k = 0; k < n; ++k) {
    if (width[k] != 1 && width[k] != 4 && width[k] != 8)
      return (int)cudaErrorInvalidValue;
    c->src[k] = src[k];
    c->dst[k] = dst[k];
    c->width[k] = width[k];
  }
  return 0;
}

static __device__ __forceinline__ void copy_elem(void* dst, int64_t di,
                                                 const void* src, int64_t si,
                                                 int width) {
  if (width == 8) {
    static_cast<uint64_t*>(dst)[di] = static_cast<const uint64_t*>(src)[si];
  } else if (width == 4) {
    static_cast<uint32_t*>(dst)[di] = static_cast<const uint32_t*>(src)[si];
  } else {
    static_cast<uint8_t*>(dst)[di] = static_cast<const uint8_t*>(src)[si];
  }
}

static __device__ __forceinline__ void zero_elem(void* dst, int64_t di,
                                                 int width) {
  if (width == 8) {
    static_cast<uint64_t*>(dst)[di] = 0;
  } else if (width == 4) {
    static_cast<uint32_t*>(dst)[di] = 0;
  } else {
    static_cast<uint8_t*>(dst)[di] = 0;
  }
}

// Sum over the block (any blockDim that is a multiple of 32, at most 1024);
// the result is valid in thread 0.  Every thread of the block must call it.
template <typename T>
static __device__ __forceinline__ T block_sum(T v, T* shared32) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) shared32[warp] = v;
  __syncthreads();
  T total = 0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += shared32[w];
  }
  __syncthreads();  // shared32 may be reused by the next call
  return total;
}

// A generic list of column pointers, passed to a kernel by value.
#define TB_MAX_PTRS 48
struct Ptrs {
  const void* p[TB_MAX_PTRS];
};

static inline int pack_ptrs(Ptrs* out, int n, const void* const* ptrs) {
  if (n < 0 || n > TB_MAX_PTRS) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < n; ++k) out->p[k] = ptrs[k];
  return 0;
}
