// Block-wide helpers shared by the general transfer kernels K9-K12
// (full_index.cu, full_legs.cu, full_pass.cu, full_waves.cu), for batches of
// at most 8,192 lanes (16,384 legs).  In K9 and K10 one block of up to
// 1,024 threads runs a whole batch, so a sort or a scan is a loop inside the
// block with __syncthreads between its steps.  K11 and K12 are cooperative
// launches over many blocks: they use these inside each block and cross
// blocks at grid barriers (two-level scans, per-block partials).
#pragma once

#include "common.cuh"

typedef unsigned __int128 u128;

#define FULL_THREADS 1024
#define FULL_MAX_LEGS 16384  // 2 x 8,192 lanes: the leg key packs legpos < 2^15

// Loop control of the Jacobi passes, in device memory (int32 words), so no
// pass needs a host read: the passes run, whether a stable pass was seen,
// and the pass budget.
enum FullCtrl { C_K = 0, C_EVER_STABLE = 1, C_MAX_PASSES = 2 };

// The JAX while-loop condition: run another pass unless a stable pass was
// seen, the budget is spent, or the wave scheduler proved the pass count.
static __device__ __forceinline__ bool full_should_run(const int* ctrl,
                                                       const uint8_t* proved,
                                                       const int* needed) {
  const int k = ctrl[C_K];
  return !ctrl[C_EVER_STABLE] && k < ctrl[C_MAX_PASSES] &&
         !(proved[0] && k >= needed[0]);
}

static __device__ __forceinline__ int ceil_pow2(int n) {
  int p = 2;
  while (p < n) p <<= 1;
  return p;
}

static __device__ __forceinline__ uint64_t shfl_up64(uint64_t v, int off) {
  return __shfl_up_sync(0xffffffffu, (unsigned long long)v, off);
}
static __device__ __forceinline__ int shfl_up_any(int v, int off) {
  return __shfl_up_sync(0xffffffffu, v, off);
}
static __device__ __forceinline__ uint64_t shfl_up_any(uint64_t v, int off) {
  return shfl_up64(v, off);
}
static __device__ __forceinline__ u128 shfl_up_any(u128 v, int off) {
  const uint64_t lo = shfl_up64((uint64_t)v, off);
  const uint64_t hi = shfl_up64((uint64_t)(v >> 64), off);
  return ((u128)hi << 64) | lo;
}

struct OpSum {
  template <class T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct OpMax {
  template <class T>
  __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};

// Exclusive scan of one value per thread, in thread order, over the block
// (blockDim.x a multiple of 32).  `sh` holds 32 values.  Every thread of
// the block must call it.  `total`, if not null, receives the block's
// reduction (in every thread).
template <class T, class Op>
static __device__ T block_scan_excl(T v, T ident, Op op, T* sh,
                                    T* total = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  T incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const T t = shfl_up_any(incl, off);
    if (lane >= off) incl = op(t, incl);
  }
  T excl = shfl_up_any(incl, 1);
  if (lane == 0) excl = ident;
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nw ? sh[lane] : ident;
    for (int off = 1; off < 32; off <<= 1) {
      const T t = shfl_up_any(w, off);
      if (lane >= off) w = op(t, w);
    }
    if (lane < nw) sh[lane] = w;
  }
  __syncthreads();
  const T pre = warp > 0 ? sh[warp - 1] : ident;
  if (total) *total = sh[nw - 1];
  __syncthreads();  // sh may be reused by the next call
  return op(pre, excl);
}

// Ascending bitonic sort of p (a power of two) u64 keys in shared memory.
static __device__ void bitonic_sort(uint64_t* keys, int p) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t a = keys[i], b = keys[ixj];
          const bool up = (i & k) == 0;
          if ((a > b) == up) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// The sorted (slot << 15 | leg) keys of 2n legs, leg 2i the debit side and
// 2i+1 the credit side of lane i; a dead leg sorts under slot `cap` (the
// sentinel).  Leaves the p = ceil_pow2(2n) keys sorted in `keys` (the pad
// is all ones).
static __device__ void sort_legs(uint64_t* keys, int n, const int64_t* dr_slot,
                                 const uint8_t* dr_live, const int64_t* cr_slot,
                                 const uint8_t* cr_live, uint64_t cap) {
  const int n2 = 2 * n, p = ceil_pow2(n2);
  for (int j = threadIdx.x; j < p; j += blockDim.x) {
    uint64_t key = ~0ull;
    if (j < n2) {
      const int i = j >> 1;
      const bool dr = (j & 1) == 0;
      const bool live = dr ? dr_live[i] != 0 : cr_live[i] != 0;
      const uint64_t slot =
          live ? (uint64_t)(dr ? dr_slot[i] : cr_slot[i]) : cap;
      key = (slot << 15) | (uint64_t)j;
    }
    keys[j] = key;
  }
  __syncthreads();
  bitonic_sort(keys, p);
}

// sort_legs, unless the cache (cache_keys[p], cache_slot[2n], *cache_ok;
// all null for no cache) holds the sort of these same leg slots: then the
// cached keys are copied in.  A sort refreshes the cache.  K10 sorts this
// way; K12 (its own multi-block sort) leaves the cache in this format.
static __device__ void sort_legs_cached(uint64_t* keys, int n,
                                        const int64_t* dr_slot,
                                        const uint8_t* dr_live,
                                        const int64_t* cr_slot,
                                        const uint8_t* cr_live, uint64_t cap,
                                        uint64_t* cache_keys,
                                        uint64_t* cache_slot, int* cache_ok) {
  __shared__ int changed;
  const int n2 = 2 * n, p = ceil_pow2(n2);
  if (cache_keys == nullptr) {
    sort_legs(keys, n, dr_slot, dr_live, cr_slot, cr_live, cap);
    return;
  }
  auto slot_of = [&](int j) -> uint64_t {
    const int i = j >> 1;
    const bool dr = (j & 1) == 0;
    const bool live = dr ? dr_live[i] != 0 : cr_live[i] != 0;
    return live ? (uint64_t)(dr ? dr_slot[i] : cr_slot[i]) : cap;
  };
  if (threadIdx.x == 0) changed = *cache_ok == 0;
  __syncthreads();
  bool differs = false;
  for (int j = threadIdx.x; j < n2; j += blockDim.x) {
    if (cache_slot[j] != slot_of(j)) differs = true;
  }
  if (differs) changed = 1;
  __syncthreads();
  if (changed) {
    sort_legs(keys, n, dr_slot, dr_live, cr_slot, cr_live, cap);
    for (int j = threadIdx.x; j < p; j += blockDim.x) cache_keys[j] = keys[j];
    for (int j = threadIdx.x; j < n2; j += blockDim.x) cache_slot[j] = slot_of(j);
    if (threadIdx.x == 0) *cache_ok = 1;
  } else {
    for (int j = threadIdx.x; j < p; j += blockDim.x) keys[j] = cache_keys[j];
  }
  __syncthreads();
}

// Opt in to `bytes` of dynamic shared memory for `kernel` (once per kernel).
template <class K>
static int full_smem_opt_in(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}
