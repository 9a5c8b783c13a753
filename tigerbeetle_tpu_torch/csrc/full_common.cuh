// Block-wide helpers shared by the general transfer kernels K9-K12
// (full_index.cu, full_legs.cu, full_pass.cu, full_waves.cu), for batches of
// at most 8,192 lanes (16,384 legs).  All four are cooperative launches over
// many blocks: they use these inside each block and cross blocks at grid
// barriers (two-level scans, per-block partials).  The leg sort of K10 (when
// its cache is stale) and of K12 is the chunk sort below: a block sorts a
// chunk of keys in shared memory, and after a grid barrier every key goes to
// its place in the whole order by its rank in the other sorted chunks.
#pragma once

#include "common.cuh"
#include "seq_sync.cuh"

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

static __device__ __forceinline__ uint64_t ldcg_u64(const uint64_t* p, int i) {
  return (uint64_t)__ldcg(reinterpret_cast<const unsigned long long*>(p) + i);
}

// Keys of a sorted chunk (`sh`, `chunk` keys, a power of two) below `key`;
// with `ties`, keys equal to it count as below too.  Branch-free halving:
// after the steps of chunk/2 .. 1 the count is `pos` or, only when every
// key but the last is below, chunk.
static __device__ __forceinline__ bool below(uint64_t v, uint64_t key,
                                             bool ties) {
  return v < key || (ties && v == key);
}
static __device__ __forceinline__ int rank_in(const uint64_t* sh, int chunk,
                                              uint64_t key, bool ties) {
  int pos = 0;
  for (int step = chunk >> 1; step > 0; step >>= 1) {
    if (below(sh[pos + step - 1], key, ties)) pos += step;
  }
  return pos + (below(sh[pos], key, ties) ? 1 : 0);
}

// The chunk sort's first step: the calling block bitonic-sorts chunk c of
// the 2n legs' (slot << 15 | leg) keys (leg j's slot from `slot_of(j)`; a
// dead leg's is the sentinel `cap`; past 2n the pad, all ones) in shared
// `sh` and stores it at chunks[c * chunk].  Every thread of the block calls
// it.
template <class SlotOf>
static __device__ void sort_leg_chunk(uint64_t* sh, int c, int chunk, int n2,
                                      SlotOf slot_of, uint64_t* chunks) {
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) {
    const int j = c * chunk + t;
    sh[t] = j < n2 ? (slot_of(j) << 15) | (uint64_t)j : ~0ull;
  }
  __syncthreads();
  bitonic_sort(sh, chunk);
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) {
    chunks[c * chunk + t] = sh[t];
  }
}

// The merge's staging, after the grid barrier that follows the chunk
// sorts: every sorted chunk (p keys, written by other blocks) into shared
// `sh` (16-byte aligned, as `chunks` is), by 16-byte cp.async copies
// through L2, all of a thread's in flight before it waits: one round trip,
// where a load then a store each would make one a word (128 KB over 128
// threads is 64 round trips a thread).  Every thread of the block calls it.
static __device__ void stage_chunks(uint64_t* sh, const uint64_t* chunks,
                                    int p) {
  for (int k = 2 * threadIdx.x; k < p; k += 2 * blockDim.x) {
    cp_async16(sh + k, chunks + k);
  }
  cp_async_wait_all();
  __syncthreads();
}

// The place in the whole order of the staged key at position j (chunk
// j / chunk of `nch`): its place in its chunk plus the keys of every other
// chunk below it.  The keys are distinct but for the pad, whose ties break
// by chunk, so this is the stable sort by slot.
static __device__ int chunk_rank(const uint64_t* sh, int chunk, int nch,
                                 int j) {
  const int c = j / chunk;
  const uint64_t key = sh[j];
  int rank = j - c * chunk;
  // Four chunks' searches in lockstep: four loads in flight a step.
  for (int o0 = 0; o0 < nch; o0 += 4) {
    int pos[4] = {0, 0, 0, 0};
    for (int step = chunk >> 1; step > 0; step >>= 1) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = o0 + q;
        if (o < nch && below(sh[o * chunk + pos[q] + step - 1], key, o < c))
          pos[q] += step;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = o0 + q;
      if (o < nch && o != c)
        rank += pos[q] + (below(sh[o * chunk + pos[q]], key, o < c) ? 1 : 0);
    }
  }
  return rank;
}

// Opt in to `bytes` of dynamic shared memory for `kernel` (once per kernel).
template <class K>
static int full_smem_opt_in(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}
