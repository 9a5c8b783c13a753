// K12 full_waves: the conflict-index wave schedule of the general transfer
// kernel.
//
// Replaces tigerbeetle_tpu/ops/transfer_full.py:422 `_wave_schedule`.
//
// Every lane gets a wave depth: 0 for a lane whose outcome cannot change
// across Jacobi iterates, and for a hazard lane 1 + the deepest earlier
// hazard lane that shares one of its accounts.  Depth is the longest path
// of a DAG, found by at most `max_rounds` relaxation rounds over ONE sort
// of the 2n legs by (slot, leg position): each round is a segmented
// exclusive running max of the legs' depths within slot runs, taken as a
// plain running max of (run_id << 32 | depth), which never leaks across
// runs because run ids grow down the sorted array; each lane then takes
// 1 + the larger of its two legs' maxima (atomicMax into the lane).  The
// schedule is `proved` when no round changed any depth (and nothing made
// the batch unschedulable); `passes_needed` is the deepest valid lane + 1;
// the histogram counts valid lanes by depth (8 = deeper).
//
// One block of 1,024 threads; the keys are sorted in shared memory (the
// same sort as K10, whose first pass sorts the same slots: the sort is left
// in the sort cache for it); each round's running max runs in warp tiles,
// as K10's sums do.  What bounds it on the H100: latency of the sort and of
// up to `max_rounds` rounds on one SM; the bytes (about 0.2 MB) take well
// under 1 us.
#include "full_common.cuh"

__global__ void __launch_bounds__(FULL_THREADS, 1)
    full_waves_kernel(const uint8_t* __restrict__ hazard,
                      const uint8_t* __restrict__ unsched,
                      const int64_t* __restrict__ wdr_slot,
                      const uint8_t* __restrict__ wdr_live,
                      const int64_t* __restrict__ wcr_slot,
                      const uint8_t* __restrict__ wcr_live,
                      const uint8_t* __restrict__ valid, int n, uint64_t cap,
                      int max_rounds, uint64_t* cache_keys,
                      uint64_t* cache_slot, int* cache_ok,
                      uint64_t* __restrict__ run_of,
                      int* __restrict__ prior, int* __restrict__ depth,
                      uint8_t* __restrict__ proved, int* __restrict__ needed,
                      int* __restrict__ hist) {
  extern __shared__ uint64_t keys[];
  __shared__ uint64_t wmax[32];
  __shared__ int shint[32];
  __shared__ int changed, hist_sh[9];
  const int n2 = 2 * n, T = blockDim.x, tid = threadIdx.x;
  sort_legs_cached(keys, n, wdr_slot, wdr_live, wcr_slot, wcr_live, cap,
                   cache_keys, cache_slot, cache_ok);

  // Run ids: the number of run heads up to each sorted position, less 1.
  int lo, hi;
  thread_chunk(n2, &lo, &hi);
  int heads = 0;
  for (int j = lo; j < hi; ++j)
    heads += (j == 0 || (keys[j] >> 15) != (keys[j - 1] >> 15)) ? 1 : 0;
  int before = block_scan_excl(heads, 0, OpSum(), shint);
  for (int j = lo; j < hi; ++j) {
    before += (j == 0 || (keys[j] >> 15) != (keys[j - 1] >> 15)) ? 1 : 0;
    run_of[j] = (uint64_t)(before - 1);
  }
  for (int i = tid; i < n; i += T) depth[i] = hazard[i] ? 1 : 0;
  if (tid < 9) hist_sh[tid] = 0;
  __syncthreads();

  // Relaxation rounds.  Each warp walks its own range of legs 32 at a
  // time (coalesced): pass A takes the warp's running max; pass B the
  // exclusive running max at every leg, carried in from the warps before.
  const int lane = tid & 31, warp = tid >> 5, W = T >> 5;
  const int per = (((n2 + W - 1) / W) + 31) & ~31;
  const int base = warp * per;
  const int end = base + per < n2 ? base + per : n2;
  auto packed_at = [&](int j) -> uint64_t {
    const uint64_t key = keys[j];
    const uint64_t d = (key >> 15) < cap ? (uint64_t)depth[(key & 0x7FFF) >> 1] : 0;
    return (run_of[j] << 32) | d;
  };
  auto warp_max = [&](uint64_t x) {
    for (int off = 1; off < 32; off <<= 1) {
      const uint64_t t = shfl_up64(x, off);
      if (lane >= off && t > x) x = t;
    }
    return x;
  };
  int rounds = 0;
  bool any_change = true;
  while (any_change && rounds < max_rounds) {
    for (int i = tid; i < n; i += T) prior[i] = 0;
    uint64_t carry = 0;
    for (int b = base; b < end; b += 32) {
      const int j = b + lane;
      const uint64_t x = warp_max(j < end ? packed_at(j) : 0);
      const uint64_t top = __shfl_sync(0xffffffffu, (unsigned long long)x, 31);
      if (top > carry) carry = top;
    }
    if (lane == 0) wmax[warp] = carry;
    __syncthreads();
    carry = 0;
    for (int w = 0; w < warp; ++w) carry = wmax[w] > carry ? wmax[w] : carry;
    for (int b = base; b < end; b += 32) {
      const int j = b + lane;
      const uint64_t v = j < end ? packed_at(j) : 0;
      const uint64_t incl = warp_max(v);
      uint64_t excl = shfl_up64(incl, 1);
      if (lane == 0) excl = 0;
      if (carry > excl) excl = carry;  // exclusive max before leg j
      if (j < end && (keys[j] >> 15) < cap && (excl >> 32) == run_of[j]) {
        atomicMax(prior + (int)((keys[j] & 0x7FFF) >> 1),
                  (int)(excl & 0xFFFFFFFFu));
      }
      const uint64_t top = __shfl_sync(0xffffffffu, (unsigned long long)incl, 31);
      if (top > carry) carry = top;
    }
    if (tid == 0) changed = 0;
    __syncthreads();
    int new_depth[8];
    int k = 0;
    for (int i = tid; i < n; i += T, ++k) {
      const int d = depth[i];
      const int nd = hazard[i] ? (d > 1 + prior[i] ? d : 1 + prior[i]) : 0;
      if (nd != d) changed = 1;
      if (k < 8) new_depth[k] = nd;
    }
    __syncthreads();
    k = 0;
    for (int i = tid; i < n; i += T, ++k) depth[i] = new_depth[k];
    any_change = changed != 0;
    ++rounds;
    __syncthreads();
  }

  int deepest = 0;
  for (int i = tid; i < n; i += T) {
    if (!valid[i]) continue;
    const int d = depth[i];
    if (d > deepest) deepest = d;
    atomicAdd(hist_sh + (d < 8 ? d : 8), 1);
  }
  int top = 0;
  block_scan_excl(deepest, 0, OpMax(), shint, &top);
  if (tid < 9) hist[tid] = hist_sh[tid];
  if (tid == 0) {
    *proved = (!unsched[0] && !any_change) ? 1 : 0;
    *needed = top + 1;
  }
}

extern "C" int tb_full_waves(const void* hazard, const void* unsched,
                             const void* wdr_slot, const void* wdr_live,
                             const void* wcr_slot, const void* wcr_live,
                             const void* valid, int64_t n, uint64_t cap,
                             int max_rounds, void* cache_keys,
                             void* cache_slot, void* cache_ok, void* scratch,
                             void* depth,
                             void* proved, void* needed, void* hist,
                             void* stream) {
  if (n <= 0 || n > 8 * FULL_THREADS || 2 * n > FULL_MAX_LEGS)
    return (int)cudaErrorInvalidValue;
  int p = 2;
  while (p < 2 * n) p <<= 1;
  static bool opted = false;
  if (!opted) {
    int err = full_smem_opt_in(full_waves_kernel, 8 * FULL_MAX_LEGS);
    if (err) return err;
    opted = true;
  }
  uint64_t* run_of = (uint64_t*)scratch;    // [2n]
  int* prior = (int*)(run_of + 2 * n);      // [n]
  full_waves_kernel<<<1, FULL_THREADS, 8 * p, (cudaStream_t)stream>>>(
      (const uint8_t*)hazard, (const uint8_t*)unsched,
      (const int64_t*)wdr_slot, (const uint8_t*)wdr_live,
      (const int64_t*)wcr_slot, (const uint8_t*)wcr_live,
      (const uint8_t*)valid, (int)n, cap, max_rounds, (uint64_t*)cache_keys,
      (uint64_t*)cache_slot, (int*)cache_ok, run_of, prior,
      (int*)depth, (uint8_t*)proved, (int*)needed, (int*)hist);
  return (int)cudaGetLastError();
}
