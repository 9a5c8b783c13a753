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
// The grid: one cooperative launch of p / 1,024 blocks of 1,024 threads
// (p = the legs rounded up to a power of two: 16 blocks on 16 SMs at 8,190
// lanes), one sorted leg a thread.  The sort is a chunk sort and a merge
// by rank: each block bitonic-sorts its chunk of 1,024 (slot << 15 | leg)
// keys in shared memory and stores it; after a grid barrier each block
// loads every sorted chunk into shared memory (128 KB at 16,384 legs) and
// places each of its own keys at its rank, its place in its chunk plus the
// keys of every other chunk below it (a binary search a chunk; the pad
// keys, all ones, break ties by chunk).  The keys are distinct and the
// leg position breaks equal slots, so this is the stable sort by slot.
// The sort (full_common.cuh's chunk sort, shared with K10) always runs and
// leaves the sorted keys, the slots it sorted and the ok word in the sort
// cache for K10 (INIT marks the cache invalid for every batch).  Run
// ids are a two-level sum scan of the run heads (a block scan, then the
// totals of the blocks before).  Each round is a two-level max scan of the
// packed legs (a block scan; each block's carry-in the max of the blocks
// before it), the scatter max into the lanes, and the depth update with a
// per-block changed flag, with grid barriers between (three a round).
//
// What bounds it on the H100: latency: the 55 compare-exchange steps of a
// chunk's sort, the merge's 15 binary searches of 10 steps a key in
// shared memory, and the grid barriers (4 + 3 a round).  The bytes (about
// 0.2 MB) take well under 1 us.
#include <cooperative_groups.h>

#include "full_common.cuh"

namespace cg = cooperative_groups;

#define WAVE_CHUNK 1024  // keys a block sorts, and threads a block
#define WAVE_MAX_BLOCKS (FULL_MAX_LEGS / WAVE_CHUNK)

struct WaveArgs {
  const uint8_t* hazard;
  const uint8_t* unsched;
  const int64_t* wdr_slot;
  const uint8_t* wdr_live;
  const int64_t* wcr_slot;
  const uint8_t* wcr_live;
  const uint8_t* valid;
  int n, p, chunk;
  uint64_t cap;
  int max_rounds;
  uint64_t* keys;       // [p] the sorted keys (the cache's, or scratch)
  uint64_t* slot_out;   // [2n] each leg's slot (the cache's check, or scratch)
  int* ok;              // the cache's ok word, or scratch
  uint64_t* chunks;     // [p] scratch: the sorted chunks
  int* prior;           // [n] scratch
  int* part;            // [5 * WAVE_MAX_BLOCKS] scratch: per-block partials
  int* depth;
  uint8_t* proved;
  int* needed;
  int* hist;
};

// Leg j's slot: its lane's debit (j even) or credit slot, `cap` if dead.
static __device__ __forceinline__ uint64_t leg_slot(const WaveArgs& a, int j) {
  const int i = j >> 1;
  const bool dr = (j & 1) == 0;
  const bool live = dr ? a.wdr_live[i] != 0 : a.wcr_live[i] != 0;
  return live ? (uint64_t)(dr ? a.wdr_slot[i] : a.wcr_slot[i]) : a.cap;
}

__global__ void __launch_bounds__(WAVE_CHUNK, 1) full_waves_kernel(WaveArgs a) {
  extern __shared__ __align__(16) uint64_t sh[];
  __shared__ uint64_t wsh[32];
  __shared__ int ish[32];
  __shared__ int hist_sh[9];
  __shared__ int flag_sh;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, b = blockIdx.x, B = gridDim.x;
  const int n = a.n, n2 = 2 * n, p = a.p, chunk = a.chunk;
  const int j = b * chunk + tid;  // this thread's chunk key, then sorted leg
  int* part_run = a.part;                        // heads a block
  int* part_max = a.part + WAVE_MAX_BLOCKS;      // (hi, lo) of a block's max
  int* part_flag = a.part + 3 * WAVE_MAX_BLOCKS; // a round's changed flag
  int* part_deep = a.part + 4 * WAVE_MAX_BLOCKS; // the deepest valid lane

  // 1. Each block sorts its chunk of keys in shared memory.
  sort_leg_chunk(sh, b, chunk, n2, [&](int k) { return leg_slot(a, k); },
                 a.chunks);
  for (int i = b * blockDim.x + tid; i < n; i += B * blockDim.x) {
    a.depth[i] = a.hazard[i] ? 1 : 0;
    a.prior[i] = 0;
  }
  if (b == 0 && tid < 9) a.hist[tid] = 0;
  grid.sync();

  // 2. Merge by rank: every sorted chunk in shared memory; each key of this
  //    block's chunk goes to its place in the whole order.
  stage_chunks(sh, a.chunks, p);
  if (tid < chunk) {
    a.keys[chunk_rank(sh, chunk, B, j)] = sh[j];
  }
  for (int i = b * blockDim.x + tid; i < n2; i += B * blockDim.x) {
    a.slot_out[i] = leg_slot(a, i);
  }
  grid.sync();

  // 3. This thread's sorted leg, its run head, and its run id (a two-level
  //    sum scan of the heads).
  uint64_t key = 0, slot = 0;
  bool head = false;
  if (j < n2) {
    key = ldcg_u64(a.keys, j);
    slot = key >> 15;
    head = j == 0 || (ldcg_u64(a.keys, j - 1) >> 15) != slot;
  }
  const bool live = j < n2 && slot < a.cap;
  const int lane = (int)((key & 0x7FFF) >> 1);
  int heads = 0;
  int before = block_scan_excl(head ? 1 : 0, 0, OpSum(), ish, &heads);
  if (tid == 0) part_run[b] = heads;
  grid.sync();
  for (int c = 0; c < b; ++c) before += __ldcg(part_run + c);
  const uint64_t run = (uint64_t)(before + (head ? 1 : 0) - 1);

  // 4. Relaxation rounds.
  int rounds = 0;
  bool any_change = true;
  while (any_change && rounds < a.max_rounds) {
    // a. The packed legs' running max: the block's, then the blocks'.
    const uint64_t d =
        live ? (uint64_t)(uint32_t)__ldcg(a.depth + lane) : 0;
    const uint64_t packed = j < n2 ? (run << 32) | d : 0;
    uint64_t top = 0;
    uint64_t excl = block_scan_excl(packed, (uint64_t)0, OpMax(), wsh, &top);
    if (tid == 0) {
      part_max[2 * b] = (int)(top >> 32);
      part_max[2 * b + 1] = (int)(uint32_t)top;
    }
    grid.sync();
    // b. The carry from the blocks before; each live leg's exclusive max,
    //    where it lies in its own run, into its lane's prior.
    for (int c = 0; c < b; ++c) {
      const uint64_t t = ((uint64_t)(uint32_t)__ldcg(part_max + 2 * c) << 32) |
                         (uint32_t)__ldcg(part_max + 2 * c + 1);
      if (t > excl) excl = t;
    }
    if (live && (excl >> 32) == run) {
      atomicMax(a.prior + lane, (int)(excl & 0xFFFFFFFFu));
    }
    grid.sync();
    // c. The depths; the prior reset for the next round.
    if (tid == 0) flag_sh = 0;
    __syncthreads();
    for (int i = b * blockDim.x + tid; i < n; i += B * blockDim.x) {
      const int dd = a.depth[i];
      const int pr = __ldcg(a.prior + i);
      const int nd = a.hazard[i] ? (dd > 1 + pr ? dd : 1 + pr) : 0;
      if (nd != dd) flag_sh = 1;
      a.depth[i] = nd;
      a.prior[i] = 0;
    }
    __syncthreads();
    if (tid == 0) part_flag[b] = flag_sh;
    grid.sync();
    any_change = false;
    for (int c = 0; c < B; ++c) any_change |= __ldcg(part_flag + c) != 0;
    ++rounds;
  }

  // 5. The histogram and the deepest valid lane.
  if (tid < 9) hist_sh[tid] = 0;
  __syncthreads();
  int deepest = 0;
  for (int i = b * blockDim.x + tid; i < n; i += B * blockDim.x) {
    if (!a.valid[i]) continue;
    const int dd = __ldcg(a.depth + i);
    if (dd > deepest) deepest = dd;
    atomicAdd(hist_sh + (dd < 8 ? dd : 8), 1);
  }
  int top = 0;
  block_scan_excl(deepest, 0, OpMax(), ish, &top);
  if (tid < 9 && hist_sh[tid]) atomicAdd(a.hist + tid, hist_sh[tid]);
  if (tid == 0) part_deep[b] = top;
  grid.sync();
  if (b == 0 && tid == 0) {
    int deep = 0;
    for (int c = 0; c < B; ++c) {
      const int t = __ldcg(part_deep + c);
      if (t > deep) deep = t;
    }
    *a.proved = (!a.unsched[0] && !any_change) ? 1 : 0;
    *a.needed = deep + 1;
    *a.ok = 1;
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
  WaveArgs a;
  a.hazard = (const uint8_t*)hazard;
  a.unsched = (const uint8_t*)unsched;
  a.wdr_slot = (const int64_t*)wdr_slot;
  a.wdr_live = (const uint8_t*)wdr_live;
  a.wcr_slot = (const int64_t*)wcr_slot;
  a.wcr_live = (const uint8_t*)wcr_live;
  a.valid = (const uint8_t*)valid;
  a.n = (int)n;
  a.p = p;
  a.chunk = p < WAVE_CHUNK ? p : WAVE_CHUNK;
  a.cap = cap;
  a.max_rounds = max_rounds;
  // scratch: chunks [p] u64, then (no cache) keys [p] and slots [2n] u64,
  // then prior [n] and the partials, int32.
  uint64_t* s64 = (uint64_t*)scratch;
  a.chunks = s64;
  s64 += p;
  if (cache_keys == nullptr) {
    a.keys = s64;
    a.slot_out = s64 + p;
    s64 += p + 2 * n;
  } else {
    a.keys = (uint64_t*)cache_keys;
    a.slot_out = (uint64_t*)cache_slot;
  }
  int* s32 = (int*)s64;
  a.prior = s32;
  a.part = s32 + n;
  a.ok = cache_ok != nullptr ? (int*)cache_ok : a.part + 5 * WAVE_MAX_BLOCKS;
  a.depth = (int*)depth;
  a.proved = (uint8_t*)proved;
  a.needed = (int*)needed;
  a.hist = (int*)hist;
  void* args[] = {&a};
  const int blocks = p / a.chunk;
  return (int)cudaLaunchCooperativeKernel(
      (const void*)full_waves_kernel, dim3((unsigned)blocks), dim3(WAVE_CHUNK),
      args, (size_t)8 * p, (cudaStream_t)stream);
}
