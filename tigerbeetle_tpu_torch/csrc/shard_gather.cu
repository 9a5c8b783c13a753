// K30 shard_gather: the owner-masked local probe and column gather of every
// shard a device holds, in one launch, into ONE answer row for the device.
//
// Replaces tigerbeetle_tpu/parallel/sharded.py:142-164 `_ShardGather`:
// `ht.lookup(table, lo, hi, MAX_PROBE, hash_shift=shift)` on each shard's
// local table, masked to the keys the shard owns (owner = mix64(key) &
// (n_shards - 1)), the global slot shard * (C/n) + slot, `gather_cols` at
// the found slots, the local probes' overflow flag, and the psum over the
// shards: the terms are owner-masked, so at most one shard's is nonzero for
// a lane and the psum is that shard's answer, which this writes directly.
// Across cards each device's row holds zeros for the lanes whose owner it
// does not hold, and an NCCL all-reduce sums the rows (parallel/mesh.py).
//
// Semantics (bit for bit the JAX function, and K1's for one table): grid.y
// is the local shard j, one thread a lane i.  The thread hashes the key
// once; when shard j owns it, it probes j's local table from
// home = (mix64 >> shift) & (C/n - 1), linearly, at most max_probe steps,
// stopping on the key (found) or on an empty slot with no tombstone; a zero
// key is done at once.  That thread writes the lane's answer in the row:
//   found[i]  = 1 if found, i < valid_count and lane_mask[i] (when given),
//   gslot[i]  = shard * (C/n) + slot where found, else 0,
//   col_c[i]  = the slot's column value, u32 zero-extended, where found,
// and zeros where it does not find the key.  A lane whose owner is not on
// this device is written as zeros by the thread of the device's first
// local shard.  The JAX function's overflow flag covers every lane of
// every shard's local probe, owned or not: when `want_overflow` is set the
// thread probes a key it does not own too, for that flag alone (no answer
// written), and stores 1 in the row's overflow word (zero on entry) if the
// probe did not end within max_probe steps.
//
// What bounds it on the H100: bytes at random addresses, as K1: the keys,
// one probe window of 17 B a step (key pair and tombstone) per probed lane,
// and the gathered columns, then the answer written once, coalesced.  In
// time, the slowest lane's round trips: its key, its probe steps, every
// column's load together, then the stores (tools/phase_clock.py's lane
// clock of K30 reads them).  A thread a lane with its
// shard's table looked up in the launch's arrays was slower: parameters
// indexed by a lane's own shard load one address at a time across a warp,
// and staging them in shared memory cost each block more than the
// launch's other threads cost in all.
#include "common.cuh"
#include "phase_clock.cuh"

#ifdef TB_PHASE_CLOCK
// tools/phase_clock.py's lane clock: each answering thread's %globaltimer
// when its key is hashed, its probe done and its stores issued (after the
// columns arrived), for the first K30_CLOCK_LANES lanes.
#define K30_CLOCK_LANES 8192
static __device__ unsigned long long k30_lane_clock[K30_CLOCK_LANES][4];
#define LANE_MARK(k)                                                   \
  do {                                                                 \
    if (i < K30_CLOCK_LANES) {                                         \
      unsigned long long t_;                                           \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)::"memory"); \
      k30_lane_clock[i][k] = t_;                                       \
    }                                                                  \
  } while (0)
PHASE_CLOCK_ARRAY_ENTRIES(tb_shard_gather_lanes, k30_lane_clock)
#else
#define LANE_MARK(k) \
  do {               \
  } while (0)
#endif

#define TB_SHARD_CHUNK 8   // local shards per launch (grid.y)
#define TB_SHARD_COLS 20   // gathered columns per launch
#define TB_SHARD_MAX 256   // shards of a mesh (the local-shard bitmask)

struct ShardTables {
  const uint64_t* key_lo[TB_SHARD_CHUNK];
  const uint64_t* key_hi[TB_SHARD_CHUNK];
  const uint8_t* tomb[TB_SHARD_CHUNK];
  const void* col[TB_SHARD_CHUNK][TB_SHARD_COLS];
  uint64_t shard[TB_SHARD_CHUNK];  // the local shard's index in the mesh
  int width[TB_SHARD_COLS];        // bytes per element: 4 or 8
  int ncols;
  int first;                       // this launch holds the first local shard
  uint64_t local[TB_SHARD_MAX / 64];  // bit s: mesh shard s is on the device
};

// Shard j's linear probe for (lo, hi) from `home`, at most max_probe slots
// in order: whether it ended (found, or an empty slot with no tombstone).
// A slot a step: reading the aligned group of four a round (K1's way) was
// slower here, four times the bytes a round for few rounds saved at a
// table's load of 0.3.
static __device__ __forceinline__ bool shard_probe(
    const ShardTables& tabs, int j, uint64_t lo, uint64_t hi, uint64_t home,
    uint64_t local_mask, int64_t max_probe, bool* found, uint64_t* slot) {
  bool done = lo == 0 && hi == 0;
  *found = false;
  *slot = 0;
  const uint64_t* tlo = tabs.key_lo[j];
  const uint64_t* thi = tabs.key_hi[j];
  const uint8_t* tomb = tabs.tomb[j];
  for (int64_t t = 0; t < max_probe && !done; ++t) {
    const uint64_t cur = (home + (uint64_t)t) & local_mask;
    const bool tb = tomb[cur] != 0;
    const uint64_t a = tlo[cur], b = thi[cur];
    if (!tb && a == lo && b == hi) {
      *found = true;
      *slot = cur;
      done = true;
    } else if (!tb && a == 0 && b == 0) {
      done = true;
    }
  }
  return done;
}

__global__ void shard_gather_kernel(ShardTables tabs, uint64_t owner_mask,
                                    int shift, uint64_t local_mask,
                                    int64_t max_probe,
                                    const uint64_t* __restrict__ key_lo,
                                    const uint64_t* __restrict__ key_hi,
                                    int64_t n, int64_t valid_count,
                                    const uint8_t* __restrict__ lane_mask,
                                    uint64_t* __restrict__ row,
                                    uint64_t* __restrict__ ovf,
                                    int want_overflow) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  if (i >= n) return;
  const uint64_t lo = key_lo[i], hi = key_hi[i];
  const uint64_t h = mix64(lo, hi);
  const uint64_t owner = h & owner_mask;
  const uint64_t shard = tabs.shard[j];
  const bool mine = owner == shard;
  if (!mine) {
    // The lane's answer is another shard's: zeros when no shard of this
    // device owns it (written once, by the first local shard's thread).
    if (tabs.first && j == 0 &&
        !((tabs.local[owner >> 6] >> (owner & 63)) & 1)) {
      for (int c = 0; c < 2 + tabs.ncols; ++c) row[(int64_t)c * n + i] = 0;
    }
    if (!want_overflow) return;
  }
  bool found;
  uint64_t slot;
  const uint64_t home = (h >> shift) & local_mask;
  if (mine) LANE_MARK(0);
  const bool done = shard_probe(tabs, j, lo, hi, home, local_mask, max_probe,
                                &found, &slot);
  if (!done && want_overflow) *ovf = 1;  // all store 1
  if (!mine) return;
  LANE_MARK(1);
  const bool f = found && i < valid_count && (!lane_mask || lane_mask[i]);
  // Every column's load issued before any store (a store could alias a
  // later column for all the compiler knows): one round trip, not one a
  // column.
  uint64_t v[TB_SHARD_COLS];
#pragma unroll
  for (int c = 0; c < TB_SHARD_COLS; ++c) {
    v[c] = 0;
    if (f && c < tabs.ncols) {
      v[c] = tabs.width[c] == 8
                 ? static_cast<const uint64_t*>(tabs.col[j][c])[slot]
                 : (uint64_t) static_cast<const uint32_t*>(tabs.col[j][c])[slot];
    }
  }
  row[i] = f ? 1 : 0;
  row[n + i] = f ? shard * (local_mask + 1) + slot : 0;
#pragma unroll
  for (int c = 0; c < TB_SHARD_COLS; ++c) {
    if (c < tabs.ncols) row[(int64_t)(2 + c) * n + i] = v[c];
  }
  LANE_MARK(2);
}

// `key_lo`/`key_hi`/`tomb` hold one table pointer per local shard, `cols`
// nlocal * ncols column pointers shard by shard, `shard_ids` each local
// shard's index in the mesh (distinct).  The answer rows start at `row`
// ((2 + ncols) * n u64 elements) and the overflow word is `ovf`, which must
// be zero on entry.
extern "C" int tb_shard_gather(int nlocal, const int64_t* shard_ids,
                               int64_t n_shards, int shift,
                               int64_t local_cap, const void* const* tkey_lo,
                               const void* const* tkey_hi,
                               const void* const* ttomb, int ncols,
                               const void* const* cols, const int* width,
                               int64_t max_probe, const void* key_lo,
                               const void* key_hi, int64_t n,
                               int64_t valid_count, const void* lane_mask,
                               void* row, void* ovf, int want_overflow,
                               void* stream) {
  if (ncols < 0 || ncols > TB_SHARD_COLS || nlocal < 0 || n_shards < 1 ||
      n_shards > TB_SHARD_MAX || (n_shards & (n_shards - 1)))
    return (int)cudaErrorInvalidValue;
  if (local_cap <= 0 || (local_cap & (local_cap - 1)))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || nlocal == 0) return 0;
  for (int c = 0; c < ncols; ++c) {
    if (width[c] != 4 && width[c] != 8) return (int)cudaErrorInvalidValue;
  }
  uint64_t local[TB_SHARD_MAX / 64] = {0, 0, 0, 0};
  for (int j = 0; j < nlocal; ++j) {
    const int64_t s = shard_ids[j];
    if (s < 0 || s >= n_shards || ((local[s >> 6] >> (s & 63)) & 1))
      return (int)cudaErrorInvalidValue;
    local[s >> 6] |= 1ull << (s & 63);
  }
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  for (int j0 = 0; j0 < nlocal; j0 += TB_SHARD_CHUNK) {
    const int k = nlocal - j0 < TB_SHARD_CHUNK ? nlocal - j0 : TB_SHARD_CHUNK;
    ShardTables tabs;
    tabs.ncols = ncols;
    tabs.first = j0 == 0;
    for (int w = 0; w < TB_SHARD_MAX / 64; ++w) tabs.local[w] = local[w];
    for (int c = 0; c < ncols; ++c) tabs.width[c] = width[c];
    for (int j = 0; j < k; ++j) {
      tabs.key_lo[j] = (const uint64_t*)tkey_lo[j0 + j];
      tabs.key_hi[j] = (const uint64_t*)tkey_hi[j0 + j];
      tabs.tomb[j] = (const uint8_t*)ttomb[j0 + j];
      tabs.shard[j] = (uint64_t)shard_ids[j0 + j];
      for (int c = 0; c < ncols; ++c)
        tabs.col[j][c] = cols[(int64_t)(j0 + j) * ncols + c];
    }
    dim3 grid((unsigned)blocks, (unsigned)k);
    shard_gather_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        tabs, (uint64_t)(n_shards - 1), shift, (uint64_t)(local_cap - 1),
        max_probe, (const uint64_t*)key_lo, (const uint64_t*)key_hi, n,
        valid_count, (const uint8_t*)lane_mask, (uint64_t*)row,
        (uint64_t*)ovf, want_overflow);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
