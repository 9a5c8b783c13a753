// K30 shard_gather: the owner-masked local probe and column gather of every
// shard a device holds, in one launch, into the shards' rows of a packed
// int64 partial buffer that K31 (shard_combine.cu) then sums.
//
// Replaces tigerbeetle_tpu/parallel/sharded.py:142-164 `_ShardGather`'s
// per-shard half: `ht.lookup(table, lo, hi, MAX_PROBE, hash_shift=shift)`
// on the shard's local table, masked to the keys the shard owns
// (owner = mix64(key) & (n_shards - 1)), the global slot
// shard * (C/n) + slot, `gather_cols` at the found slots, and the local
// probe's overflow flag.  The psum that follows there is K31.
//
// Semantics (bit for bit the JAX function, and K1's for one table): grid.y
// is the local shard j, one thread a lane i.  The thread hashes the key
// once; when shard j owns it, it probes j's local table from
// home = (mix64 >> shift) & (C/n - 1), linearly, at most max_probe steps,
// stopping on the key (found) or on an empty slot with no tombstone; a zero
// key is done at once.  It writes, in shard j's row of the partial,
//   found[i]  = 1 if found, i < valid_count and lane_mask[i] (when given),
//   gslot[i]  = shard * (C/n) + slot where found, else 0,
//   col_c[i]  = the slot's column value, u32 zero-extended, where found,
// and zeros where the shard does not own the key or does not find it, so
// the sum over the shards is each lane's owner's answer.  The JAX
// function's overflow flag covers every lane of every shard's local probe,
// owned or not; when `want_overflow` is set the thread probes a key it does
// not own too (for that flag alone) and stores 1 in shard j's overflow
// word if the probe did not end within max_probe steps.
//
// What bounds it on the H100: bytes at random addresses, as K1: the keys,
// one probe window of 17 B a step (key pair and tombstone) per probed lane,
// and the gathered columns, then one coalesced 8-B store per output row.
#include "common.cuh"

#define TB_SHARD_CHUNK 8   // local shards per launch (grid.y)
#define TB_SHARD_COLS 20   // gathered columns per launch

struct ShardTables {
  const uint64_t* key_lo[TB_SHARD_CHUNK];
  const uint64_t* key_hi[TB_SHARD_CHUNK];
  const uint8_t* tomb[TB_SHARD_CHUNK];
  const void* col[TB_SHARD_CHUNK][TB_SHARD_COLS];
  uint64_t shard[TB_SHARD_CHUNK];  // the local shard's index in the mesh
  int width[TB_SHARD_COLS];        // bytes per element: 4 or 8
  int ncols;
};

__global__ void shard_gather_kernel(ShardTables tabs, uint64_t owner_mask,
                                    int shift, uint64_t local_mask,
                                    int64_t max_probe,
                                    const uint64_t* __restrict__ key_lo,
                                    const uint64_t* __restrict__ key_hi,
                                    int64_t n, int64_t valid_count,
                                    const uint8_t* __restrict__ lane_mask,
                                    uint64_t* __restrict__ out,
                                    int64_t shard_stride,
                                    uint64_t* __restrict__ ovf,
                                    int want_overflow) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  if (i >= n) return;
  const uint64_t lo = key_lo[i], hi = key_hi[i];
  const uint64_t h = mix64(lo, hi);
  const uint64_t shard = tabs.shard[j];
  const bool mine = (h & owner_mask) == shard;
  bool done = (lo == 0 && hi == 0) || !(mine || want_overflow);
  bool found = false;
  uint64_t slot = 0;
  const uint64_t home = (h >> shift) & local_mask;
  const uint64_t* tlo = tabs.key_lo[j];
  const uint64_t* thi = tabs.key_hi[j];
  const uint8_t* tomb = tabs.tomb[j];
  for (int64_t t = 0; t < max_probe && !done; ++t) {
    const uint64_t cur = (home + (uint64_t)t) & local_mask;
    const bool tb = tomb[cur] != 0;
    const uint64_t a = tlo[cur], b = thi[cur];
    if (!tb && a == lo && b == hi) {
      found = true;
      slot = cur;
      done = true;
    } else if (!tb && a == 0 && b == 0) {
      done = true;
    }
  }
  if (!done && want_overflow) ovf[j * shard_stride] = 1;  // all store 1
  const bool f = found && mine && i < valid_count && (!lane_mask || lane_mask[i]);
  uint64_t* row = out + j * shard_stride;
  row[i] = f ? 1 : 0;
  row[n + i] = f ? shard * (local_mask + 1) + slot : 0;
  for (int c = 0; c < tabs.ncols; ++c) {
    uint64_t v = 0;
    if (f) {
      v = tabs.width[c] == 8
              ? static_cast<const uint64_t*>(tabs.col[j][c])[slot]
              : (uint64_t) static_cast<const uint32_t*>(tabs.col[j][c])[slot];
    }
    row[(int64_t)(2 + c) * n + i] = v;
  }
}

// `key_lo`/`key_hi`/`tomb` hold one table pointer per local shard, `cols`
// nlocal * ncols column pointers shard by shard, `shard_ids` each local
// shard's index in the mesh.  Shard j's rows start at out + j * shard_stride
// (u64 elements) and its overflow word at ovf + j * shard_stride; the
// overflow words must be zero on entry.
extern "C" int tb_shard_gather(int nlocal, const int64_t* shard_ids,
                               int64_t n_shards, int shift,
                               int64_t local_cap, const void* const* tkey_lo,
                               const void* const* tkey_hi,
                               const void* const* ttomb, int ncols,
                               const void* const* cols, const int* width,
                               int64_t max_probe, const void* key_lo,
                               const void* key_hi, int64_t n,
                               int64_t valid_count, const void* lane_mask,
                               void* out, int64_t shard_stride, void* ovf,
                               int want_overflow, void* stream) {
  if (ncols < 0 || ncols > TB_SHARD_COLS || nlocal < 0)
    return (int)cudaErrorInvalidValue;
  if (local_cap <= 0 || (local_cap & (local_cap - 1)))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || nlocal == 0) return 0;
  for (int c = 0; c < ncols; ++c) {
    if (width[c] != 4 && width[c] != 8) return (int)cudaErrorInvalidValue;
  }
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  for (int j0 = 0; j0 < nlocal; j0 += TB_SHARD_CHUNK) {
    const int k = nlocal - j0 < TB_SHARD_CHUNK ? nlocal - j0 : TB_SHARD_CHUNK;
    ShardTables tabs;
    tabs.ncols = ncols;
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
        valid_count, (const uint8_t*)lane_mask,
        (uint64_t*)out + (int64_t)j0 * shard_stride, shard_stride,
        (uint64_t*)ovf + (int64_t)j0 * shard_stride, want_overflow);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
