// K1 probe: batched linear probe of the hash table fused with the column
// gather.
//
// Replaces tigerbeetle_tpu/ops/hash_table.py:70 `lookup` (a lax.while_loop
// over all lanes) with the column gather of :335 `gather_cols`, and the
// u128.py:118 `mix64` it hashes with.
//
// Semantics (bit for bit the JAX function): home = (mix64(key) >> shift) &
// (C-1); a lane probes home, home+1, ... for at most max_probe steps; it is
// done on a slot holding its key and no tombstone (found) or on an empty
// slot with no tombstone (absent); a lane with key 0 is done at once.
// `found` is masked to lanes below `valid_count` and, when `lane_mask` is
// not null, to the lanes it sets; `slot` is the matching slot
// or 0; the gathered columns are zero where not found; `overflow` is set when
// any lane is not done after max_probe steps.
//
// What bounds it on the H100: bytes, at random addresses.  One thread per
// lane; each probe step reads 17 B of one slot (key pair and tombstone) in
// three 32-B sectors, so the sector traffic, not the arithmetic (one mix64 per
// lane), is the cost.  At load <= 0.5 the expected probe length is under two
// steps.  The design keeps one lane per thread so that the long tail of a
// cluster costs only the lanes in it.
#include "common.cuh"

__global__ void probe_kernel(const uint64_t* __restrict__ tkey_lo,
                             const uint64_t* __restrict__ tkey_hi,
                             const uint8_t* __restrict__ tomb, uint64_t mask,
                             int hash_shift, int64_t max_probe,
                             const uint64_t* __restrict__ key_lo,
                             const uint64_t* __restrict__ key_hi, int64_t n,
                             int64_t valid_count,
                             const uint64_t* __restrict__ count_word,
                             const uint8_t* __restrict__ lane_mask,
                             uint8_t* __restrict__ found_out,
                             int64_t* __restrict__ slot_out,
                             int* __restrict__ overflow, ColList cols) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint64_t lo = key_lo[i], hi = key_hi[i];
  bool done = (lo == 0 && hi == 0);
  bool found = false;
  uint64_t slot = 0;
  const uint64_t home = (mix64(lo, hi) >> hash_shift) & mask;
  for (int64_t t = 0; t < max_probe && !done; ++t) {
    const uint64_t cur = (home + (uint64_t)t) & mask;
    const bool tb = tomb[cur] != 0;
    const uint64_t a = tkey_lo[cur], b = tkey_hi[cur];
    if (!tb && a == lo && b == hi) {
      found = true;
      slot = cur;
      done = true;
    } else if (!tb && a == 0 && b == 0) {
      done = true;
    }
  }
  if (!done && overflow) atomicOr(overflow, 1);
  if (count_word) valid_count = (int64_t)*count_word;
  const bool f = found && i < valid_count && (!lane_mask || lane_mask[i]);
  found_out[i] = f ? 1 : 0;
  slot_out[i] = (int64_t)slot;
  for (int c = 0; c < cols.n; ++c) {
    if (f) {
      copy_elem(cols.dst[c], i, cols.src[c], (int64_t)slot, cols.width[c]);
    } else {
      zero_elem(cols.dst[c], i, cols.width[c]);
    }
  }
}

// `valid_count` is read from the u64 device word `count_word` when that is
// not null (the grouped commit's CUDA graph: one captured launch serves
// every run); `overflow` may be null (the fast path reads the table's flag,
// not the probe's).
extern "C" int tb_probe(const void* tkey_lo, const void* tkey_hi,
                        const void* tomb, int64_t capacity, int hash_shift,
                        int64_t max_probe, const void* key_lo,
                        const void* key_hi, int64_t n, int64_t valid_count,
                        const void* count_word, const void* lane_mask,
                        void* found, void* slot, void* overflow, int ncols,
                        const void* const* src, void* const* dst,
                        const int* width, void* stream) {
  ColList cols;
  int err = pack_cols(&cols, ncols, src, dst, width);
  if (err) return err;
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  probe_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)tkey_lo, (const uint64_t*)tkey_hi, (const uint8_t*)tomb,
      (uint64_t)(capacity - 1), hash_shift, max_probe,
      (const uint64_t*)key_lo, (const uint64_t*)key_hi, n, valid_count,
      (const uint64_t*)count_word, (const uint8_t*)lane_mask, (uint8_t*)found,
      (int64_t*)slot, (int*)overflow, cols);
  return (int)cudaGetLastError();
}

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
