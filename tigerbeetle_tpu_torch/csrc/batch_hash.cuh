// A batch-local open-addressing table of lane indices keyed by the lanes'
// u128 ids, for grouping equal ids inside one batch (K3's duplicates).
// `hkey` holds hsize ints (a power of two, at least twice the lanes), -1
// where empty; a slot is keyed by the first lane that claims it with
// atomicCAS, and the table compares ids through that lane.
#pragma once

#include "common.cuh"

// The slot of lane i's id: claimed by lane i, or by an earlier claimant of
// the same id.
static __device__ __forceinline__ int batch_hash_insert(
    int* hkey, int hsize, const uint64_t* key_lo, const uint64_t* key_hi,
    int i) {
  const uint64_t lo = key_lo[i], hi = key_hi[i];
  uint64_t h = mix64(lo, hi) & (uint64_t)(hsize - 1);
  for (;;) {
    const int prev = atomicCAS(hkey + h, -1, i);
    if (prev == -1 || (key_lo[prev] == lo && key_hi[prev] == hi)) return (int)h;
    h = (h + 1) & (uint64_t)(hsize - 1);
  }
}
