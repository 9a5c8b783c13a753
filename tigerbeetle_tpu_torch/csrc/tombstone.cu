// K8 tombstone: clear the keys at a list of slots, leaving tombstones.
//
// Replaces tigerbeetle_tpu/ops/hash_table.py:379 `remove_to_tombstone`: for
// every lane with `valid` set, key_lo[slot] = key_hi[slot] = 0 and
// tombstone[slot] = true; a slot at or above the capacity is dropped (the
// JAX scatter's mode="drop"), and `count` decreases by the number of valid
// lanes, dropped or not, as in JAX.
//
// One thread per lane, masked stores; each block sums its valid lanes and
// subtracts the sum from `count` with one integer atomicAdd (of the two's
// complement), which is exact and independent of the order.  Lanes naming
// the same slot store the same values.
//
// What bounds it on the H100: bytes, at random addresses: each valid lane
// reads its slot (8 B) and valid flag (1 B) and writes 17 B at the slot
// (two keys and the tombstone byte, three 32-B sectors); the invalid lanes
// read their flag only.
#include "common.cuh"
#include "tombstone.cuh"

__global__ void tombstone_kernel(uint64_t* key_lo, uint64_t* key_hi,
                                 uint8_t* tomb, uint64_t capacity,
                                 const int64_t* __restrict__ slot,
                                 const uint8_t* __restrict__ valid, int64_t n,
                                 ull* count) {
  __shared__ ull red[32];
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  ull k = 0;
  if (i < n && valid[i]) {
    k = 1;
    const uint64_t s = (uint64_t)slot[i];
    if (s < capacity) tombstone_slot(key_lo, key_hi, tomb, s);
  }
  const ull removed = block_sum(k, red);
  if (threadIdx.x == 0 && removed) atomicAdd(count, (ull)0 - removed);
}

extern "C" int tb_tombstone(void* key_lo, void* key_hi, void* tomb,
                            int64_t capacity, const void* slot,
                            const void* valid, int64_t n, void* count,
                            void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  tombstone_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint64_t*)key_lo, (uint64_t*)key_hi, (uint8_t*)tomb,
      (uint64_t)capacity, (const int64_t*)slot, (const uint8_t*)valid, n,
      (ull*)count);
  return (int)cudaGetLastError();
}
