// K5 digest: the order-independent parity digest of all account balances.
//
// Replaces tigerbeetle_tpu/ops/state_machine.py:828 `ledger_digest` (with
// u128.py:118 `mix64`): the wrapping u64 sum, over live slots (key != 0), of
//   h = mix64(id); h = mix64(h ^ f_lo, h ^ f_hi) for the four balance fields;
//   h = mix64(h, timestamp).
// Each block sums its slots and adds the sum to the output with a u64
// atomicAdd; both wrap modulo 2^64 and integer addition commutes, so the
// result is exact and independent of the order.
//
// What bounds it on the H100: bytes.  It streams the two key columns of
// every slot (16 B) once, coalesced, and reads the nine digested u64
// columns (72 B) of live slots only; the five mix64 per live slot are a few
// dozen integer operations against that.
#include "common.cuh"

struct DigestCols {
  const uint64_t* col[9];  // four balance fields lo/hi in ledger order, then
                           // timestamp
};

__global__ void digest_kernel(const uint64_t* __restrict__ key_lo,
                              const uint64_t* __restrict__ key_hi,
                              DigestCols c, int64_t capacity, ull* out) {
  __shared__ ull red[32];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  ull sum = 0;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < capacity;
       i += stride) {
    const uint64_t lo = key_lo[i], hi = key_hi[i];
    if (lo == 0 && hi == 0) continue;
    uint64_t h = mix64(lo, hi);
    for (int f = 0; f < 4; ++f) h = mix64(h ^ c.col[2 * f][i], h ^ c.col[2 * f + 1][i]);
    sum += mix64(h, c.col[8][i]);
  }
  const ull total = block_sum(sum, red);
  if (threadIdx.x == 0) atomicAdd(out, total);
}

// `out` (one u64) must be zero on entry.
extern "C" int tb_digest(const void* key_lo, const void* key_hi,
                         const void* const* cols, int64_t capacity, void* out,
                         void* stream) {
  DigestCols c;
  for (int k = 0; k < 9; ++k) c.col[k] = (const uint64_t*)cols[k];
  const int threads = 256;
  int64_t blocks = (capacity + threads - 1) / threads;
  if (blocks > 1056) blocks = 1056;  // 8 blocks on each of 132 SMs
  if (blocks < 1) return 0;
  digest_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)key_lo, (const uint64_t*)key_hi, c, capacity, (ull*)out);
  return (int)cudaGetLastError();
}
