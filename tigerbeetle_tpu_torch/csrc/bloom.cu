// K17 bloom_check: the cold tier's Bloom filter probe, and the general
// kernel's FLAG_COLD bit.
//
// Replaces tigerbeetle_tpu/ops/cold.py:72 `bloom_check_impl` (with :60
// `_bloom_positions` and u128.py:118 `mix64`) and the cold branch of
// tigerbeetle_tpu/ops/transfer_full.py:638-659 `build_gather_ctx`, which
// calls it twice:
//
//   cold_ids  = valid    & ~ex_found & ~checked & bloom_check(id)
//   cold_pend = postvoid & ~p_found  & ~checked & bloom_check(pending_id)
//   probe_grow |= any(cold_ids | cold_pend) ? FLAG_COLD : 0
//
// An id's BLOOM_HASHES = 4 bit positions are double-hashed from two mix64
// values, h1 = mix64(lo, hi) and h2 = mix64(hi ^ golden, lo) | 1, as
// (h1 + i * h2) & (bits - 1); the id hits when all four bits are set.  The
// filter is u32 words (an int32 tensor holding the bits); its bit count is a
// power of two up to 2^34, so word indices are 64-bit.
//
// One thread per lane.  Every mask pointer may be null: a null `valid`
// tests every lane, a null `found` / `p_found` / `checked` is all false and
// a null `postvoid` tests no pending id.  With `out` the lane's hit is
// written (bloom_check_impl); with `flag_word` each block that saw a hit ORs
// `flag_bit` into it with one atomicOr, on the card, so the general kernel's
// single read-back of its flag word carries FLAG_COLD.
//
// What bounds it on the H100: latency.  Per tested id it reads 16 B of keys
// and four random 4-B words of the filter (a 32-B sector each); at 8,192
// lanes that is well under a megabyte, so a launch is a few microseconds of
// fixed cost.
#include "common.cuh"

#define BLOOM_HASHES 4

static __device__ __forceinline__ bool bloom_test(const uint32_t* __restrict__ bloom,
                                                  uint64_t bit_mask, uint64_t lo,
                                                  uint64_t hi) {
  const uint64_t h1 = mix64(lo, hi);
  const uint64_t h2 = mix64(hi ^ 0x9E3779B97F4A7C15ull, lo) | 1ull;
  bool hit = true;
#pragma unroll
  for (int i = 0; i < BLOOM_HASHES; ++i) {
    const uint64_t pos = (h1 + (uint64_t)i * h2) & bit_mask;
    const uint32_t word = __ldg(bloom + (pos >> 5));
    hit = hit && ((word >> (uint32_t)(pos & 31)) & 1u);
  }
  return hit;
}

struct BloomArgs {
  const uint32_t* bloom;
  uint64_t bit_mask;
  const uint64_t* id_lo;
  const uint64_t* id_hi;
  const uint8_t* valid;
  const uint8_t* found;
  const uint64_t* p_lo;
  const uint64_t* p_hi;
  const uint8_t* postvoid;
  const uint8_t* p_found;
  const uint8_t* checked;
  int64_t n;
  uint8_t* out;
  int* flag_word;
  int flag_bit;
};

__global__ void bloom_kernel(BloomArgs a) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  bool hit = false;
  if (i < a.n && !(a.checked && a.checked[i])) {
    if ((a.valid == nullptr || a.valid[i]) && !(a.found && a.found[i])) {
      hit = bloom_test(a.bloom, a.bit_mask, a.id_lo[i], a.id_hi[i]);
    }
    if (!hit && a.postvoid && a.postvoid[i] && !(a.p_found && a.p_found[i])) {
      hit = bloom_test(a.bloom, a.bit_mask, a.p_lo[i], a.p_hi[i]);
    }
  }
  if (a.out && i < a.n) a.out[i] = hit ? 1 : 0;
  if (a.flag_word && __syncthreads_or(hit) && threadIdx.x == 0) {
    atomicOr(a.flag_word, a.flag_bit);
  }
}

extern "C" int tb_bloom_check(const void* bloom, int64_t bits,
                              const void* id_lo, const void* id_hi,
                              const void* valid, const void* found,
                              const void* p_lo, const void* p_hi,
                              const void* postvoid, const void* p_found,
                              const void* checked, int64_t n, void* out,
                              void* flag_word, int flag_bit, void* stream) {
  if (bits < 32 || (bits & (bits - 1))) return (int)cudaErrorInvalidValue;
  if (postvoid && (p_lo == nullptr || p_hi == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  BloomArgs a;
  a.bloom = (const uint32_t*)bloom;
  a.bit_mask = (uint64_t)bits - 1;
  a.id_lo = (const uint64_t*)id_lo;
  a.id_hi = (const uint64_t*)id_hi;
  a.valid = (const uint8_t*)valid;
  a.found = (const uint8_t*)found;
  a.p_lo = (const uint64_t*)p_lo;
  a.p_hi = (const uint64_t*)p_hi;
  a.postvoid = (const uint8_t*)postvoid;
  a.p_found = (const uint8_t*)p_found;
  a.checked = (const uint8_t*)checked;
  a.n = n;
  a.out = (uint8_t*)out;
  a.flag_word = (int*)flag_word;
  a.flag_bit = flag_bit;
  const int threads = 256;
  bloom_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
