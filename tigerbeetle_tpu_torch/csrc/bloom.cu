// K17 bloom_check: the cold tier's Bloom filter probe, and the general
// kernel's FLAG_COLD bit outside K1.
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
// On the general path's card route that branch is a step of K1's launch
// (csrc/probe.cu, the flag word); this launch serves `bloom_check_impl`
// (`out`) and `cold.bloom_flag` called on its own (`flag_word`).
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
// written (bloom_check_impl); with `flag_word` each warp that saw a hit ORs
// `flag_bit` into it with one atomicOr, on the card.
//
// What bounds it on the H100: latency.  Per tested id it reads 16 B of keys
// and four random 4-B words of the filter (a 32-B sector each); at 8,192
// lanes that is well under a megabyte.  So every load a lane needs is in
// flight at once: the keys and masks together, then the id's four words and
// the pending id's four, with no load waiting on an earlier word's bit;
// and the blocks are 64 threads, so that 8,192 lanes spread over 128 SMs.
#include "common.cuh"

#define BLOOM_HASHES 4
#define BLOOM_THREADS 64

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

// The four words of an id's positions, loaded at once (a lane that does
// not test it loads nothing), and the lane's hit once they are back.
struct Probe4 {
  uint32_t w[BLOOM_HASHES];
  uint32_t bit[BLOOM_HASHES];
};

static __device__ __forceinline__ void bloom_load(const BloomArgs& a, bool test,
                                                  uint64_t lo, uint64_t hi,
                                                  Probe4* p) {
  const uint64_t h1 = mix64(lo, hi);
  const uint64_t h2 = mix64(hi ^ 0x9E3779B97F4A7C15ull, lo) | 1ull;
#pragma unroll
  for (int j = 0; j < BLOOM_HASHES; ++j) {
    const uint64_t pos = (h1 + (uint64_t)j * h2) & a.bit_mask;
    p->w[j] = test ? __ldg(a.bloom + (pos >> 5)) : 0u;
    p->bit[j] = (uint32_t)(pos & 31);
  }
}

static __device__ __forceinline__ bool bloom_all(const Probe4& p) {
  uint32_t all = 1u;
#pragma unroll
  for (int j = 0; j < BLOOM_HASHES; ++j) all &= p.w[j] >> p.bit[j];
  return all & 1u;
}

__global__ void __launch_bounds__(BLOOM_THREADS) bloom_kernel(BloomArgs a) {
  const int64_t i = blockIdx.x * (int64_t)BLOOM_THREADS + threadIdx.x;
  const bool live = i < a.n;
  const int64_t j = live ? i : 0;
  const bool unchecked = live && !(a.checked && a.checked[j]);
  const bool t_id = unchecked && (a.valid == nullptr || a.valid[j]) &&
                    !(a.found && a.found[j]);
  const bool t_p = unchecked && a.postvoid && a.postvoid[j] &&
                   !(a.p_found && a.p_found[j]);
  // The keys load beside the masks, not after them.
  const uint64_t lo = live ? a.id_lo[j] : 0, hi = live ? a.id_hi[j] : 0;
  const bool pv = live && a.postvoid;
  const uint64_t plo = pv ? a.p_lo[j] : 0, phi = pv ? a.p_hi[j] : 0;
  Probe4 pid, ppend;
  bloom_load(a, t_id, lo, hi, &pid);
  bloom_load(a, t_p, plo, phi, &ppend);
  const bool hit = (t_id && bloom_all(pid)) || (t_p && bloom_all(ppend));
  if (a.out && live) a.out[i] = hit ? 1 : 0;
  // No thread has left: the whole warp takes part in the vote.
  if (a.flag_word && __any_sync(0xffffffffu, hit) && (threadIdx.x & 31) == 0)
    atomicOr(a.flag_word, a.flag_bit);
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
  bloom_kernel<<<(unsigned)((n + BLOOM_THREADS - 1) / BLOOM_THREADS),
                 BLOOM_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
