// K3 validate: the create_accounts / create_transfers result-code ladders,
// intra-batch duplicate resolution and linked-chain propagation.
//
// Replaces tigerbeetle_tpu/ops/state_machine.py:349 `account_codes` and :491
// `transfer_codes`, with what they call: :222 `_min_code`, :233
// `_merge_code`, :249 `_resolve_duplicates`, :287 `_chain_codes` and the
// exists ladders :454 and :766.
//
// Per lane, as in the JAX code:
//  1. the standalone ladder: the first failing check in precedence order
//     (the result enums are ordered so this is the minimum failing code),
//     merged by minimum with the exists ladder where the id was found;
//  2. duplicates: among lanes sharing an id, the first lane whose code is 0
//     wins; a later lane of the group whose code is 0 takes the exists
//     ladder against the winner's event.  Lanes are grouped through a
//     batch-local open-addressing table of lane indices (batch_hash.cuh:
//     atomicCAS on the first lane of each id) and the winner is an
//     atomicMin per group, so no
//     sort is needed and the result does not depend on thread order;
//  3. chains: a linked batch-final lane gets linked_event_chain_open (2);
//     in each chain the first failing lane keeps its code, lanes before it
//     get linked_event_failed (1) and lanes after it 1 (or 2 if linked and
//     batch-final).  The chain of a lane starts at the last chain start at or
//     before it: a block-wide max-scan, which stays exact for a chain as
//     long as the whole batch.
//
// One block of 1,024 threads runs the whole batch, with __syncthreads
// between the phases.  What bounds it on the H100: with a single block it is
// latency and one SM's share of bandwidth; the batch is about 19 columns by
// 8,192 lanes (1.2 MB) plus the gathered context, so even one SM streams it
// in tens of microseconds.  Spreading phase 1 over the card is later work.
#include "batch_hash.cuh"
#include "common.cuh"

#define VALIDATE_THREADS 1024

// Account batch columns, then the probe context (must match
// tigerbeetle_tpu_torch/ops/state_machine.py ACCOUNT_BATCH_COLS and
// ACCOUNT_EXISTS_COLS; a CPU test compares the names).
enum AccountCol {
  A_ID_LO, A_ID_HI,
  A_DEBITS_PENDING_LO, A_DEBITS_PENDING_HI,
  A_DEBITS_POSTED_LO, A_DEBITS_POSTED_HI,
  A_CREDITS_PENDING_LO, A_CREDITS_PENDING_HI,
  A_CREDITS_POSTED_LO, A_CREDITS_POSTED_HI,
  A_USER_DATA_128_LO, A_USER_DATA_128_HI,
  A_USER_DATA_64, A_USER_DATA_32, A_RESERVED, A_LEDGER, A_CODE, A_FLAGS,
  A_TIMESTAMP,
  A_FOUND,
  AE_FLAGS, AE_USER_DATA_128_LO, AE_USER_DATA_128_HI, AE_USER_DATA_64,
  AE_USER_DATA_32, AE_LEDGER, AE_CODE,
  A_NPTRS
};

// Transfer batch columns, then the probe context (must match
// TRANSFER_BATCH_COLS, TRANSFER_CTX_COLS and TRANSFER_EXISTS_COLS).
enum TransferCol {
  T_ID_LO, T_ID_HI,
  T_DEBIT_ACCOUNT_ID_LO, T_DEBIT_ACCOUNT_ID_HI,
  T_CREDIT_ACCOUNT_ID_LO, T_CREDIT_ACCOUNT_ID_HI,
  T_AMOUNT_LO, T_AMOUNT_HI, T_PENDING_ID_LO, T_PENDING_ID_HI,
  T_USER_DATA_128_LO, T_USER_DATA_128_HI, T_USER_DATA_64, T_USER_DATA_32,
  T_TIMEOUT, T_LEDGER, T_CODE, T_FLAGS, T_TIMESTAMP,
  TC_DR_FOUND, TC_CR_FOUND, TC_DR_LEDGER, TC_CR_LEDGER, TC_EX_FOUND,
  TE_FLAGS, TE_DEBIT_ACCOUNT_ID_LO, TE_DEBIT_ACCOUNT_ID_HI,
  TE_CREDIT_ACCOUNT_ID_LO, TE_CREDIT_ACCOUNT_ID_HI, TE_AMOUNT_LO,
  TE_AMOUNT_HI, TE_PENDING_ID_LO, TE_PENDING_ID_HI, TE_USER_DATA_128_LO,
  TE_USER_DATA_128_HI, TE_USER_DATA_64, TE_USER_DATA_32, TE_TIMEOUT, TE_CODE,
  T_NPTRS
};

#define U64(P, k, i) (static_cast<const uint64_t*>((P).p[k])[i])
#define U32(P, k, i) (static_cast<const uint32_t*>((P).p[k])[i])
#define B8(P, k, i) (static_cast<const uint8_t*>((P).p[k])[i] != 0)

static __device__ __forceinline__ uint32_t merge_code(uint32_t p, uint32_t s) {
  const uint32_t a = p ? p : 0xFFFFFFFFu, b = s ? s : 0xFFFFFFFFu;
  const uint32_t m = a < b ? a : b;
  return m == 0xFFFFFFFFu ? 0 : m;
}

static __device__ __forceinline__ bool z128(uint64_t lo, uint64_t hi) {
  return lo == 0 && hi == 0;
}
static __device__ __forceinline__ bool m128(uint64_t lo, uint64_t hi) {
  return lo == ~0ull && hi == ~0ull;
}

struct Accounts {
  static constexpr int ID_LO = A_ID_LO, ID_HI = A_ID_HI, FLAGS = A_FLAGS;

  // create_account_exists ladder of lane i against an existing account's
  // columns (a gathered table row, or the winner's batch lane).
  static __device__ uint32_t exists(const Ptrs& P, int64_t i, uint32_t ef,
                                    uint64_t eulo, uint64_t euhi, uint64_t eu64,
                                    uint32_t eu32, uint32_t eledger,
                                    uint32_t ecode) {
    if (U32(P, A_FLAGS, i) != ef) return 15;
    if (U64(P, A_USER_DATA_128_LO, i) != eulo || U64(P, A_USER_DATA_128_HI, i) != euhi) return 16;
    if (U64(P, A_USER_DATA_64, i) != eu64) return 17;
    if (U32(P, A_USER_DATA_32, i) != eu32) return 18;
    if (U32(P, A_LEDGER, i) != eledger) return 19;
    if (U32(P, A_CODE, i) != ecode) return 20;
    return 21;
  }

  static __device__ uint32_t standalone(const Ptrs& P, int64_t i, int64_t count,
                                        uint64_t batch_ts) {
    const uint32_t flags = U32(P, A_FLAGS, i);
    uint32_t c = 0;
    if (U64(P, A_TIMESTAMP, i) != 0) c = 3;
    else if (U32(P, A_RESERVED, i) != 0) c = 4;
    else if (flags & 0xFFF0u) c = 5;
    else if (z128(U64(P, A_ID_LO, i), U64(P, A_ID_HI, i))) c = 6;
    else if (m128(U64(P, A_ID_LO, i), U64(P, A_ID_HI, i))) c = 7;
    else if ((flags & 2u) && (flags & 4u)) c = 8;
    else if (!z128(U64(P, A_DEBITS_PENDING_LO, i), U64(P, A_DEBITS_PENDING_HI, i))) c = 9;
    else if (!z128(U64(P, A_DEBITS_POSTED_LO, i), U64(P, A_DEBITS_POSTED_HI, i))) c = 10;
    else if (!z128(U64(P, A_CREDITS_PENDING_LO, i), U64(P, A_CREDITS_PENDING_HI, i))) c = 11;
    else if (!z128(U64(P, A_CREDITS_POSTED_LO, i), U64(P, A_CREDITS_POSTED_HI, i))) c = 12;
    else if (U32(P, A_LEDGER, i) == 0) c = 13;
    else if (U32(P, A_CODE, i) == 0) c = 14;
    if (B8(P, A_FOUND, i)) {
      c = merge_code(c, exists(P, i, U32(P, AE_FLAGS, i), U64(P, AE_USER_DATA_128_LO, i),
                               U64(P, AE_USER_DATA_128_HI, i), U64(P, AE_USER_DATA_64, i),
                               U32(P, AE_USER_DATA_32, i), U32(P, AE_LEDGER, i),
                               U32(P, AE_CODE, i)));
    }
    return c;
  }

  static __device__ uint32_t exists_vs_lane(const Ptrs& P, int64_t i, int64_t w) {
    return exists(P, i, U32(P, A_FLAGS, w), U64(P, A_USER_DATA_128_LO, w),
                  U64(P, A_USER_DATA_128_HI, w), U64(P, A_USER_DATA_64, w),
                  U32(P, A_USER_DATA_32, w), U32(P, A_LEDGER, w),
                  U32(P, A_CODE, w));
  }
};

struct Transfers {
  static constexpr int ID_LO = T_ID_LO, ID_HI = T_ID_HI, FLAGS = T_FLAGS;

  // create_transfer_exists ladder of lane i against an existing event's
  // columns (a gathered table row, or the winner's batch lane).
  static __device__ uint32_t exists(const Ptrs& P, int64_t i, uint32_t ef,
                                    uint64_t edrlo, uint64_t edrhi, uint64_t ecrlo,
                                    uint64_t ecrhi, uint64_t eamlo, uint64_t eamhi,
                                    uint64_t epdlo, uint64_t epdhi, uint64_t eulo,
                                    uint64_t euhi, uint64_t eu64, uint32_t eu32,
                                    uint32_t etimeout, uint32_t ecode) {
    if (U32(P, T_FLAGS, i) != ef) return 36;
    if (U64(P, T_DEBIT_ACCOUNT_ID_LO, i) != edrlo || U64(P, T_DEBIT_ACCOUNT_ID_HI, i) != edrhi) return 37;
    if (U64(P, T_CREDIT_ACCOUNT_ID_LO, i) != ecrlo || U64(P, T_CREDIT_ACCOUNT_ID_HI, i) != ecrhi) return 38;
    if (U64(P, T_AMOUNT_LO, i) != eamlo || U64(P, T_AMOUNT_HI, i) != eamhi) return 39;
    if (U64(P, T_PENDING_ID_LO, i) != epdlo || U64(P, T_PENDING_ID_HI, i) != epdhi) return 40;
    if (U64(P, T_USER_DATA_128_LO, i) != eulo || U64(P, T_USER_DATA_128_HI, i) != euhi) return 41;
    if (U64(P, T_USER_DATA_64, i) != eu64) return 42;
    if (U32(P, T_USER_DATA_32, i) != eu32) return 43;
    if (U32(P, T_TIMEOUT, i) != etimeout) return 44;
    if (U32(P, T_CODE, i) != ecode) return 45;
    return 46;
  }

  static __device__ uint32_t standalone(const Ptrs& P, int64_t i, int64_t count,
                                        uint64_t batch_ts) {
    const uint32_t flags = U32(P, T_FLAGS, i);
    const uint32_t timeout = U32(P, T_TIMEOUT, i);
    const bool valid = i < count;
    const bool dr_found = B8(P, TC_DR_FOUND, i), cr_found = B8(P, TC_CR_FOUND, i);
    const bool both = dr_found && cr_found;
    const uint64_t dlo = U64(P, T_DEBIT_ACCOUNT_ID_LO, i), dhi = U64(P, T_DEBIT_ACCOUNT_ID_HI, i);
    const uint64_t clo = U64(P, T_CREDIT_ACCOUNT_ID_LO, i), chi = U64(P, T_CREDIT_ACCOUNT_ID_HI, i);
    // event timestamp = batch_ts - count + lane + 1 (u64, wrapping).
    const uint64_t ts = batch_ts - (uint64_t)count + (uint64_t)i + 1;
    // overflows_timeout: u32 -> u64 widening without sign extension.
    const uint64_t ts_sum = ts + (uint64_t)timeout * 1000000000ull;
    uint32_t c = 0;
    if (U64(P, T_TIMESTAMP, i) != 0) c = 3;
    else if (flags & 0xFFC0u) c = 4;
    else if (z128(U64(P, T_ID_LO, i), U64(P, T_ID_HI, i))) c = 5;
    else if (m128(U64(P, T_ID_LO, i), U64(P, T_ID_HI, i))) c = 6;
    else if (z128(dlo, dhi)) c = 8;
    else if (m128(dlo, dhi)) c = 9;
    else if (z128(clo, chi)) c = 10;
    else if (m128(clo, chi)) c = 11;
    else if (dlo == clo && dhi == chi) c = 12;
    else if (!z128(U64(P, T_PENDING_ID_LO, i), U64(P, T_PENDING_ID_HI, i))) c = 13;
    else if (!(flags & 2u) && timeout != 0) c = 17;
    else if (z128(U64(P, T_AMOUNT_LO, i), U64(P, T_AMOUNT_HI, i))) c = 18;
    else if (U32(P, T_LEDGER, i) == 0) c = 19;
    else if (U32(P, T_CODE, i) == 0) c = 20;
    else if (valid && !dr_found) c = 21;
    else if (valid && !cr_found) c = 22;
    else if (both && U32(P, TC_DR_LEDGER, i) != U32(P, TC_CR_LEDGER, i)) c = 23;
    else if (both && U32(P, T_LEDGER, i) != U32(P, TC_DR_LEDGER, i)) c = 24;
    else if (ts_sum < ts) c = 53;
    if (B8(P, TC_EX_FOUND, i)) {
      c = merge_code(c, exists(P, i, U32(P, TE_FLAGS, i),
                               U64(P, TE_DEBIT_ACCOUNT_ID_LO, i), U64(P, TE_DEBIT_ACCOUNT_ID_HI, i),
                               U64(P, TE_CREDIT_ACCOUNT_ID_LO, i), U64(P, TE_CREDIT_ACCOUNT_ID_HI, i),
                               U64(P, TE_AMOUNT_LO, i), U64(P, TE_AMOUNT_HI, i),
                               U64(P, TE_PENDING_ID_LO, i), U64(P, TE_PENDING_ID_HI, i),
                               U64(P, TE_USER_DATA_128_LO, i), U64(P, TE_USER_DATA_128_HI, i),
                               U64(P, TE_USER_DATA_64, i), U32(P, TE_USER_DATA_32, i),
                               U32(P, TE_TIMEOUT, i), U32(P, TE_CODE, i)));
    }
    return c;
  }

  static __device__ uint32_t exists_vs_lane(const Ptrs& P, int64_t i, int64_t w) {
    return exists(P, i, U32(P, T_FLAGS, w),
                  U64(P, T_DEBIT_ACCOUNT_ID_LO, w), U64(P, T_DEBIT_ACCOUNT_ID_HI, w),
                  U64(P, T_CREDIT_ACCOUNT_ID_LO, w), U64(P, T_CREDIT_ACCOUNT_ID_HI, w),
                  U64(P, T_AMOUNT_LO, w), U64(P, T_AMOUNT_HI, w),
                  U64(P, T_PENDING_ID_LO, w), U64(P, T_PENDING_ID_HI, w),
                  U64(P, T_USER_DATA_128_LO, w), U64(P, T_USER_DATA_128_HI, w),
                  U64(P, T_USER_DATA_64, w), U32(P, T_USER_DATA_32, w),
                  U32(P, T_TIMEOUT, w), U32(P, T_CODE, w));
  }
};

// Scratch (int32): hkey[hsize], hwin[hsize], grp[n], cstart[n], fail[n].
template <class V>
__global__ void __launch_bounds__(VALIDATE_THREADS, 1)
    validate_kernel(Ptrs P, int64_t n, int64_t count, uint64_t batch_ts,
                    const uint64_t* __restrict__ count_word,
                    const uint64_t* __restrict__ ts_word,
                    uint32_t* __restrict__ codes, uint8_t* __restrict__ ok,
                    int* __restrict__ scratch, int64_t hsize) {
  __shared__ int sh[VALIDATE_THREADS];
  // From device words when given (the grouped commit's CUDA graph).
  if (count_word) count = (int64_t)*count_word;
  if (ts_word) batch_ts = *ts_word;
  int* hkey = scratch;
  int* hwin = scratch + hsize;
  int* grp = scratch + 2 * hsize;
  int* cstart = grp + n;
  int* fail = cstart + n;
  const int T = blockDim.x, tid = threadIdx.x;
  const int inf = (int)n;
  auto linked = [&](int64_t j) -> bool {
    return j >= 0 && j < count && (U32(P, V::FLAGS, j) & 1u);
  };

  for (int64_t j = tid; j < hsize; j += T) {
    hkey[j] = -1;
    hwin[j] = inf;
  }
  for (int64_t j = tid; j < n; j += T) fail[j] = inf;
  __syncthreads();

  // 1. Standalone ladder (merged with the exists ladder), id groups, winners.
  for (int64_t i = tid; i < n; i += T) {
    const uint32_t c = V::standalone(P, i, count, batch_ts);
    codes[i] = c;
    const int h = batch_hash_insert(
        hkey, (int)hsize, static_cast<const uint64_t*>(P.p[V::ID_LO]),
        static_cast<const uint64_t*>(P.p[V::ID_HI]), (int)i);
    grp[i] = h;
    if (c == 0 && i < count) atomicMin(hwin + h, (int)i);
  }
  __syncthreads();

  // 2. Later duplicates compare against the winner; chain-open at the end.
  for (int64_t i = tid; i < n; i += T) {
    uint32_t c = codes[i];
    const int w = hwin[grp[i]];
    if (w < inf && i > w && c == 0) c = V::exists_vs_lane(P, i, w);
    if (i == count - 1 && linked(i)) c = 2;
    codes[i] = c;
  }
  __syncthreads();

  // 3. Chain start of every lane: inclusive max-scan of chain starts over
  //    contiguous chunks, one chunk per thread.
  const int64_t per = (n + T - 1) / T;
  const int64_t lo = tid * per, hi = (lo + per < n) ? lo + per : n;
  int last = -1;
  for (int64_t j = lo; j < hi; ++j) {
    if (linked(j) && !linked(j - 1)) last = (int)j;
  }
  sh[tid] = last;
  __syncthreads();
  for (int off = 1; off < T; off <<= 1) {
    const int v = tid >= off ? sh[tid - off] : -1;
    __syncthreads();
    if (v > sh[tid]) sh[tid] = v;
    __syncthreads();
  }
  int cur = tid > 0 ? sh[tid - 1] : -1;
  for (int64_t j = lo; j < hi; ++j) {
    if (linked(j) && !linked(j - 1)) cur = (int)j;
    cstart[j] = cur;
    if ((linked(j) || linked(j - 1)) && codes[j] != 0) atomicMin(fail + cur, (int)j);
  }
  __syncthreads();

  // 4. First failure of each chain rolls the chain back.
  for (int64_t i = tid; i < n; i += T) {
    const uint32_t co = codes[i];
    const bool lk = linked(i);
    uint32_t out = co;
    if (lk || linked(i - 1)) {
      const int f = fail[cstart[i]];
      if (f < inf) {
        if (i < f) out = 1;
        else if (i == f) out = co;
        else out = (i == count - 1 && lk) ? 2 : 1;
      }
    }
    codes[i] = out;
    ok[i] = (out == 0 && i < count) ? 1 : 0;
  }
}

static int launch_validate(int variant, int nptrs, const void* const* ptrs,
                           int64_t n, int64_t count, uint64_t batch_ts,
                           const void* count_word, const void* ts_word,
                           void* codes, void* ok, void* scratch, int64_t hsize,
                           void* stream) {
  const int want = variant == 0 ? (int)A_NPTRS : (int)T_NPTRS;
  if (nptrs != want || n > INT_MAX / 2 || hsize < 2 * n ||
      (hsize & (hsize - 1)))
    return (int)cudaErrorInvalidValue;
  Ptrs P;
  int err = pack_ptrs(&P, nptrs, ptrs);
  if (err) return err;
  if (n == 0) return 0;
  if (variant == 0) {
    validate_kernel<Accounts><<<1, VALIDATE_THREADS, 0, (cudaStream_t)stream>>>(
        P, n, count, batch_ts, (const uint64_t*)count_word,
        (const uint64_t*)ts_word, (uint32_t*)codes, (uint8_t*)ok, (int*)scratch,
        hsize);
  } else {
    validate_kernel<Transfers><<<1, VALIDATE_THREADS, 0, (cudaStream_t)stream>>>(
        P, n, count, batch_ts, (const uint64_t*)count_word,
        (const uint64_t*)ts_word, (uint32_t*)codes, (uint8_t*)ok, (int*)scratch,
        hsize);
  }
  return (int)cudaGetLastError();
}

extern "C" int tb_validate_accounts(int nptrs, const void* const* ptrs, int64_t n,
                                    int64_t count, void* codes, void* ok,
                                    void* scratch, int64_t hsize, void* stream) {
  return launch_validate(0, nptrs, ptrs, n, count, 0, nullptr, nullptr, codes,
                         ok, scratch, hsize, stream);
}

// `count_word` and `ts_word`, when not null, are u64 device words the
// batch's count and timestamp are read from when the kernel runs (the
// grouped commit's CUDA graph).
extern "C" int tb_validate_transfers(int nptrs, const void* const* ptrs,
                                     int64_t n, int64_t count,
                                     uint64_t batch_ts, const void* count_word,
                                     const void* ts_word, void* codes,
                                     void* ok, void* scratch, int64_t hsize,
                                     void* stream) {
  return launch_validate(1, nptrs, ptrs, n, count, batch_ts, count_word,
                         ts_word, codes, ok, scratch, hsize, stream);
}
