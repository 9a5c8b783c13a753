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
//     atomicMin per group, so no sort is needed and the result does not
//     depend on thread order;
//  3. chains: a linked batch-final lane gets linked_event_chain_open (2);
//     in each chain the first failing lane keeps its code, lanes before it
//     get linked_event_failed (1) and lanes after it 1 (or 2 if linked and
//     batch-final).  The chain of a lane starts at the last chain start at or
//     before it: a two-level max-scan (within a block, then over the
//     blocks' summaries), exact for a chain as long as the whole batch.
//
// Design: one cooperative launch over the whole card, one lane a thread
// (blocks of 128; 64 blocks for a batch of 8,192 lanes; a batch wider than
// the card holds at once takes several contiguous lanes a thread).  Four
// grid barriers order the batch-wide steps: (0) the id table cleared, (1)
// every lane's ladder, id group and winner, (2) the later duplicates against
// their winners and each block's last chain start, (3) each chain's first
// failure (atomicMin, which commutes), then the rollback.  The ladders are
// branch-free: a lane loads every column it checks at once, then takes the
// first failing code by precedence with selects.  What another block wrote
// in the same launch is read with __ldcg.
//
// What bounds it on the H100: neither bytes (about 40 columns by 8,192
// lanes, 1.4 MB) nor operations; the parent's single block streamed them
// through one SM, eight lanes a thread (79 us a batch, 40 of them the
// ladders and the id table).  Spread over the card it is latency: a few
// dependent loads and atomics a phase and the grid barriers between them.
#include <cooperative_groups.h>

#include "batch_hash.cuh"
#include "common.cuh"
#include "phase_clock.cuh"

namespace cg = cooperative_groups;

#define VALIDATE_THREADS 128

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

// A check that fails sets the code; the checks run from the lowest
// precedence to the highest, so the first failing one in precedence order
// (the smallest code) is what stays.
#define FAILS(cond, code) c = (cond) ? (uint32_t)(code) : c

struct Accounts {
  static constexpr int ID_LO = A_ID_LO, ID_HI = A_ID_HI, FLAGS = A_FLAGS;

  // The columns the exists ladder compares.
  struct Row {
    uint64_t u128_lo, u128_hi, u64;
    uint32_t flags, u32, ledger, code;
  };

  static __device__ __forceinline__ Row batch_row(const Ptrs& P, int64_t i) {
    return Row{U64(P, A_USER_DATA_128_LO, i), U64(P, A_USER_DATA_128_HI, i),
               U64(P, A_USER_DATA_64, i), U32(P, A_FLAGS, i),
               U32(P, A_USER_DATA_32, i), U32(P, A_LEDGER, i),
               U32(P, A_CODE, i)};
  }

  // create_account_exists ladder of lane row `t` against an existing
  // account's row (a gathered table row, or the winner's batch lane).
  static __device__ __forceinline__ uint32_t exists(const Row& t, const Row& e) {
    uint32_t c = 21;
    FAILS(t.code != e.code, 20);
    FAILS(t.ledger != e.ledger, 19);
    FAILS(t.u32 != e.u32, 18);
    FAILS(t.u64 != e.u64, 17);
    FAILS(t.u128_lo != e.u128_lo || t.u128_hi != e.u128_hi, 16);
    FAILS(t.flags != e.flags, 15);
    return c;
  }

  static __device__ __forceinline__ uint32_t standalone(const Ptrs& P, int64_t i,
                                                        int64_t count,
                                                        uint64_t batch_ts) {
    const Row t = batch_row(P, i);
    const Row e{U64(P, AE_USER_DATA_128_LO, i), U64(P, AE_USER_DATA_128_HI, i),
                U64(P, AE_USER_DATA_64, i), U32(P, AE_FLAGS, i),
                U32(P, AE_USER_DATA_32, i), U32(P, AE_LEDGER, i),
                U32(P, AE_CODE, i)};
    const bool found = B8(P, A_FOUND, i);
    const uint64_t id_lo = U64(P, A_ID_LO, i), id_hi = U64(P, A_ID_HI, i);
    const uint64_t ts = U64(P, A_TIMESTAMP, i);
    const uint32_t reserved = U32(P, A_RESERVED, i);
    const uint64_t dp_lo = U64(P, A_DEBITS_PENDING_LO, i), dp_hi = U64(P, A_DEBITS_PENDING_HI, i);
    const uint64_t do_lo = U64(P, A_DEBITS_POSTED_LO, i), do_hi = U64(P, A_DEBITS_POSTED_HI, i);
    const uint64_t cp_lo = U64(P, A_CREDITS_PENDING_LO, i), cp_hi = U64(P, A_CREDITS_PENDING_HI, i);
    const uint64_t co_lo = U64(P, A_CREDITS_POSTED_LO, i), co_hi = U64(P, A_CREDITS_POSTED_HI, i);
    uint32_t c = 0;
    FAILS(t.code == 0, 14);
    FAILS(t.ledger == 0, 13);
    FAILS(!z128(co_lo, co_hi), 12);
    FAILS(!z128(cp_lo, cp_hi), 11);
    FAILS(!z128(do_lo, do_hi), 10);
    FAILS(!z128(dp_lo, dp_hi), 9);
    FAILS((t.flags & 2u) && (t.flags & 4u), 8);
    FAILS(m128(id_lo, id_hi), 7);
    FAILS(z128(id_lo, id_hi), 6);
    FAILS(t.flags & 0xFFF0u, 5);
    FAILS(reserved != 0, 4);
    FAILS(ts != 0, 3);
    return found ? merge_code(c, exists(t, e)) : c;
  }

  static __device__ uint32_t exists_vs_lane(const Ptrs& P, int64_t i, int64_t w) {
    return exists(batch_row(P, i), batch_row(P, w));
  }
};

struct Transfers {
  static constexpr int ID_LO = T_ID_LO, ID_HI = T_ID_HI, FLAGS = T_FLAGS;

  struct Row {
    uint64_t dr_lo, dr_hi, cr_lo, cr_hi, am_lo, am_hi, pd_lo, pd_hi;
    uint64_t u128_lo, u128_hi, u64;
    uint32_t flags, u32, timeout, code;
  };

  static __device__ __forceinline__ Row batch_row(const Ptrs& P, int64_t i) {
    return Row{U64(P, T_DEBIT_ACCOUNT_ID_LO, i), U64(P, T_DEBIT_ACCOUNT_ID_HI, i),
               U64(P, T_CREDIT_ACCOUNT_ID_LO, i), U64(P, T_CREDIT_ACCOUNT_ID_HI, i),
               U64(P, T_AMOUNT_LO, i), U64(P, T_AMOUNT_HI, i),
               U64(P, T_PENDING_ID_LO, i), U64(P, T_PENDING_ID_HI, i),
               U64(P, T_USER_DATA_128_LO, i), U64(P, T_USER_DATA_128_HI, i),
               U64(P, T_USER_DATA_64, i), U32(P, T_FLAGS, i),
               U32(P, T_USER_DATA_32, i), U32(P, T_TIMEOUT, i),
               U32(P, T_CODE, i)};
  }

  // create_transfer_exists ladder of lane row `t` against an existing
  // event's row (a gathered table row, or the winner's batch lane).
  static __device__ __forceinline__ uint32_t exists(const Row& t, const Row& e) {
    uint32_t c = 46;
    FAILS(t.code != e.code, 45);
    FAILS(t.timeout != e.timeout, 44);
    FAILS(t.u32 != e.u32, 43);
    FAILS(t.u64 != e.u64, 42);
    FAILS(t.u128_lo != e.u128_lo || t.u128_hi != e.u128_hi, 41);
    FAILS(t.pd_lo != e.pd_lo || t.pd_hi != e.pd_hi, 40);
    FAILS(t.am_lo != e.am_lo || t.am_hi != e.am_hi, 39);
    FAILS(t.cr_lo != e.cr_lo || t.cr_hi != e.cr_hi, 38);
    FAILS(t.dr_lo != e.dr_lo || t.dr_hi != e.dr_hi, 37);
    FAILS(t.flags != e.flags, 36);
    return c;
  }

  static __device__ __forceinline__ uint32_t standalone(const Ptrs& P, int64_t i,
                                                        int64_t count,
                                                        uint64_t batch_ts) {
    const Row t = batch_row(P, i);
    const Row e{U64(P, TE_DEBIT_ACCOUNT_ID_LO, i), U64(P, TE_DEBIT_ACCOUNT_ID_HI, i),
                U64(P, TE_CREDIT_ACCOUNT_ID_LO, i), U64(P, TE_CREDIT_ACCOUNT_ID_HI, i),
                U64(P, TE_AMOUNT_LO, i), U64(P, TE_AMOUNT_HI, i),
                U64(P, TE_PENDING_ID_LO, i), U64(P, TE_PENDING_ID_HI, i),
                U64(P, TE_USER_DATA_128_LO, i), U64(P, TE_USER_DATA_128_HI, i),
                U64(P, TE_USER_DATA_64, i), U32(P, TE_FLAGS, i),
                U32(P, TE_USER_DATA_32, i), U32(P, TE_TIMEOUT, i),
                U32(P, TE_CODE, i)};
    const bool ex_found = B8(P, TC_EX_FOUND, i);
    const uint64_t id_lo = U64(P, T_ID_LO, i), id_hi = U64(P, T_ID_HI, i);
    const uint64_t ts_in = U64(P, T_TIMESTAMP, i);
    const uint32_t ledger = U32(P, T_LEDGER, i);
    const bool dr_found = B8(P, TC_DR_FOUND, i), cr_found = B8(P, TC_CR_FOUND, i);
    const uint32_t dr_ledger = U32(P, TC_DR_LEDGER, i), cr_ledger = U32(P, TC_CR_LEDGER, i);
    const bool valid = i < count;
    const bool both = dr_found && cr_found;
    // event timestamp = batch_ts - count + lane + 1 (u64, wrapping).
    const uint64_t ts = batch_ts - (uint64_t)count + (uint64_t)i + 1;
    // overflows_timeout: u32 -> u64 widening without sign extension.
    const uint64_t ts_sum = ts + (uint64_t)t.timeout * 1000000000ull;
    uint32_t c = 0;
    FAILS(ts_sum < ts, 53);
    FAILS(both && ledger != dr_ledger, 24);
    FAILS(both && dr_ledger != cr_ledger, 23);
    FAILS(valid && !cr_found, 22);
    FAILS(valid && !dr_found, 21);
    FAILS(t.code == 0, 20);
    FAILS(ledger == 0, 19);
    FAILS(z128(t.am_lo, t.am_hi), 18);
    FAILS(!(t.flags & 2u) && t.timeout != 0, 17);
    FAILS(!z128(t.pd_lo, t.pd_hi), 13);
    FAILS(t.dr_lo == t.cr_lo && t.dr_hi == t.cr_hi, 12);
    FAILS(m128(t.cr_lo, t.cr_hi), 11);
    FAILS(z128(t.cr_lo, t.cr_hi), 10);
    FAILS(m128(t.dr_lo, t.dr_hi), 9);
    FAILS(z128(t.dr_lo, t.dr_hi), 8);
    FAILS(m128(id_lo, id_hi), 6);
    FAILS(z128(id_lo, id_hi), 5);
    FAILS(t.flags & 0xFFC0u, 4);
    FAILS(ts_in != 0, 3);
    return ex_found ? merge_code(c, exists(t, e)) : c;
  }

  static __device__ uint32_t exists_vs_lane(const Ptrs& P, int64_t i, int64_t w) {
    return exists(batch_row(P, i), batch_row(P, w));
  }
};

struct VArgs {
  Ptrs P;
  int64_t n, count;
  uint64_t batch_ts;
  const uint64_t* count_word;  // when not null, the count (a device word)
  const uint64_t* ts_word;     // when not null, the batch timestamp
  uint32_t* codes;
  uint8_t* ok;
  int* scratch;
  int64_t hsize;
  int64_t per;  // lanes a thread, contiguous
};

// The largest of v over this thread and the block's threads before it
// (`excl`: before it only); `total` the block's.  Every thread calls it.
static __device__ __forceinline__ int block_max_scan(int v, int* shared_warps,
                                                     int* excl, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off && u > incl) incl = u;
  }
  const int prev = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 31) shared_warps[warp] = incl;
  __syncthreads();
  int before = lane > 0 ? prev : -1, all = -1;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const int m = shared_warps[w];
    if (w < warp && m > before) before = m;
    if (m > all) all = m;
  }
  *excl = before;
  *total = all;
  return incl;
}

// Scratch (int32): hkey[hsize], hwin[hsize], fail[n], grp[n], cstart[n];
// hwin and fail hold unsigned lane indices, all ones where none.  Once
// every lane is grouped, hkey's first words hold the blocks' summaries.
template <class V>
__global__ void __launch_bounds__(VALIDATE_THREADS)
    validate_kernel(VArgs a) {
  __shared__ int s_warps[VALIDATE_THREADS / 32];
  PHASE_MARK(0);
  cg::grid_group grid = cg::this_grid();
  const int64_t n = a.n;
  // From device words when given (the grouped commit's CUDA graph).
  const int64_t count = a.count_word ? (int64_t)*a.count_word : a.count;
  const uint64_t batch_ts = a.ts_word ? *a.ts_word : a.batch_ts;
  const Ptrs& P = a.P;
  int* hkey = a.scratch;
  unsigned* hwin = reinterpret_cast<unsigned*>(a.scratch + a.hsize);
  unsigned* fail = reinterpret_cast<unsigned*>(a.scratch + 2 * a.hsize);
  int* grp = a.scratch + 2 * a.hsize + n;
  int* cstart = grp + n;
  int* blk = hkey;
  const int64_t gt = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t lo = gt * a.per;
  const int64_t hi = lo + a.per < n ? lo + a.per : n;
  auto linked = [&](int64_t j) -> bool {
    return j >= 0 && j < count && (U32(P, V::FLAGS, j) & 1u);
  };
  auto starts = [&](int64_t j) -> bool { return linked(j) && !linked(j - 1); };

  // 0. The batch's id table, empty.
  for (int64_t j = gt; j < a.hsize; j += (int64_t)gridDim.x * blockDim.x) {
    hkey[j] = -1;
    hwin[j] = 0xFFFFFFFFu;
  }
  grid.sync();
  PHASE_MARK(1);

  // 1. Standalone ladder (merged with the exists ladder), id groups, winners.
  for (int64_t i = lo; i < hi; ++i) {
    const uint32_t c = V::standalone(P, i, count, batch_ts);
    a.codes[i] = c;
    const int h = batch_hash_insert(
        hkey, (int)a.hsize, static_cast<const uint64_t*>(P.p[V::ID_LO]),
        static_cast<const uint64_t*>(P.p[V::ID_HI]), (int)i);
    grp[i] = h;
    fail[i] = 0xFFFFFFFFu;
    if (c == 0 && i < count) atomicMin(hwin + h, (unsigned)i);
  }
  grid.sync();
  PHASE_MARK(2);

  // 2. Later duplicates compare against the winner; chain-open at the end;
  //    the last chain start of each thread's lanes, scanned over the block.
  int last = -1;
  for (int64_t i = lo; i < hi; ++i) {
    uint32_t c = a.codes[i];
    const unsigned w = __ldcg(hwin + grp[i]);
    if (w < (unsigned)n && i > (int64_t)w && c == 0)
      c = V::exists_vs_lane(P, i, w);
    if (i == count - 1 && linked(i)) c = 2;
    a.codes[i] = c;
    if (starts(i)) last = (int)i;
  }
  int excl, total;
  block_max_scan(last, s_warps, &excl, &total);
  if (threadIdx.x == 0) blk[blockIdx.x] = total;
  grid.sync();
  PHASE_MARK(3);

  // 3. Each lane's chain start (the last start before this block, then the
  //    block's own scan); each chain's first failure.
  int pre = -1;
  for (int b = threadIdx.x; b < (int)blockIdx.x; b += blockDim.x) {
    const int m = __ldcg(blk + b);
    if (m > pre) pre = m;
  }
  int pre_excl, pre_all;
  block_max_scan(pre, s_warps, &pre_excl, &pre_all);
  int cur = pre_all > excl ? pre_all : excl;
  for (int64_t i = lo; i < hi; ++i) {
    if (starts(i)) cur = (int)i;
    cstart[i] = cur;
    if ((linked(i) || linked(i - 1)) && a.codes[i] != 0)
      atomicMin(fail + cur, (unsigned)i);
  }
  grid.sync();
  PHASE_MARK(4);

  // 4. The first failure of each chain rolls the chain back.
  for (int64_t i = lo; i < hi; ++i) {
    const uint32_t co = a.codes[i];
    const bool lk = linked(i);
    uint32_t out = co;
    if (lk || linked(i - 1)) {
      const unsigned f = __ldcg(fail + cstart[i]);
      if (f < (unsigned)n) {
        if (i < (int64_t)f) out = 1;
        else if (i == (int64_t)f) out = co;
        else out = (i == count - 1 && lk) ? 2 : 1;
      }
    }
    a.codes[i] = out;
    a.ok[i] = (out == 0 && i < count) ? 1 : 0;
  }
  PHASE_MARK(5);
}

PHASE_CLOCK_ENTRIES(tb_validate_phases)

// Blocks the card holds at once of variant V's kernel.
template <class V>
static int validate_resident(int* resident) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, validate_kernel<V>, VALIDATE_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    cached = sms * per_sm;
  }
  *resident = cached;
  return 0;
}

template <class V>
static int launch_validate(VArgs& a, int64_t blocks, void* stream) {
  if (blocks <= 0) {
    int resident = 0;
    const int err = validate_resident<V>(&resident);
    if (err) return err;
    blocks = (a.n + VALIDATE_THREADS - 1) / VALIDATE_THREADS;
    if (blocks > resident) blocks = resident;
    if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  if (blocks > a.hsize) return (int)cudaErrorInvalidValue;  // the summaries
  const int64_t threads = blocks * VALIDATE_THREADS;
  a.per = (a.n + threads - 1) / threads;
  void* args[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)validate_kernel<V>, dim3((unsigned)blocks),
      dim3(VALIDATE_THREADS), args, 0, (cudaStream_t)stream);
  // A refused launch leaves its error as the thread's last error too:
  // clear it, so that the next kernel's check does not report it.
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

static int launch(int variant, int nptrs, const void* const* ptrs, int64_t n,
                  int64_t count, uint64_t batch_ts, const void* count_word,
                  const void* ts_word, void* codes, void* ok, void* scratch,
                  int64_t hsize, int64_t blocks, void* stream) {
  const int want = variant == 0 ? (int)A_NPTRS : (int)T_NPTRS;
  if (nptrs != want || n > INT_MAX / 2 || hsize < 2 * n ||
      (hsize & (hsize - 1)))
    return (int)cudaErrorInvalidValue;
  VArgs a;
  int err = pack_ptrs(&a.P, nptrs, ptrs);
  if (err) return err;
  if (n == 0) return 0;
  a.n = n;
  a.count = count;
  a.batch_ts = batch_ts;
  a.count_word = (const uint64_t*)count_word;
  a.ts_word = (const uint64_t*)ts_word;
  a.codes = (uint32_t*)codes;
  a.ok = (uint8_t*)ok;
  a.scratch = (int*)scratch;
  a.hsize = hsize;
  return variant == 0 ? launch_validate<Accounts>(a, blocks, stream)
                      : launch_validate<Transfers>(a, blocks, stream);
}

// `blocks`: the cooperative launch's blocks; 0 takes one a 128 lanes, at
// most what the card holds at once (more than that fails the launch).
extern "C" int tb_validate_accounts(int nptrs, const void* const* ptrs, int64_t n,
                                    int64_t count, void* codes, void* ok,
                                    void* scratch, int64_t hsize,
                                    int64_t blocks, void* stream) {
  return launch(0, nptrs, ptrs, n, count, 0, nullptr, nullptr, codes, ok,
                scratch, hsize, blocks, stream);
}

// `count_word` and `ts_word`, when not null, are u64 device words the
// batch's count and timestamp are read from when the kernel runs (the
// grouped commit's CUDA graph).
extern "C" int tb_validate_transfers(int nptrs, const void* const* ptrs,
                                     int64_t n, int64_t count,
                                     uint64_t batch_ts, const void* count_word,
                                     const void* ts_word, void* codes,
                                     void* ok, void* scratch, int64_t hsize,
                                     int64_t blocks, void* stream) {
  return launch(1, nptrs, ptrs, n, count, batch_ts, count_word, ts_word, codes,
                ok, scratch, hsize, blocks, stream);
}
