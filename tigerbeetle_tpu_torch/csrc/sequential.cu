// K6 seq_transfers and K7 seq_accounts: the sequential commit path, one
// launch per batch.
//
// Replaces tigerbeetle_tpu/ops/scan_path.py:187 `create_transfers_seq` (with
// :307 `_transfer_logic`, :552 `_apply_transfer`, :629
// `_exists_transfer_scalar`, :649 `_exists_postvoid_scalar`) and :690
// `create_accounts_seq` (with :762 `_account_logic`), and the helpers they
// use: :79 `_slookup`, :85 `_sprobe_free`, :143 `_tombstone` and
// ops/state_machine.py `_chain_codes`.
//
// The semantics are serial: every event sees the writes of the events
// before it (a post of a pending transfer made earlier in the batch, an id
// re-used after a rollback).  So one thread runs the whole batch in event
// order, exactly as the JAX lax.scan does:
//  - the event's probes and row gathers (accounts by debit and credit id,
//    transfers by id and by pending id, posted by the pending's timestamp);
//  - the precedence ladders in the JAX order (regular path, post/void path,
//    then the execute-level preemptions 3, 1, 2, 0);
//  - the apply: both balance legs, the transfer row at the first truly
//    empty slot of its probe (key 0 and no tombstone; tombstones are never
//    reused), the posted row, the history row, and an undo record;
//  - on the first failure in a linked chain, the chain's undo records in
//    reverse, credit leg before debit leg: balances restored, inserts
//    tombstoned (tombstone.cuh, shared with K8), history rows popped (count
//    only: the row stays in the array);
//  - after the loop, the chain-code pass of _chain_codes over the raw codes.
// u128 values are `unsigned __int128`: wrapping adds for balances, carry-out
// for the overflow codes 47-52, saturating subtraction and min for the
// balancing clamps.  u32 fields are widened without sign extension; the
// timeout sums (code 53 and expiry) wrap in u64 as in JAX.  A probe for a
// free slot stops after MAX_PROBE (1 << 12) steps; JAX then writes at slot
// 0, and so does this kernel, but it also sets the `overflow` word, which
// the machine reads with the codes and raises on.
//
// What bounds it on the H100: latency.  The bytes are small (a few hundred
// per event), but each event is a chain of dependent reads: the event's
// columns, then each probe step (home slot, then the next while the slot
// holds another key), then the row gathers, then the writes the next event
// may read.  With L2 hits at ~0.2-0.3 us and device-memory misses at
// ~0.5-0.8 us, 8-10 dependent reads per event give 15-60 ms per 8,190-event
// batch.  The design takes the simplest form that is right (one thread, no
// cross-thread ordering to get wrong); overlapping the independent probes of
// one event, or prefetching the next event, is later work.
#include "common.cuh"
#include "tombstone.cuh"

#define SEQ_MAX_PROBE 4096  // ops/state_machine.py MAX_PROBE
#define SEQ_SENT (1ull << 63)
#define NS_PER_S 1000000000ull
#define UNDO_WORDS 21  // acc slots 2, old balances 2 x 8, tr, posted, hist

typedef unsigned __int128 u128;

// Column orders (must match tigerbeetle_tpu_torch/ops/state_machine.py
// TRANSFER_BATCH_COLS, ACCOUNT_BATCH_COLS, ACCOUNT_COLS, TRANSFER_COLS and
// HISTORY_COLS; a CPU test compares the names).
enum SeqTransferBatchCol {
  TB_ID_LO, TB_ID_HI, TB_DEBIT_ACCOUNT_ID_LO, TB_DEBIT_ACCOUNT_ID_HI,
  TB_CREDIT_ACCOUNT_ID_LO, TB_CREDIT_ACCOUNT_ID_HI, TB_AMOUNT_LO, TB_AMOUNT_HI,
  TB_PENDING_ID_LO, TB_PENDING_ID_HI, TB_USER_DATA_128_LO, TB_USER_DATA_128_HI,
  TB_USER_DATA_64, TB_USER_DATA_32, TB_TIMEOUT, TB_LEDGER, TB_CODE, TB_FLAGS,
  TB_TIMESTAMP,
  TB_N
};

enum SeqAccountBatchCol {
  AB_ID_LO, AB_ID_HI, AB_DEBITS_PENDING_LO, AB_DEBITS_PENDING_HI,
  AB_DEBITS_POSTED_LO, AB_DEBITS_POSTED_HI, AB_CREDITS_PENDING_LO,
  AB_CREDITS_PENDING_HI, AB_CREDITS_POSTED_LO, AB_CREDITS_POSTED_HI,
  AB_USER_DATA_128_LO, AB_USER_DATA_128_HI, AB_USER_DATA_64, AB_USER_DATA_32,
  AB_RESERVED, AB_LEDGER, AB_CODE, AB_FLAGS, AB_TIMESTAMP,
  AB_N
};

enum AccountTableCol {
  AT_DEBITS_PENDING_LO, AT_DEBITS_PENDING_HI, AT_DEBITS_POSTED_LO,
  AT_DEBITS_POSTED_HI, AT_CREDITS_PENDING_LO, AT_CREDITS_PENDING_HI,
  AT_CREDITS_POSTED_LO, AT_CREDITS_POSTED_HI, AT_USER_DATA_128_LO,
  AT_USER_DATA_128_HI, AT_USER_DATA_64, AT_USER_DATA_32, AT_LEDGER, AT_CODE,
  AT_FLAGS, AT_TIMESTAMP,
  AT_N
};

enum TransferTableCol {
  TT_DEBIT_ACCOUNT_ID_LO, TT_DEBIT_ACCOUNT_ID_HI, TT_CREDIT_ACCOUNT_ID_LO,
  TT_CREDIT_ACCOUNT_ID_HI, TT_AMOUNT_LO, TT_AMOUNT_HI, TT_PENDING_ID_LO,
  TT_PENDING_ID_HI, TT_USER_DATA_128_LO, TT_USER_DATA_128_HI, TT_USER_DATA_64,
  TT_USER_DATA_32, TT_TIMEOUT, TT_LEDGER, TT_CODE, TT_FLAGS, TT_TIMESTAMP,
  TT_N
};

enum HistoryCol {
  H_DR_ID_LO, H_DR_ID_HI, H_DR_DP_LO, H_DR_DP_HI, H_DR_DPO_LO, H_DR_DPO_HI,
  H_DR_CP_LO, H_DR_CP_HI, H_DR_CPO_LO, H_DR_CPO_HI,
  H_CR_ID_LO, H_CR_ID_HI, H_CR_DP_LO, H_CR_DP_HI, H_CR_DPO_LO, H_CR_DPO_HI,
  H_CR_CP_LO, H_CR_CP_HI, H_CR_CPO_LO, H_CR_CPO_HI,
  H_TIMESTAMP,
  H_N
};

// Account flags (tigerbeetle.zig:42-57) and transfer flags (:107-120).
#define AF_LINKED 1u
#define AF_DEBITS_MUST_NOT_EXCEED_CREDITS 2u
#define AF_CREDITS_MUST_NOT_EXCEED_DEBITS 4u
#define AF_HISTORY 8u
#define AF_PADDING 0xFFF0u
#define TF_LINKED 1u
#define TF_PENDING 2u
#define TF_POST 4u
#define TF_VOID 8u
#define TF_BALANCING_DEBIT 16u
#define TF_BALANCING_CREDIT 32u
#define TF_PADDING 0xFFC0u

// One hash table: keys, tombstones, count, and its value columns in the
// order of the table's enum above.
struct DevTable {
  uint64_t* key_lo;
  uint64_t* key_hi;
  uint8_t* tomb;
  long long* count;
  uint64_t mask;  // capacity - 1
  void* col[TB_MAX_COLS];
};

#define C64(T, k) (static_cast<uint64_t*>((T).col[k]))
#define C32(T, k) (static_cast<uint32_t*>((T).col[k]))

static __device__ __forceinline__ u128 mk128(uint64_t lo, uint64_t hi) {
  return ((u128)hi << 64) | lo;
}
static __device__ __forceinline__ uint64_t lo64(u128 x) { return (uint64_t)x; }
static __device__ __forceinline__ uint64_t hi64(u128 x) {
  return (uint64_t)(x >> 64);
}
static __device__ __forceinline__ bool add_overflows(u128 a, u128 b) {
  return a + b < a;
}
static __device__ __forceinline__ u128 sub_saturate(u128 a, u128 b) {
  return a > b ? a - b : (u128)0;
}
static __device__ __forceinline__ u128 min128(u128 a, u128 b) {
  return a <= b ? a : b;
}
#define U128_MAX (~(u128)0)

// _slookup (ht.lookup with MAX_PROBE) fused with _sprobe_free: walks the
// key's probe sequence skipping tombstones.  Returns whether the key was
// found (then *slot is its slot); otherwise *slot is 0 and *free_slot the
// first truly empty slot, or 0 with *capped set when MAX_PROBE steps found
// none.  The key 0 is never found (lookup resolves it at once); its free
// slot is still the first empty one, as _sprobe_free gives.
static __device__ bool probe_key(const DevTable& T, uint64_t lo, uint64_t hi,
                                 uint64_t* slot, uint64_t* free_slot,
                                 bool* capped) {
  const bool null = lo == 0 && hi == 0;
  const uint64_t home = mix64(lo, hi) & T.mask;
  *slot = 0;
  *free_slot = 0;
  *capped = false;
  for (int t = 0; t < SEQ_MAX_PROBE; ++t) {
    const uint64_t cur = (home + (uint64_t)t) & T.mask;
    if (T.tomb[cur]) continue;
    const uint64_t a = T.key_lo[cur], b = T.key_hi[cur];
    if (a == 0 && b == 0) {
      *free_slot = cur;
      return false;
    }
    if (!null && a == lo && b == hi) {
      *slot = cur;
      return true;
    }
  }
  *capped = true;
  return false;
}

// _sprobe_free alone (for a key that is present and is inserted again,
// which only a posted row whose fulfillment is neither 1 nor 2 allows).
static __device__ uint64_t sprobe_free(const DevTable& T, uint64_t lo,
                                       uint64_t hi, bool* capped) {
  const uint64_t home = mix64(lo, hi) & T.mask;
  *capped = false;
  for (int t = 0; t < SEQ_MAX_PROBE; ++t) {
    const uint64_t cur = (home + (uint64_t)t) & T.mask;
    if (!T.tomb[cur] && T.key_lo[cur] == 0 && T.key_hi[cur] == 0) return cur;
  }
  *capped = true;
  return 0;
}

// _set_row's key part: the key, no tombstone, count + 1 (the columns are
// written by the caller).
static __device__ __forceinline__ void set_key(const DevTable& T,
                                               uint64_t slot, uint64_t lo,
                                               uint64_t hi) {
  T.key_lo[slot] = lo;
  T.key_hi[slot] = hi;
  T.tomb[slot] = 0;
  *T.count += 1;
}

static __device__ __forceinline__ void tombstone_row(const DevTable& T,
                                                     uint64_t slot) {
  tombstone_slot(T.key_lo, T.key_hi, T.tomb, slot);
  *T.count -= 1;
}

struct Bal {
  u128 dp, dpo, cp, cpo;
};

static __device__ Bal load_bal(const DevTable& A, uint64_t slot, bool valid) {
  Bal b;
  if (!valid) {
    b.dp = b.dpo = b.cp = b.cpo = 0;
    return b;
  }
  b.dp = mk128(C64(A, AT_DEBITS_PENDING_LO)[slot], C64(A, AT_DEBITS_PENDING_HI)[slot]);
  b.dpo = mk128(C64(A, AT_DEBITS_POSTED_LO)[slot], C64(A, AT_DEBITS_POSTED_HI)[slot]);
  b.cp = mk128(C64(A, AT_CREDITS_PENDING_LO)[slot], C64(A, AT_CREDITS_PENDING_HI)[slot]);
  b.cpo = mk128(C64(A, AT_CREDITS_POSTED_LO)[slot], C64(A, AT_CREDITS_POSTED_HI)[slot]);
  return b;
}

// The eight balance words in BALANCE_FIELDS order (= account columns 0-7).
static __device__ __forceinline__ void bal_words(const Bal& b, uint64_t* w) {
  w[0] = lo64(b.dp);
  w[1] = hi64(b.dp);
  w[2] = lo64(b.dpo);
  w[3] = hi64(b.dpo);
  w[4] = lo64(b.cp);
  w[5] = hi64(b.cp);
  w[6] = lo64(b.cpo);
  w[7] = hi64(b.cpo);
}

static __device__ __forceinline__ void store_words(const DevTable& A,
                                                   uint64_t slot,
                                                   const uint64_t* w) {
  for (int k = 0; k < 8; ++k) C64(A, AT_DEBITS_PENDING_LO + k)[slot] = w[k];
}

// ops/state_machine.py _chain_codes over the raw codes, in place, one pass
// per chain: a chain runs from a linked lane whose predecessor is not
// linked to the first unlinked lane after it.  Its first failing lane keeps
// its code; lanes before it get 1; lanes after it get 1, or 2 for a linked
// batch-final lane (which also gets 2 where the chain did not fail).
static __device__ void chain_codes(int32_t* codes, const uint32_t* flags,
                                   uint32_t linked_bit, int64_t n,
                                   int64_t count) {
  auto linked = [&](int64_t i) {
    return i < count && (flags[i] & linked_bit) != 0;
  };
  auto code_o = [&](int64_t i) {
    return (i == count - 1 && linked(i)) ? 2 : codes[i];
  };
  int64_t i = 0;
  while (i < n) {
    if (!linked(i)) {
      ++i;
      continue;
    }
    const int64_t s = i;
    int64_t e = s;
    while (e < n - 1 && linked(e)) ++e;
    int64_t f = -1;
    for (int64_t j = s; j <= e && f < 0; ++j)
      if (code_o(j) != 0) f = j;
    for (int64_t j = s; j <= e; ++j) {
      if (f < 0 || j == f) {
        codes[j] = code_o(j);
      } else if (j < f) {
        codes[j] = 1;
      } else {
        codes[j] = (j == count - 1 && linked(j)) ? 2 : 1;
      }
    }
    i = e + 1;
  }
}

// ---------------------------------------------------------------------------
// K6 seq_transfers
// ---------------------------------------------------------------------------

struct SeqTransferArgs {
  const void* batch[TB_N];
  DevTable acc, xfr, pst;
  uint64_t* hist[H_N];
  long long* hist_count;
  int64_t hist_cap;
  int64_t n, count;
  uint64_t timestamp;
  uint64_t* undo;  // n records of UNDO_WORDS
  int32_t* codes;
  int* overflow;
};

#define EV64(k) (static_cast<const uint64_t*>(A.batch[k])[i])
#define EV32(k) (static_cast<const uint32_t*>(A.batch[k])[i])

__global__ void seq_transfers_kernel(SeqTransferArgs A) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  const uint64_t ts_base = A.timestamp - (uint64_t)A.count + 1;
  int64_t chain_start = -1;
  bool chain_broken = false;
  for (int64_t i = 0; i < A.n; ++i) {
    uint64_t* undo = A.undo + i * UNDO_WORDS;
    undo[0] = undo[1] = undo[18] = undo[19] = SEQ_SENT;
    undo[20] = 0;
    const bool active = i < A.count;
    const uint32_t flags = EV32(TB_FLAGS);
    const bool linked = active && (flags & TF_LINKED);
    if (linked && chain_start < 0) chain_start = i;  // state_machine.zig:1022
    const bool in_chain = chain_start >= 0;
    const bool chain_open_err = linked && i == A.count - 1;
    const uint64_t ev_ts = ts_base + (uint64_t)i;

    // execute()-level preemptions (state_machine.zig:1021-1041): where one
    // fires, the logic's code is discarded and nothing is applied.
    uint32_t code = 0;
    if (active) {
      if (chain_open_err) code = 2;
      else if (chain_broken) code = 1;
      else if (EV64(TB_TIMESTAMP) != 0) code = 3;
    }
    if (active && code == 0) {
      // -- _transfer_logic ---------------------------------------------------
      const uint64_t tid_lo = EV64(TB_ID_LO), tid_hi = EV64(TB_ID_HI);
      const u128 tid = mk128(tid_lo, tid_hi);
      const bool post = flags & TF_POST, void_ = flags & TF_VOID;
      const bool postvoid = post || void_;
      const bool pending_f = flags & TF_PENDING;
      const bool bal_dr = flags & TF_BALANCING_DEBIT;
      const bool bal_cr = flags & TF_BALANCING_CREDIT;
      const u128 t_amount = mk128(EV64(TB_AMOUNT_LO), EV64(TB_AMOUNT_HI));
      const uint64_t pend_lo = EV64(TB_PENDING_ID_LO), pend_hi = EV64(TB_PENDING_ID_HI);
      const u128 pend_id = mk128(pend_lo, pend_hi);
      const u128 t_dr_id = mk128(EV64(TB_DEBIT_ACCOUNT_ID_LO), EV64(TB_DEBIT_ACCOUNT_ID_HI));
      const u128 t_cr_id = mk128(EV64(TB_CREDIT_ACCOUNT_ID_LO), EV64(TB_CREDIT_ACCOUNT_ID_HI));
      const uint32_t ev_timeout = EV32(TB_TIMEOUT), ev_ledger = EV32(TB_LEDGER);
      const uint32_t ev_code = EV32(TB_CODE);
      const uint64_t ev_ud128_lo = EV64(TB_USER_DATA_128_LO), ev_ud128_hi = EV64(TB_USER_DATA_128_HI);
      const uint64_t ev_ud64 = EV64(TB_USER_DATA_64);
      const uint32_t ev_ud32 = EV32(TB_USER_DATA_32);
      uint64_t scratch;
      bool scratch_capped;

      // Pending transfer (post/void only; the regular path never reads it).
      uint64_t p_slot = 0;
      const bool p_found = postvoid && probe_key(A.xfr, pend_lo, pend_hi, &p_slot,
                                                 &scratch, &scratch_capped);
      uint32_t p_flags = 0, p_timeout = 0, p_ledger = 0, p_code = 0, p_ud32 = 0;
      uint64_t p_ts = 0, p_ud64 = 0, p_ud128_lo = 0, p_ud128_hi = 0;
      u128 p_amount = 0, p_dr_id = 0, p_cr_id = 0;
      if (p_found) {
        const DevTable& X = A.xfr;
        p_flags = C32(X, TT_FLAGS)[p_slot];
        p_timeout = C32(X, TT_TIMEOUT)[p_slot];
        p_ledger = C32(X, TT_LEDGER)[p_slot];
        p_code = C32(X, TT_CODE)[p_slot];
        p_ud32 = C32(X, TT_USER_DATA_32)[p_slot];
        p_ts = C64(X, TT_TIMESTAMP)[p_slot];
        p_ud64 = C64(X, TT_USER_DATA_64)[p_slot];
        p_ud128_lo = C64(X, TT_USER_DATA_128_LO)[p_slot];
        p_ud128_hi = C64(X, TT_USER_DATA_128_HI)[p_slot];
        p_amount = mk128(C64(X, TT_AMOUNT_LO)[p_slot], C64(X, TT_AMOUNT_HI)[p_slot]);
        p_dr_id = mk128(C64(X, TT_DEBIT_ACCOUNT_ID_LO)[p_slot], C64(X, TT_DEBIT_ACCOUNT_ID_HI)[p_slot]);
        p_cr_id = mk128(C64(X, TT_CREDIT_ACCOUNT_ID_LO)[p_slot], C64(X, TT_CREDIT_ACCOUNT_ID_HI)[p_slot]);
      }
      const bool p_is_pending = p_flags & TF_PENDING;

      // The accounts operated on.
      const u128 dr_id = postvoid ? p_dr_id : t_dr_id;
      const u128 cr_id = postvoid ? p_cr_id : t_cr_id;
      uint64_t dr_slot, cr_slot;
      const bool dr_found = probe_key(A.acc, lo64(dr_id), hi64(dr_id), &dr_slot,
                                      &scratch, &scratch_capped);
      const bool cr_found = probe_key(A.acc, lo64(cr_id), hi64(cr_id), &cr_slot,
                                      &scratch, &scratch_capped);
      const Bal drb = load_bal(A.acc, dr_slot, dr_found);
      const Bal crb = load_bal(A.acc, cr_slot, cr_found);
      const uint32_t dr_flags = dr_found ? C32(A.acc, AT_FLAGS)[dr_slot] : 0;
      const uint32_t cr_flags = cr_found ? C32(A.acc, AT_FLAGS)[cr_slot] : 0;
      const uint32_t dr_ledger = dr_found ? C32(A.acc, AT_LEDGER)[dr_slot] : 0;
      const uint32_t cr_ledger = cr_found ? C32(A.acc, AT_LEDGER)[cr_slot] : 0;

      // Existing transfer with our id; its free slot is the insert slot.
      uint64_t e_slot, t_free;
      bool t_capped;
      const bool e_found = probe_key(A.xfr, tid_lo, tid_hi, &e_slot, &t_free, &t_capped);

      // Posted groove, keyed by the pending's timestamp (post/void only).
      uint64_t posted_slot = 0, posted_free = 0;
      bool posted_capped = false;
      const bool posted_found =
          postvoid && probe_key(A.pst, p_ts, 0, &posted_slot, &posted_free, &posted_capped);
      const uint32_t posted_val = posted_found ? C32(A.pst, 0)[posted_slot] : 0;

      // -- regular path (state_machine.zig:1239-1368) -----------------------
      const u128 amount0 = ((bal_dr || bal_cr) && t_amount == 0) ? (u128)~0ull : t_amount;
      const u128 avail_dr = sub_saturate(drb.cpo, drb.dpo + drb.dp);
      const u128 amount1 = bal_dr ? min128(amount0, avail_dr) : amount0;
      const bool exceeds_credits_bal = bal_dr && amount1 == 0;
      const u128 avail_cr = sub_saturate(crb.dpo, crb.cpo + crb.cp);
      const u128 amount = bal_cr ? min128(amount1, avail_cr) : amount1;
      const bool exceeds_debits_bal = bal_cr && !exceeds_credits_bal && amount == 0;

      const u128 dr_total = drb.dp + drb.dpo;
      const u128 cr_total = crb.cp + crb.cpo;
      const uint64_t ts_sum = ev_ts + (uint64_t)ev_timeout * NS_PER_S;
      const bool exceeds_credits_lim =
          (dr_flags & AF_DEBITS_MUST_NOT_EXCEED_CREDITS) && dr_total + amount > drb.cpo;
      const bool exceeds_debits_lim =
          (cr_flags & AF_CREDITS_MUST_NOT_EXCEED_DEBITS) && cr_total + amount > crb.dpo;

      uint32_t c;
      if (!postvoid) {
        if (flags & TF_PADDING) c = 4;
        else if (tid == 0) c = 5;
        else if (tid == U128_MAX) c = 6;
        else if (t_dr_id == 0) c = 8;
        else if (t_dr_id == U128_MAX) c = 9;
        else if (t_cr_id == 0) c = 10;
        else if (t_cr_id == U128_MAX) c = 11;
        else if (t_dr_id == t_cr_id) c = 12;
        else if (pend_id != 0) c = 13;
        else if (!pending_f && ev_timeout != 0) c = 17;
        else if (!bal_dr && !bal_cr && t_amount == 0) c = 18;
        else if (ev_ledger == 0) c = 19;
        else if (ev_code == 0) c = 20;
        else if (!dr_found) c = 21;
        else if (!cr_found) c = 22;
        else if (dr_ledger != cr_ledger) c = 23;
        else if (ev_ledger != dr_ledger) c = 24;
        else if (e_found) {
          // create_transfer_exists (state_machine.zig:1370-1389).
          const DevTable& X = A.xfr;
          const uint64_t s = e_slot;
          if (flags != C32(X, TT_FLAGS)[s]) c = 36;
          else if (t_dr_id != mk128(C64(X, TT_DEBIT_ACCOUNT_ID_LO)[s], C64(X, TT_DEBIT_ACCOUNT_ID_HI)[s])) c = 37;
          else if (t_cr_id != mk128(C64(X, TT_CREDIT_ACCOUNT_ID_LO)[s], C64(X, TT_CREDIT_ACCOUNT_ID_HI)[s])) c = 38;
          else if (t_amount != mk128(C64(X, TT_AMOUNT_LO)[s], C64(X, TT_AMOUNT_HI)[s])) c = 39;
          else if (pend_id != mk128(C64(X, TT_PENDING_ID_LO)[s], C64(X, TT_PENDING_ID_HI)[s])) c = 40;
          else if (ev_ud128_lo != C64(X, TT_USER_DATA_128_LO)[s] || ev_ud128_hi != C64(X, TT_USER_DATA_128_HI)[s]) c = 41;
          else if (ev_ud64 != C64(X, TT_USER_DATA_64)[s]) c = 42;
          else if (ev_ud32 != C32(X, TT_USER_DATA_32)[s]) c = 43;
          else if (ev_timeout != C32(X, TT_TIMEOUT)[s]) c = 44;
          else if (ev_code != C32(X, TT_CODE)[s]) c = 45;
          else c = 46;
        }
        else if (exceeds_credits_bal) c = 54;
        else if (exceeds_debits_bal) c = 55;
        else if (pending_f && add_overflows(amount, drb.dp)) c = 47;
        else if (pending_f && add_overflows(amount, crb.cp)) c = 48;
        else if (add_overflows(amount, drb.dpo)) c = 49;
        else if (add_overflows(amount, crb.cpo)) c = 50;
        else if (add_overflows(amount, dr_total)) c = 51;
        else if (add_overflows(amount, cr_total)) c = 52;
        else if (ts_sum < ev_ts) c = 53;
        else if (exceeds_credits_lim) c = 54;
        else if (exceeds_debits_lim) c = 55;
        else c = 0;
      } else {
        // -- post/void path (state_machine.zig:1391-1498) -------------------
        const u128 pv_amount = t_amount != 0 ? t_amount : p_amount;
        const uint64_t expiry_ns = (uint64_t)p_timeout * NS_PER_S;
        const bool expired = p_timeout != 0 && ev_ts >= p_ts + expiry_ns;
        if (flags & TF_PADDING) c = 4;
        else if (tid == 0) c = 5;
        else if (tid == U128_MAX) c = 6;
        else if (post && void_) c = 7;
        else if (pending_f || bal_dr || bal_cr) c = 7;
        else if (pend_id == 0) c = 14;
        else if (pend_id == U128_MAX) c = 15;
        else if (pend_id == tid) c = 16;
        else if (ev_timeout != 0) c = 17;
        else if (!p_found) c = 25;
        else if (!p_is_pending) c = 26;
        else if (t_dr_id != 0 && t_dr_id != p_dr_id) c = 27;
        else if (t_cr_id != 0 && t_cr_id != p_cr_id) c = 28;
        else if (ev_ledger != 0 && ev_ledger != p_ledger) c = 29;
        else if (ev_code != 0 && ev_code != p_code) c = 30;
        else if (pv_amount > p_amount) c = 31;
        else if (void_ && pv_amount < p_amount) c = 32;
        else if (e_found) {
          // post_or_void_pending_transfer_exists (state_machine.zig:1500-1561):
          // a zero field of the event compares the stored row with the
          // pending transfer instead.
          const DevTable& X = A.xfr;
          const uint64_t s = e_slot;
          const u128 e_amount = mk128(C64(X, TT_AMOUNT_LO)[s], C64(X, TT_AMOUNT_HI)[s]);
          const uint64_t e_ud128_lo = C64(X, TT_USER_DATA_128_LO)[s];
          const uint64_t e_ud128_hi = C64(X, TT_USER_DATA_128_HI)[s];
          const uint64_t e_ud64 = C64(X, TT_USER_DATA_64)[s];
          const uint32_t e_ud32 = C32(X, TT_USER_DATA_32)[s];
          const bool amount_ne = t_amount == 0 ? e_amount != p_amount : t_amount != e_amount;
          const bool ud128_ne = (ev_ud128_lo == 0 && ev_ud128_hi == 0)
                                    ? (e_ud128_lo != p_ud128_lo || e_ud128_hi != p_ud128_hi)
                                    : (ev_ud128_lo != e_ud128_lo || ev_ud128_hi != e_ud128_hi);
          const bool ud64_ne = ev_ud64 == 0 ? e_ud64 != p_ud64 : ev_ud64 != e_ud64;
          const bool ud32_ne = ev_ud32 == 0 ? e_ud32 != p_ud32 : ev_ud32 != e_ud32;
          if (flags != C32(X, TT_FLAGS)[s]) c = 36;
          else if (amount_ne) c = 39;
          else if (pend_id != mk128(C64(X, TT_PENDING_ID_LO)[s], C64(X, TT_PENDING_ID_HI)[s])) c = 40;
          else if (ud128_ne) c = 41;
          else if (ud64_ne) c = 42;
          else if (ud32_ne) c = 43;
          else c = 46;
        }
        else if (posted_found && posted_val == 1) c = 33;
        else if (posted_found && posted_val == 2) c = 34;
        else if (expired) c = 35;
        else c = 0;
      }
      code = c;

      // -- _apply_transfer -------------------------------------------------
      if (c == 0) {
        const u128 pv_amount = t_amount != 0 ? t_amount : p_amount;
        const u128 eff = postvoid ? pv_amount : amount;
        Bal ndr = drb, ncr = crb;
        if (postvoid) {
          // Release pending; a post adds posted (state_machine.zig:1481-1491).
          const u128 posted_amt = post ? eff : (u128)0;
          ndr.dp = drb.dp - p_amount;
          ndr.dpo = drb.dpo + posted_amt;
          ncr.cp = crb.cp - p_amount;
          ncr.cpo = crb.cpo + posted_amt;
        } else if (pending_f) {
          ndr.dp = drb.dp + eff;
          ncr.cp = crb.cp + eff;
        } else {
          ndr.dpo = drb.dpo + eff;
          ncr.cpo = crb.cpo + eff;
        }
        uint64_t w[8];
        undo[0] = dr_slot;
        undo[1] = cr_slot;
        bal_words(drb, undo + 2);
        bal_words(crb, undo + 10);
        bal_words(ndr, w);
        store_words(A.acc, dr_slot, w);
        uint64_t wc[8];
        bal_words(ncr, wc);
        store_words(A.acc, cr_slot, wc);

        // Transfer insert at the first truly empty slot of its probe.
        const uint64_t t_slot = t_capped ? 0 : t_free;
        if (t_capped) *A.overflow = 1;
        {
          const DevTable& X = A.xfr;
          const uint64_t s = t_slot;
          const u128 row_dr = postvoid ? p_dr_id : t_dr_id;
          const u128 row_cr = postvoid ? p_cr_id : t_cr_id;
          const bool ud128_zero = ev_ud128_lo == 0 && ev_ud128_hi == 0;
          C64(X, TT_DEBIT_ACCOUNT_ID_LO)[s] = lo64(row_dr);
          C64(X, TT_DEBIT_ACCOUNT_ID_HI)[s] = hi64(row_dr);
          C64(X, TT_CREDIT_ACCOUNT_ID_LO)[s] = lo64(row_cr);
          C64(X, TT_CREDIT_ACCOUNT_ID_HI)[s] = hi64(row_cr);
          C64(X, TT_AMOUNT_LO)[s] = lo64(eff);
          C64(X, TT_AMOUNT_HI)[s] = hi64(eff);
          C64(X, TT_PENDING_ID_LO)[s] = pend_lo;
          C64(X, TT_PENDING_ID_HI)[s] = pend_hi;
          C64(X, TT_USER_DATA_128_LO)[s] = (postvoid && ud128_zero) ? p_ud128_lo : ev_ud128_lo;
          C64(X, TT_USER_DATA_128_HI)[s] = (postvoid && ud128_zero) ? p_ud128_hi : ev_ud128_hi;
          C64(X, TT_USER_DATA_64)[s] = (postvoid && ev_ud64 == 0) ? p_ud64 : ev_ud64;
          C32(X, TT_USER_DATA_32)[s] = (postvoid && ev_ud32 == 0) ? p_ud32 : ev_ud32;
          C32(X, TT_TIMEOUT)[s] = postvoid ? 0u : ev_timeout;
          C32(X, TT_LEDGER)[s] = postvoid ? p_ledger : ev_ledger;
          C32(X, TT_CODE)[s] = postvoid ? p_code : ev_code;
          C32(X, TT_FLAGS)[s] = flags;
          C64(X, TT_TIMESTAMP)[s] = ev_ts;
          set_key(X, s, tid_lo, tid_hi);
          undo[18] = s;
        }

        if (postvoid) {
          bool capped = posted_capped;
          uint64_t s = posted_free;
          if (posted_found) s = sprobe_free(A.pst, p_ts, 0, &capped);
          if (capped) {
            s = 0;
            *A.overflow = 1;
          }
          C32(A.pst, 0)[s] = post ? 1u : 2u;
          set_key(A.pst, s, p_ts, 0);
          undo[19] = s;
        } else if ((dr_flags & AF_HISTORY) || (cr_flags & AF_HISTORY)) {
          // History append (state_machine.zig:1342-1364): a side without
          // the flag stays zero.  The host grows the log first; a row past
          // the capacity would be dropped while count still advances.
          const long long h = *A.hist_count;
          if (h < A.hist_cap) {
            const bool on[2] = {(dr_flags & AF_HISTORY) != 0, (cr_flags & AF_HISTORY) != 0};
            const u128 ids[2] = {dr_id, cr_id};
            const uint64_t* words[2] = {w, wc};
            for (int side = 0; side < 2; ++side) {
              const int base = side * 10;
              A.hist[base + 0][h] = on[side] ? lo64(ids[side]) : 0;
              A.hist[base + 1][h] = on[side] ? hi64(ids[side]) : 0;
              for (int k = 0; k < 8; ++k) A.hist[base + 2 + k][h] = on[side] ? words[side][k] : 0;
            }
            A.hist[H_TIMESTAMP][h] = ev_ts;
          }
          *A.hist_count = h + 1;
          undo[20] = 1;
        }
      }
    }
    A.codes[i] = (int32_t)code;

    // Chain break: roll back chain_start..i-1 in reverse
    // (state_machine.zig:1051-1066).
    if (active && code != 0 && in_chain && !chain_broken) {
      for (int64_t j = i - 1; j >= chain_start; --j) {
        const uint64_t* u = A.undo + j * UNDO_WORDS;
        for (int leg = 1; leg >= 0; --leg) {
          if (u[leg] < SEQ_SENT) store_words(A.acc, u[leg], u + 2 + 8 * leg);
        }
        if (u[18] < SEQ_SENT) tombstone_row(A.xfr, u[18]);
        if (u[19] < SEQ_SENT) tombstone_row(A.pst, u[19]);
        *A.hist_count -= (long long)u[20];
      }
      chain_broken = true;
    }
    // Chain termination (state_machine.zig:1074-1082).
    if (in_chain && (!linked || chain_open_err)) {
      chain_start = -1;
      chain_broken = false;
    }
  }
  chain_codes(A.codes, static_cast<const uint32_t*>(A.batch[TB_FLAGS]),
              TF_LINKED, A.n, A.count);
}

// ---------------------------------------------------------------------------
// K7 seq_accounts
// ---------------------------------------------------------------------------

struct SeqAccountArgs {
  const void* batch[AB_N];
  DevTable acc;
  int64_t n, count;
  uint64_t timestamp;
  uint64_t* undo;  // n inserted slots
  int32_t* codes;
  int* overflow;
};

__global__ void seq_accounts_kernel(SeqAccountArgs A) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  const uint64_t ts_base = A.timestamp - (uint64_t)A.count + 1;
  int64_t chain_start = -1;
  bool chain_broken = false;
  for (int64_t i = 0; i < A.n; ++i) {
    A.undo[i] = SEQ_SENT;
    const bool active = i < A.count;
    const uint32_t flags = EV32(AB_FLAGS);
    const bool linked = active && (flags & AF_LINKED);
    if (linked && chain_start < 0) chain_start = i;
    const bool in_chain = chain_start >= 0;
    const bool chain_open_err = linked && i == A.count - 1;
    const uint64_t ev_ts = ts_base + (uint64_t)i;

    uint32_t code = 0;
    if (!active) code = 0;
    else if (chain_open_err) code = 2;
    else if (chain_broken) code = 1;
    else if (EV64(AB_TIMESTAMP) != 0) code = 3;
    else {
      // _account_logic (state_machine.zig:1198-1237).
      const uint64_t id_lo = EV64(AB_ID_LO), id_hi = EV64(AB_ID_HI);
      const u128 aid = mk128(id_lo, id_hi);
      uint64_t slot, free_slot;
      bool capped;
      const bool found = probe_key(A.acc, id_lo, id_hi, &slot, &free_slot, &capped);
      const uint32_t ev_ledger = EV32(AB_LEDGER), ev_code = EV32(AB_CODE);
      const uint32_t ev_ud32 = EV32(AB_USER_DATA_32);
      const uint64_t ev_ud64 = EV64(AB_USER_DATA_64);
      const uint64_t ev_ud128_lo = EV64(AB_USER_DATA_128_LO), ev_ud128_hi = EV64(AB_USER_DATA_128_HI);
      if (EV32(AB_RESERVED) != 0) code = 4;
      else if (flags & AF_PADDING) code = 5;
      else if (aid == 0) code = 6;
      else if (aid == U128_MAX) code = 7;
      else if ((flags & AF_DEBITS_MUST_NOT_EXCEED_CREDITS) &&
               (flags & AF_CREDITS_MUST_NOT_EXCEED_DEBITS)) code = 8;
      else if (EV64(AB_DEBITS_PENDING_LO) || EV64(AB_DEBITS_PENDING_HI)) code = 9;
      else if (EV64(AB_DEBITS_POSTED_LO) || EV64(AB_DEBITS_POSTED_HI)) code = 10;
      else if (EV64(AB_CREDITS_PENDING_LO) || EV64(AB_CREDITS_PENDING_HI)) code = 11;
      else if (EV64(AB_CREDITS_POSTED_LO) || EV64(AB_CREDITS_POSTED_HI)) code = 12;
      else if (ev_ledger == 0) code = 13;
      else if (ev_code == 0) code = 14;
      else if (found) {
        const DevTable& T = A.acc;
        if (flags != C32(T, AT_FLAGS)[slot]) code = 15;
        else if (ev_ud128_lo != C64(T, AT_USER_DATA_128_LO)[slot] ||
                 ev_ud128_hi != C64(T, AT_USER_DATA_128_HI)[slot]) code = 16;
        else if (ev_ud64 != C64(T, AT_USER_DATA_64)[slot]) code = 17;
        else if (ev_ud32 != C32(T, AT_USER_DATA_32)[slot]) code = 18;
        else if (ev_ledger != C32(T, AT_LEDGER)[slot]) code = 19;
        else if (ev_code != C32(T, AT_CODE)[slot]) code = 20;
        else code = 21;
      }
      if (code == 0) {
        const DevTable& T = A.acc;
        const uint64_t s = capped ? 0 : free_slot;
        if (capped) *A.overflow = 1;
        for (int k = 0; k < 8; ++k)
          C64(T, AT_DEBITS_PENDING_LO + k)[s] = EV64(AB_DEBITS_PENDING_LO + k);
        C64(T, AT_USER_DATA_128_LO)[s] = ev_ud128_lo;
        C64(T, AT_USER_DATA_128_HI)[s] = ev_ud128_hi;
        C64(T, AT_USER_DATA_64)[s] = ev_ud64;
        C32(T, AT_USER_DATA_32)[s] = ev_ud32;
        C32(T, AT_LEDGER)[s] = ev_ledger;
        C32(T, AT_CODE)[s] = ev_code;
        C32(T, AT_FLAGS)[s] = flags;
        C64(T, AT_TIMESTAMP)[s] = ev_ts;
        set_key(T, s, id_lo, id_hi);
        A.undo[i] = s;
      }
    }
    A.codes[i] = (int32_t)code;

    if (active && code != 0 && in_chain && !chain_broken) {
      for (int64_t j = i - 1; j >= chain_start; --j)
        if (A.undo[j] < SEQ_SENT) tombstone_row(A.acc, A.undo[j]);
      chain_broken = true;
    }
    if (in_chain && (!linked || chain_open_err)) {
      chain_start = -1;
      chain_broken = false;
    }
  }
  chain_codes(A.codes, static_cast<const uint32_t*>(A.batch[AB_FLAGS]),
              AF_LINKED, A.n, A.count);
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------

// `t` lists key_lo, key_hi, tombstone, count, then `ncols` value columns.
static int pack_table(DevTable* T, const void* const* t, int nptrs, int ncols,
                      int64_t capacity) {
  if (nptrs != 4 + ncols || ncols > TB_MAX_COLS || capacity <= 0 ||
      (capacity & (capacity - 1)))
    return (int)cudaErrorInvalidValue;
  T->key_lo = (uint64_t*)t[0];
  T->key_hi = (uint64_t*)t[1];
  T->tomb = (uint8_t*)t[2];
  T->count = (long long*)t[3];
  T->mask = (uint64_t)(capacity - 1);
  for (int k = 0; k < ncols; ++k) T->col[k] = (void*)t[4 + k];
  return 0;
}

extern "C" int tb_seq_transfers(const void* const* batch, int nbatch,
                                const void* const* acc, int nacc, int64_t acc_cap,
                                const void* const* xfr, int nxfr, int64_t xfr_cap,
                                const void* const* pst, int npst, int64_t pst_cap,
                                const void* const* hist, int nhist, int64_t hist_cap,
                                int64_t n, int64_t count, uint64_t timestamp,
                                void* undo, void* codes, void* overflow,
                                void* stream) {
  SeqTransferArgs A;
  if (nbatch != TB_N || nhist != H_N + 1 || n <= 0 || count > n)
    return (int)cudaErrorInvalidValue;
  int err = pack_table(&A.acc, acc, nacc, AT_N, acc_cap);
  if (!err) err = pack_table(&A.xfr, xfr, nxfr, TT_N, xfr_cap);
  if (!err) err = pack_table(&A.pst, pst, npst, 1, pst_cap);
  if (err) return err;
  for (int k = 0; k < TB_N; ++k) A.batch[k] = batch[k];
  for (int k = 0; k < H_N; ++k) A.hist[k] = (uint64_t*)hist[k];
  A.hist_count = (long long*)hist[H_N];
  A.hist_cap = hist_cap;
  A.n = n;
  A.count = count;
  A.timestamp = timestamp;
  A.undo = (uint64_t*)undo;
  A.codes = (int32_t*)codes;
  A.overflow = (int*)overflow;
  seq_transfers_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

extern "C" int tb_seq_accounts(const void* const* batch, int nbatch,
                               const void* const* acc, int nacc, int64_t acc_cap,
                               int64_t n, int64_t count, uint64_t timestamp,
                               void* undo, void* codes, void* overflow,
                               void* stream) {
  SeqAccountArgs A;
  if (nbatch != AB_N || n <= 0 || count > n) return (int)cudaErrorInvalidValue;
  int err = pack_table(&A.acc, acc, nacc, AT_N, acc_cap);
  if (err) return err;
  for (int k = 0; k < AB_N; ++k) A.batch[k] = batch[k];
  A.n = n;
  A.count = count;
  A.timestamp = timestamp;
  A.undo = (uint64_t*)undo;
  A.codes = (int32_t*)codes;
  A.overflow = (int*)overflow;
  seq_accounts_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}
