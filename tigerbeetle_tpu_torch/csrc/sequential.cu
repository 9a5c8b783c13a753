// K6 seq_transfers (with its pre-pass K32 seq_prepass) and K7 seq_accounts:
// the sequential commit path.
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
// re-used after a rollback), exactly as the JAX lax.scan runs them:
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
// K6 is two steps, so that the probes leave the serial chain.
//
// 1. K32, the pre-pass, one thread an event on every SM, three launches:
//    probe every event's id, pending id, accounts and posted key against
//    the tables as they were before the batch, gather the rows found, and
//    write one 512-B record an event (SeqRecField); join the batch with
//    itself through a hash in device memory (ids to their lowest event,
//    account slots to their lowest leg, posted keys to their lowest
//    occurrence; keys compared in full, so the join is exact), which gives
//    each distinct account slot a dense index and
//    each post or void of a pending the batch creates that event's columns
//    as its candidate row; copy each dense account's balances.
// 2. The sequencer, one block: lane 0 of warp 0 walks the events in order;
//    eight stager warps copy the records of the next SEQ_D events into a
//    ring in shared memory (cp.async, mbarriers a slot) and with them the
//    few words the batch itself may have changed: the legs' dense balances
//    and the key and tombstone words at the pre-batch free slots, read from
//    L2 once the effects of event e - SEQ_D are stored.  The sequencer
//    trusts a pre-batch answer only where the batch cannot have changed it,
//    and the overlay says where it did:
//    - accounts never move within a transfers batch: the slots, flags and
//      ledgers of the record hold, and the ladder's checks that read only
//      them and the event come precomputed (R_SCODE); the balances are the
//      staged copy unless an event of the window (e - SEQ_D, e) wrote them
//      (forwarded from its request in the ring) or a rollback ran there
//      (read back from device memory);
//    - a key found before the batch stays where it was (K6 never moves or
//      removes a row stored before the batch); a key not found is found now
//      only if an event of its id group inserted it and no rollback
//      tombstoned it since (ins_last, ins_slot's live bit); its row is the
//      candidate's columns (a pending this batch created) or is read from
//      the table (any other in-batch row);
//    - the posted row of a pending likewise, through the posted-key groups;
//    - an insert goes to the pre-batch free slot if that slot is still
//      truly empty (its staged words, and no insert there in the window:
//      recent_t / recent_p), else the walk goes on from it through the table
//      in device memory.
//    The sequencer writes no device memory on the fast path: each event's
//    decisions go into its ring slot's request, and a writer warp composes
//    the rows from the request and the record and stores them, in event
//    order; the slot's `empty` barrier then says every effect of the events
//    up to it is stored, which is what a stager waits for and what the
//    sequencer waits for (flush_before) before it reads device memory on a
//    slow path.  Only a linked event's undo record is written: a rollback
//    reads the records of a chain, whose events are all linked.
//    What the pre-pass could not foresee is walked in device memory, never
//    guessed: a pending row inserted by another event of its group than the
//    candidate (its record and row read back), a posted insert whose key no
//    group holds (every later posted lookup then walks the table).  A
//    capped insert writes slot 0, which may hold a row the records refer
//    to: the sequencer writes the dense balances back and runs the rest of
//    the batch in serial mode, the one-thread loop this kernel always had
//    (serial_event).  The entry point refuses a batch wider than the
//    overlay (SEQ_MAX_N, the machine's default lanes) and a transfers or
//    posted table of more than 2^30 slots (the overlay's 32-bit slot words
//    keep two flag bits; a transfers table of 2^30 slots of over 100 B does
//    not fit on an 80 GB card).
//    Where each piece lives: the ring (records, staged words, requests),
//    the window's inserted slots, the id and posted-key groups' latest
//    inserters, the inserted slots with their live bits, the last writer of
//    each dense account and the raw codes in shared memory (about 160 KB at
//    SEQ_MAX_N = 8,192); the records, the dense balances and the undo log in
//    device memory, L2-resident (4 MB, 1 MB and 1.5 MB at 8,192 events),
//    because 16,384 dense accounts of 64 B do not fit one SM.  After the
//    walk the block writes the dense balances back and the final codes out.
//
// What bounds it on the H100: the sequencer's one thread.  With no device
// memory on its chain (the stagers and the writer keep ahead of it), an
// event costs about 3,300 SM cycles of its own dependent shared-memory
// loads and integer work (the overlay's lookups, the ladder's u128 checks,
// the request): 13.6 ms for 8,190 events of the sequential path's two-phase
// shape on an H100 80GB HBM3 at 700 W.  K32 is bound by its probes' random
// reads, in parallel.
#include "common.cuh"
#include "phase_clock.cuh"
#include "seq_sync.cuh"
#include "tombstone.cuh"

#define SEQ_MAX_PROBE 4096  // ops/state_machine.py MAX_PROBE
#define SEQ_SENT (1ull << 63)
#define NS_PER_S 1000000000ull
#define UNDO_WORDS 23  // acc slots 2, old balances 2 x 8, tr, posted, hist,
                       // the legs' dense indices 2
#define SEQ_NONE (~0ull)  // no group, no dense index
#define SEQ_MAX_N 8192    // the largest batch the sequencer's overlay holds
#define SEQ_MAX_SLOTS (1ll << 30)  // the largest transfers or posted table

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

// K32's record of one event (u64 words; must match
// tigerbeetle_tpu_torch/ops/scan_path.py SEQ_REC_FIELDS, a CPU test
// compares).  The pre-batch answers of its probes, the rows they found, the
// joins within the batch and the event's own columns.  Two u32 fields share
// a word where the name says so (the first in the low half).
enum SeqRecField {
  R_BITS, R_ID_GRP, R_PEND_GRP, R_KGRP,
  R_ESLOT, R_ET, R_PSLOT,
  R_DR_SLOT, R_CR_SLOT, R_DR_DENSE, R_CR_DENSE, R_DR_FL, R_CR_FL,
  R_KEY, R_KSLOT, R_KT, R_KVAL,
  R_P_FLAGS_TIMEOUT, R_P_LEDGER_CODE, R_P_UD32, R_P_TS, R_P_UD64,
  R_P_UD128_LO, R_P_UD128_HI, R_P_AMOUNT_LO, R_P_AMOUNT_HI,
  R_P_DR_LO, R_P_DR_HI, R_P_CR_LO, R_P_CR_HI,
  R_E_FLAGS_TIMEOUT, R_E_CODE_UD32, R_E_DR_LO, R_E_DR_HI, R_E_CR_LO,
  R_E_CR_HI, R_E_AMOUNT_LO, R_E_AMOUNT_HI, R_E_PENDING_LO, R_E_PENDING_HI,
  R_E_UD128_LO, R_E_UD128_HI, R_E_UD64,
  R_V_ID_LO, R_V_ID_HI, R_V_DR_LO, R_V_DR_HI, R_V_CR_LO, R_V_CR_HI,
  R_V_AMOUNT_LO, R_V_AMOUNT_HI, R_V_PENDING_LO, R_V_PENDING_HI,
  R_V_UD128_LO, R_V_UD128_HI, R_V_UD64, R_V_UD32_TIMEOUT, R_V_LEDGER_CODE,
  R_V_FLAGS, R_V_TIMESTAMP,
  R_SCODE,  // the ladder's first code that reads no state the batch changes
  R_N
};
#define REC_WORDS 64  // R_N rounded up: 512 B, 32 copies of 16 B

// R_BITS (scan_path.py SEQ_REC_BITS).
#define RB_ACTIVE 1ull     // the event is in the batch (e < count)
#define RB_EFOUND 2ull     // its id was stored before the batch (at R_ESLOT)
#define RB_ECAP 4ull       // its id's probe found no empty slot (MAX_PROBE)
#define RB_PFOUND 8ull     // its pending was stored before the batch
#define RB_PCAND 16ull     // the P row is the pending the batch creates
#define RB_PCLAMP 32ull    // ... with a balancing flag: its amount may be clamped
#define RB_LEGS 64ull      // the account legs R_DR_* / R_CR_* hold
#define RB_DRF 128ull      // the debit account exists (else slot 0)
#define RB_CRF 256ull      // the credit account exists
#define RB_KKEY 512ull     // R_KEY holds a posted key probed before the batch
#define RB_KFOUND 1024ull  // ... found (R_KVAL its fulfillment)
#define RB_KCAP 2048ull    // ... whose probe found no empty slot

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

// The first truly empty slot of a probe sequence from step t0 on (0 with
// *capped set when none is left within MAX_PROBE steps).
static __device__ uint64_t free_from(const DevTable& T, uint64_t home,
                                     uint64_t t0, bool* capped) {
  for (uint64_t t = t0; t < SEQ_MAX_PROBE; ++t) {
    const uint64_t cur = (home + t) & T.mask;
    if (!T.tomb[cur] && T.key_lo[cur] == 0 && T.key_hi[cur] == 0) {
      *capped = false;
      return cur;
    }
  }
  *capped = true;
  return 0;
}

// _sprobe_free alone (for a key that is present and is inserted again,
// which only a posted row whose fulfillment is neither 1 nor 2 allows).
static __device__ uint64_t sprobe_free(const DevTable& T, uint64_t lo,
                                       uint64_t hi, bool* capped) {
  return free_from(T, mix64(lo, hi) & T.mask, 0, capped);
}

// The pre-pass's probe: probe_key's walk, with the step it ended at.
// Returns whether the key was found; *slot is its slot, else the first truly
// empty slot (0 when capped); *t the step (SEQ_MAX_PROBE when capped).
static __device__ bool probe_full(const DevTable& T, uint64_t lo, uint64_t hi,
                                  uint64_t* slot, uint64_t* t_end,
                                  bool* capped) {
  const bool null = lo == 0 && hi == 0;
  const uint64_t home = mix64(lo, hi) & T.mask;
  *capped = false;
  for (int t = 0; t < SEQ_MAX_PROBE; ++t) {
    const uint64_t cur = (home + (uint64_t)t) & T.mask;
    if (T.tomb[cur]) continue;
    const uint64_t a = T.key_lo[cur], b = T.key_hi[cur];
    const bool empty = a == 0 && b == 0;
    if (empty || (!null && a == lo && b == hi)) {
      *slot = cur;
      *t_end = (uint64_t)t;
      return !empty;
    }
  }
  *slot = 0;
  *t_end = SEQ_MAX_PROBE;
  *capped = true;
  return false;
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
// One event's inputs and the two ladders, shared by the sequencer's fast
// mode and its serial mode
// ---------------------------------------------------------------------------

struct Ev {  // one event's columns
  uint64_t id_lo, id_hi, dr_lo, dr_hi, cr_lo, cr_hi, amt_lo, amt_hi, pend_lo,
      pend_hi, ud128_lo, ud128_hi, ud64, ts;
  uint32_t ud32, timeout, ledger, code, flags;
};

struct Row {  // the fields of a stored transfer the ladders read
  uint32_t flags, timeout, ledger, code, ud32;
  uint64_t ts, ud64, ud128_lo, ud128_hi;
  u128 amount, dr_id, cr_id, pending_id;
};

struct Acct {  // an account the event operates on
  bool found;
  uint64_t slot;  // 0 where not found (as probe_key leaves it)
  uint32_t flags, ledger;
  Bal b;  // zero where not found
};

struct Gathered {
  bool p_found;  // the pending transfer (post/void only)
  Row p;
  Acct dr, cr;
  bool e_found;  // a stored transfer with the event's id
  Row e;
  bool posted_found;  // the posted row keyed by the pending's timestamp
  uint32_t posted_val;
};

static __device__ Row row_at(const DevTable& X, uint64_t s) {
  Row r;
  r.flags = C32(X, TT_FLAGS)[s];
  r.timeout = C32(X, TT_TIMEOUT)[s];
  r.ledger = C32(X, TT_LEDGER)[s];
  r.code = C32(X, TT_CODE)[s];
  r.ud32 = C32(X, TT_USER_DATA_32)[s];
  r.ts = C64(X, TT_TIMESTAMP)[s];
  r.ud64 = C64(X, TT_USER_DATA_64)[s];
  r.ud128_lo = C64(X, TT_USER_DATA_128_LO)[s];
  r.ud128_hi = C64(X, TT_USER_DATA_128_HI)[s];
  r.amount = mk128(C64(X, TT_AMOUNT_LO)[s], C64(X, TT_AMOUNT_HI)[s]);
  r.dr_id = mk128(C64(X, TT_DEBIT_ACCOUNT_ID_LO)[s], C64(X, TT_DEBIT_ACCOUNT_ID_HI)[s]);
  r.cr_id = mk128(C64(X, TT_CREDIT_ACCOUNT_ID_LO)[s], C64(X, TT_CREDIT_ACCOUNT_ID_HI)[s]);
  r.pending_id = mk128(C64(X, TT_PENDING_ID_LO)[s], C64(X, TT_PENDING_ID_HI)[s]);
  return r;
}

// The precedence ladders (state_machine.zig:1239-1368 create_transfer,
// :1391-1498 post_or_void_pending_transfer), in two parts.  static_code:
// the checks that read only the event and whether its accounts exist and
// their ledgers, none of which a transfers batch changes (K32 evaluates
// them into R_SCODE); 0 where all pass.
static __device__ uint32_t static_code(const Ev& v, bool dr_found,
                                       bool cr_found, uint32_t dr_ledger,
                                       uint32_t cr_ledger) {
  const uint32_t flags = v.flags;
  const u128 tid = mk128(v.id_lo, v.id_hi);
  const bool post = flags & TF_POST, void_ = flags & TF_VOID;
  const bool pending_f = flags & TF_PENDING;
  const bool bal_dr = flags & TF_BALANCING_DEBIT;
  const bool bal_cr = flags & TF_BALANCING_CREDIT;
  const u128 t_amount = mk128(v.amt_lo, v.amt_hi);
  const u128 pend_id = mk128(v.pend_lo, v.pend_hi);
  const u128 t_dr_id = mk128(v.dr_lo, v.dr_hi);
  const u128 t_cr_id = mk128(v.cr_lo, v.cr_hi);
  if (flags & TF_PADDING) return 4;
  if (tid == 0) return 5;
  if (tid == U128_MAX) return 6;
  if (!(post || void_)) {
    if (t_dr_id == 0) return 8;
    if (t_dr_id == U128_MAX) return 9;
    if (t_cr_id == 0) return 10;
    if (t_cr_id == U128_MAX) return 11;
    if (t_dr_id == t_cr_id) return 12;
    if (pend_id != 0) return 13;
    if (!pending_f && v.timeout != 0) return 17;
    if (!bal_dr && !bal_cr && t_amount == 0) return 18;
    if (v.ledger == 0) return 19;
    if (v.code == 0) return 20;
    if (!dr_found) return 21;
    if (!cr_found) return 22;
    if (dr_ledger != cr_ledger) return 23;
    if (v.ledger != dr_ledger) return 24;
    return 0;
  }
  if (post && void_) return 7;
  if (pending_f || bal_dr || bal_cr) return 7;
  if (pend_id == 0) return 14;
  if (pend_id == U128_MAX) return 15;
  if (pend_id == tid) return 16;
  if (v.timeout != 0) return 17;
  return 0;
}

// The rest of the ladders, for an event static_code passed, over its
// gathered inputs: the code, and in *eff the amount an accepted event
// applies.  Each check runs only when the ones before it passed.
static __device__ uint32_t dynamic_code(const Ev& v, uint64_t ev_ts,
                                        const Gathered& g, u128* eff) {
  const uint32_t flags = v.flags;
  const bool post = flags & TF_POST, void_ = flags & TF_VOID;
  const bool pending_f = flags & TF_PENDING;
  const bool bal_dr = flags & TF_BALANCING_DEBIT;
  const bool bal_cr = flags & TF_BALANCING_CREDIT;
  const u128 t_amount = mk128(v.amt_lo, v.amt_hi);
  const u128 pend_id = mk128(v.pend_lo, v.pend_hi);
  const u128 t_dr_id = mk128(v.dr_lo, v.dr_hi);
  const u128 t_cr_id = mk128(v.cr_lo, v.cr_hi);
  const Row& e = g.e;
  const Row& p = g.p;
  *eff = 0;

  if (!(post || void_)) {
    if (g.e_found) {
      // create_transfer_exists (state_machine.zig:1370-1389).
      if (flags != e.flags) return 36;
      if (t_dr_id != e.dr_id) return 37;
      if (t_cr_id != e.cr_id) return 38;
      if (t_amount != e.amount) return 39;
      if (pend_id != e.pending_id) return 40;
      if (v.ud128_lo != e.ud128_lo || v.ud128_hi != e.ud128_hi) return 41;
      if (v.ud64 != e.ud64) return 42;
      if (v.ud32 != e.ud32) return 43;
      if (v.timeout != e.timeout) return 44;
      if (v.code != e.code) return 45;
      return 46;
    }
    const Bal& drb = g.dr.b;
    const Bal& crb = g.cr.b;
    u128 amount = t_amount;
    if (bal_dr || bal_cr) {  // the balancing clamps (:1286-1306)
      const u128 amount0 = t_amount == 0 ? (u128)~0ull : t_amount;
      const u128 amount1 =
          bal_dr ? min128(amount0, sub_saturate(drb.cpo, drb.dpo + drb.dp)) : amount0;
      if (bal_dr && amount1 == 0) return 54;
      amount = bal_cr ? min128(amount1, sub_saturate(crb.dpo, crb.cpo + crb.cp)) : amount1;
      if (bal_cr && amount == 0) return 55;
    }
    if (pending_f && add_overflows(amount, drb.dp)) return 47;
    if (pending_f && add_overflows(amount, crb.cp)) return 48;
    if (add_overflows(amount, drb.dpo)) return 49;
    if (add_overflows(amount, crb.cpo)) return 50;
    const u128 dr_total = drb.dp + drb.dpo;
    const u128 cr_total = crb.cp + crb.cpo;
    if (add_overflows(amount, dr_total)) return 51;
    if (add_overflows(amount, cr_total)) return 52;
    if (ev_ts + (uint64_t)v.timeout * NS_PER_S < ev_ts) return 53;
    if ((g.dr.flags & AF_DEBITS_MUST_NOT_EXCEED_CREDITS) && dr_total + amount > drb.cpo)
      return 54;
    if ((g.cr.flags & AF_CREDITS_MUST_NOT_EXCEED_DEBITS) && cr_total + amount > crb.dpo)
      return 55;
    *eff = amount;
    return 0;
  }
  if (!g.p_found) return 25;
  if (!(p.flags & TF_PENDING)) return 26;
  if (t_dr_id != 0 && t_dr_id != p.dr_id) return 27;
  if (t_cr_id != 0 && t_cr_id != p.cr_id) return 28;
  if (v.ledger != 0 && v.ledger != p.ledger) return 29;
  if (v.code != 0 && v.code != p.code) return 30;
  const u128 pv_amount = t_amount != 0 ? t_amount : p.amount;
  if (pv_amount > p.amount) return 31;
  if (void_ && pv_amount < p.amount) return 32;
  if (g.e_found) {
    // post_or_void_pending_transfer_exists (state_machine.zig:1500-1561): a
    // zero field of the event compares the stored row with the pending
    // transfer instead.
    if (flags != e.flags) return 36;
    if (t_amount == 0 ? e.amount != p.amount : t_amount != e.amount) return 39;
    if (pend_id != e.pending_id) return 40;
    if ((v.ud128_lo == 0 && v.ud128_hi == 0)
            ? (e.ud128_lo != p.ud128_lo || e.ud128_hi != p.ud128_hi)
            : (v.ud128_lo != e.ud128_lo || v.ud128_hi != e.ud128_hi))
      return 41;
    if (v.ud64 == 0 ? e.ud64 != p.ud64 : v.ud64 != e.ud64) return 42;
    if (v.ud32 == 0 ? e.ud32 != p.ud32 : v.ud32 != e.ud32) return 43;
    return 46;
  }
  if (g.posted_found && g.posted_val == 1) return 33;
  if (g.posted_found && g.posted_val == 2) return 34;
  if (p.timeout != 0 && ev_ts >= p.ts + (uint64_t)p.timeout * NS_PER_S) return 35;
  *eff = pv_amount;
  return 0;
}

// Both parts: the whole ladder.
static __device__ uint32_t ladder(const Ev& v, uint64_t ev_ts,
                                  const Gathered& g, u128* eff) {
  *eff = 0;
  const uint32_t c = static_code(v, g.dr.found, g.cr.found, g.dr.ledger, g.cr.ledger);
  return c ? c : dynamic_code(v, ev_ts, g, eff);
}

// The new balances of an accepted event (state_machine.zig:1330-1338,
// :1481-1491).
static __device__ void new_balances(const Ev& v, const Gathered& g, u128 eff,
                                    Bal* ndr, Bal* ncr) {
  const bool post = v.flags & TF_POST;
  const bool postvoid = post || (v.flags & TF_VOID);
  *ndr = g.dr.b;
  *ncr = g.cr.b;
  if (postvoid) {
    // Release pending; a post adds posted.
    const u128 posted_amt = post ? eff : (u128)0;
    ndr->dp = g.dr.b.dp - g.p.amount;
    ndr->dpo = g.dr.b.dpo + posted_amt;
    ncr->cp = g.cr.b.cp - g.p.amount;
    ncr->cpo = g.cr.b.cpo + posted_amt;
  } else if (v.flags & TF_PENDING) {
    ndr->dp = g.dr.b.dp + eff;
    ncr->cp = g.cr.b.cp + eff;
  } else {
    ndr->dpo = g.dr.b.dpo + eff;
    ncr->cpo = g.cr.b.cpo + eff;
  }
}

// The transfer row an accepted event stores at slot s (the key and count
// are the caller's).
static __device__ void write_row(const DevTable& X, uint64_t s, const Ev& v,
                                 const Gathered& g, u128 eff, uint64_t ev_ts) {
  const bool postvoid = v.flags & (TF_POST | TF_VOID);
  const Row& p = g.p;
  const u128 row_dr = postvoid ? p.dr_id : mk128(v.dr_lo, v.dr_hi);
  const u128 row_cr = postvoid ? p.cr_id : mk128(v.cr_lo, v.cr_hi);
  const bool ud128_zero = v.ud128_lo == 0 && v.ud128_hi == 0;
  C64(X, TT_DEBIT_ACCOUNT_ID_LO)[s] = lo64(row_dr);
  C64(X, TT_DEBIT_ACCOUNT_ID_HI)[s] = hi64(row_dr);
  C64(X, TT_CREDIT_ACCOUNT_ID_LO)[s] = lo64(row_cr);
  C64(X, TT_CREDIT_ACCOUNT_ID_HI)[s] = hi64(row_cr);
  C64(X, TT_AMOUNT_LO)[s] = lo64(eff);
  C64(X, TT_AMOUNT_HI)[s] = hi64(eff);
  C64(X, TT_PENDING_ID_LO)[s] = v.pend_lo;
  C64(X, TT_PENDING_ID_HI)[s] = v.pend_hi;
  C64(X, TT_USER_DATA_128_LO)[s] = (postvoid && ud128_zero) ? p.ud128_lo : v.ud128_lo;
  C64(X, TT_USER_DATA_128_HI)[s] = (postvoid && ud128_zero) ? p.ud128_hi : v.ud128_hi;
  C64(X, TT_USER_DATA_64)[s] = (postvoid && v.ud64 == 0) ? p.ud64 : v.ud64;
  C32(X, TT_USER_DATA_32)[s] = (postvoid && v.ud32 == 0) ? p.ud32 : v.ud32;
  C32(X, TT_TIMEOUT)[s] = postvoid ? 0u : v.timeout;
  C32(X, TT_LEDGER)[s] = postvoid ? p.ledger : v.ledger;
  C32(X, TT_CODE)[s] = postvoid ? p.code : v.code;
  C32(X, TT_FLAGS)[s] = v.flags;
  C64(X, TT_TIMESTAMP)[s] = ev_ts;
}

// History append (state_machine.zig:1342-1364): a side without the flag
// stays zero.  The host grows the log first; a row past the capacity would
// be dropped while count still advances.
static __device__ void write_history(uint64_t* const* hist, int64_t hist_cap,
                                     long long h, const Gathered& g,
                                     const u128 ids[2], const uint64_t* w,
                                     const uint64_t* wc, uint64_t ev_ts) {
  if (h >= hist_cap) return;
  const bool on[2] = {(g.dr.flags & AF_HISTORY) != 0, (g.cr.flags & AF_HISTORY) != 0};
  const uint64_t* words[2] = {w, wc};
  for (int side = 0; side < 2; ++side) {
    const int base = side * 10;
    hist[base + 0][h] = on[side] ? lo64(ids[side]) : 0;
    hist[base + 1][h] = on[side] ? hi64(ids[side]) : 0;
    for (int k = 0; k < 8; ++k) hist[base + 2 + k][h] = on[side] ? words[side][k] : 0;
  }
  hist[H_TIMESTAMP][h] = ev_ts;
}

// ---------------------------------------------------------------------------
// K32 seq_prepass: the pre-batch probes of every event, in parallel
// ---------------------------------------------------------------------------

// An event's columns from its K32 record.
static __device__ void ev_from_rec(const uint64_t* r, Ev* v) {
  v->id_lo = r[R_V_ID_LO];
  v->id_hi = r[R_V_ID_HI];
  v->dr_lo = r[R_V_DR_LO];
  v->dr_hi = r[R_V_DR_HI];
  v->cr_lo = r[R_V_CR_LO];
  v->cr_hi = r[R_V_CR_HI];
  v->amt_lo = r[R_V_AMOUNT_LO];
  v->amt_hi = r[R_V_AMOUNT_HI];
  v->pend_lo = r[R_V_PENDING_LO];
  v->pend_hi = r[R_V_PENDING_HI];
  v->ud128_lo = r[R_V_UD128_LO];
  v->ud128_hi = r[R_V_UD128_HI];
  v->ud64 = r[R_V_UD64];
  v->ts = r[R_V_TIMESTAMP];
  v->ud32 = (uint32_t)r[R_V_UD32_TIMEOUT];
  v->timeout = (uint32_t)(r[R_V_UD32_TIMEOUT] >> 32);
  v->ledger = (uint32_t)r[R_V_LEDGER_CODE];
  v->code = (uint32_t)(r[R_V_LEDGER_CODE] >> 32);
  v->flags = (uint32_t)r[R_V_FLAGS];
}

// The joins' hash tables, open addressing in device memory.  An entry is
// claimed by the first value inserted for its key (`own` = that value + 1)
// and holds the lowest value of the key (`val`).  A key is not stored: it
// is read back from the claimant's record and compared in full, so two
// keys never share an entry.
struct JoinHash {
  ull* own;  // 0 = empty
  ull* val;
  uint64_t mask;
};

enum JoinKind {
  J_ID,   // transfer ids; value: the event
  J_ACC,  // account slots; value: the leg, 2e + side
  J_PST   // posted keys; value: 2e (a found pending's timestamp) or 2e + 1
          // (the pending event e creates, at ts_base + e)
};

struct SeqPreArgs {
  const void* batch[TB_N];
  DevTable acc, xfr, pst;
  int64_t n, count;
  uint64_t ts_base;
  uint64_t* rec;    // n x REC_WORDS
  uint64_t* bal;    // 2n x 8: dense balances
  uint64_t* dslot;  // 2n: a dense index's account slot, SEQ_NONE if unused
  ull* hash;        // claimants [hash_n], then values [hash_n]
  int64_t hash_n;
  JoinHash hid, hacc, hpst;
};

// Whether value v of join `kind` has the key (lo, hi).  The words read are
// written by the probe launch and not changed by the join or link launches
// (a leg is joined only where the probe launch set RB_LEGS, and a posted
// key 2e only where it set RB_PFOUND; link rewrites neither).
static __device__ __forceinline__ bool join_is(const SeqPreArgs& A, int kind,
                                               ull v, uint64_t lo,
                                               uint64_t hi) {
  if (kind == J_ID) {
    const uint64_t* r = A.rec + v * REC_WORDS;
    return r[R_V_ID_LO] == lo && r[R_V_ID_HI] == hi;
  }
  if (kind == J_ACC)
    return A.rec[(v >> 1) * REC_WORDS + ((v & 1) ? R_CR_SLOT : R_DR_SLOT)] == lo;
  return ((v & 1) ? A.ts_base + (v >> 1)
                  : A.rec[(v >> 1) * REC_WORDS + R_P_TS]) == lo;
}

static __device__ void hash_insert(const SeqPreArgs& A, const JoinHash& H,
                                   int kind, uint64_t lo, uint64_t hi, ull v) {
  for (uint64_t h = mix64(lo, hi) & H.mask;; h = (h + 1) & H.mask) {
    const ull old = atomicCAS(H.own + h, 0ull, v + 1);
    if (old == 0 || join_is(A, kind, old - 1, lo, hi)) {
      atomicMin(H.val + h, v);
      return;
    }
  }
}

static __device__ ull hash_find(const SeqPreArgs& A, const JoinHash& H,
                                int kind, uint64_t lo, uint64_t hi) {
  for (uint64_t h = mix64(lo, hi) & H.mask;; h = (h + 1) & H.mask) {
    const ull o = H.own[h];
    if (o == 0) return SEQ_NONE;
    if (join_is(A, kind, o - 1, lo, hi)) return H.val[h];
  }
}

#define EVB64(k) (static_cast<const uint64_t*>(A.batch[k])[e])
#define EVB32(k) (static_cast<const uint32_t*>(A.batch[k])[e])

static __device__ void gather_p(const DevTable& X, uint64_t s, uint64_t* r) {
  r[R_P_FLAGS_TIMEOUT] = (uint64_t)C32(X, TT_FLAGS)[s] | ((uint64_t)C32(X, TT_TIMEOUT)[s] << 32);
  r[R_P_LEDGER_CODE] = (uint64_t)C32(X, TT_LEDGER)[s] | ((uint64_t)C32(X, TT_CODE)[s] << 32);
  r[R_P_UD32] = C32(X, TT_USER_DATA_32)[s];
  r[R_P_TS] = C64(X, TT_TIMESTAMP)[s];
  r[R_P_UD64] = C64(X, TT_USER_DATA_64)[s];
  r[R_P_UD128_LO] = C64(X, TT_USER_DATA_128_LO)[s];
  r[R_P_UD128_HI] = C64(X, TT_USER_DATA_128_HI)[s];
  r[R_P_AMOUNT_LO] = C64(X, TT_AMOUNT_LO)[s];
  r[R_P_AMOUNT_HI] = C64(X, TT_AMOUNT_HI)[s];
  r[R_P_DR_LO] = C64(X, TT_DEBIT_ACCOUNT_ID_LO)[s];
  r[R_P_DR_HI] = C64(X, TT_DEBIT_ACCOUNT_ID_HI)[s];
  r[R_P_CR_LO] = C64(X, TT_CREDIT_ACCOUNT_ID_LO)[s];
  r[R_P_CR_HI] = C64(X, TT_CREDIT_ACCOUNT_ID_HI)[s];
}

static __device__ void gather_e(const DevTable& X, uint64_t s, uint64_t* r) {
  r[R_E_FLAGS_TIMEOUT] = (uint64_t)C32(X, TT_FLAGS)[s] | ((uint64_t)C32(X, TT_TIMEOUT)[s] << 32);
  r[R_E_CODE_UD32] = (uint64_t)C32(X, TT_CODE)[s] | ((uint64_t)C32(X, TT_USER_DATA_32)[s] << 32);
  r[R_E_DR_LO] = C64(X, TT_DEBIT_ACCOUNT_ID_LO)[s];
  r[R_E_DR_HI] = C64(X, TT_DEBIT_ACCOUNT_ID_HI)[s];
  r[R_E_CR_LO] = C64(X, TT_CREDIT_ACCOUNT_ID_LO)[s];
  r[R_E_CR_HI] = C64(X, TT_CREDIT_ACCOUNT_ID_HI)[s];
  r[R_E_AMOUNT_LO] = C64(X, TT_AMOUNT_LO)[s];
  r[R_E_AMOUNT_HI] = C64(X, TT_AMOUNT_HI)[s];
  r[R_E_PENDING_LO] = C64(X, TT_PENDING_ID_LO)[s];
  r[R_E_PENDING_HI] = C64(X, TT_PENDING_ID_HI)[s];
  r[R_E_UD128_LO] = C64(X, TT_USER_DATA_128_LO)[s];
  r[R_E_UD128_HI] = C64(X, TT_USER_DATA_128_HI)[s];
  r[R_E_UD64] = C64(X, TT_USER_DATA_64)[s];
}

// The posted table's pre-batch answer for key (key, 0).
static __device__ void probe_posted(const DevTable& P, uint64_t key,
                                    uint64_t* r, uint64_t* bits) {
  uint64_t slot, t;
  bool capped;
  *bits |= RB_KKEY;
  r[R_KEY] = key;
  if (probe_full(P, key, 0, &slot, &t, &capped)) {
    *bits |= RB_KFOUND;
    r[R_KVAL] = C32(P, 0)[slot];
  }
  if (capped) *bits |= RB_KCAP;
  r[R_KSLOT] = slot;
  r[R_KT] = t;
}

// Launch 1: clear the join hash and the dense arrays; probe every active
// event against the pre-batch tables.
__global__ void seq_pre_probe(SeqPreArgs A) {
  const int64_t span = max(max(A.hash_n, 2 * A.n), A.n);
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; t < span;
       t += (int64_t)gridDim.x * blockDim.x) {
    if (t < A.hash_n) {
      A.hash[t] = 0;
      A.hash[A.hash_n + t] = SEQ_NONE;
    }
    if (t < 2 * A.n) {
      for (int k = 0; k < 8; ++k) A.bal[t * 8 + k] = 0;
      A.dslot[t] = SEQ_NONE;
    }
    if (t >= A.n) continue;
    const int64_t e = t;
    uint64_t* r = A.rec + e * REC_WORDS;
    for (int k = 0; k < REC_WORDS; ++k) r[k] = 0;
    if (e >= A.count) continue;  // an inactive lane's record stays zero
    r[R_ID_GRP] = r[R_PEND_GRP] = r[R_KGRP] = SEQ_NONE;
    r[R_DR_DENSE] = r[R_CR_DENSE] = SEQ_NONE;
    r[R_V_ID_LO] = EVB64(TB_ID_LO);
    r[R_V_ID_HI] = EVB64(TB_ID_HI);
    r[R_V_DR_LO] = EVB64(TB_DEBIT_ACCOUNT_ID_LO);
    r[R_V_DR_HI] = EVB64(TB_DEBIT_ACCOUNT_ID_HI);
    r[R_V_CR_LO] = EVB64(TB_CREDIT_ACCOUNT_ID_LO);
    r[R_V_CR_HI] = EVB64(TB_CREDIT_ACCOUNT_ID_HI);
    r[R_V_AMOUNT_LO] = EVB64(TB_AMOUNT_LO);
    r[R_V_AMOUNT_HI] = EVB64(TB_AMOUNT_HI);
    r[R_V_PENDING_LO] = EVB64(TB_PENDING_ID_LO);
    r[R_V_PENDING_HI] = EVB64(TB_PENDING_ID_HI);
    r[R_V_UD128_LO] = EVB64(TB_USER_DATA_128_LO);
    r[R_V_UD128_HI] = EVB64(TB_USER_DATA_128_HI);
    r[R_V_UD64] = EVB64(TB_USER_DATA_64);
    r[R_V_UD32_TIMEOUT] = (uint64_t)EVB32(TB_USER_DATA_32) | ((uint64_t)EVB32(TB_TIMEOUT) << 32);
    r[R_V_LEDGER_CODE] = (uint64_t)EVB32(TB_LEDGER) | ((uint64_t)EVB32(TB_CODE) << 32);
    r[R_V_FLAGS] = EVB32(TB_FLAGS);
    r[R_V_TIMESTAMP] = EVB64(TB_TIMESTAMP);
    const uint32_t flags = EVB32(TB_FLAGS);
    const bool postvoid = flags & (TF_POST | TF_VOID);
    uint64_t bits = RB_ACTIVE;
    uint64_t slot, t_end;
    bool capped;
    // The event's id.
    if (probe_full(A.xfr, r[R_V_ID_LO], r[R_V_ID_HI], &slot, &t_end, &capped)) {
      bits |= RB_EFOUND;
      gather_e(A.xfr, slot, r);
    }
    if (capped) bits |= RB_ECAP;
    r[R_ESLOT] = slot;
    r[R_ET] = t_end;
    // The pending transfer, its accounts and its posted key.
    uint64_t ids[4] = {r[R_V_DR_LO], r[R_V_DR_HI], r[R_V_CR_LO], r[R_V_CR_HI]};
    bool legs = !postvoid;
    if (postvoid && probe_full(A.xfr, r[R_V_PENDING_LO], r[R_V_PENDING_HI], &slot,
                               &t_end, &capped)) {
      bits |= RB_PFOUND;
      r[R_PSLOT] = slot;
      gather_p(A.xfr, slot, r);
      ids[0] = r[R_P_DR_LO];
      ids[1] = r[R_P_DR_HI];
      ids[2] = r[R_P_CR_LO];
      ids[3] = r[R_P_CR_HI];
      legs = true;
      probe_posted(A.pst, r[R_P_TS], r, &bits);
    }
    if (legs) {
      bits |= RB_LEGS;
      for (int side = 0; side < 2; ++side) {
        uint64_t aslot, free_slot;
        bool acapped;
        const bool found = probe_key(A.acc, ids[2 * side], ids[2 * side + 1],
                                     &aslot, &free_slot, &acapped);
        if (found) {
          bits |= side ? RB_CRF : RB_DRF;
          r[side ? R_CR_FL : R_DR_FL] = (uint64_t)C32(A.acc, AT_FLAGS)[aslot] |
                                        ((uint64_t)C32(A.acc, AT_LEDGER)[aslot] << 32);
        }
        r[side ? R_CR_SLOT : R_DR_SLOT] = aslot;
      }
    }
    r[R_BITS] = bits;
    Ev v;
    ev_from_rec(r, &v);
    r[R_SCODE] = static_code(v, bits & RB_DRF, bits & RB_CRF,
                             (uint32_t)(r[R_DR_FL] >> 32),
                             (uint32_t)(r[R_CR_FL] >> 32));
  }
}

// Launch 2: the joins' keys: every active event's id (value: the event),
// every account leg's slot (value: the leg, 2e + side), and every posted
// key an event may look up (value: 2e for a found pending's timestamp,
// 2e + 1 for a pending the event creates, at ts_base + e).
__global__ void seq_pre_join(SeqPreArgs A) {
  const int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (e >= A.count) return;
  const uint64_t* r = A.rec + e * REC_WORDS;
  const uint64_t bits = r[R_BITS];
  const uint32_t flags = (uint32_t)r[R_V_FLAGS];
  hash_insert(A, A.hid, J_ID, r[R_V_ID_LO], r[R_V_ID_HI], (ull)e);
  if (bits & RB_LEGS) {
    hash_insert(A, A.hacc, J_ACC, r[R_DR_SLOT], 0, (ull)(2 * e));
    hash_insert(A, A.hacc, J_ACC, r[R_CR_SLOT], 0, (ull)(2 * e + 1));
  }
  if (bits & RB_PFOUND) {
    hash_insert(A, A.hpst, J_PST, r[R_P_TS], 0, (ull)(2 * e));
  } else if ((flags & TF_PENDING) && !(flags & (TF_POST | TF_VOID))) {
    hash_insert(A, A.hpst, J_PST, A.ts_base + (uint64_t)e, 0,
                (ull)(2 * e + 1));
  }
}

// Launch 3: read the joins back.  Each event gets its id's group (the
// lowest event with that id) and its pending id's group; a post or void
// whose pending the batch itself creates takes that event's columns as its
// candidate pending row, its account legs and its posted key; every leg
// gets its dense index (the lowest leg on its slot), whose owner copies the
// account's pre-batch balances; every posted key its group.
__global__ void seq_pre_link(SeqPreArgs A) {
  const int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (e >= A.count) return;
  uint64_t* r = A.rec + e * REC_WORDS;
  uint64_t bits = r[R_BITS];
  const uint32_t flags = (uint32_t)r[R_V_FLAGS];
  // Every key looked up here but the pending id was inserted by this event
  // (or, for a candidate's legs and posted key, by the candidate), so those
  // finds never miss.
  r[R_ID_GRP] = hash_find(A, A.hid, J_ID, r[R_V_ID_LO], r[R_V_ID_HI]);
  if (flags & (TF_POST | TF_VOID)) {
    const ull c = hash_find(A, A.hid, J_ID, r[R_V_PENDING_LO], r[R_V_PENDING_HI]);
    if (c != SEQ_NONE) {
      const uint64_t* rc = A.rec + c * REC_WORDS;
      r[R_PEND_GRP] = c;
      const uint32_t cflags = (uint32_t)rc[R_V_FLAGS];
      if (!(bits & RB_PFOUND) && (cflags & TF_PENDING) &&
          !(cflags & (TF_POST | TF_VOID))) {
        bits |= RB_PCAND | RB_LEGS | (rc[R_BITS] & (RB_DRF | RB_CRF));
        if (cflags & (TF_BALANCING_DEBIT | TF_BALANCING_CREDIT)) bits |= RB_PCLAMP;
        r[R_P_FLAGS_TIMEOUT] = (uint64_t)cflags | (rc[R_V_UD32_TIMEOUT] & 0xFFFFFFFF00000000ull);
        r[R_P_LEDGER_CODE] = rc[R_V_LEDGER_CODE];
        r[R_P_UD32] = rc[R_V_UD32_TIMEOUT] & 0xFFFFFFFFull;
        r[R_P_TS] = A.ts_base + (uint64_t)c;
        r[R_P_UD64] = rc[R_V_UD64];
        r[R_P_UD128_LO] = rc[R_V_UD128_LO];
        r[R_P_UD128_HI] = rc[R_V_UD128_HI];
        r[R_P_AMOUNT_LO] = rc[R_V_AMOUNT_LO];
        r[R_P_AMOUNT_HI] = rc[R_V_AMOUNT_HI];
        r[R_P_DR_LO] = rc[R_V_DR_LO];
        r[R_P_DR_HI] = rc[R_V_DR_HI];
        r[R_P_CR_LO] = rc[R_V_CR_LO];
        r[R_P_CR_HI] = rc[R_V_CR_HI];
        r[R_DR_SLOT] = rc[R_DR_SLOT];
        r[R_CR_SLOT] = rc[R_CR_SLOT];
        r[R_DR_FL] = rc[R_DR_FL];
        r[R_CR_FL] = rc[R_CR_FL];
        probe_posted(A.pst, r[R_P_TS], r, &bits);
      }
    }
  }
  if (bits & RB_LEGS) {
    for (int side = 0; side < 2; ++side) {
      const uint64_t slot = r[side ? R_CR_SLOT : R_DR_SLOT];
      const ull d = hash_find(A, A.hacc, J_ACC, slot, 0);
      r[side ? R_CR_DENSE : R_DR_DENSE] = d;
      if (d == (ull)(2 * e + side)) {  // this leg owns its dense index
        for (int k = 0; k < 8; ++k) A.bal[d * 8 + k] = C64(A.acc, AT_DEBITS_PENDING_LO + k)[slot];
        A.dslot[d] = slot;
      }
    }
  }
  if (bits & RB_KKEY) {
    r[R_KGRP] = hash_find(A, A.hpst, J_PST, r[R_KEY], 0);
  }
  r[R_BITS] = bits;
}

// ---------------------------------------------------------------------------
// K6 seq_transfers: the sequencer
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
  const uint64_t* rec;    // the pre-pass's records
  uint64_t* bal;          // dense balances (the pre-pass's, then current)
  const uint64_t* dslot;  // a dense index's account slot
};

struct Chain {
  int64_t start;
  bool broken;
};

static __device__ void ev_from_batch(const SeqTransferArgs& A, int64_t e, Ev* v) {
  v->id_lo = EVB64(TB_ID_LO);
  v->id_hi = EVB64(TB_ID_HI);
  v->dr_lo = EVB64(TB_DEBIT_ACCOUNT_ID_LO);
  v->dr_hi = EVB64(TB_DEBIT_ACCOUNT_ID_HI);
  v->cr_lo = EVB64(TB_CREDIT_ACCOUNT_ID_LO);
  v->cr_hi = EVB64(TB_CREDIT_ACCOUNT_ID_HI);
  v->amt_lo = EVB64(TB_AMOUNT_LO);
  v->amt_hi = EVB64(TB_AMOUNT_HI);
  v->pend_lo = EVB64(TB_PENDING_ID_LO);
  v->pend_hi = EVB64(TB_PENDING_ID_HI);
  v->ud128_lo = EVB64(TB_USER_DATA_128_LO);
  v->ud128_hi = EVB64(TB_USER_DATA_128_HI);
  v->ud64 = EVB64(TB_USER_DATA_64);
  v->ts = EVB64(TB_TIMESTAMP);
  v->ud32 = EVB32(TB_USER_DATA_32);
  v->timeout = EVB32(TB_TIMEOUT);
  v->ledger = EVB32(TB_LEDGER);
  v->code = EVB32(TB_CODE);
  v->flags = EVB32(TB_FLAGS);
}


// Serial mode: one event as the one-thread kernel always ran it, every probe
// and row a walk of the tables in device memory (which hold the batch's
// earlier writes), the balances in the accounts table, the counts in
// device memory.  Event i is active (i < count): serial mode begins only
// after a capped insert.  Returns the raw code.
static __device__ uint32_t serial_event(const SeqTransferArgs& A, int64_t i,
                                        Chain* ch) {
  const int64_t e = i;
  uint64_t* undo = A.undo + i * UNDO_WORDS;
  undo[0] = undo[1] = undo[18] = undo[19] = SEQ_SENT;
  undo[20] = 0;
  Ev v;
  ev_from_batch(A, e, &v);
  const bool linked = v.flags & TF_LINKED;
  if (linked && ch->start < 0) ch->start = i;  // state_machine.zig:1022
  const bool in_chain = ch->start >= 0;
  const bool chain_open_err = linked && i == A.count - 1;
  const uint64_t ev_ts = A.timestamp - (uint64_t)A.count + 1 + (uint64_t)i;

  // execute()-level preemptions (state_machine.zig:1021-1041): where one
  // fires, the logic's code is discarded and nothing is applied.
  uint32_t code = 0;
  if (chain_open_err) code = 2;
  else if (ch->broken) code = 1;
  else if (v.ts != 0) code = 3;
  if (code == 0) {
    const bool postvoid = v.flags & (TF_POST | TF_VOID);
    Gathered g = {};
    uint64_t scratch;
    bool scratch_capped;
    uint64_t p_slot = 0;
    g.p_found = postvoid && probe_key(A.xfr, v.pend_lo, v.pend_hi, &p_slot, &scratch,
                                      &scratch_capped);
    if (g.p_found) g.p = row_at(A.xfr, p_slot);
    const u128 dr_id = postvoid ? g.p.dr_id : mk128(v.dr_lo, v.dr_hi);
    const u128 cr_id = postvoid ? g.p.cr_id : mk128(v.cr_lo, v.cr_hi);
    g.dr.found = probe_key(A.acc, lo64(dr_id), hi64(dr_id), &g.dr.slot, &scratch,
                           &scratch_capped);
    g.cr.found = probe_key(A.acc, lo64(cr_id), hi64(cr_id), &g.cr.slot, &scratch,
                           &scratch_capped);
    g.dr.b = load_bal(A.acc, g.dr.slot, g.dr.found);
    g.cr.b = load_bal(A.acc, g.cr.slot, g.cr.found);
    g.dr.flags = g.dr.found ? C32(A.acc, AT_FLAGS)[g.dr.slot] : 0;
    g.cr.flags = g.cr.found ? C32(A.acc, AT_FLAGS)[g.cr.slot] : 0;
    g.dr.ledger = g.dr.found ? C32(A.acc, AT_LEDGER)[g.dr.slot] : 0;
    g.cr.ledger = g.cr.found ? C32(A.acc, AT_LEDGER)[g.cr.slot] : 0;
    uint64_t e_slot, t_free;
    bool t_capped;
    g.e_found = probe_key(A.xfr, v.id_lo, v.id_hi, &e_slot, &t_free, &t_capped);
    if (g.e_found) g.e = row_at(A.xfr, e_slot);
    uint64_t posted_slot = 0, posted_free = 0;
    bool posted_capped = false;
    g.posted_found = postvoid && probe_key(A.pst, g.p.ts, 0, &posted_slot,
                                           &posted_free, &posted_capped);
    g.posted_val = g.posted_found ? C32(A.pst, 0)[posted_slot] : 0;
    u128 eff;
    code = ladder(v, ev_ts, g, &eff);

    if (code == 0) {  // _apply_transfer
      Bal ndr, ncr;
      new_balances(v, g, eff, &ndr, &ncr);
      uint64_t w[8], wc[8];
      undo[0] = g.dr.slot;
      undo[1] = g.cr.slot;
      bal_words(g.dr.b, undo + 2);
      bal_words(g.cr.b, undo + 10);
      bal_words(ndr, w);
      store_words(A.acc, g.dr.slot, w);
      bal_words(ncr, wc);
      store_words(A.acc, g.cr.slot, wc);
      // Transfer insert at the first truly empty slot of its probe.
      const uint64_t s = t_capped ? 0 : t_free;
      if (t_capped) *A.overflow = 1;
      write_row(A.xfr, s, v, g, eff, ev_ts);
      set_key(A.xfr, s, v.id_lo, v.id_hi);
      undo[18] = s;
      if (postvoid) {
        bool capped = posted_capped;
        uint64_t ps = posted_free;
        if (g.posted_found) ps = sprobe_free(A.pst, g.p.ts, 0, &capped);
        if (capped) {
          ps = 0;
          *A.overflow = 1;
        }
        C32(A.pst, 0)[ps] = (v.flags & TF_POST) ? 1u : 2u;
        set_key(A.pst, ps, g.p.ts, 0);
        undo[19] = ps;
      } else if ((g.dr.flags & AF_HISTORY) || (g.cr.flags & AF_HISTORY)) {
        const long long h = *A.hist_count;
        const u128 ids[2] = {dr_id, cr_id};
        write_history(A.hist, A.hist_cap, h, g, ids, w, wc, ev_ts);
        *A.hist_count = h + 1;
        undo[20] = 1;
      }
    }
  }
  A.codes[i] = (int32_t)code;

  // Chain break: roll back chain_start..i-1 in reverse
  // (state_machine.zig:1051-1066).
  if (code != 0 && in_chain && !ch->broken) {
    for (int64_t j = i - 1; j >= ch->start; --j) {
      const uint64_t* u = A.undo + j * UNDO_WORDS;
      for (int leg = 1; leg >= 0; --leg) {
        if (u[leg] < SEQ_SENT) store_words(A.acc, u[leg], u + 2 + 8 * leg);
      }
      if (u[18] < SEQ_SENT) tombstone_row(A.xfr, u[18]);
      if (u[19] < SEQ_SENT) tombstone_row(A.pst, u[19]);
      *A.hist_count -= (long long)u[20];
    }
    ch->broken = true;
  }
  // Chain termination (state_machine.zig:1074-1082).
  if (in_chain && (!linked || chain_open_err)) {
    ch->start = -1;
    ch->broken = false;
  }
  return code;
}

// The sequencer block: warp 0's lane 0 walks the events; SEQ_W stager warps
// stage them into a ring of SEQ_D slots, stager i the events e with
// e % SEQ_W == i (event e in slot e % SEQ_D); the writer warp stores each
// event's effects to device memory, in event order, from the slot's request.
// A slot's three mbarriers: full (the stager filled it), done (the
// sequencer wrote the request), empty (the writer stored it, so every
// effect of the events up to this one is in device memory).  Warps 4 and 8
// share warp 0's scheduler and only wait at the end, so that no warp takes
// issue slots from the sequencer; the stagers and the writer sleep between
// their barrier tries.
#define SEQ_D 16
#define SEQ_W 8
#define SEQ_WRITER 11
#define SEQ_THREADS (32 * 12)
#define NONE16 0xFFFFu
#define NONE32 0xFFFFFFFFu
#define ALIVE 0x80000000u
#define VOIDED 0x40000000u

// Cycle counters of the sequencer's block, compiled in only where
// SEQ_CYCLES is defined (tools/seq_cycles.py builds such a copy of the
// library; the port's own has none): clock64 spans, summed over a launch
// and read with tb_seq_cycles.  The sequencer's phases nest CY_FLUSH (its
// waits for the writer before a read of device memory).
#ifdef SEQ_CYCLES
enum SeqCycle {
  CY_WAIT,        // the sequencer waiting for a staged record
  CY_GATHER,      // fast_event up to the ladder: the pending row, the
                  // accounts' balances, the stored transfer, the posted row
  CY_LADDER,      // dynamic_code
  CY_APPLY,       // the request: new balances, placement, overlay writes
  CY_ROLLBACK,    // a chain's rollback
  CY_FLUSH,       // waits for the writer inside the phases above
  CY_FLUSHES,     // how many such waits (a count, not cycles)
  CY_SERIAL,      // serial mode's events
  CY_STAGE_WAIT,  // stager warps waiting for a ring slot (summed over warps)
  CY_STAGE_WORK,  // stager warps copying a record and its staged words
  CY_WRITE_WAIT,  // the writer waiting for a request
  CY_WRITE_WORK,  // the writer storing a request
  CY_LOOP,        // the sequencer's whole walk (its clock, for the rate)
  CY_N
};
__device__ unsigned long long seq_cycles[CY_N];
#define CY_NOW(t) const long long t = clock64()
#define CY_ADD(acc, k, t) ((acc)[k] += (unsigned long long)(clock64() - (t)))
#define CY_DECL(acc) unsigned long long acc[CY_N] = {}
#define CY_PUBLISH(acc)                                        \
  for (int k_ = 0; k_ < CY_N; ++k_)                            \
    if ((acc)[k_]) atomicAdd(&seq_cycles[k_], (acc)[k_])
#else
#define CY_NOW(t)
#define CY_ADD(acc, k, t)
#define CY_DECL(acc)
#define CY_PUBLISH(acc)
#endif

// Staged mutable words (Stage::mut): the dense balances of the event's
// debit and credit legs, and the key and tombstone words at its two
// pre-batch free slots (transfers, posted), read after event e - SEQ_D.
enum StagedWord {
  M_DR = 0, M_CR = 8, M_EKEY_LO = 16, M_EKEY_HI, M_ETOMB, M_KKEY_LO, M_KKEY_HI,
  M_KTOMB
};

// An event's writes (Stage::req): what the sequencer decided; the writer
// warp composes the rows from these and the slot's record, and stores them.
// The requests of the window's events are also the window the sequencer
// forwards from (what event w wrote is in slot w % SEQ_D until event
// w + SEQ_D takes the slot).
enum ReqWord {
  Q_FLAGS,            // QF_* below
  Q_DD, Q_CD,         // the legs' dense indices
  Q_W = 4,            // the debit leg's new balances, 8 words (16-B aligned)
  Q_WC = 12,          // the credit leg's, 8 words
  Q_TSLOT = 20, Q_EFF_LO, Q_EFF_HI,  // the transfer's slot and amount
  Q_PSLOT, Q_PKEY,    // the posted row's slot and key
  Q_HIDX,             // the history row's index
  // The pending row's fields, where it is not the record's (QF_PSLOW).
  Q_P_DR_LO, Q_P_DR_HI, Q_P_CR_LO, Q_P_CR_HI, Q_P_UD128_LO, Q_P_UD128_HI,
  Q_P_UD64, Q_P_UD32, Q_P_LEDGER, Q_P_CODE,
  Q_UNDO,             // the undo record, UNDO_WORDS (linked events only)
  Q_N = Q_UNDO + UNDO_WORDS
};
#define QF_APPLIED 1ull
#define QF_POSTED 2ull
#define QF_HIST 4ull
#define QF_UNDO 8ull
#define QF_PSLOW 16ull

struct __align__(16) Stage {
  uint64_t rec[REC_WORDS];
  uint64_t mut[32];
  uint64_t req[Q_N + 1];
};
// bal_of reads eight balance words as four 16-B loads.
static_assert(Q_W % 2 == 0 && Q_WC % 2 == 0 && M_CR % 2 == 0 &&
                  REC_WORDS % 2 == 0 && sizeof(Stage) % 16 == 0 &&
                  SEQ_D % 2 == 0,
              "words read in 16-B pairs must be 16-B aligned");

struct SeqShared {
  uint64_t full[SEQ_D], done[SEQ_D], empty[SEQ_D];  // mbarriers
  // The transfer and posted slots event e inserted at [e % SEQ_D] (SEQ_SENT
  // where none): the window's inserts, as 16-B pairs.
  uint64_t recent_t[SEQ_D], recent_p[SEQ_D];
  Stage ring[SEQ_D];
  uint32_t ins_slot[SEQ_MAX_N];  // transfer slot event j inserted | ALIVE
  uint32_t pst_slot[SEQ_MAX_N];  // posted slot event j inserted | ALIVE | VOIDED
  uint16_t lastw[2 * SEQ_MAX_N]; // last event that wrote a dense account
  uint16_t ins_last[SEQ_MAX_N];  // per id group: its latest inserting event
  uint16_t pst_last[SEQ_MAX_N];  // per posted-key group: its latest inserting event
  uint8_t scode[SEQ_MAX_N];      // raw code | 0x80 where linked
  int wrote_back;
};

static __device__ __forceinline__ Bal bal_of(const uint64_t* w) {
  const ulonglong2* v = reinterpret_cast<const ulonglong2*>(w);
  const ulonglong2 a = v[0], b = v[1], c = v[2], d = v[3];
  Bal r;
  r.dp = mk128(a.x, a.y);
  r.dpo = mk128(b.x, b.y);
  r.cp = mk128(c.x, c.y);
  r.cpo = mk128(d.x, d.y);
  return r;
}

// The sequencer's registers.
struct SeqState {
  Chain ch;
  uint64_t xcount, pcount;
  long long h;
  int64_t last_rb;  // event of the last rollback, -1 before any
  int64_t stored;   // events whose effects are known stored (-1: none)
  bool serial;      // a capped insert switched the rest of the batch
  bool pst_dirty;   // a posted insert the posted-key groups do not know
#ifdef SEQ_CYCLES
  unsigned long long cy[CY_N];
#endif
};

// Make every effect of the events before e visible in device memory before
// the sequencer reads it there (a slow path): wait for the writer.
static __device__ void flush_before(SeqShared& S, int64_t e, SeqState& q) {
  const int64_t x = e - 1;
  if (x <= q.stored) return;
  CY_NOW(t0);
  mbar_wait(&S.empty[x % SEQ_D], (uint32_t)((x / SEQ_D) & 1));
  q.stored = x;
  CY_ADD(q.cy, CY_FLUSH, t0);
#ifdef SEQ_CYCLES
  q.cy[CY_FLUSHES] += 1;
#endif
}

// The current balances of dense account d at event e: the staged copy
// (read after the effects of event e - SEQ_D were stored) unless an event
// of the window (e - SEQ_D, e) wrote d (forwarded from the window) or a
// rollback ran in the window (read from device memory).
static __device__ Bal cur_bal(const SeqTransferArgs& A, SeqShared& S,
                              int64_t e, uint32_t d, const uint64_t* staged,
                              SeqState& q) {
  if (!(q.last_rb >= 0 && e - q.last_rb < SEQ_D)) {
    const uint32_t w = S.lastw[d];
    if (w != NONE16 && e - (int64_t)w < SEQ_D) {
      const uint64_t* wq = S.ring[w % SEQ_D].req;
      return bal_of(wq[Q_CD] == d ? wq + Q_WC : wq + Q_W);
    }
    if (staged) return bal_of(staged);
  }
  flush_before(S, e, q);
  return bal_of(A.bal + (uint64_t)d * 8);
}

// Whether an event of the window inserted at `slot` (the current event's
// entry holds SEQ_SENT until it inserts).
static __device__ bool inserted_in_window(const SeqShared& S, uint64_t slot,
                                          bool posted) {
  const ulonglong2* v =
      reinterpret_cast<const ulonglong2*>(posted ? S.recent_p : S.recent_t);
  bool hit = false;
#pragma unroll
  for (int k = 0; k < SEQ_D / 2; ++k) {
    const ulonglong2 x = v[k];
    hit |= (x.x == slot) | (x.y == slot);
  }
  return hit;
}

// The insert slot of a key whose pre-batch probe ended at the truly empty
// slot f0 after t0 steps: f0 while it is still truly empty (its staged words
// say so and no event of the window inserted there), else the walk on from
// f0 through the table in device memory.
static __device__ uint64_t place(const DevTable& T, SeqShared& S, int64_t e,
                                 uint64_t lo, uint64_t hi, uint64_t f0,
                                 uint64_t t0, const uint64_t* staged,
                                 bool posted, SeqState& q, bool* capped) {
  if (staged[0] == 0 && staged[1] == 0 && staged[2] == 0 &&
      !inserted_in_window(S, f0, posted)) {
    *capped = false;
    return f0;
  }
  flush_before(S, e, q);
  return free_from(T, mix64(lo, hi) & T.mask, t0, capped);
}

static __device__ __forceinline__ void put_bal(uint64_t* dst, const uint64_t* w) {
  for (int k = 0; k < 8; ++k) dst[k] = w[k];
}

// Fast mode: one event from its staged record and the overlay; its writes
// go into the slot's request.
static __device__ uint32_t fast_event(const SeqTransferArgs& A, SeqShared& S,
                                      int64_t e, Stage& st, SeqState& q) {
  const uint64_t* __restrict__ r = st.rec;
  uint64_t* req = st.req;
  req[Q_FLAGS] = 0;
  S.recent_t[e % SEQ_D] = S.recent_p[e % SEQ_D] = SEQ_SENT;
  Ev v;
  ev_from_rec(r, &v);
  const bool linked = v.flags & TF_LINKED;
  // Only a linked event's undo record is ever read (a chain's events are
  // all linked), so only a linked event's is written.
  uint64_t* undo = req + Q_UNDO;
  if (linked) {
    undo[0] = undo[1] = undo[18] = undo[19] = SEQ_SENT;
    undo[20] = 0;
    req[Q_FLAGS] = QF_UNDO;
  }
  if (linked && q.ch.start < 0) q.ch.start = e;
  const bool in_chain = q.ch.start >= 0;
  const bool chain_open_err = linked && e == A.count - 1;
  const uint64_t ev_ts = A.timestamp - (uint64_t)A.count + 1 + (uint64_t)e;
  const uint64_t bits = r[R_BITS];
  uint32_t code = 0;
  if (chain_open_err) code = 2;
  else if (q.ch.broken) code = 1;
  else if (v.ts != 0) code = 3;
  else code = (uint32_t)r[R_SCODE];  // the static checks, from K32
  CY_NOW(t_gather);
  if (code == 0) {
    const bool postvoid = v.flags & (TF_POST | TF_VOID);
    Gathered g = {};
    const uint64_t* legs = r;  // whose account legs: this record or j's
    bool p_slow = false;
    // The pending transfer: found before the batch, or the live row of the
    // latest event of its id group that inserted one.
    if (postvoid && (bits & RB_PFOUND)) {
      g.p_found = true;
    } else if (postvoid && r[R_PEND_GRP] != SEQ_NONE) {
      const uint32_t grp = (uint32_t)r[R_PEND_GRP];
      const uint32_t j = S.ins_last[grp];
      if (j != NONE16 && (S.ins_slot[j] & ALIVE)) {
        g.p_found = true;
        const uint64_t ps = S.ins_slot[j] & ~ALIVE;
        if (j == grp && (bits & RB_PCAND)) {
          if (bits & RB_PCLAMP) {  // the stored amount may be clamped
            flush_before(S, e, q);
            g.p.amount = mk128(C64(A.xfr, TT_AMOUNT_LO)[ps], C64(A.xfr, TT_AMOUNT_HI)[ps]);
          }
        } else {
          p_slow = true;
          flush_before(S, e, q);
          g.p = row_at(A.xfr, ps);
          legs = A.rec + (uint64_t)j * REC_WORDS;
        }
      }
    }
    if (g.p_found && !p_slow) {
      g.p.flags = (uint32_t)r[R_P_FLAGS_TIMEOUT];
      g.p.timeout = (uint32_t)(r[R_P_FLAGS_TIMEOUT] >> 32);
      g.p.ledger = (uint32_t)r[R_P_LEDGER_CODE];
      g.p.code = (uint32_t)(r[R_P_LEDGER_CODE] >> 32);
      g.p.ud32 = (uint32_t)r[R_P_UD32];
      g.p.ts = r[R_P_TS];
      g.p.ud64 = r[R_P_UD64];
      g.p.ud128_lo = r[R_P_UD128_LO];
      g.p.ud128_hi = r[R_P_UD128_HI];
      if (!(bits & RB_PCLAMP))
        g.p.amount = mk128(r[R_P_AMOUNT_LO], r[R_P_AMOUNT_HI]);
      g.p.dr_id = mk128(r[R_P_DR_LO], r[R_P_DR_HI]);
      g.p.cr_id = mk128(r[R_P_CR_LO], r[R_P_CR_HI]);
    }
    // The accounts: slots and flags from the pre-pass, balances current.
    uint32_t dd = NONE32, cd = NONE32;
    const uint64_t lbits = legs[R_BITS];
    if ((lbits & RB_LEGS) && (!postvoid || g.p_found)) {
      dd = (uint32_t)legs[R_DR_DENSE];
      cd = (uint32_t)legs[R_CR_DENSE];
      g.dr.found = lbits & RB_DRF;
      g.cr.found = lbits & RB_CRF;
      g.dr.slot = legs[R_DR_SLOT];
      g.cr.slot = legs[R_CR_SLOT];
      g.dr.flags = (uint32_t)legs[R_DR_FL];
      g.dr.ledger = (uint32_t)(legs[R_DR_FL] >> 32);
      g.cr.flags = (uint32_t)legs[R_CR_FL];
      g.cr.ledger = (uint32_t)(legs[R_CR_FL] >> 32);
      if (g.dr.found)
        g.dr.b = cur_bal(A, S, e, dd, p_slow ? nullptr : st.mut + M_DR, q);
      if (g.cr.found)
        g.cr.b = cur_bal(A, S, e, cd, p_slow ? nullptr : st.mut + M_CR, q);
    }
    // A stored transfer with this id: before the batch, or the live row of
    // the latest event of the id group that inserted one.
    if (bits & RB_EFOUND) {
      g.e_found = true;
      g.e.flags = (uint32_t)r[R_E_FLAGS_TIMEOUT];
      g.e.timeout = (uint32_t)(r[R_E_FLAGS_TIMEOUT] >> 32);
      g.e.code = (uint32_t)r[R_E_CODE_UD32];
      g.e.ud32 = (uint32_t)(r[R_E_CODE_UD32] >> 32);
      g.e.dr_id = mk128(r[R_E_DR_LO], r[R_E_DR_HI]);
      g.e.cr_id = mk128(r[R_E_CR_LO], r[R_E_CR_HI]);
      g.e.amount = mk128(r[R_E_AMOUNT_LO], r[R_E_AMOUNT_HI]);
      g.e.pending_id = mk128(r[R_E_PENDING_LO], r[R_E_PENDING_HI]);
      g.e.ud128_lo = r[R_E_UD128_LO];
      g.e.ud128_hi = r[R_E_UD128_HI];
      g.e.ud64 = r[R_E_UD64];
    } else {
      const uint32_t j = S.ins_last[(uint32_t)r[R_ID_GRP]];
      if (j != NONE16 && (S.ins_slot[j] & ALIVE)) {
        g.e_found = true;
        flush_before(S, e, q);
        g.e = row_at(A.xfr, S.ins_slot[j] & ~ALIVE);
      }
    }
    // The posted row of the pending's timestamp.
    const bool pst_walk = postvoid && g.p_found && (p_slow || q.pst_dirty);
    if (pst_walk) {
      uint64_t posted_slot, posted_free;
      bool posted_capped;
      flush_before(S, e, q);
      g.posted_found = probe_key(A.pst, g.p.ts, 0, &posted_slot, &posted_free, &posted_capped);
      g.posted_val = g.posted_found ? C32(A.pst, 0)[posted_slot] : 0;
    } else if (postvoid && g.p_found) {
      if (bits & RB_KFOUND) {
        g.posted_found = true;
        g.posted_val = (uint32_t)r[R_KVAL];
      } else {
        const uint32_t j = S.pst_last[r[R_KGRP] >> 1];
        if (j != NONE16 && (S.pst_slot[j] & ALIVE)) {
          g.posted_found = true;
          g.posted_val = (S.pst_slot[j] & VOIDED) ? 2 : 1;
        }
      }
    }
    u128 eff;
    CY_ADD(q.cy, CY_GATHER, t_gather);
    CY_NOW(t_ladder);
    code = dynamic_code(v, ev_ts, g, &eff);
    CY_ADD(q.cy, CY_LADDER, t_ladder);

    CY_NOW(t_apply);
    if (code == 0) {  // _apply_transfer, as the slot's request
      Bal ndr, ncr;
      new_balances(v, g, eff, &ndr, &ncr);
      uint64_t* w = req + Q_W;
      uint64_t* wc = req + Q_WC;
      bal_words(ndr, w);
      bal_words(ncr, wc);
      req[Q_DD] = dd;
      req[Q_CD] = cd;
      if (linked) {
        undo[0] = g.dr.slot;
        undo[1] = g.cr.slot;
        undo[21] = dd;
        undo[22] = cd;
        bal_words(g.dr.b, undo + 2);
        bal_words(g.cr.b, undo + 10);
      }
      S.lastw[dd] = (uint16_t)e;
      S.lastw[cd] = (uint16_t)e;
      // Transfer insert at the first truly empty slot of its probe.
      bool capped = bits & RB_ECAP;
      uint64_t s = 0;
      if (!capped)
        s = place(A.xfr, S, e, v.id_lo, v.id_hi, r[R_ESLOT], r[R_ET],
                  st.mut + M_EKEY_LO, false, q, &capped);
      if (capped) {
        s = 0;
        *A.overflow = 1;
        q.serial = true;
      }
      req[Q_TSLOT] = s;
      req[Q_EFF_LO] = lo64(eff);
      req[Q_EFF_HI] = hi64(eff);
      uint64_t flags = req[Q_FLAGS] | QF_APPLIED;
      if (p_slow) {  // the pending row's fields the transfer row copies
        flags |= QF_PSLOW;
        req[Q_P_DR_LO] = lo64(g.p.dr_id);
        req[Q_P_DR_HI] = hi64(g.p.dr_id);
        req[Q_P_CR_LO] = lo64(g.p.cr_id);
        req[Q_P_CR_HI] = hi64(g.p.cr_id);
        req[Q_P_UD128_LO] = g.p.ud128_lo;
        req[Q_P_UD128_HI] = g.p.ud128_hi;
        req[Q_P_UD64] = g.p.ud64;
        req[Q_P_UD32] = g.p.ud32;
        req[Q_P_LEDGER] = g.p.ledger;
        req[Q_P_CODE] = g.p.code;
      }
      q.xcount += 1;
      if (linked) undo[18] = s;
      S.recent_t[e % SEQ_D] = s;
      S.ins_slot[e] = (uint32_t)s | ALIVE;
      S.ins_last[(uint32_t)r[R_ID_GRP]] = (uint16_t)e;
      if (postvoid) {
        uint64_t ps = 0;
        bool pcapped = false;
        if (pst_walk || (bits & RB_KFOUND)) {
          flush_before(S, e, q);
          ps = sprobe_free(A.pst, g.p.ts, 0, &pcapped);
          q.pst_dirty |= pst_walk;
        } else if (bits & RB_KCAP) {
          pcapped = true;
        } else {
          ps = place(A.pst, S, e, g.p.ts, 0, r[R_KSLOT], r[R_KT],
                     st.mut + M_KKEY_LO, true, q, &pcapped);
        }
        if (pcapped) {
          ps = 0;
          *A.overflow = 1;
          q.serial = true;
        }
        const bool post = v.flags & TF_POST;
        req[Q_PSLOT] = ps;
        req[Q_PKEY] = g.p.ts;
        flags |= QF_POSTED;
        q.pcount += 1;
        if (linked) undo[19] = ps;
        S.recent_p[e % SEQ_D] = ps;
        S.pst_slot[e] = (uint32_t)ps | ALIVE | (post ? 0u : VOIDED);
        if (!pst_walk) S.pst_last[r[R_KGRP] >> 1] = (uint16_t)e;
      } else if ((g.dr.flags & AF_HISTORY) || (g.cr.flags & AF_HISTORY)) {
        // History append (state_machine.zig:1342-1364); a row past the
        // capacity is dropped while count still advances.
        if (q.h < A.hist_cap) {
          req[Q_HIDX] = (uint64_t)q.h;
          flags |= QF_HIST;
        }
        q.h += 1;
        if (linked) undo[20] = 1;
      }
      req[Q_FLAGS] = flags;
    }
    CY_ADD(q.cy, CY_APPLY, t_apply);
  }

  // Chain break: roll back chain_start..e-1 in reverse, in the dense
  // balances and the overlay, once the writer has stored their effects.
  if (code != 0 && in_chain && !q.ch.broken) {
    CY_NOW(t_rb);
    flush_before(S, e, q);
    for (int64_t j = e - 1; j >= q.ch.start; --j) {
      const uint64_t* u = A.undo + j * UNDO_WORDS;
      if (u[1] < SEQ_SENT) put_bal(A.bal + u[22] * 8, u + 10);
      if (u[0] < SEQ_SENT) put_bal(A.bal + u[21] * 8, u + 2);
      if (u[18] < SEQ_SENT) {
        tombstone_slot(A.xfr.key_lo, A.xfr.key_hi, A.xfr.tomb, u[18]);
        q.xcount -= 1;
        S.ins_slot[j] &= ~ALIVE;
      }
      if (u[19] < SEQ_SENT) {
        tombstone_slot(A.pst.key_lo, A.pst.key_hi, A.pst.tomb, u[19]);
        q.pcount -= 1;
        S.pst_slot[j] &= ~ALIVE;
      }
      q.h -= (long long)u[20];
    }
    q.ch.broken = true;
    q.last_rb = e;
    CY_ADD(q.cy, CY_ROLLBACK, t_rb);
  }
  if (in_chain && (!linked || chain_open_err)) {
    q.ch.start = -1;
    q.ch.broken = false;
  }
  return code;
}

// Word k of the transfer row event e stores (write_row's values), from its
// record r and request q.
static __device__ uint64_t row_word(int k, const uint64_t* r,
                                    const uint64_t* q, uint64_t ev_ts) {
  const bool pv = r[R_V_FLAGS] & (TF_POST | TF_VOID);
  const bool ps = q[Q_FLAGS] & QF_PSLOW;
  const uint32_t ud32 = (uint32_t)r[R_V_UD32_TIMEOUT];
  const bool ud128_zero = r[R_V_UD128_LO] == 0 && r[R_V_UD128_HI] == 0;
  switch (k) {
    case TT_DEBIT_ACCOUNT_ID_LO: return pv ? (ps ? q[Q_P_DR_LO] : r[R_P_DR_LO]) : r[R_V_DR_LO];
    case TT_DEBIT_ACCOUNT_ID_HI: return pv ? (ps ? q[Q_P_DR_HI] : r[R_P_DR_HI]) : r[R_V_DR_HI];
    case TT_CREDIT_ACCOUNT_ID_LO: return pv ? (ps ? q[Q_P_CR_LO] : r[R_P_CR_LO]) : r[R_V_CR_LO];
    case TT_CREDIT_ACCOUNT_ID_HI: return pv ? (ps ? q[Q_P_CR_HI] : r[R_P_CR_HI]) : r[R_V_CR_HI];
    case TT_AMOUNT_LO: return q[Q_EFF_LO];
    case TT_AMOUNT_HI: return q[Q_EFF_HI];
    case TT_PENDING_ID_LO: return r[R_V_PENDING_LO];
    case TT_PENDING_ID_HI: return r[R_V_PENDING_HI];
    case TT_USER_DATA_128_LO:
      return (pv && ud128_zero) ? (ps ? q[Q_P_UD128_LO] : r[R_P_UD128_LO]) : r[R_V_UD128_LO];
    case TT_USER_DATA_128_HI:
      return (pv && ud128_zero) ? (ps ? q[Q_P_UD128_HI] : r[R_P_UD128_HI]) : r[R_V_UD128_HI];
    case TT_USER_DATA_64:
      return (pv && r[R_V_UD64] == 0) ? (ps ? q[Q_P_UD64] : r[R_P_UD64]) : r[R_V_UD64];
    case TT_USER_DATA_32:
      return (pv && ud32 == 0) ? (ps ? q[Q_P_UD32] : (uint32_t)r[R_P_UD32]) : ud32;
    case TT_TIMEOUT: return pv ? 0 : r[R_V_UD32_TIMEOUT] >> 32;
    case TT_LEDGER:
      return pv ? (ps ? q[Q_P_LEDGER] : (uint32_t)r[R_P_LEDGER_CODE])
                : (uint32_t)r[R_V_LEDGER_CODE];
    case TT_CODE:
      return pv ? (ps ? q[Q_P_CODE] : r[R_P_LEDGER_CODE] >> 32) : r[R_V_LEDGER_CODE] >> 32;
    case TT_FLAGS: return r[R_V_FLAGS];
    default: return ev_ts;  // TT_TIMESTAMP
  }
}

// Word k of the history row event e appends (state_machine.zig:1342-1364:
// a side without the history flag stays zero).
static __device__ uint64_t hist_word(int k, const uint64_t* r,
                                     const uint64_t* q, uint64_t ev_ts) {
  if (k == H_TIMESTAMP) return ev_ts;
  const int side = k / 10, j = k % 10;
  if (!((uint32_t)r[side ? R_CR_FL : R_DR_FL] & AF_HISTORY)) return 0;
  if (j < 2) return r[(side ? R_V_CR_LO : R_V_DR_LO) + j];
  return q[(side ? Q_WC : Q_W) + j - 2];
}

// The writer warp: the request of event e, composed with its record and
// stored by the 32 lanes.
static __device__ void store_request(const SeqTransferArgs& A, int64_t e,
                                     const Stage& st, int lane) {
  const uint64_t* q = st.req;
  const uint64_t* r = st.rec;
  const uint64_t flags = q[Q_FLAGS];
  if (flags & QF_APPLIED) {
    const uint64_t ev_ts = A.timestamp - (uint64_t)A.count + 1 + (uint64_t)e;
    const uint64_t dd = q[Q_DD], cd = q[Q_CD];
    // Both legs on one account: the credit leg's words are the last ones.
    if (lane < 8 && dd != cd) A.bal[dd * 8 + lane] = q[Q_W + lane];
    if (lane >= 8 && lane < 16) A.bal[cd * 8 + lane - 8] = q[Q_WC + lane - 8];
    const uint64_t s = q[Q_TSLOT];
    for (int k = lane - 16; k < TT_N + 3; k += 32) {
      if (k < 0) continue;
      if (k < TT_N) {
        const uint64_t v = row_word(k, r, q, ev_ts);
        if (k == TT_USER_DATA_32 || k == TT_TIMEOUT || k == TT_LEDGER ||
            k == TT_CODE || k == TT_FLAGS)
          C32(A.xfr, k)[s] = (uint32_t)v;
        else
          C64(A.xfr, k)[s] = v;
      } else if (k == TT_N) {
        A.xfr.key_lo[s] = r[R_V_ID_LO];
      } else if (k == TT_N + 1) {
        A.xfr.key_hi[s] = r[R_V_ID_HI];
      } else {
        A.xfr.tomb[s] = 0;
      }
    }
    if (flags & QF_POSTED) {
      const uint64_t ps = q[Q_PSLOT];
      if (lane == 4) A.pst.key_lo[ps] = q[Q_PKEY];
      if (lane == 5) A.pst.key_hi[ps] = 0;
      if (lane == 6) A.pst.tomb[ps] = 0;
      if (lane == 7) C32(A.pst, 0)[ps] = (r[R_V_FLAGS] & TF_POST) ? 1u : 2u;
    }
    if ((flags & QF_HIST) && lane < H_N) A.hist[lane][q[Q_HIDX]] = hist_word(lane, r, q, ev_ts);
  }
  if ((flags & QF_UNDO) && lane < UNDO_WORDS)
    A.undo[e * UNDO_WORDS + lane] = q[Q_UNDO + lane];
}

// Write the dense balances back to the accounts table: threads t, t +
// stride, ... of the caller.
static __device__ void write_back(const SeqTransferArgs& A, int64_t t,
                                  int64_t stride) {
  for (int64_t d = t; d < 2 * A.n; d += stride) {
    const uint64_t slot = A.dslot[d];
    if (slot == SEQ_NONE) continue;
    store_words(A.acc, slot, A.bal + d * 8);
  }
}

// _chain_codes over the raw codes in shared memory (sc[i] & 0x7F, linked
// where 0x80), as chain_codes does over device memory.
static __device__ void chain_codes_shared(uint8_t* sc, int64_t n,
                                          int64_t count) {
  auto linked = [&](int64_t i) { return i < count && (sc[i] & 0x80) != 0; };
  auto code_o = [&](int64_t i) {
    return (i == count - 1 && linked(i)) ? 2 : (sc[i] & 0x7F);
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
      int c;
      if (f < 0 || j == f) c = code_o(j);
      else if (j < f) c = 1;
      else c = (j == count - 1 && linked(j)) ? 2 : 1;
      sc[j] = (uint8_t)((sc[j] & 0x80) | c);
    }
    i = e + 1;
  }
}

__global__ void __launch_bounds__(SEQ_THREADS)
seq_transfers_kernel(SeqTransferArgs A) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  SeqShared& S = *reinterpret_cast<SeqShared*>(seq_dyn_smem());
  for (int64_t k = threadIdx.x; k < 2 * SEQ_MAX_N; k += blockDim.x) {
    S.lastw[k] = NONE16;
    if (k < SEQ_MAX_N) {
      S.ins_last[k] = NONE16;
      S.pst_last[k] = NONE16;
      S.scode[k] = 0;
    }
  }
  if (threadIdx.x < SEQ_D) {
    mbar_init(&S.full[threadIdx.x], 32);
    mbar_init(&S.done[threadIdx.x], 1);
    mbar_init(&S.empty[threadIdx.x], 32);
    S.ring[threadIdx.x].req[Q_FLAGS] = 0;
    S.recent_t[threadIdx.x] = S.recent_p[threadIdx.x] = SEQ_SENT;
  }
  if (threadIdx.x == 0) S.wrote_back = 0;
  __syncthreads();

  if (warp < SEQ_WRITER && warp % 4 != 0) {
    // A stager: copy the record in (cp.async), then read the words the
    // sequencer may have changed, once event e - SEQ_D's effects are stored.
    CY_DECL(cy);
    for (int64_t e = warp - 1 - warp / 4; e < A.count; e += SEQ_W) {
      const int s = (int)(e % SEQ_D);
      Stage& st = S.ring[s];
      const int64_t k = e / SEQ_D;
      CY_NOW(t_wait);
      if (k > 0) mbar_wait(&S.empty[s], (uint32_t)((k - 1) & 1), 256);
      CY_ADD(cy, CY_STAGE_WAIT, t_wait);
      CY_NOW(t_work);
      cp_async16(&st.rec[2 * lane], A.rec + e * REC_WORDS + 2 * lane);
      cp_async_wait_all();
      __syncwarp();
      const uint64_t bits = st.rec[R_BITS];
      uint64_t val = 0;
      if (lane < 16) {
        const uint64_t d = st.rec[lane < 8 ? R_DR_DENSE : R_CR_DENSE];
        if ((bits & RB_LEGS) && d != SEQ_NONE) val = ld_cg_u64(A.bal + d * 8 + (lane & 7));
      } else if (lane < 19) {
        if (!(bits & (RB_EFOUND | RB_ECAP))) {
          const uint64_t slot = st.rec[R_ESLOT];
          val = lane == M_EKEY_LO ? ld_cg_u64(A.xfr.key_lo + slot)
              : lane == M_EKEY_HI ? ld_cg_u64(A.xfr.key_hi + slot)
                                  : ld_cg_u8(A.xfr.tomb + slot);
        }
      } else if (lane < 22) {
        if ((bits & RB_KKEY) && !(bits & (RB_KFOUND | RB_KCAP))) {
          const uint64_t slot = st.rec[R_KSLOT];
          val = lane == M_KKEY_LO ? ld_cg_u64(A.pst.key_lo + slot)
              : lane == M_KKEY_HI ? ld_cg_u64(A.pst.key_hi + slot)
                                  : ld_cg_u8(A.pst.tomb + slot);
        }
      }
      st.mut[lane] = val;
      mbar_arrive(&S.full[s]);
      CY_ADD(cy, CY_STAGE_WORK, t_work);
    }
    if (lane == 0) CY_PUBLISH(cy);
  } else if (warp == SEQ_WRITER) {
    // The writer: each event's request, in event order.
    CY_DECL(cy);
    for (int64_t e = 0; e < A.count; ++e) {
      const int s = (int)(e % SEQ_D);
      CY_NOW(t_wait);
      mbar_wait(&S.done[s], (uint32_t)((e / SEQ_D) & 1), 64);
      CY_ADD(cy, CY_WRITE_WAIT, t_wait);
      CY_NOW(t_work);
      store_request(A, e, S.ring[s], lane);
      __syncwarp();
      mbar_arrive(&S.empty[s]);
      CY_ADD(cy, CY_WRITE_WORK, t_work);
    }
    if (lane == 0) CY_PUBLISH(cy);
  } else if (warp == 0 && lane == 0) {
    SeqState q;
    q.ch.start = -1;
    q.ch.broken = false;
    q.xcount = (uint64_t)*A.xfr.count;
    q.pcount = (uint64_t)*A.pst.count;
    q.h = *A.hist_count;
    q.last_rb = -1;
    q.stored = -1;
    q.serial = false;
    q.pst_dirty = false;
#ifdef SEQ_CYCLES
    for (int k = 0; k < CY_N; ++k) q.cy[k] = 0;
#endif
    CY_NOW(t_loop);
    for (int64_t e = 0; e < A.count; ++e) {
      const int s = (int)(e % SEQ_D);
      Stage& st = S.ring[s];
      CY_NOW(t_wait);
      mbar_wait(&S.full[s], (uint32_t)((e / SEQ_D) & 1));
      CY_ADD(q.cy, CY_WAIT, t_wait);
      uint32_t code;
      bool switched = false;
      if (!q.serial) {
        code = fast_event(A, S, e, st, q);
        switched = q.serial;
      } else {
        CY_NOW(t_serial);
        st.req[Q_FLAGS] = 0;
        code = serial_event(A, e, &q.ch);
        CY_ADD(q.cy, CY_SERIAL, t_serial);
      }
      const uint32_t flags = (uint32_t)st.rec[R_V_FLAGS];
      S.scode[e] = (uint8_t)(code | ((flags & TF_LINKED) ? 0x80u : 0u));
      mbar_arrive(&S.done[s]);
      if (switched) {  // a capped insert: the rest as the serial kernel
        flush_before(S, e + 1, q);
        *A.xfr.count = (long long)q.xcount;
        *A.pst.count = (long long)q.pcount;
        *A.hist_count = q.h;
        write_back(A, 0, 1);
        S.wrote_back = 1;
      }
    }
    if (!S.wrote_back) {
      *A.xfr.count = (long long)q.xcount;
      *A.pst.count = (long long)q.pcount;
      *A.hist_count = q.h;
    }
    chain_codes_shared(S.scode, A.n, A.count);
    CY_ADD(q.cy, CY_LOOP, t_loop);
    CY_PUBLISH(q.cy);
  }
  __syncthreads();
  for (int64_t i = threadIdx.x; i < A.n; i += blockDim.x)
    A.codes[i] = (int32_t)(S.scode[i] & 0x7F);  // the chain pass may
                                                // reach past count
  if (!S.wrote_back) write_back(A, threadIdx.x, blockDim.x);
}

// ---------------------------------------------------------------------------
// K7 seq_accounts
// ---------------------------------------------------------------------------
//
// K7 is K6's two steps for accounts: most of a create_accounts batch does
// not depend on event order, so a wide pre-pass decides it and a sequencer
// decides only what does.
//
// 1. The pre-pass, one thread an event over the card (two launches):
//    - seqa_probe_kernel: the event's static code (3-14, in the ladder's
//      order; they read only the event), and for an event that passes them
//      its probe of the table as it was before the batch: found (the slot,
//      and the exists code 15-21 against the stored row, which no event of
//      the batch moves), capped, or the first truly empty slot F and its
//      step from home.  A candidate inserter (active, static code 0, not
//      found, not capped) puts F into a batch hash of F -> (lowest,
//      highest) candidate (atomicMin / atomicMax: no output depends on
//      which thread claimed the hash slot).
//    - seqa_mark_kernel: a mark on every event the sequencer must decide:
//      a linked event and the event that closes its chain; a capped
//      candidate; a candidate whose F another candidate shares (an id seen
//      twice shares its F, so this is also the in-batch join).  A marked
//      candidate gets G1, the next pre-batch empty slot after F, and G1's
//      candidate if it has exactly one.
// 2. The sequencer, one block.  Its threads list the marked events and
//    stage their records, the mask and an overlay of the batch's inserted
//    slots (slot -> event, live, the id's high hash bits) in shared memory
//    when they fit (about 1,500 marked events; else the records are read
//    and the overlay kept in device memory).  Then thread 0 walks the
//    marked events in order over the mask: the chain state and
//    chain_open_err; the walk from F over the table as the batch has left
//    it: an overlay slot holding a live insert of the same id (its hash
//    bits, then the ids) is `exists` (15-21 against that event's fields), any
//    other overlay slot, or the F of an unmarked candidate that came
//    earlier, is taken; the first free slot is the insert's, and where it
//    is the F of a later unmarked candidate, that candidate is marked (its
//    slot is taken before it comes).  A failing chain event rolls the
//    chain's inserts back in the overlay (live bit cleared) and sets the
//    earlier members' final codes to 1.  Tombstones are never reused: a
//    rolled-back slot stays in the overlay.  Every unmarked event keeps the
//    pre-pass's answer and slot: no earlier event can reach its F unmarked.
//    A walk that reaches MAX_PROBE (a capped insert, which writes slot 0),
//    or an on-chip overlay at half its slots, ends the sequencing: the
//    block writes what is decided, and thread 0
//    runs the rest of the batch as the one-thread loop K7 always was
//    (seqa_serial), then the chain pass over the raw codes.
// 3. seqa_finish_kernel, one thread an event: the final codes and the rows
//    (every inserted slot's columns; the key where the insert stands, the
//    tombstone where it was rolled back), the count by one atomic a block.
//
// Why the sequencer is one thread: what it decides is a chain of
// dependences through the overlay and the chain state, and it decides
// little (at the sequential path's 8,190 new accounts about one event in
// eight, the ones whose F another shares); with the records on chip, an
// event is a few shared-memory probes and two stores, no device-memory
// read on its chain (the first form read its record and the ids from L2:
// about 1,800 cycles an event).  There is no lane limit: the overlay and
// the mask fall back to device memory.
//
// What bounds it on the H100: the pre-pass's probes are random reads (one
// dependent probe an event, in parallel); the sequencer's chain is the
// marked events' shared-memory work, one after another.

#define EV64(k) (static_cast<const uint64_t*>(A.batch[k])[i])
#define EV32(k) (static_cast<const uint32_t*>(A.batch[k])[i])

#define SEQA_THREADS 512   // the sequencer block
#define SEQA_WIDE 256      // the pre-pass and finish blocks
#define SEQA_SMEM (200 * 1024)  // the sequencer's shared memory
#define SEQA_NONE 0xFFFFFFFFu   // no candidate holds this F
#define SEQA_MULTI 0xFFFFFFFEu  // several candidates hold it

// The pre-pass record: four words an event (AR_*), word 0 its bits.
#define AR_WORDS 4
#define AR_STATIC 0x1Full           // the static code: 0 or 3-14
#define AR_EXISTS_SHIFT 8           // bits 8-12: a found id's exists code
#define AR_ACTIVE (1ull << 16)      // e < count
#define AR_LINKED (1ull << 17)      // active and linked
#define AR_FOUND (1ull << 18)       // stored before the batch (word 1: slot)
#define AR_CAPPED (1ull << 19)      // no empty slot within MAX_PROBE
#define AR_CAND (1ull << 20)        // a candidate inserter (word 1: F)
#define AR_G1 (1ull << 21)          // word 2: G1, word 3: G1's candidate
#define AR_TF_SHIFT 32              // bits 32-44: F's step from home
#define AR_TG1_SHIFT 48             // bits 48-60: G1's step (MAX_PROBE: none)
#define AR_STEP 0x1FFFull

// The sequencer's decision of a marked event: raw code, final code, insert.
#define DEC_FINAL_SHIFT 8
#define DEC_INS (1ull << 16)
#define DEC_LIVE (1ull << 17)
#define DEC_SLOT_SHIFT 32

#ifdef TB_PHASE_CLOCK
#define SEQA_BARRIER() __syncthreads()
#else
#define SEQA_BARRIER() \
  do {                 \
  } while (0)
#endif

struct SeqAccountArgs {
  const void* batch[AB_N];
  DevTable acc;
  int64_t n, count;
  uint64_t timestamp;
  uint64_t* rec;   // n x AR_WORDS
  uint64_t* dec;   // n: the marked events' decisions
  uint64_t* undo;  // n: inserted slots (the serial loop's rollbacks)
  uint32_t* fk;    // the F hash: F + 1 (0: free)
  uint32_t* fmi;   // ~(lowest candidate), by atomicMax
  uint32_t* fmx;   // highest candidate + 1
  uint32_t hf_mask;
  uint32_t* marks;  // ceil(n / 32) words
  uint32_t* ovk;    // the overlay in device memory (when the shared one
  uint32_t* ovv;    // does not fit): pow2(2n) slots, cleared by the
  uint32_t* ovh;    // sequencer when it takes them
  uint32_t ovg_mask;
  int64_t* state;  // the event the serial loop took over at (n: none)
  int32_t* codes;
  uint8_t* overflow;
};

static __device__ __forceinline__ uint32_t seqa_hash(uint64_t x,
                                                     uint32_t mask) {
  return (uint32_t)((x * 0x9E3779B97F4A7C15ull) >> 32) & mask;
}

static __device__ uint32_t acc_static_code(const SeqAccountArgs& A,
                                           int64_t i) {
  const uint32_t flags = EV32(AB_FLAGS);
  const u128 aid = mk128(EV64(AB_ID_LO), EV64(AB_ID_HI));
  if (EV64(AB_TIMESTAMP) != 0) return 3;
  if (EV32(AB_RESERVED) != 0) return 4;
  if (flags & AF_PADDING) return 5;
  if (aid == 0) return 6;
  if (aid == U128_MAX) return 7;
  if ((flags & AF_DEBITS_MUST_NOT_EXCEED_CREDITS) &&
      (flags & AF_CREDITS_MUST_NOT_EXCEED_DEBITS))
    return 8;
  if (EV64(AB_DEBITS_PENDING_LO) || EV64(AB_DEBITS_PENDING_HI)) return 9;
  if (EV64(AB_DEBITS_POSTED_LO) || EV64(AB_DEBITS_POSTED_HI)) return 10;
  if (EV64(AB_CREDITS_PENDING_LO) || EV64(AB_CREDITS_PENDING_HI)) return 11;
  if (EV64(AB_CREDITS_POSTED_LO) || EV64(AB_CREDITS_POSTED_HI)) return 12;
  if (EV32(AB_LEDGER) == 0) return 13;
  if (EV32(AB_CODE) == 0) return 14;
  return 0;
}

// The exists code (15-21) of event i against a row holding these fields.
static __device__ uint32_t acc_exists_code(const SeqAccountArgs& A, int64_t i,
                                           uint32_t flags, uint64_t ud128_lo,
                                           uint64_t ud128_hi, uint64_t ud64,
                                           uint32_t ud32, uint32_t ledger,
                                           uint32_t code) {
  if (EV32(AB_FLAGS) != flags) return 15;
  if (EV64(AB_USER_DATA_128_LO) != ud128_lo ||
      EV64(AB_USER_DATA_128_HI) != ud128_hi)
    return 16;
  if (EV64(AB_USER_DATA_64) != ud64) return 17;
  if (EV32(AB_USER_DATA_32) != ud32) return 18;
  if (EV32(AB_LEDGER) != ledger) return 19;
  if (EV32(AB_CODE) != code) return 20;
  return 21;
}

// The F hash: F -> (lowest, highest) candidate.
static __device__ void fh_insert(const SeqAccountArgs& A, uint64_t f,
                                 uint32_t e) {
  const uint32_t key = (uint32_t)f + 1;
  for (uint32_t h = seqa_hash(f, A.hf_mask);; h = (h + 1) & A.hf_mask) {
    const uint32_t prev = atomicCAS(&A.fk[h], 0u, key);
    if (prev == 0u || prev == key) {
      atomicMax(&A.fmi[h], ~e);
      atomicMax(&A.fmx[h], e + 1);
      return;
    }
  }
}

// The candidate whose F is x: SEQA_NONE, SEQA_MULTI or its event.
static __device__ uint32_t fh_owner(const SeqAccountArgs& A, uint64_t x) {
  const uint32_t key = (uint32_t)x + 1;
  for (uint32_t h = seqa_hash(x, A.hf_mask);; h = (h + 1) & A.hf_mask) {
    const uint32_t k = A.fk[h];
    if (k == 0u) return SEQA_NONE;
    if (k == key) {
      const uint32_t lo = ~A.fmi[h], hi = A.fmx[h] - 1;
      return lo == hi ? lo : SEQA_MULTI;
    }
  }
}

__global__ void __launch_bounds__(SEQA_WIDE)
    seqa_probe_kernel(SeqAccountArgs A) {
  PHASE_MARK(0);
  const int64_t i = blockIdx.x * (int64_t)SEQA_WIDE + threadIdx.x;
  if (i < A.n) {
    uint64_t bits = 0, slot = 0;
    if (i < A.count) {
      bits |= AR_ACTIVE;
      if (EV32(AB_FLAGS) & AF_LINKED) bits |= AR_LINKED;
      const uint32_t sc = acc_static_code(A, i);
      if (sc != 0) {
        bits |= sc;
      } else {
        uint64_t t;
        bool capped;
        const bool found =
            probe_full(A.acc, EV64(AB_ID_LO), EV64(AB_ID_HI), &slot, &t, &capped);
        const DevTable& T = A.acc;
        if (found) {
          bits |= AR_FOUND |
                  ((uint64_t)acc_exists_code(
                       A, i, C32(T, AT_FLAGS)[slot],
                       C64(T, AT_USER_DATA_128_LO)[slot],
                       C64(T, AT_USER_DATA_128_HI)[slot],
                       C64(T, AT_USER_DATA_64)[slot], C32(T, AT_USER_DATA_32)[slot],
                       C32(T, AT_LEDGER)[slot], C32(T, AT_CODE)[slot])
                   << AR_EXISTS_SHIFT);
        } else if (capped) {
          bits |= AR_CAPPED;
        } else {
          bits |= AR_CAND | (t << AR_TF_SHIFT);
          fh_insert(A, slot, (uint32_t)i);
        }
      }
    }
    A.rec[i * AR_WORDS] = bits;
    A.rec[i * AR_WORDS + 1] = slot;
    // The id's high hash bits (the sequencer tells ids apart by them before
    // it reads an id) beside G1's candidate, which the mark kernel sets.
    A.rec[i * AR_WORDS + 3] =
        (mix64(EV64(AB_ID_LO), EV64(AB_ID_HI)) & ~0xFFFFFFFFull) | SEQA_NONE;
  }
  SEQA_BARRIER();
  PHASE_MARK(1);
}

__global__ void __launch_bounds__(SEQA_WIDE)
    seqa_mark_kernel(SeqAccountArgs A) {
  PHASE_MARK(2);
  const int64_t i = blockIdx.x * (int64_t)SEQA_WIDE + threadIdx.x;
  if (i < A.n) {
    const uint64_t bits = A.rec[i * AR_WORDS];
    bool mark = (bits & (AR_LINKED | AR_CAPPED)) != 0 ||
                ((bits & AR_ACTIVE) && i > 0 &&
                 (A.rec[(i - 1) * AR_WORDS] & AR_LINKED));
    if (bits & AR_CAND) {
      const uint64_t f = A.rec[i * AR_WORDS + 1];
      if (fh_owner(A, f) == SEQA_MULTI) {
        mark = true;
        // G1: the next pre-batch empty slot after F, and its candidate.
        const uint64_t t_f = (bits >> AR_TF_SHIFT) & AR_STEP;
        const uint64_t home = (f - t_f) & A.acc.mask;
        uint64_t t = t_f + 1, g = 0;
        for (; t < SEQ_MAX_PROBE; ++t) {
          g = (home + t) & A.acc.mask;
          if (!A.acc.tomb[g] && A.acc.key_lo[g] == 0 && A.acc.key_hi[g] == 0)
            break;
        }
        A.rec[i * AR_WORDS] = bits | AR_G1 | (t << AR_TG1_SHIFT);
        A.rec[i * AR_WORDS + 2] = g;
        A.rec[i * AR_WORDS + 3] =
            (A.rec[i * AR_WORDS + 3] & ~0xFFFFFFFFull) |
            (t < SEQ_MAX_PROBE ? fh_owner(A, g) : SEQA_NONE);
      }
    }
    if (mark) atomicOr(&A.marks[i >> 5], 1u << (i & 31));
  }
  SEQA_BARRIER();
  PHASE_MARK(3);
}

// The overlay: slot + 1 -> (event << 1 | live), and the inserted id's high
// hash bits.
// The sequencer's arithmetic is 32-bit (slots below 2^31, events below
// 2^31): it runs on one thread, where every instruction is on the chain.
struct Overlay {
  uint32_t* key;
  uint32_t* val;
  uint32_t* hash;
  uint32_t mask;  // 2^(32 - shift) - 1
  int shift;

  __device__ __forceinline__ uint32_t home(uint32_t x) const {
    return (x * 0x9E3779B1u) >> shift;
  }
  __device__ uint32_t find(uint32_t x) const {  // its index, or ~0u
    const uint32_t k = x + 1;
    for (uint32_t h = home(x);; h = (h + 1) & mask) {
      const uint32_t kh = key[h];
      if (kh == k) return h;
      if (kh == 0u) return ~0u;
    }
  }
  __device__ void put(uint32_t x, uint32_t v, uint32_t id_hash) const {
    for (uint32_t h = home(x);; h = (h + 1) & mask) {
      if (key[h] == 0u) {
        key[h] = x + 1;
        val[h] = v;
        hash[h] = id_hash;
        return;
      }
    }
  }
};

// One event's row at slot x: its columns, and its key where the insert
// stands or the tombstone where it was rolled back.
static __device__ void seqa_write_row(const SeqAccountArgs& A, int64_t i,
                                      uint64_t x, bool live) {
  const DevTable& T = A.acc;
  for (int k = 0; k < 8; ++k)
    C64(T, AT_DEBITS_PENDING_LO + k)[x] = EV64(AB_DEBITS_PENDING_LO + k);
  C64(T, AT_USER_DATA_128_LO)[x] = EV64(AB_USER_DATA_128_LO);
  C64(T, AT_USER_DATA_128_HI)[x] = EV64(AB_USER_DATA_128_HI);
  C64(T, AT_USER_DATA_64)[x] = EV64(AB_USER_DATA_64);
  C32(T, AT_USER_DATA_32)[x] = EV32(AB_USER_DATA_32);
  C32(T, AT_LEDGER)[x] = EV32(AB_LEDGER);
  C32(T, AT_CODE)[x] = EV32(AB_CODE);
  C32(T, AT_FLAGS)[x] = EV32(AB_FLAGS);
  C64(T, AT_TIMESTAMP)[x] = A.timestamp - (uint64_t)A.count + 1 + (uint64_t)i;
  T.key_lo[x] = live ? EV64(AB_ID_LO) : 0;
  T.key_hi[x] = live ? EV64(AB_ID_HI) : 0;
  T.tomb[x] = live ? 0 : 1;
}

// Event i's code and row from its record, or its decision when marked;
// `raw`: the code before the chain pass.  Returns whether it inserted a row
// that stands.
static __device__ bool seqa_finish(const SeqAccountArgs& A,
                                   const uint32_t* marks, int64_t i, bool raw) {
  const uint64_t bits = A.rec[i * AR_WORDS];
  uint32_t code;
  bool ins, live = true;
  uint64_t x;
  if ((marks[i >> 5] >> (i & 31)) & 1u) {
    const uint64_t d = A.dec[i];
    code = (uint32_t)((raw ? d : d >> DEC_FINAL_SHIFT) & 0x7F);
    ins = (d & DEC_INS) != 0;
    live = (d & DEC_LIVE) != 0;
    x = d >> DEC_SLOT_SHIFT;
  } else {
    code = !(bits & AR_ACTIVE) ? 0
           : (bits & AR_STATIC) ? (uint32_t)(bits & AR_STATIC)
           : (bits & AR_FOUND) ? (uint32_t)((bits >> AR_EXISTS_SHIFT) & 0x1F)
                               : 0;
    ins = (bits & AR_CAND) != 0;
    x = A.rec[i * AR_WORDS + 1];
  }
  // _chain_codes reaches one lane past a chain left open at count - 1.
  if (!raw && i == A.count && i > 0 && (A.rec[(i - 1) * AR_WORDS] & AR_LINKED))
    code = 1;
  A.codes[i] = (int32_t)code;
  if (ins) seqa_write_row(A, i, x, live);
  return ins && live;
}

// The one-thread loop over events [i0, n) on the table in device memory,
// with the chain state at i0 (K7 before the pre-pass, and still its form
// after a capped insert); raw codes.
static __device__ void seqa_serial(const SeqAccountArgs& A, int64_t i0,
                                   int64_t chain_start, bool chain_broken) {
  for (int64_t i = i0; i < A.n; ++i) {
    A.undo[i] = SEQ_SENT;
    const bool active = i < A.count;
    const uint32_t flags = EV32(AB_FLAGS);
    const bool linked = active && (flags & AF_LINKED);
    if (linked && chain_start < 0) chain_start = i;
    const bool in_chain = chain_start >= 0;
    const bool chain_open_err = linked && i == A.count - 1;
    uint32_t code = 0;
    if (!active) code = 0;
    else if (chain_open_err) code = 2;
    else if (chain_broken) code = 1;
    else if ((code = acc_static_code(A, i)) == 0) {
      uint64_t slot, free_slot;
      bool capped;
      const uint64_t id_lo = EV64(AB_ID_LO), id_hi = EV64(AB_ID_HI);
      const DevTable& T = A.acc;
      if (probe_key(T, id_lo, id_hi, &slot, &free_slot, &capped)) {
        code = acc_exists_code(A, i, C32(T, AT_FLAGS)[slot],
                               C64(T, AT_USER_DATA_128_LO)[slot],
                               C64(T, AT_USER_DATA_128_HI)[slot],
                               C64(T, AT_USER_DATA_64)[slot],
                               C32(T, AT_USER_DATA_32)[slot],
                               C32(T, AT_LEDGER)[slot], C32(T, AT_CODE)[slot]);
      } else {
        const uint64_t s = capped ? 0 : free_slot;
        if (capped) *A.overflow = 1;
        seqa_write_row(A, i, s, true);
        *T.count += 1;
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

// The next marked event after e (n when none).
static __device__ __forceinline__ int seqa_next(const uint32_t* marks, int e,
                                                int n) {
  int w = (e + 1) >> 5;
  const int words = (n + 31) >> 5;
  if (w >= words) return n;
  uint32_t b = marks[w] & (~0u << ((e + 1) & 31));
  while (b == 0u) {
    if (++w >= words) return n;
    b = marks[w];
  }
  const int nx = (w << 5) + __ffs(b) - 1;
  return nx < n ? nx : n;
}

struct SeqaRec {
  uint64_t w[AR_WORDS];
};

static __device__ __forceinline__ SeqaRec seqa_load(const SeqAccountArgs& A,
                                                    int64_t e) {
  SeqaRec r;
  const ulonglong2* p = reinterpret_cast<const ulonglong2*>(A.rec + e * AR_WORDS);
  const ulonglong2 a = p[0], b = p[1];
  r.w[0] = a.x;
  r.w[1] = a.y;
  r.w[2] = b.x;
  r.w[3] = b.y;
  return r;
}

#define SEQA_CAPPED (-1)
#define SEQA_INSERT (-2)

// The walk of candidate e from its F over the table as the batch has left
// it.  Returns SEQA_INSERT (*x the slot), SEQA_CAPPED, or the event whose
// live insert holds e's id.
static __device__ int seqa_walk(const SeqAccountArgs& A, const Overlay& ov,
                                uint32_t* marks, int e, const SeqaRec& r,
                                uint32_t* x_out) {
  const int64_t i = e;
  const uint32_t id_hash = (uint32_t)(r.w[3] >> 32);
  const uint64_t bits = r.w[0];
  const uint32_t mask = (uint32_t)A.acc.mask;
  uint32_t x = (uint32_t)r.w[1];
  int t = (int)((bits >> AR_TF_SHIFT) & AR_STEP);
  const uint32_t home = (x - (uint32_t)t) & mask;
  int stage = 0;  // 0: at F, 1: at G1, 2: beyond
  while (true) {
    if (t >= SEQ_MAX_PROBE) return SEQA_CAPPED;
    const uint32_t h = ov.find(x);
    bool taken = false;
    if (h != ~0u) {
      const uint32_t v = ov.val[h];
      const int j = (int)(v >> 1);
      if ((v & 1u) && ov.hash[h] == id_hash &&
          static_cast<const uint64_t*>(A.batch[AB_ID_LO])[j] == EV64(AB_ID_LO) &&
          static_cast<const uint64_t*>(A.batch[AB_ID_HI])[j] == EV64(AB_ID_HI))
        return j;
      taken = true;
    } else if (stage > 0) {
      const uint32_t u = stage == 1 ? (uint32_t)r.w[3] : fh_owner(A, x);
      if (u < SEQA_MULTI && u != (uint32_t)e &&
          !((marks[u >> 5] >> (u & 31)) & 1u)) {
        if (u < (uint32_t)e) {
          taken = true;  // an unmarked candidate before e inserted there
        } else {
          marks[u >> 5] |= 1u << (u & 31);  // its F is taken before it comes
        }
      }
    }
    if (!taken) {
      *x_out = x;
      return SEQA_INSERT;
    }
    if (stage == 0 && (bits & AR_G1)) {
      stage = 1;
      x = (uint32_t)r.w[2];
      t = (int)((bits >> AR_TG1_SHIFT) & AR_STEP);
      continue;
    }
    stage = 2;
    do {
      if (++t >= SEQ_MAX_PROBE) return SEQA_CAPPED;
      x = (home + (uint32_t)t) & mask;
    } while (A.acc.tomb[x] || A.acc.key_lo[x] || A.acc.key_hi[x]);
  }
}

// An exclusive scan of one value a thread over the block; *total gets the
// sum.  Every thread must call it.
static __device__ uint32_t seqa_block_scan(uint32_t v, uint32_t* warp_tot,
                                           uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = SEQA_THREADS / 32;
  uint32_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t t = lane < warps ? warp_tot[lane] : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < warps) warp_tot[lane] = t;
  }
  __syncthreads();
  *total = warp_tot[warps - 1];
  return (warp == 0 ? 0u : warp_tot[warp - 1]) + x - v;
}

__global__ void __launch_bounds__(SEQA_THREADS)
    seqa_sequencer_kernel(SeqAccountArgs A) {
  extern __shared__ __align__(16) unsigned char seqa_sh[];
  __shared__ int64_t s_from, s_chain_start;
  __shared__ int s_chain_broken;
  __shared__ uint32_t s_warp[SEQA_THREADS / 32];
  PHASE_MARK(4);
  // The statically marked events: counted, then (when their records, the
  // list, the mask and an overlay of 4 slots an event fit SEQA_SMEM) listed
  // in order with their records in shared memory.
  const int64_t words = (A.n + 31) >> 5;
  const int64_t per = (words + SEQA_THREADS - 1) / SEQA_THREADS;
  const int64_t w0 = min(words, threadIdx.x * per), w1 = min(words, w0 + per);
  uint32_t mine = 0;
  for (int64_t w = w0; w < w1; ++w) mine += __popc(A.marks[w]);
  uint32_t m;
  const uint32_t first = seqa_block_scan(mine, s_warp, &m);
  uint32_t ovn = 64;
  while (ovn < 4 * m) ovn <<= 1;
  const bool on_chip =
      36ll * m + 4 * words + 12ll * ovn <= (long long)SEQA_SMEM;
  const bool marks_on_chip = on_chip || 4 * words <= SEQA_SMEM;
  SeqaRec* recs = reinterpret_cast<SeqaRec*>(seqa_sh);
  uint32_t* list = reinterpret_cast<uint32_t*>(recs + (on_chip ? m : 0));
  uint32_t* marks = marks_on_chip ? list + (on_chip ? m : 0) : A.marks;
  Overlay ov;
  if (on_chip) {
    ov.key = marks + words;
    ov.val = ov.key + ovn;
    ov.hash = ov.val + ovn;
    ov.mask = ovn - 1;
  } else {
    ov.key = A.ovk;
    ov.val = A.ovv;
    ov.hash = A.ovh;
    ov.mask = A.ovg_mask;
  }
  ov.shift = 32 - __popc(ov.mask);
  if (marks_on_chip)
    for (int64_t w = threadIdx.x; w < words; w += SEQA_THREADS)
      marks[w] = A.marks[w];
  if (on_chip) {
    uint32_t k = first;
    for (int64_t w = w0; w < w1; ++w)
      for (uint32_t b = A.marks[w]; b; b &= b - 1)
        list[k++] = (uint32_t)((w << 5) + __ffs(b) - 1);
  }
  for (int64_t k = threadIdx.x; k <= (int64_t)ov.mask; k += SEQA_THREADS)
    ov.key[k] = 0u;
  __syncthreads();
  if (on_chip)
    for (uint32_t k = threadIdx.x; k < m; k += SEQA_THREADS)
      recs[k] = seqa_load(A, list[k]);
  __syncthreads();
  PHASE_MARK(5);
  if (threadIdx.x == 0) {
    const int n = (int)A.n, count = (int)A.count;
    int chain_start = -1, from = n;
    bool broken = false;
    uint32_t pos = 0, ov_used = 0;
    for (int e = seqa_next(marks, -1, n); e < n; e = seqa_next(marks, e, n)) {
      SeqaRec r;
      if (on_chip && pos < m && list[pos] == (uint32_t)e) {
        r = recs[pos++];
      } else {
        r = seqa_load(A, e);  // marked by a walk, or no room on chip
      }
      const uint64_t bits = r.w[0];
      const bool active = (bits & AR_ACTIVE) != 0;
      const bool linked = (bits & AR_LINKED) != 0;
      if (linked && chain_start < 0) chain_start = e;
      const bool in_chain = chain_start >= 0;
      const bool open_err = linked && e == count - 1;
      uint32_t code = 0;
      uint64_t d = 0;
      if (!active) code = 0;
      else if (open_err) code = 2;
      else if (broken) code = 1;
      else if (bits & AR_STATIC) code = (uint32_t)(bits & AR_STATIC);
      else if (bits & AR_FOUND) code = (uint32_t)((bits >> AR_EXISTS_SHIFT) & 0x1F);
      else {
        uint32_t x = 0;
        // A capped probe, or an on-chip overlay at half its slots (a long
        // run of walks that mark the next: more events than the static
        // marks sized it for), hands the rest to the serial loop.
        const int j = (bits & AR_CAPPED) || 2 * ov_used >= ov.mask
                          ? SEQA_CAPPED
                          : seqa_walk(A, ov, marks, e, r, &x);
        if (j == SEQA_CAPPED) {
          from = e;
          break;
        }
        if (j == SEQA_INSERT) {
          ov.put(x, (uint32_t)(e << 1) | 1u, (uint32_t)(r.w[3] >> 32));
          ++ov_used;
          d = DEC_INS | DEC_LIVE | ((uint64_t)x << DEC_SLOT_SHIFT);
        } else {
          const int64_t i = j;  // the event whose insert holds the id: its row
          code = acc_exists_code(A, e, EV32(AB_FLAGS), EV64(AB_USER_DATA_128_LO),
                                 EV64(AB_USER_DATA_128_HI), EV64(AB_USER_DATA_64),
                                 EV32(AB_USER_DATA_32), EV32(AB_LEDGER),
                                 EV32(AB_CODE));
        }
      }
      A.dec[e] = d | code | ((uint64_t)code << DEC_FINAL_SHIFT);
      A.undo[e] = (d & DEC_INS) ? (d >> DEC_SLOT_SHIFT) : SEQ_SENT;
      if (active && code != 0 && in_chain && !broken) {
        for (int j = e - 1; j >= chain_start; --j) {
          uint64_t dj = A.dec[j];
          if (dj & DEC_LIVE) {
            const uint32_t h = ov.find((uint32_t)(dj >> DEC_SLOT_SHIFT));
            ov.val[h] &= ~1u;
            dj &= ~DEC_LIVE;
          }
          A.dec[j] = (dj & ~(0x7Full << DEC_FINAL_SHIFT)) | (1ull << DEC_FINAL_SHIFT);
        }
        broken = true;
      }
      if (in_chain && (!linked || open_err)) {
        chain_start = -1;
        broken = false;
      }
    }
    s_from = from;
    s_chain_start = chain_start;
    s_chain_broken = broken;
  }
  __syncthreads();
  PHASE_MARK(6);
  const int64_t from = s_from;
  if (from < A.n) {
    // A capped insert (or a full on-chip overlay) at `from`: write what is
    // decided, then the rest of the batch one event at a time.
    unsigned long long live = 0;
    for (int64_t i = threadIdx.x; i < from; i += SEQA_THREADS)
      live += seqa_finish(A, marks, i, true);
    if (live) atomicAdd(reinterpret_cast<unsigned long long*>(A.acc.count), live);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) seqa_serial(A, from, s_chain_start, s_chain_broken != 0);
  } else if (marks_on_chip) {
    for (int64_t k = threadIdx.x; k < words; k += SEQA_THREADS)
      A.marks[k] = marks[k];
  }
  if (threadIdx.x == 0) *A.state = from;
  PHASE_MARK(7);
}

__global__ void __launch_bounds__(SEQA_WIDE)
    seqa_finish_kernel(SeqAccountArgs A) {
  PHASE_MARK(8);
  if (*A.state < A.n) return;  // the sequencer finished the batch itself
  const int64_t i = blockIdx.x * (int64_t)SEQA_WIDE + threadIdx.x;
  const bool live = i < A.n && seqa_finish(A, A.marks, i, false);
  const int rows = __syncthreads_count(live);
  if (threadIdx.x == 0 && rows)
    atomicAdd(reinterpret_cast<unsigned long long*>(A.acc.count),
              (unsigned long long)rows);
  PHASE_MARK(9);
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

static bool pow2(int64_t x) { return x > 0 && (x & (x - 1)) == 0; }

// K32: `rec` u64[n * REC_WORDS], `bal` u64[2n * 8], `dslot` u64[2n],
// `hash` u64[2 * (h_id + h_acc + h_pst)] (each a power of two of at least
// 2n, 4n and 2n entries); all written here.
extern "C" int tb_seq_prepass(const void* const* batch, int nbatch,
                              const void* const* acc, int nacc, int64_t acc_cap,
                              const void* const* xfr, int nxfr, int64_t xfr_cap,
                              const void* const* pst, int npst, int64_t pst_cap,
                              int64_t n, int64_t count, uint64_t timestamp,
                              void* rec, void* bal, void* dslot, void* hash,
                              int64_t h_id, int64_t h_acc, int64_t h_pst,
                              void* stream) {
  SeqPreArgs A;
  if (nbatch != TB_N || n <= 0 || count > n || !pow2(h_id) || !pow2(h_acc) ||
      !pow2(h_pst) || h_id < 2 * n || h_acc < 4 * n || h_pst < 2 * n)
    return (int)cudaErrorInvalidValue;
  int err = pack_table(&A.acc, acc, nacc, AT_N, acc_cap);
  if (!err) err = pack_table(&A.xfr, xfr, nxfr, TT_N, xfr_cap);
  if (!err) err = pack_table(&A.pst, pst, npst, 1, pst_cap);
  if (err) return err;
  for (int k = 0; k < TB_N; ++k) A.batch[k] = batch[k];
  A.n = n;
  A.count = count;
  A.ts_base = timestamp - (uint64_t)count + 1;
  A.rec = (uint64_t*)rec;
  A.bal = (uint64_t*)bal;
  A.dslot = (uint64_t*)dslot;
  A.hash = (ull*)hash;
  A.hash_n = h_id + h_acc + h_pst;
  const JoinHash regions[3] = {
      {A.hash, A.hash + A.hash_n, (uint64_t)(h_id - 1)},
      {A.hash + h_id, A.hash + A.hash_n + h_id, (uint64_t)(h_acc - 1)},
      {A.hash + h_id + h_acc, A.hash + A.hash_n + h_id + h_acc,
       (uint64_t)(h_pst - 1)}};
  A.hid = regions[0];
  A.hacc = regions[1];
  A.hpst = regions[2];
  const int threads = 256;
  const int64_t span = A.hash_n > 2 * n ? A.hash_n : 2 * n;
  const unsigned blocks0 = (unsigned)((span + threads - 1) / threads);
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  seq_pre_probe<<<blocks0, threads, 0, s>>>(A);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  seq_pre_join<<<blocks, threads, 0, s>>>(A);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  seq_pre_link<<<blocks, threads, 0, s>>>(A);
  return (int)cudaGetLastError();
}

// K6: K32's outputs, then the undo log u64[n * UNDO_WORDS], the codes
// int32[n] and the overflow word int32[1] (zero on entry).  At most
// SEQ_MAX_N lanes and SEQ_MAX_SLOTS transfer and posted slots.
extern "C" int tb_seq_transfers(const void* const* batch, int nbatch,
                                const void* const* acc, int nacc, int64_t acc_cap,
                                const void* const* xfr, int nxfr, int64_t xfr_cap,
                                const void* const* pst, int npst, int64_t pst_cap,
                                const void* const* hist, int nhist, int64_t hist_cap,
                                int64_t n, int64_t count, uint64_t timestamp,
                                const void* rec, void* bal, const void* dslot,
                                void* undo, void* codes, void* overflow,
                                void* stream) {
  SeqTransferArgs A;
  if (nbatch != TB_N || nhist != H_N + 1 || n <= 0 || count > n ||
      n > SEQ_MAX_N || xfr_cap > SEQ_MAX_SLOTS || pst_cap > SEQ_MAX_SLOTS)
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
  A.rec = (const uint64_t*)rec;
  A.bal = (uint64_t*)bal;
  A.dslot = (const uint64_t*)dslot;
  const int smem = (int)sizeof(SeqShared);
  cudaError_t e = cudaFuncSetAttribute(
      seq_transfers_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  seq_transfers_kernel<<<1, SEQ_THREADS, smem, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

// The sequencer's cycle counters summed since the last call (SeqCycle
// order, CY_N words), then cleared; waits for the card.  A library built
// without SEQ_CYCLES has none and says so.
extern "C" int tb_seq_cycles(unsigned long long* out) {
#ifdef SEQ_CYCLES
  cudaError_t e = cudaMemcpyFromSymbol(out, seq_cycles, sizeof(seq_cycles));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[CY_N] = {};
  return (int)cudaMemcpyToSymbol(seq_cycles, zero, sizeof(zero));
#else
  (void)out;
  return (int)cudaErrorNotSupported;
#endif
}

// K7's scratch for n events, in bytes (SeqaLayout): the records, the
// decisions, the undo log and the overlay in device memory (cleared by the
// sequencer when it takes it), then what the entry point zeroes (the F
// hash, the marks, the state word and the overflow byte).
struct SeqaLayout {
  int64_t rec, dec, undo, ovk, ovv, ovh, zero, fk, fmi, fmx, marks, state, ovf,
      total;
  int64_t hf, ovg;
};

static int64_t seqa_pow2(int64_t x) {
  int64_t p = 64;
  while (p < x) p <<= 1;
  return p;
}

static void seqa_layout(int64_t n, SeqaLayout* L) {
  L->hf = seqa_pow2(2 * n);
  L->ovg = seqa_pow2(2 * n);
  int64_t off = 0;
  L->rec = off;
  off += 8 * AR_WORDS * n;
  L->dec = off;
  off += 8 * n;
  L->undo = off;
  off += 8 * n;
  L->ovk = off;
  off += 4 * L->ovg;
  L->ovv = off;
  off += 4 * L->ovg;
  L->ovh = off;
  off += 4 * L->ovg;
  L->zero = off;
  L->fk = off;
  off += 4 * L->hf;
  L->fmi = off;
  off += 4 * L->hf;
  L->fmx = off;
  off += 4 * L->hf;
  L->marks = off;
  off += 8 * ((n + 63) / 64);
  L->state = off;
  off += 8;
  L->ovf = off;
  off += 8;
  L->total = off;
}

extern "C" int tb_seq_accounts_scratch(int64_t n, int64_t* out) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  SeqaLayout L;
  seqa_layout(n, &L);
  out[0] = L.total;
  out[1] = L.ovf;
  return 0;
}

// K7: `scratch` of tb_seq_accounts_scratch(n)[0] bytes (its overflow byte
// at [1] is the call's overflow flag), the codes int32[n].  Five
// operations on the stream: a memset, the two pre-pass launches, the
// sequencer and the finish.  At most 2^31 account slots.
extern "C" int tb_seq_accounts(const void* const* batch, int nbatch,
                               const void* const* acc, int nacc, int64_t acc_cap,
                               int64_t n, int64_t count, uint64_t timestamp,
                               void* scratch, void* codes, void* stream) {
  SeqAccountArgs A;
  if (nbatch != AB_N || n <= 0 || count > n || count < 0 ||
      acc_cap > (1ll << 31) || n >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  int err = pack_table(&A.acc, acc, nacc, AT_N, acc_cap);
  if (err) return err;
  for (int k = 0; k < AB_N; ++k) A.batch[k] = batch[k];
  A.n = n;
  A.count = count;
  A.timestamp = timestamp;
  SeqaLayout L;
  seqa_layout(n, &L);
  char* base = (char*)scratch;
  A.rec = (uint64_t*)(base + L.rec);
  A.dec = (uint64_t*)(base + L.dec);
  A.undo = (uint64_t*)(base + L.undo);
  A.fk = (uint32_t*)(base + L.fk);
  A.fmi = (uint32_t*)(base + L.fmi);
  A.fmx = (uint32_t*)(base + L.fmx);
  A.hf_mask = (uint32_t)(L.hf - 1);
  A.marks = (uint32_t*)(base + L.marks);
  A.ovk = (uint32_t*)(base + L.ovk);
  A.ovv = (uint32_t*)(base + L.ovv);
  A.ovh = (uint32_t*)(base + L.ovh);
  A.ovg_mask = (uint32_t)(L.ovg - 1);
  A.state = (int64_t*)(base + L.state);
  A.codes = (int32_t*)codes;
  A.overflow = (uint8_t*)(base + L.ovf);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(base + L.zero, 0, (size_t)(L.total - L.zero), s);
  if (e != cudaSuccess) return (int)e;
  const int smem = SEQA_SMEM;
  e = cudaFuncSetAttribute(seqa_sequencer_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((n + SEQA_WIDE - 1) / SEQA_WIDE);
  seqa_probe_kernel<<<blocks, SEQA_WIDE, 0, s>>>(A);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  seqa_mark_kernel<<<blocks, SEQA_WIDE, 0, s>>>(A);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  seqa_sequencer_kernel<<<1, SEQA_THREADS, smem, s>>>(A);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  seqa_finish_kernel<<<blocks, SEQA_WIDE, 0, s>>>(A);
  return (int)cudaGetLastError();
}

// What the compiler made of K7's four kernels (probe, mark, sequencer,
// finish; 5 ints each: registers, local bytes a thread, threads a block,
// static shared bytes, max threads a block), then the sequencer's dynamic
// shared bytes for n events.
extern "C" int tb_seq_accounts_info(int64_t n, int* out) {
  const void* ks[4] = {(const void*)seqa_probe_kernel,
                       (const void*)seqa_mark_kernel,
                       (const void*)seqa_sequencer_kernel,
                       (const void*)seqa_finish_kernel};
  const int threads[4] = {SEQA_WIDE, SEQA_WIDE, SEQA_THREADS, SEQA_WIDE};
  for (int k = 0; k < 4; ++k) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, ks[k]);
    if (err != cudaSuccess) return (int)err;
    out[5 * k] = fa.numRegs;
    out[5 * k + 1] = (int)fa.localSizeBytes;
    out[5 * k + 2] = threads[k];
    out[5 * k + 3] = (int)fa.sharedSizeBytes;
    out[5 * k + 4] = fa.maxThreadsPerBlock;
  }
  (void)n;
  out[20] = SEQA_SMEM;
  return 0;
}

PHASE_CLOCK_ENTRIES(tb_seq_accounts_phases)
