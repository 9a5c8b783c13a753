/* Native host data-plane engine: the accounting state machine hot path.
 *
 * The reference's entire data plane is native (src/state_machine.zig
 * :1002-1088 execute, :1198-1225 create_account, :1239-1368 create_transfer,
 * :1391-1498 post/void); the JAX kernels cover the device (TPU) path.  This
 * engine is the HOST-side executor for the solo-server OLTP path, where a
 * remote accelerator's per-batch round-trip latency (not compute) bounds
 * throughput.  Semantics are an exact sequential port of the repo's scalar
 * oracle (tigerbeetle_tpu/testing/model.py — itself transcribed from the
 * reference).
 *
 * Hashing/probing is identical to the device tables (ops/hash_table.py:
 * slot = mix64(key) & (C-1), linear probe, tombstones, insert-past-tombstone)
 * so slot assignment is bit-identical across executors; the PHYSICAL layout
 * here is array-of-slots (AoS) rather than the device's struct-of-arrays —
 * a random insert touches 3 cache lines instead of 23.  The SoA device view
 * is materialized value-for-value by host_engine.HostLedger.to_device().
 *
 * Memory is OWNED BY PYTHON (numpy structured arrays); every call receives a
 * tb_ledger_view of raw pointers.  The engine never allocates.
 */

#include <cstdint>
#include <cstring>
#include <vector>

#include "tb_types.h"

typedef unsigned __int128 u128;

static inline u128 make_u128(uint64_t lo, uint64_t hi) {
    return ((u128)hi << 64) | lo;
}
static inline uint64_t lo64(u128 x) { return (uint64_t)x; }
static inline uint64_t hi64(u128 x) { return (uint64_t)(x >> 64); }

static const u128 U128_MAX_V = ~(u128)0;
static const uint64_t U64_MAX_V = ~(uint64_t)0;
static const uint64_t NS_PER_S = 1000000000ull;

/* splitmix64 finalizer over a xor-fold of the u128 lanes — MUST match
 * tigerbeetle_tpu/u128.py mix64 exactly (slot parity with the device). */
static inline uint64_t mix64(uint64_t lo, uint64_t hi) {
    uint64_t x = lo ^ (hi * 0x9E3779B97F4A7C15ull);
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
    return x ^ (x >> 31);
}

/* Account flag bits (tigerbeetle.zig:42-57). */
enum {
    AF_LINKED = 1,
    AF_DEBITS_MUST_NOT_EXCEED_CREDITS = 2,
    AF_CREDITS_MUST_NOT_EXCEED_DEBITS = 4,
    AF_HISTORY = 8,
    AF_PADDING = 0xFFF0,
};
/* Transfer flag bits (tigerbeetle.zig:107-120). */
enum {
    TF_LINKED = 1,
    TF_PENDING = 2,
    TF_POST = 4,
    TF_VOID = 8,
    TF_BALANCING_DEBIT = 16,
    TF_BALANCING_CREDIT = 32,
    TF_PADDING = 0xFFC0,
};

/* Result codes: tigerbeetle.zig:125-160 / :165-245 (types.py enums). */
enum {
    A_OK = 0, A_LINKED_EVENT_FAILED = 1, A_LINKED_EVENT_CHAIN_OPEN = 2,
    A_TIMESTAMP_MUST_BE_ZERO = 3, A_RESERVED_FIELD = 4, A_RESERVED_FLAG = 5,
    A_ID_MUST_NOT_BE_ZERO = 6, A_ID_MUST_NOT_BE_INT_MAX = 7,
    A_FLAGS_ARE_MUTUALLY_EXCLUSIVE = 8,
    A_DEBITS_PENDING_MUST_BE_ZERO = 9, A_DEBITS_POSTED_MUST_BE_ZERO = 10,
    A_CREDITS_PENDING_MUST_BE_ZERO = 11, A_CREDITS_POSTED_MUST_BE_ZERO = 12,
    A_LEDGER_MUST_NOT_BE_ZERO = 13, A_CODE_MUST_NOT_BE_ZERO = 14,
    A_EXISTS_WITH_DIFFERENT_FLAGS = 15, A_EXISTS_WITH_DIFFERENT_UD128 = 16,
    A_EXISTS_WITH_DIFFERENT_UD64 = 17, A_EXISTS_WITH_DIFFERENT_UD32 = 18,
    A_EXISTS_WITH_DIFFERENT_LEDGER = 19, A_EXISTS_WITH_DIFFERENT_CODE = 20,
    A_EXISTS = 21,
};
enum {
    T_OK = 0, T_LINKED_EVENT_FAILED = 1, T_LINKED_EVENT_CHAIN_OPEN = 2,
    T_TIMESTAMP_MUST_BE_ZERO = 3, T_RESERVED_FLAG = 4,
    T_ID_MUST_NOT_BE_ZERO = 5, T_ID_MUST_NOT_BE_INT_MAX = 6,
    T_FLAGS_ARE_MUTUALLY_EXCLUSIVE = 7,
    T_DEBIT_ACCOUNT_ID_MUST_NOT_BE_ZERO = 8,
    T_DEBIT_ACCOUNT_ID_MUST_NOT_BE_INT_MAX = 9,
    T_CREDIT_ACCOUNT_ID_MUST_NOT_BE_ZERO = 10,
    T_CREDIT_ACCOUNT_ID_MUST_NOT_BE_INT_MAX = 11,
    T_ACCOUNTS_MUST_BE_DIFFERENT = 12, T_PENDING_ID_MUST_BE_ZERO = 13,
    T_PENDING_ID_MUST_NOT_BE_ZERO = 14, T_PENDING_ID_MUST_NOT_BE_INT_MAX = 15,
    T_PENDING_ID_MUST_BE_DIFFERENT = 16,
    T_TIMEOUT_RESERVED_FOR_PENDING_TRANSFER = 17,
    T_AMOUNT_MUST_NOT_BE_ZERO = 18, T_LEDGER_MUST_NOT_BE_ZERO = 19,
    T_CODE_MUST_NOT_BE_ZERO = 20, T_DEBIT_ACCOUNT_NOT_FOUND = 21,
    T_CREDIT_ACCOUNT_NOT_FOUND = 22,
    T_ACCOUNTS_MUST_HAVE_THE_SAME_LEDGER = 23,
    T_TRANSFER_MUST_HAVE_THE_SAME_LEDGER_AS_ACCOUNTS = 24,
    T_PENDING_TRANSFER_NOT_FOUND = 25, T_PENDING_TRANSFER_NOT_PENDING = 26,
    T_PENDING_TRANSFER_HAS_DIFFERENT_DEBIT_ACCOUNT_ID = 27,
    T_PENDING_TRANSFER_HAS_DIFFERENT_CREDIT_ACCOUNT_ID = 28,
    T_PENDING_TRANSFER_HAS_DIFFERENT_LEDGER = 29,
    T_PENDING_TRANSFER_HAS_DIFFERENT_CODE = 30,
    T_EXCEEDS_PENDING_TRANSFER_AMOUNT = 31,
    T_PENDING_TRANSFER_HAS_DIFFERENT_AMOUNT = 32,
    T_PENDING_TRANSFER_ALREADY_POSTED = 33,
    T_PENDING_TRANSFER_ALREADY_VOIDED = 34, T_PENDING_TRANSFER_EXPIRED = 35,
    T_EXISTS_WITH_DIFFERENT_FLAGS = 36,
    T_EXISTS_WITH_DIFFERENT_DEBIT_ACCOUNT_ID = 37,
    T_EXISTS_WITH_DIFFERENT_CREDIT_ACCOUNT_ID = 38,
    T_EXISTS_WITH_DIFFERENT_AMOUNT = 39,
    T_EXISTS_WITH_DIFFERENT_PENDING_ID = 40,
    T_EXISTS_WITH_DIFFERENT_UD128 = 41, T_EXISTS_WITH_DIFFERENT_UD64 = 42,
    T_EXISTS_WITH_DIFFERENT_UD32 = 43, T_EXISTS_WITH_DIFFERENT_TIMEOUT = 44,
    T_EXISTS_WITH_DIFFERENT_CODE = 45, T_EXISTS = 46,
    T_OVERFLOWS_DEBITS_PENDING = 47, T_OVERFLOWS_CREDITS_PENDING = 48,
    T_OVERFLOWS_DEBITS_POSTED = 49, T_OVERFLOWS_CREDITS_POSTED = 50,
    T_OVERFLOWS_DEBITS = 51, T_OVERFLOWS_CREDITS = 52,
    T_OVERFLOWS_TIMEOUT = 53, T_EXCEEDS_CREDITS = 54, T_EXCEEDS_DEBITS = 55,
};

/* Engine-level error returns (not event result codes). */
enum {
    ENGINE_OK = 0,
    ENGINE_PROBE_OVERFLOW = 1,   /* table needs growth; events before the
                                    failing one stay applied (open chain is
                                    rolled back) — callers pre-size to make
                                    this unreachable and fail loud. */
    ENGINE_CAPACITY = 2,         /* history log full (same contract) */
};

extern "C" {

/* AoS slot layouts — mirrored EXACTLY by the numpy structured dtypes in
 * ../host_engine.py (natural alignment: u64 block first, u32s after, u8
 * tombstone + tail padding).  All u64 fields stay 8-aligned because
 * sizeof % 8 == 0. */

typedef struct {
    uint64_t key_lo, key_hi;
    uint64_t dp_lo, dp_hi, dpo_lo, dpo_hi;
    uint64_t cp_lo, cp_hi, cpo_lo, cpo_hi;
    uint64_t ud128_lo, ud128_hi, ud64, ts;
    uint32_t ud32, ledger, code, flags;
    uint8_t tomb;
    uint8_t pad[7];
} tb_acc_slot;
TB_STATIC_ASSERT(sizeof(tb_acc_slot) == 136, "acc slot layout");

typedef struct {
    uint64_t key_lo, key_hi;
    uint64_t dr_lo, dr_hi, cr_lo, cr_hi;
    uint64_t amt_lo, amt_hi, pid_lo, pid_hi;
    uint64_t ud128_lo, ud128_hi, ud64, ts;
    uint32_t ud32, timeout, ledger, code, flags;
    uint8_t tomb;
    uint8_t pad[3];
} tb_tr_slot;
TB_STATIC_ASSERT(sizeof(tb_tr_slot) == 136, "transfer slot layout");

typedef struct {
    uint64_t key_lo, key_hi;
    uint32_t fulfillment;
    uint8_t tomb;
    uint8_t pad[3];
} tb_po_slot;
TB_STATIC_ASSERT(sizeof(tb_po_slot) == 24, "posted slot layout");

/* Raw pointer view of the ledger (numpy-owned).  Field order is load-bearing:
 * tigerbeetle_tpu/host_engine.py mirrors it with ctypes.Structure. */
typedef struct {
    tb_acc_slot *acc;
    uint64_t acc_cap;
    tb_tr_slot *tr;
    uint64_t tr_cap;
    tb_po_slot *po;
    uint64_t po_cap;
    /* history log: 21 u64 columns in HISTORY_COLS order (SoA is fine here —
     * appends are sequential):
     * dr_id_lo, dr_id_hi, dr_dp_lo, dr_dp_hi, dr_dpo_lo, dr_dpo_hi,
     * dr_cp_lo, dr_cp_hi, dr_cpo_lo, dr_cpo_hi,
     * cr_id_lo, cr_id_hi, cr_dp_lo, cr_dp_hi, cr_dpo_lo, cr_dpo_hi,
     * cr_cp_lo, cr_cp_hi, cr_cpo_lo, cr_cpo_hi, timestamp */
    uint64_t *hist[21];
    uint64_t hist_cap;
    /* live counters, updated in place */
    uint64_t acc_count, tr_count, po_count, hist_count;
    uint64_t max_probe;
} tb_ledger_view;

} /* extern "C" (struct defs; functions re-open below) */

/* ---------------------------------------------------------------- probing */

struct ProbeResult {
    int64_t match;     /* slot holding the key, or -1 */
    int64_t free_slot; /* first claimable slot (key==0 && !tomb), or -1 */
    bool overflow;     /* exceeded max_probe without resolving */
};

/* One pass covering both ht.lookup and ht.claim_slots semantics: walk from
 * home, skipping tombstones; stop at a key match or the first true-empty slot
 * (which is exactly where claim_slots would place the key: occupied =
 * key!=0 | tombstone, so the first non-occupied slot IS the first empty). */
template <typename Slot>
static ProbeResult probe(const Slot *slots, uint64_t cap, uint64_t max_probe,
                         uint64_t klo, uint64_t khi) {
    const uint64_t mask = cap - 1;
    uint64_t home = mix64(klo, khi) & mask;
    for (uint64_t i = 0; i < max_probe; i++) {
        uint64_t cur = (home + i) & mask;
        const Slot &s = slots[cur];
        if (!s.tomb) {
            if (s.key_lo == klo && s.key_hi == khi)
                return {(int64_t)cur, -1, false};
            if ((s.key_lo | s.key_hi) == 0)
                return {-1, (int64_t)cur, false};
        }
    }
    return {-1, -1, true};
}

/* ---------------------------------------------------------------- undo log
 *
 * Linked-chain rollback (state_machine.zig:972-1000 scope_open/close;
 * model.py _scope_*).  Undo of an INSERT leaves a tombstone — exactly what
 * the device sequential path does (ht.remove_to_tombstone), keeping slot
 * state bit-identical across executors. */

enum UndoKind {
    UNDO_ACC_BALANCES,   /* restore account balance fields at slot */
    UNDO_ACC_INSERT,     /* tombstone the account slot */
    UNDO_TR_INSERT,      /* tombstone the transfer slot */
    UNDO_PO_INSERT,      /* tombstone the posted slot */
    UNDO_HIST_APPEND,    /* pop one history row */
};

struct UndoRec {
    UndoKind kind;
    uint64_t slot;
    uint64_t dp_lo, dp_hi, dpo_lo, dpo_hi;
    uint64_t cp_lo, cp_hi, cpo_lo, cpo_hi;
};

struct Scope {
    std::vector<UndoRec> recs;
    bool open = false;
};

static void scope_undo(tb_ledger_view *v, Scope &sc) {
    for (auto it = sc.recs.rbegin(); it != sc.recs.rend(); ++it) {
        switch (it->kind) {
        case UNDO_ACC_BALANCES: {
            tb_acc_slot &a = v->acc[it->slot];
            a.dp_lo = it->dp_lo;   a.dp_hi = it->dp_hi;
            a.dpo_lo = it->dpo_lo; a.dpo_hi = it->dpo_hi;
            a.cp_lo = it->cp_lo;   a.cp_hi = it->cp_hi;
            a.cpo_lo = it->cpo_lo; a.cpo_hi = it->cpo_hi;
            break;
        }
        case UNDO_ACC_INSERT: {
            tb_acc_slot &a = v->acc[it->slot];
            a.key_lo = 0; a.key_hi = 0; a.tomb = 1;
            v->acc_count -= 1;
            break;
        }
        case UNDO_TR_INSERT: {
            tb_tr_slot &t = v->tr[it->slot];
            t.key_lo = 0; t.key_hi = 0; t.tomb = 1;
            v->tr_count -= 1;
            break;
        }
        case UNDO_PO_INSERT: {
            tb_po_slot &p = v->po[it->slot];
            p.key_lo = 0; p.key_hi = 0; p.tomb = 1;
            v->po_count -= 1;
            break;
        }
        case UNDO_HIST_APPEND:
            v->hist_count -= 1;
            break;
        }
    }
    sc.recs.clear();
}

static void record_acc(Scope &sc, const tb_ledger_view *v, uint64_t slot) {
    if (!sc.open) return;
    const tb_acc_slot &a = v->acc[slot];
    UndoRec r;
    r.kind = UNDO_ACC_BALANCES;
    r.slot = slot;
    r.dp_lo = a.dp_lo;   r.dp_hi = a.dp_hi;
    r.dpo_lo = a.dpo_lo; r.dpo_hi = a.dpo_hi;
    r.cp_lo = a.cp_lo;   r.cp_hi = a.cp_hi;
    r.cpo_lo = a.cpo_lo; r.cpo_hi = a.cpo_hi;
    sc.recs.push_back(r);
}

static inline void push_insert(Scope &sc, UndoKind kind, uint64_t slot) {
    if (!sc.open) return;
    UndoRec r{};
    r.kind = kind;
    r.slot = slot;
    sc.recs.push_back(r);
}

/* ---------------------------------------------------------- u128 helpers */

static inline bool sum_overflows_u128(u128 a, u128 b) {
    return a > U128_MAX_V - b;
}
static inline bool sum_overflows_u64(uint64_t a, uint64_t b) {
    return a > U64_MAX_V - b;
}

static inline u128 acc_dp(const tb_acc_slot &a) { return make_u128(a.dp_lo, a.dp_hi); }
static inline u128 acc_dpo(const tb_acc_slot &a) { return make_u128(a.dpo_lo, a.dpo_hi); }
static inline u128 acc_cp(const tb_acc_slot &a) { return make_u128(a.cp_lo, a.cp_hi); }
static inline u128 acc_cpo(const tb_acc_slot &a) { return make_u128(a.cpo_lo, a.cpo_hi); }
static inline void set_dp(tb_acc_slot &a, u128 x) { a.dp_lo = lo64(x); a.dp_hi = hi64(x); }
static inline void set_dpo(tb_acc_slot &a, u128 x) { a.dpo_lo = lo64(x); a.dpo_hi = hi64(x); }
static inline void set_cp(tb_acc_slot &a, u128 x) { a.cp_lo = lo64(x); a.cp_hi = hi64(x); }
static inline void set_cpo(tb_acc_slot &a, u128 x) { a.cpo_lo = lo64(x); a.cpo_hi = hi64(x); }

/* --------------------------------------------------------- create_account */

/* model.py create_account :240-294 (state_machine.zig:1198-1237). */
static uint32_t create_account(tb_ledger_view *v, Scope &sc,
                               const tb_account_t *a, uint64_t timestamp,
                               int *engine_err) {
    u128 id = make_u128(a->id.lo, a->id.hi);
    if (a->reserved != 0) return A_RESERVED_FIELD;
    if (a->flags & AF_PADDING) return A_RESERVED_FLAG;
    if (id == 0) return A_ID_MUST_NOT_BE_ZERO;
    if (id == U128_MAX_V) return A_ID_MUST_NOT_BE_INT_MAX;
    if ((a->flags & AF_DEBITS_MUST_NOT_EXCEED_CREDITS) &&
        (a->flags & AF_CREDITS_MUST_NOT_EXCEED_DEBITS))
        return A_FLAGS_ARE_MUTUALLY_EXCLUSIVE;
    if (a->debits_pending.lo | a->debits_pending.hi)
        return A_DEBITS_PENDING_MUST_BE_ZERO;
    if (a->debits_posted.lo | a->debits_posted.hi)
        return A_DEBITS_POSTED_MUST_BE_ZERO;
    if (a->credits_pending.lo | a->credits_pending.hi)
        return A_CREDITS_PENDING_MUST_BE_ZERO;
    if (a->credits_posted.lo | a->credits_posted.hi)
        return A_CREDITS_POSTED_MUST_BE_ZERO;
    if (a->ledger == 0) return A_LEDGER_MUST_NOT_BE_ZERO;
    if (a->code == 0) return A_CODE_MUST_NOT_BE_ZERO;

    ProbeResult p = probe(v->acc, v->acc_cap, v->max_probe, a->id.lo, a->id.hi);
    if (p.overflow) { *engine_err = ENGINE_PROBE_OVERFLOW; return 0; }
    if (p.match >= 0) {
        /* exists ladder (state_machine.zig:1227-1237) */
        const tb_acc_slot &e = v->acc[(uint64_t)p.match];
        if ((uint32_t)a->flags != e.flags)
            return A_EXISTS_WITH_DIFFERENT_FLAGS;
        if (make_u128(a->user_data_128.lo, a->user_data_128.hi) !=
            make_u128(e.ud128_lo, e.ud128_hi))
            return A_EXISTS_WITH_DIFFERENT_UD128;
        if (a->user_data_64 != e.ud64) return A_EXISTS_WITH_DIFFERENT_UD64;
        if (a->user_data_32 != e.ud32) return A_EXISTS_WITH_DIFFERENT_UD32;
        if ((uint32_t)a->ledger != e.ledger)
            return A_EXISTS_WITH_DIFFERENT_LEDGER;
        if ((uint32_t)a->code != e.code) return A_EXISTS_WITH_DIFFERENT_CODE;
        return A_EXISTS;
    }
    uint64_t s = (uint64_t)p.free_slot;
    tb_acc_slot &n = v->acc[s];
    std::memset(&n, 0, sizeof(n));
    n.key_lo = a->id.lo;
    n.key_hi = a->id.hi;
    n.ud128_lo = a->user_data_128.lo;
    n.ud128_hi = a->user_data_128.hi;
    n.ud64 = a->user_data_64;
    n.ud32 = a->user_data_32;
    n.ledger = a->ledger;
    n.code = a->code;
    n.flags = a->flags;
    n.ts = timestamp;
    v->acc_count += 1;
    push_insert(sc, UNDO_ACC_INSERT, s);
    return A_OK;
}

/* --------------------------------------------------------- history append */

static int append_history(tb_ledger_view *v, Scope &sc, uint64_t timestamp,
                          const tb_acc_slot &dr, const tb_acc_slot &cr) {
    if (v->hist_count >= v->hist_cap) return ENGINE_CAPACITY;
    uint64_t i = v->hist_count;
    /* HISTORY_COLS order; sides zeroed unless flagged (model._insert_history,
     * state_machine.zig:1342-1364). */
    bool dh = (dr.flags & AF_HISTORY) != 0;
    bool ch = (cr.flags & AF_HISTORY) != 0;
    v->hist[0][i] = dh ? dr.key_lo : 0;
    v->hist[1][i] = dh ? dr.key_hi : 0;
    v->hist[2][i] = dh ? dr.dp_lo : 0;
    v->hist[3][i] = dh ? dr.dp_hi : 0;
    v->hist[4][i] = dh ? dr.dpo_lo : 0;
    v->hist[5][i] = dh ? dr.dpo_hi : 0;
    v->hist[6][i] = dh ? dr.cp_lo : 0;
    v->hist[7][i] = dh ? dr.cp_hi : 0;
    v->hist[8][i] = dh ? dr.cpo_lo : 0;
    v->hist[9][i] = dh ? dr.cpo_hi : 0;
    v->hist[10][i] = ch ? cr.key_lo : 0;
    v->hist[11][i] = ch ? cr.key_hi : 0;
    v->hist[12][i] = ch ? cr.dp_lo : 0;
    v->hist[13][i] = ch ? cr.dp_hi : 0;
    v->hist[14][i] = ch ? cr.dpo_lo : 0;
    v->hist[15][i] = ch ? cr.dpo_hi : 0;
    v->hist[16][i] = ch ? cr.cp_lo : 0;
    v->hist[17][i] = ch ? cr.cp_hi : 0;
    v->hist[18][i] = ch ? cr.cpo_lo : 0;
    v->hist[19][i] = ch ? cr.cpo_hi : 0;
    v->hist[20][i] = timestamp;
    v->hist_count += 1;
    push_insert(sc, UNDO_HIST_APPEND, 0);
    return ENGINE_OK;
}

/* ------------------------------------------------------ post/void pending */

/* model.py _post_or_void_pending_transfer :471-565
 * (state_machine.zig:1391-1498). */
static uint32_t post_or_void(tb_ledger_view *v, Scope &sc,
                             const tb_transfer_t *t, uint64_t timestamp,
                             int *engine_err) {
    bool post = (t->flags & TF_POST) != 0;
    bool vvoid = (t->flags & TF_VOID) != 0;
    if (post && vvoid) return T_FLAGS_ARE_MUTUALLY_EXCLUSIVE;
    if (t->flags & TF_PENDING) return T_FLAGS_ARE_MUTUALLY_EXCLUSIVE;
    if (t->flags & TF_BALANCING_DEBIT) return T_FLAGS_ARE_MUTUALLY_EXCLUSIVE;
    if (t->flags & TF_BALANCING_CREDIT) return T_FLAGS_ARE_MUTUALLY_EXCLUSIVE;

    u128 id = make_u128(t->id.lo, t->id.hi);
    u128 pid = make_u128(t->pending_id.lo, t->pending_id.hi);
    if (pid == 0) return T_PENDING_ID_MUST_NOT_BE_ZERO;
    if (pid == U128_MAX_V) return T_PENDING_ID_MUST_NOT_BE_INT_MAX;
    if (pid == id) return T_PENDING_ID_MUST_BE_DIFFERENT;
    if (t->timeout != 0) return T_TIMEOUT_RESERVED_FOR_PENDING_TRANSFER;

    ProbeResult pp = probe(v->tr, v->tr_cap, v->max_probe,
                           t->pending_id.lo, t->pending_id.hi);
    if (pp.overflow) { *engine_err = ENGINE_PROBE_OVERFLOW; return 0; }
    if (pp.match < 0) return T_PENDING_TRANSFER_NOT_FOUND;
    const tb_tr_slot p = v->tr[(uint64_t)pp.match]; /* copy: table may move under inserts? no — but p is read-only anyway */
    if (!(p.flags & TF_PENDING)) return T_PENDING_TRANSFER_NOT_PENDING;

    ProbeResult pd = probe(v->acc, v->acc_cap, v->max_probe, p.dr_lo, p.dr_hi);
    ProbeResult pc = probe(v->acc, v->acc_cap, v->max_probe, p.cr_lo, p.cr_hi);
    if (pd.overflow || pc.overflow || pd.match < 0 || pc.match < 0) {
        /* The pending transfer inserted these accounts; they must exist. */
        *engine_err = ENGINE_PROBE_OVERFLOW;
        return 0;
    }
    uint64_t drs = (uint64_t)pd.match, crs = (uint64_t)pc.match;

    u128 t_dr = make_u128(t->debit_account_id.lo, t->debit_account_id.hi);
    u128 t_cr = make_u128(t->credit_account_id.lo, t->credit_account_id.hi);
    u128 p_dr = make_u128(p.dr_lo, p.dr_hi);
    u128 p_cr = make_u128(p.cr_lo, p.cr_hi);
    if (t_dr > 0 && t_dr != p_dr)
        return T_PENDING_TRANSFER_HAS_DIFFERENT_DEBIT_ACCOUNT_ID;
    if (t_cr > 0 && t_cr != p_cr)
        return T_PENDING_TRANSFER_HAS_DIFFERENT_CREDIT_ACCOUNT_ID;
    if (t->ledger > 0 && t->ledger != p.ledger)
        return T_PENDING_TRANSFER_HAS_DIFFERENT_LEDGER;
    if (t->code > 0 && t->code != p.code)
        return T_PENDING_TRANSFER_HAS_DIFFERENT_CODE;

    u128 p_amount = make_u128(p.amt_lo, p.amt_hi);
    u128 t_amount = make_u128(t->amount.lo, t->amount.hi);
    u128 amount = t_amount > 0 ? t_amount : p_amount;
    if (amount > p_amount) return T_EXCEEDS_PENDING_TRANSFER_AMOUNT;
    if (vvoid && amount < p_amount)
        return T_PENDING_TRANSFER_HAS_DIFFERENT_AMOUNT;

    ProbeResult pe = probe(v->tr, v->tr_cap, v->max_probe, t->id.lo, t->id.hi);
    if (pe.overflow) { *engine_err = ENGINE_PROBE_OVERFLOW; return 0; }
    u128 t_ud128 = make_u128(t->user_data_128.lo, t->user_data_128.hi);
    u128 p_ud128 = make_u128(p.ud128_lo, p.ud128_hi);
    if (pe.match >= 0) {
        /* exists ladder (state_machine.zig:1500-1561) */
        const tb_tr_slot &e = v->tr[(uint64_t)pe.match];
        if ((uint32_t)t->flags != e.flags) return T_EXISTS_WITH_DIFFERENT_FLAGS;
        u128 e_amount = make_u128(e.amt_lo, e.amt_hi);
        if (t_amount == 0) {
            if (e_amount != p_amount) return T_EXISTS_WITH_DIFFERENT_AMOUNT;
        } else if (t_amount != e_amount) {
            return T_EXISTS_WITH_DIFFERENT_AMOUNT;
        }
        if (pid != make_u128(e.pid_lo, e.pid_hi))
            return T_EXISTS_WITH_DIFFERENT_PENDING_ID;
        u128 e_ud128 = make_u128(e.ud128_lo, e.ud128_hi);
        if (t_ud128 == 0) {
            if (e_ud128 != p_ud128) return T_EXISTS_WITH_DIFFERENT_UD128;
        } else if (t_ud128 != e_ud128) {
            return T_EXISTS_WITH_DIFFERENT_UD128;
        }
        if (t->user_data_64 == 0) {
            if (e.ud64 != p.ud64) return T_EXISTS_WITH_DIFFERENT_UD64;
        } else if (t->user_data_64 != e.ud64) {
            return T_EXISTS_WITH_DIFFERENT_UD64;
        }
        if (t->user_data_32 == 0) {
            if (e.ud32 != p.ud32) return T_EXISTS_WITH_DIFFERENT_UD32;
        } else if (t->user_data_32 != e.ud32) {
            return T_EXISTS_WITH_DIFFERENT_UD32;
        }
        return T_EXISTS;
    }

    /* fulfillment lookup keyed by the pending's timestamp
     * (state_machine.zig:1471-1479; POSTED_COLS). */
    ProbeResult pf = probe(v->po, v->po_cap, v->max_probe, p.ts, 0);
    if (pf.overflow) { *engine_err = ENGINE_PROBE_OVERFLOW; return 0; }
    if (pf.match >= 0) {
        uint32_t f = v->po[(uint64_t)pf.match].fulfillment;
        if (f == 1) return T_PENDING_TRANSFER_ALREADY_POSTED;
        return T_PENDING_TRANSFER_ALREADY_VOIDED;
    }
    if (p.timeout > 0 &&
        timestamp >= p.ts + (uint64_t)p.timeout * NS_PER_S)
        return T_PENDING_TRANSFER_EXPIRED;

    /* Insert the posting/voiding transfer (state_machine.zig:1455-1469). */
    uint64_t ns = (uint64_t)pe.free_slot;
    tb_tr_slot &n = v->tr[ns];
    std::memset(&n, 0, sizeof(n));
    n.key_lo = t->id.lo;
    n.key_hi = t->id.hi;
    n.dr_lo = p.dr_lo; n.dr_hi = p.dr_hi;
    n.cr_lo = p.cr_lo; n.cr_hi = p.cr_hi;
    n.amt_lo = lo64(amount); n.amt_hi = hi64(amount);
    n.pid_lo = t->pending_id.lo; n.pid_hi = t->pending_id.hi;
    u128 ud128 = t_ud128 > 0 ? t_ud128 : p_ud128;
    n.ud128_lo = lo64(ud128); n.ud128_hi = hi64(ud128);
    n.ud64 = t->user_data_64 > 0 ? t->user_data_64 : p.ud64;
    n.ud32 = t->user_data_32 > 0 ? t->user_data_32 : p.ud32;
    n.timeout = 0;
    n.ledger = p.ledger;
    n.code = p.code;
    n.flags = t->flags;
    n.ts = timestamp;
    v->tr_count += 1;
    push_insert(sc, UNDO_TR_INSERT, ns);

    uint64_t ps = (uint64_t)pf.free_slot;
    tb_po_slot &po = v->po[ps];
    po.key_lo = p.ts;
    po.key_hi = 0;
    po.tomb = 0;
    po.fulfillment = post ? 1 : 2;
    v->po_count += 1;
    push_insert(sc, UNDO_PO_INSERT, ps);

    record_acc(sc, v, drs);
    record_acc(sc, v, crs);
    tb_acc_slot &dr = v->acc[drs];
    tb_acc_slot &cr = v->acc[crs];
    set_dp(dr, acc_dp(dr) - p_amount);
    set_cp(cr, acc_cp(cr) - p_amount);
    if (post) {
        set_dpo(dr, acc_dpo(dr) + amount);
        set_cpo(cr, acc_cpo(cr) + amount);
    }
    return T_OK;
}

/* -------------------------------------------------------- create_transfer */

/* model.py create_transfer :298-415 (state_machine.zig:1239-1368). */
static uint32_t create_transfer(tb_ledger_view *v, Scope &sc,
                                const tb_transfer_t *t, uint64_t timestamp,
                                int *engine_err) {
    if (t->flags & TF_PADDING) return T_RESERVED_FLAG;
    u128 id = make_u128(t->id.lo, t->id.hi);
    if (id == 0) return T_ID_MUST_NOT_BE_ZERO;
    if (id == U128_MAX_V) return T_ID_MUST_NOT_BE_INT_MAX;

    if (t->flags & (TF_POST | TF_VOID))
        return post_or_void(v, sc, t, timestamp, engine_err);

    u128 t_dr = make_u128(t->debit_account_id.lo, t->debit_account_id.hi);
    u128 t_cr = make_u128(t->credit_account_id.lo, t->credit_account_id.hi);
    if (t_dr == 0) return T_DEBIT_ACCOUNT_ID_MUST_NOT_BE_ZERO;
    if (t_dr == U128_MAX_V) return T_DEBIT_ACCOUNT_ID_MUST_NOT_BE_INT_MAX;
    if (t_cr == 0) return T_CREDIT_ACCOUNT_ID_MUST_NOT_BE_ZERO;
    if (t_cr == U128_MAX_V) return T_CREDIT_ACCOUNT_ID_MUST_NOT_BE_INT_MAX;
    if (t_cr == t_dr) return T_ACCOUNTS_MUST_BE_DIFFERENT;
    if (t->pending_id.lo | t->pending_id.hi) return T_PENDING_ID_MUST_BE_ZERO;
    if (!(t->flags & TF_PENDING) && t->timeout != 0)
        return T_TIMEOUT_RESERVED_FOR_PENDING_TRANSFER;
    u128 t_amount = make_u128(t->amount.lo, t->amount.hi);
    if (!(t->flags & (TF_BALANCING_DEBIT | TF_BALANCING_CREDIT)) &&
        t_amount == 0)
        return T_AMOUNT_MUST_NOT_BE_ZERO;
    if (t->ledger == 0) return T_LEDGER_MUST_NOT_BE_ZERO;
    if (t->code == 0) return T_CODE_MUST_NOT_BE_ZERO;

    ProbeResult pd = probe(v->acc, v->acc_cap, v->max_probe,
                           t->debit_account_id.lo, t->debit_account_id.hi);
    if (pd.overflow) { *engine_err = ENGINE_PROBE_OVERFLOW; return 0; }
    if (pd.match < 0) return T_DEBIT_ACCOUNT_NOT_FOUND;
    ProbeResult pc = probe(v->acc, v->acc_cap, v->max_probe,
                           t->credit_account_id.lo, t->credit_account_id.hi);
    if (pc.overflow) { *engine_err = ENGINE_PROBE_OVERFLOW; return 0; }
    if (pc.match < 0) return T_CREDIT_ACCOUNT_NOT_FOUND;
    uint64_t drs = (uint64_t)pd.match, crs = (uint64_t)pc.match;
    tb_acc_slot &dr = v->acc[drs];
    tb_acc_slot &cr = v->acc[crs];

    if (dr.ledger != cr.ledger) return T_ACCOUNTS_MUST_HAVE_THE_SAME_LEDGER;
    if ((uint32_t)t->ledger != dr.ledger)
        return T_TRANSFER_MUST_HAVE_THE_SAME_LEDGER_AS_ACCOUNTS;

    ProbeResult pe = probe(v->tr, v->tr_cap, v->max_probe, t->id.lo, t->id.hi);
    if (pe.overflow) { *engine_err = ENGINE_PROBE_OVERFLOW; return 0; }
    if (pe.match >= 0) {
        /* exists ladder (state_machine.zig:1370-1389) */
        const tb_tr_slot &e = v->tr[(uint64_t)pe.match];
        if ((uint32_t)t->flags != e.flags) return T_EXISTS_WITH_DIFFERENT_FLAGS;
        if (t_dr != make_u128(e.dr_lo, e.dr_hi))
            return T_EXISTS_WITH_DIFFERENT_DEBIT_ACCOUNT_ID;
        if (t_cr != make_u128(e.cr_lo, e.cr_hi))
            return T_EXISTS_WITH_DIFFERENT_CREDIT_ACCOUNT_ID;
        if (t_amount != make_u128(e.amt_lo, e.amt_hi))
            return T_EXISTS_WITH_DIFFERENT_AMOUNT;
        if (make_u128(t->user_data_128.lo, t->user_data_128.hi) !=
            make_u128(e.ud128_lo, e.ud128_hi))
            return T_EXISTS_WITH_DIFFERENT_UD128;
        if (t->user_data_64 != e.ud64) return T_EXISTS_WITH_DIFFERENT_UD64;
        if (t->user_data_32 != e.ud32) return T_EXISTS_WITH_DIFFERENT_UD32;
        if (t->timeout != e.timeout) return T_EXISTS_WITH_DIFFERENT_TIMEOUT;
        if ((uint32_t)t->code != e.code) return T_EXISTS_WITH_DIFFERENT_CODE;
        return T_EXISTS;
    }

    /* Balancing amount clamp (state_machine.zig:1286-1306). */
    u128 amount = t_amount;
    if (t->flags & (TF_BALANCING_DEBIT | TF_BALANCING_CREDIT)) {
        if (amount == 0) amount = U128_MAX_V;
    }
    if (t->flags & TF_BALANCING_DEBIT) {
        /* min(amount, max(0, cr_posted - (dp_pending + dp_posted))) with
         * overflow-safe u128 subtraction. */
        u128 cpo = acc_cpo(dr), dp = acc_dp(dr), dpo = acc_dpo(dr);
        u128 room = 0;
        if (cpo > dp && cpo - dp > dpo) room = cpo - dp - dpo;
        if (amount > room) amount = room;
        if (amount == 0) return T_EXCEEDS_CREDITS;
    }
    if (t->flags & TF_BALANCING_CREDIT) {
        u128 dpo = acc_dpo(cr), cp = acc_cp(cr), cpo = acc_cpo(cr);
        u128 room = 0;
        if (dpo > cp && dpo - cp > cpo) room = dpo - cp - cpo;
        if (amount > room) amount = room;
        if (amount == 0) return T_EXCEEDS_DEBITS;
    }

    /* Overflow checks (state_machine.zig:1308-1322). */
    u128 dr_dp = acc_dp(dr), dr_dpo = acc_dpo(dr);
    u128 cr_cp = acc_cp(cr), cr_cpo = acc_cpo(cr);
    if (t->flags & TF_PENDING) {
        if (sum_overflows_u128(amount, dr_dp)) return T_OVERFLOWS_DEBITS_PENDING;
        if (sum_overflows_u128(amount, cr_cp)) return T_OVERFLOWS_CREDITS_PENDING;
    }
    if (sum_overflows_u128(amount, dr_dpo)) return T_OVERFLOWS_DEBITS_POSTED;
    if (sum_overflows_u128(amount, cr_cpo)) return T_OVERFLOWS_CREDITS_POSTED;
    if (sum_overflows_u128(dr_dp, dr_dpo) ||
        sum_overflows_u128(amount, dr_dp + dr_dpo))
        return T_OVERFLOWS_DEBITS;
    if (sum_overflows_u128(cr_cp, cr_cpo) ||
        sum_overflows_u128(amount, cr_cp + cr_cpo))
        return T_OVERFLOWS_CREDITS;
    if (sum_overflows_u64(timestamp, (uint64_t)t->timeout * NS_PER_S))
        return T_OVERFLOWS_TIMEOUT;

    /* Balance limits (tigerbeetle.zig:31-39, state_machine.zig:1323-1324). */
    if (dr.flags & AF_DEBITS_MUST_NOT_EXCEED_CREDITS) {
        if (dr_dp + dr_dpo + amount > acc_cpo(dr)) return T_EXCEEDS_CREDITS;
    }
    if (cr.flags & AF_CREDITS_MUST_NOT_EXCEED_DEBITS) {
        if (cr_cp + cr_cpo + amount > acc_dpo(cr)) return T_EXCEEDS_DEBITS;
    }

    /* Insert + balance updates (state_machine.zig:1326-1367). */
    uint64_t ns = (uint64_t)pe.free_slot;
    tb_tr_slot &n = v->tr[ns];
    std::memset(&n, 0, sizeof(n));
    n.key_lo = t->id.lo;
    n.key_hi = t->id.hi;
    n.dr_lo = t->debit_account_id.lo; n.dr_hi = t->debit_account_id.hi;
    n.cr_lo = t->credit_account_id.lo; n.cr_hi = t->credit_account_id.hi;
    n.amt_lo = lo64(amount); n.amt_hi = hi64(amount);
    n.ud128_lo = t->user_data_128.lo; n.ud128_hi = t->user_data_128.hi;
    n.ud64 = t->user_data_64;
    n.ud32 = t->user_data_32;
    n.timeout = t->timeout;
    n.ledger = t->ledger;
    n.code = t->code;
    n.flags = t->flags;
    n.ts = timestamp;
    v->tr_count += 1;
    push_insert(sc, UNDO_TR_INSERT, ns);

    record_acc(sc, v, drs);
    record_acc(sc, v, crs);
    if (t->flags & TF_PENDING) {
        set_dp(dr, dr_dp + amount);
        set_cp(cr, cr_cp + amount);
    } else {
        set_dpo(dr, dr_dpo + amount);
        set_cpo(cr, cr_cpo + amount);
    }

    if ((dr.flags & AF_HISTORY) || (cr.flags & AF_HISTORY)) {
        int err = append_history(v, sc, timestamp, dr, cr);
        if (err != ENGINE_OK) { *engine_err = err; return 0; }
    }
    return T_OK;
}

/* -------------------------------------------------------------- execute
 *
 * Linked-chain driver (model.py execute :188-236; state_machine.zig
 * :1002-1088).  Templated over the two event kinds. */

/* Software prefetch: on the single-socket serving hosts this engine targets,
 * an insert's critical path is 2-4 dependent line fills (exists-probe, two
 * account slots); issuing them PF_DIST events ahead overlaps the DRAM
 * latency with the ladder's compute.  (The reference gets the same effect
 * from io_uring prefetch batching in its LSM groove.) */
static const uint64_t PF_DIST = 12;

static inline void prefetch_event(const tb_ledger_view *v,
                                  const tb_account_t *ev) {
    __builtin_prefetch(
        &v->acc[mix64(ev->id.lo, ev->id.hi) & (v->acc_cap - 1)], 1, 1);
}

static inline void prefetch_event(const tb_ledger_view *v,
                                  const tb_transfer_t *ev) {
    __builtin_prefetch(
        &v->tr[mix64(ev->id.lo, ev->id.hi) & (v->tr_cap - 1)], 1, 1);
    __builtin_prefetch(
        &v->acc[mix64(ev->debit_account_id.lo, ev->debit_account_id.hi) &
                (v->acc_cap - 1)], 1, 1);
    __builtin_prefetch(
        &v->acc[mix64(ev->credit_account_id.lo, ev->credit_account_id.hi) &
                (v->acc_cap - 1)], 1, 1);
    if (ev->pending_id.lo | ev->pending_id.hi)
        __builtin_prefetch(
            &v->tr[mix64(ev->pending_id.lo, ev->pending_id.hi) &
                   (v->tr_cap - 1)], 0, 1);
}

template <typename Event>
static int execute_batch(tb_ledger_view *v, const Event *events, uint64_t count,
                         uint64_t batch_ts, uint32_t *codes,
                         uint32_t (*one)(tb_ledger_view *, Scope &,
                                         const Event *, uint64_t, int *)) {
    Scope sc;
    int64_t chain = -1;
    bool chain_broken = false;
    int engine_err = ENGINE_OK;

    for (uint64_t i = 0; i < count && i < PF_DIST; i++)
        prefetch_event(v, &events[i]);

    for (uint64_t index = 0; index < count; index++) {
        if (index + PF_DIST < count)
            prefetch_event(v, &events[index + PF_DIST]);
        const Event *ev = &events[index];
        bool linked = (ev->flags & 1) != 0;
        int32_t result = -1;

        if (linked) {
            if (chain < 0) {
                chain = (int64_t)index;
                sc.open = true;
            }
            if (index == count - 1) result = 2; /* linked_event_chain_open */
        }
        if (result < 0 && chain_broken) result = 1; /* linked_event_failed */
        if (result < 0 && ev->timestamp != 0)
            result = 3; /* timestamp_must_be_zero */
        if (result < 0) {
            uint64_t ts = batch_ts - count + index + 1;
            result = (int32_t)one(v, sc, ev, ts, &engine_err);
            if (engine_err != ENGINE_OK) {
                /* Table needs growth: events [0, index) stay applied (each is
                 * independent; an open chain is rolled back).  Caller
                 * pre-sizes to keep this unreachable; fail loud if it fires. */
                if (sc.open) scope_undo(v, sc);
                return engine_err;
            }
        }

        if (result != 0) {
            if (chain >= 0 && !chain_broken) {
                chain_broken = true;
                scope_undo(v, sc);
                sc.open = false;
                for (int64_t ci = chain; ci < (int64_t)index; ci++)
                    codes[ci] = 1; /* linked_event_failed */
            }
            codes[index] = (uint32_t)result;
        } else {
            codes[index] = 0;
        }

        if (chain >= 0 && (!linked || result == 2)) {
            if (!chain_broken) {
                sc.recs.clear(); /* persist */
                sc.open = false;
            }
            chain = -1;
            chain_broken = false;
        }
    }
    return ENGINE_OK;
}

extern "C" {

int tb_engine_create_accounts(tb_ledger_view *v, const tb_account_t *events,
                              uint64_t count, uint64_t batch_ts,
                              uint32_t *codes) {
    return execute_batch<tb_account_t>(v, events, count, batch_ts, codes,
                                       create_account);
}

int tb_engine_create_transfers(tb_ledger_view *v, const tb_transfer_t *events,
                               uint64_t count, uint64_t batch_ts,
                               uint32_t *codes) {
    return execute_batch<tb_transfer_t>(v, events, count, batch_ts, codes,
                                        create_transfer);
}

/* Lookups (state_machine.zig:1091-1126): rows written as wire structs,
 * found[] per id. */
int tb_engine_lookup_accounts(const tb_ledger_view *v,
                              const tb_uint128_t *ids, uint64_t count,
                              tb_account_t *out, uint8_t *found) {
    for (uint64_t i = 0; i < count; i++) {
        found[i] = 0;
        std::memset(&out[i], 0, sizeof(tb_account_t));
        if ((ids[i].lo | ids[i].hi) == 0) continue;
        ProbeResult p = probe(v->acc, v->acc_cap, v->max_probe,
                              ids[i].lo, ids[i].hi);
        if (p.overflow) return ENGINE_PROBE_OVERFLOW;
        if (p.match < 0) continue;
        const tb_acc_slot &s = v->acc[(uint64_t)p.match];
        found[i] = 1;
        out[i].id = ids[i];
        out[i].debits_pending = {s.dp_lo, s.dp_hi};
        out[i].debits_posted = {s.dpo_lo, s.dpo_hi};
        out[i].credits_pending = {s.cp_lo, s.cp_hi};
        out[i].credits_posted = {s.cpo_lo, s.cpo_hi};
        out[i].user_data_128 = {s.ud128_lo, s.ud128_hi};
        out[i].user_data_64 = s.ud64;
        out[i].user_data_32 = s.ud32;
        out[i].reserved = 0;
        out[i].ledger = s.ledger;
        out[i].code = (uint16_t)s.code;
        out[i].flags = (uint16_t)s.flags;
        out[i].timestamp = s.ts;
    }
    return ENGINE_OK;
}

int tb_engine_lookup_transfers(const tb_ledger_view *v,
                               const tb_uint128_t *ids, uint64_t count,
                               tb_transfer_t *out, uint8_t *found) {
    for (uint64_t i = 0; i < count; i++) {
        found[i] = 0;
        std::memset(&out[i], 0, sizeof(tb_transfer_t));
        if ((ids[i].lo | ids[i].hi) == 0) continue;
        ProbeResult p = probe(v->tr, v->tr_cap, v->max_probe,
                              ids[i].lo, ids[i].hi);
        if (p.overflow) return ENGINE_PROBE_OVERFLOW;
        if (p.match < 0) continue;
        const tb_tr_slot &s = v->tr[(uint64_t)p.match];
        found[i] = 1;
        out[i].id = ids[i];
        out[i].debit_account_id = {s.dr_lo, s.dr_hi};
        out[i].credit_account_id = {s.cr_lo, s.cr_hi};
        out[i].amount = {s.amt_lo, s.amt_hi};
        out[i].pending_id = {s.pid_lo, s.pid_hi};
        out[i].user_data_128 = {s.ud128_lo, s.ud128_hi};
        out[i].user_data_64 = s.ud64;
        out[i].user_data_32 = s.ud32;
        out[i].timeout = s.timeout;
        out[i].ledger = s.ledger;
        out[i].code = (uint16_t)s.code;
        out[i].flags = (uint16_t)s.flags;
        out[i].timestamp = s.ts;
    }
    return ENGINE_OK;
}

/* Rehash every live entry of src's table into dst's (ht.grow: tombstones
 * dropped, old-slot-order insertion keeps placement deterministic and
 * identical to the device path's batched grow).  `which`: 0 = accounts,
 * 1 = transfers, 2 = posted.  dst arrays must be zeroed by the caller. */
int tb_engine_rehash(const tb_ledger_view *src, tb_ledger_view *dst,
                     int which) {
    if (which == 0) {
        dst->acc_count = 0;
        for (uint64_t s = 0; s < src->acc_cap; s++) {
            const tb_acc_slot &o = src->acc[s];
            if ((o.key_lo | o.key_hi) == 0) continue;
            ProbeResult p = probe(dst->acc, dst->acc_cap, dst->max_probe,
                                  o.key_lo, o.key_hi);
            if (p.overflow || p.free_slot < 0) return ENGINE_PROBE_OVERFLOW;
            dst->acc[(uint64_t)p.free_slot] = o;
            dst->acc[(uint64_t)p.free_slot].tomb = 0;
            dst->acc_count += 1;
        }
        return ENGINE_OK;
    }
    if (which == 1) {
        dst->tr_count = 0;
        for (uint64_t s = 0; s < src->tr_cap; s++) {
            const tb_tr_slot &o = src->tr[s];
            if ((o.key_lo | o.key_hi) == 0) continue;
            ProbeResult p = probe(dst->tr, dst->tr_cap, dst->max_probe,
                                  o.key_lo, o.key_hi);
            if (p.overflow || p.free_slot < 0) return ENGINE_PROBE_OVERFLOW;
            dst->tr[(uint64_t)p.free_slot] = o;
            dst->tr[(uint64_t)p.free_slot].tomb = 0;
            dst->tr_count += 1;
        }
        return ENGINE_OK;
    }
    if (which == 2) {
        dst->po_count = 0;
        for (uint64_t s = 0; s < src->po_cap; s++) {
            const tb_po_slot &o = src->po[s];
            if ((o.key_lo | o.key_hi) == 0) continue;
            ProbeResult p = probe(dst->po, dst->po_cap, dst->max_probe,
                                  o.key_lo, o.key_hi);
            if (p.overflow || p.free_slot < 0) return ENGINE_PROBE_OVERFLOW;
            dst->po[(uint64_t)p.free_slot] = o;
            dst->po[(uint64_t)p.free_slot].tomb = 0;
            dst->po_count += 1;
        }
        return ENGINE_OK;
    }
    return ENGINE_CAPACITY;
}

} /* extern "C" */
