"""The sequential commit path: full create_accounts / create_transfers
semantics, one event at a time (port of ``tigerbeetle_tpu/ops/scan_path.py``).

The fast path (``state_machine.py``) leaves out the order-dependent
features: balancing transfers, two-phase post/void with expiry, balance
limits, history rows, the exact overflow codes 47-53, and linked-chain
rollback interacting with duplicates.  This module runs a batch in event
order, as the reference's ``execute`` does (state_machine.zig:1002-1088,
:1239-1368 create_transfer, :1391-1498 post_or_void_pending_transfer).

Linked-chain rollback is an undo log: every accepted event records its two
account slots with their old balances, its transfer slot, its posted slot
and whether it appended a history row; when a chain breaks, the records of
the chain's earlier events are replayed in reverse (credit leg before debit
leg), restoring balances, tombstoning the inserts and popping history rows
(the rolled-back row stays in the array beyond ``count``).  The raw codes
then go through the fast path's ``_chain_codes``.

``create_transfers_seq`` and ``create_accounts_seq`` run kernels K6
(``csrc/sequential.cu`` ``seq_transfers``) and K7 (``seq_accounts``) on
CUDA tensors: one launch per batch.  On CPU tensors they run the plain
versions here, which loop over the events in Python with u128 values as
Python integers, and read and write the ledger's tensors element by element
in place; they serve the tests and the on-card check.  Each returns
``(ledger, codes int32[N], overflow bool 0-dim)``: ``overflow`` is set when
an insert's probe for a free slot reached ``MAX_PROBE`` (the reference then
writes at slot 0, and so does this port; the machine raises on the flag).

The helpers keep the JAX module's names so that each has an obvious
counterpart; they take and return Python integers (u64 bits, unsigned).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..u128 import i64
from . import _cuda
from . import hash_table as ht
from .state_machine import (
    ACCOUNT_BATCH_COLS,
    ACCOUNT_COLS,
    AF_CREDITS_MUST_NOT_EXCEED_DEBITS,
    AF_DEBITS_MUST_NOT_EXCEED_CREDITS,
    AF_HISTORY,
    AF_LINKED,
    AF_PADDING,
    BALANCE_COLS,
    HISTORY_COLS,
    MAX_PROBE,
    NS_PER_S,
    POSTED_COLS,
    TF_BALANCING_CREDIT,
    TF_BALANCING_DEBIT,
    TF_LINKED,
    TF_PADDING,
    TF_PENDING,
    TF_POST,
    TF_VOID,
    TRANSFER_BATCH_COLS,
    TRANSFER_COLS,
    U32,
    U64,
    Ledger,
    _chain_codes,
)

M64 = (1 << 64) - 1
M128 = (1 << 128) - 1
SENT = 1 << 63  # undo-slot sentinel
BALANCE_FIELDS = BALANCE_COLS  # the eight u64 balance columns, in order

_U32_FIELDS = ("user_data_32", "reserved", "timeout", "ledger", "code", "flags")
TRANSFER_BATCH_DTYPES = tuple(U32 if c in _U32_FIELDS else U64
                              for c in TRANSFER_BATCH_COLS)
ACCOUNT_BATCH_DTYPES = tuple(U32 if c in _U32_FIELDS else U64
                             for c in ACCOUNT_BATCH_COLS)


def _table_tensors(table: ht.Table, cols) -> List[torch.Tensor]:
    """A table as kernels K6/K7 take it: keys, tombstones, count, then the
    value columns in the kernel's order."""
    return ([table.key_lo, table.key_hi, table.tombstone, table.count]
            + [table.cols[c] for c in cols])


# ---------------------------------------------------------------------------
# Element access and scalar helpers (plain versions)
# ---------------------------------------------------------------------------


def _get(col: torch.Tensor, i: int) -> int:
    """Element ``i`` of a u64/u32/bool column as an unsigned Python int."""
    v = int(col[i])
    if col.dtype == torch.int64:
        return v & M64
    if col.dtype == torch.int32:
        return v & 0xFFFFFFFF
    return v


def _put(col: torch.Tensor, i: int, v: int) -> None:
    if col.dtype == torch.int64:
        col[i] = i64(v)
    elif col.dtype == torch.int32:
        v &= 0xFFFFFFFF
        col[i] = v - (1 << 32) if v >> 31 else v
    else:
        col[i] = bool(v)


def _mix64(lo: int, hi: int) -> int:
    """``u128.mix64`` on one key (Python ints)."""
    x = (lo ^ (hi * 0x9E3779B97F4A7C15)) & M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


def _u128(row: Dict[str, int], name: str) -> int:
    return row[name + "_lo"] | (row[name + "_hi"] << 64)


def _first_code(checks) -> int:
    """First firing (condition, code) wins — scalar precedence ladder."""
    for cond, c in checks:
        if cond:
            return c
    return 0


def _slookup(table: ht.Table, lo: int, hi: int) -> Tuple[bool, int]:
    """Scalar lookup (``ht.lookup`` with ``MAX_PROBE``): (found, slot); the
    slot is 0 where not found.  Tombstones are skipped; an empty slot ends
    the probe."""
    if lo == 0 and hi == 0:
        return False, 0
    mask = table.capacity - 1
    home = _mix64(lo, hi) & mask
    for i in range(MAX_PROBE):
        cur = (home + i) & mask
        if _get(table.tombstone, cur):
            continue
        t_lo, t_hi = _get(table.key_lo, cur), _get(table.key_hi, cur)
        if t_lo == lo and t_hi == hi:
            return True, cur
        if t_lo == 0 and t_hi == 0:
            return False, 0
    return False, 0


def _sprobe_free(table: ht.Table, lo: int, hi: int) -> Tuple[int, bool]:
    """The insert slot of a new key: the first truly empty slot (key 0, no
    tombstone) of its probe sequence, and whether the probe reached
    ``MAX_PROBE`` instead (the slot is then 0, as in the reference)."""
    mask = table.capacity - 1
    home = _mix64(lo, hi) & mask
    for i in range(MAX_PROBE):
        cur = (home + i) & mask
        if (_get(table.key_lo, cur) == 0 and _get(table.key_hi, cur) == 0
                and not _get(table.tombstone, cur)):
            return cur, False
    return 0, True


def _gather_row(table: ht.Table, slot: int, valid: bool) -> Dict[str, int]:
    return {name: _get(col, slot) if valid else 0
            for name, col in table.cols.items()}


def _set_row(table: ht.Table, slot: int, do: bool, lo: int, hi: int,
             row: Dict[str, int]) -> None:
    if not do:
        return
    for name, col in table.cols.items():
        _put(col, slot, row[name])
    _put(table.key_lo, slot, lo)
    _put(table.key_hi, slot, hi)
    _put(table.tombstone, slot, False)
    table.count += 1


def _update_cols(table: ht.Table, slot: int, do: bool,
                 updates: Dict[str, int]) -> None:
    if do:
        for name, val in updates.items():
            _put(table.cols[name], slot, val)


def _tombstone(table: ht.Table, slot: int, do: bool) -> None:
    if do:
        _put(table.key_lo, slot, 0)
        _put(table.key_hi, slot, 0)
        _put(table.tombstone, slot, True)
        table.count -= 1


def _balances(row: Dict[str, int]) -> Dict[str, int]:
    return {
        "dp": _u128(row, "debits_pending"),
        "dpo": _u128(row, "debits_posted"),
        "cp": _u128(row, "credits_pending"),
        "cpo": _u128(row, "credits_posted"),
    }


def _balance_updates(b: Dict[str, int]) -> Dict[str, int]:
    out = {}
    for short, field in (("dp", "debits_pending"), ("dpo", "debits_posted"),
                         ("cp", "credits_pending"), ("cpo", "credits_posted")):
        out[field + "_lo"] = b[short] & M64
        out[field + "_hi"] = b[short] >> 64
    return out


def _balance_lanes(b: Dict[str, int]) -> List[int]:
    u = _balance_updates(b)
    return [u[f] for f in BALANCE_FIELDS]


def _add(a: int, b: int) -> Tuple[int, bool]:
    """u128 add: (sum mod 2**128, overflow)."""
    s = a + b
    return s & M128, s > M128


def _events(batch: Dict[str, torch.Tensor], names) -> List[Dict[str, int]]:
    cols = {name: [v & (M64 if batch[name].dtype == torch.int64
                        else 0xFFFFFFFF) for v in batch[name].tolist()]
            for name in names}
    n = batch[names[0]].shape[0]
    return [{name: cols[name][i] for name in names} for i in range(n)]


# ---------------------------------------------------------------------------
# create_transfers — sequential
# ---------------------------------------------------------------------------


def create_transfers_seq(
    ledger: Ledger, batch: Dict[str, torch.Tensor], count: int, timestamp: int
) -> Tuple[Ledger, torch.Tensor, torch.Tensor]:
    """Sequential create_transfers with full semantics: updates the ledger
    in place; returns (ledger, codes int32[N], overflow bool 0-dim).
    Kernel K6 on CUDA tensors, one launch per batch."""
    if batch["id_lo"].is_cuda:
        h = ledger.history
        codes, overflow = _cuda.seq_transfers(
            [batch[c] for c in TRANSFER_BATCH_COLS], TRANSFER_BATCH_DTYPES,
            _table_tensors(ledger.accounts, ACCOUNT_COLS),
            tuple(ACCOUNT_COLS.values()),
            _table_tensors(ledger.transfers, TRANSFER_COLS),
            tuple(TRANSFER_COLS.values()),
            _table_tensors(ledger.posted, POSTED_COLS),
            [h.cols[c] for c in HISTORY_COLS] + [h.count], count, timestamp)
        return ledger, codes, overflow
    return create_transfers_seq_plain(ledger, batch, count, timestamp)


def create_transfers_seq_plain(ledger, batch, count, timestamp):
    """Plain version of kernel K6 (the JAX ``lax.scan``, as a Python loop)."""
    n = batch["id_lo"].shape[0]
    evs = _events(batch, TRANSFER_BATCH_COLS)
    ts_base = (timestamp - count + 1) & M64
    undo: List[dict] = [None] * n
    raw = [0] * n
    overflow = False
    chain_start, chain_broken = -1, False
    for i in range(n):
        ev = evs[i]
        active = i < count
        linked = active and (ev["flags"] & TF_LINKED) != 0
        if linked and chain_start < 0:
            chain_start = i  # chain opening (state_machine.zig:1022-1027)
        in_chain = chain_start >= 0
        chain_open_err = linked and i == count - 1
        ev_ts = (ts_base + i) & M64

        code, effects = _transfer_logic(ledger, ev, ev_ts, timestamp)
        # execute()-level preemptions, in order (state_machine.zig:1021-1041).
        if ev["timestamp"] != 0:
            code = 3
        if chain_broken:
            code = 1
        if chain_open_err:
            code = 2
        if not active:
            code = 0
        ok = active and code == 0

        undo[i], capped = _apply_transfer(ledger, effects, ok)
        overflow |= capped
        raw[i] = code

        # Chain break -> roll back chain_start..i-1 in reverse
        # (state_machine.zig:1051-1066).
        if active and code != 0 and in_chain and not chain_broken:
            for idx in range(i - 1, chain_start - 1, -1):
                u = undo[idx]
                for leg in (1, 0):
                    slot = u["acc_slot"][leg]
                    _update_cols(ledger.accounts, slot, slot < SENT,
                                 dict(zip(BALANCE_FIELDS, u["acc_vals"][leg])))
                _tombstone(ledger.transfers, u["tr_slot"], u["tr_slot"] < SENT)
                _tombstone(ledger.posted, u["posted_slot"],
                           u["posted_slot"] < SENT)
                # Pop the history append; the row stays beyond count.
                ledger.history.count -= int(u["hist"])
            chain_broken = True

        # Chain termination (state_machine.zig:1074-1082).
        if in_chain and (not linked or chain_open_err):
            chain_start, chain_broken = -1, False

    dev = batch["id_lo"].device
    lanes = torch.arange(n, device=dev)
    linked_mask = ((batch["flags"] & TF_LINKED) != 0) & (lanes < count)
    codes = _chain_codes(linked_mask,
                         torch.tensor(raw, dtype=torch.int32, device=dev), count)
    return ledger, codes, torch.tensor(overflow, device=dev)


def _transfer_logic(ledger: Ledger, ev, ev_ts: int, batch_ts: int):
    """Full create_transfer decision logic for one event: (code, effects).
    Effects carry everything ``_apply_transfer`` needs."""
    tid_lo, tid_hi = ev["id_lo"], ev["id_hi"]
    tid = _u128(ev, "id")
    flags = ev["flags"]
    post = (flags & TF_POST) != 0
    void = (flags & TF_VOID) != 0
    postvoid = post or void
    pending_f = (flags & TF_PENDING) != 0
    bal_dr = (flags & TF_BALANCING_DEBIT) != 0
    bal_cr = (flags & TF_BALANCING_CREDIT) != 0
    t_amount = _u128(ev, "amount")
    pend_id = _u128(ev, "pending_id")
    t_dr_id = _u128(ev, "debit_account_id")
    t_cr_id = _u128(ev, "credit_account_id")

    # Pending-transfer gather (post/void path, state_machine.zig:1409-1419).
    p_found, p_slot = _slookup(ledger.transfers, ev["pending_id_lo"],
                               ev["pending_id_hi"])
    p = _gather_row(ledger.transfers, p_slot, p_found)
    p_is_pending = (p["flags"] & TF_PENDING) != 0
    p_amount = _u128(p, "amount")
    p_ts = p["timestamp"]

    # Which accounts do we operate on?
    dr_id = _u128(p, "debit_account_id") if postvoid else t_dr_id
    cr_id = _u128(p, "credit_account_id") if postvoid else t_cr_id
    dr_found, dr_slot = _slookup(ledger.accounts, dr_id & M64, dr_id >> 64)
    cr_found, cr_slot = _slookup(ledger.accounts, cr_id & M64, cr_id >> 64)
    dr = _gather_row(ledger.accounts, dr_slot, dr_found)
    cr = _gather_row(ledger.accounts, cr_slot, cr_found)
    drb = _balances(dr)
    crb = _balances(cr)

    # Existing transfer with our id (state_machine.zig:1284, 1438).
    e_found, e_slot = _slookup(ledger.transfers, tid_lo, tid_hi)
    e = _gather_row(ledger.transfers, e_slot, e_found)

    # Posted groove (state_machine.zig:1440-1445).
    posted_found, posted_slot = _slookup(ledger.posted, p_ts, 0)
    posted_val = _gather_row(ledger.posted, posted_slot,
                             posted_found)["fulfillment"]

    # ---------------- regular path (state_machine.zig:1239-1368) ----------
    # Balancing clamp (:1286-1306).
    amount0 = M64 if (bal_dr or bal_cr) and t_amount == 0 else t_amount
    dr_balance = (drb["dpo"] + drb["dp"]) & M128
    avail_dr = max(drb["cpo"] - dr_balance, 0)  # sub_saturate
    amount1 = min(amount0, avail_dr) if bal_dr else amount0
    exceeds_credits_bal = bal_dr and amount1 == 0
    cr_balance = (crb["cpo"] + crb["cp"]) & M128
    avail_cr = max(crb["dpo"] - cr_balance, 0)  # sub_saturate
    amount2 = min(amount1, avail_cr) if bal_cr else amount1
    exceeds_debits_bal = bal_cr and not exceeds_credits_bal and amount2 == 0
    amount = amount2

    # Overflow ladder (:1308-1322).
    ov_dp = _add(amount, drb["dp"])[1]
    ov_cp = _add(amount, crb["cp"])[1]
    ov_dpo = _add(amount, drb["dpo"])[1]
    ov_cpo = _add(amount, crb["cpo"])[1]
    dr_total, _ = _add(drb["dp"], drb["dpo"])
    ov_d = _add(amount, dr_total)[1]
    cr_total, _ = _add(crb["cp"], crb["cpo"])
    ov_c = _add(amount, cr_total)[1]
    timeout_ns = ev["timeout"] * NS_PER_S  # u32 widened unsigned
    ts_sum = (ev_ts + timeout_ns) & M64
    ov_timeout = ts_sum < ev_ts

    # Limits (tigerbeetle.zig:31-39).
    dr_lim = (dr["flags"] & AF_DEBITS_MUST_NOT_EXCEED_CREDITS) != 0
    new_dr_tot = _add(dr_total, amount)[0]
    exceeds_credits_lim = dr_lim and new_dr_tot > drb["cpo"]
    cr_lim = (cr["flags"] & AF_CREDITS_MUST_NOT_EXCEED_DEBITS) != 0
    new_cr_tot = _add(cr_total, amount)[0]
    exceeds_debits_lim = cr_lim and new_cr_tot > crb["dpo"]

    exists_code = _exists_transfer_scalar(ev, e)

    regular_code = _first_code([
        ((flags & TF_PADDING) != 0, 4),
        (tid == 0, 5),
        (tid == M128, 6),
        (t_dr_id == 0, 8),
        (t_dr_id == M128, 9),
        (t_cr_id == 0, 10),
        (t_cr_id == M128, 11),
        (t_dr_id == t_cr_id, 12),
        (pend_id != 0, 13),
        (not pending_f and ev["timeout"] != 0, 17),
        (not bal_dr and not bal_cr and t_amount == 0, 18),
        (ev["ledger"] == 0, 19),
        (ev["code"] == 0, 20),
        (not dr_found, 21),
        (not cr_found, 22),
        (dr["ledger"] != cr["ledger"], 23),
        (ev["ledger"] != dr["ledger"], 24),
        (e_found, exists_code),
        (exceeds_credits_bal, 54),
        (exceeds_debits_bal, 55),
        (pending_f and ov_dp, 47),
        (pending_f and ov_cp, 48),
        (ov_dpo, 49),
        (ov_cpo, 50),
        (ov_d, 51),
        (ov_c, 52),
        (ov_timeout, 53),
        (exceeds_credits_lim, 54),
        (exceeds_debits_lim, 55),
    ])

    # ---------------- post/void path (state_machine.zig:1391-1498) --------
    pv_amount = t_amount if t_amount != 0 else p_amount
    pv_exists_code = _exists_postvoid_scalar(ev, e, p)
    expiry_ns = p["timeout"] * NS_PER_S
    expired = p["timeout"] != 0 and ev_ts >= ((p_ts + expiry_ns) & M64)

    pv_code = _first_code([
        ((flags & TF_PADDING) != 0, 4),
        (tid == 0, 5),
        (tid == M128, 6),
        (post and void, 7),
        (pending_f, 7),
        (bal_dr, 7),
        (bal_cr, 7),
        (pend_id == 0, 14),
        (pend_id == M128, 15),
        (pend_id == tid, 16),
        (ev["timeout"] != 0, 17),
        (not p_found, 25),
        (not p_is_pending, 26),
        (t_dr_id != 0 and t_dr_id != _u128(p, "debit_account_id"), 27),
        (t_cr_id != 0 and t_cr_id != _u128(p, "credit_account_id"), 28),
        (ev["ledger"] != 0 and ev["ledger"] != p["ledger"], 29),
        (ev["code"] != 0 and ev["code"] != p["code"], 30),
        (pv_amount > p_amount, 31),
        (void and pv_amount < p_amount, 32),
        (e_found, pv_exists_code),
        (posted_found and posted_val == 1, 33),
        (posted_found and posted_val == 2, 34),
        (expired, 35),
    ])

    code = pv_code if postvoid else regular_code

    # ---------------- effects --------------------------------------------
    def pick(name):
        return ev[name] if ev[name] != 0 else p[name]

    row = {name: ev[name] for name in TRANSFER_COLS}
    row["timestamp"] = ev_ts
    # Regular path stores the clamped amount (state_machine.zig:1326-1328).
    stored = pv_amount if postvoid else amount
    row["amount_lo"], row["amount_hi"] = stored & M64, stored >> 64
    if postvoid:
        # Post/void row composition (state_machine.zig:1455-1469).
        for name in ("debit_account_id_lo", "debit_account_id_hi",
                     "credit_account_id_lo", "credit_account_id_hi",
                     "ledger", "code"):
            row[name] = p[name]
        if ev["user_data_128_lo"] == 0 and ev["user_data_128_hi"] == 0:
            row["user_data_128_lo"] = p["user_data_128_lo"]
            row["user_data_128_hi"] = p["user_data_128_hi"]
        row["user_data_64"] = pick("user_data_64")
        row["user_data_32"] = pick("user_data_32")
        row["timeout"] = 0

    # Balance deltas.
    eff_amount = pv_amount if postvoid else amount
    new_drb, new_crb = dict(drb), dict(crb)
    if postvoid:
        # Release pending; a post adds posted (state_machine.zig:1481-1491).
        posted_amt = eff_amount if post else 0
        new_drb["dp"] = (drb["dp"] - p_amount) & M128
        new_drb["dpo"] = (drb["dpo"] + posted_amt) & M128
        new_crb["cp"] = (crb["cp"] - p_amount) & M128
        new_crb["cpo"] = (crb["cpo"] + posted_amt) & M128
    elif pending_f:
        # Regular: pending -> dp/cp else dpo/cpo (state_machine.zig:1330-1338).
        new_drb["dp"] = (drb["dp"] + eff_amount) & M128
        new_crb["cp"] = (crb["cp"] + eff_amount) & M128
    else:
        new_drb["dpo"] = (drb["dpo"] + eff_amount) & M128
        new_crb["cpo"] = (crb["cpo"] + eff_amount) & M128

    effects = {
        "tid": (tid_lo, tid_hi),
        "row": row,
        "dr_slot": dr_slot,
        "cr_slot": cr_slot,
        "old_dr": _balance_lanes(drb),
        "old_cr": _balance_lanes(crb),
        "new_dr": _balance_updates(new_drb),
        "new_cr": _balance_updates(new_crb),
        "postvoid": postvoid,
        "posted_key": p_ts,
        "posted_val": 1 if post else 2,
        # History recording inputs (state_machine.zig:1342-1364).
        "dr_id": dr_id,
        "cr_id": cr_id,
        "dr_hist": (dr["flags"] & AF_HISTORY) != 0,
        "cr_hist": (cr["flags"] & AF_HISTORY) != 0,
        "ev_ts": ev_ts,
    }
    return code, effects


def _apply_transfer(ledger: Ledger, eff, ok: bool):
    """Apply one event's effects (when ok): (undo entry, whether an insert
    probe reached MAX_PROBE)."""
    _update_cols(ledger.accounts, eff["dr_slot"], ok, eff["new_dr"])
    _update_cols(ledger.accounts, eff["cr_slot"], ok, eff["new_cr"])

    capped = False
    t_slot = SENT
    if ok:
        t_slot, capped = _sprobe_free(ledger.transfers, *eff["tid"])
        _set_row(ledger.transfers, t_slot, True, *eff["tid"], eff["row"])

    # Posted insert (post/void only).
    p_slot = SENT
    if ok and eff["postvoid"]:
        p_slot, p_capped = _sprobe_free(ledger.posted, eff["posted_key"], 0)
        capped |= p_capped
        _set_row(ledger.posted, p_slot, True, eff["posted_key"], 0,
                 {"fulfillment": eff["posted_val"]})

    # History append (state_machine.zig:1342-1364): regular path only, when
    # either account carries the history flag; a side without the flag
    # stays zero.  The host grows the log first, so count < capacity; a row
    # past the capacity would be dropped while count still advances.
    h = ledger.history
    do_hist = ok and not eff["postvoid"] and (eff["dr_hist"] or eff["cr_hist"])
    if do_hist:
        idx = int(h.count)
        if idx < h.capacity:
            hist_row = {"timestamp": eff["ev_ts"]}
            for prefix, on, id128, bal in (
                ("dr", eff["dr_hist"], eff["dr_id"], eff["new_dr"]),
                ("cr", eff["cr_hist"], eff["cr_id"], eff["new_cr"]),
            ):
                hist_row[f"{prefix}_id_lo"] = id128 & M64 if on else 0
                hist_row[f"{prefix}_id_hi"] = id128 >> 64 if on else 0
                for short, field in (
                    ("dp", "debits_pending"), ("dpo", "debits_posted"),
                    ("cp", "credits_pending"), ("cpo", "credits_posted"),
                ):
                    for s in ("_lo", "_hi"):
                        hist_row[f"{prefix}_{short}{s}"] = (
                            bal[field + s] if on else 0)
            for name in HISTORY_COLS:
                _put(h.cols[name], idx, hist_row[name])
        h.count += 1

    undo = {
        "acc_slot": (eff["dr_slot"] if ok else SENT,
                     eff["cr_slot"] if ok else SENT),
        "acc_vals": (eff["old_dr"], eff["old_cr"]),
        "tr_slot": t_slot,
        "posted_slot": p_slot,
        "hist": do_hist,
    }
    return undo, capped


def _exists_transfer_scalar(t, e) -> int:
    """create_transfer_exists (state_machine.zig:1370-1389), scalar."""

    def ne128(name):
        return _u128(t, name) != _u128(e, name)

    return _first_code([
        (t["flags"] != e["flags"], 36),
        (ne128("debit_account_id"), 37),
        (ne128("credit_account_id"), 38),
        (ne128("amount"), 39),
        (ne128("pending_id"), 40),
        (ne128("user_data_128"), 41),
        (t["user_data_64"] != e["user_data_64"], 42),
        (t["user_data_32"] != e["user_data_32"], 43),
        (t["timeout"] != e["timeout"], 44),
        (t["code"] != e["code"], 45),
    ]) or 46


def _exists_postvoid_scalar(t, e, p) -> int:
    """post_or_void_pending_transfer_exists (state_machine.zig:1500-1561)."""

    def ne(a, b, name):
        if name.endswith("_32") or name.endswith("_64"):
            return a[name] != b[name]
        return _u128(a, name) != _u128(b, name)

    def field_ne(name, zero):
        # A zero field of the event compares the stored row with the pending.
        return ne(e, p, name) if zero else ne(t, e, name)

    return _first_code([
        (t["flags"] != e["flags"], 36),
        (field_ne("amount", _u128(t, "amount") == 0), 39),
        (ne(t, e, "pending_id"), 40),
        (field_ne("user_data_128", _u128(t, "user_data_128") == 0), 41),
        (field_ne("user_data_64", t["user_data_64"] == 0), 42),
        (field_ne("user_data_32", t["user_data_32"] == 0), 43),
    ]) or 46


# ---------------------------------------------------------------------------
# create_accounts — sequential
# ---------------------------------------------------------------------------


def create_accounts_seq(
    ledger: Ledger, batch: Dict[str, torch.Tensor], count: int, timestamp: int
) -> Tuple[Ledger, torch.Tensor, torch.Tensor]:
    """Sequential create_accounts with chain rollback: updates the accounts
    table in place; returns (ledger, codes int32[N], overflow bool 0-dim).
    Kernel K7 on CUDA tensors, one launch per batch."""
    if batch["id_lo"].is_cuda:
        codes, overflow = _cuda.seq_accounts(
            [batch[c] for c in ACCOUNT_BATCH_COLS], ACCOUNT_BATCH_DTYPES,
            _table_tensors(ledger.accounts, ACCOUNT_COLS),
            tuple(ACCOUNT_COLS.values()), count, timestamp)
        return ledger, codes, overflow
    return create_accounts_seq_plain(ledger, batch, count, timestamp)


def create_accounts_seq_plain(ledger, batch, count, timestamp):
    """Plain version of kernel K7."""
    n = batch["id_lo"].shape[0]
    evs = _events(batch, ACCOUNT_BATCH_COLS)
    ts_base = (timestamp - count + 1) & M64
    acc_ins_slot = [SENT] * n
    raw = [0] * n
    overflow = False
    chain_start, chain_broken = -1, False
    accounts = ledger.accounts
    for i in range(n):
        ev = evs[i]
        active = i < count
        linked = active and (ev["flags"] & AF_LINKED) != 0
        if linked and chain_start < 0:
            chain_start = i
        in_chain = chain_start >= 0
        chain_open_err = linked and i == count - 1
        ev_ts = (ts_base + i) & M64

        code = _account_logic(ledger, ev)
        if ev["timestamp"] != 0:
            code = 3
        if chain_broken:
            code = 1
        if chain_open_err:
            code = 2
        if not active:
            code = 0
        ok = active and code == 0

        if ok:
            slot, capped = _sprobe_free(accounts, ev["id_lo"], ev["id_hi"])
            overflow |= capped
            row = {name: ev[name] for name in ACCOUNT_COLS if name != "timestamp"}
            row["timestamp"] = ev_ts
            _set_row(accounts, slot, True, ev["id_lo"], ev["id_hi"], row)
            acc_ins_slot[i] = slot
        raw[i] = code

        if active and code != 0 and in_chain and not chain_broken:
            for idx in range(i - 1, chain_start - 1, -1):
                s = acc_ins_slot[idx]
                _tombstone(accounts, s, s < SENT)
            chain_broken = True

        if in_chain and (not linked or chain_open_err):
            chain_start, chain_broken = -1, False

    dev = batch["id_lo"].device
    lanes = torch.arange(n, device=dev)
    linked_mask = ((batch["flags"] & AF_LINKED) != 0) & (lanes < count)
    codes = _chain_codes(linked_mask,
                         torch.tensor(raw, dtype=torch.int32, device=dev), count)
    return ledger, codes, torch.tensor(overflow, device=dev)


def _account_logic(ledger: Ledger, ev) -> int:
    """create_account checks (state_machine.zig:1198-1237), scalar."""
    aid = _u128(ev, "id")
    flags = ev["flags"]
    found, slot = _slookup(ledger.accounts, ev["id_lo"], ev["id_hi"])
    e = _gather_row(ledger.accounts, slot, found)
    exists_code = _first_code([
        (ev["flags"] != e["flags"], 15),
        (_u128(ev, "user_data_128") != _u128(e, "user_data_128"), 16),
        (ev["user_data_64"] != e["user_data_64"], 17),
        (ev["user_data_32"] != e["user_data_32"], 18),
        (ev["ledger"] != e["ledger"], 19),
        (ev["code"] != e["code"], 20),
    ]) or 21
    return _first_code([
        (ev["reserved"] != 0, 4),
        ((flags & AF_PADDING) != 0, 5),
        (aid == 0, 6),
        (aid == M128, 7),
        ((flags & AF_DEBITS_MUST_NOT_EXCEED_CREDITS) != 0
         and (flags & AF_CREDITS_MUST_NOT_EXCEED_DEBITS) != 0, 8),
        (_u128(ev, "debits_pending") != 0, 9),
        (_u128(ev, "debits_posted") != 0, 10),
        (_u128(ev, "credits_pending") != 0, 11),
        (_u128(ev, "credits_posted") != 0, 12),
        (ev["ledger"] == 0, 13),
        (ev["code"] == 0, 14),
        (found, exists_code),
    ])
