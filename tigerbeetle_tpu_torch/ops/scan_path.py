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
CUDA tensors.  K6 is two steps: K32 (``seq_prepass``) probes every event
against the tables as they were before the batch, in parallel, and joins
the batch with itself; then one block walks the events in order from those
records and an overlay of the batch's own writes, reading the tables only
where a pre-batch answer went stale.  K7 is the same two steps for
accounts: a pre-pass over the card (each event's static code and its
probe of the table before the batch; marks on the events whose answer may
depend on order: chains, capped probes, first empty slots another event
shares), then one thread walks only the marked events, and a last launch
writes every event's code and row.  On CPU tensors
they run the plain versions here, which loop over the events in Python with
u128 values as Python integers, and read and write the ledger's tensors
element by element in place; they serve the tests and the on-card check.
K6 has two plain forms with the same results: the serial loop
(``create_transfers_seq_plain``, the JAX scan's mirror) and the split form
the card runs (``create_transfers_seq_split_plain``: ``seq_prepass_plain``
then ``seq_sequencer_plain``); so has K7 (``create_accounts_seq_plain``
and ``create_accounts_seq_split_plain``: ``seqa_prepass_plain`` then
``seqa_sequencer_plain``).  Each returns
``(ledger, codes int32[N], overflow bool 0-dim)``: ``overflow`` is set when
an insert's probe for a free slot reached ``MAX_PROBE`` (the reference then
writes at slot 0, and so does this port; the machine raises on the flag).

The helpers keep the JAX module's names so that each has an obvious
counterpart; they take and return Python integers (u64 bits, unsigned).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..u128 import i64
from ..utils.benchgen import mix64_np
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


def _free_from(table: ht.Table, home: int, t0: int) -> Tuple[int, bool]:
    """The first truly empty slot of a probe sequence from step ``t0`` on:
    (slot, capped); (0, True) when none is left within MAX_PROBE steps."""
    mask = table.capacity - 1
    for t in range(t0, MAX_PROBE):
        cur = (home + t) & mask
        if (not _get(table.tombstone, cur) and _get(table.key_lo, cur) == 0
                and _get(table.key_hi, cur) == 0):
            return cur, False
    return 0, True


def _sprobe_free(table: ht.Table, lo: int, hi: int) -> Tuple[int, bool]:
    """The insert slot of a new key: the first truly empty slot (key 0, no
    tombstone) of its probe sequence, and whether the probe reached
    ``MAX_PROBE`` instead (the slot is then 0, as in the reference)."""
    return _free_from(table, _mix64(lo, hi) & (table.capacity - 1), 0)


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
    Kernel K6 on CUDA tensors: K32's pre-pass, then the sequencer, on the
    first ``count`` lanes (``_k6_lanes``: any batch width, a count of at
    most SEQ_MAX_N)."""
    if batch["id_lo"].is_cuda:
        h = ledger.history
        n = batch["id_lo"].shape[0]
        codes, overflow = _cuda.seq_transfers(
            *_k6_tables(ledger, _k6_lanes(batch, count)),
            [h.cols[c] for c in HISTORY_COLS] + [h.count], count, timestamp)
        return ledger, _pad_codes(codes, n), overflow
    return create_transfers_seq_plain(ledger, batch, count, timestamp)


def _k6_lanes(batch: Dict[str, torch.Tensor], count: int
              ) -> Dict[str, torch.Tensor]:
    """The lanes of ``batch`` that K6 (and its split plain form) runs: the
    first ``count``, rounded up to a multiple of 64 and at most the batch's
    width; the lanes past ``count`` are inactive and answer 0
    (``_pad_codes``).  The sequencer's overlay holds SEQ_MAX_N events, so a
    larger count raises CudaKernelError before anything is launched or
    written."""
    if count > SEQ_MAX_N:
        raise _cuda.CudaKernelError(
            f"seq_transfers: a count of {count} events; the sequencer takes "
            f"at most {SEQ_MAX_N}")
    n = batch["id_lo"].shape[0]
    m = min(n, max(64, -(-count // 64) * 64))
    return batch if m == n else {k: v[:m] for k, v in batch.items()}


def _pad_codes(codes: torch.Tensor, n: int) -> torch.Tensor:
    """``codes`` of the first lanes, padded to ``n`` with the inactive
    lanes' 0."""
    if codes.shape[0] == n:
        return codes
    return torch.cat([codes, codes.new_zeros(n - codes.shape[0])])


def _k6_tables(ledger: Ledger, batch: Dict[str, torch.Tensor]):
    """The batch and tables as K32 and K6 take them."""
    return ([batch[c] for c in TRANSFER_BATCH_COLS], TRANSFER_BATCH_DTYPES,
            _table_tensors(ledger.accounts, ACCOUNT_COLS),
            tuple(ACCOUNT_COLS.values()),
            _table_tensors(ledger.transfers, TRANSFER_COLS),
            tuple(TRANSFER_COLS.values()),
            _table_tensors(ledger.posted, POSTED_COLS))


def seq_prepass(ledger: Ledger, batch: Dict[str, torch.Tensor], count: int,
                timestamp: int) -> Dict[str, torch.Tensor]:
    """K6's pre-pass alone (the ledger is only read): kernel K32 on CUDA
    tensors, ``seq_prepass_plain`` on CPU tensors."""
    if batch["id_lo"].is_cuda:
        return _cuda.seq_prepass(*_k6_tables(ledger, batch), count, timestamp)
    return seq_prepass_plain(ledger, batch, count, timestamp)


def create_transfers_seq_plain(ledger, batch, count, timestamp):
    """Plain version of kernel K6 (the JAX ``lax.scan``, as a Python loop)."""
    n = batch["id_lo"].shape[0]
    evs = _events(batch, TRANSFER_BATCH_COLS)
    run = _SerialRun(count, timestamp, n)
    raw = [_serial_event(ledger, evs[i], i, run) for i in range(n)]
    return ledger, *_finish_codes(batch, raw, count, run.overflow)


class _SerialRun:
    """What the serial loop carries from event to event."""

    def __init__(self, count: int, timestamp: int, n: int):
        self.count, self.timestamp = count, timestamp
        self.ts_base = (timestamp - count + 1) & M64
        self.undo: List[dict] = [None] * n
        self.chain_start, self.chain_broken = -1, False
        self.overflow = False


def _serial_event(ledger, ev, i: int, run: _SerialRun) -> int:
    """One event of the serial loop, every probe and row read from the
    ledger as the earlier events left it: its raw code."""
    active = i < run.count
    linked = active and (ev["flags"] & TF_LINKED) != 0
    if linked and run.chain_start < 0:
        run.chain_start = i  # chain opening (state_machine.zig:1022-1027)
    in_chain = run.chain_start >= 0
    chain_open_err = linked and i == run.count - 1
    ev_ts = (run.ts_base + i) & M64

    code, effects = _transfer_logic(ledger, ev, ev_ts, run.timestamp)
    # execute()-level preemptions, in order (state_machine.zig:1021-1041).
    if ev["timestamp"] != 0:
        code = 3
    if run.chain_broken:
        code = 1
    if chain_open_err:
        code = 2
    if not active:
        code = 0
    ok = active and code == 0

    run.undo[i], capped = _apply_transfer(ledger, effects, ok)
    run.overflow |= capped

    # Chain break -> roll back chain_start..i-1 in reverse
    # (state_machine.zig:1051-1066).
    if active and code != 0 and in_chain and not run.chain_broken:
        for idx in range(i - 1, run.chain_start - 1, -1):
            u = run.undo[idx]
            for leg in (1, 0):
                slot = u["acc_slot"][leg]
                _update_cols(ledger.accounts, slot, slot < SENT,
                             dict(zip(BALANCE_FIELDS, u["acc_vals"][leg])))
            _tombstone(ledger.transfers, u["tr_slot"], u["tr_slot"] < SENT)
            _tombstone(ledger.posted, u["posted_slot"],
                       u["posted_slot"] < SENT)
            # Pop the history append; the row stays beyond count.
            ledger.history.count -= int(u["hist"])
        run.chain_broken = True

    # Chain termination (state_machine.zig:1074-1082).
    if in_chain and (not linked or chain_open_err):
        run.chain_start, run.chain_broken = -1, False
    return code


def _finish_codes(batch, raw: List[int], count: int, overflow: bool):
    """The chain-code pass over the raw codes: (codes, overflow)."""
    dev = batch["id_lo"].device
    n = len(raw)
    lanes = torch.arange(n, device=dev)
    linked_mask = ((batch["flags"] & TF_LINKED) != 0) & (lanes < count)
    codes = _chain_codes(linked_mask,
                         torch.tensor(raw, dtype=torch.int32, device=dev), count)
    return codes, torch.tensor(overflow, device=dev)


def _transfer_logic(ledger: Ledger, ev, ev_ts: int, batch_ts: int):
    """Full create_transfer decision logic for one event: (code, effects).
    Effects carry everything ``_apply_transfer`` needs."""
    postvoid = (ev["flags"] & (TF_POST | TF_VOID)) != 0
    # Pending-transfer gather (post/void path, state_machine.zig:1409-1419).
    p_found, p_slot = _slookup(ledger.transfers, ev["pending_id_lo"],
                               ev["pending_id_hi"])
    p = _gather_row(ledger.transfers, p_slot, p_found)

    # Which accounts do we operate on?
    dr_id = (_u128(p, "debit_account_id") if postvoid
             else _u128(ev, "debit_account_id"))
    cr_id = (_u128(p, "credit_account_id") if postvoid
             else _u128(ev, "credit_account_id"))
    dr_found, dr_slot = _slookup(ledger.accounts, dr_id & M64, dr_id >> 64)
    cr_found, cr_slot = _slookup(ledger.accounts, cr_id & M64, cr_id >> 64)
    dr = _gather_row(ledger.accounts, dr_slot, dr_found)
    cr = _gather_row(ledger.accounts, cr_slot, cr_found)

    # Existing transfer with our id (state_machine.zig:1284, 1438).
    e_found, e_slot = _slookup(ledger.transfers, ev["id_lo"], ev["id_hi"])
    e = _gather_row(ledger.transfers, e_slot, e_found)

    # Posted groove (state_machine.zig:1440-1445).
    posted_found, posted_slot = _slookup(ledger.posted, p["timestamp"], 0)
    posted_val = _gather_row(ledger.posted, posted_slot,
                             posted_found)["fulfillment"]
    return _transfer_decide(ev, ev_ts, p_found, p, dr_found, dr_slot, dr,
                            cr_found, cr_slot, cr, e_found, e, posted_found,
                            posted_val)


def _transfer_decide(ev, ev_ts: int, p_found: bool, p, dr_found: bool,
                     dr_slot: int, dr, cr_found: bool, cr_slot: int, cr,
                     e_found: bool, e, posted_found: bool, posted_val: int):
    """The precedence ladders and the effects of one event over its
    gathered inputs (the pending row ``p``, the accounts' rows ``dr`` and
    ``cr``, the stored row ``e`` with the event's id, the posted row's
    fulfillment): (code, effects)."""
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
    p_is_pending = (p["flags"] & TF_PENDING) != 0
    p_amount = _u128(p, "amount")
    p_ts = p["timestamp"]
    dr_id = _u128(p, "debit_account_id") if postvoid else t_dr_id
    cr_id = _u128(p, "credit_account_id") if postvoid else t_cr_id
    drb = _balances(dr)
    crb = _balances(cr)

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

    # History append (regular path only).
    do_hist = ok and not eff["postvoid"] and (eff["dr_hist"] or eff["cr_hist"])
    if do_hist:
        _append_history(ledger.history, eff)

    undo = {
        "acc_slot": (eff["dr_slot"] if ok else SENT,
                     eff["cr_slot"] if ok else SENT),
        "acc_vals": (eff["old_dr"], eff["old_cr"]),
        "tr_slot": t_slot,
        "posted_slot": p_slot,
        "hist": do_hist,
    }
    return undo, capped


def _append_history(h, eff) -> None:
    """History append (state_machine.zig:1342-1364): regular path only, when
    either account carries the history flag; a side without the flag stays
    zero.  The host grows the log first, so count < capacity; a row past the
    capacity would be dropped while count still advances."""
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
# create_transfers — the split form: pre-pass (K32) and sequencer (K6)
# ---------------------------------------------------------------------------

# K32's record of one event (csrc/sequential.cu SeqRecField, REC_WORDS).
SEQ_REC_FIELDS = (
    "bits", "id_grp", "pend_grp", "kgrp",
    "eslot", "et", "pslot",
    "dr_slot", "cr_slot", "dr_dense", "cr_dense", "dr_fl", "cr_fl",
    "key", "kslot", "kt", "kval",
    "p_flags_timeout", "p_ledger_code", "p_ud32", "p_ts", "p_ud64",
    "p_ud128_lo", "p_ud128_hi", "p_amount_lo", "p_amount_hi",
    "p_dr_lo", "p_dr_hi", "p_cr_lo", "p_cr_hi",
    "e_flags_timeout", "e_code_ud32", "e_dr_lo", "e_dr_hi", "e_cr_lo",
    "e_cr_hi", "e_amount_lo", "e_amount_hi", "e_pending_lo", "e_pending_hi",
    "e_ud128_lo", "e_ud128_hi", "e_ud64",
    "v_id_lo", "v_id_hi", "v_dr_lo", "v_dr_hi", "v_cr_lo", "v_cr_hi",
    "v_amount_lo", "v_amount_hi", "v_pending_lo", "v_pending_hi",
    "v_ud128_lo", "v_ud128_hi", "v_ud64", "v_ud32_timeout", "v_ledger_code",
    "v_flags", "v_timestamp", "scode",
)
R = {name: k for k, name in enumerate(SEQ_REC_FIELDS)}
SEQ_REC_WORDS = 64
SEQ_MAX_N = _cuda.SEQ_MAX_N  # the widest batch the sequencer's overlay holds
SEQ_NONE = M64  # no group, no dense index (all ones)
# R_BITS (csrc/sequential.cu RB_*).
RB_ACTIVE, RB_EFOUND, RB_ECAP, RB_PFOUND, RB_PCAND, RB_PCLAMP, RB_LEGS, \
    RB_DRF, RB_CRF, RB_KKEY, RB_KFOUND, RB_KCAP = (1 << k for k in range(12))

# Event columns in the record: (record field, batch column, shift).
_REC_EVENT = (
    ("v_id_lo", "id_lo"), ("v_id_hi", "id_hi"),
    ("v_dr_lo", "debit_account_id_lo"), ("v_dr_hi", "debit_account_id_hi"),
    ("v_cr_lo", "credit_account_id_lo"), ("v_cr_hi", "credit_account_id_hi"),
    ("v_amount_lo", "amount_lo"), ("v_amount_hi", "amount_hi"),
    ("v_pending_lo", "pending_id_lo"), ("v_pending_hi", "pending_id_hi"),
    ("v_ud128_lo", "user_data_128_lo"), ("v_ud128_hi", "user_data_128_hi"),
    ("v_ud64", "user_data_64"), ("v_flags", "flags"),
    ("v_timestamp", "timestamp"),
)
# A stored transfer's columns in the record's P and E rows: (field, column,
# second column in the high half or None).
_REC_P = (
    ("p_flags_timeout", "flags", "timeout"), ("p_ledger_code", "ledger", "code"),
    ("p_ud32", "user_data_32", None), ("p_ts", "timestamp", None),
    ("p_ud64", "user_data_64", None), ("p_ud128_lo", "user_data_128_lo", None),
    ("p_ud128_hi", "user_data_128_hi", None), ("p_amount_lo", "amount_lo", None),
    ("p_amount_hi", "amount_hi", None), ("p_dr_lo", "debit_account_id_lo", None),
    ("p_dr_hi", "debit_account_id_hi", None),
    ("p_cr_lo", "credit_account_id_lo", None),
    ("p_cr_hi", "credit_account_id_hi", None),
)
_REC_E = (
    ("e_flags_timeout", "flags", "timeout"), ("e_code_ud32", "code", "user_data_32"),
    ("e_dr_lo", "debit_account_id_lo", None), ("e_dr_hi", "debit_account_id_hi", None),
    ("e_cr_lo", "credit_account_id_lo", None), ("e_cr_hi", "credit_account_id_hi", None),
    ("e_amount_lo", "amount_lo", None), ("e_amount_hi", "amount_hi", None),
    ("e_pending_lo", "pending_id_lo", None), ("e_pending_hi", "pending_id_hi", None),
    ("e_ud128_lo", "user_data_128_lo", None), ("e_ud128_hi", "user_data_128_hi", None),
    ("e_ud64", "user_data_64", None),
)


def _u(t: torch.Tensor) -> torch.Tensor:
    """A u64/u32 column as int64 holding its unsigned bits."""
    if t.dtype == torch.int64:
        return t
    return t.to(torch.int64) & 0xFFFFFFFF


def _probe_vec(table: ht.Table, lo, hi, valid):
    """``_slookup``'s walk for many keys at once, with where it ended:
    (found, slot, t, capped).  ``slot`` is the key's slot, else the first
    truly empty slot (0 when capped); ``t`` the step (MAX_PROBE when
    capped).  Lanes not ``valid`` give zeros."""
    from ..u128 import mix64

    mask = table.capacity - 1
    home = mix64(lo, hi) & mask
    null = (lo == 0) & (hi == 0)
    found = torch.zeros_like(valid)
    slot = torch.zeros_like(lo)
    t_end = torch.zeros_like(lo)
    done = ~valid
    for t in range(MAX_PROBE):
        if bool(done.all()):
            break
        cur = (home + t) & mask
        tomb = table.tombstone[cur]
        a, b = table.key_lo[cur], table.key_hi[cur]
        empty = ~tomb & (a == 0) & (b == 0)
        hit = ~tomb & ~null & (a == lo) & (b == hi) & ~empty
        stop = ~done & (empty | hit)
        found |= stop & hit
        slot = torch.where(stop, cur, slot)
        t_end = torch.where(stop, torch.full_like(t_end, t), t_end)
        done |= stop
    capped = ~done
    t_end = torch.where(capped, torch.full_like(t_end, MAX_PROBE), t_end)
    return found, slot, t_end, capped


def _probe_full(table: ht.Table, lo: int, hi: int):
    """``_probe_vec`` of one key (Python ints): (found, slot, t, capped)."""
    null = lo == 0 and hi == 0
    mask = table.capacity - 1
    home = _mix64(lo, hi) & mask
    for t in range(MAX_PROBE):
        cur = (home + t) & mask
        if _get(table.tombstone, cur):
            continue
        a, b = _get(table.key_lo, cur), _get(table.key_hi, cur)
        if a == 0 and b == 0:
            return False, cur, t, False
        if not null and a == lo and b == hi:
            return True, cur, t, False
    return False, 0, MAX_PROBE, True


def _static_code(ev, dr_found: bool, cr_found: bool, dr_ledger: int,
                 cr_ledger: int) -> int:
    """The ladders' checks that read only the event and whether its accounts
    exist and their ledgers, which a transfers batch never changes (K32's
    R_SCODE): the first code that fires, else 0."""
    flags = ev["flags"]
    tid = _u128(ev, "id")
    post, void = (flags & TF_POST) != 0, (flags & TF_VOID) != 0
    pending_f = (flags & TF_PENDING) != 0
    bal_dr = (flags & TF_BALANCING_DEBIT) != 0
    bal_cr = (flags & TF_BALANCING_CREDIT) != 0
    pend_id = _u128(ev, "pending_id")
    t_dr_id = _u128(ev, "debit_account_id")
    t_cr_id = _u128(ev, "credit_account_id")
    head = [((flags & TF_PADDING) != 0, 4), (tid == 0, 5), (tid == M128, 6)]
    if not (post or void):
        return _first_code(head + [
            (t_dr_id == 0, 8), (t_dr_id == M128, 9), (t_cr_id == 0, 10),
            (t_cr_id == M128, 11), (t_dr_id == t_cr_id, 12), (pend_id != 0, 13),
            (not pending_f and ev["timeout"] != 0, 17),
            (not bal_dr and not bal_cr and _u128(ev, "amount") == 0, 18),
            (ev["ledger"] == 0, 19), (ev["code"] == 0, 20),
            (not dr_found, 21), (not cr_found, 22),
            (dr_ledger != cr_ledger, 23), (ev["ledger"] != dr_ledger, 24),
        ])
    return _first_code(head + [
        (post and void, 7), (pending_f or bal_dr or bal_cr, 7),
        (pend_id == 0, 14), (pend_id == M128, 15), (pend_id == tid, 16),
        (ev["timeout"] != 0, 17),
    ])


def seq_prepass_plain(ledger: Ledger, batch: Dict[str, torch.Tensor],
                      count: int, timestamp: int) -> Dict[str, torch.Tensor]:
    """Plain version of kernel K32: every event's probes against the tables
    as they are before the batch (vectorized walks), then the batch's joins
    with itself (Python dicts: the lowest event of each id, the lowest leg
    of each account slot, the lowest occurrence of each posted key).
    Returns the kernel's outputs: ``rec`` int64[n, 64], ``bal`` int64[2n,
    8], ``dslot`` int64[2n]."""
    acc, xfr, pst = ledger.accounts, ledger.transfers, ledger.posted
    n = batch["id_lo"].shape[0]
    dev = batch["id_lo"].device
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    act = torch.arange(n, device=dev) < count
    cols = {c: _u(batch[c]) for c in TRANSFER_BATCH_COLS}
    flags = cols["flags"]
    postvoid = act & ((flags & (TF_POST | TF_VOID)) != 0)
    rec = torch.zeros((n, SEQ_REC_WORDS), dtype=torch.int64, device=dev)

    def put(name, value, where=act):
        rec[:, R[name]] = torch.where(where, value, zero)

    def row_fields(table, slot, where, spec):
        for name, col, high in spec:
            v = _u(table.cols[col][slot])
            if high is not None:
                v = v | (_u(table.cols[high][slot]) << 32)
            put(name, v, where)

    for name, col in _REC_EVENT:
        put(name, cols[col])
    put("v_ud32_timeout", cols["user_data_32"] | (cols["timeout"] << 32))
    put("v_ledger_code", cols["ledger"] | (cols["code"] << 32))
    bits = torch.where(act, RB_ACTIVE, 0)
    # The event's id.
    ef, es, et, ecap = _probe_vec(xfr, cols["id_lo"], cols["id_hi"], act)
    bits |= torch.where(ef, RB_EFOUND, 0) | torch.where(ecap & act, RB_ECAP, 0)
    put("eslot", es)
    put("et", et)
    row_fields(xfr, es, ef, _REC_E)
    # The pending transfer, its accounts and its posted key.
    pf, ps, _, _ = _probe_vec(xfr, cols["pending_id_lo"], cols["pending_id_hi"],
                              postvoid)
    bits |= torch.where(pf, RB_PFOUND, 0)
    put("pslot", ps, pf)
    row_fields(xfr, ps, pf, _REC_P)
    legs = act & (~postvoid | pf)
    bits |= torch.where(legs, RB_LEGS, 0)
    for side, (fl, prefix, col) in enumerate(((RB_DRF, "dr", "debit_account_id"),
                                              (RB_CRF, "cr", "credit_account_id"))):
        lo = torch.where(pf, _u(xfr.cols[col + "_lo"][ps]), cols[col + "_lo"])
        hi = torch.where(pf, _u(xfr.cols[col + "_hi"][ps]), cols[col + "_hi"])
        af, aslot, _, _ = _probe_vec(acc, lo, hi, legs)
        bits |= torch.where(af, fl, 0)
        put(prefix + "_slot", aslot, af)
        put(prefix + "_fl", _u(acc.cols["flags"][aslot])
            | (_u(acc.cols["ledger"][aslot]) << 32), af)
    key = rec[:, R["p_ts"]]
    kf, ks, kt, kcap = _probe_vec(pst, key, zero, pf)
    bits |= (torch.where(pf, RB_KKEY, 0) | torch.where(kf, RB_KFOUND, 0)
             | torch.where(kcap & pf, RB_KCAP, 0))
    put("key", key, pf)
    put("kslot", ks, pf)
    put("kt", kt, pf)
    put("kval", _u(pst.cols["fulfillment"][ks]), kf)
    rec[:, R["bits"]] = bits

    # The joins, in event order (the lowest index wins).
    r = [[v & M64 for v in row] for row in rec.tolist()]
    evs = _events(batch, TRANSFER_BATCH_COLS)
    for e in range(count):
        x = r[e]
        x[R["scode"]] = _static_code(
            evs[e], bool(x[R["bits"]] & RB_DRF), bool(x[R["bits"]] & RB_CRF),
            x[R["dr_fl"]] >> 32, x[R["cr_fl"]] >> 32)
    ts_base = (timestamp - count + 1) & M64
    ids, slots, keys = {}, {}, {}
    for e in range(count):
        x = r[e]
        ids.setdefault((x[R["v_id_lo"]], x[R["v_id_hi"]]), e)
        if x[R["bits"]] & RB_LEGS:
            slots.setdefault(x[R["dr_slot"]], 2 * e)
            slots.setdefault(x[R["cr_slot"]], 2 * e + 1)
        f = x[R["v_flags"]]
        if x[R["bits"]] & RB_PFOUND:
            keys.setdefault(x[R["p_ts"]], 2 * e)
        elif f & TF_PENDING and not f & (TF_POST | TF_VOID):
            keys.setdefault((ts_base + e) & M64, 2 * e + 1)
    bal = [[0] * 8 for _ in range(2 * n)]
    dslot = [SEQ_NONE] * (2 * n)
    for e in range(count):
        x = r[e]
        b = x[R["bits"]]
        for f in ("id_grp", "pend_grp", "kgrp", "dr_dense", "cr_dense"):
            x[R[f]] = SEQ_NONE
        x[R["id_grp"]] = ids[(x[R["v_id_lo"]], x[R["v_id_hi"]])]
        if x[R["v_flags"]] & (TF_POST | TF_VOID):
            c = ids.get((x[R["v_pending_lo"]], x[R["v_pending_hi"]]), SEQ_NONE)
            x[R["pend_grp"]] = c
            cf = r[c][R["v_flags"]] if c != SEQ_NONE else 0
            if (not b & RB_PFOUND and c != SEQ_NONE and cf & TF_PENDING
                    and not cf & (TF_POST | TF_VOID)):
                y = r[c]
                b |= RB_PCAND | RB_LEGS | (y[R["bits"]] & (RB_DRF | RB_CRF))
                if cf & (TF_BALANCING_DEBIT | TF_BALANCING_CREDIT):
                    b |= RB_PCLAMP
                x[R["p_flags_timeout"]] = cf | (y[R["v_ud32_timeout"]] >> 32 << 32)
                x[R["p_ledger_code"]] = y[R["v_ledger_code"]]
                x[R["p_ud32"]] = y[R["v_ud32_timeout"]] & 0xFFFFFFFF
                x[R["p_ts"]] = (ts_base + c) & M64
                for dst, src in (("p_ud64", "v_ud64"), ("p_ud128_lo", "v_ud128_lo"),
                                 ("p_ud128_hi", "v_ud128_hi"),
                                 ("p_amount_lo", "v_amount_lo"),
                                 ("p_amount_hi", "v_amount_hi"),
                                 ("p_dr_lo", "v_dr_lo"), ("p_dr_hi", "v_dr_hi"),
                                 ("p_cr_lo", "v_cr_lo"), ("p_cr_hi", "v_cr_hi"),
                                 ("dr_slot", "dr_slot"), ("cr_slot", "cr_slot"),
                                 ("dr_fl", "dr_fl"), ("cr_fl", "cr_fl")):
                    x[R[dst]] = y[R[src]]
                found, slot, t, capped = _probe_full(pst, x[R["p_ts"]], 0)
                b |= RB_KKEY | (RB_KFOUND if found else 0) | (RB_KCAP if capped else 0)
                x[R["key"]] = x[R["p_ts"]]
                x[R["kslot"]], x[R["kt"]] = slot, t
                x[R["kval"]] = _get(pst.cols["fulfillment"], slot) if found else 0
        if b & RB_LEGS:
            for side, prefix in enumerate(("dr", "cr")):
                slot = x[R[prefix + "_slot"]]
                d = slots[slot]
                x[R[prefix + "_dense"]] = d
                if d == 2 * e + side:
                    bal[d] = [_get(acc.cols[c], slot) for c in BALANCE_FIELDS]
                    dslot[d] = slot
        if b & RB_KKEY:
            x[R["kgrp"]] = keys[x[R["key"]]]
        x[R["bits"]] = b

    def t64(rows):
        return torch.tensor([[i64(v) for v in row] for row in rows],
                            dtype=torch.int64, device=dev).reshape(len(rows), -1)

    return {"rec": t64(r), "bal": t64(bal).reshape(2 * n, 8),
            "dslot": torch.tensor([i64(v) for v in dslot], dtype=torch.int64,
                                  device=dev)}


def _row_from_rec(x, spec) -> Dict[str, int]:
    """A stored transfer's fields (TRANSFER_COLS names) from a record."""
    row = {c: 0 for c in TRANSFER_COLS}
    for name, col, high in spec:
        v = x[R[name]]
        if high is None:
            row[col] = v
        else:
            row[col], row[high] = v & 0xFFFFFFFF, v >> 32
    return row


class _Overlay:
    """The sequencer's state besides the tables: the dense balances, each
    id group's latest inserting event, each event's inserted slots and
    whether they are live, each posted-key group's latest inserting event,
    and the serial loop's chain state (shared with serial mode)."""

    def __init__(self, pre, count: int, timestamp: int, n: int):
        self.rec = [[v & M64 for v in row] for row in pre["rec"].tolist()]
        self.bal = [[v & M64 for v in row] for row in pre["bal"].tolist()]
        self.dslot = [v & M64 for v in pre["dslot"].tolist()]
        self.ins_last: Dict[int, int] = {}
        self.ins: Dict[int, List] = {}  # event -> [slot, live]
        self.pst_last: Dict[int, int] = {}
        self.pst: Dict[int, List] = {}  # event -> [slot, live, voided]
        self.pst_dirty = False
        self.serial = False
        self.run = _SerialRun(count, timestamp, n)

    def write_back(self, accounts: ht.Table) -> None:
        for d, slot in enumerate(self.dslot):
            if slot != SEQ_NONE:
                _update_cols(accounts, slot, True,
                             dict(zip(BALANCE_FIELDS, self.bal[d])))


def seq_sequencer_plain(ledger: Ledger, batch: Dict[str, torch.Tensor],
                        count: int, timestamp: int, pre):
    """Plain version of K6's sequencer: the events in order, each from its
    K32 record and the overlay (``_Overlay``), the tables read only where
    the overlay says a pre-batch answer went stale: (codes, overflow).
    Refuses what the kernel refuses: more than SEQ_MAX_N lanes, or a
    transfers or posted table of more than SEQ_MAX_SLOTS slots."""
    n = batch["id_lo"].shape[0]
    if (n > SEQ_MAX_N or max(ledger.transfers.capacity,
                             ledger.posted.capacity) > _cuda.SEQ_MAX_SLOTS):
        raise ValueError(f"{n} lanes or a table of more than "
                         f"{_cuda.SEQ_MAX_SLOTS} slots: the sequencer takes "
                         f"at most {SEQ_MAX_N} lanes")
    evs = _events(batch, TRANSFER_BATCH_COLS)
    ov = _Overlay(pre, count, timestamp, n)
    raw = [0] * n
    for e in range(count):
        if ov.serial:
            raw[e] = _serial_event(ledger, evs[e], e, ov.run)
            continue
        raw[e] = _fast_event(ledger, ov, e, evs[e])
        if ov.serial:  # a capped insert: the rest as the serial loop
            ov.write_back(ledger.accounts)
    if not ov.serial:
        ov.write_back(ledger.accounts)
    return _finish_codes(batch, raw, count, ov.run.overflow)


def _fast_event(ledger: Ledger, ov: _Overlay, e: int, ev) -> int:
    """One event of the sequencer's fast mode (csrc/sequential.cu
    fast_event): its raw code."""
    run = ov.run
    x = ov.rec[e]
    bits = x[R["bits"]]
    xfr, pst = ledger.transfers, ledger.posted
    undo = {"acc_slot": (SENT, SENT), "acc_vals": ([0] * 8, [0] * 8),
            "tr_slot": SENT, "posted_slot": SENT, "hist": False,
            "dense": (SENT, SENT)}
    run.undo[e] = undo
    flags = ev["flags"]
    linked = (flags & TF_LINKED) != 0
    if linked and run.chain_start < 0:
        run.chain_start = e
    in_chain = run.chain_start >= 0
    chain_open_err = linked and e == run.count - 1
    ev_ts = (run.ts_base + e) & M64
    code = (2 if chain_open_err else 1 if run.chain_broken
            else 3 if ev["timestamp"] != 0 else 0)
    if code == 0:
        postvoid = (flags & (TF_POST | TF_VOID)) != 0
        p_found, p_slow, legs = False, False, x
        p = {c: 0 for c in TRANSFER_COLS}
        if postvoid and bits & RB_PFOUND:
            p_found = True
        elif postvoid and x[R["pend_grp"]] != SEQ_NONE:
            grp = x[R["pend_grp"]]
            j = ov.ins_last.get(grp)
            if j is not None and ov.ins[j][1]:
                p_found = True
                if j != grp or not bits & RB_PCAND:
                    p_slow = True
                    p = _gather_row(xfr, ov.ins[j][0], True)
                    legs = ov.rec[j]
        if p_found and not p_slow:
            p = _row_from_rec(x, _REC_P)
            if bits & RB_PCLAMP:  # the stored amount may be clamped
                s = ov.ins[ov.ins_last[x[R["pend_grp"]]]][0]
                p["amount_lo"] = _get(xfr.cols["amount_lo"], s)
                p["amount_hi"] = _get(xfr.cols["amount_hi"], s)
        # The accounts.
        acc_rows, acc_found, acc_slot, dense = [], [], [], []
        use_legs = legs[R["bits"]] & RB_LEGS and (not postvoid or p_found)
        for fl, prefix in ((RB_DRF, "dr"), (RB_CRF, "cr")):
            found = bool(use_legs and legs[R["bits"]] & fl)
            row = {c: 0 for c in ACCOUNT_COLS}
            if use_legs:
                d = legs[R[prefix + "_dense"]]
                row["flags"] = legs[R[prefix + "_fl"]] & 0xFFFFFFFF
                row["ledger"] = legs[R[prefix + "_fl"]] >> 32
                if found:
                    row.update(zip(BALANCE_FIELDS, ov.bal[d]))
            else:
                d = SENT
            if not found:
                row["flags"] = row["ledger"] = 0
            acc_rows.append(row)
            acc_found.append(found)
            acc_slot.append(legs[R[prefix + "_slot"]] if use_legs else 0)
            dense.append(d)
        # A stored transfer with this id.
        if bits & RB_EFOUND:
            e_found, erow = True, _row_from_rec(x, _REC_E)
        else:
            j = ov.ins_last.get(x[R["id_grp"]])
            e_found = j is not None and ov.ins[j][1]
            erow = (_gather_row(xfr, ov.ins[j][0], True) if e_found
                    else {c: 0 for c in TRANSFER_COLS})
        # The posted row of the pending's timestamp.
        pst_walk = postvoid and p_found and (p_slow or ov.pst_dirty)
        posted_found, posted_val = False, 0
        if pst_walk:
            posted_found, ps = _slookup(pst, p["timestamp"], 0)
            posted_val = _get(pst.cols["fulfillment"], ps) if posted_found else 0
        elif postvoid and p_found:
            if bits & RB_KFOUND:
                posted_found, posted_val = True, x[R["kval"]]
            else:
                j = ov.pst_last.get(x[R["kgrp"]] >> 1)
                if j is not None and ov.pst[j][1]:
                    posted_found, posted_val = True, 2 if ov.pst[j][2] else 1
        code, eff = _transfer_decide(
            ev, ev_ts, p_found, p, acc_found[0], acc_slot[0], acc_rows[0],
            acc_found[1], acc_slot[1], acc_rows[1], e_found, erow,
            posted_found, posted_val)
        if code == 0:
            _fast_apply(ledger, ov, e, x, ev, eff, dense, undo, pst_walk)

    if code != 0 and in_chain and not run.chain_broken:
        for j in range(e - 1, run.chain_start - 1, -1):
            u = run.undo[j]
            if u["acc_slot"][1] < SENT:
                ov.bal[u["dense"][1]] = list(u["acc_vals"][1])
            if u["acc_slot"][0] < SENT:
                ov.bal[u["dense"][0]] = list(u["acc_vals"][0])
            if u["tr_slot"] < SENT:
                _tombstone(xfr, u["tr_slot"], True)
                ov.ins[j][1] = False
            if u["posted_slot"] < SENT:
                _tombstone(pst, u["posted_slot"], True)
                ov.pst[j][1] = False
            ledger.history.count -= int(u["hist"])
        run.chain_broken = True
    if in_chain and (not linked or chain_open_err):
        run.chain_start, run.chain_broken = -1, False
    return code


def _fast_apply(ledger: Ledger, ov: _Overlay, e: int, x, ev, eff, dense,
                undo, pst_walk: bool) -> None:
    """An accepted event's writes in fast mode: the dense balances, the
    transfer row at its pre-batch free slot while that is still truly empty
    (else the walk on), the posted row likewise, the history row."""
    xfr, pst = ledger.transfers, ledger.posted
    bits = x[R["bits"]]
    new = [[eff["new_dr"][f] for f in BALANCE_FIELDS],
           [eff["new_cr"][f] for f in BALANCE_FIELDS]]
    undo["acc_slot"] = (eff["dr_slot"], eff["cr_slot"])
    undo["acc_vals"] = (eff["old_dr"], eff["old_cr"])
    undo["dense"] = tuple(dense)
    ov.bal[dense[0]] = new[0]
    ov.bal[dense[1]] = new[1]

    def place(table, lo, hi, f0, t0):
        if (_get(table.key_lo, f0) == 0 and _get(table.key_hi, f0) == 0
                and not _get(table.tombstone, f0)):
            return f0, False
        return _free_from(table, _mix64(lo, hi) & (table.capacity - 1), t0)

    tid = eff["tid"]
    if bits & RB_ECAP:
        s, capped = 0, True
    else:
        s, capped = place(xfr, *tid, x[R["eslot"]], x[R["et"]])
    if capped:
        s = 0
        ov.run.overflow = ov.serial = True
    _set_row(xfr, s, True, *tid, eff["row"])
    undo["tr_slot"] = s
    ov.ins[e] = [s, True]
    ov.ins_last[x[R["id_grp"]]] = e
    if eff["postvoid"]:
        key = eff["posted_key"]
        home = _mix64(key, 0) & (pst.capacity - 1)
        if pst_walk or bits & RB_KFOUND:
            ps, pcapped = _free_from(pst, home, 0)
            ov.pst_dirty |= pst_walk
        elif bits & RB_KCAP:
            ps, pcapped = 0, True
        else:
            ps, pcapped = place(pst, key, 0, x[R["kslot"]], x[R["kt"]])
        if pcapped:
            ps = 0
            ov.run.overflow = ov.serial = True
        _set_row(pst, ps, True, key, 0, {"fulfillment": eff["posted_val"]})
        undo["posted_slot"] = ps
        ov.pst[e] = [ps, True, eff["posted_val"] == 2]
        if not pst_walk:
            ov.pst_last[x[R["kgrp"]] >> 1] = e
    elif eff["dr_hist"] or eff["cr_hist"]:
        _append_history(ledger.history, eff)
        undo["hist"] = True


def create_transfers_seq_split_plain(ledger, batch, count, timestamp):
    """Plain version of K6 as the card runs it: the pre-pass
    (``seq_prepass_plain``) then the sequencer (``seq_sequencer_plain``) on
    the lanes ``_k6_lanes`` keeps.  The same results as
    ``create_transfers_seq_plain``, byte for byte; a count above SEQ_MAX_N
    raises CudaKernelError, as the card does."""
    n = batch["id_lo"].shape[0]
    batch = _k6_lanes(batch, count)
    pre = seq_prepass_plain(ledger, batch, count, timestamp)
    codes, overflow = seq_sequencer_plain(ledger, batch, count, timestamp, pre)
    return ledger, _pad_codes(codes, n), overflow


# ---------------------------------------------------------------------------
# create_accounts — sequential
# ---------------------------------------------------------------------------


def create_accounts_seq(
    ledger: Ledger, batch: Dict[str, torch.Tensor], count: int, timestamp: int
) -> Tuple[Ledger, torch.Tensor, torch.Tensor]:
    """Sequential create_accounts with chain rollback: updates the accounts
    table in place; returns (ledger, codes int32[N], overflow bool 0-dim).
    Kernel K7 on CUDA tensors: a memset, the two pre-pass launches, the
    sequencer and the finish."""
    if batch["id_lo"].is_cuda:
        codes, overflow = _cuda.seq_accounts(
            [batch[c] for c in ACCOUNT_BATCH_COLS], ACCOUNT_BATCH_DTYPES,
            _table_tensors(ledger.accounts, ACCOUNT_COLS),
            tuple(ACCOUNT_COLS.values()), count, timestamp)
        return ledger, codes, overflow
    return create_accounts_seq_plain(ledger, batch, count, timestamp)


def create_accounts_seq_plain(ledger, batch, count, timestamp):
    """Plain version of kernel K7: the serial loop."""
    n = batch["id_lo"].shape[0]
    evs = _events(batch, ACCOUNT_BATCH_COLS)
    raw = [0] * n
    overflow = _accounts_loop(ledger, evs, count, timestamp, 0, -1, False,
                              [SENT] * n, raw)
    return ledger, _account_chain_codes(batch, raw, count), torch.tensor(
        overflow, device=batch["id_lo"].device)


def _account_chain_codes(batch, raw: List[int], count: int) -> torch.Tensor:
    dev = batch["id_lo"].device
    n = len(raw)
    lanes = torch.arange(n, device=dev)
    linked_mask = ((batch["flags"] & AF_LINKED) != 0) & (lanes < count)
    return _chain_codes(linked_mask,
                        torch.tensor(raw, dtype=torch.int32, device=dev), count)


def _accounts_loop(ledger, evs, count: int, timestamp: int, i0: int,
                   chain_start: int, chain_broken: bool, acc_ins_slot,
                   raw: List[int]) -> bool:
    """Events ``i0`` on, one at a time, from the chain state at ``i0``;
    their raw codes into ``raw``, their inserted slots into
    ``acc_ins_slot``.  Returns whether an insert's probe was capped."""
    ts_base = (timestamp - count + 1) & M64
    overflow = False
    accounts = ledger.accounts
    for i in range(i0, len(evs)):
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
    return overflow


# K7's split form (csrc/sequential.cu, seqa_*): the pre-pass record's bits.
AR_ACTIVE, AR_LINKED, AR_FOUND = 1 << 16, 1 << 17, 1 << 18
AR_CAPPED, AR_CAND = 1 << 19, 1 << 20
SEQA_NONE, SEQA_MULTI = -1, -2  # no candidate holds an F; several do


def _np_u(t: torch.Tensor):
    """A u64/u32 column as an unsigned numpy array (a copy)."""
    a = t.cpu().numpy()
    return a.view(np.uint64) if a.dtype == np.int64 else (
        a.view(np.uint32) if a.dtype == np.int32 else a.copy())


def _account_static_codes(ev, n: int, count: int):
    """The ladder's codes that read only the event (3-14), 0 elsewhere or
    on lanes past ``count``."""
    z = np.uint64(0)
    flags = ev["flags"]
    nonzero = lambda f: (ev[f + "_lo"] != z) | (ev[f + "_hi"] != z)  # noqa: E731
    m64 = np.uint64(M64)
    conds = [
        ev["timestamp"] != z, ev["reserved"] != 0,
        (flags & AF_PADDING) != 0, ~nonzero("id"),
        (ev["id_lo"] == m64) & (ev["id_hi"] == m64),
        ((flags & AF_DEBITS_MUST_NOT_EXCEED_CREDITS) != 0)
        & ((flags & AF_CREDITS_MUST_NOT_EXCEED_DEBITS) != 0),
        nonzero("debits_pending"), nonzero("debits_posted"),
        nonzero("credits_pending"), nonzero("credits_posted"),
        ev["ledger"] == 0, ev["code"] == 0,
    ]
    codes = np.select(conds, list(range(3, 15)), 0).astype(np.int64)
    codes[count:] = 0
    return codes


def _account_exists_codes(ev, rows, idx):
    """Codes 15-21 of events ``idx`` against the rows ``rows`` (a dict of
    the account columns, one entry per event of ``idx``)."""
    conds = [
        ev["flags"][idx] != rows["flags"],
        (ev["user_data_128_lo"][idx] != rows["user_data_128_lo"])
        | (ev["user_data_128_hi"][idx] != rows["user_data_128_hi"]),
        ev["user_data_64"][idx] != rows["user_data_64"],
        ev["user_data_32"][idx] != rows["user_data_32"],
        ev["ledger"][idx] != rows["ledger"],
        ev["code"][idx] != rows["code"],
    ]
    return np.select(conds, list(range(15, 21)), 21).astype(np.int64)


def seqa_prepass_plain(ledger: Ledger, batch: Dict[str, torch.Tensor],
                       count: int) -> Dict[str, np.ndarray]:
    """K7's pre-pass (``seqa_probe_kernel``, ``seqa_mark_kernel``) on the
    table as it is before the batch: each event's bits (AR_*), its slot
    (found) or first truly empty slot F and F's step from home, the marks,
    and for a marked candidate G1 (the next empty slot after F), G1's step
    (MAX_PROBE: none) and G1's candidate; ``owner`` maps an F to its
    candidate (SEQA_MULTI: several)."""
    acc = ledger.accounts
    n = batch["id_lo"].shape[0]
    ev = {c: _np_u(batch[c]) for c in ACCOUNT_BATCH_COLS}
    klo, khi = _np_u(acc.key_lo), _np_u(acc.key_hi)
    tomb = acc.tombstone.cpu().numpy()
    mask = acc.capacity - 1
    lane = np.arange(n)
    active = lane < count
    static = _account_static_codes(ev, n, count)
    bits = np.where(active, AR_ACTIVE, 0).astype(np.int64)
    linked = active & ((ev["flags"] & AF_LINKED) != 0)
    bits |= np.where(linked, AR_LINKED, 0)
    bits |= static
    # The probe of the pre-batch table: found, first truly empty, or capped.
    probe = active & (static == 0)
    with np.errstate(over="ignore"):
        mixed = mix64_np(ev["id_lo"] ^ (ev["id_hi"]
                                        * np.uint64(0x9E3779B97F4A7C15)), 0)
    home = (mixed & np.uint64(mask)).astype(np.int64)
    slot = np.zeros(n, np.int64)
    step = np.zeros(n, np.int64)
    found = np.zeros(n, bool)
    live = probe.copy()
    for t in range(MAX_PROBE):
        if not live.any():
            break
        cur = (home + t) & mask
        tb = tomb[cur]
        empty = live & ~tb & (klo[cur] == 0) & (khi[cur] == 0)
        hit = live & ~tb & ~empty & (klo[cur] == ev["id_lo"]) & (khi[cur] == ev["id_hi"])
        done = empty | hit
        slot = np.where(done, cur, slot)
        step = np.where(done, t, step)
        found |= hit
        live &= ~done
    capped = live
    slot[capped] = 0
    cand = probe & ~found & ~capped
    bits |= np.where(found, AR_FOUND, 0) | np.where(capped, AR_CAPPED, 0)
    bits |= np.where(cand, AR_CAND, 0)
    fi = np.flatnonzero(found)
    rows = {c: _np_u(acc.cols[c])[slot[fi]] for c in ACCOUNT_COLS}
    exists = np.zeros(n, np.int64)
    exists[fi] = _account_exists_codes(ev, rows, fi)
    bits |= exists << 8
    # The F hash and the marks.
    owner: Dict[int, int] = {}
    for e in np.flatnonzero(cand).tolist():
        f = int(slot[e])
        owner[f] = e if f not in owner else SEQA_MULTI
    prev_linked = np.zeros(n, bool)
    prev_linked[1:] = linked[:-1]
    marks = linked | capped | (active & prev_linked)
    has_g1 = np.zeros(n, bool)
    g1 = np.zeros(n, np.int64)
    g1_step = np.zeros(n, np.int64)
    g1_owner = np.full(n, SEQA_NONE, np.int64)
    for e in np.flatnonzero(cand).tolist():
        if owner[int(slot[e])] != SEQA_MULTI:
            continue
        marks[e] = True
        t = int(step[e]) + 1
        g = 0
        while t < MAX_PROBE:
            g = (int(home[e]) + t) & mask
            if not tomb[g] and klo[g] == 0 and khi[g] == 0:
                break
            t += 1
        has_g1[e], g1[e], g1_step[e] = True, g, t
        if t < MAX_PROBE:
            g1_owner[e] = owner.get(g, SEQA_NONE)
    return {"bits": bits, "slot": slot, "step": step, "home": home,
            "marks": marks, "has_g1": has_g1, "g1": g1, "g1_step": g1_step,
            "g1_owner": g1_owner, "owner": owner, "ev": ev,
            "pre_empty": (klo, khi, tomb)}


def seqa_sequencer_plain(ledger: Ledger, count: int, pre) -> dict:
    """K7's sequencer (``seqa_sequencer_kernel``'s thread 0): the marked
    events in order, from the pre-pass and an overlay of the batch's
    inserted slots (slot -> [event, live]).  Returns each marked event's
    decision (raw code, final code, slot or None, live), the event the
    serial loop takes over at (n: none) and the chain state there."""
    bits, marks, ev = pre["bits"], pre["marks"], pre["ev"]
    n = len(bits)
    mask = ledger.accounts.capacity - 1
    overlay: Dict[int, list] = {}
    dec: Dict[int, list] = {}
    chain_start, broken = -1, False
    e = 0
    while e < n:
        if not marks[e]:
            e += 1
            continue
        b = int(bits[e])
        active, linked = bool(b & AR_ACTIVE), bool(b & AR_LINKED)
        if linked and chain_start < 0:
            chain_start = e
        in_chain = chain_start >= 0
        open_err = linked and e == count - 1
        x = None
        if not active:
            code = 0
        elif open_err:
            code = 2
        elif broken:
            code = 1
        elif b & 0x1F:
            code = b & 0x1F
        elif b & AR_FOUND:
            code = (b >> 8) & 0x1F
        elif b & AR_CAPPED:
            return {"dec": dec, "from": e, "chain_start": chain_start,
                    "broken": broken}
        else:
            got = _seqa_walk(pre, overlay, marks, e, mask)
            if got is None:
                return {"dec": dec, "from": e, "chain_start": chain_start,
                        "broken": broken}
            kind, v = got
            if kind == "insert":
                x = v
                overlay[x] = [e, True]
                code = 0
            else:
                rows = {c: ev[c][[v]] for c in ("flags", "user_data_128_lo",
                                                "user_data_128_hi", "user_data_64",
                                                "user_data_32", "ledger", "code")}
                code = int(_account_exists_codes(ev, rows, [e])[0])
        dec[e] = [code, code, x, x is not None]
        if active and code != 0 and in_chain and not broken:
            for j in range(e - 1, chain_start - 1, -1):
                d = dec[j]
                if d[3]:
                    overlay[d[2]][1] = False
                    d[3] = False
                d[1] = 1
            broken = True
        if in_chain and (not linked or open_err):
            chain_start, broken = -1, False
        e += 1
    return {"dec": dec, "from": n, "chain_start": chain_start, "broken": broken}


def _seqa_walk(pre, overlay, marks, e: int, mask: int):
    """Candidate ``e``'s walk from its F over the table as the batch has
    left it: ("insert", slot), ("exists", the event whose live insert holds
    its id), or None (the walk reached MAX_PROBE)."""
    ev = pre["ev"]
    klo, khi, tomb = pre["pre_empty"]
    x, t = int(pre["slot"][e]), int(pre["step"][e])
    home = int(pre["home"][e])
    stage = 0
    while True:
        if t >= MAX_PROBE:
            return None
        taken = False
        if x in overlay:
            j, live = overlay[x]
            if (live and ev["id_lo"][j] == ev["id_lo"][e]
                    and ev["id_hi"][j] == ev["id_hi"][e]):
                return "exists", j
            taken = True
        elif stage > 0:
            u = (int(pre["g1_owner"][e]) if stage == 1
                 else pre["owner"].get(x, SEQA_NONE))
            if u >= 0 and u != e and not marks[u]:
                if u < e:
                    taken = True
                else:
                    marks[u] = True
        if not taken:
            return "insert", x
        if stage == 0 and pre["has_g1"][e]:
            stage, x, t = 1, int(pre["g1"][e]), int(pre["g1_step"][e])
            continue
        stage = 2
        while True:
            t += 1
            if t >= MAX_PROBE:
                return None
            x = (home + t) & mask
            if not tomb[x] and klo[x] == 0 and khi[x] == 0:
                break


def create_accounts_seq_split_plain(ledger, batch, count, timestamp):
    """Plain version of K7 as the card runs it: the pre-pass
    (``seqa_prepass_plain``), the sequencer (``seqa_sequencer_plain``),
    then the finish: every event's code and row from its record or its
    decision; after a capped insert, what is decided and then the serial
    loop from there.  The same results as ``create_accounts_seq_plain``."""
    n = batch["id_lo"].shape[0]
    pre = seqa_prepass_plain(ledger, batch, count)
    seq = seqa_sequencer_plain(ledger, count, pre)
    frm = seq["from"]
    bits, dec = pre["bits"], seq["dec"]
    acc = ledger.accounts
    raw = [0] * n
    final = [0] * n
    ins_slot = [SENT] * n
    ins = []  # (event, slot, live)
    for i in range(frm):
        b = int(bits[i])
        if pre["marks"][i]:
            d = dec[i]
            raw[i], final[i] = d[0], d[1]
            if d[2] is not None:
                ins.append((i, d[2], d[3]))
                ins_slot[i] = d[2]
        else:
            c = (0 if not b & AR_ACTIVE else (b & 0x1F) or
                 ((b >> 8) & 0x1F if b & AR_FOUND else 0))
            raw[i] = final[i] = c
            if b & AR_CAND:
                ins.append((i, int(pre["slot"][i]), True))
    ts_base = (timestamp - count + 1) & M64
    if ins:
        ev = pre["ev"]
        e = np.array([i for i, _x, _l in ins], np.int64)
        x = torch.tensor([s for _i, s, _l in ins], dtype=torch.int64)
        live = np.array([lv for _i, _x, lv in ins], bool)
        for c in ACCOUNT_COLS:
            if c == "timestamp":
                with np.errstate(over="ignore"):
                    vals = np.uint64(ts_base) + e.astype(np.uint64)
            else:
                vals = ev[c][e]
            col = acc.cols[c]
            col[x.to(col.device)] = torch.from_numpy(
                vals.view(np.int64) if vals.dtype == np.uint64
                else vals.view(np.int32)).to(col.device)
        zero = np.uint64(0)
        for key, name in ((acc.key_lo, "id_lo"), (acc.key_hi, "id_hi")):
            key[x.to(key.device)] = torch.from_numpy(
                np.where(live, ev[name][e], zero).view(np.int64)).to(key.device)
        acc.tombstone[x.to(acc.tombstone.device)] = torch.from_numpy(~live).to(
            acc.tombstone.device)
        acc.count += int(live.sum())
    dev = batch["id_lo"].device
    if frm < n:
        overflow = _accounts_loop(ledger, _events(batch, ACCOUNT_BATCH_COLS),
                                  count, timestamp, frm, seq["chain_start"],
                                  seq["broken"], ins_slot, raw)
        return ledger, _account_chain_codes(batch, raw, count), torch.tensor(
            overflow, device=dev)
    if 0 < count < n and bits[count - 1] & AR_LINKED:
        final[count] = 1  # _chain_codes reaches one lane past an open chain
    return ledger, torch.tensor(final, dtype=torch.int32, device=dev), \
        torch.tensor(False, device=dev)


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
