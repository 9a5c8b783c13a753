"""Device query kernel: get_account_history (port of
``tigerbeetle_tpu/ops/query.py``).

The history log is timestamp-ordered and bounded, so a masked scan and a
top-k answer it.  Sort key: a match gets ``ts`` (descending scans) or
``~ts`` (ascending), a non-match 0, below every match because object
timestamps are >= 1; the top k by (key, slot), largest first, is the result
order, and past the matches come the other slots, highest slot first.

``scan_history`` is kernel K16 ``history_scan`` on CUDA tensors and
``scan_history_plain`` (the JAX function, written with PyTorch) on CPU
tensors.  K16 relies on what every commit path keeps true of the log: the
rows below ``count`` carry strictly increasing timestamps (they are
appended in lane order and a rolled-back chain pops ``count``).  It checks
that on every call and raises if it is false, so its answer is the plain
version's or none.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..u128 import INT64_MIN, i64
from . import _cuda
from . import state_machine as sm

# The balance fields of a history row and their short column names.
HIST_FIELDS = (
    ("debits_pending", "dp"), ("debits_posted", "dpo"),
    ("credits_pending", "cp"), ("credits_posted", "cpo"),
)


def _top_k(key: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of the k largest u64 keys, largest first (ties: the higher
    index first, as ``argsort(key)[-k:][::-1]``), plus their validity
    (key != 0)."""
    _, order = torch.sort(key ^ INT64_MIN, stable=True)
    top = order[-k:].flip(0)
    return top, key[top] != 0


def scan_history_plain(ledger: sm.Ledger, acct_lo: int, acct_hi: int,
                       ts_min: int, ts_max: int, want_debits: bool,
                       want_credits: bool, descending: bool, k: int):
    h = ledger.history
    c = h.cols
    dev = c["timestamp"].device
    live = torch.arange(h.capacity, device=dev) < h.count
    a_lo, a_hi = i64(acct_lo), i64(acct_hi)
    is_dr = (c["dr_id_lo"] == a_lo) & (c["dr_id_hi"] == a_hi) & bool(want_debits)
    is_cr = (c["cr_id_lo"] == a_lo) & (c["cr_id_hi"] == a_hi) & bool(want_credits)
    ts = c["timestamp"]
    tsu = ts ^ INT64_MIN
    match = (live & (is_dr | is_cr) & (tsu >= (i64(ts_min) ^ INT64_MIN))
             & (tsu <= (i64(ts_max) ^ INT64_MIN)))
    key = torch.where(match, ts if descending else ~ts, torch.zeros_like(ts))
    top, valid = _top_k(key, k)
    side_dr = is_dr[top]
    rows = {"timestamp": ts[top]}
    for field, short in HIST_FIELDS:
        for half in ("lo", "hi"):
            rows[f"{field}_{half}"] = torch.where(
                side_dr, c[f"dr_{short}_{half}"][top],
                c[f"cr_{short}_{half}"][top])
    return valid, rows


def scan_history(
    ledger: sm.Ledger, acct_lo: int, acct_hi: int, ts_min: int, ts_max: int,
    want_debits: bool, want_credits: bool, descending: bool, k: int,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """AccountBalance rows for one history-flagged account, side-selected
    as execute_get_account_history does (state_machine.zig:1149-1195): the
    filter's DEBITS/CREDITS flags gate which side's rows appear.  u64
    scalars are Python ints."""
    if ledger.history.count.is_cuda:
        return _cuda.history_scan(
            ledger.history.cols, ledger.history.count, acct_lo, acct_hi,
            ts_min, ts_max, bool(want_debits), bool(want_credits),
            bool(descending), k)
    return scan_history_plain(ledger, acct_lo, acct_hi, ts_min, ts_max,
                              want_debits, want_credits, descending, k)
