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
version's or none: ``scan_history`` reads its error word back at once,
``scan_history_deferred`` hands it to the caller, who reads it back with
the rows (``TorchStateMachine.get_account_history``) and raises through
``check_order``.  ``scan_history_split_plain`` is the plain form of K16's
one pass: a match bitmap and block counts over ranges of 32-slot words,
then each row's position in closed form.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def scan_history_split_plain(ledger: sm.Ledger, acct_lo: int, acct_hi: int,
                             ts_min: int, ts_max: int, want_debits: bool,
                             want_credits: bool, descending: bool, k: int,
                             blocks: int = 4):
    """Plain form of K16's one pass over ``blocks`` ranges of the 32-slot
    words below ``count``: (valid, rows, err), ``err`` True when the
    timestamps below ``count`` do not increase (the kernel's error word;
    its rows are then not the plain version's)."""
    h = ledger.history
    c = h.cols
    cap = h.capacity
    dev = c["timestamp"].device
    count = min(max(int(h.count), 0), cap)
    words = (count + 31) // 32
    per = -(-words // blocks) if words else 0
    # A: the match flag of each slot of the words below count, as bitmap
    # words, each block's count and its order check.
    s = torch.arange(words * 32, device=dev)
    live = s < count
    sl = torch.where(live, s, torch.zeros_like(s))
    a_lo, a_hi = i64(acct_lo), i64(acct_hi)
    ts = c["timestamp"][sl]
    tsu = ts ^ INT64_MIN
    is_dr = (bool(want_debits) & (c["dr_id_lo"][sl] == a_lo)
             & (c["dr_id_hi"][sl] == a_hi))
    is_cr = (bool(want_credits) & (c["cr_id_lo"][sl] == a_lo)
             & (c["cr_id_hi"][sl] == a_hi))
    key = ts if descending else ~ts
    flag = (live & (is_dr | is_cr) & (tsu >= (i64(ts_min) ^ INT64_MIN))
            & (tsu <= (i64(ts_max) ^ INT64_MIN)) & (key != 0))
    bits = flag.view(-1, 32).to(torch.int64)
    bitmap = (bits << torch.arange(32, device=dev)).sum(1)
    word_pop = bits.sum(1)
    w_block = torch.arange(words, device=dev) // max(per, 1)
    block_count = torch.zeros(blocks, dtype=torch.int64, device=dev)
    block_count.index_add_(0, w_block, word_pop)
    nxt = torch.cat([tsu[1:], tsu.new_zeros(1)])
    err = bool((live & (s + 1 < count) & ~(tsu < nxt)).any())
    # B: the matches before each block, and all of them.
    before = torch.cumsum(block_count, 0) - block_count
    m = int(block_count.sum())
    # C: a bit's rank is its block's count before it, the popcounts of the
    # block's words before its word, and the bits below it in its word.
    word_pre = torch.cumsum(word_pop, 0) - word_pop
    block_first = (w_block * per).clamp(max=max(words - 1, 0))
    word_rank = before[w_block] + word_pre - word_pre[block_first]
    below = (bitmap[:, None] >> torch.arange(32, device=dev)) & 1
    bit_rank = (word_rank[:, None] + torch.cumsum(below, 1) - below).reshape(-1)
    pos = torch.where(flag, (m - 1 - bit_rank) if descending else bit_rank,
                      cap - 1 - s + bit_rank)
    take = live & (pos >= 0) & (pos < k)
    # The slots at and above count, highest first after the matches.
    up = torch.arange(count, cap, device=dev)
    up = up[cap - 1 - up + m < k]
    slots = torch.cat([s[take], up])
    places = torch.cat([pos[take], cap - 1 - up + m])
    valid = torch.zeros(k, dtype=torch.bool, device=dev)
    valid[places] = torch.cat([flag[take], torch.zeros_like(up, dtype=torch.bool)])
    side_dr = (bool(want_debits) & (c["dr_id_lo"][slots] == a_lo)
               & (c["dr_id_hi"][slots] == a_hi))
    rows = {"timestamp": torch.zeros(k, dtype=torch.int64, device=dev)}
    rows["timestamp"][places] = c["timestamp"][slots]
    for field, short in HIST_FIELDS:
        for half in ("lo", "hi"):
            col = torch.zeros(k, dtype=torch.int64, device=dev)
            col[places] = torch.where(side_dr, c[f"dr_{short}_{half}"][slots],
                                      c[f"cr_{short}_{half}"][slots])
            rows[f"{field}_{half}"] = col
    return valid, rows, err


def check_order(err) -> None:
    """Raises if K16's error word (read back) says the log's timestamps
    below its count do not increase."""
    if err:
        raise RuntimeError(_cuda.HISTORY_ORDER_ERROR)


def scan_history_deferred(
    ledger: sm.Ledger, acct_lo: int, acct_hi: int, ts_min: int, ts_max: int,
    want_debits: bool, want_credits: bool, descending: bool, k: int,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Optional[torch.Tensor]]:
    """``scan_history`` without the read-back: (valid, rows, error word).
    On CUDA tensors the word is K16's int32[1] on the card, which the
    caller reads back with the rows and passes to ``check_order`` before
    it uses them; on CPU tensors it is None (the plain version)."""
    if ledger.history.count.is_cuda:
        return _cuda.history_scan(
            ledger.history.cols, ledger.history.count, acct_lo, acct_hi,
            ts_min, ts_max, bool(want_debits), bool(want_credits),
            bool(descending), k, check=False)
    valid, rows = scan_history_plain(ledger, acct_lo, acct_hi, ts_min, ts_max,
                                     want_debits, want_credits, descending, k)
    return valid, rows, None


def scan_history(
    ledger: sm.Ledger, acct_lo: int, acct_hi: int, ts_min: int, ts_max: int,
    want_debits: bool, want_credits: bool, descending: bool, k: int,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """AccountBalance rows for one history-flagged account, side-selected
    as execute_get_account_history does (state_machine.zig:1149-1195): the
    filter's DEBITS/CREDITS flags gate which side's rows appear.  u64
    scalars are Python ints.  On CUDA tensors K16, its error word read
    back at once (raises if the log is out of order)."""
    if ledger.history.count.is_cuda:
        return _cuda.history_scan(
            ledger.history.cols, ledger.history.count, acct_lo, acct_hi,
            ts_min, ts_max, bool(want_debits), bool(want_credits),
            bool(descending), k)
    return scan_history_plain(ledger, acct_lo, acct_hi, ts_min, ts_max,
                              want_debits, want_credits, descending, k)
