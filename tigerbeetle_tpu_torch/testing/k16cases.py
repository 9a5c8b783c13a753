"""History logs and queries that set the traps of K16's one pass
(``csrc/history_scan.cu``: blocks own ranges of the 32-slot words below
``count``, a match bitmap and block counts, one grid barrier, then each
placed row's position in closed form), in numpy.

``case(name, blocks=None)`` returns (log, queries): the log as the history
part of ``convert``'s exchange dict (``cols``: the 21 u64 columns of
``HISTORY_COLS``, ``count``) and a list of queries, each a tuple (acct_lo,
acct_hi, ts_min, ts_max, want_debits, want_credits, descending, k).
``blocks`` is the launch's block count the case aims at (K16 takes a block
for each 1,024 slots, at most what the card holds: ``blocks_for(cap)``);
``edge_matches`` puts its matches on the first and last slots of those
blocks' ranges.  ``UNORDERED`` is the case whose timestamps below the count
do not increase: K16 must refuse it.

- ``count_zero``: an empty log (every result is the fill from the top).
- ``count_full``: ``count`` = ``cap``, k up to ``cap`` (the fill from below
  the count, non-matches whose debit id is the account included).
- ``k_one_and_cap``: k = 1 and k = ``cap`` on a log with matches.
- ``odd_cap``: a capacity of 1,000 slots and a count not a multiple of 32
  or of the blocks' range.
- ``few_matches``: fewer matches than k.
- ``rolled_back_tail``: rows of the account above ``count`` (not matches;
  their columns fill the positions after the matches, debit side).
- ``outside_window``: non-matches below the count whose debit id is the
  account, with timestamps outside the window, reached by the fill.
- ``both_sides``: rows with the account on both sides.
- ``sides``: debits only, credits only, both, in both directions.
- ``empty_window``: ts_min > ts_max, and a window between two rows.
- ``low_word_collisions``: rows whose low id word is the account's and
  whose high word is not (and the account's own high word nonzero).
- ``edge_matches``: matches only on the first and last slot of each
  block's range.
- ``unordered``: a timestamp below the count equal to the one before it.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

CASES = ("count_zero", "count_full", "k_one_and_cap", "odd_cap",
         "few_matches", "rolled_back_tail", "outside_window", "both_sides",
         "sides", "empty_window", "low_word_collisions", "edge_matches")
UNORDERED = "unordered"
CAP = 1 << 12
ACCT = 7
U64M = (1 << 64) - 1
FIELDS = ("dp", "dpo", "cp", "cpo")
COLS = (["dr_id_lo", "dr_id_hi"]
        + [f"dr_{f}_{h}" for f in FIELDS for h in ("lo", "hi")]
        + ["cr_id_lo", "cr_id_hi"]
        + [f"cr_{f}_{h}" for f in FIELDS for h in ("lo", "hi")]
        + ["timestamp"])


def blocks_for(cap: int, resident: int = 1 << 30) -> int:
    """K16's blocks for a log of ``cap`` slots on a card holding
    ``resident`` of them."""
    return max(1, min(resident, (cap + 1023) // 1024))


def _log(rng, cap: int, count: int, accounts: int = 40) -> Dict:
    """A log of ``cap`` slots: rows below ``count`` between accounts
    1..``accounts`` (never the same on both sides), increasing timestamps,
    random balances; zeros above the count."""
    cols = {name: np.zeros(cap, np.uint64) for name in COLS}
    dr = rng.integers(1, accounts + 1, count).astype(np.uint64)
    cr = ((dr + rng.integers(0, accounts - 1, count).astype(np.uint64))
          % np.uint64(accounts) + np.uint64(1))
    cols["dr_id_lo"][:count] = dr
    cols["cr_id_lo"][:count] = cr
    cols["timestamp"][:count] = (10 ** 9 + 5 * np.arange(count)).astype(np.uint64)
    for name in COLS:
        if name[3:] not in ("id_lo", "id_hi") and name != "timestamp":
            cols[name][:count] = rng.integers(0, 1 << 63, count, dtype=np.uint64)
    return {"cols": cols, "count": np.asarray(count, np.uint64)}


def _queries(acct=ACCT, hi=0, ks=(64,), windows=((1, U64M - 1),),
             wants=((True, True),)) -> List[Tuple]:
    return [(acct, hi, lo_ts, hi_ts, dr, crd, desc, k)
            for k in ks for lo_ts, hi_ts in windows for dr, crd in wants
            for desc in (False, True)]


def case(name: str, blocks: Optional[int] = None) -> Tuple[Dict, List[Tuple]]:
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    cap = CAP
    if name == "count_zero":
        log = _log(rng, cap, 0)
        return log, _queries(ks=(1, 64, cap))
    if name == "count_full":
        log = _log(rng, cap, cap)
        return log, _queries(ks=(64, cap - 3, cap),
                             wants=((True, True), (True, False), (False, True)))
    if name == "k_one_and_cap":
        log = _log(rng, cap, 3000)
        return log, _queries(ks=(1, cap))
    if name == "odd_cap":
        cap = 1000
        log = _log(rng, cap, 777)
        return log, _queries(ks=(1, 100, 999, cap))
    if name == "few_matches":
        log = _log(rng, cap, 3000, accounts=400)
        return log, _queries(ks=(64, 512))
    if name == "rolled_back_tail":
        log = _log(rng, cap, 2500)
        c = log["cols"]
        for col in COLS:  # the popped rows keep their values above count
            c[col][2500:2800] = c[col][:300]
        c["dr_id_lo"][2500:2800:3] = ACCT
        c["timestamp"][2500:2800] = c["timestamp"][2499] + 5 * np.arange(1, 301,
                                                                         dtype=np.uint64)
        return log, _queries(ks=(cap - 2000, cap),
                             wants=((True, True), (True, False), (False, True)))
    if name == "outside_window":
        log = _log(rng, cap, cap - 40)
        c = log["cols"]
        ts = c["timestamp"]
        c["dr_id_lo"][cap - 300:cap - 40:5] = ACCT
        window = (int(ts[100]), int(ts[cap - 400]))
        return log, _queries(ks=(200, cap), windows=(window,),
                             wants=((True, True), (True, False)))
    if name == "both_sides":
        log = _log(rng, cap, 3500)
        c = log["cols"]
        both = rng.choice(3500, 200, replace=False)
        c["dr_id_lo"][both] = ACCT
        c["cr_id_lo"][both] = ACCT
        return log, _queries(ks=(64, 1024, cap),
                             wants=((True, True), (True, False), (False, True)))
    if name == "sides":
        log = _log(rng, cap, 3900)
        return log, _queries(ks=(8, cap),
                             wants=((True, True), (True, False), (False, True)))
    if name == "empty_window":
        log = _log(rng, cap, 2000)
        ts = log["cols"]["timestamp"]
        return log, _queries(ks=(64, cap), windows=(
            (int(ts[500]), int(ts[400])), (int(ts[7]) + 1, int(ts[8]) - 1),
            (int(ts[1999]) + 1, U64M - 1)))
    if name == "low_word_collisions":
        log = _log(rng, cap, 3200)
        c = log["cols"]
        hi = 5
        mine = rng.choice(3200, 300, replace=False)
        c["dr_id_hi"][mine[:100]] = hi
        c["dr_id_lo"][mine[:100]] = ACCT
        c["cr_id_hi"][mine[100:200]] = hi
        c["cr_id_lo"][mine[100:200]] = ACCT
        c["cr_id_hi"][mine[200:]] = hi + 1  # the low word alone collides
        c["cr_id_lo"][mine[200:]] = ACCT
        return (log, _queries(acct=ACCT, hi=hi, ks=(64, cap))
                + _queries(acct=ACCT, hi=0, ks=(64,)))
    if name == "edge_matches":
        count = 3333
        log = _log(rng, cap, count, accounts=400)
        c = log["cols"]
        c["dr_id_lo"][c["dr_id_lo"] == ACCT] = ACCT + 1
        c["cr_id_lo"][c["cr_id_lo"] == ACCT] = ACCT + 2
        g = blocks if blocks is not None else blocks_for(cap)
        words = (count + 31) // 32
        per = -(-words // g)
        for b in range(g):
            first, last = b * per * 32, min((b + 1) * per * 32, count) - 1
            if first < count:
                c["dr_id_lo"][first] = ACCT
                c["cr_id_lo"][last] = ACCT
        return log, _queries(ks=(1, 5, 64, cap))
    if name == UNORDERED:
        log = _log(rng, cap, 3000)
        ts = log["cols"]["timestamp"]
        ts[1500] = ts[1499]
        return log, _queries(ks=(64,))
    raise KeyError(name)
