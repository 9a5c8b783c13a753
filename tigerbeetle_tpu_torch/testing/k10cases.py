"""Leg inputs that set the traps of K10 on many blocks
(``csrc/full_legs.cu``: a sorted leg a thread in blocks of 128, the six
streams scanned a block at a time, the blocks' aggregates folded into each
block's carry after a grid barrier; when the sort cache is stale, the
chunk sort over the card first), in numpy.

``case(name, n, seed=0)`` returns (args, cache): ``args`` the keyword
arguments of ``transfer_full._leg_balances`` as numpy arrays (``start_bal``
a dict of the eight leg-domain balance words, u64 as int64 bits) and
``cache`` None or the sort cache (keys int64[legs_pad(n)], slots
int64[2n], ok int32[1]) a launch would find.  ``to_tensors(args, cache,
dev)`` moves both to a device (the cache as fresh tensors: K10 refreshes
it in place).

- ``one_account``: every leg of every lane on one account (one run of 2n
  legs across every block).
- ``block_edges``: runs that start and end on the blocks' edges (128
  legs), runs that straddle them, single-leg runs at an edge.
- ``sentinel``: a third of the legs dead (the sentinel run at the end, over
  several blocks) beside live runs.
- ``near_2_128``: start balances a little under 2^128 on every account, so
  every carry crosses the high word; one account, the largest slot (its
  legs last), overflows only in the last block: ``arith_broken``.
- ``underflow``: post/void releases larger than the pending balance
  (``neg``) on one account whose legs straddle a block edge.
- ``underflow_last``: post/void releases larger than the pending balance
  on legs that are alone in their runs (so only the inclusive sum can
  show the fault): the last leg of the first block, the first of the
  second, and the last two legs of the batch (the last block); every
  other release small.
- ``fresh_cache``: the cache holds the sort of these slots (the launch
  scans from it).
- ``stale_cache``: the cache holds the sort of the previous pass's slots:
  posts of in-batch pendings whose accounts changed since (K10 sorts and
  refreshes the cache).
- ``invalid_cache``: the cache's ok word is 0 (a new batch).

``CASES`` is every name; each runs at any ``n`` from 1 to 8,192 (the
mix of lanes is scaled to n).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

CASES = ("one_account", "block_edges", "sentinel", "near_2_128",
         "underflow", "underflow_last", "fresh_cache", "stale_cache", "invalid_cache")
BLOCK = 128  # csrc/full_legs.cu LEG_THREADS: legs a block
FIELDS = ("debits_pending", "debits_posted", "credits_pending",
          "credits_posted")
CAP = 1 << 20  # the accounts' capacity: the dead legs' sentinel slot
U64 = (1 << 64) - 1


def _i64(x) -> np.ndarray:
    """u64 values (Python ints or uint64) as int64 bits."""
    return np.asarray(x, dtype=np.uint64).view(np.int64)


def pad(n: int) -> int:
    """The legs of n lanes rounded up to a power of two (at least 2)."""
    return 1 << max(1, (2 * n - 1).bit_length())


def sort_cache(dr_slot, cr_slot, dr_live, cr_live, cap: int = CAP):
    """The cache K12 (or a sorting K10) leaves for these legs: the sorted
    (slot << 15 | leg) keys padded with all ones, the legs' slots, ok."""
    n = len(dr_slot)
    slot = np.stack([np.where(dr_live, dr_slot, cap),
                     np.where(cr_live, cr_slot, cap)], 1).reshape(-1)
    keys = np.full(pad(n), -1, np.int64)
    keys[:2 * n] = np.sort((slot.astype(np.int64) << 15) | np.arange(2 * n))
    return keys, slot.astype(np.int64), np.ones(1, np.int32)


def _base(rng, n: int, slots: np.ndarray) -> Dict:
    """Lanes over ``slots`` (leg-domain: dr = slots[0::2], cr =
    slots[1::2]), mostly ok, a mix of regular, pending and post/void
    lanes, u64 amounts, modest start balances."""
    pending = rng.random(n) < 0.3
    postvoid = ~pending & (rng.random(n) < 0.3)
    post = postvoid & (rng.random(n) < 0.5)
    start = {f + s: _i64(rng.integers(0, 1 << 62, 2 * n, dtype=np.uint64))
             for f in FIELDS for s in ("_lo", "_hi")}
    for f in FIELDS:
        start[f + "_hi"] = _i64(rng.integers(0, 1 << 20, 2 * n,
                                             dtype=np.uint64))
    return dict(
        start_bal=start, cap_sentinel=CAP, ok_lanes=rng.random(n) < 0.9,
        amt_lo=_i64(rng.integers(0, U64, n, dtype=np.uint64, endpoint=True)),
        pamt_lo=_i64(rng.integers(0, U64, n, dtype=np.uint64, endpoint=True)),
        dr_slot=slots[0::2].astype(np.int64),
        cr_slot=slots[1::2].astype(np.int64),
        dr_live=np.ones(n, bool), cr_live=np.ones(n, bool),
        pending_f=pending, post=post, postvoid=postvoid, has_postvoid=True)


def _runs(lengths, total: int) -> np.ndarray:
    """Slots for legs 0..total-1 in order: run k (of ``lengths``, cycled)
    on slot 3k + 1, so the sorted order is the leg order."""
    out = np.empty(total, np.int64)
    j, k = 0, 0
    while j < total:
        ln = lengths[k % len(lengths)]
        out[j:j + ln] = 3 * k + 1
        j += ln
        k += 1
    return out


def case(name: str, n: int, seed: int = 0
         ) -> Tuple[Dict, Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]]:
    if name not in CASES:
        raise ValueError(f"unknown K10 case {name!r}")
    if not 1 <= n <= 8192:
        raise ValueError("K10 takes 1..8,192 lanes")
    rng = np.random.default_rng(seed + 1009 * CASES.index(name) + n)
    n2 = 2 * n
    cache = None
    if name == "one_account":
        a = _base(rng, n, np.full(n2, 7, np.int64))
    elif name == "block_edges":
        # A cycle of 8 blocks: six runs end on an edge, four inside.
        a = _base(rng, n, _runs((BLOCK, BLOCK, BLOCK // 2, BLOCK + BLOCK // 2,
                                 1, BLOCK - 1, 2 * BLOCK, 1, 1, BLOCK - 2),
                                n2))
    elif name == "sentinel":
        a = _base(rng, n, rng.integers(0, max(2, n // 4), n2))
        a["dr_live"] = rng.random(n) < 0.67
        a["cr_live"] = rng.random(n) < 0.67
    elif name == "near_2_128":
        slots = rng.integers(0, max(2, n // 8), n2)
        # The largest slot's legs sort last: they sit in the last block.
        top = int(slots.max()) + 1
        last = [2 * (n - 1)]  # the last lane's debit leg
        slots[last] = top
        a = _base(rng, n, slots)
        a["amt_lo"] = _i64(rng.integers(0, 1 << 40, n, dtype=np.uint64))
        a["pamt_lo"] = _i64(rng.integers(0, 1 << 40, n, dtype=np.uint64))
        for f in FIELDS:
            # Room above each account's start for every leg's amount...
            a["start_bal"][f + "_hi"] = _i64(np.full(n2, U64, np.uint64))
            a["start_bal"][f + "_lo"] = _i64(np.full(
                n2, U64 - (np.uint64(n2) << np.uint64(41)), np.uint64))
        # ...but the top account starts at 2^128 - 1: its leg's add wraps.
        for f in FIELDS:
            a["start_bal"][f + "_lo"][last] = -1
        a["ok_lanes"][n - 1] = True
        a["pending_f"][n - 1] = False
        a["postvoid"][n - 1] = False
        a["post"][n - 1] = False
        a["amt_lo"][n - 1] = 5
        # Releases stay within what was added before them: no underflow.
        a["pamt_lo"][:] = 0
    elif name == "underflow":
        # Eight legs (in order, so sorted so) around a block edge in the
        # middle on one account; runs of other accounts on both sides.
        edge = BLOCK * max(1, n2 // (2 * BLOCK)) if n2 > BLOCK else n2 // 2
        lo, hi = max(0, edge - 4), min(n2, edge + 4)
        left = _runs((37, 91, 5, 140), lo)
        mid = (int(left.max()) + 2) if lo else 1
        right = _runs((37, 91, 5, 140), n2 - hi) + mid + 1
        slots = np.concatenate([left, np.full(hi - lo, mid), right])
        hot = list(range(lo, hi))
        a = _base(rng, n, slots)
        for j in hot:
            i = j // 2
            a["postvoid"][i], a["pending_f"][i] = True, False
            a["ok_lanes"][i] = True
            a["pamt_lo"][i] = -1  # 2^64 - 1: more than the pending holds
            for f in FIELDS:
                a["start_bal"][f + "_lo"][j] = 0
                a["start_bal"][f + "_hi"][j] = 0
    elif name == "underflow_last":
        traps = sorted({j for j in (BLOCK - 1, BLOCK, n2 - 2, n2 - 1)
                        if 0 <= j < n2})
        # Runs of 37 legs in leg order, each trap leg a run of its own.
        starts = np.zeros(n2, bool)
        starts[::37] = True
        for j in traps:
            starts[j] = True
            if j + 1 < n2:
                starts[j + 1] = True
        a = _base(rng, n, 3 * (np.cumsum(starts) - 1) + 1)
        a["pamt_lo"] = _i64(rng.integers(0, 1 << 32, n, dtype=np.uint64))
        for j in traps:
            i = j // 2
            a["postvoid"][i], a["pending_f"][i] = True, False
            a["post"][i] = i % 2 == 0
            a["ok_lanes"][i] = True
            a["pamt_lo"][i] = 5
            for f in FIELDS:
                a["start_bal"][f + "_lo"][j] = 0
                a["start_bal"][f + "_hi"][j] = 0
    else:
        a = _base(rng, n, rng.integers(0, max(2, n // 3), n2))
        if name == "fresh_cache":
            cache = sort_cache(a["dr_slot"], a["cr_slot"], a["dr_live"],
                               a["cr_live"])
        elif name == "stale_cache":
            # The previous pass: some posts' accounts were other slots.
            old_dr, old_cr = a["dr_slot"].copy(), a["cr_slot"].copy()
            moved = np.flatnonzero(a["post"])[: max(1, n // 16)]
            old_dr[moved] = (old_dr[moved] + 1) % max(2, n // 3)
            old_cr[moved] = CAP - 1
            cache = sort_cache(old_dr, old_cr, a["dr_live"], a["cr_live"])
        else:
            cache = sort_cache(a["dr_slot"], a["cr_slot"], a["dr_live"],
                               a["cr_live"])
            cache[2][0] = 0
    return a, cache


def to_tensors(args: Dict, cache, dev):
    """``args`` and ``cache`` as tensors on ``dev`` (fresh copies)."""
    import torch

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    out = {k: (t(v) if isinstance(v, np.ndarray) else v)
           for k, v in args.items() if k != "start_bal"}
    out["start_bal"] = {k: t(v) for k, v in args["start_bal"].items()}
    return out, (None if cache is None else tuple(t(c) for c in cache))
