"""Index pyramids and queries that set the traps of K15 ``index_window``
(``csrc/index_query.cu``: each window's bounds by a 32-ary warp search, the
wanted windows' valid prefixes merged by rank, the rest of the k results
in closed form), in numpy.  ``case(name)`` returns (dr levels, cr levels,
queries): each level a (5, n) u64 array in ``ops/index.py`` COLS order,
sorted by (acct_hi, acct_lo, ts) and padded with sentinels; each query
(acct_lo, acct_hi, ts_min, ts_max, want_debits, want_credits, k,
descending).

- ``one_side_unwanted``: a pyramid of both sides; queries with one side not
  wanted, so the tail carries that side's valid tids;
- ``wrap``: ts_max = U64_MAX descending (ts_max + 1 wraps to 0: nothing
  valid) and ascending;
- ``sentinel_levels``: levels holding only sentinels among real ones;
- ``no_rows``: an account with no entries (everything closed form);
- ``long_run``: windows whose valid run is longer than k, so the sum of
  the runs passes k and the merged prefixes are cut at the prune key;
- ``k1``: k = 1;
- ``deepest_only``: only the deepest level occupied (after a rebuild);
- ``edge_ts``: entries of ts 0 and U64_MAX on the queried account and
  equal timestamps in two levels (keys of U64_MAX among the valid, ties
  kept in concatenation order);
- ``over_stage``: six windows of 3,000 interleaved valid entries each at
  k = 8,192, more merged keys than the union block stages in shared
  memory (16,384).
"""

from __future__ import annotations

import numpy as np

CASES = ("one_side_unwanted", "wrap", "sentinel_levels", "no_rows",
         "long_run", "k1", "deepest_only", "edge_ts", "over_stage")
U64M = (1 << 64) - 1
BASE = 64


def level(entries, n: int) -> np.ndarray:
    """A (5, n) sorted level of ``entries`` (five u64 columns), padded with
    sentinels; equal keys keep their input order."""
    e = np.asarray(entries, np.uint64).reshape(5, -1)
    assert e.shape[1] <= n
    order = np.lexsort((e[2], e[0], e[1]))
    out = np.full((5, n), np.uint64(U64M), np.uint64)
    out[:, :e.shape[1]] = e[:, order]
    return out


def ledger(rng, n: int, n_accts: int = 8, ts0: int = 1000):
    """``n`` transfers in time order: (debit, credit) accounts (lo; hi 0 or
    1), timestamps increasing, random tids."""
    dr = rng.integers(1, n_accts + 1, n).astype(np.uint64)
    cr = (dr + rng.integers(1, n_accts, n).astype(np.uint64) - 1) % np.uint64(
        n_accts) + np.uint64(1)
    hi = (rng.random(n) < 0.2).astype(np.uint64)
    ts = ts0 + np.cumsum(rng.integers(1, 4, n)).astype(np.uint64)
    tid_lo = rng.integers(1, 1 << 63, n, dtype=np.uint64)
    tid_hi = rng.integers(0, 3, n).astype(np.uint64)
    return dr, cr, hi, ts, tid_lo, tid_hi


def pyramid(rng, occupied, fill=0.9, n_accts=8, base=BASE):
    """Both sides of a pyramid whose level j holds ``base << j`` entries
    (``fill`` of them real) when ``occupied[j]`` (the oldest transfers in
    the deepest level), else only sentinels; and the timestamps."""
    sizes = [base << j for j in range(len(occupied))]
    counts = [int(s * fill) if o else 0 for s, o in zip(sizes, occupied)]
    dr, cr, hi, ts, tlo, thi = ledger(rng, sum(counts), n_accts)
    dr_levels, cr_levels, at = [], [], 0
    for j in reversed(range(len(sizes))):  # the deepest level is the oldest
        s = slice(at, at + counts[j])
        at += counts[j]
        dr_levels.append(level([dr[s], hi[s], ts[s], tlo[s], thi[s]], sizes[j]))
        cr_levels.append(level([cr[s], hi[s], ts[s], tlo[s], thi[s]], sizes[j]))
    return dr_levels[::-1], cr_levels[::-1], ts


def case(name: str):
    rng = np.random.default_rng(CASES.index(name))
    if name in ("one_side_unwanted", "wrap", "no_rows", "k1"):
        dr, cr, ts = pyramid(rng, [True, False, True, True, True])
        mid = int(ts[len(ts) // 3]), int(ts[2 * len(ts) // 3])
        q = {
            "one_side_unwanted": [(3, 0, 1, U64M - 1, True, False, 64, False),
                                  (3, 0, 1, U64M - 1, False, True, 64, True),
                                  (5, 1, *mid, False, True, 256, False),
                                  (2, 0, 1, U64M - 1, False, False, 64, True),
                                  (3, 0, 1, U64M - 1, False, True, 512, False)],
            "wrap": [(4, 0, 1, U64M, True, True, 64, True),
                     (4, 0, 0, U64M, True, True, 64, False),
                     (4, 0, mid[0], U64M, True, False, 64, True)],
            "no_rows": [(99, 0, 1, U64M - 1, True, True, 64, False),
                        (99, 7, 1, U64M - 1, True, True, 64, True)],
            "k1": [(3, 0, 1, U64M - 1, True, True, 1, False),
                   (3, 0, 1, U64M - 1, True, True, 1, True),
                   (6, 0, *mid, False, True, 1, False)],
        }[name]
        return dr, cr, q
    if name == "sentinel_levels":
        dr, cr, ts = pyramid(rng, [False, True, False, True, False])
        return dr, cr, [(2, 0, 1, U64M - 1, True, True, 128, False),
                        (2, 0, 1, U64M - 1, True, True, 128, True)]
    if name == "long_run":
        # Two accounts only: each level holds runs far longer than k.
        dr, cr, ts = pyramid(rng, [True, True, True, True], fill=1.0,
                             n_accts=2)
        mid = int(ts[len(ts) // 4]), int(ts[3 * len(ts) // 4])
        return dr, cr, [(1, 0, 1, U64M - 1, True, True, 16, False),
                        (1, 0, 1, U64M - 1, True, True, 16, True),
                        (2, 0, *mid, True, True, 100, False),
                        (2, 1, 1, U64M - 1, True, False, 40, True)]
    if name == "deepest_only":
        dr, cr, ts = pyramid(rng, [False, False, False, False, True])
        return dr, cr, [(4, 0, 1, U64M - 1, True, True, 512, False),
                        (4, 1, 1, U64M - 1, True, True, 512, True)]
    if name == "edge_ts":
        # Account 3 (hi 0) has entries of ts 0 and U64_MAX, and ts 500 in
        # two levels of the debit side; account 1 fills the rest.
        lv = []
        for j, extra in enumerate(([0, 500], [500, 7, U64M], [U64M - 1, 9])):
            n = len(extra)
            fill = 20
            acct = np.concatenate([np.full(n, 3), np.ones(fill)]).astype(np.uint64)
            e = [acct, np.zeros(n + fill, np.uint64),
                 np.concatenate([np.array(extra, np.uint64),
                                 rng.integers(1, 1000, fill).astype(np.uint64)]),
                 rng.integers(1, 1 << 62, n + fill, dtype=np.uint64),
                 np.full(n + fill, j, np.uint64)]
            lv.append(level(e, 32 << j))
        cr = [level([[2], [0], [500], [55], [0]], 32)]
        return lv, cr, [(3, 0, 0, U64M, True, True, 16, False),
                        (3, 0, 0, U64M, True, True, 16, True),
                        (3, 0, 0, U64M - 1, True, True, 16, True),
                        (3, 0, 1, U64M, True, False, 4, False)]
    if name == "over_stage":
        # Six levels of one side, each 3,000 entries of account 5 with
        # interleaved timestamps (level j: ts = 6 i + j + 1) among others.
        dr = []
        for j in range(6):
            n, other = 3000, 500
            ts = np.concatenate([6 * np.arange(n) + j + 1,
                                 rng.integers(1, 1 << 20, other)]).astype(np.uint64)
            acct = np.concatenate([np.full(n, 5), rng.integers(1, 5, other)])
            e = [acct.astype(np.uint64), np.zeros(n + other, np.uint64), ts,
                 rng.integers(1, 1 << 62, n + other, dtype=np.uint64),
                 np.full(n + other, j, np.uint64)]
            dr.append(level(e, 4096))
        return dr, [], [(5, 0, 1, U64M - 1, True, True, 8192, False),
                        (5, 0, 1, U64M - 1, True, True, 8192, True)]
    raise ValueError(f"unknown case {name!r}")
