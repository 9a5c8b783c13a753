"""Inputs that set the traps of K14 ``run_merge`` (``csrc/index_merge.cu``:
the tiles' merge-path splits, a full build's rounds over live prefixes and
its tail), in numpy, as u64 columns in ``ops/index.py``'s COLS order
(acct_lo, acct_hi, ts, tid_lo, tid_hi).

- ``carry(base, k, mode)``: the sorted run and levels 0..k-1 of a carry into
  level k (``CARRY_MODES``: random keys; ties, few distinct keys so that
  equal keys meet across sources and across a tile's edge; runs that are
  only sentinels; live entries whose key is the sentinel key with other
  ids).
- ``pair(name)``: two sorted runs (``PAIR_CASES``: A or B empty, equal keys
  across a tile's edge, a run of sentinels beside live entries).
- ``entries(n, mode)``: a full build's input, five columns and the live
  mask (``BUILD_MODES``).

The CPU tests hold K14's plain split forms against the JAX package on
them, the card tests the kernel against its plain versions."""

from __future__ import annotations

import numpy as np

U64M = np.uint64((1 << 64) - 1)
CARRY_MODES = ("random", "ties", "sentinels", "sentinel_key")
PAIR_CASES = ("a_empty", "b_empty", "ties_across_tile", "sentinels_beside_live")
BUILD_MODES = ("random", "ties", "none_live", "all_live", "sentinel_key",
               "empty_chunks")
BUILD_SIZES = (8192, 1 << 14)


def _cols(rng, n, mode, live):
    """Five u64 columns of ``n`` entries, sentinels where not ``live``."""
    if mode == "ties":
        lo = rng.integers(1, 4, n, dtype=np.uint64)
        ts = rng.integers(1, 5, n, dtype=np.uint64)
    else:
        lo = rng.integers(1, 1000, n, dtype=np.uint64)
        ts = rng.integers(1, 1 << 40, n, dtype=np.uint64)
    hi = (rng.random(n) < 0.1).astype(np.uint64)
    cols = [lo, hi, ts, rng.integers(1, 1 << 62, n, dtype=np.uint64),
            rng.integers(0, 3, n, dtype=np.uint64)]
    if mode == "sentinel_key":
        # Live entries keyed by the sentinel key, ids their own.
        k = rng.random(n) < 0.2
        for c in cols[:3]:
            c[k] = U64M
    return [np.where(live, c, U64M) for c in cols]


def sort_block(cols):
    """The (5, n) block of ``cols`` in stable (acct_hi, acct_lo, ts) order."""
    order = np.lexsort((cols[2], cols[0], cols[1]))
    return np.stack([c[order] for c in cols])


def level(rng, n, mode):
    live = rng.random(n) < (0.0 if mode == "sentinels" else 0.97)
    return sort_block(_cols(rng, n, mode, live))


def carry(base, k, mode, seed=0):
    """The carry into level ``k``: the run (``base`` entries), then levels
    0..k-1 (``base << j``), each a sorted (5, n) block."""
    rng = np.random.default_rng(seed + 100 * k)
    return [level(rng, base, mode)] + [level(rng, base << j, mode)
                                       for j in range(k)]


def pair(name, seed=0):
    rng = np.random.default_rng(seed)
    if name == "a_empty":
        return level(rng, 0, "random"), level(rng, 3000, "random")
    if name == "b_empty":
        return level(rng, 3000, "random"), level(rng, 0, "random")
    if name == "ties_across_tile":
        # 1,500 + 1,500 entries of two keys: the tile's edge at output
        # 2,048 falls in the middle of the second key's stretch.
        a = _cols(rng, 1500, "random", np.ones(1500, bool))
        b = _cols(rng, 1500, "random", np.ones(1500, bool))
        for c in (a, b):
            c[0][:] = np.where(np.arange(1500) < 700, 5, 6)
            c[1][:] = 0
            c[2][:] = 9
        return sort_block(a), sort_block(b)
    if name == "sentinels_beside_live":
        return level(rng, 2500, "sentinel_key"), level(rng, 2600, "sentinels")
    raise KeyError(name)


def entries(n, mode, seed=0):
    """A full build's input: (five u64 columns, live mask)."""
    rng = np.random.default_rng(seed + n)
    if mode == "none_live":
        live = np.zeros(n, bool)
    elif mode == "all_live":
        live = np.ones(n, bool)
    elif mode == "empty_chunks":
        # Whole chunks of 1,024 with no live entry beside full ones.
        live = np.repeat(rng.random(n // 1024) < 0.5, 1024)
    else:
        live = rng.random(n) < 0.3
    return _cols(rng, n, "ties" if mode == "ties" else
                 "sentinel_key" if mode == "sentinel_key" else "random",
                 live), live
