"""Tables and keys that set the traps of K1's rounds (``csrc/probe.cu``:
a lane reads the aligned group of four slots that holds its current slot
and decides them in order; up to eight lookups share a launch), in numpy,
so that each case puts keys, tombstones and homes exactly where its trap
needs them.

``case(name)`` returns (table arrays, lookups, max_probe): the table as the
exchange dict of ``convert`` (key_lo, key_hi, tombstone, count,
probe_overflow, cols ``val`` u64 and ``tag`` u32), and a list of lookups,
each a dict of key_lo, key_hi (u64 arrays), count, mask (bool array or
None) and hash_shift.  ``FUSED`` is the case whose lookups go through one
launch with several tables (``fused_case``).

- ``keys_zero``: key 0 (done at once), and keys whose lo or hi alone is 0.
- ``wrap``: clusters that run past the table's last slot into slot 0.
- ``tomb_edges``: tombstones on a group's last slot and across two groups'
  edge, keys found after them and absent keys that pass them.
- ``max_probe_1``, ``max_probe_2``: probes cut short (the overflow flag).
- ``hash_shift``: a table placed with homes (mix64 >> 2).
- ``mask_count``: a lane mask and a count below the lanes.
- ``random``: a table at load 0.45 with clusters, half the keys stored.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..utils.benchgen import mix64_np

CASES = ("keys_zero", "wrap", "tomb_edges", "max_probe_1", "max_probe_2",
         "hash_shift", "mask_count", "random")
MAX_PROBE = 1 << 12
CAP = 64


def _homes(lo, hi, cap, shift):
    with np.errstate(over="ignore"):
        x = mix64_np(lo ^ (hi * np.uint64(0x9E3779B97F4A7C15)), 0)
    return ((x >> np.uint64(shift)) & np.uint64(cap - 1)).astype(np.int64)


def ids_at(cap: int, home: int, k: int, shift: int = 0, start: int = 1):
    """``k`` keys (hi 0) from ``start`` on whose home is ``home``."""
    cand = np.arange(start, start + (1 << 20), dtype=np.uint64)
    h = _homes(cand, np.zeros_like(cand), cap, shift)
    got = cand[h == home][:k]
    assert len(got) == k, "too few candidates"
    return got


def build(cap: int, lo, hi=None, tombs=(), shift: int = 0) -> Dict:
    """A table holding keys (lo, hi) placed in order by linear probing
    from their homes, then tombstones at the slots ``tombs`` (whatever
    they held)."""
    lo = np.asarray(lo, np.uint64)
    hi = np.zeros_like(lo) if hi is None else np.asarray(hi, np.uint64)
    key_lo = np.zeros(cap, np.uint64)
    key_hi = np.zeros(cap, np.uint64)
    tomb = np.zeros(cap, bool)
    for a, b, h in zip(lo, hi, _homes(lo, hi, cap, shift)):
        s = int(h)
        while key_lo[s] or key_hi[s] or tomb[s]:
            s = (s + 1) & (cap - 1)
        key_lo[s], key_hi[s] = a, b
    for s in tombs:
        key_lo[s] = key_hi[s] = 0
        tomb[s] = True
    live = (key_lo | key_hi) != 0
    rng = np.random.default_rng(cap + len(lo))
    val = rng.integers(1, 1 << 63, cap, dtype=np.uint64) * live
    tag = (rng.integers(1, 1 << 32, cap, dtype=np.uint64) * live).astype(np.uint32)
    return {"key_lo": key_lo, "key_hi": key_hi, "tombstone": tomb,
            "count": np.asarray(int(live.sum()), np.uint64),
            "probe_overflow": np.asarray(False),
            "cols": {"val": val, "tag": tag}}


def _lookup(lo, hi=None, count=None, mask=None, shift=0) -> Dict:
    lo = np.asarray(lo, np.uint64)
    return {"key_lo": lo,
            "key_hi": np.zeros_like(lo) if hi is None else np.asarray(hi, np.uint64),
            "count": len(lo) if count is None else count,
            "mask": None if mask is None else np.asarray(mask, bool),
            "hash_shift": shift}


def stored(t: Dict):
    live = (t["key_lo"] | t["key_hi"]) != 0
    return t["key_lo"][live], t["key_hi"][live]


def _keys_zero():
    lo = np.array([5, 0, 9, 0, 77, 1 << 63], np.uint64)
    hi = np.array([0, 3, 0, 8, 1, 0], np.uint64)
    t = build(CAP, lo, hi)
    q_lo = np.array([0, 5, 0, 0, 9, 77, 0, 1 << 63, 4], np.uint64)
    q_hi = np.array([0, 0, 3, 8, 0, 1, 0, 0, 0], np.uint64)
    return t, [_lookup(q_lo, q_hi)], MAX_PROBE


def _wrap():
    a = ids_at(CAP, CAP - 2, 5)
    b = ids_at(CAP, 1, 2)
    t = build(CAP, np.concatenate([a, b]), tombs=[CAP - 1])
    absent = ids_at(CAP, CAP - 1, 3, start=1 << 30)
    q = np.concatenate([a, b, absent])
    return t, [_lookup(q)], MAX_PROBE


def _tomb_edges():
    # A run from slot 9 over slots 10, 11 (a group's last), 12, 13 and on.
    a = ids_at(CAP, 9, 8)
    t = build(CAP, a, tombs=[11, 12, 15])
    absent = np.concatenate([ids_at(CAP, 9, 2, start=1 << 30),
                             ids_at(CAP, 11, 2, start=1 << 31),
                             ids_at(CAP, 15, 1, start=1 << 32)])
    q = np.concatenate([a, absent])
    return t, [_lookup(q)], MAX_PROBE


def _max_probe(k):
    def make():
        a = ids_at(CAP, 20, 6)
        t = build(CAP, a, tombs=[21])
        return t, [_lookup(np.concatenate([a, ids_at(CAP, 20, 2, start=1 << 30)]))], k
    return make


def _hash_shift():
    shift = 2
    a = np.concatenate([ids_at(CAP, 30, 5, shift), ids_at(CAP, CAP - 1, 3, shift)])
    t = build(CAP, a, tombs=[32], shift=shift)
    q = np.concatenate([a, ids_at(CAP, 30, 2, shift, start=1 << 30)])
    return t, [_lookup(q, shift=shift)], MAX_PROBE


def _mask_count():
    a = np.concatenate([ids_at(CAP, 40, 4), ids_at(CAP, 50, 4)])
    t = build(CAP, a, tombs=[41])
    q = np.concatenate([a, a[:4]])
    mask = np.arange(len(q)) % 3 != 1
    return t, [_lookup(q, count=len(q) - 3, mask=mask)], MAX_PROBE


def _random():
    cap = 1 << 10
    rng = np.random.default_rng(7)
    keys = rng.integers(1, 1 << 62, int(cap * 0.45), dtype=np.uint64)
    clusters = np.concatenate([ids_at(cap, h, 6, start=1 << 40)
                               for h in (100, 511, 1023)])
    keys = np.concatenate([keys, clusters])
    t = build(cap, keys, tombs=rng.choice(cap, 40, replace=False))
    slo, shi = stored(t)
    q = np.concatenate([rng.choice(slo, 256), clusters,
                        rng.integers(1, 1 << 62, 238, dtype=np.uint64)])
    return t, [_lookup(q)], MAX_PROBE


_BUILD = {"keys_zero": _keys_zero, "wrap": _wrap, "tomb_edges": _tomb_edges,
          "max_probe_1": _max_probe(1), "max_probe_2": _max_probe(2),
          "hash_shift": _hash_shift, "mask_count": _mask_count,
          "random": _random}


def case(name: str):
    return _BUILD[name]()


def fused_case():
    """Three tables and five lookups for one launch, as the general path
    makes them: a lookup of the ``random`` table gathering ``val`` and
    ``tag``, two of the ``wrap`` table (a mask on one), and two chained
    after the first, keyed by its gathered ``val`` (whose rows hold keys
    of the ``tomb_edges`` table and the ``wrap`` table).  Returns (tables,
    lookups): each lookup a dict of ``table`` (an index), key_lo, key_hi
    (arrays, or None), ``keys_from`` (lookup index, lo column, hi column
    or None), mask, count and ``cols``."""
    t_r, [l_r], _ = _random()
    t_w, [l_w], _ = _wrap()
    t_t, [l_t], _ = _tomb_edges()
    n = len(l_r["key_lo"])
    rng = np.random.default_rng(3)
    # The random table's val column holds keys of the other two tables.
    live = (t_r["key_lo"] | t_r["key_hi"]) != 0
    pool = np.concatenate([stored(t_t)[0], stored(t_w)[0], [0, 12345]])
    t_r["cols"]["val"] = np.where(live, rng.choice(pool, len(live)),
                                  0).astype(np.uint64)
    wq = np.resize(l_w["key_lo"], n)
    lookups = [
        dict(table=0, key_lo=l_r["key_lo"], key_hi=l_r["key_hi"], keys_from=None,
             mask=None, count=n - 5, cols=("val", "tag")),
        dict(table=1, key_lo=wq, key_hi=None, keys_from=None,
             mask=rng.random(n) < 0.7, count=n, cols=("tag",)),
        dict(table=2, key_lo=None, key_hi=None, keys_from=(0, "val", None),
             mask=None, count=n, cols=("val", "tag")),
        dict(table=1, key_lo=None, key_hi=None, keys_from=(0, "val", None),
             mask=None, count=n, cols=("val",)),
        dict(table=1, key_lo=wq[::-1].copy(), key_hi=None, keys_from=None,
             mask=None, count=n // 2, cols=()),
    ]
    return [t_r, t_w, t_t], lookups


def all_lookups() -> List:
    """(name, table, lookup, max_probe) of every case's lookups."""
    out = []
    for name in CASES:
        t, looks, max_probe = case(name)
        out += [(name, t, lk, max_probe) for lk in looks]
    return out
