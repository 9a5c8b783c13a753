"""Batches that set the traps of K9 ``full_index`` (``csrc/full_index.cu``:
one lane a thread over the card, the batch's ids in an open-addressing
table of full_index_slots(n) slots, each group's lead an atomicMin, then
each lane's lead and pending join read after a grid barrier), in numpy:
random two-phase-like ids with duplicates; every id equal; every id 0; a
long run of ids forced to the table's last home slot (a chain that
wraps); pending ids naming id 0, a missing id and the lane's own id; at
n = 1, 8,190 and 8,192 lanes.
``case(name, n)`` returns (id_lo, id_hi, pending_id_lo, pending_id_hi),
u64 arrays.  The CPU tests hold the plain version against the JAX
package's grouping and pending join on them, the card tests the kernel
against its plain version."""

from __future__ import annotations

import numpy as np

from ..ops._cuda import full_index_slots
from ..utils.benchgen import mix64_np

CASES = ("random", "all_equal", "all_zero", "one_home", "pending_joins")
SIZES = (1, 8190, 8192)
ONE_HOME = 512  # distinct ids sharing one home slot (a probe chain that long)


def one_home_ids(count: int, hsize: int, seed: int = 0) -> np.ndarray:
    """``count`` distinct nonzero 64-bit ids (hi 0) whose home slot at
    ``hsize`` is the last, so that their probe chain wraps to slot 0."""
    rng = np.random.default_rng([hsize, seed])
    found = np.zeros(0, np.uint64)
    while len(found) < count:
        cand = rng.integers(1, 1 << 62, count * hsize, dtype=np.uint64)
        home = mix64_np(cand, 0) & np.uint64(hsize - 1)
        found = np.unique(np.concatenate([found, cand[home == hsize - 1]]))
    return found[:count]


def case(name: str, n: int, seed: int = 0):
    rng = np.random.default_rng([n, CASES.index(name), seed])
    lo = np.zeros(n, np.uint64)
    hi = np.zeros(n, np.uint64)
    if name == "random":
        # Unique ids, 5 % repeating an earlier or later lane's, 3 % zero;
        # pendings naming some lane's id (either side of it), a missing id
        # or 0.
        lo[:] = rng.integers(1, 1 << 62, n, dtype=np.uint64)
        hi[:] = np.where(rng.random(n) < 0.2, rng.integers(1, 4, n), 0)
        dup = rng.random(n) < 0.05
        src = rng.integers(0, n, n)
        lo[dup], hi[dup] = lo[src[dup]], hi[src[dup]]
        zero = rng.random(n) < 0.03
        lo[zero] = hi[zero] = 0
        ref = rng.integers(0, n, n)
        plo, phi = lo[ref].copy(), hi[ref].copy()
        kind = rng.random(n)
        plo[kind < 0.2] = rng.integers(1 << 62, 1 << 63, int((kind < 0.2).sum()),
                                       dtype=np.uint64)
        plo[(kind >= 0.2) & (kind < 0.3)] = 0
        phi[kind < 0.3] = 0
    elif name == "all_equal":
        lo[:], hi[:] = 12345, 6
        plo, phi = lo.copy(), hi.copy()
    elif name == "all_zero":
        plo = np.zeros(n, np.uint64)
        phi = np.zeros(n, np.uint64)
    elif name == "one_home":
        # A run of ids with one home slot, each in several lanes (the rest
        # random); pendings name them and missing ids of the same home, so
        # a find walks the whole chain and misses.
        same = one_home_ids(min(ONE_HOME, n) + 64, full_index_slots(n))
        ids, missing = same[:min(ONE_HOME, n)], same[min(ONE_HOME, n):]
        lo[:] = rng.integers(1, 1 << 62, n, dtype=np.uint64)
        lanes = rng.permutation(n)[:min(n, 3 * len(ids))]
        lo[lanes] = ids[rng.integers(0, len(ids), len(lanes))]
        plo = np.where(rng.random(n) < 0.5, ids[rng.integers(0, len(ids), n)],
                       missing[rng.integers(0, len(missing), n)])
        phi = np.zeros(n, np.uint64)
    elif name == "pending_joins":
        lo[:] = rng.integers(1, 1 << 62, n, dtype=np.uint64)
        hi[:] = np.where(rng.random(n) < 0.5, 1, 0)
        lo[rng.random(n) < 0.1] = 0
        hi[lo == 0] = 0
        kind = rng.integers(0, 3, n)
        plo = np.where(kind == 0, 0, np.where(kind == 1, lo ^ np.uint64(1 << 63),
                                              lo)).astype(np.uint64)
        phi = np.where(kind == 0, 0, hi).astype(np.uint64)
    else:
        raise ValueError(f"unknown case {name!r}")
    return lo, hi, np.asarray(plo, np.uint64), np.asarray(phi, np.uint64)
