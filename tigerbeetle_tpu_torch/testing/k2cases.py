"""Batches and tables that set the traps of K2's split form
(``csrc/insert.cu``: the pre-pass's windows, the resolver's rounds over
home groups) and of its round form (more than 8,192 lanes: round 0 over
the batch, the walker lists, the one-block tail), in numpy, so that each
case puts occupied slots, tombstones and lane homes exactly where its trap
needs them.  ``CASES`` and ``ROUND_CASES`` map a name to a function
returning (table arrays, keys, mask, max_probe, hash_shift);
``shift_case(shift)`` builds the hash-shift case, ``grow_case()`` a table
with tombstones to grow and ``evict_case(keep)`` a table and the keep mask
of a rebuild that keeps none, some or all of its rows.  The CPU tests hold
the forms' plain versions against the JAX package on them, the card tests
the kernels against their plain versions."""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..ops import hash_table as ht
from ..utils.benchgen import mix64_np

CANDIDATES = np.arange(1, 1 << 21, dtype=np.uint64)
_MIX = None


def _mix():
    global _MIX
    if _MIX is None:
        _MIX = mix64_np(CANDIDATES, 0)
    return _MIX


class Keys:
    """Distinct nonzero keys (hi 0) with chosen homes, never one twice."""

    def __init__(self, cap, shift):
        homes = (_mix() >> np.uint64(shift)) & np.uint64(cap - 1)
        order = np.argsort(homes, kind="stable")
        self.sorted = CANDIDATES[order]
        self.starts = np.searchsorted(homes[order], np.arange(cap + 1))
        self.used = np.zeros(cap, np.int64)

    def at(self, home, k=1):
        s = self.starts[home] + self.used[home]
        assert s + k <= self.starts[home + 1], "too few candidates"
        self.used[home] += k
        return list(self.sorted[s:s + k])


def build(cap, occupied=(), tombs=(), hi_only=()):
    """Table arrays: random keys at ``occupied``, key_hi alone at
    ``hi_only``, tombstones at ``tombs``; a u64 and a u32 column."""
    rng = np.random.default_rng(cap + len(occupied))
    key_lo = np.zeros(cap, np.uint64)
    key_hi = np.zeros(cap, np.uint64)
    occ = np.asarray(list(occupied), np.int64)
    key_lo[occ] = rng.integers(1 << 62, 1 << 63, len(occ), dtype=np.uint64)
    key_hi[np.asarray(list(hi_only), np.int64)] = 7
    tomb = np.zeros(cap, bool)
    tomb[np.asarray(list(tombs), np.int64)] = True
    live = (key_lo | key_hi) != 0
    val = rng.integers(0, 1 << 63, cap, dtype=np.uint64) * live
    count = int(live.sum())
    return dict(key_lo=key_lo, key_hi=key_hi, tombstone=tomb,
                cols={"val": val, "tag": val.astype(np.uint32)},
                count=np.uint64(count), probe_overflow=np.bool_(False))


def table_from_arrays(a, device) -> ht.Table:
    """A port table on ``device`` holding ``build``'s arrays."""
    return ht.Table(key_lo=convert.array_to_tensor(a["key_lo"], device),
                    key_hi=convert.array_to_tensor(a["key_hi"], device),
                    tombstone=torch.from_numpy(a["tombstone"].copy()).to(device),
                    cols={k: convert.array_to_tensor(v, device)
                          for k, v in a["cols"].items()},
                    count=convert.array_to_tensor(a["count"], device),
                    probe_overflow=torch.tensor(bool(a["probe_overflow"]),
                                                device=device))


def homes_of(lo, cap, shift=0):
    return (mix64_np(np.asarray(lo, np.uint64), 0) >> np.uint64(shift)) \
        & np.uint64(cap - 1)


CAP = 1 << 10


def case_long_cluster():
    """An occupied run of 80 slots: lanes homed inside it walk past one and
    two windows of 32 slots (the resolver reads the table again at each
    window's end)."""
    k = Keys(CAP, 0)
    h = 100
    occupied = [s for s in range(h, h + 80) if s != h + 40]
    lo = k.at(h, 3) + k.at(h + 10) + k.at(h + 39, 2) + k.at(h + 79)
    return build(CAP, occupied), lo, [True] * len(lo), 1 << 9, 0


def case_lost_slot_walks_on():
    """A's second lane loses slot h+1 to B (claimed in round 0), passes an
    occupied slot, then meets C's claim at h+3, E's at h+4 (E walked there
    from its occupied home h+2) and D's two at h+6 and h+7 (D's window),
    and lands on h+8: each slot it loses was free in the table and taken
    by the batch in an earlier round."""
    k = Keys(CAP, 0)
    h = 300
    a = k.at(h, 2)
    b, c = k.at(h + 1), k.at(h + 3)
    e = k.at(h + 2)  # home occupied in the table: walks from round 1
    d = k.at(h + 6, 2)
    lo = a + b + e + c + d
    return build(CAP, [h + 2, h + 5]), lo, [True] * len(lo), 1 << 9, 0


def case_same_home_groups():
    """Groups of 2-9 lanes on one home each, interleaved in lane order with
    their neighbours' groups."""
    k = Keys(CAP, 0)
    rng = np.random.default_rng(3)
    lo = []
    for j, h in enumerate((500, 503, 505, 507, 520)):
        lo += k.at(h, 2 + 2 * j)
    lo = list(rng.permutation(np.asarray(lo, np.uint64)))
    return build(CAP, range(510, 530, 3)), lo, [True] * len(lo), 1 << 9, 0


def case_tombstones_in_window():
    """Tombstones (and a key held in key_hi alone) inside the windows are
    occupied: probes pass them, claims never reuse them."""
    k = Keys(CAP, 0)
    h = 600
    lo = k.at(h, 4) + k.at(h + 2) + k.at(h + 9, 2)
    return (build(CAP, [h + 1], tombs=[h, h + 3, h + 4, h + 10],
                  hi_only=[h + 6]), lo, [True] * len(lo), 1 << 9, 0)


def case_wrap_at_end():
    """Homes at the table's last slots: windows and walks wrap to slot 0."""
    k = Keys(CAP, 0)
    lo = k.at(CAP - 1, 3) + k.at(CAP - 2, 2) + k.at(0) + k.at(1)
    return (build(CAP, [CAP - 3, 0, 2], tombs=[3]), lo, [True] * len(lo),
            1 << 9, 0)


def case_max_probe_small():
    """max_probe 2 inside the window: the batch stops after round 1."""
    table, lo, mask, _, _ = case_same_home_groups()
    return table, lo, mask, 2, 0


def case_max_probe_in_window():
    """max_probe 13, reached by a group inside its first window."""
    table, lo, mask, _, _ = case_long_cluster()
    return table, lo, mask, 13, 0


def case_max_probe_past_window():
    """max_probe 40: the overflow after one window refill."""
    table, lo, mask, _, _ = case_long_cluster()
    return table, lo, mask, 40, 0


def case_masked_lanes():
    """Masked-out lanes sit in every group and take no slot."""
    k = Keys(CAP, 0)
    rng = np.random.default_rng(5)
    lo = k.at(700, 6) + k.at(701, 3) + k.at(705, 4) + list(
        rng.integers(1 << 40, 1 << 41, 200, dtype=np.uint64))
    mask = rng.random(len(lo)) < 0.6
    return build(CAP, range(690, 720, 4)), lo, mask, 1 << 9, 0


def case_one_lane():
    """n = 1, its home occupied."""
    k = Keys(CAP, 0)
    return build(CAP, [42, 43]), k.at(42), [True], 1 << 9, 0


def case_random_dense():
    """512 lanes (80 % masked in) into a table 45 % full with tombstones."""
    rng = np.random.default_rng(9)
    cap = 1 << 12
    occ = rng.choice(cap, int(cap * 0.45), replace=False)
    lo = rng.choice(1 << 40, 512, replace=False).astype(np.uint64) + 1
    return (build(cap, occ[:-40], tombs=occ[-40:]), lo,
            rng.random(512) < 0.8, 1 << 9, 0)


def case_full_batch():
    """n = 8,192 lanes, 1,600 masked in, into 2^12 slots a quarter full."""
    rng = np.random.default_rng(11)
    cap = 1 << 12
    occ = rng.choice(cap, cap // 4, replace=False)
    lo = rng.choice(1 << 40, 8192, replace=False).astype(np.uint64) + 1
    mask = np.zeros(8192, bool)
    mask[rng.choice(8192, 1600, replace=False)] = True
    return build(cap, occ), lo, mask, 1 << 9, 0


CASES = {f.__name__[5:]: f for f in (
    case_long_cluster, case_lost_slot_walks_on, case_same_home_groups,
    case_tombstones_in_window, case_wrap_at_end, case_max_probe_small,
    case_max_probe_in_window, case_max_probe_past_window, case_masked_lanes,
    case_one_lane, case_random_dense, case_full_batch)}




def shift_case(shift):
    """Homes from the hash's high bits (``hash_shift``): same-home groups,
    a cluster of 40 occupied slots and the wrap at the table's end."""
    k = Keys(CAP, shift)
    rng = np.random.default_rng(shift)
    lo = (k.at(CAP - 1, 4) + k.at(5, 3) + k.at(6) + k.at(400, 2)
          + list(rng.integers(1 << 41, 1 << 42, 120, dtype=np.uint64)))
    occupied = [CAP - 1, 0, 1, 7] + list(range(400, 440))
    return (build(CAP, occupied, tombs=[8, 9]), lo, rng.random(len(lo)) < 0.9,
            1 << 9, shift)


# The claims of case "lost_slot_walks_on": A's second lane loses h+1, h+3,
# h+4, h+6 and h+7 to claims of earlier rounds and lands on h+8.
LOST_SLOT_CLAIMS = [300, 308, 301, 304, 303, 306, 307]


# -- the round form: more than 8,192 lanes ------------------------------------

RCAP = 1 << 15
ROUND_N = 9000  # lanes of every round case (masked-out padding after the keys)


def _round_batch(lo, mask, rng):
    """``lo`` and ``mask`` padded to ROUND_N lanes with masked-out keys,
    then shuffled (lane order is what breaks ties)."""
    lo = np.asarray(lo, np.uint64)
    mask = np.asarray(mask, bool)
    pad = ROUND_N - len(lo)
    assert pad >= 0, len(lo)
    lo = np.concatenate([lo, (1 << 52) + np.arange(pad, dtype=np.uint64)])
    mask = np.concatenate([mask, np.zeros(pad, bool)])
    perm = rng.permutation(ROUND_N)
    return list(lo[perm]), mask[perm]


def _fill(k, rng, n, cap, avoid=()):
    """``n`` keys homed at random slots outside ``avoid``."""
    avoid = set(avoid)
    homes = [h for h in rng.integers(0, cap, 2 * n) if int(h) not in avoid][:n]
    return [x for h in homes for x in k.at(int(h))]


def case_round_wrap_cluster():
    """One occupied cluster of 600 slots across the table's end (a few
    holes), 700 lanes homed inside it and 8,000 elsewhere: walks wrap to
    slot 0 and run long past round 0's list into the one-block tail."""
    rng = np.random.default_rng(21)
    k = Keys(RCAP, 0)
    cluster = [(RCAP - 300 + j) % RCAP for j in range(600)]
    occupied = [s for j, s in enumerate(cluster) if j % 97]
    lo = [x for h in rng.choice(cluster, 700) for x in k.at(int(h))]
    lo += _fill(k, rng, 8000, RCAP, cluster)
    lo, mask = _round_batch(lo, [True] * len(lo), rng)
    return build(RCAP, occupied), lo, mask, RCAP, 0


def case_round_big_groups():
    """120 same-home groups of 33-50 lanes (more than a warp each) among
    2,000 other lanes, into a table a fifth full: over 2,048 walkers are
    left after round 0, so the grid's rounds run before the tail."""
    rng = np.random.default_rng(22)
    k = Keys(RCAP, 0)
    roomy = np.flatnonzero(np.diff(k.starts) >= 50)
    homes = rng.choice(roomy, 120, replace=False)
    lo = [x for h in homes for x in k.at(int(h), int(rng.integers(33, 51)))]
    lo += _fill(k, rng, 2000, RCAP, homes)
    occ = rng.choice(RCAP, RCAP // 5, replace=False)
    lo, mask = _round_batch(lo, [True] * len(lo), rng)
    return build(RCAP, occ[:-500], tombs=occ[-500:]), lo, mask, RCAP, 0


def case_round_max_probe():
    """The big groups with max_probe 20: the groups outlast it."""
    table, lo, mask, _, shift = case_round_big_groups()
    return table, lo, mask, 20, shift


def case_round_max_probe_tail():
    """max_probe 3 on the wrapped cluster: the overflow in the tail."""
    table, lo, mask, _, shift = case_round_wrap_cluster()
    return table, lo, mask, 3, shift


def case_round_masked():
    """9,000 lanes, about half masked in, into a table 40 % full with
    tombstones; some same-home pairs."""
    rng = np.random.default_rng(23)
    k = Keys(RCAP, 0)
    lo = _fill(k, rng, 8500, RCAP)
    lo += [x for h in rng.choice(RCAP, 250) for x in k.at(int(h), 2)]
    occ = rng.choice(RCAP, int(RCAP * 0.4), replace=False)
    lo, mask = _round_batch(lo, rng.random(len(lo)) < 0.5, rng)
    return build(RCAP, occ[:-2000], tombs=occ[-2000:]), lo, mask, RCAP, 0


ROUND_CASES = {f.__name__[5:]: f for f in (
    case_round_wrap_cluster, case_round_big_groups, case_round_max_probe,
    case_round_max_probe_tail, case_round_masked)}


GCAP = 1 << 14


def grow_case():
    """A table of 2^14 slots about half full, an eighth of its slots then
    tombstones: ``grow`` to 2^15 takes 16,384 lanes, and drops the
    tombstones."""
    rng = np.random.default_rng(24)
    occ = rng.choice(GCAP, GCAP // 2, replace=False)
    return build(GCAP, occ[:-GCAP // 8], tombs=occ[-GCAP // 8:])


def evict_case(keep: str):
    """A table of 2^14 slots (rows with timestamps, tombstones) and the
    keep mask of a rebuild that keeps ``keep`` ("none", "some", "all") of
    its live rows, with the threshold timestamp that gives it."""
    a = grow_case()
    rng = np.random.default_rng(25)
    live = (a["key_lo"] | a["key_hi"]) != 0
    live &= ~a["tombstone"]
    ts = rng.integers(1, 1000, GCAP, dtype=np.uint64) * live
    a["cols"] = {"timestamp": ts, "val": a["cols"]["val"]}
    thr = {"none": 1000, "some": 500, "all": 0}[keep]
    return a, np.uint64(thr), live & (ts > thr)
