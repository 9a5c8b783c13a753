"""Ledgers and create_accounts batches that set the traps of K7's split
form (``csrc/sequential.cu``, seqa_*: a pre-pass over the table as it was
before the batch, marks, a sequencer over the marked events): every way a
pre-batch answer can go stale while the batch runs, and every code.

``case(name, n)`` returns a dict: ``ledger`` (on the CPU), ``batch`` (an
accounts array), ``count``, ``lanes``, ``ts`` and ``overflow`` (whether an
insert's probe reaches MAX_PROBE).  ``n`` sets the batch's events for the
cases that scale (``SIZED``); the others have their own.

- ``new_distinct``: n new distinct ids into a table a quarter full (the
  sequential path's shape; the sequencer decides only the ids whose first
  empty slot another shares).
- ``one_home``: ids forced to one home window over a stored cluster with
  tombstones in it, a linked chain there rolled back mid-window and its
  ids inserted again past the batch's own inserts and tombstones.
- ``repeats``: an id repeated after an insert that stands (21, and each of
  15-20) and after one rolled back (inserted again), in and out of chains.
- ``chains``: a chain that fails at its last event, one that fails in the
  middle, one left open at ``count - 1`` (the lane at ``count`` then gets 1).
- ``codes``: each of codes 3-21.
- ``spill``: a collision's walk that passes the first empty slot of an
  earlier unmarked event (taken) and lands on that of a later one (which
  the sequencer then marks), over tombstones.
- ``cascade``: one collision whose walk lands on the next event's first
  empty slot, whose walk lands on the next's, 60 times: every event is
  marked by a walk (more than the card's on-chip overlay was sized for by
  the two static marks, so the card hands the rest to its serial loop).
- ``wrap``: clusters that wrap at the table's last slot.
- ``probe_cap``: a table whose free slots are tombstones but for three:
  three inserts find them, the next reach MAX_PROBE and write slot 0 (the
  overflow flag); a chain and repeats run on serially from there.
- ``beyond_count``: live-looking events past ``count`` (ignored).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .. import convert, types
from ..types import AccountFlags as AF
from ..utils.benchgen import mix64_np

CASES = ("new_distinct", "one_home", "repeats", "chains", "codes", "spill",
         "cascade", "wrap", "probe_cap", "beyond_count")
SIZED = ("new_distinct",)
SIZES = (1, 8190, 16384)
L = int(AF.LINKED)
LANES = 64
CAPS = (1 << 8, 1 << 8, 1 << 8, 1 << 8)  # accounts, transfers, posted, history
TS = 10 ** 12


def _acc(id, flags=0, ledger=1, code=10, **kw):
    return types.account(id=id, ledger=ledger, code=code, flags=flags, **kw)


def ids_by_home(cap: int, start: int = 1 << 20, span: int = 1 << 20):
    """Candidate ids (hi 0) from ``start`` and their homes in ``cap``."""
    cand = np.arange(start, start + span, dtype=np.uint64)
    return cand, (mix64_np(cand, 0) & np.uint64(cap - 1)).astype(np.int64)


class Homes:
    """Distinct ids with chosen homes, never one twice."""

    def __init__(self, cap: int, start: int = 1 << 20):
        self.cand, self.home = ids_by_home(cap, start)
        self.used = np.zeros(len(self.cand), bool)

    def at(self, home: int, k: int = 1) -> List[int]:
        idx = np.flatnonzero((self.home == home) & ~self.used)[:k]
        assert len(idx) == k, "too few candidates"
        self.used[idx] = True
        return [int(i) for i in self.cand[idx]]


def _ledger(acc_cap: int, stored=(), tombs=()):
    """A CPU ledger whose accounts table holds ``stored`` (account rows,
    made by the plain serial K7) and then tombstones at the slots of the
    ids in ``tombs`` (stored ids, removed)."""
    from ..ops import hash_table as ht
    from ..ops import scan_path as sp
    from ..ops import state_machine as sm

    import torch

    led = sm.make_ledger(acc_cap, *CAPS[1:], device="cpu")
    if len(stored):
        rows = types.accounts_array(list(stored))
        sp.create_accounts_seq_plain(
            led, convert.batch_to_tensors(rows, len(rows), "cpu"), len(rows), TS)
    if len(tombs):
        lo = torch.tensor(np.asarray(tombs, np.uint64).view(np.int64))
        look = ht.lookup_plain(led.accounts, lo, torch.zeros_like(lo), 1 << 12, 0,
                               len(tombs), ())
        assert bool(look.found.all())
        ht.remove_to_tombstone_plain(led.accounts, look.slot, look.found)
    return led


def _new_distinct(n: int):
    cap = 1 << 16 if n > 4096 else max(1 << 10, 1 << (8 * n - 1).bit_length())
    rng = np.random.default_rng(n)
    ids = np.unique(rng.integers(1, 1 << 62, 2 * n + cap // 4, dtype=np.uint64))
    rng.shuffle(ids)
    stored = [_acc(int(i), user_data_64=7) for i in ids[n:n + cap // 4]]
    led = _ledger(cap, stored, [int(i) for i in ids[n:n + cap // 4:16]])
    batch = [_acc(int(i), user_data_64=int(k), flags=int(AF.HISTORY) * (k % 3 == 0))
             for k, i in enumerate(ids[:n])]
    return led, batch, n, n


def _one_home(_n: int):
    cap = CAPS[0]
    h = Homes(cap)
    home = 37
    stored_ids = h.at(home, 6) + h.at(home + 2, 2)
    led = _ledger(cap, [_acc(i) for i in stored_ids], stored_ids[1:4:2])
    new = h.at(home, 30)
    batch = [_acc(new[0]), _acc(new[1])]
    batch += [_acc(new[2], flags=L), _acc(new[3], flags=L), _acc(new[4], flags=L),
              _acc(new[5], ledger=0)]  # rolled back mid-window
    batch += [_acc(i) for i in new[6:20]]
    batch += [_acc(new[3]), _acc(new[2]), _acc(new[3])]  # re-used; then exists
    batch += [_acc(stored_ids[0]), _acc(stored_ids[1])]  # stored; tombstoned
    batch += [_acc(i) for i in new[20:30]] + [_acc(new[10], code=11)]
    return led, batch, len(batch), LANES


def _repeats(_n: int):
    cap = CAPS[0]
    h = Homes(cap, start=1 << 30)
    a, b, c, d = (h.at(k)[0] for k in (5, 5, 9, 200))
    batch = [
        _acc(a, user_data_64=3, user_data_32=4, user_data_128=5),
        _acc(a, user_data_64=3, user_data_32=4, user_data_128=5),  # 21
        _acc(a, flags=int(AF.HISTORY), user_data_64=3, user_data_32=4,
             user_data_128=5),  # 15
        _acc(a, user_data_64=3, user_data_32=4, user_data_128=6),  # 16
        _acc(a, user_data_64=2, user_data_32=4, user_data_128=5),  # 17
        _acc(a, user_data_64=3, user_data_32=1, user_data_128=5),  # 18
        _acc(a, ledger=2, user_data_64=3, user_data_32=4, user_data_128=5),  # 19
        _acc(a, code=2, user_data_64=3, user_data_32=4, user_data_128=5),  # 20
        _acc(b, flags=L), _acc(c, flags=L), _acc(d, ledger=0),  # rolled back
        _acc(b), _acc(b), _acc(c, flags=L), _acc(c),  # again; exists in a chain
        _acc(d, flags=L), _acc(b, flags=L), _acc(a),  # a chain failing on 21
        _acc(d),  # d's insert rolled back: it inserts again
    ]
    return _ledger(cap), batch, len(batch), LANES


def _chains(_n: int):
    cap = CAPS[0]
    h = Homes(cap, start=1 << 31)
    ids = [h.at(k)[0] for k in range(100, 130)]
    batch = [_acc(ids[0], flags=L), _acc(ids[1], flags=L), _acc(ids[2], ledger=0)]
    batch += [_acc(ids[3]), _acc(ids[4], flags=L), _acc(ids[5], flags=L, code=0),
              _acc(ids[6], flags=L), _acc(ids[7])]  # fails in the middle
    batch += [_acc(ids[8], flags=L), _acc(ids[9])]  # a chain that holds
    batch += [_acc(ids[0]), _acc(ids[2])]  # rolled back before: inserted now
    batch += [_acc(ids[10], flags=L), _acc(ids[11], flags=L)]  # open at count-1
    lanes = len(batch) + 3
    # Past count: a linked event and one more (codes 1 and 0, no inserts).
    batch += [_acc(ids[12], flags=L), _acc(ids[13])]
    return _ledger(cap), batch, len(batch) - 2, lanes


def _codes(_n: int):
    cap = CAPS[0]
    h = Homes(cap, start=1 << 32)
    s = [h.at(k)[0] for k in range(10, 17)]
    stored = [_acc(i, user_data_64=1, user_data_32=2, user_data_128=3) for i in s]
    led = _ledger(cap, stored)
    same = dict(user_data_64=1, user_data_32=2, user_data_128=3)
    x = h.at(60)[0]
    batch = [
        _acc(x, timestamp=5),  # 3
        _acc(x, reserved=1),  # 4
        _acc(x, flags=0x10),  # 5
        _acc(0),  # 6
        _acc((1 << 128) - 1),  # 7
        _acc(x, flags=int(AF.DEBITS_MUST_NOT_EXCEED_CREDITS
                          | AF.CREDITS_MUST_NOT_EXCEED_DEBITS)),  # 8
        _acc(x, debits_pending=1), _acc(x, debits_posted=1 << 64),  # 9, 10
        _acc(x, credits_pending=1 << 100), _acc(x, credits_posted=2),  # 11, 12
        _acc(x, ledger=0), _acc(x, code=0),  # 13, 14
        _acc(s[0], flags=int(AF.HISTORY), **same),  # 15
        _acc(s[1], user_data_64=1, user_data_32=2, user_data_128=4),  # 16
        _acc(s[2], user_data_64=9, user_data_32=2, user_data_128=3),  # 17
        _acc(s[3], user_data_64=1, user_data_32=9, user_data_128=3),  # 18
        _acc(s[4], ledger=3, **same),  # 19
        _acc(s[5], code=3, **same),  # 20
        _acc(s[6], **same),  # 21
        _acc(x),  # 0
    ]
    return led, batch, len(batch), LANES


def _spill(_n: int):
    cap = CAPS[0]
    h = Homes(cap, start=1 << 33)
    base = 70
    stored = h.at(base + 3) + h.at(base + 5)
    led = _ledger(cap, [_acc(i) for i in stored], stored[:1])  # tomb at 73
    u = h.at(base + 1)[0]  # unmarked, before the collision: takes 71
    a, b, c = h.at(base, 3)  # 70, then walk: 71 (u's), 72, ...
    v = h.at(base + 2)[0]  # unmarked, after: its F (72) is taken first
    w = h.at(base + 6)[0]
    batch = [_acc(u), _acc(a), _acc(b), _acc(c), _acc(v), _acc(w),
             _acc(b)]  # b's repeat walks to b's slot: exists
    return led, batch, len(batch), LANES


def _cascade(_n: int):
    cap = CAPS[0]
    h = Homes(cap, start=1 << 37)
    base = 100
    batch = [_acc(i) for i in h.at(base, 2)]
    batch += [_acc(h.at(base + k)[0]) for k in range(1, 61)]
    return _ledger(cap), batch, len(batch), LANES


def _wrap(_n: int):
    cap = CAPS[0]
    h = Homes(cap, start=1 << 34)
    stored = h.at(cap - 2, 2) + h.at(0)
    led = _ledger(cap, [_acc(i) for i in stored], stored[1:2])
    new = h.at(cap - 1, 4) + h.at(cap - 2, 2) + h.at(1, 2)
    batch = [_acc(i) for i in new] + [_acc(stored[0]), _acc(new[0], flags=L),
                                      _acc(h.at(2)[0], ledger=0)]
    return led, batch, len(batch), LANES


def _probe_cap(_n: int):
    import torch

    cap = CAPS[0]
    h = Homes(cap, start=1 << 35)
    led = _ledger(cap)
    acc = led.accounts
    acc.tombstone[:] = True
    for s in (17, 130, 200):
        acc.tombstone[s] = False
    acc.count.fill_(0)
    ids = [h.at(k)[0] for k in range(40, 60)]
    batch = [_acc(ids[0]), _acc(ids[1]), _acc(ids[2], flags=L), _acc(ids[3], flags=L),
             _acc(ids[4]),  # the chain's capped inserts, then one more
             _acc(ids[0]), _acc(ids[5], flags=L), _acc(ids[6], ledger=0),
             _acc(ids[7]), _acc(ids[7]), _acc(ids[8])]
    assert int(torch.count_nonzero(~acc.tombstone)) == 3
    return led, batch, len(batch), LANES


def _beyond_count(_n: int):
    cap = CAPS[0]
    h = Homes(cap, start=1 << 36)
    ids = [h.at(k)[0] for k in range(150, 170)]
    batch = [_acc(i) for i in ids[:6]] + [_acc(ids[6], flags=L)] + \
        [_acc(i, flags=L) for i in ids[7:12]] + [_acc(ids[0])]
    return _ledger(cap), batch, 7, LANES


_BUILD = {"new_distinct": _new_distinct, "one_home": _one_home,
          "repeats": _repeats, "chains": _chains, "codes": _codes,
          "spill": _spill, "cascade": _cascade, "wrap": _wrap, "probe_cap": _probe_cap,
          "beyond_count": _beyond_count}


def case(name: str, n: int = LANES) -> Dict:
    led, batch, count, lanes = _BUILD[name](n)
    return {"ledger": led, "batch": types.accounts_array(batch), "count": count,
            "lanes": lanes, "ts": 5 * TS, "overflow": name == "probe_cap"}


def trap_facts(name: str) -> Dict:
    """What the split form's pre-pass and sequencer make of case ``name``
    (``new_distinct`` at 512 events), and whether it reaches its trap."""
    import torch

    from ..ops import scan_path as sp

    c = case(name, 512)
    padded = np.zeros(c["lanes"], dtype=c["batch"].dtype)
    padded[:len(c["batch"])] = c["batch"]
    soa = convert.soa_to_tensors(types.to_soa(padded), "cpu")
    pre = sp.seqa_prepass_plain(c["ledger"], soa, c["count"])
    static = pre["marks"].copy()
    seq = sp.seqa_sequencer_plain(c["ledger"], c["count"], pre)
    dec = seq["dec"]
    bits = pre["bits"]
    _, codes, _ = sp.create_accounts_seq_split_plain(c["ledger"], soa, c["count"],
                                                     c["ts"])
    codes = codes.tolist()
    n, count = c["lanes"], c["count"]
    facts = {
        "marked_static": int(static.sum()),
        "marked_by_walks": int((pre["marks"] & ~static).sum()),
        "serial_from": seq["from"],
        "rolled_back": sum(1 for d in dec.values() if d[2] is not None and not d[3]),
        "exists_in_batch": sum(1 for e, d in dec.items()
                               if 15 <= d[0] <= 21 and not bits[e] & sp.AR_FOUND),
        "wrapped": sum(1 for e, d in dec.items()
                       if d[2] is not None and d[2] < pre["home"][e]),
        "lane_past_count": codes[count] if count < n else None,
        "codes": sorted(set(codes[:count])),
    }
    reached = {
        "new_distinct": 0 < facts["marked_static"] < count,
        "one_home": facts["rolled_back"] > 0 and facts["exists_in_batch"] > 0,
        "repeats": facts["rolled_back"] > 0 and facts["exists_in_batch"] >= 7,
        "chains": facts["rolled_back"] > 0 and facts["lane_past_count"] == 1,
        "codes": facts["codes"] == [0] + list(range(3, 22)),
        "spill": facts["marked_by_walks"] > 0 and facts["exists_in_batch"] > 0,
        "cascade": facts["marked_by_walks"] >= 60,
        "wrap": facts["wrapped"] > 0,
        "probe_cap": facts["serial_from"] < n,
        "beyond_count": facts["lane_past_count"] == 1,
    }[name]
    return dict(facts, reached=bool(reached))
