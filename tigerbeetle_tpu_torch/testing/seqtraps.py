"""Batches that set the traps of K6's split form: every way a pre-batch
answer of K32 (the parallel pre-pass) can go stale while the sequencer
walks the batch.  Each case is a ledger and one create_transfers batch of
any width, made from the case's name alone:

- ``cluster_reuse``: ids sharing one home slot of the transfers table.
  Earlier events of the batch fill each cluster, a linked chain's inserts
  there are rolled back (tombstones mid-cluster) and their ids inserted
  again later, pushed past the batch's own inserts and tombstones; the
  re-used ids are then found (exists codes), and a pending id re-inserted
  after its rollback is posted from the row the table holds.
- ``posted_collisions``: pendings made and posted in the batch whose
  posted key (their own timestamp) is stored before the batch (codes 33 and
  34), others whose key shares its home with stored posted rows (the posted
  insert pushed along), a pending whose id group's first event failed, and
  a balancing pending whose clamped amount a later post reads back.
- ``join_collisions``: groups of ids whose hashes agree in their low 15
  bits, so that in K32's id join (at most 2^15 entries) each group's ids
  share one home and one chain, and every find there walks past the
  group's other keys: a pending of the batch posted and voided by id, a
  repeat (exists), a linked chain rolled back and its id re-used, a
  pending voided and then posted.
- ``probe_cap``: runs of tombstones longer than MAX_PROBE in the transfers
  and posted tables, so that the inserts whose probes start there reach
  MAX_PROBE and write at slot 0 (overflow set); the rest of the batch
  follows the tables as those writes left them.

The ledgers are made with the plain versions on the CPU; ``trap_case``
returns them on the device asked for.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .. import convert, types
from ..types import TransferFlags as F
from ..utils.benchgen import mix64_np

TRAPS = ("cluster_reuse", "posted_collisions", "join_collisions", "probe_cap")
L = int(F.LINKED)
PENDING = int(F.PENDING)
POST = int(F.POST_PENDING_TRANSFER)
VOID = int(F.VOID_PENDING_TRANSFER)
N_ACCOUNTS = 64
CAPS = (1 << 12, 1 << 16, 1 << 14, 1 << 14)  # accounts, transfers, posted, history


def same_home_groups(cap: int, groups: int, size: int, start: int = 1):
    """``groups`` lists of ``size`` keys (lo; hi 0), each list sharing one
    home slot of a table of ``cap`` slots, every key at least ``start``."""
    cand = np.uint64(start) + np.arange(0, 1 << 22, dtype=np.uint64)
    homes = mix64_np(cand, 0) & np.uint64(cap - 1)
    order = np.argsort(homes, kind="stable")
    h = homes[order]
    starts = np.flatnonzero(np.r_[True, h[1:] != h[:-1]])
    sizes = np.diff(np.r_[starts, len(h)])
    pick = starts[sizes >= size]
    if len(pick) < groups:
        raise ValueError("not enough same-home keys")
    pick = pick[::len(pick) // groups][:groups]  # homes spread over the table
    return [[int(k) for k in cand[order[s:s + size]]] for s in pick]


def _t(id, dr=1, cr=2, amount=10, flags=0, pending_id=0, ledger=1, code=10):
    return types.transfer(id=id, debit_account_id=dr, credit_account_id=cr,
                          amount=amount, flags=flags, pending_id=pending_id,
                          ledger=ledger, code=code)


def _pv(id, pending_id, flags, amount=0):
    return types.transfer(id=id, pending_id=pending_id, flags=flags,
                          amount=amount)


def _base_ledger():
    """Accounts 1..N_ACCOUNTS (ledger 1), account 1 funded with credits and
    one pending transfer, made with the plain versions on the CPU."""
    from ..ops import scan_path as sp
    from ..ops import state_machine as sm

    led = sm.make_ledger(*CAPS, device="cpu")
    acc = types.accounts_array([types.account(id=i, ledger=1, code=10)
                                for i in range(1, N_ACCOUNTS + 1)])
    sp.create_accounts_seq(led, convert.batch_to_tensors(acc, len(acc), "cpu"),
                           len(acc), 10 ** 9)
    # Credits for account 1 (the balancing pendings' debit account) and a
    # pending transfer stored before the batch.
    pre = types.transfers_array([_t(1 << 60, dr=3, cr=1, amount=1 << 62),
                                 _t(1 << 61, dr=4, cr=5, flags=PENDING)])
    sp.create_transfers_seq(led, convert.batch_to_tensors(pre, 2, "cpu"), 2,
                            2 * 10 ** 9)
    return led


def _cluster_reuse(n: int):
    rows = []
    groups = same_home_groups(CAPS[1], n // 12 + 1, 6, start=1 << 20)
    for g, ids in enumerate(groups):
        a = 1 + g % (N_ACCOUNTS - 2)
        rows += [
            _t(ids[0], dr=a, cr=a + 1, amount=5),
            _t(ids[1], dr=a, cr=a + 1, amount=6, flags=L),
            _t(ids[2], dr=a + 1, cr=a, amount=7, flags=L | PENDING),
            _t(ids[3], dr=a, cr=N_ACCOUNTS + 9, amount=1),  # breaks the chain
            _t(ids[2], dr=a + 1, cr=a, amount=8, flags=PENDING),  # re-used
            _t(ids[4], dr=a, cr=a + 1, amount=9),
            _t(ids[1], dr=a, cr=a + 1, amount=6),  # re-used, pushed along
            _pv(ids[5], ids[2], POST),  # the re-inserted pending
            _t(ids[1], dr=a, cr=a + 1, amount=6),  # exists now
            _t(ids[2], dr=a + 1, cr=a, amount=7, flags=PENDING),  # other amount
            _pv(ids[5], ids[2], POST),  # exists
            _t(ids[0], dr=a, cr=a + 1, amount=5),  # exists
        ]
    return types.transfers_array(rows[:n])


def _join_collisions(n: int):
    rows = []
    for g, ids in enumerate(same_home_groups(1 << 15, n // 12 + 1, 8,
                                             start=1 << 24)):
        a = 1 + g % (N_ACCOUNTS - 2)
        rows += [
            _t(ids[0], dr=a, cr=a + 1, amount=5, flags=PENDING),
            _t(ids[1], dr=a, cr=a + 1, amount=6),
            _pv(ids[2], ids[0], POST),  # a pending of the batch, by id
            _t(ids[1], dr=a, cr=a + 1, amount=6),  # exists
            _t(ids[3], dr=a + 1, cr=a, amount=7, flags=L),
            _t(ids[4], dr=a, cr=N_ACCOUNTS + 9, amount=1),  # breaks the chain
            _t(ids[3], dr=a + 1, cr=a, amount=7),  # re-used after the rollback
            _pv(ids[5], ids[0], VOID),  # already posted
            _t(ids[6], dr=a + 1, cr=a, amount=8, flags=PENDING),
            _pv(ids[7], ids[6], VOID),
            _pv(ids[5], ids[6], POST),  # already voided
            _t(ids[0], dr=a, cr=a + 1, amount=5, flags=PENDING),  # exists
        ]
    return types.transfers_array(rows[:n])


def _posted_collisions(n: int, ts: int):
    """The batch and the posted keys to store before it."""
    ts_base = ts - n + 1
    mask = np.uint64(CAPS[2] - 1)
    pool = np.arange(1, 1 << 20, dtype=np.uint64) * np.uint64(7919)
    pool_homes = mix64_np(pool, 0) & mask
    order = np.argsort(pool_homes, kind="stable")
    sorted_homes = pool_homes[order]
    rows, stored = [], []
    group = 13
    for g in range(n // group + 1):
        o = g * group
        base = (1 << 40) + 100 * g
        a = 2 + g % (N_ACCOUNTS - 3)
        rows += [
            _t(base, dr=a, cr=a + 1, amount=10, flags=PENDING),  # key stored
            _pv(base + 1, base, POST),
            _pv(base + 2, base, VOID),
            _t(base + 3, dr=a + 1, cr=a, amount=11, flags=PENDING),
            _pv(base + 4, base + 3, VOID),  # its key's home is crowded
            _t(base + 5, dr=a, cr=N_ACCOUNTS + 9, amount=1, flags=PENDING),
            _t(base + 5, dr=a, cr=a + 1, amount=12, flags=PENDING),
            _pv(base + 6, base + 5, VOID),  # the group's first event failed
            _pv(base + 7, base + 3, POST),  # already voided
            _t(base + 8, dr=1, cr=a, amount=1 << 50,
               flags=PENDING | int(F.BALANCING_DEBIT)),  # clamped
            _pv(base + 9, base + 8, POST),  # posts the clamped amount
            _t(base + 10, dr=a, cr=a + 1, amount=13, flags=PENDING | L),
            _pv(base + 11, base + 10, VOID),
        ]
        stored.append((ts_base + o, 1 + g % 2))
        crowd_key = np.array([ts_base + o + 3], np.uint64)
        home = (mix64_np(crowd_key, 0) & mask)[0]
        i = int(np.searchsorted(sorted_homes, home))
        stored += [(int(pool[order[j]]), 1) for j in (i, i + 1)
                   if j < len(order) and sorted_homes[j] == home]
    return types.transfers_array(rows[:n]), stored


def _probe_cap(n: int, led):
    """Tombstones over MAX_PROBE + 4,096 slots of the transfers table from
    slot 0, and over as many of the posted table from the home of the stored
    pending's posted key: one event in 256 takes an id whose home is in the
    blocked run of the transfers table (its insert reaches MAX_PROBE), one
    in 512 posts the stored pending (its posted insert reaches it)."""
    import torch

    from ..ops import scan_path as sp

    span = sp.MAX_PROBE + 4096
    for t, start in ((led.transfers, 0),
                     (led.posted, sp._mix64(_pending_ts(led), 0))):
        slots = (start + torch.arange(span)) % t.capacity
        t.tombstone[slots] |= (t.key_lo[slots] == 0) & (t.key_hi[slots] == 0)
    cand = np.arange(1 << 30, (1 << 30) + (1 << 20), dtype=np.uint64)
    homes = mix64_np(cand, 0) & np.uint64(CAPS[1] - 1)
    blocked = cand[homes < np.uint64(4096)]
    free = cand[homes >= np.uint64(span + 64)]
    rows = []
    for i in range(n):
        if i % 512 == 100:
            rows.append(_pv(blocked[i] + np.uint64(1 << 40), 1 << 61, POST))
        elif i % 256 == 7:
            rows.append(_t(int(blocked[i]), amount=5, flags=L if i % 3 else 0))
        else:
            rows.append(_t(int(free[i]), amount=5, flags=L if i % 5 == 1 else 0))
    return types.transfers_array(rows)


def _pending_ts(led) -> int:
    """The timestamp of the pending transfer the base ledger stores."""
    from ..ops import scan_path as sp

    found, slot = sp._slookup(led.transfers, 1 << 61, 0)
    assert found
    return sp._get(led.transfers.cols["timestamp"], slot)


def trap_case(name: str, n: int, device="cpu") -> Dict:
    """The ledger (on ``device``), the batch of ``n`` events, its count and
    timestamp of trap ``name``."""
    import torch

    from ..ops import hash_table as ht

    led = _base_ledger()
    ts = 10 ** 12 + n
    if name == "cluster_reuse":
        batch = _cluster_reuse(n)
    elif name == "posted_collisions":
        batch, stored = _posted_collisions(n, ts)
        keys = np.array([k for k, _v in stored], np.uint64)
        keys, first = np.unique(keys, return_index=True)
        vals = np.array([v for _k, v in stored], np.uint32)[first]
        ht.insert_plain(led.posted, convert.array_to_tensor(keys, "cpu"),
                        torch.zeros(len(keys), dtype=torch.int64),
                        torch.ones(len(keys), dtype=torch.bool),
                        {"fulfillment": convert.array_to_tensor(vals, "cpu")},
                        CAPS[2])
    elif name == "join_collisions":
        batch = _join_collisions(n)
    elif name == "probe_cap":
        batch = _probe_cap(n, led)
    else:
        raise ValueError(f"unknown trap {name!r}")
    led = convert.ledger_from_numpy(convert.ledger_to_numpy(led), device)
    return {"ledger": led, "batch": batch, "count": len(batch), "ts": ts}
