"""Seeded batches that put each batch-wide step of the general kernel's
passes (K11) and of its wave schedule (K12) across the blocks of their
grids, for holding the kernels against their plain versions.

K11 runs one lane a thread over blocks of 64 threads and K12 one sorted leg
a thread over blocks of 1,024, so every trap places its lanes far apart in
the batch (and, at a width of 128 lanes or more, across a multiple of 64):

- ``split_group``: id groups whose lanes sit in different blocks, one
  whose first lane fails (its winner is a later lane) and one with exact
  and differing copies;
- ``cross_chain``: linked chains of plain transfers across a block
  boundary, one failing in its far block, one long one failing near its
  end, one that commits, and one left open at the end of the batch;
- ``cross_pending``: pendings in the first block posted or voided in later
  blocks (full and partial amounts), and a post of a pending made later in
  the batch (not found);
- ``double_postvoid``: a pending of the batch posted, voided and posted
  again from different blocks, and a pending of the table likewise;
- ``deep_hazard``: one debit-limit account on a lane in every 7, a hazard
  chain far deeper than the wave scheduler's rounds (``proved`` false)
  whose sorted legs, over 1,024 of them at 8,190 events, must cross a
  chunk of K12's grid;
- ``unschedulable``: shallow hazards and one id repeated across blocks
  (the schedule cannot be proved whatever its depth).

Fillers are plain transfers between accounts without limits.  A batch
width that is not a multiple of the block size is the caller's (the lanes
it pads to).  Everything is drawn from the mix's generator.

``trap_facts`` checks that a batch reaches its trap's condition on a
ledger (at 8,190 events: at narrow widths the blocks and chunks are too
few), so that a trap cannot decay into an easy batch unnoticed.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import convert, types
from ..types import AccountFlags as AF, TransferFlags as F
from .fullmix import GeneralMix
from .seqmix import account_flags

PASS_BLOCK = 64  # K11's lanes a block (PASS_THREADS in csrc/full_pass.cu)
WAVE_CHUNK = 1024  # K12's sorted legs a block (WAVE_CHUNK, csrc/full_waves.cu)

TRAPS = ("split_group", "cross_chain", "cross_pending", "double_postvoid",
         "deep_hazard", "unschedulable")


def _row(mix: GeneralMix, accounts=None, **kw):
    rows: list = []
    mix._plain(rows, accounts or mix.free, **kw)
    return rows[0]


def _pv(mix: GeneralMix, pending_id: int, post: bool, amount: int = 0):
    flag = F.POST_PENDING_TRANSFER if post else F.VOID_PENDING_TRANSFER
    return types.transfers_array([types.transfer(
        id=mix._id(), pending_id=pending_id, amount=amount,
        flags=int(flag))])[0]


def _lane(count: int, frac: float, off: int = 0) -> int:
    return min(count - 1, max(0, int(count * frac) + off))


def trap_batch(mix: GeneralMix, kind: str, count: int) -> np.ndarray:
    """``count`` events (at least 32) of trap ``kind`` (one of ``TRAPS``)."""
    if count < 32:
        raise ValueError("a trap batch needs at least 32 events")
    rows: List = [_row(mix) for _ in range(count)]
    wide = count >= 256  # room for the fixed lanes around 64

    if kind == "split_group":
        a = [3, count // 3, 2 * count // 3 + 1, count - 2]
        rows[a[0]] = _row(mix)
        rows[a[1]] = rows[a[0]].copy()  # exists (46)
        rows[a[2]] = rows[a[0]].copy()
        rows[a[2]]["amount_lo"] += 1  # exists with another amount (39)
        rows[a[3]] = rows[a[0]].copy()
        rows[a[3]]["code"] += 1  # exists with another code (45)
        b = [10, count // 2, count - 5]
        rows[b[1]] = _row(mix)
        rows[b[0]] = rows[b[1]].copy()
        rows[b[0]]["ledger"] = 0  # fails: the group's winner is lane b[1]
        rows[b[2]] = rows[b[1]].copy()
    elif kind == "cross_chain":
        chains = [(60, 70, 68) if wide else (count // 8, count // 8 + 6,
                                             count // 8 + 5),
                  (count // 4, count // 4 + count // 8, count // 4 + count // 8 - 2),
                  (2 * count // 3, 2 * count // 3 + count // 20 + 2, None)]
        for lo, hi, fail in chains:
            for k in range(lo, hi - 1):
                rows[k]["flags"] |= int(F.LINKED)
            if fail is not None:
                rows[fail]["credit_account_id_lo"] = rows[fail]["debit_account_id_lo"]
        for k in range(count - 6, count):  # open at the end of the batch
            rows[k]["flags"] |= int(F.LINKED)
    elif kind == "cross_pending":
        made = {}
        for lane in (10, 20, 30, count // 2):
            rows[lane] = _row(mix, flags=int(F.PENDING), timeout=0)
            made[lane] = int(rows[lane]["id_lo"])
        rows[_lane(count, 5 / 8)] = _pv(mix, made[10], True)
        rows[_lane(count, 7 / 8)] = _pv(mix, made[20], False)
        rows[64 if wide else 40] = _pv(mix, made[30], True, amount=1)
        rows[100 if wide else 45] = _pv(mix, made[count // 2], True)
    elif kind == "double_postvoid":
        rows[15] = _row(mix, flags=int(F.PENDING), timeout=0)
        p = int(rows[15]["id_lo"])
        rows[_lane(count, 1 / 4)] = _pv(mix, p, True)
        rows[_lane(count, 3 / 4)] = _pv(mix, p, False)  # already posted (33)
        rows[count - 3] = _pv(mix, p, True)
        if mix.pool:
            q = int(mix.pool[0])
            rows[_lane(count, 1 / 8, 1)] = _pv(mix, q, True)
            rows[_lane(count, 1 / 2, 1)] = _pv(mix, q, False)
            rows[count - 10] = _pv(mix, q, True)
    elif kind == "deep_hazard":
        lim = [a for a in mix.limit
               if account_flags(a) & AF.DEBITS_MUST_NOT_EXCEED_CREDITS]
        for k in range(5, count, 7):
            rows[k] = _row(mix, amount=1)
            rows[k]["debit_account_id_lo"] = lim[0]
            rows[k]["credit_account_id_lo"] = mix.free[0]
    elif kind == "unschedulable":
        for k, a in enumerate(mix.limit[:5]):
            lane = _lane(count, (k + 1) / 7)
            rows[lane] = _row(mix, amount=1)
            rows[lane]["debit_account_id_lo"] = a
        rows[count - 7] = rows[7].copy()  # a duplicate id across blocks
    else:
        raise ValueError(f"unknown trap {kind!r}")
    return np.array(rows, dtype=rows[0].dtype)


def _blocks_apart(lanes) -> bool:
    lanes = np.asarray(lanes)
    return len(lanes) > 1 and (lanes.min() // PASS_BLOCK
                               != lanes.max() // PASS_BLOCK)


def trap_facts(kind: str, ledger, batch: np.ndarray, count: int,
               codes) -> dict:
    """Checks that ``batch`` (``count`` events of trap ``kind``, ``codes``
    the plain kernel's answer on ``ledger``) reaches its trap's condition
    across the kernels' blocks; raises AssertionError if it does not.
    Returns what was found."""
    from ..ops import transfer_full as tf

    rows = batch[:count]
    codes = np.asarray(codes)[:count]
    lanes = np.arange(count)
    flags = rows["flags"].astype(np.int64)
    ids = list(zip(rows["id_lo"].tolist(), rows["id_hi"].tolist()))
    facts: dict = {}
    if kind == "split_group":
        groups: dict = {}
        for lane, key in enumerate(ids):
            groups.setdefault(key, []).append(lane)
        split = [g for g in groups.values() if _blocks_apart(g)]
        facts["split_groups"] = len(split)
        facts["split_group_first_lane_fails"] = any(codes[g[0]] != 0
                                                    for g in split)
        ok = split and facts["split_group_first_lane_fails"]
    elif kind == "cross_chain":
        linked = (flags & int(F.LINKED)) != 0
        far_fails = 0
        lo = 0
        for lane in range(count):
            if linked[lane] and lane < count - 1:
                continue
            chain = lanes[lo:lane + 1]
            lo = lane + 1
            if len(chain) < 2:
                continue
            own = chain[(codes[chain] != 0) & (codes[chain] != 1)]
            far_fails += int(any(f // PASS_BLOCK != chain[0] // PASS_BLOCK
                                 for f in own))
        facts["chains_failing_in_a_far_block"] = far_fails
        ok = far_fails > 0
    elif kind in ("cross_pending", "double_postvoid"):
        pv = (flags & int(F.POST_PENDING_TRANSFER | F.VOID_PENDING_TRANSFER)) != 0
        refs: dict = {}
        for lane in lanes[pv]:
            refs.setdefault((int(rows["pending_id_lo"][lane]),
                             int(rows["pending_id_hi"][lane])), []).append(lane)
        if kind == "cross_pending":
            made = {key: lane for lane, key in enumerate(ids)
                    if flags[lane] & int(F.PENDING)}
            n = sum(1 for key, pvs in refs.items() if key in made
                    and any(_blocks_apart([made[key], p]) for p in pvs))
            facts["pendings_posted_from_another_block"] = n
        else:
            n = sum(1 for pvs in refs.values() if _blocks_apart(pvs))
            facts["pendings_posted_twice_from_two_blocks"] = n
        ok = n > 0
    elif kind in ("deep_hazard", "unschedulable"):
        n = len(batch)
        soa = convert.soa_to_tensors(types.to_soa(batch), ledger.device)
        valid = torch.arange(n, device=soa["id_lo"].device) < count
        postvoid = ((soa["flags"] & (tf.TF_POST | tf.TF_VOID)) != 0) & valid
        ctx = tf.build_gather_ctx(ledger, soa, valid, postvoid)
        idx = tf._build_id_index_plain(soa["id_lo"], soa["id_hi"],
                                       soa["pending_id_lo"],
                                       soa["pending_id_hi"])
        waves = [w.cpu() for w in tf._wave_inputs(ctx, soa, count, True, idx)]
        cap = ctx.accounts_capacity
        proved, needed, _, _ = tf._wave_schedule_plain(
            *waves, valid.cpu(), cap, tf._MAX_PASSES)
        hazard, unsched = waves[0].numpy(), bool(waves[1])
        facts.update(proved=bool(proved), unschedulable=unsched,
                     passes_needed=int(needed))
        if kind == "unschedulable":
            ok = unsched and not bool(proved)
        else:
            # The legs sorted by (slot, leg position), as K12 sorts them;
            # the hazard legs of one slot must span two chunks.
            slot = np.stack([waves[2].numpy(), waves[4].numpy()], 1).ravel()
            live = np.stack([waves[3].numpy(), waves[5].numpy()], 1).ravel()
            slot = np.where(live, slot, cap)
            pos = np.empty(2 * n, np.int64)
            pos[np.lexsort((np.arange(2 * n), slot))] = np.arange(2 * n)
            legs = np.repeat(hazard, 2) & live
            spans = [np.unique(pos[legs & (slot == s)] // WAVE_CHUNK).size
                     for s in np.unique(slot[legs])]
            facts["hazard_runs_across_chunks"] = sum(k > 1 for k in spans)
            ok = (not unsched and not bool(proved)
                  and facts["hazard_runs_across_chunks"] > 0)
    else:
        raise ValueError(f"unknown trap {kind!r}")
    if not ok:
        raise AssertionError(f"trap {kind} does not reach its condition: "
                             f"{facts}")
    return facts
