"""Ledgers, batches and Bloom filters that set the traps of K17's test as a
step of K1's launch (``csrc/probe.cu``'s flag word: a lane under a cold
lookup's mask, below its count, not found and not certified tests its own
key; a warp ORs its lanes' bits into the word with one atomic).

``case(name)`` returns a dict: ``ledger`` (a function of a device: the
port's ledger, its tables filled by the plain insert), ``batch`` (a
TRANSFER_DTYPE array of ``LANES`` lanes), ``count``, ``has_postvoid``,
``checked`` (bool[LANES] or None), ``bloom`` (u32 words) and ``cold``,
whether the general kernel's FLAG_COLD must be set.  ``inputs(c, dev)``
gives ``build_gather_ctx``'s arguments.

- ``id_zero``: a valid lane whose id is 0 (not found: K1 is done at once
  on key 0) and 0 in the filter: FLAG_COLD.
- ``above_count``: every lane at and above ``count`` holds a filtered id;
  none below: no flag.
- ``found_in_filter``: ids found in the hot table whose four bits are
  set: no flag.
- ``no_postvoid``: ``has_postvoid`` False with filtered pending ids on
  lanes that neither post nor void: no pending id is tested.
- ``checked_none``: one filtered new id and ``checked`` None (no lane
  certified): FLAG_COLD.
- ``checked_all_hits``: the filtered lanes all certified: no flag.
- ``checked_but_one``: all certified but one: FLAG_COLD.
- ``last_lane``: the only filtered id on the last lane of the last block
  (a warp that is partly past the lanes).
- ``pending_only``: no id filtered; one post's pending id filtered and not
  in the hot table: FLAG_COLD from the pending chain alone.
- ``pending_found``: a post's pending id filtered and found hot: no flag.
- ``mixed``: the tiered traffic in small: new ids, resubmitted evicted ids,
  hot and evicted pendings posted and voided.
"""

from __future__ import annotations

import zlib
from typing import Dict

import numpy as np
import torch

from .. import convert, types
from ..ops import cold, hash_table as ht, state_machine as sm
from ..types import TransferFlags as F

CASES = ("id_zero", "above_count", "found_in_filter", "no_postvoid",
         "checked_none", "checked_all_hits", "checked_but_one", "last_lane",
         "pending_only", "pending_found", "mixed")
LANES = 300  # three blocks of K1's 128 threads, the last one partly used
N_ACCOUNTS = 20
HOT = 200  # hot transfers (ids FIRST..), every 4th a pending
COLD_IDS = 400  # evicted ids (ids EVICTED..), all in the filter
FIRST = 1 << 20
EVICTED = 1 << 30
NEW = 1 << 40
BLOOM_LOG2 = 16
CAPS = (1 << 6, 1 << 9, 1 << 6)  # accounts, transfers, posted


def _ledger(dev) -> sm.Ledger:
    led = sm.make_ledger(*CAPS, history_capacity=1 << 4, device=dev)
    ids = torch.arange(1, N_ACCOUNTS + 1, dtype=torch.int64, device=dev)
    rows = {c: torch.zeros(N_ACCOUNTS, dtype=dt, device=dev)
            for c, dt in sm.ACCOUNT_COLS.items()}
    rows["ledger"].fill_(1)
    rows["code"].fill_(10)
    rows["timestamp"] = ids
    ones = torch.ones(N_ACCOUNTS, dtype=torch.bool, device=dev)
    ht.insert(led.accounts, ids, torch.zeros_like(ids), ones, rows, sm.MAX_PROBE)
    hot = FIRST + torch.arange(HOT, dtype=torch.int64, device=dev)
    rows = {c: torch.zeros(HOT, dtype=dt, device=dev)
            for c, dt in sm.TRANSFER_COLS.items()}
    rows["debit_account_id_lo"] = hot % N_ACCOUNTS + 1
    rows["credit_account_id_lo"] = (hot + 3) % N_ACCOUNTS + 1
    rows["amount_lo"] = hot % 97 + 1
    rows["ledger"].fill_(1)
    rows["code"].fill_(10)
    rows["flags"] = torch.where(hot % 4 == 0, int(F.PENDING), 0).to(torch.int32)
    rows["timestamp"] = 1000 + hot
    ones = torch.ones(HOT, dtype=torch.bool, device=dev)
    ht.insert(led.transfers, hot, torch.zeros_like(hot), ones, rows,
              sm.MAX_PROBE)
    return led


def _bloom(extra=()) -> np.ndarray:
    words = np.zeros((1 << BLOOM_LOG2) // 32, np.uint32)
    ids = np.concatenate([EVICTED + np.arange(COLD_IDS, dtype=np.uint64),
                          np.asarray(extra, np.uint64)])
    cold.bloom_add_host(words, ids, np.zeros_like(ids))
    return words


def _batch(rng, count: int) -> np.ndarray:
    b = np.zeros(LANES, dtype=types.TRANSFER_DTYPE)
    b["id_lo"][:count] = NEW + np.arange(count)
    b["debit_account_id_lo"][:count] = rng.integers(1, N_ACCOUNTS + 1, count)
    b["credit_account_id_lo"][:count] = (
        b["debit_account_id_lo"][:count] % N_ACCOUNTS + 1)
    b["amount_lo"][:count] = rng.integers(1, 100, count)
    b["ledger"][:count], b["code"][:count] = 1, 10
    return b


def _post(b, lane: int, pending_id: int, void: bool = False) -> None:
    b["flags"][lane] = int(F.VOID_PENDING_TRANSFER if void
                           else F.POST_PENDING_TRANSFER)
    b["pending_id_lo"][lane] = pending_id
    b["amount_lo"][lane] = 0


def case(name: str) -> Dict:
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    count, has_pv, checked, extra = LANES - 4, False, None, ()
    b = _batch(rng, count)
    cold_flag = False
    if name == "id_zero":
        b["id_lo"][5] = 0
        extra, cold_flag = (0,), True
    elif name == "above_count":
        count = 200
        b["id_lo"][count:] = EVICTED + np.arange(LANES - count)
    elif name == "found_in_filter":
        lanes = rng.choice(count, 40, replace=False)
        b["id_lo"][lanes] = FIRST + rng.choice(HOT, 40, replace=False)
        extra = b["id_lo"][lanes]
    elif name == "no_postvoid":
        b["pending_id_lo"][:count] = EVICTED + np.arange(count)
    elif name == "checked_none":
        b["id_lo"][77] = EVICTED + 5
        cold_flag = True
    elif name in ("checked_all_hits", "checked_but_one"):
        lanes = rng.choice(count, 30, replace=False)
        b["id_lo"][lanes] = EVICTED + np.arange(30)
        checked = np.zeros(LANES, bool)
        checked[lanes] = True
        checked[rng.random(LANES) < 0.3] = True
        if name == "checked_but_one":
            checked[lanes[7]] = False
            cold_flag = True
    elif name == "last_lane":
        count = LANES
        b = _batch(rng, count)
        b["id_lo"][LANES - 1] = EVICTED + 9
        cold_flag = True
    elif name in ("pending_only", "pending_found"):
        has_pv = True
        pend = FIRST + 4 * np.arange(20)
        for j, lane in enumerate(range(0, 40, 2)):
            _post(b, lane, int(pend[j]), void=j % 2 == 1)
        if name == "pending_only":
            _post(b, 101, EVICTED + 3)
            cold_flag = True
        else:
            extra = pend
    elif name == "mixed":
        has_pv = True
        back = rng.choice(count, 16, replace=False)
        b["id_lo"][back] = EVICTED + rng.choice(COLD_IDS, 16, replace=False)
        for j, lane in enumerate(range(1, count, 5)):
            pid = (FIRST + 4 * rng.integers(0, HOT // 4) if j % 3
                   else EVICTED + rng.integers(0, COLD_IDS))
            _post(b, lane, int(pid), void=j % 2 == 1)
        checked = rng.random(LANES) < 0.05
        cold_flag = True
    else:
        raise KeyError(name)
    return {"ledger": _ledger, "batch": b, "count": count,
            "has_postvoid": has_pv, "checked": checked,
            "bloom": _bloom(extra), "cold": cold_flag}


def inputs(c: Dict, dev):
    """``build_gather_ctx``'s arguments on ``dev``: (ledger, batch SoA,
    valid, postvoid, bloom, cold_checked, has_postvoid)."""
    soa = convert.batch_to_tensors(c["batch"], LANES, dev)
    valid = torch.arange(LANES, device=dev) < c["count"]
    pv_flags = int(F.POST_PENDING_TRANSFER | F.VOID_PENDING_TRANSFER)
    postvoid = ((soa["flags"] & pv_flags) != 0) & valid
    checked = (None if c["checked"] is None
               else torch.from_numpy(c["checked"]).to(dev))
    return (c["ledger"](dev), soa, valid, postvoid,
            convert.bloom_to_tensor(c["bloom"], dev), checked,
            c["has_postvoid"])
