"""Batches that set the traps of K3's grid-wide form (``csrc/validate.cu``:
one lane a thread, blocks of ``state_machine.VALIDATE_BLOCK`` lanes, the
duplicates and chains resolved after grid barriers), in numpy: duplicate
ids across block boundaries, a duplicate whose first lane fails, chains
across block boundaries, a chain as long as the batch, a linked last lane,
a count below the lane count, and a random mix.  ``transfer_case(name,
n)`` returns (batch columns, context columns, count, timestamp);
``account_case(name, n)`` returns (batch columns, found, exists columns,
count).  The CPU tests hold the split form's plain version against the JAX
package on them, the card tests the kernel against its plain version."""

from __future__ import annotations

import numpy as np

from .. import types
from ..ops import state_machine as sm

CASES = ("dups_across_blocks", "winner_fails", "chain_across_blocks",
         "chain_whole_batch", "linked_last", "count_below_n", "random")
LINKED = 1
TIMESTAMP = 10 ** 12


def _soa(rows) -> dict:
    return {name: np.ascontiguousarray(rows[name]).astype(
        np.uint32 if rows[name].dtype == np.uint16 else rows[name].dtype)
        for name in rows.dtype.names}


def _plan(name: str, n: int, rng):
    """(count, ids, lanes that fail on their own, linked lanes) of a case."""
    count = n - 37 if name == "count_below_n" else n
    ids = np.arange(1000, 1000 + n, dtype=np.uint64)
    fails = np.zeros(n, bool)
    linked = np.zeros(n, bool)
    b = sm.VALIDATE_BLOCK
    if name == "dups_across_blocks":
        ids[[b - 28, b + 2, 2 * b + 44, 3 * b + 66]] = 77   # lane 100 fails
        fails[b - 28] = True
        ids[[5, b - 1, b]] = 88                             # a block's edges
    elif name == "winner_fails":
        ids[[10, 2 * b + 3]] = 55                           # the first fails
        fails[10] = True
        ids[[20, b + 9, 3 * b + 1]] = 66                    # every lane fails
        fails[[20, b + 9, 3 * b + 1]] = True
    elif name == "chain_across_blocks":
        linked[b - 8:b + 12] = True                         # fails in block 1
        fails[b + 7] = True
        linked[2 * b - 3:2 * b + 5] = True                  # no failure
        linked[3 * b - 1] = True                            # two lanes, the
        fails[3 * b] = True                                 # last one fails
    elif name == "chain_whole_batch":
        linked[:count - 1] = True
        fails[count // 2] = True
    elif name == "linked_last":
        linked[count - 6:count] = True                      # open at the end
        linked[40:45] = True
        fails[42] = True
    elif name == "count_below_n":
        linked[count - 4:] = True                           # past the count
        ids[[count - 10, count + 5]] = 99
        linked[b - 2:b + 3] = True
    elif name == "random":
        ids = rng.integers(1000, 1000 + n // 2, n).astype(np.uint64)
        fails = rng.random(n) < 0.1
        linked = rng.random(n) < 0.3
    return count, ids, fails, linked


def transfer_case(name: str, n: int = 512):
    rng = np.random.default_rng(CASES.index(name))
    count, ids, fails, linked = _plan(name, n, rng)
    rows = np.zeros(n, dtype=types.TRANSFER_DTYPE)
    rows["id_lo"] = ids
    dr = 1 + np.arange(n) % 7
    rows["debit_account_id_lo"] = dr
    rows["credit_account_id_lo"] = dr + 1
    rows["amount_lo"] = np.where(fails, 0, 1 + np.arange(n) % 5)  # 18
    rows["ledger"] = 1
    rows["code"] = 1 + (ids % 3).astype(np.uint16)
    rows["flags"] = np.where(linked, LINKED, 0)
    if name == "random":
        rows["user_data_32"] = rng.integers(0, 2, n)
        rows["flags"] |= np.where(rng.random(n) < 0.2, 2, 0).astype(np.uint16)
        rows["timeout"] = np.where(rng.random(n) < 0.1, 5, 0)
    batch = _soa(rows)
    found = np.ones(n, bool)
    if name == "random":
        found = rng.random(n) < 0.97
    ex_found = np.zeros(n, bool)
    e = {c: np.zeros(n, batch[c].dtype) for c in sm.TRANSFER_EXISTS_COLS}
    if name == "random":
        # Some ids exist in the table: the same event, or one that differs.
        ex_found = rng.random(n) < 0.1
        for c in sm.TRANSFER_EXISTS_COLS:
            e[c] = batch[c].copy()
        e["code"] = np.where(rng.random(n) < 0.5, e["code"], e["code"] + 1)
    ctx = {"dr_found": found, "cr_found": np.ones(n, bool),
           "dr_ledger": np.ones(n, np.uint32), "cr_ledger": np.ones(n, np.uint32),
           "ex_found": ex_found, "e": e}
    return batch, ctx, count, TIMESTAMP


def account_case(name: str, n: int = 512):
    rng = np.random.default_rng(100 + CASES.index(name))
    count, ids, fails, linked = _plan(name, n, rng)
    rows = np.zeros(n, dtype=types.ACCOUNT_DTYPE)
    rows["id_lo"] = ids
    rows["ledger"] = np.where(fails, 0, 1)  # 13
    rows["code"] = 1 + (ids % 3).astype(np.uint16)
    rows["flags"] = np.where(linked, LINKED, 0)
    if name == "random":
        rows["user_data_64"] = rng.integers(0, 2, n)
    batch = _soa(rows)
    found = np.zeros(n, bool)
    e = {c: np.zeros(n, batch[c].dtype) for c in sm.ACCOUNT_EXISTS_COLS}
    if name == "random":
        found = rng.random(n) < 0.1
        for c in sm.ACCOUNT_EXISTS_COLS:
            e[c] = batch[c].copy()
        e["ledger"] = np.where(rng.random(n) < 0.5, e["ledger"], 2)
    return batch, found, e, count
