"""Host (numpy) generator of the flagship benchmark's plain-transfer batches.

Copies of ``bench.py``'s ``mix64_np`` and ``gen_batch_np``, bit for bit: the
same batch index gives the same transfers in both packages; a numpy copy of
its on-device ``--two-phase`` generator ``gen_two_phase``; and of its
``--limits`` set-up (limit-flagged accounts plus one funder, then a funding
transfer of 2**40 to each), after which the steady state is
``gen_batch_np``.  The batches are
made on the host because numpy's uint64 ``%`` is exact; torch's int64 ``%``
is signed and wrong above 2**63.
"""

from __future__ import annotations

import numpy as np

from .. import types


def mix64_np(lo: np.ndarray, hi: int) -> np.ndarray:
    """Pure-numpy twin of u128.mix64 (identical bits)."""
    with np.errstate(over="ignore"):
        x = lo.astype(np.uint64) ^ (
            np.uint64(hi) * np.uint64(0x9E3779B97F4A7C15)
        )
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def _mix_workload(gid: np.ndarray, n_accounts: int):
    """(debit index, credit index, amount) of workload event ``gid``
    (bench.py's ``mix_workload``)."""
    h1 = mix64_np(gid, 0x1234)
    h2 = mix64_np(gid, 0x9876)
    dr = h1 % np.uint64(n_accounts)
    off = np.uint64(1) + h2 % np.uint64(n_accounts - 1)
    cr = (dr + off) % np.uint64(n_accounts)
    amount = np.uint64(1) + ((h1 >> np.uint64(32)) & np.uint64(0xFFFF))
    return dr, cr, amount


def gen_batch_np(b: int, lanes: int, count: int, n_accounts: int, first_tid: int):
    """Batch ``b`` of the flagship workload: ``count`` plain transfers between
    accounts 1..n_accounts (never to the same account), ids from
    ``first_tid + b * count``, amounts 1..65536, ledger 1, code 10."""
    gid = np.arange(lanes, dtype=np.uint64) + np.uint64(b * count)
    dr, cr, amount = _mix_workload(gid, n_accounts)

    batch = np.zeros(lanes, dtype=types.TRANSFER_DTYPE)
    batch["id_lo"] = first_tid + gid
    batch["debit_account_id_lo"] = dr + 1
    batch["credit_account_id_lo"] = cr + 1
    batch["amount_lo"] = amount
    batch["ledger"] = 1
    batch["code"] = 10
    return batch[:count]


def gen_two_phase_np(b: int, lanes: int, count: int, n_accounts: int,
                     first_tid: int):
    """Batch ``b`` of bench.py's ``--two-phase`` workload (``gen_two_phase``):
    ``count // 2`` pending transfers, then a post of each of them, in one
    batch.  Pending lane i carries event ``b * count + i`` of the flagship
    mix (its accounts and amount); post lane ``half + i`` posts the pending
    of lane i in full (amount 0, no accounts, ledger or code).  Ids run from
    ``first_tid + b * count``; an odd ``count`` leaves its last lane out."""
    half = count // 2
    lane = np.arange(lanes, dtype=np.uint64)
    base = np.uint64(b * count)
    is_post = lane >= np.uint64(half)
    pend_lane = np.where(is_post, lane - np.uint64(half), lane)
    dr, cr, amount = _mix_workload(base + pend_lane, n_accounts)
    pending = ~is_post

    batch = np.zeros(lanes, dtype=types.TRANSFER_DTYPE)
    batch["id_lo"] = np.uint64(first_tid) + base + lane
    batch["debit_account_id_lo"] = np.where(pending, dr + np.uint64(1), 0)
    batch["credit_account_id_lo"] = np.where(pending, cr + np.uint64(1), 0)
    batch["amount_lo"] = np.where(pending, amount, 0)
    batch["pending_id_lo"] = np.where(
        is_post, np.uint64(first_tid) + base + pend_lane, 0)
    batch["ledger"] = np.where(pending, 1, 0)
    batch["code"] = np.where(pending, 10, 0)
    batch["flags"] = np.where(is_post, types.TransferFlags.POST_PENDING_TRANSFER,
                              types.TransferFlags.PENDING)
    return batch[:2 * half]


def gen_limit_accounts_np(n_accounts: int, count: int):
    """bench.py ``--limits`` account batches (``bench.py:2066-2087``):
    accounts 1..n_accounts with DEBITS_MUST_NOT_EXCEED_CREDITS and one
    unflagged funder, ``n_accounts + 1``, ledger 1, code 10, in batches of at
    most ``count``."""
    lim = types.AccountFlags.DEBITS_MUST_NOT_EXCEED_CREDITS
    ids = np.arange(1, n_accounts + 2, dtype=np.uint64)
    out = []
    for start in range(0, len(ids), count):
        part = ids[start:start + count]
        batch = np.zeros(len(part), dtype=types.ACCOUNT_DTYPE)
        batch["id_lo"] = part
        batch["ledger"] = 1
        batch["code"] = 10
        batch["flags"] = np.where(part <= n_accounts, np.uint16(lim),
                                  np.uint16(0))
        out.append(batch)
    return out


def gen_funding_np(n_accounts: int, count: int):
    """bench.py ``--limits`` funding batches (``bench.py:2091-2117``): the
    funder (``n_accounts + 1``) credits each limit account 2**40, ids from
    2**31, in batches of at most ``count``."""
    out = []
    for funded in range(0, n_accounts, count):
        n = min(count, n_accounts - funded)
        lane = np.arange(n, dtype=np.uint64)
        batch = np.zeros(n, dtype=types.TRANSFER_DTYPE)
        batch["id_lo"] = (1 << 31) + funded + lane
        batch["debit_account_id_lo"] = n_accounts + 1
        batch["credit_account_id_lo"] = 1 + funded + lane
        batch["amount_lo"] = 1 << 40
        batch["ledger"] = 1
        batch["code"] = 10
        out.append(batch)
    return out
