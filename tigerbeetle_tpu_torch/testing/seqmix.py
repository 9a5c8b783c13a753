"""Seeded batches that mix every kind of event the sequential path handles,
for holding kernels K6 and K7 against their plain versions and the machine
against the scalar oracle (``testing/model.py``).

Accounts carry limit and history flags; transfers mix plain, pending (with
short timeouts, so later posts can find them expired), post and void with
full and partial amounts, balancing debits and credits, amounts near 2**128
(the overflow codes 47-53), linked chains that break after two-phase
effects, ids repeated inside a batch and ids re-used after a rollback, and
a few invalid events.  Everything is drawn from one numpy generator.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .. import types
from ..types import AccountFlags as AF, TransferFlags as F

U128_MAX = (1 << 128) - 1


def account_flags(account_id: int) -> int:
    """Flags of account ``account_id`` in the mix: one in seven of each of
    debit limit, credit limit, history, and history with a debit limit."""
    return {
        2: AF.DEBITS_MUST_NOT_EXCEED_CREDITS,
        3: AF.CREDITS_MUST_NOT_EXCEED_DEBITS,
        4: AF.HISTORY,
        5: AF.HISTORY | AF.DEBITS_MUST_NOT_EXCEED_CREDITS,
    }.get(account_id % 7, 0)


def accounts_batch(rng: np.random.Generator, first: int, n: int,
                   faults: bool = True) -> np.ndarray:
    """Accounts ``first .. first + n - 1`` with the mix's flags.  With
    ``faults``, a tenth of them are linked into chains, some of which break
    (ledger 0), and some ids repeat, so the batch exercises the rollback
    and the retry of a rolled-back id."""
    b = np.zeros(n, dtype=types.ACCOUNT_DTYPE)
    ids = np.arange(first, first + n, dtype=np.uint64)
    b["ledger"] = 1
    b["code"] = 10
    b["flags"] = [account_flags(int(i)) for i in ids]
    b["user_data_64"] = rng.integers(0, 1 << 20, n)
    if faults:
        linked = rng.random(n) < 0.1
        linked[-1] = False
        b["flags"] |= np.where(linked, AF.LINKED, 0).astype(np.uint16)
        b["ledger"][rng.random(n) < 0.02] = 0
        dup = np.flatnonzero(rng.random(n) < 0.03)
        ids[dup] = ids[np.maximum(dup - rng.integers(1, 8, len(dup)), 0)]
    b["id_lo"] = ids
    return b


class TransferMix:
    """State of a transfer mix across batches: the accounts it draws from,
    the next fresh id and the pending transfers it has made."""

    def __init__(self, rng: np.random.Generator, account_ids: List[int],
                 first_id: int) -> None:
        self.rng = rng
        self.accounts = list(account_ids)
        self.next_id = first_id
        self.pending: List[int] = []
        self.used: List[int] = []

    def _pair(self):
        dr, cr = self.rng.choice(self.accounts, 2, replace=False)
        return int(dr), int(cr)

    def batch(self, n: int) -> np.ndarray:
        rng = self.rng
        rows = []
        batch_ids: List[int] = []
        for i in range(n):
            self.next_id += 1
            tid = self.next_id
            r = rng.random()
            if r < 0.04 and batch_ids:
                tid = int(rng.choice(batch_ids))  # in-batch repeat / re-use
            elif r < 0.06 and self.used:
                tid = int(rng.choice(self.used))  # exists
            linked = int(F.LINKED) if (rng.random() < 0.15 and i != n - 1) else 0
            dr, cr = self._pair()
            kind = rng.random()
            if kind < 0.25 and self.pending:
                flag = F.POST_PENDING_TRANSFER if rng.random() < 0.65 else (
                    F.VOID_PENDING_TRANSFER)
                amount = 0
                if rng.random() < 0.3:
                    amount = int(rng.integers(1, 1200))  # partial, or over
                rows.append(types.transfer(
                    id=tid, pending_id=int(rng.choice(self.pending)),
                    amount=amount, flags=int(flag) | linked))
            elif kind < 0.33:
                flag = F.BALANCING_DEBIT if rng.random() < 0.5 else (
                    F.BALANCING_CREDIT)
                rows.append(types.transfer(
                    id=tid, debit_account_id=dr, credit_account_id=cr,
                    amount=int(rng.integers(0, 2000)) if rng.random() < 0.5 else 0,
                    ledger=1, code=10, flags=int(flag) | linked))
            elif kind < 0.345:
                # Near 2**128, between accounts without limits: the next
                # transfers on these accounts overflow (codes 47-52).
                pend = int(F.PENDING) if rng.random() < 0.5 else 0
                free = [a for a in self.accounts if account_flags(a) in (
                    0, AF.HISTORY)]
                dr, cr = (int(x) for x in rng.choice(free, 2, replace=False))
                rows.append(types.transfer(
                    id=tid, debit_account_id=dr, credit_account_id=cr,
                    amount=U128_MAX - int(rng.integers(0, 1 << 20)),
                    ledger=1, code=10, flags=pend | linked))
            else:
                pend = int(F.PENDING) if rng.random() < 0.45 else 0
                timeout = int(rng.integers(0, 4)) if pend else 0
                ledger, code = 1, 10
                fault = rng.random()
                if fault < 0.02:
                    ledger = 0
                elif fault < 0.04:
                    cr = dr
                elif fault < 0.06:
                    dr = 10 ** 12 + i  # missing account
                elif fault < 0.07:
                    # A long timeout: code 53 where timestamps near 2**64.
                    pend = int(F.PENDING)
                    timeout = int(rng.integers(1 << 31, 1 << 32))
                rows.append(types.transfer(
                    id=tid, debit_account_id=dr, credit_account_id=cr,
                    amount=int(rng.integers(1, 1000)), ledger=ledger,
                    code=code, flags=pend | linked, timeout=timeout,
                    user_data_64=int(rng.integers(0, 4))))
                if pend:
                    self.pending.append(tid)
            batch_ids.append(tid)
        self.used.extend(batch_ids)
        return types.transfers_array(rows)
