"""Seeded batches for the general transfer kernel (``ops/transfer_full``):
a mix that mostly stays on that kernel, plus batches that trip each of its
``FLAG_SEQ`` reasons on purpose.

``GeneralMix.batch(n)`` alternates two shapes, because the kernel sends a
linked chain to the sequential path when the batch also holds duplicate ids
or post/void lanes:

- two-phase: plain and pending transfers, posts and voids of pendings made
  earlier in the same batch and of pendings in the table (full, partial and
  too-large amounts; some expired, some already posted or voided), double
  posts and voids, balancing debits and credits, transfers on limit and
  history accounts, duplicate ids, a few invalid events;
- chains: linked chains of plain transfers between accounts without limits
  (some broken by an invalid member), beside plain, pending, balancing and
  limit-account transfers, with no repeated id and no post or void.

``batch(n, kind)`` with a ``FLAG_SEQ`` reason makes a two-phase or chains
batch and adds what trips it: ``unconverged`` (a cascade of balancing debits
deeper than the pass budget), ``u128`` (an amount of 2**64 or more),
``linked_x_intra`` (a linked chain beside a post), ``chain_balance`` (a
linked chain whose member fails a balance limit) or ``arith_broken`` (a void
and a new pending on the ``big`` account, once ``seed_big`` has put its
debits_pending near 2**128: the true balance fits, the sum of the adds
before the subtractions does not).  Accounts come from ``seqmix.accounts_batch`` (limit and
history flags by id).  Everything is drawn from one numpy generator.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

from .. import types
from ..types import AccountFlags as AF, TransferFlags as F
from .seqmix import account_flags

SEQ_REASONS = ("unconverged", "u128", "linked_x_intra", "chain_balance",
               "arith_broken")
U128_MAX = (1 << 128) - 1


class GeneralMix:
    """State of the mix across batches: the accounts it draws from, the next
    fresh id, the pendings in the table and those of the last batch."""

    def __init__(self, rng: np.random.Generator, account_ids: List[int],
                 first_id: int) -> None:
        self.rng = rng
        self.accounts = list(account_ids)
        # The last two accounts without limits are kept for seed_big and the
        # arith_broken batches (their pending balances sit near 2**128).
        self.big, self.big_cr = [a for a in self.accounts
                                 if account_flags(a) in (0, AF.HISTORY)][-2:]
        usable = [a for a in self.accounts
                  if a not in (self.big, self.big_cr)]
        self.free = [a for a in usable if account_flags(a) in (0, AF.HISTORY)]
        self.limit = [a for a in usable if a not in self.free]
        self.usable = usable
        self.next_id = first_id
        self.pool: List[int] = []  # committed pendings
        self.used: List[int] = []
        self._made: List[Tuple[int, int]] = []  # (lane, id) of new pendings
        self._shape = 0

    def _id(self) -> int:
        self.next_id += 1
        return self.next_id

    def _pair(self, accounts) -> Tuple[int, int]:
        dr, cr = self.rng.choice(accounts, 2, replace=False)
        return int(dr), int(cr)

    def _plain(self, rows, accounts=None, flags=0, amount=None, **kw):
        dr, cr = self._pair(accounts or self.usable)
        rows.append(types.transfer(
            id=kw.pop("id", None) or self._id(), debit_account_id=dr,
            credit_account_id=cr, ledger=kw.pop("ledger", 1), code=10,
            amount=int(self.rng.integers(1, 1000)) if amount is None else amount,
            flags=flags, **kw))
        return rows[-1]

    def _pending(self, rows, in_batch):
        timeout = int(self.rng.integers(0, 3))
        row = self._plain(rows, flags=int(F.PENDING), timeout=timeout)
        in_batch.append(int(row["id_lo"]))
        self._made.append((len(rows) - 1, int(row["id_lo"])))

    def _postvoid(self, rows, pending_id):
        rng = self.rng
        flag = F.POST_PENDING_TRANSFER if rng.random() < 0.6 else (
            F.VOID_PENDING_TRANSFER)
        amount = 0 if rng.random() < 0.7 else int(rng.integers(1, 1200))
        rows.append(types.transfer(id=self._id(), pending_id=pending_id,
                                   amount=amount, flags=int(flag)))

    def _balancing(self, rows, accounts=None, flags=0):
        rng = self.rng
        flag = F.BALANCING_DEBIT if rng.random() < 0.5 else F.BALANCING_CREDIT
        amount = int(rng.integers(0, 2000)) if rng.random() < 0.5 else 0
        self._plain(rows, accounts, flags=int(flag) | flags, amount=amount)

    def _two_phase(self, n: int) -> list:
        rng = self.rng
        rows: list = []
        in_batch: List[int] = []
        while len(rows) < n:
            r = rng.random()
            if r < 0.2:
                self._pending(rows, in_batch)
            elif r < 0.35 and in_batch:
                self._postvoid(rows, int(rng.choice(in_batch)))
            elif r < 0.5 and self.pool:
                self._postvoid(rows, int(rng.choice(self.pool)))
            elif r < 0.6:
                self._balancing(rows)
            elif r < 0.65 and rows:
                rows.append(rows[int(rng.integers(0, len(rows)))].copy())
            elif r < 0.67 and self.used:
                self._plain(rows, id=int(rng.choice(self.used)))  # exists
            elif r < 0.69:
                self._plain(rows, ledger=0)
            else:
                self._plain(rows, self.limit if rng.random() < 0.3 else None)
        return rows[:n]

    def _chains(self, n: int) -> list:
        rng = self.rng
        rows: list = []
        in_batch: List[int] = []
        while len(rows) < n - 6:
            r = rng.random()
            if r < 0.3:
                for k in range(int(rng.integers(2, 6))):
                    self._plain(rows, self.free, flags=int(F.LINKED))
                if rng.random() < 0.3:
                    rows[-1 - int(rng.integers(0, 2))]["ledger"] = 0  # breaks
                self._plain(rows, self.free)  # the terminator
            elif r < 0.45:
                self._pending(rows, in_batch)
            elif r < 0.6:
                self._balancing(rows)
            else:
                self._plain(rows, self.limit if rng.random() < 0.4 else None)
        while len(rows) < n:
            self._plain(rows, self.free)
        return rows[:n]

    def seed_big(self) -> np.ndarray:
        """Two pendings on the ``big`` account's debits: one of a u128 amount
        (the sequential path commits the batch) that puts them near 2**128,
        and one of 2**20 that the arith_broken batches void."""
        self.big_pending = self._id()
        return types.transfers_array([
            types.transfer(id=self._id(), debit_account_id=self.big,
                           credit_account_id=self.big_cr,
                           amount=U128_MAX - (1 << 21), ledger=1, code=10,
                           flags=int(F.PENDING)),
            types.transfer(id=self.big_pending, debit_account_id=self.big,
                           credit_account_id=self.big_cr, amount=1 << 20,
                           ledger=1, code=10, flags=int(F.PENDING))])

    def batch(self, n: int, kind: str = "general") -> np.ndarray:
        self._made = []
        rng = self.rng
        if kind in ("general", "u128"):
            self._shape ^= 1
            rows = self._two_phase(n) if self._shape else self._chains(n)
        elif kind == "arith_broken":
            rows = self._two_phase(n)
        elif kind == "unconverged":
            rows = self._two_phase(n - 12)
            # Balancing debits, each from the account the previous one
            # credits: every lane's clamp waits on the previous lane's.
            start = int(rng.integers(0, len(self.free)))
            chain = [self.free[(start + k) % len(self.free)] for k in range(12)]
            self._plain(rows, amount=10 ** 12, id=self._id())
            rows[-1]["debit_account_id_lo"] = chain[0]
            rows[-1]["credit_account_id_lo"] = chain[1]
            for k in range(1, 11):
                rows.append(types.transfer(
                    id=self._id(), debit_account_id=chain[k],
                    credit_account_id=chain[k + 1], amount=0, ledger=1,
                    code=10, flags=int(F.BALANCING_DEBIT)))
            rows.append(types.transfer(
                id=self._id(), debit_account_id=chain[11],
                credit_account_id=chain[0], amount=0, ledger=1, code=10,
                flags=int(F.BALANCING_DEBIT)))
        elif kind == "linked_x_intra":
            rows = self._two_phase(n - 2)
            self._plain(rows, self.free, flags=int(F.LINKED))
            self._plain(rows, self.free)
        elif kind == "chain_balance":
            rows = self._chains(n - 2)
            self._plain(rows, self.free, flags=int(F.LINKED))
            lim = [a for a in self.limit
                   if account_flags(a) & AF.DEBITS_MUST_NOT_EXCEED_CREDITS]
            row = self._plain(rows, amount=1 << 62)
            row["debit_account_id_lo"] = int(rng.choice(lim))
        else:
            raise ValueError(f"unknown batch kind {kind!r}")
        if kind == "u128":
            rows[-1]["amount_hi"] = 1
            rows[-1]["flags"] &= ~np.uint16(F.LINKED)
        elif kind == "arith_broken":
            rows[-2] = types.transfer(id=self._id(), pending_id=self.big_pending,
                                      flags=int(F.VOID_PENDING_TRANSFER))
            rows[-1] = types.transfer(
                id=self._id(), debit_account_id=self.big,
                credit_account_id=self.big_cr, amount=(1 << 20) + 5, ledger=1,
                code=10, flags=int(F.PENDING))
        batch = types.transfers_array(rows) if isinstance(rows, list) else rows
        self.used.extend(int(i) for i in batch["id_lo"])
        return batch

    def settle(self, failed: Iterable[int]) -> None:
        """After a commit: the last batch's pendings that did not fail join
        the table pool (``failed`` holds their lane indices; pass every lane
        when nothing was applied)."""
        bad = set(failed)
        self.pool.extend(i for lane, i in self._made if lane not in bad)
        self._made = []
