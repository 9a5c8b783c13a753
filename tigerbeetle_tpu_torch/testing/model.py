"""Scalar reference model of the accounting state machine (the parity oracle).

A deliberately straightforward, event-at-a-time Python implementation of the
reference semantics, used as the differential-testing oracle for the device
kernels (the reference's own strategy: a second state-machine implementation
exists precisely for tests, src/testing/state_machine.zig).

Semantics transcribed from (reference, src/state_machine.zig):
- ``execute``                    :1002-1088  (linked chains, scopes, rollback)
- ``create_account``             :1198-1225
- ``create_account_exists``      :1227-1237
- ``create_transfer``            :1239-1368
- ``create_transfer_exists``     :1370-1389
- ``post_or_void_pending_transfer``         :1391-1498
- ``post_or_void_pending_transfer_exists``  :1500-1561
- timestamp assignment           :1035  (timestamp - len + index + 1)
- ``prepare`` timestamp advance  :503-512
- ``sum_overflows``              :1645-1650

All integers are Python ints; u128/u64/u32 wrap/overflow behavior is made
explicit where the reference checks it.  This model is not performance-relevant
— it exists so that every device path can be checked for *byte-identical*
results and balances.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import NS_PER_S
from ..types import (
    ACCOUNT_DTYPE,
    TRANSFER_DTYPE,
    AccountFlags,
    CreateAccountResult,
    CreateTransferResult,
    TransferFlags,
    u128_join,
)

U64_MAX = (1 << 64) - 1
U128_MAX = (1 << 128) - 1


@dataclasses.dataclass
class Account:
    id: int
    debits_pending: int = 0
    debits_posted: int = 0
    credits_pending: int = 0
    credits_posted: int = 0
    user_data_128: int = 0
    user_data_64: int = 0
    user_data_32: int = 0
    reserved: int = 0
    ledger: int = 0
    code: int = 0
    flags: int = 0
    timestamp: int = 0

    def copy(self) -> "Account":
        return dataclasses.replace(self)


@dataclasses.dataclass
class Transfer:
    id: int
    debit_account_id: int = 0
    credit_account_id: int = 0
    amount: int = 0
    pending_id: int = 0
    user_data_128: int = 0
    user_data_64: int = 0
    user_data_32: int = 0
    timeout: int = 0
    ledger: int = 0
    code: int = 0
    flags: int = 0
    timestamp: int = 0

    def copy(self) -> "Transfer":
        return dataclasses.replace(self)


def account_from_row(row: np.void) -> Account:
    return Account(
        id=u128_join(row["id_lo"], row["id_hi"]),
        debits_pending=u128_join(row["debits_pending_lo"], row["debits_pending_hi"]),
        debits_posted=u128_join(row["debits_posted_lo"], row["debits_posted_hi"]),
        credits_pending=u128_join(row["credits_pending_lo"], row["credits_pending_hi"]),
        credits_posted=u128_join(row["credits_posted_lo"], row["credits_posted_hi"]),
        user_data_128=u128_join(row["user_data_128_lo"], row["user_data_128_hi"]),
        user_data_64=int(row["user_data_64"]),
        user_data_32=int(row["user_data_32"]),
        reserved=int(row["reserved"]),
        ledger=int(row["ledger"]),
        code=int(row["code"]),
        flags=int(row["flags"]),
        timestamp=int(row["timestamp"]),
    )


def transfer_from_row(row: np.void) -> Transfer:
    return Transfer(
        id=u128_join(row["id_lo"], row["id_hi"]),
        debit_account_id=u128_join(row["debit_account_id_lo"], row["debit_account_id_hi"]),
        credit_account_id=u128_join(row["credit_account_id_lo"], row["credit_account_id_hi"]),
        amount=u128_join(row["amount_lo"], row["amount_hi"]),
        pending_id=u128_join(row["pending_id_lo"], row["pending_id_hi"]),
        user_data_128=u128_join(row["user_data_128_lo"], row["user_data_128_hi"]),
        user_data_64=int(row["user_data_64"]),
        user_data_32=int(row["user_data_32"]),
        timeout=int(row["timeout"]),
        ledger=int(row["ledger"]),
        code=int(row["code"]),
        flags=int(row["flags"]),
        timestamp=int(row["timestamp"]),
    )


def _u128_lists(batch: np.ndarray, name: str) -> List[int]:
    lo = batch[name + "_lo"].astype(np.uint64).tolist()
    hi = batch[name + "_hi"].astype(np.uint64).tolist()
    return [lo_ | (hi_ << 64) for lo_, hi_ in zip(lo, hi)]


def accounts_from_batch(batch: np.ndarray) -> List[Account]:
    """Column-wise batch -> Account conversion (one C pass per column).

    Value-identical to [account_from_row(r) for r in batch]; the per-row
    form pays ~17 numpy scalar extractions per event, which made the scrub
    mirror's per-commit advance the dominant scrub tax (BENCH_r05's ~1.6x
    overhead_vs_off) — machine._mirror_apply uses this batched form."""
    return [
        Account(
            id=i, debits_pending=dp, debits_posted=dpo,
            credits_pending=cp, credits_posted=cpo,
            user_data_128=u128, user_data_64=u64, user_data_32=u32,
            reserved=res, ledger=led, code=code, flags=flags, timestamp=ts,
        )
        for i, dp, dpo, cp, cpo, u128, u64, u32, res, led, code, flags, ts
        in zip(
            _u128_lists(batch, "id"),
            _u128_lists(batch, "debits_pending"),
            _u128_lists(batch, "debits_posted"),
            _u128_lists(batch, "credits_pending"),
            _u128_lists(batch, "credits_posted"),
            _u128_lists(batch, "user_data_128"),
            batch["user_data_64"].tolist(),
            batch["user_data_32"].tolist(),
            batch["reserved"].tolist(),
            batch["ledger"].tolist(),
            batch["code"].tolist(),
            batch["flags"].tolist(),
            batch["timestamp"].tolist(),
        )
    ]


def transfers_from_batch(batch: np.ndarray) -> List[Transfer]:
    """Column-wise batch -> Transfer conversion (see accounts_from_batch)."""
    return [
        Transfer(
            id=i, debit_account_id=dr, credit_account_id=cr, amount=amt,
            pending_id=pend, user_data_128=u128, user_data_64=u64,
            user_data_32=u32, timeout=to, ledger=led, code=code,
            flags=flags, timestamp=ts,
        )
        for i, dr, cr, amt, pend, u128, u64, u32, to, led, code, flags, ts
        in zip(
            _u128_lists(batch, "id"),
            _u128_lists(batch, "debit_account_id"),
            _u128_lists(batch, "credit_account_id"),
            _u128_lists(batch, "amount"),
            _u128_lists(batch, "pending_id"),
            _u128_lists(batch, "user_data_128"),
            batch["user_data_64"].tolist(),
            batch["user_data_32"].tolist(),
            batch["timeout"].tolist(),
            batch["ledger"].tolist(),
            batch["code"].tolist(),
            batch["flags"].tolist(),
            batch["timestamp"].tolist(),
        )
    ]


def sum_overflows(a: int, b: int, bits: int) -> bool:
    return a + b > (1 << bits) - 1


_MISSING = object()


class ReferenceStateMachine:
    """Event-at-a-time oracle with undo-log scopes for linked-chain rollback."""

    def __init__(self) -> None:
        self.accounts: Dict[int, Account] = {}
        self.transfers: Dict[int, Transfer] = {}
        # pending transfer timestamp -> "posted" | "voided" (PostedGroove).
        self.posted: Dict[int, str] = {}
        # timestamp -> history groove value (dict of dr_/cr_ snapshot fields).
        self.history: Dict[int, dict] = {}
        self.prepare_timestamp = 0
        self.commit_timestamp = 0
        # Undo log for the open scope (state_machine.zig:972-1000 scope_open/close).
        self._scope: Optional[List[Tuple[dict, int, object]]] = None

    # -- scopes (groove.zig scope_open/scope_close via undo log) -----------

    def _scope_open(self) -> None:
        assert self._scope is None
        self._scope = []

    def _scope_close(self, persist: bool) -> None:
        assert self._scope is not None
        if not persist:
            for store, key, old in reversed(self._scope):
                if old is _MISSING:
                    del store[key]
                else:
                    store[key] = old
        self._scope = None

    def _record(self, store: dict, key: int) -> None:
        if self._scope is not None:
            old = store.get(key, _MISSING)
            if old is not _MISSING and not isinstance(old, str):
                old = old.copy()
            self._scope.append((store, key, old))

    def _put(self, store: dict, key: int, value) -> None:
        self._record(store, key)
        store[key] = value

    # -- prepare (state_machine.zig:503-512) --------------------------------

    def prepare(self, operation: str, count: int, wall_clock_ns: int = 0) -> int:
        """Advance prepare_timestamp by the event count and return the batch
        timestamp (the highest timestamp of the batch).  The replica bumps
        prepare_timestamp to wall clock first (replica.zig on_request path);
        callers can pass wall_clock_ns to model that."""
        if wall_clock_ns > self.prepare_timestamp:
            self.prepare_timestamp = wall_clock_ns
        if operation in ("create_accounts", "create_transfers"):
            self.prepare_timestamp += count
        return self.prepare_timestamp

    # -- execute (state_machine.zig:1002-1088) -------------------------------

    def execute(
        self, operation: str, timestamp: int, events: List
    ) -> List[Tuple[int, int]]:
        assert operation in ("create_accounts", "create_transfers")
        results: List[Tuple[int, int]] = []
        chain: Optional[int] = None
        chain_broken = False

        for index, event_ in enumerate(events):
            event = event_.copy()
            linked = bool(event.flags & 1)

            result = None
            if linked:
                if chain is None:
                    chain = index
                    assert not chain_broken
                    self._scope_open()
                if index == len(events) - 1:
                    result = 2  # linked_event_chain_open
            if result is None and chain_broken:
                result = 1  # linked_event_failed
            if result is None and event.timestamp != 0:
                result = 3  # timestamp_must_be_zero
            if result is None:
                event.timestamp = timestamp - len(events) + index + 1
                if operation == "create_accounts":
                    result = int(self.create_account(event))
                else:
                    result = int(self.create_transfer(event))

            if result != 0:
                if chain is not None:
                    if not chain_broken:
                        chain_broken = True
                        self._scope_close(persist=False)
                        for chain_index in range(chain, index):
                            results.append((chain_index, 1))
                results.append((index, result))

            if chain is not None and (not linked or result == 2):
                if not chain_broken:
                    self._scope_close(persist=True)
                chain = None
                chain_broken = False

        assert chain is None
        assert not chain_broken
        return results

    # -- create_account (state_machine.zig:1198-1225) ------------------------

    def create_account(self, a: Account) -> CreateAccountResult:
        R = CreateAccountResult
        assert a.timestamp > self.commit_timestamp

        if a.reserved != 0:
            return R.reserved_field
        if a.flags & AccountFlags.PADDING_MASK:
            return R.reserved_flag
        if a.id == 0:
            return R.id_must_not_be_zero
        if a.id == U128_MAX:
            return R.id_must_not_be_int_max
        if (a.flags & AccountFlags.DEBITS_MUST_NOT_EXCEED_CREDITS) and (
            a.flags & AccountFlags.CREDITS_MUST_NOT_EXCEED_DEBITS
        ):
            return R.flags_are_mutually_exclusive
        if a.debits_pending != 0:
            return R.debits_pending_must_be_zero
        if a.debits_posted != 0:
            return R.debits_posted_must_be_zero
        if a.credits_pending != 0:
            return R.credits_pending_must_be_zero
        if a.credits_posted != 0:
            return R.credits_posted_must_be_zero
        if a.ledger == 0:
            return R.ledger_must_not_be_zero
        if a.code == 0:
            return R.code_must_not_be_zero

        e = self.accounts.get(a.id)
        if e is not None:
            return self._create_account_exists(a, e)

        self._put(self.accounts, a.id, a.copy())
        self.commit_timestamp = a.timestamp
        return R.ok

    @staticmethod
    def _create_account_exists(a: Account, e: Account) -> CreateAccountResult:
        # state_machine.zig:1227-1237
        R = CreateAccountResult
        assert a.id == e.id
        if a.flags != e.flags:
            return R.exists_with_different_flags
        if a.user_data_128 != e.user_data_128:
            return R.exists_with_different_user_data_128
        if a.user_data_64 != e.user_data_64:
            return R.exists_with_different_user_data_64
        if a.user_data_32 != e.user_data_32:
            return R.exists_with_different_user_data_32
        if a.ledger != e.ledger:
            return R.exists_with_different_ledger
        if a.code != e.code:
            return R.exists_with_different_code
        return R.exists

    # -- create_transfer (state_machine.zig:1239-1368) -----------------------

    def create_transfer(self, t: Transfer) -> CreateTransferResult:
        R = CreateTransferResult
        F = TransferFlags
        assert t.timestamp > self.commit_timestamp

        if t.flags & F.PADDING_MASK:
            return R.reserved_flag
        if t.id == 0:
            return R.id_must_not_be_zero
        if t.id == U128_MAX:
            return R.id_must_not_be_int_max

        if t.flags & (F.POST_PENDING_TRANSFER | F.VOID_PENDING_TRANSFER):
            return self._post_or_void_pending_transfer(t)

        if t.debit_account_id == 0:
            return R.debit_account_id_must_not_be_zero
        if t.debit_account_id == U128_MAX:
            return R.debit_account_id_must_not_be_int_max
        if t.credit_account_id == 0:
            return R.credit_account_id_must_not_be_zero
        if t.credit_account_id == U128_MAX:
            return R.credit_account_id_must_not_be_int_max
        if t.credit_account_id == t.debit_account_id:
            return R.accounts_must_be_different
        if t.pending_id != 0:
            return R.pending_id_must_be_zero
        if not (t.flags & F.PENDING):
            if t.timeout != 0:
                return R.timeout_reserved_for_pending_transfer
        if not (t.flags & (F.BALANCING_DEBIT | F.BALANCING_CREDIT)):
            if t.amount == 0:
                return R.amount_must_not_be_zero
        if t.ledger == 0:
            return R.ledger_must_not_be_zero
        if t.code == 0:
            return R.code_must_not_be_zero

        dr = self.accounts.get(t.debit_account_id)
        if dr is None:
            return R.debit_account_not_found
        cr = self.accounts.get(t.credit_account_id)
        if cr is None:
            return R.credit_account_not_found

        if dr.ledger != cr.ledger:
            return R.accounts_must_have_the_same_ledger
        if t.ledger != dr.ledger:
            return R.transfer_must_have_the_same_ledger_as_accounts

        e = self.transfers.get(t.id)
        if e is not None:
            return self._create_transfer_exists(t, e)

        # Balancing amount clamp (state_machine.zig:1286-1306).
        amount = t.amount
        if t.flags & (F.BALANCING_DEBIT | F.BALANCING_CREDIT):
            if amount == 0:
                amount = U64_MAX
        if t.flags & F.BALANCING_DEBIT:
            dr_balance = dr.debits_posted + dr.debits_pending
            amount = min(amount, max(0, dr.credits_posted - dr_balance))
            if amount == 0:
                return R.exceeds_credits
        if t.flags & F.BALANCING_CREDIT:
            cr_balance = cr.credits_posted + cr.credits_pending
            amount = min(amount, max(0, cr.debits_posted - cr_balance))
            if amount == 0:
                return R.exceeds_debits

        # Overflow checks (state_machine.zig:1308-1322).
        if t.flags & F.PENDING:
            if sum_overflows(amount, dr.debits_pending, 128):
                return R.overflows_debits_pending
            if sum_overflows(amount, cr.credits_pending, 128):
                return R.overflows_credits_pending
        if sum_overflows(amount, dr.debits_posted, 128):
            return R.overflows_debits_posted
        if sum_overflows(amount, cr.credits_posted, 128):
            return R.overflows_credits_posted
        if sum_overflows(amount, dr.debits_pending + dr.debits_posted, 128):
            return R.overflows_debits
        if sum_overflows(amount, cr.credits_pending + cr.credits_posted, 128):
            return R.overflows_credits
        if sum_overflows(t.timestamp, t.timeout * NS_PER_S, 64):
            return R.overflows_timeout

        # Balance limits (tigerbeetle.zig:31-39, state_machine.zig:1323-1324).
        if (dr.flags & AccountFlags.DEBITS_MUST_NOT_EXCEED_CREDITS) and (
            dr.debits_pending + dr.debits_posted + amount > dr.credits_posted
        ):
            return R.exceeds_credits
        if (cr.flags & AccountFlags.CREDITS_MUST_NOT_EXCEED_DEBITS) and (
            cr.credits_pending + cr.credits_posted + amount > cr.debits_posted
        ):
            return R.exceeds_debits

        # Insert + balance updates (state_machine.zig:1326-1367).
        t2 = t.copy()
        t2.amount = amount
        self._put(self.transfers, t2.id, t2)

        self._record(self.accounts, dr.id)
        self._record(self.accounts, cr.id)
        dr = self.accounts[dr.id]
        cr = self.accounts[cr.id]
        if t.flags & F.PENDING:
            dr.debits_pending += amount
            cr.credits_pending += amount
        else:
            dr.debits_posted += amount
            cr.credits_posted += amount

        if (dr.flags & AccountFlags.HISTORY) or (cr.flags & AccountFlags.HISTORY):
            self._insert_history(t2.timestamp, dr, cr)

        self.commit_timestamp = t.timestamp
        return R.ok

    def _insert_history(self, timestamp: int, dr: Account, cr: Account) -> None:
        # state_machine.zig:1342-1364
        h = dict(
            timestamp=timestamp,
            dr_account_id=0, dr_debits_pending=0, dr_debits_posted=0,
            dr_credits_pending=0, dr_credits_posted=0,
            cr_account_id=0, cr_debits_pending=0, cr_debits_posted=0,
            cr_credits_pending=0, cr_credits_posted=0,
        )
        if dr.flags & AccountFlags.HISTORY:
            h.update(
                dr_account_id=dr.id,
                dr_debits_pending=dr.debits_pending,
                dr_debits_posted=dr.debits_posted,
                dr_credits_pending=dr.credits_pending,
                dr_credits_posted=dr.credits_posted,
            )
        if cr.flags & AccountFlags.HISTORY:
            h.update(
                cr_account_id=cr.id,
                cr_debits_pending=cr.debits_pending,
                cr_debits_posted=cr.debits_posted,
                cr_credits_pending=cr.credits_pending,
                cr_credits_posted=cr.credits_posted,
            )
        self._put(self.history, timestamp, h)

    @staticmethod
    def _create_transfer_exists(t: Transfer, e: Transfer) -> CreateTransferResult:
        # state_machine.zig:1370-1389
        R = CreateTransferResult
        assert t.id == e.id
        if t.flags != e.flags:
            return R.exists_with_different_flags
        if t.debit_account_id != e.debit_account_id:
            return R.exists_with_different_debit_account_id
        if t.credit_account_id != e.credit_account_id:
            return R.exists_with_different_credit_account_id
        if t.amount != e.amount:
            return R.exists_with_different_amount
        if t.user_data_128 != e.user_data_128:
            return R.exists_with_different_user_data_128
        if t.user_data_64 != e.user_data_64:
            return R.exists_with_different_user_data_64
        if t.user_data_32 != e.user_data_32:
            return R.exists_with_different_user_data_32
        if t.timeout != e.timeout:
            return R.exists_with_different_timeout
        if t.code != e.code:
            return R.exists_with_different_code
        return R.exists

    # -- post/void (state_machine.zig:1391-1498) -----------------------------

    def _post_or_void_pending_transfer(self, t: Transfer) -> CreateTransferResult:
        R = CreateTransferResult
        F = TransferFlags
        post = bool(t.flags & F.POST_PENDING_TRANSFER)
        void = bool(t.flags & F.VOID_PENDING_TRANSFER)
        assert post or void

        if post and void:
            return R.flags_are_mutually_exclusive
        if t.flags & F.PENDING:
            return R.flags_are_mutually_exclusive
        if t.flags & F.BALANCING_DEBIT:
            return R.flags_are_mutually_exclusive
        if t.flags & F.BALANCING_CREDIT:
            return R.flags_are_mutually_exclusive

        if t.pending_id == 0:
            return R.pending_id_must_not_be_zero
        if t.pending_id == U128_MAX:
            return R.pending_id_must_not_be_int_max
        if t.pending_id == t.id:
            return R.pending_id_must_be_different
        if t.timeout != 0:
            return R.timeout_reserved_for_pending_transfer

        p = self.transfers.get(t.pending_id)
        if p is None:
            return R.pending_transfer_not_found
        if not (p.flags & F.PENDING):
            return R.pending_transfer_not_pending

        dr = self.accounts[p.debit_account_id]
        cr = self.accounts[p.credit_account_id]

        if t.debit_account_id > 0 and t.debit_account_id != p.debit_account_id:
            return R.pending_transfer_has_different_debit_account_id
        if t.credit_account_id > 0 and t.credit_account_id != p.credit_account_id:
            return R.pending_transfer_has_different_credit_account_id
        if t.ledger > 0 and t.ledger != p.ledger:
            return R.pending_transfer_has_different_ledger
        if t.code > 0 and t.code != p.code:
            return R.pending_transfer_has_different_code

        amount = t.amount if t.amount > 0 else p.amount
        if amount > p.amount:
            return R.exceeds_pending_transfer_amount
        if void and amount < p.amount:
            return R.pending_transfer_has_different_amount

        e = self.transfers.get(t.id)
        if e is not None:
            return self._post_or_void_pending_transfer_exists(t, e, p)

        fulfillment = self.posted.get(p.timestamp)
        if fulfillment == "posted":
            return R.pending_transfer_already_posted
        if fulfillment == "voided":
            return R.pending_transfer_already_voided

        assert p.timestamp < t.timestamp
        if p.timeout > 0:
            if t.timestamp >= p.timestamp + p.timeout * NS_PER_S:
                return R.pending_transfer_expired

        # Insert the posting/voiding transfer (state_machine.zig:1455-1469).
        t2 = Transfer(
            id=t.id,
            debit_account_id=p.debit_account_id,
            credit_account_id=p.credit_account_id,
            amount=amount,
            pending_id=t.pending_id,
            user_data_128=t.user_data_128 if t.user_data_128 > 0 else p.user_data_128,
            user_data_64=t.user_data_64 if t.user_data_64 > 0 else p.user_data_64,
            user_data_32=t.user_data_32 if t.user_data_32 > 0 else p.user_data_32,
            timeout=0,
            ledger=p.ledger,
            code=p.code,
            flags=t.flags,
            timestamp=t.timestamp,
        )
        self._put(self.transfers, t2.id, t2)
        self._put(self.posted, p.timestamp, "posted" if post else "voided")

        self._record(self.accounts, dr.id)
        self._record(self.accounts, cr.id)
        dr = self.accounts[dr.id]
        cr = self.accounts[cr.id]
        dr.debits_pending -= p.amount
        cr.credits_pending -= p.amount
        if post:
            dr.debits_posted += amount
            cr.credits_posted += amount

        self.commit_timestamp = t.timestamp
        return R.ok

    @staticmethod
    def _post_or_void_pending_transfer_exists(
        t: Transfer, e: Transfer, p: Transfer
    ) -> CreateTransferResult:
        # state_machine.zig:1500-1561
        R = CreateTransferResult
        if t.flags != e.flags:
            return R.exists_with_different_flags
        if t.amount == 0:
            if e.amount != p.amount:
                return R.exists_with_different_amount
        else:
            if t.amount != e.amount:
                return R.exists_with_different_amount
        if t.pending_id != e.pending_id:
            return R.exists_with_different_pending_id
        if t.user_data_128 == 0:
            if e.user_data_128 != p.user_data_128:
                return R.exists_with_different_user_data_128
        else:
            if t.user_data_128 != e.user_data_128:
                return R.exists_with_different_user_data_128
        if t.user_data_64 == 0:
            if e.user_data_64 != p.user_data_64:
                return R.exists_with_different_user_data_64
        else:
            if t.user_data_64 != e.user_data_64:
                return R.exists_with_different_user_data_64
        if t.user_data_32 == 0:
            if e.user_data_32 != p.user_data_32:
                return R.exists_with_different_user_data_32
        else:
            if t.user_data_32 != e.user_data_32:
                return R.exists_with_different_user_data_32
        return R.exists

    # -- lookups (state_machine.zig:1091-1126) -------------------------------

    def lookup_accounts(self, ids: List[int]) -> List[Account]:
        return [self.accounts[i].copy() for i in ids if i in self.accounts]

    def lookup_transfers(self, ids: List[int]) -> List[Transfer]:
        return [self.transfers[i].copy() for i in ids if i in self.transfers]

    # -- queries (state_machine.zig:693-892, 1128-1195) ----------------------

    @staticmethod
    def _filter_window(
        account_id: int, ts_min: int, ts_max: int, limit: int, flags: int
    ) -> Optional[Tuple[int, int, bool]]:
        """get_scan_from_filter validity + effective window
        (state_machine.zig:823-837)."""
        valid = (
            account_id not in (0, U128_MAX)
            and ts_min != U64_MAX
            and ts_max != U64_MAX
            and (ts_max == 0 or ts_min <= ts_max)
            and limit != 0
            and flags & 0x3
            and flags & ~0x7 == 0
        )
        if not valid:
            return None
        return (ts_min or 1, ts_max or U64_MAX - 1, bool(flags & 0x4))

    def get_account_transfers(
        self, account_id: int, ts_min: int, ts_max: int, limit: int, flags: int
    ) -> List[Transfer]:
        window = self._filter_window(account_id, ts_min, ts_max, limit, flags)
        if window is None:
            return []
        lo, hi, descending = window
        matches = [
            t.copy()
            for t in self.transfers.values()
            if lo <= t.timestamp <= hi
            and (
                (flags & 0x1 and t.debit_account_id == account_id)
                or (flags & 0x2 and t.credit_account_id == account_id)
            )
        ]
        matches.sort(key=lambda t: t.timestamp, reverse=descending)
        return matches[:limit]

    def get_account_history(
        self, account_id: int, ts_min: int, ts_max: int, limit: int, flags: int
    ) -> List[Tuple[int, int, int, int, int]]:
        """(timestamp, dp, dpo, cp, cpo) rows, side-selected
        (execute_get_account_history, state_machine.zig:1149-1195)."""
        window = self._filter_window(account_id, ts_min, ts_max, limit, flags)
        if window is None:
            return []
        acct = self.accounts.get(account_id)
        if acct is None or not (acct.flags & AccountFlags.HISTORY):
            return []
        lo, hi, descending = window
        rows = []
        for ts in sorted(self.history, reverse=descending):
            if not lo <= ts <= hi:
                continue
            h = self.history[ts]
            # Side selection honors the DEBITS/CREDITS flags: the reference
            # resolves history rows through the transfers debit/credit index
            # scans (get_scan_from_filter, state_machine.zig:823-892).
            if flags & 0x1 and h["dr_account_id"] == account_id:
                rows.append((
                    ts, h["dr_debits_pending"], h["dr_debits_posted"],
                    h["dr_credits_pending"], h["dr_credits_posted"],
                ))
            elif flags & 0x2 and h["cr_account_id"] == account_id:
                rows.append((
                    ts, h["cr_debits_pending"], h["cr_debits_posted"],
                    h["cr_credits_pending"], h["cr_credits_posted"],
                ))
        return rows[:limit]

    # -- convenience entry points -------------------------------------------

    def create_accounts(self, events: List[Account], wall_clock_ns: int = 0):
        ts = self.prepare("create_accounts", len(events), wall_clock_ns)
        return self.execute("create_accounts", ts, events)

    def create_transfers(self, events: List[Transfer], wall_clock_ns: int = 0):
        ts = self.prepare("create_transfers", len(events), wall_clock_ns)
        return self.execute("create_transfers", ts, events)

    # -- parity digest -------------------------------------------------------

    def balances_snapshot(self) -> List[Tuple[int, int, int, int, int, int]]:
        """(id, dp, dposted, cp, cposted, ts) sorted by id — the parity check
        surface (the north star's 'byte-identical balances')."""
        return sorted(
            (
                a.id,
                a.debits_pending,
                a.debits_posted,
                a.credits_pending,
                a.credits_posted,
                a.timestamp,
            )
            for a in self.accounts.values()
        )
