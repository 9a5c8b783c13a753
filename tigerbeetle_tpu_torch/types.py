"""Core data model: fixed-layout wire/disk types and their SoA device representation.

Mirrors the reference data model byte-for-byte (reference: src/tigerbeetle.zig):

- ``Account``  — 128-byte extern struct (tigerbeetle.zig:7-40)
- ``Transfer`` — 128-byte extern struct (tigerbeetle.zig:80-105)
- ``AccountFlags`` / ``TransferFlags`` — packed u16 (tigerbeetle.zig:42-63, 107-120)
- ``CreateAccountResult`` / ``CreateTransferResult`` — precedence-ordered u32 enums
  (tigerbeetle.zig:125-245); smaller value = higher precedence, and the enum order
  matches the sequential check order of ``create_account``/``create_transfer``
  (state_machine.zig:1198-1368), which is what lets the vectorized kernel compute a
  result as a *minimum* over independently-evaluated failure masks.
- ``CreateAccountsResult`` / ``CreateTransfersResult`` — 8-byte (index, result) pairs
  (tigerbeetle.zig:247-265)
- ``AccountFilter`` — 64-byte query filter (tigerbeetle.zig:268-302)

TPU-first design notes
----------------------
u128 fields are represented as two little-endian u64 lanes (``*_lo``, ``*_hi``):
JAX/XLA has no 128-bit integer type, and TPU integer units are 32-bit — u64 is
already emulated as a pair of u32, so (lo, hi) u64 lanes compile to four u32 lanes
with carry chains that XLA fuses well.  The numpy structured dtypes below have the
exact 128-byte little-endian layout of the Zig extern structs, so ``np.frombuffer``
on wire/WAL bytes *is* the deserializer (zero-copy), and ``.tobytes()`` is the
serializer.

The batch representation handed to device kernels is a struct-of-arrays (SoA)
dict of plain ``uint64``/``uint32`` arrays — column-major access is what the VPU
wants, and it sidesteps any struct layout on device.
"""

from __future__ import annotations

import enum
from typing import Any, Dict

import numpy as np

U64_MAX = np.uint64(0xFFFF_FFFF_FFFF_FFFF)
U128_MAX = (1 << 128) - 1

# ---------------------------------------------------------------------------
# Wire/disk structured dtypes (byte-compatible with the Zig extern structs).
# ---------------------------------------------------------------------------

# Account: tigerbeetle.zig:7-29 (asserted @sizeOf == 128, no padding).
ACCOUNT_DTYPE = np.dtype(
    [
        ("id_lo", "<u8"),
        ("id_hi", "<u8"),
        ("debits_pending_lo", "<u8"),
        ("debits_pending_hi", "<u8"),
        ("debits_posted_lo", "<u8"),
        ("debits_posted_hi", "<u8"),
        ("credits_pending_lo", "<u8"),
        ("credits_pending_hi", "<u8"),
        ("credits_posted_lo", "<u8"),
        ("credits_posted_hi", "<u8"),
        ("user_data_128_lo", "<u8"),
        ("user_data_128_hi", "<u8"),
        ("user_data_64", "<u8"),
        ("user_data_32", "<u4"),
        ("reserved", "<u4"),
        ("ledger", "<u4"),
        ("code", "<u2"),
        ("flags", "<u2"),
        ("timestamp", "<u8"),
    ]
)
assert ACCOUNT_DTYPE.itemsize == 128

# Transfer: tigerbeetle.zig:80-105 (asserted @sizeOf == 128, no padding).
TRANSFER_DTYPE = np.dtype(
    [
        ("id_lo", "<u8"),
        ("id_hi", "<u8"),
        ("debit_account_id_lo", "<u8"),
        ("debit_account_id_hi", "<u8"),
        ("credit_account_id_lo", "<u8"),
        ("credit_account_id_hi", "<u8"),
        ("amount_lo", "<u8"),
        ("amount_hi", "<u8"),
        ("pending_id_lo", "<u8"),
        ("pending_id_hi", "<u8"),
        ("user_data_128_lo", "<u8"),
        ("user_data_128_hi", "<u8"),
        ("user_data_64", "<u8"),
        ("user_data_32", "<u4"),
        ("timeout", "<u4"),
        ("ledger", "<u4"),
        ("code", "<u2"),
        ("flags", "<u2"),
        ("timestamp", "<u8"),
    ]
)
assert TRANSFER_DTYPE.itemsize == 128

# AccountBalance: tigerbeetle.zig:65-78 (128 bytes, 56 reserved).
ACCOUNT_BALANCE_DTYPE = np.dtype(
    [
        ("debits_pending_lo", "<u8"),
        ("debits_pending_hi", "<u8"),
        ("debits_posted_lo", "<u8"),
        ("debits_posted_hi", "<u8"),
        ("credits_pending_lo", "<u8"),
        ("credits_pending_hi", "<u8"),
        ("credits_posted_lo", "<u8"),
        ("credits_posted_hi", "<u8"),
        ("timestamp", "<u8"),
        ("reserved", "V56"),
    ]
)
assert ACCOUNT_BALANCE_DTYPE.itemsize == 128

# CreateAccountsResult / CreateTransfersResult: tigerbeetle.zig:247-265 (8 bytes).
EVENT_RESULT_DTYPE = np.dtype([("index", "<u4"), ("result", "<u4")])
assert EVENT_RESULT_DTYPE.itemsize == 8

# AccountFilter: tigerbeetle.zig:268-287 (64 bytes).
ACCOUNT_FILTER_DTYPE = np.dtype(
    [
        ("account_id_lo", "<u8"),
        ("account_id_hi", "<u8"),
        ("timestamp_min", "<u8"),
        ("timestamp_max", "<u8"),
        ("limit", "<u4"),
        ("flags", "<u4"),
        ("reserved", "V24"),
    ]
)
assert ACCOUNT_FILTER_DTYPE.itemsize == 64


# ---------------------------------------------------------------------------
# Flags (packed u16 bit layouts, tigerbeetle.zig:42-63 and 107-120).
# ---------------------------------------------------------------------------


class AccountFlags(enum.IntFlag):
    """tigerbeetle.zig:42-63. Bits beyond HISTORY are reserved padding."""

    LINKED = 1 << 0
    DEBITS_MUST_NOT_EXCEED_CREDITS = 1 << 1
    CREDITS_MUST_NOT_EXCEED_DEBITS = 1 << 2
    HISTORY = 1 << 3

    PADDING_MASK = 0xFFF0  # padding: u12


class TransferFlags(enum.IntFlag):
    """tigerbeetle.zig:107-120. Bits beyond BALANCING_CREDIT are reserved padding."""

    LINKED = 1 << 0
    PENDING = 1 << 1
    POST_PENDING_TRANSFER = 1 << 2
    VOID_PENDING_TRANSFER = 1 << 3
    BALANCING_DEBIT = 1 << 4
    BALANCING_CREDIT = 1 << 5

    PADDING_MASK = 0xFFC0  # padding: u10


class AccountFilterFlags(enum.IntFlag):
    """tigerbeetle.zig:289-302."""

    DEBITS = 1 << 0
    CREDITS = 1 << 1
    REVERSED = 1 << 2

    PADDING_MASK = 0xFFFF_FFF8


# ---------------------------------------------------------------------------
# Result enums — precedence-ordered (tigerbeetle.zig:122-124: "Error codes are
# ordered by descending precedence"). DO NOT renumber.
# ---------------------------------------------------------------------------


class CreateAccountResult(enum.IntEnum):
    """tigerbeetle.zig:125-160."""

    ok = 0
    linked_event_failed = 1
    linked_event_chain_open = 2
    timestamp_must_be_zero = 3
    reserved_field = 4
    reserved_flag = 5
    id_must_not_be_zero = 6
    id_must_not_be_int_max = 7
    flags_are_mutually_exclusive = 8
    debits_pending_must_be_zero = 9
    debits_posted_must_be_zero = 10
    credits_pending_must_be_zero = 11
    credits_posted_must_be_zero = 12
    ledger_must_not_be_zero = 13
    code_must_not_be_zero = 14
    exists_with_different_flags = 15
    exists_with_different_user_data_128 = 16
    exists_with_different_user_data_64 = 17
    exists_with_different_user_data_32 = 18
    exists_with_different_ledger = 19
    exists_with_different_code = 20
    exists = 21


class CreateTransferResult(enum.IntEnum):
    """tigerbeetle.zig:165-245."""

    ok = 0
    linked_event_failed = 1
    linked_event_chain_open = 2
    timestamp_must_be_zero = 3
    reserved_flag = 4
    id_must_not_be_zero = 5
    id_must_not_be_int_max = 6
    flags_are_mutually_exclusive = 7
    debit_account_id_must_not_be_zero = 8
    debit_account_id_must_not_be_int_max = 9
    credit_account_id_must_not_be_zero = 10
    credit_account_id_must_not_be_int_max = 11
    accounts_must_be_different = 12
    pending_id_must_be_zero = 13
    pending_id_must_not_be_zero = 14
    pending_id_must_not_be_int_max = 15
    pending_id_must_be_different = 16
    timeout_reserved_for_pending_transfer = 17
    amount_must_not_be_zero = 18
    ledger_must_not_be_zero = 19
    code_must_not_be_zero = 20
    debit_account_not_found = 21
    credit_account_not_found = 22
    accounts_must_have_the_same_ledger = 23
    transfer_must_have_the_same_ledger_as_accounts = 24
    pending_transfer_not_found = 25
    pending_transfer_not_pending = 26
    pending_transfer_has_different_debit_account_id = 27
    pending_transfer_has_different_credit_account_id = 28
    pending_transfer_has_different_ledger = 29
    pending_transfer_has_different_code = 30
    exceeds_pending_transfer_amount = 31
    pending_transfer_has_different_amount = 32
    pending_transfer_already_posted = 33
    pending_transfer_already_voided = 34
    pending_transfer_expired = 35
    exists_with_different_flags = 36
    exists_with_different_debit_account_id = 37
    exists_with_different_credit_account_id = 38
    exists_with_different_amount = 39
    exists_with_different_pending_id = 40
    exists_with_different_user_data_128 = 41
    exists_with_different_user_data_64 = 42
    exists_with_different_user_data_32 = 43
    exists_with_different_timeout = 44
    exists_with_different_code = 45
    exists = 46
    overflows_debits_pending = 47
    overflows_credits_pending = 48
    overflows_debits_posted = 49
    overflows_credits_posted = 50
    overflows_debits = 51
    overflows_credits = 52
    overflows_timeout = 53
    exceeds_credits = 54
    exceeds_debits = 55


# ---------------------------------------------------------------------------
# Python-side u128 <-> lane helpers.
# ---------------------------------------------------------------------------


def u128_split(value: int) -> tuple[int, int]:
    """Split a Python int (< 2**128) into (lo, hi) u64 lanes."""
    assert 0 <= value <= U128_MAX
    return value & 0xFFFF_FFFF_FFFF_FFFF, value >> 64


def u128_join(lo: int, hi: int) -> int:
    return (int(hi) << 64) | int(lo)


# ---------------------------------------------------------------------------
# Record constructors (host side). These build one structured-array row from
# Python ints, applying the same defaults as the Zig struct initializers.
# ---------------------------------------------------------------------------


def account(
    *,
    id: int,
    debits_pending: int = 0,
    debits_posted: int = 0,
    credits_pending: int = 0,
    credits_posted: int = 0,
    user_data_128: int = 0,
    user_data_64: int = 0,
    user_data_32: int = 0,
    reserved: int = 0,
    ledger: int = 0,
    code: int = 0,
    flags: int = 0,
    timestamp: int = 0,
) -> np.void:
    row = np.zeros((), dtype=ACCOUNT_DTYPE)
    row["id_lo"], row["id_hi"] = u128_split(id)
    row["debits_pending_lo"], row["debits_pending_hi"] = u128_split(debits_pending)
    row["debits_posted_lo"], row["debits_posted_hi"] = u128_split(debits_posted)
    row["credits_pending_lo"], row["credits_pending_hi"] = u128_split(credits_pending)
    row["credits_posted_lo"], row["credits_posted_hi"] = u128_split(credits_posted)
    row["user_data_128_lo"], row["user_data_128_hi"] = u128_split(user_data_128)
    row["user_data_64"] = user_data_64
    row["user_data_32"] = user_data_32
    row["reserved"] = reserved
    row["ledger"] = ledger
    row["code"] = code
    row["flags"] = flags
    row["timestamp"] = timestamp
    return row[()]


def transfer(
    *,
    id: int,
    debit_account_id: int = 0,
    credit_account_id: int = 0,
    amount: int = 0,
    pending_id: int = 0,
    user_data_128: int = 0,
    user_data_64: int = 0,
    user_data_32: int = 0,
    timeout: int = 0,
    ledger: int = 0,
    code: int = 0,
    flags: int = 0,
    timestamp: int = 0,
) -> np.void:
    row = np.zeros((), dtype=TRANSFER_DTYPE)
    row["id_lo"], row["id_hi"] = u128_split(id)
    row["debit_account_id_lo"], row["debit_account_id_hi"] = u128_split(debit_account_id)
    row["credit_account_id_lo"], row["credit_account_id_hi"] = u128_split(credit_account_id)
    row["amount_lo"], row["amount_hi"] = u128_split(amount)
    row["pending_id_lo"], row["pending_id_hi"] = u128_split(pending_id)
    row["user_data_128_lo"], row["user_data_128_hi"] = u128_split(user_data_128)
    row["user_data_64"] = user_data_64
    row["user_data_32"] = user_data_32
    row["timeout"] = timeout
    row["ledger"] = ledger
    row["code"] = code
    row["flags"] = flags
    row["timestamp"] = timestamp
    return row[()]


def transfers_array(rows) -> np.ndarray:
    """Stack transfer rows (as returned by :func:`transfer`) into an (N,) array."""
    out = np.zeros(len(rows), dtype=TRANSFER_DTYPE)
    for i, r in enumerate(rows):
        out[i] = r
    return out


def accounts_array(rows) -> np.ndarray:
    out = np.zeros(len(rows), dtype=ACCOUNT_DTYPE)
    for i, r in enumerate(rows):
        out[i] = r
    return out


# ---------------------------------------------------------------------------
# SoA conversion: structured array -> dict of plain columns (device-friendly).
# ---------------------------------------------------------------------------


def to_soa(batch: np.ndarray) -> Dict[str, np.ndarray]:
    """Convert a structured array batch into a dict of contiguous columns.

    Sub-u64 integer columns are widened to u32 (TPU-native lane width); u64
    stays u64 (XLA lowers to u32 pairs).  The result is what device kernels
    consume directly — field names match the dtype's field names.
    """
    out: Dict[str, np.ndarray] = {}
    for name in batch.dtype.names:
        col = np.ascontiguousarray(batch[name])
        if col.dtype == np.uint16:
            col = col.astype(np.uint32)
        out[name] = col
    return out


def from_soa(columns: Dict[str, Any], dtype: np.dtype) -> np.ndarray:
    """Inverse of :func:`to_soa` — reassemble the wire-layout structured array."""
    names = dtype.names
    n = len(np.asarray(columns[names[0]]))
    out = np.zeros(n, dtype=dtype)
    for name in names:
        out[name] = np.asarray(columns[name]).astype(dtype.fields[name][0])
    return out
