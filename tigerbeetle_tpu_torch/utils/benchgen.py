"""Host (numpy) generator of the flagship benchmark's plain-transfer batches.

Copies of ``bench.py``'s ``mix64_np`` and ``gen_batch_np``, bit for bit: the
same batch index gives the same transfers in both packages; a numpy copy of
its on-device ``--two-phase`` generator ``gen_two_phase``; and of its
``--limits`` set-up (limit-flagged accounts plus one funder, then a funding
transfer of 2**40 to each), after which the steady state is
``gen_batch_np``.  The batches are
made on the host because numpy's uint64 ``%`` is exact; torch's int64 ``%``
is signed and wrong above 2**63.

``gen_batch`` makes the same batches on the device, from the batch index
alone, as bench.py's timed loop does (``bench.py:2129`` ``mix_workload``,
``:2140`` ``gen_batch``, ``:2169`` ``gen_two_phase``); ``gen_twop`` is
``tigerbeetle_tpu/utils/benchgen.py``'s ``gen_twop`` (its ``gen_plain`` is
``gen_batch`` with ``first_tid`` for ``id_base``).  On a CUDA device they
launch kernel K20 (``csrc/bench_gen.cu``), which takes the u64 modulo
natively; on the CPU ``gen_batch_plain`` computes it exactly from the
hash's 32-bit halves, ``((hi mod n)(2**32 mod n) + lo) mod n``, which fits
an int64 for every ``n < 2**31``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import types
from ..device import resolve as resolve_device
from ..ops import _cuda
from ..u128 import i64, mix64, srl


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


# -- the device generator (kernel K20) -----------------------------------------

MODE_PLAIN = 0  # bench.py gen_batch; utils/benchgen.py gen_plain
MODE_TWO_PHASE = 1  # bench.py gen_two_phase
MODE_TWOP = 2  # utils/benchgen.py gen_twop

# The transfer SoA in K20's column order: the u64 columns, then the u32 ones.
GEN_COLS_U64 = (
    "id_lo", "id_hi", "debit_account_id_lo", "debit_account_id_hi",
    "credit_account_id_lo", "credit_account_id_hi", "amount_lo", "amount_hi",
    "pending_id_lo", "pending_id_hi", "user_data_128_lo", "user_data_128_hi",
    "user_data_64", "timestamp",
)
GEN_COLS_U32 = ("user_data_32", "timeout", "ledger", "code", "flags")
GEN_COLS = GEN_COLS_U64 + GEN_COLS_U32

_TF_PENDING = int(types.TransferFlags.PENDING)
_TF_POST = int(types.TransferFlags.POST_PENDING_TRANSFER)


def empty_soa(lanes: int, device) -> Dict[str, torch.Tensor]:
    """An uninitialised transfer SoA of ``lanes`` lanes, in
    ``types.TRANSFER_DTYPE``'s field order (int64 for u64, int32 for u32)."""
    return {name: torch.empty(lanes, dtype=torch.int64 if name in GEN_COLS_U64
                              else torch.int32, device=device)
            for name in types.TRANSFER_DTYPE.names}


def _check_args(b: int, lanes: int, count: int, n_accounts: int) -> None:
    if not 2 <= n_accounts < (1 << 31):
        raise ValueError(f"n_accounts must be in [2, 2**31), got {n_accounts}")
    if not 0 <= count <= lanes:
        raise ValueError(f"count {count} must be in [0, lanes={lanes}]")
    if b < 0:
        raise ValueError(f"batch index must be >= 0, got {b}")


def _generate(mode: int, b: int, lanes: int, count: int, n_accounts: int,
              first_tid: int, device, out) -> Dict[str, torch.Tensor]:
    _check_args(b, lanes, count, n_accounts)
    if out is None:
        out = empty_soa(lanes, resolve_device(device))
    if out["id_lo"].is_cuda:
        _cuda.bench_gen([out[c] for c in GEN_COLS], mode, b, count,
                        n_accounts, first_tid)
        return out
    plain = gen_batch_plain(mode, b, lanes, count, n_accounts, first_tid,
                            out["id_lo"].device)
    for name, col in plain.items():
        out[name].copy_(col)
    return out


def gen_batch(b: int, lanes: int, count: int, n_accounts: int,
              first_tid: int, two_phase: bool = False, *, device=None,
              out: Optional[Dict[str, torch.Tensor]] = None,
              ) -> Dict[str, torch.Tensor]:
    """Batch ``b`` of the flagship workload (or of ``--two-phase``) as a
    transfer SoA of ``lanes`` lanes on ``device`` (``cuda`` when None):
    ``types.to_soa`` of ``gen_batch_np`` (``gen_two_phase_np``) zero-padded
    to ``lanes``.  ``out``, a SoA from ``empty_soa``, is overwritten in
    place and returned.  Kernel K20 on the card."""
    mode = MODE_TWO_PHASE if two_phase else MODE_PLAIN
    return _generate(mode, b, lanes, count, n_accounts, first_tid, device, out)


def gen_twop(b: int, lanes: int, count: int, n_accounts: int,
             id_base: int = 1 << 36, *, device=None,
             out: Optional[Dict[str, torch.Tensor]] = None,
             ) -> Dict[str, torch.Tensor]:
    """The measurement tools' two-phase batch (``tigerbeetle_tpu/utils/
    benchgen.py:54`` ``gen_twop``): half pendings between accounts
    ``dr = h1 mod n`` and ``dr + 3``, amounts ``1 + (h1 & 0xFF)``, half posts
    of them.  Kernel K20 on the card."""
    return _generate(MODE_TWOP, b, lanes, count, n_accounts, id_base, device,
                     out)


def _mod_u64(h: torch.Tensor, n: int) -> torch.Tensor:
    """Exact ``h mod n`` of the u64 bits in an int64 tensor, for
    ``0 < n < 2**31``: every term stays below 2**63."""
    hi = srl(h, 32)
    lo = h & 0xFFFFFFFF
    return ((hi % n) * ((1 << 32) % n) + lo) % n


def gen_batch_plain(mode: int, b: int, lanes: int, count: int,
                    n_accounts: int, first_tid: int,
                    device) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of kernel K20 (every ``MODE_*``)."""
    _check_args(b, lanes, count, n_accounts)
    n = n_accounts
    lane = torch.arange(lanes, dtype=torch.int64, device=device)
    base = i64(b * count)
    tid0 = i64(first_tid)
    half = count // 2
    if mode == MODE_PLAIN:
        is_post = torch.zeros(lanes, dtype=torch.bool, device=device)
        gid = lane + base
        active = lane < count
    else:
        is_post = lane >= half
        gid = base + torch.where(is_post, lane - half, lane)
        active = lane < 2 * half
    h1 = mix64(gid, torch.full_like(gid, 0x1234))
    dr = _mod_u64(h1, n)
    if mode == MODE_TWOP:
        cr = (dr + 3) % n
        amount = 1 + (h1 & 0xFF)
    else:
        h2 = mix64(gid, torch.full_like(gid, 0x9876))
        off = 1 + _mod_u64(h2, n - 1)
        cr = (dr + off) % n
        amount = 1 + (srl(h1, 32) & 0xFFFF)
    create = active & ~is_post
    post = active & is_post
    z64 = torch.zeros(lanes, dtype=torch.int64, device=device)
    z32 = torch.zeros(lanes, dtype=torch.int32, device=device)
    if mode == MODE_PLAIN:
        flags = z32
    else:
        flags = torch.where(active, torch.where(is_post, _TF_POST, _TF_PENDING),
                            0).to(torch.int32)
    out = {
        "id_lo": torch.where(active, tid0 + base + lane, z64),
        "debit_account_id_lo": torch.where(create, dr + 1, z64),
        "credit_account_id_lo": torch.where(create, cr + 1, z64),
        "amount_lo": torch.where(create, amount, z64),
        "pending_id_lo": torch.where(post, tid0 + base + (lane - half), z64),
        "ledger": torch.where(create, 1, 0).to(torch.int32),
        "code": torch.where(create, 10, 0).to(torch.int32),
        "flags": flags,
    }
    return {name: out.get(name, z64 if name in GEN_COLS_U64 else z32)
            for name in types.TRANSFER_DTYPE.names}
