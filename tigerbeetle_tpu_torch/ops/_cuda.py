"""Build, bind and launch the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` (each
``.cu`` to an object, all at once, then one shared library) into
``build/torch_kernels/`` at the repository root, named by a hash of the
sources, and loaded with ctypes.  Every pointer and the stream pass as
``c_void_p``.  Each C entry point launches on PyTorch's current stream and
returns ``cudaGetLastError()``; a wrapper raises on anything but 0.  A build
failure raises: there is no fallback.

The wrappers here take CUDA tensors only (the callers in ``hash_table`` and
``state_machine`` send CPU tensors to the plain PyTorch versions instead),
check device, dtype, shape and contiguity, allocate outputs and scratch, and
add one to their kernel's ``launches`` each time they launch it.

| kernel   | source                 | replaces (JAX package)                    |
|----------|------------------------|-------------------------------------------|
| probe    | csrc/probe.cu          | ops/hash_table.py:70 lookup (+gather_cols) |
| insert   | csrc/insert.cu         | ops/hash_table.py:114 claim_slots + :317 insert |
| validate | csrc/validate.cu       | ops/state_machine.py:349 account_codes, :491 transfer_codes |
| balance  | csrc/balance.cu        | ops/state_machine.py:574 balance_plan + :644 apply_balance_plan |
| digest   | csrc/digest.cu         | ops/state_machine.py:828 ledger_digest     |
| seq_transfers | csrc/sequential.cu | ops/scan_path.py:187 create_transfers_seq |
| seq_accounts  | csrc/sequential.cu | ops/scan_path.py:690 create_accounts_seq  |
| tombstone     | csrc/tombstone.cu  | ops/hash_table.py:379 remove_to_tombstone |
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how
    many times its wrapper launched it."""

    name: str
    source: str  # repository path of the CUDA source
    replaces: str  # file:line of the JAX function it replaces
    launches: int = 0


KERNELS: Dict[str, Kernel] = {
    k.name: k
    for k in (
        Kernel("probe", "tigerbeetle_tpu_torch/csrc/probe.cu",
               "tigerbeetle_tpu/ops/hash_table.py:70"),
        Kernel("insert", "tigerbeetle_tpu_torch/csrc/insert.cu",
               "tigerbeetle_tpu/ops/hash_table.py:114"),
        Kernel("validate", "tigerbeetle_tpu_torch/csrc/validate.cu",
               "tigerbeetle_tpu/ops/state_machine.py:491"),
        Kernel("balance", "tigerbeetle_tpu_torch/csrc/balance.cu",
               "tigerbeetle_tpu/ops/state_machine.py:574"),
        Kernel("digest", "tigerbeetle_tpu_torch/csrc/digest.cu",
               "tigerbeetle_tpu/ops/state_machine.py:828"),
        Kernel("seq_transfers", "tigerbeetle_tpu_torch/csrc/sequential.cu",
               "tigerbeetle_tpu/ops/scan_path.py:187"),
        Kernel("seq_accounts", "tigerbeetle_tpu_torch/csrc/sequential.cu",
               "tigerbeetle_tpu/ops/scan_path.py:690"),
        Kernel("tombstone", "tigerbeetle_tpu_torch/csrc/tombstone.cu",
               "tigerbeetle_tpu/ops/hash_table.py:379"),
    )
}


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


# -- build -----------------------------------------------------------------

_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libtb_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` (all at once) and link one shared library;
    a no-op when the library for these sources exists.  Raises on failure,
    with nvcc's output."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for src, _obj, proc in procs:
            text = proc.communicate()[0].decode(errors="replace")
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(lib),
             *(str(o) for _s, o, _p in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(lib, out)
    return out


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int


def _bind(lib: ctypes.CDLL) -> None:
    sigs = {
        "tb_probe": [_P, _P, _P, _I64, _INT, _I64, _P, _P, _I64, _I64,
                     _P, _P, _P, _INT, _P, _P, _P, _P],
        "tb_insert": [_P, _P, _P, _I64, _INT, _I64, _P, _P, _P, _I64,
                      _P, _P, _P, _P, _P, _P, _INT, _P, _P, _P, _P],
        "tb_validate_accounts": [_INT, _P, _I64, _I64, _P, _P, _P, _I64, _P],
        "tb_validate_transfers": [_INT, _P, _I64, _I64, ctypes.c_uint64,
                                  _P, _P, _P, _I64, _P],
        "tb_balance": [_P, _P, _P, _P, _P, _I64, _P, _P, _P, _P],
        "tb_digest": [_P, _P, _P, _I64, _P, _P],
        "tb_seq_transfers": [_P, _INT, _P, _INT, _I64, _P, _INT, _I64,
                             _P, _INT, _I64, _P, _INT, _I64, _I64, _I64,
                             ctypes.c_uint64, _P, _P, _P, _P],
        "tb_seq_accounts": [_P, _INT, _P, _INT, _I64, _I64, _I64,
                            ctypes.c_uint64, _P, _P, _P, _P],
        "tb_tombstone": [_P, _P, _P, _I64, _P, _P, _I64, _P, _P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _INT
    lib.tb_error_string.argtypes = [_INT]
    lib.tb_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        _bind(lib)
        _LIB = lib
    return _LIB


def build_seconds() -> float:
    """Build (or find) and load the library; the seconds it took."""
    t0 = time.perf_counter()
    library()
    return time.perf_counter() - t0


# -- helpers ---------------------------------------------------------------


def _check(t: torch.Tensor, dtype: torch.dtype, n: Optional[int] = None,
           what: str = "tensor") -> None:
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if n is not None and t.numel() != n:
        raise ValueError(f"{what} must have {n} elements, got {t.numel()}")


def _ptr_array(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * max(1, len(tensors)))(
        *[t.data_ptr() for t in tensors]
    )


def _width(t: torch.Tensor) -> int:
    return t.element_size()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        msg = library().tb_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed: error {err} ({msg})")


_U64_OR_U32 = (torch.int64, torch.int32, torch.bool)


# -- K1 probe --------------------------------------------------------------


def probe(tkey_lo, tkey_hi, tomb, table_cols: Dict[str, torch.Tensor],
          key_lo, key_hi, max_probe: int, hash_shift: int, count: int,
          names: Sequence[str]
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                     Dict[str, torch.Tensor]]:
    """Kernel K1: (found, slot, overflow, gathered columns)."""
    lib = library()
    cap = tkey_lo.numel()
    n = key_lo.numel()
    _check(tkey_lo, torch.int64, cap, "table key_lo")
    _check(tkey_hi, torch.int64, cap, "table key_hi")
    _check(tomb, torch.bool, cap, "table tombstone")
    _check(key_lo, torch.int64, n, "key_lo")
    _check(key_hi, torch.int64, n, "key_hi")
    src = [table_cols[name] for name in names]
    for name, s in zip(names, src):
        if s.dtype not in _U64_OR_U32:
            raise TypeError(f"column {name}: unsupported dtype {s.dtype}")
        _check(s, s.dtype, cap, f"column {name}")
    dev = key_lo.device
    found = torch.empty(n, dtype=torch.bool, device=dev)
    slot = torch.empty(n, dtype=torch.int64, device=dev)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    dst = [torch.empty(n, dtype=s.dtype, device=dev) for s in src]
    widths = (ctypes.c_int * max(1, len(src)))(*[_width(s) for s in src])
    err = lib.tb_probe(
        tkey_lo.data_ptr(), tkey_hi.data_ptr(), tomb.data_ptr(), cap,
        hash_shift, max_probe, key_lo.data_ptr(), key_hi.data_ptr(), n,
        count, found.data_ptr(), slot.data_ptr(), overflow.data_ptr(),
        len(src), _ptr_array(src), _ptr_array(dst), widths, _stream(key_lo),
    )
    _raise_on(err, "probe")
    KERNELS["probe"].launches += 1
    return found, slot, overflow[0] != 0, dict(zip(names, dst))


# -- K2 insert -------------------------------------------------------------


def insert(tkey_lo, tkey_hi, tomb, table_cols: Dict[str, torch.Tensor],
           count: torch.Tensor, probe_overflow: torch.Tensor,
           key_lo, key_hi, insert_mask, rows: Dict[str, torch.Tensor],
           max_probe: int, hash_shift: int) -> torch.Tensor:
    """Kernel K2: inserts in place; returns the claimed slots (C where
    unplaced)."""
    lib = library()
    cap = tkey_lo.numel()
    n = key_lo.numel()
    _check(tkey_lo, torch.int64, cap, "table key_lo")
    _check(tkey_hi, torch.int64, cap, "table key_hi")
    _check(tomb, torch.bool, cap, "table tombstone")
    _check(count, torch.int64, 1, "table count")
    _check(probe_overflow, torch.bool, 1, "table probe_overflow")
    _check(key_lo, torch.int64, n, "key_lo")
    _check(key_hi, torch.int64, n, "key_hi")
    _check(insert_mask, torch.bool, n, "insert_mask")
    names = list(table_cols)
    src, dst = [], []
    for name in names:
        d = table_cols[name]
        s = rows[name]
        if d.dtype not in _U64_OR_U32:
            raise TypeError(f"column {name}: unsupported dtype {d.dtype}")
        _check(d, d.dtype, cap, f"column {name}")
        _check(s, d.dtype, n, f"row {name}")
        src.append(s)
        dst.append(d)
    dev = key_lo.device
    claimed = torch.empty(n, dtype=torch.int64, device=dev)
    claim0 = torch.empty(cap, dtype=torch.int32, device=dev)
    claim1 = torch.empty(cap, dtype=torch.int32, device=dev)
    cnt = torch.zeros(3, dtype=torch.int32, device=dev)
    widths = (ctypes.c_int * max(1, len(src)))(*[_width(s) for s in src])
    err = lib.tb_insert(
        tkey_lo.data_ptr(), tkey_hi.data_ptr(), tomb.data_ptr(), cap,
        hash_shift, max_probe, key_lo.data_ptr(), key_hi.data_ptr(),
        insert_mask.data_ptr(), n, claimed.data_ptr(), claim0.data_ptr(),
        claim1.data_ptr(), cnt.data_ptr(), count.data_ptr(),
        probe_overflow.data_ptr(), len(src), _ptr_array(src), _ptr_array(dst),
        widths, _stream(key_lo),
    )
    _raise_on(err, "insert")
    KERNELS["insert"].launches += 1
    return claimed


# -- K3 validate -----------------------------------------------------------


def _hash_size(n: int) -> int:
    h = 2
    while h < 2 * n:
        h *= 2
    return h


def validate(variant: str, columns: Sequence[torch.Tensor], count: int,
             batch_timestamp: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K3 (``variant`` "accounts" or "transfers"): (codes int32[N],
    ok bool[N]).  ``columns`` follow the order of the kernel's column enum
    (state_machine's ``*_COLS`` tuples)."""
    lib = library()
    n = columns[0].numel()
    for k, c in enumerate(columns):
        if c.dtype not in _U64_OR_U32:
            raise TypeError(f"validate column {k}: unsupported dtype {c.dtype}")
        _check(c, c.dtype, n, f"validate column {k}")
    dev = columns[0].device
    hsize = _hash_size(n)
    codes = torch.empty(n, dtype=torch.int32, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    scratch = torch.empty(2 * hsize + 3 * n, dtype=torch.int32, device=dev)
    ptrs = _ptr_array(columns)
    stream = _stream(columns[0])
    if variant == "accounts":
        err = lib.tb_validate_accounts(
            len(columns), ptrs, n, count, codes.data_ptr(), ok.data_ptr(),
            scratch.data_ptr(), hsize, stream,
        )
    elif variant == "transfers":
        err = lib.tb_validate_transfers(
            len(columns), ptrs, n, count, batch_timestamp & ((1 << 64) - 1),
            codes.data_ptr(), ok.data_ptr(), scratch.data_ptr(), hsize, stream,
        )
    else:
        raise ValueError(f"unknown validate variant {variant!r}")
    _raise_on(err, "validate")
    KERNELS["validate"].launches += 1
    return codes, ok


# -- K4 balance ------------------------------------------------------------


def balance(dr_slot, cr_slot, ok, amount_lo, pending,
            balance_cols: Sequence[torch.Tensor]) -> None:
    """Kernel K4: adds every accepted transfer's amount to its debit and
    credit accounts' balance columns, in place.  ``balance_cols`` are the
    eight u64 columns debits_pending lo/hi, debits_posted lo/hi,
    credits_pending lo/hi, credits_posted lo/hi."""
    lib = library()
    n = ok.numel()
    _check(dr_slot, torch.int64, n, "dr_slot")
    _check(cr_slot, torch.int64, n, "cr_slot")
    _check(ok, torch.bool, n, "ok")
    _check(amount_lo, torch.int64, n, "amount_lo")
    _check(pending, torch.bool, n, "pending")
    if len(balance_cols) != 8:
        raise ValueError("balance needs the eight balance columns")
    cap = balance_cols[0].numel()
    for c in balance_cols:
        _check(c, torch.int64, cap, "balance column")
    dev = ok.device
    limbs = torch.zeros(cap * 8, dtype=torch.int64, device=dev)
    taken = torch.zeros(cap, dtype=torch.int32, device=dev)
    err = lib.tb_balance(
        dr_slot.data_ptr(), cr_slot.data_ptr(), ok.data_ptr(),
        amount_lo.data_ptr(), pending.data_ptr(), n, limbs.data_ptr(),
        taken.data_ptr(), _ptr_array(balance_cols), _stream(ok),
    )
    _raise_on(err, "balance")
    KERNELS["balance"].launches += 1


# -- K5 digest -------------------------------------------------------------


def digest(key_lo, key_hi, cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Kernel K5: the wrapping u64 digest sum, as a 0-dim int64 tensor.
    ``cols`` are the eight balance columns in ledger order, then
    ``timestamp``."""
    lib = library()
    cap = key_lo.numel()
    _check(key_lo, torch.int64, cap, "key_lo")
    _check(key_hi, torch.int64, cap, "key_hi")
    if len(cols) != 9:
        raise ValueError("digest needs eight balance columns and timestamp")
    for c in cols:
        _check(c, torch.int64, cap, "digest column")
    out = torch.zeros(1, dtype=torch.int64, device=key_lo.device)
    err = lib.tb_digest(
        key_lo.data_ptr(), key_hi.data_ptr(), _ptr_array(cols), cap,
        out.data_ptr(), _stream(key_lo),
    )
    _raise_on(err, "digest")
    KERNELS["digest"].launches += 1
    return out[0]


# -- K6/K7 sequential commit -----------------------------------------------

# u64 words of one event's undo record in K6 (csrc/sequential.cu UNDO_WORDS).
_UNDO_WORDS = 21


def _check_cols(cols: Sequence[torch.Tensor], dtypes: Sequence[torch.dtype],
                n: int, what: str) -> None:
    if len(cols) != len(dtypes):
        raise ValueError(f"{what}: {len(cols)} columns, expected {len(dtypes)}")
    for k, (c, dt) in enumerate(zip(cols, dtypes)):
        _check(c, dt, n, f"{what} column {k}")


def _check_table(t: Sequence[torch.Tensor], dtypes: Sequence[torch.dtype],
                 what: str) -> int:
    """``t``: key_lo, key_hi, tombstone, count, then the value columns.
    Returns the capacity."""
    cap = t[0].numel()
    if cap <= 0 or cap & (cap - 1):
        raise ValueError(f"{what}: capacity {cap} is not a power of two")
    _check_cols(t[:3], (torch.int64, torch.int64, torch.bool), cap,
                f"{what} keys")
    _check(t[3], torch.int64, 1, f"{what} count")
    _check_cols(t[4:], dtypes, cap, what)
    return cap


def seq_transfers(batch: Sequence[torch.Tensor], batch_dtypes,
                  accounts: Sequence[torch.Tensor], account_dtypes,
                  transfers: Sequence[torch.Tensor], transfer_dtypes,
                  posted: Sequence[torch.Tensor],
                  history: Sequence[torch.Tensor],
                  count: int, timestamp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K6: one sequential create_transfers batch, the ledger updated
    in place.  Each table is key_lo, key_hi, tombstone, count and its
    columns in the kernel's enum order; ``history`` is its 21 columns then
    its count.  Returns (codes int32[N], overflow bool 0-dim)."""
    lib = library()
    n = batch[0].numel()
    _check_cols(batch, batch_dtypes, n, "batch")
    acc_cap = _check_table(accounts, account_dtypes, "accounts")
    xfr_cap = _check_table(transfers, transfer_dtypes, "transfers")
    pst_cap = _check_table(posted, (torch.int32,), "posted")
    hist_cap = history[0].numel()
    _check_cols(history[:-1], [torch.int64] * (len(history) - 1), hist_cap,
                "history")
    _check(history[-1], torch.int64, 1, "history count")
    if not 0 <= count <= n:
        raise ValueError(f"count {count} outside 0..{n}")
    dev = batch[0].device
    undo = torch.empty(n * _UNDO_WORDS, dtype=torch.int64, device=dev)
    codes = torch.empty(n, dtype=torch.int32, device=dev)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    err = lib.tb_seq_transfers(
        _ptr_array(batch), len(batch), _ptr_array(accounts), len(accounts),
        acc_cap, _ptr_array(transfers), len(transfers), xfr_cap,
        _ptr_array(posted), len(posted), pst_cap, _ptr_array(history),
        len(history), hist_cap, n, count, timestamp & ((1 << 64) - 1),
        undo.data_ptr(), codes.data_ptr(), overflow.data_ptr(),
        _stream(batch[0]),
    )
    _raise_on(err, "seq_transfers")
    KERNELS["seq_transfers"].launches += 1
    return codes, overflow[0] != 0


def seq_accounts(batch: Sequence[torch.Tensor], batch_dtypes,
                 accounts: Sequence[torch.Tensor], account_dtypes,
                 count: int, timestamp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K7: one sequential create_accounts batch, the accounts table
    updated in place.  Returns (codes int32[N], overflow bool 0-dim)."""
    lib = library()
    n = batch[0].numel()
    _check_cols(batch, batch_dtypes, n, "batch")
    acc_cap = _check_table(accounts, account_dtypes, "accounts")
    if not 0 <= count <= n:
        raise ValueError(f"count {count} outside 0..{n}")
    dev = batch[0].device
    undo = torch.empty(n, dtype=torch.int64, device=dev)
    codes = torch.empty(n, dtype=torch.int32, device=dev)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    err = lib.tb_seq_accounts(
        _ptr_array(batch), len(batch), _ptr_array(accounts), len(accounts),
        acc_cap, n, count, timestamp & ((1 << 64) - 1), undo.data_ptr(),
        codes.data_ptr(), overflow.data_ptr(), _stream(batch[0]),
    )
    _raise_on(err, "seq_accounts")
    KERNELS["seq_accounts"].launches += 1
    return codes, overflow[0] != 0


# -- K8 tombstone ------------------------------------------------------------


def tombstone(key_lo, key_hi, tomb, count, slot, valid) -> None:
    """Kernel K8: clear the keys at ``slot`` where ``valid``, leaving
    tombstones, and subtract the valid lanes from ``count``, in place."""
    lib = library()
    cap = key_lo.numel()
    n = slot.numel()
    _check(key_lo, torch.int64, cap, "table key_lo")
    _check(key_hi, torch.int64, cap, "table key_hi")
    _check(tomb, torch.bool, cap, "table tombstone")
    _check(count, torch.int64, 1, "table count")
    _check(slot, torch.int64, n, "slot")
    _check(valid, torch.bool, n, "valid")
    err = lib.tb_tombstone(
        key_lo.data_ptr(), key_hi.data_ptr(), tomb.data_ptr(), cap,
        slot.data_ptr(), valid.data_ptr(), n, count.data_ptr(), _stream(slot),
    )
    _raise_on(err, "tombstone")
    KERNELS["tombstone"].launches += 1
