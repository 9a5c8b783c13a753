"""Checkpoint snapshots: durable images of the device-resident ledger.

The reference persists state-machine data through the LSM forest into grid
blocks at every checkpoint (replica.zig:3153-3169).  Here the working set is
the HBM ledger itself, so a checkpoint is: device→host transfer of the table
arrays, one atomically-written compressed snapshot file per checkpoint op, and
the snapshot's whole-file AEGIS checksum + state-machine digest recorded in
the superblock (superblock.py).  Restart = load snapshot (verify checksum) +
replay WAL ops beyond the checkpoint (journal.py).

Snapshot files live next to the data file as ``<data>.checkpoint.<op>``;
the previous snapshot is removed only after the superblock referencing the
new one is durable.

(Port of ``tigerbeetle_tpu/vsr/checkpoint.py``: the same file format, byte
for byte, so a snapshot either package writes the other loads.  Only the
ledger's arrays cross differently: the port reads torch tensors and loads
into torch tensors on a device, ``arrays_to_ledger(arrays, device)`` and
``load(..., device=)``, where the JAX package used ``jnp``.)
"""

from __future__ import annotations

import io
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .checksum import checksum
from .. import convert
from ..device import resolve as resolve_device
from ..ops import hash_table as ht
from ..ops import state_machine as sm
from ..utils.fs import atomic_write

TABLE_NAMES = ("accounts", "transfers", "posted")
# Per-table fields that are NOT per-slot columns (scalars) — shared with the
# LSM forest's delta computation and the sparse base encoder: the two must
# agree or a scalar gets treated as a (capacity,)-shaped column.
TABLE_SCALARS = ("count", "probe_overflow")


def _np(t) -> np.ndarray:
    """A tensor's bits as the u64/u32/bool numpy array the snapshot holds
    (the JAX package's dtypes: u64 counts, a bool overflow flag), never a
    view of the tensor: the ledger is updated in place, and the LSM forest
    keeps the last snapshot to diff the next one against."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    a = convert.tensor_to_array(t)
    return a.copy() if t.device.type == "cpu" else a


def _table_arrays(prefix: str, table: ht.Table, out: Dict[str, np.ndarray]) -> None:
    out[f"{prefix}/key_lo"] = _np(table.key_lo)
    out[f"{prefix}/key_hi"] = _np(table.key_hi)
    out[f"{prefix}/tombstone"] = _np(table.tombstone)
    out[f"{prefix}/count"] = _np(table.count)
    out[f"{prefix}/probe_overflow"] = _np(table.probe_overflow)
    # Columns in key order: the order a JAX ledger holds after any jitted
    # commit (pytree flattening sorts dict keys), so the same state gives
    # the same snapshot file from either package.
    for name in sorted(table.cols):
        out[f"{prefix}/cols/{name}"] = _np(table.cols[name])


def _load_table(prefix: str, z, keys=None, device=None) -> ht.Table:
    def put(a):
        return convert.array_to_tensor(np.asarray(a), device)

    cols = {}
    cols_prefix = f"{prefix}/cols/"
    for key in keys if keys is not None else z.files:
        if key.startswith(cols_prefix):
            cols[key[len(cols_prefix):]] = put(z[key])
    return ht.Table(
        key_lo=put(z[f"{prefix}/key_lo"]),
        key_hi=put(z[f"{prefix}/key_hi"]),
        tombstone=put(z[f"{prefix}/tombstone"]),
        cols=cols,
        count=put(z[f"{prefix}/count"]),
        probe_overflow=put(z[f"{prefix}/probe_overflow"]),
    )


def path_for(data_path: str, op: int) -> str:
    return f"{data_path}.checkpoint.{op}"


def ledger_to_arrays(ledger: sm.Ledger) -> Dict[str, np.ndarray]:
    """Flatten a ledger into the snapshot's flat key->array dict (the same
    keys the npz uses); shared with the LSM forest's delta computation."""
    arrays: Dict[str, np.ndarray] = {}
    for name in TABLE_NAMES:
        _table_arrays(name, getattr(ledger, name), arrays)
    for name in sorted(ledger.history.cols):
        arrays[f"history/cols/{name}"] = _np(ledger.history.cols[name])
    arrays["history/count"] = _np(ledger.history.count)
    return arrays


def arrays_to_ledger(arrays, device=None) -> sm.Ledger:
    """Inverse of ledger_to_arrays, on ``device`` (``cuda`` when None);
    accepts any mapping with npz-style keys (an NpzFile or a plain dict)."""
    device = resolve_device(device)
    keys = arrays.files if hasattr(arrays, "files") else arrays.keys()
    return sm.Ledger(
        accounts=_load_table("accounts", arrays, keys, device),
        transfers=_load_table("transfers", arrays, keys, device),
        posted=_load_table("posted", arrays, keys, device),
        history=sm.History(
            cols={
                key[len("history/cols/"):]: convert.array_to_tensor(
                    np.asarray(arrays[key]), device)
                for key in keys
                if key.startswith("history/cols/")
            },
            count=convert.array_to_tensor(
                np.asarray(arrays["history/count"]), device),
        )
        if "history/count" in keys
        else sm.make_history(1, device),
    )


# Marker key identifying a sparse base snapshot (occupied rows only).
SPARSE_MARKER = "sparse_base_v1"


def sparsify_arrays(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Occupied-rows-only encoding of a snapshot dict.

    With preallocated tables (config.zig-style static allocation) the hash
    arrays are mostly empty; a dense base write costs O(capacity) — measured
    as a multi-second, cluster-wide stall when three replicas hit their
    aligned first checkpoint on 2^22-slot tables.  Sparse encoding makes
    checkpoint cost scale with data instead: a row is kept iff any of its
    columns holds a nonzero byte (zero rows are empty hash slots by
    construction — key 0 is the empty sentinel and tombstones are flagged),
    so expansion is bit-exact."""
    out: Dict[str, np.ndarray] = {SPARSE_MARKER: np.uint64(1)}
    for t in TABLE_NAMES:
        prefix = f"{t}/"
        per_slot = [
            k for k in arrays
            if k.startswith(prefix)
            and k.split("/")[-1] not in TABLE_SCALARS
        ]
        cap = arrays[f"{t}/key_lo"].shape[0]
        occ = np.zeros(cap, dtype=bool)
        for k in per_slot:
            occ |= arrays[k] != 0
        (slots,) = np.nonzero(occ)
        out[f"{t}/capacity"] = np.uint64(cap)
        out[f"{t}/slots"] = slots.astype(np.uint64)
        for k in per_slot:
            out[f"sp/{k}"] = arrays[k][slots]
        out[f"{t}/count"] = arrays[f"{t}/count"]
        out[f"{t}/probe_overflow"] = arrays[f"{t}/probe_overflow"]
    hcount = int(arrays["history/count"])
    hcap = 0
    for k in arrays:
        if k.startswith("history/cols/"):
            hcap = arrays[k].shape[0]
            out[f"sp/{k}"] = arrays[k][:hcount]
    out["history/capacity"] = np.uint64(hcap)
    out["history/count"] = arrays["history/count"]
    return out


def densify_arrays(arrays) -> Dict[str, np.ndarray]:
    """Inverse of sparsify_arrays; passes dense snapshots through unchanged
    (old checkpoints stay loadable)."""
    keys = list(arrays.files if hasattr(arrays, "files") else arrays.keys())
    if SPARSE_MARKER not in keys:
        return {k: arrays[k] for k in keys}
    out: Dict[str, np.ndarray] = {}
    for t in TABLE_NAMES:
        cap = int(arrays[f"{t}/capacity"])
        slots = np.asarray(arrays[f"{t}/slots"]).astype(np.int64)
        prefix = f"sp/{t}/"
        for k in keys:
            if k.startswith(prefix):
                rows = np.asarray(arrays[k])
                full = np.zeros((cap,) + rows.shape[1:], dtype=rows.dtype)
                full[slots] = rows
                out[k[3:]] = full
        out[f"{t}/count"] = np.asarray(arrays[f"{t}/count"])
        out[f"{t}/probe_overflow"] = np.asarray(
            arrays[f"{t}/probe_overflow"]
        )
    hcap = int(arrays["history/capacity"])
    hcount = int(arrays["history/count"])
    for k in keys:
        if k.startswith("sp/history/cols/"):
            rows = np.asarray(arrays[k])
            full = np.zeros((hcap,) + rows.shape[1:], dtype=rows.dtype)
            full[:hcount] = rows
            out[k[3:]] = full
    out["history/count"] = np.asarray(arrays["history/count"])
    for k in keys:
        # Passthrough for non-table payloads (meta, op, ...).
        if (
            k not in out
            and k != SPARSE_MARKER
            and not k.startswith("sp/")
            and not any(
                k.startswith(f"{t}/") for t in TABLE_NAMES + ("history",)
            )
        ):
            out[k] = arrays[k]
    return out


def save(
    data_path: str, op: int, ledger: sm.Ledger, meta: Optional[dict] = None
) -> Tuple[str, int]:
    """Write the snapshot for checkpoint ``op`` atomically; returns
    (path, file_checksum)."""
    return save_arrays(data_path, op, ledger_to_arrays(ledger), meta)


def save_arrays(
    data_path: str, op: int, arrays: Dict[str, np.ndarray],
    meta: Optional[dict] = None,
) -> Tuple[str, int]:
    """save() on a pre-captured host snapshot (ledger_to_arrays output) —
    lets the overlapped-checkpoint thread write without touching device
    state."""
    arrays = dict(arrays)
    arrays["meta"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8
    ).copy()

    buf = io.BytesIO()
    np.savez(buf, **arrays)  # uncompressed: snapshot speed over size
    blob = buf.getvalue()
    file_checksum = checksum(blob)

    path = path_for(data_path, op)
    atomic_write(path, blob)
    return path, file_checksum


def load(
    data_path: str, op: int, expected_checksum: int, device=None
) -> Tuple[sm.Ledger, dict]:
    """Load + verify the snapshot for checkpoint ``op``, onto ``device``."""
    path = path_for(data_path, op)
    with open(path, "rb") as f:
        blob = f.read()
    actual = checksum(blob)
    if actual != expected_checksum:
        raise RuntimeError(
            f"checkpoint {path}: checksum mismatch "
            f"(got {actual:#x}, superblock says {expected_checksum:#x})"
        )
    z = np.load(io.BytesIO(blob))
    ledger = arrays_to_ledger(densify_arrays(z), device)
    meta = json.loads(bytes(z["meta"]).decode()) if "meta" in z.files else {}
    return ledger, meta


def remove_older_than(data_path: str, op: int) -> None:
    """GC snapshots strictly older than ``op`` (called after the superblock
    referencing ``op`` is durable)."""
    directory = os.path.dirname(os.path.abspath(data_path)) or "."
    base = os.path.basename(data_path) + ".checkpoint."
    for entry in os.listdir(directory):
        if entry.startswith(base):
            tail = entry[len(base):]
            if tail.isdigit() and int(tail) < op:
                os.unlink(os.path.join(directory, entry))
