"""Carry ledger state between the JAX package and the port, losslessly.

The exchange format of a ledger is a nested dict of numpy arrays, the
arrays that ``np.asarray`` gives for a JAX ``Ledger``:

    {"accounts" | "transfers" | "posted":
        {"key_lo": u64[C], "key_hi": u64[C], "tombstone": bool[C],
         "cols": {name: u64[C] | u32[C]}, "count": u64 0-d,
         "probe_overflow": bool 0-d},
     "history": {"cols": {name: u64[H]}, "count": u64 0-d}}

On the torch side every u64 is an int64 tensor and every u32 an int32
tensor holding the same bits, so the round trip is a reinterpretation of the
bytes in both directions.

A derived index (``ops/index.TransferIndex``, ``ops/scan_builder.FieldIndex``)
is exchanged as ``{"dr_levels" and "cr_levels" | "levels": [{column: u64[n]}],
"occupied": [bool], "stale": bool}``.  The index is not checkpointed (it is
rebuilt from the table); this is for tests and checks that start both
packages from the same pyramid.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .ops import hash_table as ht
from .ops import state_machine as sm

_TO_TORCH = {np.dtype(np.uint64): np.int64, np.dtype(np.uint32): np.int32,
             np.dtype(np.bool_): np.bool_}
_TO_NUMPY = {torch.int64: np.uint64, torch.int32: np.uint32,
             torch.bool: np.bool_}
TABLES = ("accounts", "transfers", "posted")


def array_to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A u64/u32/bool numpy array as an int64/int32/bool tensor (same bits
    and shape; a 0-d array gives a 0-dim tensor)."""
    shape = np.shape(a)
    a = np.ascontiguousarray(a)
    try:
        view = _TO_TORCH[a.dtype]
    except KeyError:
        raise TypeError(f"unsupported dtype {a.dtype}") from None
    return torch.from_numpy(a.view(view).copy()).reshape(shape).to(device)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """Inverse of ``array_to_tensor``."""
    return t.detach().cpu().numpy().view(_TO_NUMPY[t.dtype])


def tensors_to_arrays(cols: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``tensor_to_array`` of every 1-d tensor of ``cols`` (int64, int32 or
    bool, one device), in one device-to-host copy: each column widens to
    int64 on the device and the stack comes back at once."""
    names = list(cols)
    host = torch.stack([cols[k].to(torch.int64) for k in names]).cpu().numpy()
    return _host_rows(host, cols)


def _host_rows(host: np.ndarray, cols: Dict[str, torch.Tensor]
               ) -> Dict[str, np.ndarray]:
    """The int64 rows read back for ``cols``, in their numpy dtypes."""
    out = {}
    for row, name in zip(host, cols):
        dt = cols[name].dtype
        if dt == torch.bool:
            out[name] = row != 0
        elif dt == torch.int32:
            out[name] = row.astype(np.uint32)
        else:
            out[name] = row.view(np.uint64)
    return out


def tensors_and_word_to_arrays(cols: Dict[str, torch.Tensor],
                               word: Optional[torch.Tensor]
                               ) -> Tuple[Dict[str, np.ndarray], int]:
    """``tensors_to_arrays(cols)`` and the int of a one-element int tensor
    ``word`` (None: 0), in the same one device-to-host copy."""
    if word is None:
        return tensors_to_arrays(cols), 0
    stack = torch.stack([c.to(torch.int64) for c in cols.values()])
    host = torch.cat([stack.reshape(-1), word.reshape(1).to(torch.int64)]
                     ).cpu().numpy()
    return _host_rows(host[:-1].reshape(len(cols), -1), cols), int(host[-1])


def table_arrays(t: Any) -> Dict[str, Any]:
    """The exchange dict of one table laid out like ``Table`` whose arrays
    ``np.asarray`` reads (a JAX package table)."""
    return {
        "key_lo": np.asarray(t.key_lo), "key_hi": np.asarray(t.key_hi),
        "tombstone": np.asarray(t.tombstone),
        "cols": {k: np.asarray(v) for k, v in t.cols.items()},
        "count": np.asarray(t.count),
        "probe_overflow": np.asarray(t.probe_overflow),
    }


def table_to_numpy(t: ht.Table) -> Dict[str, Any]:
    """The exchange dict of one port ``Table``."""
    return {
        "key_lo": tensor_to_array(t.key_lo),
        "key_hi": tensor_to_array(t.key_hi),
        "tombstone": tensor_to_array(t.tombstone),
        "cols": {k: tensor_to_array(v) for k, v in t.cols.items()},
        "count": tensor_to_array(t.count),
        "probe_overflow": tensor_to_array(t.probe_overflow),
    }


def ledger_arrays(ledger: Any) -> Dict[str, Any]:
    """The exchange dict of any object laid out like a ``Ledger`` whose
    arrays ``np.asarray`` reads (a JAX package ledger)."""
    out = {name: table_arrays(getattr(ledger, name)) for name in TABLES}
    out["history"] = {
        "cols": {k: np.asarray(v) for k, v in ledger.history.cols.items()},
        "count": np.asarray(ledger.history.count),
    }
    return out


def ledger_from_numpy(arrays: Dict[str, Any], device) -> sm.Ledger:
    """A port ``Ledger`` on ``device`` from the exchange dict."""

    def table(d):
        return ht.Table(
            key_lo=array_to_tensor(d["key_lo"], device),
            key_hi=array_to_tensor(d["key_hi"], device),
            tombstone=array_to_tensor(d["tombstone"], device),
            cols={k: array_to_tensor(v, device) for k, v in d["cols"].items()},
            count=array_to_tensor(d["count"], device),
            probe_overflow=array_to_tensor(d["probe_overflow"], device),
        )

    h = arrays["history"]
    return sm.Ledger(
        **{name: table(arrays[name]) for name in TABLES},
        history=sm.History(
            cols={k: array_to_tensor(v, device) for k, v in h["cols"].items()},
            count=array_to_tensor(h["count"], device),
        ),
    )


def ledger_to_numpy(ledger: sm.Ledger) -> Dict[str, Any]:
    """The exchange dict of a port ``Ledger``."""
    out = {name: table_to_numpy(getattr(ledger, name)) for name in TABLES}
    out["history"] = {
        "cols": {k: tensor_to_array(v) for k, v in ledger.history.cols.items()},
        "count": tensor_to_array(ledger.history.count),
    }
    return out


def batch_to_tensors(batch: np.ndarray, lanes: int,
                     device) -> Dict[str, torch.Tensor]:
    """``soa_to_tensors(types.to_soa(padded))`` of ``batch`` zero-padded to
    ``lanes``, without the padded structured copy: the fields of one width
    (u16 widened to u32, as ``to_soa`` does) fill the rows of one zeroed
    array, copied to ``device`` at once."""
    groups: Dict[Any, list] = {}
    for name in batch.dtype.names:
        dt = batch.dtype.fields[name][0]
        groups.setdefault(np.dtype(np.uint32) if dt == np.uint16 else dt,
                          []).append(name)
    out = {}
    for wide, names in groups.items():
        host = np.zeros((len(names), lanes), dtype=wide)
        for row, name in enumerate(names):
            host[row, :len(batch)] = batch[name]
        stacked = torch.from_numpy(host.view(_TO_TORCH[wide])).to(device)
        out.update(zip(names, stacked.unbind(0)))
    return {name: out[name] for name in batch.dtype.names}


def soa_to_tensors(soa: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A batch SoA (``types.to_soa``: u64 and u32 columns) as tensors: the
    columns of one dtype are stacked and copied to ``device`` at once, and
    each column is a (contiguous) row of that stack."""
    names_by_dtype: Dict[Any, list] = {}
    for name, col in soa.items():
        names_by_dtype.setdefault(col.dtype, []).append(name)
    out = {}
    for names in names_by_dtype.values():
        stacked = array_to_tensor(np.stack([soa[k] for k in names]), device)
        out.update(zip(names, stacked.unbind(0)))
    return {name: out[name] for name in soa}


# -- the Merkle forest -----------------------------------------------------------


def forest_from_numpy(heaps: Dict[str, Any], device):
    """A port ``merkle.Forest`` on ``device`` from the three heaps (u64
    numpy arrays, as ``np.asarray`` reads a JAX ``Forest``'s fields)."""
    from .ops import merkle

    return merkle.Forest(**{name: array_to_tensor(np.asarray(heaps[name]),
                                                  device)
                            for name in TABLES})


def forest_to_numpy(forest: Any) -> Dict[str, np.ndarray]:
    """The three heaps of a port ``Forest`` as u64 numpy arrays (the
    inverse of ``forest_from_numpy``, byte for byte)."""
    return {name: tensor_to_array(getattr(forest, name)) for name in TABLES}


# -- the sharded ledger (parallel/sharded.py) -------------------------------------
#
# A JAX ledger sharded on P(AXIS) reads with ``np.asarray`` as the
# concatenation of its shards: table arrays of the global capacity, and
# ``count``/``probe_overflow`` of one element a shard.  The port holds the
# same content as one local table per shard.


def sharded_ledger_from_numpy(arrays: Dict[str, Any], mesh) -> Any:
    """A port ``ShardedLedger`` over ``mesh`` from the exchange dict of a
    sharded ledger (``ledger_arrays`` of a JAX one)."""
    from .parallel import sharded

    n = mesh.size

    def table(d):
        local = len(d["key_lo"]) // n
        parts = []
        for s, dev in enumerate(mesh.devices):
            cut = slice(s * local, (s + 1) * local)
            parts.append(ht.Table(
                key_lo=array_to_tensor(d["key_lo"][cut], dev),
                key_hi=array_to_tensor(d["key_hi"][cut], dev),
                tombstone=array_to_tensor(d["tombstone"][cut], dev),
                cols={k: array_to_tensor(v[cut], dev)
                      for k, v in d["cols"].items()},
                count=array_to_tensor(np.asarray(d["count"])[s], dev),
                probe_overflow=array_to_tensor(
                    np.asarray(d["probe_overflow"])[s], dev),
            ))
        return sharded.ShardedTable(parts)

    h = arrays["history"]
    return sharded.ShardedLedger(
        mesh=mesh, **{name: table(arrays[name]) for name in TABLES},
        history=sm.History(
            cols={k: array_to_tensor(v, mesh.primary)
                  for k, v in h["cols"].items()},
            count=array_to_tensor(h["count"], mesh.primary),
        ),
    )


def sharded_ledger_to_numpy(ledger: Any) -> Dict[str, Any]:
    """The exchange dict of a port ``ShardedLedger``: the JAX layout (the
    shards' arrays concatenated, count and probe_overflow one a shard)."""

    def table(t):
        parts = [table_to_numpy(p) for p in t.parts]
        return {
            "key_lo": np.concatenate([p["key_lo"] for p in parts]),
            "key_hi": np.concatenate([p["key_hi"] for p in parts]),
            "tombstone": np.concatenate([p["tombstone"] for p in parts]),
            "cols": {k: np.concatenate([p["cols"][k] for p in parts])
                     for k in parts[0]["cols"]},
            "count": np.stack([p["count"] for p in parts]),
            "probe_overflow": np.stack([p["probe_overflow"] for p in parts]),
        }

    out = {name: table(getattr(ledger, name)) for name in TABLES}
    out["history"] = {
        "cols": {k: tensor_to_array(v) for k, v in ledger.history.cols.items()},
        "count": tensor_to_array(ledger.history.count),
    }
    return out


def sharded_forest_to_numpy(forest: Any) -> Dict[str, np.ndarray]:
    """The three heaps of a port ``ShardedForest`` in the JAX layout (the
    shards' heaps concatenated)."""
    return {name: np.concatenate([tensor_to_array(getattr(f, name))
                                  for f in forest.parts])
            for name in TABLES}


# -- the cold tier's Bloom filter ---------------------------------------------


def bloom_to_tensor(bloom: np.ndarray, device) -> torch.Tensor:
    """A host Bloom filter (u32 words) as the int32 tensor the kernels read."""
    if bloom.dtype != np.uint32 or bloom.ndim != 1:
        raise TypeError(f"a Bloom filter is u32[words], got {bloom.dtype}"
                        f"{list(bloom.shape)}")
    return array_to_tensor(bloom, device)


def bloom_to_numpy(bloom: torch.Tensor) -> np.ndarray:
    """Inverse of ``bloom_to_tensor``."""
    if bloom.dtype != torch.int32 or bloom.dim() != 1:
        raise TypeError(f"a Bloom filter is int32[words], got {bloom.dtype}"
                        f"{list(bloom.shape)}")
    return tensor_to_array(bloom)


# -- derived indexes ---------------------------------------------------------

_PYRAMIDS = ("dr_levels", "cr_levels", "levels")


def _levels_of(idx: Any, read) -> Dict[str, Any]:
    out = {"occupied": [bool(o) for o in idx.occupied],
           "stale": bool(idx.stale)}
    for name in _PYRAMIDS:
        if hasattr(idx, name):
            out[name] = [{c: read(v) for c, v in lvl.items()}
                         for lvl in getattr(idx, name)]
    return out


def index_arrays(idx: Any) -> Dict[str, Any]:
    """The exchange dict of an index whose level arrays ``np.asarray``
    reads (a JAX package ``TransferIndex`` or ``FieldIndex``)."""
    return _levels_of(idx, np.asarray)


def index_levels_to_numpy(idx: Any) -> Dict[str, Any]:
    """The exchange dict of a port ``TransferIndex`` or ``FieldIndex``."""
    return _levels_of(idx, tensor_to_array)


def index_from_numpy(arrays: Dict[str, Any], idx: Any) -> Any:
    """Load the exchange dict into the port index ``idx`` (levels on its
    device, occupancy and staleness); returns ``idx``."""
    from .ops import index as ix

    for name in _PYRAMIDS:
        if name in arrays:
            levels: List[Any] = []
            for lvl in arrays[name]:
                block = np.stack([np.asarray(lvl[c], np.uint64) for c in ix.COLS])
                levels.append(ix.Level(array_to_tensor(block, idx.device)))
            setattr(idx, name, levels)
    idx.occupied = list(arrays["occupied"])
    idx.stale = bool(arrays["stale"])
    return idx


def cluster_state_from_numpy(state: Any, device):
    """A VOPR ``ClusterState`` of numpy arrays (the JAX package's, through
    ``np.asarray`` of each field; a NamedTuple or any sequence in field
    order, or a mapping by field name), one cluster or a batch, as the
    port's ``sim.vopr_tpu.ClusterState`` on ``device``: u32 fields as int32
    bits, i32 and bool as they are."""
    from .sim import vopr_tpu

    if isinstance(state, dict):
        fields = [state[k] for k in vopr_tpu.STATE_FIELDS]
    else:
        fields = list(state)
    if len(fields) != len(vopr_tpu.STATE_FIELDS):
        raise ValueError("a ClusterState has 15 fields")
    out = []
    for name, a in zip(vopr_tpu.STATE_FIELDS, fields):
        a = np.array(a, order="C")  # a copy; 0-d stays 0-d
        want = np.uint32 if name in ("log", "log_hdr", "canonical") else (
            np.bool_ if name in ("part_active", "violated") else np.int32)
        if a.dtype != want:
            raise TypeError(f"{name}: {a.dtype}, expected {np.dtype(want)}")
        if want == np.uint32:
            a = a.view(np.int32)
        out.append(torch.from_numpy(a).to(device))
    return vopr_tpu.ClusterState(*out)


def cluster_state_to_numpy(state: Any) -> Dict[str, np.ndarray]:
    """Inverse of ``cluster_state_from_numpy``: a dict of numpy arrays by
    field name (u32 fields as uint32), which ``ClusterState(**d)`` of the
    JAX package takes."""
    from .sim import vopr_tpu

    out = {}
    for name, t in zip(vopr_tpu.STATE_FIELDS, state):
        a = t.detach().cpu().numpy()
        out[name] = a.view(np.uint32) if name in (
            "log", "log_hdr", "canonical") else a
    return out
