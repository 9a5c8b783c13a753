"""General scan composition over per-field secondary indexes (port of
``tigerbeetle_tpu/ops/scan_builder.py``).

Reference: ``lsm/scan_builder.zig`` (``scan_prefix`` conditions composed by
``merge_union``; ``merge_intersection``/``merge_difference`` are declared at
scan_builder.zig:184-205 but stubbed) and ``lsm/scan_merge.zig``.  Prefix
scans over any groove field, composed by union / intersection / difference
to any depth, exact results in timestamp order.

Each scanned field gets a :class:`FieldIndex`, the same sorted-runs pyramid
as ``ops/index.py`` keyed by (field value, timestamp), materialized on the
first scan that names the field (one full-table sort) and maintained per
committed batch.  Leaves run on the device (K15's window mode through
``index._query_side``; the builders through K1, K13 and K14); the set
algebra runs on the host over the leaves' candidates read back, with numpy,
as in the JAX module.

Exactness with bounded windows: a leaf's candidates are its complete match
prefix in rank order (rank = ts ascending, ~ts descending) up to its
frontier (the rank of its last candidate if a level's window filled, else
+inf); a merge node's membership is decided up to the least frontier of its
children, so the evaluator truncates there and propagates the frontier; the
top-level loop doubles K until the root yields ``limit`` rows or is
exhausted.  Timestamps are unique per groove object, so equal rank is
object identity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import convert
from . import hash_table as ht
from . import index as ix
from . import state_machine as sm

U64M = (1 << 64) - 1

# Scannable fields per groove: name -> (lo_col, hi_col | None); u128 fields
# split into limb columns, narrower fields widen to u64 with hi = 0.
TRANSFER_FIELDS: Dict[str, Tuple[str, Optional[str]]] = {
    "debit_account_id": ("debit_account_id_lo", "debit_account_id_hi"),
    "credit_account_id": ("credit_account_id_lo", "credit_account_id_hi"),
    "pending_id": ("pending_id_lo", "pending_id_hi"),
    "user_data_128": ("user_data_128_lo", "user_data_128_hi"),
    "user_data_64": ("user_data_64", None),
    "user_data_32": ("user_data_32", None),
    "ledger": ("ledger", None),
    "code": ("code", None),
}
ACCOUNT_FIELDS: Dict[str, Tuple[str, Optional[str]]] = {
    "user_data_128": ("user_data_128_lo", "user_data_128_hi"),
    "user_data_64": ("user_data_64", None),
    "user_data_32": ("user_data_32", None),
    "ledger": ("ledger", None),
    "code": ("code", None),
}


# -- expression algebra ------------------------------------------------------


class Scan:
    """Base of the scan expression tree."""

    def fields(self) -> List[str]:
        raise NotImplementedError


@dataclass(frozen=True)
class Prefix(Scan):
    """All objects whose ``field`` equals ``value`` (scan_prefix)."""

    field: str
    value: int

    def fields(self) -> List[str]:
        return [self.field]


@dataclass(frozen=True)
class Union(Scan):
    children: Tuple[Scan, ...]

    def fields(self) -> List[str]:
        return [f for c in self.children for f in c.fields()]


@dataclass(frozen=True)
class Intersection(Scan):
    children: Tuple[Scan, ...]

    def fields(self) -> List[str]:
        return [f for c in self.children for f in c.fields()]


@dataclass(frozen=True)
class Difference(Scan):
    include: Scan
    exclude: Scan

    def fields(self) -> List[str]:
        return self.include.fields() + self.exclude.fields()


def scan_prefix(field: str, value: int) -> Scan:
    return Prefix(field, int(value))


def merge_union(*scans: Scan) -> Scan:
    assert scans, "union of zero scans"
    return scans[0] if len(scans) == 1 else Union(tuple(scans))


def merge_intersection(*scans: Scan) -> Scan:
    assert scans, "intersection of zero scans"
    return scans[0] if len(scans) == 1 else Intersection(tuple(scans))


def merge_difference(include: Scan, exclude: Scan) -> Scan:
    return Difference(include, exclude)


# -- device builders (generic-field twins of ops/index.py's) -----------------


def _widen(col: torch.Tensor) -> torch.Tensor:
    """A u64 or u32 column as u64 bits (int64)."""
    if col.dtype == torch.int32:
        return col.to(torch.int64) & 0xFFFFFFFF
    return col


def _field_cols(cols, lo_col: str, hi_col: Optional[str], key_lo, key_hi):
    lo = _widen(cols[lo_col])
    hi = _widen(cols[hi_col]) if hi_col else torch.zeros_like(lo)
    return [lo, hi, cols["timestamp"], key_lo, key_hi]


def _build_field_run(
    ledger: sm.Ledger, id_lo: torch.Tensor, id_hi: torch.Tensor,
    ok: torch.Tensor, table_name: str, lo_col: str, hi_col: Optional[str],
) -> ix.Level:
    """Sorted level-0 run for a just-committed batch, keyed by one field."""
    table = getattr(ledger, table_name)
    names = (lo_col,) + ((hi_col,) if hi_col else ()) + ("timestamp",)
    look = ht.lookup(table, id_lo, id_hi, sm.MAX_PROBE, cols=names, mask=ok)
    use = look.found  # ok & found
    cols = _field_cols(look.cols, lo_col, hi_col, id_lo, id_hi)
    if id_lo.is_cuda:
        return ix._sort_masked([cols], use, id_lo.shape[0])[0]
    return ix._sort_level_plain(ix._masked(cols, use))


def _full_build_field(
    ledger: sm.Ledger, table_name: str, lo_col: str, hi_col: Optional[str],
    capacity: int,
) -> ix.Level:
    """One sorted run over every live object (lazy materialization)."""
    t = getattr(ledger, table_name)
    assert capacity >= t.capacity
    cols = _field_cols(t.cols, lo_col, hi_col, t.key_lo, t.key_hi)
    live = ix._live(t)
    if t.key_lo.is_cuda:
        return ix._sort_masked([cols], live, capacity)[0]
    return ix._sort_level_plain(ix._masked(cols, live, capacity))


def _leaf_window(levels, key_lo: int, key_hi: int, ts_min: int, ts_max: int,
                 k: int, descending: bool):
    return ix._query_side(list(levels), key_lo, key_hi, ts_min, ts_max, k,
                          descending)


class FieldIndex:
    """Single-field sorted-runs pyramid (one side of ``index.TransferIndex``,
    generalized to any key column pair); its carry chain, rebuild and host
    rows are the twin's."""

    def __init__(self, base: int, table_name: str, lo_col: str,
                 hi_col: Optional[str], device=None) -> None:
        assert base & (base - 1) == 0
        self.base = base
        self.table_name = table_name
        self.lo_col = lo_col
        self.hi_col = hi_col
        self.device = device
        self.levels: List[ix.Level] = []
        self.occupied: List[bool] = []
        # Born stale: materialization happens against a table that may
        # already hold objects.
        self.stale = True
        self.shape_class_events = 0

    def reset(self) -> None:
        self.levels, self.occupied = [], []
        self.stale = True

    def _ensure_level(self, k: int) -> None:
        while len(self.occupied) <= k:
            cap = self.base << len(self.occupied)
            self.levels.append(ix._sentinel_level(cap, self.device))
            self.occupied.append(False)
            self.shape_class_events += 1

    def capacity(self) -> int:
        return sum(self.base << j for j in range(len(self.occupied))) or self.base

    def append_batch(self, ledger, id_lo, id_hi, ok) -> None:
        if self.stale:
            return  # rebuilt wholesale on next scan
        run = _build_field_run(ledger, id_lo, id_hi, ok, self.table_name,
                               self.lo_col, self.hi_col)
        k = 0
        while k < len(self.occupied) and self.occupied[k]:
            k += 1
        self._ensure_level(k)
        if k == 0:
            self.levels[0] = run
        else:
            ix._merge_sides([[run] + self.levels[:k]], outs=[self.levels[k]])
            for j in range(k):
                self.levels[j].block.fill_(ix._M)
                self.occupied[j] = False
        self.occupied[k] = True

    def rebuild(self, ledger, extra_rows: Sequence[np.ndarray] = ()) -> None:
        cap = max(self.base, getattr(ledger, self.table_name).capacity)
        k = (cap // self.base - 1).bit_length()
        self.levels, self.occupied = [], []
        self._ensure_level(k)
        self.levels[k] = _full_build_field(
            ledger, self.table_name, self.lo_col, self.hi_col, self.base << k)
        self.occupied[k] = True
        for rows in extra_rows:
            self._add_host_rows(rows)
        self.stale = False

    def _add_host_rows(self, rows: np.ndarray) -> None:
        """Occupy a free level with host rows (cold-tier runs at rebuild)."""
        rows = np.asarray(rows)
        n = len(rows)
        if n == 0:
            return
        j = max(0, ((n + self.base - 1) // self.base - 1).bit_length())
        self._ensure_level(j)
        while self.occupied[j]:
            j += 1
            self._ensure_level(j)
        hi = (rows[self.hi_col].astype(np.uint64) if self.hi_col
              else np.zeros((n,), np.uint64))
        self.levels[j] = ix._sort_level(ix._host_level(
            self.base << j, self.device,
            rows[self.lo_col].astype(np.uint64), hi, rows["timestamp"],
            rows["id_lo"], rows["id_hi"]))
        self.occupied[j] = True


# -- evaluation --------------------------------------------------------------


@dataclass
class _Res:
    """One node's decided candidates, rank-ascending (= result order)."""

    rank: np.ndarray     # uint64, sorted ascending, unique
    tid_lo: np.ndarray
    tid_hi: np.ndarray
    frontier: int        # membership decided for rank <= frontier
    exhausted: bool      # True: candidates are the node's COMPLETE result set


def _eval_leaf(idx: FieldIndex, value: int, ts_min: int, ts_max: int,
               k: int, descending: bool) -> _Res:
    if not idx.levels:
        return _Res(*_empty3(), frontier=U64M, exhausted=True)
    levels = tuple(idx.levels)
    ts_d, lo_d, hi_d = _leaf_window(levels, value & U64M, value >> 64,
                                    ts_min, ts_max, k, descending)
    n_lvl = len(levels)
    # One read-back of the three candidate columns.
    host = convert.tensor_to_array(torch.stack([ts_d, lo_d, hi_d]))
    ts, lo, hi = (a.reshape(n_lvl, k) for a in host)
    valid = ts != np.uint64(U64M)
    rank = np.invert(ts) if descending else ts
    counts = valid.sum(axis=1)
    full = counts == k
    if full.any():
        # Each level's valid candidates are a rank-ascending prefix; a full
        # window means the level may hold more matches past its last rank.
        frontier = int(
            min(int(rank[l, counts[l] - 1]) for l in np.nonzero(full)[0])
        )
        exhausted = False
    else:
        frontier = U64M
        exhausted = True
    keep = valid & (rank <= np.uint64(frontier))
    r, l_, h_ = rank[keep], lo[keep], hi[keep]
    # A rebuild can index one object twice (hot table + its cold run):
    # dedup by rank so intersection multiplicity counting stays exact.
    r, first = np.unique(r, return_index=True)
    return _Res(r, l_[first], h_[first], frontier, exhausted)


def _empty3():
    z = np.zeros(0, np.uint64)
    return z, z.copy(), z.copy()


def _truncate(res: _Res, frontier: int) -> _Res:
    keep = res.rank <= np.uint64(frontier)
    # An exhausted node's candidate set is complete, so its membership is
    # decided at every rank: propagate an infinite frontier.
    return _Res(
        res.rank[keep], res.tid_lo[keep], res.tid_hi[keep],
        U64M if res.exhausted else frontier, res.exhausted,
    )


def _fully_decided(res: _Res, frontier: int) -> bool:
    """An exhausted child whose every candidate ranks <= frontier has its
    node-level contribution fully decided by the other legs' windows."""
    return res.exhausted and (
        len(res.rank) == 0 or int(res.rank[-1]) <= frontier
    )


def _eval(node: Scan, leaf: Callable[[Prefix], _Res]) -> _Res:
    if isinstance(node, Prefix):
        return leaf(node)
    if isinstance(node, (Union, Intersection)):
        rs = [_eval(c, leaf) for c in node.children]
        frontier = min(r.frontier for r in rs)
        rank = np.concatenate([r.rank for r in rs])
        lo = np.concatenate([r.tid_lo for r in rs])
        hi = np.concatenate([r.tid_hi for r in rs])
        order = np.argsort(rank, kind="stable")
        rank, lo, hi = rank[order], lo[order], hi[order]
        uniq, first, counts = np.unique(
            rank, return_index=True, return_counts=True
        )
        if isinstance(node, Union):
            res = _Res(
                uniq, lo[first], hi[first], frontier,
                all(r.exhausted for r in rs),
            )
        else:
            hit = counts == len(rs)
            exhausted = all(r.exhausted for r in rs) or any(
                _fully_decided(r, frontier) for r in rs
            )
            res = _Res(
                uniq[hit], lo[first][hit], hi[first][hit], frontier, exhausted
            )
        return _truncate(res, frontier)
    if isinstance(node, Difference):
        a = _eval(node.include, leaf)
        b = _eval(node.exclude, leaf)
        frontier = min(a.frontier, b.frontier)
        keep = ~np.isin(a.rank, b.rank)
        exhausted = (a.exhausted and b.exhausted) or _fully_decided(
            a, frontier
        )
        return _truncate(
            _Res(a.rank[keep], a.tid_lo[keep], a.tid_hi[keep],
                 frontier, exhausted),
            frontier,
        )
    raise TypeError(f"unknown scan node {node!r}")


class ScanSet:
    """Per-groove registry of lazily-materialized field indexes plus the
    scan evaluator (the ScanBuilder/ScanMerge role, scan_builder.zig:23)."""

    def __init__(self, table_name: str,
                 field_specs: Dict[str, Tuple[str, Optional[str]]],
                 base: int, device=None) -> None:
        self.table_name = table_name
        self.field_specs = field_specs
        self.base = base
        self.device = device
        self.indexes: Dict[str, FieldIndex] = {}
        # Supplies host rows to index at rebuild (the machine supplies the
        # cold tier's runs).
        self.extra_rows_provider: Optional[Callable[[], Sequence]] = None

    def reset(self) -> None:
        for idx in self.indexes.values():
            idx.reset()

    def append_batch(self, ledger, id_lo, id_hi, ok) -> None:
        for idx in self.indexes.values():
            idx.append_batch(ledger, id_lo, id_hi, ok)

    def _ensure(self, fields: Sequence[str], ledger) -> None:
        for f in fields:
            if f not in self.field_specs:
                raise KeyError(
                    f"{self.table_name} has no scannable field {f!r} "
                    f"(choose from {sorted(self.field_specs)})"
                )
            idx = self.indexes.get(f)
            if idx is None:
                lo_col, hi_col = self.field_specs[f]
                idx = FieldIndex(self.base, self.table_name, lo_col, hi_col,
                                 self.device)
                self.indexes[f] = idx
            if idx.stale:
                extra = (
                    self.extra_rows_provider()
                    if self.extra_rows_provider else ()
                )
                idx.rebuild(ledger, extra)

    def evaluate(self, expr: Scan, ledger, ts_min: int, ts_max: int,
                 limit: int, descending: bool) -> Tuple[np.ndarray, np.ndarray]:
        """(tid_lo, tid_hi) of up to ``limit`` matching objects in result
        order (ascending / descending timestamp)."""
        fields = expr.fields()
        self._ensure(fields, ledger)
        cap = max(self.indexes[f].capacity() for f in fields)
        k = max(16, 1 << max(0, limit - 1).bit_length())
        while True:
            res = _eval(
                expr,
                lambda p: _eval_leaf(
                    self.indexes[p.field], p.value, ts_min, ts_max,
                    k, descending,
                ),
            )
            if len(res.rank) >= limit or res.exhausted or k >= cap:
                break
            k *= 2
        return res.tid_lo[:limit], res.tid_hi[:limit]
