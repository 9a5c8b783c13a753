"""Tiered transfers store: a hot device window and a cold host spill (port of
``tigerbeetle_tpu/ops/cold.py``; BASELINE config 4: 10M accounts and 1B
transfers on one card).

A billion transfer rows do not fit in one card's memory.  Old transfers are
append-only and only ever touched by id (duplicate-id exists checks, the
post or void of an old pending, ``lookup_transfers``) or by the query index
(which stores ids, not rows).  So:

- The device transfers table holds the HOT window.  At eviction the oldest
  rows (by timestamp) leave the device: they are pulled to the host,
  appended to the cold store as immutable id-sorted runs, and the hot table
  is rebuilt without them.
- A device-resident Bloom filter over every cold id rides along with every
  commit: a lane whose id (or pending_id) misses the hot table but hits the
  filter sets ``FLAG_COLD`` and the kernel applies nothing.  The host then
  resolves the batch's ids against the cold store exactly (cold rows are
  rehydrated into the hot table) and dispatches again with a per-lane
  ``cold_checked`` mask, so false positives cannot loop.  There are no
  false negatives: every cold id is in the filter.
- Lookups and queries resolve missing rows from the cold store by id on the
  host.

Every function keeps its JAX name.  The filter is u32 words held as an int32
tensor.  On CPU tensors the device functions run their plain PyTorch
versions (``*_plain``); on CUDA tensors they launch their hand-written
kernels, or raise:

| function | kernel |
|---|---|
| ``bloom_check_impl`` (and the general kernel's ``FLAG_COLD``, ``bloom_flag``) | K17 ``csrc/bloom.cu`` |
| ``eviction_threshold`` | K18 ``csrc/evict.cu`` |
| ``extract_evicted`` (and ``drop_evicted``'s keep mask) | K19 ``csrc/evict.cu`` |
| ``drop_evicted``'s rebuild | K2's claim and write entries |

``ColdStore`` is host code.  Its lookups are vectorized (``np.searchsorted``
per run over the runs' (id_hi, id_lo) order) and give the JAX store's
answers; everything else keeps the JAX logic line for line, so two stores
fed the same runs write byte-identical files under identical names.
"""

from __future__ import annotations

import io
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import types
from ..u128 import INT64_MIN, i64, mix64, srl
from ..utils.fs import atomic_write
from ..vsr.checksum import checksum as _checksum
from . import _cuda
from . import hash_table as ht

BLOOM_HASHES = 4
_GOLDEN = i64(0x9E3779B97F4A7C15)
_U64MAX = -1  # the int64 holding u64 max: the dead slots' timestamp


# ---------------------------------------------------------------------------
# Device Bloom filter (bit array as u32 words, held in int32)
# ---------------------------------------------------------------------------


def make_bloom(bits_log2: int, device) -> torch.Tensor:
    assert 10 <= bits_log2 <= 34
    return torch.zeros(((1 << bits_log2) // 32,), dtype=torch.int32,
                       device=device)


def _bloom_positions(id_lo, id_hi, n_bits: int):
    """BLOOM_HASHES bit positions per id (double hashing h1 + i*h2)."""
    h1 = mix64(id_lo, id_hi)
    h2 = mix64(id_hi ^ _GOLDEN, id_lo) | 1
    mask = n_bits - 1
    return [(h1 + i * h2) & mask for i in range(BLOOM_HASHES)]


def bloom_check_impl(bloom: torch.Tensor, id_lo: torch.Tensor,
                     id_hi: torch.Tensor) -> torch.Tensor:
    """bool[N]: possibly cold (no false negatives).  K17 on CUDA tensors."""
    if id_lo.is_cuda:
        return _cuda.bloom_check(bloom, id_lo, id_hi)
    return bloom_check_plain(bloom, id_lo, id_hi)


bloom_check = bloom_check_impl


def bloom_check_plain(bloom, id_lo, id_hi) -> torch.Tensor:
    """Plain version of K17: mix64 on the int64 bit patterns, then gathers."""
    n_bits = bloom.shape[0] * 32
    hit = torch.ones(id_lo.shape, dtype=torch.bool, device=id_lo.device)
    for pos in _bloom_positions(id_lo, id_hi, n_bits):
        word = srl(pos, 5)
        hit = hit & (((bloom[word] >> (pos & 31).to(torch.int32)) & 1) != 0)
    return hit


def bloom_flag(bloom, id_lo, id_hi, valid, found, pend_lo, pend_hi,
               postvoid, p_found, checked, flag_word: torch.Tensor,
               flag_bit: int) -> torch.Tensor:
    """The general kernel's cold test (the cold branch of JAX
    ``build_gather_ctx``): ORs ``flag_bit`` into the int32 ``flag_word``
    when a lane of ``valid & ~found & ~checked`` has a possibly-cold id or
    a lane of ``postvoid & ~p_found & ~checked`` a possibly-cold pending id,
    and returns the word.  ``postvoid`` None tests no pending id and
    ``checked`` None certifies no lane.  On CUDA tensors one K17 launch ORs
    the bit in place, on the card."""
    if id_lo.is_cuda:
        _cuda.bloom_check(bloom, id_lo, id_hi, valid=valid, found=found,
                          p_lo=pend_lo, p_hi=pend_hi, postvoid=postvoid,
                          p_found=p_found, checked=checked, out=False,
                          flag_word=flag_word, flag_bit=flag_bit)
        return flag_word
    return bloom_flag_plain(bloom, id_lo, id_hi, valid, found, pend_lo,
                            pend_hi, postvoid, p_found, checked, flag_word,
                            flag_bit)


def bloom_flag_plain(bloom, id_lo, id_hi, valid, found, pend_lo, pend_hi,
                     postvoid, p_found, checked, flag_word: torch.Tensor,
                     flag_bit: int) -> torch.Tensor:
    """Plain version of ``bloom_flag`` (K17's masked form)."""
    unchecked = valid.new_ones(valid.shape) if checked is None else ~checked
    cold = valid & ~found & unchecked & bloom_check_plain(bloom, id_lo, id_hi)
    if postvoid is not None:
        cold = cold | (postvoid & ~p_found & unchecked
                       & bloom_check_plain(bloom, pend_lo, pend_hi))
    return flag_word | (cold.any().to(torch.int32) * flag_bit)


def bloom_add_host(bloom_np: np.ndarray, id_lo: np.ndarray, id_hi: np.ndarray) -> None:
    """Host-side insertion (eviction is host-driven); mirrors the device
    hash exactly — verified by the differential test."""
    n_bits = bloom_np.shape[0] * 32

    def mix64(lo, hi):
        # EXACT mirror of u128.mix64 (splitmix64 finalizer over a xor-fold).
        with np.errstate(over="ignore"):
            x = (lo ^ (hi * np.uint64(0x9E3779B97F4A7C15))).astype(np.uint64)
            x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)).astype(np.uint64)
            x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)).astype(np.uint64)
            return x ^ (x >> np.uint64(31))

    h1 = mix64(id_lo, id_hi)
    h2 = mix64(id_hi ^ np.uint64(0x9E3779B97F4A7C15), id_lo) | np.uint64(1)
    for i in range(BLOOM_HASHES):
        pos = (h1 + np.uint64(i) * h2) & np.uint64(n_bits - 1)
        np.bitwise_or.at(
            bloom_np, (pos >> np.uint64(5)).astype(np.int64),
            (np.uint32(1) << (pos & np.uint64(31)).astype(np.uint32)),
        )


# ---------------------------------------------------------------------------
# Cold store: immutable id-sorted runs on disk
# ---------------------------------------------------------------------------


def _safe_basename(name: str) -> bool:
    """Peer-supplied manifest names must be plain basenames — anything that
    could resolve outside the spill directory is rejected."""
    return bool(name) and os.path.basename(name) == name and name not in (".", "..")


class ColdStore:
    """Append-only spill of evicted transfer rows: each run is an id-sorted
    TRANSFER_DTYPE array in a .npy file (memmap-read); lookups binary-search
    every run, newest first; small runs merge when the count grows.

    Deterministic reservation: run sequence numbers, row membership
    (timestamp-threshold eviction), row order (id sort) and merge points
    (MAX_RUNS) are pure functions of the committed op stream and the ledger
    config, so replicas executing the same history write byte-identical run
    files under identical names (and so do this store and the JAX
    package's)."""

    MAX_RUNS = 8

    def __init__(self, directory: Optional[str]) -> None:
        self.directory = directory
        self.runs: List[np.ndarray] = []
        self.run_paths: List[str] = []
        # Whole-file AEGIS checksums, parallel to run_paths: pinned into the
        # checkpoint's cold_manifest so restart detects on-disk corruption
        # of evicted rows (the same checksum-chain discipline as the forest).
        self.run_checksums: List[int] = []
        # Files superseded by a merge: deletable only AFTER a checkpoint
        # superblock referencing the merged manifest is durable (the repo's
        # GC-after-superblock discipline) — gc() is that hook.
        self.garbage: List[str] = []
        # Run filenames carry a sequence number that NEVER reuses a value
        # present on disk: an old checkpoint's cold_manifest may reference
        # files this in-memory state no longer tracks (post-merge garbage,
        # or runs written after the checkpoint we restored to), and a name
        # collision would silently replace those bytes.
        self.next_seq = 0
        # path -> whole-file checksum memo: run files are immutable
        # (atomic_write never rewrites in place), so verify/load/locate
        # never need to hash the same bytes twice.  Entries drop at gc.
        self._path_checksums: Dict[str, int] = {}
        self._scan_next_seq()

    def _file_checksum_cached(self, path: str) -> Optional[int]:
        have = self._path_checksums.get(path)
        if have is not None:
            return have
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return None
        have = _checksum(blob)
        self._path_checksums[path] = have
        return have

    def _scan_next_seq(self) -> None:
        if not self.directory or not os.path.isdir(self.directory):
            return
        for entry in os.listdir(self.directory):
            parts = entry.split("_")
            if parts[0] == "run" and len(parts) > 1 and parts[1].isdigit():
                self.next_seq = max(self.next_seq, int(parts[1]) + 1)

    def _ensure_dir(self) -> None:
        if self.directory and not os.path.isdir(self.directory):
            os.makedirs(self.directory, exist_ok=True)

    @property
    def count(self) -> int:
        return sum(len(r) for r in self.runs)

    def _sort_key(self, rows: np.ndarray):
        return np.lexsort((rows["id_lo"], rows["id_hi"]))

    def append_run(self, rows: np.ndarray) -> None:
        if len(rows) == 0:
            return
        rows = rows[self._sort_key(rows)]
        if self.directory:
            path, file_checksum = self._write_run_file(rows)
            self.runs.append(np.load(path, mmap_mode="r"))
            self.run_paths.append(path)
            self.run_checksums.append(file_checksum)
        else:
            self.runs.append(rows)
            self.run_paths.append("")
            self.run_checksums.append(0)
        if len(self.runs) > self.MAX_RUNS:
            self._merge_all()

    def _write_run_file(self, rows: np.ndarray) -> Tuple[str, int]:
        self._ensure_dir()
        path = os.path.join(
            self.directory, f"run_{self.next_seq:06d}_{len(rows)}.npy"
        )
        self.next_seq += 1
        buf = io.BytesIO()
        np.save(buf, rows)
        blob = buf.getvalue()
        atomic_write(path, blob)
        return path, _checksum(blob)

    def _merge_all(self) -> None:
        merged = np.concatenate([np.asarray(r) for r in self.runs])
        merged = merged[self._sort_key(merged)]
        old_paths = [p for p in self.run_paths if p]
        self.runs, self.run_paths, self.run_checksums = [], [], []
        if self.directory:
            path, file_checksum = self._write_run_file(merged)
            self.runs = [np.load(path, mmap_mode="r")]
            self.run_paths = [path]
            self.run_checksums = [file_checksum]
            # A checkpoint taken BEFORE this merge still references the old
            # files; defer their deletion to gc() (post-superblock).
            self.garbage.extend(p for p in old_paths if p != path)
        else:
            self.runs = [merged]
            self.run_paths = [""]
            self.run_checksums = [0]

    def gc(self, paths: Optional[List[str]] = None) -> None:
        """Delete superseded run files — call only after a checkpoint
        superblock NOT referencing them is durable.  ``paths`` restricts
        deletion to files already superseded when that checkpoint was
        captured (async checkpointing: files merged away AFTER the capture
        are still referenced by the captured manifest and must wait for
        the next checkpoint)."""
        doomed = set(self.garbage) if paths is None else (
            set(paths) & set(self.garbage)
        )
        for p in doomed:
            try:
                os.remove(p)
            except OSError:
                pass
        self.garbage = [p for p in self.garbage if p not in doomed]
        for p in doomed:
            self._path_checksums.pop(p, None)

    def clear(self) -> None:
        """Drop in-memory state (restore to a pre-eviction checkpoint);
        files stay on disk — they may be referenced by older checkpoints."""
        self.runs, self.run_paths, self.run_checksums = [], [], []
        self.garbage = []

    def _find(self, id_lo: np.ndarray, id_hi: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
        """(run index or -1, row index) of each u64 id pair, newest run
        first: per run, ``np.searchsorted`` on its id_hi column gives each
        query's rows of that id_hi (the runs are lexsorted by id_hi, then
        id_lo), and one ``np.searchsorted`` on id_lo within each distinct
        such range places the queries that have one."""
        n = len(id_lo)
        run_of = np.full(n, -1, np.int64)
        row_of = np.zeros(n, np.int64)
        for r in range(len(self.runs) - 1, -1, -1):
            todo = np.flatnonzero(run_of < 0)
            run = self.runs[r]
            if len(todo) == 0:
                break
            if len(run) == 0:
                continue
            hi_col = np.asarray(run["id_hi"])
            lo_col = np.asarray(run["id_lo"])
            q_lo, q_hi = id_lo[todo], id_hi[todo]
            start = np.searchsorted(hi_col, q_hi, side="left")
            stop = np.searchsorted(hi_col, q_hi, side="right")
            has = start < stop
            pos = np.zeros(len(todo), np.int64)
            for a in np.unique(start[has]):
                sel = has & (start == a)
                b = int(stop[sel][0])
                pos[sel] = a + np.searchsorted(lo_col[a:b], q_lo[sel],
                                               side="left")
            safe = np.minimum(pos, len(run) - 1)
            ok = has & (pos < stop) & (lo_col[safe] == q_lo)
            run_of[todo[ok]] = r
            row_of[todo[ok]] = pos[ok]
        return run_of, row_of

    def lookup(self, id_lo: int, id_hi: int) -> Optional[np.void]:
        """Newest-first binary search across runs."""
        run_of, row_of = self._find(np.array([id_lo], np.uint64),
                                    np.array([id_hi], np.uint64))
        if run_of[0] < 0:
            return None
        return np.asarray(self.runs[int(run_of[0])][int(row_of[0])])

    def lookup_many(self, ids: List[Tuple[int, int]]) -> Dict[Tuple[int, int], np.void]:
        out = {}
        if not ids:
            return out
        lo = np.array([i[0] for i in ids], np.uint64)
        hi = np.array([i[1] for i in ids], np.uint64)
        run_of, row_of = self._find(lo, hi)
        for j in np.flatnonzero(run_of >= 0):
            out[ids[j]] = np.asarray(self.runs[int(run_of[j])][int(row_of[j])])
        return out

    def lookup_rows(self, id_lo: np.ndarray, id_hi: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """(found bool[n], TRANSFER_DTYPE rows[n], zero where not found) of
        u64 id arrays, gathered per run at once."""
        run_of, row_of = self._find(np.asarray(id_lo, np.uint64),
                                    np.asarray(id_hi, np.uint64))
        rows = np.zeros(len(run_of), dtype=types.TRANSFER_DTYPE)
        for r in np.unique(run_of[run_of >= 0]):
            sel = run_of == r
            rows[sel] = np.asarray(self.runs[int(r)])[row_of[sel]]
        return run_of >= 0, rows

    def rebuild_bloom(self, bits_log2: int) -> np.ndarray:
        bloom = np.zeros(((1 << bits_log2) // 32,), np.uint32)
        for run in self.runs:
            bloom_add_host(
                bloom, np.asarray(run["id_lo"]), np.asarray(run["id_hi"])
            )
        return bloom

    def manifest(self) -> List[dict]:
        return [
            {
                "path": os.path.basename(p),
                "rows": int(len(r)),
                "checksum": f"{c:032x}",
            }
            for p, r, c in zip(self.run_paths, self.runs, self.run_checksums)
        ]

    def verify_manifest(self, manifest: List[dict]) -> List[Tuple[str, int]]:
        """(basename, checksum) of manifest entries whose file is missing or
        corrupt locally — a state-synced checkpoint references the
        RESPONDER's cold runs, which must be fetched before load_manifest
        can succeed (consensus cold-fetch over request_blocks)."""
        damaged = []
        for entry in manifest:
            name = entry["path"]
            if not _safe_basename(name):
                raise ValueError(f"unsafe cold-run manifest path: {name!r}")
            expect = int(entry.get("checksum", "0"), 16)
            path = os.path.join(self.directory or "", name)
            have = self._file_checksum_cached(path)
            if have is None or (expect and have != expect):
                damaged.append((entry["path"], expect))
            elif not expect and len(np.load(path, mmap_mode="r")) != entry["rows"]:
                damaged.append((entry["path"], expect))
        return damaged

    def locate_by_checksum(self, checksum: int) -> Optional[str]:
        """Responder lookup: an on-disk run file whose bytes hash to
        ``checksum`` (cold runs are content-addressed across replicas the
        same way forest files are).  Checks live runs first, then the rest
        of the spill directory — a checkpoint being synced may reference
        runs that a later merge moved to the garbage list (still on disk
        until the next gc)."""
        for path, have in zip(self.run_paths, self.run_checksums):
            if path and have == checksum:
                return path
        if not self.directory or not os.path.isdir(self.directory):
            return None
        for entry in os.listdir(self.directory):
            if not entry.startswith("run_"):
                continue
            path = os.path.join(self.directory, entry)
            if self._file_checksum_cached(path) == checksum:
                return path
        return None

    def install_file(self, basename: str, checksum: int, blob: bytes) -> bool:
        """Write fetched cold-run bytes under the manifest's name; False on
        a checksum mismatch or an unsafe name (corrupt/malicious peer — a
        path-traversing entry like '../x' must not escape the spill dir)."""
        if not _safe_basename(basename):
            return False
        if _checksum(blob) != checksum:
            return False
        assert self.directory, "cold install requires a directory"
        self._ensure_dir()
        path = os.path.join(self.directory, basename)
        atomic_write(path, blob)
        self._path_checksums[path] = checksum
        return True

    def load_manifest(self, manifest: List[dict]) -> None:
        assert self.directory, "cold store reload requires a directory"
        self.runs, self.run_paths, self.run_checksums = [], [], []
        for entry in manifest:
            path = os.path.join(self.directory, entry["path"])
            expect = int(entry.get("checksum", "0"), 16)
            if expect:
                # Memoized: a verify_manifest just before (the sync-install
                # path) already hashed these immutable files once.
                actual = self._file_checksum_cached(path)
                if actual is None:
                    raise FileNotFoundError(path)
                if actual != expect:
                    raise RuntimeError(
                        f"cold run corrupt: {path} (checksum mismatch)"
                    )
            run = np.load(path, mmap_mode="r")
            assert len(run) == entry["rows"], f"cold run truncated: {path}"
            self.runs.append(run)
            self.run_paths.append(path)
            self.run_checksums.append(expect)
        self._scan_next_seq()  # never reuse any on-disk name


# ---------------------------------------------------------------------------
# Eviction kernels
# ---------------------------------------------------------------------------


def _live(table: ht.Table) -> torch.Tensor:
    return ((table.key_lo != 0) | (table.key_hi != 0)) & ~table.tombstone


def eviction_threshold(table: ht.Table, frac_num: int,
                       frac_den: int) -> torch.Tensor:
    """Timestamp T (a 0-dim int64 holding the u64) such that ~frac of the
    live rows have ts <= T; dead slots count as u64 max.  K18 on CUDA
    tensors: the table's ``count`` is read on the card."""
    if table.key_lo.is_cuda:
        return _cuda.evict_threshold(
            table.key_lo, table.key_hi, table.tombstone,
            table.cols["timestamp"], table.count, frac_num, frac_den)[0]
    return eviction_threshold_plain(table, frac_num, frac_den)


def eviction_threshold_plain(table: ht.Table, frac_num: int,
                             frac_den: int) -> torch.Tensor:
    """Plain version of K18: a sort of ``ts ^ INT64_MIN`` (unsigned order),
    then an index."""
    ts = torch.where(_live(table), table.cols["timestamp"],
                     torch.full_like(table.key_lo, _U64MAX))
    order = torch.sort(ts ^ INT64_MIN).values ^ INT64_MIN
    k = torch.clamp((table.count * frac_num) // frac_den,
                    max=table.capacity - 1)
    return order[k]


def _u64_le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a ^ INT64_MIN) <= (b ^ INT64_MIN)


def extract_evicted(table: ht.Table, threshold_ts: torch.Tensor, k: int,
                    keep: bool = False):
    """Compact the rows with ts <= threshold into the first ``k`` lanes.

    Returns (count int64 0-dim, key_lo[k], key_hi[k], cols{...}[k]); the
    caller pulls these to the host and then rebuilds the table.  With
    ``keep`` a fifth item, the live rows above the threshold (bool[C]),
    which ``drop_evicted`` takes.  K19 on CUDA tensors, one pass for both."""
    if table.key_lo.is_cuda:
        n, lo, hi, cols, keep_t = _cuda.evict_extract(
            table.key_lo, table.key_hi, table.tombstone, table.cols,
            threshold_ts.reshape(1), k, keep=keep)
        out = (n[0], lo, hi, cols)
    else:
        out = extract_evicted_plain(table, threshold_ts, k)
        keep_t = keep_mask_plain(table, threshold_ts) if keep else None
    return out + (keep_t,) if keep else out


def extract_evicted_plain(table: ht.Table, threshold_ts: torch.Tensor,
                          k: int):
    """Plain version of K19: a stable sort of ``~evict``, then gathers and
    ``where``."""
    evict = _live(table) & _u64_le(table.cols["timestamp"], threshold_ts)
    order = torch.sort((~evict).to(torch.int8), stable=True).indices
    idx = order[:k]
    n = evict.sum()
    sel = torch.arange(k, device=idx.device) < n
    out_cols = {name: torch.where(sel, col[idx], torch.zeros_like(col[idx]))
                for name, col in table.cols.items()}
    return (n, torch.where(sel, table.key_lo[idx], 0),
            torch.where(sel, table.key_hi[idx], 0), out_cols)


def keep_mask_plain(table: ht.Table, threshold_ts: torch.Tensor) -> torch.Tensor:
    return _live(table) & ~_u64_le(table.cols["timestamp"], threshold_ts)


def drop_evicted(table: ht.Table, threshold_ts: torch.Tensor,
                 keep: Optional[torch.Tensor] = None) -> ht.Table:
    """Rebuild the hot table without the evicted rows (a fresh rehash, no
    tombstone debt): the keep mask (``keep``, from ``extract_evicted``, or
    K19 on CUDA tensors), then ``hash_table.rehash_into`` (K2's insert)
    with every slot as a lane and ``max_probe`` = capacity, as
    ``hash_table.grow`` runs: the round form writes the new table whole.
    With max_probe the
    capacity no lane overflows, so the fresh table's flag stays clear, as
    the JAX function leaves it."""
    if not table.key_lo.is_cuda:
        return drop_evicted_plain(table, threshold_ts, keep)
    if keep is None:
        keep = _cuda.evict_extract(
            table.key_lo, table.key_hi, table.tombstone, table.cols,
            threshold_ts.reshape(1), 0, keep=True)[4]
    return ht.rehash_into(table.capacity, table.key_lo, table.key_hi, keep,
                          table.cols)[0]


def drop_evicted_plain(table: ht.Table, threshold_ts: torch.Tensor,
                       keep: Optional[torch.Tensor] = None) -> ht.Table:
    """Plain version of ``drop_evicted``: the keep mask, then K2's plain
    claim and write."""
    if keep is None:
        keep = keep_mask_plain(table, threshold_ts)
    fresh = ht.make_table(
        table.capacity, {k: v.dtype for k, v in table.cols.items()},
        table.device)
    claimed, _ = ht.claim_slots_plain(fresh, table.key_lo, table.key_hi, keep,
                                      table.capacity)
    return ht.write_rows_plain(fresh, table.key_lo, table.key_hi, claimed,
                               keep, table.cols)


def rows_to_numpy(n, key_lo, key_hi, cols) -> np.ndarray:
    """Assemble extracted device rows into a host TRANSFER_DTYPE array.
    Slices ON DEVICE before the pull: an eviction transfers O(evicted)
    bytes, not O(hot-window capacity)."""
    from ..convert import tensors_to_arrays

    count = int(n)
    host = tensors_to_arrays({"id_lo": key_lo[:count], "id_hi": key_hi[:count],
                              **{name: col[:count] for name, col in cols.items()}})
    return types.from_soa(host, types.TRANSFER_DTYPE)
