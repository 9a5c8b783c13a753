"""LSM-equivalent durable storage: base snapshot + immutable delta runs.

The reference persists state through an LSM forest — mutable memtables flow
into immutable on-disk tables with levelled compaction and a manifest log
(src/lsm/forest.zig, compaction.zig, manifest_log.zig).  On TPU the working
set *is* the HBM ledger (SURVEY §2.4 TPU mapping), so the durable layer
inverts: instead of reads hitting disk levels, checkpoints write **immutable
sorted delta runs** (the changed table slots since the previous checkpoint)
against a **base snapshot**, with:

- ``manifest``: an atomically-written, checksummed file listing the base and
  the live runs (manifest_log.zig's role); its checksum is sealed into the
  superblock, so recovery never trusts an unverified manifest.
- ``compaction``: when the run list exceeds ``compact_runs_max``, runs merge
  newest-wins into one (compaction.zig's multi-level merge collapses to a
  single level because reads never touch disk); when the merged delta
  approaches the base's size, a **major compaction** rewrites the base.
- occupancy bitmaps EWAH-compressed inside runs (free_set.zig's encoding of
  the block free set into the checkpoint; here the free *slots* of the
  device hash tables).

Restart = base + replay runs in sequence order (newest wins per slot),
verified against the superblock's ledger digest by the caller.

File layout next to the data file:
  <data>.checkpoint.<op>   base snapshot (vsr/checkpoint.py format)
  <data>.run.<seq>         delta run (npz + AEGIS whole-file checksum)
  <data>.manifest.<op>     manifest JSON for checkpoint <op>
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..vsr import checkpoint as checkpoint_mod
from ..vsr.checksum import checksum
from ..utils import ewah

TABLES = checkpoint_mod.TABLE_NAMES
_SCALARS = set(checkpoint_mod.TABLE_SCALARS)


@dataclasses.dataclass
class RunRef:
    seq: int
    op: int                 # checkpoint op that produced this run
    file_checksum: int
    rows: int               # total changed slots (compaction heuristic)


@dataclasses.dataclass
class Manifest:
    base_op: int = 0
    base_checksum: int = 0
    base_rows: int = 0      # live rows in the base (major-compaction ratio)
    runs: List[RunRef] = dataclasses.field(default_factory=list)
    next_seq: int = 1

    def to_json(self) -> bytes:
        return json.dumps({
            "base_op": self.base_op,
            "base_checksum": f"{self.base_checksum:032x}",
            "base_rows": self.base_rows,
            "next_seq": self.next_seq,
            "runs": [
                {
                    "seq": r.seq, "op": r.op,
                    "checksum": f"{r.file_checksum:032x}", "rows": r.rows,
                }
                for r in self.runs
            ],
        }, indent=1).encode()

    @classmethod
    def from_json(cls, blob: bytes) -> "Manifest":
        d = json.loads(blob.decode())
        return cls(
            base_op=d["base_op"],
            base_checksum=int(d["base_checksum"], 16),
            base_rows=d.get("base_rows", 0),
            next_seq=d["next_seq"],
            runs=[
                RunRef(
                    seq=r["seq"], op=r["op"],
                    file_checksum=int(r["checksum"], 16), rows=r["rows"],
                )
                for r in d["runs"]
            ],
        )


from ..utils.fs import atomic_write as _atomic_write


class Forest:
    def __init__(
        self,
        data_path: str,
        compact_runs_max: int = 8,
        major_ratio: float = 0.5,
    ) -> None:
        self.data_path = data_path
        self.compact_runs_max = compact_runs_max
        self.major_ratio = major_ratio
        self.manifest = Manifest()
        # Host copy of the table arrays at the last checkpoint (delta source).
        self.prev: Optional[Dict[str, np.ndarray]] = None

    # -- paths ----------------------------------------------------------------

    def run_path(self, seq: int) -> str:
        return f"{self.data_path}.run.{seq}"

    def manifest_path(self, op: int) -> str:
        return f"{self.data_path}.manifest.{op}"

    # -- checkpoint (write path) ----------------------------------------------

    def checkpoint(
        self, ledger, meta: dict, op: int
    ) -> Tuple[int, int]:
        """Durably persist the ledger at checkpoint ``op``; returns
        (base_checksum, manifest_checksum) for the superblock.  Writes a
        delta run when possible, a full base snapshot otherwise (first
        checkpoint, capacity change, or major compaction due)."""
        return self.checkpoint_arrays(
            checkpoint_mod.ledger_to_arrays(ledger), meta, op
        )

    def checkpoint_arrays(
        self, cur: Dict[str, np.ndarray], meta: dict, op: int
    ) -> Tuple[int, int]:
        """checkpoint() on a pre-captured host snapshot — the overlapped
        checkpoint thread calls this so no device access happens off the
        serving thread."""
        if self.prev is None or self._shapes_changed(cur):
            base_checksum = self._write_base(cur, meta, op)
        else:
            delta, rows = self._delta(cur)
            cumulative = rows + sum(r.rows for r in self.manifest.runs)
            if cumulative >= max(1, self.manifest.base_rows) * self.major_ratio:
                # Deltas rival the base: major compaction (rewrite base).
                base_checksum = self._write_base(cur, meta, op)
            else:
                seq = self.manifest.next_seq
                run_checksum = self._write_run(seq, op, delta, meta)
                self.manifest.next_seq = seq + 1
                self.manifest.runs.append(
                    RunRef(seq=seq, op=op, file_checksum=run_checksum, rows=rows)
                )
                if len(self.manifest.runs) > self.compact_runs_max:
                    try:
                        self._compact(op, meta)
                    except (OSError, RuntimeError):
                        # A live run is corrupt/missing on disk: skip the
                        # merge (runs stay referenced); restart-time
                        # verify() routes the damage to peer block repair.
                        pass
                base_checksum = self.manifest.base_checksum
        self.prev = cur
        manifest_checksum = self._write_manifest(op)
        return base_checksum, manifest_checksum

    def _shapes_changed(self, cur: Dict[str, np.ndarray]) -> bool:
        assert self.prev is not None
        for key, arr in cur.items():
            prev = self.prev.get(key)
            if prev is None:
                return True
            if key.startswith("history/cols/"):
                continue  # append-only: capacity growth handled by slicing
            if prev.shape != arr.shape:
                return True
        return False

    def _reset_manifest(self, ledger, op: int, file_checksum: int) -> None:
        """Point the manifest at a fresh base (shared by base writes,
        state-sync adoption, and legacy-snapshot seeding)."""
        occupied = ~np.asarray(ledger.accounts.tombstone) & (
            (np.asarray(ledger.accounts.key_lo) != 0)
            | (np.asarray(ledger.accounts.key_hi) != 0)
        )
        self.manifest = Manifest(
            base_op=op,
            base_checksum=file_checksum,
            base_rows=int(occupied.sum()) + int(ledger.transfers.count),
            next_seq=self.manifest.next_seq,
        )

    def _write_base(self, cur: Dict[str, np.ndarray], meta: dict, op: int) -> int:
        # Sparse base (occupied rows only): base-write cost scales with
        # data, not preallocated capacity (see checkpoint.sparsify_arrays).
        _, file_checksum = checkpoint_mod.save_arrays(
            self.data_path, op, checkpoint_mod.sparsify_arrays(cur), meta
        )
        occupied = ~cur["accounts/tombstone"] & (
            (cur["accounts/key_lo"] != 0) | (cur["accounts/key_hi"] != 0)
        )
        self.manifest = Manifest(
            base_op=op,
            base_checksum=file_checksum,
            base_rows=int(occupied.sum()) + int(cur["transfers/count"]),
            next_seq=self.manifest.next_seq,
        )
        return file_checksum

    def _delta(
        self, cur: Dict[str, np.ndarray]
    ) -> Tuple[Dict[str, np.ndarray], int]:
        """Changed-slot delta between prev and cur (plus history append)."""
        assert self.prev is not None
        out: Dict[str, np.ndarray] = {}
        total_rows = 0
        for t in TABLES:
            prefix = f"{t}/"
            per_slot = [
                k for k in cur
                if k.startswith(prefix) and k.split("/")[-1] not in _SCALARS
            ]
            changed = np.zeros(cur[f"{t}/key_lo"].shape[0], dtype=bool)
            for k in per_slot:
                changed |= self.prev[k] != cur[k]
            (slots,) = np.nonzero(changed)
            out[f"{t}/slots"] = slots.astype(np.uint64)
            for k in per_slot:
                out[f"delta/{k}"] = cur[k][slots]
            out[f"{t}/count"] = cur[f"{t}/count"]
            out[f"{t}/probe_overflow"] = cur[f"{t}/probe_overflow"]
            total_rows += len(slots)
            # EWAH-compressed occupancy bitmap (free_set.zig's role): lets
            # tooling reason about free slots without the full key arrays.
            occ_enc, occ_bits = ewah.encode_bits(
                (cur[f"{t}/key_lo"] != 0) | (cur[f"{t}/key_hi"] != 0)
            )
            out[f"{t}/occupancy_ewah"] = occ_enc
            out[f"{t}/occupancy_bits"] = np.uint64(occ_bits)
        # History: append-only suffix.
        prev_count = int(self.prev["history/count"])
        cur_count = int(cur["history/count"])
        out["history/start"] = np.uint64(prev_count)
        out["history/count"] = cur["history/count"]
        for k in cur:
            if k.startswith("history/cols/"):
                out[f"delta/{k}"] = cur[k][prev_count:cur_count]
        total_rows += cur_count - prev_count
        return out, total_rows

    def _write_run(
        self, seq: int, op: int, delta: Dict[str, np.ndarray], meta: dict
    ) -> int:
        arrays = dict(delta)
        arrays["meta"] = np.frombuffer(
            json.dumps(meta or {}).encode(), dtype=np.uint8
        ).copy()
        arrays["op"] = np.uint64(op)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        blob = buf.getvalue()
        _atomic_write(self.run_path(seq), blob)
        return checksum(blob)

    def _write_manifest(self, op: int) -> int:
        blob = self.manifest.to_json()
        _atomic_write(self.manifest_path(op), blob)
        return checksum(blob)

    # -- compaction -----------------------------------------------------------

    def _compact(self, op: int, meta: dict) -> None:
        """Merge all runs newest-wins into a single run (minor compaction)."""
        loaded = [
            (ref, self._load_run(ref)) for ref in self.manifest.runs
        ]
        out: Dict[str, np.ndarray] = {}
        total_rows = 0
        last = loaded[-1][1]
        for t in TABLES:
            # Newest occurrence of each slot wins: concatenate in run order
            # and take the LAST position per slot (vectorized via a reversed
            # unique — no per-slot Python loops; compaction runs inline in
            # the consensus loop).
            slots_all = np.concatenate(
                [run[f"{t}/slots"] for _, run in loaded]
            ).astype(np.uint64)
            if len(slots_all):
                reversed_slots = slots_all[::-1]
                uniq, first_in_rev = np.unique(
                    reversed_slots, return_index=True
                )
                take = len(slots_all) - 1 - first_in_rev
            else:
                uniq = slots_all
                take = np.zeros(0, dtype=np.int64)
            out[f"{t}/slots"] = uniq
            per_slot = [
                k[len("delta/"):]
                for k in last
                if k.startswith(f"delta/{t}/")
            ]
            for k in per_slot:
                col_all = np.concatenate(
                    [run[f"delta/{k}"] for _, run in loaded]
                )
                out[f"delta/{k}"] = col_all[take]
            out[f"{t}/count"] = last[f"{t}/count"]
            out[f"{t}/probe_overflow"] = last[f"{t}/probe_overflow"]
            out[f"{t}/occupancy_ewah"] = last[f"{t}/occupancy_ewah"]
            out[f"{t}/occupancy_bits"] = last[f"{t}/occupancy_bits"]
            total_rows += len(uniq)
        # History: concatenate ordered appends.
        first = loaded[0][1]
        out["history/start"] = first["history/start"]
        out["history/count"] = last["history/count"]
        for k in last:
            if k.startswith("delta/history/cols/"):
                out[k] = np.concatenate(
                    [run[k] for _, run in loaded if k in run]
                )
        total_rows += int(last["history/count"]) - int(first["history/start"])

        seq = self.manifest.next_seq
        run_checksum = self._write_run(seq, op, out, meta)
        self.manifest.next_seq = seq + 1
        self.manifest.runs = [
            RunRef(seq=seq, op=op, file_checksum=run_checksum, rows=total_rows)
        ]

    # -- open (read path) -----------------------------------------------------

    def open(
        self, op: int, manifest_checksum: int, device=None
    ) -> Tuple[object, dict]:
        """Load base + replay runs for checkpoint ``op``; returns
        (ledger, meta).  Verifies the manifest and every file checksum.
        (The port's one change: the ledger is loaded onto ``device``.)"""
        with open(self.manifest_path(op), "rb") as f:
            blob = f.read()
        if checksum(blob) != manifest_checksum:
            raise RuntimeError("manifest checksum mismatch")
        self.manifest = Manifest.from_json(blob)
        arrays, meta = self._load_base_arrays()
        for ref in self.manifest.runs:
            run = self._load_run(ref)
            meta = self._apply_run(arrays, run)
        self.prev = {
            k: v for k, v in arrays.items() if k != "meta"
        }
        ledger = checkpoint_mod.arrays_to_ledger(self.prev, device)
        return ledger, meta

    def _load_base_arrays(self) -> Tuple[Dict[str, np.ndarray], dict]:
        path = checkpoint_mod.path_for(self.data_path, self.manifest.base_op)
        with open(path, "rb") as f:
            blob = f.read()
        actual = checksum(blob)
        if actual != self.manifest.base_checksum:
            raise RuntimeError(
                f"base snapshot {path}: checksum mismatch"
            )
        z = np.load(io.BytesIO(blob))
        arrays = {
            k: v
            for k, v in checkpoint_mod.densify_arrays(z).items()
            if k != "meta"
        }
        meta = json.loads(bytes(z["meta"]).decode()) if "meta" in z.files else {}
        return arrays, meta

    def _load_run(self, ref: RunRef) -> Dict[str, np.ndarray]:
        with open(self.run_path(ref.seq), "rb") as f:
            blob = f.read()
        if checksum(blob) != ref.file_checksum:
            raise RuntimeError(f"run {ref.seq}: checksum mismatch")
        z = np.load(io.BytesIO(blob))
        return {k: z[k] for k in z.files}

    def _apply_run(
        self, arrays: Dict[str, np.ndarray], run: Dict[str, np.ndarray]
    ) -> dict:
        for t in TABLES:
            slots = run[f"{t}/slots"].astype(np.int64)
            for k in run:
                if k.startswith(f"delta/{t}/"):
                    arrays[k[len("delta/"):]][slots] = run[k]
            arrays[f"{t}/count"] = np.array(run[f"{t}/count"])
            arrays[f"{t}/probe_overflow"] = np.array(run[f"{t}/probe_overflow"])
        start = int(run["history/start"])
        count = int(run["history/count"])
        for k in run:
            if k.startswith("delta/history/cols/"):
                key = k[len("delta/"):]
                col = arrays.get(key)
                rows = run[k]
                if col is None:
                    col = np.zeros(0, dtype=rows.dtype)
                if len(col) < count:
                    grown = np.zeros(
                        max(count, 2 * max(1, len(col))), dtype=col.dtype
                    )
                    grown[: len(col)] = col
                    col = grown
                col[start : start + len(rows)] = rows
                arrays[key] = col
        arrays["history/count"] = np.array(run["history/count"])
        meta_arr = run.get("meta")
        return (
            json.loads(bytes(meta_arr).decode()) if meta_arr is not None else {}
        )

    # -- peer block repair (grid_blocks_missing.zig's role) -------------------
    #
    # Checkpoint files are content-addressed by their AEGIS whole-file
    # checksum (manifest checksum pinned by the superblock, base/run
    # checksums pinned by the manifest), so a replica with a corrupt or
    # missing file can fetch EXACTLY that file from any peer holding bytes
    # with the same checksum — no trust required beyond the checksum chain.

    def verify(self, op: int, manifest_checksum: int) -> List[Tuple[str, int, int]]:
        """Check every file the checkpoint at ``op`` needs; returns damaged
        refs as (kind, ident, expected_checksum) — empty means ``open(op,
        manifest_checksum)`` will succeed.  If the manifest itself is
        damaged, only it is reported (the rest is unknowable until it is
        repaired — the caller re-verifies after each repair)."""
        try:
            with open(self.manifest_path(op), "rb") as f:
                blob = f.read()
            if checksum(blob) != manifest_checksum:
                raise RuntimeError
            manifest = Manifest.from_json(blob)
        except (OSError, RuntimeError, ValueError, KeyError):
            return [("manifest", op, manifest_checksum)]
        damaged: List[Tuple[str, int, int]] = []
        base_path = checkpoint_mod.path_for(self.data_path, manifest.base_op)
        if self._file_checksum(base_path) != manifest.base_checksum:
            damaged.append(("base", manifest.base_op, manifest.base_checksum))
        for ref in manifest.runs:
            if self._file_checksum(self.run_path(ref.seq)) != ref.file_checksum:
                damaged.append(("run", ref.seq, ref.file_checksum))
        return damaged

    @staticmethod
    def _file_checksum(path: str) -> Optional[int]:
        try:
            with open(path, "rb") as f:
                return checksum(f.read())
        except OSError:
            return None

    def _block_path(self, kind: str, ident: int) -> str:
        if kind == "manifest":
            return self.manifest_path(ident)
        if kind == "base":
            return checkpoint_mod.path_for(self.data_path, ident)
        assert kind == "run", kind
        return self.run_path(ident)

    def locate_block(
        self, kind: str, ident: int, block_checksum: int
    ) -> Optional[str]:
        """Responder lookup: a local file whose bytes hash to
        ``block_checksum``.  Tries the hinted path first, then (for runs)
        scans the live manifest — seq numbering may differ across replicas
        when their checkpoint histories diverged; the checksum is the real
        address."""
        path = self._block_path(kind, ident)
        if self._file_checksum(path) == block_checksum:
            return path
        if kind == "run":
            for ref in self.manifest.runs:
                if ref.file_checksum == block_checksum:
                    candidate = self.run_path(ref.seq)
                    if self._file_checksum(candidate) == block_checksum:
                        return candidate
        if kind == "manifest":
            # Serve our current manifest regardless of the op suffix.
            current = max(
                [self.manifest.base_op] + [r.op for r in self.manifest.runs],
                default=ident,
            )
            candidate = self.manifest_path(current)
            if self._file_checksum(candidate) == block_checksum:
                return candidate
        return None

    def repair_block(
        self, kind: str, ident: int, expected_checksum: int, blob: bytes
    ) -> bool:
        """Install fetched bytes for a damaged file; False if the bytes do
        not hash to the pinned checksum (corrupt/malicious peer)."""
        if checksum(blob) != expected_checksum:
            return False
        _atomic_write(self._block_path(kind, ident), blob)
        return True

    # -- sync materialization & GC -------------------------------------------

    def canonical_arrays(self, op: int) -> Tuple[Dict[str, np.ndarray], dict]:
        """(arrays, meta) of the DURABLE state at checkpoint ``op`` —
        base + runs replayed from disk (the incremental state-sync
        responder's source; docs/state_sync.md).  Reading the manifest's
        files, not ``self.prev``, keeps the served state consistent with
        the adopted checkpoint even while an async checkpoint write for a
        NEWER op is still in flight on the background thread."""
        assert op == max(
            [self.manifest.base_op] + [r.op for r in self.manifest.runs]
        ), "can only serve the latest checkpoint"
        arrays, meta = self._load_base_arrays()
        for ref in self.manifest.runs:
            meta = self._apply_run(arrays, self._load_run(ref))
        return arrays, meta

    def materialize_file(self, op: int) -> Tuple[str, int]:
        """Write a single full snapshot for checkpoint ``op`` (state-sync
        responder: a lagging replica wants one blob, not base+runs)."""
        assert op == max(
            [self.manifest.base_op] + [r.op for r in self.manifest.runs]
        ), "can only materialize the latest checkpoint"
        if not self.manifest.runs:
            return checkpoint_mod.path_for(self.data_path, op), (
                self.manifest.base_checksum
            )
        path = f"{self.data_path}.sync.{op}"
        if os.path.exists(path + ".ok"):
            with open(path + ".ok") as f:
                return path, int(f.read(), 16)
        arrays, meta = self.canonical_arrays(op)
        arrays["meta"] = np.frombuffer(
            json.dumps(meta or {}).encode(), dtype=np.uint8
        ).copy()
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        blob = buf.getvalue()
        _atomic_write(path, blob)
        file_checksum = checksum(blob)
        _atomic_write(path + ".ok", f"{file_checksum:032x}".encode())
        return path, file_checksum

    def adopt_base(self, ledger, meta: dict, op: int, file_checksum: int) -> int:
        """After installing a state-synced full snapshot: reset the manifest
        to base-only and return the new manifest checksum."""
        self._reset_manifest(ledger, op, file_checksum)
        self.prev = checkpoint_mod.ledger_to_arrays(ledger)
        return self._write_manifest(op)

    def seed_base(self, ledger, op: int, file_checksum: int) -> None:
        """Adopt a legacy full-snapshot checkpoint as the base WITHOUT any
        disk writes (used at open() of a pre-manifest data file, so state
        sync can still materialize and the next checkpoint goes delta)."""
        self._reset_manifest(ledger, op, file_checksum)
        self.prev = checkpoint_mod.ledger_to_arrays(ledger)

    def gc(self) -> None:
        """Delete files not referenced by the current manifest (called after
        the superblock referencing it is durable)."""
        directory = os.path.dirname(os.path.abspath(self.data_path)) or "."
        base_name = os.path.basename(self.data_path)
        live_runs = {r.seq for r in self.manifest.runs}
        current_op = max(
            [self.manifest.base_op] + [r.op for r in self.manifest.runs]
        )
        for entry in os.listdir(directory):
            if not entry.startswith(base_name + "."):
                continue
            tail = entry[len(base_name) + 1 :]
            full = os.path.join(directory, entry)
            if ".tmp." in tail:
                # Orphan of a crashed atomic write (not ours: our own tmp
                # files only exist inside atomic_write's critical section).
                pid_s = tail.rsplit(".tmp.", 1)[1]
                if not (pid_s.isdigit() and int(pid_s) == os.getpid()):
                    os.unlink(full)
                continue
            if tail.startswith("run."):
                seq_s = tail[4:]
                if seq_s.isdigit() and int(seq_s) not in live_runs:
                    os.unlink(full)
            elif tail.startswith("checkpoint."):
                op_s = tail[len("checkpoint."):]
                if op_s.isdigit() and int(op_s) != self.manifest.base_op:
                    os.unlink(full)
            elif tail.startswith("manifest."):
                op_s = tail[len("manifest."):]
                if op_s.isdigit() and int(op_s) < current_op:
                    os.unlink(full)
            elif tail.startswith("sync."):
                op_s = tail[len("sync."):].removesuffix(".ok")
                if op_s.isdigit() and int(op_s) < current_op:
                    os.unlink(full)
