"""TorchStateMachine: the host-side seam of the port (counterpart of
``tigerbeetle_tpu/machine.py``'s ``TpuStateMachine``), reduced to the slices
ported so far: plain ``create_accounts`` and ``create_transfers`` batches on
the fast path, every other ``create_transfers`` batch on the general kernel
(``ops.transfer_full``), the batches it flags ``FLAG_SEQ`` and every batch
under ``force_sequential`` on the sequential path (and linked
``create_accounts`` batches with duplicate ids), lookups, the transfer
index and the queries (``get_account_transfers``, ``get_account_history``,
the composed scans), the cold tier (``ops.cold``: a tiered machine,
``hot_transfers_capacity_max`` and ``spill_dir``, evicts its oldest
transfers to id-sorted host runs and resolves ids the Bloom filter flags
``FLAG_COLD``), the balance snapshot and the digest.

It owns the device-resident ledger, assigns batch timestamps as prepare()
does, grows the tables and the history log from host-side row bounds (load
factor <= 0.5), pads each batch to ``batch_lanes`` and commits it through
``ops.state_machine`` (kernels K1-K4 on the card), ``ops.transfer_full``
(K1, K2 and K9-K12) or ``ops.scan_path`` (K6 and K7), then reads the result
codes and its routing word (an overflow flag, or the general kernel's flags
and wave vector) back in ONE device-to-host copy and compresses the codes
into the wire's (index, result) pairs.  After every committed batch it
appends the batch to its derived indexes (``ops.index`` and the scan
builder's field indexes: K1, K13 and K14 on the card) unless
``LedgerConfig.lazy_index`` is set, in which case a query rebuilds them
(from the hot table and the cold runs).  A tiered machine commits every
transfer batch on the general kernel (with its Bloom filter; K17 on the
card), evicts between batches once the hot table's bound passes half its
ceiling (K18, K19 and K2's claim and write entries), and merges cold rows
into lookups and query answers on the host.

Routes this slice does not port raise ``NotImplementedError`` naming the
ROADMAP slice that brings them; none gives a wrong answer or falls back
quietly.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import convert, types
from .config import LedgerConfig
from .device import resolve as resolve_device
from .obs.metrics import registry as _obs
from .ops import cold as cold_mod
from .ops import hash_table as ht
from .ops import index as ix
from .ops import query
from .ops import scan_builder as sb
from .ops import scan_path
from .ops import state_machine as sm
from .ops import transfer_full as tf
from .u128 import i64, u64

_LIMIT_FLAGS = (
    types.AccountFlags.DEBITS_MUST_NOT_EXCEED_CREDITS
    | types.AccountFlags.CREDITS_MUST_NOT_EXCEED_DEBITS
)
_BOUND_CLAMP = 1 << 127
# Transfer flags that exclude the plain fast-path batch (P2/P4: two-phase,
# balancing and linked chains run the general kernel).
_SLOW_TRANSFER_FLAGS = (
    types.TransferFlags.POST_PENDING_TRANSFER
    | types.TransferFlags.VOID_PENDING_TRANSFER
    | types.TransferFlags.BALANCING_DEBIT
    | types.TransferFlags.BALANCING_CREDIT
    | types.TransferFlags.LINKED
)
U64_MAX = (1 << 64) - 1
# Largest reply of a query: (message_size_max - header) / row size.
QUERY_ROWS_MAX = ((1 << 20) - 256) // 128

# Entry points of TpuStateMachine that this slice does not port, with the
# ROADMAP queue-A slice that brings each.
_UNPORTED = {
    "commit_fast_deferred": "A8 (commit pipeline)",
    "commit_group_fast": "A8 (commit pipeline)",
    "warmup": "A8 (commit pipeline)",
    "scrub_check": "A9 (scrub)",
    "scrub_arm": "A9 (scrub)",
    "merkle_roots": "A9 (Merkle commitments)",
    "commitment_root": "A9 (Merkle commitments)",
    "get_proof": "A9 (Merkle commitments)",
    "reshard_begin": "A11 (sharding)",
    "host_state": "A6 (persistence)",
    "restore_host_state": "A6 (persistence)",
    "checkpoint_ledger": "A6 (persistence)",
}


class TorchStateMachine:
    def __init__(
        self,
        ledger_config: Optional[LedgerConfig] = None,
        batch_lanes: int = 8192,
        device=None,
        *,
        force_sequential: bool = False,
        shards: Optional[int] = None,
        spill_dir: Optional[str] = None,
        hot_transfers_capacity_max: Optional[int] = None,
        host_engine: bool = False,
    ) -> None:
        if shards:
            raise NotImplementedError("sharding is not ported yet (ROADMAP A11)")
        if host_engine:
            raise NotImplementedError(
                "the host engine is not ported yet (ROADMAP A6)"
            )
        cfg = ledger_config or LedgerConfig()
        self.config = cfg
        self.batch_lanes = batch_lanes
        self.force_sequential = force_sequential
        self.device = resolve_device(device)
        self.ledger = sm.make_ledger(
            cfg.accounts_capacity, cfg.transfers_capacity,
            cfg.posted_capacity, cfg.history_capacity, device=self.device,
        )
        self.prepare_timestamp = 0
        self.commit_timestamp = 0
        # Host-side upper bounds on live rows (growth without device syncs).
        self._accounts_bound = 0
        self._transfers_bound = 0
        self._posted_bound = 0
        self._history_bound = 0
        # Fast-path preconditions P1/P3 (ops/state_machine.py).
        self._history_accounts_possible = False
        self._limit_accounts_possible = False
        self._balance_bound = 0
        self._waves_enabled: Optional[bool] = None
        # The last committed general-kernel batch's wave vector (passes,
        # wave_bound, hist[9]), as read back with its codes.
        self.last_wave: Optional[np.ndarray] = None
        # Derived query indexes (ops/index.py, ops/scan_builder.py), rebuilt
        # from the tables when stale; every rebuild also indexes the cold
        # runs, or evicted transfers would drop out of query answers.
        self.index = ix.TransferIndex(base=batch_lanes, device=self.device)
        self.index.extra_rows_provider = (
            lambda: [np.asarray(r) for r in self.cold.runs])
        self.scans_transfers = sb.ScanSet(
            "transfers", sb.TRANSFER_FIELDS, base=batch_lanes,
            device=self.device)
        self.scans_transfers.extra_rows_provider = (
            lambda: [np.asarray(r) for r in self.cold.runs])
        self.scans_accounts = sb.ScanSet(
            "accounts", sb.ACCOUNT_FIELDS, base=batch_lanes,
            device=self.device)
        self._lane_ids = torch.arange(batch_lanes, device=self.device)
        # Tiered transfers store (ops/cold.py): a hot device window and a
        # cold host spill.  Tiering is driven by the hot-window cap
        # (evictions never trigger without one); spill_dir None keeps the
        # runs in memory.
        self.cold = cold_mod.ColdStore(spill_dir)
        self.hot_transfers_capacity_max = hot_transfers_capacity_max
        self._tiering = hot_transfers_capacity_max is not None
        self._bloom_log2 = cfg.bloom_bits_log2
        self._bloom_np: Optional[np.ndarray] = None
        self._bloom_dev: Optional[torch.Tensor] = None
        self._evictions = 0
        # Plain-int counters: FLAG_COLD attempts resolved, rows rehydrated.
        self.cold_retries = 0
        self.rehydrated_rows = 0
        if self._tiering:
            self._bloom_np = np.zeros(((1 << self._bloom_log2) // 32,),
                                      np.uint32)
            self._bloom_dev = cold_mod.make_bloom(self._bloom_log2,
                                                  self.device)

    @property
    def waves_enabled(self) -> bool:
        """The conflict-index wave scheduler of the general kernel (TB_WAVES,
        default on, as the JAX machine): same codes and ledger, fewer Jacobi
        passes on batches the conflict index certifies.  TB_WAVES=0 runs
        every batch to the stability exit."""
        if self._waves_enabled is None:
            self._waves_enabled = os.environ.get("TB_WAVES", "1") != "0"
        return self._waves_enabled

    @waves_enabled.setter
    def waves_enabled(self, value: bool) -> None:
        self._waves_enabled = bool(value)

    def _d2h_codes(self, codes: torch.Tensor, *words: torch.Tensor):
        """The one blocking device-to-host read of a commit: the result codes
        and the commit's routing words (a table's probe_overflow, the
        sequential path's overflow flag, or the general kernel's kflags and
        wave vector) in a single copy.  Returns (codes u32[N], the words as
        one int32 array)."""
        parts = [codes] + [w.reshape(-1).to(torch.int32) for w in words]
        host = torch.cat(parts).cpu().numpy()
        n = codes.shape[0]
        return host[:n].view(np.uint32), host[n:]

    def prepare(self, operation: str, count: int, wall_clock_ns: int = 0) -> int:
        if wall_clock_ns > self.prepare_timestamp:
            self.prepare_timestamp = wall_clock_ns
        if operation in ("create_accounts", "create_transfers"):
            self.prepare_timestamp += count
        return self.prepare_timestamp

    # -- batch plumbing ------------------------------------------------------

    def _pad_soa(self, batch: np.ndarray) -> dict:
        n = len(batch)
        if n > self.batch_lanes:
            raise ValueError(f"batch of {n} exceeds {self.batch_lanes} lanes")
        return convert.batch_to_tensors(batch, self.batch_lanes, self.device)

    @staticmethod
    def _compress(codes: np.ndarray, count: int) -> List[Tuple[int, int]]:
        codes = codes[:count]
        idx = np.flatnonzero(codes)
        return list(zip(idx.tolist(), codes[idx].tolist()))

    @staticmethod
    def _has_intra_batch_dup_ids(batch: np.ndarray) -> bool:
        # id 0 lanes can never insert (id_must_not_be_zero), so repeats of 0
        # are not order-dependent duplicates.
        nonzero = (batch["id_lo"] != 0) | (batch["id_hi"] != 0)
        ids = np.stack([batch["id_hi"][nonzero], batch["id_lo"][nonzero]], axis=1)
        return len(np.unique(ids, axis=0)) < len(ids)

    def commit_batch(
        self, operation: str, batch: np.ndarray, timestamp: int
    ) -> List[Tuple[int, int]]:
        """Commit a batch whose prepare timestamp was already assigned (the
        replica's StateMachine.commit() seam)."""
        if operation not in ("create_accounts", "create_transfers"):
            raise ValueError(f"unknown commit operation {operation}")
        if timestamp > self.prepare_timestamp:
            self.prepare_timestamp = timestamp
        if operation == "create_accounts":
            return self._commit_create_accounts(batch, timestamp)
        return self._commit_create_transfers(batch, timestamp)

    # -- create_accounts -----------------------------------------------------

    def create_accounts(
        self, batch: np.ndarray, wall_clock_ns: int = 0
    ) -> List[Tuple[int, int]]:
        timestamp = self.prepare("create_accounts", len(batch), wall_clock_ns)
        return self._commit_create_accounts(batch, timestamp)

    def _commit_create_accounts(
        self, batch: np.ndarray, timestamp: int
    ) -> List[Tuple[int, int]]:
        count = len(batch)
        if count == 0:
            return []
        any_linked = bool((batch["flags"] & types.AccountFlags.LINKED).any())
        if self.force_sequential or (
            any_linked and self._has_intra_batch_dup_ids(batch)
        ):
            return self._sequential("create_accounts", batch, timestamp)
        self._grow_if_needed(accounts=count)
        if bool((batch["flags"] & types.AccountFlags.HISTORY).any()):
            self._history_accounts_possible = True
        if bool((batch["flags"] & _LIMIT_FLAGS).any()):
            self._limit_accounts_possible = True
        soa = self._pad_soa(batch)
        self.ledger, codes_dev = sm.create_accounts(self.ledger, soa, count,
                                                    timestamp)
        codes, words = self._d2h_codes(codes_dev,
                                       self.ledger.accounts.probe_overflow)
        self._accounts_bound += count
        if words[0]:
            # Load-factor management keeps this unreachable; losing inserts
            # silently is the one unacceptable outcome, so fail loud.
            raise RuntimeError("accounts probe overflow during insert")
        self._scan_append_accounts(soa, codes_dev, count)
        results = self._compress(codes, count)
        self._update_commit_timestamp(codes, count, timestamp)
        return results

    # -- create_transfers ----------------------------------------------------

    def create_transfers(
        self, batch: np.ndarray, wall_clock_ns: int = 0
    ) -> List[Tuple[int, int]]:
        timestamp = self.prepare("create_transfers", len(batch), wall_clock_ns)
        return self._commit_create_transfers(batch, timestamp)

    def _commit_create_transfers(
        self, batch: np.ndarray, timestamp: int
    ) -> List[Tuple[int, int]]:
        count = len(batch)
        if count == 0:
            return []
        self._note_balance_bound(batch)
        if self.force_sequential:
            return self._sequential("create_transfers", batch, timestamp)
        if self._fast_path_ok(batch):
            return self._commit_fast(batch, timestamp, count)
        return self._commit_full(batch, timestamp, count)

    def _note_balance_bound(self, batch: np.ndarray) -> None:
        """Over-approximate the largest possible single balance field after
        this batch (fast-path precondition P3)."""
        if self._balance_bound >= _BOUND_CLAMP or len(batch) == 0:
            return
        mx = (int(batch["amount_hi"].max()) << 64) | int(batch["amount_lo"].max())
        n_bal = int((
            (batch["flags"]
             & (types.TransferFlags.BALANCING_DEBIT
                | types.TransferFlags.BALANCING_CREDIT)) != 0
        ).sum())
        self._balance_bound += len(batch) * mx + n_bal * ((1 << 64) - 1)
        if self._balance_bound > _BOUND_CLAMP:
            self._balance_bound = _BOUND_CLAMP

    def _fast_path_ok(self, batch: np.ndarray) -> bool:
        """Preconditions P1-P4 of ops/state_machine.py, checked host-side; a
        tiered machine runs the general kernel, which carries the Bloom
        filter."""
        if (
            self._tiering
            or self._history_accounts_possible
            or self._limit_accounts_possible
            or self._balance_bound >= (1 << 126)
        ):
            return False
        if bool((batch["flags"] & _SLOW_TRANSFER_FLAGS).any()):
            return False
        if bool(batch["amount_hi"].any()):
            return False
        return True

    def _commit_fast(
        self, batch: np.ndarray, timestamp: int, count: int
    ) -> List[Tuple[int, int]]:
        self._grow_if_needed(transfers=count)
        soa = self._pad_soa(batch)
        self.ledger, codes_dev = sm.create_transfers_fast(
            self.ledger, soa, count, timestamp
        )
        codes, words = self._d2h_codes(
            codes_dev, self.ledger.transfers.probe_overflow
        )
        self._transfers_bound += count
        if words[0]:
            raise RuntimeError("transfers probe overflow during fast insert")
        self._index_append(soa, codes_dev, count)
        results = self._compress(codes, count)
        self._update_commit_timestamp(codes, count, timestamp)
        return results

    # -- the general kernel -----------------------------------------------------

    def _commit_full(
        self, batch: np.ndarray, timestamp: int, count: int
    ) -> List[Tuple[int, int]]:
        """The JAX machine's general-kernel branch: grow from host bounds,
        then up to eight attempts; kflags 0 commits (and, tiered, evicts if
        the hot table is due), FLAG_COLD resolves the batch's ids against
        the cold store and retries with the lanes certified, FLAG_SEQ runs
        the batch on the sequential path, a FLAG_GROW_* bit doubles the
        flagged tables (or evicts, at the hot ceiling) and retries; the
        kernel applied nothing on any flag, and the flags are taken in that
        order."""
        pv_count, hist_count = self._transfer_growth_counts(batch)
        self._grow_if_needed(transfers=count, posted=pv_count, history=hist_count)
        soa = self._pad_soa(batch)
        cold_checked = self._cold_certified(False) if self._tiering else None
        # Static phase hints: no post/void lanes skips the pending-side
        # probes and the posted write; no HISTORY account skips the append.
        has_postvoid = pv_count > 0
        has_history = self._history_accounts_possible
        use_waves = self.waves_enabled
        for _attempt in range(8):
            r = tf.create_transfers_full_impl(
                self.ledger, soa, count, timestamp, self._bloom_dev,
                cold_checked, max_passes=self.config.jacobi_max_passes,
                has_postvoid=has_postvoid, has_history=has_history,
                use_waves=use_waves,
            )
            self.ledger = r[0]
            codes, words = self._d2h_codes(*r[1:])
            kflags = int(words[0])
            wave_host = words[1:] if use_waves else None
            if kflags == 0:
                results = self._full_commit_success(
                    soa, r[1], codes, count, pv_count, hist_count, timestamp,
                    wave_host)
                # Eviction is only safe between batches: mid-loop it would
                # void the certification and the batch's hot gathers.
                self._maybe_evict_between_batches()
                return results
            ev0 = self._evictions
            if kflags & tf.FLAG_COLD:
                # Possibly-cold ids: resolve them exactly, rehydrate the real
                # cold rows and certify the batch, so Bloom false positives
                # end; an eviction meanwhile voids the certificate.
                self._resolve_cold(batch)
                cold_checked = self._cold_certified(self._evictions == ev0)
                self.cold_retries += 1
                continue
            if kflags & tf.FLAG_SEQ:
                return self._sequential("create_transfers", batch, timestamp)
            self._grow_flagged(kflags)
            if self._tiering and self._evictions != ev0:
                cold_checked = self._cold_certified(False)
        raise RuntimeError("transfer kernel could not place batch after growth")

    def _full_commit_success(self, soa, codes_dev, codes, count, pv_count,
                             hist_count, timestamp, wave_host):
        """Bookkeeping of a committed general-kernel batch (kflags == 0):
        ``codes_dev`` the codes on the device, ``codes`` read back."""
        if wave_host is not None:
            self.last_wave = wave_host
            if _obs.enabled:
                self._record_wave_metrics(wave_host)
        self._transfers_bound += count
        self._posted_bound += pv_count
        self._history_bound += hist_count
        self._index_append(soa, codes_dev, count)
        results = self._compress(codes, count)
        self._update_commit_timestamp(codes, count, timestamp)
        return results

    def _record_wave_metrics(self, wave_host) -> None:
        """Wave occupancy series: wave_host is (passes, bound, hist[9])."""
        passes, bound = int(wave_host[0]), int(wave_host[1])
        hist = [int(v) for v in wave_host[2:]]
        if bound > 0:
            _obs.counter("waves.batches_scheduled").inc()
            _obs.histogram("waves.bound_passes", "passes").observe(bound)
        else:
            _obs.counter("waves.batches_unscheduled").inc()
        _obs.histogram("waves.jacobi_passes", "passes").observe(passes)
        total = sum(hist)
        if total:
            _obs.histogram("waves.wave0_pct", "%").observe(
                100 * hist[0] // total
            )

    def _cold_certified(self, value: bool) -> torch.Tensor:
        """A ``cold_checked`` mask: every lane certified, or none."""
        fill = torch.ones if value else torch.zeros
        return fill(self.batch_lanes, dtype=torch.bool, device=self.device)

    def _grow_flagged(self, kflags: int) -> None:
        """Double each table a probe overflow flagged (one K2 rehash each);
        at the hot ceiling the transfers table spills instead."""
        led = self.ledger
        if kflags & tf.FLAG_GROW_ACCOUNTS:
            led.accounts = ht.grow(led.accounts, led.accounts.capacity * 2)
        if kflags & tf.FLAG_GROW_TRANSFERS:
            hot_max = self.hot_transfers_capacity_max
            if hot_max is not None and led.transfers.capacity >= hot_max:
                # Never allocate past the budget the ceiling encodes: make
                # room by spilling (the caller resets the certificate).
                self.evict_cold()
            else:
                led.transfers = ht.grow(led.transfers,
                                        led.transfers.capacity * 2)
        if kflags & tf.FLAG_GROW_POSTED:
            led.posted = ht.grow(led.posted, led.posted.capacity * 2)

    # -- the sequential path ----------------------------------------------------

    def _sequential(
        self, operation: str, batch: np.ndarray, timestamp: int
    ) -> List[Tuple[int, int]]:
        """Exact in-order execution through ops/scan_path (kernels K6 and
        K7 on the card), as the JAX machine's ``_sequential_impl`` (without
        its Merkle hook, which is not ported): the scan path sees only the
        hot table, so a tiered machine first rehydrates the cold rows the
        batch names."""
        count = len(batch)
        if operation == "create_accounts":
            self._grow_if_needed(accounts=count)
            if bool((batch["flags"] & types.AccountFlags.HISTORY).any()):
                self._history_accounts_possible = True
            if bool((batch["flags"] & _LIMIT_FLAGS).any()):
                self._limit_accounts_possible = True
            pv_count = hist_count = 0
            kernel = scan_path.create_accounts_seq
        else:
            if self.cold.count:
                self._resolve_cold(batch)
            pv_count, hist_count = self._transfer_growth_counts(batch)
            self._grow_if_needed(
                transfers=count, posted=pv_count, history=hist_count
            )
            kernel = scan_path.create_transfers_seq
        soa = self._pad_soa(batch)
        self.ledger, codes_dev, overflow = kernel(self.ledger, soa, count,
                                                  timestamp)
        codes, words = self._d2h_codes(codes_dev, overflow)
        overflow = bool(words[0])
        if operation == "create_accounts":
            self._accounts_bound += count
        else:
            self._transfers_bound += count
            self._posted_bound += pv_count
            self._history_bound += hist_count
        if overflow:
            # The reference writes such a row at slot 0; load-factor
            # management keeps this unreachable, so fail loud.
            raise RuntimeError(
                f"{operation}: a sequential insert's probe reached MAX_PROBE"
            )
        if operation == "create_accounts":
            self._scan_append_accounts(soa, codes_dev, count)
        else:
            self._index_append(soa, codes_dev, count)
        results = self._compress(codes, count)
        self._update_commit_timestamp(codes, count, timestamp)
        return results

    def _transfer_growth_counts(self, batch: np.ndarray) -> Tuple[int, int]:
        """(posted rows, history rows) this batch could append at most."""
        pv = int(
            (
                (batch["flags"]
                 & (types.TransferFlags.POST_PENDING_TRANSFER
                    | types.TransferFlags.VOID_PENDING_TRANSFER)) != 0
            ).sum()
        )
        hist = (len(batch) - pv) if self._history_accounts_possible else 0
        return pv, hist

    # -- growth ----------------------------------------------------------------

    @staticmethod
    def _target_capacity(capacity: int, needed_rows: int) -> int:
        """Smallest power-of-two capacity keeping load factor <= 0.5."""
        while needed_rows * 2 > capacity:
            capacity *= 2
        return capacity

    def _grow_if_needed(
        self, accounts: int = 0, transfers: int = 0, posted: int = 0,
        history: int = 0, evict_ok: bool = True,
    ) -> None:
        """Keep every table's load factor under 0.5 using host-side row
        bounds (no device sync; bounds only overestimate), and the history
        log's capacity above its bound.  Each table growth is one rehash
        through kernel K2.  At the hot ceiling the transfers table spills
        its oldest rows instead of growing (unless ``evict_ok`` is False, as
        in a rehydration mid-commit: then its load may rise until the next
        eviction between batches)."""
        led = self.ledger
        cap = self._target_capacity(
            led.accounts.capacity, self._accounts_bound + accounts
        )
        if cap != led.accounts.capacity:
            led.accounts = ht.grow(led.accounts, cap)
        cap = self._target_capacity(
            led.transfers.capacity, self._transfers_bound + transfers
        )
        if cap != led.transfers.capacity:
            hot_max = self.hot_transfers_capacity_max
            if hot_max is not None and cap > hot_max and (
                led.transfers.capacity >= hot_max
            ):
                if evict_ok:
                    self.evict_cold()
            else:
                if hot_max is not None:
                    cap = min(cap, max(hot_max, led.transfers.capacity))
                if cap != led.transfers.capacity:
                    led.transfers = ht.grow(led.transfers, cap)
        cap = self._target_capacity(
            led.posted.capacity, self._posted_bound + posted
        )
        if cap != led.posted.capacity:
            led.posted = ht.grow(led.posted, cap)
        if history and self._history_bound + history > led.history.capacity:
            led.history = sm.grow_history(
                led.history, self._history_bound + history
            )

    # -- the cold tier (ops/cold.py) -------------------------------------------

    def _maybe_evict_between_batches(self) -> None:
        hot_max = self.hot_transfers_capacity_max
        if hot_max is not None and self._transfers_bound * 2 > hot_max and (
            self.ledger.transfers.capacity >= hot_max
        ):
            self.evict_cold()

    def _resolve_cold(self, batch: np.ndarray) -> None:
        """Host-exact resolution of a FLAG_COLD batch: rehydrate every cold
        row the batch names by id or pending_id into the hot table, in the
        ids' sorted order (the JAX machine's), skipping ids already hot."""
        lo = np.concatenate([batch["id_lo"], batch["pending_id_lo"]])
        hi = np.concatenate([batch["id_hi"], batch["pending_id_hi"]])
        order = np.lexsort((hi, lo))  # sorted (lo, hi) pairs
        lo, hi = lo[order], hi[order]
        first = np.ones(len(lo), dtype=bool)
        first[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
        first &= (lo != 0) | (hi != 0)
        found, rows = self.cold.lookup_rows(lo[first], hi[first])
        if not found.any():
            return
        rows = rows[found]
        # Double-inserting a key would break the hot table's uniqueness.
        lo, hi = self._id_tensors(rows["id_lo"], rows["id_hi"], len(rows))
        hot, _ = sm.lookup_transfers(self.ledger, lo, hi)
        rows = rows[~convert.tensor_to_array(hot)]
        if len(rows):
            self._rehydrate(rows)

    def _rehydrate(self, rows: np.ndarray) -> None:
        """Insert cold rows back into the hot table (K2), as duplicates of
        their cold copies; a later eviction may spill them again.  No
        eviction here: mid-commit it would void the batch's certificate."""
        self._grow_if_needed(transfers=len(rows), evict_ok=False)
        n = len(rows)
        lanes = max(self.batch_lanes, 1 << (n - 1).bit_length() if n else 1)
        soa = convert.batch_to_tensors(rows, lanes, self.device)
        mask = torch.arange(lanes, device=self.device) < n
        row_cols = {name: soa[name] for name in sm.TRANSFER_COLS}
        transfers, _ = ht.insert(self.ledger.transfers, soa["id_lo"],
                                 soa["id_hi"], mask, row_cols,
                                 self.config.max_probe)
        if bool(transfers.probe_overflow):
            raise RuntimeError("cold rehydration overflowed the hot table")
        self._transfers_bound += n
        self.rehydrated_rows += n

    def evict_cold(self, frac: Optional[float] = None) -> int:
        """Spill the oldest ~frac of live hot transfers to the cold store.
        Deterministic given the ledger state; called at checkpoint
        boundaries by the replica, or directly under memory pressure.
        Returns the number of rows evicted."""
        return self._evict_cold_impl(frac)

    def _evict_cold_impl(self, frac: Optional[float] = None) -> int:
        if not self._tiering:
            self._tiering = True
            self._bloom_np = np.zeros(((1 << self._bloom_log2) // 32,),
                                      np.uint32)
        if frac is None:
            frac = self.config.eviction_fraction
        num = max(1, min(999, int(frac * 1000)))
        t = self.ledger.transfers
        threshold = cold_mod.eviction_threshold(t, num, 1000)
        n, key_lo, key_hi, cols, keep = cold_mod.extract_evicted(
            t, threshold, t.capacity, keep=True)
        rows = cold_mod.rows_to_numpy(n, key_lo, key_hi, cols)
        if len(rows) == 0:
            return 0
        self.cold.append_run(rows)
        self.ledger.transfers = cold_mod.drop_evicted(t, threshold, keep)
        cold_mod.bloom_add_host(
            self._bloom_np, rows["id_lo"].astype(np.uint64),
            rows["id_hi"].astype(np.uint64),
        )
        self._maybe_grow_bloom()
        self._bloom_dev = convert.bloom_to_tensor(self._bloom_np, self.device)
        self._transfers_bound = max(0, self._transfers_bound - len(rows))
        self._evictions += 1
        # The query index stores ids, not slots, so it stays valid; evicted
        # rows are resolved from the cold store at query time.
        return len(rows)

    def _maybe_grow_bloom(self) -> None:
        """Keep >= ~12 bits per cold id (false-positive rate ~1e-3 at 4
        hashes); rebuild from the runs at the next power of two if not."""
        while self.cold.count * 12 > (1 << self._bloom_log2):
            self._bloom_log2 += 2
            self._bloom_np = self.cold.rebuild_bloom(self._bloom_log2)

    def _update_commit_timestamp(
        self, codes: np.ndarray, count: int, timestamp: int
    ) -> None:
        ok_lanes = np.nonzero(codes[:count] == 0)[0]
        if len(ok_lanes):
            self.commit_timestamp = timestamp - count + int(ok_lanes[-1]) + 1

    # -- derived indexes -----------------------------------------------------

    def _ok_mask(self, codes_dev: torch.Tensor, count: int) -> torch.Tensor:
        """The committed lanes, on the device: code 0 below ``count``."""
        return (codes_dev == 0) & (self._lane_ids < count)

    def _index_append(self, soa: dict, codes_dev: torch.Tensor,
                      count: int) -> None:
        """Append a committed create_transfers batch to the transfer index
        and the materialized transfer field indexes; with ``lazy_index``
        (bulk ingest) mark them stale instead, and the next query rebuilds
        them from the table in one go."""
        if self.config.lazy_index:
            if not self.index.stale:
                self.index.reset()
            self.scans_transfers.reset()
            return
        ok = self._ok_mask(codes_dev, count)
        self.index.append_batch(self.ledger, soa["id_lo"], soa["id_hi"], ok)
        if self.scans_transfers.indexes:
            self.scans_transfers.append_batch(
                self.ledger, soa["id_lo"], soa["id_hi"], ok)

    def _scan_append_accounts(self, soa: dict, codes_dev: torch.Tensor,
                              count: int) -> None:
        if not self.scans_accounts.indexes:
            return
        if self.config.lazy_index:
            self.scans_accounts.reset()
            return
        self.scans_accounts.append_batch(
            self.ledger, soa["id_lo"], soa["id_hi"],
            self._ok_mask(codes_dev, count))

    # -- lookups -------------------------------------------------------------

    def _ids(self, ids: List[int]):
        lo = torch.tensor([i64(i & U64_MAX) for i in ids], dtype=torch.int64)
        hi = torch.tensor([i64(i >> 64) for i in ids], dtype=torch.int64)
        return lo.to(self.device), hi.to(self.device)

    def lookup_accounts(self, ids: List[int]) -> np.ndarray:
        """Found accounts as an ACCOUNT_DTYPE array (misses omitted)."""
        if not ids:
            return np.zeros(0, dtype=types.ACCOUNT_DTYPE)
        found, cols = sm.lookup_accounts(self.ledger, *self._ids(ids))
        host = {k: convert.tensor_to_array(v) for k, v in cols.items()}
        host["reserved"] = np.zeros(len(ids), np.uint32)
        rows = types.from_soa(host, types.ACCOUNT_DTYPE)
        return rows[convert.tensor_to_array(found)]

    def lookup_transfers(self, ids: List[int]) -> np.ndarray:
        """Found transfers as a TRANSFER_DTYPE array (misses omitted), in the
        order asked; a miss in the hot table may be found in the cold
        store."""
        if not ids:
            return np.zeros(0, dtype=types.TRANSFER_DTYPE)
        lo, hi = self._ids(ids)
        found, cols = sm.lookup_transfers(self.ledger, lo, hi)
        host = convert.tensors_to_arrays({"_found": found, **cols})
        found = host.pop("_found")
        rows = types.from_soa(host, types.TRANSFER_DTYPE)
        if self.cold.count and not found.all():
            miss = ~found
            ids_lo = np.array([i & U64_MAX for i in ids], np.uint64)[miss]
            ids_hi = np.array([i >> 64 for i in ids], np.uint64)[miss]
            cold_found, cold_rows = self.cold.lookup_rows(ids_lo, ids_hi)
            rows[miss] = cold_rows
            found = found.copy()
            found[miss] = cold_found
        return rows[found]

    # -- queries (state_machine.zig:693-892, 1128-1195) ----------------------

    @staticmethod
    def _filter_window(filt: np.void) -> Optional[Tuple[int, int, int, int, bool, int]]:
        """Validate an AccountFilter and resolve its effective window, as
        get_scan_from_filter (state_machine.zig:823-837): an invalid filter
        gives None (an empty result, not an error).  Returns (acct_lo,
        acct_hi, ts_min, ts_max, descending, limit)."""
        acct_lo = int(filt["account_id_lo"])
        acct_hi = int(filt["account_id_hi"])
        ts_min = int(filt["timestamp_min"])
        ts_max = int(filt["timestamp_max"])
        limit = int(filt["limit"])
        flags = int(filt["flags"])
        valid = (
            (acct_lo, acct_hi) != (0, 0)
            and (acct_lo, acct_hi) != (U64_MAX, U64_MAX)
            and ts_min != U64_MAX
            and ts_max != U64_MAX
            and (ts_max == 0 or ts_min <= ts_max)
            and limit != 0
            and flags & (types.AccountFilterFlags.DEBITS
                         | types.AccountFilterFlags.CREDITS)
            and flags & ~0x7 == 0
            and not bytes(filt["reserved"]).strip(b"\0")
        )
        if not valid:
            return None
        # TimestampRange defaults (lsm/timestamp_range.zig:4-5).
        eff_min = ts_min if ts_min != 0 else 1
        eff_max = ts_max if ts_max != 0 else U64_MAX - 1
        descending = bool(flags & types.AccountFilterFlags.REVERSED)
        return acct_lo, acct_hi, eff_min, eff_max, descending, limit

    def get_account_transfers(self, filt: np.void) -> np.ndarray:
        """Transfers on either side of the filtered account, timestamp-
        ordered (prefetch_get_account_transfers, state_machine.zig:693-723),
        from the sorted-runs index: a binary search and a bounded window per
        level (K15), flat in the table's capacity."""
        window = self._filter_window(filt)
        if window is None:
            return np.zeros(0, dtype=types.TRANSFER_DTYPE)
        acct_lo, acct_hi, ts_min, ts_max, descending, limit = window
        flags = int(filt["flags"])
        # Candidate cap: the power of two covering the largest reply.
        k = 1 << (QUERY_ROWS_MAX - 1).bit_length()
        valid, tid_lo, tid_hi = self.index.query(
            self.ledger, acct_lo, acct_hi, ts_min, ts_max,
            bool(flags & types.AccountFilterFlags.DEBITS),
            bool(flags & types.AccountFilterFlags.CREDITS),
            k, descending)
        return self._resolve_transfer_rows(tid_lo, tid_hi, valid, limit)

    def _resolve_transfer_rows(self, tid_lo: torch.Tensor,
                               tid_hi: torch.Tensor, valid: torch.Tensor,
                               limit: int) -> np.ndarray:
        """Timestamp-ordered index hits (transfer ids) as wire rows: one
        batched lookup (K1) and one read-back, then the dedup of adjacent
        repeats of an id (a rebuild can index a rehydrated transfer from
        both the hot table and its cold run), and the hits missing from the
        hot table resolved from the cold store, in place."""
        found, cols = sm.lookup_transfers(self.ledger, tid_lo, tid_hi)
        host = convert.tensors_to_arrays(
            {"_valid": valid, "_found": found, "_tl": tid_lo, "_th": tid_hi,
             **cols})
        idx_valid = host.pop("_valid")
        found = host.pop("_found")
        tl, th = host.pop("_tl"), host.pop("_th")
        if len(tl) > 1:
            dup = np.zeros(len(tl), dtype=bool)
            dup[1:] = (idx_valid[1:] & idx_valid[:-1]
                       & (tl[1:] == tl[:-1]) & (th[1:] == th[:-1]))
            idx_valid = idx_valid & ~dup
        out = types.from_soa(host, types.TRANSFER_DTYPE)
        cold = idx_valid & ~found
        if self.cold.count and cold.any():
            cold_found, cold_rows = self.cold.lookup_rows(tl[cold], th[cold])
            out[cold] = cold_rows
            found = found.copy()
            found[cold] = cold_found
        return out[idx_valid & found][: min(limit, QUERY_ROWS_MAX)]

    # -- composed scans (ops/scan_builder.py) ----------------------------------

    @staticmethod
    def _scan_window(timestamp_min: int, timestamp_max: int) -> Tuple[int, int]:
        # TimestampRange defaults (lsm/timestamp_range.zig:4-5).
        return (
            timestamp_min if timestamp_min else 1,
            timestamp_max if timestamp_max else U64_MAX - 1,
        )

    def _id_tensors(self, lo: np.ndarray, hi: np.ndarray, n: int):
        """``lo``/``hi`` (u64) zero-padded to ``n`` lanes, on the device."""
        both = np.zeros((2, n), np.uint64)
        both[0, :len(lo)], both[1, :len(hi)] = lo, hi
        t = convert.array_to_tensor(both, self.device)
        return t[0], t[1]

    def scan_transfers(
        self, expr, timestamp_min: int = 0, timestamp_max: int = 0,
        limit: int = QUERY_ROWS_MAX, reversed: bool = False,
    ) -> np.ndarray:
        """Composed index scan over transfers: any ``ops.scan_builder``
        expression (prefix conditions on any indexed field, union /
        intersection / difference to any depth), timestamp-ordered."""
        ts_min, ts_max = self._scan_window(timestamp_min, timestamp_max)
        limit = min(limit, QUERY_ROWS_MAX)
        tid_lo, tid_hi = self.scans_transfers.evaluate(
            expr, self.ledger, ts_min, ts_max, limit, bool(reversed))
        n = len(tid_lo)
        if n == 0:
            return np.zeros(0, dtype=types.TRANSFER_DTYPE)
        # Pad the ids to a power of two, as the JAX machine does.
        cap = 1 << (n - 1).bit_length()
        lo, hi = self._id_tensors(tid_lo, tid_hi, cap)
        valid = self._lane_ids.new_zeros(cap, dtype=torch.bool)
        valid[:n] = True
        return self._resolve_transfer_rows(lo, hi, valid, limit)

    def scan_accounts(
        self, expr, timestamp_min: int = 0, timestamp_max: int = 0,
        limit: int = QUERY_ROWS_MAX, reversed: bool = False,
    ) -> np.ndarray:
        """Composed index scan over accounts (one batched lookup)."""
        ts_min, ts_max = self._scan_window(timestamp_min, timestamp_max)
        limit = min(limit, QUERY_ROWS_MAX)
        tid_lo, tid_hi = self.scans_accounts.evaluate(
            expr, self.ledger, ts_min, ts_max, limit, bool(reversed))
        ids = [int(lo) | (int(hi) << 64) for lo, hi in zip(tid_lo, tid_hi)]
        if not ids:
            return np.zeros(0, dtype=types.ACCOUNT_DTYPE)
        # Padded to a power of two; id 0 never exists, so the pad lanes drop
        # out as misses.
        cap = 1 << (len(ids) - 1).bit_length()
        return self.lookup_accounts(ids + [0] * (cap - len(ids)))

    def query_transfers_where(
        self, timestamp_min: int = 0, timestamp_max: int = 0,
        limit: int = QUERY_ROWS_MAX, reversed: bool = False, **conditions,
    ) -> np.ndarray:
        """QueryFilter-style query: the intersection of equality conditions
        on indexed fields (e.g. ``ledger=1, code=5``)."""
        if not conditions:
            raise ValueError("query_transfers_where needs >=1 condition")
        expr = sb.merge_intersection(
            *(sb.scan_prefix(f, v) for f, v in sorted(conditions.items())))
        return self.scan_transfers(expr, timestamp_min, timestamp_max, limit,
                                   reversed)

    def query_accounts_where(
        self, timestamp_min: int = 0, timestamp_max: int = 0,
        limit: int = QUERY_ROWS_MAX, reversed: bool = False, **conditions,
    ) -> np.ndarray:
        if not conditions:
            raise ValueError("query_accounts_where needs >=1 condition")
        expr = sb.merge_intersection(
            *(sb.scan_prefix(f, v) for f, v in sorted(conditions.items())))
        return self.scan_accounts(expr, timestamp_min, timestamp_max, limit,
                                  reversed)

    def get_account_history(self, filt: np.void) -> np.ndarray:
        """Balance history of a HISTORY-flagged account
        (prefetch_get_account_history, state_machine.zig:736-797): empty
        unless the account exists and carries the flag.  K16 on the card."""
        window = self._filter_window(filt)
        if window is None:
            return np.zeros(0, dtype=types.ACCOUNT_BALANCE_DTYPE)
        acct_lo, acct_hi, ts_min, ts_max, descending, limit = window
        account = self.lookup_accounts([acct_lo | (acct_hi << 64)])
        if len(account) == 0 or not (
            int(account[0]["flags"]) & types.AccountFlags.HISTORY
        ):
            return np.zeros(0, dtype=types.ACCOUNT_BALANCE_DTYPE)
        flags = int(filt["flags"])
        k = min(self.ledger.history.capacity, QUERY_ROWS_MAX)
        valid, rows = query.scan_history(
            self.ledger, acct_lo, acct_hi, ts_min, ts_max,
            bool(flags & types.AccountFilterFlags.DEBITS),
            bool(flags & types.AccountFilterFlags.CREDITS),
            descending, k)
        host = convert.tensors_to_arrays({"_valid": valid, **rows})
        valid = host.pop("_valid")
        host["reserved"] = np.zeros(len(valid), dtype="V56")
        out = types.from_soa(host, types.ACCOUNT_BALANCE_DTYPE)
        return out[valid][: min(limit, k)]

    # -- parity surface ------------------------------------------------------

    def balances_snapshot(self) -> List[Tuple[int, int, int, int, int, int]]:
        """(id, dp, dpo, cp, cpo, ts) sorted by id — comparable with
        ReferenceStateMachine.balances_snapshot()."""
        a = self.ledger.accounts
        key_lo = convert.tensor_to_array(a.key_lo)
        key_hi = convert.tensor_to_array(a.key_hi)
        live = (key_lo != 0) | (key_hi != 0)
        cols = {k: convert.tensor_to_array(v)[live] for k, v in a.cols.items()}
        ids = (key_hi[live].astype(object) << 64) | key_lo[live].astype(object)

        def u128_col(name):
            return (cols[name + "_hi"].astype(object) << 64) | cols[
                name + "_lo"
            ].astype(object)

        out = zip(
            ids,
            u128_col("debits_pending"),
            u128_col("debits_posted"),
            u128_col("credits_pending"),
            u128_col("credits_posted"),
            (int(t) for t in cols["timestamp"]),
        )
        return sorted(
            (int(a_), int(b), int(c), int(d), int(e), int(f))
            for a_, b, c, d, e, f in out
        )

    def digest(self) -> int:
        return u64(sm.ledger_digest(self.ledger).item())


def _unported(name: str, where: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"TorchStateMachine.{name} is not ported yet (ROADMAP {where})"
        )

    method.__name__ = name
    return method


for _name, _where in _UNPORTED.items():
    setattr(TorchStateMachine, _name, _unported(_name, _where))
