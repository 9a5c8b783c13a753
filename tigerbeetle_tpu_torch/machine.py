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

The device fault domain (``ops/scrub.py``, ``ops/merkle.py``; off by
default, ``TB_SCRUB_INTERVAL``, ``TB_MERKLE``, ``TB_SCRUB_PARANOID`` and
``TB_MERKLE_ASYNC`` or the setters): once ``scrub_arm`` ran, every blocking
commit goes through ``_guarded_commit``, which checks the at-rest state
before the commit when a scrub is due (the mirror's digests against K21's
folds, and/or the maintained Merkle roots against K22's recomputed ones),
retries a commit whose dispatch raised a device fault (``DEVICE_FAULT_TYPES``)
after rebuilding the ledger from the host mirror, and advances the mirror
and the commitment forest (K1 and K23) after each success.  Roots, proofs
and digests equal the JAX machine's.

Routes this slice does not port raise ``NotImplementedError`` naming the
ROADMAP slice that brings them; none gives a wrong answer or falls back
quietly.
"""

from __future__ import annotations

import os
import random as _random
import time as _time
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
from .ops import merkle as merkle_ops
from .ops import query
from .ops import scan_builder as sb
from .ops import scan_path
from .ops import scrub as scrub_ops
from .ops import state_machine as sm
from .ops import transfer_full as tf
from .ops.scrub import (
    DEVICE_FAULT_TYPES, DeviceStateUnrecoverable, SimulatedDeviceFault,
)
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
# ROADMAP queue-A slice that brings each (the deferred-path fault funnels
# too); the names in _UNPORTED_PROPERTIES are properties there and raise as
# properties here, on read and on write.
_UNPORTED = {
    "commit_fast_deferred": "A8 (commit pipeline)",
    "commit_group_fast": "A8 (commit pipeline)",
    "warmup": "A8 (commit pipeline)",
    "pipeline_depth": "A8 (commit pipeline)",
    "group_device_commit": "A8 (commit pipeline)",
    "fuse_batches": "A8 (commit pipeline)",
    "GROUP_K": "A8 (commit pipeline)",
    "_device_fault_at_resolve": "A8 (commit pipeline)",
    "_recover_inflight": "A8 (commit pipeline)",
    "reshard_begin": "A11 (sharding)",
    "reshard_active": "A11 (sharding)",
    "reshard_step": "A11 (sharding)",
    "reshard_abort": "A11 (sharding)",
    "host_state": "A6 (persistence)",
    "restore_host_state": "A6 (persistence)",
    "checkpoint_ledger": "A6 (persistence)",
}
_UNPORTED_PROPERTIES = frozenset({
    "pipeline_depth", "group_device_commit", "fuse_batches", "GROUP_K",
    "reshard_active",
})


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
        if shards is None:
            # As the reference: TB_SHARDS asks for sharding when shards is
            # not given.
            env = os.environ.get("TB_SHARDS", "")
            shards = int(env) if env.isdigit() else 0
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
        self._ledger = sm.make_ledger(
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
        # Device fault domain (ops/scrub.py, ops/merkle.py): off until
        # scrub_arm() with scrub_interval > 0.  The mirror is the
        # authoritative host twin (testing.model.ReferenceStateMachine) that
        # every committed batch also applies to; the forest is the Merkle
        # commitment tree.  Scrub-off machines take none of these branches.
        self._scrub_interval: Optional[int] = None  # lazy (TB_SCRUB_INTERVAL)
        self._scrub_mirror = None
        self._scrub_suspect = False
        self._scrub_commits = 0  # create_* commits since the last check
        self._injected_device_faults = 0
        self._device_fault_streak = 0  # consecutive failed dispatches
        self.device_fault_limit = 3  # the streak the reference degrades at
        # Jittered exponential re-dispatch backoff (vsr/timeout.py): one tick
        # sleeps retry_tick_s; the prng feeds only the sleep, never state.
        self.retry_tick_s = 0.01
        self._retry_prng = _random.Random(0x5C12)
        self._retry_timeout = None
        self._merkle_enabled: Optional[bool] = None  # lazy (TB_MERKLE)
        self._scrub_paranoid: Optional[bool] = None  # lazy (TB_SCRUB_PARANOID)
        self._merkle_forest: Optional[merkle_ops.Forest] = None
        self._merkle_dirty = False
        # Deferred commitment lane (TB_MERKLE_ASYNC): touched-row records of
        # committed batches whose path refresh has not run yet, drained by
        # merkle_settle() wherever a maintained root is observed.
        self._merkle_async: Optional[bool] = None  # lazy (TB_MERKLE_ASYNC)
        self._merkle_pending: List[Tuple[str, np.ndarray]] = []
        # Plain-int event counters.
        self.scrub_checks = 0
        self.scrub_mismatches = 0
        self.merkle_updates = 0
        self.merkle_rebuilds = 0
        self.merkle_mismatches = 0
        self.merkle_settles = 0
        self.device_recoveries = 0

    @property
    def ledger(self) -> sm.Ledger:
        """The device-resident ledger."""
        return self._ledger

    @ledger.setter
    def ledger(self, value: sm.Ledger) -> None:
        self._ledger = value

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
        one int32 array).  An injected device fault raises here, as a failed
        dispatch would."""
        self._injected_fault_check()
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
        return self._guarded_commit(
            "create_accounts", batch, timestamp,
            self._commit_create_accounts_impl,
        )

    def _commit_create_accounts_impl(
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
        return self._guarded_commit(
            "create_transfers", batch, timestamp,
            self._commit_create_transfers_impl,
        )

    def _commit_create_transfers_impl(
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
            led.accounts = self._table_grow(led.accounts,
                                            led.accounts.capacity * 2)
        if kflags & tf.FLAG_GROW_TRANSFERS:
            hot_max = self.hot_transfers_capacity_max
            if hot_max is not None and led.transfers.capacity >= hot_max:
                # Never allocate past the budget the ceiling encodes: make
                # room by spilling (the caller resets the certificate).
                self.evict_cold()
            else:
                led.transfers = self._table_grow(led.transfers,
                                                 led.transfers.capacity * 2)
        if kflags & tf.FLAG_GROW_POSTED:
            led.posted = self._table_grow(led.posted, led.posted.capacity * 2)

    # -- the sequential path ----------------------------------------------------

    def _sequential(
        self, operation: str, batch: np.ndarray, timestamp: int
    ) -> List[Tuple[int, int]]:
        """Exact in-order execution through ops/scan_path (kernels K6 and
        K7 on the card), as the JAX machine's ``_sequential_impl``: the scan
        path sees only the hot table, so a tiered machine first rehydrates
        the cold rows the batch names.  The scan path may tombstone slots
        (linked-chain rollback), which the touched-key update cannot see, so
        the commitment forest rebuilds at the next update or check."""
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
        self._merkle_mark_dirty()
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

    def _table_grow(self, table: ht.Table, capacity: int) -> ht.Table:
        """ht.grow (one K2 rehash).  Growth moves every slot, so the
        commitment forest rebuilds from the grown layout at the next update
        or check."""
        self._merkle_mark_dirty()
        return ht.grow(table, capacity)

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
            led.accounts = self._table_grow(led.accounts, cap)
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
                    led.transfers = self._table_grow(led.transfers, cap)
        cap = self._target_capacity(
            led.posted.capacity, self._posted_bound + posted
        )
        if cap != led.posted.capacity:
            led.posted = self._table_grow(led.posted, cap)
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
        self._merkle_mark_dirty()  # rows appeared outside a commit batch

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
        self._merkle_mark_dirty()  # rows left the hot table wholesale
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

    # -- the device fault domain (ops/scrub.py) --------------------------------

    @property
    def scrub_interval(self) -> int:
        """Scrub cadence in commit batches (TB_SCRUB_INTERVAL env, or the
        setter).  0 = the device fault domain is off: no mirror, no checks,
        no retry."""
        if self._scrub_interval is None:
            env = os.environ.get("TB_SCRUB_INTERVAL", "")
            self._scrub_interval = int(env) if env.isdigit() else 0
        return self._scrub_interval

    @scrub_interval.setter
    def scrub_interval(self, value: int) -> None:
        self._scrub_interval = max(0, int(value))

    @property
    def merkle_enabled(self) -> bool:
        """Merkle commitment mode (TB_MERKLE=1 env, or the setter): scrub
        checks compare maintained against recomputed roots, and replies,
        proofs and checkpoints carry the roots."""
        if self._merkle_enabled is None:
            self._merkle_enabled = os.environ.get("TB_MERKLE", "") == "1"
        return self._merkle_enabled

    @merkle_enabled.setter
    def merkle_enabled(self, value: bool) -> None:
        self._merkle_enabled = bool(value)

    @property
    def scrub_paranoid(self) -> bool:
        """Merkle mode's mirror retention: keep the host mirror beside the
        forest (in-process recovery).  Default: exactly at scrub interval 1;
        TB_SCRUB_PARANOID=0/1 or the setter override."""
        if self._scrub_paranoid is None:
            env = os.environ.get("TB_SCRUB_PARANOID", "")
            if env in ("0", "1"):
                return env == "1"
            return self.scrub_interval == 1
        return self._scrub_paranoid

    @scrub_paranoid.setter
    def scrub_paranoid(self, value: Optional[bool]) -> None:
        self._scrub_paranoid = value if value is None else bool(value)

    @property
    def merkle_armed(self) -> bool:
        return self._merkle_forest is not None

    @property
    def scrub_armed(self) -> bool:
        return self._scrub_mirror is not None or self._merkle_forest is not None

    @property
    def scrub_due(self) -> bool:
        # +1: a check runs BEFORE the commit that would complete the window,
        # so interval 1 verifies the at-rest state ahead of every commit.
        armed = self._merkle_forest is not None or (
            self._scrub_mirror is not None and not self._scrub_suspect
        )
        return armed and self._scrub_commits + 1 >= self.scrub_interval

    @property
    def merkle_async(self) -> bool:
        """Deferred commitment lane (TB_MERKLE_ASYNC=1 env, or the setter):
        committed batches queue their touched-row records and
        ``merkle_settle`` refreshes the paths wherever a maintained root is
        observed.  The port has no dispatch thread: the queue is drained on
        the caller's thread."""
        if self._merkle_async is None:
            self._merkle_async = os.environ.get("TB_MERKLE_ASYNC", "") == "1"
        return self._merkle_async

    @merkle_async.setter
    def merkle_async(self, value: bool) -> None:
        value = bool(value)
        if not value and self._merkle_async and self._merkle_pending:
            self.merkle_settle()  # turning the lane off strands nothing
        self._merkle_async = value

    def scrub_arm(self) -> bool:
        """Enable the device fault domain from the CURRENT ledger state (a
        verified point: genesis, a checked restore, the end of a recovery).
        Returns False, arming nothing, when scrub_interval is 0.  Mirror
        mode seeds the host mirror; Merkle mode builds the forest (K22) and
        keeps the mirror only when ``scrub_paranoid``."""
        if self.scrub_interval <= 0:
            self._scrub_mirror = None
            self._merkle_forest = None
            return False
        if self.merkle_enabled:
            self._merkle_rebuild()
            keep_mirror = self.scrub_paranoid
        else:
            self._merkle_forest = None
            keep_mirror = True
        self._scrub_mirror = scrub_ops.model_from_ledger(
            self.ledger,
            cold_rows=[np.asarray(r) for r in self.cold.runs],
            prepare_timestamp=self.prepare_timestamp,
            commit_timestamp=self.commit_timestamp,
        ) if keep_mirror else None
        self._scrub_suspect = False
        self._scrub_commits = 0
        return True

    def scrub_disarm(self) -> None:
        self._scrub_mirror = None
        self._merkle_forest = None
        self._merkle_dirty = False
        self._scrub_suspect = False

    def inject_device_faults(self, n: int = 1) -> None:
        """Arm ``n`` simulated dispatch failures (tests, fault schedules):
        the next n device read-backs raise SimulatedDeviceFault through the
        same funnel a real CUDA error would."""
        self._injected_device_faults += int(n)

    def _injected_fault_check(self) -> None:
        if self._injected_device_faults > 0:
            self._injected_device_faults -= 1
            raise SimulatedDeviceFault("injected device dispatch fault")

    def _d2h_u64(self, t: torch.Tensor) -> np.ndarray:
        """The fault domain's read-back funnel (digests, roots): one copy,
        as u64; an injected device fault raises here."""
        self._injected_fault_check()
        return convert.tensor_to_array(t)

    _SDC_COLS = (
        "debits_pending_lo", "debits_posted_lo",
        "credits_pending_lo", "credits_posted_lo",
        "debits_pending_hi", "debits_posted_hi",
        "credits_pending_hi", "credits_posted_hi",
    )

    def inject_sdc_bitflip(self, rng) -> bool:
        """Flip one seeded bit of a live account's balance column on the
        device (tests and simulation only), as the reference picks it.
        Returns False when no live account exists yet."""
        a = self.ledger.accounts
        live = np.flatnonzero(
            (convert.tensor_to_array(a.key_lo) != 0)
            | (convert.tensor_to_array(a.key_hi) != 0)
        )
        if live.size == 0:
            return False
        slot = int(live[rng.randrange(live.size)])
        col = self._SDC_COLS[rng.randrange(len(self._SDC_COLS))]
        bit = rng.randrange(64)
        arr = a.cols[col]
        arr[slot] = arr[slot] ^ i64(1 << bit)
        return True

    def _mirror_apply(self, operation: str, batch: np.ndarray,
                      timestamp: int) -> None:
        """Advance the mirror by one committed batch, in commit order.  A
        failure to apply marks it SUSPECT: checks stand down and a later
        recovery escalates to checkpoint + WAL replay."""
        model = self._scrub_mirror
        if model is None or self._scrub_suspect:
            return
        from .testing import model as M

        try:
            if operation == "create_accounts":
                events = M.accounts_from_batch(batch)
            else:
                events = M.transfers_from_batch(batch)
            model.execute(operation, int(timestamp), events)
        except Exception:  # noqa: BLE001 - a broken mirror must stand down
            self._scrub_suspect = True
            if _obs.enabled:
                _obs.counter("scrub.mirror_suspect").inc()

    def _guarded_commit(self, operation, batch, timestamp, impl):
        """The blocking commits' funnel: the scrub check BEFORE the commit
        reads device state, dispatch retry with jittered exponential backoff
        on device faults, and the mirror and forest advanced after success.
        One armed check and nothing else when the fault domain is off."""
        if not self.scrub_armed or len(batch) == 0:
            return impl(batch, timestamp)
        while True:
            try:
                self._scrub_maybe_check()
                results = impl(batch, timestamp)
                self._device_fault_streak = 0
                break
            except DEVICE_FAULT_TYPES as err:
                self._on_blocking_device_fault(err)
        self._scrub_commits += 1
        self._mirror_apply(operation, batch, timestamp)
        self._merkle_apply(operation, batch)
        return results

    def _on_blocking_device_fault(self, err) -> None:
        """One failed blocking dispatch: quarantine, rebuild the ledger from
        the mirror and back off (the caller retries).  At
        ``device_fault_limit`` consecutive failures the reference degrades
        to the host engine, which the port does not have yet."""
        if _obs.enabled:
            _obs.counter("device_recovery.dispatch_faults").inc()
        self._device_fault_streak += 1
        if self._device_fault_streak >= self.device_fault_limit:
            self._degrade_to_host_engine(err)
        self.quarantine()
        self._rematerialize_from_mirror()
        self._retry_backoff()
        self.device_recoveries += 1
        if _obs.enabled:
            _obs.counter("device_recovery.recoveries").inc()
            _obs.counter("device_recovery.redispatches").inc()

    def _scrub_maybe_check(self) -> None:
        if self.scrub_due:
            self.scrub_check()

    def _scrub_digests_match(self, got, want) -> bool:
        return int(got[0]) == want[0] and int(got[2]) == want[2] and (
            self.cold.count != 0 or int(got[1]) == want[1])

    def scrub_check(self, boundary: bool = False) -> bool:
        """Integrity check of the at-rest device state.  Mirror: the folds
        (K21, one read-back) against the mirror's expected digests.  Merkle:
        the maintained roots against roots recomputed from the pads (K22,
        one (2, 3) read-back).  On a mismatch: quarantine, rebuild the
        ledger from the mirror and verify the rebuild; without a mirror the
        mismatch raises DeviceStateUnrecoverable (checkpoint + WAL replay is
        the replica's answer).  True when the state was already clean."""
        model = self._scrub_mirror
        mirror_armed = model is not None and not self._scrub_suspect
        if self._merkle_forest is None and not mirror_armed:
            return True
        self._scrub_commits = 0
        self.scrub_checks += 1
        if _obs.enabled:
            _obs.counter("scrub.checks").inc()
        ok = True
        if self._merkle_forest is not None:
            try:
                ok = self._merkle_verify()
            except DEVICE_FAULT_TYPES as err:
                if _obs.enabled:
                    _obs.counter("device_recovery.dispatch_faults").inc()
                if not mirror_armed:
                    self._merkle_dirty = True
                    raise DeviceStateUnrecoverable(
                        "device fault during merkle verification "
                        "(no mirror armed)"
                    ) from err
                ok = False
        want = scrub_ops.mirror_digests(model) if mirror_armed else None
        if mirror_armed:
            try:
                ok = ok and self._scrub_digests_match(
                    self._scrub_fold_digests(), want)
            except DEVICE_FAULT_TYPES:
                if _obs.enabled:
                    _obs.counter("device_recovery.dispatch_faults").inc()
                ok = False
        if ok:
            return True
        self.scrub_mismatches += 1
        if _obs.enabled:
            _obs.counter("scrub.mismatches").inc()
            if boundary:
                _obs.counter("scrub.boundary_mismatches").inc()
        if not mirror_armed:
            self._merkle_dirty = True
            raise DeviceStateUnrecoverable(
                "merkle root mismatch: device state corrupt and no "
                "authoritative mirror armed (TB_SCRUB_INTERVAL=1 keeps one)"
            )
        self.quarantine()
        self._rematerialize_from_mirror()
        if self._merkle_forest is not None:
            # A fresh layout: rebuild the forest from it.
            self._merkle_rebuild()
        try:
            got = self._scrub_fold_digests()
        except DEVICE_FAULT_TYPES as err:
            self._scrub_suspect = True
            raise DeviceStateUnrecoverable(
                "device fault during post-recovery scrub verification"
            ) from err
        if not self._scrub_digests_match(got, want):
            self._scrub_suspect = True
            raise DeviceStateUnrecoverable(
                "scrub mismatch survived re-materialization: mirror suspect"
            )
        self.device_recoveries += 1
        if _obs.enabled:
            _obs.counter("device_recovery.recoveries").inc()
            _obs.counter("device_recovery.scrub").inc()
        return False

    def _scrub_fold_digests(self) -> np.ndarray:
        """The (accounts, transfers, posted) folds, K21 on the card, through
        the read-back funnel (one copy)."""
        return self._d2h_u64(scrub_ops.scrub_digest(self.ledger))

    # -- Merkle commitments (ops/merkle.py) -------------------------------------

    def _merkle_rebuild(self) -> None:
        """Full forest rebuild from the current ledger (K22), paid at arm
        points and after non-incremental mutations (growth, the sequential
        path, tier moves, recovery).  It subsumes every queued touch."""
        self._merkle_forest = merkle_ops.build_forest(self.ledger)
        self._merkle_dirty = False
        self._merkle_pending.clear()
        self.merkle_rebuilds += 1
        if _obs.enabled:
            _obs.counter("merkle.rebuilds").inc()

    def _merkle_rebuild_if_dirty(self) -> bool:
        if self._merkle_forest is None or not self._merkle_dirty:
            return False
        self._merkle_rebuild()
        return True

    def _merkle_mark_dirty(self) -> None:
        if self._merkle_forest is not None:
            self._merkle_dirty = True

    def _merkle_verify(self) -> bool:
        """Maintained roots against roots recomputed from the pads: ONE
        (2, 3) read-back."""
        self.merkle_settle()  # the check observes settled roots only
        self._merkle_rebuild_if_dirty()
        lanes = self._d2h_u64(
            merkle_ops.verify_roots(self._merkle_forest, self.ledger))
        ok = bool((lanes[0] == lanes[1]).all())
        if _obs.enabled:
            _obs.counter("merkle.checks").inc()
        if not ok:
            self.merkle_mismatches += 1
            if _obs.enabled:
                _obs.counter("merkle.mismatches").inc()
        return ok

    _MERKLE_MIN_LANES = 256

    def _merkle_pad(self, lo: np.ndarray, hi: np.ndarray, min_lanes: int):
        """Key arrays padded to power-of-two lane classes, on the device
        (zero keys are instant probe misses and touch nothing)."""
        n = len(lo)
        lanes = max(min_lanes, 1 << (n - 1).bit_length()) if n else min_lanes
        return self._id_tensors(lo, hi, lanes)

    def _merkle_apply(self, operation: str, batch: np.ndarray) -> None:
        """Advance the forest by one committed batch (the blocking paths'
        post-success hook)."""
        if self._merkle_forest is None or len(batch) == 0:
            return
        if self.merkle_async:
            self._merkle_lane_enqueue(operation, batch)
            return
        if self._merkle_rebuild_if_dirty():
            return  # the rebuild already reflects this batch
        if operation == "create_accounts":
            self._merkle_apply_accounts(batch)
        else:
            self._merkle_update_transfers_batches([batch])

    def _merkle_apply_accounts(self, batch: np.ndarray) -> None:
        lo, hi = self._merkle_pad(
            batch["id_lo"].astype(np.uint64),
            batch["id_hi"].astype(np.uint64),
            self._MERKLE_MIN_LANES,
        )
        self._merkle_forest = merkle_ops.update_accounts(
            self._merkle_forest, self.ledger, lo, hi, max_probe=sm.MAX_PROBE,
        )
        self.merkle_updates += 1
        if _obs.enabled:
            _obs.counter("merkle.updates").inc()

    def _merkle_lane_enqueue(self, operation: str, batch: np.ndarray) -> None:
        """Queue one committed batch's touched-row record (TB_MERKLE_ASYNC);
        batches are immutable after commit, so holding them is safe."""
        self._merkle_pending.append((operation, batch))
        if _obs.enabled:
            _obs.counter("merkle.lane.deferred_updates").inc()

    def merkle_settle(self) -> None:
        """Settle the deferred commitment lane: replay every queued record
        into the forest (leaves recompute from the current tables, so the
        coalesced update equals the batch-at-a-time sequence).  Runs at
        every point a maintained root is observed."""
        if not self._merkle_pending:
            return
        pending, self._merkle_pending = self._merkle_pending, []
        if self._merkle_forest is None:
            return  # disarmed while records were queued
        if _obs.enabled:
            _obs.counter("merkle.lane.settle_waits").inc()
            _obs.histogram("merkle.lane.lag_batches", "batches").observe(
                len(pending))
        self.merkle_settles += 1
        if self._merkle_rebuild_if_dirty():
            return  # the rebuild subsumes every queued touch
        for op, batches in merkle_ops.coalesce_touch_records(
            pending, max_rows=self.batch_lanes
        ):
            if op == "create_accounts":
                self._merkle_apply_accounts(batches[0])
            else:
                self._merkle_update_transfers_batches(batches)

    def _merkle_update_transfers_batches(self, batches) -> None:
        """ONE touched-path update (K1, K23) covering a run of committed
        create_transfers batches: inserted ids, deduped account sides,
        pending references (resolved on the device).  Over-approximation
        is safe: an untouched leaf recomputes to its own value."""
        if self._merkle_forest is None:
            return
        if self._merkle_rebuild_if_dirty():
            return
        ids_lo = np.concatenate([b["id_lo"] for b in batches])
        ids_hi = np.concatenate([b["id_hi"] for b in batches])
        dr_lo = np.concatenate([b["debit_account_id_lo"] for b in batches])
        dr_hi = np.concatenate([b["debit_account_id_hi"] for b in batches])
        cr_lo = np.concatenate([b["credit_account_id_lo"] for b in batches])
        cr_hi = np.concatenate([b["credit_account_id_hi"] for b in batches])
        flags = np.concatenate([b["flags"] for b in batches])
        pv = (
            flags & (types.TransferFlags.POST_PENDING_TRANSFER
                     | types.TransferFlags.VOID_PENDING_TRANSFER)
        ) != 0
        # Dedupe the account side, sorted by (hi, lo): deterministic.
        acc = _unique_pairs(
            np.concatenate([dr_hi, cr_hi]).astype(np.uint64),
            np.concatenate([dr_lo, cr_lo]).astype(np.uint64),
        )
        id_lo, id_hi = self._merkle_pad(
            ids_lo.astype(np.uint64), ids_hi.astype(np.uint64),
            self._MERKLE_MIN_LANES,
        )
        acc_lo, acc_hi = self._merkle_pad(
            acc[:, 1], acc[:, 0], self._MERKLE_MIN_LANES
        )
        has_pv = bool(pv.any())
        pend = (
            np.concatenate([b["pending_id_lo"] for b in batches])[pv],
            np.concatenate([b["pending_id_hi"] for b in batches])[pv],
        ) if has_pv else (np.zeros(0, np.uint64), np.zeros(0, np.uint64))
        pend_lo, pend_hi = self._merkle_pad(
            pend[0].astype(np.uint64), pend[1].astype(np.uint64),
            self._MERKLE_MIN_LANES,
        )
        self._merkle_forest = merkle_ops.update_transfers(
            self._merkle_forest, self.ledger, id_lo, id_hi,
            acc_lo, acc_hi, pend_lo, pend_hi,
            max_probe=sm.MAX_PROBE, has_postvoid=has_pv,
        )
        self.merkle_updates += 1
        if _obs.enabled:
            _obs.counter("merkle.updates").inc()

    def merkle_roots(self) -> Optional[Tuple[int, int, int]]:
        """The maintained commitment roots (accounts, transfers, posted), or
        None when Merkle mode is not armed."""
        if self._merkle_forest is None:
            return None
        self.merkle_settle()
        self._merkle_rebuild_if_dirty()
        triple = self._d2h_u64(merkle_ops.forest_roots(self._merkle_forest))
        return (int(triple[0]), int(triple[1]), int(triple[2]))

    def merkle_canonical_roots(self) -> Optional[Tuple[int, int, int]]:
        """Roots over the canonical single-device layout, recomputed on the
        host from the ledger (what checkpoints serialize and proofs anchor
        to; equal to merkle_roots() on a clean forest)."""
        if self._merkle_forest is None:
            return None
        if self._merkle_pending:
            self.merkle_settle()
        return merkle_ops.np_ledger_roots(self.ledger)

    def commitment_root(self) -> int:
        """The accounts-pad commitment root of the committed state (the
        audit anchor a replica stamps into every reply header), or 0 when
        commitments are not armed or the deferred lane holds records
        (clients skip a 0)."""
        if self._merkle_forest is None:
            return 0
        if self._merkle_pending:
            return 0
        self._merkle_rebuild_if_dirty()
        return u64(self._merkle_forest.accounts[1].item())

    def get_proof(self, ident: int, kind: str = "accounts") -> Optional[bytes]:
        """Root-anchored Merkle inclusion proof of one row, verifiable with
        ``ops.merkle.check_proof``: ``accounts`` (the account row),
        ``transfers`` (a hot transfer row; an evicted one has no leaf) or
        ``posted`` (the fulfillment of pending transfer ``ident``, keyed by
        its timestamp).  None when the row does not exist in the pad or
        Merkle mode is off."""
        if self._merkle_forest is None:
            return None
        if kind not in merkle_ops.PROOF_KINDS:
            raise ValueError(f"unknown proof kind {kind!r}")
        self.merkle_settle()  # proofs anchor to settled roots only
        lo = np.uint64(ident & U64_MAX)
        hi = np.uint64(ident >> 64)
        row_bytes = None
        if kind == "accounts":
            rows = self.lookup_accounts([ident])
            if len(rows) == 0:
                return None
            row_bytes = rows[0].tobytes()
        elif kind == "transfers":
            rows = self.lookup_transfers([ident])
            if len(rows) == 0:
                return None
            row_bytes = rows[0].tobytes()
        else:  # posted: resolve the pending id to its pad key (timestamp)
            rows = self.lookup_transfers([ident])
            if len(rows) == 0:
                return None
            lo = np.uint64(int(rows[0]["timestamp"]))
            hi = np.uint64(0)
        self._merkle_rebuild_if_dirty()
        table = getattr(self.ledger, kind)
        k_lo, k_hi = self._id_tensors(np.array([lo], np.uint64),
                                      np.array([hi], np.uint64), 8)
        look = ht.lookup(table, k_lo, k_hi, sm.MAX_PROBE)
        if not bool(look.found[0]):
            return None
        slot = int(look.slot[0])
        levels = max(0, table.capacity.bit_length() - 1)
        leaf_dev, sib_dev, root_dev = merkle_ops.gather_path(
            self._merkle_forest.pad(kind), slot, levels)
        path = convert.tensor_to_array(torch.cat(
            [sib_dev, root_dev.reshape(1)]))
        siblings, root = path[:levels], int(path[levels])
        if kind == "posted":
            prow = np.zeros((), merkle_ops.PROOF_POSTED_DTYPE)
            prow["pending_timestamp"] = lo
            prow["fulfillment"] = u64(table.cols["fulfillment"][slot].item())
            row_bytes = prow.tobytes()
        if _obs.enabled:
            _obs.counter("merkle.proofs").inc()
        return merkle_ops.encode_proof(
            row_bytes, slot, siblings, root, kind=kind
        )

    # -- recovery ----------------------------------------------------------------

    def quarantine(self) -> None:
        """Quarantine the device pipeline: after a failed or corrupted
        dispatch every cached device buffer is suspect.  The port has no
        dispatch lane or staging pool yet (ROADMAP A8); it drops its cached
        buffers (the lane index vector and the Bloom filter's device copy)
        and makes them anew."""
        self._lane_ids = torch.arange(self.batch_lanes, device=self.device)
        if self._bloom_np is not None:
            self._bloom_dev = convert.bloom_to_tensor(self._bloom_np,
                                                      self.device)

    def _rematerialize_from_mirror(self) -> None:
        """Rebuild the ledger (fresh buffers) from the mirror and resync the
        host-side derived state; the layout is the reference's."""
        model = self._scrub_mirror
        if model is None or self._scrub_suspect:
            raise DeviceStateUnrecoverable("mirror unavailable or suspect")
        if self._tiering or self.cold.count:
            # The mirror holds every transfer but cannot reproduce the
            # hot/cold split the Bloom filter and the spill encode.
            raise DeviceStateUnrecoverable(
                "cold tier active: mirror re-materialization unsupported"
            )
        self.ledger = scrub_ops.materialize_ledger(model, self.config,
                                                   self.device)
        self._merkle_mark_dirty()  # fresh layout: the forest rebuilds
        self._resync_host_state_from_mirror(model)

    def _resync_host_state_from_mirror(self, model) -> None:
        self._accounts_bound = len(model.accounts)
        self._transfers_bound = len(model.transfers)
        self._posted_bound = len(model.posted)
        self._history_bound = len(model.history)
        self._history_accounts_possible = any(
            a.flags & types.AccountFlags.HISTORY
            for a in model.accounts.values()
        )
        self._limit_accounts_possible = any(
            a.flags & _LIMIT_FLAGS for a in model.accounts.values()
        )
        bound = 0
        for a in model.accounts.values():
            bound = max(a.debits_pending, a.debits_posted,
                        a.credits_pending, a.credits_posted, bound)
        self._balance_bound = min(bound, _BOUND_CLAMP)
        self.commit_timestamp = max(
            self.commit_timestamp, model.commit_timestamp
        )
        self.index.reset()
        self.scans_transfers.reset()
        self.scans_accounts.reset()

    def reset_device_state(self) -> None:
        """Genesis reset (the replica's checkpoint-free recovery): a fresh
        empty ledger, derived state cleared.  The prepare clock is kept:
        issued prepare timestamps must stay monotone."""
        cfg = self.config
        self.ledger = sm.make_ledger(
            cfg.accounts_capacity, cfg.transfers_capacity,
            cfg.posted_capacity, cfg.history_capacity, device=self.device,
        )
        self._merkle_mark_dirty()
        self.commit_timestamp = 0
        self._accounts_bound = self._transfers_bound = 0
        self._posted_bound = self._history_bound = 0
        self._history_accounts_possible = False
        self._limit_accounts_possible = False
        self._balance_bound = 0
        self.index.reset()
        self.scans_transfers.reset()
        self.scans_accounts.reset()

    def _retry_backoff(self) -> None:
        """Jittered exponential backoff between re-dispatch attempts
        (vsr/timeout.py); retry_tick_s 0 skips the sleep."""
        if self._retry_timeout is None:
            from .vsr.timeout import Timeout

            self._retry_timeout = Timeout(
                self._retry_prng, base_ticks=1, max_ticks=64
            )
        ticks = self._retry_timeout.next_backoff()
        if _obs.enabled:
            _obs.counter("device_recovery.retries").inc()
        if self.retry_tick_s > 0:
            _time.sleep(ticks * self.retry_tick_s)

    def _degrade_to_host_engine(self, err) -> None:
        """The reference serves from the native host engine after
        ``device_fault_limit`` consecutive failures; the port has no host
        engine yet."""
        raise NotImplementedError(
            "TorchStateMachine cannot degrade to the host engine after "
            f"{self.device_fault_limit} consecutive device faults: the host "
            "engine is not ported yet (ROADMAP A6)"
        ) from err


def _unique_pairs(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """``np.unique(np.stack([hi, lo], axis=1), axis=0)``: the distinct (hi,
    lo) rows in the same sorted order, by a lexsort (the axis form sorts a
    structured view, about 18 ms for 16,380 rows)."""
    order = np.lexsort((lo, hi))
    hi, lo = hi[order], lo[order]
    first = np.ones(len(hi), dtype=bool)
    first[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    return np.stack([hi[first], lo[first]], axis=1)


def _unported(name: str, where: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"TorchStateMachine.{name} is not ported yet (ROADMAP {where})"
        )

    method.__name__ = name
    if name in _UNPORTED_PROPERTIES:
        return property(method, method)
    return method


for _name, _where in _UNPORTED.items():
    setattr(TorchStateMachine, _name, _unported(_name, _where))
