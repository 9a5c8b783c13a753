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

The commit pipeline (``commit_fast_deferred``, ``commit_group_fast``,
``DeviceCommitHandle``; ``TB_PIPELINE``, ``TB_GROUP_COMMIT``): deferred
dispatches run in order on one dispatch-lane thread, on a CUDA stream of its
own, and a handle's ``resolve`` makes the one device-to-host read of its
codes.  A grouped run of up to ``GROUP_K`` fast-path batches is staged into
one pinned buffer and committed on the card by one replay of a captured
CUDA graph (``ops/group.py``: K24, K1-K4 reading the batch's count and
timestamp from device words, K25); on CPU tensors the plain loop runs
instead.  Every blocking path first joins the lane (``ledger``'s getter),
so it never races an in-flight run.  A device fault at a resolve
quarantines the lane and re-commits every pending run from the host
mirror; ``device_fault_limit`` consecutive faults, or one CUDA error that
left the context unusable, degrade the machine to the host engine
(``host_engine.py``, the native C++ engine over a numpy ledger), which
then commits every batch, as ``host_engine=True`` does from the start.  A
failure of the port's own kernels (``CudaKernelError``) is re-dispatched on
the device but never degrades: at the limit it raises.  ``checkpoint_ledger``,
``host_state`` and ``restore_host_state`` are the persistence surface
(``vsr/checkpoint.py``, ``lsm/forest.py``).

Sharded mode (``shards`` >= 2 or ``TB_SHARDS``; ``parallel/sharded.py``):
the tables are partitioned over a mesh of shards (``device.devices()``;
``device.force_virtual(n, d)`` puts n shards on one device), every commit
gathers through kernels K30 and K31, validates once per device and applies
owner-locally; batches the sharded kernels route (history accounts, linked
duplicates, the cold tier) run in the sequential window (unshard, the
sequential path, reshard).  Queries, lookups and checkpoints read the
canonical single-device view, and an online N -> 2N split
(``reshard_begin``/``reshard_step``) ships the moved rows through the
verified state-sync codec while the old layout keeps serving.
"""

from __future__ import annotations

import concurrent.futures
import os
import random as _random
import threading
import time as _time
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import convert, types
from . import device as device_mod
from . import sanitize as _san
from .config import LedgerConfig
from .device import resolve as resolve_device
from .obs.metrics import registry as _obs
from .ops import _cuda
from .ops import cold as cold_mod
from .ops import group as group_mod
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
    mix64_np,
)
from .parallel import sharded as shard_mod
from .parallel.mesh import Mesh
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
# The CUDA runtime's error class (a member of DEVICE_FAULT_TYPES), where the
# installed torch has it.
_ACCELERATOR_ERROR = getattr(torch, "AcceleratorError", None)
# Largest reply of a query: (message_size_max - header) / row size.
QUERY_ROWS_MAX = ((1 << 20) - 256) // 128

def _overflow_any(overflow) -> bool:
    """True if any probe-overflow flag fired (a scalar, an array of flags,
    or a tuple of either)."""
    if isinstance(overflow, (list, tuple)):
        return any(_overflow_any(o) for o in overflow)
    return bool(np.any(np.asarray(overflow)))


def pipeline_depth_default() -> int:
    """Commit-pipeline depth (TB_PIPELINE env; default 2).  Depth 1 (and
    TB_PIPELINE=0, "off") disables deferral entirely: the serving path is
    then the blocking path.  Depth >= 2 runs one commit group in flight;
    deeper values are reserved (currently equivalent to 2)."""
    env = os.environ.get("TB_PIPELINE", "")
    if env.isdigit():
        return max(1, int(env))  # 0 == off == depth 1
    return 2


class DeviceCommitHandle:
    """An in-flight fast-path device commit (one batch or a grouped run).

    ``result`` is the dispatch's (codes, overflow[, event]) device tuple
    (the dispatch already ran on the calling thread) or a Future of one:
    deferred dispatches run on the machine's one dispatch-lane thread, on
    the lane's CUDA stream, and ``event`` marks the end of their device
    work on it.

    ``resolve()`` joins the dispatch, makes the ONE deferred device-to-host
    read (codes and the probe-overflow word together) and runs the host
    bookkeeping that needs the codes (result compression, the commit
    timestamp), returning per-batch (index, result) lists.  ``join_wait_s``
    records how long the join blocked.  Handles resolve in dispatch order.
    """

    __slots__ = ("_machine", "_result", "_stacked", "_counts",
                 "_timestamps", "_stage", "_resolved", "join_wait_s",
                 "_batches", "_recovered", "_deferred")

    def __init__(self, machine, result, counts, timestamps,
                 stacked: bool, stage=None, batches=None,
                 deferred: bool = False) -> None:
        self._machine = machine
        self._result = result
        self._stacked = stacked      # True: leading per-batch dim
        self._counts = counts
        self._timestamps = timestamps
        self._stage = stage          # staging set to release on resolve
        self._resolved = False
        self._deferred = deferred    # counted in the machine's in-flight depth
        self.join_wait_s = 0.0
        # Host copies of the dispatched batches: the device fault domain
        # re-commits a quarantined run from these (machine._recover_inflight);
        # None when the fault domain is off.
        self._batches = batches
        # Per-batch results of a recovery re-commit; resolve() returns them
        # instead of touching the dead dispatch.
        self._recovered = None

    def __len__(self) -> int:
        return len(self._counts)

    def discard(self) -> None:
        """Abort path: quiesce the dispatch (join it, swallow its error) and
        release the staging set; an orphaned closure left running on the
        lane would keep mutating machine.ledger behind the caller."""
        if self._resolved:
            return
        self._resolved = True
        self._machine._deferred_done(self)
        self._machine._inflight_untrack(self)
        if hasattr(self._result, "result"):
            try:
                self._result.result()
            except Exception:  # noqa: BLE001 - abort quiesce
                pass
        if self._stage is not None:
            self._machine._lane_drain()  # its copy may still be queued
            self._machine._stage_release(self._stage)
            self._stage = None

    def resolve(self) -> List[List[Tuple[int, int]]]:
        assert not self._resolved, "commit handle resolved twice"
        self._resolved = True
        m = self._machine
        m._deferred_done(self)
        if self._recovered is not None:
            # A device-fault recovery already re-committed this run through
            # the blocking path (machine._recover_inflight).
            return self._recovered
        try:
            if hasattr(self._result, "result"):
                t0 = _time.perf_counter()
                self._result = self._result.result()
                self.join_wait_s = _time.perf_counter() - t0
                if _obs.enabled:
                    _obs.histogram("pipeline.resolve_wait_us", "us").observe(
                        self.join_wait_s * 1e6)
            codes_dev, overflow_dev = self._result[:2]
            if len(self._result) > 2:
                # A lane dispatch on the card: order this stream after it.
                torch.cuda.current_stream(m.device).wait_event(
                    self._result[2])
            host, overflow = m._d2h_codes(codes_dev.reshape(-1), overflow_dev)
            codes = host.reshape(codes_dev.shape)
        except DEVICE_FAULT_TYPES as err:
            # Dispatch-lane funnel: the dispatch (or its read-back) failed;
            # quarantine the lane and re-commit every pending run from the
            # mirror.  Raises the original error when the fault domain is
            # off.
            m._device_fault_at_resolve(err)
            assert self._recovered is not None
            return self._recovered
        finally:
            m._inflight_untrack(self)
            if self._stage is not None:
                # The dispatch completed or failed for good: its host-to-
                # device copy is over, so the staging set goes back.
                m._stage_release(self._stage)
                self._stage = None
        if _overflow_any(overflow):
            # Load-factor management keeps this unreachable; losing inserts
            # silently is the one unacceptable outcome, so fail loud.
            raise RuntimeError("transfers probe overflow during fast insert")
        if _obs.enabled:
            _obs.counter("pipeline.resolves").inc()
        # Index maintenance already ran inside the dispatch closure.
        out = []
        for j, (count, ts) in enumerate(zip(self._counts, self._timestamps)):
            row = codes[j] if self._stacked else codes
            out.append(m._compress(row, count))
            m._update_commit_timestamp(row, count, ts)
        m._device_fault_streak = 0
        if m.scrub_armed:
            # The scrub cadence advances in resolve (== op) order; the
            # forest already advanced inside the dispatch closure.
            m._scrub_commits += len(self._counts)
        if m._scrub_mirror is not None and self._batches is not None:
            for b, ts in zip(self._batches, self._timestamps):
                m._mirror_apply("create_transfers", b, ts)
        return out


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
        cfg = ledger_config or LedgerConfig()
        self.config = cfg
        self.batch_lanes = batch_lanes
        self.force_sequential = force_sequential
        self.device = resolve_device(device)
        # Sharded mode (parallel/sharded.py): ``shards`` None defers to
        # TB_SHARDS; 0 is the single-device path, which takes no sharded
        # branch.
        if shards is None:
            env = os.environ.get("TB_SHARDS", "")
            shards = int(env) if env.isdigit() else 0
        self.shards = 0
        self._shard_mesh: Optional[Mesh] = None
        self._shard_steps = None
        self._merkle_steps_cache = None
        self._canon = None  # the cached canonical (single-layout) view
        self._canon_tree = None  # (canon ledger, {pad: host heap})
        self._ledger_is_sharded = False
        self.shard_lanes_total = 0  # plain-int counters
        self.shard_lanes_cross = 0
        self.shard_seq_fallbacks = 0
        # Per-shard attempted-insert bounds (accounts, transfers): hash skew
        # can overfill one shard's C/n region while the global count sits
        # under C/2, so growth sizes off the peak shard too.
        self._shard_insert_bounds: dict = {}
        # Online shard split: volatile migration state (None: no split in
        # flight), never checkpointed.
        self._reshard: Optional[dict] = None
        self.reshard_stats = {
            "splits_started": 0, "splits_completed": 0, "abandons": 0,
            "restarts": 0, "catchup_rounds": 0, "chunks": 0,
            "chunk_retries": 0, "bytes_migrated": 0, "bytes_full": 0,
        }
        if shards >= 2 and host_engine:
            # Sharding runs on the device path: a process-wide TB_SHARDS
            # must not take down a host-engine server.
            warnings.warn(
                f"TB_SHARDS={shards} ignored: "
                "the host engine is the commit authority here",
                RuntimeWarning, stacklevel=2,
            )
            shards = 0
        if shards >= 2:
            assert shards & (shards - 1) == 0, "TB_SHARDS must be a power of 2"
            devs = device_mod.devices(self.device)
            if len(devs) < shards:
                # Degrade to the single-device path on the same device
                # rather than wedge, as the reference does.
                warnings.warn(
                    f"TB_SHARDS={shards} but only {len(devs)} device(s) "
                    "visible; running single-device",
                    RuntimeWarning, stacklevel=2,
                )
            else:
                for cap in (cfg.accounts_capacity, cfg.transfers_capacity,
                            cfg.posted_capacity):
                    assert cap % shards == 0, "capacity not shard-divisible"
                self.shards = shards
                self._shard_mesh = Mesh(devs[:shards])
                self._shard_steps = shard_mod.machine_steps(
                    self._shard_mesh, cfg.jacobi_max_passes)
                self._shard_insert_bounds = {
                    "accounts": np.zeros(shards, np.int64),
                    "transfers": np.zeros(shards, np.int64),
                }
                if _obs.enabled:
                    _obs.gauge("sharding.shards").set(shards)
        # The commit pipeline: the dispatch lane (one worker thread, a CUDA
        # stream of its own), the future of its last submitted closure (the
        # blocking paths join it before touching the ledger), the pooled
        # staging sets by run length, the grouped commit's CUDA graph and
        # the in-flight bookkeeping of the fault funnels.
        self._lane = None
        self._lane_stream = None
        self._lane_tail = None
        self._lane_tls = threading.local()
        self._stage_pool: dict = {}
        self._group_graph = None
        self._group_device_commit: Optional[bool] = None  # lazy (TB_GROUP_COMMIT)
        self._pipeline_depth: Optional[int] = None  # lazy (TB_PIPELINE)
        self._fuse_batches: Optional[bool] = None  # lazy (TB_FUSE)
        self._inflight_handles: List[DeviceCommitHandle] = []
        self._deferred_inflight = 0
        # A list to time the lane's device work (off when None): each
        # deferred closure on the card appends its (start, end) CUDA events,
        # whose elapsed times sum to the device's busy time.
        self.lane_events: Optional[list] = None
        # TB_SANITIZE: poison released staging sets, and trip on CUDA-graph
        # captures after warmup that no growth explains.
        self._sanitize = _san.enabled()
        self._sanitize_capture_base: Optional[int] = None
        self._sanitize_grace = False
        # Host data-plane mode (host_engine.py): commits run in the native
        # engine over a numpy ledger, which is the authority; the device
        # ledger is made from it when a query, digest or checkpoint reads it.
        self._engine = None
        self._host_led = None
        self._device_stale = False
        self._index_stale = False
        self.degraded_to_host_engine = False
        if host_engine:
            from .host_engine import HostEngine, HostLedger

            assert not force_sequential, (
                "host engine is already sequential-exact")
            assert hot_transfers_capacity_max is None, (
                "tiering runs on the device path")
            self._host_led = HostLedger(
                cfg.accounts_capacity, cfg.transfers_capacity,
                cfg.posted_capacity, cfg.history_capacity,
            )
            self._engine = HostEngine(self._host_led, cfg.max_probe)
            self._device_stale = True
            self._ledger = None
        elif self._shard_mesh is not None:
            self._ledger = shard_mod.make_sharded_ledger(
                self._shard_mesh, cfg.accounts_capacity,
                cfg.transfers_capacity, cfg.posted_capacity,
                history_capacity=cfg.history_capacity,
            )
            self._ledger_is_sharded = True
        else:
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
        """The device-resident ledger.  Off the dispatch lane, reading it
        first joins the lane (its last closure, and on the card its stream),
        so no blocking path races an in-flight run.  In host-engine mode the
        numpy ledger is the authority: the device view is made from it on
        the first read after engine commits."""
        if self._lane_tail is not None and not self._on_lane():
            self._lane_join()
        if self._engine is not None and self._device_stale:
            self._ledger = self._host_led.to_device(self.device)
            self._device_stale = False
        return self._ledger

    @ledger.setter
    def ledger(self, value: sm.Ledger) -> None:
        if self._lane_tail is not None and not self._on_lane():
            self._lane_join()
        if (self._ledger_is_sharded and value is not None
                and not isinstance(value, shard_mod.ShardedLedger)):
            # An external install of a single-layout ledger (checkpoint
            # restore, state sync, recovery) while sharded: re-place it
            # into the owner-partitioned layout.  The sequential window
            # turns _ledger_is_sharded off, so its ledgers pass through.
            value = shard_mod.shard_ledger(value, self._shard_mesh)
            self._refresh_shard_bounds(value)
        self._ledger = value
        self._canon = None
        if self._engine is not None:
            # An external swap (checkpoint restore, state sync): the host
            # ledger must mirror the new authority exactly.
            from .host_engine import HostLedger

            self._host_led = HostLedger.from_device(value)
            self._engine.ledger = self._host_led
            self._device_stale = False

    def _query_ledger(self) -> sm.Ledger:
        """The single-layout ledger queries, lookups and checkpoints read:
        the ledger itself, or, sharded, a cached canonical unsharding of it
        (content-exact, the single-device probe layout), made again after
        a commit invalidates it."""
        if not self._ledger_is_sharded:
            return self.ledger
        if self._canon is None:
            self._canon = shard_mod.unshard_ledger(self.ledger,
                                                   self._shard_mesh)
            if _obs.enabled:
                _obs.counter("sharding.unshards").inc()
        return self._canon

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
        if (self._sanitize and self._sanitize_capture_base is not None
                and self._deferred_inflight == 0):
            # Every commit funnels through this read-back: a post-warmup
            # capture is caught one read-back after it happened.  Checked
            # only with the pipeline quiescent (a running closure may be
            # mid-growth, its grace flag not yet set).
            self._sanitize_capture_check("serving commit path")
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
        if self._engine is not None:
            return self._engine_commit("create_accounts", batch, timestamp)
        any_linked = bool((batch["flags"] & types.AccountFlags.LINKED).any())
        if self.force_sequential or (
            any_linked and self._has_intra_batch_dup_ids(batch)
        ):
            return self._sequential("create_accounts", batch, timestamp)
        self._note_shard_inserts("accounts", batch, count)
        self._grow_if_needed(accounts=count)
        if bool((batch["flags"] & types.AccountFlags.HISTORY).any()):
            self._history_accounts_possible = True
        if bool((batch["flags"] & _LIMIT_FLAGS).any()):
            self._limit_accounts_possible = True
        soa = self._pad_soa(batch)
        if self._ledger_is_sharded:
            # The same codes; owner-local inserts, one overflow flag a shard.
            self.ledger, codes_dev = self._shard_steps["accounts"](
                self.ledger, soa, count, timestamp)
        else:
            self.ledger, codes_dev = sm.create_accounts(self.ledger, soa,
                                                        count, timestamp)
        codes, words = self._d2h_codes(codes_dev,
                                       self.ledger.accounts.probe_overflow)
        self._accounts_bound += count
        if words.any():
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
        if self._engine is not None:
            return self._engine_commit("create_transfers", batch, timestamp)
        self._note_balance_bound(batch)
        if self.force_sequential:
            return self._sequential("create_transfers", batch, timestamp)
        if self._ledger_is_sharded:
            return self._sharded_commit_transfers(batch, timestamp, count)
        if self._fast_path_ok(batch):
            return self._commit_fast(batch, timestamp, count)
        return self._commit_full(batch, timestamp, count)

    # -- sharded commits (parallel/sharded.py) ---------------------------------

    def _sharded_commit_transfers(
        self, batch: np.ndarray, timestamp: int, count: int
    ) -> List[Tuple[int, int]]:
        """The sharded commit path: each shard probes its local tables for
        the whole batch, one psum a round carries every leg's context to
        every device, validation runs once a device and balances and
        inserts apply owner-locally.  Codes and balances equal the
        single-device kernels'; batches the general step routes (FLAG_SEQ:
        history accounts, deep cascades) and every batch of a tiered machine
        (the sharded kernels carry no Bloom filter) run in the sequential
        window."""
        if self._tiering or self.cold.count:
            return self._sequential("create_transfers", batch, timestamp)
        self._note_cross_shard(batch, count)
        self._note_shard_inserts("transfers", batch, count)
        if self._fast_path_ok(batch):
            self._grow_if_needed(transfers=count)
            soa = self._pad_soa(batch)
            self.ledger, codes_dev = self._shard_steps["fast"](
                self.ledger, soa, count, timestamp)
            codes, words = self._d2h_codes(
                codes_dev, self.ledger.transfers.probe_overflow)
            self._transfers_bound += count
            if words.any():
                raise RuntimeError(
                    "transfers probe overflow during fast insert")
            if _obs.enabled:
                _obs.counter("sharding.batches").inc()
            self._index_append(soa["id_lo"], soa["id_hi"], codes_dev, count)
            results = self._compress(codes, count)
            self._update_commit_timestamp(codes, count, timestamp)
            return results
        pv_count, hist_count = self._transfer_growth_counts(batch)
        self._grow_if_needed(transfers=count, posted=pv_count,
                             history=hist_count)
        soa = self._pad_soa(batch)
        use_waves = self.waves_enabled
        step = self._shard_steps["full_waves" if use_waves else "full"]
        for _attempt in range(8):
            r = step(self.ledger, soa, count, timestamp)
            self.ledger = r[0]
            codes, words = self._d2h_codes(*r[1:])
            kflags = int(words[0])
            if kflags == 0:
                if _obs.enabled:
                    _obs.counter("sharding.batches").inc()
                return self._full_commit_success(
                    soa, r[1], codes, count, pv_count, hist_count, timestamp,
                    words[1:] if use_waves else None)
            if kflags & tf.FLAG_SEQ:
                return self._sequential("create_transfers", batch, timestamp)
            # No FLAG_COLD on the mesh path: the rest are growth requests.
            self._grow_flagged(kflags)
        raise RuntimeError(
            "sharded transfer kernel could not place batch after growth")

    def _note_shard_inserts(self, which: str, batch: np.ndarray,
                            count: int) -> Optional[np.ndarray]:
        """Advance the per-shard attempted-insert bound of ``which`` by
        this batch's id owners (rejected lanes count too), before the
        growth decision; returns the per-shard counts (None off the mesh)."""
        if self._shard_mesh is None or count == 0:
            return None
        owners = (
            mix64_np(batch["id_lo"][:count].astype(np.uint64),
                     batch["id_hi"][:count].astype(np.uint64))
            & np.uint64(self.shards - 1)
        ).astype(np.int64)
        counts = np.bincount(owners, minlength=self.shards)
        self._shard_insert_bounds[which] += counts
        return counts

    def _refresh_shard_bounds(self, ledger) -> None:
        """Floor the per-shard bounds at the live per-shard counts (an
        external install, the sequential window, a recovery)."""
        if self._shard_mesh is None:
            return
        self._shard_insert_bounds = {
            "accounts": convert.tensor_to_array(
                ledger.accounts.count).astype(np.int64),
            "transfers": convert.tensor_to_array(
                ledger.transfers.count).astype(np.int64),
        }

    def _note_cross_shard(self, batch: np.ndarray, count: int) -> None:
        """Cross-shard accounting on the host: a lane whose debit and credit
        accounts have different owners settles through the psum's leg
        exchange.  Post/void lanes carry zero account ids on both sides and
        count as same-shard."""
        mask = np.uint64(self.shards - 1)
        dr = mix64_np(batch["debit_account_id_lo"].astype(np.uint64),
                      batch["debit_account_id_hi"].astype(np.uint64)) & mask
        cr = mix64_np(batch["credit_account_id_lo"].astype(np.uint64),
                      batch["credit_account_id_hi"].astype(np.uint64)) & mask
        cross = int((dr != cr).sum())
        self.shard_lanes_total += count
        self.shard_lanes_cross += cross
        if _obs.enabled:
            _obs.counter("sharding.lanes").inc(count)
            _obs.counter("sharding.cross_shard_lanes").inc(cross)
            _obs.histogram("sharding.cross_shard_pct", "%").observe(
                100 * cross // max(count, 1))

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
        self._index_append(soa["id_lo"], soa["id_hi"], codes_dev, count)
        results = self._compress(codes, count)
        self._update_commit_timestamp(codes, count, timestamp)
        return results

    # -- the online shard split ---------------------------------------------------
    #
    # An N -> 2N split executed while serving: the old layout keeps
    # committing; between batches the machine ships the owner-changed rows
    # through the vsr/statesync codec (each chunk verified against the
    # source's Merkle tree), catches up changed slots in delta rounds, and
    # cuts over only after the staged state passes the whole-state checksum
    # gate and the new layout's per-shard scrub lanes fold to the canonical
    # digest.  Any verification failure abandons the split and serving
    # goes on in the old layout.  Migration state is volatile: a crash
    # mid-migration restarts on the old layout.

    @property
    def reshard_active(self) -> bool:
        return self._reshard is not None

    def reshard_begin(
        self, target_shards: int, *, verify: bool = True,
        chunk_rows: int = 512, corrupt_chunks=(), corrupt_persistent=False,
    ) -> bool:
        """Arm an online N -> 2N shard split.  True when the migration is
        armed (idempotent while one is in flight); False, counted and
        warned, when this machine cannot split.  ``corrupt_chunks`` and
        ``corrupt_persistent`` inject faults: flip a byte of the numbered
        migration chunks, once or on every retry."""
        if self._reshard is not None:
            return True
        reason = None
        n_devices = len(device_mod.devices(self.device))
        if self.shards < 2 or self._shard_mesh is None:
            reason = "machine is not in sharded mode"
        elif target_shards != self.shards * 2:
            reason = f"{self.shards} -> {target_shards} is not a doubling"
        elif self._engine is not None:
            reason = "host engine is the commit authority"
        elif self._tiering or self.cold.count:
            reason = "cold tier active (evicted rows have no leaves)"
        elif n_devices < target_shards:
            reason = (f"{target_shards} shards need {target_shards} "
                      f"devices, have {n_devices}")
        else:
            for cap in (self.config.accounts_capacity,
                        self.config.transfers_capacity,
                        self.config.posted_capacity):
                if cap % target_shards:
                    reason = "capacity not divisible by the target shards"
        if reason is not None:
            self.reshard_stats["abandons"] += 1
            if _obs.enabled:
                _obs.counter("reconfig.reshard_abandoned").inc()
            warnings.warn(
                f"shard split refused: {reason} (serving continues on the "
                f"current layout)", RuntimeWarning, stacklevel=2,
            )
            return False
        self.reshard_stats["splits_started"] += 1
        self._reshard = {
            "target": int(target_shards), "verify": bool(verify),
            "chunk_rows": int(chunk_rows), "round": 0, "queue": [],
            "src": None, "trees": None, "wire": None,
            "shipped_leaves": None, "shipped_mask": None, "chunks_sent": 0,
            "corrupt_chunks": set(int(c) for c in corrupt_chunks),
            "corrupt_persistent": bool(corrupt_persistent),
        }
        if _obs.enabled:
            _obs.counter("reconfig.reshard_started").inc()
            _obs.gauge("reconfig.reshard_active").set(1)
        return True

    def reshard_abort(self) -> None:
        """Operator abort: drop the migration, keep serving the old layout
        untouched."""
        if self._reshard is not None:
            self._reshard_abandon("operator abort")

    def reshard_step(self, max_chunks: int = 8) -> str:
        """Advance an active split by up to ``max_chunks`` verified chunks;
        call between commit batches.  Returns 'idle' (no split),
        'migrating', 'done' (cut over in this step) or 'abandoned'."""
        rs = self._reshard
        if rs is None:
            return "idle"
        from .vsr import statesync as _ss

        for _ in range(max_chunks):
            rs = self._reshard
            if rs is None:
                return "abandoned"
            if not rs["queue"]:
                status = self._reshard_advance()
                if status != "migrating":
                    return status
                continue
            pad, slots = rs["queue"].pop(0)
            tree = rs["trees"][pad]
            cap = _ss.pad_capacity(rs["src"], pad)
            chunk_id = rs["chunks_sent"]
            rows = None
            for attempt in (0, 1):
                corrupt = chunk_id in rs["corrupt_chunks"] and (
                    attempt == 0 or rs["corrupt_persistent"])
                body = _ss.ship_chunk(rs["src"], tree, pad, slots,
                                      corrupt=corrupt)
                if not rs["verify"]:
                    # The scrub-off negative control: install unaudited.
                    rows = _ss.unpack_rows(rs["src"], pad, slots, body)
                    break
                rows = _ss.verify_chunk(rs["src"], tree, pad, slots, body)
                if rows is not None:
                    break
                self.reshard_stats["chunk_retries"] += 1
                if _obs.enabled:
                    _obs.counter("reconfig.chunk_retries").inc()
            if rows is None:
                return self._reshard_abandon(
                    f"chunk {chunk_id} ({pad}) failed verification twice")
            for k in _ss.per_slot_keys(rs["src"], pad):
                rs["wire"][pad][k][slots] = rows[k]
            # The SOURCE leaf is recorded as shipped even unaudited: with
            # verification off a corrupted chunk stays divergent up to the
            # cutover, for the auditor to catch.
            rs["shipped_leaves"][pad][slots] = tree[cap + slots]
            rs["shipped_mask"][pad][slots] = True
            rs["chunks_sent"] += 1
            self.reshard_stats["chunks"] += 1
            self.reshard_stats["bytes_migrated"] += len(body)
            if _obs.enabled:
                _obs.counter("reconfig.bytes_migrated").inc(len(body))
        return "migrating"

    def _reshard_snapshot(self):
        """A fresh canonical flat-array snapshot and its trees (the state
        sync responder's view of this machine's live state)."""
        from .vsr import checkpoint as _ckpt
        from .vsr import statesync as _ss

        arrays = _ckpt.ledger_to_arrays(self.checkpoint_ledger())
        return arrays, _ss.build_trees(arrays)

    def _reshard_advance(self) -> str:
        """Queue drained: take a fresh snapshot, queue the moved slots whose
        leaves changed since their last shipment (a delta round), or cut
        over when a round comes back empty."""
        from .vsr import statesync as _ss

        rs = self._reshard
        arrays, trees = self._reshard_snapshot()
        if rs["src"] is not None and any(
            _ss.pad_capacity(arrays, pad) != _ss.pad_capacity(rs["src"], pad)
            for pad in _ss.PADS
        ):
            # A table grew mid-migration: leaf indexes are incomparable
            # across capacities, so the split restarts (counted; the old
            # layout served throughout).
            self.reshard_stats["restarts"] += 1
            if _obs.enabled:
                _obs.counter("reconfig.reshard_restarts").inc()
            rs["wire"] = None
        if rs["wire"] is None:
            rs["wire"] = {
                pad: {k: np.zeros_like(arrays[k])
                      for k in _ss.per_slot_keys(arrays, pad)}
                for pad in _ss.PADS
            }
            rs["shipped_leaves"] = {
                pad: np.zeros(_ss.pad_capacity(arrays, pad), np.uint64)
                for pad in _ss.PADS
            }
            rs["shipped_mask"] = {
                pad: np.zeros(_ss.pad_capacity(arrays, pad), bool)
                for pad in _ss.PADS
            }
            rs["round"] = 0
            # The full-transfer baseline the differential protocol is
            # judged against: every live row of every pad.
            self.reshard_stats["bytes_full"] = sum(
                int(((arrays[f"{pad}/key_lo"] | arrays[f"{pad}/key_hi"])
                     != 0).sum()) * _ss.row_bytes(arrays, pad)
                for pad in _ss.PADS
            )
        queue = []
        for pad in _ss.PADS:
            cap = _ss.pad_capacity(arrays, pad)
            moved = shard_mod.split_moved_mask(
                arrays[f"{pad}/key_lo"], arrays[f"{pad}/key_hi"], self.shards)
            leaves = trees[pad][cap:]
            need = moved & (~rs["shipped_mask"][pad]
                            | (leaves != rs["shipped_leaves"][pad]))
            for piece in _ss.chunk_slots(np.nonzero(need)[0],
                                         rs["chunk_rows"]):
                queue.append((pad, piece))
        rs["src"], rs["trees"] = arrays, trees
        if not queue:
            return self._reshard_cutover(arrays, trees)
        rs["queue"] = queue
        if rs["round"] > 0:
            self.reshard_stats["catchup_rounds"] += 1
        rs["round"] += 1
        return "migrating"

    def _reshard_cutover(self, arrays, trees) -> str:
        """The cutover rule: the staged state (the rows that stayed, which
        never left their device, and the verified wire rows) must pass the
        whole-state checksum gate, and the NEW layout's per-shard scrub
        lanes must fold to the canonical digest, before the swap.  A gate
        failure abandons; the old layout was never touched."""
        from .vsr import checkpoint as _ckpt
        from .vsr import statesync as _ss

        rs = self._reshard
        staged = {k: v.copy() for k, v in arrays.items()}
        for pad in _ss.PADS:
            moved = shard_mod.split_moved_mask(
                arrays[f"{pad}/key_lo"], arrays[f"{pad}/key_hi"], self.shards)
            slots = np.nonzero(moved)[0]
            for k in _ss.per_slot_keys(arrays, pad):
                staged[k][slots] = rs["wire"][pad][k][slots]
        if rs["verify"] and (
                _ss.arrays_checksum(staged) != _ss.arrays_checksum(arrays)):
            return self._reshard_abandon("whole-state checksum gate failed")
        digest_want = _ss.np_digest(arrays)
        devs = device_mod.devices(self.device)
        new_mesh = Mesh(devs[:rs["target"]])
        new_steps = shard_mod.machine_steps(new_mesh,
                                            self.config.jacobi_max_passes)
        sharded_led = shard_mod.shard_ledger(
            _ckpt.arrays_to_ledger(staged, new_mesh.primary), new_mesh)
        # The per-shard commitment gate: the 2N scrub lanes (wrap-add
        # partial folds, one a shard) must sum to the canonical digest.
        lanes = convert.tensor_to_array(new_steps["scrub"](sharded_led))
        with np.errstate(over="ignore"):
            got = int(lanes[:, 0].sum(dtype=np.uint64))
        if rs["verify"] and got != digest_want:
            return self._reshard_abandon(
                "per-shard commitment roots do not fold to the canonical "
                "digest")
        old_shards = self.shards
        self.shards = rs["target"]
        self._shard_mesh = new_mesh
        self._shard_steps = new_steps
        self._merkle_steps_cache = None
        self._ledger = sharded_led  # already placed on the new mesh
        self._ledger_is_sharded = True
        self._canon = None
        self._refresh_shard_bounds(sharded_led)
        self._merkle_mark_dirty()
        self.reshard_stats["splits_completed"] += 1
        audited = rs["verify"]
        self._reshard = None
        if _obs.enabled:
            _obs.counter("reconfig.reshard_completed").inc()
            _obs.gauge("reconfig.reshard_active").set(0)
            _obs.gauge("sharding.shards").set(self.shards)
        if audited:
            # Converter sanity on the audited path only: with verification
            # off an installed divergence is the auditor's to catch.
            assert int(self.digest()) == digest_want, (
                f"post-cutover digest diverged after {old_shards} -> "
                f"{self.shards} split")
        return "done"

    def _reshard_abandon(self, reason: str) -> str:
        self.reshard_stats["abandons"] += 1
        self._reshard = None
        if _obs.enabled:
            _obs.counter("reconfig.reshard_abandoned").inc()
            _obs.gauge("reconfig.reshard_active").set(0)
        warnings.warn(
            f"shard split abandoned: {reason} (serving continues on the "
            f"{self.shards}-shard layout)", RuntimeWarning, stacklevel=3,
        )
        return "abandoned"

    # -- the commit pipeline ------------------------------------------------------

    # Fixed run length of the grouped dispatch: one captured graph per
    # ledger layout; runs pad with zero-count batches, which apply nothing.
    GROUP_K = group_mod.GROUP_K

    @property
    def group_device_commit(self) -> bool:
        """Grouped device commit (TB_GROUP_COMMIT=0/1, or the setter).  By
        default on for a CUDA machine, where a run of GROUP_K batches is one
        graph replay, and off on the CPU, where the plain loop pays every
        padding step."""
        if self._group_device_commit is None:
            env = os.environ.get("TB_GROUP_COMMIT")
            self._group_device_commit = (
                env == "1" if env in ("0", "1")
                else self.device.type == "cuda"
            )
        return self._group_device_commit

    @group_device_commit.setter
    def group_device_commit(self, value: bool) -> None:
        self._group_device_commit = value

    @property
    def fuse_batches(self) -> bool:
        """Cross-batch conflict fusion (TB_FUSE env, default off, or the
        setter), read by the replica's dispatch lane."""
        if self._fuse_batches is None:
            from .vsr import overload

            self._fuse_batches = overload.fusion_enabled()
        return self._fuse_batches

    @fuse_batches.setter
    def fuse_batches(self, value: bool) -> None:
        self._fuse_batches = bool(value)

    @property
    def pipeline_depth(self) -> int:
        """Deferred read-back depth (TB_PIPELINE env, default 2, or the
        setter), 1 or 2: depth 1 disables deferral, depth 2 pipelines one
        commit group.  The reference reserves deeper values (equivalent to
        2 there); the port holds them at 2 until a deeper pipeline exists."""
        if self._pipeline_depth is None:
            self._pipeline_depth = min(2, pipeline_depth_default())
        return self._pipeline_depth

    @pipeline_depth.setter
    def pipeline_depth(self, value: int) -> None:
        self._pipeline_depth = min(2, max(1, int(value)))

    def _on_lane(self) -> bool:
        return getattr(self._lane_tls, "on_lane", False)

    def _dispatch_lane(self):
        """The one-worker FIFO executor deferred dispatches run on (one
        worker == dispatch order == op order; growth rides each closure so
        the ledger chain never interleaves).  On the card it runs them on a
        stream of its own, so the serving thread's copies and reads do not
        queue behind them."""
        if self._lane is None:
            self._lane = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="tb-dispatch")
            if self.device.type == "cuda" and self._lane_stream is None:
                self._lane_stream = torch.cuda.Stream(self.device)
        return self._lane

    def _lane_dispatch(self, dispatch, deferred: bool):
        """Run (deferred=False) or submit (deferred=True) a commit closure.
        A submitted closure runs on the lane thread and, on the card, on the
        lane's stream after the submitting stream's work so far; its result
        carries an event marking the end of its device work."""
        if not deferred:
            return dispatch()
        lane = self._dispatch_lane()
        cuda = self.device.type == "cuda"
        after = None
        if cuda:
            after = torch.cuda.Event()
            after.record(torch.cuda.current_stream(self.device))
        stream = self._lane_stream

        def run():
            self._lane_tls.on_lane = True
            if not cuda:
                return dispatch()
            timing = self.lane_events
            with torch.cuda.stream(stream):
                stream.wait_event(after)
                if timing is not None:
                    start = torch.cuda.Event(enable_timing=True)
                    start.record(stream)
                out = dispatch()
                done = torch.cuda.Event(enable_timing=timing is not None)
                done.record(stream)
            if timing is not None:
                timing.append((start, done))
            return (*out, done)

        fut = lane.submit(run)
        self._lane_tail = fut
        return fut

    def _lane_drain(self) -> None:
        """Wait on the host for the lane stream's queued work: a staging set
        goes back on the free-list only after its copy ran.  A failed
        device cannot run it; its error surfaces at the resolve or the
        next commit, not here."""
        if self._lane_stream is not None:
            try:
                self._lane_stream.synchronize()
            except DEVICE_FAULT_TYPES:  # noqa: BLE001 - the fault funnels own it
                pass

    def _lane_join(self) -> None:
        """Wait for the lane's last closure (its error, if any, surfaces at
        its handle's resolve) and, on the card, order the current stream
        after the lane's stream."""
        fut, self._lane_tail = self._lane_tail, None
        if fut is None:
            return
        concurrent.futures.wait([fut])
        if self._lane_stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(
                self._lane_stream)

    def _stage_acquire(self, k: int) -> dict:
        """One staging set for a run of ``k`` batches (an
        ``ops.group.StagingLayout`` byte buffer, pinned on the card), from
        the free-list or new: a set must not be refilled while a dispatch
        that reads it is in flight; DeviceCommitHandle.resolve releases it
        back here."""
        pool = self._stage_pool.setdefault(k, [])
        if pool:
            return pool.pop()
        layout = group_mod.StagingLayout(k, self.batch_lanes)
        buf = torch.zeros(layout.nbytes, dtype=torch.uint8,
                          pin_memory=self.device.type == "cuda")
        cols, counts, tss = layout.arrays(buf.numpy())
        return {"k": k, "layout": layout, "buf": buf, "cols": cols,
                "counts": counts, "timestamps": tss, "dirty": [0] * k}

    def _stage_release(self, stage: dict) -> None:
        if self._sanitize:
            # Anything still reading this set after release sees 0xA5
            # garbage; every lane is dirty, so the next occupant zeroes it.
            _san.poison([stage["buf"].numpy()])
            stage["dirty"] = [self.batch_lanes] * stage["k"]
        self._stage_pool.setdefault(stage["k"], []).append(stage)

    def _stage_group(self, batches: List[np.ndarray], timestamps: List[int],
                     k: int) -> dict:
        """Stack a run's batches into a staging set of ``k`` rows (counts 0
        and the last timestamp in the padding rows); dirty-row tracking
        zeroes only the lanes the previous occupant wrote."""
        stage = self._stage_acquire(k)
        cols, dirty = stage["cols"], stage["dirty"]
        lens = [len(batches[j]) if j < len(batches) else 0 for j in range(k)]
        for name, buf in cols.items():
            for j in range(k):
                n = lens[j]
                if dirty[j] > n:
                    buf[j, n:dirty[j]] = 0
                if n:
                    buf[j, :n] = batches[j][name]
        stage["dirty"] = lens
        stage["counts"][:] = lens
        stage["timestamps"][:] = list(timestamps) + [timestamps[-1]] * (
            k - len(timestamps))
        return stage

    def _staged_columns(self, stage: dict) -> dict:
        """The staged run's columns {name: [k, lanes]} on the machine's
        device: on the card one asynchronous copy of the pinned set on the
        current stream (the lane's), on the CPU views of it."""
        buf = stage["buf"]
        if self.device.type == "cuda":
            buf = buf.to(self.device, non_blocking=True)
        return stage["layout"].tensors(buf)[0]

    def _group_graph_for(self, ledger: sm.Ledger) -> group_mod.GroupGraph:
        """The grouped commit's graph for this ledger layout, captured anew
        when a table was reallocated (growth, a restore): the old graph and
        its buffers go first."""
        key = (self.GROUP_K, self.batch_lanes) + group_mod.ledger_key(ledger)
        graph = self._group_graph
        if graph is None or graph.key != key:
            self._group_graph = None
            graph = group_mod.GroupGraph(ledger, self.GROUP_K,
                                         self.batch_lanes)
            self._group_graph = graph
        return graph

    def _inflight_untrack(self, handle) -> None:
        try:
            self._inflight_handles.remove(handle)
        except ValueError:
            pass  # never tracked (fault domain off) or already recovered

    def _deferred_done(self, handle) -> None:
        if handle._deferred:
            handle._deferred = False
            self._deferred_inflight = max(0, self._deferred_inflight - 1)

    def _deferred_submitted(self, lanes: int, owners=None) -> None:
        """Commit-lane occupancy of one deferred dispatch (serving thread,
        at submit).  Sharded, the pipeline.shard.* series: every shard runs
        every batch, so ``inflight`` is the per-shard lane depth, and the
        per-shard lane counters (``owners``, the host-side owner counts)
        show the insert skew."""
        self._deferred_inflight += 1
        if not _obs.enabled:
            return
        prefix = "pipeline.shard." if self.shards else "pipeline."
        _obs.counter(prefix + "dispatches").inc()
        _obs.histogram(prefix + "inflight", "handles").observe(
            self._deferred_inflight)
        _obs.counter(prefix + "lanes").inc(lanes)
        if owners is not None:
            for s, c in enumerate(owners.tolist()):
                if c:
                    _obs.counter(f"pipeline.shard.lanes.{s}").inc(c)

    def commit_group_fast(self, batches: List[np.ndarray],
                          timestamps: List[int], deferred: bool = False):
        """Commit a RUN of fast-path-eligible create_transfers batches in
        ONE device dispatch with ONE device-to-host codes read: on the card
        one replay of the grouped commit's CUDA graph (ops/group.py), on
        the CPU the plain loop.

        Returns per-batch results index-aligned with ``batches``, or None
        when the run is not groupable (the caller commits batch by batch).
        Each batch carries its own prepare timestamp, so the results equal
        committing the run batch by batch.  ``deferred=True`` returns a
        DeviceCommitHandle instead: the run is in flight on the dispatch
        lane and the caller resolves it, in dispatch order."""
        if (
            not self.group_device_commit
            or self._engine is not None
            or self.force_sequential
            or not (2 <= len(batches) <= self.GROUP_K)
        ):
            return None
        counts = [len(b) for b in batches]
        if any(c == 0 or c > self.batch_lanes for c in counts):
            return None
        # Eligibility is order-dependent (the balance bound grows per
        # batch); on a mid-run refusal restore the entry bound, since the
        # per-batch fallback notes every batch itself.
        bound0 = self._balance_bound
        for b in batches:
            self._note_balance_bound(b)
            if not self._fast_path_ok(b):
                self._balance_bound = bound0
                return None
        if timestamps[-1] > self.prepare_timestamp:
            self.prepare_timestamp = timestamps[-1]
        self._scrub_maybe_check()  # no-op unless armed, due and lane idle
        if self._ledger_is_sharded:
            return self._commit_group_fast_sharded(batches, timestamps,
                                                   counts, deferred)
        k = len(batches)
        stage = self._stage_group(batches, timestamps, self.GROUP_K)
        # Row bounds advance at submit, and the closure's growth target is
        # snapshotted here, so it never depends on how far the serving
        # thread raced ahead.
        need = self._transfers_bound + sum(counts)
        self._transfers_bound = need
        merkle_closure = (self._merkle_forest is not None
                          and not self.merkle_async)

        def dispatch():
            # Growth, dispatch and index maintenance stay one unit so the
            # FIFO lane keeps the ledger chain in order.
            self._grow_if_needed(transfers_need=need)
            if self.device.type == "cuda":
                graph = self._group_graph_for(self.ledger)
                codes, overflow, id_lo, id_hi = graph.run(stage["buf"])
            else:
                (self.ledger, codes, overflow, id_lo, id_hi) = \
                    group_mod.group_dispatch_steps(
                        self.ledger, self._staged_columns(stage),
                        [int(c) for c in stage["counts"]],
                        [int(t) for t in stage["timestamps"]])
            for j in range(k):
                self._index_append(id_lo[j], id_hi[j], codes[j],
                                          counts[j])
            if merkle_closure:
                # The commitment update rides the ledger chain, batch by
                # batch.
                for j in range(k):
                    self._merkle_update_transfers_batches([batches[j]])
            return codes, overflow

        armed_mirror = self._scrub_mirror is not None
        armed = armed_mirror or self._merkle_forest is not None
        result = self._lane_dispatch(dispatch, deferred)
        handle = DeviceCommitHandle(
            self, result, counts, list(timestamps), stacked=True, stage=stage,
            batches=list(batches) if armed_mirror else None,
            deferred=deferred,
        )
        if self._merkle_forest is not None and not merkle_closure:
            for b in batches:
                self._merkle_lane_enqueue("create_transfers", b)
        if deferred:
            self._deferred_submitted(sum(counts))
        if armed:
            self._inflight_handles.append(handle)
        if deferred:
            return handle
        return handle.resolve()  # ONE read-back for the whole group

    def _commit_group_fast_sharded(self, batches, timestamps, counts,
                                   deferred: bool):
        """The grouped commit over the mesh: the run's batches are padded on
        the serving thread, then ONE dispatch closure drives the sharded
        ``fast_probed`` step batch by batch (the ledger threaded through,
        growth snapshotted at submit) with ONE read-back of the codes and
        the per-shard overflow flags for the whole run.  The results equal
        committing the run batch by batch on the blocking sharded path."""
        k = len(batches)
        owner_sum = np.zeros(self.shards, np.int64)
        for b, c in zip(batches, counts):
            self._note_cross_shard(b, c)
            owner_sum += self._note_shard_inserts("transfers", b, c)
        soas = [self._pad_soa(b) for b in batches]
        total = sum(counts)
        need = self._transfers_bound + total
        self._transfers_bound = need
        snap = {name: v.copy() for name, v in self._shard_insert_bounds.items()}
        step = self._shard_steps["fast_probed"]
        merkle_closure = (self._merkle_forest is not None
                          and not self.merkle_async)

        def dispatch():
            self._grow_if_needed(transfers_need=need, shard_bounds=snap)
            codes_out, ovf_out = [], []
            for j in range(k):
                self.ledger, codes, overflow = step(
                    self.ledger, soas[j], counts[j], timestamps[j])
                self._index_append(soas[j]["id_lo"], soas[j]["id_hi"], codes,
                                   counts[j])
                if merkle_closure:
                    self._merkle_update_transfers_batches([batches[j]])
                codes_out.append(codes)
                ovf_out.append(overflow)
            if _obs.enabled:
                _obs.counter("sharding.batches").inc(k)
            return torch.stack(codes_out), torch.stack(ovf_out)

        armed_mirror = self._scrub_mirror is not None
        armed = armed_mirror or self._merkle_forest is not None
        result = self._lane_dispatch(dispatch, deferred)
        handle = DeviceCommitHandle(
            self, result, list(counts), list(timestamps), stacked=True,
            batches=list(batches) if armed_mirror else None,
            deferred=deferred,
        )
        if self._merkle_forest is not None and not merkle_closure:
            for b in batches:
                self._merkle_lane_enqueue("create_transfers", b)
        if deferred:
            self._deferred_submitted(total, owner_sum)
        if armed:
            self._inflight_handles.append(handle)
        if deferred:
            return handle
        return handle.resolve()  # ONE read-back for the whole run

    def commit_fast_deferred(
        self, batch: np.ndarray, timestamp: int
    ) -> Optional[DeviceCommitHandle]:
        """Dispatch ONE fast-path create_transfers batch on the dispatch
        lane and return its deferred read-back handle, or None when the
        batch is not fast-path eligible (the caller falls back to the
        blocking commit_batch).  The same kernels, codes and bookkeeping as
        ``_commit_fast``; only the read-back moves: the probed variant
        carries the overflow flag in a fresh tensor, so resolve() reads it
        after later dispatches."""
        count = len(batch)
        if (
            self._engine is not None
            or self.force_sequential
            or count == 0
            or count > self.batch_lanes
        ):
            return None
        bound0 = self._balance_bound
        self._note_balance_bound(batch)
        if not self._fast_path_ok(batch):
            self._balance_bound = bound0
            return None
        if timestamp > self.prepare_timestamp:
            self.prepare_timestamp = timestamp
        self._scrub_maybe_check()  # no-op unless armed, due and lane idle
        owners = stage = None
        if self._ledger_is_sharded:
            self._note_cross_shard(batch, count)
            owners = self._note_shard_inserts("transfers", batch, count)
            soa = self._pad_soa(batch)  # padded on the serving thread
        else:
            stage = self._stage_group([batch], [timestamp], 1)
        need = self._transfers_bound + count
        self._transfers_bound = need
        merkle_closure = (self._merkle_forest is not None
                          and not self.merkle_async)
        if self._ledger_is_sharded:
            snap = {name: v.copy()
                    for name, v in self._shard_insert_bounds.items()}
            step = self._shard_steps["fast_probed"]

            def dispatch():
                # The overflow flags ride a fresh output of the step.
                self._grow_if_needed(transfers_need=need, shard_bounds=snap)
                self.ledger, codes, overflow = step(self.ledger, soa, count,
                                                    timestamp)
                self._index_append(soa["id_lo"], soa["id_hi"], codes, count)
                if merkle_closure:
                    self._merkle_update_transfers_batches([batch])
                if _obs.enabled:
                    _obs.counter("sharding.batches").inc()
                return codes, overflow
        else:
            def dispatch():
                self._grow_if_needed(transfers_need=need)
                soa = {name: col[0] for name, col in
                       self._staged_columns(stage).items()}
                (self.ledger, codes, overflow, id_lo, id_hi) = \
                    sm.create_transfers_fast_probed(self.ledger, soa, count,
                                                    timestamp)
                self._index_append(id_lo, id_hi, codes, count)
                if merkle_closure:
                    self._merkle_update_transfers_batches([batch])
                return codes, overflow

        armed_mirror = self._scrub_mirror is not None
        armed = armed_mirror or self._merkle_forest is not None
        fut = self._lane_dispatch(dispatch, True)
        handle = DeviceCommitHandle(
            self, fut, [count], [timestamp], stacked=False, stage=stage,
            batches=[batch] if armed_mirror else None, deferred=True,
        )
        if self._merkle_forest is not None and not merkle_closure:
            self._merkle_lane_enqueue("create_transfers", batch)
        self._deferred_submitted(count, owners)
        if armed:
            self._inflight_handles.append(handle)
        return handle

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
        self._index_append(soa["id_lo"], soa["id_hi"], codes_dev, count)
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
            led.accounts = self._table_grow(
                led.accounts, led.accounts.capacity * 2, "accounts")
        if kflags & tf.FLAG_GROW_TRANSFERS:
            hot_max = self.hot_transfers_capacity_max
            if hot_max is not None and led.transfers.capacity >= hot_max:
                # Never allocate past the budget the ceiling encodes: make
                # room by spilling (the caller resets the certificate).
                self.evict_cold()
            else:
                led.transfers = self._table_grow(
                    led.transfers, led.transfers.capacity * 2, "transfers")
        if kflags & tf.FLAG_GROW_POSTED:
            led.posted = self._table_grow(
                led.posted, led.posted.capacity * 2, "posted")

    # -- the sequential path ----------------------------------------------------

    def _sequential(
        self, operation: str, batch: np.ndarray, timestamp: int
    ) -> List[Tuple[int, int]]:
        """The sequential path; on a sharded ledger in the sequential
        window: the ledger is pulled into the canonical single-device
        layout, the sequential path runs on it unchanged (growth, bounds
        and index bookkeeping included: ``_ledger_is_sharded`` is off for
        the window) and the result is placed back onto the mesh.  O(rows)
        host conversions; routed batches are rare by design."""
        if not self._ledger_is_sharded:
            return self._sequential_impl(operation, batch, timestamp)
        self.shard_seq_fallbacks += 1
        if _obs.enabled:
            _obs.counter("sharding.seq_fallbacks").inc()
        canon = shard_mod.unshard_ledger(self.ledger, self._shard_mesh)
        self._ledger_is_sharded = False
        self._ledger = canon
        try:
            return self._sequential_impl(operation, batch, timestamp)
        finally:
            self._end_canonical_window()

    def _end_canonical_window(self) -> None:
        """End of the sequential (or eviction) window: place the canonical
        ledger back onto the mesh."""
        self._ledger = shard_mod.shard_ledger(self.ledger, self._shard_mesh)
        self._ledger_is_sharded = True
        self._canon = None
        self._refresh_shard_bounds(self._ledger)

    def _sequential_impl(
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
            self._index_append(soa["id_lo"], soa["id_hi"], codes_dev, count)
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

    def _table_grow(self, table, capacity: int, name: str = ""):
        """ht.grow (one K2 rehash), or on a sharded table (``name`` the
        table's) the host re-placement at the new capacity (owners are the low hash bits, so
        rows never change shard; only the local homes do).  Growth moves
        every slot, so the commitment forest rebuilds from the grown layout
        at the next update or check."""
        self._merkle_mark_dirty()
        self._canon = None
        if self._sanitize and self._sanitize_capture_base is not None:
            # A new capacity makes a new graph: its capture is legitimate.
            self._sanitize_grace = True
        if isinstance(table, shard_mod.ShardedTable):
            if _obs.enabled:
                _obs.counter("sharding.grows").inc()
            return shard_mod.grow_sharded_table(table, name, capacity,
                                                self._shard_mesh)
        return ht.grow(table, capacity)

    def _shard_peak_floor(self, which: str, cap: int, bounds=None) -> int:
        """Sharded, the capacity must also keep the peak shard's attempted
        inserts under half its C/n region (hash skew can overfill one shard
        while the global count looks fine, and a fast-path overflow is
        fatal).  ``bounds``: a submit-time snapshot of the per-shard bounds
        (the deferred closures')."""
        if bounds is None:
            bounds = self._shard_insert_bounds
        if self._ledger_is_sharded and which in bounds:
            peak = int(bounds[which].max())
            while peak * 2 > cap // self.shards:
                cap *= 2
        return cap

    @staticmethod
    def _target_capacity(capacity: int, needed_rows: int) -> int:
        """Smallest power-of-two capacity keeping load factor <= 0.5."""
        while needed_rows * 2 > capacity:
            capacity *= 2
        return capacity

    def _grow_if_needed(
        self, accounts: int = 0, transfers: int = 0, posted: int = 0,
        history: int = 0, evict_ok: bool = True,
        transfers_need: Optional[int] = None, shard_bounds=None,
    ) -> None:
        """Keep every table's load factor under 0.5 using host-side row
        bounds (no device sync; bounds only overestimate), and the history
        log's capacity above its bound.  Each table growth is one rehash
        through kernel K2.  At the hot ceiling the transfers table spills
        its oldest rows instead of growing (unless ``evict_ok`` is False, as
        in a rehydration mid-commit: then its load may rise until the next
        eviction between batches).  ``transfers_need`` is a row target the
        deferred closures snapshot at submit: they run on the lane while the
        serving thread advances the bound, so a live read would make the
        growth moment timing-dependent; ``shard_bounds`` is its per-shard
        twin."""
        led = self.ledger
        cap = self._shard_peak_floor("accounts", self._target_capacity(
            led.accounts.capacity, self._accounts_bound + accounts
        ), shard_bounds)
        if cap != led.accounts.capacity:
            led.accounts = self._table_grow(led.accounts, cap, "accounts")
        cap = self._shard_peak_floor("transfers", self._target_capacity(
            led.transfers.capacity,
            transfers_need if transfers_need is not None
            else self._transfers_bound + transfers,
        ), shard_bounds)
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
                    led.transfers = self._table_grow(led.transfers, cap,
                                                     "transfers")
        posted_need = self._posted_bound + posted
        if self._ledger_is_sharded:
            # Posted keys (pending timestamps) are not host-computable per
            # shard: a 2x target (global load <= 0.25) keeps the peak shard
            # under 0.5 but at negligible skew, and the general step's
            # claim overflow still grows and retries.
            posted_need *= 2
        cap = self._target_capacity(led.posted.capacity, posted_need)
        if cap != led.posted.capacity:
            led.posted = self._table_grow(led.posted, cap, "posted")
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
        assert self._engine is None, "tiering runs on the device path"
        if self._ledger_is_sharded:
            # Eviction is a canonical-layout concern: the eviction runs
            # unchanged in the window the sequential path uses.
            canon = shard_mod.unshard_ledger(self.ledger, self._shard_mesh)
            self._ledger_is_sharded = False
            self._ledger = canon
            try:
                return self._evict_cold_impl(frac)
            finally:
                self._end_canonical_window()
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

    def _index_append(self, id_lo: torch.Tensor, id_hi: torch.Tensor,
                      codes_dev: torch.Tensor, count: int) -> None:
        """Append a committed create_transfers batch (its id columns) to the
        transfer index and the materialized transfer field indexes; with
        ``lazy_index`` (bulk ingest) mark them stale instead, and the next
        query rebuilds them from the table in one go.  The deferred
        closures run it on the lane, right after their kernels, where
        ``self.ledger`` is the one their dispatch left.  A sharded machine
        always marks them stale: the query path reads the canonical view."""
        if self.config.lazy_index or self._shard_mesh is not None:
            if not self.index.stale:
                self.index.reset()
            self.scans_transfers.reset()
            return
        ok = self._ok_mask(codes_dev, count)
        self.index.append_batch(self.ledger, id_lo, id_hi, ok)
        if self.scans_transfers.indexes:
            self.scans_transfers.append_batch(self.ledger, id_lo, id_hi, ok)

    def _scan_append_accounts(self, soa: dict, codes_dev: torch.Tensor,
                              count: int) -> None:
        if not self.scans_accounts.indexes:
            return
        if self.config.lazy_index or self._shard_mesh is not None:
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
        if self._engine is not None:
            return self._engine.lookup_accounts(ids)
        found, cols = sm.lookup_accounts(self._query_ledger(),
                                         *self._ids(ids))
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
        if self._engine is not None:
            found, rows = self._engine.lookup_transfers(ids)
            return rows[found]  # no cold tier in host mode
        lo, hi = self._ids(ids)
        found, cols = sm.lookup_transfers(self._query_ledger(), lo, hi)
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
        self._index_fresh()
        acct_lo, acct_hi, ts_min, ts_max, descending, limit = window
        flags = int(filt["flags"])
        # Candidate cap: the power of two covering the largest reply.
        k = 1 << (QUERY_ROWS_MAX - 1).bit_length()
        valid, tid_lo, tid_hi = self.index.query(
            self._query_ledger(), acct_lo, acct_hi, ts_min, ts_max,
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
        found, cols = sm.lookup_transfers(self._query_ledger(), tid_lo,
                                          tid_hi)
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
        self._index_fresh()
        ts_min, ts_max = self._scan_window(timestamp_min, timestamp_max)
        limit = min(limit, QUERY_ROWS_MAX)
        tid_lo, tid_hi = self.scans_transfers.evaluate(
            expr, self._query_ledger(), ts_min, ts_max, limit, bool(reversed))
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
        self._index_fresh()
        ts_min, ts_max = self._scan_window(timestamp_min, timestamp_max)
        limit = min(limit, QUERY_ROWS_MAX)
        tid_lo, tid_hi = self.scans_accounts.evaluate(
            expr, self._query_ledger(), ts_min, ts_max, limit, bool(reversed))
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
        qled = self._query_ledger()
        k = min(qled.history.capacity, QUERY_ROWS_MAX)
        # K16's order check rides the rows' one read-back.
        valid, rows, err = query.scan_history_deferred(
            qled, acct_lo, acct_hi, ts_min, ts_max,
            bool(flags & types.AccountFilterFlags.DEBITS),
            bool(flags & types.AccountFilterFlags.CREDITS),
            descending, k)
        host, err = convert.tensors_and_word_to_arrays(
            {"_valid": valid, **rows}, err)
        query.check_order(err)
        valid = host.pop("_valid")
        host["reserved"] = np.zeros(len(valid), dtype="V56")
        out = types.from_soa(host, types.ACCOUNT_BALANCE_DTYPE)
        return out[valid][: min(limit, k)]

    # -- parity surface ------------------------------------------------------

    def balances_snapshot(self) -> List[Tuple[int, int, int, int, int, int]]:
        """(id, dp, dpo, cp, cpo, ts) sorted by id — comparable with
        ReferenceStateMachine.balances_snapshot()."""
        a = self._query_ledger().accounts
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
        if self._ledger_is_sharded:
            return u64(shard_mod.ledger_digest(self.ledger).item())
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
        observed.  The deferred and grouped commits queue their records at
        submit; a settle runs on the serving thread with the lane idle."""
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
        keeps the mirror only when ``scrub_paranoid``.  No-op in host-engine
        mode, where the numpy ledger is already the authority."""
        if self._engine is not None or self.scrub_interval <= 0:
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
            self._query_ledger(),
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
        Returns False when no live account exists yet (or in host-engine
        mode, with no device ledger to corrupt)."""
        if self._engine is not None:
            return False
        a = self.ledger.accounts
        # Sharded, the slot is global (the parts' concatenation), as the
        # reference's sharded array indexes it.
        parts = getattr(a, "parts", [a])
        key_lo = np.concatenate([convert.tensor_to_array(p.key_lo)
                                 for p in parts])
        key_hi = np.concatenate([convert.tensor_to_array(p.key_hi)
                                 for p in parts])
        live = np.flatnonzero((key_lo != 0) | (key_hi != 0))
        if live.size == 0:
            return False
        slot = int(live[rng.randrange(live.size)])
        col = self._SDC_COLS[rng.randrange(len(self._SDC_COLS))]
        bit = rng.randrange(64)
        local = parts[0].capacity
        arr = parts[slot // local].cols[col]
        arr[slot % local] = arr[slot % local] ^ i64(1 << bit)
        self._canon = None  # the corruption must be visible to queries too
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
        if not self.scrub_armed or self._engine is not None or (
            len(batch) == 0
        ):
            return impl(batch, timestamp)
        while True:
            try:
                self._scrub_maybe_check()
                results = impl(batch, timestamp)
                self._device_fault_streak = 0
                break
            except DEVICE_FAULT_TYPES as err:
                recovered = self._on_blocking_device_fault(
                    operation, batch, timestamp, err)
                if recovered is not None:
                    return recovered  # degraded: the host engine committed
        self._scrub_commits += 1
        self._mirror_apply(operation, batch, timestamp)
        self._merkle_apply(operation, batch)
        return results

    def _on_blocking_device_fault(self, operation, batch, timestamp, err):
        """One failed blocking dispatch: quarantine, rebuild the ledger from
        the mirror and back off (the caller retries), or, at
        ``device_fault_limit`` consecutive failures, degrade to the host
        engine and commit there.  Returns the results when degraded, None
        when the caller should retry."""
        if _obs.enabled:
            _obs.counter("device_recovery.dispatch_faults").inc()
        self._device_fault_streak += 1
        if self._device_fault_streak >= self.device_fault_limit or (
            self._context_lost(err)
        ):
            self._degrade_to_host_engine(err)
            results = self._engine_commit(operation, batch, timestamp)
            self._device_fault_streak = 0
            return results
        self.quarantine()
        self._rematerialize_from_mirror()
        self._retry_backoff()
        self.device_recoveries += 1
        if _obs.enabled:
            _obs.counter("device_recovery.recoveries").inc()
            _obs.counter("device_recovery.redispatches").inc()
        return None

    def _device_fault_at_resolve(self, err) -> None:
        """Deferred-path funnel: the oldest in-flight handle's dispatch (or
        its read-back) failed.  Quarantine the whole lane and re-commit
        EVERY pending run from the mirror through the blocking path (which
        owns retry, backoff and the degrade), storing each handle's results
        for its resolve()."""
        if _obs.enabled:
            _obs.counter("device_recovery.dispatch_faults").inc()
        if self._scrub_mirror is None:
            if self._merkle_forest is not None:
                # Merkle-only mode has no in-process authority to re-commit
                # from: escalate to the durable-state rebuild (checkpoint +
                # WAL replay) instead of leaking the raw device error.
                self._merkle_dirty = True
                raise DeviceStateUnrecoverable(
                    "deferred dispatch failed with no mirror armed "
                    "(merkle mode recovers via checkpoint + WAL replay)"
                ) from err
            raise err
        self._device_fault_streak += 1
        if self._device_fault_streak >= self.device_fault_limit or (
            self._context_lost(err)
        ):
            # Let the re-commits below run on the host engine directly.
            self._degrade_to_host_engine(err)
        self._retry_backoff()
        self._recover_inflight()

    def _context_lost(self, err) -> bool:
        """Whether ``err``, a CUDA error the runtime reported
        (``torch.AcceleratorError``), left the device unusable: a sticky
        error (an illegal address, a trap) fails every later launch, copy
        and allocation in this process, so no re-dispatch can help and the
        funnels hand over to the host engine at once.  One small allocation
        and, on the card, a synchronize tell.  An injected fault and a
        failure of the port's own kernels (``CudaKernelError``) are not
        such errors."""
        if not isinstance(_ACCELERATOR_ERROR, type) or not isinstance(
                err, _ACCELERATOR_ERROR):
            return False
        try:
            torch.zeros(1, device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        except DEVICE_FAULT_TYPES:
            return True
        return False

    def _recover_inflight(self) -> None:
        """Quarantine, rebuild from the mirror, then re-commit every pending
        deferred run's batches in FIFO (== op) order through the guarded
        blocking path.

        On the card this re-dispatch can only help a fault that left the
        CUDA context usable (a failed launch, an injected fault).  A sticky
        error (an illegal address, a trap) poisons the context for the rest
        of the process: every later launch, copy and allocation fails.
        ``_context_lost`` tells such a fault, and the funnel then degrades
        to the host engine, which needs no device, before calling this:
        with the engine in place nothing here touches the device (the
        quarantine re-allocates nothing, the re-commits run on the
        engine)."""
        pending = list(self._inflight_handles)
        self._inflight_handles = []
        self.quarantine(reallocate=self._engine is None)
        try:
            if self._engine is None:
                self._rematerialize_from_mirror()
            for handle in pending:
                if hasattr(handle._result, "result"):
                    try:
                        handle._result.result()  # quiesce the dead future
                    except Exception:  # noqa: BLE001 - quiesced fault
                        pass
                assert handle._batches is not None, (
                    "deferred handle tracked without batch retention")
                handle._recovered = [
                    self._commit_create_transfers(b, ts)
                    for b, ts in zip(handle._batches, handle._timestamps)
                ]
                if handle._stage is not None:
                    self._stage_release(handle._stage)
                    handle._stage = None
        except BaseException:
            # Recovery itself failed (e.g. escalating to the durable-state
            # rebuild): quiesce the handles not yet recovered and release
            # their staging sets, so nothing leaks.
            for handle in pending:
                if handle._recovered is not None:
                    continue
                if hasattr(handle._result, "result"):
                    try:
                        handle._result.result()
                    except Exception:  # noqa: BLE001 - quiesced fault
                        pass
                if handle._stage is not None:
                    self._stage_release(handle._stage)
                    handle._stage = None
            raise
        self.device_recoveries += 1
        if _obs.enabled:
            _obs.counter("device_recovery.recoveries").inc()

    def _scrub_maybe_check(self) -> None:
        if not self.scrub_due or self._inflight_handles:
            return
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
        assert not self._inflight_handles, "scrub requires a settled pipeline"
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
        if self._ledger_is_sharded:
            # Per-shard lanes (n, 3), one read-back; the folds are
            # wrap-adds over disjoint partitions, so their sum is the
            # single-device fold (and a lane names a mismatching shard).
            lanes = self._d2h_u64(self._shard_steps["scrub"](self.ledger))
            if _obs.enabled:
                _obs.counter("sharding.scrub_lane_checks").inc()
            with np.errstate(over="ignore"):
                return lanes.sum(axis=0, dtype=np.uint64)
        return self._d2h_u64(scrub_ops.scrub_digest(self.ledger))

    # -- Merkle commitments (ops/merkle.py) -------------------------------------

    def _merkle_steps(self) -> dict:
        """The sharded Merkle steps of this mesh (cached process-wide)."""
        if self._merkle_steps_cache is None:
            self._merkle_steps_cache = shard_mod.merkle_steps(
                self._shard_mesh)
        return self._merkle_steps_cache

    def _merkle_rebuild(self) -> None:
        """Full forest rebuild from the current ledger (K22), paid at arm
        points and after non-incremental mutations (growth, the sequential
        path, tier moves, recovery).  It subsumes every queued touch."""
        if self._ledger_is_sharded:
            self._merkle_forest = self._merkle_steps()["build"](self.ledger)
        else:
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
        if self._ledger_is_sharded:
            # Per-shard (n, 2, 3) lanes, which also name a shard.
            lanes = self._d2h_u64(self._merkle_steps()["verify"](
                self._merkle_forest, self.ledger))
            ok = bool((lanes[:, 0, :] == lanes[:, 1, :]).all())
        else:
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
        if self._ledger_is_sharded:
            self._merkle_forest = self._merkle_steps()["update_accounts"](
                self._merkle_forest, self.ledger, lo, hi)
        else:
            self._merkle_forest = merkle_ops.update_accounts(
                self._merkle_forest, self.ledger, lo, hi,
                max_probe=sm.MAX_PROBE,
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
        assert self._deferred_inflight == 0, (
            "merkle_settle with the dispatch lane busy: settle barriers run "
            "only at drained points")
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
        if self._ledger_is_sharded:
            step = self._merkle_steps()[
                "update_transfers_pv" if has_pv else "update_transfers"]
            self._merkle_forest = step(
                self._merkle_forest, self.ledger, id_lo, id_hi,
                acc_lo, acc_hi, pend_lo, pend_hi)
        else:
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
        if self._ledger_is_sharded:
            # The wrap-sum fold of the per-shard subtree roots.
            lanes = self._d2h_u64(
                self._merkle_steps()["roots"](self._merkle_forest))
            with np.errstate(over="ignore"):
                triple = lanes.sum(axis=0, dtype=np.uint64)
        else:
            triple = self._d2h_u64(
                merkle_ops.forest_roots(self._merkle_forest))
        return (int(triple[0]), int(triple[1]), int(triple[2]))

    def merkle_canonical_roots(self) -> Optional[Tuple[int, int, int]]:
        """Roots over the canonical single-device layout, recomputed on the
        host from the ledger (what checkpoints serialize and proofs anchor
        to; equal to merkle_roots() on a clean forest)."""
        if self._merkle_forest is None:
            return None
        if self._merkle_pending and self._deferred_inflight == 0:
            self.merkle_settle()
        return merkle_ops.np_ledger_roots(self._query_ledger())

    def commitment_root(self) -> int:
        """The accounts-pad commitment root of the committed state (the
        audit anchor a replica stamps into every reply header), or 0 when
        commitments are not armed or the deferred lane holds records
        (clients skip a 0)."""
        if self._merkle_forest is None or self._engine is not None:
            return 0
        if self._merkle_pending:
            return 0
        self._merkle_rebuild_if_dirty()
        if self._ledger_is_sharded:
            # The canonical root lives in the host tree cache get_proof
            # fills; building it costs an unshard and an O(capacity) hash
            # pass, never paid per reply: 0 (skipped by clients) unless
            # the cache is fresh.
            cached = self._canon_tree
            if (self._canon is None or cached is None
                    or cached[0] is not self._canon
                    or "accounts" not in cached[1]):
                return 0
            return int(cached[1]["accounts"][1])
        return u64(self._merkle_forest.accounts[1].item())

    def _canon_tree_nodes(self, pad_name: str) -> np.ndarray:
        """The cached host heap over the canonical layout of ``pad_name``
        (sharded proofs and ``commitment_root``), invalidated with the
        canonical view itself."""
        canon = self._query_ledger()
        cached = self._canon_tree
        if cached is None or cached[0] is not canon:
            self._canon_tree = cached = (canon, {})
        nodes = cached[1].get(pad_name)
        if nodes is None:
            nodes = merkle_ops.np_tree(
                merkle_ops.np_table_leaves(getattr(canon, pad_name),
                                           pad_name))
            cached[1][pad_name] = nodes
        return nodes

    def _canon_proof_path(self, lo: np.uint64, hi: np.uint64,
                          pad_name: str = "accounts"):
        """A proof path from the cached host tree over the canonical layout
        of ``pad_name`` (sharded: the live per-shard subtrees commit to the
        sharded layout; proofs and checkpoints anchor to the canonical
        one).  (slot, siblings, root), or None when the key is absent."""
        nodes = self._canon_tree_nodes(pad_name)
        table = getattr(self._query_ledger(), pad_name)
        cap = len(nodes) // 2
        key_lo = convert.tensor_to_array(table.key_lo)
        key_hi = convert.tensor_to_array(table.key_hi)
        tomb = convert.tensor_to_array(table.tombstone)
        slot = int(mix64_np(np.asarray([lo]), np.asarray([hi]))[0]) & (cap - 1)
        probes = 0
        while not (key_lo[slot] == lo and key_hi[slot] == hi):
            if key_lo[slot] == 0 and key_hi[slot] == 0 and not bool(
                    tomb[slot]):
                return None  # absent from the canonical pad
            slot = (slot + 1) & (cap - 1)
            probes += 1
            if probes > cap:
                return None
        idx = cap + slot
        siblings = np.empty(max(0, cap.bit_length() - 1), np.uint64)
        for level in range(len(siblings)):
            siblings[level] = nodes[idx ^ 1]
            idx >>= 1
        return slot, siblings, int(nodes[1])

    def get_proof(self, ident: int, kind: str = "accounts") -> Optional[bytes]:
        """Root-anchored Merkle inclusion proof of one row, verifiable with
        ``ops.merkle.check_proof``: ``accounts`` (the account row),
        ``transfers`` (a hot transfer row; an evicted one has no leaf) or
        ``posted`` (the fulfillment of pending transfer ``ident``, keyed by
        its timestamp).  None when the row does not exist in the pad or
        Merkle mode is off."""
        if self._merkle_forest is None or self._engine is not None:
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
        if self._ledger_is_sharded:
            path = self._canon_proof_path(lo, hi, kind)
            if path is None:
                return None
            slot, siblings, root = path
            table = getattr(self._query_ledger(), kind)
        else:
            table = getattr(self.ledger, kind)
            k_lo, k_hi = self._id_tensors(np.array([lo], np.uint64),
                                          np.array([hi], np.uint64), 8)
            look = ht.lookup(table, k_lo, k_hi, sm.MAX_PROBE)
            if not bool(look.found[0]):
                return None
            slot = int(look.slot[0])
            levels = max(0, table.capacity.bit_length() - 1)
            _leaf, sib_dev, root_dev = merkle_ops.gather_path(
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

    def quarantine(self, reallocate: bool = True) -> None:
        """Quarantine the device pipeline: drain the dispatch lane (joining
        any running closure, then waiting on the host for its stream) and
        drop every cached device buffer, which a failed or corrupted
        dispatch chain makes suspect: the staging sets, the grouped
        commit's graph, the lane index vector and the Bloom filter's device
        copy (the last two made anew unless ``reallocate`` is False).  With
        ``reallocate=False`` (the degrade to the host engine) nothing here
        touches the device, which a sticky CUDA error has made unusable."""
        fut, self._lane_tail = self._lane_tail, None
        if fut is not None:
            concurrent.futures.wait([fut])
        lane, self._lane = self._lane, None
        if lane is not None:
            lane.shutdown(wait=True)
        self._lane_drain()
        self._stage_pool.clear()
        self._group_graph = None
        if not reallocate:
            return
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
        if self._shard_mesh is not None:
            self.ledger = shard_mod.make_sharded_ledger(
                self._shard_mesh, cfg.accounts_capacity,
                cfg.transfers_capacity, cfg.posted_capacity,
                history_capacity=cfg.history_capacity,
            )
            self._ledger_is_sharded = True
            self._shard_insert_bounds = {
                "accounts": np.zeros(self.shards, np.int64),
                "transfers": np.zeros(self.shards, np.int64),
            }
        else:
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
        """After ``device_fault_limit`` consecutive dispatch failures, or a
        CUDA error that left the context unusable (``_context_lost``): stop
        trusting the device and serve from the native host engine over a
        ledger built from the mirror (a RuntimeWarning, not a wedge).
        Nothing here touches the device.

        A failure of the port's own kernels (``CudaKernelError``: a launch,
        a graph capture or replay) never degrades: it is a fault of the
        port, not of the card, and moving the work to the CPU would hide
        it.  It raises here, past the funnels."""
        from .host_engine import HostEngine, engine_available

        if isinstance(err, _cuda.CudaKernelError):
            raise err
        model = self._scrub_mirror
        if model is None or self._scrub_suspect:
            raise DeviceStateUnrecoverable(
                "device failing and mirror unavailable") from err
        if self._tiering or self.cold.count or (
            self.hot_transfers_capacity_max is not None
        ):
            raise DeviceStateUnrecoverable(
                "device failing under tiering: host engine cannot take over"
            ) from err
        if not engine_available():
            raise DeviceStateUnrecoverable(
                "device failing and the native host engine is unavailable"
            ) from err
        self.quarantine(reallocate=False)
        self._host_led = scrub_ops.build_host_ledger(model, self.config)
        self._engine = HostEngine(self._host_led, self.config.max_probe)
        self._resync_host_state_from_mirror(model)
        self._index_stale = True
        self._device_stale = True
        self._ledger = None  # made anew for queries and checkpoints
        self._ledger_is_sharded = False  # ... in the single-device layout
        self.scrub_disarm()  # the host ledger is the authority now
        self.degraded_to_host_engine = True
        if _obs.enabled:
            _obs.counter("device_recovery.degraded").inc()
        warnings.warn(
            f"device dispatch failed {self.device_fault_limit} consecutive "
            f"times ({err!r}); degraded to the native host engine "
            "(device path disabled for this process)",
            RuntimeWarning,
            stacklevel=3,
        )

    # -- host-engine mode (host_engine.py) ---------------------------------------

    def _engine_grow(
        self, accounts: int = 0, transfers: int = 0, posted: int = 0,
        history: int = 0,
    ) -> None:
        """Load-factor management of the host tables (``_grow_if_needed``'s
        policy on the same host-side bounds)."""
        led = self._host_led
        for which, need in (
            ("accounts", self._accounts_bound + accounts),
            ("transfers", self._transfers_bound + transfers),
            ("posted", self._posted_bound + posted),
        ):
            cap = self._target_capacity(getattr(led, which).capacity, need)
            if cap != getattr(led, which).capacity:
                self._engine.grow(which, cap)
        if history and self._history_bound + history > led.history_capacity:
            led.grow_history(self._history_bound + history)

    def _engine_commit(
        self, operation: str, batch: np.ndarray, timestamp: int
    ) -> List[Tuple[int, int]]:
        count = len(batch)
        if count == 0:
            return []
        # Invalidate the derived views BEFORE the commit: a partial
        # application must not leave queries serving the old device ledger.
        self._device_stale = True
        self._index_stale = True
        if operation == "create_accounts":
            if bool((batch["flags"] & types.AccountFlags.HISTORY).any()):
                self._history_accounts_possible = True
            if bool((batch["flags"] & _LIMIT_FLAGS).any()):
                self._limit_accounts_possible = True
            self._engine_grow(accounts=count)
            codes = self._engine.create_accounts(batch, timestamp)
            self._accounts_bound += count
        else:
            pv_count, hist_count = self._transfer_growth_counts(batch)
            self._engine_grow(
                transfers=count, posted=pv_count, history=hist_count)
            codes = self._engine.create_transfers(batch, timestamp)
            self._transfers_bound += count
            self._posted_bound += pv_count
            self._history_bound += hist_count
        results = self._compress(codes, count)
        self._update_commit_timestamp(codes, count, timestamp)
        return results

    def _index_fresh(self) -> None:
        """Engine commits bypass the per-batch index append: reset the
        derived indexes (the next query rebuilds them from the refreshed
        ledger)."""
        if self._engine is not None and self._index_stale:
            self.index.reset()
            self.scans_transfers.reset()
            self.scans_accounts.reset()
            self._index_stale = False

    # -- warmup and the capture tripwire ------------------------------------------

    def warmup(self) -> None:
        """Run every serving commit kernel once on zero-count batches
        (results discarded, state untouched) so the first request pays no
        first-use cost: on the card the kernel library loads and the
        grouped commit's graph is captured here.  Under TB_SANITIZE the end
        of warmup arms the capture tripwire.  In host-engine mode it
        pre-faults the numpy tables instead."""
        try:
            self._warmup_impl()
        finally:
            self._sanitize_arm_tripwire()

    def _warmup_impl(self) -> None:
        if self._engine is not None:
            self._host_led.prefault()
            return
        if self._ledger_is_sharded:
            # The sharded commit steps (accounts, fast, the probed twin the
            # deferred and grouped commits dispatch, the general step for
            # the current waves setting) on zero-count batches.
            steps = self._shard_steps
            soa_a = self._pad_soa(np.zeros(0, dtype=types.ACCOUNT_DTYPE))
            self.ledger, codes_a = steps["accounts"](self.ledger, soa_a, 0, 1)
            soa_t = self._pad_soa(np.zeros(0, dtype=types.TRANSFER_DTYPE))
            self.ledger, codes_f = steps["fast"](self.ledger, soa_t, 0, 1)
            reads = [codes_a, codes_f]
            if self.pipeline_depth > 1 or self.group_device_commit:
                r = steps["fast_probed"](self.ledger, soa_t, 0, 1)
                reads.append(r[1])
            r = steps["full_waves" if self.waves_enabled else "full"](
                self.ledger, soa_t, 0, 1)
            self.ledger = r[0]
            reads.append(r[1])
            torch.cat([c.reshape(-1) for c in reads]).cpu()
            return
        soa_a = self._pad_soa(np.zeros(0, dtype=types.ACCOUNT_DTYPE))
        self.ledger, codes_a = sm.create_accounts(self.ledger, soa_a, 0, 1)
        soa_t = self._pad_soa(np.zeros(0, dtype=types.TRANSFER_DTYPE))
        cold_checked = self._cold_certified(False) if self._tiering else None
        # Both serving variants of the general kernel for the current
        # history flag (dispatch selects has_postvoid per batch).
        reads = [codes_a]
        for has_postvoid in (False, True):
            r = tf.create_transfers_full_impl(
                self.ledger, soa_t, 0, 1, self._bloom_dev, cold_checked,
                max_passes=self.config.jacobi_max_passes,
                has_postvoid=has_postvoid,
                has_history=self._history_accounts_possible,
                use_waves=self.waves_enabled,
            )
            self.ledger = r[0]
            reads.append(r[1])
        if self._fast_path_ok(np.zeros(0, dtype=types.TRANSFER_DTYPE)):
            self.ledger, codes_f = sm.create_transfers_fast(
                self.ledger, soa_t, 0, 1)
            reads.append(codes_f)
            if self.group_device_commit and self.device.type == "cuda":
                # Capture the grouped commit's graph now, not mid-run.
                self._group_graph_for(self.ledger)
        torch.cat([c.reshape(-1) for c in reads]).cpu()

    def _sanitize_arm_tripwire(self) -> None:
        """TB_SANITIZE: baseline the capture count at a legitimate capture
        point (the end of warmup)."""
        if not self._sanitize:
            return
        self._sanitize_capture_base = group_mod.CAPTURES
        self._sanitize_grace = False

    def _sanitize_capture_check(self, where: str) -> None:
        cur = group_mod.CAPTURES
        if self._sanitize_grace:
            # First read-back after a growth: its capture is a new layout.
            self._sanitize_grace = False
            self._sanitize_capture_base = cur
            return
        delta = cur - self._sanitize_capture_base
        if delta > 0:
            self._sanitize_capture_base = cur
            _san.capture_trip(where, delta, strict_ok=not (
                self._scrub_mirror is not None
                or self._merkle_forest is not None))

    # -- persistence (vsr/checkpoint.py) ------------------------------------------

    def checkpoint_ledger(self) -> sm.Ledger:
        """The ledger snapshot checkpoints serialize: the canonical
        single-device layout, so a checkpoint restores into any shard
        count."""
        return self._query_ledger()

    def host_state(self) -> dict:
        """Host-tracked state that must survive restarts (checkpointed
        beside the device ledger)."""
        return {
            "prepare_timestamp": self.prepare_timestamp,
            "commit_timestamp": self.commit_timestamp,
            "accounts_bound": self._accounts_bound,
            "transfers_bound": self._transfers_bound,
            "posted_bound": self._posted_bound,
            "history_bound": self._history_bound,
            "history_accounts_possible": self._history_accounts_possible,
            "limit_accounts_possible": self._limit_accounts_possible,
            "balance_bound": min(self._balance_bound, _BOUND_CLAMP),
            "cold_manifest": self.cold.manifest(),
            "bloom_log2": self._bloom_log2,
        }

    def restore_host_state(self, state: dict) -> None:
        self.prepare_timestamp = int(state["prepare_timestamp"])
        self.commit_timestamp = int(state["commit_timestamp"])
        # Floor the bounds at the live counts, so checkpoints that predate
        # bound tracking still grow correctly (one read-back at restart).
        led = self.ledger
        # Sharded tables count per shard: the sums.
        counts = convert.tensor_to_array(torch.stack([
            led.accounts.count.sum(), led.transfers.count.sum(),
            led.posted.count.sum(), led.history.count]))
        self._accounts_bound = max(int(state.get("accounts_bound", 0)),
                                   int(counts[0]))
        self._transfers_bound = max(int(state.get("transfers_bound", 0)),
                                    int(counts[1]))
        self._posted_bound = max(int(state.get("posted_bound", 0)),
                                 int(counts[2]))
        self._history_bound = max(int(state.get("history_bound", 0)),
                                  int(counts[3]))
        self._history_accounts_possible = bool(
            state.get("history_accounts_possible", True))
        # Absent fields (older checkpoints) default to "fast path off".
        self._limit_accounts_possible = bool(
            state.get("limit_accounts_possible", True))
        self._balance_bound = int(state.get("balance_bound", _BOUND_CLAMP))
        manifest = state.get("cold_manifest", [])
        if manifest:
            self._tiering = True
            self.cold.load_manifest(manifest)
            self._bloom_log2 = int(state.get("bloom_log2", self._bloom_log2))
            self._bloom_np = self.cold.rebuild_bloom(self._bloom_log2)
            self._bloom_dev = convert.bloom_to_tensor(self._bloom_np,
                                                      self.device)
        elif self.cold.runs:
            # Restored to a pre-eviction checkpoint: drop stale in-memory
            # cold state (the files stay; older checkpoints may name them).
            self.cold.clear()
            self._bloom_np = np.zeros(((1 << self._bloom_log2) // 32,),
                                      np.uint32)
            self._bloom_dev = convert.bloom_to_tensor(self._bloom_np,
                                                      self.device)
        # The ledger was just swapped: the derived indexes rebuild on use.
        self.index.reset()
        self.scans_transfers.reset()
        self.scans_accounts.reset()
        self._index_stale = False
        if self.scrub_armed:
            # The caller verified the new ledger's digest: reseed the mirror
            # and/or rebuild the forest from it.
            self.scrub_arm()


def _unique_pairs(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """``np.unique(np.stack([hi, lo], axis=1), axis=0)``: the distinct (hi,
    lo) rows in the same sorted order, by a lexsort (the axis form sorts a
    structured view, about 18 ms for 16,380 rows)."""
    order = np.lexsort((lo, hi))
    hi, lo = hi[order], lo[order]
    first = np.ones(len(hi), dtype=bool)
    first[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    return np.stack([hi[first], lo[first]], axis=1)

