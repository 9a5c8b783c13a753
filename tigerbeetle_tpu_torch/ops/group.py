"""The grouped device commit (port of ``tigerbeetle_tpu/machine.py:78``
``_group_fast_dispatch_impl``): ``GROUP_K`` stacked fast-path
create_transfers batches committed in order, padding batches of count 0
applying nothing, with the stacked codes, the transfers table's probe
overflow widened into a fresh word of the run, and the stacked id columns.

Two forms:

- ``group_dispatch_steps``, a Python loop of the fast path's
  ``_create_transfers`` over the stacked batches with host ints.  On CPU
  tensors it is the plain version (the tests and the card's comparison use
  it); on CUDA tensors it is the eager form, GROUP_K launches of K1-K4 each.
- ``GroupGraph``, the card's form: one ``torch.cuda.CUDAGraph`` per
  (GROUP_K, lanes, the ledger's table buffers) holding GROUP_K steps of K24
  (``group_step``) and K1-K4 (``lookup_many``, ``validate`` and ``insert``
  with preallocated outputs and scratch; ``balance``, one launch of atomics,
  needs none, so nothing the graph holds grows with the accounts capacity
  for K4), K1 and K3 reading the
  step's count and timestamp from the run's u64[GROUP_K] device words, then
  K25 (``group_finish``).  A run costs one host-to-device copy of
  the staging set into the graph's input buffer, one replay and one
  device-to-host copy at resolve.  The graph bakes every pointer: the ledger
  must keep its buffers (the fast path updates them in place) and a growth,
  which reallocates a table, makes a new graph (``GroupGraph.key``).

The staging set (``StagingLayout``) packs the run into one byte buffer: the
counts, the timestamps, then every transfer column as [GROUP_K, lanes]
(u64 columns as int64, u16/u32 ones widened to int32, as ``types.to_soa``).

A failed capture or replay raises ``CudaKernelError``; nothing falls back to
the eager form or the plain loop.  ``CAPTURES`` counts captures (the
machine's post-warmup tripwire reads it).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import types
from . import _cuda
from . import hash_table as ht
from . import state_machine as sm

GROUP_K = 32

# Captures made in this process (read by the machine's sanitize tripwire).
CAPTURES = 0


def _field_dtypes() -> List[Tuple[str, torch.dtype]]:
    out = []
    for name in types.TRANSFER_DTYPE.names:
        dt = types.TRANSFER_DTYPE.fields[name][0]
        out.append((name, torch.int64 if dt == np.uint64 else torch.int32))
    return out


FIELDS = _field_dtypes()
_NP = {torch.int64: np.uint64, torch.int32: np.uint32}


class StagingLayout:
    """Byte offsets of one staging set: counts u64[k], timestamps u64[k],
    then each transfer column [k, lanes] (8-byte aligned: k * lanes is
    even)."""

    def __init__(self, k: int, lanes: int) -> None:
        if (k * lanes) % 2:
            raise ValueError("k * lanes must be even")
        self.k, self.lanes = k, lanes
        self.regions = [("counts", 0, k, torch.int64),
                        ("timestamps", 8 * k, k, torch.int64)]
        off = 16 * k
        for name, dt in FIELDS:
            self.regions.append((name, off, k * lanes, dt))
            off += k * lanes * (8 if dt == torch.int64 else 4)
        self.nbytes = off

    def _views(self, buf, view):
        out = {name: view(buf[off:off + n * (8 if dt == torch.int64 else 4)],
                          dt)
               for name, off, n, dt in self.regions}
        counts, tss = out.pop("counts"), out.pop("timestamps")
        return ({name: col.reshape(self.k, self.lanes)
                 for name, col in out.items()}, counts, tss)

    def tensors(self, buf: torch.Tensor):
        """(stacked columns {name: [k, lanes]}, counts int64[k], timestamps
        int64[k]) as views of the uint8 tensor ``buf``."""
        return self._views(buf, lambda b, dt: b.view(dt))

    def arrays(self, buf: np.ndarray):
        """The same views of a host uint8 array, as u64/u32 numpy arrays."""
        return self._views(buf, lambda b, dt: b.view(_NP[dt]))


def group_dispatch_steps(ledger: sm.Ledger, stacked: Dict[str, torch.Tensor],
                         counts: Sequence[int], timestamps: Sequence[int]):
    """The plain version (CPU tensors) and the eager form (CUDA tensors):
    ``_create_transfers`` once per stacked batch, with host ints.  Returns
    (ledger, codes int32[k, lanes], overflow int32[1], id_lo, id_hi)."""
    codes = []
    for j in range(len(counts)):
        soa = {name: col[j] for name, col in stacked.items()}
        ledger, c = sm._create_transfers(ledger, soa, int(counts[j]),
                                         int(timestamps[j]))
        codes.append(c)
    return (ledger, torch.stack(codes),
            ledger.transfers.probe_overflow.to(torch.int32).reshape(1),
            stacked["id_lo"], stacked["id_hi"])


def group_step_plain(counts: torch.Tensor, timestamps: torch.Tensor, j: int,
                     flags: torch.Tensor, table_overflow: torch.Tensor,
                     run_overflow: torch.Tensor):
    """Plain PyTorch version of kernel K24's step ``j``: (valid bool[n],
    ts int64[n], pending bool[n], the run's overflow word int32[1])."""
    n = flags.shape[0]
    cnt, bts = counts[j], timestamps[j]
    lane = torch.arange(n, dtype=torch.int64, device=flags.device)
    valid = lane < cnt  # counts fit in int64: at most the lanes
    ts = bts - cnt + lane + 1  # wrapping u64 arithmetic on the bits
    pending = (flags & sm.TF_PENDING) != 0
    prev = run_overflow if j else torch.zeros_like(run_overflow)
    return valid, ts, pending, prev | table_overflow.to(torch.int32).reshape(1)


def group_finish_plain(table_overflow: torch.Tensor,
                       run_overflow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel K25: the run's word int32[1] with
    the table's probe_overflow ORed in."""
    return run_overflow | table_overflow.to(torch.int32).reshape(1)


def group_words_plain(base: torch.Tensor, count: int, ts0: int, k: int):
    """Plain PyTorch version of kernel K26: (the advanced base word, batch
    indexes, counts, timestamps), each int64 (wrapping u64 arithmetic on the
    bits): batch ``base + j``, count ``count`` and timestamp ``ts0 + (base +
    j + 1) * count`` for the k steps of a replay."""
    b = base.reshape(1) + torch.arange(k, dtype=torch.int64,
                                       device=base.device)
    counts = torch.full((k,), count, dtype=torch.int64, device=base.device)
    return base + k, b, counts, ts0 + (b + 1) * count


def ledger_key(ledger: sm.Ledger) -> tuple:
    """The buffers a graph bakes: every tensor of the accounts and
    transfers tables, by address (the graph keeps them alive, so an address
    match is the same buffer)."""
    out = []
    for t in (ledger.accounts, ledger.transfers):
        out += [t.key_lo.data_ptr(), t.key_hi.data_ptr(),
                t.tombstone.data_ptr(), t.count.data_ptr(),
                t.probe_overflow.data_ptr(), t.capacity]
        out += [c.data_ptr() for c in t.cols.values()]
    return tuple(out)


class FastSteps:
    """Preallocated outputs and scratch of the fast path's steps with the
    count and timestamp in device words, and the step itself."""

    def __init__(self, ledger: sm.Ledger, k: int, lanes: int, device) -> None:
        self.k, self.lanes = k, lanes
        xfr_cap = ledger.transfers.capacity

        def z(n, dt=torch.int64):
            return torch.zeros(n, dtype=dt, device=device)

        self.valid, self.ts, self.pending = z(lanes, torch.bool), z(lanes), \
            z(lanes, torch.bool)
        self.dr_found, self.dr_slot = z(lanes, torch.bool), z(lanes)
        self.cr_found, self.cr_slot = z(lanes, torch.bool), z(lanes)
        self.dr_ledger, self.cr_ledger = z(lanes, torch.int32), \
            z(lanes, torch.int32)
        self.ex_found, self.ex_slot = z(lanes, torch.bool), z(lanes)
        xcols = ledger.transfers.cols
        self.ex = {c: z(lanes, xcols[c].dtype) for c in sm.TRANSFER_EXISTS_COLS}
        self.ok = z(lanes, torch.bool)
        self.codes = z((k, lanes), torch.int32)
        self.vscratch = z(2 * _cuda.hash_size(lanes) + 3 * lanes, torch.int32)
        self.iscratch = _cuda.insert_scratch(lanes, xfr_cap, device)
        self.run_ovf = z(1, torch.int32)

    def step(self, ledger: sm.Ledger, j: int, soa: Dict[str, torch.Tensor],
             counts: torch.Tensor, timestamps: torch.Tensor) -> None:
        """Step ``j``: K24, K1 (the three probes in one launch), K3, K4
        and K2, the count and timestamp read from ``counts[j]`` and
        ``timestamps[j]``; the codes land in ``self.codes[j]``."""
        acc, xfr = ledger.accounts, ledger.transfers
        cw, tw = counts[j:j + 1], timestamps[j:j + 1]
        _cuda.group_step(counts, timestamps, j, soa["flags"], self.valid,
                         self.ts, self.pending, xfr.probe_overflow,
                         self.run_ovf)
        lanes = self.lanes
        ht.lookup_many([
            ht.Lookup(acc, soa["debit_account_id_lo"],
                      soa["debit_account_id_hi"], ("ledger",), count=lanes,
                      count_word=cw,
                      out=(self.dr_found, self.dr_slot, [self.dr_ledger])),
            ht.Lookup(acc, soa["credit_account_id_lo"],
                      soa["credit_account_id_hi"], ("ledger",), count=lanes,
                      count_word=cw,
                      out=(self.cr_found, self.cr_slot, [self.cr_ledger])),
            ht.Lookup(xfr, soa["id_lo"], soa["id_hi"], sm.TRANSFER_EXISTS_COLS,
                      count=lanes, count_word=cw,
                      out=(self.ex_found, self.ex_slot,
                           [self.ex[c] for c in sm.TRANSFER_EXISTS_COLS])),
        ], sm.MAX_PROBE, overflow=False)
        ctx = {"dr_found": self.dr_found, "cr_found": self.cr_found,
               "dr_ledger": self.dr_ledger, "cr_ledger": self.cr_ledger,
               "ex_found": self.ex_found}
        cols = ([soa[c] for c in sm.TRANSFER_BATCH_COLS]
                + [ctx[c] for c in sm.TRANSFER_CTX_COLS]
                + [self.ex[c] for c in sm.TRANSFER_EXISTS_COLS])
        _cuda.validate("transfers", cols, 0, count_word=cw, ts_word=tw,
                       out=(self.codes[j], self.ok, self.vscratch))
        _cuda.balance(self.dr_slot, self.cr_slot, self.ok, soa["amount_lo"],
                      self.pending, [acc.cols[c] for c in sm.BALANCE_COLS])
        rows = {name: soa[name] for name in sm.TRANSFER_COLS}
        rows["timestamp"] = self.ts
        _cuda.insert(xfr.key_lo, xfr.key_hi, xfr.tombstone, xfr.cols,
                     xfr.count, xfr.probe_overflow, soa["id_lo"],
                     soa["id_hi"], self.ok, rows, sm.MAX_PROBE, 0,
                     scratch=self.iscratch)


class CapturedGraph:
    """A ``torch.cuda.CUDAGraph`` of the launch sequence ``record`` makes,
    captured on a side stream after ``warm`` (an eager pass that applies
    nothing), with the launches it holds per kernel: the wrappers' counts
    grow by those at every replay (a capture records launches, it does not
    make them)."""

    def __init__(self, record, warm, device) -> None:
        global CAPTURES
        self.graph = torch.cuda.CUDAGraph()
        self.nodes: Dict[str, int] = {}
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            # ``warm``: one eager pass of the sequence that applies nothing;
            # it loads every kernel's module before the capture, where a
            # lazy load may not run.  Its launches count: they are made.
            warm()
        torch.cuda.current_stream(device).wait_stream(stream)
        before = _cuda.counts()
        try:
            with torch.cuda.graph(self.graph, stream=stream,
                                  capture_error_mode="thread_local"):
                record()
        except _cuda.CudaKernelError:
            raise
        except RuntimeError as err:
            raise _cuda.CudaKernelError(f"CUDA graph capture failed: {err}") \
                from err
        finally:
            after = _cuda.counts()
            for name, k in _cuda.KERNELS.items():
                k.launches = before[name]
        self.nodes = {n: after[n] - before[n] for n in after
                      if after[n] != before[n]}
        CAPTURES += 1

    def replay(self) -> None:
        try:
            self.graph.replay()
        except RuntimeError as err:
            raise _cuda.CudaKernelError(f"CUDA graph replay failed: {err}") \
                from err
        for name, n in self.nodes.items():
            _cuda.KERNELS[name].launches += n


class GroupGraph:
    """The grouped commit's graph for one ledger layout: ``stage`` is its
    input buffer (a ``StagingLayout``), ``run`` commits the staged run."""

    def __init__(self, ledger: sm.Ledger, k: int, lanes: int) -> None:
        device = ledger.device
        self.key = (k, lanes) + ledger_key(ledger)
        self.layout = StagingLayout(k, lanes)
        self.stage = torch.zeros(self.layout.nbytes, dtype=torch.uint8,
                                 device=device)
        self.stacked, self.counts, self.timestamps = \
            self.layout.tensors(self.stage)
        self.steps = FastSteps(ledger, k, lanes, device)
        # The graph bakes these tensors' addresses: keep them alive.
        self._ledger = sm.Ledger(ledger.accounts, ledger.transfers,
                                 ledger.posted, ledger.history)
        self.captured = CapturedGraph(self._record, self._warm, device)

    def _warm(self) -> None:
        self.counts.zero_()  # every step a padding step: applies nothing
        self._record()

    def _record(self) -> None:
        for j in range(self.layout.k):
            soa = {name: col[j] for name, col in self.stacked.items()}
            self.steps.step(self._ledger, j, soa, self.counts,
                            self.timestamps)
        _cuda.group_finish(self._ledger.transfers.probe_overflow,
                           self.steps.run_ovf)

    def run(self, host_stage: torch.Tensor):
        """Copy the staged run in (``host_stage``: the uint8 staging set,
        pinned), replay, and return (codes int32[k, lanes], overflow
        int32[1]) in buffers of the run's own, plus the stacked id columns
        (valid until the next run)."""
        self.stage.copy_(host_stage, non_blocking=True)
        self.captured.replay()
        _cuda.KERNELS["group_dispatch"].launches += 1
        return (self.steps.codes.clone(), self.steps.run_ovf.clone(),
                self.stacked["id_lo"], self.stacked["id_hi"])
