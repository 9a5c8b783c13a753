"""The flagship benchmark's timed core on the port: create_transfers
throughput with the batches made on the device.

    python -m tigerbeetle_tpu_torch.bench [--two-phase | --limits]
        [--transfers N] [--accounts N] [--count N] [--lanes N]
        [--skip-parity] [--device cuda|cpu]

The twin of ``bench.py``'s timed core, and only of that core: the defaults
of ``bench.py:1826-1829`` (10,000 accounts, 10,000,000 transfers, 8,190
events a batch, 8,192 lanes), the same account creation and ``--limits``
funding (``bench.py:2063-2125``), tables sized up front as ``:2056-2057``
(``tr_cap = 2^ceil(log2(2 * total))``), ``ts0`` as ``:2127``, and the same
timed loop (``:2256-2299``): a warm-up dispatch of ``k = n_batches // 20``
batches, then ``disp - 1`` dispatches of ``k`` batches, each a host loop of
kernel K20 (``utils.benchgen.gen_batch``, the batch from its index, on the
card) and the commit (``state_machine.create_transfers_fast``, or
``transfer_full.create_transfers_full_impl`` for ``--two-phase`` and
``--limits``), with the failure word accumulated on the card (a flagged
general-kernel batch adds ``1 << 32``) and one synchronize per dispatch, as
``block_until_ready`` does.  On the card a plain-shape dispatch is one
replay of a captured CUDA graph of its ``k`` batches, as ``bench.py``'s
``multi`` is one ``fori_loop`` dispatch (``bench.py:2245-2254``): K26 sets
the batch indexes and timestamps from a device word, then per batch K20
reads its batch index from a device word and the fast path's kernels read
the count and timestamp from device words (``ops/group.py``); the graphs
are captured before the timed loop.  On the card the timed loop runs under
``torch.cuda.set_sync_debug_mode("error")``: any hidden host read raises.
After the timing: failures 0, no probe overflow, debits equal credits, and
(unless ``--skip-parity``) the parity check of ``run_parity_check``
(``bench.py:122``) against ``testing.model.ReferenceStateMachine``.

Prints ONE JSON line: ``metric`` (bench.py's three names), ``value``,
``unit`` ("tx/s"), ``per_batch_us``, the three-rep split ``rep_tx_s``,
``device`` (nvidia-smi's name and power limit) and ``device_idle_share``
from a card-only ``torch.profiler`` window over the last batches of the
warm-up dispatch, outside the timed loop (null on the CPU, where there is
no card to measure).

Left out, with the slices that bring them: bench.py's end-to-end client,
tracer, kernel-profile and harness-contention extras (ROADMAP A12).  The
two-phase and limits shapes stay eager: the general kernel reads its count
and timestamp as host ints and routes on its flags word.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import convert, types
from .device import resolve as resolve_device
from .ops import _cuda
from .ops import group
from .ops import state_machine as sm
from .ops import transfer_full as tf
from .utils import benchgen

METRICS = {
    "plain": "create_transfers_throughput",
    "two_phase": "two_phase_transfers_throughput",
    "limits": "limit_transfers_throughput",
}
FIRST_TID = 1 << 32
PROFILE_BATCHES = 20


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m tigerbeetle_tpu_torch.bench",
        description=__doc__.split("\n")[0])
    p.add_argument("--transfers", type=int, default=10_000_000)
    p.add_argument("--accounts", type=int, default=10_000)
    p.add_argument("--count", type=int, default=8190)
    p.add_argument("--lanes", type=int, default=8192)
    p.add_argument("--skip-parity", action="store_true")
    p.add_argument("--two-phase", action="store_true",
                   help="each batch is half pending creates and half posts "
                        "of those pendings (the general kernel)")
    p.add_argument("--limits", action="store_true",
                   help="every account carries debits_must_not_exceed_"
                        "credits, pre-funded (the general kernel)")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (the plain versions)")
    args = p.parse_args(argv)
    if args.count > args.lanes:
        p.error(f"--count {args.count} exceeds --lanes {args.lanes}")
    if args.two_phase:
        args.count -= args.count % 2  # pendings and posts pair up exactly
    if plan(args.transfers, args.count)[0] < 3:
        p.error("--transfers too small: need >= 3 batches")
    return args


def plan(n_transfers: int, count: int) -> Tuple[int, int, int]:
    """(n_batches, k, timed): bench.py's batch plan.  The warm-up dispatch
    commits batches [0, k), the timed dispatches [k, k + timed)."""
    n_batches = (n_transfers + count - 1) // count
    disp = 20 if n_batches >= 40 else 2
    k = max(1, n_batches // disp)
    return n_batches, k, (n_batches - k) // k * k


def _log2_ceil(x: int) -> int:
    return max(0, (x - 1).bit_length())


def device_name(device: torch.device) -> str:
    """nvidia-smi's name and power limit of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=60, check=True)
    return out.stdout.decode().strip().splitlines()[0]


def run_parity_check(device, n_accounts: int = 64, batches: int = 3,
                     count: int = 200) -> bool:
    """The port's machine against the scalar oracle on the benchmark's
    generator, small scale (bench.py:122 run_parity_check)."""
    from .config import LedgerConfig
    from .machine import TorchStateMachine
    from .testing import model as M

    cfg = LedgerConfig(
        accounts_capacity_log2=10, transfers_capacity_log2=11,
        posted_capacity_log2=10,
    )
    dev = TorchStateMachine(cfg, batch_lanes=256, device=device)
    ref = M.ReferenceStateMachine()
    accounts = types.accounts_array(
        [types.account(id=i + 1, ledger=1, code=10) for i in range(n_accounts)]
    )
    got = dev.create_accounts(accounts, wall_clock_ns=1)
    want = ref.create_accounts([M.account_from_row(r) for r in accounts], 1)
    assert got == want, "account parity failure"
    for b in range(batches):
        batch = benchgen.gen_batch_np(b, count, count, n_accounts, FIRST_TID)
        got = dev.create_transfers(batch)
        want = ref.create_transfers([M.transfer_from_row(r) for r in batch])
        assert got == want, f"parity failure batch {b}: {got[:5]} vs {want[:5]}"
    assert dev.balances_snapshot() == ref.balances_snapshot(), \
        "balance parity failure"
    return True


def _sum_fails(codes: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    return ((codes != 0) & active).sum()


def setup(args, device) -> Tuple[sm.Ledger, torch.Tensor, torch.Tensor, dict]:
    """The ledger sized up front, with the accounts created (and funded
    under ``--limits``); the failure words stay on the device."""
    n_accounts, lanes, count = args.accounts, args.lanes, args.count
    n_batches = plan(args.transfers, count)[0]
    total = n_batches * count
    acc_cap = 1 << _log2_ceil(n_accounts * 2)
    tr_cap = 1 << _log2_ceil(total * 2)
    posted_cap = (tr_cap // 2) if args.two_phase else (1 << 10)
    ledger = sm.make_ledger(acc_cap, tr_cap, posted_cap, device=device)
    lane = torch.arange(lanes, device=device)
    acc_fails = torch.zeros((), dtype=torch.int64, device=device)
    n_create = n_accounts + 1 if args.limits else n_accounts
    created = 0
    while created < n_create:
        n = min(count, n_create - created)
        batch = np.zeros(lanes, dtype=types.ACCOUNT_DTYPE)
        batch["id_lo"][:n] = 1 + created + np.arange(n, dtype=np.uint64)
        batch["ledger"][:n] = 1
        batch["code"][:n] = 10
        if args.limits:
            lim = types.AccountFlags.DEBITS_MUST_NOT_EXCEED_CREDITS
            batch["flags"][:n] = np.where(
                batch["id_lo"][:n] <= n_accounts, np.uint16(lim), np.uint16(0))
        soa = convert.batch_to_tensors(batch, lanes, device)
        ledger, codes = sm.create_accounts(ledger, soa, n, created + n)
        acc_fails += _sum_fails(codes, lane < n)
        created += n
    fund_fails = torch.zeros((), dtype=torch.int64, device=device)
    if args.limits:
        # Credit each limit account 2^40 from the funder (credits never trip
        # a debit limit), through the general kernel.
        funded = 0
        while funded < n_accounts:
            n = min(count, n_accounts - funded)
            batch = np.zeros(lanes, dtype=types.TRANSFER_DTYPE)
            batch["id_lo"][:n] = (1 << 31) + funded + np.arange(n, dtype=np.uint64)
            batch["debit_account_id_lo"][:n] = n_accounts + 1
            batch["credit_account_id_lo"][:n] = (
                1 + funded + np.arange(n, dtype=np.uint64))
            batch["amount_lo"][:n] = 1 << 40
            batch["ledger"][:n] = 1
            batch["code"][:n] = 10
            soa = convert.batch_to_tensors(batch, lanes, device)
            ledger, codes, kflags = tf.create_transfers_full_impl(
                ledger, soa, n, n_create + funded + n)
            fund_fails += _sum_fails(codes, lane < n) + torch.where(
                kflags != 0, 1 << 32, 0)
            funded += n
    sizes = {"accounts_capacity": acc_cap, "transfers_capacity": tr_cap,
             "posted_capacity": posted_cap}
    return ledger, acc_fails, fund_fails, sizes


class _Loop:
    """The timed loop's step: K20 into a reused SoA, then the commit; the
    failures accumulate into a device word."""

    def __init__(self, args, ledger: sm.Ledger, device) -> None:
        self.args = args
        self.ledger = ledger
        self.full = args.two_phase or args.limits
        self.ts0 = (2 * args.accounts + 1) if args.limits else args.accounts
        self.soa = benchgen.empty_soa(args.lanes, device)
        self.active = torch.arange(args.lanes, device=device) < args.count
        self.fails = torch.zeros((), dtype=torch.int64, device=device)
        # The plain shape on the card: one captured graph per dispatch
        # length, sharing the device word of the next batch index.
        self.graphs: Dict[int, "_DispatchGraph"] = {}
        self.base = torch.zeros(1, dtype=torch.int64, device=device)
        self.next_b: Optional[int] = None

    def step(self, b: int) -> None:
        a = self.args
        benchgen.gen_batch(b, a.lanes, a.count, a.accounts, FIRST_TID,
                           a.two_phase, out=self.soa)
        ts = self.ts0 + (b + 1) * a.count
        if self.full:
            self.ledger, codes, kflags = tf.create_transfers_full_impl(
                self.ledger, self.soa, a.count, ts)
            self.fails += _sum_fails(codes, self.active) + torch.where(
                kflags != 0, 1 << 32, 0)
        else:
            self.ledger, codes = sm.create_transfers_fast(
                self.ledger, self.soa, a.count, ts)
            self.fails += _sum_fails(codes, self.active)

    def graphed(self) -> bool:
        return self.soa["id_lo"].is_cuda and not self.full

    def prepare(self, k: int) -> None:
        """Capture the graph of a ``k``-batch dispatch (outside any timed
        or sync-checked region: a capture synchronizes the card)."""
        if self.graphed() and k > 0 and k not in self.graphs:
            self.graphs[k] = _DispatchGraph(self, k)

    def multi(self, b0: int, k: int) -> None:
        if not self.graphed():
            for b in range(b0, b0 + k):
                self.step(b)
            return
        if k == 0:
            return
        self.prepare(k)
        if b0 != self.next_b:
            self.base.fill_(b0)
        self.graphs[k].captured.replay()
        self.next_b = b0 + k


class _DispatchGraph:
    """A plain-shape dispatch of ``k`` batches as one CUDA graph: K26
    (batch ``base + j``, count, timestamp ``ts0 + (base + j + 1) * count``;
    ``base`` then advances by ``k``), and per batch K20 from its device
    word, the fast path's steps with device words and the failure word's
    update."""

    def __init__(self, loop: _Loop, k: int) -> None:
        a = loop.args
        dev = loop.soa["id_lo"].device
        self.loop, self.k = loop, k
        self.steps = group.FastSteps(loop.ledger, k, a.lanes, dev)
        z = lambda: torch.zeros(k, dtype=torch.int64, device=dev)  # noqa: E731
        self.bidx, self.counts, self.tss = z(), z(), z()
        self.captured = group.CapturedGraph(self._record, self._warm, dev)

    def _record(self, live: bool = True) -> None:
        loop, a = self.loop, self.loop.args
        if live:
            _cuda.group_words(loop.base, a.count, loop.ts0, self.bidx,
                              self.counts, self.tss)
        cols = [loop.soa[c] for c in benchgen.GEN_COLS]
        for j in range(self.k):
            _cuda.bench_gen(cols, benchgen.MODE_PLAIN, 0, a.count,
                            a.accounts, FIRST_TID, b_word=self.bidx[j:j + 1])
            self.steps.step(loop.ledger, j, loop.soa, self.counts, self.tss)
            if live:
                loop.fails += _sum_fails(self.steps.codes[j], loop.active)

    def _warm(self) -> None:
        """One eager pass that applies nothing (counts 0, words entry on
        scratch words), loading every kernel before the capture."""
        self.counts.zero_()
        self._record(live=False)
        scratch = torch.zeros_like(self.loop.base)
        _cuda.group_words(scratch, 0, 0, self.bidx, self.counts, self.tss)
        self.counts.zero_()


def _barrier(device, strict: bool) -> None:
    """One synchronize per dispatch; under the strict sync mode the mode is
    lifted for this explicit wait alone."""
    if device.type != "cuda":
        return
    if strict:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(device)
    if strict:
        torch.cuda.set_sync_debug_mode("error")


def _u128_total(ledger: sm.Ledger, field: str) -> int:
    a = ledger.accounts
    live = (convert.tensor_to_array(a.key_lo) != 0) | (
        convert.tensor_to_array(a.key_hi) != 0)
    lo = convert.tensor_to_array(a.cols[field + "_lo"])[live]
    hi = convert.tensor_to_array(a.cols[field + "_hi"])[live]
    return int(sum(int(x) for x in lo)) + (int(sum(int(x) for x in hi)) << 64)


def run(args) -> Tuple[Dict, sm.Ledger]:
    """Set up, warm up, time, check; returns (the JSON payload, the final
    ledger)."""
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    shape = ("two_phase" if args.two_phase
             else "limits" if args.limits else "plain")
    n_batches, k, timed = plan(args.transfers, args.count)
    t_setup = time.perf_counter()
    ledger, acc_fails, fund_fails, sizes = setup(args, device)
    loop = _Loop(args, ledger, device)
    _barrier(device, False)
    setup_s = time.perf_counter() - t_setup

    # Warm-up dispatch: batches [0, k); its last batches run under a
    # card-only profiler for the device's idle share.
    t0 = time.perf_counter()
    window = min(PROFILE_BATCHES, k)
    loop.multi(0, k - window)
    _barrier(device, False)
    idle_share = busy_ms = window_ms = None
    if cuda:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tw = time.perf_counter()
            loop.multi(k - window, window)
            torch.cuda.synchronize(device)
            window_ms = (time.perf_counter() - tw) * 1e3
        busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA) / 1e3
        idle_share = 1 - busy_ms / window_ms if busy_ms > 0 else None
    else:
        loop.multi(k - window, window)
    warmup_s = time.perf_counter() - t0
    # The failure word keeps its buffer (a captured graph adds into it).
    fails_warmup = loop.fails.clone()
    loop.fails.zero_()
    loop.prepare(k)

    dispatch_s = []
    if cuda:
        torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        for b0 in range(k, k + timed, k):
            td = time.perf_counter()
            loop.multi(b0, k)
            _barrier(device, cuda)
            dispatch_s.append(time.perf_counter() - td)
        elapsed = time.perf_counter() - t0
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(0)

    rep_tx_s = None
    if len(dispatch_s) >= 3:
        seg = len(dispatch_s) // 3
        rep_tx_s = [seg * k * args.count / sum(dispatch_s[r * seg:(r + 1) * seg])
                    for r in range(3)]

    ledger = loop.ledger
    total_fails = int(loop.fails.item()) + int(fails_warmup.item())
    assert total_fails == 0, (
        f"transfer failures: {total_fails & 0xFFFFFFFF} codes, "
        f"{total_fails >> 32} flagged batches")
    assert int(acc_fails.item()) == 0, "account creation failures"
    ff = int(fund_fails.item())
    assert ff == 0, (f"limits funding: {ff & 0xFFFFFFFF} code failures, "
                     f"{ff >> 32} flagged batches")
    assert not bool(ledger.transfers.probe_overflow.item())
    dpo = _u128_total(ledger, "debits_posted")
    cpo = _u128_total(ledger, "credits_posted")
    assert dpo == cpo and dpo > 0, f"conservation failure: {dpo} != {cpo}"
    dp = _u128_total(ledger, "debits_pending")
    cp = _u128_total(ledger, "credits_pending")
    assert dp == cp, f"pending conservation failure: {dp} != {cp}"
    parity = None
    if not args.skip_parity:
        parity = run_parity_check(device)

    tx_s = timed * args.count / elapsed
    payload = {
        "metric": METRICS[shape],
        "value": tx_s,
        "unit": "tx/s",
        "per_batch_us": elapsed / timed * 1e6,
        "rep_tx_s": rep_tx_s,
        "device": device_name(device),
        "device_idle_share": idle_share,
        "profile_window": {"batches": window, "wall_ms": window_ms,
                           "device_busy_ms": busy_ms},
        "accounts": args.accounts, "count": args.count, "lanes": args.lanes,
        "batches": k + timed, "batches_per_dispatch": k,
        "timed_batches": timed, "timed_s": elapsed,
        "setup_s": setup_s, "warmup_s": warmup_s,
        "sync_debug_mode": "error" if cuda else None,
        "parity": parity, **sizes,
    }
    return payload, ledger


def main(argv: Optional[List[str]] = None) -> int:
    payload, _ledger = run(parse_args(argv))
    print(json.dumps(payload), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
