"""Chip smoke test of the PyTorch/CUDA port (``tigerbeetle_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device   - requires CUDA; prints the card's name and power limit;
  2. build    - builds the CUDA kernels from csrc/ (nvcc, sm_90a);
  3. kernels  - each kernel K1-K5 against its plain PyTorch version on the
                same CUDA tensors at main-path shapes: outputs must be
                byte-identical; times both; K3's phases clocked
                (tools/phase_clock.py, built beside the kernels) and its
                accounts variant timed, the parent's times (PERF.md) beside; K4 also on carry-heavy balances
                (a few units below 2^64), with every leg on one debit and
                one credit account, and in its slot-base form over 2, 4 and
                8 shards, and timed again on an accounts table of 2^21;
                K2's insert and claim entries checked byte for byte and
                timed at an adversarial shape (2^20 slots at load 0.45,
                same-home groups), at the main path's shape (a 2^25-slot
                table holding the main run's earlier batches, its next
                batches; the claim and write entries apart) and at
                full_twophase's (its transfers claim, then its posted
                claim into 2^24 slots), each with the protocol's rounds
                and deepest lane; K2's round form (more than 8,192 lanes)
                at its callers' full shapes, byte for byte against the
                plain insert and rebuild: ``grow`` 2^24 -> 2^25 slots at
                load 0.5 and ``drop_evicted`` at 2^23, the claim (its
                phases clocked), the writes and the call timed beside
                their bounds and the parent's times (PERF.md); K1 as the
                main path's batch launches it
                (its three lookups in one launch, and the graph's form with
                preallocated outputs and a device count word) on that
                2^25-slot table and the 2^16-slot accounts table, beside
                its adversarial shape, with its phases clocked;
  4. parity   - TorchStateMachine on the card against the scalar oracle
                (testing/model.py) on small seeded batches;
  5. main     - the main path at full size: 10,000 accounts, then 10,000,000
                plain transfers in 8,190-event batches (the flagship
                bench.py defaults), balances against a closed form, and the
                digest against its plain version; each table growth timed
                apart (a synchronise on each side) with the allocator's
                reserved bytes around it.  K1-K5's launch counts are read
                from this phase;
  6. seq_kernels - K6 seq_transfers (K32 seq_prepass, then the sequencer),
                K32 alone, K7 seq_accounts and K8 tombstone against their
                plain versions on the same inputs, byte for byte: tables
                that hold rows, same-home clusters and tombstones (made on
                the card through K2 and K8, whose launches there are K8's
                count), batches of 2,048 lanes of the testing/seqmix.py
                event mix; K32 and K6 on testing/seqtraps.py's three cases
                at 8,190 events (ids re-used after rollbacks in clusters
                the batch filled, pushed placements, pendings made and
                posted in the batch with colliding posted keys, the probe
                cap) against the split plain form; K7 on
                testing/k7cases.py's traps (new distinct ids at 16,384
                lanes among them) against its split plain form; then K7,
                K32 and K6 at the sequential path's shapes (8,190 accounts,
                two-phase batches), where they are timed and bounded (K6's
                sequencer alone and with K32; K7's phases clocked).  The
                plain K6/K7/K32 run on CPU copies (a Python loop over the
                events; K7's split form in numpy); plain K8 on the card;
  7. seq_parity - a force_sequential TorchStateMachine on the card against
                the scalar oracle at full width (8,190 events per batch),
                and one of 16,384 lanes (K6 runs the lanes up to the
                count);
  8. sequential - the sequential path at full width: a force_sequential
                machine, 10,000 accounts, then bench.py's --two-phase shape
                (4,095 pendings and 4,095 posts of them per batch) for
                ``--seq-transfers`` transfers (2,000,000: cut from
                bench.py's 10,000,000 to keep the script near ten minutes);
                K6/K7/K32's launch counts are read from this phase;
  9. full_kernels - the general kernel: K9 full_index, K10 full_legs, K12
                full_waves against their plain versions on the card, byte
                for byte, and create_transfers_full_impl (K1, K2's claim and
                write entries, K9-K12) against its plain composition at pass
                budgets 1, 2, 3 and 8, waves on and off: codes, kflags, the
                wave vector and every ledger array, on 8,190-event batches of
                the testing/fullmix.py mix and each FLAG_SEQ kind, on a ledger
                with rows, same-home clusters and tombstones, and on
                testing/fulltraps.py's batches (each batch-wide step of
                K11 and K12 across their blocks; one of 8,150 lanes), and
                K9 on testing/k9cases.py's traps at 8,190 and 8,192 lanes;
                then each kernel timed and bounded on a bench.py two-phase
                batch: K9 with its launch and phases clocked
                (tools/phase_clock.py), K12 with and without its rounds,
                the whole core by CUDA events beside K11's profile (its
                events against the launches made), and K11's history
                append;
 10. full_parity - a default machine (general kernel), a force_sequential
                machine (K6) and the scalar oracle on the same 8,190-event
                batches of the mix: codes, balances, history rows, lookups,
                digest; both routes must be taken;
 11. full_twophase - bench.py's --two-phase shape through a default machine:
                10,000 accounts, ``--full-transfers`` transfers (10,000,000);
                every batch commits on the general kernel with kflags 0, K6
                never launches; K9-K12 and K2's entries' launches are read
                from this phase;
 12. full_limits - bench.py's --limits shape: 10,000 limit-flagged accounts
                and a funder, 10,000 funding transfers, then the flagship
                plain generator for ``--full-transfers`` transfers, all on
                the general kernel.
                Phases 5, 8, 11 and 12 build their machines with
                ``LedgerConfig(lazy_index=True)``, as bench.py's device runs
                do: no index maintenance, so their rates compare with the
                earlier slices' runs;
 13. index_kernels - K13 run_sort, K14 run_merge, K15 index_window and K16
                history_scan against their plain versions on the card, byte
                for byte on every output (invalid lanes included): build_runs
                with none, some and all lanes ok, stable ties, a full build
                of 2^20 entries, carries into levels 1-6, windows and unions
                in both directions with the four side combinations over
                levels that are only sentinels, both K15 modes on
                testing/k15cases.py's traps, a history log with fewer and
                more matches than k and a rolled-back tail, and a 2^21-slot
                log (K16's block-count scan over more than 1,024 blocks);
                K13 and K14 timed at the main path's shapes, K13's one-launch
                batch sort (one cluster a side: the launch's cluster, shared
                memory and the clusters the card holds) beside its
                chunks-and-K14-rounds form and one side of 1,024; K13's
                phases clocked (tools/phase_clock.py) and the parent's time
                (PERF.md) beside it; K14 at full size, byte for byte against
                the plain sort and timed beside its bounds and the parent's
                times (PERF.md): a rebuild's rounds and tail over 2^25
                entries (10,000,000 live), the carries into levels 6 and 10;
 14. queries_parity - small, on the card: a default machine (the index
                appended on the fast, general and sequential routes) against
                the scalar oracle and a lazy_index machine: every filter
                flag combination, the invalid filters, limits 1, 7 and
                8,190, timestamp windows, scan_transfers/scan_accounts/
                query_*_where with union, intersection and difference;
 15. queries  - at full width: (a) the flagship generator on a default
                machine (index maintained on every commit) for
                ``--query-transfers`` transfers (10,000,000), 100
                get_account_transfers at limit 8,190 (debits, credits,
                both, reversed), a full rebuild and the same queries again;
                (b) the same transfers on HISTORY accounts (the general
                path, a history row each), then 100 get_account_history.
                Every answer against a numpy selection over the table or
                log on the host.  At this size, on the card, byte for byte
                against the plain versions: the deepest carried level and
                the rebuilt level (K13, K14), K15 over the whole pyramid and
                K16 over the whole log, invalid lanes included; K15/K16
                timed here (K16's one launch a query in both directions,
                the parent's times (PERF.md) beside; K15 also on an account
                with no rows, with its
                valid rows, the windows that hold them, its launch and its
                phases clocked), and K1 and K13-K16's launch counts read from
                this phase, with the entries K14's counted launches merge
                (its bound over the path's carries);
 16. cold_kernels - K17 bloom_check, K18 evict_threshold, K19 evict_extract
                and drop_evicted's K2 rebuild against their plain versions on
                the card, byte for byte: filters of 2^20 and 2^28 bits (each
                lane's hit, and the masked form with its FLAG_COLD word),
                tables of 2^8, 2^23 and 2^25 slots with tombstones at
                fractions 0.001-0.999, empty tables and the C-1 clamp; each
                timed at the tiered path's shapes.  K17 as a step of K1's
                launch (its flag word) at the tiered general path's shape
                (``tier_shape``: 10,000,000 accounts, a 2^23 hot table at
                the eviction point, a 2^28-bit filter of 20,000,000 evicted
                ids): the word under every mask, with and without post/void
                lanes, and every lookup's outputs against the plain form;
                K1 with and without the step, ``build_gather_ctx`` (its
                runtime calls) and K17's own launch in both forms timed,
                warm and after an L2 flush, the parents' times (PERF.md)
                beside;
 17. tiered   - the cold tier at full width (BASELINE.json config 4, cut in
                depth): a tiered machine (hot ceiling 2^23 slots, in-memory
                runs) and an untiered twin, 10,000,000 accounts each, then
                ``--tier-transfers`` (24,000,000) transfers of the flagship
                generator with pendings every 8th batch, cold pendings
                posted or voided after each eviction and 256 evicted ids
                resubmitted per batch (codes 46 and 39).  Every code equal
                to the twin's; the accounts tables, lookups across the tiers
                and 100 get_account_transfers equal; at least one merge of
                the cold runs.  K17-K19's launch counts read from here;
                K17's are the K1 launches that carried its step (its own
                kernel is never launched on this path: checked).
 18. flagship - K20 bench_gen against its plain version on the card, byte
                for byte (plain, two-phase and the tools' two-phase shape,
                batch indexes where b * count + lane passes 2^32) and
                against bench.py's numpy mirrors; then the bench twin
                (``tigerbeetle_tpu_torch.bench.run``, what ``python -m
                tigerbeetle_tpu_torch.bench`` calls) at bench.py's defaults
                (``--bench-transfers``, 10,000,000) in its three shapes, each
                printing its JSON line, the timed loops under
                ``torch.cuda.set_sync_debug_mode("error")``; after the plain
                shape every account's balances equal the main phase's after
                the same batches.  K20's and K26's launches read from the
                plain shape;
 19. scrub_kernels - K21 scrub_fold against its plain version and K5, K22
                merkle_build (heap and root-only) and K23 merkle_touch
                (touch and gather_path) against their plain versions on the
                card, byte for byte, on pads of 2^8, 2^15 and 2^25 slots with
                tombstones, duplicate touches and post/void lanes whose
                pendings are found and not found; a Merkle-armed machine's
                forest after 20 touched flagship batches equal to a fresh
                K22 build;
 20. commitments - Merkle on at scrub interval 1, paranoid (the host mirror
                kept), through the setters, on the flagship at 10,000
                accounts beside a Merkle-only machine and an unarmed twin:
                roots equal a fresh K22 build every ``ROOT_CHECK_EVERY``
                batches and at the end, 100 account and 100 transfer proofs
                verify, one SDC flip detected and recovered (digest equal to
                the twin's), one injected device fault recovered (codes
                equal).  Cut to ``--commit-transfers`` (250,000) and a root
                check every 20 batches (printed): the mirror is a Python
                oracle.  K21-K23 timed here, and their launches read here.
 21. pipeline_kernels - the commit pipeline's kernels (``ops/group.py``):
                K24 ``group_step`` and K25 ``group_finish`` against their
                plain versions, K1-K4 in the forms the graph launches (K1
                and K3 reading the count and timestamp from device words
                into preallocated outputs, K4 and K2 on preallocated
                scratch) against their host-int forms, K26 ``group_words``
                and K20 reading its batch index from a device word against
                their plain versions at the bench twin's shapes (8,192
                lanes, its k), and one replay of the grouped commit's CUDA
                graph (``group_dispatch``: GROUP_K = 32 steps) against 32
                eager steps on the card and the plain loop on CPU copies,
                byte for byte (codes [32, 8192], every table array, the
                run's overflow word) on the phase-kernels ledger, for runs
                of 1, 2, 17 and 32 batches; a zero-count run leaves the
                ledger byte-identical.  K24-K26, the forms and a replay
                timed;
 22. pipeline - the commit pipeline at full width (``--pipeline-transfers``,
                10,000,000 flagship transfers at 10,000 accounts, lazy index,
                the transfers table sized up front): (a) runs of 32 through
                ``commit_group_fast(deferred=True)`` at depth 2, (b)
                ``commit_fast_deferred`` batch by batch, (c) a mirror-armed
                machine with an injected fault recovered through
                ``_recover_inflight``, then ``device_fault_limit`` faults
                degrading to the host engine, which commits the rest.  Every
                code as the blocking path's, digest and balances equal phase
                main's; the submits under the sync debug mode "error"; the
                device idle share from CUDA events around each lane
                closure.  The pipeline kernels' launches are read from (a);
 23. persistence - the commitments phase's Merkle-only machine (250,000
                transfers) through ``checkpoint_ledger``, ``host_state``,
                ``vsr.checkpoint.save`` and ``load`` into a fresh machine on
                the card: digest, roots, commitment root, lookups and host
                state equal; the save and load walls printed.
 24. vopr_kernels - the batched VOPR's kernels (``sim/vopr_tpu.py``)
                against their plain versions on CUDA tensors, byte for
                byte: K27 ``vopr_draw`` on 4,096 keys (R 3 and 5, S 8 and
                32, p_sdc 0 and 0.3), K28 ``vopr_step`` on 1,024 clusters x
                50 steps for the clean model and each of the nine bugs, K29
                ``vopr_run``'s flags and final states at 512 x 200 for the
                clean HARSH model and each bug, K29 runs ending inside,
                at and past its chunks of 32 drawn steps (0, 1, 31, 33 and
                65 steps at R=3 S=32 and R=6 S=256), and a K29 run past
                ``VOPR_SHARED_MAX_OPS`` (the canonical lists in device
                memory); then each at its path's shape (K27 on 4,096
                keys, K28 on 4,096 clusters at max_ops 402, K29's flags and
                final states on a batch of 8,192 x 200 under HARSH_FAULTS)
                byte for byte against its plain version, and timed beside
                it (the plain versions with CUDA events around their calls)
                and beside its bound; K29's registers, local memory and
                resident warps a SM (``_cuda.vopr_run_info``);
 25. vopr     - at the sources' sizes: (a) cli.py's ``vopr --tpu`` default
                (4,096 clusters x 400 steps, clean) through ``run_sharded``:
                0 violations; (b) tools/vopr_scale.py's run through the twin
                ``sim.vopr_scale`` (batches of 8,192 x 200 under
                HARSH_FAULTS, >= 100,000 schedules): 0 violations, the
                schedules per minute and the wall of each batch; (c) each
                bug at tests/test_vopr.py's shapes (256 x 300, seed 1):
                caught, each count the JAX package's
                (``VOPR_BUG_VIOLATIONS``); (d) 4,096 clusters x 20,000
                steps, clean, the canonical lists in device memory: 0
                violations; (e) the step-locked route (``draw_faults`` then
                ``step``, K27 then K28, each step) at (a)'s shape, whose
                last step's faults and state equal the plain versions' on
                the same inputs and whose final state equals K29's.  K29's
                launches are read from (b), K27's and K28's from (e).
 26. shard_kernels - K30 ``shard_gather`` and K31 ``shard_combine``
                (``parallel/sharded.py``), and the slot-base forms of K4 and
                K10's apply launch, against their plain versions on the card,
                byte for byte: 8,190 lanes of the flagship mix (debit and
                credit accounts, ids half stored), the main phase's tables
                (accounts 2^16, transfers 2^25 holding 10,000,000 rows) over
                2, 4 and 8 shards, with and without the overflow words, a
                lane mask, the partials starting as garbage but for the
                overflow words; then each timed at 8 shards (K31 beside
                ``partial.sum(0)`` and ``torch.stack(partials).sum(0)``;
                K30's bound the function's bytes, not the partial's);
 27. sharded  - bench.py's shard-sweep mix (``run_shard_sweep``: plain
                batches, every fourth pair a pending batch and the batch
                posting it) at the flagship's width (10,000 accounts, 8,190
                events a batch, ``--sharded-transfers`` 2,000,000) through a
                single-device machine and ``TorchStateMachine(shards=s)`` for
                s = 2 and 8 over ``device.force_virtual(8, "cuda")``, Merkle
                on, every machine from the default capacities, growing: every
                batch's codes equal, then every table's rows
                (sorted by key: where keys collided each machine's slots
                follow its own insertion order, as in the JAX package), the
                digest, the folded scrub lanes, and the maintained per-shard
                Merkle roots against a fresh build; a
                grouped and deferred 4-shard run (1,000,000 transfers) with
                the blocking path's codes; a 2 -> 4 split while serving the
                same batches (one after every migration step until the
                cutover, at least two catch-up rounds), cut over to the
                4-shard machine's state.  The launch counts are reset and
                read around each of the four runs; K30's and K31's row takes
                the 8-shard run's.
Then a ``{"kernels": [...]}`` line (K1-K32, K2's claim and write entries
and the grouped commit's replay), and as
the last line ``{"ok": true, "device": {...}}``.  Any mismatch or exception exits non-zero
before the last line is printed.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_OPS_PER_S = 67e12  # the slowest CUDA-core rate the data sheet lists (FP32)
# INT32 on the CUDA cores: 132 SMs x 64 INT32 lanes x 1.98 GHz (the VOPR's
# kernels are integer work).
H100_INT32_OPS_PER_S = 132 * 64 * 1.98e9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def phase_clock():
    """tools/phase_clock.py: the clocked kernels' phases by %globaltimer,
    from a build of their sources with TB_PHASE_CLOCK."""
    import importlib.util

    if "phase_clock" not in sys.modules:
        path = Path(__file__).resolve().parent / "tools" / "phase_clock.py"
        spec = importlib.util.spec_from_file_location("phase_clock", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules["phase_clock"] = mod
    return sys.modules["phase_clock"]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=60, check=True,
    )
    return out.stdout.decode().strip().splitlines()[0]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


# torch.cuda._sleep spins the card for a number of SM clock cycles; at
# most 1.98 GHz, so a spin of ``ms * SPIN_CYCLES_PER_MS`` lasts ms or more.
SPIN_CYCLES_PER_MS = 1_980_000


def timed(fn, reps=20, warmup=2, setup=None) -> dict:
    """Per call of ``fn(*setup())``: ``device_ms``, the device time of all
    that the call puts on the card (kernels, fills, copies), and
    ``call_ms``, from CUDA events around each call, which also counts the
    host's launch work while the card waits.  ``setup`` runs outside both.

    ``device_ms`` comes from CUDA events around ``reps`` calls queued
    behind a GPU spin: the host queues every call while the card spins, so
    the calls run back to back and the events time the card alone.  A call
    that waits on the card (a read-back) cannot be queued; its
    ``device_ms`` comes from torch.profiler, which can record only part of
    a window's kernels (more often late in a long process) and so read
    short, and the result says so with the events it recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn(*(setup() if setup else ()))
    torch.cuda.synchronize()
    call = host = 0.0
    for _ in range(reps):
        args = setup() if setup else ()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn(*args)
        end.record()
        host += time.perf_counter() - t0
        end.synchronize()
        call += start.elapsed_time(end)
    # Three times the host's queuing time; a host loop of more than a tenth
    # of a second is not a launcher's and is not spun for.
    spin_ms = 1.0 + 3e3 * host
    if spin_ms <= 300:
        inputs = [setup() if setup else () for _ in range(reps)]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
        start.record()
        for args in inputs:
            fn(*args)
        end.record()
        queued = not start.query()  # the spin outlasted the queuing
        end.synchronize()
        if queued:
            return {"device_ms": start.elapsed_time(end) / reps,
                    "call_ms": call / reps,
                    "device_ms_from": "cuda events, calls queued behind a spin"}
    # The profiler now and then hands back no device events for a short
    # window of tiny launches; such a window is taken again, longer.  If it
    # still records nothing, the device time is taken with CUDA events
    # around the launches (which also count the gaps between them), and
    # the result says so.
    for n in (reps, 5 * reps, 5 * reps):
        inputs = [setup() if setup else () for _ in range(n)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for args in inputs:
                fn(*args)
            torch.cuda.synchronize()
        calls = {}
        busy = device_us(prof, None, calls)
        if busy > 0:
            return {"device_ms": busy / 1e3 / n, "call_ms": call / reps,
                    "device_ms_from": f"profiler ({sum(calls.values())} "
                                      f"device events recorded, {n} calls)"}
    inputs = [setup() if setup else () for _ in range(reps)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for args in inputs:
        fn(*args)
    end.record()
    end.synchronize()
    return {"device_ms": start.elapsed_time(end) / reps, "call_ms": call / reps,
            "device_ms_from": "cuda events (the profiler recorded nothing)"}


def device_us(prof, by_name=None, calls=None) -> float:
    """Device time in a profile: the events that ran on the card only (a
    CPU op's device time repeats its kernels').  ``by_name`` gets each
    event's time and ``calls`` its count."""
    from torch.autograd import DeviceType

    total = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            total += e.self_device_time_total
            if by_name is not None:
                by_name[e.key[:60]] = e.self_device_time_total
            if calls is not None:
                calls[e.key[:60]] = e.count
    return total


def to_np(t):
    from tigerbeetle_tpu_torch import convert

    return convert.tensor_to_array(t)


def max_abs_err(name: str, a: dict, b: dict) -> int:
    """0 when every array pair is byte-identical; raises otherwise (after
    computing the largest absolute difference for the message)."""
    worst = 0
    bad = []
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.shape != y.shape or x.dtype != y.dtype:
            bad.append(f"{k}: {x.shape}/{x.dtype} vs {y.shape}/{y.dtype}")
            continue
        diff = np.flatnonzero(x.reshape(-1) != y.reshape(-1))
        if len(diff):
            xs = x.reshape(-1)[diff].astype(object)
            ys = y.reshape(-1)[diff].astype(object)
            worst = max(worst, max(abs(int(p) - int(q)) for p, q in zip(xs, ys)))
            bad.append(f"{k}: {len(diff)} elements differ, first at {diff[0]}")
    if bad:
        raise AssertionError(f"{name}: kernel != plain: {bad} (max abs err {worst})")
    return worst


def max_abs_err_card(name: str, a: dict, b: dict) -> int:
    """``max_abs_err`` of tensors compared where they lie (on the card at
    full size); they are copied to the host only when they differ, for the
    message."""
    import torch

    for k in a:
        x, y = a[k], b[k]
        if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(x, y):
            return max_abs_err(name, {c: to_np(v) for c, v in a.items()},
                               {c: to_np(v) for c, v in b.items()})
    return 0


def table_np(t) -> dict:
    out = {"key_lo": to_np(t.key_lo), "key_hi": to_np(t.key_hi),
           "tombstone": to_np(t.tombstone), "count": to_np(t.count),
           "probe_overflow": to_np(t.probe_overflow)}
    out.update({"col:" + k: to_np(v) for k, v in t.cols.items()})
    return out


def clone_table(t):
    from tigerbeetle_tpu_torch.ops import hash_table as ht

    return ht.Table(t.key_lo.clone(), t.key_hi.clone(), t.tombstone.clone(),
                    {k: v.clone() for k, v in t.cols.items()}, t.count.clone(),
                    t.probe_overflow.clone())


def rand_u64(rng, n, hi=1 << 64):
    return rng.integers(0, hi, size=n, dtype=np.uint64)


def t64(a, dev):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).to(dev)


def t32(a, dev):
    import torch

    return torch.from_numpy(
        np.ascontiguousarray(a).astype(np.uint32).view(np.int32)).to(dev)


def home_np(lo, hi, cap):
    from tigerbeetle_tpu_torch.utils.benchgen import mix64_np

    with np.errstate(over="ignore"):
        x = lo ^ (hi * np.uint64(0x9E3779B97F4A7C15))
    return mix64_np(x, 0) & np.uint64(cap - 1)


def probe_steps(table_np_, lo, hi, cap, max_probe) -> int:
    """Slots the probe of these keys visits (the data-dependent work)."""
    klo, khi, tomb = table_np_["key_lo"], table_np_["key_hi"], table_np_["tombstone"]
    home = home_np(lo, hi, cap).astype(np.int64)
    done = (lo == 0) & (hi == 0)
    steps = 0
    for i in range(max_probe):
        if done.all():
            break
        cur = (home + i) & (cap - 1)
        steps += int((~done).sum())
        a, b, tb = klo[cur], khi[cur], tomb[cur]
        done = done | (~tb & (((a == lo) & (b == hi)) | ((a == 0) & (b == 0))))
    return steps


class uncounted:
    """Launches made while a kernel is timed against its plain version do
    not count toward the launches of the path being run (``depth`` > 0
    while one is open)."""

    depth = 0

    def __enter__(self):
        from tigerbeetle_tpu_torch.ops import _cuda

        self.saved = _cuda.counts()
        self.in_probe = _cuda.BLOOM_IN_PROBE
        uncounted.depth += 1

    def __exit__(self, *exc):
        from tigerbeetle_tpu_torch.ops import _cuda

        uncounted.depth -= 1
        for name, n in self.saved.items():
            _cuda.KERNELS[name].launches = n
        _cuda.BLOOM_IN_PROBE = self.in_probe


def loop_ms(fn, n=50) -> float:
    """CUDA events around ``n`` back-to-back calls, per call: the kernel's
    time when it outlasts the host's launch work, else the launch rate."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def pair_times(kernel: dict, plain: dict) -> dict:
    return {"ms": kernel["device_ms"], "plain_ms": plain["device_ms"],
            "call_ms": kernel["call_ms"], "plain_call_ms": plain["call_ms"],
            "ms_from": kernel["device_ms_from"],
            "plain_ms_from": plain["device_ms_from"]}


def bound(bytes_, ops, ops_per_s=H100_OPS_PER_S):
    b_ms = bytes_ / H100_BYTES_PER_S * 1e3
    o_ms = ops / ops_per_s * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

LANES = 8192
COUNT = 8190
PROFILE_BATCHES = 20
N_ACCOUNTS = 10_000


def make_accounts_table(rng, dev):
    """Accounts table of 2^16 with 10,000 accounts (ids 1..10,000) carrying
    random balances below 2^100, some on ledger 2."""
    import torch
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import state_machine as sm

    cap = 1 << 16
    t = ht.make_table(cap, sm.ACCOUNT_COLS, dev)
    ids = np.arange(1, N_ACCOUNTS + 1, dtype=np.uint64)
    rows = {}
    for k, dt in sm.ACCOUNT_COLS.items():
        if dt == torch.int64:
            hi = 1 << 36 if k.endswith("_hi") else 1 << 64
            rows[k] = t64(rand_u64(rng, N_ACCOUNTS, hi), dev)
        else:
            rows[k] = t32(rng.integers(0, 4, N_ACCOUNTS), dev)
    rows["ledger"] = t32(np.where(rng.random(N_ACCOUNTS) < 0.03, 2, 1), dev)
    mask = torch.ones(N_ACCOUNTS, dtype=torch.bool, device=dev)
    zeros = torch.zeros(N_ACCOUNTS, dtype=torch.int64, device=dev)
    ht.insert_plain(t, t64(ids, dev), zeros, mask, rows, 1 << 16)
    return t


def same_home_groups(rng, cap, groups, size, base):
    """``groups`` x ``size`` distinct keys (lo, hi=0) sharing a home slot per
    group, all above ``base``."""
    cand = base + np.arange(1, 1 << 22, dtype=np.uint64)
    homes = home_np(cand, np.zeros_like(cand), cap)
    order = np.argsort(homes, kind="stable")
    h = homes[order]
    starts = np.flatnonzero(np.r_[True, h[1:] != h[:-1]])
    sizes = np.diff(np.r_[starts, len(h)])
    pick = starts[sizes >= size]
    pick = rng.choice(pick, size=groups, replace=False)
    return np.concatenate([cand[order[s:s + size]] for s in pick])


def make_transfers_table(rng, dev):
    """Transfers table of 2^20 pre-filled to load 0.45 with random rows,
    same-home clusters and a few tombstones.  Returns (table, prefilled ids)."""
    import torch
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import state_machine as sm

    cap = 1 << 20
    n = int(cap * 0.45)
    t = ht.make_table(cap, sm.TRANSFER_COLS, dev)
    clusters = same_home_groups(rng, cap, 64, 6, 1 << 40)
    ids = np.unique(np.concatenate([
        rng.integers(1 << 41, 1 << 62, size=n - len(clusters), dtype=np.uint64),
        clusters,
    ]))
    rng.shuffle(ids)
    hi = np.where(rng.random(len(ids)) < 0.1, rng.integers(1, 5, len(ids)), 0)
    hi = hi.astype(np.uint64)
    rows = {}
    for k, dt in sm.TRANSFER_COLS.items():
        if dt == torch.int64:
            rows[k] = t64(rand_u64(rng, len(ids), 1 << 20), dev)
        else:
            rows[k] = t32(rng.integers(0, 3, len(ids)), dev)
    mask = torch.ones(len(ids), dtype=torch.bool, device=dev)
    ht.insert_plain(t, t64(ids, dev), t64(hi, dev), mask, rows, cap)
    tomb_slots = torch.from_numpy(
        rng.choice(np.flatnonzero(to_np(t.key_lo) != 0), 64, replace=False)
    ).to(dev)
    ht.remove_to_tombstone(t, tomb_slots, torch.ones(64, dtype=torch.bool,
                                                      device=dev))
    return t, ids, hi


def account_batch(rng, n, count):
    from tigerbeetle_tpu_torch import types

    b = np.zeros(n, dtype=types.ACCOUNT_DTYPE)
    lane = np.arange(n, dtype=np.uint64)
    ids = (1 << 30) + lane
    r = rng.random(n)
    ids = np.where(r < 0.15, rng.integers(1, N_ACCOUNTS + 1, n).astype(np.uint64), ids)
    dup = (r >= 0.15) & (r < 0.3)
    ids[dup] = ids[rng.integers(0, n, int(dup.sum()))]
    b["id_lo"] = ids
    b["id_lo"][rng.random(n) < 0.01] = 0
    b["ledger"] = np.where(rng.random(n) < 0.05, 0, 1)
    b["code"] = np.where(rng.random(n) < 0.05, 0, rng.integers(0, 4, n))
    b["user_data_32"] = rng.integers(0, 4, n)
    b["user_data_64"] = rng.integers(0, 4, n)
    b["user_data_128_lo"] = rng.integers(0, 4, n)
    flags = np.where(rng.random(n) < 0.3, 1, 0)
    flags |= np.where(rng.random(n) < 0.02, 0x10, 0)
    flags |= np.where(rng.random(n) < 0.02, 6, 0)
    b["flags"] = flags
    b["reserved"] = np.where(rng.random(n) < 0.02, 7, 0)
    b["timestamp"] = np.where(rng.random(n) < 0.02, 5, 0)
    b["debits_posted_lo"] = np.where(rng.random(n) < 0.02, 3, 0)
    b["id_lo"][count:] = 0
    return b


def transfer_batch(rng, n, count, existing_ids, existing_hi, linked_all=False):
    from tigerbeetle_tpu_torch import types

    b = np.zeros(n, dtype=types.TRANSFER_DTYPE)
    lane = np.arange(n, dtype=np.uint64)
    ids = (1 << 63) + lane
    ids_hi = np.zeros(n, dtype=np.uint64)
    r = rng.random(n)
    ex = r < 0.1
    pick = rng.integers(0, len(existing_ids), int(ex.sum()))
    ids[ex] = existing_ids[pick]
    ids_hi[ex] = existing_hi[pick]
    dup = (r >= 0.1) & (r < 0.3)
    src = rng.integers(0, n, int(dup.sum()))
    ids[dup], ids_hi[dup] = ids[src], ids_hi[src]
    b["id_lo"], b["id_hi"] = ids, ids_hi
    b["id_lo"][rng.random(n) < 0.01] = 0
    dr = rng.integers(1, N_ACCOUNTS + 1, n).astype(np.uint64)
    cr = rng.integers(1, N_ACCOUNTS + 1, n).astype(np.uint64)
    dr[rng.random(n) < 0.03] = 50_000
    cr[rng.random(n) < 0.03] = 60_000
    same = rng.random(n) < 0.02
    cr[same] = dr[same]
    b["debit_account_id_lo"], b["credit_account_id_lo"] = dr, cr
    b["debit_account_id_lo"][rng.random(n) < 0.01] = 0
    b["amount_lo"] = rand_u64(rng, n)
    b["amount_lo"][rng.random(n) < 0.02] = 0
    pending = rng.random(n) < 0.2
    flags = np.where(pending, 2, 0)
    flags |= np.where(rng.random(n) < 0.3, 1, 0)
    flags |= np.where(rng.random(n) < 0.01, 0x40, 0)
    if linked_all:
        flags |= 1
    b["flags"] = flags
    b["timeout"] = np.where(pending | (rng.random(n) < 0.03),
                            rng.integers(0, 5000, n), 0)
    b["pending_id_lo"] = np.where(rng.random(n) < 0.02, 9, 0)
    b["ledger"] = np.where(rng.random(n) < 0.03, 2, 1)
    b["ledger"][rng.random(n) < 0.01] = 0
    b["code"] = np.where(rng.random(n) < 0.02, 0, 10)
    b["user_data_32"] = rng.integers(0, 3, n)
    b["timestamp"] = np.where(rng.random(n) < 0.01, 1, 0)
    b["id_lo"][count:] = 0
    return b


# K3's and K13's times before their redesign onto the whole card, taken
# beside the redesigned kernels in one call (PERF.md §6): printed in the
# phase lines only.
K3_PARENT_MS = {"transfers": 0.0762, "accounts": 0.0844}
K13_PARENT_MS = {"both_sides_8192": 0.0592, "one_side_1024": 0.0274}
# K9 on a two-phase batch of 8,190 lanes and K15's limit-8,192 query over
# the queries phase's pyramid, before their redesign (PERF.md §6).
K9_PARENT_MS = 0.0453
K15_PARENT_MS = {"query": 0.1177, "no_rows": 0.1164}
# K1 (three fills, three probes and three compares a main-path batch; the
# graph's three probes; the adversarial 15-column shape) and K7 (the
# sequential path's 8,190 new accounts; seqmix's 2,040-event batch; 16,384
# new accounts into a table a quarter full) before their redesign (PERF.md
# §6).
K1_PARENT_MS = {"three_as_create_transfers": 0.02524,
                "graph_form_three": 0.01305, "adversarial": 0.01281}
K7_PARENT_MS = {"path_8190": 15.83, "mixed_2040": 3.801, "new_16384": 32.15}


def phase_kernels(seed: int, dev) -> dict:
    import torch
    from tigerbeetle_tpu_torch import convert, types
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import state_machine as sm

    rng = np.random.default_rng(seed)
    acc = make_accounts_table(rng, dev)
    xfr, xids, xhi = make_transfers_table(rng, dev)
    results = {}

    # -- K1 probe: 8,192 lanes into the transfers table ----------------------
    cap = xfr.capacity
    n_hit = LANES // 2
    pick = rng.integers(0, len(xids), n_hit)
    lo = np.concatenate([xids[pick],
                         same_home_groups(rng, cap, 32, 4, 1 << 40)[:128],
                         rng.integers(1 << 62, 1 << 63, LANES - n_hit - 128,
                                      dtype=np.uint64)])
    hi = np.concatenate([xhi[pick], np.zeros(LANES - n_hit, np.uint64)])
    lo[rng.random(LANES) < 0.01] = 0
    klo, khi = t64(lo, dev), t64(hi, dev)
    names = sm.TRANSFER_EXISTS_COLS
    errs = 0
    for max_probe in (1, sm.MAX_PROBE):
        k = ht.lookup(xfr, klo, khi, max_probe, count=COUNT, cols=names)
        p = ht.lookup_plain(xfr, klo, khi, max_probe, 0, COUNT, names)
        errs = max(errs, max_abs_err(
            f"probe max_probe={max_probe}",
            {"found": to_np(k.found), "slot": to_np(k.slot),
             "overflow": to_np(k.overflow),
             **{c: to_np(v) for c, v in k.cols.items()}},
            {"found": to_np(p.found), "slot": to_np(p.slot),
             "overflow": to_np(p.overflow),
             **{c: to_np(v) for c, v in p.cols.items()}}))
    if not bool(ht.lookup_plain(xfr, klo, khi, 1, 0, COUNT, ()).overflow):
        raise AssertionError("probe: the max_probe=1 case did not overflow")
    xnp = table_np(xfr)
    steps = probe_steps(xnp, lo, hi, cap, sm.MAX_PROBE)
    col_bytes = sum(xfr.cols[c].element_size() for c in names)
    found_n = int(k.found.sum())
    b_bytes = 16 * LANES + 17 * steps + found_n * col_bytes \
        + LANES * (1 + 8 + col_bytes)
    adv = pair_times(
        timed(lambda: ht.lookup(xfr, klo, khi, sm.MAX_PROBE, count=COUNT,
                                cols=names)),
        timed(lambda: ht.lookup_plain(xfr, klo, khi, sm.MAX_PROBE, 0,
                                      COUNT, names)))
    adv_clock = phase_clock().split(
        "probe", lambda: ht.lookup(xfr, klo, khi, sm.MAX_PROBE, count=COUNT,
                                   cols=names))

    # -- K2 insert: 8,192 new keys, and grow 2^20 -> 2^21 ----------------
    results["insert"] = k2_adversarial(rng, xfr, dev)
    # K1 at the main path's shapes is timed on the same 2^25 table.
    results["insert"].update(insert_path_shape(dev, probe_acc=acc))
    results["insert"]["round_form"] = round_form_shapes(dev)
    # Typed in from PERF.md, printed in this phase's line only.
    results["insert"]["round_form_parent_ms_perf_md"] = K2_ROUND_PARENT_MS
    k1 = results["insert"].pop("k1")
    results["probe"] = dict(
        k1, max_abs_err=max(errs, k1["max_abs_err"]), library_ms=None,
        ms_adversarial=adv["ms"], plain_ms_adversarial=adv["plain_ms"],
        bound_adversarial=bound(b_bytes, 40 * LANES + 10 * steps),
        clock_adversarial=adv_clock,
        shape_adversarial=f"{LANES} lanes, 15 columns, table 2^20 at load "
                          f"0.45, half the keys stored, {steps} slot visits",
        parent_ms=K1_PARENT_MS, info=_cuda.probe_info(),
    )

    # -- K3 validate: accounts and transfers variants ------------------------
    errs = 0
    ab = account_batch(rng, LANES, COUNT)
    asoa = convert.soa_to_tensors(types.to_soa(ab), dev)
    alook = ht.lookup_plain(acc, asoa["id_lo"], asoa["id_hi"], sm.MAX_PROBE, 0,
                            COUNT, sm.ACCOUNT_EXISTS_COLS)
    kc, ko = sm.account_codes(asoa, alook.found, alook.cols, COUNT)
    pc, po = sm.account_codes_plain(asoa, alook.found, alook.cols, COUNT)
    errs = max(errs, max_abs_err("validate accounts",
                                 {"codes": to_np(kc), "ok": to_np(ko)},
                                 {"codes": to_np(pc), "ok": to_np(po)}))
    ts_normal, ts_high = 10 ** 18, (1 << 64) - 5 * 10 ** 11
    ctxs = []
    codes_seen = set()
    for linked_all, batch_ts in ((False, ts_normal), (False, ts_high),
                                 (True, ts_normal)):
        tb = transfer_batch(rng, LANES, COUNT, xids, xhi, linked_all)
        tsoa = convert.soa_to_tensors(types.to_soa(tb), dev)
        ctx = transfer_ctx(acc, xfr, tsoa, ht, sm)
        kc, ko = sm.transfer_codes(tsoa, ctx, COUNT, batch_ts)
        pc, po = sm.transfer_codes_plain(tsoa, ctx, COUNT, batch_ts)
        errs = max(errs, max_abs_err(
            f"validate transfers (linked_all={linked_all}, ts={batch_ts})",
            {"codes": to_np(kc), "ok": to_np(ko)},
            {"codes": to_np(pc), "ok": to_np(po)}))
        codes_seen |= set(to_np(kc)[:COUNT].tolist())
        ctxs.append((tsoa, ctx, ko, batch_ts))
    tsoa, ctx, tok, batch_ts = ctxs[0]
    # Every lane reads its batch columns and lookup flags; the gathered
    # exists columns are read only where the id was found.
    in_cols = [tsoa[c] for c in sm.TRANSFER_BATCH_COLS] + [
        ctx.dr_found, ctx.cr_found, ctx.dr["ledger"], ctx.cr["ledger"],
        ctx.ex_found]
    n_found = int(ctx.ex_found.sum())
    v_bytes = (sum(c.numel() * c.element_size() for c in in_cols)
               + n_found * sum(ctx.e[c].element_size()
                               for c in sm.TRANSFER_EXISTS_COLS)
               + 5 * LANES)
    results["validate"] = dict(
        max_abs_err=errs,
        **pair_times(
            timed(lambda: sm.transfer_codes(tsoa, ctx, COUNT, batch_ts)),
            timed(lambda: sm.transfer_codes_plain(tsoa, ctx, COUNT, batch_ts))),
        library_ms=None,
        bound=bound(v_bytes, 150 * LANES),
        shape=f"{LANES} lanes, transfers variant (timed); checked: accounts "
              "variant, timeout overflow, whole-batch linked chain",
        codes_seen=sorted(codes_seen),
        accounts_ms=timed(lambda: sm.account_codes(asoa, alook.found,
                                                   alook.cols, COUNT))["device_ms"],
        phases_us=phase_clock().split(
            "validate", lambda: sm.transfer_codes(tsoa, ctx, COUNT, batch_ts)),
        parent_ms_perf_md=K3_PARENT_MS,
    )

    # -- K4 balance ----------------------------------------------------------
    amt = tsoa["amount_lo"]
    pend = (tsoa["flags"] & sm.TF_PENDING) != 0
    ak, ap = clone_table(acc), clone_table(acc)
    sm.apply_balances(ak, ctx.dr_slot, ctx.cr_slot, tok, amt, pend)
    sm.apply_balance_plan(ap, sm.balance_plan(ctx.dr_slot, ctx.cr_slot, tok,
                                              amt, pend, ap.capacity))
    errs = max_abs_err("balance", table_np(ak), table_np(ap))
    n_ok = int(tok.sum())
    touched = int(torch.unique(torch.cat([ctx.dr_slot[tok],
                                          ctx.cr_slot[tok]])).numel())
    # The ok flag of every lane; slots, amount and pending flag of the
    # accepted lanes; one read and one write of the 64 B of balances of each
    # touched account.
    bal_bytes = LANES * 1 + n_ok * (8 + 8 + 8 + 1) + touched * 2 * 64
    legs = torch.cat([ctx.dr_slot[tok], ctx.cr_slot[tok]])
    limbs = torch.stack([amt[tok] & 0xFFFFFFFF, (amt[tok] >> 32) & 0xFFFFFFFF],
                        1).repeat(2, 1)
    scratch = torch.zeros((acc.capacity, 2), dtype=torch.int64, device=dev)
    errs = max(errs, balance_cases(rng, acc, ctx, tok, amt, pend))
    big = balance_table_2e21(rng, acc, ctx, dev)
    big_scratch = torch.zeros((big["cap"], 2), dtype=torch.int64, device=dev)
    big_legs = torch.cat([big["dr"][tok], big["cr"][tok]])
    results["balance"] = dict(
        max_abs_err=errs,
        **pair_times(
            timed(lambda t: sm.apply_balances(t, ctx.dr_slot, ctx.cr_slot, tok,
                                              amt, pend),
                  setup=lambda: (clone_table(acc),)),
            timed(lambda t: sm.apply_balance_plan(t, sm.balance_plan(
                ctx.dr_slot, ctx.cr_slot, tok, amt, pend, t.capacity)),
                setup=lambda: (clone_table(acc),))),
        library_ms=timed(lambda: scratch.index_add_(0, legs, limbs))["device_ms"],
        bound=bound(bal_bytes, 30 * n_ok),
        ms_accounts_2e21=timed(lambda: _cuda.balance(
            big["dr"], big["cr"], tok, amt, pend, big["cols"]))["device_ms"],
        library_ms_accounts_2e21=timed(
            lambda: big_scratch.index_add_(0, big_legs, limbs))["device_ms"],
        shape=f"{LANES} lanes ({n_ok} accepted, {touched} accounts touched), "
              "accounts table 2^16; library: one index_add_ of the leg limbs; "
              "ms_accounts_2e21: the same legs spread over a 2^21-slot table; "
              "checked: carry-heavy balances, one hot account, slot base over "
              "2, 4 and 8 shards",
    )
    del big, big_scratch

    # -- K5 digest -----------------------------------------------------------
    led = sm.Ledger(accounts=acc, transfers=xfr, posted=None, history=None)
    dcols = [acc.cols[c] for c in sm.BALANCE_COLS] + [acc.cols["timestamp"]]
    dk = sm.ledger_digest(led)
    dp = sm.ledger_digest_plain(acc.key_lo, acc.key_hi, dcols)
    errs = max_abs_err("digest", {"digest": to_np(dk)}, {"digest": to_np(dp)})
    n_live = int(((acc.key_lo != 0) | (acc.key_hi != 0)).sum())
    results["digest"] = dict(
        max_abs_err=errs,
        **pair_times(
            timed(lambda: sm.ledger_digest(led)),
            timed(lambda: sm.ledger_digest_plain(acc.key_lo, acc.key_hi, dcols))),
        library_ms=None,
        # The keys of every slot; the nine digested columns of live slots.
        bound=bound(acc.capacity * 16 + n_live * 9 * 8 + 8, 60 * n_live),
        shape=f"accounts table 2^16 with {N_ACCOUNTS} accounts",
    )
    torch.cuda.synchronize()
    return results


def k2_depth(claimed, lo, hi, mask, cap, overflow, max_probe) -> dict:
    """The rounds K2's protocol ran on a batch (the deepest placed lane's
    offset from its home, plus one; max_probe when it overflowed), that
    offset, and the slots the placed lanes visited."""
    c = to_np(claimed)
    m = to_np(mask) & (c < cap)
    off = (c[m] - home_np(to_np(lo)[m], to_np(hi)[m], cap)) \
        & np.uint64(cap - 1)
    deepest = int(off.max()) if len(off) else 0
    rounds = max_probe if overflow else (deepest + 1 if len(off) else 0)
    return {"rounds": rounds, "deepest_lane": deepest,
            "slot_visits": int((off + np.uint64(1)).sum())}


def k2_check(what, t, lo, hi, mask, rows, max_probe) -> tuple:
    """K2 against its plain version on one batch, byte for byte, compared
    on the card: the insert entry on clones of ``t`` (claimed slots, every
    table array, count, probe_overflow), then the claim entry on ``t``
    itself (its slots, its flag word, the marks it leaves at the claimed
    slots, and a closed gate's revert, which must leave ``t`` as it was).
    Returns (max_abs_err, the plain insert's claims, its overflow)."""
    import torch
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import hash_table as ht

    tk, tp = clone_table(t), clone_table(t)
    _, ck = ht.insert(tk, lo, hi, mask, rows, max_probe)
    _, cp = ht.insert_plain(tp, lo, hi, mask, rows, max_probe)
    overflow = bool(tp.probe_overflow)
    err = max_abs_err_card(f"insert ({what})",
                           {"claimed": ck, **table_tensors(tk)},
                           {"claimed": cp, **table_tensors(tp)})
    del tk, tp
    pc, po = ht.claim_slots_plain(t, lo, hi, mask, max_probe)
    keys = (t.key_lo.clone(), t.key_hi.clone())
    word = torch.full((1,), 4, dtype=torch.int32, device=lo.device)
    kc, _ = _cuda.claim(t.key_lo, t.key_hi, t.tombstone, lo, hi, mask,
                        max_probe, flag_word=word, flag_bit=2)
    placed = kc < t.capacity
    marks = (t.key_lo[kc[placed]], t.key_hi[kc[placed]])
    want_word = torch.full_like(word, 4 | (2 if bool(po) else 0))
    _cuda.write_claimed(t.key_lo, t.key_hi, t.tombstone, t.cols, t.count,
                        lo, hi, kc, mask, {}, gate=torch.ones_like(word),
                        revert=True)
    err = max(err, max_abs_err_card(
        f"claim ({what})",
        {"claimed": kc, "flag_word": word, "mark_lo": marks[0],
         "mark_hi": marks[1], "key_lo": t.key_lo, "key_hi": t.key_hi},
        {"claimed": pc, "flag_word": want_word, "mark_lo": lo[placed],
         "mark_hi": hi[placed], "key_lo": keys[0], "key_hi": keys[1]}))
    return err, cp, overflow


def k2_adversarial(rng, xfr, dev) -> dict:
    """K2 at the adversarial shape: 8,192 new keys (64 same-home groups of
    8 among them, 90 % masked in) into ``xfr``, make_transfers_table's
    2^20 slots at load 0.45 (its own same-home clusters and tombstones):
    the insert and claim entries against their plain versions at
    max_probe MAX_PROBE and 2, grow 2^20 -> 2^21 against the plain
    insert, both entries timed by CUDA events behind a spin, and the
    protocol's rounds and deepest lane."""
    import torch
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import state_machine as sm

    cap = xfr.capacity
    ins_lo = np.concatenate([same_home_groups(rng, cap, 64, 8, 1 << 39),
                             rng.integers(1 << 63, 1 << 64, LANES - 512,
                                          dtype=np.uint64)])
    ins_lo = np.unique(ins_lo)
    ins_lo = np.concatenate([ins_lo, (1 << 38) + np.arange(
        LANES - len(ins_lo), dtype=np.uint64)])
    rng.shuffle(ins_lo)
    ilo = t64(ins_lo, dev)
    ihi = torch.zeros(LANES, dtype=torch.int64, device=dev)
    imask = torch.from_numpy(rng.random(LANES) < 0.9).to(dev)
    irows = {k: (t64(rand_u64(rng, LANES), dev) if v.dtype == torch.int64
                 else t32(rng.integers(0, 1 << 32, LANES), dev))
             for k, v in xfr.cols.items()}
    errs = 0
    for max_probe in (sm.MAX_PROBE, 2):
        err, cp, overflow = k2_check(f"adversarial, max_probe={max_probe}",
                                     xfr, ilo, ihi, imask, irows, max_probe)
        errs = max(errs, err)
        if max_probe == 2 and not overflow:
            raise AssertionError("insert: the max_probe=2 case did not overflow")
        if max_probe == sm.MAX_PROBE:
            depth = k2_depth(cp, ilo, ihi, imask, cap, overflow, max_probe)
            ins_steps = depth["slot_visits"]
            row_bytes = sum(v.element_size() for v in xfr.cols.values())
            n_placed = int((cp < cap).sum())
            ins_bytes = LANES * (16 + 1 + 8) + 17 * ins_steps \
                + n_placed * (16 + 1 + 2 * row_bytes)
    grown_k = ht.grow(xfr, cap * 2)
    grown_p = ht.insert_plain(
        ht.make_table(cap * 2, {k: v.dtype for k, v in xfr.cols.items()}, dev),
        xfr.key_lo, xfr.key_hi, (xfr.key_lo != 0) | (xfr.key_hi != 0),
        xfr.cols, cap * 2)[0]
    errs = max(errs, max_abs_err("insert (grow 2^20 -> 2^21)",
                                 table_np(grown_k), table_np(grown_p)))
    del grown_k, grown_p
    out = dict(
        max_abs_err=errs,
        **pair_times(
            timed(lambda t: ht.insert(t, ilo, ihi, imask, irows, sm.MAX_PROBE),
                  reps=10, setup=lambda: (clone_table(xfr),)),
            timed(lambda t: ht.insert_plain(t, ilo, ihi, imask, irows,
                                            sm.MAX_PROBE),
                  reps=10, setup=lambda: (clone_table(xfr),))),
        library_ms=None,
        bound=bound(ins_bytes, 40 * LANES + 10 * ins_steps),
        shape=f"{LANES} lanes ({n_placed} placed), table 2^20 at load 0.45; "
              "also checked: max_probe=2 overflow, grow 2^20->2^21",
        rounds=depth["rounds"], deepest_lane=depth["deepest_lane"])
    out["claim_adversarial"] = dict(
        ms=timed(lambda lo_, hi_: _cuda.claim(lo_, hi_, xfr.tombstone, ilo,
                                              ihi, imask, sm.MAX_PROBE),
                 reps=10, setup=lambda: (xfr.key_lo.clone(),
                                         xfr.key_hi.clone()))["device_ms"],
        bound_ms=bound(LANES * (16 + 1 + 8) + 17 * ins_steps + 16 * n_placed,
                       40 * LANES + 10 * ins_steps)[0],
        rounds=depth["rounds"], deepest_lane=depth["deepest_lane"])
    return out


# K2's round kernel before its redesign, at round_form_shapes' shapes, ms
# (PERF.md §6, T1: the earlier tree timed in the same call as this one).
K2_ROUND_PARENT_MS = {"grow_2e25": {"claim": 5.555, "write": 3.323,
                                    "call": 10.40, "wall": 10.50},
                      "drop_evicted_2e23": {"claim": 1.942, "write": 0.946,
                                            "call": 3.289, "wall": 3.337}}


def round_form_shapes(dev) -> dict:
    """K2's round form (more than 8,192 lanes) at its callers' shapes:
    ``ht.grow`` of the main run's transfers table, 2^24 -> 2^25 slots at
    load 0.5 (8,388,608 rows, ids consecutive from FIRST_TID), and the cold
    tier's rebuild ``drop_evicted`` at the tiered run's hot ceiling, 2^23
    slots (``evict_test_table``, the threshold of time_evict).  Each
    checked byte for byte against the plain insert and the plain rebuild
    on the card; then K2's insert as the call makes it (into an unwritten
    table, written whole) and the whole call timed by CUDA events behind a
    spin, the insert's phases clocked (tools/phase_clock.py: the claim ends
    where the fill starts), the call's synchronised wall, the rounds, the
    deepest lane and the bounds (the parent's times, K2_ROUND_PARENT_MS,
    are printed beside them in the kernels phase's line)."""
    import torch
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import cold
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import state_machine as sm

    def wall_ms(fn, reps=5):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    def shape(t, keys_mask, cap, call, plain, mask_given):
        specs = {k: v.dtype for k, v in t.cols.items()}
        errs = max_abs_err_card("K2 round form", table_tensors(call()),
                                table_tensors(plain()))

        def insert():
            # The insert as the call makes it: into an unwritten table,
            # written whole.
            return ht.rehash_into(cap, t.key_lo, t.key_hi, keys_mask, t.cols)

        f, claimed = insert()
        depth = k2_depth(claimed, t.key_lo, t.key_hi, keys_mask, cap,
                         bool(f.probe_overflow), cap)
        del f
        n, placed = keys_mask.numel(), int((claimed < cap).sum())
        masked = int(keys_mask.sum())
        row_bytes = sum(c.element_size() for c in t.cols.values())
        # The call's inputs, each read once: ``grow`` reads every old key
        # (its mask comes from them) and the live lanes' rows;
        # ``drop_evicted`` its keep mask and the kept lanes' keys and rows.
        # Its output, the new table, written whole.
        read_bytes = n + masked * (row_bytes + 16) if mask_given \
            else n * 16 + masked * row_bytes
        # The claim: each lane's mask and claim, a masked lane's keys, its
        # slot's word; the fill: each placed lane's row and keys read, every
        # slot of the new table written whole.
        claim_bytes = n * 9 + masked * 16 + 8 * depth["slot_visits"]
        fill_bytes = placed * (row_bytes + 16) + cap * (17 + row_bytes)
        ins = timed(insert, reps=5)
        clock = phase_clock().split("insert_rounds", insert)
        # The claim ends where the fill starts (the memsets before the
        # first mark are left out of it).
        if "fill" not in clock["us_since_start"]:
            raise AssertionError(f"K2's round form clock has no fill mark: "
                                 f"{sorted(clock['us_since_start'])}")
        claim_ms = clock["us_since_start"]["fill"] / 1e3
        whole = timed(call, reps=5)
        return dict(
            max_abs_err=errs, insert_ms=ins["device_ms"], claim_ms=claim_ms,
            write_ms=ins["device_ms"] - claim_ms, ms=whole["device_ms"],
            wall_ms=wall_ms(call), make_table_ms=timed(
                lambda: ht.make_table(cap, specs, dev), reps=5)["device_ms"],
            claim_bound=bound(claim_bytes, 40 * n + 10 * depth["slot_visits"]),
            write_bound=bound(fill_bytes, 0),
            bound=bound(read_bytes + cap * (17 + row_bytes), 40 * n),
            rounds=depth["rounds"], deepest_lane=depth["deepest_lane"],
            lanes=n, placed=placed, info=_cuda.insert_rounds_info(n),
            clock=clock)

    out = {}
    old_cap = 1 << 24
    t = ht.make_table(old_cap, sm.TRANSFER_COLS, dev)
    ids = FIRST_TID + torch.arange(old_cap // 2, dtype=torch.int64, device=dev)
    rows = {k: (ids * 2654435761).to(dt) for k, dt in sm.TRANSFER_COLS.items()}
    ht.insert(t, ids, torch.zeros_like(ids), torch.ones_like(ids, dtype=torch.bool),
              rows, old_cap)
    del ids, rows
    live = (t.key_lo != 0) | (t.key_hi != 0)
    specs = {k: v.dtype for k, v in t.cols.items()}
    out["grow_2e25"] = shape(
        t, live, 2 * old_cap, lambda: ht.grow(t, 2 * old_cap),
        lambda: ht.insert_plain(ht.make_table(2 * old_cap, specs, dev),
                                t.key_lo, t.key_hi, live, t.cols,
                                2 * old_cap)[0], mask_given=False)
    out["grow_2e25"]["shape"] = ("ht.grow 2^24 -> 2^25 slots, 8,388,608 rows "
                                 "(the main run's ids)")
    del t, live
    torch.cuda.empty_cache()
    cap = 1 << 23
    t = evict_test_table(dev, cap)
    thr = cold.eviction_threshold(t, 500, 1000)
    keep = cold.extract_evicted(t, thr, cap, keep=True)[4]
    out["drop_evicted_2e23"] = shape(
        t, keep, cap, lambda: cold.drop_evicted(t, thr, keep),
        lambda: cold.drop_evicted_plain(t, thr, keep), mask_given=True)
    out["drop_evicted_2e23"]["shape"] = (
        f"drop_evicted at 2^23 slots, {int(keep.sum())} of "
        f"{int(cold._live(t).sum())} live rows kept")
    del t, keep
    torch.cuda.empty_cache()
    return out


def slot_visits(t, lo, hi, max_probe) -> int:
    """The slots a lookup of these keys visits (its data-dependent reads),
    counted on the card."""
    from tigerbeetle_tpu_torch.ops import hash_table as ht

    home = ht._home(lo, hi, t.capacity, 0)
    done = (lo == 0) & (hi == 0)
    visits = 0
    for i in range(max_probe):
        live = ~done
        n = int(live.sum())
        if n == 0:
            break
        visits += n
        cur = (home + i) & (t.capacity - 1)
        a, b, tb = t.key_lo[cur], t.key_hi[cur], t.tombstone[cur]
        done = done | (~tb & (((a == lo) & (b == hi)) | ((a == 0) & (b == 0))))
    return visits


def probe_path_shape(dev, acc, xfr, b: int) -> dict:
    """K1 as the main path meets it, on batch ``b`` of bench.py's plain
    generator: the debit and credit probes of the accounts table (2^16
    slots, ids 1..10,000, the ``ledger`` column) and the exists probe of the
    transfers table (2^25 slots holding the main run's earlier batches, 15
    columns, nearly every id new), as one launch of three lookups the way
    ``_create_transfers`` makes it (no overflow flags), and as
    ``GroupGraph`` launches it (preallocated outputs, the count in a device
    word).  Checked against the plain lookups on the card, byte for byte;
    times by CUDA events behind a spin; the bytes bound counts the keys,
    17 B a visited slot, each found row's columns and the outputs."""
    import torch
    from tigerbeetle_tpu_torch import convert
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import state_machine as sm
    from tigerbeetle_tpu_torch.utils.benchgen import gen_batch_np

    soa = convert.batch_to_tensors(
        gen_batch_np(b, LANES, COUNT, N_ACCOUNTS, FIRST_TID), LANES, dev)
    names = sm.TRANSFER_EXISTS_COLS
    keys = [(acc, soa["debit_account_id_lo"], soa["debit_account_id_hi"],
             ("ledger",)),
            (acc, soa["credit_account_id_lo"], soa["credit_account_id_hi"],
             ("ledger",)),
            (xfr, soa["id_lo"], soa["id_hi"], names)]

    def three():
        return ht.lookup_many([ht.Lookup(t, lo, hi, c, count=COUNT)
                               for t, lo, hi, c in keys], sm.MAX_PROBE,
                              overflow=False)

    def plain():
        return [ht.lookup_plain(t, lo, hi, sm.MAX_PROBE, 0, COUNT, c)
                for t, lo, hi, c in keys]

    cw = torch.tensor([COUNT], dtype=torch.int64, device=dev)
    outs = [(torch.empty(LANES, dtype=torch.bool, device=dev),
             torch.empty(LANES, dtype=torch.int64, device=dev),
             [torch.empty(LANES, dtype=t.cols[n].dtype, device=dev) for n in c])
            for t, _lo, _hi, c in keys]

    def graph_form():
        ht.lookup_many([ht.Lookup(t, lo, hi, c, count=LANES, count_word=cw,
                                  out=o)
                        for (t, lo, hi, c), o in zip(keys, outs)],
                       sm.MAX_PROBE, overflow=False)

    errs = 0
    graph_form()
    for what, k, p, (_t, _lo, _hi, c), o in zip(
            ("debit", "credit", "exists"), three(), plain(), keys, outs):
        errs = max(errs, max_abs_err_card(
            f"probe ({what}, the main path's shape)",
            {"found": k.found, "slot": k.slot, **k.cols},
            {"found": p.found, "slot": p.slot, **p.cols}))
        errs = max(errs, max_abs_err_card(
            f"probe ({what}, the graph's form)",
            {"found": o[0], "slot": o[1], **dict(zip(c, o[2]))},
            {"found": p.found, "slot": p.slot, **p.cols}))
    visits, found_bytes, out_bytes = 0, 0, 0
    found = []
    for (t, lo, hi, c), p in zip(keys, plain()):
        visits += slot_visits(t, lo, hi, sm.MAX_PROBE)
        width = sum(t.cols[n].element_size() for n in c)
        nf = int(p.found.sum())
        found.append(nf)
        found_bytes += nf * width
        out_bytes += LANES * (1 + 8 + width)
    k_three = timed(three)
    k_graph = timed(graph_form)
    k_plain = timed(plain)
    g = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        graph_form()
    torch.cuda.current_stream(dev).wait_stream(stream)
    with torch.cuda.graph(g, stream=stream):
        graph_form()
    replay = timed(g.replay)
    del g
    return {
        "max_abs_err": errs,
        "ms": k_three["device_ms"], "call_ms": k_three["call_ms"],
        "ms_from": k_three["device_ms_from"],
        "plain_ms": k_plain["device_ms"],
        "ms_graph_form": k_graph["device_ms"],
        "ms_graph_replay": replay["device_ms"],
        "bound": bound(3 * 16 * LANES + 17 * visits + found_bytes + out_bytes,
                       3 * 40 * LANES + 10 * visits),
        "clock": {w: phase_clock().split(
            "probe", lambda lo=lo, hi=hi, t=t, c=c: ht.lookup_many(
                [ht.Lookup(t, lo, hi, c, count=COUNT)], sm.MAX_PROBE,
                overflow=False))
            for w, (t, lo, hi, c) in zip(("debit", "exists"),
                                         (keys[0], keys[2]))},
        "shape": f"the main path's three probes of a batch, one launch: "
                 f"debit and credit ids into 2^16 account slots (ids "
                 f"1..10,000; found {found[0]}, {found[1]}), {COUNT} ids into "
                 f"2^{xfr.capacity.bit_length() - 1} transfer slots holding "
                 f"{int(xfr.count)} rows "
                 f"(15 columns, found {found[2]}), {visits} slot visits",
    }


# The main run's transfers table at its largest: 2^25 slots (grown from
# 2^18) holding the transfers of every batch but the last.
MAIN_TABLE_LOG2 = 25
FIRST_TID = 1 << 32  # the first transfer id of bench.py's generators here
# full_twophase's posted table at its largest: 2^24 slots holding the
# pending timestamps of every batch but the last (4,095 a batch).
POSTED_TABLE_LOG2 = 24


def insert_path_shape(dev, n_main: int = 10_000_000,
                      log2: int = MAIN_TABLE_LOG2, probe_acc=None) -> dict:
    """K2 as the main path meets it: 8,190-event batches of bench.py's plain
    generator inserted into a transfers table of 2^25 slots already holding
    the main run's 1,221 earlier batches (its ids, consecutive from
    FIRST_TID), each timed call a later batch of the run (so the table
    gains 8,190 rows a call, 0.06 % of its load).  Then, on that table,
    the claim entry (the rounds without the rows) and the write entry (the
    rows at claimed slots), and the claim entry as full_twophase calls it:
    a two-phase batch's ids into the same table (full_twophase's
    transfers hold the same ids at its last batch), and its 4,095 posts'
    pending timestamps into a posted table of 2^24 slots holding those of
    every earlier batch (the machine's timestamps: 10,000 accounts, then
    8,190 a batch, lane i of a batch at its base + 1 + i).  Each checked
    against its plain version first, byte for byte (``k2_check``); times
    by CUDA events behind a spin, beside their bounds; the rounds and the
    deepest lane of each shape."""
    import torch
    from tigerbeetle_tpu_torch import convert
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import state_machine as sm
    from tigerbeetle_tpu_torch.utils.benchgen import (gen_batch_np,
                                                       gen_two_phase_np)

    batches = (n_main + COUNT - 1) // COUNT
    held = (batches - 1) * COUNT
    cap = 1 << log2
    t = ht.make_table(cap, sm.TRANSFER_COLS, dev)
    keys = torch.arange(FIRST_TID, FIRST_TID + held, dtype=torch.int64,
                        device=dev)
    zero_rows = {k: torch.zeros(held, dtype=dt, device=dev)
                 for k, dt in sm.TRANSFER_COLS.items()}
    ht.insert(t, keys, torch.zeros_like(keys),
              torch.ones(held, dtype=torch.bool, device=dev), zero_rows,
              sm.MAX_PROBE)
    del keys, zero_rows
    if int(t.count.item()) != held:
        raise AssertionError("insert (path shape): the table lost rows")
    k1 = None if probe_acc is None else probe_path_shape(
        dev, probe_acc, t, batches - 1)
    nxt = [batches - 1]

    def batch(gen=gen_batch_np):
        soa = convert.batch_to_tensors(
            gen(nxt[0], LANES, COUNT, N_ACCOUNTS, FIRST_TID), LANES, dev)
        nxt[0] += 1
        rows = {k: soa[k] for k in sm.TRANSFER_COLS if k in soa}
        for k, dt in sm.TRANSFER_COLS.items():
            rows.setdefault(k, torch.zeros(LANES, dtype=dt, device=dev))
        return (soa["id_lo"], soa["id_hi"],
                torch.arange(LANES, device=dev) < COUNT, rows)

    ilo, ihi, mask, rows = batch()
    err, cp, overflow = k2_check("the main path's shape", t, ilo, ihi, mask,
                                 rows, sm.MAX_PROBE)
    depth = k2_depth(cp, ilo, ihi, mask, cap, overflow, sm.MAX_PROBE)
    steps = depth["slot_visits"]
    row_bytes = sum(v.element_size() for v in t.cols.values())
    b = bound(LANES * (16 + 1 + 8) + 17 * steps
              + COUNT * (16 + 1 + 2 * row_bytes), 40 * LANES + 10 * steps)
    r = timed(lambda lo, hi, mk, rw: ht.insert(t, lo, hi, mk, rw, sm.MAX_PROBE),
              reps=10, setup=batch)
    # The claim entry on the same table and batches; the write entry on the
    # claims its set-up makes.  Both leave the table as an insert would.
    rc = timed(lambda lo, hi, mk, _rw: _cuda.claim(
        t.key_lo, t.key_hi, t.tombstone, lo, hi, mk, sm.MAX_PROBE),
        reps=10, setup=batch)

    def claimed_batch():
        lo, hi, mk, rw = batch()
        return lo, hi, mk, rw, _cuda.claim(t.key_lo, t.key_hi, t.tombstone,
                                           lo, hi, mk, sm.MAX_PROBE)[0]

    rw_ = timed(lambda lo, hi, mk, rw, c: _cuda.write_claimed(
        t.key_lo, t.key_hi, t.tombstone, t.cols, t.count, lo, hi, c, mk, rw),
        reps=10, setup=claimed_batch)

    # full_twophase's claims: the transfers' ids (a two-phase batch, every
    # lane ok) and the posts' pending timestamps into the posted table.
    pcap = 1 << POSTED_TABLE_LOG2
    p = ht.make_table(pcap, sm.POSTED_COLS, dev)
    half = COUNT // 2
    base = N_ACCOUNTS + COUNT * torch.arange(batches - 1, device=dev)
    pkeys = (base[:, None] + 1 + torch.arange(half, device=dev)).reshape(-1)
    ht.insert(p, pkeys, torch.zeros_like(pkeys),
              torch.ones_like(pkeys, dtype=torch.bool),
              {"fulfillment": torch.ones_like(pkeys, dtype=torch.int32)},
              sm.MAX_PROBE)
    del pkeys
    post = torch.arange(LANES, device=dev)
    pv_ok = (post >= half) & (post < 2 * half)

    def twophase():
        b0 = nxt[0]
        lo, hi, mk, _rw = batch(gen_two_phase_np)
        pkey = torch.where(pv_ok, N_ACCOUNTS + COUNT * b0 + 1 + post - half,
                           torch.zeros_like(post))
        return lo, hi, mk, pkey

    lo2, hi2, mk2, pkey = twophase()
    zeros = torch.zeros_like(pkey)
    prow = {"fulfillment": torch.ones(LANES, dtype=torch.int32, device=dev)}
    err2, cpt, ovt = k2_check("full_twophase's transfers", t, lo2, hi2, mk2,
                              rows, sm.MAX_PROBE)
    err3, cpp, ovp = k2_check("full_twophase's posted", p, pkey, zeros, pv_ok,
                              prow, sm.MAX_PROBE)
    depth_t = k2_depth(cpt, lo2, hi2, mk2, cap, ovt, sm.MAX_PROBE)
    depth_p = k2_depth(cpp, pkey, zeros, pv_ok, pcap, ovp, sm.MAX_PROBE)

    def claim_both(lo, hi, mk, pk):
        word = torch.zeros(1, dtype=torch.int32, device=dev)
        _cuda.claim(t.key_lo, t.key_hi, t.tombstone, lo, hi, mk,
                    sm.MAX_PROBE, flag_word=word, flag_bit=1)
        _cuda.claim(p.key_lo, p.key_hi, p.tombstone, pk, zeros, pv_ok,
                    sm.MAX_PROBE, flag_word=word, flag_bit=2)

    r2 = timed(claim_both, reps=10, setup=twophase)
    rp = timed(lambda lo, hi, mk, pk: _cuda.claim(
        p.key_lo, p.key_hi, p.tombstone, pk, zeros, pv_ok, sm.MAX_PROBE),
        reps=10, setup=twophase)
    load = int(t.count.item()) / cap
    claim_b = bound(LANES * (16 + 1 + 8) + 17 * steps + 16 * COUNT,
                    40 * LANES + 10 * steps)
    two_b = bound(2 * LANES * (16 + 1 + 8) + 17 * (depth_t["slot_visits"]
                                                   + depth_p["slot_visits"])
                  + 16 * (COUNT + half),
                  80 * LANES + 10 * (depth_t["slot_visits"]
                                     + depth_p["slot_visits"]))
    del t, p
    torch.cuda.empty_cache()
    return {**({} if k1 is None else {"k1": k1}),
            "ms_path_shape": r["device_ms"],
            "ms_path_shape_from": r["device_ms_from"],
            "bound_path_shape": b,
            "max_abs_err_path_shape": max(err, err2, err3),
            "path_shape": f"{COUNT} plain events into 2^{log2} "
                          f"slots holding {held:,} rows ({steps} slot visits; "
                          f"load {load:.3f} after the timed calls)",
            "rounds_path_shape": depth["rounds"],
            "deepest_lane_path_shape": depth["deepest_lane"],
            "claim_path_shape": {
                "ms": rc["device_ms"], "bound_ms": claim_b[0],
                "write_ms": rw_["device_ms"],
                "rounds": depth["rounds"],
                "deepest_lane": depth["deepest_lane"]},
            "claim_twophase_shape": {
                "ms": r2["device_ms"], "posted_ms": rp["device_ms"],
                "bound_ms": two_b[0],
                "rounds": [depth_t["rounds"], depth_p["rounds"]],
                "deepest_lane": [depth_t["deepest_lane"],
                                 depth_p["deepest_lane"]],
                "shape": f"{COUNT} two-phase ids into the transfers table "
                         f"above, then {half} posts' pending timestamps into "
                         f"2^{POSTED_TABLE_LOG2} posted slots holding "
                         f"{(batches - 1) * half:,}"}}


def balance_cases(rng, acc, ctx, tok, amt, pend) -> int:
    """K4 against its plain version, byte for byte, on the inputs the fast
    path gives it with the balances set a few units below 2^64 (most legs
    carry into the hi word), with every leg on one debit and one credit
    account (warp aggregation), and in its slot-base form over 2, 4 and 8
    shards on the carry-heavy balances."""
    import torch
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import state_machine as sm
    from tigerbeetle_tpu_torch.parallel import sharded as tsh

    carry = clone_table(acc)
    for c in sm.BALANCE_COLS:
        if c.endswith("_lo"):
            carry.cols[c].copy_(t64(np.uint64((1 << 64) - 1) - rng.integers(
                0, 64, acc.capacity, dtype=np.uint64), acc.key_lo.device))
    hot_dr = torch.full_like(ctx.dr_slot, int(ctx.dr_slot[tok][0]))
    hot_cr = torch.full_like(ctx.cr_slot, int(ctx.cr_slot[tok][0]))
    if int(hot_dr[0]) == int(hot_cr[0]):
        hot_cr = torch.full_like(ctx.cr_slot, int(ctx.cr_slot[tok][1]))
    errs = 0
    for what, base, dr, cr in (("carry-heavy", carry, ctx.dr_slot, ctx.cr_slot),
                               ("one hot account", acc, hot_dr, hot_cr),
                               ("hot and carry-heavy", carry, hot_dr, hot_cr)):
        k, p = clone_table(base), clone_table(base)
        sm.apply_balances(k, dr, cr, tok, amt, pend)
        sm.apply_balance_plan(p, sm.balance_plan(dr, cr, tok, amt, pend,
                                                 p.capacity))
        errs = max(errs, max_abs_err(f"balance ({what})", table_np(k),
                                     table_np(p)))
    cap = acc.capacity
    for n_shards in (2, 4, 8):
        local = cap // n_shards
        for s in range(n_shards):
            part = {c: v[s * local:(s + 1) * local].clone()
                    for c, v in carry.cols.items() if c in sm.BALANCE_COLS}
            k = ht.Table(carry.key_lo[:local].clone(),
                         carry.key_hi[:local].clone(),
                         carry.tombstone[:local].clone(), part,
                         carry.count.clone(), carry.probe_overflow.clone())
            p = clone_table(k)
            tsh.apply_balances_local(k, ctx.dr_slot, ctx.cr_slot, tok, amt,
                                     pend, s * local, cap)
            tsh.apply_balances_local_plain(p, ctx.dr_slot, ctx.cr_slot, tok,
                                           amt, pend, s * local, cap)
            errs = max(errs, max_abs_err(
                f"balance (slot base, shard {s} of {n_shards})", table_np(k),
                table_np(p)))
    return errs


def balance_table_2e21(rng, acc, ctx, dev) -> dict:
    """The timed legs' accounts spread over a table of 2^21 slots (each
    touched slot of the 2^16 table mapped to its own random slot), with
    the eight balance columns: K4's time there shows whether it grows with
    the accounts capacity."""
    import torch
    from tigerbeetle_tpu_torch.ops import state_machine as sm

    cap = 1 << 21
    perm = torch.from_numpy(rng.permutation(cap)[:acc.capacity]).to(dev)
    cols = [torch.from_numpy(rand_u64(rng, cap, 1 << 60).view(np.int64)).to(dev)
            for _ in sm.BALANCE_COLS]
    return {"cap": cap, "dr": perm[ctx.dr_slot], "cr": perm[ctx.cr_slot],
            "cols": cols}


def transfer_ctx(acc, xfr, soa, ht, sm):
    dr = ht.lookup_plain(acc, soa["debit_account_id_lo"],
                         soa["debit_account_id_hi"], sm.MAX_PROBE, 0, COUNT,
                         ("ledger",))
    cr = ht.lookup_plain(acc, soa["credit_account_id_lo"],
                         soa["credit_account_id_hi"], sm.MAX_PROBE, 0, COUNT,
                         ("ledger",))
    ex = ht.lookup_plain(xfr, soa["id_lo"], soa["id_hi"], sm.MAX_PROBE, 0,
                         COUNT, sm.TRANSFER_EXISTS_COLS)
    return sm.TransferCtx(dr.found, cr.found, dr.slot, cr.slot, dr.cols,
                          cr.cols, ex.found, ex.cols)


# ---------------------------------------------------------------------------
# phase 4: small parity against the scalar oracle
# ---------------------------------------------------------------------------


def phase_parity(seed: int, dev) -> dict:
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine
    from tigerbeetle_tpu_torch.testing import model as M
    from tigerbeetle_tpu_torch.utils.benchgen import gen_batch_np

    # The bench.run_parity_check shape.
    cfg = LedgerConfig(accounts_capacity_log2=10, transfers_capacity_log2=11,
                       posted_capacity_log2=10)
    m = TorchStateMachine(cfg, batch_lanes=256, device=dev)
    ref = M.ReferenceStateMachine()
    accounts = types.accounts_array(
        [types.account(id=i + 1, ledger=1, code=10) for i in range(64)])
    got = m.create_accounts(accounts, wall_clock_ns=1)
    if got != ref.create_accounts(M.accounts_from_batch(accounts), 1):
        raise AssertionError("parity: accounts")
    batches = 0
    for b in range(3):
        batch = gen_batch_np(b, 200, 200, 64, 1 << 32)
        if m.create_transfers(batch) != ref.create_transfers(
                M.transfers_from_batch(batch)):
            raise AssertionError(f"parity: transfers batch {b}")
        batches += 1
    if m.balances_snapshot() != ref.balances_snapshot():
        raise AssertionError("parity: balances")

    # Seeded batches with validation failures, duplicates, linked account
    # chains, and a transfers table that grows.
    rng = np.random.default_rng(seed + 1)
    cfg = LedgerConfig(accounts_capacity_log2=10, transfers_capacity_log2=10,
                       posted_capacity_log2=10)
    m = TorchStateMachine(cfg, batch_lanes=256, device=dev)
    ref = M.ReferenceStateMachine()
    n_failed = 0
    wall = 1000
    for i in range(3):
        ab = account_batch(rng, 200, 200)
        ab["flags"] &= ~np.uint16(6)  # no limit accounts: keep the fast path
        ab["id_lo"][ab["id_lo"] >= (1 << 30)] += i * 1000
        if ref.accounts:
            again = rng.random(len(ab)) < 0.1
            ab["id_lo"][again] = rng.choice(list(ref.accounts), int(again.sum()))
        if (ab["flags"] & 1).any():
            keep = np.unique(ab["id_lo"], return_index=True)[1]
            ab = ab[np.sort(keep)]
        wall += 10 ** 6
        got = m.create_accounts(ab, wall_clock_ns=wall)
        want = ref.create_accounts(M.accounts_from_batch(ab), wall)
        if got != want:
            raise AssertionError(f"parity: seeded accounts batch {i}")
        n_failed += len(got)
        batches += 1
    ids = [a for a in ref.accounts]
    for i in range(8):
        n = 200
        tb = np.zeros(n, dtype=types.TRANSFER_DTYPE)
        tb["id_lo"] = (1 << 40) + i * n + np.arange(n)
        dupes = rng.random(n) < 0.1
        tb["id_lo"][dupes] = tb["id_lo"][rng.integers(0, n, int(dupes.sum()))]
        tb["debit_account_id_lo"] = rng.choice(ids + [999_999], n)
        tb["credit_account_id_lo"] = rng.choice(ids, n)
        tb["amount_lo"] = rng.integers(0, 1000, n)
        tb["ledger"] = np.where(rng.random(n) < 0.05, 3, 1)
        tb["code"] = np.where(rng.random(n) < 0.03, 0, 10)
        pending = rng.random(n) < 0.2
        tb["flags"] = np.where(pending, 2, 0)
        tb["timeout"] = np.where(pending, rng.integers(0, 100, n), 0)
        wall += 10 ** 6
        got = m.create_transfers(tb, wall_clock_ns=wall)
        want = ref.create_transfers(M.transfers_from_batch(tb), wall)
        if got != want:
            raise AssertionError(f"parity: seeded transfers batch {i}")
        n_failed += len(got)
        batches += 1
    if m.balances_snapshot() != ref.balances_snapshot():
        raise AssertionError("parity: seeded balances")
    return {"batches": batches, "failed_events_matched": n_failed,
            "transfers_capacity_after": m.ledger.transfers.capacity}


# ---------------------------------------------------------------------------
# phase 5: the main path at full size
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def timed_grows(grows: list):
    """While the block runs, every ``ht.grow`` is timed on the card (a
    synchronise on each side of the rehash) and recorded in ``grows`` with
    the allocator's reserved bytes before and after it and the time its
    new table's allocation took (``make_table_ms``: ``ht._new_table``,
    which ``make_table`` and ``rehash_into`` call, synchronised alike)."""
    import torch
    from tigerbeetle_tpu_torch.ops import hash_table as ht

    grow, new_table = ht.grow, ht._new_table
    alloc_ms = []

    def timed_new_table(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = new_table(*args, **kwargs)
        torch.cuda.synchronize()
        alloc_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def wrapped(table, capacity, hash_shift=0):
        torch.cuda.synchronize()
        before = torch.cuda.memory_reserved()
        alloc_ms.clear()
        ht._new_table = timed_new_table
        t0 = time.perf_counter()
        try:
            out = grow(table, capacity, hash_shift)
            torch.cuda.synchronize()
        finally:
            ht._new_table = new_table
        if not alloc_ms:
            raise AssertionError("ht.grow allocated no table")
        grows.append({"from": table.capacity, "to": capacity,
                      "ms": (time.perf_counter() - t0) * 1e3,
                      "make_table_ms": sum(alloc_ms),
                      "reserved_before": before,
                      "reserved_after": torch.cuda.memory_reserved()})
        return out

    ht.grow = wrapped
    try:
        yield grows
    finally:
        ht.grow = grow


def phase_main(dev, n_transfers: int, snapshot_batches: int = 0) -> dict:
    """The main path at full size.  With ``snapshot_batches``, the accounts
    table's keys and balance columns are copied on the card (a device copy,
    no host read) once that many batches have committed: the flagship
    phase compares the bench twin's balances with them."""
    import torch
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine
    from tigerbeetle_tpu_torch.ops import state_machine as sm
    from tigerbeetle_tpu_torch.utils.benchgen import gen_batch_np

    batch_max = 8190
    torch.cuda.reset_peak_memory_stats()
    # lazy_index: no index maintenance (bench.py's device runs), so the
    # throughput compares with the earlier slices' runs.
    m = TorchStateMachine(LedgerConfig(lazy_index=True), batch_lanes=8192,
                          device=dev)
    caps0 = m.ledger.transfers.capacity
    for start in range(0, N_ACCOUNTS, batch_max):
        ids = range(start + 1, min(N_ACCOUNTS, start + batch_max) + 1)
        batch = types.accounts_array(
            [types.account(id=i, ledger=1, code=10) for i in ids])
        if m.create_accounts(batch) != []:
            raise AssertionError("main: account creation failed")

    debits = np.zeros(N_ACCOUNTS + 1, np.uint64)
    credits = np.zeros(N_ACCOUNTS + 1, np.uint64)
    n_batches = (n_transfers + batch_max - 1) // batch_max
    # A window of full batches near the end runs under torch.profiler,
    # tracing the card only (host tracing would slow the host side it is
    # meant to show), and is left out of the throughput figure.  Each
    # create_transfers call ends in the read of its codes, after all of its
    # device work, so the device idle share is taken over the calls' wall:
    # that of the profiled window, and that of the unprofiled full batches
    # that did not grow the table.
    window = range(n_batches - 1 - PROFILE_BATCHES, n_batches - 1)
    if window.start < 0:
        window = range(0)
    commit_s = 0.0
    n_timed = 0
    snapshot = None
    prof_commit_ms = 0.0
    steady_s = 0.0
    n_steady = 0
    grow_batches_ms = []
    # Each growth's rehash timed apart (its batch's wall is in
    # grow_batches_ms), with the allocator's reserved bytes around it.
    table_grows = []
    prof = None
    t_wall = time.perf_counter()
    for b in range(n_batches):
        count = min(batch_max, n_transfers - b * batch_max)
        batch = gen_batch_np(b, batch_max, batch_max, N_ACCOUNTS, 1 << 32)[:count]
        cap = m.ledger.transfers.capacity
        if window and b == window.start:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        with timed_grows(table_grows):
            res = m.create_transfers(batch)
        dt = time.perf_counter() - t0
        grew = m.ledger.transfers.capacity != cap
        if grew:
            grow_batches_ms.append(dt * 1e3)
        if b in window:
            prof_commit_ms += dt * 1e3
        else:
            commit_s += dt
            n_timed += count
            if count == batch_max and not grew:
                steady_s += dt
                n_steady += 1
        if window and b == window.stop - 1:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
        if res:
            raise AssertionError(f"main: batch {b} had failures {res[:5]}")
        if b == snapshot_batches - 1:
            a = m.ledger.accounts
            snapshot = {c: a.cols[c].clone() for c in
                        sm.BALANCE_COLS + ("timestamp",)}
            snapshot.update(key_lo=a.key_lo.clone(), key_hi=a.key_hi.clone())
        np.add.at(debits, batch["debit_account_id_lo"].astype(np.int64),
                  batch["amount_lo"])
        np.add.at(credits, batch["credit_account_id_lo"].astype(np.int64),
                  batch["amount_lo"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t_wall

    rows = m.lookup_accounts(list(range(1, N_ACCOUNTS + 1)))
    if len(rows) != N_ACCOUNTS:
        raise AssertionError("main: lookup lost accounts")
    order = rows["id_lo"].astype(np.int64)
    for name, want in (("debits_posted", debits), ("credits_posted", credits)):
        if not np.array_equal(rows[name + "_lo"], want[order]) or rows[name + "_hi"].any():
            raise AssertionError(f"main: {name} differs from the closed form")
    for name in ("debits_pending", "credits_pending"):
        if rows[name + "_lo"].any() or rows[name + "_hi"].any():
            raise AssertionError(f"main: {name} not zero")
    total = int(debits.sum(dtype=np.uint64))
    if total != int(credits.sum(dtype=np.uint64)):
        raise AssertionError("main: conservation violated")
    digest = m.digest()
    a = m.ledger.accounts
    plain = sm.ledger_digest_plain(
        a.key_lo, a.key_hi,
        [a.cols[c] for c in sm.BALANCE_COLS] + [a.cols["timestamp"]])
    if digest != int(plain.item()) & ((1 << 64) - 1):
        raise AssertionError("main: digest differs from its plain version")
    if int(m.ledger.transfers.count.item()) != n_transfers:
        raise AssertionError("main: transfers count")
    profile = None
    if prof is not None:
        by_name = {}
        busy = device_us(prof, by_name) / 1e3
        if busy <= 0:
            raise AssertionError("main: the profile recorded no device time")
        steady_ms = steady_s * 1e3 / n_steady if n_steady else None
        profile = {
            "batches": len(window), "commit_wall_ms": prof_commit_ms,
            "device_busy_ms": busy,
            "device_idle_share": 1 - busy / prof_commit_ms,
            "unprofiled_batches": n_steady,
            "unprofiled_wall_ms_per_batch": steady_ms,
            "device_idle_share_unprofiled":
                1 - busy / len(window) / steady_ms if steady_ms else None,
            "device_ms_per_batch_by_name": {
                k: v / 1e3 / len(window) for k, v in sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:12]},
        }
    return {
        "accounts": N_ACCOUNTS, "transfers": n_transfers, "batches": n_batches,
        "transfers_capacity": [caps0, m.ledger.transfers.capacity],
        "grow_batches_ms": grow_batches_ms, "table_grows": table_grows,
        "commit_s_unprofiled": commit_s, "wall_s_with_host_generation": wall_s,
        "transfers_per_s": n_timed / commit_s,
        "profile": profile,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "digest": digest, "sum_amounts": total,
        "snapshot": snapshot,
    }


# ---------------------------------------------------------------------------
# phase 6: K6, K7 and K8 against their plain versions
# ---------------------------------------------------------------------------

SEQ_LANES = 2048
SEQ_ACCOUNTS = 400  # accounts the transfer mix draws from
MAIN_PATH = ("probe", "insert", "validate", "balance", "digest")
SEQ_PATH = ("probe", "insert", "digest", "seq_prepass", "seq_transfers",
            "seq_accounts")


class PlainTrace:
    """While active, records what the plain sequential path reads and writes
    (its distinct elements: the bytes a kernel must move at least) and the
    dependent-read chain of its events (probe steps and row gathers)."""

    def __enter__(self):
        from tigerbeetle_tpu_torch.ops import scan_path as tsp

        self.tsp = tsp
        self.read, self.written = set(), set()
        self.steps = self.gathers = 0
        self._orig = (tsp._get, tsp._put, tsp._slookup, tsp._gather_row)
        get, put, slookup, gather = self._orig

        def traced_get(col, i):
            self.read.add((col.data_ptr(), int(i), col.element_size()))
            return get(col, i)

        def traced_put(col, i, v):
            self.written.add((col.data_ptr(), int(i), col.element_size()))
            put(col, i, v)

        def traced_slookup(table, lo, hi):
            self.steps += self._probe_len(table, lo, hi, get)
            return slookup(table, lo, hi)

        def traced_gather(table, slot, valid):
            self.gathers += bool(valid)
            return gather(table, slot, valid)

        tsp._get, tsp._put = traced_get, traced_put
        tsp._slookup, tsp._gather_row = traced_slookup, traced_gather
        return self

    def _probe_len(self, table, lo, hi, get) -> int:
        if lo == 0 and hi == 0:
            return 0
        mask = table.capacity - 1
        home = self.tsp._mix64(lo, hi) & mask
        for i in range(self.tsp.MAX_PROBE):
            cur = (home + i) & mask
            if get(table.tombstone, cur):
                continue
            key = (get(table.key_lo, cur), get(table.key_hi, cur))
            if key in ((lo, hi), (0, 0)):
                return i + 1
        return self.tsp.MAX_PROBE

    def __exit__(self, *exc):
        tsp = self.tsp
        tsp._get, tsp._put, tsp._slookup, tsp._gather_row = self._orig

    def table_bytes(self) -> int:
        return sum(w for _p, _i, w in self.read | self.written)


def clone_ledger(led, device=None):
    from tigerbeetle_tpu_torch import convert

    return convert.ledger_from_numpy(convert.ledger_to_numpy(led),
                                     device or led.device)


def ledger_np(led) -> dict:
    from tigerbeetle_tpu_torch import convert

    out = {}
    for name, d in convert.ledger_to_numpy(led).items():
        for k, v in d.items():
            if k == "cols":
                out.update({f"{name}/{c}": a for c, a in v.items()})
            else:
                out[f"{name}/{k}"] = v
    return out


def seq_prepared_ledger(rng, dev):
    """A ledger on the card whose transfers table holds 30 % random rows,
    some of them pending transfers between the mix's accounts, plus 64
    same-home clusters of 6 and 256 tombstones (K2 inserts, K8 tombstones);
    the posted table holds rows and tombstones keyed by some pendings'
    timestamps; the history log holds 100 rows."""
    import torch
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import state_machine as sm

    led = sm.make_ledger(1 << 13, 1 << 15, 1 << 12, 1 << 13, device=dev)
    xfr = led.transfers
    cap = xfr.capacity
    clusters = same_home_groups(rng, cap, 64, 6, 1 << 40)
    ids = np.unique(np.concatenate([
        rng.integers(1 << 41, 1 << 50, size=int(cap * 0.3), dtype=np.uint64),
        clusters]))
    rng.shuffle(ids)
    n = len(ids)
    rows = {}
    for k, dt in sm.TRANSFER_COLS.items():
        rows[k] = (t64(rand_u64(rng, n, 1 << 20), dev) if dt == torch.int64
                   else t32(rng.integers(0, 3, n), dev))
    pend = rng.random(n) < 0.5
    rows["flags"] = t32(np.where(pend, 2, 0), dev)
    rows["debit_account_id_lo"] = t64(rng.integers(1, SEQ_ACCOUNTS + 1, n)
                                      .astype(np.uint64), dev)
    rows["credit_account_id_lo"] = t64(
        (to_np(rows["debit_account_id_lo"]) % np.uint64(SEQ_ACCOUNTS))
        + np.uint64(1), dev)
    for k in ("debit_account_id_hi", "credit_account_id_hi", "amount_hi",
              "pending_id_lo", "pending_id_hi"):
        rows[k] = torch.zeros(n, dtype=torch.int64, device=dev)
    rows["ledger"] = t32(np.ones(n), dev)
    rows["code"] = t32(np.full(n, 10), dev)
    rows["timeout"] = t32(np.where(pend, rng.integers(0, 3, n), 0), dev)
    rows["timestamp"] = t64(np.arange(1, n + 1, dtype=np.uint64) * 1000, dev)
    ht.insert(xfr, t64(ids, dev), torch.zeros(n, dtype=torch.int64, device=dev),
              torch.ones(n, dtype=torch.bool, device=dev), rows, cap)
    live = np.flatnonzero(to_np(xfr.key_lo) != 0)
    gone = torch.from_numpy(rng.choice(live, 256, replace=False)).to(dev)
    ht.remove_to_tombstone(xfr, gone, torch.ones(256, dtype=torch.bool,
                                                 device=dev))
    # Posted rows for a fifth of the pendings (already posted or voided).
    pts = to_np(rows["timestamp"])[pend][: n // 10]
    ppos = led.posted
    m = len(pts)
    ht.insert(ppos, t64(pts, dev), torch.zeros(m, dtype=torch.int64, device=dev),
              torch.ones(m, dtype=torch.bool, device=dev),
              {"fulfillment": t32(rng.integers(1, 3, m), dev)}, ppos.capacity)
    plive = np.flatnonzero(to_np(ppos.key_lo) != 0)
    pgone = torch.from_numpy(rng.choice(plive, 32, replace=False)).to(dev)
    ht.remove_to_tombstone(ppos, pgone, torch.ones(32, dtype=torch.bool,
                                                   device=dev))
    for c in led.history.cols.values():
        c[:100] = t64(rand_u64(rng, 100, 1 << 40), dev)
    led.history.count.fill_(100)
    return led, [int(i) for i in ids[pend][:2000]]


class SeqPair:
    """One ledger on the card and its copy on the CPU: each batch goes
    through the kernel on the card and the plain version on the copy, and
    the two are compared array by array (codes, overflow flag, every table
    and the history log)."""

    def __init__(self, gpu, lanes: int):
        self.gpu = gpu
        self.cpu = clone_ledger(gpu, "cpu")
        self.lanes = lanes
        self.codes_seen = set()

    def soa(self, batch, device):
        from tigerbeetle_tpu_torch import convert, types

        padded = np.zeros(self.lanes, dtype=batch.dtype)
        padded[: len(batch)] = batch
        return convert.soa_to_tensors(types.to_soa(padded), device)

    def run(self, op: str, batch, ts: int) -> dict:
        from tigerbeetle_tpu_torch.ops import scan_path as tsp

        before = clone_ledger(self.gpu)
        sg, sc = self.soa(batch, self.gpu.device), self.soa(batch, "cpu")
        pre = {}
        if op == "create_transfers_seq":  # K32 against its plain version
            t0 = time.perf_counter()
            pp = tsp.seq_prepass_plain(self.cpu, sc, len(batch), ts)
            pre["plain_ms"] = (time.perf_counter() - t0) * 1e3
            pk = tsp.seq_prepass(self.gpu, sg, len(batch), ts)
            pre["err"] = max_abs_err(f"seq_prepass at ts {ts}",
                                     {k: to_np(v) for k, v in pk.items()},
                                     {k: to_np(v) for k, v in pp.items()})
            pre["bytes"] = prepass_bytes(self.cpu, sc, len(batch), pp)
        _, kc, kov = getattr(tsp, op)(self.gpu, sg, len(batch), ts)
        with PlainTrace() as trace:
            t0 = time.perf_counter()
            self.cpu, pc, pov = getattr(tsp, op + "_plain")(
                self.cpu, sc, len(batch), ts)
            plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_err(f"{op} at ts {ts}",
                          {"codes": to_np(kc), "overflow": to_np(kov),
                           **ledger_np(self.gpu)},
                          {"codes": to_np(pc), "overflow": to_np(pov),
                           **ledger_np(self.cpu)})
        self.codes_seen.update(to_np(kc)[: len(batch)].tolist())
        in_bytes = sum(c.numel() * c.element_size() for c in sc.values())
        return {
            "op": op, "ts": ts, "plain_ms": plain_ms, "err": err, "soa": sg,
            "count": len(batch), "before": before,
            # The batch and the codes, plus the distinct table elements the
            # events read and write.
            "bytes": in_bytes + 4 * self.lanes + trace.table_bytes(),
            "chain_per_event": 1 + (trace.steps + trace.gathers) / len(batch),
            "probe_steps": trace.steps, "row_gathers": trace.gathers,
            "prepass": pre,
        }


def prepass_bytes(led, soa, count: int, pre) -> int:
    """What K32's function must move at least on this batch: the active
    events' batch columns, read once; 17 B (key and tombstone) for each
    slot its probes visit (ids and pending ids in the transfers table, the
    legs' account ids in the accounts table, the posted keys in the posted
    table; a candidate's legs are its creator's, found without a probe);
    the rows it gathers, at their columns' widths (a pending's, an existing
    transfer's, a found leg's flags and ledger, a posted row's value); the
    balances of each distinct account once; and its answers at their own
    widths: an active event's bits (2 B), static code (1 B), id group (2 B)
    and id slot and step (4 + 2 B); a post or void's pending slot and group
    (4 + 2 B); a leg's slot and dense index (4 + 2 B); a posted key's slot,
    step and group (4 + 2 + 2 B); a distinct account's slot (4 B).  Not
    counted: the record's copy of the event's columns, its unused words,
    the inactive lanes' records and the dense arrays' unused entries, which
    are this design's layout and not the function's work."""
    from tigerbeetle_tpu_torch.ops import scan_path as tsp
    from tigerbeetle_tpu_torch.ops import state_machine as sm

    rec = to_np(pre["rec"])[:count]
    bits = rec[:, tsp.R["bits"]]

    def has(b):
        return (bits & np.uint64(b)) != 0

    xnp, anp, pnp = table_np(led.transfers), table_np(led.accounts), table_np(led.posted)
    postvoid = (rec[:, tsp.R["v_flags"]] & np.uint64(tsp.TF_POST | tsp.TF_VOID)) != 0
    steps = probe_steps(xnp, rec[:, tsp.R["v_id_lo"]], rec[:, tsp.R["v_id_hi"]],
                        led.transfers.capacity, tsp.MAX_PROBE)
    steps += probe_steps(xnp, rec[postvoid, tsp.R["v_pending_lo"]],
                         rec[postvoid, tsp.R["v_pending_hi"]],
                         led.transfers.capacity, tsp.MAX_PROBE)
    probed = has(tsp.RB_LEGS) & ~has(tsp.RB_PCAND)
    for side in ("dr", "cr"):
        steps += probe_steps(anp, np.where(postvoid, rec[:, tsp.R["p_" + side + "_lo"]],
                                           rec[:, tsp.R["v_" + side + "_lo"]])[probed],
                             np.where(postvoid, rec[:, tsp.R["p_" + side + "_hi"]],
                                      rec[:, tsp.R["v_" + side + "_hi"]])[probed],
                             led.accounts.capacity, tsp.MAX_PROBE)
    keyed = has(tsp.RB_KKEY)
    steps += probe_steps(pnp, rec[keyed, tsp.R["key"]],
                         np.zeros(int(keyed.sum()), np.uint64),
                         led.posted.capacity, tsp.MAX_PROBE)

    def width(table, spec):
        return sum(table.cols[c].element_size() for _f, col, high in spec
                   for c in (col, high) if c is not None)

    leg_width = sum(led.accounts.cols[c].element_size() for c in ("flags", "ledger"))
    legs_found = int((has(tsp.RB_DRF) & probed).sum() + (has(tsp.RB_CRF) & probed).sum())
    gathered = (int(has(tsp.RB_PFOUND).sum()) * width(led.transfers, tsp._REC_P)
                + int(has(tsp.RB_EFOUND).sum()) * width(led.transfers, tsp._REC_E)
                + legs_found * leg_width
                + int(has(tsp.RB_KFOUND).sum()) * led.posted.cols["fulfillment"].element_size())
    accounts = int((to_np(pre["dslot"]) != -1).sum())
    balances = accounts * sum(led.accounts.cols[c].element_size()
                              for c in sm.BALANCE_COLS)
    answers = (count * (2 + 1 + 2 + 4 + 2) + int(postvoid.sum()) * (4 + 2)
               + int(has(tsp.RB_LEGS).sum()) * 2 * (4 + 2)
               + int(keyed.sum()) * (4 + 2 + 2) + accounts * 4)
    batch_bytes = sum(c.element_size() for c in soa.values()) * count
    return batch_bytes + 17 * steps + gathered + balances + answers


def seq_timing(r: dict, reps: int = 10) -> dict:
    """Device time per call of the kernel on the batch of run ``r``, each
    call from a copy of the ledger as it was before that batch."""
    from tigerbeetle_tpu_torch.ops import scan_path as tsp

    t = timed(lambda led: getattr(tsp, r["op"])(led, r["soa"], r["count"],
                                                 r["ts"]),
              reps=reps, setup=lambda: (clone_ledger(r["before"]),))
    return {"ms": t["device_ms"], "call_ms": t["call_ms"],
            "plain_ms": r["plain_ms"], "bound": bound(r["bytes"], 0),
            "chain_per_event": r["chain_per_event"],
            "probe_steps": r["probe_steps"], "row_gathers": r["row_gathers"],
            "events": r["count"]}


def sequencer_timing(r: dict, whole_ms: float, prepass_ms: float,
                     reps: int = 10) -> dict:
    """K6's sequencer launch alone on the batch of run ``r``: the
    profiler's device time of ``seq_transfers_kernel`` over calls of the
    path's K6 (K32, then the sequencer), each on a copy of the ledger as it
    was before that batch, made before the profiled window; a window in
    which the profiler recorded no sequencer launch is taken again, longer.
    If it records none again, K6's time less K32's (``whole_ms``,
    ``prepass_ms``, both by CUDA events), and the result says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tigerbeetle_tpu_torch.ops import scan_path as tsp

    def run(led):
        tsp.create_transfers_seq(led, r["soa"], r["count"], r["ts"])

    run(clone_ledger(r["before"]))
    for n in (reps, 3 * reps):
        ledgers = [clone_ledger(r["before"]) for _ in range(n)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for led in ledgers:
                run(led)
            torch.cuda.synchronize()
        us = calls = 0
        for e in prof.key_averages():
            if (e.device_type == DeviceType.CUDA
                    and e.key.startswith("seq_transfers_kernel")):
                us += e.self_device_time_total
                calls += e.count
        del ledgers
        if calls:
            return {"device_ms": us / 1e3 / calls,
                    "from": f"profiler, seq_transfers_kernel ({calls} of "
                            f"{n} launches recorded)"}
    return {"device_ms": whole_ms - prepass_ms,
            "from": "K6 less K32, CUDA events (the profiler recorded no "
                    "sequencer launch)"}


def mixed_times(r: dict) -> dict:
    """K6 on a mixed batch, with its sequencer alone."""
    whole = seq_timing(r)
    seq = sequencer_timing(r, whole["ms"], prepass_timing(r)["device_ms"])
    return dict(whole, sequencer_ms=seq["device_ms"], sequencer_ms_from=seq["from"])


def prepass_timing(r: dict) -> dict:
    """K32 alone on the batch of run ``r`` (it only reads the ledger)."""
    from tigerbeetle_tpu_torch.ops import scan_path as tsp

    return timed(lambda: tsp.seq_prepass(r["before"], r["soa"], r["count"],
                                         r["ts"]))


def phase_seq_kernels(seed: int, dev) -> dict:
    import torch
    from tigerbeetle_tpu_torch import convert, types
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import scan_path as tsp
    from tigerbeetle_tpu_torch.ops import state_machine as sm
    from tigerbeetle_tpu_torch.testing import k7cases, seqmix, seqtraps
    from tigerbeetle_tpu_torch.utils.benchgen import gen_two_phase_np

    rng = np.random.default_rng(seed + 2)
    _cuda.reset_counts()
    gpu, prefilled_pending = seq_prepared_ledger(rng, dev)
    torch.cuda.synchronize()
    prep_launches = _cuda.counts()
    mixed = SeqPair(gpu, SEQ_LANES)

    # -- the mix: K7 on a fresh batch, then one with existing ids, chains
    #    and repeats; K6 on four batches, the last at timestamps near 2**64 --
    acc_runs = [mixed.run("create_accounts_seq",
                          seqmix.accounts_batch(rng, 1, 2000), 10 ** 9),
                mixed.run("create_accounts_seq",
                          seqmix.accounts_batch(rng, 1800, 2040), 2 * 10 ** 9)]
    mix = seqmix.TransferMix(rng, list(range(1, SEQ_ACCOUNTS + 1)), 1 << 52)
    mix.pending.extend(prefilled_pending[:500])
    tr_runs = []
    for b in range(4):
        ts = (1 << 64) - 10 ** 10 if b == 3 else (b + 3) * 10 ** 9
        batch = mix.batch(SEQ_LANES - 2)
        if b == 3:
            batch[-1] = types.transfer(id=1 << 70, debit_account_id=1,
                                       credit_account_id=7, amount=1,
                                       ledger=1, code=10,
                                       flags=int(types.TransferFlags.PENDING),
                                       timeout=100)
        tr_runs.append(mixed.run("create_transfers_seq", batch, ts))
    for need in (0, 1, 25, 33, 35, 53, 54):
        if need not in mixed.codes_seen:
            raise AssertionError(f"seq_kernels: the mix produced no code {need}")

    # -- the sequential path's shapes: 8,190 new accounts (K7), then two
    #    batches of bench.py's two-phase shape (K6), on the default ledger
    #    capacities --
    path = SeqPair(sm.make_ledger(1 << 16, 1 << 18, 1 << 16, 1 << 16,
                                  device=dev), LANES)
    path_acc = path.run("create_accounts_seq", types.accounts_array(
        [types.account(id=i, ledger=1, code=10) for i in range(1, COUNT + 1)]),
        10 ** 9)
    path_tr = [path.run("create_transfers_seq",
                        gen_two_phase_np(b, LANES, COUNT, COUNT, 1 << 32),
                        (b + 2) * 10 ** 9) for b in range(2)]
    if path.codes_seen != {0}:
        raise AssertionError(f"seq_kernels: path codes {path.codes_seen}")

    # -- the split form's traps at 8,190 events (testing/seqtraps.py): K32
    #    and K6 on the card against the split plain form on CPU copies --
    traps = {}
    for trap in seqtraps.TRAPS:
        case = seqtraps.trap_case(trap, COUNT, dev)
        gled = case["ledger"]
        cled = clone_ledger(gled, "cpu")
        sg = convert.batch_to_tensors(case["batch"], LANES, dev)
        sc = convert.batch_to_tensors(case["batch"], LANES, "cpu")
        count, ts = case["count"], case["ts"]
        pk = tsp.seq_prepass(gled, sg, count, ts)
        pp = tsp.seq_prepass_plain(cled, sc, count, ts)
        perr = max_abs_err(f"seq_prepass ({trap})",
                           {k: to_np(v) for k, v in pk.items()},
                           {k: to_np(v) for k, v in pp.items()})
        _, kc, kov = tsp.create_transfers_seq(gled, sg, count, ts)
        _, pc, pov = tsp.create_transfers_seq_split_plain(cled, sc, count, ts)
        err = max_abs_err(f"seq_transfers ({trap})",
                          {"codes": to_np(kc), "overflow": to_np(kov),
                           **ledger_np(gled)},
                          {"codes": to_np(pc), "overflow": to_np(pov),
                           **ledger_np(cled)})
        if bool(kov) != (trap == "probe_cap"):
            raise AssertionError(f"seq_kernels: {trap} overflow {bool(kov)}")
        traps[trap] = {"events": count, "prepass_err": perr, "err": err,
                       "overflow": bool(kov),
                       "codes": sorted(set(to_np(kc)[:count].tolist()))}
        del case, gled, cled

    # -- K7's traps (testing/k7cases.py), new distinct ids at 16,384 lanes
    #    among them: the card against the split plain form on CPU copies --
    k7 = {}
    for name in k7cases.CASES:
        n = 16384 if name in k7cases.SIZED else k7cases.LANES
        case = k7cases.case(name, n)
        pristine = clone_ledger(case["ledger"], dev)
        gled = clone_ledger(pristine)
        cled = case["ledger"]
        sg = SeqPair(gled, case["lanes"]).soa(case["batch"], dev)
        sc = SeqPair(cled, case["lanes"]).soa(case["batch"], "cpu")
        _, kc, kov = tsp.create_accounts_seq(gled, sg, case["count"], case["ts"])
        _, pc, pov = tsp.create_accounts_seq_split_plain(cled, sc, case["count"],
                                                         case["ts"])
        err = max_abs_err(f"seq_accounts ({name}, {n} events)",
                          {"codes": to_np(kc), "overflow": to_np(kov),
                           **ledger_np(gled)},
                          {"codes": to_np(pc), "overflow": to_np(pov),
                           **ledger_np(cled)})
        if bool(kov) != case["overflow"]:
            raise AssertionError(f"seq_kernels: K7 {name} overflow {bool(kov)}")
        k7[name] = {"events": case["count"], "err": err,
                    "codes": sorted(set(to_np(kc)[:case["count"]].tolist()))}
        if name in k7cases.SIZED:
            k7[name]["ms"] = timed(
                lambda led: tsp.create_accounts_seq(led, sg, case["count"],
                                                    case["ts"]),
                reps=5, setup=lambda: (clone_ledger(pristine),))["device_ms"]
        del case, pristine, gled, cled

    results = {}
    row = seq_timing(path_acc)
    mixed_acc = seq_timing(acc_runs[1])
    results["seq_accounts"] = dict(
        max_abs_err=max([x["err"] for x in acc_runs + [path_acc]]
                        + [v["err"] for v in k7.values()]),
        ms=row["ms"], call_ms=row["call_ms"], plain_ms=row["plain_ms"],
        plain_where="cpu (Python loop over the events, host wall ms)",
        library_ms=None, bound=row["bound"],
        chain_per_event=row["chain_per_event"],
        shape=f"{row['events']} events of the sequential path's shape",
        mixed_2048=mixed_acc, ms_mixed_2040=mixed_acc["ms"],
        ms_16384=k7["new_distinct"]["ms"], traps=k7,
        parent_ms=K7_PARENT_MS, info=_cuda.seq_accounts_info(COUNT),
        clock=phase_clock().split(
            "seq_accounts", lambda: tsp.create_accounts_seq(
                clone_ledger(path_acc["before"]), path_acc["soa"],
                path_acc["count"], path_acc["ts"])),
    )
    at_path = path_tr[1]
    whole = seq_timing(at_path)
    pre = prepass_timing(at_path)
    seq = sequencer_timing(at_path, whole["ms"], pre["device_ms"])
    results["seq_transfers"] = dict(
        max_abs_err=max([x["err"] for x in tr_runs + [at_path]]
                        + [t["err"] for t in traps.values()]),
        ms=seq["device_ms"], call_ms=whole["call_ms"],
        ms_with_prepass=whole["ms"], plain_ms=whole["plain_ms"],
        plain_where="cpu (the serial plain loop over the events, host wall ms)",
        library_ms=None, bound=whole["bound"],
        chain_per_event=whole["chain_per_event"],
        ms_from=seq["from"],
        shape=f"{whole['events']} events of the sequential path's shape; ms: "
              "the sequencer launch alone; ms_with_prepass and call_ms: K32 "
              "and the sequencer, as the path calls them",
        mixed_2048=mixed_times(tr_runs[1]),
        traps=traps,
    )
    results["seq_prepass"] = dict(
        max_abs_err=max([x["prepass"]["err"] for x in tr_runs + [at_path]]
                        + [t["prepass_err"] for t in traps.values()]),
        ms=pre["device_ms"], call_ms=pre["call_ms"],
        plain_ms=at_path["prepass"]["plain_ms"],
        plain_where="cpu (vectorized probes, Python joins; host wall ms)",
        library_ms=None, bound=bound(at_path["prepass"]["bytes"], 0),
        shape=f"{at_path['count']} events of the sequential path's shape "
              "(three launches: probe, join, link)",
        mixed_2048_ms=prepass_timing(tr_runs[1])["device_ms"],
    )

    # -- K8: random slots (some out of range, some repeated), some invalid --
    xfr = gpu.transfers
    cap = xfr.capacity
    live = np.flatnonzero(to_np(xfr.key_lo) != 0)
    slots = rng.choice(live, SEQ_LANES).astype(np.int64)
    slots[rng.random(SEQ_LANES) < 0.02] = cap + 5
    slot_t = torch.from_numpy(slots).to(dev)
    valid = torch.from_numpy(rng.random(SEQ_LANES) < 0.8).to(dev)
    tk, tp = clone_table(xfr), clone_table(xfr)
    ht.remove_to_tombstone(tk, slot_t, valid)
    ht.remove_to_tombstone_plain(tp, slot_t, valid)
    err = max_abs_err("tombstone", table_np(tk), table_np(tp))
    n_valid = int(valid.sum())
    results["tombstone"] = dict(
        max_abs_err=err,
        **pair_times(
            timed(lambda t: ht.remove_to_tombstone(t, slot_t, valid),
                  setup=lambda: (clone_table(xfr),)),
            timed(lambda t: ht.remove_to_tombstone_plain(t, slot_t, valid),
                  setup=lambda: (clone_table(xfr),))),
        plain_where="cuda",
        library_ms=None,
        # The valid flag of every lane; the slot of each valid lane and 17 B
        # written at it; the count read and written.
        bound=bound(SEQ_LANES + n_valid * (8 + 17) + 16, 4 * SEQ_LANES),
        shape=f"{SEQ_LANES} lanes ({n_valid} valid) on a table of 2^15",
    )
    torch.cuda.synchronize()
    return {"results": results, "prep_launches": prep_launches,
            "codes_seen": sorted(mixed.codes_seen)}


# ---------------------------------------------------------------------------
# phase 7: the sequential machine against the scalar oracle at full width
# ---------------------------------------------------------------------------


def phase_seq_parity(seed: int, dev) -> dict:
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine
    from tigerbeetle_tpu_torch.testing import model as M
    from tigerbeetle_tpu_torch.testing import seqmix

    rng = np.random.default_rng(seed + 3)
    cfg = LedgerConfig(accounts_capacity_log2=14, transfers_capacity_log2=14,
                       posted_capacity_log2=12, history_capacity_log2=12)
    m = TorchStateMachine(cfg, batch_lanes=LANES, device=dev,
                          force_sequential=True)
    ref = M.ReferenceStateMachine()
    wall = 10 ** 9
    ab = seqmix.accounts_batch(rng, 1, COUNT)
    got = m.create_accounts(ab, wall_clock_ns=wall)
    if got != ref.create_accounts(M.accounts_from_batch(ab), wall):
        raise AssertionError("seq_parity: accounts")
    failed = len(got)
    mix = seqmix.TransferMix(rng, list(ref.accounts)[:SEQ_ACCOUNTS], 1 << 40)
    walls = [wall + 10 ** 9 * (b + 1) for b in range(3)] + [(1 << 64) - 10 ** 12]
    codes = set()
    for b, w in enumerate(walls):
        tb = mix.batch(COUNT)
        got = m.create_transfers(tb, wall_clock_ns=w)
        if got != ref.create_transfers(M.transfers_from_batch(tb), w):
            raise AssertionError(f"seq_parity: transfers batch {b}")
        failed += len(got)
        codes.update(c for _, c in got)
    if m.balances_snapshot() != ref.balances_snapshot():
        raise AssertionError("seq_parity: balances")
    ids = sorted(set(mix.used))
    rows = m.lookup_transfers(ids)
    if [M.transfer_from_row(r) for r in rows] != ref.lookup_transfers(ids):
        raise AssertionError("seq_parity: lookup_transfers")
    if int(m.ledger.history.count.item()) != len(ref.history):
        raise AssertionError("seq_parity: history count")
    wide = seq_wide_machine(rng, dev, cfg)
    return {"batches": 1 + len(walls), "events_per_batch": COUNT,
            "failed_events_matched": failed, "transfers_looked_up": len(ids),
            "history_rows": len(ref.history), "posted_rows": len(ref.posted),
            "codes_seen": sorted(codes), "wide_lanes": wide}


def seq_wide_machine(rng, dev, cfg) -> dict:
    """C7: a force_sequential machine of 16,384 lanes (twice the
    sequencer's overlay) on the card commits a one-transfer batch with no
    failure, as the JAX package's machine answers, then an 8,190-event
    batch of the mix as the scalar oracle does: K6 runs the lanes up to
    the count."""
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.machine import TorchStateMachine
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.testing import model as M
    from tigerbeetle_tpu_torch.testing import seqmix

    lanes = 2 * _cuda.SEQ_MAX_N
    m = TorchStateMachine(cfg, batch_lanes=lanes, device=dev,
                          force_sequential=True)
    ref = M.ReferenceStateMachine()
    ab = seqmix.accounts_batch(rng, 1, COUNT, faults=False)
    if m.create_accounts(ab, 10 ** 9) != [] or ref.create_accounts(
            M.accounts_from_batch(ab), 10 ** 9) != []:
        raise AssertionError("seq_parity (16,384 lanes): accounts")
    dr, cr = (int(i) for i in ab["id_lo"][ab["flags"] == 0][:2])
    one = types.transfers_array([types.transfer(
        id=1 << 60, debit_account_id=dr, credit_account_id=cr, amount=1,
        ledger=1, code=1)])
    seq_before = _cuda.KERNELS["seq_transfers"].launches
    got = m.create_transfers(one, 2 * 10 ** 9)
    want = ref.create_transfers(M.transfers_from_batch(one), 2 * 10 ** 9)
    if got != [] or want != []:
        raise AssertionError(f"seq_parity (16,384 lanes): one transfer {got} "
                             f"(oracle {want})")
    mix = seqmix.TransferMix(rng, list(ref.accounts)[:SEQ_ACCOUNTS], 1 << 40)
    tb = mix.batch(COUNT)
    got = m.create_transfers(tb, 3 * 10 ** 9)
    if got != ref.create_transfers(M.transfers_from_batch(tb), 3 * 10 ** 9):
        raise AssertionError("seq_parity (16,384 lanes): the mix batch")
    if m.balances_snapshot() != ref.balances_snapshot():
        raise AssertionError("seq_parity (16,384 lanes): balances")
    launched = _cuda.KERNELS["seq_transfers"].launches - seq_before
    if launched != 2:
        raise AssertionError(f"seq_parity (16,384 lanes): K6 launched {launched}")
    return {"lanes": lanes, "events": [1, COUNT], "failed_events_matched":
            len(got), "k6_launches": launched}


# ---------------------------------------------------------------------------
# phase 8: the sequential path at full width (bench.py --two-phase)
# ---------------------------------------------------------------------------


def phase_sequential(dev, n_transfers: int) -> dict:
    # Time every table growth on the card (a synchronize on each side of
    # each rehash; growths are rare, so the rest of the run is untouched).
    grows = []
    with timed_grows(grows):
        return _sequential_run(dev, n_transfers, grows)


def _sequential_run(dev, n_transfers: int, grows: list) -> dict:
    import torch
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine
    from tigerbeetle_tpu_torch.ops import state_machine as sm
    from tigerbeetle_tpu_torch.utils.benchgen import gen_two_phase_np

    batch_max = 8190
    torch.cuda.reset_peak_memory_stats()
    m = TorchStateMachine(LedgerConfig(lazy_index=True), batch_lanes=LANES,
                          device=dev,
                          force_sequential=True)
    caps0 = (m.ledger.transfers.capacity, m.ledger.posted.capacity)
    for start in range(0, N_ACCOUNTS, batch_max):
        ids = range(start + 1, min(N_ACCOUNTS, start + batch_max) + 1)
        batch = types.accounts_array(
            [types.account(id=i, ledger=1, code=10) for i in ids])
        if m.create_accounts(batch) != []:
            raise AssertionError("sequential: account creation failed")

    posted = np.zeros(N_ACCOUNTS + 1, np.uint64)
    credited = np.zeros(N_ACCOUNTS + 1, np.uint64)
    # Full batches only (bench.py's generator numbers ids by batch): at
    # least n_transfers transfers.
    n_batches = max(1, (n_transfers + batch_max - 1) // batch_max)
    window = range(n_batches - 1 - PROFILE_BATCHES, n_batches - 1)
    if window.start < 0:
        window = range(0)
    commit_s = 0.0
    n_timed = 0
    steady_s = 0.0
    n_steady = 0
    prof_commit_ms = 0.0
    grow_batches_ms = []
    prof = None
    for b in range(n_batches):
        batch = gen_two_phase_np(b, LANES, batch_max, N_ACCOUNTS, 1 << 32)
        caps = (m.ledger.transfers.capacity, m.ledger.posted.capacity)
        if window and b == window.start:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        res = m.create_transfers(batch)
        dt = time.perf_counter() - t0
        grew = (m.ledger.transfers.capacity, m.ledger.posted.capacity) != caps
        if grew:
            grow_batches_ms.append(
                {"batch": b, "ms": dt * 1e3,
                 "capacities": [m.ledger.transfers.capacity,
                                m.ledger.posted.capacity]})
        if b in window:
            prof_commit_ms += dt * 1e3
        else:
            commit_s += dt
            n_timed += len(batch)
            if not grew:
                steady_s += dt
                n_steady += 1
        if window and b == window.stop - 1:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
        if res:
            raise AssertionError(f"sequential: batch {b} had failures {res[:5]}")
        half = len(batch) // 2
        pend = batch[:half]
        np.add.at(posted, pend["debit_account_id_lo"].astype(np.int64),
                  pend["amount_lo"])
        np.add.at(credited, pend["credit_account_id_lo"].astype(np.int64),
                  pend["amount_lo"])
    torch.cuda.synchronize()

    rows = m.lookup_accounts(list(range(1, N_ACCOUNTS + 1)))
    if len(rows) != N_ACCOUNTS:
        raise AssertionError("sequential: lookup lost accounts")
    order = rows["id_lo"].astype(np.int64)
    for name, want in (("debits_posted", posted), ("credits_posted", credited)):
        if (not np.array_equal(rows[name + "_lo"], want[order])
                or rows[name + "_hi"].any()):
            raise AssertionError(f"sequential: {name} differs from the closed form")
    for name in ("debits_pending", "credits_pending"):
        if rows[name + "_lo"].any() or rows[name + "_hi"].any():
            raise AssertionError(f"sequential: {name} not zero")
    digest = m.digest()
    a = m.ledger.accounts
    plain = sm.ledger_digest_plain(
        a.key_lo, a.key_hi,
        [a.cols[c] for c in sm.BALANCE_COLS] + [a.cols["timestamp"]])
    if digest != int(plain.item()) & ((1 << 64) - 1):
        raise AssertionError("sequential: digest differs from its plain version")
    committed = int(m.ledger.transfers.count.item())
    if committed != n_batches * batch_max:
        raise AssertionError(f"sequential: transfers count {committed}")
    profile = None
    if prof is not None:
        by_name = {}
        busy = device_us(prof, by_name) / 1e3
        if busy <= 0:
            raise AssertionError("sequential: the profile recorded no device time")
        steady_ms = steady_s * 1e3 / n_steady if n_steady else None
        profile = {
            "batches": len(window), "commit_wall_ms": prof_commit_ms,
            "device_busy_ms": busy,
            "device_idle_share": 1 - busy / prof_commit_ms,
            "unprofiled_batches": n_steady,
            "unprofiled_wall_ms_per_batch": steady_ms,
            "device_idle_share_unprofiled":
                1 - busy / len(window) / steady_ms if steady_ms else None,
            "device_ms_per_batch_by_name": {
                k: v / 1e3 / len(window) for k, v in sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:8]},
        }
    return {
        "accounts": N_ACCOUNTS, "transfers": committed, "batches": n_batches,
        "capacities_before": caps0,
        "capacities_after": [m.ledger.transfers.capacity,
                             m.ledger.posted.capacity],
        "posted_rows": int(m.ledger.posted.count.item()),
        "grow_batches": grow_batches_ms,
        "table_grows": grows,
        "commit_s_unprofiled": commit_s,
        "transfers_per_s": n_timed / commit_s,
        "wall_ms_per_batch_unprofiled": commit_s * 1e3 / max(
            1, n_batches - len(window)),
        "profile": profile,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "digest": digest,
    }


# ---------------------------------------------------------------------------
# phase 9: the general kernel's kernels (K9-K12, K2's claim/write) against
# their plain versions
# ---------------------------------------------------------------------------

FULL_PATH = ("probe", "claim", "write_claimed", "full_index", "full_legs",
             "full_pass", "full_waves")
FULL_ACCOUNTS = COUNT  # accounts the general mix draws from: every account
# K11 a core and K12 a call before their multi-block redesign, as PERF.md
# records them (NVIDIA H100 80GB HBM3, 700 W): printed in the phase's line
# beside the new figures, never in the kernels line (not measured here).
K11_PERF_MD_WAS_MS = 0.997
K12_PERF_MD_WAS_MS = 0.354
# K10 before its redesign over the card, one block sorting 16,384 keys
# itself (no cache), a launch at this phase's shape, as PERF.md records
# it (NVIDIA H100 80GB HBM3, 700 W): printed in the phase's line beside the
# new figures, never in the kernels line (not measured here).
K10_PARENT_MS = 0.441


def full_prepared_ledger(rng, dev):
    """A ledger on the card built through the default machine: 8,190
    accounts (seqmix's limit and history flags), four 8,190-event batches
    of the general mix (pendings in the table, posted rows, history rows),
    64 same-home clusters of 6 transfers and 256 tombstones in the
    transfers table (K2, K8), then the ``big`` accounts' pendings near
    2**128 (fullmix.seed_big)."""
    import torch
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import state_machine as sm
    from tigerbeetle_tpu_torch.testing import fullmix, seqmix

    cfg = LedgerConfig(accounts_capacity_log2=14, transfers_capacity_log2=16,
                       posted_capacity_log2=14, history_capacity_log2=15)
    m = TorchStateMachine(cfg, batch_lanes=LANES, device=dev)
    m.create_accounts(seqmix.accounts_batch(rng, 1, COUNT, faults=False), 10 ** 9)
    mix = fullmix.GeneralMix(rng, list(range(1, FULL_ACCOUNTS + 1)), 1 << 41)
    wall = 2 * 10 ** 9
    for _ in range(4):
        res = m.create_transfers(mix.batch(COUNT), wall)
        mix.settle(i for i, _ in res)
        wall += 10 ** 9
    xfr = m.ledger.transfers
    cap = xfr.capacity
    keys = same_home_groups(rng, cap, 64, 6, 1 << 45)
    n = len(keys)
    rows = {k: (t64(rand_u64(rng, n, 1 << 20), dev) if dt == torch.int64
                else t32(rng.integers(0, 3, n), dev))
            for k, dt in sm.TRANSFER_COLS.items()}
    ht.insert(xfr, t64(keys, dev), torch.zeros(n, dtype=torch.int64, device=dev),
              torch.ones(n, dtype=torch.bool, device=dev), rows, sm.MAX_PROBE)
    live = np.flatnonzero(to_np(xfr.key_lo) != 0)
    gone = torch.from_numpy(rng.choice(live, 256, replace=False)).to(dev)
    ht.remove_to_tombstone(xfr, gone, torch.ones(256, dtype=torch.bool, device=dev))
    m.create_transfers(mix.seed_big(), wall)
    return m, mix, wall


def full_plain(ledger, soa, count, ts, max_passes=8, has_postvoid=True,
               has_history=True, use_waves=True):
    """create_transfers_full_impl with the plain versions of K9-K12 and of
    K2's claim/write (K1 probes, already held against its plain version)."""
    import torch
    from tigerbeetle_tpu_torch.ops import transfer_full as tf

    n = soa["id_lo"].shape[0]
    valid = torch.arange(n, device=soa["id_lo"].device) < count
    flags = soa["flags"]
    postvoid = ((flags & (tf.TF_POST | tf.TF_VOID)) != 0) & valid
    ctx = tf.build_gather_ctx(ledger, soa, valid, postvoid,
                              has_postvoid=has_postvoid)
    plan = tf._kernel_core_plain(ctx, soa, count, ts, max_passes, has_postvoid,
                                 use_waves)
    kflags = tf._apply_plain(ledger, soa, ctx, plan, has_postvoid, has_history)
    wave = torch.cat([plan.passes.reshape(1), plan.wave_bound.reshape(1),
                      plan.wave_hist])
    return ledger, plan.codes, kflags, wave


def full_inputs(ledger, soa, count, has_postvoid=True):
    """The kernels' inputs on one batch: its gather context, id index, wave
    inputs and the legs of an iterate where every valid lane is ok."""
    import torch
    from tigerbeetle_tpu_torch.ops import transfer_full as tf

    n = soa["id_lo"].shape[0]
    dev = soa["id_lo"].device
    valid = torch.arange(n, device=dev) < count
    flags = soa["flags"]
    postvoid = ((flags & (tf.TF_POST | tf.TF_VOID)) != 0) & valid
    ctx = tf.build_gather_ctx(ledger, soa, valid, postvoid,
                              has_postvoid=has_postvoid)
    idx = tf._build_id_index_plain(soa["id_lo"], soa["id_hi"],
                                   soa["pending_id_lo"], soa["pending_id_hi"])
    waves = tf._wave_inputs(ctx, soa, count, has_postvoid, idx)
    pick = lambda own, pv: torch.where(postvoid, pv, own)  # noqa: E731
    legs = dict(
        start_bal={k: tf._interleave(pick(ctx.drT.bal[k], ctx.pdr.bal[k]),
                                     pick(ctx.crT.bal[k], ctx.pcr.bal[k]))
                   for k in tf._BAL_COLS},
        cap_sentinel=ctx.accounts_capacity, ok_lanes=valid,
        amt_lo=soa["amount_lo"], pamt_lo=ctx.p_tab["amount_lo"],
        dr_slot=pick(ctx.drT.slot, ctx.pdr.slot),
        cr_slot=pick(ctx.crT.slot, ctx.pcr.slot),
        dr_live=pick(ctx.drT.found, ctx.pdr.found),
        cr_live=pick(ctx.crT.found, ctx.pcr.found),
        pending_f=((flags & tf.TF_PENDING) != 0) & valid,
        post=((flags & tf.TF_POST) != 0) & valid, postvoid=postvoid,
        has_postvoid=has_postvoid)
    return ctx, idx, waves, legs, valid


def soa_of(batch, dev):
    from tigerbeetle_tpu_torch import convert, types

    padded = np.zeros(LANES, dtype=batch.dtype)
    padded[: len(batch)] = batch
    return convert.soa_to_tensors(types.to_soa(padded), dev)


def nbytes(*tensors) -> int:
    out = 0
    for t in tensors:
        if isinstance(t, dict):
            out += nbytes(*t.values())
        elif isinstance(t, (list, tuple)):
            out += nbytes(*t)
        elif hasattr(t, "numel"):
            out += t.numel() * t.element_size()
    return out


def profile_by_name(fn, reps=5):
    """Device ms per call of ``fn`` by kernel name, and launches per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            out[e.key[:60]] = (e.self_device_time_total / 1e3 / reps,
                               e.count / reps)
    return out


def kernel_ms(by_name, prefix):
    total = sum(v[0] for k, v in by_name.items() if k.startswith(prefix))
    calls = sum(v[1] for k, v in by_name.items() if k.startswith(prefix))
    return total, calls


def host_queue_ms(fn, reps: int = 20) -> float:
    """The host's time to queue one call of ``fn``, the calls queued behind
    a GPU spin (so no call waits on the card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(100 * SPIN_CYCLES_PER_MS))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queued = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return queued


def core_times(ledger, soa, count, ts) -> dict:
    """The general kernel core on one batch with waves, at its pass budget
    (K9, K12, then every K11 and K10 launch of the Jacobi loop and the aux
    pass, as transfer_full._kernel_core queues them), and K12 alone at that
    budget and with no relaxation round (its sort and run ids alone), each
    by CUDA events behind a spin (``timed``); the host's time to queue one
    core; the core's launches by kernel (the wrappers' counts), a profile
    by kernel name, the core's plan and the kernels' inputs."""
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import transfer_full as tf

    ctx, idx, waves, legs, valid = full_inputs(ledger, soa, count)
    cap = ctx.accounts_capacity
    core = lambda: tf._kernel_core(ctx, soa, count, ts, use_waves=True)  # noqa: E731
    before = _cuda.counts()
    plan = core()
    made = {k: v - before[k] for k, v in _cuda.counts().items() if v > before[k]}
    return {
        "core": timed(core), "core_host_ms": host_queue_ms(core),
        "k12": timed(lambda: tf._wave_schedule(*waves, valid, cap,
                                               tf._MAX_PASSES)),
        "k12_no_rounds": timed(lambda: tf._wave_schedule(*waves, valid, cap,
                                                         0)),
        "launches": made, "profile": profile_by_name(core), "plan": plan,
        "inputs": (ctx, idx, waves, legs, valid)}


def phase_full_kernels(seed: int, dev) -> dict:
    import torch
    from tigerbeetle_tpu_torch import convert, types
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import state_machine as sm
    from tigerbeetle_tpu_torch.ops import transfer_full as tf
    from tigerbeetle_tpu_torch.testing import fullmix, fulltraps, k9cases, k10cases
    from tigerbeetle_tpu_torch.utils.benchgen import gen_two_phase_np

    rng = np.random.default_rng(seed + 4)
    m, mix, wall = full_prepared_ledger(rng, dev)
    errs = {k: 0 for k in ("full_index", "full_legs", "full_waves",
                           "full_pass", "claim", "write_claimed")}
    checked = []
    kinds = ["general", "general"] + list(fullmix.SEQ_REASONS)
    for b, kind in enumerate(kinds):
        batch = mix.batch(COUNT, kind)
        ts = wall + 10 ** 9 * (b + 1)
        soa = soa_of(batch, dev)
        # K9, K10, K12 on their own, on this batch's inputs.
        ctx, idx, waves, legs, valid = full_inputs(m.ledger, soa, COUNT)
        k9 = tf._build_id_index(soa["id_lo"], soa["id_hi"], soa["pending_id_lo"],
                                soa["pending_id_hi"])
        errs["full_index"] = max(errs["full_index"], max_abs_err(
            f"full_index ({kind})", {f: to_np(v) for f, v in k9._asdict().items()},
            {f: to_np(v) for f, v in idx._asdict().items()}))
        kl = tf._leg_balances(**legs)
        pl = tf._leg_balances_plain(**legs)
        errs["full_legs"] = max(errs["full_legs"], max_abs_err(
            f"full_legs ({kind})", legs_np(kl), legs_np(pl)))
        kw = tf._wave_schedule(*waves, valid, ctx.accounts_capacity,
                               tf._MAX_PASSES)
        pw = tf._wave_schedule_plain(*waves, valid, ctx.accounts_capacity,
                                     tf._MAX_PASSES)
        errs["full_waves"] = max(errs["full_waves"], max_abs_err(
            f"full_waves ({kind})", {str(i): to_np(v) for i, v in enumerate(kw)},
            {str(i): to_np(v) for i, v in enumerate(pw)}))
        # The whole kernel: the general batches at pass budgets 1, 2, 3 and 8
        # (every iterate up to the third), waves on and off; the FLAG_SEQ
        # batches at 8: codes, kflags, the wave vector and the applied
        # ledger.
        budgets = (1, 2, 3, 8) if kind == "general" else (8,)
        for max_passes in budgets:
            for waves_on in ((True, False) if kind == "general" else (True,)):
                gk, gp = clone_ledger(m.ledger), clone_ledger(m.ledger)
                rk = tf.create_transfers_full_impl(
                    gk, soa, COUNT, ts, max_passes=max_passes,
                    use_waves=waves_on)
                rp = full_plain(gp, soa, COUNT, ts, max_passes=max_passes,
                                use_waves=waves_on)
                got = {"codes": to_np(rk[1]), "kflags": to_np(rk[2]),
                       **ledger_np(gk)}
                want = {"codes": to_np(rp[1]), "kflags": to_np(rp[2]),
                        **ledger_np(gp)}
                if waves_on:
                    got["wave"], want["wave"] = to_np(rk[3]), to_np(rp[3])
                err = max_abs_err(f"full kernel ({kind}, {max_passes} passes, "
                                  f"waves {waves_on})", got, want)
                for k in ("full_pass", "claim", "write_claimed"):
                    errs[k] = max(errs[k], err)
                checked.append((kind, max_passes, waves_on,
                                int(to_np(rk[2]))))
                del gk, gp
        res = m.create_transfers(batch, ts)
        mix.settle(i for i, _ in res)
    routed = {kind: [k for kd, mp, w, k in checked if kd == kind and mp == 8]
              for kind in kinds}
    for kind in fullmix.SEQ_REASONS:
        if not all(k & tf.FLAG_SEQ for k in routed[kind]):
            raise AssertionError(f"full_kernels: {kind} batch not flagged FLAG_SEQ")
    if not all(k == 0 for k in routed["general"]):
        raise AssertionError(f"full_kernels: a general batch was flagged {routed}")

    # -- the traps: each batch-wide step of K11 and K12 across their blocks
    #    (testing/fulltraps.py), and a lane count that is not a multiple of
    #    K11's block of 64 --
    traps = {}
    k10_before = legs_stats_now(dev)
    for b, (trap, lanes) in enumerate(
            [(t, LANES) for t in fulltraps.TRAPS] + [("cross_chain", LANES - 42)]):
        count = lanes - 2
        batch = fulltraps.trap_batch(mix, trap, count)
        padded = np.zeros(lanes, dtype=batch.dtype)
        padded[:count] = batch
        tsoa = convert.soa_to_tensors(types.to_soa(padded), dev)
        ts = wall + 10 ** 10 * (b + 1)
        for max_passes, waves_on in ((8, True), (2, True), (8, False)):
            gk, gp = clone_ledger(m.ledger), clone_ledger(m.ledger)
            rk = tf.create_transfers_full_impl(gk, tsoa, count, ts,
                                               max_passes=max_passes,
                                               use_waves=waves_on)
            rp = full_plain(gp, tsoa, count, ts, max_passes=max_passes,
                            use_waves=waves_on)
            got = {"codes": to_np(rk[1]), "kflags": to_np(rk[2]), **ledger_np(gk)}
            want = {"codes": to_np(rp[1]), "kflags": to_np(rp[2]), **ledger_np(gp)}
            if waves_on:
                got["wave"], want["wave"] = to_np(rk[3]), to_np(rp[3])
            err = max_abs_err(f"full kernel trap {trap} ({lanes} lanes, "
                              f"{max_passes} passes, waves {waves_on})",
                              got, want)
            for k in ("full_pass", "full_waves", "claim", "write_claimed"):
                errs[k] = max(errs[k], err)
            if (max_passes, waves_on) == (8, True):
                # The batch must reach its trap's condition across the
                # blocks (raises if it does not).
                traps[f"{trap}/{lanes}"] = {
                    "kflags": int(want["kflags"]), "wave": want["wave"].tolist(),
                    "codes": sorted(set(want["codes"][:count].tolist())),
                    "reached": fulltraps.trap_facts(trap, m.ledger, padded,
                                                    count, want["codes"])}
            del gk, gp
    k10_traps_stats = stats_since(dev, k10_before)

    # -- times and bounds at the path's shape: a bench.py two-phase batch --
    led = m.ledger
    batch = gen_two_phase_np(0, LANES, COUNT, COUNT, 1 << 50)
    soa = soa_of(batch, dev)
    ts = wall + 10 ** 11
    ct = core_times(led, soa, COUNT, ts)
    ctx, idx, waves, legs, valid = ct["inputs"]
    results = {}
    ids = (soa["id_lo"], soa["id_hi"], soa["pending_id_lo"], soa["pending_id_hi"])
    stacked = torch.stack([soa["id_hi"], soa["id_lo"]], 1)
    # K9's traps (testing/k9cases.py) at full width, byte for byte.
    for case in k9cases.CASES:
        for n in (COUNT, LANES):
            args = [t64(a, dev) for a in k9cases.case(case, n)]
            errs["full_index"] = max(errs["full_index"], max_abs_err(
                f"full_index ({case}, {n} lanes)",
                {f: to_np(v) for f, v in tf._build_id_index(*args)._asdict().items()},
                {f: to_np(v) for f, v in
                 tf._build_id_index_plain(*args)._asdict().items()}))
    results["full_index"] = dict(
        max_abs_err=errs["full_index"],
        **pair_times(timed(lambda: tf._build_id_index(*ids)),
                     timed(lambda: tf._build_id_index_plain(*ids))),
        library_ms=timed(lambda: torch.unique(stacked, dim=0,
                                              return_inverse=True))["device_ms"],
        bound=bound(nbytes(*ids) + LANES * (8 + 1 + 8) + 1, 20 * LANES),
        shape=f"{LANES} lanes of a two-phase batch; library: torch.unique "
              "of the (hi, lo) id pairs with return_inverse",
        launch=_cuda.full_index_info(LANES),
        phases_us=phase_clock().split(
            "full_index", lambda: tf._build_id_index(*ids)),
        cases_checked=len(k9cases.CASES) * 2,
        parent_ms_perf_md=K9_PARENT_MS)
    # K10's traps (testing/k10cases.py) at full width against the split
    # plain form on the card, byte for byte, with the cache each leaves.
    for name in k10cases.CASES:
        for n in (LANES, COUNT):
            args, cache = k10cases.case(name, n)
            ga, gc = k10cases.to_tensors(args, cache, dev)
            pa, pc = k10cases.to_tensors(args, cache, dev)
            got = legs_np(k10_call(ga, gc))
            want = legs_np(tf._leg_balances_split_plain(**pa, cache=pc))
            if gc is not None:
                for k, x, y in zip(("keys", "slots", "ok"), gc, pc):
                    got["cache." + k] = to_np(x[:2 * n] if k == "keys" else x)
                    want["cache." + k] = to_np(y[:2 * n] if k == "keys" else y)
            errs["full_legs"] = max(errs["full_legs"], max_abs_err(
                f"full_legs trap {name} ({n} lanes)", got, want))
            checked.append(("k10", name, n))
    n2 = 2 * LANES
    fresh = legs_cache(legs)
    k10_fresh = timed(lambda: k10_call(legs, fresh))

    def stale_cache():
        keys, slot, ok = (x.clone() for x in fresh)
        ok.zero_()  # a new batch's cache: the launch sorts and refreshes it
        return ((keys, slot, ok),)

    k10_stale = timed(lambda c: k10_call(legs, c), setup=stale_cache)
    k10_none = timed(lambda: k10_call(legs, None))
    results["full_legs"] = dict(
        max_abs_err=errs["full_legs"],
        **pair_times(k10_fresh,
                     timed(lambda: tf._leg_balances_split_plain(
                         **legs, cache=tuple(x.clone() for x in fresh)),
                           reps=5)),
        ms_stale_cache=k10_stale["device_ms"],
        ms_no_cache=k10_none["device_ms"],
        ms_form="a launch that runs from a fresh sort cache (ms_stale_cache: "
                "it sorts over the card and refreshes the cache; "
                "ms_no_cache: it sorts, no cache)",
        parent_ms_perf_md=K10_PARENT_MS,
        library_ms=None,
        # Inputs read once (start balances of every leg, the lane inputs),
        # outputs written once (positions, 16 values, slots, flags).
        bound=bound(nbytes(legs["start_bal"]) + LANES * 38
                    + n2 * (8 + 16 * 8 + 8 + 1 + 1) + 1,
                    n2 * 14 * 15 // 2 + 40 * n2),
        shape=f"{n2} legs of a two-phase batch, every valid lane ok",
        launch=_cuda.full_legs_info(LANES),
        phases_us={
            "fresh": phase_clock().split(
                "full_legs", lambda: k10_call(legs, fresh)),
            "no_cache": phase_clock().split(
                "full_legs", lambda: k10_call(legs, None))},
        traps_checked=len(k10cases.CASES) * 2,
        stale_launches_fulltraps=k10_traps_stats)
    pw = tf._wave_schedule_plain(*waves, valid, ctx.accounts_capacity,
                                 tf._MAX_PASSES)
    # K12's split: the sort and run ids alone (no round) against the rounds.
    results["full_waves"] = dict(
        max_abs_err=errs["full_waves"],
        **pair_times(ct["k12"], timed(lambda: tf._wave_schedule_plain(
            *waves, valid, ctx.accounts_capacity, tf._MAX_PASSES))),
        perf_md_was_ms=K12_PERF_MD_WAS_MS,
        ms_no_rounds=ct["k12_no_rounds"]["device_ms"],
        proved=bool(pw[0]), passes_needed=int(pw[1]),
        library_ms=None,
        bound=bound(LANES * (1 + 16 + 2 + 1 + 4) + 36 + 6, n2 * 14 * 15 // 2),
        shape=f"{LANES} lanes of a two-phase batch")
    # The whole kernel core (K9, K11, K12, K10 for one batch) by CUDA
    # events behind a spin; K11's share from a profile, with the events the
    # profiler recorded against the launches made.
    made, core_ms, core, plan = ct["launches"], ct["core"], ct["profile"], ct["plan"]
    plain_core = timed(lambda: tf._kernel_core_plain(ctx, soa, COUNT, ts,
                                                     use_waves=True), reps=3)
    k11_ms, k11_calls = kernel_ms(core, "full_pass_kernel")
    k10_ms, k10_calls = kernel_ms(core, "full_legs_kernel")
    passes = int(plan.passes.item())
    ins = [soa, ctx.ex_found, ctx.e_tab, ctx.p_tab_found, ctx.p_tab,
           [v._asdict() for v in (ctx.drT, ctx.crT, ctx.pdr, ctx.pcr)],
           ctx.postedT_found, ctx.postedT_val, idx._asdict()]
    outs = [plan.codes, plan.ok, plan.row, plan.posted_key, plan.pv_ok,
            plan.do_hist, plan.hist_row]
    # The profiler drops events (C4): its K11 total is scaled by the
    # launches made over the events it recorded.
    k11_made = made.get("full_pass", 0)
    if k11_calls:
        k11_core_ms = k11_ms * k11_made / k11_calls
        k11_from = (f"profiler, {k11_calls} of {k11_made} launches a core "
                    "recorded, total scaled by launches / events")
    else:
        k11_core_ms = core_ms["device_ms"]
        k11_from = ("the whole core by cuda events (the profiler recorded no "
                    "K11 event): an upper bound")
    results["full_pass"] = dict(
        max_abs_err=errs["full_pass"], ms=k11_core_ms, ms_from=k11_from,
        ms_profiled=k11_ms, plain_ms=plain_core["device_ms"],
        call_ms=None, plain_call_ms=plain_core["call_ms"],
        perf_md_was_ms=K11_PERF_MD_WAS_MS,
        launches_per_core=k11_made,
        profiler_events_per_core=k11_calls, passes=passes,
        k10_in_core_ms=k10_ms, k10_launches_per_core=made.get("full_legs"),
        k10_profiler_events_per_core=k10_calls,
        core_ms=core_ms["device_ms"], core_ms_from=core_ms["device_ms_from"],
        core_host_ms=ct["core_host_ms"], core_launches=made,
        library_ms=None,
        bound=bound(nbytes(*ins) + nbytes(*outs), 400 * LANES * (passes + 1)),
        shape=f"{LANES} lanes of a two-phase batch: every K11 launch of one "
              f"kernel core ({passes} passes + the aux pass); plain: the whole "
              "plain kernel core (its index, legs and waves included)")
    # K11's history append (its own launch, in the apply) on this plan's
    # lanes, the log's count restored before each call.
    h = led.history
    gate = torch.zeros(1, dtype=torch.int32, device=dev)
    results["full_pass"]["hist_append_ms"] = timed(
        lambda c: _cuda.full_hist(gate, plan.do_hist,
                                  [plan.hist_row[k] for k in sm.HISTORY_COLS],
                                  [h.cols[k] for k in sm.HISTORY_COLS], c),
        setup=lambda: (h.count.clone(),))["device_ms"]
    results["full_pass"]["hist_append_rows"] = int(plan.do_hist.sum())
    # K2's claim and write on the transfers table.
    xfr = led.transfers
    ok = plan.ok
    kflags = torch.zeros(1, dtype=torch.int32, device=dev)

    def claim_once(t):
        return _cuda.claim(t.key_lo, t.key_hi, t.tombstone, soa["id_lo"],
                           soa["id_hi"], ok, sm.MAX_PROBE)

    t_claim, _ = claim_once(clone_table(xfr))
    steps = int((((to_np(t_claim)[to_np(ok)] - home_np(
        to_np(soa["id_lo"]), to_np(soa["id_hi"]), xfr.capacity)[to_np(ok)])
        & np.uint64(xfr.capacity - 1)) + 1).sum()) if bool(ok.any()) else 0
    n_ok = int(ok.sum())
    results["claim"] = dict(
        max_abs_err=errs["claim"],
        **pair_times(
            timed(lambda t: claim_once(t), reps=10,
                  setup=lambda: (clone_table(xfr),)),
            timed(lambda t: ht.claim_slots_plain(t, soa["id_lo"], soa["id_hi"],
                                                 ok, sm.MAX_PROBE),
                  reps=10, setup=lambda: (clone_table(xfr),))),
        library_ms=None,
        bound=bound(LANES * (16 + 1 + 8) + 17 * steps + 16 * n_ok,
                    40 * LANES + 10 * steps),
        shape=f"{LANES} lanes ({n_ok} ok) into the transfers table "
              f"(2^{xfr.capacity.bit_length() - 1})")
    row_bytes = sum(v.element_size() for v in xfr.cols.values())

    def write_setup():
        t = clone_table(xfr)
        c, _ = claim_once(t)
        return t, c

    def write_plain_setup():
        t = clone_table(xfr)
        c, _ = ht.claim_slots_plain(t, soa["id_lo"], soa["id_hi"], ok,
                                    sm.MAX_PROBE)
        return t, c

    results["write_claimed"] = dict(
        max_abs_err=errs["write_claimed"],
        **pair_times(
            timed(lambda t, c: _cuda.write_claimed(
                t.key_lo, t.key_hi, t.tombstone, t.cols, t.count, soa["id_lo"],
                soa["id_hi"], c, ok, plan.row, gate=kflags, revert=True),
                reps=10, setup=write_setup),
            timed(lambda t, c: ht.write_rows_plain(t, soa["id_lo"], soa["id_hi"],
                                                   c, ok, plan.row),
                  reps=10, setup=write_plain_setup)),
        library_ms=None,
        bound=bound(LANES * (8 + 1) + n_ok * (16 + 1 + 2 * row_bytes + 16),
                    10 * LANES),
        shape=f"{n_ok} rows of a two-phase batch written at claimed slots")
    torch.cuda.synchronize()
    return {"results": results, "batches_checked": len(checked),
            "kflags": {kind: routed[kind] for kind in routed},
            "traps": traps, "core_device_ms_by_name": core}


def legs_np(legs) -> dict:
    out = {}
    for k, v in legs._asdict().items():
        if isinstance(v, tuple):
            out[k + ".lo"], out[k + ".hi"] = to_np(v.lo), to_np(v.hi)
        else:
            out[k] = to_np(v)
    return out


def k10_call(legs: dict, cache):
    """K10 on its own (``_cuda.full_legs``) on ``full_inputs``' or
    ``k10cases``' legs, with the sort cache ``cache`` (None: it sorts)."""
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import transfer_full as tf

    a = legs
    return tf._legs_from_buffers(_cuda.full_legs(
        a["start_bal"], a["cap_sentinel"], a["ok_lanes"], a["amt_lo"],
        a["pamt_lo"], a["dr_slot"], a["cr_slot"], a["dr_live"],
        a["cr_live"], a["pending_f"], a["post"], a["postvoid"],
        a["has_postvoid"], cache=cache))


def legs_cache(legs: dict):
    """The sort cache of ``legs``' slots (K12's format: sorted keys padded
    with all ones, the legs' slots, ok 1), built on the host."""
    from tigerbeetle_tpu_torch.testing import k10cases

    dev = legs["dr_slot"].device
    keys, slot, ok = k10cases.sort_cache(
        to_np(legs["dr_slot"]), to_np(legs["cr_slot"]),
        to_np(legs["dr_live"]), to_np(legs["cr_live"]), legs["cap_sentinel"])
    return tuple(t64(x, dev) if x.dtype == np.int64 else
                 t32(x, dev) for x in (keys, slot, ok))


def legs_stats_now(dev) -> tuple:
    """K10's stats pair on ``dev`` (the general core's launches that ran,
    and those that found the sort cache stale and sorted)."""
    from tigerbeetle_tpu_torch.ops import _cuda

    return tuple(int(x) for x in _cuda.legs_stats(dev).tolist())


def stats_since(dev, before: tuple) -> dict:
    now = legs_stats_now(dev)
    return {"ran": now[0] - before[0], "sorted": now[1] - before[1]}


# ---------------------------------------------------------------------------
# phase 10: the default machine against K6 and the scalar oracle
# ---------------------------------------------------------------------------


def phase_full_parity(seed: int, dev) -> dict:
    from tigerbeetle_tpu_torch import convert
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine
    from tigerbeetle_tpu_torch.testing import fullmix
    from tigerbeetle_tpu_torch.testing import model as M
    from tigerbeetle_tpu_torch.testing import seqmix

    rng = np.random.default_rng(seed + 5)
    cfg = LedgerConfig(accounts_capacity_log2=14, transfers_capacity_log2=14,
                       posted_capacity_log2=12, history_capacity_log2=12)
    gen = TorchStateMachine(cfg, batch_lanes=LANES, device=dev)
    seq = TorchStateMachine(cfg, batch_lanes=LANES, device=dev,
                            force_sequential=True)
    ref = M.ReferenceStateMachine()
    routes = []
    seq_calls = []
    inner = gen._sequential
    gen._sequential = lambda *a, **k: seq_calls.append(1) or inner(*a, **k)
    wall = 10 ** 9
    ab = seqmix.accounts_batch(rng, 1, COUNT, faults=False)
    for mch in (gen, seq):
        if mch.create_accounts(ab, wall) != []:
            raise AssertionError("full_parity: accounts")
    ref.create_accounts(M.accounts_from_batch(ab), wall)
    mix = fullmix.GeneralMix(rng, list(range(1, FULL_ACCOUNTS + 1)), 1 << 40)
    kinds = ["general"] * 4 + ["seed_big"] + list(fullmix.SEQ_REASONS) + [
        "general"] * 2
    failed = 0
    codes = set()
    for b, kind in enumerate(kinds):
        wall += 10 ** 9
        batch = mix.seed_big() if kind == "seed_big" else mix.batch(COUNT, kind)
        n_seq = len(seq_calls)
        got = gen.create_transfers(batch, wall)
        routed = len(seq_calls) > n_seq
        routes.append({"kind": kind, "sequential": routed})
        if got != seq.create_transfers(batch, wall):
            raise AssertionError(f"full_parity: batch {b} ({kind}): general != K6")
        if got != ref.create_transfers(M.transfers_from_batch(batch), wall):
            raise AssertionError(f"full_parity: batch {b} ({kind}): != oracle")
        mix.settle(i for i, _ in got)
        failed += len(got)
        codes.update(c for _, c in got)
    if not gen.balances_snapshot() == seq.balances_snapshot() == ref.balances_snapshot():
        raise AssertionError("full_parity: balances")
    if gen.digest() != seq.digest():
        raise AssertionError("full_parity: digest")
    ids = sorted(set(mix.used))
    rows = gen.lookup_transfers(ids)
    if not np.array_equal(rows, seq.lookup_transfers(ids)):
        raise AssertionError("full_parity: lookup_transfers (general vs K6)")
    if [M.transfer_from_row(r) for r in rows] != ref.lookup_transfers(ids):
        raise AssertionError("full_parity: lookup_transfers (oracle)")
    hg = convert.ledger_to_numpy(gen.ledger)["history"]
    hs = convert.ledger_to_numpy(seq.ledger)["history"]
    count = int(hg["count"])
    if count != int(hs["count"]) or count != len(ref.history):
        raise AssertionError("full_parity: history count")
    for c in hg["cols"]:
        if not np.array_equal(hg["cols"][c][:count], hs["cols"][c][:count]):
            raise AssertionError(f"full_parity: history column {c}")
    general = sum(1 for r in routes if not r["sequential"])
    rerouted = {r["kind"]: r["sequential"] for r in routes
                if r["kind"] in fullmix.SEQ_REASONS}
    if not general or not all(rerouted.values()):
        raise AssertionError(f"full_parity: routes {routes}")
    return {"batches": len(kinds), "events_per_batch": COUNT,
            "committed_on_general_kernel": general,
            "rerouted_by_reason": rerouted, "routes": routes,
            "failed_events_matched": failed, "codes_seen": sorted(codes),
            "history_rows": count, "transfers_looked_up": len(ids)}


# ---------------------------------------------------------------------------
# phases 11 and 12: the general path at full width
# ---------------------------------------------------------------------------


def full_path_setup(m, shape: str):
    """bench.py's set-up of the general path's ``shape`` on machine ``m``:
    N_ACCOUNTS plain accounts ("twophase"), or N_ACCOUNTS limit-flagged
    accounts and their funding ("limits").  Returns the funding's debits
    and credits by account id and the shape's batch generator."""
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.utils import benchgen

    debits = np.zeros(N_ACCOUNTS + 2, dtype=object)
    credits = np.zeros(N_ACCOUNTS + 2, dtype=object)
    if shape == "limits":
        for b in benchgen.gen_limit_accounts_np(N_ACCOUNTS, COUNT):
            if m.create_accounts(b) != []:
                raise AssertionError("limits: account creation failed")
        for b in benchgen.gen_funding_np(N_ACCOUNTS, COUNT):
            if m.create_transfers(b) != []:
                raise AssertionError("limits: funding failed")
            for d, c, a in zip(b["debit_account_id_lo"],
                               b["credit_account_id_lo"], b["amount_lo"]):
                debits[int(d)] += int(a)
                credits[int(c)] += int(a)
        return debits, credits, benchgen.gen_batch_np
    for start in range(0, N_ACCOUNTS, COUNT):
        ids = range(start + 1, min(N_ACCOUNTS, start + COUNT) + 1)
        if m.create_accounts(types.accounts_array(
                [types.account(id=i, ledger=1, code=10) for i in ids])) != []:
            raise AssertionError("twophase: account creation failed")
    return debits, credits, benchgen.gen_two_phase_np


def phase_full_path(dev, shape: str, n_transfers: int) -> dict:
    """bench.py's --two-phase (``shape`` "twophase") or --limits ("limits")
    through a default machine: 10,000 accounts, then ``n_transfers``
    transfers in 8,190-event batches, every batch committed by the general
    kernel with kflags 0 on its first attempt."""
    import torch
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import state_machine as sm

    grows = []
    grow = ht.grow

    def timed_grow(table, capacity, hash_shift=0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = grow(table, capacity, hash_shift)
        torch.cuda.synchronize()
        grows.append({"from": table.capacity, "to": capacity,
                      "ms": (time.perf_counter() - t0) * 1e3})
        return out

    batch_max = COUNT
    gc.collect()  # an earlier phase's machine must not count in this peak
    torch.cuda.reset_peak_memory_stats()
    m = TorchStateMachine(LedgerConfig(lazy_index=True), batch_lanes=LANES,
                          device=dev)
    attempts = []  # the first routing word of every readback: kflags
    d2h = m._d2h_codes

    def spy(codes, *words):
        out = d2h(codes, *words)
        attempts.append(int(out[1][0]))
        return out

    m._d2h_codes = spy
    flagged = []
    grow_flagged = m._grow_flagged
    m._grow_flagged = lambda k: flagged.append(k) or grow_flagged(k)
    ht.grow = timed_grow
    try:
        debits, credits, gen = full_path_setup(m, shape)
        setup_readbacks = len(attempts)
        dsum = np.zeros(N_ACCOUNTS + 2, np.uint64)
        csum = np.zeros(N_ACCOUNTS + 2, np.uint64)
        caps0 = (m.ledger.transfers.capacity, m.ledger.posted.capacity)
        n_batches = max(1, (n_transfers + batch_max - 1) // batch_max)
        window = range(n_batches - 1 - PROFILE_BATCHES, n_batches - 1)
        if window.start < 0:
            window = range(0)
        _cuda.reset_counts()
        k10_before = legs_stats_now(dev)
        commit_s = steady_s = 0.0
        n_timed = n_steady = 0
        prof_commit_ms = 0.0
        prof = None
        passes, wave_hist, bounds = {}, np.zeros(9, np.int64), {}
        first_tid = 1 << 32
        for b in range(n_batches):
            batch = gen(b, LANES, batch_max, N_ACCOUNTS, first_tid)
            caps = (m.ledger.transfers.capacity, m.ledger.posted.capacity)
            if window and b == window.start:
                prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            n_att = len(attempts)
            t0 = time.perf_counter()
            res = m.create_transfers(batch)
            dt = time.perf_counter() - t0
            grew = (m.ledger.transfers.capacity, m.ledger.posted.capacity) != caps
            if b in window:
                prof_commit_ms += dt * 1e3
            else:
                commit_s += dt
                n_timed += len(batch)
                if not grew:
                    steady_s += dt
                    n_steady += 1
            if window and b == window.stop - 1:
                torch.cuda.synchronize()
                prof.__exit__(None, None, None)
            if res:
                raise AssertionError(f"{shape}: batch {b} had failures {res[:5]}")
            if attempts[n_att:] != [0]:
                raise AssertionError(f"{shape}: batch {b} kflags {attempts[n_att:]}")
            w = m.last_wave
            passes[int(w[0])] = passes.get(int(w[0]), 0) + 1
            bounds[int(w[1])] = bounds.get(int(w[1]), 0) + 1
            wave_hist += w[2:].astype(np.int64)
            if shape == "limits":
                np.add.at(dsum, batch["debit_account_id_lo"].astype(np.int64),
                          batch["amount_lo"])
                np.add.at(csum, batch["credit_account_id_lo"].astype(np.int64),
                          batch["amount_lo"])
            else:
                pend = batch[: len(batch) // 2]
                np.add.at(dsum, pend["debit_account_id_lo"].astype(np.int64),
                          pend["amount_lo"])
                np.add.at(csum, pend["credit_account_id_lo"].astype(np.int64),
                          pend["amount_lo"])
        torch.cuda.synchronize()
        launches = _cuda.counts()
        k10_stats = stats_since(dev, k10_before)
        round_form_calls = _cuda.ROUND_FORM_CALLS
    finally:
        ht.grow = grow
        del m._d2h_codes, m._grow_flagged  # the spies refer back to m
    if flagged:
        raise AssertionError(f"{shape}: flagged growths {flagged}")
    n_acc = N_ACCOUNTS + (1 if shape == "limits" else 0)
    rows = m.lookup_accounts(list(range(1, n_acc + 1)))
    if len(rows) != n_acc:
        raise AssertionError(f"{shape}: lookup lost accounts")
    order = rows["id_lo"].astype(np.int64)
    for name, run, setup in (("debits_posted", dsum, debits),
                             ("credits_posted", csum, credits)):
        want = [int(run[i]) + int(setup[i]) for i in order]
        got = [(int(h) << 64) | int(lo) for lo, h in zip(rows[name + "_lo"],
                                                         rows[name + "_hi"])]
        if got != want:
            raise AssertionError(f"{shape}: {name} differs from the closed form")
    for name in ("debits_pending", "credits_pending"):
        if rows[name + "_lo"].any() or rows[name + "_hi"].any():
            raise AssertionError(f"{shape}: {name} not zero")
    digest = m.digest()
    a = m.ledger.accounts
    plain = sm.ledger_digest_plain(
        a.key_lo, a.key_hi,
        [a.cols[c] for c in sm.BALANCE_COLS] + [a.cols["timestamp"]])
    if digest != int(plain.item()) & ((1 << 64) - 1):
        raise AssertionError(f"{shape}: digest differs from its plain version")
    committed = int(m.ledger.transfers.count.item())
    setup_transfers = N_ACCOUNTS if shape == "limits" else 0
    if committed != n_batches * batch_max + setup_transfers:
        raise AssertionError(f"{shape}: transfers count {committed}")
    if launches["seq_transfers"]:
        raise AssertionError(f"{shape}: K6 launched {launches['seq_transfers']}")
    missing = [k for k in FULL_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"{shape}: kernels not launched {missing}")
    profile = None
    if prof is not None:
        by_name = {}
        busy = device_us(prof, by_name) / 1e3
        if busy <= 0:
            raise AssertionError(f"{shape}: the profile recorded no device time")
        steady_ms = steady_s * 1e3 / n_steady if n_steady else None
        profile = {
            "batches": len(window), "commit_wall_ms": prof_commit_ms,
            "device_busy_ms": busy,
            "device_busy_ms_per_batch": busy / len(window),
            "device_idle_share": 1 - busy / prof_commit_ms,
            "unprofiled_batches": n_steady,
            "unprofiled_wall_ms_per_batch": steady_ms,
            "device_idle_share_unprofiled":
                1 - busy / len(window) / steady_ms if steady_ms else None,
            "device_ms_per_batch_by_name": {
                k: v / 1e3 / len(window) for k, v in sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:14]},
        }
    return {
        "shape": shape, "accounts": n_acc, "transfers": n_batches * batch_max,
        "batches": n_batches, "setup_readbacks": setup_readbacks,
        "capacities_before": caps0,
        "capacities_after": [m.ledger.transfers.capacity,
                             m.ledger.posted.capacity],
        "table_grows": grows, "flagged_grows": len(flagged),
        "commit_s_unprofiled": commit_s,
        "transfers_per_s": n_timed / commit_s if commit_s else None,
        "wall_ms_per_batch_unprofiled": commit_s * 1e3 / max(
            1, n_batches - len(window)),
        "jacobi_passes": passes, "wave_bounds": bounds,
        "wave_hist": wave_hist.tolist(), "profile": profile,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "digest": digest, "launches": launches,
        "k10_stats": k10_stats,
        "k2_round_form_calls": round_form_calls,
    }


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phases 13-15: the transfer index and the queries (K13-K16)
# ---------------------------------------------------------------------------

INDEX_PATH = ("probe", "run_sort", "run_merge", "index_window", "history_scan")
U64M = (1 << 64) - 1
QUERY_K = 8192  # get_account_transfers' candidate cap (QUERY_ROWS_MAX's power of two)


def level_np(lvl) -> dict:
    return {c: to_np(v) for c, v in lvl.items()}


def index_runs(rng, n_runs, n, dev):
    """``n_runs`` batches of ``n`` index entries per side, as a batch's
    runs before the sort: unique timestamps in commit order, debit and
    credit accounts 1..64 (never the same), a tenth of the lanes not ok."""
    import torch

    out = []
    ts0 = 1
    for _ in range(n_runs):
        ts = np.arange(ts0, ts0 + n, dtype=np.uint64)
        ts0 += n
        dr = rng.integers(1, 65, n).astype(np.uint64)
        cr = (dr + rng.integers(1, 64, n).astype(np.uint64) - 1) % 64 + 1
        tid = rng.integers(1, 1 << 62, n).astype(np.uint64)
        use = torch.from_numpy(rng.random(n) >= 0.1).to(dev)
        zero = np.zeros(n, np.uint64)
        sides = [[t64(a, dev) for a in (acct, zero, ts, tid, zero)]
                 for acct in (dr, cr)]
        out.append((sides, use))
    return out


# K14 before its redesign, at merge_shapes' shapes, ms (PERF.md §6, T1:
# the earlier tree timed in the same call as this one).
K14_PARENT_MS = {"rebuild_rounds_2e25": 41.91, "carry_into_6": 0.3036,
                 "carry_into_10": 3.196}


def merge_shapes(dev) -> dict:
    """K14 at its callers' full shapes, each checked byte for byte against
    the plain sort on the card, then timed by CUDA events behind a spin
    beside its bound (the parent's times, K14_PARENT_MS, are printed in
    the index_kernels phase's line): a full
    rebuild's merge rounds and tail after K13's chunks (one side of the
    queries run's rebuild: 2^25 entries, 10,000,000 live, accounts of
    10,000), and the carries into level 6 and into level 10 (the queries
    run's deepest: 1,222 batches), both sides a launch, base 8,192."""
    import torch
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import index as ix

    g = torch.Generator(device=dev)
    g.manual_seed(17)

    def rand(n, hi):
        return torch.randint(1, hi, (n,), device=dev, generator=g)

    def sorted_level(n):
        live = torch.rand(n, device=dev, generator=g) < 0.99
        acct, tid = rand(n, 10_001), rand(n, 1 << 62)
        return ix._sort_level_plain(ix._masked(
            [acct, torch.zeros_like(acct), rand(n, 1 << 62), tid,
             torch.zeros_like(tid)], live))

    out = {}
    n, n_live = 1 << 25, 10_000_000
    live = torch.zeros(n, dtype=torch.bool, device=dev)
    live[torch.randperm(n, device=dev, generator=g)[:n_live]] = True
    acct, tid = rand(n, 10_001), rand(n, 1 << 62)
    cols = [acct, torch.zeros_like(acct), rand(n, 1 << 62), tid,
            torch.zeros_like(tid)]
    chunks = [torch.empty((5, n), dtype=torch.int64, device=dev)]
    chunk = _cuda.run_sort([cols], live, [list(chunks[0].unbind(0))])
    got = ix._merge_rounds(chunks, chunk)[0]
    errs = max_abs_err_card("run_merge rebuild rounds", {"level": got.block},
                            {"level": ix._sort_level_plain(
                                ix._masked(cols, live, n)).block})
    del got, cols, acct, tid, live
    t = timed(lambda: ix._merge_rounds(chunks, chunk), reps=5)
    out["rebuild_rounds_2e25"] = dict(
        ms=t["device_ms"], ms_from=t["device_ms_from"],
        launches=(n // chunk).bit_length(),  # the rounds and the tail
        # K13's chunks read once, the level written once: a live entry's
        # five words read and written, a sentinel's two id words read and
        # its five written (its key words are the sentinel key).
        bound=bound(n_live * 80 + (n - n_live) * 56, 0), live=n_live,
        sentinels=n - n_live,
        shape=f"one side of a rebuild: 2^25 entries in chunks of {chunk}, "
              f"{n_live} live")
    del chunks
    torch.cuda.empty_cache()
    base = LANES
    for k in (6, 10):
        jobs = [[sorted_level(base)] + [sorted_level(base << j)
                                         for j in range(k)] for _ in range(2)]
        outs = [ix.Level(torch.empty((5, base << k), dtype=torch.int64,
                                     device=dev)) for _ in range(2)]
        ix._merge_sides(jobs, outs=outs)
        for o, j in zip(outs, jobs):
            errs = max(errs, max_abs_err_card(
                f"run_merge carry into {k}", {"level": o.block},
                {"level": ix._merge_plain(j).block}))
        t = timed(lambda: ix._merge_sides(jobs, outs=outs), reps=5)
        sent = sum(int((lv.block[2] == -1).sum()) for j in jobs for lv in j)
        out[f"carry_into_{k}"] = dict(
            ms=t["device_ms"], ms_from=t["device_ms_from"], launches=k,
            # Both sides' entries in and out once, a sentinel's key words
            # not read (as in the rebuild's bound).
            bound=bound(2 * (base << k) * 80 - 24 * sent, 0), sentinels=sent,
            shape=f"a carry into level {k}: run + levels 0..{k - 1}, "
                  f"{base << k} entries a side, both sides a launch")
        del jobs, outs
        torch.cuda.empty_cache()
    out["max_abs_err"] = errs
    return out


def phase_index_kernels(seed: int, dev) -> dict:
    """K13-K16 against their plain versions on the card, byte for byte on
    every output array (invalid lanes included); K13 and K14 timed at the
    main path's shapes (K15 and K16 are timed by ``queries``)."""
    import torch
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import index as ix
    from tigerbeetle_tpu_torch.ops import query as q
    from tigerbeetle_tpu_torch.ops import state_machine as sm
    from tigerbeetle_tpu_torch.testing import fullmix, k15cases, seqmix
    from tigerbeetle_tpu_torch.utils.benchgen import gen_batch_np

    rng = np.random.default_rng(seed + 13)
    results, checked = {}, {}

    # -- K13: build_runs' sort on a ledger at the main path's shape --------
    m = TorchStateMachine(LedgerConfig(lazy_index=True), batch_lanes=LANES,
                          device=dev)
    for start in range(0, N_ACCOUNTS, COUNT):
        m.create_accounts(types.accounts_array(
            [types.account(id=i, ledger=1, code=10)
             for i in range(start + 1, min(N_ACCOUNTS, start + COUNT) + 1)]))
    for b in range(24):
        if m.create_transfers(gen_batch_np(b, COUNT, COUNT, N_ACCOUNTS, 1 << 32)):
            raise AssertionError("index_kernels: a flagship batch failed")
    led = m.ledger
    batch = gen_batch_np(23, LANES, COUNT, N_ACCOUNTS, 1 << 32)
    id_lo = t64(np.concatenate([batch["id_lo"], np.zeros(LANES - COUNT, np.uint64)]), dev)
    id_hi = torch.zeros_like(id_lo)
    errs = 0
    for frac in (0.0, 0.5, 1.0):
        ok = torch.from_numpy(rng.random(LANES) < frac).to(dev)
        look = ht.lookup(led.transfers, id_lo, id_hi, sm.MAX_PROBE,
                         cols=("debit_account_id_lo", "debit_account_id_hi",
                               "credit_account_id_lo", "credit_account_id_hi",
                               "timestamp"), mask=ok)
        sides = [ix._side_cols(look.cols, id_lo, id_hi, f)
                 for f in ("debit_account_id", "credit_account_id")]
        got = ix._sort_masked(sides, look.found, LANES)
        for g, s, name in zip(got, sides, ("dr", "cr")):
            errs = max(errs, max_abs_err(
                f"run_sort build_runs ok={frac} {name}", level_np(g),
                level_np(ix._sort_level_plain(ix._masked(s, look.found)))))
        got = ix.build_runs(led, id_lo, id_hi, ok)
        for g, s in zip(got, sides):
            max_abs_err(f"build_runs ok={frac}", level_np(g),
                        level_np(ix._sort_level_plain(ix._masked(s, look.found))))
    checked["run_sort_build_runs"] = 3
    use = look.found
    # The batch's run in one K13 launch (its chunks merged after a grid
    # barrier) against K13's chunks and three K14 rounds, the full builds'
    # form: the same run, both timed (device and back-to-back calls).
    one = ix._sort_masked(sides, use, LANES)
    two = ix._sort_masked(sides, use, LANES, fused=False)
    for g, p, name in zip(two, one, ("dr", "cr")):
        errs = max(errs, max_abs_err(f"run_sort chunks and rounds {name}",
                                     level_np(g), level_np(p)))
    batch_forms = {}
    for label, fused in (("one_launch", True), ("chunks_and_rounds", False),
                         ("chunks_and_rounds_2", False), ("one_launch_2", True)):
        def form(fused=fused):
            return ix._sort_masked(sides, use, LANES, fused=fused)

        t = timed(form, reps=50)
        batch_forms[label] = {"device_ms": t["device_ms"], "call_ms": t["call_ms"],
                              "loop_ms": loop_ms(form, n=200)}
    outs = [[torch.empty(LANES, dtype=torch.int64, device=dev) for _ in range(5)]
            for _ in range(2)]
    # Ties: repeated keys keep their input order (stable), as lexsort.
    for n, fill in ((LANES, LANES), (1 << 15, 1 << 14)):
        block = np.full((5, n), U64M, np.uint64)
        block[0, :fill] = rng.integers(1, 9, fill)
        block[1, :fill] = rng.integers(0, 2, fill)
        block[2, :fill] = rng.integers(1, 50, fill)
        block[3, :fill] = rng.integers(1, 1 << 62, fill)
        block[4, :fill] = rng.integers(0, 4, fill)
        lvl = ix.Level(t64(block[:, rng.permutation(n)], dev))
        errs = max(errs, max_abs_err(f"run_sort ties n={n}",
                                     level_np(ix._sort_level(lvl)),
                                     level_np(ix._sort_level_plain(lvl))))
    # A full build at 2^20 entries: K13 over 1,024 chunks, then 10 K14 rounds.
    n_full = 1 << 20
    fb = [t64(rng.integers(0, 1 << 63, n_full // 2, dtype=np.uint64), dev)
          for _ in range(5)]
    fb[1] = fb[1] & 3
    fb[0] = fb[0] % 5000
    fuse = torch.from_numpy(rng.random(n_full // 2) < 0.8).to(dev)
    full_k = ix._sort_masked([fb], fuse, n_full)[0]
    full_p = ix._sort_level_plain(ix._masked(fb, fuse, n_full))
    errs = max(errs, max_abs_err("full build 2^20", level_np(full_k),
                                 level_np(full_p)))
    full_ms = timed(lambda: ix._sort_masked([fb], fuse, n_full), reps=5)
    full_plain_ms = timed(lambda: ix._sort_level_plain(ix._masked(fb, fuse, n_full)),
                          reps=3)
    # K13's timed row comes from the queries phase (the flagship's last
    # batch); this one, on a 24-batch ledger's run, is kept beside it.
    results["run_sort"] = dict(
        max_abs_err=errs,
        early_ledger=dict(**pair_times(
            timed(lambda: _cuda.run_sort(sides, use, outs)),
            timed(lambda: [ix._sort_level_plain(ix._masked(s, use))
                           for s in sides])),
            loop_ms=loop_ms(lambda: _cuda.run_sort(sides, use, outs))),
        full_build_2p20=dict(ms=full_ms["device_ms"], plain_ms=full_plain_ms["device_ms"],
                             call_ms=full_ms["call_ms"]),
        batch_forms=batch_forms,
        launch=_cuda.run_sort_info(LANES),
        phases_us=phase_clock().split(
            "run_sort", lambda: _cuda.run_sort(sides, use, outs)),
        one_side_1024_ms=timed(lambda: _cuda.run_sort(
            [[c[:1024] for c in sides[0]]], use[:1024],
            [[c[:1024] for c in outs[0]]]))["device_ms"],
        parent_ms_perf_md=K13_PARENT_MS,
    )
    if results["run_sort"]["launch"]["max_clusters"] < 2:
        raise AssertionError(f"K13's cluster: {results['run_sort']['launch']}")
    del m, led
    gc.collect()

    # -- K14: Bentley-Saxe carries into levels 1..6 (70 appends) -------------
    errs = 0
    runs = index_runs(rng, 70, LANES, dev)
    levels = {"dr": [], "cr": []}
    occupied = []
    carries = []
    for sides, use_r in runs:
        dr, cr = ix._sort_masked(sides, use_r, LANES)
        k = 0
        while k < len(occupied) and occupied[k]:
            k += 1
        while len(occupied) <= k:
            cap = LANES << len(occupied)
            levels["dr"].append(ix._sentinel_level(cap, dev))
            levels["cr"].append(ix._sentinel_level(cap, dev))
            occupied.append(False)
        if k == 0:
            levels["dr"][0], levels["cr"][0] = dr, cr
        else:
            jobs = [[dr] + levels["dr"][:k], [cr] + levels["cr"][:k]]
            plain = [ix._merge_plain(j) for j in jobs]
            got = ix._merge_sides(jobs, outs=[levels["dr"][k], levels["cr"][k]])
            for g, p, side in zip(got, plain, ("dr", "cr")):
                errs = max(errs, max_abs_err(f"run_merge carry into {k} {side}",
                                             level_np(g), level_np(p)))
            for j in range(k):
                levels["dr"][j].block.fill_(-1)
                levels["cr"][j].block.fill_(-1)
                occupied[j] = False
            carries.append(k)
        occupied[k] = True
    if max(carries) < 6:
        raise AssertionError(f"index_kernels: carries reached only {max(carries)}")
    # One launch of the level-6 carry's last step: 32 N + 32 N entries a side.
    big = [ix._merge_plain([levels["dr"][6]]), ix._merge_plain([levels["cr"][6]])]
    halves = [(ix.Level(b.block[:, : b.n // 2].contiguous()),
               ix.Level(b.block[:, b.n // 2:].contiguous())) for b in big]
    merge_out = [[torch.empty(big[0].n, dtype=torch.int64, device=dev)
                  for _ in range(5)] for _ in range(2)]
    ab = [[h[0][c] for c in ix.COLS] for h in halves]
    bb = [[h[1][c] for c in ix.COLS] for h in halves]
    results["run_merge"] = dict(
        max_abs_err=errs,
        **pair_times(
            timed(lambda: _cuda.run_merge(ab, bb, merge_out), reps=10),
            timed(lambda: [ix._merge_plain(list(h)) for h in halves], reps=5)),
        loop_ms=loop_ms(lambda: _cuda.run_merge(ab, bb, merge_out), n=20),
        library_ms=None,
        bound=bound(2 * big[0].n * 40 * 2, 2 * big[0].n * 20),
        shape=f"the last step of a carry into level 6: two sides of "
              f"{big[0].n // 2} + {big[0].n // 2} entries in one launch",
        carries=carries,
    )
    shapes = merge_shapes(dev)
    results["run_merge"]["max_abs_err"] = max(errs, shapes.pop("max_abs_err"))
    results["run_merge"]["shapes"] = shapes
    # Typed in from PERF.md, printed in this phase's line only.
    results["run_merge"]["shapes_parent_ms_perf_md"] = K14_PARENT_MS
    checked["run_merge_carries"] = len(carries)

    # -- K15: windows and unions on that pyramid (levels 1, 2, 6 occupied,
    # the others sentinel only) ------------------------------------------
    dr_levels, cr_levels = levels["dr"], levels["cr"]
    errs15 = 0
    n_q = 0
    ts_all = 70 * LANES
    for desc in (False, True):
        for want in ((True, True), (True, False), (False, True), (False, False)):
            for acct, lo_ts, hi_ts, k in ((1, 1, U64M - 1, QUERY_K),
                                          (7, ts_all // 5, ts_all // 2, QUERY_K),
                                          (33, 1, U64M - 1, 64),
                                          (64, ts_all - 100, U64M - 1, 256),
                                          (999, 1, U64M - 1, 64)):
                g = ix.query_transfers(dr_levels, cr_levels, acct, 0, lo_ts,
                                       hi_ts, *want, k, desc)
                p = ix.query_transfers_plain(dr_levels, cr_levels, acct, 0,
                                             lo_ts, hi_ts, *want, k, desc)
                errs15 = max(errs15, max_abs_err(
                    f"index_window union acct={acct} want={want} desc={desc}",
                    {"valid": to_np(g[0]), "lo": to_np(g[1]), "hi": to_np(g[2])},
                    {"valid": to_np(p[0]), "lo": to_np(p[1]), "hi": to_np(p[2])}))
                n_q += 1
        for acct, lo_ts, hi_ts in ((5, 1, U64M), (9, ts_all // 3, U64M - 1)):
            g = ix._query_side(dr_levels, acct, 0, lo_ts, hi_ts, 512, desc)
            p = ix._query_side_plain(dr_levels, acct, 0, lo_ts, hi_ts, 512, desc)
            errs15 = max(errs15, max_abs_err(
                f"index_window window acct={acct} desc={desc}",
                dict(zip("tlh", map(to_np, g))), dict(zip("tlh", map(to_np, p)))))
            n_q += 1
    # K15's traps (testing/k15cases.py), both modes.
    for case in k15cases.CASES:
        dr_c, cr_c, queries = k15cases.case(case)
        lv = [[ix.Level(t64(b, dev)) for b in side] for side in (dr_c, cr_c)]
        for qa in queries:
            g = ix.query_transfers(*lv, *qa)
            for fn in (ix.query_transfers_plain, ix.query_transfers_split_plain):
                errs15 = max(errs15, max_abs_err_card(
                    f"index_window {case} {qa} vs {fn.__name__}",
                    dict(zip("vlh", g)), dict(zip("vlh", fn(*lv, *qa)))))
            for side in lv:
                if side:
                    a = (side, qa[0], qa[1], qa[2], qa[3], qa[6], qa[7])
                    errs15 = max(errs15, max_abs_err_card(
                        f"index_window window {case} {qa}",
                        dict(zip("tlh", ix._query_side(*a))),
                        dict(zip("tlh", ix._query_side_plain(*a)))))
            n_q += 1
    checked["index_window_queries"] = n_q
    results["index_window"] = dict(max_abs_err=errs15)
    del levels, dr_levels, cr_levels, runs, big, halves
    gc.collect()

    # -- K16: a history log from the general path, a rolled-back tail above
    # its count, both sides, fewer and more matches than k ----------------
    hm = TorchStateMachine(LedgerConfig(accounts_capacity_log2=10,
                                        transfers_capacity_log2=14,
                                        posted_capacity_log2=12,
                                        history_capacity_log2=12),
                           batch_lanes=2048, device=dev)
    hm.create_accounts(seqmix.accounts_batch(rng, 1, 400, faults=False), 10)
    mix = fullmix.GeneralMix(rng, list(range(1, 401)), 1 << 40)
    for b in range(4):
        res = hm.create_transfers(mix.batch(2000), 10 ** 9 * (b + 1))
        mix.settle(i for i, _ in res)
    h = hm.ledger.history
    count = int(h.count.item())
    if count < 64:
        raise AssertionError(f"index_kernels: history count {count}")
    tail = min(300, h.capacity - count)
    for col in h.cols.values():
        col[count:count + tail] = col[:tail].clone()
    hist_acct = [a for a in range(1, 401) if seqmix.account_flags(a) & 8][:6]
    ts_h = to_np(h.cols["timestamp"][:count])
    errs16 = 0
    for desc in (False, True):
        for want in ((True, True), (True, False), (False, True)):
            for acct, lo_ts, hi_ts, k in ((hist_acct[0], 1, U64M - 1, 8),
                                          (hist_acct[1], 1, U64M - 1, h.capacity),
                                          (hist_acct[2], int(ts_h[10]),
                                           int(ts_h[-10]), 512),
                                          (999_999, 1, U64M - 1, 64)):
                g = q.scan_history(hm.ledger, acct, 0, lo_ts, hi_ts, *want, desc, k)
                p = q.scan_history_plain(hm.ledger, acct, 0, lo_ts, hi_ts, *want,
                                         desc, k)
                errs16 = max(errs16, max_abs_err(
                    f"history_scan acct={acct} want={want} desc={desc} k={k}",
                    {"valid": to_np(g[0]), **{c: to_np(v) for c, v in g[1].items()}},
                    {"valid": to_np(p[0]), **{c: to_np(v) for c, v in p[1].items()}}))
    more = int(q.scan_history_plain(hm.ledger, hist_acct[0], 0, 1, U64M - 1,
                                    True, True, False, h.capacity)[0].sum())
    if more <= 8:
        raise AssertionError("index_kernels: the k=8 history case has few matches")
    # A log of 2^21 slots: 2,048 blocks of K16's count pass, so the scan of
    # the block counts carries across more than one block of 1,024.  The
    # rows above repeated, with fresh increasing timestamps, 1,500,000 of
    # them below count.
    big_cap = 1 << 21
    reps = -(-big_cap // count)
    big_cols = {name: col[:count].repeat(reps)[:big_cap].clone()
                for name, col in h.cols.items()}
    big_cols["timestamp"] = 3 * torch.arange(1, big_cap + 1, dtype=torch.int64,
                                             device=dev)
    big = dataclasses.replace(hm.ledger, history=dataclasses.replace(
        h, cols=big_cols, count=torch.full_like(h.count, 1_500_000)))
    for desc, want, lo_ts, hi_ts, k in (
            (True, (True, True), 1, U64M - 1, 8190),
            (False, (True, False), 1, U64M - 1, 8190),
            (True, (False, True), 3_000_000, 4_000_000, 512)):
        for acct in hist_acct[:2]:
            g = q.scan_history(big, acct, 0, lo_ts, hi_ts, *want, desc, k)
            p = q.scan_history_plain(big, acct, 0, lo_ts, hi_ts, *want, desc, k)
            errs16 = max(errs16, max_abs_err_card(
                f"history_scan 2^21 log acct={acct} want={want} desc={desc} k={k}",
                {"valid": g[0], **g[1]}, {"valid": p[0], **p[1]}))
    del big, big_cols
    checked["history_scan_queries"] = 30
    checked["history_rows"] = count
    checked["history_tail_above_count"] = tail
    results["history_scan"] = dict(max_abs_err=errs16)
    del hm
    gc.collect()
    torch.cuda.synchronize()
    return {"results": results, "checked": checked}


def phase_queries_parity(seed: int, dev) -> dict:
    """Small, on the card: a default machine (index appended on every
    commit of the fast, general and sequential routes) against the scalar
    oracle and against a ``lazy_index`` machine, over every filter flag
    combination, the invalid filters, limits 1, 7 and 8,190, timestamp
    windows and composed scans."""
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine
    from tigerbeetle_tpu_torch.ops import scan_builder as sb
    from tigerbeetle_tpu_torch.testing import fullmix, seqmix
    from tigerbeetle_tpu_torch.testing import model as M

    rng = np.random.default_rng(seed + 14)
    cfg = LedgerConfig(accounts_capacity_log2=10, transfers_capacity_log2=14,
                       posted_capacity_log2=12, history_capacity_log2=12)
    lanes = 1024
    eager = TorchStateMachine(cfg, batch_lanes=lanes, device=dev)
    lazy = TorchStateMachine(dataclasses.replace(cfg, lazy_index=True),
                             batch_lanes=lanes, device=dev)
    ref = M.ReferenceStateMachine()
    routes = {"fast": 0, "full": 0, "sequential": 0}
    for name in routes:
        attr = {"fast": "_commit_fast", "full": "_commit_full",
                "sequential": "_sequential"}[name]
        orig = getattr(eager, attr)

        def spy(*a, _orig=orig, _name=name, **k):
            routes[_name] += 1
            return _orig(*a, **k)

        setattr(eager, attr, spy)
    wall = [10]

    def commit(op, batch):
        wall[0] += 10 ** 9
        got = getattr(eager, op)(batch, wall_clock_ns=wall[0])
        if getattr(lazy, op)(batch, wall_clock_ns=wall[0]) != got:
            raise AssertionError(f"queries_parity: lazy machine {op}")
        rows = (M.accounts_from_batch if op == "create_accounts"
                else M.transfers_from_batch)(batch)
        if getattr(ref, op)(rows, wall[0]) != got:
            raise AssertionError(f"queries_parity: oracle {op}")
        return got

    def vary(batch):
        regular = (batch["flags"] & 12) == 0  # not post/void
        n = int(regular.sum())
        batch["user_data_128_hi"][regular] = rng.integers(0, 3, n)
        batch["user_data_128_lo"][regular] = rng.integers(0, 2, n)
        batch["code"][regular] = rng.choice([10, 20, 30], n)
        return batch

    # Plain accounts and plain batches: the fast path.
    commit("create_accounts", types.accounts_array([
        types.account(id=i, ledger=1, code=10 + 10 * (i % 2), user_data_32=i % 3)
        for i in range(1, 41)]))
    for b in range(3):
        n = 1000
        dr = rng.integers(1, 41, n)
        cr = (dr + rng.integers(1, 40, n) - 1) % 40 + 1
        commit("create_transfers", vary(types.transfers_array([
            types.transfer(id=100_000 + 1000 * b + i, debit_account_id=int(dr[i]),
                           credit_account_id=int(cr[i]), amount=int(rng.integers(1, 99)),
                           ledger=1, code=10) for i in range(n)])))
    # Limit and history accounts: the general kernel, and its FLAG_SEQ
    # re-routes to the sequential path.
    acc = seqmix.accounts_batch(rng, 41, 200, faults=False)
    acc["code"] = 10 + 10 * (acc["id_lo"] % 2).astype(np.uint16)
    commit("create_accounts", acc)
    mix = fullmix.GeneralMix(rng, list(range(41, 241)), 1 << 40)
    for kind in ("general", "general", "chain_balance", "general", "u128"):
        got = commit("create_transfers", vary(mix.batch(1000, kind)))
        mix.settle(i for i, _ in got)
    tmix = seqmix.TransferMix(rng, list(range(41, 241)), 1 << 44)
    for _ in range(2):
        commit("create_transfers", vary(tmix.batch(1000)))
    if not all(routes.values()):
        raise AssertionError(f"queries_parity: a route was not taken {routes}")
    if eager.index.stale or not lazy.index.stale:
        raise AssertionError("queries_parity: index staleness")

    def filt(acct, ts_min=0, ts_max=0, limit=8190, flags=3, reserved=0):
        a = np.zeros(1, dtype=types.ACCOUNT_FILTER_DTYPE)
        size = types.ACCOUNT_FILTER_DTYPE["reserved"].itemsize
        a["reserved"] = np.void(bytes([reserved]) + bytes(size - 1))
        f = a[0]
        f["account_id_lo"], f["account_id_hi"] = acct & U64M, acct >> 64
        f["timestamp_min"], f["timestamp_max"] = ts_min, ts_max
        f["limit"], f["flags"] = limit, flags
        return f

    ts = np.sort([t.timestamp for t in ref.transfers.values()])
    lo_ts, hi_ts = int(ts[len(ts) // 5]), int(ts[4 * len(ts) // 5])
    n_transfer_q = n_hist_q = 0
    hist_accounts = [a for a in range(41, 241) if seqmix.account_flags(a) & 8]
    for acct in [1, 2, 17, 40, 41, 45] + hist_accounts[:4] + [10 ** 9]:
        for flags in range(1, 8):
            for limit, ts_min, ts_max in ((8190, 0, 0), (1, 0, 0), (7, 0, 0),
                                          (8190, lo_ts, hi_ts), (7, lo_ts, 0),
                                          (8190, 0, hi_ts)):
                f = filt(acct, ts_min, ts_max, limit, flags)
                got = eager.get_account_transfers(f)
                want = ref.get_account_transfers(acct, ts_min, ts_max, limit, flags)
                if [int(r["id_lo"]) for r in got] != [t.id for t in want] or \
                        [int(r["timestamp"]) for r in got] != [t.timestamp for t in want]:
                    raise AssertionError(f"queries_parity: transfers {acct} {flags} {limit}")
                if got.tobytes() != lazy.get_account_transfers(f).tobytes():
                    raise AssertionError("queries_parity: lazy transfers")
                gh = eager.get_account_history(f)
                wh = ref.get_account_history(acct, ts_min, ts_max, limit, flags)
                got_h = [(int(r["timestamp"]),
                          *((int(r[c + "_hi"]) << 64) | int(r[c + "_lo"])
                            for c in ("debits_pending", "debits_posted",
                                      "credits_pending", "credits_posted")))
                         for r in gh]
                if got_h != [tuple(w) for w in wh]:
                    raise AssertionError(f"queries_parity: history {acct} {flags}")
                if gh.tobytes() != lazy.get_account_history(f).tobytes():
                    raise AssertionError("queries_parity: lazy history")
                n_transfer_q += 1
                n_hist_q += len(wh) > 0
    invalid = (filt(0), filt(U64M | (U64M << 64)), filt(1, ts_min=U64M),
               filt(1, ts_max=U64M), filt(1, ts_min=9, ts_max=8), filt(1, limit=0),
               filt(1, flags=4), filt(1, flags=9), filt(1, reserved=1))
    for f in invalid:
        if len(eager.get_account_transfers(f)) or len(eager.get_account_history(f)):
            raise AssertionError("queries_parity: an invalid filter gave rows")

    # Composed scans against a numpy selection over every transfer.
    rows = eager.lookup_transfers(list(ref.transfers))

    def u128(r, f):
        return (r[f + "_hi"].astype(object) << 64) | r[f + "_lo"].astype(object)

    def mask(rs, e, specs):
        if isinstance(e, sb.Prefix):
            lo_col, hi_col = specs[e.field]
            vals = u128(rs, e.field) if hi_col else rs[lo_col].astype(object)
            return np.asarray(vals == e.value, dtype=bool)
        if isinstance(e, sb.Union):
            return np.logical_or.reduce([mask(rs, c, specs) for c in e.children])
        if isinstance(e, sb.Intersection):
            return np.logical_and.reduce([mask(rs, c, specs) for c in e.children])
        return mask(rs, e.include, specs) & ~mask(rs, e.exclude, specs)

    def oracle(rs, e, limit, rev, ts_min=0, ts_max=0, specs=sb.TRANSFER_FIELDS):
        t = rs["timestamp"]
        keep = mask(rs, e, specs) & (t >= (ts_min or 1)) & (t <= (ts_max or U64M - 1))
        hit = rs[keep]
        order = np.argsort(hit["timestamp"], kind="stable")
        return hit[order[::-1] if rev else order][:limit]

    exprs = [
        sb.scan_prefix("ledger", 1),
        sb.scan_prefix("code", 20),
        sb.scan_prefix("user_data_128", (1 << 64) | 1),
        sb.merge_union(sb.scan_prefix("code", 10), sb.scan_prefix("code", 30)),
        sb.merge_intersection(sb.scan_prefix("ledger", 1), sb.scan_prefix("code", 20),
                              sb.scan_prefix("user_data_128", 2 << 64)),
        sb.merge_difference(sb.scan_prefix("user_data_128", 1),
                            sb.scan_prefix("code", 10)),
        sb.merge_union(sb.merge_intersection(sb.scan_prefix("code", 10),
                                             sb.scan_prefix("ledger", 1)),
                       sb.merge_difference(sb.scan_prefix("user_data_128", 2 << 64),
                                           sb.scan_prefix("code", 30))),
    ]
    n_scans = 0
    for e in exprs:
        for limit, rev, ts_min, ts_max in ((8190, False, 0, 0), (5, True, 0, 0),
                                           (100, False, lo_ts, hi_ts)):
            got = eager.scan_transfers(e, ts_min, ts_max, limit, rev)
            want = oracle(rows, e, limit, rev, ts_min, ts_max)
            if got.tobytes() != want.tobytes():
                raise AssertionError(f"queries_parity: scan_transfers {e} {limit}")
            if got.tobytes() != lazy.scan_transfers(e, ts_min, ts_max, limit,
                                                    rev).tobytes():
                raise AssertionError("queries_parity: lazy scan_transfers")
            n_scans += 1
    # One more batch: the materialized field indexes are appended (eager)
    # or marked stale (lazy), and the scans stay exact.
    commit("create_transfers", vary(tmix.batch(500)))
    rows = eager.lookup_transfers(list(ref.transfers))
    for e in exprs[:4]:
        got = eager.scan_transfers(e)
        if got.tobytes() != oracle(rows, e, 8190, False).tobytes() or \
                got.tobytes() != lazy.scan_transfers(e).tobytes():
            raise AssertionError(f"queries_parity: scan after append {e}")
        n_scans += 1
    got = eager.query_transfers_where(ledger=1, code=20, limit=50)
    want = oracle(rows, sb.merge_intersection(sb.scan_prefix("code", 20),
                                              sb.scan_prefix("ledger", 1)), 50, False)
    if got.tobytes() != want.tobytes():
        raise AssertionError("queries_parity: query_transfers_where")
    acc_rows = eager.lookup_accounts(list(ref.accounts))
    for e in (sb.scan_prefix("code", 20),
              sb.merge_difference(sb.scan_prefix("ledger", 1),
                                  sb.scan_prefix("user_data_32", 1))):
        got = eager.scan_accounts(e)
        if got.tobytes() != oracle(acc_rows, e, 8190, False,
                                   specs=sb.ACCOUNT_FIELDS).tobytes() or \
                got.tobytes() != lazy.scan_accounts(e).tobytes():
            raise AssertionError(f"queries_parity: scan_accounts {e}")
    got = eager.query_accounts_where(ledger=1, code=10)
    want = oracle(acc_rows, sb.merge_intersection(sb.scan_prefix("code", 10),
                                                  sb.scan_prefix("ledger", 1)),
                  8190, False, specs=sb.ACCOUNT_FIELDS)
    if got.tobytes() != want.tobytes():
        raise AssertionError("queries_parity: query_accounts_where")
    return {"routes": routes, "transfer_queries": n_transfer_q,
            "history_queries_with_rows": n_hist_q, "scans": n_scans,
            "transfers": len(ref.transfers), "history_rows": int(
                eager.ledger.history.count.item())}


def _side_order(acct_col, ts_col):
    """numpy: entries sorted by (account, timestamp), and the sorted
    accounts (for searchsorted)."""
    order = np.lexsort((ts_col, acct_col))
    return order, acct_col[order]


def phase_queries(dev, n_transfers: int, smi: str) -> dict:
    """(a) The flagship generator on a default machine (the index appended
    on every commit), then 100 get_account_transfers at limit 8,190, a full
    rebuild and the same queries; (b) the same transfers on HISTORY
    accounts (the general path appends a history row per transfer), then
    100 get_account_history.  Every answer is held against a numpy selection
    over the table or log copied to the host.  Also K14's bytes over the
    phase's launches (``k14_over_path``)."""
    import torch
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.utils.benchgen import gen_batch_np

    rng = np.random.default_rng(15)
    n_batches = max(1, (n_transfers + COUNT - 1) // COUNT)
    flag_cycle = (1, 2, 3, 7)  # DEBITS, CREDITS, both, both REVERSED
    out = {"nvidia_smi": smi, "transfers": n_transfers, "batches": n_batches}

    def run(m, label):
        """Commit the flagship batches; a card-only profile over the last
        64 full batches but one (a whole carry cycle up to level 6)."""
        window = range(n_batches - 1 - 64, n_batches - 1)
        if window.start < 0:
            window = range(0)
        commit_s, n_timed, prof = 0.0, 0, None
        # The host's time in the index appends (their launches are
        # asynchronous, so this is the Python and launch work).
        append_s = [0.0]
        index_append = m._index_append

        def timed_append(*a):
            t0 = time.perf_counter()
            index_append(*a)
            append_s[0] += time.perf_counter() - t0

        m._index_append = timed_append
        for b in range(n_batches):
            count = min(COUNT, n_transfers - b * COUNT)
            batch = gen_batch_np(b, COUNT, COUNT, N_ACCOUNTS, 1 << 32)[:count]
            if window and b == window.start:
                torch.cuda.synchronize()
                launched = {k: _cuda.KERNELS[k].launches
                            for k in ("run_sort", "run_merge")}
                prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            t0 = time.perf_counter()
            res = m.create_transfers(batch)
            dt = time.perf_counter() - t0
            if b not in window:
                commit_s += dt
                n_timed += count
            if window and b == window.stop - 1:
                torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                launched = {k: _cuda.KERNELS[k].launches - v
                            for k, v in launched.items()}
            if res:
                raise AssertionError(f"queries {label}: batch {b} failed {res[:3]}")
        torch.cuda.synchronize()
        del m._index_append
        r = {"commit_s_unprofiled": commit_s,
             "transfers_per_s": n_timed / commit_s if commit_s else None,
             "index_append_host_ms_per_batch": append_s[0] * 1e3 / n_batches}
        if prof is not None:
            by_name, calls = {}, {}
            busy = device_us(prof, by_name, calls) / 1e3
            per = {k: v / 1e3 / len(window) for k, v in by_name.items()}
            # The profiler may drop events: the launches the window made
            # beside the events it recorded say how far to trust a time.
            r["profile"] = {
                "batches": len(window), "device_busy_ms_per_batch": busy / len(window),
                "launches_in_window": launched,
                "events_recorded": {
                    k: sum(v for n, v in calls.items() if k in n)
                    for k in ("run_sort", "run_merge")},
                "n_batches": n_batches,
                "k13_run_sort_ms_per_batch": sum(v for k, v in per.items()
                                                 if "run_sort" in k),
                "k14_run_merge_ms_per_batch": sum(v for k, v in per.items()
                                                  if "run_merge" in k),
                "device_ms_per_batch_by_name": dict(sorted(
                    per.items(), key=lambda kv: -kv[1])[:12])}
        return r

    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_counts()
    # K14's work over the path, for its bound: a carry's launch reads (and
    # writes) its entries; a full build's rounds and tail together read
    # K13's chunks once and write the level once, counted at the tail,
    # where a sentinel-keyed entry's key words are not read.
    merge_launch, merge_tail = _cuda._merge_launch, _cuda.run_merge_tail
    k14_entries = [0, 0]  # entries, launches
    k14_tails = []  # (entries, its live prefix's length) a full build

    def counted_merge(cols, sizes, jobs, stream, prefix=None):
        if uncounted.depth == 0:
            for j in range(jobs if prefix is None else 0):
                la, lb, pairs = sizes[6 * j:6 * j + 3]
                k14_entries[0] += (la + lb) * pairs
            k14_entries[1] += 1
        merge_launch(cols, sizes, jobs, stream, prefix)

    def counted_tail(chunks, level, chunk, pchunk, pfinal):
        if uncounted.depth == 0:
            k14_entries[0] += sum(c[0].numel() for c in chunks)
            k14_entries[1] += 1
            k14_tails.extend((c[0].numel(), pf) for c, pf in zip(chunks, pfinal))
        merge_tail(chunks, level, chunk, pchunk, pfinal)

    _cuda._merge_launch, _cuda.run_merge_tail = counted_merge, counted_tail
    try:
        _queries_body(out, run, dev, n_transfers, rng, flag_cycle)
    finally:
        _cuda._merge_launch, _cuda.run_merge_tail = merge_launch, merge_tail
    entries, launches = k14_entries
    if launches != out["launches"]["run_merge"]:
        raise AssertionError(f"K14's counted launches {launches} != "
                             f"{out['launches']['run_merge']}")
    # Each entry read once and written once, 40 B (five u64 columns); a
    # full build's sentinel-keyed entries read 16 B (their id words).
    tail_sentinels = sum(n - int(pf.item()) for n, pf in k14_tails)
    per_launch = (80 * entries - 24 * tail_sentinels) / launches \
        if launches else 0.0
    out["k14_over_path"] = dict(
        launches=launches, entries_merged=entries,
        full_build_sentinels=tail_sentinels,
        bytes_per_launch=per_launch,
        bound_ms_per_launch=bound(per_launch, 0)[0])
    return out


def _queries_body(out, run, dev, n_transfers, rng, flag_cycle):
    """The queries phase's runs (a) and (b), their queries and the
    rebuild, into ``out``."""
    import torch
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import index as ix
    from tigerbeetle_tpu_torch.ops import query as q
    from tigerbeetle_tpu_torch.u128 import INT64_MIN
    from tigerbeetle_tpu_torch.utils.benchgen import gen_batch_np

    n_batches = out["batches"]
    # -- (a) -------------------------------------------------------------
    m = TorchStateMachine(LedgerConfig(), batch_lanes=LANES, device=dev)
    for start in range(0, N_ACCOUNTS, COUNT):
        if m.create_accounts(types.accounts_array(
                [types.account(id=i, ledger=1, code=10)
                 for i in range(start + 1, min(N_ACCOUNTS, start + COUNT) + 1)])):
            raise AssertionError("queries: account creation failed")
    out["a"] = run(m, "a")
    out["a"]["index_levels"] = [lv.n for lv in m.index.dr_levels]
    out["a"]["index_occupied"] = list(m.index.occupied)
    t = m.ledger.transfers
    host = {k: to_np(v) for k, v in (
        ("key_lo", t.key_lo), ("key_hi", t.key_hi), ("tomb", t.tombstone),
        ("dr", t.cols["debit_account_id_lo"]), ("dr_hi", t.cols["debit_account_id_hi"]),
        ("cr", t.cols["credit_account_id_lo"]), ("cr_hi", t.cols["credit_account_id_hi"]),
        ("ts", t.cols["timestamp"]))}
    live = ((host["key_lo"] != 0) | (host["key_hi"] != 0)) & ~host["tomb"]
    if host["key_hi"][live].any() or host["dr_hi"][live].any() or host["cr_hi"][live].any():
        raise AssertionError("queries: the flagship ids fit in 64 bits")
    ids, ts = host["key_lo"][live], host["ts"][live]
    sides = {s: _side_order(host[s][live], ts) for s in ("dr", "cr")}
    del host

    def expected(acct, flags):
        sel_ts, sel_id = [], []
        for bit, s in ((1, "dr"), (2, "cr")):
            if flags & bit:
                order, keys = sides[s]
                a, b = np.searchsorted(keys, acct), np.searchsorted(keys, acct, "right")
                sel_ts.append(ts[order[a:b]])
                sel_id.append(ids[order[a:b]])
        st, si = np.concatenate(sel_ts), np.concatenate(sel_id)
        o = np.argsort(st)
        if flags & 4:
            o = o[::-1]
        return si[o][:8190], st[o][:8190]

    accts = rng.integers(1, N_ACCOUNTS + 1, 100)

    def queries(label):
        answers, walls = [], []
        for i, acct in enumerate(accts):
            f = np.zeros(1, dtype=types.ACCOUNT_FILTER_DTYPE)[0]
            f["account_id_lo"], f["limit"] = int(acct), 8190
            f["flags"] = flag_cycle[i % 4]
            t0 = time.perf_counter()
            got = m.get_account_transfers(f)
            walls.append((time.perf_counter() - t0) * 1e3)
            want_id, want_ts = expected(int(acct), int(f["flags"]))
            if not (np.array_equal(got["id_lo"], want_id)
                    and np.array_equal(got["timestamp"], want_ts)):
                raise AssertionError(f"queries {label}: account {acct} flags "
                                     f"{f['flags']}: {len(got)} rows, want "
                                     f"{len(want_id)}")
            if got.tobytes() != m.lookup_transfers([int(x) for x in want_id]).tobytes():
                raise AssertionError(f"queries {label}: rows of account {acct}")
            answers.append(got.tobytes())
        return answers, walls

    first, walls = queries("a")
    out["a"]["query_rows"] = int(sum(len(x) for x in first) // 128)
    out["a"]["query_wall_ms"] = {"median": float(np.median(walls)),
                                 "p99": float(np.percentile(walls, 99)),
                                 "max": float(np.max(walls))}
    # The kernels against their plain versions on the card at this size,
    # every output array (invalid lanes included).  The peak memory of the
    # path is read before each such check, which adds plain temporaries.
    peak = torch.cuda.max_memory_allocated()
    errs = {"run_sort": 0, "run_merge": 0, "index_window": 0, "history_scan": 0}
    t = m.ledger.transfers

    def side_cols(field):
        return [t.cols[field + "_lo"], t.cols[field + "_hi"],
                t.cols["timestamp"], t.key_lo, t.key_hi]

    def check_level(label, side, k, use):
        """Level k of one side ("dr" or "cr") against the plain sort of the
        entries of ``use``, which must all fit in it (the rest sentinels)."""
        levels = m.index.dr_levels if side == "dr" else m.index.cr_levels
        field = "debit_account_id" if side == "dr" else "credit_account_id"
        n = m.index.base << k
        want = ix._sort_level_plain(ix._masked(side_cols(field), use))
        if not bool((want.block[:, n:] == -1).all()):
            raise AssertionError(f"queries {label}: entries past level {k}")
        return max_abs_err_card(f"queries {label} {side} level {k}", levels[k],
                                {c: want[c][:n] for c in ix.COLS})

    with uncounted():
        # The deepest carried level: appended in commit order, the highest
        # occupied level k holds the first 2^k batches' runs, the
        # transfers with the smallest timestamps (K13, then k K14 merges).
        k_top = max(j for j, o in enumerate(m.index.occupied) if o)
        n_real = min((1 << k_top) * COUNT, n_transfers)
        live = ix._live(t)
        tsu = t.cols["timestamp"] ^ INT64_MIN
        first_runs = live & (tsu <= torch.sort(tsu[live]).values[n_real - 1])
        for side in ("dr", "cr"):
            errs["run_merge"] = max(errs["run_merge"], check_level(
                "a", side, k_top, first_runs))
        out["a"]["deepest_level_checked"] = {"level": k_top,
                                             "entries": m.index.base << k_top,
                                             "real": n_real}
        del live, tsu, first_runs
        # K15 on the whole pyramid, both directions, every side choice
        # (none included: all lanes invalid), a timestamp window.
        t_lo, t_hi = int(ts.min()), int(ts.max())
        window = (t_lo + (t_hi - t_lo) // 4, t_lo + (t_hi - t_lo) // 2)
        k15_cases = ((3, False, 1, U64M - 1), (1, True, 1, U64M - 1),
                     (2, False, 1, U64M - 1), (0, True, 1, U64M - 1),
                     (3, True, *window))

        def check_k15(label, cases):
            for j, (flags, desc, lo_ts, hi_ts) in enumerate(cases):
                a = (m.index.dr_levels, m.index.cr_levels, int(accts[j]), 0,
                     lo_ts, hi_ts, bool(flags & 1), bool(flags & 2), QUERY_K,
                     desc)
                errs["index_window"] = max(errs["index_window"], max_abs_err_card(
                    f"queries {label}: query_transfers flags {flags} desc {desc}",
                    dict(zip(("valid", "lo", "hi"), ix.query_transfers(*a))),
                    dict(zip(("valid", "lo", "hi"), ix.query_transfers_plain(*a)))))
            return len(cases)

        out["a"]["k15_checked"] = check_k15("a", k15_cases)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    # K15 on the full pyramid: one limit-8,190 query's kernels and plain;
    # K13 on the last batch's run, timed alone beside its in-path time.
    acct = int(accts[0])

    def k15_fn():
        return ix.query_transfers(m.index.dr_levels, m.index.cr_levels, acct,
                                  0, 1, U64M - 1, True, True, QUERY_K, False)

    with uncounted():
        k15 = timed(k15_fn)
        k15_loop = loop_ms(k15_fn)
        k15p = timed(lambda: ix.query_transfers_plain(
            m.index.dr_levels, m.index.cr_levels, acct, 0, 1, U64M - 1, True,
            True, QUERY_K, False), reps=3, warmup=1)
        last = gen_batch_np(n_batches - 1, LANES, COUNT, N_ACCOUNTS, 1 << 32)
        lid = t64(last["id_lo"], dev)
        look = ix.ht.lookup(m.ledger.transfers, lid, torch.zeros_like(lid),
                            ix.sm.MAX_PROBE, cols=(
                                "debit_account_id_lo", "debit_account_id_hi",
                                "credit_account_id_lo", "credit_account_id_hi",
                                "timestamp"))
        k13_sides = [ix._side_cols(look.cols, lid, torch.zeros_like(lid), f)
                     for f in ("debit_account_id", "credit_account_id")]
        k13_out = [[torch.empty(len(last), dtype=torch.int64, device=dev)
                    for _ in range(5)] for _ in range(2)]

        def k13_fn():
            return _cuda.run_sort(k13_sides, look.found, k13_out)

        out["k13"] = dict(
            **pair_times(timed(k13_fn), timed(lambda: [
                ix._sort_level_plain(ix._masked(s, look.found))
                for s in k13_sides])),
            loop_ms=loop_ms(k13_fn), library_ms=None,
            # Both sides' five columns and the found mask read, both
            # sorted runs written; a side's 55 compare-exchange rounds of
            # n/2 pairs and three merge rounds of n outputs.
            bound=bound(2 * len(last) * 40 + len(last) + 2 * len(last) * 40,
                        2 * ((len(last) // 2) * 55 * 8 + 3 * len(last) * 10)),
            shape=f"build_runs' sort of the last flagship batch: both sides "
                  f"of {len(last)} lanes in one launch")
        if "profile" in out["a"]:
            # A launch's device time in the path (one K13 launch a batch):
            # a short standalone profiler window of this kernel varies
            # between runs, the path's 64 launches do not.
            out["k13"].update(
                ms_standalone=out["k13"]["ms"],
                ms=out["a"]["profile"]["k13_run_sort_ms_per_batch"],
                ms_from="queries (a) profile window, one launch a batch")
        n_valid = int(k15_fn()[0].sum())
        # The windows that hold valid rows, and a query of an account with
        # no rows (everything in closed form).
        per_window = [int(ix._window_desc_plain(
            lv, acct, 0, 1, U64M - 1, QUERY_K, False)[1])
            for lv in m.index.dr_levels + m.index.cr_levels]
        k15_empty = timed(lambda: ix.query_transfers(
            m.index.dr_levels, m.index.cr_levels, N_ACCOUNTS + 7, 0, 1,
            U64M - 1, True, True, QUERY_K, False))["device_ms"]
        k15_phases = phase_clock().split("index_union", k15_fn)
    n_win = len(m.index.dr_levels) + len(m.index.cr_levels)
    deepest = max(lv.n for lv in m.index.dr_levels)
    # What the query must read: each window's binary search (24 B a step),
    # its valid candidates and the entry that ends each window, and the k
    # results it writes.
    out["k15"] = dict(**pair_times(k15, k15p), loop_ms=k15_loop, library_ms=None,
                      bound=bound(n_win * (deepest.bit_length() * 24 + 40)
                                  + n_valid * 40 + QUERY_K * 17,
                                  n_win * deepest.bit_length() * 10
                                  + n_win * QUERY_K * 4),
                      shape=f"one limit-8,190 query (k {QUERY_K}, {n_valid} rows) "
                            f"over {n_win} levels of both sides, one union "
                            "launch",
                      n_valid=n_valid, valid_per_window=per_window,
                      windows_with_valid=sum(1 for v in per_window if v),
                      no_rows_ms=k15_empty, launch=_cuda.index_window_info(),
                      phases_us=k15_phases, parent_ms_perf_md=K15_PARENT_MS)
    # A full rebuild: reset, then the next query rebuilds both sides at
    # the table's capacity (K13 chunks, then K14 rounds).
    m.index.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f = np.zeros(1, dtype=types.ACCOUNT_FILTER_DTYPE)[0]
    f["account_id_lo"], f["limit"], f["flags"] = int(accts[0]), 8190, 1
    m.get_account_transfers(f)
    torch.cuda.synchronize()
    out["a"]["rebuild_and_query_ms"] = (time.perf_counter() - t0) * 1e3
    out["a"]["rebuilt_levels"] = [lv.n for lv in m.index.dr_levels]
    again, walls2 = queries("a rebuilt")
    if again != first:
        raise AssertionError("queries: the rebuilt index answers differently")
    out["a"]["query_wall_ms_rebuilt"] = {"median": float(np.median(walls2)),
                                         "p99": float(np.percentile(walls2, 99))}
    peak = max(peak, torch.cuda.max_memory_allocated())
    out["a"]["peak_device_bytes"] = peak
    with uncounted():
        # The rebuilt level (K13 chunks, then K14 rounds, at the table's
        # capacity) against the plain full build, and K15 over it.
        k_top = max(j for j, o in enumerate(m.index.occupied) if o)
        live = ix._live(t)
        for side in ("dr", "cr"):
            errs["run_sort"] = max(errs["run_sort"], check_level(
                "a rebuilt", side, k_top, live))
        out["a"]["rebuilt_level_checked"] = m.index.base << k_top
        del live
        out["a"]["k15_checked"] += check_k15("a rebuilt", k15_cases[:2])
    out["full_size_errs"] = errs
    gc.collect()
    del m, sides, ids, ts, t
    gc.collect()

    # -- (b) -------------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    m = TorchStateMachine(LedgerConfig(), batch_lanes=LANES, device=dev)
    for start in range(0, N_ACCOUNTS, COUNT):
        if m.create_accounts(types.accounts_array(
                [types.account(id=i, ledger=1, code=10, flags=8)
                 for i in range(start + 1, min(N_ACCOUNTS, start + COUNT) + 1)])):
            raise AssertionError("queries: history account creation failed")
    out["b"] = run(m, "b")
    h = m.ledger.history
    count = int(h.count.item())
    if count != n_transfers:
        raise AssertionError(f"queries b: {count} history rows")
    hc = {name: to_np(col[:count]) for name, col in h.cols.items()}
    if (hc["dr_id_hi"].any() or hc["cr_id_hi"].any()
            or not (hc["timestamp"][1:] > hc["timestamp"][:-1]).all()):
        raise AssertionError("queries b: the history log's shape")
    hsides = {s: np.argsort(hc[s + "_id_lo"], kind="stable") for s in ("dr", "cr")}
    hkeys = {s: hc[s + "_id_lo"][hsides[s]] for s in ("dr", "cr")}
    fields = ("dp", "dpo", "cp", "cpo")
    names = ("debits_pending", "debits_posted", "credits_pending", "credits_posted")
    hwalls = []
    for i, acct in enumerate(accts):
        flags = flag_cycle[i % 4]
        f = np.zeros(1, dtype=types.ACCOUNT_FILTER_DTYPE)[0]
        f["account_id_lo"], f["limit"], f["flags"] = int(acct), 8190, flags
        t0 = time.perf_counter()
        got = m.get_account_history(f)
        hwalls.append((time.perf_counter() - t0) * 1e3)
        slots, side = [], []
        for bit, s in ((1, "dr"), (2, "cr")):
            if flags & bit:
                a = np.searchsorted(hkeys[s], acct)
                b = np.searchsorted(hkeys[s], acct, "right")
                slots.append(hsides[s][a:b])
                side.append(np.full(b - a, s == "dr"))
        sl, sd = np.concatenate(slots), np.concatenate(side)
        o = np.argsort(sl)
        if flags & 4:
            o = o[::-1]
        sl, sd = sl[o][:8190], sd[o][:8190]
        ok = len(got) == len(sl) and np.array_equal(got["timestamp"],
                                                    hc["timestamp"][sl])
        for fl, nm in zip(fields, names):
            for half in ("lo", "hi"):
                want = np.where(sd, hc[f"dr_{fl}_{half}"][sl], hc[f"cr_{fl}_{half}"][sl])
                ok = ok and np.array_equal(got[f"{nm}_{half}"], want)
        if not ok:
            raise AssertionError(f"queries b: history of account {acct} flags {flags}")
    out["b"]["history_rows"] = count
    out["b"]["history_capacity"] = h.capacity
    out["b"]["history_query_wall_ms"] = {"median": float(np.median(hwalls)),
                                         "p99": float(np.percentile(hwalls, 99))}
    out["b"]["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    k = min(h.capacity, 8190)
    # K16 against its plain version at this size, every output array
    # (the invalid fill included): both directions, each side, a
    # timestamp window, and fewer matches than k (512).
    t_lo, t_hi = int(hc["timestamp"][0]), int(hc["timestamp"][-1])
    with uncounted():
        for j, (flags, desc, lo_ts, hi_ts, kk) in enumerate((
                (3, True, 1, U64M - 1, k), (1, False, 1, U64M - 1, k),
                (2, True, 1, U64M - 1, k),
                (3, False, t_lo + (t_hi - t_lo) // 3, t_hi - (t_hi - t_lo) // 3, k),
                (3, True, 1, U64M - 1, 512))):
            a = (m.ledger, int(accts[j]), 0, lo_ts, hi_ts, bool(flags & 1),
                 bool(flags & 2), desc, kk)
            g, p = q.scan_history(*a), q.scan_history_plain(*a)
            errs["history_scan"] = max(errs["history_scan"], max_abs_err_card(
                f"queries b: scan_history flags {flags} desc {desc} k {kk}",
                {"valid": g[0], **g[1]}, {"valid": p[0], **p[1]}))
        out["b"]["k16_checked"] = j + 1
    # K16 at this size: one query's kernel (its one launch, the error word
    # left on the card: CUDA events behind a spin), its plain version, and
    # one torch.topk of the same key.  The plain version and the library
    # call are timed with CUDA events around back-to-back calls (a
    # torch.sort of 2^24 keys outlasts the launches), the profiler's
    # figures beside.
    acct = int(accts[0])

    def k16_fn(desc=True):
        return _cuda.history_scan(h.cols, h.count, acct, 0, 1, U64M - 1, True,
                                  True, desc, k, check=False)

    def k16_plain():
        return q.scan_history_plain(m.ledger, acct, 0, 1, U64M - 1, True,
                                    True, True, k)

    c = h.cols
    match = ((torch.arange(h.capacity, device=dev) < h.count)
             & (((c["dr_id_lo"] == acct) & (c["dr_id_hi"] == 0))
                | ((c["cr_id_lo"] == acct) & (c["cr_id_hi"] == 0))))
    key = torch.where(match, c["timestamp"], torch.zeros_like(c["timestamp"])) ^ INT64_MIN
    with uncounted():
        k16 = timed(k16_fn, reps=10)
        k16_asc = timed(lambda: k16_fn(False), reps=10)
        k16_loop = loop_ms(k16_fn, n=20)
        k16p = timed(k16_plain, reps=3, warmup=1)
        k16p_loop = loop_ms(k16_plain, n=5)
        k16p_kernels = profile_by_name(k16_plain, reps=3)
        lib = timed(lambda: torch.topk(key, k), reps=10)
        lib_loop = loop_ms(lambda: torch.topk(key, k), n=10)
    # What the function must move: the low words of both side ids of every
    # row below count, the matching side's high word and the timestamp of
    # a row whose low word matches, the k result rows' ten columns
    # (timestamp, a side's eight, the debit id) read, and the k results
    # written.  The kernel's order check reads every row's timestamp
    # besides (then a match adds only its high word): that design's cost
    # is printed apart.
    n_hit = int(((c["dr_id_lo"][:count] == acct)
                 | (c["cr_id_lo"][:count] == acct)).sum())
    rows_bytes = k * 10 * 8 + k * (1 + 9 * 8)
    out["k16"] = dict(**pair_times(k16, k16p), loop_ms=k16_loop,
                      ms_ascending=k16_asc["device_ms"],
                      bound=bound(count * 16 + n_hit * 16 + rows_bytes, count * 4),
                      bound_with_order_check_ms=bound(
                          count * 24 + n_hit * 8 + rows_bytes, count * 4)[0],
                      launches_a_query=1,
                      parent_ms_perf_md=K16_PARENT_MS,
                      shape=f"one history query, k {k}, log capacity {h.capacity} "
                            f"({count} rows); library: torch.topk of the key")
    out["k16"].update(
        plain_ms=k16p_loop, plain_ms_from="cuda events, 5 calls back to back",
        plain_ms_profiler=k16p["device_ms"],
        plain_kernels_profiler={n: v[0] for n, v in k16p_kernels.items()},
        library_ms=lib_loop, library_ms_from="cuda events, 10 calls back to back",
        library_ms_profiler=lib["device_ms"])
    torch.cuda.synchronize()
    out["launches"] = _cuda.counts()
    del m, hc
    gc.collect()
    missing = [k for k in INDEX_PATH if out["launches"][k] == 0]
    if missing:
        raise AssertionError(f"queries: kernels not launched {missing}")


# ---------------------------------------------------------------------------
# phases 16-17: the cold tier (K17-K19 and drop_evicted's K2 rebuild)
# ---------------------------------------------------------------------------

TIER_PATH = ("probe", "insert", "claim", "write_claimed", "full_pass",
             "bloom_check", "evict_threshold", "evict_extract")
TIER_ACCOUNTS = 10_000_000  # BASELINE.json config 4: 10M accounts
TIER_HOT_MAX = 1 << 23  # the hot window's ceiling, in slots
TIER_PENDINGS = 1024  # pending transfers in every 8th batch
TIER_COLD_POSTS = 512  # cold pendings posted or voided after an eviction
TIER_RESUBMITS = 256  # evicted ids resubmitted per batch, half with amount + 1
COLD_FILTER_LOG2 = (20, 28)  # Bloom filter sizes held against the plain version
COLD_TABLE_LOG2 = (8, 23, 25)  # table sizes held against the plain versions
COLD_TIMED_LOG2 = 23  # the table size timed (the tiered path's ceiling)
# The tiered general path's shape for K1's flag word (K17's step): the
# tiered run's 10,000,000 accounts (2^25 slots), its hot table at the
# eviction point (2^22 rows in 2^23 slots), the filter it reaches from its
# third eviction on (2^28 bits; 12 bits an evicted id) holding 20,000,000
# evicted ids, and TIER_RESUBMITS of them in a batch.
TIER_ACCOUNTS_LOG2 = 25
TIER_HOT_LOG2 = 23
TIER_HOT_ROWS = 1 << 22
TIER_COLD_IDS = 20_000_000
TIER_BLOOM_LOG2 = 28
TIER_FIRST_ID = 1 << 32
# The parents' times at these shapes (PERF.md §6, the parents' clock P0:
# tools/cold_history_times.py on the parent tree; NVIDIA H100 80GB HBM3,
# 700.00 W), printed beside this tree's.
K17_PARENT_MS = {"k1_3_lookups": 0.01144, "k1_7_lookups": 0.02836,
                 "gather_ctx_3": 0.0458, "gather_ctx_7": 0.0780,
                 "gather_ctx_runtime_calls_3": 17, "gather_ctx_runtime_calls_7": 21,
                 "masked_form_3": 0.00359, "masked_form_3_l2_flushed": 0.00614,
                 "masked_form_7": 0.00452, "masked_form_7_l2_flushed": 0.00808,
                 "out_form": 0.00322, "out_form_l2_flushed": 0.00547}
K16_PARENT_MS = {"query_2e24_log_desc": 0.3768, "query_2e24_log_asc": 0.3767,
                 "perf_md_row_b16d": 0.233}


def bloom_on_card(ids_lo, bits_log2: int):
    """The Bloom filter (int32 words) of ``ids_lo`` (id_hi 0), built on the
    card: a byte a bit set by index_put, then packed; the words
    ``cold.bloom_add_host`` makes."""
    import torch
    from tigerbeetle_tpu_torch.ops import cold

    dev = ids_lo.device
    bits = torch.zeros(1 << bits_log2, dtype=torch.uint8, device=dev)
    one = torch.ones((), dtype=torch.uint8, device=dev)
    for chunk in ids_lo.split(1 << 22):
        for pos in cold._bloom_positions(chunk, torch.zeros_like(chunk),
                                         1 << bits_log2):
            bits.index_put_((pos,), one)
    shifts = torch.arange(32, device=dev, dtype=torch.int64)
    words = (bits.view(-1, 32).to(torch.int64) << shifts).sum(1)
    del bits
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def tier_shape(dev):
    """The tiered general path's ledger (accounts 2^25 slots holding ids
    1..10,000,000; hot transfers 2^23 holding 2^22 rows, every 8th a
    pending; a posted table of 2^16), its 2^28-bit filter holding
    20,000,000 evicted ids, and two batches of COUNT events on LANES lanes
    with TIER_RESUBMITS evicted ids resubmitted: a plain one, and one whose
    every other lane posts or voids a pending (half of them hot, a quarter
    evicted, a quarter absent).  Returns (ledger, filter, plain SoA,
    post/void SoA)."""
    import torch
    from tigerbeetle_tpu_torch import convert, types
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import state_machine as sm
    from tigerbeetle_tpu_torch.ops import transfer_full as tf

    rng = np.random.default_rng(18)
    i64 = torch.int64
    ids = torch.arange(1, TIER_ACCOUNTS + 1, dtype=i64, device=dev)
    rows = {c: torch.zeros(TIER_ACCOUNTS, dtype=dt, device=dev)
            for c, dt in sm.ACCOUNT_COLS.items()}
    rows["ledger"].fill_(1)
    rows["code"].fill_(10)
    rows["timestamp"] = ids * 1000
    accounts = ht.rehash_into(1 << TIER_ACCOUNTS_LOG2, ids, torch.zeros_like(ids),
                              torch.ones_like(ids, dtype=torch.bool), rows)[0]
    del rows, ids
    hot = (TIER_FIRST_ID + TIER_COLD_IDS
           + torch.arange(TIER_HOT_ROWS, dtype=i64, device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    rows = {c: torch.zeros(TIER_HOT_ROWS, dtype=dt, device=dev)
            for c, dt in sm.TRANSFER_COLS.items()}
    for side in ("debit", "credit"):
        rows[f"{side}_account_id_lo"] = torch.randint(
            1, TIER_ACCOUNTS + 1, (TIER_HOT_ROWS,), device=dev, generator=gen)
    rows["amount_lo"] = torch.randint(1, 1 << 16, (TIER_HOT_ROWS,), device=dev,
                                      generator=gen)
    rows["ledger"].fill_(1)
    rows["code"].fill_(10)
    rows["flags"] = torch.where(torch.arange(TIER_HOT_ROWS, device=dev) % 8 == 0,
                                int(tf.TF_PENDING), 0).to(torch.int32)
    rows["timestamp"] = hot * 7
    transfers = ht.rehash_into(1 << TIER_HOT_LOG2, hot, torch.zeros_like(hot),
                               torch.ones_like(hot, dtype=torch.bool), rows)[0]
    del rows
    posted = ht.make_table(1 << 16, sm.POSTED_COLS, dev)
    bloom = bloom_on_card(TIER_FIRST_ID + torch.arange(
        TIER_COLD_IDS, dtype=i64, device=dev), TIER_BLOOM_LOG2)
    b = np.zeros(COUNT, dtype=types.TRANSFER_DTYPE)
    b["id_lo"] = TIER_FIRST_ID + TIER_COLD_IDS + TIER_HOT_ROWS + np.arange(COUNT)
    back = rng.choice(COUNT, TIER_RESUBMITS, replace=False)
    b["id_lo"][back] = TIER_FIRST_ID + rng.integers(0, TIER_COLD_IDS,
                                                     TIER_RESUBMITS)
    b["debit_account_id_lo"] = rng.integers(1, TIER_ACCOUNTS + 1, COUNT)
    b["credit_account_id_lo"] = rng.integers(1, TIER_ACCOUNTS + 1, COUNT)
    b["amount_lo"] = rng.integers(1, 1 << 16, COUNT)
    b["ledger"], b["code"] = 1, 10
    plain = convert.batch_to_tensors(b, LANES, dev)
    half = np.arange(0, COUNT, 2)
    b["flags"][half] = np.where(half % 4 == 0, int(tf.TF_POST), int(tf.TF_VOID))
    b["amount_lo"][half] = 0
    kind = rng.random(len(half))
    b["pending_id_lo"][half] = np.where(
        kind < 0.5, TIER_FIRST_ID + TIER_COLD_IDS
        + rng.integers(0, TIER_HOT_ROWS // 8, len(half)) * 8,
        np.where(kind < 0.75, TIER_FIRST_ID + rng.integers(0, TIER_COLD_IDS,
                                                            len(half)),
                 1 << 62))
    twophase = convert.batch_to_tensors(b, LANES, dev)
    ledger = sm.Ledger(accounts=accounts, transfers=transfers, posted=posted,
                       history=sm.make_history(1 << 4, dev))
    return ledger, bloom, plain, twophase


def runtime_calls(fn) -> int:
    """The CUDA runtime's launch and memset calls one call of ``fn`` makes
    (a CPU profile: every launch passes the host, whatever the card's trace
    records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith(("cudaLaunch", "cuLaunch", "cudaMemset")))


def tier_flag_shape(dev) -> dict:
    """K1's flag word (K17's step) at the tiered general path's shape
    (``tier_shape``), byte for byte against its plain form on the card:
    the word under every mask (no post/void lane and half of them; no lane,
    one in a hundred and every lane certified), and each lookup's found,
    slot and columns; ``build_gather_ctx``'s flags the same, its K1 one
    launch carrying the step and K17's own kernel not launched; K17's own
    launch in both forms against their plain versions.  Then, by
    CUDA events behind a spin (and after a 128 MB fill that overwrites the
    L2): K1 with and without the step, ``build_gather_ctx`` and its
    runtime calls, K17's own launch in both forms, beside the parents'
    times (PERF.md) and their bounds."""
    import torch
    from tigerbeetle_tpu_torch.ops import _cuda, cold
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import transfer_full as tf

    ledger, bloom, plain, twophase = tier_shape(dev)
    valid = torch.arange(LANES, device=dev) < COUNT
    some = torch.from_numpy(np.random.default_rng(17).random(LANES) < 0.01).to(dev)
    errs, checked, out = 0, {}, {}
    for name, soa, has_pv in (("3", plain, False), ("7", twophase, True)):
        postvoid = (((soa["flags"] & (tf.TF_POST | tf.TF_VOID)) != 0) & valid)
        looks = tf.gather_lookups(ledger, soa, valid, postvoid, True, has_pv)
        for ci, cert in enumerate((None, some, torch.ones_like(some))):
            with uncounted():
                got, word = ht.lookup_flags(looks, tf.MAX_PROBE, bloom, cert,
                                            tf.FLAG_COLD)
            want, want_word = ht.lookup_flags_plain(looks, tf.MAX_PROBE, bloom,
                                                    cert, tf.FLAG_COLD)
            errs = max(errs, max_abs_err_card(
                f"flag word, {name} lookups, certified {ci}",
                {"word": word.reshape(1)}, {"word": want_word.reshape(1)}))
            if ci == 0:
                for k, (g, w) in enumerate(zip(got, want)):
                    errs = max(errs, max_abs_err_card(
                        f"K1 with the step, {name} lookups, lookup {k}",
                        {"found": g.found, "slot": g.slot, **g.cols},
                        {"found": w.found, "slot": w.slot, **w.cols}))
            checked[f"word_{name}_certified{ci}"] = int(want_word)
        _cuda.reset_counts()
        ctx = tf.build_gather_ctx(ledger, soa, valid, postvoid, bloom, None,
                                  has_postvoid=has_pv)
        n = _cuda.counts()
        if (n["probe"], n["bloom_check"], _cuda.BLOOM_IN_PROBE) != (1, 1, 1):
            raise AssertionError(f"build_gather_ctx {name}: launches {n}")
        errs = max(errs, max_abs_err_card(
            f"build_gather_ctx flags, {name} lookups",
            {"flags": ctx.probe_grow.reshape(1)},
            {"flags": ht.lookup_flags_plain(looks, tf.MAX_PROBE, bloom, None,
                                            tf.FLAG_COLD)[1].reshape(1)}))
        found = [r.found for r in want]
        tested = int((valid & ~found[0]).sum())
        tested_p = int((postvoid & ~found[3]).sum()) if has_pv else 0
        # K1's bytes (as probe_path_shape counts them: keys, 17 B a visited
        # slot, the found rows' columns, the outputs) and the step's: four
        # 32-B sectors of the filter a tested id.
        k1_bytes = 0
        for lk, w in zip(looks, want):
            lo = lk.key_lo if lk.keys_from is None else want[lk.keys_from[0]].cols[lk.keys_from[1]]
            hi = (lk.key_hi if lk.keys_from is None else
                  (want[lk.keys_from[0]].cols[lk.keys_from[2]] if lk.keys_from[2]
                   else torch.zeros_like(lo)))
            width = sum(lk.table.cols[c].element_size() for c in lk.cols)
            k1_bytes += (16 * LANES + 17 * slot_visits(lk.table, lo, hi, tf.MAX_PROBE)
                         + int(w.found.sum()) * width + LANES * (1 + 8 + width))
        step_bytes = 4 * 32 * (tested + tested_p)
        mask_args = (bloom, soa["id_lo"], soa["id_hi"], valid, found[0],
                     soa["pending_id_lo"], soa["pending_id_hi"],
                     postvoid if has_pv else None, found[3] if has_pv else None,
                     None, torch.zeros((), dtype=torch.int32, device=dev),
                     tf.FLAG_COLD)
        with uncounted():
            errs = max(errs, max_abs_err_card(
                f"bloom_flag (K17's own launch), {name} lookups' masks",
                {"flag": cold.bloom_flag(*mask_args[:10], torch.zeros(
                    (), dtype=torch.int32, device=dev), tf.FLAG_COLD).reshape(1)},
                {"flag": cold.bloom_flag_plain(*mask_args).reshape(1)}))
        with uncounted():
            step = lambda: ht.lookup_flags(looks, tf.MAX_PROBE, bloom, None,  # noqa: E731
                                           tf.FLAG_COLD)
            k1 = lambda: ht.lookup_many(looks, tf.MAX_PROBE)  # noqa: E731
            ctx_fn = lambda: tf.build_gather_ctx(  # noqa: E731
                ledger, soa, valid, postvoid, bloom, None, has_postvoid=has_pv)
            with_step = timed(step)
            out[name] = {
                "tested_ids": tested, "tested_pending_ids": tested_p,
                "k1_with_step_ms": with_step["device_ms"],
                "k1_with_step_ms_from": with_step["device_ms_from"],
                "k1_ms": timed(k1)["device_ms"],
                "k1_word_no_test_ms": timed(lambda: ht.lookup_flags(
                    [lk._replace(cold=False) for lk in looks],
                    tf.MAX_PROBE))["device_ms"],
                "k1_with_step_ms_l2_flushed": cold_l2_ms(step),
                "k1_ms_l2_flushed": cold_l2_ms(k1),
                "gather_ctx_ms": timed(ctx_fn)["device_ms"],
                "gather_ctx_runtime_calls": runtime_calls(ctx_fn),
                "masked_form_ms": timed(lambda: cold.bloom_flag(*mask_args))["device_ms"],
                "masked_form_ms_l2_flushed": cold_l2_ms(
                    lambda: cold.bloom_flag(*mask_args)),
                "plain_ms": timed(lambda: ht.lookup_flags_plain(
                    looks, tf.MAX_PROBE, bloom, None, tf.FLAG_COLD),
                    reps=3, warmup=1)["device_ms"],
                "bound": bound(k1_bytes + step_bytes, 0),
                "step_bound_ms": step_bytes / H100_BYTES_PER_S * 1e3,
                "parent_ms_perf_md": {
                    "k1": K17_PARENT_MS[f"k1_{name}_lookups"],
                    "gather_ctx": K17_PARENT_MS[f"gather_ctx_{name}"],
                    "gather_ctx_runtime_calls":
                        K17_PARENT_MS[f"gather_ctx_runtime_calls_{name}"],
                    "masked_form": K17_PARENT_MS[f"masked_form_{name}"],
                    "masked_form_l2_flushed":
                        K17_PARENT_MS[f"masked_form_{name}_l2_flushed"]},
            }
            out[name]["step_ms"] = out[name]["k1_with_step_ms"] - out[name]["k1_ms"]
    lo, hi = plain["id_lo"], plain["id_hi"]
    with uncounted():
        errs = max(errs, max_abs_err_card(
            "bloom_check 2^28, the tiered batch's ids",
            {"hits": cold.bloom_check_impl(bloom, lo, hi)},
            {"hits": cold.bloom_check_plain(bloom, lo, hi)}))
        out["out_form_ms"] = timed(lambda: cold.bloom_check_impl(bloom, lo, hi))["device_ms"]
        out["out_form_ms_l2_flushed"] = cold_l2_ms(
            lambda: cold.bloom_check_impl(bloom, lo, hi))
    out["out_form_bound_ms"] = bound(LANES * (16 + 4 * 32 + 1), 0)[0]
    out["out_form_parent_ms_perf_md"] = {
        "warm": K17_PARENT_MS["out_form"],
        "l2_flushed": K17_PARENT_MS["out_form_l2_flushed"]}
    out["launch"] = _cuda.probe_info()
    out["shape"] = (f"{COUNT} events on {LANES} lanes; accounts 2^{TIER_ACCOUNTS_LOG2} "
                    f"holding {TIER_ACCOUNTS}, hot transfers 2^{TIER_HOT_LOG2} "
                    f"holding {TIER_HOT_ROWS}, filter 2^{TIER_BLOOM_LOG2} bits "
                    f"holding {TIER_COLD_IDS} ids; {TIER_RESUBMITS} resubmitted")
    del ledger, bloom
    gc.collect()
    torch.cuda.empty_cache()
    return {"max_abs_err": errs, "checked": checked, **out}


def evict_test_table(dev, cap, live_frac=0.5, tomb_frac=1 / 16):
    """A transfers table of ``cap`` slots on the card: ``live_frac`` of the
    slots hold rows (distinct ids, one in seven with a high half;
    timestamps with repeats), then ``tomb_frac`` of the slots tombstoned;
    made through K2 and K8."""
    import torch
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import state_machine as sm
    from tigerbeetle_tpu_torch.u128 import mix64

    n = int(cap * live_frac)
    idx = torch.arange(1, n + 1, device=dev, dtype=torch.int64)
    ids = mix64(idx, torch.zeros_like(idx))  # a bijection: distinct ids
    ids = torch.where(ids == 0, -1, ids)
    hi = (idx % 7 == 0).to(torch.int64) * 3
    rows = {name: (idx * 2654435761).to(dt) for name, dt in sm.TRANSFER_COLS.items()}
    rows["timestamp"] = 1 + (idx * 7919) % (n // 2 + 1)
    t = ht.make_table(cap, sm.TRANSFER_COLS, dev)
    ht.insert(t, ids, hi, torch.ones(n, dtype=torch.bool, device=dev), rows, cap)
    dead = int(cap * tomb_frac)
    if dead:
        look = ht.lookup(t, ids[:dead], hi[:dead], cap)
        ht.remove_to_tombstone(t, look.slot, look.found)
    return t


def table_tensors(t) -> dict:
    return {"key_lo": t.key_lo, "key_hi": t.key_hi, "tombstone": t.tombstone,
            "count": t.count.reshape(1),
            "probe_overflow": t.probe_overflow.reshape(1),
            **{"col:" + k: v for k, v in t.cols.items()}}


def phase_cold_kernels(seed: int, dev) -> dict:
    """K17 bloom_check, K18 evict_threshold, K19 evict_extract and
    drop_evicted's K2 rebuild against their plain versions on the card,
    byte for byte on every output array: filters of 2^20 and 2^28 bits
    (each lane's hit, and the general kernel's masked form with its
    FLAG_COLD word under every mask), tables of 2^8, 2^23 and 2^25 slots
    with tombstones at fractions 0.001-0.999, empty tables and the C-1
    clamp.  Each timed at the tiered path's shapes (8,192 lanes on a 2^28
    filter; a 2^23-slot table) beside its plain version and bound."""
    import torch
    from tigerbeetle_tpu_torch import convert
    from tigerbeetle_tpu_torch.ops import cold
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import state_machine as sm
    from tigerbeetle_tpu_torch.ops import transfer_full as tf

    rng = np.random.default_rng(seed + 17)
    results, checked = {}, {}

    # -- K17 ------------------------------------------------------------------
    lo = t64(rand_u64(rng, LANES), dev)
    hi = t64(np.where(rng.random(LANES) < 0.1, rand_u64(rng, LANES), 0)
             .astype(np.uint64), dev)
    plo, phi = t64(rand_u64(rng, LANES), dev), torch.zeros_like(lo)
    valid = torch.arange(LANES, device=dev) < COUNT
    found = torch.from_numpy(rng.random(LANES) < 0.5).to(dev) & valid
    postvoid = torch.from_numpy(rng.random(LANES) < 0.5).to(dev) & valid
    p_found = torch.from_numpy(rng.random(LANES) < 0.5).to(dev) & postvoid
    errs = 0
    for bits_log2 in COLD_FILTER_LOG2:
        words = np.zeros((1 << bits_log2) // 32, np.uint32)
        # A third of the ids and pending ids are in the filter; the others
        # hit at its false-positive rate.
        cold.bloom_add_host(words, to_np(lo)[::3], to_np(hi)[::3])
        cold.bloom_add_host(words, to_np(plo)[::3], to_np(phi)[::3])
        bloom = convert.bloom_to_tensor(words, dev)
        errs = max(errs, max_abs_err(
            f"bloom_check 2^{bits_log2}",
            {"hits": to_np(cold.bloom_check_impl(bloom, lo, hi))},
            {"hits": to_np(cold.bloom_check_plain(bloom, lo, hi))}))
        for ci, certified in enumerate((
                None, torch.from_numpy(rng.random(LANES) < 0.99).to(dev),
                torch.ones(LANES, dtype=torch.bool, device=dev))):
            for pv in (None, postvoid):
                args = (bloom, lo, hi, valid, found, plo, phi, pv, p_found,
                        certified)
                zero = torch.zeros((), dtype=torch.int32, device=dev)
                got = cold.bloom_flag(*args, zero.clone(), tf.FLAG_COLD)
                want = cold.bloom_flag_plain(*args, zero.clone(), tf.FLAG_COLD)
                errs = max(errs, max_abs_err(
                    f"bloom_flag 2^{bits_log2}", {"flag": to_np(got.reshape(1))},
                    {"flag": to_np(want.reshape(1))}))
                checked[f"flag_2^{bits_log2}_certified{ci}_pv{pv is not None}"] = int(got)
    del bloom
    # K17 on the tiered general path: a step of K1's launch (its flag
    # word), checked and timed at that path's shape; the row's time is the
    # K1 launch that carries it (no post/void lane, as most of the tiered
    # run's batches), its plain time the flag word's plain form.
    tier = tier_flag_shape(dev)
    three = tier["3"]
    results["bloom_check"] = dict(
        max_abs_err=max(errs, tier["max_abs_err"]), ms=three["k1_with_step_ms"],
        plain_ms=three["plain_ms"], ms_from=three["k1_with_step_ms_from"],
        library_ms=None, bound=three["bound"],
        step_ms=three["step_ms"], step_bound_ms=three["step_bound_ms"],
        ms_7_lookups=tier["7"]["k1_with_step_ms"],
        ms_own_out_form=tier["out_form_ms"],
        ms_own_masked_form=three["masked_form_ms"],
        shape="the K1 launch carrying K17's step (3 lookups), " + tier["shape"])
    checked.update(tier.pop("checked"))
    results["k17_tier_shape"] = tier

    # -- K18, K19 and drop_evicted's K2 rebuild -------------------------------
    errs18 = errs19 = errs2 = 0
    for log2 in COLD_TABLE_LOG2:
        cap = 1 << log2
        t = evict_test_table(dev, cap)
        empty = ht.make_table(cap, sm.TRANSFER_COLS, dev)
        for table, kind in ((t, "tombstones"), (empty, "empty")):
            for num in (1, 250, 500, 999):
                thr = cold.eviction_threshold(table, num, 1000)
                errs18 = max(errs18, max_abs_err(
                    f"evict_threshold 2^{log2} {kind} {num}",
                    {"t": to_np(thr.reshape(1))},
                    {"t": to_np(cold.eviction_threshold_plain(
                        table, num, 1000).reshape(1))}))
                if log2 > COLD_TABLE_LOG2[0] and num in (1, 500):
                    continue
                got = cold.extract_evicted(table, thr, cap, keep=True)
                want = cold.extract_evicted_plain(table, thr, cap)
                errs19 = max(errs19, max_abs_err_card(
                    f"evict_extract 2^{log2} {kind} {num}",
                    {"n": got[0].reshape(1), "lo": got[1], "hi": got[2],
                     "keep": got[4], **got[3]},
                    {"n": want[0].reshape(1), "lo": want[1], "hi": want[2],
                     "keep": cold.keep_mask_plain(table, thr), **want[3]}))
                checked[f"evicted_2^{log2}_{kind}_{num}"] = int(got[0])
                if num == 250:
                    errs2 = max(errs2, max_abs_err_card(
                        f"drop_evicted 2^{log2} {kind}",
                        table_tensors(cold.drop_evicted(table, thr, got[4])),
                        table_tensors(cold.drop_evicted_plain(table, thr))))
                del got, want
        saved = t.count.clone()
        t.count.fill_(4 * cap)  # k = count * 999 // 1000 > C - 1: clamped
        errs18 = max(errs18, max_abs_err(
            f"evict_threshold 2^{log2} clamp",
            {"t": to_np(cold.eviction_threshold(t, 999, 1000).reshape(1))},
            {"t": to_np(cold.eviction_threshold_plain(t, 999, 1000).reshape(1))}))
        t.count.copy_(saved)
        if log2 == COLD_TIMED_LOG2:
            results.update(time_evict(t, dev))
        del t, empty
        gc.collect()
        torch.cuda.empty_cache()
    results["evict_threshold"]["max_abs_err"] = errs18
    results["evict_extract"]["max_abs_err"] = errs19
    results["drop_evicted_k2"]["max_abs_err"] = errs2
    torch.cuda.synchronize()
    return {"results": results, "checked": checked}


def time_evict(t, dev) -> dict:
    """K18, K19 and the K2 rebuild timed on a 2^23-slot table (the tiered
    path's hot ceiling) at the path's fraction (one half), beside their
    plain versions and bounds.  ``ms`` and ``plain_ms`` come from CUDA
    events around back-to-back calls (each call outlasts its host work):
    a short profiler window can read a kernel below its bytes bound, so the
    profiler's figure stands beside, as ``ms_profiler``."""
    import torch
    from tigerbeetle_tpu_torch.ops import cold
    from tigerbeetle_tpu_torch.u128 import INT64_MIN

    cap, num = t.capacity, 500
    thr = cold.eviction_threshold(t, num, 1000)
    live = int(cold._live(t).sum())
    got = cold.extract_evicted(t, thr, cap, keep=True)
    n, keep = int(got[0]), got[4]
    kept = int(keep.sum())
    del got
    row_bytes = sum(c.element_size() for c in t.cols.values())
    keys = torch.where(cold._live(t), t.cols["timestamp"],
                       torch.full_like(t.key_lo, -1)) ^ INT64_MIN
    kth = min(int(t.count) * num // 1000, cap - 1) + 1

    def events(kernel, plain, reps=20):
        k, p = timed(kernel, reps=5), timed(plain, reps=5)
        return {"ms": loop_ms(kernel, reps), "plain_ms": loop_ms(plain, reps),
                "ms_from": "cuda events, back-to-back calls",
                "ms_profiler": k["device_ms"], "plain_ms_profiler": p["device_ms"],
                "call_ms": k["call_ms"], "plain_call_ms": p["call_ms"]}

    return {
        "evict_threshold": dict(
            **events(lambda: cold.eviction_threshold(t, num, 1000),
                     lambda: cold.eviction_threshold_plain(t, num, 1000)),
            library_ms=loop_ms(lambda: torch.kthvalue(keys, kth), 5),
            # Keys, tombstone and timestamp read once; the threshold written.
            bound=bound(cap * 25 + 8, cap * 8 * 4),
            shape=f"2^{cap.bit_length() - 1} slots, {live} live, frac "
                  f"{num}/1000; library: torch.kthvalue of the live-masked "
                  "unsigned keys"),
        "evict_extract": dict(
            **events(lambda: cold.extract_evicted(t, thr, cap, keep=True),
                     lambda: (cold.extract_evicted_plain(t, thr, cap),
                              cold.keep_mask_plain(t, thr))),
            library_ms=None,
            # The masks' 25 B a slot, the evicted rows' columns gathered, C
            # output lanes of keys and columns, the keep mask and n written.
            bound=bound(cap * 25 + n * row_bytes + cap * (16 + row_bytes)
                        + cap + 8, cap * 10),
            shape=f"2^{cap.bit_length() - 1} slots, {n} of {live} live rows "
                  "evicted, k = C"),
        "drop_evicted_k2": dict(
            **events(lambda: cold.drop_evicted(t, thr, keep),
                     lambda: cold.drop_evicted_plain(t, thr, keep), reps=5),
            library_ms=None,
            # The keep mask and the kept rows' keys and columns read; the
            # fresh table written whole (as round_form_shapes counts it).
            bound=bound(cap + kept * (16 + row_bytes) + cap * (17 + row_bytes),
                        cap * 10),
            shape=f"2^{cap.bit_length() - 1} slots, {kept} kept "
                  "rows reinserted (K2's insert, its round form writing the "
                  "new table whole)"),
    }


def tier_batch(b, m, pendings, cold_posts_due, rng):
    """Batch ``b`` of the tiered traffic: the flagship generator's plain
    transfers over TIER_ACCOUNTS accounts; in every 8th batch the first
    TIER_PENDINGS lanes are pending; after an eviction, TIER_COLD_POSTS
    lanes post or void pendings that are now cold; once anything is cold,
    TIER_RESUBMITS lanes resubmit evicted plain transfers (TigerBeetle's
    client retry), half exactly (code 46) and half with amount + 1 (39).
    Returns (batch, the expected codes)."""
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.utils.benchgen import gen_batch_np

    batch = gen_batch_np(b, LANES, COUNT, TIER_ACCOUNTS, 1 << 32)
    want = np.zeros(COUNT, np.uint32)
    if b % 8 == 0:
        batch["flags"][:TIER_PENDINGS] = types.TransferFlags.PENDING
        pendings.extend(batch["id_lo"][:TIER_PENDINGS].tolist())
    lane = TIER_PENDINGS
    if cold_posts_due and pendings:
        cand = np.array(pendings[:4 * TIER_COLD_POSTS], np.uint64)
        is_cold, _ = m.cold.lookup_rows(cand, np.zeros_like(cand))
        take = cand[is_cold][:TIER_COLD_POSTS]
        done = set(take.tolist())
        pendings[:] = [p for p in pendings if p not in done]
        sl = slice(lane, lane + len(take))
        for f in ("debit_account_id_lo", "credit_account_id_lo", "amount_lo",
                  "ledger", "code"):
            batch[f][sl] = 0
        batch["pending_id_lo"][sl] = take
        batch["flags"][sl] = np.where(
            np.arange(len(take)) % 2 == 0,
            types.TransferFlags.POST_PENDING_TRANSFER,
            types.TransferFlags.VOID_PENDING_TRANSFER)
        lane += len(take)
    if m.cold.count:
        run = m.cold.runs[int(rng.integers(len(m.cold.runs)))]
        pick = np.asarray(run)[rng.integers(0, len(run), 4 * TIER_RESUBMITS)]
        pick = pick[(pick["flags"] == 0)]
        pick = pick[np.unique(pick["id_lo"], return_index=True)[1]]
        pick = pick[:TIER_RESUBMITS]
        sl = slice(lane, lane + len(pick))
        for f in ("id_lo", "debit_account_id_lo", "credit_account_id_lo",
                  "amount_lo", "ledger", "code", "flags", "pending_id_lo"):
            batch[f][sl] = pick[f]
        batch["amount_lo"][sl][1::2] += 1
        want[sl] = np.where(np.arange(len(pick)) % 2 == 0, 46, 39)
    return batch, want


def phase_tiered(dev, n_transfers: int) -> dict:
    """The cold tier at full width: a tiered machine (hot ceiling 2^23 slots,
    in-memory runs, lazy index) and an untiered twin, both with 10,000,000
    accounts, fed the same ``tier_batch`` traffic for ``n_transfers``
    transfers.  Every code equal to the twin's and to the traffic's
    expectation; then the accounts tables byte-identical, lookup_transfers
    of 8,190 ids across hot and cold and 100 get_account_transfers at
    limit 8,190 equal, and the tiered machine's distinct transfers (hot and
    cold) equal to the twin's count.  Reports the rate, the FLAG_COLD
    retries and rehydrated lanes, the host ms of each _resolve_cold, each
    eviction's wall by step, the Bloom filter's size over time, the device
    idle share of a profiled window and the peak device memory."""
    import torch
    from tigerbeetle_tpu_torch import convert, types
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import cold

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = LedgerConfig(lazy_index=True)
    m = TorchStateMachine(cfg, batch_lanes=LANES, device=dev,
                          hot_transfers_capacity_max=TIER_HOT_MAX)
    twin = TorchStateMachine(cfg, batch_lanes=LANES, device=dev)
    t0 = time.perf_counter()
    for start in range(0, TIER_ACCOUNTS, COUNT):
        n = min(COUNT, TIER_ACCOUNTS - start)
        acc = np.zeros(n, dtype=types.ACCOUNT_DTYPE)
        acc["id_lo"] = np.arange(start + 1, start + n + 1, dtype=np.uint64)
        acc["ledger"], acc["code"] = 1, 10
        if m.create_accounts(acc) != [] or twin.create_accounts(acc) != []:
            raise AssertionError("tiered: account creation failed")
    accounts_s = time.perf_counter() - t0

    # Timers around each step of an eviction and each cold resolution; they
    # synchronize, so the steps' walls are the card's and the host's.
    steps = {}

    def timer(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            s = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            steps.setdefault(name, []).append((time.perf_counter() - s) * 1e3)
            return out
        return run

    saved = {name: getattr(cold, name) for name in (
        "eviction_threshold", "extract_evicted", "rows_to_numpy",
        "drop_evicted", "bloom_add_host")}
    saved_b2t = convert.bloom_to_tensor
    for name, fn in saved.items():
        setattr(cold, name, timer(name, fn))
    convert.bloom_to_tensor = timer("bloom_to_tensor", saved_b2t)
    m.cold.append_run = timer("append_run (lexsort)", m.cold.append_run)
    m._maybe_grow_bloom = timer("maybe_grow_bloom", m._maybe_grow_bloom)
    m._resolve_cold = timer("resolve_cold", m._resolve_cold)
    merges = []
    merge = m.cold._merge_all
    m.cold._merge_all = lambda: merges.append(m.cold.count) or merge()

    rng = np.random.default_rng(5)
    pendings = []
    n_batches = max(1, (n_transfers + COUNT - 1) // COUNT)
    window = range(n_batches - 1 - PROFILE_BATCHES, n_batches - 1)
    if window.start < 0:
        window = range(0)
    launches = dict.fromkeys(_cuda.KERNELS, 0)
    k10_stats = {"ran": 0, "sorted": 0}  # K10's launches: ran, sorted
    round_form_calls = 0  # K2's round form: its growths and rebuilds
    bloom_in_probe = 0  # K1 launches that carried K17's step
    tier_s = twin_s = 0.0
    prof, prof_wall_ms = None, 0.0
    evictions, bloom_over_time, flagged = [], [], 0
    cold_posts_due = False
    twin_due = []
    try:
        for b in range(n_batches):
            batch, want = tier_batch(b, m, pendings, cold_posts_due, rng)
            ev0, retries0 = m._evictions, m.cold_retries
            if window and b == window.start:
                torch.cuda.synchronize()
                prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            before = _cuda.counts()
            rf0, bp0 = _cuda.ROUND_FORM_CALLS, _cuda.BLOOM_IN_PROBE
            k10_0 = legs_stats_now(dev)
            s = time.perf_counter()
            got = m.create_transfers(batch)
            dt = time.perf_counter() - s
            for k, v in stats_since(dev, k10_0).items():
                k10_stats[k] += v
            for k, v in _cuda.counts().items():
                launches[k] += v - before[k]
            round_form_calls += _cuda.ROUND_FORM_CALLS - rf0
            bloom_in_probe += _cuda.BLOOM_IN_PROBE - bp0
            tier_s += dt
            if b in window:
                prof_wall_ms += dt * 1e3
            exp = TorchStateMachine._compress(want, COUNT)
            if got != exp:
                raise AssertionError(f"tiered: batch {b} codes {got[:4]}, "
                                     f"expected {exp[:4]}")
            # The profiled window holds the tiered machine's commits only:
            # the twin takes those batches after it.
            twin_due.append((b, batch, got))
            if window and b == window.stop - 1:
                torch.cuda.synchronize()
                prof.__exit__(None, None, None)
            if b not in window:
                for tb, tbatch, tgot in twin_due:
                    s = time.perf_counter()
                    twin_got = twin.create_transfers(tbatch)
                    twin_s += time.perf_counter() - s
                    if tgot != twin_got:
                        raise AssertionError(
                            f"tiered: batch {tb} codes differ from the twin's: "
                            f"{tgot[:4]} vs {twin_got[:4]}")
                twin_due.clear()
            flagged += m.cold_retries > retries0
            cold_posts_due = m._evictions > ev0
            if cold_posts_due:
                evictions.append({"batch": b, "cold_rows": m.cold.count,
                                  "runs": len(m.cold.runs),
                                  "bloom_bits_log2": m._bloom_log2})
                bloom_over_time.append((b, m._bloom_log2))
        torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(cold, name, fn)
        convert.bloom_to_tensor = saved_b2t
    if not merges:
        raise AssertionError("tiered: no merge of the cold runs happened")
    missing = [k for k in TIER_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"tiered: kernels not launched {missing}")
    # K17 runs as a step of K1's launch on the general path: every count
    # of it is such a launch, and its own kernel is never launched.
    if bloom_in_probe != launches["bloom_check"]:
        raise AssertionError(
            f"tiered: {launches['bloom_check'] - bloom_in_probe} launches of "
            f"K17's own kernel on the general path")
    peak = torch.cuda.max_memory_allocated()

    # -- the checks against the twin ---------------------------------------------
    errs = max_abs_err_card("tiered accounts", table_tensors(m.ledger.accounts),
                            table_tensors(twin.ledger.accounts))
    hot_ids = to_np(m.ledger.transfers.key_lo)[to_np(m.ledger.transfers.key_lo) != 0]
    cold_ids = np.concatenate([np.asarray(r["id_lo"]) for r in m.cold.runs])
    distinct = len(np.unique(np.concatenate([hot_ids, cold_ids])))
    twin_count = int(twin.ledger.transfers.count)
    if distinct != twin_count:
        raise AssertionError(f"tiered: {distinct} distinct transfers (hot and "
                             f"cold), the twin has {twin_count}")
    last_id = (1 << 32) + n_batches * COUNT
    ids = rng.integers(1 << 32, last_id, COUNT).tolist()
    ids[::7] = rng.choice(cold_ids, len(ids[::7])).tolist()
    s = time.perf_counter()
    got = m.lookup_transfers(ids)
    lookup_ms = (time.perf_counter() - s) * 1e3
    want = twin.lookup_transfers(ids)
    if got.tobytes() != want.tobytes():
        raise AssertionError("tiered: lookup_transfers differs from the twin's")
    f = np.zeros(1, dtype=types.ACCOUNT_FILTER_DTYPE)[0]
    f["limit"] = COUNT
    q_ms, rows_seen = [], 0
    for q, acct in enumerate(rng.integers(1, TIER_ACCOUNTS + 1, 100)):
        f["account_id_lo"], f["flags"] = int(acct), (1, 2, 3, 7)[q % 4]
        s = time.perf_counter()
        got = m.get_account_transfers(f)
        q_ms.append((time.perf_counter() - s) * 1e3)
        if got.tobytes() != twin.get_account_transfers(f).tobytes():
            raise AssertionError(f"tiered: get_account_transfers({acct}) differs")
        rows_seen += len(got)
    profile = None
    if prof is not None:
        by_name = {}
        busy = device_us(prof, by_name) / 1e3
        if busy <= 0:
            raise AssertionError("tiered: the profile recorded no device time")
        profile = {
            "batches": len(window), "commit_wall_ms": prof_wall_ms,
            "device_busy_ms_per_batch": busy / len(window),
            "device_idle_share": 1 - busy / prof_wall_ms,
            "device_ms_per_batch_by_name": {
                k: v / 1e3 / len(window) for k, v in sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:12]},
            # K10's part of the busy time: the legs' scan and the apply.
            "k10_share_of_busy": sum(
                v for k, v in by_name.items() if "full_legs" in k) / 1e3 / busy,
        }
    ledger_bytes = {
        name: sum(sum(x.numel() * x.element_size() for x in
                      [t.key_lo, t.key_hi, t.tombstone, *t.cols.values()])
                  for t in (mm.ledger.accounts, mm.ledger.transfers, mm.ledger.posted))
        for name, mm in (("tiered", m), ("twin", twin))}
    summary = {name: {"calls": len(v), "ms_mean": float(np.mean(v)),
                      "ms_max": float(np.max(v)), "ms_total": float(np.sum(v))}
               for name, v in steps.items()}
    return {
        "accounts": TIER_ACCOUNTS, "transfers": n_batches * COUNT,
        "batches": n_batches, "accounts_s": accounts_s,
        "transfers_per_s": n_batches * COUNT / tier_s,
        "twin_transfers_per_s": n_batches * COUNT / twin_s,
        "tiered_wall_ms_per_batch": tier_s * 1e3 / n_batches,
        "batches_flagged_cold": flagged, "cold_retries": m.cold_retries,
        "lanes_rehydrated": m.rehydrated_rows, "evictions": evictions,
        "merges": len(merges), "bloom_over_time": bloom_over_time,
        "cold_rows": m.cold.count, "hot_rows": int(m.ledger.transfers.count),
        "distinct_transfers": distinct, "twin_transfers": twin_count,
        "steps_ms": summary,
        "lookup_8190_ms": lookup_ms,
        "query_ms_median": float(np.median(q_ms)),
        "query_ms_p99": float(np.percentile(q_ms, 99)),
        "query_rows_mean": rows_seen / 100,
        "accounts_max_abs_err": errs,
        "peak_device_bytes": peak, "ledger_bytes": ledger_bytes,
        "profile": profile, "launches": launches, "k10_stats": k10_stats,
        "k2_round_form_calls": round_form_calls,
        "k17_launches_in_k1": bloom_in_probe,
        "k17_own_launches": launches["bloom_check"] - bloom_in_probe,
    }


# ---------------------------------------------------------------------------
# phases 18-20: the flagship bench twin (K20), scrub and Merkle (K21-K23)
# ---------------------------------------------------------------------------

# The commitments phase's depth and root-check cadence, cut from the
# flagship's 2,000,000 transfers and a check every 100 batches: the paranoid
# mode's host mirror (testing/model.py, a Python oracle) costs about 0.4 s
# a batch, and its digests about 1 us a transfer at every check.  250,000
# (31 batches: the SDC flip at 10, the fault at 20, root checks at 20 and
# 31) keeps the whole script near 720 s with the sharding phases.
COMMIT_TRANSFERS = 250_000
ROOT_CHECK_EVERY = 20
SCRUB_SIZES_LOG2 = (8, 15, 25)  # scrub_kernels' pad sizes

FLAGSHIP_PATH = ("bench_gen", "probe", "insert", "validate", "balance",
                 "group_words")
COMMIT_PATH = ("scrub_fold", "merkle_build", "merkle_touch", "probe")
# K20 writes fourteen u64 and five u32 columns a lane.
GEN_BYTES_PER_LANE = 14 * 8 + 5 * 4
# mix64 is about ten integer operations.
MIX64_OPS = 10


def cold_l2_ms(fn) -> float:
    """Device ms of ``fn`` with a 128 MB fill before each call, which
    overwrites the 50 MB L2 (a scrub or a rebuild finds the tables cold):
    ``timed`` of fill and call, less ``timed`` of the fill alone."""
    import torch

    flush = torch.empty(1 << 24, dtype=torch.int64, device="cuda")
    both = timed(lambda: (flush.fill_(1), fn()))["device_ms"]
    return both - timed(lambda: flush.fill_(1))["device_ms"]


def after_idle_ms(fn, reps: int = 10) -> dict:
    """Device ms of ``fn`` when each call finds the card idle for 20 ms, as
    the host leaves it between a path's batches: CUDA events around the
    call, queued behind a 1 ms spin that covers the host's launch work
    (5 ms where 1 did not).  ``calls``: the calls so timed."""
    import torch

    total, held = 0.0, 0
    for _ in range(reps):
        for spin_ms in (1.0, 5.0):
            torch.cuda.synchronize()
            time.sleep(0.02)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
            start.record()
            fn()
            end.record()
            queued = not start.query()
            end.synchronize()
            if queued:
                total += start.elapsed_time(end)
                held += 1
                break
    return {"ms": total / held if held else None, "calls": held}


def touch_keys(batch):
    """The keys one flagship batch touches, per pad, as the machine's
    ``_merkle_update_transfers_batches`` gathers them (every id fits the
    low word): the transfer ids, and the debit and credit ids deduped."""
    sides = np.concatenate([batch["debit_account_id_lo"],
                            batch["credit_account_id_lo"]])
    return (("transfers", batch["id_lo"].astype(np.uint64)),
            ("accounts", np.unique(sides.astype(np.uint64))))


def touch_lookup(table, keys: np.ndarray):
    """K1's probe of ``keys``, padded as ``TorchStateMachine._merkle_pad``
    pads them (a power of two of at least 256 lanes, zero keys after)."""
    import torch
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import state_machine as sm

    lanes = max(256, 1 << (len(keys) - 1).bit_length())
    ids = torch.zeros(lanes, dtype=torch.int64, device=table.key_lo.device)
    ids[:len(keys)] = torch.from_numpy(keys.view(np.int64)).to(ids.device)
    return ht.lookup(table, ids, torch.zeros_like(ids), sm.MAX_PROBE)


def touch_bound(table, lk, pad: str):
    """(bytes, operations) that one K23 touch of the probed lanes ``lk``
    must move and do: every lane's slot and found words read; each
    distinct touched row read and its leaf written once; each distinct
    ancestor (per level, the unique (C + slot) >> level) read as its two
    children and written once."""
    import torch

    row_bytes, row_mixes = {"accounts": (16 + 72, 6),
                            "transfers": (16 + 24, 3)}[pad]
    lanes = lk.slot.numel()
    nodes = torch.unique(lk.slot[lk.found]) + table.capacity
    leaves = nodes.numel()
    ancestors = 0
    for _ in range(table.capacity.bit_length() - 1):
        nodes = torch.unique(nodes >> 1)
        ancestors += nodes.numel()
    return (9 * lanes + (row_bytes + 8) * leaves + 24 * ancestors,
            (row_mixes * leaves + ancestors) * MIX64_OPS)


def balances_by_id(keys_lo, cols: dict) -> dict:
    """{column: u64[n]} of the live slots, ordered by id (u64 numpy)."""
    lo = to_np(keys_lo)
    live = np.flatnonzero(lo)
    order = live[np.argsort(lo[live], kind="stable")]
    out = {"id": lo[order]}
    out.update({c: to_np(v)[order] for c, v in cols.items()})
    return out


def phase_flagship(dev, seed: int, main_snapshot, twin_args) -> dict:
    """K20 against its plain version on the card (byte for byte, where
    b * count + lane passes 2^32 too) and against bench.py's numpy mirrors;
    then the bench twin's three shapes at bench.py's defaults through
    ``tigerbeetle_tpu_torch.bench.run`` (what ``python -m
    tigerbeetle_tpu_torch.bench`` calls), each printing its JSON line; after
    the plain shape every account's balances equal the main phase's after
    the same batches."""
    import torch
    from tigerbeetle_tpu_torch import bench
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import state_machine as sm
    from tigerbeetle_tpu_torch.utils import benchgen

    checked = 0
    first_tid = bench.FIRST_TID
    with uncounted():
        for mode in (benchgen.MODE_PLAIN, benchgen.MODE_TWO_PHASE,
                     benchgen.MODE_TWOP):
            for b in (0, 1, (1 << 32) // COUNT + 1, 1 << 40):
                got = benchgen._generate(mode, b, LANES, COUNT, N_ACCOUNTS,
                                         first_tid, None,
                                         benchgen.empty_soa(LANES, dev))
                want = benchgen.gen_batch_plain(mode, b, LANES, COUNT,
                                                N_ACCOUNTS, first_tid, dev)
                max_abs_err_card(f"bench_gen mode {mode} b {b}", got, want)
                if mode != benchgen.MODE_TWOP:
                    host = (benchgen.gen_batch_np if mode == benchgen.MODE_PLAIN
                            else benchgen.gen_two_phase_np)(
                        b, LANES, COUNT, N_ACCOUNTS, first_tid)
                    full = np.zeros(LANES, dtype=host.dtype)
                    full[:len(host)] = host
                    from tigerbeetle_tpu_torch import types

                    max_abs_err(f"bench_gen vs numpy mode {mode} b {b}",
                                {k: to_np(v) for k, v in got.items()},
                                types.to_soa(full))
                checked += 1
        out = benchgen.empty_soa(LANES, dev)
        times = pair_times(
            timed(lambda: benchgen.gen_batch(7, LANES, COUNT, N_ACCOUNTS,
                                             first_tid, out=out)),
            timed(lambda: benchgen.gen_batch_plain(
                benchgen.MODE_PLAIN, 7, LANES, COUNT, N_ACCOUNTS, first_tid,
                dev)))
    k20 = {"max_abs_err": 0, **times,
           "bound": bound(LANES * GEN_BYTES_PER_LANE, 0), "library_ms": None}

    # The twin's timed loop relies on the sync debug mode: show that it
    # catches a host read on this torch.
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.zeros(1, device=dev).item()
        sync_mode_catches = False
    except RuntimeError:
        sync_mode_catches = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not sync_mode_catches:
        raise AssertionError("the sync debug mode let a host read through")

    runs = {}
    twin_launches = None
    for shape in ("plain", "two_phase", "limits"):
        argv = list(twin_args)
        if shape != "plain":
            argv.append("--" + shape.replace("_", "-"))
        gc.collect()
        _cuda.reset_counts()
        t0 = time.perf_counter()
        payload, ledger = bench.run(bench.parse_args(argv))
        payload["seconds"] = time.perf_counter() - t0
        if shape == "plain":
            twin_launches = _cuda.counts()
            if main_snapshot is not None:
                a = ledger.accounts
                got = balances_by_id(a.key_lo, {c: a.cols[c] for c in
                                                sm.BALANCE_COLS + ("timestamp",)})
                want = balances_by_id(main_snapshot["key_lo"], {
                    c: main_snapshot[c] for c in sm.BALANCE_COLS + ("timestamp",)})
                max_abs_err("bench twin balances vs the main phase", got, want)
                if len(got["id"]) != N_ACCOUNTS:
                    raise AssertionError("bench twin lost accounts")
                payload["balances_equal_main_after_batches"] = payload["batches"]
        emit({"bench_twin": shape, **payload})
        runs[shape] = payload
        del ledger
    missing = [k for k in FLAGSHIP_PATH if twin_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the flagship path: {missing}")
    return {"k20": k20, "checked": checked, "runs": runs,
            "launches": twin_launches,
            "sync_debug_mode_catches_item": sync_mode_catches}


def fault_domain_ledger(dev, cap: int, seed: int):
    """Three pads of ``cap`` slots each, half full through K2 (accounts and
    transfers with random columns; posted rows keyed by the timestamps of
    a quarter of the transfers), then the keys of a sixteenth of each pad's
    slots, the last inserted, tombstoned through K8.  Returns (ledger,
    transfer ids)."""
    import torch
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import state_machine as sm
    from tigerbeetle_tpu_torch.u128 import mix64

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rnd(n, dt):
        x = torch.randint(-(1 << 62), 1 << 62, (n,), generator=gen, device=dev,
                          dtype=torch.int64)
        return x.to(dt)

    n = max(1, cap // 2)

    def table(specs, ids):
        rows = {name: rnd(n, dt) for name, dt in specs.items()}
        t = ht.make_table(cap, specs, dev)
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        ht.insert(t, ids, torch.zeros_like(ids), ones, rows, cap)
        dead = max(1, cap // 16)  # the last keys: the touches hit live ones
        look = ht.lookup(t, ids[-dead:], torch.zeros_like(ids[-dead:]), cap)
        ht.remove_to_tombstone(t, look.slot, look.found)
        return t

    idx = torch.arange(1, n + 1, device=dev, dtype=torch.int64)
    acc_ids = idx
    tr_ids = mix64(idx, torch.full_like(idx, 77))  # a bijection: distinct
    tr_ids = torch.where(tr_ids == 0, -1, tr_ids)
    accounts = table(sm.ACCOUNT_COLS, acc_ids)
    transfers = table(sm.TRANSFER_COLS, tr_ids)
    # Posted keys: the timestamps of live transfers (found pendings).
    live = transfers.key_lo != 0
    ts_live = transfers.cols["timestamp"][live]
    posted_keys = torch.unique(ts_live[ts_live != 0])[:n]
    pk = torch.zeros(n, dtype=torch.int64, device=dev)
    pk[:posted_keys.numel()] = posted_keys
    rows = {"fulfillment": 1 + (rnd(n, torch.int64) & 1).to(torch.int32)}
    posted = ht.make_table(cap, sm.POSTED_COLS, dev)
    ht.insert(posted, pk, torch.zeros_like(pk), pk != 0, rows, cap)
    led = sm.Ledger(accounts=accounts, transfers=transfers, posted=posted,
                    history=sm.make_history(1 << 4, dev))
    return led, tr_ids


def forest_tensors(f) -> dict:
    return {name: f.pad(name) for name in ("accounts", "transfers", "posted")}


def phase_scrub_kernels(seed: int, dev) -> dict:
    """K21 against its plain version and K5; K22 (heap and root-only) and
    K23 (touch and gather_path) against their plain versions on the card,
    byte for byte, on pads of 2^8, 2^15 and 2^25 slots with tombstones,
    duplicate touches and post/void lanes whose pendings are found and not
    found; then a merkle-armed machine's forest after 20 touched flagship
    batches against a fresh K22 build."""
    import torch
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine
    from tigerbeetle_tpu_torch.ops import merkle as mk
    from tigerbeetle_tpu_torch.ops import scrub
    from tigerbeetle_tpu_torch.ops import state_machine as sm
    from tigerbeetle_tpu_torch.utils.benchgen import gen_batch_np

    checked = []
    with uncounted():
        for log2 in SCRUB_SIZES_LOG2:
            cap = 1 << log2
            gc.collect()
            led, tr_ids = fault_domain_ledger(dev, cap, seed + log2)
            got = scrub.scrub_digest(led)
            want = scrub.scrub_digest_plain(led)
            max_abs_err_card(f"scrub_fold 2^{log2}", {"d": got}, {"d": want})
            if int(got[0]) != int(sm.ledger_digest(led)):
                raise AssertionError("scrub_fold accounts fold != K5 digest")
            forest = mk.build_forest(led)
            plain = mk.build_forest_impl(led)
            max_abs_err_card(f"merkle_build heap 2^{log2}",
                             forest_tensors(forest), forest_tensors(plain))
            del plain
            max_abs_err_card(f"merkle_build roots 2^{log2}",
                             {"v": mk.verify_roots(forest, led)},
                             {"v": mk.verify_roots_impl(forest, led)})
            # Touches from stale (zeroed) heaps: duplicates, misses, and
            # pendings found (live transfer ids) and not found.
            n_t = min(8192, cap // 4)
            # Live keys, duplicates, zero padding and tombstoned keys.
            ids = torch.cat([tr_ids[:n_t], tr_ids[:n_t // 4],
                             torch.zeros(16, dtype=torch.int64, device=dev),
                             tr_ids[-4:]])
            acc = torch.arange(1, n_t + 1, dtype=torch.int64, device=dev)
            n_acc = max(1, cap // 2)
            acc = torch.cat([acc, acc[: n_t // 3],
                             torch.arange(n_acc - 3, n_acc + 1, device=dev)])
            pend = torch.cat([tr_ids[: n_t // 2],
                              tr_ids[: n_t // 8] + 2])  # +2: never an id
            z = torch.zeros_like
            stale_k = mk.Forest(**{k: v.clone() for k, v in
                                   forest_tensors(forest).items()})
            stale_p = mk.Forest(**{k: v.clone() for k, v in
                                   forest_tensors(forest).items()})
            for f in (stale_k, stale_p):
                for name in mk.PADS:
                    f.pad(name)[1:].zero_()  # rewritten paths only
            got_f = mk.update_transfers(stale_k, led, ids, z(ids), acc, z(acc),
                                        pend, z(pend), max_probe=sm.MAX_PROBE,
                                        has_postvoid=True)
            look = {}
            # The plain touch from the same probes (K1 serves both).
            from tigerbeetle_tpu_torch.ops import hash_table as ht

            p = ht.lookup(led.transfers, pend, z(pend), sm.MAX_PROBE,
                          cols=mk._PENDING_COLS).cols
            for name, k_lo, k_hi in (
                    ("transfers", ids, z(ids)),
                    ("posted", p["timestamp"], z(pend)),
                    ("accounts",
                     torch.cat([acc, p["debit_account_id_lo"],
                                p["credit_account_id_lo"]]),
                     torch.cat([z(acc), p["debit_account_id_hi"],
                                p["credit_account_id_hi"]]))):
                t = getattr(led, name)
                lk = ht.lookup(t, k_lo, k_hi, sm.MAX_PROBE)
                mk.touch_tree_plain(stale_p.pad(name), t, lk.slot, lk.found,
                                    name)
                look[name] = int(lk.found.sum())
            max_abs_err_card(f"merkle_touch 2^{log2}", forest_tensors(got_f),
                             forest_tensors(stale_p))
            del stale_k, stale_p, got_f
            for name in mk.PADS:
                levels = cap.bit_length() - 1
                for slot in (0, 1, cap // 3, cap - 1):
                    g = mk.gather_path(forest.pad(name), slot, levels)
                    w = (forest.pad(name)[cap + slot],
                         forest.pad(name)[[((cap + slot) >> lv) ^ 1
                                           for lv in range(levels)]]
                         if levels else forest.pad(name)[:0],
                         forest.pad(name)[1])
                    max_abs_err_card(f"gather_path {name} 2^{log2}",
                                     {"l": g[0].reshape(1), "s": g[1],
                                      "r": g[2].reshape(1)},
                                     {"l": w[0].reshape(1), "s": w[1],
                                      "r": w[2].reshape(1)})
            checked.append({"slots": cap, "touched_found": look})
            del led, forest

    # 20 flagship batches on a merkle-armed machine (no scrub due), each
    # touched by K23: the maintained heaps equal a fresh K22 build.
    gc.collect()
    # Tables sized so that no growth (a full rebuild) falls in the 20.
    m = TorchStateMachine(LedgerConfig(lazy_index=True,
                                       transfers_capacity_log2=20),
                          batch_lanes=LANES, device=dev)
    m.scrub_interval = 1 << 30
    m.merkle_enabled = True
    m.scrub_paranoid = False
    for start in range(0, N_ACCOUNTS, COUNT):
        ids = range(start + 1, min(N_ACCOUNTS, start + COUNT) + 1)
        m.create_accounts(types.accounts_array(
            [types.account(id=i, ledger=1, code=10) for i in ids]))
    if not m.scrub_arm():
        raise AssertionError("scrub_kernels: the machine did not arm")
    updates0 = m.merkle_updates
    for b in range(20):
        if m.create_transfers(gen_batch_np(b, LANES, COUNT, N_ACCOUNTS,
                                           1 << 32)):
            raise AssertionError("scrub_kernels: a flagship batch failed")
    if m.merkle_updates - updates0 != 20 or m._merkle_dirty:
        raise AssertionError("scrub_kernels: batches were not touched by K23")
    with uncounted():
        fresh = mk.build_forest(m.ledger)
        err = max_abs_err_card("20 touched batches vs a fresh build",
                               forest_tensors(m._merkle_forest),
                               forest_tensors(fresh))
    return {"checked": checked, "touched_vs_fresh_max_abs_err": err,
            "touched_batches": 20}


def commitments_machine(dev, interval: int, paranoid: bool):
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine

    m = TorchStateMachine(LedgerConfig(lazy_index=True), batch_lanes=LANES,
                          device=dev)
    m.retry_tick_s = 0
    if interval:
        m.scrub_interval = interval
        m.merkle_enabled = True
        m.scrub_paranoid = paranoid
        if not m.scrub_arm():
            raise AssertionError("commitments: the machine did not arm")
    for start in range(0, N_ACCOUNTS, COUNT):
        ids = range(start + 1, min(N_ACCOUNTS, start + COUNT) + 1)
        if m.create_accounts(types.accounts_array(
                [types.account(id=i, ledger=1, code=10) for i in ids])):
            raise AssertionError("commitments: account creation failed")
    return m


def phase_commitments(dev, n_transfers: int, seed: int) -> dict:
    """Merkle on at scrub interval 1, set through the setters, paranoid (the
    host mirror kept), on the flagship workload at 10,000 accounts, beside
    a Merkle-only machine (interval 1, no mirror) and an unarmed twin, all
    fed the same batches.  Roots equal a fresh K22 rebuild every
    ``ROOT_CHECK_EVERY`` batches and at the end; 100 account and 100
    transfer proofs verify against the roots; one SDC flip is caught by
    the next check and recovered (the digest then equals the twin's); one
    injected device fault is retried (the codes equal the twin's).  Rates
    of the three, the device time of K21-K23 a batch, and K21-K23 timed
    against their plain versions at this ledger's shapes."""
    import random

    import torch
    from torch.profiler import ProfilerActivity, profile
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import merkle as mk
    from tigerbeetle_tpu_torch.ops import scrub
    from tigerbeetle_tpu_torch.ops import state_machine as sm
    from tigerbeetle_tpu_torch.utils.benchgen import gen_batch_np

    gc.collect()
    twin = commitments_machine(dev, 0, False)
    lean = commitments_machine(dev, 1, False)
    _cuda.reset_counts()
    m = commitments_machine(dev, 1, True)
    n_batches = (n_transfers + COUNT - 1) // COUNT
    sdc_at, fault_at = n_batches // 3, (2 * n_batches) // 3
    window = range(max(0, n_batches - 6), n_batches - 1)
    wall = {"paranoid": 0.0, "merkle_only": 0.0, "unarmed": 0.0}
    n_rate = 0
    root_checks = 0
    events = {}
    by_name = {}
    calls = {}
    for b in range(n_batches):
        batch = gen_batch_np(b, LANES, COUNT, N_ACCOUNTS, 1 << 32)
        special = b in (sdc_at, fault_at) or b in window
        if b == sdc_at:
            if not m.inject_sdc_bitflip(random.Random(seed)):
                raise AssertionError("commitments: no account to flip")
        if b == fault_at:
            m.inject_device_faults(1)
        res = {}
        for name, mach in (("unarmed", twin), ("merkle_only", lean),
                           ("paranoid", m)):
            profiled = name == "paranoid" and b in window
            if profiled:
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.__enter__()
            t0 = time.perf_counter()
            res[name] = mach.create_transfers(batch)
            dt = time.perf_counter() - t0
            if profiled:
                torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                one, n_one = {}, {}
                device_us(prof, one, n_one)
                for k, v in one.items():
                    by_name[k] = by_name.get(k, 0.0) + v
                    calls[k] = calls.get(k, 0) + n_one[k]
            if not special:
                wall[name] += dt
        if not special:
            n_rate += COUNT
        if res["unarmed"] or res["merkle_only"] != res["unarmed"] \
                or res["paranoid"] != res["unarmed"]:
            raise AssertionError(f"commitments: codes differ at batch {b}")
        if b == sdc_at:
            events["sdc"] = {"batch": b, "scrub_mismatches": m.scrub_mismatches,
                             "device_recoveries": m.device_recoveries,
                             "digest_equals_twin": m.digest() == twin.digest()}
            if m.scrub_mismatches != 1 or m.device_recoveries != 1 \
                    or m.digest() != twin.digest():
                raise AssertionError(f"commitments: SDC not recovered {events}")
        if b == fault_at:
            # At interval 1 a check runs ahead of every commit, so the fault
            # lands on the check's read-back; either funnel recovers.
            events["fault"] = {"batch": b,
                               "device_recoveries": m.device_recoveries,
                               "caught_by": "scrub check"
                               if m.scrub_mismatches == 2 else "commit retry"}
            if m.device_recoveries != 2:
                raise AssertionError("commitments: the fault was not retried")
        if (b + 1) % ROOT_CHECK_EVERY == 0 or b == n_batches - 1:
            for mach in (m, lean):
                want = tuple(int(r) & ((1 << 64) - 1) for r in to_np(
                    mk.forest_roots(mk.build_forest(mach.ledger))))
                if mach.merkle_roots() != want:
                    raise AssertionError(f"commitments: roots != rebuild at {b}")
            root_checks += 1
    launches = _cuda.counts()

    def path_launch(prefix):
        """The window's device ms per recorded launch of ``prefix...``."""
        names = [k for k in by_name if k.startswith(prefix)]
        n = sum(calls[k] for k in names)
        return {"ms": sum(by_name[k] for k in names) / 1e3 / n if n else None,
                "launches_recorded": n}

    if m.digest() != twin.digest() or lean.digest() != twin.digest():
        raise AssertionError("commitments: final digests differ")
    canon = m.merkle_canonical_roots()
    if canon != m.merkle_roots():
        raise AssertionError("commitments: canonical roots != maintained")
    # Proofs: 100 accounts and 100 transfers.
    rng = np.random.default_rng(seed)
    roots = m.merkle_roots()
    acc_root = m.commitment_root()
    for ident in rng.integers(1, N_ACCOUNTS + 1, 100):
        p = mk.check_proof(m.get_proof(int(ident)))
        if p["root"] != acc_root or int(p["row"]["id_lo"]) != int(ident):
            raise AssertionError("commitments: account proof root")
    for gid in rng.integers(0, n_batches * COUNT, 100):
        b, lane = divmod(int(gid), COUNT)
        ident = (1 << 32) + b * COUNT + lane
        p = mk.check_proof(m.get_proof(ident, kind="transfers"))
        if p["root"] != roots[1]:
            raise AssertionError("commitments: transfer proof root")

    # K21-K23 against their plain versions at this ledger's shapes.
    led = m.ledger
    caps = {n: getattr(led, n).capacity for n in mk.PADS}
    lives = {n: int(getattr(led, n).count) for n in mk.PADS}
    key_bytes = sum(16 * c for c in caps.values())
    col_bytes = 72 * lives["accounts"] + 24 * lives["transfers"] + 4 * lives["posted"]
    mixes = 6 * lives["accounts"] + 3 * lives["transfers"] + 2 * lives["posted"]
    results = {}
    with uncounted():
        got = scrub.scrub_digest(led)
        err21 = max_abs_err_card("scrub_fold (commitments)", {"d": got},
                                 {"d": scrub.scrub_digest_plain(led)})
        results["scrub_fold"] = {
            "max_abs_err": err21, **pair_times(
                timed(lambda: scrub.scrub_digest(led)),
                timed(lambda: scrub.scrub_digest_plain(led), reps=5)),
            "bound": bound(key_bytes + col_bytes, mixes * MIX64_OPS),
            "library_ms": None}
        results["scrub_fold"]["ms_warm_l2"] = results["scrub_fold"]["ms"]
        results["scrub_fold"]["ms"] = cold_l2_ms(
            lambda: scrub.scrub_digest(led))
        fresh = mk.build_forest(led)
        err22 = max_abs_err_card("merkle_build (commitments)",
                                 forest_tensors(fresh),
                                 forest_tensors(mk.build_forest_impl(led)))
        nodes = sum(caps.values())
        results["merkle_build"] = {
            "max_abs_err": err22, **pair_times(
                timed(lambda: mk.build_forest(led), reps=5),
                timed(lambda: mk.build_forest_impl(led), reps=3)),
            "bound": bound(key_bytes + col_bytes + 16 * nodes,
                           (mixes + nodes) * MIX64_OPS),
            "library_ms": None,
            "verify": pair_times(
                timed(lambda: mk.verify_roots(fresh, led), reps=5),
                timed(lambda: mk.verify_roots_impl(fresh, led), reps=3))}
        results["merkle_build"]["ms_warm_l2"] = results["merkle_build"]["ms"]
        results["merkle_build"]["ms"] = cold_l2_ms(
            lambda: mk.build_forest(led))
        results["merkle_build"]["verify"]["ms_cold_l2"] = cold_l2_ms(
            lambda: mk.verify_roots(fresh, led))
        # K23 on the last batch's two touches, as the machine pads them:
        # its transfer ids and its deduped account sides.
        last = gen_batch_np(n_batches - 1, LANES, COUNT, N_ACCOUNTS, 1 << 32)
        touches = []
        err23 = 0
        for pad, keys in touch_keys(last):
            table = getattr(led, pad)
            lk = touch_lookup(table, keys)
            heap_k = getattr(fresh, pad).clone()
            heap_p = getattr(fresh, pad).clone()
            _cuda.merkle_touch(pad, table.key_lo, table.key_hi, table.cols,
                               heap_k, lk.slot, lk.found)
            mk.touch_tree_plain(heap_p, table, lk.slot, lk.found, pad)
            err23 = max(err23, max_abs_err_card(
                f"merkle_touch {pad} (commitments)", {"h": heap_k},
                {"h": heap_p}))
            touches.append((pad, table, heap_k, heap_p, lk))

        def touch_kernel(pads=("transfers", "accounts")):
            for pad, table, heap_k, _hp, lk in touches:
                if pad in pads:
                    _cuda.merkle_touch(pad, table.key_lo, table.key_hi,
                                       table.cols, heap_k, lk.slot, lk.found)

        def touch_plain():
            for pad, table, _hk, heap_p, lk in touches:
                mk.touch_tree_plain(heap_p, table, lk.slot, lk.found, pad)

        alone = pair_times(timed(touch_kernel), timed(touch_plain, reps=5))
        # The path's own launches: the profiled window's K23 device time
        # per launch, against the bound of the same touches.
        path = path_launch("merkle_touch")
        need = np.zeros(2)
        for b in window:
            for pad, keys in touch_keys(
                    gen_batch_np(b, LANES, COUNT, N_ACCOUNTS, 1 << 32)):
                table = getattr(led, pad)
                need += touch_bound(table, touch_lookup(table, keys), pad)
        need /= 2 * len(window)

        def t_only():
            touch_kernel(("transfers",))

        results["merkle_touch"] = {
            "max_abs_err": err23,
            "ms": path["ms"] if path["ms"] else alone["ms"] / 2,
            "ms_from": f"profiler, per launch in the commitments path "
                       f"({path['launches_recorded']} launches recorded in "
                       f"{len(window)} batches of 2)" if path["ms"] else
                       "the last batch's two touches alone (no launch of "
                       "the path was recorded)",
            "plain_ms": alone["plain_ms"] / 2,
            "plain_ms_from": alone["plain_ms_from"] + ", per touch of the "
                             "last batch's two",
            "bound": bound(*need), "library_ms": None,
            "ms_alone": alone["ms"] / 2, "ms_alone_from": alone["ms_from"],
            "call_ms_alone": alone["call_ms"] / 2,
            "lanes": {pad: int(lk.slot.numel())
                      for pad, _t, _hk, _hp, lk in touches},
            "found": {pad: int(lk.found.sum())
                      for pad, _t, _hk, _hp, lk in touches},
            "transfers_touch_ms": {
                "back_to_back": timed(t_only)["device_ms"],
                "after_128mb_fill": cold_l2_ms(t_only),
                "after_20ms_idle": after_idle_ms(t_only)},
            "transfers_touch_bound": bound(*touch_bound(
                touches[0][1], touches[0][4], "transfers"))}
    for name in ("scrub_fold", "merkle_build"):
        results[name]["ms_from"] = \
            "each call after a 128 MB fill (cold_l2_ms)"
    results["merkle_build"]["ms_per"] = \
        "forest: three pads, one wrapper call each"
    return {
        "accounts": N_ACCOUNTS, "transfers": n_batches * COUNT,
        "batches": n_batches, "scrub_interval": 1, "paranoid": True,
        "root_checks": root_checks, "root_check_every": ROOT_CHECK_EVERY,
        "proofs_checked": {"accounts": 100, "transfers": 100},
        "events": events, "roots": roots, "commitment_root": acc_root,
        "transfers_per_s": {k: n_rate / v for k, v in wall.items()},
        "armed_vs_unarmed": wall["unarmed"] / wall["paranoid"],
        "merkle_only_vs_unarmed": wall["unarmed"] / wall["merkle_only"],
        "device_ms_per_launch": {
            "scrub_fold": path_launch("scrub_fold"),
            "merkle_build": path_launch("merkle_level"),
            "merkle_touch": path_launch("merkle_touch"),
            "window_batches": len(window),
            "from": "profiler: the mean of the launches it recorded"},
        "counters": {"scrub_checks": m.scrub_checks,
                     "merkle_updates": m.merkle_updates,
                     "merkle_rebuilds": m.merkle_rebuilds},
        "launches": launches, "kernels": results, "machine": lean,
    }


# ---------------------------------------------------------------------------
# phases 21-23: the commit pipeline and persistence
# ---------------------------------------------------------------------------

PIPE_RUNS = (1, 2, 17, 32)  # run lengths held against the eager and plain
PIPELINE_PATH = ("group_dispatch", "group_step", "group_finish", "probe",
                 "validate", "balance", "insert")
PIPE_FAULT_BATCHES = 6  # mirror-armed deferred batches before the degrade


def restore_tables(dst, src) -> None:
    """Copy ``src``'s accounts and transfers tables into ``dst``'s buffers
    in place (a captured graph keeps ``dst``'s addresses)."""
    for name in ("accounts", "transfers"):
        d, s = getattr(dst, name), getattr(src, name)
        for a, b in ((d.key_lo, s.key_lo), (d.key_hi, s.key_hi),
                     (d.tombstone, s.tombstone), (d.count, s.count),
                     (d.probe_overflow, s.probe_overflow)):
            a.copy_(b)
        for c in d.cols:
            d.cols[c].copy_(s.cols[c])


def stage_run(rng, layout, host, k, xids, xhi, ts0):
    """Fill the pinned staging set ``host`` with a run of ``k`` batches,
    counts 8,190 and less: flagship batches (bench.py's generator, on the
    ledger's 10,000 accounts) alternating with the phase-kernels mix (ids
    of the table's rows, duplicates, unknown accounts, pendings, chains; its
    batches reuse the run's ids, so they see the earlier ones' inserts);
    returns the counts and timestamps of all GROUP_K rows."""
    from tigerbeetle_tpu_torch.utils.benchgen import gen_batch_np

    cols, counts, tss = layout.arrays(host.numpy())
    host.zero_()
    ts = ts0
    for j in range(k):
        n = COUNT - (j * 611) % 3000
        b = (gen_batch_np(int(rng.integers(0, 1000)), LANES, COUNT,
                          N_ACCOUNTS, 1 << 32) if j % 2 == 0
             else transfer_batch(rng, LANES, COUNT, xids, xhi))[:n]
        for name, col in cols.items():
            col[j, :n] = b[name]
        ts += n
        counts[j], tss[j] = n, ts
    tss[k:] = ts
    return [int(c) for c in counts], [int(t) for t in tss]


def phase_pipeline_kernels(seed: int, dev, kern: dict) -> dict:
    """K24-K26 against their plain versions, K1-K4 and K20 in the forms a
    captured graph launches (device words, preallocated outputs and
    scratch) against their host-int forms, and one replay of the grouped
    commit's graph against GROUP_K eager steps and the plain loop, byte for
    byte: codes [GROUP_K, 8192], every table array and the run's overflow
    word, on the phase-kernels ledger (rows, same-home clusters,
    tombstones), for runs of ``PIPE_RUNS`` batches (flagship batches and
    the phase-kernels mix); a run of zero-count steps leaves the ledger
    byte-identical.  Timed:
    K24-K26, each form, one replay, the eager run."""
    import torch
    from tigerbeetle_tpu_torch.ops import _cuda, group
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import state_machine as sm

    rng = np.random.default_rng(seed + 21)
    acc = make_accounts_table(rng, dev)
    xfr, xids, xhi = make_transfers_table(rng, dev)
    base = sm.Ledger(acc, xfr, ht.make_table(1 << 10, sm.POSTED_COLS, dev),
                     sm.make_history(1 << 10, dev))
    K = group.GROUP_K
    layout = group.StagingLayout(K, LANES)
    host = torch.zeros(layout.nbytes, dtype=torch.uint8, pin_memory=True)
    graph = group.GroupGraph(clone_ledger(base), K, LANES)
    gled = graph._ledger
    errs = dict.fromkeys(("group_dispatch", "group_step", "group_finish",
                          "group_words"), 0)
    checked = []
    ts0 = 10 ** 15
    plain_s = replay_ms = eager_ms = None
    for k in PIPE_RUNS:
        counts, tss = stage_run(rng, layout, host, k, xids, xhi, ts0)
        ts0 = tss[-1] + 1
        restore_tables(gled, base)
        codes_g, ovf_g, _lo, _hi = graph.run(host)
        torch.cuda.synchronize()
        got = {"codes": to_np(codes_g), "overflow": to_np(ovf_g),
               **ledger_np(gled)}
        led_e = clone_ledger(base)
        dev_cols = layout.tensors(host.to(dev))[0]
        _l, codes_e, ovf_e, _a, _b = group.group_dispatch_steps(
            led_e, dev_cols, counts, tss)
        want_e = {"codes": to_np(codes_e), "overflow": to_np(ovf_e),
                  **ledger_np(led_e)}
        del led_e
        led_p = clone_ledger(base, torch.device("cpu"))
        cpu_cols = layout.tensors(host.clone())[0]
        t0 = time.perf_counter()
        _l, codes_p, ovf_p, _a, _b = group.group_dispatch_steps(
            led_p, cpu_cols, counts, tss)
        if k == K:
            plain_s = time.perf_counter() - t0
        want_p = {"codes": to_np(codes_p), "overflow": to_np(ovf_p),
                  **ledger_np(led_p)}
        del led_p
        e = max(max_abs_err(f"group replay vs eager (run of {k})", got,
                            want_e),
                max_abs_err(f"group replay vs plain (run of {k})", got,
                            want_p))
        errs["group_dispatch"] = max(errs["group_dispatch"], e)
        checked.append({"run": k, "counts": counts[:k],
                        "codes_nonzero": int((got["codes"][:k] != 0).sum())})
    # Zero-count steps leave every ledger array byte-identical.
    cols, counts_np, _t = layout.arrays(host.numpy())
    counts_np[:] = 0
    restore_tables(gled, base)
    before = ledger_np(gled)
    graph.run(host)
    torch.cuda.synchronize()
    errs["group_dispatch"] = max(errs["group_dispatch"], max_abs_err(
        "zero-count run", ledger_np(gled), before))

    # The run of GROUP_K again, timed: one replay (the ledger restored
    # before each, outside the events) and the eager form.
    counts, tss = stage_run(rng, layout, host, K, xids, xhi, ts0)
    dev_host = host.to(dev)

    def event_ms(fn, reps=5):
        out = []
        for _ in range(reps):
            restore_tables(gled, base)
            graph.stage.copy_(dev_host)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return sorted(out)[len(out) // 2]

    replay_ms = event_ms(graph.captured.replay)
    eager_cols = layout.tensors(dev_host)[0]
    eager_ms = event_ms(lambda: group.group_dispatch_steps(
        gled, eager_cols, counts, tss))
    h2d_ms = loop_ms(lambda: graph.stage.copy_(host, non_blocking=True),
                     n=10)

    # K24 against its plain version, steps of a run and a padding step.
    stacked, cw, tw = graph.stacked, graph.counts, graph.timestamps
    graph.stage.copy_(dev_host)
    run_ovf = torch.zeros(1, dtype=torch.int32, device=dev)
    for j in (0, 1, K - 1):
        for flag in (False, True):
            table_ovf = torch.tensor(flag, device=dev)
            run_ovf.fill_(1 if j == 1 else 0)
            pv, pts, pp, po = group.group_step_plain(
                cw, tw, j, stacked["flags"][j], table_ovf, run_ovf.clone())
            sc = graph.steps
            _cuda.group_step(cw, tw, j, stacked["flags"][j], sc.valid, sc.ts,
                             sc.pending, table_ovf, run_ovf)
            errs["group_step"] = max(errs["group_step"], max_abs_err(
                f"K24 step {j} (table flag {flag})",
                {"valid": to_np(sc.valid), "ts": to_np(sc.ts),
                 "pending": to_np(sc.pending), "ovf": to_np(run_ovf)},
                {"valid": to_np(pv), "ts": to_np(pts), "pending": to_np(pp),
                 "ovf": to_np(po)}))
    flags0 = stacked["flags"][0]
    sc = graph.steps
    k24_ms = timed(lambda: _cuda.group_step(
        cw, tw, 0, flags0, sc.valid, sc.ts, sc.pending,
        gled.transfers.probe_overflow, sc.run_ovf))
    k24_plain = timed(lambda: group.group_step_plain(
        cw, tw, 0, flags0, gled.transfers.probe_overflow, sc.run_ovf))

    # K25 against its plain version, then timed.
    for flag in (False, True):
        for prev in (0, 1):
            table_ovf = torch.tensor(flag, device=dev)
            run_ovf.fill_(prev)
            want = group.group_finish_plain(table_ovf, run_ovf.clone())
            _cuda.group_finish(table_ovf, run_ovf)
            errs["group_finish"] = max(errs["group_finish"],
                                       max_abs_err(
                f"K25 (table flag {flag}, word {prev})",
                {"ovf": to_np(run_ovf)}, {"ovf": to_np(want)}))
    k25_ms = timed(lambda: _cuda.group_finish(gled.transfers.probe_overflow,
                                              sc.run_ovf))
    k25_plain = timed(lambda: group.group_finish_plain(
        gled.transfers.probe_overflow, sc.run_ovf))

    # The fast path's kernels in the forms the graph launches (K1 and K3
    # reading the count and timestamp from device words into preallocated
    # outputs, K4 and K2 on preallocated scratch) against their host-int
    # forms at step 0 of the run, on the base ledger.
    soa = {name: col[0] for name, col in stacked.items()}
    c0, t0_ = counts[0], tss[0]
    cw0, tw0 = cw[0:1], tw[0:1]
    s = group.FastSteps(base, K, LANES, dev)
    names = sm.TRANSFER_EXISTS_COLS
    look = ht.lookup(xfr, soa["id_lo"], soa["id_hi"], sm.MAX_PROBE, count=c0,
                     cols=names)
    probe_out = (s.ex_found, s.ex_slot, [s.ex[c] for c in names])
    _cuda.probe(xfr.key_lo, xfr.key_hi, xfr.tombstone, xfr.cols,
                soa["id_lo"], soa["id_hi"], sm.MAX_PROBE, 0, LANES, names,
                count_word=cw0, out=probe_out)
    forms = {}
    forms["probe"] = max_abs_err(
        "K1 reading its count from a device word",
        {"found": to_np(s.ex_found), "slot": to_np(s.ex_slot),
         **{c: to_np(s.ex[c]) for c in names}},
        {"found": to_np(look.found), "slot": to_np(look.slot),
         **{c: to_np(look.cols[c]) for c in names}})
    ctx = transfer_ctx(acc, xfr, soa, ht, sm)
    kc, ko = sm.transfer_codes(soa, ctx, c0, t0_)
    ctx_cols = {"dr_found": ctx.dr_found, "cr_found": ctx.cr_found,
                "dr_ledger": ctx.dr["ledger"], "cr_ledger": ctx.cr["ledger"],
                "ex_found": ctx.ex_found}
    vcols = ([soa[c] for c in sm.TRANSFER_BATCH_COLS]
             + [ctx_cols[c] for c in sm.TRANSFER_CTX_COLS]
             + [ctx.e[c] for c in names])
    vout = (s.codes[0], s.ok, s.vscratch)
    _cuda.validate("transfers", vcols, 0, count_word=cw0, ts_word=tw0,
                   out=vout)
    forms["validate"] = max_abs_err(
        "K3 reading its count and timestamp from device words",
        {"codes": to_np(s.codes[0]), "ok": to_np(s.ok)},
        {"codes": to_np(kc), "ok": to_np(ko)})
    pend = (soa["flags"] & sm.TF_PENDING) != 0
    ak, ag = clone_table(acc), clone_table(acc)
    sm.apply_balances(ak, ctx.dr_slot, ctx.cr_slot, ko, soa["amount_lo"],
                      pend)
    _cuda.balance(ctx.dr_slot, ctx.cr_slot, ko, soa["amount_lo"], pend,
                  [ag.cols[c] for c in sm.BALANCE_COLS])
    forms["balance"] = max_abs_err("K4 as the graph launches it (no scratch)",
                                   table_np(ag), table_np(ak))
    rows = sm.transfer_rows(soa, c0, t0_)
    iscratch = s.iscratch
    tk, tg = clone_table(xfr), clone_table(xfr)
    _t, ck = ht.insert(tk, soa["id_lo"], soa["id_hi"], ko, rows, sm.MAX_PROBE)
    for x in iscratch:  # the kernel must not rely on the scratch's contents
        x.fill_(-1)
    _cuda.insert(tg.key_lo, tg.key_hi, tg.tombstone, tg.cols, tg.count,
                 tg.probe_overflow, soa["id_lo"], soa["id_hi"], ko, rows,
                 sm.MAX_PROBE, 0, scratch=iscratch)
    forms["insert"] = max_abs_err(
        "K2 on preallocated scratch", {"claimed": to_np(iscratch[0]),
                                       **table_np(tg)},
        {"claimed": to_np(ck), **table_np(tk)})
    del ak, ag, tk, tg
    torch.cuda.synchronize()
    form_times = {
        "probe": pair_times(
            timed(lambda: _cuda.probe(
                xfr.key_lo, xfr.key_hi, xfr.tombstone, xfr.cols,
                soa["id_lo"], soa["id_hi"], sm.MAX_PROBE, 0, LANES, names,
                count_word=cw0, out=probe_out)),
            timed(lambda: ht.lookup_plain(xfr, soa["id_lo"], soa["id_hi"],
                                          sm.MAX_PROBE, 0, c0, names))),
        "validate": pair_times(
            timed(lambda: _cuda.validate("transfers", vcols, 0,
                                         count_word=cw0, ts_word=tw0,
                                         out=vout)),
            timed(lambda: sm.transfer_codes_plain(soa, ctx, c0, t0_))),
        "balance": pair_times(
            timed(lambda t: _cuda.balance(
                ctx.dr_slot, ctx.cr_slot, ko, soa["amount_lo"], pend,
                [t.cols[c] for c in sm.BALANCE_COLS]),
                setup=lambda: (clone_table(acc),)),
            timed(lambda t: sm.apply_balance_plan(t, sm.balance_plan(
                ctx.dr_slot, ctx.cr_slot, ko, soa["amount_lo"], pend,
                t.capacity)), setup=lambda: (clone_table(acc),))),
        "insert": pair_times(
            timed(lambda t: _cuda.insert(
                t.key_lo, t.key_hi, t.tombstone, t.cols, t.count,
                t.probe_overflow, soa["id_lo"], soa["id_hi"], ko, rows,
                sm.MAX_PROBE, 0, scratch=iscratch),
                reps=10, setup=lambda: (clone_table(xfr),)),
            timed(lambda t: ht.insert_plain(t, soa["id_lo"], soa["id_hi"],
                                            ko, rows, sm.MAX_PROBE),
                  reps=10, setup=lambda: (clone_table(xfr),))),
    }
    forms = {name: dict(max_abs_err=err, **form_times[name],
                        bound_ms=kern[name]["bound"][0])
             for name, err in forms.items()}
    if any(f["max_abs_err"] for f in forms.values()):
        raise AssertionError(f"device-word forms disagree: {forms}")

    # K26 and K20 reading its batch index from a device word, at the bench
    # twin's shapes: 8,192 lanes, the twin's k, its count and timestamps.
    from tigerbeetle_tpu_torch import bench
    from tigerbeetle_tpu_torch.utils import benchgen

    twin_k = bench.plan(10_000_000, COUNT)[1]
    ts0 = N_ACCOUNTS  # the plain shape's (bench.py's ts0 for 10,000 accounts)
    words = [torch.zeros(twin_k, dtype=torch.int64, device=dev)
             for _ in range(3)]
    bases = (0, twin_k, bench.plan(10_000_000, COUNT)[0] - twin_k,
             (1 << 32) // COUNT + 1)
    for b0 in bases:
        base = torch.tensor([b0], dtype=torch.int64, device=dev)
        want = group.group_words_plain(base.clone(), COUNT, ts0, twin_k)
        _cuda.group_words(base, COUNT, ts0, *words)
        errs["group_words"] = max(errs["group_words"], max_abs_err(
            f"K26 (base {b0}, k {twin_k})",
            dict(zip(("base", "bidx", "counts", "timestamps"),
                     map(to_np, [base] + words))),
            dict(zip(("base", "bidx", "counts", "timestamps"),
                     map(to_np, want)))))
    gen = benchgen.empty_soa(LANES, dev)
    gen_cols = [gen[c] for c in benchgen.GEN_COLS]
    for j in (0, 1, twin_k - 1):
        _cuda.bench_gen(gen_cols, benchgen.MODE_PLAIN, 0, COUNT, N_ACCOUNTS,
                        bench.FIRST_TID, b_word=words[0][j:j + 1])
        b = int(words[0][j])
        forms.setdefault("bench_gen", {"max_abs_err": 0})
        forms["bench_gen"]["max_abs_err"] = max(
            forms["bench_gen"]["max_abs_err"], max_abs_err_card(
                f"K20 reading batch {b} from a device word",
                gen, benchgen.gen_batch_plain(
                    benchgen.MODE_PLAIN, b, LANES, COUNT, N_ACCOUNTS,
                    bench.FIRST_TID, dev)))
    forms["bench_gen"].update(pair_times(
        timed(lambda: _cuda.bench_gen(
            gen_cols, benchgen.MODE_PLAIN, 0, COUNT, N_ACCOUNTS,
            bench.FIRST_TID, b_word=words[0][0:1])),
        timed(lambda: benchgen.gen_batch_plain(
            benchgen.MODE_PLAIN, 7, LANES, COUNT, N_ACCOUNTS,
            bench.FIRST_TID, dev))))
    base = torch.zeros(1, dtype=torch.int64, device=dev)
    k26_ms = timed(lambda: _cuda.group_words(base, COUNT, ts0, *words))
    k26_plain = timed(lambda: group.group_words_plain(base, COUNT, ts0,
                                                      twin_k))

    results = {}
    step_bytes = 4 * LANES + LANES * (1 + 8 + 1) + 16 + 4
    results["group_step"] = dict(
        max_abs_err=errs["group_step"], **pair_times(k24_ms, k24_plain),
        library_ms=None, bound=bound(step_bytes, 4 * LANES),
        shape=f"one step of {LANES} lanes")
    results["group_finish"] = dict(
        max_abs_err=errs["group_finish"], **pair_times(k25_ms, k25_plain),
        library_ms=None, bound=bound(1 + 4 + 4, 1),
        shape="one flag byte and the run's word")
    results["group_words"] = dict(
        max_abs_err=errs["group_words"], **pair_times(k26_ms, k26_plain),
        library_ms=None, bound=bound(8 + 8 + 3 * 8 * twin_k, 4 * twin_k),
        shape=f"the bench twin's k = {twin_k} steps")
    # One replay's bound: GROUP_K steps, each the fast path's three probes,
    # ladder, balances and insert at the phase-kernels shapes, then K25.
    step_ms = (3 * kern["probe"]["bound"][0] + kern["validate"]["bound"][0]
               + kern["balance"]["bound"][0] + kern["insert"]["bound"][0]
               + results["group_step"]["bound"][0])
    results["group_dispatch"] = dict(
        max_abs_err=errs["group_dispatch"], ms=replay_ms,
        plain_ms=plain_s * 1e3, ms_from="cuda events around one replay "
        "(median of 5, the ledger restored before each)",
        plain_ms_from="host clock, the plain loop on CPU copies",
        eager_ms=eager_ms, h2d_ms=h2d_ms,
        library_ms=None,
        bound=(K * step_ms + results["group_finish"]["bound"][0], "bytes"),
        bound_from="GROUP_K x (3 K1 + K3 + K4 + K2 + K24 bounds) + K25",
        shape=f"a run of {K} batches of up to {COUNT} events, 8,192 lanes")
    return {"checked": checked, "graph_nodes": graph.captured.nodes,
            "results": results, "forms": forms}


def pipeline_accounts(m):
    from tigerbeetle_tpu_torch import types

    for start in range(0, N_ACCOUNTS, COUNT):
        ids = range(start + 1, min(N_ACCOUNTS, start + COUNT) + 1)
        if m.create_accounts(types.accounts_array(
                [types.account(id=i, ledger=1, code=10) for i in ids])):
            raise AssertionError("pipeline: account creation failed")


def check_closed_form(m, debits, credits, what):
    rows = m.lookup_accounts(list(range(1, N_ACCOUNTS + 1)))
    if len(rows) != N_ACCOUNTS:
        raise AssertionError(f"{what}: lookup lost accounts")
    order = rows["id_lo"].astype(np.int64)
    for name, want in (("debits_posted", debits), ("credits_posted", credits)):
        if not np.array_equal(rows[name + "_lo"], want[order]) or \
                rows[name + "_hi"].any():
            raise AssertionError(f"{what}: {name} differs from the closed form")


def phase_pipeline(dev, n_transfers: int, main_run: dict) -> dict:
    """The commit pipeline at full width: 10,000 accounts, then the
    flagship's ``n_transfers`` in 8,190-event batches, ``lazy_index``, the
    transfers table sized up front (2^25 slots: no growth, one capture at
    warmup).  (a) runs of GROUP_K through ``commit_group_fast(deferred=
    True)`` at depth 2 (one run in flight while the next is staged); (b)
    ``commit_fast_deferred`` batch by batch at depth 2; (c) a mirror-armed
    machine: one injected fault in a deferred run, recovered through
    ``_recover_inflight``, then ``device_fault_limit`` consecutive faults,
    after which the host engine commits the rest.  Every code as the
    blocking path's (none fail); digest and balances equal phase main's.
    The submits run under ``torch.cuda.set_sync_debug_mode("error")``; the
    device idle share of (a) and (b) from CUDA events around each lane
    closure."""
    import torch
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine
    from tigerbeetle_tpu_torch.ops import _cuda, group
    from tigerbeetle_tpu_torch.utils.benchgen import gen_batch_np

    n_batches = (n_transfers + COUNT - 1) // COUNT
    batches = [gen_batch_np(b, COUNT, COUNT, N_ACCOUNTS, 1 << 32)[
        :min(COUNT, n_transfers - b * COUNT)] for b in range(n_batches)]
    debits = np.zeros(N_ACCOUNTS + 1, np.uint64)
    credits = np.zeros(N_ACCOUNTS + 1, np.uint64)
    for b in batches:
        np.add.at(debits, b["debit_account_id_lo"].astype(np.int64),
                  b["amount_lo"])
        np.add.at(credits, b["credit_account_id_lo"].astype(np.int64),
                  b["amount_lo"])
    cfg = LedgerConfig(lazy_index=True, transfers_capacity_log2=25)
    out = {"batches": n_batches, "transfers": n_transfers,
           "main_transfers_per_s": main_run["transfers_per_s"]}
    launches = None
    for mode in ("group", "single"):
        gc.collect()
        m = TorchStateMachine(cfg, batch_lanes=LANES, device=dev)
        m.pipeline_depth = 2
        m.group_device_commit = True
        pipeline_accounts(m)
        m.warmup()
        torch.cuda.synchronize()
        captures0 = group.CAPTURES
        m.lane_events = []
        if mode == "group":
            _cuda.reset_counts()
        runs = ([batches[i:i + m.GROUP_K]
                 for i in range(0, n_batches, m.GROUP_K)]
                if mode == "group" else [[b] for b in batches])
        inflight = None
        results = []
        wait_s = 0.0
        t0 = time.perf_counter()
        for run in runs:
            torch.cuda.set_sync_debug_mode("error")
            try:
                tss = [m.prepare("create_transfers", len(b)) for b in run]
                if len(run) >= 2:
                    h = m.commit_group_fast(run, tss, deferred=True)
                else:
                    h = m.commit_fast_deferred(run[0], tss[0])
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if h is None:
                raise AssertionError(f"pipeline {mode}: a run was refused")
            if inflight is not None:
                results += inflight.resolve()
                wait_s += inflight.join_wait_s
            inflight = h
        results += inflight.resolve()
        wall = time.perf_counter() - t0
        if mode == "group":
            launches = _cuda.counts()
        if any(results) or len(results) != n_batches:
            raise AssertionError(f"pipeline {mode}: codes differ from the "
                                 "blocking path's (which had none)")
        digest = m.digest()
        if digest != main_run["digest"]:
            raise AssertionError(f"pipeline {mode}: digest differs from main's")
        check_closed_form(m, debits, credits, f"pipeline {mode}")
        span = sum(s.elapsed_time(e) for s, e in m.lane_events)
        out[mode] = {
            "transfers_per_s": n_transfers / wall, "wall_s": wall,
            "runs": len(runs), "resolve_wait_s": wait_s,
            "closure_span_ms": span,
            "device_idle_share": 1 - span / (wall * 1e3),
            "idle_share_from": "CUDA events around each lane closure: their "
                               "span bounds the busy time from above (a "
                               "graph replay keeps the card busy; eager "
                               "launches leave gaps while the lane thread "
                               "queues them), so the share is a lower bound",
            "captures_after_warmup": group.CAPTURES - captures0,
        }
        if group.CAPTURES != captures0:
            raise AssertionError(f"pipeline {mode}: a capture after warmup")
        del m
    gc.collect()

    # (c) the fault funnels at full width, then the host engine.
    m = TorchStateMachine(LedgerConfig(lazy_index=True), batch_lanes=LANES,
                          device=dev)
    m.retry_tick_s = 0
    m.scrub_interval = 1 << 20  # a mirror, no check due in this run
    if not m.scrub_arm():
        raise AssertionError("pipeline faults: the machine did not arm")
    pipeline_accounts(m)
    results = []
    inflight = []
    t0 = time.perf_counter()
    events = []
    for b, batch in enumerate(batches):
        ts = m.prepare("create_transfers", len(batch))
        h = m.commit_fast_deferred(batch, ts)
        if h is None:  # degraded: the host engine commits (blocking)
            results.append(m.commit_batch("create_transfers", batch, ts))
            continue
        inflight.append(h)
        if b == 2:
            m.inject_device_faults(1)  # at the read-back of batch 1
            events.append("fault at batch 1's resolve (2 in flight)")
        if b == PIPE_FAULT_BATCHES - 1:
            m.inject_device_faults(m.device_fault_limit)
            events.append(f"{m.device_fault_limit} faults at batch "
                          f"{b - 1}'s resolve")
        if len(inflight) == 2:
            results += inflight.pop(0).resolve()
    for h in inflight:
        results += h.resolve()
    wall_c = time.perf_counter() - t0
    if any(results) or len(results) != n_batches:
        raise AssertionError("pipeline faults: codes differ")
    if not m.degraded_to_host_engine or m.device_recoveries < 1:
        raise AssertionError("pipeline faults: no recovery and degrade")
    if m.digest() != main_run["digest"]:
        raise AssertionError("pipeline faults: digest differs from main's")
    check_closed_form(m, debits, credits, "pipeline faults")
    out["faults"] = {"events": events, "device_recoveries":
                     m.device_recoveries, "degraded": True,
                     "wall_s": wall_c, "transfers_per_s": n_transfers / wall_c}
    out["launches"] = launches
    return out


def phase_persistence(dev, lean) -> dict:
    """The commitments phase's Merkle-only machine (500,000 flagship
    transfers): ``checkpoint_ledger`` and ``host_state``, saved with
    ``vsr.checkpoint.save`` and loaded into a fresh machine on the card,
    Merkle armed there from the restored state: digest, roots, commitment
    root and lookups equal."""
    import tempfile

    import torch
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine
    from tigerbeetle_tpu_torch.vsr import checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/data"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _p, cs = checkpoint.save(path, 7, lean.checkpoint_ledger(),
                                 {"host_state": lean.host_state()})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ledger, meta = checkpoint.load(path, 7, cs, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in __import__("pathlib").Path(
            tmp).iterdir())
    m = TorchStateMachine(LedgerConfig(lazy_index=True), batch_lanes=LANES,
                          device=dev)
    m.ledger = ledger
    m.scrub_interval = 1
    m.merkle_enabled = True
    m.scrub_paranoid = False
    m.restore_host_state(meta["host_state"])
    m.scrub_arm()  # armed from the restored, verified state
    if not m.merkle_armed:
        raise AssertionError("persistence: the restored machine did not arm")
    checks = {
        "digest": (m.digest(), lean.digest()),
        "merkle_roots": (m.merkle_roots(), lean.merkle_roots()),
        "commitment_root": (m.commitment_root(), lean.commitment_root()),
    }
    for what, (got, want) in checks.items():
        if got != want:
            raise AssertionError(f"persistence: {what} {got} != {want}")
    ids = list(range(1, N_ACCOUNTS + 1))
    if m.lookup_accounts(ids).tobytes() != lean.lookup_accounts(ids).tobytes():
        raise AssertionError("persistence: account lookups differ")
    tids = [(1 << 32) + i * 37 for i in range(8192)]
    if m.lookup_transfers(tids).tobytes() != \
            lean.lookup_transfers(tids).tobytes():
        raise AssertionError("persistence: transfer lookups differ")
    if m.host_state() != lean.host_state():
        raise AssertionError("persistence: host state differs")
    return {"save_s": save_s, "load_s": load_s, "snapshot_bytes": nbytes,
            "transfers": int(m.ledger.transfers.count.item()),
            "checked": sorted(checks) + ["lookups", "host_state"]}



# ---------------------------------------------------------------------------
# phases 24-25: the batched VOPR (sim/vopr_tpu.py, K27-K29)
# ---------------------------------------------------------------------------

# The JAX package's violation count for each injected bug at
# tests/test_vopr.py's shapes (seed 1, 256 clusters x 300 steps);
# tests/test_torch_vopr_run.py holds these to the JAX package.
VOPR_BUG_VIOLATIONS = {
    "commit_quorum": 256, "canonical_by_op": 85, "no_truncate": 244,
    "corrupt_serve": 46, "wal_wrap": 191, "split_brain": 241,
    "amputate_vouch": 1, "join_keep_stale": 247, "scrub_off": 256,
}
VOPR_SCALE = dict(schedules=100_000, steps=200, batch=8192)  # tools/vopr_scale.py
VOPR_CLI = dict(clusters=4096, steps=400)  # cli.py vopr --tpu defaults
VOPR_LONG = dict(clusters=4096, steps=20_000)
VOPR_CHECK_CLUSTERS = dict(draw=4096, step=1024, run=512)
VOPR_CHECK_STEPS = dict(step=50, run=200)
# One threefry-2x32 hash: 4 adds and xors of the key schedule, 20 rounds of
# add, rotate and xor, 5 injections of three adds.
THREEFRY_OPS = 80


def vopr_draw_ops(R: int) -> int:
    """Integer operations of one key's draws: 30 + 14R threefry hashes
    (split 10, split 4, fold_in, split 2, ten (R,) Bernoulli gates and the
    repartition gate, two (R,) and two scalar randints of a split and two
    64-bit draws a value), plus a compare a gate and four 64-bit remainders
    a randint value."""
    return (30 + 14 * R) * THREEFRY_OPS + 11 * R + 4 * 4 * (2 * R + 2)


def vopr_step_ops(R: int, S: int) -> int:
    """Integer operations of one cluster-step of the model (not of the
    kernel's redundant copies): the (r, donor, slot) checksum scan, 7 a
    triple (R^2 S); 60 a ring element (R S) over the crash, scrub, install,
    append, repair, prefix, commit and oracle phases; 15 a replica pair
    (connectivity, perceived views, participants, ranks); 100 a replica."""
    return 7 * R * R * S + 60 * R * S + 15 * R * R + 100 * R


def vopr_state_bytes(R: int, S: int, max_ops: int) -> int:
    return 4 * 9 * R + 12 * R * S + 4 * max_ops + 2


def vopr_states_equal(a, b, what: str) -> int:
    """0 when every field of two ClusterStates is byte-identical (on the
    card); raises otherwise."""
    return max_abs_err_card(what, dict(zip(a._fields, a)),
                            dict(zip(b._fields, b)))


def phase_vopr_kernels(seed: int, dev) -> dict:
    """K27-K29 against their plain versions on CUDA tensors, byte for byte:
    K27 on 4,096 keys for R in {3, 5}, S in {8, 32}, p_sdc in {0, 0.3}; K28
    on 1,024 clusters x 50 steps (its faults from K27) for the clean model
    and each bug; K29's flags and every final state at 512 clusters x 200
    steps for the clean HARSH model and each bug; runs that end inside,
    at and past K29's chunks of 32 drawn steps (0, 1, 31, 33, 65 steps) at
    one warp a cluster (R=3, S=32) and eight (R=6, S=256); one long run
    (canonical lists past shared memory, in device memory).  Then each
    kernel at its path's shape, byte for byte against its plain version on
    the same inputs, and timed beside it and beside its bound; K29's
    registers and resident warps a SM as the card reports them."""
    import torch
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.sim import prng
    from tigerbeetle_tpu_torch.sim import vopr_tpu as vt

    checked = {"draw": 0, "step": 0, "run": 0, "long": 0}
    keys = prng.split(prng.PRNGKey(seed, dev), VOPR_CHECK_CLUSTERS["draw"])
    for R in (3, 5):
        for S in (8, 32):
            for p_sdc in (0.0, 0.3):
                probs = dict(vt.HARSH_FAULTS, p_sdc=p_sdc)
                got = vt.draw_faults(keys, R, S, **probs)
                want = vt.draw_faults_plain(keys, R, S, **probs)
                max_abs_err_card(f"K27 R={R} S={S} p_sdc={p_sdc}", got, want)
                checked["draw"] += 1
    bugs = (None,) + vt.BUGS
    n, steps = VOPR_CHECK_CLUSTERS["step"], VOPR_CHECK_STEPS["step"]
    for bug in bugs:
        R, S, probs = vt.BUG_CONFIGS[bug]
        max_ops = steps + 2
        state = vt.make_state(R, S, max_ops, n, dev)
        key = prng.split(prng.PRNGKey(seed + 1, dev), n)
        for i in range(steps):
            ks = prng.split(key, 2)
            key, sub = ks[:, 0], ks[:, 1]
            faults = vt.draw_faults(sub, R, S, **probs)
            got = vt.step(state, faults=faults, n_replicas=R, slots=S,
                          max_ops=max_ops, bug=bug)
            want = vt.step_plain(state, faults, n_replicas=R, slots=S,
                                 max_ops=max_ops, bug=bug)
            vopr_states_equal(got, want, f"K28 {bug} step {i}")
            state = got
        checked["step"] += 1
    n, steps = VOPR_CHECK_CLUSTERS["run"], VOPR_CHECK_STEPS["run"]
    caught = {}
    for bug in bugs:
        R, S, probs = vt.BUG_CONFIGS[bug]
        flags, got = vt.run(seed, n, steps, R, S, bug, device=dev,
                            final_state=True, **probs)
        want = vt.run_plain(seed, 0, n, steps, R, S, bug, dev, **probs)
        vopr_states_equal(got, want, f"K29 {bug}")
        if not np.array_equal(flags, want.violated.cpu().numpy()):
            raise AssertionError(f"K29 {bug}: flags differ from the plain loop")
        caught[str(bug)] = int(flags.sum())
        checked["run"] += 1
    checked["chunks"] = []
    for R, S in ((3, 32), (6, 256)):
        probs = dict(vt.HARSH_FAULTS, p_sdc=0.3)
        for steps in (0, 1, 31, 33, 65):
            flags, got = vt.run(seed, 256, steps, R, S, device=dev,
                                final_state=True, **probs)
            want = vt.run_plain(seed, 0, 256, steps, R, S, None, dev, **probs)
            vopr_states_equal(got, want, f"K29 R={R} S={S} {steps} steps")
            if not np.array_equal(flags, want.violated.cpu().numpy()):
                raise AssertionError(f"K29 R={R} S={S} {steps} steps: flags "
                                     "differ from the plain loop")
            checked["chunks"].append(f"R={R} S={S} {steps} steps")
    long_steps = _cuda.VOPR_SHARED_MAX_OPS + 100
    flags, got = vt.run(seed, 4, long_steps, device=dev, final_state=True,
                        **vt.HARSH_FAULTS)
    want = vt.run_plain(seed, 0, 4, long_steps, 3, 32, None, dev,
                        **vt.HARSH_FAULTS)
    vopr_states_equal(got, want, "K29 long run")
    if not np.array_equal(flags, want.violated.cpu().numpy()):
        raise AssertionError("K29 long run: flags differ from the plain loop")
    checked["long"] = long_steps

    # At the paths' shapes, byte for byte and timed: K27 and K28 at the
    # step-locked route's 4,096 clusters (R=3, S=32, max_ops 402), K29 at
    # tools/vopr_scale.py's batch (8,192 x 200 under HARSH_FAULTS).  The
    # plain versions are timed with CUDA events around their calls (a
    # plain version's host work is its time on the card).
    R, S = 3, 32
    nc, max_ops = VOPR_CLI["clusters"], VOPR_CLI["steps"] + 2
    harsh = dict(vt.HARSH_FAULTS)
    tkeys = prng.split(prng.PRNGKey(seed + 2, dev), nc)
    step_kw = dict(n_replicas=R, slots=S, max_ops=max_ops)
    with uncounted():
        faults = vt.draw_faults(tkeys, R, S, **harsh)
        max_abs_err_card("K27 at 4,096 keys", faults,
                         vt.draw_faults_plain(tkeys, R, S, **harsh))
        state = vt.make_state(R, S, max_ops, nc, dev)
        for _ in range(20):  # a state with rings, commits and a canon
            state = vt.step(state, faults=faults, **step_kw)
        vopr_states_equal(vt.step(state, faults=faults, **step_kw),
                          vt.step_plain(state, faults, **step_kw),
                          "K28 at 4,096 clusters")
        k27 = timed(lambda: vt.draw_faults(tkeys, R, S, **harsh))
        k27_plain = loop_ms(
            lambda: vt.draw_faults_plain(tkeys, R, S, **harsh), n=10)
        k28 = timed(lambda: vt.step(state, faults=faults, **step_kw))
        k28_plain = loop_ms(
            lambda: vt.step_plain(state, faults, **step_kw), n=10)
        b, bs = VOPR_SCALE["batch"], VOPR_SCALE["steps"]
        # The wrapper's launch without the flags' read-back, so that calls
        # queue behind the spin.
        k29 = timed(lambda: vt._run_block(seed, 0, b, bs, R, S, None, dev,
                                          False, harsh), reps=10)
        flags, got = vt._run_block(seed, 0, b, bs, R, S, None, dev, True,
                                   harsh)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = vt.run_plain(seed, 0, b, bs, R, S, None, dev, **harsh)
        end.record()
        end.synchronize()
        k29_plain = start.elapsed_time(end)
        vopr_states_equal(got, want, "K29 at 8,192 x 200")
        if not torch.equal(flags, want.violated):
            raise AssertionError("K29 at 8,192 x 200: flags differ")
        del got, want
        checked["path_shapes"] = ["K27 4,096 keys", "K28 4,096 clusters",
                                  "K29 8,192 x 200 HARSH"]

    def times(kernel, plain_ms):
        return dict(ms=kernel["device_ms"], plain_ms=plain_ms,
                    call_ms=kernel["call_ms"], ms_from=kernel["device_ms_from"],
                    plain_ms_from="cuda events around the plain calls")

    draw_bytes = 8 + 30 * R + 17
    results = {
        "vopr_draw": dict(
            max_abs_err=0, **times(k27, k27_plain), library_ms=None,
            bound=bound(nc * draw_bytes, nc * vopr_draw_ops(R),
                        H100_INT32_OPS_PER_S),
            shape=f"{nc} keys, R={R}, S={S}"),
        "vopr_step": dict(
            max_abs_err=0, **times(k28, k28_plain), library_ms=None,
            bound=bound(nc * (2 * vopr_state_bytes(R, S, max_ops)
                              + draw_bytes - 8),
                        nc * vopr_step_ops(R, S), H100_INT32_OPS_PER_S),
            shape=f"{nc} clusters, R={R}, S={S}, max_ops {max_ops}"),
        "vopr_run": dict(
            max_abs_err=0, **times(k29, k29_plain), library_ms=None,
            bound=bound(b, b * bs * (vopr_draw_ops(R) + 2 * THREEFRY_OPS
                                     + vopr_step_ops(R, S)),
                        H100_INT32_OPS_PER_S),
            shape=f"{b} clusters x {bs} steps, R={R}, S={S}, HARSH_FAULTS"),
    }
    launch = {f"R={r} S={s_} steps={t}": _cuda.vopr_run_info(r, s_, t)
              for r, s_, t in ((R, S, bs), (R, S, VOPR_LONG["steps"]),
                               (6, 256, bs))}
    return {"checked": checked, "caught_at_check_size": caught,
            "results": results, "k29_launch": launch}


def phase_vopr(dev, seed: int, smi: str) -> dict:
    """The VOPR at its sources' sizes, through the port's entry points:
    (a) cli.py's ``vopr --tpu`` default, 4,096 clusters x 400 steps, clean:
    0 violations; (b) tools/vopr_scale.py's run through the twin
    (``sim.vopr_scale``), batches of 8,192 x 200 under HARSH_FAULTS until
    100,000 schedules: 0 violations; (c) each bug at tests/test_vopr.py's
    shapes: caught, with the JAX package's count; (d) 4,096 clusters x
    20,000 steps, clean, the canonical lists in device memory: 0
    violations; (e) the step-locked route (``draw_faults`` then ``step``
    each step, as tools/vopr_crossval.py drives it) at (a)'s shape: its
    last step equals the plain versions' on the same inputs, and its final
    state equals K29's.  K29's launches are read from (b), K27's and
    K28's from (e)."""
    import io

    import torch
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.sim import prng, vopr_scale
    from tigerbeetle_tpu_torch.sim import vopr_tpu as vt

    out = {"nvidia_smi": smi}
    nc, steps = VOPR_CLI["clusters"], VOPR_CLI["steps"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v = vt.run_sharded(seed, nc, steps, devices=[dev])
    out["a_cli_default"] = {"clusters": len(v), "steps": steps,
                            "violations": int(v.sum()),
                            "wall_s": time.perf_counter() - t0}
    if v.sum() != 0 or len(v) != nc:
        raise AssertionError(f"vopr (a): {int(v.sum())} clean violations")

    _cuda.reset_counts()
    log = io.StringIO()
    rec = vopr_scale.scale(VOPR_SCALE["schedules"], VOPR_SCALE["steps"],
                           VOPR_SCALE["batch"], dev, log=log)
    out["launches_b"] = _cuda.counts()
    out["b_scale"] = rec
    if rec["violations"] != 0 or rec["schedules"] < VOPR_SCALE["schedules"]:
        raise AssertionError(f"vopr (b): {rec['violations']} violations")
    if out["launches_b"]["vopr_run"] == 0:
        raise AssertionError("vopr (b): K29 was not launched")

    counts = {}
    t0 = time.perf_counter()
    for bug in vt.BUGS:
        R, S, probs = vt.BUG_CONFIGS[bug]
        counts[bug] = int(vt.run(1, 256, 300, R, S, bug, device=dev,
                                 **probs).sum())
    out["c_bugs"] = {"violations": counts, "jax_package": VOPR_BUG_VIOLATIONS,
                     "wall_s": time.perf_counter() - t0}
    if counts != VOPR_BUG_VIOLATIONS:
        raise AssertionError(f"vopr (c): counts {counts} differ from the "
                             f"JAX package's {VOPR_BUG_VIOLATIONS}")

    nl, sl = VOPR_LONG["clusters"], VOPR_LONG["steps"]
    # The run's own device memory: its peak above what earlier phases
    # still hold (their garbage collected first).
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    v = vt.run(seed, nl, sl, device=dev)
    wall = time.perf_counter() - t0
    out["d_long"] = {"clusters": nl, "steps": sl, "violations": int(v.sum()),
                     "wall_s": wall, "cluster_steps_per_s": nl * sl / wall,
                     "peak_device_bytes": torch.cuda.max_memory_allocated()
                     - held, "device_bytes_held_before": held}
    if v.sum() != 0:
        raise AssertionError(f"vopr (d): {int(v.sum())} clean violations")

    R, S, max_ops = 3, 32, steps + 2
    _cuda.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = vt.make_state(R, S, max_ops, nc, dev)
    key = vt.cluster_keys(seed, 0, nc, dev)
    step_kw = dict(n_replicas=R, slots=S, max_ops=max_ops)
    for _ in range(steps):
        ks = prng.split(key, 2)
        key, sub = ks[:, 0], ks[:, 1]
        faults = vt.draw_faults(sub, R, S)
        prev, state = state, vt.step(state, faults=faults, **step_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["launches_e"] = _cuda.counts()
    # The last step, where the canonical lists are longest, against the
    # plain versions on the same inputs.
    max_abs_err_card("vopr (e): K27 at the last step", faults,
                     vt.draw_faults_plain(sub, R, S))
    vopr_states_equal(state, vt.step_plain(prev, faults, **step_kw),
                      "vopr (e): K28 at the last step")
    del prev
    with uncounted():
        _flags, ref = vt.run(seed, nc, steps, device=dev, final_state=True)
    vopr_states_equal(state, ref, "vopr (e): step-locked vs K29")
    out["e_step_locked"] = {"clusters": nc, "steps": steps, "wall_s": wall,
                            "violations": int(state.violated.sum()),
                            "equals_k29_final_state": True}
    for name in ("vopr_draw", "vopr_step"):
        if out["launches_e"][name] == 0:
            raise AssertionError(f"vopr (e): {name} was not launched")
    return out


# ---------------------------------------------------------------------------
# phases 26-27: sharding (parallel/sharded.py: K30, K31, the slot-base K4/K10)
# ---------------------------------------------------------------------------

SHARD_COUNTS = (2, 4, 8)
# The main phase's tables after its 10,000,000 transfers: accounts 2^16
# slots, transfers 2^25 slots (load <= 0.5), over 2, 4 and 8 shards.
SHARD_ACCOUNTS_LOG2 = 16
SHARD_TRANSFERS_LOG2 = 25
SHARD_FILL = 10_000_000
# K31's launches in the 8-shard run before K30 wrote one row a card (a K31
# a gather round), and K30's time at 8 shards then (a row a shard), as
# PERF.md records them (NVIDIA H100 80GB HBM3, 700 W): printed beside the
# new figures, never in the kernels line (not measured here).
K31_PARENT_LAUNCHES = 358
K30_PARENT_MS = 0.00842
SHARDED_PATH = ("shard_gather", "probe", "insert",
                "validate", "balance", "claim", "write_claimed", "full_index",
                "full_legs", "full_pass", "full_waves")
SHARDED_TRANSFERS = 2_000_000  # each of the 2- and 8-shard machines
SHARDED_GROUP_TRANSFERS = 1_000_000  # the grouped/deferred 4-shard machine
SHARDED_SPLIT_AT = 40  # batches the 2 -> 4 split's machine commits first
SHARDED_SPLIT_CHUNK = 1 << 15  # rows a migration chunk


def shard_fill(rng, dev, n_shards: int, log2: int, col_specs, keys, rows):
    """``n_shards`` local tables of 2^log2 / n slots each holding their own
    of ``keys`` (inserted on the card by K2 with the mesh's hash shift)."""
    import torch
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import state_machine as sm
    from tigerbeetle_tpu_torch.parallel import sharded as tsh

    local = (1 << log2) // n_shards
    tables = [ht.make_table(local, col_specs, dev) for _ in range(n_shards)]
    zeros = torch.zeros_like(keys)
    own = tsh.owners(keys, zeros, n_shards)
    for s in range(n_shards):
        ht.insert(tables[s], keys, zeros, own == s, rows, sm.MAX_PROBE,
                  hash_shift=n_shards.bit_length() - 1)
        if bool(tables[s].probe_overflow):
            raise AssertionError("shard_kernels: a fill overflowed")
    return tables


def rand_cols(col_specs, n, dev, gen):
    import torch

    out = {}
    for name, dt in col_specs.items():
        hi = (1 << 62) if dt == torch.int64 else (1 << 31) - 1
        out[name] = torch.randint(0, hi, (n,), dtype=dt, device=dev,
                                  generator=gen)
    return out


def phase_shard_kernels(seed: int, dev) -> dict:
    """K30 and K31, and the slot-base forms of K4 and K10, against their
    plain versions on the card, byte for byte, at the path's shapes (8,190
    lanes of the flagship mix, the main phase's capacities over 2, 4 and 8
    shards); each timed at 8 shards."""
    import torch
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import state_machine as sm
    from tigerbeetle_tpu_torch.ops import transfer_full as tf
    from tigerbeetle_tpu_torch.parallel import mesh as tmesh
    from tigerbeetle_tpu_torch.parallel import sharded as tsh
    from tigerbeetle_tpu_torch.utils.benchgen import gen_batch_np

    rng = np.random.default_rng(seed + 30)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 30)
    checked = []
    out = {}
    # The transfers rows (the main phase holds 10,000,000) and the accounts.
    xkeys = t64((1 << 45) + np.arange(SHARD_FILL, dtype=np.uint64)
                * np.uint64(7919), dev)
    xrows = rand_cols(sm.TRANSFER_COLS, SHARD_FILL, dev, gen)
    akeys = t64(np.arange(1, N_ACCOUNTS + 1, dtype=np.uint64), dev)
    arows = rand_cols(sm.ACCOUNT_COLS, N_ACCOUNTS, dev, gen)
    batch = gen_batch_np(7, LANES, COUNT, N_ACCOUNTS, 1 << 40)
    # Half the lanes name stored transfers, the rest new ids; zeros pad.
    q = np.zeros(LANES, np.uint64)
    q[:COUNT] = batch["id_lo"]
    hit = rng.random(COUNT) < 0.5
    q[:COUNT][hit] = ((1 << 45) + rng.integers(0, SHARD_FILL, int(hit.sum()))
                      .astype(np.uint64) * np.uint64(7919))
    qlo, qhi = t64(q, dev), torch.zeros(LANES, dtype=torch.int64, device=dev)
    dr = np.zeros(LANES, np.uint64)
    cr = np.zeros(LANES, np.uint64)
    dr[:COUNT] = batch["debit_account_id_lo"]
    cr[:COUNT] = batch["credit_account_id_lo"]
    drlo, crlo = t64(dr, dev), t64(cr, dev)
    mask = torch.from_numpy(rng.random(LANES) < 0.9).to(dev)
    amount = np.zeros(LANES, np.uint64)
    amount[:COUNT] = batch["amount_lo"]
    amt = t64(amount, dev)
    pend = torch.from_numpy(rng.random(LANES) < 0.3).to(dev)
    xnames = tuple(sm.TRANSFER_COLS)
    anames = tf._ACCOUNT_VIEW_COLS
    for n_shards in SHARD_COUNTS:
        xt = shard_fill(rng, dev, n_shards, SHARD_TRANSFERS_LOG2,
                        sm.TRANSFER_COLS, xkeys, xrows)
        at = shard_fill(rng, dev, n_shards, SHARD_ACCOUNTS_LOG2,
                        sm.ACCOUNT_COLS, akeys, arows)
        ids = range(n_shards)
        # One round as the fast path gathers it: the debit and credit
        # accounts and the ids, with and without the overflow words.
        offs, m = [], 0
        for rows in ((2 + len(anames)) * LANES,) * 2 + (
                (2 + len(xnames)) * LANES,):
            offs.append(m)
            m += rows
        launches = (
            (at, drlo, anames, None), (at, crlo, anames, mask),
            (xt, qlo, xnames, None))
        for want_overflow in (False, True):
            # K30 writes every lane of its row (the path allocates it
            # unzeroed): only the overflow words start at zero, and each
            # side starts from its own garbage elsewhere.
            got = torch.full((m + 3,), -1, dtype=torch.int64, device=dev)
            want = torch.full_like(got, -2)
            got[m:] = 0
            want[m:] = 0
            for k, (tabs, lo, names, msk) in enumerate(launches):
                _cuda.shard_gather(tabs, ids, n_shards, lo, qhi, names,
                                   sm.MAX_PROBE, COUNT, msk, got, offs[k],
                                   m + k, want_overflow)
                tsh.shard_gather_plain(tabs, ids, n_shards, lo, qhi, names,
                                       sm.MAX_PROBE, COUNT, msk, want,
                                       offs[k], m + k, want_overflow)
            err = max_abs_err_card(f"shard_gather {n_shards} shards",
                                   {"row": got}, {"row": want})
            # A device a shard, as a mesh across cards holds them: each
            # shard's own row; K31's sum of those rows is the one row.
            per = torch.full((n_shards, m + 3), -1, dtype=torch.int64,
                             device=dev)
            per[:, m:] = 0
            for sh in ids:
                for k, (tabs, lo, names, msk) in enumerate(launches):
                    _cuda.shard_gather([tabs[sh]], [sh], n_shards, lo, qhi,
                                       names, sm.MAX_PROBE, COUNT, msk,
                                       per[sh], offs[k], m + k, want_overflow)
            comb = _cuda.shard_combine(per)
            err = max(err, max_abs_err_card(
                f"shard_combine {n_shards} shards",
                {"sum": comb}, {"sum": tmesh.shard_combine_plain(per)}))
            # The summed overflow words count the shards that overflowed,
            # the one row's OR them: both are read as != 0.
            err = max(err, max_abs_err_card(
                f"shard_combine of {n_shards} one-shard rows = K30's row",
                {"row": comb[:m], "overflow": comb[m:] != 0},
                {"row": got[:m], "overflow": got[m:] != 0}))
            checked.append(f"K30+K31 {n_shards} shards overflow={want_overflow}")
        comb = got
        found = comb[offs[2]:offs[2] + LANES] != 0
        n_found = int(found.sum())
        if n_found < COUNT // 3:
            raise AssertionError("shard_kernels: too few ids found")
        # K4's slot-base form on each shard, on the round's global slots.
        dslot = comb[offs[0] + LANES:offs[0] + 2 * LANES]
        cslot = comb[offs[1] + LANES:offs[1] + 2 * LANES]
        ok = (comb[offs[0]:offs[0] + LANES] != 0) & (
            comb[offs[1]:offs[1] + LANES] != 0)
        local = at[0].capacity
        gcap = local * n_shards
        for s in range(n_shards):
            tk, tp = clone_table(at[s]), clone_table(at[s])
            tsh.apply_balances_local(tk, dslot, cslot, ok, amt, pend,
                                     s * local, gcap)
            tsh.apply_balances_local_plain(tp, dslot, cslot, ok, amt, pend,
                                           s * local, gcap)
            max_abs_err_card(f"balance slot base, shard {s}/{n_shards}",
                             {k: v for k, v in tk.cols.items()},
                             {k: v for k, v in tp.cols.items()})
        # K10's apply launch in its slot-base form: unique run tails.
        s_slot = torch.from_numpy(rng.permutation(gcap)[:2 * LANES]).to(dev)
        scat = torch.from_numpy(rng.random(2 * LANES) < 0.6).to(dev)
        incl = {c: torch.randint(0, 1 << 62, (2 * LANES,), dtype=torch.int64,
                                 device=dev, generator=gen)
                for c in tf._BAL_COLS}
        gate = torch.zeros(1, dtype=torch.int32, device=dev)
        for s in range(n_shards):
            tk, tp = clone_table(at[s]), clone_table(at[s])
            tsh._scatter_local(tk, gate, scat, s_slot, incl, s * local)
            tsh._scatter_local_plain(tp, torch.tensor(True, device=dev), scat,
                                     s_slot, incl, s * local)
            max_abs_err_card(f"full_legs slot base, shard {s}/{n_shards}",
                             {k: v for k, v in tk.cols.items()},
                             {k: v for k, v in tp.cols.items()})
        checked.append(f"K4, K10 slot base, every shard of {n_shards}")
        if n_shards != SHARD_COUNTS[-1]:
            del xt, at
            torch.cuda.empty_cache()
            continue
        # Timed at 8 shards: the transfers gather of the fast path (owner
        # probes only) into the card's one row, K31 on the round's rows of
        # a device a shard, and one shard's K4 and K10 slot-base launches.
        part = torch.empty((2 + len(xnames)) * LANES + 1, dtype=torch.int64,
                           device=dev)

        def k30():
            _cuda.shard_gather(xt, ids, n_shards, qlo, qhi, xnames,
                               sm.MAX_PROBE, COUNT, None, part, 0,
                               part.shape[0] - 1, False)

        def k30_plain():
            tsh.shard_gather_plain(xt, ids, n_shards, qlo, qhi, xnames,
                                   sm.MAX_PROBE, COUNT, None, part, 0,
                                   part.shape[0] - 1, False)

        n_nz = int((q != 0).sum())
        col_bytes = sum(xrows[c].element_size() for c in xnames)
        # What the gather needs, whatever the shard count: the keys read;
        # one probe window (17 B: key pair and tombstone) a nonzero lane at
        # its owner; the found rows' columns read; and the answer written
        # once, a lane's found byte, global slot and columns at their
        # widths (K30 writes them as u64 words).
        g_bytes = 16 * LANES + 17 * n_nz + n_found * col_bytes \
            + LANES * (1 + 8 + col_bytes)
        with uncounted():
            t_k30 = timed(k30)
            t_k30p = timed(k30_plain, reps=5)
        out["shard_gather"] = dict(
            max_abs_err=0, **pair_times(t_k30, t_k30p), library_ms=None,
            parent_ms_perf_md=K30_PARENT_MS,
            phases_us=phase_clock().lanes(k30),
            bound=bound(g_bytes, 30 * LANES),
            shape=f"{LANES} lanes ({n_found} found), transfers 2^"
                  f"{SHARD_TRANSFERS_LOG2} over {n_shards} shards holding "
                  f"{SHARD_FILL} rows, {len(xnames)} columns, one row for "
                  "the card; checked over 2, 4 and 8 shards, accounts and "
                  "transfers, masks, the overflow words, and a device a "
                  "shard (summed by K31)")
        parts = list(per)
        # The rows (22 MB) fit the 50 MB L2: the warm time is a sum right
        # after the gathers, the cold one (L2 flushed before each call) the
        # one the bytes bound speaks of.
        with uncounted():
            warm = timed(lambda: _cuda.shard_combine(per))
            k31 = cold_l2_ms(lambda: _cuda.shard_combine(per))
            k31p = cold_l2_ms(lambda: tmesh.shard_combine_plain(per))
            lib = cold_l2_ms(lambda: per.sum(0))
            lib_stack = cold_l2_ms(lambda: torch.stack(parts).sum(0))
        out["shard_combine"] = dict(
            max_abs_err=0, ms=k31, plain_ms=k31p, warm_ms=warm["device_ms"],
            ms_from="cuda events, L2 flushed before each call",
            library_ms=lib, library_stack_ms=lib_stack,
            bound=bound(per.numel() * 8 + per.shape[1] * 8, per.numel()),
            shape=f"{n_shards} rows of {per.shape[1]} words (the fast "
                  "path's round, a device a shard: debit and credit "
                  "accounts, ids; on one card no gather round sums: K30 "
                  "writes the card's one row); library: rows.sum(0), one "
                  "call (library_stack_ms: torch.stack(rows).sum(0))")
        s = n_shards - 1
        n_ok = int(ok.sum())
        with uncounted():
            t_b = timed(lambda t: tsh.apply_balances_local(
                t, dslot, cslot, ok, amt, pend, s * local, gcap),
                setup=lambda: (clone_table(at[s]),))
            t_bp = timed(lambda t: tsh.apply_balances_local_plain(
                t, dslot, cslot, ok, amt, pend, s * local, gcap),
                setup=lambda: (clone_table(at[s]),))
            t_l = timed(lambda t: tsh._scatter_local(
                t, gate, scat, s_slot, incl, s * local),
                setup=lambda: (clone_table(at[s]),))
            t_lp = timed(lambda t: tsh._scatter_local_plain(
                t, torch.tensor(True, device=dev), scat, s_slot, incl,
                s * local), setup=lambda: (clone_table(at[s]),))
        in_range = int(((s_slot >= s * local) & (s_slot < (s + 1) * local)
                        & scat).sum())
        out["balance_slot_base"] = dict(
            **pair_times(t_b, t_bp),
            bound=bound(LANES + n_ok * 25 + 2 * n_ok * 64 // n_shards,
                        30 * n_ok),
            shape=f"one shard of {n_shards} (accounts 2^{SHARD_ACCOUNTS_LOG2}"
                  f" / {n_shards}), {n_ok} accepted lanes")
        out["full_legs_slot_base"] = dict(
            **pair_times(t_l, t_lp),
            bound=bound(2 * LANES * 9 + in_range * 8 * 8 * 2, 2 * LANES),
            shape=f"one shard of {n_shards}, {2 * LANES} legs, "
                  f"{in_range} tails in its range")
        del xt, at, part, got, want
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return {"results": out, "checked": checked}


def shard_sweep_batches(n_transfers: int) -> list:
    """bench.py:1149 run_shard_sweep's mix at the flagship's width: uniform
    plain batches of the flagship generator, every fourth pair a pending
    batch followed by a batch posting each of its pendings."""
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.utils.benchgen import gen_batch_np

    batches, pend = [], None
    for b in range((n_transfers + COUNT - 1) // COUNT):
        kind = b % 4
        if kind == 3 and pend is not None:
            ids, base = pend
            batch = np.zeros(COUNT, dtype=types.TRANSFER_DTYPE)
            batch["id_lo"] = base + (1 << 22) + np.arange(COUNT,
                                                          dtype=np.uint64)
            batch["pending_id_lo"] = ids
            batch["ledger"] = 1
            batch["code"] = 10
            batch["flags"] = types.TransferFlags.POST_PENDING_TRANSFER
            pend = None
        elif kind == 2:
            base = (1 << 41) + b * COUNT
            batch = gen_batch_np(b, COUNT, COUNT, N_ACCOUNTS, base)
            batch["flags"] = types.TransferFlags.PENDING
            pend = (batch["id_lo"].copy(), base)
        else:
            batch = gen_batch_np(b, COUNT, COUNT, N_ACCOUNTS,
                                 (1 << 40) + b * COUNT)
        batches.append(batch)
    return batches


def sharded_machine(dev, shards: int):
    """A machine of ``shards`` (0: the single device) with 10,000 accounts,
    at the default capacities: its tables grow as the phase commits (under
    shards, the host re-placement and each shard's peak floor; the posted
    table at twice the rows)."""
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine

    cfg = LedgerConfig(lazy_index=True)
    m = TorchStateMachine(cfg, batch_lanes=LANES, device=dev, shards=shards)
    if m.shards != shards:
        raise AssertionError(f"sharded: asked {shards} shards, got {m.shards}")
    for start in range(0, N_ACCOUNTS, COUNT):
        ids = range(start + 1, min(N_ACCOUNTS, start + COUNT) + 1)
        if m.create_accounts(types.accounts_array(
                [types.account(id=i, ledger=1, code=10) for i in ids])) != []:
            raise AssertionError("sharded: account creation failed")
    return m


def ledger_rows(m) -> dict:
    """The content of a machine's canonical ledger, layout aside: each
    pad's live rows (every per-slot array) sorted by key, its count, and
    the history log as it is.  Two machines that placed the same rows in
    another insertion order (a single device, a mesh of another shard
    count) hold them in other slots where keys collided: the canonical
    view is canonical for a shard count, as the JAX package's is.  Nor is
    the capacity content: a sharded machine grows its posted table at
    twice the rows, and a shard's peak can grow a table early."""
    from tigerbeetle_tpu_torch.vsr import checkpoint as tck

    arrays = tck.ledger_to_arrays(m.checkpoint_ledger())
    out = {k: v for k, v in arrays.items() if k.startswith("history/")}
    for pad in ("accounts", "transfers", "posted"):
        lo, hi = arrays[f"{pad}/key_lo"], arrays[f"{pad}/key_hi"]
        live = ((lo | hi) != 0) & ~arrays[f"{pad}/tombstone"]
        order = np.lexsort((lo[live], hi[live]))
        for k, v in arrays.items():
            if k.startswith(pad + "/") and v.shape == lo.shape:
                out[k] = v[live][order]
        out[f"{pad}/count"] = arrays[f"{pad}/count"]
    return out


def content_equal(what: str, a, b) -> None:
    x, y = ledger_rows(a), ledger_rows(b)
    if sorted(x) != sorted(y):
        raise AssertionError(f"{what}: the ledgers differ in arrays")
    max_abs_err(what, x, {k: y[k] for k in x})
    if a.digest() != b.digest():
        raise AssertionError(f"{what}: digests differ")


def phase_sharded(dev, n_transfers: int, n_group: int) -> dict:
    """bench.py's shard-sweep mix at the flagship's width through
    ``TorchStateMachine(shards=s)`` on 8 virtual devices over the card,
    against a single-device machine, batch by batch and at the end (the
    rows of every table, the digest, the scrub folds; the Merkle subtrees
    against a fresh build); a grouped and deferred 4-shard run; a 2 -> 4
    split while serving.  Every machine starts at the default capacities
    and grows.  The launch counts are set to 0 before each of the four
    runs and read after it."""
    import torch
    from tigerbeetle_tpu_torch import device as tdev
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import scrub as scrub_ops

    batches = shard_sweep_batches(n_transfers)
    t0 = time.perf_counter()
    single = sharded_machine(dev, 0)
    want = [single.create_transfers(b) for b in batches]
    torch.cuda.synchronize()
    out = {"batches": len(batches), "transfers": sum(map(len, batches)),
           "single_device_tx_s": sum(map(len, batches))
           / (time.perf_counter() - t0),
           "fails": sum(map(len, want))}
    single_fold = to_np(scrub_ops.scrub_digest(single.ledger))
    out["single_capacities"] = [single.ledger.accounts.capacity,
                                single.ledger.transfers.capacity,
                                single.ledger.posted.capacity]
    launches = {}
    tdev.force_virtual(8, dev)
    try:
        for s in (2, 8):
            m = sharded_machine(dev, s)
            m.merkle_enabled = True
            m.scrub_interval = 1 << 30  # Merkle updates on every commit, no checks
            m.scrub_paranoid = False
            if not m.scrub_arm():
                raise AssertionError("sharded: Merkle did not arm")
            m.warmup()
            torch.cuda.synchronize()
            _cuda.reset_counts()
            t0 = time.perf_counter()
            for j, b in enumerate(batches):
                if m.create_transfers(b) != want[j]:
                    raise AssertionError(f"sharded {s}: batch {j} codes differ")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[f"shards_{s}"] = _cuda.counts()
            lanes = m._d2h_u64(m._shard_steps["scrub"](m.ledger))
            with np.errstate(over="ignore"):
                folded = lanes.sum(axis=0, dtype=np.uint64)
            if not np.array_equal(folded, single_fold):
                raise AssertionError(f"sharded {s}: scrub lanes do not fold")
            # The per-shard subtrees, touched by K1 and K23 on every
            # commit, against a fresh K22 build of each shard.
            if not m.scrub_check():
                raise AssertionError(f"sharded {s}: Merkle roots disagree")
            content_equal(f"sharded {s}", m, single)
            out[f"shards_{s}"] = {
                "tx_s": out["transfers"] / wall, "wall_s": wall,
                "shard_lanes_cross": m.shard_lanes_cross,
                "shard_lanes_total": m.shard_lanes_total,
                "seq_fallbacks": m.shard_seq_fallbacks,
                "capacities": [m.ledger.accounts.capacity,
                               m.ledger.transfers.capacity,
                               m.ledger.posted.capacity],
            }
            del m
            torch.cuda.empty_cache()
        # Grouped and deferred at 4 shards: runs of the fast-path batches
        # (plain, pending) as grouped deferred runs, single batches deferred,
        # the posts blocking; codes as the blocking path's.
        k_group = (n_group + COUNT - 1) // COUNT
        g = sharded_machine(dev, 4)
        g.group_device_commit = True
        g.warmup()
        torch.cuda.synchronize()
        _cuda.reset_counts()
        t0 = time.perf_counter()
        j = 0
        grouped = deferred = 0
        while j < k_group:
            run = []
            while j + len(run) < k_group and not (
                    batches[j + len(run)]["flags"][0]
                    & 4):  # POST_PENDING_TRANSFER
                run.append(batches[j + len(run)])
            if len(run) >= 2 and (j // 4) % 2 == 0:
                tss = [g.prepare("create_transfers", len(b), 0) for b in run]
                h = g.commit_group_fast(run, tss, deferred=True)
                if h is None or h.resolve() != want[j:j + len(run)]:
                    raise AssertionError(f"sharded grouped: run at {j}")
                grouped += len(run)
                j += len(run)
            elif run:
                # Every other run: each batch deferred on its own, all in
                # flight before the first resolve.
                hs = []
                for b in run:
                    ts = g.prepare("create_transfers", len(b), 0)
                    hs.append(g.commit_fast_deferred(b, ts))
                for h in hs:
                    if h is None or h.resolve()[0] != want[j]:
                        raise AssertionError(f"sharded deferred: batch {j}")
                    deferred += 1
                    j += 1
            else:
                if g.create_transfers(batches[j]) != want[j]:
                    raise AssertionError(f"sharded grouped: post batch {j}")
                j += 1
        torch.cuda.synchronize()
        launches["grouped_4"] = _cuda.counts()
        out["grouped_4"] = {"batches": k_group, "grouped": grouped,
                            "deferred": deferred,
                            "tx_s": sum(len(b) for b in batches[:k_group])
                            / (time.perf_counter() - t0),
                            "capacities": [g.ledger.accounts.capacity,
                                           g.ledger.transfers.capacity,
                                           g.ledger.posted.capacity]}
        # The 2 -> 4 split while serving the same batches; it must cut over
        # to the grouped 4-shard machine's state.
        live = sharded_machine(dev, 2)
        torch.cuda.synchronize()
        _cuda.reset_counts()
        for b in range(SHARDED_SPLIT_AT):
            if live.create_transfers(batches[b]) != want[b]:
                raise AssertionError(f"split: batch {b} before the split")
        t0 = time.perf_counter()
        if not live.reshard_begin(4, chunk_rows=SHARDED_SPLIT_CHUNK):
            raise AssertionError("split: refused")
        # A batch served after every step while there are batches left:
        # every served batch dirties moved rows, which a catch-up round (a
        # fresh snapshot and its trees) ships again.
        served = SHARDED_SPLIT_AT
        while live.reshard_active:
            live.reshard_step(4)
            if live.reshard_active and served < k_group:
                if live.create_transfers(batches[served]) != want[served]:
                    raise AssertionError(f"split: batch {served} served")
                served += 1
        for b in range(served, k_group):
            if live.create_transfers(batches[b]) != want[b]:
                raise AssertionError(f"split: batch {b} after the cutover")
        torch.cuda.synchronize()
        launches["split_2_to_4"] = _cuda.counts()
        if live.shards != 4 or live.reshard_stats["splits_completed"] != 1:
            raise AssertionError(f"split: {live.reshard_stats}")
        if live.reshard_stats["catchup_rounds"] < 2:
            raise AssertionError("split: fewer than two catch-up rounds "
                                 f"served through: {live.reshard_stats}")
        content_equal("split vs the 4-shard machine", live, g)
        out["split_2_to_4"] = {
            **live.reshard_stats, "served_during": served - SHARDED_SPLIT_AT,
            "wall_s": time.perf_counter() - t0}
    finally:
        tdev.force_virtual(0, dev)
    out["launches"] = launches
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--transfers", type=int, default=10_000_000)
    # Cut from bench.py's --two-phase size (10,000,000) to keep the whole
    # script near ten minutes and the path's rate comparable with the
    # earlier runs' at this depth; the general path's two phases run
    # bench.py's size.
    p.add_argument("--seq-transfers", type=int, default=2_000_000)
    # bench.py's depth for the general path's two full-size shapes.
    p.add_argument("--full-transfers", type=int, default=10_000_000)
    # The queries phase's depth: bench.py's 10,000,000 transfers.
    p.add_argument("--query-transfers", type=int, default=10_000_000)
    # The tiered phase's depth: BASELINE.json config 4's 1,000,000,000
    # transfers cut to 24,000,000 (about ten evictions of the 2^23 hot
    # window, a merge of the cold runs among them) to fit the run's time.
    p.add_argument("--tier-transfers", type=int, default=24_000_000)
    # The bench twin's depth: bench.py's 10,000,000 transfers.
    p.add_argument("--bench-transfers", type=int, default=10_000_000)
    p.add_argument("--commit-transfers", type=int, default=COMMIT_TRANSFERS)
    # The pipeline phase's depth: the flagship's 10,000,000 transfers.
    p.add_argument("--pipeline-transfers", type=int, default=10_000_000)
    # The sharded phase's depth: each of the 2- and 8-shard machines.
    p.add_argument("--sharded-transfers", type=int, default=SHARDED_TRANSFERS)
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tigerbeetle_tpu_torch.ops import _cuda

    _cuda.LEGS_STATS_ON = True  # the full paths and the tiered run read them
    smi = nvidia_smi()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    dev = torch.device("cuda")

    # The kernels' library and the phase clock's build, nvcc all at once.
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        clocked = pool.submit(phase_clock().library)
        seconds = _cuda.build_seconds()
        clocked.result()
    emit({"phase": "build", "seconds": seconds,
          "library": str(_cuda.library_path().name)})

    t0 = time.perf_counter()
    kern = phase_kernels(args.seed, dev)
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
          "kernels": {k: {kk: vv for kk, vv in v.items() if kk != "bound"}
                      for k, v in kern.items()}})

    t0 = time.perf_counter()
    parity = phase_parity(args.seed, dev)
    emit({"phase": "parity", "seconds": time.perf_counter() - t0, **parity})

    from tigerbeetle_tpu_torch import bench

    twin_plan = bench.plan(args.bench_transfers, COUNT)
    twin_batches = twin_plan[1] + twin_plan[2]
    if (args.transfers + COUNT - 1) // COUNT < twin_batches:
        twin_batches = 0  # main runs fewer batches: nothing to compare
    _cuda.reset_counts()
    main_run = phase_main(dev, args.transfers, twin_batches)
    launches = _cuda.counts()
    main_snapshot = main_run.pop("snapshot")
    # K2's round form (its growths) is counted apart from the batches' K2.
    emit({"phase": "main", "launches": launches,
          "k2_round_form_calls": _cuda.ROUND_FORM_CALLS, **main_run})
    missing = [k for k in MAIN_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    t0 = time.perf_counter()
    seqk = phase_seq_kernels(args.seed, dev)
    kern.update(seqk["results"])
    emit({"phase": "seq_kernels", "seconds": time.perf_counter() - t0,
          "prep_launches": seqk["prep_launches"],
          "codes_seen": seqk["codes_seen"],
          "kernels": {k: {kk: vv for kk, vv in v.items() if kk != "bound"}
                      for k, v in seqk["results"].items()}})
    if seqk["prep_launches"]["tombstone"] == 0:
        raise AssertionError("K8 was not launched making the tables")

    t0 = time.perf_counter()
    seqp = phase_seq_parity(args.seed, dev)
    emit({"phase": "seq_parity", "seconds": time.perf_counter() - t0, **seqp})

    _cuda.reset_counts()
    t0 = time.perf_counter()
    seq_run = phase_sequential(dev, args.seq_transfers)
    seq_launches = _cuda.counts()
    emit({"phase": "sequential", "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi, "launches": seq_launches, **seq_run})
    missing = [k for k in SEQ_PATH if seq_launches[k] == 0]
    if missing:
        raise AssertionError(
            f"kernels not launched on the sequential path: {missing}")

    t0 = time.perf_counter()
    fullk = phase_full_kernels(args.seed, dev)
    kern.update(fullk["results"])
    # K2's claim and write entries at the kernels phase's K2 shapes.
    ins = kern["insert"]
    kern["claim"].update(ms_path_shape=ins["claim_path_shape"]["ms"],
                         ms_twophase_shape=ins["claim_twophase_shape"]["ms"],
                         ms_adversarial=ins["claim_adversarial"]["ms"])
    kern["write_claimed"]["ms_path_shape"] = \
        ins["claim_path_shape"]["write_ms"]
    emit({"phase": "full_kernels", "seconds": time.perf_counter() - t0,
          "batches_checked": fullk["batches_checked"],
          "kflags_at_8_passes": fullk["kflags"], "traps": fullk["traps"],
          "core_device_ms_by_name": fullk["core_device_ms_by_name"],
          "kernels": {k: {kk: vv for kk, vv in v.items() if kk != "bound"}
                      for k, v in fullk["results"].items()}})

    t0 = time.perf_counter()
    fullp = phase_full_parity(args.seed, dev)
    emit({"phase": "full_parity", "seconds": time.perf_counter() - t0, **fullp})

    full_launches, full_k10_stats = {}, {}
    for shape in ("twophase", "limits"):
        t0 = time.perf_counter()
        run = phase_full_path(dev, shape, args.full_transfers)
        emit({"phase": "full_" + shape, "seconds": time.perf_counter() - t0,
              "nvidia_smi": smi, **run})
        full_launches[shape] = run["launches"]
        full_k10_stats[shape] = run["k10_stats"]

    t0 = time.perf_counter()
    idxk = phase_index_kernels(args.seed, dev)
    emit({"phase": "index_kernels", "seconds": time.perf_counter() - t0,
          "checked": idxk["checked"],
          "kernels": {k: {kk: vv for kk, vv in v.items() if kk != "bound"}
                      for k, v in idxk["results"].items()}})

    t0 = time.perf_counter()
    qp = phase_queries_parity(args.seed, dev)
    emit({"phase": "queries_parity", "seconds": time.perf_counter() - t0, **qp})

    t0 = time.perf_counter()
    qrun = phase_queries(dev, args.query_transfers, smi)
    emit({"phase": "queries", "seconds": time.perf_counter() - t0,
          **{k: v for k, v in qrun.items() if k not in ("k13", "k15", "k16")},
          **{name: {k: v for k, v in qrun[name].items() if k != "bound"}
             for name in ("k13", "k15", "k16")}})
    kern.update(idxk["results"])
    kern["run_sort"].update(qrun["k13"])
    kern["index_window"].update(qrun["k15"])
    kern["history_scan"].update(qrun["k16"])
    t0 = time.perf_counter()
    coldk = phase_cold_kernels(args.seed, dev)
    emit({"phase": "cold_kernels", "seconds": time.perf_counter() - t0,
          "checked": coldk["checked"],
          "kernels": {k: {kk: vv for kk, vv in v.items() if kk != "bound"}
                      for k, v in coldk["results"].items()},
          "bounds_ms": {k: v["bound"] for k, v in coldk["results"].items()
                        if "bound" in v}})
    kern.update({k: v for k, v in coldk["results"].items() if k in _cuda.KERNELS})

    t0 = time.perf_counter()
    trun = phase_tiered(dev, args.tier_transfers)
    emit({"phase": "tiered", "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi, **trun})

    t0 = time.perf_counter()
    flag = phase_flagship(dev, args.seed, main_snapshot,
                          ["--transfers", str(args.bench_transfers)])
    del main_snapshot
    emit({"phase": "flagship", "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi, "bench_gen_checked": flag["checked"],
          "sync_debug_mode_catches_item": flag["sync_debug_mode_catches_item"],
          "launches": flag["launches"],
          "twin_batches_compared_with_main": twin_batches,
          "k20": {k: v for k, v in flag["k20"].items() if k != "bound"},
          "rates": {k: v["value"] for k, v in flag["runs"].items()},
          "device_idle_share": {k: v["device_idle_share"]
                                for k, v in flag["runs"].items()}})
    kern["bench_gen"] = flag["k20"]

    t0 = time.perf_counter()
    sk = phase_scrub_kernels(args.seed, dev)
    emit({"phase": "scrub_kernels", "seconds": time.perf_counter() - t0, **sk})

    t0 = time.perf_counter()
    com = phase_commitments(dev, args.commit_transfers, args.seed)
    lean = com.pop("machine")
    emit({"phase": "commitments", "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi,
          "cut": {"transfers": [2_000_000, args.commit_transfers],
                  "root_check_every_batches": [100, ROOT_CHECK_EVERY],
                  "why": "the paranoid mode's host mirror costs ~0.4 s a "
                         "batch and ~1 us a transfer at every check"},
          **{k: v for k, v in com.items() if k != "kernels"},
          "kernels": {k: {kk: vv for kk, vv in v.items() if kk != "bound"}
                      for k, v in com["kernels"].items()},
          "bounds_ms": {k: v["bound"] for k, v in com["kernels"].items()}})
    kern.update(com["kernels"])
    missing = [k for k in COMMIT_PATH if com["launches"][k] == 0]
    if missing:
        raise AssertionError(
            f"kernels not launched on the commitments path: {missing}")

    t0 = time.perf_counter()
    pk = phase_pipeline_kernels(args.seed, dev, kern)
    emit({"phase": "pipeline_kernels", "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi, "checked": pk["checked"],
          "graph_nodes": pk["graph_nodes"],
          "graph_forms": pk["forms"],
          "kernels": {k: {kk: vv for kk, vv in v.items() if kk != "bound"}
                      for k, v in pk["results"].items()},
          "bounds_ms": {k: v["bound"] for k, v in pk["results"].items()}})
    kern.update(pk["results"])

    t0 = time.perf_counter()
    pipe = phase_pipeline(dev, args.pipeline_transfers, main_run)
    emit({"phase": "pipeline", "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi, **pipe})
    missing = [k for k in PIPELINE_PATH if pipe["launches"][k] == 0]
    if missing:
        raise AssertionError(
            f"kernels not launched on the pipeline path: {missing}")

    t0 = time.perf_counter()
    per = phase_persistence(dev, lean)
    del lean
    emit({"phase": "persistence", "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi, **per})

    t0 = time.perf_counter()
    vk = phase_vopr_kernels(args.seed, dev)
    emit({"phase": "vopr_kernels", "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi, "checked": vk["checked"],
          "caught_at_check_size": vk["caught_at_check_size"],
          "k29_launch": vk["k29_launch"],
          "kernels": {k: {kk: vv for kk, vv in v.items() if kk != "bound"}
                      for k, v in vk["results"].items()},
          "bounds_ms": {k: v["bound"] for k, v in vk["results"].items()}})
    kern.update(vk["results"])

    t0 = time.perf_counter()
    vo = phase_vopr(dev, args.seed, smi)
    emit({"phase": "vopr", "seconds": time.perf_counter() - t0, **vo})

    t0 = time.perf_counter()
    shk = phase_shard_kernels(args.seed, dev)
    emit({"phase": "shard_kernels", "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi, "checked": shk["checked"],
          "kernels": {k: {kk: vv for kk, vv in v.items() if kk != "bound"}
                      for k, v in shk["results"].items()},
          "bounds_ms": {k: v["bound"] for k, v in shk["results"].items()}})
    kern.update({k: v for k, v in shk["results"].items()
                 if k in _cuda.KERNELS})

    t0 = time.perf_counter()
    shd = phase_sharded(dev, args.sharded_transfers,
                        min(SHARDED_GROUP_TRANSFERS, args.sharded_transfers))
    emit({"phase": "sharded", "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi, **shd})
    for run, names in (("shards_2", SHARDED_PATH), ("shards_8", SHARDED_PATH),
                       ("grouped_4", ("shard_gather",)),
                       ("split_2_to_4", ("shard_gather",))):
        missing = [k for k in names if shd["launches"][run][k] == 0]
        if missing:
            raise AssertionError(
                f"kernels not launched on the sharded {run} run: {missing}")
    # On one card every gather round is K30's one row: no K31 (it sums only
    # across cards' groups, which one card does not have).
    k31 = {run: shd["launches"][run]["shard_combine"] for run in
           ("shards_2", "shards_8", "grouped_4", "split_2_to_4")}
    emit({"phase": "sharded", "k31_launches": k31,
          "k31_launches_8_shards_parent_perf_md": K31_PARENT_LAUNCHES})
    if any(k31.values()):
        raise AssertionError(f"K31 launched on one card: {k31}")

    # max_abs_err: index_kernels' cases and the queries phase's full-size
    # comparisons (the deepest carried level, the rebuilt level, K15 over
    # the whole pyramid, K16 over the whole log).
    for name, err in qrun["full_size_errs"].items():
        kern[name]["max_abs_err"] = max(idxk["results"][name]["max_abs_err"], err)

    # Each kernel's launches come from the path it serves: K1-K5 from the
    # main path, K6/K7/K32 from the sequential path, K8 from making the tables
    # of seq_kernels (its device function runs inside K6/K7's rollbacks),
    # K9-K12 and K2's claim/write entries from the general path's two-phase
    # run (the limits run launched each of them too), K13-K16 from the
    # queries phase, K17-K19 from the tiered phase, K20 and K26 from the
    # bench twin's plain shape, K21-K23 from the commitments phase, K24,
    # K25 and the grouped commit's replays from the pipeline phase's
    # grouped runs, K29 from the vopr phase's scale run (b), K27 and K28
    # from its step-locked route (e) (K29 runs their device functions),
    # K30 and K31 from the sharded phase's 8-shard run (their ms: 8 shards
    # over the main phase's tables, ms_shape).
    paths = {name: ("main", launches) for name in MAIN_PATH}
    paths.update({name: ("sequential", seq_launches)
                  for name in ("seq_prepass", "seq_transfers", "seq_accounts")})
    paths["tombstone"] = ("seq_kernels tables", seqk["prep_launches"])
    paths.update({name: ("full_twophase", full_launches["twophase"])
                  for name in FULL_PATH if name != "probe"})
    paths.update({name: ("queries", qrun["launches"])
                  for name in INDEX_PATH if name != "probe"})
    paths.update({name: ("tiered", trun["launches"]) for name in
                  ("bloom_check", "evict_threshold", "evict_extract")})
    paths.update({name: ("flagship (bench twin, plain)", flag["launches"])
                  for name in ("bench_gen", "group_words")})
    paths.update({name: ("commitments", com["launches"]) for name in
                  ("scrub_fold", "merkle_build", "merkle_touch")})
    paths.update({name: ("pipeline (a), grouped runs", pipe["launches"])
                  for name in ("group_dispatch", "group_step",
                               "group_finish")})
    paths["vopr_run"] = ("vopr (b), tools/vopr_scale.py's run", vo["launches_b"])
    paths["shard_gather"] = ("sharded (8 shards, tables grown from the "
                             "defaults)", shd["launches"]["shards_8"])
    paths["shard_combine"] = ("sharded (8 shards on one card): none, a gather "
                              "round is K30's one row a card; K31 sums only "
                              "the groups of a mesh across cards",
                              shd["launches"]["shards_8"])
    paths.update({name: ("vopr (e), the step-locked route", vo["launches_e"])
                  for name in ("vopr_draw", "vopr_step")})
    rows = []
    for name, k in _cuda.KERNELS.items():
        r = kern[name]
        path, counts = paths[name]
        rows.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            "launches_path": path,
        })
        if name in ("shard_gather", "shard_combine"):
            rows[-1]["ms_shape"] = r["shape"]
        if name == "full_legs":
            # K10's launches in the core: those that ran (the rest returned
            # at once, the loop over) and those that found the cache stale.
            rows[-1]["launches_ran"] = full_k10_stats["twophase"]["ran"]
            rows[-1]["launches_sorted"] = full_k10_stats["twophase"]["sorted"]
        if name == "bloom_check":
            # K17's count is of K1 launches that carried its step; its own
            # kernel (the out and masked forms) is timed apart.
            rows[-1].update(
                launches_form="the K1 launches that carried K17's step "
                              "(csrc/probe.cu's flag word)",
                launches_in_k1=trun["k17_launches_in_k1"],
                launches_own=trun["k17_own_launches"],
                ms_form="the K1 launch carrying the step, tiered shape",
                step_ms=r["step_ms"], step_bound_ms=r["step_bound_ms"],
                ms_7_lookups=r["ms_7_lookups"],
                ms_own_out_form=r["ms_own_out_form"],
                ms_own_masked_form=r["ms_own_masked_form"])
        for key in ("ms_accounts_2e21", "library_ms_accounts_2e21",
                    "ms_with_prepass", "ms_path_shape", "ms_graph_form",
                    "ms_graph_replay", "ms_mixed_2040", "ms_16384",
                    "ms_twophase_shape", "ms_adversarial",
                    "rounds_path_shape", "deepest_lane_path_shape",
                    "ms_no_rounds", "core_ms", "hist_append_ms",
                    "round_form", "shapes", "bound_with_order_check_ms",
                    "ms_form", "ms_stale_cache", "ms_no_cache"):
            if key in r:
                rows[-1][key] = r[key]
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
