"""The port's commit pipeline (deferred and grouped commits, ``ops/group.py``
and the machine's dispatch lane) against the JAX package's on the CPU,
exactly: codes, every table array, ``count`` and ``probe_overflow`` are
integers, so the tolerance is zero.

- tests/test_pipeline.py's ``TestMachineDeferred`` and
  tests/test_group_commit.py's ``TestMachineGroupParity``, restated with a
  port machine beside a JAX machine (and the scalar oracle), plus runs of 2,
  17 and 32 batches;
- the grouped dispatch itself: ``group_dispatch_steps`` (the plain version)
  against the JAX ``_group_fast_dispatch_impl`` on the same stacked batches,
  padding batches included; K24's plain version against the fast path's
  lane rules, K25's and K26's (the bench twin's step words) against the
  reference's; the staging set;
- the sanitizer's counterpart: poisoned staging sets and the capture
  tripwire (the capture itself happens only on the card:
  tests/test_torch_kernels.py).

On the CPU the grouped commit runs the plain loop; the captured graph of
K24, K1-K4 reading device words, and K25 is held against it on the card
(tests/test_torch_kernels.py and chip_smoke.py's ``pipeline_kernels``)."""

import copy

import numpy as np
import pytest
import torch

from torch_fault_domain import assert_ledgers_equal, jax_ledger

import jax
import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu import machine as jmachine
from tigerbeetle_tpu import types
from tigerbeetle_tpu.config import LedgerConfig
from tigerbeetle_tpu.machine import TpuStateMachine
from tigerbeetle_tpu.testing import model as M
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch import machine as tmachine
from tigerbeetle_tpu_torch import sanitize as san
from tigerbeetle_tpu_torch.machine import DeviceCommitHandle, TorchStateMachine
from tigerbeetle_tpu_torch.ops import group
from tigerbeetle_tpu_torch.ops import state_machine as sm

LANES = 64
CFG = LedgerConfig(accounts_capacity_log2=10, transfers_capacity_log2=12,
                   posted_capacity_log2=10)
N_ACCOUNTS = 16
CPU = torch.device("cpu")


def accounts_batch():
    return types.accounts_array([
        types.account(id=i + 1, ledger=1, code=10) for i in range(N_ACCOUNTS)
    ])


def batch(first_id, n, amount=3, flags=0):
    return types.transfers_array([
        types.transfer(
            id=first_id + i, debit_account_id=1 + i % N_ACCOUNTS,
            credit_account_id=1 + (i + 3) % N_ACCOUNTS,
            amount=amount + i % 5, ledger=1, code=10, flags=flags,
        )
        for i in range(n)
    ])


def port(group_commit=None, **kw) -> TorchStateMachine:
    m = TorchStateMachine(CFG, batch_lanes=LANES, device="cpu", **kw)
    if group_commit is not None:
        m.group_device_commit = group_commit
    assert m.create_accounts(accounts_batch(), wall_clock_ns=1000) == []
    return m


def jaxm(group_commit=None, **kw) -> TpuStateMachine:
    m = TpuStateMachine(CFG, batch_lanes=LANES, **kw)
    if group_commit is not None:
        m.group_device_commit = group_commit
    assert m.create_accounts(accounts_batch(), wall_clock_ns=1000) == []
    return m


def model() -> M.ReferenceStateMachine:
    ref = M.ReferenceStateMachine()
    assert ref.create_accounts(
        [M.account_from_row(r) for r in accounts_batch()], 1000) == []
    return ref


def assert_same(t: TorchStateMachine, j: TpuStateMachine) -> None:
    """Every table array, the clocks and the digest."""
    assert_ledgers_equal(convert.ledger_to_numpy(t.ledger),
                         convert.ledger_arrays(j.ledger))
    assert (t.prepare_timestamp, t.commit_timestamp) == (
        j.prepare_timestamp, j.commit_timestamp)
    assert t.digest() == j.digest()


# -- tests/test_pipeline.py TestMachineDeferred ---------------------------------


class TestMachineDeferred:
    def test_single_deferred_matches_blocking_and_model(self):
        t, j, blocking, ref = port(), jaxm(), port(), model()
        for k, b in enumerate([batch(1000, 20), batch(2000, 31),
                               batch(1000, 20)]):  # 3rd: every lane exists
            ts = t.prepare("create_transfers", len(b), 0)
            assert j.prepare("create_transfers", len(b), 0) == ts
            handle = t.commit_fast_deferred(b, ts)
            assert isinstance(handle, DeviceCommitHandle)
            (res_t,) = handle.resolve()
            (res_j,) = j.commit_fast_deferred(b, ts).resolve()
            blocking.prepare("create_transfers", len(b), 0)
            res_b = blocking.commit_batch("create_transfers", b, ts)
            res_m = ref.create_transfers([M.transfer_from_row(r) for r in b])
            assert res_t == res_j == res_b == res_m, f"batch {k}"
            assert_same(t, j)
        assert t.digest() == blocking.digest()
        assert t.balances_snapshot() == ref.balances_snapshot()

    def test_deferred_refuses_non_fast_batches_and_restores_bound(self):
        t, j = port(), jaxm()
        bound0 = t._balance_bound
        b = batch(3000, 4, flags=int(types.TransferFlags.LINKED))
        b["flags"][-1] = 0  # terminated chain; LINKED excludes the fast path
        assert t.commit_fast_deferred(
            b, t.prepare("create_transfers", 4, 0)) is None
        assert j.commit_fast_deferred(
            b, j.prepare("create_transfers", 4, 0)) is None
        assert t._balance_bound == bound0 == j._balance_bound

    def test_group_deferred_matches_blocking(self):
        t, j, blocking = port(True), jaxm(True), port(True)
        batches = [batch(1000 * (k + 1), 20 + k) for k in range(4)]
        tss = [t.prepare("create_transfers", len(b), 0) for b in batches]
        assert [j.prepare("create_transfers", len(b), 0)
                for b in batches] == tss
        handle = t.commit_group_fast(batches, tss, deferred=True)
        assert isinstance(handle, DeviceCommitHandle)
        res_t = handle.resolve()
        res_j = j.commit_group_fast(batches, tss, deferred=True).resolve()
        tss_b = [blocking.prepare("create_transfers", len(b), 0)
                 for b in batches]
        assert tss_b == tss
        res_b = blocking.commit_group_fast(batches, tss_b)
        assert res_t == res_j == res_b
        assert_same(t, j)
        assert t.digest() == blocking.digest()
        assert t.commit_timestamp == blocking.commit_timestamp

    def test_forced_probe_overflow_raises_at_resolve(self):
        """The overflow word rides the deferred codes read-back: a set flag
        fails the resolve loudly (injected: load-factor management keeps a
        real overflow unreachable)."""
        m = port()
        handle = m.commit_fast_deferred(
            batch(5000, 8), m.prepare("create_transfers", 8, 0))
        codes = handle._result.result()[0]
        handle._result = (codes, torch.ones(1, dtype=torch.int32))
        with pytest.raises(RuntimeError, match="probe overflow"):
            handle.resolve()

    def test_forced_probe_overflow_group(self):
        m = port(True)
        batches = [batch(6000, 4), batch(7000, 4)]
        tss = [m.prepare("create_transfers", 4, 0) for _ in batches]
        handle = m.commit_group_fast(batches, tss, deferred=True)
        codes = handle._result.result()[0]
        handle._result = (codes, torch.ones(1, dtype=torch.int32))
        with pytest.raises(RuntimeError, match="probe overflow"):
            handle.resolve()


# -- tests/test_group_commit.py TestMachineGroupParity ---------------------------


class TestMachineGroupParity:
    def test_grouped_equals_per_batch(self):
        grouped, j, serial = port(True), jaxm(True), port(False)
        batches = [batch(1000 * (k + 1), 20 + k) for k in range(5)]
        tss = [grouped.prepare("create_transfers", len(b), 0)
               for b in batches]
        res_g = grouped.commit_group_fast(batches, tss)
        assert res_g is not None, "an eligible run must group"
        for b in batches:
            j.prepare("create_transfers", len(b), 0)
        assert j.commit_group_fast(batches, tss) == res_g
        res_s = []
        for b, ts in zip(batches, tss):
            serial.prepare("create_transfers", len(b), 0)
            res_s.append(serial.commit_batch("create_transfers", b, ts))
        assert res_g == res_s
        assert grouped.digest() == serial.digest()
        assert_same(grouped, j)

    def test_failures_identical(self):
        grouped, j, serial = port(True), jaxm(True), port(False)
        b1 = batch(2000, 12)
        b2 = batch(2000, 12)  # full duplicate of b1: every lane 'exists'
        b3 = batch(3000, 8)
        b3["debit_account_id_lo"][3] = 999  # no such account
        run = [b1, b2, b3]
        tss = [grouped.prepare("create_transfers", len(b), 0) for b in run]
        for b in run:
            j.prepare("create_transfers", len(b), 0)
        res_g = grouped.commit_group_fast(run, tss)
        assert res_g is not None
        assert j.commit_group_fast(run, tss) == res_g
        res_s = []
        for b, ts in zip(run, tss):
            serial.prepare("create_transfers", len(b), 0)
            res_s.append(serial.commit_batch("create_transfers", b, ts))
        assert res_g == res_s
        assert len(res_g[1]) == 12  # the duplicate batch: per-lane 'exists'
        assert_same(grouped, j)

    def test_ineligible_run_refused(self):
        t, j = port(True), jaxm(True)
        balancing = types.transfers_array([types.transfer(
            id=5000, debit_account_id=1, credit_account_id=2, amount=5,
            ledger=1, code=10, flags=types.TransferFlags.BALANCING_DEBIT)])
        for m in (t, j):
            assert m.commit_group_fast(
                [batch(6000, 4), balancing],
                [m.prepare("create_transfers", 4, 0),
                 m.prepare("create_transfers", 1, 0)]) is None
        assert t._balance_bound == j._balance_bound

    def test_single_batch_refused(self):
        for m in (port(True), jaxm(True)):
            assert m.commit_group_fast(
                [batch(7000, 4)], [m.prepare("create_transfers", 4, 0)]
            ) is None

    @pytest.mark.parametrize("k", [2, 17, 32])
    def test_runs_match_jax(self, k):
        """Runs of k batches (the last batches reuse earlier ids, so they
        see the run's own inserts): results, every table array, count and
        probe_overflow equal the JAX machine's."""
        t, j = port(True), jaxm(True)
        rng = np.random.default_rng(k)
        run = []
        for i in range(k):
            first = 10_000 + 100 * int(rng.integers(0, max(1, k // 2)))
            run.append(batch(first, int(rng.integers(1, LANES + 1)),
                             amount=1 + i))
        tss = [t.prepare("create_transfers", len(b), 0) for b in run]
        for b in run:
            j.prepare("create_transfers", len(b), 0)
        res_t = t.commit_group_fast(run, tss)
        assert res_t is not None
        assert res_t == j.commit_group_fast(run, tss)
        assert_same(t, j)


# -- the grouped dispatch itself ---------------------------------------------------


def stacked_run(seed, k, counts):
    """A port ledger after accounts and one batch, and a stacked run of
    ``k`` rows (``counts`` events each; a 0 is a padding row)."""
    m = port()
    assert m.create_transfers(batch(900, 30)) == []
    rng = np.random.default_rng(seed)
    layout = group.StagingLayout(k, LANES)
    buf = np.zeros(layout.nbytes, np.uint8)
    cols, cnt, tss = layout.arrays(buf)
    ts = 10 ** 6
    for r in range(k):
        n = counts[r]
        b = batch(900 + 10 * int(rng.integers(0, 8)), n, amount=2 + r) \
            if n else batch(0, 0)
        for name, col in cols.items():
            col[r, :n] = b[name]
        ts += n
        cnt[r], tss[r] = n, ts
    return m, layout, buf


@pytest.mark.parametrize("counts", [[5, 0, 0, 0], [64, 17, 0, 3],
                                    [1, 64, 33, 64]])
def test_group_dispatch_steps_matches_jax_scan(counts):
    """The plain version (a loop of the fast path over the stacked rows)
    against the JAX package's lax.scan of create_transfers_impl: codes of
    every row, the widened overflow word, the id columns and every table
    array; padding rows (count 0) apply nothing."""
    m, layout, buf = stacked_run(sum(counts), len(counts), counts)
    # On the CPU the exchange arrays are views of the port's tensors, which
    # its run updates in place, and JAX may alias numpy buffers: JAX gets
    # copies, and its run completes first.
    jstacked = {name: col.copy()
                for name, col in layout.arrays(buf)[0].items()}
    jcnt, jtss = layout.arrays(buf)[1:]
    jled, jcodes, jovf, jlo, jhi = jax.block_until_ready(jax.jit(
        jmachine._group_fast_dispatch_impl)(
        jax_ledger(copy.deepcopy(convert.ledger_to_numpy(m.ledger))),
        jstacked, jcnt.copy(), jtss.copy()))
    stacked, cnt, tss = layout.tensors(torch.from_numpy(buf.copy()))
    led, codes, ovf, id_lo, id_hi = group.group_dispatch_steps(
        m.ledger, stacked, [int(c) for c in cnt], [int(t) for t in tss])
    np.testing.assert_array_equal(convert.tensor_to_array(codes),
                                  np.asarray(jcodes))
    np.testing.assert_array_equal(convert.tensor_to_array(ovf).reshape(()),
                                  np.asarray(jovf))
    np.testing.assert_array_equal(convert.tensor_to_array(id_lo),
                                  np.asarray(jlo))
    np.testing.assert_array_equal(convert.tensor_to_array(id_hi),
                                  np.asarray(jhi))
    assert_ledgers_equal(convert.ledger_to_numpy(led),
                         convert.ledger_arrays(jled))


@pytest.mark.parametrize("j", [0, 1, 3])
def test_group_step_plain_is_the_fast_paths_lane_rules(j):
    """K24's plain version: the lane mask and lane timestamps that the fast
    path's ``_valid`` and ``_timestamps`` make from host ints, the pending
    mask, and the run's overflow word (reset at step 0, ORed after)."""
    counts = torch.tensor([5, 64, 0, 17], dtype=torch.int64)
    tss = torch.from_numpy(np.array([100, 1 << 40, 1 << 40, (1 << 63) + 9],
                                    np.uint64).view(np.int64))
    flags = torch.tensor([2 * (i % 3 == 0) | (i % 5 == 0)
                          for i in range(LANES)], dtype=torch.int32)
    for table_flag in (False, True):
        for prev in (0, 1):
            valid, ts, pending, word = group.group_step_plain(
                counts, tss, j, flags, torch.tensor(table_flag),
                torch.tensor([prev], dtype=torch.int32))
            c, t = int(counts[j]), int(tss[j]) & ((1 << 64) - 1)
            assert torch.equal(valid, sm._valid(LANES, c, CPU))
            assert torch.equal(ts, sm._timestamps(c, t, LANES, CPU))
            assert torch.equal(pending, (flags & sm.TF_PENDING) != 0)
            want = (prev if j else 0) | int(table_flag)
            assert word.tolist() == [want]


def test_group_finish_plain_ors_the_table_flag():
    """K25's plain version: the run's word with the table's flag ORed in,
    the widened flag the reference returns (``machine.py:102``)."""
    for table_flag in (False, True):
        for prev in (0, 1):
            word = group.group_finish_plain(
                torch.tensor(table_flag),
                torch.tensor([prev], dtype=torch.int32))
            assert word.dtype == torch.int32
            assert word.tolist() == [prev | int(table_flag)]


@pytest.mark.parametrize("b0, count, ts0", [(0, 8190, 10_000),
                                            (41, 3, 1 << 62),
                                            ((1 << 64) - 2, 8190, 5)])
def test_group_words_plain_is_the_benchs_step_words(b0, count, ts0):
    """K26's plain version against bench.py's ``multi``/``step`` words in
    uint64 (``jnp``): batch ``b0 + i``, its timestamp ``ts0 + (b + 1) *
    count`` (wrapping), and the base advanced by k."""
    import jax.numpy as jnp

    k = 6
    base = torch.from_numpy(np.array([b0], np.uint64).view(np.int64))
    nxt, bidx, counts, tss = group.group_words_plain(base, count, ts0, k)
    i = jnp.arange(k, dtype=jnp.uint64)
    b = jnp.uint64(b0) + i
    ts = jnp.uint64(ts0) + (b + 1) * jnp.uint64(count)
    np.testing.assert_array_equal(bidx.numpy().view(np.uint64), np.asarray(b))
    np.testing.assert_array_equal(tss.numpy().view(np.uint64), np.asarray(ts))
    assert counts.tolist() == [count] * k
    assert nxt.numpy().view(np.uint64).tolist() == [(b0 + k) % (1 << 64)]


def test_staging_set_rows_and_dirty_tail():
    """A staging set holds the run's columns (u16 widened to u32), its
    counts and timestamps (the last repeated in the padding rows), and a
    refill zeroes the previous occupant's longer tails."""
    m = port(True)
    first = [batch(100, 40), batch(200, 7)]
    stage = m._stage_group(first, [11, 22], m.GROUP_K)
    cols, counts, tss = stage["layout"].tensors(stage["buf"])
    assert counts.tolist()[:3] == [40, 7, 0]
    assert tss.tolist()[:3] == [11, 22, 22]
    assert cols["id_lo"][0, :40].tolist() == list(range(100, 140))
    assert cols["code"].dtype == torch.int32
    m._stage_release(stage)
    again = m._stage_group([batch(300, 3), batch(400, 5)], [33, 44],
                           m.GROUP_K)
    assert again is stage  # the pool hands the set back
    cols = again["layout"].tensors(again["buf"])[0]
    assert cols["id_lo"][0, :3].tolist() == [300, 301, 302]
    assert not cols["id_lo"][0, 3:].any() and not cols["id_lo"][1, 5:].any()
    assert not cols["amount_lo"][0, 3:].any()


# -- the sanitizer's counterpart ------------------------------------------------


def test_poison_and_is_poisoned():
    bufs = [np.arange(16, dtype=np.uint64), np.ones(5, np.uint32)]
    assert not san.is_poisoned(bufs[0])
    assert san.poison(bufs) == 2
    assert all(san.is_poisoned(b) for b in bufs)
    assert not san.is_poisoned(np.zeros(0, np.uint8))
    bufs[1][2] = 0
    assert not san.is_poisoned(bufs[1])


def test_released_staging_sets_are_poisoned(monkeypatch):
    """Under TB_SANITIZE a resolved run's staging set is poisoned on
    release, and its next occupant still stages exactly (every lane of the
    poisoned set is dirty)."""
    monkeypatch.setenv("TB_SANITIZE", "1")
    t, j = port(True), jaxm(True)
    run = [batch(100, 9), batch(200, 12)]
    tss = [t.prepare("create_transfers", len(b), 0) for b in run]
    for b in run:
        j.prepare("create_transfers", len(b), 0)
    h = t.commit_group_fast(run, tss, deferred=True)
    stage = h._stage
    assert h.resolve() == j.commit_group_fast(run, tss)
    assert san.is_poisoned(stage["buf"].numpy())
    run = [batch(300, 3), batch(400, 5)]
    tss = [t.prepare("create_transfers", len(b), 0) for b in run]
    for b in run:
        j.prepare("create_transfers", len(b), 0)
    assert t.commit_group_fast(run, tss) == j.commit_group_fast(run, tss)
    assert_same(t, j)


def test_capture_tripwire(monkeypatch, capsys):
    """A CUDA-graph capture after warmup that no growth explains warns at
    the next quiescent read-back and raises under TB_SANITIZE_STRICT; one
    after a growth re-baselines.  (On the CPU no graph is captured: the
    count is moved by hand; the card's test captures for real.)"""
    monkeypatch.setenv("TB_SANITIZE", "1")
    monkeypatch.setenv("TB_SANITIZE_STRICT", "1")
    m = port()
    m.warmup()
    assert m._sanitize_capture_base == group.CAPTURES
    assert m.create_transfers(batch(100, 8)) == []  # quiet: nothing captured
    monkeypatch.setattr(group, "CAPTURES", group.CAPTURES + 1)
    with pytest.raises(san.SanitizeError, match="capture tripwire"):
        m.create_transfers(batch(200, 8))
    assert "CUDA graph capture" in capsys.readouterr().err
    # A growth makes the next capture legitimate.
    m._table_grow(m.ledger.accounts, m.ledger.accounts.capacity)
    monkeypatch.setattr(group, "CAPTURES", group.CAPTURES + 1)
    assert m.create_transfers(batch(300, 8)) == []
    assert m._sanitize_capture_base == group.CAPTURES


# -- knobs and entry points --------------------------------------------------------


def test_knobs_follow_the_reference(monkeypatch):
    """pipeline_depth (TB_PIPELINE), group_device_commit (TB_GROUP_COMMIT:
    on for a CUDA machine, off on the CPU, the env overriding both ways),
    fuse_batches (TB_FUSE) and GROUP_K read as the reference reads them."""
    for env, want in (("", 2), ("0", 1), ("1", 1), ("4", 4)):
        monkeypatch.setenv("TB_PIPELINE", env)
        assert tmachine.pipeline_depth_default() == want == \
            jmachine.pipeline_depth_default()
    m = TorchStateMachine(CFG, batch_lanes=LANES, device="cpu")
    # Deeper values are reserved in the reference (equivalent to 2 there);
    # the port holds them at 2.
    assert m.pipeline_depth == 2
    m.pipeline_depth = 0
    assert m.pipeline_depth == 1
    m.pipeline_depth = 5
    assert m.pipeline_depth == 2
    monkeypatch.delenv("TB_GROUP_COMMIT", raising=False)
    assert TorchStateMachine(CFG, device="cpu").group_device_commit is False
    monkeypatch.setenv("TB_GROUP_COMMIT", "1")
    assert TorchStateMachine(CFG, device="cpu").group_device_commit is True
    for env in ("", "0", "off", "1", "yes"):
        monkeypatch.setenv("TB_FUSE", env)
        j = TpuStateMachine(CFG, batch_lanes=LANES)
        assert TorchStateMachine(CFG, device="cpu").fuse_batches == \
            j.fuse_batches
    assert TorchStateMachine.GROUP_K == TpuStateMachine.GROUP_K == 32


def test_warmup_leaves_the_ledger_as_it_was():
    """warmup runs every serving kernel on zero-count batches: the ledger,
    the clocks and the digest are unchanged."""
    m = port()
    assert m.create_transfers(batch(100, 20)) == []
    before = convert.ledger_to_numpy(m.ledger)
    clocks = (m.prepare_timestamp, m.commit_timestamp)
    m.warmup()
    assert_ledgers_equal(convert.ledger_to_numpy(m.ledger), before)
    assert (m.prepare_timestamp, m.commit_timestamp) == clocks


def test_blocking_paths_join_the_lane():
    """A query made while deferred runs are in flight sees them: reading
    the ledger joins the dispatch lane (the handles then resolve in op
    order, before the next blocking commit)."""
    t, j = port(True), jaxm(True)
    handles = []
    for k in range(3):
        b = batch(1000 * (k + 1), 30)
        ts = t.prepare("create_transfers", len(b), 0)
        j.prepare("create_transfers", len(b), 0)
        handles.append(t.commit_fast_deferred(b, ts))
        j.commit_fast_deferred(b, ts).resolve()
    assert t.lookup_transfers([1000, 2029, 3015]).tobytes() == \
        j.lookup_transfers([1000, 2029, 3015]).tobytes()
    assert t.digest() == j.digest()
    assert [h.resolve() for h in handles] == [[[]]] * 3
    assert t.create_transfers(batch(9000, 5)) == \
        j.create_transfers(batch(9000, 5))
    assert_same(t, j)


def test_discard_quiesces_and_releases():
    m = port(True)
    run = [batch(100, 9), batch(200, 12)]
    h = m.commit_group_fast(
        run, [m.prepare("create_transfers", len(b), 0) for b in run],
        deferred=True)
    assert m._deferred_inflight == 1
    h.discard()
    assert m._deferred_inflight == 0
    assert len(m._stage_pool[m.GROUP_K]) == 1
    h.discard()  # idempotent


def test_fusion_enabled_is_the_reference_function():
    """vsr/overload.py holds the one function of the reference module the
    machine reads, copied."""
    import inspect

    from tigerbeetle_tpu.vsr import overload as jov
    from tigerbeetle_tpu_torch.vsr import overload as tov

    assert inspect.getsource(tov.fusion_enabled) == \
        inspect.getsource(jov.fusion_enabled)


def test_lane_and_serving_thread_under_a_short_switch_interval():
    """The serving thread and the dispatch lane share the machine: with the
    interpreter switching threads every microsecond, a stream of deferred
    single batches and grouped runs at depth 2, with queries and blocking
    commits between them, ends in the blocking twin's ledger and clocks
    (a lost update of the ledger, a bound or the in-flight count would
    split them)."""
    import sys

    rng = np.random.default_rng(77)
    t, twin = port(True), port(True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        inflight = []
        next_id = 100_000
        for step in range(24):
            k = int(rng.integers(1, 4))
            run = []
            for _ in range(k):
                n = int(rng.integers(1, LANES + 1))
                run.append(batch(next_id, n, amount=1 + step))
                next_id += n
            tss = [t.prepare("create_transfers", len(b), 0) for b in run]
            h = (t.commit_group_fast(run, tss, deferred=True) if k >= 2
                 else t.commit_fast_deferred(run[0], tss[0]))
            assert h is not None
            inflight.append(h)
            for b, ts in zip(run, tss):
                twin.prepare("create_transfers", len(b), 0)
                assert twin.commit_batch("create_transfers", b, ts) == []
            if len(inflight) == 2:
                assert all(r == [] for r in inflight.pop(0).resolve())
            if step % 7 == 6:
                # A query and a blocking commit join the lane first.
                for h in inflight:
                    assert all(r == [] for r in h.resolve())
                inflight.clear()
                assert t.lookup_transfers([100_000]).tobytes() == \
                    twin.lookup_transfers([100_000]).tobytes()
                b = batch(next_id, 5)
                next_id += 5
                assert t.create_transfers(b) == twin.create_transfers(b)
        for h in inflight:
            assert all(r == [] for r in h.resolve())
    finally:
        sys.setswitchinterval(old)
    assert t._deferred_inflight == 0
    assert t._transfers_bound == twin._transfers_bound
    assert (t.prepare_timestamp, t.commit_timestamp) == (
        twin.prepare_timestamp, twin.commit_timestamp)
    assert_ledgers_equal(convert.ledger_to_numpy(t.ledger),
                         convert.ledger_to_numpy(twin.ledger))
