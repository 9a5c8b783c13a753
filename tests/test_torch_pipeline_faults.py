"""The commit pipeline's fault funnels on the port against the JAX package's
on the CPU: tests/test_scrub.py's ``test_deferred_group_fault_recovered_
across_handles`` and ``test_consecutive_faults_degrade_to_host_engine``,
and tests/test_merkle.py's ``test_deferred_and_grouped_paths`` and
``test_deferred_dispatch_fault_escalates_not_crashes``, each with a port
machine beside a JAX machine: the same results, the same recoveries, equal
ledgers and roots.  Faults are injected with ``inject_device_faults``,
which raises at a read-back as a failed dispatch would."""

import pytest

from torch_fault_domain import (
    CFG, LANES, accounts_batch, plain_batch, assert_ledgers_equal,
)

import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu.machine import TpuStateMachine
from tigerbeetle_tpu.ops import merkle as jmk
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.host_engine import engine_available
from tigerbeetle_tpu_torch.machine import DeviceCommitHandle, TorchStateMachine
from tigerbeetle_tpu_torch.ops import merkle as mk
from tigerbeetle_tpu_torch.ops.scrub import (
    DeviceStateUnrecoverable, SimulatedDeviceFault,
)


def machine(cls, scrub_interval=0, merkle=False, paranoid=None,
            group=None):
    kw = {"device": "cpu"} if cls is TorchStateMachine else {}
    m = cls(CFG, batch_lanes=LANES, **kw)
    m.retry_tick_s = 0
    m.scrub_interval = scrub_interval
    if group is not None:
        m.group_device_commit = group
    if merkle:
        m.merkle_enabled = True
        m.scrub_paranoid = paranoid
    assert m.create_accounts(accounts_batch(), wall_clock_ns=1000) == []
    if scrub_interval:
        assert m.scrub_arm()
    return m


def both(**kw):
    return machine(TorchStateMachine, **kw), machine(TpuStateMachine, **kw)


def assert_same(t, j):
    assert_ledgers_equal(convert.ledger_to_numpy(t.ledger),
                         convert.ledger_arrays(j.ledger))
    assert t.digest() == j.digest()
    assert t.balances_snapshot() == j.balances_snapshot()


# -- tests/test_scrub.py ---------------------------------------------------------------


def test_deferred_group_fault_recovered_across_handles():
    """A failed dispatch with TWO runs in flight: both resolve with results
    identical to the blocking twin's (FIFO recovery), in both packages."""
    t, j = both(scrub_interval=8, group=True)
    twin = machine(TorchStateMachine, group=True)
    out = {}
    for m in (t, j):
        batches = [plain_batch(2000, 8), plain_batch(3000, 8)]
        tss = [m.prepare("create_transfers", 8, 0) for _ in batches]
        m.inject_device_faults(1)
        h1 = m.commit_group_fast(batches, tss, deferred=True)
        assert h1 is not None and type(h1).__name__ == "DeviceCommitHandle"
        b4 = plain_batch(4000, 5)
        h2 = m.commit_fast_deferred(b4, m.prepare("create_transfers", 5, 0))
        out[m] = (h1.resolve(), h2.resolve())
        assert m.device_recoveries >= 1
    assert out[t] == out[j]
    batches = [plain_batch(2000, 8), plain_batch(3000, 8)]
    tss = [twin.prepare("create_transfers", 8, 0) for _ in batches]
    rt = twin.commit_group_fast(batches, tss)
    rt4 = twin.commit_batch("create_transfers", plain_batch(4000, 5),
                            twin.prepare("create_transfers", 5, 0))
    assert out[t] == (rt, [rt4])
    assert t.device_recoveries == j.device_recoveries
    assert t.digest() == twin.digest()
    assert_same(t, j)
    assert t.scrub_check() is True and j.scrub_check() is True


@pytest.mark.skipif(not engine_available(), reason="no native engine")
@pytest.mark.parametrize("deferred", [False, True])
def test_consecutive_faults_degrade_to_host_engine(deferred):
    """device_fault_limit consecutive failures degrade to the native host
    engine (a RuntimeWarning), which then commits, value-identical, with
    the fault domain disarmed: a blocking commit, or a deferred one whose
    resolve fails and whose re-commits fail again."""
    clean = machine(TorchStateMachine)
    t, j = both(scrub_interval=8)
    for m in (t, j):
        m.inject_device_faults(50)  # every re-dispatch fails too
        with pytest.warns(RuntimeWarning, match="degraded to the native"):
            if deferred and m is t:
                h = m.commit_fast_deferred(
                    plain_batch(1000, 20),
                    m.prepare("create_transfers", 20, 0))
                assert isinstance(h, DeviceCommitHandle)
                assert h.resolve() == [[]]
            else:
                assert m.create_transfers(plain_batch(1000, 20)) == []
        assert m.degraded_to_host_engine and m._engine is not None
        assert not m.scrub_armed
        assert m.create_transfers(plain_batch(2000, 6)) == []
        m._injected_device_faults = 0
    clean.create_transfers(plain_batch(1000, 20))
    clean.create_transfers(plain_batch(2000, 6))
    assert t.balances_snapshot() == clean.balances_snapshot() == \
        j.balances_snapshot()
    assert t.digest() == clean.digest() == j.digest()
    # The engine's tables equal the JAX engine's, slot for slot.
    for name in ("accounts", "transfers"):
        assert getattr(t._host_led, name).rows.tobytes() == \
            getattr(j._host_led, name).rows.tobytes()
    # Deferred entry points decline on the engine; commits go through it.
    assert t.commit_fast_deferred(plain_batch(3000, 4),
                                  t.prepare("create_transfers", 4, 0)) is None


def test_deferred_fault_with_the_fault_domain_off_reraises():
    """Fault domain off: a deferred dispatch's failure propagates untouched
    at resolve, as the blocking path's does."""
    for m in both():
        h = m.commit_fast_deferred(plain_batch(1000, 8),
                                   m.prepare("create_transfers", 8, 0))
        m.inject_device_faults(1)
        with pytest.raises(Exception) as err:  # each package's own class
            h.resolve()
        assert type(err.value).__name__ == SimulatedDeviceFault.__name__


def test_lane_error_surfaces_at_resolve_and_recovers(monkeypatch):
    """An error raised ON the dispatch lane (a kernel failure, not a
    read-back) surfaces at the handle's resolve through the same funnel: the
    mirror-armed machine re-commits the run and its results equal a clean
    twin's."""
    from tigerbeetle_tpu_torch.ops import state_machine as sm

    t = machine(TorchStateMachine, scrub_interval=8)
    twin = machine(TorchStateMachine)
    real = sm.create_transfers_fast_probed
    calls = []

    def failing(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise SimulatedDeviceFault("lane fault")
        return real(*a, **k)

    monkeypatch.setattr(sm, "create_transfers_fast_probed", failing)
    b = plain_batch(1000, 16)
    h = t.commit_fast_deferred(b, t.prepare("create_transfers", 16, 0))
    assert h.resolve() == [twin.create_transfers(b)]
    assert t.device_recoveries == 1
    assert t.digest() == twin.digest()


# -- tests/test_merkle.py --------------------------------------------------------------


def test_deferred_and_grouped_paths():
    """The commitment update rides the dispatch-lane closures: deferred
    single batches and grouped runs keep the maintained roots exact, and
    equal to the JAX machine's."""
    t = TorchStateMachine(CFG, batch_lanes=LANES, device="cpu")
    j = TpuStateMachine(CFG, batch_lanes=LANES)
    for m in (t, j):
        m.retry_tick_s = 0
        m.scrub_interval = 4
        m.merkle_enabled = True
        m.scrub_paranoid = False
        assert m.scrub_arm()
        m.create_accounts(accounts_batch(), wall_clock_ns=1000)
        handles = []
        for g in range(3):
            b = plain_batch(20_000 + g * 100, 24)
            h = m.commit_fast_deferred(b, m.prepare("create_transfers",
                                                    len(b)))
            assert h is not None
            handles.append(h)
        for h in handles:
            h.resolve()
        m.group_device_commit = True
        batches = [plain_batch(30_000 + k * 100, 16) for k in range(3)]
        tss = [m.prepare("create_transfers", 16) for _ in range(3)]
        assert m.commit_group_fast(batches, tss) is not None
        assert m.scrub_check() is True
    assert t.merkle_roots() == mk.np_ledger_roots(t.ledger) == \
        j.merkle_roots() == jmk.np_ledger_roots(j.ledger)
    assert t.commitment_root() == j.commitment_root()
    assert_same(t, j)


@pytest.mark.parametrize("merkle_async", [False, True])
def test_deferred_paths_under_the_commitment_lane(merkle_async):
    """With TB_MERKLE_ASYNC the deferred and grouped commits queue their
    touch records instead; the settle after the resolves gives the same
    roots as the JAX machine's."""
    t = TorchStateMachine(CFG, batch_lanes=LANES, device="cpu")
    j = TpuStateMachine(CFG, batch_lanes=LANES)
    for m in (t, j):
        m.retry_tick_s = 0
        m.scrub_interval = 64
        m.merkle_enabled = True
        m.scrub_paranoid = False
        m.merkle_async = merkle_async
        m.group_device_commit = True
        assert m.scrub_arm()
        m.create_accounts(accounts_batch(), wall_clock_ns=1000)
        batches = [plain_batch(40_000 + k * 100, 12) for k in range(4)]
        tss = [m.prepare("create_transfers", 12) for _ in batches]
        h = m.commit_group_fast(batches, tss, deferred=True)
        h2 = m.commit_fast_deferred(plain_batch(50_000, 9),
                                    m.prepare("create_transfers", 9))
        queued = [op for op, _b in m._merkle_pending
                  if op == "create_transfers"]
        assert len(queued) == (5 if merkle_async else 0)
        h.resolve()
        h2.resolve()
    assert t.merkle_roots() == j.merkle_roots()
    assert t.merkle_roots() == mk.np_ledger_roots(t.ledger)
    assert_same(t, j)


def test_deferred_dispatch_fault_escalates_not_crashes():
    """Merkle-only mode has no mirror to re-commit from: a device fault at a
    deferred handle's resolve escalates as DeviceStateUnrecoverable (the
    replica's checkpoint + WAL replay), never the raw device error."""
    for m in both(scrub_interval=4, merkle=True, paranoid=False):
        assert m._scrub_mirror is None
        b = plain_batch(70_000, 16)
        h = m.commit_fast_deferred(b, m.prepare("create_transfers", len(b)))
        assert h is not None
        m.inject_device_faults(1)  # fires at the deferred codes read-back
        with pytest.raises(Exception) as err:  # each package's own class
            h.resolve()
        assert type(err.value).__name__ == DeviceStateUnrecoverable.__name__


def test_recovery_failure_quiesces_and_releases_every_handle(monkeypatch):
    """A recovery that itself fails (the re-commit escalates) leaves no
    handle dangling: every staging set goes back to the pool."""
    m = machine(TorchStateMachine, scrub_interval=8, group=True)
    batches = [plain_batch(2000, 8), plain_batch(3000, 8)]
    tss = [m.prepare("create_transfers", 8, 0) for _ in batches]
    h1 = m.commit_group_fast(batches, tss, deferred=True)
    h2 = m.commit_fast_deferred(plain_batch(4000, 5),
                                m.prepare("create_transfers", 5, 0))

    def broken():
        raise DeviceStateUnrecoverable("mirror unavailable or suspect")

    monkeypatch.setattr(m, "_rematerialize_from_mirror", broken)
    m.inject_device_faults(1)
    with pytest.raises(DeviceStateUnrecoverable):
        h1.resolve()
    assert m._inflight_handles == []
    assert h1._stage is None and h2._stage is None
    # Both sets went back to the (quarantined, then refilled) pool.
    assert sum(len(p) for p in m._stage_pool.values()) == 2


# -- the port's own routes: kernel failures and a lost CUDA context -------------------


@pytest.mark.parametrize("deferred", [False, True])
def test_port_kernel_failure_raises_and_never_degrades(monkeypatch, deferred):
    """A failure of the port's own kernels (``CudaKernelError``: a launch, a
    graph capture or replay) on a mirror-armed machine is re-dispatched on
    the device from the mirror and, at ``device_fault_limit``, raises: it
    never moves the work to the host engine."""
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import state_machine as sm

    t = machine(TorchStateMachine, scrub_interval=8)
    clean = machine(TorchStateMachine)
    b = plain_batch(1000, 20)

    def failing(*a, **k):
        raise _cuda.CudaKernelError("probe: an illegal memory access")

    with monkeypatch.context() as patch:
        patch.setattr(sm, "create_transfers_fast", failing)
        patch.setattr(sm, "create_transfers_fast_probed", failing)
        with pytest.raises(_cuda.CudaKernelError, match="probe"):
            if deferred:
                t.commit_fast_deferred(
                    b, t.prepare("create_transfers", 20, 0)).resolve()
            else:
                t.create_transfers(b)
    assert not t.degraded_to_host_engine and t._engine is None
    assert t.scrub_armed
    # Re-dispatched on the device between the failures (the deferred
    # route's first failure is the resolve's, whose recovery did not end).
    assert t.device_recoveries == (1 if deferred
                                   else t.device_fault_limit - 1)
    # The device path still serves once the kernel launches again.
    assert t.create_transfers(b) == clean.create_transfers(b)
    assert t.digest() == clean.digest()
    assert t.scrub_check() is True


@pytest.mark.skipif(not engine_available(), reason="no native engine")
@pytest.mark.parametrize("deferred", [False, True])
def test_lost_context_degrades_with_nothing_on_the_device(monkeypatch,
                                                           deferred):
    """A CUDA error that kills the context (``torch.AcceleratorError``;
    every later device allocation then fails, simulated by making them
    raise): the first fault degrades to the host engine at once, nothing on
    the way touches the device, and the engine commits the batch and the
    next ones as a clean twin's device path does."""
    import torch

    t = machine(TorchStateMachine, scrub_interval=8)
    clean = machine(TorchStateMachine)
    b1, b2 = plain_batch(1000, 20), plain_batch(2000, 6)
    if deferred:
        h = t.commit_fast_deferred(b1, t.prepare("create_transfers", 20, 0))
        t._lane_join()  # the dispatch ran; its read-back is what fails
    dead = torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered")

    def fail(*a, **k):
        raise dead

    with monkeypatch.context() as patch:
        for name in ("zeros", "empty", "arange", "full", "ones", "tensor",
                     "as_tensor", "from_numpy"):
            patch.setattr(torch, name, fail)
        patch.setattr(t, "_d2h_codes", fail)
        with pytest.warns(RuntimeWarning, match="degraded to the native"):
            got = h.resolve() if deferred else [t.create_transfers(b1)]
        assert t.degraded_to_host_engine and t._engine is not None
        assert t.device_recoveries == (1 if deferred else 0)
        got.append(t.create_transfers(b2))
    assert got == [clean.create_transfers(b1), clean.create_transfers(b2)]
    assert t.balances_snapshot() == clean.balances_snapshot()
    assert t.digest() == clean.digest()
