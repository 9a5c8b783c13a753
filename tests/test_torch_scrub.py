"""The port's device fault domain (``tigerbeetle_tpu_torch/ops/scrub.py``
and the machine's scrub, retry and recovery) against the JAX package's on
the CPU, exactly (u64 digests and ledger arrays, so the tolerance is zero).

- ops: ``scrub_digest`` against the JAX function, ``model_from_ledger``'s
  mirror and ``mirror_digests``, and ``materialize_ledger``'s rebuilt
  ledger (every array: the slots are the reference's) on ledgers left by
  the port's fast, general, sequential and tiered routes.
- machine: a port and a JAX machine in mirror mode at scrub interval 1
  through an SDC flip, its detection and the re-materialization: the same
  counters and the same ledger, array for array.
- the device-fault family: injected faults, ``CudaKernelError`` and
  ``torch.AcceleratorError`` are retried; a bare ``RuntimeError`` is not.
- the cases of tests/test_scrub.py's ``TestScrubDigest``,
  ``TestSdcRecovery`` and ``TestDispatchRetry`` (blocking), restated
  against the port with the same seeds.

On the CPU the port runs the plain version of kernel K21; the kernel is
held against it on the card (tests/test_torch_kernels.py and
chip_smoke.py)."""

import random

import numpy as np
import pytest
import torch

from torch_fault_domain import (
    CFG, LANES, N_ACCOUNTS, ROUTES, assert_ledgers_equal, jax_ledger,
    route_states,
)

from tigerbeetle_tpu import types
from tigerbeetle_tpu.machine import TpuStateMachine
from tigerbeetle_tpu.ops import scrub as jscrub
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.machine import TorchStateMachine
from tigerbeetle_tpu_torch.ops import _cuda
from tigerbeetle_tpu_torch.ops import scrub as scrub_ops
from tigerbeetle_tpu_torch.ops import state_machine as sm
from tigerbeetle_tpu_torch.testing import model as M

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def states():
    return {route: route_states(route) for route in ROUTES}


# -- ops ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES)
def test_scrub_digest_matches_jax(states, route):
    _before, after, _batch, _cold = states[route]
    tled = convert.ledger_from_numpy(after, CPU)
    got = convert.tensor_to_array(scrub_ops.scrub_digest(tled))
    want = np.asarray(jscrub.scrub_digest(jax_ledger(after)))
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    # The accounts fold is the checkpoint digest (K5's).
    assert int(got[0]) == convert.tensor_to_array(
        sm.ledger_digest(tled).reshape(1))[0]
    if route == "general":
        assert got[2] != 0  # the posted pad carries weight


@pytest.mark.parametrize("route", ROUTES)
def test_mirror_from_ledger_matches_jax(states, route):
    """model_from_ledger seeds the same mirror (cold runs included), and
    mirror_digests gives the device folds (the transfers fold only while
    nothing is cold)."""
    _before, after, _batch, cold = states[route]
    tled = convert.ledger_from_numpy(after, CPU)
    tm = scrub_ops.model_from_ledger(tled, cold_rows=cold,
                                     prepare_timestamp=5, commit_timestamp=4)
    jm = jscrub.model_from_ledger(jax_ledger(after), cold_rows=cold,
                                  prepare_timestamp=5, commit_timestamp=4)
    assert tm.balances_snapshot() == jm.balances_snapshot()
    assert {k: vars(v) for k, v in tm.transfers.items()} == \
        {k: vars(v) for k, v in jm.transfers.items()}
    assert tm.posted == jm.posted and tm.history == jm.history
    assert (tm.prepare_timestamp, tm.commit_timestamp) == (5, 4)
    want = scrub_ops.mirror_digests(tm)
    assert want == jscrub.mirror_digests(jm)
    got = convert.tensor_to_array(scrub_ops.scrub_digest(tled))
    assert (int(got[0]), int(got[2])) == (want[0], want[2])
    assert (int(got[1]) == want[1]) == (not cold)


@pytest.mark.parametrize("route", ROUTES)
def test_materialize_ledger_matches_jax(states, route):
    """The re-materialized ledger, array for array: the keys go in the
    reference's order, so every slot (and with it every Merkle leaf)
    equals the JAX machine's after a recovery."""
    _before, after, _batch, cold = states[route]
    model = scrub_ops.model_from_ledger(convert.ledger_from_numpy(after, CPU),
                                        cold_rows=cold)
    got = convert.ledger_to_numpy(
        scrub_ops.materialize_ledger(model, CFG, CPU))
    want = convert.ledger_arrays(jscrub.materialize_ledger(model, CFG))
    assert_ledgers_equal(got, want)


def test_numpy_twins_match_jax():
    rng = np.random.default_rng(9)
    lo = rng.integers(0, 1 << 64, 500, dtype=np.uint64)
    hi = rng.integers(0, 1 << 64, 500, dtype=np.uint64)
    np.testing.assert_array_equal(scrub_ops.mix64_np(lo, hi),
                                  jscrub.mix64_np(lo, hi))
    assert scrub_ops._wrap_sum(lo) == jscrub._wrap_sum(lo)


# -- machines ----------------------------------------------------------------------


def accounts_batch():
    return types.accounts_array([
        types.account(id=i + 1, ledger=1, code=10)
        for i in range(N_ACCOUNTS)
    ])


def batch(first_id, n, flags=0):
    return types.transfers_array([
        types.transfer(
            id=first_id + i, debit_account_id=1 + i % N_ACCOUNTS,
            credit_account_id=1 + (i + 3) % N_ACCOUNTS,
            amount=3 + i % 5, ledger=1, code=10, flags=flags,
        )
        for i in range(n)
    ])


def pending_post_batch(first_id, n):
    rows = []
    for i in range(n // 2):
        rows.append(types.transfer(
            id=first_id + i, debit_account_id=1 + i % N_ACCOUNTS,
            credit_account_id=1 + (i + 5) % N_ACCOUNTS, amount=2,
            ledger=1, code=10, flags=int(types.TransferFlags.PENDING),
        ))
    for i in range(n // 2):
        rows.append(types.transfer(
            id=first_id + 1000 + i, pending_id=first_id + i,
            ledger=1, code=10,
            flags=int(types.TransferFlags.POST_PENDING_TRANSFER),
        ))
    return types.transfers_array(rows)


def make_machine(scrub_interval=0, cls=TorchStateMachine):
    kw = {"device": "cpu"} if cls is TorchStateMachine else {}
    m = cls(CFG, batch_lanes=LANES, **kw)
    m.retry_tick_s = 0
    m.scrub_interval = scrub_interval
    assert m.create_accounts(accounts_batch(), wall_clock_ns=1000) == []
    if scrub_interval:
        assert m.scrub_arm()
    return m


def test_mirror_mode_recovery_matches_jax():
    """Interval 1, mirror mode: the same flip is caught before the next
    commit in both packages, and the re-materialized ledgers, and every
    ledger after, are equal array for array."""
    t = make_machine(1)
    j = make_machine(1, cls=TpuStateMachine)
    for k, b in enumerate([batch(1000, 20), pending_post_batch(4000, 10),
                           batch(6000, 7), batch(7000, 30)]):
        if k == 2:
            assert t.inject_sdc_bitflip(random.Random(3))
            assert j.inject_sdc_bitflip(random.Random(3))
        assert t.create_transfers(b) == j.create_transfers(b)
        assert_ledgers_equal(convert.ledger_to_numpy(t.ledger),
                             convert.ledger_arrays(j.ledger))
    for name in ("scrub_checks", "scrub_mismatches", "device_recoveries"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.device_recoveries == 1 and t.digest() == j.digest()


@pytest.mark.parametrize("kind", ["injected", "kernel", "accelerator"])
def test_device_fault_family_is_retried(monkeypatch, kind):
    """Each member of DEVICE_FAULT_TYPES raised by a commit is retried after
    a rebuild from the mirror; the result equals an unfaulted twin's."""
    clean = make_machine()
    faulted = make_machine(scrub_interval=8)
    b = batch(1000, 20)
    assert clean.create_transfers(b) == []
    if kind == "injected":
        faulted.inject_device_faults(1)
    else:
        err = (_cuda.CudaKernelError("CUDA kernel probe failed: error 700")
               if kind == "kernel" else torch.AcceleratorError("lost device"))
        real = sm.create_transfers_fast
        calls = []

        def once(*args, **kwargs):
            calls.append(1)
            if len(calls) == 1:
                raise err
            return real(*args, **kwargs)

        monkeypatch.setattr(sm, "create_transfers_fast", once)
    assert faulted.create_transfers(b) == []
    assert faulted.device_recoveries == 1
    assert faulted.digest() == clean.digest()
    assert issubclass(_cuda.CudaKernelError, RuntimeError)


def test_bare_runtime_error_is_not_a_device_fault(monkeypatch):
    """The machine's own integrity errors must not route into retry."""
    m = make_machine(scrub_interval=8)

    def broken(*args, **kwargs):
        raise RuntimeError("transfers probe overflow during fast insert")

    monkeypatch.setattr(sm, "create_transfers_fast", broken)
    with pytest.raises(RuntimeError, match="probe overflow"):
        m.create_transfers(batch(1000, 8))
    assert m.device_recoveries == 0
    assert RuntimeError not in scrub_ops.DEVICE_FAULT_TYPES


def test_consecutive_faults_name_the_missing_host_engine():
    """device_fault_limit consecutive faults: the port degrades to the host
    engine, as the reference does (a RuntimeWarning naming it), and the
    engine commits the batch."""
    m = make_machine(scrub_interval=8)
    m.inject_device_faults(m.device_fault_limit)
    with pytest.warns(RuntimeWarning, match="degraded to the native host"):
        assert m.create_transfers(batch(1000, 8)) == []
    assert m.degraded_to_host_engine and m._engine is not None


# -- tests/test_scrub.py restated against the port -------------------------------


class TestScrubDigest:
    def test_mirror_digests_match_device_on_clean_stream(self):
        m = make_machine(scrub_interval=8)
        assert m.create_transfers(batch(1000, 20)) == []
        assert m.create_transfers(pending_post_batch(5000, 12)) == []
        got = convert.tensor_to_array(scrub_ops.scrub_digest(m.ledger))
        want = scrub_ops.mirror_digests(m._scrub_mirror)
        assert (int(got[0]), int(got[1]), int(got[2])) == want
        assert int(got[0]) == m.digest()
        assert m.scrub_check() is True
        assert m.scrub_mismatches == 0


class TestSdcRecovery:
    def test_bitflip_detected_and_recovered_identical(self):
        clean = make_machine()
        faulted = make_machine(scrub_interval=1)
        streams = [batch(1000, 20), batch(2000, 12), batch(3000, 9)]
        for k, b in enumerate(streams):
            if k == 1:
                assert faulted.inject_sdc_bitflip(random.Random(7))
            assert clean.create_transfers(b) == []
            assert faulted.create_transfers(b) == []
        assert faulted.scrub_mismatches == 1
        assert faulted.device_recoveries == 1
        assert faulted.scrub_check() is True
        assert faulted.digest() == clean.digest()
        assert faulted.balances_snapshot() == clean.balances_snapshot()

    def test_unscrubbed_bitflip_diverges(self):
        clean = make_machine()
        faulted = make_machine()  # fault domain OFF
        for k, b in enumerate([batch(1000, 20), batch(2000, 12)]):
            if k == 1:
                assert faulted.inject_sdc_bitflip(random.Random(7))
            clean.create_transfers(b)
            faulted.create_transfers(b)
        assert faulted.digest() != clean.digest()

    def test_recovery_matches_scalar_oracle(self):
        ref = M.ReferenceStateMachine()
        assert ref.create_accounts(
            [M.account_from_row(r) for r in accounts_batch()], 1000
        ) == []
        m = make_machine(scrub_interval=1)
        for k, b in enumerate(
            [batch(1000, 20), pending_post_batch(4000, 10), batch(6000, 7)]
        ):
            if k == 2:
                assert m.inject_sdc_bitflip(random.Random(3))
            ts = m.prepare("create_transfers", len(b), 0)
            got = m.commit_batch("create_transfers", b, ts)
            want = ref.create_transfers([M.transfer_from_row(r) for r in b])
            assert got == want, k
        assert m.device_recoveries == 1
        assert m.balances_snapshot() == ref.balances_snapshot()


class TestDispatchRetry:
    def test_blocking_fault_retried_identical(self):
        clean = make_machine()
        faulted = make_machine(scrub_interval=8)
        for k, b in enumerate([batch(1000, 20), batch(2000, 12)]):
            if k == 1:
                faulted.inject_device_faults(1)
            assert clean.create_transfers(b) == []
            assert faulted.create_transfers(b) == []
        assert faulted.device_recoveries == 1
        assert faulted.digest() == clean.digest()

    def test_unrecoverable_without_mirror_reraises(self):
        m = make_machine()  # no scrub -> no mirror
        m.inject_device_faults(1)
        with pytest.raises(scrub_ops.SimulatedDeviceFault):
            m.create_transfers(batch(1000, 8))
