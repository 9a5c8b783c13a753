"""TorchStateMachine (the port's host seam) against TpuStateMachine and the
scalar oracle, on the fast path, the general kernel (with its FLAG_SEQ
re-routes, its growth retry and TB_WAVES) and the sequential path, plus the
port's boundaries: no JAX import, copied modules kept equal to their
sources, the device default, and every route not ported yet raising
NotImplementedError."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu import types
from tigerbeetle_tpu.config import LedgerConfig
from tigerbeetle_tpu.machine import TpuStateMachine
from tigerbeetle_tpu.testing import model as M
from tigerbeetle_tpu.testing.workload import WorkloadGen
from tigerbeetle_tpu.types import AccountFlags, TransferFlags as F
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.machine import TorchStateMachine
from tigerbeetle_tpu_torch.ops import state_machine as tsm
from tigerbeetle_tpu_torch.ops import transfer_full as tf
from tigerbeetle_tpu_torch.testing import fullmix, seqmix
from tigerbeetle_tpu_torch.utils.benchgen import gen_batch_np, gen_two_phase_np

ROOT = Path(__file__).resolve().parents[1]
CFG = LedgerConfig(accounts_capacity_log2=10, transfers_capacity_log2=10,
                   posted_capacity_log2=10, history_capacity_log2=10)


def trio(batch_lanes=256):
    return (TorchStateMachine(CFG, batch_lanes=batch_lanes, device="cpu"),
            TpuStateMachine(CFG, batch_lanes=batch_lanes),
            M.ReferenceStateMachine())


def commit3(t, j, ref, op, batch, wall):
    got = getattr(t, op)(batch, wall_clock_ns=wall)
    rows = (M.accounts_from_batch if op == "create_accounts"
            else M.transfers_from_batch)(batch)
    want = getattr(ref, op)(rows, wall)
    assert got == want == getattr(j, op)(batch, wall_clock_ns=wall)
    return got


def assert_same_tables(t, j, tables=("accounts", "transfers")):
    want = convert.ledger_arrays(j.ledger)
    got = convert.ledger_to_numpy(t.ledger)
    for name in tables:
        for k in ("key_lo", "key_hi", "tombstone", "count", "probe_overflow"):
            np.testing.assert_array_equal(got[name][k], want[name][k],
                                          err_msg=f"{name}/{k}")
        for k in want[name]["cols"]:
            np.testing.assert_array_equal(got[name]["cols"][k],
                                          want[name]["cols"][k],
                                          err_msg=f"{name}/{k}")


def assert_same_ledger(t, j):
    """Every array of the accounts, transfers and posted tables and of the
    history log, and the history count."""
    assert_same_tables(t, j, ("accounts", "transfers", "posted"))
    want = convert.ledger_arrays(j.ledger)["history"]
    got = convert.ledger_to_numpy(t.ledger)["history"]
    np.testing.assert_array_equal(got["count"], want["count"])
    for k in want["cols"]:
        np.testing.assert_array_equal(got["cols"][k], want["cols"][k],
                                      err_msg=f"history/{k}")


def test_sequence_across_a_table_growth_matches_jax_and_oracle():
    t, j, ref = trio()
    gen = WorkloadGen(seed=21)
    commit3(t, j, ref, "create_accounts", gen.accounts_batch(24), 1_000)
    cap0 = t.ledger.transfers.capacity
    for i in range(5):
        batch = gen.transfers_batch(120, invalid_rate=0.2, dup_rate=0.1,
                                    pending_rate=0.2)
        commit3(t, j, ref, "create_transfers", batch, 10_000 * (i + 1))
    assert t.ledger.transfers.capacity > cap0  # crossed one growth
    assert t.ledger.transfers.capacity == j.ledger.transfers.capacity
    assert t.balances_snapshot() == ref.balances_snapshot() == j.balances_snapshot()
    assert t.digest() == j.digest()
    assert (t.prepare_timestamp, t.commit_timestamp) == (
        j.prepare_timestamp, j.commit_timestamp)
    assert_same_tables(t, j)
    ids = gen.transfer_ids[:40] + [123456789]
    got = t.lookup_transfers(ids)
    assert [M.transfer_from_row(r) for r in got] == ref.lookup_transfers(ids)
    np.testing.assert_array_equal(got, j.lookup_transfers(ids))
    np.testing.assert_array_equal(t.lookup_accounts(gen.account_ids + [0]),
                                  j.lookup_accounts(gen.account_ids + [0]))


def test_bench_parity_check_shape():
    """bench.run_parity_check's shape: 64 accounts, three 200-transfer
    batches of the flagship generator."""
    cfg = LedgerConfig(accounts_capacity_log2=10, transfers_capacity_log2=11,
                       posted_capacity_log2=10)
    t = TorchStateMachine(cfg, batch_lanes=256, device="cpu")
    ref = M.ReferenceStateMachine()
    accounts = types.accounts_array(
        [types.account(id=i + 1, ledger=1, code=10) for i in range(64)])
    assert t.create_accounts(accounts, wall_clock_ns=1) == ref.create_accounts(
        M.accounts_from_batch(accounts), 1)
    for b in range(3):
        batch = gen_batch_np(b, 200, 200, 64, 1 << 32)
        assert t.create_transfers(batch) == ref.create_transfers(
            M.transfers_from_batch(batch))
    assert t.balances_snapshot() == ref.balances_snapshot()


def test_benchgen_is_bench_py_generator():
    sys.path.insert(0, str(ROOT))
    import bench

    for b in (0, 7):
        np.testing.assert_array_equal(gen_batch_np(b, 512, 500, 100, 1 << 32),
                                      bench.gen_batch_np(b, 512, 500, 100, 1 << 32))


def test_two_phase_generator_is_bench_py_shape():
    """gen_two_phase_np: the pendings carry the flagship mix's accounts and
    amounts (bench.py's shared mix_workload), each post names the pending
    of its lane, and the batches commit with no failure on the sequential
    path of both machines."""
    for b in (0, 5):
        two = gen_two_phase_np(b, 256, 201, 100, 1 << 32)
        plain = gen_batch_np(b, 256, 201, 100, 1 << 32)
        assert len(two) == 200
        pend, post = two[:100], two[100:]
        for k in ("debit_account_id_lo", "credit_account_id_lo", "amount_lo",
                  "id_lo"):
            np.testing.assert_array_equal(pend[k], plain[k][:100])
        assert (pend["flags"] == F.PENDING).all()
        assert (post["flags"] == F.POST_PENDING_TRANSFER).all()
        np.testing.assert_array_equal(post["pending_id_lo"], pend["id_lo"])
        np.testing.assert_array_equal(post["id_lo"], plain["id_lo"][100:200])
        assert not post["amount_lo"].any() and not post["ledger"].any()
    t, j, ref = seq_trio(batch_lanes=256)
    commit3(t, j, ref, "create_accounts", types.accounts_array(
        [types.account(id=i, ledger=1, code=10) for i in range(1, 101)]), 10)
    for b in range(2):
        assert commit3(t, j, ref, "create_transfers",
                       gen_two_phase_np(b, 256, 200, 100, 1 << 32),
                       10 ** 6 * (b + 1)) == []
    assert_same_ledger(t, j)
    assert int(t.ledger.posted.count) == 200


def test_commit_batch_replay_and_linked_accounts():
    t, j, ref = trio()
    rows = [types.account(id=i + 1, ledger=1, code=10,
                          flags=AccountFlags.LINKED if i % 3 else 0)
            for i in range(9)]
    rows[4] = types.account(id=5, ledger=0, code=10, flags=AccountFlags.LINKED)
    batch = types.accounts_array(rows)
    ts = 5_000
    assert t.commit_batch("create_accounts", batch, ts) == j.commit_batch(
        "create_accounts", batch, ts)
    assert t.prepare_timestamp == j.prepare_timestamp == ts
    tb = types.transfers_array([types.transfer(
        id=1, debit_account_id=1, credit_account_id=4, amount=3, ledger=1,
        code=1)])
    assert t.commit_batch("create_transfers", tb, ts + 1) == j.commit_batch(
        "create_transfers", tb, ts + 1)
    assert t.balances_snapshot() == j.balances_snapshot()
    with pytest.raises(ValueError):
        t.commit_batch("lookup_accounts", batch, ts + 2)


def test_state_carried_from_the_jax_machine_commits_identically():
    """A ledger converted from the JAX package's state continues in step."""
    t, j, ref = trio()
    gen = WorkloadGen(seed=5)
    commit3(t, j, ref, "create_accounts", gen.accounts_batch(16), 100)
    commit3(t, j, ref, "create_transfers", gen.transfers_batch(60), 200)
    t.ledger = convert.ledger_from_numpy(convert.ledger_arrays(j.ledger), "cpu")
    commit3(t, j, ref, "create_transfers", gen.transfers_batch(60), 300)
    assert_same_tables(t, j)


def _transfer(**kw):
    base = dict(id=1, debit_account_id=1, credit_account_id=2, amount=1,
                ledger=1, code=1)
    base.update(kw)
    return types.transfers_array([types.transfer(**base)])


UNPORTED_BATCHES = {
    "post_pending": _transfer(flags=F.POST_PENDING_TRANSFER, pending_id=9),
    "void_pending": _transfer(flags=F.VOID_PENDING_TRANSFER, pending_id=9),
    "balancing_debit": _transfer(flags=F.BALANCING_DEBIT),
    "balancing_credit": _transfer(flags=F.BALANCING_CREDIT),
    "linked_transfers": _transfer(flags=F.LINKED),
    "u128_amount": _transfer(amount=1 << 64),
}


@pytest.mark.parametrize("route", sorted(UNPORTED_BATCHES))
def test_batches_the_fast_path_refuses_raise(route):
    """These batches raised before the general kernel was ported; now the
    default machine commits each of them as the JAX machine does (general
    kernel, or its FLAG_SEQ re-route), table for table."""
    t, j, ref = trio(batch_lanes=64)
    commit3(t, j, ref, "create_accounts", types.accounts_array(
        [types.account(id=i, ledger=1, code=1) for i in (1, 2)]), 10)
    commit3(t, j, ref, "create_transfers", types.transfers_array([
        types.transfer(id=9, debit_account_id=2, credit_account_id=1,
                       amount=5, ledger=1, code=1, flags=F.PENDING)]), 20)
    commit3(t, j, ref, "create_transfers", UNPORTED_BATCHES[route], 30)
    assert_same_ledger(t, j)
    assert t.balances_snapshot() == ref.balances_snapshot()
    assert t.digest() == j.digest()


@pytest.mark.parametrize("flags", [AccountFlags.HISTORY,
                                   AccountFlags.DEBITS_MUST_NOT_EXCEED_CREDITS])
def test_history_and_limit_accounts_end_the_fast_path(flags):
    """Once a history or limit account exists, every create_transfers batch
    takes the general kernel, in both machines, with equal results and
    history rows."""
    t, j, ref = trio(batch_lanes=64)
    commit3(t, j, ref, "create_accounts", types.accounts_array(
        [types.account(id=1, ledger=1, code=1, flags=flags),
         types.account(id=2, ledger=1, code=1)]), 10)
    calls = []
    t._commit_fast = lambda *a: calls.append(a)
    commit3(t, j, ref, "create_transfers", types.transfers_array([
        types.transfer(id=10 + i, debit_account_id=2 - i % 2,
                       credit_account_id=1 + i % 2, amount=3 + i, ledger=1,
                       code=1) for i in range(6)]), 20)
    assert not calls
    assert_same_ledger(t, j)
    assert t.balances_snapshot() == ref.balances_snapshot()


def test_linked_accounts_with_duplicate_ids_raise():
    """Such a batch raised before the sequential path was ported; now both
    machines route it there (without force_sequential) and agree with the
    oracle, table for table."""
    t, j, ref = trio(batch_lanes=64)
    batch = types.accounts_array([
        types.account(id=1, ledger=1, code=1, flags=AccountFlags.LINKED),
        types.account(id=1, ledger=1, code=1),
        types.account(id=2, ledger=1, code=1, flags=AccountFlags.LINKED),
        types.account(id=3, ledger=0, code=1),
        types.account(id=2, ledger=1, code=1)])
    assert commit3(t, j, ref, "create_accounts", batch, 10) == [
        (0, 1), (1, 15), (2, 1), (3, 13)]
    assert_same_ledger(t, j)
    assert t.balances_snapshot() == ref.balances_snapshot()


# -- the sequential path (force_sequential) ------------------------------------

# Small posted and history capacities, so that both grow within a few batches.
CFG_SEQ = LedgerConfig(accounts_capacity_log2=10, transfers_capacity_log2=10,
                       posted_capacity_log2=6, history_capacity_log2=6)


def seq_trio(batch_lanes=128):
    return (TorchStateMachine(CFG_SEQ, batch_lanes=batch_lanes, device="cpu",
                              force_sequential=True),
            TpuStateMachine(CFG_SEQ, batch_lanes=batch_lanes,
                            force_sequential=True),
            M.ReferenceStateMachine())


def seq_accounts(n=10):
    """Accounts 1..n: 2 and 3 carry limits, 4 and 5 history."""
    flags = {2: AccountFlags.DEBITS_MUST_NOT_EXCEED_CREDITS,
             3: AccountFlags.CREDITS_MUST_NOT_EXCEED_DEBITS,
             4: AccountFlags.HISTORY,
             5: AccountFlags.HISTORY | AccountFlags.DEBITS_MUST_NOT_EXCEED_CREDITS}
    return types.accounts_array([
        types.account(id=i, ledger=1, code=10, flags=int(flags.get(i, 0)))
        for i in range(1, n + 1)])


def mixed_transfers(rng, n, n_accounts, state):
    """Plain, pending, post, void and balancing transfers, some linked, some
    re-using ids; ``state`` carries the next id and the pending pool."""
    rows = []
    for _ in range(n):
        state["next"] += 1
        tid = state["next"]
        if state["pool"] and rng.random() < 0.05:
            tid = int(rng.choice(state["pool"]))
        linked = int(F.LINKED) if rng.random() < 0.15 else 0
        dr, cr = (int(x) for x in rng.choice(range(1, n_accounts + 2), 2,
                                             replace=False))
        r = rng.random()
        if r < 0.3 and state["pool"]:
            kind = int(rng.choice([F.POST_PENDING_TRANSFER,
                                   F.VOID_PENDING_TRANSFER]))
            amount = int(rng.integers(0, 30)) if rng.random() < 0.3 else 0
            rows.append(types.transfer(id=tid, pending_id=int(rng.choice(
                state["pool"])), amount=amount, flags=kind | linked))
        elif r < 0.4:
            kind = int(rng.choice([F.BALANCING_DEBIT, F.BALANCING_CREDIT]))
            rows.append(types.transfer(
                id=tid, debit_account_id=dr, credit_account_id=cr,
                amount=int(rng.integers(0, 80)), ledger=1, code=10,
                flags=kind | linked))
        else:
            pending = int(F.PENDING) if rng.random() < 0.4 else 0
            rows.append(types.transfer(
                id=tid, debit_account_id=dr, credit_account_id=cr,
                amount=int(rng.integers(1, 60)), ledger=1, code=10,
                flags=pending | linked,
                timeout=int(rng.integers(0, 3)) if pending else 0))
            if pending:
                state["pool"].append(tid)
    return types.transfers_array(rows)


def test_force_sequential_matches_jax_and_oracle_across_growth():
    """Every kind of event through the sequential path on both machines and
    the oracle; every table array after each batch, while the transfers
    table, the posted table and the history log grow."""
    t, j, ref = seq_trio()
    commit3(t, j, ref, "create_accounts", seq_accounts(), 1_000)
    assert_same_ledger(t, j)
    commit3(t, j, ref, "create_transfers", types.transfers_array([
        types.transfer(id=1000 + i, debit_account_id=1, credit_account_id=i,
                       amount=400, ledger=1, code=10) for i in range(2, 11)]),
            2_000)
    rng = np.random.default_rng(8)
    state = {"next": 2_000, "pool": []}
    caps0 = (t.ledger.posted.capacity, t.ledger.history.capacity)
    for b in range(6):
        batch = mixed_transfers(rng, 100, 10, state)
        commit3(t, j, ref, "create_transfers", batch,
                10 ** 9 * (b + 2) + int(rng.integers(0, 10 ** 9)))
        assert_same_ledger(t, j)
    assert t.ledger.posted.capacity > caps0[0]
    assert t.ledger.history.capacity > caps0[1]
    assert int(t.ledger.history.count) == len(ref.history) > 0
    assert t.balances_snapshot() == ref.balances_snapshot() == j.balances_snapshot()
    assert t.digest() == j.digest()
    assert (t.prepare_timestamp, t.commit_timestamp) == (
        j.prepare_timestamp, j.commit_timestamp)
    ids = list(range(1000, 1011)) + list(range(2_000, state["next"] + 1))
    got = t.lookup_transfers(ids)
    assert [M.transfer_from_row(r) for r in got] == ref.lookup_transfers(ids)
    np.testing.assert_array_equal(got, j.lookup_transfers(ids))


def test_sequential_insert_at_the_probe_cap_raises():
    """No free slot within MAX_PROBE: the reference writes the row at slot
    0 and goes on; the port writes it there too, then raises."""
    t = TorchStateMachine(CFG_SEQ, batch_lanes=64, device="cpu",
                          force_sequential=True)
    t.create_accounts(seq_accounts(3))
    t.ledger.transfers.tombstone[:] = True
    with pytest.raises(RuntimeError, match="MAX_PROBE"):
        t.create_transfers(_transfer())
    assert int(t.ledger.transfers.key_lo[0]) == 1


def test_converted_ledger_with_pending_posted_and_history_continues():
    """A JAX ledger holding pending transfers, posted rows and history rows,
    converted to the port, commits the next batches identically."""
    t, j, ref = seq_trio()
    commit3(t, j, ref, "create_accounts", seq_accounts(), 1_000)
    rng = np.random.default_rng(12)
    state = {"next": 5_000, "pool": []}
    for b in range(2):
        commit3(t, j, ref, "create_transfers",
                mixed_transfers(rng, 60, 10, state), 10 ** 6 * (b + 2))
    led = convert.ledger_arrays(j.ledger)
    assert int(led["posted"]["count"]) > 0 and int(led["history"]["count"]) > 0
    t.ledger = convert.ledger_from_numpy(led, "cpu")
    for b in range(2):
        commit3(t, j, ref, "create_transfers",
                mixed_transfers(rng, 60, 10, state), 10 ** 7 * (b + 2))
        assert_same_ledger(t, j)
    assert t.balances_snapshot() == ref.balances_snapshot()


@pytest.mark.parametrize(
    "name", sorted(n for n in dir(TpuStateMachine) if not n.startswith("_")))
def test_every_public_reference_name_resolves_on_the_port(name):
    """Each public name of TpuStateMachine (read from the class) is on
    TorchStateMachine, and is of the same kind (a property there is a
    property here)."""
    assert hasattr(TorchStateMachine, name), name
    assert isinstance(getattr(TorchStateMachine, name), property) == \
        isinstance(getattr(TpuStateMachine, name), property), name


@pytest.fixture
def eight_cpu_shards():
    from tigerbeetle_tpu_torch import device as tdev

    tdev.force_virtual(8, "cpu")
    try:
        yield
    finally:
        tdev.force_virtual(0, "cpu")


@pytest.mark.parametrize("how", ["env", "argument"])
def test_tb_shards_engages_a_sharded_machine(monkeypatch, eight_cpu_shards,
                                             how):
    """TB_SHARDS asks for sharding when shards is not given, as in the
    reference (tests/test_sharded_machine.py:90): per-shard count vectors."""
    if how == "env":
        monkeypatch.setenv("TB_SHARDS", "2")
        t = TorchStateMachine(CFG, batch_lanes=64, device="cpu")
    else:
        monkeypatch.delenv("TB_SHARDS", raising=False)
        t = TorchStateMachine(CFG, batch_lanes=64, device="cpu", shards=2)
    assert t.shards == 2 and t._ledger_is_sharded
    assert tuple(t.ledger.accounts.count.shape) == (2,)
    assert t.create_accounts(types.accounts_array(
        [types.account(id=i + 1, ledger=1, code=10) for i in range(8)])) == []


@pytest.mark.parametrize("env,arg", [("0", None), (None, 0), ("2", 0),
                                     ("x", None)])
def test_shards_off_is_the_single_device_path(monkeypatch, eight_cpu_shards,
                                              env, arg):
    """TB_SHARDS=0, shards=0 (which overrides the env) and a non-digit
    TB_SHARDS leave the machine single-device: scalar counts, no mesh."""
    if env is None:
        monkeypatch.delenv("TB_SHARDS", raising=False)
    else:
        monkeypatch.setenv("TB_SHARDS", env)
    t = TorchStateMachine(CFG, batch_lanes=64, device="cpu", shards=arg)
    assert t.shards == 0 and t._shard_mesh is None
    assert not t._ledger_is_sharded and t.ledger.accounts.count.dim() == 0


def test_shards_above_the_devices_warn_and_run_single_device(monkeypatch):
    """More shards than ``device.devices()`` gives the reference's
    RuntimeWarning and a single-device machine on the same device
    (tigerbeetle_tpu/machine.py:360-368); so does host_engine with shards
    (:343-357)."""
    monkeypatch.delenv("TB_SHARDS", raising=False)
    with pytest.warns(RuntimeWarning, match="only 1 device"):
        t = TorchStateMachine(CFG, batch_lanes=64, device="cpu", shards=2)
    assert t.shards == 0 and t.device == torch.device("cpu")
    assert t.ledger.accounts.count.dim() == 0
    with pytest.warns(RuntimeWarning, match="host engine"):
        h = TorchStateMachine(CFG, batch_lanes=64, device="cpu", shards=2,
                              host_engine=True)
    assert h.shards == 0


def test_kernel_failures_raise_cuda_kernel_error(monkeypatch):
    """A nonzero error from a kernel's C entry point raises CudaKernelError,
    a RuntimeError that the fault domain counts as a device fault."""
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import scrub as tscrub

    class FakeLib:
        @staticmethod
        def tb_error_string(err):
            return b"an illegal memory access was encountered"

    monkeypatch.setattr(_cuda, "library", lambda: FakeLib)
    with pytest.raises(_cuda.CudaKernelError, match="probe failed: error 700"):
        _cuda._raise_on(700, "probe")
    _cuda._raise_on(0, "probe")
    assert issubclass(_cuda.CudaKernelError, RuntimeError)
    assert _cuda.CudaKernelError in tscrub.DEVICE_FAULT_TYPES


def test_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchStateMachine(CFG)
    from tigerbeetle_tpu_torch.ops import state_machine as tsm

    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsm.make_ledger(1 << 4, 1 << 4, 1 << 4, 1 << 4)


def test_wrappers_never_fall_back_for_cuda_tensors(monkeypatch):
    """A CUDA tensor goes to the kernel wrapper, never to the plain version:
    here the wrapper is replaced by a marker to show the route."""
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import hash_table as tht

    class Routed(Exception):
        pass

    def kernel(*args, **kwargs):
        raise Routed

    monkeypatch.setattr(_cuda, "probe", kernel)
    monkeypatch.setattr(tht, "lookup_plain", lambda *a: pytest.fail("plain"))

    class FakeCuda:
        is_cuda = True
        shape = (4,)

    with pytest.raises(Routed):
        tht.lookup(tht.make_table(16, {}, "cpu"), FakeCuda(), FakeCuda(), 8)


@pytest.mark.parametrize("route", ["seq_transfers", "seq_accounts",
                                   "tombstone"])
def test_sequential_and_tombstone_wrappers_never_fall_back(monkeypatch, route):
    """K6, K7 and K8: a CUDA tensor goes to the kernel wrapper, never to the
    plain version."""
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import hash_table as tht
    from tigerbeetle_tpu_torch.ops import scan_path as tsp

    class Routed(Exception):
        pass

    def kernel(*args, **kwargs):
        raise Routed

    monkeypatch.setattr(_cuda, route, kernel)
    for plain in ("create_transfers_seq_plain", "create_accounts_seq_plain"):
        monkeypatch.setattr(tsp, plain, lambda *a: pytest.fail("plain"))
    monkeypatch.setattr(tht, "remove_to_tombstone_plain",
                        lambda *a: pytest.fail("plain"))

    class FakeCuda:
        is_cuda = True
        shape = (4,)

    batch = {c: FakeCuda() for c in tsm.TRANSFER_BATCH_COLS
             + tsm.ACCOUNT_BATCH_COLS}
    led = tsm.make_ledger(16, 16, 16, 16, device="cpu")
    with pytest.raises(Routed):
        if route == "tombstone":
            tht.remove_to_tombstone(led.accounts, FakeCuda(), FakeCuda())
        elif route == "seq_transfers":
            tsp.create_transfers_seq(led, batch, 1, 10)
        else:
            tsp.create_accounts_seq(led, batch, 1, 10)


def test_package_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, tigerbeetle_tpu_torch, tigerbeetle_tpu_torch.machine, "
        "tigerbeetle_tpu_torch.convert, tigerbeetle_tpu_torch.testing.model, "
        "tigerbeetle_tpu_torch.utils.benchgen\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'flax', 'tigerbeetle_tpu.')) or m == 'tigerbeetle_tpu')\n"
        "print(bad)\n"
        "raise SystemExit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", ["types.py", "config.py", "obs/metrics.py",
                                  "testing/model.py", "utils/fs.py",
                                  "vsr/checksum.py", "vsr/timeout.py"])
def test_copied_module_equals_its_source_apart_from_imports(path):
    def body(p):
        return [line for line in (ROOT / p).read_text().splitlines()
                if not line.lstrip().startswith(("import ", "from "))]

    assert body("tigerbeetle_tpu_torch/" + path) == body("tigerbeetle_tpu/" + path)


def test_kernel_sources_are_in_the_repository():
    from tigerbeetle_tpu_torch.ops import _cuda

    for k in _cuda.KERNELS.values():
        src = (ROOT / k.source).read_text()
        # Each source names the JAX function it replaces: its path in the
        # JAX package, or a file at the repository's root by name.
        path, line = k.replaces.split(":")
        assert (ROOT / path).is_file()
        assert (path.split("/", 1)[1] if "/" in path else path) in src
        assert int(line) > 0


# -- the general kernel (ops/transfer_full) ------------------------------------

CFG_FULL = LedgerConfig(accounts_capacity_log2=10, transfers_capacity_log2=10,
                        posted_capacity_log2=8, history_capacity_log2=8)


def full_trio(n_accounts=12, waves=True, cfg=CFG_FULL):
    """Port, JAX and oracle machines (default routing) holding accounts
    1..n_accounts with seqmix's limit and history flags."""
    t = TorchStateMachine(cfg, batch_lanes=64, device="cpu")
    j = TpuStateMachine(cfg, batch_lanes=64)
    t.waves_enabled = j.waves_enabled = waves
    ref = M.ReferenceStateMachine()
    commit3(t, j, ref, "create_accounts", seqmix.accounts_batch(
        np.random.default_rng(0), 1, n_accounts, faults=False), 10)
    return t, j, ref


def tspec(id, dr, cr, amount, flags=0, **kw):
    kw.setdefault("ledger", 1)
    kw.setdefault("code", 1)
    return types.transfer(id=id, debit_account_id=dr, credit_account_id=cr,
                          amount=amount, flags=int(flags), **kw)


def pvspec(id, pending_id, flags, amount=0):
    return types.transfer(id=id, pending_id=pending_id, amount=amount,
                          flags=int(flags))


# Scenarios of tests/test_transfer_full.py, test_balancing_vector.py and
# test_waves.py, as lists of batches (each a list of transfers).
FULL_SCENARIOS = {
    "pending_then_post_separate_batches": [
        [tspec(100 + i, 1 + i % 6, 7 + i % 5, 10 + i, F.PENDING)
         for i in range(16)],
        [pvspec(200 + i, 100 + i, F.POST_PENDING_TRANSFER if i % 2
                else F.VOID_PENDING_TRANSFER) for i in range(16)]],
    "pending_and_post_same_batch": [
        [tspec(300 + i, 1 + i % 6, 7 + i % 5, 50, F.PENDING) for i in range(8)]
        + [pvspec(400 + i, 300 + i, F.POST_PENDING_TRANSFER) for i in range(8)]],
    "double_post_and_partial_amounts": [
        [tspec(500, 1, 6, 9, F.PENDING), tspec(600, 1, 6, 100, F.PENDING)],
        [pvspec(501, 500, F.POST_PENDING_TRANSFER),
         pvspec(502, 500, F.POST_PENDING_TRANSFER),
         pvspec(503, 500, F.VOID_PENDING_TRANSFER),
         pvspec(601, 600, F.POST_PENDING_TRANSFER, 40),
         pvspec(602, 600, F.POST_PENDING_TRANSFER, 200)]],
    "duplicate_post_ids": [
        [tspec(1100, 1, 6, 30, F.PENDING),
         pvspec(1101, 1100, F.POST_PENDING_TRANSFER),
         pvspec(1101, 1100, F.POST_PENDING_TRANSFER),
         pvspec(1101, 1100, F.VOID_PENDING_TRANSFER)]],
    "balancing_clamps_on_limit_accounts": [
        [tspec(10 + i, 8, 2 + 7 * (i % 2), 40) for i in range(4)],
        [tspec(20 + i, 2 + 7 * (i % 2), 6, 0 if i % 3 else 15,
               F.BALANCING_DEBIT if i % 2 else F.BALANCING_CREDIT)
         for i in range(10)]
        + [tspec(40 + i, 2, 6, 25) for i in range(4)]],
    "history_accounts_and_limits": [
        [tspec(60 + i, 4 if i % 2 else 1, 5 if i % 3 else 11, 7 + i)
         for i in range(20)]],
    "linked_chains_with_limits": [
        [tspec(70, 8, 2, 100)],
        [tspec(71, 1, 6, 5, F.LINKED), tspec(72, 6, 8, 5, F.LINKED),
         tspec(73, 8, 1, 5), tspec(74, 4, 6, 9, F.LINKED),
         tspec(75, 6, 4, 9, ledger=0), tspec(76, 1, 4, 2)]],
}


@pytest.mark.parametrize("scenario", sorted(FULL_SCENARIOS))
def test_general_kernel_scenarios_match_jax_and_oracle(scenario):
    t, j, ref = full_trio()
    for b, rows in enumerate(FULL_SCENARIOS[scenario]):
        commit3(t, j, ref, "create_transfers", types.transfers_array(rows),
                10 ** 9 * (b + 1))
        assert_same_ledger(t, j)
    assert t.balances_snapshot() == ref.balances_snapshot()
    assert t.digest() == j.digest()
    assert (t.prepare_timestamp, t.commit_timestamp) == (
        j.prepare_timestamp, j.commit_timestamp)


def run_mix(t, j, ref, seed, kinds, lanes=60):
    """``kinds``: the fullmix batch kind of each batch.  Returns the port
    machine's route of each batch (the sequential path or not)."""
    rng = np.random.default_rng(seed)
    mix = fullmix.GeneralMix(rng, list(range(1, 13)), 10_000)
    routes = []
    seq = t._sequential
    for b, kind in enumerate(kinds):
        wall = 10 ** 9 * (b + 1)
        if kind == "seed_big":
            batch = mix.seed_big()
        else:
            batch = mix.batch(lanes, kind)
        hit = []
        t._sequential = lambda *a, **k: hit.append(1) or seq(*a, **k)
        got = commit3(t, j, ref, "create_transfers", batch, wall)
        t._sequential = seq
        routes.append(bool(hit))
        mix.settle(i for i, _ in got)
        assert_same_ledger(t, j)
    assert t.balances_snapshot() == ref.balances_snapshot()
    assert t.digest() == j.digest()
    return routes


@pytest.mark.parametrize("waves", [True, False])
def test_general_mix_stays_on_the_general_kernel(waves):
    t, j, ref = full_trio(waves=waves)
    routes = run_mix(t, j, ref, 3 + waves, ["general"] * 4)
    assert not any(routes)
    assert (t.last_wave is not None) == waves


@pytest.mark.parametrize("reason", fullmix.SEQ_REASONS)
def test_each_flag_seq_reason_lands_on_the_sequential_path(reason):
    """A batch the general kernel flags FLAG_SEQ (nothing applied) is run on
    the sequential path, and still equals the JAX machine and the oracle."""
    t, j, ref = full_trio()
    kinds = ["general", "seed_big", reason] if reason == "arith_broken" \
        else ["general", reason]
    routes = run_mix(t, j, ref, 11, kinds)
    assert routes[-1], reason


def test_waves_on_and_off_give_the_same_ledger():
    """TB_WAVES=0 and the default (on) commit the same codes and tables."""
    on = full_trio(waves=True)
    off = full_trio(waves=False)
    assert on[0].waves_enabled and not off[0].waves_enabled
    for t, j, ref in (on, off):
        run_mix(t, j, ref, 21, ["general"] * 3)
    got_on = convert.ledger_to_numpy(on[0].ledger)
    got_off = convert.ledger_to_numpy(off[0].ledger)
    for name in ("accounts", "transfers", "posted", "history"):
        for k, v in got_on[name].items():
            if k == "cols":
                for c in v:
                    np.testing.assert_array_equal(v[c], got_off[name]["cols"][c])
            else:
                np.testing.assert_array_equal(v, got_off[name][k])


def test_tb_waves_env_default_on(monkeypatch):
    monkeypatch.delenv("TB_WAVES", raising=False)
    assert TorchStateMachine(CFG, device="cpu").waves_enabled
    monkeypatch.setenv("TB_WAVES", "0")
    assert not TorchStateMachine(CFG, device="cpu").waves_enabled


def test_wave_metrics_equal_the_jax_machine():
    """The wave occupancy series (the 11-int wave vector read back with the
    codes) equal the JAX machine's, batch by batch."""
    from tigerbeetle_tpu.obs.metrics import registry as jreg
    from tigerbeetle_tpu_torch.obs.metrics import registry as treg

    t, j, ref = full_trio()
    with jreg.enabled_scope(), treg.enabled_scope():
        run_mix(t, j, ref, 31, ["general"] * 3)
        want = {k: v for k, v in jreg.snapshot()["histograms"].items()
                if k.startswith("waves.")}
        got = {k: v for k, v in treg.snapshot()["histograms"].items()
               if k.startswith("waves.")}
        assert got == want and want
        for kind in ("counters",):
            assert ({k: v for k, v in treg.snapshot()[kind].items()
                     if k.startswith("waves.")}
                    == {k: v for k, v in jreg.snapshot()[kind].items()
                        if k.startswith("waves.")})


def test_probe_overflow_grows_the_flagged_table_and_retries():
    """Every free transfers slot tombstoned: the general kernel's probes
    overflow, both machines double the table and retry, and commit the same
    batch identically."""
    t, j, ref = full_trio()
    commit3(t, j, ref, "create_transfers", types.transfers_array(
        [tspec(1, 1, 6, 10, F.PENDING)]), 10 ** 9)
    tomb = convert.tensor_to_array(t.ledger.transfers.tombstone)
    free = (convert.tensor_to_array(t.ledger.transfers.key_lo) == 0)
    t.ledger.transfers.tombstone[torch.from_numpy(free)] = True
    j.ledger = j.ledger.replace(transfers=j.ledger.transfers.replace(
        tombstone=jnp.asarray(tomb | free)))
    cap = t.ledger.transfers.capacity
    grown = []
    grow = t._grow_flagged
    t._grow_flagged = lambda k: grown.append(k) or grow(k)
    commit3(t, j, ref, "create_transfers", types.transfers_array(
        [tspec(2, 1, 6, 5, F.BALANCING_DEBIT),
         pvspec(3, 1, F.POST_PENDING_TRANSFER)]), 2 * 10 ** 9)
    assert grown and grown[0] & tf.FLAG_GROW_TRANSFERS
    assert t.ledger.transfers.capacity == j.ledger.transfers.capacity > cap
    assert_same_ledger(t, j)


@pytest.mark.parametrize("dtype", ["transfers", "accounts"])
def test_batch_to_tensors_is_the_padded_soa(dtype):
    """The machine's batch staging equals soa_to_tensors(to_soa(padded))."""
    rng = np.random.default_rng(4)
    if dtype == "transfers":
        batch = mixed_transfers(rng, 50, 10, {"next": 1, "pool": []})
    else:
        batch = seqmix.accounts_batch(rng, 1, 50)
    padded = np.zeros(64, dtype=batch.dtype)
    padded[:50] = batch
    want = convert.soa_to_tensors(types.to_soa(padded), "cpu")
    got = convert.batch_to_tensors(batch, 64, "cpu")
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
