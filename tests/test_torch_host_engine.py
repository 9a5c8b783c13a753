"""The port's host engine (``host_engine.py``: the native C++ engine over a
numpy ledger, built by ``native.load_engine``) against the JAX package's,
exactly, on tests/test_host_engine.py's scenarios: a ``host_engine=True``
port machine beside a ``host_engine=True`` JAX machine and the scalar
oracle, compared after every batch (codes, balances, and the host tables
byte for byte: same slots, same rows); the engine against the port's
device executor (the plain versions on the CPU); ``HostLedger``'s
conversions to and from torch tensors; and the engine sources held equal to
the JAX package's copies."""

from pathlib import Path

import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu import types
from tigerbeetle_tpu.config import LedgerConfig
from tigerbeetle_tpu.host_engine import HostLedger as JHostLedger
from tigerbeetle_tpu.machine import TpuStateMachine
from tigerbeetle_tpu.testing import model as M
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.host_engine import HostLedger, engine_available
from tigerbeetle_tpu_torch.machine import TorchStateMachine
from tigerbeetle_tpu_torch.ops import state_machine as sm

ROOT = Path(__file__).resolve().parents[1]
CFG = LedgerConfig(accounts_capacity_log2=10, transfers_capacity_log2=12,
                   posted_capacity_log2=11)
CPU = torch.device("cpu")
TF = types.TransferFlags


def transfers_array(specs):
    return types.transfers_array([types.transfer(**s) for s in specs])


def host_trio(n_accounts=16, history=(), limits=()):
    """A port and a JAX host-engine machine and the oracle, accounts made."""
    t = TorchStateMachine(CFG, batch_lanes=256, device="cpu",
                          host_engine=True)
    j = TpuStateMachine(CFG, batch_lanes=256, host_engine=True)
    ref = M.ReferenceStateMachine()
    rows = []
    for i in range(n_accounts):
        flags = 0
        if i in history:
            flags |= types.AccountFlags.HISTORY
        if i in limits:
            flags |= types.AccountFlags.DEBITS_MUST_NOT_EXCEED_CREDITS
        rows.append(types.account(id=i + 1, ledger=1, code=10, flags=flags))
    accounts = types.accounts_array(rows)
    want = ref.create_accounts([M.account_from_row(r) for r in accounts], 1)
    assert t.create_accounts(accounts, 1) == j.create_accounts(accounts, 1) \
        == want
    return t, j, ref


def assert_host_tables_equal(t, j):
    for name in ("accounts", "transfers", "posted"):
        a, b = getattr(t._host_led, name), getattr(j._host_led, name)
        assert a.rows.tobytes() == b.rows.tobytes(), name
        assert a.count == b.count, name
    assert t._host_led.history_count == j._host_led.history_count
    for k in t._host_led.history:
        np.testing.assert_array_equal(t._host_led.history[k],
                                      j._host_led.history[k], err_msg=k)


def run_batch(t, j, ref, batch):
    got = t.create_transfers(batch)
    assert got == j.create_transfers(batch)
    want = ref.create_transfers([M.transfer_from_row(r) for r in batch])
    assert got == want, f"codes diverge: {got[:8]} vs {want[:8]}"
    assert t.balances_snapshot() == ref.balances_snapshot() == \
        j.balances_snapshot()
    assert_host_tables_equal(t, j)


@pytest.fixture(autouse=True)
def _needs_engine():
    if not engine_available():
        pytest.skip("the native engine cannot be built (no g++)")


# -- tests/test_host_engine.py TestEngineVsOracle --------------------------------


class TestEngineVsOracle:
    def test_validation_ladder(self):
        t, j, ref = host_trio()
        run_batch(t, j, ref, transfers_array([
            dict(id=0, debit_account_id=1, credit_account_id=2, amount=1,
                 ledger=1, code=1),
            dict(id=10, debit_account_id=1, credit_account_id=1, amount=1,
                 ledger=1, code=1),
            dict(id=11, debit_account_id=1, credit_account_id=99, amount=1,
                 ledger=1, code=1),
            dict(id=12, debit_account_id=1, credit_account_id=2, amount=0,
                 ledger=1, code=1),
            dict(id=13, debit_account_id=1, credit_account_id=2, amount=5,
                 ledger=2, code=1),
            dict(id=14, debit_account_id=1, credit_account_id=2, amount=5,
                 ledger=1, code=0),
            dict(id=15, debit_account_id=1, credit_account_id=2, amount=5,
                 ledger=1, code=1, timeout=9),
            dict(id=16, debit_account_id=1, credit_account_id=2, amount=5,
                 ledger=1, code=1),
            dict(id=16, debit_account_id=1, credit_account_id=2, amount=5,
                 ledger=1, code=1),
            dict(id=16, debit_account_id=1, credit_account_id=2, amount=6,
                 ledger=1, code=1),
        ]))

    def test_two_phase_flow(self):
        t, j, ref = host_trio()
        run_batch(t, j, ref, transfers_array([
            dict(id=100 + i, debit_account_id=1 + i % 8,
                 credit_account_id=9 + i % 8, amount=10 + i, ledger=1, code=1,
                 flags=TF.PENDING, timeout=3600)
            for i in range(32)
        ]))
        run_batch(t, j, ref, transfers_array(
            [dict(id=200 + i, pending_id=100 + i, ledger=1, code=1,
                  flags=TF.POST_PENDING_TRANSFER) for i in range(16)]
            + [dict(id=300 + i, pending_id=116 + i,
                    flags=TF.VOID_PENDING_TRANSFER) for i in range(8)]
            + [dict(id=400, pending_id=100, flags=TF.POST_PENDING_TRANSFER)]
            + [dict(id=401, pending_id=116, flags=TF.VOID_PENDING_TRANSFER)]
        ))

    def test_linked_chains_rollback(self):
        t, j, ref = host_trio()
        L = TF.LINKED
        run_batch(t, j, ref, transfers_array([
            dict(id=500, debit_account_id=1, credit_account_id=2, amount=5,
                 ledger=1, code=1, flags=L),
            dict(id=501, debit_account_id=2, credit_account_id=3, amount=5,
                 ledger=1, code=1, flags=L),
            dict(id=502, debit_account_id=1, credit_account_id=1, amount=5,
                 ledger=1, code=1),
            dict(id=510, debit_account_id=1, credit_account_id=2, amount=5,
                 ledger=1, code=1, flags=L),
            dict(id=511, debit_account_id=2, credit_account_id=3, amount=5,
                 ledger=1, code=1),
            dict(id=500, debit_account_id=3, credit_account_id=4, amount=7,
                 ledger=1, code=1),
        ]))

    def test_chain_open_at_batch_end(self):
        t, j, ref = host_trio()
        run_batch(t, j, ref, transfers_array([
            dict(id=600, debit_account_id=1, credit_account_id=2, amount=5,
                 ledger=1, code=1, flags=TF.LINKED),
            dict(id=601, debit_account_id=2, credit_account_id=3, amount=5,
                 ledger=1, code=1, flags=TF.LINKED),
        ]))

    def test_balancing_and_limits(self):
        t, j, ref = host_trio(limits=(0,))
        run_batch(t, j, ref, transfers_array([
            dict(id=700, debit_account_id=2, credit_account_id=1, amount=100,
                 ledger=1, code=1),
        ]))
        run_batch(t, j, ref, transfers_array([
            dict(id=701, debit_account_id=1, credit_account_id=3, amount=250,
                 ledger=1, code=1, flags=TF.BALANCING_DEBIT),
            dict(id=702, debit_account_id=1, credit_account_id=3, amount=10,
                 ledger=1, code=1, flags=TF.BALANCING_DEBIT),
            dict(id=703, debit_account_id=1, credit_account_id=3, amount=10,
                 ledger=1, code=1),
            dict(id=704, debit_account_id=3, credit_account_id=4, amount=10,
                 ledger=1, code=1, flags=TF.BALANCING_CREDIT),
        ]))

    def test_history_accounts(self):
        t, j, ref = host_trio(history=(0, 3))
        run_batch(t, j, ref, transfers_array([
            dict(id=800 + i, debit_account_id=1 + (i % 4),
                 credit_account_id=5 + (i % 4), amount=3 + i, ledger=1,
                 code=1)
            for i in range(24)
        ]))
        assert t._host_led.history_count == int(t.ledger.history.count) > 0

    @pytest.mark.parametrize("seed", range(8))
    def test_random_two_phase_stream(self, seed):
        rng = np.random.default_rng(seed)
        t, j, ref = host_trio(
            n_accounts=12,
            history=(0,) if seed % 3 == 0 else (),
            limits=(11,) if seed % 4 == 0 else (),
        )
        next_id = 2000
        live_pending: list = []
        for _batch in range(6):
            specs = []
            for _ in range(int(rng.integers(20, 60))):
                if rng.random() < 0.40 or not live_pending:
                    dr = int(rng.integers(1, 13))
                    flags = 0
                    r = rng.random()
                    if r < 0.4:
                        flags = TF.PENDING
                    elif r < 0.5:
                        flags = TF.LINKED
                    specs.append(dict(
                        id=next_id, debit_account_id=dr,
                        credit_account_id=dr % 12 + 1,
                        amount=int(rng.integers(0, 100)), ledger=1, code=1,
                        timeout=int(rng.integers(0, 3))
                        if flags == TF.PENDING else 0,
                        flags=flags,
                    ))
                    if flags == TF.PENDING:
                        live_pending.append(next_id)
                    next_id += 1
                else:
                    pid = int(rng.choice(live_pending))
                    if rng.random() < 0.3:
                        live_pending.remove(pid)
                    flags = (TF.POST_PENDING_TRANSFER if rng.random() < 0.6
                             else TF.VOID_PENDING_TRANSFER)
                    amount = 0 if rng.random() < 0.7 else int(
                        rng.integers(1, 120))
                    specs.append(dict(id=next_id, pending_id=pid,
                                      amount=amount, ledger=1, code=1,
                                      flags=flags))
                    next_id += 1
            if len(specs) > 4 and rng.random() < 0.6:
                specs.insert(int(rng.integers(1, len(specs))),
                             dict(specs[int(rng.integers(0, len(specs) - 1))]))
            run_batch(t, j, ref, transfers_array(specs))


# -- tests/test_host_engine.py TestCrossExecutorParity ---------------------------


class TestCrossExecutorParity:
    @pytest.mark.parametrize("seed", range(2))
    def test_digest_parity(self, seed):
        """The same batches through the port's device executor (the plain
        versions here) and its host engine: bit-identical ledgers."""
        rng = np.random.default_rng(300 + seed)
        dev = TorchStateMachine(CFG, batch_lanes=256, device="cpu")
        host = TorchStateMachine(CFG, batch_lanes=256, device="cpu",
                                 host_engine=True)
        accounts = types.accounts_array([
            types.account(id=i + 1, ledger=1, code=10,
                          flags=types.AccountFlags.HISTORY
                          if i == 0 and seed % 2 else 0)
            for i in range(12)
        ])
        assert dev.create_accounts(accounts, 1) == \
            host.create_accounts(accounts, 1)
        next_id = 9000
        pendings = []
        for _ in range(3):
            specs = []
            for _ in range(int(rng.integers(15, 40))):
                if pendings and rng.random() < 0.3:
                    specs.append(dict(
                        id=next_id, pending_id=int(rng.choice(pendings)),
                        ledger=1, code=1,
                        flags=TF.POST_PENDING_TRANSFER
                        if rng.random() < 0.5 else TF.VOID_PENDING_TRANSFER))
                else:
                    dr = int(rng.integers(1, 13))
                    flags = TF.PENDING if rng.random() < 0.4 else 0
                    specs.append(dict(
                        id=next_id, debit_account_id=dr,
                        credit_account_id=dr % 12 + 1,
                        amount=int(rng.integers(1, 90)), ledger=1, code=1,
                        flags=flags))
                    if flags:
                        pendings.append(next_id)
                next_id += 1
            batch = transfers_array(specs)
            assert dev.create_transfers(batch) == host.create_transfers(batch)
        assert dev.digest() == host.digest(), "slot-level divergence"
        assert dev.balances_snapshot() == host.balances_snapshot()
        got = convert.ledger_to_numpy(host.ledger)
        want = convert.ledger_to_numpy(dev.ledger)
        for name in ("accounts", "transfers", "posted"):
            np.testing.assert_array_equal(got[name]["key_lo"],
                                          want[name]["key_lo"], err_msg=name)

    def test_conversion_round_trip(self):
        """HostLedger -> torch Ledger -> HostLedger is lossless, and the
        port's host ledger of a machine equals the JAX package's of its
        twin row for row."""
        t, j, _ref = host_trio(n_accounts=8)
        batch = transfers_array([
            dict(id=50 + i, debit_account_id=1 + i % 8,
                 credit_account_id=(1 + i) % 8 + 1, amount=2 + i,
                 ledger=1, code=1)
            for i in range(40)
        ])
        assert t.create_transfers(batch) == j.create_transfers(batch)
        d1 = t.digest()
        led2 = HostLedger.from_device(t.ledger).to_device(CPU)
        assert int(sm.ledger_digest(led2)) & ((1 << 64) - 1) == d1 == \
            j.digest()
        back = HostLedger.from_device(led2)
        jback = JHostLedger.from_device(j.ledger)
        for name in ("accounts", "transfers", "posted"):
            assert getattr(back, name).rows.tobytes() == \
                getattr(jback, name).rows.tobytes()

    def test_lookup_parity(self):
        dev = TorchStateMachine(CFG, batch_lanes=256, device="cpu")
        host, j, _ref = host_trio(n_accounts=8)
        accounts = types.accounts_array(
            [types.account(id=i + 1, ledger=1, code=10) for i in range(8)])
        dev.create_accounts(accounts, 1)
        batch = transfers_array([
            dict(id=70 + i, debit_account_id=1 + i % 8,
                 credit_account_id=(1 + i) % 8 + 1, amount=2 + i,
                 ledger=1, code=1, flags=TF.PENDING)
            for i in range(16)
        ])
        for m in (dev, host, j):
            m.create_transfers(batch)
        ids = [71, 999, 75, 70]
        assert dev.lookup_transfers(ids).tobytes() == \
            host.lookup_transfers(ids).tobytes() == \
            j.lookup_transfers(ids).tobytes()
        assert dev.lookup_accounts([1, 5, 42]).tobytes() == \
            host.lookup_accounts([1, 5, 42]).tobytes() == \
            j.lookup_accounts([1, 5, 42]).tobytes()


def test_growth_under_pressure():
    """tests/test_host_engine.py's growth case: the host tables grow as the
    JAX engine's do, slot for slot."""
    cfg = LedgerConfig(accounts_capacity_log2=6, transfers_capacity_log2=7,
                       posted_capacity_log2=6)
    t = TorchStateMachine(cfg, batch_lanes=512, device="cpu",
                          host_engine=True)
    j = TpuStateMachine(cfg, batch_lanes=512, host_engine=True)
    ref = M.ReferenceStateMachine()
    accounts = types.accounts_array(
        [types.account(id=i + 1, ledger=1, code=10) for i in range(16)])
    t.create_accounts(accounts, 1)
    j.create_accounts(accounts, 1)
    ref.create_accounts([M.account_from_row(r) for r in accounts], 1)
    for b in range(4):
        run_batch(t, j, ref, transfers_array([
            dict(id=10_000 + b * 128 + i, debit_account_id=1 + i % 16,
                 credit_account_id=(1 + i) % 16 + 1, amount=1 + i,
                 ledger=1, code=1, flags=TF.PENDING if i % 3 == 0 else 0)
            for i in range(128)
        ]))
    assert t._host_led.transfers.capacity > 1 << 7


def test_queries_after_engine_commits():
    """The derived indexes rebuild from the engine's ledger on first use."""
    t, j, _ref = host_trio(n_accounts=4)
    batch = transfers_array([
        dict(id=80 + i, debit_account_id=1, credit_account_id=2 + i % 3,
             amount=5 + i, ledger=1, code=1)
        for i in range(20)
    ])
    assert t.create_transfers(batch) == j.create_transfers(batch)
    filt = np.zeros((), dtype=types.ACCOUNT_FILTER_DTYPE)
    filt["account_id_lo"], filt["limit"] = 1, 100
    filt["flags"] = (types.AccountFilterFlags.DEBITS
                     | types.AccountFilterFlags.CREDITS)
    assert t.get_account_transfers(filt).tobytes() == \
        j.get_account_transfers(filt).tobytes()
    assert len(t.get_account_transfers(filt)) == 20


def test_engine_mode_surface():
    """As the reference: warmup pre-faults, the fault domain does not arm,
    no SDC target, no commitments, and the pipeline entry points decline
    (the caller commits on the engine through commit_batch)."""
    t, _j, _ref = host_trio(n_accounts=4)
    t.warmup()
    t.scrub_interval = 4
    assert t.scrub_arm() is False and not t.scrub_armed
    assert t.inject_sdc_bitflip(__import__("random").Random(1)) is False
    assert t.commitment_root() == 0
    b = transfers_array([dict(id=5, debit_account_id=1, credit_account_id=2,
                              amount=1, ledger=1, code=1)])
    assert t.commit_fast_deferred(b, t.prepare("create_transfers", 1)) is None
    t.group_device_commit = True
    assert t.commit_group_fast([b, b], [10, 11]) is None


@pytest.mark.parametrize("name", ["engine.cpp", "tb_types.h"])
def test_engine_sources_equal_the_jax_packages(name):
    assert (ROOT / "tigerbeetle_tpu_torch/native" / name).read_bytes() == \
        (ROOT / "tigerbeetle_tpu/native" / name).read_bytes()


def test_host_engine_module_matches_its_source_outside_the_device_bridge():
    """host_engine.py is the JAX package's apart from the imports, the
    module docstring and the torch side of ``to_device``/``from_device``
    and the loader: the AoS slot layouts and the engine calls are equal."""
    from tigerbeetle_tpu import host_engine as jhe
    from tigerbeetle_tpu_torch import host_engine as the

    for name in ("ACC_SLOT_DTYPE", "TR_SLOT_DTYPE", "PO_SLOT_DTYPE",
                 "ACC_FIELD_TO_COL", "TR_FIELD_TO_COL", "PO_FIELD_TO_COL"):
        assert getattr(the, name) == getattr(jhe, name), name
    assert [f[0] for f in the._LedgerView._fields_] == \
        [f[0] for f in jhe._LedgerView._fields_]
    import inspect

    for fn in ("create_accounts", "create_transfers", "_lookup", "grow",
               "_view", "_writeback_counts"):
        assert inspect.getsource(getattr(the.HostEngine, fn)) == \
            inspect.getsource(getattr(jhe.HostEngine, fn)), fn
