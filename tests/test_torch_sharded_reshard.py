"""The online shard split of the port's machine against the JAX machine's:
tests/test_reconfig.py:175-250 run as differentials.

Each case drives a JAX ``TpuStateMachine`` and a port ``TorchStateMachine``
(``device.force_virtual(8, "cpu")``) through the same split, step for step:
the status of every ``reshard_step``, the commits served between chunks,
the split's counters, the digests and the canonical arrays must be equal,
and the live split must end at a cold-booted machine's digest at the
target shard count."""

import jax
import numpy as np
import pytest

from tigerbeetle_tpu.config import LedgerConfig as JConfig
from tigerbeetle_tpu.machine import TpuStateMachine
from tigerbeetle_tpu.vsr import checkpoint as jck
from tigerbeetle_tpu_torch import device as tdev
from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.config import LedgerConfig
from tigerbeetle_tpu_torch.machine import TorchStateMachine
from tigerbeetle_tpu_torch.vsr import checkpoint as tck

LANES = 128
CAPS = dict(accounts_capacity_log2=10, transfers_capacity_log2=12,
            posted_capacity_log2=10)


@pytest.fixture(autouse=True)
def virtual_mesh():
    if len(jax.devices()) < 8:
        pytest.skip(f"needs 8 JAX devices, have {len(jax.devices())}")
    tdev.force_virtual(8, "cpu")
    try:
        yield
    finally:
        tdev.force_virtual(0, "cpu")


def pair(shards):
    return (TpuStateMachine(JConfig(**CAPS), batch_lanes=LANES, shards=shards),
            TorchStateMachine(LedgerConfig(**CAPS), batch_lanes=LANES,
                              device="cpu", shards=shards))


def _accounts(n=64):
    return types.accounts_array([
        types.account(id=i, ledger=1, code=10) for i in range(1, n + 1)])


def _batch(base, n=16, accounts=64):
    return types.transfers_array([
        types.transfer(id=base + i, debit_account_id=1 + (base + i) % accounts,
                       credit_account_id=1 + (base + i * 7 + 3) % accounts,
                       amount=1 + i, ledger=1, code=10)
        for i in range(n)])


def each(machines, fn):
    """``fn`` on every machine; all must answer alike."""
    out = [fn(m) for m in machines]
    assert all(o == out[0] for o in out[1:]), out
    return out[0]


def assert_same(pair_):
    """A JAX machine and the port's: the digest and every canonical array."""
    j, t = pair_
    each(pair_, lambda m: int(m.digest()))
    base = jck.ledger_to_arrays(j.checkpoint_ledger())
    got = tck.ledger_to_arrays(t.checkpoint_ledger())
    assert sorted(got) == sorted(base)
    for key in base:
        np.testing.assert_array_equal(got[key], np.asarray(base[key]),
                                      err_msg=key)


def test_split_while_serving_matches_jax_and_cold_boot():
    live = pair(2)
    cold = pair(4)
    every = live + cold
    each(every, lambda m: m.create_accounts(_accounts()))
    for b in range(4):
        each(every, lambda m: m.create_transfers(_batch(100 + 16 * b)))
    assert each(live, lambda m: m.reshard_begin(4, verify=True,
                                                chunk_rows=16))
    # Serving between chunk shipments; each commit dirties migrated rows,
    # so the cutover takes catch-up rounds.
    for b in range(6):
        if not live[1].reshard_active:
            break
        each(live, lambda m: m.reshard_step(1))
        each(every, lambda m: m.create_transfers(_batch(300 + 16 * b)))
    pumps = 0
    while live[1].reshard_active:
        each(live, lambda m: m.reshard_step(1))
        pumps += 1
        assert pumps < 10_000, "split did not cut over after the drain"
    stats = each(live, lambda m: dict(m.reshard_stats))
    assert stats["splits_completed"] == 1 and stats["catchup_rounds"] >= 1
    assert each(live, lambda m: m.shards) == 4
    # The split ends where the cold boot is (the digest, as the reference
    # holds it; the slots of colliding keys follow each machine's own
    # insertion order), and the port where the JAX package is, array for
    # array.
    for _ in range(2):
        assert_same(live)
        assert_same(cold)
        each(every, lambda m: int(m.digest()))
        each(every, lambda m: m.create_transfers(_batch(900)))


def test_split_rejects_a_corrupt_chunk_and_reships_it():
    m = pair(2)
    each(m, lambda x: x.create_accounts(_accounts()))
    each(m, lambda x: x.create_transfers(_batch(100)))
    assert each(m, lambda x: x.reshard_begin(4, verify=True, chunk_rows=16,
                                             corrupt_chunks={0}))
    pumps = 0
    while m[1].reshard_active:
        each(m, lambda x: x.reshard_step(1))
        pumps += 1
        assert pumps < 10_000
    stats = each(m, lambda x: dict(x.reshard_stats))
    assert stats["chunk_retries"] >= 1 and stats["splits_completed"] == 1
    oracle = pair(4)
    each(oracle, lambda x: x.create_accounts(_accounts()))
    each(oracle, lambda x: x.create_transfers(_batch(100)))
    assert_same(m)
    each(m + oracle, lambda x: int(x.digest()))


def test_split_refusals_and_idempotence():
    m = pair(2)
    each(m, lambda x: x.create_accounts(_accounts()))
    for x in m:
        with pytest.warns(RuntimeWarning, match="not a doubling"):
            assert not x.reshard_begin(8, verify=True, chunk_rows=16)
    each(m, lambda x: x.reshard_stats["abandons"])
    assert each(m, lambda x: x.reshard_begin(4, verify=True, chunk_rows=16))
    assert each(m, lambda x: x.reshard_begin(4, verify=True, chunk_rows=16))
    assert each(m, lambda x: x.reshard_stats["splits_started"]) == 1
    pumps = 0
    while m[1].reshard_active:
        each(m, lambda x: x.reshard_step(4))
        pumps += 1
        assert pumps < 10_000
    assert each(m, lambda x: x.shards) == 4
    # A machine that is not sharded refuses too, and an abort of no split
    # is a no-op.
    single = TorchStateMachine(LedgerConfig(**CAPS), batch_lanes=LANES,
                               device="cpu")
    with pytest.warns(RuntimeWarning, match="not in sharded mode"):
        assert not single.reshard_begin(2)
    single.reshard_abort()
    assert single.reshard_step() == "idle" and not single.reshard_active


def test_operator_abort_keeps_serving_the_old_layout():
    m = pair(2)
    each(m, lambda x: x.create_accounts(_accounts()))
    each(m, lambda x: x.create_transfers(_batch(100)))
    assert each(m, lambda x: x.reshard_begin(4, chunk_rows=16))
    each(m, lambda x: x.reshard_step(2))
    for x in m:
        with pytest.warns(RuntimeWarning, match="operator abort"):
            x.reshard_abort()
    assert not each(m, lambda x: x.reshard_active)
    assert each(m, lambda x: x.shards) == 2
    each(m, lambda x: x.create_transfers(_batch(200)))
    assert_same(m)
