"""The port's sharded machine (``TorchStateMachine(shards=...)``) against the
JAX package's (``TpuStateMachine(shards=...)``) on the same batches.

The cases are tests/test_sharded_machine.py's and
tests/test_async_sharded.py's: mixed cross-shard and two-phase parity with
the sequential fallback, growth, the checkpoint round trip, the scrub lanes
and a grouped deferred run.  The JAX machines run conftest's 8 virtual CPU
devices; the port's, ``device.force_virtual(8, "cpu")``.  Results, digests,
balances and the canonical ledger arrays must be equal."""

import random

import jax
import numpy as np
import pytest

from tigerbeetle_tpu.config import LedgerConfig as JConfig
from tigerbeetle_tpu.machine import TpuStateMachine
from tigerbeetle_tpu.vsr import checkpoint as jck
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch import device as tdev
from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.config import LedgerConfig
from tigerbeetle_tpu_torch.machine import TorchStateMachine
from tigerbeetle_tpu_torch.ops.scrub import mix64_np
from tigerbeetle_tpu_torch.vsr import checkpoint as tck

LANES = 128


@pytest.fixture(autouse=True)
def virtual_mesh():
    if len(jax.devices()) < 8:
        pytest.skip(f"needs 8 JAX devices, have {len(jax.devices())}")
    tdev.force_virtual(8, "cpu")
    try:
        yield
    finally:
        tdev.force_virtual(0, "cpu")


def caps(transfers_log2=12):
    return dict(accounts_capacity_log2=10,
                transfers_capacity_log2=transfers_log2,
                posted_capacity_log2=10)


def make_pair(shards, transfers_log2=12):
    j = TpuStateMachine(JConfig(**caps(transfers_log2)), batch_lanes=LANES,
                        shards=shards)
    t = TorchStateMachine(LedgerConfig(**caps(transfers_log2)),
                          batch_lanes=LANES, device="cpu", shards=shards)
    assert j.shards == t.shards == shards
    return j, t


def owner_of(account_id: int, shards: int) -> int:
    return int(mix64_np(np.array([account_id], np.uint64),
                        np.zeros(1, np.uint64))[0]) & (shards - 1)


def accounts_by_owner(shards: int, per_owner: int, flags=0):
    buckets = {s: [] for s in range(shards)}
    aid = 1
    while any(len(b) < per_owner for b in buckets.values()):
        s = owner_of(aid, shards)
        if len(buckets[s]) < per_owner:
            buckets[s].append(aid)
        aid += 1
    rows = [types.account(id=a, ledger=1, code=10, flags=flags)
            for b in buckets.values() for a in b]
    return buckets, types.accounts_array(
        sorted(rows, key=lambda r: int(r["id_lo"])))


def both(j, t, op, batch, **kw):
    want = getattr(j, op)(batch, **kw)
    got = getattr(t, op)(batch, **kw)
    assert got == want, (op, got[:5], want[:5])
    return want


def assert_same_state(j, t):
    assert t.digest() == int(j.digest())
    assert t.balances_snapshot() == j.balances_snapshot()
    a = jck.ledger_to_arrays(j.checkpoint_ledger())
    b = tck.ledger_to_arrays(t.checkpoint_ledger())
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), b[key],
                                      err_msg=key)


def plain(first, n, dr, cr, amount=3, flags=0, **kw):
    return types.transfers_array([
        types.transfer(id=first + i, debit_account_id=dr[i % len(dr)],
                       credit_account_id=cr[(i + 1) % len(cr)],
                       amount=amount + i % 5, ledger=1, code=1, flags=flags,
                       **kw)
        for i in range(n)])


def test_cross_shard_parity_and_sequential_fallback():
    """Plain cross-shard and same-shard batches on the sharded fast path,
    a linked create_accounts batch with a duplicate id through the
    sequential window (unshard, the sequential path, reshard), then
    lookups, a query and the canonical arrays."""
    j, t = make_pair(2)
    buckets, accounts = accounts_by_owner(2, 6)
    both(j, t, "create_accounts", accounts, wall_clock_ns=1)
    same, other = buckets[0], buckets[1]
    both(j, t, "create_transfers", plain(100, 10, same, other))
    assert t.shard_lanes_cross == j.shard_lanes_cross == 10
    both(j, t, "create_transfers", plain(200, 6, same, same, amount=2))
    assert t.shard_lanes_cross == 10
    linked = types.accounts_array([
        types.account(id=7000, ledger=1, code=10,
                      flags=types.AccountFlags.LINKED),
        types.account(id=7000, ledger=1, code=10),
        types.account(id=7001, ledger=1, code=10),
    ])
    both(j, t, "create_accounts", linked)
    assert t.shard_seq_fallbacks == j.shard_seq_fallbacks == 1
    assert t._ledger_is_sharded
    both(j, t, "create_transfers", plain(300, 8, same + [7001], other))
    assert_same_state(j, t)
    ids = [same[0], other[0], 7001, 999_999]
    assert (j.lookup_accounts(ids) == t.lookup_accounts(ids)).all()
    tids = [100, 205, 300, 777_777]
    assert (j.lookup_transfers(tids) == t.lookup_transfers(tids)).all()
    filt = np.zeros(1, dtype=types.ACCOUNT_FILTER_DTYPE)[0].copy()
    filt["account_id_lo"] = same[0]
    filt["limit"] = 64
    filt["flags"] = (types.AccountFilterFlags.DEBITS
                     | types.AccountFilterFlags.CREDITS)
    q1, q2 = j.get_account_transfers(filt), t.get_account_transfers(filt)
    assert len(q1) == len(q2) > 0 and (q1 == q2).all()


@pytest.mark.slow
def test_two_phase_and_history_parity():
    """tests/test_sharded_machine.py's mixed parity: cross-shard pendings,
    their table posts and voids on the general step, and a history batch
    routed to the sequential window.  @slow: the JAX machine compiles its
    8-device general kernel (about 75 s on a cold cache, as the reference's
    own case)."""
    j, t = make_pair(2)
    buckets, accounts = accounts_by_owner(2, 6)
    both(j, t, "create_accounts", accounts, wall_clock_ns=1)
    both(j, t, "create_accounts", types.accounts_array([
        types.account(id=5000, ledger=1, code=10,
                      flags=types.AccountFlags.HISTORY)]))
    same, other = buckets[0], buckets[1]
    both(j, t, "create_transfers",
         plain(300, 6, same, other, amount=20,
               flags=types.TransferFlags.PENDING))
    both(j, t, "create_transfers", types.transfers_array([
        types.transfer(id=400 + i, pending_id=300 + i, ledger=1, code=1,
                       flags=(types.TransferFlags.POST_PENDING_TRANSFER
                              if i % 2 == 0
                              else types.TransferFlags.VOID_PENDING_TRANSFER))
        for i in range(6)]))
    assert t.shard_seq_fallbacks == 0
    both(j, t, "create_transfers", types.transfers_array([
        types.transfer(id=500, debit_account_id=5000,
                       credit_account_id=same[0], amount=7, ledger=1,
                       code=1)]))
    assert t.shard_seq_fallbacks == j.shard_seq_fallbacks == 1
    assert_same_state(j, t)


def test_growth_parity():
    """3 x 512 transfers through a 1,024-slot table: growth under shards
    (the per-shard peak floor and the host re-placement)."""
    j, t = make_pair(2, transfers_log2=10)
    _buckets, accounts = accounts_by_owner(2, 8)
    both(j, t, "create_accounts", accounts, wall_clock_ns=1)
    acct = sorted(int(r["id_lo"]) for r in accounts)
    for b in range(12):
        both(j, t, "create_transfers", types.transfers_array([
            types.transfer(id=(1 << 18) + b * 128 + i,
                           debit_account_id=acct[i % 16],
                           credit_account_id=acct[(i + 1) % 16],
                           amount=1, ledger=1, code=1)
            for i in range(128)]))
    assert t.ledger.transfers.capacity == j.ledger.transfers.capacity > 1024
    assert_same_state(j, t)
    assert convert.tensor_to_array(t.ledger.transfers.count).tolist() == \
        np.asarray(j.ledger.transfers.count).tolist()


def test_checkpoint_round_trip_and_restore():
    """The canonical arrays equal the JAX machine's, and a checkpoint
    restores into a fresh 4-shard port machine that commits on in step."""
    j, t = make_pair(2)
    _buckets, accounts = accounts_by_owner(2, 6)
    both(j, t, "create_accounts", accounts, wall_clock_ns=1)
    acct = sorted(int(r["id_lo"]) for r in accounts)
    both(j, t, "create_transfers", plain(900, 20, acct, acct[5:], amount=9))
    assert_same_state(j, t)
    m3 = TorchStateMachine(LedgerConfig(**caps()), batch_lanes=LANES,
                           device="cpu", shards=4)
    m3.ledger = tck.arrays_to_ledger(tck.ledger_to_arrays(
        t.checkpoint_ledger()), "cpu")
    m3.restore_host_state(t.host_state())
    assert m3._ledger_is_sharded and m3.digest() == t.digest()
    nxt = plain(7777, 3, acct, acct)
    r_a = both(j, t, "create_transfers", nxt)
    assert m3.commit_batch("create_transfers", nxt, t.prepare_timestamp) == r_a
    assert m3.digest() == t.digest()


def test_scrub_lanes_detect_and_recover():
    """The per-shard scrub lanes through the machine's fault domain: an SDC
    flip (the JAX machine's seeded pick) is detected and recovered in the
    sharded layout."""
    j, t = make_pair(2)
    _buckets, accounts = accounts_by_owner(2, 4)
    for m in (j, t):
        m.scrub_interval = 1
        m.retry_tick_s = 0
    both(j, t, "create_accounts", accounts, wall_clock_ns=1)
    for m in (j, t):
        assert m.scrub_arm()
    acct = sorted(int(r["id_lo"]) for r in accounts)
    both(j, t, "create_transfers", plain(600, 8, acct, acct, amount=4))
    both(j, t, "create_transfers", plain(700, 1, acct, acct[1:], amount=1))
    assert t.scrub_checks == j.scrub_checks >= 1
    assert t.scrub_mismatches == 0
    before = t.digest()
    assert j.inject_sdc_bitflip(random.Random(11))
    assert t.inject_sdc_bitflip(random.Random(11))
    assert t.digest() == int(j.digest()) != before
    assert not t.scrub_check()
    assert not j.scrub_check()
    assert t.device_recoveries == 1 and t._ledger_is_sharded
    assert t.digest() == before and t.scrub_check()
    assert_same_state(j, t)


def test_grouped_and_deferred_runs_match_blocking():
    """tests/test_async_sharded.py:148-199 at 2 shards: deferred single
    batches and a grouped deferred run through the sharded probed step,
    against the JAX machine's blocking commits."""
    j, t = make_pair(2)
    t.group_device_commit = True
    accounts = types.accounts_array([
        types.account(id=i + 1, ledger=1, code=10) for i in range(16)])
    both(j, t, "create_accounts", accounts, wall_clock_ns=1000)

    def batch(first, n, amount=3):
        return types.transfers_array([
            types.transfer(id=first + i, debit_account_id=1 + i % 16,
                           credit_account_id=1 + (i + 3) % 16,
                           amount=amount + i % 5, ledger=1, code=10)
            for i in range(n)])

    singles = [batch(10_000, 20), batch(20_000, 24, amount=5),
               batch(10_000, 20)]
    want = [j.create_transfers(b) for b in singles]
    handles = []
    for b in singles:
        ts = t.prepare("create_transfers", len(b), 0)
        handles.append(t.commit_fast_deferred(b, ts))
    assert all(h is not None for h in handles)
    assert [h.resolve()[0] for h in handles] == want
    run = [batch(30_000, 12), batch(40_000, 9), batch(50_000, 15)]
    want = [j.create_transfers(b) for b in run]
    tss = [t.prepare("create_transfers", len(b), 0) for b in run]
    handle = t.commit_group_fast(run, tss, deferred=True)
    assert handle is not None and handle.resolve() == want
    assert_same_state(j, t)
