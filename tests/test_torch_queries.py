"""The port's queries against the JAX package's: ``ops/query.scan_history``
at function level, and ``TorchStateMachine``'s
``get_account_transfers`` and ``get_account_history`` against
``TpuStateMachine`` and the scalar oracle on the same batches, over
the fast path, the general kernel and the sequential path, with the index
maintained on every commit and with ``lazy_index``.  Tolerance: exact
equality of every row and array (integers only)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu import types
from tigerbeetle_tpu.config import LedgerConfig
from tigerbeetle_tpu.machine import TpuStateMachine
from tigerbeetle_tpu.ops import query as jq
from tigerbeetle_tpu.ops import state_machine as jsm
from tigerbeetle_tpu.testing import model as M
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.machine import TorchStateMachine
from tigerbeetle_tpu_torch.ops import query as tq
from tigerbeetle_tpu_torch.testing import fullmix, seqmix

CPU = torch.device("cpu")
U64M = (1 << 64) - 1
DEBITS, CREDITS, REVERSED = 1, 2, 4
LANES = 64
N_ACCOUNTS = 12
# Four 30-event batches fill the 256-slot transfers table to its growth
# bound: the eager pyramid then holds levels of 64, 128 and 256 entries, as
# the lazy rebuild does, so both share each JAX program shape.
CFG = LedgerConfig(accounts_capacity_log2=8, transfers_capacity_log2=8,
                   posted_capacity_log2=8, history_capacity_log2=8)
BATCH = 30


def commit3(t, j, ref, op, batch, wall):
    got = getattr(t, op)(batch, wall_clock_ns=wall)
    rows = (M.accounts_from_batch if op == "create_accounts"
            else M.transfers_from_batch)(batch)
    want = getattr(ref, op)(rows, wall)
    assert got == want == getattr(j, op)(batch, wall_clock_ns=wall)
    return got


def vary_fields(rng, batch):
    """Spread user_data_128 and code over a few values on the batch's
    regular (not post/void) transfers, so the field scans have work."""
    regular = (batch["flags"] & (types.TransferFlags.POST_PENDING_TRANSFER
                                 | types.TransferFlags.VOID_PENDING_TRANSFER)) == 0
    n = int(regular.sum())
    batch["user_data_128_hi"][regular] = rng.integers(0, 3, n)
    batch["user_data_128_lo"][regular] = rng.integers(0, 2, n)
    batch["code"][regular] = rng.choice([10, 20, 30], n)
    return batch


def plain_batch(rng, n, first):
    dr = rng.integers(1, N_ACCOUNTS + 1, n)
    cr = (dr + rng.integers(1, N_ACCOUNTS, n) - 1) % N_ACCOUNTS + 1
    return vary_fields(rng, types.transfers_array([
        types.transfer(id=first + i, debit_account_id=int(dr[i]),
                       credit_account_id=int(cr[i]),
                       amount=int(rng.integers(1, 100)), ledger=1, code=10)
        for i in range(n)]))


def run_route(route, lazy, seed=0):
    """Port, JAX and oracle machines after account and transfer batches that
    commit on ``route`` ("fast", "general" or "sequential")."""
    cfg = dataclasses.replace(CFG, lazy_index=lazy)
    fs = route == "sequential"
    t = TorchStateMachine(cfg, batch_lanes=LANES, device="cpu",
                          force_sequential=fs)
    j = TpuStateMachine(cfg, batch_lanes=LANES, force_sequential=fs)
    ref = M.ReferenceStateMachine()
    rng = np.random.default_rng(seed)
    if route == "fast":
        accounts = types.accounts_array([
            types.account(id=i, ledger=1, code=10 + 10 * (i % 2),
                          user_data_32=i % 3)
            for i in range(1, N_ACCOUNTS + 1)])
    else:
        accounts = seqmix.accounts_batch(rng, 1, N_ACCOUNTS, faults=False)
        accounts["code"] = 10 + 10 * (accounts["id_lo"] % 2).astype(np.uint16)
    commit3(t, j, ref, "create_accounts", accounts, 10)
    gen = {"general": fullmix.GeneralMix(rng, list(range(1, N_ACCOUNTS + 1)),
                                         10_000),
           "sequential": seqmix.TransferMix(rng, list(range(1, N_ACCOUNTS + 1)),
                                            10_000)}.get(route)
    for b in range(4):
        if route == "fast":
            batch = plain_batch(rng, BATCH, 1_000 + 100 * b)
        else:
            batch = vary_fields(rng, gen.batch(BATCH))
        got = commit3(t, j, ref, "create_transfers", batch, 10 ** 9 * (b + 1))
        if route == "general":
            gen.settle(i for i, _ in got)
    if route == "fast":
        assert not t._history_accounts_possible
    assert t.index.stale == j.index.stale == lazy
    assert t.ledger.transfers.capacity == 256
    return t, j, ref


def filt(account_id, ts_min=0, ts_max=0, limit=8190, flags=DEBITS | CREDITS,
         reserved=0):
    a = np.zeros(1, dtype=types.ACCOUNT_FILTER_DTYPE)
    size = types.ACCOUNT_FILTER_DTYPE["reserved"].itemsize
    a["reserved"] = np.void(bytes([reserved]) + bytes(size - 1))
    f = a[0]
    f["account_id_lo"] = account_id & U64M
    f["account_id_hi"] = account_id >> 64
    f["timestamp_min"] = ts_min
    f["timestamp_max"] = ts_max
    f["limit"] = limit
    f["flags"] = flags
    return f


def same_rows(got, want, what):
    assert got.dtype == want.dtype, what
    assert len(got) == len(want), f"{what}: {len(got)} rows, want {len(want)}"
    assert got.tobytes() == want.tobytes(), f"{what}: rows differ"


def check_filters(t, j, ref, accounts):
    ts = np.sort(convert.ledger_to_numpy(t.ledger)["transfers"]["cols"]["timestamp"])
    ts = ts[ts != 0]
    lo_ts, hi_ts = int(ts[len(ts) // 4]), int(ts[3 * len(ts) // 4])
    for acct in accounts:
        for flags in (DEBITS, CREDITS, DEBITS | CREDITS, DEBITS | REVERSED,
                      CREDITS | REVERSED, DEBITS | CREDITS | REVERSED):
            windows = ((8190, 0, 0), (7, lo_ts, hi_ts))
            if flags == DEBITS | CREDITS | REVERSED:
                windows += ((1, 0, 0),)
            for limit, ts_min, ts_max in windows:
                f = filt(acct, ts_min, ts_max, limit, flags)
                got = t.get_account_transfers(f)
                same_rows(got, j.get_account_transfers(f),
                          f"transfers acct={acct} flags={flags} limit={limit}")
                want = ref.get_account_transfers(acct, ts_min, ts_max, limit,
                                                 flags)
                assert [int(r["timestamp"]) for r in got] == [
                    w.timestamp for w in want]
                got_h = t.get_account_history(f)
                same_rows(got_h, j.get_account_history(f),
                          f"history acct={acct} flags={flags} limit={limit}")
                assert [int(r["timestamp"]) for r in got_h] == [
                    w[0] for w in ref.get_account_history(acct, ts_min, ts_max,
                                                          limit, flags)]


def assert_index_equal(port_idx, jax_idx):
    got = convert.index_levels_to_numpy(port_idx)
    want = convert.index_arrays(jax_idx)
    assert got["occupied"] == want["occupied"]
    assert got["stale"] == want["stale"]
    for name in ("dr_levels", "cr_levels", "levels"):
        for g, w in zip(got.get(name, []), want.get(name, [])):
            for c in g:
                np.testing.assert_array_equal(g[c], w[c], err_msg=name + c)


def extra_batch(route, seed=5):
    """One more batch on ``route``, after the queries have run (8 events:
    the transfers table stays at 256 slots)."""
    rng = np.random.default_rng(seed)
    if route == "fast":
        return plain_batch(rng, 8, 50_000)
    return vary_fields(rng, seqmix.TransferMix(
        rng, list(range(1, N_ACCOUNTS + 1)), 60_000).batch(8))


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("route", ["fast", "general", "sequential"])
def test_queries_match_jax_and_oracle(route, lazy):
    t, j, ref = run_route(route, lazy)
    assert_index_equal(t.index, j.index)
    check_filters(t, j, ref, (1, 4, 99))
    assert_index_equal(t.index, j.index)  # a lazy index was rebuilt alike
    # One more batch after a query: appended (eager) or marked stale
    # (lazy), and the answers stay equal.
    commit3(t, j, ref, "create_transfers", extra_batch(route), 10 ** 10)
    check_filters(t, j, ref, (4,))
    assert_index_equal(t.index, j.index)


def test_invalid_filters_give_no_rows():
    t, j, ref = run_route("fast", False)
    for f in (filt(0), filt(U64M | (U64M << 64)), filt(1, ts_min=U64M),
              filt(1, ts_max=U64M), filt(1, ts_min=9, ts_max=8),
              filt(1, limit=0), filt(1, flags=REVERSED), filt(1, flags=8 | 1),
              filt(1, reserved=1)):
        assert t._filter_window(f) is None
        assert len(t.get_account_transfers(f)) == 0
        assert len(t.get_account_history(f)) == 0
        same_rows(t.get_account_transfers(f), j.get_account_transfers(f), "bad")


def history_ledgers():
    """A sequential-path ledger whose history log holds rolled-back rows
    above its count, as a port ledger and a JAX ledger of the same bytes."""
    t, j, ref = run_route("sequential", False, seed=3)
    # A linked chain through HISTORY accounts 4 and 11 whose last member
    # fails: its history rows are written, then popped with the count.
    F = types.TransferFlags
    commit3(t, j, ref, "create_transfers", types.transfers_array([
        types.transfer(id=900_001, debit_account_id=4, credit_account_id=1,
                       amount=5, ledger=1, code=10, flags=F.LINKED),
        types.transfer(id=900_002, debit_account_id=1, credit_account_id=11,
                       amount=5, ledger=1, code=10, flags=F.LINKED),
        types.transfer(id=900_003, debit_account_id=1, credit_account_id=6,
                       amount=5, ledger=0, code=10)]), 10 ** 10)
    arrays = convert.ledger_to_numpy(t.ledger)
    h = arrays["history"]
    count = int(h["count"])
    assert count > 16 and h["cols"]["timestamp"][count:].any(), \
        "the mix must leave a rolled-back tail above the count"
    jl = jsm.Ledger(
        accounts=None, transfers=None, posted=None,
        history=jsm.History(cols={k: jnp.asarray(v) for k, v in h["cols"].items()},
                            count=jnp.asarray(h["count"])))
    return t.ledger, jl


@pytest.fixture(scope="module")
def hist():
    return history_ledgers()


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("want", [(True, True), (True, False), (False, True)])
def test_scan_history_matches_jax(hist, want, descending):
    port, jl = hist
    cap = port.history.capacity
    ts = convert.tensor_to_array(port.history.cols["timestamp"])
    for acct, ts_min, ts_max, k in ((4, 1, U64M - 1, cap), (5, 1, U64M - 1, cap),
                                    (4, 1, U64M - 1, 8),
                                    (11, int(ts[5]), int(ts[30]), cap),
                                    (99, 1, U64M - 1, 8)):
        wv, wr = jq.scan_history(jl, jnp.uint64(acct), jnp.uint64(0),
                                 jnp.uint64(ts_min), jnp.uint64(ts_max),
                                 jnp.bool_(want[0]), jnp.bool_(want[1]),
                                 jnp.bool_(descending), k)
        gv, gr = tq.scan_history(port, acct, 0, ts_min, ts_max, want[0],
                                 want[1], descending, k)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        assert sorted(gr) == sorted(wr)
        for name in wr:
            np.testing.assert_array_equal(convert.tensor_to_array(gr[name]),
                                          np.asarray(wr[name]), err_msg=name)


@pytest.mark.parametrize("route", ["general", "sequential"])
def test_history_log_timestamps_increase_below_count(route):
    """What K16 relies on (and checks on the card): on every commit path
    that appends history, the rows below ``count`` carry strictly increasing
    timestamps."""
    t, j, _ = run_route(route, False, seed=7)
    h = convert.ledger_to_numpy(t.ledger)["history"]
    count = int(h["count"])
    assert count > 1
    ts = h["cols"]["timestamp"][:count]
    assert (ts[1:] > ts[:-1]).all()
    np.testing.assert_array_equal(
        ts, np.asarray(j.ledger.history.cols["timestamp"])[:count])
