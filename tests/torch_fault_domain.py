"""Shared inputs of tests/test_torch_scrub.py and tests/test_torch_merkle.py:
the reference tests' batches (tests/test_scrub.py, tests/test_merkle.py),
ledgers left by the port's fast, general, sequential and tiered routes, and
the conversions that hand one ledger to both packages."""

import random

import jax.numpy as jnp
import numpy as np

import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu import types
from tigerbeetle_tpu.config import LedgerConfig
from tigerbeetle_tpu.ops import hash_table as jht
from tigerbeetle_tpu.ops import state_machine as jsm
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.machine import TorchStateMachine

LANES = 64
CFG = LedgerConfig(
    accounts_capacity_log2=10, transfers_capacity_log2=12,
    posted_capacity_log2=10,
)
N_ACCOUNTS = 16
ROUTES = ("fast", "general", "sequential", "tiered")


def accounts_batch(flags=0):
    return types.accounts_array([
        types.account(id=i + 1, ledger=1, code=10, flags=flags)
        for i in range(N_ACCOUNTS)
    ])


def plain_batch(first_id, n, zipf=False):
    rng = random.Random(first_id)
    return types.transfers_array([
        types.transfer(
            id=first_id + i,
            debit_account_id=(
                1 + min(int(rng.paretovariate(1.2)), N_ACCOUNTS - 1)
                if zipf else 1 + i % N_ACCOUNTS
            ),
            credit_account_id=1 + (i + 3) % N_ACCOUNTS,
            amount=3 + i % 5, ledger=1, code=10,
        )
        for i in range(n)
    ])


def two_phase_batches(first_id, n, missing=()):
    """Pendings, then a batch posting the even ones and voiding the odd
    ones; ``missing`` adds posts of pending ids that do not exist."""
    pend = types.transfers_array([
        types.transfer(
            id=first_id + i, debit_account_id=1 + i % N_ACCOUNTS,
            credit_account_id=1 + (i + 5) % N_ACCOUNTS, amount=10,
            ledger=1, code=10, flags=types.TransferFlags.PENDING,
        )
        for i in range(n)
    ])
    rows = [
        types.transfer(
            id=first_id + 500 + i, pending_id=first_id + i, ledger=1,
            code=10,
            flags=(
                types.TransferFlags.POST_PENDING_TRANSFER if i % 2 == 0
                else types.TransferFlags.VOID_PENDING_TRANSFER
            ),
        )
        for i in range(n)
    ]
    rows += [
        types.transfer(id=first_id + 900 + k, pending_id=pid, ledger=1,
                       code=10,
                       flags=types.TransferFlags.POST_PENDING_TRANSFER)
        for k, pid in enumerate(missing)
    ]
    return [pend, types.transfers_array(rows)]


def linked_batch(first_id, n):
    rows = []
    for i in range(n):
        rows.append(types.transfer(
            id=first_id + i, debit_account_id=1 + i % N_ACCOUNTS,
            credit_account_id=1 + (i + 2) % N_ACCOUNTS, amount=2,
            ledger=1, code=10,
            flags=types.TransferFlags.LINKED if i % 4 != 3 else 0,
        ))
    return types.transfers_array(rows)


def drive_mixes(m):
    """tests/test_merkle.py's mixed stream."""
    out = [m.create_accounts(accounts_batch(), wall_clock_ns=1000)]
    out.append(m.create_transfers(plain_batch(1000, 24)))
    out.append(m.create_transfers(plain_batch(2000, 20, zipf=True)))
    for b in two_phase_batches(3000, 8):
        out.append(m.create_transfers(b))
    out.append(m.create_transfers(linked_batch(5000, 12)))
    out.append(m.create_transfers(plain_batch(6000, 16)))
    return out


def route_machine(route):
    """A port machine on the CPU for one route, and its transfer batches
    (the last is committed by the caller)."""
    kw = {}
    if route == "sequential":
        kw["force_sequential"] = True
    if route == "tiered":
        kw["hot_transfers_capacity_max"] = 1 << 12
    m = TorchStateMachine(CFG, batch_lanes=LANES, device="cpu", **kw)
    assert m.create_accounts(accounts_batch(), wall_clock_ns=1000) == []
    if route == "fast":
        batches = [plain_batch(1000, 24), plain_batch(2000, 20, zipf=True)]
    elif route == "general":
        batches = [plain_batch(1000, 24), linked_batch(5000, 12)]
        batches += two_phase_batches(3000, 8, missing=(777_777,))
    elif route == "sequential":
        batches = [plain_batch(1000, 24), *two_phase_batches(3000, 8),
                   linked_batch(5000, 12)]
    else:
        batches = [plain_batch(1000 + 100 * k, 40) for k in range(4)]
        batches.append(two_phase_batches(3000, 8)[0])
        batches.append("evict")
        # Posts of hot pendings, of an evicted transfer (not pending) and of
        # an id that never existed.
        batches.append(two_phase_batches(3000, 8, missing=(1005, 888_888))[1])
    return m, batches


def commit(m, batch):
    if isinstance(batch, str):
        assert m.evict_cold(0.5) > 0
        return None
    return m.create_transfers(batch)


def route_states(route):
    """(ledger arrays before the last batch, after it, the last batch,
    the cold runs) of a route, as numpy."""
    m, batches = route_machine(route)
    for b in batches[:-1]:
        commit(m, b)
    before = convert.ledger_to_numpy(m.ledger)
    commit(m, batches[-1])
    after = convert.ledger_to_numpy(m.ledger)
    return before, after, batches[-1], [np.asarray(r) for r in m.cold.runs]


def jax_table(d):
    return jht.Table(
        key_lo=jnp.asarray(d["key_lo"]), key_hi=jnp.asarray(d["key_hi"]),
        tombstone=jnp.asarray(d["tombstone"]),
        cols={k: jnp.asarray(v) for k, v in d["cols"].items()},
        count=jnp.asarray(d["count"]),
        probe_overflow=jnp.asarray(d["probe_overflow"]))


def jax_ledger(arrays):
    h = arrays["history"]
    return jsm.Ledger(
        accounts=jax_table(arrays["accounts"]),
        transfers=jax_table(arrays["transfers"]),
        posted=jax_table(arrays["posted"]),
        history=jsm.History(
            cols={k: jnp.asarray(v) for k, v in h["cols"].items()},
            count=jnp.asarray(h["count"])))


def assert_ledgers_equal(got, want):
    """Two exchange dicts, array by array."""
    for name in ("accounts", "transfers", "posted"):
        for k in ("key_lo", "key_hi", "tombstone", "count", "probe_overflow"):
            np.testing.assert_array_equal(got[name][k], want[name][k],
                                          err_msg=f"{name}/{k}")
        for k in want[name]["cols"]:
            np.testing.assert_array_equal(got[name]["cols"][k],
                                          want[name]["cols"][k],
                                          err_msg=f"{name}/{k}")
    np.testing.assert_array_equal(got["history"]["count"],
                                  want["history"]["count"])
    for k in want["history"]["cols"]:
        np.testing.assert_array_equal(got["history"]["cols"][k],
                                      want["history"]["cols"][k],
                                      err_msg=f"history/{k}")
