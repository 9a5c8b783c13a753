"""The flagship bench twin (``python -m tigerbeetle_tpu_torch.bench``) and
its generator on the CPU.

- The generator (``utils.benchgen.gen_batch_plain``, kernel K20's plain
  version) against the JAX package's ``gen_plain`` and ``gen_twop``
  (jitted on the CPU) and against the host generators ``gen_batch_np`` and
  ``gen_two_phase_np`` (bench.py's own numpy mirror), byte for byte, for
  batch indexes where ``b * count + lane`` passes 2^32 and account counts
  where the modulo takes every branch.
- The twin's ``main`` on the CPU at 2,048 accounts and 16,380 transfers for
  the plain, ``--two-phase`` and ``--limits`` shapes: its JSON line, and
  every account's balances equal to those of a ``TorchStateMachine`` fed
  the same batches.

K20 is held against its plain version on the card in
tests/test_torch_kernels.py and chip_smoke.py."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu.utils import benchgen as jgen
from tigerbeetle_tpu_torch import bench, convert, types
from tigerbeetle_tpu_torch.config import LedgerConfig
from tigerbeetle_tpu_torch.machine import TorchStateMachine
from tigerbeetle_tpu_torch.utils import benchgen

CPU = torch.device("cpu")
LANES, COUNT = 8192, 8190
BATCHES = [0, 1, 1 << 20, (1 << 32) // COUNT + 1]
ACCOUNTS = [2, 64, 10_000]


def soa_np(soa):
    return {k: convert.tensor_to_array(v) for k, v in soa.items()}


def padded_soa(batch, lanes):
    full = np.zeros(lanes, dtype=types.TRANSFER_DTYPE)
    full[:len(batch)] = batch
    return types.to_soa(full)


def assert_soa_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("n", ACCOUNTS)
@pytest.mark.parametrize("b", BATCHES)
def test_plain_generator_matches_jax_and_numpy(b, n):
    got = soa_np(benchgen.gen_batch(b, LANES, COUNT, n, 1 << 35, device="cpu"))
    fn = jax.jit(jgen.gen_plain,
                 static_argnames=("lanes", "count", "n_accounts"))
    want = fn(jnp.uint64(b), lanes=LANES, count=COUNT, n_accounts=n)
    assert_soa_equal(got, {k: np.asarray(v) for k, v in want.items()})
    assert_soa_equal(got, padded_soa(
        benchgen.gen_batch_np(b, LANES, COUNT, n, 1 << 35), LANES))


@pytest.mark.parametrize("n", ACCOUNTS)
@pytest.mark.parametrize("b", BATCHES)
def test_two_phase_generators_match_jax_and_numpy(b, n):
    got = soa_np(benchgen.gen_twop(b, LANES, COUNT, n, device="cpu"))
    fn = jax.jit(jgen.gen_twop,
                 static_argnames=("lanes", "count", "n_accounts"))
    want = fn(jnp.uint64(b), lanes=LANES, count=COUNT, n_accounts=n)
    assert_soa_equal(got, {k: np.asarray(v) for k, v in want.items()})
    got = soa_np(benchgen.gen_batch(b, LANES, COUNT, n, 1 << 32,
                                    two_phase=True, device="cpu"))
    assert_soa_equal(got, padded_soa(
        benchgen.gen_two_phase_np(b, LANES, COUNT, n, 1 << 32), LANES))


def test_generator_writes_in_place_and_checks_its_arguments():
    out = benchgen.empty_soa(64, CPU)
    same = benchgen.gen_batch(3, 64, 60, 100, 7, out=out)
    assert same is out
    assert_soa_equal(soa_np(out), padded_soa(
        benchgen.gen_batch_np(3, 64, 60, 100, 7), 64))
    for bad in ({"n_accounts": 1}, {"n_accounts": 1 << 31}, {"count": 65}):
        kw = {"b": 0, "lanes": 64, "count": 60, "n_accounts": 100,
              "first_tid": 1, **bad}
        with pytest.raises(ValueError):
            benchgen.gen_batch(**kw, device="cpu")


def machine_balances(shape, n_accounts, n_transfers, count, lanes):
    """A TorchStateMachine fed the twin's batches, account for account."""
    m = TorchStateMachine(LedgerConfig(), batch_lanes=lanes, device="cpu")
    if shape == "limits":
        for b in benchgen.gen_limit_accounts_np(n_accounts, count):
            assert m.create_accounts(b) == []
        for b in benchgen.gen_funding_np(n_accounts, count):
            assert m.create_transfers(b) == []
    else:
        for start in range(0, n_accounts, count):
            ids = range(start + 1, min(n_accounts, start + count) + 1)
            assert m.create_accounts(types.accounts_array(
                [types.account(id=i, ledger=1, code=10) for i in ids])) == []
    _n, k, timed = bench.plan(n_transfers, count)
    for b in range(k + timed):
        batch = (benchgen.gen_two_phase_np if shape == "two_phase"
                 else benchgen.gen_batch_np)(b, lanes, count, n_accounts,
                                             bench.FIRST_TID)
        assert m.create_transfers(batch) == []
    return m.ledger


@pytest.mark.parametrize("shape", ["plain", "two_phase", "limits"])
def test_bench_twin_on_the_cpu(shape, capsys):
    argv = ["--device", "cpu", "--accounts", "2048", "--transfers", "16380",
            "--count", "1638", "--lanes", "2048"]
    if shape != "plain":
        argv.append("--" + shape.replace("_", "-"))
    assert bench.main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    payload = json.loads(line)
    assert payload["metric"] == bench.METRICS[shape]
    assert payload["unit"] == "tx/s" and payload["value"] > 0
    assert payload["per_batch_us"] > 0 and payload["device"] == "cpu"
    # No card, so no device idle share: it is not measured, not zero.
    assert payload["device_idle_share"] is None
    assert payload["parity"] is True
    assert {"rep_tx_s", "batches", "timed_batches"} <= set(payload)

    _payload, ledger = bench.run(bench.parse_args(argv + ["--skip-parity"]))
    want = machine_balances(shape, 2048, 16380, 1638, 2048)
    ids = list(range(1, 2048 + 1 + (shape == "limits")))
    lo = torch.tensor(ids, dtype=torch.int64)
    from tigerbeetle_tpu_torch.ops import state_machine as sm

    found_t, got = sm.lookup_accounts(ledger, lo, torch.zeros_like(lo))
    found_m, exp = sm.lookup_accounts(want, lo, torch.zeros_like(lo))
    assert bool(found_t.all()) and bool(found_m.all())
    for c in sm.BALANCE_COLS + ("timestamp",):
        assert torch.equal(got[c], exp[c]), c
    assert int(got["debits_posted_lo"].sum()) > 0
