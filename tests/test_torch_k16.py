"""K16 ``history_scan``'s plain forms on ``testing/k16cases.py``'s traps
against the JAX package's ``ops/query.scan_history``, on the CPU, exactly
(integers only: every output array, the invalid positions included): the
plain version (the CPU route) and the split form that mirrors the card's
one pass (a match bitmap over blocks' ranges of 32-slot words, block
counts, closed-form positions), at the block count the kernel would launch
and at others.  The kernel itself is held against these on the card
(tests/test_torch_kernels.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu.ops import query as jq
from tigerbeetle_tpu.ops import state_machine as jsm
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.ops import query as tq
from tigerbeetle_tpu_torch.ops import state_machine as tsm
from tigerbeetle_tpu_torch.testing import k16cases

CPU = torch.device("cpu")


def ledgers(log):
    port = tsm.Ledger(accounts=None, transfers=None, posted=None,
                      history=tsm.History(
                          cols={k: convert.array_to_tensor(v, CPU)
                                for k, v in log["cols"].items()},
                          count=torch.tensor(int(log["count"]))))
    jax_ = jsm.Ledger(accounts=None, transfers=None, posted=None,
                      history=jsm.History(
                          cols={k: jnp.asarray(v) for k, v in log["cols"].items()},
                          count=jnp.asarray(log["count"])))
    return port, jax_


def jax_scan(jl, q):
    acct_lo, acct_hi, ts_min, ts_max, dr, cr, desc, k = q
    valid, rows = jq.scan_history(jl, jnp.uint64(acct_lo), jnp.uint64(acct_hi),
                                  jnp.uint64(ts_min), jnp.uint64(ts_max),
                                  jnp.bool_(dr), jnp.bool_(cr), jnp.bool_(desc), k)
    return np.asarray(valid), {n: np.asarray(v) for n, v in rows.items()}


def assert_same(got, want, what):
    np.testing.assert_array_equal(got[0].numpy(), want[0], err_msg=what)
    assert sorted(got[1]) == sorted(want[1])
    for name, v in want[1].items():
        np.testing.assert_array_equal(convert.tensor_to_array(got[1][name]), v,
                                      err_msg=f"{what} {name}")


@pytest.mark.parametrize("name", k16cases.CASES)
def test_k16_cases_match_jax(name):
    """Every trap query: the plain version and the split form at the
    kernel's block count and at 1, 3 and 7 blocks, against JAX."""
    log, queries = k16cases.case(name)
    port, jl = ledgers(log)
    cap = len(log["cols"]["timestamp"])
    matched = 0
    for q in queries:
        want = jax_scan(jl, q)
        matched += int(want[0].sum())
        assert_same(tq.scan_history(port, *q), want, f"{name} {q} plain")
        for blocks in sorted({k16cases.blocks_for(cap), 1, 3, 7}):
            valid, rows, err = tq.scan_history_split_plain(port, *q,
                                                           blocks=blocks)
            assert not err
            assert_same((valid, rows), want, f"{name} {q} split {blocks}")
    if name not in ("count_zero", "empty_window"):
        assert matched, "the case's queries match no row"


def test_k16_edge_matches_sit_on_the_ranges_edges():
    """``edge_matches`` puts its rows on the first and last slot of each
    block's range, for the block count asked."""
    for blocks in (1, 3, 4):
        log, _ = k16cases.case("edge_matches", blocks)
        c = log["cols"]
        count = int(log["count"])
        per = -(-((count + 31) // 32) // blocks) * 32
        hits = np.flatnonzero((c["dr_id_lo"][:count] == k16cases.ACCT)
                              | (c["cr_id_lo"][:count] == k16cases.ACCT))
        edges = {s for b in range(blocks) for s in (b * per, min((b + 1) * per,
                                                                 count) - 1)
                 if b * per < count}
        assert set(hits.tolist()) == edges


def test_k16_unordered_log_sets_the_error_word():
    """A log whose timestamps below the count do not increase sets the
    split form's error word (the kernel's, which ``scan_history`` raises
    on); an ordered one never does."""
    log, queries = k16cases.case(k16cases.UNORDERED)
    port, _ = ledgers(log)
    for blocks in (1, 4):
        assert tq.scan_history_split_plain(port, *queries[0], blocks=blocks)[2]
    with pytest.raises(RuntimeError, match="do not increase"):
        tq.check_order(1)
    tq.check_order(0)


def test_k16_order_word_rides_the_rows_read_back():
    """``get_account_history``'s one read-back: the rows as
    ``tensors_to_arrays`` gives them and the error word beside them."""
    rng = np.random.default_rng(16)
    cols = {"_valid": torch.from_numpy(rng.random(9) < 0.5),
            "a": convert.array_to_tensor(rng.integers(0, 1 << 64, 9,
                                                      dtype=np.uint64), CPU),
            "b": torch.from_numpy(rng.integers(0, 1 << 31, 9).astype(np.int32))}
    for word in (None, torch.tensor([0], dtype=torch.int32),
                 torch.tensor([1], dtype=torch.int32)):
        got, w = convert.tensors_and_word_to_arrays(cols, word)
        want = convert.tensors_to_arrays(cols)
        assert w == (0 if word is None else int(word))
        for name in want:
            assert got[name].dtype == want[name].dtype
            np.testing.assert_array_equal(got[name], want[name])
    valid, rows, err = tq.scan_history_deferred(
        ledgers(k16cases.case("sides")[0])[0], *k16cases.case("sides")[1][0])
    assert err is None and valid.dtype == torch.bool
