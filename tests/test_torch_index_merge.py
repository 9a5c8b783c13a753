"""K14 ``run_merge``'s own steps in plain PyTorch (``_merge_tiles_plain``:
tiles cut at the 32-ary search's merge-path splits; ``_rounds_split_plain``:
a full build's rounds over live prefixes, then the tail) against the JAX
package's ``_merge`` (carries into levels 1-6), ``_full_build_side`` and
``_full_build_field``, on ``testing/k14cases.py``'s inputs."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu.config import LedgerConfig
from tigerbeetle_tpu.ops import index as jix
from tigerbeetle_tpu.ops import scan_builder as jsb
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.ops import _cuda
from tigerbeetle_tpu_torch.ops import index as tix
from tigerbeetle_tpu_torch.ops import scan_builder as tsb
from tigerbeetle_tpu_torch.testing import k14cases

CPU = torch.device("cpu")
U64M = (1 << 64) - 1


def port_level(block):
    return tix.Level(convert.array_to_tensor(np.ascontiguousarray(block), CPU))


def jax_level(block):
    return {c: jnp.asarray(block[k]) for k, c in enumerate(tix.COLS)}


def assert_level(got, want, what):
    for c in tix.COLS:
        np.testing.assert_array_equal(convert.tensor_to_array(got[c]),
                                      np.asarray(want[c]), err_msg=f"{what}/{c}")


@pytest.mark.parametrize("mode", k14cases.CARRY_MODES)
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6])
def test_carry_split_form_matches_jax(k, mode):
    """A carry into level k (run + levels 0..k-1, base 64: level 6 has
    4,096 entries, two tiles) by K14's tiled pairwise chain equals JAX's
    concatenate-and-sort ``_merge``; the earlier source wins ties."""
    blocks = k14cases.carry(64, k, mode)
    want = jix._merge_jit([jax_level(b) for b in blocks])
    got = tix._merge_sides_split_plain([[port_level(b) for b in blocks]])[0]
    assert_level(got, want, f"carry into {k}, {mode}")


@pytest.mark.parametrize("case", k14cases.PAIR_CASES)
def test_pair_split_form_matches_jax(case):
    """One pairwise merge: A or B empty, equal keys across a tile's edge,
    sentinels beside live entries keyed by the sentinel key."""
    a, b = k14cases.pair(case)
    want = jix._merge_jit([jax_level(a), jax_level(b)])
    got = tix._merge_tiles_plain(port_level(a), port_level(b), a.shape[1],
                                 b.shape[1])
    assert_level(got, want, case)


def _jax_sorted(cols, use, n_out):
    """JAX's ``_sort_level`` of a full build's input: sentinels where not
    live and in the padding up to ``n_out``."""
    lvl = {}
    for name, c in zip(tix.COLS, cols):
        v = np.where(use, c, np.uint64(U64M))
        lvl[name] = jnp.asarray(np.concatenate(
            [v, np.full(n_out - len(v), U64M, np.uint64)]))
    return jix._sort_level(lvl)


@pytest.mark.parametrize("mode", k14cases.BUILD_MODES)
@pytest.mark.parametrize("n", k14cases.BUILD_SIZES)
def test_build_rounds_split_form_matches_jax(n, mode):
    """A full build by K13's chunks, then K14's rounds over the runs' live
    prefixes and the tail (unfused at 8,192 entries: three rounds; four at
    2^14): every column equals JAX's lexsort, the sentinel-keyed entries
    in position order."""
    cols, use = k14cases.entries(n, mode)
    got = tix._sort_rounds_split_plain(
        [convert.array_to_tensor(c, CPU) for c in cols], torch.from_numpy(use),
        n, fused=n > 8192)
    assert_level(got, _jax_sorted(cols, use, n), f"{mode} n={n}")


@pytest.fixture(scope="module")
def ledger():
    """A small ledger (tables of 2^10 slots) with transfers, some slots
    turned into tombstones, as a JAX ledger and a port ledger."""
    from test_torch_index import jax_ledger  # the shared fixture's builders
    from tigerbeetle_tpu import types
    from tigerbeetle_tpu.machine import TpuStateMachine

    cfg = LedgerConfig(accounts_capacity_log2=10, transfers_capacity_log2=10,
                       posted_capacity_log2=10, history_capacity_log2=10,
                       max_probe=1 << 9)
    m = TpuStateMachine(cfg, batch_lanes=64)
    rng = np.random.default_rng(17)
    assert m.create_accounts(types.accounts_array([
        types.account(id=i + 1, ledger=1, code=10, user_data_64=i % 5)
        for i in range(16)]), wall_clock_ns=1000) == []
    tid = 5000
    for _ in range(4):
        specs = []
        for _ in range(60):
            dr, cr = rng.choice(16, size=2, replace=False)
            specs.append(types.transfer(
                id=tid, debit_account_id=int(dr) + 1,
                credit_account_id=int(cr) + 1, amount=1, ledger=1, code=10,
                user_data_64=int(rng.integers(0, 4))))
            tid += 1
        assert m.create_transfers(types.transfers_array(specs)) == []
    arrays = convert.ledger_arrays(m.ledger)
    t = arrays["transfers"]
    for k in ("key_lo", "key_hi", "tombstone"):
        t[k] = np.array(t[k])
    dead = rng.choice(np.flatnonzero(t["key_lo"] != 0), size=20, replace=False)
    t["key_lo"][dead] = 0
    t["key_hi"][dead] = 0
    t["tombstone"][dead] = True
    return jax_ledger(arrays), convert.ledger_from_numpy(arrays, CPU)


@pytest.mark.parametrize("side", ["debit_account_id", "credit_account_id"])
def test_full_build_side_split_form_matches_jax(ledger, side):
    """``_full_build_side`` at 2^14 entries (a transfers table of 2^10
    slots, padded): K13's chunks, K14's rounds and tail equal JAX's."""
    jl, tl = ledger
    cap = 1 << 14
    t = tl.transfers
    cols = [t.cols[side + "_lo"], t.cols[side + "_hi"], t.cols["timestamp"],
            t.key_lo, t.key_hi]
    got = tix._sort_rounds_split_plain(cols, tix._live(t), cap)
    assert_level(got, jix._full_build_side(jl, side, cap), side)


@pytest.mark.parametrize("table,field", [("transfers", "user_data_64"),
                                         ("accounts", "user_data_64")])
def test_full_build_field_split_form_matches_jax(ledger, table, field):
    """``FieldIndex``'s full build (``_full_build_field``) at 2^14 entries
    by the same route equals JAX's."""
    jl, tl = ledger
    specs = tsb.TRANSFER_FIELDS if table == "transfers" else tsb.ACCOUNT_FIELDS
    lo_col, hi_col = specs[field]
    t = getattr(tl, table)
    cap = 1 << 14
    cols = tsb._field_cols(t.cols, lo_col, hi_col, t.key_lo, t.key_hi)
    got = tix._sort_rounds_split_plain(cols, tix._live(t), cap)
    assert_level(got, jsb._full_build_field(jl, table, lo_col, hi_col, cap),
                 f"{table}.{field}")


def test_merge_tile_matches_the_cuda_source():
    """The tile the plain form cuts at is index_merge.cu's."""
    src = (Path(_cuda.CSRC) / "index_merge.cu").read_text()
    assert int(re.search(r"#define MERGE_TILE (\d+)", src).group(1)) \
        == _cuda.MERGE_TILE
