"""The port's transfer index and scan-builder device functions
(``tigerbeetle_tpu_torch/ops/index.py``, ``ops/scan_builder.py``; their plain
PyTorch versions on the CPU) against the JAX package's on the same inputs.
Tolerance: exact equality of every array, invalid lanes included (integers
only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu import types
from tigerbeetle_tpu.config import LedgerConfig
from tigerbeetle_tpu.machine import TpuStateMachine
from tigerbeetle_tpu.ops import hash_table as jht
from tigerbeetle_tpu.ops import index as jix
from tigerbeetle_tpu.ops import scan_builder as jsb
from tigerbeetle_tpu.ops import state_machine as jsm
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.ops import index as tix
from tigerbeetle_tpu_torch.ops import scan_builder as tsb
from tigerbeetle_tpu_torch.testing import k13cases

CPU = torch.device("cpu")
U64M = (1 << 64) - 1
LANES = 64
CFG = LedgerConfig(accounts_capacity_log2=10, transfers_capacity_log2=10,
                   posted_capacity_log2=10, history_capacity_log2=10,
                   max_probe=1 << 9)


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
        history=jsm.History(cols={k: jnp.asarray(v) for k, v in h["cols"].items()},
                            count=jnp.asarray(h["count"])))


def level_np(lvl):
    return {c: np.asarray(lvl[c]) if not torch.is_tensor(lvl[c])
            else convert.tensor_to_array(lvl[c]) for c in tix.COLS}


def assert_levels_equal(got, want, what=""):
    g, w = level_np(got), level_np(want)
    for c in tix.COLS:
        assert g[c].dtype == w[c].dtype == np.uint64, (what, c)
        np.testing.assert_array_equal(g[c], w[c], err_msg=f"{what}/{c}")


def assert_index_equal(port_idx, jax_idx):
    got = convert.index_levels_to_numpy(port_idx)
    want = convert.index_arrays(jax_idx)
    assert got["occupied"] == want["occupied"]
    assert got["stale"] == want["stale"]
    for name in ("dr_levels", "cr_levels", "levels"):
        if name not in want:
            continue
        assert len(got[name]) == len(want[name]), name
        for j, (g, w) in enumerate(zip(got[name], want[name])):
            for c in tix.COLS:
                np.testing.assert_array_equal(g[c], w[c],
                                              err_msg=f"{name}[{j}]/{c}")


@pytest.fixture(scope="module")
def world():
    """A JAX machine's ledger after varied commits, with some transfer slots
    turned into tombstones, as a JAX ledger and a port ledger (same bytes),
    plus the committed transfer ids and the machine."""
    m = TpuStateMachine(CFG, batch_lanes=LANES)
    rng = np.random.default_rng(11)
    n_acct = 24
    assert m.create_accounts(types.accounts_array([
        types.account(id=i + 1, ledger=1 + i % 3, code=10 * (1 + i % 2),
                      user_data_128=(i % 4) << 64 | (i % 4),
                      user_data_64=i % 5, user_data_32=i % 3)
        for i in range(n_acct)]), wall_clock_ns=1000) == []
    pools = {g: [i + 1 for i in range(n_acct) if i % 3 == g] for g in range(3)}
    tid = 1000
    for _ in range(5):
        specs = []
        for _ in range(48):
            g = int(rng.integers(0, 3))
            dr, cr = rng.choice(len(pools[g]), size=2, replace=False)
            specs.append(types.transfer(
                id=tid, debit_account_id=pools[g][dr],
                credit_account_id=pools[g][cr], amount=int(rng.integers(1, 9)),
                ledger=g + 1, code=int(rng.choice([10, 20, 30])),
                user_data_128=int(rng.integers(0, 4)) << 64 | 7,
                user_data_64=int(rng.integers(0, 5)),
                user_data_32=int(rng.integers(0, 3))))
            tid += 1
        assert m.create_transfers(types.transfers_array(specs)) == []
    arrays = convert.ledger_arrays(m.ledger)
    t = arrays["transfers"]
    for k in ("key_lo", "key_hi", "tombstone"):
        t[k] = np.array(t[k])
    live = np.flatnonzero(t["key_lo"] != 0)
    dead = rng.choice(live, size=12, replace=False)
    t["key_lo"][dead] = 0
    t["key_hi"][dead] = 0
    t["tombstone"][dead] = True
    ids = np.arange(1000, tid, dtype=np.uint64)
    return {"jax": jax_ledger(arrays), "port": convert.ledger_from_numpy(arrays, CPU),
            "ids": ids, "rng": rng, "machine": m}


def id_lanes(rng, ids, n, kind):
    """``n`` lanes of transfer ids (some absent, some zero) and an ok mask
    with none, some or all lanes set."""
    lo = rng.choice(ids, size=n)
    lo[rng.random(n) < 0.15] = 0
    lo[rng.random(n) < 0.1] = 77_777
    hi = np.zeros(n, np.uint64)
    ok = {"none": np.zeros(n, bool), "all": np.ones(n, bool),
          "some": rng.random(n) < 0.6}[kind]
    return lo, hi, ok


def tt(a):
    return convert.array_to_tensor(np.asarray(a), CPU)


@pytest.mark.parametrize("kind", ["none", "some", "all"])
def test_build_runs_matches_jax(world, kind):
    rng = np.random.default_rng(hash(kind) % 1000)
    lo, hi, ok = id_lanes(rng, world["ids"], LANES, kind)
    want = jix.build_runs(world["jax"], jnp.asarray(lo), jnp.asarray(hi),
                          jnp.asarray(ok))
    got = tix.build_runs(world["port"], tt(lo), tt(hi), torch.from_numpy(ok))
    for g, w, side in zip(got, want, ("dr", "cr")):
        assert_levels_equal(g, w, side)


def random_level(rng, n, fill):
    """A sorted level of ``n`` entries, the first ``fill`` real (repeated
    accounts and timestamps, so ties occur), the rest sentinels."""
    cols = {c: np.full(n, U64M, np.uint64) for c in tix.COLS}
    cols["acct_lo"][:fill] = rng.integers(1, 5, fill)
    cols["acct_hi"][:fill] = rng.integers(0, 2, fill)
    cols["ts"][:fill] = rng.integers(1, 40, fill)
    cols["tid_lo"][:fill] = rng.integers(1, 1 << 40, fill)
    cols["tid_hi"][:fill] = rng.integers(0, 3, fill)
    return jix._sort_level_jit({c: jnp.asarray(v) for c, v in cols.items()})


def test_merge_of_geometric_runs_matches_jax():
    rng = np.random.default_rng(3)
    levels = [random_level(rng, 16, 9), random_level(rng, 16, 16),
              random_level(rng, 32, 20), random_level(rng, 64, 64)]
    want = jix._merge_jit(levels)
    got = tix._merge([{c: tt(np.asarray(l[c])) for c in tix.COLS}
                      for l in levels])
    assert_levels_equal(got, want, "merge")


@pytest.mark.parametrize("pad", [1, 2])
@pytest.mark.parametrize("side", ["debit_account_id", "credit_account_id"])
def test_full_build_side_matches_jax(world, side, pad):
    cap = world["port"].transfers.capacity * pad
    want = jix._full_build_side(world["jax"], side, cap)
    got = tix._full_build_side(world["port"], side, cap)
    assert_levels_equal(got, want, side)


def test_add_host_rows_matches_jax(world):
    rows = world["machine"].lookup_transfers(
        [int(i) for i in world["ids"][:150]])
    j = jix.TransferIndex(base=LANES)
    t = tix.TransferIndex(base=LANES, device=CPU)
    for idx in (j, t):
        idx._add_host_rows(rows[:100])
        idx._add_host_rows(rows[100:])
        idx._add_host_rows(rows[:40])
    assert_index_equal(t, j)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("want", [(True, True), (True, False), (False, True),
                                  (False, False)])
def test_query_transfers_matches_jax(world, want, descending):
    m = world["machine"]
    assert sum(m.index.occupied) >= 2
    port = convert.index_from_numpy(convert.index_arrays(m.index),
                                    tix.TransferIndex(LANES, CPU))
    ts = np.sort(convert.ledger_arrays(m.ledger)["transfers"]["cols"]["timestamp"])
    ts = ts[ts != 0]
    for acct, ts_min, ts_max, k in ((1, 1, U64M - 1, 64), (4, 1, U64M - 1, 16),
                                    (7, int(ts[40]), int(ts[200]), 16),
                                    (2, int(ts[100]), U64M - 1, 16),
                                    (99, 1, U64M - 1, 16)):
        w = jix.query_transfers(
            tuple(m.index.dr_levels), tuple(m.index.cr_levels),
            jnp.uint64(acct), jnp.uint64(0), jnp.uint64(ts_min),
            jnp.uint64(ts_max), jnp.bool_(want[0]), jnp.bool_(want[1]),
            k, descending)
        g = tix.query_transfers(port.dr_levels, port.cr_levels, acct, 0,
                                ts_min, ts_max, want[0], want[1], k, descending)
        for a, b, name in zip(g, w, ("valid", "tid_lo", "tid_hi")):
            np.testing.assert_array_equal(
                a.numpy() if a.dtype == torch.bool else convert.tensor_to_array(a),
                np.asarray(b), err_msg=f"{name} acct={acct} k={k}")


def test_sentinel_only_levels_query_empty():
    j = jix.TransferIndex(base=16)
    t = tix.TransferIndex(base=16, device=CPU)
    j._ensure_level(2)
    t._ensure_level(2)
    w = j.query(None, jnp.uint64(3), jnp.uint64(0), jnp.uint64(1),
                jnp.uint64(U64M - 1), jnp.bool_(True), jnp.bool_(True), 16, True)
    g = t.query(None, 3, 0, 1, U64M - 1, True, True, 16, True)
    assert not g[0].any()
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a.numpy().astype(np.asarray(b).dtype),
                                      np.asarray(b))


def test_indexes_after_many_appends_match_jax(world):
    """40+ appends of 16-lane runs: carries reach level 5; the level arrays
    and occupancy of TransferIndex and two FieldIndexes equal the JAX
    ones."""
    base = 16
    rng = np.random.default_rng(9)
    jt, tt_ = jix.TransferIndex(base), tix.TransferIndex(base, CPU)
    jf = {f: jsb.FieldIndex(base, "transfers", *jsb.TRANSFER_FIELDS[f])
          for f in ("user_data_128", "code")}
    tf = {f: tsb.FieldIndex(base, "transfers", *tsb.TRANSFER_FIELDS[f], CPU)
          for f in jf}
    for f in jf:
        jf[f].stale = tf[f].stale = False  # maintained from empty
    for _ in range(41):
        lo, hi, ok = id_lanes(rng, world["ids"], base, "some")
        jargs = (world["jax"], jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(ok))
        targs = (world["port"], tt(lo), tt(hi), torch.from_numpy(ok))
        jt.append_batch(*jargs)
        tt_.append_batch(*targs)
        for f in jf:
            jf[f].append_batch(*jargs)
            tf[f].append_batch(*targs)
    assert len(tt_.occupied) >= 6 and tt_.occupied[5]
    assert_index_equal(tt_, jt)
    for f in jf:
        assert_index_equal(tf[f], jf[f])
        assert tf[f].capacity() == jf[f].capacity()


@pytest.mark.parametrize("table, fields", [
    ("transfers", list(tsb.TRANSFER_FIELDS)),
    ("accounts", list(tsb.ACCOUNT_FIELDS)),
])
def test_field_builders_match_jax(world, table, fields):
    specs = tsb.TRANSFER_FIELDS if table == "transfers" else tsb.ACCOUNT_FIELDS
    rng = np.random.default_rng(5)
    ids = world["ids"] if table == "transfers" else np.arange(1, 25, dtype=np.uint64)
    lo, hi, ok = id_lanes(rng, ids, LANES, "some")
    cap = getattr(world["port"], table).capacity
    for f in fields:
        lo_col, hi_col = specs[f]
        want = jsb._build_field_run(world["jax"], jnp.asarray(lo), jnp.asarray(hi),
                                    jnp.asarray(ok), table, lo_col, hi_col)
        got = tsb._build_field_run(world["port"], tt(lo), tt(hi),
                                   torch.from_numpy(ok), table, lo_col, hi_col)
        assert_levels_equal(got, want, f"run {f}")
        want = jsb._full_build_field(world["jax"], table, lo_col, hi_col, 2 * cap)
        got = tsb._full_build_field(world["port"], table, lo_col, hi_col, 2 * cap)
        assert_levels_equal(got, want, f"full {f}")


@pytest.mark.parametrize("descending", [False, True])
def test_leaf_window_matches_jax(world, descending):
    j = jsb.FieldIndex(LANES, "transfers", "code", None)
    j.rebuild(world["jax"])
    for _ in range(3):  # and a few appended runs beside the full build
        lo, hi, ok = id_lanes(world["rng"], world["ids"], LANES, "some")
        j.append_batch(world["jax"], jnp.asarray(lo), jnp.asarray(hi),
                       jnp.asarray(ok))
    t = convert.index_from_numpy(
        convert.index_arrays(j),
        tsb.FieldIndex(LANES, "transfers", "code", None, CPU))
    assert_index_equal(t, j)
    for value, ts_min, ts_max, k in ((10, 1, U64M - 1, 16), (20, 1, U64M - 1, 256),
                                     (30, 5000, U64M, 16), (11, 1, U64M - 1, 16)):
        w = jsb._leaf_window(tuple(j.levels), jnp.uint64(value), jnp.uint64(0),
                             jnp.uint64(ts_min), jnp.uint64(ts_max), k,
                             descending)
        g = tsb._leaf_window(t.levels, value, 0, ts_min, ts_max, k, descending)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(convert.tensor_to_array(a),
                                          np.asarray(b))


def _jax_sorted(cols, use, n_out):
    """JAX's ``_sort_level`` of the run as the port's callers mask it:
    sentinels where not ``use`` and in the padding up to ``n_out``."""
    lvl = {}
    for name, c in zip(tix.COLS, cols):
        v = np.where(use, c, np.uint64(U64M))
        lvl[name] = jnp.asarray(np.concatenate(
            [v, np.full(n_out - len(v), U64M, np.uint64)]))
    return jix._sort_level(lvl)


@pytest.mark.parametrize("mode", k13cases.MODES)
@pytest.mark.parametrize("n", k13cases.SIZES)
def test_sort_split_form_matches_jax(n, mode):
    """K13's own algorithm (chunks of 1,024 sorted, then merged by rank in
    one step) in plain PyTorch against JAX's lexsort: every column, the
    sentinels and the run length; equal keys across chunk boundaries keep
    their input order."""
    cols, use = k13cases.entries(n, mode)
    got, run = tix._sort_split_plain(
        [convert.array_to_tensor(c, CPU) for c in cols], torch.from_numpy(use), n)
    assert run == n
    want = _jax_sorted(cols, use, n)
    for name in tix.COLS:
        np.testing.assert_array_equal(convert.tensor_to_array(got[name]),
                                      np.asarray(want[name]), err_msg=name)


@pytest.mark.parametrize("n_in,n_out", k13cases.PADDED)
def test_sort_split_form_of_a_padded_run_matches_jax(n_in, n_out):
    """Entries past ``n_in`` up to ``n_out`` are sentinels; unfused, a run
    of several chunks stays in sorted chunks of 1,024."""
    cols, use = k13cases.entries(n_in, "ties", seed=1)
    tcols = [convert.array_to_tensor(c, CPU) for c in cols]
    got, run = tix._sort_split_plain(tcols, torch.from_numpy(use), n_out)
    assert run == n_out
    want = _jax_sorted(cols, use, n_out)
    for name in tix.COLS:
        np.testing.assert_array_equal(convert.tensor_to_array(got[name]),
                                      np.asarray(want[name]), err_msg=name)
    if n_out % 1024 == 0 and n_out > 1024:
        chunks, run = tix._sort_split_plain(tcols, torch.from_numpy(use), n_out,
                                            fused=False)
        assert run == 1024
        for k in range(0, n_out, 1024):
            part = {name: jnp.asarray(np.concatenate(
                [np.where(use, c, np.uint64(U64M)),
                 np.full(n_out - n_in, U64M, np.uint64)])[k:k + 1024])
                for name, c in zip(tix.COLS, cols)}
            w = jix._sort_level(part)
            for name in tix.COLS:
                np.testing.assert_array_equal(
                    convert.tensor_to_array(chunks[name][k:k + 1024]),
                    np.asarray(w[name]), err_msg=f"{name} chunk {k}")
