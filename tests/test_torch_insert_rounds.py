"""K2's round form (more than 8,192 lanes: round 0 over the batch, then
rounds over the walkers left, ``claim_rounds_plain``; a fresh table's rows
written whole, ``write_rows_fill_plain``) against the JAX package's
``claim_slots``, ``insert``, ``grow`` and ``drop_evicted``, slot for slot
and on every table array, on ``testing/k2cases.py``'s round cases."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu.ops import cold as jcold
from tigerbeetle_tpu.ops import hash_table as jht
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.ops import _cuda
from tigerbeetle_tpu_torch.ops import hash_table as tht
from tigerbeetle_tpu_torch.testing import k2cases as k2

CPU = torch.device("cpu")
jax_claim = jax.jit(jht.claim_slots, static_argnums=(4, 5))


def jax_table(a):
    return jht.Table(key_lo=jnp.asarray(a["key_lo"]),
                     key_hi=jnp.asarray(a["key_hi"]),
                     tombstone=jnp.asarray(a["tombstone"]),
                     cols={k: jnp.asarray(v) for k, v in a["cols"].items()},
                     count=jnp.asarray(a["count"]),
                     probe_overflow=jnp.asarray(a["probe_overflow"]))


def assert_tables_equal(port, jax_t):
    want, got = convert.table_arrays(jax_t), convert.table_to_numpy(port)
    for k in ("key_lo", "key_hi", "tombstone", "count", "probe_overflow"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in want["cols"]:
        np.testing.assert_array_equal(got["cols"][k], want["cols"][k], err_msg=k)


def t64(a):
    return convert.array_to_tensor(np.asarray(a, np.uint64), CPU)


def unwritten(t):
    """What a table's unwritten arrays might hold: keys, tombstones and
    columns that are not zero."""
    for x in (t.key_lo, t.key_hi, *t.cols.values()):
        x.fill_(7)
    t.tombstone.fill_(True)


@pytest.mark.parametrize("case", sorted(k2.ROUND_CASES))
def test_round_form_matches_jax(case):
    """Claims and overflow of the round form's plain version equal JAX's
    ``claim_slots`` (the claim entry's flag is that overflow); its insert
    (the claims, then the rows) equals JAX's ``insert`` on every table
    array."""
    arrays, lo, mask, max_probe, shift = k2.ROUND_CASES[case]()
    n = len(lo)
    assert n > _cuda.INSERT_SPLIT_MAX_N
    lo = np.asarray(lo, np.uint64)
    hi = np.zeros(n, np.uint64)
    vals = lo * np.uint64(3)
    jt, tt = jax_table(arrays), k2.table_from_arrays(arrays, CPU)
    tmask = torch.from_numpy(np.asarray(mask))
    jc, jo = jax_claim(jt, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(mask),
                       max_probe, shift)
    tc, to = tht.claim_rounds_plain(tt, t64(lo), t64(hi), tmask, max_probe,
                                    shift)
    np.testing.assert_array_equal(convert.tensor_to_array(tc), np.asarray(jc))
    assert bool(to) == bool(jo)
    if "max_probe" in case:
        assert bool(to)
    rows_j = {"val": jnp.asarray(vals), "tag": jnp.asarray(vals.astype(np.uint32))}
    rows_t = {"val": t64(vals),
              "tag": convert.array_to_tensor(vals.astype(np.uint32), CPU)}
    jt, jslots = jht.insert(jt, jnp.asarray(lo), jnp.asarray(hi),
                            jnp.asarray(mask), rows_j, max_probe, shift)
    tht.write_rows_plain(tt, t64(lo), t64(hi), tc, tmask, rows_t)
    tt.probe_overflow |= to
    np.testing.assert_array_equal(convert.tensor_to_array(tc), np.asarray(jslots))
    assert_tables_equal(tt, jt)


def test_round_form_grow_matches_jax():
    """``grow`` of a table with tombstones (2^14 -> 2^15 slots, every old
    slot a lane): the round form's claims into a fresh table none of whose
    arrays it reads, then every slot written whole, equal JAX's ``grow``;
    the tombstones are dropped."""
    arrays = k2.grow_case()
    cap = len(arrays["key_lo"])
    want = jht.grow(jax_table(arrays), 2 * cap)
    t = k2.table_from_arrays(arrays, CPU)
    live = (t.key_lo != 0) | (t.key_hi != 0)
    fresh = tht.make_table(2 * cap, {k: v.dtype for k, v in t.cols.items()}, CPU)
    unwritten(fresh)
    claimed, over = tht.claim_rounds_plain(fresh, t.key_lo, t.key_hi, live,
                                           2 * cap, fresh=True)
    assert not bool(over)
    tht.write_rows_fill_plain(fresh, t.key_lo, t.key_hi, claimed, live, t.cols)
    assert_tables_equal(fresh, want)
    assert int(fresh.tombstone.sum()) == 0
    assert_tables_equal(tht.grow(t, 2 * cap), want)


@pytest.mark.parametrize("keep", ["none", "some", "all"])
def test_round_form_drop_evicted_matches_jax(keep):
    """The cold tier's rebuild (``drop_evicted``) keeping none, some and all
    of the live rows: the keep mask, the round form's claims and the
    writes of the fresh table whole equal JAX's ``drop_evicted``."""
    from tigerbeetle_tpu_torch.ops import cold

    arrays, thr, want_keep = k2.evict_case(keep)
    cap = len(arrays["key_lo"])
    want = jcold.drop_evicted(jax_table(arrays), jnp.uint64(thr))
    t = k2.table_from_arrays(arrays, CPU)
    thr_t = t64(np.asarray([thr]))[0]
    mask = cold.keep_mask_plain(t, thr_t)
    np.testing.assert_array_equal(mask.numpy(), want_keep)
    fresh = tht.make_table(cap, {k: v.dtype for k, v in t.cols.items()}, CPU)
    unwritten(fresh)
    claimed, over = tht.claim_rounds_plain(fresh, t.key_lo, t.key_hi, mask, cap,
                                           fresh=True)
    assert not bool(over)
    tht.write_rows_fill_plain(fresh, t.key_lo, t.key_hi, claimed, mask, t.cols)
    assert_tables_equal(fresh, want)
    assert int(fresh.count) == int(want_keep.sum())
    assert_tables_equal(cold.drop_evicted(t, thr_t), want)


def test_round_constants_match_the_cuda_source():
    """The tail's walker limit that the wrappers and the plain form name is
    insert.cu's."""
    src = (Path(_cuda.CSRC) / "insert.cu").read_text()
    assert int(re.search(r"#define TAIL_MAX (\d+)", src).group(1)) \
        == _cuda.INSERT_TAIL_MAX


def test_round_form_refuses_too_many_lanes():
    """The round form's lanes are int32: a larger insert raises before
    anything is allocated or launched, naming the count."""
    with pytest.raises(_cuda.CudaKernelError, match=str(1 << 31)):
        _cuda.insert_scratch(1 << 31, 1 << 20, torch.device("meta"))
