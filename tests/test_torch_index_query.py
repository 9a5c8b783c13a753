"""K15 ``index_window``'s plain versions against the JAX package on the
traps of ``testing/k15cases.py``: ``query_transfers_split_plain`` (the
union kernel's own steps: the windows' bounds by the 32-ary search, the
prune key, the merge by rank and the closed-form tail) and
``query_transfers_plain`` against ``query_transfers``; ``_query_side_plain``
against ``_query_side``; the 32-ary search against ``_search3``.  Every
output array, invalid lanes included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu.ops import index as jix
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.ops import index as tix
from tigerbeetle_tpu_torch.testing import k15cases

CPU = torch.device("cpu")
U64M = (1 << 64) - 1


def port_levels(blocks):
    return [tix.Level(convert.array_to_tensor(b, CPU)) for b in blocks]


def jax_levels(blocks):
    return tuple({c: jnp.asarray(b[i]) for i, c in enumerate(tix.COLS)}
                 for b in blocks)


def as_np(t):
    return t.numpy() if t.dtype == torch.bool else convert.tensor_to_array(t)


@pytest.mark.parametrize("case", k15cases.CASES)
def test_query_forms_match_jax(case):
    dr, cr, queries = k15cases.case(case)
    tdr, tcr = port_levels(dr), port_levels(cr)
    jdr, jcr = jax_levels(dr), jax_levels(cr)
    for q in queries:
        acct_lo, acct_hi, ts_min, ts_max, want_dr, want_cr, k, desc = q
        want = jix.query_transfers(
            jdr, jcr, jnp.uint64(acct_lo), jnp.uint64(acct_hi),
            jnp.uint64(ts_min), jnp.uint64(ts_max), jnp.bool_(want_dr),
            jnp.bool_(want_cr), k, desc)
        for fn in (tix.query_transfers_split_plain, tix.query_transfers_plain):
            got = fn(tdr, tcr, *q)
            for a, b, name in zip(got, want, ("valid", "tid_lo", "tid_hi")):
                np.testing.assert_array_equal(as_np(a), np.asarray(b),
                                              err_msg=f"{fn.__name__} {name} {q}")
        for tside, jside in ((tdr, jdr), (tcr, jcr)):
            if not tside:
                continue
            w = jix._query_side(jside, jnp.uint64(acct_lo), jnp.uint64(acct_hi),
                                jnp.uint64(ts_min), jnp.uint64(ts_max), k, desc)
            g = tix._query_side_plain(tside, acct_lo, acct_hi, ts_min, ts_max,
                                      k, desc)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(as_np(a), np.asarray(b),
                                              err_msg=f"window {q}")


@pytest.mark.parametrize("case", k15cases.CASES)
def test_search32_matches_the_jax_search(case):
    """On every level of the case and at each query's window start (ts_min
    ascending, ts_max + 1 descending, with the wrap) and the ends of its
    valid runs, the 32-ary search's lower and upper bounds equal JAX's
    ``_search3`` (an upper bound is the lower bound of the next key)."""
    dr, cr, queries = k15cases.case(case)
    for block in dr + cr:
        t, j = port_levels([block])[0], jax_levels([block])[0]
        for acct_lo, acct_hi, ts_min, ts_max, *_ in queries:
            for ts in {ts_min, (ts_max + 1) & U64M, max(ts_min, 1),
                       min(ts_max, U64M - 1) + 1, 0, U64M}:
                want = int(jix._search3(j, jnp.uint64(acct_hi),
                                        jnp.uint64(acct_lo), jnp.uint64(ts)))
                assert tix._search32_plain(t, acct_hi, acct_lo, ts) == want
                if ts:
                    assert tix._search32_plain(t, acct_hi, acct_lo, ts - 1,
                                               upper=True) == want


def test_k15_cases_reach_their_traps():
    """The cases set what they name: a tail of an unwanted side's valid
    tids, runs longer than k (the prune), valid keys of U64_MAX (ts 0
    descending), more merged keys than the union block stages, an empty
    account and the descending wrap."""
    def descs(case, q):
        dr, cr, _ = k15cases.case(case)
        return [tix._window_desc_plain(lv, q[0], q[1], q[2], q[3], q[6], q[7])
                for lv in port_levels(dr + cr)]

    def union(case, q):
        dr, cr, _ = k15cases.case(case)
        return tix.query_transfers_split_plain(port_levels(dr), port_levels(cr), *q)

    q = k15cases.case("one_side_unwanted")[2][4]
    valid, lo, _hi = union("one_side_unwanted", q)
    assert (~valid & (lo != 0)).any()  # unwanted side's tids in the tail
    q = k15cases.case("long_run")[2][0]
    assert sum(1 for d in descs("long_run", q) if d[2] == q[6]) >= 2
    q = k15cases.case("edge_ts")[2][2]  # descending, ts_max < U64_MAX
    assert any(m > r for _b, m, r in descs("edge_ts", q))
    valid, _lo, _hi = union("edge_ts", q)
    assert int(valid.sum()) > sum(r for _b, _m, r in descs("edge_ts", q))
    q = k15cases.case("over_stage")[2][0]
    assert sum(r for _b, _m, r in descs("over_stage", q)) > 16384
    for case, j in (("no_rows", 0), ("wrap", 0)):
        q = k15cases.case(case)[2][j]
        assert all(m == 0 for _b, m, _r in descs(case, q))
