"""K9 ``full_index``'s plain version against the JAX package's id grouping
(``_build_id_index``) and pending join (``_search128``) on the traps of
``testing/k9cases.py`` (every id equal or 0, a probe chain of 512 ids that
wraps the card's table, pending ids naming id 0, a missing id and the
lane's own), at 1, 8,190 and 8,192 lanes.  JAX labels a group by its
sorted position, the port by its lowest lane."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu.ops import transfer_full as jtf
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.ops import transfer_full as ttf
from tigerbeetle_tpu_torch.testing import k9cases


def jax_grouping(lo, hi, plo, phi):
    """(group_of_lane as lowest lanes, any_dup, pj_hit, pj_group as lowest
    lanes, 0 where no hit) from the JAX functions."""
    n = len(lo)
    idx = jtf._build_id_index(jnp.asarray(lo), jnp.asarray(hi))
    gid = np.asarray(idx.group_of_lane)
    lead_of_gid = np.full(n, n, np.int64)
    np.minimum.at(lead_of_gid, gid, np.arange(n))
    pj = np.asarray(jtf._search128(idx.s_hi, idx.s_lo, jnp.asarray(phi),
                                   jnp.asarray(plo)))
    pj_c = np.minimum(pj, n - 1)
    s_lo, s_hi = np.asarray(idx.s_lo), np.asarray(idx.s_hi)
    pj_hit = (s_hi[pj_c] == phi) & (s_lo[pj_c] == plo) & (pj < n)
    pj_group = np.where(pj_hit, lead_of_gid[np.asarray(idx.gid)[pj_c]], 0)
    return lead_of_gid[gid], bool(idx.any_dup), pj_hit, pj_group


@pytest.mark.parametrize("case", k9cases.CASES)
@pytest.mark.parametrize("n", k9cases.SIZES)
def test_full_index_cases_match_jax(case, n):
    lo, hi, plo, phi = k9cases.case(case, n)
    got = ttf._build_id_index(*(convert.array_to_tensor(a, "cpu")
                                for a in (lo, hi, plo, phi)))
    group, any_dup, pj_hit, pj_group = jax_grouping(lo, hi, plo, phi)
    np.testing.assert_array_equal(got.group_of_lane.numpy(), group)
    assert bool(got.any_dup) == any_dup
    np.testing.assert_array_equal(got.pj_hit.numpy(), pj_hit)
    np.testing.assert_array_equal(got.pj_group.numpy(), pj_group)
    assert got.group_of_lane.dtype == got.pj_group.dtype == torch.int64


def test_k9_cases_reach_their_traps():
    """Each case sets what it names: the one-home ids all start at the
    table's last slot, all-equal and all-zero batches are one group, and
    the pending joins hit id 0, miss, and hit the lane's own id."""
    n = 8192
    hsize = k9cases.full_index_slots(n)
    same = k9cases.one_home_ids(k9cases.ONE_HOME, hsize)
    homes = k9cases.mix64_np(same, 0) & np.uint64(hsize - 1)
    assert len(np.unique(same)) == k9cases.ONE_HOME
    assert (homes == hsize - 1).all()
    lo, hi, plo, phi = k9cases.case("one_home", n)
    assert np.isin(lo, same).sum() >= k9cases.ONE_HOME
    for case in ("all_equal", "all_zero"):
        args = [convert.array_to_tensor(a, "cpu") for a in k9cases.case(case, n)]
        idx = ttf._build_id_index(*args)
        assert (idx.group_of_lane == 0).all() and bool(idx.pj_hit.all())
        assert bool(idx.any_dup) == (case == "all_equal")
    lo, hi, plo, phi = k9cases.case("pending_joins", n)
    idx = ttf._build_id_index(*(convert.array_to_tensor(a, "cpu")
                                for a in (lo, hi, plo, phi)))
    hit = idx.pj_hit.numpy()
    zero = (plo == 0) & (phi == 0)
    own = (plo == lo) & (phi == hi) & ~zero
    assert hit[zero].all() and hit[own].all() and not hit[~zero & ~own].any()
