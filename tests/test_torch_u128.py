"""The port's u128 arithmetic (int64 tensors holding u64 bits) against the JAX
package's ``u128`` on the same lanes, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu import u128 as ju
from tigerbeetle_tpu_torch import u128 as tu

M64 = (1 << 64) - 1
# Values around every carry and borrow boundary: 0, 1, 2^32, 2^63, 2^64 - 1.
EDGES = [0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63,
         (1 << 63) + 1, M64 - 1, M64]


def _lanes(seed, n=4096):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    hi = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    edge = np.array(EDGES, dtype=np.uint64)
    lo[: len(edge) ** 2] = np.repeat(edge, len(edge))
    hi[: len(edge) ** 2] = np.tile(edge, len(edge))
    return lo, hi


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def _np(t):
    return t.numpy().view(np.uint64)


def _pair(seed):
    lo, hi = _lanes(seed)
    return (ju.U128(jnp.asarray(lo), jnp.asarray(hi)),
            tu.U128(_t(lo), _t(hi)), lo, hi)


@pytest.mark.parametrize("hi_value", [0, 1, 1 << 63, M64, 0x1234])
def test_mix64_matches_jax(hi_value):
    lo, _ = _lanes(1)
    hi = np.full_like(lo, hi_value)
    want = np.asarray(ju.mix64(jnp.asarray(lo), jnp.asarray(hi)))
    got = _np(tu.mix64(_t(lo), _t(hi)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["add", "sub"])
def test_add_sub_carries_match_jax(op):
    ja, ta, _, _ = _pair(2)
    jb, tb, _, _ = _pair(3)
    (jr, jflag) = getattr(ju, op)(ja, jb)
    (tr, tflag) = getattr(tu, op)(ta, tb)
    np.testing.assert_array_equal(_np(tr.lo), np.asarray(jr.lo))
    np.testing.assert_array_equal(_np(tr.hi), np.asarray(jr.hi))
    np.testing.assert_array_equal(tflag.numpy(), np.asarray(jflag))


def test_add_wraps_at_2_128_and_64():
    a = tu.U128(torch.tensor([-1, -1, (1 << 63) - 1]),
                torch.tensor([-1, 0, 0]))
    b = tu.U128(torch.tensor([1, 1, 1]), torch.tensor([0, 0, 0]))
    r, over = tu.add(a, b)
    # 2^128 - 1 + 1 wraps to 0 with overflow; 2^64 - 1 + 1 carries into hi;
    # 2^63 - 1 + 1 crosses the int64 sign bit without a carry.
    assert r.lo.tolist() == [0, 0, -(1 << 63)]
    assert r.hi.tolist() == [0, 1, 0]
    assert over.tolist() == [True, False, False]
    r, under = tu.sub(b, a)
    assert under.tolist() == [True, True, True]


@pytest.mark.parametrize("op", ["eq", "ne", "gt", "ge", "lt", "le"])
def test_comparisons_match_jax(op):
    ja, ta, _, _ = _pair(4)
    jb, tb, _, _ = _pair(5)
    # Shared lanes so equality and ties occur.
    jb = ju.U128(jb.lo.at[:500].set(ja.lo[:500]), jb.hi.at[:300].set(ja.hi[:300]))
    tb = tu.U128(tb.lo.clone(), tb.hi.clone())
    tb.lo[:500] = ta.lo[:500]
    tb.hi[:300] = ta.hi[:300]
    np.testing.assert_array_equal(getattr(tu, op)(ta, tb).numpy(),
                                  np.asarray(getattr(ju, op)(ja, jb)))


def test_min_saturate_select_zero_max_match_jax():
    ja, ta, _, _ = _pair(6)
    jb, tb, _, _ = _pair(7)
    for name in ("min_", "sub_saturate"):
        jr = getattr(ju, name)(ja, jb)
        tr = getattr(tu, name)(ta, tb)
        np.testing.assert_array_equal(_np(tr.lo), np.asarray(jr.lo))
        np.testing.assert_array_equal(_np(tr.hi), np.asarray(jr.hi))
    pred = ju.lt(ja, jb)
    jr = ju.select(pred, ja, jb)
    tr = tu.select(torch.from_numpy(np.asarray(pred)), ta, tb)
    np.testing.assert_array_equal(_np(tr.lo), np.asarray(jr.lo))
    for name in ("is_zero", "is_max"):
        np.testing.assert_array_equal(getattr(tu, name)(ta).numpy(),
                                      np.asarray(getattr(ju, name)(ja)))


def test_logical_shift_and_unsigned_order():
    lo, hi = _lanes(8)
    for k in (0, 1, 27, 30, 31, 32, 63):
        np.testing.assert_array_equal(_np(tu.srl(_t(lo), k)), lo >> np.uint64(k))
    np.testing.assert_array_equal(tu.ult(_t(lo), _t(hi)).numpy(), lo < hi)
    np.testing.assert_array_equal(tu.uge(_t(lo), _t(hi)).numpy(), lo >= hi)


def test_literals_round_trip():
    for v in (0, 1, 1 << 63, M64, (1 << 64) + 5, (1 << 128) - 1):
        x = tu.lit(v)
        assert (tu.u64(x.hi.item()) << 64) | tu.u64(x.lo.item()) == v
