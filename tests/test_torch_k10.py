"""K10's split plain form (``transfer_full._leg_balances_split_plain``, the
steps of the kernel on many blocks: the sort cache or the chunk sort, block
scans of the six streams, the blocks' carries) against the JAX package's
``_leg_balances`` on the CPU, exactly, on ``testing/k10cases.py``'s traps;
and against the port's plain form at the kernel's block and chunk and at
small ones (many blocks and chunks at a few lanes).  The kernel is held
against the split plain form on the card (tests/test_torch_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu.ops import transfer_full as jtf
from tigerbeetle_tpu_torch.ops import _cuda
from tigerbeetle_tpu_torch.ops import transfer_full as ttf
from tigerbeetle_tpu_torch.testing import k10cases

CPU = torch.device("cpu")
SIZES = (1, 300, 8192)
VALUES = ("dp_pre", "dp_incl", "dpo_pre", "dpo_incl", "cp_pre", "cp_incl",
          "cpo_pre", "cpo_incl")


def _jax(args):
    sb = {k: jnp.asarray(v.view(np.uint64)) for k, v in args["start_bal"].items()}
    u = lambda k: jnp.asarray(args[k].view(np.uint64))  # noqa: E731
    b = lambda k: jnp.asarray(args[k])  # noqa: E731
    return jtf._leg_balances(
        sb, jnp.uint64(args["cap_sentinel"]), b("ok_lanes"), u("amt_lo"),
        u("pamt_lo"), u("dr_slot"), u("cr_slot"), b("dr_live"), b("cr_live"),
        b("pending_f"), b("post"), b("postvoid"),
        has_postvoid=args["has_postvoid"])


def _assert_legs_equal(want, got, jax_side: bool):
    """``got`` (the port's) equals ``want`` (JAX's, or the port's)."""
    def arr(x):
        return np.asarray(x) if jax_side else x.numpy()

    np.testing.assert_array_equal(got.leg_pos.numpy(),
                                  arr(want.leg_pos).astype(np.int64))
    for name in VALUES:
        w, g = getattr(want, name), getattr(got, name)
        for part in ("lo", "hi"):
            np.testing.assert_array_equal(
                getattr(g, part).numpy().view(np.uint64),
                arr(getattr(w, part)).view(np.uint64), f"{name}.{part}")
    np.testing.assert_array_equal(got.s_slot.numpy().view(np.uint64),
                                  arr(want.s_slot).view(np.uint64))
    np.testing.assert_array_equal(got.s_live.numpy(), arr(want.s_live))
    np.testing.assert_array_equal(got.is_last.numpy(), arr(want.is_last))
    assert bool(got.arith_broken) == bool(arr(want.arith_broken))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", k10cases.CASES)
def test_k10_split_plain_matches_jax(name, n):
    """The split plain form, at the kernel's block (128) and chunk
    (1,024), with the case's cache, equals JAX ``_leg_balances``; a stale
    or invalid cache is refreshed to the sort of these legs, a fresh one
    left as it was."""
    args, cache = k10cases.case(name, n)
    targs, tcache = k10cases.to_tensors(args, cache, CPU)
    got = ttf._leg_balances_split_plain(**targs, cache=tcache)
    _assert_legs_equal(_jax(args), got, jax_side=True)
    if tcache is not None:
        want = k10cases.sort_cache(args["dr_slot"], args["cr_slot"],
                                   args["dr_live"], args["cr_live"])
        np.testing.assert_array_equal(tcache[0].numpy()[:2 * n],
                                      want[0][:2 * n])
        np.testing.assert_array_equal(tcache[1].numpy(), want[1])
        assert int(tcache[2][0]) == 1
        if name == "fresh_cache":
            np.testing.assert_array_equal(tcache[0].numpy(), cache[0])


@pytest.mark.parametrize("block,chunk", [(16, 32), (32, 1024), (128, 64)])
@pytest.mark.parametrize("name", k10cases.CASES)
def test_k10_split_plain_blocks_and_chunks(name, block, chunk):
    """Any block and chunk give the plain form's bytes: 600 legs in up to
    38 blocks of the scan and 32 chunks of the sort (the cache dropped, so
    every call sorts)."""
    args, _cache = k10cases.case(name, 300)
    targs, _ = k10cases.to_tensors(args, None, CPU)
    want = ttf._leg_balances_plain(**targs)
    got = ttf._leg_balances_split_plain(**targs, block=block, chunk=chunk)
    _assert_legs_equal(want, got, jax_side=False)


def test_k10_traps_reach_their_conditions():
    """Each trap sets what it names: one run over every block, runs ending
    on block edges, the sentinel run over several blocks, the overflow only
    in the last block, an underflow run across an edge, and caches that are
    fresh, stale and invalid."""
    n = 8192
    block = _cuda.LEG_THREADS

    def legs(name):
        args, cache = k10cases.case(name, n)
        targs, tcache = k10cases.to_tensors(args, cache, CPU)
        return args, cache, ttf._leg_balances_plain(**targs)

    _, _, one = legs("one_account")
    assert int(one.is_last.sum()) == 1
    _, _, edges = legs("block_edges")
    tails = np.flatnonzero(edges.is_last.numpy())
    assert ((tails + 1) % block == 0).sum() >= 8
    assert ((tails + 1) % block != 0).sum() >= 8
    _, _, sent = legs("sentinel")
    dead = (~sent.s_live).numpy()
    assert dead.sum() > 2 * block and dead[-1]
    args, _, near = legs("near_2_128")
    assert bool(near.arith_broken)
    # Without the last lane the batch is sound: the overflow was its leg's.
    args["ok_lanes"][n - 1] = False
    targs, _ = k10cases.to_tensors(args, None, CPU)
    assert not bool(ttf._leg_balances_plain(**targs).arith_broken)
    assert int(near.leg_pos[2 * (n - 1)]) // block == 2 * n // block - 1
    _, _, under = legs("underflow")
    assert bool(under.arith_broken)
    # Each trap leg is alone in its run (and so last), at a block edge or
    # in the last block; without the trap lanes the batch is sound, and
    # each alone breaks it.
    args, _, last = legs("underflow_last")
    assert bool(last.arith_broken)
    traps = (block - 1, block, 2 * n - 2, 2 * n - 1)
    pos, tail = last.leg_pos.numpy(), last.is_last.numpy()
    assert all(pos[j] == j and tail[j] and tail[j - 1] for j in traps)
    lanes = sorted({j // 2 for j in traps})
    for keep in lanes + [None]:
        ok = args["ok_lanes"].copy()
        ok[[i for i in lanes if i != keep]] = False
        targs, _ = k10cases.to_tensors(dict(args, ok_lanes=ok), None, CPU)
        broken = bool(ttf._leg_balances_plain(**targs).arith_broken)
        assert broken == (keep is not None), (keep, lanes)
    for name, stale in (("fresh_cache", False), ("stale_cache", True),
                        ("invalid_cache", True)):
        args, cache = k10cases.case(name, n)
        slot = np.stack([np.where(args["dr_live"], args["dr_slot"], k10cases.CAP),
                         np.where(args["cr_live"], args["cr_slot"], k10cases.CAP)],
                        1).reshape(-1)
        tc = tuple(torch.from_numpy(c) for c in cache)
        assert ttf._legs_stale(torch.from_numpy(slot), tc) == stale, name
