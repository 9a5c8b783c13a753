"""The port's batched VOPR over whole schedules on the CPU: ``run`` and
``run_sharded`` (the plain loop kernel K29 replaces) against the JAX
package's ``run``, the final states through ``convert`` against a JAX loop
over ``step``, and the JAX package's violation count for each injected bug
at ``tests/test_vopr.py``'s shapes, which ``chip_smoke.py`` holds K29 to on
the card (where there is no JAX).  Every comparison is exact."""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_vopr import CPU, jax_state, jax_step, states_equal
from tigerbeetle_tpu.sim import vopr_tpu as J
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.ops import _cuda
from tigerbeetle_tpu_torch.sim import vopr_tpu as T

STEPS = 60


# -- run -----------------------------------------------------------------------


@pytest.mark.parametrize("bug", [None, "commit_quorum", "wal_wrap"])
def test_run_flags_match_jax(bug):
    R, S, probs = T.BUG_CONFIGS[bug]
    want = J.run(seed=9, n_clusters=64, n_steps=100, n_replicas=R, slots=S,
                 bug=bug, **probs)
    got = T.run(9, 64, 100, R, S, bug, device="cpu", **probs)
    assert got.dtype == np.bool_ and np.array_equal(got, want)
    if bug is not None:
        assert got.any()


def test_run_sharded_equals_run_and_ignores_padding():
    want = T.run(2, 50, 40, bug="commit_quorum", device="cpu")
    one = T.run_sharded(2, 50, 40, device="cpu", bug="commit_quorum")
    assert np.array_equal(one, want)
    # Three devices: 50 clusters pad to 51, cut into blocks of 17 with base
    # indexes 0, 17, 34; the first 50 flags are run's.
    three = T.run_sharded(2, 50, 40, devices=["cpu"] * 3, bug="commit_quorum")
    assert len(three) == 51
    assert np.array_equal(three[:50], want)
    assert np.array_equal(three, T.run(2, 51, 40, bug="commit_quorum",
                                       device="cpu"))
    assert want.any()


def test_final_states_equal_a_jax_loop_over_step():
    bug = "split_brain"
    R, S, probs = T.BUG_CONFIGS[bug]
    n, steps = 24, STEPS
    max_ops = steps + 2
    flags, ts = T.run(6, n, steps, R, S, bug, device="cpu", final_state=True,
                      **probs)
    fn = jax_step(R, S, max_ops, bug, tuple(sorted(probs.items())))
    js = jax_state(R, S, max_ops, n)
    key = jax.random.split(jax.random.PRNGKey(6), n)
    for _ in range(steps):
        ks = jax.vmap(jax.random.split)(key)
        key, sub = ks[:, 0], ks[:, 1]
        js = fn(js, sub)
    states_equal(js, ts, "final state")
    assert np.array_equal(flags, np.asarray(js.violated))
    back = convert.cluster_state_from_numpy(
        [np.asarray(x) for x in js], CPU)
    for a, b in zip(back, ts):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert _cuda.KERNELS["vopr_run"].launches == 0


@pytest.mark.parametrize("bug", J.BUGS)
def test_bug_violation_counts_are_the_jax_package_counts(bug):
    """chip_smoke.py's VOPR_BUG_VIOLATIONS: seed 1, 256 clusters x 300
    steps at each bug's shape, counted by the JAX package."""
    R, S, probs = T.BUG_CONFIGS[bug]
    v = J.run(seed=1, n_clusters=256, n_steps=300, bug=bug, n_replicas=R,
              slots=S, **probs)
    assert int(v.sum()) == chip_smoke.VOPR_BUG_VIOLATIONS[bug] > 0
