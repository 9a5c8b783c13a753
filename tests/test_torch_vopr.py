"""The port's batched VOPR (``tigerbeetle_tpu_torch/sim``) against the JAX
package's ``sim/vopr_tpu.py`` on the CPU, every comparison exact (integers
and booleans: tolerance 0).

- ``sim/prng.py`` against ``jax.random``: PRNGKey, split, fold_in, bits,
  bernoulli (float64) and randint (int64), under the two JAX settings the
  port assumes;
- ``draw_faults`` (the plain version of K27) against JAX's;
- ``step`` (the plain version of K28) against ``jax.jit(jax.vmap(step))``,
  every field after every step, for the clean model and the nine bugs at
  ``tests/test_vopr.py``'s shapes and probabilities;
- ``run``, ``run_sharded`` and the bug counts: ``tests/test_torch_vopr_run.py``.

The kernels themselves are held against these plain versions on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

import functools
import inspect
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tigerbeetle_tpu.sim import vopr_tpu as J
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.ops import _cuda
from tigerbeetle_tpu_torch.sim import prng
from tigerbeetle_tpu_torch.sim import vopr_tpu as T

CPU = torch.device("cpu")
CSRC = Path(__file__).resolve().parents[1] / "tigerbeetle_tpu_torch" / "csrc"
HARSH = J.HARSH_FAULTS


def tkeys(keys) -> torch.Tensor:
    """JAX uint32 keys as the port's int32 bit patterns."""
    return torch.from_numpy(np.asarray(keys).view(np.int32).copy())


def as_u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint64)


# -- the PRNG -------------------------------------------------------------------


def test_jax_settings_the_port_assumes():
    """sim/prng.py reproduces threefry under these settings; a JAX that
    changes them must fail here, not drift silently."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_enable_x64 is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.random.randint(jax.random.PRNGKey(0), (), 0, 4).dtype == jnp.int64


SEEDS = [0, 1, 42, 2**31 - 1, 2**32 + 7, 2**63 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_and_fold_in(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed, CPU)
    assert np.array_equal(np.asarray(jk).astype(np.int64), tk.numpy())
    for n in (2, 4, 10, 37):
        assert np.array_equal(np.asarray(jax.random.split(jk, n)),
                              prng.split(tk, n).numpy().astype(np.uint32))
    assert np.array_equal(np.asarray(jax.random.split(jk, 12))[5:9],
                          prng.split(tk, 4, 5).numpy().astype(np.uint32))
    for data in (0, 0x5DC, 2**32 - 1):
        assert np.array_equal(np.asarray(jax.random.fold_in(jk, data)),
                              prng.fold_in(tk, data).numpy().astype(np.uint32))


@pytest.mark.parametrize("shape", [(), (1,), (3,), (2, 5)])
def test_prng_bits_bernoulli_randint(shape):
    for seed in SEEDS[:4]:
        jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed, CPU)
        assert np.array_equal(
            np.asarray(jax.random.bits(jk, shape, jnp.uint32)),
            prng.random_bits(tk, 32, shape).numpy().astype(np.uint32))
        hi, lo = prng.random_bits(tk, 64, shape)
        assert np.array_equal(
            np.asarray(jax.random.bits(jk, shape, jnp.uint64)),
            (as_u64(hi) << np.uint64(32)) | as_u64(lo))
        assert np.array_equal(
            np.asarray(jax.random.uniform(jk, shape, jnp.float64)),
            prng.uniform(tk, shape).numpy())
        for p in (0.0, 0.08, 0.3, 0.5, 1.0):
            assert np.array_equal(np.asarray(jax.random.bernoulli(jk, p, shape)),
                                  prng.bernoulli(tk, p, shape).numpy())
        for lo_, hi_ in ((0, 1), (0, 3), (0, 4), (0, 5), (0, 8), (0, 32),
                         (3, 17), (0, 1_000_003), (5, 5)):
            want = np.asarray(jax.random.randint(jk, shape, lo_, hi_))
            assert want.dtype == np.int64
            assert np.array_equal(want, prng.randint(tk, shape, lo_, hi_).numpy())


def test_prng_batched_keys_follow_vmap():
    keys = jax.random.split(jax.random.PRNGKey(3), 33)
    tk = tkeys(keys)
    assert np.array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.split(k, 10))(keys)),
        prng.split(tk, 10).numpy().astype(np.uint32))
    assert np.array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.randint(k, (5,), 0, 32))(keys)),
        prng.randint(tk, (5,), 0, 32).numpy())
    assert np.array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, 0.3, (4,)))(keys)),
        prng.bernoulli(tk, 0.3, (4,)).numpy())
    with pytest.raises(ValueError):
        prng.randint(prng.PRNGKey(0, CPU), (), 0, 1 << 31)


# -- draw_faults ----------------------------------------------------------------


def faults_equal(jf, tf, what):
    assert set(tf) == set(T.FAULT_FIELDS) == set(jf)
    for name in T.FAULT_FIELDS:
        a, b = np.asarray(jf[name]), tf[name].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        assert np.array_equal(a, b), (what, name)


@pytest.mark.parametrize("R,S", [(3, 8), (3, 32), (5, 8), (5, 32)])
@pytest.mark.parametrize("p_sdc", [0.0, 0.3])
def test_draw_faults_match_jax(R, S, p_sdc):
    keys = jax.random.split(jax.random.PRNGKey(R * 100 + S), 64)
    jf = jax.vmap(functools.partial(J.draw_faults, n_replicas=R, slots=S,
                                    p_sdc=p_sdc, **HARSH))(keys)
    faults_equal(jf, T.draw_faults(tkeys(keys), R, S, p_sdc=p_sdc, **HARSH),
                 (R, S, p_sdc))


def test_draw_faults_defaults_and_one_key():
    keys = jax.random.split(jax.random.PRNGKey(8), 64)
    jf = jax.vmap(lambda k: J.draw_faults(k, 3, 32))(keys)
    faults_equal(jf, T.draw_faults(tkeys(keys), 3, 32), "defaults")
    one = T.draw_faults(tkeys(keys[5]), 3, 32)
    faults_equal(J.draw_faults(keys[5], 3, 32), one, "one key")
    assert one["crash"].shape == (3,) and one["repart"].shape == ()
    assert _cuda.KERNELS["vopr_draw"].launches == 0  # CPU: the plain version


# -- step -------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_step(R, S, max_ops, bug, probs):
    return jax.jit(jax.vmap(functools.partial(
        J.step, n_replicas=R, slots=S, max_ops=max_ops, bug=bug,
        **dict(probs))))


def jax_state(R, S, max_ops, n):
    return jax.vmap(lambda _: J.make_state(R, S, max_ops))(jnp.arange(n))


def states_equal(js, ts, what):
    a = convert.cluster_state_to_numpy(ts)
    for name, x in zip(J.ClusterState._fields, js):
        x = np.asarray(x)
        y = a[name]
        assert x.dtype == y.dtype and x.shape == y.shape, (what, name)
        if not np.array_equal(x, y):
            bad = np.argwhere(x != y)[:3].tolist()
            raise AssertionError(f"{what}: {name} differs at {bad}")


STEP_CLUSTERS, STEP_STEPS = 32, 60


@pytest.mark.parametrize("bug", (None,) + J.BUGS)
def test_step_matches_jax_every_field_every_step(bug):
    R, S, probs = T.BUG_CONFIGS[bug]
    n, steps = STEP_CLUSTERS, STEP_STEPS
    max_ops = steps + 2
    fn = jax_step(R, S, max_ops, bug, tuple(sorted(probs.items())))
    js = jax_state(R, S, max_ops, n)
    ts = T.make_state(R, S, max_ops, n, CPU)
    key = jax.random.split(jax.random.PRNGKey(3), n)
    corrupt_commits = 0
    for i in range(steps):
        ks = jax.vmap(jax.random.split)(key)
        key, sub = ks[:, 0], ks[:, 1]
        js = fn(js, sub)
        ts = T.step(ts, tkeys(sub), n_replicas=R, slots=S, max_ops=max_ops,
                    bug=bug, **probs)
        states_equal(js, ts, f"{bug} step {i}")
        corrupt_commits += int((ts.canonical == T._CORRUPT_I32).sum())
    if bug == "corrupt_serve":
        # The canonical list's max compares as u32: CORRUPT (0x80000001,
        # negative as an int32) wins over any entry proposed beside it.
        assert corrupt_commits > 0
    if bug in ("commit_quorum", "no_truncate", "wal_wrap", "split_brain",
               "join_keep_stale", "scrub_off"):
        assert bool(ts.violated.any())
    if bug is None:
        assert not bool(ts.violated.any())


def test_corrupt_serve_canonical_max_is_unsigned():
    """Two replicas commit op 1 in one step, the primary its entry e and a
    backup, blind to its damage under corrupt_serve, CORRUPT: the canonical
    list takes the u32 max of the proposals, CORRUPT (a signed max would
    take e, CORRUPT being negative as an int32), and the oracle fires."""
    R, S, max_ops = 3, 8, 10
    e = int(J._entry(jnp.int32(0), jnp.int32(1)))
    js = J.make_state(R, S, max_ops)
    ring = np.zeros((R, S), np.uint32)
    ring[:, 1] = e
    hdr = ring.copy()
    ring[1, 1] = 0x80000001
    lop = np.zeros((R, S), np.int32)
    lop[:, 1] = 1
    one = np.ones(R, np.int32)
    start = [np.asarray(x) for x in js._replace(
        op=one, durable_op=one, log=ring, log_hdr=hdr, log_op=lop)]
    faults = J.draw_faults(jax.random.PRNGKey(0), R, S, p_crash=0.0,
                           p_restart=0.0, p_append=0.0, p_link=1.0,
                           p_view_change=0.0, p_corrupt=0.0,
                           p_repartition=0.0, p_amputate=0.0)
    kw = dict(n_replicas=R, slots=S, max_ops=max_ops, bug="corrupt_serve")
    js = jax.jit(lambda st, f: J.step(st, None, faults=f, **kw))(
        J.ClusterState(*map(jnp.asarray, start)), faults)
    ts = T.step(convert.cluster_state_from_numpy(start, CPU),
                faults={k: torch.from_numpy(np.array(v))
                        for k, v in faults.items()}, **kw)
    states_equal(js, ts, "corrupt_serve")
    assert np.asarray(js.commit).tolist() == [1, 1, 1]
    assert int(np.asarray(js.canonical)[1]) == 0x80000001
    assert np.int32(e) > np.uint32(0x80000001).view(np.int32)
    assert bool(ts.violated)


def test_step_one_cluster_without_a_batch_dimension():
    R, S, max_ops = 3, 32, 40
    probs = dict(HARSH)
    fn = jax.jit(functools.partial(J.step, n_replicas=R, slots=S,
                                   max_ops=max_ops, **probs))
    js = J.make_state(R, S, max_ops)
    ts = T.make_state(R, S, max_ops, device=CPU)
    assert ts.status.shape == (R,) and ts.canonical.shape == (max_ops,)
    key = jax.random.PRNGKey(12)
    for i in range(30):
        key, sub = jax.random.split(key)
        js = fn(js, sub)
        ts = T.step(ts, tkeys(sub), n_replicas=R, slots=S, max_ops=max_ops,
                    **probs)
        states_equal(js, ts, f"step {i}")
    assert int(ts.commit.max()) > 0


def test_step_with_given_faults_matches_jax():
    """The cross-validation harness's route: faults drawn once, handed to
    both packages' step."""
    R, S, max_ops = 3, 8, 30
    keys = jax.random.split(jax.random.PRNGKey(4), 16)
    faults = jax.vmap(lambda k: J.draw_faults(k, R, S, **HARSH))(keys)
    js = jax_state(R, S, max_ops, 16)
    js = jax.jit(jax.vmap(functools.partial(
        J.step, n_replicas=R, slots=S, max_ops=max_ops)))(js, keys,
                                                          faults=faults)
    tf = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in faults.items()}
    ts = T.step(T.make_state(R, S, max_ops, 16, CPU), faults=tf,
                n_replicas=R, slots=S, max_ops=max_ops)
    states_equal(js, ts, "given faults")


def test_cluster_state_round_trip_and_dtypes():
    js = J.make_state(5, 8, 12)._replace(
        log=jnp.full((5, 8), 0x80000001, jnp.uint32))
    ts = convert.cluster_state_from_numpy(js._asdict(), CPU)
    assert ts.log.dtype == torch.int32 and int(ts.log[0, 0]) == T._CORRUPT_I32
    back = convert.cluster_state_to_numpy(ts)
    for name, x in zip(J.ClusterState._fields, js):
        assert back[name].dtype == np.asarray(x).dtype
        assert np.array_equal(back[name], np.asarray(x))
    assert J.ClusterState(**back)  # the JAX package takes it back
    with pytest.raises(TypeError):
        convert.cluster_state_from_numpy(
            js._replace(log=np.zeros((5, 8), np.int64)), CPU)


# -- limits, devices, copies ------------------------------------------------------


def test_limits_raise_on_both_devices():
    for R, S in ((0, 32), (7, 32), (3, 0), (3, T.MAX_SLOTS + 1)):
        with pytest.raises(ValueError):
            T.run(0, 4, 3, R, S, device="cpu")
        with pytest.raises(ValueError):
            T.draw_faults(prng.PRNGKey(0, CPU), R, S)
    with pytest.raises(ValueError):
        T.run(0, 4, 3, bug="no_such_bug", device="cpu")
    with pytest.raises(TypeError):
        T.run(0, 4, 3, device="cpu", p_nothing=0.5)
    T.run(0, 2, 3, 1, 1, device="cpu")
    T.run(0, 2, 3, 6, T.MAX_SLOTS, device="cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run(0, 4, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run_sharded(0, 4, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.make_state(3, 8, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prng.PRNGKey(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.cluster_keys(0, 0, 4)


def test_step_draws_where_the_state_lies():
    """A key on another device than the state is refused before any draw,
    so the draws never run on a device the caller did not choose."""
    state = T.make_state(3, 8, 10, 4, CPU)
    key = prng.split(prng.PRNGKey(1, CPU), 4)
    stepped = T.step(state, key, n_replicas=3, slots=8, max_ops=10)
    assert stepped.status.device == CPU
    with pytest.raises(ValueError, match="the key is on meta"):
        T.step(state, key.to("meta"), n_replicas=3, slots=8, max_ops=10)


def test_model_constants_equal_the_reference():
    assert T.BUGS == J.BUGS
    assert T.HARSH_FAULTS == J.HARSH_FAULTS
    assert T.CORRUPT == int(J.CORRUPT) and T.INF == int(J.INF)
    sig = inspect.signature(J.draw_faults).parameters
    assert T.PROBS == {k: sig[k].default for k in T.PROBS}
    assert T.ClusterState._fields == J.ClusterState._fields
    v = np.arange(0, 2**31, 2**27, dtype=np.int32)
    o = np.arange(16, dtype=np.int32)
    assert np.array_equal(np.asarray(J._entry(jnp.asarray(v), jnp.asarray(o))
                                     ).view(np.int32),
                          T._entry(torch.from_numpy(v),
                                   torch.from_numpy(o)).numpy())


def test_quorums_is_the_reference_function():
    from tigerbeetle_tpu.vsr import consensus as jc
    from tigerbeetle_tpu_torch.vsr import consensus as tc

    assert inspect.getsource(tc.quorums) == inspect.getsource(jc.quorums)


def _c_enum(text, name):
    body = re.search(r"enum " + name + r" \{(.*?)\};", text, re.S).group(1)
    return [re.sub(r"\s*=.*", "", x).strip() for x in body.split(",")
            if x.strip()]


def test_kernel_layouts_match_the_sources():
    """The pointer arrays and codes the wrappers pass are in the order of
    csrc/vopr.cuh's enums, and the bounds the wrappers check are its own."""
    text = (CSRC / "vopr.cuh").read_text()
    faults = _c_enum(text, "VoprFaultField")
    assert faults[-1] == "F_COUNT"
    assert [f"F_{n.upper()}" for n in T.FAULT_FIELDS] == faults[:-1]
    state = _c_enum(text, "VoprStateField")
    assert [f"S_{n.upper()}" for n in T.STATE_FIELDS] == state[:-1]
    probs = _c_enum(text, "VoprProb")
    assert [f"P_{n[2:].upper()}" for n in T.PROBS] == probs[:-1]
    bugs = _c_enum(text, "VoprBug")
    assert bugs == ["BUG_NONE"] + [f"BUG_{b.upper()}" for b in T.BUGS]
    assert T.BUG_CODES == {None: 0, **{b: i + 1 for i, b in enumerate(T.BUGS)}}
    defines = dict(re.findall(r"#define (VOPR_\w+) (\d+)", text))
    assert int(defines["VOPR_MAX_R"]) == T.MAX_REPLICAS
    assert int(defines["VOPR_MAX_S"]) == T.MAX_SLOTS
    assert int(defines["VOPR_SHARED_MAX_OPS"]) == _cuda.VOPR_SHARED_MAX_OPS
    for name in ("vopr_draw", "vopr_step", "vopr_run"):
        k = _cuda.KERNELS[name]
        assert (Path(__file__).resolve().parents[1] / k.source).exists()
        path, line = k.replaces.split(":")
        src = (Path(__file__).resolve().parents[1] / path).read_text()
        assert re.match(r"def (draw_faults|step|run)\(",
                        src.splitlines()[int(line) - 1])


def test_scale_twin_on_the_cpu(tmp_path, capsys):
    from tigerbeetle_tpu_torch.sim import vopr_scale

    record = Path(__file__).resolve().parents[1] / "VOPR_TPU_SCALE.json"
    before = record.read_bytes()
    out = tmp_path / "scale.json"
    rc = vopr_scale.main(["--device", "cpu", "--schedules", "48", "--steps",
                          "12", "--batch", "16", "--out", str(out)])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == line
    assert set(json.loads(before)) <= set(line)
    assert line["schedules"] == 48 and line["violations"] == 0
    assert line["platform"] == "cpu" and line["faults"] == HARSH
    assert len(line["batch_wall_s"]) == 3
    assert record.read_bytes() == before
