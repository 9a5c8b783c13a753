"""K29's draws ahead of its steps, held to the JAX package on the CPU, every
comparison exact (integers and booleans: tolerance 0).

K29 (``csrc/vopr_run.cu``) draws 32 steps at once, a step a lane: the key
chain ``key = split(key)[0]`` one hash a step, then each step's
``draw_faults(split(key)[1])``.  Its draws use integers only
(``csrc/threefry.cuh``): a Bernoulli gate compares the draw's top 52 bits
with ``prng.bernoulli_threshold(p)``, and a randint reduces by its span with
``prng.span_consts``' multiplier, Lemire's remainder on the 32-bit halves.

- the chunked order: the subkeys drawn chunk by chunk, and
  ``draw_faults_plain`` once on all of them, equal the reference's
  ``split`` loop and its ``draw_faults``, key for key and draw for draw;
- the integer Bernoulli threshold equals the float64 compare that defines
  the draw (``prng.bernoulli``), for the models' probabilities, 0, 0.5, 1
  and their neighbouring doubles, at edge and random ``m``;
- the division-free remainder (the device arithmetic, written out here in
  Python integers) equals numpy's uint64 ``%`` for every span 1-256.

The kernels themselves are held against the plain versions on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

import functools
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tigerbeetle_tpu.sim import vopr_tpu as J
from tigerbeetle_tpu_torch.sim import prng
from tigerbeetle_tpu_torch.sim import vopr_tpu as T

CHUNK = 32  # csrc/vopr_run.cu VOPR_CHUNK
CSRC = Path(__file__).resolve().parents[1] / "tigerbeetle_tpu_torch" / "csrc"
M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1
PROBS = dict(J.HARSH_FAULTS, p_sdc=0.3)
MAX_STEPS = 50


def test_chunk_is_the_kernels():
    src = (CSRC / "vopr_run.cu").read_text()
    assert re.search(r"#define VOPR_CHUNK (\d+)", src).group(1) == str(CHUNK)


# -- the chunked order ------------------------------------------------------------


def chunked_draws(keys: torch.Tensor, n_steps: int, R: int, S: int):
    """K29's order in plain PyTorch: for each chunk of 32 steps, walk the key
    chain one split a step, keep each step's key, take its
    ``split(key)[1]``; then ``draw_faults_plain`` once on every step's
    subkey.  (subkeys (N, n_steps, 2), the draws leading with (N,
    n_steps))."""
    key = keys.to(torch.int64)
    subs = []
    for t in range(0, n_steps, CHUNK):
        chain = []
        for _ in range(min(CHUNK, n_steps - t)):
            chain.append(key)
            key = prng.hash_keys(key[:, None, :], [0])[:, 0]
        chain = torch.stack(chain, 1)
        subs.append(prng.hash_keys(chain, [1] * chain.shape[1]))
    n = keys.shape[0]
    sub = torch.cat(subs, 1) if subs else torch.zeros(n, 0, 2, dtype=torch.int64)
    flat = T.draw_faults_plain(sub.reshape(-1, 2), R, S, **PROBS)
    return sub, {k: v.reshape(n, n_steps, *v.shape[1:]) for k, v in flat.items()}


@functools.lru_cache(maxsize=None)
def jax_draws(R: int, S: int):
    """The reference's loop for MAX_STEPS steps on four cluster keys:
    ``key, sub = split(key)`` then ``draw_faults(sub)``, its subkeys and
    draws as numpy, each leading with (4, MAX_STEPS)."""
    keys = jax.random.split(jax.random.PRNGKey(R * 1000 + S), 4)
    subs = []
    for _ in range(MAX_STEPS):
        ks = jax.vmap(jax.random.split)(keys)
        keys, sub = ks[:, 0], ks[:, 1]
        subs.append(sub)
    sub = jax.numpy.stack(subs, 1)
    draws = jax.vmap(functools.partial(J.draw_faults, n_replicas=R, slots=S,
                                       **PROBS))(sub.reshape(-1, 2))
    first = jax.random.split(jax.random.PRNGKey(R * 1000 + S), 4)
    return (np.asarray(first), np.asarray(sub),
            {k: np.asarray(v).reshape(4, MAX_STEPS, *v.shape[1:])
             for k, v in draws.items()})


@pytest.mark.parametrize("R,S", [(1, 8), (1, 32), (1, 64), (3, 8), (3, 32),
                                 (3, 64), (5, 8), (5, 32), (5, 64)])
@pytest.mark.parametrize("n_steps", [0, 1, 31, 32, 33, 50])
def test_chunked_draws_equal_the_reference_loop(R, S, n_steps):
    first, want_sub, want = jax_draws(R, S)
    keys = torch.from_numpy(first.astype(np.int64))
    sub, got = chunked_draws(keys, n_steps, R, S)
    assert np.array_equal(sub.numpy().astype(np.uint32),
                          want_sub[:, :n_steps])
    assert set(got) == set(T.FAULT_FIELDS)
    for name in T.FAULT_FIELDS:
        a, b = want[name][:, :n_steps], got[name].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), (name, n_steps)


# -- the integer Bernoulli threshold ---------------------------------------------


def _probabilities():
    base = {0.0, 0.5, 1.0, *J.HARSH_FAULTS.values(), *T.PROBS.values(),
            *T.BUG_CONFIGS["amputate_vouch"][2].values(), 0.3}
    out = set()
    for p in base:
        out |= {p, float(np.nextafter(p, -np.inf)),
                float(np.nextafter(p, np.inf))}
    return sorted(out)


M_EDGES = [0, 1, 2, (1 << 51) - 1, 1 << 51, (1 << 51) + 1, (1 << 52) - 2,
           (1 << 52) - 1]


@pytest.mark.parametrize("p", _probabilities())
def test_bernoulli_threshold_equals_the_float_compare(p):
    t = prng.bernoulli_threshold(p)
    assert 0 <= t <= 1 << 52
    rng = np.random.default_rng(abs(hash(p)) % (1 << 32))
    ms = M_EDGES + [m for m in (t - 2, t - 1, t, t + 1, t + 2)
                    if 0 <= m < 1 << 52]
    m = np.concatenate([np.array(ms, np.uint64),
                        rng.integers(0, 1 << 52, 4096, dtype=np.uint64)])
    # The definition: the uniform m * 2^-52 (exact in float64) below p.
    want = m.astype(np.float64) * 2.0 ** -52 < p
    assert np.array_equal(m < np.uint64(t), want)


def test_bernoulli_threshold_on_draws_and_edges():
    """The thresholds of NaN, negatives and values past 1, and the integer
    compare on real 64-bit draws against ``prng.bernoulli``."""
    assert prng.bernoulli_threshold(float("nan")) == 0
    assert prng.bernoulli_threshold(-1.0) == 0
    assert prng.bernoulli_threshold(0.0) == 0
    assert prng.bernoulli_threshold(1.0) == 1 << 52
    assert prng.bernoulli_threshold(3.0) == 1 << 52
    assert prng.bernoulli_threshold(0.5) == 1 << 51
    assert prng.bernoulli_threshold(5e-324) == 1
    key = prng.PRNGKey(11, "cpu")
    hi, lo = prng.random_bits(key, 64, (20_000,))
    m = (hi << 20) | (lo >> 12)
    for p in _probabilities():
        assert torch.equal(m < prng.bernoulli_threshold(p),
                           prng.bernoulli(key, p, (20_000,))), p


def test_draw_consts_layout_matches_the_source():
    """``draw_consts``' words are csrc/vopr.cuh's VoprDrawConsts: a
    threshold a probability in PROBS order, then (magic, d, r32, mult) of
    the spans S, 4 and R."""
    text = (CSRC / "vopr.cuh").read_text()
    body = re.search(r"struct VoprDrawConsts \{(.*?)\};", text, re.S).group(1)
    assert body.split() == ["uint64_t", "gate[P_COUNT];", "TfSpan", "slot,",
                            "mode,", "lone;"]
    n = len(T.PROBS) + 3 * 4
    probs = tuple(T._probs(PROBS).values())
    c = T.draw_consts(5, 64, probs)
    assert len(c) == n
    assert list(c[:len(probs)]) == [prng.bernoulli_threshold(p) for p in probs]
    spans = [c[len(probs) + 4 * k:len(probs) + 4 * k + 4] for k in range(3)]
    assert [s[1] for s in spans] == [64, 4, 5]
    assert spans[0] == prng.span_consts(64)
    assert all(0 <= w <= M64 for w in c)
    with pytest.raises(ValueError):
        T.draw_consts(3, 32, probs[:-1])


# -- the division-free remainder ---------------------------------------------------


def mod32(x: int, c) -> int:
    """threefry.cuh tf_mod32: __umul64hi(magic * x mod 2^64, d)."""
    magic, d = c[0], c[1]
    return ((magic * x) & M64) * d >> 64


def mod64(v: int, c) -> int:
    """threefry.cuh tf_mod64, from the halves of v."""
    return mod32(mod32(v >> 32, c) * c[2] + mod32(v & M32, c), c)


def _values(span: int, rng) -> list:
    mults = [span * k for k in (0, 1, 2, 3, (1 << 32) // span,
                                M64 // span - 1, M64 // span)]
    return sorted({0, 1, M32, 1 << 32, M64, M64 - 1, *mults,
                   *(m + 1 for m in mults if m < M64),
                   *(m - 1 for m in mults if m > 0),
                   *(int(x) for x in rng.integers(0, 1 << 63, 48,
                                                  dtype=np.uint64) * 2 + 1)})


@pytest.mark.parametrize("first", range(1, 257, 32))
def test_division_free_remainder_equals_numpy(first):
    rng = np.random.default_rng(first)
    for span in range(first, first + 32):
        c = prng.span_consts(span)
        assert c[1] == span and c[2] == (1 << 32) % span
        assert c[3] == (1 << 64) % span
        vals = _values(span, rng)
        want = np.array(vals, np.uint64) % np.uint64(span)
        assert [mod64(v, c) for v in vals] == want.tolist(), span
        assert [mod32(v & M32, c) for v in vals] == [
            (v & M32) % span for v in vals], span


@pytest.mark.parametrize("span", [1, 2, 3, 4, 5, 6, 7, 8, 31, 32, 33, 64, 255,
                                  256])
def test_division_free_randint_equals_the_plain_randint(span):
    """tf_randint_split's (high % d * mult + low % d) % d on random draws,
    against prng.randint_of_words (the plain version's remainders)."""
    key = prng.PRNGKey(span, "cpu")
    high = prng.random_bits(prng.split(key, 2)[0], 64, (512,))
    low = prng.random_bits(prng.split(key, 2)[1], 64, (512,))
    want = prng.randint_of_words(high, low, 0, span).tolist()
    c = prng.span_consts(span)
    got = [mod32(mod64(int(h1) << 32 | int(h2), c) * c[3]
                 + mod64(int(l1) << 32 | int(l2), c), c)
           for h1, h2, l1, l2 in zip(*high, *low)]
    assert got == want


def test_span_consts_limits():
    assert prng.span_consts(1) == (0, 1, 0, 0)
    assert prng.span_consts(1 << 15)[0] == 1 << 49
    for bad in (0, -3, 1 << 16):
        with pytest.raises(ValueError):
            prng.span_consts(bad)
