"""K17's test as a step of K1's launch: the plain form of K1's flag word
(``hash_table.lookup_flags_plain`` over ``transfer_full.gather_lookups``)
and the CPU route of ``build_gather_ctx`` against the JAX package's
``build_gather_ctx`` flags on ``testing/k17cases.py``'s traps, and K17's
hashing (``_bloom_positions``, ``bloom_check_impl``) and the word's grow
bits against the JAX functions, on the CPU, exactly (integers only).  The
kernels are held against these plain forms on the card
(tests/test_torch_kernels.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu.ops import cold as jcold
from tigerbeetle_tpu.ops import hash_table as jht
from tigerbeetle_tpu.ops import state_machine as jsm
from tigerbeetle_tpu.ops import transfer_full as jtf
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.ops import cold as tcold
from tigerbeetle_tpu_torch.ops import hash_table as tht
from tigerbeetle_tpu_torch.ops import transfer_full as ttf
from tigerbeetle_tpu_torch.testing import k1cases, k17cases

CPU = torch.device("cpu")


def jax_table(a):
    return jht.Table(key_lo=jnp.asarray(a["key_lo"]), key_hi=jnp.asarray(a["key_hi"]),
                     tombstone=jnp.asarray(a["tombstone"]),
                     cols={k: jnp.asarray(v) for k, v in a["cols"].items()},
                     count=jnp.asarray(a["count"]),
                     probe_overflow=jnp.asarray(a["probe_overflow"]))


def jax_ledger(port):
    a = convert.ledger_to_numpy(port)
    return jsm.Ledger(
        accounts=jax_table(a["accounts"]), transfers=jax_table(a["transfers"]),
        posted=jax_table(a["posted"]),
        history=jsm.History(cols={k: jnp.asarray(v) for k, v in
                                  a["history"]["cols"].items()},
                            count=jnp.asarray(a["history"]["count"])))


def jax_flags(c, args):
    ledger, soa, valid, postvoid, bloom, checked, has_pv = args
    jl = jax_ledger(ledger)
    batch = {k: jnp.asarray(convert.tensor_to_array(v)) for k, v in soa.items()}
    ctx = jtf.build_gather_ctx(
        jl, batch, jnp.asarray(valid.numpy()), jnp.asarray(postvoid.numpy()),
        bloom=jnp.asarray(c["bloom"]),
        cold_checked=None if checked is None else jnp.asarray(checked.numpy()),
        has_postvoid=has_pv)
    return int(ctx.probe_grow)


@pytest.mark.parametrize("name", k17cases.CASES)
def test_k17cases_flag_word_matches_jax(name):
    """The general kernel's flags (FLAG_COLD and the FLAG_GROW_* bits) on
    each trap: K1's flag word in its plain form, and build_gather_ctx's CPU
    route, equal to the JAX package's; the case sets FLAG_COLD as its trap
    says."""
    c = k17cases.case(name)
    args = k17cases.inputs(c, CPU)
    want = jax_flags(c, args)
    assert bool(want & jtf.FLAG_COLD) == c["cold"], "the case misses its trap"
    ledger, soa, valid, postvoid, bloom, checked, has_pv = args
    looks = ttf.gather_lookups(ledger, soa, valid, postvoid, True, has_pv)
    got, word = tht.lookup_flags(looks, ttf.MAX_PROBE, bloom, checked,
                                 ttf.FLAG_COLD)
    assert int(word) == want
    assert [r.found.tolist() for r in got] == [
        r.found.tolist() for r in tht.lookup_many(looks, ttf.MAX_PROBE)]
    ctx = ttf.build_gather_ctx(ledger, soa, valid, postvoid, bloom, checked,
                               has_postvoid=has_pv)
    assert int(ctx.probe_grow) == want


def test_k17_word_without_a_filter_is_the_grow_bits():
    """No filter: the word holds only the lookups' grow bits (as
    ``build_gather_ctx`` without the cold tier)."""
    c = k17cases.case("mixed")
    ledger, soa, valid, postvoid, _bloom, checked, has_pv = k17cases.inputs(c, CPU)
    looks = ttf.gather_lookups(ledger, soa, valid, postvoid, False, has_pv)
    assert int(tht.lookup_flags(looks, ttf.MAX_PROBE)[1]) == 0
    with pytest.raises(ValueError, match="filter"):
        tht.lookup_flags(looks[:1] + [looks[0]._replace(cold=True)], ttf.MAX_PROBE)


@pytest.mark.parametrize("name", ["max_probe_1", "max_probe_2", "wrap",
                                  "random"])
def test_k17_word_grow_bits_match_jax_overflows(name):
    """Each lookup's grow bit is in the word exactly when the JAX lookup
    overflows (K1's trap tables with probes cut short)."""
    t, looks, max_probe = k1cases.case(name)
    jt = jax_table(t)
    table = tht.Table(convert.array_to_tensor(t["key_lo"], CPU),
                      convert.array_to_tensor(t["key_hi"], CPU),
                      torch.from_numpy(t["tombstone"].copy()),
                      {k: convert.array_to_tensor(v, CPU) for k, v in t["cols"].items()},
                      torch.tensor(int(t["count"])), torch.tensor(False))
    specs, want = [], 0
    for k, lk in enumerate(looks):
        j = jht.lookup(jt, jnp.asarray(lk["key_lo"]), jnp.asarray(lk["key_hi"]),
                       max_probe, lk["hash_shift"])
        want |= (1 << k) if bool(j.overflow) else 0
        specs.append(tht.Lookup(
            table, convert.array_to_tensor(lk["key_lo"], CPU),
            convert.array_to_tensor(lk["key_hi"], CPU), ("val",),
            None if lk["mask"] is None else torch.from_numpy(lk["mask"]),
            lk["count"], lk["hash_shift"], grow_bit=1 << k))
    assert int(tht.lookup_flags(specs, max_probe)[1]) == want
    if name.startswith("max_probe"):
        assert want


@pytest.mark.parametrize("bits_log2", [10, 28, 34])
def test_bloom_positions_match_jax(bits_log2):
    """K17's four positions an id (the kernels' double hashing) against the
    JAX package's ``_bloom_positions``, up to the largest filter."""
    rng = np.random.default_rng(bits_log2)
    lo = rng.integers(0, 1 << 64, 4096, dtype=np.uint64)
    hi = np.where(rng.random(4096) < 0.3, rng.integers(0, 1 << 64, 4096,
                                                       dtype=np.uint64), 0
                  ).astype(np.uint64)
    lo[:3], hi[:3] = 0, 0
    want = jcold._bloom_positions(jnp.asarray(lo), jnp.asarray(hi), 1 << bits_log2)
    got = tcold._bloom_positions(convert.array_to_tensor(lo, CPU),
                                 convert.array_to_tensor(hi, CPU), 1 << bits_log2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(convert.tensor_to_array(g), np.asarray(w))


@pytest.mark.parametrize("name", ["id_zero", "mixed"])
def test_bloom_check_on_trap_ids_matches_jax(name):
    """The out form's plain version on a case's ids and pending ids against
    JAX ``bloom_check`` (id 0 and the filtered ids among them)."""
    c = k17cases.case(name)
    b = c["batch"]
    for lo_name, hi_name in (("id_lo", "id_hi"), ("pending_id_lo", "pending_id_hi")):
        lo, hi = b[lo_name].astype(np.uint64), b[hi_name].astype(np.uint64)
        want = np.asarray(jcold.bloom_check(jnp.asarray(c["bloom"]),
                                            jnp.asarray(lo), jnp.asarray(hi)))
        got = tcold.bloom_check_impl(convert.bloom_to_tensor(c["bloom"], CPU),
                                     convert.array_to_tensor(lo, CPU),
                                     convert.array_to_tensor(hi, CPU))
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.any()
