"""K2's split form (the pre-pass's windows, then the resolver's rounds over
home groups: ``claim_prepass_plain``, ``claim_resolve_plain``) against the
JAX package's ``claim_slots`` and ``insert``, slot for slot and on every
table array, on ``testing/k2cases.py``'s cases (tables built in numpy,
each trap's occupied slots, tombstones and lane homes placed by hand)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu.ops import hash_table as jht
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.ops import _cuda
from tigerbeetle_tpu_torch.ops import hash_table as tht
from tigerbeetle_tpu_torch.testing import k2cases as k2

CPU = torch.device("cpu")
W = _cuda.INSERT_WINDOW
PAD = 256
jax_claim = jax.jit(jht.claim_slots, static_argnums=(4, 5))


def jax_table(a):
    return jht.Table(key_lo=jnp.asarray(a["key_lo"]),
                     key_hi=jnp.asarray(a["key_hi"]),
                     tombstone=jnp.asarray(a["tombstone"]),
                     cols={k: jnp.asarray(v) for k, v in a["cols"].items()},
                     count=jnp.asarray(a["count"]),
                     probe_overflow=jnp.asarray(a["probe_overflow"]))


def run_case(arrays, lo, mask, max_probe, shift=0):
    """Claims and inserts through JAX and through the split plain form;
    returns the claims and the overflow.  A batch of fewer than PAD lanes
    is padded with masked-out lanes, so that most cases share one shape
    (and one compile of the JAX functions)."""
    n = len(lo)
    pad = max(0, PAD - n)
    lo = np.concatenate([np.asarray(lo, np.uint64),
                         (1 << 50) + np.arange(pad, dtype=np.uint64)])
    mask = np.concatenate([np.asarray(mask, bool), np.zeros(pad, bool)])
    hi = np.zeros(len(lo), np.uint64)
    vals = lo * np.uint64(3)
    jt, tt = jax_table(arrays), k2.table_from_arrays(arrays, CPU)
    tlo, thi = convert.array_to_tensor(lo, CPU), convert.array_to_tensor(hi, CPU)
    tmask = torch.from_numpy(mask)

    jc, jo = jax_claim(jt, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(mask),
                       max_probe, shift)
    tc, to = tht.claim_slots_split_plain(tt, tlo, thi, tmask, max_probe, shift)
    np.testing.assert_array_equal(convert.tensor_to_array(tc), np.asarray(jc))
    assert bool(to) == bool(jo)

    rows_j = {"val": jnp.asarray(vals), "tag": jnp.asarray(vals.astype(np.uint32))}
    rows_t = {"val": convert.array_to_tensor(vals, CPU),
              "tag": convert.array_to_tensor(vals.astype(np.uint32), CPU)}
    jt, jslots = jht.insert(jt, jnp.asarray(lo), jnp.asarray(hi),
                            jnp.asarray(mask), rows_j, max_probe, shift)
    tht.write_rows_plain(tt, tlo, thi, tc, tmask, rows_t)
    tt.probe_overflow |= to
    np.testing.assert_array_equal(convert.tensor_to_array(tc), np.asarray(jslots))
    want, got = convert.table_arrays(jt), convert.table_to_numpy(tt)
    for k in ("key_lo", "key_hi", "tombstone", "count", "probe_overflow"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in want["cols"]:
        np.testing.assert_array_equal(got["cols"][k], want["cols"][k], err_msg=k)
    return convert.tensor_to_array(tc)[:n], bool(to)


@pytest.mark.parametrize("case", sorted(k2.CASES))
def test_split_form_matches_jax(case):
    table, lo, mask, max_probe, shift = k2.CASES[case]()
    claimed, overflow = run_case(table, lo, mask, max_probe, shift)
    cap = len(table["key_lo"])
    if case.startswith("max_probe"):
        assert overflow
    if case == "long_cluster":
        # Lanes really walked past the first window, and a second.
        depth = (claimed[claimed < cap] - k2.homes_of(lo, cap)[claimed < cap]) \
            & np.uint64(cap - 1)
        assert depth.max() >= 2 * W
    if case == "lost_slot_walks_on":
        assert list(claimed) == k2.LOST_SLOT_CLAIMS


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_split_form_with_hash_shift_matches_jax(shift):
    """Homes from the hash's high bits: same-home groups, a cluster and
    the wrap at the table's end under each shift."""
    table, lo, mask, max_probe, shift = k2.shift_case(shift)
    _, overflow = run_case(table, lo, mask, max_probe, shift)
    assert not overflow


def test_prepass_windows_are_the_table_occupancy():
    """The pre-pass's window bits are the occupancy of home .. home+W-1,
    wrapped, and -1 marks a lane outside the mask."""
    rng = np.random.default_rng(2)
    cap = 1 << 8
    occ = rng.choice(cap, 100, replace=False)
    arrays = k2.build(cap, occ[:80], tombs=occ[80:])
    t = k2.table_from_arrays(arrays, CPU)
    lo = rng.integers(1, 1 << 40, 64, dtype=np.uint64)
    mask = rng.random(64) < 0.7
    home, window = tht.claim_prepass_plain(
        t, convert.array_to_tensor(lo, CPU), torch.zeros(64, dtype=torch.int64),
        torch.from_numpy(mask))
    h = k2.homes_of(lo, cap).astype(np.int64)
    busy = (arrays["key_lo"] != 0) | arrays["tombstone"]
    for i in range(64):
        assert int(home[i]) == (h[i] if mask[i] else -1)
        want = sum(int(busy[(h[i] + j) % cap]) << j for j in range(W))
        assert int(window[i]) == want


def test_split_constants_match_the_cuda_source():
    """The window and the split form's lane limit that the plain form and
    the wrappers use are insert.cu's."""
    src = (Path(_cuda.CSRC) / "insert.cu").read_text()

    def define(name):
        return int(re.search(r"#define %s (\d+)" % name, src).group(1))

    assert define("CLAIM_WINDOW") == _cuda.INSERT_WINDOW
    assert define("SPLIT_MAX_N") == _cuda.INSERT_SPLIT_MAX_N


@pytest.mark.parametrize("n,cap", [(1, 16), (8192, 1 << 25), (8193, 1 << 16)])
def test_insert_scratch_is_batch_sized_up_to_the_split_limit(n, cap):
    """K2's scratch: claimed and the pre-pass's homes and windows for a
    batch of at most 8,192 lanes, whatever the table's size; the round
    form's int32[C] claim words (a home's), its two walker lists of n
    (lane, home) pairs and their two lengths only above it."""
    scratch = _cuda.insert_scratch(n, cap, CPU)
    assert scratch[0].shape == (n,) and scratch[0].dtype == torch.int64
    if n <= _cuda.INSERT_SPLIT_MAX_N:
        assert _cuda.insert_split(n, cap)
        assert [x.numel() for x in scratch] == [n, 2 * n]
    else:
        assert not _cuda.insert_split(n, cap)
        assert [x.numel() for x in scratch] == [n, cap, 2 * n, 2]
