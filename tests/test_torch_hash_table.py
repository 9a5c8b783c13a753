"""The port's hash table (``tigerbeetle_tpu_torch.ops.hash_table``) against the
JAX package's on the same inputs: every table array, every claimed slot and
every lookup output must be equal, byte for byte.  The cases follow
tests/test_hash_table.py.  On the CPU the port runs the plain PyTorch
versions of kernels K1 (probe) and K2 (insert); the kernels themselves are
held against those versions on the card (tests/test_torch_kernels.py and
chip_smoke.py)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu.ops import hash_table as jht
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.ops import hash_table as tht
from tigerbeetle_tpu_torch.ops import state_machine as tsm
from tigerbeetle_tpu_torch.testing import k1cases
from tigerbeetle_tpu_torch.utils.benchgen import mix64_np

MAX_PROBE = 1 << 9
CPU = torch.device("cpu")


def pair(capacity):
    """Empty JAX and port tables with one u64 and one u32 value column."""
    return (jht.make_table(capacity, {"val": jnp.uint64, "tag": jnp.uint32}),
            tht.make_table(capacity, {"val": torch.int64, "tag": torch.int32},
                           CPU))


def keys(ints):
    lo = np.array([v & ((1 << 64) - 1) for v in ints], np.uint64)
    hi = np.array([v >> 64 for v in ints], np.uint64)
    return lo, hi


def arrays_equal(jt, tt):
    want = convert.table_arrays(jt)
    got = convert.table_to_numpy(tt)
    for k in ("key_lo", "key_hi", "tombstone", "count", "probe_overflow"):
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in want["cols"]:
        assert want["cols"][k].dtype == got["cols"][k].dtype, k
        np.testing.assert_array_equal(got["cols"][k], want["cols"][k], err_msg=k)


def insert_both(jt, tt, lo, hi, mask, vals, max_probe=MAX_PROBE):
    rows_j = {"val": jnp.asarray(vals), "tag": jnp.asarray(vals.astype(np.uint32))}
    rows_t = {"val": convert.array_to_tensor(vals, CPU),
              "tag": convert.array_to_tensor(vals.astype(np.uint32), CPU)}
    jt, jslots = jht.insert(jt, jnp.asarray(lo), jnp.asarray(hi),
                            jnp.asarray(mask), rows_j, max_probe)
    tt, tslots = tht.insert(tt, convert.array_to_tensor(lo, CPU),
                            convert.array_to_tensor(hi, CPU),
                            torch.from_numpy(np.asarray(mask)), rows_t, max_probe)
    np.testing.assert_array_equal(convert.tensor_to_array(tslots),
                                  np.asarray(jslots))
    arrays_equal(jt, tt)
    return jt, tt


def lookup_both(jt, tt, lo, hi, max_probe=MAX_PROBE):
    j = jht.lookup(jt, jnp.asarray(lo), jnp.asarray(hi), max_probe)
    jcols = jht.gather_cols(jt, j.slot, j.found)
    t = tht.lookup(tt, convert.array_to_tensor(lo, CPU),
                   convert.array_to_tensor(hi, CPU), max_probe,
                   cols=("val", "tag"))
    np.testing.assert_array_equal(t.found.numpy(), np.asarray(j.found))
    np.testing.assert_array_equal(convert.tensor_to_array(t.slot), np.asarray(j.slot))
    assert bool(t.overflow) == bool(j.overflow)
    for k in ("val", "tag"):
        np.testing.assert_array_equal(convert.tensor_to_array(t.cols[k]),
                                      np.asarray(jcols[k]))
    return t


def same_home(cap, n_keys, groups=1, start=1):
    """``groups`` lists of ``n_keys`` keys sharing one home slot each."""
    cands = np.arange(start, start + 200_000, dtype=np.uint64)
    homes = mix64_np(cands, 0) & np.uint64(cap - 1)
    out = []
    for h in np.unique(homes):
        same = cands[homes == h]
        if len(same) >= n_keys:
            out.append(same[:n_keys])
        if len(out) == groups:
            break
    return out


def test_insert_then_lookup():
    jt, tt = pair(256)
    ids = [1, 2, 3, 1 << 64, (1 << 64) + 1, 0xDEAD << 90]
    lo, hi = keys(ids)
    jt, tt = insert_both(jt, tt, lo, hi, np.ones(len(ids), bool),
                         np.arange(len(ids), dtype=np.uint64))
    assert int(tt.count) == len(ids)
    assert lookup_both(jt, tt, lo, hi).found.all()
    # Absent keys are not found; key 0 resolves to not-found immediately.
    lo2, hi2 = keys([99, 0, 1 << 100])
    assert not lookup_both(jt, tt, lo2, hi2).found.any()


def test_collision_heavy_insert():
    jt, tt = pair(64)
    ids = list(range(1, 49))  # load 0.75
    lo, hi = keys(ids)
    jt, tt = insert_both(jt, tt, lo, hi, np.ones(48, bool), np.array(ids, np.uint64))
    assert lookup_both(jt, tt, lo, hi).found.all()


def test_incremental_batches_random():
    rng = np.random.default_rng(7)
    jt, tt = pair(1 << 13)
    seen = set()
    for _ in range(6):
        ids = rng.integers(1, 1 << 62, size=512).tolist()
        lo, hi = keys(ids)
        found = lookup_both(jt, tt, lo, hi).found.numpy()
        first = np.zeros(512, bool)
        batch_seen = set()
        for j, i in enumerate(ids):
            first[j] = i not in batch_seen and i not in seen
            batch_seen.add(i)
        mask = first & ~found
        jt, tt = insert_both(jt, tt, lo, hi, mask, (lo % np.uint64(1000)))
        seen |= batch_seen
    assert not bool(tt.probe_overflow)


def test_tombstones_probe_continues_and_are_not_reused():
    jt, tt = pair(16)
    (a, b, c), = same_home(16, 3)
    lo, hi = keys([int(a), int(b)])
    jt, tt = insert_both(jt, tt, lo, hi, np.ones(2, bool),
                         np.array([10, 20], np.uint64))
    la, ha = keys([int(a)])
    ja = jht.lookup(jt, jnp.asarray(la), jnp.asarray(ha), MAX_PROBE)
    jt = jht.remove_to_tombstone(jt, ja.slot, ja.found)
    ta = tht.lookup(tt, convert.array_to_tensor(la, CPU),
                    convert.array_to_tensor(ha, CPU), MAX_PROBE)
    tt = tht.remove_to_tombstone(tt, ta.slot, ta.found)
    arrays_equal(jt, tt)
    assert lookup_both(jt, tt, *keys([int(b)])).found.all()
    assert not lookup_both(jt, tt, la, ha).found.any()
    # A new key of the same home probes past the tombstone.
    jt, tt = insert_both(jt, tt, *keys([int(c)]), np.ones(1, bool),
                         np.array([30], np.uint64))


def test_scatter_cols_update():
    jt, tt = pair(256)
    lo, hi = keys([5, 6, 7])
    jt, tt = insert_both(jt, tt, lo, hi, np.ones(3, bool),
                         np.array([1, 2, 3], np.uint64))
    j = jht.lookup(jt, jnp.asarray(lo), jnp.asarray(hi), MAX_PROBE)
    new = np.array([10, 20, 30], np.uint64)
    jt = jht.scatter_cols(jt, j.slot, j.found, {"val": jnp.asarray(new)})
    t = tht.lookup(tt, convert.array_to_tensor(lo, CPU),
                   convert.array_to_tensor(hi, CPU), MAX_PROBE)
    tt = tht.scatter_cols(tt, t.slot, t.found,
                          {"val": convert.array_to_tensor(new, CPU)})
    arrays_equal(jt, tt)


@pytest.mark.parametrize("trial", range(3))
def test_claim_parity_prefilled_masked(trial):
    """Claims into a table pre-filled to ~45 %, with interleaved masked-out
    lanes and forced same-home groups, are the JAX claims slot for slot."""
    rng = np.random.default_rng(0xC1A1 + trial)
    cap = 1 << 12
    jt, tt = pair(cap)
    pre = (rng.choice(1 << 20, size=1800, replace=False) + 1).astype(np.uint64)
    jt, tt = insert_both(jt, tt, pre, np.zeros_like(pre), np.ones(1800, bool), pre)
    groups = np.concatenate(same_home(cap, 5, groups=8, start=1 << 21))
    ids = np.concatenate([
        (rng.choice(1 << 20, size=512 - len(groups), replace=False)
         + (1 << 20)).astype(np.uint64), groups])
    rng.shuffle(ids)
    mask = rng.random(512) < 0.8
    jc, jo = jht.claim_slots(jt, jnp.asarray(ids), jnp.zeros(512, jnp.uint64),
                             jnp.asarray(mask), MAX_PROBE)
    tc, to = tht.claim_slots(tt, convert.array_to_tensor(ids, CPU),
                             torch.zeros(512, dtype=torch.int64),
                             torch.from_numpy(mask), MAX_PROBE)
    np.testing.assert_array_equal(convert.tensor_to_array(tc), np.asarray(jc))
    assert bool(to) == bool(jo) is False
    insert_both(jt, tt, ids, np.zeros_like(ids), mask, ids)


@pytest.mark.parametrize("max_probe", [1, 2, 3])
def test_probe_overflow_partial_placement(max_probe):
    """With a probe budget below the cluster depth the batch stops with
    probe_overflow set and the lanes placed so far written, as in JAX."""
    cap = 1 << 8
    jt, tt = pair(cap)
    ids = np.concatenate(same_home(cap, 6, groups=2))
    lo, hi = ids, np.zeros_like(ids)
    jt, tt = insert_both(jt, tt, lo, hi, np.ones(len(ids), bool), ids,
                         max_probe=max_probe)
    assert bool(tt.probe_overflow)
    assert 0 < int(tt.count) <= 2 * max_probe < len(ids)
    lookup_both(jt, tt, lo, hi, max_probe=max_probe)


def test_lookup_with_hash_shift_and_u128_keys():
    rng = np.random.default_rng(3)
    jt, tt = pair(1 << 10)
    lo = rng.integers(1, 1 << 64, 300, dtype=np.uint64)
    hi = rng.integers(0, 4, 300, dtype=np.uint64)
    rows_j = {"val": jnp.asarray(lo), "tag": jnp.zeros(300, jnp.uint32)}
    rows_t = {"val": convert.array_to_tensor(lo, CPU),
              "tag": torch.zeros(300, dtype=torch.int32)}
    jt, _ = jht.insert(jt, jnp.asarray(lo), jnp.asarray(hi),
                       jnp.ones(300, bool), rows_j, MAX_PROBE, hash_shift=2)
    tht.insert(tt, convert.array_to_tensor(lo, CPU), convert.array_to_tensor(hi, CPU),
               torch.ones(300, dtype=torch.bool), rows_t, MAX_PROBE, hash_shift=2)
    arrays_equal(jt, tt)
    j = jht.lookup(jt, jnp.asarray(lo), jnp.asarray(hi), MAX_PROBE, hash_shift=2)
    t = tht.lookup(tt, convert.array_to_tensor(lo, CPU),
                   convert.array_to_tensor(hi, CPU), MAX_PROBE, hash_shift=2)
    np.testing.assert_array_equal(convert.tensor_to_array(t.slot), np.asarray(j.slot))
    assert t.found.all()


def test_grow_rehash_matches_and_drops_tombstones():
    rng = np.random.default_rng(11)
    cap = 1 << 8
    jt, tt = pair(cap)
    ids = (rng.choice(1 << 30, size=110, replace=False) + 1).astype(np.uint64)
    jt, tt = insert_both(jt, tt, ids, np.zeros_like(ids), np.ones(110, bool), ids)
    gone = ids[:40]
    j = jht.lookup(jt, jnp.asarray(gone), jnp.zeros(40, jnp.uint64), MAX_PROBE)
    jt = jht.remove_to_tombstone(jt, j.slot, j.found)
    t = tht.lookup(tt, convert.array_to_tensor(gone, CPU),
                   torch.zeros(40, dtype=torch.int64), MAX_PROBE)
    tt = tht.remove_to_tombstone(tt, t.slot, t.found)
    jg = jht.grow(jt, cap * 2)
    tg = tht.grow(tt, cap * 2)
    arrays_equal(jg, tg)
    assert not tg.tombstone.any() and int(tg.count) == 70


def test_lookup_masks_found_to_count_and_gathers_zero():
    jt, tt = pair(256)
    lo, hi = keys([1, 2, 3, 4])
    jt, tt = insert_both(jt, tt, lo, hi, np.ones(4, bool),
                         np.array([7, 8, 9, 10], np.uint64))
    t = tht.lookup(tt, convert.array_to_tensor(lo, CPU),
                   convert.array_to_tensor(hi, CPU), MAX_PROBE, count=2,
                   cols=("val",))
    assert t.found.tolist() == [True, True, False, False]
    assert t.cols["val"].tolist() == [7, 8, 0, 0]
    assert t.slot[2:].ne(0).all()  # the raw slot stays, as in the JAX code


def test_validate_kernel_column_orders_match_the_cuda_enums():
    """validate.cu reads its inputs by enum index; the Python column tuples
    that feed it must list the same columns in the same order."""
    src = (Path(tsm.__file__).parents[1] / "csrc" / "validate.cu").read_text()

    def enum(name):
        body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
        return [t.strip() for t in body.replace("\n", " ").split(",") if t.strip()]

    want_a = (["A_" + c.upper() for c in tsm.ACCOUNT_BATCH_COLS] + ["A_FOUND"]
              + ["AE_" + c.upper() for c in tsm.ACCOUNT_EXISTS_COLS] + ["A_NPTRS"])
    want_t = (["T_" + c.upper() for c in tsm.TRANSFER_BATCH_COLS]
              + ["TC_" + c.upper() for c in tsm.TRANSFER_CTX_COLS]
              + ["TE_" + c.upper() for c in tsm.TRANSFER_EXISTS_COLS] + ["T_NPTRS"])
    assert enum("AccountCol") == want_a
    assert enum("TransferCol") == want_t


# -- K1's rounds and its fused launch: testing/k1cases.py ---------------------


def _jax_table(t):
    return jht.Table(key_lo=jnp.asarray(t["key_lo"]), key_hi=jnp.asarray(t["key_hi"]),
                     tombstone=jnp.asarray(t["tombstone"]),
                     cols={k: jnp.asarray(v) for k, v in t["cols"].items()},
                     count=jnp.asarray(t["count"]),
                     probe_overflow=jnp.asarray(t["probe_overflow"]))


def _port_table(t):
    return tht.Table(convert.array_to_tensor(t["key_lo"], CPU),
                     convert.array_to_tensor(t["key_hi"], CPU),
                     torch.from_numpy(t["tombstone"].copy()),
                     {k: convert.array_to_tensor(v, CPU) for k, v in t["cols"].items()},
                     torch.tensor(int(t["count"])), torch.tensor(False))


def _jax_lookup(t, lo, hi, max_probe, shift, count, mask, cols):
    """The JAX package's lookup + gather_cols, masked as K1 masks ``found``:
    (found, slot, overflow, gathered columns) as numpy."""
    jt = _jax_table(t)
    j = jht.lookup(jt, jnp.asarray(lo), jnp.asarray(hi), max_probe, shift)
    valid = np.asarray(j.found) & (np.arange(len(lo)) < count)
    if mask is not None:
        valid &= mask
    g = jht.gather_cols(jt, j.slot, jnp.asarray(valid))
    return (valid, np.asarray(j.slot), bool(j.overflow),
            {c: np.asarray(g[c]) for c in cols})


def _assert_lookup(got, want, cols):
    found, slot, overflow, gathered = want
    np.testing.assert_array_equal(got.found.numpy(), found)
    np.testing.assert_array_equal(convert.tensor_to_array(got.slot).view(np.uint64),
                                  slot)
    assert bool(got.overflow) == overflow
    for c in cols:
        np.testing.assert_array_equal(convert.tensor_to_array(got.cols[c]),
                                      gathered[c], err_msg=c)


@pytest.mark.parametrize("name", k1cases.CASES)
@pytest.mark.parametrize("plain", ["split", "serial"])
def test_k1cases_match_jax(name, plain):
    """K1's plain forms on its trap cases against the JAX package's
    ``lookup`` + ``gather_cols``: the split form (the card's rounds over
    aligned groups of four slots) and the slot-a-step form, byte for byte,
    overflow included."""
    t, looks, max_probe = k1cases.case(name)
    fn = tht.lookup_split_plain if plain == "split" else tht.lookup_plain
    for lk in looks:
        lo, hi = lk["key_lo"], lk["key_hi"]
        mask = lk["mask"]
        got = fn(_port_table(t), convert.array_to_tensor(lo, CPU),
                 convert.array_to_tensor(hi, CPU), max_probe, lk["hash_shift"],
                 lk["count"], ("val", "tag"),
                 None if mask is None else torch.from_numpy(mask))
        _assert_lookup(got, _jax_lookup(t, lo, hi, max_probe, lk["hash_shift"],
                                        lk["count"], mask, ("val", "tag")),
                       ("val", "tag"))
    if name.startswith("max_probe"):
        assert bool(got.overflow)


def test_k1_fused_lookups_match_jax():
    """``lookup_many``'s lookups of several tables in one call, two of them
    keyed by a first lookup's gathered column, against the JAX package's
    lookups one after another."""
    tables, looks = k1cases.fused_case()
    port = [_port_table(t) for t in tables]
    specs = []
    for lk in looks:
        specs.append(tht.Lookup(
            port[lk["table"]],
            None if lk["key_lo"] is None else convert.array_to_tensor(lk["key_lo"], CPU),
            None if lk["key_hi"] is None else convert.array_to_tensor(lk["key_hi"], CPU),
            lk["cols"], None if lk["mask"] is None else torch.from_numpy(lk["mask"]),
            lk["count"], keys_from=lk["keys_from"]))
    got = tht.lookup_many(specs, k1cases.MAX_PROBE)
    want = []
    for lk in looks:
        if lk["keys_from"] is None:
            lo = lk["key_lo"]
        else:
            j, name, _hi = lk["keys_from"]
            lo = want[j][3][name]
        hi = np.zeros_like(lo) if lk["key_hi"] is None else lk["key_hi"]
        want.append(_jax_lookup(tables[lk["table"]], lo, hi, k1cases.MAX_PROBE, 0,
                                lk["count"], lk["mask"], ("val", "tag")))
    for g, w, lk in zip(got, want, looks):
        _assert_lookup(g, w, lk["cols"])
    assert got[2].found.any() and got[3].found.any()
    assert [g.overflow for g in tht.lookup_many(specs[:2], 4, overflow=False)] \
        == [None, None]
