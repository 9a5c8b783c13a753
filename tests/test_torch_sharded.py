"""The port's sharded steps (``tigerbeetle_tpu_torch/parallel``) against the
JAX package's on the same 8-shard mesh, byte for byte.

The JAX side runs conftest's 8 virtual CPU devices; the port's mesh is
``device.force_virtual(8, "cpu")``: eight shards whose local tables all lie
on the CPU, through the plain versions of K30 and K31 and the other
kernels.  The shapes are tests/test_sharded.py's: 256 lanes, global
capacities 2^12 (accounts), 2^13 (transfers) and 2^10 (posted).  Every
step's codes, every shard's table arrays, ``count`` and ``probe_overflow``
must be equal."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from tigerbeetle_tpu import types as jtypes
from tigerbeetle_tpu.parallel import sharded as jsh
from tigerbeetle_tpu.testing.workload import WorkloadGen
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch import device as tdev
from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.ops import _cuda
from tigerbeetle_tpu_torch.ops import hash_table as ht
from tigerbeetle_tpu_torch.parallel import mesh as tmesh
from tigerbeetle_tpu_torch.parallel import sharded as tsh
from tigerbeetle_tpu_torch.testing import k30cases

LANES = 256
CPU = torch.device("cpu")
CAPS = (1 << 12, 1 << 13, 1 << 10)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip(f"needs 8 JAX devices, have {len(jax.devices())}")
    tdev.force_virtual(8, "cpu")
    try:
        yield (JMesh(np.array(jax.devices()[:8]), (jsh.AXIS,)),
               tmesh.Mesh(tdev.devices("cpu")))
    finally:
        tdev.force_virtual(0, "cpu")


def assert_equal(want, got, path=""):
    if isinstance(want, dict):
        assert want.keys() == got.keys(), path
        for k in want:
            assert_equal(want[k], got[k], f"{path}/{k}")
        return
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype, path
    np.testing.assert_array_equal(got, want, err_msg=path)


def jsoa(batch):
    padded = np.zeros(LANES, dtype=batch.dtype)
    padded[: len(batch)] = batch
    return {k: jnp.asarray(v) for k, v in jtypes.to_soa(padded).items()}


def tsoa(batch):
    return convert.batch_to_tensors(batch, LANES, CPU)


class Pair:
    """A JAX sharded ledger and the port's, fed the same batches."""

    def __init__(self, meshes):
        self.jm, self.tm = meshes
        self.j = jsh.make_sharded_ledger(self.jm, *CAPS)
        self.t = tsh.make_sharded_ledger(self.tm, *CAPS)
        self.ts = 1_000

    def check(self):
        assert_equal(convert.ledger_arrays(self.j),
                     convert.sharded_ledger_to_numpy(self.t))

    def run(self, jstep, tstep, batch, extra=0):
        """One step on both; asserts the codes (and the extra outputs) and
        every array equal, returns the port's extra outputs."""
        self.ts += len(batch)
        jr = jstep(self.j, jsoa(batch), jnp.uint64(len(batch)),
                   jnp.uint64(self.ts))
        tr = tstep(self.t, tsoa(batch), len(batch), self.ts)
        self.j = jr[0]
        for k, (a, b) in enumerate(zip(jr[1:], tr[1:])):
            assert_equal(np.asarray(a).astype(np.int64),
                         convert.tensor_to_array(b).astype(np.int64),
                         f"output {k}")
        self.check()
        return tr[1:]


def _accounts(n, first=1, flags=0):
    return types.accounts_array([
        types.account(id=first + i, ledger=1, code=10, flags=flags)
        for i in range(n)])


def test_accounts_fast_and_probed_steps_match_jax(meshes):
    jm, tm = meshes
    p = Pair(meshes)
    gen = WorkloadGen(seed=21)
    p.run(jsh.sharded_create_accounts(jm), tsh.sharded_create_accounts(tm),
          gen.accounts_batch(32))
    fast = (jsh.sharded_create_transfers(jm), tsh.sharded_create_transfers(tm))
    for _ in range(4):
        p.run(*fast, gen.transfers_batch(100, invalid_rate=0.2, dup_rate=0.1,
                                         pending_rate=0.2))
    probed = (jsh.sharded_create_transfers(jm, probed=True),
              tsh.sharded_create_transfers(tm, probed=True))
    codes, overflow = p.run(*probed, gen.transfers_batch(90, invalid_rate=0.1,
                                                         dup_rate=0.1))
    assert overflow.dtype == torch.int32 and overflow.shape == (8,)
    assert not bool(p.t.accounts.probe_overflow.any())


def test_lookup_step_matches_jax(meshes):
    jm, tm = meshes
    p = Pair(meshes)
    gen = WorkloadGen(seed=33)
    accounts = gen.accounts_batch(24)
    p.run(jsh.sharded_create_accounts(jm), tsh.sharded_create_accounts(tm),
          accounts)
    batch = gen.transfers_batch(80, invalid_rate=0.0, dup_rate=0.0,
                                pending_rate=0.0)
    p.run(jsh.sharded_create_transfers(jm), tsh.sharded_create_transfers(tm),
          batch)
    for name, ids in (
        ("accounts", [int(i) for i in accounts["id_lo"][:8]] + [999_999, 0]),
        ("transfers", [int(t) for t in batch["id_lo"][:6]] + [123_456_789]),
    ):
        lo = np.array(ids + [0] * (LANES - len(ids)), np.uint64)
        hi = np.zeros(LANES, np.uint64)
        jf, jrows = jsh.sharded_lookup(jm, name)(p.j, jnp.asarray(lo),
                                                 jnp.asarray(hi))
        tf_, trows = tsh.sharded_lookup(tm, name)(
            p.t, convert.array_to_tensor(lo, CPU),
            convert.array_to_tensor(hi, CPU))
        assert_equal(np.asarray(jf), convert.tensor_to_array(tf_))
        assert_equal({k: np.asarray(v) for k, v in jrows.items()},
                     convert.tensors_to_arrays(trows))


PENDING = jtypes.TransferFlags.PENDING
POST = jtypes.TransferFlags.POST_PENDING_TRANSFER
VOID = jtypes.TransferFlags.VOID_PENDING_TRANSFER
BAL_DR = jtypes.TransferFlags.BALANCING_DEBIT
DRLIM = jtypes.AccountFlags.DEBITS_MUST_NOT_EXCEED_CREDITS


def _transfers(specs):
    return types.transfers_array([types.transfer(**s) for s in specs])


@pytest.mark.parametrize("waves", [False, True])
def test_full_step_matches_jax(meshes, waves):
    """tests/test_sharded.py's two-phase, balancing and limit stream through
    the general step: codes, kflags, the wave vector and every array."""
    jm, tm = meshes
    p = Pair(meshes)
    p.run(jsh.sharded_create_accounts(jm), tsh.sharded_create_accounts(tm),
          types.accounts_array([
              types.account(id=i + 1, ledger=1, code=10,
                            flags=DRLIM if i < 4 else 0)
              for i in range(16)]))
    full = (jsh.sharded_create_transfers_full(jm, use_waves=waves),
            tsh.sharded_create_transfers_full(tm, use_waves=waves))
    stream = [
        [dict(id=100 + i, debit_account_id=5 + i % 12,
              credit_account_id=1 + i % 4, amount=10_000, ledger=1, code=1)
         for i in range(24)],
        [dict(id=200 + i, debit_account_id=1 + i % 8,
              credit_account_id=9 + i % 8, amount=50 + i, ledger=1, code=1,
              flags=PENDING) for i in range(16)],
        [dict(id=300 + i, pending_id=200 + i, ledger=1, code=1,
              flags=POST if i % 2 == 0 else VOID) for i in range(8)]
        + [dict(id=400 + i, debit_account_id=1 + i % 8,
                credit_account_id=9 + i % 8, amount=30, ledger=1, code=1,
                flags=PENDING) for i in range(4)]
        + [dict(id=500 + i, pending_id=400 + i, ledger=1, code=1, flags=POST)
           for i in range(4)],
        [dict(id=600, debit_account_id=1, credit_account_id=9, amount=0,
              ledger=1, code=1, flags=BAL_DR),
         dict(id=601, debit_account_id=1, credit_account_id=9, amount=5,
              ledger=1, code=1),
         dict(id=602, debit_account_id=2, credit_account_id=10, amount=400,
              ledger=1, code=1, flags=BAL_DR),
         dict(id=603, debit_account_id=6, credit_account_id=12, amount=77,
              ledger=1, code=1),
         dict(id=300, pending_id=200, ledger=1, code=1, flags=POST)],
    ]
    for specs in stream:
        out = p.run(*full, _transfers(specs))
        assert int(out[1]) == 0, "the stream commits on the general step"


def test_full_step_routes_history_with_nothing_applied(meshes):
    from tigerbeetle_tpu_torch.ops import transfer_full as ttf

    jm, tm = meshes
    p = Pair(meshes)
    p.run(jsh.sharded_create_accounts(jm), tsh.sharded_create_accounts(tm),
          types.accounts_array([
              types.account(id=1, ledger=1, code=10,
                            flags=jtypes.AccountFlags.HISTORY),
              types.account(id=2, ledger=1, code=10)]))
    out = p.run(jsh.sharded_create_transfers_full(jm),
                tsh.sharded_create_transfers_full(tm),
                _transfers([dict(id=50, debit_account_id=1,
                                 credit_account_id=2, amount=5, ledger=1,
                                 code=1)]))
    assert int(out[1]) & ttf.FLAG_SEQ


def test_scrub_lanes_and_merkle_steps_match_jax(meshes):
    jm, tm = meshes
    p = Pair(meshes)
    p.run(jsh.sharded_create_accounts(jm), tsh.sharded_create_accounts(tm),
          _accounts(12))
    jsteps, tsteps = jsh.merkle_steps(jm), tsh.merkle_steps(tm)
    jf, tf_ = jsteps["build"](p.j), tsteps["build"](p.t)
    full = (jsh.sharded_create_transfers_full(jm),
            tsh.sharded_create_transfers_full(tm))
    batches = [
        [dict(id=10 + i, debit_account_id=1 + i % 12,
              credit_account_id=1 + (i + 3) % 12, amount=7, ledger=1, code=1,
              flags=PENDING if i % 3 == 0 else 0) for i in range(18)],
        [dict(id=40 + i, pending_id=10 + 3 * i, ledger=1, code=1,
              flags=POST if i % 2 else VOID) for i in range(6)],
    ]
    for specs in batches:
        batch = _transfers(specs)
        p.run(*full, batch)
        pv = bool((batch["flags"] & (POST | VOID)).any())
        keys = {
            "id": (batch["id_lo"], batch["id_hi"]),
            "acc": (np.concatenate([batch["debit_account_id_lo"],
                                    batch["credit_account_id_lo"]]),
                    np.concatenate([batch["debit_account_id_hi"],
                                    batch["credit_account_id_hi"]])),
            "pend": (batch["pending_id_lo"], batch["pending_id_hi"]),
        }
        jargs, targs = [], []
        for lo, hi in keys.values():
            pl = np.zeros(64, np.uint64)
            ph = np.zeros(64, np.uint64)
            pl[:len(lo)], ph[:len(hi)] = lo, hi
            jargs += [jnp.asarray(pl), jnp.asarray(ph)]
            targs += [convert.array_to_tensor(pl, CPU),
                      convert.array_to_tensor(ph, CPU)]
        name = "update_transfers_pv" if pv else "update_transfers"
        jf = jsteps[name](jf, p.j, *jargs)
        tf_ = tsteps[name](tf_, p.t, *targs)
        assert_equal({k: np.asarray(getattr(jf, k)) for k in convert.TABLES},
                     convert.sharded_forest_to_numpy(tf_))
    acc = np.array([3, 5, 0, 0], np.uint64)
    jf = jsteps["update_accounts"](jf, p.j, jnp.asarray(acc),
                                   jnp.zeros(4, jnp.uint64))
    tf_ = tsteps["update_accounts"](tf_, p.t, convert.array_to_tensor(acc, CPU),
                                    torch.zeros(4, dtype=torch.int64))
    assert_equal(np.asarray(jsteps["verify"](jf, p.j)),
                 convert.tensor_to_array(tsteps["verify"](tf_, p.t)))
    assert_equal(np.asarray(jsteps["roots"](jf)),
                 convert.tensor_to_array(tsteps["roots"](tf_)))
    assert_equal(np.asarray(jsh.sharded_scrub_digest(jm)(p.j)),
                 convert.tensor_to_array(tsh.sharded_scrub_digest(tm)(p.t)))


# -- K30 and K31's plain versions on hand-built cases -----------------------------


def _owned_keys(n_shards, shard, k, start=1):
    """``k`` keys (lo, hi = 0) that ``shard`` owns, from ``start`` up."""
    cand = np.arange(start, start + 64 * k * n_shards, dtype=np.uint64)
    own = tsh.mix64_np(cand, np.zeros_like(cand)) & np.uint64(n_shards - 1)
    return cand[own == shard][:k]


def test_shard_gather_plain_owner_miss_and_overflow():
    n_shards, local = 4, 16
    tables = [ht.make_table(local, {"v": torch.int64, "w": torch.int32}, CPU)
              for _ in range(n_shards)]
    shift = 2
    # Shard 1 holds three of its own keys; shard 2's whole table is full of
    # its keys, so every probe there runs out (max_probe < local).
    held = _owned_keys(n_shards, 1, 3)
    full = _owned_keys(n_shards, 2, local, start=10_000)
    for s, keys in ((1, held), (2, full)):
        lo = convert.array_to_tensor(keys, CPU)
        ht.insert(tables[s], lo, torch.zeros_like(lo),
                  torch.ones(len(keys), dtype=torch.bool),
                  {"v": lo * 3, "w": (lo + 7).to(torch.int32) | (-1 << 31)},
                  max_probe=local, hash_shift=shift)
    missing = _owned_keys(n_shards, 1, 1, start=50_000)
    other = _owned_keys(n_shards, 3, 1, start=60_000)
    q = np.concatenate([held, missing, other, np.zeros(1, np.uint64)])
    lo = convert.array_to_tensor(q, CPU)
    hi = torch.zeros_like(lo)
    n = len(q)
    names = ("v", "w")
    width = (2 + len(names)) * n
    for want_overflow in (False, True):
        # Every lane of a row is written: only the overflow word starts at
        # zero (GatherRound.run allocates no zeroed row).  One device
        # holding every shard writes one row; a device a shard writes that
        # shard's own row (zeros where it does not own the lane), and the
        # rows' sum across those devices is the one row.
        one = torch.full((width + 1,), -7, dtype=torch.int64)
        one[-1] = 0
        tsh.shard_gather_plain(tables, range(n_shards), n_shards, lo, hi,
                               names, 4, n - 1, None, one, 0, width,
                               want_overflow)
        out = torch.full((n_shards, width + 1), -7, dtype=torch.int64)
        out[:, -1] = 0
        for s in range(n_shards):
            tsh.shard_gather_plain([tables[s]], [s], n_shards, lo, hi, names,
                                   4, n - 1, None, out[s], 0, width,
                                   want_overflow)
        rows = out[:, :-1].view(n_shards, 2 + len(names), n)
        total = tmesh.shard_combine_plain(out)
        # Only the owner of a found key answers; everything else is zero.
        for s in range(n_shards):
            if s != 1:
                assert not rows[s].any(), s
        found = rows[1, 0].tolist()
        assert found == [1, 1, 1, 0, 0, 0]
        for i in range(3):
            tbl = tables[1]
            slot = int(rows[1, 1, i]) - 1 * local
            assert int(tbl.key_lo[slot]) == int(held[i])
            assert int(rows[1, 2, i]) == 3 * int(held[i])
            # The u32 column arrives zero-extended.
            assert int(rows[1, 3, i]) == (int(held[i]) + 7) | (1 << 31)
        # Shard 2's full table overflows every probe of its region: only
        # with want_overflow do the other shards' keys probe it (and the
        # owned key of shard 2 is none of the queried keys).
        assert int(out[2, -1]) == int(want_overflow)
        assert int(total[-1]) == int(want_overflow)
        assert torch.equal(total[:-1], out[1, :-1])
        assert torch.equal(one, total)
    # A lane mask and the count hide found rows.
    out = torch.zeros(4 * n + 1, dtype=torch.int64)
    mask = torch.tensor([True, False, True, True, True, True])
    tsh.shard_gather_plain(tables, range(n_shards), n_shards, lo, hi, names,
                           4, 2, mask, out, 0, 4 * n, False)
    assert out[:n].tolist() == [1, 0, 0, 0, 0, 0]


def _jax_gather(c, n_shards):
    """JAX ``_ShardGather`` over an ``n_shards`` mesh of the case's tables:
    found, global slot, the two columns (each psummed) and ``any_shard`` of
    the local probes' overflow flags."""
    from tigerbeetle_tpu.jaxenv import shard_map
    from tigerbeetle_tpu.ops import hash_table as jht
    from jax.sharding import PartitionSpec as P

    tabs = c["tables"]
    cat = lambda k: np.concatenate([t[k] for t in tabs])  # noqa: E731
    table = jht.Table(
        key_lo=jnp.asarray(cat("key_lo").view(np.uint64)),
        key_hi=jnp.asarray(cat("key_hi").view(np.uint64)),
        tombstone=jnp.asarray(cat("tombstone")),
        cols={"v": jnp.asarray(cat("v").view(np.uint64)),
              "w": jnp.asarray(cat("w").view(np.uint32))},
        count=jnp.zeros((n_shards,), jnp.uint64),
        probe_overflow=jnp.zeros((n_shards,), jnp.bool_))
    mesh = JMesh(np.array(jax.devices()[:n_shards]), (jsh.AXIS,))
    shift = n_shards.bit_length() - 1

    def body(t, lo, hi):
        g = jsh._ShardGather(t, lo, hi, n_shards, shift)
        rows = g.rows(t)
        ovf = jax.lax.psum(g.overflow_l.astype(jnp.uint32), jsh.AXIS) > 0
        return g.found, g.gslot, rows["v"], rows["w"], ovf

    specs = jax.tree_util.tree_map(lambda _: P(jsh.AXIS), table)
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(specs, P(), P()),
                           out_specs=(P(), P(), P(), P(), P()),
                           check_vma=False))
    out = fn(table, jnp.asarray(c["lo"].view(np.uint64)),
             jnp.asarray(c["hi"].view(np.uint64)))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("want_overflow", [False, True])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("name", k30cases.CASES)
def test_shard_gather_one_row_cases_match_jax(meshes, name, n_shards,
                                              want_overflow):
    """K30's plain form, one answer row a device group
    (``testing/k30cases.py``), summed across the groups as NCCL sums them:
    found, the global slot and the columns equal JAX ``_ShardGather``'s
    psums (masked by the count and the lane mask), the overflow word its
    ``any_shard`` when asked and zero when not; and each group's row is
    zero on the lanes whose owner it does not hold."""
    from tigerbeetle_tpu_torch.ops.state_machine import MAX_PROBE

    c = k30cases.case(name, n_shards)
    tables = k30cases.to_tables(c, CPU)
    lo, hi = torch.from_numpy(c["lo"]), torch.from_numpy(c["hi"])
    n = lo.numel()
    mask = None if c["mask"] is None else torch.from_numpy(c["mask"])
    names = ("v", "w")
    width = (2 + len(names)) * n
    own = k30cases.owners(c["lo"], c["hi"], n_shards)
    rows = []
    for shards in c["devices"]:
        row = torch.full((width + 1,), -3, dtype=torch.int64)
        row[-1] = 0
        tsh.shard_gather_plain([tables[s] for s in shards], shards, n_shards,
                               lo, hi, names, MAX_PROBE, c["count"], mask,
                               row, 0, width, want_overflow)
        foreign = ~np.isin(own, shards)
        assert not row[:-1].view(2 + len(names), n).numpy()[:, foreign].any()
        rows.append(row)
    total = sum(rows[1:], rows[0]).numpy()
    j_found, j_slot, j_v, j_w, j_ovf = _jax_gather(c, n_shards)
    keep = j_found & (np.arange(n) < c["count"])
    if c["mask"] is not None:
        keep &= c["mask"]
    seg = total[:-1].reshape(2 + len(names), n)
    np.testing.assert_array_equal(seg[0], keep.astype(np.int64))
    np.testing.assert_array_equal(seg[1].view(np.uint64),
                                  np.where(keep, j_slot, 0))
    np.testing.assert_array_equal(seg[2].view(np.uint64),
                                  np.where(keep, j_v, 0))
    np.testing.assert_array_equal(seg[3].view(np.uint64),
                                  np.where(keep, j_w, 0).astype(np.uint64))
    assert int(total[-1]) == (int(bool(j_ovf)) if want_overflow else 0)
    if name == "overflow" and want_overflow:
        assert bool(j_ovf)
    assert keep.sum() > 0
    if name == "no_local_owner":
        assert not rows[0][:-1].any()


def test_shard_combine_plain_wraps():
    p = torch.tensor([[-1, 5, 1 << 62], [1, 0, 1 << 62]], dtype=torch.int64)
    assert tmesh.shard_combine_plain(p).tolist() == [0, 5, -(1 << 63)]


def test_mesh_groups_repeated_devices():
    m = tmesh.Mesh([CPU] * 4)
    assert m.size == 4 and m.shift == 2
    assert m.groups == ((CPU, (0, 1, 2, 3)),)
    with pytest.raises(ValueError):
        tmesh.Mesh([CPU] * 3)


def test_devices_force_virtual():
    saved = dict(tdev._VIRTUAL)
    try:
        tdev.force_virtual(0, "cpu")
        assert tdev.devices("cpu") == [CPU]
        tdev.force_virtual(4, "cpu")
        assert tdev.devices("cpu") == [CPU] * 4
        tdev.force_virtual(2, "cuda:0")  # another type's setting
        assert tdev.devices("cpu") == [CPU] * 4
        tdev.force_virtual(0, "cpu")
        assert tdev.devices("cpu") == [CPU]
    finally:
        tdev._VIRTUAL.clear()
        tdev._VIRTUAL.update(saved)


# -- the host converters ------------------------------------------------------------


@pytest.mark.parametrize("case", ["same_home", "cross_group", "random"])
def test_probe_place_matches_its_reference(case):
    rng = np.random.default_rng(5)
    if case == "same_home":
        homes = np.full(40, 7, np.uint64)
        base = np.zeros(40, np.int64)
        mask, cap = 63, 64
    elif case == "cross_group":
        homes = np.array([5, 5, 6, 5, 7, 6, 62, 63, 63, 0], np.uint64)
        base = np.zeros(10, np.int64)
        mask, cap = 63, 64
    else:
        homes = rng.integers(0, 128, 300).astype(np.uint64)
        base = rng.integers(0, 4, 300).astype(np.int64) * 128
        mask, cap = 127, 512
    assert np.array_equal(tsh._probe_place(homes, base, mask, cap),
                          tsh._probe_place_ref(homes, base, mask, cap))
    assert np.array_equal(tsh._probe_place(homes, base, mask, cap),
                          jsh._probe_place(homes, base, mask, cap))


def test_unshard_and_shard_round_trip_against_jax(meshes):
    jm, tm = meshes
    p = Pair(meshes)
    gen = WorkloadGen(seed=8)
    p.run(jsh.sharded_create_accounts(jm), tsh.sharded_create_accounts(tm),
          gen.accounts_batch(40))
    for _ in range(2):
        p.run(jsh.sharded_create_transfers(jm),
              tsh.sharded_create_transfers(tm),
              gen.transfers_batch(120, invalid_rate=0.1, dup_rate=0.05))
    jcanon = jsh.unshard_ledger(p.j, jm)
    tcanon = tsh.unshard_ledger(p.t, tm)
    assert_equal(convert.ledger_arrays(jcanon), convert.ledger_to_numpy(tcanon))
    back = tsh.shard_ledger(tcanon, tm)
    assert_equal(convert.ledger_arrays(jsh.shard_ledger(jcanon, jm)),
                 convert.sharded_ledger_to_numpy(back))
    assert_equal(convert.ledger_arrays(p.j),
                 convert.sharded_ledger_to_numpy(back))
    grown = tsh.grow_sharded_table(p.t.transfers, "transfers", 1 << 14, tm)
    jgrown = jsh.grow_sharded_table(p.j.transfers, "transfers", 1 << 14, jm)
    assert_equal(convert.table_arrays(jgrown),
                 convert.sharded_ledger_to_numpy(tsh.ShardedLedger(
                     tm, grown, grown, grown, p.t.history))["transfers"])
    arrays = convert.ledger_arrays(jcanon)
    for old in (2, 4):
        assert np.array_equal(
            tsh.split_moved_mask(arrays["accounts"]["key_lo"],
                                 arrays["accounts"]["key_hi"], old),
            jsh.split_moved_mask(arrays["accounts"]["key_lo"],
                                 arrays["accounts"]["key_hi"], old))


def test_sharded_ledger_exchange_round_trip(meshes):
    jm, tm = meshes
    p = Pair(meshes)
    p.run(jsh.sharded_create_accounts(jm), tsh.sharded_create_accounts(tm),
          WorkloadGen(seed=2).accounts_batch(20))
    arrays = convert.ledger_arrays(p.j)
    again = convert.sharded_ledger_from_numpy(arrays, tm)
    assert_equal(arrays, convert.sharded_ledger_to_numpy(again))


# -- the bindings ----------------------------------------------------------------------


def test_every_entry_point_binds_with_its_c_arity():
    """Each ``extern "C" int tb_*`` of csrc/ has as many ctypes argument
    types in ``_cuda._bind`` as parameters: a mismatch would pass garbage
    to a kernel on the card, which no CPU test otherwise sees."""
    src = "".join(p.read_text()
                  for p in (ROOT / "tigerbeetle_tpu_torch/csrc").glob("*.cu"))
    arity = {
        m.group(1): len([a for a in m.group(2).split(",") if a.strip()])
        for m in re.finditer(r'extern "C" int (tb_\w+)\(([^)]*)\)', src)
    }

    class Lib:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            fn = self.fns.setdefault(name, type("Fn", (), {})())
            return fn

    lib = Lib()
    _cuda._bind(lib)
    bound = {k: len(v.argtypes) for k, v in lib.fns.items()
             if k != "tb_error_string"}
    assert bound == arity
    assert {"tb_shard_gather", "tb_shard_combine"} <= set(bound)
