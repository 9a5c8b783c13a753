"""The port's general transfer kernel (``tigerbeetle_tpu_torch.ops.
transfer_full``) against the JAX package's (``tigerbeetle_tpu.ops.
transfer_full``) on the CPU, on the same seeded numpy inputs, exactly: the
id index, the leg balances, the wave schedule, every field of the kernel
core's ApplyPlan, and ``create_transfers_full_impl``'s codes, flags, wave
vector and every ledger array, for each static hint, waves on and off, and
each routing flag (a flagged attempt leaves the ledger as it was).  On the
CPU the port runs the plain versions of kernels K9-K12; the kernels are held
against them on the card (tests/test_torch_kernels.py and chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu import types
from tigerbeetle_tpu.ops import scan_path as jsp
from tigerbeetle_tpu.ops import state_machine as jsm
from tigerbeetle_tpu.ops import transfer_full as jtf
from tigerbeetle_tpu.types import TransferFlags as F
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.ops import transfer_full as ttf
from tigerbeetle_tpu_torch.testing import fullmix, fulltraps, k10cases, seqmix

LANES = 64
CAPS = (1 << 10, 1 << 11, 1 << 10, 1 << 10)
CPU = torch.device("cpu")
U64 = (1 << 64) - 1
U128_MAX = (1 << 128) - 1


def t64(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64)
                            .view(np.int64).copy())


def np64(t):
    return t.numpy().view(np.uint64)


def rand_u64(rng, n, hi=1 << 64):
    return rng.integers(0, hi, size=n, dtype=np.uint64)


# -- the id index ---------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_id_index_and_group_winner(seed):
    """Groups (with duplicates, id 0 and padding), any_dup, the pending join
    and the per-group first-ok winner equal the JAX functions'; JAX labels a
    group by sorted position, the port by its lowest lane."""
    rng = np.random.default_rng(seed)
    n = 128
    lo = rng.integers(1, 24, n).astype(np.uint64)
    hi = np.where(rng.random(n) < 0.3, 1, 0).astype(np.uint64)
    lo[rng.random(n) < 0.1] = 0
    hi[lo == 0] = 0
    lo[100:] = 0  # padding lanes
    hi[100:] = 0
    plo = rng.integers(0, 30, n).astype(np.uint64)
    phi = np.where(rng.random(n) < 0.3, 1, 0).astype(np.uint64)
    ok = rng.random(n) < 0.4

    jidx = jtf._build_id_index(jnp.asarray(lo), jnp.asarray(hi))
    gid = np.asarray(jidx.group_of_lane)
    leader = np.array([np.flatnonzero(gid == g).min() for g in gid])
    pj = np.asarray(jtf._search128(jidx.s_hi, jidx.s_lo, jnp.asarray(phi),
                                   jnp.asarray(plo)))
    pj_c = np.minimum(pj, n - 1)
    s_lo, s_hi = np.asarray(jidx.s_lo), np.asarray(jidx.s_hi)
    pj_hit = (s_hi[pj_c] == phi) & (s_lo[pj_c] == plo) & (pj < n)
    pj_leader = np.where(pj_hit, leader[np.asarray(jidx.order)[pj_c]], 0)
    jwin_g, jwin = jtf._group_winner(jidx, jnp.asarray(ok))

    idx = ttf._build_id_index(t64(lo), t64(hi), t64(plo), t64(phi))
    np.testing.assert_array_equal(idx.group_of_lane.numpy(), leader)
    assert bool(idx.any_dup) == bool(jidx.any_dup)
    np.testing.assert_array_equal(idx.pj_hit.numpy(), pj_hit)
    np.testing.assert_array_equal(idx.pj_group.numpy(), pj_leader)
    win_g, win = ttf._group_winner(idx, torch.from_numpy(ok))
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
    # Per group: the JAX group at a lane's sorted position, the port's at
    # the lane's leader.
    np.testing.assert_array_equal(win_g.numpy()[leader],
                                  np.asarray(jwin_g)[gid])


# -- the leg balances -----------------------------------------------------------


def leg_inputs(rng, n, near_max):
    cap = 1 << 9
    start = {}
    for f in ttf._BAL_FIELDS:
        hi_top = (1 << 64) if near_max else (1 << 20)
        lo_ = rand_u64(rng, n)
        hi_ = rand_u64(rng, n, hi_top)
        if near_max:
            hi_ = np.where(rng.random(n) < 0.5, np.uint64(U64), hi_)
        start[f] = (lo_, hi_)
    slots = rng.integers(0, 24, (2, n)).astype(np.uint64)
    live = rng.random((2, n)) < 0.9
    flags = rng.integers(0, 4, n)
    return dict(
        cap=cap, start=start, ok=rng.random(n) < 0.7,
        amt=rand_u64(rng, n, 1 << 64 if near_max else 1 << 40),
        pamt=rand_u64(rng, n, 1 << 40), slots=slots, live=live,
        pending=flags == 1, post=flags == 2, postvoid=flags >= 2)


@pytest.mark.parametrize("has_postvoid", [True, False])
@pytest.mark.parametrize("near_max", [False, True])
def test_leg_balances(has_postvoid, near_max):
    rng = np.random.default_rng(7 + has_postvoid + 2 * near_max)
    n = 96
    x = leg_inputs(rng, n, near_max)
    pv = x["postvoid"] & has_postvoid
    post = x["post"] & has_postvoid
    # Each LEG's start balances: the start of its account, interleaved.
    jstart, tstart = {}, {}
    for f, (lo, hi) in x["start"].items():
        for s, col in (("_lo", lo), ("_hi", hi)):
            leg = np.stack([col, col[::-1]], 1).reshape(-1)
            jstart[f + s] = jnp.asarray(leg)
            tstart[f + s] = t64(leg)
    j = jtf._leg_balances(
        jstart, jnp.uint64(x["cap"]), jnp.asarray(x["ok"]),
        jnp.asarray(x["amt"]), jnp.asarray(x["pamt"]),
        jnp.asarray(x["slots"][0]), jnp.asarray(x["slots"][1]),
        jnp.asarray(x["live"][0]), jnp.asarray(x["live"][1]),
        jnp.asarray(x["pending"]), jnp.asarray(post), jnp.asarray(pv),
        has_postvoid=has_postvoid)
    t = ttf._leg_balances(
        tstart, x["cap"], torch.from_numpy(x["ok"]), t64(x["amt"]),
        t64(x["pamt"]), t64(x["slots"][0]), t64(x["slots"][1]),
        torch.from_numpy(x["live"][0]), torch.from_numpy(x["live"][1]),
        torch.from_numpy(x["pending"]), torch.from_numpy(post),
        torch.from_numpy(pv), has_postvoid)
    np.testing.assert_array_equal(t.leg_pos.numpy(), np.asarray(j.leg_pos))
    for name in ("dp_pre", "dp_incl", "dpo_pre", "dpo_incl", "cp_pre",
                 "cp_incl", "cpo_pre", "cpo_incl"):
        jv, tv = getattr(j, name), getattr(t, name)
        np.testing.assert_array_equal(np64(tv.lo), np.asarray(jv.lo), name)
        np.testing.assert_array_equal(np64(tv.hi), np.asarray(jv.hi), name)
    np.testing.assert_array_equal(np64(t.s_slot), np.asarray(j.s_slot))
    np.testing.assert_array_equal(t.s_live.numpy(), np.asarray(j.s_live))
    np.testing.assert_array_equal(t.is_last.numpy(), np.asarray(j.is_last))
    assert bool(t.arith_broken) == bool(j.arith_broken)
    if near_max:
        assert bool(t.arith_broken)


def test_limbs_to_u128():
    rng = np.random.default_rng(3)
    lo = rand_u64(rng, 64, 1 << 47)
    hi = rand_u64(rng, 64, 1 << 47)
    j = jtf._limbs_to_u128(jnp.asarray(lo), jnp.asarray(hi))
    t = ttf._limbs_to_u128(t64(lo), t64(hi))
    np.testing.assert_array_equal(np64(t.lo), np.asarray(j.lo))
    np.testing.assert_array_equal(np64(t.hi), np.asarray(j.hi))


# -- the wave schedule ----------------------------------------------------------


@pytest.mark.parametrize("max_rounds", [2, 8])
@pytest.mark.parametrize("seed", range(2))
def test_wave_schedule(max_rounds, seed):
    """Random hazards on a few hot accounts: deep chains hit the round cap
    (max_rounds=2: not proved), shallow ones are proved."""
    rng = np.random.default_rng(20 + seed)
    n = 96
    hazard = rng.random(n) < (0.6 if seed else 0.15)
    slots = rng.integers(0, 6 if seed else 40, (2, n)).astype(np.uint64)
    live = rng.random((2, n)) < 0.95
    valid = np.arange(n) < 90
    unsched = bool(seed == 1 and max_rounds == 8)
    j = jtf._wave_schedule(
        jnp.asarray(hazard), jnp.bool_(unsched), jnp.asarray(slots[0]),
        jnp.asarray(live[0]), jnp.asarray(slots[1]), jnp.asarray(live[1]),
        jnp.asarray(valid), jnp.uint64(1 << 9), max_rounds)
    t = ttf._wave_schedule(
        torch.from_numpy(hazard), torch.tensor(unsched), t64(slots[0]),
        torch.from_numpy(live[0]), t64(slots[1]), torch.from_numpy(live[1]),
        torch.from_numpy(valid), 1 << 9, max_rounds)
    assert bool(t[0]) == bool(j[0])
    assert int(t[1]) == int(j[1])
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))


# -- the kernel core and the whole kernel ------------------------------------------


class FullPair:
    """One JAX ledger and the port's copy, fed the same padded batches
    through the two general kernels; the JAX ledger is kept as numpy arrays
    (its function donates the ledger)."""

    def __init__(self, n_accounts=12):
        j = jsm.make_ledger(*CAPS)
        acc = seqmix.accounts_batch(np.random.default_rng(0), 1, n_accounts,
                                    faults=False)
        soa = self.soa(acc)
        j, _ = jsp.create_accounts_seq(
            j, {k: jnp.asarray(v) for k, v in soa.items()},
            jnp.uint64(len(acc)), jnp.uint64(100))
        self.arrays = writable(convert.ledger_arrays(j))
        self.ts = 10 ** 9

    @staticmethod
    def soa(batch):
        padded = np.zeros(LANES, dtype=batch.dtype)
        padded[: len(batch)] = batch
        return types.to_soa(padded)

    def jax_ledger(self):
        return jax.tree_util.tree_map(
            jnp.asarray, jsm.make_ledger(*CAPS)).replace(**{
                name: getattr(jsm.make_ledger(*CAPS), name).replace(
                    key_lo=jnp.asarray(a["key_lo"]),
                    key_hi=jnp.asarray(a["key_hi"]),
                    tombstone=jnp.asarray(a["tombstone"]),
                    cols={k: jnp.asarray(v) for k, v in a["cols"].items()},
                    count=jnp.asarray(a["count"]),
                    probe_overflow=jnp.asarray(a["probe_overflow"]))
                for name, a in self.arrays.items() if name != "history"},
                history=jsm.make_ledger(*CAPS).history.replace(
                    cols={k: jnp.asarray(v) for k, v in
                          self.arrays["history"]["cols"].items()},
                    count=jnp.asarray(self.arrays["history"]["count"])))

    def commit(self, batch, ts=None, keep=True, bloom=None, cold_checked=None,
               **kw):
        """Both kernels on ``batch`` (with the cold tier's filter, u32
        words, and certified lanes, bool, when given); asserts equal codes,
        flags, wave vectors and ledgers; returns (codes, kflags)."""
        self.ts = ts if ts is not None else self.ts + 7 * 10 ** 8
        soa = self.soa(batch)
        n = len(batch)
        jkw, tkw = dict(kw), dict(kw)
        if bloom is not None:
            jkw["bloom"] = jnp.asarray(bloom)
            tkw["bloom"] = convert.bloom_to_tensor(bloom, CPU)
        if cold_checked is not None:
            jkw["cold_checked"] = jnp.asarray(cold_checked)
            tkw["cold_checked"] = torch.from_numpy(cold_checked)
        jr = jtf.create_transfers_full(
            self.jax_ledger(), {k: jnp.asarray(v) for k, v in soa.items()},
            jnp.uint64(n), jnp.uint64(self.ts), **jkw)
        before = self.arrays
        tled = convert.ledger_from_numpy(before, CPU)
        tr = ttf.create_transfers_full_impl(
            tled, convert.soa_to_tensors(soa, CPU), n, self.ts, **tkw)
        np.testing.assert_array_equal(convert.tensor_to_array(tr[1]),
                                      np.asarray(jr[1]))
        kflags = int(jr[2])
        assert int(tr[2]) == kflags
        if kw.get("use_waves"):
            np.testing.assert_array_equal(tr[3].numpy(), np.asarray(jr[3]))
        want = writable(convert.ledger_arrays(jr[0]))
        assert_ledgers_equal(want, convert.ledger_to_numpy(tr[0]))
        if kflags:
            assert_ledgers_equal(before, want)  # nothing applied
        if keep:
            self.arrays = want
        return np.asarray(jr[1])[:n].tolist(), kflags


def writable(d):
    if isinstance(d, dict):
        return {k: writable(v) for k, v in d.items()}
    return np.array(d)


def assert_ledgers_equal(want, got, path=""):
    if isinstance(want, dict):
        assert want.keys() == got.keys(), path
        for k in want:
            assert_ledgers_equal(want[k], got[k], f"{path}/{k}")
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=path)


WAVES = dict(use_waves=True)


def mixed_stream(pair, seed, batches=3, **kw):
    rng = np.random.default_rng(seed)
    mix = fullmix.GeneralMix(rng, list(range(1, 13)), 10_000)
    flags = []
    for _ in range(batches):
        codes, kflags = pair.commit(mix.batch(LANES - 4), **kw)
        flags.append(kflags)
        mix.settle(i for i, c in enumerate(codes) if c or kflags)
    return flags


@pytest.mark.parametrize("seed", range(3))
def test_full_kernel_mixed_stream_waves_on(seed):
    """The general mix (pendings, in-batch and table posts/voids, double
    posts, expiry, balancing clamps, limit and history accounts, duplicate
    ids, plain linked chains) through both kernels, waves on."""
    flags = mixed_stream(FullPair(), seed, **WAVES)
    assert 0 in flags


@pytest.mark.parametrize("trap", fulltraps.TRAPS)
def test_fulltraps_batches_match_jax(trap):
    """testing/fulltraps.py's batches (what the card holds the multi-block
    K11 and K12 to at 8,190 events) at the test width, after a batch of the
    mix has left pendings in the table, waves on."""
    p = FullPair()
    mix = fullmix.GeneralMix(np.random.default_rng(61), list(range(1, 13)),
                             10_000)
    codes, kflags = p.commit(mix.batch(LANES - 4), **WAVES)
    mix.settle(i for i, c in enumerate(codes) if c or kflags)
    codes, _ = p.commit(fulltraps.trap_batch(mix, trap, LANES - 4), **WAVES)
    assert len(codes) == LANES - 4


def test_full_kernel_mixed_stream_waves_off():
    assert 0 in mixed_stream(FullPair(), 5)


def test_full_kernel_without_postvoid_or_history():
    """The static hints off (the machine's plain-limits shape)."""
    p = FullPair()
    rng = np.random.default_rng(9)
    rows = [types.transfer(id=500 + i, debit_account_id=int(d),
                           credit_account_id=int(c), amount=int(a), ledger=1,
                           code=10, flags=int(F.BALANCING_DEBIT) if i % 5 == 0
                           else 0)
            for i, (d, c, a) in enumerate(zip(
                rng.integers(1, 7, 40), rng.integers(7, 13, 40),
                rng.integers(1, 90, 40)))]
    codes, kflags = p.commit(types.transfers_array(rows), has_postvoid=False,
                             has_history=False, **WAVES)
    assert kflags == 0 and 0 in codes


def test_kernel_core_apply_plan_fields():
    """Every ApplyPlan field of the two kernel cores, from the two gather
    contexts of the same ledger and batch."""
    p = FullPair()
    rng = np.random.default_rng(31)
    mix = fullmix.GeneralMix(rng, list(range(1, 13)), 20_000)
    codes, _ = p.commit(mix.batch(40), **WAVES)
    mix.settle(i for i, c in enumerate(codes) if c)
    batch = mix.batch(LANES - 2)
    soa = p.soa(batch)
    n, ts = len(batch), 5 * 10 ** 9
    jb = {k: jnp.asarray(v) for k, v in soa.items()}
    jled = p.jax_ledger()
    lane = jnp.arange(LANES)
    valid = lane < n
    fl = jb["flags"]
    jpv = (((fl & jsm.TF_POST) != 0) | ((fl & jsm.TF_VOID) != 0)) & valid
    jctx = jtf.build_gather_ctx(jled, jb, valid, jpv)
    jplan = jtf._kernel_core(jctx, jb, jnp.uint64(n), jnp.uint64(ts),
                             use_waves=True)
    tled = convert.ledger_from_numpy(p.arrays, CPU)
    tb = convert.soa_to_tensors(soa, CPU)
    tvalid = torch.arange(LANES) < n
    tpv = (((tb["flags"] & 4) != 0) | ((tb["flags"] & 8) != 0)) & tvalid
    tctx = ttf.build_gather_ctx(tled, tb, tvalid, tpv)
    assert int(tctx.probe_grow) == int(jctx.probe_grow)
    tplan = ttf._kernel_core(tctx, tb, n, ts, use_waves=True)
    for field in jtf.ApplyPlan._fields:
        jv, tv = getattr(jplan, field), getattr(tplan, field)
        if isinstance(jv, dict):
            assert set(jv) == set(tv), field
            for k in jv:
                np.testing.assert_array_equal(
                    convert.tensor_to_array(tv[k]), np.asarray(jv[k]),
                    f"{field}/{k}")
        else:
            np.testing.assert_array_equal(
                convert.tensor_to_array(tv.reshape(np.asarray(jv).shape)),
                np.asarray(jv).astype(convert.tensor_to_array(tv).dtype),
                field)
    assert int(tplan.passes) >= 1


# -- each routing flag -----------------------------------------------------------


def tr(id, dr=1, cr=2, amount=10, **kw):
    kw.setdefault("ledger", 1)
    kw.setdefault("code", 10)
    return types.transfer(id=id, debit_account_id=dr, credit_account_id=cr,
                          amount=amount, **kw)


def tombstone_free_slots(pair, table):
    a = pair.arrays[table]
    free = (a["key_lo"] == 0) & (a["key_hi"] == 0)
    a["tombstone"] = a["tombstone"] | free


@pytest.mark.parametrize("reason", ["u128", "linked_x_postvoid",
                                    "chain_balance_code", "arith_broken",
                                    "grow_accounts", "grow_transfers",
                                    "grow_posted"])
def test_each_flag_applies_nothing(reason):
    p = FullPair()
    assert p.commit(types.transfers_array(
        [tr(900, 1, 2, 50, flags=int(F.PENDING))]), **WAVES) == ([0], 0)
    rows = [tr(901, 3, 4, 5)]
    want = ttf.FLAG_SEQ
    if reason == "u128":
        rows.append(tr(902, 3, 4, 1 << 64))
    elif reason == "linked_x_postvoid":
        rows += [tr(902, 3, 4, 5, flags=int(F.LINKED)),
                 types.transfer(id=903, pending_id=900,
                                flags=int(F.POST_PENDING_TRANSFER))]
    elif reason == "chain_balance_code":
        # Account 2 limits its debits (fullmix flags); a chain whose member
        # exceeds it fails with a balance code.
        rows += [tr(902, 5, 6, 7, flags=int(F.LINKED)),
                 tr(903, 2, 6, 10 ** 9)]
    elif reason == "arith_broken":
        # Account 3's debits_pending near 2**128, one pending of 2**20 on it
        # voided and a new one made: the true balance fits, the sum of the
        # adds before the subtractions does not.
        assert p.commit(types.transfers_array(
            [tr(950, 3, 4, 1 << 20, flags=int(F.PENDING))]), **WAVES)[1] == 0
        a = p.arrays["accounts"]
        slot = int(np.flatnonzero(a["key_lo"] == 3)[0])
        dp = U128_MAX - (1 << 21) + (1 << 20)
        a["cols"]["debits_pending_lo"][slot] = np.uint64(dp & U64)
        a["cols"]["debits_pending_hi"][slot] = np.uint64(dp >> 64)
        rows += [types.transfer(id=951, pending_id=950,
                                flags=int(F.VOID_PENDING_TRANSFER)),
                 tr(952, 3, 5, (1 << 20) + 5, flags=int(F.PENDING))]
    elif reason == "grow_accounts":
        tombstone_free_slots(p, "accounts")
        rows.append(tr(902, 3, 77_777, 5, flags=int(F.BALANCING_CREDIT)))
        want = ttf.FLAG_GROW_ACCOUNTS
    elif reason == "grow_transfers":
        tombstone_free_slots(p, "transfers")
        want = ttf.FLAG_GROW_TRANSFERS
    else:
        tombstone_free_slots(p, "posted")
        rows.append(types.transfer(id=902, pending_id=900,
                                   flags=int(F.VOID_PENDING_TRANSFER)))
        want = ttf.FLAG_GROW_POSTED
    _, kflags = p.commit(types.transfers_array(rows), **WAVES)
    assert kflags & want, (reason, kflags)


def test_unconverged_fixpoint_routes():
    """In-batch pendings and their posts need more passes than a budget of
    one: FLAG_SEQ, nothing applied (waves off, so no proved bound)."""
    p = FullPair()
    rows = [tr(700 + i, 1 + i % 6, 7 + i % 6, 9, flags=int(F.PENDING))
            for i in range(6)]
    rows += [types.transfer(id=800 + i, pending_id=700 + i,
                            flags=int(F.POST_PENDING_TRANSFER))
             for i in range(6)]
    _, kflags = p.commit(types.transfers_array(rows), max_passes=1)
    assert kflags == ttf.FLAG_SEQ


# Cold ids in the filter, whether the batch has post/void lanes, whether
# every lane is certified, and the flags expected.
COLD_CASES = {
    "id": ([50], True, False, ttf.FLAG_COLD),
    "id_no_postvoid": ([50], False, False, ttf.FLAG_COLD),
    "pending_id": ([60], True, False, ttf.FLAG_COLD),
    "certified": ([50, 60], True, True, 0),
    "hot_ids": ([1, 2], True, False, 0),
    "miss": ([77], True, False, 0),
    "empty_filter": ([], True, False, 0),
}


@pytest.mark.parametrize("case", sorted(COLD_CASES))
def test_bloom_filter_flags_cold(case):
    """build_gather_ctx's cold branch (JAX transfer_full.py:638-659, kernel
    K17 on the card): an id, or a post/void's pending id, that misses the
    hot table and hits the filter sets FLAG_COLD and applies nothing; lanes
    certified by cold_checked, ids found hot and ids the filter misses do
    not.  Codes, flags and every ledger array equal the JAX kernel's."""
    from tigerbeetle_tpu.ops import cold as jcold

    p = FullPair()
    p.commit(types.transfers_array([tr(1), tr(2, 3, 4, 5, flags=int(F.PENDING))]),
             has_postvoid=False)
    cold_ids, postvoid, certified, want = COLD_CASES[case]
    bloom = np.zeros((1 << 10) // 32, np.uint32)
    ids = np.array(cold_ids, np.uint64)
    jcold.bloom_add_host(bloom, ids, np.zeros_like(ids))
    rows = [tr(50, 5, 6, 7), tr(51), tr(1)]
    if postvoid:
        rows += [types.transfer(id=52, pending_id=60,
                                flags=int(F.POST_PENDING_TRANSFER)),
                 types.transfer(id=53, pending_id=2,
                                flags=int(F.VOID_PENDING_TRANSFER))]
    checked = np.full(LANES, certified)
    _, kflags = p.commit(types.transfers_array(rows), bloom=bloom,
                         cold_checked=checked, has_postvoid=postvoid)
    assert kflags == want


# -- the kernels' pointer layouts -------------------------------------------------


def enum_indices(source: str, enum: str) -> dict:
    """Name -> value of a C enum whose entries are NAME, NAME = 0 or
    NAME = OTHER + K."""
    import re
    from pathlib import Path

    text = (Path(__file__).resolve().parents[1] / "tigerbeetle_tpu_torch"
            / "csrc" / source).read_text()
    body = text[text.index("enum " + enum + " {"):]
    body = body[body.index("{") + 1:body.index("};")]
    body = re.sub(r"//[^\n]*", "", body)
    out, prev = {}, -1
    for entry in (e.strip() for e in body.split(",")):
        if not entry:
            continue
        m = re.fullmatch(r"(\w+)(?:\s*=\s*(\w+)(?:\s*\+\s*(\d+))?)?", entry)
        name, base, plus = m.groups()
        if base is None:
            value = prev + 1
        elif base.isdigit():
            value = int(base)
        else:
            value = out[base] + int(plus or 0)
        out[name] = prev = value
    return out


@pytest.mark.parametrize("source,enum,prefix,layout", [
    ("full_pass.cu", "FullPtr", "F_", "FULL_PASS_LAYOUT"),
    ("full_legs.cu", "LegPtr", "L_", "LEGS_LAYOUT"),
])
def test_kernel_pointer_layouts_match_the_sources(source, enum, prefix, layout):
    from tigerbeetle_tpu_torch.ops import _cuda

    idx = enum_indices(source, enum)
    offset = 0
    for name, count in getattr(_cuda, layout):
        assert idx[prefix + name.upper()] == offset, name
        offset += count
    assert idx[prefix + "NPTRS"] == offset


@pytest.mark.parametrize("source,define,owner,name", [
    ("full_pass.cu", "PASS_MAX_BLOCKS", "_cuda", "PASS_MAX_BLOCKS"),
    ("full_waves.cu", "WAVE_MAX_BLOCKS", "_cuda", "WAVE_MAX_BLOCKS"),
    ("full_pass.cu", "PASS_THREADS", "fulltraps", "PASS_BLOCK"),
    ("full_waves.cu", "WAVE_CHUNK", "fulltraps", "WAVE_CHUNK"),
    ("full_legs.cu", "LEG_THREADS", "_cuda", "LEG_THREADS"),
    ("full_legs.cu", "LEG_MAX_BLOCKS", "_cuda", "LEG_MAX_BLOCKS"),
    ("full_legs.cu", "LEG_CHUNK", "_cuda", "LEG_CHUNK"),
    ("full_legs.cu", "LEG_THREADS", "k10cases", "BLOCK"),
])
def test_grid_scratch_sizes_match_the_sources(source, define, owner, name):
    """K10's, K11's and K12's per-block partials live in scratch the
    wrappers size, and testing/fulltraps.py and k10cases.py place and
    check their traps by the kernels' blocks and chunks: these must be the
    sources' (FULL_THREADS, FULL_MAX_LEGS and the block sizes from
    csrc/)."""
    import re
    from pathlib import Path

    from tigerbeetle_tpu_torch.ops import _cuda

    csrc = Path(_cuda.CSRC)
    text = (csrc / "full_common.cuh").read_text() + (csrc / source).read_text()
    expr = re.search(rf"#define {define} (\([^)\n]*\)|\d+)", text).group(1)
    expr = expr.strip("()")
    for k, v in re.findall(r"#define (\w+) (\d+)\b", text):
        expr = re.sub(rf"\b{k}\b", v, expr)
    assert re.fullmatch(r"[\d */]+", expr), expr
    module = {"_cuda": _cuda, "fulltraps": fulltraps,
              "k10cases": k10cases}[owner]
    assert eval(expr) == getattr(module, name)  # integers and * / only
