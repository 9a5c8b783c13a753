"""The port's commit kernels (``tigerbeetle_tpu_torch.ops.state_machine``)
against the JAX package's on the same padded SoA batches: every result code
and every ledger array must be equal, byte for byte.  The cases follow
tests/test_kernels_fast.py at the ops level, where linked transfer chains
run on the fast kernel too.  On the CPU the port runs the plain PyTorch
versions of kernels K1-K5; the kernels are held against them on the card
(tests/test_torch_kernels.py and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu import types
from tigerbeetle_tpu.ops import state_machine as jsm
from tigerbeetle_tpu.testing.workload import WorkloadGen
from tigerbeetle_tpu.types import AccountFlags, TransferFlags as F
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.ops import state_machine as tsm
from tigerbeetle_tpu_torch.testing import k3cases

LANES = 256
CPU = torch.device("cpu")
L = int(F.LINKED)


def assert_ledgers_equal(want: dict, got: dict, path=""):
    if isinstance(want, dict):
        assert want.keys() == got.keys(), path
        for k in want:
            assert_ledgers_equal(want[k], got[k], f"{path}/{k}")
        return
    assert want.dtype == got.dtype, path
    np.testing.assert_array_equal(got, want, err_msg=path)


class Pair:
    """One JAX ledger and one port ledger fed the same batches."""

    def __init__(self):
        caps = (1 << 10, 1 << 11, 1 << 10, 1 << 10)
        self.j = jsm.make_ledger(*caps)
        self.t = tsm.make_ledger(*caps, device=CPU)
        self.ts = 1_000

    def _soa(self, batch):
        padded = np.zeros(LANES, dtype=batch.dtype)
        padded[: len(batch)] = batch
        return types.to_soa(padded)

    def commit(self, op, batch, ts=None):
        self.ts = ts if ts is not None else self.ts + 10 * len(batch) + 7
        soa = self._soa(batch)
        n = len(batch)
        self.j, jc = getattr(jsm, op)(
            self.j, {k: jnp.asarray(v) for k, v in soa.items()},
            jnp.uint64(n), jnp.uint64(self.ts))
        self.t, tc = getattr(tsm, op)(
            self.t, convert.soa_to_tensors(soa, CPU), n, self.ts)
        np.testing.assert_array_equal(convert.tensor_to_array(tc), np.asarray(jc))
        self.check()
        return np.asarray(jc)[:n]

    def check(self):
        assert_ledgers_equal(convert.ledger_arrays(self.j),
                             convert.ledger_to_numpy(self.t))

    def accounts(self, rows, ts=None):
        return self.commit("create_accounts", types.accounts_array(rows), ts)

    def transfers(self, rows, ts=None):
        return self.commit("create_transfers_fast", types.transfers_array(rows), ts)


def seeded(n=8, ledger=1):
    p = Pair()
    p.accounts([types.account(id=i + 1, ledger=ledger, code=10) for i in range(n)])
    return p


def tr(id, dr=1, cr=2, amount=10, **kw):
    kw.setdefault("ledger", 1)
    kw.setdefault("code", 10)
    return types.transfer(id=id, debit_account_id=dr, credit_account_id=cr,
                          amount=amount, **kw)


# -- create_accounts ---------------------------------------------------------

ACCOUNT_CASES = {
    "validation": [[
        types.account(id=1, ledger=1, code=1),
        types.account(id=0, ledger=1, code=1),
        types.account(id=(1 << 128) - 1, ledger=1, code=1),
        types.account(id=2, ledger=0, code=1),
        types.account(id=3, ledger=1, code=0),
        types.account(id=4, ledger=1, code=1, debits_posted=5),
        types.account(id=5, ledger=1, code=1, reserved=9),
        types.account(id=6, ledger=1, code=1, flags=0x8000),
        types.account(id=7, ledger=1, code=1, timestamp=4),
        types.account(id=8, ledger=1, code=1, flags=6),
        types.account(id=9, ledger=1, code=1, credits_pending=1 << 70),
        types.account(id=1 << 64, ledger=1, code=1),
    ]],
    "exists_ladder": [
        [types.account(id=1, ledger=1, code=1, user_data_32=9)],
        [types.account(id=1, ledger=1, code=1, user_data_32=9),
         types.account(id=1, ledger=2, code=1, user_data_32=9),
         types.account(id=1, ledger=1, code=3, user_data_32=9),
         types.account(id=1, ledger=1, code=1, user_data_32=8),
         types.account(id=1, ledger=1, code=1, user_data_32=9, user_data_64=5),
         types.account(id=1, ledger=1, code=1, user_data_32=9, user_data_128=5),
         types.account(id=1, ledger=1, code=1, user_data_32=9,
                       flags=AccountFlags.HISTORY)],
    ],
    "intra_batch_duplicates": [[
        types.account(id=5, ledger=0, code=1),  # invalid: not the winner
        types.account(id=5, ledger=1, code=1),  # winner
        types.account(id=5, ledger=1, code=1),  # exists
        types.account(id=5, ledger=1, code=2),  # exists_with_different_code
        types.account(id=5, ledger=0, code=2),  # own failure first
    ]],
    "linked_chains": [[
        types.account(id=1, ledger=1, code=1, flags=AccountFlags.LINKED),
        types.account(id=2, ledger=0, code=1, flags=AccountFlags.LINKED),
        types.account(id=3, ledger=1, code=1),
        types.account(id=4, ledger=1, code=1, flags=AccountFlags.LINKED),
        types.account(id=5, ledger=1, code=1),
        types.account(id=6, ledger=1, code=1, flags=AccountFlags.LINKED),
    ]],
}


@pytest.mark.parametrize("case", sorted(ACCOUNT_CASES))
def test_create_accounts_matches_jax(case):
    p = Pair()
    for rows in ACCOUNT_CASES[case]:
        p.accounts(rows)


def test_create_accounts_random_differential():
    p = Pair()
    gen = WorkloadGen(seed=42)
    for i in range(3):
        batch = gen.accounts_batch(40, special_flags=True)
        rng = np.random.default_rng(100 + i)
        for j in rng.integers(0, 40, size=8):
            k = rng.integers(0, 4)
            if k == 0:
                batch[j]["id_lo"] = batch[(j + 1) % 40]["id_lo"]
            elif k == 1:
                batch[j]["ledger"] = 0
            elif k == 2:
                batch[j]["flags"] |= AccountFlags.LINKED
            else:
                batch[j]["code"] = 0
        p.commit("create_accounts", batch)


# -- create_transfers (fast kernel) ------------------------------------------

TRANSFER_CASES = {
    "validation": [[
        tr(1, amount=100), tr(0), tr(2, 1, 1), tr(3, 99, 2), tr(4, 1, 99),
        tr(5, amount=0), tr(6, ledger=9), tr(7, code=0), tr(8, timeout=5),
        tr(9, pending_id=3), tr(10, 3, 4, amount=(1 << 64) - 1),
        tr(11, 0, 2), tr(12, (1 << 128) - 1, 2), tr(13, 1, 0),
        tr(14, flags=0x4000), tr(15, timestamp=3), tr((1 << 128) - 1),
    ]],
    "pending_and_exists": [
        [tr(1, amount=50, flags=F.PENDING, timeout=100)],
        [tr(1, amount=50, flags=F.PENDING, timeout=100),
         tr(1, amount=50, flags=F.PENDING, timeout=101),
         tr(1, amount=51, flags=F.PENDING, timeout=100),
         tr(1, 1, 3, amount=50, flags=F.PENDING, timeout=100),
         tr(1, 2, 1, amount=50, flags=F.PENDING, timeout=100),
         tr(1, amount=50, timeout=0),
         tr(1, amount=50, flags=F.PENDING, timeout=100, user_data_64=1),
         tr(1, amount=50, flags=F.PENDING, timeout=100, code=11)],
    ],
    "intra_batch_duplicates": [[
        tr(7, amount=0), tr(7, amount=5), tr(7, amount=5), tr(7, 2, 1, amount=5),
        tr(7, amount=6, ledger=0), tr(7, amount=5, user_data_32=3),
    ]],
    "linked_chains": [[
        tr(1, flags=L), tr(2, 3, 4, flags=L), tr(3, 1, 99),
        tr(4, amount=7, flags=L), tr(5, 2, 3, amount=7),
        tr(6, amount=1, flags=L),
    ]],
    "linked_dup_in_chain": [[
        tr(1, flags=L), tr(1, flags=L), tr(2),
        tr(3, flags=L), tr(4, flags=L), tr(3),
    ]],
    "same_account_many_times": [[
        tr(10 + i, 1 + (i % 2), 3, amount=1 << (i + 40)) for i in range(20)
    ] + [tr(40 + i, 3, 4, amount=(1 << 64) - 1 - i) for i in range(6)]],
    "ledger_mismatch": [[tr(1, 1, 9), tr(2, 9, 1), tr(3, 9, 10, ledger=2)]],
}


@pytest.mark.parametrize("case", sorted(TRANSFER_CASES))
def test_create_transfers_fast_matches_jax(case):
    p = seeded(8)
    p.accounts([types.account(id=9, ledger=2, code=10),
                types.account(id=10, ledger=2, code=10)])
    for rows in TRANSFER_CASES[case]:
        p.transfers(rows)


def test_timeout_overflow_near_u64_max():
    """ts + timeout * 1e9 wrapping past 2**64 fails with overflows_timeout;
    the u32 timeout widens without sign extension."""
    p = seeded(4)
    rows = [tr(i + 1, flags=F.PENDING, timeout=t) for i, t in
            enumerate([0, 1, 100, (1 << 31) + 5, (1 << 32) - 1])]
    codes = p.transfers(rows, ts=(1 << 64) - 2_000_000_000_000)
    assert 53 in codes.tolist()


def test_whole_batch_linked_chain():
    """A chain as long as the batch: one failure rolls every lane back, and
    with no failure the open final lane does."""
    p = seeded(4)
    rows = [tr(100 + i, amount=1, flags=L) for i in range(LANES)]
    rows[-1] = tr(100 + LANES - 1, amount=1)
    rows[LANES // 2] = tr(100 + LANES // 2, amount=0, flags=L)
    assert set(p.transfers(rows).tolist()) == {1, 18}
    rows = [tr(1000 + i, amount=1, flags=L) for i in range(LANES)]
    assert set(p.transfers(rows).tolist()) == {1, 2}


def test_random_differential_multi_batch_and_lookups():
    p = Pair()
    gen = WorkloadGen(seed=7)
    p.commit("create_accounts", gen.accounts_batch(16))
    for i in range(5):
        batch = gen.transfers_batch(60, invalid_rate=0.25, dup_rate=0.15,
                                    pending_rate=0.25, linked_rate=0.2)
        p.commit("create_transfers_fast", batch)
    for table, ids in (("accounts", gen.account_ids[:20] + [99_999]),
                       ("transfers", gen.transfer_ids[:60] + [0, 1 << 100])):
        lo = np.array([i & ((1 << 64) - 1) for i in ids], np.uint64)
        hi = np.array([i >> 64 for i in ids], np.uint64)
        jf, jc = getattr(jsm, "lookup_" + table)(p.j, jnp.asarray(lo), jnp.asarray(hi))
        tf, tc = getattr(tsm, "lookup_" + table)(
            p.t, convert.array_to_tensor(lo, CPU), convert.array_to_tensor(hi, CPU))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        assert tc.keys() == jc.keys()
        for k in jc:
            np.testing.assert_array_equal(convert.tensor_to_array(tc[k]),
                                          np.asarray(jc[k]), err_msg=k)
    want = int(jsm.ledger_digest(p.j))
    assert tsm.ledger_digest(p.t).item() & ((1 << 64) - 1) == want


def test_probed_variant_and_metrics_counter():
    from tigerbeetle_tpu_torch.obs.metrics import registry

    p = seeded(4)
    soa = convert.soa_to_tensors(p._soa(types.transfers_array([tr(1), tr(2)])), CPU)
    with registry.enabled_scope():
        led, codes, overflow, id_lo, id_hi = tsm.create_transfers_fast_probed(
            p.t, soa, 2, 10_000)
        assert registry.counter("ops.kernel.create_transfers_fast_probed").value == 1
    registry.reset()
    assert codes[:2].tolist() == [0, 0]
    assert overflow.dtype == torch.int32 and overflow.item() == 0
    assert id_lo is soa["id_lo"] and id_hi is soa["id_hi"]


@pytest.mark.parametrize("seed", [1, 2])
def test_resolve_duplicates_and_chain_codes_match_jax(seed):
    rng = np.random.default_rng(seed)
    n, count = 200, 190
    ids = rng.integers(1, 30, n).astype(np.uint64)
    ok = rng.random(n) < 0.6
    valid = np.arange(n) < count
    jd = jsm._resolve_duplicates(jnp.asarray(ids), jnp.zeros(n, jnp.uint64),
                                 jnp.asarray(ok), jnp.asarray(valid))
    td = tsm._resolve_duplicates(convert.array_to_tensor(ids, CPU),
                                 torch.zeros(n, dtype=torch.int64),
                                 torch.from_numpy(ok), torch.from_numpy(valid))
    np.testing.assert_array_equal(td.winner_lane.numpy(), np.asarray(jd.winner_lane))
    np.testing.assert_array_equal(td.after_winner.numpy(), np.asarray(jd.after_winner))
    linked = (rng.random(n) < 0.6) & valid
    codes = np.where(rng.random(n) < 0.15, rng.integers(3, 50, n), 0).astype(np.uint32)
    jc = jsm._chain_codes(jnp.asarray(linked), jnp.asarray(codes), jnp.uint64(count))
    tc = tsm._chain_codes(torch.from_numpy(linked),
                          convert.array_to_tensor(codes, CPU), count)
    np.testing.assert_array_equal(convert.tensor_to_array(tc), np.asarray(jc))


def test_ledger_round_trip_is_lossless():
    p = Pair()
    gen = WorkloadGen(seed=3)
    p.commit("create_accounts", gen.accounts_batch(30))
    p.commit("create_transfers_fast", gen.transfers_batch(50, pending_rate=0.3))
    arrays = convert.ledger_arrays(p.j)
    back = convert.ledger_to_numpy(convert.ledger_from_numpy(arrays, CPU))
    assert_ledgers_equal(arrays, back)


@pytest.mark.parametrize("case", ["carry", "hot"])
def test_balance_plan_carries_and_hot_account_match_jax(case):
    """K4's plain version (``apply_balances`` on CPU tensors) against JAX's
    ``balance_plan`` + ``apply_balance_plan``: balances a few units below
    2^64 so that most legs carry into the hi word, and a batch whose legs
    all hit one debit and one credit account (K4's warp-aggregated case)."""
    from tigerbeetle_tpu.ops import hash_table as jht
    from tigerbeetle_tpu_torch.ops import hash_table as tht

    rng = np.random.default_rng(21)
    n, cap = 2048, 1 << 10
    dr = rng.integers(0, cap, n).astype(np.uint64)
    cr = ((dr + 1 + rng.integers(0, cap - 1, n).astype(np.uint64))
          % np.uint64(cap))
    if case == "hot":
        dr[:], cr[:] = 3, 5
    amt = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    ok = rng.random(n) < 0.9
    pend = rng.random(n) < 0.3
    cols = {}
    for c in tsm.BALANCE_COLS:
        if c.endswith("_lo"):
            cols[c] = (np.uint64((1 << 64) - 1)
                       - rng.integers(0, 64, cap, dtype=np.uint64))
        else:
            cols[c] = rng.integers(0, 1 << 40, cap, dtype=np.uint64)
    jt = jht.make_table(cap, {c: jnp.uint64 for c in cols})
    jt = jt.replace(cols={c: jnp.asarray(v) for c, v in cols.items()})
    jt = jsm.apply_balance_plan(jt, jsm.balance_plan(
        jnp.asarray(dr), jnp.asarray(cr), jnp.asarray(ok), jnp.asarray(amt),
        jnp.asarray(pend), cap))
    tt = tht.make_table(cap, {c: torch.int64 for c in cols}, CPU)
    for c, v in cols.items():
        tt.cols[c].copy_(convert.array_to_tensor(v, CPU))

    def t64(a):
        return convert.array_to_tensor(a, CPU)

    tsm.apply_balances(tt, t64(dr), t64(cr), torch.from_numpy(ok), t64(amt),
                       torch.from_numpy(pend))
    for c in cols:
        np.testing.assert_array_equal(convert.tensor_to_array(tt.cols[c]),
                                      np.asarray(jt.cols[c]), err_msg=c)
    hi = convert.tensor_to_array(tt.cols["debits_posted_hi"])
    assert int((hi != cols["debits_posted_hi"]).sum()) >= (
        1 if case == "hot" else 100)


def _jax_transfer_codes(batch, ctx, count, ts):
    j = {k: jnp.asarray(v) for k, v in batch.items()}
    n = len(batch["id_lo"])
    jctx = jsm.TransferCtx(
        jnp.asarray(ctx["dr_found"]), jnp.asarray(ctx["cr_found"]),
        jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32),
        {"ledger": jnp.asarray(ctx["dr_ledger"])},
        {"ledger": jnp.asarray(ctx["cr_ledger"])},
        jnp.asarray(ctx["ex_found"]),
        {k: jnp.asarray(v) for k, v in ctx["e"].items()})
    codes, ok = jsm.transfer_codes(j, jctx, jnp.uint64(count), jnp.uint64(ts))[:2]
    return np.asarray(codes), np.asarray(ok)


def _torch_ctx(ctx):
    t = lambda a: convert.array_to_tensor(a, CPU)  # noqa: E731
    n = len(ctx["dr_found"])
    return tsm.TransferCtx(
        t(ctx["dr_found"]), t(ctx["cr_found"]),
        torch.zeros(n, dtype=torch.int64), torch.zeros(n, dtype=torch.int64),
        {"ledger": t(ctx["dr_ledger"])}, {"ledger": t(ctx["cr_ledger"])},
        t(ctx["ex_found"]), {k: t(v) for k, v in ctx["e"].items()})


@pytest.mark.parametrize("case", k3cases.CASES)
def test_validate_split_form_matches_jax(case):
    """K3's own steps (per lane, then the batch-wide steps after grid
    barriers, chain starts by a two-level scan over blocks of 128 lanes) in
    plain PyTorch against JAX's transfer_codes and account_codes on
    batches that put duplicates and chains across the blocks' boundaries:
    codes and ok, every lane."""
    batch, ctx, count, ts = k3cases.transfer_case(case)
    want_c, want_ok = _jax_transfer_codes(batch, ctx, count, ts)
    tb = convert.soa_to_tensors(batch, CPU)
    for fn in (tsm.transfer_codes_split_plain, tsm.transfer_codes_plain):
        codes, ok = fn(tb, _torch_ctx(ctx), count, ts)
        np.testing.assert_array_equal(convert.tensor_to_array(codes), want_c)
        np.testing.assert_array_equal(ok.numpy(), want_ok)
    batch, found, e, count = k3cases.account_case(case)
    jc, jok = jsm.account_codes(
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(found),
        {k: jnp.asarray(v) for k, v in e.items()}, jnp.uint64(count))
    codes, ok = tsm.account_codes_split_plain(
        convert.soa_to_tensors(batch, CPU), torch.from_numpy(found),
        convert.soa_to_tensors(e, CPU), count)
    np.testing.assert_array_equal(convert.tensor_to_array(codes), np.asarray(jc))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    if case != "random":
        assert len(set(convert.tensor_to_array(codes).tolist())) > 1
