"""The hand-written CUDA kernels K1-K32 against their plain PyTorch versions
on the card.  These tests need an NVIDIA GPU with nvcc and skip elsewhere;
this file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels.py

(``--noconftest`` because tests/conftest.py sets JAX up.)  The CPU tests
hold the plain versions against the JAX package; these close the chain."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tigerbeetle_tpu_torch import convert, types
from tigerbeetle_tpu_torch.ops import _cuda
from tigerbeetle_tpu_torch.ops import hash_table as ht
from tigerbeetle_tpu_torch.ops import index as ix
from tigerbeetle_tpu_torch.ops import query as q
from tigerbeetle_tpu_torch.ops import scan_path as sp
from tigerbeetle_tpu_torch.ops import state_machine as sm
from tigerbeetle_tpu_torch.ops import transfer_full as tf
from tigerbeetle_tpu_torch.testing import (fullmix, fulltraps, k1cases, k2cases,
                                           k3cases, k7cases, k9cases, k10cases,
                                           k13cases, k14cases, k15cases,
                                           k16cases, k17cases, k30cases, seqmix)
from tigerbeetle_tpu_torch.utils.benchgen import mix64_np

pytestmark = pytest.mark.cuda
COLS = {"val": torch.int64, "tag": torch.int32}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def same_home(cap, n_keys, groups, start):
    cands = np.arange(start, start + 400_000, dtype=np.uint64)
    homes = mix64_np(cands, 0) & np.uint64(cap - 1)
    out = []
    for h in np.unique(homes):
        same = cands[homes == h]
        if len(same) >= n_keys:
            out.append(same[:n_keys])
        if len(out) == groups:
            break
    return np.concatenate(out)


def tables_equal(a: ht.Table, b: ht.Table):
    for name in ("key_lo", "key_hi", "tombstone", "count", "probe_overflow"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for name in a.cols:
        assert torch.equal(a.cols[name], b.cols[name]), name


def table_to(t: ht.Table, dev) -> ht.Table:
    return ht.Table(t.key_lo.to(dev), t.key_hi.to(dev), t.tombstone.to(dev),
                    {k: v.to(dev) for k, v in t.cols.items()}, t.count.to(dev),
                    t.probe_overflow.to(dev))


def keyed_rows(rng, n, dev):
    ids = np.unique(rng.integers(1, 1 << 62, n + 64, dtype=np.uint64))[:n]
    rng.shuffle(ids)
    lo = convert.array_to_tensor(ids, dev)
    return lo, {"val": lo, "tag": lo.to(torch.int32)}


@pytest.mark.parametrize("max_probe", [sm.MAX_PROBE, 2])
def test_insert_and_probe_match_plain(cuda_device, max_probe):
    rng = np.random.default_rng(5)
    cap = 1 << 12
    lo, rows = keyed_rows(rng, 1700, cuda_device)
    groups = convert.array_to_tensor(same_home(cap, 6, 4, 1 << 62), cuda_device)
    lo = torch.cat([lo, groups])
    rows = {"val": lo, "tag": lo.to(torch.int32)}
    hi = torch.zeros_like(lo)
    mask = torch.from_numpy(rng.random(len(lo)) < 0.9).to(cuda_device)
    a = ht.make_table(cap, COLS, cuda_device)
    b = ht.make_table(cap, COLS, cuda_device)
    _, ca = ht.insert(a, lo, hi, mask, rows, max_probe)
    _, cb = ht.insert_plain(b, lo, hi, mask, rows, max_probe)
    assert torch.equal(ca, cb)
    tables_equal(a, b)
    assert bool(a.probe_overflow) == (max_probe == 2)
    k = ht.lookup(a, lo, hi, max_probe, count=1000, cols=("val", "tag"))
    p = ht.lookup_plain(a, lo, hi, max_probe, 0, 1000, ("val", "tag"))
    assert torch.equal(k.found, p.found) and torch.equal(k.slot, p.slot)
    assert bool(k.overflow) == bool(p.overflow)
    for name in ("val", "tag"):
        assert torch.equal(k.cols[name], p.cols[name])


def _k1_table(t, dev):
    return ht.Table(convert.array_to_tensor(t["key_lo"], dev),
                    convert.array_to_tensor(t["key_hi"], dev),
                    torch.from_numpy(t["tombstone"].copy()).to(dev),
                    {k: convert.array_to_tensor(v, dev) for k, v in t["cols"].items()},
                    torch.tensor(int(t["count"]), device=dev),
                    torch.tensor(False, device=dev))


def _k1_equal(k, p, cols, what):
    assert torch.equal(k.found.cpu(), p.found), what
    assert torch.equal(k.slot.cpu(), p.slot), what
    assert (k.overflow is None) == (p.overflow is None), what
    if p.overflow is not None:
        assert bool(k.overflow) == bool(p.overflow), what
    for c in cols:
        assert torch.equal(k.cols[c].cpu(), p.cols[c]), (what, c)


@pytest.mark.parametrize("name", k1cases.CASES)
def test_probe_cases_match_plain(cuda_device, name):
    """K1 (one lookup a launch) on testing/k1cases.py's traps against both
    plain forms on CPU copies, byte for byte, overflow included; and the
    same lookup as the three lookups of one launch."""
    t, looks, max_probe = k1cases.case(name)
    for lk in looks:
        mask = None if lk["mask"] is None else torch.from_numpy(lk["mask"])
        args = [convert.array_to_tensor(lk["key_lo"], "cpu"),
                convert.array_to_tensor(lk["key_hi"], "cpu"), max_probe,
                lk["hash_shift"], lk["count"], ("val", "tag"), mask]
        p = ht.lookup_split_plain(_k1_table(t, "cpu"), *args)
        _k1_equal(p, ht.lookup_plain(_k1_table(t, "cpu"), *args),
                  ("val", "tag"), name)
        g = _k1_table(t, cuda_device)
        gargs = [a.to(cuda_device) if isinstance(a, torch.Tensor) else a
                 for a in args]
        k = ht.lookup(g, gargs[0], gargs[1], max_probe, lk["hash_shift"],
                      lk["count"], ("val", "tag"), gargs[6])
        _k1_equal(k, p, ("val", "tag"), name)
        many = ht.lookup_many([ht.Lookup(g, gargs[0], gargs[1], cols, gargs[6],
                                         lk["count"], lk["hash_shift"])
                               for cols in (("val", "tag"), ("tag",), ())],
                              max_probe)
        for r, cols in zip(many, (("val", "tag"), ("tag",), ())):
            _k1_equal(r, p, cols, name + " (fused)")


def test_probe_fused_case_matches_plain(cuda_device):
    """K1's one launch of five lookups over three tables, two keyed by the
    first lookup's gathered column on the same thread, against
    ``lookup_many``'s plain lookups one after another on CPU copies; with
    and without the overflow flags."""
    tables, looks = k1cases.fused_case()

    def specs(dev):
        tabs = [_k1_table(t, dev) for t in tables]
        arr = lambda a: None if a is None else convert.array_to_tensor(a, dev)  # noqa: E731
        return [ht.Lookup(tabs[lk["table"]], arr(lk["key_lo"]), arr(lk["key_hi"]),
                          lk["cols"],
                          None if lk["mask"] is None
                          else torch.from_numpy(lk["mask"]).to(dev),
                          lk["count"], keys_from=lk["keys_from"])
                for lk in looks]

    p = ht.lookup_many(specs("cpu"), k1cases.MAX_PROBE)
    before = _cuda.counts()["probe"]
    k = ht.lookup_many(specs(cuda_device), k1cases.MAX_PROBE)
    assert _cuda.counts()["probe"] == before + 1
    for a, b, lk in zip(k, p, looks):
        _k1_equal(a, b, lk["cols"], "fused")
    for a, b, lk in zip(ht.lookup_many(specs(cuda_device), k1cases.MAX_PROBE,
                                       overflow=False), p, looks):
        assert a.overflow is None
        _k1_equal(a._replace(overflow=b.overflow), b, lk["cols"], "no flags")


def test_probe_info_reads_the_launch(cuda_device):
    info = _cuda.probe_info()
    assert info["threads"] == 128 and info["blocks_per_sm"] >= 4
    assert 0 < info["arg_bytes"] <= 4096 and info["registers"] > 0
    assert info["flags_registers"] > 0 and info["flags_blocks_per_sm"] >= 4


def _k7_run(c, dev, fn):
    led = convert.ledger_from_numpy(convert.ledger_to_numpy(c["ledger"]), dev)
    soa = _padded_soa(c["batch"], c["lanes"], dev)
    _, codes, ovf = fn(led, soa, c["count"], c["ts"])
    return led, codes, ovf


K7_CASES = [(c, 64) for c in k7cases.CASES if c not in k7cases.SIZED] + \
    [("new_distinct", n) for n in k7cases.SIZES]


@pytest.mark.parametrize("name,n", K7_CASES)
def test_seq_accounts_cases_match_plain(cuda_device, name, n):
    """K7 on testing/k7cases.py's traps (new distinct ids up to 16,384
    events) against its split plain form on a CPU copy: codes, overflow
    and every ledger array, byte for byte; the serial plain form agrees."""
    c = k7cases.case(name, n)
    gk, kc, kov = _k7_run(c, cuda_device, sp.create_accounts_seq)
    pk, pc, pov = _k7_run(c, "cpu", sp.create_accounts_seq_split_plain)
    assert torch.equal(kc.cpu(), pc), name
    assert bool(kov) == bool(pov) == c["overflow"]
    _ledgers_equal(gk, pk, name)
    sk, sc, _ = _k7_run(c, "cpu", sp.create_accounts_seq_plain)
    assert torch.equal(sc, pc)
    _ledgers_equal(sk, pk, name + " serial")


def test_seq_accounts_info_reads_the_launch(cuda_device):
    info = _cuda.seq_accounts_info(8192)
    assert info["sequencer"]["dynamic_shared"] == 200 * 1024
    assert info["sequencer"]["threads"] == 512
    assert all(info[k]["registers"] > 0 for k in ("probe", "mark", "finish"))


def test_grow_on_many_blocks_matches_plain(cuda_device):
    """A rehash of 2^16 lanes runs the cooperative multi-block insert."""
    rng = np.random.default_rng(6)
    cap = 1 << 16
    lo, rows = keyed_rows(rng, 30_000, cuda_device)
    t = ht.make_table(cap, COLS, cuda_device)
    ht.insert_plain(t, lo, torch.zeros_like(lo),
                    torch.ones_like(lo, dtype=torch.bool), rows, cap)
    gone = ht.lookup_plain(t, lo[:500], torch.zeros_like(lo[:500]), 64, 0, 500, ())
    ht.remove_to_tombstone(t, gone.slot, gone.found)
    grown = ht.grow(t, cap * 2)
    plain = ht.insert_plain(
        ht.make_table(cap * 2, COLS, cuda_device), t.key_lo, t.key_hi,
        (t.key_lo != 0) | (t.key_hi != 0), t.cols, cap * 2)[0]
    tables_equal(grown, plain)
    assert int(grown.count) == 29_500


# testing/k2cases.py's traps of K2's split form, and its hash-shift case.
K2_CASES = sorted(k2cases.CASES) + ["shift_1", "shift_2", "shift_3"]


def _k2_case(name, dev):
    if name.startswith("shift_"):
        arrays, lo, mask, max_probe, shift = k2cases.shift_case(int(name[6:]))
    else:
        arrays, lo, mask, max_probe, shift = k2cases.CASES[name]()
    lo = convert.array_to_tensor(np.asarray(lo, np.uint64), dev)
    return (k2cases.table_from_arrays(arrays, dev), lo, torch.zeros_like(lo),
            torch.from_numpy(np.asarray(mask, bool)).to(dev), max_probe, shift)


def _k2_insert_matches_plain(t, lo, hi, mask, max_probe, shift=0):
    rows = {"val": lo * 3, "tag": lo.to(torch.int32)}
    a, b = ledger_table_copy(t), ledger_table_copy(t)
    _, ca = ht.insert(a, lo, hi, mask, rows, max_probe, shift)
    _, cb = ht.insert_plain(b, lo, hi, mask, rows, max_probe, shift)
    assert torch.equal(ca, cb)
    tables_equal(a, b)
    return ca


def _k2_claim_matches_plain(t, lo, hi, mask, max_probe, shift=0):
    """The claim entry's slots and flag word equal the plain claim's, it
    marks the claimed slots with their keys, a closed gate reverts the
    marks (the table as it was) and an open one writes the plain rows."""
    rows = {"val": lo * 3, "tag": lo.to(torch.int32)}
    cp, op = ht.claim_slots_plain(t, lo, hi, mask, max_probe, shift)
    for gate in (1, 0):
        c = ledger_table_copy(t)
        word = torch.tensor([4], dtype=torch.int32, device=lo.device)
        ck, _ = _cuda.claim(c.key_lo, c.key_hi, c.tombstone, lo, hi, mask,
                            max_probe, shift, flag_word=word, flag_bit=2)
        assert torch.equal(ck, cp)
        assert int(word[0]) == 4 | (2 if bool(op) else 0)
        placed = ck < t.capacity
        assert torch.equal(c.key_lo[ck[placed]], lo[placed])
        assert torch.equal(c.key_hi[ck[placed]], hi[placed])
        word.fill_(gate)
        _cuda.write_claimed(c.key_lo, c.key_hi, c.tombstone, c.cols, c.count,
                            lo, hi, ck, mask, rows, gate=word, revert=True)
        if gate:
            tables_equal(c, t)
        else:
            d = ledger_table_copy(t)
            ht.write_rows_plain(d, lo, hi, cp, mask, rows)
            tables_equal(c, d)


@pytest.mark.parametrize("case", K2_CASES)
def test_insert_cases_match_plain(cuda_device, case):
    """K2's insert entry on each trap of its split form (clusters longer
    than the window, a lane that loses slots and walks into others'
    windows, same-home groups, tombstones in windows, homes that wrap,
    max_probe 2, 13 and 40, masked lanes, hash shifts, n = 1 and 8,192):
    claimed slots and every table array equal the plain insert's."""
    t, lo, hi, mask, max_probe, shift = _k2_case(case, cuda_device)
    claimed = _k2_insert_matches_plain(t, lo, hi, mask, max_probe, shift)
    if case == "lost_slot_walks_on":
        assert claimed.tolist() == k2cases.LOST_SLOT_CLAIMS


@pytest.mark.parametrize("case", K2_CASES)
def test_claim_cases_match_plain(cuda_device, case):
    """K2's claim and write entries on each trap of its split form."""
    t, lo, hi, mask, max_probe, shift = _k2_case(case, cuda_device)
    _k2_claim_matches_plain(t, lo, hi, mask, max_probe, shift)


def test_insert_at_8192_and_8193_lanes_takes_each_route(cuda_device):
    """A batch of 8,192 lanes takes the split form (its scratch the batch's
    size), one of 8,193 the round form (``grow``'s route, an int32[C]
    claim word a home); both equal the plain insert and claim, with
    same-home groups, tombstones and masked lanes."""
    rng = np.random.default_rng(8)
    cap = 1 << 15
    t = ht.make_table(cap, COLS, cuda_device)
    lo, rows = keyed_rows(rng, 9000, cuda_device)
    ht.insert_plain(t, lo, torch.zeros_like(lo),
                    torch.ones_like(lo, dtype=torch.bool), rows, cap)
    gone = ht.lookup_plain(t, lo[:300], torch.zeros_like(lo[:300]), 64, 0,
                           300, ())
    ht.remove_to_tombstone(t, gone.slot, gone.found)
    groups = convert.array_to_tensor(same_home(cap, 8, 32, 1 << 61),
                                     cuda_device)
    for n in (8192, 8193):
        assert _cuda.insert_split(n, cap) == (n == 8192)
        scratch = _cuda.insert_scratch(n, cap, cuda_device)
        assert len(scratch) == (2 if n == 8192 else 4)
        assert max(x.numel() for x in scratch) == (2 * n if n == 8192 else cap)
        new = torch.cat([groups, (1 << 50) + torch.arange(
            n - len(groups), device=cuda_device)])
        new = new[torch.from_numpy(rng.permutation(n)).to(cuda_device)]
        hi = torch.zeros_like(new)
        mask = torch.from_numpy(rng.random(n) < 0.9).to(cuda_device)
        _k2_insert_matches_plain(t, new, hi, mask, sm.MAX_PROBE)
        _k2_claim_matches_plain(t, new, hi, mask, sm.MAX_PROBE)


def _accounts(rng, n, first):
    b = np.zeros(n, dtype=types.ACCOUNT_DTYPE)
    b["id_lo"] = first + np.arange(n)
    dup = rng.random(n) < 0.1
    b["id_lo"][dup] = b["id_lo"][rng.integers(0, n, int(dup.sum()))]
    b["ledger"] = np.where(rng.random(n) < 0.05, 0, 1)
    b["code"] = 10
    b["flags"] = np.where(rng.random(n) < 0.2, 1, 0)
    return b


def _transfers(rng, n, first, n_accounts, linked=0.2):
    b = np.zeros(n, dtype=types.TRANSFER_DTYPE)
    b["id_lo"] = first + np.arange(n)
    dup = rng.random(n) < 0.1
    b["id_lo"][dup] = b["id_lo"][rng.integers(0, n, int(dup.sum()))]
    b["debit_account_id_lo"] = rng.integers(1, n_accounts + 20, n)
    b["credit_account_id_lo"] = rng.integers(1, n_accounts + 20, n)
    b["amount_lo"] = rng.integers(0, 1 << 63, n, dtype=np.uint64)
    pending = rng.random(n) < 0.2
    b["flags"] = np.where(pending, 2, 0) | np.where(rng.random(n) < linked, 1, 0)
    b["timeout"] = np.where(pending, rng.integers(0, 5, n), 0)
    b["ledger"] = 1
    b["code"] = np.where(rng.random(n) < 0.03, 0, 10)
    return b


def test_commit_path_on_card_matches_plain_on_cpu(cuda_device):
    """The same batches through kernels K1-K4 on the card and the plain
    versions on the CPU give the same codes and the same ledger, and K5 the
    same digest."""
    rng = np.random.default_rng(7)
    lanes = 8192
    caps = (1 << 14, 1 << 15, 1 << 10, 1 << 10)
    gpu = sm.make_ledger(*caps, device=cuda_device)
    cpu = sm.make_ledger(*caps, device="cpu")
    ts = 1 << 40
    batches = [("create_accounts", _accounts(rng, 4000, 1))]
    batches += [("create_transfers_fast", _transfers(rng, 8190, 10 ** 6 * (i + 1), 4000))
                for i in range(3)]
    batches += [("create_transfers_fast",
                 _transfers(rng, 8190, 10 ** 8, 4000, linked=1.0))]
    for op, batch in batches:
        padded = np.zeros(lanes, dtype=batch.dtype)
        padded[: len(batch)] = batch
        soa = types.to_soa(padded)
        ts += 10 ** 6
        gpu, cg = getattr(sm, op)(gpu, convert.soa_to_tensors(soa, cuda_device),
                                  len(batch), ts)
        cpu, cc = getattr(sm, op)(cpu, convert.soa_to_tensors(soa, "cpu"),
                                  len(batch), ts)
        assert torch.equal(cg.cpu(), cc), op
    want = convert.ledger_to_numpy(cpu)
    got = convert.ledger_to_numpy(gpu)
    for name in ("accounts", "transfers"):
        for k in ("key_lo", "key_hi", "tombstone", "count", "probe_overflow"):
            np.testing.assert_array_equal(got[name][k], want[name][k])
        for k in want[name]["cols"]:
            np.testing.assert_array_equal(got[name]["cols"][k], want[name]["cols"][k])
    assert sm.ledger_digest(gpu).item() == sm.ledger_digest(cpu).item()


def _padded_soa(batch, lanes, dev):
    padded = np.zeros(lanes, dtype=batch.dtype)
    padded[: len(batch)] = batch
    return convert.soa_to_tensors(types.to_soa(padded), dev)


def _prepass_equal(gpu, cpu, batch, lanes, ts, dev):
    """K32 on the card ledger and its plain version on the CPU copy: every
    record word, dense balance and dense slot."""
    k = sp.seq_prepass(gpu, _padded_soa(batch, lanes, dev), len(batch), ts)
    p = sp.seq_prepass_plain(cpu, _padded_soa(batch, lanes, "cpu"), len(batch),
                             ts)
    for name in ("rec", "bal", "dslot"):
        assert torch.equal(k[name].cpu(), p[name]), name


def _ledgers_equal(got, want, what):
    got, want = convert.ledger_to_numpy(got), convert.ledger_to_numpy(want)
    for name in want:
        for k, v in want[name].items():
            if k == "cols":
                for c in v:
                    np.testing.assert_array_equal(got[name]["cols"][c], v[c],
                                                  err_msg=f"{what} {name}/{c}")
            else:
                np.testing.assert_array_equal(got[name][k], v,
                                              err_msg=f"{what} {name}/{k}")


@pytest.mark.parametrize("trap", ["cluster_reuse", "posted_collisions",
                                  "join_collisions", "probe_cap"])
def test_sequential_traps_on_card_match_split_plain(cuda_device, trap):
    """testing/seqtraps.py's cases, where K32's pre-batch answers go stale
    inside the batch: K32 and K6 on the card against the split plain form
    (pre-pass, then sequencer) on the CPU, byte for byte."""
    from tigerbeetle_tpu_torch.testing import seqtraps

    lanes = 2048
    case = seqtraps.trap_case(trap, lanes, cuda_device)
    gpu = case["ledger"]
    cpu = convert.ledger_from_numpy(convert.ledger_to_numpy(gpu), "cpu")
    batch, count, ts = case["batch"], case["count"], case["ts"]
    _prepass_equal(gpu, cpu, batch, lanes, ts, cuda_device)
    _, kc, kov = sp.create_transfers_seq(
        gpu, _padded_soa(batch, lanes, cuda_device), count, ts)
    _, pc, pov = sp.create_transfers_seq_split_plain(
        cpu, _padded_soa(batch, lanes, "cpu"), count, ts)
    assert torch.equal(kc.cpu(), pc)
    assert bool(kov) == bool(pov) == (trap == "probe_cap")
    _ledgers_equal(gpu, cpu, trap)


@pytest.mark.parametrize("case", ["one_transfer", "count_above"])
def test_sequential_transfers_refuse_a_batch_wider_than_the_overlay(
        cuda_device, case):
    """K6's sequencer holds SEQ_MAX_N events and runs only the lanes up to
    the count (C7): a 16,384-lane batch of one transfer commits on the card
    as the plain version does on the CPU; a count above SEQ_MAX_N raises
    before any launch and leaves the ledger as it was."""
    lanes = 2 * _cuda.SEQ_MAX_N
    caps = (1 << 10, 1 << 11, 1 << 10, 1 << 10)
    gpu = sm.make_ledger(*caps, device=cuda_device)
    cpu = sm.make_ledger(*caps, device="cpu")
    acc = types.accounts_array([types.account(id=i, ledger=1, code=10)
                                for i in (1, 2)])
    for led, dev in ((gpu, cuda_device), (cpu, "cpu")):
        sp.create_accounts_seq(led, _padded_soa(acc, 64, dev), 2, 10 ** 9)
    batch = types.transfers_array([types.transfer(
        id=1, debit_account_id=1, credit_account_id=2, amount=1, ledger=1,
        code=1)])
    if case == "count_above":
        before = convert.ledger_to_numpy(gpu)
        launches = _cuda.counts()
        with pytest.raises(_cuda.CudaKernelError,
                           match=f"count of {_cuda.SEQ_MAX_N + 1} events"):
            sp.create_transfers_seq(gpu, _padded_soa(batch, lanes, cuda_device),
                                    _cuda.SEQ_MAX_N + 1, 2 * 10 ** 9)
        assert _cuda.counts() == launches
        _ledgers_equal(gpu, convert.ledger_from_numpy(before, "cpu"), "refused")
        return
    _, kc, kov = sp.create_transfers_seq(
        gpu, _padded_soa(batch, lanes, cuda_device), 1, 2 * 10 ** 9)
    _, pc, pov = sp.create_transfers_seq_plain(
        cpu, _padded_soa(batch, lanes, "cpu"), 1, 2 * 10 ** 9)
    assert kc.shape == (lanes,) and torch.equal(kc.cpu(), pc)
    assert int(pc[0]) == 0 and not bool(kov) and not bool(pov)
    _ledgers_equal(gpu, cpu, "one transfer")


def test_sequential_kernels_on_card_match_plain_on_cpu(cuda_device):
    """K7 and K6 on the card and their plain versions on the CPU, batch by
    batch from the same ledger: the same codes, the same overflow flag and
    the same arrays of every table and of the history log."""
    rng = np.random.default_rng(11)
    lanes = 512
    caps = (1 << 12, 1 << 13, 1 << 11, 1 << 12)
    gpu = sm.make_ledger(*caps, device=cuda_device)
    cpu = sm.make_ledger(*caps, device="cpu")
    mix = seqmix.TransferMix(rng, list(range(1, 120)), 1 << 40)
    steps = [("create_accounts_seq", seqmix.accounts_batch(rng, 1, 100), 10 ** 9),
             ("create_accounts_seq", seqmix.accounts_batch(rng, 90, 60), 2 * 10 ** 9)]
    steps += [("create_transfers_seq", mix.batch(lanes - 2), (b + 3) * 10 ** 9)
              for b in range(4)]
    steps += [("create_transfers_seq", mix.batch(lanes), (1 << 64) - 10 ** 10)]
    for op, batch, ts in steps:
        if op == "create_transfers_seq":  # K32 against its plain version
            _prepass_equal(gpu, cpu, batch, lanes, ts, cuda_device)
        _, kc, kov = getattr(sp, op)(gpu, _padded_soa(batch, lanes, cuda_device),
                                     len(batch), ts)
        _, pc, pov = getattr(sp, op)(cpu, _padded_soa(batch, lanes, "cpu"),
                                     len(batch), ts)
        assert torch.equal(kc.cpu(), pc), op
        assert bool(kov) == bool(pov)
        want = convert.ledger_to_numpy(cpu)
        got = convert.ledger_to_numpy(gpu)
        for name in want:
            for k, v in want[name].items():
                if k == "cols":
                    for c in v:
                        np.testing.assert_array_equal(got[name]["cols"][c], v[c],
                                                      err_msg=f"{op} {name}/{c}")
                else:
                    np.testing.assert_array_equal(got[name][k], v,
                                                  err_msg=f"{op} {name}/{k}")


def test_tombstone_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(12)
    cap = 1 << 12
    lo, rows = keyed_rows(rng, 1500, cuda_device)
    base = ht.make_table(cap, COLS, cuda_device)
    ht.insert_plain(base, lo, torch.zeros_like(lo),
                    torch.ones_like(lo, dtype=torch.bool), rows, cap)
    live = np.flatnonzero(convert.tensor_to_array(base.key_lo) != 0)
    slots = rng.choice(live, 700).astype(np.int64)
    slots[:10] = cap + 3  # dropped, yet counted, as in JAX
    slot = torch.from_numpy(slots).to(cuda_device)
    valid = torch.from_numpy(rng.random(700) < 0.7).to(cuda_device)
    tables = []
    for fn in (ht.remove_to_tombstone, ht.remove_to_tombstone_plain):
        t = ht.Table(base.key_lo.clone(), base.key_hi.clone(),
                     base.tombstone.clone(), {k: v.clone() for k, v in
                                              base.cols.items()},
                     base.count.clone(), base.probe_overflow.clone())
        fn(t, slot, valid)
        tables.append(t)
    tables_equal(*tables)
    assert int(tables[0].count) == 1500 - int(valid.sum())


# -- K2's claim/write entries and the general kernel (K9-K12) -----------------


def ledger_to(led, dev):
    return convert.ledger_from_numpy(convert.ledger_to_numpy(led), dev)


def test_claim_and_write_entries_match_plain(cuda_device):
    """K2's claim leaves the table as it was (claim_slots), the claimed
    slots equal the plain protocol's, a closed gate clears the marks, an
    open gate writes what the plain write_rows writes."""
    rng = np.random.default_rng(41)
    cap = 1 << 12
    lo, rows = keyed_rows(rng, 1500, cuda_device)
    hi = torch.zeros_like(lo)
    t = ht.make_table(cap, COLS, cuda_device)
    ht.insert(t, lo, hi, torch.ones_like(lo, dtype=torch.bool), rows, cap)
    ht.remove_to_tombstone(t, torch.arange(0, cap, 37, device=cuda_device),
                           torch.ones(len(range(0, cap, 37)), dtype=torch.bool,
                                      device=cuda_device))
    new = torch.cat([convert.array_to_tensor(same_home(cap, 5, 6, 1 << 61),
                                             cuda_device),
                     lo[:40] + (1 << 40)])
    nh = torch.zeros_like(new)
    mask = torch.from_numpy(rng.random(len(new)) < 0.85).to(cuda_device)
    nrows = {"val": new * 3, "tag": new.to(torch.int32)}
    for max_probe in (sm.MAX_PROBE, 1):
        before = ledger_table_copy(t)
        ck, ok_ = ht.claim_slots(t, new, nh, mask, max_probe)
        tables_equal(t, before)
        cp, op = ht.claim_slots_plain(ledger_table_copy(t, "cpu"), new.cpu(),
                                      nh.cpu(), mask.cpu(), max_probe)
        assert torch.equal(ck.cpu(), cp) and bool(ok_) == bool(op)
        for gate in (1, 0):
            a = ledger_table_copy(t)
            claimed, word = _cuda.claim(a.key_lo, a.key_hi, a.tombstone, new,
                                        nh, mask, max_probe)
            word.fill_(gate)
            _cuda.write_claimed(a.key_lo, a.key_hi, a.tombstone, a.cols,
                                a.count, new, nh, claimed, mask, nrows,
                                gate=word, revert=True)
            b = ledger_table_copy(t)
            if gate == 0:
                ht.write_rows(b, new, nh, ck, mask, nrows)
                c = ledger_table_copy(t, "cpu")
                ht.write_rows_plain(c, new.cpu(), nh.cpu(), cp, mask.cpu(),
                                    {k: v.cpu() for k, v in nrows.items()})
                tables_equal(ledger_table_copy(b, "cpu"), c)
            tables_equal(a, b)


def ledger_table_copy(t, dev=None):
    dev = dev or t.key_lo.device
    return ht.Table(t.key_lo.to(dev, copy=True), t.key_hi.to(dev, copy=True),
                    t.tombstone.to(dev, copy=True),
                    {k: v.to(dev, copy=True) for k, v in t.cols.items()},
                    t.count.to(dev, copy=True),
                    t.probe_overflow.to(dev, copy=True))


def test_full_index_legs_and_waves_match_plain(cuda_device):
    rng = np.random.default_rng(43)
    n = 2048
    lo = rng.integers(1, 600, n).astype(np.uint64)
    lo[rng.random(n) < 0.05] = 0
    lo[2000:] = 0
    pend = rng.integers(0, 700, n).astype(np.uint64)
    zero = np.zeros(n, np.uint64)
    args = [convert.array_to_tensor(a, cuda_device) for a in (lo, zero, pend,
                                                             zero)]
    k = tf._build_id_index(*args)
    p = tf._build_id_index_plain(*[a.cpu() for a in args])
    for x, y in zip(k, p):
        assert torch.equal(x.cpu(), y)

    slots = rng.integers(0, 300, (2, n)).astype(np.int64)
    live = rng.random((2, n)) < 0.9
    flags = rng.integers(0, 4, n)
    cap = 1 << 10
    for has_pv in (True, False):
        start = {c: torch.from_numpy(rng.integers(
            0, 1 << 62, 2 * n, dtype=np.int64)) for c in tf._BAL_COLS}
        start["debits_pending_hi"][::7] = -1  # 2**128 - 1: any add overflows
        start["debits_pending_lo"][::7] = -1
        cpu = (start, cap, torch.from_numpy(rng.random(n) < 0.7),
               torch.from_numpy(rng.integers(0, 1 << 62, n, dtype=np.int64)),
               torch.from_numpy(rng.integers(0, 1 << 40, n, dtype=np.int64)),
               torch.from_numpy(slots[0]), torch.from_numpy(slots[1]),
               torch.from_numpy(live[0]), torch.from_numpy(live[1]),
               torch.from_numpy(flags == 1), torch.from_numpy(flags == 2),
               torch.from_numpy(flags >= 2), has_pv)
        gpu = tuple({kk: vv.to(cuda_device) for kk, vv in a.items()}
                    if isinstance(a, dict) else
                    a.to(cuda_device) if isinstance(a, torch.Tensor) else a
                    for a in cpu)
        kl, pl = tf._leg_balances(*gpu), tf._leg_balances(*cpu)
        for x, y in zip(kl, pl):
            if isinstance(y, tuple):
                assert torch.equal(x.lo.cpu(), y.lo)
                assert torch.equal(x.hi.cpu(), y.hi)
            else:
                assert torch.equal(x.cpu(), y)
        assert bool(pl.arith_broken)

    for max_rounds in (2, 8):
        hazard = torch.from_numpy(rng.random(n) < 0.3)
        hs = torch.from_numpy(rng.integers(0, 64, (2, n)).astype(np.int64))
        valid = torch.arange(n) < 2000
        cpu = (hazard, torch.tensor([False]), hs[0], torch.from_numpy(live[0]),
               hs[1], torch.from_numpy(live[1]), valid, cap, max_rounds)
        gpu = tuple(a.to(cuda_device) if isinstance(a, torch.Tensor) else a
                    for a in cpu)
        kw, pw = tf._wave_schedule(*gpu), tf._wave_schedule_plain(
            cpu[0], cpu[1][0], *cpu[2:])
        for x, y in zip(kw, pw):
            assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("waves", [True, False])
def test_general_kernel_on_card_matches_plain_on_cpu(cuda_device, waves):
    """create_transfers_full_impl on the card (K1, K2, K9-K12) against the
    plain version on a CPU copy, batch by batch of the general mix and each
    FLAG_SEQ kind, with pass budgets of 1, 2 and 8: codes, kflags, the wave
    vector and every ledger array."""
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine

    rng = np.random.default_rng(47 + waves)
    lanes = 512
    m = TorchStateMachine(LedgerConfig(accounts_capacity_log2=10,
                                       transfers_capacity_log2=14,
                                       posted_capacity_log2=12,
                                       history_capacity_log2=12),
                          batch_lanes=lanes, device="cpu")
    m.create_accounts(seqmix.accounts_batch(rng, 1, 200, faults=False), 10)
    mix = fullmix.GeneralMix(rng, list(range(1, 201)), 1 << 40)
    m.create_transfers(mix.seed_big(), 10 ** 9)
    kinds = ["general"] * 3 + list(fullmix.SEQ_REASONS)
    for b, kind in enumerate(kinds):
        batch = mix.batch(lanes - 10, kind)
        padded = np.zeros(lanes, dtype=batch.dtype)
        padded[:len(batch)] = batch
        soa = types.to_soa(padded)
        ts = 10 ** 9 * (b + 2)
        for max_passes in (1, 2, 8):
            gk = ledger_to(m.ledger, cuda_device)
            gp = ledger_to(m.ledger, "cpu")
            rk = tf.create_transfers_full_impl(
                gk, convert.soa_to_tensors(soa, cuda_device), len(batch), ts,
                max_passes=max_passes, use_waves=waves)
            rp = tf.create_transfers_full_impl(
                gp, convert.soa_to_tensors(soa, "cpu"), len(batch), ts,
                max_passes=max_passes, use_waves=waves)
            for x, y in zip(rk[1:], rp[1:]):
                assert torch.equal(x.cpu(), y), (kind, max_passes)
            want = convert.ledger_to_numpy(gp)
            got = convert.ledger_to_numpy(gk)
            for name in want:
                for key, v in want[name].items():
                    if key == "cols":
                        for c in v:
                            np.testing.assert_array_equal(got[name]["cols"][c],
                                                          v[c])
                    else:
                        np.testing.assert_array_equal(got[name][key], v)
        res = m.create_transfers(batch, ts)
        mix.settle(i for i, _ in res)


TRAP_LANES = 8192
TRAP_CASES = [(t, TRAP_LANES) for t in fulltraps.TRAPS] + [
    ("cross_chain", TRAP_LANES - 42)]  # lanes not a multiple of 64


@pytest.fixture(scope="module")
def trap_ledger():
    """A CPU machine's ledger after 8,190 accounts (limit and history flags)
    and two 8,190-event batches of the general mix, and the mix."""
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine

    rng = np.random.default_rng(53)
    m = TorchStateMachine(LedgerConfig(accounts_capacity_log2=14,
                                       transfers_capacity_log2=16,
                                       posted_capacity_log2=14,
                                       history_capacity_log2=15),
                          batch_lanes=TRAP_LANES, device="cpu")
    m.create_accounts(seqmix.accounts_batch(rng, 1, 8190, faults=False), 10)
    mix = fullmix.GeneralMix(rng, list(range(1, 8191)), 1 << 40)
    for b in range(2):
        res = m.create_transfers(mix.batch(8190), 10 ** 9 * (b + 1))
        mix.settle(i for i, _ in res)
    return m.ledger, mix


def trap_case(ledger, mix, trap, lanes):
    """Trap ``trap``'s batch padded to ``lanes``, its count and SoA, checked
    to reach its condition (fulltraps.trap_facts) against the plain
    kernel's codes on a CPU copy of ``ledger``."""
    count = lanes - 2
    batch = fulltraps.trap_batch(mix, trap, count)
    padded = np.zeros(lanes, dtype=batch.dtype)
    padded[:count] = batch
    soa = types.to_soa(padded)
    rp = tf.create_transfers_full_impl(
        ledger_to(ledger, "cpu"), convert.soa_to_tensors(soa, "cpu"), count,
        10 ** 11, max_passes=tf._MAX_PASSES, use_waves=True)
    facts = fulltraps.trap_facts(trap, ledger, padded, count, rp[1].numpy())
    return count, soa, facts


@pytest.mark.parametrize("trap,lanes", TRAP_CASES)
def test_trap_batches_reach_their_conditions(trap_ledger, trap, lanes):
    """At 8,190 events each trap puts its step across the kernels' blocks:
    a split id group whose first lane fails, a chain failing in a block
    other than its start's, a pending posted (and one posted twice) from
    another block, a hazard run over two of K12's chunks with ``proved``
    false, an unschedulable batch (trap_case raises otherwise)."""
    ledger, mix = trap_ledger
    _, _, facts = trap_case(ledger, mix, trap, lanes)
    assert facts


@pytest.mark.parametrize("trap,lanes", TRAP_CASES)
def test_general_kernel_traps_across_blocks_match_plain(cuda_device,
                                                        trap_ledger, trap,
                                                        lanes):
    """testing/fulltraps.py's batches, whose id groups, chains, in-batch
    pendings, double posts and hazard chains cross the blocks of K11's and
    K12's grids, at 8,190 events: the kernels on the card against the plain
    versions on a CPU copy, byte for byte (codes, kflags, the wave vector,
    every ledger array), pass budgets 1, 2 and 8, waves on and off."""
    ledger, mix = trap_ledger
    count, soa, _ = trap_case(ledger, mix, trap, lanes)
    for max_passes in (1, 2, 8):
        for waves in (True, False):
            gk, gp = ledger_to(ledger, cuda_device), ledger_to(ledger, "cpu")
            rk = tf.create_transfers_full_impl(
                gk, convert.soa_to_tensors(soa, cuda_device), count,
                10 ** 11, max_passes=max_passes, use_waves=waves)
            rp = tf.create_transfers_full_impl(
                gp, convert.soa_to_tensors(soa, "cpu"), count, 10 ** 11,
                max_passes=max_passes, use_waves=waves)
            for x, y in zip(rk[1:], rp[1:]):
                assert torch.equal(x.cpu(), y), (trap, max_passes, waves)
            _ledgers_equal(gk, gp, f"{trap} {max_passes} {waves}")


def test_general_core_replays_in_a_cuda_graph(cuda_device):
    """The kernel core of one batch (K9, K12 and the Jacobi loop's K11 and
    K10 launches; K11 and K12 are cooperative launches) captured in a CUDA
    graph: a replay gives the eager core's plan, byte for byte."""
    rng = np.random.default_rng(59)
    lanes = 512
    led = sm.make_ledger(1 << 10, 1 << 12, 1 << 10, 1 << 10, device=cuda_device)
    acc = seqmix.accounts_batch(rng, 1, 200, faults=False)
    sp.create_accounts_seq(led, _padded_soa(acc, lanes, cuda_device), 200, 10)
    mix = fullmix.GeneralMix(rng, list(range(1, 201)), 1 << 40)
    batch = mix.batch(lanes - 10)
    soa = _padded_soa(batch, lanes, cuda_device)
    count = len(batch)
    valid = torch.arange(lanes, device=cuda_device) < count
    postvoid = ((soa["flags"] & (tf.TF_POST | tf.TF_VOID)) != 0) & valid
    ctx = tf.build_gather_ctx(led, soa, valid, postvoid)
    eager = tf._kernel_core(ctx, soa, count, 10 ** 9, use_waves=True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tf._kernel_core(ctx, soa, count, 10 ** 9, use_waves=True)
    graph.replay()
    torch.cuda.synchronize()
    for field in eager._fields:
        a, b = getattr(eager, field), getattr(captured, field)
        for k in (a if isinstance(a, dict) else {None: a}):
            x = a[k] if k is not None else a
            y = b[k] if k is not None else b
            assert torch.equal(x, y), (field, k)


def _legs_equal(got, want, what):
    for field, x, y in zip(want._fields, got, want):
        if isinstance(y, tuple):
            assert torch.equal(x.lo.cpu(), y.lo), (what, field)
            assert torch.equal(x.hi.cpu(), y.hi), (what, field)
        else:
            assert torch.equal(x.cpu(), y), (what, field)


def _full_legs(args, cache):
    a = args
    return tf._legs_from_buffers(_cuda.full_legs(
        a["start_bal"], a["cap_sentinel"], a["ok_lanes"], a["amt_lo"],
        a["pamt_lo"], a["dr_slot"], a["cr_slot"], a["dr_live"],
        a["cr_live"], a["pending_f"], a["post"], a["postvoid"],
        a["has_postvoid"], cache=cache))


@pytest.mark.parametrize("n", (1, 300, 8192))
@pytest.mark.parametrize("name", k10cases.CASES)
def test_full_legs_cases_match_split_plain(cuda_device, name, n):
    """K10 over the card (a sorted leg a thread in blocks of 128; one grid
    barrier from a fresh cache, four when it sorts) at its traps
    (testing/k10cases.py): every output and the cache it leaves, byte for
    byte against the split plain form on the CPU; then a second launch
    from the cache it left (the fresh path), and one with no cache."""
    args, cache = k10cases.case(name, n)
    ca, cc = k10cases.to_tensors(args, cache, "cpu")
    ga, gc = k10cases.to_tensors(args, cache, cuda_device)
    want = tf._leg_balances_split_plain(**ca, cache=cc)
    _legs_equal(_full_legs(ga, gc), want, name)
    if cc is not None:
        assert torch.equal(gc[0].cpu()[:2 * n], cc[0][:2 * n])
        assert torch.equal(gc[1].cpu(), cc[1]) and torch.equal(gc[2].cpu(), cc[2])
        _legs_equal(_full_legs(ga, gc), want, name + " from the cache")
    _legs_equal(_full_legs(ga, None), want, name + " with no cache")


def test_full_legs_info_reads_the_launch(cuda_device):
    """K10's launch at 8,192 lanes: 128 blocks of 128, every one resident
    at once (one a SM with the stale sort's 128 KB), no local memory."""
    info = _cuda.full_legs_info(8192)
    assert info["threads"] == _cuda.LEG_THREADS and info["blocks"] == 128
    assert info["shared_bytes"] == 8 * 16384
    assert info["blocks_per_sm"] >= 1 and info["local_bytes"] == 0
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert info["blocks"] <= sms * info["blocks_per_sm"]


@pytest.mark.parametrize("case", k9cases.CASES)
@pytest.mark.parametrize("n", k9cases.SIZES)
def test_full_index_cases_match_plain(cuda_device, case, n):
    """K9 over the card (a thread a lane, grid barriers) at its traps: every
    id equal or 0, a probe chain of 512 ids that wraps the table, pending
    ids naming id 0, a missing id and the lane's own; byte for byte
    against the plain version on the CPU."""
    args = [convert.array_to_tensor(a, "cpu") for a in k9cases.case(case, n)]
    got = tf._build_id_index(*(a.to(cuda_device) for a in args))
    want = tf._build_id_index_plain(*args)
    for field, x, y in zip(want._fields, got, want):
        assert torch.equal(x.cpu(), y), field


def test_full_index_replays_in_a_cuda_graph(cuda_device):
    """K9 captured in a CUDA graph: each replay clears its table again, so
    new ids written in place into the captured inputs give the plain
    version's outputs for those ids."""
    first = [convert.array_to_tensor(a, cuda_device)
             for a in k9cases.case("random", 8190)]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tf._build_id_index(*first)
    for case in ("one_home", "random", "all_equal"):
        new = k9cases.case(case, 8190)
        for t, a in zip(first, new):
            t.copy_(convert.array_to_tensor(a, cuda_device))
        graph.replay()
        torch.cuda.synchronize()
        want = tf._build_id_index_plain(
            *(convert.array_to_tensor(a, "cpu") for a in new))
        for field, x, y in zip(want._fields, captured, want):
            assert torch.equal(x.cpu(), y), (case, field)
    info = _cuda.full_index_info(8190)
    assert info["blocks"] == 64 and info["threads"] == 128
    assert info["local_bytes"] == 0, info


# -- K13-K16: the transfer index and the queries ---------------------------------

U64M = (1 << 64) - 1


def level_on(lvl, dev):
    return ix.Level(lvl.block.to(dev, copy=True))


def levels_equal(a, b, what=""):
    assert torch.equal(a.block.cpu(), b.block.cpu()), what


def random_entries(rng, n, fill, dev):
    """``n`` entries, the first ``fill`` real with repeated accounts and
    timestamps (so ties occur), the rest sentinels."""
    block = np.full((5, n), U64M, np.uint64)
    block[0, :fill] = rng.integers(1, 9, fill)
    block[1, :fill] = rng.integers(0, 2, fill)
    block[2, :fill] = rng.integers(1, 3 * n, fill)
    block[3, :fill] = rng.integers(1, 1 << 62, fill)
    block[4, :fill] = rng.integers(0, 4, fill)
    perm = rng.permutation(n)
    return ix.Level(convert.array_to_tensor(block[:, perm], dev))


@pytest.mark.parametrize("n", [64, 8192, 1 << 15])
def test_run_sort_and_merge_match_plain(cuda_device, n):
    """K13 (chunks; then K14 rounds past 8,192 entries, or up to 8,192
    unfused) and K14's carry merges against the plain stable lexsort and
    concatenate-and-sort."""
    rng = np.random.default_rng(n)
    for fill in (0, n // 3, n):
        lvl = random_entries(rng, n, fill, "cpu")
        got = ix._sort_level(level_on(lvl, cuda_device))
        levels_equal(got, ix._sort_level_plain(lvl), f"sort n={n} fill={fill}")
        if n % 1024 == 0:
            cols = [level_on(lvl, cuda_device)[c] for c in ix.COLS]
            got = ix._sort_masked([cols], None, n, fused=False)[0]
            levels_equal(got, ix._sort_level_plain(lvl),
                         f"unfused sort n={n} fill={fill}")
    runs = [ix._sort_level_plain(random_entries(rng, m, m // 2, "cpu"))
            for m in (64, 64, 128, 256)]
    got = ix._merge([level_on(r, cuda_device) for r in runs])
    levels_equal(got, ix._merge_plain(runs), "carry merge")


@pytest.mark.parametrize("mode", k13cases.MODES)
@pytest.mark.parametrize("n", k13cases.SIZES)
def test_run_sort_cases_match_plain(cuda_device, n, mode):
    """K13 at the cluster form's traps (one launch for both sides), byte
    for byte against the plain lexsort and its own algorithm's plain
    version: every column, the sorted run's length, one launch a call."""
    cols, use = k13cases.entries(n, mode)
    cpu = [convert.array_to_tensor(c, "cpu") for c in cols]
    cpu2 = [c.flip(0).contiguous() for c in cpu]
    use_t = torch.from_numpy(use)
    outs = [[torch.empty(n, dtype=torch.int64, device=cuda_device)
             for _ in range(5)] for _ in range(2)]
    before = _cuda.KERNELS["run_sort"].launches
    run = _cuda.run_sort([[c.to(cuda_device) for c in cpu],
                          [c.to(cuda_device) for c in cpu2]],
                         use_t.to(cuda_device), outs)
    assert run == n and _cuda.KERNELS["run_sort"].launches == before + 1
    for got, src in zip(outs, (cpu, cpu2)):
        want = ix._sort_level_plain(ix._masked(src, use_t))
        split, _run = ix._sort_split_plain(src, use_t, n)
        levels_equal(ix.Level(torch.stack(got)), want, f"n={n} {mode}")
        levels_equal(split, want, f"split n={n} {mode}")


@pytest.mark.parametrize("n_in,n_out", k13cases.PADDED)
def test_run_sort_padded_runs_match_plain(cuda_device, n_in, n_out):
    """Entries past n_in are sentinels; fused and unfused forms."""
    cols, use = k13cases.entries(n_in, "ties", seed=1)
    cpu = [convert.array_to_tensor(c, "cpu") for c in cols]
    use_t = torch.from_numpy(use)
    want = ix._sort_level_plain(ix._masked(cpu, use_t, n_out))
    dev = [c.to(cuda_device) for c in cpu]
    for fused in (True, False):
        got = ix._sort_masked([dev], use_t.to(cuda_device), n_out, fused=fused)
        levels_equal(got[0], want, f"{n_in}->{n_out} fused={fused}")


def test_run_sort_launch_is_one_cluster_and_allocates_nothing(cuda_device):
    """A run of 1,025 to 8,192 entries is one cluster of a block a chunk
    of 512, which the card can schedule (both sides at once), and the call
    allocates no device memory; shorter and longer runs, and unfused ones,
    take unclustered chunks of 1,024."""
    for n in (1025, 2048, 4097, 8190, 8192):
        info = _cuda.run_sort_info(n)
        assert info["cluster"] == -(-n // ix.MERGE_CHUNK), (n, info)
        assert info["max_clusters"] >= 2, (n, info)
    for n, fused in ((1024, True), (8192, False), (1 << 15, True)):
        assert _cuda.run_sort_info(n, fused)["cluster"] == 1
    cols, use = k13cases.entries(8190, "random")
    src = [convert.array_to_tensor(c, cuda_device) for c in cols]
    use_t = torch.from_numpy(use).to(cuda_device)
    outs = [[torch.empty(8190, dtype=torch.int64, device=cuda_device)
             for _ in range(5)] for _ in range(2)]
    _cuda.run_sort([src, src], use_t, outs)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    _cuda.run_sort([src, src], use_t, outs)
    assert torch.cuda.memory_allocated() == before


def index_machine(dev, lanes=128, batches=9, history=False):
    """A port machine (on ``dev``) after plain batches, so its transfer index
    holds several levels; with ``history``, HISTORY accounts on the
    sequential path and a rolled-back chain."""
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine

    m = TorchStateMachine(LedgerConfig(accounts_capacity_log2=8,
                                       transfers_capacity_log2=12,
                                       history_capacity_log2=12),
                          batch_lanes=lanes, device=dev,
                          force_sequential=history)
    rng = np.random.default_rng(3)
    m.create_accounts(seqmix.accounts_batch(rng, 1, 40, faults=False), 10)
    mix = seqmix.TransferMix(rng, list(range(1, 41)), 1000)
    for b in range(batches):
        m.create_transfers(mix.batch(lanes - 8), 10 ** 9 * (b + 1))
    return m


def test_build_runs_full_build_and_queries_match_plain(cuda_device):
    """K1 + K13 (build_runs), K13 + K14 (full builds), K15 (windows and
    union, both directions, the four side combinations, a window past the
    range, sentinel-only levels) on the card against the plain versions on
    a CPU copy of the same ledger and levels."""
    cpu = index_machine("cpu")
    led = ledger_to(cpu.ledger, cuda_device)
    rng = np.random.default_rng(8)
    ids = convert.tensor_to_array(cpu.ledger.transfers.key_lo)
    ids = ids[ids != 0]
    for frac in (0.0, 0.5, 1.0):
        lo = rng.choice(ids, 128)
        lo[:10] = 0
        ok = rng.random(128) < frac
        args = [convert.array_to_tensor(x, d) for x in (lo, np.zeros(128, np.uint64))
                for d in ("cpu",)]
        want = ix.build_runs(cpu.ledger, *args, torch.from_numpy(ok))
        got = ix.build_runs(led, *(a.to(cuda_device) for a in args),
                            torch.from_numpy(ok).to(cuda_device))
        for g, w in zip(got, want):
            levels_equal(g, w, f"build_runs ok={frac}")
    for side in ("debit_account_id", "credit_account_id"):
        levels_equal(ix._full_build_side(led, side, 1 << 13),
                     ix._full_build_side(cpu.ledger, side, 1 << 13), side)
    idx = cpu.index
    assert sum(idx.occupied) >= 2
    idx._ensure_level(len(idx.occupied))  # a sentinel-only level on top
    dr = [level_on(lv, cuda_device) for lv in idx.dr_levels]
    cr = [level_on(lv, cuda_device) for lv in idx.cr_levels]
    ts = np.sort(convert.tensor_to_array(cpu.ledger.transfers.cols["timestamp"]))
    ts = ts[ts != 0]
    for desc in (False, True):
        for want in ((True, True), (True, False), (False, True), (False, False)):
            for acct, lo_ts, hi_ts, k in ((1, 1, U64M - 1, 8192),
                                          (7, int(ts[50]), int(ts[400]), 64),
                                          (3, 1, U64M - 1, 16),
                                          (5, int(ts[-1]) + 1, U64M - 1, 64),
                                          (99, 1, U64M - 1, 64)):
                w = ix.query_transfers(idx.dr_levels, idx.cr_levels, acct, 0,
                                       lo_ts, hi_ts, *want, k, desc)
                g = ix.query_transfers(dr, cr, acct, 0, lo_ts, hi_ts, *want,
                                       k, desc)
                for a, b in zip(g, w):
                    assert torch.equal(a.cpu(), b), (desc, want, acct)
            w = ix._query_side(idx.dr_levels, 2, 0, 1, U64M, 256, desc)
            g = ix._query_side(dr, 2, 0, 1, U64M, 256, desc)
            for a, b in zip(g, w):
                assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("case", k15cases.CASES)
def test_index_query_cases_match_plain(cuda_device, case):
    """K15 at its traps (one side unwanted, the descending wrap,
    sentinel-only levels, no rows, runs longer than k, k = 1, only the
    deepest level, keys of U64_MAX among the valid, more merged keys than
    the union block stages): union mode against the plain query and its
    own algorithm's plain version, window mode against the plain window,
    byte for byte, invalid lanes included."""
    dr, cr, queries = k15cases.case(case)

    def levels(blocks, dev):
        return [ix.Level(convert.array_to_tensor(b, dev)) for b in blocks]

    cpu = (levels(dr, "cpu"), levels(cr, "cpu"))
    gpu = (levels(dr, cuda_device), levels(cr, cuda_device))
    for q in queries:
        acct_lo, acct_hi, ts_min, ts_max, want_dr, want_cr, k, desc = q
        got = ix.query_transfers(*gpu, *q)
        for fn in (ix.query_transfers_plain, ix.query_transfers_split_plain):
            want = fn(*cpu, *q)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b), (fn.__name__, q)
        for side_gpu, side_cpu in zip(gpu, cpu):
            if not side_cpu:
                continue
            a = ix._query_side(side_gpu, acct_lo, acct_hi, ts_min, ts_max, k,
                               desc)
            b = ix._query_side_plain(side_cpu, acct_lo, acct_hi, ts_min,
                                     ts_max, k, desc)
            for x, y in zip(a, b):
                assert torch.equal(x.cpu(), y), ("window", q)


def test_index_query_refuses_too_many_windows(cuda_device):
    """More windows than K15's launch takes (64) raise CudaKernelError and
    count no launch; the info entry reads both kernels' launches."""
    lvl = ix._sentinel_level(64, cuda_device)
    before = _cuda.KERNELS["index_window"].launches
    with pytest.raises(_cuda.CudaKernelError, match="index_window failed"):
        _cuda.index_union([[lvl] * 40, [lvl] * 25], [True, True], 1, 0, 1,
                          U64M - 1, 16, False)
    with pytest.raises(_cuda.CudaKernelError, match="index_window failed"):
        _cuda.index_window([[lvl] * 65], 1, 0, 1, U64M - 1, 16, False)
    assert _cuda.KERNELS["index_window"].launches == before
    info = _cuda.index_window_info()
    assert info["union_threads"] == info["window_threads"] == 1024
    assert info["union_local_bytes"] == 0 and info["window_local_bytes"] == 0


def test_history_scan_matches_plain(cuda_device):
    """K16 against the plain scan_history: matches fewer and more than k, a
    rolled-back tail above count, both sides and directions."""
    cpu = index_machine("cpu", lanes=256, batches=6, history=True)
    h = convert.ledger_to_numpy(cpu.ledger)["history"]
    count = int(h["count"])
    # Force a tail above the count (a popped chain's rows).
    led = ledger_to(cpu.ledger, cuda_device)
    tail = min(40, led.history.capacity - count)
    for name, col in led.history.cols.items():
        col[count:count + tail] = cpu.ledger.history.cols[name][:tail].to(cuda_device)
    cpu_led = ledger_to(led, "cpu")
    ts = h["cols"]["timestamp"][:count]
    for desc in (False, True):
        for want in ((True, True), (True, False), (False, True)):
            for acct, lo_ts, hi_ts, k in ((4, 1, U64M - 1, 8), (4, 1, U64M - 1,
                                                                 led.history.capacity),
                                          (11, int(ts[3]), int(ts[-3]), 64),
                                          (99, 1, U64M - 1, 32)):
                w = q.scan_history(cpu_led, acct, 0, lo_ts, hi_ts, *want, desc, k)
                g = q.scan_history(led, acct, 0, lo_ts, hi_ts, *want, desc, k)
                assert torch.equal(g[0].cpu(), w[0])
                for name in w[1]:
                    assert torch.equal(g[1][name].cpu(), w[1][name]), name
    # A log whose timestamps below count do not increase is refused.
    led.history.cols["timestamp"][:count] = led.history.cols["timestamp"][:count].flip(0)
    with pytest.raises(RuntimeError, match="do not increase"):
        q.scan_history(led, 4, 0, 1, U64M - 1, True, True, True, 8)


def test_machine_queries_on_card_match_cpu(cuda_device):
    """TorchStateMachine on the card (index appended through K1, K13, K14;
    queries through K15 and K16) against the same machine on the CPU."""
    from tigerbeetle_tpu_torch.ops import scan_builder as sb

    cpu = index_machine("cpu", batches=5)
    gpu = index_machine(cuda_device, batches=5)
    for a, b in zip(gpu.index.dr_levels + gpu.index.cr_levels,
                    cpu.index.dr_levels + cpu.index.cr_levels):
        levels_equal(a, b)
    assert gpu.index.occupied == cpu.index.occupied
    f = np.zeros(1, dtype=types.ACCOUNT_FILTER_DTYPE)[0]
    for acct in (1, 4, 9):
        for flags in (1, 2, 3, 7):
            f["account_id_lo"], f["limit"], f["flags"] = acct, 8190, flags
            assert gpu.get_account_transfers(f).tobytes() == \
                cpu.get_account_transfers(f).tobytes()
    expr = sb.merge_union(sb.scan_prefix("code", 10),
                          sb.scan_prefix("user_data_64", 2))
    assert gpu.scan_transfers(expr).tobytes() == cpu.scan_transfers(expr).tobytes()


# -- K17-K19: the cold tier ----------------------------------------------------------


def evict_table(rng, cap, n_live, n_tomb, dev):
    """A transfers table with live rows (timestamps with repeats) and
    tombstones, made through K2 and K8."""
    from tigerbeetle_tpu_torch.ops import cold

    t = ht.make_table(cap, sm.TRANSFER_COLS, dev)
    ids = np.unique(rng.integers(1, 1 << 62, n_live + 64, dtype=np.uint64))[:n_live]
    lo = convert.array_to_tensor(ids, dev)
    hi = convert.array_to_tensor(
        np.where(rng.random(n_live) < 0.3, 7, 0).astype(np.uint64), dev)
    rows = {}
    for name, dt in sm.TRANSFER_COLS.items():
        vals = rng.integers(0, 1 << 62, n_live, dtype=np.uint64)
        if name == "timestamp":
            vals = rng.integers(1, n_live // 3 + 2, n_live, dtype=np.uint64)
        rows[name] = convert.array_to_tensor(
            vals if dt == torch.int64 else vals.astype(np.uint32), dev)
    ht.insert(t, lo, hi, torch.ones_like(lo, dtype=torch.bool), rows, cap)
    gone = ht.lookup(t, lo[:n_tomb], hi[:n_tomb], cap)
    ht.remove_to_tombstone(t, gone.slot, gone.found)
    return t


@pytest.mark.parametrize("cap", [1 << 8, 1 << 16])
def test_evict_kernels_match_plain(cuda_device, cap):
    """K18's radix select, K19's compaction and keep mask, and
    drop_evicted's K2 rebuild against their plain versions on the same
    table, at several fractions, on an empty table and past the C-1
    clamp."""
    from tigerbeetle_tpu_torch.ops import cold

    rng = np.random.default_rng(cap)
    t = evict_table(rng, cap, cap // 2, cap // 16, cuda_device)
    empty = ht.make_table(cap, sm.TRANSFER_COLS, cuda_device)
    for table in (t, empty):
        for num in (1, 250, 500, 999):
            thr = cold.eviction_threshold(table, num, 1000)
            assert torch.equal(thr, cold.eviction_threshold_plain(table, num, 1000))
            for k in (cap, cap // 4):
                got = cold.extract_evicted(table, thr, k, keep=True)
                want = cold.extract_evicted_plain(table, thr, k)
                assert int(got[0]) == int(want[0])
                assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
                for name in want[3]:
                    assert torch.equal(got[3][name], want[3][name]), name
                assert torch.equal(got[4], cold.keep_mask_plain(table, thr))
            tables_equal(cold.drop_evicted(table, thr, got[4]),
                         cold.drop_evicted_plain(table, thr))
    clamp = evict_table(rng, cap, cap // 2, 0, cuda_device)
    clamp.count.fill_(4 * cap)
    assert torch.equal(cold.eviction_threshold(clamp, 999, 1000),
                       cold.eviction_threshold_plain(clamp, 999, 1000))


def test_bloom_kernel_matches_plain(cuda_device):
    """K17 against its plain version: filters of 2^10 and 2^20 bits, hits
    per lane, and the FLAG_COLD word under every mask."""
    from tigerbeetle_tpu_torch.ops import cold

    rng = np.random.default_rng(17)
    n = 8192
    lo = convert.array_to_tensor(rng.integers(0, 1 << 64, n, dtype=np.uint64), cuda_device)
    hi = convert.array_to_tensor(rng.integers(0, 4, n, dtype=np.uint64), cuda_device)
    for bits_log2 in (10, 20):
        words = rng.integers(0, 1 << 32, (1 << bits_log2) // 32, dtype=np.uint64)
        words &= rng.integers(0, 1 << 32, len(words), dtype=np.uint64)
        bloom = convert.bloom_to_tensor(words.astype(np.uint32), cuda_device)
        hits = cold.bloom_check_impl(bloom, lo, hi)
        assert torch.equal(hits, cold.bloom_check_plain(bloom, lo, hi))
        masks = [torch.from_numpy(rng.random(n) < f).to(cuda_device)
                 for f in (0.9, 0.5, 0.3, 0.5, 0.2)]
        plo, phi = lo.flip(0), hi.flip(0)
        for checked in (None, masks[4], torch.ones_like(masks[4])):
            for postvoid in (None, masks[2]):
                args = (bloom, lo, hi, masks[0], masks[1], plo, phi, postvoid,
                        masks[3], checked)
                word = torch.zeros((), dtype=torch.int32, device=cuda_device)
                got = cold.bloom_flag(*args, word, 16)
                want = cold.bloom_flag(*[a.cpu() if torch.is_tensor(a) else a
                                         for a in args],
                                       torch.zeros((), dtype=torch.int32), 16)
                assert int(got) == int(want)


def test_tiered_machine_on_card_matches_cpu(cuda_device, tmp_path):
    """A tiered TorchStateMachine on the card (K17 in every general batch,
    K18, K19 and K2 at each eviction, K1 and K2 in each rehydration)
    against the same machine on the CPU: codes, every hot table array, the
    spill's manifest and files, lookups and queries across the tiers."""
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine

    cfg = LedgerConfig(accounts_capacity_log2=8, transfers_capacity_log2=8,
                       posted_capacity_log2=8)
    machines = [TorchStateMachine(cfg, batch_lanes=64, device=d,
                                  spill_dir=str(tmp_path / str(d)),
                                  hot_transfers_capacity_max=256)
                for d in (cuda_device, "cpu")]
    acc = np.zeros(8, dtype=types.ACCOUNT_DTYPE)
    acc["id_lo"] = np.arange(1, 9)
    acc["ledger"], acc["code"] = 1, 10
    assert [m.create_accounts(acc, 1) for m in machines] == [[], []]
    rng = np.random.default_rng(9)
    tid = 1000
    for b in range(12):
        batch = np.zeros(50, dtype=types.TRANSFER_DTYPE)
        batch["id_lo"] = tid + np.arange(50)
        if b >= 8:  # resubmit evicted ids, some with another amount
            batch["id_lo"][:10] = rng.integers(1000, 1100, 10)
        batch["debit_account_id_lo"] = 1 + batch["id_lo"] % 8
        batch["credit_account_id_lo"] = 1 + (batch["id_lo"] + 3) % 8
        batch["amount_lo"] = 1 + batch["id_lo"] % 9 + (rng.random(50) < 0.3)
        batch["ledger"], batch["code"] = 1, 10
        tid += 50
        got = [m.create_transfers(batch) for m in machines]
        assert got[0] == got[1]
        tables_equal(machines[0].ledger.transfers,
                     table_to(machines[1].ledger.transfers, cuda_device))
        assert machines[0].cold.manifest() == machines[1].cold.manifest()
        assert (machines[0]._evictions, machines[0].cold_retries,
                machines[0].rehydrated_rows) == (
            machines[1]._evictions, machines[1].cold_retries,
            machines[1].rehydrated_rows)
    assert machines[0]._evictions > 0 and machines[0].cold_retries > 0
    ids = list(range(990, 1700, 7))
    assert machines[0].lookup_transfers(ids).tobytes() == \
        machines[1].lookup_transfers(ids).tobytes()
    f = np.zeros(1, dtype=types.ACCOUNT_FILTER_DTYPE)[0]
    f["account_id_lo"], f["limit"], f["flags"] = 2, 8190, 3
    assert machines[0].get_account_transfers(f).tobytes() == \
        machines[1].get_account_transfers(f).tobytes()


def test_port_modules_import_neither_jax_nor_the_jax_package():
    """Importing every module of the port leaves jax and tigerbeetle_tpu
    out of sys.modules (runs on any machine)."""
    root = Path(__file__).resolve().parents[1]
    mods = sorted(
        "tigerbeetle_tpu_torch." + ".".join(p.relative_to(
            root / "tigerbeetle_tpu_torch").with_suffix("").parts)
        for p in (root / "tigerbeetle_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    assert {"tigerbeetle_tpu_torch.ops.index", "tigerbeetle_tpu_torch.ops.query",
            "tigerbeetle_tpu_torch.ops.scan_builder",
            "tigerbeetle_tpu_torch.ops.scrub", "tigerbeetle_tpu_torch.ops.merkle",
            "tigerbeetle_tpu_torch.bench",
            "tigerbeetle_tpu_torch.vsr.timeout",
            "tigerbeetle_tpu_torch.ops.group",
            "tigerbeetle_tpu_torch.host_engine",
            "tigerbeetle_tpu_torch.sanitize",
            "tigerbeetle_tpu_torch.vsr.checkpoint",
            "tigerbeetle_tpu_torch.vsr.overload",
            "tigerbeetle_tpu_torch.lsm.forest",
            "tigerbeetle_tpu_torch.utils.ewah",
            "tigerbeetle_tpu_torch.sim.vopr_tpu",
            "tigerbeetle_tpu_torch.sim.prng",
            "tigerbeetle_tpu_torch.sim.vopr_scale",
            "tigerbeetle_tpu_torch.vsr.consensus",
            "tigerbeetle_tpu_torch.vsr.statesync",
            "tigerbeetle_tpu_torch.parallel.mesh",
            "tigerbeetle_tpu_torch.parallel.sharded",
            "tigerbeetle_tpu_torch.testing.k9cases",
            "tigerbeetle_tpu_torch.testing.k15cases",
            "tigerbeetle_tpu_torch.testing.k1cases",
            "tigerbeetle_tpu_torch.testing.k7cases"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'tigerbeetle_tpu.')) or m == 'tigerbeetle_tpu')\n"
        "raise SystemExit(str(bad) if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# -- K20-K23: the bench generator, scrub and Merkle commitments ----------------------


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_bench_gen_matches_plain(cuda_device, mode):
    """K20 writes every column of its SoA as its plain version computes it,
    byte for byte, where b * count + lane passes 2^32 too."""
    from tigerbeetle_tpu_torch.utils import benchgen

    for b in (0, 1, (1 << 32) // 8190 + 1):
        for n in (2, 10_000):
            out = benchgen.empty_soa(8192, cuda_device)
            for c in out.values():
                c.fill_(-1)  # K20 must overwrite every lane
            benchgen._generate(mode, b, 8192, 8190, n, 1 << 32, None, out)
            want = benchgen.gen_batch_plain(mode, b, 8192, 8190, n, 1 << 32,
                                            "cpu")
            for k in want:
                assert torch.equal(out[k].cpu(), want[k]), (mode, b, n, k)


def fault_domain_machine(dev, lanes=64):
    """A machine holding pendings, posts, voids, linked rollbacks and
    tombstones (the general kernel and the sequential path)."""
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine

    cfg = LedgerConfig(accounts_capacity_log2=8, transfers_capacity_log2=10,
                       posted_capacity_log2=8)
    m = TorchStateMachine(cfg, batch_lanes=lanes, device=dev)
    rng = np.random.default_rng(21)
    assert m.create_accounts(_accounts(np.random.default_rng(1), 40, 1)[:40], 1) \
        is not None
    for i in range(6):
        m.create_transfers(_transfers(rng, lanes, 10_000 * (i + 1), 40))
    post = np.zeros(20, dtype=types.TRANSFER_DTYPE)
    post["id_lo"] = 900_000 + np.arange(20)
    post["pending_id_lo"] = 10_000 + np.arange(20)
    post["flags"] = np.where(np.arange(20) % 2, 8, 4)
    m.create_transfers(post)
    return m


def ledger_on(led, dev):
    return convert.ledger_from_numpy(convert.ledger_to_numpy(led), dev)


def test_scrub_fold_matches_plain_and_digest(cuda_device):
    from tigerbeetle_tpu_torch.ops import scrub

    m = fault_domain_machine(cuda_device)
    got = scrub.scrub_digest(m.ledger).cpu()
    want = scrub.scrub_digest_plain(ledger_on(m.ledger, "cpu"))
    assert torch.equal(got, want)
    assert int(got[2]) != 0 and int(got[0]) == int(sm.ledger_digest(m.ledger))


def test_merkle_build_touch_and_path_match_plain(cuda_device):
    from tigerbeetle_tpu_torch.ops import merkle as mk

    m = fault_domain_machine(cuda_device)
    cpu = ledger_on(m.ledger, "cpu")
    forest = mk.build_forest(m.ledger)
    plain = mk.build_forest_impl(cpu)
    for name in mk.PADS:
        assert torch.equal(forest.pad(name).cpu(), plain.pad(name)), name
    assert torch.equal(mk.verify_roots(forest, m.ledger).cpu(),
                       mk.verify_roots_impl(plain, cpu))
    stale = mk.Forest(**{n: torch.zeros_like(forest.pad(n)) for n in mk.PADS})
    stale_cpu = mk.Forest(**{n: torch.zeros_like(plain.pad(n))
                             for n in mk.PADS})
    keys = torch.arange(1, 300, dtype=torch.int64)
    keys[::7] = 0
    dup = torch.cat([keys, keys[:50]])  # duplicate touches
    pend = torch.arange(10_000, 10_030, dtype=torch.int64)  # some not found
    z = torch.zeros_like
    args_cpu = (dup, z(dup), dup % 40, z(dup), pend, z(pend))
    got = mk.update_transfers(stale, m.ledger,
                              *(a.to(cuda_device) for a in args_cpu),
                              max_probe=sm.MAX_PROBE, has_postvoid=True)
    want = mk.update_transfers(stale_cpu, cpu, *args_cpu,
                               max_probe=sm.MAX_PROBE, has_postvoid=True)
    for name in mk.PADS:
        assert torch.equal(got.pad(name).cpu(), want.pad(name)), name
    for name in mk.PADS:
        cap = getattr(cpu, name).capacity
        levels = cap.bit_length() - 1
        for slot in (0, 1, cap - 1):
            g = mk.gather_path(forest.pad(name), slot, levels)
            w = mk.gather_path(plain.pad(name), slot, levels)
            for a, b in zip(g, w):
                assert torch.equal(a.cpu(), b)


def test_bad_launch_raises_cuda_kernel_error(cuda_device):
    """A launch the kernel's entry point refuses (a slot past the heap)
    raises CudaKernelError, which the fault domain treats as a device
    fault."""
    heap = torch.zeros(2 * 1024, dtype=torch.int64, device=cuda_device)
    with pytest.raises(_cuda.CudaKernelError):
        _cuda.merkle_path(heap, 5000, 10)


def _function_sources(path: Path):
    import ast

    text = path.read_text()
    tree = ast.parse(text)
    return {node.name: ast.get_source_segment(text, node)
            for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef))}


# The numpy twins the port keeps line for line with its sources.
_TWINS = {
    "ops/scrub.py": (
        "mix64_np", "_limbs", "_wrap_sum", "mirror_digests", "_join",
        "_grown", "_pad_pow2", "_account_arrays", "_transfer_arrays",
        "_posted_arrays", "_history_arrays", "model_from_ledger",
        "build_host_ledger",
        "SimulatedDeviceFault", "DeviceStateUnrecoverable"),
    "ops/merkle.py": (
        "_np_row_accounts", "_np_row_transfers", "_np_row_posted",
        "np_leaves", "np_tree", "np_root", "np_table_leaves",
        "np_ledger_roots", "np_account_leaf", "np_transfer_leaf",
        "np_posted_leaf", "canonical_proof_row", "proof_row_dtype",
        "ProofError", "encode_proof", "check_proof", "_np_combine",
        "coalesce_touch_records"),
}


@pytest.mark.parametrize("path,name", [(p, n) for p, names in _TWINS.items()
                                       for n in names])
def test_numpy_twin_equals_its_source(path, name):
    """Read from the sources (no import of the JAX package): the code of
    each twin equals the reference's, apart from comments, import lines
    and, in model_from_ledger, the one line that reads the port's
    tensors."""
    import io
    import tokenize

    root = Path(__file__).resolve().parents[1]

    def body(src):
        # The code, line for line: comments dropped, then import lines.
        toks = [t for t in tokenize.generate_tokens(io.StringIO(src).readline)
                if t.type != tokenize.COMMENT]
        return [line.rstrip() for line in tokenize.untokenize(toks).splitlines()
                if not line.lstrip().startswith(("import ", "from "))
                and line.strip() != "ledger = _np_ledger(ledger)"]

    got = _function_sources(root / "tigerbeetle_tpu_torch" / path)[name]
    want = _function_sources(root / "tigerbeetle_tpu" / path)[name]
    if name in ("SimulatedDeviceFault", "DeviceStateUnrecoverable"):
        # The exception classes keep their names and bases; their
        # docstrings name the port's device errors.
        assert got.splitlines()[0] == want.splitlines()[0]
        return
    assert body(got) == body(want)


# -- K24 and the grouped commit's graph (ops/group.py) ----------------------------


def _group_ledger(device, rng):
    """A small ledger on ``device``: 16 accounts, 300 transfers."""
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine

    m = TorchStateMachine(LedgerConfig(accounts_capacity_log2=10,
                                       transfers_capacity_log2=12),
                          batch_lanes=256, device=device)
    m.create_accounts(types.accounts_array(
        [types.account(id=i + 1, ledger=1, code=10) for i in range(16)]))
    b = np.zeros(250, dtype=types.TRANSFER_DTYPE)
    b["id_lo"] = 1000 + np.arange(250)
    b["debit_account_id_lo"] = 1 + rng.integers(0, 16, 250)
    b["credit_account_id_lo"] = 1 + (b["debit_account_id_lo"] + 2) % 16
    b["amount_lo"], b["ledger"], b["code"] = 5, 1, 10
    m.create_transfers(b)
    return m


def _stage(layout, rng, k):
    from tigerbeetle_tpu_torch.ops import group

    buf = torch.zeros(layout.nbytes, dtype=torch.uint8)
    cols, counts, tss = layout.arrays(buf.numpy())
    ts = 10 ** 9
    for j in range(k):
        n = int(rng.integers(1, layout.lanes + 1))
        cols["id_lo"][j, :n] = 900 + rng.integers(0, 1500, n)  # some exist
        cols["debit_account_id_lo"][j, :n] = 1 + rng.integers(0, 17, n)
        cols["credit_account_id_lo"][j, :n] = 1 + rng.integers(0, 16, n)
        cols["amount_lo"][j, :n] = rng.integers(0, 50, n)
        cols["flags"][j, :n] = np.where(rng.random(n) < 0.2, 2, 0)
        cols["ledger"][j, :n], cols["code"][j, :n] = 1, 10
        ts += n
        counts[j], tss[j] = n, ts
    tss[k:] = ts
    return buf, [int(c) for c in counts], [int(t) for t in tss], group


@pytest.mark.parametrize("k", [1, 2, 17, 32])
def test_group_graph_replay_matches_eager_and_plain(cuda_device, k):
    """One replay of the grouped commit's graph against GROUP_K eager steps
    on the card and the plain loop on CPU copies: codes [32, 256], the
    run's overflow word and every ledger array, byte for byte; padding
    steps apply nothing."""
    from tigerbeetle_tpu_torch.ops import group

    rng = np.random.default_rng(k)
    m = _group_ledger(cuda_device, rng)
    layout = group.StagingLayout(group.GROUP_K, 256)
    buf, counts, tss, _g = _stage(layout, rng, k)
    base = convert.ledger_to_numpy(m.ledger)
    graph = group.GroupGraph(convert.ledger_from_numpy(base, cuda_device),
                             group.GROUP_K, 256)
    codes_g, ovf_g, _lo, _hi = graph.run(buf.pin_memory())
    eager = convert.ledger_from_numpy(base, cuda_device)
    _l, codes_e, ovf_e, _a, _b = group.group_dispatch_steps(
        eager, layout.tensors(buf.to(cuda_device))[0], counts, tss)
    plain = convert.ledger_from_numpy(base, torch.device("cpu"))
    _l, codes_p, ovf_p, _a, _b = group.group_dispatch_steps(
        plain, layout.tensors(buf.clone())[0], counts, tss)
    assert torch.equal(codes_g.cpu(), codes_e.cpu())
    assert torch.equal(codes_g.cpu(), codes_p)
    assert ovf_g.tolist() == ovf_e.tolist() == ovf_p.tolist()
    got = convert.ledger_to_numpy(graph._ledger)
    for want in (convert.ledger_to_numpy(eager),
                 convert.ledger_to_numpy(plain)):
        for name in ("accounts", "transfers"):
            for key in ("key_lo", "key_hi", "tombstone", "count"):
                np.testing.assert_array_equal(got[name][key], want[name][key])
            for c in want[name]["cols"]:
                np.testing.assert_array_equal(got[name]["cols"][c],
                                              want[name]["cols"][c])


def test_group_graph_k3_chains_and_duplicates_across_blocks(cuda_device):
    """The grouped commit's graph captures K3's cooperative launch: a
    replay over batches whose linked chains and duplicate ids cross K3's
    blocks of 128 lanes (one with a failing member) gives the eager steps'
    and the plain loop's codes and ledger."""
    from tigerbeetle_tpu_torch.ops import group

    m = _group_ledger(cuda_device, np.random.default_rng(31))
    layout = group.StagingLayout(group.GROUP_K, 256)
    buf = torch.zeros(layout.nbytes, dtype=torch.uint8)
    cols, cw, tw = layout.arrays(buf.numpy())
    ts = 10 ** 9
    for j, n in enumerate((256, 256, 200)):
        lane = np.arange(n)
        cols["id_lo"][j, :n] = 5000 + 1000 * j + lane
        cols["debit_account_id_lo"][j, :n] = 1 + lane % 16
        cols["credit_account_id_lo"][j, :n] = 1 + (lane + 3) % 16
        cols["amount_lo"][j, :n] = 1 + lane % 7
        cols["ledger"][j, :n], cols["code"][j, :n] = 1, 10
        ts += n
        cw[j], tw[j] = n, ts
    tw[3:] = ts
    b = sm.VALIDATE_BLOCK
    cols["flags"][0, b - 10:b + 20] = 1          # a chain over the boundary
    cols["amount_lo"][0, b + 15] = 0             # that fails in block 1
    cols["flags"][0, 200:255] = 1                # and one that holds
    cols["id_lo"][1, [3, b - 1, b, 2 * b - 2]] = 4242  # duplicates
    cols["flags"][2, 150:200] = 1                # open at the batch's end
    counts, tss = [int(c) for c in cw], [int(t) for t in tw]
    base = convert.ledger_to_numpy(m.ledger)
    graph = group.GroupGraph(convert.ledger_from_numpy(base, cuda_device),
                             group.GROUP_K, 256)
    codes_g, _ovf, _lo, _hi = graph.run(buf.pin_memory())
    eager = convert.ledger_from_numpy(base, cuda_device)
    codes_e = group.group_dispatch_steps(
        eager, layout.tensors(buf.to(cuda_device))[0], counts, tss)[1]
    plain = convert.ledger_from_numpy(base, torch.device("cpu"))
    codes_p = group.group_dispatch_steps(
        plain, layout.tensors(buf.clone())[0], counts, tss)[1]
    assert torch.equal(codes_g.cpu(), codes_e.cpu())
    assert torch.equal(codes_g.cpu(), codes_p)
    got = codes_p.numpy()
    assert set(got[0, b - 10:b + 20].tolist()) == {1, 18}
    assert (got[1, [b - 1, b, 2 * b - 2]] != 0).all()
    assert set(got[2, 150:200].tolist()) == {1, 2}
    want = convert.ledger_to_numpy(plain)
    have = convert.ledger_to_numpy(graph._ledger)
    for name in ("accounts", "transfers"):
        for key in ("key_lo", "key_hi", "count"):
            np.testing.assert_array_equal(have[name][key], want[name][key])


@pytest.mark.parametrize("case", k3cases.CASES)
@pytest.mark.parametrize("n", [512, 8192])
def test_validate_cases_match_plain(cuda_device, case, n):
    """K3 at its grid-wide form's traps (duplicates and chains across its
    blocks, a chain as long as the batch, a linked last lane, a count
    below the lanes), byte for byte against the plain version and its own
    algorithm's plain version on the CPU: codes and ok."""
    batch, ctx, count, ts = k3cases.transfer_case(case, n)

    def on(dev):
        t = lambda a: convert.array_to_tensor(a, dev)  # noqa: E731
        zero = torch.zeros(n, dtype=torch.int64, device=dev)
        return (convert.soa_to_tensors(batch, dev), sm.TransferCtx(
            t(ctx["dr_found"]), t(ctx["cr_found"]), zero, zero,
            {"ledger": t(ctx["dr_ledger"])}, {"ledger": t(ctx["cr_ledger"])},
            t(ctx["ex_found"]), {k: t(v) for k, v in ctx["e"].items()}))

    kc, ko = sm.transfer_codes(*on(cuda_device), count, ts)
    for fn in (sm.transfer_codes_plain, sm.transfer_codes_split_plain):
        pc, po = fn(*on("cpu"), count, ts)
        assert torch.equal(kc.cpu(), pc) and torch.equal(ko.cpu(), po), fn
    batch, found, e, count = k3cases.account_case(case, n)
    args = [(convert.soa_to_tensors(batch, d), torch.from_numpy(found).to(d),
             convert.soa_to_tensors(e, d)) for d in (cuda_device, "cpu")]
    kc, ko = sm.account_codes(*args[0], count)
    for fn in (sm.account_codes_plain, sm.account_codes_split_plain):
        pc, po = fn(*args[1], count)
        assert torch.equal(kc.cpu(), pc) and torch.equal(ko.cpu(), po), fn


def test_validate_refuses_a_launch_the_card_cannot_hold(cuda_device):
    """K3's batch-wide steps wait at grid barriers, so its blocks must all
    be resident: a cooperative launch of more blocks than the card holds
    raises CudaKernelError and launches nothing, rather than running in
    some other form."""
    batch, ctx, count, ts = k3cases.transfer_case("random", 8192)
    t = lambda a: convert.array_to_tensor(a, cuda_device)  # noqa: E731
    soa = convert.soa_to_tensors(batch, cuda_device)
    cols = ([soa[c] for c in sm.TRANSFER_BATCH_COLS]
            + [t(ctx[c]) for c in sm.TRANSFER_CTX_COLS]
            + [t(ctx["e"][c]) for c in sm.TRANSFER_EXISTS_COLS])
    before = _cuda.KERNELS["validate"].launches
    with pytest.raises(_cuda.CudaKernelError, match="validate failed"):
        _cuda.validate("transfers", cols, count, ts, blocks=10_000)
    assert _cuda.KERNELS["validate"].launches == before
    codes, ok = _cuda.validate("transfers", cols, count, ts, blocks=64)
    pc, po = sm.transfer_codes_plain(
        convert.soa_to_tensors(batch, "cpu"), sm.TransferCtx(
            *(convert.array_to_tensor(ctx[c], "cpu") for c in ("dr_found", "cr_found")),
            None, None, {"ledger": convert.array_to_tensor(ctx["dr_ledger"], "cpu")},
            {"ledger": convert.array_to_tensor(ctx["cr_ledger"], "cpu")},
            convert.array_to_tensor(ctx["ex_found"], "cpu"),
            {k: convert.array_to_tensor(v, "cpu") for k, v in ctx["e"].items()}),
        count, ts)
    assert torch.equal(codes.cpu(), pc) and torch.equal(ok.cpu(), po)


def test_group_graph_k2_scratch_is_batch_sized(cuda_device):
    """The grouped commit's graph holds K2's split-form scratch (claimed
    int64[lanes], the pre-pass's int32[2 lanes]) and nothing the size of
    the transfers table, and its replay equals the eager steps with ids
    that share homes in the transfers table."""
    from tigerbeetle_tpu_torch.ops import group

    rng = np.random.default_rng(77)
    m = _group_ledger(cuda_device, rng)
    layout = group.StagingLayout(group.GROUP_K, 256)
    buf, counts, tss, _g = _stage(layout, rng, 4)
    cols, _c, _t = layout.arrays(buf.numpy())
    cap = m.ledger.transfers.capacity
    homes = same_home(cap, 12, 32, 1 << 44)  # 8 homes of 12 ids a step
    for j in range(4):
        take = min(counts[j], 96)
        cols["id_lo"][j, :take] = homes[96 * j:96 * j + take]
    base = convert.ledger_to_numpy(m.ledger)
    graph = group.GroupGraph(convert.ledger_from_numpy(base, cuda_device),
                             group.GROUP_K, 256)
    scratch = graph.steps.iscratch
    assert [x.numel() for x in scratch] == [256, 512]
    held = [x for x in vars(graph.steps).values()
            if isinstance(x, torch.Tensor)] + list(scratch)
    assert all(x.numel() != cap for x in held)
    codes_g, ovf_g, _lo, _hi = graph.run(buf.pin_memory())
    eager = convert.ledger_from_numpy(base, cuda_device)
    _l, codes_e, ovf_e, _a, _b = group.group_dispatch_steps(
        eager, layout.tensors(buf.to(cuda_device))[0], counts, tss)
    assert torch.equal(codes_g.cpu(), codes_e.cpu())
    assert ovf_g.tolist() == ovf_e.tolist()
    got, want = (convert.ledger_to_numpy(graph._ledger),
                 convert.ledger_to_numpy(eager))
    for key in ("key_lo", "key_hi", "tombstone", "count"):
        np.testing.assert_array_equal(got["transfers"][key],
                                      want["transfers"][key])
    for c in want["transfers"]["cols"]:
        np.testing.assert_array_equal(got["transfers"]["cols"][c],
                                      want["transfers"]["cols"][c])


def test_group_step_matches_plain(cuda_device):
    from tigerbeetle_tpu_torch.ops import group

    counts = torch.tensor([5, 256, 0], dtype=torch.int64, device=cuda_device)
    tss = torch.tensor([100, 1 << 40, -7], dtype=torch.int64,
                       device=cuda_device)
    flags = torch.arange(256, dtype=torch.int32, device=cuda_device) % 7
    valid = torch.empty(256, dtype=torch.bool, device=cuda_device)
    ts = torch.empty(256, dtype=torch.int64, device=cuda_device)
    pending = torch.empty(256, dtype=torch.bool, device=cuda_device)
    for j in range(3):
        for flag in (False, True):
            table = torch.tensor(flag, device=cuda_device)
            word = torch.ones(1, dtype=torch.int32, device=cuda_device)
            want = group.group_step_plain(counts, tss, j, flags, table,
                                          word.clone())
            _cuda.group_step(counts, tss, j, flags, valid, ts, pending, table,
                             word)
            for a, b in zip((valid, ts, pending, word), want):
                assert torch.equal(a, b)


def test_device_word_forms_match_host_int_forms(cuda_device):
    """The forms the grouped commit's graph launches, step by step on one
    ledger: K1 and K3 reading the count and timestamp from device words
    into preallocated outputs, K4 and K2 on preallocated scratch, against
    the fast path's host-int forms (a padding step of count 0 included);
    K25 and K26 against their plain versions; K20 reading its batch index
    from a device word against its plain version."""
    from tigerbeetle_tpu_torch.ops import group
    from tigerbeetle_tpu_torch.utils import benchgen

    rng = np.random.default_rng(5)
    m = _group_ledger(cuda_device, rng)
    layout = group.StagingLayout(4, 256)
    buf, counts, tss, _g = _stage(layout, rng, 3)
    stacked, cw, tw = layout.tensors(buf.to(cuda_device))
    ref = convert.ledger_from_numpy(convert.ledger_to_numpy(m.ledger),
                                    cuda_device)
    got = convert.ledger_from_numpy(convert.ledger_to_numpy(m.ledger),
                                    cuda_device)
    s = group.FastSteps(got, 4, 256, cuda_device)
    names = sm.TRANSFER_EXISTS_COLS
    for j in range(4):
        soa = {n: c[j] for n, c in stacked.items()}
        c, t = counts[j], tss[j]
        xr, xg = ref.transfers, got.transfers
        want = ht.lookup(xr, soa["id_lo"], soa["id_hi"], sm.MAX_PROBE,
                         count=c, cols=names)
        found, slot, ovf, cols = _cuda.probe(
            xg.key_lo, xg.key_hi, xg.tombstone, xg.cols, soa["id_lo"],
            soa["id_hi"], sm.MAX_PROBE, 0, 256, names,
            count_word=cw[j:j + 1],
            out=(s.ex_found, s.ex_slot, [s.ex[n] for n in names]))
        assert ovf is None and found is s.ex_found
        assert torch.equal(found, want.found) and torch.equal(slot, want.slot)
        for n in names:
            assert torch.equal(cols[n], want.cols[n])
        dr = ht.lookup(ref.accounts, soa["debit_account_id_lo"],
                       soa["debit_account_id_hi"], sm.MAX_PROBE, count=c,
                       cols=("ledger",))
        cr = ht.lookup(ref.accounts, soa["credit_account_id_lo"],
                       soa["credit_account_id_hi"], sm.MAX_PROBE, count=c,
                       cols=("ledger",))
        ctx = sm.TransferCtx(dr.found, cr.found, dr.slot, cr.slot, dr.cols,
                             cr.cols, want.found, want.cols)
        kc, ko = sm.transfer_codes(soa, ctx, c, t)
        ctx_cols = {"dr_found": dr.found, "cr_found": cr.found,
                    "dr_ledger": dr.cols["ledger"],
                    "cr_ledger": cr.cols["ledger"], "ex_found": want.found}
        vcols = ([soa[n] for n in sm.TRANSFER_BATCH_COLS]
                 + [ctx_cols[n] for n in sm.TRANSFER_CTX_COLS]
                 + [want.cols[n] for n in names])
        codes, ok = _cuda.validate("transfers", vcols, 0, count_word=cw[j:j + 1],
                                   ts_word=tw[j:j + 1],
                                   out=(s.codes[j], s.ok, s.vscratch))
        assert torch.equal(codes, kc) and torch.equal(ok, ko)
        pend = (soa["flags"] & sm.TF_PENDING) != 0
        sm.apply_balances(ref.accounts, dr.slot, cr.slot, ko,
                          soa["amount_lo"], pend)
        _cuda.balance(dr.slot, cr.slot, ko, soa["amount_lo"], pend,
                      [got.accounts.cols[n] for n in sm.BALANCE_COLS])
        rows = sm.transfer_rows(soa, c, t)
        ck = ht.insert(xr, soa["id_lo"], soa["id_hi"], ko, rows,
                       sm.MAX_PROBE)[1]
        for x in s.iscratch:  # the kernel must not rely on its contents
            x.fill_(-1)
        cg = _cuda.insert(xg.key_lo, xg.key_hi, xg.tombstone, xg.cols,
                          xg.count, xg.probe_overflow, soa["id_lo"],
                          soa["id_hi"], ko, rows, sm.MAX_PROBE, 0,
                          scratch=s.iscratch)
        assert torch.equal(cg, ck)
        for name in ("accounts", "transfers"):
            tables_equal(getattr(got, name), getattr(ref, name))
    # K25 and K26 against their plain versions.
    for table_flag in (False, True):
        for prev in (0, 1):
            table = torch.tensor(table_flag, device=cuda_device)
            word = torch.tensor([prev], dtype=torch.int32, device=cuda_device)
            want_word = group.group_finish_plain(table, word.clone())
            _cuda.group_finish(table, word)
            assert torch.equal(word, want_word)
    for b0, count, ts0 in ((0, 8190, 10_000), (7, 3, 1 << 62),
                           ((1 << 64) - 2, 8190, 5)):
        base = torch.tensor([b0], dtype=torch.int64, device=cuda_device) \
            if b0 < (1 << 63) else torch.tensor([b0 - (1 << 64)],
                                                dtype=torch.int64,
                                                device=cuda_device)
        want = group.group_words_plain(base.clone(), count, ts0, 5)
        z = [torch.zeros(5, dtype=torch.int64, device=cuda_device)
             for _ in range(3)]
        _cuda.group_words(base, count, ts0, *z)
        for a, b in zip([base] + z, want):
            assert torch.equal(a, b)
    cols = benchgen.empty_soa(256, cuda_device)
    for b in (0, 3, (1 << 32) // 200 + 1):
        word = torch.tensor([b], dtype=torch.int64, device=cuda_device)
        _cuda.bench_gen([cols[n] for n in benchgen.GEN_COLS],
                        benchgen.MODE_PLAIN, 0, 200, 64, 1 << 32, b_word=word)
        want = benchgen.gen_batch_plain(benchgen.MODE_PLAIN, b, 256, 200, 64,
                                        1 << 32, cuda_device)
        for n in want:
            assert torch.equal(cols[n], want[n]), n


def test_capture_tripwire_on_the_card(cuda_device, monkeypatch):
    """warmup captures the grouped commit's graph; a growth's recapture is
    absorbed; a capture nothing explains raises under TB_SANITIZE_STRICT."""
    from tigerbeetle_tpu_torch import sanitize as san
    from tigerbeetle_tpu_torch.ops import group

    monkeypatch.setenv("TB_SANITIZE", "1")
    monkeypatch.setenv("TB_SANITIZE_STRICT", "1")
    m = _group_ledger(cuda_device, np.random.default_rng(1))
    m.group_device_commit = True
    c0 = group.CAPTURES
    m.warmup()
    assert group.CAPTURES == c0 + 1 and m._group_graph is not None

    def run(first, n=8):
        rows = np.zeros(n, dtype=types.TRANSFER_DTYPE)
        rows["id_lo"] = first + np.arange(n)
        rows["debit_account_id_lo"], rows["credit_account_id_lo"] = 1, 2
        rows["amount_lo"], rows["ledger"], rows["code"] = 1, 1, 10
        batches = [rows, rows.copy()]
        batches[1]["id_lo"] += n
        tss = [m.prepare("create_transfers", n) for _ in batches]
        return m.commit_group_fast(batches, tss)

    assert run(5000) == [[], []]
    assert group.CAPTURES == c0 + 1  # the same graph served the run
    m._group_graph = None  # forget the graph: the next run recaptures
    with pytest.raises(san.SanitizeError, match="capture tripwire"):
        run(6000)
    m._grow_if_needed(transfers=1 << 12)  # a growth: its capture is allowed
    assert run(7000) == [[], []]


# -- K27-K29: the batched VOPR ------------------------------------------------------


def _states_equal(a, b, what):
    for name, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: {name}"


def test_vopr_draw_matches_plain(cuda_device):
    """K27 draws every fault array as its plain version does, byte for
    byte, for R 1-6 and S up to the kernels' bound."""
    from tigerbeetle_tpu_torch.sim import prng
    from tigerbeetle_tpu_torch.sim import vopr_tpu as vt

    keys = prng.split(prng.PRNGKey(17, cuda_device), 4096)
    for R in range(1, 7):
        for S in (1, 8, 32, vt.MAX_SLOTS):
            for probs in ({}, dict(vt.HARSH_FAULTS, p_sdc=0.3)):
                n = _cuda.KERNELS["vopr_draw"].launches
                got = vt.draw_faults(keys, R, S, **probs)
                assert _cuda.KERNELS["vopr_draw"].launches == n + 1
                want = vt.draw_faults_plain(keys, R, S, **probs)
                for name in vt.FAULT_FIELDS:
                    assert torch.equal(got[name], want[name]), (R, S, name)


def test_vopr_draw_every_span_matches_plain(cuda_device):
    """K27's division-free randint over the slots at every span S from 1
    to MAX_SLOTS (R = 3): byte for byte the plain draws."""
    from tigerbeetle_tpu_torch.sim import prng
    from tigerbeetle_tpu_torch.sim import vopr_tpu as vt

    keys = prng.split(prng.PRNGKey(23, cuda_device), 1024)
    probs = dict(vt.HARSH_FAULTS, p_sdc=0.3)
    for S in range(1, vt.MAX_SLOTS + 1):
        got = vt.draw_faults(keys, 3, S, **probs)
        want = vt.draw_faults_plain(keys, 3, S, **probs)
        for name in vt.FAULT_FIELDS:
            assert torch.equal(got[name], want[name]), (S, name)


@pytest.mark.parametrize("bug", [None, "commit_quorum", "canonical_by_op",
                                 "no_truncate", "corrupt_serve", "wal_wrap",
                                 "split_brain", "amputate_vouch",
                                 "join_keep_stale", "scrub_off"])
def test_vopr_step_matches_plain(cuda_device, bug):
    """K28 steps 256 clusters as step_plain does, every field after every
    one of 40 steps, on the same state and faults."""
    from tigerbeetle_tpu_torch.sim import prng
    from tigerbeetle_tpu_torch.sim import vopr_tpu as vt

    R, S, probs = vt.BUG_CONFIGS[bug]
    n, steps = 256, 40
    max_ops = steps + 2
    state = vt.make_state(R, S, max_ops, n, cuda_device)
    key = prng.split(prng.PRNGKey(3, cuda_device), n)
    for i in range(steps):
        ks = prng.split(key, 2)
        key, sub = ks[:, 0], ks[:, 1]
        faults = vt.draw_faults(sub, R, S, **probs)
        got = vt.step(state, faults=faults, n_replicas=R, slots=S,
                      max_ops=max_ops, bug=bug)
        want = vt.step_plain(state, faults, n_replicas=R, slots=S,
                             max_ops=max_ops, bug=bug)
        _states_equal(got, want, f"step {i}")
        state = want


@pytest.mark.parametrize("bug", [None, "corrupt_serve", "split_brain"])
def test_vopr_run_matches_plain(cuda_device, bug):
    """K29's flags and final states equal the plain schedule loop's."""
    from tigerbeetle_tpu_torch.sim import vopr_tpu as vt

    R, S, probs = vt.BUG_CONFIGS[bug]
    flags, state = vt.run(1, 128, 120, R, S, bug, device=cuda_device,
                          final_state=True, **probs)
    want = vt.run_plain(1, 0, 128, 120, R, S, bug, cuda_device, **probs)
    _states_equal(state, want, "final state")
    assert np.array_equal(flags, want.violated.cpu().numpy())
    assert np.array_equal(vt.run(1, 128, 120, R, S, bug, device=cuda_device,
                                 **probs), flags)


def test_vopr_run_long_horizon_matches_plain(cuda_device):
    """A run whose canonical list passes the shared-memory bound keeps it in
    device memory, with the same flags and final states."""
    from tigerbeetle_tpu_torch.sim import vopr_tpu as vt

    steps = _cuda.VOPR_SHARED_MAX_OPS + 60
    flags, state = vt.run(2, 4, steps, device=cuda_device, final_state=True,
                          **vt.HARSH_FAULTS)
    want = vt.run_plain(2, 0, 4, steps, 3, 32, None, cuda_device,
                        **vt.HARSH_FAULTS)
    _states_equal(state, want, "long run")
    assert int(state.commit.max()) > 0
    assert np.array_equal(vt.run(2, 4, steps, device=cuda_device,
                                 **vt.HARSH_FAULTS), flags)


@pytest.mark.parametrize("R", [1, 6])
@pytest.mark.parametrize("S", [8, 32, 64, 256])
def test_vopr_run_chunks_match_plain(cuda_device, R, S):
    """K29 draws its steps 32 at a time; runs that end before, at and after
    a chunk's end (0, 1, 31, 33, 65 steps) equal the plain loop, flags
    and every final field, for one-warp and many-warp clusters."""
    from tigerbeetle_tpu_torch.sim import vopr_tpu as vt

    probs = dict(vt.HARSH_FAULTS, p_sdc=0.3)
    for steps in (0, 1, 31, 33, 65):
        n = _cuda.KERNELS["vopr_run"].launches
        flags, state = vt.run(6, 40, steps, R, S, device=cuda_device,
                              final_state=True, **probs)
        assert _cuda.KERNELS["vopr_run"].launches == n + 1
        want = vt.run_plain(6, 0, 40, steps, R, S, None, cuda_device, **probs)
        _states_equal(state, want, f"R={R} S={S} {steps} steps")
        assert np.array_equal(flags, want.violated.cpu().numpy())
        assert np.array_equal(vt.run(6, 40, steps, R, S, device=cuda_device,
                                     **probs), flags)


@pytest.mark.parametrize("steps", [_cuda.VOPR_SHARED_MAX_OPS - 2,
                                   _cuda.VOPR_SHARED_MAX_OPS - 1])
def test_vopr_run_at_the_shared_canon_boundary(cuda_device, steps):
    """max_ops 1,024 keeps the canonical lists of a flags-only run in
    shared memory, 1,025 in device memory; both equal the plain loop."""
    from tigerbeetle_tpu_torch.sim import vopr_tpu as vt

    kw = dict(bug="commit_quorum", **vt.HARSH_FAULTS)
    flags = vt.run(8, 12, steps, device=cuda_device, **kw)
    got_flags, state = vt.run(8, 12, steps, device=cuda_device,
                              final_state=True, **kw)
    want = vt.run_plain(8, 0, 12, steps, 3, 32, "commit_quorum", cuda_device,
                        **vt.HARSH_FAULTS)
    _states_equal(state, want, f"{steps} steps")
    assert np.array_equal(flags, want.violated.cpu().numpy())
    assert np.array_equal(got_flags, flags)


def test_vopr_run_info_reads_the_launch(cuda_device):
    """K29's registers and resident blocks as the card reports them."""
    for R, S, steps, warps in ((3, 32, 200, 1), (6, 256, 1100, 8)):
        info = _cuda.vopr_run_info(R, S, steps)
        assert info["threads"] == 32 * warps
        assert 0 < info["registers"] <= 255
        assert info["blocks_per_sm"] >= 1
        assert info["dynamic_smem_bytes"] == (0 if steps + 2 > 1024
                                              else 4 * (steps + 2))


def test_vopr_step_and_run_at_the_largest_shape(cuda_device):
    """K28 and K29 launch at R=6 and S=MAX_SLOTS (a block of MAX_SLOTS
    threads at the step's largest register count) and equal the plain
    versions there, every field."""
    from tigerbeetle_tpu_torch.sim import prng
    from tigerbeetle_tpu_torch.sim import vopr_tpu as vt

    R, S, n, steps = vt.MAX_REPLICAS, vt.MAX_SLOTS, 64, 30
    probs = dict(vt.HARSH_FAULTS, p_sdc=0.3)
    max_ops = steps + 2
    state = vt.make_state(R, S, max_ops, n, cuda_device)
    key = prng.split(prng.PRNGKey(4, cuda_device), n)
    for i in range(steps):
        ks = prng.split(key, 2)
        key, sub = ks[:, 0], ks[:, 1]
        faults = vt.draw_faults(sub, R, S, **probs)
        got = vt.step(state, faults=faults, n_replicas=R, slots=S,
                      max_ops=max_ops)
        want = vt.step_plain(state, faults, n_replicas=R, slots=S,
                             max_ops=max_ops)
        _states_equal(got, want, f"step {i}")
        state = want
    assert int(state.commit.max()) > 0
    flags, state = vt.run(4, n, steps, R, S, device=cuda_device,
                          final_state=True, **probs)
    want = vt.run_plain(4, 0, n, steps, R, S, None, cuda_device, **probs)
    _states_equal(state, want, "final state")
    assert np.array_equal(flags, want.violated.cpu().numpy())


def test_vopr_run_sharded_on_every_card_equals_run(cuda_device):
    """run_sharded over every visible card (one block of clusters each,
    padded to a multiple of the card count) against run on one card."""
    from tigerbeetle_tpu_torch.sim import vopr_tpu as vt

    n_cards = torch.cuda.device_count()
    for bug, n, R in ((None, 1001, 3), ("commit_quorum", 1001, 3),
                      ("split_brain", 409, 5)):
        kw = dict(bug=bug, n_replicas=R, **vt.HARSH_FAULTS)
        got = vt.run_sharded(5, n, 80, **kw)
        assert len(got) % n_cards == 0 and len(got) >= n
        want = vt.run(5, len(got), 80, device=cuda_device, **kw)
        assert np.array_equal(got, want)
        if bug is None:
            assert not got.any()
        if bug == "commit_quorum":
            assert got.any()
    one = vt.run_sharded(5, 300, 80, devices=[cuda_device],
                         bug="commit_quorum")
    assert np.array_equal(one, vt.run(5, 300, 80, bug="commit_quorum",
                                      device=cuda_device))


# -- K30, K31 and the slot-base forms of K4 and K10 (parallel/sharded.py) -----------


def _shard_tables(dev, n_shards, local, rng):
    """One local table a shard, filled to about a third with the shard's own
    keys (inserted with the mesh's hash shift), tombstones on shard 0 and the
    last shard full (every probe there runs out)."""
    from tigerbeetle_tpu_torch.parallel import sharded as tsh

    shift = n_shards.bit_length() - 1
    specs = {"val": torch.int64, "tag": torch.int32}
    tables = [ht.make_table(local, specs, dev) for _ in range(n_shards)]
    cand = np.unique(rng.integers(1, 1 << 62, 40 * local * n_shards,
                                  dtype=np.uint64))
    own = tsh.mix64_np(cand, np.zeros_like(cand)) & np.uint64(n_shards - 1)
    keys = {}
    for s in range(n_shards):
        k = cand[own == s][:local if s == n_shards - 1 else local // 3]
        keys[s] = k
        lo = convert.array_to_tensor(k, dev)
        ht.insert(tables[s], lo, torch.zeros_like(lo),
                  torch.ones(len(k), dtype=torch.bool, device=dev),
                  {"val": lo * 5, "tag": lo.to(torch.int32)},
                  max_probe=local, hash_shift=shift)
    slots = torch.arange(0, local, 7, device=dev)
    ht.remove_to_tombstone(tables[0], slots,
                           torch.ones_like(slots, dtype=torch.bool))
    return tables, keys


@pytest.mark.parametrize("n_shards", [2, 8, 16])
def test_shard_gather_and_combine_match_plain(cuda_device, n_shards):
    """K30 (all of a device's shards in one launch, in chunks of 8) and K31
    against their plain versions on the same card tensors, byte for byte:
    owned, unowned, missing and zero keys, a lane mask, a count, and the
    overflow words with and without want_overflow."""
    from tigerbeetle_tpu_torch.parallel import mesh as tmesh
    from tigerbeetle_tpu_torch.parallel import sharded as tsh

    rng = np.random.default_rng(n_shards)
    local = 1 << 10
    tables, keys = _shard_tables(cuda_device, n_shards, local, rng)
    n = 8192
    q = np.concatenate([np.concatenate(list(keys.values())),
                        rng.integers(1, 1 << 62, n, dtype=np.uint64)])[:n]
    q[rng.integers(0, n, 200)] = 0
    rng.shuffle(q)
    lo = convert.array_to_tensor(q, cuda_device)
    hi = torch.zeros_like(lo)
    mask = torch.from_numpy(rng.random(n) < 0.9).to(cuda_device)
    names = ("val", "tag")
    for want_overflow in (False, True):
        for m, count in ((None, n), (mask, n - 100)):
            m_rows = (2 + len(names)) * n + 3
            got = torch.zeros(m_rows, dtype=torch.int64, device=cuda_device)
            want = torch.zeros_like(got)
            _cuda.shard_gather(tables, range(n_shards), n_shards, lo, hi,
                               names, 16, count, m, got, 1, m_rows - 1,
                               want_overflow)
            tsh.shard_gather_plain(tables, range(n_shards), n_shards, lo, hi,
                                   names, 16, count, m, want, 1, m_rows - 1,
                                   want_overflow)
            assert torch.equal(got, want), (want_overflow, count)
            assert bool(got[-1]) == want_overflow
            # A device a shard: each shard's own row (zeros where it does
            # not own the lane), as a mesh across cards has them; K31's sum
            # of those rows is the one row.
            per = torch.zeros(n_shards, m_rows, dtype=torch.int64,
                              device=cuda_device)
            for s in range(n_shards):
                _cuda.shard_gather([tables[s]], [s], n_shards, lo, hi, names,
                                   16, count, m, per[s], 1, m_rows - 1,
                                   want_overflow)
            assert bool(per[n_shards - 1, -1]) == want_overflow
            assert torch.equal(_cuda.shard_combine(per),
                               tmesh.shard_combine_plain(per.cpu()).to(
                                   cuda_device))
            # The overflow word of the sum counts the shards that overflowed;
            # the one row's ORs them (the rounds read both as != 0).
            comb = _cuda.shard_combine(per)
            assert torch.equal(comb[:-1], got[:-1])
            assert bool(comb[-1]) == bool(got[-1])


@pytest.mark.parametrize("want_overflow", [False, True])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("name", k30cases.CASES)
def test_shard_gather_k30_cases_match_plain(cuda_device, name, n_shards,
                                            want_overflow):
    """K30's one answer row a device group at its traps
    (testing/k30cases.py: owners on other devices, no local owner, a lane
    mask and a count, a full table's overflow), against the plain form on
    the CPU, byte for byte, from a row of garbage (only the overflow word
    zeroed)."""
    from tigerbeetle_tpu_torch.parallel import sharded as tsh

    c = k30cases.case(name, n_shards)
    gt, ct = (k30cases.to_tables(c, d) for d in (cuda_device, "cpu"))
    lo, hi = torch.from_numpy(c["lo"]), torch.from_numpy(c["hi"])
    mask = None if c["mask"] is None else torch.from_numpy(c["mask"])
    width = 4 * lo.numel()
    for shards in c["devices"]:
        got = torch.full((width + 1,), -5, dtype=torch.int64,
                         device=cuda_device)
        got[-1] = 0
        want = torch.zeros(width + 1, dtype=torch.int64)
        _cuda.shard_gather([gt[s] for s in shards], shards, n_shards,
                           lo.to(cuda_device), hi.to(cuda_device), ("v", "w"),
                           sm.MAX_PROBE, c["count"],
                           None if mask is None else mask.to(cuda_device),
                           got, 0, width, want_overflow)
        tsh.shard_gather_plain([ct[s] for s in shards], shards, n_shards, lo,
                               hi, ("v", "w"), sm.MAX_PROBE, c["count"], mask,
                               want, 0, width, want_overflow)
        assert torch.equal(got.cpu(), want), shards


def test_balance_and_legs_apply_slot_base_match_plain(cuda_device):
    """K4 and K10's apply launch in their slot-base forms: each shard's
    columns take exactly the legs of its global slot range, as the plain
    localized plan writes them."""
    from tigerbeetle_tpu_torch.ops import transfer_full as ttf
    from tigerbeetle_tpu_torch.parallel import sharded as tsh

    rng = np.random.default_rng(4)
    n_shards, local, n = 4, 1 << 8, 2048
    cap = n_shards * local
    dr = torch.from_numpy(rng.integers(0, cap, n)).to(cuda_device)
    cr = torch.from_numpy(rng.integers(0, cap, n)).to(cuda_device)
    ok = torch.from_numpy(rng.random(n) < 0.8).to(cuda_device)
    amt = torch.from_numpy(rng.integers(1, 1 << 40, n)).to(cuda_device)
    pend = torch.from_numpy(rng.random(n) < 0.3).to(cuda_device)
    cols = sm.BALANCE_COLS
    for s in range(n_shards):
        start = {c: torch.from_numpy(rng.integers(0, 1 << 60, local)).to(
            cuda_device) for c in cols}
        got = ht.Table(*(torch.zeros(local, dtype=torch.int64,
                                     device=cuda_device),) * 2,
                       torch.zeros(local, dtype=torch.bool,
                                   device=cuda_device),
                       {c: v.clone() for c, v in start.items()},
                       torch.zeros((), dtype=torch.int64, device=cuda_device),
                       torch.zeros((), dtype=torch.bool, device=cuda_device))
        want = table_to(got, "cpu")
        tsh.apply_balances_local(got, dr, cr, ok, amt, pend, s * local, cap)
        tsh.apply_balances_local(want, dr.cpu(), cr.cpu(), ok.cpu(),
                                 amt.cpu(), pend.cpu(), s * local, cap)
        tables_equal(table_to(got, "cpu"), want)
    # K10's apply: unique run-tail slots over the global range.
    s_slot = torch.from_numpy(rng.permutation(cap)[:n // 2]).to(cuda_device)
    scat = torch.from_numpy(rng.random(n // 2) < 0.7).to(cuda_device)
    incl = {c: torch.from_numpy(rng.integers(0, 1 << 62, n // 2)).to(
        cuda_device) for c in ttf._BAL_COLS}
    for gate in (0, 4):
        for s in range(n_shards):
            got = ht.make_table(local, {c: torch.int64 for c in cols},
                                cuda_device)
            want = table_to(got, "cpu")
            word = torch.full((1,), gate, dtype=torch.int32,
                              device=cuda_device)
            tsh._scatter_local(got, word, scat, s_slot, incl, s * local)
            tsh._scatter_local(want, torch.tensor(gate == 0), scat.cpu(),
                               s_slot.cpu(),
                               {c: v.cpu() for c, v in incl.items()},
                               s * local)
            tables_equal(table_to(got, "cpu"), want)


def _balance_inputs(rng, case, n, cap, dev):
    """K4's inputs: legs over ``cap`` slots, amounts below 2^64 (P3)."""
    dr = rng.integers(0, cap, n)
    cr = (dr + 1 + rng.integers(0, cap - 1, n)) % cap
    if case == "hot":  # every leg on one debit and one credit account
        dr[:], cr[:] = 7, 9
    amt = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    return [torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).to(dev)
            for a in (dr, cr, amt)] + [
        torch.from_numpy(rng.random(n) < 0.9).to(dev),
        torch.from_numpy(rng.random(n) < 0.3).to(dev)]


@pytest.mark.parametrize("case", ["carry", "hot"])
def test_balance_carries_and_hot_accounts_match_plain(cuda_device, case):
    """K4 (one launch of 64-bit atomics, wraps carried into the hi word,
    warp-aggregated on hot words) against the plain plan, byte for byte:
    balances a few units below 2^64 so most legs carry, and a batch whose
    legs all hit one debit and one credit account; the slot-base form over
    2, 4 and 8 shards on the same inputs."""
    from tigerbeetle_tpu_torch.parallel import sharded as tsh

    rng = np.random.default_rng(12)
    n, cap = 8190, 1 << 12
    dr, cr, amt, ok, pend = _balance_inputs(rng, case, n, cap, cuda_device)
    start = {}
    for c in sm.BALANCE_COLS:
        if c.endswith("_lo"):
            v = np.uint64((1 << 64) - 1) - rng.integers(0, 63, cap,
                                                        dtype=np.uint64)
        else:
            v = rng.integers(0, 1 << 40, cap, dtype=np.uint64)
        start[c] = torch.from_numpy(v.view(np.int64)).to(cuda_device)

    def table(local):
        z = torch.zeros(local, dtype=torch.int64, device=cuda_device)
        return ht.Table(z, z.clone(), torch.zeros(local, dtype=torch.bool,
                                                  device=cuda_device),
                        {}, torch.zeros((), dtype=torch.int64,
                                        device=cuda_device),
                        torch.zeros((), dtype=torch.bool, device=cuda_device))

    got = table(cap)
    got.cols.update({c: v.clone() for c, v in start.items()})
    want = table_to(got, "cpu")
    sm.apply_balances(got, dr, cr, ok, amt, pend)
    sm.apply_balances(want, dr.cpu(), cr.cpu(), ok.cpu(), amt.cpu(),
                      pend.cpu())
    tables_equal(table_to(got, "cpu"), want)
    carried = (got.cols["debits_posted_hi"] != start["debits_posted_hi"])
    assert int(carried.sum()) >= (1 if case == "hot" else 100)
    for n_shards in (2, 4, 8):
        local = cap // n_shards
        for s in range(n_shards):
            got = table(local)
            got.cols.update({c: v[s * local:(s + 1) * local].clone()
                             for c, v in start.items()})
            want = table_to(got, "cpu")
            tsh.apply_balances_local(got, dr, cr, ok, amt, pend, s * local,
                                     cap)
            tsh.apply_balances_local(want, dr.cpu(), cr.cpu(), ok.cpu(),
                                     amt.cpu(), pend.cpu(), s * local, cap)
            tables_equal(table_to(got, "cpu"), want)


def test_sharded_machine_on_card_matches_cpu(cuda_device):
    """A 4-shard machine on one card (``force_virtual(4, "cuda")``) and one
    on the CPU, through the same accounts, plain, pending and post batches,
    a split to 8 shards and the scrub lanes: equal results, canonical
    arrays and digests, with K30 launched and K31 not (on one card each
    gather round's answer is K30's one row: nothing is left to sum)."""
    from tigerbeetle_tpu_torch import device as tdev
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine
    from tigerbeetle_tpu_torch.vsr import checkpoint as tck

    rng = np.random.default_rng(9)
    cfg = LedgerConfig(accounts_capacity_log2=12, transfers_capacity_log2=14,
                       posted_capacity_log2=12)
    before = _cuda.counts()
    tdev.force_virtual(8, "cuda")
    tdev.force_virtual(8, "cpu")
    try:
        gpu = TorchStateMachine(cfg, batch_lanes=1024, shards=4)
        cpu = TorchStateMachine(cfg, batch_lanes=1024, device="cpu", shards=4)
        pend_ids = []
        accounts = _accounts(rng, 500, 1)
        assert gpu.create_accounts(accounts) == cpu.create_accounts(accounts)
        for b in range(6):
            batch = _transfers(np.random.default_rng(b), 1000,
                               10 ** 6 * (b + 1), 500, linked=0.0)
            if b % 3 == 1:
                batch["flags"] = types.TransferFlags.PENDING
                pend_ids = batch["id_lo"].copy()
            elif b % 3 == 2:
                batch["flags"] = types.TransferFlags.POST_PENDING_TRANSFER
                batch["pending_id_lo"] = pend_ids
                batch["amount_lo"] = 0
                for c in ("debit_account_id_lo", "credit_account_id_lo"):
                    batch[c] = 0
            assert gpu.create_transfers(batch) == cpu.create_transfers(batch)
        for m in (gpu, cpu):
            assert m.reshard_begin(8, chunk_rows=256)
            while m.reshard_active:
                m.reshard_step(16)
            assert m.shards == 8
        assert gpu.digest() == cpu.digest()
        a, b = (tck.ledger_to_arrays(m.checkpoint_ledger())
                for m in (gpu, cpu))
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for m in (gpu, cpu):
            m.scrub_interval = 1
            assert m.scrub_arm() and m.scrub_check()
    finally:
        tdev.force_virtual(0, "cuda")
        tdev.force_virtual(0, "cpu")
    after = _cuda.counts()
    for name in ("shard_gather", "balance", "full_legs"):
        assert after[name] > before[name], name
    assert after["shard_combine"] == before["shard_combine"]


def test_psum_across_cards_with_nccl(cuda_device):
    """A mesh over every card: the per-card K31 sums all-reduced with NCCL
    equal the plain sum of every shard's partial.  Needs two or more
    cards."""
    from tigerbeetle_tpu_torch.parallel import mesh as tmesh

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more CUDA devices: the NCCL route of psum "
                    "runs only across cards")
    devs = [torch.device("cuda", i) for i in range(cards)
            for _ in range(2)]
    n = 1 << (len(devs).bit_length() - 1)
    m = tmesh.Mesh(devs[:n])
    rng = np.random.default_rng(3)
    host = rng.integers(-(1 << 62), 1 << 62, (n, 4099))
    parts = [torch.from_numpy(host[list(shards)]).to(d)
             for d, shards in m.groups]
    want = torch.from_numpy(host).sum(0)
    for got in m.psum(parts):
        assert torch.equal(got.cpu(), want)


# -- K2's round form (more than 8,192 lanes) and K14's redesign ----------------


def _round_case(name, dev):
    arrays, lo, mask, max_probe, shift = k2cases.ROUND_CASES[name]()
    lo = convert.array_to_tensor(np.asarray(lo, np.uint64), dev)
    return (k2cases.table_from_arrays(arrays, dev), lo, torch.zeros_like(lo),
            torch.from_numpy(np.asarray(mask, bool)).to(dev), max_probe, shift)


@pytest.mark.parametrize("case", sorted(k2cases.ROUND_CASES))
def test_insert_round_cases_match_plain(cuda_device, case):
    """K2's round form on each of its traps (a cluster across the table's
    end into the tail, groups larger than a warp through the grid's
    rounds, max_probe in the rounds and in the tail, masked lanes): the
    insert entry against the plain insert and the round form's own plain
    version; the claim entry's slots, flag word and marks, a closed gate's
    revert and an open one against the plain claim and writes; the insert
    into a table none of whose arrays were written (``fill``: the claim
    reads none of it, every slot is written) against the plain form's
    fresh claim and fill."""
    t, lo, hi, mask, max_probe, shift = _round_case(case, cuda_device)
    n0 = _cuda.ROUND_FORM_CALLS
    claimed = _k2_insert_matches_plain(t, lo, hi, mask, max_probe, shift)
    cr, orr = ht.claim_rounds_plain(t, lo, hi, mask, max_probe, shift)
    assert torch.equal(claimed, cr)
    _k2_claim_matches_plain(t, lo, hi, mask, max_probe, shift)
    c = ledger_table_copy(t)
    ck, word = _cuda.claim(c.key_lo, c.key_hi, c.tombstone, lo, hi, mask,
                           max_probe, shift)
    assert torch.equal(ck, cr) and bool(word[0]) == bool(orr)
    rows = {"val": lo * 3, "tag": lo.to(torch.int32)}
    _cuda.write_claimed(c.key_lo, c.key_hi, c.tombstone, c.cols, c.count,
                        lo, hi, ck, mask, rows)
    d = ledger_table_copy(t)
    ht.write_rows_plain(d, lo, hi, cr, mask, rows)
    tables_equal(c, d)
    f = ht.make_table(t.capacity, COLS, cuda_device)
    for x in (f.key_lo, f.key_hi, *f.cols.values()):
        x.fill_(7)  # what unwritten arrays might hold
    f.tombstone.fill_(True)
    fk = _cuda.insert(f.key_lo, f.key_hi, f.tombstone, f.cols, f.count,
                      f.probe_overflow, lo, hi, mask, rows, max_probe, shift,
                      fill=True)
    fp = ht.make_table(t.capacity, COLS, cuda_device)
    fc, fo = ht.claim_rounds_plain(fp, lo, hi, mask, max_probe, shift,
                                   fresh=True)
    assert torch.equal(fk, fc)
    ht.write_rows_fill_plain(fp, lo, hi, fc, mask, rows)
    fp.probe_overflow |= fo
    tables_equal(f, fp)
    assert _cuda.ROUND_FORM_CALLS >= n0 + 4


def test_grow_and_drop_evicted_round_form_match_plain(cuda_device):
    """``grow`` of a table with tombstones (16,384 lanes) and the cold
    rebuild keeping none, some and all rows, on the card, against the
    plain insert and the plain rebuild."""
    from tigerbeetle_tpu_torch.ops import cold

    arrays = k2cases.grow_case()
    cap = len(arrays["key_lo"])
    t = k2cases.table_from_arrays(arrays, cuda_device)
    tp = k2cases.table_from_arrays(arrays, "cpu")
    grown = ht.grow(t, 2 * cap)
    want = ht.insert_plain(
        ht.make_table(2 * cap, {k: v.dtype for k, v in tp.cols.items()}, "cpu"),
        tp.key_lo, tp.key_hi, (tp.key_lo != 0) | (tp.key_hi != 0), tp.cols,
        2 * cap)[0]
    tables_equal(ledger_table_copy(grown, "cpu"), want)
    for keep in ("none", "some", "all"):
        arrays, thr, _k = k2cases.evict_case(keep)
        t = k2cases.table_from_arrays(arrays, cuda_device)
        tp = k2cases.table_from_arrays(arrays, "cpu")
        thr_t = torch.tensor(int(thr), dtype=torch.int64)
        got = cold.drop_evicted(t, thr_t.to(cuda_device))
        tables_equal(ledger_table_copy(got, "cpu"),
                     cold.drop_evicted_plain(tp, thr_t))


def test_insert_rounds_info_reads_the_launch(cuda_device):
    """The round form's cooperative launch: blocks resident on every SM,
    its tail limit."""
    info = _cuda.insert_rounds_info(1 << 24)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert info["blocks_per_sm"] >= 1, info
    assert info["blocks"] == info["blocks_per_sm"] * sms, info
    assert info["tail_max"] == _cuda.INSERT_TAIL_MAX


def _k14_level(block, dev):
    return ix.Level(convert.array_to_tensor(np.ascontiguousarray(block), dev))


@pytest.mark.parametrize("mode", k14cases.CARRY_MODES)
def test_run_merge_carries_match_plain(cuda_device, mode):
    """K14's carries into levels 1-6 (base 512, both sides a launch, each
    step's tiles cut by the warps' searches) against the plain
    concatenate-and-sort and K14's own plain form."""
    for k in range(1, 7):
        blocks = k14cases.carry(512, k, mode)
        cpu = [_k14_level(b, "cpu") for b in blocks]
        dev = [_k14_level(b, cuda_device) for b in blocks]
        flipped = [_k14_level(b, cuda_device) for b in k14cases.carry(
            512, k, mode, seed=1)]
        outs = [ix._sentinel_level(512 << k, cuda_device) for _ in range(2)]
        got = ix._merge_sides([dev, flipped], outs=outs)
        levels_equal(got[0], ix._merge_plain(cpu), f"carry into {k} {mode}")
        levels_equal(got[0], ix._merge_sides_split_plain([cpu])[0],
                     f"split carry into {k} {mode}")
        levels_equal(got[1], ix._merge_plain([ix.Level(b.block.cpu())
                                              for b in flipped]))


@pytest.mark.parametrize("case", k14cases.PAIR_CASES)
def test_run_merge_pairs_match_plain(cuda_device, case):
    """One K14 launch: A or B empty, equal keys across a tile's edge,
    sentinels beside live entries keyed by the sentinel key."""
    a, b = (_k14_level(x, "cpu") for x in k14cases.pair(case))
    out = [torch.empty(a.n + b.n, dtype=torch.int64, device=cuda_device)
           for _ in range(5)]
    _cuda.run_merge([[a[c].to(cuda_device) for c in ix.COLS]],
                    [[b[c].to(cuda_device) for c in ix.COLS]], [out])
    levels_equal(ix.Level(torch.stack(out)), ix._merge_plain([a, b]), case)


@pytest.mark.parametrize("mode", k14cases.BUILD_MODES)
@pytest.mark.parametrize("n", k14cases.BUILD_SIZES + (1 << 17,))
def test_run_merge_build_cases_match_plain(cuda_device, n, mode):
    """A full build on the card (K13's chunks, K14's rounds over the live
    prefixes, its tail; both sides a launch) against the plain lexsort and
    K14's own plain form (up to 2^14 entries), with the launches it takes:
    one a round and one for the tail."""
    cols, use = k14cases.entries(n, mode)
    cpu = [convert.array_to_tensor(c, "cpu") for c in cols]
    use_t = torch.from_numpy(use)
    want = ix._sort_level_plain(ix._masked(cpu, use_t, n))
    dev = [c.to(cuda_device) for c in cpu]
    before = _cuda.KERNELS["run_merge"].launches
    got = ix._sort_masked([dev, dev], use_t.to(cuda_device), n, fused=False)
    rounds = (n // 1024).bit_length() - 1
    assert _cuda.KERNELS["run_merge"].launches == before + rounds + 1
    for g in got:
        levels_equal(g, want, f"{mode} n={n}")
    if n <= 1 << 14:
        levels_equal(ix._sort_rounds_split_plain(cpu, use_t, n, fused=False),
                     want, f"split {mode} n={n}")


# -- K17 as a step of K1, K17's own launch, K16's one pass ------------------


def _lookups_equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.found.cpu(), w.found)
        assert torch.equal(g.slot.cpu(), w.slot)
        for name in w.cols:
            assert torch.equal(g.cols[name].cpu(), w.cols[name]), name


@pytest.mark.parametrize("name", k17cases.CASES)
def test_k1_flag_word_cases_match_plain(cuda_device, name):
    """K1's FLAGS launch on each K17 trap: the flag word, each lookup's
    found, slot and columns, byte for byte against the plain form on CPU
    copies; build_gather_ctx's probe_grow the same, with K17's step
    counted once and no launch of K17's own kernel."""
    c = k17cases.case(name)
    card = k17cases.inputs(c, cuda_device)
    cpu = k17cases.inputs(c, "cpu")
    tables_equal(table_to(card[0].transfers, "cpu"), cpu[0].transfers)
    looks = [tf.gather_lookups(a[0], a[1], a[2], a[3], True, a[6])
             for a in (card, cpu)]
    got, word = ht.lookup_flags(looks[0], tf.MAX_PROBE, card[4], card[5],
                                tf.FLAG_COLD)
    want, want_word = ht.lookup_flags_plain(looks[1], tf.MAX_PROBE, cpu[4],
                                            cpu[5], tf.FLAG_COLD)
    assert int(word) == int(want_word)
    assert bool(int(word) & tf.FLAG_COLD) == c["cold"]
    _lookups_equal(got, want)
    _cuda.reset_counts()
    ctx = tf.build_gather_ctx(*card[:6], has_postvoid=card[6])
    counts = _cuda.counts()
    assert int(ctx.probe_grow) == int(want_word)
    assert counts["probe"] == 1 and counts["bloom_check"] == 1
    assert _cuda.BLOOM_IN_PROBE == 1


def test_k1_flag_word_grow_bits_and_last_lane(cuda_device):
    """The word's grow bits against the plain form on K1's cut-short
    probes, and a cold hit on the last lane of the last block alone, at
    lane counts that leave a warp partly past the lanes."""
    for name in ("max_probe_1", "max_probe_2", "wrap"):
        t, lks, max_probe = k1cases.case(name)
        tables = [_k1_table(t, d) for d in (cuda_device, "cpu")]
        words = []
        for table, d in zip(tables, (cuda_device, "cpu")):
            specs = [ht.Lookup(table, convert.array_to_tensor(lk["key_lo"], d),
                               convert.array_to_tensor(lk["key_hi"], d), ("val",),
                               None if lk["mask"] is None
                               else torch.from_numpy(lk["mask"]).to(d),
                               lk["count"], lk["hash_shift"], grow_bit=1 << k)
                     for k, lk in enumerate(lks)]
            fn = ht.lookup_flags if d != "cpu" else ht.lookup_flags_plain
            words.append(int(fn(specs, max_probe)[1]))
        assert words[0] == words[1] and (words[0] or name == "wrap")
    for n in (1, 31, 33, 129, 8191):
        c = k17cases.case("checked_none")
        a = k17cases.inputs(c, cuda_device)
        lo = torch.full((n,), k17cases.NEW, dtype=torch.int64, device=cuda_device)
        lo += torch.arange(n, device=cuda_device)
        lo[n - 1] = k17cases.EVICTED + 1
        look = ht.Lookup(a[0].transfers, lo, torch.zeros_like(lo), ("amount_lo",),
                         cold=True)
        assert int(ht.lookup_flags([look], tf.MAX_PROBE, a[4], None, 16)[1]) == 16
        lo[n - 1] = k17cases.NEW + n
        assert int(ht.lookup_flags([look._replace(key_lo=lo)], tf.MAX_PROBE,
                                   a[4], None, 16)[1]) == 0


@pytest.mark.parametrize("name", k17cases.CASES)
def test_bloom_kernel_forms_on_k17_cases_match_plain(cuda_device, name):
    """K17's own launch, both forms, on the traps' ids and masks."""
    from tigerbeetle_tpu_torch.ops import cold

    c = k17cases.case(name)
    outs = []
    for dev in (cuda_device, "cpu"):
        ledger, soa, valid, postvoid, bloom, checked, _hp = k17cases.inputs(c, dev)
        looks = tf.gather_lookups(ledger, soa, valid, postvoid, True, True)
        got = ht.lookup_many(looks, tf.MAX_PROBE)
        f, pf = got[0].found, got[3].found
        hits = cold.bloom_check_impl(bloom, soa["pending_id_lo"], soa["pending_id_hi"])
        flag = cold.bloom_flag(bloom, soa["id_lo"], soa["id_hi"], valid, f,
                               soa["pending_id_lo"], soa["pending_id_hi"],
                               postvoid, pf, checked,
                               torch.zeros((), dtype=torch.int32, device=valid.device),
                               tf.FLAG_COLD)
        outs.append((hits.cpu(), int(flag)))
    assert torch.equal(outs[0][0], outs[1][0]) and outs[0][1] == outs[1][1]


def _history_ledger(log, dev):
    return sm.Ledger(accounts=None, transfers=None, posted=None,
                     history=sm.History(
                         cols={k: convert.array_to_tensor(v, dev)
                               for k, v in log["cols"].items()},
                         count=torch.tensor(int(log["count"]), device=dev)))


@pytest.mark.parametrize("name", k16cases.CASES)
def test_history_scan_cases_match_plain(cuda_device, name):
    """K16 on each trap, every output array (the invalid positions
    included) against the plain version and the split form at the
    launch's block count, one launch a query and no memset."""
    cap = 1000 if name == "odd_cap" else k16cases.CAP
    blocks = _cuda.history_scan_launch(cap, torch.cuda.current_device())[0]
    log, queries = k16cases.case(name, blocks)
    card, cpu = _history_ledger(log, cuda_device), _history_ledger(log, "cpu")
    for qy in queries:
        _cuda.reset_counts()
        g = q.scan_history(card, *qy)
        assert _cuda.counts()["history_scan"] == 1
        w = q.scan_history_plain(cpu, *qy)
        split = q.scan_history_split_plain(cpu, *qy, blocks=blocks)
        assert not split[2]
        for want in (w, split):
            assert torch.equal(g[0].cpu(), want[0]), qy
            for col in want[1]:
                assert torch.equal(g[1][col].cpu(), want[1][col]), (qy, col)


def test_history_scan_unordered_log_raises_on_both_routes(cuda_device):
    """A log whose timestamps below the count do not increase: K16's error
    word makes scan_history raise at once, and get_account_history raise
    from the rows' one read-back (it never calls scan_history); the
    deferred form hands the word back set."""
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine

    log, queries = k16cases.case(k16cases.UNORDERED)
    led = _history_ledger(log, cuda_device)
    with pytest.raises(RuntimeError, match="do not increase"):
        q.scan_history(led, *queries[0])
    assert int(q.scan_history_deferred(led, *queries[0])[2].item()) == 1
    m = TorchStateMachine(LedgerConfig(accounts_capacity_log2=8,
                                       transfers_capacity_log2=8,
                                       posted_capacity_log2=8),
                          batch_lanes=64, device=cuda_device)
    acc = np.zeros(40, dtype=types.ACCOUNT_DTYPE)
    acc["id_lo"] = np.arange(1, 41)
    acc["ledger"], acc["code"] = 1, 10
    acc["flags"] = int(types.AccountFlags.HISTORY)
    assert m.create_accounts(acc) == []
    m.ledger = dataclasses.replace(m.ledger, history=led.history)
    f = np.zeros(1, dtype=types.ACCOUNT_FILTER_DTYPE)[0]
    f["account_id_lo"], f["limit"], f["flags"] = k16cases.ACCT, 64, 3
    checked_at_once = q.scan_history
    q.scan_history = None  # the machine reads the word with its rows
    try:
        with pytest.raises(RuntimeError, match="do not increase"):
            m.get_account_history(f)
        ordered, _ = k16cases.case("sides")
        m.ledger = dataclasses.replace(
            m.ledger, history=_history_ledger(ordered, cuda_device).history)
        rows = m.get_account_history(f)
    finally:
        q.scan_history = checked_at_once
    assert len(rows) > 0
