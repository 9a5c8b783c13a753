"""The hand-written CUDA kernels K1-K8 against their plain PyTorch versions
on the card.  These tests need an NVIDIA GPU with nvcc and skip elsewhere;
this file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels.py

(``--noconftest`` because tests/conftest.py sets JAX up.)  The CPU tests
hold the plain versions against the JAX package; these close the chain."""

import numpy as np
import pytest
import torch

from tigerbeetle_tpu_torch import convert, types
from tigerbeetle_tpu_torch.ops import hash_table as ht
from tigerbeetle_tpu_torch.ops import scan_path as sp
from tigerbeetle_tpu_torch.ops import state_machine as sm
from tigerbeetle_tpu_torch.testing import seqmix
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
