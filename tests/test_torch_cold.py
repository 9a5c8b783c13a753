"""The port's cold tier against the JAX package's on the CPU, exactly
(integers and bytes, so the tolerance is zero): the Bloom filter, the
eviction cut, the extraction and the rebuild of ``ops.cold`` on the same
seeded tables; the ``ColdStore`` over two spill directories fed the same
runs (manifests, run files byte for byte, lookups, merges, the manifest
operations); the host helpers it copies (``utils/fs.py``,
``vsr/checksum.py``, ``native/aegis.cpp``); and a tiered
``TorchStateMachine`` beside a tiered ``TpuStateMachine`` and the scalar
oracle on the scenarios of tests/test_cold_tier.py, compared after every
batch: codes, balances, every hot table array, the spill's manifest and
files, the eviction count and the filter's size.  On the CPU the port runs
the plain versions of kernels K17-K19; the kernels are held against them on
the card (tests/test_torch_kernels.py and chip_smoke.py)."""

import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu import types
from tigerbeetle_tpu.config import LedgerConfig
from tigerbeetle_tpu.machine import TpuStateMachine
from tigerbeetle_tpu.ops import cold as jcold
from tigerbeetle_tpu.ops import hash_table as jht
from tigerbeetle_tpu.ops import state_machine as jsm
from tigerbeetle_tpu.testing import model as M
from tigerbeetle_tpu.vsr import checksum as jchecksum
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.machine import TorchStateMachine
from tigerbeetle_tpu_torch.ops import cold as tcold
from tigerbeetle_tpu_torch.ops import hash_table as tht
from tigerbeetle_tpu_torch.vsr import checksum as tchecksum

ROOT = Path(__file__).resolve().parents[1]
CFG = LedgerConfig(accounts_capacity_log2=8, transfers_capacity_log2=8,
                   posted_capacity_log2=8)
CPU = torch.device("cpu")
CAP = 1 << 8


def u64(rng, n, hi=1 << 64):
    return rng.integers(0, hi, size=n, dtype=np.uint64)


def t64(a):
    return convert.array_to_tensor(np.asarray(a, np.uint64), CPU)


# -- the Bloom filter -------------------------------------------------------------


@pytest.mark.parametrize("bits_log2", [10, 16, 20])
def test_bloom_check_and_add_match_jax(bits_log2):
    """bloom_add_host fills the same words; bloom_check_impl (K17's plain
    version) answers as the JAX function on ids that were added (no false
    negatives), ids that were not, and ids with nonzero high halves."""
    rng = np.random.default_rng(bits_log2)
    lo, hi = u64(rng, 700), np.where(rng.random(700) < 0.5, u64(rng, 700), 0)
    hi = hi.astype(np.uint64)
    jb = np.zeros((1 << bits_log2) // 32, np.uint32)
    tb = jb.copy()
    jcold.bloom_add_host(jb, lo[:300], hi[:300])
    tcold.bloom_add_host(tb, lo[:300], hi[:300])
    np.testing.assert_array_equal(tb, jb)
    want = np.asarray(jcold.bloom_check(jnp.asarray(jb), jnp.asarray(lo),
                                        jnp.asarray(hi)))
    got = tcold.bloom_check_impl(convert.bloom_to_tensor(tb, CPU), t64(lo),
                                 t64(hi)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:300].all()


def test_bloom_conversion_round_trip():
    words = np.random.default_rng(3).integers(0, 1 << 32, 64,
                                              dtype=np.uint64).astype(np.uint32)
    t = convert.bloom_to_tensor(words, CPU)
    assert t.dtype == torch.int32 and tcold.make_bloom(11, CPU).shape == t.shape
    np.testing.assert_array_equal(convert.bloom_to_numpy(t), words)
    with pytest.raises(TypeError):
        convert.bloom_to_tensor(words.astype(np.uint64), CPU)


# -- the eviction functions --------------------------------------------------------


def make_tables(seed, kind):
    """The same transfers table as a JAX Table and a port Table: ``kind``
    "tombstones" (half live, timestamps with repeats, some tombstones),
    "empty", "full" (every slot live), or "clamp" (count above the
    capacity, so k is clamped to C-1)."""
    rng = np.random.default_rng(seed)
    j = jsm.make_ledger(16, CAP, 16, 16).transfers
    a = {k: np.array(v) for k, v in convert.table_arrays(j).items() if k != "cols"}
    cols = {k: np.array(v) for k, v in j.cols.items()}
    n = {"tombstones": CAP // 2, "empty": 0, "full": CAP, "clamp": CAP // 2}[kind]
    slots = rng.choice(CAP, size=n, replace=False)
    a["key_lo"][slots] = rng.choice(np.arange(1, 1 << 20, dtype=np.uint64), n,
                                    replace=False)
    a["key_hi"][slots] = np.where(rng.random(n) < 0.3, 5, 0)
    for name, col in cols.items():
        col[slots] = rng.integers(0, 1 << 31, n).astype(col.dtype)
    cols["timestamp"][slots] = rng.integers(1, n // 3 + 2, n, dtype=np.uint64)
    a["count"] = np.uint64(n)
    if kind in ("tombstones", "clamp"):
        dead = slots[: n // 8]
        a["key_lo"][dead], a["key_hi"][dead], a["tombstone"][dead] = 0, 0, True
        a["count"] = np.uint64(n - len(dead))
    if kind == "clamp":
        a["count"] = np.uint64(4 * CAP)
    jt = jht.Table(key_lo=jnp.asarray(a["key_lo"]), key_hi=jnp.asarray(a["key_hi"]),
                   tombstone=jnp.asarray(a["tombstone"]),
                   cols={k: jnp.asarray(v) for k, v in cols.items()},
                   count=jnp.asarray(a["count"]),
                   probe_overflow=jnp.asarray(a["probe_overflow"]))
    tt = tht.Table(**{k: convert.array_to_tensor(v, CPU) for k, v in a.items()},
                   cols={k: convert.array_to_tensor(v, CPU) for k, v in cols.items()})
    return jt, tt


def assert_table_equal(jt, tt):
    want, got = convert.table_arrays(jt), convert.table_to_numpy(tt)
    for k in ("key_lo", "key_hi", "tombstone", "count", "probe_overflow"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in want["cols"]:
        np.testing.assert_array_equal(got["cols"][k], want["cols"][k], err_msg=k)


EVICT_CASES = [("tombstones", 1), ("tombstones", 250), ("tombstones", 500),
               ("tombstones", 999), ("empty", 500), ("full", 999),
               ("clamp", 999), ("clamp", 500)]


@pytest.mark.parametrize("kind,num", EVICT_CASES)
def test_eviction_functions_match_jax(kind, num):
    """eviction_threshold (K18's plain version), extract_evicted (K19's) at k
    = C and k = C/4 with its zero tail and keep mask, drop_evicted (every
    table array, count and probe_overflow) and rows_to_numpy equal the JAX
    functions on the same table."""
    jt, tt = make_tables(num, kind)
    jthr = jcold.eviction_threshold(jt, num, 1000)
    tthr = tcold.eviction_threshold(tt, num, 1000)
    assert int(convert.tensor_to_array(tthr)) == int(np.asarray(jthr))
    if kind == "empty":
        assert int(np.asarray(jthr)) == (1 << 64) - 1
    for k in (CAP, CAP // 4):
        jn, jlo, jhi, jcols = jcold.extract_evicted(jt, jthr, k)
        tn, tlo, thi, tcols, keep = tcold.extract_evicted(tt, tthr, k, keep=True)
        assert int(tn) == int(np.asarray(jn))
        np.testing.assert_array_equal(convert.tensor_to_array(tlo), np.asarray(jlo))
        np.testing.assert_array_equal(convert.tensor_to_array(thi), np.asarray(jhi))
        for name in jcols:
            np.testing.assert_array_equal(convert.tensor_to_array(tcols[name]),
                                          np.asarray(jcols[name]), err_msg=name)
        assert tcold.rows_to_numpy(tn, tlo, thi, tcols).tobytes() == \
            jcold.rows_to_numpy(jn, jlo, jhi, jcols).tobytes()
    assert_table_equal(jcold.drop_evicted(jt, jthr), tcold.drop_evicted(tt, tthr))
    assert_table_equal(jcold.drop_evicted(jt, jthr),
                       tcold.drop_evicted(tt, tthr, keep))


# -- the cold store ----------------------------------------------------------------


def random_rows(rng, n, ids):
    rows = np.zeros(n, dtype=types.TRANSFER_DTYPE)
    rows["id_lo"], rows["id_hi"] = ids
    for name in ("debit_account_id_lo", "credit_account_id_lo", "amount_lo",
                 "timestamp", "user_data_64"):
        rows[name] = u64(rng, n, 1 << 40)
    rows["ledger"], rows["code"] = 1, rng.integers(1, 100, n)
    return rows


def store_pair(tmp_path, name="s"):
    if tmp_path is None:
        return jcold.ColdStore(None), tcold.ColdStore(None)
    return (jcold.ColdStore(str(tmp_path / "jax" / name)),
            tcold.ColdStore(str(tmp_path / "port" / name)))


def assert_stores_equal(j, t):
    assert t.manifest() == j.manifest()
    assert t.count == j.count and t.next_seq == j.next_seq
    assert [os.path.basename(p) for p in t.garbage] == \
        [os.path.basename(p) for p in j.garbage]
    for pj, pt in zip(j.run_paths, t.run_paths):
        if pj:
            assert Path(pt).read_bytes() == Path(pj).read_bytes()
    for rj, rt in zip(j.runs, t.runs):
        assert np.asarray(rt).tobytes() == np.asarray(rj).tobytes()


def assert_lookups_equal(j, t, ids):
    want, got = j.lookup_many(ids), t.lookup_many(ids)
    assert got.keys() == want.keys()
    for key in want:
        assert np.asarray(got[key]).tobytes() == np.asarray(want[key]).tobytes()
    for lo, hi in ids[:20]:
        a, b = j.lookup(lo, hi), t.lookup(lo, hi)
        assert (a is None) == (b is None)
        if a is not None:
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    found, rows = t.lookup_rows(np.array([i[0] for i in ids], np.uint64),
                                np.array([i[1] for i in ids], np.uint64))
    np.testing.assert_array_equal(found, [i in want for i in ids])
    assert rows[found].tobytes() == b"".join(
        np.asarray(want[i]).tobytes() for i in ids if i in want)


@pytest.mark.parametrize("on_disk", [True, False])
def test_cold_store_runs_and_lookups_match_jax(tmp_path, on_disk):
    """Two stores fed the same runs, past MAX_RUNS (a merge): equal
    manifests, byte-identical files under identical names, equal garbage
    lists, and equal lookups for hits, misses, ids in several runs (the
    newest wins) and ids with high halves; equal rebuilt filters."""
    rng = np.random.default_rng(11)
    j, t = store_pair(tmp_path if on_disk else None)
    all_ids = []
    for r in range(jcold.ColdStore.MAX_RUNS + 3):
        n = int(rng.integers(1, 40))
        lo = rng.choice(np.arange(1, 5000, dtype=np.uint64), n, replace=False)
        hi = np.where(rng.random(n) < 0.2, rng.integers(1, 4, n), 0).astype(np.uint64)
        rows = random_rows(rng, n, (lo, hi))
        j.append_run(rows.copy())
        t.append_run(rows.copy())
        assert_stores_equal(j, t)
        all_ids += list(zip(lo.tolist(), hi.tolist()))
        probe = all_ids + [(int(x), 0) for x in rng.integers(1, 6000, 30)] + [(7, 9)]
        assert_lookups_equal(j, t, probe)
    assert len(j.runs) < jcold.ColdStore.MAX_RUNS + 3  # a merge happened
    np.testing.assert_array_equal(t.rebuild_bloom(14), j.rebuild_bloom(14))
    assert t.lookup_many([]) == {} and t.lookup(0, 0) is None


def test_cold_store_manifest_operations_match_jax(tmp_path):
    """verify_manifest (missing, corrupt and unsafe entries),
    locate_by_checksum (live runs, merged-away files, unknown), install_file
    (an unsafe name and a bad checksum refused), load_manifest (a reload,
    and a corrupt file refused) and gc give the JAX store's answers."""
    rng = np.random.default_rng(12)
    j, t = store_pair(tmp_path)
    for r in range(jcold.ColdStore.MAX_RUNS + 1):
        ids = (np.arange(1, 6, dtype=np.uint64) + 10 * r, np.zeros(5, np.uint64))
        rows = random_rows(rng, 5, ids)
        j.append_run(rows.copy())
        t.append_run(rows.copy())
    for r in range(2):
        rows = random_rows(rng, 3, (np.arange(500, 503, dtype=np.uint64) + 7 * r,
                                    np.zeros(3, np.uint64)))
        j.append_run(rows.copy())
        t.append_run(rows.copy())
    man = t.manifest()
    assert man == j.manifest() and t.verify_manifest(man) == j.verify_manifest(man) == []
    # locate: a live run, a merged-away run still on disk, an unknown sum.
    garbage = [jchecksum.checksum(Path(p).read_bytes()) for p in j.garbage[:1]]
    for c in [int(man[0]["checksum"], 16), int(man[-1]["checksum"], 16)] + garbage + [123]:
        a, b = j.locate_by_checksum(c), t.locate_by_checksum(c)
        assert (a is None) == (b is None)
        if a is not None:
            assert os.path.basename(a) == os.path.basename(b)
    # A fresh pair of stores: verify a manifest naming files not yet there,
    # install them (refusing bad names and sums), then load.
    j2, t2 = store_pair(tmp_path, "fetched")
    assert t2.verify_manifest(man) == j2.verify_manifest(man) != []
    for entry in man:
        blob = Path(j.directory, entry["path"]).read_bytes()
        c = int(entry["checksum"], 16)
        for s in (j2, t2):
            assert not s.install_file("../" + entry["path"], c, blob)
            assert not s.install_file(entry["path"], c ^ 1, blob)
            assert s.install_file(entry["path"], c, blob)
    assert t2.verify_manifest(man) == j2.verify_manifest(man) == []
    j2.load_manifest(man)
    t2.load_manifest(man)
    assert_stores_equal(j2, t2)
    assert_lookups_equal(j2, t2, [(i, 0) for i in range(0, 520)])
    bad = [dict(man[0], path="../evil")]
    for s in (j2, t2):
        with pytest.raises(ValueError):
            s.verify_manifest(bad)
    # Corrupt one file: both report it, and both refuse to load it.
    victim = man[0]["path"]
    for s in (j2, t2):
        p = Path(s.directory, victim)
        p.write_bytes(p.read_bytes()[:-1] + b"\x01")
        s._path_checksums.clear()
    assert t2.verify_manifest(man) == j2.verify_manifest(man) != []
    for s in (j2, t2):
        with pytest.raises(RuntimeError, match="corrupt"):
            s.load_manifest(man)
    # gc deletes exactly the merged-away files.
    assert j.garbage and len(t.garbage) == len(j.garbage)
    j.gc()
    t.gc()
    assert sorted(os.listdir(t.directory)) == sorted(os.listdir(j.directory))
    assert t.garbage == j.garbage == []


def test_run_names_never_reused(tmp_path):
    """Run file sequence numbers are monotonic across merges and reloads
    (the port of tests/test_cold_tier.py's case)."""
    store = tcold.ColdStore(str(tmp_path / "c"))
    rows = types.transfers_array([
        types.transfer(id=i + 1, debit_account_id=1, credit_account_id=2,
                       amount=1, ledger=1, code=10)
        for i in range(4)
    ])
    seen = set()
    for k in range(store.MAX_RUNS * 3):
        rows["id_lo"] = np.arange(4, dtype=np.uint64) + 1 + 10 * k
        store.append_run(rows.copy())
        seen.update(store.run_paths)
        seen.update(store.garbage)
    assert len(seen) == store.next_seq
    assert not (set(store.run_paths) & set(store.garbage))
    assert tcold.ColdStore(str(tmp_path / "c")).next_seq == store.next_seq


# -- the host helpers it copies ---------------------------------------------------------


def test_checksum_matches_jax():
    """AEGIS-128L: the port's native build and its pure-Python version
    equal the JAX package's on the reference's empty-input vector and on
    inputs around the 32-byte block."""
    assert tchecksum.checksum(b"") == 0x49F174618255402DE6E7E3C40D60CC83
    assert tchecksum.checksum_empty() == jchecksum.checksum_empty()
    rng = np.random.default_rng(13)
    for n in (1, 15, 16, 31, 32, 33, 64, 1000, 4097):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        want = jchecksum.checksum(data)
        assert tchecksum.checksum(data) == want == tchecksum.checksum_py(data)


def test_aegis_copy_equals_its_source():
    assert (ROOT / "tigerbeetle_tpu_torch/native/aegis.cpp").read_bytes() == \
        (ROOT / "tigerbeetle_tpu/native/aegis.cpp").read_bytes()


@pytest.mark.parametrize("route", ["bloom_check", "evict_threshold",
                                   "evict_extract"])
def test_cold_wrappers_never_fall_back_for_cuda_tensors(monkeypatch, route):
    """K17-K19: a CUDA tensor goes to the kernel wrapper, never to the
    plain version."""
    from tigerbeetle_tpu_torch.ops import _cuda

    class Routed(Exception):
        pass

    def kernel(*args, **kwargs):
        raise Routed

    monkeypatch.setattr(_cuda, route, kernel)
    for plain in ("bloom_check_plain", "eviction_threshold_plain",
                  "extract_evicted_plain", "keep_mask_plain",
                  "drop_evicted_plain"):
        monkeypatch.setattr(tcold, plain, lambda *a: pytest.fail("plain"))

    class FakeCuda:
        is_cuda = True
        shape = (4,)

        def reshape(self, *shape):
            return self

    table = tht.make_table(16, {"timestamp": torch.int64}, "cpu")
    table.key_lo = FakeCuda()
    with pytest.raises(Routed):
        if route == "bloom_check":
            tcold.bloom_check_impl(FakeCuda(), FakeCuda(), FakeCuda())
        elif route == "evict_threshold":
            tcold.eviction_threshold(table, 1, 2)
        else:
            tcold.extract_evicted(table, FakeCuda(), 4)


# -- the tiered machine -----------------------------------------------------------------


class Trio:
    """A tiered TorchStateMachine, a tiered TpuStateMachine and the scalar
    oracle, fed the same batches and compared after each."""

    def __init__(self, tmp_path, spill=True, hot_max=256, **kw):
        self.dirs = ((tmp_path / "port", tmp_path / "jax") if spill
                     else (None, None))
        self.t = TorchStateMachine(
            CFG, batch_lanes=64, device="cpu", hot_transfers_capacity_max=hot_max,
            spill_dir=None if not spill else str(self.dirs[0]), **kw)
        self.j = TpuStateMachine(
            CFG, batch_lanes=64, hot_transfers_capacity_max=hot_max,
            spill_dir=None if not spill else str(self.dirs[1]), **kw)
        self.ref = M.ReferenceStateMachine()
        acc = types.accounts_array(
            [types.account(id=i + 1, ledger=1, code=10) for i in range(8)])
        assert self.t.create_accounts(acc, 1) == self.j.create_accounts(acc, 1) \
            == self.ref.create_accounts(M.accounts_from_batch(acc), 1) == []

    def run(self, specs, oracle=True):
        batch = types.transfers_array([types.transfer(**s) for s in specs])
        got = self.t.create_transfers(batch)
        want = self.j.create_transfers(batch)
        assert got == want
        if oracle:
            assert got == self.ref.create_transfers(M.transfers_from_batch(batch))
            assert self.t.balances_snapshot() == self.ref.balances_snapshot()
        self.check()
        return got

    def check(self):
        t, j = self.t, self.j
        assert t.balances_snapshot() == j.balances_snapshot()
        want = convert.ledger_arrays(j.ledger)
        got = convert.ledger_to_numpy(t.ledger)
        for name in ("accounts", "transfers", "posted"):
            for k in ("key_lo", "key_hi", "tombstone", "count", "probe_overflow"):
                np.testing.assert_array_equal(got[name][k], want[name][k],
                                              err_msg=f"{name}/{k}")
            for k in want[name]["cols"]:
                np.testing.assert_array_equal(got[name]["cols"][k],
                                              want[name]["cols"][k],
                                              err_msg=f"{name}/{k}")
        assert t.cold.manifest() == j.cold.manifest()
        assert (t._evictions, t._bloom_log2, t._transfers_bound) == (
            j._evictions, j._bloom_log2, j._transfers_bound)
        if j._bloom_dev is None:
            assert t._bloom_dev is None
        else:
            np.testing.assert_array_equal(convert.bloom_to_numpy(t._bloom_dev),
                                          np.asarray(j._bloom_dev))
        for entry in j.cold.manifest():
            if self.dirs[0] is not None:
                assert (self.dirs[0] / entry["path"]).read_bytes() == \
                    (self.dirs[1] / entry["path"]).read_bytes()

    def fill(self, n, start, batch=50):
        tid = start
        while tid < start + n:
            m = min(batch, start + n - tid)
            self.run([dict(id=tid + i, debit_account_id=1 + (tid + i) % 8,
                           credit_account_id=1 + (tid + i + 3) % 8,
                           amount=1 + i, ledger=1, code=10) for i in range(m)])
            tid += m
        return tid

    def resubmit(self, ident, amount_delta=0):
        orig = self.ref.transfers[ident]
        return dict(id=ident, debit_account_id=orig.debit_account_id,
                    credit_account_id=orig.credit_account_id,
                    amount=orig.amount + amount_delta, ledger=1, code=10)


def test_spill_and_cold_duplicates(tmp_path):
    """Filling past the hot ceiling evicts; a duplicate of a cold id gets
    the exact exists codes (46, and 39 with another amount) after FLAG_COLD
    and a rehydration."""
    p = Trio(tmp_path)
    p.fill(400, 1000)
    assert p.t.cold.count > 0 and p.t._evictions > 0
    cold_ids = [int(r["id_lo"]) for r in np.asarray(p.t.cold.runs[0][:3])]
    for ident in cold_ids:
        assert p.run([p.resubmit(ident)]) == [(0, 46)]
        assert p.run([p.resubmit(ident, 1)]) == [(0, 39)]
    assert p.t.cold_retries >= 1 and p.t.rehydrated_rows == len(cold_ids)


def test_cold_pending_posted_and_queries_across_tiers(tmp_path):
    """A pending created early is evicted; posting it rehydrates it and
    succeeds exactly; lookup_transfers, get_account_transfers and a
    composed scan across the hot/cold boundary equal the JAX machine's and
    the oracle's."""
    p = Trio(tmp_path)
    p.run([dict(id=500, debit_account_id=1, credit_account_id=2, amount=77,
                ledger=1, code=10, flags=types.TransferFlags.PENDING)])
    end = p.fill(400, 10_000)
    assert p.t.cold.lookup(500, 0) is not None
    p.run([dict(id=501, pending_id=500, ledger=1, code=10,
                flags=types.TransferFlags.POST_PENDING_TRANSFER)])
    sample = [10_000, 10_001, end - 1, 999_999, 500, 501]
    got = p.t.lookup_transfers(sample)
    assert got.tobytes() == p.j.lookup_transfers(sample).tobytes()
    assert [M.transfer_from_row(r) for r in got] == p.ref.lookup_transfers(sample)
    f = np.zeros(1, dtype=types.ACCOUNT_FILTER_DTYPE)[0]
    f["account_id_lo"], f["limit"] = 1, 8000
    for flags in (1, 3, 7):
        f["flags"] = flags
        rows = p.t.get_account_transfers(f)
        assert rows.tobytes() == p.j.get_account_transfers(f).tobytes()
        assert [int(r["id_lo"]) for r in rows] == [
            t.id for t in p.ref.get_account_transfers(1, 0, 0, 8000, flags)]
    got = p.t.query_transfers_where(debit_account_id=2)
    assert got.tobytes() == p.j.query_transfers_where(debit_account_id=2).tobytes()
    assert len(got) > 0 and int(got[0]["timestamp"]) < int(
        p.t.lookup_transfers([end - 1])[0]["timestamp"])


def test_deterministic_reservation_equals_jax(tmp_path):
    """Two port machines and the JAX machine with the identical history
    write identical spills, name for name and byte for byte (the port's
    case of tests/test_cold_tier.py::TestDeterministicReservation)."""
    p = Trio(tmp_path / "a")
    q = TorchStateMachine(CFG, batch_lanes=64, device="cpu",
                          spill_dir=str(tmp_path / "b"),
                          hot_transfers_capacity_max=256)
    acc = types.accounts_array(
        [types.account(id=i + 1, ledger=1, code=10) for i in range(8)])
    assert q.create_accounts(acc, 1) == []
    for tid in range(1000, 1500, 50):
        specs = [dict(id=tid + i, debit_account_id=1 + (tid + i) % 8,
                      credit_account_id=1 + (tid + i + 3) % 8,
                      amount=1 + i % 9, ledger=1, code=10) for i in range(50)]
        assert p.run(specs, oracle=False) == []
        assert q.create_transfers(
            types.transfers_array([types.transfer(**s) for s in specs])) == []
    man = p.j.cold.manifest()
    assert man and q.cold.manifest() == man
    for entry in man:
        assert (tmp_path / "b" / entry["path"]).read_bytes() == \
            (tmp_path / "a" / "jax" / entry["path"]).read_bytes()


def test_in_memory_spill_and_direct_eviction(tmp_path):
    """spill_dir None keeps the runs in memory, as the JAX machine does; an
    untiered machine's direct evict_cold(frac) turns tiering on, and a
    duplicate of an evicted id is then caught through FLAG_COLD."""
    p = Trio(tmp_path, spill=False)
    p.fill(300, 2000)
    assert p.t.cold.count > 0 and p.t.cold.run_paths[0] == ""
    q = Trio(tmp_path / "direct", spill=False, hot_max=None)
    q.fill(100, 3000)
    assert q.t.evict_cold(0.3) == q.j.evict_cold(0.3) > 0
    q.check()
    assert q.t._tiering and q.j._tiering
    ident = int(q.t.cold.runs[0][0]["id_lo"])
    assert q.run([q.resubmit(ident)]) == [(0, 46)]
    assert q.t.evict_cold(0.5) == q.j.evict_cold(0.5)
    q.check()


def test_sequential_at_the_ceiling_reproduces_the_reference(tmp_path):
    """A force_sequential tiered machine at the hot ceiling, fed a batch
    whose first lane duplicates a cold id: _sequential_impl rehydrates the
    row, then its growth check evicts at the ceiling, spilling the oldest
    rows, the rehydrated one among them, so the scan path does not see it
    and accepts the duplicate as new.  The JAX machine splits from the
    scalar oracle there (code 0 where the oracle says 46; ROADMAP C records
    it as a known state of the reference), and the port reproduces the JAX
    machine exactly."""
    p = Trio(tmp_path, force_sequential=True)
    p.fill(400, 1000)
    ident = int(p.t.cold.runs[0][1]["id_lo"])
    specs = [p.resubmit(ident)] + [
        dict(id=5000 + i, debit_account_id=1 + i % 8,
             credit_account_id=1 + (i + 3) % 8, amount=1 + i, ledger=1, code=10)
        for i in range(49)]
    batch = types.transfers_array([types.transfer(**s) for s in specs])
    want = p.ref.create_transfers(M.transfers_from_batch(batch))
    ev0 = p.j._evictions
    got = p.run(specs, oracle=False)
    assert p.j._evictions == ev0 + 1
    assert want == [(0, 46)] and got == []  # the reference's split
