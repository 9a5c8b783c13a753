"""The port's persistence (``vsr/checkpoint.py``, ``lsm/forest.py``,
``utils/ewah.py`` and the machine's ``checkpoint_ledger``, ``host_state`` and
``restore_host_state``) against the JAX package's on the CPU, exactly:

- a checkpoint written by the JAX package loads into the port and one
  written by the port loads into the JAX package: the blobs are equal byte
  for byte, and so are the digests and every array;
- tests/test_lsm.py's forest and EWAH cases on the port's copies, with the
  port's ledgers, and the forest's files equal to the JAX package's;
- a restart across a tiered checkpoint (tests/test_cold_tier.py:183-247),
  port machine beside JAX machine and the scalar oracle;
- ``host_state`` and a restore equal to the JAX machine's."""

import copy
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_fault_domain import assert_ledgers_equal, jax_ledger

import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu import types
from tigerbeetle_tpu.config import LEDGER_TEST, LedgerConfig
from tigerbeetle_tpu.lsm import Forest as JForest
from tigerbeetle_tpu.machine import TpuStateMachine
from tigerbeetle_tpu.testing import model as M
from tigerbeetle_tpu.utils import ewah as jewah
from tigerbeetle_tpu.vsr import checkpoint as jcheckpoint
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.lsm import Forest
from tigerbeetle_tpu_torch.machine import TorchStateMachine
from tigerbeetle_tpu_torch.utils import ewah
from tigerbeetle_tpu_torch.vsr import checkpoint

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TF = types.TransferFlags


def _accounts(first, n, flags=0):
    return types.accounts_array([
        types.account(id=first + i, ledger=1, code=10, flags=flags)
        for i in range(n)
    ])


def _transfers(first, n, n_accounts=8, flags=0):
    return types.transfers_array([
        types.transfer(id=first + i, debit_account_id=1 + i % n_accounts,
                       credit_account_id=1 + (i + 1) % n_accounts,
                       amount=1 + i, ledger=1, code=10, flags=flags)
        for i in range(n)
    ])


def twins(cfg=LEDGER_TEST, lanes=64):
    """A port and a JAX machine with the same accounts, pendings, posts and
    history rows (every table populated)."""
    t = TorchStateMachine(cfg, batch_lanes=lanes, device="cpu")
    j = TpuStateMachine(cfg, batch_lanes=lanes)
    for m in (t, j):
        assert m.create_accounts(_accounts(1, 6), wall_clock_ns=1) == []
        assert m.create_accounts(
            _accounts(7, 2, types.AccountFlags.HISTORY)) == []
        assert m.create_transfers(_transfers(100, 20, flags=TF.PENDING)) == []
        posts = types.transfers_array([
            types.transfer(id=200 + i, pending_id=100 + i, ledger=1, code=10,
                           flags=TF.POST_PENDING_TRANSFER)
            for i in range(5)])
        assert m.create_transfers(posts) == []
    return t, j


def _blob(ledger_to_arrays, ledger, meta):
    arrays = dict(ledger_to_arrays(ledger))
    arrays["meta"] = np.frombuffer(__import__("json").dumps(meta).encode(),
                                   dtype=np.uint8).copy()
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


# -- checkpoints across the two packages --------------------------------------------


def test_ledger_to_arrays_equals_the_jax_packages():
    t, j = twins()
    got, want = checkpoint.ledger_to_arrays(t.ledger), \
        jcheckpoint.ledger_to_arrays(j.ledger)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["history/count"]) > 0 and int(got["posted/count"]) > 0


@pytest.mark.parametrize("sparse", [False, True])
def test_jax_checkpoint_loads_into_the_port(tmp_path, sparse):
    t, j = twins()
    meta = {"host_state": j.host_state()}
    if sparse:
        path = str(tmp_path / "j")
        _p, cs = jcheckpoint.save_arrays(
            path, 3, jcheckpoint.sparsify_arrays(
                jcheckpoint.ledger_to_arrays(j.ledger)), meta)
    else:
        path = str(tmp_path / "j")
        _p, cs = jcheckpoint.save(path, 3, j.ledger, meta)
    ledger, got_meta = checkpoint.load(path, 3, cs, device=CPU)
    assert got_meta == meta
    fresh = TorchStateMachine(LEDGER_TEST, batch_lanes=64, device="cpu")
    fresh.ledger = ledger
    fresh.restore_host_state(got_meta["host_state"])
    assert fresh.digest() == j.digest()
    assert_ledgers_equal(convert.ledger_to_numpy(fresh.ledger),
                         convert.ledger_arrays(j.ledger))
    assert fresh.host_state() == j.host_state()
    # The restored port machine commits the next batch as the JAX one.
    b = _transfers(500, 12)
    assert fresh.create_transfers(b) == j.create_transfers(b)
    assert fresh.digest() == j.digest()


def test_port_checkpoint_loads_into_the_jax_package(tmp_path):
    t, j = twins()
    meta = {"host_state": t.host_state()}
    path = str(tmp_path / "t")
    _p, cs = checkpoint.save(path, 4, t.checkpoint_ledger(), meta)
    ledger, got_meta = jcheckpoint.load(path, 4, cs)
    fresh = TpuStateMachine(LEDGER_TEST, batch_lanes=64)
    fresh.ledger = ledger
    fresh.restore_host_state(got_meta["host_state"])
    assert fresh.digest() == t.digest()
    assert_ledgers_equal(convert.ledger_to_numpy(t.ledger),
                         convert.ledger_arrays(fresh.ledger))
    assert fresh.host_state() == t.host_state()


def test_blobs_equal_byte_for_byte(tmp_path):
    """The same ledger saved by either package gives the same file, and the
    same file checksum."""
    t, j = twins()
    meta = {"op": 9}
    tp, tcs = checkpoint.save(str(tmp_path / "a"), 9, t.ledger, meta)
    jp, jcs = jcheckpoint.save(str(tmp_path / "b"), 9, j.ledger, meta)
    assert Path(tp).read_bytes() == Path(jp).read_bytes()
    assert tcs == jcs
    assert _blob(checkpoint.ledger_to_arrays, t.ledger, meta) == \
        _blob(jcheckpoint.ledger_to_arrays, j.ledger, meta)


def test_checksum_mismatch_is_refused(tmp_path):
    t, _j = twins()
    path = str(tmp_path / "x")
    _p, cs = checkpoint.save(path, 1, t.ledger)
    with pytest.raises(RuntimeError, match="checksum mismatch"):
        checkpoint.load(path, 1, cs ^ 1, device=CPU)


def test_sparse_arrays_round_trip():
    t, _j = twins()
    arrays = checkpoint.ledger_to_arrays(t.ledger)
    sp = checkpoint.sparsify_arrays(arrays)
    jsp = jcheckpoint.sparsify_arrays(jcheckpoint.ledger_to_arrays(
        checkpoint.arrays_to_ledger(arrays, CPU)))
    assert sorted(sp) == sorted(jsp)
    back = checkpoint.densify_arrays(sp)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)


# -- tests/test_lsm.py on the port's copies -------------------------------------------


def test_ewah_roundtrips_and_rejects_malformed():
    rng = np.random.default_rng(7)
    for value in (0, 0xFFFF_FFFF_FFFF_FFFF):
        w = np.full(300, value, dtype=np.uint64)
        enc = ewah.encode(w)
        assert len(enc) < 10
        assert np.array_equal(ewah.decode(enc, 300), w)
    for _ in range(50):
        n = int(rng.integers(0, 400))
        w = rng.integers(0, 1 << 63, size=n).astype(np.uint64)
        enc = ewah.encode(w)
        assert np.array_equal(enc, jewah.encode(w))
        assert np.array_equal(ewah.decode(enc, n), w)
    for n in (0, 1, 63, 64, 65, 1000):
        bits = rng.random(n) < 0.1
        enc, cnt = ewah.encode_bits(bits)
        assert cnt == n and np.array_equal(ewah.decode_bits(enc, cnt), bits)
    enc = ewah.encode(np.full(64, 5, dtype=np.uint64))
    with pytest.raises(ValueError):
        ewah.decode(enc, 32)
    with pytest.raises(ValueError):
        ewah.decode(enc[:-1], 64)


def _machine():
    return TorchStateMachine(LEDGER_TEST, batch_lanes=64, device="cpu")


def _digest(ledger):
    m = _machine()
    m.ledger = ledger
    return m.digest()


def test_forest_base_then_delta_runs(tmp_path):
    path = str(tmp_path / "x.data")
    m = _machine()
    assert m.create_accounts(_accounts(1, 8), wall_clock_ns=1) == []
    forest = Forest(path, major_ratio=100.0)
    base_cs, _man = forest.checkpoint(m.ledger, {"k": 1}, op=1)
    assert forest.manifest.runs == []
    assert m.create_transfers(_transfers(100, 16)) == []
    base_cs2, man_cs2 = forest.checkpoint(m.ledger, {"k": 2}, op=2)
    assert base_cs2 == base_cs
    assert len(forest.manifest.runs) == 1
    ledger2, meta2 = Forest(path).open(2, man_cs2, device=CPU)
    assert meta2 == {"k": 2}
    assert _digest(ledger2) == m.digest()


def test_forest_compaction(tmp_path):
    path = str(tmp_path / "x.data")
    m = _machine()
    assert m.create_accounts(_accounts(1, 8), wall_clock_ns=1) == []
    forest = Forest(path, compact_runs_max=3, major_ratio=100.0)
    op = 1
    forest.checkpoint(m.ledger, {}, op=op)
    for batch in range(6):
        assert m.create_transfers(_transfers(1000 + 50 * batch, 8)) == []
        op += 1
        _, man_cs = forest.checkpoint(m.ledger, {"batch": batch}, op=op)
    assert len(forest.manifest.runs) <= 4
    ledger2, meta2 = Forest(path).open(op, man_cs, device=CPU)
    assert _digest(ledger2) == m.digest()
    assert meta2 == {"batch": 5}


def test_forest_major_compaction_rewrites_base(tmp_path):
    path = str(tmp_path / "x.data")
    m = _machine()
    assert m.create_accounts(_accounts(1, 8), wall_clock_ns=1) == []
    forest = Forest(path, major_ratio=0.0)
    base1, _ = forest.checkpoint(m.ledger, {}, op=1)
    assert m.create_transfers(_transfers(100, 8)) == []
    base2, man2 = forest.checkpoint(m.ledger, {}, op=2)
    assert base2 != base1
    assert forest.manifest.runs == []
    ledger2, _ = Forest(path).open(2, man2, device=CPU)
    assert _digest(ledger2) == m.digest()


def test_forest_gc_removes_stale_files(tmp_path):
    path = str(tmp_path / "x.data")
    m = _machine()
    assert m.create_accounts(_accounts(1, 8), wall_clock_ns=1) == []
    forest = Forest(path, compact_runs_max=2, major_ratio=100.0)
    op = 1
    forest.checkpoint(m.ledger, {}, op=op)
    for batch in range(5):
        assert m.create_transfers(_transfers(2000 + 40 * batch, 6)) == []
        op += 1
        forest.checkpoint(m.ledger, {}, op=op)
        forest.gc()
    names = sorted(p.name for p in tmp_path.iterdir())
    live = {f"x.data.run.{r.seq}" for r in forest.manifest.runs}
    live.add(f"x.data.checkpoint.{forest.manifest.base_op}")
    live.add(f"x.data.manifest.{op}")
    assert set(names) == live, names


def test_forest_detects_corrupt_run(tmp_path):
    path = str(tmp_path / "x.data")
    m = _machine()
    assert m.create_accounts(_accounts(1, 8), wall_clock_ns=1) == []
    forest = Forest(path, major_ratio=100.0)
    forest.checkpoint(m.ledger, {}, op=1)
    assert m.create_transfers(_transfers(100, 8)) == []
    _, man_cs = forest.checkpoint(m.ledger, {}, op=2)
    run_file = tmp_path / f"x.data.run.{forest.manifest.runs[0].seq}"
    blob = bytearray(run_file.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    run_file.write_bytes(bytes(blob))
    with pytest.raises(RuntimeError, match="checksum"):
        Forest(path).open(2, man_cs, device=CPU)


def test_forest_files_equal_the_jax_packages(tmp_path):
    """The same stream checkpointed by both packages' forests: every base,
    run and manifest file equal byte for byte, and each package opens the
    other's."""
    t, j = _machine(), TpuStateMachine(LEDGER_TEST, batch_lanes=64)
    tf_, jf = Forest(str(tmp_path / "t" / "x.data"), compact_runs_max=2,
                     major_ratio=100.0), \
        JForest(str(tmp_path / "j" / "x.data"), compact_runs_max=2,
                major_ratio=100.0)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    for m in (t, j):
        assert m.create_accounts(_accounts(1, 8), wall_clock_ns=1) == []
    op = 1
    tf_.checkpoint(t.ledger, {"op": op}, op=op)
    jf.checkpoint(j.ledger, {"op": op}, op=op)
    for batch in range(4):
        for m in (t, j):
            assert m.create_transfers(_transfers(300 + 30 * batch, 9)) == []
        op += 1
        _, tman = tf_.checkpoint(t.ledger, {"op": op}, op=op)
        _, jman = jf.checkpoint(j.ledger, {"op": op}, op=op)
        assert tman == jman
    tfiles = {p.name: p.read_bytes() for p in (tmp_path / "t").iterdir()}
    jfiles = {p.name: p.read_bytes() for p in (tmp_path / "j").iterdir()}
    assert tfiles == jfiles
    jled, _ = JForest(str(tmp_path / "t" / "x.data")).open(op, tman)
    tled, _ = Forest(str(tmp_path / "j" / "x.data")).open(op, jman,
                                                          device=CPU)
    assert_ledgers_equal(convert.ledger_to_numpy(tled),
                         convert.ledger_arrays(jled))


@pytest.mark.parametrize("path", ["utils/ewah.py", "lsm/__init__.py",
                                  "vsr/statesync.py"])
def test_copies_equal_their_sources_apart_from_imports_and_docstring(path):
    def body(p):
        text = (ROOT / p).read_text()
        if text.startswith('"""'):
            text = text[text.index('"""', 3) + 3:]
        return [line for line in text.splitlines()
                if not line.lstrip().startswith(("import ", "from "))]

    assert body("tigerbeetle_tpu_torch/" + path) == \
        body("tigerbeetle_tpu/" + path)


def test_forest_copy_differs_only_in_the_load_device():
    """lsm/forest.py is the JAX package's but for ``open``'s ``device``,
    which the port's ``arrays_to_ledger`` needs."""
    src = (ROOT / "tigerbeetle_tpu/lsm/forest.py").read_text()
    for old, new in (
        ("self, op: int, manifest_checksum: int\n",
         "self, op: int, manifest_checksum: int, device=None\n"),
        ("every file checksum.\"\"\"",
         "every file checksum.\n        (The port's one change: the ledger "
         "is loaded onto ``device``.)\"\"\""),
        ("arrays_to_ledger(self.prev)", "arrays_to_ledger(self.prev, device)"),
    ):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    assert (ROOT / "tigerbeetle_tpu_torch/lsm/forest.py").read_text() == src


# -- restart across a tiered checkpoint (tests/test_cold_tier.py:183-247) ----------

TIER_CFG = LedgerConfig(accounts_capacity_log2=8, transfers_capacity_log2=8,
                        posted_capacity_log2=8)


def tier_trio(tmp_path):
    t = TorchStateMachine(TIER_CFG, batch_lanes=64, device="cpu",
                          spill_dir=str(tmp_path / "tcold"),
                          hot_transfers_capacity_max=256)
    j = TpuStateMachine(TIER_CFG, batch_lanes=64,
                        spill_dir=str(tmp_path / "jcold"),
                        hot_transfers_capacity_max=256)
    ref = M.ReferenceStateMachine()
    accounts = _accounts(1, 8)
    want = ref.create_accounts([M.account_from_row(r) for r in accounts], 1)
    assert t.create_accounts(accounts, 1) == j.create_accounts(accounts, 1) \
        == want
    return t, j, ref


def tier_batch(t, j, ref, specs):
    batch = types.transfers_array([types.transfer(**s) for s in specs])
    got = t.create_transfers(batch)
    assert got == j.create_transfers(batch)
    want = ref.create_transfers([M.transfer_from_row(r) for r in batch])
    assert got == want
    return got


def fill(t, j, ref, n, start_id):
    tid = start_id
    while tid < start_id + n:
        m = min(50, start_id + n - tid)
        tier_batch(t, j, ref, [
            dict(id=tid + i, debit_account_id=1 + (tid + i) % 8,
                 credit_account_id=1 + (tid + i + 3) % 8, amount=1 + i,
                 ledger=1, code=10)
            for i in range(m)
        ])
        tid += m


def restarted(m, cls, tmp_path, name, **kw):
    """A fresh machine of ``cls`` over ``m``'s checkpoint: the ledger saved
    and loaded through the snapshot file, then the host state."""
    path = str(tmp_path / name)
    if cls is TorchStateMachine:
        _p, cs = checkpoint.save(path, 1, m.checkpoint_ledger())
        ledger, _meta = checkpoint.load(path, 1, cs, device=CPU)
        m2 = cls(TIER_CFG, batch_lanes=64, device="cpu", **kw)
    else:
        _p, cs = jcheckpoint.save(path, 1, m.checkpoint_ledger())
        ledger, _meta = jcheckpoint.load(path, 1, cs)
        m2 = cls(TIER_CFG, batch_lanes=64, **kw)
    m2.ledger = ledger
    m2.restore_host_state(copy.deepcopy(m.host_state()))
    return m2


def test_restart_reload(tmp_path):
    t, j, ref = tier_trio(tmp_path)
    fill(t, j, ref, 400, 30_000)
    assert t.cold.count == j.cold.count > 0
    t2 = restarted(t, TorchStateMachine, tmp_path, "t",
                   spill_dir=str(tmp_path / "tcold"),
                   hot_transfers_capacity_max=256)
    j2 = restarted(j, TpuStateMachine, tmp_path, "j",
                   spill_dir=str(tmp_path / "jcold"),
                   hot_transfers_capacity_max=256)
    assert t2.cold.count == t.cold.count
    assert t2.host_state()["cold_manifest"] == t.host_state()["cold_manifest"]
    lo = int(np.asarray(t.cold.runs[0][0])["id_lo"])
    orig = ref.transfers[lo]
    dup = [dict(id=lo, debit_account_id=orig.debit_account_id,
                credit_account_id=orig.credit_account_id, amount=orig.amount,
                ledger=1, code=10)]
    got = tier_batch(t2, j2, ref, dup)
    assert got == [(0, int(types.CreateTransferResult.exists))]
    assert t2.balances_snapshot() == ref.balances_snapshot()


def test_restart_query_includes_cold(tmp_path):
    """After a restart the rebuilt index covers the cold tier too."""
    t, j, ref = tier_trio(tmp_path)
    fill(t, j, ref, 300, 40_000)
    assert t.cold.count > 0
    t2 = restarted(t, TorchStateMachine, tmp_path, "t",
                   spill_dir=str(tmp_path / "tcold"),
                   hot_transfers_capacity_max=256)
    f = np.zeros(1, dtype=types.ACCOUNT_FILTER_DTYPE)[0]
    f["account_id_lo"], f["limit"], f["flags"] = 1, 8000, 3
    got_rows = t2.get_account_transfers(f)
    want_rows = ref.get_account_transfers(1, 0, 0, 8000, 3)
    assert [int(r["id_lo"]) for r in got_rows] == [x.id for x in want_rows]
    assert got_rows.tobytes() == j.get_account_transfers(f).tobytes()


def test_restart_without_cap_reads_cold_manifest(tmp_path):
    t, j, ref = tier_trio(tmp_path)
    fill(t, j, ref, 400, 50_000)
    assert t.cold.count > 0
    t2 = restarted(t, TorchStateMachine, tmp_path, "t",
                   spill_dir=str(tmp_path / "tcold"))
    j2 = restarted(j, TpuStateMachine, tmp_path, "j",
                   spill_dir=str(tmp_path / "jcold"))
    assert t2.cold.count == t.cold.count == j2.cold.count
    sample = [50_000, 50_001]
    got = t2.lookup_transfers(sample)
    assert got.tobytes() == j2.lookup_transfers(sample).tobytes()
    assert len(got) == len(ref.lookup_transfers(sample)) == 2


def test_restore_to_a_pre_eviction_checkpoint_drops_cold_state(tmp_path):
    """Restoring a host state without a cold manifest clears the in-memory
    runs and the filter, as the JAX machine does."""
    t, j, ref = tier_trio(tmp_path)
    # Copies: the port updates its tensors in place, JAX donates its buffers.
    early = {
        t: (convert.ledger_from_numpy(convert.ledger_to_numpy(t.ledger), CPU),
            copy.deepcopy(t.host_state())),
        j: (jax_ledger(copy.deepcopy(convert.ledger_arrays(j.ledger))),
            copy.deepcopy(j.host_state())),
    }
    fill(t, j, ref, 400, 60_000)
    assert t.cold.count > 0
    for m in (t, j):
        led, st = early[m]
        m.ledger = led
        m.restore_host_state(st)
    assert t.cold.count == j.cold.count == 0
    assert t.host_state() == j.host_state()
    assert convert.bloom_to_numpy(t._bloom_dev).tobytes() == \
        np.asarray(j._bloom_dev).tobytes()


def test_host_state_round_trip_equals_jax():
    t, j = twins()
    st_t, st_j = t.host_state(), j.host_state()
    assert st_t == st_j
    t2 = TorchStateMachine(LEDGER_TEST, batch_lanes=64, device="cpu")
    j2 = TpuStateMachine(LEDGER_TEST, batch_lanes=64)
    t2.ledger = convert.ledger_from_numpy(convert.ledger_to_numpy(t.ledger),
                                          CPU)
    j2.ledger = j.ledger
    # An older checkpoint without the bound fields: floors at the live
    # counts, fast path off.
    old = {"prepare_timestamp": st_t["prepare_timestamp"],
           "commit_timestamp": st_t["commit_timestamp"]}
    t2.restore_host_state(old)
    j2.restore_host_state(old)
    assert t2.host_state() == j2.host_state()
    b = _transfers(900, 10)
    assert t2.create_transfers(b) == j2.create_transfers(b)
    assert t2.digest() == j2.digest()
