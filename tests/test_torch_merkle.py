"""The port's Merkle commitments (``tigerbeetle_tpu_torch/ops/merkle.py`` and
the machine's hooks) against the JAX package's on the CPU, exactly: every
value is a u64, so the tolerance is zero.

- ops: ``build_forest``, ``verify_roots``, ``update_accounts``,
  ``update_transfers`` (post/void lanes whose pendings are found, not found,
  and not pending) and ``gather_path`` against the JAX functions on ledgers
  left by the port's fast, general, sequential and tiered routes, each
  handed to both packages; the numpy twins against each other.
- machine: a port machine and a JAX machine, Merkle on, scrub intervals 1
  and 4, armed at genesis through the setters and ``scrub_arm``, on one
  mixed stream: equal after every batch in ``merkle_roots``,
  ``commitment_root`` and the ``get_proof`` bytes of accounts, transfers
  and posted rows (at interval 1 through an SDC flip and its recovery).
- the single-device blocking cases of tests/test_merkle.py, restated
  against the port with the same seeds.

On the CPU the port runs the plain versions of kernels K22 and K23; the
kernels are held against them on the card (tests/test_torch_kernels.py and
chip_smoke.py)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_fault_domain import (
    CFG, LANES, N_ACCOUNTS, ROUTES, accounts_batch, drive_mixes, jax_ledger,
    linked_batch, plain_batch, route_states, two_phase_batches,
)

from tigerbeetle_tpu import types
from tigerbeetle_tpu.machine import TpuStateMachine
from tigerbeetle_tpu.ops import merkle as jmk
from tigerbeetle_tpu.ops import state_machine as jsm
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.machine import TorchStateMachine
from tigerbeetle_tpu_torch.ops import merkle as mk
from tigerbeetle_tpu_torch.ops import state_machine as sm
from tigerbeetle_tpu_torch.ops.scrub import DeviceStateUnrecoverable

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def states():
    return {route: route_states(route) for route in ROUTES}


def forest_arrays(forest):
    """The heaps of a JAX ``Forest`` as u64 numpy arrays."""
    return {name: np.asarray(getattr(forest, name)) for name in mk.PADS}


def both(arrays):
    """The same ledger for both packages."""
    return convert.ledger_from_numpy(arrays, CPU), jax_ledger(arrays)


def heaps_equal(port_forest, jax_forest):
    got = convert.forest_to_numpy(port_forest)
    want = forest_arrays(jax_forest)
    for name in mk.PADS:
        assert got[name].dtype == want[name].dtype == np.uint64
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def padded(a, lanes=256):
    buf = np.zeros(max(lanes, 1 << (len(a) - 1).bit_length()), np.uint64)
    buf[:len(a)] = np.asarray(a, np.uint64)
    return buf


def t64(a):
    return convert.array_to_tensor(a, CPU)


# -- ops ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES)
def test_build_forest_and_roots_match_jax(states, route):
    _before, after, _batch, _cold = states[route]
    tled, jled = both(after)
    tf_, jf = mk.build_forest(tled), jmk.build_forest(jled)
    heaps_equal(tf_, jf)
    got = convert.tensor_to_array(mk.forest_roots(tf_))
    np.testing.assert_array_equal(got, np.asarray(jmk.forest_roots(jf)))
    assert tuple(int(r) for r in got) == jmk.np_ledger_roots(jled) \
        == mk.np_ledger_roots(tled)
    # The forest round-trips through the exchange format byte for byte.
    back = convert.forest_from_numpy(forest_arrays(jf), CPU)
    heaps_equal(back, jf)


@pytest.mark.parametrize("route", ROUTES)
def test_verify_roots_matches_jax_clean_and_tampered(states, route):
    _before, after, _batch, _cold = states[route]
    tled, jled = both(after)
    jf = jmk.build_forest(jled)
    for tamper in (None, "accounts", "posted"):
        heaps = forest_arrays(jf)
        if tamper:
            heaps[tamper] = heaps[tamper].copy()
            heaps[tamper][1] ^= np.uint64(1 << 17)
        want = np.asarray(jmk.verify_roots(
            jmk.Forest(**{k: jnp.asarray(v) for k, v in heaps.items()}), jled))
        got = convert.tensor_to_array(
            mk.verify_roots(convert.forest_from_numpy(heaps, CPU), tled))
        np.testing.assert_array_equal(got, want)
        assert (got[0] == got[1]).all() == (tamper is None)


def touched_keys(batch):
    """The machine's touched-key sets of one transfer batch, padded."""
    pv = (batch["flags"] & (types.TransferFlags.POST_PENDING_TRANSFER
                            | types.TransferFlags.VOID_PENDING_TRANSFER)) != 0
    acc = np.unique(np.stack([
        np.concatenate([batch["debit_account_id_hi"],
                        batch["credit_account_id_hi"]]).astype(np.uint64),
        np.concatenate([batch["debit_account_id_lo"],
                        batch["credit_account_id_lo"]]).astype(np.uint64),
    ], axis=1), axis=0)
    return {
        "id_lo": padded(batch["id_lo"]), "id_hi": padded(batch["id_hi"]),
        "acc_lo": padded(acc[:, 1]), "acc_hi": padded(acc[:, 0]),
        "pend_lo": padded(batch["pending_id_lo"][pv]),
        "pend_hi": padded(batch["pending_id_hi"][pv]),
    }, bool(pv.any())


@pytest.mark.parametrize("route", ROUTES)
def test_update_transfers_matches_jax(states, route):
    """A forest built before the route's last batch, updated with that
    batch's touched keys on the ledger after it: the same heaps in both
    packages (post/void lanes resolved on the device)."""
    before, after, batch, _cold = states[route]
    _t0, j0 = both(before)
    tled, jled = both(after)
    jf0 = jmk.build_forest(j0)
    keys, has_pv = touched_keys(batch)
    if route in ("general", "tiered"):
        assert has_pv
    want = jmk.update_transfers(
        jmk.Forest(**{k: jnp.asarray(v) for k, v in
                      forest_arrays(jf0).items()}),
        jled, *(jnp.asarray(keys[k]) for k in (
            "id_lo", "id_hi", "acc_lo", "acc_hi", "pend_lo", "pend_hi")),
        max_probe=jsm.MAX_PROBE, has_postvoid=has_pv)
    got = mk.update_transfers(
        convert.forest_from_numpy(forest_arrays(jf0), CPU), tled,
        *(t64(keys[k]) for k in (
            "id_lo", "id_hi", "acc_lo", "acc_hi", "pend_lo", "pend_hi")),
        max_probe=sm.MAX_PROBE, has_postvoid=has_pv)
    heaps_equal(got, want)
    if route in ("fast", "general"):
        # Every row the batch changed was touched: the update equals a
        # fresh build.
        heaps_equal(mk.build_forest(tled), want)


@pytest.mark.parametrize("route", ROUTES)
def test_update_accounts_matches_jax(states, route):
    before, after, _batch, _cold = states[route]
    _t0, j0 = both(before)
    tled, jled = both(after)
    jf0 = forest_arrays(jmk.build_forest(j0))
    ids = padded(np.arange(1, N_ACCOUNTS + 3, dtype=np.uint64))  # 2 misses
    zeros = np.zeros_like(ids)
    want = jmk.update_accounts(
        jmk.Forest(**{k: jnp.asarray(v) for k, v in jf0.items()}), jled,
        jnp.asarray(ids), jnp.asarray(zeros), max_probe=jsm.MAX_PROBE)
    got = mk.update_accounts(convert.forest_from_numpy(jf0, CPU), tled,
                             t64(ids), t64(zeros), max_probe=sm.MAX_PROBE)
    heaps_equal(got, want)


@pytest.mark.parametrize("route", ROUTES)
def test_gather_path_matches_jax(states, route):
    _before, after, _batch, _cold = states[route]
    tled, jled = both(after)
    tf_, jf = mk.build_forest(tled), jmk.build_forest(jled)
    for pad in mk.PADS:
        keys = after[pad]["key_lo"]
        slots = [int(s) for s in np.flatnonzero(keys)[:3]] + [0]
        levels = max(0, (len(keys)).bit_length() - 1)
        for slot in slots:
            jl, js, jr = jmk.gather_path(jf.pad(pad), jnp.uint64(slot), levels)
            tl, ts, tr = mk.gather_path(tf_.pad(pad), slot, levels)
            assert convert.tensor_to_array(tl.reshape(1))[0] == np.asarray(jl)
            np.testing.assert_array_equal(convert.tensor_to_array(ts),
                                          np.asarray(js))
            assert convert.tensor_to_array(tr.reshape(1))[0] == np.asarray(jr)


def test_numpy_twins_match_jax(states):
    """The host twins on the same rows: leaves, heaps, roots, proof leaves,
    the proof wire format and the lane coalescing."""
    rng = np.random.default_rng(5)
    leaves = rng.integers(0, 1 << 64, 64, dtype=np.uint64)
    np.testing.assert_array_equal(mk.np_tree(leaves), jmk.np_tree(leaves))
    assert mk.np_root(leaves) == jmk.np_root(leaves)
    _b, after, _batch, _cold = states["general"]
    tled, jled = both(after)
    assert mk.np_ledger_roots(tled) == jmk.np_ledger_roots(jled)
    for pad in mk.PADS:
        np.testing.assert_array_equal(
            mk.np_table_leaves(getattr(tled, pad), pad),
            jmk.np_table_leaves(getattr(jled, pad), pad))
    row = np.zeros((), types.TRANSFER_DTYPE)
    row["id_lo"], row["amount_lo"], row["timestamp"] = 7, 9, 11
    blob = mk.encode_proof(row.tobytes(), 5, [1, 2, 3], 99, kind="transfers")
    assert blob == jmk.encode_proof(row.tobytes(), 5, [1, 2, 3], 99,
                                    kind="transfers")
    records = [("create_transfers", np.zeros(40)), ("create_accounts", 1),
               ("create_transfers", np.zeros(30)),
               ("create_transfers", np.zeros(50))]
    assert [(op, len(g)) for op, g in mk.coalesce_touch_records(records, 64)] \
        == [(op, len(g)) for op, g in jmk.coalesce_touch_records(records, 64)]


def test_unique_pairs_equals_numpy_unique_rows():
    """The machine's account-side dedupe gives np.unique(axis=0)'s rows."""
    from tigerbeetle_tpu_torch.machine import _unique_pairs

    rng = np.random.default_rng(3)
    for n in (0, 1, 50, 16_380):
        hi = rng.integers(0, 3, n).astype(np.uint64) << np.uint64(62)
        lo = rng.integers(0, max(1, n // 4), n).astype(np.uint64)
        lo[::5] |= np.uint64(1 << 63)
        want = np.unique(np.stack([hi, lo], axis=1), axis=0)
        got = _unique_pairs(hi, lo)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# -- machines ----------------------------------------------------------------------


def armed_pair(interval):
    """A port and a JAX machine, Merkle on, armed at genesis."""
    out = []
    for m in (TorchStateMachine(CFG, batch_lanes=LANES, device="cpu"),
              TpuStateMachine(CFG, batch_lanes=LANES)):
        m.retry_tick_s = 0
        m.scrub_interval = interval
        m.merkle_enabled = True
        assert m.scrub_arm()
        out.append(m)
    return out


def observe(m, transfer_id):
    return (m.merkle_roots(), m.commitment_root(), m.get_proof(3),
            m.get_proof(N_ACCOUNTS + 5),
            m.get_proof(transfer_id, kind="transfers"),
            m.get_proof(3000, kind="posted"),
            m.get_proof(3001, kind="posted"))


@pytest.mark.parametrize("interval", [1, 4])
def test_machine_roots_and_proofs_match_jax_after_every_batch(interval):
    t, j = armed_pair(interval)
    assert (t._scrub_mirror is not None) == (interval == 1) \
        == (j._scrub_mirror is not None)
    stream = [("create_accounts", accounts_batch(), 1000),
              ("create_transfers", plain_batch(1000, 24), 0),
              ("create_transfers", plain_batch(2000, 20, zipf=True), 0)]
    stream += [("create_transfers", b, 0)
               for b in two_phase_batches(3000, 8, missing=(424_242,))]
    stream += [("create_transfers", linked_batch(5000, 12), 0),
               ("create_transfers", plain_batch(6000, 16), 0)]
    for k, (op, batch, wall) in enumerate(stream):
        if interval == 1 and k == 4:
            assert t.inject_sdc_bitflip(random.Random(7))
            assert j.inject_sdc_bitflip(random.Random(7))
        got = getattr(t, op)(batch, wall_clock_ns=wall)
        assert got == getattr(j, op)(batch, wall_clock_ns=wall), k
        first = int(batch["id_lo"][0]) if op == "create_transfers" else 1000
        assert observe(t, first) == observe(j, first), k
    assert t.merkle_canonical_roots() == j.merkle_canonical_roots()
    for name in ("scrub_checks", "scrub_mismatches", "merkle_mismatches",
                 "device_recoveries", "merkle_rebuilds", "merkle_updates"):
        assert getattr(t, name) == getattr(j, name), name
    if interval == 1:
        assert t.device_recoveries == 1


@pytest.mark.parametrize("route", ["sequential", "tiered"])
def test_machine_roots_match_jax_across_rebuild_marks(route):
    """The routes that change rows outside a touched update (the
    sequential path's rollbacks, eviction and rehydration) mark the forest
    dirty; it rebuilds, and the roots stay the JAX machine's."""
    kw = ({"force_sequential": True} if route == "sequential"
          else {"hot_transfers_capacity_max": 1 << 12})
    t = TorchStateMachine(CFG, batch_lanes=LANES, device="cpu", **kw)
    j = TpuStateMachine(CFG, batch_lanes=LANES, **kw)
    for m in (t, j):
        m.retry_tick_s = 0
        m.scrub_interval = 4
        m.merkle_enabled = True
        m.scrub_paranoid = False
        assert m.scrub_arm()
    steps = [accounts_batch()] + [plain_batch(1000 + 100 * k, 40)
                                  for k in range(4)]
    steps += two_phase_batches(3000, 8)[:1] + ["evict"]
    steps += [two_phase_batches(3000, 8, missing=(1005,))[1],
              linked_batch(5000, 12)]
    for k, step in enumerate(steps):
        if isinstance(step, str):
            if route != "tiered":
                continue
            assert t.evict_cold(0.5) == j.evict_cold(0.5) > 0
        elif k == 0:
            assert t.create_accounts(step, 1000) == j.create_accounts(step, 1000)
        else:
            assert t.create_transfers(step) == j.create_transfers(step), k
        assert t.merkle_roots() == j.merkle_roots(), k
        assert t.commitment_root() == j.commitment_root(), k
    assert t.merkle_rebuilds == j.merkle_rebuilds > 1
    if route == "tiered":
        assert t.rehydrated_rows > 0 and t.cold.count > 0
    assert t.scrub_check() is True and j.scrub_check() is True


# -- tests/test_merkle.py restated against the port ------------------------------


def make_machine(merkle=True, interval=4, paranoid=False):
    m = TorchStateMachine(CFG, batch_lanes=LANES, device="cpu")
    m.retry_tick_s = 0
    m.scrub_interval = interval
    if merkle:
        m.merkle_enabled = True
        m.scrub_paranoid = paranoid
        if interval:
            assert m.scrub_arm()
    return m


class TestMerkleOps:
    def test_build_matches_numpy_oracle(self):
        m = make_machine(merkle=False, interval=0)
        drive_mixes(m)
        forest = mk.build_forest(m.ledger)
        dev = tuple(int(r) for r in
                    convert.tensor_to_array(mk.forest_roots(forest)))
        assert dev == mk.np_ledger_roots(m.ledger)

    def test_touched_path_update_matches_rebuild(self):
        m = make_machine(merkle=False, interval=0)
        m.create_accounts(accounts_batch(), wall_clock_ns=1000)
        forest = mk.build_forest(m.ledger)
        b = plain_batch(1000, 24)
        m.create_transfers(b)

        def pad(a):
            buf = np.zeros(64, np.uint64)
            buf[:len(a)] = a.astype(np.uint64)
            return t64(buf)

        forest = mk.update_transfers(
            forest, m.ledger, pad(b["id_lo"]), pad(b["id_hi"]),
            pad(np.concatenate([b["debit_account_id_lo"],
                                b["credit_account_id_lo"]])[:64]),
            pad(np.concatenate([b["debit_account_id_hi"],
                                b["credit_account_id_hi"]])[:64]),
            pad(np.zeros(0)), pad(np.zeros(0)),
            max_probe=sm.MAX_PROBE, has_postvoid=False,
        )
        lanes = convert.tensor_to_array(mk.verify_roots(forest, m.ledger))
        assert (lanes[0] == lanes[1]).all(), lanes


class TestRootOracle:
    def test_root_vs_oracle_mixed_stream(self):
        off = make_machine(merkle=False, interval=0)
        res_off = drive_mixes(off)
        on = make_machine()
        res_on = drive_mixes(on)
        assert res_off == res_on
        assert off.digest() == on.digest()
        assert on.scrub_check() is True
        assert on.merkle_roots() == mk.np_ledger_roots(on.ledger)
        assert on._scrub_mirror is None  # the whole point: no mirror

    def test_growth_rehash_root_stability(self):
        m = make_machine()
        cap0 = m.ledger.accounts.capacity
        for g in range(16):
            b = types.accounts_array([
                types.account(id=10_000 + 64 * g + i, ledger=1, code=10)
                for i in range(40)
            ])
            m.create_accounts(b, wall_clock_ns=1000)
        assert m.ledger.accounts.capacity > cap0, "growth did not trigger"
        assert m.scrub_check() is True
        assert m.merkle_roots() == mk.np_ledger_roots(m.ledger)
        assert m.merkle_rebuilds >= 2  # arm + post-growth

    def test_interval_zero_is_plain(self):
        a = make_machine(merkle=False, interval=0)
        ra = drive_mixes(a)
        b = make_machine(merkle=True, interval=0)
        assert not b.scrub_armed and b.merkle_roots() is None
        rb = drive_mixes(b)
        assert ra == rb and a.digest() == b.digest()

    def test_async_lane_settles_to_the_synchronous_roots(self):
        sync = make_machine()
        lane = make_machine()
        lane.merkle_async = True
        drive_mixes(sync)
        drive_mixes(lane)
        assert lane.commitment_root() == 0  # backlogged: the skip sentinel
        assert lane.merkle_roots() == sync.merkle_roots()
        # Scrub checks settle the lane too (interval 4).
        assert lane.merkle_settles >= 1 and lane.commitment_root() \
            == sync.commitment_root()


class TestMerkleProofs:
    def test_round_trip_and_tamper(self):
        m = make_machine()
        drive_mixes(m)
        blob = m.get_proof(3)
        proof = mk.check_proof(blob)
        assert int(proof["account"]["id_lo"]) == 3
        assert proof["root"] == m.merkle_roots()[0]
        for off in (mk.PROOF_HEADER_DTYPE.itemsize + 2, len(blob) - 3):
            bad = bytearray(blob)
            bad[off] ^= 1
            with pytest.raises(mk.ProofError):
                mk.check_proof(bytes(bad))

    def test_absent_account_and_merkle_off(self):
        m = make_machine()
        m.create_accounts(accounts_batch(), wall_clock_ns=1000)
        assert m.get_proof(999_999) is None
        off = make_machine(merkle=False, interval=0)
        off.create_accounts(accounts_batch(), wall_clock_ns=1000)
        assert off.get_proof(1) is None

    def test_transfer_proof_roundtrip_and_tamper(self):
        m = make_machine()
        drive_mixes(m)
        blob = m.get_proof(1000, kind="transfers")
        proof = mk.check_proof(blob)
        assert proof["kind"] == "transfers"
        assert int(proof["row"]["id_lo"]) == 1000
        assert proof["root"] == m.merkle_roots()[1]
        head = mk.PROOF_HEADER_DTYPE.itemsize
        dr_off = types.TRANSFER_DTYPE.fields["debit_account_id_lo"][1]
        for off in (head + 2, head + dr_off, len(blob) - 3):
            bad = bytearray(blob)
            bad[off] ^= 1
            with pytest.raises(mk.ProofError):
                mk.check_proof(bytes(bad))
        assert int(proof["row"]["debit_account_id_lo"]) == 0
        assert int(proof["row"]["ledger"]) == 0
        bad = bytearray(blob)
        bad[20] ^= 1  # the kind field (header offset 20)
        with pytest.raises(mk.ProofError):
            mk.check_proof(bytes(bad))

    def test_posted_proof_binds_pending(self):
        m = make_machine()
        drive_mixes(m)
        pb = m.get_proof(3000, kind="posted")
        pp = mk.check_proof(pb)
        assert pp["kind"] == "posted"
        assert int(pp["row"]["fulfillment"]) == 1
        assert pp["root"] == m.merkle_roots()[2]
        tp = mk.check_proof(m.get_proof(3000, kind="transfers"))
        assert int(tp["row"]["timestamp"]) == int(
            pp["row"]["pending_timestamp"]
        )
        vb = mk.check_proof(m.get_proof(3001, kind="posted"))
        assert int(vb["row"]["fulfillment"]) == 2
        head = mk.PROOF_HEADER_DTYPE.itemsize
        for off in (head + 1, head + 8, head + 12, len(pb) - 2):
            bad = bytearray(pb)
            bad[off] ^= 1
            with pytest.raises(mk.ProofError):
                mk.check_proof(bytes(bad))

    def test_proof_kind_misses(self):
        m = make_machine()
        drive_mixes(m)
        assert m.get_proof(999_999, kind="transfers") is None
        assert m.get_proof(1000, kind="posted") is None
        with pytest.raises(ValueError):
            m.get_proof(1, kind="history")


class TestMerkleSdc:
    def test_root_mismatch_with_mirror_off(self):
        m = make_machine(interval=1)
        assert m._scrub_mirror is None
        drive_mixes(m)
        assert m.inject_sdc_bitflip(random.Random(7))
        with pytest.raises(DeviceStateUnrecoverable):
            m.scrub_check()
        assert m.merkle_mismatches == 1 and m.scrub_mismatches == 1

    def test_paranoid_interval_keeps_mirror_and_recovers(self):
        m = make_machine(interval=1, paranoid=True)
        assert m._scrub_mirror is not None and m.merkle_armed
        drive_mixes(m)
        assert m.inject_sdc_bitflip(random.Random(7))
        assert m.scrub_check() is False  # detected + recovered
        assert m.device_recoveries == 1
        assert m.scrub_check() is True
        assert m.merkle_roots() == mk.np_ledger_roots(m.ledger)
