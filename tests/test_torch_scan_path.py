"""The port's sequential commit path (``tigerbeetle_tpu_torch.ops.scan_path``)
against the JAX package's (``tigerbeetle_tpu.ops.scan_path``, jitted on the
CPU) on the same padded SoA batches, from the same ledger: every result code
and every array of the accounts, transfers and posted tables and of the
history log must be equal, byte for byte.  The cases port
tests/test_scan_path.py's at the ops level, plus the probe helpers, history
rows, the overflow codes near 2**128 and ``grow_history``.  On the CPU the
port runs the plain versions of kernels K6 and K7; the kernels are held
against them on the card (tests/test_torch_kernels.py and chip_smoke.py)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables x64)
from tigerbeetle_tpu import types
from tigerbeetle_tpu.ops import hash_table as jht
from tigerbeetle_tpu.ops import scan_path as jsp
from tigerbeetle_tpu.ops import state_machine as jsm
from tigerbeetle_tpu.types import AccountFlags as AF, TransferFlags as F
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.ops import scan_path as tsp
from tigerbeetle_tpu_torch.ops import state_machine as tsm
from tigerbeetle_tpu_torch.testing import k7cases, seqmix, seqtraps
from tigerbeetle_tpu_torch.utils.benchgen import mix64_np

LANES = 64
CAPS = (1 << 10, 1 << 11, 1 << 10, 1 << 10)
CPU = torch.device("cpu")
L = int(F.LINKED)
U128_MAX = (1 << 128) - 1


def assert_ledgers_equal(want: dict, got: dict, path=""):
    if isinstance(want, dict):
        assert want.keys() == got.keys(), path
        for k in want:
            assert_ledgers_equal(want[k], got[k], f"{path}/{k}")
        return
    assert want.dtype == got.dtype, path
    np.testing.assert_array_equal(got, want, err_msg=path)


# The port's two plain forms of K6 and of K7: the serial loop (the JAX
# scan's mirror) and the split form the card runs (K32's pre-pass, then the
# sequencer with its overlay; K7's pre-pass, marks and sequencer).
FORMS = {"serial": tsp.create_transfers_seq_plain,
         "split": tsp.create_transfers_seq_split_plain}
ACCOUNT_FORMS = {"serial": tsp.create_accounts_seq_plain,
                 "split": tsp.create_accounts_seq_split_plain}


@pytest.fixture(params=sorted(FORMS))
def form(request):
    return request.param


class Pair:
    """One JAX ledger and one port ledger (converted from it) fed the same
    batches through the two sequential paths; transfers and accounts
    through the plain form ``form`` of K6 and K7."""

    def __init__(self, form="serial", jledger=None):
        self.j = jledger if jledger is not None else jsm.make_ledger(*CAPS)
        self.t = convert.ledger_from_numpy(convert.ledger_arrays(self.j), CPU)
        self.ts = 1_000
        self.form = form

    def commit(self, op, batch, ts=None, overflow=False, lanes=LANES):
        self.ts = ts if ts is not None else self.ts + 10 * len(batch) + 7
        padded = np.zeros(lanes, dtype=batch.dtype)
        padded[: len(batch)] = batch
        soa = types.to_soa(padded)
        n = len(batch)
        self.j, jc = getattr(jsp, op)(
            self.j, {k: jnp.asarray(v) for k, v in soa.items()},
            jnp.uint64(n), jnp.uint64(self.ts))
        fn = (FORMS if op == "create_transfers_seq" else ACCOUNT_FORMS)[self.form]
        self.t, tc, got_overflow = fn(
            self.t, convert.soa_to_tensors(soa, CPU), n, self.ts)
        np.testing.assert_array_equal(convert.tensor_to_array(tc), np.asarray(jc))
        assert bool(got_overflow) == overflow
        self.check()
        return np.asarray(jc)[:n].tolist()

    def check(self):
        assert_ledgers_equal(convert.ledger_arrays(self.j),
                             convert.ledger_to_numpy(self.t))

    def accounts(self, rows, ts=None, overflow=False, lanes=LANES):
        return self.commit("create_accounts_seq", types.accounts_array(rows), ts,
                           overflow, lanes)

    def transfers(self, rows, ts=None, overflow=False, lanes=LANES):
        return self.commit("create_transfers_seq", types.transfers_array(rows),
                           ts, overflow, lanes)


def seeded(n=6, flags=None, form="serial", jledger=None):
    p = Pair(form, jledger)
    p.accounts([types.account(id=i + 1, ledger=1, code=10,
                              flags=(flags or {}).get(i + 1, 0))
                for i in range(n)])
    return p


def tr(id, dr=1, cr=2, amount=10, **kw):
    kw.setdefault("ledger", 1)
    kw.setdefault("code", 10)
    return types.transfer(id=id, debit_account_id=dr, credit_account_id=cr,
                          amount=amount, **kw)


def pv(id, pending_id, flags, amount=0, **kw):
    return types.transfer(id=id, pending_id=pending_id, amount=amount,
                          flags=flags, **kw)


# -- create_accounts ---------------------------------------------------------


def test_accounts_basic_and_chains():
    p = Pair()
    codes = p.accounts([
        types.account(id=1, ledger=1, code=1),
        types.account(id=1, ledger=1, code=1),  # exists
        types.account(id=2, ledger=1, code=1, flags=AF.LINKED),
        types.account(id=2, ledger=1, code=1),  # exists breaks the chain
        types.account(id=3, ledger=1, code=1, flags=AF.LINKED),
        types.account(id=4, ledger=1, code=1),
    ])
    assert codes[1] == 21 and codes[2:4] == [1, 15]
    assert int(p.t.accounts.tombstone.sum()) == 1


def test_accounts_linked_with_duplicates():
    """A rolled-back chain insert followed by a retry of the same id later
    in the batch (the fast path's P4 exclusion)."""
    p = Pair()
    codes = p.accounts([
        types.account(id=1, ledger=1, code=1, flags=AF.LINKED),
        types.account(id=2, ledger=0, code=1),  # breaks; 1 rolled back
        types.account(id=1, ledger=1, code=1),  # retry: ok now
        types.account(id=1, ledger=1, code=1),  # exists
        types.account(id=5, ledger=1, code=1, flags=AF.LINKED),  # chain open
    ])
    assert codes == [1, 13, 0, 21, 2]


# -- create_transfers --------------------------------------------------------


def test_plain_transfers_match_fast_semantics(form):
    p = seeded(form=form)
    codes = p.transfers([
        tr(1, amount=100),
        tr(1, amount=100),  # exists
        tr(2, dr=1, cr=1, amount=5),  # accounts_must_be_different
        tr(3, dr=1, cr=9, amount=5),  # credit_account_not_found
        tr(4, amount=0),  # amount_must_not_be_zero
        tr(5, timeout=3),  # timeout_reserved_for_pending_transfer
        tr(6, pending_id=7),  # pending_id_must_be_zero
        types.transfer(id=7, debit_account_id=1, credit_account_id=2,
                       amount=1, ledger=1, code=10, timestamp=9),
        tr(8, flags=0x80),  # padding flags
    ])
    assert codes == [0, 46, 12, 22, 18, 17, 13, 3, 4]


def test_balance_limits(form):
    p = seeded(flags={1: int(AF.DEBITS_MUST_NOT_EXCEED_CREDITS),
                      2: int(AF.CREDITS_MUST_NOT_EXCEED_DEBITS)}, form=form)
    p.transfers([tr(1, dr=3, cr=1, amount=100)])  # fund account 1
    codes = p.transfers([
        tr(2, dr=1, cr=3, amount=60),
        tr(3, dr=1, cr=3, amount=60),  # exceeds_credits
        tr(4, dr=1, cr=3, amount=40),  # exactly at the limit: ok
        tr(5, dr=3, cr=2, amount=10),  # credits limit: 10 > debits 0
        tr(6, dr=1, cr=3, amount=1, flags=F.PENDING),  # pending counts too
    ])
    assert codes == [0, 54, 0, 55, 54]


def test_balancing_transfers(form):
    p = seeded(form=form)
    p.transfers([tr(1, dr=2, cr=1, amount=70)])
    codes = p.transfers([
        tr(2, dr=1, cr=3, amount=100, flags=F.BALANCING_DEBIT),  # clamp to 70
        tr(3, dr=1, cr=3, amount=0, flags=F.BALANCING_DEBIT),  # exceeds_credits
        tr(4, dr=3, cr=2, amount=0, flags=F.BALANCING_CREDIT),  # clamp
        tr(5, dr=3, cr=2, amount=0, flags=F.BALANCING_CREDIT),  # exceeds_debits
        tr(6, dr=4, cr=5, amount=0,
           flags=F.BALANCING_DEBIT | F.BALANCING_CREDIT),
    ])
    assert codes == [0, 54, 0, 55, 54]
    amounts = convert.tensor_to_array(p.t.transfers.cols["amount_lo"])
    assert sorted(a for a in amounts if a) == [70, 70, 70]


def test_two_phase_full_cycle(form):
    p = seeded(form=form)
    p.transfers([tr(1, amount=100, flags=F.PENDING),
                 tr(2, amount=50, flags=F.PENDING, timeout=1000)])
    codes = p.transfers([
        pv(10, 1, F.POST_PENDING_TRANSFER, amount=60),  # partial post of 1
        pv(10, 1, F.POST_PENDING_TRANSFER, amount=60),  # exists
        pv(11, 1, F.POST_PENDING_TRANSFER, amount=60),  # already posted
        pv(12, 2, F.VOID_PENDING_TRANSFER),  # void 2
        pv(13, 2, F.POST_PENDING_TRANSFER),  # already voided
        pv(14, 0, F.POST_PENDING_TRANSFER),
        pv(15, 15, F.POST_PENDING_TRANSFER),
        pv(16, 99, F.POST_PENDING_TRANSFER),
        pv(17, 1, F.POST_PENDING_TRANSFER, amount=101),
        pv(18, 1, F.POST_PENDING_TRANSFER | F.VOID_PENDING_TRANSFER),
        pv(19, 10, F.POST_PENDING_TRANSFER),  # not pending
        pv(20, 2, F.VOID_PENDING_TRANSFER, amount=10),  # partial void
        pv(21, 1, F.POST_PENDING_TRANSFER, ledger=5),
        pv(22, 1, F.POST_PENDING_TRANSFER, code=5),
        pv(23, 1, F.POST_PENDING_TRANSFER, debit_account_id=3),
        pv(24, 1, F.POST_PENDING_TRANSFER, credit_account_id=3),
        pv(10, 1, F.POST_PENDING_TRANSFER, amount=61),  # exists, other amount
        pv(25, 1, F.POST_PENDING_TRANSFER | F.PENDING),
    ])
    assert codes == [0, 46, 33, 0, 34, 14, 16, 25, 31, 7, 26, 32, 29, 30,
                     27, 28, 39, 7]
    assert int(p.t.posted.count) == 2


def test_intra_batch_pending_then_post(form):
    p = seeded(form=form)
    codes = p.transfers([
        tr(1, amount=100, flags=F.PENDING, user_data_64=7),
        pv(2, 1, F.POST_PENDING_TRANSFER),
        pv(3, 1, F.VOID_PENDING_TRANSFER),  # already posted
    ])
    assert codes == [0, 0, 33]


def test_pending_expiry(form):
    p = seeded(form=form)
    p.transfers([tr(1, flags=F.PENDING, timeout=1), tr(3, flags=F.PENDING,
                                                       timeout=5)],
                ts=10_000)
    p_ts = 10_000 - 2 + 0 + 1
    codes = p.transfers([pv(2, 1, F.POST_PENDING_TRANSFER),
                         pv(4, 3, F.POST_PENDING_TRANSFER)],
                        ts=p_ts + 1_000_000_000 + 1)
    assert codes == [35, 0]


def test_linked_chain_rolls_back_two_phase(form):
    p = seeded(flags={2: int(AF.HISTORY)}, form=form)
    p.transfers([tr(1, amount=100, flags=F.PENDING)])
    codes = p.transfers([
        pv(2, 1, F.POST_PENDING_TRANSFER | L),
        tr(3, dr=2, cr=3, amount=5, flags=L),
        tr(4, dr=1, cr=99, amount=1),  # breaks: all rolled back
        pv(5, 1, F.POST_PENDING_TRANSFER),  # still postable
    ])
    assert codes == [1, 1, 22, 0]
    assert int(p.t.posted.tombstone.sum()) == 1
    assert int(p.t.transfers.tombstone.sum()) == 2


def test_rollback_then_reuse_id(form):
    p = seeded(form=form)
    codes = p.transfers([
        tr(1, amount=10, flags=L),
        tr(2, dr=1, cr=99, amount=1),  # breaks; id 1 rolled back
        tr(1, amount=11),  # fresh insert, different amount
        tr(1, amount=10),  # exists_with_different_amount
    ])
    assert codes == [1, 22, 0, 39]


def test_history_rows_and_a_rolled_back_row_beyond_count(form):
    p = seeded(flags={1: int(AF.HISTORY), 3: int(AF.HISTORY)}, form=form)
    codes = p.transfers([
        tr(1, dr=1, cr=2, amount=7),  # history for the debit side
        tr(2, dr=2, cr=3, amount=5, flags=F.PENDING),  # credit side
        tr(3, dr=2, cr=4, amount=5),  # neither side: no row
        tr(4, dr=3, cr=1, amount=2, flags=L),  # a row, then rolled back
        tr(5, dr=1, cr=99, amount=1),
        pv(6, 2, F.POST_PENDING_TRANSFER),  # post/void: no row
    ])
    assert codes == [0, 0, 0, 1, 22, 0]
    h = p.t.history
    assert int(h.count) == 2
    # The popped row stays in the array beyond count, as in the reference.
    assert convert.tensor_to_array(h.cols["timestamp"])[2] != 0
    assert convert.tensor_to_array(h.cols["cr_id_lo"])[0] == 0
    assert convert.tensor_to_array(h.cols["dr_dpo_lo"])[0] == 7
    # A later row overwrites it.
    p.transfers([tr(7, dr=3, cr=2, amount=1)])
    assert int(p.t.history.count) == 3


def test_overflow_codes_near_u128_max(form):
    big = U128_MAX - 9
    p = seeded(8, form=form)
    codes = p.transfers([
        tr(1, dr=1, cr=2, amount=big, flags=F.PENDING),
        tr(2, dr=1, cr=3, amount=20, flags=F.PENDING),  # debits_pending: 47
        tr(3, dr=3, cr=2, amount=20, flags=F.PENDING),  # credits_pending: 48
        tr(4, dr=4, cr=5, amount=big),
        tr(5, dr=4, cr=6, amount=20),  # debits_posted: 49
        tr(6, dr=6, cr=5, amount=20),  # credits_posted: 50
        tr(7, dr=7, cr=8, amount=1 << 127, flags=F.PENDING),
        tr(8, dr=7, cr=8, amount=(1 << 127) - 1),
        tr(9, dr=7, cr=3, amount=1),  # debits total: 51
        tr(10, dr=3, cr=8, amount=1),  # credits total: 52
    ])
    assert codes == [0, 47, 48, 0, 49, 50, 0, 0, 51, 52]
    codes = p.transfers([tr(11, dr=3, cr=6, amount=1, flags=F.PENDING,
                            timeout=10)], ts=(1 << 64) - 5)
    assert codes == [53]


def test_random_differential_all_features(form):
    rng = np.random.default_rng(99)
    flags = {2: int(AF.DEBITS_MUST_NOT_EXCEED_CREDITS),
             3: int(AF.CREDITS_MUST_NOT_EXCEED_DEBITS), 4: int(AF.HISTORY),
             5: int(AF.HISTORY | AF.DEBITS_MUST_NOT_EXCEED_CREDITS)}
    p = seeded(8, flags, form=form)
    p.transfers([tr(1000 + i, dr=1, cr=2 + i, amount=500) for i in range(7)])
    pool, next_id = [], 100
    for b in range(5):
        rows = []
        for _ in range(LANES - 4):
            r = rng.random()
            next_id += 1
            tid = int(rng.choice(pool)) if pool and rng.random() < 0.05 else next_id
            f = L if rng.random() < 0.2 else 0
            if r < 0.2 and pool:
                kind = int(rng.choice([F.POST_PENDING_TRANSFER,
                                       F.VOID_PENDING_TRANSFER]))
                amt = int(rng.integers(0, 40)) if kind == F.POST_PENDING_TRANSFER else 0
                rows.append(pv(tid, int(rng.choice(pool)), kind | f, amount=amt))
            elif r < 0.35:
                kind = int(rng.choice([F.BALANCING_DEBIT, F.BALANCING_CREDIT]))
                dr, cr = rng.choice(range(1, 10), size=2, replace=False)
                rows.append(tr(tid, dr=int(dr), cr=int(cr),
                               amount=int(rng.integers(0, 100)), flags=kind | f))
            else:
                dr, cr = rng.choice(range(1, 10), size=2, replace=False)
                pend = int(F.PENDING) if rng.random() < 0.4 else 0
                rows.append(tr(tid, dr=int(dr), cr=int(cr),
                               amount=int(rng.integers(1, 60)), flags=pend | f,
                               timeout=int(rng.integers(0, 3)) if pend else 0))
                if pend:
                    pool.append(tid)
        codes = p.transfers(rows, ts=p.ts + 1_000_000_000 * int(rng.integers(0, 3)) + 997)
        assert len(set(codes)) > 3, codes


def test_seqmix_batches_match_jax(form):
    """The event mix chip_smoke.py holds kernels K6 and K7 to, at a small
    size: a faulty accounts batch, then transfer batches, the last at
    timestamps near 2**64 (code 53)."""
    rng = np.random.default_rng(31)
    p = Pair(form)
    p.accounts(list(seqmix.accounts_batch(rng, 1, 40)), ts=10 ** 9)
    p.accounts(list(seqmix.accounts_batch(rng, 30, 40)), ts=2 * 10 ** 9)
    mix = seqmix.TransferMix(rng, list(range(1, 70)), 10 ** 6)
    codes = []
    for b in range(4):
        codes += p.transfers(list(mix.batch(LANES)), ts=(b + 3) * 10 ** 9)
    codes += p.transfers(list(mix.batch(LANES - 1)) + [
        tr(1 << 70, dr=1, cr=7, flags=F.PENDING, timeout=100)],
        ts=(1 << 64) - 10 ** 10)
    assert {0, 1, 25, 33, 53, 54}.issubset(codes)
    assert int(p.t.history.count) > 0 and int(p.t.posted.count) > 0


# -- the split form's traps: where a pre-batch answer goes stale ------------


def _same_home(cap, n, home=None, start=1, exclude=()):
    """``n`` keys (lo, hi 0) whose home slot in a table of ``cap`` slots is
    ``home`` (the first candidate's when None)."""
    cand = np.arange(start, start + 2_000_000, dtype=np.uint64)
    homes = mix64_np(cand, 0) & np.uint64(cap - 1)
    h = homes[0] if home is None else np.uint64(home)
    keys = [int(k) for k in cand[homes == h] if int(k) not in exclude]
    return keys[:n]


def test_id_reused_after_rollback_in_a_cluster_the_batch_filled(form):
    """Ids sharing one home slot of the transfers table: earlier events of
    the batch fill the cluster, a linked chain's inserts there are rolled
    back (tombstones mid-cluster), and their ids are inserted again later in
    the batch: each placement is pushed past the batch's own inserts and
    tombstones, and each re-used id is then found (exists codes)."""
    ids = _same_home(CAPS[1], 6)
    p = seeded(form=form)
    p.transfers([tr(ids[0], amount=3)])  # stored before the batch
    codes = p.transfers([
        tr(ids[1], amount=5),
        tr(ids[2], amount=6, flags=L),
        tr(ids[3], amount=7, flags=L),
        tr(ids[4], dr=1, cr=99, amount=1),  # breaks: 2 and 3 rolled back
        tr(ids[3], amount=7),  # re-used: past the tombstones
        tr(ids[5], amount=8),  # past every insert of the batch
        tr(ids[2], amount=9),  # re-used with another amount
        tr(ids[3], amount=7),  # exists now
        tr(ids[2], amount=6),  # exists with another amount
        tr(ids[1], amount=5),  # exists
        tr(ids[0], amount=4),  # stored before the batch, other amount
    ])
    assert codes == [0, 1, 1, 22, 0, 0, 0, 46, 39, 46, 39]
    assert int(p.t.transfers.tombstone.sum()) == 2


def test_placement_pushed_past_in_batch_inserts_and_tombstones(form):
    """Keys of different ids with one home: a key whose pre-batch free slot
    an earlier event of the batch took goes further along, past live rows
    and past a tombstone the batch itself left; a pending id the batch
    re-inserts after a rollback is posted by a later event, whose pending
    row then comes from the table (not from the group's first event)."""
    ids = _same_home(CAPS[1], 7)
    p = seeded(form=form)
    codes = p.transfers([
        tr(ids[0], amount=1, flags=L),
        tr(ids[1], amount=2, flags=L | F.PENDING),
        tr(ids[2], dr=1, cr=99, amount=1),  # breaks: 0 and 1 tombstoned
        tr(ids[3], amount=3),
        tr(ids[1], amount=4, flags=F.PENDING),  # re-inserted, further on
        tr(ids[4], amount=5),
        pv(ids[5], ids[1], F.POST_PENDING_TRANSFER),
        pv(ids[6], ids[1], F.VOID_PENDING_TRANSFER),  # already posted
        tr(ids[0], amount=6),
    ])
    assert codes == [1, 1, 22, 0, 0, 0, 0, 33, 0]
    assert int(p.t.posted.count) == 1


def test_pending_made_and_posted_in_one_batch_with_colliding_posted_keys(form):
    """A pending made in the batch and posted later in it: its posted key
    (its own timestamp) is found in the posted table before the batch
    (code 33), and another's key shares its home with stored posted rows,
    so the posted insert is pushed past them; a void of a pending whose
    group's first event failed takes the pending's row from the table."""
    count, ts = 11, 70_000
    ts_base = ts - count + 1
    cap = CAPS[2]
    home = int(mix64_np(np.array([ts_base + 3], np.uint64), 0)[0]) & (cap - 1)
    crowd = _same_home(cap, 3, home=home, exclude={ts_base + 3})
    j = jsm.make_ledger(*CAPS)
    keys = np.array([ts_base] + crowd, np.uint64)
    posted, _ = jht.insert(
        j.posted, jnp.asarray(keys), jnp.zeros(len(keys), jnp.uint64),
        jnp.ones(len(keys), jnp.bool_),
        {"fulfillment": jnp.asarray(np.array([1, 2, 1, 2], np.uint32))},
        max_probe=cap)
    p = seeded(form=form, jledger=j.replace(posted=posted))
    p.transfers([tr(50, dr=3, cr=1, amount=100)])  # credits for account 1
    codes = p.transfers([
        tr(100, amount=10, flags=F.PENDING),  # its key is stored already
        pv(101, 100, F.POST_PENDING_TRANSFER),
        pv(102, 100, F.VOID_PENDING_TRANSFER),
        tr(103, amount=11, flags=F.PENDING),  # its key's home is crowded
        pv(104, 103, F.VOID_PENDING_TRANSFER),
        tr(105, dr=1, cr=99, amount=1, flags=F.PENDING),  # the group's head
        tr(105, amount=12, flags=F.PENDING),  # the pending, inserted here
        pv(106, 105, F.VOID_PENDING_TRANSFER),
        pv(107, 103, F.POST_PENDING_TRANSFER),  # already voided
        tr(108, amount=500, flags=F.PENDING | F.BALANCING_DEBIT),  # clamped
        pv(109, 108, F.POST_PENDING_TRANSFER),  # posts the clamped amount
    ], ts=ts)
    assert codes == [0, 33, 33, 0, 0, 22, 0, 0, 34, 0, 0]
    assert int(p.t.posted.count) == len(keys) + 3


def test_probe_cap_writes_slot_zero_and_sets_overflow(form):
    """No truly empty slot within MAX_PROBE (tables whose free slots are all
    tombstones): each insert goes to slot 0, over whatever is stored there,
    as the reference writes it, and the overflow flag is raised; the rest of
    the batch follows the tables as those writes left them (the split form
    runs it serially)."""
    j = jsm.make_ledger(*CAPS)
    j = j.replace(posted=j.posted.replace(
        tombstone=jnp.ones(CAPS[2], jnp.bool_)))
    p = seeded(form=form, jledger=j)
    p.transfers([tr(7, amount=9, flags=F.PENDING),
                 tr(8, amount=9, flags=F.PENDING)])
    assert p.transfers([pv(9, 8, F.POST_PENDING_TRANSFER),  # posted: slot 0
                        tr(10, amount=1)], overflow=True) == [0, 0]
    p.j = p.j.replace(transfers=p.j.transfers.replace(
        tombstone=p.j.transfers.tombstone.at[:].set(
            p.j.transfers.key_lo == 0)))
    p.t = convert.ledger_from_numpy(convert.ledger_arrays(p.j), CPU)
    codes = p.transfers([
        tr(1, amount=5),  # capped: slot 0
        tr(2, amount=6, flags=L),  # capped: slot 0 again
        tr(1, amount=5),
        pv(3, 7, F.POST_PENDING_TRANSFER),  # a capped posted insert too
        tr(4, amount=7),
    ], overflow=True)
    assert codes == [0, 0, 0, 0, 0]
    assert int(p.t.transfers.key_lo[0]) == 4


# -- helpers -----------------------------------------------------------------


def _clustered_tables():
    """A JAX transfers table with same-home clusters, some of them cut by
    tombstones, and the port's copy of it."""
    cap = 1 << 10
    cand = np.arange(1, 200_000, dtype=np.uint64)
    homes = mix64_np(cand, 0) & np.uint64(cap - 1)
    keys = np.concatenate([cand[homes == h][:6] for h in (3, 4, 1023)]
                          + [cand[200:400]])
    jt = jht.make_table(cap, jsm.TRANSFER_COLS)
    rows = {k: jnp.zeros(len(keys), v) for k, v in jsm.TRANSFER_COLS.items()}
    jt, _ = jht.insert(jt, jnp.asarray(keys), jnp.zeros(len(keys), jnp.uint64),
                       jnp.ones(len(keys), jnp.bool_), rows, max_probe=cap)
    gone = jht.lookup(jt, jnp.asarray(keys[1::4]),
                      jnp.zeros(len(keys[1::4]), jnp.uint64), cap)
    jt = jht.remove_to_tombstone(jt, gone.slot, gone.found)
    tt = convert.ledger_from_numpy(
        {**convert.ledger_arrays(jsm.make_ledger(*CAPS)),
         "transfers": convert.table_arrays(jt)}, CPU).transfers
    return jt, tt, keys


def test_sprobe_free_and_slookup_over_tombstones_and_clusters(form):
    """The probes each plain form of K6 walks with (the serial loop's
    ``_slookup`` / ``_sprobe_free``; the split form's ``_probe_full`` and,
    in the pre-pass, the vectorized ``_probe_vec``) against the JAX
    package's on tables with same-home clusters and tombstones."""
    jt, tt, keys = _clustered_tables()
    probes = np.concatenate([keys, keys + np.uint64(1 << 20),
                             np.arange(1, 64, dtype=np.uint64)])
    free = jax.jit(jax.vmap(jsp._sprobe_free, in_axes=(None, 0, 0)))
    look = jax.jit(jax.vmap(jsp._slookup, in_axes=(None, 0, 0)))
    for hi in (0, 3):
        lo = jnp.asarray(probes)
        his = jnp.full(len(probes), hi, jnp.uint64)
        want_free = np.asarray(free(jt, lo, his)).tolist()
        want_found, want_slot = (np.asarray(a).tolist() for a in look(jt, lo, his))
        if form == "serial":
            for k, ws, wf, wl in zip(probes.tolist(), want_free, want_found,
                                     want_slot):
                assert tsp._sprobe_free(tt, k, hi) == (ws, False)
                assert tsp._slookup(tt, k, hi) == (wf, wl)
            continue
        # The split form: a key's walk ends at its slot or at the first
        # truly empty one, which is where the reference inserts it.
        vf, vs, vt, vc = tsp._probe_vec(
            tt, convert.array_to_tensor(probes, CPU),
            torch.full((len(probes),), hi, dtype=torch.int64),
            torch.ones(len(probes), dtype=torch.bool))
        mask = tt.capacity - 1
        for i, (k, ws, wf, wl) in enumerate(zip(probes.tolist(), want_free,
                                                want_found, want_slot)):
            found, slot, t, capped = tsp._probe_full(tt, k, hi)
            assert (found, capped) == (wf, False)
            assert slot == (wl if wf else ws)
            assert slot == (tsp._mix64(k, hi) + t) & mask
            assert (bool(vf[i]), int(vs[i]), int(vt[i]), bool(vc[i])) == (
                found, slot, t, capped)
            if not found:
                assert tsp._free_from(tt, (slot - t) & mask, t) == (ws, False)


def test_sprobe_free_at_the_cap_returns_slot_zero(form):
    """No free slot within MAX_PROBE: the reference answers slot 0, and the
    port does too, with its overflow flag raised (each form's probe)."""
    jt = jht.make_table(1 << 10, {"v": jnp.uint64})
    jt = jt.replace(tombstone=jnp.ones(1 << 10, jnp.bool_))
    tt = convert.ledger_from_numpy(
        {**convert.ledger_arrays(jsm.make_ledger(*CAPS)),
         "posted": convert.table_arrays(jt)}, CPU).posted
    assert int(jsp._sprobe_free(jt, jnp.uint64(77), jnp.uint64(0))) == 0
    if form == "serial":
        assert tsp._sprobe_free(tt, 77, 0) == (0, True)
        return
    assert tsp._probe_full(tt, 77, 0) == (False, 0, tsp.MAX_PROBE, True)
    assert tsp._free_from(tt, 5, 0) == (0, True)
    vf, vs, vt, vc = tsp._probe_vec(tt, torch.tensor([77, 0]),
                                    torch.tensor([0, 0]),
                                    torch.tensor([True, True]))
    assert vc.tolist() == [True, True] and vs.tolist() == [0, 0]
    assert vt.tolist() == [tsp.MAX_PROBE] * 2 and not vf.any()


def test_grow_history_matches_jax():
    j = jsm.make_history(1 << 4)
    cols = {k: jnp.arange(1, 17, dtype=jnp.uint64) * (i + 1)
            for i, k in enumerate(j.cols)}
    j = jsm.History(cols=cols, count=jnp.uint64(9))
    t = tsm.History(cols={k: convert.array_to_tensor(np.asarray(v), CPU)
                          for k, v in cols.items()},
                    count=torch.tensor(9, dtype=torch.int64))
    for need in (3, 16, 17, 100):
        jg = jsm.grow_history(j, need)
        tg = tsm.grow_history(t, need)
        assert tg.capacity == jg.capacity
        assert int(tg.count) == int(jg.count)
        for k in jg.cols:
            np.testing.assert_array_equal(convert.tensor_to_array(tg.cols[k]),
                                          np.asarray(jg.cols[k]))
    assert tsm.grow_history(t, 16) is t


def test_kernel_column_orders_match_the_cuda_enums():
    """csrc/sequential.cu reads the batch and table columns by enum; the
    wrappers pass them in these orders."""
    import re
    from pathlib import Path

    src = (Path(tsm.__file__).parents[1] / "csrc" / "sequential.cu").read_text()

    def enum(name, prefix):
        body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
        names = [w.strip() for w in body.replace("\n", " ").split(",")]
        return [w[len(prefix):].lower() for w in names if w.startswith(prefix)
                and not w.endswith("_N")]

    assert enum("SeqTransferBatchCol", "TB_") == list(tsm.TRANSFER_BATCH_COLS)
    assert enum("SeqAccountBatchCol", "AB_") == list(tsm.ACCOUNT_BATCH_COLS)
    assert enum("AccountTableCol", "AT_") == list(tsm.ACCOUNT_COLS)
    assert enum("TransferTableCol", "TT_") == list(tsm.TRANSFER_COLS)
    assert enum("HistoryCol", "H_") == list(tsm.HISTORY_COLS)


def test_prepass_record_layout_matches_the_cuda_enum():
    """csrc/sequential.cu writes K32's records by the SeqRecField enum and
    its RB_* bits; the plain pre-pass and sequencer read them by these
    names, and the wrappers size the undo log by UNDO_WORDS."""
    import re
    from pathlib import Path

    from tigerbeetle_tpu_torch.ops import _cuda

    src = (Path(tsm.__file__).parents[1] / "csrc" / "sequential.cu").read_text()
    body = re.search(r"enum SeqRecField \{(.*?)\};", src, re.S).group(1)
    names = [w.strip() for w in body.replace("\n", " ").split(",")]
    names = [w[2:].lower() for w in names if w.startswith("R_") and w != "R_N"]
    assert names == list(tsp.SEQ_REC_FIELDS)
    words = int(re.search(r"#define REC_WORDS (\d+)", src).group(1))
    assert words == tsp.SEQ_REC_WORDS == _cuda.SEQ_REC_WORDS >= len(names)
    for name in ("ACTIVE", "EFOUND", "ECAP", "PFOUND", "PCAND", "PCLAMP",
                 "LEGS", "DRF", "CRF", "KKEY", "KFOUND", "KCAP"):
        bit = int(re.search(r"#define RB_%s (\d+)ull" % name, src).group(1))
        assert bit == getattr(tsp, "RB_" + name), name
    undo = int(re.search(r"#define UNDO_WORDS (\d+)", src).group(1))
    assert undo == _cuda._UNDO_WORDS
    max_n = int(re.search(r"#define SEQ_MAX_N (\d+)", src).group(1))
    assert max_n == tsp.SEQ_MAX_N == _cuda.SEQ_MAX_N
    slots = int(re.search(r"#define SEQ_MAX_SLOTS \(1ll << (\d+)\)", src).group(1))
    assert 1 << slots == _cuda.SEQ_MAX_SLOTS


@pytest.mark.parametrize("lanes", [tsp.SEQ_MAX_N, tsp.SEQ_MAX_N + 1])
def test_split_form_takes_at_most_the_overlays_lanes(lanes):
    """The sequencer's overlay holds SEQ_MAX_N events.  The split plain form
    runs only the lanes up to the count (rounded up to 64), as the kernel's
    route does, so a batch of that width or wider commits like the serial
    loop; only a count above SEQ_MAX_N is refused (below)."""
    padded = np.zeros(lanes, dtype=types.transfers_array([tr(1)]).dtype)
    padded[0] = types.transfers_array([tr(1, amount=5)])[0]
    soa = convert.soa_to_tensors(types.to_soa(padded), CPU)
    led = [seeded().t, seeded().t]
    _, got, _ = tsp.create_transfers_seq_split_plain(led[0], soa, 1, 10 ** 9)
    _, want, _ = tsp.create_transfers_seq_plain(led[1], soa, 1, 10 ** 9)
    assert got.shape == (lanes,)
    assert torch.equal(got, want) and int(got[0]) == 0
    assert_ledgers_equal(convert.ledger_to_numpy(led[1]),
                         convert.ledger_to_numpy(led[0]), "ledger")


# A machine's batch_lanes past the sequencer's overlay (C7).
WIDE = 2 * tsp.SEQ_MAX_N


@pytest.mark.parametrize("count", [1, 300])
def test_split_form_on_a_batch_wider_than_the_overlay_matches_jax(count):
    """C7: a batch of 16,384 lanes whose count fits the overlay commits on
    the split plain form (the card's algorithm) with the JAX package's
    codes and tables, byte for byte."""
    rng = np.random.default_rng(72 + count)
    p = Pair("split")
    p.accounts(list(seqmix.accounts_batch(rng, 1, 40)), ts=10 ** 9)
    mix = seqmix.TransferMix(rng, list(range(1, 41)), 10 ** 6)
    codes = p.transfers(list(mix.batch(count)), ts=3 * 10 ** 9, lanes=WIDE)
    assert len(codes) == count


def test_split_form_refuses_a_count_above_the_overlay():
    """A count above SEQ_MAX_N is refused before anything is written, with
    a message that names the count."""
    from tigerbeetle_tpu_torch.ops import _cuda

    p = seeded(form="split")
    padded = np.zeros(WIDE, dtype=types.transfers_array([tr(1)]).dtype)
    padded[: tsp.SEQ_MAX_N + 1] = types.transfers_array([tr(1, amount=5)])[0]
    soa = convert.soa_to_tensors(types.to_soa(padded), CPU)
    before = copy.deepcopy(convert.ledger_to_numpy(p.t))  # a CPU view
    with pytest.raises(_cuda.CudaKernelError,
                       match=f"count of {tsp.SEQ_MAX_N + 1} events"):
        tsp.create_transfers_seq_split_plain(p.t, soa, tsp.SEQ_MAX_N + 1,
                                             10 ** 9)
    assert_ledgers_equal(before, convert.ledger_to_numpy(p.t), "ledger")


def _jax_ledger(arrays):
    """A JAX package ledger holding the exchange dict's arrays."""
    def table(d):
        return jht.Table(key_lo=jnp.asarray(d["key_lo"]),
                         key_hi=jnp.asarray(d["key_hi"]),
                         tombstone=jnp.asarray(d["tombstone"]),
                         cols={k: jnp.asarray(v) for k, v in d["cols"].items()},
                         count=jnp.asarray(d["count"]),
                         probe_overflow=jnp.asarray(d["probe_overflow"]))

    h = arrays["history"]
    return jsm.Ledger(accounts=table(arrays["accounts"]),
                      transfers=table(arrays["transfers"]),
                      posted=table(arrays["posted"]),
                      history=jsm.History(
                          cols={k: jnp.asarray(v) for k, v in h["cols"].items()},
                          count=jnp.asarray(h["count"])))


@pytest.mark.parametrize("trap", seqtraps.TRAPS)
def test_seqtraps_batches_match_jax(form, trap):
    """testing/seqtraps.py's cases (what chip_smoke.py holds K6 and K32 to
    at 8,190 events on the card) at the test width, from their own
    ledgers."""
    case = seqtraps.trap_case(trap, LANES)
    p = Pair(form, _jax_ledger(convert.ledger_to_numpy(case["ledger"])))
    codes = p.transfers(list(case["batch"]), ts=case["ts"],
                        overflow=trap == "probe_cap")
    # Every insert of probe_cap lands on slot 0 and is accepted.
    assert len(set(codes)) > (0 if trap == "probe_cap" else 2)


# -- K7's split form: testing/k7cases.py ------------------------------------


def _k7_pair(form, case):
    return Pair(form, _jax_ledger(convert.ledger_to_numpy(case["ledger"])))


@pytest.mark.parametrize("name", [c for c in k7cases.CASES
                                  if c not in k7cases.SIZED])
def test_k7cases_match_jax(form, name):
    """K7's trap cases through both plain forms against the JAX package's
    ``create_accounts_seq``: codes (the lanes past ``count`` too), every
    array of the ledger, ``count`` and the overflow flag."""
    case = k7cases.case(name)
    p = _k7_pair(form, case)
    codes = p.commit("create_accounts_seq", case["batch"], case["ts"],
                     case["overflow"], case["lanes"])
    if name == "codes":
        assert sorted(set(codes)) == [0] + list(range(3, 22))


@pytest.mark.parametrize("n", k7cases.SIZES)
def test_k7_new_distinct_sizes_match_jax(form, n):
    """n new distinct ids into an accounts table a quarter full, at 1,
    8,190 and 16,384 events (K7 has no lane limit)."""
    case = k7cases.case("new_distinct", n)
    p = _k7_pair(form, case)
    assert set(p.commit("create_accounts_seq", case["batch"], case["ts"],
                        False, case["lanes"])) == {0}


@pytest.mark.parametrize("name", k7cases.CASES)
def test_k7cases_reach_their_traps(name):
    """Each case sets the trap it names: the events the sequencer decides,
    a walk that marks a later event, a capped insert that hands the batch
    to the serial loop."""
    facts = k7cases.trap_facts(name)
    assert facts["reached"], facts


def test_k7_split_form_on_the_seqmix_batches_matches_jax():
    """The mix chip_smoke.py holds K7 to (a fresh batch, then one with
    existing ids, chains and repeats) through the split form."""
    rng = np.random.default_rng(33)
    p = Pair("split")
    p.accounts(list(seqmix.accounts_batch(rng, 1, 60)), ts=10 ** 9)
    codes = p.accounts(list(seqmix.accounts_batch(rng, 40, 60)),
                       ts=2 * 10 ** 9)
    assert any(15 <= c <= 21 for c in codes)
