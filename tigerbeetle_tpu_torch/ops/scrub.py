"""Device fault domain: the scrub digest, the host mirror, re-materialization
(port of ``tigerbeetle_tpu/ops/scrub.py``).

- ``scrub_digest``: the (accounts, transfers, posted) live-column folds of
  the ledger pads as one int64[3] tensor (u64 bits): per live slot a chained
  ``mix64`` over the key and the digested columns, wrap-summed per pad.
  Kernel K21 (``csrc/scrub.cu``) on CUDA tensors, in one launch over the
  three pads; the plain PyTorch version (``row_hash_*``, ``leaf_hashes``,
  ``scrub_digest_plain``) on CPU tensors.  The accounts fold is bit for bit
  ``state_machine.ledger_digest`` (K5).
- ``mirror_digests``: the expected digests, in numpy, from the host mirror
  (a ``testing.model.ReferenceStateMachine``); ``model_from_ledger`` seeds
  that mirror from a verified ledger; ``materialize_ledger`` rebuilds a
  fresh ledger from it, inserting every key through the port's
  ``hash_table.insert`` (K2 on the card) in the reference's order, so the
  slots, and with them the Merkle roots and proofs, equal the JAX
  machine's after a recovery.  These numpy twins are kept line for line
  with the reference (``tests/test_torch_kernels.py`` compares them), apart
  from reading the port's tensors.

The device-fault family (``DEVICE_FAULT_TYPES``), which the machine's
dispatch funnels retry and recover from: ``SimulatedDeviceFault`` (an
injected fault, ``machine.inject_device_faults``), ``torch.AcceleratorError``
(a CUDA error the runtime reports: an illegal address, a lost device) where
the installed torch has it, and ``ops._cuda.CudaKernelError`` (a
hand-written kernel's launch, or a graph's capture or replay, failed).  The
funnels re-dispatch a ``CudaKernelError`` on the device but never degrade
it to the host engine: at the fault limit it raises.  Never bare
``RuntimeError``:
the machine's own integrity errors (probe overflow, a digest mismatch) must
not route into dispatch retry.

Coverage: the folds cover the accounts pad (id, the four balances,
timestamp), the transfers pad (id, amount, timestamp) and the posted pad
(pending timestamp, fulfillment).  History rows and other columns are not
scrubbed.  The transfers fold is comparable only while the cold tier is
empty; ``machine.scrub_check`` skips it once spill runs exist.
``build_host_ledger`` (the host engine's ledger) comes with the host engine
(ROADMAP A6).
"""

from __future__ import annotations

import types as _pytypes
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from .. import convert
from ..u128 import mix64
from . import _cuda
from . import hash_table as ht
from . import state_machine as sm

U64_MASK = (1 << 64) - 1

_BALANCE_FIELDS = (
    "debits_pending", "debits_posted", "credits_pending", "credits_posted",
)


class SimulatedDeviceFault(RuntimeError):
    """Injected device-dispatch failure (tests / fault schedules): raised
    from the machine's read-back funnel when ``inject_device_faults`` armed
    one, standing in for a CUDA error of a real failed launch."""


class DeviceStateUnrecoverable(RuntimeError):
    """The device state is corrupt or failing AND the in-process mirror
    recovery cannot apply (mirror suspect, cold tier active, no mirror
    armed).  The replica layer answers it with checkpoint + WAL replay."""


def _device_fault_types() -> tuple:
    kinds: List[type] = [SimulatedDeviceFault]
    accel = getattr(torch, "AcceleratorError", None)
    if isinstance(accel, type):
        kinds.append(accel)
    kinds.append(_cuda.CudaKernelError)
    return tuple(dict.fromkeys(kinds))


# The exception family the dispatch funnels treat as "the device failed".
DEVICE_FAULT_TYPES = _device_fault_types()


# ---------------------------------------------------------------------------
# The scrub fold (kernel K21; plain PyTorch beside it)
# ---------------------------------------------------------------------------


def row_hash_accounts(key_lo, key_hi, cols) -> torch.Tensor:
    """Per-row account fold (the scrub fold's per-slot term, and the Merkle
    leaf value, ``ops/merkle.py``).  ``cols`` may be full columns or
    gathered lanes; shapes follow the inputs."""
    h = mix64(key_lo, key_hi)
    for f in _BALANCE_FIELDS:
        h = mix64(h ^ cols[f + "_lo"], h ^ cols[f + "_hi"])
    return mix64(h, cols["timestamp"])


def row_hash_transfers(key_lo, key_hi, cols) -> torch.Tensor:
    h = mix64(key_lo, key_hi)
    h = mix64(h ^ cols["amount_lo"], h ^ cols["amount_hi"])
    return mix64(h, cols["timestamp"])


def row_hash_posted(key_lo, key_hi, cols) -> torch.Tensor:
    h = mix64(key_lo, key_hi)
    # fulfillment is u32 bits in an int32: widen without sign extension.
    return mix64(h, cols["fulfillment"].to(torch.int64) & 0xFFFFFFFF)


ROW_HASH = {
    "accounts": row_hash_accounts,
    "transfers": row_hash_transfers,
    "posted": row_hash_posted,
}


def leaf_hashes(table: ht.Table, row_hash) -> torch.Tensor:
    """int64[capacity] per-slot live-masked row folds: the scrub fold's
    addends, and the Merkle tree's leaf level (``ops/merkle.py``)."""
    live = (table.key_lo != 0) | (table.key_hi != 0)
    h = row_hash(table.key_lo, table.key_hi, table.cols)
    return torch.where(live, h, torch.zeros_like(h))


def _fold_accounts(a: ht.Table) -> torch.Tensor:
    """Bit-identical to ``state_machine.ledger_digest``."""
    return torch.sum(leaf_hashes(a, row_hash_accounts))


def _fold_transfers(t: ht.Table) -> torch.Tensor:
    return torch.sum(leaf_hashes(t, row_hash_transfers))


def _fold_posted(p: ht.Table) -> torch.Tensor:
    return torch.sum(leaf_hashes(p, row_hash_posted))


def scrub_digest(ledger: sm.Ledger) -> torch.Tensor:
    """int64[3] = (accounts, transfers, posted) live-column folds (u64
    bits).  Reads the ledger and never changes it.  Kernel K21 on CUDA
    tensors."""
    if ledger.accounts.key_lo.is_cuda:
        return _cuda.scrub_fold({
            name: (t.key_lo, t.key_hi, t.cols)
            for name, t in (("accounts", ledger.accounts),
                            ("transfers", ledger.transfers),
                            ("posted", ledger.posted))})
    return scrub_digest_plain(ledger)


def scrub_digest_plain(ledger: sm.Ledger) -> torch.Tensor:
    """Plain PyTorch version of kernel K21."""
    return torch.stack([
        _fold_accounts(ledger.accounts),
        _fold_transfers(ledger.transfers),
        _fold_posted(ledger.posted),
    ])


# ---------------------------------------------------------------------------
# Host-side numpy twins (the expected digests, from the mirror model)
# ---------------------------------------------------------------------------

_K1 = np.uint64(0x9E3779B97F4A7C15)
_K2 = np.uint64(0xBF58476D1CE4E5B9)
_K3 = np.uint64(0x94D049BB133111EB)


def mix64_np(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """numpy twin of u128.mix64 (same splitmix64 finalizer, uint64 wrap)."""
    with np.errstate(over="ignore"):
        x = lo ^ (hi * _K1)
        x = (x ^ (x >> np.uint64(30))) * _K2
        x = (x ^ (x >> np.uint64(27))) * _K3
        return x ^ (x >> np.uint64(31))


def _limbs(values: List[int]) -> Tuple[np.ndarray, np.ndarray]:
    lo = np.fromiter(
        (v & U64_MASK for v in values), dtype=np.uint64, count=len(values)
    )
    hi = np.fromiter(
        ((v >> 64) & U64_MASK for v in values),
        dtype=np.uint64, count=len(values),
    )
    return lo, hi


def _wrap_sum(h: np.ndarray) -> int:
    with np.errstate(over="ignore"):
        return int(np.sum(h, dtype=np.uint64)) if len(h) else 0


def mirror_digests(model) -> Tuple[int, int, int]:
    """(accounts, transfers, posted) expected digests from the mirror
    model, matching scrub_digest's device folds value-for-value."""
    accounts = list(model.accounts.values())
    if accounts:
        id_lo, id_hi = _limbs([a.id for a in accounts])
        h = mix64_np(id_lo, id_hi)
        for f in _BALANCE_FIELDS:
            lo, hi = _limbs([getattr(a, f) for a in accounts])
            h = mix64_np(h ^ lo, h ^ hi)
        ts = np.fromiter(
            (a.timestamp for a in accounts), np.uint64, count=len(accounts)
        )
        acc = _wrap_sum(mix64_np(h, ts))
    else:
        acc = 0
    transfers = list(model.transfers.values())
    if transfers:
        id_lo, id_hi = _limbs([t.id for t in transfers])
        h = mix64_np(id_lo, id_hi)
        lo, hi = _limbs([t.amount for t in transfers])
        h = mix64_np(h ^ lo, h ^ hi)
        ts = np.fromiter(
            (t.timestamp for t in transfers), np.uint64, count=len(transfers)
        )
        tr = _wrap_sum(mix64_np(h, ts))
    else:
        tr = 0
    posted = list(model.posted.items())
    if posted:
        key = np.fromiter((ts for ts, _ in posted), np.uint64, count=len(posted))
        ful = np.fromiter(
            ((1 if kind == "posted" else 2) for _, kind in posted),
            np.uint64, count=len(posted),
        )
        po = _wrap_sum(mix64_np(mix64_np(key, np.zeros_like(key)), ful))
    else:
        po = 0
    return acc, tr, po


# ---------------------------------------------------------------------------
# Mirror seeding: ReferenceStateMachine from a verified ledger snapshot
# ---------------------------------------------------------------------------

# model history dict key -> device HISTORY_COLS (lo, hi) column names.
_HIST_U128 = {
    "dr_account_id": ("dr_id_lo", "dr_id_hi"),
    "dr_debits_pending": ("dr_dp_lo", "dr_dp_hi"),
    "dr_debits_posted": ("dr_dpo_lo", "dr_dpo_hi"),
    "dr_credits_pending": ("dr_cp_lo", "dr_cp_hi"),
    "dr_credits_posted": ("dr_cpo_lo", "dr_cpo_hi"),
    "cr_account_id": ("cr_id_lo", "cr_id_hi"),
    "cr_debits_pending": ("cr_dp_lo", "cr_dp_hi"),
    "cr_debits_posted": ("cr_dpo_lo", "cr_dpo_hi"),
    "cr_credits_pending": ("cr_cp_lo", "cr_cp_hi"),
    "cr_credits_posted": ("cr_cpo_lo", "cr_cpo_hi"),
}


def _join(lo, hi) -> int:
    return int(lo) | (int(hi) << 64)


def _np_table(t: ht.Table):
    return _pytypes.SimpleNamespace(
        key_lo=convert.tensor_to_array(t.key_lo),
        key_hi=convert.tensor_to_array(t.key_hi),
        cols={k: convert.tensor_to_array(v) for k, v in t.cols.items()},
    )


def _np_ledger(ledger: sm.Ledger):
    """The ledger's arrays as numpy (u64/u32), laid out as the reference's
    ``model_from_ledger`` reads a JAX ledger."""
    return _pytypes.SimpleNamespace(
        accounts=_np_table(ledger.accounts),
        transfers=_np_table(ledger.transfers),
        posted=_np_table(ledger.posted),
        history=_pytypes.SimpleNamespace(
            cols={k: convert.tensor_to_array(v)
                  for k, v in ledger.history.cols.items()},
            count=convert.tensor_to_array(ledger.history.count),
        ),
    )


def model_from_ledger(
    ledger: sm.Ledger,
    cold_rows: Iterable[np.ndarray] = (),
    prepare_timestamp: int = 0,
    commit_timestamp: int = 0,
):
    """Seed a ReferenceStateMachine mirror from a VERIFIED device ledger
    (genesis, a digest-checked checkpoint restore, or a just-recovered
    state).  ``cold_rows``: the cold store's spilled TRANSFER_DTYPE runs —
    the mirror must know every transfer, hot or cold, for exists/post
    semantics to stay exact."""
    from ..testing import model as M

    ledger = _np_ledger(ledger)
    m = M.ReferenceStateMachine()

    a = ledger.accounts
    key_lo, key_hi = np.asarray(a.key_lo), np.asarray(a.key_hi)
    cols = {name: np.asarray(col) for name, col in a.cols.items()}
    for slot in np.flatnonzero((key_lo != 0) | (key_hi != 0)):
        acct = M.Account(
            id=_join(key_lo[slot], key_hi[slot]),
            timestamp=int(cols["timestamp"][slot]),
            ledger=int(cols["ledger"][slot]),
            code=int(cols["code"][slot]),
            flags=int(cols["flags"][slot]),
            user_data_128=_join(
                cols["user_data_128_lo"][slot], cols["user_data_128_hi"][slot]
            ),
            user_data_64=int(cols["user_data_64"][slot]),
            user_data_32=int(cols["user_data_32"][slot]),
        )
        for f in _BALANCE_FIELDS:
            setattr(acct, f, _join(cols[f + "_lo"][slot], cols[f + "_hi"][slot]))
        m.accounts[acct.id] = acct

    t = ledger.transfers
    key_lo, key_hi = np.asarray(t.key_lo), np.asarray(t.key_hi)
    cols = {name: np.asarray(col) for name, col in t.cols.items()}
    for slot in np.flatnonzero((key_lo != 0) | (key_hi != 0)):
        tr = M.Transfer(
            id=_join(key_lo[slot], key_hi[slot]),
            debit_account_id=_join(
                cols["debit_account_id_lo"][slot],
                cols["debit_account_id_hi"][slot],
            ),
            credit_account_id=_join(
                cols["credit_account_id_lo"][slot],
                cols["credit_account_id_hi"][slot],
            ),
            amount=_join(cols["amount_lo"][slot], cols["amount_hi"][slot]),
            pending_id=_join(
                cols["pending_id_lo"][slot], cols["pending_id_hi"][slot]
            ),
            user_data_128=_join(
                cols["user_data_128_lo"][slot], cols["user_data_128_hi"][slot]
            ),
            user_data_64=int(cols["user_data_64"][slot]),
            user_data_32=int(cols["user_data_32"][slot]),
            timeout=int(cols["timeout"][slot]),
            ledger=int(cols["ledger"][slot]),
            code=int(cols["code"][slot]),
            flags=int(cols["flags"][slot]),
            timestamp=int(cols["timestamp"][slot]),
        )
        m.transfers[tr.id] = tr
    for run in cold_rows:
        for row in np.asarray(run):
            tr = M.transfer_from_row(row)
            m.transfers.setdefault(tr.id, tr)

    p = ledger.posted
    key_lo, key_hi = np.asarray(p.key_lo), np.asarray(p.key_hi)
    ful = np.asarray(p.cols["fulfillment"])
    for slot in np.flatnonzero((key_lo != 0) | (key_hi != 0)):
        m.posted[int(key_lo[slot])] = (
            "posted" if int(ful[slot]) == 1 else "voided"
        )

    hist = ledger.history
    n_hist = int(hist.count)
    if n_hist:
        hcols = {name: np.asarray(col) for name, col in hist.cols.items()}
        for i in range(n_hist):
            row = {
                key: _join(hcols[lo][i], hcols[hi][i])
                for key, (lo, hi) in _HIST_U128.items()
            }
            row["timestamp"] = int(hcols["timestamp"][i])
            m.history[row["timestamp"]] = row

    m.prepare_timestamp = int(prepare_timestamp)
    m.commit_timestamp = int(commit_timestamp)
    return m


# ---------------------------------------------------------------------------
# Re-materialization: a fresh ledger from the mirror
# ---------------------------------------------------------------------------


def _grown(capacity: int, rows: int) -> int:
    while rows * 2 > capacity:
        capacity *= 2
    return capacity


def _pad_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length()) if n else 1


def _insert_all(table: ht.Table, id_lo, id_hi, rows: Dict[str, np.ndarray]):
    """One padded batched insert of distinct keys (probe-overflow-checked),
    through the port's ``hash_table.insert`` (K2 on the card)."""
    n = len(id_lo)
    if n == 0:
        return table
    dev = table.device
    lanes = _pad_pow2(n)
    pad_lo = np.zeros(lanes, np.uint64)
    pad_hi = np.zeros(lanes, np.uint64)
    pad_lo[:n], pad_hi[:n] = id_lo, id_hi
    mask = np.zeros(lanes, bool)
    mask[:n] = True
    padded_rows = {}
    for name, col in rows.items():
        buf = np.zeros(lanes, col.dtype)
        buf[:n] = col
        padded_rows[name] = convert.array_to_tensor(buf, dev)
    table, _ = ht.insert(
        table, convert.array_to_tensor(pad_lo, dev),
        convert.array_to_tensor(pad_hi, dev), convert.array_to_tensor(mask, dev),
        padded_rows, max_probe=table.capacity,
    )
    if bool(table.probe_overflow):
        raise DeviceStateUnrecoverable(
            "re-materialization probe overflow (capacity planning violated)"
        )
    return table


def _account_arrays(model):
    items = sorted(model.accounts.values(), key=lambda a: a.id)
    id_lo, id_hi = _limbs([a.id for a in items])
    rows: Dict[str, np.ndarray] = {}
    for f in _BALANCE_FIELDS + ("user_data_128",):
        lo, hi = _limbs([getattr(a, f) for a in items])
        rows[f + "_lo"], rows[f + "_hi"] = lo, hi
    rows["user_data_64"] = np.fromiter(
        (a.user_data_64 for a in items), np.uint64, count=len(items))
    rows["user_data_32"] = np.fromiter(
        (a.user_data_32 for a in items), np.uint32, count=len(items))
    rows["ledger"] = np.fromiter(
        (a.ledger for a in items), np.uint32, count=len(items))
    rows["code"] = np.fromiter(
        (a.code for a in items), np.uint32, count=len(items))
    rows["flags"] = np.fromiter(
        (a.flags for a in items), np.uint32, count=len(items))
    rows["timestamp"] = np.fromiter(
        (a.timestamp for a in items), np.uint64, count=len(items))
    return id_lo, id_hi, rows


def _transfer_arrays(model):
    items = sorted(model.transfers.values(), key=lambda t: t.id)
    id_lo, id_hi = _limbs([t.id for t in items])
    rows: Dict[str, np.ndarray] = {}
    for f in ("debit_account_id", "credit_account_id", "amount",
              "pending_id", "user_data_128"):
        lo, hi = _limbs([getattr(t, f) for t in items])
        rows[f + "_lo"], rows[f + "_hi"] = lo, hi
    rows["user_data_64"] = np.fromiter(
        (t.user_data_64 for t in items), np.uint64, count=len(items))
    rows["user_data_32"] = np.fromiter(
        (t.user_data_32 for t in items), np.uint32, count=len(items))
    rows["timeout"] = np.fromiter(
        (t.timeout for t in items), np.uint32, count=len(items))
    rows["ledger"] = np.fromiter(
        (t.ledger for t in items), np.uint32, count=len(items))
    rows["code"] = np.fromiter(
        (t.code for t in items), np.uint32, count=len(items))
    rows["flags"] = np.fromiter(
        (t.flags for t in items), np.uint32, count=len(items))
    rows["timestamp"] = np.fromiter(
        (t.timestamp for t in items), np.uint64, count=len(items))
    return id_lo, id_hi, rows


def _posted_arrays(model):
    items = sorted(model.posted.items())
    key = np.fromiter((ts for ts, _ in items), np.uint64, count=len(items))
    ful = np.fromiter(
        ((1 if kind == "posted" else 2) for _, kind in items),
        np.uint32, count=len(items),
    )
    return key, np.zeros_like(key), {"fulfillment": ful}


def _history_arrays(model) -> Tuple[Dict[str, np.ndarray], int]:
    items = [model.history[ts] for ts in sorted(model.history)]
    n = len(items)
    cols: Dict[str, np.ndarray] = {}
    for key, (lo_name, hi_name) in _HIST_U128.items():
        lo, hi = _limbs([h[key] for h in items])
        cols[lo_name], cols[hi_name] = lo, hi
    cols["timestamp"] = np.fromiter(
        (h["timestamp"] for h in items), np.uint64, count=n)
    return cols, n


def materialize_ledger(model, ledger_config, device=None) -> sm.Ledger:
    """Fresh ledger on ``device`` with the mirror's exact content (recovery).

    Capacities derive from the config floor grown to the mirror's row
    counts (load factor <= 0.5, the host growth policy); keys are inserted
    sorted by id, in one batch a table, as the reference inserts them, so
    the layout equals the JAX machine's re-materialized one."""
    cfg = ledger_config
    acc_lo, acc_hi, acc_rows = _account_arrays(model)
    tr_lo, tr_hi, tr_rows = _transfer_arrays(model)
    po_lo, po_hi, po_rows = _posted_arrays(model)
    hist_cols, hist_n = _history_arrays(model)

    accounts = _insert_all(
        ht.make_table(
            _grown(cfg.accounts_capacity, len(acc_lo)), sm.ACCOUNT_COLS,
            device,
        ),
        acc_lo, acc_hi, acc_rows,
    )
    transfers = _insert_all(
        ht.make_table(
            _grown(cfg.transfers_capacity, len(tr_lo)), sm.TRANSFER_COLS,
            device,
        ),
        tr_lo, tr_hi, tr_rows,
    )
    posted = _insert_all(
        ht.make_table(_grown(cfg.posted_capacity, len(po_lo)), sm.POSTED_COLS,
                      device),
        po_lo, po_hi, po_rows,
    )
    hist_cap = cfg.history_capacity
    while hist_cap < hist_n:
        hist_cap *= 2
    hcols = {}
    for name in sm.HISTORY_COLS:
        buf = np.zeros(hist_cap, np.uint64)
        if hist_n:
            buf[:hist_n] = hist_cols[name]
        hcols[name] = convert.array_to_tensor(buf, device)
    history = sm.History(
        cols=hcols, count=torch.tensor(hist_n, dtype=torch.int64, device=device))
    return sm.Ledger(
        accounts=accounts, transfers=transfers, posted=posted, history=history
    )


def build_host_ledger(model, ledger_config):
    """HostLedger (native engine numpy ledger) with the mirror's content —
    the degrade-to-host_engine target.  Pure host-side: the probe-insert
    runs in numpy/python (mix64 home slot + linear probe, the exact
    hash_table.py discipline), so a failing device is never touched."""
    from ..host_engine import HostLedger

    cfg = ledger_config
    acc_lo, acc_hi, acc_rows = _account_arrays(model)
    tr_lo, tr_hi, tr_rows = _transfer_arrays(model)
    po_lo, po_hi, po_rows = _posted_arrays(model)
    hist_cols, hist_n = _history_arrays(model)

    hist_cap = cfg.history_capacity
    while hist_cap < hist_n:
        hist_cap *= 2
    led = HostLedger(
        _grown(cfg.accounts_capacity, len(acc_lo)),
        _grown(cfg.transfers_capacity, len(tr_lo)),
        _grown(cfg.posted_capacity, len(po_lo)),
        history_capacity=hist_cap,
    )

    def fill(table, key_lo, key_hi, rows):
        cap = table.capacity
        mask = np.uint64(cap - 1)
        occupied = np.zeros(cap, bool)
        home = mix64_np(key_lo, key_hi) & mask
        cols = table.cols  # device-column-name views into the AoS rows
        for i in range(len(key_lo)):
            slot = int(home[i])
            while occupied[slot]:
                slot = (slot + 1) & int(mask)
            occupied[slot] = True
            table.rows["key_lo"][slot] = key_lo[i]
            table.rows["key_hi"][slot] = key_hi[i]
            for name, col in rows.items():
                cols[name][slot] = col[i]
        table.count = len(key_lo)

    fill(led.accounts, acc_lo, acc_hi, acc_rows)
    fill(led.transfers, tr_lo, tr_hi, tr_rows)
    fill(led.posted, po_lo, po_hi, po_rows)
    for name in led.history:
        if hist_n:
            led.history[name][:hist_n] = hist_cols[name]
    led.history_count = hist_n
    return led
