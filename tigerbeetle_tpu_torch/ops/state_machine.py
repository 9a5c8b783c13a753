"""create_accounts / create_transfers commit kernels, the fast path (port of
``tigerbeetle_tpu/ops/state_machine.py``).

The whole 8190-event batch runs as data-parallel device code, as in the JAX
package:

- every validation check is an independent mask, and an event's result code
  is the minimum failing code (the result enums are precedence-ordered);
- intra-batch duplicate ids: the first lane that passes validation inserts,
  later lanes compare against it with the exists ladder;
- linked chains: segmented first-failure propagation;
- balance updates: exact u128 sums of 32-bit limbs, applied once per
  account (kernel K4 instead adds each leg into the lo word with one 64-bit
  atomic and carries the wraps into the hi word: the same sums, in one
  launch).

Preconditions, enforced by the host dispatcher (``machine.py``), which
sends any other batch to the general kernel (``ops/transfer_full.py``), or
every batch to the sequential path (``ops/scan_path.py``) under
``force_sequential``, as the JAX package does:
  P1 no account in the table carries limit or history flags;
  P2 the batch has no balancing_debit/balancing_credit/post/void flags;
  P3 all amounts < 2**64 and every balance is bounded away from 2**128;
  P4 the batch does not combine linked chains with intra-batch duplicates.

The validation ladders (``account_codes``/``transfer_codes``, kernel K3),
the balance update (``apply_balances``, kernel K4) and the digest
(``ledger_digest``, kernel K5) run their hand-written CUDA kernels on CUDA
tensors and the plain PyTorch versions beside them on CPU tensors; the
probes and inserts go through ``hash_table`` (kernels K1 and K2).  The
ledger's tensors are updated in place where the JAX package donated them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from .. import u128
from ..device import resolve as resolve_device
from ..obs.metrics import registry as _metrics
from ..u128 import U128, i64, srl, ult
from . import _cuda
from . import hash_table as ht

MAX_PROBE = 1 << 12

U64 = torch.int64  # u64 bits
U32 = torch.int32  # u32 bits


def _counted(name: str):
    """Count dispatches of an entry point in the metrics registry (one
    attribute load and branch per call while the registry is disabled)."""

    def wrap(fn):
        @functools.wraps(fn)
        def dispatch(*args, **kwargs):
            if _metrics.enabled:
                _metrics.counter("ops.kernel." + name).inc()
            return fn(*args, **kwargs)

        return dispatch

    return wrap


ACCOUNT_COLS = {
    "debits_pending_lo": U64,
    "debits_pending_hi": U64,
    "debits_posted_lo": U64,
    "debits_posted_hi": U64,
    "credits_pending_lo": U64,
    "credits_pending_hi": U64,
    "credits_posted_lo": U64,
    "credits_posted_hi": U64,
    "user_data_128_lo": U64,
    "user_data_128_hi": U64,
    "user_data_64": U64,
    "user_data_32": U32,
    "ledger": U32,
    "code": U32,
    "flags": U32,
    "timestamp": U64,
}

TRANSFER_COLS = {
    "debit_account_id_lo": U64,
    "debit_account_id_hi": U64,
    "credit_account_id_lo": U64,
    "credit_account_id_hi": U64,
    "amount_lo": U64,
    "amount_hi": U64,
    "pending_id_lo": U64,
    "pending_id_hi": U64,
    "user_data_128_lo": U64,
    "user_data_128_hi": U64,
    "user_data_64": U64,
    "user_data_32": U32,
    "timeout": U32,
    "ledger": U32,
    "code": U32,
    "flags": U32,
    "timestamp": U64,
}

POSTED_COLS = {"fulfillment": U32}

HISTORY_COLS = {
    name: U64
    for name in (
        "dr_id_lo", "dr_id_hi",
        "dr_dp_lo", "dr_dp_hi", "dr_dpo_lo", "dr_dpo_hi",
        "dr_cp_lo", "dr_cp_hi", "dr_cpo_lo", "dr_cpo_hi",
        "cr_id_lo", "cr_id_hi",
        "cr_dp_lo", "cr_dp_hi", "cr_dpo_lo", "cr_dpo_hi",
        "cr_cp_lo", "cr_cp_hi", "cr_cpo_lo", "cr_cpo_hi",
        "timestamp",
    )
}

# Account flag bits (tigerbeetle.zig:42-57).
AF_LINKED = 1
AF_DEBITS_MUST_NOT_EXCEED_CREDITS = 2
AF_CREDITS_MUST_NOT_EXCEED_DEBITS = 4
AF_HISTORY = 8
AF_PADDING = 0xFFF0

# Transfer flag bits (tigerbeetle.zig:107-120).
TF_LINKED = 1
TF_PENDING = 2
TF_POST = 4
TF_VOID = 8
TF_BALANCING_DEBIT = 16
TF_BALANCING_CREDIT = 32
TF_PADDING = 0xFFC0

NS_PER_S = 1_000_000_000

BALANCE_FIELDS = (
    "debits_pending", "debits_posted", "credits_pending", "credits_posted",
)
BALANCE_COLS = tuple(f + s for f in BALANCE_FIELDS for s in ("_lo", "_hi"))

VALIDATE_BLOCK = 128  # csrc/validate.cu VALIDATE_THREADS: K3's lanes a block

# Column orders of kernel K3 (csrc/validate.cu's AccountCol/TransferCol
# enums; tests compare the names).
ACCOUNT_BATCH_COLS = (
    "id_lo", "id_hi", *BALANCE_COLS, "user_data_128_lo", "user_data_128_hi",
    "user_data_64", "user_data_32", "reserved", "ledger", "code", "flags",
    "timestamp",
)
ACCOUNT_EXISTS_COLS = (
    "flags", "user_data_128_lo", "user_data_128_hi", "user_data_64",
    "user_data_32", "ledger", "code",
)
TRANSFER_BATCH_COLS = (
    "id_lo", "id_hi", "debit_account_id_lo", "debit_account_id_hi",
    "credit_account_id_lo", "credit_account_id_hi", "amount_lo", "amount_hi",
    "pending_id_lo", "pending_id_hi", "user_data_128_lo", "user_data_128_hi",
    "user_data_64", "user_data_32", "timeout", "ledger", "code", "flags",
    "timestamp",
)
TRANSFER_CTX_COLS = ("dr_found", "cr_found", "dr_ledger", "cr_ledger", "ex_found")
TRANSFER_EXISTS_COLS = (
    "flags", "debit_account_id_lo", "debit_account_id_hi",
    "credit_account_id_lo", "credit_account_id_hi", "amount_lo", "amount_hi",
    "pending_id_lo", "pending_id_hi", "user_data_128_lo", "user_data_128_hi",
    "user_data_64", "user_data_32", "timeout", "code",
)


@dataclasses.dataclass
class History:
    """Append-only history rows (the account_history groove).  The
    sequential path (``ops/scan_path.py``) appends a row per accepted
    regular transfer that touches a HISTORY account; ``count`` is the live
    length."""

    cols: Dict[str, torch.Tensor]
    count: torch.Tensor  # int64 0-dim

    @property
    def capacity(self) -> int:
        return self.cols["timestamp"].shape[0]


def make_history(capacity: int, device) -> History:
    if capacity <= 0 or capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of two, got {capacity}")
    return History(
        cols={
            name: torch.zeros(capacity, dtype=dt, device=device)
            for name, dt in HISTORY_COLS.items()
        },
        count=torch.zeros((), dtype=torch.int64, device=device),
    )


def grow_history(history: History, min_capacity: int) -> History:
    """Host-side capacity doubling (keeps power-of-two sizing): a new
    History whose rows past the old capacity are zero; ``count`` is
    carried."""
    cap = history.capacity
    while cap < min_capacity:
        cap *= 2
    if cap == history.capacity:
        return history
    return History(
        cols={
            name: torch.cat([col, torch.zeros(cap - history.capacity,
                                              dtype=col.dtype,
                                              device=col.device)])
            for name, col in history.cols.items()
        },
        count=history.count,
    )


@dataclasses.dataclass
class Ledger:
    """The full device-resident ledger state."""

    accounts: ht.Table
    transfers: ht.Table
    posted: ht.Table
    history: History

    @property
    def device(self) -> torch.device:
        return self.accounts.device


def make_ledger(
    accounts_capacity: int,
    transfers_capacity: int,
    posted_capacity: int,
    history_capacity: int = 1 << 16,
    device=None,
) -> Ledger:
    """A zeroed ledger on ``device`` (``cuda`` when None; raises with no
    card)."""
    device = resolve_device(device)
    return Ledger(
        accounts=ht.make_table(accounts_capacity, ACCOUNT_COLS, device),
        transfers=ht.make_table(transfers_capacity, TRANSFER_COLS, device),
        posted=ht.make_table(posted_capacity, POSTED_COLS, device),
        history=make_history(history_capacity, device),
    )


# ---------------------------------------------------------------------------
# Shared helpers (plain PyTorch; kernel K3 does the same per lane)
# ---------------------------------------------------------------------------

_BIG = (1 << 31) - 1  # above every result code


def _min_code(n: int, device, *checks: Tuple[torch.Tensor, int]) -> torch.Tensor:
    """Combine (mask, code) checks into the minimum firing code (0 if none)."""
    acc = torch.full((n,), _BIG, dtype=U32, device=device)
    for mask, code in checks:
        acc = torch.where(mask, torch.clamp(acc, max=code), acc)
    return torch.where(acc == _BIG, torch.zeros_like(acc), acc)


def _merge_code(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """min(primary, secondary) treating 0 as 'ok' (no failure)."""
    big = torch.full_like(primary, _BIG)
    m = torch.minimum(torch.where(primary == 0, big, primary),
                      torch.where(secondary == 0, big, secondary))
    return torch.where(m == _BIG, torch.zeros_like(m), m)


class DupInfo(NamedTuple):
    winner_lane: torch.Tensor  # int64[N]: first standalone-ok lane of the id group
    has_winner: torch.Tensor  # bool[N]
    after_winner: torch.Tensor  # bool[N]: lane strictly after its group's winner


def _resolve_duplicates(
    id_lo: torch.Tensor, id_hi: torch.Tensor, standalone_ok: torch.Tensor,
    valid: torch.Tensor,
) -> DupInfo:
    """Intra-batch duplicate ids: among lanes sharing an id, the first that
    passes validation wins (group by id, segmented minimum ok lane)."""
    n = id_lo.shape[0]
    lane = torch.arange(n, device=id_lo.device)
    _, gid = torch.unique(torch.stack([id_hi, id_lo], 1), dim=0,
                          return_inverse=True)
    cand = torch.where(standalone_ok & valid, lane, torch.full_like(lane, n))
    winner_g = torch.full((n,), n, dtype=torch.int64, device=id_lo.device)
    winner_g.scatter_reduce_(0, gid, cand, "amin")
    winner_lane = winner_g[gid]
    has_winner = winner_lane < n
    return DupInfo(winner_lane, has_winner, has_winner & (lane > winner_lane))


def _chain_codes(
    linked: torch.Tensor, codes: torch.Tensor, count: int
) -> torch.Tensor:
    """Linked-chain failure propagation (state_machine.zig:1015-1082): the
    first failing member keeps its code; members before it roll back to
    linked_event_failed (1); members after it get 1, except a linked
    batch-final event, which gets linked_event_chain_open (2)."""
    n = linked.shape[0]
    dev = linked.device
    lane = torch.arange(n, device=dev)
    prev_linked = torch.zeros_like(linked)
    prev_linked[1:] = linked[:-1]
    in_chain = linked | prev_linked
    start = linked & ~prev_linked
    chain_id = torch.cumsum(start.to(torch.int64), 0) - 1

    is_last = lane == count - 1
    two = torch.full_like(codes, 2)
    one = torch.full_like(codes, 1)
    codes_o = torch.where(is_last & linked, two, codes)

    seg = torch.where(in_chain, chain_id, torch.full_like(chain_id, n))
    fail_g = torch.full((n + 1,), n, dtype=torch.int64, device=dev)
    fail_g.scatter_reduce_(
        0, seg,
        torch.where(in_chain & (codes_o != 0), lane, torch.full_like(lane, n)),
        "amin",
    )
    f = fail_g[seg]
    chain_failed = in_chain & (f < n)
    after = torch.where(is_last & linked, two, one)
    out = torch.where(
        lane < f, one, torch.where(lane == f, codes_o, after)
    )
    return torch.where(chain_failed, out, codes_o)


def _u128_col(cols: Dict[str, torch.Tensor], name: str) -> U128:
    return U128(cols[name + "_lo"], cols[name + "_hi"])


def _timestamps(count: int, timestamp: int, n: int, device) -> torch.Tensor:
    # event.timestamp = batch_timestamp - len + index + 1 (u64, wrapping).
    return torch.arange(n, dtype=torch.int64, device=device) + i64(
        timestamp - count + 1
    )


def _valid(n: int, count: int, device) -> torch.Tensor:
    return torch.arange(n, device=device) < count


# ---------------------------------------------------------------------------
# create_accounts
# ---------------------------------------------------------------------------


def _exists_ladder_accounts(
    t: Dict[str, torch.Tensor], e: Dict[str, torch.Tensor], n: int
) -> torch.Tensor:
    """create_account_exists ladder (state_machine.zig:1227-1237), evaluated
    in reverse so higher-precedence checks overwrite."""
    dev = t["flags"].device
    c = torch.full((n,), 21, dtype=U32, device=dev)

    def put(mask, code):
        return torch.where(mask, torch.full_like(c, code), c)

    c = put(t["code"] != e["code"], 20)
    c = put(t["ledger"] != e["ledger"], 19)
    c = put(t["user_data_32"] != e["user_data_32"], 18)
    c = put(t["user_data_64"] != e["user_data_64"], 17)
    c = put((t["user_data_128_lo"] != e["user_data_128_lo"])
            | (t["user_data_128_hi"] != e["user_data_128_hi"]), 16)
    c = put(t["flags"] != e["flags"], 15)
    return c


def account_codes(
    batch: Dict[str, torch.Tensor],
    found: torch.Tensor,
    e: Dict[str, torch.Tensor],
    count: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """create_accounts validation (state_machine.zig:1198-1237): (codes
    int32[N], ok bool[N]).  ``found``/``e`` are the table-existence probe and
    its gather of ``ACCOUNT_EXISTS_COLS``.  Kernel K3 on CUDA tensors."""
    if found.is_cuda:
        cols = [batch[c] for c in ACCOUNT_BATCH_COLS] + [found] + [
            e[c] for c in ACCOUNT_EXISTS_COLS
        ]
        return _cuda.validate("accounts", cols, count)
    return account_codes_plain(batch, found, e, count)


def account_codes_plain(batch, found, e, count):
    """Plain PyTorch version of kernel K3, accounts variant."""
    return _resolve(batch, _account_standalone(batch, found, e),
                    _exists_ladder_accounts, AF_LINKED, count)


def account_codes_split_plain(batch, found, e, count,
                              block: int = VALIDATE_BLOCK):
    """Kernel K3's own steps (accounts), in plain PyTorch: the same codes
    as ``account_codes_plain``."""
    return _resolve_split(batch, _account_standalone(batch, found, e),
                          _exists_ladder_accounts, AF_LINKED, count, block)


def _account_standalone(batch, found, e):
    """Each lane's standalone ladder merged with the exists ladder where the
    id was found (kernel K3's phase 1, accounts)."""
    n = batch["id_lo"].shape[0]
    dev = found.device
    bid = _u128_col(batch, "id")
    flags = batch["flags"]

    exists_code = _exists_ladder_accounts(batch, e, n)
    standalone = _min_code(
        n, dev,
        (batch["timestamp"] != 0, 3),
        (batch["reserved"] != 0, 4),
        ((flags & AF_PADDING) != 0, 5),
        (u128.is_zero(bid), 6),
        (u128.is_max(bid), 7),
        (((flags & AF_DEBITS_MUST_NOT_EXCEED_CREDITS) != 0)
         & ((flags & AF_CREDITS_MUST_NOT_EXCEED_DEBITS) != 0), 8),
        (~u128.is_zero(_u128_col(batch, "debits_pending")), 9),
        (~u128.is_zero(_u128_col(batch, "debits_posted")), 10),
        (~u128.is_zero(_u128_col(batch, "credits_pending")), 11),
        (~u128.is_zero(_u128_col(batch, "credits_posted")), 12),
        (batch["ledger"] == 0, 13),
        (batch["code"] == 0, 14),
    )
    return _merge_code(
        standalone, torch.where(found, exists_code, torch.zeros_like(exists_code))
    )


def _resolve(batch, standalone, ladder, linked_flag, count):
    """Duplicates against their winners, then the chains (the plain
    route: ids grouped by ``torch.unique``, chains by a cumulative sum)."""
    n = standalone.shape[0]
    valid = _valid(n, count, standalone.device)
    bid = _u128_col(batch, "id")
    linked = ((batch["flags"] & linked_flag) != 0) & valid
    dup = _resolve_duplicates(bid.lo, bid.hi, standalone == 0, valid)
    w = dup.winner_lane.clamp(0, n - 1)
    intra = ladder(batch, {k: v[w] for k, v in batch.items()}, n)
    codes = torch.where(
        dup.after_winner, torch.where(standalone == 0, intra, standalone),
        standalone,
    )
    codes = _chain_codes(linked, codes, count)
    return codes, (codes == 0) & valid


def _resolve_split(batch, standalone, ladder, linked_flag, count, block):
    """``_resolve`` as kernel K3 runs it over blocks of ``block`` lanes:
    (1) each id group's winner, the first code-0 lane below the count;
    (2) a later code-0 lane of a group takes the exists ladder against its
    winner, a linked batch-final lane takes 2, and each block records its
    last chain start; (3) a lane's chain start is the last start before its
    block (the blocks' summaries) or in it, and each chain's first failure
    its least failing lane (a minimum by chain start); (4) the rollback."""
    n = standalone.shape[0]
    dev = standalone.device
    lane = torch.arange(n, device=dev)
    valid = lane < count
    flags = batch["flags"]
    linked = ((flags & linked_flag) != 0) & valid
    prev_linked = torch.zeros_like(linked)
    prev_linked[1:] = linked[:-1]
    # (1) The kernel groups lanes in a batch hash table; any grouping by id
    # gives the same groups.
    _, grp = torch.unique(torch.stack([batch["id_hi"], batch["id_lo"]], 1),
                          dim=0, return_inverse=True)
    win = torch.full((n,), n, dtype=torch.int64, device=dev)
    win.scatter_reduce_(0, grp, torch.where((standalone == 0) & valid, lane,
                                            torch.full_like(lane, n)), "amin")
    w = win[grp]
    # (2)
    later = (w < n) & (lane > w) & (standalone == 0)
    intra = ladder(batch, {k: v[w.clamp(max=n - 1)] for k, v in batch.items()},
                   n)
    codes = torch.where(later, intra, standalone)
    codes = torch.where((lane == count - 1) & linked,
                        torch.full_like(codes, 2), codes)
    starts = torch.where(linked & ~prev_linked, lane, torch.full_like(lane, -1))
    blocks = -(-n // block)
    padded = torch.full((blocks * block,), -1, dtype=torch.int64, device=dev)
    padded[:n] = starts
    within = torch.cummax(padded.view(blocks, block), 1).values
    summary = within[:, -1]
    before = torch.full((blocks,), -1, dtype=torch.int64, device=dev)
    if blocks > 1:
        before[1:] = torch.cummax(summary[:-1], 0).values
    # (3)
    cstart = torch.maximum(within, before[:, None]).reshape(-1)[:n]
    in_chain = linked | prev_linked
    fail = torch.full((n,), n, dtype=torch.int64, device=dev)
    failing = in_chain & (codes != 0)
    fail.scatter_reduce_(0, cstart.clamp(min=0)[failing], lane[failing], "amin")
    # (4)
    f = fail[cstart.clamp(min=0)]
    after = torch.where((lane == count - 1) & linked, torch.full_like(codes, 2),
                        torch.ones_like(codes))
    rolled = torch.where(lane < f, torch.ones_like(codes),
                         torch.where(lane == f, codes, after))
    out = torch.where(in_chain & (f < n), rolled, codes)
    return out, (out == 0) & valid


def account_rows(
    batch: Dict[str, torch.Tensor], count: int, timestamp: int
) -> Dict[str, torch.Tensor]:
    """Rows to insert for accepted create_accounts events (assigned timestamps)."""
    n = batch["id_lo"].shape[0]
    ts = _timestamps(count, timestamp, n, batch["id_lo"].device)
    return {name: batch[name] if name != "timestamp" else ts
            for name in ACCOUNT_COLS}


@_counted("create_accounts")
def create_accounts(
    ledger: Ledger, batch: Dict[str, torch.Tensor], count: int, timestamp: int
) -> Tuple[Ledger, torch.Tensor]:
    """Vectorized create_accounts (state_machine.zig:1198-1237).

    ``batch`` is the SoA of the account columns padded to a fixed lane count
    (int64/int32 tensors holding the u64/u32 bits); ``count`` the true event
    count; ``timestamp`` the batch prepare timestamp.  Updates the accounts
    table in place; returns (ledger, codes int32[N]) — 0 is ok."""
    look = ht.lookup(ledger.accounts, batch["id_lo"], batch["id_hi"], MAX_PROBE,
                     count=count, cols=ACCOUNT_EXISTS_COLS)
    codes, ok = account_codes(batch, look.found, look.cols, count)
    rows = account_rows(batch, count, timestamp)
    ht.insert(ledger.accounts, batch["id_lo"], batch["id_hi"], ok, rows,
              MAX_PROBE)
    return ledger, codes


# ---------------------------------------------------------------------------
# create_transfers (fast path)
# ---------------------------------------------------------------------------


class TransferCtx(NamedTuple):
    """Gathered context for transfer validation."""

    dr_found: torch.Tensor
    cr_found: torch.Tensor
    dr_slot: torch.Tensor
    cr_slot: torch.Tensor
    dr: Dict[str, torch.Tensor]  # {"ledger"}
    cr: Dict[str, torch.Tensor]  # {"ledger"}
    ex_found: torch.Tensor
    e: Dict[str, torch.Tensor]  # TRANSFER_EXISTS_COLS


def _exists_ladder_transfers(
    t: Dict[str, torch.Tensor], e: Dict[str, torch.Tensor], n: int
) -> torch.Tensor:
    """create_transfer_exists ladder (state_machine.zig:1370-1389), reverse
    evaluation order so higher-precedence comparisons overwrite."""
    dev = t["flags"].device
    c = torch.full((n,), 46, dtype=U32, device=dev)

    def put(mask, code):
        return torch.where(mask, torch.full_like(c, code), c)

    def ne128(name):
        return (t[name + "_lo"] != e[name + "_lo"]) | (
            t[name + "_hi"] != e[name + "_hi"]
        )

    c = put(t["code"] != e["code"], 45)
    c = put(t["timeout"] != e["timeout"], 44)
    c = put(t["user_data_32"] != e["user_data_32"], 43)
    c = put(t["user_data_64"] != e["user_data_64"], 42)
    c = put(ne128("user_data_128"), 41)
    c = put(ne128("pending_id"), 40)
    c = put(ne128("amount"), 39)
    c = put(ne128("credit_account_id"), 38)
    c = put(ne128("debit_account_id"), 37)
    c = put(t["flags"] != e["flags"], 36)
    return c


def transfer_codes(
    batch: Dict[str, torch.Tensor],
    ctx: TransferCtx,
    count: int,
    timestamp: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """create_transfers validation under P1-P4: (codes int32[N], ok bool[N]).
    Kernel K3 on CUDA tensors."""
    if ctx.dr_found.is_cuda:
        ctx_cols = {"dr_found": ctx.dr_found, "cr_found": ctx.cr_found,
                    "dr_ledger": ctx.dr["ledger"], "cr_ledger": ctx.cr["ledger"],
                    "ex_found": ctx.ex_found}
        cols = ([batch[c] for c in TRANSFER_BATCH_COLS]
                + [ctx_cols[c] for c in TRANSFER_CTX_COLS]
                + [ctx.e[c] for c in TRANSFER_EXISTS_COLS])
        return _cuda.validate("transfers", cols, count, timestamp)
    return transfer_codes_plain(batch, ctx, count, timestamp)


def transfer_codes_plain(batch, ctx, count, timestamp):
    """Plain PyTorch version of kernel K3, transfers variant."""
    return _resolve(batch, _transfer_standalone(batch, ctx, count, timestamp),
                    _exists_ladder_transfers, TF_LINKED, count)


def transfer_codes_split_plain(batch, ctx, count, timestamp,
                               block: int = VALIDATE_BLOCK):
    """Kernel K3's own steps (transfers), in plain PyTorch: the same codes
    as ``transfer_codes_plain``."""
    return _resolve_split(
        batch, _transfer_standalone(batch, ctx, count, timestamp),
        _exists_ladder_transfers, TF_LINKED, count, block)


def _transfer_standalone(batch, ctx, count, timestamp):
    """Each lane's standalone ladder merged with the exists ladder where the
    id was found (kernel K3's phase 1, transfers)."""
    n = batch["id_lo"].shape[0]
    dev = ctx.dr_found.device
    valid = _valid(n, count, dev)
    tid = _u128_col(batch, "id")
    dr_id = _u128_col(batch, "debit_account_id")
    cr_id = _u128_col(batch, "credit_account_id")
    flags = batch["flags"]
    pending = (flags & TF_PENDING) != 0

    ts = _timestamps(count, timestamp, n, dev)
    both = ctx.dr_found & ctx.cr_found
    exists_code = _exists_ladder_transfers(batch, ctx.e, n)

    # overflows_timeout: ts + timeout*1e9 > u64 max (u32 widened unsigned).
    timeout_ns = (batch["timeout"].to(torch.int64) & 0xFFFFFFFF) * NS_PER_S
    ts_sum = ts + timeout_ns
    timeout_overflow = ult(ts_sum, ts)

    standalone = _min_code(
        n, dev,
        (batch["timestamp"] != 0, 3),
        ((flags & TF_PADDING) != 0, 4),
        (u128.is_zero(tid), 5),
        (u128.is_max(tid), 6),
        (u128.is_zero(dr_id), 8),
        (u128.is_max(dr_id), 9),
        (u128.is_zero(cr_id), 10),
        (u128.is_max(cr_id), 11),
        (u128.eq(dr_id, cr_id), 12),
        (~u128.is_zero(_u128_col(batch, "pending_id")), 13),
        (~pending & (batch["timeout"] != 0), 17),
        (u128.is_zero(_u128_col(batch, "amount")), 18),
        (batch["ledger"] == 0, 19),
        (batch["code"] == 0, 20),
        (valid & ~ctx.dr_found, 21),
        (valid & ~ctx.cr_found, 22),
        (both & (ctx.dr["ledger"] != ctx.cr["ledger"]), 23),
        (both & (batch["ledger"] != ctx.dr["ledger"]), 24),
        (timeout_overflow, 53),
    )
    return _merge_code(
        standalone,
        torch.where(ctx.ex_found, exists_code, torch.zeros_like(exists_code)),
    )


class BalancePlan(NamedTuple):
    """Sorted, segment-summed balance deltas keyed by account slot."""

    s_slot: torch.Tensor
    head: torch.Tensor
    deltas: Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def balance_plan(
    dr_slot: torch.Tensor,
    cr_slot: torch.Tensor,
    ok: torch.Tensor,
    amt_lo: torch.Tensor,
    pending: torch.Tensor,
    sentinel: int,
) -> BalancePlan:
    """Exact u128 per-account balance deltas via 32-bit limb segment sums
    (stable sort of the 2N legs by slot, ``index_add_`` of the limbs; each
    limb sum is at most 2 x 8190 terms below 2**32, exact in int64)."""
    n = ok.shape[0]
    dev = ok.device
    ok2 = torch.cat([ok, ok])
    slots2 = torch.where(ok2, torch.cat([dr_slot, cr_slot]),
                         torch.full((2 * n,), sentinel, dtype=torch.int64,
                                    device=dev))
    amt2 = torch.cat([amt_lo, amt_lo])  # P3: amount_hi == 0
    pending2 = torch.cat([pending, pending])
    is_dr2 = torch.cat([torch.ones(n, dtype=torch.bool, device=dev),
                        torch.zeros(n, dtype=torch.bool, device=dev)])

    s_slot, order = torch.sort(slots2, stable=True)
    s_amt = amt2[order]
    s_pending = pending2[order]
    s_is_dr = is_dr2[order]
    s_live = s_slot < sentinel

    head = torch.ones(2 * n, dtype=torch.bool, device=dev)
    head[1:] = s_slot[1:] != s_slot[:-1]
    head &= s_live
    gid = torch.cumsum(head.to(torch.int64), 0) - 1
    gid = torch.where(s_live, gid, torch.full_like(gid, 2 * n))

    a0 = s_amt & 0xFFFFFFFF
    a1 = srl(s_amt, 32)
    fields = (
        ("debits_pending", s_is_dr & s_pending),
        ("debits_posted", s_is_dr & ~s_pending),
        ("credits_pending", ~s_is_dr & s_pending),
        ("credits_posted", ~s_is_dr & ~s_pending),
    )
    zero = torch.zeros_like(a0)
    cols = []
    for _name, mask in fields:
        m = mask & s_live
        cols.append(torch.where(m, a0, zero))
        cols.append(torch.where(m, a1, zero))
    stacked = torch.stack(cols, dim=1)  # (2N, 8)
    summed = torch.zeros((2 * n + 1, 8), dtype=torch.int64, device=dev)
    summed.index_add_(0, gid, stacked)
    per_leg = summed[gid]

    deltas = {}
    for i, (field, _mask) in enumerate(fields):
        sa0 = per_leg[:, 2 * i]
        sa1 = per_leg[:, 2 * i + 1]
        low_part = (sa1 & 0xFFFFFFFF) << 32
        d_lo = sa0 + low_part
        d_hi = srl(sa1, 32) + ult(d_lo, low_part).to(torch.int64)
        deltas[field] = (d_lo, d_hi)
    return BalancePlan(s_slot=s_slot, head=head, deltas=deltas)


def apply_balance_plan(accounts: ht.Table, plan: BalancePlan) -> ht.Table:
    """Gather old + add delta + scatter at group heads (unique slots), in place."""
    head_valid = plan.head & (plan.s_slot < accounts.capacity)
    slot = torch.where(head_valid, plan.s_slot, torch.zeros_like(plan.s_slot))
    acc = ht.gather_cols(accounts, slot, head_valid, BALANCE_COLS)
    updates = {}
    for field, (d_lo, d_hi) in plan.deltas.items():
        new, _ = u128.add(_u128_col(acc, field), U128(d_lo, d_hi))  # P3
        updates[field + "_lo"] = new.lo
        updates[field + "_hi"] = new.hi
    return ht.scatter_cols(accounts, slot, head_valid, updates)


def apply_balances(
    accounts: ht.Table,
    dr_slot: torch.Tensor,
    cr_slot: torch.Tensor,
    ok: torch.Tensor,
    amt_lo: torch.Tensor,
    pending: torch.Tensor,
) -> ht.Table:
    """Add every accepted transfer's amount to its accounts' balances, in
    place (``balance_plan`` + ``apply_balance_plan``).  Kernel K4 on CUDA
    tensors: one launch, no scratch."""
    if ok.is_cuda:
        _cuda.balance(dr_slot, cr_slot, ok, amt_lo, pending,
                      [accounts.cols[c] for c in BALANCE_COLS])
        return accounts
    return apply_balance_plan(
        accounts,
        balance_plan(dr_slot, cr_slot, ok, amt_lo, pending, accounts.capacity),
    )


def transfer_rows(
    batch: Dict[str, torch.Tensor], count: int, timestamp: int
) -> Dict[str, torch.Tensor]:
    """Rows to insert for accepted create_transfers events."""
    n = batch["id_lo"].shape[0]
    ts = _timestamps(count, timestamp, n, batch["id_lo"].device)
    return {name: batch[name] if name != "timestamp" else ts
            for name in TRANSFER_COLS}


def _create_transfers(ledger, batch, count, timestamp):
    # The three probes are one K1 launch; no overflow flag is asked for
    # (the fast path's preconditions keep the tables' probes short, and the
    # insert raises the transfers table's own flag).
    dr, cr, ex = ht.lookup_many([
        ht.Lookup(ledger.accounts, batch["debit_account_id_lo"],
                  batch["debit_account_id_hi"], ("ledger",), count=count),
        ht.Lookup(ledger.accounts, batch["credit_account_id_lo"],
                  batch["credit_account_id_hi"], ("ledger",), count=count),
        ht.Lookup(ledger.transfers, batch["id_lo"], batch["id_hi"],
                  TRANSFER_EXISTS_COLS, count=count),
    ], MAX_PROBE, overflow=False)
    ctx = TransferCtx(
        dr_found=dr.found, cr_found=cr.found, dr_slot=dr.slot, cr_slot=cr.slot,
        dr=dr.cols, cr=cr.cols, ex_found=ex.found, e=ex.cols,
    )
    codes, ok = transfer_codes(batch, ctx, count, timestamp)
    pending = (batch["flags"] & TF_PENDING) != 0
    apply_balances(ledger.accounts, dr.slot, cr.slot, ok, batch["amount_lo"],
                   pending)
    rows = transfer_rows(batch, count, timestamp)
    ht.insert(ledger.transfers, batch["id_lo"], batch["id_hi"], ok, rows,
              MAX_PROBE)
    return ledger, codes


@_counted("create_transfers_fast")
def create_transfers_fast(
    ledger: Ledger, batch: Dict[str, torch.Tensor], count: int, timestamp: int
) -> Tuple[Ledger, torch.Tensor]:
    """Vectorized create_transfers under preconditions P1-P4 (module
    docstring): three probes (K1), validation (K3), balances (K4) and the
    insert (K2).  Updates the ledger in place; returns (ledger, codes)."""
    return _create_transfers(ledger, batch, count, timestamp)


@_counted("create_transfers_fast_probed")
def create_transfers_fast_probed(
    ledger: Ledger, batch: Dict[str, torch.Tensor], count: int, timestamp: int
):
    """The fast kernel plus the transfers probe_overflow flag as an int32
    tensor of its own, and the batch's id columns: (ledger, codes, overflow,
    id_lo, id_hi)."""
    ledger, codes = _create_transfers(ledger, batch, count, timestamp)
    return (ledger, codes, ledger.transfers.probe_overflow.to(torch.int32),
            batch["id_lo"], batch["id_hi"])


# ---------------------------------------------------------------------------
# Lookups (state_machine.zig:1091-1126)
# ---------------------------------------------------------------------------


def _lookup_table(table: ht.Table, id_lo, id_hi):
    look = ht.lookup(table, id_lo, id_hi, MAX_PROBE, cols=tuple(table.cols))
    cols = dict(look.cols)
    zero = torch.zeros_like(id_lo)
    cols["id_lo"] = torch.where(look.found, id_lo, zero)
    cols["id_hi"] = torch.where(look.found, id_hi, zero)
    return look.found, cols


@_counted("lookup_accounts")
def lookup_accounts(
    ledger: Ledger, id_lo: torch.Tensor, id_hi: torch.Tensor
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    return _lookup_table(ledger.accounts, id_lo, id_hi)


@_counted("lookup_transfers")
def lookup_transfers(
    ledger: Ledger, id_lo: torch.Tensor, id_hi: torch.Tensor
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    return _lookup_table(ledger.transfers, id_lo, id_hi)


# ---------------------------------------------------------------------------
# Parity digest
# ---------------------------------------------------------------------------


def ledger_digest(ledger: Ledger) -> torch.Tensor:
    """Order-independent digest of all account balances: the wrapping u64
    sum over live slots of a mix64 chain over (id, balances, timestamp), as
    a 0-dim int64 tensor holding the u64 bits.  Kernel K5 on CUDA tensors."""
    a = ledger.accounts
    cols = [a.cols[c] for c in BALANCE_COLS] + [a.cols["timestamp"]]
    if a.key_lo.is_cuda:
        return _cuda.digest(a.key_lo, a.key_hi, cols)
    return ledger_digest_plain(a.key_lo, a.key_hi, cols)


def ledger_digest_plain(key_lo, key_hi, cols) -> torch.Tensor:
    """Plain PyTorch version of kernel K5."""
    live = (key_lo != 0) | (key_hi != 0)
    h = u128.mix64(key_lo, key_hi)
    for f in range(4):
        h = u128.mix64(h ^ cols[2 * f], h ^ cols[2 * f + 1])
    h = u128.mix64(h, cols[8])
    return torch.where(live, h, torch.zeros_like(h)).sum()
