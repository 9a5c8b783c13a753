"""The sharded ledger: tables partitioned over a mesh of shards (port of
``tigerbeetle_tpu/parallel/sharded.py``).

Ownership is the JAX package's, bit for bit: a key belongs to shard
``mix64(key) & (n - 1)`` and lives in that shard's local open-addressing
table of C/n slots at home ``(mix64(key) >> log2 n) & (C/n - 1)``, so probe
chains never leave a shard, and every local table array, ``count`` and
``probe_overflow`` equal the JAX package's shard slice.

Every step has the reference's three phases:

- gather: every shard probes its local table for the whole batch, masked to
  the keys it owns (``_ShardGather``: kernel K30, all the shards of a device
  in one launch, into the device's one packed answer row: a lane's answer
  comes from its owner shard, so the sum over a device's shards is written
  directly), and across cards one NCCL all-reduce per round sums the
  devices' rows (``Mesh.psum_rows``), after which every device holds the
  full gather context;
- validate: the pure passes run replicated, once per device (the shards of
  a device would compute the same values): K3, or the general kernel's core
  K9, K11 and K12;
- apply: balance deltas are planned over global slots and each shard
  writes only its own slot range (K4 and K10's scatter in their slot-base
  forms); inserts and claims are owner-masked local K2 launches with the
  local ``hash_shift``.

The terms of every psum are disjoint (owner-masked) and every write is
owner-local, so the result equals the single-device kernels' byte for byte,
as in the JAX package, whose tests run an 8-shard mesh on virtual CPU
devices; the port's run ``device.force_virtual(8, "cpu")``.

History-flagged accounts route the general step (``FLAG_SEQ``), as in the
JAX package: the history log is an append-ordered log, replicated (one copy
on the mesh's first device) and written only by the machine's sequential
window.  The host converters (``unshard_ledger``, ``shard_ledger``,
``grow_sharded_table``, ``split_moved_mask``) are the JAX package's numpy
code line for line.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import convert
from ..ops import _cuda
from ..ops import hash_table as ht
from ..ops import merkle as mk
from ..ops import state_machine as sm
from ..ops import transfer_full as tf
from ..ops.scrub import mix64_np, scrub_digest
from ..ops.state_machine import (
    ACCOUNT_COLS,
    ACCOUNT_EXISTS_COLS,
    BALANCE_COLS,
    MAX_PROBE,
    POSTED_COLS,
    TF_PENDING,
    TF_POST,
    TF_VOID,
    TRANSFER_COLS,
    TRANSFER_EXISTS_COLS,
    TransferCtx,
)
from ..u128 import mix64
from .mesh import Mesh


# ---------------------------------------------------------------------------
# The sharded ledger
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedTable:
    """A table partitioned over a mesh: ``parts[s]`` is shard s's local
    ``ht.Table`` (C/n slots, its own ``count`` and ``probe_overflow``) on
    the mesh's device s.  The JAX package's global arrays are the parts'
    concatenation."""

    parts: List[ht.Table]

    @property
    def capacity(self) -> int:
        """The global capacity C."""
        return self.parts[0].capacity * len(self.parts)

    @property
    def local_capacity(self) -> int:
        return self.parts[0].capacity

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    @property
    def count(self) -> torch.Tensor:
        """int64[n]: each shard's live rows, on the first shard's device."""
        return torch.stack([p.count.to(self.device) for p in self.parts])

    @property
    def probe_overflow(self) -> torch.Tensor:
        """bool[n]: each shard's probe-overflow flag."""
        return torch.stack([p.probe_overflow.to(self.device)
                            for p in self.parts])


@dataclasses.dataclass
class ShardedLedger:
    """The ledger over ``mesh``: three sharded tables and the replicated
    history log (on the mesh's first device)."""

    mesh: Mesh
    accounts: ShardedTable
    transfers: ShardedTable
    posted: ShardedTable
    history: sm.History

    @property
    def device(self) -> torch.device:
        return self.mesh.primary

    def shard(self, s: int) -> sm.Ledger:
        """Shard s's local ledger (its three local tables; the history is
        the replicated log's)."""
        return sm.Ledger(accounts=self.accounts.parts[s],
                         transfers=self.transfers.parts[s],
                         posted=self.posted.parts[s], history=self.history)


def make_sharded_ledger(
    mesh: Mesh,
    accounts_capacity: int,
    transfers_capacity: int,
    posted_capacity: int,
    history_capacity: int = 1,
) -> ShardedLedger:
    """A zeroed sharded ledger.  Capacities are global (powers of two,
    divisible by the shard count); each shard holds C/n slots of each
    table, with its own count and probe_overflow."""
    n = mesh.size
    for cap in (accounts_capacity, transfers_capacity, posted_capacity):
        assert cap % n == 0 and (cap & (cap - 1)) == 0

    def table(capacity, col_specs):
        return ShardedTable([ht.make_table(capacity // n, col_specs, d)
                             for d in mesh.devices])

    return ShardedLedger(
        mesh=mesh,
        accounts=table(accounts_capacity, ACCOUNT_COLS),
        transfers=table(transfers_capacity, TRANSFER_COLS),
        posted=table(posted_capacity, POSTED_COLS),
        history=sm.make_history(history_capacity, mesh.primary),
    )


def owners(key_lo: torch.Tensor, key_hi: torch.Tensor, n: int) -> torch.Tensor:
    """Each key's owner shard: the low hash bits."""
    return mix64(key_lo, key_hi) & (n - 1)


def _replicate(mesh: Mesh, tensors: Dict[str, torch.Tensor]) -> List[Dict]:
    """One copy of ``tensors`` per device group of the mesh."""
    return [{k: v if v.device == d else v.to(d) for k, v in tensors.items()}
            for d, _shards in mesh.groups]


# ---------------------------------------------------------------------------
# _ShardGather: K30 + the psum across cards (NCCL)
# ---------------------------------------------------------------------------


class Look(NamedTuple):
    """One key set's gathered context, on one device group."""

    found: torch.Tensor  # bool[N]
    slot: torch.Tensor  # int64[N]: the global slot, 0 where not found
    cols: Dict[str, torch.Tensor]  # zero where not found
    overflow: torch.Tensor  # bool 0-dim: a shard's local probe overflowed


@dataclasses.dataclass
class _Request:
    table: ShardedTable
    keys: List[Tuple[torch.Tensor, torch.Tensor]]  # per device group
    names: Tuple[str, ...]
    count: Optional[int]
    masks: Optional[List[torch.Tensor]]
    overflow: bool


class GatherRound:
    """One psum round of ``_ShardGather``s (sharded.py:142): each added key
    set is one K30 launch per device group into the group's packed answer
    row (int64[M]), then ONE ``Mesh.psum_rows`` sums every key set, column
    and overflow word of the round across the groups' cards (where the JAX
    package does one psum a column; on one card nothing is left to sum)."""

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh
        self.requests: List[_Request] = []

    def add(self, table: ShardedTable, keys, names: Sequence[str] = (),
            count: Optional[int] = None, masks=None,
            overflow: bool = False) -> int:
        """Queue a gather of ``table`` at ``keys`` (one (lo, hi) pair per
        device group): ``found`` masked to lanes below ``count`` and to
        ``masks`` (one bool[N] per group) when given, the ``names`` columns,
        and, with ``overflow``, the JAX package's overflow flag over every
        lane of every shard.  Returns its index in ``run()``'s lists."""
        self.requests.append(_Request(table, list(keys), tuple(names), count,
                                      masks, overflow))
        return len(self.requests) - 1

    def run(self) -> List[List[Look]]:
        """``[group][request]`` the combined context, on each group's
        device."""
        mesh = self.mesh
        offsets, m = [], 0
        for r in self.requests:
            offsets.append(m)
            m += (2 + len(r.names)) * r.keys[0][0].numel()
        ovf0 = m
        m += len(self.requests)
        rows = []
        for g, (dev, shards) in enumerate(mesh.groups):
            # K30 writes every lane of the row; only the overflow words
            # start at zero.
            row = torch.empty(m, dtype=torch.int64, device=dev)
            row[ovf0:].zero_()
            for k, r in enumerate(self.requests):
                lo, hi = r.keys[g]
                count = lo.numel() if r.count is None else r.count
                mask = None if r.masks is None else r.masks[g]
                gather = (_cuda.shard_gather if lo.is_cuda
                          else shard_gather_plain)
                gather([r.table.parts[s] for s in shards], shards, mesh.size,
                       lo, hi, r.names, MAX_PROBE, count, mask, row,
                       offsets[k], ovf0 + k, r.overflow)
            rows.append(row)
        sums = mesh.psum_rows(rows)
        out = []
        for total in sums:
            looks = []
            for k, r in enumerate(self.requests):
                n = r.keys[0][0].numel()
                seg = total[offsets[k]:offsets[k] + (2 + len(r.names)) * n]
                seg = seg.view(2 + len(r.names), n)
                cols = {}
                for c, name in enumerate(r.names):
                    v = seg[2 + c]
                    if r.table.parts[0].cols[name].dtype == torch.int32:
                        v = v.to(torch.int32)
                    cols[name] = v
                looks.append(Look(seg[0] != 0, seg[1], cols,
                                  total[ovf0 + k] != 0))
            out.append(looks)
        return out


def shard_gather_plain(tables: Sequence[ht.Table], shard_ids: Sequence[int],
                       n_shards: int, key_lo, key_hi, names: Sequence[str],
                       max_probe: int, count: int,
                       mask: Optional[torch.Tensor], out: torch.Tensor,
                       offset: int, ovf_index: int,
                       want_overflow: bool) -> None:
    """Plain version of kernel K30 (the same answer row ``out``): the JAX
    package's per-shard ``ht.lookup`` with ``hash_shift``, masked to the
    keys the shard owns, and ``gather_cols``, each lane's answer from its
    owner shard when it is local and zeros otherwise; the overflow word
    ORed over every local shard's probe."""
    n = key_lo.shape[0]
    shift = n_shards.bit_length() - 1
    own = owners(key_lo, key_hi, n_shards)
    width = (2 + len(names)) * n
    out[offset:offset + width] = 0
    for t, s in zip(tables, shard_ids):
        lane_mask = own == s
        if mask is not None:
            lane_mask = lane_mask & mask
        look = ht.lookup_plain(t, key_lo, key_hi, max_probe, shift, count,
                               names, lane_mask)
        mine = own == s
        ans = [look.found.to(torch.int64),
               torch.where(look.found, s * t.capacity + look.slot,
                           torch.zeros_like(look.slot))]
        for name in names:
            v = look.cols[name].to(torch.int64)
            if t.cols[name].dtype == torch.int32:
                v = v & 0xFFFFFFFF  # u32 zero-extended, as K30 writes it
            ans.append(v)
        for c, v in enumerate(ans):
            seg = out[offset + c * n:offset + (c + 1) * n]
            seg.copy_(torch.where(mine, v, seg))
        if want_overflow:
            out[ovf_index] |= look.overflow.to(torch.int64)


# ---------------------------------------------------------------------------
# Owner-local applies: K4 and K10's scatter in their slot-base forms
# ---------------------------------------------------------------------------


def apply_balances_local(accounts: ht.Table, dr_slot, cr_slot, ok, amount_lo,
                         pending, slot_base: int,
                         global_cap: int) -> ht.Table:
    """The fast path's balance update of one shard (sharded.py:213-229): a
    plan over global slots, applied to the legs in the shard's range
    [slot_base, slot_base + C/n) at slot - slot_base.  K4's slot-base form
    on CUDA tensors."""
    if ok.is_cuda:
        _cuda.balance(dr_slot, cr_slot, ok, amount_lo, pending,
                      [accounts.cols[c] for c in BALANCE_COLS],
                      slot_base=slot_base)
        return accounts
    return apply_balances_local_plain(accounts, dr_slot, cr_slot, ok,
                                      amount_lo, pending, slot_base,
                                      global_cap)


def apply_balances_local_plain(accounts: ht.Table, dr_slot, cr_slot, ok,
                               amount_lo, pending, slot_base: int,
                               global_cap: int) -> ht.Table:
    """Plain version of K4's slot-base form: the JAX package's localized
    plan."""
    plan = sm.balance_plan(dr_slot, cr_slot, ok, amount_lo, pending,
                           global_cap)
    local_cap = accounts.capacity
    in_range = (plan.s_slot >= slot_base) & (
        plan.s_slot < slot_base + local_cap)
    local_plan = sm.BalancePlan(
        s_slot=torch.where(in_range, plan.s_slot - slot_base,
                           torch.full_like(plan.s_slot, local_cap)),
        head=plan.head & in_range,
        deltas=plan.deltas,
    )
    return sm.apply_balance_plan(accounts, local_plan)


def _scatter_local(accounts: ht.Table, gate, scat, s_slot,
                   bal_incl: Dict[str, torch.Tensor], slot_base: int) -> None:
    """The general kernel's balance scatter on one shard
    (sharded.py:439-450): where the batch commits, the run tails whose
    global slot is in the shard's range write at slot - slot_base.  K10's
    apply launch in its slot-base form on CUDA tensors (``gate`` the int32[1]
    flags word); ``gate`` the commit mask (bool 0-dim) on CPU tensors."""
    cols = tf._BAL_COLS
    if scat.is_cuda:
        _cuda.full_legs_apply(gate, scat, s_slot,
                              [bal_incl[c] for c in cols],
                              [accounts.cols[c] for c in cols],
                              slot_base=slot_base)
        return
    _scatter_local_plain(accounts, gate, scat, s_slot, bal_incl, slot_base)


def _scatter_local_plain(accounts: ht.Table, commit, scat, s_slot,
                         bal_incl: Dict[str, torch.Tensor],
                         slot_base: int) -> None:
    """Plain version of K10's apply launch in its slot-base form; ``commit``
    a bool 0-dim."""
    local_cap = accounts.capacity
    in_range = (s_slot >= slot_base) & (s_slot < slot_base + local_cap)
    do = scat & commit & in_range
    ht.scatter_cols(accounts,
                    torch.where(do, s_slot - slot_base,
                                torch.full_like(s_slot, local_cap)),
                    do, bal_incl)


def _or_across(mesh: Mesh, words: List[torch.Tensor]) -> None:
    """OR the int32[1] flag words of every device group, in place: each
    flag bit as a 0/1 term of a psum (K31, NCCL)."""
    if len(words) == 1:
        return
    shifts = torch.arange(8, device=words[0].device)
    bits = [((w.to(torch.int64) >> shifts.to(w.device)) & 1).reshape(1, -1)
            for w in words]
    for w, total in zip(words, mesh.psum(bits)):
        w.copy_(((total > 0).to(torch.int64)
                 << shifts.to(w.device)).sum().to(torch.int32).reshape(1))


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------


def _keys(rep, lo: str, hi: str):
    return [(b[lo], b[hi]) for b in rep]


def sharded_create_accounts(mesh: Mesh):
    """The sharded create_accounts step (sharded.py:523):
    fn(ledger, batch, count, timestamp) -> (ledger, codes), in place."""
    n_shards, shift = mesh.size, mesh.shift

    def step(ledger: ShardedLedger, batch, count: int, timestamp: int):
        acc = ledger.accounts
        rep = _replicate(mesh, batch)
        rnd = GatherRound(mesh)
        g_id = rnd.add(acc, _keys(rep, "id_lo", "id_hi"), ACCOUNT_EXISTS_COLS,
                       count)
        looks = rnd.run()
        out = None
        for g, (_dev, shards) in enumerate(mesh.groups):
            b, look = rep[g], looks[g][g_id]
            codes, ok = sm.account_codes(b, look.found, look.cols, count)
            rows = sm.account_rows(b, count, timestamp)
            own = owners(b["id_lo"], b["id_hi"], n_shards)
            for s in shards:
                ht.insert(acc.parts[s], b["id_lo"], b["id_hi"], ok & (own == s),
                          rows, MAX_PROBE, hash_shift=shift)
            if g == 0:
                out = codes
        return ledger, out

    return step


def sharded_create_transfers(mesh: Mesh, probed: bool = False):
    """The sharded fast create_transfers step (sharded.py:167):
    fn(ledger, batch, count, timestamp) -> (ledger, codes), in place.
    ``probed`` also returns the per-shard transfers probe_overflow flags as
    a fresh int32[n] tensor, which a deferred handle reads after later
    dispatches."""
    n_shards, shift = mesh.size, mesh.shift

    def step(ledger: ShardedLedger, batch, count: int, timestamp: int):
        acc, tr = ledger.accounts, ledger.transfers
        rep = _replicate(mesh, batch)
        rnd = GatherRound(mesh)
        g_dr = rnd.add(acc, _keys(rep, "debit_account_id_lo",
                                  "debit_account_id_hi"), ("ledger",), count)
        g_cr = rnd.add(acc, _keys(rep, "credit_account_id_lo",
                                  "credit_account_id_hi"), ("ledger",), count)
        g_ex = rnd.add(tr, _keys(rep, "id_lo", "id_hi"), TRANSFER_EXISTS_COLS,
                       count)
        looks = rnd.run()
        global_cap = acc.capacity
        local_cap = acc.local_capacity
        out = None
        for g, (_dev, shards) in enumerate(mesh.groups):
            b = rep[g]
            dr, cr, ex = looks[g][g_dr], looks[g][g_cr], looks[g][g_ex]
            ctx = TransferCtx(
                dr_found=dr.found, cr_found=cr.found, dr_slot=dr.slot,
                cr_slot=cr.slot, dr=dr.cols, cr=cr.cols, ex_found=ex.found,
                e=ex.cols,
            )
            # Replicated validation (identical on every device).
            codes, ok = sm.transfer_codes(b, ctx, count, timestamp)
            pending = (b["flags"] & TF_PENDING) != 0
            rows = sm.transfer_rows(b, count, timestamp)
            own = owners(b["id_lo"], b["id_hi"], n_shards)
            for s in shards:
                # Balance plan over global slots, applied owner-locally.
                apply_balances_local(acc.parts[s], dr.slot, cr.slot, ok,
                                     b["amount_lo"], pending, s * local_cap,
                                     global_cap)
                # Owner-local transfer inserts.
                ht.insert(tr.parts[s], b["id_lo"], b["id_hi"], ok & (own == s),
                          rows, MAX_PROBE, hash_shift=shift)
            if g == 0:
                out = codes
        if probed:
            return ledger, out, tr.probe_overflow.to(torch.int32)
        return ledger, out

    return step


_ACCOUNT_VIEW_COLS = tf._ACCOUNT_VIEW_COLS
_FLAG_BITS = (tf.FLAG_GROW_ACCOUNTS, tf.FLAG_GROW_TRANSFERS,
              tf.FLAG_GROW_POSTED)


def _view(look: Look, found) -> tf.AccountView:
    return tf.AccountView(found=found, slot=look.slot,
                          flags=look.cols["flags"], ledger=look.cols["ledger"],
                          bal={c: look.cols[c] for c in tf._BAL_COLS})


def sharded_create_transfers_full(mesh: Mesh, max_passes: Optional[int] = None,
                                  use_waves: bool = False):
    """The general transfer kernel over the mesh (sharded.py:265):
    fn(ledger, batch, count, timestamp) -> (ledger, codes, kflags[,
    wave_vec]), in place where kflags is 0 (nothing applied otherwise).

    Two gather rounds (the pending rows must be combined before the pending
    accounts and the posted record are gathered at their keys), the kernel
    core replicated on each device, owner-local claims (their overflow ORed
    into kflags on every device before any write), then owner-local
    scatters and writes.  History-flagged accounts route (FLAG_SEQ)."""
    if max_passes is None:
        max_passes = tf._MAX_PASSES
    n_shards, shift = mesh.size, mesh.shift

    def step(ledger: ShardedLedger, batch, count: int, timestamp: int):
        acc, tr, posted_t = ledger.accounts, ledger.transfers, ledger.posted
        rep = _replicate(mesh, batch)
        n = batch["id_lo"].shape[0]
        valid, postvoid = [], []
        for b in rep:
            v = torch.arange(n, device=b["id_lo"].device) < count
            valid.append(v)
            postvoid.append((((b["flags"] & TF_POST) != 0)
                             | ((b["flags"] & TF_VOID) != 0)) & v)
        xfr_cols = tuple(TRANSFER_COLS)
        r1 = GatherRound(mesh)
        g_ex = r1.add(tr, _keys(rep, "id_lo", "id_hi"), xfr_cols,
                      masks=valid, overflow=True)
        g_p = r1.add(tr, _keys(rep, "pending_id_lo", "pending_id_hi"),
                     xfr_cols, masks=postvoid, overflow=True)
        looks1 = r1.run()
        # The pending rows (zero where no table pending) key round 2.
        p_tab = [looks1[g][g_p].cols for g in range(len(rep))]
        r2 = GatherRound(mesh)
        g_dr = r2.add(acc, _keys(rep, "debit_account_id_lo",
                                 "debit_account_id_hi"), _ACCOUNT_VIEW_COLS,
                      masks=valid, overflow=True)
        g_cr = r2.add(acc, _keys(rep, "credit_account_id_lo",
                                 "credit_account_id_hi"), _ACCOUNT_VIEW_COLS,
                      masks=valid, overflow=True)
        g_pdr = r2.add(acc, _keys(p_tab, "debit_account_id_lo",
                                  "debit_account_id_hi"), _ACCOUNT_VIEW_COLS,
                       overflow=True)
        g_pcr = r2.add(acc, _keys(p_tab, "credit_account_id_lo",
                                  "credit_account_id_hi"), _ACCOUNT_VIEW_COLS,
                       overflow=True)
        g_pt = r2.add(posted_t, [(p["timestamp"],
                                  torch.zeros_like(p["timestamp"]))
                                 for p in p_tab], ("fulfillment",),
                      overflow=True)
        looks2 = r2.run()
        global_cap = acc.capacity
        local_cap = acc.local_capacity
        plans, words = [], []
        for g in range(len(rep)):
            b = rep[g]
            ex, p = looks1[g][g_ex], looks1[g][g_p]
            dr, cr = looks2[g][g_dr], looks2[g][g_cr]
            pdr, pcr, pt = looks2[g][g_pdr], looks2[g][g_pcr], looks2[g][g_pt]
            probe_grow = (
                (dr.overflow | cr.overflow | pdr.overflow | pcr.overflow).to(
                    torch.int32) * tf.FLAG_GROW_ACCOUNTS
                | (ex.overflow | p.overflow).to(torch.int32)
                * tf.FLAG_GROW_TRANSFERS
                | pt.overflow.to(torch.int32) * tf.FLAG_GROW_POSTED
            )
            ctx = tf.GatherCtx(
                ex_found=ex.found, e_tab=ex.cols, p_tab_found=p.found,
                p_tab=p.cols, drT=_view(dr, dr.found), crT=_view(cr, cr.found),
                pdr=_view(pdr, pdr.found), pcr=_view(pcr, pcr.found),
                postedT_found=pt.found, postedT_val=pt.cols["fulfillment"],
                probe_grow=probe_grow, accounts_capacity=global_cap,
            )
            plan = tf._kernel_core(ctx, b, count, timestamp, max_passes,
                                   has_postvoid=True, use_waves=use_waves)
            # History admission: the mesh ledger's history is not appended
            # here; route instead of dropping rows.
            route = plan.route | plan.do_hist.any().to(torch.int32) * tf.FLAG_SEQ
            plans.append(plan)
            words.append((probe_grow | route).reshape(1).clone())
        # Owner-local claims; their overflow joins the flags before any
        # write (insert-probe overflow routes with nothing applied).
        claims = []
        for g, (_dev, shards) in enumerate(mesh.groups):
            b, plan = rep[g], plans[g]
            zeros = torch.zeros_like(plan.posted_key)
            own_t = owners(b["id_lo"], b["id_hi"], n_shards)
            own_p = owners(plan.posted_key, zeros, n_shards)
            per = {}
            for s in shards:
                t, pp = tr.parts[s], posted_t.parts[s]
                t_mask = plan.ok & (own_t == s)
                p_mask = plan.pv_ok & (own_p == s)
                if b["id_lo"].is_cuda:
                    t_claim, _ = _cuda.claim(
                        t.key_lo, t.key_hi, t.tombstone, b["id_lo"],
                        b["id_hi"], t_mask, MAX_PROBE, shift,
                        flag_word=words[g], flag_bit=tf.FLAG_GROW_TRANSFERS)
                    p_claim, _ = _cuda.claim(
                        pp.key_lo, pp.key_hi, pp.tombstone, plan.posted_key,
                        zeros, p_mask, MAX_PROBE, shift, flag_word=words[g],
                        flag_bit=tf.FLAG_GROW_POSTED)
                else:
                    t_claim, t_ovf = ht.claim_slots_plain(
                        t, b["id_lo"], b["id_hi"], t_mask, MAX_PROBE, shift)
                    p_claim, p_ovf = ht.claim_slots_plain(
                        pp, plan.posted_key, zeros, p_mask, MAX_PROBE, shift)
                    words[g] |= (t_ovf.to(torch.int32) * tf.FLAG_GROW_TRANSFERS
                                 | p_ovf.to(torch.int32) * tf.FLAG_GROW_POSTED)
                per[s] = (t_claim, t_mask, p_claim, p_mask)
            claims.append(per)
        _or_across(mesh, words)
        for g, (_dev, shards) in enumerate(mesh.groups):
            b, plan, kflags = rep[g], plans[g], words[g]
            zeros = torch.zeros_like(plan.posted_key)
            fulfillment = torch.where(plan.post, 1, 2).to(torch.int32)
            cuda = b["id_lo"].is_cuda
            commit = None if cuda else (kflags[0] == 0)
            for s in shards:
                t_claim, t_mask, p_claim, p_mask = claims[g][s]
                t, pp = tr.parts[s], posted_t.parts[s]
                _scatter_local(acc.parts[s], kflags if cuda else commit,
                               plan.scat, plan.s_slot, plan.bal_incl,
                               s * local_cap)
                if cuda:
                    _cuda.write_claimed(
                        t.key_lo, t.key_hi, t.tombstone, t.cols, t.count,
                        b["id_lo"], b["id_hi"], t_claim, t_mask, plan.row,
                        gate=kflags, revert=True)
                    _cuda.write_claimed(
                        pp.key_lo, pp.key_hi, pp.tombstone, pp.cols, pp.count,
                        plan.posted_key, zeros, p_claim, p_mask,
                        {"fulfillment": fulfillment}, gate=kflags,
                        revert=True)
                else:
                    ht.write_rows_plain(t, b["id_lo"], b["id_hi"], t_claim,
                                        t_mask & commit, plan.row)
                    ht.write_rows_plain(pp, plan.posted_key, zeros, p_claim,
                                        p_mask & commit,
                                        {"fulfillment": fulfillment})
        plan, kflags = plans[0], words[0][0]
        if use_waves:
            wave_vec = torch.cat([plan.passes.reshape(1),
                                  plan.wave_bound.reshape(1), plan.wave_hist])
            return ledger, plan.codes, kflags, wave_vec
        return ledger, plan.codes, kflags

    return step


def sharded_lookup(mesh: Mesh, table_name: str):
    """Sharded point lookup over ``ledger.<table_name>`` (sharded.py:492):
    fn(ledger, id_lo, id_hi) -> (found[b], rows{col: [b]}), with the id
    columns as the single-device lookups give them."""

    def step(ledger: ShardedLedger, id_lo, id_hi):
        table = getattr(ledger, table_name)
        rep = _replicate(mesh, {"lo": id_lo, "hi": id_hi})
        rnd = GatherRound(mesh)
        k = rnd.add(table, _keys(rep, "lo", "hi"), tuple(table.parts[0].cols))
        look = rnd.run()[0][k]
        rows = dict(look.cols)
        zero = torch.zeros_like(id_lo)
        rows["id_lo"] = torch.where(look.found, id_lo, zero)
        rows["id_hi"] = torch.where(look.found, id_hi, zero)
        return look.found, rows

    return step


def sharded_scrub_digest(mesh: Mesh):
    """Per-shard scrub fold lanes (sharded.py:565): fn(ledger) ->
    int64[n, 3], row s shard s's (accounts, transfers, posted) folds over
    its local tables (K21 on each), whose wrap-sum is the single-device
    fold.  Reads the ledger and never changes it."""

    def step(ledger: ShardedLedger) -> torch.Tensor:
        return torch.stack([scrub_digest(ledger.shard(s)).to(mesh.primary)
                            for s in range(mesh.size)])

    return step


def ledger_digest(ledger: ShardedLedger) -> torch.Tensor:
    """``state_machine.ledger_digest`` of the sharded ledger (an int64
    0-dim): the shards' wrap-sum folds (K5 on each) summed."""
    return torch.stack([
        sm.ledger_digest(ledger.shard(s)).to(ledger.device)
        for s in range(ledger.mesh.size)
    ]).sum()


# ---------------------------------------------------------------------------
# Per-shard Merkle subtrees (sharded.py:597-757)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedForest:
    """One ``merkle.Forest`` per shard, over its local slot layout (the
    JAX package's heaps are the parts' concatenation)."""

    parts: List[mk.Forest]


def merkle_steps(mesh: Mesh) -> Dict[str, object]:
    """The sharded Merkle build/update/verify/roots steps (sharded.py:622),
    cached process-wide like ``machine_steps``.  Updates touch in place;
    a non-owned key misses its local probe and touches nothing."""
    key = (mesh.key(), "merkle")
    steps = _STEP_CACHE.get(key)
    if steps is not None:
        return steps
    n_shards, shift = mesh.size, mesh.shift

    def locals_(ledger):
        return [ledger.shard(s) for s in range(n_shards)]

    def on(t: torch.Tensor, s: int) -> torch.Tensor:
        d = mesh.devices[s]
        return t if t.device == d else t.to(d)

    def build(ledger):
        return ShardedForest([mk.build_forest(led) for led in locals_(ledger)])

    def verify(forest, ledger):
        """int64[n, 2, 3]: each shard's maintained and recomputed roots."""
        return torch.stack([
            mk.verify_roots(f, led).to(mesh.primary)
            for f, led in zip(forest.parts, locals_(ledger))])

    def roots(forest):
        """int64[n, 3]: each shard's (accounts, transfers, posted) roots."""
        return torch.stack([mk.forest_roots(f).to(mesh.primary)
                            for f in forest.parts])

    def update_accounts(forest, ledger, lo, hi):
        for s, led in enumerate(locals_(ledger)):
            forest.parts[s] = mk.update_accounts_impl(
                forest.parts[s], led, on(lo, s), on(hi, s),
                max_probe=MAX_PROBE, hash_shift=shift)
        return forest

    def update_transfers(has_postvoid):
        def fn(forest, ledger, id_lo, id_hi, acc_lo, acc_hi, pend_lo,
               pend_hi):
            if has_postvoid:
                # Resolve pending refs cluster-wide: the row lives on one
                # shard; the psum carries its posted key and account sides
                # to every device, whose local touches keep what they own.
                rep = _replicate(mesh, {"lo": pend_lo, "hi": pend_hi})
                rnd = GatherRound(mesh)
                k = rnd.add(ledger.transfers, _keys(rep, "lo", "hi"),
                            mk._PENDING_COLS)
                looks = rnd.run()
            for g, (_dev, shards) in enumerate(mesh.groups):
                a_lo, a_hi = acc_lo, acc_hi
                if has_postvoid:
                    rows = looks[g][k].cols  # zero where not found
                    pend_ts = rows["timestamp"]
                    a_lo = torch.cat([on(acc_lo, shards[0]),
                                      rows["debit_account_id_lo"],
                                      rows["credit_account_id_lo"]])
                    a_hi = torch.cat([on(acc_hi, shards[0]),
                                      rows["debit_account_id_hi"],
                                      rows["credit_account_id_hi"]])
                for s in shards:
                    led, f = ledger.shard(s), forest.parts[s]
                    if has_postvoid:
                        mk.touch_tree(f.posted, led.posted, pend_ts,
                                      torch.zeros_like(pend_ts), "posted",
                                      MAX_PROBE, shift)
                    mk.touch_tree(f.transfers, led.transfers, on(id_lo, s),
                                  on(id_hi, s), "transfers", MAX_PROBE, shift)
                    mk.touch_tree(f.accounts, led.accounts, on(a_lo, s),
                                  on(a_hi, s), "accounts", MAX_PROBE, shift)
            return forest

        return fn

    steps = {
        "build": build,
        "verify": verify,
        "roots": roots,
        "update_accounts": update_accounts,
        "update_transfers": update_transfers(False),
        "update_transfers_pv": update_transfers(True),
    }
    _STEP_CACHE[key] = steps
    return steps


# ---------------------------------------------------------------------------
# Host-side layout converters (sequential fallback, checkpoints, queries)
# ---------------------------------------------------------------------------
#
# The sharded and single-device layouts hold identical CONTENT under
# different slot assignment: single-device homes at mix64(key) & (C-1);
# sharded homes at shard (mix64 & (n-1)), local slot ((mix64 >> shift) &
# (C/n - 1)).  These converters re-place every live row host-side with the
# exact linear-probe discipline of ht.claim_slots for distinct keys, as the
# JAX package's do (the same numpy code), so every replica replaying the
# same commit stream converges to byte-identical canonical arrays.


_NP_DTYPE = {torch.int64: np.uint64, torch.int32: np.uint32}


def _parts(table) -> List[ht.Table]:
    return table.parts if isinstance(table, ShardedTable) else [table]


def _host_array(table, name: str) -> np.ndarray:
    """The global host copy of a key, tombstone or value column (the
    parts' concatenation for a sharded table)."""
    got = [convert.tensor_to_array(
        getattr(p, name) if name in ("key_lo", "key_hi", "tombstone")
        else p.cols[name]) for p in _parts(table)]
    return got[0] if len(got) == 1 else np.concatenate(got)


def _host_rows(table):
    """(key_lo, key_hi, cols, live_idx) host copies; live rows in slot
    order (deterministic given the layout), tombstones dropped."""
    key_lo = _host_array(table, "key_lo")
    key_hi = _host_array(table, "key_hi")
    tomb = _host_array(table, "tombstone")
    live = ((key_lo != 0) | (key_hi != 0)) & ~tomb
    idx = np.flatnonzero(live)
    cols = {k: _host_array(table, k) for k in _parts(table)[0].cols}
    return key_lo, key_hi, cols, idx


def _probe_place_ref(homes: np.ndarray, region_base: np.ndarray,
                     region_mask: int, capacity: int) -> np.ndarray:
    """Reference linear-probe placement (the original per-row host loop):
    row i lands at the first free slot of region_base[i] + ((homes[i] + k)
    & region_mask).  O(rows) interpreted work, kept as the oracle the
    vectorized _probe_place is held bit-identical against."""
    occupied = np.zeros(capacity, bool)
    slots = np.empty(len(homes), np.int64)
    for i in range(len(homes)):
        s = int(homes[i])
        base = int(region_base[i])
        while occupied[base + s]:
            s = (s + 1) & region_mask
        occupied[base + s] = True
        slots[i] = base + s
    return slots


def _probe_place(homes: np.ndarray, region_base: np.ndarray, region_mask: int,
                 capacity: int) -> np.ndarray:
    """Vectorized linear-probe placement, bit-identical to
    _probe_place_ref.

    Sequential FCFS insertion satisfies one invariant that pins the
    assignment uniquely: every slot a row probes PAST holds a row with a
    smaller row index (it was already there when the later row walked).
    So the fixpoint of a displacement sweep (every unplaced row proposes
    to its current probe slot, each slot keeps the smallest row index it
    has ever been offered (np.minimum.at), losers and stolen-from rows
    advance) IS the sequential assignment, computed in O(max displacement)
    vector rounds instead of O(live rows) interpreted probe walks."""
    n = len(homes)
    if n == 0:
        return np.empty(0, np.int64)
    base = region_base.astype(np.int64)
    homes64 = homes.astype(np.int64)
    owner = np.full(capacity, n, np.int64)  # n = unowned sentinel
    offset = np.zeros(n, np.int64)
    row_slot = np.full(n, -1, np.int64)
    active = np.arange(n, dtype=np.int64)
    while active.size:
        cur = base[active] + ((homes64[active] + offset[active]) & region_mask)
        prev = owner[cur].copy()
        np.minimum.at(owner, cur, active)
        won = owner[cur] == active
        row_slot[active[won]] = cur[won]
        offset[active[~won]] += 1  # lost the proposal: advance one
        # Stolen-from rows (a smaller index claimed their slot) rejoin one
        # past the stolen slot.  One victim per slot, winners' slots are
        # unique, so victims are unique.
        victims = prev[won]
        victims = victims[victims < n]
        if victims.size:
            offset[victims] = (
                (row_slot[victims] - base[victims] - homes64[victims])
                & region_mask
            ) + 1
            row_slot[victims] = -1
            active = np.concatenate([active[~won], victims])
        else:
            active = active[~won]
    return row_slot


def _fill_table(capacity: int, key_lo, key_hi, cols, slots,
                col_specs) -> Dict[str, object]:
    """The global host arrays of a table holding the rows at ``slots``."""
    out_lo = np.zeros(capacity, np.uint64)
    out_hi = np.zeros(capacity, np.uint64)
    out_lo[slots] = key_lo
    out_hi[slots] = key_hi
    out_cols = {}
    for name, dt in col_specs.items():
        buf = np.zeros(capacity, _NP_DTYPE[dt])
        buf[slots] = cols[name]
        out_cols[name] = buf
    return {"key_lo": out_lo, "key_hi": out_hi,
            "tombstone": np.zeros(capacity, np.bool_), "cols": out_cols}


def _table_on(arrays: Dict, lo: int, hi: int, count: int, device) -> ht.Table:
    """``ht.Table`` of slots [lo, hi) of ``_fill_table``'s arrays."""
    return ht.Table(
        key_lo=convert.array_to_tensor(arrays["key_lo"][lo:hi], device),
        key_hi=convert.array_to_tensor(arrays["key_hi"][lo:hi], device),
        tombstone=convert.array_to_tensor(arrays["tombstone"][lo:hi], device),
        cols={k: convert.array_to_tensor(v[lo:hi], device)
              for k, v in arrays["cols"].items()},
        count=torch.tensor(int(count), dtype=torch.int64, device=device),
        probe_overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


_COL_SPECS = {
    "accounts": ACCOUNT_COLS,
    "transfers": TRANSFER_COLS,
    "posted": POSTED_COLS,
}


def _history_copy(history: sm.History, device) -> sm.History:
    return sm.History(
        cols={k: v.to(device, copy=True) for k, v in history.cols.items()},
        count=history.count.to(device, copy=True),
    )


def unshard_ledger(ledger: ShardedLedger, mesh: Mesh) -> sm.Ledger:
    """Canonical single-device Ledger (on the mesh's first device) with the
    sharded ledger's exact content: single-device probe layout, scalar
    counts.  The history log is copied as it is."""

    def un_table(table, name: str) -> ht.Table:
        cap = table.capacity
        key_lo, key_hi, cols, idx = _host_rows(table)
        k_lo, k_hi = key_lo[idx], key_hi[idx]
        homes = mix64_np(k_lo, k_hi) & np.uint64(cap - 1)
        slots = _probe_place(
            homes, np.zeros(len(idx), np.int64), cap - 1, cap
        )
        arrays = _fill_table(
            cap, k_lo, k_hi, {k: v[idx] for k, v in cols.items()}, slots,
            _COL_SPECS[name],
        )
        return _table_on(arrays, 0, cap, len(slots), mesh.primary)

    return sm.Ledger(
        accounts=un_table(ledger.accounts, "accounts"),
        transfers=un_table(ledger.transfers, "transfers"),
        posted=un_table(ledger.posted, "posted"),
        history=_history_copy(ledger.history, mesh.primary),
    )


def _shard_table(table, name: str, mesh: Mesh,
                 new_capacity: int = None) -> ShardedTable:
    """Host-side (re)placement of one table (single-device or sharded) into
    the sharded layout at ``new_capacity`` (default: same global capacity):
    used by shard_ledger and by growth under sharding."""
    n = mesh.size
    shift = n.bit_length() - 1
    cap = new_capacity if new_capacity is not None else table.capacity
    assert cap % n == 0 and (cap & (cap - 1)) == 0
    local_cap = cap // n
    key_lo, key_hi, cols, idx = _host_rows(table)
    k_lo, k_hi = key_lo[idx], key_hi[idx]
    h = mix64_np(k_lo, k_hi)
    owner = (h & np.uint64(n - 1)).astype(np.int64)
    homes = (h >> np.uint64(shift)) & np.uint64(local_cap - 1)
    slots = _probe_place(homes, owner * local_cap, local_cap - 1, cap)
    arrays = _fill_table(
        cap, k_lo, k_hi, {k: v[idx] for k, v in cols.items()}, slots,
        _COL_SPECS[name],
    )
    counts = np.bincount(owner, minlength=n)
    return ShardedTable([
        _table_on(arrays, s * local_cap, (s + 1) * local_cap, counts[s], d)
        for s, d in enumerate(mesh.devices)
    ])


def shard_ledger(single: sm.Ledger, mesh: Mesh) -> ShardedLedger:
    """Sharded ledger with the single-device ledger's exact content
    (owner-partitioned probe layout, per-shard counts)."""
    return ShardedLedger(
        mesh=mesh,
        accounts=_shard_table(single.accounts, "accounts", mesh),
        transfers=_shard_table(single.transfers, "transfers", mesh),
        posted=_shard_table(single.posted, "posted", mesh),
        history=_history_copy(single.history, mesh.primary),
    )


def grow_sharded_table(table: ShardedTable, name: str, new_capacity: int,
                       mesh: Mesh) -> ShardedTable:
    """ht.grow for a sharded table: owners are the LOW hash bits so every
    row stays on its shard; only the local homes rehash.  Host-side
    re-placement, deterministic like the converters."""
    assert new_capacity >= table.capacity
    return _shard_table(table, name, mesh, new_capacity)


# ---------------------------------------------------------------------------
# The step cache (the machine's serving surface)
# ---------------------------------------------------------------------------

_STEP_CACHE: Dict[tuple, dict] = {}


def machine_steps(mesh: Mesh, max_passes: int) -> dict:
    """The sharded commit and scrub steps for ``mesh``, cached process-wide
    by (the mesh's devices, max_passes), so machines on one mesh share
    them."""
    key = (mesh.key(), int(max_passes))
    steps = _STEP_CACHE.get(key)
    if steps is None:
        steps = {
            "accounts": sharded_create_accounts(mesh),
            "fast": sharded_create_transfers(mesh),
            # The deferred dispatch's twin (overflow as a fresh output).
            "fast_probed": sharded_create_transfers(mesh, probed=True),
            "full": sharded_create_transfers_full(mesh, max_passes),
            "full_waves": sharded_create_transfers_full(
                mesh, max_passes, use_waves=True
            ),
            "scrub": sharded_scrub_digest(mesh),
        }
        _STEP_CACHE[key] = steps
    return steps


# ---------------------------------------------------------------------------
# Online shard split (docs/reconfiguration.md)
# ---------------------------------------------------------------------------


def split_moved_mask(key_lo: np.ndarray, key_hi: np.ndarray,
                     old_shards: int) -> np.ndarray:
    """Boolean mask of canonical slots whose OWNER changes on an
    old_shards -> 2*old_shards split.  Owners are the low hash bits, so
    doubling adds exactly one bit: a live row moves iff
    ``mix64(key) & old_shards != 0`` (it lands on shard s + old_shards),
    and stays resident otherwise.  Empty slots (key == 0) never move."""
    assert old_shards >= 1 and old_shards & (old_shards - 1) == 0
    lo = np.asarray(key_lo, dtype=np.uint64)
    hi = np.asarray(key_hi, dtype=np.uint64)
    live = (lo | hi) != 0
    owners_ = mix64_np(lo, hi)
    return live & ((owners_ & np.uint64(old_shards)) != 0)
