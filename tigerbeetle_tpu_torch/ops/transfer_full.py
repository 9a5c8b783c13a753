"""The general create_transfers commit kernel (port of
``tigerbeetle_tpu/ops/transfer_full.py``).

It covers what the fast path refuses, in one data-parallel batch: two-phase
pending / post / void (including a post or void of a pending created earlier
in the same batch, double post/void inside the batch, expiry), balancing
debits and credits, balance-limit accounts, the exact overflow codes 47-52,
history rows with exact per-event balances, intra-batch duplicate ids and
linked chains.

Running balances come from legs: each event has a debit leg (2i) and a
credit leg (2i+1); legs sorted by (account slot, leg position) and summed
within each slot run give every event's exact pre- and post-event account
state.  Acceptance feeds back into later events' balances, so the balances
live inside a Jacobi fixpoint: pass k recomputes the legs from pass k-1's
(accepted, amount) iterate and re-evaluates every ladder; a stable pass is
the sequential answer.  A batch that does not converge within the pass
budget, or that the leg machinery cannot reproduce exactly (u128 amounts,
linked chains with intra-batch references, failed chains with balance
codes, balances that overflow u128), sets ``FLAG_SEQ`` and applies nothing;
the machine then runs it on the sequential path.  A probe that reaches
MAX_PROBE sets a ``FLAG_GROW_*`` bit, and the machine grows the table and
retries.  ``FLAG_COLD`` stays dark until the cold tier is ported.

Every function keeps its JAX name.  Tensors are int64 holding u64 bits and
int32 holding u32 bits, as everywhere in the port.  On CPU tensors each
function runs its plain PyTorch version (``*_plain``); on CUDA tensors it
launches its hand-written kernel, or raises:

| function | kernel |
|---|---|
| ``_build_id_index`` (+ ``_search128``'s pending join) | K9 ``csrc/full_index.cu`` |
| ``_leg_balances`` (+ the apply's balance scatter) | K10 ``csrc/full_legs.cu`` |
| ``_kernel_core``'s passes (``_first_code``, ``_group_winner``, ``_exists_*``, the ladders, chain codes, routing, history values; + the history append) | K11 ``csrc/full_pass.cu`` |
| ``_wave_schedule`` | K12 ``csrc/full_waves.cu`` |
| ``build_gather_ctx`` | K1 through ``hash_table.lookup_flags``: one launch, its flag word the FLAG_GROW_* bits and the cold branch (K17's step) |
| the apply's ``claim_slots`` / ``write_rows`` | K2 claim / write entries |

The port's ``IdIndex`` labels each id group by its lowest lane (the JAX
package labels it by sorted position; only the grouping matters), so the
kernel's and the plain version's index are equal array for array.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from .. import u128
from ..u128 import U128, i64, srl, uge, ult
from . import _cuda
from . import hash_table as ht
from .state_machine import (
    AF_CREDITS_MUST_NOT_EXCEED_DEBITS,
    AF_DEBITS_MUST_NOT_EXCEED_CREDITS,
    AF_HISTORY,
    HISTORY_COLS,
    MAX_PROBE,
    NS_PER_S,
    TF_BALANCING_CREDIT,
    TF_BALANCING_DEBIT,
    TF_LINKED,
    TF_PADDING,
    TF_PENDING,
    TF_POST,
    TF_VOID,
    TRANSFER_BATCH_COLS,
    TRANSFER_COLS,
    Ledger,
    _chain_codes,
    _timestamps,
    _u128_col,
)

# Routing flag bits (int32 0-dim).  Nonzero => nothing was applied.
FLAG_SEQ = 1  # order-dependent semantics: run the sequential path
FLAG_GROW_ACCOUNTS = 2  # a probe hit MAX_PROBE: grow the table + retry
FLAG_GROW_TRANSFERS = 4
FLAG_GROW_POSTED = 8
FLAG_COLD = 16  # an id/pending_id may live in the cold spill: host resolves

_U32MASK = 0xFFFFFFFF
_U64MAX = -1  # the int64 holding u64 max

# Result codes whose value depends on account balances (the failed linked
# chain hazard route).
_BALANCE_CODES = (47, 48, 49, 50, 51, 52, 54, 55)

# Jacobi pass budget (pass k is exact for outcome-cascade depth < k).
_MAX_PASSES = 8

_BAL_FIELDS = (
    "debits_pending", "debits_posted", "credits_pending", "credits_posted",
)
_BAL_COLS = tuple(f + s for f in _BAL_FIELDS for s in ("_lo", "_hi"))

# Near-overflow thresholds on the hi limb: the failed-chain hazard (margin
# 2^79 >= n * 2^64) and the wave scheduler's stricter margin (2^127 - 2^80).
_NEAR_OV = i64(0xFFFF_FFFF_FFFF_0000)
_NEAR_W = i64(0x7FFF_FFFF_FFFF_0000)


class AccountView(NamedTuple):
    """The slice of an account row the kernel core needs."""

    found: torch.Tensor  # bool[N]
    slot: torch.Tensor  # int64[N]
    flags: torch.Tensor  # int32[N]
    ledger: torch.Tensor  # int32[N]
    bal: Dict[str, torch.Tensor]  # {field_lo/_hi: int64[N]}


class GatherCtx(NamedTuple):
    """Every table-derived input of the kernel core."""

    ex_found: torch.Tensor
    e_tab: Dict[str, torch.Tensor]
    p_tab_found: torch.Tensor
    p_tab: Dict[str, torch.Tensor]
    drT: AccountView  # the event's own debit account
    crT: AccountView
    pdr: AccountView  # the TABLE pending's debit account
    pcr: AccountView
    postedT_found: torch.Tensor
    postedT_val: torch.Tensor
    probe_grow: torch.Tensor  # int32 0-dim: FLAG_GROW_* / FLAG_COLD bits
    accounts_capacity: int  # the slot sentinel


class ApplyPlan(NamedTuple):
    """Everything the apply phase needs."""

    codes: torch.Tensor  # int32[N] final result codes
    route: torch.Tensor  # int32 0-dim: FLAG_SEQ or 0
    ok: torch.Tensor  # bool[N]
    row: Dict[str, torch.Tensor]  # composed transfer rows to insert
    post: torch.Tensor  # bool[N]
    posted_key: torch.Tensor  # int64[N] pending timestamps (0 = none)
    pv_ok: torch.Tensor  # bool[N]
    s_slot: torch.Tensor  # int64[2N] sorted leg slots (capacity = sentinel)
    scat: torch.Tensor  # bool[2N] last live leg of each slot run
    bal_incl: Dict[str, torch.Tensor]  # {field_lo/_hi: int64[2N]}
    do_hist: torch.Tensor  # bool[N]
    hist_row: Dict[str, torch.Tensor]
    passes: torch.Tensor  # int32 0-dim: Jacobi passes taken
    wave_bound: torch.Tensor  # int32 0-dim: proved pass bound, 0 if none
    wave_hist: torch.Tensor  # int32[9] wave-depth histogram


def _first_code(checks, like: torch.Tensor) -> torch.Tensor:
    """Vector precedence ladder: the FIRST firing (mask, code) wins."""
    code = torch.zeros_like(like, dtype=torch.int32)
    for cond, c in reversed(checks):
        if isinstance(c, torch.Tensor):
            code = torch.where(cond, c, code)
        else:
            code = torch.where(cond, torch.full_like(code, c), code)
    return code


# ---------------------------------------------------------------------------
# K9: the batch id index
# ---------------------------------------------------------------------------


class IdIndex(NamedTuple):
    """The batch's id groups and the in-batch pending join."""

    group_of_lane: torch.Tensor  # int64[N]: lowest lane with the same id
    any_dup: torch.Tensor  # bool 0-dim: some nonzero id occurs twice
    pj_hit: torch.Tensor  # bool[N]: some lane's id equals my pending_id
    pj_group: torch.Tensor  # int64[N]: that lane's group (0 where no hit)


def _ukey(x: torch.Tensor) -> torch.Tensor:
    """int64 bits whose signed order is the u64 order of ``x``."""
    return x ^ u128.INT64_MIN


def _search128(s_hi, s_lo, q_hi, q_lo) -> torch.Tensor:
    """First sorted index with (s_hi, s_lo) >= (q_hi, q_lo): a batched binary
    search over 128-bit pairs (u64 order on int64 bits)."""
    n = s_hi.shape[0]
    lo = torch.zeros(q_lo.shape, dtype=torch.int64, device=q_lo.device)
    hi = torch.full(q_lo.shape, n, dtype=torch.int64, device=q_lo.device)
    for _ in range(int(n).bit_length()):
        mid = torch.clamp((lo + hi) // 2, max=n - 1)
        m_hi, m_lo = s_hi[mid], s_lo[mid]
        less = ult(m_hi, q_hi) | ((m_hi == q_hi) & ult(m_lo, q_lo))
        active = lo < hi
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo


def _build_id_index(id_lo, id_hi, pend_lo, pend_hi) -> IdIndex:
    """Group equal batch ids and join each lane's pending_id to the group of
    the lane whose id it names.  Kernel K9 on CUDA tensors."""
    if id_lo.is_cuda:
        return IdIndex(*_cuda.full_index(id_lo, id_hi, pend_lo, pend_hi))
    return _build_id_index_plain(id_lo, id_hi, pend_lo, pend_hi)


def _build_id_index_plain(id_lo, id_hi, pend_lo, pend_hi) -> IdIndex:
    """Plain version of K9: a lexsort by (id, lane), run ids and a binary
    search (the JAX package's ``_build_id_index`` and ``_search128``)."""
    n = id_lo.shape[0]
    dev = id_lo.device
    lane = torch.arange(n, device=dev)
    _, o1 = torch.sort(_ukey(id_lo), stable=True)
    _, o2 = torch.sort(_ukey(id_hi[o1]), stable=True)
    order = o1[o2]
    s_lo, s_hi = id_lo[order], id_hi[order]
    same = (s_lo[1:] == s_lo[:-1]) & (s_hi[1:] == s_hi[:-1])
    new_group = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ~same])
    # The leader of a sorted run is its first (lowest) lane.
    head_lane = torch.where(new_group, order, torch.zeros_like(order))
    pos = torch.where(new_group, lane, torch.zeros_like(lane))
    run_start = torch.cummax(pos, 0).values
    leader_sorted = head_lane[run_start]
    group_of_lane = torch.empty(n, dtype=torch.int64, device=dev)
    group_of_lane[order] = leader_sorted
    any_dup = (same & ((s_lo[1:] != 0) | (s_hi[1:] != 0))).any()

    pj = _search128(s_hi, s_lo, pend_hi, pend_lo)
    pj_c = torch.clamp(pj, max=n - 1)
    pj_hit = (s_hi[pj_c] == pend_hi) & (s_lo[pj_c] == pend_lo) & (pj < n)
    pj_group = torch.where(pj_hit, leader_sorted[pj_c], torch.zeros_like(pj))
    return IdIndex(group_of_lane, any_dup, pj_hit, pj_group)


def _group_winner(idx: IdIndex, ok: torch.Tensor):
    """(per-group, per-lane) first ok lane of each id group (n if none); the
    per-group array is indexed by the group's label."""
    n = ok.shape[0]
    lane = torch.arange(n, device=ok.device)
    cand = torch.where(ok, lane, torch.full_like(lane, n))
    winner_g = torch.full((n,), n, dtype=torch.int64, device=ok.device)
    winner_g.scatter_reduce_(0, idx.group_of_lane, cand, "amin")
    return winner_g, winner_g[idx.group_of_lane]


# ---------------------------------------------------------------------------
# K10: leg balances
# ---------------------------------------------------------------------------


def _limbs_to_u128(lo_limb: torch.Tensor, hi_limb: torch.Tensor) -> U128:
    """Recombine 32-bit limb sums (each < 2**47 for <= 2**15 terms) into
    u128: lo_limb + hi_limb * 2**32."""
    low = lo_limb + ((hi_limb & _U32MASK) << 32)
    carry = ult(low, lo_limb).to(torch.int64)
    return U128(low, srl(hi_limb, 32) + carry)


class _LegBalances(NamedTuple):
    """Per-leg exact account state around each event (sorted leg domain)."""

    leg_pos: torch.Tensor  # int64[2N]: leg index -> sorted position
    dp_pre: U128
    dp_incl: U128
    dpo_pre: U128
    dpo_incl: U128
    cp_pre: U128
    cp_incl: U128
    cpo_pre: U128
    cpo_incl: U128
    s_slot: torch.Tensor  # int64[2N] sorted slot (capacity = sentinel)
    s_live: torch.Tensor  # bool[2N]
    is_last: torch.Tensor  # bool[2N]: last leg of its slot run
    arith_broken: torch.Tensor  # bool 0-dim


def _leg_balances(start_bal, cap_sentinel: int, ok_lanes, amt_lo, pamt_lo,
                  dr_slot, cr_slot, dr_live, cr_live, pending_f, post,
                  postvoid, has_postvoid: bool = True) -> _LegBalances:
    """Exact running balances of all four account fields at every leg.

    Legs 2i (debit) / 2i+1 (credit) sorted by (slot, leg position); leg
    position order is event order, so sums within slot runs give each
    account's exact fields before/after every event.  Deltas are gated by
    ``ok_lanes`` (the previous iterate); ``amt_lo``/``pamt_lo`` are its
    effective / pending amounts (u64: u128 amounts route to FLAG_SEQ).
    ``start_bal`` holds each LEG's account start balances
    ({field_lo/_hi: int64[2N]}).  Kernel K10 on CUDA tensors."""
    if ok_lanes.is_cuda:
        return _legs_from_buffers(_cuda.full_legs(
            start_bal, cap_sentinel, ok_lanes, amt_lo, pamt_lo, dr_slot,
            cr_slot, dr_live, cr_live, pending_f, post, postvoid, has_postvoid))
    return _leg_balances_plain(start_bal, cap_sentinel, ok_lanes, amt_lo,
                               pamt_lo, dr_slot, cr_slot, dr_live, cr_live,
                               pending_f, post, postvoid, has_postvoid)


def _legs_from_buffers(b: Dict) -> _LegBalances:
    """_LegBalances over K10's output buffers (``_cuda.legs_buffers``)."""
    v = b["val"]
    return _LegBalances(
        leg_pos=b["leg_pos"],
        dp_pre=U128(v[0], v[1]), dp_incl=U128(v[2], v[3]),
        dpo_pre=U128(v[4], v[5]), dpo_incl=U128(v[6], v[7]),
        cp_pre=U128(v[8], v[9]), cp_incl=U128(v[10], v[11]),
        cpo_pre=U128(v[12], v[13]), cpo_incl=U128(v[14], v[15]),
        s_slot=b["s_slot"], s_live=b["s_live"], is_last=b["is_last"],
        arith_broken=b["arith"][0],
    )


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a, b], dim=1).reshape(-1)


def _leg_balances_plain(start_bal, cap_sentinel, ok_lanes, amt_lo, pamt_lo,
                        dr_slot, cr_slot, dr_live, cr_live, pending_f, post,
                        postvoid, has_postvoid=True) -> _LegBalances:
    """Plain version of K10: one sort, then segmented sums of the six delta
    streams as 32-bit limb sums (exact in int64 over <= 2**15 legs), run
    bases from a cummax (exclusive sums at run heads never decrease)."""
    n = ok_lanes.shape[0]
    dev = ok_lanes.device
    leg_slot_raw = _interleave(dr_slot, cr_slot)
    leg_live_raw = _interleave(dr_live, cr_live)
    leg_ok = ok_lanes.repeat_interleave(2)
    leg_is_dr = (torch.arange(2 * n, device=dev) & 1) == 0
    leg_slot = torch.where(leg_live_raw, leg_slot_raw,
                           torch.full_like(leg_slot_raw, cap_sentinel))

    amt2 = amt_lo.repeat_interleave(2)
    pamt2 = pamt_lo.repeat_interleave(2)
    pend2 = pending_f.repeat_interleave(2)
    post2 = post.repeat_interleave(2)
    pv2 = postvoid.repeat_interleave(2)
    reg2 = ~pend2 & ~pv2
    zero = torch.zeros_like(amt2)
    on = leg_ok
    deltas = {
        "dp_add": torch.where(on & leg_is_dr & pend2, amt2, zero),
        "dp_sub": torch.where(on & leg_is_dr & pv2, pamt2, zero),
        "dpo_add": torch.where(on & leg_is_dr & (reg2 | post2), amt2, zero),
        "cp_add": torch.where(on & ~leg_is_dr & pend2, amt2, zero),
        "cp_sub": torch.where(on & ~leg_is_dr & pv2, pamt2, zero),
        "cpo_add": torch.where(on & ~leg_is_dr & (reg2 | post2), amt2, zero),
    }

    sort_key = (leg_slot << 15) | torch.arange(2 * n, device=dev)
    _, leg_order = torch.sort(sort_key, stable=True)
    s_slot = leg_slot[leg_order]
    s_live = s_slot < cap_sentinel
    change = s_slot[1:] != s_slot[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    s_head = torch.cat([one, change])
    is_last = torch.cat([change, one])
    leg_pos = torch.empty(2 * n, dtype=torch.int64, device=dev)
    leg_pos[leg_order] = torch.arange(2 * n, device=dev)

    def seg_sums(d):
        """(exclusive, inclusive) segmented sums of a u64 stream as U128."""
        d = d[leg_order]
        out = []
        for part in (d & _U32MASK, srl(d, 32)):
            c = torch.cumsum(part, 0)
            base = torch.cummax(torch.where(s_head, c - part,
                                            torch.zeros_like(c)), 0).values
            incl = c - base
            out.append((incl - part, incl))
        (lo_e, lo_i), (hi_e, hi_i) = out
        return _limbs_to_u128(lo_e, hi_e), _limbs_to_u128(lo_i, hi_i)

    def field_vals(field, add_name, sub_name):
        start = U128(start_bal[field + "_lo"][leg_order],
                     start_bal[field + "_hi"][leg_order])
        add_e, add_i = seg_sums(deltas[add_name])
        if sub_name is not None and has_postvoid:
            sub_e, sub_i = seg_sums(deltas[sub_name])
        else:
            z = torch.zeros(2 * n, dtype=torch.int64, device=dev)
            sub_e = sub_i = U128(z, z)

        def at(add, sub):
            added, ov = u128.add(start, add)
            val, neg = u128.sub(added, sub)
            return val, ov | neg

        pre, bad_e = at(add_e, sub_e)
        incl, bad_i = at(add_i, sub_i)
        return pre, incl, bad_e | bad_i

    dp_pre, dp_incl, bad1 = field_vals("debits_pending", "dp_add", "dp_sub")
    dpo_pre, dpo_incl, bad2 = field_vals("debits_posted", "dpo_add", None)
    cp_pre, cp_incl, bad3 = field_vals("credits_pending", "cp_add", "cp_sub")
    cpo_pre, cpo_incl, bad4 = field_vals("credits_posted", "cpo_add", None)
    arith_broken = (s_live & (bad1 | bad2 | bad3 | bad4)).any()
    return _LegBalances(
        leg_pos=leg_pos,
        dp_pre=dp_pre, dp_incl=dp_incl, dpo_pre=dpo_pre, dpo_incl=dpo_incl,
        cp_pre=cp_pre, cp_incl=cp_incl, cpo_pre=cpo_pre, cpo_incl=cpo_incl,
        s_slot=s_slot, s_live=s_live, is_last=is_last,
        arith_broken=arith_broken,
    )


def _legs_stale(leg_slot: torch.Tensor, cache) -> bool:
    """K10's test of the sort cache (keys, slots, ok word): stale when
    there is none, it is marked invalid, or a leg's slot is not the one it
    sorted."""
    return (cache is None or int(cache[2][0]) == 0
            or not torch.equal(cache[1], leg_slot))


def _legs_chunk_sort(leg_slot: torch.Tensor, chunk: int) -> torch.Tensor:
    """K10's stale sort (full_common.cuh's chunk sort): the legs' (slot <<
    15 | leg) keys padded to a power of two, each chunk sorted on its own,
    then every real key placed at its rank (its place in its chunk plus the
    keys of the other chunks below it; the pad, above every key, is never
    placed).  The sorted keys of the 2n legs."""
    n2 = leg_slot.shape[0]
    dev = leg_slot.device
    p = _cuda.legs_pad(n2 // 2)
    c = min(p, chunk)
    pad = torch.full((p,), (1 << 63) - 1, dtype=torch.int64, device=dev)
    pad[:n2] = (leg_slot << 15) | torch.arange(n2, device=dev)
    chunks = torch.sort(pad.view(p // c, c), dim=1).values
    staged = chunks.reshape(-1)[:n2]
    pos = torch.arange(n2, device=dev)
    own = pos // c
    rank = pos - own * c
    for o in range(p // c):
        below = torch.searchsorted(chunks[o], staged)
        rank = rank + torch.where(own == o, torch.zeros_like(below), below)
    keys = torch.empty(n2, dtype=torch.int64, device=dev)
    keys[rank] = staged
    return keys


def _leg_balances_split_plain(start_bal, cap_sentinel, ok_lanes, amt_lo,
                              pamt_lo, dr_slot, cr_slot, dr_live, cr_live,
                              pending_f, post, postvoid, has_postvoid=True,
                              cache=None, block: int = _cuda.LEG_THREADS,
                              chunk: int = _cuda.LEG_CHUNK) -> _LegBalances:
    """Plain version of K10 in the kernel's steps: the sorted keys from
    ``cache`` (keys, slots, ok word; refreshed in place when stale, as the
    kernel does) or the chunk sort; each block of ``block`` sorted legs
    scanned on its own (six streams of 32-bit limb sums, one head); the
    blocks' aggregates folded in order into each block's carry; then the
    four fields.  Same outputs as ``_leg_balances_plain``."""
    n = ok_lanes.shape[0]
    n2 = 2 * n
    dev = ok_lanes.device
    leg_slot = torch.where(_interleave(dr_live, cr_live),
                           _interleave(dr_slot, cr_slot),
                           torch.full((n2,), cap_sentinel, dtype=torch.int64,
                                      device=dev))
    if _legs_stale(leg_slot, cache):
        keys = _legs_chunk_sort(leg_slot, chunk)
        if cache is not None:
            cache[0][:n2] = keys
            cache[1].copy_(leg_slot)
            cache[2].fill_(1)
    else:
        keys = cache[0][:n2].clone()

    # Each sorted leg: its slot, leg, lane, run head and the six deltas.
    s_slot = srl(keys, 15)
    leg = keys & 0x7FFF
    lane = leg >> 1
    dr = (leg & 1) == 0
    change = s_slot[1:] != s_slot[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    head = torch.cat([one, change])
    is_last = torch.cat([change, one])
    ok = ok_lanes[lane]
    pend, pv, pst = pending_f[lane], postvoid[lane], post[lane]
    amt, pamt = amt_lo[lane], pamt_lo[lane]
    zero = torch.zeros_like(amt)
    add = torch.where(ok & pend, amt, zero)
    sub = torch.where(ok & pv, pamt, zero) if has_postvoid else zero
    posted = torch.where(ok & ((~pend & ~pv) | pst), amt, zero)
    d = [torch.where(dr, add, zero), torch.where(dr, sub, zero),
         torch.where(dr, posted, zero), torch.where(dr, zero, add),
         torch.where(dr, zero, sub), torch.where(dr, zero, posted)]

    # Block scans: every stream's two 32-bit limbs at once, [12, B, block].
    blocks = -(-n2 // block)
    padded = blocks * block
    limbs = torch.zeros((12, padded), dtype=torch.int64, device=dev)
    for k, x in enumerate(d):
        limbs[2 * k, :n2] = x & _U32MASK
        limbs[2 * k + 1, :n2] = srl(x, 32)
    limbs = limbs.view(12, blocks, block)
    h = torch.zeros(padded, dtype=torch.bool, device=dev)
    h[:n2] = head
    h = h.view(blocks, block)
    c = torch.cumsum(limbs, 2)
    base = torch.cummax(torch.where(h, c - limbs, torch.zeros_like(c)),
                        2).values
    incl = c - base  # within the block, from its last head
    seen = torch.cummax(h.to(torch.int64), 1).values.bool()
    # The carries: each block's aggregate folded in block order.
    agg_v, agg_h = incl[:, :, -1], h.any(1)
    carry = torch.zeros((12, blocks), dtype=torch.int64, device=dev)
    acc = torch.zeros(12, dtype=torch.int64, device=dev)
    for b in range(blocks):
        carry[:, b] = acc
        acc = agg_v[:, b] if bool(agg_h[b]) else acc + agg_v[:, b]
    incl = torch.where(seen, incl, incl + carry[:, :, None])
    incl = incl.reshape(12, padded)[:, :n2]
    excl = incl - limbs.reshape(12, padded)[:, :n2]

    def stream(k):
        """(exclusive, inclusive) sums of stream k as U128."""
        return (_limbs_to_u128(excl[2 * k], excl[2 * k + 1]),
                _limbs_to_u128(incl[2 * k], incl[2 * k + 1]))

    s_live = s_slot < cap_sentinel
    vals, bad = [], torch.zeros(n2, dtype=torch.bool, device=dev)
    for f, (field, add_s, sub_s) in enumerate(
            (("debits_pending", 0, 1), ("debits_posted", 2, None),
             ("credits_pending", 3, 4), ("credits_posted", 5, None))):
        start = U128(start_bal[field + "_lo"][leg], start_bal[field + "_hi"][leg])
        add_e, add_i = stream(add_s)
        if sub_s is None:
            z = torch.zeros(n2, dtype=torch.int64, device=dev)
            sub_e = sub_i = U128(z, z)
        else:
            sub_e, sub_i = stream(sub_s)
        for a_, s_ in ((add_e, sub_e), (add_i, sub_i)):
            added, ov = u128.add(start, a_)
            val, neg = u128.sub(added, s_)
            vals.append(val)
            bad = bad | ov | neg
    leg_pos = torch.empty(n2, dtype=torch.int64, device=dev)
    leg_pos[leg] = torch.arange(n2, device=dev)
    return _LegBalances(
        leg_pos=leg_pos,
        dp_pre=vals[0], dp_incl=vals[1], dpo_pre=vals[2], dpo_incl=vals[3],
        cp_pre=vals[4], cp_incl=vals[5], cpo_pre=vals[6], cpo_incl=vals[7],
        s_slot=s_slot, s_live=s_live, is_last=is_last,
        arith_broken=(s_live & bad).any(),
    )


# ---------------------------------------------------------------------------
# K12: the wave schedule
# ---------------------------------------------------------------------------


def _wave_schedule(hazard, unschedulable, wdr_slot, wdr_live, wcr_slot,
                   wcr_live, valid, cap_sentinel: int, max_rounds: int):
    """Conflict-index wave scheduler (docs/waves.md): every lane's wave
    depth (0 for lanes whose outcome cannot change across Jacobi iterates;
    for a hazard lane 1 + the deepest earlier hazard lane sharing one of its
    accounts), by at most ``max_rounds`` relaxation rounds.  Returns
    (proved bool 0-dim, passes_needed int32 0-dim, depth int32[N],
    hist int32[9]).  Kernel K12 on CUDA tensors."""
    if hazard.is_cuda:
        return _cuda.full_waves(hazard, unschedulable, wdr_slot, wdr_live,
                                wcr_slot, wcr_live, valid, cap_sentinel,
                                max_rounds)
    return _wave_schedule_plain(hazard, unschedulable, wdr_slot, wdr_live,
                                wcr_slot, wcr_live, valid, cap_sentinel,
                                max_rounds)


def _wave_schedule_plain(hazard, unschedulable, wdr_slot, wdr_live, wcr_slot,
                         wcr_live, valid, cap_sentinel, max_rounds):
    """Plain version of K12: the JAX relaxation rounds, each a segmented
    exclusive running max through (run_id << 32 | depth) packing."""
    n = hazard.shape[0]
    dev = hazard.device
    leg_slot = _interleave(wdr_slot, wcr_slot)
    leg_live = _interleave(wdr_live, wcr_live)
    leg_slot = torch.where(leg_live, leg_slot,
                           torch.full_like(leg_slot, cap_sentinel))
    _, leg_order = torch.sort((leg_slot << 15) | torch.arange(2 * n, device=dev),
                              stable=True)
    s_slot = leg_slot[leg_order]
    s_head = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        s_slot[1:] != s_slot[:-1]])
    s_lane = leg_order >> 1
    s_live = s_slot < cap_sentinel
    run_id = torch.cumsum(s_head.to(torch.int64), 0) - 1

    depth = torch.where(hazard, 1, 0).to(torch.int32)
    changed = True
    rounds = 0
    while changed and rounds < max_rounds:
        leg_depth = torch.where(s_live, depth[s_lane],
                                torch.zeros_like(depth[s_lane])).to(torch.int64)
        packed = (run_id << 32) | leg_depth
        incl = torch.cummax(packed, 0).values
        excl = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          incl[:-1]])
        excl_val = torch.where(s_live & ((excl >> 32) == run_id),
                               excl & _U32MASK, torch.zeros_like(excl))
        prior = torch.zeros(n, dtype=torch.int64, device=dev)
        prior.scatter_reduce_(0, s_lane, excl_val, "amax")
        new_depth = torch.where(hazard, torch.maximum(depth.to(torch.int64),
                                                      1 + prior),
                                torch.zeros_like(prior)).to(torch.int32)
        changed = bool((new_depth != depth).any())
        depth = new_depth
        rounds += 1
    proved = ~unschedulable & torch.tensor(not changed, device=dev)
    passes_needed = (torch.where(valid, depth, torch.zeros_like(depth)).max()
                     + 1).to(torch.int32)
    hist = torch.bincount(torch.clamp(depth[valid], 0, 8).to(torch.int64),
                          minlength=9)[:9].to(torch.int32)
    return proved, passes_needed, depth, hist


# ---------------------------------------------------------------------------
# The gather context (K1)
# ---------------------------------------------------------------------------


def _account_view(look: ht.LookupResult) -> AccountView:
    cols = look.cols
    return AccountView(found=look.found, slot=look.slot, flags=cols["flags"],
                       ledger=cols["ledger"],
                       bal={c: cols[c] for c in _BAL_COLS})


_ACCOUNT_VIEW_COLS = ("flags", "ledger") + _BAL_COLS


def _empty_view(n: int, dev) -> AccountView:
    z64 = torch.zeros(n, dtype=torch.int64, device=dev)
    z32 = torch.zeros(n, dtype=torch.int32, device=dev)
    return AccountView(found=torch.zeros(n, dtype=torch.bool, device=dev),
                       slot=z64, flags=z32, ledger=z32,
                       bal={c: z64 for c in _BAL_COLS})


def gather_lookups(ledger: Ledger, batch: Dict[str, torch.Tensor],
                   valid: torch.Tensor, postvoid: torch.Tensor,
                   cold_test: bool, has_postvoid: bool) -> list:
    """``build_gather_ctx``'s lookups: the transfer ids, the debit and
    credit accounts and, with ``has_postvoid``, the pending's row, then on
    the same thread its accounts and posted row; each with its FLAG_GROW_*
    bit, and with ``cold_test`` the ids and pending ids tested against the
    cold tier's filter (``hash_table.lookup_flags``)."""
    xfr_cols = tuple(TRANSFER_COLS)
    looks = [
        ht.Lookup(ledger.transfers, batch["id_lo"], batch["id_hi"], xfr_cols,
                  mask=valid, grow_bit=FLAG_GROW_TRANSFERS, cold=cold_test),
        ht.Lookup(ledger.accounts, batch["debit_account_id_lo"],
                  batch["debit_account_id_hi"], _ACCOUNT_VIEW_COLS, mask=valid,
                  grow_bit=FLAG_GROW_ACCOUNTS),
        ht.Lookup(ledger.accounts, batch["credit_account_id_lo"],
                  batch["credit_account_id_hi"], _ACCOUNT_VIEW_COLS,
                  mask=valid, grow_bit=FLAG_GROW_ACCOUNTS),
    ]
    if has_postvoid:
        # The pending's row, then, on the same thread, the accounts and the
        # fulfillment of a TABLE pending (keys zero elsewhere).
        looks += [
            ht.Lookup(ledger.transfers, batch["pending_id_lo"],
                      batch["pending_id_hi"], xfr_cols, mask=postvoid,
                      grow_bit=FLAG_GROW_TRANSFERS, cold=cold_test),
            ht.Lookup(ledger.accounts, None, cols=_ACCOUNT_VIEW_COLS,
                      keys_from=(3, "debit_account_id_lo",
                                 "debit_account_id_hi"),
                      grow_bit=FLAG_GROW_ACCOUNTS),
            ht.Lookup(ledger.accounts, None, cols=_ACCOUNT_VIEW_COLS,
                      keys_from=(3, "credit_account_id_lo",
                                 "credit_account_id_hi"),
                      grow_bit=FLAG_GROW_ACCOUNTS),
            ht.Lookup(ledger.posted, None, cols=("fulfillment",),
                      keys_from=(3, "timestamp", None),
                      grow_bit=FLAG_GROW_POSTED),
        ]
    return looks


def build_gather_ctx(ledger: Ledger, batch: Dict[str, torch.Tensor],
                     valid: torch.Tensor, postvoid: torch.Tensor,
                     bloom=None, cold_checked=None,
                     has_postvoid: bool = True) -> GatherCtx:
    """Local probes of the ledger tables (kernel K1 on CUDA tensors): three,
    or seven with post/void lanes (``has_postvoid``, a static host hint).
    Each probe's found flags and gathered columns are masked as the JAX
    package masks them (``valid``, ``postvoid``, the pending's row found);
    its overflow covers every lane.  With ``bloom`` (the cold ids' filter)
    an id or pending id that misses the hot table, on a lane not
    ``cold_checked``, and hits the filter ORs ``FLAG_COLD`` into the flags.
    All of it is ``hash_table.lookup_flags``, whose flag word is
    ``probe_grow``: on CUDA tensors one K1 launch (K17's test a step of
    it), on CPU tensors its plain version in the kernel's steps."""
    n = batch["id_lo"].shape[0]
    dev = batch["id_lo"].device
    looks = gather_lookups(ledger, batch, valid, postvoid, bloom is not None,
                           has_postvoid)
    got, probe_grow = ht.lookup_flags(looks, MAX_PROBE, bloom, cold_checked,
                                      FLAG_COLD)
    ex_look, dr_look, cr_look = got[:3]
    if has_postvoid:
        p_look, pdr_look, pcr_look, posted_look = got[3:]
        p_tab = p_look.cols
        p_tab_found = p_look.found
        pdr, pcr = _account_view(pdr_look), _account_view(pcr_look)
        postedT_found = posted_look.found
        postedT_val = posted_look.cols["fulfillment"]
    else:
        p_tab_found = torch.zeros(n, dtype=torch.bool, device=dev)
        z64 = torch.zeros(n, dtype=torch.int64, device=dev)
        z32 = torch.zeros(n, dtype=torch.int32, device=dev)
        p_tab = {k: (z64 if dt == torch.int64 else z32)
                 for k, dt in TRANSFER_COLS.items()}
        pdr = pcr = _empty_view(n, dev)
        postedT_found = p_tab_found
        postedT_val = z32
    return GatherCtx(
        ex_found=ex_look.found, e_tab=ex_look.cols, p_tab_found=p_tab_found,
        p_tab=p_tab, drT=_account_view(dr_look), crT=_account_view(cr_look),
        pdr=pdr, pcr=pcr, postedT_found=postedT_found, postedT_val=postedT_val,
        probe_grow=probe_grow, accounts_capacity=ledger.accounts.capacity,
    )


# ---------------------------------------------------------------------------
# The exists ladders
# ---------------------------------------------------------------------------


def _exists_regular(t, e, t_amount: U128) -> torch.Tensor:
    """create_transfer_exists (state_machine.zig:1370-1389): ``t`` the raw
    event, ``e`` the stored/winner row, ``t_amount`` the RAW event amount."""

    def ne128(name):
        return (t[name + "_lo"] != e[name + "_lo"]) | (
            t[name + "_hi"] != e[name + "_hi"])

    c = torch.full_like(t["flags"], 46)

    def put(mask, code):
        return torch.where(mask, torch.full_like(c, code), c)

    c = put(t["code"] != e["code"], 45)
    c = put(t["timeout"] != e["timeout"], 44)
    c = put(t["user_data_32"] != e["user_data_32"], 43)
    c = put(t["user_data_64"] != e["user_data_64"], 42)
    c = put(ne128("user_data_128"), 41)
    amount_ne = (t_amount.lo != e["amount_lo"]) | (t_amount.hi != e["amount_hi"])
    c = put(ne128("pending_id"), 40)
    c = put(amount_ne, 39)
    c = put(ne128("credit_account_id"), 38)
    c = put(ne128("debit_account_id"), 37)
    c = put(t["flags"] != e["flags"], 36)
    return c


def _exists_postvoid(t, e, p) -> torch.Tensor:
    """post_or_void_pending_transfer_exists (state_machine.zig:1500-1561)."""

    def pair_ne(a, b, name):
        return (a[name + "_lo"] != b[name + "_lo"]) | (
            a[name + "_hi"] != b[name + "_hi"])

    t_amount_zero = (t["amount_lo"] == 0) & (t["amount_hi"] == 0)
    amount_ne = torch.where(t_amount_zero, pair_ne(e, p, "amount"),
                            pair_ne(t, e, "amount"))
    ud128_zero = (t["user_data_128_lo"] == 0) & (t["user_data_128_hi"] == 0)
    ud128_ne = torch.where(ud128_zero, pair_ne(e, p, "user_data_128"),
                           pair_ne(t, e, "user_data_128"))
    ud64_ne = torch.where(t["user_data_64"] == 0,
                          e["user_data_64"] != p["user_data_64"],
                          t["user_data_64"] != e["user_data_64"])
    ud32_ne = torch.where(t["user_data_32"] == 0,
                          e["user_data_32"] != p["user_data_32"],
                          t["user_data_32"] != e["user_data_32"])
    c = torch.full_like(t["flags"], 46)

    def put(mask, code):
        return torch.where(mask, torch.full_like(c, code), c)

    c = put(ud32_ne, 43)
    c = put(ud64_ne, 42)
    c = put(ud128_ne, 41)
    c = put(pair_ne(t, e, "pending_id"), 40)
    c = put(amount_ne, 39)
    c = put(t["flags"] != e["flags"], 36)
    return c


# ---------------------------------------------------------------------------
# The kernel core: the Jacobi fixpoint (K9-K12 on CUDA tensors)
# ---------------------------------------------------------------------------


def _wave_inputs(ctx: GatherCtx, batch, count: int, has_postvoid: bool,
                 idx: IdIndex):
    """The wave scheduler's inputs (the plain form of K11's set-up): HAZARD
    lanes, the only ones whose (code, amount) can change across Jacobi
    iterates (balancing, limit accounts, start balances within one batch's
    delta margin of u128 overflow); whether the batch is unschedulable
    (linked chains, duplicate ids, in-batch pending references); and the
    effective debit/credit slots.  Returns (hazard, unschedulable, wdr_slot,
    wdr_live, wcr_slot, wcr_live)."""
    n = batch["id_lo"].shape[0]
    dev = batch["id_lo"].device
    valid = torch.arange(n, device=dev) < count
    flags = batch["flags"]
    linked = ((flags & TF_LINKED) != 0) & valid
    balancing = ((flags & (TF_BALANCING_DEBIT | TF_BALANCING_CREDIT)) != 0) & valid
    drT, crT, pdr, pcr = ctx.drT, ctx.crT, ctx.pdr, ctx.pcr
    dr_limf = ((drT.flags & AF_DEBITS_MUST_NOT_EXCEED_CREDITS) != 0) & drT.found
    cr_limf = ((crT.flags & AF_CREDITS_MUST_NOT_EXCEED_DEBITS) != 0) & crT.found
    near_w = torch.tensor(_NEAR_W, device=dev)

    def near_start(v: AccountView):
        return v.found & (uge(v.bal["debits_pending_hi"], near_w)
                          | uge(v.bal["debits_posted_hi"], near_w)
                          | uge(v.bal["credits_pending_hi"], near_w)
                          | uge(v.bal["credits_posted_hi"], near_w))

    hazard = valid & (balancing | dr_limf | cr_limf | near_start(drT)
                      | near_start(crT))
    unschedulable = linked.any() | idx.any_dup
    if has_postvoid:
        postvoid = ((flags & (TF_POST | TF_VOID)) != 0) & valid
        hazard = hazard | (postvoid & (near_start(pdr) | near_start(pcr)))
        unschedulable = unschedulable | (postvoid & idx.pj_hit).any()
        return (hazard, unschedulable,
                torch.where(postvoid, pdr.slot, drT.slot),
                torch.where(postvoid, pdr.found, drT.found & valid),
                torch.where(postvoid, pcr.slot, crT.slot),
                torch.where(postvoid, pcr.found, crT.found & valid))
    return (hazard, unschedulable, drT.slot, drT.found & valid, crT.slot,
            crT.found & valid)


def _kernel_core(ctx: GatherCtx, batch: Dict[str, torch.Tensor], count: int,
                 timestamp: int, max_passes: int = _MAX_PASSES,
                 has_postvoid: bool = True, use_waves: bool = False
                 ) -> ApplyPlan:
    """The pure batch semantics: no table access.  The early-exit (while)
    form of the JAX loop (its fixed-trip form, a TPU scheduling device,
    returns the same values).  On CUDA tensors K9, K12 and ``max_passes`` +
    1 rounds of K11/K10/K11 launches with the loop state on the card (no
    host read)."""
    if batch["id_lo"].is_cuda:
        return _kernel_core_cuda(ctx, batch, count, timestamp, max_passes,
                                 has_postvoid, use_waves)
    return _kernel_core_plain(ctx, batch, count, timestamp, max_passes,
                              has_postvoid, use_waves)


def _kernel_core_plain(ctx, batch, count, timestamp, max_passes=_MAX_PASSES,
                       has_postvoid=True, use_waves=False) -> ApplyPlan:
    """Plain version of the kernel core (K9-K12)."""
    n = batch["id_lo"].shape[0]
    assert n <= 1 << 14, "leg sort key packs (slot, legpos < 2^15)"
    dev = batch["id_lo"].device
    lane = torch.arange(n, device=dev)
    valid = lane < count
    ts = _timestamps(count, timestamp, n, dev)
    inf = n

    tid = _u128_col(batch, "id")
    t_dr_id = _u128_col(batch, "debit_account_id")
    t_cr_id = _u128_col(batch, "credit_account_id")
    t_amt = _u128_col(batch, "amount")
    pend_id = _u128_col(batch, "pending_id")
    flags = batch["flags"]
    false_n = torch.zeros(n, dtype=torch.bool, device=dev)
    if has_postvoid:
        post = ((flags & TF_POST) != 0) & valid
        void = ((flags & TF_VOID) != 0) & valid
        postvoid = post | void
    else:
        post = void = postvoid = false_n
    pending_f = ((flags & TF_PENDING) != 0) & valid
    linked = ((flags & TF_LINKED) != 0) & valid
    bal_dr = ((flags & TF_BALANCING_DEBIT) != 0) & valid
    bal_cr = ((flags & TF_BALANCING_CREDIT) != 0) & valid
    balancing = bal_dr | bal_cr

    ex_found, e_tab = ctx.ex_found, ctx.e_tab
    p_tab_found, p_tab = ctx.p_tab_found, ctx.p_tab
    drT, crT, pdr, pcr = ctx.drT, ctx.crT, ctx.pdr, ctx.pcr
    cap_sentinel = ctx.accounts_capacity

    idx = _build_id_index_plain(tid.lo, tid.hi, pend_id.lo, pend_id.hi)
    pj_hit = idx.pj_hit

    timeout_ns = (batch["timeout"].to(torch.int64) & _U32MASK) * NS_PER_S
    ov_timeout = ult(ts + timeout_ns, ts)
    dr_limf = ((drT.flags & AF_DEBITS_MUST_NOT_EXCEED_CREDITS) != 0) & drT.found
    cr_limf = ((crT.flags & AF_CREDITS_MUST_NOT_EXCEED_DEBITS) != 0) & crT.found

    if use_waves:
        hazard, unschedulable, wdr_slot, wdr_live, wcr_slot, wcr_live = \
            _wave_inputs(ctx, batch, count, has_postvoid, idx)
        sched_proved, passes_needed, _depth, wave_hist = _wave_schedule_plain(
            hazard, unschedulable, wdr_slot, wdr_live, wcr_slot, wcr_live,
            valid, cap_sentinel, max_passes)
        wave_bound = torch.where(sched_proved, passes_needed,
                                 torch.zeros_like(passes_needed))
        sched_proved = bool(sched_proved)
        passes_needed = int(passes_needed)
    else:
        sched_proved = False
        passes_needed = _MAX_PASSES + 1
        wave_bound = torch.zeros((), dtype=torch.int32, device=dev)
        wave_hist = torch.zeros(9, dtype=torch.int32, device=dev)

    def one_pass(ok_prev, amt_prev: U128):
        winner_g, winner_of_lane = _group_winner(idx, ok_prev)
        if has_postvoid:
            pw = torch.where(pj_hit, winner_g[idx.pj_group],
                             torch.full_like(lane, inf))
            pwc = torch.clamp(pw, max=n - 1)
            in_batch_ref = postvoid & pj_hit & (pw < inf) & (pw < lane) \
                & ok_prev[pwc]
            p_found = p_tab_found | in_batch_ref
            p = {}
            for name in TRANSFER_COLS:
                if name == "timestamp":
                    src = ts[pwc]
                elif name == "amount_lo":
                    src = amt_prev.lo[pwc]
                elif name == "amount_hi":
                    src = amt_prev.hi[pwc]
                else:
                    src = batch[name][pwc]
                p[name] = torch.where(in_batch_ref, src, p_tab[name])
            p_is_pending = ((p["flags"] & TF_PENDING) != 0) & p_found
            p_amt = U128(p["amount_lo"], p["amount_hi"])
            p_dr_id = U128(p["debit_account_id_lo"], p["debit_account_id_hi"])
            p_cr_id = U128(p["credit_account_id_lo"], p["credit_account_id_hi"])

            def compose(own: AccountView, pend_side: AccountView):
                def pick(o, pv_):
                    return torch.where(in_batch_ref, o[pwc],
                                       torch.where(postvoid, pv_, o))

                return (pick(own.slot, pend_side.slot),
                        pick(own.found, pend_side.found) & valid,
                        pick(own.flags, pend_side.flags),
                        {k: pick(own.bal[k], pend_side.bal[k]) for k in own.bal})

            dr_slot, dr_live, acc_flags_dr, dr_bal = compose(drT, pdr)
            cr_slot, cr_live, acc_flags_cr, cr_bal = compose(crT, pcr)
        else:
            in_batch_ref = false_n
            p_found = p_tab_found
            p = p_tab
            p_amt = U128(p["amount_lo"], p["amount_hi"])
            dr_slot, dr_live = drT.slot, drT.found & valid
            cr_slot, cr_live = crT.slot, crT.found & valid
            acc_flags_dr, acc_flags_cr = drT.flags, crT.flags
            dr_bal, cr_bal = drT.bal, crT.bal

        start_bal = {k: _interleave(dr_bal[k], cr_bal[k]) for k in dr_bal}
        legs = _leg_balances_plain(
            start_bal, cap_sentinel, ok_prev, amt_prev.lo, p_amt.lo, dr_slot,
            cr_slot, dr_live, cr_live, pending_f, post, postvoid, has_postvoid)
        dpos = legs.leg_pos[2 * lane]
        cpos = legs.leg_pos[2 * lane + 1]

        def at(v: U128, pos):
            return U128(v.lo[pos], v.hi[pos])

        a_dp, a_dpo, a_cpo = (at(legs.dp_pre, dpos), at(legs.dpo_pre, dpos),
                              at(legs.cpo_pre, dpos))
        b_cp, b_cpo, b_dpo = (at(legs.cp_pre, cpos), at(legs.cpo_pre, cpos),
                              at(legs.dpo_pre, cpos))

        # Balancing clamps (state_machine.zig:1286-1306).
        zero = torch.zeros_like(t_amt.lo)
        amount0 = u128.select(balancing & u128.is_zero(t_amt),
                              U128(torch.full_like(zero, _U64MAX), zero), t_amt)
        dr_balance = u128.add_wrap(a_dpo, a_dp)
        avail_dr = u128.sub_saturate(a_cpo, dr_balance)
        amount1 = u128.select(bal_dr, u128.min_(amount0, avail_dr), amount0)
        exceeds_credits_bal = bal_dr & u128.is_zero(amount1)
        cr_balance = u128.add_wrap(b_cpo, b_cp)
        avail_cr = u128.sub_saturate(b_dpo, cr_balance)
        amount2 = u128.select(bal_cr, u128.min_(amount1, avail_cr), amount1)
        exceeds_debits_bal = bal_cr & ~exceeds_credits_bal & u128.is_zero(amount2)
        reg_amount = amount2

        # Overflow ladder (:1308-1322).
        _, ov_dp = u128.add(reg_amount, a_dp)
        _, ov_cp = u128.add(reg_amount, b_cp)
        _, ov_dpo = u128.add(reg_amount, a_dpo)
        _, ov_cpo = u128.add(reg_amount, b_cpo)
        dr_total, _ = u128.add(a_dp, a_dpo)
        _, ov_d = u128.add(reg_amount, dr_total)
        cr_total, _ = u128.add(b_cp, b_cpo)
        _, ov_c = u128.add(reg_amount, cr_total)

        # Balance limits (tigerbeetle.zig:31-39).
        new_dr_tot, _ = u128.add(dr_total, reg_amount)
        exceeds_credits_lim = dr_limf & u128.gt(new_dr_tot, a_cpo)
        new_cr_tot, _ = u128.add(cr_total, reg_amount)
        exceeds_debits_lim = cr_limf & u128.gt(new_cr_tot, b_dpo)

        # Effective amount and composed insert rows.
        row = {name: batch[name] for name in TRANSFER_COLS}
        row["timestamp"] = ts
        if has_postvoid:
            pv_amount = u128.select(u128.is_zero(t_amt), p_amt, t_amt)
            amount = u128.select(postvoid, pv_amount, reg_amount)
            for name in ("debit_account_id", "credit_account_id"):
                for l_ in ("_lo", "_hi"):
                    row[name + l_] = torch.where(postvoid, p[name + l_],
                                                 batch[name + l_])
            ud128_nz = ((batch["user_data_128_lo"] != 0)
                        | (batch["user_data_128_hi"] != 0))
            for l_ in ("_lo", "_hi"):
                row["user_data_128" + l_] = torch.where(
                    postvoid & ~ud128_nz, p["user_data_128" + l_],
                    batch["user_data_128" + l_])
            for name in ("user_data_64", "user_data_32"):
                row[name] = torch.where(postvoid & (batch[name] == 0), p[name],
                                        batch[name])
            row["ledger"] = torch.where(postvoid, p["ledger"], batch["ledger"])
            row["code"] = torch.where(postvoid, p["code"], batch["code"])
            row["timeout"] = torch.where(postvoid,
                                         torch.zeros_like(batch["timeout"]),
                                         batch["timeout"])
        else:
            amount = reg_amount
        row["amount_lo"] = amount.lo
        row["amount_hi"] = amount.hi

        # Regular-path ladder (:1239-1368); the exists check compares the
        # RAW event amount against the stored (possibly clamped) amount.
        exists_tab_reg = _exists_regular(batch, e_tab, t_amt)
        reg_code = _first_code([
            ((flags & TF_PADDING) != 0, 4),
            (u128.is_zero(tid), 5),
            (u128.is_max(tid), 6),
            (u128.is_zero(t_dr_id), 8),
            (u128.is_max(t_dr_id), 9),
            (u128.is_zero(t_cr_id), 10),
            (u128.is_max(t_cr_id), 11),
            (u128.eq(t_dr_id, t_cr_id), 12),
            (~u128.is_zero(pend_id), 13),
            (~pending_f & (batch["timeout"] != 0), 17),
            (~balancing & u128.is_zero(t_amt), 18),
            (batch["ledger"] == 0, 19),
            (batch["code"] == 0, 20),
            (~drT.found, 21),
            (~crT.found, 22),
            (drT.ledger != crT.ledger, 23),
            (batch["ledger"] != drT.ledger, 24),
            (ex_found, exists_tab_reg),
            (exceeds_credits_bal, 54),
            (exceeds_debits_bal, 55),
            (pending_f & ov_dp, 47),
            (pending_f & ov_cp, 48),
            (ov_dpo, 49),
            (ov_cpo, 50),
            (ov_d, 51),
            (ov_c, 52),
            (ov_timeout, 53),
            (exceeds_credits_lim, 54),
            (exceeds_debits_lim, 55),
        ], flags)

        if has_postvoid:
            # Post/void ladder (:1391-1453).
            exists_tab_pv = _exists_postvoid(batch, e_tab, p)
            expiry_ns = (p["timeout"].to(torch.int64) & _U32MASK) * NS_PER_S
            expired = (p["timeout"] != 0) & uge(ts, p["timestamp"] + expiry_ns)
            pv_code = _first_code([
                ((flags & TF_PADDING) != 0, 4),
                (u128.is_zero(tid), 5),
                (u128.is_max(tid), 6),
                (post & void, 7),
                (pending_f, 7),
                (balancing, 7),
                (u128.is_zero(pend_id), 14),
                (u128.is_max(pend_id), 15),
                (u128.eq(pend_id, tid), 16),
                (batch["timeout"] != 0, 17),
                (~p_found, 25),
                (~p_is_pending, 26),
                (~u128.is_zero(t_dr_id) & ~u128.eq(t_dr_id, p_dr_id), 27),
                (~u128.is_zero(t_cr_id) & ~u128.eq(t_cr_id, p_cr_id), 28),
                ((batch["ledger"] != 0) & (batch["ledger"] != p["ledger"]), 29),
                ((batch["code"] != 0) & (batch["code"] != p["code"]), 30),
                (u128.gt(amount, p_amt), 31),
                (void & u128.lt(amount, p_amt), 32),
                (ex_found, exists_tab_pv),
                (ctx.postedT_found & (ctx.postedT_val == 1), 33),
                (ctx.postedT_found & (ctx.postedT_val == 2), 34),
                (expired, 35),
            ], flags)
            code = torch.where(postvoid, pv_code, reg_code)
        else:
            code = reg_code
        code = torch.where(batch["timestamp"] != 0, torch.full_like(code, 3),
                           code)

        # Intra-batch duplicate ids: the override replaces exactly the codes
        # that sit after the exists check in sequential order.
        after_winner = (winner_of_lane < inf) & (lane > winner_of_lane)
        wc = torch.clamp(winner_of_lane, max=n - 1)
        w_row = {k: v[wc] for k, v in row.items()}
        intra_reg = _exists_regular(batch, w_row, t_amt)
        balance_code = torch.zeros_like(false_n)
        for bc in _BALANCE_CODES:
            balance_code = balance_code | (code == bc)
        if has_postvoid:
            intra_pv = _exists_postvoid(batch, w_row, p)
            intra = torch.where(postvoid, intra_pv, intra_reg)
            dup_overridable = torch.where(
                postvoid, (code == 0) | (code == 33) | (code == 34) | (code == 35),
                (code == 0) | (code == 53) | balance_code)
        else:
            intra = intra_reg
            dup_overridable = (code == 0) | (code == 53) | balance_code
        code = torch.where(after_winner & dup_overridable, intra, code)

        if has_postvoid:
            # Intra-batch double post/void, grouped by the resolved pending
            # timestamp: the first lane whose code is 0 records the
            # fulfillment; later ones get already_posted/voided.
            p_ts_key = torch.where(postvoid & p_found, p["timestamp"],
                                   torch.zeros_like(p["timestamp"]))
            _, f_order = torch.sort(_ukey(p_ts_key), stable=True)
            f_ts = p_ts_key[f_order]
            f_head = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                                f_ts[1:] != f_ts[:-1]])
            f_gid = torch.cumsum(f_head.to(torch.int64), 0) - 1
            f_ok = (code[f_order] == 0) & (f_ts != 0)
            f_winner_g = torch.full((n,), inf, dtype=torch.int64, device=dev)
            f_winner_g.scatter_reduce_(
                0, f_gid, torch.where(f_ok, f_order, torch.full_like(f_order, inf)),
                "amin")
            f_winner = torch.empty(n, dtype=torch.int64, device=dev)
            f_winner[f_order] = f_winner_g[f_gid]
            fulfil_after = (f_winner < inf) & (lane > f_winner) & (p_ts_key != 0)
            fwc = torch.clamp(f_winner, max=n - 1)
            fulfil_code = torch.where(post[fwc], torch.full_like(code, 33),
                                      torch.full_like(code, 34))
            code = torch.where(fulfil_after & ((code == 0) | (code == 35)),
                               fulfil_code, code)

        # Linked chains.
        code = torch.where(valid, code, torch.zeros_like(code))
        pre_chain_code = code
        code = _chain_codes(linked, code, count)
        ok = (code == 0) & valid

        near = torch.tensor(_NEAR_OV, device=dev)
        near_ov = (uge(a_dp.hi, near) | uge(a_dpo.hi, near)
                   | uge(b_cp.hi, near) | uge(b_cpo.hi, near))
        aux = dict(in_batch_ref=in_batch_ref, p=p, row=row,
                   acc_flags_dr=acc_flags_dr, acc_flags_cr=acc_flags_cr,
                   legs=legs, pre_chain_code=pre_chain_code, near_ov=near_ov,
                   dpos=dpos, cpos=cpos)
        return ok, code, amount, aux

    # The while form: a pass whose codes and accepted amounts equal the
    # previous pass's is the fixpoint; k counts passes up to and including
    # the stabilizing one; with waves, the loop also stops once the proved
    # number of passes has run.
    ok_f = torch.zeros(n, dtype=torch.bool, device=dev)
    code_f = torch.full((n,), -1, dtype=torch.int32, device=dev)
    amt_f = t_amt
    k_passes = 0
    converged = False
    while (not converged and k_passes < max_passes
           and not (sched_proved and k_passes >= passes_needed)):
        ok_n, code_n, amt_n, _ = one_pass(ok_f, amt_f)
        stable = not bool(
            (code_n != code_f).any()
            | (ok_n & ((amt_n.lo != amt_f.lo) | (amt_n.hi != amt_f.hi))).any())
        k_passes += 1
        converged = stable
        ok_f, code_f, amt_f = ok_n, code_n, amt_n
    proved_done = sched_proved and k_passes >= passes_needed
    unconverged = not converged and not proved_done

    # The single aux-bearing pass from the fixpoint.
    ok, codes, amount, aux = one_pass(ok_f, amt_f)
    row = aux["row"]
    legs = aux["legs"]

    # History (state_machine.zig:1342-1364).
    dr_hist = ((aux["acc_flags_dr"] & AF_HISTORY) != 0) & ok
    cr_hist = ((aux["acc_flags_cr"] & AF_HISTORY) != 0) & ok
    do_hist = (dr_hist | cr_hist) & ~postvoid

    # Routing flags.
    any_u128_amount = (valid & ((batch["amount_hi"] != 0)
                                | (postvoid & (aux["p"]["amount_hi"] != 0)))).any()
    any_linked = linked.any()
    linked_x_intra = any_linked & (idx.any_dup | aux["in_batch_ref"].any()
                                   | postvoid.any())
    prev_linked = torch.cat([false_n[:1], linked[:-1]])
    in_chain = linked | prev_linked
    chain_failed = in_chain & (codes != 0)
    failed_member_balance = torch.zeros_like(false_n)
    for bc in _BALANCE_CODES:
        failed_member_balance = failed_member_balance | (
            chain_failed & (aux["pre_chain_code"] == bc))
    chain_hazard = (chain_failed & (balancing | dr_limf | cr_limf
                                    | aux["near_ov"])).any() \
        | failed_member_balance.any()
    route_on = (torch.tensor(unconverged, device=dev) | any_u128_amount
                | linked_x_intra | chain_hazard | legs.arith_broken)
    route = torch.where(route_on, FLAG_SEQ, 0).to(torch.int32)

    # History rows: each recorded account's post-event snapshot of all four
    # fields is the inclusive value at that event's leg.
    dpos, cpos = aux["dpos"], aux["cpos"]

    def hv(val: U128, pos, mask):
        z = torch.zeros_like(val.lo[pos])
        return torch.where(mask, val.lo[pos], z), torch.where(mask, val.hi[pos], z)

    hist_row = {"timestamp": ts}
    for side, pos, mask, id_name in (
            ("dr", dpos, dr_hist, "debit_account_id"),
            ("cr", cpos, cr_hist, "credit_account_id")):
        for l_ in ("_lo", "_hi"):
            hist_row[side + "_id" + l_] = torch.where(
                mask, row[id_name + l_], torch.zeros_like(row[id_name + l_]))
        for short, val in (("dp", legs.dp_incl), ("dpo", legs.dpo_incl),
                           ("cp", legs.cp_incl), ("cpo", legs.cpo_incl)):
            lo, hi = hv(val, pos, mask)
            hist_row[f"{side}_{short}_lo"] = lo
            hist_row[f"{side}_{short}_hi"] = hi

    pv_ok = ok & postvoid
    posted_key = torch.where(pv_ok, aux["p"]["timestamp"],
                             torch.zeros_like(aux["p"]["timestamp"]))
    bal_incl = {}
    for field, val in (("debits_pending", legs.dp_incl),
                       ("debits_posted", legs.dpo_incl),
                       ("credits_pending", legs.cp_incl),
                       ("credits_posted", legs.cpo_incl)):
        bal_incl[field + "_lo"] = val.lo
        bal_incl[field + "_hi"] = val.hi
    return ApplyPlan(
        codes=codes, route=route, ok=ok, row=row, post=post,
        posted_key=posted_key, pv_ok=pv_ok, s_slot=legs.s_slot,
        scat=legs.is_last & legs.s_live, bal_incl=bal_incl, do_hist=do_hist,
        hist_row=hist_row,
        passes=torch.tensor(k_passes, dtype=torch.int32, device=dev),
        wave_bound=wave_bound.to(torch.int32), wave_hist=wave_hist,
    )


_WIDTH = {torch.bool: 1, torch.int32: 4, torch.int64: 8}


def _carve(dev, specs) -> Dict[str, torch.Tensor]:
    """One allocation carved into typed, 16-byte aligned views: ``specs``
    maps a name to (dtype, numel)."""
    offsets, size = {}, 0
    for name, (dtype, numel) in specs.items():
        size = (size + 15) & ~15
        width = _WIDTH[dtype]
        offsets[name] = (size, dtype, numel, width)
        size += numel * width
    buf = torch.empty(max(size, 16), dtype=torch.uint8, device=dev)
    return {name: buf[o:o + numel * w].view(dtype)
            for name, (o, dtype, numel, w) in offsets.items()}


def _kernel_core_cuda(ctx: GatherCtx, batch, count: int, timestamp: int,
                      max_passes: int, has_postvoid: bool,
                      use_waves: bool) -> ApplyPlan:
    """The kernel core on the card: K9, K11's set-up, K12 (waves), then
    ``max_passes`` rounds of K11 PRE / K10 / K11 POST and the aux round.
    The loop's control words live on the card; a round after the loop has
    ended returns at once, so nothing here reads the card."""
    n = batch["id_lo"].shape[0]
    dev = batch["id_lo"].device
    n2 = 2 * n
    idx = _build_id_index(batch["id_lo"], batch["id_hi"],
                          batch["pending_id_lo"], batch["pending_id_hi"])
    hsize = _cuda.hash_size(n)
    b, i32, i64 = torch.bool, torch.int32, torch.int64
    p2 = _cuda.legs_pad(n)
    specs = {"ctrl": (i32, 4), "proved": (b, 1), "needed": (i32, 1),
             "unsched": (b, 1), "route": (i32, 1), "passes": (i32, 1),
             "wave_bound": (i32, 1), "cache_ok": (i32, 1),
             "cache_keys": (i64, p2), "cache_slot": (i64, n2),
             "grid": (i32, 2 * _cuda.PASS_MAX_BLOCKS)}
    for name in ("valid", "pending", "post", "postvoid", "linked", "ok_c",
                 "hazard", "wdr_live", "wcr_live", "dr_live", "cr_live",
                 "near_ov", "ok", "pv_ok", "do_hist"):
        specs[name] = (b, n)
    for name in ("code_c", "winner", "ref", "flags_dr", "flags_cr", "code_t",
                 "pre_chain", "codes"):
        specs[name] = (i32, n)
    for name in ("amt_c_lo", "amt_c_hi", "wdr_slot", "wcr_slot", "dr_slot",
                 "cr_slot", "pamt", "fkey", "posted_key"):
        specs[name] = (i64, n)
    specs["fhash"] = (i32, 2 * hsize)
    specs["chain"] = (i32, 2 * n)
    for k in range(8):
        specs[f"leg_start{k}"] = (i64, n2)
    for c, dt in TRANSFER_COLS.items():
        specs["row:" + c] = (dt, n)
    for c in HISTORY_COLS:
        specs["hist:" + c] = (i64, n)
    t = _carve(dev, specs)
    legs = _cuda.legs_buffers(n, dev)
    leg_start = [t[f"leg_start{k}"] for k in range(8)]
    row = {c: t["row:" + c] for c in TRANSFER_COLS}
    hist_row = {c: t["hist:" + c] for c in HISTORY_COLS}

    def view(v: AccountView):
        return [v.found, v.slot, v.flags, v.ledger] + [v.bal[c] for c in _BAL_COLS]

    ctl = {"ctrl": [t["ctrl"]], "proved": [t["proved"]],
           "needed": [t["needed"]]}
    ptrs, nptrs = _cuda.layout_array(_cuda.FULL_PASS_LAYOUT, {
        "batch": [batch[c] for c in TRANSFER_BATCH_COLS],
        "ex_found": [ctx.ex_found],
        "e_tab": [ctx.e_tab[c] for c in TRANSFER_COLS],
        "p_tab_found": [ctx.p_tab_found],
        "p_tab": [ctx.p_tab[c] for c in TRANSFER_COLS],
        "drt": view(ctx.drT), "crt": view(ctx.crT), "pdr": view(ctx.pdr),
        "pcr": view(ctx.pcr), "posted_found": [ctx.postedT_found],
        "posted_val": [ctx.postedT_val],
        "group": [idx.group_of_lane], "any_dup": [idx.any_dup],
        "pj_hit": [idx.pj_hit], "pj_group": [idx.pj_group], **ctl,
        **{k: [t[k]] for k in (
            "valid", "pending", "post", "postvoid", "linked", "ok_c",
            "code_c", "amt_c_lo", "amt_c_hi", "hazard", "unsched",
            "wdr_slot", "wdr_live", "wcr_slot", "wcr_live", "winner", "ref",
            "dr_slot", "cr_slot", "dr_live", "cr_live", "pamt", "flags_dr",
            "flags_cr", "code_t", "pre_chain", "near_ov", "fkey", "fhash",
            "chain", "codes", "ok", "pv_ok", "posted_key", "do_hist", "route",
            "passes", "wave_bound", "cache_ok", "grid")},
        "leg_start": leg_start, "leg_pos": [legs["leg_pos"]],
        "leg_val": legs["val"], "s_slot": [legs["s_slot"]],
        "s_live": [legs["s_live"]], "is_last": [legs["is_last"]],
        "arith": [legs["arith"]],
        "row": [row[c] for c in TRANSFER_COLS],
        "hist": [hist_row[c] for c in HISTORY_COLS],
    })
    lptrs, lnptrs = _cuda.layout_array(_cuda.LEGS_LAYOUT, {
        "start": leg_start, "ok": [t["ok_c"]], "amt": [t["amt_c_lo"]],
        "pamt": [t["pamt"]], "dr_slot": [t["dr_slot"]],
        "cr_slot": [t["cr_slot"]], "dr_live": [t["dr_live"]],
        "cr_live": [t["cr_live"]], "pending": [t["pending"]],
        "post": [t["post"]], "postvoid": [t["postvoid"]],
        "leg_pos": [legs["leg_pos"]], "val": legs["val"],
        "s_slot": [legs["s_slot"]], "s_live": [legs["s_live"]],
        "is_last": [legs["is_last"]], "arith": [legs["arith"]],
        "scratch": [legs["scratch"]],
        "stats": [_cuda.legs_stats(dev) if _cuda.LEGS_STATS_ON else None],
        **ctl,
        "cache_keys": [t["cache_keys"]], "cache_slot": [t["cache_slot"]],
        "cache_ok": [t["cache_ok"]]})
    stream = torch.cuda.current_stream(dev).cuda_stream
    cap = ctx.accounts_capacity

    def pass_(mode, aux=False):
        _cuda.full_pass_launch(ptrs, nptrs, mode, aux, n, count, timestamp,
                               has_postvoid, use_waves, max_passes, hsize,
                               stream)

    pass_(_cuda.PASS_INIT)
    if use_waves:
        wave_hist = _cuda.full_waves(
            t["hazard"], t["unsched"], t["wdr_slot"], t["wdr_live"],
            t["wcr_slot"], t["wcr_live"], t["valid"], cap, max_passes,
            proved=t["proved"], needed=t["needed"],
            cache=(t["cache_keys"], t["cache_slot"], t["cache_ok"]))[3]
    else:
        wave_hist = torch.zeros(9, dtype=torch.int32, device=dev)
    for aux in [False] * max_passes + [True]:
        pass_(_cuda.PASS_PRE, aux)
        _cuda.full_legs_launch(lptrs, lnptrs, n, has_postvoid, cap, aux, stream)
        pass_(_cuda.PASS_POST, aux)
    legs_t = _legs_from_buffers(legs)
    bal_incl = {}
    for k, field in enumerate(_BAL_FIELDS):
        bal_incl[field + "_lo"] = legs["val"][4 * k + 2]
        bal_incl[field + "_hi"] = legs["val"][4 * k + 3]
    return ApplyPlan(
        codes=t["codes"], route=t["route"][0], ok=t["ok"], row=row,
        post=t["post"], posted_key=t["posted_key"], pv_ok=t["pv_ok"],
        s_slot=legs_t.s_slot, scat=legs_t.is_last & legs_t.s_live,
        bal_incl=bal_incl, do_hist=t["do_hist"], hist_row=hist_row,
        passes=t["passes"][0], wave_bound=t["wave_bound"][0],
        wave_hist=wave_hist,
    )


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def create_transfers_full_impl(
    ledger: Ledger,
    batch: Dict[str, torch.Tensor],
    count: int,
    timestamp: int,
    bloom=None,
    cold_checked=None,
    max_passes: int = _MAX_PASSES,
    has_postvoid: bool = True,
    has_history: bool = True,
    use_waves: bool = False,
) -> Tuple:
    """Returns (ledger, codes int32[N], kflags int32 0-dim), plus the wave
    vector int32[11] = (passes, wave_bound, hist[9]) when ``use_waves``.

    kflags == 0: the batch was applied (in place) and ``codes`` are final.
    kflags != 0: NOTHING was applied: every table array and the history log
    are as they were; the caller grows the flagged tables and retries, or
    re-routes the batch to the sequential path (FLAG_SEQ), or resolves its
    cold ids and retries (FLAG_COLD: ``bloom`` is the cold ids' filter,
    ``cold_checked`` bool[N] the lanes the host already certified).  On
    CUDA tensors
    the claims, the commit word and every write stay on the card (K2's claim
    and write entries, K10's and K11's apply launches): the only host read
    of the commit is the caller's."""
    n = batch["id_lo"].shape[0]
    dev = batch["id_lo"].device
    valid = torch.arange(n, device=dev) < count
    flags = batch["flags"]
    postvoid = (((flags & TF_POST) != 0) | ((flags & TF_VOID) != 0)) & valid
    ctx = build_gather_ctx(ledger, batch, valid, postvoid, bloom, cold_checked,
                           has_postvoid=has_postvoid)
    plan = _kernel_core(ctx, batch, count, timestamp, max_passes,
                        has_postvoid=has_postvoid, use_waves=use_waves)
    if batch["id_lo"].is_cuda:
        kflags = _apply_cuda(ledger, batch, ctx, plan, has_postvoid,
                             has_history)
    else:
        kflags = _apply_plain(ledger, batch, ctx, plan, has_postvoid,
                              has_history)
    if use_waves:
        wave_vec = torch.cat([plan.passes.reshape(1),
                              plan.wave_bound.reshape(1), plan.wave_hist])
        return ledger, plan.codes, kflags, wave_vec
    return ledger, plan.codes, kflags


def _apply_cuda(ledger: Ledger, batch, ctx: GatherCtx, plan: ApplyPlan,
                has_postvoid: bool, has_history: bool) -> torch.Tensor:
    """The apply on the card: K2's claims OR their overflow bits into the
    kflags word; K10's balance scatter, K2's writes (or the claims' marks
    cleared) and K11's history append read that word on the card."""
    kflags = (ctx.probe_grow | plan.route).reshape(1)
    zeros = torch.zeros_like(batch["id_lo"])
    t, p = ledger.transfers, ledger.posted
    t_claim, _ = _cuda.claim(t.key_lo, t.key_hi, t.tombstone, batch["id_lo"],
                             batch["id_hi"], plan.ok, MAX_PROBE,
                             flag_word=kflags, flag_bit=FLAG_GROW_TRANSFERS)
    if has_postvoid:
        p_claim, _ = _cuda.claim(p.key_lo, p.key_hi, p.tombstone,
                                 plan.posted_key, zeros, plan.pv_ok, MAX_PROBE,
                                 flag_word=kflags, flag_bit=FLAG_GROW_POSTED)
    a = ledger.accounts
    _cuda.full_legs_apply(kflags, plan.scat, plan.s_slot,
                          [plan.bal_incl[c] for c in _BAL_COLS],
                          [a.cols[c] for c in _BAL_COLS])
    _cuda.write_claimed(t.key_lo, t.key_hi, t.tombstone, t.cols, t.count,
                        batch["id_lo"], batch["id_hi"], t_claim, plan.ok,
                        plan.row, gate=kflags, revert=True)
    if has_postvoid:
        fulfillment = torch.where(plan.post, 1, 2).to(torch.int32)
        _cuda.write_claimed(p.key_lo, p.key_hi, p.tombstone, p.cols, p.count,
                            plan.posted_key, zeros, p_claim, plan.pv_ok,
                            {"fulfillment": fulfillment}, gate=kflags,
                            revert=True)
    if has_history:
        h = ledger.history
        _cuda.full_hist(kflags, plan.do_hist,
                        [plan.hist_row[c] for c in HISTORY_COLS],
                        [h.cols[c] for c in HISTORY_COLS], h.count)
    return kflags[0]


def _apply_plain(ledger: Ledger, batch, ctx: GatherCtx, plan: ApplyPlan,
                 has_postvoid: bool, has_history: bool) -> torch.Tensor:
    """Plain version of the apply (K2 claim/write, K10's balance scatter,
    K11's history append): claim first, then write only if the batch
    commits."""
    zeros = torch.zeros_like(batch["id_lo"])
    t_claim, t_ovf = ht.claim_slots_plain(ledger.transfers, batch["id_lo"],
                                          batch["id_hi"], plan.ok, MAX_PROBE)
    if has_postvoid:
        p_claim, p_ovf = ht.claim_slots_plain(ledger.posted, plan.posted_key,
                                              zeros, plan.pv_ok, MAX_PROBE)
    kflags = (ctx.probe_grow | plan.route
              | (t_ovf.to(torch.int32) * FLAG_GROW_TRANSFERS))
    if has_postvoid:
        kflags = kflags | (p_ovf.to(torch.int32) * FLAG_GROW_POSTED)
    commit = kflags == 0

    scat = plan.scat & commit
    ht.scatter_cols(ledger.accounts, plan.s_slot, scat, plan.bal_incl)
    ht.write_rows_plain(ledger.transfers, batch["id_lo"], batch["id_hi"],
                        t_claim, plan.ok & commit, plan.row)
    if has_postvoid:
        fulfillment = torch.where(plan.post, 1, 2).to(torch.int32)
        ht.write_rows_plain(ledger.posted, plan.posted_key, zeros, p_claim,
                            plan.pv_ok & commit, {"fulfillment": fulfillment})
    if has_history:
        h = ledger.history
        do = (plan.do_hist & commit).to(torch.int64)
        h_idx = h.count + torch.cumsum(do, 0) - do
        keep = (do != 0) & (h_idx < h.capacity)
        for name in HISTORY_COLS:
            h.cols[name][h_idx[keep]] = plan.hist_row[name][keep]
        h.count += do.sum()
    return kflags
