"""Device-resident open-addressing SoA hash table (port of
``tigerbeetle_tpu/ops/hash_table.py``).

The layout and placement are the JAX package's, slot for slot, because
Merkle leaves, checkpoints and state sync depend on them:

- capacity is a power of two; home = (mix64(key) >> hash_shift) & (C-1);
- an empty slot has key 0; a tombstone keeps ``tombstone=True`` with key 0;
  probes continue past tombstones and inserts never reuse them;
- a batched insert runs in rounds: in round t every unplaced lane probes
  home+t, a lane contends only for a slot free at the start of the round,
  the lowest batch lane wins a contested slot (contenders always share a
  home), losers advance, and the batch stops once a lane's offset reaches
  ``max_probe``.

Tensors: keys are int64 holding u64 bits, ``tombstone`` is bool, u64 columns
are int64 and u32 columns int32 holding the bits, ``count`` a 0-dim int64 and
``probe_overflow`` a 0-dim bool, all on one device.  Where the JAX package
returned a new table from donated buffers, this module updates the table's
tensors in place and returns the same ``Table``.

``lookup``, ``lookup_many`` (kernel K1: one launch for several
lookups) and ``lookup_flags`` (K1 with a flag word on the card: the
lookups' overflow bits and the general path's cold test, K17's step),
``insert`` (kernel K2), ``claim_slots`` and
``write_rows`` (K2's claim and write entries) and ``remove_to_tombstone``
(kernel K8) take the hand-written CUDA kernels for CUDA tensors and their
plain PyTorch versions, beside them here, for CPU tensors.  K2 has two
plain forms with the same results: ``claim_slots_plain`` (the rounds over
lanes, the CPU route) and ``claim_slots_split_plain`` (the card's split
form: windows, then rounds over home groups), and for more than
_cuda.INSERT_SPLIT_MAX_N lanes ``claim_rounds_plain`` and
``write_rows_fill_plain`` (the card's round form and its writes of a fresh
table whole); K1's are ``lookup_plain``
(a slot a step, the CPU route) and ``lookup_split_plain`` (the card's
rounds over aligned groups of four slots), and ``lookup_flags_plain``
mirrors the flag word's steps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..u128 import mix64, srl
from . import _cuda


@dataclasses.dataclass
class Table:
    """SoA open-addressing table. ``cols`` holds the value columns."""

    key_lo: torch.Tensor  # int64[C] (u64 bits); 0 = empty/tombstone
    key_hi: torch.Tensor  # int64[C]
    tombstone: torch.Tensor  # bool[C]
    cols: Dict[str, torch.Tensor]
    count: torch.Tensor  # int64 0-dim: live entries
    probe_overflow: torch.Tensor  # bool 0-dim: a probe exceeded max_probe

    @property
    def capacity(self) -> int:
        return self.key_lo.shape[0]

    @property
    def device(self) -> torch.device:
        return self.key_lo.device


def make_table(
    capacity: int, col_specs: Dict[str, torch.dtype], device
) -> Table:
    return _new_table(capacity, col_specs, device, torch.zeros)


def _new_table(capacity: int, col_specs: Dict[str, torch.dtype], device,
               alloc) -> Table:
    """A table whose arrays ``alloc`` makes: zeros (``make_table``), or
    ``torch.empty`` for K2's round form to write whole (``rehash_into``)."""
    if capacity <= 0 or capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of two, got {capacity}")
    return Table(
        key_lo=alloc(capacity, dtype=torch.int64, device=device),
        key_hi=alloc(capacity, dtype=torch.int64, device=device),
        tombstone=alloc(capacity, dtype=torch.bool, device=device),
        cols={
            name: alloc(capacity, dtype=dt, device=device)
            for name, dt in col_specs.items()
        },
        count=torch.zeros((), dtype=torch.int64, device=device),
        probe_overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


class LookupResult(NamedTuple):
    found: torch.Tensor  # bool[N], masked to lanes < count
    slot: torch.Tensor  # int64[N]: the matching slot, 0 where not found
    overflow: torch.Tensor  # bool 0-dim: some lane exhausted max_probe
    cols: Dict[str, torch.Tensor]  # gathered columns, zero where not found


def _home(key_lo, key_hi, capacity: int, hash_shift: int) -> torch.Tensor:
    return srl(mix64(key_lo, key_hi), hash_shift) & (capacity - 1)


def lookup(
    table: Table,
    key_lo: torch.Tensor,
    key_hi: torch.Tensor,
    max_probe: int,
    hash_shift: int = 0,
    count: Optional[int] = None,
    cols: Sequence[str] = (),
    mask: Optional[torch.Tensor] = None,
) -> LookupResult:
    """Batched linear probe for each key, fused with the column gather
    (``ops/hash_table.py`` ``lookup`` + ``gather_cols``).

    ``found`` is masked to lanes below ``count`` (all lanes when None) and,
    when given, to the bool lane ``mask``, as the commit kernels mask it;
    ``cols`` names the columns to gather at the found slots.  ``overflow``
    covers every lane.  Kernel K1 on CUDA tensors."""
    n = key_lo.shape[0]
    count = n if count is None else count
    if key_lo.is_cuda:
        found, slot, overflow, gathered = _cuda.probe(
            table.key_lo, table.key_hi, table.tombstone, table.cols,
            key_lo, key_hi, max_probe, hash_shift, count, tuple(cols), mask,
        )
        return LookupResult(found, slot, overflow, gathered)
    return lookup_plain(table, key_lo, key_hi, max_probe, hash_shift,
                        count, cols, mask)


def lookup_plain(
    table: Table,
    key_lo: torch.Tensor,
    key_hi: torch.Tensor,
    max_probe: int,
    hash_shift: int,
    count: int,
    cols: Sequence[str],
    lane_mask: Optional[torch.Tensor] = None,
) -> LookupResult:
    """Plain PyTorch version of kernel K1 (the JAX ``while_loop``, lane-
    parallel, run until every lane is done or ``max_probe`` steps)."""
    capacity = table.capacity
    mask = capacity - 1
    home = _home(key_lo, key_hi, capacity, hash_shift)
    done = (key_lo == 0) & (key_hi == 0)
    found = torch.zeros_like(done)
    slot = torch.zeros_like(home)
    for i in range(max_probe):
        if bool(done.all()):
            break
        cur = (home + i) & mask
        t_lo = table.key_lo[cur]
        t_hi = table.key_hi[cur]
        tomb = table.tombstone[cur]
        match = ~done & (t_lo == key_lo) & (t_hi == key_hi) & ~tomb
        empty = ~done & (t_lo == 0) & (t_hi == 0) & ~tomb
        found = found | match
        slot = torch.where(match, cur, slot)
        done = done | match | empty
    lane = torch.arange(key_lo.shape[0], device=key_lo.device)
    found = found & (lane < count)
    if lane_mask is not None:
        found = found & lane_mask
    return LookupResult(
        found=found,
        slot=slot,
        overflow=(~done).any(),
        cols=gather_cols(table, slot, found, cols),
    )


class Lookup(NamedTuple):
    """One lookup of ``lookup_many``.  ``key_hi`` None means zeros;
    ``keys_from`` = (k, lo_name, hi_name or None) takes the keys from
    lookup k's gathered columns (k earlier in the list); ``out`` (found,
    slot, columns) takes the outputs in place on the card."""

    table: Table
    key_lo: Optional[torch.Tensor]
    key_hi: Optional[torch.Tensor] = None
    cols: Sequence[str] = ()
    mask: Optional[torch.Tensor] = None
    count: Optional[int] = None
    hash_shift: int = 0
    keys_from: Optional[Tuple[int, str, Optional[str]]] = None
    count_word: Optional[torch.Tensor] = None
    out: Optional[Tuple[torch.Tensor, torch.Tensor, Sequence[torch.Tensor]]] = None
    grow_bit: int = 0  # lookup_flags: ORed into the word when it overflows
    cold: bool = False  # lookup_flags: its lanes test their key (K17)


def lookup_many(lookups: Sequence[Lookup], max_probe: int,
                overflow: bool = True):
    """``lookup`` for several lookups of one lane count at once: one K1
    launch on CUDA tensors (one memset more for the overflow flags, when
    ``overflow``), the plain version of each in turn on CPU tensors.  A
    list of ``LookupResult``s in order; their ``overflow`` is None when not
    asked for."""
    first = lookups[0].key_lo
    if first.is_cuda:
        got = _cuda.probe_many(_probe_specs(lookups), max_probe, overflow)
        return [LookupResult(*r) for r in got]
    return _lookup_many_plain(lookups, max_probe, overflow)


def _lookup_many_plain(lookups: Sequence[Lookup], max_probe: int,
                       overflow: bool = True) -> List[LookupResult]:
    """``lookup_plain`` of each lookup in turn (on any device)."""
    out = []
    for lk in lookups:
        if lk.count_word is not None or lk.out is not None:
            raise ValueError("count_word and out are for CUDA tensors")
        if lk.keys_from is None:
            lo, hi = lk.key_lo, lk.key_hi
        else:
            j, lo_name, hi_name = lk.keys_from
            lo = out[j].cols[lo_name]
            hi = None if hi_name is None else out[j].cols[hi_name]
        if hi is None:
            hi = torch.zeros_like(lo)
        n = lo.shape[0]
        r = lookup_plain(lk.table, lo, hi, max_probe, lk.hash_shift,
                         n if lk.count is None else lk.count, tuple(lk.cols),
                         lk.mask)
        out.append(r if overflow else r._replace(overflow=None))
    return out


def _probe_specs(lookups: Sequence[Lookup]):
    return [_cuda.ProbeSpec(lk.table.key_lo, lk.table.key_hi,
                            lk.table.tombstone, lk.table.cols, lk.key_lo,
                            lk.key_hi, tuple(lk.cols), lk.count, lk.mask,
                            lk.hash_shift, lk.count_word, lk.out,
                            lk.keys_from, lk.grow_bit, lk.cold)
            for lk in lookups]


def lookup_flags(lookups: Sequence[Lookup], max_probe: int,
                 bloom: Optional[torch.Tensor] = None,
                 checked: Optional[torch.Tensor] = None, cold_bit: int = 0
                 ) -> Tuple[List[LookupResult], torch.Tensor]:
    """``lookup_many`` (with overflow flags) and a flag word, int32 0-dim:
    each lookup ORs its ``grow_bit`` into the word when it overflows, and a
    lookup marked ``cold`` ORs ``cold_bit`` when a lane under its mask,
    below its count, not found and not certified by ``checked`` (bool[N],
    None: no lane) has a key that hits the Bloom filter ``bloom`` (the
    cold tier's int32 words; ``ops/cold.py``).  On CUDA tensors one K1
    launch whose memset zeroes the word beside the overflow bytes, K17's
    test a step of it (the word never leaves the card); on CPU tensors
    ``lookup_flags_plain``."""
    if lookups[0].key_lo.is_cuda:
        got, word = _cuda.probe_flags(_probe_specs(lookups), max_probe,
                                      bloom, checked, cold_bit)
        return [LookupResult(*r) for r in got], word
    return lookup_flags_plain(lookups, max_probe, bloom, checked, cold_bit)


def lookup_flags_plain(lookups: Sequence[Lookup], max_probe: int,
                       bloom: Optional[torch.Tensor] = None,
                       checked: Optional[torch.Tensor] = None,
                       cold_bit: int = 0
                       ) -> Tuple[List[LookupResult], torch.Tensor]:
    """Plain version of ``lookup_flags``, in the kernel's steps (on any
    device): each lookup, then its lanes' bits (its grow bit where it
    overflowed; where it is cold, the filter test of its own keys on the
    lanes its mask and count admit, not found, not certified), ORed into
    one word."""
    from .cold import bloom_check_plain

    out = _lookup_many_plain(lookups, max_probe)
    word = torch.zeros((), dtype=torch.int32, device=lookups[0].key_lo.device)
    for lk, r in zip(lookups, out):
        if lk.grow_bit:
            word = word | (r.overflow.to(torch.int32) * lk.grow_bit)
        if not lk.cold:
            continue
        if bloom is None:
            raise ValueError("a cold lookup needs the filter")
        if lk.keys_from is None:
            lo, hi = lk.key_lo, lk.key_hi
        else:
            j, lo_name, hi_name = lk.keys_from
            lo = out[j].cols[lo_name]
            hi = None if hi_name is None else out[j].cols[hi_name]
        hi = torch.zeros_like(lo) if hi is None else hi
        n = lo.shape[0]
        lane = torch.arange(n, device=lo.device)
        test = (lane < (n if lk.count is None else lk.count)) & ~r.found
        if lk.mask is not None:
            test = test & lk.mask
        if checked is not None:
            test = test & ~checked
        hit = (test & bloom_check_plain(bloom, lo, hi)).any()
        word = word | (hit.to(torch.int32) * cold_bit)
    return out, word


def lookup_split_plain(
    table: Table,
    key_lo: torch.Tensor,
    key_hi: torch.Tensor,
    max_probe: int,
    hash_shift: int,
    count: int,
    cols: Sequence[str],
    lane_mask: Optional[torch.Tensor] = None,
) -> LookupResult:
    """Plain version of kernel K1 as the card runs it: rounds over the
    aligned group of four slots that holds each lane's current slot (one
    slot a round below a capacity of 4), each deciding the group's slots
    from the current one on in order, until every lane is done or has
    taken ``max_probe`` steps; then the gather.  The same results as
    ``lookup_plain``."""
    capacity = table.capacity
    mask = capacity - 1
    g = 4 if capacity >= 4 else 1
    cur = _home(key_lo, key_hi, capacity, hash_shift)
    done = (key_lo == 0) & (key_hi == 0)
    found = torch.zeros_like(done)
    slot = torch.zeros_like(cur)
    steps = torch.zeros_like(cur)
    while True:
        live = ~done & (steps < max_probe)
        if not bool(live.any()):
            break
        base = cur & ~(g - 1)
        off = cur & (g - 1)
        for o in range(g):
            visit = live & ~done & (off <= o) & (steps < max_probe)
            s = base + o
            t_lo, t_hi = table.key_lo[s], table.key_hi[s]
            tomb = table.tombstone[s]
            match = visit & ~tomb & (t_lo == key_lo) & (t_hi == key_hi)
            empty = visit & ~tomb & (t_lo == 0) & (t_hi == 0)
            found = found | match
            slot = torch.where(match, s, slot)
            done = done | match | empty
            steps = steps + visit.to(steps.dtype)
        cur = torch.where(live, (base + g) & mask, cur)
    lane = torch.arange(key_lo.shape[0], device=key_lo.device)
    found = found & (lane < count)
    if lane_mask is not None:
        found = found & lane_mask
    return LookupResult(found=found, slot=slot, overflow=(~done).any(),
                        cols=gather_cols(table, slot, found, cols))


def gather_cols(
    table: Table, slot: torch.Tensor, valid: torch.Tensor,
    names: Optional[Sequence[str]] = None,
) -> Dict[str, torch.Tensor]:
    """Gather value columns at ``slot``, zeroed where ``valid`` is False."""
    safe = torch.where(valid, slot, torch.zeros_like(slot))
    names = table.cols.keys() if names is None else names
    return {
        name: torch.where(
            valid, table.cols[name][safe], torch.zeros((), dtype=table.cols[name].dtype,
                                                       device=slot.device)
        )
        for name in names
    }


def scatter_cols(
    table: Table, slot: torch.Tensor, valid: torch.Tensor,
    updates: Dict[str, torch.Tensor],
) -> Table:
    """Scatter updated columns at ``slot`` where ``valid``, in place.  Slots
    must be unique among valid lanes."""
    idx = slot[valid]
    for name, val in updates.items():
        table.cols[name][idx] = val[valid]
    return table


def claim_slots(
    table: Table,
    key_lo: torch.Tensor,
    key_hi: torch.Tensor,
    insert_mask: torch.Tensor,
    max_probe: int,
    hash_shift: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The insert slot of every masked key, without writing: (claimed
    int64[N] with C where unplaced, overflow bool 0-dim).  On CUDA tensors
    K2's claim entry, which marks the claimed slots with their keys while it
    runs, then its write entry with a closed gate, which clears the marks:
    the table is left as it was."""
    if key_lo.is_cuda:
        claimed, flag = _cuda.claim(
            table.key_lo, table.key_hi, table.tombstone, key_lo, key_hi,
            insert_mask, max_probe, hash_shift)
        _cuda.write_claimed(
            table.key_lo, table.key_hi, table.tombstone, table.cols,
            table.count, key_lo, key_hi, claimed,
            torch.zeros_like(insert_mask), {}, gate=torch.ones_like(flag),
            revert=True)
        return claimed, flag[0] != 0
    return claim_slots_plain(table, key_lo, key_hi, insert_mask, max_probe,
                             hash_shift)


def claim_slots_plain(
    table: Table,
    key_lo: torch.Tensor,
    key_hi: torch.Tensor,
    insert_mask: torch.Tensor,
    max_probe: int,
    hash_shift: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch claim protocol (plain version of K2's claim entry).

    The winner of a round is the group's next lane in batch order: all
    unplaced lanes advance together, so lanes probing one slot share a home,
    and one stable sort gives each lane its rank within its home group
    (the JAX package's group-rank form, without its windowing, which only
    saves work)."""
    capacity = table.capacity
    dev = key_lo.device
    n = key_lo.shape[0]
    mask = capacity - 1
    home = _home(key_lo, key_hi, capacity, hash_shift)
    gkey = torch.where(insert_mask, home, torch.full_like(home, capacity))
    s_home, order = torch.sort(gkey, stable=True)
    pos = torch.arange(n, device=dev)
    s_head = torch.ones(n, dtype=torch.bool, device=dev)
    s_head[1:] = s_home[1:] != s_home[:-1]
    gid_sorted = torch.cumsum(s_head.to(torch.int64), 0) - 1
    gstart = torch.cummax(torch.where(s_head, pos, torch.zeros_like(pos)), 0).values
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = pos - gstart
    gid = torch.empty(n, dtype=torch.int64, device=dev)
    gid[order] = gid_sorted

    occ = (table.key_lo != 0) | (table.key_hi != 0) | table.tombstone
    claimed = torch.full((n,), capacity, dtype=torch.int64, device=dev)
    unplaced = insert_mask.clone()
    next_rank = torch.zeros(n, dtype=torch.int64, device=dev)
    overflow = False
    t = 0
    while bool(unplaced.any()):
        if t >= max_probe:
            overflow = True
            break
        cur = (home + t) & mask
        win = unplaced & ~occ[cur] & (rank == next_rank[gid])
        claimed = torch.where(win, cur, claimed)
        occ[cur[win]] = True
        next_rank.index_add_(0, gid[win], torch.ones_like(gid[win]))
        unplaced = unplaced & ~win
        t += 1
    return claimed, torch.tensor(overflow, device=dev)


# K2's split form (csrc/insert.cu), for batches of at most
# _cuda.INSERT_SPLIT_MAX_N lanes: a wide pre-pass reads each lane's window
# of _cuda.INSERT_WINDOW slots, then one block runs the rounds over home
# groups, the batch's claims in a set.


def _occupied(table: Table) -> torch.Tensor:
    return (table.key_lo != 0) | (table.key_hi != 0) | table.tombstone


def _windows(occ: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Bit k of each result is the occupancy of slot (start + k) & (C-1)."""
    k = torch.arange(_cuda.INSERT_WINDOW, device=start.device)
    bits = occ[(start[:, None] + k) & (occ.shape[0] - 1)]
    return (bits.to(torch.int64) << k).sum(1)


def claim_prepass_plain(table: Table, key_lo, key_hi, insert_mask,
                        hash_shift: int = 0):
    """Plain version of K2's pre-pass: (home, window), int64[N] each.  A
    masked lane's home, and its window: bit k set where slot home+k is
    occupied (key nonzero or tombstone) before the batch; home -1 for a
    lane outside the mask."""
    home = _home(key_lo, key_hi, table.capacity, hash_shift)
    window = _windows(_occupied(table), home)
    return torch.where(insert_mask, home, -1), window


def claim_resolve_plain(table: Table, home: torch.Tensor, window: torch.Tensor,
                        max_probe: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2's resolver: (claimed int64[N], overflow).

    The masked lanes form home groups, members in lane order.  In round t
    each group with members left probes home+t; the slot is free if its
    window bit is clear (the group's window is its first lane's, read anew
    from the table every _cuda.INSERT_WINDOW rounds) and the batch has not
    claimed it in an earlier round; then the group's next member takes it.
    Within a round no two groups probe one slot (their homes differ), so
    the round's claims are made together.  The rounds stop as the
    protocol's do (``claim_slots_plain``)."""
    n = home.shape[0]
    cap = table.capacity
    dev = home.device
    claimed = torch.full((n,), cap, dtype=torch.int64, device=dev)
    lanes = torch.nonzero(home >= 0).flatten()
    if lanes.numel() == 0:
        return claimed, torch.tensor(False, device=dev)
    s_home, order = torch.sort(home[lanes], stable=True)
    members = lanes[order]  # grouped by home, lane order within a group
    g_home, g_size = torch.unique_consecutive(s_home, return_counts=True)
    g_end = torch.cumsum(g_size, 0)
    g_next = g_end - g_size
    g_win = window[members[g_next]]
    occ = _occupied(table)
    taken = torch.zeros(cap, dtype=torch.bool, device=dev)
    live = torch.ones_like(g_home, dtype=torch.bool)
    t = 0
    while bool(live.any()):
        if t >= max_probe:
            return claimed, torch.tensor(True, device=dev)
        if t and t % _cuda.INSERT_WINDOW == 0:
            g_win = torch.where(live, _windows(occ, g_home + t), g_win)
        slot = (g_home + t) & (cap - 1)
        bit = (g_win >> (t % _cuda.INSERT_WINDOW)) & 1
        win = live & (bit == 0) & ~taken[slot]
        claimed[members[g_next[win]]] = slot[win]
        taken[slot[win]] = True
        g_next = g_next + win.to(torch.int64)
        live = g_next < g_end
        t += 1
    return claimed, torch.tensor(False, device=dev)


def claim_slots_split_plain(table: Table, key_lo, key_hi, insert_mask,
                            max_probe: int, hash_shift: int = 0):
    """Plain version of K2's claim as the card runs it for a batch of at
    most _cuda.INSERT_SPLIT_MAX_N lanes: the pre-pass, then the resolver.  The
    same claims and overflow as ``claim_slots_plain``."""
    home, window = claim_prepass_plain(table, key_lo, key_hi, insert_mask,
                                       hash_shift)
    return claim_resolve_plain(table, home, window, max_probe)


# K2's round form (csrc/insert.cu), for more than _cuda.INSERT_SPLIT_MAX_N
# lanes (``grow``, the cold tier's rebuild): round 0 over every lane, then
# rounds over a list of the lanes left; a fresh table's rows then written
# whole, in slot order.


def claim_rounds_plain(table: Table, key_lo, key_hi, insert_mask,
                       max_probe: int, hash_shift: int = 0, fresh: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2's round form: (claimed int64[N], overflow).

    A word a slot, no lane on entry (the kernel's memset).  In round t each
    walker (lane, home) whose slot home+t is free at the round's start (not
    occupied in the table and not taken in an earlier round; ``fresh``: an
    empty table, taken only by this batch) puts (t, lane) on the slot's
    word by the lowest-value reduction: a word an earlier round set is
    lower and stays, and contenders share a home.  The lane named with
    round t on its slot's word takes the slot; the rest are the next
    round's walkers.  Round 0's walkers are every masked lane (the
    kernel's two launches over the batch); later rounds walk the list (the
    kernel's cooperative launch, its last _cuda.INSERT_TAIL_MAX walkers on
    one block, with the same steps).  The rounds stop as the protocol's do
    (``claim_slots_plain``)."""
    cap = table.capacity
    n = key_lo.shape[0]
    dev = key_lo.device
    claimed = torch.full((n,), cap, dtype=torch.int64, device=dev)
    word = torch.full((cap,), 1 << 62, dtype=torch.int64, device=dev)
    occ = torch.zeros(cap, dtype=torch.bool, device=dev) if fresh \
        else _occupied(table)
    lane = torch.nonzero(insert_mask).flatten()
    home = _home(key_lo, key_hi, cap, hash_shift)[lane]
    t = 0
    over = False
    while lane.numel():
        if t >= max_probe:
            over = True
            break
        slot = (home + t) & (cap - 1)
        free = ~occ[slot]
        word.scatter_reduce_(0, slot[free], (t << 32) + lane[free], "amin")
        win = word[slot] == (t << 32) + lane
        claimed[lane[win]] = slot[win]
        occ[slot[win]] = True
        lane, home = lane[~win], home[~win]
        t += 1
    return claimed, torch.tensor(over, device=dev)


def write_rows_fill_plain(table: Table, key_lo, key_hi,
                          claimed: torch.Tensor, write_mask: torch.Tensor,
                          rows: Dict[str, torch.Tensor]) -> Table:
    """Plain version of K2's writes of a fresh table whole (``fill``, the
    round form's rows for ``grow`` and the cold rebuild): each slot's lane
    from the map of slots to lanes, then every array of every slot
    written, that lane's row or zeros.  The same table as
    ``write_rows_plain`` on a table of zeros."""
    cap = table.capacity
    lanes = torch.nonzero(write_mask & (claimed < cap)).flatten()
    inv = torch.full((cap,), -1, dtype=torch.int64, device=claimed.device)
    inv[claimed[lanes]] = lanes
    has = inv >= 0
    lane = inv.clamp(min=0)
    table.key_lo.copy_(torch.where(has, key_lo[lane], 0))
    table.key_hi.copy_(torch.where(has, key_hi[lane], 0))
    table.tombstone.zero_()
    for name, col in table.cols.items():
        col.copy_(torch.where(has, rows[name][lane], torch.zeros_like(col)))
    table.count.fill_(lanes.numel())
    table.probe_overflow.zero_()
    return table


def write_rows(
    table: Table,
    key_lo: torch.Tensor,
    key_hi: torch.Tensor,
    claimed: torch.Tensor,
    write_mask: torch.Tensor,
    rows: Dict[str, torch.Tensor],
) -> Table:
    """Write keys and value columns at the slots from ``claim_slots``
    (unique by construction) where ``write_mask``, in place; ``count`` grows
    by the rows written.  K2's write entry on CUDA tensors."""
    if key_lo.is_cuda:
        _cuda.write_claimed(
            table.key_lo, table.key_hi, table.tombstone, table.cols,
            table.count, key_lo, key_hi, claimed, write_mask, rows)
        return table
    return write_rows_plain(table, key_lo, key_hi, claimed, write_mask, rows)


def write_rows_plain(
    table: Table,
    key_lo: torch.Tensor,
    key_hi: torch.Tensor,
    claimed: torch.Tensor,
    write_mask: torch.Tensor,
    rows: Dict[str, torch.Tensor],
) -> Table:
    """Plain version of K2's write entry."""
    w = write_mask & (claimed < table.capacity)
    idx = claimed[w]
    table.key_lo[idx] = key_lo[w]
    table.key_hi[idx] = key_hi[w]
    table.tombstone[idx] = False
    for name in table.cols:
        table.cols[name][idx] = rows[name][w]
    table.count += w.sum()
    return table


def insert(
    table: Table,
    key_lo: torch.Tensor,
    key_hi: torch.Tensor,
    insert_mask: torch.Tensor,
    rows: Dict[str, torch.Tensor],
    max_probe: int,
    hash_shift: int = 0,
) -> Tuple[Table, torch.Tensor]:
    """Batched insert of new, distinct, nonzero keys where ``insert_mask``
    is set, in place; the probe overflow is recorded on the table.  Returns
    (table, claimed slots).  Kernel K2 on CUDA tensors."""
    if key_lo.is_cuda:
        claimed = _cuda.insert(
            table.key_lo, table.key_hi, table.tombstone, table.cols,
            table.count, table.probe_overflow, key_lo, key_hi, insert_mask,
            rows, max_probe, hash_shift,
        )
        return table, claimed
    return insert_plain(table, key_lo, key_hi, insert_mask, rows, max_probe,
                        hash_shift)


def insert_plain(table, key_lo, key_hi, insert_mask, rows, max_probe,
                 hash_shift=0):
    """Plain PyTorch version of kernel K2: claim_slots + write_rows."""
    claimed, overflow = claim_slots_plain(
        table, key_lo, key_hi, insert_mask, max_probe, hash_shift
    )
    write_rows_plain(table, key_lo, key_hi, claimed, insert_mask, rows)
    table.probe_overflow |= overflow
    return table, claimed


def grow(table: Table, new_capacity: int, hash_shift: int = 0) -> Table:
    """Rehash every live entry into a new table of ``new_capacity`` slots:
    one batched insert with every old slot as a lane (tombstones dropped).
    The old table's tensors are left as they were."""
    if new_capacity & (new_capacity - 1) or new_capacity < table.capacity:
        raise ValueError(f"bad new capacity {new_capacity}")
    live = (table.key_lo != 0) | (table.key_hi != 0)
    return rehash_into(new_capacity, table.key_lo, table.key_hi, live,
                       table.cols, hash_shift)[0]


def rehash_into(capacity: int, key_lo: torch.Tensor, key_hi: torch.Tensor,
                mask: torch.Tensor, rows: Dict[str, torch.Tensor],
                hash_shift: int = 0) -> Tuple[Table, torch.Tensor]:
    """A fresh table of ``capacity`` slots holding the rows of the lanes in
    ``mask``, ``max_probe`` the capacity (``grow``, the cold tier's
    rebuild); returns (table, claimed slots).  On CUDA tensors of more
    than _cuda.INSERT_SPLIT_MAX_N lanes K2's round form takes a table none
    of whose arrays is written and writes every slot (``fill``); else the
    table starts as zeros and ``insert`` runs."""
    specs = {k: v.dtype for k, v in rows.items()}
    if key_lo.is_cuda and not _cuda.insert_split(key_lo.numel(), capacity):
        fresh = _new_table(capacity, specs, key_lo.device, torch.empty)
        claimed = _cuda.insert(
            fresh.key_lo, fresh.key_hi, fresh.tombstone, fresh.cols,
            fresh.count, fresh.probe_overflow, key_lo, key_hi, mask, rows,
            capacity, hash_shift, fill=True)
        return fresh, claimed
    return insert(make_table(capacity, specs, key_lo.device), key_lo, key_hi,
                  mask, rows, max_probe=capacity, hash_shift=hash_shift)


def remove_to_tombstone(
    table: Table, slot: torch.Tensor, valid: torch.Tensor
) -> Table:
    """Clear keys at ``slot`` where ``valid`` (rollback of inserts), leaving
    tombstones, in place; ``count`` drops by the number of valid lanes.
    Kernel K8 on CUDA tensors."""
    if slot.is_cuda:
        _cuda.tombstone(table.key_lo, table.key_hi, table.tombstone,
                        table.count, slot, valid)
        return table
    return remove_to_tombstone_plain(table, slot, valid)


def remove_to_tombstone_plain(
    table: Table, slot: torch.Tensor, valid: torch.Tensor
) -> Table:
    """Plain PyTorch version of kernel K8.  A slot at or above the capacity
    is dropped, as the JAX scatter's mode="drop" does; ``count`` still drops
    by every valid lane, as in JAX."""
    keep = valid & (slot >= 0) & (slot < table.capacity)
    idx = slot[keep]
    table.key_lo[idx] = 0
    table.key_hi[idx] = 0
    table.tombstone[idx] = True
    table.count -= valid.sum()
    return table
