"""Secondary index for transfer queries (port of
``tigerbeetle_tpu/ops/index.py``).

Per side (debit / credit) a Bentley–Saxe pyramid of sorted runs: level k
holds ``base << k`` entries sorted by (account_hi, account_lo, timestamp),
``base`` one batch of lanes.  Each committed batch appends one sorted run at
level 0; an occupied level carries upward, binary-counter style.  A query
binary-searches every level and gathers a bounded window from each, then
unions the windows in timestamp order.

Entries carry the transfer id (not its slot), so table growth never
invalidates the index.  Sentinel entries (every column U64_MAX) pad partial
runs and sort after every real entry.  The index is derived state: it is not
checkpointed, and ``rebuild`` makes it from the transfers table in one go.

Tensors: every column is an int64 tensor holding the u64 bits (U64_MAX is
-1); a level is a dict of its five columns (``Level``), the rows of one
(5, capacity) block so that a level resets with one fill.  Unsigned order is
the signed order of ``x ^ INT64_MIN``.

Kernels on CUDA tensors (the plain PyTorch versions beside them serve CPU
tensors): ``_sort_level`` is K13 ``run_sort`` (a stable sort of a run of up
to 8,192 entries in one launch; longer arrays in sorted chunks of 1,024,
then K14 rounds), ``_merge`` is K14
``run_merge`` (stable merge-path merges of the sorted inputs, left first on
ties, which equals the JAX concatenate-and-stable-sort; a full build's
rounds merge the runs' live prefixes alone, then write the sentinel-keyed
tail once: ``_merge_sides_split_plain``, ``_rounds_split_plain``),
``_query_side`` is
K15's window mode and ``query_transfers`` K15's union mode.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..u128 import INT64_MIN, i64
from . import _cuda
from . import hash_table as ht
from . import state_machine as sm

U64M = (1 << 64) - 1
_M = -1  # U64M as int64 bits

COLS = ("acct_lo", "acct_hi", "ts", "tid_lo", "tid_hi")


class Level(dict):
    """One sorted run: the five ``COLS`` as rows of ``block`` (5, n)."""

    def __init__(self, block: torch.Tensor) -> None:
        super().__init__(zip(COLS, block.unbind(0)))
        self.block = block

    @property
    def n(self) -> int:
        return self.block.shape[1]


def _sentinel_level(capacity: int, device) -> Level:
    return Level(torch.full((5, capacity), _M, dtype=torch.int64, device=device))


def _as_level(lvl: Dict[str, torch.Tensor]) -> Level:
    if isinstance(lvl, Level):
        return lvl
    return Level(torch.stack([lvl[name] for name in COLS]))


def _lexsort_plain(lvl: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The stable order of ``jnp.lexsort((ts, acct_lo, acct_hi))`` over u64
    bit patterns: one stable sort pass per key, least significant first."""
    n = lvl["ts"].shape[0]
    order = torch.arange(n, device=lvl["ts"].device)
    for name in ("ts", "acct_lo", "acct_hi"):
        _, p = torch.sort(lvl[name][order] ^ INT64_MIN, stable=True)
        order = order[p]
    return order


def _sort_level_plain(lvl: Dict[str, torch.Tensor]) -> Level:
    order = _lexsort_plain(lvl)
    return Level(torch.stack([lvl[name][order] for name in COLS]))


SORT_CHUNK = 1024  # csrc/index_sort.cu: a sorted chunk K14 merges
MERGE_CHUNK = 512  # csrc/index_sort.cu: a chunk of a run K13 sorts whole


def _sort_split_plain(cols: Sequence[torch.Tensor],
                      use: Optional[torch.Tensor], n_out: int,
                      fused: bool = True) -> Tuple[Level, int]:
    """Kernel K13's own steps in plain PyTorch: (the sorted run or sorted
    chunks, the sorted runs' length).  A run of 1,025 to 8,192 entries
    (when ``fused``) is cut into chunks of 512, each sorted by (key,
    position), then merged by rank: an entry's output position is its index
    in its chunk, plus the count of keys <= its key in every earlier chunk
    and of keys < its key in every later chunk, each count a fixed-step
    binary search.  Otherwise the run is sorted in chunks of 1,024.  The
    padding of the last chunk (past ``n_out``) sorts last and is not
    written."""
    if use is None:
        use = torch.ones_like(cols[0], dtype=torch.bool)
    lvl = _masked(cols, use, n_out)
    dev = lvl["ts"].device
    merge = fused and SORT_CHUNK < n_out <= _cuda.SORT_RUN_MAX
    size = MERGE_CHUNK if merge else SORT_CHUNK
    chunks = -(-n_out // size)
    if chunks > 1 and not merge and n_out % size:
        raise ValueError(f"{n_out} entries is not a multiple of 1,024")
    total = chunks * size
    padded = {}
    for name in ("acct_hi", "acct_lo", "ts"):
        padded[name] = torch.full((total,), _M, dtype=torch.int64, device=dev)
        padded[name][:n_out] = lvl[name]
    order = torch.cat([
        _lexsort_plain({k: v[c:c + size] for k, v in padded.items()}) + c
        for c in range(0, total, size)])
    if not merge:
        run = n_out if chunks == 1 else size
        return Level(torch.stack([lvl[c][order[:n_out]] for c in COLS])), run
    # Each chunk sorted, in unsigned order as signed.
    hi, lo, ts = (padded[k][order] ^ INT64_MIN for k in ("acct_hi", "acct_lo", "ts"))
    own = torch.arange(total, device=dev) // size
    rank = torch.arange(total, device=dev) % size
    for d in range(chunks):
        length = min(size, n_out - d * size)
        le = own > d  # d is an earlier chunk: keys <= count
        n = torch.zeros(total, dtype=torch.int64, device=dev)
        step = size
        while step:
            p = n + step - 1
            at = d * size + p.clamp(max=length - 1)
            before = (hi[at] < hi) | ((hi[at] == hi) & (
                (lo[at] < lo) | ((lo[at] == lo) & (
                    (ts[at] < ts) | (le & (ts[at] == ts))))))
            n = torch.where((p < length) & before, n + step, n)
            step >>= 1
        rank += torch.where(own == d, torch.zeros_like(n), n)
    real = torch.arange(total, device=dev) % size < n_out - own * size
    final = torch.empty(n_out, dtype=torch.int64, device=dev)
    final[rank[real]] = order[real]
    return Level(torch.stack([lvl[c][final] for c in COLS])), n_out


def _sort_level(lvl: Dict[str, torch.Tensor]) -> Level:
    """The level's entries in (acct_hi, acct_lo, ts) order, stable."""
    if lvl["ts"].is_cuda:
        return _sort_masked([[lvl[name] for name in COLS]], None,
                            lvl["ts"].shape[0])[0]
    return _sort_level_plain(lvl)


def _sort_masked(jobs: Sequence[Sequence[torch.Tensor]],
                 use: Optional[torch.Tensor], n_out: int,
                 fused: bool = True) -> List[Level]:
    """CUDA route of a sort of each job's five columns (length n_in <=
    n_out), entries where ``use`` is False and entries past n_in taken as
    sentinels: K13 over chunks, then K14 rounds over the chunks (for a run
    of up to 8,192, K13 merges its chunks in the same launch unless
    ``fused`` is False): ``_merge_rounds``."""
    dev = jobs[0][0].device
    chunks = [torch.empty((5, n_out), dtype=torch.int64, device=dev)
              for _ in jobs]
    chunk = _cuda.run_sort(jobs, use, [list(o.unbind(0)) for o in chunks],
                           fused)
    if chunk >= n_out:
        return [Level(o) for o in chunks]
    return _merge_rounds(chunks, chunk)


def _merge_rounds(chunks: Sequence[torch.Tensor], chunk: int) -> List[Level]:
    """K14's part of a sort on CUDA: each job's (5, n) block of K13's
    sorted chunks of ``chunk`` merged into one run: rounds over the runs'
    live prefixes, then the tail step (``_rounds_split_plain`` is its plain
    form).  The chunks are kept until the tail is written."""
    n_out = chunks[0].shape[1]
    dev = chunks[0].device
    bufs = [[torch.empty_like(o) for o in chunks] for _ in range(2)]
    pchunk = [torch.empty(n_out // chunk, dtype=torch.int64, device=dev)
              for _ in chunks]
    src, pin, run, k = chunks, None, chunk, 0
    while run < n_out:
        dst = bufs[k % 2]
        pout = [torch.empty(n_out // (2 * run), dtype=torch.int64, device=dev)
                for _ in chunks]
        _cuda.run_merge_rounds([list(o.unbind(0)) for o in src],
                               [list(o.unbind(0)) for o in dst], run, pin,
                               pout, pchunk if pin is None else None)
        src, pin, run, k = dst, pout, run * 2, k + 1
    _cuda.run_merge_tail([list(o.unbind(0)) for o in chunks],
                         [list(o.unbind(0)) for o in src], chunk, pchunk, pin)
    return [Level(o) for o in src]


def _side_cols(rows, id_lo, id_hi, acct_field):
    return [rows[acct_field + "_lo"], rows[acct_field + "_hi"],
            rows["timestamp"], id_lo, id_hi]


def build_runs(
    ledger: sm.Ledger, id_lo: torch.Tensor, id_hi: torch.Tensor,
    ok: torch.Tensor,
) -> Tuple[Level, Level]:
    """Sorted level-0 runs (debit side, credit side) for a just-committed
    batch: the stored rows by id (K1), keyed by each side's account."""
    look = ht.lookup(
        ledger.transfers, id_lo, id_hi, sm.MAX_PROBE,
        cols=("debit_account_id_lo", "debit_account_id_hi",
              "credit_account_id_lo", "credit_account_id_hi", "timestamp"),
        mask=ok,
    )
    use = look.found  # ok & found
    sides = [_side_cols(look.cols, id_lo, id_hi, f)
             for f in ("debit_account_id", "credit_account_id")]
    if id_lo.is_cuda:
        dr, cr = _sort_masked(sides, use, id_lo.shape[0])
        return dr, cr
    return tuple(_sort_level_plain(_masked(cols, use)) for cols in sides)


def _masked(cols: Sequence[torch.Tensor], use: torch.Tensor,
            n_out: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The level dict of ``cols`` with sentinels where not ``use`` and in
    the padding up to ``n_out``."""
    n = use.shape[0]
    n_out = n if n_out is None else n_out
    out = {}
    for name, c in zip(COLS, cols):
        v = torch.where(use, c, torch.full_like(c, _M))
        if n_out > n:
            v = torch.cat([v, torch.full((n_out - n,), _M, dtype=torch.int64,
                                         device=c.device)])
        out[name] = v
    return out


def _merge_plain(levels: Sequence[Dict[str, torch.Tensor]]) -> Level:
    cat = {name: torch.cat([lvl[name] for lvl in levels]) for name in COLS}
    return _sort_level_plain(cat)


def _merge(levels: Sequence[Dict[str, torch.Tensor]]) -> Level:
    """One sorted run of every entry of ``levels`` (each sorted), as the
    JAX concatenate-and-sort gives it."""
    return _merge_sides([levels])[0]


def _merge_sides(jobs: Sequence[Sequence[Dict[str, torch.Tensor]]],
                 outs: Optional[Sequence[Level]] = None) -> List[Level]:
    """``_merge`` of each job's levels; on CUDA one K14 launch per step for
    all jobs (the carry's pairwise merges: run + level 0, + level 1, ...),
    the last written into ``outs`` when given."""
    if not jobs[0][0]["ts"].is_cuda:
        merged = [_merge_plain(levels) for levels in jobs]
        if outs is not None:
            for o, m in zip(outs, merged):
                o.block.copy_(m.block)
            return list(outs)
        return merged
    acc = [_as_level(levels[0]) for levels in jobs]
    steps = len(jobs[0])
    for s in range(1, steps):
        nxt_n = acc[0].n + jobs[0][s]["ts"].shape[0]
        if s == steps - 1 and outs is not None:
            nxt = list(outs)
        else:
            nxt = [Level(torch.empty((5, nxt_n), dtype=torch.int64,
                                     device=a.block.device)) for a in acc]
        _cuda.run_merge(
            [[a[name] for name in COLS] for a in acc],
            [[levels[s][name] for name in COLS] for levels in jobs],
            [[o[name] for name in COLS] for o in nxt])
        acc = nxt
    if steps == 1 and outs is not None:
        for o, a in zip(outs, acc):
            o.block.copy_(a.block)
        return list(outs)
    return acc


# K14's own steps in plain PyTorch (csrc/index_merge.cu): a pairwise merge
# cut into tiles of _cuda.MERGE_TILE outputs at the merge-path splits that
# a warp's 32-ary search finds; a full build's rounds over K13's chunks
# merging the runs' live prefixes alone, then the tail written once.

_GARBAGE = 0x0123456789ABCDEF  # what the card leaves past a prefix: never read


def _first_true32_plain(lo: int, hi: int, pred) -> int:
    """K14's 32-ary warp search (``warp_split``, ``warp_prefix``): the
    first i in [lo, hi) where ``pred`` (an index tensor to a bool tensor,
    false then true) holds, else hi.  Each round tests 32 pivots
    lo + (l + 1) step - 1 (true past the range) and keeps the step before
    the first true one."""
    lane = torch.arange(32, dtype=torch.int64)
    while lo < hi:
        step = (hi - lo + 31) // 32
        p = lo + (lane + 1) * step - 1
        hit = (p >= hi) | pred(torch.clamp(p, max=hi - 1)).cpu()
        if not bool(hit.any()):
            return hi
        f = int(torch.nonzero(hit)[0])
        lo, hi = lo + f * step, min(hi, lo + (f + 1) * step - 1)
    return lo


def _ukeys(lvl) -> Tuple[torch.Tensor, ...]:
    """(acct_hi, acct_lo, ts) with unsigned order as signed order."""
    return tuple(lvl[c] ^ INT64_MIN for c in ("acct_hi", "acct_lo", "ts"))


def _key_lt(x, i, y, j) -> torch.Tensor:
    """Key x[i] < key y[j] (``_ukeys`` triples, index tensors)."""
    xh, xl, xt = (k[i] for k in x)
    yh, yl, yt = (k[j] for k in y)
    return (xh < yh) | ((xh == yh) & ((xl < yl) | ((xl == yl) & (xt < yt))))


def _merge_tiles_plain(a, b, na: int, nb: int) -> Dict[str, torch.Tensor]:
    """The stable merge of a[:na] and b[:nb] (a first on equal keys) as
    K14's blocks make it: each tile of _cuda.MERGE_TILE outputs from the
    A and B ranges between its two splits, merged on its own."""
    ka, kb = _ukeys(a), _ukeys(b)
    total = na + nb
    ds = list(range(0, total, _cuda.MERGE_TILE)) + [total]
    splits = []
    for d in ds:
        if d in (0, total):
            splits.append(0 if d == 0 else na)
            continue
        splits.append(_first_true32_plain(
            max(0, d - nb), min(d, na),
            lambda i: _key_lt(kb, d - 1 - i, ka, i)))
    parts = []
    for t in range(len(ds) - 1):
        i0, i1 = splits[t], splits[t + 1]
        j0, j1 = ds[t] - i0, ds[t + 1] - i1
        staged = {c: torch.cat([a[c][i0:i1], b[c][j0:j1]]) for c in COLS}
        order = _lexsort_plain(staged)
        parts.append({c: staged[c][order] for c in COLS})
    dev = a["ts"].device
    return {c: torch.cat([p[c] for p in parts]) if parts else
            torch.empty(0, dtype=torch.int64, device=dev) for c in COLS}


def _merge_sides_split_plain(jobs) -> List[Level]:
    """``_merge_sides`` by K14's steps: each job's carry a chain of tiled
    pairwise merges (run + level 0, + level 1, ...)."""
    out = []
    for levels in jobs:
        acc = levels[0]
        for lvl in levels[1:]:
            acc = _merge_tiles_plain(acc, lvl, acc["ts"].shape[0],
                                     lvl["ts"].shape[0])
        out.append(Level(torch.stack([acc[c] for c in COLS])))
    return out


def _rounds_split_plain(chunks: Level, chunk: int) -> Level:
    """K14's rounds of a full build over K13's sorted chunks, in plain
    PyTorch: each chunk's live prefix (the entries before its
    sentinel-keyed tail) by the 32-ary search; each round merges adjacent
    runs' prefixes by ``_merge_tiles_plain`` and leaves the rest of a run
    unwritten; then the tail step writes every chunk's tail in chunk order
    after the level's prefix (keys the sentinel key, ids copied)."""
    n = chunks.n
    blk = chunks.block
    keys = _ukeys(chunks)
    sent = torch.full((), _M, dtype=torch.int64) ^ INT64_MIN
    pchunk = []
    for c in range(n // chunk):
        at = c * chunk
        pchunk.append(_first_true32_plain(
            0, chunk, lambda i: (keys[0][at + i] == sent)
            & (keys[1][at + i] == sent) & (keys[2][at + i] == sent)))
    cur, pin, run = blk, pchunk, chunk
    while run < n:
        nxt = torch.full_like(blk, _GARBAGE)
        pout = []
        for p in range(n // (2 * run)):
            a0, b0 = 2 * p * run, (2 * p + 1) * run
            a = {c: cur[k][a0:a0 + pin[2 * p]] for k, c in enumerate(COLS)}
            b = {c: cur[k][b0:b0 + pin[2 * p + 1]] for k, c in enumerate(COLS)}
            m = _merge_tiles_plain(a, b, pin[2 * p], pin[2 * p + 1])
            nxt[:, a0:a0 + m["ts"].shape[0]] = torch.stack([m[c] for c in COLS])
            pout.append(m["ts"].shape[0])
        cur, pin, run = nxt, pout, run * 2
    at = pin[0]
    for c, p in enumerate(pchunk):
        t = chunk - p
        cur[:3, at:at + t] = _M
        cur[3:, at:at + t] = blk[3:, c * chunk + p:(c + 1) * chunk]
        at += t
    return Level(cur)


def _sort_rounds_split_plain(cols: Sequence[torch.Tensor],
                             use: Optional[torch.Tensor], n_out: int,
                             fused: bool = True) -> Level:
    """``_sort_masked``'s route in plain PyTorch: K13's split form, then
    (past one sorted run) K14's rounds and tail."""
    lvl, run = _sort_split_plain(cols, use, n_out, fused)
    return lvl if run >= n_out else _rounds_split_plain(lvl, run)


def _live(t: ht.Table) -> torch.Tensor:
    return ((t.key_lo != 0) | (t.key_hi != 0)) & ~t.tombstone


def _full_build_side(ledger: sm.Ledger, acct_field: str, capacity: int) -> Level:
    """One sorted run over every live transfer (restart/state-sync
    rebuild), padded with sentinels to ``capacity``."""
    t = ledger.transfers
    assert capacity >= t.capacity
    cols = [t.cols[acct_field + "_lo"], t.cols[acct_field + "_hi"],
            t.cols["timestamp"], t.key_lo, t.key_hi]
    live = _live(t)
    if t.key_lo.is_cuda:
        return _sort_masked([cols], live, capacity)[0]
    return _sort_level_plain(_masked(cols, live, capacity))


def _search3(lvl, q_hi: int, q_lo: int, q_ts: int) -> int:
    """First index with (acct_hi, acct_lo, ts) >= (q_hi, q_lo, q_ts) (plain;
    the JAX loop of bit_length(n) halvings).  Arguments are u64 ints."""
    n = lvl["ts"].shape[0]
    hi_c = lvl["acct_hi"]
    lo_c = lvl["acct_lo"]
    ts_c = lvl["ts"]
    lo, hi = 0, n
    q = (q_hi, q_lo, q_ts)
    for _ in range(int(n).bit_length()):
        mid = min((lo + hi) // 2, n - 1)
        m = (int(hi_c[mid]) & U64M, int(lo_c[mid]) & U64M,
             int(ts_c[mid]) & U64M)
        less = m < q
        if lo < hi:
            if less:
                lo = mid + 1
            else:
                hi = mid
    return lo


def _query_side_plain(levels, acct_lo, acct_hi, ts_min, ts_max, k, descending):
    cand_ts, cand_lo, cand_hi = [], [], []
    a_lo, a_hi = i64(acct_lo), i64(acct_hi)
    for lvl in levels:
        n = lvl["ts"].shape[0]
        dev = lvl["ts"].device
        if descending:
            upper = _search3(lvl, acct_hi, acct_lo, (ts_max + 1) & U64M)
            pos = upper - 1 - torch.arange(k, dtype=torch.int64, device=dev)
        else:
            lower = _search3(lvl, acct_hi, acct_lo, ts_min)
            pos = lower + torch.arange(k, dtype=torch.int64, device=dev)
        in_range = (pos >= 0) & (pos < n)
        safe = torch.clamp(pos, 0, n - 1)
        e_hi = lvl["acct_hi"][safe]
        e_lo = lvl["acct_lo"][safe]
        e_ts = lvl["ts"][safe]
        e_tsu = e_ts ^ INT64_MIN
        valid = (
            in_range & (e_hi == a_hi) & (e_lo == a_lo)
            & (e_tsu >= (i64(ts_min) ^ INT64_MIN))
            & (e_tsu <= (i64(ts_max) ^ INT64_MIN))
        )
        zero = torch.zeros_like(e_ts)
        cand_ts.append(torch.where(valid, e_ts, torch.full_like(e_ts, _M)))
        cand_lo.append(torch.where(valid, lvl["tid_lo"][safe], zero))
        cand_hi.append(torch.where(valid, lvl["tid_hi"][safe], zero))
    return torch.cat(cand_ts), torch.cat(cand_lo), torch.cat(cand_hi)


def _key_before(lvl, idx: torch.Tensor, q, upper: bool) -> torch.Tensor:
    """Whether each entry ``idx`` of ``lvl`` sorts before the bound of key
    ``q`` (three u64 ints: acct_hi, acct_lo, ts): below q, or at most q
    where ``upper``."""
    e = [lvl[c][idx] ^ INT64_MIN for c in ("acct_hi", "acct_lo", "ts")]
    qs = [i64(x) ^ INT64_MIN for x in q]
    less = e[0] < qs[0]
    less = less | ((e[0] == qs[0]) & (e[1] < qs[1]))
    less = less | ((e[0] == qs[0]) & (e[1] == qs[1])
                   & ((e[2] <= qs[2]) if upper else (e[2] < qs[2])))
    return less


def _warp_search_plain(n: int, before) -> int:
    """Kernel K15's 32-ary warp search (csrc/index_query.cu ``warp_bounds``)
    in plain PyTorch: the first index in [0, n) at which ``before`` (an
    index tensor to a bool tensor, true then false) is false.  Each round
    tests 32 pivots lo + (l + 1) step - 1 (false past the range) and keeps
    the step after the last one still before."""
    lo, hi = 0, n
    lane = torch.arange(32, dtype=torch.int64)
    while lo < hi:
        step = (hi - lo + 31) // 32
        p = lo + (lane + 1) * step - 1
        inside = p < hi
        hit = before(torch.clamp(p, max=n - 1)).cpu() & inside
        cnt = int(hit.sum())
        top = lo + (cnt + 1) * step - 1
        lo += cnt * step
        hi = min(hi, top)
    return lo


def _search32_plain(lvl, q_hi: int, q_lo: int, q_ts: int,
                    upper: bool = False) -> int:
    """The first index of sorted ``lvl`` with key >= (q_hi, q_lo, q_ts) (>
    where ``upper``) by the 32-ary search: on a sorted level, ``_search3``'s
    answer (a CPU test holds it to the JAX search)."""
    dev = lvl["ts"].device
    q = (q_hi, q_lo, q_ts)
    return _warp_search_plain(
        lvl["ts"].shape[0], lambda i: _key_before(lvl, i.to(dev), q, upper))


def _window_desc_plain(lvl, acct_lo, acct_hi, ts_min, ts_max, k, descending):
    """(start, m, r) of one window, as K15's ``window_desc``: its
    candidates start at ``start`` (descending: below it); the first m are
    valid, the first r of them have a sort key below U64_MAX (ts below
    U64_MAX ascending, above 0 descending)."""
    if descending:
        b0 = _search32_plain(lvl, acct_hi, acct_lo, (ts_max + 1) & U64M)
        b1 = _search32_plain(lvl, acct_hi, acct_lo, ts_min)
        b2 = _search32_plain(lvl, acct_hi, acct_lo, max(ts_min, 1))
        m, r = b0 - b1, b0 - b2
    else:
        b0 = _search32_plain(lvl, acct_hi, acct_lo, ts_min)
        b1 = _search32_plain(lvl, acct_hi, acct_lo, ts_max, upper=True)
        b2 = _search32_plain(lvl, acct_hi, acct_lo, min(ts_max, U64M - 1),
                             upper=True)
        m, r = b1 - b0, b2 - b0
    return b0, min(max(m, 0), k), min(max(r, 0), k)


def query_transfers_split_plain(dr_levels, cr_levels, acct_lo, acct_hi,
                                ts_min, ts_max, want_debits, want_credits, k,
                                descending):
    """Kernel K15 union mode's own steps in plain PyTorch (the result of
    ``query_transfers_plain``, a CPU test holds it to the JAX function):
    each window's start, m and r by the 32-ary search; the prune key (the
    smallest k-th key of a wanted window whose k candidates all have keys
    below U64_MAX) and each wanted window's merged prefix, its first r keys
    at or below it; each prefix entry to its index plus the count of keys
    <= its key in earlier windows and < it in later ones, where that is
    below k; then positions R.. k - 1 (R the sum of the r) in closed form:
    the candidates whose key is U64_MAX in concatenation order."""
    wins = ([(lv, bool(want_debits)) for lv in dr_levels]
            + [(lv, bool(want_credits)) for lv in cr_levels])
    dev = wins[0][0]["ts"].device
    descs = [_window_desc_plain(lv, acct_lo, acct_hi, ts_min, ts_max, k,
                                descending) for lv, _w in wins]
    step = -1 if descending else 1

    def positions(w, count):
        start = descs[w][0] - 1 if descending else descs[w][0]
        return start + step * torch.arange(count, dtype=torch.int64,
                                           device=dev)

    def keys(w, count):  # u64 sort keys in signed order
        ts = wins[w][0]["ts"][positions(w, count)]
        return (~ts if descending else ts) ^ INT64_MIN

    rs = [d[2] if want else 0 for d, (_lv, want) in zip(descs, wins)]
    kth = [int(keys(w, k)[k - 1]) for w, r in enumerate(rs) if r == k]
    cs = []
    for w, r in enumerate(rs):
        if not kth:
            cs.append(r)
            continue
        cut = min(kth)
        cs.append(_warp_search_plain(
            r, lambda i, w=w, r=r: keys(w, r)[i.to(dev)] <= cut))
    staged = [keys(w, c) for w, c in enumerate(cs)]
    valid = torch.zeros(k, dtype=torch.bool, device=dev)
    out_lo = torch.zeros(k, dtype=torch.int64, device=dev)
    out_hi = torch.zeros(k, dtype=torch.int64, device=dev)
    for w, c in enumerate(cs):
        if c == 0:
            continue
        pos = torch.arange(c, dtype=torch.int64, device=dev)
        for v, other in enumerate(staged):
            if v != w and cs[v]:
                pos = pos + torch.searchsorted(other, staged[w], right=v < w)
        keep = pos < k
        src = positions(w, c)[keep]
        valid[pos[keep]] = True
        out_lo[pos[keep]] = wins[w][0]["tid_lo"][src]
        out_hi[pos[keep]] = wins[w][0]["tid_hi"][src]
    total_r = sum(rs)
    if total_r < k:
        tail = [0]
        for r in rs:
            tail.append(tail[-1] + k - r)
        t = torch.arange(k - total_r, dtype=torch.int64, device=dev)
        wof = torch.searchsorted(torch.tensor(tail[:-1], device=dev), t,
                                 right=True) - 1
        for w, ((lv, want), (start, m, _r)) in enumerate(zip(wins, descs)):
            sel = wof == w
            i = rs[w] + t[sel] - tail[w]
            hit = i < m
            p = (start - 1 - i if descending else start + i)[hit]
            pos = total_r + t[sel][hit]
            valid[pos] = want & (lv["ts"][p] != _M)
            out_lo[pos] = lv["tid_lo"][p]
            out_hi[pos] = lv["tid_hi"][p]
    return valid, out_lo, out_hi


def _query_side(levels, acct_lo: int, acct_hi: int, ts_min: int, ts_max: int,
                k: int, descending: bool):
    """Up to k (ts, tid) candidates per level for one side, concatenated
    over the levels (u64 scalars as Python ints)."""
    if levels[0]["ts"].is_cuda:
        return _cuda.index_window([levels], acct_lo, acct_hi, ts_min, ts_max,
                                  k, descending)
    return _query_side_plain(levels, acct_lo, acct_hi, ts_min, ts_max, k,
                             descending)


def query_transfers_plain(dr_levels, cr_levels, acct_lo, acct_hi, ts_min,
                          ts_max, want_debits, want_credits, k, descending):
    all_ts, all_lo, all_hi = [], [], []
    for levels, want in ((dr_levels, want_debits), (cr_levels, want_credits)):
        if not levels:
            continue
        ts, lo, hi = _query_side_plain(levels, acct_lo, acct_hi, ts_min,
                                       ts_max, k, descending)
        all_ts.append(ts if want else torch.full_like(ts, _M))
        all_lo.append(lo)
        all_hi.append(hi)
    ts = torch.cat(all_ts)
    lo = torch.cat(all_lo)
    hi = torch.cat(all_hi)
    big = ts == _M
    key = torch.where(big, ts, ~ts if descending else ts)
    _, order = torch.sort(key ^ INT64_MIN, stable=True)
    order = order[:k]
    return ts[order] != _M, lo[order], hi[order]


def query_transfers(
    dr_levels, cr_levels, acct_lo: int, acct_hi: int, ts_min: int,
    ts_max: int, want_debits: bool, want_credits: bool, k: int,
    descending: bool, device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(valid[k], tid_lo[k], tid_hi[k]) in result order: the union of the
    debit and credit index scans, timestamp-ordered (scan_merge.zig union);
    past the valid results, the other candidates in concatenation order.
    With no level on either side, zeros on ``device``."""
    dr_levels, cr_levels = list(dr_levels), list(cr_levels)
    if not dr_levels and not cr_levels:
        z = torch.zeros(k, dtype=torch.int64, device=device)
        return torch.zeros(k, dtype=torch.bool, device=device), z, z.clone()
    first = (dr_levels or cr_levels)[0]["ts"]
    if first.is_cuda:
        sides = [lv for lv in (dr_levels, cr_levels) if lv]
        wants = [w for lv, w in ((dr_levels, want_debits),
                                 (cr_levels, want_credits)) if lv]
        return _cuda.index_union(sides, wants, acct_lo, acct_hi, ts_min,
                                 ts_max, k, descending)
    return query_transfers_plain(dr_levels, cr_levels, acct_lo, acct_hi,
                                 ts_min, ts_max, bool(want_debits),
                                 bool(want_credits), k, descending)


class TransferIndex:
    """Host driver: owns the level tensors and the host-side occupancy that
    decides the Bentley–Saxe carry chain of each append.

    ``scan_builder.FieldIndex`` is the single-side twin of this pyramid."""

    def __init__(self, base: int, device=None) -> None:
        assert base & (base - 1) == 0
        self.base = base
        self.device = device
        self.dr_levels: List[Level] = []
        self.cr_levels: List[Level] = []
        self.occupied: List[bool] = []
        # A fresh machine's empty index matches its empty table; staleness
        # comes from reset() and is cured by a wholesale rebuild on next use.
        self.stale = False
        # Source of extra host rows to index at rebuild (the machine supplies
        # the cold tier's runs).
        self.extra_rows_provider = None
        # New level allocations (one per power-of-two size), as the JAX
        # index counts them.
        self.shape_class_events = 0

    # -- maintenance --------------------------------------------------------

    def reset(self) -> None:
        self.dr_levels, self.cr_levels, self.occupied = [], [], []
        self.stale = True

    def _ensure_level(self, k: int) -> None:
        while len(self.occupied) <= k:
            cap = self.base << len(self.occupied)
            self.dr_levels.append(_sentinel_level(cap, self.device))
            self.cr_levels.append(_sentinel_level(cap, self.device))
            self.occupied.append(False)
            self.shape_class_events += 1

    def append_batch(self, ledger: sm.Ledger, id_lo: torch.Tensor,
                     id_hi: torch.Tensor, ok: torch.Tensor) -> None:
        if self.stale:
            return  # rebuilt wholesale on next query
        dr_run, cr_run = build_runs(ledger, id_lo, id_hi, ok)
        k = 0
        while k < len(self.occupied) and self.occupied[k]:
            k += 1
        self._ensure_level(k)
        if k == 0:
            self.dr_levels[0] = dr_run
            self.cr_levels[0] = cr_run
        else:
            _merge_sides(
                [[dr_run] + self.dr_levels[:k], [cr_run] + self.cr_levels[:k]],
                outs=[self.dr_levels[k], self.cr_levels[k]])
            for j in range(k):
                self.dr_levels[j].block.fill_(_M)
                self.cr_levels[j].block.fill_(_M)
                self.occupied[j] = False
        self.occupied[k] = True

    def rebuild(self, ledger: sm.Ledger, extra_rows=None) -> None:
        """Full rebuild from the live table (one sort of the table per
        side), plus ``extra_rows`` (host TRANSFER_DTYPE arrays; by default
        what ``extra_rows_provider`` supplies)."""
        if extra_rows is None:
            extra_rows = (
                self.extra_rows_provider() if self.extra_rows_provider else ()
            )
        cap = max(self.base, ledger.transfers.capacity)
        k = (cap // self.base - 1).bit_length()
        self.dr_levels, self.cr_levels, self.occupied = [], [], []
        self._ensure_level(k)
        self.dr_levels[k] = _full_build_side(
            ledger, "debit_account_id", self.base << k)
        self.cr_levels[k] = _full_build_side(
            ledger, "credit_account_id", self.base << k)
        self.occupied[k] = True
        for rows in extra_rows:
            self._add_host_rows(rows)
        self.stale = False

    def _add_host_rows(self, rows) -> None:
        """Occupy a free level with host rows (cold-tier runs at rebuild)."""
        rows = np.asarray(rows)
        n = len(rows)
        if n == 0:
            return
        j = max(0, ((n + self.base - 1) // self.base - 1).bit_length())
        self._ensure_level(j)
        while self.occupied[j]:
            j += 1
            self._ensure_level(j)
        cap = self.base << j

        def level(acct_field):
            return _sort_level(_host_level(
                cap, self.device,
                rows[acct_field + "_lo"], rows[acct_field + "_hi"],
                rows["timestamp"], rows["id_lo"], rows["id_hi"]))

        self.dr_levels[j] = level("debit_account_id")
        self.cr_levels[j] = level("credit_account_id")
        self.occupied[j] = True

    # -- queries ------------------------------------------------------------

    def query(self, ledger: sm.Ledger, acct_lo: int, acct_hi: int,
              ts_min: int, ts_max: int, want_debits: bool,
              want_credits: bool, k: int, descending: bool):
        if self.stale:
            self.rebuild(ledger)
        return query_transfers(
            self.dr_levels, self.cr_levels, acct_lo, acct_hi, ts_min, ts_max,
            want_debits, want_credits, k, descending, device=self.device)


def _host_level(cap: int, device, *cols) -> Dict[str, torch.Tensor]:
    """A level dict of ``cap`` entries from host u64 columns, sentinel
    padded (one host-to-device copy)."""
    out = np.full((5, cap), U64M, np.uint64)
    for r, vals in enumerate(cols):
        out[r, :len(vals)] = np.asarray(vals).astype(np.uint64)
    block = torch.from_numpy(out.view(np.int64)).to(device)
    return dict(zip(COLS, block.unbind(0)))
