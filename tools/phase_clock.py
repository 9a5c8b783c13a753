"""Where K13 run_sort's, K3 validate's, K9 full_index's, K15
index_window's (union mode), K1 probe's, K7 seq_accounts', K2's round
form's, K10 full_legs' and K30 shard_gather's time goes, by phase, on the
card.

Builds csrc/index_sort.cu, csrc/validate.cu, csrc/full_index.cu,
csrc/index_query.cu, csrc/probe.cu, csrc/sequential.cu, csrc/insert.cu,
csrc/full_legs.cu and csrc/shard_gather.cu with TB_PHASE_CLOCK defined into
build/phase_clock/: thread
0 of each block (the first 64) stores %globaltimer at each of the kernel's
phase marks (csrc/phase_clock.cuh).  ``split(kernel, fn)`` runs ``fn``
(a call that launches the kernel once through its wrapper) on that library
and returns the marks' times since the launch's first block started,
averaged over the blocks, median of five launches after two; chip_smoke.py's
kernels, index_kernels, full_kernels and queries phases print it at the
paths' shapes.  From the repository root on a machine with a CUDA card,
for a flagship-shaped batch (both sides of 8,192 index entries), K3 and
K9 on 8,192 lanes and K15 on a limit-8,192 query over a pyramid of
levels 2^13-2^23 (five of eleven occupied a side, 10,000 accounts), K1 on
8,192 keys (half stored) into a table of 2^20 slots at load 0.45 gathering
15 columns, and K7 on 8,190 new accounts into an empty table of 2^16
(the sequential path's shape).  K1's marks are a block's (block barriers
in the clocked build only) and the last lookup's of a launch; K7's come
from its four kernels (the pre-pass's probe and mark launches, the
sequencer's one block, the finish); K2's round form's come from its
three kernels and its fill (each of round 0's two launches starting, the
cooperative rounds starting, block 0's one-block tail starting and ending,
the fill's writes starting: a mark reached by no block is left out), on
``grow`` 2^20 -> 2^21 at load 0.5 (its insert into an unwritten table);
K10's from a fresh sort cache (scanned, the grid barrier's verdict,
written) and when it sorts (the chunks sorted, merged, scanned, written),
on testing/k10cases.py's ``fresh_cache`` legs at 8,192 lanes, with the
cache and with none; K30's are a lane's, not a block's (``lanes``: each
answering lane's key hashed, probe done, stores issued), at
tools/full_core_times.py's 8-shard shape (its ``gather`` part):

    python tools/phase_clock.py
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tigerbeetle_tpu_torch.ops import _cuda  # noqa: E402
from tigerbeetle_tpu_torch.ops import hash_table as ht  # noqa: E402
from tigerbeetle_tpu_torch.ops import scan_path as sp  # noqa: E402
from tigerbeetle_tpu_torch.ops import state_machine as sm  # noqa: E402

# The marks of each kernel, in order (csrc/index_sort.cu, csrc/validate.cu,
# csrc/full_index.cu, csrc/index_query.cu's union mode).
MARKS = {
    "run_sort": ("start", "network", "cluster_barrier", "copies", "end"),
    "validate": ("start", "cleared", "ladders_ids_winners",
                 "duplicates_block_scan", "chain_starts_failures", "end"),
    "full_index": ("start", "cleared", "inserted_with_lead",
                   "found_and_joined"),
    "index_union": ("start", "windows_searched", "pruned", "scanned",
                    "staged", "ranked", "tail_written"),
    "probe": ("start", "probed", "row_loaded", "row_stored"),
    "seq_accounts": ("start", "probed", "mark_start", "marked",
                     "sequencer_start", "overlay_ready", "walked",
                     "sequencer_end", "finish_start", "finished"),
    "insert_rounds": ("round0_contend", "round0_resolve", "grid_rounds",
                      "tail", "tail_end", "fill"),
    "full_legs": ("start", "scanned_from_cache", "verdict", "chunks_sorted",
                  "merged", "scanned_after_sort", "written_after_sort",
                  "written_from_cache"),
}
ENTRY = {"run_sort": "tb_run_sort_phases", "validate": "tb_validate_phases",
         "full_index": "tb_full_index_phases",
         "index_union": "tb_index_query_phases",
         "probe": "tb_probe_phases", "seq_accounts": "tb_seq_accounts_phases",
         "insert_rounds": "tb_insert_phases", "full_legs": "tb_full_legs_phases"}
SOURCES = ("index_sort.cu", "validate.cu", "full_index.cu", "index_query.cu",
           "probe.cu", "sequential.cu", "insert.cu", "full_legs.cu",
           "shard_gather.cu")
# K30's lane clock (csrc/shard_gather.cu): each answering lane's marks.
LANE_MARKS = ("hashed", "probed", "stored")
LANE_CLOCK = 8192
_LIB = None


def library() -> ctypes.CDLL:
    """The clocked library (built once a process)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    out = _cuda.BUILD_DIR.parent / "phase_clock"
    out.mkdir(parents=True, exist_ok=True)
    flags = (*_cuda.NVCC_FLAGS, "-DTB_PHASE_CLOCK")
    procs = [(obj, subprocess.Popen(
        [_cuda._nvcc(), *flags, "-c", str(_cuda.CSRC / src), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        for src in SOURCES
        for obj in [out / (Path(src).stem + ".o")]]
    for _obj, proc in procs:
        text = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError("nvcc failed:\n" + text)
    path = out / "libphase_clock.so"
    subprocess.run([_cuda._nvcc(), *flags[:2], "-shared", "-o", str(path),
                    *(str(o) for o, _p in procs)], check=True)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _cuda._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    lib.tb_error_string.argtypes = [ctypes.c_int]
    lib.tb_error_string.restype = ctypes.c_char_p
    for entry in ENTRY.values():
        getattr(lib, entry + "_read").argtypes = [ctypes.c_void_p]
    lib.tb_shard_gather_lanes_read.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def split(kernel: str, fn, reps: int = 7) -> dict:
    """``fn`` run ``reps`` times on the clocked library: each mark's time
    (us since the launch's first block started; mean over the clocked
    blocks, median over the launches after the first two) and the blocks
    that reached it."""
    lib = library()
    read = getattr(lib, ENTRY[kernel] + "_read")
    clear = getattr(lib, ENTRY[kernel] + "_clear")
    marks = MARKS[kernel]
    saved = _cuda._LIB
    runs = []
    _cuda._LIB = lib
    try:
        for _ in range(reps):
            if clear() != 0:
                raise RuntimeError("phase clock: clear failed")
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (64 * 16))()
            if read(buf) != 0:
                raise RuntimeError("phase clock: read failed")
            runs.append(np.frombuffer(buf, np.uint64).reshape(64, 16)
                        [:, :len(marks)].astype(np.int64))
    finally:
        _cuda._LIB = saved
    out = {}
    for k, name in enumerate(marks):
        per_run = []
        for a in runs[2:]:
            live = a[:, 0] > 0
            hit = live & (a[:, k] > 0)
            if hit.any():
                per_run.append((a[hit, k] - a[live, 0].min()).mean() / 1e3)
        if per_run:
            out[name] = round(float(np.median(per_run)), 3)
    blocks = int((runs[-1][:, 0] > 0).sum())
    return {"us_since_start": out, "blocks_clocked": blocks}


def lanes(fn, reps: int = 7) -> dict:
    """K30's lane clock: ``fn`` (a call that launches K30 once) run
    ``reps`` times on the clocked library; over the lanes that answered,
    each mark's time (us since the first lane hashed its key), as the
    median and the largest over the lanes (the largest is when the last
    lane got there), median over the launches after the first two; and
    the lanes clocked."""
    lib = library()
    saved = _cuda._LIB
    runs = []
    _cuda._LIB = lib
    try:
        for _ in range(reps):
            if lib.tb_shard_gather_lanes_clear() != 0:
                raise RuntimeError("lane clock: clear failed")
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (LANE_CLOCK * 4))()
            if lib.tb_shard_gather_lanes_read(buf) != 0:
                raise RuntimeError("lane clock: read failed")
            runs.append(np.frombuffer(buf, np.uint64).reshape(LANE_CLOCK, 4)
                        [:, :len(LANE_MARKS)].astype(np.int64))
    finally:
        _cuda._LIB = saved
    out = {}
    for k, name in enumerate(LANE_MARKS):
        med, top = [], []
        for a in runs[2:]:
            live = a[:, 0] > 0
            t = (a[live, k] - a[live, 0].min()) / 1e3
            med.append(np.median(t))
            top.append(t.max())
        out[name] = {"median": round(float(np.median(med)), 3),
                     "last": round(float(np.median(top)), 3)}
    return {"us_since_first_hash": out,
            "lanes_clocked": int((runs[-1][:, 0] > 0).sum())}


def query_pyramid(dev):
    """Both sides of a pyramid shaped as chip_smoke.py's queries phase
    leaves it after 10,000,000 flagship transfers (levels 2^13-2^23, five
    of eleven occupied), over 10,000 accounts, and a limit-8,192 query's
    arguments on account 1."""
    from tigerbeetle_tpu_torch import convert
    from tigerbeetle_tpu_torch.ops import index as ix
    from tigerbeetle_tpu_torch.testing import k15cases

    occupied = [False, True, True, False, False, False, True, True, False,
                False, True]
    dr, cr, _ts = k15cases.pyramid(np.random.default_rng(1), occupied,
                                   fill=1.0, n_accts=10_000, base=8192)
    side = lambda blocks: [ix.Level(convert.array_to_tensor(b, dev))  # noqa: E731
                           for b in blocks]
    return side(dr), side(cr), 1, 0, 1, (1 << 64) - 2, True, True, 8192, False


def k1_shape(dev):
    """A transfers table of 2^20 slots at load 0.45 and 8,192 keys, half of
    them stored."""
    rng = np.random.default_rng(2)
    cap = 1 << 20
    t = ht.make_table(cap, sm.TRANSFER_COLS, dev)
    ids = torch.from_numpy(np.unique(rng.integers(
        1, 1 << 62, int(cap * 0.45), dtype=np.uint64)).view(np.int64)).to(dev)
    rows = {k: ids.to(dt) for k, dt in sm.TRANSFER_COLS.items()}
    ht.insert(t, ids, torch.zeros_like(ids), torch.ones_like(ids, dtype=torch.bool),
              rows, sm.MAX_PROBE)
    lo = torch.cat([ids[torch.randperm(len(ids), device=dev)[:4096]],
                    torch.randint(1, 1 << 62, (4096,), device=dev)])
    return t, lo, torch.zeros_like(lo)


def k7_shape(dev):
    """The sequential path's create_accounts batch: 8,190 new accounts
    (ids 1..8,190) into an empty accounts table of 2^16 slots; each call
    of the returned function makes a fresh ledger."""
    from tigerbeetle_tpu_torch import convert, types

    batch = types.accounts_array([types.account(id=i, ledger=1, code=10)
                                  for i in range(1, 8191)])
    padded = np.zeros(8192, dtype=batch.dtype)
    padded[:8190] = batch
    soa = convert.soa_to_tensors(types.to_soa(padded), dev)

    def args():
        led = sm.make_ledger(1 << 16, 1 << 18, 1 << 16, 1 << 16, device=dev)
        return led, soa, 8190, 10 ** 9
    return args


def grow_claim(dev, old_cap: int):
    """A call of ``hash_table.rehash_into`` as ``grow`` makes it: every
    slot of a table of ``old_cap`` slots at load 0.5 a lane, into an
    unwritten table of twice the slots, written whole (K2's ``fill``)."""
    t = ht.make_table(old_cap, sm.TRANSFER_COLS, dev)
    ids = 1 + torch.arange(old_cap // 2, dtype=torch.int64, device=dev)
    ht.insert(t, ids, torch.zeros_like(ids), torch.ones_like(ids, dtype=torch.bool),
              {k: ids.to(dt) for k, dt in sm.TRANSFER_COLS.items()}, old_cap)
    live = (t.key_lo != 0) | (t.key_hi != 0)

    def fn():
        ht.rehash_into(2 * old_cap, t.key_lo, t.key_hi, live, t.cols)
    return fn


def k30_shape(dev):
    """A call of K30 at tools/full_core_times.py's shape (8,192 lanes
    over 8 shards of transfers holding 10,000,000 rows, 17 columns, no
    overflow word) into one row for the card."""
    import importlib.util

    root = Path(__file__).resolve().parents[1]
    mods = {}
    for name, path in (("chip_smoke", root / "chip_smoke.py"),
                       ("full_core_times",
                        root / "tools" / "full_core_times.py")):
        spec = importlib.util.spec_from_file_location(name, path)
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    cs = mods["chip_smoke"]
    xt, lo, hi, names = mods["full_core_times"].k30_shape(cs, dev)
    m = (2 + len(names)) * cs.LANES + 1
    row = torch.empty(m, dtype=torch.int64, device=dev)
    return lambda: _cuda.shard_gather(xt, range(len(xt)), len(xt), lo, hi,
                                      names, sm.MAX_PROBE, cs.COUNT, None,
                                      row, 0, m - 1, False)


def legs_call(a, cache):
    """K10 on its own on k10cases' tensors, with the sort cache or none."""
    return _cuda.full_legs(
        a["start_bal"], a["cap_sentinel"], a["ok_lanes"], a["amt_lo"],
        a["pamt_lo"], a["dr_slot"], a["cr_slot"], a["dr_live"],
        a["cr_live"], a["pending_f"], a["post"], a["postvoid"],
        a["has_postvoid"], cache=cache)


def main() -> None:
    from tigerbeetle_tpu_torch import convert
    from tigerbeetle_tpu_torch.ops import index as ix
    from tigerbeetle_tpu_torch.ops import transfer_full as tf
    from tigerbeetle_tpu_torch.testing import k3cases, k9cases, k10cases, k13cases

    dev = torch.device("cuda")
    cols, use = k13cases.entries(8192, "random")
    side = [convert.array_to_tensor(c, dev) for c in cols]
    use_t = torch.from_numpy(use).to(dev)
    outs = [[torch.empty(8192, dtype=torch.int64, device=dev)
             for _ in range(5)] for _ in range(2)]
    batch, ctx, count, ts = k3cases.transfer_case("random", 8192)
    t = lambda a: convert.array_to_tensor(a, dev)  # noqa: E731
    soa = convert.soa_to_tensors(batch, dev)
    vcols = ([soa[c] for c in sm.TRANSFER_BATCH_COLS]
             + [t(ctx[c]) for c in sm.TRANSFER_CTX_COLS]
             + [t(ctx["e"][c]) for c in sm.TRANSFER_EXISTS_COLS])
    ids = [convert.array_to_tensor(a, dev)
           for a in k9cases.case("random", 8192)]
    query = query_pyramid(dev)
    k1_table, k1_lo, k1_hi = k1_shape(dev)
    k7_args = k7_shape(dev)
    k10_args, k10_cache = k10cases.to_tensors(
        *k10cases.case("fresh_cache", 8192), dev)
    k30 = k30_shape(dev)
    print(json.dumps({
        "run_sort_both_sides_8192": split(
            "run_sort", lambda: _cuda.run_sort([side, side], use_t, outs)),
        "validate_transfers_8192": split(
            "validate", lambda: _cuda.validate("transfers", vcols, count, ts)),
        "full_index_8192": split("full_index",
                                 lambda: tf._build_id_index(*ids)),
        "index_union_limit_8192": split(
            "index_union", lambda: ix.query_transfers(*query)),
        "probe_8192_15_columns": split(
            "probe", lambda: ht.lookup(k1_table, k1_lo, k1_hi, sm.MAX_PROBE,
                                       cols=sm.TRANSFER_EXISTS_COLS)),
        "seq_accounts_8190_new": split(
            "seq_accounts", lambda: sp.create_accounts_seq(*k7_args())),
        "insert_rounds_grow_2e20": split(
            "insert_rounds", grow_claim(dev, 1 << 20)),
        "full_legs_8192_fresh_cache": split(
            "full_legs", lambda: legs_call(k10_args, k10_cache)),
        "full_legs_8192_no_cache": split(
            "full_legs", lambda: legs_call(k10_args, None)),
        "shard_gather_8_shards_lanes": lanes(k30),
    }))


if __name__ == "__main__":
    main()
