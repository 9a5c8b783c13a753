"""The general kernel's core, K10 full_legs and K30 shard_gather on the card,
at the paths' shapes, for the checkout in ``--tree`` (this one by default):
the shapes and the timing are this checkout's ``chip_smoke``, the package
timed is the tree's, so one call can time an earlier tree's kernels beside
this one's (earlier, this, this, earlier).  Run from the repository root on
a machine with a CUDA card:

    python tools/full_core_times.py [--tree DIR] [--parts core,legs,gather]

``core``: three batch shapes, full_kernels' timing batch (bench.py's
two-phase shape on a ledger of 8,190 accounts with limit and history flags,
64 same-home clusters and tombstones), the full_twophase path's (bench.py's
--two-phase on 10,000 plain accounts) and the full_limits path's (bench.py's
--limits: 10,000 limit-flagged accounts funded, then the plain generator),
each the third batch after the path's set-up and two batches.  For each
shape one JSON line from ``chip_smoke.core_times``: the core and K12 (at
its pass budget and with no round) by CUDA events behind a spin, the host's
time to queue one core, the core's launches by kernel and a profile by
kernel name, and the batch's passes and wave schedule.

``legs``: K10 at full_kernels' timing batch (``chip_smoke.full_inputs``,
every valid lane ok): one launch from a fresh sort cache (the cache of these
legs' slots, as K12 leaves it), one that finds the cache stale (its ok word
0, as a new batch's: it sorts and refreshes it) and one with no cache, each
by CUDA events behind a spin.  The launch goes through the tree's own
pointer layout (``LEGS_LAYOUT``) and buffers (``legs_buffers``), so any tree
of the port since K10 took its cache runs it.  A digest of the outputs lets
two trees be compared.

``gather``: K30 at 8,192 lanes (8,190 ids of a flagship batch, about half
of them stored ids) over a transfers table of 2^25 slots holding 10,000,000
rows in 8 shards on one card, the 17 columns, no overflow word asked (the
fast path's gather), into the tree's layout (one answer row for the card,
or a row a shard).
"""

import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("debits_pending", "debits_posted", "credits_pending",
          "credits_posted")
PARTS = ("core", "legs", "gather")


def k30_shape(cs, dev):
    """K30's shape: the 8 shards' transfers tables (2^25 slots in all,
    holding 10,000,000 rows) and 8,192 query keys (8,190 ids of a flagship
    batch, about half replaced by stored ids); (tables, lo, hi, columns)."""
    import numpy as np
    import torch
    from tigerbeetle_tpu_torch.ops import state_machine as sm
    from tigerbeetle_tpu_torch.utils.benchgen import gen_batch_np

    rng = np.random.default_rng(30)
    gen = torch.Generator(device=dev)
    gen.manual_seed(30)
    fill, n_shards = 10_000_000, 8
    xkeys = cs.t64((1 << 45) + np.arange(fill, dtype=np.uint64)
                   * np.uint64(7919), dev)
    xrows = cs.rand_cols(sm.TRANSFER_COLS, fill, dev, gen)
    xt = cs.shard_fill(rng, dev, n_shards, 25, sm.TRANSFER_COLS, xkeys, xrows)
    del xkeys, xrows
    flag = gen_batch_np(7, cs.LANES, cs.COUNT, cs.N_ACCOUNTS, 1 << 40)
    q = np.zeros(cs.LANES, np.uint64)
    q[:cs.COUNT] = flag["id_lo"]
    hit = rng.random(cs.COUNT) < 0.5
    q[:cs.COUNT][hit] = ((1 << 45) + rng.integers(0, fill, int(hit.sum()))
                         .astype(np.uint64) * np.uint64(7919))
    qlo = cs.t64(q, dev)
    return xt, qlo, torch.zeros_like(qlo), tuple(sm.TRANSFER_COLS)


def core_part(cs, dev, smi, tree):
    import numpy as np
    import torch

    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine
    from tigerbeetle_tpu_torch.ops import transfer_full as tf
    from tigerbeetle_tpu_torch.utils import benchgen

    def report(shape, ledger, batch, ts):
        t = cs.core_times(ledger, cs.soa_of(batch, dev), cs.COUNT, ts)
        _, _, waves, _, valid = t["inputs"]
        proved, needed, _, hist = tf._wave_schedule_plain(
            *waves, valid, t["inputs"][0].accounts_capacity, tf._MAX_PASSES)
        print(json.dumps({
            "shape": shape, "tree": tree, "nvidia_smi": smi,
            "core_ms": t["core"]["device_ms"],
            "core_host_ms": t["core_host_ms"],
            "k12_ms": t["k12"]["device_ms"],
            "k12_no_rounds_ms": t["k12_no_rounds"]["device_ms"],
            "launches": t["launches"],
            "profile_ms_and_events_by_name": {
                k[:40]: v for k, v in t["profile"].items()},
            "passes": int(t["plan"].passes.item()), "proved": bool(proved),
            "passes_needed": int(needed), "wave_hist": hist.tolist(),
            "hazard_lanes": int(waves[0].sum())}), flush=True)

    m, _, wall = cs.full_prepared_ledger(np.random.default_rng(4), dev)
    report("full_kernels", m.ledger,
           benchgen.gen_two_phase_np(0, cs.LANES, cs.COUNT, cs.COUNT, 1 << 50),
           wall + 10 ** 11)
    del m
    for shape in ("twophase", "limits"):
        m = TorchStateMachine(LedgerConfig(lazy_index=True),
                              batch_lanes=cs.LANES, device=dev)
        _, _, gen = cs.full_path_setup(m, shape)
        for b in range(2):
            if m.create_transfers(gen(b, cs.LANES, cs.COUNT, cs.N_ACCOUNTS,
                                      1 << 32)) != []:
                raise AssertionError(f"{shape}: batch {b} had failures")
        report("full_" + shape, m.ledger,
               gen(2, cs.LANES, cs.COUNT, cs.N_ACCOUNTS, 1 << 32), 10 ** 15)
        del m
        torch.cuda.empty_cache()


def legs_part(cs, dev, smi, tree):
    import numpy as np
    import torch

    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.utils.benchgen import gen_two_phase_np

    m, _, _wall = cs.full_prepared_ledger(np.random.default_rng(4), dev)
    batch = gen_two_phase_np(0, cs.LANES, cs.COUNT, cs.COUNT, 1 << 50)
    soa = cs.soa_of(batch, dev)
    legs = cs.full_inputs(m.ledger, soa, cs.COUNT)[3]
    n = legs["ok_lanes"].numel()
    # The sort cache of these legs' slots, K12's format (this tool builds
    # it itself: an earlier tree has no testing/k10cases.py).
    slot = np.stack([np.where(cs.to_np(legs[f"{s}_live"]),
                              cs.to_np(legs[f"{s}_slot"]),
                              legs["cap_sentinel"]) for s in ("dr", "cr")],
                    1).reshape(-1).astype(np.int64)
    keys = np.full(1 << max(1, (2 * n - 1).bit_length()), -1, np.int64)
    keys[:2 * n] = np.sort((slot << 15) | np.arange(2 * n))
    fresh = (cs.t64(keys, dev), cs.t64(slot, dev),
             torch.ones(1, dtype=torch.int32, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(cache):
        out = _cuda.legs_buffers(n, dev)
        a = legs
        named = {
            "start": [a["start_bal"][f + s] for f in FIELDS
                      for s in ("_lo", "_hi")],
            "ok": [a["ok_lanes"]], "amt": [a["amt_lo"]],
            "pamt": [a["pamt_lo"]], "dr_slot": [a["dr_slot"]],
            "cr_slot": [a["cr_slot"]], "dr_live": [a["dr_live"]],
            "cr_live": [a["cr_live"]], "pending": [a["pending_f"]],
            "post": [a["post"]], "postvoid": [a["postvoid"]],
            "val": out["val"], "ctrl": [None], "proved": [None],
            "needed": [None],
            "cache_keys": [None if cache is None else cache[0]],
            "cache_slot": [None if cache is None else cache[1]],
            "cache_ok": [None if cache is None else cache[2]]}
        for name, count in _cuda.LEGS_LAYOUT:
            if name not in named:
                named[name] = [out[name]] if name in out else [None] * count
        ptrs, nptrs = _cuda.layout_array(_cuda.LEGS_LAYOUT, named)
        _cuda.full_legs_launch(ptrs, nptrs, n, a["has_postvoid"],
                               a["cap_sentinel"], False, stream)
        return out

    def digest(out) -> str:
        h = hashlib.sha256()
        for k in ("leg_pos", "s_slot", "s_live", "is_last", "arith"):
            h.update(cs.to_np(out[k]).tobytes())
        for v in out["val"]:
            h.update(cs.to_np(v).tobytes())
        return h.hexdigest()[:16]

    def stale():
        keys, slot, ok = (x.clone() for x in fresh)
        ok.zero_()
        return ((keys, slot, ok),)

    digests = {"fresh": digest(launch(fresh)), "none": digest(launch(None)),
               "stale": digest(launch(stale()[0]))}
    k10 = {"fresh_cache": cs.timed(lambda: launch(fresh))["device_ms"],
           "stale_cache": cs.timed(launch, setup=stale)["device_ms"],
           "no_cache": cs.timed(lambda: launch(None))["device_ms"]}
    print(json.dumps({"kernel": "full_legs", "tree": tree, "nvidia_smi": smi,
                      "ms": k10, "legs": 2 * n, "digests": digests}),
          flush=True)
    del m, legs, fresh


def gather_part(cs, dev, smi, tree):
    import torch

    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import state_machine as sm

    xt, qlo, qhi, names = k30_shape(cs, dev)
    n_shards = len(xt)
    m_words = (2 + len(names)) * cs.LANES + 1
    row = torch.empty(m_words, dtype=torch.int64, device=dev)
    try:
        _cuda.shard_gather(xt, range(n_shards), n_shards, qlo, qhi, names,
                           sm.MAX_PROBE, cs.COUNT, None, row, 0, m_words - 1,
                           False)
        layout = "one row for the card"
    except ValueError:
        row = torch.empty(n_shards, m_words, dtype=torch.int64, device=dev)
        layout = "a row a shard"

    def k30():
        _cuda.shard_gather(xt, range(n_shards), n_shards, qlo, qhi, names,
                           sm.MAX_PROBE, cs.COUNT, None, row, 0,
                           m_words - 1, False)

    k30()
    answer = row if row.dim() == 1 else row.sum(0)
    h = hashlib.sha256(cs.to_np(answer[:-1]).tobytes()).hexdigest()[:16]
    print(json.dumps({"kernel": "shard_gather", "tree": tree,
                      "nvidia_smi": smi, "layout": layout,
                      "ms": cs.timed(k30)["device_ms"],
                      "found": int((answer[:cs.LANES] != 0).sum()),
                      "answer_digest": h}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT),
                    help="the checkout whose tigerbeetle_tpu_torch is timed")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="which of core, legs, gather to time")
    args = ap.parse_args()
    parts = args.parts.split(",")
    if set(parts) - set(PARTS):
        ap.error(f"--parts takes {PARTS}")
    sys.path.insert(0, str(Path(args.tree).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    import tigerbeetle_tpu_torch
    from tigerbeetle_tpu_torch.ops import _cuda

    dev = torch.device("cuda")
    smi = cs.nvidia_smi()
    tree = str(Path(tigerbeetle_tpu_torch.__file__).resolve().parents[1])
    print(smi, tree, flush=True)
    _cuda.build_seconds()
    run = {"core": core_part, "legs": legs_part, "gather": gather_part}
    for part in parts:
        run[part](cs, dev, smi, tree)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
