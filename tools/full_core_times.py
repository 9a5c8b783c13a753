"""Where the general kernel's core spends its device time, on three batch
shapes: full_kernels' timing batch (bench.py's two-phase shape on a ledger
of 8,190 accounts with limit and history flags, 64 same-home clusters and
tombstones), the full_twophase path's (bench.py's --two-phase on 10,000
plain accounts) and the full_limits path's (bench.py's --limits: 10,000
limit-flagged accounts funded, then the plain generator), each the third
batch after the path's set-up and two batches.

For each shape it prints one JSON line from ``chip_smoke.core_times``: the
core and K12 (at its pass budget and with no round) by CUDA events behind
a spin, the host's time to queue one core, the core's launches by kernel
and a profile by kernel name, and the batch's passes and wave schedule.
The shapes and the timing are this checkout's ``chip_smoke``; the package
timed is the one in ``--tree`` (by default this checkout), so one call can
time an earlier tree's kernels against this one's.  Run from the
repository root on a machine with a CUDA card:

    python tools/full_core_times.py [--tree DIR]
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT),
                    help="the checkout whose tigerbeetle_tpu_torch is timed")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch

    import tigerbeetle_tpu_torch
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import transfer_full as tf
    from tigerbeetle_tpu_torch.utils import benchgen

    dev = torch.device("cuda")
    smi = cs.nvidia_smi()
    tree = str(Path(tigerbeetle_tpu_torch.__file__).resolve().parents[1])
    print(smi, tree, flush=True)
    _cuda.build_seconds()

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
