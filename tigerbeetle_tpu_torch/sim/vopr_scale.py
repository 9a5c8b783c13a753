"""Run the batched VOPR's clean model at scale on the card and record its
throughput: the twin of ``tools/vopr_scale.py``, with the same flags and the
same JSON keys.

    python -m tigerbeetle_tpu_torch.sim.vopr_scale [--schedules 100000]
        [--steps 200] [--batch 8192] [--device cpu] [--out PATH]

Batches of ``--batch`` clusters, ``--steps`` steps each, under
``HARSH_FAULTS``, seeds 1, 2, ... until ``--schedules`` schedules have run
(a warm-up batch at seed 0 first, untimed), through ``vopr_tpu.run`` (kernel
K29 on the card).  Prints one JSON line: schedules, steps_per_schedule,
violations (must be 0), elapsed_s, schedules_per_minute, platform ("gpu" on
the card), faults, captured_iso, and on the card its name and power limit
(``nvidia-smi --query-gpu=name,power.limit``) and the wall of each batch.
It writes a file only where ``--out`` points.  ``--device cpu`` runs the
plain PyTorch loop instead (slow; for checks at small sizes).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from .. import device as device_mod
from . import vopr_tpu


def card_name_and_power(index: int = 0) -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of card ``index``."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=60, check=True)
    return out.stdout.decode().strip().splitlines()[0]


def scale(schedules: int, steps: int, batch: int, dev: torch.device,
          log=sys.stderr) -> dict:
    """Run the batches and return the record (without writing it)."""
    harsh = dict(vopr_tpu.HARSH_FAULTS)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    vopr_tpu.run(seed=0, n_clusters=batch, n_steps=steps, device=dev, **harsh)
    sync()
    total = violations = 0
    walls = []
    seed = 1
    t0 = time.perf_counter()
    while total < schedules:
        tb = time.perf_counter()
        v = vopr_tpu.run(seed=seed, n_clusters=batch, n_steps=steps,
                         device=dev, **harsh)
        walls.append(time.perf_counter() - tb)
        total += len(v)
        violations += int(v.sum())
        seed += 1
        elapsed = time.perf_counter() - t0
        print(f"# {total} schedules, {violations} violations, "
              f"{total / max(elapsed, 1e-9) * 60:.0f}/min", file=log)
    elapsed = time.perf_counter() - t0
    out = {
        "schedules": total,
        "steps_per_schedule": steps,
        "violations": violations,
        "elapsed_s": elapsed,
        "schedules_per_minute": total / elapsed * 60,
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "faults": harsh,
        "captured_iso": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "batch": batch,
        "batch_wall_s": walls,
    }
    if dev.type == "cuda":
        out["device"] = torch.cuda.get_device_name(dev)
        out["nvidia_smi"] = card_name_and_power(dev.index or 0)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--schedules", type=int, default=100_000)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--out", default=None, help="also write the record here")
    args = p.parse_args(argv)
    dev = device_mod.resolve(args.device)
    out = scale(args.schedules, args.steps, args.batch, dev)
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    if out["violations"]:
        print(f"{out['violations']} clean-model violations", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
