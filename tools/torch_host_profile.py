"""Where the host's time goes on the port's general path: cProfile over 60
batches of bench.py's two-phase shape (8,190 events, 10,000 accounts)
through a default TorchStateMachine on one CUDA card, after 10 warm-up
batches.  Prints the wall per batch (under cProfile) and the top functions
by own and by cumulative time.  Run from the repository root:

    python tools/torch_host_profile.py
"""

import cProfile
import pstats
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from tigerbeetle_tpu_torch import types  # noqa: E402
from tigerbeetle_tpu_torch.config import LedgerConfig  # noqa: E402
from tigerbeetle_tpu_torch.machine import TorchStateMachine  # noqa: E402
from tigerbeetle_tpu_torch.utils.benchgen import gen_two_phase_np  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_host_profile: no CUDA device", file=sys.stderr)
        return 2
    m = TorchStateMachine(LedgerConfig(transfers_capacity_log2=21,
                                       posted_capacity_log2=20),
                          batch_lanes=8192, device="cuda")
    for start in range(0, 10_000, 8190):
        ids = range(start + 1, min(10_000, start + 8190) + 1)
        m.create_accounts(types.accounts_array(
            [types.account(id=i, ledger=1, code=10) for i in ids]))
    batches = [gen_two_phase_np(b, 8192, 8190, 10_000, 1 << 32)
               for b in range(70)]
    for b in batches[:10]:
        m.create_transfers(b)
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for b in batches[10:]:
        m.create_transfers(b)
    prof.disable()
    print("ms per batch under cProfile",
          (time.perf_counter() - t0) / (len(batches) - 10) * 1e3)
    stats = pstats.Stats(prof)
    stats.sort_stats("tottime").print_stats(25)
    stats.sort_stats("cumulative").print_stats(30)
    return 0


if __name__ == "__main__":
    sys.exit(main())
