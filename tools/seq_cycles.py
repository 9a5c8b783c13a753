"""Where K6's sequencer spends its cycles on the sequential path's shape.

Builds csrc/sequential.cu (with probe.cu, for the error strings) with
SEQ_CYCLES defined into build/seq_cycles/, then runs batches of bench.py's
two-phase shape (8,190 events over 8,190 accounts, on the sequential
path's default tables, as chip_smoke.py's seq_kernels phase does) through
the port's K6 wrapper twice each, on the port's own library and on the
counting one, from the same ledger.  Prints one JSON line a batch: K6's
device time (K32 and the sequencer, CUDA events around the call) with and
without the counters, the SM clock the counters ran at, and the
sequencer block's cycles per event by phase (csrc/sequential.cu SeqCycle:
the sequencer's own phases, then the stager warps' and the writer warp's,
each summed over its warps).  Both runs must leave the same codes and
ledger.  Run from the repository root on a machine with a CUDA card:

    python tools/seq_cycles.py [--batches 4]
"""

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tigerbeetle_tpu_torch import convert, types  # noqa: E402
from tigerbeetle_tpu_torch.ops import _cuda  # noqa: E402
from tigerbeetle_tpu_torch.ops import scan_path as sp  # noqa: E402
from tigerbeetle_tpu_torch.ops import state_machine as sm  # noqa: E402
from tigerbeetle_tpu_torch.utils.benchgen import gen_two_phase_np  # noqa: E402

# csrc/sequential.cu SeqCycle, in order.
PHASES = ("wait", "gather", "ladder", "apply", "rollback", "flush", "flushes",
          "serial", "stage_wait", "stage_work", "write_wait", "write_work",
          "loop")
LANES, COUNT = 8192, 8190


def build() -> ctypes.CDLL:
    out = _cuda.BUILD_DIR.parent / "seq_cycles"
    out.mkdir(parents=True, exist_ok=True)
    flags = (*_cuda.NVCC_FLAGS, "-DSEQ_CYCLES")
    procs = [(obj, subprocess.Popen(
        [_cuda._nvcc(), *flags, "-c", str(_cuda.CSRC / src), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        for src in ("sequential.cu", "probe.cu")
        for obj in [out / (Path(src).stem + ".o")]]
    for _obj, proc in procs:
        text = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError("nvcc failed:\n" + text)
    lib_path = out / "libseq_cycles.so"
    subprocess.run([_cuda._nvcc(), *flags[:2], "-shared", "-o", str(lib_path),
                    *(str(o) for o, _p in procs)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("tb_seq_prepass", "tb_seq_transfers", "tb_seq_cycles"):
        getattr(lib, name).argtypes = _cuda._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.tb_error_string.argtypes = [ctypes.c_int]
    lib.tb_error_string.restype = ctypes.c_char_p
    return lib


@contextlib.contextmanager
def using(lib):
    """The port's wrappers launch from ``lib`` inside the block."""
    saved = _cuda._LIB
    _cuda._LIB = lib
    try:
        yield
    finally:
        _cuda._LIB = saved


def run(led, soa, ts):
    """K6 (K32, then the sequencer) on ``led``: (codes, device ms by CUDA
    events around the call)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    _, codes, overflow = sp.create_transfers_seq(led, soa, COUNT, ts)
    end.record()
    end.synchronize()
    if bool(overflow):
        raise AssertionError("a probe reached MAX_PROBE")
    return codes, start.elapsed_time(end)


def arrays(led) -> dict:
    """Every array of a ledger, by table and column."""
    out = {}
    for name, table in convert.ledger_to_numpy(led).items():
        for k, v in table.items():
            for c, a in (v.items() if k == "cols" else [(k, v)]):
                out[name, c] = a
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("seq_cycles: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    _cuda.library()
    counting = build()
    led = sm.make_ledger(1 << 16, 1 << 18, 1 << 16, 1 << 16, device=dev)
    acc = types.accounts_array([types.account(id=i, ledger=1, code=10)
                                for i in range(1, COUNT + 1)])
    sp.create_accounts_seq(led, convert.batch_to_tensors(acc, LANES, dev),
                           COUNT, 10 ** 9)
    cycles = (ctypes.c_ulonglong * len(PHASES))()
    with using(counting):
        if counting.tb_seq_cycles(cycles) != 0:  # clears the counters
            raise RuntimeError("the counting library has no counters")
    for b in range(args.batches):
        soa = convert.batch_to_tensors(
            gen_two_phase_np(b, LANES, COUNT, COUNT, 1 << 32), LANES, dev)
        ts = (b + 2) * 10 ** 9
        copy = convert.ledger_from_numpy(convert.ledger_to_numpy(led), dev)
        codes, ms = run(led, soa, ts)
        with using(counting):
            ccodes, ms_counted = run(copy, soa, ts)
            if counting.tb_seq_cycles(cycles) != 0:
                raise RuntimeError("tb_seq_cycles failed")
        got = arrays(copy)
        bad = [k for k, a in arrays(led).items() if not np.array_equal(a, got[k])]
        if bad or not torch.equal(codes, ccodes):
            raise AssertionError(f"the counting build differs: {bad or 'codes'}")
        cy = dict(zip(PHASES, (int(x) for x in cycles)))
        print(json.dumps({
            "batch": b, "events": COUNT, "k6_ms": ms,
            "k6_ms_counted": ms_counted,
            "sm_ghz": cy["loop"] / (ms_counted * 1e6),
            "flushes": cy["flushes"],
            "cycles_per_event": {k: v / COUNT for k, v in cy.items()
                                 if k != "flushes"},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
