"""Build, bind and launch the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` (each
``.cu`` to an object, all at once, then one shared library) into
``build/torch_kernels/`` at the repository root, named by a hash of the
sources, and loaded with ctypes.  Every pointer and the stream pass as
``c_void_p``.  Each C entry point launches on PyTorch's current stream and
returns ``cudaGetLastError()``; a wrapper raises on anything but 0.  A build
failure raises: there is no fallback.

The wrappers here take CUDA tensors only (the callers in ``hash_table`` and
``state_machine`` send CPU tensors to the plain PyTorch versions instead),
check device, dtype, shape and contiguity, allocate outputs and scratch, and
add one to their kernel's ``launches`` each time they launch it.

| kernel   | source                 | replaces (JAX package)                    |
|----------|------------------------|-------------------------------------------|
| probe    | csrc/probe.cu          | ops/hash_table.py:70 lookup (+gather_cols) |
| insert   | csrc/insert.cu         | ops/hash_table.py:114 claim_slots + :317 insert |
| validate | csrc/validate.cu       | ops/state_machine.py:349 account_codes, :491 transfer_codes |
| balance  | csrc/balance.cu        | ops/state_machine.py:574 balance_plan + :644 apply_balance_plan |
| digest   | csrc/digest.cu         | ops/state_machine.py:828 ledger_digest     |
| seq_transfers | csrc/sequential.cu | ops/scan_path.py:187 create_transfers_seq |
| seq_accounts  | csrc/sequential.cu | ops/scan_path.py:690 create_accounts_seq  |
| seq_prepass   | csrc/sequential.cu | ops/scan_path.py:79 _slookup, :85 _sprobe_free, the row gathers of :307 _transfer_logic (K6's pre-batch probes, in parallel) |
| tombstone     | csrc/tombstone.cu  | ops/hash_table.py:379 remove_to_tombstone |
| claim         | csrc/insert.cu     | ops/hash_table.py:114 claim_slots (claim only) |
| write_claimed | csrc/insert.cu     | ops/hash_table.py:286 write_rows           |
| full_index    | csrc/full_index.cu | ops/transfer_full.py:199 _build_id_index (+ :212 _search128's join) |
| full_legs     | csrc/full_legs.cu  | ops/transfer_full.py:266 _leg_balances (+ the apply's balance scatter) |
| full_pass     | csrc/full_pass.cu  | ops/transfer_full.py:806 one_pass, the loop, aux pass, routing (+ the history append) |
| full_waves    | csrc/full_waves.cu | ops/transfer_full.py:422 _wave_schedule    |
| run_sort      | csrc/index_sort.cu | ops/index.py:49 _sort_level (in :54 build_runs, the full builds) |
| run_merge     | csrc/index_merge.cu | ops/index.py:77 _merge (carries; full-build rounds) |
| index_window  | csrc/index_query.cu | ops/index.py:132 _query_side (+ :111 _search3), :165 query_transfers |
| history_scan  | csrc/history_scan.cu | ops/query.py:38 scan_history (+ :29 _top_k) |
| bloom_check   | csrc/bloom.cu; the general path's FLAG_COLD a step of probe's launch (csrc/probe.cu's flag word), counted here too | ops/cold.py:72 bloom_check_impl (+ transfer_full.py:638 FLAG_COLD) |
| evict_threshold | csrc/evict.cu    | ops/cold.py:391 eviction_threshold         |
| evict_extract | csrc/evict.cu      | ops/cold.py:402 extract_evicted (+ :426 drop_evicted's keep mask) |
| bench_gen     | csrc/bench_gen.cu  | utils/benchgen.py:22 gen_plain, :54 gen_twop (bench.py:2140 gen_batch, :2169 gen_two_phase) |
| scrub_fold    | csrc/scrub.cu      | ops/scrub.py:151 scrub_digest (+ :108-147 row_hash_*, _fold_*) |
| merkle_build  | csrc/merkle_build.cu | ops/merkle.py:125 build_forest_impl (+ :106 tree_from_leaves, :151 verify_roots_impl) |
| merkle_touch  | csrc/merkle_touch.cu | ops/merkle.py:183 touch_tree (+ :169 _leaf_at, :280 gather_path) |
| group_step    | csrc/group.cu      | machine.py:78 _group_fast_dispatch_impl (a step's lanes and the run's overflow word) |
| group_finish  | csrc/group.cu      | machine.py:102 the run's overflow word after the last step |
| group_words   | csrc/group.cu      | bench.py:2245 multi's batch index b0 + i (+ :2229 its timestamp) |
| group_dispatch | (a CUDA graph)    | machine.py:78 _group_fast_dispatch_impl: GROUP_K steps, one replay |
| vopr_draw     | csrc/vopr_draw.cu  | sim/vopr_tpu.py:160 draw_faults (vmapped over keys) |
| vopr_step     | csrc/vopr_step.cu  | sim/vopr_tpu.py:217 step (vmapped over clusters, :738) |
| vopr_run      | csrc/vopr_run.cu   | sim/vopr_tpu.py:702 _one_cluster_fn, :724 run, :741 run_sharded (+ :737 the keys) |
| shard_gather  | csrc/shard_gather.cu | parallel/sharded.py:142 _ShardGather (the owner-masked local probe and gather, and its psum within a card: one answer row a device) |
| shard_combine | csrc/shard_combine.cu | parallel/sharded.py:367 any_shard's psum within a card, before NCCL across cards |

The grouped commit's graph (``ops/group.py``) and the bench twin's read a
batch's count and timestamp from u64 device words, so one captured launch
sequence serves every run: ``probe``, ``validate`` (transfers) and
``bench_gen`` take such words (``count_word``, ``ts_word``, ``b_word``), and
``probe``, ``validate`` and ``insert`` take preallocated outputs and
scratch (a graph bakes every pointer; ``balance`` needs none; ``insert``'s
is ``insert_scratch``'s, nothing the size of the table for a batch).
``group_dispatch`` is not a kernel of its own: it counts the replays of the grouped commit's
graph, each of which launches the kernels above (their counts grow by the
graph's nodes at every replay, not at capture).

The VOPR's kernels (K27-K29) share ``csrc/vopr.cuh`` (the state layout,
the draws and the step) and ``csrc/threefry.cuh`` (JAX's threefry); their
pointers pass as arrays in the order of ``sim/vopr_tpu.py``'s
``FAULT_FIELDS`` and ``STATE_FIELDS`` (the C enums; a CPU test compares).

The general kernel's launches (K9-K12) take their pointers as one array in
the order of the kernel's pointer enum (``FULL_PASS_LAYOUT`` and
``LEGS_LAYOUT`` here; a CPU test compares them with the sources).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# --split-compile=0 spreads one source's optimisation over threads: the
# VOPR sources hold six instantiations of an unrolled step each.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "--split-compile=0",
)


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how
    many times its wrapper launched it."""

    name: str
    source: str  # repository path of the CUDA source
    replaces: str  # file:line of the JAX function it replaces
    launches: int = 0


KERNELS: Dict[str, Kernel] = {
    k.name: k
    for k in (
        Kernel("probe", "tigerbeetle_tpu_torch/csrc/probe.cu",
               "tigerbeetle_tpu/ops/hash_table.py:70"),
        Kernel("insert", "tigerbeetle_tpu_torch/csrc/insert.cu",
               "tigerbeetle_tpu/ops/hash_table.py:114"),
        Kernel("validate", "tigerbeetle_tpu_torch/csrc/validate.cu",
               "tigerbeetle_tpu/ops/state_machine.py:491"),
        Kernel("balance", "tigerbeetle_tpu_torch/csrc/balance.cu",
               "tigerbeetle_tpu/ops/state_machine.py:574"),
        Kernel("digest", "tigerbeetle_tpu_torch/csrc/digest.cu",
               "tigerbeetle_tpu/ops/state_machine.py:828"),
        Kernel("seq_transfers", "tigerbeetle_tpu_torch/csrc/sequential.cu",
               "tigerbeetle_tpu/ops/scan_path.py:187"),
        Kernel("seq_accounts", "tigerbeetle_tpu_torch/csrc/sequential.cu",
               "tigerbeetle_tpu/ops/scan_path.py:690"),
        Kernel("seq_prepass", "tigerbeetle_tpu_torch/csrc/sequential.cu",
               "tigerbeetle_tpu/ops/scan_path.py:79"),
        Kernel("tombstone", "tigerbeetle_tpu_torch/csrc/tombstone.cu",
               "tigerbeetle_tpu/ops/hash_table.py:379"),
        Kernel("claim", "tigerbeetle_tpu_torch/csrc/insert.cu",
               "tigerbeetle_tpu/ops/hash_table.py:114"),
        Kernel("write_claimed", "tigerbeetle_tpu_torch/csrc/insert.cu",
               "tigerbeetle_tpu/ops/hash_table.py:286"),
        Kernel("full_index", "tigerbeetle_tpu_torch/csrc/full_index.cu",
               "tigerbeetle_tpu/ops/transfer_full.py:199"),
        Kernel("full_legs", "tigerbeetle_tpu_torch/csrc/full_legs.cu",
               "tigerbeetle_tpu/ops/transfer_full.py:266"),
        Kernel("full_pass", "tigerbeetle_tpu_torch/csrc/full_pass.cu",
               "tigerbeetle_tpu/ops/transfer_full.py:806"),
        Kernel("full_waves", "tigerbeetle_tpu_torch/csrc/full_waves.cu",
               "tigerbeetle_tpu/ops/transfer_full.py:422"),
        Kernel("run_sort", "tigerbeetle_tpu_torch/csrc/index_sort.cu",
               "tigerbeetle_tpu/ops/index.py:49"),
        Kernel("run_merge", "tigerbeetle_tpu_torch/csrc/index_merge.cu",
               "tigerbeetle_tpu/ops/index.py:77"),
        Kernel("index_window", "tigerbeetle_tpu_torch/csrc/index_query.cu",
               "tigerbeetle_tpu/ops/index.py:132"),
        Kernel("history_scan", "tigerbeetle_tpu_torch/csrc/history_scan.cu",
               "tigerbeetle_tpu/ops/query.py:38"),
        Kernel("bloom_check", "tigerbeetle_tpu_torch/csrc/bloom.cu",
               "tigerbeetle_tpu/ops/cold.py:72"),
        Kernel("evict_threshold", "tigerbeetle_tpu_torch/csrc/evict.cu",
               "tigerbeetle_tpu/ops/cold.py:391"),
        Kernel("evict_extract", "tigerbeetle_tpu_torch/csrc/evict.cu",
               "tigerbeetle_tpu/ops/cold.py:402"),
        Kernel("bench_gen", "tigerbeetle_tpu_torch/csrc/bench_gen.cu",
               "tigerbeetle_tpu/utils/benchgen.py:22"),
        Kernel("scrub_fold", "tigerbeetle_tpu_torch/csrc/scrub.cu",
               "tigerbeetle_tpu/ops/scrub.py:151"),
        Kernel("merkle_build", "tigerbeetle_tpu_torch/csrc/merkle_build.cu",
               "tigerbeetle_tpu/ops/merkle.py:125"),
        Kernel("merkle_touch", "tigerbeetle_tpu_torch/csrc/merkle_touch.cu",
               "tigerbeetle_tpu/ops/merkle.py:183"),
        Kernel("group_step", "tigerbeetle_tpu_torch/csrc/group.cu",
               "tigerbeetle_tpu/machine.py:78"),
        Kernel("group_finish", "tigerbeetle_tpu_torch/csrc/group.cu",
               "tigerbeetle_tpu/machine.py:102"),
        Kernel("group_words", "tigerbeetle_tpu_torch/csrc/group.cu",
               "bench.py:2245"),
        Kernel("group_dispatch", "tigerbeetle_tpu_torch/csrc/group.cu",
               "tigerbeetle_tpu/machine.py:78"),
        Kernel("vopr_draw", "tigerbeetle_tpu_torch/csrc/vopr_draw.cu",
               "tigerbeetle_tpu/sim/vopr_tpu.py:160"),
        Kernel("vopr_step", "tigerbeetle_tpu_torch/csrc/vopr_step.cu",
               "tigerbeetle_tpu/sim/vopr_tpu.py:217"),
        Kernel("vopr_run", "tigerbeetle_tpu_torch/csrc/vopr_run.cu",
               "tigerbeetle_tpu/sim/vopr_tpu.py:724"),
        Kernel("shard_gather", "tigerbeetle_tpu_torch/csrc/shard_gather.cu",
               "tigerbeetle_tpu/parallel/sharded.py:142"),
        Kernel("shard_combine", "tigerbeetle_tpu_torch/csrc/shard_combine.cu",
               "tigerbeetle_tpu/parallel/sharded.py:367"),
    )
}


def reset_counts() -> None:
    global ROUND_FORM_CALLS, BLOOM_IN_PROBE
    for k in KERNELS.values():
        k.launches = 0
    ROUND_FORM_CALLS = 0
    BLOOM_IN_PROBE = 0


def counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


# -- build -----------------------------------------------------------------

_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libtb_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` (all at once) and link one shared library;
    a no-op when the library for these sources exists.  Raises on failure,
    with nvcc's output."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for src, _obj, proc in procs:
            text = proc.communicate()[0].decode(errors="replace")
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(lib),
             *(str(o) for _s, o, _p in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(lib, out)
    return out


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_U64 = ctypes.c_uint64
_M64 = (1 << 64) - 1


# Each C entry point's argument types (all return an int error code).
_SIGNATURES = {
    "tb_probe": [_INT, _INT, _P, _P, _P, _P, _P, _P, _P, _I64, _P, _P, _I64,
                 _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                 _I64, _P, _INT, _P],
    "tb_probe_info": [_P],
    "tb_insert": [_P, _P, _P, _I64, _INT, _I64, _P, _P, _P, _I64,
                  _P, _P, _P, _P, _P, _P, _P, _INT, _P, _P, _P, _INT, _P],
    "tb_validate_accounts": [_INT, _P, _I64, _I64, _P, _P, _P, _I64, _I64,
                             _P],
    "tb_validate_transfers": [_INT, _P, _I64, _I64, ctypes.c_uint64,
                              _P, _P, _P, _P, _P, _I64, _I64, _P],
    "tb_balance": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _P, _P],
    "tb_digest": [_P, _P, _P, _I64, _P, _P],
    "tb_seq_prepass": [_P, _INT, _P, _INT, _I64, _P, _INT, _I64,
                       _P, _INT, _I64, _I64, _I64, ctypes.c_uint64,
                       _P, _P, _P, _P, _I64, _I64, _I64, _P],
    "tb_seq_transfers": [_P, _INT, _P, _INT, _I64, _P, _INT, _I64,
                         _P, _INT, _I64, _P, _INT, _I64, _I64, _I64,
                         ctypes.c_uint64, _P, _P, _P, _P, _P, _P, _P],
    "tb_seq_cycles": [_P],
    "tb_seq_accounts": [_P, _INT, _P, _INT, _I64, _I64, _I64,
                        ctypes.c_uint64, _P, _P, _P],
    "tb_seq_accounts_scratch": [_I64, ctypes.POINTER(ctypes.c_int64)],
    "tb_seq_accounts_info": [_I64, _P],
    "tb_tombstone": [_P, _P, _P, _I64, _P, _P, _I64, _P, _P],
    "tb_claim": [_P, _P, _P, _I64, _INT, _I64, _P, _P, _P, _I64, _P, _P,
                 _P, _P, _P, _P, _INT, _P],
    "tb_insert_rounds_info": [_I64, _P],
    "tb_write_claimed": [_P, _P, _P, _I64, _P, _P, _P, _P, _I64, _P,
                         _INT, _P, _INT, _P, _P, _P, _P],
    "tb_full_index": [_P, _P, _P, _P, _I64, _P, _I64, _P, _P, _P, _P, _P],
    "tb_full_index_info": [_I64, _P],
    "tb_full_legs": [_P, _INT, _I64, _INT, ctypes.c_uint64, _INT, _P],
    "tb_full_legs_info": [_I64, _P],
    "tb_full_legs_apply": [_P, _I64, _P, _P, _I64, _I64, _P, _P, _P],
    "tb_full_waves": [_P, _P, _P, _P, _P, _P, _P, _I64, ctypes.c_uint64,
                      _INT, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "tb_full_pass": [_P, _INT, _INT, _INT, _I64, _I64, ctypes.c_uint64,
                     _INT, _INT, _INT, _I64, _P],
    "tb_full_hist": [_P, _P, _I64, _P, _P, _I64, _P, _P, _P],
    "tb_run_sort": [_P, _P, _INT, _P, _I64, _I64, _INT,
                    ctypes.POINTER(ctypes.c_int64), _P],
    "tb_run_sort_info": [_I64, _INT] + [ctypes.POINTER(ctypes.c_int)] * 3,
    "tb_run_merge": [_P, _P, _P, _INT, _P],
    "tb_run_merge_tail": [_P, _P, _P, _INT, _P, _P],
    "tb_index_window": [_P, _P, _INT, _U64, _U64, _U64, _U64, _I64, _INT,
                        _P, _P, _P, _P],
    "tb_index_union": [_P, _P, _INT, _INT, _INT, _INT, _U64, _U64, _U64,
                       _U64, _I64, _INT, _P, _P, _P, _P],
    "tb_index_window_info": [_P],
    "tb_history_scan": [_P, _P, _I64, _I64, _U64, _U64, _U64, _U64, _INT,
                        _INT, _INT, _P, _I64, _P, _P, _P, _P],
    "tb_history_scan_scratch": [_I64, ctypes.POINTER(ctypes.c_int64),
                                ctypes.POINTER(ctypes.c_int64)],
    "tb_bloom_check": [_P, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I64, _P, _P, _INT, _P],
    "tb_evict_threshold": [_P, _P, _P, _P, _I64, _P, _U64, _U64, _P, _P,
                           _P, _P, _P],
    "tb_evict_extract": [_P, _P, _P, _P, _I64, _P, _I64, _P, _P, _P, _P,
                         _P, _INT, _P, _P, _P, _P, _P],
    "tb_bench_gen": [_P, _I64, _INT, _U64, _P, _U64, _U64, _U64, _P],
    "tb_scrub_fold": [_P, _P, ctypes.POINTER(ctypes.c_int64), _P, _P],
    "tb_merkle_build": [_INT, _P, _P, _P, _I64, _P, _P, _P, _P, _P],
    "tb_merkle_touch": [_INT, _P, _P, _P, _I64, _P, _P, _P, _I64, _P],
    "tb_merkle_path": [_P, _I64, _I64, _INT, _P, _P],
    "tb_group_step": [_P, _P, _INT, _I64, _P, _P, _P, _P, _P, _P, _P],
    "tb_group_finish": [_P, _P, _P],
    "tb_group_words": [_P, _INT, _U64, _U64, _P, _P, _P, _P],
    "tb_vopr_draw": [_P, _I64, _INT, _INT, _P, _P, _P],
    "tb_vopr_step": [_I64, _INT, _INT, _INT, _INT, _P, _P, _P, _P],
    "tb_vopr_run": [ctypes.c_uint32, ctypes.c_uint32, _U64, _I64, _INT,
                    _INT, _INT, _P, _INT, _P, _P, _P, _P],
    "tb_vopr_run_info": [_INT, _INT, _INT, _INT, _P],
    "tb_shard_gather": [_INT, ctypes.POINTER(ctypes.c_int64), _I64, _INT,
                        _I64, _P, _P, _P, _INT, _P, _P, _I64, _P, _P,
                        _I64, _I64, _P, _P, _P, _INT, _P],
    "tb_shard_combine": [_P, _I64, _I64, _P, _P],
}


def _bind(lib: ctypes.CDLL) -> None:
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _INT
    lib.tb_error_string.argtypes = [_INT]
    lib.tb_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        _bind(lib)
        _LIB = lib
    return _LIB


def build_seconds() -> float:
    """Build (or find) and load the library; the seconds it took."""
    t0 = time.perf_counter()
    library()
    return time.perf_counter() - t0


# -- helpers ---------------------------------------------------------------


def _check(t: torch.Tensor, dtype: torch.dtype, n: Optional[int] = None,
           what: str = "tensor") -> None:
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if n is not None and t.numel() != n:
        raise ValueError(f"{what} must have {n} elements, got {t.numel()}")


def _word(t: torch.Tensor, what: str) -> None:
    """A u64 device word: a one-element int64 view of a CUDA tensor."""
    _check(t, torch.int64, 1, what)


def _ptr_array(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * max(1, len(tensors)))(
        *[t.data_ptr() for t in tensors]
    )


def _width(t: torch.Tensor) -> int:
    return t.element_size()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


class CudaKernelError(RuntimeError):
    """A hand-written kernel's launch or run failed (a nonzero CUDA error
    from its C entry point).  The device-fault family of ``ops/scrub.py``
    counts it as a device fault, as it does no bare ``RuntimeError``."""


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        msg = library().tb_error_string(err).decode()
        raise CudaKernelError(
            f"CUDA kernel {kernel} failed: error {err} ({msg})")


_U64_OR_U32 = (torch.int64, torch.int32, torch.bool)


# -- K1 probe --------------------------------------------------------------

PROBE_MAX_LOOKUPS = 8  # csrc/probe.cu PROBE_MAX_DESC: lookups a launch
PROBE_MAX_COLS = 96  # csrc/probe.cu PROBE_MAX_COLS: their columns together


@dataclasses.dataclass
class ProbeSpec:
    """One lookup of a fused K1 launch: a table (its key arrays, tombstones
    and columns), the keys, the columns to gather and the mask of ``found``
    (lanes below ``count``, or below the u64 device word ``count_word``,
    and set in ``mask``).  ``key_hi`` None means zeros.  ``keys_from`` =
    (k, lo_name, hi_name or None) takes the keys from lookup k's gathered
    columns instead: the lookup then runs after k in k's chain, on the same
    thread, which reads them back from its own stores.  ``out`` (found,
    slot, columns) takes the outputs in place."""

    tkey_lo: torch.Tensor
    tkey_hi: torch.Tensor
    tomb: torch.Tensor
    table_cols: Dict[str, torch.Tensor]
    key_lo: Optional[torch.Tensor]
    key_hi: Optional[torch.Tensor]
    names: Sequence[str] = ()
    count: Optional[int] = None
    mask: Optional[torch.Tensor] = None
    hash_shift: int = 0
    count_word: Optional[torch.Tensor] = None
    out: Optional[Tuple[torch.Tensor, torch.Tensor,
                        Sequence[torch.Tensor]]] = None
    keys_from: Optional[Tuple[int, str, Optional[str]]] = None
    grow_bit: int = 0  # probe_flags: ORed into the word on an overflow
    cold: bool = False  # probe_flags: the lanes test their key (K17's step)


def probe_many(specs: Sequence[ProbeSpec], max_probe: int,
               overflow: bool = True):
    """Kernel K1: the lookups ``specs``, of one lane count each, in one
    launch; a list of (found, slot, overflow, gathered columns) in their
    order.  ``overflow`` False asks for no overflow flags (each is None
    then, and no memset is made); else each is a 0-dim bool view of one
    byte the entry point zeroes and the kernel sets."""
    return _probe_launch(specs, max_probe, overflow, None)[0]


# K1 launches that carried K17's step (``probe_flags`` with a cold lookup):
# each is counted in KERNELS["bloom_check"] too.
BLOOM_IN_PROBE = 0


def probe_flags(specs: Sequence[ProbeSpec], max_probe: int,
                bloom: Optional[torch.Tensor] = None,
                checked: Optional[torch.Tensor] = None, cold_bit: int = 0):
    """Kernel K1 with the flag word (its FLAGS variant): ``probe_many``'s
    list (with overflow flags), and an int32 0-dim view of the word the
    launch's memset zeroes, into which each lookup ORs its ``grow_bit`` on
    an overflow and, for a lookup marked ``cold``, ``cold_bit`` when a lane
    under its mask, below its count, not found and not certified by
    ``checked`` has a key that hits the filter ``bloom`` (K17's test, a
    step of this launch).  A launch with a cold lookup counts as one of
    K17's too."""
    global BLOOM_IN_PROBE
    cold = any(sp.cold for sp in specs)
    if cold:
        if bloom is None:
            raise ValueError("a cold lookup needs the filter")
        _check(bloom, torch.int32, bloom.numel(), "bloom")
    got, word = _probe_launch(specs, max_probe, True,
                              (bloom, checked, cold_bit))
    if cold:
        KERNELS["bloom_check"].launches += 1
        BLOOM_IN_PROBE += 1
    return got, word


def _probe_launch(specs, max_probe: int, overflow: bool, flags):
    """One K1 launch; ``flags`` (bloom, checked, cold_bit) or None."""
    lib = library()
    nd = len(specs)
    if not 0 < nd <= PROBE_MAX_LOOKUPS:
        raise ValueError(f"K1 takes 1 to {PROBE_MAX_LOOKUPS} lookups, got {nd}")
    first = specs[0].key_lo
    if first is None:
        raise ValueError("the first lookup's keys must be given")
    n = first.numel()
    dev = first.device
    chain = []
    outs = []
    for k, sp in enumerate(specs):
        cap = sp.tkey_lo.numel()
        _check(sp.tkey_lo, torch.int64, cap, "table key_lo")
        _check(sp.tkey_hi, torch.int64, cap, "table key_hi")
        _check(sp.tomb, torch.bool, cap, "table tombstone")
        if sp.keys_from is None:
            _check(sp.key_lo, torch.int64, n, "key_lo")
            if sp.key_hi is not None:
                _check(sp.key_hi, torch.int64, n, "key_hi")
            chain.append(k)
        else:
            j, lo_name, hi_name = sp.keys_from
            if not 0 <= j < k:
                raise ValueError(f"lookup {k}: keys from lookup {j}")
            chain.append(chain[j])
        if sp.mask is not None:
            _check(sp.mask, torch.bool, n, "mask")
        if sp.count_word is not None:
            _word(sp.count_word, "count word")
        src = [sp.table_cols[name] for name in sp.names]
        for name, s in zip(sp.names, src):
            if s.dtype not in _U64_OR_U32:
                raise TypeError(f"column {name}: unsupported dtype {s.dtype}")
            _check(s, s.dtype, cap, f"column {name}")
        if sp.out is None:
            found = torch.empty(n, dtype=torch.bool, device=dev)
            slot = torch.empty(n, dtype=torch.int64, device=dev)
            dst = [torch.empty(n, dtype=s.dtype, device=dev) for s in src]
        else:
            found, slot, dst = sp.out[0], sp.out[1], list(sp.out[2])
            _check(found, torch.bool, n, "found")
            _check(slot, torch.int64, n, "slot")
            if len(dst) != len(src):
                raise ValueError(f"lookup {k}: {len(dst)} outputs for "
                                 f"{len(src)} columns")
            for name, s, d in zip(sp.names, src, dst):
                _check(d, s.dtype, n, f"output {name}")
        outs.append((found, slot, src, dict(zip(sp.names, dst))))
    keys = []
    for k, sp in enumerate(specs):
        if sp.keys_from is None:
            keys.append((sp.key_lo, sp.key_hi))
        else:
            j, lo_name, hi_name = sp.keys_from
            got = outs[j][3]
            if lo_name not in got or (hi_name is not None and hi_name not in got):
                raise ValueError(f"lookup {k}: lookup {j} gathers no "
                                 f"{lo_name}/{hi_name}")
            lo, hi = got[lo_name], None if hi_name is None else got[hi_name]
            if lo.dtype != torch.int64 or (hi is not None
                                           and hi.dtype != torch.int64):
                raise TypeError(f"lookup {k}: keys must be u64 columns")
            keys.append((lo, hi))
    heads = sorted(set(chain))
    nxt = [-1] * nd
    for c in heads:
        members = [k for k in range(nd) if chain[k] == c]
        for a, b in zip(members, members[1:]):
            nxt[a] = b
    ncols = sum(len(sp.names) for sp in specs)
    if ncols > PROBE_MAX_COLS:
        raise ValueError(f"K1 gathers at most {PROBE_MAX_COLS} columns a "
                         f"launch, got {ncols}")
    src_all = [s for o in outs for s in o[2]]
    dst_all = [d for o in outs for d in o[3].values()]
    # With the flag word: 12 bytes, the overflow bytes then the word at 8,
    # zeroed by the entry point's one memset.
    buf = (torch.empty(16 if flags else nd, dtype=torch.uint8, device=dev)
           if overflow else None)
    ovf = None if buf is None else buf[:nd].view(torch.bool)
    word = buf[8:12].view(torch.int32)[0] if flags else None
    bloom = checked = None
    cold_bit = 0
    if flags:
        bloom, checked, cold_bit = flags
        if checked is not None:
            _check(checked, torch.bool, n, "checked")
    ints = lambda v: (ctypes.c_int * len(v))(*v)  # noqa: E731
    i64s = lambda v: (ctypes.c_int64 * len(v))(*v)  # noqa: E731
    ptrs = lambda v: (ctypes.c_void_p * len(v))(  # noqa: E731
        *[None if t is None else t.data_ptr() for t in v])
    err = lib.tb_probe(
        nd, len(heads), ints(heads), ints(nxt),
        ptrs([sp.tkey_lo for sp in specs]), ptrs([sp.tkey_hi for sp in specs]),
        ptrs([sp.tomb for sp in specs]),
        i64s([sp.tkey_lo.numel() for sp in specs]),
        ints([sp.hash_shift for sp in specs]), max_probe,
        ptrs([lo for lo, _hi in keys]), ptrs([hi for _lo, hi in keys]), n,
        i64s([n if sp.count is None else sp.count for sp in specs]),
        ptrs([sp.count_word for sp in specs]), ptrs([sp.mask for sp in specs]),
        ptrs([o[0] for o in outs]), ptrs([o[1] for o in outs]),
        None if ovf is None else ovf.data_ptr(),
        ints([len(sp.names) for sp in specs]), _ptr_array(src_all),
        _ptr_array(dst_all), ints([_width(s) for s in src_all] or [0]),
        None if word is None else word.data_ptr(),
        ints([sp.grow_bit for sp in specs]),
        ints([int(bool(sp.cold)) for sp in specs]),
        None if bloom is None else bloom.data_ptr(),
        0 if bloom is None else bloom.numel() * 32,
        None if checked is None else checked.data_ptr(), cold_bit,
        _stream(first),
    )
    _raise_on(err, "probe")
    KERNELS["probe"].launches += 1
    return [(o[0], o[1], None if ovf is None else ovf[k], o[3])
            for k, o in enumerate(outs)], word


def probe(tkey_lo, tkey_hi, tomb, table_cols: Dict[str, torch.Tensor],
          key_lo, key_hi, max_probe: int, hash_shift: int, count: int,
          names: Sequence[str], mask: Optional[torch.Tensor] = None, *,
          count_word: Optional[torch.Tensor] = None,
          out: Optional[Tuple[torch.Tensor, torch.Tensor,
                              Sequence[torch.Tensor]]] = None,
          ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
                     Dict[str, torch.Tensor]]:
    """Kernel K1 on one lookup: (found, slot, overflow, gathered columns);
    ``found`` is masked to lanes below ``count`` (read from the u64 device
    word ``count_word`` when given) and to ``mask`` when given.  ``out``, a
    (found, slot, columns) triple, takes the outputs in place; no overflow
    flag is made then (None: the fast path reads the table's flag)."""
    return probe_many([ProbeSpec(tkey_lo, tkey_hi, tomb, table_cols, key_lo,
                                 key_hi, names, count, mask, hash_shift,
                                 count_word, out)],
                      max_probe, overflow=out is None)[0]


def probe_info() -> Dict[str, int]:
    """What the compiler and the card make of K1's kernel: registers and
    local memory a thread, threads a block, blocks resident on one SM and
    the launch's argument bytes; then the flag word's variant's registers,
    local memory and resident blocks.  Launches nothing."""
    out = (ctypes.c_int * 8)()
    _raise_on(library().tb_probe_info(out), "probe")
    return dict(zip(("registers", "local_bytes", "threads", "blocks_per_sm",
                     "arg_bytes", "flags_registers", "flags_local_bytes",
                     "flags_blocks_per_sm"), out))


# -- K2 insert -------------------------------------------------------------

# K2's split form (csrc/insert.cu: a pre-pass, a one-block resolver, the
# writes) takes a batch of at most INSERT_SPLIT_MAX_N lanes into a table of
# at most INSERT_SPLIT_MAX_SLOTS slots, with a window of INSERT_WINDOW slots
# a lane; anything larger (``grow``, the cold tier's rebuild) takes its
# round form (round 0 over every lane, then rounds over a list of the lanes
# left, the last INSERT_TAIL_MAX of them on one block), which needs a u64
# word a slot (the round and lane of its winner) and two walker lists of n
# (lane, home) pairs.  Its lanes are int32: at most INSERT_ROUNDS_MAX_N.
INSERT_WINDOW = 32
INSERT_SPLIT_MAX_N = 8192
INSERT_SPLIT_MAX_SLOTS = 1 << 31
INSERT_TAIL_MAX = 2048
INSERT_ROUNDS_MAX_N = (1 << 31) - 1

# Calls of K2's round form (insert and claim entries together); the launch
# counts of ``insert`` and ``claim`` cover both forms.
ROUND_FORM_CALLS = 0


def insert_split(n: int, cap: int) -> bool:
    """Whether K2 runs its split form for ``n`` lanes into ``cap`` slots."""
    return n <= INSERT_SPLIT_MAX_N and cap <= INSERT_SPLIT_MAX_SLOTS


def insert_scratch(n: int, cap: int, device) -> Tuple[torch.Tensor, ...]:
    """K2's scratch for ``n`` lanes into ``cap`` slots, for the insert and
    claim entries: (claimed int64[n], the pre-pass's homes and windows
    int32[2n]) for the split form; (claimed, the slot words int64[cap], the
    two walker lists int64[2n] of (lane, home) int32 pairs, their lengths
    int32[2]) for the round form, which raises above INSERT_ROUNDS_MAX_N
    lanes."""
    split = insert_split(n, cap)
    if not split and (n > INSERT_ROUNDS_MAX_N or cap > INSERT_SPLIT_MAX_SLOTS):
        raise CudaKernelError(
            f"K2's round form takes at most {INSERT_ROUNDS_MAX_N} lanes into "
            f"{INSERT_SPLIT_MAX_SLOTS} slots, got {n} lanes into {cap}")
    claimed = torch.empty(n, dtype=torch.int64, device=device)
    if split:
        return claimed, torch.empty(2 * n, dtype=torch.int32, device=device)
    return (claimed, torch.empty(cap, dtype=torch.int64, device=device),
            torch.empty(2 * n, dtype=torch.int64, device=device),
            torch.empty(2, dtype=torch.int32, device=device))


def _insert_scratch_ptrs(scratch, n: int, cap: int):
    """Checks ``scratch`` (from ``insert_scratch``) and returns (claimed,
    pointers of pre, word, lists, cnt: None where the route has none).
    The round form's slot words and lengths are set in its C entry."""
    claimed = scratch[0]
    _check(claimed, torch.int64, n, "claimed")
    if insert_split(n, cap):
        if len(scratch) != 2:
            raise ValueError("K2's split form takes (claimed, pre) scratch")
        _check(scratch[1], torch.int32, 2 * n, "pre")
        return claimed, (scratch[1].data_ptr(), None, None, None)
    if len(scratch) != 4:
        raise ValueError("K2's round form takes (claimed, word, lists, cnt) "
                         "scratch")
    _, claim, lists, cnt = scratch
    _check(claim, torch.int64, cap, "word")
    _check(lists, torch.int64, 2 * n, "lists")
    _check(cnt, torch.int32, 2, "cnt")
    return claimed, (None, claim.data_ptr(), lists.data_ptr(),
                     cnt.data_ptr())


def _count_round_form(pre) -> None:
    global ROUND_FORM_CALLS
    if pre is None:
        ROUND_FORM_CALLS += 1


def insert_rounds_info(n: int) -> Dict[str, int]:
    """The launch K2's round form takes for ``n`` lanes (its cooperative
    rounds kernel): registers and local memory a thread, threads a block,
    blocks resident on one SM, blocks launched, and the walkers the
    one-block tail takes.  Launches nothing."""
    out = (ctypes.c_int * 6)()
    _raise_on(library().tb_insert_rounds_info(n, out), "insert")
    return dict(zip(("registers", "local_bytes", "threads", "blocks_per_sm",
                     "blocks", "tail_max"), out))


def insert(tkey_lo, tkey_hi, tomb, table_cols: Dict[str, torch.Tensor],
           count: torch.Tensor, probe_overflow: torch.Tensor,
           key_lo, key_hi, insert_mask, rows: Dict[str, torch.Tensor],
           max_probe: int, hash_shift: int,
           scratch: Optional[Tuple[torch.Tensor, ...]] = None,
           fill: bool = False) -> torch.Tensor:
    """Kernel K2: inserts in place; returns the claimed slots (C where
    unplaced).  A batch of at most INSERT_SPLIT_MAX_N lanes runs the split
    form (the pre-pass, the one-block resolver over home groups, the row
    writes: no scratch the size of the table); a larger one (``grow``) the
    round form.  ``scratch`` (``insert_scratch``), preallocated, serves a
    captured graph.  ``fill`` (the round form only): the table is fresh,
    none of its arrays written yet (``make_table(..., zeroed=False)``); the
    claim reads none of it, and every slot is written, a lane's row or
    zeros."""
    lib = library()
    cap = tkey_lo.numel()
    n = key_lo.numel()
    _check(tkey_lo, torch.int64, cap, "table key_lo")
    _check(tkey_hi, torch.int64, cap, "table key_hi")
    _check(tomb, torch.bool, cap, "table tombstone")
    _check(count, torch.int64, 1, "table count")
    _check(probe_overflow, torch.bool, 1, "table probe_overflow")
    _check(key_lo, torch.int64, n, "key_lo")
    _check(key_hi, torch.int64, n, "key_hi")
    _check(insert_mask, torch.bool, n, "insert_mask")
    names = list(table_cols)
    src, dst = [], []
    for name in names:
        d = table_cols[name]
        s = rows[name]
        if d.dtype not in _U64_OR_U32:
            raise TypeError(f"column {name}: unsupported dtype {d.dtype}")
        _check(d, d.dtype, cap, f"column {name}")
        _check(s, d.dtype, n, f"row {name}")
        src.append(s)
        dst.append(d)
    if fill and insert_split(n, cap):
        raise ValueError(f"K2 writes a fresh table whole only in its round "
                         f"form (more than {INSERT_SPLIT_MAX_N} lanes), "
                         f"got {n}")
    if scratch is None:
        scratch = insert_scratch(n, cap, key_lo.device)
    claimed, (pre, claim, lists, cnt) = _insert_scratch_ptrs(scratch, n, cap)
    widths = (ctypes.c_int * max(1, len(src)))(*[_width(s) for s in src])
    err = lib.tb_insert(
        tkey_lo.data_ptr(), tkey_hi.data_ptr(), tomb.data_ptr(), cap,
        hash_shift, max_probe, key_lo.data_ptr(), key_hi.data_ptr(),
        insert_mask.data_ptr(), n, claimed.data_ptr(), pre, claim, lists,
        cnt, count.data_ptr(), probe_overflow.data_ptr(), len(src),
        _ptr_array(src), _ptr_array(dst), widths, int(fill), _stream(key_lo),
    )
    _raise_on(err, "insert")
    KERNELS["insert"].launches += 1
    _count_round_form(pre)
    return claimed


# -- K3 validate -----------------------------------------------------------


def hash_size(n: int) -> int:
    """Batch-local hash table size for ``n`` lanes (K3, K11; K9 takes twice
    it)."""
    h = 2
    while h < 2 * n:
        h *= 2
    return h


def validate(variant: str, columns: Sequence[torch.Tensor], count: int,
             batch_timestamp: int = 0, *,
             count_word: Optional[torch.Tensor] = None,
             ts_word: Optional[torch.Tensor] = None,
             out: Optional[Tuple[torch.Tensor, ...]] = None,
             blocks: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K3 (``variant`` "accounts" or "transfers"): (codes int32[N],
    ok bool[N]).  ``columns`` follow the order of the kernel's column enum
    (state_machine's ``*_COLS`` tuples).  For transfers, ``count_word`` and
    ``ts_word`` (u64 device words, given together) replace ``count`` and
    ``batch_timestamp``; ``out``, preallocated (codes, ok, scratch
    int32[2 * hash_size(n) + 3 * n]), serves a captured graph.  ``blocks``
    sets the cooperative launch's blocks (0: one a 128 lanes, at most what
    the card holds at once; more than that raises)."""
    lib = library()
    n = columns[0].numel()
    for k, c in enumerate(columns):
        if c.dtype not in _U64_OR_U32:
            raise TypeError(f"validate column {k}: unsupported dtype {c.dtype}")
        _check(c, c.dtype, n, f"validate column {k}")
    if (count_word is None) != (ts_word is None) or (
            count_word is not None and variant != "transfers"):
        raise ValueError("count_word and ts_word go together, on transfers")
    if count_word is not None:
        _word(count_word, "count word")
        _word(ts_word, "timestamp word")
    dev = columns[0].device
    hsize = hash_size(n)
    if out is None:
        codes = torch.empty(n, dtype=torch.int32, device=dev)
        ok = torch.empty(n, dtype=torch.bool, device=dev)
        scratch = torch.empty(2 * hsize + 3 * n, dtype=torch.int32,
                              device=dev)
    else:
        codes, ok, scratch = out
        _check(codes, torch.int32, n, "codes")
        _check(ok, torch.bool, n, "ok")
        _check(scratch, torch.int32, 2 * hsize + 3 * n, "validate scratch")
    ptrs = _ptr_array(columns)
    stream = _stream(columns[0])
    if variant == "accounts":
        err = lib.tb_validate_accounts(
            len(columns), ptrs, n, count, codes.data_ptr(), ok.data_ptr(),
            scratch.data_ptr(), hsize, blocks, stream,
        )
    elif variant == "transfers":
        err = lib.tb_validate_transfers(
            len(columns), ptrs, n, count, batch_timestamp & ((1 << 64) - 1),
            None if count_word is None else count_word.data_ptr(),
            None if ts_word is None else ts_word.data_ptr(),
            codes.data_ptr(), ok.data_ptr(), scratch.data_ptr(), hsize,
            blocks, stream,
        )
    else:
        raise ValueError(f"unknown validate variant {variant!r}")
    _raise_on(err, "validate")
    KERNELS["validate"].launches += 1
    return codes, ok


# -- K4 balance ------------------------------------------------------------


def balance(dr_slot, cr_slot, ok, amount_lo, pending,
            balance_cols: Sequence[torch.Tensor], slot_base: int = 0) -> None:
    """Kernel K4: adds every accepted transfer's amount to its debit and
    credit accounts' balance columns, in place, in one launch with no
    scratch (one 64-bit atomic a leg on the lo word, the wraps carried into
    the hi word).  ``balance_cols`` are the eight u64 columns
    debits_pending lo/hi, debits_posted lo/hi, credits_pending lo/hi,
    credits_posted lo/hi.  ``slot_base`` (one shard of a sharded ledger):
    the slots are global, and only the legs in [slot_base, slot_base + C)
    apply, at slot - slot_base."""
    lib = library()
    n = ok.numel()
    _check(dr_slot, torch.int64, n, "dr_slot")
    _check(cr_slot, torch.int64, n, "cr_slot")
    _check(ok, torch.bool, n, "ok")
    _check(amount_lo, torch.int64, n, "amount_lo")
    _check(pending, torch.bool, n, "pending")
    if len(balance_cols) != 8:
        raise ValueError("balance needs the eight balance columns")
    cap = balance_cols[0].numel()
    for c in balance_cols:
        _check(c, torch.int64, cap, "balance column")
    err = lib.tb_balance(
        dr_slot.data_ptr(), cr_slot.data_ptr(), ok.data_ptr(),
        amount_lo.data_ptr(), pending.data_ptr(), n, slot_base, cap,
        _ptr_array(balance_cols), _stream(ok),
    )
    _raise_on(err, "balance")
    KERNELS["balance"].launches += 1


# -- K5 digest -------------------------------------------------------------


def digest(key_lo, key_hi, cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Kernel K5: the wrapping u64 digest sum, as a 0-dim int64 tensor.
    ``cols`` are the eight balance columns in ledger order, then
    ``timestamp``."""
    lib = library()
    cap = key_lo.numel()
    _check(key_lo, torch.int64, cap, "key_lo")
    _check(key_hi, torch.int64, cap, "key_hi")
    if len(cols) != 9:
        raise ValueError("digest needs eight balance columns and timestamp")
    for c in cols:
        _check(c, torch.int64, cap, "digest column")
    out = torch.zeros(1, dtype=torch.int64, device=key_lo.device)
    err = lib.tb_digest(
        key_lo.data_ptr(), key_hi.data_ptr(), _ptr_array(cols), cap,
        out.data_ptr(), _stream(key_lo),
    )
    _raise_on(err, "digest")
    KERNELS["digest"].launches += 1
    return out[0]


# -- K6/K7 sequential commit -----------------------------------------------

# u64 words of one event's undo record in K6 (csrc/sequential.cu UNDO_WORDS).
_UNDO_WORDS = 23
# u64 words of one event's record from K32 (csrc/sequential.cu REC_WORDS).
SEQ_REC_WORDS = 64
# The widest batch K6's sequencer takes and its largest transfers and
# posted tables (csrc/sequential.cu SEQ_MAX_N, SEQ_MAX_SLOTS).
SEQ_MAX_N = 8192
SEQ_MAX_SLOTS = 1 << 30


def _check_cols(cols: Sequence[torch.Tensor], dtypes: Sequence[torch.dtype],
                n: int, what: str) -> None:
    if len(cols) != len(dtypes):
        raise ValueError(f"{what}: {len(cols)} columns, expected {len(dtypes)}")
    for k, (c, dt) in enumerate(zip(cols, dtypes)):
        _check(c, dt, n, f"{what} column {k}")


def _check_table(t: Sequence[torch.Tensor], dtypes: Sequence[torch.dtype],
                 what: str) -> int:
    """``t``: key_lo, key_hi, tombstone, count, then the value columns.
    Returns the capacity."""
    cap = t[0].numel()
    if cap <= 0 or cap & (cap - 1):
        raise ValueError(f"{what}: capacity {cap} is not a power of two")
    _check_cols(t[:3], (torch.int64, torch.int64, torch.bool), cap,
                f"{what} keys")
    _check(t[3], torch.int64, 1, f"{what} count")
    _check_cols(t[4:], dtypes, cap, what)
    return cap


def _seq_hash_sizes(n: int) -> Tuple[int, int, int]:
    """Entries of K32's three join hashes (ids, account slots, posted keys):
    powers of two of at least 2n, 4n and 2n."""
    def p2(x):
        return 1 << max(6, (x - 1).bit_length())
    return p2(2 * n), p2(4 * n), p2(2 * n)


def seq_prepass(batch: Sequence[torch.Tensor], batch_dtypes,
                accounts: Sequence[torch.Tensor], account_dtypes,
                transfers: Sequence[torch.Tensor], transfer_dtypes,
                posted: Sequence[torch.Tensor], count: int,
                timestamp: int) -> Dict[str, torch.Tensor]:
    """Kernel K32 (three launches): every event's probes against the tables
    as they are before the batch, and the batch's joins with itself.
    Returns ``rec`` int64[n, SEQ_REC_WORDS] (csrc/sequential.cu
    SeqRecField), ``bal`` int64[2n, 8] (each dense account's balances, at
    its lowest leg) and ``dslot`` int64[2n] (a dense index's account slot,
    -1 where none)."""
    lib = library()
    n = batch[0].numel()
    _check_cols(batch, batch_dtypes, n, "batch")
    acc_cap = _check_table(accounts, account_dtypes, "accounts")
    xfr_cap = _check_table(transfers, transfer_dtypes, "transfers")
    pst_cap = _check_table(posted, (torch.int32,), "posted")
    if not 0 <= count <= n:
        raise ValueError(f"count {count} outside 0..{n}")
    dev = batch[0].device
    rec = torch.empty((n, SEQ_REC_WORDS), dtype=torch.int64, device=dev)
    bal = torch.empty((2 * n, 8), dtype=torch.int64, device=dev)
    dslot = torch.empty(2 * n, dtype=torch.int64, device=dev)
    h_id, h_acc, h_pst = _seq_hash_sizes(n)
    hash_ = torch.empty(2 * (h_id + h_acc + h_pst), dtype=torch.int64,
                        device=dev)
    err = lib.tb_seq_prepass(
        _ptr_array(batch), len(batch), _ptr_array(accounts), len(accounts),
        acc_cap, _ptr_array(transfers), len(transfers), xfr_cap,
        _ptr_array(posted), len(posted), pst_cap, n, count,
        timestamp & ((1 << 64) - 1), rec.data_ptr(), bal.data_ptr(),
        dslot.data_ptr(), hash_.data_ptr(), h_id, h_acc, h_pst,
        _stream(batch[0]),
    )
    _raise_on(err, "seq_prepass")
    KERNELS["seq_prepass"].launches += 1
    return {"rec": rec, "bal": bal, "dslot": dslot}


def seq_transfers(batch: Sequence[torch.Tensor], batch_dtypes,
                  accounts: Sequence[torch.Tensor], account_dtypes,
                  transfers: Sequence[torch.Tensor], transfer_dtypes,
                  posted: Sequence[torch.Tensor],
                  history: Sequence[torch.Tensor],
                  count: int, timestamp: int,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K6: one sequential create_transfers batch, the ledger updated
    in place: K32, then the sequencer.  Each table is key_lo, key_hi,
    tombstone, count and its columns in the kernel's enum order;
    ``history`` is its 21 columns then its count.  Raises CudaKernelError
    for a batch wider than SEQ_MAX_N lanes or a transfers or posted table
    of more than SEQ_MAX_SLOTS slots, which the sequencer's overlay cannot
    hold.  Returns (codes int32[N], overflow bool 0-dim)."""
    lib = library()
    n = batch[0].numel()
    _check_cols(batch, batch_dtypes, n, "batch")
    acc_cap = _check_table(accounts, account_dtypes, "accounts")
    xfr_cap = _check_table(transfers, transfer_dtypes, "transfers")
    pst_cap = _check_table(posted, (torch.int32,), "posted")
    hist_cap = history[0].numel()
    _check_cols(history[:-1], [torch.int64] * (len(history) - 1), hist_cap,
                "history")
    _check(history[-1], torch.int64, 1, "history count")
    if not 0 <= count <= n:
        raise ValueError(f"count {count} outside 0..{n}")
    if n > SEQ_MAX_N or max(xfr_cap, pst_cap) > SEQ_MAX_SLOTS:
        raise CudaKernelError(
            f"seq_transfers: {n} lanes and tables of {xfr_cap} and {pst_cap} "
            f"slots; the sequencer takes at most {SEQ_MAX_N} lanes and "
            f"{SEQ_MAX_SLOTS} slots")
    pre = seq_prepass(batch, batch_dtypes, accounts, account_dtypes,
                      transfers, transfer_dtypes, posted, count, timestamp)
    dev = batch[0].device
    undo = torch.empty(n * _UNDO_WORDS, dtype=torch.int64, device=dev)
    codes = torch.empty(n, dtype=torch.int32, device=dev)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    err = lib.tb_seq_transfers(
        _ptr_array(batch), len(batch), _ptr_array(accounts), len(accounts),
        acc_cap, _ptr_array(transfers), len(transfers), xfr_cap,
        _ptr_array(posted), len(posted), pst_cap, _ptr_array(history),
        len(history), hist_cap, n, count, timestamp & ((1 << 64) - 1),
        pre["rec"].data_ptr(), pre["bal"].data_ptr(), pre["dslot"].data_ptr(),
        undo.data_ptr(), codes.data_ptr(), overflow.data_ptr(),
        _stream(batch[0]),
    )
    _raise_on(err, "seq_transfers")
    KERNELS["seq_transfers"].launches += 1
    return codes, overflow[0] != 0


def seq_accounts(batch: Sequence[torch.Tensor], batch_dtypes,
                 accounts: Sequence[torch.Tensor], account_dtypes,
                 count: int, timestamp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K7: one sequential create_accounts batch, the accounts table
    updated in place: a memset of its scratch, the pre-pass (two launches),
    the sequencer and the finish.  Returns (codes int32[N], overflow bool
    0-dim, a view of the scratch's overflow byte)."""
    lib = library()
    n = batch[0].numel()
    _check_cols(batch, batch_dtypes, n, "batch")
    acc_cap = _check_table(accounts, account_dtypes, "accounts")
    if not 0 <= count <= n:
        raise ValueError(f"count {count} outside 0..{n}")
    dev = batch[0].device
    size = (ctypes.c_int64 * 2)()
    _raise_on(lib.tb_seq_accounts_scratch(n, size), "seq_accounts")
    scratch = torch.empty(size[0], dtype=torch.uint8, device=dev)
    codes = torch.empty(n, dtype=torch.int32, device=dev)
    err = lib.tb_seq_accounts(
        _ptr_array(batch), len(batch), _ptr_array(accounts), len(accounts),
        acc_cap, n, count, timestamp & ((1 << 64) - 1), scratch.data_ptr(),
        codes.data_ptr(), _stream(batch[0]),
    )
    _raise_on(err, "seq_accounts")
    KERNELS["seq_accounts"].launches += 1
    return codes, scratch[size[1]:size[1] + 1].view(torch.bool)[0]


def seq_accounts_info(n: int) -> Dict[str, Dict[str, int]]:
    """What the compiler and the card make of K7's four kernels for ``n``
    events: registers, local memory and static shared bytes a thread or
    block, threads a block; and the sequencer's dynamic shared bytes (its
    records, mask and overlay when the marked events fit, as the kernel
    decides).  Launches nothing."""
    out = (ctypes.c_int * 21)()
    _raise_on(library().tb_seq_accounts_info(n, out), "seq_accounts")
    keys = ("registers", "local_bytes", "threads", "static_shared",
            "max_threads")
    info = {name: dict(zip(keys, out[5 * k:5 * k + 5]))
            for k, name in enumerate(("probe", "mark", "sequencer", "finish"))}
    info["sequencer"]["dynamic_shared"] = out[20]
    return info


# -- K8 tombstone ------------------------------------------------------------


def tombstone(key_lo, key_hi, tomb, count, slot, valid) -> None:
    """Kernel K8: clear the keys at ``slot`` where ``valid``, leaving
    tombstones, and subtract the valid lanes from ``count``, in place."""
    lib = library()
    cap = key_lo.numel()
    n = slot.numel()
    _check(key_lo, torch.int64, cap, "table key_lo")
    _check(key_hi, torch.int64, cap, "table key_hi")
    _check(tomb, torch.bool, cap, "table tombstone")
    _check(count, torch.int64, 1, "table count")
    _check(slot, torch.int64, n, "slot")
    _check(valid, torch.bool, n, "valid")
    err = lib.tb_tombstone(
        key_lo.data_ptr(), key_hi.data_ptr(), tomb.data_ptr(), cap,
        slot.data_ptr(), valid.data_ptr(), n, count.data_ptr(), _stream(slot),
    )
    _raise_on(err, "tombstone")
    KERNELS["tombstone"].launches += 1


# -- K2 claim / write entries (the general kernel's apply) -------------------


def claim(tkey_lo, tkey_hi, tomb, key_lo, key_hi, insert_mask, max_probe: int,
          hash_shift: int = 0, flag_word: Optional[torch.Tensor] = None,
          flag_bit: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's claim entry: the insert slot of every masked key (C where
    unplaced), by the insert's placement (its split form, or its round
    form above INSERT_SPLIT_MAX_N lanes), leaving each claimed slot
    holding its key as a mark until ``write_claimed``; on probe overflow
    ``flag_bit`` is ORed into ``flag_word`` (int32[1], a new zero word when
    None).  Returns (claimed, flag_word)."""
    lib = library()
    cap = tkey_lo.numel()
    n = key_lo.numel()
    _check(tkey_lo, torch.int64, cap, "table key_lo")
    _check(tkey_hi, torch.int64, cap, "table key_hi")
    _check(tomb, torch.bool, cap, "table tombstone")
    _check(key_lo, torch.int64, n, "key_lo")
    _check(key_hi, torch.int64, n, "key_hi")
    _check(insert_mask, torch.bool, n, "insert_mask")
    dev = key_lo.device
    if flag_word is None:
        flag_word = torch.zeros(1, dtype=torch.int32, device=dev)
    _check(flag_word, torch.int32, 1, "flag_word")
    scratch = insert_scratch(n, cap, dev)  # held until the launch is queued
    claimed, (pre, claim, lists, cnt) = _insert_scratch_ptrs(scratch, n, cap)
    err = lib.tb_claim(
        tkey_lo.data_ptr(), tkey_hi.data_ptr(), tomb.data_ptr(), cap,
        hash_shift, max_probe, key_lo.data_ptr(), key_hi.data_ptr(),
        insert_mask.data_ptr(), n, claimed.data_ptr(), pre, claim, lists,
        cnt, flag_word.data_ptr(), flag_bit, _stream(key_lo),
    )
    _raise_on(err, "claim")
    KERNELS["claim"].launches += 1
    _count_round_form(pre)
    return claimed, flag_word


def write_claimed(tkey_lo, tkey_hi, tomb, table_cols: Dict[str, torch.Tensor],
                  count, key_lo, key_hi, claimed, write_mask,
                  rows: Dict[str, torch.Tensor],
                  gate: Optional[torch.Tensor] = None,
                  revert: bool = False) -> None:
    """K2's write entry: at each claimed slot, the row (keys, tombstone
    cleared, the columns named in ``rows``, the count) where ``gate``
    (int32[1]) is None or 0 and the lane is in ``write_mask``; otherwise,
    with ``revert``, the claim's mark cleared back to key 0."""
    lib = library()
    cap = tkey_lo.numel()
    n = key_lo.numel()
    _check(tkey_lo, torch.int64, cap, "table key_lo")
    _check(tkey_hi, torch.int64, cap, "table key_hi")
    _check(tomb, torch.bool, cap, "table tombstone")
    _check(count, torch.int64, 1, "table count")
    _check(key_lo, torch.int64, n, "key_lo")
    _check(key_hi, torch.int64, n, "key_hi")
    _check(claimed, torch.int64, n, "claimed")
    _check(write_mask, torch.bool, n, "write_mask")
    if gate is not None:
        _check(gate, torch.int32, 1, "gate")
    src, dst = [], []
    for name, s in rows.items():
        d = table_cols[name]
        _check(d, d.dtype, cap, f"column {name}")
        _check(s, d.dtype, n, f"row {name}")
        src.append(s)
        dst.append(d)
    widths = (ctypes.c_int * max(1, len(src)))(*[_width(s) for s in src])
    err = lib.tb_write_claimed(
        tkey_lo.data_ptr(), tkey_hi.data_ptr(), tomb.data_ptr(), cap,
        key_lo.data_ptr(), key_hi.data_ptr(), claimed.data_ptr(),
        write_mask.data_ptr(), n, None if gate is None else gate.data_ptr(),
        int(revert), count.data_ptr(), len(src), _ptr_array(src),
        _ptr_array(dst), widths, _stream(key_lo),
    )
    _raise_on(err, "write_claimed")
    KERNELS["write_claimed"].launches += 1


# -- K9-K12: the general transfer kernel ---------------------------------------

# Pointer layouts of csrc/full_pass.cu (FullPtr, prefix F_) and
# csrc/full_legs.cu (LegPtr, prefix L_): (name, count) in order.
FULL_PASS_LAYOUT = (
    ("batch", 19), ("ex_found", 1), ("e_tab", 17), ("p_tab_found", 1),
    ("p_tab", 17), ("drt", 12), ("crt", 12), ("pdr", 12), ("pcr", 12),
    ("posted_found", 1), ("posted_val", 1),
    ("group", 1), ("any_dup", 1), ("pj_hit", 1), ("pj_group", 1),
    ("ctrl", 1), ("proved", 1), ("needed", 1),
    ("valid", 1), ("pending", 1), ("post", 1), ("postvoid", 1), ("linked", 1),
    ("ok_c", 1), ("code_c", 1), ("amt_c_lo", 1), ("amt_c_hi", 1),
    ("hazard", 1), ("unsched", 1), ("wdr_slot", 1), ("wdr_live", 1),
    ("wcr_slot", 1), ("wcr_live", 1),
    ("winner", 1), ("ref", 1), ("leg_start", 8), ("dr_slot", 1),
    ("cr_slot", 1), ("dr_live", 1), ("cr_live", 1), ("pamt", 1),
    ("flags_dr", 1), ("flags_cr", 1),
    ("leg_pos", 1), ("leg_val", 16), ("s_slot", 1), ("s_live", 1),
    ("is_last", 1), ("arith", 1),
    ("row", 17), ("code_t", 1), ("pre_chain", 1), ("near_ov", 1), ("fkey", 1),
    ("fhash", 1), ("chain", 1),
    ("codes", 1), ("ok", 1), ("pv_ok", 1), ("posted_key", 1), ("do_hist", 1),
    ("hist", 21), ("route", 1), ("passes", 1), ("wave_bound", 1),
    ("cache_ok", 1), ("grid", 1),
)
LEGS_LAYOUT = (
    ("start", 8), ("ok", 1), ("amt", 1), ("pamt", 1), ("dr_slot", 1),
    ("cr_slot", 1), ("dr_live", 1), ("cr_live", 1), ("pending", 1),
    ("post", 1), ("postvoid", 1), ("leg_pos", 1), ("val", 16), ("s_slot", 1),
    ("s_live", 1), ("is_last", 1), ("arith", 1), ("scratch", 1), ("stats", 1),
    ("ctrl", 1), ("proved", 1), ("needed", 1),
    ("cache_keys", 1), ("cache_slot", 1), ("cache_ok", 1),
)
FULL_MAX_LANES = 8192  # csrc/full_common.cuh: 16,384 legs, leg keys < 2^15
# csrc/full_legs.cu: K10's block (a sorted leg a thread), its most blocks
# (the per-block aggregates and stale flags in its scratch), the words of an
# aggregate, and the chunk its stale sort gives a block.
LEG_THREADS = 128
LEG_MAX_BLOCKS = 128
LEG_AGG_WORDS = 13
LEG_CHUNK = 1024
# csrc/full_pass.cu PASS_MAX_BLOCKS and csrc/full_waves.cu WAVE_MAX_BLOCKS:
# the per-block partials of a K11 and a K12 launch.
PASS_MAX_BLOCKS = 128
WAVE_MAX_BLOCKS = 16
# Modes of one full_pass launch (csrc/full_pass.cu Mode).
PASS_INIT, PASS_PRE, PASS_POST = 0, 1, 2


def layout_array(layout, tensors: Dict[str, Sequence[torch.Tensor]]):
    """The ctypes pointer array of ``layout`` from named tensor lists (a
    None entry passes a null pointer)."""
    ptrs = []
    for name, count in layout:
        group = tensors[name]
        if len(group) != count:
            raise ValueError(f"{name}: {len(group)} tensors, expected {count}")
        for t in group:
            if t is not None and not (t.is_cuda and t.is_contiguous()):
                raise ValueError(f"{name}: a contiguous CUDA tensor is needed")
            ptrs.append(None if t is None else t.data_ptr())
    return (ctypes.c_void_p * len(ptrs))(*ptrs), len(ptrs)


def _check_lanes(n: int) -> None:
    if not 0 < n <= FULL_MAX_LANES:
        raise ValueError(f"the general kernel takes 1..{FULL_MAX_LANES} lanes, "
                         f"got {n}")


def full_index(id_lo, id_hi, pend_lo, pend_hi):
    """Kernel K9: (group_of_lane int64[N] (the lowest lane of each id),
    any_dup bool 0-dim, pj_hit bool[N], pj_group int64[N]).  One
    cooperative launch of a thread a lane; a refused launch raises."""
    lib = library()
    n = id_lo.numel()
    _check_lanes(n)
    for t, what in ((id_lo, "id_lo"), (id_hi, "id_hi"), (pend_lo, "pend_lo"),
                    (pend_hi, "pend_hi")):
        _check(t, torch.int64, n, what)
    dev = id_lo.device
    slots = full_index_slots(n)
    scratch = torch.empty(3 * slots, dtype=torch.int32, device=dev)
    group = torch.empty(n, dtype=torch.int64, device=dev)
    any_dup = torch.empty(1, dtype=torch.bool, device=dev)
    pj_hit = torch.empty(n, dtype=torch.bool, device=dev)
    pj_group = torch.empty(n, dtype=torch.int64, device=dev)
    err = lib.tb_full_index(
        id_lo.data_ptr(), id_hi.data_ptr(), pend_lo.data_ptr(),
        pend_hi.data_ptr(), n, scratch.data_ptr(), slots, group.data_ptr(),
        any_dup.data_ptr(), pj_hit.data_ptr(), pj_group.data_ptr(),
        _stream(id_lo),
    )
    _raise_on(err, "full_index")
    KERNELS["full_index"].launches += 1
    return group, any_dup[0], pj_hit, pj_group


def full_index_slots(n: int) -> int:
    """K9's table for ``n`` lanes: a power of two of at least 4n slots (a
    load of 1/4 keeps the probe chains, which every block waits on, short)."""
    return 2 * hash_size(n)


def full_index_info(n: int) -> Dict[str, int]:
    """What the compiler and the card make of K9's launch for ``n`` lanes:
    registers and local memory a thread, threads a block, blocks and
    blocks resident on one SM.  Launches nothing."""
    _check_lanes(n)
    out = (ctypes.c_int * 5)()
    _raise_on(library().tb_full_index_info(n, out), "full_index")
    return dict(zip(("registers", "local_bytes", "threads", "blocks",
                     "blocks_per_sm"), out))


def legs_pad(n: int) -> int:
    """The legs of ``n`` lanes rounded up to a power of two (at least 2):
    the sort cache's keys and K10's stale sort."""
    return 1 << max(1, (2 * n - 1).bit_length())


def legs_scratch_words(n: int) -> int:
    """K10's scratch (int64 words, csrc/full_legs.cu LegScratch): the
    per-block aggregates and stale flags, the sorted chunks, and the sorted
    keys when there is no cache."""
    return LEG_MAX_BLOCKS * (LEG_AGG_WORDS + 1) + 2 * legs_pad(n)


def legs_buffers(n: int, dev) -> Dict[str, torch.Tensor]:
    """K10's outputs and scratch for ``n`` lanes."""
    n2 = 2 * n
    out = {"leg_pos": torch.empty(n2, dtype=torch.int64, device=dev),
           "s_slot": torch.empty(n2, dtype=torch.int64, device=dev),
           "s_live": torch.empty(n2, dtype=torch.bool, device=dev),
           "is_last": torch.empty(n2, dtype=torch.bool, device=dev),
           "arith": torch.empty(1, dtype=torch.bool, device=dev),
           "scratch": torch.empty(legs_scratch_words(n), dtype=torch.int64,
                                  device=dev)}
    vals = torch.empty((16, n2), dtype=torch.int64, device=dev)
    out["val"] = list(vals.unbind(0))
    return out


# K10's stats pair a device: (launches that ran, launches that sorted because
# the sort cache was stale), counted on the card by the general core's K10
# launches (``transfer_full._kernel_core_cuda``) while ``LEGS_STATS_ON`` is
# set; otherwise the core hands K10 no pair and it counts nothing.
LEGS_STATS_ON = False
_LEGS_STATS: Dict[torch.device, torch.Tensor] = {}


def legs_stats(dev) -> Optional[torch.Tensor]:
    """The device's K10 stats pair (int64[2], zero when first made); None
    while a CUDA graph captures before it was made (no count then)."""
    dev = torch.device(dev)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    if dev not in _LEGS_STATS:
        if torch.cuda.is_current_stream_capturing():
            return None
        _LEGS_STATS[dev] = torch.zeros(2, dtype=torch.int64, device=dev)
    return _LEGS_STATS[dev]


def full_legs_launch(ptrs, nptrs: int, n: int, has_postvoid: bool,
                     cap_sentinel: int, aux: bool, stream: int) -> None:
    """One K10 launch from a prepared ``LEGS_LAYOUT`` pointer array: one
    cooperative launch of ceil(2n / 128) blocks; a refused launch raises."""
    err = library().tb_full_legs(ptrs, nptrs, n, int(has_postvoid),
                                 cap_sentinel, int(aux), stream)
    _raise_on(err, "full_legs")
    KERNELS["full_legs"].launches += 1


def full_legs_info(n: int) -> Dict[str, int]:
    """What the compiler and the card make of K10's launch for ``n`` lanes:
    registers and local memory a thread, threads a block, blocks, dynamic
    shared bytes and blocks resident on one SM.  Launches nothing."""
    _check_lanes(n)
    out = (ctypes.c_int * 6)()
    _raise_on(library().tb_full_legs_info(n, out), "full_legs")
    return dict(zip(("registers", "local_bytes", "threads", "blocks",
                     "shared_bytes", "blocks_per_sm"), out))


def full_legs(start_bal: Dict[str, torch.Tensor], cap_sentinel: int, ok,
              amt_lo, pamt_lo, dr_slot, cr_slot, dr_live, cr_live, pending,
              post, postvoid, has_postvoid: bool,
              cache: Optional[Sequence[torch.Tensor]] = None
              ) -> Dict[str, torch.Tensor]:
    """Kernel K10 on its own: the leg balances (keys of ``legs_buffers``;
    ``val`` holds {dp, dpo, cp, cpo} x {pre, incl} x {lo, hi}).  ``cache``
    (keys int64[legs_pad(n)], slots int64[2n], ok int32[1]) is the sort
    cache, read and, when stale, refreshed in place; None sorts."""
    n = ok.numel()
    _check_lanes(n)
    cols = [start_bal[f + s] for f in ("debits_pending", "debits_posted",
                                       "credits_pending", "credits_posted")
            for s in ("_lo", "_hi")]
    for c in cols:
        _check(c, torch.int64, 2 * n, "start balance")
    for t, dt, what in ((ok, torch.bool, "ok"), (amt_lo, torch.int64, "amt_lo"),
                        (pamt_lo, torch.int64, "pamt_lo"),
                        (dr_slot, torch.int64, "dr_slot"),
                        (cr_slot, torch.int64, "cr_slot"),
                        (dr_live, torch.bool, "dr_live"),
                        (cr_live, torch.bool, "cr_live"),
                        (pending, torch.bool, "pending"),
                        (post, torch.bool, "post"),
                        (postvoid, torch.bool, "postvoid")):
        _check(t, dt, n, what)
    if cache is None:
        cache = (None, None, None)
    else:
        _check(cache[0], torch.int64, legs_pad(n), "cache keys")
        _check(cache[1], torch.int64, 2 * n, "cache slots")
        _check(cache[2], torch.int32, 1, "cache ok word")
    out = legs_buffers(n, ok.device)
    ptrs, nptrs = layout_array(LEGS_LAYOUT, {
        "start": cols, "ok": [ok], "amt": [amt_lo], "pamt": [pamt_lo],
        "dr_slot": [dr_slot], "cr_slot": [cr_slot], "dr_live": [dr_live],
        "cr_live": [cr_live], "pending": [pending], "post": [post],
        "postvoid": [postvoid], "leg_pos": [out["leg_pos"]], "val": out["val"],
        "s_slot": [out["s_slot"]], "s_live": [out["s_live"]],
        "is_last": [out["is_last"]], "arith": [out["arith"]],
        "scratch": [out["scratch"]], "stats": [None], "ctrl": [None],
        "proved": [None], "needed": [None], "cache_keys": [cache[0]],
        "cache_slot": [cache[1]], "cache_ok": [cache[2]]})
    full_legs_launch(ptrs, nptrs, n, has_postvoid, cap_sentinel, False,
                     _stream(ok))
    return out


def full_legs_apply(gate, scat, s_slot, incl: Sequence[torch.Tensor],
                    cols: Sequence[torch.Tensor], slot_base: int = 0) -> None:
    """K10's apply launch: where ``gate`` (int32[1]) is 0, each run tail
    (``scat``) writes its eight inclusive balance columns at its slot.
    ``slot_base`` (one shard of a sharded ledger): the slots are global, and
    only the tails in [slot_base, slot_base + C) write, at slot -
    slot_base."""
    lib = library()
    n2 = scat.numel()
    _check(gate, torch.int32, 1, "gate")
    _check(scat, torch.bool, n2, "scat")
    _check(s_slot, torch.int64, n2, "s_slot")
    for v in incl:
        _check(v, torch.int64, n2, "inclusive balance")
    cap = cols[0].numel()
    for c in cols:
        _check(c, torch.int64, cap, "balance column")
    err = lib.tb_full_legs_apply(gate.data_ptr(), n2, scat.data_ptr(),
                                 s_slot.data_ptr(), slot_base, cap,
                                 _ptr_array(incl), _ptr_array(cols),
                                 _stream(scat))
    _raise_on(err, "full_legs")
    KERNELS["full_legs"].launches += 1


def full_waves(hazard, unschedulable, wdr_slot, wdr_live, wcr_slot, wcr_live,
               valid, cap_sentinel: int, max_rounds: int,
               proved: Optional[torch.Tensor] = None,
               needed: Optional[torch.Tensor] = None,
               cache: Optional[Sequence[torch.Tensor]] = None):
    """Kernel K12: (proved bool 0-dim, passes_needed int32 0-dim, depth
    int32[N], hist int32[9]).  ``proved`` (bool[1]) and ``needed`` (int32[1])
    may be given to receive them (the Jacobi loop's control words), and
    ``cache`` (keys, slots, ok word) to leave the leg sort for K10."""
    lib = library()
    n = hazard.numel()
    _check_lanes(n)
    for t, dt, what in ((hazard, torch.bool, "hazard"),
                        (wdr_slot, torch.int64, "wdr_slot"),
                        (wdr_live, torch.bool, "wdr_live"),
                        (wcr_slot, torch.int64, "wcr_slot"),
                        (wcr_live, torch.bool, "wcr_live"),
                        (valid, torch.bool, "valid")):
        _check(t, dt, n, what)
    _check(unschedulable, torch.bool, 1, "unschedulable")
    dev = hazard.device
    if proved is None:
        proved = torch.empty(1, dtype=torch.bool, device=dev)
    if needed is None:
        needed = torch.empty(1, dtype=torch.int32, device=dev)
    _check(proved, torch.bool, 1, "proved")
    _check(needed, torch.int32, 1, "needed")
    p2 = legs_pad(n)
    # csrc/full_waves.cu: the sorted chunks, (no cache) the sorted keys and
    # slots, then the lanes' priors and the per-block partials.
    words = p2 + (p2 + 2 * n if cache is None else 0)
    words += (n + 5 * WAVE_MAX_BLOCKS + 1 + 1) // 2
    scratch = torch.empty(words, dtype=torch.int64, device=dev)
    depth = torch.empty(n, dtype=torch.int32, device=dev)
    hist = torch.empty(9, dtype=torch.int32, device=dev)
    err = lib.tb_full_waves(
        hazard.data_ptr(), unschedulable.data_ptr(), wdr_slot.data_ptr(),
        wdr_live.data_ptr(), wcr_slot.data_ptr(), wcr_live.data_ptr(),
        valid.data_ptr(), n, cap_sentinel, max_rounds,
        *((None, None, None) if cache is None else (c.data_ptr() for c in cache)),
        scratch.data_ptr(), depth.data_ptr(), proved.data_ptr(),
        needed.data_ptr(), hist.data_ptr(), _stream(hazard),
    )
    _raise_on(err, "full_waves")
    KERNELS["full_waves"].launches += 1
    return proved[0], needed[0], depth, hist


def full_pass_launch(ptrs, nptrs: int, mode: int, aux: bool, n: int,
                     count: int, timestamp: int, has_postvoid: bool,
                     use_waves: bool, max_passes: int, hsize: int,
                     stream: int) -> None:
    """One K11 launch (``mode`` PASS_INIT, PASS_PRE or PASS_POST) from a
    prepared ``FULL_PASS_LAYOUT`` pointer array."""
    err = library().tb_full_pass(
        ptrs, nptrs, mode, int(aux), n, count, timestamp & ((1 << 64) - 1),
        int(has_postvoid), int(use_waves), max_passes, hsize, stream)
    _raise_on(err, "full_pass")
    KERNELS["full_pass"].launches += 1


def full_hist(gate, do_hist, rows: Sequence[torch.Tensor],
              cols: Sequence[torch.Tensor], count) -> None:
    """K11's history append: where ``gate`` (int32[1]) is 0, the rows of
    the lanes in ``do_hist`` at count + their prefix in lane order (dropped
    past the capacity); the count grows by all of them."""
    lib = library()
    n = do_hist.numel()
    _check_lanes(n)
    _check(gate, torch.int32, 1, "gate")
    _check(do_hist, torch.bool, n, "do_hist")
    _check(count, torch.int64, 1, "history count")
    cap = cols[0].numel()
    for r, c in zip(rows, cols):
        _check(r, torch.int64, n, "history row")
        _check(c, torch.int64, cap, "history column")
    part = torch.empty(PASS_MAX_BLOCKS, dtype=torch.int32,
                       device=do_hist.device)
    err = lib.tb_full_hist(gate.data_ptr(), do_hist.data_ptr(), n,
                           _ptr_array(rows), _ptr_array(cols), cap,
                           count.data_ptr(), part.data_ptr(), _stream(do_hist))
    _raise_on(err, "full_pass")
    KERNELS["full_pass"].launches += 1


# -- K13-K16: the transfer index and the queries ---------------------------------

SORT_RUN_MAX = 8192  # csrc/index_sort.cu: a run K13 sorts whole in one launch


def _check_run(cols: Sequence[torch.Tensor], n: int, what: str) -> None:
    if len(cols) != 5:
        raise ValueError(f"{what}: five columns, got {len(cols)}")
    for k, c in enumerate(cols):
        _check(c, torch.int64, n, f"{what} column {k}")


def run_sort(jobs: Sequence[Sequence[torch.Tensor]],
             use: Optional[torch.Tensor],
             outs: Sequence[Sequence[torch.Tensor]], fused: bool = True) -> int:
    """Kernel K13: each job's five columns (n_in entries; sentinels where
    ``use`` is False and past n_in) sorted stably by (acct_hi, acct_lo, ts)
    into ``outs`` (n_out >= n_in entries each): whole up to 8,192 entries
    (unless ``fused`` is False), else (n_out a multiple of 1,024) in sorted
    chunks of 1,024 for K14 to merge.  Returns the length of the sorted
    runs written.  A whole run is one cluster of a block a chunk, merged
    by rank in shared memory: nothing is allocated here."""
    lib = library()
    n_in = jobs[0][0].numel()
    n_out = outs[0][0].numel()
    if not 1 <= len(jobs) == len(outs) <= 2:
        raise ValueError("run_sort takes one or two jobs")
    for cols in jobs:
        _check_run(cols, n_in, "run_sort input")
    for cols in outs:
        _check_run(cols, n_out, "run_sort output")
    if use is not None:
        _check(use, torch.bool, n_in, "use")
    if n_in > n_out or n_out < 1:
        raise ValueError(f"run_sort: {n_in} entries into {n_out}")
    if (n_out > SORT_RUN_MAX or not fused) and n_out > 1024 and n_out % 1024:
        raise ValueError(f"run_sort: {n_out} entries is not a multiple of 1,024")
    sorted_run = ctypes.c_int64(0)
    err = lib.tb_run_sort(
        _ptr_array([c for cols in jobs for c in cols]),
        _ptr_array([c for cols in outs for c in cols]), len(jobs),
        None if use is None else use.data_ptr(), n_in, n_out, int(fused),
        ctypes.byref(sorted_run), _stream(outs[0][0]))
    _raise_on(err, "run_sort")
    KERNELS["run_sort"].launches += 1
    return sorted_run.value


def run_sort_info(n_out: int, fused: bool = True) -> Dict[str, int]:
    """The launch K13 takes for a run of ``n_out`` entries: ``cluster``
    blocks a cluster (1: the chunks are not merged), ``smem`` bytes of
    shared memory a block, and ``max_clusters`` the card holds at once
    (0 would mean the launch cannot be scheduled)."""
    cluster, smem, most = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    err = library().tb_run_sort_info(n_out, int(fused), ctypes.byref(cluster),
                                     ctypes.byref(smem), ctypes.byref(most))
    _raise_on(err, "run_sort")
    return {"cluster": cluster.value, "smem": smem.value,
            "max_clusters": most.value}


MERGE_TILE = 2048  # csrc/index_merge.cu: the outputs a block of K14 merges


def _merge_launch(cols: List[torch.Tensor], sizes: List[int], jobs: int,
                  stream: int, prefix=None) -> None:
    arr = (ctypes.c_int64 * len(sizes))(*sizes)
    ptrs = None
    if prefix is not None:
        ptrs = (ctypes.c_void_p * len(prefix))(
            *[None if t is None else t.data_ptr() for t in prefix])
    err = library().tb_run_merge(_ptr_array(cols), arr, ptrs, jobs, stream)
    _raise_on(err, "run_merge")
    KERNELS["run_merge"].launches += 1


def run_merge(a: Sequence[Sequence[torch.Tensor]],
              b: Sequence[Sequence[torch.Tensor]],
              out: Sequence[Sequence[torch.Tensor]]) -> None:
    """Kernel K14: for each job (one or two), the stable merge of the
    sorted runs a and b (a first on equal keys) into out (len a + len b)."""
    if not 1 <= len(a) == len(b) == len(out) <= 2:
        raise ValueError("run_merge takes one or two jobs")
    cols, sizes = [], []
    for ja, jb, jo in zip(a, b, out):
        la, lb = ja[0].numel(), jb[0].numel()
        _check_run(ja, la, "run_merge a")
        _check_run(jb, lb, "run_merge b")
        _check_run(jo, la + lb, "run_merge out")
        cols += [*ja, *jb, *jo]
        sizes += [la, lb, 1, 0, 0, 0]
    _merge_launch(cols, sizes, len(a), _stream(out[0][0]))


def run_merge_rounds(src: Sequence[Sequence[torch.Tensor]],
                     dst: Sequence[Sequence[torch.Tensor]], run: int,
                     pin: Optional[Sequence[torch.Tensor]] = None,
                     pout: Optional[Sequence[torch.Tensor]] = None,
                     pchunk: Optional[Sequence[torch.Tensor]] = None) -> None:
    """K14 over adjacent pairs of sorted runs of ``run`` entries: each job's
    ``src`` (n entries, n a multiple of 2 * run) merged pairwise into
    ``dst``, giving sorted runs of 2 * run.  With ``pout`` (int64[n / (2 *
    run)] a job), only the runs' live prefixes (the entries before the
    sentinel-keyed tail) are merged, from the lengths in ``pin`` (int64[n /
    run] a job; None: each run is searched, and the lengths kept in
    ``pchunk`` when given), and each merged run's prefix length is written
    to ``pout``; ``dst`` past a run's prefix is not written."""
    if not 1 <= len(src) == len(dst) <= 2:
        raise ValueError("run_merge takes one or two jobs")
    if pout is None and (pin is not None or pchunk is not None):
        raise ValueError("run_merge: pin and pchunk go with pout")
    cols, sizes, prefix = [], [], []
    for j, (js, jd) in enumerate(zip(src, dst)):
        n = js[0].numel()
        if n % (2 * run):
            raise ValueError(f"run_merge: {n} entries in runs of {run}")
        _check_run(js, n, "run_merge source")
        _check_run(jd, n, "run_merge destination")
        cols += [*js, *(c[run:] for c in js), *jd]
        sizes += [run, run, n // (2 * run), 2 * run, 2 * run, 2 * run]
        if pout is not None:
            _check(pout[j], torch.int64, n // (2 * run), "run_merge pout")
            if pin is not None:
                _check(pin[j], torch.int64, n // run, "run_merge pin")
            if pchunk is not None:
                _check(pchunk[j], torch.int64, n // run, "run_merge pchunk")
            prefix += [None if pin is None else pin[j], pout[j],
                       None if pchunk is None else pchunk[j]]
    _merge_launch(cols, sizes, len(src), _stream(dst[0][0]),
                  prefix if pout is not None else None)


def run_merge_tail(chunks: Sequence[Sequence[torch.Tensor]],
                   level: Sequence[Sequence[torch.Tensor]], chunk: int,
                   pchunk: Sequence[torch.Tensor],
                   pfinal: Sequence[torch.Tensor]) -> None:
    """K14's last step of a full build: each job's level (its merged live
    prefix of ``pfinal`` entries written) gets its tail, every sorted
    chunk's sentinel-keyed entries (from ``pchunk``'s prefix lengths on)
    in chunk order: the entries whose key is the sentinel key, in position
    order, as a stable sort leaves them."""
    if not 1 <= len(chunks) == len(level) == len(pchunk) == len(pfinal) <= 2:
        raise ValueError("run_merge_tail takes one or two jobs")
    n = chunks[0][0].numel()
    if n % chunk:
        raise ValueError(f"run_merge_tail: {n} entries in chunks of {chunk}")
    cols, sizes, prefix = [], [], []
    for jc, jl, pc, pf in zip(chunks, level, pchunk, pfinal):
        _check_run(jc, n, "run_merge_tail chunks")
        _check_run(jl, n, "run_merge_tail level")
        _check(pc, torch.int64, n // chunk, "run_merge_tail pchunk")
        _check(pf, torch.int64, 1, "run_merge_tail pfinal")
        cols += [*jc, *jl]
        sizes += [n // chunk, chunk]
        prefix += [pc, pf]
    off = torch.empty(len(chunks) * (n // chunk), dtype=torch.int64,
                      device=chunks[0][0].device)
    arr = (ctypes.c_int64 * len(sizes))(*sizes)
    err = library().tb_run_merge_tail(
        _ptr_array(cols), arr, _ptr_array(prefix), len(chunks),
        off.data_ptr(), _stream(level[0][0]))
    _raise_on(err, "run_merge")
    KERNELS["run_merge"].launches += 1


def _level_ptrs(levels: Sequence[dict]):
    """The five columns' pointers of each level and the levels' lengths."""
    cols, ns = [], []
    for lvl in levels:
        n = lvl["ts"].numel()
        run = [lvl[c] for c in ("acct_lo", "acct_hi", "ts", "tid_lo", "tid_hi")]
        _check_run(run, n, "index level")
        cols += run
        ns.append(n)
    return cols, (ctypes.c_int64 * len(ns))(*ns), len(ns)


def index_window(sides: Sequence[Sequence[dict]], acct_lo: int, acct_hi: int,
                 ts_min: int, ts_max: int, k: int, descending: bool):
    """Kernel K15, window mode: (ts, tid_lo, tid_hi), k candidates per level
    of each side's levels, concatenated level after level (``_query_side``
    of the JAX package for one side)."""
    cols, ns, nwin = _level_ptrs([lvl for side in sides for lvl in side])
    out = torch.empty((3, nwin * k), dtype=torch.int64, device=cols[0].device)
    err = library().tb_index_window(
        _ptr_array(cols), ns, nwin, acct_lo & _M64, acct_hi & _M64,
        ts_min & _M64, ts_max & _M64, k, int(descending), out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), _stream(cols[0]))
    _raise_on(err, "index_window")
    KERNELS["index_window"].launches += 1
    return out[0], out[1], out[2]


def index_union(sides: Sequence[Sequence[dict]], wants: Sequence[bool],
                acct_lo: int, acct_hi: int, ts_min: int, ts_max: int, k: int,
                descending: bool):
    """Kernel K15, union mode: the query over the windows of each side (one
    or two) in result order, (valid bool[k], tid_lo[k], tid_hi[k]), in one
    launch that makes no candidate array."""
    if not 1 <= len(sides) == len(wants) <= 2:
        raise ValueError("index_union takes one or two sides")
    cols, ns, nwin = _level_ptrs([lvl for side in sides for lvl in side])
    dev = cols[0].device
    valid = torch.empty(k, dtype=torch.bool, device=dev)
    res = torch.empty((2, k), dtype=torch.int64, device=dev)
    err = library().tb_index_union(
        _ptr_array(cols), ns, nwin, len(sides[0]), int(bool(wants[0])),
        int(bool(wants[-1])), acct_lo & _M64, acct_hi & _M64, ts_min & _M64,
        ts_max & _M64, k, int(descending), valid.data_ptr(),
        res[0].data_ptr(), res[1].data_ptr(), _stream(cols[0]))
    _raise_on(err, "index_window")
    KERNELS["index_window"].launches += 1
    return valid, res[0], res[1]


def index_window_info() -> Dict[str, int]:
    """What the compiler makes of K15's two kernels: registers, local
    memory a thread and threads a block of window mode and of union mode,
    and the union block's shared memory.  Launches nothing."""
    out = (ctypes.c_int * 7)()
    _raise_on(library().tb_index_window_info(out), "index_window")
    return dict(zip(("window_registers", "window_local_bytes",
                     "window_threads", "union_registers", "union_local_bytes",
                     "union_threads", "union_smem_bytes"), out))


# The order of the 21 history columns in csrc/history_scan.cu.
HISTORY_COL_ORDER = (
    "dr_id_lo", "dr_id_hi",
    "dr_dp_lo", "dr_dp_hi", "dr_dpo_lo", "dr_dpo_hi",
    "dr_cp_lo", "dr_cp_hi", "dr_cpo_lo", "dr_cpo_hi",
    "cr_id_lo", "cr_id_hi",
    "cr_dp_lo", "cr_dp_hi", "cr_dpo_lo", "cr_dpo_hi",
    "cr_cp_lo", "cr_cp_hi", "cr_cpo_lo", "cr_cpo_hi",
    "timestamp",
)
HISTORY_ROW_COLS = ("timestamp",) + tuple(
    f"{f}_{h}" for f in ("debits_pending", "debits_posted", "credits_pending",
                         "credits_posted") for h in ("lo", "hi"))


HISTORY_ORDER_ERROR = (
    "history_scan: the history log's timestamps below its count do not "
    "increase; the kernel's top-k would be wrong")
_HS_LAUNCH: Dict[Tuple[int, int], Tuple[int, int]] = {}


def history_scan_launch(cap: int, device: int) -> Tuple[int, int]:
    """K16's cooperative launch for a log of ``cap`` slots on CUDA device
    ``device``: (blocks, the scratch's int64 words).  Launches nothing."""
    key = (device, cap)
    if key not in _HS_LAUNCH:
        blocks, words = ctypes.c_int64(), ctypes.c_int64()
        with torch.cuda.device(device):
            _raise_on(library().tb_history_scan_scratch(
                cap, ctypes.byref(blocks), ctypes.byref(words)), "history_scan")
        _HS_LAUNCH[key] = (blocks.value, words.value)
    return _HS_LAUNCH[key]


def history_scan(cols: Dict[str, torch.Tensor], count: torch.Tensor,
                 acct_lo: int, acct_hi: int, ts_min: int, ts_max: int,
                 want_debits: bool, want_credits: bool, descending: bool,
                 k: int, check: bool = True):
    """Kernel K16: (valid bool[k], rows) of ``scan_history``, one launch.
    The kernel writes an error word (int32[1]) that is set when the log's
    timestamps below ``count`` do not increase (the order it relies on).
    ``check`` reads it back and raises; ``check`` False returns (valid,
    rows, error word) for the caller to read back with the rows."""
    lib = library()
    src = [cols[name] for name in HISTORY_COL_ORDER]
    cap = src[0].numel()
    for name, c in zip(HISTORY_COL_ORDER, src):
        _check(c, torch.int64, cap, f"history {name}")
    _check(count.reshape(1), torch.int64, 1, "history count")
    if not 1 <= k <= cap:
        raise ValueError(f"history_scan: k {k} outside 1..{cap}")
    dev = src[0].device
    blocks, words = history_scan_launch(cap, dev.index)
    scratch = torch.empty(words, dtype=torch.int64, device=dev)
    err_word = torch.empty(1, dtype=torch.int32, device=dev)
    valid = torch.empty(k, dtype=torch.bool, device=dev)
    rows = torch.empty((len(HISTORY_ROW_COLS), k), dtype=torch.int64,
                       device=dev)
    err = lib.tb_history_scan(
        _ptr_array(src), count.data_ptr(), cap, k, acct_lo & _M64,
        acct_hi & _M64, ts_min & _M64, ts_max & _M64, int(bool(want_debits)),
        int(bool(want_credits)), int(bool(descending)), scratch.data_ptr(),
        blocks, err_word.data_ptr(), valid.data_ptr(),
        _ptr_array(list(rows.unbind(0))), _stream(valid))
    _raise_on(err, "history_scan")
    KERNELS["history_scan"].launches += 1
    out = dict(zip(HISTORY_ROW_COLS, rows.unbind(0)))
    if not check:
        return valid, out, err_word
    if int(err_word.item()):
        raise RuntimeError(HISTORY_ORDER_ERROR)
    return valid, out


# -- K17-K19: the cold tier ------------------------------------------------------


def _ptr(t: Optional[torch.Tensor], n: int, what: str):
    if t is None:
        return None
    _check(t, torch.bool, n, what)
    return t.data_ptr()


def bloom_check(bloom, id_lo, id_hi, *, valid=None, found=None, p_lo=None,
                p_hi=None, postvoid=None, p_found=None, checked=None,
                out: bool = True, flag_word: Optional[torch.Tensor] = None,
                flag_bit: int = 0) -> Optional[torch.Tensor]:
    """Kernel K17: each lane's id against the Bloom filter (``bloom``, int32
    words), under the optional bool masks (``valid`` and not ``found`` for
    the id, ``postvoid`` and not ``p_found`` for ``p_lo``/``p_hi``, neither
    where ``checked``); returns the lanes' hits (bool[N]) when ``out``, and
    ORs ``flag_bit`` into ``flag_word`` (int32, one element) on the card
    when a lane hits."""
    lib = library()
    words = bloom.numel()
    _check(bloom, torch.int32, words, "bloom")
    n = id_lo.numel()
    _check(id_lo, torch.int64, n, "id_lo")
    _check(id_hi, torch.int64, n, "id_hi")
    if postvoid is not None:
        _check(p_lo, torch.int64, n, "pending id_lo")
        _check(p_hi, torch.int64, n, "pending id_hi")
    if flag_word is not None:
        _check(flag_word, torch.int32, 1, "flag_word")
    hits = torch.empty(n, dtype=torch.bool, device=id_lo.device) if out else None
    err = lib.tb_bloom_check(
        bloom.data_ptr(), words * 32, id_lo.data_ptr(), id_hi.data_ptr(),
        _ptr(valid, n, "valid"), _ptr(found, n, "found"),
        None if postvoid is None else p_lo.data_ptr(),
        None if postvoid is None else p_hi.data_ptr(),
        _ptr(postvoid, n, "postvoid"), _ptr(p_found, n, "p_found"),
        _ptr(checked, n, "checked"), n,
        None if hits is None else hits.data_ptr(),
        None if flag_word is None else flag_word.data_ptr(), flag_bit,
        _stream(id_lo))
    _raise_on(err, "bloom_check")
    KERNELS["bloom_check"].launches += 1
    return hits


def _check_evict_table(key_lo, key_hi, tomb, ts) -> int:
    cap = key_lo.numel()
    _check(key_lo, torch.int64, cap, "table key_lo")
    _check(key_hi, torch.int64, cap, "table key_hi")
    _check(tomb, torch.bool, cap, "table tombstone")
    _check(ts, torch.int64, cap, "table timestamp")
    return cap


def evict_threshold(key_lo, key_hi, tomb, ts, count: torch.Tensor, num: int,
                    den: int) -> torch.Tensor:
    """Kernel K18: the eviction threshold (int64[1] holding the u64), read
    from the table and its ``count`` on the card: a radix select, nine
    launches on the current stream, no host read."""
    lib = library()
    cap = _check_evict_table(key_lo, key_hi, tomb, ts)
    _check(count.reshape(1), torch.int64, 1, "table count")
    if den <= 0 or num < 0:
        raise ValueError(f"evict_threshold: bad fraction {num}/{den}")
    dev = key_lo.device
    keys = torch.empty(cap, dtype=torch.int64, device=dev)
    hist = torch.zeros(8 * 256, dtype=torch.int64, device=dev)
    state = torch.empty(18, dtype=torch.int64, device=dev)
    out = torch.empty(1, dtype=torch.int64, device=dev)
    err = lib.tb_evict_threshold(
        key_lo.data_ptr(), key_hi.data_ptr(), tomb.data_ptr(), ts.data_ptr(),
        cap, count.data_ptr(), num, den, keys.data_ptr(), hist.data_ptr(),
        state.data_ptr(), out.data_ptr(), _stream(key_lo))
    _raise_on(err, "evict_threshold")
    KERNELS["evict_threshold"].launches += 1
    return out


def evict_extract(key_lo, key_hi, tomb, cols: Dict[str, torch.Tensor],
                  threshold: torch.Tensor, k: int, keep: bool = False):
    """Kernel K19: (n int64[1], key_lo[k], key_hi[k], {column: [k]}, keep
    bool[C] or None): the live rows with timestamp <= ``threshold``, in slot
    order, in the first lanes, zeros after n; ``keep`` the live rows above
    the threshold."""
    lib = library()
    cap = _check_evict_table(key_lo, key_hi, tomb, cols["timestamp"])
    _check(threshold.reshape(1), torch.int64, 1, "threshold")
    if k < 0:
        raise ValueError(f"evict_extract: k {k} < 0")
    names = list(cols)
    src = [cols[name] for name in names]
    for name, c in zip(names, src):
        if c.dtype not in _U64_OR_U32:
            raise TypeError(f"column {name}: unsupported dtype {c.dtype}")
        _check(c, c.dtype, cap, f"column {name}")
    dev = key_lo.device
    tiles = (cap + 4095) // 4096
    scratch = torch.empty(2 * tiles, dtype=torch.int64, device=dev)
    n = torch.empty(1, dtype=torch.int64, device=dev)
    out_lo = torch.empty(k, dtype=torch.int64, device=dev)
    out_hi = torch.empty(k, dtype=torch.int64, device=dev)
    dst = [torch.empty(k, dtype=c.dtype, device=dev) for c in src]
    keep_t = torch.empty(cap, dtype=torch.bool, device=dev) if keep else None
    widths = (ctypes.c_int * max(1, len(src)))(*[_width(c) for c in src])
    err = lib.tb_evict_extract(
        key_lo.data_ptr(), key_hi.data_ptr(), tomb.data_ptr(),
        cols["timestamp"].data_ptr(), cap, threshold.data_ptr(), k,
        scratch.data_ptr(), scratch[tiles:].data_ptr(), n.data_ptr(),
        out_lo.data_ptr(), out_hi.data_ptr(), len(src), _ptr_array(src),
        _ptr_array(dst), widths,
        None if keep_t is None else keep_t.data_ptr(), _stream(key_lo))
    _raise_on(err, "evict_extract")
    KERNELS["evict_extract"].launches += 1
    return n, out_lo, out_hi, dict(zip(names, dst)), keep_t


# -- K20: the flagship generator ---------------------------------------------------


def bench_gen(cols: Sequence[torch.Tensor], mode: int, b: int, count: int,
              n_accounts: int, first_tid: int, *,
              b_word: Optional[torch.Tensor] = None) -> None:
    """Kernel K20: overwrites the transfer SoA ``cols`` (utils/benchgen.py
    ``GEN_COLS`` order: fourteen int64 columns, then five int32) with batch
    ``b`` of generator ``mode``, or batch ``b_word[0]`` when that u64 device
    word is given (the bench twin's captured graph)."""
    lib = library()
    if len(cols) != 19:
        raise ValueError("bench_gen needs the nineteen transfer columns")
    lanes = cols[0].numel()
    for k, c in enumerate(cols):
        _check(c, torch.int64 if k < 14 else torch.int32, lanes,
               f"bench_gen column {k}")
    if b_word is not None:
        _word(b_word, "batch word")
    if not 0 <= count <= lanes or n_accounts < 2:
        raise ValueError("bench_gen: bad count or n_accounts")
    err = lib.tb_bench_gen(_ptr_array(cols), lanes, mode, b & _M64,
                           None if b_word is None else b_word.data_ptr(),
                           count, n_accounts, first_tid & _M64,
                           _stream(cols[0]))
    _raise_on(err, "bench_gen")
    KERNELS["bench_gen"].launches += 1


# -- K21-K23: scrub and Merkle commitments ---------------------------------------

PAD_KINDS = {"accounts": 0, "transfers": 1, "posted": 2}
# Each pad's folded columns in the kernels' order (csrc/leaf.cuh).
PAD_COLS = {
    "accounts": (
        "debits_pending_lo", "debits_pending_hi",
        "debits_posted_lo", "debits_posted_hi",
        "credits_pending_lo", "credits_pending_hi",
        "credits_posted_lo", "credits_posted_hi",
        "timestamp",
    ),
    "transfers": ("amount_lo", "amount_hi", "timestamp"),
    "posted": ("fulfillment",),
}


def _pad_tensors(pad: str, key_lo, key_hi, cols: Dict[str, torch.Tensor]):
    """(capacity, [key_lo, key_hi], [folded columns]) of a pad, checked."""
    cap = key_lo.numel()
    if cap <= 0 or cap & (cap - 1):
        raise ValueError(f"{pad}: capacity must be a power of two, got {cap}")
    _check(key_lo, torch.int64, cap, f"{pad} key_lo")
    _check(key_hi, torch.int64, cap, f"{pad} key_hi")
    folded = [cols[name] for name in PAD_COLS[pad]]
    want = torch.int32 if pad == "posted" else torch.int64
    for name, c in zip(PAD_COLS[pad], folded):
        _check(c, want, cap, f"{pad} column {name}")
    return cap, [key_lo, key_hi], folded


def scrub_fold(pads: Dict[str, Tuple[torch.Tensor, torch.Tensor,
                                     Dict[str, torch.Tensor]]]) -> torch.Tensor:
    """Kernel K21: int64[3] = the (accounts, transfers, posted) scrub folds;
    ``pads[name]`` is (key_lo, key_hi, cols) of each pad."""
    lib = library()
    keys, cols, caps = [], [], []
    for pad in ("accounts", "transfers", "posted"):
        cap, k, c = _pad_tensors(pad, *pads[pad])
        keys += k
        cols += c
        caps.append(cap)
    out = torch.zeros(3, dtype=torch.int64, device=keys[0].device)
    caps_arr = (ctypes.c_int64 * 3)(*caps)
    err = lib.tb_scrub_fold(_ptr_array(keys), _ptr_array(cols), caps_arr,
                            out.data_ptr(), _stream(out))
    _raise_on(err, "scrub_fold")
    KERNELS["scrub_fold"].launches += 1
    return out


def merkle_build(pad: str, key_lo, key_hi, cols: Dict[str, torch.Tensor],
                 heap: Optional[torch.Tensor] = None,
                 root_out: Optional[torch.Tensor] = None) -> None:
    """Kernel K22: writes the pad's whole heap (int64[2C]) into ``heap``, or,
    with ``heap`` None, only the root into ``root_out`` (a one-element int64
    tensor); ``root_out`` may be given in heap mode too."""
    lib = library()
    cap, _k, folded = _pad_tensors(pad, key_lo, key_hi, cols)
    if heap is None and root_out is None:
        raise ValueError("merkle_build: nothing to write")
    if heap is not None:
        _check(heap, torch.int64, 2 * cap, f"{pad} heap")
        heap[:1].zero_()
    if root_out is not None:
        _check(root_out, torch.int64, 1, "root_out")
    tops = torch.empty(2, max(1, cap // 1024), dtype=torch.int64,
                       device=key_lo.device)
    err = lib.tb_merkle_build(
        PAD_KINDS[pad], key_lo.data_ptr(), key_hi.data_ptr(),
        _ptr_array(folded), cap, None if heap is None else heap.data_ptr(),
        tops[0].data_ptr(), tops[1].data_ptr(),
        None if root_out is None else root_out.data_ptr(), _stream(key_lo))
    _raise_on(err, "merkle_build")
    KERNELS["merkle_build"].launches += 1


def merkle_touch(pad: str, key_lo, key_hi, cols: Dict[str, torch.Tensor],
                 heap: torch.Tensor, slot: torch.Tensor,
                 found: torch.Tensor) -> None:
    """Kernel K23: refreshes, in place, the paths of ``heap`` (int64[2C])
    from the leaves at the found lanes' slots (K1's probe) to the root."""
    lib = library()
    cap, _k, folded = _pad_tensors(pad, key_lo, key_hi, cols)
    _check(heap, torch.int64, 2 * cap, f"{pad} heap")
    n = slot.numel()
    _check(slot, torch.int64, n, "slot")
    _check(found, torch.bool, n, "found")
    err = lib.tb_merkle_touch(
        PAD_KINDS[pad], key_lo.data_ptr(), key_hi.data_ptr(),
        _ptr_array(folded), cap, heap.data_ptr(), slot.data_ptr(),
        found.data_ptr(), n, _stream(heap))
    _raise_on(err, "merkle_touch")
    KERNELS["merkle_touch"].launches += 1


def merkle_path(heap: torch.Tensor, slot: int, levels: int) -> torch.Tensor:
    """Kernel K23's path entry: int64[levels + 2] = (the leaf at ``slot``,
    its ``levels`` siblings bottom-up, the root)."""
    lib = library()
    cap = heap.numel() // 2
    _check(heap, torch.int64, 2 * cap, "heap")
    out = torch.empty(levels + 2, dtype=torch.int64, device=heap.device)
    err = lib.tb_merkle_path(heap.data_ptr(), cap, slot, levels,
                             out.data_ptr(), _stream(heap))
    _raise_on(err, "merkle_path")
    KERNELS["merkle_touch"].launches += 1
    return out


# -- K24: the grouped commit's own steps (ops/group.py's CUDA graph) ----------------


def group_step(counts: torch.Tensor, timestamps: torch.Tensor, j: int,
               flags: torch.Tensor, valid: torch.Tensor, ts: torch.Tensor,
               pending: torch.Tensor, table_overflow: torch.Tensor,
               run_overflow: torch.Tensor) -> None:
    """Kernel K24, step ``j`` of a run: the lane mask, lane timestamps and
    pending mask from the run's u64 count and timestamp words, and the
    table's probe_overflow ORed into the run's word (reset at step 0)."""
    lib = library()
    k = counts.numel()
    n = flags.numel()
    _check(counts, torch.int64, k, "counts")
    _check(timestamps, torch.int64, k, "timestamps")
    if not 0 <= j < k:
        raise ValueError(f"step {j} outside 0..{k - 1}")
    _check(flags, torch.int32, n, "flags")
    _check(valid, torch.bool, n, "valid")
    _check(ts, torch.int64, n, "ts")
    _check(pending, torch.bool, n, "pending")
    _check(table_overflow, torch.bool, 1, "table probe_overflow")
    _check(run_overflow, torch.int32, 1, "run overflow")
    err = lib.tb_group_step(
        counts.data_ptr(), timestamps.data_ptr(), j, n, flags.data_ptr(),
        valid.data_ptr(), ts.data_ptr(), pending.data_ptr(),
        table_overflow.data_ptr(), run_overflow.data_ptr(), _stream(flags))
    _raise_on(err, "group_step")
    KERNELS["group_step"].launches += 1


def group_finish(table_overflow: torch.Tensor,
                 run_overflow: torch.Tensor) -> None:
    """Kernel K25, the last launch of a run: the table's probe_overflow
    ORed into the run's word after the last step's insert."""
    lib = library()
    _check(table_overflow, torch.bool, 1, "table probe_overflow")
    _check(run_overflow, torch.int32, 1, "run overflow")
    err = lib.tb_group_finish(table_overflow.data_ptr(),
                              run_overflow.data_ptr(), _stream(run_overflow))
    _raise_on(err, "group_finish")
    KERNELS["group_finish"].launches += 1


def group_words(base: torch.Tensor, count: int, ts0: int, bidx: torch.Tensor,
                counts: torch.Tensor, timestamps: torch.Tensor) -> None:
    """Kernel K26, the bench twin's step words: for the k =
    ``bidx.numel()`` steps of a replay, batch ``base + j``, count ``count``
    and timestamp ``ts0 + (base + j + 1) * count``; then ``base`` advances
    by k."""
    lib = library()
    k = bidx.numel()
    _word(base, "base word")
    for t, what in ((bidx, "bidx"), (counts, "counts"),
                    (timestamps, "timestamps")):
        _check(t, torch.int64, k, what)
    err = lib.tb_group_words(base.data_ptr(), k, count & _M64, ts0 & _M64,
                             bidx.data_ptr(), counts.data_ptr(),
                             timestamps.data_ptr(), _stream(base))
    _raise_on(err, "group_words")
    KERNELS["group_words"].launches += 1


# -- K27-K29: the batched VOPR (sim/vopr_tpu.py) --------------------------------

# K29 keeps the canonical list in shared memory up to this many ops
# (csrc/vopr.cuh VOPR_SHARED_MAX_OPS) and in a device buffer beyond.
VOPR_SHARED_MAX_OPS = 1024


def _vopr_consts(R: int, S: int, probs: Sequence[float]):
    from ..sim import vopr_tpu as vt

    words = vt.draw_consts(R, S, probs)
    return (ctypes.c_uint64 * len(words))(*words)


def _vopr_state_check(fields: Sequence[torch.Tensor], n: int, R: int, S: int,
                      max_ops: int, what: str) -> None:
    from ..sim import vopr_tpu as vt

    if len(fields) != len(vt.STATE_FIELDS):
        raise ValueError(f"{what}: {len(vt.STATE_FIELDS)} state fields")
    for name, t in zip(vt.STATE_FIELDS, fields):
        if name in ("part_active", "violated"):
            dtype, numel = torch.bool, n
        elif name in ("log", "log_hdr", "log_op"):
            dtype, numel = torch.int32, n * R * S
        elif name == "canonical":
            dtype, numel = torch.int32, n * max_ops
        else:
            dtype, numel = torch.int32, n * R
        _check(t, dtype, numel, f"{what} {name}")
        if t.shape[0] != n:
            raise ValueError(f"{what} {name}: leading dimension {n} expected")


def _vopr_state_empty(n: int, R: int, S: int, max_ops: int, dev,
                      canonical: Optional[torch.Tensor] = None):
    from ..sim import vopr_tpu as vt

    out = []
    for name in vt.STATE_FIELDS:
        if name in ("part_active", "violated"):
            out.append(torch.empty(n, dtype=torch.bool, device=dev))
        elif name in ("log", "log_hdr", "log_op"):
            out.append(torch.empty(n, R, S, dtype=torch.int32, device=dev))
        elif name == "canonical":
            out.append(canonical if canonical is not None else torch.empty(
                n, max_ops, dtype=torch.int32, device=dev))
        else:
            out.append(torch.empty(n, R, dtype=torch.int32, device=dev))
    return out


def vopr_draw(keys: torch.Tensor, n_replicas: int, slots: int,
              probs: Sequence[float]) -> Dict[str, torch.Tensor]:
    """Kernel K27: ``draw_faults`` for each of the (N, 2) keys (u32 words
    as int32 bits): the dict of ``sim/vopr_tpu.FAULT_FIELDS``, each leading
    with N, in the reference's dtypes."""
    from ..sim import vopr_tpu as vt

    lib = library()
    vt._check_shape(n_replicas, slots)
    n = keys.shape[0] if keys.dim() == 2 else -1
    if keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError("keys must have shape (N, 2)")
    _check(keys, torch.int32, 2 * n, "keys")
    dev = keys.device
    out = {}
    for name in vt.FAULT_FIELDS:
        shape = (n,) if name in vt._SCALAR_FAULTS else (n, n_replicas)
        out[name] = torch.empty(shape, dtype=vt.FAULT_DTYPES.get(
            name, torch.bool), device=dev)
    ptrs = _ptr_array([out[name] for name in vt.FAULT_FIELDS])
    err = lib.tb_vopr_draw(keys.data_ptr(), n, n_replicas, slots,
                           _vopr_consts(n_replicas, slots, probs), ptrs,
                           _stream(keys))
    _raise_on(err, "vopr_draw")
    KERNELS["vopr_draw"].launches += 1
    return out


def vopr_step(state: Sequence[torch.Tensor], faults: Sequence[torch.Tensor],
              n_replicas: int, slots: int, max_ops: int,
              bug: int) -> List[torch.Tensor]:
    """Kernel K28: one step of a batch of N clusters (the fields of
    ``sim/vopr_tpu.ClusterState`` in order, each leading with N) under the
    faults of ``FAULT_FIELDS`` (K27's layout); the new state's fields."""
    from ..sim import vopr_tpu as vt

    lib = library()
    vt._check_shape(n_replicas, slots)
    R, S = n_replicas, slots
    n = state[0].shape[0]
    _vopr_state_check(state, n, R, S, max_ops, "state")
    if len(faults) != len(vt.FAULT_FIELDS):
        raise ValueError(f"{len(vt.FAULT_FIELDS)} fault arrays")
    for name, t in zip(vt.FAULT_FIELDS, faults):
        numel = n if name in vt._SCALAR_FAULTS else n * R
        _check(t, vt.FAULT_DTYPES.get(name, torch.bool), numel,
               f"faults {name}")
    if not 0 <= bug <= len(vt.BUGS):
        raise ValueError(f"bug code {bug}")
    out = _vopr_state_empty(n, R, S, max_ops, state[0].device)
    err = lib.tb_vopr_step(n, R, S, max_ops, bug, _ptr_array(state),
                           _ptr_array(out), _ptr_array(faults),
                           _stream(state[0]))
    _raise_on(err, "vopr_step")
    KERNELS["vopr_step"].launches += 1
    return out


def vopr_run(seed_key: Tuple[int, int], start: int, count: int, n_steps: int,
             n_replicas: int, slots: int, probs: Sequence[float], bug: int,
             dev, final_state: bool = False):
    """Kernel K29: ``count`` whole schedules of ``n_steps`` on ``dev``, the
    clusters ``start`` .. ``start + count - 1`` of the seed key's split.
    (violated (count,) bool, the final state's fields or None).  The
    canonical lists sit in shared memory up to ``VOPR_SHARED_MAX_OPS`` ops
    (n_steps + 2), in a zeroed (count, n_steps + 2) device buffer beyond."""
    from ..sim import vopr_tpu as vt

    lib = library()
    vt._check_shape(n_replicas, slots)
    if count < 0 or start < 0 or n_steps < 0:
        raise ValueError("count, start and n_steps must be >= 0")
    if not 0 <= bug <= len(vt.BUGS):
        raise ValueError(f"bug code {bug}")
    R, S = n_replicas, slots
    max_ops = n_steps + 2
    violated = torch.empty(count, dtype=torch.bool, device=dev)
    canon = None
    if max_ops > VOPR_SHARED_MAX_OPS or final_state:
        canon = torch.zeros(count, max_ops, dtype=torch.int32, device=dev)
    out = _vopr_state_empty(count, R, S, max_ops, dev, canon) \
        if final_state else None
    err = lib.tb_vopr_run(
        seed_key[0] & 0xFFFFFFFF, seed_key[1] & 0xFFFFFFFF, start & _M64,
        count, n_steps, R, S, _vopr_consts(R, S, probs), bug,
        violated.data_ptr(),
        _ptr_array(out) if out is not None else None,
        canon.data_ptr() if max_ops > VOPR_SHARED_MAX_OPS else None,
        _stream(violated))
    _raise_on(err, "vopr_run")
    KERNELS["vopr_run"].launches += 1
    return violated, out


def vopr_run_info(n_replicas: int, slots: int,
                  n_steps: int) -> Dict[str, int]:
    """What the compiler and the card make of K29's launch at this shape:
    registers and local memory a thread, shared memory, threads and blocks
    resident on one SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    and the warps that makes, for a flags-only run.  Launches nothing."""
    from ..sim import vopr_tpu as vt

    vt._check_shape(n_replicas, slots)
    lib = library()
    out = (ctypes.c_int * 6)()
    canon_global = n_steps + 2 > VOPR_SHARED_MAX_OPS
    _raise_on(lib.tb_vopr_run_info(n_replicas, slots, n_steps,
                                   int(canon_global), out), "vopr_run_info")
    info = dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "threads", "dynamic_smem_bytes", "blocks_per_sm"), out))
    info["warps_per_sm"] = info["blocks_per_sm"] * info["threads"] // 32
    return info


# -- K30 shard_gather, K31 shard_combine -------------------------------------------


def shard_gather(tables: Sequence, shard_ids: Sequence[int], n_shards: int,
                 key_lo, key_hi, names: Sequence[str], max_probe: int,
                 count: int, mask: Optional[torch.Tensor], out: torch.Tensor,
                 offset: int, ovf_index: int, want_overflow: bool) -> None:
    """Kernel K30: the device's one answer row for the local shards
    ``tables`` (``ht.Table``s of C/n slots, indices ``shard_ids`` in a mesh
    of ``n_shards``): writes ``out`` (int64[M], u64 bits) from ``offset``:
    found, the global slot and the ``names`` columns (u32 zero-extended),
    each n lanes, from the lane's owner shard when it is local, zeros
    otherwise; and, when ``want_overflow``, 1 at ``out[ovf_index]`` (zero
    on entry) if a lane's local probe in any of the shards, owned or not,
    ran ``max_probe`` steps."""
    lib = library()
    nlocal = len(tables)
    n = key_lo.numel()
    _check(key_lo, torch.int64, n, "key_lo")
    _check(key_hi, torch.int64, n, "key_hi")
    if mask is not None:
        _check(mask, torch.bool, n, "mask")
    _check(out, torch.int64, None, "answer row")
    if out.dim() != 1:
        raise ValueError("the answer row must be int64[M]")
    m = out.shape[0]
    if offset < 0 or offset + (2 + len(names)) * n > m or not (
            0 <= ovf_index < m):
        raise ValueError("answer row too short for this gather")
    if nlocal == 0:
        return
    cap = tables[0].capacity
    klo, khi, tomb, cols = [], [], [], []
    for t in tables:
        _check(t.key_lo, torch.int64, cap, "table key_lo")
        _check(t.key_hi, torch.int64, cap, "table key_hi")
        _check(t.tombstone, torch.bool, cap, "table tombstone")
        klo.append(t.key_lo)
        khi.append(t.key_hi)
        tomb.append(t.tombstone)
        for name in names:
            c = t.cols[name]
            if c.dtype not in (torch.int64, torch.int32):
                raise TypeError(f"column {name}: unsupported dtype {c.dtype}")
            _check(c, c.dtype, cap, f"column {name}")
            cols.append(c)
    widths = (ctypes.c_int * max(1, len(names)))(
        *[_width(tables[0].cols[name]) for name in names])
    ids = (ctypes.c_int64 * nlocal)(*[int(s) for s in shard_ids])
    base = out.data_ptr()
    err = lib.tb_shard_gather(
        nlocal, ids, n_shards, n_shards.bit_length() - 1, cap,
        _ptr_array(klo), _ptr_array(khi), _ptr_array(tomb), len(names),
        _ptr_array(cols), widths, max_probe, key_lo.data_ptr(),
        key_hi.data_ptr(), n, count, None if mask is None else mask.data_ptr(),
        base + 8 * offset, base + 8 * ovf_index, int(want_overflow),
        _stream(key_lo),
    )
    _raise_on(err, "shard_gather")
    KERNELS["shard_gather"].launches += 1


def shard_combine(partial: torch.Tensor) -> torch.Tensor:
    """Kernel K31: int64[M], the wrap-sum over dim 0 of an int64[S, M]
    partial."""
    lib = library()
    _check(partial, torch.int64, None, "partial")
    if partial.dim() != 2:
        raise ValueError("partial must be int64[S, M]")
    s, m = partial.shape
    out = torch.empty(m, dtype=torch.int64, device=partial.device)
    err = lib.tb_shard_combine(partial.data_ptr(), s, m, out.data_ptr(),
                               _stream(partial))
    _raise_on(err, "shard_combine")
    KERNELS["shard_combine"].launches += 1
    return out
