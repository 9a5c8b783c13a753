"""K17 ``bloom_check``, K1 as the general path's ``build_gather_ctx``
launches it, and K16 ``history_scan``, timed on the card at the shapes
their paths give them, for one checkout's package.

The shapes and the timing (``timed``: CUDA events around calls queued
behind a GPU spin; ``cold_l2_ms``: the same after a 128 MB fill that
overwrites the L2) are this checkout's ``chip_smoke``; the package timed is
the one in ``--tree`` (by default this checkout), so one call can time an
earlier tree's kernels against this one's (earlier, this, this, earlier).

- ``k17``: the tiered path's shape.  An accounts table of 2^25 slots
  holding ids 1..10,000,000, a hot transfers table of 2^23 slots holding
  4,194,304 rows (the eviction point), a posted table of 2^16 slots, a
  Bloom filter of 2^28 bits holding 20,000,000 evicted ids, and a batch of
  8,190 events on 8,192 lanes with 256 evicted ids resubmitted; half its
  lanes post or void a pending (half of them hot, a quarter evicted, a
  quarter absent).  Times the masked form (``cold.bloom_flag``) and the
  out form (``cold.bloom_check_impl``), warm and after an L2 flush; K1's
  launch of ``build_gather_ctx``'s three and seven lookups; the whole of
  ``build_gather_ctx`` with the filter and the launches it makes (the
  runtime's launch and memset calls in a CPU profile); where the tree has
  it, K1's launch with the filter step and the flag word
  (``chip_smoke.tier_flag_shape``, which also holds them against their
  plain forms).
- ``k1``: the main path's three probes in one launch (debit and credit
  ids into 2^16 account slots holding 10,000, 8,190 ids into 2^25
  transfer slots holding 9,999,990 rows, 15 columns).
- ``k16``: one get_account_history at the queries run's shape: a history
  log of 2^24 slots holding 10,000,000 rows over 10,000 accounts, limit
  8,190, both directions.  The kernel alone (no read-back), its launches
  apart (a profile by kernel name), the error word's fill and read-back,
  ``query.scan_history`` and ``TorchStateMachine.get_account_history``
  (synchronised host walls, median of 20).

Prints one JSON line a part.  Run from the repository root on a machine
with a CUDA card:

    python tools/cold_history_times.py [--tree DIR] [--parts k17,k1,k16]
"""

import argparse
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HIST_LOG2 = 24
HIST_ROWS = 10_000_000
HIST_ACCOUNTS = 10_000
MAIN_ACCOUNTS_LOG2 = 16
MAIN_TRANSFERS_LOG2 = 25
MAIN_ROWS = 1221 * 8190  # the main run's transfers before its last batch


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def wall_ms(fn, reps=20) -> float:
    """Median host wall of a synchronised call."""
    import numpy as np
    import torch

    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def gather_lookups(tf, ht, ledger, soa, valid, postvoid, has_postvoid):
    """``build_gather_ctx``'s lookups without the cold test: the tree's own
    ``transfer_full.gather_lookups``; a tree from before it (K17 a launch
    of its own) gets the same list from this shim."""
    if hasattr(tf, "gather_lookups"):
        return tf.gather_lookups(ledger, soa, valid, postvoid, False,
                                 has_postvoid)
    xfr_cols = tuple(tf.TRANSFER_COLS)
    looks = [
        ht.Lookup(ledger.transfers, soa["id_lo"], soa["id_hi"], xfr_cols,
                  mask=valid),
        ht.Lookup(ledger.accounts, soa["debit_account_id_lo"],
                  soa["debit_account_id_hi"], tf._ACCOUNT_VIEW_COLS, mask=valid),
        ht.Lookup(ledger.accounts, soa["credit_account_id_lo"],
                  soa["credit_account_id_hi"], tf._ACCOUNT_VIEW_COLS,
                  mask=valid),
    ]
    if has_postvoid:
        looks += [
            ht.Lookup(ledger.transfers, soa["pending_id_lo"],
                      soa["pending_id_hi"], xfr_cols, mask=postvoid),
            ht.Lookup(ledger.accounts, None, cols=tf._ACCOUNT_VIEW_COLS,
                      keys_from=(3, "debit_account_id_lo", "debit_account_id_hi")),
            ht.Lookup(ledger.accounts, None, cols=tf._ACCOUNT_VIEW_COLS,
                      keys_from=(3, "credit_account_id_lo",
                                 "credit_account_id_hi")),
            ht.Lookup(ledger.posted, None, cols=("fulfillment",),
                      keys_from=(3, "timestamp", None)),
        ]
    return looks


def part_k17(cs, dev) -> dict:
    import torch
    from tigerbeetle_tpu_torch.ops import cold
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import transfer_full as tf

    ledger, bloom, plain, twophase = cs.tier_shape(dev)
    out = {"shape": f"{cs.COUNT} events on {cs.LANES} lanes; accounts "
                    f"2^{cs.TIER_ACCOUNTS_LOG2} holding {cs.TIER_ACCOUNTS}, "
                    f"hot transfers 2^{cs.TIER_HOT_LOG2} holding "
                    f"{cs.TIER_HOT_ROWS}, filter 2^{cs.TIER_BLOOM_LOG2} bits "
                    f"holding {cs.TIER_COLD_IDS} ids; {cs.TIER_RESUBMITS} "
                    f"evicted ids resubmitted"}
    n = cs.LANES
    valid = torch.arange(n, device=dev) < cs.COUNT
    for name, soa, has_pv in (("no_postvoid", plain, False),
                              ("postvoid", twophase, True)):
        flags = soa["flags"]
        postvoid = ((flags & (tf.TF_POST | tf.TF_VOID)) != 0) & valid
        looks = gather_lookups(tf, ht, ledger, soa, valid, postvoid, has_pv)
        got = ht.lookup_many(looks, tf.MAX_PROBE)
        found = got[0].found
        p_found = got[3].found if has_pv else None
        pv = postvoid if has_pv else None
        word = torch.zeros((), dtype=torch.int32, device=dev)
        masked = (bloom, soa["id_lo"], soa["id_hi"], valid, found,
                  soa["pending_id_lo"], soa["pending_id_hi"], pv, p_found, None,
                  word, tf.FLAG_COLD)
        r = {
            "tested_ids": int((valid & ~found).sum()),
            "tested_pending_ids": int((postvoid & ~p_found).sum()) if has_pv else 0,
            "k17_masked_ms": cs.timed(lambda: cold.bloom_flag(*masked))["device_ms"],
            "k17_masked_ms_l2_flushed": cs.cold_l2_ms(
                lambda: cold.bloom_flag(*masked)),
            "flag": int(cold.bloom_flag_plain(
                *masked[:10], torch.zeros((), dtype=torch.int32, device=dev),
                tf.FLAG_COLD)),
            "k1_ms": cs.timed(lambda: ht.lookup_many(looks, tf.MAX_PROBE))["device_ms"],
            "gather_ctx_ms": cs.timed(lambda: tf.build_gather_ctx(
                ledger, soa, valid, postvoid, bloom, None,
                has_postvoid=has_pv))["device_ms"],
            "gather_ctx_calls": cs.runtime_calls(lambda: tf.build_gather_ctx(
                ledger, soa, valid, postvoid, bloom, None, has_postvoid=has_pv)),
        }
        out[name] = r
    lo, hi = plain["id_lo"], plain["id_hi"]
    out["k17_out_ms"] = cs.timed(lambda: cold.bloom_check_impl(bloom, lo, hi))["device_ms"]
    out["k17_out_ms_l2_flushed"] = cs.cold_l2_ms(
        lambda: cold.bloom_check_impl(bloom, lo, hi))
    out["k17_out_hits"] = int(cold.bloom_check_impl(bloom, lo, hi).sum())
    if hasattr(tf, "gather_lookups"):
        # K1 with the step (K17 inside K1's launch): chip_smoke's own check
        # and clock of the flag word at this shape.
        del ledger, bloom, plain, twophase
        torch.cuda.empty_cache()
        out["tier_flag_shape"] = cs.tier_flag_shape(dev)
    return out


def part_k1(cs, dev) -> dict:
    """The main path's three probes, one launch, no overflow flags."""
    import torch
    from tigerbeetle_tpu_torch import convert
    from tigerbeetle_tpu_torch.ops import hash_table as ht
    from tigerbeetle_tpu_torch.ops import state_machine as sm
    from tigerbeetle_tpu_torch.utils.benchgen import gen_batch_np

    i64 = torch.int64
    ids = torch.arange(1, cs.N_ACCOUNTS + 1, dtype=i64, device=dev)
    rows = {c: torch.zeros(len(ids), dtype=dt, device=dev)
            for c, dt in sm.ACCOUNT_COLS.items()}
    rows["ledger"].fill_(1)
    acc = ht.rehash_into(1 << MAIN_ACCOUNTS_LOG2, ids, torch.zeros_like(ids),
                         torch.ones_like(ids, dtype=torch.bool), rows)[0]
    n_rows = MAIN_ROWS
    tids = cs.FIRST_TID + torch.arange(n_rows, dtype=i64, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    rows = {c: torch.randint(0, 1 << 31, (n_rows,), device=dev, generator=gen
                             ).to(dt) for c, dt in sm.TRANSFER_COLS.items()}
    xfr = ht.rehash_into(1 << MAIN_TRANSFERS_LOG2, tids, torch.zeros_like(tids),
                         torch.ones_like(tids, dtype=torch.bool), rows)[0]
    del rows
    soa = convert.batch_to_tensors(
        gen_batch_np(1221, cs.LANES, cs.COUNT, cs.N_ACCOUNTS, cs.FIRST_TID),
        cs.LANES, dev)
    looks = [ht.Lookup(acc, soa["debit_account_id_lo"],
                       soa["debit_account_id_hi"], ("ledger",), count=cs.COUNT),
             ht.Lookup(acc, soa["credit_account_id_lo"],
                       soa["credit_account_id_hi"], ("ledger",), count=cs.COUNT),
             ht.Lookup(xfr, soa["id_lo"], soa["id_hi"],
                       sm.TRANSFER_EXISTS_COLS, count=cs.COUNT)]
    fn = lambda: ht.lookup_many(looks, sm.MAX_PROBE, overflow=False)  # noqa: E731
    return {"three_probes_ms": [cs.timed(fn)["device_ms"] for _ in range(3)],
            "shape": f"debit and credit into 2^{MAIN_ACCOUNTS_LOG2} account "
                     f"slots holding {cs.N_ACCOUNTS}, {cs.COUNT} ids into "
                     f"2^{MAIN_TRANSFERS_LOG2} transfer slots "
                     f"holding {n_rows}, 15 columns"}


def history_log(dev):
    """A log of 2^HIST_LOG2 slots, HIST_ROWS rows below its count over
    accounts 1..HIST_ACCOUNTS (debit and credit never equal), increasing
    timestamps, random balances; zeros above the count."""
    import torch
    from tigerbeetle_tpu_torch.ops import state_machine as sm

    cap = 1 << HIST_LOG2
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    h = sm.make_history(cap, dev)
    n = HIST_ROWS
    dr = torch.randint(1, HIST_ACCOUNTS + 1, (n,), device=dev, generator=gen)
    cr = (dr + torch.randint(0, HIST_ACCOUNTS - 1, (n,), device=dev,
                             generator=gen)) % HIST_ACCOUNTS + 1
    h.cols["dr_id_lo"][:n] = dr
    h.cols["cr_id_lo"][:n] = cr
    h.cols["timestamp"][:n] = 10 ** 12 + 3 * torch.arange(n, device=dev)
    for name, col in h.cols.items():
        if name[3:] not in ("id_lo", "id_hi") and name != "timestamp":
            col[:n] = torch.randint(0, 1 << 62, (n,), device=dev, generator=gen)
    h.count.fill_(n)
    return h


def part_k16(cs, dev) -> dict:
    import inspect

    import numpy as np
    import torch
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.config import LedgerConfig
    from tigerbeetle_tpu_torch.machine import TorchStateMachine
    from tigerbeetle_tpu_torch.ops import _cuda
    from tigerbeetle_tpu_torch.ops import query as q

    h = history_log(dev)
    cap, count, k = h.capacity, HIST_ROWS, 8190
    acct = 17
    m = TorchStateMachine(LedgerConfig(lazy_index=True), batch_lanes=cs.LANES,
                          device=dev)
    acc = np.zeros(HIST_ACCOUNTS, dtype=types.ACCOUNT_DTYPE)
    acc["id_lo"] = np.arange(1, HIST_ACCOUNTS + 1)
    acc["ledger"], acc["code"] = 1, 10
    acc["flags"] = int(types.AccountFlags.HISTORY)
    for s in range(0, HIST_ACCOUNTS, cs.COUNT):
        if m.create_accounts(acc[s:s + cs.COUNT]) != []:
            raise AssertionError("k16: account creation failed")
    m.ledger = dataclasses.replace(m.ledger, history=h)
    c = h.cols
    n_low = int(((c["dr_id_lo"][:count] == acct)
                 | (c["cr_id_lo"][:count] == acct)).sum())
    new_api = "check" in inspect.signature(_cuda.history_scan).parameters
    out = {"shape": f"one history query, k {k}, log 2^{HIST_LOG2} slots holding "
                    f"{count} rows over {HIST_ACCOUNTS} accounts; account {acct}: "
                    f"{n_low} rows",
           # The function's bytes (16 B a row below count, a low-word
           # match's timestamp and high word, the k rows in and out), and
           # with the order check's timestamp of every row besides.
           "bound_ms_bytes": (count * 16 + n_low * 16 + k * (10 * 8 + 1 + 9 * 8))
           / cs.H100_BYTES_PER_S * 1e3,
           "bound_with_order_check_ms_bytes":
               (count * 24 + n_low * 8 + k * (10 * 8 + 1 + 9 * 8))
               / cs.H100_BYTES_PER_S * 1e3}
    for desc in (True, False):
        args = (c, h.count, acct, 0, 1, (1 << 64) - 2, True, True, desc, k)
        if new_api:
            kernel = lambda: _cuda.history_scan(*args, check=False)  # noqa: E731
        else:
            # The parent's wrapper without its error word's fill and read-back.
            lib = _cuda.library()
            src = [c[name] for name in _cuda.HISTORY_COL_ORDER]
            scratch = torch.empty((cap + 1023) // 1024 + 2, dtype=torch.int64,
                                  device=dev)
            err = torch.zeros(1, dtype=torch.int32, device=dev)
            valid = torch.empty(k, dtype=torch.bool, device=dev)
            rows = torch.empty((9, k), dtype=torch.int64, device=dev)

            def kernel(desc=desc, src=src, scratch=scratch, err=err,
                       valid=valid, rows=rows):
                _cuda._raise_on(lib.tb_history_scan(
                    _cuda._ptr_array(src), h.count.data_ptr(), cap, k, acct, 0,
                    1, (1 << 64) - 2, 1, 1, int(desc), scratch.data_ptr(),
                    err.data_ptr(), valid.data_ptr(),
                    _cuda._ptr_array(list(rows.unbind(0))), _cuda._stream(valid)),
                    "history_scan")
        g = q.scan_history(m.ledger, acct, 0, 1, (1 << 64) - 2, True, True, desc, k)
        p = q.scan_history_plain(m.ledger, acct, 0, 1, (1 << 64) - 2, True, True,
                                 desc, k)
        same = torch.equal(g[0], p[0]) and all(torch.equal(g[1][n], p[1][n])
                                               for n in p[1])
        f = np.zeros(1, dtype=types.ACCOUNT_FILTER_DTYPE)[0]
        f["account_id_lo"], f["limit"] = acct, k
        f["flags"] = 3 | (4 if desc else 0)
        out["desc" if desc else "asc"] = {
            "equal_to_plain": same,
            "rows": int(p[0].sum()),
            "kernel_ms": [cs.timed(kernel)["device_ms"] for _ in range(3)],
            "kernel_ms_by_name": cs.profile_by_name(kernel, reps=10),
            "scan_history_wall_ms": wall_ms(lambda: q.scan_history(*(
                (m.ledger,) + args[2:]))),
            "get_account_history_wall_ms": wall_ms(
                lambda: m.get_account_history(f)),
        }
    word = torch.zeros(1, dtype=torch.int32, device=dev)
    out["err_word_fill_ms"] = cs.timed(
        lambda: torch.zeros(1, dtype=torch.int32, device=dev))["device_ms"]
    out["err_word_item_wall_ms"] = wall_ms(lambda: word.item(), reps=50)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT),
                    help="the checkout whose tigerbeetle_tpu_torch is timed")
    ap.add_argument("--parts", default="k17,k1,k16")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    cs = load_chip_smoke()

    import torch

    import tigerbeetle_tpu_torch
    from tigerbeetle_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        print("cold_history_times: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = cs.nvidia_smi()
    tree = str(Path(tigerbeetle_tpu_torch.__file__).resolve().parents[1])
    print(smi, tree, flush=True)
    build_s = _cuda.build_seconds()
    parts = {"k17": part_k17, "k1": part_k1, "k16": part_k16}
    for name in args.parts.split(","):
        t0 = time.perf_counter()
        r = parts[name](cs, dev)
        print(json.dumps({"part": name, "tree": tree, "nvidia_smi": smi,
                          "build_s": build_s,
                          "seconds": time.perf_counter() - t0, **r}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
