"""The batched protocol-model VOPR on the card: thousands of simulated VSR
clusters, each a few KB of state, stepped under a seeded fault schedule and
checked every step by a safety oracle on the device.

The port of ``tigerbeetle_tpu/sim/vopr_tpu.py`` (its docstring describes the
protocol model, the fault repertoire, the oracle and the injected bugs; the
model here is the same, step for step).  The reference vmaps one cluster's
``step`` and runs ``n_steps`` in a ``fori_loop``; here:

- ``draw_faults`` runs kernel K27 ``vopr_draw`` (``csrc/vopr_draw.cu``) on a
  CUDA key tensor, ``draw_faults_plain`` on a CPU one;
- ``step`` runs K28 ``vopr_step`` (``csrc/vopr_step.cu``), one block per
  cluster, on CUDA state, ``step_plain`` on CPU state;
- ``run`` and ``run_sharded`` run K29 ``vopr_run`` (``csrc/vopr_run.cu``):
  one block per cluster derives its key from (seed, cluster index) and runs
  every step with the state on the chip; on the CPU, ``run_plain``.

Every random draw is JAX's threefry bit for bit (``sim/prng.py``,
``csrc/threefry.cuh``), so a seed and a cluster index name the same schedule
in both packages and a violation found on the card replays under JAX.

Layout: the public functions take the reference's layout for one cluster
(``status`` of shape (R,), a key of shape (2,)) or the same with a leading
cluster dimension, which is what ``vmap`` becomes.  u32 fields (``log``,
``log_hdr``, ``canonical``) ride as int32 tensors holding the same bits, and
keys as (..., 2) int32 or int64 tensors of u32 words.

Limits: R in 1..6 (TigerBeetle's replica maximum) and S in 1..``MAX_SLOTS``
(the kernels keep one slot column a thread, one block a cluster); outside
them the functions raise, on either device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as device_mod
from ..vsr.consensus import quorums
from . import prng

# Entry ids keep the top bit clear; CORRUPT is the detectable-damage marker.
CORRUPT = 0x8000_0001
INF = 1 << 28
_CORRUPT_I32 = CORRUPT - (1 << 32)  # CORRUPT's bits in an int32
M32 = 0xFFFFFFFF

MAX_REPLICAS = 6
MAX_SLOTS = 256


class ClusterState(NamedTuple):
    status: torch.Tensor      # (R,) i32: 0 alive, 1 crashed
    view: torch.Tensor        # (R,) i32
    log_view: torch.Tensor    # (R,) i32
    op: torch.Tensor          # (R,) i32 journal head (slot = op % S)
    commit: torch.Tensor      # (R,) i32
    checkpoint: torch.Tensor  # (R,) i32
    adopted_op: torch.Tensor  # (R,) i32 adoption watermark
    durable_op: torch.Tensor  # (R,) i32 journal durability watermark
    log: torch.Tensor         # (R, S) u32 bits in i32 (0 empty, CORRUPT)
    log_hdr: torch.Tensor     # (R, S) u32 bits in i32: the headers ring
    log_op: torch.Tensor      # (R, S) i32 op occupying the slot
    part_active: torch.Tensor  # () bool
    side: torch.Tensor        # (R,) i32 partition side id
    canonical: torch.Tensor   # (MAX_OPS,) u32 bits in i32
    violated: torch.Tensor    # () bool


BUGS = (
    "commit_quorum", "canonical_by_op", "no_truncate", "corrupt_serve",
    "wal_wrap", "split_brain", "amputate_vouch", "join_keep_stale",
    "scrub_off",
)
# The kernels' bug codes (csrc/vopr.cuh's VoprBug): 0 is the clean model.
BUG_CODES = {None: 0, **{b: i + 1 for i, b in enumerate(BUGS)}}

HARSH_FAULTS = dict(
    p_crash=0.08, p_restart=0.3, p_view_change=0.5, p_link=0.5,
    p_repartition=0.15,
)


def _bug_config(bug: Optional[str]):
    R = 5 if bug == "split_brain" else 3
    S = 8 if bug == "wal_wrap" else 32
    probs = dict(HARSH_FAULTS)
    if bug == "amputate_vouch":
        probs.update(p_crash=0.15, p_restart=0.4, p_view_change=0.6,
                     p_link=0.35, p_repartition=0.2, p_amputate=0.6)
    if bug == "scrub_off":
        probs.update(p_sdc=0.3)
    return R, S, probs


# (n_replicas, slots, probabilities) of the clean HARSH model (None) and of
# each bug, as tests/test_vopr.py runs them (R=5 for split_brain, S=8 for
# wal_wrap, amputate_vouch's own probabilities, p_sdc=0.3 for scrub_off).
BUG_CONFIGS = {bug: _bug_config(bug) for bug in (None,) + BUGS}

# draw_faults' defaults, in the order the kernels take them.
PROBS = dict(
    p_crash=0.01, p_restart=0.2, p_append=0.6, p_link=0.7,
    p_view_change=0.3, p_corrupt=0.2, p_repartition=0.05, p_amputate=0.15,
    p_sdc=0.0,
)

# The fault arrays, in the order of csrc/vopr.cuh's VoprFaultField.
FAULT_FIELDS = (
    "sdc", "sdc_slot", "crash", "restart", "corrupt_gate", "corrupt_slot",
    "amputate", "repart", "part_mode", "part_lone", "part_side", "append",
    "link", "vc", "sync",
)
FAULT_DTYPES = {
    "sdc_slot": torch.int64, "corrupt_slot": torch.int64,
    "part_mode": torch.int64, "part_lone": torch.int64,
    "part_side": torch.int32,
}
_SCALAR_FAULTS = ("repart", "part_mode", "part_lone")
# The state's fields, in the order of csrc/vopr.cuh's VoprStateField.
STATE_FIELDS = ClusterState._fields


def _check_shape(n_replicas: int, slots: int) -> None:
    if not 1 <= n_replicas <= MAX_REPLICAS:
        raise ValueError(f"n_replicas must be in 1..{MAX_REPLICAS}")
    if not 1 <= slots <= MAX_SLOTS:
        raise ValueError(f"slots must be in 1..{MAX_SLOTS}")


def _probs(probs: dict) -> Dict[str, float]:
    bad = set(probs) - set(PROBS)
    if bad:
        raise TypeError(f"unknown fault probabilities {sorted(bad)}")
    return {k: float(probs.get(k, v)) for k, v in PROBS.items()}


def _bug_code(bug: Optional[str]) -> int:
    if bug not in BUG_CODES:
        raise ValueError(f"unknown bug {bug!r}; one of {BUGS}")
    return BUG_CODES[bug]


# -- state -------------------------------------------------------------------


def make_state(n_replicas: int, slots: int, max_ops: int,
               n_clusters: Optional[int] = None, device=None) -> ClusterState:
    """The empty state of one cluster, or of ``n_clusters`` stacked."""
    _check_shape(n_replicas, slots)
    dev = device_mod.resolve(device)
    lead = () if n_clusters is None else (n_clusters,)
    R, S = n_replicas, slots

    def z(*shape, dtype=torch.int32):
        return torch.zeros(lead + shape, dtype=dtype, device=dev)

    return ClusterState(
        z(R), z(R), z(R), z(R), z(R), z(R), z(R), z(R),
        z(R, S), z(R, S), z(R, S), z(dtype=torch.bool), z(R), z(max_ops),
        z(dtype=torch.bool),
    )


def _batched(state: ClusterState) -> bool:
    return state.status.dim() == 2


def _unbatch(state: ClusterState) -> ClusterState:
    return ClusterState(*(t[0] for t in state))


def _batch(state: ClusterState) -> ClusterState:
    return ClusterState(*(t.unsqueeze(0) for t in state))


def _entry(view: torch.Tensor, op: torch.Tensor) -> torch.Tensor:
    """Unique nonzero id for the prepare created at (view, op), u32 math
    (wrapping products) in int64; the id has its top bit clear."""
    h = (((view.long() & M32) * 2654435761) & M32) ^ (
        ((op.long() & M32) * 40503) & M32)
    return ((h & 0x7FFF_FFFF) | 1).to(torch.int32)


# -- faults --------------------------------------------------------------------


_GATES = ("sdc", "crash", "restart", "corrupt_gate", "amputate", "part_side",
          "append", "link", "vc", "sync")


def draw_faults_plain(keys: torch.Tensor, n_replicas: int, slots: int,
                      **probs) -> dict:
    """``draw_faults`` for a batch of keys (N, 2) in plain PyTorch: each
    draw of the reference, bit for bit.  Arrays lead with N.

    The reference's threefry calls are batched by their depth in the key
    tree, four hashes a step: (1) ``split(key, 10)`` and ``fold_in(key,
    0x5DC)``; (2) ``split(k_part, 4)`` and ``split(k_sdc)``; (3) the
    Bernoulli draws (ten (R,) gates and the repartition gate) and the
    randint keys' splits; (4) the randint draws."""
    _check_shape(n_replicas, slots)
    p = _probs(probs)
    R, S = n_replicas, slots

    def hashes(pairs):
        return prng.hash_keys(torch.stack([k for k, _ in pairs], -2),
                              [c for _, c in pairs]).unbind(-2)

    (k_crash, k_restart, k_cgate, k_cslot, k_part, k_append, k_link, k_vc,
     k_sync, k_amp, k_sdc) = hashes([(keys, c) for c in range(10)]
                                    + [(keys, 0x5DC)])
    k_pm, k_pg, k_ps, k_pw, k_sdc_gate, k_sdc_slot = hashes(
        [(k_part, c) for c in range(4)] + [(k_sdc, 0), (k_sdc, 1)])
    gate_keys = (k_sdc_gate, k_crash, k_restart, k_cgate, k_amp, k_ps,
                 k_append, k_link, k_vc, k_sync)
    randint_keys = (k_sdc_slot, k_cslot, k_pm, k_pw)
    third = hashes([(k, r) for k in gate_keys for r in range(R)]
                   + [(k_pg, 0)]
                   + [(k, c) for k in randint_keys for c in (0, 1)])
    bits = torch.stack(third[:10 * R + 1], -2)
    u = prng.uniform_of_words(bits[..., 0], bits[..., 1])
    thresh = [p["p_sdc"], p["p_crash"], p["p_restart"], p["p_corrupt"],
              p["p_amputate"], 0.5, p["p_append"], p["p_link"],
              p["p_view_change"], 0.5]
    hit = u[..., :10 * R].reshape(*u.shape[:-1], 10, R) < prng.const(
        tuple(thresh), torch.float64, keys.device)[:, None]
    out = {name: hit[..., i, :] for i, name in enumerate(_GATES)}
    out["part_side"] = out["part_side"].to(torch.int32)
    out["repart"] = u[..., 10 * R] < p["p_repartition"]
    # randint: split(k)[0] draws the high 64 bits, split(k)[1] the low.
    s0, s1, c0, c1, m0, m1, w0, w1 = third[10 * R + 1:]
    fourth = hashes([(k, r) for k in (s0, s1, c0, c1) for r in range(R)]
                    + [(m0, 0), (m1, 0), (w0, 0), (w1, 0)])
    words = torch.stack(fourth, -2)

    def draw64(i, n):
        return words[..., i:i + n, 0], words[..., i:i + n, 1]

    out["sdc_slot"] = prng.randint_of_words(draw64(0, R), draw64(R, R), 0, S)
    out["corrupt_slot"] = prng.randint_of_words(draw64(2 * R, R),
                                                draw64(3 * R, R), 0, S)
    out["part_mode"] = prng.randint_of_words(draw64(4 * R, 1),
                                             draw64(4 * R + 1, 1), 0, 4)[..., 0]
    out["part_lone"] = prng.randint_of_words(draw64(4 * R + 2, 1),
                                             draw64(4 * R + 3, 1), 0, R)[..., 0]
    return {name: out[name].contiguous() for name in FAULT_FIELDS}


def draw_consts(n_replicas: int, slots: int, probs: Sequence[float]
                ) -> Tuple[int, ...]:
    """The kernels' draw constants (``csrc/vopr.cuh`` VoprDrawConsts) as
    u64 words: the Bernoulli threshold of each of ``probs`` (in ``PROBS``
    order), then the randint spans S, 4 and R (``prng.span_consts``)."""
    if len(probs) != len(PROBS):
        raise ValueError(f"{len(PROBS)} probabilities, in PROBS order")
    words = [prng.bernoulli_threshold(p) for p in probs]
    for span in (slots, 4, n_replicas):
        words += prng.span_consts(span)
    return tuple(words)


def draw_faults(key: torch.Tensor, n_replicas: int, slots: int,
                **probs) -> dict:
    """One step's fault and schedule draws (the reference's ``draw_faults``)
    for a key (2,) or a batch of keys (N, 2): kernel K27 for a CUDA key,
    the plain version for a CPU one."""
    single = key.dim() == 1
    keys = key.reshape(-1, 2)
    if keys.is_cuda:
        from ..ops import _cuda

        _check_shape(n_replicas, slots)
        out = _cuda.vopr_draw(keys.to(torch.int32).contiguous(), n_replicas,
                              slots, tuple(_probs(probs).values()))
    else:
        out = draw_faults_plain(keys, n_replicas, slots, **probs)
    return {k: v[0] for k, v in out.items()} if single else out


# -- one step ------------------------------------------------------------------


def _rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[n, idx[n, r], :]`` for ring arrays (N, R, S) and indexes (N, R)."""
    return torch.gather(a, 1, idx[:, :, None].expand(-1, -1, a.shape[2]))


def _at(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[n, idx[n, r]]`` for replica arrays (N, R)."""
    return torch.gather(a, 1, idx)


def step_plain(state: ClusterState, faults: dict, *, n_replicas: int,
               slots: int, max_ops: int, bug: Optional[str] = None
               ) -> ClusterState:
    """One step of a batch of clusters (every field leads with N) under
    pre-drawn faults, in plain PyTorch: the reference's ``step`` line for
    line, ``vmap`` written out as the leading dimension."""
    _check_shape(n_replicas, slots)
    _bug_code(bug)
    R, S = n_replicas, slots
    q_repl, q_view = quorums(R)
    if bug == "commit_quorum":
        q_repl = max(1, q_repl - 1)
    if bug == "split_brain":
        q_view = 1
    ckpt_interval = max(1, S // 2)
    W = torch.where
    f = faults
    (status, view, log_view, op, commit, checkpoint, adopted_op, durable_op,
     log, log_hdr, log_op, part_active, side, canonical, violated) = state
    dev = status.device
    rids = torch.arange(R, device=dev)
    sidx = torch.arange(S, device=dev)
    eye = torch.eye(R, dtype=torch.bool, device=dev)
    commit0 = commit

    # 1. Crashes, restarts, crash-time corruption and suffix amputation.
    crash = f["crash"] & (status == 0)
    restart = f["restart"] & (status == 1)
    status = W(crash, 1, W(restart, 0, status))
    hit = (f["corrupt_gate"] & crash)[:, :, None] & (
        sidx == f["corrupt_slot"][:, :, None]) & (log_op >= 1)
    log = W(hit, _CORRUPT_I32, log)
    amputate = f["amputate"] & crash
    amp_floor = torch.maximum(commit, durable_op)
    amp_hit = amputate[:, :, None] & (log_op > amp_floor[:, :, None]) & (
        log_op <= op[:, :, None])
    log = W(amp_hit, 0, log)
    log_hdr = W(amp_hit, 0, log_hdr)
    log_op = W(amp_hit, 0, log_op)
    op = W(amputate, amp_floor, op)
    alive = status == 0

    # 1b. Silent SDC, then the scrub.
    sdc_hit = (f["sdc"] & alive)[:, :, None] & (
        sidx == f["sdc_slot"][:, :, None]) & (log_op >= 1) & (log != 0) & (
        log != _CORRUPT_I32)
    log = W(sdc_hit, log ^ 2, log)
    if bug != "scrub_off":
        silent = (log != log_hdr) & (log != 0) & (log_hdr != 0) & (
            log != _CORRUPT_I32)
        log = W(silent, _CORRUPT_I32, log)

    # 2. Partitions.
    repart, mode, lone = f["repart"], f["part_mode"], f["part_lone"]
    new_side = W((mode == 2)[:, None], (rids == lone[:, None]).to(torch.int32),
                 f["part_side"])
    side = W(repart[:, None], new_side, side)
    part_active = W(repart, mode >= 2, part_active)
    conn = (~part_active)[:, None, None] | (side[:, :, None] == side[:, None, :])
    conn = conn | eye
    link_up = f["link"]

    # 3. Perceived views.
    reach = conn & alive[:, None, :]
    perceived = W(reach, view[:, None, :], 0).amax(dim=2)
    perceived = torch.maximum(perceived, view)
    prim = (perceived % R).long()
    connP = torch.gather(conn, 2, prim[:, :, None])[:, :, 0]
    aliveP = _at(alive, prim)
    currentP = _at(log_view, prim) == perceived
    p_current_for = aliveP & currentP & connP
    acting = alive & (prim == rids) & (log_view == perceived)

    # 4. Joiner install.
    joiner = alive & (log_view < perceived) & p_current_for & link_up
    logP, log_hdrP, log_opP = _rows(log, prim), _rows(log_hdr, prim), \
        _rows(log_op, prim)
    opP, ckptP = _at(op, prim), _at(checkpoint, prim)
    if bug == "join_keep_stale":
        fresh = joiner[:, :, None] & (log == 0)
        log = W(fresh, logP, log)
        log_hdr = W(fresh, log_hdrP, log_hdr)
        log_op = W(fresh, log_opP, log_op)
        op = W(joiner, opP, op)
        checkpoint = W(joiner, torch.maximum(checkpoint, ckptP), checkpoint)
    elif bug != "no_truncate":
        J = joiner[:, :, None]
        log = W(J, logP, log)
        log_hdr = W(J, log_hdrP, log_hdr)
        log_op = W(J, log_opP, log_op)
        op = W(joiner, opP, op)
        checkpoint = W(joiner, torch.maximum(checkpoint, ckptP), checkpoint)
    log_view = W(joiner, perceived, log_view)
    view = W(joiner, perceived, view)
    adopted_op = W(joiner, opP, adopted_op)
    durable_op = W(joiner, torch.minimum(durable_op, op), durable_op)

    # 5. Acting primaries append.
    new_op = op + 1
    floor_ok = (new_op - checkpoint) <= S
    if bug == "wal_wrap":
        floor_ok = torch.ones_like(floor_ok)
    can_append = acting & floor_ok & (new_op < max_ops - 1) & f["append"]
    app_entry = _entry(perceived, new_op)
    app_write = can_append[:, :, None] & (sidx == (new_op % S)[:, :, None])
    log = W(app_write, app_entry[:, :, None], log)
    log_hdr = W(app_write, app_entry[:, :, None], log_hdr)
    log_op = W(app_write, new_op[:, :, None], log_op)
    op = W(can_append, new_op, op)
    durable_op = W(can_append, new_op, durable_op)

    # 6. Primary self-repair by checksum, (r, donor, slot).
    donor_ok = alive[:, None, :, None] & conn[:, :, :, None] & (
        log_op[:, None, :, :] == log_op[:, :, None, :]) & (
        log[:, None, :, :] != _CORRUPT_I32) & (log[:, None, :, :] != 0)
    if bug != "corrupt_serve":
        donor_ok = donor_ok & (log[:, None, :, :] == log_hdr[:, :, None, :])
    donor_entry = W(donor_ok, log[:, None, :, :].long() & M32, 0).amax(dim=2)
    fixable = acting[:, :, None] & (log == _CORRUPT_I32) & (donor_entry != 0)
    log = W(fixable, donor_entry.to(torch.int32), log)

    logP, log_opP = _rows(log, prim), _rows(log_op, prim)
    opP, ckptP = _at(op, prim), _at(checkpoint, prim)

    # 7. Matching prefix against the perceived primary.
    def prefix_vs_primary(log, log_op, logP, log_opP, opP):
        entry_differs = log != logP
        if bug == "corrupt_serve":
            entry_differs = entry_differs & (log != _CORRUPT_I32)
        mismatch = entry_differs & (log_opP >= 1)
        if bug != "wal_wrap":
            mismatch = mismatch | ((log_op != log_opP) & (log_opP >= 1))
        if bug == "join_keep_stale":
            mismatch = (log == 0) & (log_opP >= 1)
        first_bad = W(mismatch, log_opP, INF).amin(dim=2)
        return first_bad, torch.minimum(first_bad - 1, opP)

    first_bad, prefix_ok = prefix_vs_primary(log, log_op, logP, log_opP, opP)

    # 8. Backup repair: slot sync, or state sync past the floor.
    is_backup = alive & ~acting & p_current_for & (log_view == perceived)
    target = torch.minimum(first_bad, op + 1)
    t_slot = target % S
    t_in_ring = torch.gather(log_opP, 2, t_slot[:, :, None].long())[:, :, 0] \
        == target
    if bug == "wal_wrap":
        t_in_ring = torch.ones_like(t_in_ring)
    reachable = is_backup & link_up & (target <= opP)
    can_sync = reachable & t_in_ring
    sync_write = can_sync[:, :, None] & (sidx == t_slot[:, :, None])
    log = W(sync_write, logP, log)
    log_hdr = W(sync_write, _rows(log_hdr, prim), log_hdr)
    if bug == "wal_wrap":
        log_op = W(sync_write, target[:, :, None], log_op)
    else:
        log_op = W(sync_write, log_opP, log_op)
    op = W(can_sync, torch.maximum(op, target), op)
    durable_op = W(can_sync & (target == durable_op + 1), target, durable_op)

    state_sync = reachable & ~t_in_ring & f["sync"]
    SS = state_sync[:, :, None]
    log = W(SS, logP, log)
    log_hdr = W(SS, _rows(log_hdr, prim), log_hdr)
    log_op = W(SS, log_opP, log_op)
    op = W(state_sync, opP, op)
    checkpoint = W(state_sync, torch.maximum(checkpoint, ckptP), checkpoint)
    commit = W(state_sync, torch.maximum(commit, ckptP), commit)
    adopted_op = W(state_sync, opP, adopted_op)
    durable_op = W(state_sync, opP, durable_op)

    logP, log_opP = _rows(log, prim), _rows(log_op, prim)
    first_bad, prefix_ok = prefix_vs_primary(log, log_op, logP, log_opP,
                                             _at(op, prim))

    # Body fetch.
    fetch_chunk = max(1, S // 8)
    fetched = is_backup & link_up & (first_bad > op) & (durable_op < op)
    durable_op = W(fetched, torch.minimum(
        op, torch.maximum(durable_op, commit) + fetch_chunk), durable_op)

    # 9. Commit at a replication quorum of acks.
    k_op = _at(commit, prim) + 1
    ack = alive & (log_view == perceived) & connP & (op >= k_op)
    if bug != "no_truncate":
        ack = ack & (prefix_ok >= k_op) & (durable_op >= k_op)
    ack_count = torch.zeros_like(op).scatter_add_(1, prim, ack.to(torch.int32))
    k_self = commit + 1
    k_slot = (k_self % S).long()[:, :, None]
    e_k = torch.gather(log, 2, k_slot)[:, :, 0]
    e_k_op = torch.gather(log_op, 2, k_slot)[:, :, 0]
    entry_valid = (e_k_op == k_self) & (e_k != 0)
    if bug != "corrupt_serve":
        entry_valid = entry_valid & (e_k != _CORRUPT_I32)
    can_commit = acting & (k_self <= op) & (ack_count >= q_repl) & entry_valid
    commit = W(can_commit, k_self, commit)

    # 10. Commit heartbeat.
    hb = torch.minimum(torch.minimum(_at(commit, prim), prefix_ok), durable_op)
    if bug == "no_truncate":
        hb = _at(commit, prim)
    commit = W(is_backup & link_up & connP, torch.maximum(commit, hb), commit)

    # 11. Checkpoint advance.
    new_ckpt = (commit // ckpt_interval) * ckpt_interval
    checkpoint = W(alive & (commit - checkpoint >= ckpt_interval),
                   torch.maximum(checkpoint, new_ckpt), checkpoint)

    # 12. View change.
    dead_prim = alive & (~aliveP | ~connP)
    same_view = perceived[:, :, None] == perceived[:, None, :]
    svc = dead_prim & f["vc"]
    participant = alive[:, None, :] & conn & same_view & svc[:, None, :]
    suspect = op < adopted_op
    if bug != "amputate_vouch":
        clean_donor_ok = participant & ~suspect[:, None, :]
    else:
        clean_donor_ok = participant
    cnt = clean_donor_ok.sum(dim=2)
    fire = svc & (cnt >= q_view)
    new_view = perceived + 1
    new_prim = new_view % R
    inst = fire & (new_prim == rids)
    penalty = W(clean_donor_ok, 0, 1 << 60)
    if bug == "canonical_by_op":
        rank = op[:, None, :].long() - penalty
    else:
        rank = (log_view[:, None, :].long() * (max_ops + S)
                + op[:, None, :].long() - penalty)
    donor = rank.argmax(dim=2)  # the first maximum, as jnp.argmax
    I = inst[:, :, None]
    log = W(I, _rows(log, donor), log)
    log_hdr = W(I, _rows(log_hdr, donor), log_hdr)
    log_op = W(I, _rows(log_op, donor), log_op)
    op = W(inst, _at(op, donor), op)
    commit = W(inst, torch.maximum(commit, _at(commit, donor)), commit)
    checkpoint = W(inst, torch.maximum(checkpoint, _at(checkpoint, donor)),
                   checkpoint)
    log_view = W(inst, new_view, log_view)
    # As the reference: op[donor] after this step's install of op.
    adopted_op = W(inst, _at(op, donor), adopted_op)
    durable_op = W(inst, _at(op, donor), durable_op)
    bumped = (I & participant).any(dim=1)
    view = W((bumped | inst) & alive, torch.maximum(view, new_view), view)

    # 13. Safety oracle: the canonical commit list, first writer wins
    # (u32 order: the max of a slot's proposals compares unsigned).
    N = status.shape[0]
    log_u = log.long() & M32
    committed = (log_op > commit0[:, :, None]) & (
        log_op <= commit[:, :, None]) & (log_op >= 1)
    if bug != "corrupt_serve":
        committed = committed & (log != _CORRUPT_I32)
    idx = W(committed, log_op, 0).long().reshape(N, -1)
    vals = W(committed, log_u, 0).reshape(N, -1)
    proposals = torch.zeros(N, max_ops, dtype=torch.int64, device=dev)
    proposals.scatter_reduce_(1, idx, vals, "amax")
    canon = canonical.long() & M32
    first = (canon == 0) & (torch.arange(max_ops, device=dev) >= 1)
    canon = W(first, proposals, canon)
    conflict = committed.reshape(N, -1) & (torch.gather(canon, 1, idx) != vals)
    violated = violated | conflict.any(dim=1)
    below = ((log_op >= 1) & (log_op <= commit[:, :, None])
             & (log != _CORRUPT_I32)).reshape(N, -1)
    want = torch.gather(canon, 1, W(below, log_op.reshape(N, -1), 0).long())
    violated = violated | (below & (want != 0)
                           & (want != log_u.reshape(N, -1))).any(dim=1)

    i32 = torch.int32
    return ClusterState(
        status.to(i32), view.to(i32), log_view.to(i32), op.to(i32),
        commit.to(i32), checkpoint.to(i32), adopted_op.to(i32),
        durable_op.to(i32), log.to(i32), log_hdr.to(i32), log_op.to(i32),
        part_active, side.to(i32), canon.to(i32), violated,
    )


def step(state: ClusterState, key: Optional[torch.Tensor] = None, *,
         n_replicas: int, slots: int, max_ops: int,
         bug: Optional[str] = None, faults: Optional[dict] = None,
         **probs) -> ClusterState:
    """One simulation step for one cluster, or for a batch (every field
    leading with N), as the reference's ``step``.  ``faults`` (a
    ``draw_faults`` dict of the same layout) overrides the draws from
    ``key``.  CUDA state steps in kernel K28 (the draws in K27); CPU state
    in the plain version."""
    _check_shape(n_replicas, slots)
    code = _bug_code(bug)
    p = _probs(probs)
    single = not _batched(state)
    if single:
        state = _batch(state)
    if faults is None:
        if key is None:
            raise TypeError("step needs a key or faults")
        if key.device != state.status.device:
            raise ValueError(f"the key is on {key.device}, the state on "
                             f"{state.status.device}")
        faults = draw_faults(key.reshape(-1, 2), n_replicas, slots, **p)
    elif single:
        faults = {k: v.unsqueeze(0) for k, v in faults.items()}
    if state.status.is_cuda:
        from ..ops import _cuda

        out = ClusterState(*_cuda.vopr_step(
            list(state), [faults[k] for k in FAULT_FIELDS], n_replicas,
            slots, max_ops, code))
    else:
        out = step_plain(state, faults, n_replicas=n_replicas, slots=slots,
                         max_ops=max_ops, bug=bug)
    return _unbatch(out) if single else out


# -- whole schedules -----------------------------------------------------------


def cluster_keys(seed: int, start: int, count: int,
                 device=None) -> torch.Tensor:
    """The keys of clusters start .. start + count - 1: the reference's
    ``jax.random.split(jax.random.PRNGKey(seed), n_clusters)[start:]``, which
    do not depend on ``n_clusters``; on the card unless ``device`` names
    another."""
    return prng.split(prng.PRNGKey(seed, device), count, start)


def _one_cluster_fn(n_steps: int, n_replicas: int, slots: int,
                    bug: Optional[str], probs: dict):
    """The reference's per-cluster schedule function, in plain PyTorch over
    a batch of cluster keys (N, 2): from ``make_state``, ``n_steps`` times
    ``key, sub = split(key)``, ``draw_faults(sub)``, ``step``.  It returns
    the final states (the reference keeps only ``violated``)."""
    max_ops = n_steps + 2

    def one_cluster(keys: torch.Tensor) -> ClusterState:
        state = make_state(n_replicas, slots, max_ops, keys.shape[0],
                           keys.device)
        key = keys
        for _ in range(n_steps):
            ks = prng.split(key, 2)
            key, sub = ks[:, 0], ks[:, 1]
            faults = draw_faults_plain(sub, n_replicas, slots, **probs)
            state = step_plain(state, faults, n_replicas=n_replicas,
                               slots=slots, max_ops=max_ops, bug=bug)
        return state

    return one_cluster


def run_plain(seed: int, start: int, count: int, n_steps: int,
              n_replicas: int, slots: int, bug: Optional[str], device,
              **probs) -> ClusterState:
    """The final states of clusters start .. start + count - 1 after
    ``n_steps``, in plain PyTorch (``_one_cluster_fn`` on their keys)."""
    one_cluster = _one_cluster_fn(n_steps, n_replicas, slots, bug,
                                  _probs(probs))
    return one_cluster(cluster_keys(seed, start, count, device))


def _run_block(seed: int, start: int, count: int, n_steps: int,
               n_replicas: int, slots: int, bug: Optional[str], dev,
               final_state: bool, probs: dict):
    """Clusters start .. start + count - 1 on one device: K29 on a card,
    the plain loop on the CPU.  (violated, final state or None)."""
    _check_shape(n_replicas, slots)
    code = _bug_code(bug)
    p = _probs(probs)
    if n_steps < 0:
        raise ValueError("n_steps must be >= 0")
    if dev.type == "cuda":
        from ..ops import _cuda

        with torch.cuda.device(dev):
            violated, fields = _cuda.vopr_run(
                prng.seed_words(seed), start, count, n_steps, n_replicas,
                slots, tuple(p.values()), code, dev, final_state)
        return violated, (ClusterState(*fields) if final_state else None)
    state = run_plain(seed, start, count, n_steps, n_replicas, slots, bug,
                      dev, **p)
    return state.violated, (state if final_state else None)


def run(seed: int, n_clusters: int, n_steps: int, n_replicas: int = 3,
        slots: int = 32, bug: Optional[str] = None, *, device=None,
        final_state: bool = False, **probs):
    """Simulate ``n_clusters`` independent fault schedules for ``n_steps``;
    the per-cluster violation flags as a numpy bool array (all False unless
    a ``bug`` is injected).  On the card unless ``device="cpu"``.  With
    ``final_state``, (flags, the final ``ClusterState`` of the batch)."""
    dev = device_mod.resolve(device)
    violated, state = _run_block(seed, 0, n_clusters, n_steps, n_replicas,
                                 slots, bug, dev, final_state, probs)
    flags = violated.cpu().numpy()
    return (flags, state) if final_state else flags


def run_sharded(seed: int, n_clusters: int, n_steps: int,
                devices: Optional[Sequence] = None, *, device=None,
                **kwargs) -> np.ndarray:
    """The reference's ``run_sharded``: the cluster range padded to a
    multiple of the device count and cut into contiguous blocks, one per
    device (its ``P("vopr")`` sharding); each device runs its block with
    its base cluster index.  ``devices`` defaults to every card (or
    ``[device]`` when one is named).  On one device it equals ``run``; a
    cluster's flag never depends on the padding."""
    if devices is None:
        if device is None:
            device_mod.resolve(None)  # raises without a card
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [device_mod.resolve(device)]
    devices = [torch.device(d) for d in devices]
    n_replicas = kwargs.pop("n_replicas", 3)
    slots = kwargs.pop("slots", 32)
    bug = kwargs.pop("bug", None)
    n_dev = len(devices)
    per = (n_clusters + n_dev - 1) // n_dev
    parts = [
        _run_block(seed, i * per, per, n_steps, n_replicas, slots, bug, d,
                   False, kwargs)[0]
        for i, d in enumerate(devices)
    ]
    return torch.cat([v.cpu() for v in parts]).numpy()
