"""Merkle commitment forest over the ledger pads (port of
``tigerbeetle_tpu/ops/merkle.py``).

- LEAVES: per-slot row folds, exactly the scrub fold's addends
  (``scrub.leaf_hashes`` / ``row_hash_*``): an empty slot commits to 0.
- INTERIOR: node = mix64(left, right), one int64[2 * capacity] heap per pad
  (u64 bits; root at [1], children of i at [2i, 2i+1], leaves at
  [capacity + slot], cell [0] unused).
- BUILD (``build_forest``) and VERIFY (``verify_roots``): kernel K22
  (``csrc/merkle_build.cu``) on CUDA tensors, a tile of 1,024 nodes a block
  reduced in shared memory, one launch per ten levels; the verify recomputes
  the three roots without writing a heap and stacks them under the
  maintained roots, one (2, 3) read-back.
- INCREMENTAL UPDATE (``update_accounts`` / ``update_transfers``): the
  touched keys are probed (K1), then kernel K23 (``csrc/merkle_touch.cu``)
  rewrites their leaves from the tables' current rows and recombines their
  ancestors level by level, a barrier between levels.  Post/void lanes
  resolve the pending transfer on the device (K1 with a gather) to its
  posted key (its timestamp) and its account sides.
- PROOFS (``gather_path``): K23's path entry reads one slot's leaf,
  siblings and root.

The plain PyTorch versions (``tree_from_leaves``, ``root_from_leaves``,
``build_forest_impl``, ``verify_roots_impl``, ``_leaf_at``,
``touch_tree_plain``) run on CPU tensors.  Heaps are updated in place where
the JAX package donated them.  ``Forest`` is a plain dataclass of the three
heaps (the reference's is a ``flax.struct``).

The host twins (``np_*``), the proof format (``encode_proof``,
``check_proof``) and ``coalesce_touch_records`` are numpy, kept line for line
with the reference (``tests/test_torch_kernels.py`` compares them), apart
from ``_np_table_cols`` reading the port's tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from .. import convert
from ..u128 import mix64
from . import _cuda
from . import hash_table as ht
from . import state_machine as sm
from .scrub import (
    ROW_HASH, leaf_hashes, mix64_np, row_hash_accounts, row_hash_posted,
    row_hash_transfers,
)

U64_MASK = (1 << 64) - 1

PADS = ("accounts", "transfers", "posted")
# The value columns each pad's leaf folds (the per-lane leaf gather's).
_LEAF_COLS = _cuda.PAD_COLS


@dataclasses.dataclass
class Forest:
    """The three per-pad Merkle heaps (int64[2 * capacity] each, u64 bits)."""

    accounts: torch.Tensor
    transfers: torch.Tensor
    posted: torch.Tensor

    def pad(self, name: str) -> torch.Tensor:
        return getattr(self, name)


# ---------------------------------------------------------------------------
# Build and verify (kernel K22; plain PyTorch beside it)
# ---------------------------------------------------------------------------


def tree_from_leaves(leaves: torch.Tensor) -> torch.Tensor:
    """Heap-layout tree from a power-of-two leaf level: concatenated
    levels root-first, [unused, root, level2 (2), ..., leaves (C)]."""
    levels = [leaves]
    while levels[-1].shape[0] > 1:
        prev = levels[-1]
        levels.append(mix64(prev[0::2], prev[1::2]))
    return torch.cat(
        [torch.zeros(1, dtype=torch.int64, device=leaves.device)]
        + levels[::-1])


def root_from_leaves(leaves: torch.Tensor) -> torch.Tensor:
    """The root alone (no heap: the verify reduction)."""
    while leaves.shape[0] > 1:
        leaves = mix64(leaves[0::2], leaves[1::2])
    return leaves[0]


def build_forest_impl(ledger: sm.Ledger) -> Forest:
    """Plain PyTorch version of kernel K22's heap mode."""
    return Forest(
        accounts=tree_from_leaves(
            leaf_hashes(ledger.accounts, row_hash_accounts)
        ),
        transfers=tree_from_leaves(
            leaf_hashes(ledger.transfers, row_hash_transfers)
        ),
        posted=tree_from_leaves(
            leaf_hashes(ledger.posted, row_hash_posted)
        ),
    )


def build_forest(ledger: sm.Ledger) -> Forest:
    """The three heaps, from the ledger (never changed).  Kernel K22 on
    CUDA tensors."""
    if not ledger.accounts.key_lo.is_cuda:
        return build_forest_impl(ledger)
    heaps = {}
    for name in PADS:
        t = getattr(ledger, name)
        heaps[name] = torch.empty(2 * t.capacity, dtype=torch.int64,
                                  device=t.device)
        _cuda.merkle_build(name, t.key_lo, t.key_hi, t.cols,
                           heap=heaps[name])
    return Forest(**heaps)


def forest_roots(forest: Forest) -> torch.Tensor:
    """int64[3] = (accounts, transfers, posted) maintained roots."""
    return torch.stack([
        forest.accounts[1], forest.transfers[1], forest.posted[1]
    ])


def verify_roots_impl(forest: Forest, ledger: sm.Ledger) -> torch.Tensor:
    """Plain PyTorch version of ``verify_roots``."""
    recomputed = torch.stack([
        root_from_leaves(leaf_hashes(ledger.accounts, row_hash_accounts)),
        root_from_leaves(leaf_hashes(ledger.transfers, row_hash_transfers)),
        root_from_leaves(leaf_hashes(ledger.posted, row_hash_posted)),
    ])
    return torch.stack([forest_roots(forest), recomputed])


def verify_roots(forest: Forest, ledger: sm.Ledger) -> torch.Tensor:
    """int64[2, 3]: row 0 the maintained roots, row 1 the roots recomputed
    from the pads, compared on the host after ONE read-back.  Kernel K22's
    root-only mode on CUDA tensors (no heap is written)."""
    if not ledger.accounts.key_lo.is_cuda:
        return verify_roots_impl(forest, ledger)
    roots = torch.empty(3, dtype=torch.int64, device=ledger.device)
    for k, name in enumerate(PADS):
        t = getattr(ledger, name)
        _cuda.merkle_build(name, t.key_lo, t.key_hi, t.cols,
                           root_out=roots[k:k + 1])
    return torch.stack([forest_roots(forest), roots])


# ---------------------------------------------------------------------------
# Touched-path updates (K1, then kernel K23; plain PyTorch beside it)
# ---------------------------------------------------------------------------


def _leaf_at(table: ht.Table, slot: torch.Tensor, found: torch.Tensor,
             pad: str) -> torch.Tensor:
    """The leaf value at ``slot`` for found lanes: the row fold over the
    table's current content, so repeated touches of one slot agree."""
    safe = torch.where(found, slot, torch.zeros_like(slot))
    cols = {name: table.cols[name][safe] for name in _LEAF_COLS[pad]}
    key_lo = table.key_lo[safe]
    key_hi = table.key_hi[safe]
    live = (key_lo != 0) | (key_hi != 0)
    h = ROW_HASH[pad](key_lo, key_hi, cols)
    return torch.where(live, h, torch.zeros_like(h))


def touch_tree_plain(nodes: torch.Tensor, table: ht.Table,
                     slot: torch.Tensor, found: torch.Tensor,
                     pad: str) -> torch.Tensor:
    """Plain PyTorch version of kernel K23's touch (in place): rewrite the
    found lanes' leaves, then recombine their ancestors for log2(capacity)
    levels; lanes sharing a node write the same value."""
    cap = table.capacity
    do = found
    leaf = _leaf_at(table, slot, do, pad)
    idx = cap + slot
    nodes[idx[do]] = leaf[do]
    parent = idx >> 1
    zero = torch.zeros_like(parent)
    for _ in range(max(0, cap.bit_length() - 1)):
        val = mix64(nodes[torch.where(do, parent * 2, zero)],
                    nodes[torch.where(do, parent * 2 + 1, zero)])
        nodes[parent[do]] = val[do]
        parent = parent >> 1
    return nodes


def touch_tree(nodes: torch.Tensor, table: ht.Table, key_lo: torch.Tensor,
               key_hi: torch.Tensor, pad: str, max_probe: int,
               hash_shift: int = 0) -> torch.Tensor:
    """Refresh, in place, the leaf->root paths of the rows holding ``key``:
    a probe (K1), then the leaf rewrite and log2(capacity) level recombines
    (K23 on CUDA tensors).  Missing keys (rejected lanes, zero padding) are
    skipped."""
    look = ht.lookup(table, key_lo, key_hi, max_probe, hash_shift)
    if nodes.is_cuda:
        _cuda.merkle_touch(pad, table.key_lo, table.key_hi, table.cols, nodes,
                           look.slot, look.found)
        return nodes
    return touch_tree_plain(nodes, table, look.slot, look.found, pad)


def update_accounts_impl(forest: Forest, ledger: sm.Ledger,
                         acc_lo, acc_hi, *, max_probe: int,
                         hash_shift: int = 0) -> Forest:
    """Touched-path refresh after a create_accounts commit."""
    return dataclasses.replace(
        forest,
        accounts=touch_tree(
            forest.accounts, ledger.accounts, acc_lo, acc_hi,
            "accounts", max_probe, hash_shift,
        ),
    )


# Pending-side columns a post/void lane resolves on the device.
_PENDING_COLS = ("timestamp", "debit_account_id_lo", "debit_account_id_hi",
                 "credit_account_id_lo", "credit_account_id_hi")


def update_transfers_impl(forest: Forest, ledger: sm.Ledger,
                          id_lo, id_hi, acc_lo, acc_hi, pend_lo, pend_hi,
                          *, max_probe: int, has_postvoid: bool,
                          hash_shift: int = 0) -> Forest:
    """Touched-path refresh after a create_transfers commit: inserted
    transfer rows, both account sides, and, when the batch carried post/void
    lanes, the pending transfer's posted key (its timestamp) and its account
    sides, resolved on the device (one K1 probe with a gather; a pending not
    found gives zero keys, which touch nothing)."""
    transfers = touch_tree(
        forest.transfers, ledger.transfers, id_lo, id_hi,
        "transfers", max_probe, hash_shift,
    )
    posted = forest.posted
    if has_postvoid:
        pcol = ht.lookup(ledger.transfers, pend_lo, pend_hi, max_probe,
                         hash_shift, cols=_PENDING_COLS).cols
        posted = touch_tree(
            forest.posted, ledger.posted, pcol["timestamp"],
            torch.zeros_like(pend_lo), "posted", max_probe, hash_shift,
        )
        acc_lo = torch.cat([
            acc_lo, pcol["debit_account_id_lo"], pcol["credit_account_id_lo"],
        ])
        acc_hi = torch.cat([
            acc_hi, pcol["debit_account_id_hi"], pcol["credit_account_id_hi"],
        ])
    accounts = touch_tree(
        forest.accounts, ledger.accounts, acc_lo, acc_hi,
        "accounts", max_probe, hash_shift,
    )
    return Forest(accounts=accounts, transfers=transfers, posted=posted)


update_accounts = update_accounts_impl
update_transfers = update_transfers_impl


def gather_path(nodes: torch.Tensor, slot: int, levels: int) -> tuple:
    """(leaf, siblings[levels], root) for the leaf at ``slot``: the device
    half of get_proof (one small read-back).  K23's path entry on CUDA
    tensors."""
    if nodes.is_cuda:
        out = _cuda.merkle_path(nodes, int(slot), levels)
        return out[0], out[1:levels + 1], out[levels + 1]
    cap = nodes.shape[0] // 2
    idx = cap + int(slot)
    sibs = []
    for _ in range(levels):
        sibs.append(int(idx ^ 1))
        idx >>= 1
    siblings = nodes[torch.tensor(sibs, dtype=torch.int64,
                                  device=nodes.device)]
    return nodes[cap + int(slot)], siblings, nodes[1]


# ---------------------------------------------------------------------------
# Host (numpy) twins: checkpoint roots, test oracles, proof verification
# ---------------------------------------------------------------------------


def _np_table_cols(table: ht.Table, pad: str):
    key_lo = convert.tensor_to_array(table.key_lo)
    key_hi = convert.tensor_to_array(table.key_hi)
    cols = {name: convert.tensor_to_array(table.cols[name])
            for name in _LEAF_COLS[pad]}
    return key_lo, key_hi, cols


_NP_ROW_HASH = {
    "accounts": lambda lo, hi, c: _np_row_accounts(lo, hi, c),
    "transfers": lambda lo, hi, c: _np_row_transfers(lo, hi, c),
    "posted": lambda lo, hi, c: _np_row_posted(lo, hi, c),
}


def _np_row_accounts(key_lo, key_hi, cols):
    with np.errstate(over="ignore"):
        h = mix64_np(key_lo, key_hi)
        for f in ("debits_pending", "debits_posted",
                  "credits_pending", "credits_posted"):
            h = mix64_np(h ^ cols[f + "_lo"], h ^ cols[f + "_hi"])
        return mix64_np(h, cols["timestamp"])


def _np_row_transfers(key_lo, key_hi, cols):
    with np.errstate(over="ignore"):
        h = mix64_np(key_lo, key_hi)
        h = mix64_np(h ^ cols["amount_lo"], h ^ cols["amount_hi"])
        return mix64_np(h, cols["timestamp"])


def _np_row_posted(key_lo, key_hi, cols):
    h = mix64_np(key_lo, key_hi)
    return mix64_np(h, cols["fulfillment"].astype(np.uint64))


def np_leaves(key_lo: np.ndarray, key_hi: np.ndarray, cols: Dict, pad: str):
    live = (key_lo != 0) | (key_hi != 0)
    h = _NP_ROW_HASH[pad](
        key_lo.astype(np.uint64), key_hi.astype(np.uint64),
        {k: np.asarray(v) for k, v in cols.items()},
    )
    return np.where(live, h, np.uint64(0))


def np_tree(leaves: np.ndarray) -> np.ndarray:
    """Heap-layout numpy twin of tree_from_leaves."""
    levels = [leaves.astype(np.uint64)]
    while len(levels[-1]) > 1:
        prev = levels[-1]
        levels.append(mix64_np(prev[0::2], prev[1::2]))
    return np.concatenate([np.zeros(1, np.uint64)] + levels[::-1])


def np_root(leaves: np.ndarray) -> int:
    x = leaves.astype(np.uint64)
    while len(x) > 1:
        x = mix64_np(x[0::2], x[1::2])
    return int(x[0])


def np_table_leaves(table: ht.Table, pad: str) -> np.ndarray:
    key_lo, key_hi, cols = _np_table_cols(table, pad)
    return np_leaves(key_lo, key_hi, cols, pad)


def np_ledger_roots(ledger: sm.Ledger) -> Tuple[int, int, int]:
    """(accounts, transfers, posted) roots recomputed host-side from a
    single-layout ledger — the checkpoint-root writer/verifier and the
    from-scratch test oracle (no device work, no replay)."""
    return (
        np_root(np_table_leaves(ledger.accounts, "accounts")),
        np_root(np_table_leaves(ledger.transfers, "transfers")),
        np_root(np_table_leaves(ledger.posted, "posted")),
    )


def np_account_leaf(row: np.void) -> int:
    """Leaf value from one wire ACCOUNT_DTYPE row (the verifier side of a
    proof: the client holds the row bytes and the root, nothing else)."""
    cols = {
        name: np.asarray([row[name]]).astype(np.uint64)
        for name in _LEAF_COLS["accounts"]
    }
    lo = np.asarray([row["id_lo"]], np.uint64)
    hi = np.asarray([row["id_hi"]], np.uint64)
    return int(np_leaves(lo, hi, cols, "accounts")[0])


def np_transfer_leaf(row: np.void) -> int:
    """Leaf value from one wire TRANSFER_DTYPE row (transfer proofs)."""
    cols = {
        name: np.asarray([row[name]]).astype(np.uint64)
        for name in _LEAF_COLS["transfers"]
    }
    lo = np.asarray([row["id_lo"]], np.uint64)
    hi = np.asarray([row["id_hi"]], np.uint64)
    return int(np_leaves(lo, hi, cols, "transfers")[0])


def np_posted_leaf(row: np.void) -> int:
    """Leaf value from one PROOF_POSTED_DTYPE row: the posted pad is
    keyed by the pending transfer's timestamp, its one value column the
    fulfillment word (1 = posted, 2 = voided)."""
    cols = {
        "fulfillment": np.asarray([row["fulfillment"]]).astype(np.uint32)
    }
    lo = np.asarray([row["pending_timestamp"]], np.uint64)
    hi = np.zeros(1, np.uint64)
    return int(np_leaves(lo, hi, cols, "posted")[0])


# ---------------------------------------------------------------------------
# Proof wire format (machine.get_proof <-> clients)
# ---------------------------------------------------------------------------

PROOF_MAGIC = 0x4D505254  # "TRPM"
PROOF_VERSION = 1

PROOF_HEADER_DTYPE = np.dtype([
    ("magic", "<u4"),
    ("version", "<u4"),
    ("slot", "<u8"),          # leaf slot in the (canonical) pad
    ("n_siblings", "<u4"),    # log2(capacity)
    ("kind", "<u4"),          # PROOF_KINDS (was reserved=0 == accounts)
    ("root", "<u8"),          # the pad commitment the path folds to
])

# Which pad a proof anchors to.  Kind 0 keeps the first format's wire bytes
# (the field was reserved-as-zero), so old account proofs still verify.
PROOF_KINDS = {"accounts": 0, "transfers": 1, "posted": 2}
_PROOF_KIND_NAMES = {v: k for k, v in PROOF_KINDS.items()}

# The posted pad has no wire dtype: a proof row is the pad's content —
# the key (the pending transfer's timestamp; bind it to a pending id via
# that transfer's OWN proof, whose row carries id + timestamp) and the
# fulfillment word.
PROOF_POSTED_DTYPE = np.dtype([
    ("pending_timestamp", "<u8"),
    ("fulfillment", "<u4"),
    ("reserved", "<u4"),
])

_PROOF_LEAF = {
    "accounts": np_account_leaf,
    "transfers": np_transfer_leaf,
    "posted": np_posted_leaf,
}

# Row columns the leaf hash actually covers (the scrub-fold columns,
# _LEAF_COLS + the key).  A proof row carries ONLY these: every other
# column is zeroed at encode and PINNED to zero at verify — a byte the
# fold does not authenticate must not ride a blob that claims
# "reject-any-tampered-byte", or a MITM could rewrite it (e.g. a
# transfer's debit/credit accounts) inside a "verified" proof.
_PROOF_AUTH_COLS = {
    "accounts": ("id_lo", "id_hi") + _LEAF_COLS["accounts"],
    "transfers": ("id_lo", "id_hi") + _LEAF_COLS["transfers"],
    "posted": ("pending_timestamp", "fulfillment"),
}


def canonical_proof_row(row: np.void, kind: str) -> np.ndarray:
    """The committed projection of ``row``: leaf-covered columns kept,
    everything else zero.  Both the prover (encode) and the verifier
    (check_proof rejects non-canonical rows) use this."""
    out = np.zeros((), proof_row_dtype(kind))
    for name in _PROOF_AUTH_COLS[kind]:
        out[name] = row[name]
    return out


def proof_row_dtype(kind: str) -> np.dtype:
    from .. import types

    return {
        "accounts": types.ACCOUNT_DTYPE,
        "transfers": types.TRANSFER_DTYPE,
        "posted": PROOF_POSTED_DTYPE,
    }[kind]


class ProofError(ValueError):
    """Malformed or non-verifying Merkle proof."""


def encode_proof(row_bytes: bytes, slot: int, siblings, root: int,
                 kind: str = "accounts") -> bytes:
    head = np.zeros((), PROOF_HEADER_DTYPE)
    head["magic"] = PROOF_MAGIC
    head["version"] = PROOF_VERSION
    head["slot"] = slot
    head["n_siblings"] = len(siblings)
    head["kind"] = PROOF_KINDS[kind]
    head["root"] = np.uint64(root & U64_MASK)
    sib = np.asarray(siblings, np.uint64)
    row = np.frombuffer(bytes(row_bytes), proof_row_dtype(kind))[0]
    return head.tobytes() + canonical_proof_row(row, kind).tobytes() \
        + sib.tobytes()


def check_proof(blob: bytes) -> dict:
    """Parse AND verify a proof; raises ProofError unless the row's leaf
    folds through the sibling path to the stated root.  Returns
    {kind, row (np row of proof_row_dtype(kind)), root, slot, siblings};
    account proofs also keep the legacy ``account`` key."""
    head_size = PROOF_HEADER_DTYPE.itemsize
    if len(blob) < head_size:
        raise ProofError("proof truncated")
    head = np.frombuffer(blob[:head_size], PROOF_HEADER_DTYPE)[0]
    if int(head["magic"]) != PROOF_MAGIC:
        raise ProofError("bad proof magic")
    if int(head["version"]) != PROOF_VERSION:
        raise ProofError(f"unsupported proof version {int(head['version'])}")
    kind = _PROOF_KIND_NAMES.get(int(head["kind"]))
    if kind is None:
        raise ProofError(f"unknown proof kind {int(head['kind'])}")
    row_size = proof_row_dtype(kind).itemsize
    n_sib = int(head["n_siblings"])
    want = head_size + row_size + 8 * n_sib
    if len(blob) != want:
        raise ProofError(f"proof size {len(blob)} != expected {want}")
    row = np.frombuffer(
        blob[head_size:head_size + row_size], proof_row_dtype(kind)
    )[0]
    if canonical_proof_row(row, kind).tobytes() != blob[
        head_size:head_size + row_size
    ]:
        # A nonzero byte in a column the leaf hash does not cover: the
        # fold below could not detect it, so canonical form is enforced
        # instead — every blob byte is hash-bound or pinned to zero.
        raise ProofError("proof row carries unauthenticated nonzero bytes")
    siblings = np.frombuffer(blob[head_size + row_size:], "<u8")
    pos = int(head["slot"])
    if n_sib and pos >> n_sib:
        raise ProofError("slot out of range for the stated tree depth")
    node = np.uint64(_PROOF_LEAF[kind](row))
    for level in range(n_sib):
        sib = np.uint64(siblings[level])
        if (pos >> level) & 1:
            node = _np_combine(sib, node)  # this node is the right child
        else:
            node = _np_combine(node, sib)
    if int(node) != int(head["root"]):
        raise ProofError(
            f"proof does not fold to root: {int(node):#x} != "
            f"{int(head['root']):#x}"
        )
    out = {
        "kind": kind,
        "row": row,
        "root": int(head["root"]),
        "slot": int(head["slot"]),
        "siblings": [int(s) for s in siblings],
    }
    if kind == "accounts":
        out["account"] = row  # legacy key (account-only callers)
    return out


def _np_combine(left, right) -> np.uint64:
    return mix64_np(
        np.asarray([left], np.uint64), np.asarray([right], np.uint64)
    )[0]


# -- deferred commitment lane (TB_MERKLE_ASYNC; machine.merkle_settle) --------

def coalesce_touch_records(records, max_rows: int):
    """Chunk a deferred-commitment-lane queue into update-sized groups.

    ``records`` is an ordered list of ``(operation, batch)`` touch records
    queued by committed batches while the lane was deferring the
    leaf->root refresh.  Yields ``(operation, batches)`` groups where
    consecutive ``create_transfers`` records coalesce until their summed
    row count would exceed ``max_rows`` (the machine's batch_lanes — so a
    settle's padded key classes never exceed the classes the synchronous
    per-batch path already compiled), and every other operation (account
    creation) stays a singleton at its original position.

    Order is preserved end to end: an accounts record splits the
    transfer runs around it exactly where it committed, so replaying the
    groups reproduces the synchronous refresh sequence (leaves recompute
    from current table content, making each group idempotent and the
    coalescing an over-approximation-safe fusion, not a reordering)."""
    group: list = []
    rows = 0
    for op, batch in records:
        if op == "create_transfers":
            n = len(batch)
            if group and rows + n > max_rows:
                yield ("create_transfers", group)
                group, rows = [], 0
            group.append(batch)
            rows += n
            continue
        if group:
            yield ("create_transfers", group)
            group, rows = [], 0
        yield (op, [batch])
    if group:
        yield ("create_transfers", group)
