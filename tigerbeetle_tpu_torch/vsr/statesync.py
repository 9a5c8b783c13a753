"""Host-side codec + tree math for Merkle-anchored incremental state sync.

The reference ships whole checkpoints on state sync (src/vsr/sync.zig —
its grid is content-addressed, so a lagging replica fetches every block
of the target checkpoint); here the commitment trees (ops/merkle.py)
make the transfer *differential*.

The transport story (docs/state_sync.md): a catching-up replica compares
the responder checkpoint's per-pad commitment trees against trees built
over its OWN (stale-checkpoint or live-but-lagging) canonical state and
ships only what diverges — O(diff · log capacity) bytes instead of the
full checkpoint blob.  Everything here is numpy on the CANONICAL flat
array snapshot (vsr/checkpoint.ledger_to_arrays keys), shared by both
sides of the protocol:

- ``build_trees``: heap-layout np commitment trees (ops/merkle.np_tree —
  the same leaves the on-device forest maintains and checkpoints anchor)
  for the three pads, straight from a flat arrays dict.
- ``children`` / ``verify_children``: the batched binary descent — a
  reply carries the 2 children of each requested node, each pair
  verified against the ALREADY-VERIFIED parent value (mix64(l, r) ==
  parent), so the chain of trust grows root-downward and a lying
  responder is caught at the first forged level.
- ``pack_rows`` / ``unpack_rows`` / ``verify_rows``: diverging leaf rows
  as raw per-slot column slices in sorted-key order (zero per-row
  framing overhead); each row re-hashes to its verified leaf value.
- ``pack_history`` / ``unpack_history``: the append-only history tail
  (no tree covers it; the final state checksum does).
- ``arrays_checksum``: AEGIS over EVERY canonical array byte in sorted
  key order — the reconstructed state must hash to the responder's
  advertised value before it may install, making incremental and full
  rejoins byte-identical by construction.

The wire envelope (commands, headers) lives in vsr/wire.py; the protocol
state machine in vsr/consensus.py.
"""

from __future__ import annotations

import io
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops import merkle as merkle_ops
from .checksum import checksum

# Pad order is wire contract: request/response headers carry the index.
PADS = ("accounts", "transfers", "posted")
HISTORY_PAD = 3

# Scalar (non per-slot) keys per pad, as in vsr/checkpoint.py.
_SCALARS = ("count", "probe_overflow")

U64 = np.uint64


# -- canonical array access --------------------------------------------------


def per_slot_keys(arrays: Dict[str, np.ndarray], pad: str) -> List[str]:
    """Sorted per-slot array keys for ``pad`` — the shared row layout both
    encoder and decoder derive independently (sorted: the order IS the
    wire contract, so it must not depend on dict insertion history)."""
    prefix = f"{pad}/"
    return sorted(
        k for k in arrays
        if k.startswith(prefix) and k.split("/")[-1] not in _SCALARS
    )


def history_keys(arrays: Dict[str, np.ndarray]) -> List[str]:
    return sorted(k for k in arrays if k.startswith("history/cols/"))


def schema(arrays: Dict[str, np.ndarray]) -> dict:
    """Column layout fingerprint: {pad: [[key, dtype_str], ...]} for the
    three pads + history.  A requester whose own schema differs (version
    skew) must fall back to the full-checkpoint path — raw row packing
    is only sound between identical layouts.  JSON-shaped (lists, not
    tuples) so a wire round trip compares equal."""
    out = {}
    for pad in PADS:
        out[pad] = [
            [k, arrays[k].dtype.str] for k in per_slot_keys(arrays, pad)
        ]
    out["history"] = [
        [k, arrays[k].dtype.str] for k in history_keys(arrays)
    ]
    return out


def pad_capacity(arrays: Dict[str, np.ndarray], pad: str) -> int:
    return int(arrays[f"{pad}/key_lo"].shape[0])


def row_bytes(arrays: Dict[str, np.ndarray], pad: str) -> int:
    """Packed bytes per slot for ``pad`` (sum of per-slot itemsizes)."""
    return sum(arrays[k].dtype.itemsize for k in per_slot_keys(arrays, pad))


def history_row_bytes(arrays: Dict[str, np.ndarray]) -> int:
    return sum(arrays[k].dtype.itemsize for k in history_keys(arrays)) or 1


# -- commitment trees over flat arrays ---------------------------------------


def pad_leaves(arrays: Dict[str, np.ndarray], pad: str) -> np.ndarray:
    cols = {
        name: arrays[f"{pad}/cols/{name}"]
        for name in merkle_ops._LEAF_COLS[pad]
    }
    return merkle_ops.np_leaves(
        arrays[f"{pad}/key_lo"], arrays[f"{pad}/key_hi"], cols, pad
    )


def build_trees(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Heap-layout np tree per pad (root at [1], leaves at [cap + slot])."""
    return {pad: merkle_ops.np_tree(pad_leaves(arrays, pad)) for pad in PADS}


def np_digest(arrays: Dict[str, np.ndarray]) -> int:
    """The convergence-oracle fold (ops/state_machine.ledger_digest twin):
    wrap-sum of the accounts leaves — bit-identical because the merkle
    accounts leaves ARE the scrub fold's per-slot addends."""
    with np.errstate(over="ignore"):
        return int(pad_leaves(arrays, "accounts").sum(dtype=U64))


def children(tree: np.ndarray, nodes: np.ndarray) -> np.ndarray:
    """u64[2n]: the (left, right) child values of each heap node —
    interleaved pairs, the descent reply payload."""
    nodes = nodes.astype(np.int64)
    out = np.empty(2 * len(nodes), U64)
    out[0::2] = tree[2 * nodes]
    out[1::2] = tree[2 * nodes + 1]
    return out


def verify_children(
    values: np.ndarray, nodes: np.ndarray, want: Dict[int, int]
) -> bool:
    """Each received (l, r) pair must combine to the already-verified
    parent value: mix64(l, r) == want[node]."""
    if len(values) != 2 * len(nodes):
        return False
    left = values[0::2]
    right = values[1::2]
    combined = merkle_ops.mix64_np(
        left.astype(U64), right.astype(U64)
    )
    return all(
        int(combined[i]) == want.get(int(n), -1)
        for i, n in enumerate(nodes)
    )


def leaf_level(cap: int) -> int:
    """Heap index of the first leaf (== capacity)."""
    return cap


# -- row payloads ------------------------------------------------------------


def pack_rows(
    arrays: Dict[str, np.ndarray], pad: str, slots: np.ndarray
) -> bytes:
    """Raw per-slot slices in sorted-key order — no per-row framing; the
    receiver re-derives the layout from its own (schema-checked) arrays."""
    slots = slots.astype(np.int64)
    return b"".join(
        np.ascontiguousarray(arrays[k][slots]).tobytes()
        for k in per_slot_keys(arrays, pad)
    )


def unpack_rows(
    arrays: Dict[str, np.ndarray], pad: str, slots: np.ndarray, body: bytes
) -> Optional[Dict[str, np.ndarray]]:
    """Split a pack_rows payload back into {key: values[len(slots)]},
    using the RECEIVER's arrays only for layout (shapes/dtypes).  None on
    a length mismatch (truncated/garbage payload)."""
    n = len(slots)
    out: Dict[str, np.ndarray] = {}
    off = 0
    for k in per_slot_keys(arrays, pad):
        dt = arrays[k].dtype
        size = dt.itemsize * n
        if off + size > len(body):
            return None
        out[k] = np.frombuffer(body[off:off + size], dtype=dt).copy()
        off += size
    if off != len(body):
        return None
    return out


def rows_leaves(rows: Dict[str, np.ndarray], pad: str) -> np.ndarray:
    """Leaf hashes of unpacked rows (verification: each received row must
    hash to the already-verified leaf value for its slot)."""
    cols = {
        name: rows[f"{pad}/cols/{name}"]
        for name in merkle_ops._LEAF_COLS[pad]
    }
    return merkle_ops.np_leaves(
        rows[f"{pad}/key_lo"], rows[f"{pad}/key_hi"], cols, pad
    )


def verify_rows(
    rows: Dict[str, np.ndarray], pad: str, slots: np.ndarray,
    want: Dict[int, int], cap: int,
) -> bool:
    leaves = rows_leaves(rows, pad)
    return all(
        int(leaves[i]) == want.get(cap + int(s), -1)
        for i, s in enumerate(slots)
    )


# -- history tail ------------------------------------------------------------


def pack_history(
    arrays: Dict[str, np.ndarray], start: int, count: int
) -> bytes:
    return b"".join(
        np.ascontiguousarray(arrays[k][start:start + count]).tobytes()
        for k in history_keys(arrays)
    )


def unpack_history(
    arrays: Dict[str, np.ndarray], count: int, body: bytes
) -> Optional[Dict[str, np.ndarray]]:
    out: Dict[str, np.ndarray] = {}
    off = 0
    for k in history_keys(arrays):
        dt = arrays[k].dtype
        size = dt.itemsize * count
        if off + size > len(body):
            return None
        out[k] = np.frombuffer(body[off:off + size], dtype=dt).copy()
        off += size
    if off != len(body):
        return None
    return out


# -- whole-state byte identity -----------------------------------------------


def arrays_checksum(arrays: Dict[str, np.ndarray]) -> int:
    """AEGIS over every canonical array byte (names + shapes + content,
    sorted key order).  The install gate: a reconstructed state must hash
    to the responder's advertised value, which makes an incremental
    rejoin byte-identical to a full-transfer rejoin BY CONSTRUCTION —
    any divergence the tree's covered columns cannot see (or any bug in
    the descent) routes to the full-checkpoint fallback instead of
    installing."""
    h = []
    for k in sorted(arrays):
        if k == "meta":
            continue
        arr = np.ascontiguousarray(arrays[k])
        h.append(k.encode())
        h.append(str(arr.shape).encode())
        h.append(arr.tobytes())
    return checksum(b"\x00".join(h))


# -- the sync_roots body pack ------------------------------------------------

# Top-frontier depth: the sync_roots body carries each pad's nodes at
# this relative depth below the root (2^depth values, clamped to the
# tree's own height) so a requester can skip entire clean subtrees
# before the first descent round trip.
TOP_DEPTH = 6


def frontier(tree: np.ndarray, depth: int) -> np.ndarray:
    """The 2^depth heap values at ``depth`` levels below the root."""
    lo = 1 << depth
    return tree[lo: 2 * lo].copy()


def fold_frontier(values: np.ndarray) -> int:
    """Fold a frontier level back up to the root value."""
    x = values.astype(U64)
    while len(x) > 1:
        x = merkle_ops.mix64_np(x[0::2], x[1::2])
    return int(x[0])


def top_depth(cap: int) -> int:
    return min(TOP_DEPTH, max(0, cap.bit_length() - 1))


def pack_roots(
    arrays: Dict[str, np.ndarray],
    trees: Dict[str, np.ndarray],
    meta: dict,
) -> bytes:
    """The sync_roots reply body: per-pad capacity/scalars/root/top
    frontier, history shape, schema, and the checkpoint meta JSON."""
    payload: Dict[str, np.ndarray] = {}
    for pad in PADS:
        cap = pad_capacity(arrays, pad)
        payload[f"{pad}/capacity"] = U64(cap)
        payload[f"{pad}/count"] = np.asarray(arrays[f"{pad}/count"])
        payload[f"{pad}/probe_overflow"] = np.asarray(
            arrays[f"{pad}/probe_overflow"]
        )
        payload[f"{pad}/root"] = np.asarray(trees[pad][1])
        payload[f"{pad}/top"] = frontier(trees[pad], top_depth(cap))
    hk = history_keys(arrays)
    payload["history/capacity"] = U64(
        arrays[hk[0]].shape[0] if hk else 0
    )
    payload["history/count"] = np.asarray(arrays["history/count"])
    payload["schema"] = np.frombuffer(
        json.dumps(schema(arrays), sort_keys=True).encode(), dtype=np.uint8
    ).copy()
    payload["meta"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8
    ).copy()
    buf = io.BytesIO()
    np.savez(buf, **payload)
    # zlib: the schema/meta JSON and the npz zero padding dominate the
    # raw size; compressed, the summary fits one message body even at
    # the 8 KiB test_min budget (the responder still refuses to answer
    # if a pathological session table pushes it past the budget — the
    # requester then degrades to the full-checkpoint path).
    import zlib

    return zlib.compress(buf.getvalue(), 6)


def unpack_roots(body: bytes) -> Optional[dict]:
    """Parse a sync_roots body; verifies each pad's top frontier folds to
    its stated root (the first link of the chain of trust).  None on any
    malformed/forged payload."""
    import zlib

    try:
        z = np.load(io.BytesIO(zlib.decompress(body)))
        out: dict = {"pads": {}}
        for pad in PADS:
            cap = int(z[f"{pad}/capacity"])
            top = np.asarray(z[f"{pad}/top"], dtype=U64)
            root = int(z[f"{pad}/root"])
            if cap <= 0 or cap & (cap - 1):
                return None
            if len(top) != 1 << top_depth(cap):
                return None
            if fold_frontier(top) != root:
                return None
            out["pads"][pad] = {
                "capacity": cap,
                "count": np.asarray(z[f"{pad}/count"]),
                "probe_overflow": np.asarray(z[f"{pad}/probe_overflow"]),
                "root": root,
                "top": top,
            }
        out["history_capacity"] = int(z["history/capacity"])
        out["history_count"] = int(z["history/count"])
        # Bound responder-supplied shapes BEFORE anything allocates or
        # slices from them (a forged summary must be rejected here, not
        # crash the requester past the verification chain): history must
        # fit its capacity and the capacity must be allocatable.
        if not (
            0 <= out["history_count"] <= out["history_capacity"] <= 1 << 26
        ):
            return None
        for pad in PADS:
            if out["pads"][pad]["capacity"] > 1 << 28:
                return None
        out["schema"] = json.loads(bytes(z["schema"]).decode())
        out["meta"] = json.loads(bytes(z["meta"]).decode())
        return out
    except (ValueError, KeyError, OSError, json.JSONDecodeError,
            zlib.error):
        return None


# -- responder-side pack -----------------------------------------------------


class SyncPack:
    """Everything a responder needs to serve one checkpoint's incremental
    sync, built once per checkpoint op and cached (vsr/consensus.py):
    the canonical flat arrays, their trees, and the install gates."""

    def __init__(self, op: int, arrays: Dict[str, np.ndarray], meta: dict):
        self.op = op
        self.arrays = {k: v for k, v in arrays.items() if k != "meta"}
        self.meta = meta or {}
        self.trees = build_trees(self.arrays)
        self.digest = np_digest(self.arrays)
        self.state_checksum = arrays_checksum(self.arrays)
        self.roots_body = pack_roots(self.arrays, self.trees, self.meta)


# -- online reshard migration (docs/reconfiguration.md) -----------------------
#
# An N -> 2N shard split reuses this codec verbatim: the split adds one
# owner bit, so a canonical slot either stays on its shard or moves to
# shard s+N.  Only the MOVED subset crosses the wire; every chunk is a
# pack_rows payload re-hashed against the already-built source tree
# (verify_rows), and the staged full state must pass arrays_checksum
# before the new layout may take over.  The helpers below carve the
# moved subset into bounded chunks and audit each one — the machine-side
# engine (machine.TpuStateMachine.reshard_*) drives them between
# commits.


def chunk_slots(slots: np.ndarray, chunk: int) -> List[np.ndarray]:
    """Split a slot vector into <= chunk-sized contiguous pieces (wire
    bound: one migration message per piece)."""
    slots = np.asarray(slots, dtype=np.int64)
    if len(slots) == 0:
        return []
    return [slots[i:i + chunk] for i in range(0, len(slots), max(1, chunk))]


def ship_chunk(
    arrays: Dict[str, np.ndarray], tree: np.ndarray, pad: str,
    slots: np.ndarray, corrupt: bool = False,
) -> bytes:
    """Responder side of one migration chunk: a pack_rows payload for
    ``slots``.  ``corrupt`` flips one byte of the key_lo segment (fault
    injection: a lying or bit-flipped migration source) — keys are
    leaf-covered for every pad, so the receiver's verify_chunk must
    catch it, or, with verification disabled, install the divergence the
    auditor then catches (the scrub-off discipline)."""
    body = bytearray(pack_rows(arrays, pad, slots))
    if corrupt and body:
        off = 0
        for k in per_slot_keys(arrays, pad):
            size = arrays[k].dtype.itemsize * len(slots)
            if k.endswith("/key_lo"):
                body[off + size // 2] ^= 0x40
                break
            off += size
        else:  # pragma: no cover - every pad has a key_lo
            body[len(body) // 2] ^= 0x40
    return bytes(body)


def verify_chunk(
    arrays: Dict[str, np.ndarray], tree: np.ndarray, pad: str,
    slots: np.ndarray, body: bytes,
) -> Optional[Dict[str, np.ndarray]]:
    """Receiver side: unpack against the receiver's own schema and
    re-hash every row against the verified source tree leaf for its
    slot.  None => reject the chunk (retry, then abandon the split)."""
    rows = unpack_rows(arrays, pad, slots, body)
    if rows is None:
        return None
    cap = pad_capacity(arrays, pad)
    want = {cap + int(s): int(tree[cap + int(s)]) for s in slots}
    if not verify_rows(rows, pad, slots, want, cap):
        return None
    return rows
