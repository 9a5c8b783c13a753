"""Sharded tables and queries that set the traps of K30's one answer row a
device (``csrc/shard_gather.cu``: a lane's answer written once, by the
thread of its owner shard when the owner is on the device, as zeros by the
device's first local shard otherwise; the overflow word ORed by the probes
of every local shard when asked), in numpy.

``case(name, n_shards, seed=0)`` returns a dict: ``tables`` (one per shard:
``key_lo``, ``key_hi``, ``tombstone`` and the columns ``v`` (u64 as int64)
and ``w`` (int32, high bit set on some rows), ``LOCAL`` slots each, keys
placed as the sharded tables place them: at (mix64 >> log2 n) & (LOCAL -
1), linearly), ``lo``/``hi`` (int64[N] query keys: stored keys of every
shard, missing keys of every shard, zeros), ``count`` and ``mask`` (None
or bool[N]), ``devices`` (the mesh's device groups: tuples of shard ids
that partition the shards), ``full`` (the shard whose table is full, or
None).

- ``owners_not_local``: two devices of interleaved shards: every device
  holds the owners of some lanes and not of the rest.
- ``no_local_owner``: a device holding shard 0 alone and one holding the
  rest; the queries are all owned by the rest, so device 0 writes zeros
  for every lane.
- ``mask_count``: one device; a lane mask and a count below the lanes hide
  found rows.
- ``overflow``: the last shard's table is full, so a probe there for a key
  it does not hold never ends: the overflow word, asked or not; on its own
  device.

``to_tables(c, dev)`` gives the ``hash_table.Table``s on a device.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..ops.scrub import mix64_np

CASES = ("owners_not_local", "no_local_owner", "mask_count", "overflow")
LOCAL = 64  # slots of each shard's table
LANES = 300


def owners(lo: np.ndarray, hi: np.ndarray, n_shards: int) -> np.ndarray:
    return (mix64_np(lo.astype(np.uint64), hi.astype(np.uint64))
            & np.uint64(n_shards - 1)).astype(np.int64)


def _owned(rng, n_shards: int, shard: int, k: int) -> np.ndarray:
    """``k`` distinct nonzero keys (hi = 0) that ``shard`` owns."""
    out: List[int] = []
    seen = set()
    while len(out) < k:
        cand = rng.integers(1, 1 << 62, 4 * k * n_shards, dtype=np.uint64)
        own = owners(cand, np.zeros_like(cand), n_shards)
        for c in cand[own == shard]:
            if int(c) not in seen and len(out) < k:
                seen.add(int(c))
                out.append(int(c))
    return np.array(out, np.uint64)


def _table(rng, keys: np.ndarray, n_shards: int, tombs: int) -> Dict:
    """A local table of LOCAL slots holding ``keys`` at their homes, then
    ``tombs`` empty slots made tombstones."""
    shift = n_shards.bit_length() - 1
    key_lo = np.zeros(LOCAL, np.uint64)
    home = (mix64_np(keys, np.zeros_like(keys)) >> np.uint64(shift)) \
        & np.uint64(LOCAL - 1)
    for k, h in zip(keys, home):
        s = int(h)
        while key_lo[s] != 0:
            s = (s + 1) & (LOCAL - 1)
        key_lo[s] = k
    tomb = np.zeros(LOCAL, bool)
    empty = np.flatnonzero(key_lo == 0)
    if len(empty) and tombs:
        tomb[rng.choice(empty, min(tombs, len(empty)), replace=False)] = True
    v = np.where(key_lo != 0, key_lo * np.uint64(3), 0).view(np.int64)
    w = np.where(key_lo != 0, (key_lo & np.uint64(0x7FFFFFFF))
                 | np.uint64(1 << 31), 0).astype(np.uint32).view(np.int32)
    return {"key_lo": key_lo.view(np.int64),
            "key_hi": np.zeros(LOCAL, np.int64), "tombstone": tomb,
            "v": v, "w": w}


def case(name: str, n_shards: int, seed: int = 0) -> Dict:
    if name not in CASES:
        raise ValueError(f"unknown K30 case {name!r}")
    rng = np.random.default_rng(seed + 31 * CASES.index(name) + n_shards)
    full = n_shards - 1 if name == "overflow" else None
    stored, tables = [], []
    for s in range(n_shards):
        k = LOCAL if s == full else LOCAL // 2
        keys = _owned(rng, n_shards, s, k + 8)
        tables.append(_table(rng, keys[:k], n_shards, 0 if s == full else 6))
        stored.append((keys[:k], keys[k:]))  # held, missing
    if name == "no_local_owner":
        shards = range(1, n_shards)
    else:
        shards = range(n_shards)
    held = np.concatenate([stored[s][0] for s in shards])
    missing = np.concatenate([stored[s][1] for s in shards])
    miss = missing[:50]
    q = np.concatenate([rng.choice(held, LANES - len(miss) - 10), miss,
                        np.zeros(10, np.uint64)])
    rng.shuffle(q)
    count, mask = LANES, None
    if name == "mask_count":
        count, mask = LANES - 37, rng.random(LANES) < 0.8
    if name == "owners_not_local":
        devices = [tuple(range(0, n_shards, 2)), tuple(range(1, n_shards, 2))]
    elif name in ("no_local_owner", "overflow"):
        lone = 0 if name == "no_local_owner" else n_shards - 1
        devices = [(lone,), tuple(s for s in range(n_shards) if s != lone)]
    else:
        devices = [tuple(range(n_shards))]
    return {"tables": tables, "lo": q.view(np.int64),
            "hi": np.zeros(LANES, np.int64), "count": count, "mask": mask,
            "devices": devices, "full": full}


def to_tables(c: Dict, dev) -> list:
    """The case's shard tables as ``hash_table.Table``s on ``dev``."""
    import torch

    from ..ops import hash_table as ht

    out = []
    for t in c["tables"]:
        x = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        out.append(ht.Table(
            x(t["key_lo"]), x(t["key_hi"]), x(t["tombstone"]),
            {"v": x(t["v"]), "w": x(t["w"])},
            torch.zeros((), dtype=torch.int64, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev)))
    return out
