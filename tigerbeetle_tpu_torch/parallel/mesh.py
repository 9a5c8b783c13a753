"""A one-process mesh of shards (the counterpart of
``jax.sharding.Mesh(np.array(devs), (AXIS,))``).

The JAX package runs one state machine over a mesh of devices from one
process (``tigerbeetle_tpu/machine.py:358-388``) and tests it on 8 virtual
CPU devices.  Here a mesh is an ordered list of ``torch.device``s, one per
shard, where a device may repeat: ``device.force_virtual(n, d)`` gives n
shards on the one device ``d``, each holding its own slice of the tables.
The shards that share a device form a group; work that every shard would
repeat identically (the replicated validation) runs once per group.

``psum`` sums shard-partial int64 tensors (u64 bits, so the sum wraps) over
the mesh: first within each group, by kernel K31 on the card (its plain
version on the CPU), then, where the mesh spans several cards, across the
groups with one in-process NCCL all-reduce (``torch.cuda.nccl``), the
single-controller counterpart of XLA's psum.  ``psum_rows`` takes one row
a group already summed over its shards (K30's answer rows) and does only
the all-reduce across cards.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..device import physical
from ..ops import _cuda


class Mesh:
    """``devices[s]`` holds shard s (a power-of-two count of shards)."""

    def __init__(self, devices: Sequence[torch.device]) -> None:
        devs = [physical(d) for d in devices]
        n = len(devs)
        if n < 1 or n & (n - 1):
            raise ValueError(f"a mesh needs a power-of-two size, got {n}")
        self.devices: Tuple[torch.device, ...] = tuple(devs)
        groups: List[Tuple[torch.device, List[int]]] = []
        for s, d in enumerate(devs):
            for gd, members in groups:
                if gd == d:
                    members.append(s)
                    break
            else:
                groups.append((d, [s]))
        # (device, its shards in mesh order), devices in first-use order.
        self.groups: Tuple[Tuple[torch.device, Tuple[int, ...]], ...] = tuple(
            (d, tuple(m)) for d, m in groups)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shift(self) -> int:
        """The low hash bits that name a key's owner."""
        return self.size.bit_length() - 1

    @property
    def primary(self) -> torch.device:
        return self.devices[0]

    def key(self) -> tuple:
        return tuple(str(d) for d in self.devices)

    def psum(self, partials: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``partials[g]``: int64[len(group g's shards), M] on group g's
        device.  Returns, for every group, the int64[M] wrap-sum over every
        shard of the mesh, on that group's device."""
        if len(partials) != len(self.groups):
            raise ValueError("one partial per device group")
        sums = [shard_combine(p) for p in partials]
        if len(sums) > 1:
            # Every group's sum is on its own card, each after that card's
            # K31 on its current stream: NCCL orders itself on those streams.
            torch.cuda.nccl.all_reduce(sums)
        return sums


    def psum_rows(self, rows: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``rows[g]``: int64[M] on group g's device, the sum over its own
        shards.  Returns, for every group, the int64[M] wrap-sum over the
        groups, on that group's device (in place: the rows themselves)."""
        if len(rows) != len(self.groups):
            raise ValueError("one row per device group")
        rows = list(rows)
        if len(rows) > 1:
            torch.cuda.nccl.all_reduce(rows)
        return rows


def shard_combine(partial: torch.Tensor) -> torch.Tensor:
    """The wrap-sum over dim 0 of an int64[S, M] partial: kernel K31 on a
    CUDA tensor, its plain version on a CPU tensor."""
    if partial.is_cuda:
        return _cuda.shard_combine(partial)
    return shard_combine_plain(partial)


def shard_combine_plain(partial: torch.Tensor) -> torch.Tensor:
    """Plain version of K31 (int64 addition wraps as the u64 sum does)."""
    return partial.sum(0)
