"""The one function of ``tigerbeetle_tpu/vsr/consensus.py`` the batched VOPR
reads (``sim/vopr_tpu.py``), copied; the rest of that module (the replica's
consensus) belongs to the serving slice."""

from __future__ import annotations

from typing import Tuple


def quorums(replica_count: int) -> Tuple[int, int]:
    """(quorum_replication, quorum_view_change) — flexible quorums that
    always intersect (vsr.zig:910-986): 1/1, 2/2, 2/2, 2/3, 3/3, 3/4."""
    if replica_count == 1:
        return 1, 1
    majority = replica_count // 2 + 1
    q_replication = max(2, replica_count + 1 - majority)
    q_view_change = max(majority, replica_count + 1 - q_replication)
    assert q_replication + q_view_change > replica_count
    return q_replication, q_view_change
