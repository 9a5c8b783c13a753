"""Replication-side helpers of the port (so far the checksum, the retry
backoff timer, checkpoints, the fusion gate and the quorum sizes)."""
