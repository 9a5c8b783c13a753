"""Replication-side helpers of the port (so far the checksum and the
retry backoff timer)."""
