"""Replication-side helpers of the port (so far only the checksum)."""
