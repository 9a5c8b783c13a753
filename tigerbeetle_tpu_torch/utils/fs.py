"""Durable filesystem helpers shared by the checkpoint/LSM/sync writers."""

from __future__ import annotations

import os


def atomic_write(path: str, blob: bytes) -> None:
    """Crash-safe file write: tmp + fsync + rename + directory fsync.
    After return, either the old file or the complete new file exists."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
