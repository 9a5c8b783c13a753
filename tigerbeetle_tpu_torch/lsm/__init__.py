"""LSM-equivalent durable storage (a copy of ``tigerbeetle_tpu/lsm``)."""

from .forest import Forest, Manifest, RunRef

__all__ = ["Forest", "Manifest", "RunRef"]
