"""TB_SANITIZE=1 runtime sanitizer (port of ``tigerbeetle_tpu/sanitize.py``):
test/CI-only checks that make two bug classes fail loud.

- DONATION POISONING: when a pooled staging set goes back on the machine's
  free-list, every byte is filled with the 0xA5 sentinel, so a reader that
  still holds the released set (a dispatch closure after its resolve) sees
  garbage instead of stale plausible rows (``is_poisoned`` tells).
- CAPTURE TRIPWIRE: the JAX package counts XLA compiles after warmup; the
  port has no compiles, and its counterpart is a CUDA-graph capture
  (``ops/group.CAPTURES``).  The machine baselines the count at the end of
  ``warmup``; a later capture that no growth explains is a size-class bug,
  reported through ``capture_trip`` (a warning; a raise under
  TB_SANITIZE_STRICT=1).

Every trip increments a ``sanitize.*`` series when the metrics registry is
enabled.
"""

from __future__ import annotations

import os
import sys
from typing import Iterable

import numpy as np

__all__ = [
    "SanitizeError", "enabled", "strict", "SENTINEL_BYTE", "poison",
    "is_poisoned", "capture_trip",
]

#: Every byte of a poisoned buffer: not 0x00 (a plausible pad), not 0xFF (a
#: plausible sentinel id), and odd in every field.
SENTINEL_BYTE = 0xA5


class SanitizeError(AssertionError):
    """A sanitizer invariant was violated (loud by design)."""


def enabled() -> bool:
    """TB_SANITIZE=1 arms the runtime checks (test/CI-only)."""
    return os.environ.get("TB_SANITIZE", "") not in ("", "0")


def strict() -> bool:
    """TB_SANITIZE_STRICT=1 escalates tripwire warnings to raises."""
    return os.environ.get("TB_SANITIZE_STRICT", "") not in ("", "0")


def _count(name: str, n: int = 1) -> None:
    from .obs.metrics import registry

    if registry.enabled and enabled():
        registry.counter(f"sanitize.{name}").inc(n)


def poison(buffers: Iterable[np.ndarray]) -> int:
    """Fill each host buffer with the sentinel byte; returns how many were
    poisoned (the machine's ``_stage_release`` under TB_SANITIZE)."""
    n = 0
    for buf in buffers:
        np.asarray(buf).view(np.uint8).fill(SENTINEL_BYTE)
        n += 1
    if n:
        _count("donation_poisons", n)
    return n


def is_poisoned(buf) -> bool:
    """True when the buffer is entirely sentinel bytes (a released pooled
    buffer nobody refilled).  Empty buffers are never poisoned."""
    flat = np.asarray(buf).view(np.uint8)
    return flat.size > 0 and bool((flat == SENTINEL_BYTE).all())


def capture_trip(where: str, delta: int, strict_ok: bool = True) -> None:
    """Record ``delta`` CUDA-graph captures in ``where`` after warmup that
    no growth explains: count, warn, raise under TB_SANITIZE_STRICT (unless
    ``strict_ok`` is False).  Callers re-baseline so a burst warns once."""
    _count("recaptures", delta)
    print(
        f"# SANITIZE: {delta} CUDA graph capture(s) in {where} after warmup "
        "with no growth: a ledger buffer or shape is not stable across "
        "runs", file=sys.stderr)
    if strict_ok and strict():
        raise SanitizeError(
            f"capture tripwire: {delta} capture(s) in {where} after warmup")
