"""Observability: the process-global metrics registry (a copy of
``tigerbeetle_tpu.obs.metrics``)."""

from .metrics import registry  # noqa: F401 — the canonical entry point
