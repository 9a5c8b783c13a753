"""Process-global metrics registry: counters, gauges, log2 histograms.

The reference splits observability between typed Tracy spans (src/tracer.zig)
and StatsD emission (src/statsd.zig); the numbers themselves — how many
commits, how long each pipeline stage took, how full each batch was — live in
ad-hoc locals.  This registry is the missing middle layer: every runtime
layer (vsr, net, ops, sim) records into ONE process-global table of named
series, and three sinks read it:

- a JSON snapshot (``TB_METRICS_PATH`` env / ``--metrics-json`` flags) for
  bench artifacts and tools/devhub.py;
- the StatsD bridge (``flush_statsd``), so the existing UDP path keeps
  carrying the new series;
- direct inspection from tests (deterministic bucket layout).

Cost discipline (the reference's build-time ``tracer_backend=none`` spirit,
at runtime): the registry starts DISABLED and every instrumentation site
guards on ``registry.enabled`` before doing any work — including the
``perf_counter_ns`` reads that feed histograms — so a server that never opts
in pays one attribute load + branch per instrumented event, nothing more.
Handles themselves are dumb slots objects (an ``inc`` is one int add); they
are safe to cache across the enabled flag flipping because the flag gates
the *call sites*, not the handles.

Histograms are bounded log2-bucket (64 buckets: bucket b holds values v with
``v.bit_length() == b``, i.e. [2^(b-1), 2^b); bucket 0 holds v <= 0).  Exact
count/sum/min/max ride alongside, so p100 is exact and single-valued series
report exact percentiles; interior percentiles are the bucket midpoint
clamped to [min, max].  Fixed memory per series, no unbounded sample lists —
the same discipline as the tracer's slot cap.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Dict, Optional

HIST_BUCKETS = 64


class Counter:
    """Monotonic event count.  ``inc`` is intentionally lock-free: a torn
    read-modify-write under free threading loses a sample, which best-effort
    metrics tolerate (statsd.zig drops on EAGAIN for the same reason)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = value


class Histogram:
    """Bounded log2-bucket latency/size histogram (module docstring)."""

    __slots__ = ("name", "unit", "buckets", "count", "total", "min", "max")

    def __init__(self, name: str, unit: str = "") -> None:
        self.name = name
        self.unit = unit
        self.buckets = [0] * HIST_BUCKETS
        self.count = 0
        self.total = 0
        self.min: Optional[int] = None
        self.max: Optional[int] = None

    @staticmethod
    def bucket_of(value: int) -> int:
        if value <= 0:
            return 0
        return min(value.bit_length(), HIST_BUCKETS - 1)

    def observe(self, value: float) -> None:
        v = int(value)
        self.buckets[self.bucket_of(v)] += 1
        self.count += 1
        self.total += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v

    def percentile(self, p: float) -> Optional[float]:
        """Deterministic bucket-resolution percentile: the midpoint of the
        bucket containing the ceil(p% * count)-th sample, clamped to the
        exact [min, max] envelope (so p100 == max exactly)."""
        if self.count == 0:
            return None
        rank = max(1, -(-int(p * self.count) // 100))  # ceil(p/100 * count)
        seen = 0
        for b, n in enumerate(self.buckets):
            seen += n
            if seen >= rank:
                if b == 0:
                    mid = 0.0
                else:
                    lo, hi = 1 << (b - 1), (1 << b) - 1
                    mid = (lo + hi) / 2.0
                return float(min(max(mid, self.min), self.max))
        return float(self.max)

    def snapshot(self) -> dict:
        out = {
            "count": self.count,
            "sum": self.total,
            "min": self.min,
            "max": self.max,
            "unit": self.unit,
        }
        if self.count:
            out["p50"] = self.percentile(50)
            out["p95"] = self.percentile(95)
            out["p99"] = self.percentile(99)
            # Sparse bucket map (most of the 64 buckets are empty).
            out["buckets"] = {
                str(b): n for b, n in enumerate(self.buckets) if n
            }
        return out


class Registry:
    """The process-global series table (module docstring)."""

    def __init__(self, enabled: bool = False) -> None:
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        # Counter values as of the last statsd flush (deltas are emitted).
        self._statsd_sent: Dict[str, int] = {}

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    @contextlib.contextmanager
    def enabled_scope(self, reset: bool = True):
        """Context manager: enable for the block, ALWAYS disable (and by
        default reset) on exit.  The registry is process-global, so a
        leaked enable() taxes every later test and mixes foreign series
        into the next snapshot — the PR 10 leak class the TB_SANITIZE
        registry guard (sanitize.assert_registry_disabled) and the
        autouse test fixture now police.  Use this instead of a bare
        enable() in tests and tools."""
        if reset:
            self.reset()
        self.enable()
        try:
            yield self
        finally:
            self.disable()
            if reset:
                self.reset()

    def reset(self) -> None:
        """Drop every series (tests; the registry is process-global)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._statsd_sent.clear()

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str, unit: str = "") -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(name, unit))
        return h

    # -- sinks ---------------------------------------------------------------

    def snapshot(self) -> dict:
        """One JSON-ready dict of every series (sorted: deterministic)."""
        with self._lock:
            return {
                "counters": {
                    name: c.value
                    for name, c in sorted(self._counters.items())
                },
                "gauges": {
                    name: g.value for name, g in sorted(self._gauges.items())
                },
                "histograms": {
                    name: h.snapshot()
                    for name, h in sorted(self._histograms.items())
                },
            }

    def dump(self, path: str) -> dict:
        """Write the snapshot as JSON; returns it."""
        snap = self.snapshot()
        with open(path, "w") as f:
            json.dump(snap, f, indent=1)
        return snap

    def flush_statsd(self, statsd) -> None:
        """Bridge the registry onto the existing UDP path
        (utils/statsd.StatsD): counters as deltas since the last flush,
        gauges as gauges, histogram p50/p95/p99 as timing samples.  Never
        raises, never blocks (the StatsD socket is non-blocking).

        The delta watermark (_statsd_sent) is claimed under the lock, so
        concurrent flushes cannot double-emit a delta.  It is registry-
        global: the bridge assumes ONE StatsD sink per process (the CLI
        wires exactly one); multiple distinct sinks would split the deltas
        between them."""
        if statsd is None:
            return
        with self._lock:
            deltas = []
            for name, c in sorted(self._counters.items()):
                value = c.value
                delta = value - self._statsd_sent.get(name, 0)
                if delta:
                    self._statsd_sent[name] = value
                    deltas.append((name, delta))
            gauges = [(n, g.value) for n, g in sorted(self._gauges.items())]
            hists = [
                (n, h.snapshot())
                for n, h in sorted(self._histograms.items())
            ]
        for name, delta in deltas:
            statsd.count(name, delta)
        for name, value in gauges:
            statsd.gauge(name, value)
        for name, h in hists:
            for pct in ("p50", "p95", "p99"):
                if h.get(pct) is not None:
                    statsd.timing(f"{name}.{pct}", h[pct])


# The process-global registry (the reference's comptime-global tracer/statsd
# pattern).  TB_METRICS_PATH enables it at import and dumps at exit;
# --metrics-json flags (cli.py, bench.py) enable it programmatically.
registry = Registry(enabled=bool(os.environ.get("TB_METRICS_PATH")))

if registry.enabled:
    import atexit

    @atexit.register
    def _dump_at_exit() -> None:
        path = os.environ.get("TB_METRICS_PATH", "tb_metrics.json")
        try:
            registry.dump(path)
        except OSError:
            return
        print(f"metrics: wrote snapshot to {path}",
              file=__import__("sys").stderr)
