"""Streaming metrics registry: counters, gauges, fixed-bucket histograms
(own copy of the reference ``repro/obs/registry.py``, pure Python).

``serving/metrics.EngineMetrics`` backs its accumulators onto a per-run
registry: every scalar is a named :class:`Counter`/:class:`Gauge`, and
per-request and per-step latency and speculation-quality distributions land
in fixed-bucket :class:`Histogram` objects with exact counts and
interpolated p50/p90/p99.

* ``observe``/``inc`` are a few Python float ops plus a ``bisect``; the
  registry records host bookkeeping the scheduler already does, or values
  read at an existing host sync, and never adds a device read.
* Histograms carry their bucket bounds from construction; percentiles
  interpolate inside the containing bucket, so they are functions of the
  counts alone.
* Two exporters: :meth:`MetricsRegistry.to_prometheus`, the Prometheus
  text exposition (``# TYPE`` lines, cumulative ``_bucket{le=...}``
  series), which the HTTP front-end serves at ``/metrics``; and
  :meth:`MetricsRegistry.snapshot`, a schema-versioned JSON-able dict (one
  JSONL line a call with :meth:`MetricsRegistry.write_jsonl`) that
  ``obs.validate_snapshot`` checks.
"""
from __future__ import annotations

import bisect
import json
import math
import re
import threading
import time
from typing import Dict, List, Optional, Sequence

SNAPSHOT_SCHEMA_VERSION = 1

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """A metric name made legal for the Prometheus exposition format."""
    return _NAME_RE.sub("_", name)


def linear_buckets(start: float, width: float, count: int) -> List[float]:
    return [start + width * i for i in range(count)]


def exponential_buckets(start: float, factor: float,
                        count: int) -> List[float]:
    return [start * factor ** i for i in range(count)]


# default latency buckets: 50us .. ~55s, x2 per bucket — wide enough for
# both CPU smoke runs and full-width serving on the card
LATENCY_BUCKETS = exponential_buckets(50e-6, 2.0, 21)
# rates in [0, 1]: 5% resolution plus tight head/tail buckets
RATE_BUCKETS = [0.0, 0.01, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4,
                0.45, 0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8, 0.85, 0.9,
                0.95, 0.99, 1.0]
# page / head counts per step: 1..4096, x2
COUNT_BUCKETS = [0.0] + exponential_buckets(1.0, 2.0, 13)


class Counter:
    """Monotonic (by convention) accumulator. ``set`` exists so legacy
    ``EngineMetrics`` attribute assignment keeps working."""

    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self._value += v

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Gauge(Counter):
    """Last-write-wins scalar (occupancy, wall clock, in-flight drops)."""

    __slots__ = ()


class Histogram:
    """Fixed-bucket histogram with exact count/sum and interpolated
    percentiles.

    ``buckets`` are inclusive upper bounds; an implicit +inf bucket
    catches overflow. ``percentile(q)`` walks the cumulative counts to
    the containing bucket and interpolates linearly inside it (the +inf
    bucket clamps to the highest finite bound — and to the max observed
    value, which is tracked exactly).
    """

    __slots__ = ("name", "help", "buckets", "counts", "_count", "_sum",
                 "_min", "_max")

    def __init__(self, name: str, buckets: Sequence[float], help: str = ""):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"{name}: buckets must be sorted and non-empty")
        self.name = name
        self.help = help
        self.buckets = [float(b) for b in buckets]
        self.counts = [0] * (len(self.buckets) + 1)   # +1 = +inf overflow
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self._count += 1
        self._sum += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    @property
    def min(self) -> float:
        return self._min if self._count else 0.0

    @property
    def max(self) -> float:
        return self._max if self._count else 0.0

    def percentile(self, q: float) -> float:
        """q in [0, 1]; 0 with no observations."""
        if self._count == 0:
            return 0.0
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q={q} outside [0, 1]")
        target = q * self._count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            lo = self.buckets[i - 1] if i > 0 else min(self._min, 0.0)
            hi = self.buckets[i] if i < len(self.buckets) else self._max
            if cum + c >= target:
                frac = (target - cum) / c
                return min(lo + frac * (hi - lo), self._max)
            cum += c
        return self._max

    def summary(self) -> dict:
        return {
            "count": self._count,
            "sum": self._sum,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(0.50),
            "p90": self.percentile(0.90),
            "p99": self.percentile(0.99),
        }


class MetricsRegistry:
    """Name -> metric map with get-or-create accessors and two exporters.

    Metric *creation* and the exporters take a lock, so the HTTP
    front-end's thread can render ``/metrics`` while the scheduler's thread
    registers new series; the hot path (inc/observe on an existing metric,
    reached via a plain dict ``get``) stays lock-free."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    # -- get-or-create -------------------------------------------------
    def counter(self, name: str, help: str = "") -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.get(name)
                if c is None:
                    c = self._counters[name] = Counter(name, help)
        return c

    def gauge(self, name: str, help: str = "") -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.get(name)
                if g is None:
                    g = self._gauges[name] = Gauge(name, help)
        return g

    def histogram(self, name: str, buckets: Optional[Sequence[float]] = None,
                  help: str = "") -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.get(name)
                if h is None:
                    h = self._histograms[name] = Histogram(
                        name,
                        buckets if buckets is not None else LATENCY_BUCKETS,
                        help)
        return h

    # -- exporters -----------------------------------------------------
    def snapshot(self, extra: Optional[dict] = None) -> dict:
        """Schema-versioned JSON-able view (``obs.validate_snapshot``)."""
        with self._lock:
            snap = {
                "schema_version": SNAPSHOT_SCHEMA_VERSION,
                "unix_time": time.time(),
                "counters": {n: c.value for n, c in sorted(self._counters.items())},
                "gauges": {n: g.value for n, g in sorted(self._gauges.items())},
                "histograms": {
                    n: {**h.summary(), "buckets": h.buckets, "bucket_counts": list(h.counts)}
                    for n, h in sorted(self._histograms.items())
                },
            }
        if extra:
            snap["extra"] = extra
        return snap

    def snapshot_line(self, extra: Optional[dict] = None) -> str:
        return json.dumps(self.snapshot(extra), sort_keys=True)

    def write_jsonl(self, path: str, extra: Optional[dict] = None) -> None:
        """Append one snapshot line to ``path``."""
        with open(path, "a", encoding="utf-8") as f:
            f.write(self.snapshot_line(extra) + "\n")

    def to_prometheus(self) -> str:
        """Prometheus text exposition (0.0.4): counters, gauges, and
        histograms with cumulative ``le`` buckets."""
        out: List[str] = []
        with self._lock:
            for kind, metrics in (("counter", self._counters), ("gauge", self._gauges)):
                for n, c in sorted(metrics.items()):
                    pn = _prom_name(n)
                    if c.help:
                        out.append(f"# HELP {pn} {c.help}")
                    out.append(f"# TYPE {pn} {kind}")
                    out.append(f"{pn} {c.value:g}")
            for n, h in sorted(self._histograms.items()):
                pn = _prom_name(n)
                if h.help:
                    out.append(f"# HELP {pn} {h.help}")
                out.append(f"# TYPE {pn} histogram")
                cum = 0
                for b, c in zip(h.buckets, h.counts):
                    cum += c
                    out.append(f'{pn}_bucket{{le="{b:g}"}} {cum}')
                out.append(f'{pn}_bucket{{le="+Inf"}} {h.count}')
                out.append(f"{pn}_sum {h.sum:g}")
                out.append(f"{pn}_count {h.count}")
        return "\n".join(out) + "\n"
