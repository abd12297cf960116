"""Observability of the serving loop (reference ``repro/obs``):

* :mod:`repro_torch.obs.registry`: counters, gauges and fixed-bucket
  histograms, the store behind ``serving/metrics.EngineMetrics``, with its
  Prometheus and JSON-snapshot exporters;
* :mod:`repro_torch.obs.timeseries`: the sliding-window board the
  scheduler feeds rolling TTFT, inter-token gaps, tokens/s and occupancy
  into, served live at the HTTP front-end's ``/stats``;
* :mod:`repro_torch.obs.trace`: the Chrome-trace span recorder for the
  request lifecycle and the recall, and ``annotate``, the same span names
  as ``torch.profiler`` ranges in the retrieval path.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.obs.registry import (  # noqa: F401  (re-exports)
    COUNT_BUCKETS,
    LATENCY_BUCKETS,
    RATE_BUCKETS,
    SNAPSHOT_SCHEMA_VERSION,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    exponential_buckets,
    linear_buckets,
)
from repro_torch.obs.timeseries import (  # noqa: F401
    DEFAULT_WINDOW_S,
    TIMESERIES_SCHEMA_VERSION,
    TimeSeriesBoard,
    WindowRate,
    WindowStat,
    validate_timeseries_snapshot,
)
from repro_torch.obs.trace import (  # noqa: F401
    SPAN_ATTN_COMPUTE,
    SPAN_DECODE_STEP,
    SPAN_DECODE_WINDOW,
    SPAN_RECALL_CORRECTION,
    SPAN_RECALL_REUSE,
    SPAN_RECALL_SELECT,
    SPAN_RECALL_STAGED,
    SPAN_RECALL_TOPUP,
    SPAN_REQUEST_DECODE,
    SPAN_REQUEST_DONE,
    SPAN_REQUEST_PREFILL,
    SPAN_REQUEST_QUEUED,
    TraceRecorder,
    annotate,
    validate_chrome_trace,
)


@dataclass
class Observability:
    """Run-level switches handed to ``ServeEngine``. ``enabled`` gates the
    per-step histograms and trace work in the scheduler (the counters of
    ``EngineMetrics`` always run); ``trace`` is the span recorder;
    ``timeseries`` is the optional sliding-window board the scheduler
    feeds, which the HTTP front-end serves at ``/stats`` (None skips all
    windowed work)."""

    enabled: bool = True
    trace: TraceRecorder = field(default_factory=lambda: TraceRecorder(enabled=False))
    timeseries: "TimeSeriesBoard | None" = None

    @classmethod
    def off(cls) -> "Observability":
        return cls(enabled=False, trace=TraceRecorder(enabled=False))

    @classmethod
    def full(cls) -> "Observability":
        return cls(enabled=True, trace=TraceRecorder(enabled=True),
                   timeseries=TimeSeriesBoard())


def validate_snapshot(snap: dict) -> list:
    """Schema check for ``MetricsRegistry.snapshot()`` dicts and JSONL
    lines. Returns a list of problems (empty = valid)."""
    errors = []
    if not isinstance(snap, dict):
        return ["snapshot is not an object"]
    if snap.get("schema_version") != SNAPSHOT_SCHEMA_VERSION:
        errors.append(f"schema_version != {SNAPSHOT_SCHEMA_VERSION}")
    for sect in ("counters", "gauges", "histograms"):
        if not isinstance(snap.get(sect), dict):
            errors.append(f"missing section {sect!r}")
    for sect in ("counters", "gauges"):
        for name, v in (snap.get(sect) or {}).items():
            if not isinstance(v, (int, float)):
                errors.append(f"{sect}.{name}: non-numeric value")
    for name, h in (snap.get("histograms") or {}).items():
        if not isinstance(h, dict):
            errors.append(f"histograms.{name}: not an object")
            continue
        for key in ("count", "sum", "mean", "p50", "p90", "p99", "buckets", "bucket_counts"):
            if key not in h:
                errors.append(f"histograms.{name}: missing {key!r}")
        bc, b = h.get("bucket_counts"), h.get("buckets")
        if isinstance(bc, list) and isinstance(b, list) and len(bc) != len(b) + 1:
            errors.append(f"histograms.{name}: bucket_counts must have len(buckets)+1 entries")
        if isinstance(bc, list) and isinstance(h.get("count"), (int, float)) \
                and sum(bc) != h["count"]:
            errors.append(f"histograms.{name}: bucket_counts don't sum to count")
    return errors
