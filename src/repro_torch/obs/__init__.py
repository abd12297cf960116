"""Observability of the serving loop (reference ``repro/obs``):

* :mod:`repro_torch.obs.registry`: counters, gauges and fixed-bucket
  histograms, the store behind ``serving/metrics.EngineMetrics``;
* :mod:`repro_torch.obs.trace`: the Chrome-trace span recorder for the
  request lifecycle and the recall.

The reference's sliding-window board (``repro/obs/timeseries.py``) and its
profiler annotations are not ported yet (ROADMAP queue 1, "Observability,
cancellation, SLOs and the front-end").
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.obs.trace import TraceRecorder


@dataclass
class Observability:
    """Run-level switches handed to ``ServeEngine``. ``enabled`` gates the
    per-step histograms and trace work in the scheduler (the counters of
    ``EngineMetrics`` always run); ``trace`` is the span recorder."""

    enabled: bool = True
    trace: TraceRecorder = field(default_factory=lambda: TraceRecorder(enabled=False))

    @classmethod
    def off(cls) -> "Observability":
        return cls(enabled=False, trace=TraceRecorder(enabled=False))

    @classmethod
    def full(cls) -> "Observability":
        return cls(enabled=True, trace=TraceRecorder(enabled=True))
