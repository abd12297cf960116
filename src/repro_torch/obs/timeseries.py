"""Sliding-window time series over the serving telemetry (own copy of the
reference ``repro/obs/timeseries.py``, pure Python).

The registry (``obs.registry``) is cumulative over a run; a live service
also needs "what are p99 TTFT and tokens/s *right now*": rolling
statistics over the last W seconds, old samples evicted as time moves on.

* :class:`WindowStat`: a bounded deque of ``(t, value)`` samples inside a
  sliding window, with exact rolling min/mean/max and exact p50/p90/p99
  over the samples in the window (numpy's ``linear`` interpolation). Fed
  with TTFT, the inter-token gaps, queue wait, decode-step time, slot
  occupancy and the speculative hit rate.
* :class:`WindowRate`: a bounded deque of ``(t, weight)`` events giving a
  rolling events/s and weight/s over the window, and exact totals. Fed
  with tokens, completions, cancellations, preemptions and swapped bytes.
* :class:`TimeSeriesBoard`: a named get-or-create collection of both with
  a schema-versioned :meth:`TimeSeriesBoard.snapshot`, the payload the
  HTTP front-end serves at ``/stats`` (``validate_timeseries_snapshot``).

The scheduler's thread feeds the board (``serving/scheduler.py``, from
what it already reads at a window's end) while the front-end's thread
snapshots it, so one lock covers both. Timestamps share one clock
(``time.perf_counter`` by default; the scheduler feeds ``run_t0 +
run-relative t``); eviction is by time, and ``max_samples`` only caps
memory under extreme rates. :data:`SERIES` names the serving series; the
board takes any name.
"""
from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

TIMESERIES_SCHEMA_VERSION = 1

# default sliding window (seconds): short enough that smoke runs fill and
# rotate it, long enough to smooth the bursts at window ends
DEFAULT_WINDOW_S = 10.0
# ring-buffer bound per series: memory cap, NOT the window semantics
DEFAULT_MAX_SAMPLES = 8192

# the serving series the scheduler feeds whenever a board is attached
SERIES = {
    "stats": {
        "ttft_s": "enqueue -> first token, per finished first token",
        "itl_s": "per-token inter-token gap",
        "queue_wait_s": "enqueue -> prefill start",
        "decode_step_s": "per decode step latency",
        "slot_occupancy": "live slots / pool size, sampled per step",
        "spec_hit_rate": "per-step speculative page-hit rate",
    },
    "rates": {
        "tokens": "generated tokens (weight 1 per token) -> tokens/s",
        "completions": "finished requests",
        "cancellations": "client-cancelled requests",
        "preemptions": "requests swapped out to host",
        "swap_bytes": "weight = bytes swapped out+in",
    },
}


def _percentile_sorted(vals, q: float) -> float:
    """numpy's 'linear' percentile over an already-sorted list, q in [0,1],
    in numpy's own arithmetic (its virtual index and its two-sided lerp), so
    it equals ``np.percentile`` bit for bit. The reference's ``a * (1 - t) +
    b * t`` can land an ulp off between equal samples, and p50 then exceeds
    p90 (a decode window's steps share one time): the lerp never does."""
    n = len(vals)
    if n == 0:
        return 0.0
    if n == 1:
        return float(vals[0])
    pos = (n - 1) * q
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    t = pos - lo
    a, b = vals[lo], vals[hi]
    d = b - a
    return float(b - d * (1.0 - t) if t >= 0.5 else a + d * t)


class WindowStat:
    """Rolling value distribution over a sliding time window.

    Samples are ``(t, v)`` pairs in a bounded deque (ring buffer); every
    read first evicts samples older than ``now - window_s``. Percentiles
    are exact over the surviving samples (numpy-``linear``)."""

    __slots__ = ("name", "window_s", "samples")

    def __init__(self, name: str, window_s: float = DEFAULT_WINDOW_S,
                 max_samples: int = DEFAULT_MAX_SAMPLES):
        if window_s <= 0:
            raise ValueError(f"{name}: window_s must be positive")
        self.name = name
        self.window_s = float(window_s)
        self.samples: deque = deque(maxlen=max_samples)

    def observe(self, v: float, t: float) -> None:
        self.samples.append((float(t), float(v)))

    def _trim(self, now: float) -> None:
        cutoff = now - self.window_s
        s = self.samples
        while s and s[0][0] < cutoff:
            s.popleft()

    def values(self, now: float) -> list:
        self._trim(now)
        return [v for _, v in self.samples]

    def summary(self, now: float) -> dict:
        vals = sorted(self.values(now))
        n = len(vals)
        return {
            "window_s": self.window_s,
            "count": n,
            "mean": sum(vals) / n if n else 0.0,
            "min": vals[0] if n else 0.0,
            "max": vals[-1] if n else 0.0,
            "p50": _percentile_sorted(vals, 0.50),
            "p90": _percentile_sorted(vals, 0.90),
            "p99": _percentile_sorted(vals, 0.99),
        }


class WindowRate:
    """Rolling event/weight rate over a sliding time window, plus exact
    cumulative totals (the totals never evict, so they match the registry
    counters)."""

    __slots__ = ("name", "window_s", "samples", "total_events",
                 "total_weight")

    def __init__(self, name: str, window_s: float = DEFAULT_WINDOW_S,
                 max_samples: int = DEFAULT_MAX_SAMPLES):
        if window_s <= 0:
            raise ValueError(f"{name}: window_s must be positive")
        self.name = name
        self.window_s = float(window_s)
        self.samples: deque = deque(maxlen=max_samples)
        self.total_events = 0
        self.total_weight = 0.0

    def event(self, weight: float = 1.0, t: float = 0.0) -> None:
        self.samples.append((float(t), float(weight)))
        self.total_events += 1
        self.total_weight += float(weight)

    def _trim(self, now: float) -> None:
        cutoff = now - self.window_s
        s = self.samples
        while s and s[0][0] < cutoff:
            s.popleft()

    def summary(self, now: float) -> dict:
        self._trim(now)
        events = len(self.samples)
        weight = sum(w for _, w in self.samples)
        return {
            "window_s": self.window_s,
            "events": events,
            "weight": weight,
            "events_per_s": events / self.window_s,
            "weight_per_s": weight / self.window_s,
            "total_events": self.total_events,
            "total_weight": self.total_weight,
        }


class TimeSeriesBoard:
    """Named sliding-window series with a schema-versioned snapshot.

    Thread-safe: the scheduler thread feeds ``observe``/``event`` while the
    front-end thread snapshots — one lock covers both (feeds are a deque
    append under the lock; snapshots trim + sort, still cheap at ring-bound
    sizes)."""

    def __init__(self, window_s: float = DEFAULT_WINDOW_S,
                 max_samples: int = DEFAULT_MAX_SAMPLES,
                 clock: Callable[[], float] = time.perf_counter):
        self.window_s = float(window_s)
        self.max_samples = int(max_samples)
        self.clock = clock
        self._stats: Dict[str, WindowStat] = {}
        self._rates: Dict[str, WindowRate] = {}
        self._lock = threading.Lock()

    # -- get-or-create -------------------------------------------------
    def stat(self, name: str,
             window_s: Optional[float] = None) -> WindowStat:
        s = self._stats.get(name)
        if s is None:
            with self._lock:
                s = self._stats.get(name)
                if s is None:
                    s = self._stats[name] = WindowStat(
                        name, window_s or self.window_s, self.max_samples)
        return s

    def rate(self, name: str,
             window_s: Optional[float] = None) -> WindowRate:
        r = self._rates.get(name)
        if r is None:
            with self._lock:
                r = self._rates.get(name)
                if r is None:
                    r = self._rates[name] = WindowRate(
                        name, window_s or self.window_s, self.max_samples)
        return r

    # -- feeding (scheduler thread) -------------------------------------
    def observe(self, name: str, v: float, t: Optional[float] = None) -> None:
        s = self.stat(name)                    # creation has its own locking
        with self._lock:
            s.observe(v, self.clock() if t is None else t)

    def event(self, name: str, weight: float = 1.0,
              t: Optional[float] = None) -> None:
        r = self.rate(name)
        with self._lock:
            r.event(weight, self.clock() if t is None else t)

    # -- snapshot (front-end thread) ------------------------------------
    def snapshot(self, now: Optional[float] = None,
                 extra: Optional[dict] = None) -> dict:
        now = self.clock() if now is None else now
        with self._lock:
            snap = {
                "schema_version": TIMESERIES_SCHEMA_VERSION,
                "unix_time": time.time(),
                "now": now,
                "window_s": self.window_s,
                "stats": {n: s.summary(now)
                          for n, s in sorted(self._stats.items())},
                "rates": {n: r.summary(now)
                          for n, r in sorted(self._rates.items())},
            }
        if extra:
            snap["extra"] = extra
        return snap

    def snapshot_line(self, now: Optional[float] = None,
                      extra: Optional[dict] = None) -> str:
        return json.dumps(self.snapshot(now, extra), sort_keys=True)


_STAT_KEYS = ("window_s", "count", "mean", "min", "max", "p50", "p90", "p99")
_RATE_KEYS = ("window_s", "events", "weight", "events_per_s", "weight_per_s",
              "total_events", "total_weight")


def validate_timeseries_snapshot(snap: dict) -> list:
    """Schema check for :meth:`TimeSeriesBoard.snapshot` dicts (shared by
    tests, ``tools/check_obs.py`` and the ``/stats`` endpoint validation).
    Returns a list of problems (empty = valid)."""
    errors = []
    if not isinstance(snap, dict):
        return ["timeseries snapshot is not an object"]
    if snap.get("schema_version") != TIMESERIES_SCHEMA_VERSION:
        errors.append(f"schema_version != {TIMESERIES_SCHEMA_VERSION}")
    for key in ("unix_time", "now", "window_s"):
        if not isinstance(snap.get(key), (int, float)):
            errors.append(f"missing/non-numeric {key!r}")
    for sect, keys in (("stats", _STAT_KEYS), ("rates", _RATE_KEYS)):
        body = snap.get(sect)
        if not isinstance(body, dict):
            errors.append(f"missing section {sect!r}")
            continue
        for name, entry in body.items():
            if not isinstance(entry, dict):
                errors.append(f"{sect}.{name}: not an object")
                continue
            for k in keys:
                v = entry.get(k)
                if not isinstance(v, (int, float)) or not math.isfinite(v):
                    errors.append(f"{sect}.{name}.{k}: missing or "
                                  "non-finite")
            if sect == "stats" and all(
                    isinstance(entry.get(p), (int, float))
                    for p in ("p50", "p90", "p99")):
                if not entry["p50"] <= entry["p90"] <= entry["p99"]:
                    errors.append(f"stats.{name}: percentiles not monotone")
            if sect == "rates" and isinstance(entry.get("events"), (int,
                                                                    float)):
                if entry["events"] < 0 or entry.get("total_events", 0) \
                        < entry["events"]:
                    errors.append(f"rates.{name}: window events exceed "
                                  "totals")
    return errors
