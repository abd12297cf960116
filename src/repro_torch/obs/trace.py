"""Trace spans: Chrome-trace / Perfetto JSON for the serving loop (own copy
of the reference ``repro/obs/trace.py``, cut to what the continuous
scheduler records).

``TraceRecorder`` buffers Trace Event Format events and returns them as
one Chrome-trace dict with :meth:`TraceRecorder.chrome_trace`:

* request-lifecycle spans: one Perfetto thread per request uid with
  ``request/queued`` -> ``request/prefill`` -> ``request/decode`` and a
  ``request/done`` instant, emitted at finish time from the request's
  ``RequestMetrics`` timestamps;
* engine spans: ``engine/decode_window`` per host sync, with the step count
  and the bytes read back in ``args``, split into ``engine/decode_step``;
  ``engine/prefill_chunk`` per chunk of a chunked prefill (its tokens and
  the job's position); ``sched/preempt`` and ``sched/resume`` instants with
  the swapped bytes;
* recall spans: the blocking top-up on the decode track and the staged
  recall on a DMA track. Their durations are modeled from page counts at
  ``MODEL_LINK_BW``; ``args`` carry the exact byte counts;
* counter tracks: ``speculation`` hit and correction rates per step.

:meth:`TraceRecorder.write` writes the trace as JSON, which
:func:`validate_chrome_trace` checks. The retrieval path's span names
(``recall/select``, ``recall/correction``, ``recall/topup``,
``recall/staged``, ``recall/reuse``, ``attn/compute``) are also
``torch.profiler`` ranges through :func:`annotate`, so a profile of the
card lines up with these spans by name.
"""
from __future__ import annotations

import contextlib
import json
from typing import Dict, List, Optional

import torch

# modeled host-to-card link rate for the recall spans' durations (the
# reference's value; the spans' args carry the exact bytes)
MODEL_LINK_BW = 20e9

SPAN_REQUEST_QUEUED = "request/queued"
SPAN_REQUEST_PREFILL = "request/prefill"
SPAN_REQUEST_DECODE = "request/decode"
SPAN_REQUEST_DONE = "request/done"
SPAN_DECODE_WINDOW = "engine/decode_window"
SPAN_DECODE_STEP = "engine/decode_step"
# one drafted-block verify iteration of the speculative decode window, with
# its live slots and proposed/accepted/committed token counts
SPAN_SPEC_VERIFY = "engine/spec_verify"
SPAN_PREFILL_CHUNK = "engine/prefill_chunk"
SPAN_SCHED_PREEMPT = "sched/preempt"
SPAN_SCHED_RESUME = "sched/resume"
SPAN_SCHED_CANCEL = "sched/cancel"
SPAN_RECALL_SELECT = "recall/select"
SPAN_RECALL_CORRECTION = "recall/correction"
SPAN_RECALL_TOPUP = "recall/topup"
SPAN_RECALL_STAGED = "recall/staged"
SPAN_RECALL_REUSE = "recall/reuse"
SPAN_ATTN_COMPUTE = "attn/compute"
# the spans ``annotate`` marks in the retrieval path (profiler ranges)
ANNOTATED_SPANS = (SPAN_RECALL_SELECT, SPAN_RECALL_CORRECTION, SPAN_RECALL_TOPUP,
                   SPAN_RECALL_STAGED, SPAN_RECALL_REUSE, SPAN_ATTN_COMPUTE)

# Perfetto pid/tid layout: one process for the engine, one for requests
PID_ENGINE = 1
PID_REQUESTS = 2
TID_ENGINE = 1
TID_DMA = 2


def annotate(name: str):
    """A ``torch.profiler`` range named ``name`` while a profiler runs, so
    the card's kernels inside it are attributed to the span (kernels
    launched on the side stream inside ``recall/staged`` included);
    otherwise ``contextlib.nullcontext()``, so outside a profile a span
    costs one flag read and no profiler op."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


class TraceRecorder:
    """Buffers Chrome-trace events; with ``enabled=False`` every method is a
    cheap no-op, so the recorder can be passed around unconditionally."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.events: List[dict] = []
        self._names: Dict[tuple, str] = {}
        if enabled:
            self._meta(PID_ENGINE, None, "process_name", "serve-engine")
            self._meta(PID_ENGINE, TID_ENGINE, "thread_name", "decode")
            self._meta(PID_ENGINE, TID_DMA, "thread_name", "recall-dma")
            self._meta(PID_REQUESTS, None, "process_name", "requests")

    @staticmethod
    def _us(t_s: float) -> float:
        return t_s * 1e6

    def _meta(self, pid: int, tid: Optional[int], what: str, name: str):
        ev = {"ph": "M", "pid": pid, "name": what, "args": {"name": name}}
        if tid is not None:
            ev["tid"] = tid
        self.events.append(ev)

    def name_request_track(self, uid: int) -> None:
        if not self.enabled or (PID_REQUESTS, uid) in self._names:
            return
        self._names[(PID_REQUESTS, uid)] = f"req {uid}"
        self._meta(PID_REQUESTS, uid, "thread_name", f"req {uid}")

    # -- event emitters (ts/dur in run-relative seconds) ------------------
    def complete(self, name: str, ts_s: float, dur_s: float, *,
                 pid: int = PID_ENGINE, tid: int = TID_ENGINE,
                 args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "ph": "X", "ts": self._us(ts_s),
              "dur": max(self._us(dur_s), 0.0), "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, ts_s: float, *, pid: int = PID_ENGINE,
                tid: int = TID_ENGINE, args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "ts": self._us(ts_s), "pid": pid,
              "tid": tid, "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, ts_s: float, values: Dict[str, float], *,
                pid: int = PID_ENGINE) -> None:
        if not self.enabled:
            return
        self.events.append({"name": name, "ph": "C", "ts": self._us(ts_s),
                            "pid": pid, "args": dict(values)})

    # -- high-level helpers ------------------------------------------------
    def request_lifecycle(self, rm) -> None:
        """queued/prefill/decode spans and the done instant of a finished
        request, from its ``RequestMetrics`` timestamps."""
        if not self.enabled:
            return
        uid = rm.uid
        self.name_request_track(uid)
        if rm.prefill_start_t is not None:
            self.complete(SPAN_REQUEST_QUEUED, rm.enqueue_t,
                          rm.prefill_start_t - rm.enqueue_t, pid=PID_REQUESTS, tid=uid,
                          args={"uid": uid, "prompt_tokens": rm.prompt_tokens})
        if rm.prefill_start_t is not None and rm.first_token_t is not None:
            self.complete(SPAN_REQUEST_PREFILL, rm.prefill_start_t,
                          rm.first_token_t - rm.prefill_start_t, pid=PID_REQUESTS, tid=uid,
                          args={"prefix_hit_tokens": rm.prefix_hit_tokens,
                                "padded": rm.padded_prompt_tokens})
        if rm.first_token_t is not None and rm.finish_t is not None:
            self.complete(SPAN_REQUEST_DECODE, rm.first_token_t,
                          rm.finish_t - rm.first_token_t, pid=PID_REQUESTS, tid=uid,
                          args={"new_tokens": rm.new_tokens})
        if rm.finish_t is not None:
            self.instant(SPAN_REQUEST_DONE, rm.finish_t, pid=PID_REQUESTS, tid=uid,
                         args={"uid": uid})

    def recall_step(self, ts_s: float, dur_s: float, *, sync_pages: float,
                    async_pages: float, reused_pages: float,
                    page_block_bytes: float) -> None:
        """One step's recall spans: the blocking top-up on the decode track,
        the staged recall for the next step on the DMA track, durations
        modeled as bytes / ``MODEL_LINK_BW``."""
        if not self.enabled:
            return
        if sync_pages > 0:
            b = sync_pages * page_block_bytes
            self.complete(SPAN_RECALL_TOPUP, ts_s, min(b / MODEL_LINK_BW, dur_s),
                          tid=TID_ENGINE, args={"pages": sync_pages, "bytes": b,
                                                "modeled": True})
        if async_pages > 0:
            b = async_pages * page_block_bytes
            self.complete(SPAN_RECALL_STAGED, ts_s, min(b / MODEL_LINK_BW, dur_s),
                          tid=TID_DMA, args={"pages": async_pages, "bytes": b,
                                             "modeled": True, "hidden": True})
        if reused_pages > 0:
            self.instant(SPAN_RECALL_REUSE, ts_s, tid=TID_DMA, args={"pages": reused_pages})

    # -- export --------------------------------------------------------------
    def chrome_trace(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms",
                "otherData": {"producer": "repro_torch.obs.trace"}}

    def write(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.chrome_trace(), f)


def validate_chrome_trace(doc: dict) -> List[str]:
    """Well-formedness of a Chrome trace, as Perfetto's loader needs it.
    Returns a list of problems (empty = valid)."""
    errors: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["missing traceEvents key"]
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        return ["traceEvents is not a list"]
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        for key in ("ph", "pid", "name"):
            if key not in ev:
                errors.append(f"event {i}: missing {key!r}")
        ph = ev.get("ph")
        if ph in ("X", "i", "C") and "ts" not in ev:
            errors.append(f"event {i}: {ph!r} event missing ts")
        if ph == "X":
            if "dur" not in ev or not isinstance(ev["dur"], (int, float)) or ev["dur"] < 0:
                errors.append(f"event {i}: X event needs dur >= 0")
            if "tid" not in ev:
                errors.append(f"event {i}: X event missing tid")
    return errors
