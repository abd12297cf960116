"""Continuous-batching scheduler: admission queue and per-slot request
lifecycle (reference ``repro/serving/scheduler.py``), for a batch handed
to ``run`` or, in service mode, for requests that arrive while others
decode.

Requests move QUEUED -> PREFILL -> DECODE -> DONE (and DECODE -> SWAPPED ->
DECODE under preemption); a request cancelled in any of these states ends
CANCELLED. Slots are refilled at
every host boundary, so a short request's completion frees capacity for
the next queued request instead of idling until the longest co-scheduled
request drains (the static engine's behaviour). Finished slots stop
contributing tokens or statistics the moment they drain.

Decode runs without host reads inside a window (``fkv.sample_on_device``,
the default): the scheduler keeps the loop carry (current tokens, the
requests' keys ``request_key(seed, uid)``, generated counts, limits, eos
ids, finished mask) on the card and hands it to ``backend.decode_window``,
which runs the window's steps (decode + sampling on the card, token ``i``
of a request drawn from ``fold_in(key, i)``) and leaves the (n, B) token,
valid and stat blocks on the card. At the window's end the host reads the blocks
once, appends tokens, frees and refills slots, and uploads the small lane
vectors only when one changed. Between reads nothing crosses the host
boundary (``EngineMetrics.summary()["dispatch"]``).

The window's length comes from the host copy of the lanes (``_Lanes``):
up to ``sync_interval`` steps, ending when every lane has reached its
limit or, with admissions queued, when the first one does; that is the
step count of the reference's on-card loop. An eos finish is seen only
when the window ends (``models.model.decode_window``): the lane is masked
on the card at once, so its tokens are exact, but with admissions queued
its slot is refilled at the window's end rather than at the eos step, and
``em.steps`` can then differ from the reference's. Where a step's rows
meet (``backend.rows_meet``: a MoE router's capacity is shared by the
step's tokens) that would change the other lanes' tokens, so while a live
lane has an eos the window reads the finished flags after every step and
stops where the reference's loop stops (one host read a step).

Under speculative decoding (``backend.spec_decode``) a window runs verify
iterations instead (``models.model.decode_window_spec``), each committing
1 to ``1 + draft_len`` tokens a lane, and its blocks are (n, 1 +
draft_len, B). The host cannot know when a lane reaches its limit then, so
the window gets the iterations the lanes would need if every draft were
rejected (``_Lanes.window_len``) and stops early, with no blocking read,
once the card's stop flag is seen (``decode_window_spec``'s docstring).
Each committed row is applied as one logical step; iterations in which
every lane was already finished count as ``spec_idle_iterations``. The
tokens equal ``draft_len=0``'s; ``em.steps`` and the turnover points may
differ (they follow the committed rows and the window ends).

``fkv.sample_on_device = False`` is the synchronous reference path: one
decode step and one host read per iteration. Tokens are the same on both
paths and for every ``sync_interval``.

Each round of the loop runs the reference's three passes before its decode
window:

* admission: queued requests fill free slots, FIFO; a SWAPPED request
  resumes (``resume``). With chunked prefill (``backend.prefill_chunk_tokens
  > 0``) an admitted request takes its slot and opens a
  ``backend.start_prefill_job``, its lane left finished until the job ends;
* preemption (``backend.preempt``): while a queued request's priority
  strictly exceeds the lowest-priority running request's, that victim's
  whole slot state is swapped out to host (``SlotPool.swap_out``), its slot
  goes to the candidate and it is queued again as SWAPPED; on resume
  ``swap_in`` restores the slot bit for bit and its lane is rebuilt from
  host bookkeeping, so its tokens equal an uninterrupted run's. Equal
  priorities never preempt;
* chunked prefill: at most ``prefill_chunk_tokens`` prompt tokens a round
  across the open jobs, oldest first; a finished job's state is in its slot
  and its request joins the decode lanes. Co-batched decoders wait at most
  about one chunk instead of a whole prefill.

The scheduler drives a backend (``ServeEngine``) exposing

    prefill_one(request, pool, slot) -> (logits (1, V), B=1 state,
                                         prefix_hit_tokens, padded_len)
    start_prefill_job(request, pool, slot) -> job (.advance/.done/.result)
    prefill_chunk_tokens, preempt
    step(state, tokens (B, 1)) -> (logits (B, V), state, stats)
    sample_slot(logits, key, count) -> tokens (1,)
    sample_lanes(logits, keys (B, 2), counts (B,)) -> tokens (B,)
    decode_window(state, loop, n, stop_turnover, read_finishes)
        -> (state, loop, toks, valid, stats, finite)
    page_block_bytes, sync_interval, sample_on_device, obs, recall_tracker,
    spec_decode, draft_len, rows_meet, slo_ttft_ms, slo_itl_ms, tp (the
    tensor-parallel shard count, for ``EngineMetrics.tp``; 1 if absent),
    mesh (its mesh, whose steps carry each shard's counts; None if absent)

Service mode (``run(..., service=svc)``, ``serving/frontend.EngineService``):
each round first takes ``svc.poll()``'s new requests into the queue and
``svc.drain_cancels()``'s uids into the cancellation pass, streams each
token and each terminal state back (``svc.emit_token``, ``svc.emit_finish``),
parks in ``svc.wait`` when there is nothing to do, and ends once the service
is closed and drained. A cancelled request releases what it holds: its
place in the queue, its swapped-out state, its held slot and open chunked
prefill, or its decode slot through the path a finish takes (the staged
recall dropped, the slot freed, the lane retired). With
``obs.timeseries`` set, the scheduler feeds the sliding-window board from
what it already reads at a window's end: no feed adds a read of the card.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.paging import state_bytes
from repro_torch.models.model import DECODE_STAT_KEYS, shard_stats
from repro_torch.obs.trace import (SPAN_DECODE_STEP, SPAN_DECODE_WINDOW, SPAN_PREFILL_CHUNK,
                                   SPAN_SCHED_CANCEL, SPAN_SCHED_PREEMPT, SPAN_SCHED_RESUME,
                                   SPAN_SPEC_VERIFY)
from repro_torch.serving.metrics import EngineMetrics, RequestMetrics
from repro_torch.serving.sampling import request_key

# stat keys the engine-level counters accumulate (per-request aggregation
# keeps the full tuple)
_PAGE_KEYS = ("sync_pages", "async_pages", "reused_pages", "sel_pages",
              "spec_hit_pages", "churn_pages")

QUEUED, PREFILL, DECODE, DONE = "queued", "prefill", "decode", "done"
SWAPPED = "swapped"           # preempted: the slot's state parked on the host
CANCELLED = "cancelled"       # terminal: the client gave the request up


def _swap_bytes(host_state) -> float:
    """Bytes of a swapped-out state, as the reference counts them: every
    leaf but ``pos_host``, the host's mirror of ``pos``, which the
    reference's state does not have."""
    return float(state_bytes({k: v for k, v in host_state.items() if k != "pos_host"}))


@dataclass
class _Tracked:
    req: object                       # engine.Request
    order: int                        # position in the submitted batch
    metrics: RequestMetrics
    state: str = QUEUED
    slot: int = -1
    tokens: List[int] = field(default_factory=list)
    prefill_s: float = 0.0
    decode_s: float = 0.0
    job: object = None                # open PrefillJob (chunked prefill)
    host_state: object = None         # swapped-out B=1 state (host tensors)
    flight_pages: float = 0.0         # staged recall suspended with the swap
    last_tok_t: Optional[float] = None  # run-relative time of the last token
    agg: Dict[str, float] = field(default_factory=lambda: {k: 0.0 for k in DECODE_STAT_KEYS})

    def finished(self) -> bool:
        if len(self.tokens) >= self.req.max_new_tokens:
            return True
        eos = self.req.eos_token
        return bool(self.tokens) and eos is not None and self.tokens[-1] == eos


def _per_shard(stats_np, key: str, s: int):
    """Slot ``s``'s ``key`` count in one step's stats, or one a shard where
    the step carries each shard's own (``models.model.SHARD_STAT_KEYS``)."""
    per = stats_np.get("shard_" + key)
    return stats_np[key][s] if per is None else per[..., s]


def _request_stats(agg: Dict[str, float]) -> dict:
    stats = dict(agg)
    if agg["kv_heads"] > 0:
        stats["correction_rate"] = agg["corrected"] / agg["kv_heads"]
        stats["mean_similarity"] = agg["sim_sum"] / agg["sim_cnt"] if agg["sim_cnt"] else 0.0
    if agg.get("sel_pages", 0) > 0:
        stats["spec_hit_rate"] = agg["spec_hit_pages"] / agg["sel_pages"]
    return stats


class _Lanes:
    """Host mirror of the decode-loop carry, one lane per slot. The card's
    copy is uploaded again (a few (B,) vectors) only when a lane changed at
    a boundary: admission, turnover."""

    FIELDS = ("cur", "key", "count", "limit", "eos", "fin")

    def __init__(self, num_slots: int, device):
        self.device = device
        self.cur = np.zeros(num_slots, np.int32)
        self.key = np.zeros((num_slots, 2), np.int64)   # uint32 words of request_key
        self.count = np.zeros(num_slots, np.int32)
        self.limit = np.ones(num_slots, np.int32)
        self.eos = np.full(num_slots, -1, np.int32)
        self.fin = np.ones(num_slots, bool)       # empty lanes are "finished"
        self.dirty = True
        self._dev = None

    def admit(self, slot: int, tok: int, key, count: int, limit: int, eos: Optional[int]):
        self.cur[slot] = tok
        self.key[slot] = np.asarray(key)
        self.count[slot] = count
        self.limit[slot] = limit
        self.eos[slot] = -1 if eos is None else eos
        self.fin[slot] = False
        self.dirty = True

    def retire(self, slot: int):
        self.fin[slot] = True
        self.dirty = True

    def window_len(self, k_max: int, stop_turnover: bool) -> int:
        """Steps the reference's on-card loop runs from these lanes when no
        eos fires: until every live lane reaches its limit, or the first
        one does when admissions are queued, at most ``k_max``. Under
        speculative decoding, an upper bound on its verify iterations (each
        commits at least one token a live lane)."""
        live = ~self.fin
        if not live.any():
            return 0
        left = (self.limit - self.count)[live]
        return int(min(k_max, left.min() if stop_turnover else left.max()))

    def device_loop(self, em: EngineMetrics):
        """The loop carry on the card; uploads the lanes only when dirty."""
        if self.dirty or self._dev is None:
            self._dev = {f: torch.from_numpy(getattr(self, f).copy()).to(self.device)
                         for f in self.FIELDS}
            em.sync_bytes_to_device += sum(getattr(self, f).nbytes for f in self.FIELDS)
            self.dirty = False
        return dict(self._dev)

    def carry_back(self, loop):
        """Keep the window's carry on the card for the next window (the host
        mirrors follow as the read tokens are applied)."""
        self._dev = {f: loop[f] for f in self.FIELDS}


class ContinuousScheduler:
    """Drives one run of requests to completion over a fixed slot pool."""

    def __init__(self, backend, pool):
        self.backend = backend
        self.pool = pool
        self.logits_finite: Optional[bool] = None   # live lanes' logits, whole run

    def run(self, requests, seed: int = 0, service=None):
        """Returns (tracked records in submission order, EngineMetrics).
        ``seed`` seeds the per-request sample streams (``request_key(seed,
        uid)``); greedy ignores it. ``service`` switches to service mode
        (module docstring): the run also takes the requests that arrive
        through it, and ends once it is closed and drained."""
        backend, pool = self.backend, self.pool
        on_device = backend.sample_on_device
        obs = backend.obs
        self._trace = obs.trace
        self._obs_enabled = obs.enabled
        board = obs.timeseries          # None: no windowed series
        self._page_block_bytes = backend.page_block_bytes
        t0 = time.perf_counter()
        self._t0 = t0
        now = lambda: time.perf_counter() - t0  # noqa: E731
        abst = lambda rel: t0 + rel             # noqa: E731  (the board's clock)

        queue: deque = deque()
        by_uid: Dict[int, _Tracked] = {}
        next_order = 0

        def track(r) -> _Tracked:
            nonlocal next_order
            rm = RequestMetrics(uid=r.uid, prompt_tokens=len(r.tokens),
                                max_new_tokens=r.max_new_tokens, priority=r.priority,
                                enqueue_t=now(), slo_ttft_ms=getattr(r, "slo_ttft_ms", None),
                                slo_itl_ms=getattr(r, "slo_itl_ms", None))
            tr = _Tracked(req=r, order=next_order, metrics=rm)
            next_order += 1
            by_uid[r.uid] = tr
            return tr

        for r in requests:
            queue.append(track(r))

        em = EngineMetrics(num_slots=pool.num_slots, scheduler="continuous",
                           page_block_bytes=backend.page_block_bytes,
                           sync_interval=backend.sync_interval if on_device else 1,
                           sample_on_device=on_device,
                           draft_len=int(getattr(backend, "draft_len", 0)),
                           tp=int(getattr(backend, "tp", 1)),
                           slo_ttft_ms=getattr(backend, "slo_ttft_ms", None),
                           slo_itl_ms=getattr(backend, "slo_itl_ms", None))
        svc = service
        if svc is not None:
            svc.attach(em, t0)
        # per-slot staged recall in flight: the buffer a slot carries out of
        # step t is consumed by step t+1 unless the slot turns over
        flight = backend.recall_tracker
        # each tensor-parallel shard's own sync/async page counts, where the
        # steps carry them (a mesh, ``models.model.SHARD_STAT_KEYS``)
        shard_pages = ({k: np.zeros(flight.shards) for k in ("sync", "async")}
                       if shard_stats(getattr(backend, "mesh", None)) else {})
        active: Dict[int, _Tracked] = {}
        prefilling: Dict[int, _Tracked] = {}    # slot -> request with an open chunked prefill
        chunk = int(backend.prefill_chunk_tokens)
        lanes = _Lanes(pool.num_slots, pool.device)
        done: List[_Tracked] = []
        self._step_idx = 0
        # every live lane's logits finite, kept on the card, read at the end
        self._finite = torch.ones((), dtype=torch.bool, device=pool.device)

        def finish(tr: _Tracked, slot: Optional[int]):
            tr.state = DONE
            tr.metrics.finish_t = now()
            tr.metrics.finish_step = self._step_idx
            tr.metrics.new_tokens = len(tr.tokens)
            tr.metrics.prefill_s = tr.prefill_s
            tr.metrics.decode_s = tr.decode_s
            em.record_request(tr.metrics)
            self._trace.request_lifecycle(tr.metrics)
            done.append(tr)
            if slot is not None:
                flight.invalidate(slot)   # staged buffer abandoned in flight
                pool.free(slot)
                lanes.retire(slot)
            if board is not None:
                board.event("completions", 1.0, abst(tr.metrics.finish_t))
            if svc is not None:
                svc.emit_finish(tr.req.uid, tr)

        def cancel_pass(uids):
            """The CANCELLED path (the client hung up): the request gives up
            what it holds and nothing is parked; the other requests' lanes,
            keys and states are untouched, so their tokens do not change.
            A cancelled request counts in no completion, latency or SLO."""
            for uid in uids:
                tr = by_uid.get(uid)
                if tr is None or tr.state in (DONE, CANCELLED):
                    continue
                slot = tr.slot if tr.slot >= 0 else None
                if tr.state in (QUEUED, SWAPPED):
                    queue.remove(tr)
                    tr.host_state = None          # the parked state goes with it
                    tr.flight_pages = 0.0
                elif tr.state == PREFILL and slot in prefilling:
                    del prefilling[slot]          # the open job and its held slot
                    tr.job = None
                    pool.free(slot)
                    lanes.retire(slot)
                elif tr.state == DECODE and slot in active:
                    del active[slot]              # as a finish releases it
                    flight.invalidate(slot)
                    pool.free(slot)
                    lanes.retire(slot)
                tr.state = CANCELLED
                tr.slot = -1
                tr.metrics.cancelled = True
                tr.metrics.finish_t = now()
                tr.metrics.finish_step = self._step_idx
                tr.metrics.new_tokens = len(tr.tokens)
                tr.metrics.prefill_s = tr.prefill_s
                tr.metrics.decode_s = tr.decode_s
                em.cancellations += 1
                self._trace.instant(SPAN_SCHED_CANCEL, tr.metrics.finish_t,
                                    args={"uid": uid, "slot": -1 if slot is None else slot,
                                          "tokens": len(tr.tokens)})
                if board is not None:
                    board.event("cancellations", 1.0, abst(tr.metrics.finish_t))
                done.append(tr)
                if svc is not None:
                    svc.emit_finish(uid, tr)

        def apply_step(stats_np, toks_np, live_slots, dt, ts, interpolated=False):
            """Host bookkeeping of ONE decode step (``ts``, ``dt``: its
            run-relative start and its share of the host's time): telemetry,
            token append, finish detection; shared by both dispatch modes.
            ``interpolated`` marks token times split out of one read (window
            and verify rows) in the events streamed to the service."""
            em.record_step(len(live_slots))
            for k in _PAGE_KEYS + ("corrected_heads", "kv_head_steps"):
                src = {"corrected_heads": "corrected", "kv_head_steps": "kv_heads"}.get(k, k)
                setattr(em, k, getattr(em, k) + float(sum(stats_np[src][s] for s in live_slots)))
            for s in live_slots:
                flight.note_step(s, _per_shard(stats_np, "async_pages", s),
                                 _per_shard(stats_np, "sync_pages", s),
                                 float(stats_np["reused_pages"][s]))
                if shard_pages:
                    for k in ("sync", "async"):
                        shard_pages[k] += _per_shard(stats_np, k + "_pages", s)
            if obs.enabled:
                em.observe_decode_step(dt)
                for s in live_slots:
                    em.observe_speculation(
                        float(stats_np["sel_pages"][s]), float(stats_np["spec_hit_pages"][s]),
                        float(stats_np["churn_pages"][s]), float(stats_np["corrected"][s]),
                        float(stats_np["kv_heads"][s]))
            if self._trace.enabled:
                self._trace_step(stats_np, live_slots, ts, dt)
            tok_t = ts + dt
            if board is not None:
                board.observe("decode_step_s", dt, abst(tok_t))
                board.observe("slot_occupancy", len(live_slots) / max(pool.num_slots, 1),
                              abst(tok_t))
                sel = float(sum(stats_np["sel_pages"][s] for s in live_slots))
                if sel > 0:
                    board.observe("spec_hit_rate",
                                  float(sum(stats_np["spec_hit_pages"][s] for s in live_slots))
                                  / sel, abst(tok_t))
            for s in live_slots:
                tr = active[s]
                tr.decode_s += dt
                for k in DECODE_STAT_KEYS:
                    tr.agg[k] += float(stats_np[k][s])
                tok = int(toks_np[s])
                tr.tokens.append(tok)
                lanes.cur[s] = tok
                lanes.count[s] += 1
                if tr.last_tok_t is not None:
                    gap = max(tok_t - tr.last_tok_t, 0.0)
                    em.observe_token_gap(gap)
                    tr.metrics.max_token_gap_s = max(tr.metrics.max_token_gap_s, gap)
                    if board is not None:
                        board.observe("itl_s", gap, abst(tok_t))
                tr.last_tok_t = tok_t
                if board is not None:
                    board.event("tokens", 1.0, abst(tok_t))
                if svc is not None:
                    svc.emit_token(tr.req.uid, len(tr.tokens) - 1, tok, tok_t,
                                   interpolated=interpolated)
                if tr.finished():
                    del active[s]
                    finish(tr, s)
            self._step_idx += 1

        def begin_decode(tr: _Tracked, slot: int, logits1, tp: Optional[float] = None):
            """The first token of a finished prefill, token 0 of the request's
            stream; the request joins the decode lanes. ``tp``: the
            whole-shot prefill's start, whose ``prefill_s`` runs to this
            read."""
            self._finite &= torch.isfinite(logits1).all()
            rkey = request_key(seed, tr.req.uid)
            tok = int(backend.sample_slot(logits1, rkey, 0)[0])     # the admission's read
            if tp is not None:
                tr.prefill_s = time.perf_counter() - tp
            tr.metrics.first_token_t = now()
            tr.last_tok_t = tr.metrics.first_token_t
            tr.tokens.append(tok)
            tr.state = DECODE
            tr.slot = slot
            if board is not None:
                t_abs = abst(tr.metrics.first_token_t)
                board.observe("ttft_s", tr.metrics.first_token_t - tr.metrics.enqueue_t, t_abs)
                board.event("tokens", 1.0, t_abs)
            if svc is not None:
                svc.emit_token(tr.req.uid, 0, tok, tr.metrics.first_token_t)
            if tr.finished():           # max_new_tokens == 1 or an instant eos
                finish(tr, slot)
            else:
                active[slot] = tr
                lanes.admit(slot, tok, rkey, 1, tr.req.max_new_tokens, tr.req.eos_token)

        def resume(tr: _Tracked):
            """Swap a preempted request's state back into a free slot; its
            lane (current token, count) is rebuilt from the host's copy, so
            its tokens go on as if never interrupted."""
            slot = pool.alloc(tr.req.uid)
            nbytes = _swap_bytes(tr.host_state)
            pool.swap_in(tr.host_state, slot)
            tr.host_state = None
            flight.restore(slot, tr.flight_pages)
            tr.flight_pages = 0.0
            lanes.admit(slot, tr.tokens[-1], request_key(seed, tr.req.uid), len(tr.tokens),
                        tr.req.max_new_tokens, tr.req.eos_token)
            tr.state = DECODE
            tr.slot = slot
            active[slot] = tr
            em.resumes += 1
            em.swap_in_bytes += nbytes
            if board is not None:
                board.event("swap_bytes", nbytes, abst(now()))
            self._trace.instant(SPAN_SCHED_RESUME, now(),
                                args={"uid": tr.req.uid, "slot": slot, "bytes": nbytes})

        def admit_one(tr: _Tracked):
            """Give the request a free slot: resume it, open its chunked
            prefill, or prefill it into the slot and take its first token."""
            if tr.state == SWAPPED:
                resume(tr)
                return
            if tr.req.max_new_tokens <= 0:
                finish(tr, None)
                return
            tr.state = PREFILL
            tr.metrics.prefill_start_t = now()
            if board is not None:
                board.observe("queue_wait_s", tr.metrics.prefill_start_t - tr.metrics.enqueue_t,
                              abst(tr.metrics.prefill_start_t))
            if chunk > 0:
                # the slot is held (its lane finished, its row stepping what
                # it held, as the reference's) while the job runs a budgeted
                # chunk a round (advance_prefill)
                slot = pool.alloc(tr.req.uid)
                tr.job = backend.start_prefill_job(tr.req, pool, slot)
                tr.slot = slot
                prefilling[slot] = tr
                return
            tp = time.perf_counter()
            slot = pool.alloc(tr.req.uid)
            logits1, state1, hit, padded = backend.prefill_one(tr.req, pool, slot)
            pool.insert(state1, slot)
            tr.metrics.prefix_hit_tokens = hit
            tr.metrics.padded_prompt_tokens = padded
            begin_decode(tr, slot, logits1, tp)

        def preempt_pass():
            """While a queued request's priority strictly exceeds the
            lowest-priority running request's, swap that victim out to the
            host and admit the candidate in its slot. Ends: each admission
            removes a queued request and queues only a strictly
            lower-priority one."""
            while queue and active:
                cand = max(queue, key=lambda t: (t.req.priority, -t.order))
                victim = min(active.values(), key=lambda t: (t.req.priority, -t.order))
                if cand.req.priority <= victim.req.priority:
                    return
                slot = victim.slot
                host = pool.swap_out(slot)
                nbytes = _swap_bytes(host)
                victim.host_state = host
                victim.flight_pages = flight.suspend(slot)
                del active[slot]
                pool.free(slot)
                lanes.retire(slot)
                victim.state = SWAPPED
                victim.slot = -1
                victim.metrics.preemptions += 1
                em.preemptions += 1
                em.swap_out_bytes += nbytes
                if board is not None:
                    t_abs = abst(now())
                    board.event("preemptions", 1.0, t_abs)
                    board.event("swap_bytes", nbytes, t_abs)
                self._trace.instant(SPAN_SCHED_PREEMPT, now(),
                                    args={"uid": victim.req.uid, "slot": slot,
                                          "bytes": nbytes, "by_uid": cand.req.uid})
                queue.append(victim)
                queue.remove(cand)
                admit_one(cand)

        def advance_prefill():
            """Spend at most one ``chunk`` budget across the open jobs, oldest
            first; a finished job's state is in its slot, and its request
            takes its first token."""
            budget = chunk
            for tr in sorted(prefilling.values(), key=lambda t: t.order):
                while budget > 0 and not tr.job.done:
                    tc = time.perf_counter()
                    n = tr.job.advance(budget)
                    dt = time.perf_counter() - tc
                    tr.prefill_s += dt
                    budget -= n
                    em.prefill_chunks += 1
                    em.prefill_chunk_tokens += n
                    self._trace.complete(SPAN_PREFILL_CHUNK, tc - t0, dt,
                                         args={"uid": tr.req.uid, "tokens": n,
                                               "pos": tr.job.pos, "total": len(tr.job.seq)})
                if tr.job.done:
                    slot = tr.slot
                    del prefilling[slot]
                    logits1, state1, hit, padded = tr.job.result
                    tr.job = None
                    pool.insert(state1, slot)
                    tr.metrics.prefix_hit_tokens = hit
                    tr.metrics.padded_prompt_tokens = padded
                    begin_decode(tr, slot, logits1)
                if budget <= 0:
                    break

        while queue or active or prefilling or (svc is not None and not svc.closed):
            # service mode: take the arrivals and the cancellations
            if svc is not None:
                for r in svc.poll():
                    queue.append(track(r))
                cancels = svc.drain_cancels()
                if cancels:
                    cancel_pass(cancels)
                em.wall_s = now()       # live tokens/s
            # admission: refill freed slots at the host boundary (FIFO)
            while queue and pool.free_count:
                admit_one(queue.popleft())
            # preemption: a strictly higher priority takes a running slot
            if backend.preempt and queue:
                preempt_pass()
            # chunked prefill: one token budget a round
            if prefilling:
                advance_prefill()
            if not active:
                if svc is not None and not (queue or prefilling):
                    svc.wait(0.002)     # idle: park until work arrives
                continue
            pool.flush_resets()          # lazily reset freed-but-idle slots
            if on_device:
                # work waiting in the service ends the window at the first
                # turnover, as a queued request does
                self._window_steps(backend, pool, em, lanes, apply_step,
                                   stop_turnover=bool(queue) or (svc is not None
                                                                 and svc.pending),
                                   flight=flight)
            else:
                self._sync_step(backend, pool, em, lanes, apply_step)

        em.wall_s = now()
        em.dropped_pages = flight.dropped_pages
        if shard_pages:
            em.shard_pages = {k: v.tolist() for k, v in shard_pages.items()}
            em.shard_pages["dropped"] = flight.shard_dropped.tolist()
        self.logits_finite = bool(self._finite)
        done.sort(key=lambda tr: tr.order)
        em.requests = [tr.metrics for tr in done]
        return done, em

    # ------------------------------------------------------------------
    # decode dispatch modes
    # ------------------------------------------------------------------
    def _trace_step(self, stats_np, live_slots, ts, dt):
        """One decode step's spans: the step on the decode track, its recall
        split, and the speculation counter track."""
        tr = self._trace
        agg = {k: float(sum(stats_np[k][s] for s in live_slots))
               for k in ("sync_pages", "async_pages", "reused_pages", "sel_pages",
                         "spec_hit_pages", "corrected", "kv_heads")}
        tr.complete(SPAN_DECODE_STEP, ts, dt,
                    args={"live_slots": len(live_slots), "sync_pages": agg["sync_pages"],
                          "async_pages": agg["async_pages"]})
        tr.recall_step(ts, dt, sync_pages=agg["sync_pages"], async_pages=agg["async_pages"],
                       reused_pages=agg["reused_pages"],
                       page_block_bytes=self._page_block_bytes)
        tr.counter("speculation", ts, {
            "hit_rate": agg["spec_hit_pages"] / agg["sel_pages"] if agg["sel_pages"] else 0.0,
            "correction_rate": agg["corrected"] / agg["kv_heads"] if agg["kv_heads"] else 0.0})

    @staticmethod
    def _read(blocks: List[torch.Tensor]) -> List[np.ndarray]:
        """One device-to-host read for several small blocks (float64 holds
        every token id, mask and stat exactly)."""
        flat = torch.cat([b.reshape(-1).to(torch.float64) for b in blocks]).cpu().numpy()
        out, i = [], 0
        for b in blocks:
            out.append(flat[i: i + b.numel()].reshape(tuple(b.shape)))
            i += b.numel()
        return out

    def _window_steps(self, backend, pool, em, lanes, apply_step, stop_turnover: bool,
                      flight=None):
        """Run one window without host reads, then read its blocks once and
        apply them step by step (verify iterations row by row)."""
        n = lanes.window_len(backend.sync_interval, stop_turnover)
        # where rows meet in a MoE router, an eos finish the host cannot plan
        # changes who shares the next steps: read the finishes every step
        read = (backend.rows_meet and not backend.spec_decode
                and bool((lanes.eos[~lanes.fin] >= 0).any()))
        loop = lanes.device_loop(em)
        ts = time.perf_counter()
        ts_rel = ts - self._t0
        state, loop, toks, valid, stats, finite = backend.decode_window(
            pool.state, loop, n, stop_turnover, read_finishes=read)
        if read:
            em.host_syncs += toks.shape[0]
        pool.state = state
        lanes.carry_back(loop)
        self._finite &= finite.all()
        toks_np, valid_np, *stat_np = self._read([toks, valid] + list(stats.values()))
        stats_np = dict(zip(stats, stat_np))
        dt = time.perf_counter() - ts
        em.host_syncs += 1
        pulled = 8 * (toks.numel() + valid.numel() + sum(b.numel() for b in stats.values()))
        em.sync_bytes_to_host += pulled
        n = toks_np.shape[0]
        self._trace.complete(SPAN_DECODE_WINDOW, ts_rel, dt,
                             args={"steps": n, "bytes_to_host": pulled})
        per_dt = dt / max(n, 1)
        if toks_np.ndim == 3:
            self._apply_spec_blocks(pool, em, toks_np, valid_np, stats_np, apply_step,
                                    flight, ts_rel, per_dt)
            return
        for j in range(n):
            live = [int(s) for s in np.nonzero(valid_np[j])[0]]
            if live:        # rows after an eos finished every lane: nothing to apply
                apply_step({k: b[j] for k, b in stats_np.items()}, toks_np[j], live,
                           per_dt, ts=ts_rel + j * per_dt, interpolated=True)

    def _apply_spec_blocks(self, pool, em, toks_np, valid_np, stats_np, apply_step, flight,
                           ts_rel, per_dt):
        """Apply a speculative window's (n, S, B) blocks (reference
        ``scheduler.py:646-691``): iteration j committed, a slot, the rows r
        with ``valid[j, r, slot]``, an accepted prefix, so row 0's live set
        is the iteration's. Each committed row is one logical decode step;
        the timestamps split the iteration's share of the window. An
        iteration with no live row ran after every lane had finished: it
        counts in ``spec_idle_iterations``."""
        n, S = toks_np.shape[:2]
        dl = S - 1
        # pos_host follows the committed rows (the window's rewinds moved pos)
        pool.state["pos_host"] += torch.from_numpy(
            valid_np.sum(axis=(0, 1)).astype(np.int32))
        for j in range(n):
            rows = [(r, [int(s) for s in np.nonzero(valid_np[j, r])[0]]) for r in range(S)]
            rows = [(r, live) for r, live in rows if live]
            if not rows:
                em.spec_idle_iterations += 1
                continue
            base = rows[0][1]
            committed = sum(len(live) for _, live in rows)
            em.spec_verify_steps += 1
            em.spec_slot_steps += len(base)
            em.spec_proposed_tokens += dl * len(base)
            em.spec_accepted_tokens += committed - len(base)
            em.spec_committed_tokens += committed
            ts_j = ts_rel + j * per_dt
            if self._obs_enabled:
                em.observe_spec_step(committed / len(base))
            self._trace.complete(SPAN_SPEC_VERIFY, ts_j, per_dt,
                                 args={"live_slots": len(base), "proposed": dl * len(base),
                                       "accepted": committed - len(base),
                                       "committed": committed})
            # rejected rows' recall was streamed for a continuation that never
            # commits: dropped in flight (the rollback recall re-stages)
            if flight is not None and dl:
                rej = sum(_per_shard({k: b[j, r] for k, b in stats_np.items()}, key, s)
                          for key in ("async_pages", "sync_pages")
                          for r in range(1, S) for s in base if not valid_np[j, r, s])
                if np.any(rej):
                    flight.drop(rej)
            sub = per_dt / len(rows)
            for i, (r, live) in enumerate(rows):
                apply_step({k: b[j, r] for k, b in stats_np.items()}, toks_np[j, r], live,
                           sub, ts=ts_j + i * sub, interpolated=True)

    def _sync_step(self, backend, pool, em, lanes, apply_step):
        """Synchronous reference mode: one decode step, one host read."""
        loop = lanes.device_loop(em)
        ts = time.perf_counter()
        ts_rel = ts - self._t0
        logits, state, stats = backend.step(pool.state, loop["cur"][:, None])
        toks = backend.sample_lanes(logits, loop["key"], loop["count"])
        live = ~loop["fin"]
        self._finite &= (torch.isfinite(logits).all(dim=-1) | ~live).all()
        toks_np, *stat_np = self._read([toks] + list(stats.values()))
        stats_np = dict(zip(stats, stat_np))
        dt = time.perf_counter() - ts
        pool.state = state
        em.host_syncs += 1
        em.sync_bytes_to_host += 8 * (toks.numel() + sum(b.numel() for b in stats.values()))
        # cur and count change every step on this path: upload them again
        # (the per-step round trip the window removes)
        lanes.dirty = True
        apply_step(stats_np, toks_np, [int(s) for s in np.nonzero(~lanes.fin)[0]], dt, ts=ts_rel)
