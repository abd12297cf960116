"""Overlapped double-buffered recall (§4), reference
``repro/core/recall_pipeline.py:56-150``.

Each decode step's transfer splits into
  * reuse: newly selected pages already in the previous buffer (no bytes),
  * a correction top-up on the critical path: corrected heads' pages that
    are not resident, and
  * a staged recall of everything else, which becomes the next step's
    buffer.

On the card the staged recall runs on a side CUDA stream — the card's form
of the paper's double buffer. Its rules: the side stream waits on the main
stream before it launches (completed pool pages are written on the main
stream); tensors that cross streams get ``record_stream``; the staged output
is a fresh tensor that never aliases the buffer this step's attention reads;
and the next step waits on ``PipelinedRecall.ready`` before it reads the
staged buffer (``FreeKVRetriever`` keeps the event in the layer state). On
the CPU there are no streams and the same code runs in order; on the meta
device too (a counted step: the same ops and kernels, nothing to overlap).

Guarantee, bit for bit: ``staged == fresh`` and
``use == where(corr, fresh, stale)``.

ShadowKV's V-only variant (``step_values``) selects afresh every step, so
everything non-resident is a critical-path fetch: it runs on the main
stream, and only buffer hits skip the transfer.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core import recall
from repro_torch.obs.trace import (SPAN_RECALL_REUSE, SPAN_RECALL_STAGED, SPAN_RECALL_TOPUP,
                                   annotate)


def match_resident(new_idx, prev_idx):
    """Which newly selected pages already sit in the previous buffer.

    new_idx/prev_idx (B, kv, n_sel) int32, -1 invalid -> (hit bool, src
    int32): for a hit, ``src`` is the page's position in the previous
    buffer. ``argmax`` over the int-cast match gives the first match, as
    ``jnp.argmax`` of a boolean does."""
    eq = ((new_idx[..., :, None] == prev_idx[..., None, :])
          & (new_idx >= 0)[..., :, None] & (prev_idx >= 0)[..., None, :])
    hit = eq.any(dim=-1)
    src = torch.argmax(eq.to(torch.int32), dim=-1).to(torch.int32)
    return hit, src


def _take_pages(buf, src):
    """Gather buffer pages (B, kv, n_sel, p, d) at per-slot positions src."""
    index = src.long()[..., None, None].expand(*src.shape, *buf.shape[3:])
    return torch.gather(buf, 2, index)


@dataclass
class PipelinedRecall:
    """One decode step's transfer plan and results."""
    use_k: Optional[torch.Tensor]     # buffer this step's attention reads
    use_v: torch.Tensor                 # (no K buffer for a V-only step)
    use_idx: torch.Tensor
    staged_k: Optional[torch.Tensor]  # next step's buffer == fresh recall, bit-exact
    staged_v: torch.Tensor
    topup_blocks: torch.Tensor   # (B,) critical-path (kv-head, page) fetches
    staged_blocks: torch.Tensor  # (B,) overlapped fetches
    reused_blocks: torch.Tensor  # (B,) buffer hits
    ready: Optional[object] = None  # CUDA event: staged buffer written


# One side stream per device for the whole process: the caching allocator
# keeps its blocks per stream, so a fresh stream every step would miss the
# cache and call cudaMalloc on every staged recall.
_SIDE_STREAMS = {}


def side_stream(device):
    """The staged-recall stream of ``device``."""
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device=device)
    return _SIDE_STREAMS[device]


class RecallExecutor:
    """Double-buffered recall over one ``recall_fn(pool, idx) -> (k, v)``
    and, for V-only steps, one ``values_fn(pool, idx) -> v``; ``pool`` is
    passed through untouched (the fp pool, or the quantized tier's
    ``paging.QuantPool``)."""

    def __init__(self, recall_fn=None, values_fn=None):
        self.recall_fn = recall_fn or recall.recall_pages
        self.values_fn = values_fn or recall.recall_values_only

    def recall(self, pool, idx):
        """Full blocking recall (prefill and the synchronous path)."""
        return self.recall_fn(pool, idx)

    def step(self, pool, new_idx, prev_idx, prev_k, prev_v, need) -> PipelinedRecall:
        """Plan and run one overlapped step. ``need`` (B, kv) bool marks the
        heads whose fresh pages THIS step's attention must see."""
        dt = prev_k.dtype
        hit, src = match_resident(new_idx, prev_idx)
        with annotate(SPAN_RECALL_REUSE):
            reused_k = _take_pages(prev_k, src)
            reused_v = _take_pages(prev_v, src)
        valid = new_idx >= 0
        need3 = need[:, :, None]
        hit5 = hit[..., None, None]
        need5 = need3[..., None, None]
        neg = torch.full_like(new_idx, -1)

        # critical path: corrected heads' non-resident pages only
        topup_idx = torch.where(need3 & ~hit & valid, new_idx, neg)
        with annotate(SPAN_RECALL_TOPUP):
            tk, tv = self.recall_fn(pool, topup_idx)
        tk, tv = tk.to(dt), tv.to(dt)
        # overlapped: everything else that is fresh and non-resident
        stage_idx = torch.where(~need3 & ~hit & valid, new_idx, neg)

        ready = None
        if new_idx.is_cuda:
            main = torch.cuda.current_stream(new_idx.device)
            side = side_stream(new_idx.device)
            side.wait_stream(main)
            for t in (stage_idx, reused_k, reused_v, tk, tv, hit5, need5):
                t.record_stream(side)
            # the fp pool, or the quantized tier's payload and scales
            for t in (pool if isinstance(pool, tuple) else (pool,)):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(side)
            ctx = torch.cuda.stream(side)
        else:
            ctx = contextlib.nullcontext()
        # the span opens on the side stream, so its kernels are attributed to it
        with ctx, annotate(SPAN_RECALL_STAGED):
            sk, sv = self.recall_fn(pool, stage_idx)
            fresh_k = torch.where(hit5, reused_k, torch.where(need5, tk, sk.to(dt)))
            fresh_v = torch.where(hit5, reused_v, torch.where(need5, tv, sv.to(dt)))
        if new_idx.is_cuda:
            fresh_k.record_stream(main)
            fresh_v.record_stream(main)
            ready = torch.cuda.Event()
            ready.record(side)

        # for need heads fresh == where(hit, reused, topup): computed here on
        # the main stream so attention never waits for the staged recall
        use_k = torch.where(need5, torch.where(hit5, reused_k, tk), prev_k)
        use_v = torch.where(need5, torch.where(hit5, reused_v, tv), prev_v)
        use_idx = torch.where(need3, new_idx, prev_idx)
        return PipelinedRecall(
            use_k=use_k, use_v=use_v, use_idx=use_idx,
            staged_k=fresh_k, staged_v=fresh_v,
            topup_blocks=(topup_idx >= 0).sum(dim=(1, 2)),
            staged_blocks=(stage_idx >= 0).sum(dim=(1, 2)),
            reused_blocks=hit.sum(dim=(1, 2)),
            ready=ready)


    def step_values(self, pool, new_idx, prev_idx, prev_v) -> PipelinedRecall:
        """ShadowKV's V-only delta fetch against the previous buffer
        (reference ``recall_pipeline.py:152``): pages resident in ``prev_v``
        are reused bit-exactly, the rest are fetched on the current stream;
        the composed buffer is both this step's and the next step's. There
        is no K buffer (``use_k``/``staged_k`` are None) and no event."""
        dt = prev_v.dtype
        hit, src = match_resident(new_idx, prev_idx)
        reused_v = _take_pages(prev_v, src)
        fetch_idx = torch.where(~hit & (new_idx >= 0), new_idx, torch.full_like(new_idx, -1))
        fv = self.values_fn(pool, fetch_idx).to(dt)
        fresh_v = torch.where(hit[..., None, None], reused_v, fv)
        return PipelinedRecall(
            use_k=None, use_v=fresh_v, use_idx=new_idx,
            staged_k=None, staged_v=fresh_v,
            topup_blocks=(fetch_idx >= 0).sum(dim=(1, 2)),
            staged_blocks=torch.zeros((new_idx.shape[0],), dtype=torch.int64,
                                      device=new_idx.device),
            reused_blocks=hit.sum(dim=(1, 2)))


def wait_staged(state):
    """Make the current stream wait for the staged buffer of the previous
    step (no-op on the CPU or when nothing is in flight). A layer served
    with KV-head-group TP holds one such event a shard, ``"<s>/sel_ready"``
    (``core/sharded_retrieval``); each is waited for on its shard's device."""
    for key in [k for k in state if k.endswith("sel_ready")]:
        ev = state.pop(key)
        if ev is not None:
            buf = state[key[:-len("sel_ready")] + "sel_k"]
            torch.cuda.current_stream(buf.device).wait_event(ev)


class RecallFlightTracker:
    """Host-side per-slot accounting of the staged recall in flight
    (reference ``recall_pipeline.py:174``).

    The staged buffer a slot carries out of step t is consumed by step t+1,
    unless the slot turns over at the boundary (its request finished, the
    slot was freed or refilled): then the pages in flight were streamed for
    nothing. The continuous scheduler feeds the tracker each step, from the
    stat blocks it reads at a sync, and invalidates a slot when it frees
    it; the dropped total lands in ``EngineMetrics.summary()
    ["recall_overlap"]``.

    Under tensor-parallel serving (``shards > 1``) each step's staged and
    topped-up counts come a shard, from each shard's own counters
    (``core/sharded_retrieval``), and every count is kept a shard: the
    ``shard_*`` arrays measure what each shard's link moved, and
    ``summary()["shards"]`` lists them. ``summary()["per_shard"]`` is the
    reference's view, each total over ``shards``."""

    def __init__(self, shards: int = 1):
        self.shards = max(shards, 1)
        self._in_flight = {}
        self.shard_staged = np.zeros(self.shards)
        self.shard_topup = np.zeros(self.shards)
        self.shard_dropped = np.zeros(self.shards)
        self.reused_pages = 0.0

    @property
    def staged_pages(self) -> float:
        return float(self.shard_staged.sum())

    @property
    def topup_pages(self) -> float:
        return float(self.shard_topup.sum())

    @property
    def dropped_pages(self) -> float:
        return float(self.shard_dropped.sum())

    def _per_shard(self, pages) -> np.ndarray:
        """A count, or one a shard, as a (shards,) array (a lone count is
        refused where there are several shards)."""
        return np.asarray(pages, dtype=np.float64).reshape(self.shards)

    def note_step(self, slot: int, staged, topup=0.0, reused: float = 0.0):
        """One step's transfer split for ``slot``: its staged pages replace
        (consume) what the slot had in flight. ``staged``/``topup``: a count
        or, with several shards, one a shard."""
        staged = self._per_shard(staged)
        self._in_flight[slot] = staged
        self.shard_staged += staged
        self.shard_topup += self._per_shard(topup)
        self.reused_pages += reused

    def invalidate(self, slot: int):
        """Slot turnover: the staged buffer is abandoned in flight."""
        self.shard_dropped += self._in_flight.pop(slot, 0.0)

    def drop(self, pages):
        """Pages streamed for work discarded without touching the slot's
        carried buffer: a speculative verify row whose draft was rejected
        staged (and topped up) for a continuation that never commits; the
        rollback recall re-stages from the last committed row. A count or
        one a shard."""
        self.shard_dropped += np.maximum(self._per_shard(pages), 0.0)

    def suspend(self, slot: int):
        """Preemption swap-out: the staged buffer lives in the ``sel_k`` /
        ``sel_v`` leaves and travels to the host with the rest of the slot's
        state, so its pages are not dropped. Returns the count for
        ``restore``."""
        return self._in_flight.pop(slot, 0.0)

    def restore(self, slot: int, staged):
        """Preemption swap-in: reattach a suspended count to the slot the
        request resumed into."""
        if np.any(staged):
            self._in_flight[slot] = staged

    def summary(self) -> dict:
        moved = self.staged_pages + self.topup_pages
        return {"staged_pages": self.staged_pages, "topup_pages": self.topup_pages,
                "reused_pages": self.reused_pages, "dropped_pages": self.dropped_pages,
                "hidden_fraction": self.staged_pages / moved if moved else 0.0,
                "per_shard": {"shards": self.shards,
                              "staged_pages": self.staged_pages / self.shards,
                              "topup_pages": self.topup_pages / self.shards,
                              "dropped_pages": self.dropped_pages / self.shards},
                "shards": {"staged_pages": self.shard_staged.tolist(),
                           "topup_pages": self.shard_topup.tolist(),
                           "dropped_pages": self.shard_dropped.tolist()}}
