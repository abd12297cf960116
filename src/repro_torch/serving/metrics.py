"""Serving telemetry: per-request lifecycle timings and engine-level counters
(reference ``repro/serving/metrics.py``, without its tensor-parallel
section). The ``kv_quant`` section's ``dequant_overhead_s`` is the cost
model's estimate of the fused dequantization's time at the H100's
device-pool rate (``quant.accounting.DEQUANT_ELEMS_PER_S``); it holds no
PCIe time.

Timestamps are ``time.perf_counter()`` values relative to the scheduler
run's start; queue wait, TTFT and inter-token latency are properties, so
no caller recomputes them differently. ``EngineMetrics`` is a view over a
per-run ``obs.MetricsRegistry``: its accumulators (``em.steps``,
``em.host_syncs``, ...) are registry counters exposed as attributes, and
the latency and speculation histograms live beside them.
``EngineMetrics.summary()`` is the one dict the launcher prints; its
``"slo"`` section holds SLO attainment and goodput over the completed
requests that carry a TTFT or inter-token SLO (their own, or the engine's),
and ``"cancelled"`` counts the requests cancelled mid-flight.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.obs.registry import (COUNT_BUCKETS, LATENCY_BUCKETS, RATE_BUCKETS,
                                      MetricsRegistry)
from repro_torch.quant.accounting import DEQUANT_ELEMS_PER_S


@dataclass
class RequestMetrics:
    uid: int
    prompt_tokens: int = 0            # raw prompt length
    padded_prompt_tokens: int = 0     # after bucket padding
    max_new_tokens: int = 0
    enqueue_t: float = 0.0
    prefill_start_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    finish_step: Optional[int] = None  # engine step index at completion
    new_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    max_token_gap_s: float = 0.0      # worst observed inter-token gap
    priority: int = 0                 # the request's scheduling priority
    prefix_hit_tokens: int = 0        # prompt tokens served from the prefix cache
    preemptions: int = 0              # times this request was swapped out
    cancelled: bool = False           # cancelled mid-flight (the client hung up)
    # the request's SLOs in ms; None takes the engine's (EngineMetrics.slo_*)
    slo_ttft_ms: Optional[float] = None
    slo_itl_ms: Optional[float] = None

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.prefill_start_t is None:
            return None
        return self.prefill_start_t - self.enqueue_t

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.enqueue_t

    @property
    def itl_s(self) -> Optional[float]:
        """Mean inter-token latency after the first token."""
        if self.finish_t is None or self.first_token_t is None or self.new_tokens < 2:
            return None
        return (self.finish_t - self.first_token_t) / (self.new_tokens - 1)


def _mean(xs: List[float]) -> float:
    return sum(xs) / len(xs) if xs else 0.0


# attribute -> (registry metric name, cast, help); attached as properties
# below, so ``em.steps += 1`` reads and writes the registry
_COUNTER_ATTRS = {
    "steps": ("engine_steps_total", int, "decode steps executed"),
    "active_slot_steps": ("engine_active_slot_steps_total", int,
                          "sum over steps of active slots"),
    "sync_pages": ("recall_sync_pages_total", float,
                   "blocking (kv-head, page) blocks on the critical path"),
    "async_pages": ("recall_async_pages_total", float,
                    "staged blocks hidden behind compute"),
    "reused_pages": ("recall_reused_pages_total", float,
                     "blocks served from the resident double buffer"),
    "host_syncs": ("dispatch_host_syncs_total", int,
                   "decode reads back to the host"),
    "sync_bytes_to_host": ("dispatch_sync_bytes_to_host_total", float,
                           "token/valid/stat blocks read at syncs"),
    "sync_bytes_to_device": ("dispatch_sync_bytes_to_device_total", float,
                             "loop-lane uploads at syncs"),
    "nonsync_host_bytes": ("dispatch_nonsync_host_bytes_total", float,
                           "decode-loop transfers BETWEEN syncs"),
    "sel_pages": ("spec_sel_pages_total", float,
                  "speculatively selected (kv-head, page) slots"),
    "spec_hit_pages": ("spec_hit_pages_total", float,
                       "selected pages already resident from the previous step"),
    "churn_pages": ("spec_churn_pages_total", float,
                    "pages entering the top-k selection this step"),
    "corrected_heads": ("spec_corrected_heads_total", float,
                        "kv heads that triggered fine-grained correction"),
    "kv_head_steps": ("spec_kv_head_steps_total", float,
                      "kv-head decision opportunities (heads x steps)"),
    # speculative decoding (models.model.serve_step_spec): one "verify
    # step" is a drafted-block target pass; the tokens it commits share
    # its compute
    "spec_verify_steps": ("specdec_verify_steps_total", int,
                          "drafted-block verify iterations dispatched"),
    "spec_slot_steps": ("specdec_slot_steps_total", int,
                        "live slot participations in verify steps"),
    "spec_proposed_tokens": ("specdec_proposed_tokens_total", float,
                             "drafted tokens proposed to verification"),
    "spec_accepted_tokens": ("specdec_accepted_tokens_total", float,
                             "drafted tokens accepted by the target pass"),
    "spec_committed_tokens": ("specdec_committed_tokens_total", float,
                              "tokens committed by verify steps (base + accepted)"),
    "spec_idle_iterations": ("specdec_idle_iterations_total", int,
                             "verify iterations run with every lane finished "
                             "(models.model.decode_window_spec's window rule)"),
    "prefill_chunks": ("sched_prefill_chunks_total", int,
                       "chunked-prefill chunks executed"),
    "prefill_chunk_tokens": ("sched_prefill_chunk_tokens_total", int,
                             "prompt tokens prefilled through chunks"),
    "preemptions": ("sched_preemptions_total", int,
                    "requests swapped out of their slot to host"),
    "resumes": ("sched_resumes_total", int,
                "swapped-out requests swapped back into a slot"),
    "swap_out_bytes": ("sched_swap_out_bytes_total", float,
                       "decode-state bytes pulled to host at preemption"),
    "swap_in_bytes": ("sched_swap_in_bytes_total", float,
                      "decode-state bytes pushed back at resume"),
    "cancellations": ("sched_cancellations_total", int,
                      "requests cancelled mid-flight (client disconnect)"),
    "slo_tagged": ("slo_tagged_requests_total", int,
                   "completed requests carrying an effective SLO tag"),
    "slo_attained": ("slo_attained_requests_total", int,
                     "tagged requests meeting their TTFT+ITL SLOs"),
    "slo_good_tokens": ("slo_good_tokens_total", int,
                        "tokens from SLO-attaining requests (goodput numerator)"),
}
_GAUGE_ATTRS = {
    "dropped_pages": ("recall_dropped_in_flight_pages", float,
                      "staged blocks abandoned at slot turnover"),
    "wall_s": ("engine_wall_seconds", float, "scheduler run wall clock"),
}

H_QUEUE_WAIT = "request_queue_wait_seconds"
H_TTFT = "request_ttft_seconds"
H_ITL = "request_itl_seconds"
H_PREFILL = "request_prefill_seconds"
H_DECODE_STEP = "engine_decode_step_seconds"
H_TOKEN_GAP = "request_token_gap_seconds"
H_HIT_RATE = "spec_hit_rate"
H_CORRECTION_RATE = "spec_correction_rate"
H_CHURN = "spec_churn_pages"
H_SPEC_TOKENS = "specdec_tokens_per_step"


@dataclass
class EngineMetrics:
    """Engine-level aggregation over one scheduler run. The accumulators
    live in ``registry``; the fields below are the run's configuration."""
    num_slots: int = 0
    requests: List[RequestMetrics] = field(default_factory=list)
    registry: MetricsRegistry = field(default_factory=MetricsRegistry)
    page_block_bytes: int = 0         # bytes of one (kv-head, page) K+V block
    # quantized host tier: page_block_bytes is then the packed unit
    # (payload + fp32 scales) and dense_block_bytes the unquantized one
    kv_quant: str = "none"
    dense_block_bytes: int = 0
    dequant_elems_per_block: int = 0  # elements dequantized per moved block
    pool_bytes_physical: float = 0.0  # slot-pool host-tier bytes (packed)
    pool_bytes_dense: float = 0.0     # same capacity unquantized
    # True when the pool is pinned host memory (real host-to-card transfers)
    transfer_is_dma: bool = False
    scheduler: str = "continuous"
    # tensor-parallel serving: page counts are global (summed over the
    # KV-head-group shards); ``shard_pages`` holds each shard's own,
    # measured ("sync"/"async"/"dropped" -> one count a shard; empty where
    # the run had no mesh), ``per_shard_transfer_bytes`` the reference's
    # even split of the totals
    tp: int = 1
    shard_pages: Dict[str, List[float]] = field(default_factory=dict)
    # serving under a ("data", "model") compute mesh (empty without one):
    # its shape, the bytes the decode steps moved between its shards by
    # kind (``sharding/transfer.KINDS``), their count, and the rest of the
    # run's moves (the prefills')
    mesh_shape: Dict[str, int] = field(default_factory=dict)
    mesh_decode_bytes: Dict[str, float] = field(default_factory=dict)
    mesh_decode_steps: int = 0
    mesh_other_bytes: Dict[str, float] = field(default_factory=dict)
    # decode steps per host read (models.model.decode_window); with
    # sample_on_device nothing crosses the host boundary between reads, so
    # nonsync_host_bytes stays 0; the synchronous path reads every step
    sync_interval: int = 1
    sample_on_device: bool = True
    # speculative decoding: drafted tokens per verify step (0 = off); a
    # verify step commits up to 1 + draft_len tokens a slot
    draft_len: int = 0
    # RadixPrefixCache.stats() after the run (empty without a cache)
    prefix_cache: Dict = field(default_factory=dict)
    # the engine's SLOs in ms (None: untagged); a request's own tag wins.
    # Requests with no SLO at all count in neither attainment nor goodput
    slo_ttft_ms: Optional[float] = None
    slo_itl_ms: Optional[float] = None

    # -- recording ---------------------------------------------------------
    def record_step(self, n_active: int):
        self.steps += 1
        self.active_slot_steps += n_active

    def observe_decode_step(self, dt_s: float):
        self.registry.histogram(H_DECODE_STEP, LATENCY_BUCKETS,
                                "per-step decode latency").observe(dt_s)

    def observe_token_gap(self, gap_s: float):
        """One emitted token's gap since the request's previous token (the
        tail a per-request mean ITL averages away)."""
        self.registry.histogram(H_TOKEN_GAP, LATENCY_BUCKETS,
                                "per-token inter-token gap").observe(gap_s)

    def observe_speculation(self, sel: float, hit: float, churn: float,
                            corrected: float, kv_heads: float):
        """One slot-step of the speculation-quality histograms, from the
        window's stat blocks read at the sync (no extra host traffic)."""
        reg = self.registry
        if sel > 0:
            reg.histogram(H_HIT_RATE, RATE_BUCKETS,
                          "per-step speculative page-hit rate").observe(hit / sel)
            reg.histogram(H_CHURN, COUNT_BUCKETS,
                          "pages entering top-k per step").observe(churn)
        if kv_heads > 0:
            reg.histogram(H_CORRECTION_RATE, RATE_BUCKETS,
                          "per-step corrected-head fraction").observe(corrected / kv_heads)

    def slo_check(self, rm: RequestMetrics):
        """(tagged, attained) for one finished request: ``tagged`` when it
        has a TTFT or inter-token SLO (its own, else the engine's);
        ``attained`` when each holds, TTFT against ``rm.ttft_s`` and the
        inter-token SLO against the request's mean ``rm.itl_s`` (a
        one-token request has none and passes that bound)."""
        t_slo = rm.slo_ttft_ms if rm.slo_ttft_ms is not None else self.slo_ttft_ms
        i_slo = rm.slo_itl_ms if rm.slo_itl_ms is not None else self.slo_itl_ms
        if t_slo is None and i_slo is None:
            return False, False
        ok = True
        if t_slo is not None and (rm.ttft_s is None or rm.ttft_s * 1e3 > t_slo):
            ok = False
        if i_slo is not None and rm.itl_s is not None and rm.itl_s * 1e3 > i_slo:
            ok = False
        return True, ok

    def record_request(self, rm: RequestMetrics):
        """Observe a finished request's latency distributions and SLOs."""
        reg = self.registry
        reg.counter("requests_completed_total").inc()
        reg.counter("request_tokens_generated_total").inc(rm.new_tokens)
        tagged, attained = self.slo_check(rm)
        if tagged:
            self.slo_tagged += 1
            if attained:
                self.slo_attained += 1
                self.slo_good_tokens += rm.new_tokens
        if rm.queue_wait_s is not None:
            reg.histogram(H_QUEUE_WAIT, LATENCY_BUCKETS,
                          "enqueue -> prefill start").observe(rm.queue_wait_s)
        if rm.ttft_s is not None:
            reg.histogram(H_TTFT, LATENCY_BUCKETS, "enqueue -> first token").observe(rm.ttft_s)
        if rm.itl_s is not None:
            reg.histogram(H_ITL, LATENCY_BUCKETS, "mean inter-token latency").observe(rm.itl_s)
        if rm.prefill_s > 0:
            reg.histogram(H_PREFILL, LATENCY_BUCKETS, "prefill forward time").observe(rm.prefill_s)

    # -- derived views -------------------------------------------------------
    @property
    def slot_occupancy(self) -> float:
        total = self.steps * self.num_slots
        return self.active_slot_steps / total if total else 0.0

    @property
    def generated_tokens(self) -> int:
        return sum(r.new_tokens for r in self.requests)

    @property
    def tokens_per_s(self) -> float:
        return self.generated_tokens / self.wall_s if self.wall_s else 0.0

    @property
    def exposed_transfer_bytes(self) -> float:
        """Bytes whose transfer the decode critical path waited for."""
        return self.sync_pages * self.page_block_bytes

    @property
    def hidden_transfer_bytes(self) -> float:
        """Bytes streamed behind decode compute (the staged buffer)."""
        return self.async_pages * self.page_block_bytes

    @property
    def moved_page_blocks(self) -> float:
        """Blocks that crossed the link (reused blocks moved nothing)."""
        return self.sync_pages + self.async_pages

    @property
    def per_shard_transfer_bytes(self) -> Dict[str, float]:
        """The reference's per-shard host-to-card bytes (``metrics.py:370``):
        each transfer class's total over tp, derived, not measured
        (``shard_transfer_bytes`` is what each shard moved)."""
        tp = max(self.tp, 1)
        return {"sync": self.exposed_transfer_bytes / tp,
                "async": self.hidden_transfer_bytes / tp,
                "dropped": self.dropped_pages * self.page_block_bytes / tp}

    @property
    def shard_transfer_bytes(self) -> Dict[str, List[float]]:
        """Host-to-card bytes each tensor-parallel shard moved over its own
        link, from its own counters: "sync"/"async"/"dropped" -> one a
        shard (empty where the run had no mesh)."""
        return {k: [n * self.page_block_bytes for n in v] for k, v in self.shard_pages.items()}

    @property
    def mesh_summary(self) -> dict:
        """The serving collective term: bytes a decode step moved between
        the mesh's shards by kind, their sum, and that sum over NVLink's
        data-sheet rate (``roofline.NVLINK_BPS``), computed, not measured;
        the prefills' bytes beside them. Empty without a compute mesh."""
        if not self.mesh_shape:
            return {}
        from repro_torch.launch.roofline import NVLINK_BPS
        n = max(self.mesh_decode_steps, 1)
        per = {k: v / n for k, v in self.mesh_decode_bytes.items()}
        total = sum(per.values())
        return {"shape": dict(self.mesh_shape), "decode_steps": self.mesh_decode_steps,
                "bytes_per_step": per, "bytes_per_step_total": total,
                "nvlink_ms_per_step": 1e3 * total / NVLINK_BPS, "nvlink_ms_computed": True,
                "prefill_bytes": dict(self.mesh_other_bytes)}

    @property
    def transfer_bytes_saved(self) -> float:
        """Bytes the quantized tier removed against a dense pool."""
        if self.kv_quant == "none" or not self.dense_block_bytes:
            return 0.0
        return self.moved_page_blocks * (self.dense_block_bytes - self.page_block_bytes)

    @property
    def dequant_overhead_s(self) -> float:
        """Cost-model estimate of the cumulative fused dequantization time:
        every moved block is dequantized once on recall, at the rate the
        card's ``recall_gather_quant`` reached from a device pool, an upper
        bound with no link time in it (reference ``metrics.py:358``). 0 when
        the tier is off."""
        if self.kv_quant == "none":
            return 0.0
        return self.moved_page_blocks * self.dequant_elems_per_block / DEQUANT_ELEMS_PER_S

    @property
    def steps_per_sync(self) -> float:
        """Decode steps per host read (the window depth actually reached)."""
        return self.steps / self.host_syncs if self.host_syncs else 0.0

    @property
    def host_bytes_per_step(self) -> float:
        total = self.sync_bytes_to_host + self.sync_bytes_to_device + self.nonsync_host_bytes
        return total / self.steps if self.steps else 0.0

    @property
    def nonsync_bytes_per_step(self) -> float:
        return self.nonsync_host_bytes / self.steps if self.steps else 0.0

    @property
    def hidden_fraction(self) -> float:
        moved = self.hidden_transfer_bytes + self.exposed_transfer_bytes
        return self.hidden_transfer_bytes / moved if moved else 0.0

    @property
    def spec_hit_rate_mean(self) -> float:
        return self.spec_hit_pages / self.sel_pages if self.sel_pages else 0.0

    @property
    def correction_rate_mean(self) -> float:
        return self.corrected_heads / self.kv_head_steps if self.kv_head_steps else 0.0

    def observe_spec_step(self, tokens_per_step: float):
        """One verify step's committed tokens per live slot (at least 1)."""
        self.registry.histogram(H_SPEC_TOKENS, COUNT_BUCKETS,
                                "tokens committed per verify step per slot"
                                ).observe(tokens_per_step)

    @property
    def spec_accept_rate(self) -> float:
        """Fraction of drafted tokens the target pass accepted."""
        return (self.spec_accepted_tokens / self.spec_proposed_tokens
                if self.spec_proposed_tokens else 0.0)

    @property
    def spec_tokens_per_target_step(self) -> float:
        """Tokens committed per live slot per verify step."""
        return (self.spec_committed_tokens / self.spec_slot_steps
                if self.spec_slot_steps else 0.0)

    def specdec_summary(self) -> dict:
        return {
            "draft_len": self.draft_len,
            "verify_steps": self.spec_verify_steps,
            "proposed_tokens": self.spec_proposed_tokens,
            "accepted_tokens": self.spec_accepted_tokens,
            "committed_tokens": self.spec_committed_tokens,
            "accept_rate": self.spec_accept_rate,
            "tokens_per_step": self.spec_tokens_per_target_step,
            "tokens_per_step_hist": self._hist_summary(H_SPEC_TOKENS, COUNT_BUCKETS),
            "idle_iterations": self.spec_idle_iterations,
        }

    @property
    def slo_attainment(self) -> float:
        """Share of the SLO-tagged completed requests that met their SLOs
        (1.0 with no tagged request: nothing was violated)."""
        return self.slo_attained / self.slo_tagged if self.slo_tagged else 1.0

    @property
    def goodput_tokens_per_s(self) -> float:
        """Tokens/s of the SLO-attaining requests alone; with no tagged
        request, all tokens/s."""
        good = self.slo_good_tokens if self.slo_tagged else self.generated_tokens
        return good / self.wall_s if self.wall_s else 0.0

    def slo_summary(self) -> dict:
        return {
            "ttft_ms": self.slo_ttft_ms,
            "itl_ms": self.slo_itl_ms,
            "tagged": self.slo_tagged,
            "attained": self.slo_attained,
            "attainment": self.slo_attainment,
            "good_tokens": self.slo_good_tokens,
            "goodput_tokens_per_s": self.goodput_tokens_per_s,
            "cancelled": self.cancellations,
        }

    def _hist_summary(self, name: str, buckets) -> dict:
        return self.registry.histogram(name, buckets).summary()

    def summary(self) -> dict:
        done = [r for r in self.requests if r.finish_t is not None and not r.cancelled]
        return {
            "scheduler": self.scheduler,
            "requests": len(self.requests),
            "completed": len(done),
            "cancelled": self.cancellations,
            "generated_tokens": self.generated_tokens,
            "wall_s": self.wall_s,
            "tokens_per_s": self.tokens_per_s,
            "steps": self.steps,
            "slot_occupancy": self.slot_occupancy,
            "queue_wait_s_mean": _mean([r.queue_wait_s for r in done
                                        if r.queue_wait_s is not None]),
            "ttft_s_mean": _mean([r.ttft_s for r in done if r.ttft_s is not None]),
            "itl_s_mean": _mean([r.itl_s for r in done if r.itl_s is not None]),
            "slo": self.slo_summary(),
            "specdec": self.specdec_summary(),
            "latency": {
                "queue_wait_s": self._hist_summary(H_QUEUE_WAIT, LATENCY_BUCKETS),
                "ttft_s": self._hist_summary(H_TTFT, LATENCY_BUCKETS),
                "itl_s": self._hist_summary(H_ITL, LATENCY_BUCKETS),
                "decode_step_s": self._hist_summary(H_DECODE_STEP, LATENCY_BUCKETS),
            },
            "speculation": {
                "sel_pages": self.sel_pages,
                "spec_hit_pages": self.spec_hit_pages,
                "churn_pages": self.churn_pages,
                "hit_rate_mean": self.spec_hit_rate_mean,
                "correction_rate_mean": self.correction_rate_mean,
                "hit_rate": self._hist_summary(H_HIT_RATE, RATE_BUCKETS),
                "correction_rate": self._hist_summary(H_CORRECTION_RATE, RATE_BUCKETS),
                "churn": self._hist_summary(H_CHURN, COUNT_BUCKETS),
            },
            "recall_overlap": {
                "hidden_bytes": self.hidden_transfer_bytes,
                "exposed_bytes": self.exposed_transfer_bytes,
                "hidden_fraction": self.hidden_fraction,
                "reused_pages": self.reused_pages,
                "dropped_in_flight_bytes": self.dropped_pages * self.page_block_bytes,
                "transfer_is_dma": self.transfer_is_dma,
            },
            "tp": {
                "tp": self.tp,
                "per_shard_transfer_bytes": self.per_shard_transfer_bytes,
                "shard_transfer_bytes": self.shard_transfer_bytes,
            },
            "scheduling": {
                "prefill_chunks": self.prefill_chunks,
                "prefill_chunk_tokens": self.prefill_chunk_tokens,
                "preemptions": self.preemptions,
                "resumes": self.resumes,
                "swap_out_bytes": self.swap_out_bytes,
                "swap_in_bytes": self.swap_in_bytes,
                "token_gap_s": self._hist_summary(H_TOKEN_GAP, LATENCY_BUCKETS),
            },
            "dispatch": {
                "sync_interval": self.sync_interval,
                "sample_on_device": self.sample_on_device,
                "host_syncs": self.host_syncs,
                "steps_per_sync": self.steps_per_sync,
                "sync_bytes_to_host": self.sync_bytes_to_host,
                "sync_bytes_to_device": self.sync_bytes_to_device,
                "nonsync_host_bytes": self.nonsync_host_bytes,
                "nonsync_bytes_per_step": self.nonsync_bytes_per_step,
                "host_bytes_per_step": self.host_bytes_per_step,
            },
            "kv_quant": {
                "mode": self.kv_quant,
                "page_block_bytes": self.page_block_bytes,
                "dense_block_bytes": self.dense_block_bytes,
                "moved_page_blocks": self.moved_page_blocks,
                "bytes_saved": self.transfer_bytes_saved,
                "dequant_overhead_s": self.dequant_overhead_s,
                "pool_bytes_physical": self.pool_bytes_physical,
                "pool_bytes_dense": self.pool_bytes_dense,
                "pool_compression": (self.pool_bytes_dense / self.pool_bytes_physical
                                     if self.pool_bytes_physical else 1.0),
            },
            "prefix_cache": dict(self.prefix_cache),
            **({"mesh": self.mesh_summary} if self.mesh_shape else {}),
        }


def _attach_registry_attrs():
    """Registry counters and gauges as read/write ``EngineMetrics``
    attributes (``em.steps += 1``)."""
    def make(metric, cast, help, kind):
        def fget(self):
            return cast(getattr(self.registry, kind)(metric, help).value)

        def fset(self, v):
            getattr(self.registry, kind)(metric, help).set(float(v))
        return property(fget, fset)

    for attr, (metric, cast, help) in _COUNTER_ATTRS.items():
        setattr(EngineMetrics, attr, make(metric, cast, help, "counter"))
    for attr, (metric, cast, help) in _GAUGE_ATTRS.items():
        setattr(EngineMetrics, attr, make(metric, cast, help, "gauge"))


_attach_registry_attrs()
