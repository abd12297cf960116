"""Serving engine (reference ``repro/serving/engine.py``): prefill and
decode with any ported retriever, under two schedulers.

* ``scheduler="continuous"`` (the default, as in the reference): the
  ``serving/scheduler`` and ``serving/kv_slots`` subsystem. A fixed pool of
  ``batch_size`` slots; each request is prefilled alone (B=1) straight into
  a free slot's rows and joins the decode batch; a finished request's slot
  is refilled at the next host boundary; greedy tokens are picked on the
  card and up to ``fkv.sync_interval`` decode steps run per host read
  (``models.model.decode_window``). ``fkv.sample_on_device=False`` is the
  synchronous reference path, one host read a step, with the same tokens.
* ``scheduler="static"``: the lockstep fallback. Requests are served in
  batches of ``batch_size``: left-pad the prompts, one ``prefill``, then one
  ``serve_step`` per generated token with host-side sampling, until the
  batch's longest request drains; two host reads a step (the tokens and
  the stats).

Prompt lengths can be bucketed (``prefill_bucket``, continuous only): a
prompt is left-padded to a multiple of the bucket, and the pads become
attended context, as in the reference. The default 1 pads nothing.

Under the continuous scheduler, as in the reference:

A stack with a recurrent layer (jamba's Mamba, xlstm's mLSTM and sLSTM)
keeps its history in a state that cannot be extended over cached K/V, and
an encoder-decoder's cross-attention state and a frontend prefix cannot be
either (``models.model.supports_kv_extend``): chunked prefill and the
prefix cache then turn off, as in the reference. MoE layers route each
call's tokens together, so rows meet in the router (``models/moe``).

A frontend config (whisper's audio frames, internvl2's patches) takes each
request's ``Request.frontend`` (n_frontend_tokens, d_model) embeddings,
zeros where a request has none, as the reference: whisper's encoder runs
over them; internvl2's sit ahead of the (left-padded) prompt.

* ``prefix_cache_tokens > 0``: a radix-trie prefix cache
  (``serving/prefix_cache``) keyed by the padded prompt. A hit skips the
  forward pass over the reused span: only the suffix runs
  (``models.model.prefill_extend``), over the cached K/V copied back from
  pinned host memory; every prefill's K/V is copied out to it.
* ``fkv.prefill_chunk_tokens > 0``: chunked prefill. An admitted request
  holds its slot while a ``PrefillJob`` runs its prompt in chunks of at
  most that many tokens a scheduler round, between decode windows.
* ``fkv.preempt``: priority preemption (``Request.priority``): a queued
  request of strictly higher priority swaps the lowest-priority running
  request's slot state out to host (``SlotPool.swap_out``) and takes the
  slot; the victim resumes bit for bit later.

Sampling with a temperature draws token ``i`` of request ``uid`` from
``fold_in(request_key(seed, uid), i)`` on the continuous path and chains
``fold_in(key, step)`` from ``PRNGKey(seed)`` on the static path, bit for
bit the reference's draws (``serving/sampling``).

``fkv.draft_len > 0``: speculative decoding (``models.model
.decode_window_spec``), a bigram drafter a slot (``core/drafter``, seeded
from the prompt and ``Request.draft_hint``) and a verify pass that commits
up to ``1 + draft_len`` tokens a slot an iteration, the tokens equal to
``draft_len=0``'s. Where that cannot hold (the static scheduler,
``sample_on_device=False``, a method outside ``supports_spec_decode``) the
engine falls back to ``draft_len=0``, as the reference does.

Live serving (``serve_service``): the continuous scheduler driven by a
``serving/frontend.EngineService`` that admits requests as they arrive,
streams their tokens and cancels those whose client hung up; the HTTP
front-end (``serving/frontend.HttpFrontend``) runs it on a worker thread.
``slo_ttft_ms``/``slo_itl_ms`` (the engine's) and ``Request.slo_*`` (a
request's own) feed ``EngineMetrics.summary()["slo"]``; they never change a
scheduling decision.

``tp > 1`` (or ``mesh``, ``launch/mesh.make_tp_mesh``): KV-head-group
tensor parallelism (reference ``engine.py:201-221``). Every attention
layer's retrieval state is split over ``tp`` shards by KV head, each on its
own device, and the retrieval step runs per shard
(``core/sharded_retrieval``); the backbone runs once, on the primary
device (``device``, the mesh's first), and the greedy tokens equal tp=1's.
One process drives every shard: one engine, one scheduler, one slot pool
whose rows span the shards. ``tp`` must divide both head counts; it
composes with speculative decoding.

``mesh`` a ("data", "model") compute mesh (``launch/mesh.make_host_mesh``,
told from serving TP's ``TPMesh`` by its "data" axis): the reference's
compute-mesh serving (``engine.py:196-290``, ``model.py:118-126``). The
params (plain tensors) are placed by ``sharding/rules
.place_serving_params``: split over "model" only, in the layout the
shards compute with, a copy in each data group, unless ``inference_fsdp``
keeps the FSDP dim. The slots split over
the data groups (``SlotPool``), each request is prefilled by its slot's
group, and every decode step runs each group's rows on its model shards
(``models/model``), each attention layer's retrieval in KV-head groups,
page-sharded under ``fkv.sharded_retrieval`` (the fused step) or whole on
the group's shard 0. Speculative decoding composes with a compute mesh:
each data group verifies and rolls back its rows on its shards, its
drafter table on its shard 0.
The bytes the shards move count on ``mesh.moved`` by kind; the decode
steps' share lands in ``EngineMetrics``' mesh section.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import MOE, ArchConfig, FreeKVConfig
from repro_torch.core.recall_pipeline import RecallFlightTracker
from repro_torch.core.sharded_retrieval import tp_group_size
from repro_torch.launch.mesh import indexed_device, is_compute_mesh, make_tp_mesh
from repro_torch.models.model import (DECODE_STAT_KEYS, decode_window,
                                      decode_window_spec, frontend_prefix, prefill,
                                      prefill_extend, serve_step, supports_kv_extend,
                                      supports_spec_decode)
from repro_torch.sharding import rules
from repro_torch.sharding.transfer import KINDS
from repro_torch.obs import Observability
from repro_torch.quant.accounting import page_block_bytes, page_block_bytes_dense
from repro_torch.serving.kv_slots import SlotPool
from repro_torch.serving.metrics import EngineMetrics, RequestMetrics
from repro_torch.serving.prefix_cache import RadixPrefixCache, copy_parts
from repro_torch.serving.sampling import (PRNGKey, SamplerConfig, fold_in, sample,
                                         sample_counted)
from repro_torch.serving.scheduler import ContinuousScheduler, _request_stats


@dataclass
class Request:
    uid: int
    tokens: np.ndarray                 # prompt (T,)
    max_new_tokens: int = 32
    eos_token: Optional[int] = None
    # scheduling priority (higher is more urgent). Admission stays FIFO;
    # with ``fkv.preempt`` a queued request of strictly higher priority than
    # the lowest-priority running one swaps that one out and takes its slot
    priority: int = 0
    # the request's SLOs in ms; None takes the engine's. Tagged completions
    # feed EngineMetrics.summary()["slo"] (attainment, goodput)
    slo_ttft_ms: Optional[float] = None
    slo_itl_ms: Optional[float] = None
    # optional reference stream for the speculative drafter (a retrieved
    # document, an earlier draft of the answer, ...): its bigrams overlay
    # the prompt's in the slot's table at admission. It steers which drafts
    # are proposed, never which tokens are emitted
    draft_hint: Optional[np.ndarray] = None
    # a frontend config's stub embeddings (n_frontend_tokens, d_model): the
    # audio frames whisper's encoder reads, the patches internvl2 puts ahead
    # of the prompt; None serves zeros (reference ``engine.py:71``)
    frontend: Optional[np.ndarray] = None


@dataclass
class Completion:
    uid: int
    tokens: List[int]
    prefill_s: float
    decode_s: float
    steps: int
    stats: dict
    metrics: Optional[RequestMetrics] = None


class PrefillJob:
    """Chunked prefill of one admitted request (reference
    ``engine.py:102``), held in slot ``slot`` of ``pool``.

    The opening chunk runs the ordinary prefill and keeps its K/V
    (``return_kv``); every later chunk runs ``prefill_extend`` over the K/V
    so far, the prefix cache's extension math. Only the final chunk builds
    the decode state, from the whole prompt's K/V and straight into the
    slot's rows (``SlotPool.claim``), as a whole-shot prefill does; earlier
    chunks skip it (``build_state=False``). The K/V accumulate in per-layer
    buffers allocated once for the padded prompt, each chunk writing its
    span in place: nothing is concatenated again.

    A prefix-cache hit seeds the buffers with the cached span (shrunk so
    the suffix is a whole number of buckets, as ``prefill_one``); at the end
    the whole prompt's K/V go into the trie. The scheduler paces the job:
    ``advance`` with its budget a round."""

    def __init__(self, engine: "ServeEngine", req: Request, pool=None, slot=None):
        self.engine, self.req, self.pool, self.slot = engine, req, pool, slot
        self.tokens = engine._padded_prompt(req)
        self.seq = tuple(int(t) for t in self.tokens)
        self.pos = 0                    # prompt tokens prefilled so far
        self.hit = 0                    # of which served by the prefix cache
        self.chunks = 0
        self._kv = None                 # per-layer (k, v) buffers (1, T, kv, dh)
        self.result = None  # (logits (1,V), B=1 state, hit, padded) when done
        if engine.prefix_cache is not None:
            tp, parts = engine._cache_lookup(self.seq)
            if tp:
                self._kv = engine._load_prefix(parts, len(self.seq), engine._group_device(
                    pool.group_of(slot) if pool is not None else 0))
                self.pos = self.hit = tp

    @property
    def remaining(self) -> int:
        return len(self.seq) - self.pos

    @property
    def done(self) -> bool:
        return self.result is not None

    def advance(self, budget: int) -> int:
        """Run one chunk of at most ``budget`` prompt tokens; returns the
        tokens consumed. The final chunk sets ``result`` to what
        ``prefill_one`` returns."""
        assert not self.done and budget > 0
        eng = self.engine
        # under a compute mesh the slot's data group runs the prefill
        group = (self.pool.group_of(self.slot) if eng.compute_mesh and self.pool is not None
                 else None)
        n = min(int(budget), self.remaining)
        last = n == self.remaining
        into = self.pool.claim(self.slot) if last and self.pool is not None else None
        batch = {"tokens": torch.from_numpy(self.tokens[None, self.pos: self.pos + n]).long()
                 .to(eng.device)}
        if self.pos == 0:
            batch.update(eng._frontend_batch([self.req]))
        common = dict(max_len=eng.max_len, state_dtype=eng.state_dtype, build_state=last,
                      into=into, mesh=eng.mesh)
        if eng.compute_mesh:
            common["group"] = group
        if self.pos == 0:
            keep = not last or eng.prefix_cache is not None  # for later chunks or the cache
            out = prefill(eng.cfg, eng.fkv, eng.params, batch, return_kv=keep, **common)
            logits, state = out[:2]
            if keep and last:
                self._kv = out[2]
            elif keep:
                self._kv = eng._kv_buffers(len(self.seq), out[2][0][0].dtype,
                                           out[2][0][0].device)
                for (bk, bv), (k, v) in zip(self._kv, out[2]):
                    bk[:, :n].copy_(k)
                    bv[:, :n].copy_(v)
        else:
            logits, state = prefill_extend(eng.cfg, eng.fkv, eng.params, batch, self._kv,
                                           self.pos, **common)
        self.pos += n
        self.chunks += 1
        if last:
            if eng.prefix_cache is not None:
                eng._cache_insert(self.seq, self._kv)
            self._kv = None
            self.result = (logits, eng._attach_draft_tab(state, self.seq, self.req.draft_hint,
                                                         group or 0),
                           self.hit, len(self.seq))
        return n


class ServeEngine:
    def __init__(self, cfg: ArchConfig, fkv: FreeKVConfig, params,
                 max_len: int, batch_size: int,
                 sampler: SamplerConfig = SamplerConfig(),
                 state_dtype=torch.float32,
                 scheduler: str = "continuous",
                 prefill_bucket: int = 1,
                 prefix_cache_tokens: int = 0,
                 pad_token: int = 0,
                 obs: Optional[Observability] = None,
                 slo_ttft_ms: Optional[float] = None,
                 slo_itl_ms: Optional[float] = None,
                 device="cuda", tp: int = 1, mesh=None):
        if scheduler not in ("continuous", "static"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        self.device = resolve_device(device)
        if mesh is not None and tp > 1:
            raise ValueError("pass either mesh= or tp=, not both")
        self.compute_mesh = is_compute_mesh(mesh)
        if fkv.sharded_retrieval and (tp > 1 or (mesh is not None and not self.compute_mesh)):
            # reference ``engine.py:214``
            raise ValueError("tp serving and the page-sharded fused step are exclusive")
        if self.compute_mesh:
            if indexed_device(self.device) != mesh.primary:
                raise ValueError(f"the engine's device {self.device} must be the mesh's first, "
                                 f"{mesh.primary}")
            if not isinstance(params, list):
                params = rules.place_serving_params(cfg, params, mesh)
        elif mesh is not None or tp > 1:
            # the reference's checks (``engine.py:206-218``), then the mesh:
            # by default cuda:0 .. cuda:tp-1, which raises with fewer cards
            tp = tp if mesh is None else tp_group_size(mesh)
            if cfg.n_kv_heads % tp or cfg.n_heads % tp:
                raise ValueError(f"{cfg.name}: tp={tp} must divide both n_heads={cfg.n_heads} "
                                 f"and n_kv_heads={cfg.n_kv_heads}")
            mesh = mesh if mesh is not None else make_tp_mesh(tp)
            if indexed_device(self.device) != mesh.primary:
                raise ValueError(f"the backbone's device {self.device} must be the mesh's "
                                 f"first, {mesh.primary}")
        self.tp, self.mesh = tp, mesh
        # speculative decoding rides the continuous scheduler's window; where
        # it cannot be exact the engine serves draft_len=0 (reference
        # ``engine.py:222-232``): the same tokens, one a step
        if fkv.draft_len > 0 and not (scheduler == "continuous" and fkv.sample_on_device
                                      and supports_spec_decode(cfg, fkv)):
            fkv = dataclasses.replace(fkv, draft_len=0)
        self.spec_decode = fkv.draft_len > 0
        self.draft_len = fkv.draft_len
        self.cfg, self.fkv, self.params = cfg, fkv, params
        self.max_len, self.batch_size = max_len, batch_size
        self.sampler = sampler
        self.state_dtype = state_dtype
        self.scheduler = scheduler
        self.prefill_bucket = max(1, prefill_bucket)
        self.pad_token = pad_token
        self.sync_interval = max(1, fkv.sync_interval)
        self.sample_on_device = bool(fkv.sample_on_device)
        self.obs = obs if obs is not None else Observability.off()
        # the engine's SLOs in ms, for requests without their own (None:
        # untagged; EngineMetrics.slo_check)
        self.slo_ttft_ms = slo_ttft_ms
        self.slo_itl_ms = slo_itl_ms
        # kept across generate() calls, as the reference's; none for a stack
        # whose context is not all K/V (supports_kv_extend), as the reference's
        self._can_extend = supports_kv_extend(cfg)
        self.prefix_cache = (RadixPrefixCache(prefix_cache_tokens)
                             if prefix_cache_tokens > 0 and self._can_extend else None)
        self._pool: Optional[SlotPool] = None
        self.last_metrics: Optional[EngineMetrics] = None
        # per-slot staged recall in flight, fed by the continuous scheduler
        self.recall_tracker = RecallFlightTracker(shards=self.tp)
        # whether every live lane's logits of the last generate() were finite
        self.last_logits_finite: Optional[bool] = None
        # under a compute mesh: the bytes the decode steps moved, by kind
        self.mesh_decode_bytes = dict.fromkeys(KINDS, 0)
        self.mesh_decode_steps = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # scheduler backend
    # ------------------------------------------------------------------
    @property
    def page_block_bytes(self) -> int:
        """Bytes of one (KV head, page) K+V block, the recall's unit: the
        packed unit (payload + scales) under the quantized tier."""
        return page_block_bytes(self.fkv, self.cfg.d_head, self._itemsize)

    @property
    def _itemsize(self) -> int:
        return torch.finfo(self.state_dtype).bits // 8

    def _apply_quant_metrics(self, em: EngineMetrics):
        em.kv_quant = self.fkv.kv_quant
        em.page_block_bytes = self.page_block_bytes
        em.dense_block_bytes = page_block_bytes_dense(self.fkv, self.cfg.d_head, self._itemsize)
        em.dequant_elems_per_block = 2 * self.fkv.page_size * self.cfg.d_head
        em.transfer_is_dma = self.fkv.offload == "host" and self.device.type == "cuda"
        if self._pool is not None:
            detail = self._pool.pool_bytes_detail()
            em.pool_bytes_physical = float(detail["physical"])
            em.pool_bytes_dense = float(detail["dense"])

    @property
    def prefill_chunk_tokens(self) -> int:
        """The chunked prefill's token budget a scheduler round; 0 is
        whole-shot prefill at admission, and always so for a stack the
        extension cannot serve (``supports_kv_extend``), as the reference."""
        return self.fkv.prefill_chunk_tokens if self._can_extend else 0

    @property
    def preempt(self) -> bool:
        """Whether the scheduler may swap a lower-priority running request
        out to host to admit a strictly higher-priority queued one."""
        return bool(self.fkv.preempt)

    def start_prefill_job(self, req: Request, pool: Optional[SlotPool] = None,
                          slot: Optional[int] = None) -> PrefillJob:
        """Open a chunked prefill of ``req`` into ``slot`` of ``pool``."""
        return PrefillJob(self, req, pool, slot)

    def make_slot_pool(self, num_slots: int) -> SlotPool:
        return SlotPool(self.cfg, self.fkv, num_slots, self.max_len, self.state_dtype,
                        self.device, self.mesh)

    def step(self, state, tokens):
        before = self._moved()
        out = serve_step(self.cfg, self.fkv, self.params, state, tokens.long(),
                         collect_stats=True, mesh=self.mesh)
        self._count_decode(before, 1)
        return out

    def _moved(self):
        return dict(self.mesh.moved.bytes) if self.compute_mesh else None

    def _count_decode(self, before, n_steps: int):
        """Add the bytes moved since ``before`` to the decode steps'."""
        if before is None:
            return
        for k, v in self.mesh.moved.bytes.items():
            self.mesh_decode_bytes[k] += v - before[k]
        self.mesh_decode_steps += n_steps

    def _apply_mesh_metrics(self, em: EngineMetrics, moved_at_start):
        """The run's mesh section: the decode steps' bytes by kind, and the
        rest (the prefills') from the mesh's counter."""
        if not self.compute_mesh:
            return
        em.mesh_shape = dict(self.mesh.shape)
        em.mesh_decode_bytes = dict(self.mesh_decode_bytes)
        em.mesh_decode_steps = self.mesh_decode_steps
        em.mesh_other_bytes = {k: v - moved_at_start[k] - self.mesh_decode_bytes[k]
                               for k, v in self.mesh.moved.bytes.items()}

    def _reset_mesh_counts(self):
        self.mesh_decode_bytes = dict.fromkeys(KINDS, 0)
        self.mesh_decode_steps = 0
        return self._moved()

    @property
    def rows_meet(self) -> bool:
        """Whether a decode step's rows affect each other: a MoE layer's
        capacity is shared by the step's B tokens (``models/moe``)."""
        return any(f == MOE for _, f in self.cfg.layers)

    def decode_window(self, state, loop, n_steps: int, stop_turnover: bool = False,
                      read_finishes: bool = False):
        """``n_steps`` fused decode steps without a host read; ``state`` is
        updated in place. ``read_finishes``: one read a step, the window
        stopping where the reference's does (``models.model.decode_window``).
        Under speculative decoding, at most ``n_steps`` verify iterations
        (``decode_window_spec``'s window rule), and the blocks are (n, 1 +
        draft_len, B)."""
        before = self._moved()
        if self.spec_decode:
            out = decode_window_spec(self.cfg, self.fkv, self.params, state, loop,
                                     self.sampler, n_steps, stop_turnover, mesh=self.mesh)
            # a verify iteration is 1 + draft_len decode steps
            self._count_decode(before, out[2].shape[0] * out[2].shape[1])
            return out
        out = decode_window(self.cfg, self.fkv, self.params, state, loop, self.sampler,
                            n_steps, stop_turnover, read_finishes, mesh=self.mesh)
        self._count_decode(before, out[2].shape[0])
        return out

    def sample_lanes(self, logits, keys, counts):
        """Per-slot sampling outside the window (the synchronous path): token
        ``counts[b]`` of each slot's stream."""
        return sample_counted(logits, self.sampler, keys, counts)

    def sample_slot(self, logits, req_key, count: int):
        """Token ``count`` of one request from its B=1 logits."""
        keys = req_key.reshape(1, 2).to(logits.device)
        return self.sample_lanes(logits, keys, torch.full((1,), count, dtype=torch.int32,
                                                          device=logits.device))

    def _attach_draft_tab(self, state, seq, hint=None, group: int = 0):
        """Seed the B=1 state's drafter table from the padded prompt, its
        bigrams overlaid by the hint's (reference ``engine.py:394``); a
        no-op without speculative decoding. Under a compute mesh the table
        lives on shard 0 of the data group that prefilled it, the slot's
        (``"<group>:0/draft_tab"``)."""
        if not self.spec_decode or state is None:
            return state
        from repro_torch.core import drafter
        tab = drafter.seed_from_prompt(self.cfg.vocab_size, np.asarray(seq, np.int64))
        if hint is not None and len(hint) >= 2:
            h = drafter.seed_from_prompt(self.cfg.vocab_size, np.asarray(hint, np.int64))
            tab = np.where(h >= 0, h, tab)
        tab = torch.from_numpy(tab)
        if self.compute_mesh:
            state["draft_tab"] = {f"{group}:0/draft_tab": tab.to(self._group_device(group))}
        else:
            state["draft_tab"] = tab.to(self.device)
        return state

    def _frontend_batch(self, reqs: List[Request]) -> dict:
        """``{"frontend": (B, F, d) float32}`` for a frontend config, each
        request's embeddings or zeros (reference ``engine.py:450-454``,
        ``:562-567``); ``{}`` otherwise."""
        cfg = self.cfg
        if cfg.frontend is None:
            return {}
        fe = np.stack([np.zeros((cfg.n_frontend_tokens, cfg.d_model), np.float32)
                       if r.frontend is None else np.asarray(r.frontend, np.float32)
                       for r in reqs])
        return {"frontend": torch.from_numpy(fe).to(self.device)}

    def _padded_prompt(self, req: Request) -> np.ndarray:
        """The prompt left-padded to a whole number of buckets."""
        tokens = np.asarray(req.tokens, np.int32)
        b = self.prefill_bucket
        padded_len = max(b, -(-len(tokens) // b) * b)
        prefix = frontend_prefix(self.cfg)
        if prefix + padded_len + req.max_new_tokens > self.max_len:
            raise ValueError(f"request {req.uid}: {prefix} frontend tokens + padded "
                             f"prompt {padded_len} + {req.max_new_tokens} new tokens exceeds "
                             f"max_len {self.max_len}")
        out = np.full((padded_len,), self.pad_token, np.int32)
        out[padded_len - len(tokens):] = tokens
        return out

    def prefill_one(self, req: Request, pool: Optional[SlotPool] = None,
                    slot: Optional[int] = None):
        """Prefill one request (B=1), through the prefix cache when there is
        one -> (last-token logits (1, V), B=1 decode state, prefix-hit
        tokens, padded prompt length) (reference ``engine.py:420``): a
        ``PrefillJob`` run in one chunk. With ``pool`` and ``slot`` the
        state is built straight into the slot's rows (``SlotPool.claim``)."""
        job = PrefillJob(self, req, pool, slot)
        job.advance(job.remaining)
        return job.result

    # -- the prefix cache's payload: [k, v] a layer, each (T, kv, dh) ----
    def _cache_lookup(self, seq):
        """(reused tokens, matched pieces): the match shrunk so the suffix
        is a whole number of buckets, 0 unless at least a page is reused
        (the reference's rule)."""
        matched, parts = self.prefix_cache.match_parts(seq)
        b = self.prefill_bucket
        suffix = max(b, -(-(len(seq) - matched) // b) * b)
        tp = len(seq) - suffix
        return (tp if tp >= max(b, self.fkv.page_size) else 0), parts

    def _kv_buffers(self, n_tokens: int, dtype, device=None):
        shape = (1, n_tokens, self.cfg.n_kv_heads, self.cfg.d_head)
        device = self.device if device is None else device
        return [tuple(torch.empty(shape, dtype=dtype, device=device) for _ in range(2))
                for _ in self.cfg.layers]

    def _group_device(self, g: int):
        """Data group g's shard 0 under a compute mesh (where a request's
        K/V buffers live), else the engine's device."""
        return self.mesh.device((g, 0)) if self.compute_mesh else self.device

    @staticmethod
    def _flat(kv):
        return [t[0] for pair in kv for t in pair]

    def _load_prefix(self, parts, n_tokens: int, device=None):
        """K/V buffers for an ``n_tokens`` prompt holding the matched pieces
        in their leading tokens, copied from the (pinned) host."""
        kv = self._kv_buffers(n_tokens, parts[0][0].dtype, device)
        copy_parts(parts, self._flat(kv))
        return kv

    def _cache_insert(self, seq, kv) -> int:
        """Copy the prompt's K/V into the trie (pinned host on the card);
        returns the tokens newly stored."""
        return self.prefix_cache.insert(seq, self._flat(kv))

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------
    def generate(self, requests: List[Request], seed: int = 0) -> List[Completion]:
        if self.scheduler == "continuous":
            return self._generate_continuous(requests, seed)
        t0 = time.perf_counter()
        moved_at_start = self._reset_mesh_counts()
        em = EngineMetrics(num_slots=self.batch_size, scheduler="static", tp=self.tp,
                           sample_on_device=False)
        out: List[Completion] = []
        self.last_logits_finite = True
        for i in range(0, len(requests), self.batch_size):
            out.extend(self._generate_batch(requests[i: i + self.batch_size], seed + i, em,
                                            t0))
        self._apply_quant_metrics(em)
        self._apply_mesh_metrics(em, moved_at_start)
        em.wall_s = time.perf_counter() - t0
        em.requests = [c.metrics for c in out]
        for rm in em.requests:
            em.record_request(rm)
        self.last_metrics = em
        return out

    def _generate_continuous(self, requests: List[Request], seed: int,
                             service=None) -> List[Completion]:
        if self.scheduler != "continuous":
            raise ValueError("live serving needs scheduler='continuous'")
        if self._pool is None:
            self._pool = self.make_slot_pool(self.batch_size)
        else:
            self._pool.reset_all()
        self.recall_tracker = RecallFlightTracker(shards=self.tp)
        moved_at_start = self._reset_mesh_counts()
        sched = ContinuousScheduler(self, self._pool)
        tracked, em = sched.run(requests, seed, service=service)
        self._apply_quant_metrics(em)
        self._apply_mesh_metrics(em, moved_at_start)
        if self.prefix_cache is not None:
            em.prefix_cache = self.prefix_cache.stats()
        self.last_metrics = em
        self.last_logits_finite = sched.logits_finite
        return [Completion(uid=tr.req.uid, tokens=tr.tokens, prefill_s=tr.prefill_s,
                           decode_s=tr.decode_s, steps=max(len(tr.tokens) - 1, 0),
                           stats=_request_stats(tr.agg), metrics=tr.metrics)
                for tr in tracked]

    def serve_service(self, service, seed: int = 0) -> List[Completion]:
        """Live serving: the continuous scheduler fed by ``service``
        (``serving/frontend.EngineService``: requests admitted as they
        arrive, tokens streamed, hung-up clients cancelled) until the
        service closes and drains. Blocks; the front-end runs it on a
        worker thread, which then makes every call to the card. Returns
        every completion, cancelled requests' partial ones included, in
        admission order."""
        return self._generate_continuous([], seed, service=service)

    # -- static lockstep fallback --------------------------------------------
    def _generate_batch(self, reqs: List[Request], seed: int,
                        em: EngineMetrics, t_start: float) -> List[Completion]:
        """One lockstep batch. ``em`` counts the decode steps, the live
        rows and the host reads, and with ``obs`` on the step times (the
        reference's static path records none of them). Each request's
        metrics hold its prefill start, its first token's arrival on the
        host and its finish, in seconds from ``t_start`` (every request is
        enqueued at 0)."""
        cfg, fkv = self.cfg, self.fkv
        B = len(reqs)
        T = max(len(r.tokens) for r in reqs)
        toks = np.zeros((B, T), np.int32)
        for i, r in enumerate(reqs):            # left-pad to align the last token
            toks[i, T - len(r.tokens):] = r.tokens
        prefix = frontend_prefix(cfg)
        if prefix + T + max(r.max_new_tokens for r in reqs) > self.max_len:
            raise ValueError(f"{prefix} frontend tokens + prompt {T} + new tokens "
                             f"exceeds max_len {self.max_len}")
        # a frontend prefix sits ahead of the left padding (``_embed_inputs``)
        batch = {"tokens": torch.from_numpy(toks).long().to(self.device),
                 **self._frontend_batch(reqs)}

        t0 = time.perf_counter()
        rms = [RequestMetrics(uid=r.uid, prompt_tokens=len(r.tokens),
                              padded_prompt_tokens=T, max_new_tokens=r.max_new_tokens,
                              prefill_start_t=t0 - t_start) for r in reqs]
        logits, state = prefill(cfg, fkv, self.params, batch, max_len=self.max_len,
                                state_dtype=self.state_dtype, mesh=self.mesh)
        self._sync()
        prefill_s = time.perf_counter() - t0

        # the reference's chain: PRNGKey(seed), then fold_in(key, step)
        key = PRNGKey(seed, self.device)
        max_new = max(r.max_new_tokens for r in reqs)
        out_toks = [[] for _ in reqs]
        aggs = [{k: 0.0 for k in DECODE_STAT_KEYS} for _ in reqs]
        decode_ss = [0.0 for _ in reqs]
        cur = sample(logits, self.sampler, key)
        finite = torch.isfinite(logits).all()       # read once, after the batch
        done = [r.max_new_tokens <= 0 for r in reqs]
        for step in range(max_new):
            cur_host = cur.tolist()
            em.host_syncs += 1
            t_host = time.perf_counter() - t_start
            for i, r in enumerate(reqs):
                if done[i]:
                    continue
                out_toks[i].append(cur_host[i])
                if rms[i].first_token_t is None:
                    rms[i].first_token_t = t_host
                if len(out_toks[i]) >= r.max_new_tokens or \
                        (r.eos_token is not None and cur_host[i] == r.eos_token):
                    done[i] = True
                    rms[i].finish_t = t_host
            if all(done):
                break
            ts = time.perf_counter()
            logits, state, stats = self.step(state, cur[:, None])
            key = fold_in(key, step)
            cur = sample(logits, self.sampler, key)
            finite &= torch.isfinite(logits).all()
            # one device-to-host read for all the step's statistics
            stats_np = dict(zip(DECODE_STAT_KEYS, torch.stack(
                [stats[k] for k in DECODE_STAT_KEYS]).cpu().numpy()))
            em.host_syncs += 1
            dt = time.perf_counter() - ts
            em.record_step(sum(not d for d in done))
            if self.obs.enabled:
                em.observe_decode_step(dt)
            for i in range(B):
                if not done[i]:
                    decode_ss[i] += dt
                    for k in aggs[i]:
                        aggs[i][k] += float(stats_np[k][i])
        self._sync()
        self.last_logits_finite = self.last_logits_finite and bool(finite)
        t_end = time.perf_counter() - t_start
        for i, rm in enumerate(rms):
            rm.new_tokens, rm.prefill_s, rm.decode_s = len(out_toks[i]), prefill_s, decode_ss[i]
            if rm.finish_t is None:             # max_new_tokens <= 0
                rm.finish_t = t_end
        return [Completion(uid=r.uid, tokens=out_toks[i], prefill_s=prefill_s,
                           decode_s=decode_ss[i], steps=max(len(out_toks[i]) - 1, 0),
                           stats=_request_stats(aggs[i]), metrics=rms[i])
                for i, r in enumerate(reqs)]
