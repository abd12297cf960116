"""KV-head-group tensor parallelism for serving (the first half of the
reference's ``repro/core/sharded_retrieval.py``, ``:65-213``).

``ServeEngine(tp>1)`` splits every retrieval-side state leaf over the GQA
KV-head axis (``sharding/rules.tp_state_axis``): each of ``tp`` shards owns
``n_kv_heads / tp`` KV heads and their ``G`` query heads, on its own device
(``launch/mesh.make_tp_mesh``), and runs the whole per-layer retrieval step
on them (append and page completion, selection, recall with its overlapped
double buffer and quantized pool view, correction, attention) through the
plain retriever built for a local config whose head counts are divided by
tp. Every one of those operations is per KV head, so a shard computes
exactly its slice of the unsharded step: greedy tokens equal tp=1's.

The reference runs one program over a ``("model",)`` mesh with the backbone
replicated on every shard. The port keeps one controller: the backbone
(embeddings, projections, FFN, logits) runs once, on the primary device,
and the wrapper hands each shard its heads of q/k/v, runs the shards one
after another from the same thread, and gathers the attention output onto
the primary device: one ``torch.cat`` on the head axis, after a ``.to``
where a shard sits on another card. That gather is the only tensor that
crosses shards; the integer transfer counters are summed exactly.

A layer's state is one flat dict with the shard in the key (``"0/pool"``,
``"1/pool"``, ...), so the slot pool's per-leaf row operations
(``serving/kv_slots``) act on every shard's rows without a loop over
shards. The page-sharded fused step (``sharded_decode_step``, the
reference's ``fkv.sharded_retrieval``) is not ported (ROADMAP queue 1 item
2).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig


def tp_group_size(mesh) -> int:
    """Size of the ``"model"`` axis, or 1 when there is no mesh."""
    if mesh is None or "model" not in getattr(mesh, "axis_names", ()):
        return 1
    return mesh.shape["model"]


def tp_serving_active(cfg: ArchConfig, mesh) -> bool:
    """Can retrieval run as KV-head-group TP on this (cfg, mesh)? The mesh
    alone decides: a ``("model",)`` axis whose size divides both head
    counts (every shard owns a whole group of KV heads and their G query
    heads)."""
    if mesh is None or "model" not in getattr(mesh, "axis_names", ()):
        return False
    mp = tp_group_size(mesh)
    return cfg.n_kv_heads % mp == 0 and cfg.n_heads % mp == 0


def _heads(t, s, n, axis, dev):
    """Shard ``s``'s ``n`` heads of ``t`` along ``axis``, contiguous, on ``dev``."""
    return t.narrow(axis, s * n, n).contiguous().to(dev)


class TPGroupShardedRetriever:
    """Any retriever run per KV-head group (reference ``:98-213``).

    ``make_inner`` builds the wrapped retriever for an ArchConfig; it is
    called once a shard with the local config (head counts divided by tp),
    so each shard has its own ``RecallExecutor``, whose staged recall runs
    on the side stream of that shard's device
    (``core/recall_pipeline.side_stream``). Shards that share a card share
    its streams; their launches are ordered on them as one shard's are.

    ``decode`` returns the attention output gathered onto the primary
    device, ``corrected``/``similarity`` concatenated on the KV-head axis,
    the ``_COUNTERS`` summed over the shards (exact integers), and each
    shard's own transfer counts, ``shard_sync_pages`` and
    ``shard_async_pages`` (tp, B), which the engine's per-shard accounting
    reads (``serving/metrics``, ``core/recall_pipeline``)."""

    # counters summed over (local) KV heads by each shard, added to their
    # exact global values (the speculation telemetry and Centroid's
    # candidate count included)
    _COUNTERS = ("sync_pages", "async_pages", "reused_pages", "sel_pages",
                 "spec_hit_pages", "churn_pages", "cand_pages")

    def __init__(self, cfg: ArchConfig, mesh, make_inner):
        tp = tp_group_size(mesh)
        if not tp_serving_active(cfg, mesh):
            raise ValueError(f"{cfg.name}: the model axis ({tp}) must divide both head counts "
                             f"({cfg.n_heads}/{cfg.n_kv_heads}) for KV-head-group TP")
        self.cfg, self.tp = cfg, tp
        self.devices = tuple(mesh.devices)
        self.local_cfg = dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                                             n_kv_heads=cfg.n_kv_heads // tp)
        self.inners = [make_inner(self.local_cfg) for _ in range(tp)]
        self.token_wise_recall = getattr(self.inners[0], "token_wise_recall", False)
        self._pre = [f"{s}/" for s in range(tp)]

    # -- a layer's state: one flat dict, the shard in the key ----------------
    def _sub(self, state, s):
        pre = self._pre[s]
        n = len(pre)
        return {k[n:]: v for k, v in state.items() if k.startswith(pre)}

    def _put(self, state, s, sub):
        """Shard ``s``'s entries of ``state`` become ``sub``'s, in place:
        entries the inner retriever dropped (a consumed ``sel_ready``) go."""
        pre = self._pre[s]
        for k in [k for k in state if k.startswith(pre) and k[len(pre):] not in sub]:
            del state[k]
        for k, v in sub.items():
            state[pre + k] = v

    def _each(self):
        return zip(range(self.tp), self.inners, self.devices)

    def init_state(self, batch, max_len, dtype=torch.bfloat16, device=None):
        """Every shard's empty state on its own device (``device``, the
        primary one, is the first shard's)."""
        state = {}
        for s, inner, dev in self._each():
            for k, v in inner.init_state(batch, max_len, dtype, dev).items():
                state[self._pre[s] + k] = v
        return state

    def prefill(self, state, k, v, q_last):
        """k/v (B, T, kv, d) split on the KV-head axis, q_last (B, H, d) on
        the query-head axis; each shard's prefill, in place."""
        kvl, hl = self.local_cfg.n_kv_heads, self.local_cfg.n_heads
        for s, inner, dev in self._each():
            sub = inner.prefill(self._sub(state, s), _heads(k, s, kvl, 2, dev),
                                _heads(v, s, kvl, 2, dev), _heads(q_last, s, hl, 1, dev))
            self._put(state, s, sub)
        return state

    def decode(self, state, q, k_new, v_new, length_host=None, q_proxy=None):
        kvl, hl = self.local_cfg.n_kv_heads, self.local_cfg.n_heads
        primary = q.device
        outs, infos = [], []
        for s, inner, dev in self._each():
            qp = None if q_proxy is None else _heads(q_proxy, s, hl, 1, dev)
            o, sub, info = inner.decode(self._sub(state, s), _heads(q, s, hl, 1, dev),
                                        _heads(k_new, s, kvl, 1, dev),
                                        _heads(v_new, s, kvl, 1, dev),
                                        length_host=length_host, q_proxy=qp)
            self._put(state, s, sub)
            outs.append(o.to(primary))
            infos.append(info)
        # the gather of the (B, H, d) attention output: the one tensor that
        # crosses shards
        o = torch.cat(outs, dim=1)
        out = {k: torch.cat([i[k].to(primary) for i in infos], dim=1)
               for k in ("corrected", "similarity")}
        for c in self._COUNTERS:
            if c in infos[0]:
                out[c] = sum(i[c].to(primary) for i in infos)
        for c in ("sync_pages", "async_pages"):
            out["shard_" + c] = torch.stack([i[c].to(primary) for i in infos])
        out["granularity"] = "token" if self.token_wise_recall else "page"
        return o, state, out

    # -- speculative-decoding rollback (models.model.serve_step_verify) -----
    def draft_probe(self, state):
        """Each shard's probe, concatenated into one flat tuple."""
        return tuple(x for s, inner, _ in self._each()
                     for x in inner.draft_probe(self._sub(state, s)))

    def draft_rewind(self, state, keep_len, probe):
        n = len(probe) // self.tp
        for s, inner, dev in self._each():
            sub = inner.draft_rewind(self._sub(state, s), keep_len.to(dev),
                                     probe[s * n:(s + 1) * n])
            self._put(state, s, sub)
        return state

    def ring_snapshot(self, state, n_rows):
        """Each shard's ``ring_snapshot``."""
        return [inner.ring_snapshot(self._sub(state, s), n_rows)
                for s, inner, _ in self._each()]

    def ring_restore(self, state, snaps, keep):
        """Each shard's ``ring_restore``, in place."""
        for (s, inner, dev), snap in zip(self._each(), snaps):
            inner.ring_restore(self._sub(state, s), snap, keep.to(dev))
        return state
