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
shards.

Under a ("data", "model") compute mesh (``ServeEngine(mesh=)``,
``models/model``) a data group's model shards run the same wrapper, their
q/k/v heads handed over where the column-parallel projections made them
(``prefill_parts``, ``decode_parts``), so nothing crosses shards there.

**The page-sharded fused decode step** (the second half of the reference's
module, ``sharded_decode_step``, ``:216-395``; ``fkv.sharded_retrieval``):
``PageShardedRetriever`` keeps one data group's FreeKV state split over
its m model shards by page and by selection slot, as the ``sharded_retrieval``
branch of ``sharding/rules.decode_state_spec``: shard j holds pages
[j n_loc, (j + 1) n_loc) of the pool and the summaries, slots [j k_loc,
(j + 1) k_loc) of ``sel_k``/``sel_v``/``sel_idx`` (n_loc = n_pages / m,
k_loc = n_sel / m), its own copy of the window ring and the lengths, and
shard 0 the sink and ``qprev``. One decode step:

  * every shard appends the token to its ring (the reference's ring is
    model-replicated state, appended on every shard);
  * only the owning shard writes a completed page (``complete_page_shard``);
  * each shard selects its own top-k_loc over its pages with global ids
    (``select_pages_shard``); with ``sharded_overselect`` > 1 the kept
    candidates' pooled scores meet on shard 0 for the global re-rank;
  * each shard recalls its ids from its own pages (``recall_gather`` on
    local ids) and reuses its slice of the previous selection for the
    heads that are not corrected;
  * each shard attends its pages, shard 0 also the sink and the window,
    with ``paged_attention_lse``; the partials merge on shard 0 by
    log-sum-exp.

A shard's selection is its own top-k, so the step approximates the global
top-k (the reference's design). The moves between shards go through
``sharding/transfer`` under their kinds: the query and the new K/V to the
page shards (``attn_in``), the (o, lse) partials and the selected ids the
telemetry reads (``lse``), the over-selection's scores and masks
(``overselect``), and the prefill's state handed from shard 0 to its page
shards (``state``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, FreeKVConfig


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
        devs = self.devices
        return self.prefill_parts(state, [_heads(k, s, kvl, 2, d) for s, d in enumerate(devs)],
                                  [_heads(v, s, kvl, 2, d) for s, d in enumerate(devs)],
                                  [_heads(q_last, s, hl, 1, d) for s, d in enumerate(devs)])

    def prefill_parts(self, state, ks, vs, q_lasts):
        """Each shard's prefill from its own heads, in place: ``ks[s]``,
        ``vs[s]`` (B, T, kv / tp, d) and ``q_lasts[s]`` (B, H / tp, d) on
        shard s's device."""
        for s, inner, _ in self._each():
            self._put(state, s, inner.prefill(self._sub(state, s), ks[s], vs[s], q_lasts[s]))
        return state

    def decode_parts(self, state, qs, k_news, v_news, length_host=None, q_proxies=None):
        """Each shard's decode step from its own heads (``qs[s]`` (B, H / tp,
        d), ``k_news[s]``/``v_news[s]`` (B, kv / tp, d), on shard s's
        device) -> (each shard's output on its device, state, each shard's
        info), state in place."""
        outs, infos = [], []
        for s, inner, _ in self._each():
            qp = None if q_proxies is None else q_proxies[s]
            o, sub, info = inner.decode(self._sub(state, s), qs[s], k_news[s], v_news[s],
                                        length_host=length_host, q_proxy=qp)
            self._put(state, s, sub)
            outs.append(o)
            infos.append(info)
        return outs, state, infos

    def merge_info(self, infos, primary):
        """The shards' infos as the unsharded retriever's, on ``primary``:
        ``corrected``/``similarity`` joined on the KV-head axis, the
        ``_COUNTERS`` summed, and each shard's own transfer counts."""
        out = {k: torch.cat([i[k].to(primary) for i in infos], dim=1)
               for k in ("corrected", "similarity")}
        for c in self._COUNTERS:
            if c in infos[0]:
                out[c] = sum(i[c].to(primary) for i in infos)
        for c in ("sync_pages", "async_pages"):
            out["shard_" + c] = torch.stack([i[c].to(primary) for i in infos])
        out["granularity"] = "token" if self.token_wise_recall else "page"
        return out

    def decode(self, state, q, k_new, v_new, length_host=None, q_proxy=None):
        kvl, hl = self.local_cfg.n_kv_heads, self.local_cfg.n_heads
        primary = q.device
        devs = self.devices
        qps = (None if q_proxy is None else
               [_heads(q_proxy, s, hl, 1, d) for s, d in enumerate(devs)])
        outs, state, infos = self.decode_parts(
            state, [_heads(q, s, hl, 1, d) for s, d in enumerate(devs)],
            [_heads(k_new, s, kvl, 1, d) for s, d in enumerate(devs)],
            [_heads(v_new, s, kvl, 1, d) for s, d in enumerate(devs)],
            length_host=length_host, q_proxies=qps)
        # the gather of the (B, H, d) attention output: the one tensor that
        # crosses shards
        o = torch.cat([o.to(primary) for o in outs], dim=1)
        return o, state, self.merge_info(infos, primary)

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


# ---------------------------------------------------------------------------
# the page-sharded fused decode step (reference ``:216-395``)
# ---------------------------------------------------------------------------
# a page shard's leaves, each split over the shards (pages or slots) or held
# by every shard (the ring and the lengths); shard 0 alone holds these
PAGE_SPLIT = ("pool", "summ")
SLOT_SPLIT = ("sel_k", "sel_v", "sel_idx")
EVERY_SHARD = ("win_k", "win_v", "win_pos", "length")
SHARD0_ONLY = ("sink_k", "sink_v", "qprev")


class PageShardedRetriever:
    """FreeKV's decode over one data group's ``row.m`` model shards with the
    pool split by page (``fkv.sharded_retrieval``; the module docstring has
    the step). ``row`` is a ``sharding/transfer.MeshRow``; every move
    between its shards is counted on its mesh. A layer's state is one flat
    dict with the shard in the key (``"<j>/<leaf>"``), as the KV-head-group
    wrapper's, so the slot pool's row operations act on every shard's rows.

    Inputs and outputs live on the row's shard 0: ``prefill`` takes the
    prompt's whole K/V and last query there, ``decode`` the step's q, k_new
    and v_new, and returns the merged attention output and the info there.
    The info is the reference's fused-path info (``retrieval.py:296-318``):
    every selected slot counts as recalled, synchronously for a corrected
    head and asynchronously otherwise, and the speculation telemetry
    compares the step's whole selection with the previous one."""

    token_wise_recall = False

    def __init__(self, cfg: ArchConfig, fkv: FreeKVConfig, row, speculative: bool = True):
        if fkv.kv_quant != "none":
            raise ValueError("the page-sharded step reads an unquantized pool "
                             "(kv_quant falls back to the plain path)")
        self.cfg, self.fkv, self.row, self.m = cfg, fkv, row, row.m
        # ArkVale and InfiniGen select fresh for every head (reference
        # ``retrieval.py:283-285``)
        self.speculative = speculative

    def dims(self, max_len: int):
        """(p, n_pages, n_sink, n_win, n_sel, n_loc, k_loc) of a state for
        ``max_len`` tokens; raises where the pages or the slots do not
        divide the model axis (``retrieval.use_sharded``)."""
        from repro_torch.core import paging
        p, n_pages, n_sink, n_win, n_sel = paging.state_dims(self.cfg, self.fkv, max_len)
        if n_pages % self.m or n_sel % self.m:
            raise ValueError(f"{n_pages} pages and {n_sel} selection slots must divide the "
                             f"model axis ({self.m}) for the page-sharded step")
        return p, n_pages, n_sink, n_win, n_sel, n_pages // self.m, n_sel // self.m

    def init_state(self, batch, max_len, dtype=torch.bfloat16, device=None):
        """Each shard's empty pieces on its own device (``device`` is the
        row's shard 0, which the row already names)."""
        from repro_torch.core import offload
        cfg, fkv = self.cfg, self.fkv
        p, _, n_sink, n_win, _, n_loc, k_loc = self.dims(max_len)
        kv, d, H = cfg.n_kv_heads, cfg.d_head, cfg.n_heads
        state = {}
        for j in range(self.m):
            dev = self.row.device(j)

            def z(*shape, dt=dtype):
                return torch.zeros(shape, dtype=dt, device=dev)
            state.update({
                f"{j}/pool": offload.alloc_pool((batch, n_loc, kv, 2, p, d), dtype, fkv, dev),
                f"{j}/summ": z(batch, n_loc, kv, 2, d),
                f"{j}/sel_k": z(batch, kv, k_loc, p, d),
                f"{j}/sel_v": z(batch, kv, k_loc, p, d),
                f"{j}/sel_idx": torch.full((batch, kv, k_loc), -1, dtype=torch.int32,
                                           device=dev),
                f"{j}/win_k": z(batch, n_win, kv, d),
                f"{j}/win_v": z(batch, n_win, kv, d),
                f"{j}/win_pos": torch.full((batch, n_win), -1, dtype=torch.int32, device=dev),
                f"{j}/length": torch.zeros((batch,), dtype=torch.int32, device=dev)})
            if j == 0:
                state.update({"0/sink_k": z(batch, n_sink, kv, d),
                              "0/sink_v": z(batch, n_sink, kv, d), "0/qprev": z(batch, H, d)})
        return state

    def _sub(self, state, j):
        pre = f"{j}/"
        return {k[len(pre):]: v for k, v in state.items() if k.startswith(pre)}

    def prefill(self, state, k, v, q_last):
        """The prompt's K/V (B, T, kv, d) and last query (B, H, d) on shard
        0 -> the state, in place. The plain FreeKV prefill builds the whole
        state on shard 0 (the reference's prefill selects its first pages
        over every page, globally, ``retrieval.py:253-263``), and each shard
        takes its pages, its slots and a copy of the ring and the lengths
        (``state`` moves); the pages and slots it takes are its blocks of
        the ``sharded_retrieval`` branch of ``sharding/rules
        .decode_state_spec``."""
        from repro_torch.core import paging
        from repro_torch.core.retrieval import FreeKVRetriever
        from repro_torch.launch.mesh import Mesh
        from repro_torch.sharding import rules
        fkv, row = self.fkv, self.row
        n_loc = state["0/pool"].shape[1]
        p = state["0/pool"].shape[4]
        dtype = state["0/win_k"].dtype
        whole = paging.init_kv_state(self.cfg, dataclasses.replace(fkv, offload="sim"),
                                     k.shape[0], self.m * n_loc * p, dtype, k.device)
        whole = FreeKVRetriever(self.cfg, fkv, speculative=self.speculative).prefill(
            whole, k, v, q_last)
        # the split leaves' blocks by the sharded_retrieval branch of
        # decode_state_spec, on one data group's (1, m) mesh
        group = Mesh(("data", "model"), (1, self.m))
        specs = {key: rules.decode_state_spec(self.cfg, group, key, whole[key].shape, fkv)
                 for key in PAGE_SPLIT + SLOT_SPLIT}
        for j in range(self.m):
            parts = {key: whole[key] for key in EVERY_SHARD + (SHARD0_ONLY if j == 0 else ())}
            parts.update({key: rules.model_block(spec, whole[key], self.m, j)
                          for key, spec in specs.items()})
            for key, t in parts.items():
                dst = state[f"{j}/{key}"]
                dst.copy_(row.move(t, 0, j, "state").to(dst.dtype))
        return state

    def decode(self, state, q, k_new, v_new, length_host=None, q_proxy=None):
        """One fused step: q (B, H, d), k_new/v_new (B, kv, d) on shard 0 ->
        (o (B, H, d) on shard 0, state, info on shard 0), state in place."""
        from repro_torch.core import paging, selection
        from repro_torch.core.correction import corrected_heads
        from repro_torch.core.recall_pipeline import match_resident
        from repro_torch.core.retrieval import _cat_regions, _page_region, _scale
        from repro_torch.kernels import ops
        cfg, fkv, row, m = self.cfg, self.fkv, self.row, self.m
        p = fkv.page_size
        B, H, d = q.shape
        kv = cfg.n_kv_heads
        G = H // kv
        st0 = self._sub(state, 0)
        n_loc = st0["pool"].shape[1]
        k_loc = st0["sel_idx"].shape[2]
        if self.speculative:
            corr, sim = corrected_heads(cfg, fkv, q, st0["qprev"])
            corr = corr | torch.all(st0["qprev"].float() == 0)
        else:
            corr = torch.ones((B, kv), dtype=torch.bool, device=q.device)
            sim = torch.zeros((B, kv), dtype=torch.float32, device=q.device)
        prev_idx = [state[f"{j}/sel_idx"] for j in range(m)]
        qg = q.reshape(B, kv, G, d).contiguous()
        ins = [(qg, k_new, v_new, corr)] + [
            tuple(row.move(t, 0, j, "attn_in") for t in (qg, k_new, v_new, corr))
            for j in range(1, m)]
        kw = selection.select_kwargs(cfg, fkv, d)
        kk = min(k_loc, n_loc)
        idxs, tops = [], []
        for j in range(m):
            sub = self._sub(state, j)
            qj, kn, vn, _ = ins[j]
            cur = sub["length"]
            paging.ring_append(sub, kn, vn)
            state[f"{j}/length"] = sub["length"]
            ops.complete_page_shard(sub["win_k"], sub["win_v"], sub["length"], sub["summ"],
                                    sub["pool"], page_lo=j * n_loc)
            idx, top = ops.select_pages_shard(qj, sub["summ"], sub["length"], page_lo=j * n_loc,
                                              n_sel=k_loc, mode=fkv.group_pool, **kw)
            idxs.append((idx, cur))
            tops.append(top)
        if fkv.sharded_overselect > 1:
            # the global re-rank (reference :308-320): a candidate survives
            # where fewer than n_target candidates of every shard score
            # strictly above it
            n_target = (kk * m) // fkv.sharded_overselect
            cands = [tops[0][..., :kk]] + [row.move(t[..., :kk], j, 0, "overselect")
                                           for j, t in enumerate(tops) if j]
            all_s = torch.cat(cands, dim=-1)                       # (B, kv, m kk)
            for j in range(m):
                keep = (all_s[:, :, None, :] > cands[j][..., None]).sum(dim=-1) < n_target
                if kk < k_loc:
                    keep = torch.cat([keep, torch.zeros_like(keep[..., :k_loc - kk])], dim=-1)
                keep = keep if j == 0 else row.move(keep, 0, j, "overselect")
                idx, cur = idxs[j]
                idxs[j] = (torch.where(keep & (idx >= 0), idx, torch.full_like(idx, -1)), cur)
        outs = []
        for j in range(m):
            sub = self._sub(state, j)
            idx, cur = idxs[j]
            qj, _, _, cj = ins[j]
            lo = j * n_loc
            local = torch.where(idx >= 0, idx - lo, torch.full_like(idx, -1))
            new_k, new_v = ops.recall_gather(sub["pool"], local)
            new_k = new_k.to(sub["sel_k"].dtype)
            new_v = new_v.to(sub["sel_v"].dtype)
            mk = cj[:, :, None, None, None]
            use_k = torch.where(mk, new_k, sub["sel_k"])
            use_v = torch.where(mk, new_v, sub["sel_v"])
            use_idx = torch.where(cj[:, :, None], idx, sub["sel_idx"])
            if j == 0:
                k_cat, v_cat, pos = _cat_regions(fkv, sub, use_k, use_v, use_idx, p)
            else:
                k_cat, v_cat, pos = _page_region(fkv, sub["length"], use_k, use_v, use_idx, p)
            L = k_cat.shape[2]
            o, lse = ops.paged_attention_lse(
                qj, k_cat.reshape(B, kv, L // p, p, d), v_cat.reshape(B, kv, L // p, p, d),
                pos.reshape(B, kv, L // p, p), cur, scale=_scale(cfg),
                softcap=cfg.attn_logit_softcap)
            state.update({f"{j}/sel_k": new_k, f"{j}/sel_v": new_v, f"{j}/sel_idx": idx})
            outs.append((o, lse) if j == 0 else (row.move(o, j, 0, "lse"),
                                                 row.move(lse, j, 0, "lse")))
        # the log-sum-exp merge of the page shards' partials, on shard 0
        mx = outs[0][1]
        for _, lse in outs[1:]:
            mx = torch.maximum(mx, lse)
        num = den = None
        for o, lse in outs:
            w = torch.exp(lse - mx)
            num = o.float() * w[..., None] if num is None else num + o.float() * w[..., None]
            den = w if den is None else den + w
        o = (num / den[..., None]).to(q.dtype).reshape(B, H, d)
        state["0/qprev"] = q.to(st0["qprev"].dtype)
        new_idx = torch.cat([idxs[0][0]] + [row.move(i, j, 0, "lse")
                                            for j, (i, _) in enumerate(idxs) if j], dim=2)
        old_idx = torch.cat([prev_idx[0]] + [row.move(i, j, 0, "lse")
                                             for j, i in enumerate(prev_idx) if j], dim=2)
        n_sel = new_idx.shape[2]
        sel_pages = (new_idx >= 0).sum(dim=(1, 2))
        spec_hit = match_resident(new_idx, old_idx)[0].sum(dim=(1, 2))
        info = {"corrected": corr, "similarity": sim,
                "sync_pages": corr.sum(dim=1) * n_sel, "async_pages": (~corr).sum(dim=1) * n_sel,
                "sel_pages": sel_pages, "spec_hit_pages": spec_hit,
                "churn_pages": sel_pages - spec_hit, "granularity": "page"}
        return o, state, info
