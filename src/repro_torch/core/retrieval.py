"""Retrievers behind one API (reference ``repro/core/retrieval.py``):

    r = make_retriever(cfg, fkv)
    state = r.init_state(batch, max_len, dtype, device)
    state = r.prefill(state, k, v, q_last)       # bulk-insert a prompt
    o, state, info = r.decode(state, q, k_new, v_new[, q_proxy=...])

Shapes: k/v (B,T,kv,dh) post-RoPE; q (B,H,dh) one decode token; q_proxy
(B,H,dh) the previous attention layer's query (zeros for the first), read
by InfiniGen only. ``decode`` updates ``state`` in place and returns it.

All nine methods of the reference (``make_retriever``): ``freekv``
(speculative retrieval + correction, the paper), ``arkvale`` (fresh
selection + blocking recall every step), ``infinigen`` (blocking, selection
from the proxy query, token granularity in ``info``), ``quest`` (per-query-
head selection, the pool on the card), ``shadowkv`` (low-rank keys on the
device, V-only recall), ``raas`` (sink + window + kept pages with recency
timestamps, no pool), ``streaming`` (sink + window; also gemma2's local
layers), ``full`` (the exact oracle) and ``centroid`` (centroid-then-token
selection inside FreeKV's machinery, ``core/centroid_index``). Every
decode attention but ``full``'s is the ``paged_attention`` kernel on the
card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import card_branch
from repro_torch.configs.base import ArchConfig, FreeKVConfig
from repro_torch.core import centroid_index, paging, selection
from repro_torch.core.correction import corrected_heads
from repro_torch.core.recall_pipeline import (RecallExecutor, match_resident,
                                              wait_staged)
from repro_torch.core.sharded_retrieval import TPGroupShardedRetriever
from repro_torch.kernels import ops
from repro_torch.models.layers import softcap
from repro_torch.obs.trace import (SPAN_ATTN_COMPUTE, SPAN_RECALL_CORRECTION, SPAN_RECALL_SELECT,
                                   annotate)

NEG_INF = -1e30


def _scale(cfg):
    return cfg.attn_scale if cfg.attn_scale is not None else 1.0 / (cfg.d_head ** 0.5)


def _attend(cfg, q, k_cat, v_cat, pos_cat, cur_pos, fkv=None):
    """q (B,H,d); k/v_cat (B,kv,L,d); pos_cat (B,kv,L) -> (B,H,d).

    With ``fkv`` given this is the ``paged_attention`` kernel (its plain
    version on the CPU), which reads L as whole pages: an L that is not a
    whole number of pages raises off the CPU and takes the plain einsum on
    it. Without ``fkv`` (the full-cache oracle) it is the reference's plain
    einsum."""
    B, H, d = q.shape
    kv, L = k_cat.shape[1], k_cat.shape[2]
    G = H // kv
    if fkv is not None and L % fkv.page_size:
        if q.device.type != "cpu":
            raise ValueError(
                f"{L} attended tokens are not a whole number of {fkv.page_size}-token pages: "
                "paged_attention reads pages (the sink and window sizes must be page multiples)")
    elif fkv is not None:
        p = fkv.page_size
        o = ops.paged_attention(
            q.reshape(B, kv, G, d).contiguous(),
            k_cat.reshape(B, kv, L // p, p, d),
            v_cat.reshape(B, kv, L // p, p, d),
            pos_cat.reshape(B, kv, L // p, p), cur_pos,
            scale=_scale(cfg), softcap=cfg.attn_logit_softcap)
        return o.reshape(B, H, d)
    qg = q.reshape(B, kv, G, d)
    s = torch.einsum("bkgd,bkld->bkgl", qg, k_cat).float() * _scale(cfg)
    s = softcap(s, cfg.attn_logit_softcap)
    ok = (pos_cat >= 0) & (pos_cat <= cur_pos[:, None, None])
    s = torch.where(ok[:, :, None, :], s, torch.full((), NEG_INF, device=s.device))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgl,bkld->bkgd", w.to(v_cat.dtype), v_cat)
    return o.reshape(B, H, d)


def _window_floor(fkv, length):
    """First position attended through the window ring; selectable pages are
    exactly [n_sink//p, window_floor//p), so sink / selected / window
    partition the context."""
    p = fkv.page_size
    return torch.clamp(torch.div(length - fkv.n_window, p, rounding_mode="floor"),
                       min=fkv.n_sink // p) * p


def _cat_regions(fkv, state, sel_k, sel_v, sel_idx, p, rep=1):
    """Sink + window + selected pages per KV head, with the three-region
    position partition applied through pos = -1 masking. ``rep`` > 1 gives
    each KV head's sink and window to ``rep`` consecutive rows, whose
    selected pages sel_k/sel_v (B, kv * rep, n_sel, p, d) and sel_idx (B,
    kv * rep, n_sel) are their own (Quest's per-query-head rows)."""
    B, n_sink, _, d = state["sink_k"].shape
    kv = sel_idx.shape[1]
    n_win = state["win_k"].shape[1]
    length = state["length"]
    dev = length.device
    wfloor = _window_floor(fkv, length)[:, None, None]
    neg = torch.full((), -1, dtype=torch.int32, device=dev)

    def rows(t):                                                   # (B,n,kv0,d) -> (B,kv,n,d)
        t = t.transpose(1, 2)
        return t if rep == 1 else t.repeat_interleave(rep, dim=1)

    ks, vs = rows(state["sink_k"]), rows(state["sink_v"])
    pos_s = torch.arange(n_sink, dtype=torch.int32, device=dev)[None, None, :].expand(B, kv, n_sink)
    pos_s = torch.where(pos_s < length[:, None, None], pos_s, neg)
    kw, vw = rows(state["win_k"]), rows(state["win_v"])
    pos_w = state["win_pos"][:, None, :].expand(B, kv, n_win)
    pos_w = torch.where((pos_w >= n_sink) & (pos_w >= wfloor), pos_w, neg)
    n_sel = sel_idx.shape[2]
    kp = sel_k.reshape(B, kv, n_sel * p, d)
    vp = sel_v.reshape(B, kv, n_sel * p, d)
    pos_p = sel_idx[..., None] * p + torch.arange(p, dtype=torch.int32, device=dev)
    pos_p = torch.where(sel_idx[..., None] >= 0, pos_p, neg).reshape(B, kv, n_sel * p)
    pos_p = torch.where((pos_p >= n_sink) & (pos_p < wfloor), pos_p, neg)
    k_cat = torch.cat([ks, kw, kp], dim=2)
    v_cat = torch.cat([vs, vw, vp], dim=2)
    pos = torch.cat([pos_s, pos_w, pos_p], dim=2).to(torch.int32)
    return k_cat, v_cat, pos


def _page_region(fkv, length, sel_k, sel_v, sel_idx, p):
    """The selected pages alone as ``_cat_regions`` lays them out, their
    positions masked to [n_sink, window floor): a page shard of the fused
    step other than shard 0, which holds no sink and attends no window."""
    B, kv, n_sel = sel_idx.shape
    d = sel_k.shape[-1]
    dev = length.device
    wfloor = _window_floor(fkv, length)[:, None, None]
    neg = torch.full((), -1, dtype=torch.int32, device=dev)
    pos = sel_idx[..., None] * p + torch.arange(p, dtype=torch.int32, device=dev)
    pos = torch.where(sel_idx[..., None] >= 0, pos, neg).reshape(B, kv, n_sel * p)
    pos = torch.where((pos >= fkv.n_sink) & (pos < wfloor), pos, neg).to(torch.int32)
    return sel_k.reshape(B, kv, n_sel * p, d), sel_v.reshape(B, kv, n_sel * p, d), pos


def ring_snapshot(state, n_rows: int):
    """Copy the ``n_rows`` window-ring slots a drafted block will write
    (reference ``retrieval.py:121``): appends at positions ``length + j``
    land in slots ``(length + j) % n_win``, distinct while ``n_rows <=
    n_win``, so their (k, v, pos) before the block are a complete undo log.
    The verify pass appends in place, so these are copies. Any state with
    the ``win_k``/``win_v``/``win_pos`` ring (FreeKV's, streaming's)."""
    n_win = state["win_k"].shape[1]
    dev = state["length"].device
    slots = ((state["length"][:, None].long()
              + torch.arange(n_rows, device=dev)[None]) % n_win)
    bidx = torch.arange(slots.shape[0], device=dev)[:, None]
    return (slots, state["win_k"][bidx, slots], state["win_v"][bidx, slots],
            state["win_pos"][bidx, slots])


def ring_restore(state, snap, keep):
    """Undo the ring writes of rejected drafted rows, in place (reference
    ``retrieval.py:139``): ``keep`` (B,) is each slot's committed row count
    m; slots written by rows >= m take their snapshot back, the others keep
    what the rows wrote (what m sequential appends leave). Pool pages and
    summaries written by rejected rows stay: a page is selectable only
    below ``length // p``, and the genuine append that completes it
    rewrites it first (``complete_page`` writes a page only on the step
    that completes it)."""
    slots, k, v, pos = snap
    B, S = slots.shape
    dev = slots.device
    rej = torch.arange(S, device=dev)[None, :] >= keep[:, None]
    bidx = torch.arange(B, device=dev)[:, None]
    r4 = rej[:, :, None, None]
    state["win_k"][bidx, slots] = torch.where(r4, k, state["win_k"][bidx, slots])
    state["win_v"][bidx, slots] = torch.where(r4, v, state["win_v"][bidx, slots])
    state["win_pos"][bidx, slots] = torch.where(rej, pos, state["win_pos"][bidx, slots])
    return state


class RingRollback:
    """``ring_snapshot``/``ring_restore`` as a retriever's methods, which
    ``models.model.serve_step_verify`` and ``rewind_state`` call on every
    layer's retriever; the tensor-parallel wrapper
    (``core/sharded_retrieval``) runs them on each shard's ring."""

    def ring_snapshot(self, state, n_rows: int):
        return ring_snapshot(state, n_rows)

    def ring_restore(self, state, snap, keep):
        return ring_restore(state, snap, keep)


class FreeKVRetriever(RingRollback):
    """FreeKV (speculative=True) and, by flags, the ArkVale-style baseline
    (speculative=False: fresh selection, blocking recall every step) and
    the InfiniGen-style one (also ``proxy_query``: the selection reads the
    previous attention layer's query; ``token_wise_recall`` reports token
    granularity in ``info``), reference ``retrieval.py:165-174``."""

    def __init__(self, cfg: ArchConfig, fkv: FreeKVConfig, speculative: bool = True,
                 proxy_query: bool = False, token_wise_recall: bool = False):
        self.cfg, self.fkv = cfg, fkv
        self.speculative = speculative
        self.proxy_query = proxy_query
        self.token_wise_recall = token_wise_recall
        self.executor = RecallExecutor(recall_fn=self._recall, values_fn=self._recall_values)

    def _overlap(self):
        return self.fkv.recall_overlap and self.speculative

    def _recall(self, pool, idx):
        if isinstance(pool, tuple):                   # quantized host tier
            # dequantization fused into the gather: the packed page and its
            # scales cross the link, the fp page never does
            return ops.recall_gather_quant(pool.pool, pool.scale, idx, bits=pool.bits,
                                           out_dtype=pool.out_dtype)
        return ops.recall_gather(pool, idx)

    def _recall_values(self, pool, idx):
        """V halves only (ShadowKV): the packed V half and its V scales under
        the quantized tier, the fp V half otherwise."""
        if isinstance(pool, tuple):
            return ops.recall_values_quant(pool.pool, pool.scale, idx, bits=pool.bits,
                                           out_dtype=pool.out_dtype)
        return ops.recall_values(pool, idx)

    def init_state(self, batch, max_len, dtype=torch.bfloat16, device="cuda"):
        return paging.init_kv_state(self.cfg, self.fkv, batch, max_len, dtype, device)

    def _n_sel(self, state):
        return state["sel_idx"].shape[2]

    def prefill(self, state, k, v, q_last):
        """k/v (B,T,kv,d); q_last (B,H,d): the prompt's last query, which makes
        the first speculative selection and recall."""
        B, T = k.shape[:2]
        state = paging.prefill_fill_pool(state, k, v, T)
        idx, _ = selection.select_pages(self.cfg, self.fkv, q_last, state["summ"],
                                        state["length"], self._n_sel(state), with_pooled=False)
        sk, sv = self._recall(paging.pool_view(state), idx)
        state["sel_k"] = sk.to(state["sel_k"].dtype)
        state["sel_v"] = sv.to(state["sel_v"].dtype)
        state["sel_idx"] = idx
        state["qprev"] = q_last.to(state["qprev"].dtype)
        return state

    def decode(self, state, q, k_new, v_new, length_host=None, q_proxy=None):
        """One decode step; ``length_host`` is an optional CPU copy of
        ``state["length"]``, read only by the centroid index's upkeep
        (``centroid_index.update_on_append``); ``q_proxy`` replaces q in the
        selection under ``proxy_query``."""
        cfg, fkv = self.cfg, self.fkv
        p = fkv.page_size
        cur_pos = state["length"]                  # position of the new token
        wait_staged(state)
        state = paging.append_token(state, k_new, v_new)
        state = self._post_append(state, None if length_host is None else length_host + 1)
        B = q.shape[0]

        if self.speculative:
            with annotate(SPAN_RECALL_CORRECTION):
                corr, sim = corrected_heads(cfg, fkv, q, state["qprev"])
            # one all() over the whole batch, as in the reference
            is_cold = torch.all(state["qprev"].float() == 0)
            corr = corr | is_cold
        else:
            corr = torch.ones((B, cfg.n_kv_heads), dtype=torch.bool, device=q.device)
            sim = torch.zeros((B, cfg.n_kv_heads), dtype=torch.float32, device=q.device)

        q_sel = q_proxy if self.proxy_query and q_proxy is not None else q
        with annotate(SPAN_RECALL_SELECT):
            new_idx, sel_info = self._select_indices(state, q_sel, corr)
        n_sel = new_idx.shape[2]
        reused = torch.zeros((B,), dtype=torch.int64, device=q.device)
        sel_pages = (new_idx >= 0).sum(dim=(1, 2))
        spec_hit = match_resident(new_idx, state["sel_idx"])[0].sum(dim=(1, 2))

        ready = None
        if self._overlap():
            pr = self.executor.step(paging.pool_view(state), new_idx, state["sel_idx"],
                                    state["sel_k"], state["sel_v"], corr)
            use_k, use_v, use_idx = pr.use_k, pr.use_v, pr.use_idx
            new_k, new_v = pr.staged_k, pr.staged_v
            sync_pages, async_pages = pr.topup_blocks, pr.staged_blocks
            reused, ready = pr.reused_blocks, pr.ready
        else:
            new_k, new_v = self.executor.recall(paging.pool_view(state), new_idx)
            new_k = new_k.to(state["sel_k"].dtype)
            new_v = new_v.to(state["sel_v"].dtype)
            if self.speculative:
                m = corr[:, :, None, None, None]
                use_k = torch.where(m, new_k, state["sel_k"])
                use_v = torch.where(m, new_v, state["sel_v"])
                use_idx = torch.where(corr[:, :, None], new_idx, state["sel_idx"])
            else:
                use_k, use_v, use_idx = new_k, new_v, new_idx
            sync_pages = corr.sum(dim=1) * n_sel
            async_pages = (~corr).sum(dim=1) * n_sel

        with annotate(SPAN_ATTN_COMPUTE):
            k_cat, v_cat, pos = _cat_regions(fkv, state, use_k, use_v, use_idx, p)
            o = _attend(cfg, q, k_cat, v_cat, pos, cur_pos, fkv=fkv)

        state.update(sel_k=new_k, sel_v=new_v, sel_idx=new_idx,
                     qprev=q.to(state["qprev"].dtype))
        if ready is not None:
            state["sel_ready"] = ready
        info = {
            "corrected": corr, "similarity": sim,
            "sync_pages": sync_pages, "async_pages": async_pages,
            "reused_pages": reused, "sel_pages": sel_pages,
            "spec_hit_pages": spec_hit, "churn_pages": sel_pages - spec_hit,
            "granularity": "token" if self.token_wise_recall else "page",
        }
        info.update(sel_info)
        return o, state, info

    # -- speculative-decoding rollback (models.model.serve_step_verify) -----
    def draft_probe(self, state):
        """What a verify row leaves that the rollback restores besides the
        length and the ring: the row's ``qprev`` and ``sel_idx`` (reference
        ``retrieval.py:413``). ``decode`` replaces both with new tensors, so
        a later row never overwrites a probe."""
        return (state["qprev"], state["sel_idx"])

    def draft_rewind(self, state, keep_len, probe):
        """Roll a drafted block back to ``keep_len`` committed tokens
        (reference ``retrieval.py:419``), in place. ``probe`` is
        ``draft_probe`` at each slot's last committed row. The selection
        buffers become one blocking recall of that row's ``sel_idx``: what
        the sequential path held, since pool pages below the committed
        length are written once and the staged buffer equals the fresh
        recall bit for bit. The recall first waits for the rejected rows'
        staged recall on the side stream, so the two never write the
        selection buffers in a race; it also serves as the next block's
        prefetch. The ring is restored by ``ring_restore``."""
        wait_staged(state)
        qprev, sel_idx = probe
        nk, nv = self.executor.recall(paging.pool_view(state), sel_idx)
        state.update(length=keep_len.clone(), qprev=qprev, sel_idx=sel_idx,
                     sel_k=nk.to(state["sel_k"].dtype), sel_v=nv.to(state["sel_v"].dtype))
        return state

    # -- subclass hooks (reference retrieval.py:399-411) -------------------
    def _post_append(self, state, length_host=None):
        """Retriever-owned index upkeep after the token append;
        ``length_host`` is a CPU copy of the post-append lengths, or None."""
        return state

    def _select_indices(self, state, q, corr):
        """-> (new_idx (B, kv, n_sel), extra info); ``corr`` lets a subclass
        send corrected heads to the exact scan."""
        new_idx, _ = selection.select_pages(self.cfg, self.fkv, q, state["summ"],
                                            state["length"], self._n_sel(state),
                                            with_pooled=False)
        return new_idx, {}


class CentroidRetriever(FreeKVRetriever):
    """Centroid-then-token selection (reference ``retrieval.py:440``): the
    two-level index of ``core/centroid_index`` picks uncorrected heads'
    pages from C cluster boxes and a bounded candidate set; corrected heads
    re-select with the exact scan, so mis-clustered heads are corrected,
    not lost. Otherwise FreeKV: speculative recall, correction, overlap."""

    def __init__(self, cfg, fkv):
        super().__init__(cfg, fkv, speculative=True)

    def init_state(self, batch, max_len, dtype=torch.bfloat16, device="cuda"):
        st = super().init_state(batch, max_len, dtype, device)
        st.update(centroid_index.init_index(
            batch, st["pool"].shape[1], self.fkv.centroid_count, self.cfg.n_kv_heads,
            self.cfg.d_head, st["summ"].dtype, st["summ"].device))
        return st

    def prefill(self, state, k, v, q_last):
        st = super().prefill(state, k, v, q_last)
        st.update(centroid_index.build(st["summ"], st["length"], self.fkv.centroid_count,
                                       self.fkv.page_size, st["cent"].dtype))
        return st

    def _post_append(self, state, length_host=None):
        return centroid_index.update_on_append(state, self.fkv, length_host)

    def _select_indices(self, state, q, corr):
        exact_idx, _ = selection.select_pages(self.cfg, self.fkv, q, state["summ"],
                                              state["length"], self._n_sel(state),
                                              with_pooled=False)
        cent_idx, cand_idx = centroid_index.centroid_select(self.cfg, self.fkv, q, state,
                                                            self._n_sel(state))
        new_idx = torch.where(corr[:, :, None], exact_idx, cent_idx)
        return new_idx, {"cand_pages": (cand_idx >= 0).sum(dim=(1, 2))}


class QuestRetriever(FreeKVRetriever):
    """Quest (reference ``retrieval.py:492-530``): no offload, so the pool
    stays in device memory whatever ``fkv.offload`` says; each query head
    picks its own top-k pages over its own scores, with no group pooling
    (``selection.select_pages(per_head=True)``, one launch),
    so a layer recalls G times the pages of a group-consistent method, on
    the critical path every step. The ids are ``jax.lax.top_k``'s,
    unselectable lanes included (the reference does not turn them into -1;
    ``_cat_regions`` masks their positions).

    The reference loops over the G heads of a group: G recalls and G
    attentions a layer. Here the G heads' pages are one ``recall_gather``
    launch (ids (B, kv, G * n_sel)) and one ``paged_attention`` launch over
    kv * G rows of one query each, whose sink and window are their KV
    head's: a layer's decode step is one select_pages, one recall_gather,
    one paged_attention and the page completion."""

    def __init__(self, cfg, fkv):
        super().__init__(cfg, fkv, speculative=False)

    def init_state(self, batch, max_len, dtype=torch.bfloat16, device="cuda"):
        return paging.init_kv_state(self.cfg, dataclasses.replace(self.fkv, offload="sim"),
                                    batch, max_len, dtype, device)

    def decode(self, state, q, k_new, v_new, length_host=None, q_proxy=None):
        cfg, fkv = self.cfg, self.fkv
        p = fkv.page_size
        B, H, d = q.shape
        kv, G = cfg.n_kv_heads, cfg.group_size
        dev = q.device
        cur_pos = state["length"]
        state = paging.append_token(state, k_new, v_new)
        n_sel = self._n_sel(state)
        with annotate(SPAN_RECALL_SELECT):
            idx, _ = selection.select_pages(cfg, fkv, q, state["summ"], state["length"], n_sel,
                                            with_pooled=False, per_head=True,
                                            keep_invalid=True)         # (B,kv,G,n_sel)
        sk, sv = self._recall(paging.pool_view(state), idx.reshape(B, kv, G * n_sel))
        rows = (B, kv * G, n_sel, p, d)
        with annotate(SPAN_ATTN_COMPUTE):
            k_cat, v_cat, pos = _cat_regions(fkv, state, sk.to(q.dtype).reshape(rows),
                                             sv.to(q.dtype).reshape(rows),
                                             idx.reshape(B, kv * G, n_sel), p, rep=G)
            o = _attend(cfg, q, k_cat, v_cat, pos, cur_pos, fkv=fkv)
        state["qprev"] = q.to(state["qprev"].dtype)
        info = {"corrected": torch.ones((B, kv), dtype=torch.bool, device=dev),
                "sync_pages": torch.full((B,), H * n_sel, dtype=torch.int64, device=dev),
                "async_pages": torch.zeros((B,), dtype=torch.int64, device=dev),
                "similarity": torch.zeros((B, kv), device=dev), "granularity": "page"}
        return o, state, info


def _no_recall_info(B, kv, dev):
    zeros = torch.zeros((B,), dtype=torch.int64, device=dev)
    return {"corrected": torch.zeros((B, kv), dtype=torch.bool, device=dev),
            "sync_pages": zeros, "async_pages": zeros,
            "similarity": torch.zeros((B, kv), device=dev), "granularity": "page"}


class StreamingRetriever(RingRollback):
    """Sink + sliding window only (StreamingLLM), reference
    ``retrieval.py:533-611``; also gemma2's ``ATTN_LOCAL`` layers, with
    ``window = cfg.sliding_window`` and no sink (``models.model``). No pool:
    the ring holds the last ``window`` tokens. Decode attends the sink and
    the ring through ``paged_attention``, which reads them as whole pages
    (``_attend``)."""

    def __init__(self, cfg, fkv, window=None, n_sink=None):
        self.cfg, self.fkv = cfg, fkv
        self.window = window or fkv.n_window
        self.n_sink = fkv.n_sink if n_sink is None else n_sink

    def init_state(self, batch, max_len, dtype=torch.bfloat16, device="cuda"):
        from repro_torch import resolve_device
        dev = resolve_device(device)
        kv, d = self.cfg.n_kv_heads, self.cfg.d_head

        def z(n):
            return torch.zeros((batch, n, kv, d), dtype=dtype, device=dev)

        return {"sink_k": z(self.n_sink), "sink_v": z(self.n_sink),
                "win_k": z(self.window), "win_v": z(self.window),
                "win_pos": torch.full((batch, self.window), -1, dtype=torch.int32, device=dev),
                "length": torch.zeros((batch,), dtype=torch.int32, device=dev)}

    def prefill(self, state, k, v, q_last):
        """The prompt's first ``n_sink`` tokens into the sink and its last
        ``window`` into the ring (token t at slot t % window), in place."""
        B, T = k.shape[:2]
        n_sink, n_win = state["sink_k"].shape[1], state["win_k"].shape[1]
        dt = state["win_k"].dtype
        s, nt = min(T, n_sink), min(T, n_win)
        for key, src in (("sink_k", k), ("sink_v", v)):
            state[key].zero_()
            state[key][:, :s] = src[:, :s].to(dt)
        slots = torch.arange(T - nt, T, device=k.device) % n_win
        for key, src in (("win_k", k), ("win_v", v)):
            state[key].zero_()
            state[key][:, slots] = src[:, T - nt:].to(dt)
        state["win_pos"].fill_(-1)
        state["win_pos"][:, slots] = torch.arange(T - nt, T, dtype=torch.int32,
                                                  device=k.device)[None].expand(B, nt)
        state["length"] = torch.full((B,), T, dtype=torch.int32, device=k.device)
        return state

    def decode(self, state, q, k_new, v_new, length_host=None, q_proxy=None):
        B, kv = q.shape[0], self.cfg.n_kv_heads
        cur_pos = state["length"]
        paging.ring_append(state, k_new, v_new)
        n_sink, n_win = state["sink_k"].shape[1], state["win_k"].shape[1]
        dev = q.device
        neg = torch.full((), -1, dtype=torch.int32, device=dev)
        pos_s = torch.arange(n_sink, dtype=torch.int32, device=dev)[None, None].expand(
            B, kv, n_sink)
        pos_s = torch.where(pos_s < state["length"][:, None, None], pos_s, neg)
        pos_w = state["win_pos"][:, None, :].expand(B, kv, n_win)
        pos_w = torch.where(pos_w >= n_sink, pos_w, neg)
        k_cat = torch.cat([state["sink_k"].transpose(1, 2), state["win_k"].transpose(1, 2)], 2)
        v_cat = torch.cat([state["sink_v"].transpose(1, 2), state["win_v"].transpose(1, 2)], 2)
        pos = torch.cat([pos_s, pos_w], dim=2)
        with annotate(SPAN_ATTN_COMPUTE):
            o = _attend(self.cfg, q, k_cat, v_cat, pos, cur_pos, fkv=self.fkv)
        return o, state, _no_recall_info(B, kv, dev)

    # -- speculative-decoding rollback (reference retrieval.py:605) --------
    def draft_probe(self, state):
        """Sink + ring only: nothing beyond the length and the ring."""
        return ()

    def draft_rewind(self, state, keep_len, probe):
        state["length"] = keep_len.clone()
        return state


class RaaSRetriever:
    """RaaS-like dynamic dropping (reference ``retrieval.py:661-767``): sink
    + window + ``n_keep`` kept pages a KV head, no pool. The prefill seeds
    the kept pages with the top pages under the prompt's last query; each
    decode step marks the kept pages whose group-mean attention mass beats
    1 / length as used now, and a completed page replaces the least
    recently used one (``argmin(last_used)``)."""

    def __init__(self, cfg, fkv):
        self.cfg, self.fkv = cfg, fkv
        self.stream = StreamingRetriever(cfg, fkv)

    def init_state(self, batch, max_len, dtype=torch.bfloat16, device="cuda"):
        cfg, fkv = self.cfg, self.fkv
        kv, d, p = cfg.n_kv_heads, cfg.d_head, fkv.page_size
        n_keep = max(1, (fkv.budget - fkv.n_sink - fkv.n_window) // p)
        st = self.stream.init_state(batch, max_len, dtype, device)
        dev = st["length"].device
        st.update(keep_k=torch.zeros((batch, kv, n_keep, p, d), dtype=dtype, device=dev),
                  keep_v=torch.zeros((batch, kv, n_keep, p, d), dtype=dtype, device=dev),
                  keep_idx=torch.full((batch, kv, n_keep), -1, dtype=torch.int32, device=dev),
                  last_used=torch.full((batch, kv, n_keep), -(10 ** 9), dtype=torch.int32,
                                       device=dev))
        return st

    def prefill(self, state, k, v, q_last):
        cfg, fkv = self.cfg, self.fkv
        p = fkv.page_size
        B, T, kv, d = k.shape
        st = self.stream.prefill(state, k, v, q_last)
        # the prompt's whole pages as a pool on the card with their min/max
        # summaries, in one fill_pages launch (the reference's summaries of
        # K, :690-691, and nhd_pages_to_hnd, :700), then the top pages under
        # the last query as the reference's top_k returns them, gathered
        n_pages = T // p
        summ = torch.empty((B, n_pages, kv, 2, d), dtype=k.dtype, device=k.device)
        pool = torch.empty((B, n_pages, kv, 2, p, d), dtype=k.dtype, device=k.device)
        ops.fill_pages(k, v, summ, pool)
        length = torch.full((B,), T, dtype=torch.int32, device=k.device)
        idx, _ = selection.select_pages(cfg, fkv, q_last, summ, length,
                                        st["keep_idx"].shape[2], with_pooled=False,
                                        keep_invalid=True)
        kk, vv = ops.recall_gather(pool, idx)
        st["keep_k"].copy_(kk)
        st["keep_v"].copy_(vv)
        st["keep_idx"].copy_(idx)
        st["last_used"].fill_(T)
        return st

    def decode(self, state, q, k_new, v_new, length_host=None, q_proxy=None):
        cfg, fkv = self.cfg, self.fkv
        p = fkv.page_size
        B, H, d = q.shape
        kv, G = cfg.n_kv_heads, cfg.group_size
        dev = q.device
        cur_pos = state["length"]
        paging.ring_append(state, k_new, v_new)
        length = state["length"]
        keep_idx, last_used = state["keep_idx"], state["last_used"]
        with annotate(SPAN_ATTN_COMPUTE):
            k_cat, v_cat, pos = _cat_regions(fkv, state, state["keep_k"], state["keep_v"],
                                             keep_idx, p)
            o = _attend(cfg, q, k_cat, v_cat, pos, cur_pos, fkv=fkv)
        # each kept page's attention mass, averaged over the group, from an
        # explicit softmax over every position (no softcap, as the reference)
        n_keep = keep_idx.shape[2]
        s = torch.einsum("bkgd,bkld->bkgl", q.reshape(B, kv, G, d), k_cat).float() * _scale(cfg)
        s = torch.where((pos >= 0)[:, :, None, :], s, torch.full((), NEG_INF, device=dev))
        w = torch.softmax(s, dim=-1)
        off = k_cat.shape[2] - n_keep * p
        wp = w[..., off:].reshape(B, kv, G, n_keep, p).sum(-1).mean(2)
        significant = wp > (1.0 / torch.clamp(length, min=1))[:, None, None]
        last_used = torch.where(significant & (keep_idx >= 0), length[:, None, None], last_used)
        # a completed page evicts the least recently used kept page
        done = (length % p) == 0
        page = torch.div(length, p, rounding_mode="floor") - 1
        n_win = state["win_k"].shape[1]
        slot = ((page[:, None] * p + torch.arange(p, device=dev)) % n_win).long()
        bI = torch.arange(B, device=dev)[:, None]
        kI = torch.arange(kv, device=dev)[None, :]
        evict = torch.argmin(last_used, dim=2)                     # (B,kv)
        m4 = done[:, None, None, None]
        for key, ring in (("keep_k", "win_k"), ("keep_v", "win_v")):
            newp = state[ring][bI, slot].transpose(1, 2).to(state[key].dtype)   # (B,kv,p,d)
            state[key][bI, kI, evict] = torch.where(m4, newp, state[key][bI, kI, evict])
        m2 = done[:, None]
        keep_idx[bI, kI, evict] = torch.where(m2, page[:, None], keep_idx[bI, kI, evict])
        last_used[bI, kI, evict] = torch.where(m2, length[:, None], last_used[bI, kI, evict])
        state["last_used"] = last_used
        return o, state, _no_recall_info(B, kv, dev)


def low_rank_keys(k, rank):
    """ShadowKV's key factors: k (B, T, kv, d) -> (u (B, kv, T, r') scaled
    by the singular values, w (B, kv, r', d)), r' = min(rank, T, d), with
    u @ w the best rank-r' approximation of each head's keys in float32
    (the reference's ``jnp.linalg.svd``, ``retrieval.py:792``).

    On the card the SVD of the tall (T, d) matrices goes to cuSOLVER's
    batched driver for tall, thin matrices (``gesvda``): at 4 x 8 heads of
    8192 x 128 keys it takes ~2 ms a layer where the default driver, or a
    thin QR and the SVD of R, takes ~120 ms (``chip_smoke.py``
    ``time_low_rank_keys``). Singular vectors are defined only up to sign,
    so compare ``u @ w``, never ``u`` or ``w``."""
    kf = k.transpose(1, 2).float()                                 # (B, kv, T, d)
    tall = card_branch(kf) and kf.shape[-2] >= kf.shape[-1]
    u, s, vt = torch.linalg.svd(kf, full_matrices=False, driver="gesvda" if tall else None)
    r = min(rank, s.shape[-1])
    return u[..., :r] * s[..., None, :r], vt[..., :r, :]


class ShadowKVRetriever(FreeKVRetriever):
    """ShadowKV-like (reference ``retrieval.py:770``): rank-r key factors
    stay on the device and the selected pages' keys are reconstructed from
    them; only V halves are recalled from the pool, through
    ``RecallExecutor.step_values`` (delta against the previous buffer) or a
    blocking V-only recall. Selection is fresh every step, no correction.

    Two reference behaviours are kept on purpose: only the prefill writes
    ``k_u``, so a page completed during decode reconstructs to zero keys if
    it is selected; and ``rank = min(svd_rank, d_head)``, so at d_head 128
    the factors are full-rank (``k_u`` as large as the keys themselves)."""

    def __init__(self, cfg, fkv):
        super().__init__(cfg, fkv, speculative=False)
        self.rank = min(fkv.svd_rank, cfg.d_head)

    def init_state(self, batch, max_len, dtype=torch.bfloat16, device="cuda"):
        st = super().init_state(batch, max_len, dtype, device)
        cfg, dev = self.cfg, st["summ"].device
        n_tok = st["pool"].shape[1] * self.fkv.page_size
        st["k_u"] = torch.zeros((batch, cfg.n_kv_heads, n_tok, self.rank), dtype=dtype,
                                device=dev)
        st["k_w"] = torch.zeros((batch, cfg.n_kv_heads, self.rank, cfg.d_head), dtype=dtype,
                                device=dev)
        return st

    def prefill(self, state, k, v, q_last):
        st = super().prefill(state, k, v, q_last)
        u, w = low_rank_keys(k, self.rank)
        # in place, zero-padded to ``rank`` when the prompt is shorter: the
        # state may be a slot's rows (``SlotPool.claim``)
        st["k_u"][:, :, :u.shape[2], :u.shape[3]] = u.to(st["k_u"].dtype)
        st["k_w"][:, :, :w.shape[2]] = w.to(st["k_w"].dtype)
        return st

    def decode(self, state, q, k_new, v_new, length_host=None, q_proxy=None):
        cfg, fkv = self.cfg, self.fkv
        p = fkv.page_size
        B = q.shape[0]
        kv = cfg.n_kv_heads
        dev = q.device
        cur_pos = state["length"]
        state = paging.append_token(state, k_new, v_new)
        n_sel = self._n_sel(state)
        with annotate(SPAN_RECALL_SELECT):
            idx, _ = selection.select_pages(cfg, fkv, q, state["summ"], state["length"], n_sel,
                                            with_pooled=False)
        sel_pages = (idx >= 0).sum(dim=(1, 2))
        spec_hit = match_resident(idx, state["sel_idx"])[0].sum(dim=(1, 2))
        # keys: the selected pages reconstructed from the low-rank factors
        safe = idx.clamp(0, state["pool"].shape[1] - 1).long()
        tok = safe[..., None] * p + torch.arange(p, device=dev)
        bI = torch.arange(B, device=dev)[:, None, None, None]
        kI = torch.arange(kv, device=dev)[None, :, None, None]
        u_sel = state["k_u"][bI, kI, tok]                          # (B,kv,n_sel,p,r)
        k_rec = torch.einsum("bkspr,bkrd->bkspd", u_sel.float(), state["k_w"].float())
        k_rec = torch.where((idx >= 0)[..., None, None], k_rec, 0.0).to(q.dtype)
        # values: V halves only, reusing pages resident in the last buffer
        pool = paging.pool_view(state)
        if fkv.recall_overlap:
            pr = self.executor.step_values(pool, idx, state["sel_idx"], state["sel_v"])
            v_sel = pr.staged_v.to(q.dtype)
            sync_pages = pr.topup_blocks // 2                       # V-only
            reused = pr.reused_blocks // 2
            state["sel_v"] = pr.staged_v
        else:
            v_sel = self._recall_values(pool, idx).to(q.dtype)
            sync_pages = sel_pages // 2                             # V-only
            reused = torch.zeros((B,), dtype=torch.int64, device=dev)
        with annotate(SPAN_ATTN_COMPUTE):
            k_cat, v_cat, pos = _cat_regions(fkv, state, k_rec, v_sel, idx, p)
            o = _attend(cfg, q, k_cat, v_cat, pos, cur_pos, fkv=fkv)
        state.update(sel_idx=idx, qprev=q.to(state["qprev"].dtype))
        zeros = torch.zeros((B,), dtype=torch.int64, device=dev)
        info = {"corrected": torch.ones((B, kv), dtype=torch.bool, device=dev),
                "similarity": torch.zeros((B, kv), dtype=torch.float32, device=dev),
                "sync_pages": sync_pages, "async_pages": zeros, "reused_pages": reused,
                "sel_pages": sel_pages, "spec_hit_pages": spec_hit,
                "churn_pages": sel_pages - spec_hit, "granularity": "page"}
        return o, state, info


class FullRetriever:
    """Exact dense KV cache — the accuracy oracle. It keeps the reference's
    plain attention (``retrieval.py:653``): it is not on the main path."""

    def __init__(self, cfg, fkv):
        self.cfg, self.fkv = cfg, fkv

    def init_state(self, batch, max_len, dtype=torch.bfloat16, device="cuda"):
        from repro_torch import resolve_device
        dev = resolve_device(device)
        cfg = self.cfg
        shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev),
                "length": torch.zeros((batch,), dtype=torch.int32, device=dev)}

    def prefill(self, state, k, v, q_last):
        B, T = k.shape[:2]
        state["k"][:, :T] = k.to(state["k"].dtype)
        state["v"][:, :T] = v.to(state["v"].dtype)
        state["length"] = torch.full((B,), T, dtype=torch.int32, device=k.device)
        return state

    def decode(self, state, q, k_new, v_new, length_host=None, q_proxy=None):
        cfg = self.cfg
        B = q.shape[0]
        kv = cfg.n_kv_heads
        cur_pos = state["length"]
        bidx = torch.arange(B, device=q.device)
        state["k"][bidx, cur_pos.long()] = k_new.to(state["k"].dtype)
        state["v"][bidx, cur_pos.long()] = v_new.to(state["v"].dtype)
        state["length"] = cur_pos + 1
        L = state["k"].shape[1]
        k_cat = state["k"].transpose(1, 2)
        v_cat = state["v"].transpose(1, 2)
        pos = torch.arange(L, dtype=torch.int32, device=q.device)[None, None, :].expand(B, kv, L)
        pos = torch.where(pos < state["length"][:, None, None], pos,
                          torch.full((), -1, dtype=torch.int32, device=q.device))
        with annotate(SPAN_ATTN_COMPUTE):
            o = _attend(cfg, q, k_cat, v_cat, pos, cur_pos)
        zeros = torch.zeros((B,), dtype=torch.int64, device=q.device)
        info = {"corrected": torch.zeros((B, kv), dtype=torch.bool, device=q.device),
                "similarity": torch.zeros((B, kv), device=q.device),
                "sync_pages": zeros, "async_pages": zeros, "granularity": "page"}
        return o, state, info


METHODS = ("freekv", "arkvale", "infinigen", "quest", "shadowkv", "raas", "streaming",
           "full", "centroid")


# the methods whose decode takes the page-sharded fused step under a mesh
# with ``fkv.sharded_retrieval`` (the reference's ``FreeKVRetriever``, whose
# ``decode`` dispatches on ``_use_sharded``; centroid excludes it)
FUSED_METHODS = ("freekv", "arkvale", "infinigen")
# layer-steps under ``fkv.sharded_retrieval`` and a mesh that took the fused
# step and that fell back to the plain path (a caller can require the first)
SHARDED_PATHS = {"fused": 0, "fallback": 0}


def use_sharded(cfg: ArchConfig, fkv: FreeKVConfig, model_parallel: int, max_len: int) -> bool:
    """Whether a global attention layer's decode takes the page-sharded
    fused step (reference ``retrieval.py:265-277``): ``sharded_retrieval``
    on, an unquantized pool (the quantized tier falls back to the plain
    path), and the selection slots and the pool's pages dividing the model
    axis."""
    if not (fkv.sharded_retrieval and fkv.method in FUSED_METHODS):
        return False
    if fkv.kv_quant != "none":
        return False
    _, n_pages, _, _, n_sel = paging.state_dims(cfg, fkv, max_len)
    return n_sel % model_parallel == 0 and n_pages % model_parallel == 0


def make_retriever(cfg: ArchConfig, fkv: FreeKVConfig, mesh=None):
    """The retriever of ``fkv.method``, any of METHODS (reference
    ``retrieval.py:861-890``). With a ``mesh`` (serving TP,
    ``launch/mesh.make_tp_mesh``) it is the plain retriever of the local
    KV-head group, run per shard by ``TPGroupShardedRetriever``, which
    raises where the mesh does not divide both head counts."""
    if mesh is not None:
        return TPGroupShardedRetriever(cfg, mesh, lambda c: make_retriever(c, fkv))
    m = fkv.method
    if m == "freekv":
        return FreeKVRetriever(cfg, fkv, speculative=True)
    if m == "arkvale":
        return FreeKVRetriever(cfg, fkv, speculative=False)
    if m == "full":
        return FullRetriever(cfg, fkv)
    if m == "shadowkv":
        return ShadowKVRetriever(cfg, fkv)
    if m == "centroid":
        return CentroidRetriever(cfg, fkv)
    if m == "infinigen":
        return FreeKVRetriever(cfg, fkv, speculative=False, proxy_query=True,
                               token_wise_recall=True)
    if m == "quest":
        return QuestRetriever(cfg, fkv)
    if m == "raas":
        return RaaSRetriever(cfg, fkv)
    if m == "streaming":
        return StreamingRetriever(cfg, fkv, window=fkv.budget - fkv.n_sink)
    raise ValueError(f"unknown method {m!r}")
