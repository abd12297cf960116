"""Retrievers behind one API (reference ``repro/core/retrieval.py``):

    r = make_retriever(cfg, fkv)
    state = r.init_state(batch, max_len, dtype, device)
    state = r.prefill(state, k, v, q_last)       # bulk-insert a prompt
    o, state, info = r.decode(state, q, k_new, v_new)

Shapes: k/v (B,T,kv,dh) post-RoPE; q (B,H,dh) one decode token. ``decode``
updates ``state`` in place and returns it.

Ported methods: ``freekv`` (speculative retrieval + correction, the paper),
``arkvale`` (fresh selection + blocking recall every step) and ``full`` (the
exact oracle). The others raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, FreeKVConfig
from repro_torch.core import paging, selection
from repro_torch.core.correction import corrected_heads
from repro_torch.core.recall_pipeline import (RecallExecutor, match_resident,
                                              wait_staged)
from repro_torch.kernels import ops
from repro_torch.models.layers import softcap

NEG_INF = -1e30


def _scale(cfg):
    return cfg.attn_scale if cfg.attn_scale is not None else 1.0 / (cfg.d_head ** 0.5)


def _attend(cfg, q, k_cat, v_cat, pos_cat, cur_pos, window=None, fkv=None):
    """q (B,H,d); k/v_cat (B,kv,L,d); pos_cat (B,kv,L) -> (B,H,d).

    With ``fkv`` given and L a whole number of pages this is the
    ``paged_attention`` kernel (its plain version on the CPU); without
    ``fkv`` (the full-cache oracle) it is the reference's plain einsum."""
    B, H, d = q.shape
    kv, L = k_cat.shape[1], k_cat.shape[2]
    G = H // kv
    if window is None and fkv is not None and L % fkv.page_size == 0:
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
    if window is not None:
        ok = ok & (pos_cat > (cur_pos[:, None, None] - window))
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


def _cat_regions(fkv, state, sel_k, sel_v, sel_idx, p):
    """Sink + window + selected pages per KV head, with the three-region
    position partition applied through pos = -1 masking."""
    B, n_sink, kv, d = state["sink_k"].shape
    n_win = state["win_k"].shape[1]
    length = state["length"]
    dev = length.device
    wfloor = _window_floor(fkv, length)[:, None, None]
    neg = torch.full((), -1, dtype=torch.int32, device=dev)
    ks = state["sink_k"].transpose(1, 2)                           # (B,kv,S,d)
    vs = state["sink_v"].transpose(1, 2)
    pos_s = torch.arange(n_sink, dtype=torch.int32, device=dev)[None, None, :].expand(B, kv, n_sink)
    pos_s = torch.where(pos_s < length[:, None, None], pos_s, neg)
    kw = state["win_k"].transpose(1, 2)
    vw = state["win_v"].transpose(1, 2)
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


class FreeKVRetriever:
    """FreeKV (speculative=True) and, by flag, the ArkVale-style baseline
    (speculative=False: fresh selection, blocking recall every step)."""

    def __init__(self, cfg: ArchConfig, fkv: FreeKVConfig, speculative: bool = True):
        self.cfg, self.fkv = cfg, fkv
        self.speculative = speculative
        self.executor = RecallExecutor(recall_fn=self._recall)

    def _overlap(self):
        return self.fkv.recall_overlap and self.speculative

    def _recall(self, pool, idx):
        if isinstance(pool, tuple):                   # quantized host tier
            # dequantization fused into the gather: the packed page and its
            # scales cross the link, the fp page never does
            return ops.recall_gather_quant(pool.pool, pool.scale, idx, bits=pool.bits,
                                           out_dtype=pool.out_dtype)
        return ops.recall_gather(pool, idx)

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
                                        state["length"], self._n_sel(state))
        sk, sv = self._recall(paging.pool_view(state), idx)
        state["sel_k"] = sk.to(state["sel_k"].dtype)
        state["sel_v"] = sv.to(state["sel_v"].dtype)
        state["sel_idx"] = idx
        state["qprev"] = q_last.to(state["qprev"].dtype)
        return state

    def decode(self, state, q, k_new, v_new, length_host=None):
        """One decode step; ``length_host`` is an optional CPU copy of
        ``state["length"]`` (see ``paging.append_token``)."""
        cfg, fkv = self.cfg, self.fkv
        p = fkv.page_size
        cur_pos = state["length"]                  # position of the new token
        wait_staged(state)
        state = paging.append_token(state, k_new, v_new, length_host)
        B = q.shape[0]

        if self.speculative:
            corr, sim = corrected_heads(cfg, fkv, q, state["qprev"])
            # one all() over the whole batch, as in the reference
            is_cold = torch.all(state["qprev"].float() == 0)
            corr = corr | is_cold
        else:
            corr = torch.ones((B, cfg.n_kv_heads), dtype=torch.bool, device=q.device)
            sim = torch.zeros((B, cfg.n_kv_heads), dtype=torch.float32, device=q.device)

        new_idx, _ = selection.select_pages(cfg, fkv, q, state["summ"], state["length"],
                                            self._n_sel(state))
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
        }
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

    def decode(self, state, q, k_new, v_new, length_host=None):
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
        o = _attend(cfg, q, k_cat, v_cat, pos, cur_pos)
        zeros = torch.zeros((B,), dtype=torch.int64, device=q.device)
        info = {"corrected": torch.zeros((B, kv), dtype=torch.bool, device=q.device),
                "similarity": torch.zeros((B, kv), device=q.device),
                "sync_pages": zeros, "async_pages": zeros}
        return o, state, info


def make_retriever(cfg: ArchConfig, fkv: FreeKVConfig):
    m = fkv.method
    if m == "freekv":
        return FreeKVRetriever(cfg, fkv, speculative=True)
    if m == "arkvale":
        return FreeKVRetriever(cfg, fkv, speculative=False)
    if m == "full":
        return FullRetriever(cfg, fkv)
    if m in ("infinigen", "quest", "shadowkv", "raas", "streaming", "centroid"):
        raise NotImplementedError(
            f"method {m!r} is not ported yet (ROADMAP queue 1, item 9)")
    raise ValueError(f"unknown method {m!r}")
