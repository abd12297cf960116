"""Plain PyTorch versions of the hand-written CUDA kernels.

Each function computes exactly what its counterpart in the reference's
``repro/kernels/ref.py`` computes. ``kernels/ops.py`` dispatches CPU tensors
here; the tests hold these against the JAX oracles and ``chip_smoke.py``
holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.quant.quantizers import (dequant_recall_pages, dequant_recall_values,
                                          quantize_block)

NEG_INF = -1e30


def page_summary_ref(k, page_size):
    """k (B, T, kv, d), T a whole number of pages -> (B, T/p, kv, 2, d): the
    min and max of each page's keys, in k's dtype (reference
    ``kernels/ref.py:10``)."""
    B, T, kv, d = k.shape
    kp = k.reshape(B, T // page_size, page_size, kv, d)
    return torch.stack([kp.amin(dim=2), kp.amax(dim=2)], dim=3)


def _as_pool(hnd, pool, scale):
    """HND blocks (..., 2, p, d) as ``pool`` stores them -> (payload, float32
    scales or None): cast to the pool's dtype, or ``quantize_block`` where
    the pool has scales (int4 where its rows are d / 2 bytes wide)."""
    if scale is None:
        return hnd.to(pool.dtype), None
    d = hnd.shape[-1]
    return quantize_block(hnd, 8 if pool.shape[-1] == d else 4, d // scale.shape[-1])


def fill_pages_ref(k, v, summ, pool, scale=None):
    """The prefill's pool fill, in place (reference ``core/paging.py:178-203``):
    the n = pool.shape[1] first whole pages of k, v (B, T, kv, d) -> summ
    (B, n, kv, 2, d) their keys' min and max, in summ's dtype, and pool (B,
    n, kv, 2, p, dp) their HND blocks, in the pool's dtype or quantized with
    float32 scale (B, n, kv, 2, n_g)."""
    B, n, kv, _, p, _ = pool.shape
    d = k.shape[-1]
    kp = k[:, :n * p].reshape(B, n, p, kv, d)
    vp = v[:, :n * p].reshape(B, n, p, kv, d)
    summ.copy_(torch.stack([kp.amin(dim=2), kp.amax(dim=2)], dim=3))
    blk, sc = _as_pool(torch.stack([kp.transpose(2, 3), vp.transpose(2, 3)], dim=3),
                       pool, scale)
    pool.copy_(blk)
    if scale is not None:
        scale.copy_(sc)


def complete_page_ref(win_k, win_v, length, summ, pool, scale=None, page_lo=0):
    """The decode's page completion, in place, masked as the reference's
    (``core/paging.py:228-254``): row b whose post-append length (length
    (B,) int32) is a whole number of pages, with page = length // p - 1 <
    n_pages, gathers that page's p tokens from its rings win_k / win_v (B,
    n_win, kv, d) at slots (page * p + t) % n_win and writes their summary to
    summ[b, page], their HND block to pool[b, page] (and its scales to
    scale[b, page]); every other row writes its own old bytes back at page
    0, a ``where`` over every row, so it changes nothing. ``page_lo``: the
    outputs hold pages page_lo .. page_lo + n_pages - 1 (a page shard's
    range, reference ``sharded_retrieval.py:271-290``); a row writes only a
    page of that range."""
    B, n_win = win_k.shape[:2]
    n_pages, p = pool.shape[1], pool.shape[4]
    page = torch.div(length, p, rounding_mode="floor") - 1
    rel = page - page_lo
    done = (length % p == 0) & (page >= 0) & (rel >= 0) & (rel < n_pages)
    src = torch.where(done, page, 0).long()
    tgt = torch.where(done, rel, 0).long()
    bI = torch.arange(B, device=length.device)
    slot = (src[:, None] * p + torch.arange(p, device=length.device)) % n_win
    pk = win_k[bI[:, None], slot]                                  # (B, p, kv, d)
    pv = win_v[bI[:, None], slot]
    blk, sc = _as_pool(torch.stack([pk.transpose(1, 2), pv.transpose(1, 2)], dim=2),
                       pool, scale)                                # (B, kv, 2, p, dp)
    m = done[:, None, None, None]
    summ[bI, tgt] = torch.where(m, torch.stack([pk.amin(dim=1), pk.amax(dim=1)], dim=2)
                                .to(summ.dtype), summ[bI, tgt])
    pool[bI, tgt] = torch.where(m[..., None], blk, pool[bI, tgt])
    if scale is not None:
        scale[bI, tgt] = torch.where(m, sc, scale[bI, tgt])


def page_scores_ref(q, summ, scale):
    """q (B, kv, G, d); summ (B, n_pages, kv, 2, d) -> (B, kv, G, n_pages) f32.

    Quest scoring: ``sum_d max(q*lo, q*hi)``, the coordinate-wise max taken
    BEFORE the sum (reference ``kernels/ref.py:17``)."""
    lo = summ[..., 0, :].float().permute(0, 2, 1, 3)[:, :, None]   # (B,kv,1,n,d)
    hi = summ[..., 1, :].float().permute(0, 2, 1, 3)[:, :, None]
    qf = q.float()[:, :, :, None, :]                               # (B,kv,G,1,d)
    return torch.maximum(qf * lo, qf * hi).sum(-1) * scale


def centroid_scores_ref(q, cent, count, scale):
    """q (B, kv, G, d); cent (B, C, kv, 2, d); count (B, C, kv) int32 ->
    (B, kv, G, C) f32: the Quest bound against the cluster boxes, exactly
    -1e30 for empty clusters (reference ``kernels/ref.py:31``)."""
    s = page_scores_ref(q, cent, scale)
    ok = count.permute(0, 2, 1)[:, :, None, :] > 0
    return torch.where(ok, s, torch.full((), NEG_INF, dtype=s.dtype, device=s.device))


def selectable_mask_ref(n_pages, length, page_size, n_sink, n_window, page_lo=0):
    """(B, n_pages) bool: fully offloaded pages outside the sink and the
    local window (those tokens are resident on the device already);
    reference ``core/selection.py:37``. ``page_lo``: the n_pages are pages
    page_lo .. page_lo + n_pages - 1 (a page shard's range, reference
    ``sharded_retrieval.py:296-299``)."""
    p = page_size
    pages = torch.arange(page_lo, page_lo + n_pages, device=length.device)
    first = n_sink // p
    n_done = torch.div(length, p, rounding_mode="floor")
    last = torch.clamp(torch.div(length - n_window, p, rounding_mode="floor"), min=first)
    return (pages[None, :] >= first) & (pages[None, :] < torch.minimum(n_done, last)[:, None])


def group_pool_ref(scores, ok, mode):
    """(B, kv, G, n) per-q-head scores, ok (B, kv, n) bool -> (B, kv, n)
    group-consistent scores (reference ``core/selection.py:49``
    ``group_consistent_scores``): mean_softmax (MeanS), max_softmax,
    mean_qk or max_qk."""
    neg = torch.full((), NEG_INF, dtype=scores.dtype, device=scores.device)
    s = torch.where(ok[:, :, None, :], scores, neg)
    if mode.endswith("softmax"):
        s = torch.softmax(s, dim=-1)
        # XLA and the TPU flush subnormal results to zero; flush them here
        # too, so pages whose probability underflows tie at exactly 0.0 and
        # the top-k order among them is the reference's (lower id first)
        s = torch.where(s < torch.finfo(s.dtype).tiny, torch.zeros((), dtype=s.dtype,
                                                                   device=s.device), s)
    pooled = s.mean(dim=2) if mode.startswith("mean") else s.amax(dim=2)
    return torch.where(ok, pooled, neg)


def top_k_lower_index_first(x, k):
    """``jax.lax.top_k`` semantics: the k largest along the last axis, equal
    values in increasing index order (a stable descending sort; ``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_ids(vals, ids, n_sel, keep_invalid=False):
    """Top-k positions of vals (..., n) -> their ids (..., n_sel) int32:
    ``ids`` None for the positions themselves, else gathered from ``ids``
    (B, kv, n); -1 where the value is <= -5e29 (unless ``keep_invalid``:
    then the ids ``jax.lax.top_k`` returns there) and -1-padded past n."""
    k = min(n_sel, vals.shape[-1])
    top_s, top_i = top_k_lower_index_first(vals, k)
    if ids is not None:
        top_i = torch.gather(ids, 2, top_i)
    idx = (top_i if keep_invalid else torch.where(top_s > NEG_INF / 2, top_i, -1)).to(torch.int32)
    if k < n_sel:
        pad = torch.full(idx.shape[:-1] + (n_sel - k,), -1, dtype=torch.int32,
                         device=idx.device)
        idx = torch.cat([idx, pad], dim=-1)
    return idx


def select_pages_ref(q, summ, length, n_sel, scale, page_size, n_sink, n_window, mode,
                     cand=None, per_head=False, keep_invalid=False):
    """Quest scores -> selectable mask -> group pooling -> top-k page ids
    (reference ``core/selection.py:74-100``; ``select_top_p`` and
    ``q_pool`` are plain tensor ops around it in ``core/selection.py``). q
    (B, kv, G, d); summ (B, N, kv, 2, d); length (B,) int32 -> (idx (B, kv,
    n_sel) int32, -1 for invalid, pooled (B, kv, N) f32).

    ``per_head``: Quest's selection (reference ``core/retrieval.py:508-513``),
    no pooling, each query head's own top-k over its masked scores -> (idx
    (B, kv, G, n_sel), scores (B, kv, G, N)). ``keep_invalid``: lanes at
    -1e30 keep the ids ``jax.lax.top_k`` returns (lower ids first), as
    Quest's and RaaS's raw top-k do.

    With ``cand`` (B, kv, m) int32 page ids, -1 invalid: stage 2 of the
    reference's ``centroid_select`` (``core/centroid_index.py:289-330``):
    only the candidates' summaries are scored, the mask is ``cand >= 0``,
    ties break by candidate position, the ids are ``cand[top_i]`` and
    pooled is (B, kv, m)."""
    N = summ.shape[1]
    if per_head:
        scores = page_scores_ref(q, summ, scale)                   # (B,kv,G,N)
        ok = selectable_mask_ref(N, length, page_size, n_sink, n_window)[:, None, None, :]
        scores = torch.where(ok, scores, torch.full((), NEG_INF, device=scores.device))
        return top_ids(scores, None, n_sel, keep_invalid), scores
    if cand is None:
        scores = page_scores_ref(q, summ, scale)                   # (B,kv,G,N)
        ok = selectable_mask_ref(N, length, page_size, n_sink, n_window)
        ok = ok[:, None, :].expand(-1, q.shape[1], -1)
    else:
        # each head's own candidates on the page axis: (B, m, kv, 2, d)
        B, kv = cand.shape[:2]
        safe = cand.clamp(0, N - 1).long()
        bI = torch.arange(B, device=cand.device)[:, None, None]
        kI = torch.arange(kv, device=cand.device)[None, :, None]
        summ_c = summ[bI, safe, kI].permute(0, 2, 1, 3, 4).contiguous()
        scores = page_scores_ref(q, summ_c, scale)                 # (B,kv,G,m)
        ok = cand >= 0
    pooled = group_pool_ref(scores, ok, mode)
    return top_ids(pooled, cand, n_sel, keep_invalid), pooled


def select_pages_shard_ref(q, summ, length, n_sel, scale, page_size, n_sink, n_window,
                           mode, page_lo):
    """One page shard's selection in the fused decode step (reference
    ``sharded_retrieval.py:292-306``): summ (B, n_loc, kv, 2, d) holds pages
    page_lo .. page_lo + n_loc - 1; the mask and the ids are global, the
    pooling's softmax runs over the shard's pages -> (idx (B, kv, n_sel)
    int32 global ids, -1 for invalid, top (B, kv, n_sel) float32 their
    pooled values, -1e30 past the valid lanes)."""
    N = summ.shape[1]
    scores = page_scores_ref(q, summ, scale)                       # (B,kv,G,N)
    ok = selectable_mask_ref(N, length, page_size, n_sink, n_window, page_lo)
    pooled = group_pool_ref(scores, ok[:, None, :].expand(-1, q.shape[1], -1), mode)
    k = min(n_sel, N)
    top_s, top_i = top_k_lower_index_first(pooled, k)
    idx = torch.where(top_s > NEG_INF / 2, top_i + page_lo, -1).to(torch.int32)
    if k < n_sel:
        pad = idx.shape[:-1] + (n_sel - k,)
        idx = torch.cat([idx, torch.full(pad, -1, dtype=torch.int32, device=idx.device)], -1)
        top_s = torch.cat([top_s, torch.full(pad, NEG_INF, device=idx.device)], -1)
    return idx, top_s.float()


def centroid_candidates_ref(q, cent, count, cent_assign, length, m, scale, page_size,
                            n_sink, n_window):
    """Stage 1 of centroid selection (reference ``core/centroid_index.py:254-287``
    ``cluster_scores`` + ``candidate_pages``): q (B, kv, G, d) against the
    cluster boxes cent (B, C, kv, 2, d), empty clusters (count (B, C, kv)
    == 0) at -1e30, the max over the G rows; each selectable page with a
    cluster (cent_assign (B, N, kv) >= 0) inherits its cluster's score; the
    top m, ties in increasing page id -> (B, kv, m) int32, -1-padded."""
    cs = centroid_scores_ref(q, cent, count, scale).amax(dim=2)   # (B, kv, C)
    a = cent_assign.permute(0, 2, 1)                               # (B, kv, N)
    inh = torch.gather(cs, -1, torch.where(a >= 0, a, 0).long())
    valid = selectable_mask_ref(cent_assign.shape[1], length, page_size, n_sink, n_window)
    ok = (a >= 0) & valid[:, None, :]
    inh = torch.where(ok, inh, torch.full((), NEG_INF, device=inh.device))
    return top_ids(inh, None, m)


def paged_attention_ref(q, k_pages, v_pages, page_pos, cur_pos, scale,
                        softcap=None):
    """Decode attention over per-KV-head page sets (reference
    ``kernels/ref.py:40``).

    q (B, kv, G, d); k/v_pages (B, kv, N, p, d); page_pos (B, kv, N, p) int32
    with -1 masked; cur_pos (B,) int32 -> (B, kv, G, d) in q's dtype, fp32
    accumulation."""
    B, kv, N, p, d = k_pages.shape
    k = k_pages.reshape(B, kv, N * p, d).float()
    v = v_pages.reshape(B, kv, N * p, d).float()
    pos = page_pos.reshape(B, kv, N * p)
    s = torch.einsum("bkgd,bkld->bkgl", q.float(), k) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    ok = (pos >= 0) & (pos <= cur_pos[:, None, None])
    s = torch.where(ok[:, :, None, :], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgl,bkld->bkgd", w, v).to(q.dtype)


def paged_attention_lse_ref(q, k_pages, v_pages, page_pos, cur_pos, scale, softcap=None):
    """``paged_attention_ref`` with its output left in float32, and each (b,
    KV head, query row)'s log-sum-exp of its scaled (softcapped) masked
    scores, float32 natural log (B, kv, G): the partial a page shard hands
    to the fused step's merge (reference ``sharded_retrieval
    ._partial_attend``'s num / den and m + log(den)). A row whose positions
    are all masked gives about -1e30."""
    B, kv, N, p, d = k_pages.shape
    k = k_pages.reshape(B, kv, N * p, d).float()
    v = v_pages.reshape(B, kv, N * p, d).float()
    pos = page_pos.reshape(B, kv, N * p)
    s = torch.einsum("bkgd,bkld->bkgl", q.float(), k) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    ok = (pos >= 0) & (pos <= cur_pos[:, None, None])
    s = torch.where(ok[:, :, None, :], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgl,bkld->bkgd", w, v), torch.logsumexp(s, dim=-1)


def recall_gather_ref(pool, idx):
    """pool (B, n_pages, kv, 2, p, d) HND; idx (B, kv, n_sel) int32, -1 invalid
    -> k, v each (B, kv, n_sel, p, d) in the pool's dtype, on idx's device
    (reference ``kernels/ref.py:64``). Invalid lanes give zeros."""
    B, n_pages, kv = pool.shape[:3]
    idx = idx.to(pool.device)
    safe = idx.clamp(0, n_pages - 1).long()
    bI = torch.arange(B, device=pool.device)[:, None, None]
    kI = torch.arange(kv, device=pool.device)[None, :, None]
    blk = pool[bI, safe, kI]                                       # (B,kv,n_sel,2,p,d)
    blk = torch.where((idx >= 0)[..., None, None, None], blk,
                      torch.zeros((), dtype=blk.dtype, device=blk.device))
    return blk[..., 0, :, :], blk[..., 1, :, :]


def recall_values_ref(pool, idx):
    """The V half of ``recall_gather_ref``: pool (B, n_pages, kv, 2, p, d);
    idx (B, kv, n_sel) int32, -1 invalid -> v (B, kv, n_sel, p, d) in the
    pool's dtype on idx's device, zeros for invalid lanes (the contract of
    the reference's ``core/recall.py:31`` ``recall_values_only``)."""
    B, n_pages, kv = pool.shape[:3]
    idx = idx.to(pool.device)
    safe = idx.clamp(0, n_pages - 1).long()
    bI = torch.arange(B, device=pool.device)[:, None, None]
    kI = torch.arange(kv, device=pool.device)[None, :, None]
    v = pool[bI, safe, kI, 1]                                      # (B,kv,n_sel,p,d)
    return torch.where((idx >= 0)[..., None, None], v,
                       torch.zeros((), dtype=v.dtype, device=v.device))


def recall_gather_quant_ref(pool, scales, idx, bits, out_dtype=torch.float32):
    """pool (B, n_pages, kv, 2, p, d_packed) int8; scales (B, n_pages, kv, 2,
    n_g) float32; idx (B, kv, n_sel) int32, < 0 invalid -> k, v each (B, kv,
    n_sel, p, d) in ``out_dtype`` on idx's device: ``dequant_recall_pages``
    (``quant/quantizers.py``), the contract of the reference's fused kernel."""
    k, v = dequant_recall_pages(pool, scales, idx, bits, out_dtype)
    return k.to(idx.device), v.to(idx.device)


def recall_values_quant_ref(pool, scales, idx, bits, out_dtype=torch.float32):
    """The V half of ``recall_gather_quant_ref`` -> v (B, kv, n_sel, p, d) in
    ``out_dtype`` on idx's device: ``dequant_recall_values``
    (``quant/quantizers.py``), the contract of the reference's fused kernel
    with ``values_only=True``."""
    return dequant_recall_values(pool, scales, idx, bits, out_dtype).to(idx.device)


def flash_prefill_ref(q, k, v, scale, causal=True, window=None, softcap=None):
    """q (B, H, Tq, d); k/v (B, kv, Tk, d) with Tk >= Tq -> (B, H, Tq, d) in
    q's dtype, float32 throughout (reference ``kernels/ref.py:76``, plus the
    TPU kernel's softcap, applied to the scaled scores before the mask).
    Query row i sits at absolute position Tk - Tq + i (the bottom-right
    causal alignment of an extension chunk; Tq == Tk is a whole prompt).
    Query rows go 512 at a time so the scores of a long prompt never exist
    whole; each row's softmax is independent, so the result is the same."""
    q_chunk = 512
    B, H, Tq, d = q.shape
    kv, Tk = k.shape[1], k.shape[2]
    G = H // kv
    kf, vf = k.float(), v.float()
    qg = q.reshape(B, kv, G, Tq, d)
    tpos = torch.arange(Tk - Tq, Tk, device=q.device)      # the query rows' positions
    ti = torch.arange(Tk, device=q.device)
    out = []
    for t0 in range(0, Tq, q_chunk):
        tq = tpos[t0:t0 + q_chunk, None]
        s = torch.einsum("bkgtd,bksd->bkgts", qg[:, :, :, t0:t0 + q_chunk].float(), kf) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        ok = torch.ones((tq.shape[0], Tk), dtype=torch.bool, device=q.device)
        if causal:
            ok &= ti[None, :] <= tq
        if window is not None:
            ok &= ti[None, :] > tq - window
        s = torch.where(ok, s, torch.full((), NEG_INF, device=q.device))
        w = torch.softmax(s, dim=-1)
        out.append(torch.einsum("bkgts,bksd->bkgtd", w, vf))
    return torch.cat(out, dim=3).reshape(B, H, Tq, d).to(q.dtype)
