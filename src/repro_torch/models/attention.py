"""GQA attention for prefill (reference ``repro/models/attention.py``).

``attention_prefill`` is what a prompt's prefill and an extension chunk
(a prompt's suffix over its cached or already prefilled prefix,
``models.model.prefill_extend``) call, and, bidirectional, an
encoder-decoder's encoder (``models.model._encode``). On the card it is the
``flash_prefill`` CUDA kernel (the reference registers its Pallas
counterpart but computes prefill in jnp), whose causal mask is aligned
bottom-right when there are fewer queries than keys. On the CPU it is the
reference's own plain computation, ``attention_auto``: ``attention_dense``
for small products and the flash-style ``attention_chunked`` (running
max/sum over KV chunks of 512) beyond ``2048 * 2048`` query-key pairs, so
the CPU parity tests keep the reference's numbers. Decode attention is
``core/retrieval._attend``.

``attention_mp`` is a training layer's attention sublayer under a mesh, on
one data group's model shards (``sharding/transfer.MeshRow``), in the
layouts of the reference's ``_gather_for_compute`` and ``_maybe_seq_shard``;
``attention_mp_prefill`` is a serving prefill's, forward only, and
``megatron_weights``, ``qkv_split`` and ``out_split`` are the pieces a
serving decode step's sublayer reuses (``models/model``).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import card_branch
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, softcap

NEG_INF = -1e30


def qkv_proj(cfg: ArchConfig, p, x, positions, rope=True):
    """x: (B,T,d) -> q (B,T,H,dh), k/v (B,T,Hkv,dh); RoPE applied to q,k."""
    B, T, _ = x.shape
    q = (x @ p["wq"]).reshape(B, T, cfg.n_heads, cfg.d_head)
    k = (x @ p["wk"]).reshape(B, T, cfg.n_kv_heads, cfg.d_head)
    v = (x @ p["wv"]).reshape(B, T, cfg.n_kv_heads, cfg.d_head)
    if rope:
        q = apply_rope(cfg, q, positions)
        k = apply_rope(cfg, k, positions)
    return q, k, v


def out_proj(cfg: ArchConfig, p, o):
    B, T = o.shape[:2]
    return o.reshape(B, T, cfg.n_heads * cfg.d_head) @ p["wo"]


def _scale(cfg: ArchConfig):
    return cfg.attn_scale if cfg.attn_scale is not None else 1.0 / (cfg.d_head ** 0.5)


def _mask_bias(pos_q, pos_k, causal=True, window=None):
    """(B,Tq),(B,Tk) -> additive bias (B,1,Tq,Tk); pos_k < 0 marks invalid."""
    dq = pos_q[:, :, None]
    dk = pos_k[:, None, :]
    ok = dk >= 0
    if causal:
        ok = ok & (dk <= dq)
    if window is not None:
        ok = ok & (dk > dq - window)
    zero = torch.zeros((), dtype=torch.float32, device=pos_q.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))[:, None, :, :]


def attention_dense(cfg: ArchConfig, q, k, v, pos_q, pos_k, causal=True, window=None):
    """q:(B,Tq,H,dh) k,v:(B,Tk,Hkv,dh) -> (B,Tq,H,dh)."""
    B, Tq, H, dh = q.shape
    G = cfg.group_size
    qg = q.reshape(B, Tq, cfg.n_kv_heads, G, dh)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k).float() * _scale(cfg)
    s = softcap(s, cfg.attn_logit_softcap)
    s = s + _mask_bias(pos_q, pos_k, causal, window)[:, :, None, :, :]
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bskd->btkgd", w.to(v.dtype), v)
    return o.reshape(B, Tq, H, dh)


def _chunk_step(cfg: ArchConfig, qg, m, l, acc, kc, vc, pos_q, pos_kc, causal, window):
    """One KV chunk of ``attention_chunked``: the running (max, sum, acc)
    after the chunk's keys."""
    s = torch.einsum("bkgtd,bskd->bkgts", qg, kc.float())
    s = softcap(s, cfg.attn_logit_softcap)
    s = s + _mask_bias(pos_q, pos_kc, causal, window)[:, :, None]
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    del s
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bkgts,bskd->bkgtd", p, vc.float())
    return m_new, l, acc


def attention_chunked(cfg: ArchConfig, q, k, v, pos_q, pos_k, causal=True,
                      window=None, chunk=512):
    """Flash-style attention: a loop over KV chunks with running (max, sum);
    peak memory O(Tq * chunk) instead of O(Tq * Tk). Under autograd each
    chunk is checkpointed, as the reference's scan body (``jax.checkpoint``):
    the backward recomputes a chunk's (B, kv, G, Tq, chunk) scores instead
    of keeping every chunk's."""
    B, Tq, H, dh = q.shape
    Tk = k.shape[1]
    if Tk % chunk:
        pad = chunk - Tk % chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        pos_k = torch.nn.functional.pad(pos_k, (0, pad), value=-1)
        Tk += pad
    G = cfg.group_size
    kv = cfg.n_kv_heads
    # (B, kv, G, Tq, dh), made contiguous once for every chunk's product
    qg = (q.reshape(B, Tq, kv, G, dh).float() * _scale(cfg)).permute(0, 2, 3, 1, 4).contiguous()
    m = torch.full((B, kv, G, Tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, kv, G, Tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, kv, G, Tq, dh), dtype=torch.float32, device=q.device)
    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    for c0 in range(0, Tk, chunk):
        args = (cfg, qg, m, l, acc, k[:, c0:c0 + chunk], v[:, c0:c0 + chunk], pos_q,
                pos_k[:, c0:c0 + chunk], causal, window)
        if remat:
            m, l, acc = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            m, l, acc = _chunk_step(*args)
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, dh).to(q.dtype)


def attention_auto(cfg: ArchConfig, q, k, v, pos_q, pos_k, causal=True, window=None):
    # the dense path only for small products; longer prompts take the
    # chunked path so the scores never materialise (reference :133)
    if q.shape[1] * k.shape[1] <= 2048 * 2048:
        return attention_dense(cfg, q, k, v, pos_q, pos_k, causal, window)
    return attention_chunked(cfg, q, k, v, pos_q, pos_k, causal, window)


def attention_prefill(cfg: ArchConfig, q, k, v, q_pos, kv_pos, window=None, causal=True):
    """Causal attention of S prompt tokens over Tk >= S keys whose last S
    are their own: q (B,S,H,dh) at positions ``q_pos`` (B,S), k/v
    (B,Tk,Hkv,dh) at ``kv_pos`` (B,Tk) -> (B,S,H,dh). A whole prompt has
    S = Tk and ``q_pos`` = ``kv_pos``; an extension chunk (reference
    ``model._apply_layer_extend``) has ``q_pos`` = Tp..Tp+S-1 and ``kv_pos``
    = 0..Tp+S-1. ``window`` (gemma2's local layers) masks keys at or before
    a query's position minus the window, in both forms. ``causal=False``
    (the encoder, S = Tk) lets every query see every key.

    CUDA tensors go to ``ops.flash_prefill`` as transposed (B,H,T,dh) views
    (the kernel takes strides, so nothing is copied), whose bottom-right
    alignment puts query row i at Tk - S + i, and the output comes back in
    q's (B,S,H,dh) layout (meta tensors likewise: the card's branch,
    counted); CPU tensors take ``attention_auto`` at the given positions, as
    the reference does, so the CPU tokens equal the reference's."""
    if card_branch(q):
        o = ops.flash_prefill(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              scale=_scale(cfg), causal=causal, window=window,
                              softcap=cfg.attn_logit_softcap)
        return o.transpose(1, 2)
    return attention_auto(cfg, q, k, v, q_pos, kv_pos, causal=causal, window=window)


def _positions(B: int, t0: int, t1: int, device):
    return torch.arange(t0, t1, device=device)[None].expand(B, t1 - t0)


def attention_mp(cfg: ArchConfig, p, h, window, row, causal=True):
    """Self-attention of a training layer over one data group's ``h`` (B,
    T, d) on shard 0 of ``row``, placed weights ``p`` -> the sublayer's
    output (B, T, d) on shard 0 (before any post-norm); causal, or
    bidirectional (``causal=False``, an encoder layer).

    Where the model axis divides both head counts, the projections are
    Megatron's: shard j takes query heads [j H/m, (j+1) H/m) and KV heads
    [j kv/m, (j+1) kv/m) (whole GQA groups) through its column blocks of
    wq/wk/wv, attends with them and multiplies by its row block of wo; the
    partial outputs are summed on shard 0. Where it does not (smollm-360m's
    15/5 at m = 2, the smoke configs' 4/2 at m = 4), shard j takes input
    block j of wq/wk/wv (d_model) and of wo (H * d_head), the partial q, k, v
    and outputs summed on shard 0 (``qkv_split``, ``out_split``), and the
    attention is split over query rows when T divides: shard j attends rows
    [j T/m, (j+1) T/m) to every key, which is exact. A dim that does not
    divide stays whole on shard 0. With one model shard this is the
    unsharded sublayer."""
    m = row.m
    B, T, d = h.shape
    if heads_divide(cfg, m):
        local = local_cfg(cfg, m)
        hs = row.broadcast(h, "partial_sum")
        parts = []
        for j in range(m):
            w = megatron_weights(p, row, j)
            pos = _positions(B, 0, T, row.device(j))
            q, k, v = qkv_proj(local, w, hs[j], pos)
            o = attention_auto(local, q, k, v, pos, pos, causal=causal, window=window)
            parts.append(out_proj(local, w, o))
        return row.reduce(parts, "partial_sum")

    pos = _positions(B, 0, T, h.device)
    q, k, v = qkv_split(cfg, p, h, pos, row)
    if T % m == 0:                          # query rows: shard j holds block j
        n = T // m
        ks, vs = row.broadcast(k, "partial_sum"), row.broadcast(v, "partial_sum")
        blocks = []
        for j in range(m):
            qj = row.move(q[:, j * n:(j + 1) * n], 0, j, "partial_sum")
            blocks.append((j, attention_auto(cfg, qj, ks[j], vs[j],
                                             _positions(B, j * n, (j + 1) * n, row.device(j)),
                                             _positions(B, 0, T, row.device(j)),
                                             causal=causal, window=window)))
    else:
        blocks = [(0, attention_auto(cfg, q, k, v, pos, pos, causal=causal, window=window))]
    return out_split(cfg, p, blocks, row)


# ---------------------------------------------------------------------------
# the sublayer's pieces under a mesh row, shared by training and serving
# ---------------------------------------------------------------------------
def local_cfg(cfg: ArchConfig, m: int) -> ArchConfig:
    """``cfg`` with its head counts divided by ``m`` (one Megatron shard's)."""
    return cfg if m == 1 else dataclasses.replace(cfg, n_heads=cfg.n_heads // m,
                                                  n_kv_heads=cfg.n_kv_heads // m)


def heads_divide(cfg: ArchConfig, m: int) -> bool:
    """Whether ``m`` model shards take Megatron's layout: m divides both head
    counts."""
    return cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0


def megatron_weights(p, row, j: int) -> dict:
    """Shard j's Megatron blocks of an attention sublayer's weights."""
    w = {k: row.fetch(p[k], j, dim=1) for k in ("wq", "wk", "wv")}
    w["wo"] = row.fetch(p["wo"], j, dim=0)
    return w


def proj_split(ws, h, row) -> list:
    """``[h @ w for w in ws]`` on shard 0 by the input-dim split: input
    block j of each w on shard j, the partial products summed on shard 0
    (whole on shard 0 where d_model does not divide)."""
    m = row.m
    d = h.shape[-1]
    if d % m == 0:
        hs = [row.move(h[..., j * d // m:(j + 1) * d // m], 0, j, "partial_sum")
              for j in range(m)]
        return [row.reduce([hs[j] @ row.fetch(w, j, dim=0) for j in range(m)], "partial_sum")
                for w in ws]
    return [h @ row.fetch(w, 0) for w in ws]


def qkv_split(cfg: ArchConfig, p, h, pos, row):
    """The input-dim split's q, k, v (B, T, H|kv, dh) on shard 0, RoPE'd at
    ``pos`` (``proj_split``)."""
    B, T, _ = h.shape
    q, k, v = proj_split([p["wq"], p["wk"], p["wv"]], h, row)
    q = apply_rope(cfg, q.reshape(B, T, cfg.n_heads, cfg.d_head), pos)
    k = apply_rope(cfg, k.reshape(B, T, cfg.n_kv_heads, cfg.d_head), pos)
    return q, k, v.reshape(B, T, cfg.n_kv_heads, cfg.d_head)


def out_split(cfg: ArchConfig, p, blocks, row):
    """The input-dim split's out projection: ``blocks`` a list of (shard,
    o (B, t, H, dh)) row blocks in order; feature block j of every row
    block goes to shard j for wo's input block j, the partial outputs
    summed on shard 0 (whole on shard 0 where H * dh does not divide)."""
    m = row.m
    F = cfg.n_heads * cfg.d_head
    if F % m == 0:
        parts = []
        for j in range(m):
            o_j = [row.move(o.reshape(o.shape[0], o.shape[1], F)[..., j * F // m:(j + 1) * F // m],
                            src, j, "partial_sum") for src, o in blocks]
            o_j = o_j[0] if len(o_j) == 1 else torch.cat(o_j, dim=1)
            parts.append(o_j @ row.fetch(p["wo"], j, dim=0))
        return row.reduce(parts, "partial_sum")
    o = torch.cat([row.move(o, src, 0, "partial_sum") for src, o in blocks], dim=1)
    return o.reshape(o.shape[0], o.shape[1], F) @ row.fetch(p["wo"], 0)


def attention_mp_prefill(cfg: ArchConfig, p, h, t0: int, window, row, buf=None,
                         need_whole=False, causal=True):
    """A serving prefill's attention sublayer (forward only) over one data
    group's h (B, S, d) on shard 0 of ``row``, queries at positions
    t0..t0+S-1 over keys 0..t0+S-1, ``attention_prefill`` (``flash_prefill``
    on the card) on each shard's heads, or over query rows split over
    "model" where the heads do not divide (the reference's
    ``_maybe_seq_shard``); ``causal=False`` (an encoder layer, t0 = 0) lets
    every query see every key -> (out on
    shard 0, ks, vs, q_lasts, whole): the K/V of the whole context and the
    last query, per shard under Megatron's layout (shard j's heads), else
    one each on shard 0; ``whole`` the prompt's K/V joined on shard 0 when
    ``need_whole``. ``buf`` (an extension): the (k, v) buffers on shard 0
    holding the first t0 tokens, into which the suffix's K/V is written."""
    m = row.m
    B, S, _ = h.shape
    t1 = t0 + S
    if heads_divide(cfg, m):
        local = local_cfg(cfg, m)
        kvh = cfg.n_kv_heads // m
        hs = row.broadcast(h, "partial_sum")
        parts, ks, vs, qls = [], [], [], []
        for j in range(m):
            w = megatron_weights(p, row, j)
            dev = row.device(j)
            q_pos, kv_pos = _positions(B, t0, t1, dev), _positions(B, 0, t1, dev)
            q, k, v = qkv_proj(local, w, hs[j], q_pos)
            if buf is not None:
                sl = slice(j * kvh, (j + 1) * kvh)
                for b_, new in zip(buf, (k, v)):
                    b_[:, t0:t1, sl].copy_(row.move(new, j, 0, "state"))
                k = torch.cat([row.move(buf[0][:, :t0, sl], 0, j, "state"), k], dim=1)
                v = torch.cat([row.move(buf[1][:, :t0, sl], 0, j, "state"), v], dim=1)
            o = attention_prefill(local, q, k, v, q_pos, kv_pos, window=window, causal=causal)
            parts.append(out_proj(local, w, o))
            ks.append(k)
            vs.append(v)
            qls.append(q[:, -1].contiguous())
        whole = None
        if need_whole:
            whole = tuple(torch.cat([row.move(t, j, 0, "state") for j, t in enumerate(ts)], dim=2)
                          for ts in (ks, vs))
        return row.reduce(parts, "partial_sum"), ks, vs, qls, whole
    pos0 = _positions(B, t0, t1, h.device)
    q, k, v = qkv_split(cfg, p, h, pos0, row)
    if buf is not None:
        buf[0][:, t0:t1].copy_(k)
        buf[1][:, t0:t1].copy_(v)
        k, v = buf[0][:, :t1], buf[1][:, :t1]
    if S % m == 0 and m > 1:
        # query rows: shard j attends rows block j to the keys they see
        n = S // m
        blocks = []
        for j in range(m):
            dev = row.device(j)
            hi = t0 + (j + 1) * n if causal else t1
            qj = row.move(q[:, j * n:(j + 1) * n], 0, j, "partial_sum")
            kj, vj = (row.move(t[:, :hi], 0, j, "partial_sum") for t in (k, v))
            blocks.append((j, attention_prefill(
                cfg, qj, kj, vj, _positions(B, t0 + j * n, t0 + (j + 1) * n, dev),
                _positions(B, 0, hi, dev), window=window, causal=causal)))
    else:
        blocks = [(0, attention_prefill(cfg, q, k, v, pos0, _positions(
            B, 0, t1, h.device), window=window, causal=causal))]
    whole = (k, v) if need_whole else None
    return out_split(cfg, p, blocks, row), [k], [v], [q[:, -1].contiguous()], whole
