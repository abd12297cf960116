"""Plain PyTorch versions of the hand-written CUDA kernels.

Each function computes exactly what its counterpart in the reference's
``repro/kernels/ref.py`` computes. ``kernels/ops.py`` dispatches CPU tensors
here; the tests hold these against the JAX oracles and ``chip_smoke.py``
holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def page_scores_ref(q, summ, scale):
    """q (B, kv, G, d); summ (B, n_pages, kv, 2, d) -> (B, kv, G, n_pages) f32.

    Quest scoring: ``sum_d max(q*lo, q*hi)``, the coordinate-wise max taken
    BEFORE the sum (reference ``kernels/ref.py:17``)."""
    lo = summ[..., 0, :].float().permute(0, 2, 1, 3)[:, :, None]   # (B,kv,1,n,d)
    hi = summ[..., 1, :].float().permute(0, 2, 1, 3)[:, :, None]
    qf = q.float()[:, :, :, None, :]                               # (B,kv,G,1,d)
    return torch.maximum(qf * lo, qf * hi).sum(-1) * scale


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
