"""Page selection (§3.2), reference ``repro/core/selection.py``: Quest-style
min-max page scores (the ``page_scores`` kernel), group-consistent pooling
(MeanS by default) and top-k page ids."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, FreeKVConfig
from repro_torch.kernels import ops

NEG_INF = -1e30


def page_scores_minmax(q, summ, scale):
    """Quest upper-bound score per (q-head, page): q (B, H, d), summ
    (B, n_pages, kv, 2, d) -> (B, H, n_pages) fp32, through ``ops.page_scores``."""
    B, H, d = q.shape
    kv = summ.shape[2]
    s = ops.page_scores(q.reshape(B, kv, H // kv, d).contiguous(), summ, scale=scale)
    return s.reshape(B, H, -1)


def selectable_mask(cfg: ArchConfig, fkv: FreeKVConfig, n_pages, length):
    """(B, n_pages) bool: fully offloaded pages outside the sink and the
    local window (those tokens are resident on the device already)."""
    p = fkv.page_size
    pages = torch.arange(n_pages, device=length.device)
    first = fkv.n_sink // p
    n_done = torch.div(length, p, rounding_mode="floor")
    last = torch.clamp(torch.div(length - fkv.n_window, p, rounding_mode="floor"),
                       min=first)
    return (pages[None, :] >= first) & (pages[None, :] < torch.minimum(n_done, last)[:, None])


def group_consistent_scores(cfg: ArchConfig, scores, valid, mode="mean_softmax"):
    """(B, H, n) per-q-head scores -> (B, kv, n) group-consistent scores."""
    B, H, n = scores.shape
    kv = cfg.n_kv_heads
    G = H // kv
    ok = valid if valid.dim() == 3 else valid[:, None, :]
    s = scores.reshape(B, kv, G, n)
    neg = torch.full((), NEG_INF, dtype=s.dtype, device=s.device)
    s = torch.where(ok[:, :, None, :], s, neg)
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


def select_pages(cfg: ArchConfig, fkv: FreeKVConfig, q, summ, length, n_sel):
    """Scores -> group-consistent pooling -> top-k page ids.

    Returns (idx (B, kv, n_sel) int32 with -1 for invalid, pooled scores)."""
    B, H, d = q.shape
    scale = cfg.attn_scale if cfg.attn_scale is not None else 1.0 / (d ** 0.5)
    scores = page_scores_minmax(q, summ, scale)                    # (B,H,n)
    valid = selectable_mask(cfg, fkv, summ.shape[1], length)
    pooled = group_consistent_scores(cfg, scores, valid, fkv.group_pool)
    k = min(n_sel, pooled.shape[-1])
    top_s, top_i = top_k_lower_index_first(pooled, k)
    idx = torch.where(top_s > NEG_INF / 2, top_i, torch.full_like(top_i, -1))
    idx = idx.to(torch.int32)
    if k < n_sel:
        pad = torch.full(idx.shape[:-1] + (n_sel - k,), -1, dtype=torch.int32,
                         device=idx.device)
        idx = torch.cat([idx, pad], dim=-1)
    return idx, pooled
