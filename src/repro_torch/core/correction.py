"""Fine-grained correction (§3.3), reference ``repro/core/correction.py``:
cosine similarity of adjacent decode-step queries, pooled per KV head;
heads with C_i < tau get a synchronous recall."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, FreeKVConfig


def query_similarity(q, qprev, eps=1e-6):
    """Per-q-head cosine similarity. q, qprev: (B, H, d) -> (B, H) fp32."""
    qf = q.float()
    pf = qprev.float()
    num = torch.sum(qf * pf, dim=-1)
    den = torch.linalg.vector_norm(qf, dim=-1) * torch.linalg.vector_norm(pf, dim=-1)
    return num / torch.clamp(den, min=eps)


def corrected_heads(cfg: ArchConfig, fkv: FreeKVConfig, q, qprev):
    """(corr (B, kv) bool, sim_grouped (B, kv) fp32): which KV heads need a
    synchronous correction this step (mean pooling over the group, the
    paper's choice)."""
    B, H, _ = q.shape
    kv = cfg.n_kv_heads
    g = query_similarity(q, qprev).reshape(B, kv, H // kv).mean(dim=-1)
    return g < fkv.tau, g
