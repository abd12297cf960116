"""Page selection (§3.2), reference ``repro/core/selection.py``: Quest-style
min-max page scores, group-consistent pooling (MeanS by default) and top-k
page ids, in one ``ops.select_pages`` launch (its plain version,
``kernels/ref.select_pages_ref``, on the CPU). The MaxQ/MeanQ query pooling
and the top-p budget are small tensor ops around that launch, as they are
plain jnp around the Pallas call in the reference."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, FreeKVConfig
from repro_torch.kernels import ops


def select_kwargs(cfg: ArchConfig, fkv: FreeKVConfig, d: int) -> dict:
    """The selection settings ``ops.select_pages`` takes, from the configs."""
    return dict(scale=cfg.attn_scale if cfg.attn_scale is not None else 1.0 / (d ** 0.5),
                page_size=fkv.page_size, n_sink=fkv.n_sink, n_window=fkv.n_window)


def select_pages(cfg: ArchConfig, fkv: FreeKVConfig, q, summ, length, n_sel,
                 with_pooled=True, q_pool=None, per_head=False, keep_invalid=False):
    """Scores -> group-consistent pooling -> top-k page ids: q (B, H, d),
    summ (B, n_pages, kv, 2, d), length (B,) int32.

    ``q_pool`` "max" or "mean" (the MaxQ/MeanQ ablations, reference
    ``selection.py:82-86``) pools q over each group before scoring and
    repeats it G times. With ``fkv.select_top_p`` in (0, 1) and a softmax
    pooling mode, only the shortest prefix of the top-k whose pooled mass
    reaches it stays selected, never fewer than one page (reference
    ``selection.py:101-107``).

    ``keep_invalid`` gives the k best pages as ``jax.lax.top_k`` returns
    them, unselectable lanes included (their ids, lower ids first, never
    -1) and no top-p: RaaS's prefill seeding (reference
    ``retrieval.py:693-698``) and, with ``per_head``, Quest's selection of
    each query head over its own scores, idx (B, kv, G, n_sel) (reference
    ``retrieval.py:508-513``).

    Returns (idx (B, kv, n_sel) int32 with -1 for invalid, the pooled scores
    (B, kv, n_pages), or None when ``with_pooled`` is False)."""
    B, H, d = q.shape
    kv = cfg.n_kv_heads
    G = H // kv
    qg = q.reshape(B, kv, G, d)
    if q_pool in ("max", "mean"):
        qp = qg.amax(dim=2) if q_pool == "max" else qg.mean(dim=2)
        qg = qp[:, :, None].expand(B, kv, G, d)
    top_p = (not keep_invalid and 0.0 < fkv.select_top_p < 1.0
             and fkv.group_pool.endswith("softmax"))
    need = with_pooled or top_p
    out = ops.select_pages(qg.contiguous(), summ, length, n_sel=n_sel, mode=fkv.group_pool,
                           with_pooled=need, per_head=per_head, keep_invalid=keep_invalid,
                           **select_kwargs(cfg, fkv, d))
    idx, pooled = out if need else (out, None)
    if top_p:
        # the pooled mass of each selected page, in top-k order (0 past the
        # valid lanes, as the reference's max(top_s, 0) of -1e30)
        top_s = torch.gather(pooled, 2, idx.clamp(min=0).long())
        top_s = torch.where(idx >= 0, top_s.clamp(min=0.0), torch.zeros((), device=idx.device))
        keep = (torch.cumsum(top_s, dim=-1) - top_s) < fkv.select_top_p
        keep[..., 0] = True
        idx = torch.where(keep, idx, torch.full((), -1, dtype=idx.dtype, device=idx.device))
    return idx, (pooled if with_pooled else None)
