"""Page selection (§3.2), reference ``repro/core/selection.py``: Quest-style
min-max page scores, group-consistent pooling (MeanS by default) and top-k
page ids, in one ``ops.select_pages`` launch (its plain version,
``kernels/ref.select_pages_ref``, on the CPU)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, FreeKVConfig
from repro_torch.kernels import ops


def select_kwargs(cfg: ArchConfig, fkv: FreeKVConfig, d: int) -> dict:
    """The selection settings ``ops.select_pages`` takes, from the configs."""
    return dict(scale=cfg.attn_scale if cfg.attn_scale is not None else 1.0 / (d ** 0.5),
                page_size=fkv.page_size, n_sink=fkv.n_sink, n_window=fkv.n_window)


def select_pages(cfg: ArchConfig, fkv: FreeKVConfig, q, summ, length, n_sel,
                 with_pooled=True):
    """Scores -> group-consistent pooling -> top-k page ids: q (B, H, d),
    summ (B, n_pages, kv, 2, d), length (B,) int32.

    Returns (idx (B, kv, n_sel) int32 with -1 for invalid, the pooled scores
    (B, kv, n_pages), or None when ``with_pooled`` is False)."""
    B, H, d = q.shape
    kv = cfg.n_kv_heads
    out = ops.select_pages(q.reshape(B, kv, H // kv, d).contiguous(), summ, length,
                           n_sel=n_sel, mode=fkv.group_pool, with_pooled=with_pooled,
                           **select_kwargs(cfg, fkv, d))
    return out if with_pooled else (out, None)
