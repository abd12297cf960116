"""Recall primitive (reference ``repro/core/recall.py``): the plain gather of
selected pages from the HND pool into per-head page buffers. The decode
path recalls through ``kernels/ops.recall_gather`` (the CUDA kernel on the
card); this is the same ``(pool, idx) -> (k, v)`` contract in plain PyTorch.
"""
from __future__ import annotations

from repro_torch.kernels.ref import recall_gather_ref


def recall_pages(pool, idx):
    """pool (B, n_pages, kv, 2, p, d) HND; idx (B, kv, n_sel) int32, -1 invalid
    -> (sel_k, sel_v) each (B, kv, n_sel, p, d)."""
    return recall_gather_ref(pool, idx)
