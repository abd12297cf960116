"""Recall primitives (reference ``repro/core/recall.py``): the plain gathers
of selected pages from the HND pool into per-head page buffers. The decode
path recalls through ``kernels/ops.recall_gather`` and ``ops.recall_values``
(the CUDA kernels on the card); these are the same contracts in plain
PyTorch.
"""
from __future__ import annotations

from repro_torch.kernels.ref import recall_gather_ref, recall_values_ref


def recall_pages(pool, idx):
    """pool (B, n_pages, kv, 2, p, d) HND; idx (B, kv, n_sel) int32, -1 invalid
    -> (sel_k, sel_v) each (B, kv, n_sel, p, d)."""
    return recall_gather_ref(pool, idx)


def recall_values_only(pool, idx):
    """ShadowKV: only the V half is transferred (K is reconstructed) ->
    sel_v (B, kv, n_sel, p, d)."""
    return recall_values_ref(pool, idx)
