"""Byte accounting for the quantized host KV tier (reference
``repro/quant/accounting.py``). One recalled (KV head, page) K+V block moves

  dense:  2 * p * d * itemsize
  int8:   2 * p * d          + 2 * n_groups * 4   (payload + float32 scales)
  int4:   2 * p * (d / 2)    + 2 * n_groups * 4

The scales travel with the page, so they count as moved bytes.
``chip_smoke.py`` reports these per recalled page; nothing on the decode
path calls them. ``DEQUANT_ELEMS_PER_S`` is the rate behind
``EngineMetrics.dequant_overhead_s``.
"""
from __future__ import annotations

import torch

from repro_torch.quant.quantizers import effective_group, quant_bits
from repro_torch.sharding.rules import base_key

# Elements a second the fused gather + dequantization reached on the card
# with the int8 pool in device memory, so that no PCIe time is in it
# (reference ``repro/quant/accounting.py:25`` gives a nominal 2e10):
# recall_gather_quant's int8 device-pool time, 0.01749824 ms for
# pool(4, 259, 8, 2, 32, 128) int8, idx(4, 8, 56) -> bf16, every lane valid,
# i.e. 4 * 8 * 56 * 2 * 32 * 128 = 14,680,064 elements (chip_smoke.py phase
# 3, NVIDIA H100 80GB HBM3, 700.00 W). It includes the gather's own HBM
# traffic, so it bounds the dequantization's time from above: at the same
# shape the bf16 recall_gather from a device pool took longer (0.01940878
# ms), so the dequantization hides under the memory traffic.
DEQUANT_ELEMS_PER_S = 4 * 8 * 56 * 2 * 32 * 128 / 0.01749824e-3


def scale_bytes_per_block(fkv, d_head: int) -> int:
    """float32 scale bytes moved with one (KV head, page) K+V block."""
    if fkv.kv_quant == "none":
        return 0
    g = effective_group(fkv.quant_group_size, d_head)
    return 2 * (d_head // g) * 4


def page_block_bytes_dense(fkv, d_head: int, itemsize: int = 2) -> int:
    """Unquantized (KV head, page) K+V block bytes at ``itemsize`` per element."""
    return 2 * fkv.page_size * d_head * itemsize


def page_block_bytes(fkv, d_head: int, itemsize: int = 2) -> int:
    """Moved bytes of one (KV head, page) block under ``fkv.kv_quant``
    (packed payload + scales; the dense size when quantization is off)."""
    bits = quant_bits(fkv.kv_quant)
    if bits == 0:
        return page_block_bytes_dense(fkv, d_head, itemsize)
    return 2 * fkv.page_size * (d_head * bits // 8) + scale_bytes_per_block(fkv, d_head)


def _tensors_by_key(tree, key=None):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors_by_key(v, k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors_by_key(v, key)
    elif isinstance(tree, torch.Tensor):
        yield key, tree


def pool_bytes_detail(state, d_head: int, dense_itemsize: int = 2) -> dict:
    """Physical against dense-equivalent pool bytes of a decode state (one
    layer's dict, or any nesting of dicts and lists of them).

    Returns {"payload", "scales", "physical", "dense", "ratio"}: ``payload``
    sums the (possibly packed) ``pool`` tensors, ``scales`` the
    ``pool_scale`` tensors, ``dense`` what the same pages would take
    unquantized at ``dense_itemsize`` bytes per element. Every shard's
    pool counts under tensor-parallel serving (``"<s>/pool"``)."""
    acc = {"payload": 0, "scales": 0, "dense": 0}
    for key, t in _tensors_by_key(state):
        nbytes = t.numel() * t.element_size()
        key = base_key(key) if isinstance(key, str) else key
        if key == "pool":
            acc["payload"] += nbytes
            acc["dense"] += t.numel() // t.shape[-1] * d_head * dense_itemsize
        elif key == "pool_scale":
            acc["scales"] += nbytes
    physical = acc["payload"] + acc["scales"]
    return {**acc, "physical": physical,
            "ratio": acc["dense"] / physical if physical else 1.0}
