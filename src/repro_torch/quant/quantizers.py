"""Symmetric per-page, per-KV-head KV quantizers (own copy of the reference
``repro/quant/quantizers.py``, in PyTorch).

Layout contract (the HND pool of ``core/paging``):

  * fp pool block   ``(..., 2, p, d)``      K+V halves of one page
  * int8 pool block ``(..., 2, p, d)``      int8
  * int4 pool block ``(..., 2, p, d//2)``   int8, two nibbles per byte:
    channel ``j`` in the low nibble, ``j + d/2`` in the high nibble
  * scales          ``(..., 2, n_groups)``  float32, ``n_groups = d // g``

Quantization is symmetric absmax: one scale per (page, KV head, K|V half,
channel group), the amax taken over the page's ``p`` tokens x ``g``
channels; ``group_size == 0`` means one scale per page half. Zero pages get
scale 1, so they dequantize to exact zeros. Every step matches the reference
bit for bit: ``amax / qmax`` and ``x / scale`` are true float32 divisions
(on the card too, see ``quantize_block``),
``torch.round`` rounds half to even like ``jnp.round``, values are clipped
before the cast to int8, and dequantization is ``int -> float32 * scale ->
out_dtype``, the contract the ``recall_gather_quant`` kernel keeps too.
"""
from __future__ import annotations

import torch

_QMAX = {8: 127, 4: 7}


def quant_bits(kv_quant: str) -> int:
    """Bits per stored element for a ``FreeKVConfig.kv_quant`` mode (0 = off)."""
    return {"none": 0, "int8": 8, "int4": 4}[kv_quant]


def effective_group(group_size: int, d: int) -> int:
    """Channels per scale; 0 -> the whole page half (one scale)."""
    g = group_size if group_size > 0 else d
    if d % g:
        raise ValueError(f"quant_group_size {g} does not divide d_head {d}")
    return g


def pack_int4(q):
    """int8 values in [-8, 7], even last dim d -> int8 packed (..., d//2)."""
    d = q.shape[-1]
    assert d % 2 == 0, d
    d2 = d // 2
    lo = q[..., :d2] & 0xF
    hi = q[..., d2:] & 0xF
    return lo | (hi << 4)


def unpack_int4(packed):
    """int8 packed (..., d//2) -> int8 values in [-8, 7] (..., d); the
    arithmetic right shifts sign-extend each nibble."""
    lo = (packed << 4) >> 4
    hi = packed >> 4
    return torch.cat([lo, hi], dim=-1)


def quantize_block(block, bits: int, group_size: int = 0):
    """fp pool block (..., 2, p, d) -> (q int8 (..., 2, p, d_packed),
    scale float32 (..., 2, n_groups))."""
    qmax = _QMAX[bits]
    p, d = block.shape[-2], block.shape[-1]
    g = effective_group(group_size, d)
    n_g = d // g
    xg = block.float().reshape(*block.shape[:-2], p, n_g, g)
    amax = xg.abs().amax(dim=(-3, -1))                         # (..., 2, n_g)
    # qmax as a float32 tensor: a CUDA tensor divided by a Python number is
    # multiplied by the number's float32 reciprocal instead, which can land
    # one ulp away from the true quotient
    qmax_t = torch.full((), qmax, dtype=torch.float32, device=amax.device)
    scale = torch.where(amax > 0, amax / qmax_t, torch.ones((), device=amax.device))
    q = torch.clamp(torch.round(xg / scale[..., None, :, None]), -qmax, qmax)
    q = q.to(torch.int8).reshape(*block.shape[:-2], p, d)
    if bits == 4:
        q = pack_int4(q)
    return q, scale


def dequant_block(q, scale, bits: int, out_dtype=torch.float32):
    """Inverse of ``quantize_block``: (q, scale) -> fp block (..., 2, p, d)."""
    if bits == 4:
        q = unpack_int4(q)
    p, d = q.shape[-2], q.shape[-1]
    n_g = scale.shape[-1]
    xf = q.float().reshape(*q.shape[:-2], p, n_g, d // n_g)
    xf = xf * scale.float()[..., None, :, None]
    return xf.reshape(*q.shape[:-2], p, d).to(out_dtype)


def _gather_blocks(pool, scales, idx):
    """The selected (2, p, d_packed) blocks and their (2, n_g) scales, on the
    pool's device, with idx clamped into range (callers mask lanes < 0)."""
    B, n_pages, kv = pool.shape[:3]
    safe = idx.to(pool.device).clamp(0, n_pages - 1).long()
    bI = torch.arange(B, device=pool.device)[:, None, None]
    kI = torch.arange(kv, device=pool.device)[None, :, None]
    return pool[bI, safe, kI], scales.to(pool.device)[bI, safe, kI]


def dequant_recall_pages(pool, scales, idx, bits: int, out_dtype=torch.float32):
    """Quantized-pool recall: pool (B, n_pages, kv, 2, p, d_packed) int8;
    scales (B, n_pages, kv, 2, n_g) float32; idx (B, kv, n_sel) int32, < 0
    invalid -> (k, v) each (B, kv, n_sel, p, d) in ``out_dtype`` on the
    pool's device; invalid lanes are zeros."""
    blk, sc = _gather_blocks(pool, scales, idx)
    deq = dequant_block(blk, sc, bits, out_dtype)              # (B,kv,n_sel,2,p,d)
    deq = torch.where((idx.to(pool.device) >= 0)[..., None, None, None], deq,
                      torch.zeros((), dtype=out_dtype, device=pool.device))
    return deq[..., 0, :, :], deq[..., 1, :, :]


def dequant_recall_values(pool, scales, idx, bits: int, out_dtype=torch.float32):
    """ShadowKV's V-only recall from the quantized pool (reference
    ``quantizers.py:123``): only the V half of each selected page and its V
    scales -> v (B, kv, n_sel, p, d) in ``out_dtype`` on the pool's device;
    invalid lanes are zeros."""
    blk, sc = _gather_blocks(pool, scales, idx)
    v = dequant_block(blk[..., 1:, :, :], sc[..., 1:, :], bits, out_dtype)[..., 0, :, :]
    return torch.where((idx.to(pool.device) >= 0)[..., None, None], v,
                       torch.zeros((), dtype=out_dtype, device=pool.device))
