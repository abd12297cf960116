"""Host offload of the KV pool and the preemption swap (reference
``repro/core/offload.py``).

``offload="host"`` allocates each layer's ``pool`` (and, under the
quantized tier, its ``pool_scale``) in pinned (page-locked) host memory,
while the summaries stay on the card (they are read every step), as the
reference's ``HOST_KEYS`` do. The card reads the host pool only through the
``recall_gather`` and ``recall_gather_quant`` kernels, at the mapped device
addresses; writes are non-blocking copies from card-side blocks
(``core/paging``). ``offload="sim"`` keeps the pool in device memory. On a
CPU device the two coincide. On the meta device a host pool is a meta
tensor marked by ``ops.mark_host_pool``, so the kernels' wrappers count its
bytes, and those of its views, across the link as on the card.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import FreeKVConfig
from repro_torch.kernels import ops


def alloc_pool(shape, dtype, fkv: FreeKVConfig, device: torch.device):
    """A zeroed pool tensor (the payload or its scales): pinned host memory
    for ``offload="host"`` on a CUDA device (on meta, a meta tensor that
    stands for it), else on ``device``. Each tensor-parallel shard places
    its own pool, on its own device (the counterpart of the reference's
    mesh-aware ``place_decode_state``): pinned pages are mapped into every
    card's address space, so the shard's card reads them at their host
    address."""
    if fkv.offload == "host" and device.type == "cuda":
        return torch.zeros(shape, dtype=dtype, pin_memory=True)
    t = torch.zeros(shape, dtype=dtype, device=device)
    if fkv.offload == "host" and device.type == "meta":
        ops.mark_host_pool(t)
    return t


def swap_state_to_host(state):
    """Every tensor of an extracted B=1 decode state (any nesting of dicts
    and lists) as a CPU tensor at its stored dtype: the preemption swap-out
    (reference ``offload.py:126``). A packed int8/int4 pool and its float32
    scales move as stored, never dequantized, so ``SlotPool.swap_in``
    restores the slot bit for bit. Pool leaves already in pinned host memory
    are copied too: the freed slot's rows will be overwritten.

    CUDA leaves land in pinned memory by non-blocking copies on the current
    stream (no pageable staging, no host wait); the copies back at swap-in
    are ordered after them on the same stream. Host leaves are copied on the
    host, so the caller first waits for the card to finish writing them
    (``SlotPool._settle``). Non-tensor entries are dropped."""
    if isinstance(state, dict):
        return {k: swap_state_to_host(v) for k, v in state.items()
                if isinstance(v, (dict, list, torch.Tensor))}
    if isinstance(state, list):
        return [swap_state_to_host(v) for v in state]
    if not state.is_cuda and not state.is_pinned():
        return state.clone(memory_format=torch.contiguous_format)
    out = torch.empty(state.shape, dtype=state.dtype, pin_memory=True)
    out.copy_(state, non_blocking=True)
    return out
