"""Host offload of the KV pool (reference ``repro/core/offload.py``).

``offload="host"`` allocates each layer's ``pool`` (and, under the
quantized tier, its ``pool_scale``) in pinned (page-locked) host memory,
while the summaries stay on the card (they are read every step), as the
reference's ``HOST_KEYS`` do. The card reads the host pool only through the
``recall_gather`` and ``recall_gather_quant`` kernels, at the mapped device
addresses; writes are non-blocking copies from card-side blocks
(``core/paging``). ``offload="sim"`` keeps the pool in device memory. On a
CPU device the two coincide.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import FreeKVConfig


def alloc_pool(shape, dtype, fkv: FreeKVConfig, device: torch.device):
    """A zeroed pool tensor (the payload or its scales): pinned host memory
    for ``offload="host"`` on a CUDA device, else on ``device``."""
    if fkv.offload == "host" and device.type == "cuda":
        return torch.zeros(shape, dtype=dtype, pin_memory=True)
    return torch.zeros(shape, dtype=dtype, device=device)
