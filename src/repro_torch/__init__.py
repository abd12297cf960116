"""FreeKV on PyTorch + CUDA: the port of the JAX package ``repro``.

The module layout mirrors ``repro`` (``configs``, ``kernels``, ``models``,
``core``, ``serving``, ``data``, ``launch``) so each function has a
counterpart of the same name. This package imports ``torch``, ``numpy`` and
the standard library only; it never imports ``jax`` or ``repro``.

Entry points take an explicit ``device`` whose default is ``"cuda"``; on a
machine without a card that default raises (``resolve_device``) instead of
carrying on on the CPU. Pass ``device="cpu"`` to run the plain PyTorch
versions of the kernels, or ``device="meta"`` to count a step as the card
would run it without running it (``launch/op_cost``): meta tensors take the
card's branches (``card_branch``) and its kernels' wrappers, and skip only
what needs a real runtime (streams, events, pinned memory, host reads).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def card_branch(x) -> bool:
    """Whether a tensor (or device) takes the card's branch: CUDA, and meta,
    where a step is counted as the card would run it."""
    dev = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    return dev.type in ("cuda", "meta")
