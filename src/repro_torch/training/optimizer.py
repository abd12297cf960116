"""Hand-rolled AdamW with a warmup + cosine learning rate (reference
``repro/training/optimizer.py``): global-norm clipping, decoupled weight
decay, float32 arithmetic per leaf, the moments kept at ``state_dtype``
("float32" or "bfloat16").

The update runs in place under ``torch.no_grad()``, the port's counterpart
of the reference's buffer donation (``donate_argnums``). Nothing reads the
card from the host: the step count, the learning rate and the clip factor
stay 0-dim tensors on the params' device.

Weight decay follows the reference's rule, ``p.ndim >= 2``, counted on the
reference's leaves: a layer of ``cfg.pattern`` (and an encoder layer) is a
slice of a leaf stacked along a leading (n_periods,) axis there, so its
norms' ``w`` and its 1-D biases are decayed too; the prelude layers',
``embed``'s and the final norms' 1-D leaves are not (``decays``).

Params placed on a mesh (``sharding/rules.shard_params``) have ``Sharded``
leaves: the tree functions walk into their pieces, so AdamW runs on each
piece on its own device, the moments are pieces of the same layout, and
``global_norm`` sums each element once. A piece's path is its leaf's with
the piece's index after it, and its rank is its leaf's, so ``decays``
decides as it does for the unsharded leaf.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.sharding.rules import Sharded


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    state_dtype: str = "float32"     # float32 | bfloat16


def tree_leaves(tree, path=()):
    """(path, leaf) pairs of a tree of dicts, lists and tuples, in insertion
    order (dict keys as given, sequence entries by index); a ``Sharded``
    leaf gives its pieces, at its path and the piece's index."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in tree_leaves(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in tree_leaves(v, path + (i,))]
    if isinstance(tree, Sharded):
        return [(path + (i,), p) for i, p in enumerate(tree.pieces)]
    return [(path, tree)]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, Sharded):
        return tree.like(fn(p) for p in tree.pieces)
    return fn(tree)


def decays(arch: ArchConfig, path, leaf) -> bool:
    """Whether the reference decays the leaf at ``path`` of the port's
    params: its rank on the reference's tree is ``leaf.ndim + 1`` for a
    layer of the pattern stack (``("layers", i)`` with i past the prelude)
    or of the encoder stack, ``leaf.ndim`` otherwise, and it decays at rank
    2 or more (reference ``optimizer.py:69``)."""
    stacked = ((path[0] == "layers" and path[1] >= len(arch.prelude))
               or path[:2] == ("encoder", "layers"))
    return leaf.ndim + stacked >= 2


def _state_dtype(cfg: AdamWConfig):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.state_dtype]


def lr_at(cfg: AdamWConfig, step):
    """Linear warmup to ``cfg.lr`` over ``warmup_steps``, then a cosine down
    to ``min_lr_ratio * lr`` at ``total_steps``; float32 as the reference.
    ``step`` an int or a 0-dim tensor; returns a 0-dim float32 tensor on
    its device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params, cfg: AdamWConfig):
    """Zero moments like ``params`` at ``cfg.state_dtype``, and the step
    count, a 0-dim int32 tensor on the params' device."""
    dt = _state_dtype(cfg)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    dev = tree_leaves(params)[0][1].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree):
    """sqrt of the sum over leaves (or pieces) of their float32 sums of
    squares, on the first leaf's device."""
    leaves = [x for _, x in tree_leaves(tree)]
    dev = leaves[0].device
    sq = [torch.sum(torch.square(x.float())).to(dev) for x in leaves]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: AdamWConfig, arch: ArchConfig):
    """One AdamW step (reference ``adamw_update``), in place: ``params`` and
    the moments are written over, and the same objects come back as
    ``(params, opt_state, {"lr", "grad_norm"})``. ``grads`` has the params'
    structure; ``arch`` decides which leaves decay (``decays``)."""
    step = opt_state["step"] + 1
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    g_leaves = [g for _, g in tree_leaves(grads)]
    m_leaves = [m for _, m in tree_leaves(opt_state["m"])]
    v_leaves = [v for _, v in tree_leaves(opt_state["v"])]
    scalars = {lr.device: (lr, clip, bc1, bc2)}
    for (path, p), g, m, v in zip(tree_leaves(params), g_leaves, m_leaves, v_leaves):
        if p.device not in scalars:          # a piece on another card of a mesh
            scalars[p.device] = tuple(t.to(p.device) for t in scalars[lr.device])
        lr_p, clip_p, bc1_p, bc2_p = scalars[p.device]
        g = g.float() * clip_p
        m_new = b1 * m.float() + (1 - b1) * g
        v_new = b2 * v.float() + (1 - b2) * g * g
        delta = (m_new / bc1_p) / (torch.sqrt(v_new / bc2_p) + cfg.eps)
        if decays(arch, path, p):      # decoupled weight decay
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr_p * delta)
        m.copy_(m_new)
        v.copy_(v_new)
    opt_state["step"].copy_(step)
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
