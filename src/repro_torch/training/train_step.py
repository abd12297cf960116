"""The training step (reference ``repro/training/train_step.py``): the loss
and its gradients through ``forward_train``, then the AdamW update in place.

    step = make_train_step(cfg, opt_cfg)
    params, opt_state = init_train(cfg, opt_cfg, seed=0, device="cuda")
    params, opt_state, metrics = step(params, opt_state, {"tokens": tokens})

Every metric is a 0-dim tensor on the params' device, so a step never waits
for the card; reading one (``float(metrics["loss"])``) does.

With a ``mesh`` (``launch/mesh.make_host_mesh``) ``init_train`` places the
params and their moments on it (``sharding/rules.shard_params``), the step
runs the model-parallel ``forward_train`` and AdamW on the pieces, and
``mesh.moved.bytes`` holds the step's moves between shards by kind (reset
as the step starts).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import forward_train, init_params
from repro_torch.sharding.rules import shard_params
from repro_torch.training.optimizer import (AdamWConfig, adamw_init, adamw_update,
                                            tree_leaves, tree_map)


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, mesh=None, remat=True):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, metrics ``loss``, ``ce``, ``aux``, ``tokens``, ``lr`` and
    ``grad_norm``. ``params`` and ``opt_state`` are updated in place and
    returned; under ``mesh`` they are ``init_train(mesh=)``'s placed state."""

    def train_step(params, opt_state, batch):
        if mesh is not None:
            mesh.moved.reset()
        leaves = [p for _, p in tree_leaves(params)]
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, metrics = forward_train(cfg, params, batch, mesh=mesh, remat=remat)
                grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = iter(grads)
        params, opt_state, opt_metrics = adamw_update(
            tree_map(lambda _: next(grads), params), opt_state, params, opt_cfg, cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(metrics, loss=loss.detach(), **opt_metrics)

    return train_step


def init_train(cfg: ArchConfig, opt_cfg: AdamWConfig, seed: int = 0, device="cuda",
               dtype=torch.float32, mesh=None):
    """Seeded random params (``init_params``) and their zero AdamW state;
    under ``mesh`` drawn on the mesh's primary device and placed on the
    mesh, the moments as pieces beside them."""
    if mesh is None:
        params = init_params(cfg, seed=seed, device=device, dtype=dtype)
    else:
        params = shard_params(cfg, init_params(cfg, seed=seed, device=mesh.primary,
                                               dtype=dtype), mesh)
    return params, adamw_init(params, opt_cfg)
