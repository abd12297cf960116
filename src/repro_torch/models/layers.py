"""Basic layers: norms, RoPE, MLPs, embeddings (reference
``repro/models/layers.py``). Plain functions on tensors; params are dicts of
tensors with dense weights in the ``x @ W`` orientation ``(d_in, d_out)``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig


def apply_norm(cfg: ArchConfig, p, x, eps=1e-6):
    xf = x.float()
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (xf * p["w"].float()).to(x.dtype)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * p["w"].float() + p["b"].float()).to(x.dtype)


def softcap(x, cap):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def act_fn(name):
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def rope_freqs(cfg: ArchConfig, d_head=None, device=None):
    d_head = d_head or cfg.d_head
    d_rot = int(d_head * cfg.rope_fraction)
    d_rot -= d_rot % 2
    exps = torch.arange(0, d_rot, 2, dtype=torch.float32, device=device) / d_rot
    # float32 pow with a Python-scalar base: no host-to-device copy (a
    # tensor built from the scalar would cost a synchronising copy per call)
    inv = 1.0 / torch.pow(float(cfg.rope_theta), exps)
    return inv, d_rot


def apply_rope(cfg: ArchConfig, x, positions):
    """x: (..., T, n_heads, d_head); positions: (..., T) int."""
    inv, d_rot = rope_freqs(cfg, x.shape[-1], x.device)
    if d_rot == 0:
        return x
    ang = positions[..., None].float() * inv                     # (..., T, d_rot/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    x1, x2 = xr[..., : d_rot // 2], xr[..., d_rot // 2:]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rot.to(x.dtype), xp], dim=-1)


def apply_mlp(cfg: ArchConfig, p, x):
    h = x @ p["up"]
    if cfg.gated_mlp:
        h = act_fn(cfg.act)(x @ p["gate"]) * h
    else:
        h = act_fn(cfg.act)(h)
    return h @ p["down"]


def embed_tokens(cfg: ArchConfig, p, tokens):
    x = p["tok"][tokens]
    if cfg.name.startswith("gemma"):
        # a 0-dim host tensor: the scale rounds to x's dtype as before, and
        # nothing is copied to the card (which would make the host wait)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def lm_logits(cfg: ArchConfig, p, x):
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    logits = softcap(x @ w, cfg.final_logit_softcap)
    v, vp = cfg.vocab_size, cfg.padded_vocab()
    if vp != v:
        mask = torch.arange(vp, device=logits.device) < v
        logits = torch.where(mask, logits,
                             torch.full((), torch.finfo(logits.dtype).min,
                                        dtype=logits.dtype, device=logits.device))
    return logits
