"""Basic layers: norms, RoPE, MLPs, embeddings (reference
``repro/models/layers.py``). Plain functions on tensors; params are dicts of
tensors with dense weights in the ``x @ W`` orientation ``(d_in, d_out)``.

Under a mesh (training, ``models/model.forward_train(mesh=)``) the MLP,
the embedding and the LM head take ``row``, the model shards of one data
group (``sharding/transfer.MeshRow``), and placed weights
(``sharding/rules.Sharded``): the MLP is column-parallel in ``up``/``gate``
and row-parallel in ``down``, the embedding and the logits vocab-parallel,
each where the split divides (the reference's ``_gather_for_compute`` and
``lm_logits(mesh=)``). With one model shard each does the plain ops."""
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


def apply_mlp(cfg: ArchConfig, p, x, row=None):
    """x @ up (gated by act(x @ gate)) @ down. Under ``row``: shard j
    computes hidden block j of up/gate and its rows of down, and the partial
    outputs are summed on shard 0 (whole on shard 0 when the hidden width
    does not divide the model axis)."""
    if row is not None:
        if p["up"].shape[-1] % row.m:
            return apply_mlp(cfg, row.whole(p), x)
        xs = row.broadcast(x, "partial_sum")
        parts = [apply_mlp(cfg, {k: row.fetch(w, j, dim=0 if k == "down" else 1)
                                 for k, w in p.items()}, xs[j]) for j in range(row.m)]
        return row.reduce(parts, "partial_sum")
    h = x @ p["up"]
    if cfg.gated_mlp:
        h = act_fn(cfg.act)(x @ p["gate"]) * h
    else:
        h = act_fn(cfg.act)(h)
    return h @ p["down"]


def _vocab_parallel(cfg: ArchConfig, row) -> bool:
    return row is not None and row.m > 1 and cfg.padded_vocab() % row.m == 0


def embed_tokens(cfg: ArchConfig, p, tokens, row=None):
    """The tokens' rows of ``p["tok"]`` (times sqrt(d_model) for gemma).
    Under ``row``, vocab-parallel: shard j looks the tokens up in its vocab
    block, zeros where another shard holds the row, and the shards' rows
    are summed on shard 0 (exact: one of them is non-zero)."""
    if row is not None:
        if not _vocab_parallel(cfg, row):
            return embed_tokens(cfg, {"tok": row.fetch(p["tok"], 0)}, tokens)
        n = cfg.padded_vocab() // row.m
        ts = row.broadcast(tokens, "vocab")
        parts = []
        for j in range(row.m):
            rel = ts[j] - j * n
            hit = ((rel >= 0) & (rel < n))[..., None]
            e = row.fetch(p["tok"], j, dim=0)[rel.clamp(0, n - 1)]
            parts.append(torch.where(hit, e, torch.zeros((), dtype=e.dtype, device=e.device)))
        x = row.reduce(parts, "vocab")
        return _embed_scale(cfg, x)
    return _embed_scale(cfg, p["tok"][tokens])


def _embed_scale(cfg: ArchConfig, x):
    if cfg.name.startswith("gemma"):
        # a 0-dim host tensor: the scale rounds to x's dtype as before, and
        # nothing is copied to the card (which would make the host wait)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def lm_logits(cfg: ArchConfig, p, x, row=None):
    """Softcapped logits over the padded vocabulary, the padding masked to
    the dtype's min. Under ``row`` a list of vocab blocks, block j on shard
    j (column-parallel when the padded vocab divides the model axis: the
    softcap and the padding mask at global vocab indices), else one block,
    the whole logits on shard 0."""
    if row is not None:
        if not _vocab_parallel(cfg, row):
            return [lm_logits(cfg, row.whole(p), x)]
        xs = row.broadcast(x, "vocab")
        n = cfg.padded_vocab() // row.m
        return [_head(cfg, xs[j] @ (row.fetch(p["tok"], j, dim=0).T if cfg.tie_embeddings
                                    else row.fetch(p["head"], j, dim=1)), j * n)
                for j in range(row.m)]
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    return _head(cfg, x @ w, 0)


def _head(cfg: ArchConfig, logits, v0: int):
    """Softcap, then the vocab padding's mask, for logits whose first column
    is vocab index ``v0``."""
    logits = softcap(logits, cfg.final_logit_softcap)
    v, vp = cfg.vocab_size, cfg.padded_vocab()
    if vp != v:
        mask = torch.arange(v0, v0 + logits.shape[-1], device=logits.device) < v
        logits = torch.where(mask, logits,
                             torch.full((), torch.finfo(logits.dtype).min,
                                        dtype=logits.dtype, device=logits.device))
    return logits
