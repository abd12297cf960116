"""Mixture-of-Experts FFN (reference ``repro/models/moe.py``): fine-grained
routed experts plus shared experts (DeepSeekMoE), top-k routing with
GShard-style capacity and the sort-based dispatch, on one device.

  capacity(N, E, k)                  -> slots an expert takes in one call
  route(cfg, router, x)              -> (gates, topk_idx, topk_w)
  dispatch(x, topk_idx, E, C[, e_lo, n_local])
                                     -> (xg, pos)
  expert_ffn(cfg, wg, wu, wd, xg)    -> (E, C, d)
  apply_moe(cfg, p, x[, row, n_blocks])
                                     -> (y, aux)

Capacity couples the tokens of one call: an assignment's slot is its
arrival rank within its expert over the call's flat (token, k) order, and
ranks ``>= capacity`` are dropped. So a row's output depends on every other
row of the same call (a decode step's idle lanes included), exactly as in
the reference. Under a mesh (training) a call is one data block: the flat
tokens are cut into the mesh's data blocks, each routed on its own at
``capacity(B * T / n_data, E, k)`` with its own ``aux``, so the numbers
depend on the data axis, as the reference's do.

The combine uses no atomics: each token gathers its k outputs through the
inverse of the dispatch map and adds them in expert-ascending order, the
order in which the reference's scatter-add visits them, accumulating in
the compute dtype. Nothing reads the card from the host: the capacity
comes from shapes, and there is no ``.item()``, ``nonzero``, boolean-mask
indexing or ``one_hot`` (whose range check would wait for the card).

Expert parallelism (the reference's ``shard_map`` branch, ``moe.py:126-153``):
under ``row`` (``sharding/transfer.MeshRow``) model shard j runs experts
[j E/m, (j+1) E/m) on the block's tokens, dispatching locally (the
non-local assignments sorted last, which gives the local experts the slots
of the global dispatch), adds its experts' outputs in expert-ascending
order, and the shards' outputs are summed in ``x.dtype`` on shard 0. The
shared experts run as a dense MLP, column- and row-parallel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ref import top_k_lower_index_first
from repro_torch.models import layers as L

CAPACITY_FACTOR = 1.25


def moe_init(cfg: ArchConfig, normal, dtype=torch.float32):
    """Parameters of one MoE FFN from ``normal(shape, std)`` (a seeded
    float32 draw): the router (d, E) stays float32 whatever ``dtype`` is,
    as the reference's ``moe_init`` keeps it; ``wg``/``wu`` (E, d, de) with
    std 1/sqrt(d), ``wd`` (E, de, d) with 1/sqrt(de), drawn one expert at a
    time (a whole float32 draw of deepseek's (64, 2048, 1408) is 738 MB);
    ``shared`` a dense gated MLP of width de * n_shared_experts."""
    d, de, E = cfg.d_model, cfg.d_expert or cfg.d_ff, cfg.n_experts

    def experts(d_in, d_out):
        return torch.stack([normal((d_in, d_out), 1.0 / math.sqrt(d_in)).to(dtype)
                            for _ in range(E)])

    p = {"router": normal((d, E), 1.0 / math.sqrt(d)).float(),
         "wg": experts(d, de), "wu": experts(d, de), "wd": experts(de, d)}
    if cfg.n_shared_experts:
        ds = de * cfg.n_shared_experts
        p["shared"] = {"up": normal((d, ds), 1.0 / math.sqrt(d)).to(dtype),
                       "down": normal((ds, d), 1.0 / math.sqrt(ds)).to(dtype)}
        if cfg.gated_mlp:
            p["shared"]["gate"] = normal((d, ds), 1.0 / math.sqrt(d)).to(dtype)
    return p


def capacity(n_tokens: int, n_experts: int, top_k: int) -> int:
    """Slots an expert takes in a call of ``n_tokens`` tokens: the
    reference's ``_capacity``, max(4, roundup4(ceil(N * k / E * 1.25)))."""
    c = int(math.ceil(n_tokens * top_k / n_experts * CAPACITY_FACTOR))
    return max(4, -(-c // 4) * 4)


def route(cfg: ArchConfig, router_w, x):
    """x (N, d) -> gates (N, E) float32, topk_idx (N, k) int64 in
    ``jax.lax.top_k``'s order (descending, the lower index first on ties),
    topk_w (N, k) float32 renormalised with the reference's 1e-9 floor."""
    logits = x.float() @ router_w
    gates = torch.softmax(logits, dim=-1)
    topk_w, topk_idx = top_k_lower_index_first(gates, cfg.moe_top_k)
    topk_w = topk_w / torch.clamp(topk_w.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, topk_idx, topk_w


def dispatch(x, topk_idx, n_experts: int, cap: int, e_lo: int = 0, n_local=None):
    """The reference's sort-based ``_dispatch_local`` to the experts
    [e_lo, e_lo + n_local) (all of them by default): a stable argsort of the
    flat (token, k) expert ids, non-local ones last, each expert's start by
    ``searchsorted``, an assignment's slot its arrival rank within its
    expert; ranks ``>= cap`` and non-local assignments go to a drop row.

    Returns xg (E, C, d), E the local experts, the routed tokens gathered
    through the (E, C) token ids (N, a zero row, where a slot is empty), and
    pos (N, k) int64: where each assignment landed in the flat (E * C) slot
    order, E * C where it was dropped or is not local. The reference's
    weight matrix has no counterpart: the combine weighs each assignment
    through ``pos``."""
    N, k = topk_idx.shape
    dev = x.device
    flat_e = topk_idx.reshape(-1)
    part = n_local is not None and n_local != n_experts
    E = n_local if part else n_experts
    if part:                                 # non-local assignments sort last
        rel = flat_e - e_lo
        flat_e = torch.where((rel >= 0) & (rel < E), rel, torch.full_like(rel, E))
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    start = torch.searchsorted(se, torch.arange(E, device=dev, dtype=se.dtype))
    if part:
        slot = torch.arange(N * k, device=dev) - start[se.clamp(max=E - 1)]
        keep = (se < E) & (slot < cap)
    else:
        slot = torch.arange(N * k, device=dev) - start[se]
        keep = slot < cap
    drop = E * cap
    dest = torch.where(keep, se * cap + slot, torch.full_like(slot, drop))
    tok = torch.div(order, k, rounding_mode="floor")
    tok_flat = torch.full((drop + 1,), N, dtype=torch.int64, device=dev)
    tok_flat.scatter_(0, dest, torch.where(keep, tok, torch.full_like(tok, N)))
    pos = torch.empty_like(dest).scatter_(0, order, dest).view(N, k)
    x_pad = torch.cat([x, x.new_zeros((1, x.shape[1]))], dim=0)
    return x_pad[tok_flat[:drop].view(E, cap)], pos


def expert_ffn(cfg: ArchConfig, wg, wu, wd, xg):
    """xg (E, C, d) through each expert's MLP, batched over experts."""
    h = torch.bmm(xg, wu)
    if cfg.gated_mlp:
        h = L.act_fn(cfg.act)(torch.bmm(xg, wg)) * h
    else:
        h = L.act_fn(cfg.act)(h)
    return torch.bmm(h, wd)


def _combine(out, pos, topk_idx, topk_w, dtype):
    """y (N, d) in ``dtype``: each token's kept outputs times their weights
    (cast to ``dtype``), added to zeros in expert-ascending order; a dropped
    assignment reads the zero row past the last slot."""
    E, C, d = out.shape
    out_flat = torch.cat([out.reshape(E * C, d), out.new_zeros((1, d))], dim=0)
    perm = torch.argsort(topk_idx, dim=1)           # distinct experts: no ties
    pos = pos.gather(1, perm)
    w = topk_w.gather(1, perm).to(dtype)
    y = out.new_zeros((pos.shape[0], d), dtype=dtype)
    for j in range(pos.shape[1]):
        y = y + out_flat[pos[:, j]] * w[:, j, None]
    return y


def _onehot_sum(topk_idx, n_experts: int):
    """(N, E) float32: how many of a token's k assignments name each expert
    (``one_hot(...).sum(1)`` without one_hot's host-side range check)."""
    ar = torch.arange(n_experts, device=topk_idx.device)
    return (topk_idx[..., None] == ar).float().sum(dim=1)


def _moe_local(cfg: ArchConfig, p, x, cap: int, e_lo: int = 0, with_aux: bool = True):
    """x (N, d) through the experts [e_lo, e_lo + E_loc) of ``p``'s wg/wu/wd
    (E_loc of them) -> (y (N, d) in x's dtype, aux (N,) float32 or None)."""
    N = x.shape[0]
    E = cfg.n_experts
    gates, topk_idx, topk_w = route(cfg, p["router"], x)
    xg, pos = dispatch(x, topk_idx, E, cap, e_lo, p["wg"].shape[0])
    out = expert_ffn(cfg, p["wg"], p["wu"], p["wd"], xg)
    y = _combine(out, pos, topk_idx, topk_w, x.dtype)
    if not with_aux:
        return y, None
    f = _onehot_sum(topk_idx, E).mean(dim=0)
    aux = E * torch.sum(f * gates.mean(dim=0)) / cfg.moe_top_k
    return y, aux.expand(N)


def apply_moe(cfg: ArchConfig, p, x, row=None, n_blocks: int = 1):
    """x (B, T, d) -> (y (B, T, d), aux (B, T) float32): the routed experts
    over the call's B * T flattened tokens at ``capacity(B * T, E, k)``,
    plus the shared experts. ``aux`` is the load-balance term (training
    reads it; serving discards it).

    Under ``row`` (placed weights ``p``, ``x`` on shard 0) expert-parallel
    where the model axis divides E: the flat tokens are cut into
    ``n_blocks`` contiguous blocks, each routed on its own at ``capacity(B *
    T / n_blocks, E, k)`` with its own ``aux`` (computed on shard 0). Where
    it does not, the reference's replicated branch: the weights whole on
    shard 0 and one call over ``x``."""
    if row is not None and cfg.n_experts % row.m:
        return apply_moe(cfg, row.whole(p), x)
    B, T, d = x.shape
    if row is None:
        cap = capacity(B * T, cfg.n_experts, cfg.moe_top_k)
        y, aux = _moe_local(cfg, p, x.reshape(B * T, d), cap)
    else:
        y, aux = _moe_expert_parallel(cfg, p, x.reshape(B * T, d), row, n_blocks)
    y = y.reshape(B, T, d)
    if "shared" in p:
        y = y + L.apply_mlp(cfg, p["shared"], x, row=row)
    return y, aux.reshape(B, T)


def _moe_expert_parallel(cfg: ArchConfig, p, xf, row, n_blocks: int):
    m, E = row.m, cfg.n_experts
    assert E % m == 0, (E, m)
    n_local = E // m
    cap = capacity(xf.shape[0] // n_blocks, E, cfg.moe_top_k)
    local = [{"router": row.fetch(p["router"], j),
              **{key: row.fetch(p[key], j, dim=0) for key in ("wg", "wu", "wd")}}
             for j in range(m)]
    ys, auxs = [], []
    for xb in xf.chunk(n_blocks):
        xbs = row.broadcast(xb, "expert_sum")
        parts = []
        for j in range(m):
            y, aux = _moe_local(cfg, local[j], xbs[j], cap, j * n_local, with_aux=j == 0)
            parts.append(y)
            if j == 0:
                auxs.append(aux)
        ys.append(row.reduce(parts, "expert_sum"))
    return (ys[0], auxs[0]) if n_blocks == 1 else (torch.cat(ys), torch.cat(auxs))


def capacity_keep_mask(topk_idx, n_experts: int, cap: int):
    """(N, k) bool: which (token, k) assignments survive the capacity cut,
    by ``dispatch``'s arrival order (the flat (token, k) index within each
    expert). Tests and ``chip_smoke.py`` only."""
    N, k = topk_idx.shape
    flat_e = topk_idx.reshape(-1)
    onehot = (flat_e[:, None] == torch.arange(n_experts, device=flat_e.device)).to(torch.int64)
    arrival = torch.cumsum(onehot, dim=0) - onehot
    slot = arrival.gather(1, flat_e[:, None])[:, 0]
    return (slot < cap).reshape(N, k)


def moe_dense_reference(cfg: ArchConfig, p, x):
    """The capacity-aware O(E) oracle (reference ``moe_dense_reference``):
    every expert computes every token, dropped assignments weigh 0, the
    weighted sum in float32. Tests and ``chip_smoke.py`` only."""
    B, T, d = x.shape
    E = cfg.n_experts
    xf = x.reshape(B * T, d)
    gates, topk_idx, topk_w = route(cfg, p["router"], xf)
    keep = capacity_keep_mask(topk_idx, E, capacity(B * T, E, cfg.moe_top_k))
    full_w = torch.zeros_like(gates).scatter(1, topk_idx,
                                             torch.where(keep, topk_w, torch.zeros_like(topk_w)))
    outs = expert_ffn(cfg, p["wg"], p["wu"], p["wd"], xf.expand(E, B * T, d))
    y = torch.einsum("ne,end->nd", full_w, outs.float())
    y = y.to(x.dtype).reshape(B, T, d)
    if "shared" in p:
        y = y + L.apply_mlp(cfg, p["shared"], x)
    return y
