"""Mamba-1 selective SSM block, jamba's mixer (reference
``repro/models/ssm.py``), with the reference's arithmetic and dtypes:
``A_log``, ``D`` and the state ``h`` are float32, ``dt``, ``B`` and ``C``
are upcast to float32, and each step's ``y`` is cast back to the compute
dtype.

  mamba_dims(cfg)                          -> (d_inner, dt_rank, d_state, d_conv)
  mamba_init(cfg, normal, dtype)           -> params
  mamba_forward(cfg, p, x, return_state)   -> y (B, T, d)[, state]
  mamba_init_state(cfg, batch, dtype, device) -> {"h", "conv"}
  mamba_decode_step(cfg, p, x, state)      -> (y (B, 1, d), state)
  mamba_splits(cfg, m)                     -> whether d_inner divides m shards
  mamba_forward_mp(cfg, p, x, row, return_state)  -> y on shard 0[, states]
  mamba_decode_step_mp(cfg, p, x, states, row)    -> (y on shard 0, states)

The prefill's scan is a Python loop over time in torch ops (the reference's
256-token remat chunks serve only its backward pass). The decode step
writes the new ``h`` and ``conv`` into the state's tensors in place, at
their stored dtypes (the reference's ``astype(a.dtype)`` on the stacked
state), so a slot's rows stay where the slot pool put them. Nothing reads
the card from the host.

**The model-parallel form** (``_mp``, the reference's ``_di_shard``) runs
over the m model shards of one data group (``sharding/transfer.MeshRow``):
shard j holds d_inner block j. ``in_proj`` is column-parallel (block j of
its ``xm`` half and of its ``z`` half), ``conv_w``, ``conv_b``, ``dt_w``'s
columns, ``dt_b``, ``A_log`` and ``D`` are split by channel, so the conv
and the scan run locally; ``x_proj`` is row-parallel, its partial
``(dt, B, C)`` sums reduced on shard 0 and handed back to every shard, and
``out_proj`` is row-parallel, reduced on shard 0. Shard j's state is its
block of ``h`` (B, d_inner / m, ds) and of ``conv`` (B, dk - 1, d_inner /
m), the reference's ``decode_state_spec``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig


def mamba_dims(cfg: ArchConfig):
    di = cfg.ssm_expand * cfg.d_model
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return di, dt_rank, cfg.ssm_d_state, cfg.ssm_d_conv


def mamba_init(cfg: ArchConfig, normal, dtype=torch.float32):
    """Parameters from ``normal(shape, std)`` (a seeded float32 draw), laid
    out as the reference's ``mamba_init``: dense weights (d_in, d_out) with
    std 1/sqrt(d_in), the conv taps (d_conv, d_inner) with 1/sqrt(d_conv),
    ``dt_b`` = -4.6 (softplus^-1(0.01)), ``A_log`` = log(1..d_state) and
    ``D`` = 1 in float32."""
    d = cfg.d_model
    di, dt_rank, ds, dk = mamba_dims(cfg)

    def dense(d_in, d_out):
        return normal((d_in, d_out), 1.0 / math.sqrt(d_in)).to(dtype)

    w = dense(d, 2 * di)
    dev = w.device
    A = torch.arange(1, ds + 1, dtype=torch.float32, device=dev)[None, :].repeat(di, 1)
    return {
        "in_proj": w,
        "conv_w": normal((dk, di), 1.0 / math.sqrt(dk)).to(dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense(di, dt_rank + 2 * ds),
        "dt_w": dense(dt_rank, di),
        "dt_b": torch.full((di,), -4.6, dtype=dtype, device=dev),
        "A_log": torch.log(A),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": dense(di, d),
    }


def _mm(a, b):
    """a @ b at the promoted dtype (jnp's promotion of mixed operands)."""
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t) @ b.to(t)


def _ssm_split(cfg, p, dbl):
    """``xc @ x_proj`` (B, T, dt_rank + 2 ds) -> dt (B, T, di), Bm, Cm (B,
    T, ds), all float32 (di: the columns of ``p["dt_w"]``)."""
    _, dt_rank, ds, _ = mamba_dims(cfg)
    dt, Bm, Cm = torch.split(dbl, [dt_rank, ds, ds], dim=-1)
    dt = F.softplus(_mm(dt, p["dt_w"]) + p["dt_b"])
    return dt.float(), Bm.float(), Cm.float()


def _ssm_inputs(cfg, p, xc):
    """xc (B, T, di) after the conv -> dt (B, T, di), Bm, Cm (B, T, ds),
    all float32."""
    return _ssm_split(cfg, p, _mm(xc, p["x_proj"]))


def _causal_conv(p, x):
    """Depthwise causal conv over time: x (B, T, di) -> (B, T, di), the taps
    summed in the reference's order."""
    dk = p["conv_w"].shape[0]
    T = x.shape[1]
    xp = F.pad(x, (0, 0, dk - 1, 0))
    out = xp[:, 0:T] * p["conv_w"][0]
    for i in range(1, dk):
        out = out + xp[:, i:i + T] * p["conv_w"][i]
    return F.silu(out + p["conv_b"])


def _step(h, xt, dtt, Bt, Ct, A, D):
    """One recurrence step in float32: h (B, di, ds), xt/dtt (B, di), Bt/Ct
    (B, ds) -> (h, y (B, di))."""
    dA = torch.exp(dtt[..., None] * A)
    h = dA * h + (dtt * xt)[..., None] * Bt[:, None, :]
    y = torch.einsum("bis,bs->bi", h, Ct) + D * xt
    return h, y


def _scan(p, xc, dt, Bm, Cm, dtype):
    """The recurrence over time from a zero state: xc, dt (B, T, di) ->
    (h after the last token (B, di, ds) float32, y (B, T, di) at
    ``dtype``)."""
    B, T, di = xc.shape
    A = -torch.exp(p["A_log"])
    h = torch.zeros((B, di, A.shape[1]), dtype=torch.float32, device=xc.device)
    ys = []
    for t in range(T):
        h, y = _step(h, xc[:, t].float(), dt[:, t], Bm[:, t], Cm[:, t], A, p["D"])
        ys.append(y.to(dtype))
    return h, torch.stack(ys, dim=1)


def _conv_state(xm, dk):
    return F.pad(xm, (0, 0, dk - 1, 0))[:, -(dk - 1):].contiguous()


def mamba_forward(cfg: ArchConfig, p, x, return_state=False):
    """x (B, T, d) -> (B, T, d) [, the decode state after the last token]."""
    di, _, _, dk = mamba_dims(cfg)
    xm, z = torch.split(x @ p["in_proj"], di, dim=-1)
    xc = _causal_conv(p, xm)
    dt, Bm, Cm = _ssm_inputs(cfg, p, xc)
    h, y = _scan(p, xc, dt, Bm, Cm, x.dtype)
    out = (y * F.silu(z)) @ p["out_proj"]
    if return_state:
        return out, {"h": h, "conv": _conv_state(xm, dk)}
    return out


def mamba_init_state(cfg: ArchConfig, batch: int, dtype=torch.float32, device="cuda"):
    di, _, ds, dk = mamba_dims(cfg)
    dev = resolve_device(device)
    return {"h": torch.zeros((batch, di, ds), dtype=torch.float32, device=dev),
            "conv": torch.zeros((batch, dk - 1, di), dtype=dtype, device=dev)}


def mamba_decode_step(cfg: ArchConfig, p, x, state):
    """x (B, 1, d); state {"h": (B, di, ds) float32, "conv": (B, dk-1, di)}
    -> (y (B, 1, d), state), the state updated in place."""
    di = mamba_dims(cfg)[0]
    xm, z = torch.split(x[:, 0] @ p["in_proj"], di, dim=-1)
    conv = state["conv"]
    win = torch.cat([conv, xm[:, None]], dim=1)          # (B, dk, di), dtypes promoted
    t = torch.promote_types(win.dtype, p["conv_w"].dtype)
    xc = F.silu(torch.einsum("bki,ki->bi", win.to(t), p["conv_w"].to(t)) + p["conv_b"])
    dt, Bm, Cm = _ssm_inputs(cfg, p, xc[:, None])
    h, y = _step(state["h"], xc.float(), dt[:, 0], Bm[:, 0], Cm[:, 0], -torch.exp(p["A_log"]),
                 p["D"])
    y = y.to(x.dtype) * F.silu(z)
    out = (y @ p["out_proj"])[:, None]
    state["h"].copy_(h)
    conv.copy_(win[:, 1:])
    return out, state


# ---------------------------------------------------------------------------
# the model-parallel form: d_inner split over a data group's model shards
# ---------------------------------------------------------------------------
def mamba_splits(cfg: ArchConfig, m: int) -> bool:
    """Whether m model shards split d_inner (else the mixer runs whole on
    the group's shard 0)."""
    return m > 1 and mamba_dims(cfg)[0] % m == 0


def _di_block(cfg, p, row, j):
    """Shard j's d_inner block of the placed weights ``p`` on its device:
    ``in_x``/``in_z`` the columns of in_proj's two halves, the rest by
    channel (``x_proj`` and ``out_proj`` by row)."""
    di = mamba_dims(cfg)[0]
    n = di // row.m
    w = {"in_x": row.span(p["in_proj"], j, 1, j * n, (j + 1) * n),
         "in_z": row.span(p["in_proj"], j, 1, di + j * n, di + (j + 1) * n)}
    for key, dim in (("conv_w", 1), ("conv_b", 0), ("x_proj", 0), ("dt_w", 1), ("dt_b", 0),
                     ("A_log", 0), ("D", 0), ("out_proj", 0)):
        w[key] = row.fetch(p[key], j, dim=dim)
    return w


def _shared_dbl(row, dbls):
    """x_proj's partial products reduced on shard 0 and handed to every
    shard (an all-reduce)."""
    return row.broadcast(row.reduce(dbls, "partial_sum"), "partial_sum")


def mamba_forward_mp(cfg: ArchConfig, p, x, row, return_state=False):
    """``mamba_forward`` over ``row``'s m shards (``mamba_splits``): x (B,
    T, d) on shard 0, ``p`` placed -> y (B, T, d) on shard 0 [, each
    shard's state block, on its device]."""
    dk = mamba_dims(cfg)[3]
    xs = row.broadcast(x, "partial_sum")
    ws, xms, zs, xcs = [], [], [], []
    for j in range(row.m):
        w = _di_block(cfg, p, row, j)
        xm, z = xs[j] @ w["in_x"], xs[j] @ w["in_z"]
        ws.append(w)
        xms.append(xm)
        zs.append(z)
        xcs.append(_causal_conv(w, xm))
    dbls = _shared_dbl(row, [_mm(xc, w["x_proj"]) for xc, w in zip(xcs, ws)])
    parts, states = [], []
    for j, w in enumerate(ws):
        dt, Bm, Cm = _ssm_split(cfg, w, dbls[j])
        h, y = _scan(w, xcs[j], dt, Bm, Cm, x.dtype)
        parts.append((y * F.silu(zs[j])) @ w["out_proj"])
        states.append({"h": h, "conv": _conv_state(xms[j], dk)})
    out = row.reduce(parts, "partial_sum")
    return (out, states) if return_state else out


def mamba_decode_step_mp(cfg: ArchConfig, p, x, states, row):
    """``mamba_decode_step`` over ``row``'s m shards: x (B, 1, d) on shard
    0, ``states[j]`` shard j's block of {"h", "conv"} on its device ->
    (y (B, 1, d) on shard 0, states), each block updated in place."""
    xs = row.broadcast(x[:, 0], "partial_sum")
    ws, zs, wins, xcs = [], [], [], []
    for j in range(row.m):
        w = _di_block(cfg, p, row, j)
        xm, z = xs[j] @ w["in_x"], xs[j] @ w["in_z"]
        win = torch.cat([states[j]["conv"], xm[:, None]], dim=1)
        t = torch.promote_types(win.dtype, w["conv_w"].dtype)
        xc = F.silu(torch.einsum("bki,ki->bi", win.to(t), w["conv_w"].to(t)) + w["conv_b"])
        ws.append(w)
        zs.append(z)
        wins.append(win)
        xcs.append(xc)
    dbls = _shared_dbl(row, [_mm(xc[:, None], w["x_proj"]) for xc, w in zip(xcs, ws)])
    parts = []
    for j, w in enumerate(ws):
        dt, Bm, Cm = _ssm_split(cfg, w, dbls[j])
        h, y = _step(states[j]["h"], xcs[j].float(), dt[:, 0], Bm[:, 0], Cm[:, 0],
                     -torch.exp(w["A_log"]), w["D"])
        parts.append((y.to(x.dtype) * F.silu(zs[j])) @ w["out_proj"])
        states[j]["h"].copy_(h)
        states[j]["conv"].copy_(wins[j][:, 1:])
    return row.reduce(parts, "partial_sum")[:, None], states
