"""xLSTM blocks, xlstm-350m's mixers (reference ``repro/models/xlstm.py``):
mLSTM (matrix memory) and sLSTM (scalar memory) [arXiv:2405.04517], each an
up-projection to (xm, z), the mixer over xm, and a down-projection of
``h * silu(z)``.

  xlstm_dims(cfg)                          -> (d_inner, heads, dv_head, dqk_head)
  mlstm_init(cfg, normal, dtype)           -> params
  mlstm_forward(cfg, p, x, return_state, chunk) -> y (B, T, d)[, state]
  mlstm_init_state(cfg, batch, device)     -> {"C", "n", "m"}
  mlstm_decode_step(cfg, p, x, state)      -> (y (B, 1, d), state)
  slstm_init / slstm_forward / slstm_init_state / slstm_decode_step, the same
  for the sLSTM, whose state is {"h", "c", "n", "m"}.
  mlstm_splits(cfg, m), mlstm_forward_mp(cfg, p, x, row, return_state),
  mlstm_decode_step_mp(cfg, p, x, states, row): the mLSTM over m shards.

The reference's arithmetic and dtypes: the gate weights and biases (``wi``,
``wf``, ``bf``; ``W``, ``R``, ``b``) are float32 whatever the other leaves'
dtype, the gates are computed in float32, and the states are float32 (mLSTM
``m`` starts at -1e30, sLSTM ``n`` at 1). ``mlstm_forward`` is the
reference's chunkwise-state stabilized form: a loop over chunks of ``chunk``
tokens carrying (C, n, m), the quadratic stabilized form inside a chunk, a
T that is no multiple of the chunk padded with ``log_i`` = -1e30 (padded
steps update nothing). The sLSTM scan is a Python loop over time, as
Mamba's; the input pre-activations ``xm @ W`` are computed once for all T
outside it. The reference scans it in chunks of 256 steps with the tail
zero-padded and returns the state after the padded steps (zero input
pre-activations, which do move the state); the port steps them too, so its
state, and the tokens decoded from it, are the reference's. A decode step
writes the new state into the state's tensors in place, so a slot's rows
stay where the slot pool put them. Nothing reads the card from the host.

**The mLSTM's model-parallel form** (``mlstm_forward_mp``,
``mlstm_decode_step_mp``) runs over the m model shards of one data group
(``sharding/transfer.MeshRow``), split by head where m divides the heads
(``mlstm_splits``): shard j holds heads [j nh / m, (j + 1) nh / m) and the
inner channels they make. ``up`` is column-parallel (block j of its ``xm``
half and of its ``z`` half); the ``xm`` blocks are gathered on every shard,
since each head's q, k, v and gates read all of ``xm``; ``wq``, ``wk``,
``wv``, ``wi``, ``wf`` and ``bf`` are split by head, so the recurrence runs
locally and moves nothing; ``down`` is row-parallel, reduced on shard 0.
Shard j's state is its heads' ``C``, ``n`` and ``m``. The reference's
``decode_state_spec`` splits ``C`` by dv and keeps ``n`` and ``m`` whole:
a difference by design (ROADMAP). The sLSTM has no such form: its ``R``
and its state are replicated in the reference, and the port runs it whole
on the group's shard 0.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig

NEG_INF = -1e30
# the reference's sLSTM scan chunk; its state is returned after the chunk's
# zero-padded tail
SLSTM_CHUNK = 256


def xlstm_dims(cfg: ArchConfig):
    di = int(cfg.xlstm_proj_factor * cfg.d_model)
    nh = cfg.n_heads
    di -= di % nh
    dqk = int(cfg.xlstm_qk_dim_factor * di)
    dqk -= dqk % nh
    return di, nh, di // nh, dqk // nh


def _softplus(x):
    """jax.nn.softplus: log(1 + exp(x)) with no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _dense(normal, d_in, d_out, dtype):
    return normal((d_in, d_out), 1.0 / math.sqrt(d_in)).to(dtype)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_init(cfg: ArchConfig, normal, dtype=torch.float32):
    """Parameters from ``normal(shape, std)`` (a seeded float32 draw), laid
    out as the reference's ``mlstm_init``: dense weights (d_in, d_out) with
    std 1/sqrt(d_in), ``wi``/``wf`` float32, the forget-gate bias ``bf`` = 3
    (remember)."""
    d = cfg.d_model
    di, nh, dv, dqk = xlstm_dims(cfg)
    up = _dense(normal, d, 2 * di, dtype)
    return {"up": up,
            "wq": _dense(normal, di, nh * dqk, dtype),
            "wk": _dense(normal, di, nh * dqk, dtype),
            "wv": _dense(normal, di, nh * dv, dtype),
            "wi": _dense(normal, di, nh, torch.float32),
            "wf": _dense(normal, di, nh, torch.float32),
            "bf": torch.full((nh,), 3.0, dtype=torch.float32, device=up.device),
            "down": _dense(normal, di, d, dtype)}


def _mlstm_qkvif(cfg, p, xm):
    """xm (B, T, di) -> q, k (B, T, nh, dqk), v (B, T, nh, dv), the gates'
    log_i, log_f (B, T, nh) float32, for the nh heads ``p`` holds."""
    B, T, _ = xm.shape
    _, _, dv, dqk = xlstm_dims(cfg)
    nh = p["wi"].shape[1]
    q = (xm @ p["wq"]).reshape(B, T, nh, dqk) / math.sqrt(dqk)
    k = (xm @ p["wk"]).reshape(B, T, nh, dqk)
    v = (xm @ p["wv"]).reshape(B, T, nh, dv)
    xf = xm.float()
    log_i = xf @ p["wi"]                                          # (B, T, nh)
    log_f = -_softplus(-(xf @ p["wf"] + p["bf"]))
    return q, k, v, log_i, log_f


def mlstm_forward(cfg: ArchConfig, p, x, return_state=False, chunk=256):
    """x (B, T, d) -> (B, T, d) [, the state after the last token]."""
    di = xlstm_dims(cfg)[0]
    xm, z = torch.split(x @ p["up"], di, dim=-1)
    h, state = _mlstm_chunks(*_mlstm_qkvif(cfg, p, xm), chunk, x.dtype)
    out = (h * F.silu(z)) @ p["down"]
    if return_state:
        return out, state
    return out


def _mlstm_chunks(q, k, v, log_i, log_f, chunk, dtype):
    """The chunkwise stabilized mLSTM over the heads of q/k/v (B, T, nh,
    ...) -> (h (B, T, nh * dv) at ``dtype``, the state after the last
    token)."""
    B, T, nh, dqk = q.shape
    dv = v.shape[-1]
    pad = (-T) % chunk
    if pad:                       # log_i = -1e30: padded steps update nothing
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=NEG_INF)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    dev = q.device
    idx = torch.arange(chunk, device=dev)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]    # (1, t, s, 1): s <= t
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    C = torch.zeros((B, nh, dqk, dv), dtype=torch.float32, device=dev)
    n = torch.zeros((B, nh, dqk), dtype=torch.float32, device=dev)
    m = torch.full((B, nh), NEG_INF, dtype=torch.float32, device=dev)
    hs = []
    for c0 in range(0, T + pad, chunk):
        sl = slice(c0, c0 + chunk)
        qf, kf, vf = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        ic, fc = log_i[:, sl], log_f[:, sl]
        b = torch.cumsum(fc, dim=1)                               # (B, t, nh)
        # intra-chunk decay logits d_ts = b_t - b_s + i_s (s <= t)
        dlog = b[:, :, None, :] - b[:, None, :, :] + ic[:, None, :, :]
        dlog = torch.where(causal, dlog, neg)
        m_intra = dlog.amax(dim=2)                                # (B, t, nh)
        # the carried state's contribution decays by b_t from the chunk start
        m_inter = b + m[:, None, :]
        m_t = torch.maximum(m_intra, m_inter)
        w = torch.exp(dlog - m_t[:, :, None, :])                  # (B, t, s, nh)
        qk = torch.einsum("bthd,bshd->bhts", qf, kf)
        sw = qk * w.permute(0, 3, 1, 2)                           # (B, nh, t, s)
        num = torch.einsum("bhts,bshd->bthd", sw, vf)
        den = sw.sum(dim=-1).transpose(1, 2)                      # (B, t, nh)
        wI = torch.exp(m_inter - m_t)
        num = num + torch.einsum("bthd,bhde,bth->bthe", qf, C, wI)
        den = den + torch.einsum("bthd,bhd->bth", qf, n) * wI
        h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
        hs.append(h.to(dtype))
        # the state at the chunk's end
        bL = b[:, -1, :]                                          # (B, nh)
        m_state = torch.maximum(bL + m, (bL[:, None] - b + ic).amax(dim=1))
        wS = torch.exp(bL[:, None] - b + ic - m_state[:, None])   # (B, s, nh)
        carry = torch.exp(bL + m - m_state)
        C = carry[:, :, None, None] * C + torch.einsum("bsh,bshd,bshe->bhde", wS, kf, vf)
        n = carry[:, :, None] * n + torch.einsum("bsh,bshd->bhd", wS, kf)
        m = m_state
    return torch.cat(hs, dim=1)[:, :T].reshape(B, T, nh * dv), {"C": C, "n": n, "m": m}


def mlstm_init_state(cfg: ArchConfig, batch: int, device="cuda"):
    _, nh, dv, dqk = xlstm_dims(cfg)
    dev = resolve_device(device)
    return {"C": torch.zeros((batch, nh, dqk, dv), dtype=torch.float32, device=dev),
            "n": torch.zeros((batch, nh, dqk), dtype=torch.float32, device=dev),
            "m": torch.full((batch, nh), NEG_INF, dtype=torch.float32, device=dev)}


def mlstm_decode_step(cfg: ArchConfig, p, x, state):
    """x (B, 1, d); state {"C" (B, nh, dqk, dv), "n" (B, nh, dqk), "m" (B,
    nh)}, float32 -> (y (B, 1, d), state), the state updated in place: the
    stabilized recurrent update."""
    di = xlstm_dims(cfg)[0]
    xm, z = torch.split(x @ p["up"], di, dim=-1)
    h = _mlstm_step(*_mlstm_qkvif(cfg, p, xm), state, x.dtype)
    return ((h * F.silu(z[:, 0])) @ p["down"])[:, None, :], state


def _mlstm_step(q, k, v, log_i, log_f, state, dtype):
    """One stabilized recurrent update of the heads of q/k/v (B, 1, nh, ...)
    -> h (B, nh * dv) at ``dtype``; ``state`` written in place."""
    B = q.shape[0]
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    log_i, log_f = log_i[:, 0], log_f[:, 0]                       # (B, nh)
    m_new = torch.maximum(log_f + state["m"], log_i)
    fw = torch.exp(log_f + state["m"] - m_new)[..., None]
    iw = torch.exp(log_i - m_new)[..., None]
    kf, vf = k.float(), v.float()
    C = fw[..., None] * state["C"] + iw[..., None] * kf[..., :, None] * vf[..., None, :]
    n = fw * state["n"] + iw * kf
    qf = q.float()
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n).abs(), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, -1).to(dtype)
    state["C"].copy_(C)
    state["n"].copy_(n)
    state["m"].copy_(m_new)
    return h


# ---------------------------------------------------------------------------
# the mLSTM's model-parallel form: heads split over a data group's shards
# ---------------------------------------------------------------------------
def mlstm_splits(cfg: ArchConfig, m: int) -> bool:
    """Whether m model shards split the mLSTM's heads (else it runs whole on
    the group's shard 0)."""
    return m > 1 and xlstm_dims(cfg)[1] % m == 0


def _head_block(cfg, p, row, j):
    """Shard j's heads of the placed weights ``p`` on its device: ``in_x``/
    ``in_z`` the columns of up's two halves, the projections and gates by
    head, ``down`` by row."""
    di = xlstm_dims(cfg)[0]
    n = di // row.m
    w = {"in_x": row.span(p["up"], j, 1, j * n, (j + 1) * n),
         "in_z": row.span(p["up"], j, 1, di + j * n, di + (j + 1) * n)}
    for key, dim in (("wq", 1), ("wk", 1), ("wv", 1), ("wi", 1), ("wf", 1), ("bf", 0),
                     ("down", 0)):
        w[key] = row.fetch(p[key], j, dim=dim)
    return w


def _mp_inputs(cfg, p, x, row):
    """x on shard 0 -> each shard's (weights, z block, xm gathered whole)."""
    xs = row.broadcast(x, "partial_sum")
    ws = [_head_block(cfg, p, row, j) for j in range(row.m)]
    xms = [xs[j] @ w["in_x"] for j, w in enumerate(ws)]
    gathered = [torch.cat([row.move(t, i, j, "partial_sum") for i, t in enumerate(xms)], dim=-1)
                for j in range(row.m)]
    return [(w, xs[j] @ w["in_z"], gathered[j]) for j, w in enumerate(ws)]


def mlstm_forward_mp(cfg: ArchConfig, p, x, row, return_state=False, chunk=256):
    """``mlstm_forward`` over ``row``'s m shards (``mlstm_splits``): x (B,
    T, d) on shard 0, ``p`` placed -> y (B, T, d) on shard 0 [, each
    shard's heads' state, on its device]."""
    parts, states = [], []
    for w, z, xm in _mp_inputs(cfg, p, x, row):
        h, st = _mlstm_chunks(*_mlstm_qkvif(cfg, w, xm), chunk, x.dtype)
        parts.append((h * F.silu(z)) @ w["down"])
        states.append(st)
    out = row.reduce(parts, "partial_sum")
    return (out, states) if return_state else out


def mlstm_decode_step_mp(cfg: ArchConfig, p, x, states, row):
    """``mlstm_decode_step`` over ``row``'s m shards: x (B, 1, d) on shard 0,
    ``states[j]`` shard j's heads' {"C", "n", "m"} -> (y (B, 1, d) on shard
    0, states), each updated in place."""
    parts = []
    for (w, z, xm), st in zip(_mp_inputs(cfg, p, x, row), states):
        h = _mlstm_step(*_mlstm_qkvif(cfg, w, xm), st, x.dtype)
        parts.append((h * F.silu(z[:, 0])) @ w["down"])
    return row.reduce(parts, "partial_sum")[:, None, :], states


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_init(cfg: ArchConfig, normal, dtype=torch.float32):
    """Parameters laid out as the reference's ``slstm_init``: ``W`` (di,
    4 di) the i, f, z, o input pre-activations, ``R`` (nh, 4 dh, dh) the
    block-diagonal recurrence (std 1/sqrt(dh)), ``b`` with the forget
    gate's bias 3, all three float32."""
    d = cfg.d_model
    di, nh, _, _ = xlstm_dims(cfg)
    dh = di // nh
    up = _dense(normal, d, 2 * di, dtype)
    dev = up.device
    b = torch.zeros((4 * di,), dtype=torch.float32, device=dev)
    b[di:2 * di] = 3.0
    return {"up": up,
            "W": _dense(normal, di, 4 * di, torch.float32),
            "R": normal((nh, 4 * dh, dh), 1.0 / math.sqrt(dh)),
            "b": b,
            "down": _dense(normal, di, d, dtype)}


def slstm_init_state(cfg: ArchConfig, batch: int, device="cuda"):
    di = xlstm_dims(cfg)[0]
    dev = resolve_device(device)

    def full(v):
        return torch.full((batch, di), v, dtype=torch.float32, device=dev)
    return {"h": full(0.0), "c": full(0.0), "n": full(1.0), "m": full(0.0)}


def _slstm_cell(cfg, p, xt, h, c, n, m):
    """xt (B, 4 di) float32 input pre-activations; the state's four (B, di)
    -> the new (h, c, n, m). The recurrence maps each head's dh -> 4 dh;
    the result is regrouped gate-major, as the reference's function
    computes (its line at ``_slstm_cell:204`` is overwritten by the next)."""
    B, di = h.shape
    nh = cfg.n_heads
    dh = di // nh
    rec = torch.einsum("bhd,hgd->bhg", h.reshape(B, nh, dh), p["R"])     # (B, nh, 4 dh)
    rec = rec.reshape(B, nh, 4, dh).transpose(1, 2).reshape(B, 4 * di)
    ig, fg, zg, og = torch.split(xt + rec + p["b"], di, dim=-1)
    log_f = -_softplus(-fg)
    m_new = torch.maximum(log_f + m, ig)
    iw = torch.exp(ig - m_new)
    fw = torch.exp(log_f + m - m_new)
    c = fw * c + iw * torch.tanh(zg)
    n = fw * n + iw
    h = torch.sigmoid(og) * c / torch.clamp(n, min=1e-6)
    return h, c, n, m_new


def slstm_forward(cfg: ArchConfig, p, x, return_state=False):
    """x (B, T, d) -> (B, T, d) [, the state after the last token and, as
    the reference's, the zero-input steps that pad T to a multiple of
    ``SLSTM_CHUNK``]."""
    B, T, _ = x.shape
    di = xlstm_dims(cfg)[0]
    xm, z = torch.split(x @ p["up"], di, dim=-1)
    pre = xm.float() @ p["W"]                                     # (B, T, 4 di)
    st = slstm_init_state(cfg, B, x.device)
    h, c, n, m = st["h"], st["c"], st["n"], st["m"]
    hs = []
    for t in range(T):
        h, c, n, m = _slstm_cell(cfg, p, pre[:, t], h, c, n, m)
        hs.append(h)
    out = (torch.stack(hs, dim=1).to(x.dtype) * F.silu(z)) @ p["down"]
    if return_state:
        zero = torch.zeros_like(pre[:, 0])
        for _ in range((-T) % SLSTM_CHUNK):
            h, c, n, m = _slstm_cell(cfg, p, zero, h, c, n, m)
        return out, {"h": h, "c": c, "n": n, "m": m}
    return out


def slstm_decode_step(cfg: ArchConfig, p, x, state):
    """x (B, 1, d); state {"h", "c", "n", "m"} (B, di) float32 -> (y (B, 1,
    d), state), the state updated in place."""
    di = xlstm_dims(cfg)[0]
    xm, z = torch.split(x @ p["up"], di, dim=-1)
    pre = xm[:, 0].float() @ p["W"]
    new = _slstm_cell(cfg, p, pre, state["h"], state["c"], state["n"], state["m"])
    out = ((new[0].to(x.dtype) * F.silu(z[:, 0])) @ p["down"])[:, None, :]
    for key, t in zip(("h", "c", "n", "m"), new):
        state[key].copy_(t)
    return out, state
