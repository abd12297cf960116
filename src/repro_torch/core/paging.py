"""KV paging and the paper's hybrid layouts (reference ``repro/core/paging.py``).

The pool uses the **HND** layout ``(B, n_pages, kv, 2, p, d)``: the K+V block
of one (KV head, page) is contiguous, the recall's transfer unit. The device
rings use **NHD** ``(B, n, kv, d)``, so a decode append needs no transpose;
the NHD->HND transpose happens once per completed page.

With the quantized host tier (``fkv.kv_quant`` int8 or int4,
``repro_torch/quant``) the pool holds int8 (int4 packed two to a byte) and a
``pool_scale`` tensor holds the float32 scales; a page is quantized where
the NHD->HND transpose already happens (page completion in
``append_token``, the bulk insert in ``prefill_fill_pool``), on the card,
before its copy to the pool. Summaries come from the keys before
quantization, through ``ops.page_summary``. The quantization parameters are
read off the state itself (``quant_info``).

State updates are IN PLACE (the port's counterpart of the reference's buffer
donation): ``append_token`` writes the rings, the pool and the summaries of
the dict it is given and returns that same dict. With ``offload="host"`` the
pool and its scales are pinned host memory (``core/offload``) and every pool
write is a ``copy_(..., non_blocking=True)`` from a card-side block on the
current stream; nothing reads the host pool except the ``recall_gather`` and
``recall_gather_quant`` kernels.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig, FreeKVConfig
from repro_torch.core import offload
from repro_torch.kernels import ops
from repro_torch.quant import quantizers as qz


def state_dims(cfg: ArchConfig, fkv: FreeKVConfig, max_len: int):
    p = fkv.page_size
    n_pages = -(-max_len // p)
    m = fkv.pool_pad_pages
    n_pages = -(-n_pages // m) * m
    n_sink = fkv.n_sink
    n_win = fkv.n_window + p          # ring slack so a completing page is present
    n_sel = max(1, (fkv.budget - fkv.n_sink - fkv.n_window) // p)
    return p, n_pages, n_sink, n_win, n_sel


def quant_info(state):
    """(bits, group_size) of a quantized-pool state, or None for an fp pool
    (reference ``paging.py:54``): a packed int4 pool is half the channel
    width of the rings, and the scales' group count fixes the group size."""
    if "pool_scale" not in state:
        return None
    d = state["win_k"].shape[-1]
    bits = 8 if state["pool"].shape[-1] == d else 4
    return bits, d // state["pool_scale"].shape[-1]


class QuantPool(NamedTuple):
    """The quantized pool as the recall sees it: the packed pages, their
    scales, the bit width and the dtype the recalled pages take (the
    device-side buffers')."""
    pool: torch.Tensor
    scale: torch.Tensor
    bits: int
    out_dtype: torch.dtype


def pool_view(state):
    """What the recall gathers from: the fp pool, or a ``QuantPool`` under
    the quantized tier (the reference's ``(pool, pool_scale)`` pair, which
    the retriever unpacks the same way)."""
    qi = quant_info(state)
    if qi is None:
        return state["pool"]
    return QuantPool(state["pool"], state["pool_scale"], qi[0], state["sel_k"].dtype)


def state_bytes(state) -> int:
    """Physical bytes of every tensor of a decode state (any nesting of dicts
    and lists): the packed payload at its packed width, the scales included."""
    if isinstance(state, dict):
        return sum(state_bytes(v) for v in state.values())
    if isinstance(state, (list, tuple)):
        return sum(state_bytes(v) for v in state)
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    return 0


def init_kv_state(cfg: ArchConfig, fkv: FreeKVConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cuda"):
    """Per-layer FreeKV decode state; under ``kv_quant`` the pool is int8 of
    width ``d * bits / 8`` with float32 ``pool_scale`` (B, n_pages, kv, 2,
    n_groups) beside it (reference ``paging.py:76``)."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    p, n_pages, n_sink, n_win, n_sel = state_dims(cfg, fkv, max_len)
    kv, d, H = cfg.n_kv_heads, cfg.d_head, cfg.n_heads

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    bits = fkv.quant_bits
    if bits:
        n_g = d // qz.effective_group(fkv.quant_group_size, d)
        pool = {"pool": offload.alloc_pool((batch, n_pages, kv, 2, p, d * bits // 8),
                                           torch.int8, fkv, dev),
                "pool_scale": offload.alloc_pool((batch, n_pages, kv, 2, n_g),
                                                 torch.float32, fkv, dev)}
    else:
        pool = {"pool": offload.alloc_pool((batch, n_pages, kv, 2, p, d), dtype, fkv, dev)}
    return {
        **pool,
        "summ": z(batch, n_pages, kv, 2, d),
        "sink_k": z(batch, n_sink, kv, d),
        "sink_v": z(batch, n_sink, kv, d),
        "win_k": z(batch, n_win, kv, d),
        "win_v": z(batch, n_win, kv, d),
        "win_pos": torch.full((batch, n_win), -1, dtype=torch.int32, device=dev),
        "sel_k": z(batch, kv, n_sel, p, d),
        "sel_v": z(batch, kv, n_sel, p, d),
        "sel_idx": torch.full((batch, kv, n_sel), -1, dtype=torch.int32, device=dev),
        "qprev": z(batch, H, d),
        "length": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


# ---------------------------------------------------------------------------
# per-slot state surgery (continuous batching)
# ---------------------------------------------------------------------------
# The decode state's leaves carry the batch on ``axis`` (0 for the port's
# per-layer dicts, ``pos`` and ``pos_host``). Continuous batching maps a
# request onto a physical row by writing one row in or reading one out, in
# place, on the card, in the pinned pool or on the CPU alike (reference
# ``paging.py:121,130``, whose functional updates XLA lowers in place).
def slot_write_leaf(dst, src, slot, axis=0):
    """Write ``src``'s singleton batch row into row ``slot`` of ``dst`` in
    place (cast to ``dst``'s dtype) and return ``dst``. A ``src`` that
    already is that row, the same memory, is left as it is."""
    row = dst.narrow(axis, slot, 1)
    if (src.data_ptr() == row.data_ptr() and src.shape == row.shape
            and src.stride() == row.stride() and src.dtype == row.dtype):
        return dst
    row.copy_(src)
    return dst


def slot_read_leaf(arr, slot, axis=0):
    """Row ``slot`` as a singleton-batch view of ``arr`` (the inverse of
    ``slot_write_leaf``); ``.clone()`` it for a copy."""
    return arr.narrow(axis, slot, 1)


def nhd_pages_to_hnd(k_pages, v_pages):
    """(B, n, p, kv, d) K and V -> pool block (B, n, kv, 2, p, d) (HND)."""
    return torch.stack([k_pages.transpose(2, 3), v_pages.transpose(2, 3)], dim=3)


def _host_ids(vals, dev):
    """A short host list of indices as an int64 tensor on ``dev``, without a
    host sync: a copy from pageable memory makes the host wait for the
    stream, one from pinned memory is queued like a kernel."""
    t = torch.tensor(vals, dtype=torch.int64)
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


def _write_pool(pool, rows, pages, blocks):
    """pool[rows[i], pages[i]...] = blocks[i] for a card-side ``blocks``:
    one non-blocking copy per row into a (possibly pinned host) pool."""
    for i, (b, pg) in enumerate(zip(rows, pages)):
        dst = pool[b, pg] if isinstance(pg, int) else pool[b, pg.start:pg.stop]
        dst.copy_(blocks[i], non_blocking=True)


def _offload_pages(state, rows, pages, hnd):
    """Write card-side HND blocks ``hnd`` (R, ..., kv, 2, p, d) to the pool
    rows ``rows`` at ``pages`` (ints, or slices of whole pages), quantized
    first under the quantized tier, payload and scales alike."""
    pool = state["pool"]
    qi = quant_info(state)
    if qi is None:
        _write_pool(pool, rows, pages, hnd.to(pool.dtype).contiguous())
        return
    q, scale = qz.quantize_block(hnd, *qi)
    _write_pool(pool, rows, pages, q.contiguous())
    _write_pool(state["pool_scale"], rows, pages, scale.contiguous())


def prefill_fill_pool(state, k, v, length):
    """Insert a prefill's K/V (B, T, kv, d) into pool + summaries + sink + ring.

    ``length`` (B,) is the per-row valid length (rows share T, left-padded).
    The pool write is one bulk device-to-host copy per row (two under the
    quantized tier: payload and scales)."""
    B, T, kv, d = k.shape
    n_sink = state["sink_k"].shape[1]
    n_win = state["win_k"].shape[1]
    if T < max(n_sink, n_win):
        raise ValueError(f"a {T}-token prompt is shorter than the sink ({n_sink}) "
                         f"or the window ring ({n_win})")
    p = state["pool"].shape[4]
    n_full = T // p
    kp = k[:, : n_full * p].reshape(B, n_full, p, kv, d)
    vp = v[:, : n_full * p].reshape(B, n_full, p, kv, d)
    _offload_pages(state, range(B), [slice(0, n_full)] * B, nhd_pages_to_hnd(kp, vp))
    summ = ops.page_summary(k[:, : n_full * p], page_size=p)      # (B,n,kv,2,d)
    state["summ"][:, :n_full] = summ.to(state["summ"].dtype)

    dt = state["win_k"].dtype
    state["sink_k"].copy_(k[:, :n_sink].to(dt))
    state["sink_v"].copy_(v[:, :n_sink].to(dt))
    # ring layout: the token at absolute position t lives in slot t % n_win
    tail = torch.arange(T - n_win, T, device=k.device)
    slots = tail % n_win
    state["win_k"].zero_()
    state["win_v"].zero_()
    state["win_k"][:, slots] = k[:, T - n_win:T].to(dt)
    state["win_v"][:, slots] = v[:, T - n_win:T].to(dt)
    state["win_pos"].fill_(-1)
    state["win_pos"][:, slots] = tail.to(torch.int32)[None].expand(B, n_win)
    state["length"] = torch.as_tensor(length, dtype=torch.int32,
                                      device=k.device).expand(B).clone()
    return state


def append_token(state, k_new, v_new, length_host=None):
    """Append one token's K/V (B, kv, d); offload a page where one completes.

    ``length_host`` is a CPU copy of ``state["length"]`` (the engine keeps
    one so the decode step needs no device read); without it the lengths
    are read back here. Rows whose page completes this step write their
    ``(kv, 2, p, d)`` block to the pool and their min/max summary; the other
    rows write nothing. Updates ``state`` in place and returns it."""
    B, n_win, kv, d = state["win_k"].shape
    p = state["pool"].shape[4]
    pos = state["length"]                          # (B,) position of the new token
    dev = pos.device
    slot = (pos % n_win).long()
    bidx = torch.arange(B, device=dev)
    state["win_k"][bidx, slot] = k_new.to(state["win_k"].dtype)
    state["win_v"][bidx, slot] = v_new.to(state["win_v"].dtype)
    state["win_pos"][bidx, slot] = pos
    state["length"] = pos + 1

    if length_host is None:
        length_host = pos.cpu()
    new_len = [int(x) + 1 for x in length_host]
    rows = [b for b in range(B) if new_len[b] % p == 0]
    if not rows:
        return state
    pages = [new_len[b] // p - 1 for b in rows]
    # the completed page's tokens, gathered from the ring
    pages_d = _host_ids(pages, dev)
    tok_pos = pages_d[:, None] * p + torch.arange(p, device=dev)
    tok_slot = tok_pos % n_win                                     # (R, p)
    ridx = _host_ids(rows, dev)
    pk = state["win_k"][ridx[:, None], tok_slot]                   # (R, p, kv, d)
    pv = state["win_v"][ridx[:, None], tok_slot]
    hnd = torch.stack([pk.transpose(1, 2), pv.transpose(1, 2)], dim=2)   # (R,kv,2,p,d)
    _offload_pages(state, rows, pages, hnd)
    summ = ops.page_summary(pk, page_size=p)[:, 0]                 # (R,kv,2,d)
    state["summ"][ridx, pages_d] = summ.to(state["summ"].dtype)
    return state
