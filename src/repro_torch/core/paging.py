"""KV paging and the paper's hybrid layouts (reference ``repro/core/paging.py``).

The pool uses the **HND** layout ``(B, n_pages, kv, 2, p, d)``: the K+V block
of one (KV head, page) is contiguous, the recall's transfer unit. The device
rings use **NHD** ``(B, n, kv, d)``, so a decode append needs no transpose;
the NHD->HND transpose happens once per completed page.

With the quantized host tier (``fkv.kv_quant`` int8 or int4,
``repro_torch/quant``) the pool holds int8 (int4 packed two to a byte) and a
``pool_scale`` tensor holds the float32 scales; a page is quantized where
the NHD->HND transpose already happens. Summaries come from the keys before
quantization. Both places are one kernel that reads K and V once and writes
the summaries, the HND block and its scales: ``ops.fill_pages`` for the
bulk insert in ``prefill_fill_pool``, ``ops.complete_page`` for the page
completion in ``append_token``, masked on the card by the lengths there as
the reference's ``where`` is (no host branch, no host lengths). The
quantization parameters are read off the state itself (``quant_info``).

State updates are IN PLACE (the port's counterpart of the reference's buffer
donation): ``append_token`` writes the rings, the pool and the summaries of
the dict it is given and returns that same dict. With ``offload="host"`` the
pool and its scales are pinned host memory (``core/offload``): the prefill
fills a card-side block and moves it with one ``copy_(...,
non_blocking=True)`` a row on the current stream; a decode page completion
is written by the ``complete_page`` kernel at the pool's mapped device
address. Nothing else reads or writes the host pool on the card but the
``recall_gather`` and ``recall_gather_quant`` kernels.
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
    if fkv.sharded_retrieval and fkv.sharded_overselect > 1:
        # the fused step's over-selection (reference ``paging.py:47-50``): a
        # page shard holds up to overselect times its share of the pages
        n_sel *= fkv.sharded_overselect
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


def prefill_fill_pool(state, k, v, length):
    """Insert a prefill's K/V (B, T, kv, d) into pool + summaries + sink + ring.

    ``length`` (B,) is the per-row valid length (rows share T, left-padded).
    The T // p whole pages go through one ``ops.fill_pages`` launch; a
    pinned pool then takes its block with one device-to-host copy per row
    (two under the quantized tier: payload and scales)."""
    B, T, kv, d = k.shape
    n_sink = state["sink_k"].shape[1]
    n_win = state["win_k"].shape[1]
    if T < max(n_sink, n_win):
        raise ValueError(f"a {T}-token prompt is shorter than the sink ({n_sink}) "
                         f"or the window ring ({n_win})")
    pool, scale = state["pool"], state.get("pool_scale")
    n_full = T // pool.shape[4]
    if not ops.is_host_pool(pool, k.device):
        ops.fill_pages(k, v, state["summ"][:, :n_full], pool[:, :n_full],
                       None if scale is None else scale[:, :n_full])
    else:       # a pinned pool: fill a card-side block, moved by the copy engine
        blk = torch.empty((B, n_full) + pool.shape[2:], dtype=pool.dtype, device=k.device)
        sc = None if scale is None else torch.empty((B, n_full) + scale.shape[2:],
                                                     dtype=scale.dtype, device=k.device)
        ops.fill_pages(k, v, state["summ"][:, :n_full], blk, sc)
        for b in range(B):
            pool[b, :n_full].copy_(blk[b], non_blocking=True)
            if scale is not None:
                scale[b, :n_full].copy_(sc[b], non_blocking=True)

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


def ring_append(state, k_new, v_new):
    """Write one token's K/V (B, kv, d) into the window ring at slot
    ``length % n_win`` with its position, and advance ``length``, in place
    (the ring step of every paged and streaming state)."""
    B, n_win = state["win_k"].shape[:2]
    pos = state["length"]                          # (B,) position of the new token
    slot = (pos % n_win).long()
    bidx = torch.arange(B, device=pos.device)
    state["win_k"][bidx, slot] = k_new.to(state["win_k"].dtype)
    state["win_v"][bidx, slot] = v_new.to(state["win_v"].dtype)
    state["win_pos"][bidx, slot] = pos
    state["length"] = pos + 1
    return state


def append_token(state, k_new, v_new):
    """Append one token's K/V (B, kv, d); offload a page where one completes.

    Rows whose page completes this step write their ``(kv, 2, p, d)`` block
    to the pool (quantized under the quantized tier) and their min/max
    summary, in one ``ops.complete_page`` launch that reads the lengths on
    the card; the other rows write nothing. Nothing is read back and no
    host copy of the lengths is needed. Updates ``state`` in place and
    returns it."""
    ring_append(state, k_new, v_new)
    ops.complete_page(state["win_k"], state["win_v"], state["length"], state["summ"],
                      state["pool"], state.get("pool_scale"))
    return state
