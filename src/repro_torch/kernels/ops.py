"""Dispatch for the hand-written CUDA kernels (counterpart of the reference's
``repro/kernels/ops.py``).

Every wrapper takes the JAX layouts of its reference kernel. Tensors on the
CPU go to the plain version in ``kernels/ref.py``; tensors on a CUDA device
launch the kernel or raise — there is no fallback from the card to the plain
version. Each wrapper counts its kernel launches in ``<wrapper>.launches``
(incremented where the kernel is launched and nowhere else);
``reset_launches`` zeroes every count.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _on_cuda(t: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; other devices raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _dtype_code(*ts) -> int:
    dt = ts[0].dtype
    _require(dt in _DTYPE_CODE and all(t.dtype == dt for t in ts),
             f"kernel takes float32 or bfloat16 of one dtype, got "
             f"{[t.dtype for t in ts]}")
    return _DTYPE_CODE[dt]


def _one_dtype(*ts):
    """The inputs unchanged when they share a dtype, else all as float32
    (exact for bfloat16; the TPU kernels compute in float32 either way)."""
    if all(t.dtype == ts[0].dtype for t in ts):
        return ts
    return tuple(t.float() for t in ts)


def _check_cuda(dev, *ts):
    for t in ts:
        _require(t.device == dev, f"tensor on {t.device}, expected {dev}")
        _require(t.is_contiguous(), "kernel takes contiguous tensors")


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0


# ---------------------------------------------------------------------------
MAX_SPLIT = 256          # kMaxSplit in csrc/paged_attention.cu
MIN_PAGES_PER_SPLIT = 4  # fewer pages per block leave the kernel's ring part-empty
BLOCKS_PER_SM = 4        # the kernel's 32 KB ring and 128 registers a thread: four blocks an SM


def split_pages(N: int, rows: int, sms: int, blocks_per_sm: int = BLOCKS_PER_SM) -> int:
    """Number of slices paged attention cuts each (request, KV head)'s N
    pages into, for ``rows`` = B * kv such rows on a card of ``sms`` SMs:
    at most ``blocks_per_sm`` blocks per SM, each slice at least
    MIN_PAGES_PER_SPLIT pages (all N when N is fewer), at most MAX_SPLIT
    slices. Slice s holds pages ``split_range(N, n_split, s)``."""
    want = blocks_per_sm * sms // max(rows, 1)      # one wave: no block waits for a slot
    return max(1, min(MAX_SPLIT, want, N // MIN_PAGES_PER_SPLIT))


def split_range(N: int, n_split: int, s: int) -> tuple:
    """Pages [n0, n1) of slice s, as the kernel computes them."""
    return N * s // n_split, N * (s + 1) // n_split


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_TICKETS: dict = {}


def _tickets(dev, stream: int, n: int) -> torch.Tensor:
    """Zeroed int32 counters, one per (b, kv), for paged attention's merge;
    each launch leaves them zero again, so one buffer per device and stream
    serves every launch (launches on one stream never overlap)."""
    key = (dev.index, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=dev)
        _TICKETS[key] = buf
    return buf


def paged_attention(q, k_pages, v_pages, page_pos, cur_pos, *, scale,
                    softcap=None):
    """q (B,kv,G,d); k/v_pages (B,kv,N,p,d); page_pos (B,kv,N,p) int32;
    cur_pos (B,) int32 -> (B,kv,G,d) in q's dtype."""
    if not _on_cuda(q):
        return ref.paged_attention_ref(q, k_pages, v_pages, page_pos, cur_pos,
                                       scale, softcap)
    dev = q.device
    out_dtype = q.dtype
    q, k_pages, v_pages = _one_dtype(q, k_pages, v_pages)
    _check_cuda(dev, q, k_pages, v_pages, page_pos, cur_pos)
    code = _dtype_code(q, k_pages, v_pages)
    _require(page_pos.dtype == torch.int32 and cur_pos.dtype == torch.int32,
             "page_pos and cur_pos must be int32")
    B, kv, G, d = q.shape
    N, p = k_pages.shape[2], k_pages.shape[3]
    _require(k_pages.shape == (B, kv, N, p, d) and v_pages.shape == k_pages.shape
             and page_pos.shape == (B, kv, N, p) and cur_pos.shape == (B,),
             "paged_attention: shape mismatch")
    _require(G <= 16 and d <= 256 and p <= 64 and (d * q.element_size()) % 16 == 0
             and all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)),
             "paged_attention takes G <= 16, d <= 256 with 16-byte rows, p <= 64, "
             "16-byte aligned q/K/V")
    lib = build.load("paged_attention")
    n_split = split_pages(N, B * kv, _sm_count(dev.index))
    part_m = torch.empty((B, kv, n_split, G), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, kv, n_split, G, d), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    stream = _stream(dev)
    tickets = _tickets(dev, stream.value, B * kv)
    rc = lib.freekv_paged_attention(
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(page_pos), _ptr(cur_pos),
        _ptr(part_m), _ptr(part_l), _ptr(part_acc), _ptr(tickets), _ptr(out),
        B, kv, G, N, p, d, n_split, float(scale),
        float(softcap) if softcap is not None else 0.0, code, dev.index, stream)
    build.check(rc, "paged_attention")
    paged_attention.launches += 1
    return out.to(out_dtype)


def page_scores(q, summ, *, scale):
    """q (B,kv,G,d); summ (B,n_pages,kv,2,d) -> (B,kv,G,n_pages) float32."""
    if not _on_cuda(q):
        return ref.page_scores_ref(q, summ, scale)
    dev = q.device
    q, summ = _one_dtype(q, summ)
    _check_cuda(dev, q, summ)
    code = _dtype_code(q, summ)
    B, kv, G, d = q.shape
    N = summ.shape[1]
    _require(summ.shape == (B, N, kv, 2, d), "page_scores: shape mismatch")
    lib = build.load("page_scores")
    out = torch.empty((B, kv, G, N), dtype=torch.float32, device=dev)
    rc = lib.freekv_page_scores(_ptr(q), _ptr(summ), _ptr(out), B, kv, G, N, d,
                                float(scale), code, dev.index, _stream(dev))
    build.check(rc, "page_scores")
    page_scores.launches += 1
    return out


def centroid_scores(q, cent, count, *, scale):
    """q (B,kv,G,d); cent (B,C,kv,2,d) cluster boxes; count (B,C,kv) int32
    -> (B,kv,G,C) float32, exactly -1e30 where count == 0."""
    if not _on_cuda(q):
        return ref.centroid_scores_ref(q, cent, count, scale)
    dev = q.device
    q, cent = _one_dtype(q, cent)
    _check_cuda(dev, q, cent, count)
    code = _dtype_code(q, cent)
    B, kv, G, d = q.shape
    C = cent.shape[1]
    _require(cent.shape == (B, C, kv, 2, d) and count.shape == (B, C, kv)
             and count.dtype == torch.int32, "centroid_scores: shape or dtype mismatch")
    lib = build.load("page_scores")
    out = torch.empty((B, kv, G, C), dtype=torch.float32, device=dev)
    rc = lib.freekv_centroid_scores(_ptr(q), _ptr(cent), _ptr(count), _ptr(out), B, kv, G, C,
                                    d, float(scale), code, dev.index, _stream(dev))
    build.check(rc, "centroid_scores")
    centroid_scores.launches += 1
    return out


def device_pointer(t: torch.Tensor, device) -> ctypes.c_void_p:
    """The address at which ``device`` may read ``t``: its own for device
    memory, the mapped one for pinned host memory; raises otherwise."""
    lib = build.load("recall_gather")
    out = ctypes.c_void_p()
    rc = lib.freekv_device_pointer(_ptr(t), device.index, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(
            f"tensor at {t.data_ptr():#x} on {t.device} (pinned="
            f"{t.is_pinned() if t.device.type == 'cpu' else 'n/a'}) cannot be "
            f"read by {device}: cudaPointerGetAttributes gave error {rc}")
    return out


def _pool_pointer(pool: torch.Tensor, device) -> ctypes.c_void_p:
    """The address at which ``device`` reads ``pool``. A device pool is read
    at its own address; a pinned host pool is resolved by ``device_pointer``
    once and the result is kept on the tensor (keyed by its address and the
    device), so a decode step queries the driver for no launch."""
    if pool.device == device:
        return _ptr(pool)
    _require(pool.device.type == "cpu",
             f"pool on {pool.device} must be on {device} or in pinned host memory")
    key = (pool.data_ptr(), device.index)
    kept = getattr(pool, "_freekv_mapped", None)
    if kept is None or kept[0] != key:
        _require(pool.is_pinned(), "a host pool must be in pinned memory")
        kept = (key, device_pointer(pool, device))
        pool._freekv_mapped = kept
    return kept[1]


# ---------------------------------------------------------------------------
GATHER_WARPS = 8       # kThreads / 32 in csrc/recall_gather*.cu: each warp walks its own units
# SMs' worth of blocks in a gather from a pinned host pool: enough warps to
# keep the link full, and the rest of the card free for the main stream
HOST_GATHER_SMS = 32


def gather_grid(n_units: int, sms: int, blocks_per_sm: int, host: bool) -> int:
    """Blocks of a gather launch over ``n_units`` units (the K and V halves
    of each (request, KV head, lane) item, or the V halves alone) on a card
    of ``sms`` SMs that hold ``blocks_per_sm`` of its blocks at once. Every
    warp of the grid walks its units (``gather_items``), copying valid
    halves and zeroing those of -1 lanes. From a pinned host pool the grid is
    what HOST_GATHER_SMS SMs hold, so the link is kept full from a few SMs
    and the rest of the card stays free for the main stream; from a device
    pool, what every SM holds. Never more blocks than the units fill
    (GATHER_WARPS a block)."""
    _require(blocks_per_sm >= 1 and sms >= 1, "gather_grid: bad card")
    cap = (min(HOST_GATHER_SMS, sms) if host else sms) * blocks_per_sm
    return max(1, min(cap, -(-n_units // GATHER_WARPS)))


def gather_items(n_units: int, n_blocks: int, block: int) -> list:
    """The units block ``block`` of an ``n_blocks`` grid walks, as the
    kernels' ``walk_items`` does: its warp w is walker ``block *
    GATHER_WARPS + w`` of ``n_blocks * GATHER_WARPS``, and walker i takes
    units i, i + walkers, ... (unit u is half u % 2 of item u // 2 in a
    K+V gather, the V half of item u in a V-only one)."""
    walkers = n_blocks * GATHER_WARPS
    return [i for w in range(block * GATHER_WARPS, (block + 1) * GATHER_WARPS)
            for i in range(w, n_units, walkers)]


@functools.lru_cache(maxsize=None)
def gather_blocks_per_sm(source: str, index: int) -> int:
    """Blocks of the gathers in csrc/<source>.cu an SM holds at once (by
    registers and shared memory), asked of the runtime once per device."""
    lib = build.load(source)
    out = ctypes.c_int()
    build.check(getattr(lib, f"freekv_{source}_blocks_per_sm")(index, ctypes.byref(out)),
                f"{source} occupancy")
    return out.value


def _gather_blocks(source: str, pool: torch.Tensor, dev, n_units: int) -> int:
    return gather_grid(n_units, _sm_count(dev.index), gather_blocks_per_sm(source, dev.index),
                       host=pool.device != dev)


def recall_gather(pool, idx):
    """pool (B,n_pages,kv,2,p,d) HND; idx (B,kv,n_sel) int32 (-1 pad) -> k, v
    each (B,kv,n_sel,p,d) in the pool's dtype, on idx's device.

    Dispatches on ``idx``: the pool may be pinned host memory while the
    selection lives on the card, and the kernel reads it over the link."""
    if not _on_cuda(idx):
        return ref.recall_gather_ref(pool, idx)
    dev = idx.device
    _check_cuda(dev, idx)
    _require(pool.is_contiguous(), "pool must be contiguous")
    _require(idx.dtype == torch.int32, "idx must be int32")
    B, n_pages, kv, two, p, d = pool.shape
    n_sel = idx.shape[2]
    _require(two == 2 and idx.shape == (B, kv, n_sel), "recall_gather: shape mismatch")
    half = p * d * pool.element_size()
    _require(half % 16 == 0, "recall_gather: p * d * itemsize must be a multiple of 16")
    lib = build.load("recall_gather")
    src = _pool_pointer(pool, dev)
    k = torch.empty((B, kv, n_sel, p, d), dtype=pool.dtype, device=dev)
    v = torch.empty_like(k)
    grid = _gather_blocks("recall_gather", pool, dev, 2 * idx.numel())
    rc = lib.freekv_recall_gather(src, _ptr(idx), _ptr(k), _ptr(v), B, n_pages, kv, n_sel,
                                  half, grid, dev.index, _stream(dev))
    build.check(rc, "recall_gather")
    recall_gather.launches += 1
    return k, v


def recall_values(pool, idx):
    """ShadowKV's V-only recall: pool (B,n_pages,kv,2,p,d) HND; idx
    (B,kv,n_sel) int32 (-1 pad) -> v (B,kv,n_sel,p,d) in the pool's dtype,
    on idx's device. Reads only the V half of each block; no K is made.
    Dispatches on ``idx`` like ``recall_gather``."""
    if not _on_cuda(idx):
        return ref.recall_values_ref(pool, idx)
    dev = idx.device
    _check_cuda(dev, idx)
    _require(pool.is_contiguous(), "pool must be contiguous")
    _require(idx.dtype == torch.int32, "idx must be int32")
    B, n_pages, kv, two, p, d = pool.shape
    n_sel = idx.shape[2]
    _require(two == 2 and idx.shape == (B, kv, n_sel), "recall_values: shape mismatch")
    half = p * d * pool.element_size()
    _require(half % 16 == 0, "recall_values: p * d * itemsize must be a multiple of 16")
    lib = build.load("recall_gather")
    src = _pool_pointer(pool, dev)
    v = torch.empty((B, kv, n_sel, p, d), dtype=pool.dtype, device=dev)
    grid = _gather_blocks("recall_gather", pool, dev, idx.numel())
    rc = lib.freekv_recall_values(src, _ptr(idx), _ptr(v), B, n_pages, kv, n_sel, half, grid,
                                  dev.index, _stream(dev))
    build.check(rc, "recall_values")
    recall_values.launches += 1
    return v


def _quant_dims(pool, scales, idx, bits, out_dtype, what):
    """Checks shared by the quantized gathers -> (dtype code, B, n_pages, kv,
    n_sel, p, d, n_g)."""
    _check_cuda(idx.device, idx)
    _require(pool.is_contiguous() and scales.is_contiguous(),
             "pool and scales must be contiguous")
    _require(pool.dtype == torch.int8 and scales.dtype == torch.float32
             and idx.dtype == torch.int32,
             f"{what} takes an int8 pool, float32 scales and int32 idx")
    _require(bits in (8, 4), f"bits must be 8 or 4, got {bits}")
    code = _DTYPE_CODE.get(out_dtype)
    _require(code is not None, f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    B, n_pages, kv, two, p, dp = pool.shape
    d = dp * 8 // bits
    n_g = scales.shape[-1]
    n_sel = idx.shape[2]
    _require(two == 2 and scales.shape == (B, n_pages, kv, 2, n_g)
             and idx.shape == (B, kv, n_sel) and d % n_g == 0 and n_g <= 256,
             f"{what}: shape mismatch")
    _require(dp % 16 == 0, f"{what}: d * bits / 8 must be a multiple of 16")
    return code, B, n_pages, kv, n_sel, p, d, n_g


def recall_gather_quant(pool, scales, idx, *, bits, out_dtype=torch.float32):
    """pool (B,n_pages,kv,2,p,d*bits/8) int8 (int4 packed two to a byte);
    scales (B,n_pages,kv,2,n_g) float32; idx (B,kv,n_sel) int32 (< 0 pad)
    -> k, v each (B,kv,n_sel,p,d) in ``out_dtype``, on idx's device.

    Dispatches on ``idx`` like ``recall_gather``: the pool and its scales may
    be pinned host memory, read by the kernel over the link."""
    if not _on_cuda(idx):
        return ref.recall_gather_quant_ref(pool, scales, idx, bits, out_dtype)
    dev = idx.device
    code, B, n_pages, kv, n_sel, p, d, n_g = _quant_dims(pool, scales, idx, bits, out_dtype,
                                                         "recall_gather_quant")
    lib = build.load("recall_gather_quant")
    src, src_scales = _pool_pointer(pool, dev), _pool_pointer(scales, dev)
    k = torch.empty((B, kv, n_sel, p, d), dtype=out_dtype, device=dev)
    v = torch.empty_like(k)
    grid = _gather_blocks("recall_gather_quant", pool, dev, 2 * idx.numel())
    rc = lib.freekv_recall_gather_quant(src, src_scales, _ptr(idx), _ptr(k), _ptr(v), B,
                                        n_pages, kv, n_sel, p, d, n_g, bits, code, grid,
                                        dev.index, _stream(dev))
    build.check(rc, "recall_gather_quant")
    recall_gather_quant.launches += 1
    return k, v


def recall_values_quant(pool, scales, idx, *, bits, out_dtype=torch.float32):
    """V-only ``recall_gather_quant`` (ShadowKV on the quantized tier): the
    V half of each packed page and its V scales -> v (B,kv,n_sel,p,d) in
    ``out_dtype``, on idx's device."""
    if not _on_cuda(idx):
        return ref.recall_values_quant_ref(pool, scales, idx, bits, out_dtype)
    dev = idx.device
    code, B, n_pages, kv, n_sel, p, d, n_g = _quant_dims(pool, scales, idx, bits, out_dtype,
                                                         "recall_values_quant")
    lib = build.load("recall_gather_quant")
    src, src_scales = _pool_pointer(pool, dev), _pool_pointer(scales, dev)
    v = torch.empty((B, kv, n_sel, p, d), dtype=out_dtype, device=dev)
    grid = _gather_blocks("recall_gather_quant", pool, dev, idx.numel())
    rc = lib.freekv_recall_values_quant(src, src_scales, _ptr(idx), _ptr(v), B, n_pages, kv,
                                        n_sel, p, d, n_g, bits, code, grid, dev.index,
                                        _stream(dev))
    build.check(rc, "recall_values_quant")
    recall_values_quant.launches += 1
    return v


def page_summary(k, *, page_size):
    """k (B,T,kv,d) with T a whole number of pages -> (B,T/p,kv,2,d) per-page
    min and max in k's dtype. Rows of a CUDA ``k`` may sit any 16-byte
    multiple apart (a prefix of a longer prompt); the rest is contiguous."""
    if not _on_cuda(k):
        return ref.page_summary_ref(k, page_size)
    dev = k.device
    B, T, kv, d = k.shape
    p = page_size
    _require(T % p == 0 and T > 0, f"page_summary: T={T} is not a whole number of {p}-token pages")
    _require(k.stride(3) == 1 and k.stride(2) == d and k.stride(1) == kv * d,
             "page_summary: k must be contiguous past the batch dim")
    code = _dtype_code(k)
    _require((d * k.element_size()) % 16 == 0 and k.data_ptr() % 16 == 0
             and (k.stride(0) * k.element_size()) % 16 == 0,
             "page_summary takes 16-byte aligned rows of 16-byte multiples")
    lib = build.load("page_summary")
    out = torch.empty((B, T // p, kv, 2, d), dtype=k.dtype, device=dev)
    rc = lib.freekv_page_summary(_ptr(k), _ptr(out), B, T // p, p, kv, d, k.stride(0), code,
                                 dev.index, _stream(dev))
    build.check(rc, "page_summary")
    page_summary.launches += 1
    return out


def flash_prefill(q, k, v, *, scale, causal=True, window=None, softcap=None):
    """q (B,H,T,d); k/v (B,kv,T,d) -> (B,H,T,d) in q's dtype, float32 inside.

    CUDA inputs may be strided views (the last dim contiguous, 16-byte
    aligned rows), e.g. the model's (B,T,H,d) tensors transposed; the output
    is laid out like ``q``, so transposing it back is free."""
    if not _on_cuda(q):
        return ref.flash_prefill_ref(q, k, v, scale, causal, window, softcap)
    dev = q.device
    B, H, T, d = q.shape
    kv = k.shape[1]
    _require(k.shape == (B, kv, T, d) and v.shape == k.shape and H % kv == 0,
             "flash_prefill: shape mismatch")
    _require(d in (64, 128, 256), f"flash_prefill takes d_head 64, 128 or 256, got {d}")
    for t in (q, k, v):
        _require(t.device == dev, f"tensor on {t.device}, expected {dev}")
        _require(t.stride(3) == 1 and t.data_ptr() % 16 == 0
                 and all((s * t.element_size()) % 16 == 0 for s in t.stride()[:3]),
                 "flash_prefill: the last dim must be contiguous, rows 16-byte aligned")
    code = _dtype_code(q, k, v)
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *out.stride()[:3])
    lib = build.load("flash_prefill")
    rc = lib.freekv_flash_prefill(_ptr(q), _ptr(k), _ptr(v), _ptr(out), B, H, H // kv, T, d,
                                  strides, float(scale),
                                  float(softcap) if softcap is not None else 0.0,
                                  int(bool(causal)), int(window or 0), code, dev.index,
                                  _stream(dev))
    build.check(rc, "flash_prefill")
    flash_prefill.launches += 1
    return out


KERNELS = (paged_attention, page_scores, recall_gather, recall_gather_quant, page_summary,
           flash_prefill, recall_values, recall_values_quant, centroid_scores)
reset_launches()
