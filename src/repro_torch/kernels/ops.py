"""Dispatch for the hand-written CUDA kernels (counterpart of the reference's
``repro/kernels/ops.py``).

Every wrapper takes the JAX layouts of its reference kernel. Tensors on the
CPU go to the plain version in ``kernels/ref.py``; tensors on a CUDA device
launch the kernel or raise — there is no fallback from the card to the plain
version. Tensors on the meta device take the card's branch, with its checks,
up to the launch: nothing runs, and the wrapper returns empty outputs of the
kernel's shapes and dtypes (the cost model counts a step there,
``launch/op_cost``). Each wrapper counts its kernel launches in
``<wrapper>.launches`` (incremented where the kernel is launched and nowhere
else, so never on meta); ``reset_launches`` zeroes every count. Inside
``counting(counter)`` (``launch/op_cost``) each wrapper also reports the
launch, on the card once it launched and on meta in its place, with its cost
from ``kernels/cost.py``.
"""
from __future__ import annotations

import ctypes
import functools
import math
import weakref

import torch

from repro_torch.kernels import build, cost as kcost, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _on_cuda(t: torch.Tensor) -> bool:
    """Whether a wrapper takes the card's branch: True for CUDA tensors, which
    launch the kernel, and for meta tensors, which stop at the launch
    (``_launch``); False for CPU ones, which take the plain version; other
    devices raise."""
    if t.device.type in ("cuda", "meta"):
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


# the active launch counters (``launch/op_cost``), each with ``kernel(name, cost)``
_COUNTERS: list = []


class counting:  # noqa: N801  (a context manager, named as contextlib's are)
    """A context in which every kernel launch, on the card and on meta alike,
    is reported to ``counter`` (``counter.kernel(name, cost)``)."""

    def __init__(self, counter):
        self.counter = counter

    def __enter__(self):
        _COUNTERS.append(self.counter)
        return self.counter

    def __exit__(self, *exc):
        _COUNTERS.remove(self.counter)


def _report(fn, cost):
    """Reports one launch of ``fn``'s kernel to the active counters: on the
    card after it launched, on meta in its place. ``cost`` gives its
    ``kernels/cost`` cost and is called only when a counter is active."""
    if _COUNTERS:
        c = cost()
        for counter in _COUNTERS:
            counter.kernel(fn.__name__, c)


def _meta_launch(fn, dev, cost) -> bool:
    """True on meta, where the launch the card would make is reported and
    nothing runs (the wrapper returns its empty outputs); False on a CUDA
    device, which goes on to launch."""
    if dev.type != "meta":
        return False
    _report(fn, cost)
    return True


# the storages of the meta tensors that stand for pinned host pools
# (``core/offload.alloc_pool``); every view of such a pool shares its storage
_HOST_STORAGES = weakref.WeakSet()


def mark_host_pool(t: torch.Tensor) -> torch.Tensor:
    """Marks the meta tensor ``t`` as the stand-in for a pinned host pool:
    ``is_host_pool`` holds for it and for every view of it."""
    _require(t.device.type == "meta", "only a meta tensor stands for a host pool")
    _HOST_STORAGES.add(t.untyped_storage())
    return t


def is_host_pool(pool: torch.Tensor, dev) -> bool:
    """Whether ``dev`` reads ``pool`` from pinned host memory: a pool on
    another device than ``dev``'s, or on meta the stand-in for a host pool
    (``mark_host_pool``) or a view of it."""
    if pool.device != dev:
        return True
    return pool.device.type == "meta" and pool.untyped_storage() in _HOST_STORAGES


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


def _opt_ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None) if t is None else _ptr(t)


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
    serves every launch (launches on one stream never overlap). Tensor-
    parallel shards that share a card (``core/sharded_retrieval``) launch on
    its one current stream, one shard after the other, so they share the
    buffer safely; a shard on another card has its own."""
    key = (dev.index, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=dev)
        _TICKETS[key] = buf
    return buf


def paged_attention(q, k_pages, v_pages, page_pos, cur_pos, *, scale,
                    softcap=None, return_lse=False):
    """q (B,kv,G,d); k/v_pages (B,kv,N,p,d); page_pos (B,kv,N,p) int32;
    cur_pos (B,) int32 -> (B,kv,G,d) in q's dtype. ``return_lse``: the
    ``paged_attention_lse`` form, (out, lse)."""
    if return_lse:
        return paged_attention_lse(q, k_pages, v_pages, page_pos, cur_pos, scale=scale,
                                   softcap=softcap)
    return _paged_attention(paged_attention, q, k_pages, v_pages, page_pos, cur_pos, scale,
                            softcap)


def paged_attention_lse(q, k_pages, v_pages, page_pos, cur_pos, *, scale, softcap=None):
    """``paged_attention`` that returns its output in float32 (not rounded to
    q's dtype) and each (b, KV head, query row)'s log-sum-exp of its scaled
    (softcapped) scores, (B,kv,G) float32 natural log: the partial a page
    shard of the fused decode step hands to the merge
    (``core/sharded_retrieval``). Counted under its own name."""
    return _paged_attention(paged_attention_lse, q, k_pages, v_pages, page_pos, cur_pos, scale,
                            softcap)


def _paged_attention(fn, q, k_pages, v_pages, page_pos, cur_pos, scale, softcap):
    want_lse = fn is paged_attention_lse
    if not _on_cuda(q):
        if want_lse:
            return ref.paged_attention_lse_ref(q, k_pages, v_pages, page_pos, cur_pos, scale,
                                               softcap)
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
    # the lse form's output is float32, unrounded, for the merge of partials
    out = torch.empty(q.shape, dtype=torch.float32 if want_lse else q.dtype, device=dev)
    lse = torch.empty((B, kv, G), dtype=torch.float32, device=dev) if want_lse else None
    cost = functools.partial(kcost.paged_attention_lse if want_lse else kcost.paged_attention,
                             B, kv, G, N, p, d, q.element_size())
    if _meta_launch(fn, dev, cost):
        return (out, lse) if want_lse else out.to(out_dtype)
    lib = build.load("paged_attention")
    n_split = split_pages(N, B * kv, _sm_count(dev.index))
    part_m = torch.empty((B, kv, n_split, G), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, kv, n_split, G, d), dtype=torch.float32, device=dev)
    stream = _stream(dev)
    tickets = _tickets(dev, stream.value, B * kv)
    rc = lib.freekv_paged_attention(
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(page_pos), _ptr(cur_pos),
        _ptr(part_m), _ptr(part_l), _ptr(part_acc), _ptr(tickets),
        _opt_ptr(None if want_lse else out), _opt_ptr(lse), _opt_ptr(out if want_lse else None),
        B, kv, G, N, p, d, n_split, float(scale),
        float(softcap) if softcap is not None else 0.0, code, dev.index, stream)
    build.check(rc, fn.__name__)
    fn.launches += 1
    _report(fn, cost)
    return (out, lse) if want_lse else out.to(out_dtype)


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
    out = torch.empty((B, kv, G, N), dtype=torch.float32, device=dev)
    cost = functools.partial(kcost.page_scores, B, kv, G, N, d, q.element_size())
    if _meta_launch(page_scores, dev, cost):
        return out
    lib = build.load("page_scores")
    rc = lib.freekv_page_scores(_ptr(q), _ptr(summ), _ptr(out), B, kv, G, N, d,
                                float(scale), code, dev.index, _stream(dev))
    build.check(rc, "page_scores")
    page_scores.launches += 1
    _report(page_scores, cost)
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
    out = torch.empty((B, kv, G, C), dtype=torch.float32, device=dev)
    cost = functools.partial(kcost.centroid_scores, B, kv, G, C, d, q.element_size())
    if _meta_launch(centroid_scores, dev, cost):
        return out
    lib = build.load("page_scores")
    rc = lib.freekv_centroid_scores(_ptr(q), _ptr(cent), _ptr(count), _ptr(out), B, kv, G, C,
                                    d, float(scale), code, dev.index, _stream(dev))
    build.check(rc, "centroid_scores")
    centroid_scores.launches += 1
    _report(centroid_scores, cost)
    return out


# ---------------------------------------------------------------------------
# the fused selection kernels (csrc/page_scores.cu)
MAX_CLUSTER = 8      # kMaxCluster: the portable thread-block cluster size
SMEM_SCORES = 8192   # kSmemScores: G * pages whose scores a block keeps in shared memory
SMEM_KEYS = 2048     # kSmemKeys: pages a block ranks in shared memory
POOL_MODES = ("mean_softmax", "max_softmax", "mean_qk", "max_qk")


def select_split(N: int, rows: int, sms: int) -> int:
    """Blocks (one cluster) a fused selection kernel gives each of ``rows``
    (request, KV head) rows of N pages on a card of ``sms`` SMs: about one
    wave, and more where a block's pages would not fit its shared memory;
    at most MAX_CLUSTER and at most N. Block r takes pages
    ``split_range(N, S, r)``. The ids and pooled scores do not depend on S
    (the softmax's denominator is an integer sum, ``csrc/page_scores.cu``),
    so a row selects the same pages in a launch of any size: a
    tensor-parallel shard's, with half the rows, included."""
    want = max(sms // max(rows, 1), -(-N // SMEM_KEYS))
    return max(1, min(MAX_CLUSTER, N, want))


def _keys_workspace(dev, rows, S, nl):
    """Device memory for the keys of a block whose pages exceed SMEM_KEYS."""
    if nl <= SMEM_KEYS:
        return None
    return torch.empty((rows, S, 2 * nl), dtype=torch.int64, device=dev)


def select_pages(q, summ, length, *, n_sel, scale, page_size, n_sink, n_window,
                 mode="mean_softmax", cand=None, with_pooled=False, per_head=False,
                 keep_invalid=False):
    """Quest scores, selectable mask, group pooling and top-k in one launch.

    q (B,kv,G,d); summ (B,N,kv,2,d); length (B,) int32 -> idx (B,kv,n_sel)
    int32, -1 for invalid (ties: lower page id first); with ``with_pooled``
    also the pooled scores (B,kv,N) float32. ``cand`` (B,kv,m) int32 page
    ids (-1 invalid) scores only those pages, read in place: idx holds
    candidates' ids, ties break by candidate position, pooled is (B,kv,m).
    ``mode`` is one of POOL_MODES.

    ``per_head``: no pooling; each of the G query heads makes its own top-k
    over its own masked scores (Quest) -> idx (B,kv,G,n_sel), pooled the
    scores (B,kv,G,N); ``mode`` and ``cand`` do not apply. ``keep_invalid``:
    lanes whose value is -1e30 keep the page ids ``jax.lax.top_k`` gives
    them (lower ids first) instead of -1."""
    _require(mode in POOL_MODES, f"select_pages: unknown pooling mode {mode!r}")
    _require(not (per_head and cand is not None), "select_pages: per_head takes no candidates")
    if per_head:
        mode = "max_qk"        # over one query row: the row's own scores
    if not _on_cuda(q):
        idx, pooled = ref.select_pages_ref(q, summ, length, n_sel, scale, page_size, n_sink,
                                           n_window, mode, cand, per_head, keep_invalid)
        return (idx, pooled) if with_pooled else idx
    dev = q.device
    q, summ = _one_dtype(q, summ)
    _check_cuda(dev, q, summ, length, *(() if cand is None else (cand,)))
    code = _dtype_code(q, summ)
    B, kv, G, d = q.shape
    NP = summ.shape[1]
    N = NP if cand is None else cand.shape[2]
    _require(summ.shape == (B, NP, kv, 2, d) and length.shape == (B,)
             and length.dtype == torch.int32
             and (cand is None or (cand.shape == (B, kv, N) and cand.dtype == torch.int32)),
             "select_pages: shape or dtype mismatch")
    _require(G <= 16 and d <= 256 and N >= 1 and n_sel >= 1 and page_size >= 1,
             "select_pages takes G <= 16, d <= 256, at least one page and n_sel >= 1")
    # per head: B * kv * G rows of one query row each
    rows, g_row = (B * kv * G, 1) if per_head else (B * kv, G)
    lead = (B, kv, G) if per_head else (B, kv)
    idx = torch.empty(lead + (n_sel,), dtype=torch.int32, device=dev)
    pooled = torch.empty(lead + (N,), dtype=torch.float32, device=dev) if with_pooled else None
    cost = functools.partial(kcost.select_pages, B, kv, G, NP, d, n_sel, q.element_size(),
                             per_head=per_head, n_cand=0 if cand is None else N,
                             with_pooled=with_pooled)
    if _meta_launch(select_pages, dev, cost):
        return (idx, pooled) if with_pooled else idx
    lib = build.load("page_scores")
    S = select_split(N, rows, _sm_count(dev.index))
    nl = -(-N // S)
    ws_s = (torch.empty((rows, S, g_row, nl), dtype=torch.float32, device=dev)
            if g_row * nl > SMEM_SCORES else None)
    ws_k = _keys_workspace(dev, rows, S, nl)
    rc = lib.freekv_select_pages(
        _ptr(q), _ptr(summ), _ptr(length), _opt_ptr(cand), _ptr(idx), _opt_ptr(pooled),
        _opt_ptr(None), _opt_ptr(ws_s), _opt_ptr(ws_k), B, kv, G, N, NP, d, n_sel,
        min(n_sel, N), S, nl, page_size, n_sink, n_window, POOL_MODES.index(mode),
        int(per_head), int(keep_invalid), 0, float(scale), code, dev.index, _stream(dev))
    build.check(rc, "select_pages")
    select_pages.launches += 1
    _report(select_pages, cost)
    return (idx, pooled) if with_pooled else idx


def select_pages_shard(q, summ, length, *, page_lo, n_sel, scale, page_size, n_sink, n_window,
                       mode="mean_softmax"):
    """One page shard's selection in the fused decode step: summ (B,N,kv,2,d)
    holds the request's pages page_lo .. page_lo + N - 1; the selectable
    mask and the returned ids are the global pages', the pooling's softmax
    runs over the shard's N pages (reference ``sharded_retrieval.py:
    292-306``) -> (idx (B,kv,n_sel) int32, -1 for invalid, top (B,kv,n_sel)
    float32 the kept ids' pooled values, -1e30 past the valid lanes, for
    ``sharded_overselect``'s global re-rank). The ids do not depend on the
    launch's size, as ``select_pages``'. Counted under its own name."""
    _require(mode in POOL_MODES, f"select_pages_shard: unknown pooling mode {mode!r}")
    if not _on_cuda(q):
        return ref.select_pages_shard_ref(q, summ, length, n_sel, scale, page_size, n_sink,
                                          n_window, mode, page_lo)
    dev = q.device
    q, summ = _one_dtype(q, summ)
    _check_cuda(dev, q, summ, length)
    code = _dtype_code(q, summ)
    B, kv, G, d = q.shape
    N = summ.shape[1]
    _require(summ.shape == (B, N, kv, 2, d) and length.shape == (B,)
             and length.dtype == torch.int32 and page_lo >= 0,
             "select_pages_shard: shape or dtype mismatch")
    _require(G <= 16 and d <= 256 and N >= 1 and n_sel >= 1 and page_size >= 1,
             "select_pages_shard takes G <= 16, d <= 256, at least one page and n_sel >= 1")
    idx = torch.empty((B, kv, n_sel), dtype=torch.int32, device=dev)
    top = torch.empty((B, kv, n_sel), dtype=torch.float32, device=dev)
    cost = functools.partial(kcost.select_pages_shard, B, kv, G, N, d, n_sel, q.element_size())
    if _meta_launch(select_pages_shard, dev, cost):
        return idx, top
    lib = build.load("page_scores")
    rows = B * kv
    S = select_split(N, rows, _sm_count(dev.index))
    nl = -(-N // S)
    ws_s = (torch.empty((rows, S, G, nl), dtype=torch.float32, device=dev)
            if G * nl > SMEM_SCORES else None)
    ws_k = _keys_workspace(dev, rows, S, nl)
    rc = lib.freekv_select_pages(
        _ptr(q), _ptr(summ), _ptr(length), _opt_ptr(None), _ptr(idx), _opt_ptr(None), _ptr(top),
        _opt_ptr(ws_s), _opt_ptr(ws_k), B, kv, G, N, N, d, n_sel, min(n_sel, N), S, nl,
        page_size, n_sink, n_window, POOL_MODES.index(mode), 0, 0, int(page_lo), float(scale),
        code, dev.index, _stream(dev))
    build.check(rc, "select_pages_shard")
    select_pages_shard.launches += 1
    _report(select_pages_shard, cost)
    return idx, top


def centroid_candidates(q, cent, count, cent_assign, length, *, m, scale, page_size, n_sink,
                        n_window):
    """Stage 1 of centroid selection in one launch: q (B,kv,G,d) against the
    cluster boxes cent (B,C,kv,2,d) (count (B,C,kv) int32, empty clusters
    at -1e30), the max over G; each selectable page of cent_assign (B,N,kv)
    int32 inherits its cluster's score -> the top m page ids (B,kv,m)
    int32, ties in increasing page id, -1-padded."""
    if not _on_cuda(q):
        return ref.centroid_candidates_ref(q, cent, count, cent_assign, length, m, scale,
                                           page_size, n_sink, n_window)
    dev = q.device
    q, cent = _one_dtype(q, cent)
    _check_cuda(dev, q, cent, count, cent_assign, length)
    code = _dtype_code(q, cent)
    B, kv, G, d = q.shape
    C, N = cent.shape[1], cent_assign.shape[1]
    _require(cent.shape == (B, C, kv, 2, d) and count.shape == (B, C, kv)
             and cent_assign.shape == (B, N, kv) and length.shape == (B,)
             and all(t.dtype == torch.int32 for t in (count, cent_assign, length)),
             "centroid_candidates: shape or dtype mismatch")
    _require(G <= 16 and d <= 256 and 1 <= m <= N and (G + 1) * C <= SMEM_SCORES
             and page_size >= 1,
             "centroid_candidates takes G <= 16, d <= 256, 1 <= m <= N pages and "
             f"(G + 1) * C <= {SMEM_SCORES}")
    cand = torch.empty((B, kv, m), dtype=torch.int32, device=dev)
    cost = functools.partial(kcost.centroid_candidates, B, kv, G, C, N, d, m, q.element_size())
    if _meta_launch(centroid_candidates, dev, cost):
        return cand
    lib = build.load("page_scores")
    S = select_split(N, B * kv, _sm_count(dev.index))
    nl = -(-N // S)
    ws_k = _keys_workspace(dev, B * kv, S, nl)
    rc = lib.freekv_centroid_candidates(
        _ptr(q), _ptr(cent), _ptr(count), _ptr(cent_assign), _ptr(length), _ptr(cand),
        _opt_ptr(ws_k), B, kv, G, C, N, d, m, S, nl, page_size, n_sink, n_window, float(scale),
        code, dev.index, _stream(dev))
    build.check(rc, "centroid_candidates")
    centroid_candidates.launches += 1
    _report(centroid_candidates, cost)
    return cand


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
    k = torch.empty((B, kv, n_sel, p, d), dtype=pool.dtype, device=dev)
    v = torch.empty_like(k)
    cost = functools.partial(kcost.recall_gather, B, kv, n_sel, p, d, pool.element_size(),
                             host=is_host_pool(pool, dev))
    if _meta_launch(recall_gather, dev, cost):
        return k, v
    lib = build.load("recall_gather")
    src = _pool_pointer(pool, dev)
    grid = _gather_blocks("recall_gather", pool, dev, 2 * idx.numel())
    rc = lib.freekv_recall_gather(src, _ptr(idx), _ptr(k), _ptr(v), B, n_pages, kv, n_sel,
                                  half, grid, dev.index, _stream(dev))
    build.check(rc, "recall_gather")
    recall_gather.launches += 1
    _report(recall_gather, cost)
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
    v = torch.empty((B, kv, n_sel, p, d), dtype=pool.dtype, device=dev)
    cost = functools.partial(kcost.recall_values, B, kv, n_sel, p, d, pool.element_size(),
                             host=is_host_pool(pool, dev))
    if _meta_launch(recall_values, dev, cost):
        return v
    lib = build.load("recall_gather")
    src = _pool_pointer(pool, dev)
    grid = _gather_blocks("recall_gather", pool, dev, idx.numel())
    rc = lib.freekv_recall_values(src, _ptr(idx), _ptr(v), B, n_pages, kv, n_sel, half, grid,
                                  dev.index, _stream(dev))
    build.check(rc, "recall_values")
    recall_values.launches += 1
    _report(recall_values, cost)
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
    k = torch.empty((B, kv, n_sel, p, d), dtype=out_dtype, device=dev)
    v = torch.empty_like(k)
    cost = functools.partial(kcost.recall_gather_quant, B, kv, n_sel, p, d, bits, n_g,
                             k.element_size(), host=is_host_pool(pool, dev))
    if _meta_launch(recall_gather_quant, dev, cost):
        return k, v
    lib = build.load("recall_gather_quant")
    src, src_scales = _pool_pointer(pool, dev), _pool_pointer(scales, dev)
    grid = _gather_blocks("recall_gather_quant", pool, dev, 2 * idx.numel())
    rc = lib.freekv_recall_gather_quant(src, src_scales, _ptr(idx), _ptr(k), _ptr(v), B,
                                        n_pages, kv, n_sel, p, d, n_g, bits, code, grid,
                                        dev.index, _stream(dev))
    build.check(rc, "recall_gather_quant")
    recall_gather_quant.launches += 1
    _report(recall_gather_quant, cost)
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
    v = torch.empty((B, kv, n_sel, p, d), dtype=out_dtype, device=dev)
    cost = functools.partial(kcost.recall_values_quant, B, kv, n_sel, p, d, bits, n_g,
                             v.element_size(), host=is_host_pool(pool, dev))
    if _meta_launch(recall_values_quant, dev, cost):
        return v
    lib = build.load("recall_gather_quant")
    src, src_scales = _pool_pointer(pool, dev), _pool_pointer(scales, dev)
    grid = _gather_blocks("recall_gather_quant", pool, dev, idx.numel())
    rc = lib.freekv_recall_values_quant(src, src_scales, _ptr(idx), _ptr(v), B, n_pages, kv,
                                        n_sel, p, d, n_g, bits, code, grid, dev.index,
                                        _stream(dev))
    build.check(rc, "recall_values_quant")
    recall_values_quant.launches += 1
    _report(recall_values_quant, cost)
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
    out = torch.empty((B, T // p, kv, 2, d), dtype=k.dtype, device=dev)
    cost = functools.partial(kcost.page_summary, B, T, kv, d, p, k.element_size())
    if _meta_launch(page_summary, dev, cost):
        return out
    lib = build.load("page_summary")
    rc = lib.freekv_page_summary(_ptr(k), _ptr(out), B, T // p, p, kv, d, k.stride(0), code,
                                 dev.index, _stream(dev))
    build.check(rc, "page_summary")
    page_summary.launches += 1
    _report(page_summary, cost)
    return out


# ---------------------------------------------------------------------------
# the page-fill kernels (csrc/page_summary.cu)
FILL_THREADS = 128       # threads a prefill block aims at: a few blocks an SM in one wave
FILL_MAX_THREADS = 512   # kFillMaxThreads


def fill_heads_per_block(kv: int, d: int, itemsize: int, threads: int) -> int:
    """KV heads one block of the page-fill kernels covers: a head takes 2 *
    d * itemsize / 16 threads (one 16-byte chunk of its K row and one of its
    V row); the largest divisor of kv whose block stays within ``threads``,
    at least one."""
    per_head = 2 * d * itemsize // 16
    _require(per_head <= FILL_MAX_THREADS,
             f"the page-fill kernels take d * itemsize <= {FILL_MAX_THREADS * 8} bytes")
    return max(h for h in range(1, kv + 1) if kv % h == 0 and (h == 1 or h * per_head <= threads))


def _fill_outputs(summ, pool, scale, B, n, kv, d, what):
    """Checks of the page-fill outputs -> (bits, n_g, p): summ (B, n, kv, 2,
    d), pool (B, n, kv, 2, p, dp) and scale (B, n, kv, 2, n_g) or None, each
    contiguous past its batch dim; the pool int8 exactly where scale is
    given (int4 where dp = d / 2)."""
    p, dp = pool.shape[4], pool.shape[5]
    _require(summ.shape == (B, n, kv, 2, d) and pool.shape[:4] == (B, n, kv, 2),
             f"{what}: shape mismatch")
    if scale is None:
        bits, n_g = 0, 0
        _require(pool.dtype == summ.dtype and dp == d,
                 f"{what}: an unquantized pool takes the summaries' dtype and width")
    else:
        bits = 8 if dp == d else 4
        n_g = scale.shape[-1]
        _require(pool.dtype == torch.int8 and scale.dtype == torch.float32 and dp * 8 // bits == d
                 and scale.shape == (B, n, kv, 2, n_g) and n_g >= 1 and d % n_g == 0,
                 f"{what}: a quantized pool is int8 of width d or d / 2 with float32 scales")
    for t in (summ, pool) + (() if scale is None else (scale,)):
        _require(t[0].is_contiguous() and t.data_ptr() % 16 == 0,
                 f"{what}: outputs must be contiguous past the batch dim, 16-byte aligned")
    return bits, n_g, p


def _bs(t) -> int:
    """Elements between the batch rows of ``t``. A lone row's stride is
    whatever PyTorch left on a size-1 dim, so the row's size stands in."""
    return t.stride(0) if t.shape[0] > 1 else t[0].numel()


def fill_pages(k, v, summ, pool, scale=None):
    """The prefill's pool fill in one pass over K and V, written in place:
    k, v (B, T, kv, d) -> for the n = pool.shape[1] first whole pages, summ
    (B, n, kv, 2, d) their keys' min and max in summ's dtype, pool (B, n,
    kv, 2, p, dp) their HND blocks, in summ's dtype or, with ``scale`` (B,
    n, kv, 2, n_g) float32, quantized to int8 (int4 packed two to a byte
    where dp = d / 2) as ``quantize_block`` does. Every tensor may be a view
    whose batch rows lie any 16-byte multiple apart (a prefix of a longer
    prompt, the first pages of the state's summaries); on a CUDA device the
    outputs must be on it too."""
    if not _on_cuda(k):
        return ref.fill_pages_ref(k, v, summ, pool, scale)
    dev = k.device
    B, T, kv, d = k.shape
    n = pool.shape[1]
    bits, n_g, p = _fill_outputs(summ, pool, scale, B, n, kv, d, "fill_pages")
    _require(v.shape == k.shape and v.dtype == k.dtype and n * p <= T,
             f"fill_pages: {n} pages of {p} need T >= {n * p} tokens of k and v alike")
    for t in (k, v, summ, pool) + (() if scale is None else (scale,)):
        _require(t.device == dev, f"tensor on {t.device}, expected {dev}")
    for t in (k, v):
        _require(t.stride(3) == 1 and t.stride(2) == d and t.stride(1) == kv * d
                 and t.data_ptr() % 16 == 0 and (t.stride(0) * t.element_size()) % 16 == 0,
                 "fill_pages: k and v must be contiguous past the batch dim, rows 16-byte "
                 "aligned")
    hpb = fill_heads_per_block(kv, d, k.element_size(), FILL_THREADS)
    cost = functools.partial(kcost.fill_pages, B, n, p, kv, d, k.element_size(),
                             summ.element_size(), bits=bits, n_g=n_g)
    if _meta_launch(fill_pages, dev, cost):
        return
    lib = build.load("page_summary")
    rc = lib.freekv_fill_pages(
        _ptr(k), _ptr(v), _bs(k), _bs(v), _ptr(summ), _bs(summ), _ptr(pool), _bs(pool),
        _opt_ptr(scale), 0 if scale is None else _bs(scale), B, n, p, kv, d, n_g, bits,
        _dtype_code(k), _dtype_code(summ), hpb, dev.index, _stream(dev))
    build.check(rc, "fill_pages")
    fill_pages.launches += 1
    _report(fill_pages, cost)


def complete_page(win_k, win_v, length, summ, pool, scale=None):
    """The decode's page completion, masked on the device, in place: with
    ``length`` (B,) int32 the post-append lengths, row b whose length is a
    whole number of pages gathers page length // p - 1 from its window rings
    win_k / win_v (B, n_win, kv, d) (token i at slot i % n_win) and writes
    its summary to summ[b, page] (B, n_pages, kv, 2, d), its HND block to
    pool[b, page] (B, n_pages, kv, 2, p, dp) and its scales to scale[b,
    page]; other rows write nothing. One launch whatever the lengths, no
    host read, no allocation: the pool and its scales may be pinned host
    memory, written at their mapped device addresses."""
    return _complete_page(complete_page, win_k, win_v, length, summ, pool, scale, 0)


def complete_page_shard(win_k, win_v, length, summ, pool, scale=None, *, page_lo):
    """``complete_page`` into one page shard's range of the pool: summ,
    pool and scale hold pages page_lo .. page_lo + n_pages - 1, and a row
    writes its completed page only where it lies in that range, at its
    place there (reference ``sharded_retrieval.py:271-290``). Counted under
    its own name."""
    return _complete_page(complete_page_shard, win_k, win_v, length, summ, pool, scale,
                          page_lo)


def _complete_page(fn, win_k, win_v, length, summ, pool, scale, page_lo):
    if not _on_cuda(length):
        return ref.complete_page_ref(win_k, win_v, length, summ, pool, scale, page_lo)
    dev = length.device
    B, n_win, kv, d = win_k.shape
    bits, n_g, p = _fill_outputs(summ, pool, scale, B, pool.shape[1], kv, d, fn.__name__)
    _check_cuda(dev, win_k, win_v, length, summ)
    _require(win_v.shape == win_k.shape and win_v.dtype == win_k.dtype == summ.dtype
             and length.shape == (B,) and length.dtype == torch.int32 and page_lo >= 0,
             f"{fn.__name__}: the rings and the summaries share a dtype; int32 lengths (B,)")
    cost = functools.partial(kcost.complete_page_shard if fn is complete_page_shard
                             else kcost.complete_page, B, p, kv, d, win_k.element_size(),
                             host=is_host_pool(pool, dev), bits=bits, n_g=n_g)
    if _meta_launch(fn, dev, cost):
        return
    lib = build.load("page_summary")
    rc = lib.freekv_complete_page(
        _ptr(win_k), _ptr(win_v), _ptr(length), _ptr(summ), _bs(summ),
        _pool_pointer(pool, dev), _bs(pool),
        ctypes.c_void_p(None) if scale is None else _pool_pointer(scale, dev),
        0 if scale is None else _bs(scale), B, n_win, pool.shape[1], p, kv, d, n_g, bits,
        # one head a block: the most SMs writing over the link
        _dtype_code(win_k), fill_heads_per_block(kv, d, win_k.element_size(), 0),
        int(page_lo), dev.index, _stream(dev))
    build.check(rc, fn.__name__)
    fn.launches += 1
    _report(fn, cost)


def flash_prefill(q, k, v, *, scale, causal=True, window=None, softcap=None):
    """q (B,H,Tq,d); k/v (B,kv,Tk,d) with Tk >= Tq -> (B,H,Tq,d) in q's
    dtype, float32 inside. Query row i sits at absolute position Tk - Tq + i,
    so the causal mask aligns bottom-right: Tq == Tk is a whole prompt, Tq <
    Tk a prompt's suffix (an extension chunk) over its prefix's keys.

    CUDA inputs may be strided views (the last dim contiguous, 16-byte
    aligned rows), e.g. the model's (B,T,H,d) tensors transposed; the output
    is laid out like ``q``, so transposing it back is free."""
    if not _on_cuda(q):
        return ref.flash_prefill_ref(q, k, v, scale, causal, window, softcap)
    dev = q.device
    B, H, Tq, d = q.shape
    kv, Tk = k.shape[1], k.shape[2]
    _require(k.shape == (B, kv, Tk, d) and v.shape == k.shape and H % kv == 0 and Tk >= Tq,
             "flash_prefill: shape mismatch (q (B,H,Tq,d), k/v (B,kv,Tk,d), Tk >= Tq)")
    _require(d in (64, 80, 128, 256), f"flash_prefill takes d_head 64, 80, 128 or 256, got {d}")
    for t in (q, k, v):
        _require(t.device == dev, f"tensor on {t.device}, expected {dev}")
        _require(t.stride(3) == 1 and t.data_ptr() % 16 == 0
                 and all((s * t.element_size()) % 16 == 0 for s in t.stride()[:3]),
                 "flash_prefill: the last dim must be contiguous, rows 16-byte aligned")
    code = _dtype_code(q, k, v)
    out = torch.empty_like(q)
    cost = functools.partial(kcost.flash_prefill, B, H, kv, Tq, Tk, d, q.element_size(),
                             causal=causal, window=window)
    if _meta_launch(flash_prefill, dev, cost):
        return out
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *out.stride()[:3])
    lib = build.load("flash_prefill")
    rc = lib.freekv_flash_prefill(_ptr(q), _ptr(k), _ptr(v), _ptr(out), B, H, H // kv, Tq, Tk, d,
                                  strides, float(scale),
                                  float(softcap) if softcap is not None else 0.0,
                                  int(bool(causal)), int(window or 0), code, dev.index,
                                  _stream(dev))
    build.check(rc, "flash_prefill")
    flash_prefill.launches += 1
    _report(flash_prefill, cost)
    return out


KERNELS = (paged_attention, page_scores, recall_gather, recall_gather_quant, page_summary,
           flash_prefill, recall_values, recall_values_quant, centroid_scores, select_pages,
           centroid_candidates, fill_pages, complete_page, paged_attention_lse,
           select_pages_shard, complete_page_shard)
reset_launches()
