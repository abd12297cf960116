"""Centroid-then-token page selection for ``method="centroid"`` (reference
``repro/core/centroid_index.py``).

A CTkvr-style two-level index over the page summaries:

  * per-(layer, KV head) centroids partition the pages into
    ``fkv.centroid_count`` clusters (k-means on page-summary midpoints);
  * each cluster carries the elementwise min/max of its member pages'
    (lo, hi) summaries, so the Quest score of a query against the cluster
    box bounds the score of every member page;
  * selection scores the query against the C boxes, lets pages inherit
    their cluster's pooled bound and keeps the top ``COVER_PAGES_FACTOR *
    n_sel`` candidates (the ``centroid_candidates`` kernel), then scores,
    pools and ranks only those (``select_pages`` with candidates).

Incremental maintenance equals a full ``rebuild`` from (summaries, mean
snapshot, length) bit for bit at any time: the means change only at the
prefill build and at the periodic re-center; every page is assigned by the
same function of (its summary, the snapshot); counts are integer sums and
boxes min/max merges, which no order changes. Two things the reference gets
from XLA are made explicit here, because on the card the order of a float
sum can change with the tensor's shape and float ``index_add_`` uses
atomics: ``_dist2`` sums each distance in float64 and rounds once, so a
one-page and an all-pages call give the same bits; ``recompute_means``
accumulates the member midpoints in float64 and rounds the sum once, so no
summation order shows.

State leaves (updated in place, like the rest of the decode state):

  cent        (B, C, kv, 2, d)   cluster bounding boxes (lo, hi)
  cent_mean   (B, C, kv, d) f32  centroid means (the assignment snapshot)
  cent_assign (B, n_pages, kv)   page -> cluster id, -1 = not offloaded
  cent_count  (B, C, kv) int32   member pages per cluster
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, FreeKVConfig
from repro_torch.core import selection
from repro_torch.kernels import ops

# candidate pages kept after stage 1, as a multiple of n_sel
COVER_PAGES_FACTOR = 4
_BIG = torch.finfo(torch.float32).max


def candidate_count(n_pages: int, n_sel: int) -> int:
    return min(n_pages, COVER_PAGES_FACTOR * n_sel)


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------
def init_index(batch, n_pages, n_cent, kv, d, dtype, device):
    """Empty index leaves (merged into the retriever's decode state)."""
    return {
        "cent": torch.zeros((batch, n_cent, kv, 2, d), dtype=dtype, device=device),
        "cent_mean": torch.zeros((batch, n_cent, kv, d), dtype=torch.float32, device=device),
        "cent_assign": torch.full((batch, n_pages, kv), -1, dtype=torch.int32, device=device),
        "cent_count": torch.zeros((batch, n_cent, kv), dtype=torch.int32, device=device),
    }


def page_mid(summ):
    """(B, N, kv, 2, d) summaries -> (B, N, kv, d) f32 box midpoints."""
    return 0.5 * (summ[..., 0, :].float() + summ[..., 1, :].float())


def _dist2(mid, mean):
    """Squared distances: mid (B, N, kv, d) f32, mean (B, C, kv, d) f32 ->
    (B, N, kv, C) f32. Each float32 difference squares exactly in float64
    and the sum over d is rounded to float32 once, so a distance does not
    depend on N or on the device's reduction order."""
    diff = mid[:, :, :, None, :] - mean.permute(0, 2, 1, 3)[:, None]   # (B,N,kv,C,d)
    return diff.double().square().sum(-1).float()


def assign_pages(summ, cent_mean, valid):
    """Nearest centroid of every valid page: valid (B, N) bool -> (B, N, kv)
    int32, -1 for invalid pages; ties go to the lowest cluster id."""
    a = torch.argmin(_dist2(page_mid(summ), cent_mean), dim=-1)
    return torch.where(valid[:, :, None], a, -1).to(torch.int32)


def _flat_cluster(assign, n_cent):
    """(ok (B, N, kv) bool, flat (B*N*kv,) int64 row of (b, cluster, kv) in a
    (B*C*kv, ...) table; invalid pages point at cluster 0)."""
    B, N, kv = assign.shape
    ok = assign >= 0
    safe = torch.where(ok, assign, 0).long()
    bI = torch.arange(B, device=assign.device)[:, None, None]
    kI = torch.arange(kv, device=assign.device)[None, None, :]
    return ok, ((bI * n_cent + safe) * kv + kI).reshape(-1)


def _counts(ok, flat, B, n_cent, kv):
    n = torch.zeros((B * n_cent * kv,), dtype=torch.int32, device=ok.device)
    return n.index_add_(0, flat, ok.reshape(-1).to(torch.int32)).reshape(B, n_cent, kv)


def rebuild_stats(summ, assign, n_cent, dtype):
    """Cluster counts and bounding boxes from scratch (integer sums and
    scatter min/max: the same in any order)."""
    B, N, kv = assign.shape
    d = summ.shape[-1]
    ok, flat = _flat_cluster(assign, n_cent)
    idx = flat[:, None].expand(-1, d)
    lo = torch.where(ok[..., None], summ[..., 0, :].float(), _BIG).reshape(-1, d)
    hi = torch.where(ok[..., None], summ[..., 1, :].float(), -_BIG).reshape(-1, d)
    full = torch.full((B * n_cent * kv, d), _BIG, device=summ.device)
    c_lo = full.scatter_reduce(0, idx, lo, "amin", include_self=True)
    c_hi = (-full).scatter_reduce(0, idx, hi, "amax", include_self=True)
    count = _counts(ok, flat, B, n_cent, kv)
    empty = (count == 0)[..., None]
    zero = torch.zeros((), device=summ.device)
    cent = torch.stack([torch.where(empty, zero, c_lo.reshape(B, n_cent, kv, d)),
                        torch.where(empty, zero, c_hi.reshape(B, n_cent, kv, d))], dim=3)
    return cent.to(dtype), count


def recompute_means(summ, assign, n_cent, prev_mean):
    """Segment means of member-page midpoints; empty clusters keep their
    previous mean. The sums are float64, rounded once to float32 before the
    division (the reference's float32 scatter-add, without its order)."""
    B, N, kv = assign.shape
    d = summ.shape[-1]
    ok, flat = _flat_cluster(assign, n_cent)
    mid = torch.where(ok[..., None], page_mid(summ), 0.0).double().reshape(-1, d)
    s = torch.zeros((B * n_cent * kv, d), dtype=torch.float64, device=summ.device)
    s = s.index_add_(0, flat, mid).float().reshape(B, n_cent, kv, d)
    n = _counts(ok, flat, B, n_cent, kv)
    mean = s / torch.clamp(n, min=1)[..., None].float()
    return torch.where((n > 0)[..., None], mean, prev_mean)


# ---------------------------------------------------------------------------
# build / rebuild
# ---------------------------------------------------------------------------
def build(summ, length, n_cent, page_size, dtype, iters=2):
    """Prefill-time index: strided seeds, ``iters`` k-means refinements and
    a final assign-all, so every assignment is the argmin against the
    snapshot from the first decode step on."""
    B, N = summ.shape[:2]
    dev = summ.device
    n_done = torch.div(length, page_size, rounding_mode="floor")          # (B,)
    valid = torch.arange(N, device=dev)[None, :] < n_done[:, None]
    mid = page_mid(summ)
    c = torch.arange(n_cent, device=dev)
    seed = torch.clamp(torch.div(c[None, :] * torch.clamp(n_done, min=1)[:, None], n_cent,
                                 rounding_mode="floor"), 0, N - 1).long()  # (B, C)
    mean = mid[torch.arange(B, device=dev)[:, None], seed]                # (B, C, kv, d)
    for _ in range(iters):
        mean = recompute_means(summ, assign_pages(summ, mean, valid), n_cent, mean)
    a = assign_pages(summ, mean, valid)
    cent, count = rebuild_stats(summ, a, n_cent, dtype)
    return {"cent": cent, "cent_mean": mean, "cent_assign": a, "cent_count": count}


def rebuild(state, page_size):
    """Exact rebuild from (summaries, mean snapshot, length) alone: the
    oracle the incrementally kept leaves must equal bit for bit."""
    summ = state["summ"]
    n_done = torch.div(state["length"], page_size, rounding_mode="floor")
    valid = torch.arange(summ.shape[1], device=summ.device)[None, :] < n_done[:, None]
    a = assign_pages(summ, state["cent_mean"], valid)
    cent, count = rebuild_stats(summ, a, state["cent_mean"].shape[1], state["cent"].dtype)
    return {"cent": cent, "cent_mean": state["cent_mean"], "cent_assign": a,
            "cent_count": count}


# ---------------------------------------------------------------------------
# incremental maintenance (decode append)
# ---------------------------------------------------------------------------
def update_on_append(state, fkv: FreeKVConfig, length_host=None):
    """Index maintenance after ``paging.append_token`` (reference
    ``centroid_index.py:180``), in place: assign the page that just
    completed against the frozen snapshot and min/max-merge its box into its
    cluster; every ``centroid_refresh_interval`` completed pages, one
    k-means step (re-center, reassign all, exact stat rebuild). Rows whose
    page did not complete are left as they were.

    ``length_host`` is a CPU copy of the post-append ``state["length"]``;
    with it a step where no page completes (most steps) touches nothing on
    the card and reads nothing back."""
    p = fkv.page_size
    length = state["length"]
    if length_host is None:
        length_host = length.cpu()
    new_len = [int(x) for x in length_host]
    if not any(n % p == 0 for n in new_len):
        return state
    B = length.shape[0]
    n_cent, kv = state["cent_mean"].shape[1:3]
    dev = length.device
    page_done = (length % p) == 0                                         # (B,)
    safe_pi = torch.where(page_done, torch.div(length, p, rounding_mode="floor") - 1, 0).long()
    bI = torch.arange(B, device=dev)[:, None]
    kI = torch.arange(kv, device=dev)[None, :]

    # assign the completed page (the same distance as the rebuild)
    row = state["summ"][torch.arange(B, device=dev), safe_pi]             # (B, kv, 2, d)
    a = torch.argmin(_dist2(page_mid(row[:, None]), state["cent_mean"]), dim=-1)[:, 0]
    pi = safe_pi[:, None]
    old_a = state["cent_assign"][bI, pi, kI]
    state["cent_assign"][bI, pi, kI] = torch.where(page_done[:, None], a.to(torch.int32), old_a)

    # count += 1 and the box min/max-merge for the page's cluster
    a = a.long()
    old_n = state["cent_count"][bI, a, kI]
    state["cent_count"][bI, a, kI] = old_n + page_done[:, None].to(torch.int32)
    box = row.float()
    old_box = state["cent"][bI, a, kI].float()
    merged = torch.stack([torch.minimum(old_box[:, :, 0], box[:, :, 0]),
                          torch.maximum(old_box[:, :, 1], box[:, :, 1])], dim=2)
    new_box = torch.where((old_n > 0)[..., None, None], merged, box)
    new_box = torch.where(page_done[:, None, None, None], new_box, old_box)
    state["cent"][bI, a, kI] = new_box.to(state["cent"].dtype)

    # periodic re-center (one masked k-means iteration per row)
    every = max(fkv.centroid_refresh_interval, 1)
    if not any(n % p == 0 and (n // p) % every == 0 for n in new_len):
        return state
    n_done = torch.div(length, p, rounding_mode="floor")
    recen = page_done & (n_done % every == 0)
    mean2 = recompute_means(state["summ"], state["cent_assign"], n_cent, state["cent_mean"])
    valid = torch.arange(state["summ"].shape[1], device=dev)[None, :] < n_done[:, None]
    a2 = assign_pages(state["summ"], mean2, valid)
    cent2, count2 = rebuild_stats(state["summ"], a2, n_cent, state["cent"].dtype)
    r = recen[:, None, None]
    state["cent_mean"] = torch.where(r[..., None], mean2, state["cent_mean"])
    state["cent_assign"] = torch.where(r, a2, state["cent_assign"])
    state["cent"] = torch.where(r[..., None, None], cent2, state["cent"])
    state["cent_count"] = torch.where(r, count2, state["cent_count"])
    return state


# ---------------------------------------------------------------------------
# two-stage selection
# ---------------------------------------------------------------------------
def centroid_select(cfg: ArchConfig, fkv: FreeKVConfig, q, state, n_sel):
    """Centroid-then-token selection (reference ``centroid_index.py:289``)
    -> (idx (B, kv, n_sel) int32 page ids, -1-padded; cand_idx (B, kv, m)).
    Stage 1 (``ops.centroid_candidates``) scores the cluster boxes and keeps
    the top m selectable pages by their cluster's bound; stage 2
    (``ops.select_pages`` with ``cand``) scores only those candidates'
    summaries, read in place, and pools and ranks them."""
    B, H, d = q.shape
    kv = cfg.n_kv_heads
    qg = q.reshape(B, kv, H // kv, d).contiguous()
    kw = selection.select_kwargs(cfg, fkv, d)
    m = candidate_count(state["summ"].shape[1], n_sel)
    cand_idx = ops.centroid_candidates(qg, state["cent"], state["cent_count"],
                                       state["cent_assign"], state["length"], m=m, **kw)
    idx = ops.select_pages(qg, state["summ"], state["length"], n_sel=n_sel,
                           mode=fkv.group_pool, cand=cand_idx, **kw)
    return idx, cand_idx
