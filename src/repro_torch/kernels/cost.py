"""What one launch of each hand-written kernel costs, from the shapes it
takes: the bytes it must move across HBM and across the PCIe link (a pinned
host pool) and the operations it does, each input read once and each output
written once -> ``{"hbm_bytes", "link_bytes", "flops"}``.

``kernels/ops.py`` reports every launch with these to the active
``launch/op_cost`` counters, and ``chip_smoke.py`` phase 3 turns them into
the kernels' bounds with ``launch/roofline.kernel_bound``. Where a launch's
work depends on the data (the valid lanes of a gather, the rows that
complete a page), the default is the most it can be; a caller that knows the
data passes what it needs.
"""
from __future__ import annotations


def _cost(hbm, link=0, flops=0) -> dict:
    return {"hbm_bytes": int(hbm), "link_bytes": int(link), "flops": int(flops)}


def paged_attention(B, kv, G, N, p, d, itemsize) -> dict:
    """q (B,kv,G,d), K/V pages (B,kv,N,p,d), int32 positions (B,kv,N,p) and
    cur (B,) read, the output written; QK^T and PV over every slot."""
    L = N * p
    return _cost(itemsize * (2 * B * kv * G * d + 2 * B * kv * L * d) + 4 * B * kv * L + 4 * B,
                 flops=4 * B * kv * G * L * d)


def paged_attention_lse(B, kv, G, N, p, d, itemsize) -> dict:
    """``paged_attention`` with its output written in float32, and its
    float32 log-sum-exp (B,kv,G)."""
    c = paged_attention(B, kv, G, N, p, d, itemsize)
    c["hbm_bytes"] += (4 - itemsize) * B * kv * G * d + 4 * B * kv * G
    return c


def page_scores(B, kv, G, N, d, itemsize) -> dict:
    """q and the summaries (B,N,kv,2,d) read, float32 scores written."""
    return _cost(itemsize * (B * kv * G * d + B * N * kv * 2 * d) + 4 * B * kv * G * N,
                 flops=4 * B * kv * G * N * d)


def centroid_scores(B, kv, G, C, d, itemsize) -> dict:
    """q, the cluster boxes (B,C,kv,2,d) and counts read, float32 scores
    written."""
    return _cost(itemsize * (B * kv * G * d + B * C * kv * 2 * d) + 4 * B * C * kv
                 + 4 * B * kv * G * C, flops=4 * B * kv * G * C * d)


def select_pages(B, kv, G, N, d, n_sel, itemsize, *, per_head=False, n_cand=0,
                 with_pooled=False) -> dict:
    """q, the summaries of the N pages scored (of the ``n_cand`` candidates
    when given, with their int32 ids) and the lengths read; int32 ids (per
    query head under ``per_head``) and, ``with_pooled``, the float32 pooled
    scores written."""
    n = n_cand or N
    rows = B * kv * (G if per_head else 1)
    out = 4 * rows * n_sel + (4 * rows * n if with_pooled else 0)
    return _cost(itemsize * (B * kv * G * d + B * n * kv * 2 * d) + 4 * B + 4 * B * kv * n_cand
                 + out, flops=4 * B * kv * G * n * d)


def select_pages_shard(B, kv, G, N, d, n_sel, itemsize) -> dict:
    """``select_pages`` over one page shard's N pages, and the kept ids'
    float32 pooled values (B,kv,n_sel) written."""
    c = select_pages(B, kv, G, N, d, n_sel, itemsize)
    c["hbm_bytes"] += 4 * B * kv * n_sel
    return c


def centroid_candidates(B, kv, G, C, N, d, m, itemsize) -> dict:
    """q, the cluster boxes, counts, the pages' assignments (B,N,kv) and the
    lengths read; m int32 candidate ids a row written."""
    return _cost(itemsize * (B * kv * G * d + B * C * kv * 2 * d)
                 + 4 * (B * C * kv + B * N * kv + B) + 4 * B * kv * m,
                 flops=4 * B * kv * G * C * d)


def _gather(B, kv, n_sel, page_bytes, out_bytes, valid, host) -> dict:
    """A gather: ``page_bytes`` read for each valid lane (over the link from
    a host pool), ``out_bytes`` written for every lane, the int32 ids read."""
    valid = B * kv * n_sel if valid is None else valid
    moved = valid * page_bytes
    on_card = B * kv * n_sel * out_bytes + 4 * B * kv * n_sel
    return _cost(on_card, moved) if host else _cost(moved + on_card)


def recall_gather(B, kv, n_sel, p, d, itemsize, *, valid=None, host=True) -> dict:
    """K and V halves of each selected page from the pool -> (B,kv,n_sel,p,d)
    twice; ``valid`` lanes read (default every lane)."""
    return _gather(B, kv, n_sel, 2 * p * d * itemsize, 2 * p * d * itemsize, valid, host)


def recall_values(B, kv, n_sel, p, d, itemsize, *, valid=None, host=True) -> dict:
    """The V halves only (ShadowKV)."""
    return _gather(B, kv, n_sel, p * d * itemsize, p * d * itemsize, valid, host)


def recall_gather_quant(B, kv, n_sel, p, d, bits, n_g, out_itemsize, *, valid=None,
                        host=True) -> dict:
    """The packed K and V halves (d * bits / 8 bytes a row) and their float32
    scales, dequantized to ``out_itemsize``."""
    return _gather(B, kv, n_sel, 2 * p * d * bits // 8 + 2 * n_g * 4,
                   2 * p * d * out_itemsize, valid, host)


def recall_values_quant(B, kv, n_sel, p, d, bits, n_g, out_itemsize, *, valid=None,
                        host=True) -> dict:
    """The packed V halves and their V scales only."""
    return _gather(B, kv, n_sel, p * d * bits // 8 + n_g * 4, p * d * out_itemsize, valid,
                   host)


def page_summary(B, T, kv, d, p, itemsize) -> dict:
    """K (B,T,kv,d) read, the per-page min and max (B,T/p,kv,2,d) written."""
    return _cost(itemsize * (B * T * kv * d + B * (T // p) * kv * 2 * d))


def fill_pages(B, n, p, kv, d, itemsize, summ_itemsize, *, bits=0, n_g=0) -> dict:
    """The n whole pages' K and V read; their summaries, HND blocks (packed
    under ``bits``) and float32 scales written."""
    block = d * itemsize if not bits else d * bits // 8
    return _cost(2 * B * n * p * kv * d * itemsize + B * n * kv * 2 * d * summ_itemsize
                 + B * n * kv * 2 * p * block + (B * n * kv * 2 * n_g * 4 if bits else 0))


def complete_page(B, p, kv, d, itemsize, *, rows=None, host=True, bits=0, n_g=0) -> dict:
    """The lengths (B,) read; for each of ``rows`` rows completing a page
    (default every row) its p ring tokens of K and V read, its summary
    written and its HND block (and scales) written to the pool, across the
    link when the pool is in pinned host memory."""
    rows = B if rows is None else rows
    block = d * itemsize if not bits else d * bits // 8
    to_pool = rows * kv * 2 * p * block + (rows * kv * 2 * n_g * 4 if bits else 0)
    on_card = rows * (2 * p * kv * d * itemsize + kv * 2 * d * itemsize) + 4 * B
    return _cost(on_card, to_pool) if host else _cost(on_card + to_pool)


def complete_page_shard(B, p, kv, d, itemsize, *, rows=None, host=True, bits=0,
                        n_g=0) -> dict:
    """``complete_page`` into one page shard's range: ``rows`` are the rows
    whose completed page lies in the range (default every row)."""
    return complete_page(B, p, kv, d, itemsize, rows=rows, host=host, bits=bits, n_g=n_g)


def visible_pairs(tq, tk, causal=True, window=None) -> int:
    """Query-key pairs an attention of tq rows at positions tk - tq .. tk - 1
    over tk keys computes: every pair when not causal, else each row's keys
    up to its own position, at most ``window`` of them."""
    if not causal:
        return tq * tk
    lo, hi = tk - tq + 1, tk          # the row at position x - 1 sees min(x, window) keys
    if not window or window >= hi:
        return (lo + hi) * (hi - lo + 1) // 2
    short = (lo + window) * (window - lo + 1) // 2 if lo <= window else 0
    return short + (hi - max(lo, window + 1) + 1) * window


def flash_prefill(B, H, kv, tq, tk, d, itemsize, *, causal=True, window=None) -> dict:
    """q (B,H,tq,d) and K/V (B,kv,tk,d) read, the output written; QK^T and PV
    over the visible pairs (``visible_pairs``): the causal, bidirectional,
    windowed and extension (tq < tk, bottom-right) forms."""
    return _cost(itemsize * (2 * B * H * tq * d + 2 * B * kv * tk * d),
                 flops=4 * B * H * d * visible_pairs(tq, tk, causal, window))
