"""The fused selection wrappers (``ops.select_pages``, ``ops.centroid_candidates``)
held against the reference package on the CPU, where they run their plain
versions, and a numpy model of the CUDA kernels' cluster split and top-k
held against the stable sort. Also the selection's variants around the
launch: MaxQ/MeanQ query pooling, the top-p budget, Quest's per-query-head
top-k and RaaS's raw top-k, whose unselectable lanes keep
``jax.lax.top_k``'s ids.

Inputs come from numpy and go through both packages: page and candidate ids
exactly equal, pooled scores within ``tests/test_kernels.py::_tol`` (float32).
The reference runs its Pallas scoring kernels in interpret mode
(``use_kernels=True``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import FreeKVConfig as JFreeKVConfig
from repro.core import centroid_index as jcentroid
from repro.core import selection as jselection
from repro_torch.configs import get_config
from repro_torch.configs.base import FreeKVConfig
from repro_torch.core import centroid_index, selection
from repro_torch.kernels import ops, ref

torch.set_float32_matmul_precision("highest")
ARCH = "granite-3-8b-smoke"
P, N_SINK, N_WIN = 8, 8, 16
TOL = dict(atol=2e-5, rtol=2e-5)          # tests/test_kernels.py::_tol at float32
MODES = ["mean_softmax", "max_softmax", "mean_qk", "max_qk"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(mode):
    kw = dict(page_size=P, budget=64, n_sink=N_SINK, n_window=N_WIN, group_pool=mode)
    return (jget_config(ARCH), JFreeKVConfig(use_kernels=True, kernel_interpret="interpret",
                                             **kw),
            get_config(ARCH), FreeKVConfig(**kw))


def _summ(rng, B, n, kv, d):
    raw = rng.standard_normal((B, n, kv, 2, d)).astype(np.float32)
    return np.stack([raw.min(axis=3), raw.max(axis=3)], axis=3)


def _select_case(case, rng, cfg):
    """q (B, H, d), summ, length, n_sel for one named case."""
    B, n, kv, H, d = 2, 24, cfg.n_kv_heads, cfg.n_heads, cfg.d_head
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    summ = _summ(rng, B, n, kv, d)
    length = np.array([n * P, n * P - 20], np.int32)
    n_sel = 6
    if case == "ties":                     # pages 3..19 identical, tied at the top
        summ[:, 3, :, 0], summ[:, 3, :, 1] = -3.0, 3.0
        summ[:, 4:20] = summ[:, 3:4]
    elif case == "underflow":              # MeanS probabilities underflow to exactly 0.0
        q *= 40.0
        summ[:, 20:] *= 3.0
    elif case == "no_selectable":          # row 1 has no selectable page at all
        length = np.array([n * P, N_SINK + N_WIN + 3], np.int32)
    elif case == "k_gt_selectable":        # fewer selectable pages than n_sel
        length = np.array([N_SINK + N_WIN + 5 * P, n * P], np.int32)
        n_sel = 12
    elif case == "short":                  # length < n_window
        length = np.array([N_WIN - 3, 5], np.int32)
    return q, summ, length, n_sel


@pytest.mark.parametrize("case", ["random", "ties", "underflow", "no_selectable",
                                  "k_gt_selectable", "short"])
@pytest.mark.parametrize("mode", MODES)
def test_select_pages_plain_matches_reference(mode, case):
    """``ops.select_pages`` (its plain path) against the reference's
    ``select_pages`` through its Pallas scoring kernel: every pooling mode,
    ties from identical summaries (lower page id first), MeanS
    probabilities that underflow to 0.0, a row with no selectable page,
    fewer selectable pages than n_sel, and length < n_window."""
    jcfg, jfkv, cfg, fkv = _cfgs(mode)
    rng = np.random.default_rng(11)
    q, summ, length, n_sel = _select_case(case, rng, cfg)
    jidx, jpooled = jselection.select_pages(jcfg, jfkv, jnp.asarray(q), jnp.asarray(summ),
                                            jnp.asarray(length), n_sel)
    B, H, d = q.shape
    kv = cfg.n_kv_heads
    idx, pooled = ops.select_pages(_t(q).reshape(B, kv, H // kv, d), _t(summ), _t(length),
                                   n_sel=n_sel, scale=1.0 / d ** 0.5, page_size=P,
                                   n_sink=N_SINK, n_window=N_WIN, mode=mode, with_pooled=True)
    assert idx.dtype == torch.int32 and idx.shape == (B, kv, n_sel)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), **TOL)
    if case == "ties":
        assert (pooled.numpy()[..., 3:19] == pooled.numpy()[..., 3:4]).all()
        assert (idx.numpy() == np.arange(3, 3 + n_sel)).all()
    if case == "underflow" and mode == "mean_softmax":
        assert (pooled.numpy() == 0.0).any()
    if case == "no_selectable":
        assert (idx[1] == -1).all()
    if case == "k_gt_selectable":
        assert (idx[0, :, 5:] == -1).all() and (idx[0, :, :5] >= 0).all()


def _centroid_state(rng, cfg, case):
    """A centroid index state: summaries, length and cluster boxes, counts
    (some empty) and assignments (-1 for pages without a cluster)."""
    B, N, kv, d, C = 2, 40, cfg.n_kv_heads, cfg.d_head, 16
    summ = _summ(rng, B, N, kv, d)
    cent = _summ(rng, B, C, kv, d)
    assign = rng.integers(-1, C, (B, N, kv)).astype(np.int32)
    count = np.zeros((B, C, kv), np.int32)
    for b in range(B):
        for h in range(kv):
            for c in assign[b, :, h][assign[b, :, h] >= 0]:
                count[b, c, h] += 1
    count[:, 3] = 0                                     # an empty cluster
    length = np.array([N * P, N * P - 100], np.int32)
    if case == "few":                                   # fewer selectable pages than m
        length = np.array([N_SINK + N_WIN + 6 * P, N * P], np.int32)
    return {"summ": summ, "length": length, "cent": cent, "cent_count": count,
            "cent_assign": assign}


@pytest.mark.parametrize("case", ["random", "few"])
def test_centroid_candidates_plain_matches_reference(case):
    """``ops.centroid_candidates`` (its plain path) against the reference's
    ``candidate_pages(cluster_scores(...))`` through its Pallas kernel:
    candidate ids exactly equal, ties (pages of one cluster) in page-id
    order, -1 padding when fewer pages are selectable than m."""
    jcfg, jfkv, cfg, fkv = _cfgs("mean_softmax")
    rng = np.random.default_rng(12)
    st = _centroid_state(rng, cfg, case)
    B, H, d = 2, cfg.n_heads, cfg.d_head
    kv = cfg.n_kv_heads
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    N = st["summ"].shape[1]
    m = jcentroid.candidate_count(N, 6)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    cs = jcentroid.cluster_scores(jcfg, jfkv, jnp.asarray(q), jst, use_kernels=True)
    valid = jselection.selectable_mask(jcfg, jfkv, N, jst["length"])
    want = jcentroid.candidate_pages(cs, jst["cent_assign"], valid, m)
    got = ops.centroid_candidates(_t(q).reshape(B, kv, H // kv, d), _t(st["cent"]),
                                  _t(st["cent_count"]), _t(st["cent_assign"]), _t(st["length"]),
                                  m=m, scale=1.0 / d ** 0.5, page_size=P, n_sink=N_SINK,
                                  n_window=N_WIN)
    assert got.dtype == torch.int32 and got.shape == (B, kv, m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "few":
        assert (got[0] == -1).any()


@pytest.mark.parametrize("mode", MODES)
def test_select_pages_candidates_match_centroid_select(mode):
    """``ops.select_pages(..., cand=...)`` on the reference's candidates (with
    -1 candidates: fewer selectable pages than m in request 0) gives the
    reference ``centroid_select``'s page ids, and the port's
    ``centroid_select`` gives its candidates and ids."""
    jcfg, jfkv, cfg, fkv = _cfgs(mode)
    rng = np.random.default_rng(13)
    st = _centroid_state(rng, cfg, "few")
    B, H, d = 2, cfg.n_heads, cfg.d_head
    kv = cfg.n_kv_heads
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    n_sel = 6
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    jidx, jcand = jcentroid.centroid_select(jcfg, jfkv, jnp.asarray(q), jst, n_sel,
                                            use_kernels=True)
    assert (np.asarray(jcand) == -1).any()
    idx = ops.select_pages(_t(q).reshape(B, kv, H // kv, d), _t(st["summ"]), _t(st["length"]),
                           n_sel=n_sel, scale=1.0 / d ** 0.5, page_size=P, n_sink=N_SINK,
                           n_window=N_WIN, mode=mode, cand=_t(jcand))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    tst = {k: _t(v) for k, v in st.items()}
    pidx, pcand = centroid_index.centroid_select(cfg, fkv, _t(q), tst, n_sel)
    np.testing.assert_array_equal(pcand.numpy(), np.asarray(jcand))
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))


# ---------------------------------------------------------------------------
# numpy model of the kernels' cluster split and top-k (csrc/page_scores.cu)
# ---------------------------------------------------------------------------
def _keys(vals):
    """The kernel's 64-bit keys: the value's float32 bits in an
    order-preserving form (-0.0 as +0.0), then 0xffffffff - index."""
    v = np.where(vals == 0, np.float32(0), vals).astype(np.float32)
    u = v.view(np.uint32).astype(np.uint64)
    u = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return (u << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - np.arange(len(v), dtype=np.uint64))


def _kernel_top(vals, n_sel, S):
    """What the kernel writes for one row: block r ranks the keys of pages
    split_range(N, S, r) by counting the keys above each and keeps its k
    best in order; a kept key's place is its rank plus, for each other
    block, the count of that block's kept keys above it (binary search)."""
    N = len(vals)
    k = min(n_sel, N)
    keys = _keys(vals)
    lists = []
    for r in range(S):
        n0, n1 = ops.split_range(N, S, r)
        loc = keys[n0:n1]
        rank = (loc[None, :] > loc[:, None]).sum(axis=1)
        lst = np.zeros(min(k, n1 - n0), np.uint64)
        lst[rank[rank < k]] = loc[rank < k]
        lists.append(lst)
    neg_half = _keys(np.array([-5e29], np.float32))[0] >> np.uint64(32)
    out = np.full(n_sel, -2, np.int64)
    for r, lst in enumerate(lists):
        for j, key in enumerate(lst):
            place = j
            for s, other in enumerate(lists):
                if s == r:
                    continue
                lo, hi = 0, len(other)
                while lo < hi:
                    mid = (lo + hi) // 2
                    if other[mid] > key:
                        lo = mid + 1
                    else:
                        hi = mid
                place += lo
            if place < k:
                assert out[place] == -2, "a place written twice"
                i = int(np.uint64(0xFFFFFFFF) - (key & np.uint64(0xFFFFFFFF)))
                out[place] = i if (key >> np.uint64(32)) > neg_half else -1
    assert (out[:k] != -2).all(), "a place never written"
    out[k:] = -1
    return out


def _values(rng, N, kind):
    if kind == "distinct":
        return rng.standard_normal(N).astype(np.float32)
    if kind == "ties":       # few distinct values, -0.0 beside 0.0, masked pages
        pick = np.array([-1e30, -0.0, 0.0, 0.125, 0.5, 0.5, 3.0], np.float32)
        return pick[rng.integers(0, len(pick), N)]
    return np.full(N, -1e30, np.float32)            # nothing selectable


@pytest.mark.parametrize("kind", ["distinct", "ties", "masked"])
@pytest.mark.parametrize("N,S", [(1, 1), (7, 3), (65, 4), (259, 4), (259, 8), (1000, 8)])
def test_kernel_top_k_equals_stable_sort(N, S, kind):
    """The kernel's split top-k equals ``jax.lax.top_k``'s order (the stable
    descending sort) with -1 at values <= -5e29 and -1 padding, for n_sel
    below, near and above N, every place written exactly once."""
    rng = np.random.default_rng(N * 10 + S)
    vals = _values(rng, N, kind)
    for n_sel in (1, 56, 300):
        got = _kernel_top(vals, n_sel, S)
        want = ref.top_ids(torch.from_numpy(vals)[None, None], None, n_sel)[0, 0].numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"n_sel={n_sel}")


@pytest.mark.parametrize("rows,sms", [(1, 132), (4, 132), (32, 132), (32, 108), (4096, 132)])
def test_select_split_covers_every_page_once(rows, sms):
    """``ops.select_split``: 1 <= S <= min(MAX_CLUSTER, N), the blocks' page
    ranges tile [0, N), and a block's pages fit its shared memory wherever
    MAX_CLUSTER blocks can hold the row."""
    for N in list(range(1, 40)) + [259, 2048, 16384, 16385, 32768]:
        S = ops.select_split(N, rows, sms)
        assert 1 <= S <= min(ops.MAX_CLUSTER, N)
        bounds = [ops.split_range(N, S, r) for r in range(S)]
        assert bounds[0][0] == 0 and bounds[-1][1] == N
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert all(n1 > n0 for n0, n1 in bounds)
        if N <= ops.MAX_CLUSTER * ops.SMEM_KEYS:
            assert -(-N // S) <= ops.SMEM_KEYS


def test_select_split_main_path_shape():
    """At the main path's decode (B * kv = 32 rows, 259 pages, 132 SMs) each
    row is a cluster of 4 blocks of 64 or 65 pages: 128 blocks, one wave."""
    assert ops.select_split(259, 32, 132) == 4
    assert {n1 - n0 for n0, n1 in (ops.split_range(259, 4, r) for r in range(4))} == {64, 65}


# ---------------------------------------------------------------------------
# MaxQ/MeanQ, the top-p budget, Quest's and RaaS's raw top-k
# ---------------------------------------------------------------------------
def _scale(d):
    return 1.0 / d ** 0.5


@pytest.mark.parametrize("case", ["random", "ties", "k_gt_selectable"])
@pytest.mark.parametrize("q_pool", ["max", "mean"])
def test_q_pool_matches_reference(q_pool, case):
    """MaxQ/MeanQ (``q_pool``): q pooled over the group before scoring, then
    repeated, around the same launch; page ids exactly the reference's,
    pooled scores within 2e-5."""
    jcfg, jfkv, cfg, fkv = _cfgs("mean_softmax")
    q, summ, length, n_sel = _select_case(case, np.random.default_rng(21), cfg)
    jidx, jpooled = jselection.select_pages(jcfg, jfkv, jnp.asarray(q), jnp.asarray(summ),
                                            jnp.asarray(length), n_sel, q_pool=q_pool)
    idx, pooled = selection.select_pages(cfg, fkv, _t(q), _t(summ), _t(length), n_sel,
                                         q_pool=q_pool)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), **TOL)
    plain, _ = selection.select_pages(cfg, fkv, _t(q), _t(summ), _t(length), n_sel)
    if case == "random":
        assert not torch.equal(idx, plain)      # the pooling changes the selection


@pytest.mark.parametrize("mode", ["mean_softmax", "max_softmax", "mean_qk"])
@pytest.mark.parametrize("top_p", [0.3, 0.5, 0.9, 0.999])
def test_select_top_p_matches_reference(top_p, mode):
    """The dynamic budget (``select_top_p``, the reference's
    ``test_retrieval.py::test_top_p_dynamic_budget`` inputs): ids exactly
    the reference's; the kept pages are a prefix of the static top-k, at
    least one a row; a qk pooling mode keeps the static top-k."""
    B, n_pages, n_sel = 2, 16, 8
    kw = dict(page_size=8, budget=10 ** 5, n_sink=8, n_window=8, group_pool=mode)
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    key = jax.random.PRNGKey(3)
    q = np.asarray(jax.random.normal(key, (B, cfg.n_heads, cfg.d_head))) * 3
    # sorted so that lo <= hi, as a page summary is (the bound's two forms
    # agree only then)
    summ = np.sort(np.asarray(jax.random.normal(jax.random.fold_in(key, 1),
                                                (B, n_pages, cfg.n_kv_heads, 2, cfg.d_head))),
                   axis=3)
    length = np.array([n_pages * 8, n_pages * 8], np.int32)
    got = {}
    for p_ in (0.0, top_p):
        jidx, _ = jselection.select_pages(jcfg, JFreeKVConfig(**kw, select_top_p=p_),
                                          jnp.asarray(q), jnp.asarray(summ),
                                          jnp.asarray(length), n_sel)
        idx, _ = selection.select_pages(cfg, FreeKVConfig(**kw, select_top_p=p_), _t(q),
                                        _t(summ), _t(length), n_sel, with_pooled=False)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx), err_msg=f"top_p={p_}")
        got[p_] = idx.numpy()
    full, part = got[0.0], got[top_p]
    assert ((part >= 0).sum(-1) >= 1).all()
    for b in range(B):
        for h in range(cfg.n_kv_heads):
            kept = part[b, h][part[b, h] >= 0]
            np.testing.assert_array_equal(kept, full[b, h][: len(kept)])
    if mode == "mean_qk":
        np.testing.assert_array_equal(part, full)
    elif top_p == 0.3:
        assert (part >= 0).sum() < (full >= 0).sum()


LAYOUTS = [(4, 2, 64), (28, 4, 128), (15, 5, 64), (32, 32, 80), (8, 4, 256)]


def _layout_cfg(H, kv, d):
    return dataclasses.replace(get_config(ARCH), n_heads=H, n_kv_heads=kv, d_head=d)


@pytest.mark.parametrize("case", ["random", "ties", "no_selectable", "k_gt_selectable"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: "H%d-kv%d-d%d" % x)
def test_per_head_top_pages_match_quest(layout, case):
    """Quest's selection (reference ``retrieval.py:508-513``): each query
    head's own top-k of its masked scores, at the head layouts of the
    served archs (G = 2, 7, 3, 1, 2; d_head 64 to 256). Ids exactly
    ``jax.lax.top_k``'s, unselectable lanes included: their ids, lower
    first, never -1."""
    cfg = _layout_cfg(*layout)
    fkv = FreeKVConfig(page_size=P, budget=64, n_sink=N_SINK, n_window=N_WIN)
    q, summ, length, n_sel = _select_case(case, np.random.default_rng(31), cfg)
    B, H, d = q.shape
    jfkv = JFreeKVConfig(page_size=P, budget=64, n_sink=N_SINK, n_window=N_WIN)
    s = jselection.page_scores_minmax(jnp.asarray(q), jnp.asarray(summ), _scale(d))
    valid = jselection.selectable_mask(None, jfkv, summ.shape[1], jnp.asarray(length))
    s = jnp.where(valid[:, None, :], s, jselection.NEG_INF)
    want = np.asarray(jax.lax.top_k(s, n_sel)[1]).reshape(B, cfg.n_kv_heads, -1, n_sel)
    idx, _ = selection.select_pages(cfg, fkv, _t(q), _t(summ), _t(length), n_sel,
                                    with_pooled=False, per_head=True, keep_invalid=True)
    assert idx.dtype == torch.int32 and idx.shape == want.shape
    np.testing.assert_array_equal(idx.numpy(), want)
    assert (idx >= 0).all()
    if case == "no_selectable":
        assert (idx[1] == torch.arange(n_sel, dtype=torch.int32)).all()


@pytest.mark.parametrize("case", ["random", "underflow", "no_selectable", "k_gt_selectable"])
@pytest.mark.parametrize("mode", MODES)
def test_pooled_top_pages_match_raas_seeding(mode, case):
    """RaaS's prefill seeding (reference ``retrieval.py:693-698``): the group-
    pooled scores' top-k as ``jax.lax.top_k`` returns it, unselectable
    lanes keeping their ids; pages whose MeanS probability underflows to
    0.0 still rank above unselectable ones."""
    jcfg, jfkv, cfg, fkv = _cfgs(mode)
    q, summ, length, n_sel = _select_case(case, np.random.default_rng(41), cfg)
    d = q.shape[-1]
    s = jselection.page_scores_minmax(jnp.asarray(q), jnp.asarray(summ), _scale(d))
    valid = jselection.selectable_mask(jcfg, jfkv, summ.shape[1], jnp.asarray(length))
    pooled = jselection.group_consistent_scores(jcfg, s, valid, mode)
    want = np.asarray(jax.lax.top_k(pooled, n_sel)[1])
    idx, _ = selection.select_pages(cfg, fkv, _t(q), _t(summ), _t(length), n_sel,
                                    with_pooled=False, keep_invalid=True)
    np.testing.assert_array_equal(idx.numpy(), want)
    assert (idx >= 0).all()
