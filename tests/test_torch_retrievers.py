"""The port's ShadowKV, Centroid, Quest, RaaS, StreamingLLM and InfiniGen
retrievers, their kernels' plain versions and the centroid index, held
against the reference on the CPU. Inputs come
from numpy and go through both packages (the reference's Pallas kernels in
interpret mode). Integers (page ids, candidate ids, cluster assignments and
counts, block counts, greedy tokens) are exactly equal; gathers are exact;
float outputs agree within 2e-5 at float32 (the centroid scores within
1e-5, the reference's own kernel tolerance; the centroid means within 1e-6:
the port sums them in float64 where the reference sums in float32)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import FreeKVConfig as JFreeKVConfig
from repro.core import centroid_index as jcentroid
from repro.core import recall as jrecall
from repro.core.recall_pipeline import RecallExecutor as JRecallExecutor
from repro.core.retrieval import make_retriever as jmake_retriever
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import model as jmodel
from repro.quant import quantizers as jqz
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import FreeKVConfig
from repro_torch.core import centroid_index, paging, recall
from repro_torch.core.recall_pipeline import RecallExecutor
from repro_torch.core import retrieval
from repro_torch.core.retrieval import (METHODS, CentroidRetriever, FreeKVRetriever,
                                        FullRetriever, QuestRetriever, RaaSRetriever,
                                        ShadowKVRetriever, StreamingRetriever, make_retriever)
from repro_torch.data.synthetic import needle_stream
from repro_torch.kernels import ops, ref
from repro_torch.models import model
from repro_torch.quant import quantizers as qz
from repro_torch.serving.engine import Request, ServeEngine

torch.set_float32_matmul_precision("highest")
ARCH = "granite-3-8b-smoke"
SMALL = dict(page_size=8, budget=64, n_sink=8, n_window=8, tau=0.8)
CENT = dict(SMALL, centroid_count=4, centroid_refresh_interval=3)
TOL = dict(atol=2e-5, rtol=2e-5)
INDEX_KEYS = ("cent", "cent_assign", "cent_count")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the port's smoke-width steps are many
    small ops, and with several test workers sharing the cores the default
    thread pool spends its time spinning. The thread count does not change
    what a test checks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cfgs(**kw):
    return (jget_config(ARCH), JFreeKVConfig(**kw), get_config(ARCH), FreeKVConfig(**kw))


# ---------------------------------------------------------------------------
# kernels' plain versions against the reference's kernels (interpret mode)
# ---------------------------------------------------------------------------
def test_recall_values_ref_matches_reference_kernel():
    """V-only gather, -1 and out-of-range lanes included: equal to the
    reference kernel's V output and to ``recall_values_only``."""
    rng = np.random.default_rng(0)
    B, n_pages, kv, p, d = 2, 12, 3, 8, 32
    pool = rng.standard_normal((B, n_pages, kv, 2, p, d)).astype(np.float32)
    idx = rng.integers(-1, n_pages, (B, kv, 5)).astype(np.int32)
    idx[0, 0, 0] = n_pages + 3                    # clamped, as in the reference
    want = jops.recall_values(jnp.asarray(pool), jnp.asarray(idx), interpret=True)
    got = ref.recall_values_ref(_t(pool), _t(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(recall.recall_values_only(_t(pool), _t(idx)).numpy(),
                                  np.asarray(jrecall.recall_values_only(jnp.asarray(pool),
                                                                        jnp.asarray(idx))))
    assert not got[idx < 0].any()
    np.testing.assert_array_equal(ops.recall_values(_t(pool), _t(idx)).numpy(), got.numpy())


@pytest.mark.parametrize("group", [0, 16])
@pytest.mark.parametrize("bits", [8, 4])
def test_recall_values_quant_ref_matches_reference_kernel(bits, group):
    """V-only dequantizing gather at float32 and bfloat16, equal bit for bit
    to the reference kernel (interpret mode) and to its
    ``dequant_recall_values``."""
    rng = np.random.default_rng(10 * bits + group)
    B, n_pages, kv, p, d = 2, 10, 2, 8, 64
    x = rng.standard_normal((B, n_pages, kv, 2, p, d)).astype(np.float32)
    x[:, 2] = 0.0
    pool, scales = (np.asarray(a) for a in jqz.quantize_block(jnp.asarray(x), bits, group))
    idx = rng.integers(-2, n_pages, (B, kv, 6)).astype(np.int32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jops.recall_values_quant(jnp.asarray(pool), jnp.asarray(scales),
                                        jnp.asarray(idx), bits=bits, out_dtype=jdt,
                                        interpret=True)
        got = ref.recall_values_quant_ref(_t(pool), _t(scales), _t(idx), bits, tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
        jv = jqz.dequant_recall_values(jnp.asarray(pool), jnp.asarray(scales),
                                       jnp.asarray(idx), bits, jdt)
        np.testing.assert_array_equal(
            qz.dequant_recall_values(_t(pool), _t(scales), _t(idx), bits, tdt).float().numpy(),
            np.asarray(jv, np.float32))


def test_centroid_scores_ref_matches_reference_kernel():
    """The Quest bound against cluster boxes within 1e-5 of the reference
    kernel; empty clusters exactly -1e30."""
    rng = np.random.default_rng(3)
    B, kv, G, C, d = 2, 2, 2, 6, 64
    q = rng.standard_normal((B, kv, G, d)).astype(np.float32)
    lo = rng.standard_normal((B, C, kv, d)).astype(np.float32)
    hi = lo + np.abs(rng.standard_normal((B, C, kv, d))).astype(np.float32)
    cent = np.stack([lo, hi], axis=3)
    cnt = rng.integers(0, 3, (B, C, kv)).astype(np.int32)
    want = jops.centroid_scores(jnp.asarray(q), jnp.asarray(cent), jnp.asarray(cnt),
                                scale=0.125, interpret=True)
    got = ops.centroid_scores(_t(q), _t(cent), _t(cnt), scale=0.125)
    assert got.shape == (B, kv, G, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jref.centroid_scores_ref(jnp.asarray(q), jnp.asarray(cent), jnp.asarray(cnt), 0.125)),
        rtol=1e-5, atol=1e-5)
    empty = cnt.transpose(0, 2, 1) == 0
    assert empty.any()
    assert (got.numpy().transpose(0, 1, 3, 2)[empty] == np.float32(-1e30)).all()


# ---------------------------------------------------------------------------
# recall executor
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_step_values_bit_exact(quant):
    """V-only delta fetch: the composed buffer equals a fresh V-only recall,
    bit for bit, and every field equals the reference executor's."""
    rng = np.random.default_rng(4)
    B, n_pages, kv, p, d, n_sel = 2, 20, 3, 8, 32, 5
    x = rng.standard_normal((B, n_pages, kv, 2, p, d)).astype(np.float32)
    prev_idx = np.stack([rng.permutation(n_pages)[:n_sel] for _ in range(B * kv)])
    prev_idx = prev_idx.reshape(B, kv, n_sel).astype(np.int32)
    new_idx = prev_idx.copy()
    new_idx[..., :2] = rng.integers(0, n_pages, (B, kv, 2))
    new_idx[0, 0, -1] = -1
    prev_idx[1, 2, 0] = -1
    if quant == "none":
        jpool, pool = jnp.asarray(x), _t(x)
        jfn = jrecall.recall_values_only
        fn = ops.recall_values
    else:
        pq, sc = (np.asarray(a) for a in jqz.quantize_block(jnp.asarray(x), 8, 0))
        jpool = (jnp.asarray(pq), jnp.asarray(sc))
        pool = paging.QuantPool(_t(pq), _t(sc), 8, torch.float32)
        jfn = lambda pl, i: jqz.dequant_recall_values(pl[0], pl[1], i, 8)
        fn = lambda pl, i: ops.recall_values_quant(pl.pool, pl.scale, i, bits=8,
                                                   out_dtype=pl.out_dtype)
    prev_v = fn(pool, _t(prev_idx))
    pr = RecallExecutor(values_fn=fn).step_values(pool, _t(new_idx), _t(prev_idx), prev_v)
    assert pr.use_k is None and pr.staged_k is None
    assert torch.equal(pr.staged_v, fn(pool, _t(new_idx)))
    assert torch.equal(pr.use_v, pr.staged_v)
    jpr = JRecallExecutor(values_fn=jfn).step_values(
        jpool, jnp.asarray(new_idx), jnp.asarray(prev_idx), jnp.asarray(prev_v.numpy()))
    for name in ("use_v", "use_idx", "staged_v", "topup_blocks", "staged_blocks",
                 "reused_blocks"):
        np.testing.assert_array_equal(_n(getattr(pr, name)), np.asarray(getattr(jpr, name)),
                                      err_msg=name)
    assert 0 < int(pr.reused_blocks.sum()) < B * kv * n_sel


# ---------------------------------------------------------------------------
# centroid index
# ---------------------------------------------------------------------------
def _summ(rng, B, n, kv, d):
    raw = rng.standard_normal((B, n, kv, 2, d)).astype(np.float32)
    return np.stack([raw.min(axis=3), raw.max(axis=3)], axis=3)


def _assert_index_equal(st, jst, ctx=""):
    for key in INDEX_KEYS:
        np.testing.assert_array_equal(_n(st[key]), np.asarray(jst[key]), err_msg=f"{key} {ctx}")
    np.testing.assert_allclose(_n(st["cent_mean"]), np.asarray(jst["cent_mean"]),
                               atol=1e-6, rtol=1e-6, err_msg=f"cent_mean {ctx}")


@pytest.mark.parametrize("seed", [0, 1])
def test_centroid_build_and_rebuild_match_reference(seed):
    """``build`` (seeds, two k-means steps, assign-all) and ``rebuild`` on
    summaries with rows of different lengths and a partial last page."""
    rng = np.random.default_rng(seed)
    B, N, kv, d, C, p = 2, 30, 2, 64, 5, 8
    summ = _summ(rng, B, N, kv, d)
    length = np.array([N * p - 5, 17 * p], np.int32)
    jb = jcentroid.build(jnp.asarray(summ), jnp.asarray(length), C, p, jnp.float32)
    b = centroid_index.build(_t(summ), _t(length), C, p, torch.float32)
    _assert_index_equal(b, jb, "build")
    st = dict(b, summ=_t(summ), length=_t(length))
    jrb = jcentroid.rebuild(dict(jb, summ=jnp.asarray(summ), length=jnp.asarray(length)), p)
    _assert_index_equal(centroid_index.rebuild(st, p), jrb, "rebuild")
    rb = centroid_index.rebuild(st, p)
    for key in INDEX_KEYS:
        assert torch.equal(rb[key], b[key]), key
    assert int(b["cent_count"].sum()) == sum(int(x) // p for x in length) * kv


def _prefill_pair(jcfg, jfkv, cfg, fkv, rng, B=2, T=160, max_len=512):
    H, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    k = rng.standard_normal((B, T, kv, d)).astype(np.float32)
    v = rng.standard_normal((B, T, kv, d)).astype(np.float32)
    q0 = rng.standard_normal((B, H, d)).astype(np.float32)
    jr = jmake_retriever(jcfg, jfkv)
    jst = jr.prefill(jr.init_state(B, max_len, jnp.float32), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(q0))
    r = make_retriever(cfg, fkv)
    st = r.prefill(r.init_state(B, max_len, torch.float32, "cpu"), _t(k), _t(v), _t(q0))
    return jr, jst, r, st, q0


def _step(rng, cfg, q, drift):
    B = q.shape[0]
    q = (q + drift * rng.standard_normal(q.shape)).astype(np.float32)
    kn = rng.standard_normal((B, cfg.n_kv_heads, cfg.d_head)).astype(np.float32)
    vn = rng.standard_normal(kn.shape).astype(np.float32)
    return q, kn, vn


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
def test_centroid_decode_matches_reference(overlap, quant):
    """26 decode steps that complete three pages and cross a re-center:
    selected page ids, candidate counts, block counts and every index leaf
    equal to the reference each step, the output within 2e-5. The queries
    drift slowly, so some heads take the centroid path uncorrected."""
    jcfg, jfkv, cfg, fkv = _cfgs(method="centroid", recall_overlap=overlap, kv_quant=quant,
                                 **CENT)
    rng = np.random.default_rng(5)
    jr, jst, r, st, q = _prefill_pair(jcfg, jfkv, cfg, fkv, rng, T=163)
    _assert_index_equal(st, jst, "after prefill")
    uncorrected = 0
    for t in range(26):
        q, kn, vn = _step(rng, cfg, q, (0.05, 1.0)[t % 7 == 0])
        jo, jst, jinfo = jr.decode(jst, jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn))
        host = st["length"].clone() if t % 2 else None     # with and without the mirror
        o, st, info = r.decode(st, _t(q), _t(kn), _t(vn), length_host=host)
        np.testing.assert_array_equal(st["sel_idx"].numpy(), np.asarray(jst["sel_idx"]))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
        for key in ("corrected", "cand_pages", "sync_pages", "async_pages", "reused_pages",
                    "spec_hit_pages"):
            np.testing.assert_array_equal(_n(info[key]), np.asarray(jinfo[key]), err_msg=key)
        _assert_index_equal(st, jst, f"step {t}")
        uncorrected += int((~info["corrected"]).sum())
    assert uncorrected > 0, "every head was corrected: the centroid path never ran"


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_centroid_incremental_equals_rebuild(seed, quant):
    """Random runs of decode appends from an unaligned prefill, crossing page
    completions and re-centers at varying phases: after every run the
    incrementally kept leaves equal ``rebuild`` bit for bit."""
    cfg = get_config(ARCH)
    fkv = FreeKVConfig(method="centroid", kv_quant=quant, **CENT)
    rng = np.random.default_rng(seed)
    r = make_retriever(cfg, fkv)
    B, T = 2, int(rng.integers(100, 200))
    k = _t(rng.standard_normal((B, T, cfg.n_kv_heads, cfg.d_head)).astype(np.float32))
    q = rng.standard_normal((B, cfg.n_heads, cfg.d_head)).astype(np.float32)
    st = r.prefill(r.init_state(B, 512, torch.float32, "cpu"), k, k.flip(1), _t(q))
    recentered = 0
    for _ in range(8):
        for _ in range(int(rng.integers(1, 12))):
            before = st["cent_mean"].clone()
            q, kn, vn = _step(rng, cfg, q, 1.0)
            _, st, _ = r.decode(st, _t(q), _t(kn), _t(vn))
            recentered += int(not torch.equal(before, st["cent_mean"]))
        rb = centroid_index.rebuild(st, fkv.page_size)
        for key in INDEX_KEYS:
            assert torch.equal(rb[key], st[key]), key
    assert recentered > 0 and int(st["cent_count"].sum()) > 0


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
def test_centroid_bit_identical_to_freekv_when_corrected(overlap, quant):
    """Random queries: every head is corrected, takes the exact scan, and the
    output is bit-identical to freekv's (the reference's
    ``test_centroid_index.py`` all-corrected case)."""
    cfg = get_config(ARCH)
    fkv = FreeKVConfig(method="centroid", recall_overlap=overlap, kv_quant=quant, **CENT)
    outs = {}
    for f in (fkv, dataclasses.replace(fkv, method="freekv")):
        rng = np.random.default_rng(7)
        r = make_retriever(cfg, f)
        k = _t(rng.standard_normal((2, 160, cfg.n_kv_heads, cfg.d_head)).astype(np.float32))
        q = rng.standard_normal((2, cfg.n_heads, cfg.d_head)).astype(np.float32)
        st = r.prefill(r.init_state(2, 512, torch.float32, "cpu"), k, k * 0.5, _t(q))
        os_, ncorr = [], 0
        for _ in range(12):
            q, kn, vn = _step(rng, cfg, np.zeros_like(q), 1.0)
            o, st, info = r.decode(st, _t(q), _t(kn), _t(vn))
            os_.append(o)
            ncorr += int(info["corrected"].sum())
        outs[f.method] = (os_, ncorr)
    assert outs["centroid"][1] == 12 * 2 * cfg.n_kv_heads
    for a, b in zip(outs["centroid"][0], outs["freekv"][0]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# ShadowKV
# ---------------------------------------------------------------------------
def _k_rec(st):
    return torch.einsum("bktr,bkrd->bktd", st["k_u"].float(), st["k_w"].float())


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
def test_shadowkv_decode_matches_reference(overlap, quant):
    """The reconstructed prompt keys within 2e-5 of the reference's (never
    the factors: singular vectors are defined up to sign), then 20 decode
    steps: page ids and block counts equal, the output within 2e-5."""
    kw = dict(SMALL, svd_rank=48)              # below d_head 64: a truncated factorization
    jcfg, jfkv, cfg, fkv = _cfgs(method="shadowkv", recall_overlap=overlap, kv_quant=quant,
                                 **kw)
    rng = np.random.default_rng(6)
    jr, jst, r, st, q = _prefill_pair(jcfg, jfkv, cfg, fkv, rng, T=96, max_len=160)
    jk_rec = np.einsum("bktr,bkrd->bktd", np.asarray(jst["k_u"]), np.asarray(jst["k_w"]))
    np.testing.assert_allclose(_k_rec(st).numpy(), jk_rec, atol=2e-5, rtol=2e-5)
    for t in range(20):
        q, kn, vn = _step(rng, cfg, q, 0.3)
        jo, jst, jinfo = jr.decode(jst, jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn))
        o, st, info = r.decode(st, _t(q), _t(kn), _t(vn))
        np.testing.assert_array_equal(st["sel_idx"].numpy(), np.asarray(jst["sel_idx"]))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
        for key in ("sync_pages", "async_pages", "reused_pages", "sel_pages",
                    "spec_hit_pages"):
            np.testing.assert_array_equal(_n(info[key]), np.asarray(jinfo[key]), err_msg=key)
    if overlap:
        np.testing.assert_array_equal(st["sel_v"].numpy(), np.asarray(jst["sel_v"]))


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_shadowkv_overlap_bit_identical(quant):
    """The V-only delta fetch changes the transfer schedule only: outputs
    with ``recall_overlap`` on and off are bit-identical."""
    cfg = get_config(ARCH)
    outs = {}
    for overlap in (True, False):
        fkv = FreeKVConfig(method="shadowkv", recall_overlap=overlap, kv_quant=quant, **SMALL)
        rng = np.random.default_rng(8)
        r = make_retriever(cfg, fkv)
        k = _t(rng.standard_normal((2, 96, cfg.n_kv_heads, cfg.d_head)).astype(np.float32))
        q = rng.standard_normal((2, cfg.n_heads, cfg.d_head)).astype(np.float32)
        st = r.prefill(r.init_state(2, 160, torch.float32, "cpu"), k, k.flip(1), _t(q))
        os_, reused = [], 0
        for _ in range(10):
            q, kn, vn = _step(rng, cfg, q, 0.1)
            o, st, info = r.decode(st, _t(q), _t(kn), _t(vn))
            os_.append(o)
            reused += int(info["reused_pages"].sum())
        outs[overlap] = (os_, reused)
    assert outs[True][1] > 0 and outs[False][1] == 0
    for a, b in zip(outs[True][0], outs[False][0]):
        assert torch.equal(a, b)


def test_shadowkv_full_rank_close_to_full():
    """Rank d_head reconstructs the keys; with a budget above the context
    ShadowKV matches the full-cache oracle (the reference's
    ``test_retrieval.py::test_shadowkv_full_rank_close_to_full``)."""
    cfg = get_config(ARCH)
    T = 96
    fkv = FreeKVConfig(method="shadowkv", page_size=8, budget=T + 64, n_sink=16, n_window=16,
                       svd_rank=cfg.d_head)
    rng = np.random.default_rng(9)
    k = _t(rng.standard_normal((2, T, cfg.n_kv_heads, cfg.d_head)).astype(np.float32))
    v = _t(rng.standard_normal(k.shape).astype(np.float32))
    q0 = _t(rng.standard_normal((2, cfg.n_heads, cfg.d_head)).astype(np.float32))
    q, kn, vn = _step(rng, cfg, np.zeros((2, cfg.n_heads, cfg.d_head), np.float32), 1.0)
    outs = []
    for f in (fkv, FreeKVConfig(method="full")):
        r = make_retriever(cfg, f)
        st = r.prefill(r.init_state(2, 160, torch.float32, "cpu"), k, v, q0)
        if f.method == "shadowkv":
            torch.testing.assert_close(_k_rec(st)[:, :, :T], k.transpose(1, 2),
                                       atol=2e-5, rtol=2e-5)
        outs.append(r.decode(st, _t(q), _t(kn), _t(vn))[0])
    torch.testing.assert_close(outs[0], outs[1], atol=5e-4, rtol=0)


def test_make_retriever_ports_shadowkv_and_centroid():
    cfg = get_config(ARCH)
    assert isinstance(make_retriever(cfg, FreeKVConfig(method="shadowkv")), ShadowKVRetriever)
    assert isinstance(make_retriever(cfg, FreeKVConfig(retriever="centroid")),
                      CentroidRetriever)


def test_make_retriever_builds_all_nine_methods_as_the_reference():
    """Every method of the reference's ``make_retriever`` builds, each as
    the reference's class and flags; an unknown one raises."""
    cfg = get_config(ARCH)
    want = {"freekv": FreeKVRetriever, "arkvale": FreeKVRetriever,
            "infinigen": FreeKVRetriever, "quest": QuestRetriever,
            "shadowkv": ShadowKVRetriever, "raas": RaaSRetriever,
            "streaming": StreamingRetriever, "full": FullRetriever,
            "centroid": CentroidRetriever}
    assert set(want) == set(METHODS)
    for m, cls in want.items():
        assert type(make_retriever(cfg, FreeKVConfig(method=m))) is cls, m
    st = make_retriever(cfg, FreeKVConfig(method="streaming", budget=256, n_sink=32))
    assert (st.window, st.n_sink) == (224, 32)
    for m, flags in (("freekv", (True, False, False)), ("arkvale", (False, False, False)),
                     ("infinigen", (False, True, True))):
        r = make_retriever(cfg, FreeKVConfig(method=m))
        assert (r.speculative, r.proxy_query, r.token_wise_recall) == flags, m
    with pytest.raises(ValueError, match="unknown method"):
        make_retriever(cfg, FreeKVConfig(method="snapkv"))


def test_attend_refuses_partial_pages_off_the_cpu():
    """A decode attention over a length that is not a whole number of pages
    cannot be paged_attention: off the CPU it raises (here on the meta
    device) rather than take the plain version; on the CPU it is the plain
    einsum, equal to the full oracle's."""
    cfg = get_config(ARCH)
    fkv = FreeKVConfig(**SMALL)
    B, kv, L, d = 1, cfg.n_kv_heads, 3 * fkv.page_size + 1, cfg.d_head
    rng = np.random.default_rng(3)
    q = _t(rng.standard_normal((B, cfg.n_heads, d)).astype(np.float32))
    k = _t(rng.standard_normal((B, kv, L, d)).astype(np.float32))
    pos = torch.arange(L, dtype=torch.int32)[None, None].expand(B, kv, L).contiguous()
    cur = torch.full((B,), L - 1, dtype=torch.int32)
    got = retrieval._attend(cfg, q, k, k, pos, cur, fkv=fkv)
    torch.testing.assert_close(got, retrieval._attend(cfg, q, k, k, pos, cur), **TOL)
    with pytest.raises(ValueError, match="whole number of"):
        retrieval._attend(cfg, *(t.to("meta") for t in (q, k, k, pos, cur)), fkv=fkv)


@pytest.mark.parametrize("method", METHODS)
def test_make_retriever_builds_every_method(method):
    """Each of the nine methods builds and serves a prefill and a decode
    step on the CPU with finite outputs of the query's shape."""
    cfg = get_config(ARCH)
    r = make_retriever(cfg, FreeKVConfig(method=method, **SMALL))
    rng = np.random.default_rng(1)
    k = _t(rng.standard_normal((1, 64, cfg.n_kv_heads, cfg.d_head)).astype(np.float32))
    q = _t(rng.standard_normal((1, cfg.n_heads, cfg.d_head)).astype(np.float32))
    st = r.prefill(r.init_state(1, 96, torch.float32, "cpu"), k, k, q)
    o, st, info = r.decode(st, q, k[:, 0], k[:, 0], q_proxy=q)
    assert o.shape == q.shape and torch.isfinite(o).all()
    assert int(st["length"][0]) == 65 and info["granularity"] in ("page", "token")


# ---------------------------------------------------------------------------
# Quest, RaaS, StreamingLLM and InfiniGen against the reference
# ---------------------------------------------------------------------------
NEW = ("quest", "raas", "streaming", "infinigen")
# narrow configs with the served archs' real head layouts (heads, KV heads,
# d_head): qwen25-7b G=7, smollm-360m G=3, stablelm-3b G=1, gemma2-2b G=2
REAL_LAYOUTS = {"qwen25-7b": (28, 4, 128), "smollm-360m": (15, 5, 64),
                "stablelm-3b": (32, 32, 80), "gemma2-2b": (8, 4, 256)}


def _pair_retrievers(get_a, get_b, method, layout=None, arch=ARCH):
    cfgs = []
    for get in (get_a, get_b):
        c = get(arch)
        if layout is not None:
            c = dataclasses.replace(c, n_heads=layout[0], n_kv_heads=layout[1],
                                    d_head=layout[2])
        cfgs.append(c)
    return cfgs


def _drive_new(jcfg, cfg, method, steps, seed, B=2, T=100):
    """Prefill a T-token prompt, then ``steps`` decode steps with a query
    that drifts and the previous step's query as ``q_proxy`` (zeros first):
    every state leaf equal (integers exactly, floats within 2e-5) after the
    prefill and after each step, outputs within 2e-5, the block counts and
    the granularity equal. Returns the number of steps on which a page
    completed."""
    jr, r = jmake_retriever(jcfg, JFreeKVConfig(method=method, **SMALL)), \
        make_retriever(cfg, FreeKVConfig(method=method, **SMALL))
    rng = np.random.default_rng(seed)
    kv, H, d = cfg.n_kv_heads, cfg.n_heads, cfg.d_head
    k = rng.standard_normal((B, T, kv, d)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    base = rng.standard_normal((B, H, d)).astype(np.float32)
    # the reference jitted, a compile a shape instead of one an op (its
    # info's granularity, a string, stays outside)
    def jdecode_info(*a, **kw):
        o, st_, info = jr.decode(*a, **kw)
        return o, st_, {k_: x for k_, x in info.items() if k_ != "granularity"}

    jdecode = jax.jit(jdecode_info)
    jst = jax.jit(jr.prefill)(jr.init_state(B, 160, jnp.float32), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(base))
    st = r.prefill(r.init_state(B, 160, torch.float32, "cpu"), _t(k), _t(v), _t(base))

    def same(where):
        assert set(jst) <= set(st), where
        for key in jst:
            a, b = np.asarray(jst[key]), st[key].numpy()
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, **TOL, err_msg=f"{where} {key}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{where} {key}")

    same("prefill")
    qp = np.zeros_like(base)
    completed = 0
    for t in range(steps):
        q = (base + (0.3, 1.5)[t % 3 == 0] * rng.standard_normal(base.shape)).astype(np.float32)
        kn = rng.standard_normal((B, kv, d)).astype(np.float32)
        vn = rng.standard_normal(kn.shape).astype(np.float32)
        jo, jst, jinfo = jdecode(jst, jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                                 q_proxy=jnp.asarray(qp))
        o, st, info = r.decode(st, _t(q), _t(kn), _t(vn), q_proxy=_t(qp))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
        same(f"step {t}")
        for key in ("corrected", "sync_pages", "async_pages"):
            np.testing.assert_array_equal(_n(info[key]), np.asarray(jinfo[key]), err_msg=key)
        assert info["granularity"] == ("token" if method == "infinigen" else "page")
        completed += int((int(st["length"][0]) % SMALL["page_size"]) == 0)
        qp = q
    return completed


@pytest.mark.parametrize("method", NEW)
def test_new_retriever_matches_reference(method):
    """Quest, RaaS, StreamingLLM and InfiniGen: a prefill and 16 decode
    steps (two page completions) against the reference's, every state leaf
    compared: RaaS's kept page ids and timestamps and Quest's pool and
    summaries exactly, InfiniGen's selected ids (from the proxy query)
    exactly."""
    jcfg, cfg = _pair_retrievers(jget_config, get_config, method)
    assert _drive_new(jcfg, cfg, method, 16, seed=7) == 2


@pytest.mark.parametrize("arch", sorted(REAL_LAYOUTS))
def test_new_retrievers_real_head_layouts(arch):
    """The four new retrievers and FreeKV at a served arch's real head
    layout (G = 7, 3, 1 or 2; d_head 128, 64, 80 or 256), 6 decode steps
    each (a page completing), against the reference's."""
    for method in NEW + ("freekv",):
        jcfg, cfg = _pair_retrievers(jget_config, get_config, method, REAL_LAYOUTS[arch])
        assert cfg.group_size == REAL_LAYOUTS[arch][0] // REAL_LAYOUTS[arch][1]
        assert _drive_new(jcfg, cfg, method, 6, seed=8, T=90) == 1


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _llama2(get):
    return dataclasses.replace(get("llama31-8b-smoke"), n_layers=2, n_periods=2)


@pytest.mark.parametrize("method,quant", [("shadowkv", "none"), ("shadowkv", "int8"),
                                          ("centroid", "none")])
def test_static_engine_greedy_tokens_equal_reference(method, quant):
    """ServeEngine(scheduler="static") on a 2-layer llama31-8b-smoke: 3 needle
    requests x 8 greedy tokens, batch 2, equal to the JAX engine's, with
    equal per-request block counts."""
    kw = dict(method=method, kv_quant=quant, **CENT)
    jcfg, cfg = _llama2(jget_config), _llama2(get_config)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    p = model.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    stream = needle_stream(cfg.vocab_size, 96, 8, seed=1)
    prompts = [next(stream).tokens for _ in range(3)]
    jeng = JServeEngine(jcfg, JFreeKVConfig(**kw), jp, max_len=128, batch_size=2,
                        scheduler="static")
    eng = ServeEngine(cfg, FreeKVConfig(**kw), p, max_len=128, batch_size=2,
                      scheduler="static", device="cpu")
    jouts = jeng.generate([JRequest(uid=i, tokens=t, max_new_tokens=8)
                           for i, t in enumerate(prompts)])
    outs = eng.generate([Request(uid=i, tokens=t, max_new_tokens=8)
                         for i, t in enumerate(prompts)])
    assert [o.tokens for o in outs] == [o.tokens for o in jouts]
    assert all(len(o.tokens) == 8 for o in outs)
    for o, jo in zip(outs, jouts):
        for key in ("corrected", "sync_pages", "reused_pages"):
            assert o.stats[key] == jo.stats[key], key
