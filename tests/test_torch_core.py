"""The port's FreeKV core (paging, correction, selection, recall pipeline,
retrievers) held against the reference package on the CPU. Inputs come from
numpy and go through both; float outputs agree within 2e-5 at float32,
integers (page ids, masks, block counts) exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import FreeKVConfig as JFreeKVConfig
from repro.core import correction as jcorrection
from repro.core import paging as jpaging
from repro.core import recall as jrecall
from repro.core import selection as jselection
from repro.core.recall_pipeline import RecallExecutor as JRecallExecutor
from repro.core.retrieval import make_retriever as jmake_retriever
from repro_torch.configs import get_config
from repro_torch.configs.base import FreeKVConfig
from repro_torch.core import correction, paging, selection
from repro_torch.core.recall_pipeline import RecallExecutor
from repro_torch.core.retrieval import make_retriever
from repro_torch.kernels import ops

torch.set_float32_matmul_precision("highest")
ARCH = "granite-3-8b-smoke"
SMALL = dict(page_size=8, budget=64, n_sink=8, n_window=8, tau=0.8)
TOL = dict(atol=2e-5, rtol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cfgs(**kw):
    return (jget_config(ARCH), JFreeKVConfig(**kw), get_config(ARCH), FreeKVConfig(**kw))


def _kv(rng, B, T, cfg):
    shape = (B, T, cfg.n_kv_heads, cfg.d_head)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def test_paging_prefill_and_appends():
    """prefill_fill_pool, then 40 appends that complete five pages: every
    leaf equal to the reference's (copies and min/max are exact)."""
    jcfg, jfkv, cfg, fkv = _cfgs(method="freekv", **SMALL)
    rng = np.random.default_rng(0)
    B, T, max_len = 2, 96, 160
    k, v = _kv(rng, B, T, cfg)
    jst = jpaging.init_kv_state(jcfg, jfkv, B, max_len, jnp.float32)
    jst = jpaging.prefill_fill_pool(jst, jnp.asarray(k), jnp.asarray(v),
                                    jnp.full((B,), T, jnp.int32))
    st = paging.init_kv_state(cfg, fkv, B, max_len, torch.float32, device="cpu")
    st = paging.prefill_fill_pool(st, _t(k), _t(v), T)
    for t in range(40):
        kn = rng.standard_normal((B, cfg.n_kv_heads, cfg.d_head)).astype(np.float32)
        vn = rng.standard_normal(kn.shape).astype(np.float32)
        jst = jpaging.append_token(jst, jnp.asarray(kn), jnp.asarray(vn))
        st = paging.append_token(st, _t(kn), _t(vn))
    assert set(st) == set(jst)
    for key in jst:
        np.testing.assert_array_equal(_n(st[key]), np.asarray(jst[key]), err_msg=key)
    assert int(st["length"][0]) == T + 40


def test_correction_matches_reference():
    jcfg, jfkv, cfg, fkv = _cfgs(method="freekv", **SMALL)
    rng = np.random.default_rng(1)
    B, H, d = 3, cfg.n_heads, cfg.d_head
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    scale = np.array([0.05, 0.5, 3.0], np.float32)[:, None, None]
    qprev = (q + scale * rng.standard_normal((B, H, d))).astype(np.float32)
    jc, jsim = jcorrection.corrected_heads(jcfg, jfkv, jnp.asarray(q), jnp.asarray(qprev))
    c, sim = correction.corrected_heads(cfg, fkv, _t(q), _t(qprev))
    np.testing.assert_allclose(sim.numpy(), np.asarray(jsim), **TOL)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert c.any() and (~c).any()


def _summ(rng, B, n, kv, d):
    raw = rng.standard_normal((B, n, kv, 2, d)).astype(np.float32)
    return np.stack([raw.min(axis=3), raw.max(axis=3)], axis=3)


@pytest.mark.parametrize("case", ["random", "ties"])
def test_select_pages_matches_reference(case):
    """Page ids equal exactly. ``ties``: identical page summaries and a
    large query make pooled scores tie exactly (and MeanS probabilities
    underflow to 0.0); the lower page id must come first, as in
    ``jax.lax.top_k``."""
    jcfg, jfkv, cfg, fkv = _cfgs(method="freekv", **SMALL)
    rng = np.random.default_rng(2)
    B, n, kv, H, d = 2, 24, cfg.n_kv_heads, cfg.n_heads, cfg.d_head
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    summ = _summ(rng, B, n, kv, d)
    if case == "ties":
        summ[:, 4:20] = summ[:, 3:4]        # pages 3..19 identical
        summ[:, 20:] *= 3.0
        q *= 40.0
    length = np.array([n * 8, n * 8 - 20], np.int32)
    n_sel = 6
    jidx, jpooled = jselection.select_pages(jcfg, jfkv, jnp.asarray(q), jnp.asarray(summ),
                                            jnp.asarray(length), n_sel)
    idx, pooled = selection.select_pages(cfg, fkv, _t(q), _t(summ), _t(length), n_sel)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), **TOL)
    if case == "ties":
        assert (pooled == 0.0).any()


def test_recall_executor_step_bit_exact():
    """``staged == fresh`` and ``use == where(corr, fresh, stale)`` bit for
    bit, plus equality with the reference executor and its block counts."""
    rng = np.random.default_rng(3)
    B, n_pages, kv, p, d, n_sel = 2, 20, 3, 8, 16, 5
    pool = rng.standard_normal((B, n_pages, kv, 2, p, d)).astype(np.float32)
    prev_idx = np.stack([rng.permutation(n_pages)[:n_sel] for _ in range(B * kv)])
    prev_idx = prev_idx.reshape(B, kv, n_sel).astype(np.int32)
    new_idx = prev_idx.copy()
    new_idx[..., :2] = rng.integers(0, n_pages, (B, kv, 2))
    new_idx[0, 0, -1] = -1
    prev_idx[1, 2, 0] = -1
    need = rng.random((B, kv)) < 0.5
    need[0, 0], need[0, 1] = True, False
    tpool, tnew, tprev = _t(pool), _t(new_idx), _t(prev_idx)
    prev_k, prev_v = (x.contiguous() for x in ops.recall_gather(tpool, tprev))
    pr = RecallExecutor(recall_fn=ops.recall_gather).step(
        tpool, tnew, tprev, prev_k, prev_v, _t(need))
    fresh_k, fresh_v = ops.recall_gather(tpool, tnew)
    assert torch.equal(pr.staged_k, fresh_k) and torch.equal(pr.staged_v, fresh_v)
    m = _t(need)[:, :, None, None, None]
    assert torch.equal(pr.use_k, torch.where(m, fresh_k, prev_k))
    assert torch.equal(pr.use_v, torch.where(m, fresh_v, prev_v))
    jpr = JRecallExecutor(recall_fn=jrecall.recall_pages).step(
        jnp.asarray(pool), jnp.asarray(new_idx), jnp.asarray(prev_idx),
        jnp.asarray(prev_k.numpy()), jnp.asarray(prev_v.numpy()), jnp.asarray(need))
    for name in ("use_k", "use_v", "use_idx", "staged_k", "staged_v",
                 "topup_blocks", "staged_blocks", "reused_blocks"):
        np.testing.assert_array_equal(_n(getattr(pr, name)), np.asarray(getattr(jpr, name)),
                                      err_msg=name)


def _setup(jcfg, jfkv, cfg, fkv, rng, B=2, T=96, max_len=160):
    k, v = _kv(rng, B, T, cfg)
    q_last = rng.standard_normal((B, cfg.n_heads, cfg.d_head)).astype(np.float32)
    jr = jmake_retriever(jcfg, jfkv)
    jst = jr.prefill(jr.init_state(B, max_len, jnp.float32),
                     jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_last))
    r = make_retriever(cfg, fkv)
    st = r.prefill(r.init_state(B, max_len, torch.float32, "cpu"), _t(k), _t(v), _t(q_last))
    return jr, jst, r, st, q_last


@pytest.mark.parametrize("method,overlap", [("freekv", True), ("freekv", False),
                                            ("arkvale", True)])
def test_retriever_decode_matches_reference(method, overlap):
    """20 decode steps: selected page ids equal every step, outputs within
    2e-5, recall block counts equal. The queries drift slowly, so some heads
    are corrected and some reuse their speculative pages."""
    jcfg, jfkv, cfg, fkv = _cfgs(method=method, recall_overlap=overlap, **SMALL)
    rng = np.random.default_rng(4)
    jr, jst, r, st, base = _setup(jcfg, jfkv, cfg, fkv, rng)
    B = base.shape[0]
    corrected = 0
    for t in range(20):
        q = (base + (0.2, 1.2)[t % 3 == 0] * rng.standard_normal(base.shape)).astype(np.float32)
        kn = rng.standard_normal((B, cfg.n_kv_heads, cfg.d_head)).astype(np.float32)
        vn = rng.standard_normal(kn.shape).astype(np.float32)
        jo, jst, jinfo = jr.decode(jst, jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn))
        o, st, info = r.decode(st, _t(q), _t(kn), _t(vn))
        np.testing.assert_array_equal(st["sel_idx"].numpy(), np.asarray(jst["sel_idx"]))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
        for key in ("corrected", "sync_pages", "async_pages", "sel_pages", "spec_hit_pages"):
            np.testing.assert_array_equal(_n(info[key]), np.asarray(jinfo[key]), err_msg=key)
        corrected += int(info["corrected"].sum())
    if method == "freekv":
        assert 0 < corrected < 20 * B * cfg.n_kv_heads


def test_freekv_full_budget_equals_full_attention():
    """Budget >= context: sink, window and selected pages partition the
    context exactly, so FreeKV equals the full-cache oracle (the reference's
    ``test_retrieval.py::test_freekv_full_budget_exact``)."""
    T = 96
    kw = dict(page_size=8, budget=T + 64, n_sink=16, n_window=16, tau=0.8)
    jcfg, jfkv, cfg, fkv = _cfgs(method="freekv", **kw)
    rng = np.random.default_rng(5)
    _, _, r, st, _ = _setup(jcfg, jfkv, cfg, fkv, rng, T=T)
    rng = np.random.default_rng(5)
    _, _, rf, stf, _ = _setup(jcfg, JFreeKVConfig(method="full"), cfg,
                              FreeKVConfig(method="full"), rng, T=T)
    for _ in range(20):
        q = rng.standard_normal((2, cfg.n_heads, cfg.d_head)).astype(np.float32)
        kn = rng.standard_normal((2, cfg.n_kv_heads, cfg.d_head)).astype(np.float32)
        vn = rng.standard_normal(kn.shape).astype(np.float32)
        o, st, _ = r.decode(st, _t(q), _t(kn), _t(vn))
        of, stf, _ = rf.decode(stf, _t(q), _t(kn), _t(vn))
        np.testing.assert_allclose(o.numpy(), of.numpy(), **TOL)
