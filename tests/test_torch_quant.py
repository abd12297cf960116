"""The port's quantized host KV tier (``repro_torch/quant``, the quantized
pool in ``core/paging``, the fused recall) held against the reference on the
CPU. Inputs come from numpy; everything here is exact: quantized integers,
scales, dequantized values, summaries, page ids and greedy tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import FreeKVConfig as JFreeKVConfig
from repro.core import paging as jpaging
from repro.kernels import ops as jops
from repro.models import model as jmodel
from repro.quant import accounting as jaccounting
from repro.quant import quantizers as jqz
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import FreeKVConfig
from repro_torch.core import paging
from repro_torch.data.synthetic import needle_stream
from repro_torch.kernels import ops
from repro_torch.models import model
from repro_torch.quant import accounting
from repro_torch.quant import quantizers as qz
from repro_torch.serving.engine import Request, ServeEngine

torch.set_float32_matmul_precision("highest")
SMALL = dict(method="freekv", page_size=8, budget=64, n_sink=8, n_window=8, tau=0.8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("scale_pow", [-3, 0, 3])
@pytest.mark.parametrize("group", [0, 8, 16])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantizers_bit_exact(bits, group, scale_pow):
    """quantize_block's integers and scales, and dequant_block at float32 and
    bfloat16, equal the reference's bit for bit; an all-zero page gets
    scale 1 and dequantizes to zeros."""
    rng = np.random.default_rng(10 * bits + group + scale_pow)
    x = (10.0 ** scale_pow * rng.standard_normal((3, 2, 2, 8, 32))).astype(np.float32)
    x[0] = 0.0
    jq, js = jqz.quantize_block(jnp.asarray(x), bits, group)
    q, s = qz.quantize_block(_t(x), bits, group)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (s[0] == 1).all()
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        got = qz.dequant_block(q, s, bits, tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(_n(got), _n(jqz.dequant_block(jq, js, bits, jdt)))
    assert not qz.dequant_block(q, s, bits)[0].any()


def test_int4_pack_unpack_every_byte():
    """unpack_int4 on all 256 byte values, and pack_int4 on the whole int4
    range, equal the reference; pack then unpack is the identity."""
    b = np.arange(-128, 128, dtype=np.int8).reshape(4, 64)
    np.testing.assert_array_equal(qz.unpack_int4(_t(b)).numpy(),
                                  np.asarray(jqz.unpack_int4(jnp.asarray(b))))
    q = np.random.default_rng(0).integers(-8, 8, (5, 64)).astype(np.int8)
    packed = qz.pack_int4(_t(q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jqz.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(qz.unpack_int4(packed).numpy(), q)


@pytest.mark.parametrize("bits,group", [(8, 0), (8, 16), (4, 0), (4, 8)])
def test_recall_gather_quant_ref_exact(bits, group):
    """The port's plain recall (what ``ops.recall_gather_quant`` runs on CPU
    tensors) against the reference's Pallas kernel in interpret mode and its
    ``dequant_recall_pages``, at ``tests/test_quant.py``'s shapes, with -1
    and -2 lanes (every negative id is invalid)."""
    B, n_pages, kv, p, d, n_sel = 2, 12, 3, 8, 32, 5
    rng = np.random.default_rng(bits + group)
    pool_f = rng.standard_normal((B, n_pages, kv, 2, p, d)).astype(np.float32)
    jpool, jsc = jqz.quantize_block(jnp.asarray(pool_f), bits, group)
    pool, sc = _t(jpool), _t(jsc)
    idx = rng.integers(-2, n_pages, (B, kv, n_sel)).astype(np.int32)
    idx[0, 0, :2] = (-1, -2)
    k, v = ops.recall_gather_quant(pool, sc, _t(idx), bits=bits)
    assert k.dtype == torch.float32 and k.shape == (B, kv, n_sel, p, d)
    jk, jv = jops.recall_gather_quant(jpool, jsc, jnp.asarray(idx), bits=bits,
                                      interpret=True)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert not k[0, 0, :2].any() and not v[0, 0, :2].any()
    kb, vb = ops.recall_gather_quant(pool, sc, _t(idx), bits=bits, out_dtype=torch.bfloat16)
    jkb, jvb = jqz.dequant_recall_pages(jpool, jsc, jnp.asarray(idx), bits, jnp.bfloat16)
    np.testing.assert_array_equal(_n(kb), _n(jkb))
    np.testing.assert_array_equal(_n(vb), _n(jvb))


def _cfgs(arch="granite-3-8b-smoke", **kw):
    return (jget_config(arch), JFreeKVConfig(**kw), get_config(arch), FreeKVConfig(**kw))


@pytest.mark.parametrize("kv_quant,group", [("int8", 0), ("int4", 0), ("int4", 16)])
def test_quant_paging_matches_reference(kv_quant, group):
    """prefill_fill_pool, then 24 appends that complete three pages under the
    quantized tier: pool integers, scales, summaries and every other leaf
    equal to the reference's."""
    jcfg, jfkv, cfg, fkv = _cfgs(kv_quant=kv_quant, quant_group_size=group, **SMALL)
    rng = np.random.default_rng(1)
    B, T, max_len, kv, d = 2, 96, 160, cfg.n_kv_heads, cfg.d_head
    k = rng.standard_normal((B, T, kv, d)).astype(np.float32)
    v = rng.standard_normal((B, T, kv, d)).astype(np.float32)
    jst = jpaging.init_kv_state(jcfg, jfkv, B, max_len, jnp.float32)
    jst = jpaging.prefill_fill_pool(jst, jnp.asarray(k), jnp.asarray(v),
                                    jnp.full((B,), T, jnp.int32))
    st = paging.init_kv_state(cfg, fkv, B, max_len, torch.float32, device="cpu")
    assert st["pool"].dtype == torch.int8 and st["pool_scale"].dtype == torch.float32
    assert paging.quant_info(st) == jpaging.quant_info(jst)
    st = paging.prefill_fill_pool(st, _t(k), _t(v), T)
    for t in range(24):
        kn = rng.standard_normal((B, kv, d)).astype(np.float32)
        vn = rng.standard_normal(kn.shape).astype(np.float32)
        jst = jpaging.append_token(jst, jnp.asarray(kn), jnp.asarray(vn))
        st = paging.append_token(st, _t(kn), _t(vn))
    assert set(st) == set(jst)
    for key in jst:
        np.testing.assert_array_equal(_n(st[key]), np.asarray(jst[key]), err_msg=key)
    assert int(st["pool"][:, 12:15].abs().sum()) > 0      # decode-time pages landed
    view = paging.pool_view(st)
    assert isinstance(view, tuple) and view.bits == (8 if kv_quant == "int8" else 4)
    assert view.out_dtype == torch.float32


def test_quant_state_bytes_and_accounting():
    """The packed pool's width and bytes, and the per-page byte accounting,
    agree with the reference's ``quant/accounting``; an fp state carries no
    scales and its pool view is the pool itself."""
    cfg = get_config("granite-3-8b-smoke")
    d = cfg.d_head
    for kv_quant, group in (("none", 0), ("int8", 0), ("int4", 0), ("int4", 16)):
        kw = dict(SMALL, kv_quant=kv_quant, quant_group_size=group)
        fkv, jfkv = FreeKVConfig(**kw), JFreeKVConfig(**kw)
        assert fkv.quant_bits == jfkv.quant_bits
        st = paging.init_kv_state(cfg, fkv, 2, 64, torch.float32, device="cpu")
        detail = accounting.pool_bytes_detail({"layers": [st, st]}, d, dense_itemsize=4)
        assert detail["payload"] == 2 * st["pool"].numel() * st["pool"].element_size()
        assert detail["physical"] == detail["payload"] + detail["scales"]
        assert paging.state_bytes(st) == sum(t.numel() * t.element_size() for t in st.values())
        for itemsize in (2, 4):
            assert accounting.page_block_bytes(fkv, d, itemsize) == \
                jaccounting.page_block_bytes(jfkv, d, itemsize)
        if kv_quant == "none":
            assert "pool_scale" not in st and paging.quant_info(st) is None
            assert paging.pool_view(st) is st["pool"] and detail["ratio"] == 1.0
        else:
            assert st["pool"].shape[-1] == d * fkv.quant_bits // 8
            assert detail["ratio"] > 1.0
    with pytest.raises(ValueError, match="kv_quant"):
        FreeKVConfig(kv_quant="int3")


def _pair(arch):
    if arch == "llama31-8b-smoke-2l":
        return tuple(dataclasses.replace(get("llama31-8b-smoke"), n_layers=2, n_periods=2)
                     for get in (jget_config, get_config))
    return jget_config(arch), get_config(arch)


def _prompts(cfg, n=3):
    stream = needle_stream(cfg.vocab_size, 96, 8, seed=1)
    return [next(stream).tokens for _ in range(n)]


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
@pytest.mark.parametrize("arch", ["granite-3-8b-smoke", "llama31-8b-smoke-2l"])
def test_static_engine_quant_tokens_equal_reference(arch, kv_quant):
    """ServeEngine(scheduler="static") under the quantized tier: 3 needle
    requests x 12 greedy tokens (a page completes, and is quantized, during
    decode), batch 2, equal to the JAX engine, with the same corrected heads
    and synchronous page counts."""
    jcfg, cfg = _pair(arch)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    p = model.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    kw = dict(SMALL, kv_quant=kv_quant)
    prompts = _prompts(cfg)
    jeng = JServeEngine(jcfg, JFreeKVConfig(**kw), jp, max_len=128, batch_size=2,
                        scheduler="static")
    eng = ServeEngine(cfg, FreeKVConfig(**kw), p, max_len=128, batch_size=2,
                      scheduler="static", device="cpu")
    jouts = jeng.generate([JRequest(uid=i, tokens=t, max_new_tokens=12)
                           for i, t in enumerate(prompts)])
    outs = eng.generate([Request(uid=i, tokens=t, max_new_tokens=12)
                         for i, t in enumerate(prompts)])
    assert [o.tokens for o in outs] == [o.tokens for o in jouts]
    assert all(len(o.tokens) == 12 for o in outs)
    for o, jo in zip(outs, jouts):
        assert o.stats["corrected"] == jo.stats["corrected"]
        assert o.stats["sync_pages"] == jo.stats["sync_pages"]


def test_quant_recall_overlap_same_tokens():
    """The staged recall carries the quantized pool view unchanged: with and
    without recall_overlap the int8 engine gives the same greedy tokens."""
    cfg = get_config("granite-3-8b-smoke")
    p = model.init_params(cfg, seed=0, device="cpu")
    prompts = _prompts(cfg, 2)
    toks = []
    for overlap in (True, False):
        eng = ServeEngine(cfg, FreeKVConfig(**SMALL, kv_quant="int8", recall_overlap=overlap),
                          p, max_len=128, batch_size=2, scheduler="static", device="cpu")
        toks.append([o.tokens for o in eng.generate(
            [Request(uid=i, tokens=t, max_new_tokens=12) for i, t in enumerate(prompts)])])
    assert toks[0] == toks[1]
