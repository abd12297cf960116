"""The port's model and static serving engine held against the reference on
the CPU: parameters carried over with ``params_from_jax``, logits within
1e-4, greedy tokens exactly equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import FreeKVConfig as JFreeKVConfig
from repro.models import model as jmodel
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import FreeKVConfig
from repro_torch.data.synthetic import needle_stream
from repro_torch.models import model
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.sampling import SamplerConfig

torch.set_float32_matmul_precision("highest")
FKV = dict(method="freekv", page_size=8, budget=64, n_sink=8, n_window=8, tau=0.8)


def _llama2(get):
    """A 2-layer llama31-8b-smoke: two decode states and two layers' weights."""
    return dataclasses.replace(get("llama31-8b-smoke"), n_layers=2, n_periods=2)


def _pair(arch):
    if arch == "llama31-8b-smoke-2l":
        return _llama2(jget_config), _llama2(get_config)
    return jget_config(arch), get_config(arch)


def _params(jcfg, cfg, seed=0):
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, model.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def test_params_from_jax_round_trip():
    """Every reference leaf lands in the port's tree unchanged, stacked
    pattern leaves split per layer in order, ``x @ W`` orientation kept."""
    jcfg, cfg = _pair("llama31-8b-smoke-2l")
    jp, p = _params(jcfg, cfg)
    assert len(p["layers"]) == cfg.n_layers == 2
    np.testing.assert_array_equal(p["embed"]["tok"].numpy(), np.asarray(jp["embed"]["tok"]))
    np.testing.assert_array_equal(p["embed"]["head"].numpy(), np.asarray(jp["embed"]["head"]))
    np.testing.assert_array_equal(p["final_norm"]["w"].numpy(),
                                  np.asarray(jp["final_norm"]["w"]))
    flat, _ = jax.tree_util.tree_flatten_with_path(jp["pattern"][0])
    for path, leaf in flat:
        keys = [k.key for k in path]
        for i in range(cfg.n_layers):
            t = p["layers"][i]
            for key in keys:
                t = t[key]
            np.testing.assert_array_equal(t.numpy(), np.asarray(leaf[i]), err_msg=str(keys))
    assert p["layers"][0]["mixer"]["wq"].shape == (cfg.d_model, cfg.n_heads * cfg.d_head)
    assert p["layers"][0]["ffn"]["down"].shape == (cfg.d_ff, cfg.d_model)
    assert model.init_params(cfg, seed=0, device="cpu")["layers"][1]["ffn"]["up"].shape \
        == p["layers"][1]["ffn"]["up"].shape


@pytest.mark.parametrize("arch", ["granite-3-8b-smoke", "llama31-8b-smoke-2l"])
def test_prefill_and_serve_step_logits(arch):
    """Prefill logits, then five decode steps fed the reference's greedy
    tokens: logits within 1e-4 and the same per-layer selected pages."""
    jcfg, cfg = _pair(arch)
    jp, p = _params(jcfg, cfg)
    jfkv, fkv = JFreeKVConfig(**FKV), FreeKVConfig(**FKV)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 96)).astype(np.int32)
    max_len = 128
    jprefill = jax.jit(lambda pp, b: jmodel.prefill(jcfg, jfkv, pp, b, max_len,
                                                    state_dtype=jnp.float32))
    jstep = jax.jit(lambda pp, s, t: jmodel.serve_step(jcfg, jfkv, pp, s, t))
    jlog, jst = jprefill(jp, {"tokens": jnp.asarray(toks)})
    log, st = model.prefill(cfg, fkv, p, {"tokens": torch.from_numpy(toks).long()}, max_len,
                            state_dtype=torch.float32)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-4, rtol=1e-4)
    for _ in range(5):
        cur = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)[:, None]
        jlog, jst = jstep(jp, jst, jnp.asarray(cur))
        log, st = model.serve_step(cfg, fkv, p, st, torch.from_numpy(cur).long())
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-4, rtol=1e-4)
        for i in range(cfg.n_layers):
            np.testing.assert_array_equal(
                st["layers"][i]["sel_idx"].numpy(),
                np.asarray(jst["pattern"][0]["sel_idx"][i]))
    assert st["pos"].tolist() == st["pos_host"].tolist() == [101, 101]


@pytest.mark.parametrize("arch", ["granite-3-8b-smoke", "llama31-8b-smoke-2l"])
def test_static_engine_greedy_tokens_equal_reference(arch):
    """ServeEngine(scheduler="static"): 3 needle requests x 8 greedy tokens,
    batch 2 (so one full and one partial batch), equal to the JAX engine."""
    jcfg, cfg = _pair(arch)
    jp, p = _params(jcfg, cfg)
    stream = needle_stream(cfg.vocab_size, 96, 8, seed=1)
    prompts = [next(stream).tokens for _ in range(3)]
    jeng = JServeEngine(jcfg, JFreeKVConfig(**FKV), jp, max_len=128, batch_size=2,
                        scheduler="static")
    eng = ServeEngine(cfg, FreeKVConfig(**FKV), p, max_len=128, batch_size=2,
                      scheduler="static", device="cpu")
    jouts = jeng.generate([JRequest(uid=i, tokens=t, max_new_tokens=8)
                           for i, t in enumerate(prompts)])
    outs = eng.generate([Request(uid=i, tokens=t, max_new_tokens=8)
                         for i, t in enumerate(prompts)])
    assert [o.tokens for o in outs] == [o.tokens for o in jouts]
    assert all(len(o.tokens) == 8 for o in outs)
    for o, jo in zip(outs, jouts):
        assert o.stats["corrected"] == jo.stats["corrected"]
        assert o.stats["sync_pages"] == jo.stats["sync_pages"]


@pytest.mark.parametrize("kv_quant", ["none", "int8", "int4"])
def test_static_path_takes_every_kv_quant(kv_quant):
    """The static lockstep path takes every ``kv_quant`` (the quantized host
    tier is ported); the continuous scheduler is the default."""
    cfg = get_config("granite-3-8b-smoke")
    fkv = FreeKVConfig(**FKV, kv_quant=kv_quant)
    assert ServeEngine(cfg, fkv, {}, max_len=64, batch_size=1, scheduler="static",
                       device="cpu").scheduler == "static"
    assert ServeEngine(cfg, fkv, {}, max_len=64, batch_size=1,
                       device="cpu").scheduler == "continuous"


def test_continuous_samples_on_request_streams():
    """The continuous scheduler takes a temperature and draws on the
    reference's per-request streams: a request's first token is token 0 of
    ``request_key(seed, uid)``'s stream from its prefill logits, and its
    tokens do not depend on the slot count or the host-read cadence (the
    tokens against the reference's: ``test_torch_sampling.py``)."""
    from repro_torch.serving.sampling import request_key, sample_counted
    cfg = get_config("granite-3-8b-smoke")
    params = model.init_params(cfg, seed=0, device="cpu")
    sampler = SamplerConfig(temperature=0.7)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, 64).astype(np.int32)
    outs = {}
    for name, kw, slots in (("k8", {}, 1), ("k1", dict(sync_interval=1), 2),
                            ("sync", dict(sample_on_device=False), 2)):
        eng = ServeEngine(cfg, FreeKVConfig(**FKV, **kw), params, max_len=128, batch_size=slots,
                          sampler=sampler, device="cpu")
        outs[name] = {o.uid: o.tokens for o in eng.generate(
            [Request(uid=u, tokens=prompt, max_new_tokens=6) for u in (3, 4)], seed=5)}
    assert outs["k8"] == outs["k1"] == outs["sync"]
    assert outs["k8"][3] != outs["k8"][4]          # one prompt, two streams
    logits, _, _, _ = eng.prefill_one(Request(uid=3, tokens=prompt, max_new_tokens=6))
    for uid in (3, 4):
        first = sample_counted(logits, sampler, request_key(5, uid)[None],
                               torch.zeros((1,), dtype=torch.int32))
        assert int(first[0]) == outs["k8"][uid][0]
    ServeEngine(cfg, FreeKVConfig(**FKV), {}, max_len=64, batch_size=1,
                sampler=SamplerConfig(temperature=0.7), scheduler="static", device="cpu")