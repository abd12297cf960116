"""The archs the port serves beside granite-3-8b and llama31-8b, and the
new retrievers through the serving engine, held against the reference on
the CPU with the reference's weights (``params_from_jax``), page_size 8,
budget 64:

* qwen25-7b, gemma2-2b (sliding-window local layers served by a sink-less
  ``StreamingRetriever``, post-block norms, softcaps), smollm-360m,
  stablelm-3b (LayerNorm, 25% rotary), deepseek-moe-16b and
  llama4-scout-17b-a16e (MoE FFNs), jamba-1.5-large-398b (a Mamba + MoE
  and an attention + dense layer), xlstm-350m (an mLSTM and an sLSTM
  block), whisper-tiny (an encoder over 16 zero frames, cross-attention in
  every decoder layer) and internvl2-26b (16 zero patches ahead of each
  prompt), each at its smoke width (4 heads over 2 KV heads) and, but for
  xlstm, at a narrow config that keeps its real head layout (qwen 28/4,
  smollm 15/5, stablelm 32/32 at d_head 80, gemma2 8/4 at d_head 256,
  deepseek 16/16, scout 40/8, jamba 64/8 and internvl2 48/8 at d_head 128,
  whisper 6/6 at d_head 64): prefill logits within 2e-5 of the reference's
  and the prefill's decode state leaf for leaf (integers exactly; a
  recurrent layer's state, whisper's ``xk``/``xv``), then greedy tokens,
  steps and per-request block counts through the continuous engine exactly
  equal to the JAX engine's;
* quest, raas, streaming, infinigen and freekv with ``select_top_p`` on a
  2-layer llama31-8b-smoke through the continuous engine: tokens and block
  counts exactly equal;
* gemma2-smoke's chunked prefill and a prefix-cache hit, and a preemption
  under RaaS and Quest, against the JAX engine (tokens, chunks, hits,
  preemptions, swap bytes);
* ``supports_kv_extend`` and ``supports_spec_decode`` giving the
  reference's answers for every arch it registers.

The JAX engine of a config is built once and serves both its prefill check
(``prefill_one`` at the traffic's prompt length) and its run."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.configs.base import FreeKVConfig as JFreeKVConfig
from repro.models import model as jmodel
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.prefix_cache import RadixPrefixCache as JRadixPrefixCache
from repro_torch.configs import MAMBA, MLSTM, MOE, SLSTM, get_config
from repro_torch.configs.base import ATTN_LOCAL, FreeKVConfig
from repro_torch.core.retrieval import StreamingRetriever
from repro_torch.models import model
from repro_torch.serving.engine import Request, ServeEngine

torch.set_float32_matmul_precision("highest")
FKV = dict(page_size=8, budget=64, n_sink=8, n_window=8, tau=0.8)
TOL = dict(atol=2e-5, rtol=2e-5)
MAX_LEN = 192
ARCHS = ("qwen25-7b", "gemma2-2b", "smollm-360m", "stablelm-3b", "deepseek-moe-16b",
         "llama4-scout-17b-a16e", "jamba-1.5-large-398b", "xlstm-350m", "whisper-tiny",
         "internvl2-26b")
# (heads, KV heads, d_head) of each attention arch at full width (xlstm's
# heads only split its mixers' widths, which its smoke form already has)
REAL = {"qwen25-7b": (28, 4, 128), "gemma2-2b": (8, 4, 256), "smollm-360m": (15, 5, 64),
        "stablelm-3b": (32, 32, 80), "deepseek-moe-16b": (16, 16, 128),
        "llama4-scout-17b-a16e": (40, 8, 128), "jamba-1.5-large-398b": (64, 8, 128),
        "whisper-tiny": (6, 6, 64), "internvl2-26b": (48, 8, 128)}
ARCH_CASES = [pytest.param(a, r, id=f"{a}-{'real-heads' if r else 'smoke'}")
              for a in ARCHS for r in (False, True) if not r or a in REAL]
# three requests over two slots: one prompt length (one prefill compile),
# limits that turn a slot over while the other decodes; gemma2-smoke's
# 72-token prompts exceed its 64-token sliding window
LEN, NEWS = 72, (9, 4, 12)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the port's smoke-width steps are many
    small ops, and with several test workers sharing the cores the default
    thread pool spends its time spinning (a run under six workers took ~4x
    longer). The thread count does not change what a test checks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(get, arch, real):
    cfg = get(arch + "-smoke")
    if real:
        H, kv, d = REAL[arch]
        cfg = dataclasses.replace(cfg, n_heads=H, n_kv_heads=kv, d_head=d)
    return cfg


def _llama2(get):
    return dataclasses.replace(get("llama31-8b-smoke"), n_layers=2, n_periods=2)


def _prompts(cfg, n=3, length=LEN, seed=0):
    return [np.random.default_rng(seed + i).integers(0, cfg.vocab_size, length).astype(np.int32)
            for i in range(n)]


def _params(jcfg, cfg):
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, model.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _run(eng, cls, prompts, news=NEWS, priority=None):
    outs = eng.generate([cls(uid=i, tokens=t, max_new_tokens=m,
                             priority=int(priority is not None and i == priority))
                         for i, (t, m) in enumerate(zip(prompts, news))])
    return [o.tokens for o in outs], outs, eng.last_metrics


def _ref_layers(jcfg, jstate):
    """The reference's decode state per layer, in ``cfg.layers`` order."""
    layers = list(jstate["prelude"])
    for i in range(jcfg.n_periods):
        for stacked in jstate["pattern"]:
            layers.append(jax.tree.map(lambda a: a[i], stacked))
    return layers


_ARCH_RUNS = {}


def _arch_run(arch, real):
    """Both engines on one config: the prefill of the first prompt (logits
    and state), then the continuous run of the three requests."""
    key = (arch, real)
    if key not in _ARCH_RUNS:
        jcfg, cfg = _cfg(jget_config, arch, real), _cfg(get_config, arch, real)
        jp, p = _params(jcfg, cfg)
        prompts = _prompts(cfg)
        jeng = JServeEngine(jcfg, JFreeKVConfig(**FKV), jp, max_len=MAX_LEN, batch_size=2)
        eng = ServeEngine(cfg, FreeKVConfig(**FKV), p, max_len=MAX_LEN, batch_size=2,
                          device="cpu")
        req = dict(uid=0, tokens=prompts[0], max_new_tokens=4)
        jl, jst, _, _ = jeng.prefill_one(JRequest(**req))
        logits, st, _, _ = eng.prefill_one(Request(**req))
        _ARCH_RUNS[key] = dict(cfg=cfg, jcfg=jcfg, prefill=(jl, jst, logits, st),
                               runs=(_run(jeng, JRequest, prompts), _run(eng, Request, prompts)))
    return _ARCH_RUNS[key]


@pytest.mark.parametrize("arch,real", ARCH_CASES)
def test_arch_prefill_matches_reference(arch, real):
    """Prefill logits within 2e-5 and every layer's decode state equal to
    the reference's: the global layers' paged state, gemma2's local layers'
    sink-less ring of the last ``sliding_window`` tokens."""
    r = _arch_run(arch, real)
    cfg, jcfg = r["cfg"], r["jcfg"]
    jl, jst, logits, st = r["prefill"]
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    jlayers = _ref_layers(jcfg, jst)
    assert len(jlayers) == len(st["layers"]) == cfg.n_layers
    for i, (jlayer, layer) in enumerate(zip(jlayers, st["layers"])):
        assert set(jlayer) == set(layer), i
        for k, a in jlayer.items():
            a, b = np.asarray(a), layer[k].numpy()
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, **TOL, err_msg=f"layer {i} {k}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"layer {i} {k}")
    if arch == "gemma2-2b":
        assert cfg.layers[0][0] == ATTN_LOCAL
        assert st["layers"][0]["win_k"].shape[1] == cfg.sliding_window < LEN
        assert st["layers"][0]["sink_k"].shape[1] == 0


@pytest.mark.parametrize("arch,real", ARCH_CASES)
def test_arch_continuous_tokens_match_reference(arch, real):
    """Three requests over two slots through the continuous engine: greedy
    tokens, steps and each request's corrected heads and blocking pages
    exactly the JAX engine's (gemma2's local layers count in neither)."""
    (jtoks, jouts, jem), (toks, outs, em) = _arch_run(arch, real)["runs"]
    assert toks == jtoks
    assert [len(t) for t in toks] == list(NEWS)
    assert em.steps == jem.steps
    for o, jo in zip(outs, jouts):
        for key in ("corrected", "sync_pages", "async_pages"):
            assert o.stats[key] == jo.stats[key], key


@pytest.fixture(scope="module")
def llama2():
    jcfg, cfg = _llama2(jget_config), _llama2(get_config)
    return (jcfg, cfg) + _params(jcfg, cfg)


@pytest.mark.parametrize("method,top_p", [("quest", 0.0), ("raas", 0.0), ("streaming", 0.0),
                                          ("infinigen", 0.0), ("freekv", 0.9)])
def test_method_continuous_tokens_match_reference(llama2, method, top_p):
    """The new retrievers (and FreeKV's top-p budget) through the continuous
    engine on a 2-layer llama31-8b-smoke: tokens, steps and block counts
    exactly the JAX engine's."""
    jcfg, cfg, jp, p = llama2
    kw = dict(FKV, method=method, select_top_p=top_p)
    prompts = _prompts(cfg, seed=5)
    jtoks, jouts, jem = _run(JServeEngine(jcfg, JFreeKVConfig(**kw), jp, max_len=MAX_LEN,
                                          batch_size=2), JRequest, prompts)
    toks, outs, em = _run(ServeEngine(cfg, FreeKVConfig(**kw), p, max_len=MAX_LEN, batch_size=2,
                                      device="cpu"), Request, prompts)
    assert toks == jtoks and em.steps == jem.steps
    for o, jo in zip(outs, jouts):
        for key in ("corrected", "sync_pages", "async_pages", "sel_pages"):
            assert o.stats.get(key) == jo.stats.get(key), key


@pytest.mark.parametrize("case", ["gemma2 chunked", "gemma2 prefix hit", "raas preempt",
                                  "quest preempt"])
def test_features_take_new_archs_and_methods(llama2, case):
    """Chunked prefill (gemma2-smoke, 24-token chunks, local layers' window
    in the extension form), a prefix-cache hit (gemma2-smoke, 64 shared
    tokens) and a preemption (RaaS's kept pages and timestamps, Quest's
    pool on the card, swapped out and in) against the JAX engine: tokens,
    chunks, prefix hits, preemptions and swap bytes equal."""
    name, feature = case.split(" ", 1)
    if name == "gemma2":
        jcfg, cfg = _cfg(jget_config, "gemma2-2b", False), _cfg(get_config, "gemma2-2b", False)
        jp, p = _params(jcfg, cfg)
        kw, method = dict(FKV), "freekv"
    else:
        jcfg, cfg, jp, p = llama2
        kw, method = dict(FKV, method=name), name
    eng_kw, prio, news = {}, None, NEWS
    prompts = _prompts(cfg, seed=9)
    if feature == "chunked":
        kw["prefill_chunk_tokens"] = 24
    elif feature == "prefix hit":
        shared = prompts[0][:64]
        prompts = [np.concatenate([shared, t[:16]]) for t in prompts]
        eng_kw = dict(prefix_cache_tokens=4096, prefill_bucket=8)
    else:
        kw["preempt"], prio, news = True, 2, (10, 10, 10)
    jeng = JServeEngine(jcfg, JFreeKVConfig(**kw), jp, max_len=MAX_LEN, batch_size=2,
                        prefill_bucket=eng_kw.get("prefill_bucket", 1))
    if eng_kw:
        jeng.prefix_cache = JRadixPrefixCache(eng_kw["prefix_cache_tokens"])
    jtoks, _, jem = _run(jeng, JRequest, prompts, news, prio)
    toks, _, em = _run(ServeEngine(cfg, FreeKVConfig(**kw), p, max_len=MAX_LEN, batch_size=2,
                                   device="cpu", **eng_kw), Request, prompts, news, prio)
    assert toks == jtoks, method
    assert (em.steps, em.prefill_chunks, em.preemptions, em.swap_out_bytes, em.swap_in_bytes) \
        == (jem.steps, jem.prefill_chunks, jem.preemptions, jem.swap_out_bytes, jem.swap_in_bytes)
    hits = [m.prefix_hit_tokens for m in em.requests]
    assert hits == [m.prefix_hit_tokens for m in jem.requests]
    if feature == "chunked":
        assert em.prefill_chunks > len(prompts)
    elif feature == "prefix hit":
        assert hits[1:] == [64, 64]
    else:
        assert em.preemptions >= 1 and em.swap_in_bytes == em.swap_out_bytes > 0


def test_check_supported_admits_dense_and_refuses_the_rest():
    """gemma2's local layers and post-block norms, MoE FFNs, Mamba, mLSTM and
    sLSTM mixers, encoder-decoder and frontend stacks are served: every arch
    the reference registers is registered and admitted. An unknown mixer or
    FFN, an encoder-decoder with a recurrent decoder layer and an unknown
    arch stay refused."""
    gemma = get_config("gemma2-2b")
    model.check_supported(gemma)
    assert gemma.post_block_norm and ATTN_LOCAL in {m for m, _ in gemma.layers}
    rs = model.retrievers(gemma, FreeKVConfig())
    assert all(isinstance(r, StreamingRetriever) and r.window == 4096 and r.n_sink == 0
               for r, (m, _) in zip(rs, gemma.layers) if m == ATTN_LOCAL)
    base = get_config("llama31-8b-smoke")
    for ok in (get_config("deepseek-moe-16b"), get_config("llama4-scout-17b-a16e"),
               get_config("jamba-1.5-large-398b"),
               dataclasses.replace(base, pattern=(("attn", MOE),)),
               dataclasses.replace(base, pattern=((MAMBA, "dense"),))):
        model.check_supported(ok)
    assert {MOE} <= {f for _, f in get_config("deepseek-moe-16b").layers}
    assert {MAMBA, "attn"} == {m for m, _ in get_config("jamba-1.5-large-398b").layers}
    for ok in (dataclasses.replace(base, pattern=((SLSTM, "none"),)),
               dataclasses.replace(base, pattern=((MLSTM, "dense"),)),
               dataclasses.replace(base, is_encoder_decoder=True),
               dataclasses.replace(base, frontend="vision", n_frontend_tokens=8)):
        model.check_supported(ok)
    for arch in jlist_archs():
        for name in (arch, arch + "-smoke"):
            cfg = get_config(name)
            model.check_supported(cfg)
            jcfg = jget_config(name)          # every field the port keeps, the same
            for f in dataclasses.fields(cfg):
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), (name, f.name)
    for bad in (dataclasses.replace(base, pattern=(("retnet", "dense"),)),
                dataclasses.replace(base, pattern=(("attn", "glu2"),)),
                dataclasses.replace(base, pattern=((MAMBA, "dense"),), is_encoder_decoder=True)):
        with pytest.raises(NotImplementedError):
            model.check_supported(bad)
    with pytest.raises(KeyError, match="deepseek-moe-16b"):
        get_config("retnet-1b")


@pytest.mark.parametrize("arch", jlist_archs())
def test_gates_match_reference(arch):
    """``supports_kv_extend`` and ``supports_spec_decode`` (draft_len 0 and
    4 under freekv, arkvale, infinigen and quest) give the reference's
    answers, at full width and smoke width."""
    for name in (arch, arch + "-smoke"):
        cfg, jcfg = get_config(name), jget_config(name)
        assert model.supports_kv_extend(cfg) == jmodel.supports_kv_extend(jcfg), name
        for method in ("freekv", "arkvale", "infinigen", "quest"):
            for draft in (0, 4):
                kw = dict(method=method, draft_len=draft)
                assert model.supports_spec_decode(cfg, FreeKVConfig(**kw)) == \
                    jmodel.supports_spec_decode(jcfg, JFreeKVConfig(**kw)), (name, kw)
