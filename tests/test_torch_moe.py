"""The port's MoE FFN (``repro_torch/models/moe.py``) and the MoE archs
through the serving engine, held against the JAX package on the CPU with
the reference's weights (``params_from_jax``) and numpy-seeded inputs:

* the module on deepseek-moe-16b-smoke (4 experts, top-2, a shared expert)
  and llama4-scout-17b-a16e-smoke (top-1): at float32 ``y`` and ``aux``
  within 2e-5, expert ids and ``capacity_keep_mask`` exactly equal, also
  with the router biased toward one expert (tied logits elsewhere) so that
  capacity drops assignments; each package's dense oracle against its own ``apply_moe``;
  at bfloat16 within 5e-2; the router float32 after ``init_params`` and
  ``params_from_jax(dtype=bfloat16)``;
* the continuous engine against the JAX engine (page_size 8, budget 64):
  deepseek over 6 slots with idle lanes and turnover, a chunked prefill (a
  held lane), a prefix-cache hit, a preemption, the static left-padded
  batch, ``prefill_bucket`` 8 and an eos with admissions queued; scout over
  8 slots continuous, chunked and static. Tokens, steps and
  per-request block counts exactly equal, and in every run the port's own
  routing (``capacity_keep_mask`` on each ``apply_moe`` call's routing)
  dropped assignments in at least one prefill call and one decode step;
  ``draft_len=4`` falls back to ``draft_len=0``'s tokens.

Capacity couples the rows of a call, so these runs also hold what every
idle or held lane feeds the router. One JAX engine per arch serves all of
its runs: a run sets the scheduler's switches, which its compiled
functions never read."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import FreeKVConfig as JFreeKVConfig
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.prefix_cache import RadixPrefixCache as JRadixPrefixCache
from repro_torch.configs import get_config
from repro_torch.configs.base import MOE, FreeKVConfig
from repro_torch.models import model, moe
from repro_torch.serving.engine import Request, ServeEngine

torch.set_float32_matmul_precision("highest")
TOL = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=5e-2, rtol=5e-2)
FKV = dict(page_size=8, budget=64, n_sink=8, n_window=8, tau=0.8)
MAX_LEN = 192
ARCHS = ("deepseek-moe-16b-smoke", "llama4-scout-17b-a16e-smoke")
SLOTS = {"deepseek-moe-16b-smoke": 6, "llama4-scout-17b-a16e-smoke": 8}


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


def _tree_torch(tree, dtype=None):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(
        dtype or torch.float32), tree)


def _layer(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jp = jmoe.moe_init(jax.random.PRNGKey(3), jcfg)
    return jcfg, cfg, jp


def _biased(jp, on):
    """The router biased toward expert 0 as ``tests/test_blocks.py`` biases
    it (zeros, column 0 at 100): a token's logit for expert 0 is 100 times
    its sum of inputs and every other logit 0, so the ties among experts
    1..E-1 go to the lower ids and capacity binds."""
    if not on:
        return jp
    return dict(jp, router=jnp.zeros_like(jp["router"]).at[:, 0].set(100.0))


def _x(cfg, shape=(2, 24), seed=0):
    return np.random.default_rng(seed).standard_normal(shape + (cfg.d_model,)).astype(np.float32)


@pytest.mark.parametrize("biased", [False, True], ids=["balanced", "biased"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_reference(arch, biased):
    """y and aux within 2e-5 at float32; the routed expert ids and which
    assignments survive the capacity cut exactly the reference's."""
    jcfg, cfg, jp = _layer(arch)
    jp = _biased(jp, biased)
    p = _tree_torch(jp)
    x = _x(cfg)
    jy, jaux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    y, aux = moe.apply_moe(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), **TOL)
    xf = x.reshape(-1, cfg.d_model)
    _, jidx, jw = jmoe._route(jcfg, jp["router"], jnp.asarray(xf))
    _, idx, w = moe.route(cfg, p["router"], torch.from_numpy(xf))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    cap = moe.capacity(xf.shape[0], cfg.n_experts, cfg.moe_top_k)
    assert cap == jmoe._capacity(xf.shape[0], jcfg.n_experts, jcfg.moe_top_k)
    keep = moe.capacity_keep_mask(idx, cfg.n_experts, cap)
    np.testing.assert_array_equal(keep.numpy(),
                                  np.asarray(jmoe.capacity_keep_mask(jidx, jcfg.n_experts, cap)))
    if biased:
        assert not bool(keep.all()), "the biased router dropped nothing"


@pytest.mark.parametrize("biased", [False, True], ids=["balanced", "biased"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_oracles_agree_with_apply_moe(arch, biased):
    """Each package's capacity-aware dense oracle against its own
    ``apply_moe`` (2e-5), and the two oracles against each other."""
    jcfg, cfg, jp = _layer(arch)
    jp = _biased(jp, biased)
    p = _tree_torch(jp)
    x = _x(cfg, seed=1)
    jy = np.asarray(jmoe.apply_moe(jcfg, jp, jnp.asarray(x))[0])
    jref = np.asarray(jmoe.moe_dense_reference(jcfg, jp, jnp.asarray(x)))
    y = moe.apply_moe(cfg, p, torch.from_numpy(x))[0].numpy()
    pref = moe.moe_dense_reference(cfg, p, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(jy, jref, **TOL)
    np.testing.assert_allclose(y, pref, **TOL)
    np.testing.assert_allclose(pref, jref, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_bf16_matches_reference(arch):
    """At bfloat16 (the router float32, as both packages keep it) the port's
    output within 5e-2 of the reference's, the drops included."""
    jcfg, cfg, jp = _layer(arch)
    jp = _biased(jp, True)
    jpb = {k: (v if k == "router" else jax.tree.map(lambda a: a.astype(jnp.bfloat16), v))
           for k, v in jp.items()}
    p = {k: (_tree_torch(v) if k == "router" else _tree_torch(v, torch.bfloat16))
         for k, v in jp.items()}
    x = _x(cfg, seed=2)
    jy = jmoe.apply_moe(jcfg, jpb, jnp.asarray(x).astype(jnp.bfloat16))[0]
    y = moe.apply_moe(cfg, p, torch.from_numpy(x).to(torch.bfloat16))[0]
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy.astype(jnp.float32)), **BF16)
    assert torch.equal(y, moe.apply_moe(cfg, p, torch.from_numpy(x).to(torch.bfloat16))[0])


def test_router_stays_float32():
    """The router is float32 after ``init_params`` and after
    ``params_from_jax(dtype=bfloat16)``; every other leaf takes the dtype."""
    cfg, jcfg = get_config("deepseek-moe-16b-smoke"), jget_config("deepseek-moe-16b-smoke")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    for params in (model.init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16),
                   model.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu",
                                         dtype=torch.bfloat16)):
        for (mixer, ffn), lp in zip(cfg.layers, params["layers"]):
            if ffn == MOE:
                assert lp["ffn"]["router"].dtype == torch.float32
                assert lp["ffn"]["router"].shape == (cfg.d_model, cfg.n_experts)
                assert lp["ffn"]["wg"].shape == (cfg.n_experts, cfg.d_model, cfg.d_expert)
                assert lp["ffn"]["wd"].shape == (cfg.n_experts, cfg.d_expert, cfg.d_model)
                assert lp["ffn"]["shared"]["up"].shape == (cfg.d_model, cfg.d_expert)
                assert all(t.dtype == torch.bfloat16 for k, t in lp["ffn"].items()
                           if isinstance(t, torch.Tensor) and k != "router")
            assert lp["mixer"]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("n", [1, 4, 6, 8, 34, 35, 1024, 8192])
def test_capacity_is_the_references(n):
    for E, k in ((64, 6), (4, 2), (16, 1), (16, 2)):
        assert moe.capacity(n, E, k) == jmoe._capacity(n, E, k)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------
# two prompt lengths (bucket 8 pads the trimmed ones back to them), so the
# JAX engine compiles few prefill shapes
LENS = (40, 56)
NEWS = (10, 4, 14, 6, 9, 5, 12, 7, 11, 3)
_ENGINES = {}
_PORT_TOKENS = {}       # arch -> the port's tokens of the plain continuous run


def _models(arch):
    if arch not in _ENGINES:
        jcfg, cfg = jget_config(arch), get_config(arch)
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        p = model.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
        jeng = JServeEngine(jcfg, JFreeKVConfig(**FKV), jp, max_len=MAX_LEN,
                            batch_size=SLOTS[arch])
        _ENGINES[arch] = (jcfg, cfg, jp, p, jeng)
    return _ENGINES[arch]


def _jax_run(jeng, reqs, chunk=0, preempt=False, prefix_tokens=0, bucket=1,
             scheduler="continuous"):
    """The shared JAX engine with this run's switches."""
    jeng.fkv = dataclasses.replace(jeng.fkv, prefill_chunk_tokens=chunk, preempt=preempt)
    jeng.prefix_cache = JRadixPrefixCache(prefix_tokens) if prefix_tokens else None
    jeng.prefill_bucket, jeng.scheduler = bucket, scheduler
    outs = jeng.generate(reqs)
    return outs, jeng.last_metrics


@contextlib.contextmanager
def routing_drops():
    """Count the assignments the port's MoE layers drop, split into decode
    steps (calls over (B, 1) tokens) and prefill calls: each call of
    ``moe.apply_moe`` is routed again on its input and its
    ``capacity_keep_mask`` read."""
    seen = {"prefill": 0, "decode": 0}
    apply = moe.apply_moe

    def spy(c, p, x):
        B, T, d = x.shape
        _, idx, _ = moe.route(c, p["router"], x.reshape(B * T, d))
        keep = moe.capacity_keep_mask(idx, c.n_experts,
                                      moe.capacity(B * T, c.n_experts, c.moe_top_k))
        seen["decode" if T == 1 else "prefill"] += int((~keep).sum())
        return apply(c, p, x)
    moe.apply_moe = spy
    try:
        yield seen
    finally:
        moe.apply_moe = apply


def _prompts(cfg, n, seed=0, lens=LENS):
    return [np.random.default_rng(seed + i).integers(0, cfg.vocab_size, lens[i % len(lens)])
            .astype(np.int32) for i in range(n)]


def _requests(cls, prompts, news=NEWS, prio=None, eos=None):
    return [cls(uid=i, tokens=t, max_new_tokens=news[i % len(news)],
                priority=int(prio is not None and i == prio), eos_token=(eos or {}).get(i))
            for i, t in enumerate(prompts)]


def _both(arch, prompts, news=NEWS, prio=None, fkv_kw=None, eng_kw=None, eos=None):
    """(reference outputs and metrics, port outputs and metrics, drops)."""
    jcfg, cfg, jp, p, jeng = _models(arch)
    fkv_kw, eng_kw = dict(fkv_kw or {}), dict(eng_kw or {})
    jouts, jem = _jax_run(jeng, _requests(JRequest, prompts, news, prio, eos),
                          chunk=fkv_kw.get("prefill_chunk_tokens", 0),
                          preempt=fkv_kw.get("preempt", False),
                          prefix_tokens=eng_kw.get("prefix_cache_tokens", 0),
                          bucket=eng_kw.get("prefill_bucket", 1),
                          scheduler=eng_kw.get("scheduler", "continuous"))
    eng = ServeEngine(cfg, FreeKVConfig(**FKV, **fkv_kw), p, max_len=MAX_LEN,
                      batch_size=SLOTS[arch], device="cpu", **eng_kw)
    with routing_drops() as drops:
        outs = eng.generate(_requests(Request, prompts, news, prio, eos))
    return (jouts, jem), (outs, eng.last_metrics), drops


def _assert_equal(ref, port):
    """Tokens, each request's steps and block counts, and the engine's
    decode steps (the reference's static path counts none)."""
    (jouts, jem), (outs, em) = ref, port
    assert [o.tokens for o in outs] == [o.tokens for o in jouts]
    assert [o.steps for o in outs] == [o.steps for o in jouts]
    if jem.scheduler == "continuous":
        assert em.steps == jem.steps
    for o, jo in zip(outs, jouts):
        for key in ("corrected", "sync_pages", "async_pages"):
            assert o.stats[key] == jo.stats[key], (o.uid, key)


DEEPSEEK, SCOUT = ARCHS
# every case on deepseek; scout (top-1) through the continuous scheduler, a
# chunked prefill and the static batch
CASES = [(DEEPSEEK, c) for c in ("continuous", "chunked", "prefix hit", "preempt", "static",
                                 "bucket", "eos")] + \
    [(SCOUT, c) for c in ("continuous", "chunked", "static")]


@pytest.mark.parametrize("arch,case", CASES)
def test_moe_engine_matches_reference(arch, case):
    """10 requests of mixed lengths over 6 (deepseek) or 8 (scout) slots:
    lanes idle and turn over, and capacity binds at decode. ``chunked``:
    40-token prompts, 20 tokens a round, so admitted requests hold their
    slots for rounds;
    ``prefix hit``: 3 requests sharing 64 prompt tokens; ``preempt``: the
    last request has priority 1; ``static``: lockstep batches of the slot
    count, left-padded; ``bucket``: prompts left-padded to 8-token buckets;
    ``eos``: request 4 ends by an eos picked inside a window while
    admissions are queued (the window stops where the reference's does).
    Tokens, steps, block counts (and chunks, hits, preemptions, swap bytes)
    exactly equal; drops in a prefill and a decode step."""
    jcfg, cfg, jp, p, jeng = _models(arch)
    prompts, prio, fkv_kw, eng_kw = _prompts(cfg, 10), None, {}, {}
    if case == "chunked":
        prompts, fkv_kw = [t[:40] for t in prompts], dict(prefill_chunk_tokens=20)
    elif case == "prefix hit":
        shared = _prompts(cfg, 1, seed=50, lens=(64,))[0]
        prompts = [np.concatenate([shared, t[:8 + 16 * (i % 2)]]) for i, t in
                   enumerate(prompts)]
        eng_kw = dict(prefix_cache_tokens=4096)
    elif case == "preempt":
        fkv_kw, prio = dict(preempt=True), len(prompts) - 1
    elif case == "static":
        eng_kw = dict(scheduler="static")
    elif case == "bucket":
        prompts = [t[: len(t) - 3 - i % 3] for i, t in enumerate(prompts)]
        eng_kw = dict(prefill_bucket=8)
    eos = {}
    if case == "eos":
        # request 4's first token not made before, its third or later: read
        # inside a window, with the queue still holding requests
        if arch not in _PORT_TOKENS:
            _PORT_TOKENS[arch] = [o.tokens for o in ServeEngine(
                cfg, FreeKVConfig(**FKV), p, max_len=MAX_LEN, batch_size=SLOTS[arch],
                device="cpu").generate(_requests(Request, prompts))]
        full = _PORT_TOKENS[arch][4]
        eos = {4: next(t for i, t in enumerate(full) if i >= 2 and t not in full[:i])}
    ref, port, drops = _both(arch, prompts, prio=prio, fkv_kw=fkv_kw, eng_kw=eng_kw, eos=eos)
    if case == "continuous":
        _PORT_TOKENS[arch] = [o.tokens for o in port[0]]
    _assert_equal(ref, port)
    (jouts, jem), (outs, em) = ref, port
    assert (em.prefill_chunks, em.preemptions, em.swap_out_bytes, em.swap_in_bytes) == \
        (jem.prefill_chunks, jem.preemptions, jem.swap_out_bytes, jem.swap_in_bytes)
    assert [m.prefix_hit_tokens for m in em.requests] == \
        [m.prefix_hit_tokens for m in jem.requests]
    assert drops["prefill"] > 0 and drops["decode"] > 0, drops
    if case == "chunked":
        assert em.prefill_chunks > len(prompts)
    elif case == "prefix hit":
        assert sum(m.prefix_hit_tokens > 0 for m in em.requests) >= 3
    elif case == "preempt":
        assert em.preemptions >= 1 and em.swap_in_bytes == em.swap_out_bytes > 0
    elif case == "eos":
        assert 3 <= len(outs[4].tokens) < NEWS[4] and outs[4].tokens[-1] == eos[4]


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_spec_decode_falls_back_to_draft_len_0(arch):
    """``draft_len=4`` on a MoE arch serves ``draft_len=0`` (the reference's
    ``supports_spec_decode`` refuses non-dense FFNs): the same tokens."""
    jcfg, cfg, jp, p, _ = _models(arch)
    prompts = _prompts(cfg, 2, seed=20)
    toks = {}
    for draft in (0, 4):
        eng = ServeEngine(cfg, FreeKVConfig(**FKV, draft_len=draft), p, max_len=MAX_LEN,
                          batch_size=SLOTS[arch], device="cpu")
        assert not eng.spec_decode and eng.draft_len == 0
        toks[draft] = [o.tokens for o in eng.generate(_requests(Request, prompts))]
    assert toks[4] == toks[0]
    assert not jmodel.supports_spec_decode(jcfg, JFreeKVConfig(**FKV, draft_len=4))
