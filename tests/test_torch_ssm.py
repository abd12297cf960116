"""The port's Mamba mixer (``repro_torch/models/ssm.py``) and jamba through
the serving engine, held against the JAX package on the CPU with the
reference's weights (``params_from_jax``) and numpy-seeded inputs:

* the module on jamba-1.5-large-398b-smoke (d 256, d_inner 512, d_state
  16): ``mamba_forward``, its returned state and chained
  ``mamba_decode_step``s within 2e-5 of the reference's at float32, the
  forward equal to its own chained decode; at bfloat16 within 5e-2;
  ``A_log``, ``D`` and ``h`` float32 whatever the params' dtype;
* the slot pool carrying the Mamba leaves: reset, claim and the
  preemption swap, ``h`` float32 and bit for bit through the host;
* the engine against the JAX engine (jamba-smoke: a Mamba + MoE layer and
  an attention + dense layer; page_size 8, budget 64, 6 slots): the
  continuous scheduler with idle lanes and turnover, a preemption, the
  static left-padded batch and ``prefill_bucket`` 8 (pad tokens enter the
  recurrent state, as in the reference). Tokens, steps and block counts
  exactly equal, and the MoE layer's routing dropped assignments in a
  prefill and a decode step. With ``prefill_chunk_tokens`` and
  ``prefix_cache_tokens`` set, the port turns both off as the reference
  does (``supports_kv_extend``) and gives its tokens; ``draft_len=4``
  falls back to ``draft_len=0``'s."""
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
from repro.models import ssm as jssm
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import MAMBA, FreeKVConfig
from repro_torch.core.offload import swap_state_to_host
from repro_torch.models import model, moe, ssm
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.kv_slots import SlotPool

torch.set_float32_matmul_precision("highest")
TOL = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=5e-2, rtol=5e-2)
FKV = dict(page_size=8, budget=64, n_sink=8, n_window=8, tau=0.8)
ARCH = "jamba-1.5-large-398b-smoke"
MAX_LEN, SLOTS = 192, 6


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


def _block(dtype=None):
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    jp = jssm.mamba_init(jax.random.PRNGKey(1), jcfg)
    if dtype is not None:
        jp = {k: v if k in ("A_log", "D") else v.astype(dtype) for k, v in jp.items()}
    p = {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(
        torch.float32 if v.dtype == jnp.float32 else torch.bfloat16) for k, v in jp.items()}
    return jcfg, cfg, jp, p


def _x(cfg, T=19, seed=0):
    return 0.5 * np.random.default_rng(seed).standard_normal((2, T, cfg.d_model)).astype(
        np.float32)


def test_mamba_forward_and_decode_match_reference():
    """The forward's output and final state, and 19 chained decode steps
    from the empty state (each step's output and the final state), within
    2e-5 of the reference's at float32; the forward equals its own chained
    decode within 2e-5."""
    jcfg, cfg, jp, p = _block()
    x = _x(cfg)
    jy, jst = jssm.mamba_forward(jcfg, jp, jnp.asarray(x), return_state=True)
    y, st = ssm.mamba_forward(cfg, p, torch.from_numpy(x), return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), **TOL, err_msg=k)
    js = jssm.mamba_init_state(jcfg, 2)
    s = ssm.mamba_init_state(cfg, 2, torch.float32, "cpu")
    ys = []
    for t in range(x.shape[1]):
        jo, js = jssm.mamba_decode_step(jcfg, jp, jnp.asarray(x[:, t:t + 1]), js)
        o, s = ssm.mamba_decode_step(cfg, p, torch.from_numpy(x[:, t:t + 1]), s)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL, err_msg=f"step {t}")
        ys.append(o)
    for k in ("h", "conv"):
        np.testing.assert_allclose(s[k].numpy(), np.asarray(js[k]), **TOL, err_msg=k)
        np.testing.assert_allclose(s[k].numpy(), st[k].numpy(), **TOL, err_msg=k)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), y.numpy(), **TOL)


@pytest.mark.parametrize("T", [1, 2, 3, 5])
def test_mamba_short_prompt_state_matches_reference(T):
    """Prompts shorter than the conv's window (d_conv - 1 = 3 taps of
    history): the conv state is zero-padded on the left as the
    reference's."""
    jcfg, cfg, jp, p = _block()
    x = _x(cfg, T=T, seed=T)
    jy, jst = jssm.mamba_forward(jcfg, jp, jnp.asarray(x), return_state=True)
    y, st = ssm.mamba_forward(cfg, p, torch.from_numpy(x), return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for k in ("h", "conv"):
        assert st[k].shape == jst[k].shape
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), **TOL, err_msg=k)


def test_mamba_bf16_matches_reference_and_keeps_float32_leaves():
    """At bfloat16 the forward and 8 chained decode steps within 5e-2 of the
    reference's; ``A_log``, ``D`` and ``h`` stay float32, ``conv`` takes the
    state's dtype."""
    jcfg, cfg, jp, p = _block(jnp.bfloat16)
    assert p["A_log"].dtype == p["D"].dtype == torch.float32
    assert p["in_proj"].dtype == torch.bfloat16
    x = _x(cfg, T=8, seed=3)
    jy, jst = jssm.mamba_forward(jcfg, jp, jnp.asarray(x).astype(jnp.bfloat16),
                                 return_state=True)
    y, st = ssm.mamba_forward(cfg, p, torch.from_numpy(x).to(torch.bfloat16), return_state=True)
    assert y.dtype == torch.bfloat16 and st["h"].dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy.astype(jnp.float32)), **BF16)
    js = jssm.mamba_init_state(jcfg, 2, jnp.bfloat16)
    s = ssm.mamba_init_state(cfg, 2, torch.bfloat16, "cpu")
    for t in range(x.shape[1]):
        xt = x[:, t:t + 1]
        jo, js = jssm.mamba_decode_step(jcfg, jp, jnp.asarray(xt).astype(jnp.bfloat16), js)
        o, s = ssm.mamba_decode_step(cfg, p, torch.from_numpy(xt).to(torch.bfloat16), s)
        np.testing.assert_allclose(o.float().numpy(), np.asarray(jo.astype(jnp.float32)),
                                   **BF16)
    assert s["h"].dtype == torch.float32 and s["conv"].dtype == torch.bfloat16
    np.testing.assert_allclose(s["h"].numpy(), np.asarray(js["h"]), **BF16)


def test_params_keep_a_log_and_d_float32():
    """``init_params`` and ``params_from_jax(dtype=bfloat16)`` keep the Mamba
    layer's ``A_log`` and ``D`` (and the MoE router) float32."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    for params in (model.init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16),
                   model.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu",
                                         dtype=torch.bfloat16)):
        lp = params["layers"][0]
        assert cfg.layers[0][0] == MAMBA
        assert lp["mixer"]["A_log"].dtype == lp["mixer"]["D"].dtype == torch.float32
        assert lp["mixer"]["in_proj"].dtype == torch.bfloat16
        assert lp["ffn"]["router"].dtype == torch.float32
    p = model.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    np.testing.assert_array_equal(p["layers"][0]["mixer"]["A_log"].numpy(),
                                  np.asarray(jp["pattern"][0]["mixer"]["A_log"][0]))


def test_check_supported_and_retrievers_take_mamba():
    """A Mamba layer has no retriever and a ``{"h", "conv"}`` state; the
    stack cannot extend over cached K/V."""
    cfg = get_config(ARCH)
    model.check_supported(cfg)
    rs = model.retrievers(cfg, FreeKVConfig(**FKV))
    assert [r is None for r in rs] == [m == MAMBA for m, _ in cfg.layers]
    st = model.init_decode_state(cfg, FreeKVConfig(**FKV), 3, 64, torch.bfloat16, "cpu")
    assert set(st["layers"][0]) == {"h", "conv"}
    assert st["layers"][0]["h"].dtype == torch.float32
    assert st["layers"][0]["conv"].dtype == torch.bfloat16
    assert not model.supports_kv_extend(cfg) and not jmodel.supports_kv_extend(
        jget_config(ARCH))
    with pytest.raises(NotImplementedError, match="supports_kv_extend"):
        model.prefill_extend(cfg, FreeKVConfig(**FKV), None, {"tokens": None}, None, 8, 64)


# ---------------------------------------------------------------------------
# the slot pool and the engine
# ---------------------------------------------------------------------------
_ENGINE = {}
_JAX_RUNS = {}          # the JAX engine's plain continuous run, shared by two cases


def _models():
    if not _ENGINE:
        jcfg, cfg = jget_config(ARCH), get_config(ARCH)
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        p = model.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
        jeng = JServeEngine(jcfg, JFreeKVConfig(**FKV), jp, max_len=MAX_LEN, batch_size=SLOTS)
        _ENGINE.update(jcfg=jcfg, cfg=cfg, jp=jp, p=p, jeng=jeng)
    return _ENGINE


def _prompts(cfg, n, seed=0, lens=(40, 56)):
    return [np.random.default_rng(seed + i).integers(0, cfg.vocab_size, lens[i % len(lens)])
            .astype(np.int32) for i in range(n)]


def test_slot_pool_carries_mamba_state_bit_for_bit():
    """A prefilled request's Mamba state written into a slot, stepped, swapped
    out and into another slot: ``h`` float32 and every leaf bit for bit; a
    freed slot's Mamba leaves reset to zeros at the next flush."""
    m = _models()
    cfg, p = m["cfg"], m["p"]
    eng = ServeEngine(cfg, FreeKVConfig(**FKV), p, max_len=MAX_LEN, batch_size=3, device="cpu")
    pool = SlotPool(cfg, eng.fkv, 3, MAX_LEN, torch.float32, "cpu")
    req = Request(uid=0, tokens=_prompts(cfg, 1)[0], max_new_tokens=4)
    slot = pool.alloc(0)
    _, st, _, _ = eng.prefill_one(req, pool, slot)
    pool.insert(st, slot)
    row = pool.extract(slot)
    assert torch.equal(row["layers"][0]["h"], st["layers"][0]["h"])
    assert row["layers"][0]["h"].dtype == torch.float32
    model.serve_step(cfg, eng.fkv, p, pool.state, torch.zeros((3, 1), dtype=torch.long))
    before = pool.extract(slot)
    host = pool.swap_out(slot)
    assert host["layers"][0]["h"].dtype == torch.float32
    pool.free(slot)
    other = pool.alloc(1)
    pool.swap_in(host, other)
    after = pool.extract(other)
    for k in ("h", "conv"):
        assert torch.equal(after["layers"][0][k], before["layers"][0][k]), k
    pool.free(other)
    pool.flush_resets()
    assert not pool.state["layers"][0]["h"][other].any()
    assert not pool.state["layers"][0]["conv"][other].any()
    state = swap_state_to_host(pool.extract(1 - other if other else 2))
    assert state["layers"][0]["h"].dtype == torch.float32


@contextlib.contextmanager
def _routing_drops():
    """Assignments the MoE layer drops, in decode steps (T = 1) and prefill
    calls, counted on each ``apply_moe`` call's own routing."""
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


def _requests(cls, prompts, prio=None, news=(10, 4, 14, 6, 9, 5, 12, 7, 11, 3)):
    return [cls(uid=i, tokens=t, max_new_tokens=news[i % len(news)],
                priority=int(prio is not None and i == prio)) for i, t in enumerate(prompts)]


def _jax_run(reqs, preempt=False, bucket=1, scheduler="continuous"):
    jeng = _models()["jeng"]
    jeng.fkv = dataclasses.replace(jeng.fkv, preempt=preempt)
    jeng.prefill_bucket, jeng.scheduler = bucket, scheduler
    return jeng.generate(reqs), jeng.last_metrics


@pytest.mark.parametrize("case", ["continuous", "preempt", "static", "bucket",
                                  "chunk and cache set"])
def test_jamba_engine_matches_reference(case):
    """10 requests of mixed lengths over 6 slots (idle lanes, turnover, a
    decode capacity that binds): tokens, steps, block counts (and
    preemptions, swap bytes) exactly the JAX engine's; drops in a prefill
    and a decode step. ``chunk and cache set``: ``prefill_chunk_tokens`` 24
    and ``prefix_cache_tokens`` 4096 on the port, which turns both off as
    the reference does, against the reference's plain run."""
    m = _models()
    cfg, p = m["cfg"], m["p"]
    prompts, prio, fkv_kw, eng_kw = _prompts(cfg, 10), None, {}, {}
    jkw = {}
    if case == "preempt":
        fkv_kw, prio, jkw = dict(preempt=True), 9, dict(preempt=True)
    elif case == "static":
        eng_kw = jkw = dict(scheduler="static")
    elif case == "bucket":
        prompts = [t[: len(t) - 3 - i % 3] for i, t in enumerate(prompts)]
        eng_kw, jkw = dict(prefill_bucket=8), dict(bucket=8)
    elif case == "chunk and cache set":
        fkv_kw, eng_kw = dict(prefill_chunk_tokens=24), dict(prefix_cache_tokens=4096)
    if case in ("continuous", "chunk and cache set"):      # the same reference run
        if "plain" not in _JAX_RUNS:
            _JAX_RUNS["plain"] = _jax_run(_requests(JRequest, prompts))
        jouts, jem = _JAX_RUNS["plain"]
    else:
        jouts, jem = _jax_run(_requests(JRequest, prompts, prio), **jkw)
    eng = ServeEngine(cfg, FreeKVConfig(**FKV, **fkv_kw), p, max_len=MAX_LEN, batch_size=SLOTS,
                      device="cpu", **eng_kw)
    with _routing_drops() as drops:
        outs = eng.generate(_requests(Request, prompts, prio))
    em = eng.last_metrics
    assert [o.tokens for o in outs] == [o.tokens for o in jouts]
    assert [o.steps for o in outs] == [o.steps for o in jouts]
    if jem.scheduler == "continuous":
        assert em.steps == jem.steps
    for o, jo in zip(outs, jouts):
        for key in ("corrected", "sync_pages", "async_pages"):
            assert o.stats[key] == jo.stats[key], (o.uid, key)
    assert (em.preemptions, em.swap_out_bytes, em.swap_in_bytes, em.prefill_chunks) == \
        (jem.preemptions, jem.swap_out_bytes, jem.swap_in_bytes, jem.prefill_chunks)
    assert drops["prefill"] > 0 and drops["decode"] > 0, drops
    if case == "preempt":
        assert em.preemptions >= 1 and em.swap_in_bytes == em.swap_out_bytes > 0
    if case == "chunk and cache set":
        assert eng.prefill_chunk_tokens == 0 and eng.prefix_cache is None
        assert em.prefill_chunks == 0 and all(r.prefix_hit_tokens == 0 for r in em.requests)


def test_jamba_spec_decode_falls_back_to_draft_len_0():
    """``draft_len=4`` on jamba serves ``draft_len=0``: the same tokens."""
    m = _models()
    cfg, p = m["cfg"], m["p"]
    prompts = _prompts(cfg, 2, seed=20)
    toks = {}
    for draft in (0, 4):
        eng = ServeEngine(cfg, FreeKVConfig(**FKV, draft_len=draft), p, max_len=MAX_LEN,
                          batch_size=SLOTS, device="cpu")
        assert not eng.spec_decode
        toks[draft] = [o.tokens for o in eng.generate(_requests(Request, prompts))]
    assert toks[4] == toks[0]
    assert not jmodel.supports_spec_decode(m["jcfg"], JFreeKVConfig(**FKV, draft_len=4))
