"""The port's xLSTM mixers (``repro_torch/models/xlstm.py``) and xlstm-350m
through the serving engine, held against the JAX package on the CPU with
the reference's weights (``params_from_jax``) and numpy-seeded inputs:

* the modules on xlstm-350m-smoke (d 256, 4 heads, d_inner 512, dqk 64 and
  dv 128 a head): ``mlstm_forward`` (chunks of 256 and of 8, T a multiple
  of neither) and ``slstm_forward`` (T short of its 256-step scan chunk,
  whose zero-padded tail the reference's returned state includes): outputs
  and final states within 2e-5 of the reference's at float32; chained
  ``*_decode_step``s against the reference's steps and against the port's
  own forward; at bfloat16 within 5e-2, the gates' weights and the states
  float32;
* the slot pool carrying the xLSTM leaves (mLSTM ``m`` = -1e30, sLSTM
  ``n`` = 1 in an empty row): claim, reset and the preemption swap bit
  for bit;
* the engine against the JAX engine (xlstm-350m-smoke: an mLSTM and an
  sLSTM block; 6 slots): the continuous scheduler with idle lanes and
  turnover, a preemption, the static left-padded batch and
  ``prefill_bucket`` 8. Tokens, steps, preemptions and swap bytes exactly
  equal. With ``prefill_chunk_tokens`` and ``prefix_cache_tokens`` set the
  port turns both off as the reference does (``supports_kv_extend``);
  ``draft_len=4`` falls back to ``draft_len=0``'s."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import FreeKVConfig as JFreeKVConfig
from repro.models import model as jmodel
from repro.models import xlstm as jxlstm
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import MLSTM, SLSTM, FreeKVConfig
from repro_torch.models import model, xlstm
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.kv_slots import SlotPool

torch.set_float32_matmul_precision("highest")
TOL = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=5e-2, rtol=5e-2)
FKV = dict(page_size=8, budget=64, n_sink=8, n_window=8, tau=0.8)
ARCH = "xlstm-350m-smoke"
MAX_LEN, SLOTS = 192, 6
F32_LEAVES = {"mlstm": ("wi", "wf", "bf"), "slstm": ("W", "R", "b")}


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


def _block(kind, dtype=None):
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    jp = getattr(jxlstm, kind + "_init")(jax.random.PRNGKey(1), jcfg)
    if dtype is not None:
        jp = {k: v if k in F32_LEAVES[kind] else v.astype(dtype) for k, v in jp.items()}
    p = {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(
        torch.float32 if v.dtype == jnp.float32 else torch.bfloat16) for k, v in jp.items()}
    return jcfg, cfg, jp, p


def _x(cfg, T, seed=0):
    return 0.5 * np.random.default_rng(seed).standard_normal((2, T, cfg.d_model)).astype(
        np.float32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol,
                               err_msg=what)


@pytest.mark.parametrize("T,chunk", [(19, 256), (19, 8), (300, 256)])
def test_mlstm_forward_matches_reference(T, chunk):
    """The chunkwise-state stabilized form, padded with log_i = -1e30 where
    T is no multiple of the chunk: output and (C, n, m) within 2e-5."""
    jcfg, cfg, jp, p = _block("mlstm")
    x = _x(cfg, T, seed=T)
    jy, jst = jxlstm.mlstm_forward(jcfg, jp, jnp.asarray(x), return_state=True, chunk=chunk)
    y, st = xlstm.mlstm_forward(cfg, p, torch.from_numpy(x), return_state=True, chunk=chunk)
    _close(y, jy, TOL, "y")
    assert set(st) == set(jst) == {"C", "n", "m"}
    for k in st:
        assert st[k].dtype == torch.float32
        _close(st[k], jst[k], TOL, k)


@pytest.mark.parametrize("T", [19, 256])
def test_slstm_forward_matches_reference(T):
    """The sLSTM scan: output and (h, c, n, m) within 2e-5, the state after
    the reference's zero-padded tail where T is short of 256."""
    jcfg, cfg, jp, p = _block("slstm")
    x = _x(cfg, T, seed=T)
    jy, jst = jxlstm.slstm_forward(jcfg, jp, jnp.asarray(x), return_state=True)
    y, st = xlstm.slstm_forward(cfg, p, torch.from_numpy(x), return_state=True)
    _close(y, jy, TOL, "y")
    assert set(st) == set(jst) == {"h", "c", "n", "m"}
    for k in st:
        _close(st[k], jst[k], TOL, k)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_steps_match_reference_and_forward(kind):
    """256 chained decode steps from the empty state: each step's output
    and the final state within 2e-5 of the reference's chained steps, and
    of the port's own forward over the 256 tokens (a whole scan chunk)."""
    jcfg, cfg, jp, p = _block(kind)
    T = 256
    x = _x(cfg, T, seed=4)
    js = getattr(jxlstm, kind + "_init_state")(jcfg, 2)
    s = getattr(xlstm, kind + "_init_state")(cfg, 2, "cpu")
    jstep = jax.jit(lambda p_, x_, s_: getattr(jxlstm, kind + "_decode_step")(jcfg, p_, x_, s_))
    ys = []
    for t in range(T):
        jo, js = jstep(jp, jnp.asarray(x[:, t:t + 1]), js)
        o, s = getattr(xlstm, kind + "_decode_step")(cfg, p, torch.from_numpy(x[:, t:t + 1]), s)
        if t % 32 == 0 or t == T - 1:
            _close(o, jo, TOL, f"step {t}")
        ys.append(o)
    y, st = getattr(xlstm, kind + "_forward")(cfg, p, torch.from_numpy(x), return_state=True)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), y.numpy(), **TOL)
    for k in st:
        _close(s[k], js[k], TOL, k)
        _close(s[k], st[k].numpy(), TOL, k)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_bf16_matches_reference_and_keeps_float32_leaves(kind):
    """bf16 weights: the forward and 8 chained decode steps within 5e-2 of
    the reference's; the gates' weights and every state leaf float32."""
    jcfg, cfg, jp, p = _block(kind, jnp.bfloat16)
    assert all(p[k].dtype == torch.float32 for k in F32_LEAVES[kind])
    assert p["up"].dtype == p["down"].dtype == torch.bfloat16
    x = _x(cfg, 8, seed=3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jy, jst = getattr(jxlstm, kind + "_forward")(jcfg, jp, jnp.asarray(x).astype(jnp.bfloat16),
                                                 return_state=True)
    y, st = getattr(xlstm, kind + "_forward")(cfg, p, xb, return_state=True)
    assert y.dtype == torch.bfloat16
    _close(y, jy.astype(jnp.float32), BF16, "y")
    js = getattr(jxlstm, kind + "_init_state")(jcfg, 2, jnp.bfloat16)
    s = getattr(xlstm, kind + "_init_state")(cfg, 2, "cpu")
    for t in range(x.shape[1]):
        jo, js = getattr(jxlstm, kind + "_decode_step")(
            jcfg, jp, jnp.asarray(x[:, t:t + 1]).astype(jnp.bfloat16), js)
        o, s = getattr(xlstm, kind + "_decode_step")(cfg, p, xb[:, t:t + 1], s)
        _close(o, jo.astype(jnp.float32), BF16, f"step {t}")
    assert all(t.dtype == torch.float32 for t in list(s.values()) + list(st.values()))


def test_params_keep_gates_float32():
    """``init_params`` and ``params_from_jax(dtype=bfloat16)`` keep the
    mLSTM's ``wi``/``wf``/``bf`` and the sLSTM's ``W``/``R``/``b`` float32,
    and the LayerNorms' ``b`` at bfloat16; an xLSTM block has no FFN."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert [m for m, _ in cfg.layers] == [MLSTM, SLSTM]
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    for params in (model.init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16),
                   model.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu",
                                         dtype=torch.bfloat16)):
        for lp, kind in zip(params["layers"], ("mlstm", "slstm")):
            assert set(lp) == {"norm1", "mixer"}
            assert lp["norm1"]["b"].dtype == torch.bfloat16
            for k, t in lp["mixer"].items():
                want = torch.float32 if k in F32_LEAVES[kind] else torch.bfloat16
                assert t.dtype == want, (kind, k)
    p = model.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    np.testing.assert_array_equal(p["layers"][1]["mixer"]["R"].numpy(),
                                  np.asarray(jp["pattern"][1]["mixer"]["R"][0]))


def test_retrievers_and_decode_state():
    """An xLSTM layer has no retriever and a float32 state whatever the
    state dtype; the stack extends over no cached K/V and speculates not."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    model.check_supported(cfg)
    fkv = FreeKVConfig(**FKV)
    assert model.retrievers(cfg, fkv) == [None, None]
    st = model.init_decode_state(cfg, fkv, 3, 64, torch.bfloat16, "cpu")
    assert set(st["layers"][0]) == {"C", "n", "m"} and set(st["layers"][1]) == {"h", "c", "n",
                                                                                   "m"}
    assert all(t.dtype == torch.float32 for layer in st["layers"] for t in layer.values())
    assert bool((st["layers"][0]["m"] == -1e30).all()) and bool((st["layers"][1]["n"] == 1).all())
    assert not model.supports_kv_extend(cfg) and not jmodel.supports_kv_extend(jcfg)
    assert not model.supports_spec_decode(cfg, FreeKVConfig(**FKV, draft_len=4))


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


def test_slot_pool_carries_xlstm_state_bit_for_bit():
    """A prefilled request's xLSTM state written into a slot, stepped,
    swapped out and into another slot: every leaf float32 and bit for bit;
    a freed slot's leaves reset to the empty state's constants (mLSTM ``m``
    -1e30, sLSTM ``n`` 1, zeros elsewhere) at the next flush, and a claimed
    row equals an empty one."""
    m = _models()
    cfg, p = m["cfg"], m["p"]
    eng = ServeEngine(cfg, FreeKVConfig(**FKV), p, max_len=MAX_LEN, batch_size=3, device="cpu")
    pool = SlotPool(cfg, eng.fkv, 3, MAX_LEN, torch.float32, "cpu")
    empty = model.init_decode_state(cfg, eng.fkv, 1, MAX_LEN, torch.float32, "cpu")
    slot = pool.alloc(0)
    _, st, _, _ = eng.prefill_one(Request(uid=0, tokens=_prompts(cfg, 1)[0], max_new_tokens=4),
                                  pool, slot)
    pool.insert(st, slot)
    row = pool.extract(slot)
    for i, layer in enumerate(st["layers"]):
        for k, t in layer.items():
            assert torch.equal(row["layers"][i][k], t), (i, k)
    model.serve_step(cfg, eng.fkv, p, pool.state, torch.zeros((3, 1), dtype=torch.long))
    before = pool.extract(slot)
    host = pool.swap_out(slot)
    pool.free(slot)
    other = pool.alloc(1)
    pool.swap_in(host, other)
    after = pool.extract(other)
    for i, layer in enumerate(before["layers"]):
        for k, t in layer.items():
            assert t.dtype == torch.float32
            assert torch.equal(after["layers"][i][k], t), (i, k)
    pool.free(other)
    pool.flush_resets()
    for i, layer in enumerate(empty["layers"]):
        for k, t in layer.items():
            assert torch.equal(pool.state["layers"][i][k][other:other + 1], t), (i, k)
    views = pool.claim(pool.alloc(2))
    for i, layer in enumerate(empty["layers"]):
        for k, t in layer.items():
            assert torch.equal(views[i][k], t), (i, k)


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
def test_xlstm_engine_matches_reference(case):
    """10 requests of mixed lengths over 6 slots (idle lanes, turnover):
    tokens, steps, preemptions and swap bytes exactly the JAX engine's.
    ``chunk and cache set``: ``prefill_chunk_tokens`` 24 and
    ``prefix_cache_tokens`` 4096 on the port, which turns both off as the
    reference does, against the reference's plain run."""
    m = _models()
    cfg, p = m["cfg"], m["p"]
    prompts, prio, fkv_kw, eng_kw, jkw = _prompts(cfg, 10), None, {}, {}, {}
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
    outs = eng.generate(_requests(Request, prompts, prio))
    em = eng.last_metrics
    assert [o.tokens for o in outs] == [o.tokens for o in jouts]
    assert [o.steps for o in outs] == [o.steps for o in jouts]
    if jem.scheduler == "continuous":
        assert em.steps == jem.steps
    assert (em.preemptions, em.swap_out_bytes, em.swap_in_bytes, em.prefill_chunks) == \
        (jem.preemptions, jem.swap_out_bytes, jem.swap_in_bytes, jem.prefill_chunks)
    if case == "preempt":
        assert em.preemptions >= 1 and em.swap_in_bytes == em.swap_out_bytes > 0
    if case == "chunk and cache set":
        assert eng.prefill_chunk_tokens == 0 and eng.prefix_cache is None
        assert em.prefill_chunks == 0 and all(r.prefix_hit_tokens == 0 for r in em.requests)


def test_xlstm_spec_decode_falls_back_to_draft_len_0():
    """``draft_len=4`` on xlstm serves ``draft_len=0``: the same tokens."""
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
