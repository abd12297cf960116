"""The encoder-decoder whisper-tiny and the frontend arch internvl2-26b,
held against the JAX package on the CPU with the reference's weights
(``params_from_jax``) and numpy-seeded frontend embeddings (0.1 N(0, 1)),
each at its smoke width (4/2 heads, 2 encoder layers, 16 frontend tokens)
and at a narrow config with its real head layout (whisper 6/6 at d_head 64,
internvl2 48/8 at d_head 128):

* the prefill's logits within 2e-5 and every state leaf of every layer,
  the cross-attention ``xk``/``xv`` (whisper) included, integers exactly;
  the length counting internvl2's 16 patches ahead of the prompt;
* four decode steps after it: each step's logits within 2e-5 and the
  state leaves after them. These two hold internvl2 against the reference
  evaluated op by op (``jax.disable_jit``): jitted, XLA fuses RoPE's cos
  and sin into the products around them and its result moves by up to
  2.6e-5 (internvl2's layer-0 keys at position 69, rope_theta 1e6, against
  the same reference code run op by op, which is within 1.5e-6 of the
  port). whisper's (rope_theta 1e4) hold against the reference jitted;
* the engine against the JAX engine, 5 requests over 2 slots, four with
  seeded frontends and one without (zeros): the continuous scheduler
  with slots turning over, the static left-padded batch (the patches
  ahead of the padding), a preemption and ``prefill_bucket`` 8. Tokens,
  steps and each request's corrected heads and blocking pages exactly
  equal (whisper-smoke's greedy tokens repeat under seeded weights, so
  the logits and states above carry most of the check);
* ``prefill_chunk_tokens`` and ``prefix_cache_tokens`` forced off and
  ``draft_len`` 4 falling back to 0, as in the reference;
* the slot pool carrying whisper's ``xk``/``xv`` beside the retriever's
  leaves: an admitted row, stepped, swapped out and into another slot is
  bit for bit the row it was, and a freed row resets to the empty one.

The JAX engine of a config is built once and shared by its cases."""
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
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import FreeKVConfig
from repro_torch.models import model
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.kv_slots import SlotPool

torch.set_float32_matmul_precision("highest")
TOL = dict(atol=2e-5, rtol=2e-5)
FKV = dict(page_size=8, budget=64, n_sink=8, n_window=8, tau=0.8)
MAX_LEN, SLOTS, LEN = 192, 2, 72
ARCHS = ("whisper-tiny", "internvl2-26b")
REAL = {"whisper-tiny": (6, 6, 64), "internvl2-26b": (48, 8, 128)}
NEWS = (9, 4, 12, 6, 8)


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


def _cfg(get, arch, real):
    cfg = get(arch + "-smoke")
    if real:
        H, kv, d = REAL[arch]
        cfg = dataclasses.replace(cfg, n_heads=H, n_kv_heads=kv, d_head=d)
    return cfg


def _frontends(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal((cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
            for _ in range(n)]


def _prompts(cfg, n, seed=0, length=LEN):
    return [np.random.default_rng(seed + i).integers(0, cfg.vocab_size, length).astype(np.int32)
            for i in range(n)]


def _ref_layers(jcfg, jstate):
    layers = list(jstate["prelude"])
    for i in range(jcfg.n_periods):
        for stacked in jstate["pattern"]:
            layers.append(jax.tree.map(lambda a: a[i], stacked))
    return layers


def _states_equal(jcfg, jst, st):
    jlayers = _ref_layers(jcfg, jst)
    assert len(jlayers) == len(st["layers"])
    for i, (jlayer, layer) in enumerate(zip(jlayers, st["layers"])):
        assert set(jlayer) == set(layer), i
        for k, a in jlayer.items():
            a, b = np.asarray(a), layer[k].numpy()
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, **TOL, err_msg=f"layer {i} {k}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"layer {i} {k}")
    np.testing.assert_array_equal(st["pos"].numpy(), np.asarray(jst["pos"]))


_MODELS = {}


def _models(arch, real):
    key = (arch, real)
    if key not in _MODELS:
        jcfg, cfg = _cfg(jget_config, arch, real), _cfg(get_config, arch, real)
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        p = model.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
        jeng = JServeEngine(jcfg, JFreeKVConfig(**FKV), jp, max_len=MAX_LEN, batch_size=SLOTS)
        _MODELS[key] = dict(jcfg=jcfg, cfg=cfg, jp=jp, p=p, jeng=jeng)
    return _MODELS[key]


CASES = [pytest.param(a, r, id=f"{a}-{'real-heads' if r else 'smoke'}")
         for a in ARCHS for r in (False, True)]


@pytest.mark.parametrize("arch,real", CASES)
def test_prefill_and_decode_match_reference(arch, real):
    """A batch of two prompts with seeded frontends: the prefill's logits
    and state (``xk``/``xv`` included), then four greedy decode steps'
    logits and the state after them, against the reference's."""
    m = _models(arch, real)
    jcfg, cfg, jp, p = m["jcfg"], m["cfg"], m["jp"], m["p"]
    fkv, jfkv = FreeKVConfig(**FKV), JFreeKVConfig(**FKV)
    toks = np.stack(_prompts(cfg, 2, seed=3))
    fe = np.stack(_frontends(cfg, 2, seed=4))
    op_by_op = jax.disable_jit if arch == "internvl2-26b" else contextlib.nullcontext
    with op_by_op():
        jl, jst = jmodel.prefill(jcfg, jfkv, jp, {"tokens": jnp.asarray(toks),
                                                  "frontend": jnp.asarray(fe)},
                                 MAX_LEN, state_dtype=jnp.float32)
    logits, st = model.prefill(cfg, fkv, p, {"tokens": torch.from_numpy(toks).long(),
                                             "frontend": torch.from_numpy(fe)},
                               MAX_LEN, state_dtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _states_equal(jcfg, jst, st)
    prefix = cfg.n_frontend_tokens if arch == "internvl2-26b" else 0
    assert int(st["pos"][0]) == prefix + LEN
    if cfg.is_encoder_decoder:
        assert st["layers"][0]["xk"].shape == (2, cfg.n_frontend_tokens, cfg.n_kv_heads,
                                               cfg.d_head)
    for t in range(4):
        tok = np.asarray(jnp.argmax(jl, -1)[:, None])
        with op_by_op():
            jl, jst = jmodel.serve_step(jcfg, jfkv, jp, jst, jnp.asarray(tok))
        logits, st = model.serve_step(cfg, fkv, p, st, torch.from_numpy(tok.copy()).long())
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL, err_msg=f"step {t}")
    _states_equal(jcfg, jst, st)


def _requests(cls, cfg, prio=None, seed=0, bucket=False):
    prompts = _prompts(cfg, len(NEWS), seed=seed)
    if bucket:
        prompts = [t[: len(t) - 3 - i % 3] for i, t in enumerate(prompts)]
    fes = _frontends(cfg, len(NEWS), seed=seed + 50)
    fes[2] = None                               # served zeros, as the reference
    return [cls(uid=i, tokens=t, max_new_tokens=n, frontend=f,
                priority=int(prio is not None and i == prio))
            for i, (t, n, f) in enumerate(zip(prompts, NEWS, fes))]


@pytest.mark.parametrize("case", ["continuous", "static", "preempt", "bucket"])
@pytest.mark.parametrize("arch,real", CASES)
def test_engine_matches_reference(arch, real, case):
    """5 requests over 2 slots through both engines: tokens, steps, block
    counts, preemptions and swap bytes exactly equal."""
    m = _models(arch, real)
    cfg, p, jeng = m["cfg"], m["p"], m["jeng"]
    prio = 4 if case == "preempt" else None
    bucket = 8 if case == "bucket" else 1
    jeng.fkv = dataclasses.replace(jeng.fkv, preempt=case == "preempt")
    jeng.prefill_bucket = bucket
    jeng.scheduler = "static" if case == "static" else "continuous"
    jouts = jeng.generate(_requests(JRequest, cfg, prio, bucket=bucket > 1))
    jem = jeng.last_metrics
    eng = ServeEngine(cfg, FreeKVConfig(**FKV, preempt=case == "preempt"), p, max_len=MAX_LEN,
                      batch_size=SLOTS, scheduler=jeng.scheduler, prefill_bucket=bucket,
                      device="cpu")
    outs = eng.generate(_requests(Request, cfg, prio, bucket=bucket > 1))
    em = eng.last_metrics
    assert [o.tokens for o in outs] == [o.tokens for o in jouts]
    assert [len(o.tokens) for o in outs] == list(NEWS)
    if case != "static":
        assert em.steps == jem.steps
    for o, jo in zip(outs, jouts):
        for key in ("corrected", "sync_pages", "async_pages"):
            assert o.stats[key] == jo.stats[key], (o.uid, key)
    assert (em.preemptions, em.swap_out_bytes, em.swap_in_bytes) == \
        (jem.preemptions, jem.swap_out_bytes, jem.swap_in_bytes)
    if case == "preempt":
        assert em.preemptions >= 1 and em.swap_in_bytes == em.swap_out_bytes > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_cache_and_spec_turn_off(arch):
    """``prefill_chunk_tokens`` 24, ``prefix_cache_tokens`` 4096 and
    ``draft_len`` 4 set: the port serves whole-shot prefill, no cache and
    ``draft_len`` 0, as the reference (``supports_kv_extend``,
    ``supports_spec_decode``), with the plain run's tokens."""
    m = _models(arch, False)
    cfg, p = m["cfg"], m["p"]
    assert not model.supports_kv_extend(cfg) and not jmodel.supports_kv_extend(m["jcfg"])
    reqs = _requests(Request, cfg, seed=7)
    plain = ServeEngine(cfg, FreeKVConfig(**FKV), p, max_len=MAX_LEN, batch_size=SLOTS,
                        device="cpu").generate(reqs)
    eng = ServeEngine(cfg, FreeKVConfig(**FKV, prefill_chunk_tokens=24, draft_len=4), p,
                      max_len=MAX_LEN, batch_size=SLOTS, prefix_cache_tokens=4096,
                      device="cpu")
    assert eng.prefill_chunk_tokens == 0 and eng.prefix_cache is None
    assert not eng.spec_decode and eng.fkv.draft_len == 0
    outs = eng.generate(reqs)
    assert [o.tokens for o in outs] == [o.tokens for o in plain]
    em = eng.last_metrics
    assert em.prefill_chunks == 0 and all(r.prefix_hit_tokens == 0 for r in em.requests)
    assert not jmodel.supports_spec_decode(m["jcfg"], JFreeKVConfig(**FKV, draft_len=4))


def test_slot_pool_carries_cross_state_bit_for_bit():
    """whisper-smoke: a request prefilled straight into a slot (its
    ``xk``/``xv`` written into the slot's rows), stepped, swapped out and
    into another slot: every leaf of the row bit for bit; the freed slot's
    leaves (the pool pages aside) reset to the empty state's."""
    m = _models("whisper-tiny", False)
    cfg, p = m["cfg"], m["p"]
    fkv = FreeKVConfig(**FKV)
    eng = ServeEngine(cfg, fkv, p, max_len=MAX_LEN, batch_size=3, device="cpu")
    pool = SlotPool(cfg, fkv, 3, MAX_LEN, torch.float32, "cpu")
    slot = pool.alloc(0)
    req = Request(uid=0, tokens=_prompts(cfg, 1)[0], max_new_tokens=4,
                  frontend=_frontends(cfg, 1, seed=9)[0])
    _, st, _, _ = eng.prefill_one(req, pool, slot)
    pool.insert(st, slot)
    assert bool(pool.state["layers"][0]["xk"][slot].abs().sum() > 0)
    model.serve_step(cfg, fkv, p, pool.state, torch.zeros((3, 1), dtype=torch.long))
    before = pool.extract(slot)
    host = pool.swap_out(slot)
    pool.free(slot)
    other = pool.alloc(1)
    pool.swap_in(host, other)
    after = pool.extract(other)
    for i, layer in enumerate(before["layers"]):
        assert {"xk", "xv"} <= set(layer)
        for k, t in layer.items():
            assert torch.equal(after["layers"][i][k], t), (i, k)
    pool.free(other)
    pool.flush_resets()
    empty = model.init_decode_state(cfg, fkv, 1, MAX_LEN, torch.float32, "cpu")
    for i, layer in enumerate(empty["layers"]):
        for k, t in layer.items():
            if k not in ("pool", "pool_scale"):
                assert torch.equal(pool.state["layers"][i][k][other:other + 1], t), (i, k)
