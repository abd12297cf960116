"""KV-head-group tensor-parallel serving in the port (``ServeEngine(tp=2)``,
``core/sharded_retrieval``), held against the reference on the CPU with two
shards on ``("cpu", "cpu")`` (``launch/mesh.make_tp_mesh``).

* the wrapper at tp=1 is the plain port retriever bit for bit;
* the wrapper at tp=2 against the reference's plain retriever (which the
  reference's own tests hold equal to its tp=2 wrapper) on the same numpy
  inputs, a prefill and 10 decode steps crossing a page completion: the
  output within 2e-5, the selected ids, the counters and every integer leaf
  of the joined state exact, the pool's payload exact, other float leaves
  (the quant scales among them; ShadowKV's key factors as their product)
  within 2e-5; each shard's own transfer counts exactly those of the
  reference's plain retriever run on that shard's heads alone; every method
  and gemma2's sliding-window layers;
* ``sharding/rules.tp_state_axis`` against the reference's
  ``tp_state_specs`` for every leaf of every method's state;
* the engine's refusals (the reference's ``test_engine_rejects_bad_tp``);
* ``ServeEngine(tp=2)`` against the JAX engine at tp=1 on mixed-length
  continuous traffic (recall overlap on and off, kv_quant none and int8),
  the static scheduler, a prefix-cache hit, a preemption and ``draft_len``
  4: greedy tokens exactly equal, and so the exposed and hidden bytes; the
  measured per-shard bytes add up to them; one scenario also against a JAX
  ``tp=2`` run in one subprocess with two forced host devices (the script
  at the bottom of this file): the reference's keys of ``summary()["tp"]``
  and the flight tracker's per-shard view equal.

granite-3-8b-smoke (1 layer, 4/2 heads, so one KV head a shard) with the
reference's weights; ~40 s serial, the subprocess ~7 s of it.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import FreeKVConfig as JFreeKVConfig
from repro.core import retrieval as jretrieval
from repro.models import model as jmodel
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.prefix_cache import RadixPrefixCache as JRadixPrefixCache
from repro_torch.configs import get_config
from repro_torch.configs.base import FreeKVConfig
from repro_torch.core.retrieval import METHODS, StreamingRetriever, make_retriever
from repro_torch.core.sharded_retrieval import TPGroupShardedRetriever, tp_serving_active
from repro_torch.launch.mesh import make_tp_mesh
from repro_torch.models import model
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.sharding.rules import join_state, tp_state_axis

torch.set_float32_matmul_precision("highest")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "granite-3-8b-smoke"
FKV = dict(method="freekv", page_size=8, budget=48, n_sink=8, n_window=8, tau=0.8)
TOL = dict(atol=2e-5, rtol=2e-5)
MAX_LEN, SLOTS, BUCKET = 160, 3, 24


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test, as the other engine tests pin it: the
    port's smoke-width steps are many small ops. It does not change what a
    test checks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(tp):
    return make_tp_mesh(tp, ("cpu",) * tp)


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_tp_wrapper_mp1_bit_identical(kv_quant):
    """One shard is the plain retriever: outputs, selected ids, counters and
    the pool equal bit for bit over 10 steps crossing a page completion."""
    cfg = get_config(ARCH)
    fkv = FreeKVConfig(**FKV, kv_quant=kv_quant)
    r_tp = make_retriever(cfg, fkv, mesh=_mesh(1))
    assert isinstance(r_tp, TPGroupShardedRetriever)
    r_pl = make_retriever(cfg, fkv)
    rng = np.random.default_rng(0)
    B, T, H, kv, d = 2, 64, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    ks, vs = (_t(rng.standard_normal((B, T, kv, d)).astype(np.float32)) for _ in range(2))
    q0 = _t(rng.standard_normal((B, H, d)).astype(np.float32))
    st_tp = r_tp.prefill(r_tp.init_state(B, T + 32, torch.float32, "cpu"), ks, vs, q0)
    st_pl = r_pl.prefill(r_pl.init_state(B, T + 32, torch.float32, "cpu"), ks, vs, q0)
    for _ in range(10):
        q = _t(rng.standard_normal((B, H, d)).astype(np.float32))
        kn, vn = (_t(rng.standard_normal((B, kv, d)).astype(np.float32)) for _ in range(2))
        o_tp, st_tp, i_tp = r_tp.decode(st_tp, q, kn, vn)
        o_pl, st_pl, i_pl = r_pl.decode(st_pl, q, kn, vn)
        assert torch.equal(o_tp, o_pl)
        assert torch.equal(st_tp["0/sel_idx"], st_pl["sel_idx"])
        for key in ("sync_pages", "async_pages", "reused_pages", "corrected"):
            assert torch.equal(i_tp[key], i_pl[key]), key
    assert torch.equal(st_tp["0/pool"], st_pl["pool"])
    assert int(st_pl["length"][0]) == T + 10


# name -> (arch, method, kv_quant); "local" is gemma2's ATTN_LOCAL retriever
RETRIEVER_CASES = {
    "freekv/none": (ARCH, "freekv", "none"), "freekv/int8": (ARCH, "freekv", "int8"),
    "shadowkv": (ARCH, "shadowkv", "none"), "centroid": (ARCH, "centroid", "none"),
    "arkvale": (ARCH, "arkvale", "none"), "infinigen": (ARCH, "infinigen", "none"),
    "quest": (ARCH, "quest", "none"), "raas": (ARCH, "raas", "none"),
    "streaming": (ARCH, "streaming", "none"), "full": (ARCH, "full", "none"),
    "gemma2 local": ("gemma2-2b-smoke", "local", "none"),
}


def _pair(case):
    """(jcfg, cfg, the reference's plain retriever, the same on one shard's
    heads, the port's tp=2 wrapper)."""
    arch, method, quant = RETRIEVER_CASES[case]
    kw = dict(FKV, method="freekv" if method == "local" else method, kv_quant=quant,
              centroid_count=4, centroid_refresh_interval=3)
    jcfg, cfg = jget_config(arch), get_config(arch)
    jfkv, fkv = JFreeKVConfig(**kw), FreeKVConfig(**kw)
    jlocal = dataclasses.replace(jcfg, n_heads=jcfg.n_heads // 2,
                                 n_kv_heads=jcfg.n_kv_heads // 2)
    if method == "local":
        jr, jr1 = (jretrieval.StreamingRetriever(c, jfkv, window=jcfg.sliding_window, n_sink=0)
                   for c in (jcfg, jlocal))
        r = TPGroupShardedRetriever(cfg, _mesh(2), lambda c: StreamingRetriever(
            c, fkv, window=cfg.sliding_window, n_sink=0))
    else:
        jr, jr1 = (jretrieval.make_retriever(c, jfkv) for c in (jcfg, jlocal))
        r = make_retriever(cfg, fkv, mesh=_mesh(2))
    assert isinstance(r, TPGroupShardedRetriever) and r.local_cfg.n_kv_heads == 1
    return jcfg, cfg, jr, jr1, r


@pytest.mark.parametrize("case", sorted(RETRIEVER_CASES))
def test_tp2_retriever_matches_reference(case):
    """Two shards against the reference's unsharded retriever: the joined
    state after the prefill and after each of 10 decode steps (a page
    completes at the 4th), the output and the counters; and each shard's
    own sync and async counts against the reference's retriever run on
    that shard's heads alone (one KV head and its G query heads)."""
    jcfg, cfg, jr, jr1, r = _pair(case)
    B, T, max_len = 2, 100, 160
    kv, H, d = cfg.n_kv_heads, cfg.n_heads, cfg.d_head
    rng = np.random.default_rng(sorted(RETRIEVER_CASES).index(case))
    k = rng.standard_normal((B, T, kv, d)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    base = rng.standard_normal((B, H, d)).astype(np.float32)

    def decoder(ret):                 # the granularity string stays outside the jit
        def decode_info(*a, **kw):
            o, st_, info = ret.decode(*a, **kw)
            return o, st_, {k_: x for k_, x in info.items() if k_ != "granularity"}
        return jax.jit(decode_info)

    jdecode, jdecode1 = decoder(jr), decoder(jr1)
    jst = jax.jit(jr.prefill)(jr.init_state(B, max_len, jnp.float32), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(base))
    st = r.prefill(r.init_state(B, max_len, torch.float32, "cpu"), _t(k), _t(v), _t(base))
    kvl, hl = kv // 2, H // 2

    def heads(x, s, n):               # shard s's n heads of x, on axis -2
        return jnp.asarray(x[..., s * n:(s + 1) * n, :])

    jprefill1 = jax.jit(jr1.prefill)
    jst1 = [jprefill1(jr1.init_state(B, max_len, jnp.float32), heads(k, s, kvl),
                      heads(v, s, kvl), heads(base, s, hl)) for s in range(2)]

    def same(where):
        joined = join_state(st, 2)
        assert set(jst) <= set(joined), (where, set(jst) - set(joined))
        if "k_u" in jst:       # ShadowKV: singular vectors are defined up to sign
            np.testing.assert_allclose(
                np.einsum("bktr,bkrd->bktd", joined["k_u"].numpy(), joined["k_w"].numpy()),
                np.einsum("bktr,bkrd->bktd", np.asarray(jst["k_u"]), np.asarray(jst["k_w"])),
                **TOL, err_msg=f"{where} k_u @ k_w")
        for key in set(jst) - {"k_u", "k_w"}:
            a, b = np.asarray(jst[key]), joined[key].numpy()
            if a.dtype.kind != "f" or key == "pool":
                np.testing.assert_array_equal(b, a, err_msg=f"{where} {key}")
            else:
                np.testing.assert_allclose(b, a, **TOL, err_msg=f"{where} {key}")

    same("prefill")
    halved = {"sync_pages", "reused_pages"} if case == "shadowkv" else set()
    qp = np.zeros_like(base)
    for t in range(10):
        q = (base + (0.3, 1.5)[t % 3 == 0] * rng.standard_normal(base.shape)).astype(np.float32)
        kn = rng.standard_normal((B, kv, d)).astype(np.float32)
        vn = rng.standard_normal(kn.shape).astype(np.float32)
        jo, jst, jinfo = jdecode(jst, jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                                 q_proxy=jnp.asarray(qp))
        o, st, info = r.decode(st, _t(q), _t(kn), _t(vn), q_proxy=_t(qp))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
        for s in range(2):
            _, jst1[s], jinfo1 = jdecode1(jst1[s], heads(q, s, hl), heads(kn, s, kvl),
                                          heads(vn, s, kvl), q_proxy=heads(qp, s, hl))
            for key in ("sync_pages", "async_pages"):
                np.testing.assert_array_equal(_n(info["shard_" + key][s]),
                                              np.asarray(jinfo1[key]),
                                              err_msg=f"step {t} shard {s} {key}")
        same(f"step {t}")
        for key in set(jinfo) & set(info) - {"similarity"} - halved:
            np.testing.assert_array_equal(_n(info[key]), np.asarray(jinfo[key]), err_msg=key)
        for key in halved:
            # ShadowKV counts V-only blocks as half blocks, floored on each
            # shard before the sum, as the reference's psum of shard-local
            # info does: at most tp - 1 below the unsharded count
            gap = np.asarray(jinfo[key]) - _n(info[key])
            assert ((gap >= 0) & (gap <= 1)).all(), (key, gap)
        np.testing.assert_allclose(_n(info["similarity"]), np.asarray(jinfo["similarity"]),
                                   **TOL)
        assert info["granularity"] == ("token" if case == "infinigen" else "page")
        qp = q
    assert int(join_state(st, 2)["length"][0]) == T + 10


def test_shards_on_their_devices_and_their_rows():
    """Each shard's leaves hold one KV head (or G query heads); the
    replicated leaves are whole in each shard; the wrapper refuses a head
    count tp does not divide."""
    cfg, fkv = get_config(ARCH), FreeKVConfig(**FKV)
    r = make_retriever(cfg, fkv, mesh=_mesh(2))
    st = r.init_state(3, 96, torch.float32, "cpu")
    assert st["0/pool"].shape[2] == st["1/pool"].shape[2] == 1
    assert st["1/qprev"].shape[1] == cfg.n_heads // 2
    assert st["0/length"].shape == st["1/length"].shape == (3,)
    with pytest.raises(ValueError, match="divide"):
        make_retriever(cfg, fkv, mesh=_mesh(3))
    assert tp_serving_active(cfg, _mesh(2)) and tp_serving_active(cfg, _mesh(1))
    assert not tp_serving_active(cfg, _mesh(3)) and not tp_serving_active(cfg, None)


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", list(METHODS) + ["local"])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_tp_state_axis_matches_reference_specs(method, kv_quant):
    """Every leaf's split axis is where the reference's ``tp_state_specs``
    puts ``"model"`` (None where it puts none), and the port's state holds
    the reference's leaves."""
    from repro.core.sharded_retrieval import tp_state_specs
    from repro.launch.mesh import make_tp_mesh as jmake_tp_mesh
    arch = "gemma2-2b-smoke" if method == "local" else ARCH
    kw = dict(FKV, method="freekv" if method == "local" else method, kv_quant=kv_quant)
    jcfg, cfg = jget_config(arch), get_config(arch)
    jfkv, fkv = JFreeKVConfig(**kw), FreeKVConfig(**kw)
    if method == "local":
        jr = jretrieval.StreamingRetriever(jcfg, jfkv, window=jcfg.sliding_window, n_sink=0)
        r = StreamingRetriever(cfg, fkv, window=cfg.sliding_window, n_sink=0)
    else:
        jr, r = jretrieval.make_retriever(jcfg, jfkv), make_retriever(cfg, fkv)
    jst = jax.eval_shape(lambda: jr.init_state(2, 96, jnp.float32))
    specs = tp_state_specs(jcfg, jmake_tp_mesh(1), jst)
    st = r.init_state(2, 96, torch.float32, "cpu")
    assert set(jst) <= set(st)
    for key, spec in specs.items():
        want = list(spec).index("model") if "model" in tuple(spec) else None
        assert tp_state_axis(key) == want, (key, spec)
    for key in ("xk", "xv"):                      # whisper's cross-attention leaves
        assert tp_state_axis(key) == 2


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, model.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def test_engine_rejects_bad_tp(models):
    """The reference's refusals: a tp that does not divide both head counts,
    tp beside the page-sharded fused step (``engine.py:214``), tp beside a
    mesh; and a mesh whose first device is not the backbone's."""
    _, cfg, _, p = models
    fkv = FreeKVConfig(**FKV)
    with pytest.raises(ValueError, match="divide"):
        ServeEngine(cfg, fkv, p, max_len=96, batch_size=1, tp=3, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        ServeEngine(cfg, fkv, p, max_len=96, batch_size=1, mesh=_mesh(3), device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        ServeEngine(cfg, FreeKVConfig(**FKV, sharded_retrieval=True), p, max_len=96,
                    batch_size=1, tp=2, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        ServeEngine(cfg, fkv, p, max_len=96, batch_size=1, tp=2, mesh=_mesh(2), device="cpu")
    with pytest.raises(ValueError, match="first"):
        ServeEngine(cfg, fkv, p, max_len=96, batch_size=1, mesh=_mesh(2), device="meta")
    eng = ServeEngine(cfg, fkv, p, max_len=96, batch_size=1, mesh=_mesh(2), device="cpu")
    assert eng.tp == 2 and eng.mesh.shape == {"model": 2} and eng.recall_tracker.shards == 2


def _mixed(cfg, cls):
    rng = np.random.default_rng(0)
    return [cls(uid=i, tokens=rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                max_new_tokens=5 + (i % 3), priority=0)
            for i, n in enumerate([40, 72, 56, 88, 48, 64])]


def _waves(cfg, cls):
    """Four prompts sharing a 48-token prefix (the reference's prefix-cache
    scenario)."""
    rng = np.random.default_rng(1)
    shared = rng.integers(0, cfg.vocab_size, size=48).astype(np.int32)
    return [cls(uid=100 + i, tokens=np.concatenate(
        [shared, rng.integers(0, cfg.vocab_size, size=24).astype(np.int32)]), max_new_tokens=5)
        for i in range(4)]


@pytest.fixture(scope="module")
def runs(models):
    """Each scenario through the JAX engine at tp=1 and the port's at tp=2:
    {name: ((jax tokens, jax metrics), (port tokens, port metrics, engine))}.
    The JAX engines are compiled once per (overlap, kv_quant); a run sets
    the scheduler's switches and a fresh prefix cache on them."""
    jcfg, cfg, jp, p = models
    jax_engines = {}

    def jax_engine(overlap, quant, scheduler="continuous", preempt=False, prefix=0):
        key = (overlap, quant, scheduler)
        if key not in jax_engines:
            jax_engines[key] = JServeEngine(
                jcfg, JFreeKVConfig(**FKV, recall_overlap=overlap, kv_quant=quant), jp,
                max_len=MAX_LEN, batch_size=SLOTS, prefill_bucket=BUCKET, scheduler=scheduler)
        eng = jax_engines[key]
        eng.fkv = dataclasses.replace(eng.fkv, preempt=preempt)
        eng.prefix_cache = JRadixPrefixCache(prefix) if prefix else None
        return eng

    def gen(name, reqs, overlap=True, quant="none", scheduler="continuous", preempt=False,
            prefix=0, draft_len=0):
        jeng = jax_engine(overlap, quant, scheduler, preempt, prefix)
        jtoks = [c.tokens for c in jeng.generate(reqs(cfg, JRequest))]
        fkv = FreeKVConfig(**FKV, recall_overlap=overlap, kv_quant=quant, preempt=preempt,
                           draft_len=draft_len)
        eng = ServeEngine(cfg, fkv, p, max_len=MAX_LEN, batch_size=SLOTS,
                          prefill_bucket=BUCKET, scheduler=scheduler, prefix_cache_tokens=prefix,
                          mesh=_mesh(2), device="cpu")
        toks = [c.tokens for c in eng.generate(reqs(cfg, Request))]
        out[name] = ((jtoks, jeng.last_metrics), (toks, eng.last_metrics, eng))

    def urgent_last(cfg, cls):
        reqs = _mixed(cfg, cls)
        reqs[-1].priority = 1
        return reqs

    out = {}
    for overlap in (True, False):
        for quant in ("none", "int8"):
            gen(f"traffic/overlap={overlap}/quant={quant}", _mixed, overlap, quant)
    gen("static", _mixed, scheduler="static")
    gen("prefix_cache", _waves, prefix=4096)
    gen("preempt", urgent_last, preempt=True)
    gen("draft_len=4", _mixed, draft_len=4)
    return out


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
def test_tp2_tokens_equal_reference(runs, overlap, quant):
    """Mixed-length continuous traffic (6 requests over 3 slots, slots
    turning over): tokens equal the JAX engine's at tp=1, and so the
    exposed and hidden bytes and the dropped-in-flight bytes."""
    (jtoks, jem), (toks, em, _) = runs[f"traffic/overlap={overlap}/quant={quant}"]
    assert toks == jtoks
    js, s = jem.summary()["recall_overlap"], em.summary()["recall_overlap"]
    for key in ("exposed_bytes", "hidden_bytes", "dropped_in_flight_bytes"):
        assert s[key] == js[key], key
    assert s["exposed_bytes"] > 0
    assert em.summary()["tp"]["tp"] == 2 and em.steps == jem.steps


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_tp2_per_shard_flight_accounting(runs, quant):
    """Each shard's measured bytes of every transfer class (its own
    counters, summed over the live slots' steps) add up to the run's total,
    and every shard moved some; the flight tracker keeps the same counts a
    shard. The reference's per-shard view is each total over tp."""
    _, (_, em, eng) = runs[f"traffic/overlap=True/quant={quant}"]
    s = em.summary()
    per, ro = s["tp"]["per_shard_transfer_bytes"], s["recall_overlap"]
    shard = s["tp"]["shard_transfer_bytes"]
    for cls, total in (("sync", "exposed_bytes"), ("async", "hidden_bytes"),
                       ("dropped", "dropped_in_flight_bytes")):
        assert len(shard[cls]) == 2 and sum(shard[cls]) == ro[total], cls
        assert per[cls] * 2 == ro[total], cls
    assert min(shard["sync"]) > 0 and min(shard["async"]) > 0
    fl = eng.recall_tracker.summary()
    assert fl["per_shard"]["shards"] == 2
    for key, cls in (("staged_pages", "async"), ("topup_pages", "sync"),
                     ("dropped_pages", "dropped")):
        assert fl["per_shard"][key] * 2 == fl[key] == sum(fl["shards"][key])
        assert fl["shards"][key] == em.shard_pages[cls], key


def test_tp2_static_scheduler(runs):
    (jtoks, _), (toks, em, _) = runs["static"]
    assert toks == jtoks and em.tp == 2


def test_tp2_prefix_cache_hits(runs):
    (jtoks, jem), (toks, em, _) = runs["prefix_cache"]
    assert toks == jtoks
    hits = [m.prefix_hit_tokens for m in em.requests]
    assert sum(hits) > 0 and hits == [m.prefix_hit_tokens for m in jem.requests]


def test_tp2_preemption(runs):
    """The urgent request swaps a running one out: tokens equal the JAX
    engine's (and the run without preemption), the swapped bytes in equal
    those out. The byte count is not the reference's: each shard holds the
    replicated leaves (lengths, ring positions) whole."""
    (jtoks, jem), (toks, em, _) = runs["preempt"]
    assert toks == jtoks == runs["traffic/overlap=True/quant=none"][1][0]
    assert em.preemptions == jem.preemptions >= 1 and em.resumes == em.preemptions
    assert em.swap_out_bytes == em.swap_in_bytes > 0


def test_tp2_spec_decode(runs):
    """draft_len 4 composes with tp: the tokens equal draft_len 0's (the
    JAX engine's), in fewer target steps."""
    (jtoks, _), (toks, em, eng) = runs["draft_len=4"]
    assert eng.spec_decode and em.specdec_summary()["verify_steps"] > 0
    assert toks == jtoks == runs["traffic/overlap=True/quant=none"][1][0]


def test_tp2_slot_pool_counts_every_shard(runs):
    """The slot pool's pool bytes count both shards' pools: equal to tp=1's
    (the pool splits by KV head), and each shard's half."""
    _, (_, _, eng) = runs["traffic/overlap=True/quant=int8"]
    one = ServeEngine(get_config(ARCH), eng.fkv, eng.params, max_len=MAX_LEN, batch_size=SLOTS,
                      device="cpu").make_slot_pool(SLOTS)
    assert eng._pool.pool_bytes_detail() == one.pool_bytes_detail()
    half = eng._pool.state["layers"][0]["0/pool"]
    assert 2 * half.numel() == one.state["layers"][0]["pool"].numel()


def test_tp2_http_front_end_serves_unchanged(models, runs):
    """The HTTP front-end serves a tp=2 engine as it serves any: two
    streaming clients get the tokens the JAX engine made for their
    requests."""
    import threading
    from repro_torch.serving.frontend import EngineService, http_generate, serve_http_background
    _, cfg, _, p = models
    eng = ServeEngine(cfg, FreeKVConfig(**FKV), p, max_len=MAX_LEN, batch_size=SLOTS,
                      prefill_bucket=BUCKET, mesh=_mesh(2), device="cpu")
    reqs = _mixed(cfg, Request)[:2]
    svc = EngineService(eng, seed=0).start()
    fe, stop, th = serve_http_background(svc)
    results = {}

    def client(r):
        results[r.uid] = list(http_generate("127.0.0.1", fe.port, {
            "uid": r.uid, "tokens": r.tokens.tolist(), "max_new_tokens": r.max_new_tokens}))

    threads = [threading.Thread(target=client, args=(r,)) for r in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    stop.set()
    th.join(timeout=30)
    svc.stop()
    jtoks = runs["traffic/overlap=True/quant=none"][0][0]
    for r in reqs:
        assert results[r.uid][-1]["event"] == "done"
        assert results[r.uid][-1]["tokens"] == jtoks[r.uid]
    assert eng.last_metrics.summary()["tp"]["tp"] == 2


# ---------------------------------------------------------------------------
# against the reference's tp=2 run (one subprocess, two forced host devices,
# started with the module)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", autouse=True)
def _tp2_proc(tmp_path_factory):
    """The reference's tp=2 run, started with the module's first test, so the
    tests before it run meanwhile."""
    out = tmp_path_factory.mktemp("tp_serving") / "report.json"
    env = dict(os.environ)
    env["XLA_FLAGS"] = env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"), env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), str(out)], env=env,
                            cwd=REPO)
    yield out, proc
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def jax_tp2(_tp2_proc):
    out, proc = _tp2_proc
    assert proc.wait(timeout=600) == 0, proc.args
    return json.loads(out.read_text())


def test_tp2_summary_equals_reference_tp2(runs, jax_tp2):
    """Continuous, overlap, int8: the tokens, ``summary()["tp"]`` (the
    reference's keys; the port adds the measured ``shard_transfer_bytes``)
    and the flight tracker's per-shard view equal the reference's own tp=2
    run."""
    _, (toks, em, eng) = runs["traffic/overlap=True/quant=int8"]
    assert toks == jax_tp2["tokens"]
    tp = em.summary()["tp"]
    assert set(tp) - set(jax_tp2["tp"]) == {"shard_transfer_bytes"}
    assert {k: tp[k] for k in jax_tp2["tp"]} == jax_tp2["tp"]
    assert eng.recall_tracker.summary()["per_shard"] == jax_tp2["per_shard"]


def _reference_tp2_run(out_path):
    """The reference engine at tp=2 on the traffic above (run as a script)."""
    assert len(jax.devices()) >= 2, jax.devices()
    jcfg = jget_config(ARCH)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    eng = JServeEngine(jcfg, JFreeKVConfig(**FKV, recall_overlap=True, kv_quant="int8"), jp,
                       max_len=MAX_LEN, batch_size=SLOTS, prefill_bucket=BUCKET, tp=2)
    toks = [c.tokens for c in eng.generate(_mixed(jcfg, JRequest))]
    s = eng.last_metrics.summary()
    with open(out_path, "w") as f:
        json.dump({"tokens": toks, "tp": s["tp"],
                   "per_shard": eng.recall_tracker.summary()["per_shard"]}, f)


if __name__ == "__main__":
    _reference_tp2_run(sys.argv[1])
