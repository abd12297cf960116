"""Serving under a ("data", "model") compute mesh in the port
(``ServeEngine(mesh=)``, ``models/model``'s mesh forms, the page-sharded
fused decode step of ``core/sharded_retrieval``, the serving rules of
``sharding/rules``, the metrics' mesh section) held against the JAX package.

The oracle is one module-scoped subprocess with four forced XLA host
devices on ``jax.sharding.Mesh`` objects built here (``make_host_mesh``'s
explicit axes make the reference raise under the installed JAX, ROADMAP
queue 3). It runs, on granite-3-8b-smoke (B 2, T 96, page 8, budget 48,
sink 8, window 8), the reference's fused step at model-parallel 2 and 4
with ``sharded_overselect`` 1 and 2 (prefill and ten decode steps, jitted),
its ``ServeEngine(mesh=)`` on both schedulers (its synchronous path, whose
tokens equal its window's, each prefill's and step's logits kept), chunked
and with a prefix hit. It writes everything to an ``.npz`` file. The port gets the
same numpy inputs and the reference's own params (``params_from_jax``), all
float32 on ``("cpu",) * n`` meshes:

  * the fused step: pool, summaries and selected ids exactly equal, the
    output within 1e-5, the transfer counters equal; at model-parallel 1
    it equals the port's plain FreeKV retriever (the intent of the
    reference's ``test_sharded_equals_plain_mp1``);
  * the engine: greedy tokens equal the reference engine's; a 1 x 1 mesh
    equals no mesh bit for bit (tokens, ids, bytes, stats); the logits of
    every prefill and step within 2e-4 of the largest |logit| (the
    reference's own tolerance, ``tests/test_sharding.py``);
  * the rules: ``param_spec(fsdp_shard=False)``, ``inference_fsdp`` at the
    reference's 16e9 bytes, ``decode_state_spec`` and
    ``analytic_decode_bytes`` with ``sharded_retrieval`` equal the
    reference's on every case.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED, SHAPES as J_SHAPES
from repro.configs import get_config as jget_config
from repro.configs.base import FreeKVConfig as JFreeKVConfig
from repro.models import model as jmodel
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import FreeKVConfig
from repro_torch.core import paging, retrieval
from repro_torch.core.retrieval import FreeKVRetriever
from repro_torch.core.sharded_retrieval import PageShardedRetriever
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh, make_tp_mesh
from repro_torch.models import model
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.sharding import rules
from repro_torch.sharding.transfer import MeshRow

torch.set_float32_matmul_precision("highest")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, STEPS = 2, 96, 10
MAX_LEN = T + 64
NEW = 6
LOGIT_RTOL = 2e-4
FKV = dict(method="freekv", page_size=8, budget=48, n_sink=8, n_window=8, tau=0.8)
FUSED = [(m, osx) for m in (2, 4) for osx in (1, 2)]
COUNTERS = ("sync_pages", "async_pages", "sel_pages", "spec_hit_pages", "churn_pages")
# (name, arch, (data, model), engine keywords, FreeKVConfig keywords)
ENGINE_RUNS = [
    ("granite-1x2", "granite-3-8b-smoke", (1, 2), {}, {}),
    ("granite-2x1", "granite-3-8b-smoke", (2, 1), {}, {}),
    ("granite-2x2", "granite-3-8b-smoke", (2, 2), {}, {}),
    ("granite-1x4", "granite-3-8b-smoke", (1, 4), {}, {}),
    ("deepseek-1x2", "deepseek-moe-16b-smoke", (1, 2), {}, {}),
    ("deepseek-1x4", "deepseek-moe-16b-smoke", (1, 4), {}, {}),
    ("granite-2x2-static", "granite-3-8b-smoke", (2, 2), {"scheduler": "static"}, {}),
    ("granite-2x2-chunked", "granite-3-8b-smoke", (2, 2), {}, {"prefill_chunk_tokens": 40}),
    ("granite-2x2-prefix", "granite-3-8b-smoke", (2, 2),
     {"prefix_cache_tokens": 4096, "prefill_bucket": 8}, {}),
    ("granite-1x2-fused", "granite-3-8b-smoke", (1, 2), {}, {"sharded_retrieval": True}),
]
# the engine runs whose every prefill's and step's logits are held (both
# engines on their synchronous path, which hands each step's logits back)
LOGIT_RUNS = [r for r in ENGINE_RUNS if r[0].count("-") == 1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: many small ops, several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(dm):
    return make_host_mesh(dm[1], ("cpu",) * (dm[0] * dm[1]))


def _fused_inputs(cfg):
    """The fused step's prompt K/V, last query and ten steps' q/k/v (numpy)."""
    rng = np.random.default_rng(0)
    kv, d, H = cfg.n_kv_heads, cfg.d_head, cfg.n_heads

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"k": n(B, T, kv, d), "v": n(B, T, kv, d), "q_last": n(B, H, d),
            "q": n(STEPS, B, H, d), "kn": n(STEPS, B, kv, d), "vn": n(STEPS, B, kv, d)}


def _requests(cfg, name):
    rng = np.random.default_rng(1)
    if name.endswith("prefix"):
        shared = rng.integers(0, cfg.vocab_size, 64)
        prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, 32)])
                   for _ in range(3)]
    else:
        prompts = [rng.integers(0, cfg.vocab_size, T) for _ in range(3)]
    return [dict(uid=i, tokens=p.astype(np.int32), max_new_tokens=NEW)
            for i, p in enumerate(prompts)]


def _prompt_batch(cfg):
    return np.random.default_rng(2).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


# ---------------------------------------------------------------------------
# the reference's mesh runs (one subprocess, four forced host devices)
# ---------------------------------------------------------------------------
N_PARTS = 3


@pytest.fixture(scope="module", autouse=True)
def _ref_procs(tmp_path_factory):
    """The reference's runs, started with the module's first test in
    ``N_PARTS`` subprocesses at once (most of their time is XLA compiling),
    one core each, so the tests that need no oracle run meanwhile."""
    out = tmp_path_factory.mktemp("mesh_serving")
    env = dict(os.environ)
    # one core each: the suite runs beside them on every other core
    env["XLA_FLAGS"] = env.get("XLA_FLAGS", "") + (" --xla_force_host_platform_device_count=4"
                                                   " --xla_cpu_multi_thread_eigen=false"
                                                   " intra_op_parallelism_threads=1")
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"), env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(out / f"part{i}.npz"), str(i)], env=env, cwd=REPO)
             for i in range(N_PARTS)]
    yield out, procs
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def ref(_ref_procs):
    out, procs = _ref_procs
    for p in procs:
        assert p.wait(timeout=600) == 0, p.args
    runs = {}
    for i in range(N_PARTS):
        with np.load(out / f"part{i}.npz") as data:
            runs.update({k: data[k] for k in data.files})
    return runs


def _record_logits(eng, to_numpy):
    """The logits of every ``prefill_one`` and ``step`` call ``eng``'s
    scheduler makes, in order, as numpy (the list fills as it runs)."""
    out = []
    step, prefill_one = eng.step, eng.prefill_one

    def rec_step(*a, **k):
        res = step(*a, **k)
        out.append(to_numpy(res[0]))
        return res

    def rec_prefill(*a, **k):
        res = prefill_one(*a, **k)
        out.append(to_numpy(res[0]))
        return res
    eng.step, eng.prefill_one = rec_step, rec_prefill
    return out


def _jmesh(dm):
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:dm[0] * dm[1]]).reshape(dm), ("data", "model"))


def _reference_runs(out_path, part):
    """Part ``part`` of what the tests hold the port against, through the
    reference (the fused step and a third of the engine runs)."""
    from repro.core.retrieval import make_retriever
    from repro.serving.engine import Request as JRequest, ServeEngine as JServeEngine
    from repro.serving.prefix_cache import RadixPrefixCache
    assert len(jax.devices()) >= 4, jax.devices()
    flat = {}
    cfg = jget_config("granite-3-8b-smoke")
    x = {k: jnp.asarray(v) for k, v in _fused_inputs(cfg).items()}
    # part 0 the fused step and deepseek's runs, 1 the (2, 2) runs (one
    # engine), 2 the rest
    parts = [[r for r in ENGINE_RUNS if r[1].startswith("deepseek")],
             [r for r in ENGINE_RUNS if r[2] == (2, 2)]]
    parts.append([r for r in ENGINE_RUNS if r not in parts[0] + parts[1]])
    engine_runs = parts[part]
    for m, osx in FUSED if part == 0 else ():
        mesh = _jmesh((1, m))
        fkv = JFreeKVConfig(**FKV, sharded_retrieval=True, sharded_overselect=osx)
        r = make_retriever(cfg, fkv, mesh=mesh)
        with mesh:
            st = r.init_state(B, MAX_LEN, jnp.float32)
            st = jax.jit(r.prefill)(st, x["k"], x["v"], x["q_last"])
            def step(s, q, kn, vn):
                o, s, info = r.decode(s, q, kn, vn)
                return o, s, {c: info[c] for c in COUNTERS}   # no granularity string
            dec = jax.jit(step)
            os_, infos = [], []
            for t in range(STEPS):
                o, st, info = dec(st, x["q"][t], x["kn"][t], x["vn"][t])
                os_.append(np.asarray(o))
                infos.append([np.asarray(info[c]) for c in COUNTERS])
        key = f"fused|{m}|{osx}"
        flat[key + "|o"] = np.stack(os_)
        flat[key + "|info"] = np.asarray(infos)
        for leaf in ("pool", "summ", "sel_idx"):
            flat[f"{key}|{leaf}"] = np.asarray(st[leaf])
    engines = {}
    for name, arch, dm, ekw, fkw in engine_runs:
        acfg = jget_config(arch)
        mesh = _jmesh(dm)
        # one engine a (arch, mesh, retrieval) serves the scheduler variants,
        # their switches set per run (as tests/test_torch_chunked.py's)
        key = (arch, dm, fkw.get("sharded_retrieval", False))
        if key not in engines:
            # the reference's synchronous path: its window's tokens (by
            # design), and every prefill's and step's logits handed back
            fkv = JFreeKVConfig(**FKV, sharded_retrieval=key[2], sample_on_device=False)
            eng = JServeEngine(acfg, fkv, jmodel.init_params(acfg, jax.random.PRNGKey(0)),
                               max_len=MAX_LEN, batch_size=2, mesh=mesh)
            engines[key] = (eng, fkv, _record_logits(eng, np.asarray))
        eng, fkv, logits = engines[key]
        logits.clear()
        eng.fkv = dataclasses.replace(fkv, **fkw)
        eng.scheduler = ekw.get("scheduler", "continuous")
        eng.prefill_bucket = ekw.get("prefill_bucket", 1)
        eng.prefix_cache = (RadixPrefixCache(ekw["prefix_cache_tokens"])
                            if "prefix_cache_tokens" in ekw else None)
        with mesh:
            comps = eng.generate([JRequest(**r) for r in _requests(acfg, name)])
        for c in comps:
            flat[f"engine|{name}|{c.uid}"] = np.asarray(c.tokens, np.int64)
        for i, lg in enumerate(logits):
            flat[f"logits|{name}|{i}"] = lg
    np.savez(out_path, **flat)


# ---------------------------------------------------------------------------
# the page-sharded fused step
# ---------------------------------------------------------------------------
def _t(a):
    return torch.from_numpy(np.asarray(a))


def _fused_port(cfg, fkv, m):
    """The port's fused step on a (1, m) mesh of CPU shards -> (outputs (10,
    B, H, d), infos, the joined pool, summaries and ids, the mesh)."""
    x = {k: _t(v) for k, v in _fused_inputs(cfg).items()}
    mesh = _cpu_mesh((1, m))
    r = PageShardedRetriever(cfg, fkv, MeshRow(mesh, 0))
    st = r.init_state(B, MAX_LEN, torch.float32)
    st = r.prefill(st, x["k"], x["v"], x["q_last"])
    os_, infos = [], []
    for t in range(STEPS):
        o, st, info = r.decode(st, x["q"][t], x["kn"][t], x["vn"][t])
        os_.append(o)
        infos.append([info[c].numpy() for c in COUNTERS])
    joined = {leaf: torch.cat([st[f"{j}/{leaf}"] for j in range(m)], dim=axis)
              for leaf, axis in (("pool", 1), ("summ", 1), ("sel_idx", 2))}
    return torch.stack(os_), np.asarray(infos), joined, mesh


def test_fused_step_mp1_equals_plain_freekv():
    """At model-parallel 1 the fused step is the plain FreeKV path across a
    page boundary: pool bit-exact, the same ids, output within 1e-5."""
    cfg = get_config("granite-3-8b-smoke")
    fkv = FreeKVConfig(**FKV, sharded_retrieval=True)
    o_f, _, joined, _ = _fused_port(cfg, fkv, 1)
    x = {k: _t(v) for k, v in _fused_inputs(cfg).items()}
    plain = FreeKVRetriever(cfg, FreeKVConfig(**FKV))
    st = plain.prefill(plain.init_state(B, MAX_LEN, torch.float32, "cpu"), x["k"], x["v"],
                       x["q_last"])
    os_ = []
    for t in range(STEPS):
        o, st, _ = plain.decode(st, x["q"][t], x["kn"][t], x["vn"][t])
        os_.append(o)
    assert (T + STEPS) // 8 > T // 8                       # a page completes on the way
    assert float((o_f - torch.stack(os_)).abs().max()) <= 1e-5
    assert torch.equal(joined["pool"], st["pool"])
    assert torch.equal(joined["summ"], st["summ"])
    assert torch.equal(joined["sel_idx"], st["sel_idx"])


def test_fused_dims_and_sel_slots():
    """``sharded_overselect`` multiplies the selection slots under the fused
    step only (reference ``paging.py:47-50``), as the reference's dims."""
    from repro.core import paging as jpaging
    cfg, jcfg = get_config("granite-3-8b-smoke"), jget_config("granite-3-8b-smoke")
    for kw in ({}, {"sharded_retrieval": True}, {"sharded_retrieval": True,
                                                  "sharded_overselect": 2},
               {"sharded_overselect": 3}):
        want = jpaging.state_dims(jcfg, JFreeKVConfig(**FKV, **kw), MAX_LEN)
        assert paging.state_dims(cfg, FreeKVConfig(**FKV, **kw), MAX_LEN) == tuple(want)
    assert retrieval.use_sharded(cfg, FreeKVConfig(**FKV, sharded_retrieval=True), 4, MAX_LEN)
    assert not retrieval.use_sharded(cfg, FreeKVConfig(**FKV, sharded_retrieval=True,
                                                       kv_quant="int8"), 2, MAX_LEN)
    assert not retrieval.use_sharded(cfg, FreeKVConfig(**FKV, sharded_retrieval=True), 3,
                                     MAX_LEN)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
_JPARAMS = {}


def _params(arch):
    """The reference's params for ``arch`` in the port's layout, float32."""
    if arch not in _JPARAMS:
        cfg = jget_config(arch)
        jp = jax.tree.map(np.asarray, jmodel.init_params(cfg, jax.random.PRNGKey(0)))
        _JPARAMS[arch] = model.params_from_jax(get_config(arch), jp, device="cpu")
    return _JPARAMS[arch]


def _engine(arch, dm, ekw, fkw, mesh=None):
    cfg = get_config(arch)
    mesh = mesh if mesh is not None or dm is None else _cpu_mesh(dm)
    return ServeEngine(cfg, FreeKVConfig(**FKV, **fkw), _params(arch), max_len=MAX_LEN,
                       batch_size=2, device="cpu", mesh=mesh, **ekw)


@pytest.mark.parametrize("scheduler", ["continuous", "static"])
@pytest.mark.parametrize("arch,fkw", [("granite-3-8b-smoke", {}),
                                      ("gemma2-2b-smoke", {}),
                                      ("deepseek-moe-16b-smoke", {})],
                         ids=["granite", "gemma2", "deepseek"])
def test_one_by_one_mesh_is_no_mesh(arch, fkw, scheduler):
    """A 1 x 1 mesh serves what no mesh serves, bit for bit: tokens, the
    stats, the transfer bytes and every decode-state leaf after the run.
    (With ``sharded_retrieval`` a 1 x 1 mesh takes the fused step, whose
    accounting differs by design, as the reference's; its outputs are held
    to the plain path in ``test_fused_step_mp1_equals_plain_freekv``.)"""
    cfg = get_config(arch)
    runs = {}
    for dm in (None, (1, 1)):
        eng = _engine(arch, dm, {"scheduler": scheduler}, fkw)
        comps = eng.generate([Request(**r) for r in _requests(cfg, "plain")])
        summary = eng.last_metrics.summary()
        runs[dm] = ([c.tokens for c in comps], [c.stats for c in comps],
                    summary["recall_overlap"], eng)
    assert runs[None][:3] == runs[(1, 1)][:3]
    if scheduler == "continuous":
        plain, meshed = runs[None][3]._pool.state, runs[(1, 1)][3]._pool.state
        for a, b in zip(plain["layers"], meshed["layers"]):
            assert {f"0:0/{k}" for k in a} == set(b), (set(a), set(b))
            for k, t in a.items():
                assert torch.equal(t, b[f"0:0/{k}"]), k


def test_decode_step_moved_bytes_by_hand():
    """One decode step of granite-3-8b-smoke (B 2, float32) at (1, 2), the
    bytes its shards move by kind, counted from the shapes: Megatron heads
    (4 / 2 and 2 / 2 divide the model axis), the weights placed in the
    layout the shards compute with (``rules.serving_spec``: wo and down by
    row, so no weight moves), and the vocab-parallel embedding and
    logits."""
    cfg = get_config("granite-3-8b-smoke")
    mesh = _cpu_mesh((1, 2))
    params = rules.place_serving_params(cfg, _params("granite-3-8b-smoke"), mesh)
    assert not rules.inference_fsdp(cfg, mesh)
    fkv = FreeKVConfig(**FKV)
    logits, st = model.prefill(cfg, fkv, params, {"tokens": torch.from_numpy(
        _prompt_batch(cfg)).long()}, max_len=MAX_LEN, state_dtype=torch.float32, mesh=mesh)
    mesh.moved.reset()
    model.serve_step(cfg, fkv, params, st, logits.argmax(-1)[:, None], collect_stats=True,
                     mesh=mesh)
    d, f32, i64 = cfg.d_model, 4, 8
    V, kv = cfg.padded_vocab(), cfg.n_kv_heads
    n_layers = cfg.n_layers
    act = B * d * f32                       # one token's (B, 1, d) activation
    want = dict.fromkeys(mesh.moved.bytes, 0)
    # the embedding: the tokens to shard 1, its rows back; the logits: x to
    # shard 1, its vocab block back
    want["vocab"] = B * i64 + act + act + B * (V // 2) * f32
    # a layer: h to shard 1 and the partial output back, for attention and MLP
    want["partial_sum"] = n_layers * 4 * act
    # every shard holds the blocks it multiplies by: no weight_gather
    want["attn_in"] = n_layers * B * 4      # the positions (int32) to shard 1
    # shard 1's info: corrected (B, kv / 2) bool, similarity (B, kv / 2)
    # float32, six int64 counters (B,)
    want["stats"] = n_layers * (B * kv // 2 + B * kv // 2 * f32 + 6 * B * i64)
    assert mesh.moved.bytes == want


@pytest.mark.parametrize("arch,dm", [
    ("granite-3-8b-smoke", (1, 2)),          # KV-head groups, vocab-parallel
    ("granite-3-8b-smoke", (1, 4)),          # 4 / 2 heads: the input-dim split
    ("llama31-8b-smoke", (2, 2)),            # an untied head, two data groups
    ("deepseek-moe-16b-smoke", (1, 4)),      # experts, router copies, shared experts
    ("deepseek-moe-16b-smoke", (1, 3)),      # nothing divides: every leaf whole on shard 0
])
def test_serving_layout_gathers_no_weight(arch, dm):
    """Without FSDP the serving placement (``rules.serving_spec``) holds each
    weight in the layout its shards compute with: a prefill and a decode
    step fetch no weight, and their logits and every other kind of moved
    bytes equal those of the reference's storage layout (``param_spec(
    fsdp_shard=False)``, re-laid out as the shards fetch)."""
    cfg = get_config(arch)
    params = model.init_params(cfg, 0, device="cpu")
    fkv = FreeKVConfig(**FKV)
    toks = torch.from_numpy(_prompt_batch(cfg)).long()
    runs = []
    for layout in ("serving", "storage"):
        mesh = _cpu_mesh(dm)
        if layout == "serving":
            placed = rules.place_serving_params(cfg, params, mesh, fsdp=False)
        else:
            placed = [rules.map_leaves(lambda path, t, g=g: rules.Sharded.place(
                t, rules.param_spec(mesh, "/".join(map(str, path)), t.shape, fsdp_shard=False),
                mesh, g), params) for g in range(dm[0])]
        logits, st = model.prefill(cfg, fkv, placed, {"tokens": toks}, max_len=MAX_LEN,
                                   state_dtype=torch.float32, mesh=mesh)
        pre = dict(mesh.moved.bytes)
        mesh.moved.reset()
        step, _ = model.serve_step(cfg, fkv, placed, st, logits.argmax(-1)[:, None], mesh=mesh)
        runs.append((logits, step, pre, dict(mesh.moved.bytes)))
    (l0, s0, p0, m0), (l1, s1, p1, m1) = runs
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    assert p0["weight_gather"] == m0["weight_gather"] == 0
    if dm[1] == 4 and arch.startswith("granite"):
        assert m1["weight_gather"] > 0       # the storage layout re-lays wq/wk/wv/wo out
    for moved in ((p0, p1), (m0, m1)):
        assert {k: v for k, v in moved[0].items() if k != "weight_gather"} == \
            {k: v for k, v in moved[1].items() if k != "weight_gather"}


# ---------------------------------------------------------------------------
# the errors
# ---------------------------------------------------------------------------
def test_errors():
    cfg = get_config("granite-3-8b-smoke")
    params = _params("granite-3-8b-smoke")
    with pytest.raises(ValueError, match="either mesh= or tp="):
        ServeEngine(cfg, FreeKVConfig(**FKV), params, MAX_LEN, 2, device="cpu",
                    mesh=_cpu_mesh((1, 2)), tp=2)
    with pytest.raises(ValueError, match="exclusive"):
        ServeEngine(cfg, FreeKVConfig(**FKV, sharded_retrieval=True), params, MAX_LEN, 2,
                    device="cpu", mesh=make_tp_mesh(2, ("cpu", "cpu")))
    with pytest.raises(ValueError, match="centroid"):
        FreeKVConfig(**{**FKV, "method": "centroid"}, sharded_retrieval=True)
    eng = ServeEngine(cfg, FreeKVConfig(**FKV, sharded_retrieval=True, draft_len=3), params,
                      MAX_LEN, 2, device="cpu", mesh=_cpu_mesh((1, 2)))
    assert not eng.spec_decode and eng.fkv.draft_len == 0
    assert not model.supports_spec_decode(cfg, FreeKVConfig(**FKV, sharded_retrieval=True,
                                                            draft_len=3))
    assert model.supports_spec_decode(cfg, FreeKVConfig(**FKV, draft_len=3))
    # the recurrent mixers and the encoder-decoder serve under a mesh
    # (``tests/test_torch_mesh_recurrent_serving.py`` holds their tokens)
    for arch in ("jamba-1.5-large-398b-smoke", "xlstm-350m-smoke", "whisper-tiny-smoke"):
        acfg = get_config(arch)
        ap = model.init_params(acfg, 0, "cpu")
        eng = ServeEngine(acfg, FreeKVConfig(**FKV), ap, MAX_LEN, 2, device="cpu",
                          mesh=_cpu_mesh((1, 2)))
        assert eng.compute_mesh and isinstance(eng.params, list)


# ---------------------------------------------------------------------------
# the rules, against the reference's
# ---------------------------------------------------------------------------
def _abstract_mesh(shape, names):
    from jax.sharding import AbstractMesh
    try:
        return AbstractMesh(shape, names)
    except TypeError:   # jax <= 0.4.x: one shape tuple of (name, size) pairs
        return AbstractMesh(tuple(zip(names, shape)))


def _spec_tuple(spec, ndim):
    out = [() if e is None else (e,) if isinstance(e, str) else tuple(e) for e in spec]
    return tuple(out + [()] * (ndim - len(out)))


PROD = [make_production_mesh(), make_production_mesh(multi_pod=True)]
SMALL = [make_production_mesh().__class__(("data", "model"), dm) for dm in
         ((1, 2), (2, 2), (1, 4))]


@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_spec_without_fsdp_and_inference_fsdp(arch):
    from repro.sharding import rules as jrules
    cfg = jget_config(arch)
    shapes = jax.eval_shape(lambda: jmodel.init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    for mesh in PROD + SMALL:
        jmesh = _abstract_mesh(mesh.dims, mesh.axis_names)
        for path, leaf in leaves:
            name = jrules._path_str(path)
            want = _spec_tuple(jrules.param_spec(jmesh, name, leaf, fsdp_shard=False), leaf.ndim)
            assert rules.param_spec(mesh, name, leaf.shape, fsdp_shard=False) == want, name
        assert rules.inference_fsdp(get_config(arch), mesh, hbm_bytes=16e9) == \
            jrules.inference_fsdp(cfg, jmesh)


def _jdryrun_fkv(**kw):
    return JFreeKVConfig(method="freekv", page_size=32, budget=2048, n_sink=512, n_window=512,
                         tau=0.9, pool_pad_pages=512, **kw)


@pytest.mark.parametrize("sharded", [False, True], ids=["plain", "sharded"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_decode_state_spec_equals_reference(arch, sharded):
    """Every decode-state leaf of the reference's own state at each of
    SHAPES (its length + 64, as ``tests/test_sharding.py``), on the
    production meshes and on (1, 2), (2, 2) and (1, 4), with
    ``sharded_retrieval`` off and on (``sharded_overselect`` 2)."""
    from repro.sharding import rules as jrules
    jcfg, cfg = jget_config(arch), get_config(arch)
    kw = {"sharded_retrieval": True, "sharded_overselect": 2} if sharded else {}
    jfkv = _jdryrun_fkv(**kw)
    fkv = FreeKVConfig(**{f.name: getattr(jfkv, f.name) for f in dataclasses.fields(
        FreeKVConfig) if hasattr(jfkv, f.name) and f.name != "retriever"})
    n = 0
    for sname, shp in J_SHAPES.items():
        assert SHAPES[sname].seq_len == shp.seq_len
        st = jax.eval_shape(lambda: jmodel.init_decode_state(
            jcfg, jfkv, shp.global_batch, shp.seq_len + 64, jnp.bfloat16))
        leaves = jax.tree_util.tree_flatten_with_path(st)[0]
        for mesh in PROD + SMALL:
            jmesh = _abstract_mesh(mesh.dims, mesh.axis_names)
            for path, leaf in leaves:
                name = jrules._path_str(path)
                want = _spec_tuple(jrules.decode_state_spec(jcfg, jmesh, name, leaf, jfkv),
                                   leaf.ndim)
                got = rules.decode_state_spec(cfg, mesh, name, leaf.shape, fkv)
                assert got == want, (name, leaf.shape, mesh.dims)
                n += 1
    assert n > 100


@pytest.mark.parametrize("sharded", [False, True], ids=["plain", "sharded"])
def test_analytic_decode_bytes_with_the_flag(sharded):
    """``analytic_decode_bytes`` equals the reference's for every arch x
    shape x mesh with ``sharded_retrieval`` off and on (its ``or
    fkv.sharded_retrieval`` terms, ``roofline.py:126,135``)."""
    from repro.launch import roofline as jroofline
    from repro_torch.launch import dryrun
    fkv = dataclasses.replace(dryrun.dryrun_fkv(), sharded_retrieval=sharded)
    jfkv = _jdryrun_fkv(sharded_retrieval=sharded)
    meshes = [{"data": 1, "model": 1}, {"data": 16, "model": 16},
              {"pod": 2, "data": 16, "model": 16}, {"data": 1, "model": 2},
              {"data": 2, "model": 2}, {"data": 1, "model": 4}]
    for arch in ASSIGNED:
        cfg, jcfg = get_config(arch), jget_config(arch)
        for sname, shp in SHAPES.items():
            for mesh in meshes:
                assert rl.analytic_decode_bytes(cfg, fkv, shp, mesh) == \
                    jroofline.analytic_decode_bytes(jcfg, jfkv, J_SHAPES[sname], mesh)


def test_serving_placement_holds_a_copy_per_data_group():
    """Without FSDP each data group holds its own copy of every leaf on its
    own model shards; with it the groups share one placement."""
    cfg = get_config("granite-3-8b-smoke")
    mesh = _cpu_mesh((2, 2))
    params = _params("granite-3-8b-smoke")
    for fsdp in (False, True):
        placed = rules.place_serving_params(cfg, params, mesh, fsdp=fsdp)
        assert len(placed) == 2 and (placed[0] is placed[1]) == fsdp
        for g, tree in enumerate(placed):
            wq = tree["layers"][0]["mixer"]["wq"]
            assert torch.equal(wq.full("cpu"), params["layers"][0]["mixer"]["wq"])
            owners = {wq.owner(k)[0] for k in range(len(wq.pieces))}
            assert owners == ({0, 1} if fsdp else {g})


# ---------------------------------------------------------------------------
# against the reference's mesh runs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,osx", FUSED, ids=[f"mp{m}-os{o}" for m, o in FUSED])
def test_fused_step_equals_reference(ref, m, osx):
    cfg = get_config("granite-3-8b-smoke")
    fkv = FreeKVConfig(**FKV, sharded_retrieval=True, sharded_overselect=osx)
    o, infos, joined, mesh = _fused_port(cfg, fkv, m)
    key = f"fused|{m}|{osx}"
    for leaf in ("pool", "summ", "sel_idx"):
        np.testing.assert_array_equal(joined[leaf].numpy(), ref[f"{key}|{leaf}"], err_msg=leaf)
    assert float(np.abs(o.numpy() - ref[key + "|o"]).max()) <= 1e-5
    np.testing.assert_array_equal(infos, ref[key + "|info"])
    moved = mesh.moved.bytes
    assert moved["lse"] > 0 and moved["attn_in"] > 0 and moved["state"] > 0
    assert (moved["overselect"] > 0) == (osx > 1)


@pytest.mark.parametrize("name,arch,dm,ekw,fkw", ENGINE_RUNS, ids=[r[0] for r in ENGINE_RUNS])
def test_engine_tokens_equal_reference(ref, name, arch, dm, ekw, fkw):
    cfg = get_config(arch)
    retrieval.SHARDED_PATHS.update(fused=0, fallback=0)
    eng = _engine(arch, dm, ekw, fkw)
    comps = eng.generate([Request(**r) for r in _requests(cfg, name)])
    for c in comps:
        np.testing.assert_array_equal(np.asarray(c.tokens), ref[f"engine|{name}|{c.uid}"],
                                      err_msg=f"{name} request {c.uid}")
    summary = eng.last_metrics.summary()
    assert summary["mesh"]["shape"] == {"data": dm[0], "model": dm[1]}
    if name.endswith("fused"):
        # every global layer's decode steps took the fused step
        assert retrieval.SHARDED_PATHS["fallback"] == 0
        assert retrieval.SHARDED_PATHS["fused"] == summary["mesh"]["decode_steps"] * sum(
            mixer == "attn" for mixer, _ in cfg.layers)
    if name.endswith("prefix"):
        assert summary["prefix_cache"]["hits"] >= 1
    if name.endswith("chunked"):
        assert summary["scheduling"]["prefill_chunks"] > len(comps)


@pytest.mark.parametrize("name,arch,dm,ekw,fkw", LOGIT_RUNS, ids=[r[0] for r in LOGIT_RUNS])
def test_logits_equal_reference(ref, name, arch, dm, ekw, fkw):
    """Every prefill's and decode step's logits of the engine on its
    synchronous path, within 2e-4 of the largest |logit| of the reference
    engine's on its own (float32, over the real vocabulary)."""
    cfg = get_config(arch)
    eng = _engine(arch, dm, ekw, {**fkw, "sample_on_device": False})
    got = _record_logits(eng, lambda t: t.numpy())
    eng.generate([Request(**r) for r in _requests(cfg, name)])
    n = sum(k.startswith(f"logits|{name}|") for k in ref)
    assert len(got) == n > 2 * NEW
    for i, g in enumerate(got):
        g, w = g[..., :cfg.vocab_size], ref[f"logits|{name}|{i}"][..., :cfg.vocab_size]
        assert np.abs(g - w).max() <= LOGIT_RTOL * np.abs(w).max(), (name, i)

if __name__ == "__main__":
    _reference_runs(sys.argv[1], int(sys.argv[2]))
