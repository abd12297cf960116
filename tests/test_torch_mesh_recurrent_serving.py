"""Serving the recurrent mixers and the encoder-decoder under a ("data",
"model") compute mesh in the port (``ServeEngine(mesh=)``: Mamba split by
d_inner, the mLSTM by head, the sLSTM whole on each group's shard 0,
whisper's encoder on the shards and its cross-attention K/V by KV-head
group), and speculative decoding under a compute mesh, held against the JAX
package.

The oracle is one module-scoped set of subprocesses with four forced XLA
host devices on ``jax.sharding.Mesh`` objects built here (as
``tests/test_torch_mesh_serving.py``). They run the reference's
``ServeEngine(mesh=)`` (B 2, three 96-token prompts, 6 new tokens, page 8,
budget 48, sink 8, window 8; its synchronous path, each prefill's and
step's logits kept) for xlstm-350m-smoke, jamba-1.5-large-398b-smoke and
whisper-tiny-smoke at (1, 2) and (2, 2), and whisper-tiny-smoke at (1, 4);
and granite-3-8b-smoke at (1, 2) and (2, 2) with ``draft_len`` 4 (its
speculative window, greedy). The port gets the reference's own params
(``params_from_jax``), float32, on ``("cpu",) * n`` meshes:

  * greedy tokens equal the reference's mesh engine (jamba at (2, 2) routes
    each data group's MoE rows on their own, so its tokens move off the
    unsharded engine's, the reference's and the port's alike);
  * every prefill's and step's logits within 2e-4 of the largest |logit|;
  * speculative decoding's tokens equal the reference's and the port's
    ``draft_len`` 0 tokens;
  * a 1 x 1 mesh serves what no mesh serves, bit for bit, and the serving
    placement fetches no weight.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import FreeKVConfig as JFreeKVConfig
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.configs.base import FreeKVConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.sharding import rules

torch.set_float32_matmul_precision("highest")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, NEW, MAX_LEN, SLOTS = 96, 6, 160, 2
LOGIT_RTOL = 2e-4
FKV = dict(method="freekv", page_size=8, budget=48, n_sink=8, n_window=8, tau=0.8)
XLSTM, JAMBA, WHISPER = ("xlstm-350m-smoke", "jamba-1.5-large-398b-smoke", "whisper-tiny-smoke")
GRANITE = "granite-3-8b-smoke"
ENGINE_RUNS = [(a, dm) for a in (XLSTM, JAMBA, WHISPER) for dm in ((1, 2), (2, 2))] + [
    (WHISPER, (1, 4))]
SPEC_RUNS = [(GRANITE, (1, 2)), (GRANITE, (2, 2))]
DRAFT_LEN = 4
# the reference's runs in three subprocesses of about equal compile time,
# each arch's params made in one
PARTS = [[(WHISPER, (1, 2)), (WHISPER, (2, 2)), (WHISPER, (1, 4))],
         [(JAMBA, (1, 2)), (JAMBA, (2, 2))],
         [(XLSTM, (1, 2)), (XLSTM, (2, 2))] + SPEC_RUNS]
N_PARTS = len(PARTS)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: many small ops, several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _name(arch, dm):
    return f"{arch}|{dm[0]}x{dm[1]}"


def _cpu_mesh(dm):
    return make_host_mesh(dm[1], ("cpu",) * (dm[0] * dm[1]))


def _requests(cfg, request_cls):
    """Three 96-token prompts, each with its seeded frames for whisper."""
    rng = np.random.default_rng(1)
    out = []
    for i in range(3):
        fe = (None if cfg.frontend is None else (0.1 * rng.standard_normal(
            (cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32))
        out.append(request_cls(uid=i, tokens=rng.integers(0, cfg.vocab_size, T).astype(np.int32),
                               max_new_tokens=NEW, frontend=fe))
    return out


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


# ---------------------------------------------------------------------------
# the reference's mesh runs (subprocesses, four forced host devices)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", autouse=True)
def _ref_procs(tmp_path_factory):
    """The reference's runs, started with the module's first test in
    ``N_PARTS`` subprocesses at once, one core each, so the tests that need
    no oracle run meanwhile."""
    out = tmp_path_factory.mktemp("mesh_recurrent_serving")
    env = dict(os.environ)
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


def _reference_runs(out_path, part):
    """Part ``part`` of the engine and speculative runs through the
    reference (run as a script)."""
    from jax.sharding import Mesh
    from repro.serving.engine import Request as JRequest, ServeEngine as JServeEngine
    assert len(jax.devices()) >= 4, jax.devices()
    assert sorted(c for p in PARTS for c in p) == sorted(ENGINE_RUNS + SPEC_RUNS)
    flat, params = {}, {}
    for arch, dm in PARTS[part]:
        cfg = jget_config(arch)
        mesh = Mesh(np.asarray(jax.devices()[:dm[0] * dm[1]]).reshape(dm), ("data", "model"))
        spec = (arch, dm) in SPEC_RUNS
        # the synchronous path hands each step's logits back; speculation
        # rides the window
        fkv = JFreeKVConfig(**FKV, sample_on_device=spec, draft_len=DRAFT_LEN if spec else 0)
        if arch not in params:              # the tests read them from here
            params[arch] = jmodel.init_params(cfg, jax.random.PRNGKey(0))
            for path, leaf in jax.tree_util.tree_flatten_with_path(params[arch])[0]:
                name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
                flat[f"params|{arch}|{name}"] = np.asarray(leaf)
        eng = JServeEngine(cfg, fkv, params[arch], max_len=MAX_LEN, batch_size=SLOTS, mesh=mesh)
        assert eng.spec_decode == spec
        logits = _record_logits(eng, np.asarray)
        with mesh:
            comps = eng.generate(_requests(cfg, JRequest))
        name = _name(arch, dm)
        for c in comps:
            flat[f"tokens|{name}|{c.uid}"] = np.asarray(c.tokens, np.int64)
        for i, lg in enumerate(logits):
            flat[f"logits|{name}|{i}"] = lg
    np.savez(out_path, **flat)


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------
_PARAMS = {}


def _unflatten(flat):
    """{"a/0/b": x} -> {"a": ({"b": x},)}, digit-keyed dicts as tuples."""
    root = {}
    for key, arr in flat.items():
        *parents, last = key.split("/")
        node = root
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = arr

    def seq(t):
        if not isinstance(t, dict):
            return t
        t = {k: seq(v) for k, v in t.items()}
        return tuple(t[str(i)] for i in range(len(t))) if all(k.isdigit() for k in t) else t
    return seq(root)


def _params(arch, ref=None):
    """``arch``'s params in the port's layout, float32: the reference's own,
    as its subprocess wrote them, where the test holds the port against
    the reference (``ref``); else the port's seeded ones."""
    key = (arch, ref is not None)
    if key not in _PARAMS:
        cfg = get_config(arch)
        if ref is None:
            _PARAMS[key] = model.init_params(cfg, 0, device="cpu")
        else:
            pre = f"params|{arch}|"
            jp = _unflatten({k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)})
            jp.setdefault("prelude", ())
            _PARAMS[key] = model.params_from_jax(cfg, jp, device="cpu")
    return _PARAMS[key]


def _engine(arch, dm, ref=None, **fkw):
    return ServeEngine(get_config(arch), FreeKVConfig(**FKV, **fkw), _params(arch, ref),
                       max_len=MAX_LEN, batch_size=SLOTS, device="cpu",
                       mesh=None if dm is None else _cpu_mesh(dm))


# the tests that need no oracle run first, while the reference compiles
def test_sharded_retrieval_keeps_speculation_off():
    """The page-sharded fused step keeps its own selection schedule, so
    ``supports_spec_decode`` (the reference's) turns speculation off under
    it, on a compute mesh too."""
    eng = _engine(GRANITE, (1, 2), draft_len=DRAFT_LEN, sharded_retrieval=True)
    assert not eng.spec_decode and eng.fkv.draft_len == 0


@pytest.mark.parametrize("arch", [XLSTM, JAMBA, WHISPER])
def test_one_by_one_mesh_is_no_mesh(arch):
    """A 1 x 1 mesh serves what no mesh serves, bit for bit: tokens, stats
    and every decode-state leaf after the run."""
    cfg = get_config(arch)
    runs = {}
    for dm in (None, (1, 1)):
        eng = _engine(arch, dm)
        comps = eng.generate(_requests(cfg, Request))
        runs[dm] = ([c.tokens for c in comps], [c.stats for c in comps], eng._pool.state)
    assert runs[None][:2] == runs[(1, 1)][:2]
    for a, b in zip(runs[None][2]["layers"], runs[(1, 1)][2]["layers"]):
        assert {f"0:0/{k}" for k in a} == set(b), (set(a), set(b))
        for k, t in a.items():
            assert torch.equal(t, b[f"0:0/{k}"]), k


@pytest.mark.parametrize("arch,dm,fkw", [(XLSTM, (1, 2), {}), (JAMBA, (2, 2), {}),
                                         (WHISPER, (2, 2), {}),
                                         (GRANITE, (2, 2), {"draft_len": DRAFT_LEN})],
                         ids=["xlstm", "jamba", "whisper", "granite-spec"])
def test_slot_swap_moves_a_request_between_data_groups(arch, dm, fkw):
    """A request prefilled into slot 1 (data group 1 at (2, 2), model shard
    blocks of its recurrent state, whisper's cross K/V by KV-head group, its
    drafter table) swaps out to the host and back into slot 0 (group 0)
    bit for bit: every leaf of the slot's rows equal under its key without
    the group."""
    cfg = get_config(arch)
    eng = _engine(arch, dm, **fkw)
    pool = eng.make_slot_pool(SLOTS)
    assert [pool.alloc(u) for u in (0, 1)] == [0, 1]
    assert pool.group_of(1) == dm[0] - 1
    _, st, _, _ = eng.prefill_one(_requests(cfg, Request)[0], pool, 1)
    pool.insert(st, 1)

    def rows(slot):
        out = pool.extract(slot)
        flat = {f"{i}|{k.split(':', 1)[-1]}": t for i, layer in enumerate(out["layers"])
                for k, t in layer.items()}
        for lane, t in out.items():
            if lane != "layers":
                for k, v in (t.items() if isinstance(t, dict) else [("", t)]):
                    flat[f"{lane}|{k.split(':', 1)[-1]}"] = v
        return flat
    before = rows(1)
    assert any(k.startswith("draft_tab") for k in before) == bool(fkw)
    host = pool.swap_out(1)
    pool.free(1)
    pool.free(0)
    assert pool.alloc(2) == 0
    pool.swap_in(host, 0)
    after = rows(0)
    assert before.keys() == after.keys()
    for k, t in before.items():
        assert torch.equal(t, after[k]), k


@pytest.mark.parametrize("arch,dm", [(XLSTM, (1, 2)), (XLSTM, (1, 4)), (JAMBA, (2, 2)),
                                     (JAMBA, (1, 4)), (WHISPER, (1, 2)), (WHISPER, (1, 4))])
def test_serving_layout_gathers_no_weight(arch, dm):
    """The serving placement (``rules.serving_spec``: Mamba's in_proj and the
    mLSTM's up as ``rules.Halves``, the mixers' other leaves by channel, the
    sLSTM whole on shard 0, the encoder and cross-attention by the
    attention and MLP rules) holds each weight where its shard computes
    with it: a prefill and a decode step fetch no weight, and their logits
    equal those of the reference's storage layout (``param_spec(
    fsdp_shard=False)``, re-laid out as the shards fetch). The state sits
    where the forms put it."""
    cfg = get_config(arch)
    params = model.init_params(cfg, 0, device="cpu")
    fkv = FreeKVConfig(**FKV)
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, T))).long()}
    if cfg.frontend:
        batch["frontend"] = torch.from_numpy((0.1 * rng.standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32))
    runs = []
    for layout in ("serving", "storage"):
        mesh = _cpu_mesh(dm)
        if layout == "serving":
            placed = rules.place_serving_params(cfg, params, mesh, fsdp=False)
        else:
            placed = [rules.map_leaves(lambda path, t, g=g: rules.Sharded.place(
                t, rules.param_spec(mesh, "/".join(map(str, path)), t.shape, fsdp_shard=False),
                mesh, g), params) for g in range(dm[0])]
        logits, st = model.prefill(cfg, fkv, placed, batch, max_len=MAX_LEN,
                                   state_dtype=torch.float32, mesh=mesh)
        pre = dict(mesh.moved.bytes)
        mesh.moved.reset()
        step, st = model.serve_step(cfg, fkv, placed, st, logits.argmax(-1)[:, None], mesh=mesh)
        runs.append((logits, step, pre, dict(mesh.moved.bytes), st))
    (l0, s0, p0, m0, st), (l1, s1, p1, m1, _) = runs
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    assert p0["weight_gather"] == m0["weight_gather"] == 0
    assert m1["weight_gather"] > 0
    m = dm[1]
    for i, (mixer, _) in enumerate(cfg.layers):
        n_sh = model.recurrent_shards(cfg, mixer, m) if mixer in model.RECURRENT else None
        shards = {int(k.split(":")[1].split("/")[0]) for k in st["layers"][i]}
        if n_sh is not None:
            assert shards == set(range(n_sh)), (mixer, shards)
            assert n_sh == (1 if mixer == "slstm" else m)
        if cfg.is_encoder_decoder:
            xk = {k for k in st["layers"][i] if k.endswith("/xk")}
            heads = cfg.n_kv_heads % m == 0 and cfg.n_heads % m == 0
            assert len(xk) == dm[0] * (m if heads else 1), xk


# ---------------------------------------------------------------------------
# against the reference's mesh runs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,dm", ENGINE_RUNS, ids=[_name(*r) for r in ENGINE_RUNS])
def test_engine_tokens_and_logits_equal_reference(ref, arch, dm):
    """Greedy tokens equal the reference's mesh engine's (the port's window
    path), and every prefill's and step's logits on the port's synchronous
    path within 2e-4 of the largest |logit| of the reference's."""
    cfg = get_config(arch)
    name = _name(arch, dm)
    eng = _engine(arch, dm, ref)
    comps = eng.generate(_requests(cfg, Request))
    for c in comps:
        np.testing.assert_array_equal(np.asarray(c.tokens), ref[f"tokens|{name}|{c.uid}"],
                                      err_msg=f"{name} request {c.uid}")
    assert eng.last_metrics.summary()["mesh"]["shape"] == {"data": dm[0], "model": dm[1]}
    eng = _engine(arch, dm, ref, sample_on_device=False)
    got = _record_logits(eng, lambda t: t.numpy())
    eng.generate(_requests(cfg, Request))
    n = sum(k.startswith(f"logits|{name}|") for k in ref)
    assert len(got) == n > 2 * NEW
    for i, g in enumerate(got):
        g, w = g[..., :cfg.vocab_size], ref[f"logits|{name}|{i}"][..., :cfg.vocab_size]
        assert np.abs(g - w).max() <= LOGIT_RTOL * np.abs(w).max(), (name, i)


@pytest.mark.parametrize("arch,dm", SPEC_RUNS, ids=[_name(*r) for r in SPEC_RUNS])
def test_spec_decode_under_a_mesh_equals_reference(ref, arch, dm):
    """``draft_len`` 4 under a compute mesh: the engine speculates, its tokens
    equal the reference's mesh engine's and the port's ``draft_len`` 0
    tokens on the same mesh; the drafter's tables live in the slots' data
    groups, on their shard 0."""
    cfg = get_config(arch)
    name = _name(arch, dm)
    eng = _engine(arch, dm, ref, draft_len=DRAFT_LEN)
    assert eng.spec_decode and eng.draft_len == DRAFT_LEN
    comps = eng.generate(_requests(cfg, Request))
    sd = eng.last_metrics.summary()["specdec"]
    assert sd["verify_steps"] > 0
    tabs = eng._pool.state["draft_tab"]
    assert sorted(tabs) == [f"{g}:0/draft_tab" for g in range(dm[0])]
    plain = _engine(arch, dm, ref).generate(_requests(cfg, Request))
    for c, p in zip(comps, plain):
        np.testing.assert_array_equal(np.asarray(c.tokens), ref[f"tokens|{name}|{c.uid}"],
                                      err_msg=f"{name} request {c.uid}")
        assert c.tokens == p.tokens, (name, c.uid)


if __name__ == "__main__":
    _reference_runs(sys.argv[1], int(sys.argv[2]))
