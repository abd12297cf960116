"""Model-parallel training in the port (``forward_train(mesh=)`` over a
("data", "model") mesh of CPU shards, ``sharding/rules``' parameter rules
and placement, the transfer counter, AdamW and checkpoints on pieces, the
launcher's ``--model-parallel``) held against the JAX package.

The oracle is a module-scoped set of subprocesses, one an arch group,
started with the module's first test (so the tests that need no oracle
run meanwhile; they come first in the file), that run the reference's
``jax.value_and_grad(forward_train(mesh=))`` with four forced XLA host
devices on a ``jax.sharding.Mesh`` built here from them (not
``make_host_mesh``, whose ``jax.make_mesh`` axes make the reference's
``_bshard`` raise under the installed JAX), T 64: B 2 at (1, 2) and
(2, 1), B 4 at (2, 2) and (1, 4), and deepseek at (2, 2) with B 3, whose
MoE data blocks cut through rows. They write every loss and gradient, the
reference's params and its unsharded MoE losses to ``.npz`` files. The
port runs the same numpy-seeded params (``params_from_jax``) and tokens
on ``("cpu",) * n`` meshes and is held at
``test_torch_train_archs``' tolerances: the loss within 2e-5 relative,
every gradient leaf within 1e-4 relative L2 (1e-6 absolute where the
reference's norm is below 1e-6). A MoE with a data axis above 1 routes each
data block on its own, so its loss moves off the unsharded one; the
port's moves by the reference's amount.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED
from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import model
from repro_torch.sharding import rules
from repro_torch.training import checkpoint, optimizer
from repro_torch.training.optimizer import AdamWConfig, tree_leaves, tree_map
from repro_torch.training.train_step import init_train, make_train_step

torch.set_float32_matmul_precision("highest")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 64
LOSS_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
ARCHS = ["deepseek-moe-16b-smoke", "llama4-scout-17b-a16e-smoke", "smollm-360m-smoke",
         "gemma2-2b-smoke"]
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
# (arch, (data, model), B): every arch at every mesh, and the trap where
# B % n_data != 0 but B * T % n_data == 0
CASES = [(a, dm, 2 if dm[0] * dm[1] == 2 else 4) for a in ARCHS for dm in MESHES] + [
    ("deepseek-moe-16b-smoke", (2, 2), 3)]
ALL_ARCHS = ["smollm-360m-smoke", "gemma2-2b-smoke", "deepseek-moe-16b-smoke",
             "llama4-scout-17b-a16e-smoke", "internvl2-26b-smoke", "xlstm-350m-smoke",
             "whisper-tiny-smoke", "jamba-1.5-large-398b-smoke"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: many small ops, several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(arch, dm, B):
    return f"{arch}|{dm[0]}x{dm[1]}|B{B}"


def _batch(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
    if cfg.frontend:
        batch["frontend"] = (0.1 * rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    return batch


def _cpu_mesh(dm):
    return make_host_mesh(dm[1], ("cpu",) * (dm[0] * dm[1]))


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


def _port_loss_grads(cfg, params, batch, mesh):
    """(loss, metrics, gradients in the unsharded layout) of the port."""
    if mesh is not None:
        params = rules.shard_params(cfg, params, mesh)
    leaves = [p for _, p in tree_leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, m = model.forward_train(cfg, params, tb, mesh=mesh)
    grads = iter(torch.autograd.grad(loss, leaves))
    g = tree_map(lambda _: next(grads), params)
    return loss.detach(), m, rules.gather_params(g, "cpu") if mesh is not None else g


def _assert_grads_close(cfg, got, want, what):
    flat_want = tree_leaves(want)
    assert [p for p, _ in flat_want] == [p for p, _ in tree_leaves(got)]
    for (path, w), (_, g) in zip(flat_want, tree_leaves(got)):
        wn, err = float(w.norm()), float((g - w).norm())
        if wn < 1e-6:
            assert err <= GRAD_ATOL, (what, path, err)
        else:
            assert err / wn <= GRAD_RTOL, (what, path, err / wn)


def _rel(a, b):
    return abs(a - b) / abs(b)


# ---------------------------------------------------------------------------
# the reference's mesh runs (subprocesses, four forced host devices)
# ---------------------------------------------------------------------------
# the reference's cases in subprocesses by arch, each arch's params made in one
PARTS = [[c for c in CASES if c[0] == a] for a in ("deepseek-moe-16b-smoke",
                                                  "llama4-scout-17b-a16e-smoke")]
PARTS.append([c for c in CASES if c not in PARTS[0] + PARTS[1]])
N_PARTS = len(PARTS)


@pytest.fixture(scope="module", autouse=True)
def _ref_procs(tmp_path_factory):
    """The reference's runs, started with the module's first test in
    ``N_PARTS`` subprocesses at once."""
    out = tmp_path_factory.mktemp("mesh_train")
    env = dict(os.environ)
    env["XLA_FLAGS"] = env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
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
def jax_mesh_runs(_ref_procs):
    out, procs = _ref_procs
    for p in procs:
        assert p.wait(timeout=600) == 0, p.args
    runs = {}
    for i in range(N_PARTS):
        with np.load(out / f"part{i}.npz") as data:
            runs.update({k: data[k] for k in data.files})
    return runs


def _reference_mesh_runs(out_path, part):
    """Part ``part`` of ``CASES`` through the reference (run as a script),
    with each arch's params and, where a MoE's data blocks move the loss,
    its unsharded loss."""
    from jax.sharding import Mesh
    assert len(jax.devices()) >= 4, jax.devices()
    assert sorted(c for p in PARTS for c in p) == sorted(CASES)
    flat, made = {}, {}
    for arch, dm, B in PARTS[part]:
        cfg = jget_config(arch)
        if arch not in made:
            made[arch] = jmodel.init_params(cfg, jax.random.PRNGKey(0))
            for path, leaf in jax.tree_util.tree_flatten_with_path(made[arch])[0]:
                name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
                flat[f"params|{arch}|{name}"] = np.asarray(leaf)
        params = made[arch]
        batch = {k: jnp.asarray(v) for k, v in _batch(cfg, B).items()}
        mesh = Mesh(np.asarray(jax.devices()[:dm[0] * dm[1]]).reshape(dm), ("data", "model"))
        with mesh:
            (loss, _), grads = jax.jit(jax.value_and_grad(
                lambda p, b: jmodel.forward_train(cfg, p, b, mesh=mesh), has_aux=True))(
                    params, batch)
        key = _key(arch, dm, B)
        flat[key + "|loss"] = np.asarray(loss)
        for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            name = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
            flat[f"{key}|grad/{name}"] = np.asarray(g)
        if cfg.n_experts and dm[0] > 1 and f"plain|{arch}|B{B}" not in flat:
            flat[f"plain|{arch}|B{B}"] = np.asarray(jax.jit(
                lambda p, b: jmodel.forward_train(cfg, p, b)[0])(params, batch))
    np.savez(out_path, **flat)


# ---------------------------------------------------------------------------
# 1 x 1 is no mesh; the recurrent mixers and the encoder-decoder under a mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_one_by_one_mesh_is_no_mesh_bit_for_bit(arch):
    cfg = get_config(arch)
    params = model.init_params(cfg, seed=0, device="cpu")
    batch = _batch(cfg, 2)
    loss, m, grads = _port_loss_grads(cfg, params, batch, None)
    loss1, m1, grads1 = _port_loss_grads(cfg, params, batch, _cpu_mesh((1, 1)))
    assert torch.equal(loss, loss1)
    for k in m:
        assert torch.equal(m[k], m1[k]), k
    for (path, a), (_, b) in zip(tree_leaves(grads), tree_leaves(grads1)):
        assert torch.equal(a, b), (arch, path)


@pytest.mark.parametrize("arch,dm,B", [("deepseek-moe-16b-smoke", (1, 3), 2),
                                       ("smollm-360m-smoke", (1, 3), 2),
                                       ("deepseek-moe-16b-smoke", (3, 1), 4),
                                       ("deepseek-moe-16b-smoke", (2, 3), 2),
                                       ("smollm-360m-smoke", (2, 3), 2)])
def test_meshes_that_divide_nothing_run_whole(arch, dm, B):
    """At m = 3 no head count, width, vocab or expert count of the smoke
    configs divides the model axis, so every sublayer runs whole on shard 0
    (the MoE in the reference's replicated branch, one call over the batch);
    at (3, 1) with B 4 neither B nor B * T divides the data axis, so the
    batch stays whole on data group 0. At (2, 3) the dense arch splits its
    rows over the two data groups, while the MoE arch keeps the batch whole
    on group 0, since its replicated branch routes every row in one call.
    All equal no mesh to float rounding."""
    cfg = get_config(arch)
    params = model.init_params(cfg, seed=0, device="cpu")
    batch = _batch(cfg, B)
    loss, _, grads = _port_loss_grads(cfg, params, batch, None)
    loss_m, _, grads_m = _port_loss_grads(cfg, params, batch, _cpu_mesh(dm))
    assert _rel(float(loss_m), float(loss)) <= LOSS_RTOL
    _assert_grads_close(cfg, grads_m, grads, (arch, dm))


@pytest.mark.parametrize("arch", ["xlstm-350m-smoke", "jamba-1.5-large-398b-smoke",
                                  "whisper-tiny-smoke"])
def test_recurrent_and_encoder_decoder_raise_under_a_mesh(arch):
    """The recurrent mixers and the encoder-decoder train under a mesh
    above 1 x 1: one train step at (1, 2) gives the 1 x 1 step's loss to
    float rounding (``tests/test_torch_mesh_recurrent.py`` holds them
    against the reference's mesh runs)."""
    cfg = get_config(arch)
    opt_cfg = AdamWConfig()
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2).items()}
    losses = {}
    for dm in ((1, 1), (1, 2)):
        mesh = _cpu_mesh(dm)
        params, opt = init_train(cfg, opt_cfg, seed=0, device="cpu", mesh=mesh)
        losses[dm] = float(make_train_step(cfg, opt_cfg, mesh=mesh)(params, opt, tb)[2]["loss"])
        assert mesh.moved.bytes["partial_sum"] > 0 or dm == (1, 1)
    assert _rel(losses[(1, 2)], losses[(1, 1)]) <= LOSS_RTOL, losses


# ---------------------------------------------------------------------------
# the parameter rules and the placement
# ---------------------------------------------------------------------------
def _abstract_mesh(shape, names):
    from jax.sharding import AbstractMesh
    try:
        return AbstractMesh(shape, names)
    except TypeError:   # jax <= 0.4.x: one shape tuple of (name, size) pairs
        return AbstractMesh(tuple(zip(names, shape)))


def _spec_tuple(spec, ndim):
    """A reference PartitionSpec as one tuple of axis names a dim."""
    out = [() if e is None else (e,) if isinstance(e, str) else tuple(e) for e in spec]
    return tuple(out + [()] * (ndim - len(out)))


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_spec_equals_reference(arch, multi_pod):
    """Every leaf of the reference's own params (stacked pattern leaves
    included) at 16 x 16 and 2 x 16 x 16, as ``tests/test_sharding.py``
    walks them."""
    from repro.sharding import rules as jrules
    mesh = make_production_mesh(multi_pod=multi_pod)
    jmesh = _abstract_mesh(mesh.dims, mesh.axis_names)
    cfg = jget_config(arch)
    shapes = jax.eval_shape(lambda: jmodel.init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16))
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        name = jrules._path_str(path)
        want = _spec_tuple(jrules.param_spec(jmesh, name, leaf), leaf.ndim)
        assert rules.param_spec(mesh, name, leaf.shape) == want, (name, leaf.shape)
        n += 1
    assert n > 10


def test_batch_shardings_equal_reference():
    from repro.sharding import rules as jrules
    for dims, names in (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))):
        mesh = make_production_mesh(multi_pod=len(dims) == 3)
        jmesh = _abstract_mesh(dims, names)
        batch = {"tokens": (64, 4096), "odd": (3, 8), "frontend": (32, 16, 256)}
        got = rules.batch_shardings(None, mesh, batch)
        want = jrules.batch_shardings(None, jmesh, {k: jax.ShapeDtypeStruct(s, jnp.int32)
                                                    for k, s in batch.items()})
        for k, s in batch.items():
            assert got[k] == _spec_tuple(want[k].spec, len(s)), k


def test_placement_holds_every_element_once():
    cfg = get_config("deepseek-moe-16b-smoke")
    mesh = _cpu_mesh((2, 2))
    params = model.init_params(cfg, seed=0, device="cpu")
    sp = rules.shard_params(cfg, params, mesh)
    for (path, leaf), (_, s) in zip(tree_leaves(params), _sharded_leaves(sp)):
        assert sum(p.numel() for p in s.pieces) == leaf.numel(), path
        assert len({s.owner(k) for k in range(len(s.pieces))}) == len(s.pieces), path
        assert torch.equal(s.full("cpu"), leaf), path
    # the rule as the reference applies it to a prelude leaf, on every layer
    moe_layer = sp["layers"][1]
    assert moe_layer["norm1"]["w"].spec == ((),)
    assert moe_layer["ffn"]["wg"].spec == (("model",), ("data",), ())
    assert len(moe_layer["ffn"]["wg"].pieces) == 4
    assert sp["embed"]["tok"].spec == (("model",), ("data",))
    back = rules.gather_params(sp, "cpu")
    for (path, a), (_, b) in zip(tree_leaves(params), tree_leaves(back)):
        assert torch.equal(a, b), path


def _sharded_leaves(tree, path=()):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _sharded_leaves(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _sharded_leaves(v, path + (i,))]
    return [(path, tree)]


def test_make_host_mesh(monkeypatch):
    mesh = make_host_mesh(2, ("cpu",) * 4)
    assert mesh.axis_names == ("data", "model") and mesh.dims == (2, 2)
    assert mesh.primary == torch.device("cpu") and len(mesh.devices[1]) == 2
    assert make_host_mesh(4, ("cpu",) * 4).dims == (1, 4)
    with pytest.raises(ValueError, match="needs 3 devices"):
        make_host_mesh(3, ("cpu",) * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs 2 devices"):
        make_host_mesh(2)
    with pytest.raises(RuntimeError, match="needs 1 devices"):
        make_host_mesh()
    assert make_production_mesh().devices is None
    assert make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}


# ---------------------------------------------------------------------------
# the transfer counter, AdamW on pieces, checkpoints across meshes
# ---------------------------------------------------------------------------
def test_transfer_bytes_of_a_dense_layer_equal_their_formula():
    """smollm-360m-smoke (one attention + dense layer, 4/2 heads) at (1, 2),
    forward and backward without remat: shard 1's column blocks of wq/wk/wv
    and up/gate are its own pieces, while its row blocks of wo and down are
    re-laid out from both pieces (half of each matrix crosses); each
    sublayer broadcasts its (B, T, d) input and reduces one partial; a
    backward moves each forward move's bytes back."""
    cfg = get_config("smollm-360m-smoke")
    mesh = _cpu_mesh((1, 2))
    B, d, F, f = 4, cfg.d_model, cfg.n_heads * cfg.d_head, cfg.d_ff
    sp = rules.shard_params(cfg, model.init_params(cfg, seed=0, device="cpu"), mesh)
    leaves = [p for _, p in tree_leaves(sp)]
    for p in leaves:
        p.requires_grad_(True)
    tb = {"tokens": torch.from_numpy(_batch(cfg, B)["tokens"])}
    loss, _ = model.forward_train(cfg, sp, tb, mesh=mesh, remat=False)
    fwd = dict(mesh.moved.bytes)
    torch.autograd.grad(loss, leaves)
    both = mesh.moved.bytes
    m = 2
    assert fwd["weight_gather"] == 4 * (m - 1) * (F * d + f * d) // m
    assert fwd["partial_sum"] == 4 * 2 * 2 * (m - 1) * B * T * d
    assert fwd["data"] == fwd["expert_sum"] == 0
    assert both["weight_gather"] == 2 * fwd["weight_gather"]
    assert both["partial_sum"] == 2 * fwd["partial_sum"]


def test_adamw_on_pieces_equals_unsharded_update():
    """One AdamW step on (2, 2) pieces equals the unsharded step bit for bit
    (no clipping: the global norm's summation order is then irrelevant),
    and the decay rule reads the logical leaf."""
    cfg = get_config("deepseek-moe-16b-smoke")
    opt_cfg = AdamWConfig(grad_clip=1e9)
    params, opt = init_train(cfg, opt_cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen), params)
    mesh = _cpu_mesh((2, 2))
    sp = rules.shard_params(cfg, params, mesh)
    sopt = optimizer.adamw_init(sp, opt_cfg)
    sg = rules.shard_params(cfg, grads, mesh)
    optimizer.adamw_update(sg, sopt, sp, opt_cfg, cfg)
    optimizer.adamw_update(grads, opt, params, opt_cfg, cfg)
    for tree, stree in ((params, sp), (opt["m"], sopt["m"]), (opt["v"], sopt["v"])):
        for (path, a), (_, b) in zip(tree_leaves(tree),
                                     tree_leaves(rules.gather_params(stree, "cpu"))):
            assert torch.equal(a, b), path
    norm = optimizer.global_norm(sg)
    assert abs(float(norm) - float(optimizer.global_norm(grads))) <= 1e-5 * float(norm)


def test_checkpoint_moves_between_meshes_bit_for_bit(tmp_path):
    cfg = get_config("deepseek-moe-16b-smoke")
    opt_cfg = AdamWConfig()
    m12, m11 = _cpu_mesh((1, 2)), _cpu_mesh((1, 1))
    params, opt = init_train(cfg, opt_cfg, seed=0, device="cpu", mesh=m12)
    step = make_train_step(cfg, opt_cfg, mesh=m12)
    tb = {"tokens": torch.from_numpy(_batch(cfg, 2)["tokens"])}
    params, opt, _ = step(params, opt, tb)
    ck = str(tmp_path / "s12.npz")
    checkpoint.save(ck, cfg, {"params": params, "opt": opt})
    state12 = rules.gather_params({"params": params, "opt": opt}, "cpu")
    # (1, 2) -> (1, 1) and -> no mesh
    like11 = dict(zip(("params", "opt"), init_train(cfg, opt_cfg, seed=1, device="cpu",
                                                    mesh=m11)))
    back11 = checkpoint.restore(ck, cfg, like11)
    plain = checkpoint.restore(ck, cfg, dict(zip(("params", "opt"), init_train(
        cfg, opt_cfg, seed=1, device="cpu"))))
    for tree in (rules.gather_params(back11, "cpu"), plain):
        for (path, a), (_, b) in zip(tree_leaves(state12), tree_leaves(tree)):
            assert a.dtype == b.dtype and torch.equal(a, b), path
    assert isinstance(back11["params"]["embed"]["tok"], rules.Sharded)
    # (1, 1) -> (1, 2): the pieces come back as they were
    ck11 = str(tmp_path / "s11.npz")
    checkpoint.save(ck11, cfg, back11)
    like12 = dict(zip(("params", "opt"), init_train(cfg, opt_cfg, seed=2, device="cpu",
                                                    mesh=m12)))
    back12 = checkpoint.restore(ck11, cfg, like12)
    for (path, a), (_, b) in zip(tree_leaves({"params": params, "opt": opt}),
                                 tree_leaves(back12)):
        assert torch.equal(a, b), path


def test_mesh_train_steps_equal_unsharded_steps():
    """Five steps of smollm-360m-smoke on one batch at (1, 2) and (2, 2)
    against no mesh: dense, so the losses agree to float rounding."""
    cfg = get_config("smollm-360m-smoke")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=5)
    batches = [{"tokens": torch.from_numpy(_batch(cfg, 4)["tokens"])}] * 5
    runs = {}
    for dm in (None, (1, 2), (2, 2)):
        mesh = None if dm is None else _cpu_mesh(dm)
        params, opt = init_train(cfg, opt_cfg, seed=0, device="cpu", mesh=mesh)
        step = make_train_step(cfg, opt_cfg, mesh=mesh)
        runs[dm] = [float(step(params, opt, b)[2]["loss"]) for b in batches]
    for dm in ((1, 2), (2, 2)):
        assert max(_rel(a, b) for a, b in zip(runs[dm], runs[None])) <= 1e-5, runs
    assert runs[None][-1] < runs[None][0]


# ---------------------------------------------------------------------------
# against the reference's mesh runs (last: the tests above run while they
# compute)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,dm,B", CASES, ids=[_key(*c) for c in CASES])
def test_mesh_train_matches_reference_mesh(arch, dm, B, jax_mesh_runs):
    cfg = get_config(arch)
    key = _key(arch, dm, B)
    pre = f"params|{arch}|"
    jp = _unflatten({k[len(pre):]: v for k, v in jax_mesh_runs.items() if k.startswith(pre)})
    jp.setdefault("prelude", ())
    batch = _batch(cfg, B)
    loss, m, grads = _port_loss_grads(cfg, model.params_from_jax(cfg, jp, device="cpu"),
                                      batch, _cpu_mesh(dm))
    want_loss = float(jax_mesh_runs[key + "|loss"])
    assert _rel(float(loss), want_loss) <= LOSS_RTOL, (key, float(loss), want_loss)
    assert int(m["tokens"]) == B * (T - 1)
    ref_grads = _unflatten({k.split("|grad/")[1]: v for k, v in jax_mesh_runs.items()
                            if k.startswith(key + "|grad/")})
    ref_grads.setdefault("prelude", ())
    _assert_grads_close(cfg, grads, model.params_from_jax(cfg, ref_grads, device="cpu"), key)
    if cfg.n_experts and dm[0] > 1:
        # the data blocks' own capacity and aux move the loss off the
        # unsharded one, in the reference and in the port alike
        ref_plain = float(jax_mesh_runs[f"plain|{arch}|B{B}"])
        port_plain, _, _ = _port_loss_grads(cfg, model.params_from_jax(cfg, jp, device="cpu"),
                                            batch, None)
        assert _rel(want_loss, ref_plain) > 10 * LOSS_RTOL, (key, want_loss, ref_plain)
        moved = float(loss) - float(port_plain)
        assert abs(moved - (want_loss - ref_plain)) <= LOSS_RTOL * abs(want_loss), (
            key, moved, want_loss - ref_plain)


if __name__ == "__main__":
    _reference_mesh_runs(sys.argv[1], int(sys.argv[2]))
