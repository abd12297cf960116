"""Model-parallel training of the recurrent mixers and the encoder-decoder
in the port (``forward_train(mesh=)`` over a ("data", "model") mesh of CPU
shards: Mamba split by d_inner, the mLSTM by head, the sLSTM whole on each
group's shard 0, whisper's encoder and cross-attention by KV-head group or
the input-dim split) held against the JAX package.

The oracle is one module-scoped pair of subprocesses that run the
reference's ``jax.value_and_grad(forward_train(mesh=))`` with four forced
XLA host devices on a ``jax.sharding.Mesh`` built here (as
``tests/test_torch_model_parallel.py``), B 4, T 64: xlstm-350m-smoke at
(1, 2), (2, 2) and (1, 4), jamba-1.5-large-398b-smoke at (1, 2) and (2, 2)
(its MoE routes each data block on its own there, so its loss moves off the
unsharded one) and whisper-tiny-smoke at (1, 2) and (1, 4) (its 4 / 2 heads
do not divide 4: the input-dim split). The port runs the same numpy-seeded
params (``params_from_jax``) and batches and is held at the loss within
2e-5 relative and every gradient leaf within 1e-4 relative L2 (1e-6
absolute where the reference's norm is below 1e-6).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model
from repro_torch.sharding import rules
from repro_torch.training.optimizer import tree_leaves, tree_map

torch.set_float32_matmul_precision("highest")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T = 4, 64
LOSS_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
XLSTM, JAMBA, WHISPER = ("xlstm-350m-smoke", "jamba-1.5-large-398b-smoke", "whisper-tiny-smoke")
CASES = [(XLSTM, (1, 2)), (XLSTM, (2, 2)), (XLSTM, (1, 4)), (JAMBA, (1, 2)), (JAMBA, (2, 2)),
         (WHISPER, (1, 2)), (WHISPER, (1, 4))]
# the reference's cases in three subprocesses, each arch's params made in one
PARTS = [[(XLSTM, (1, 2)), (XLSTM, (2, 2)), (XLSTM, (1, 4))],
         [(WHISPER, (1, 2)), (WHISPER, (1, 4))],
         [(JAMBA, (1, 2)), (JAMBA, (2, 2))]]
N_PARTS = len(PARTS)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: many small ops, several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(arch, dm):
    return f"{arch}|{dm[0]}x{dm[1]}"


def _batch(cfg, seed=0):
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
    """(loss, gradients in the unsharded layout, the mesh's moved bytes)."""
    if mesh is not None:
        params = rules.shard_params(cfg, params, mesh)
    leaves = [p for _, p in tree_leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = model.forward_train(cfg, params, tb, mesh=mesh)
    grads = iter(torch.autograd.grad(loss, leaves))
    g = tree_map(lambda _: next(grads), params)
    moved = dict(mesh.moved.bytes) if mesh is not None else None
    return (float(loss.detach()), rules.gather_params(g, "cpu") if mesh is not None else g,
            moved)


def _rel(a, b):
    return abs(a - b) / abs(b)


# ---------------------------------------------------------------------------
# the reference's mesh runs (subprocesses, four forced host devices)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", autouse=True)
def _ref_procs(tmp_path_factory):
    """The reference's runs, started with the module's first test in
    ``N_PARTS`` subprocesses at once, one core each, so the test that needs
    no oracle runs meanwhile."""
    out = tmp_path_factory.mktemp("mesh_recurrent")
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


def _reference_mesh_runs(out_path, part):
    """Part ``part`` of ``CASES`` through the reference (run as a script)."""
    from jax.sharding import Mesh
    assert len(jax.devices()) >= 4, jax.devices()
    assert sorted(c for p in PARTS for c in p) == sorted(CASES)
    flat, made = {}, {}
    for arch, dm in PARTS[part]:
        cfg = jget_config(arch)
        if arch not in made:                 # the tests read them from here
            made[arch] = jmodel.init_params(cfg, jax.random.PRNGKey(0))
            for path, leaf in jax.tree_util.tree_flatten_with_path(made[arch])[0]:
                name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
                flat[f"params|{arch}|{name}"] = np.asarray(leaf)
        params = made[arch]
        batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
        mesh = Mesh(np.asarray(jax.devices()[:dm[0] * dm[1]]).reshape(dm), ("data", "model"))
        with mesh:
            (loss, _), grads = jax.jit(jax.value_and_grad(
                lambda p, b: jmodel.forward_train(cfg, p, b, mesh=mesh), has_aux=True))(
                    params, batch)
        key = _key(arch, dm)
        flat[key + "|loss"] = np.asarray(loss)
        for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            name = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
            flat[f"{key}|grad/{name}"] = np.asarray(g)
        if arch == JAMBA and dm[0] > 1:
            flat[key + "|plain_loss"] = np.asarray(jax.jit(
                lambda p, b: jmodel.forward_train(cfg, p, b)[0])(params, batch))
    np.savez(out_path, **flat)


# ---------------------------------------------------------------------------
# against the reference's mesh runs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,dm", CASES, ids=[_key(*c) for c in CASES])
def test_mesh_train_matches_reference_mesh(ref, arch, dm):
    cfg = get_config(arch)
    key = _key(arch, dm)
    pre = f"params|{arch}|"
    jp = _unflatten({k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)})
    jp.setdefault("prelude", ())
    params = model.params_from_jax(cfg, jp, device="cpu")
    batch = _batch(cfg)
    loss, grads, moved = _port_loss_grads(cfg, params, batch, _cpu_mesh(dm))
    want = float(ref[key + "|loss"])
    assert _rel(loss, want) <= LOSS_RTOL, (key, loss, want)
    ref_grads = _unflatten({k.split("|grad/")[1]: v for k, v in ref.items()
                            if k.startswith(key + "|grad/")})
    ref_grads.setdefault("prelude", ())
    ref_grads = model.params_from_jax(cfg, ref_grads, device="cpu")
    flat_want, flat_got = tree_leaves(ref_grads), tree_leaves(grads)
    assert [p for p, _ in flat_want] == [p for p, _ in flat_got]
    for (path, w), (_, g) in zip(flat_want, flat_got):
        wn, err = float(w.norm()), float((g - w).norm())
        if wn < 1e-6:
            assert err <= GRAD_ATOL, (key, path, err)
        else:
            assert err / wn <= GRAD_RTOL, (key, path, err / wn)
    # the recurrent mixers and the encoder run on the model shards: their
    # all-reduces move bytes
    assert moved["partial_sum"] > 0
    if arch == JAMBA and dm[0] > 1:
        # each data block routes on its own: the loss moves off the
        # unsharded one by the reference's amount
        port_plain, _, _ = _port_loss_grads(cfg, params, batch, None)
        plain = float(ref[key + "|plain_loss"])
        assert _rel(want, plain) > 10 * LOSS_RTOL, (key, want, plain)
        assert abs((loss - port_plain) - (want - plain)) <= LOSS_RTOL * abs(want)


# ---------------------------------------------------------------------------
# the layouts' moves
# ---------------------------------------------------------------------------
def test_mamba_in_proj_relayout_is_a_counted_move():
    """Training stores Mamba's in_proj (d, 2 d_inner) by the reference's
    ``param_spec`` (its columns over "model": at m = 2 shard 0 holds the
    ``xm`` half, shard 1 the ``z`` half), so the d_inner split fetches half
    of each shard's block from the other shard, counted as weight_gather;
    the serving placement (``rules.Halves``) holds block j of both halves on
    shard j, and the same fetches move nothing."""
    from repro_torch.sharding.transfer import MeshRow
    cfg = get_config(JAMBA)
    w = model.init_params(cfg, 0, device="cpu")["layers"][0]["mixer"]["in_proj"]
    d, di2 = w.shape
    n = di2 // 4
    mesh = _cpu_mesh((1, 2))
    spec = rules.param_spec(mesh, "layers/0/mixer/in_proj", w.shape)
    assert spec[1] == ("model",)
    stored = rules.Sharded.place(w, spec, mesh)
    halves = rules.Halves(w, mesh, 0)
    row = MeshRow(mesh, 0)
    for leaf, want_bytes in ((stored, 2 * d * n * 4), (halves, 0)):
        mesh.moved.reset()
        for j in range(2):
            for lo in (j * n, 2 * n + j * n):
                got = row.span(leaf, j, 1, lo, lo + n)
                assert torch.equal(got, w[:, lo:lo + n])
        assert mesh.moved.bytes["weight_gather"] == want_bytes
    assert torch.equal(halves.full("cpu"), w)


if __name__ == "__main__":
    _reference_mesh_runs(sys.argv[1], int(sys.argv[2]))
