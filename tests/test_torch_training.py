"""The port's training path (``repro_torch/training``, ``data/synthetic``,
``launch/train``) held against the JAX package on the CPU:

* ``lm_batches`` and ``DataConfig`` bit for bit (seeds 0, 7 and 8);
* ``lr_at`` over steps 0..120 (warmup 10), ``global_norm`` and
  ``adamw_update`` on the same numpy params and gradients, for both
  ``state_dtype`` values, clipped and not, within 1e-6 relative;
* the weight-decay rule, which the reference counts on its stacked leaves:
  after a zero-gradient step exactly the reference's leaves move (the
  pattern's and the encoder's norms and biases do; the prelude's, the
  embedding's and the final norms' do not);
* ``attention_chunked``'s gradients against ``jax.grad`` of the
  reference's at T 2304 (past the dense path), windowed and softcapped;
* 5 ``make_train_step`` steps on smollm-360m-smoke and
  deepseek-moe-16b-smoke: each loss within 1e-4 relative, each param leaf
  within 1e-3 relative L2 afterwards;
* the reference's loss-decreases test through the port's train CLI;
* checkpoints: the port's round trip exact, a reference-written file
  restoring into the port as ``params_from_jax``, a port-written one
  through the reference's ``restore``, and a run the reference started,
  resumed in the port, matching the reference's own continuation."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import synthetic as jsynthetic
from repro.models import attention as jattn
from repro.training import checkpoint as jcheckpoint
from repro.training import optimizer as joptimizer
from repro.training import train_step as jtrain_step
from repro_torch.configs import get_config
from repro_torch.data import synthetic
from repro_torch.launch import train as train_cli
from repro_torch.models import attention as attn
from repro_torch.models import model
from repro_torch.training import checkpoint, optimizer
from repro_torch.training.optimizer import AdamWConfig, tree_leaves
from repro_torch.training.train_step import init_train, make_train_step

torch.set_float32_matmul_precision("highest")
OPT_RTOL = 1e-6
# bfloat16 moments under clipping: the clip factor 1 / grad_norm differs by
# an ulp between the packages (float32 sums over the leaves in another
# order), which flips the bfloat16 rounding of a few moment entries to the
# neighbouring bfloat16 value; in 3 steps the moments' leaves land ~1.1e-5
# apart (relative L2) and the params they update ~1.3e-6
BF16_CLIPPED_RTOL = {"params": 1e-5, "moments": 1e-4}
STEP_LOSS_RTOL, STEP_PARAM_RTOL = 1e-4, 1e-3
B, T = 2, 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the smoke-width steps are many small ops,
    and with several test workers sharing the cores the default thread pool
    spends its time spinning. The thread count does not change what a test
    checks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(cfg, jparams, jopt, opt_cfg):
    """The reference's (params, opt_state) in the port's form on the CPU."""
    params = model.params_from_jax(cfg, _np_tree(jparams), device="cpu")
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[opt_cfg.state_dtype]
    cast = lambda t: t.to(dt)                                   # noqa: E731
    return params, {"m": optimizer.tree_map(cast, model.params_from_jax(
                        cfg, _np_tree(jopt["m"]), device="cpu")),
                    "v": optimizer.tree_map(cast, model.params_from_jax(
                        cfg, _np_tree(jopt["v"]), device="cpu")),
                    "step": torch.tensor(int(jopt["step"]), dtype=torch.int32)}


def _rel_l2(got, want):
    got, want = got.double(), want.double()
    wn = float(want.norm())
    return float((got - want).norm()) / wn if wn else float(got.norm())


def _max_leaf_rel(cfg, params, jparams):
    want = dict(tree_leaves(model.params_from_jax(cfg, _np_tree(jparams), device="cpu")))
    return max(_rel_l2(g, want[path]) for path, g in tree_leaves(params))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7, 8])
def test_lm_batches_equal_reference(seed):
    for vocab, seq, batch in ((100, 32, 2), (49152, 300, 3)):
        ours = synthetic.lm_batches(vocab, seq, batch, seed=seed)
        ref = jsynthetic.lm_batches(vocab, seq, batch, seed=seed)
        for _ in range(3):
            a, b = next(ours), next(ref)
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    cfg = synthetic.DataConfig(100, 32, 2, seed)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jsynthetic.DataConfig(100, 32, 2, seed))
    np.testing.assert_array_equal(synthetic.SyntheticLM(cfg).motifs,
                                  jsynthetic.SyntheticLM(jsynthetic.DataConfig(
                                      100, 32, 2, seed)).motifs)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def test_lr_at_matches_reference():
    """Within 1e-6 relative, or a millionth of the peak rate where the
    cosine nears its floor of 0 (there ``1 + cos`` cancels, and float32
    ``cos`` may land an ulp apart between the two libraries)."""
    for kw in (dict(lr=1e-3, warmup_steps=10, total_steps=100),
               dict(lr=3e-4, warmup_steps=10, total_steps=120, min_lr_ratio=0.0)):
        ours, ref = AdamWConfig(**kw), joptimizer.AdamWConfig(**kw)
        got = np.array([float(optimizer.lr_at(ours, s)) for s in range(121)], np.float32)
        want = np.array([float(joptimizer.lr_at(ref, s)) for s in range(121)], np.float32)
        np.testing.assert_allclose(got, want, rtol=OPT_RTOL, atol=OPT_RTOL * ours.lr)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1e-4, 1.0], ids=["unclipped", "clipped"])
def test_adamw_update_matches_reference(state_dtype, grad_scale):
    arch = "deepseek-moe-16b-smoke"                    # prelude, pattern, MoE leaves
    jcfg, cfg = jget_config(arch), get_config(arch)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, state_dtype=state_dtype)
    jopt_cfg, opt_cfg = joptimizer.AdamWConfig(**kw), AdamWConfig(**kw)
    from repro.models import model as jmodel
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    jopt = joptimizer.adamw_init(jp, jopt_cfg)
    params, opt = _port_state(cfg, jp, jopt, opt_cfg)
    rng = np.random.default_rng(1)
    for _ in range(3):
        jg = jax.tree.map(lambda p: jnp.asarray(
            grad_scale * rng.standard_normal(p.shape).astype(np.float32)), jp)
        g = model.params_from_jax(cfg, _np_tree(jg), device="cpu")
        assert _rel_l2(optimizer.global_norm(g).reshape(1),
                       torch.tensor([float(joptimizer.global_norm(jg))])) <= OPT_RTOL
        jp, jopt, jm = joptimizer.adamw_update(jg, jopt, jp, jopt_cfg)
        params, opt, m = optimizer.adamw_update(g, opt, params, opt_cfg, cfg)
        assert int(opt["step"]) == int(jopt["step"])
        for key in ("lr", "grad_norm"):
            assert abs(float(m[key]) - float(jm[key])) <= OPT_RTOL * abs(float(jm[key]))
    assert (float(jm["grad_norm"]) > 1.0) == (grad_scale == 1.0)
    flips = (state_dtype, grad_scale) == ("bfloat16", 1.0)
    want_p, want_o = _port_state(cfg, jp, jopt, opt_cfg)
    for kind, got_tree, want_tree in (("params", params, want_p),
                                      ("moments", opt["m"], want_o["m"]),
                                      ("moments", opt["v"], want_o["v"])):
        tol = BF16_CLIPPED_RTOL[kind] if flips else OPT_RTOL
        for (path, got), (_, want) in zip(tree_leaves(got_tree), tree_leaves(want_tree)):
            assert got.dtype == want.dtype, path
            assert _rel_l2(got, want) <= tol, (kind, path, _rel_l2(got, want))


@pytest.mark.parametrize("arch", ["smollm-360m-smoke", "deepseek-moe-16b-smoke",
                                  "whisper-tiny-smoke"])
def test_weight_decay_moves_the_reference_leaves(arch):
    """A zero-gradient step moves a leaf by weight decay alone: exactly the
    leaves the reference decays (rank >= 2 on its stacked tree) move. Every
    leaf is offset by 0.5 first, so that the zero-initialised biases would
    show a decay too."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    jopt_cfg, opt_cfg = joptimizer.AdamWConfig(**kw), AdamWConfig(**kw)
    from repro.models import model as jmodel
    jp = jax.tree.map(lambda p: p + 0.5, jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    jopt = joptimizer.adamw_init(jp, jopt_cfg)
    params, opt = _port_state(cfg, jp, jopt, opt_cfg)
    before = model.params_from_jax(cfg, _np_tree(jp), device="cpu")
    jp2, _, _ = joptimizer.adamw_update(jax.tree.map(jnp.zeros_like, jp), jopt, jp, jopt_cfg)
    zeros = optimizer.tree_map(torch.zeros_like, params)
    params, _, _ = optimizer.adamw_update(zeros, opt, params, opt_cfg, cfg)
    after_ref = model.params_from_jax(cfg, _np_tree(jp2), device="cpu")
    moved = {}
    for (path, b), (_, a), (_, r) in zip(tree_leaves(before), tree_leaves(params),
                                         tree_leaves(after_ref)):
        moved[path] = bool((a != b).any())
        assert moved[path] == bool((r != b).any()), path
        assert moved[path] == optimizer.decays(cfg, path, b), path
        assert _rel_l2(a, r) <= OPT_RTOL, path
    n_pre = len(cfg.prelude)
    assert moved[("layers", n_pre, "norm1", "w")]                 # a pattern layer's norm
    assert not moved[("final_norm", "w")]
    assert moved[("embed", "tok")]
    if n_pre:
        assert not moved[("layers", 0, "norm1", "w")]            # the prelude's norm
        assert moved[("layers", 0, "mixer", "wq")]
    if cfg.is_encoder_decoder:
        assert moved[("encoder", "layers", 0, "norm1", "w")]
        assert moved[("encoder", "layers", 0, "norm1", "b")]          # a 1-D bias
        assert moved[("layers", 0, "norm1", "b")]
        assert not moved[("encoder", "final_norm", "w")]
        assert not moved[("final_norm", "b")]


# ---------------------------------------------------------------------------
# attention_chunked's backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window,softcap", [(None, None), (700, 30.0)])
def test_attention_chunked_gradients_match_reference(window, softcap):
    Tc = 2304                                  # 2304^2 > 2048^2: the chunked path
    base = get_config("gemma2-2b-smoke")
    cfg = dataclasses.replace(base, n_heads=4, n_kv_heads=2, d_head=16,
                              attn_logit_softcap=softcap)
    jcfg = dataclasses.replace(jget_config("gemma2-2b-smoke"), n_heads=4, n_kv_heads=2,
                               d_head=16, attn_logit_softcap=softcap)
    rng = np.random.default_rng(3)
    q, k, v, w = (rng.standard_normal(s).astype(np.float32) for s in
                  ((1, Tc, 4, 16), (1, Tc, 2, 16), (1, Tc, 2, 16), (1, Tc, 4, 16)))
    pos = np.arange(Tc, dtype=np.int32)[None]

    def jloss(q, k, v):
        o = jattn.attention_auto(jcfg, q, k, v, pos, pos, causal=True, window=window)
        return jnp.sum(o * w)
    jout = jattn.attention_auto(jcfg, q, k, v, pos, pos, causal=True, window=window)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tpos = torch.from_numpy(pos).long()
    out = attn.attention_auto(cfg, *ts, tpos, tpos, causal=True, window=window)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    assert _rel_l2(out.detach(), torch.from_numpy(np.asarray(jout))) <= 1e-5
    for got, want in zip(grads, jgrads):
        assert _rel_l2(got, torch.from_numpy(np.asarray(want))) <= 1e-4
    with torch.no_grad():                      # no graph, the same numbers
        assert torch.equal(attn.attention_auto(cfg, *ts, tpos, tpos, causal=True,
                                               window=window), out.detach())


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
STEP_ARCHS = ["smollm-360m-smoke", "deepseek-moe-16b-smoke"]
STEP_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(scope="module")
def jax_steps():
    """The reference's jitted train step for each arch, compiled once."""
    out = {}
    for arch in STEP_ARCHS:
        jcfg = jget_config(arch)
        out[arch] = jax.jit(jtrain_step.make_train_step(
            jcfg, joptimizer.AdamWConfig(**STEP_OPT)))
    return out


def _data(cfg, n, seed=0):
    it = synthetic.lm_batches(cfg.vocab_size, T, B, seed=seed)
    return [next(it) for _ in range(n)]


def _jax_run(arch, jstep, batches, state=None):
    jcfg = jget_config(arch)
    if state is None:
        state = jtrain_step.init_train(jcfg, joptimizer.AdamWConfig(**STEP_OPT),
                                       jax.random.PRNGKey(0))
    jp, jopt = state
    losses = []
    for b in batches:
        jp, jopt, m = jstep(jp, jopt, {"tokens": jnp.asarray(b)})
        losses.append(float(m["loss"]))
    return jp, jopt, losses


def _port_run(cfg, params, opt, batches):
    step = make_train_step(cfg, AdamWConfig(**STEP_OPT))
    losses = []
    for b in batches:
        params, opt, m = step(params, opt, {"tokens": torch.from_numpy(b)})
        assert set(m) == {"loss", "ce", "aux", "tokens", "lr", "grad_norm"}
        losses.append(float(m["loss"]))
    return params, opt, losses


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_steps_match_reference(arch, jax_steps):
    cfg = get_config(arch)
    batches = _data(cfg, 5)
    jcfg = jget_config(arch)
    j0 = jtrain_step.init_train(jcfg, joptimizer.AdamWConfig(**STEP_OPT), jax.random.PRNGKey(0))
    params, opt = _port_state(cfg, *j0, AdamWConfig(**STEP_OPT))
    jp, jopt, jlosses = _jax_run(arch, jax_steps[arch], batches, j0)
    params, opt, losses = _port_run(cfg, params, opt, batches)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, jlosses))
    param_err = _max_leaf_rel(cfg, params, jp)
    print(f"{arch}: 5 steps, max loss rel {loss_err:.3g}, max param leaf rel L2 {param_err:.3g}")
    assert loss_err <= STEP_LOSS_RTOL, (losses, jlosses)
    assert param_err <= STEP_PARAM_RTOL
    assert int(opt["step"]) == 5
    assert losses[-1] < losses[0]


def test_train_cli_loss_decreases(tmp_path, capsys):
    """The reference's ``test_train_loss_decreases`` (smollm-360m-smoke, 40
    steps of 8 x 128, lr 1e-3) through the port's launcher, which then
    writes a checkpoint that restores into the port's state."""
    ck = str(tmp_path / "state.npz")
    losses = train_cli.main(["--device", "cpu", "--arch", "smollm-360m-smoke", "--steps", "40",
                             "--batch", "8", "--seq", "128", "--lr", "1e-3",
                             "--log-every", "1", "--ckpt", ck])
    out = capsys.readouterr().out
    assert len(losses) == 40 and all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    assert out.startswith("step     0 loss=") and f"checkpoint -> {ck}" in out
    cfg = get_config("smollm-360m-smoke")
    like = dict(zip(("params", "opt"), init_train(cfg, AdamWConfig(), seed=1, device="cpu")))
    state = checkpoint.restore(ck, cfg, like)
    assert int(state["opt"]["step"]) == 40
    # a mesh needs its devices: without --mesh-devices there are no cards here
    with pytest.raises(RuntimeError, match="needs 2 devices"):
        train_cli.main(["--device", "cpu", "--model-parallel", "2"])


def test_train_cli_model_parallel_matches_one_device(capsys):
    """``--model-parallel 2 --mesh-devices cpu,cpu`` trains on a (1, 2) mesh
    of CPU shards, its step losses within ``STEP_LOSS_RTOL`` of
    ``--model-parallel 1``'s."""
    argv = ["--device", "cpu", "--arch", "smollm-360m-smoke", "--steps", "8", "--batch", "4",
            "--seq", "64", "--log-every", "1"]
    one = train_cli.main(argv)
    two = train_cli.main(argv + ["--model-parallel", "2", "--mesh-devices", "cpu,cpu"])
    assert "mesh {'data': 1, 'model': 2}" in capsys.readouterr().out
    assert len(two) == len(one) == 8
    assert max(abs(a - b) / abs(b) for a, b in zip(two, one)) <= STEP_LOSS_RTOL, (two, one)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
CKPT_ARCHS = ["smollm-360m-smoke", "deepseek-moe-16b-smoke", "whisper-tiny-smoke"]


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_checkpoint_round_trip_exact(arch, state_dtype, tmp_path):
    cfg = get_config(arch)
    opt_cfg = AdamWConfig(state_dtype=state_dtype)
    params, opt = init_train(cfg, opt_cfg, seed=0, device="cpu")
    g = optimizer.tree_map(lambda p: torch.randn_like(p.float()).to(p.dtype), params)
    params, opt, _ = optimizer.adamw_update(g, opt, params, opt_cfg, cfg)
    ck = str(tmp_path / "s.npz")
    checkpoint.save(ck, cfg, {"params": params, "opt": opt})
    like = dict(zip(("params", "opt"), init_train(cfg, opt_cfg, seed=1, device="cpu")))
    got = checkpoint.restore(ck, cfg, like)
    want = tree_leaves({"params": params, "opt": opt})
    assert [p for p, _ in tree_leaves(got)] == [p for p, _ in want]
    for (path, a), (_, b) in zip(tree_leaves(got), want):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert not list(tmp_path.glob("*.tmp.npz"))


@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_checkpoints_cross_between_packages(arch, tmp_path):
    """A reference-written file restores into the port as ``params_from_jax``
    of the reference's state; a port-written one restores through the
    reference's ``checkpoint.restore`` to the port's values; the keys are
    the reference's."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jopt_cfg, opt_cfg = joptimizer.AdamWConfig(), AdamWConfig()
    from repro.models import model as jmodel
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(2))
    jopt = joptimizer.adamw_init(jp, jopt_cfg)
    jopt = {"m": jax.tree.map(lambda p: p * 0.5, jp), "v": jax.tree.map(jnp.abs, jp),
            "step": jnp.asarray(7, jnp.int32)}
    jstate = {"params": jp, "opt": jopt}
    ref_file = str(tmp_path / "ref.npz")
    jcheckpoint.save(ref_file, jstate)
    like = dict(zip(("params", "opt"), init_train(cfg, opt_cfg, seed=0, device="cpu")))
    got = checkpoint.restore(ref_file, cfg, like)
    want_p, want_o = _port_state(cfg, jp, jopt, opt_cfg)
    want = dict(tree_leaves({"params": want_p, "opt": want_o}))
    assert sorted(map(str, want)) == sorted(str(p) for p, _ in tree_leaves(got))
    for path, a in tree_leaves(got):
        assert a.dtype == want[path].dtype and torch.equal(a, want[path]), path

    port_file = str(tmp_path / "port.npz")
    checkpoint.save(port_file, cfg, got)
    with np.load(port_file) as a, np.load(ref_file) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "params/pattern/0/mixer/wq" in a.files and "opt/step" in a.files
    back = jcheckpoint.restore(port_file, jstate)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_reference_run_resumes_in_the_port(tmp_path, jax_steps):
    """The reference trains 3 steps and saves; the port restores and trains
    3 more; the reference's own 6 steps agree within the 5-step
    tolerances."""
    arch = "smollm-360m-smoke"
    cfg = get_config(arch)
    batches = _data(cfg, 6, seed=5)
    jp, jopt, _ = _jax_run(arch, jax_steps[arch], batches[:3])
    ck = str(tmp_path / "mid.npz")
    jcheckpoint.save(ck, {"params": jp, "opt": jopt})
    _, _, jlosses = _jax_run(arch, jax_steps[arch], batches[3:], (jp, jopt))
    jp6, _, _ = _jax_run(arch, jax_steps[arch], batches[3:], (jp, jopt))
    like = dict(zip(("params", "opt"), init_train(cfg, AdamWConfig(**STEP_OPT), seed=0,
                                                  device="cpu")))
    state = checkpoint.restore(ck, cfg, like)
    assert int(state["opt"]["step"]) == 3
    params, opt, losses = _port_run(cfg, state["params"], state["opt"], batches[3:])
    assert max(abs(a - b) / abs(b) for a, b in zip(losses, jlosses)) <= STEP_LOSS_RTOL
    assert _max_leaf_rel(cfg, params, jp6) <= STEP_PARAM_RTOL
    assert int(opt["step"]) == 6
