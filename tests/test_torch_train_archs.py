"""The port's training forward (``repro_torch.models.model.forward_train``)
held against the JAX package's ``jax.value_and_grad(forward_train)`` on the
CPU, for every arch family at smoke width: the reference's params carried
across with ``params_from_jax``, B 2, T 32, numpy-seeded tokens and, where
the config has a frontend, seeded frames (whisper's encoder) or patches
(internvl2's prefix).

* loss, ``ce`` and ``aux`` within 2e-5 relative;
* every gradient leaf within 1e-4 relative L2 of the reference's (1e-6
  absolute where the reference's norm is below 1e-6);
* ``remat=True`` (a period recomputed in the backward) and ``remat=False``
  bit for bit, loss and gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.models import model
from repro_torch.training.optimizer import tree_leaves

torch.set_float32_matmul_precision("highest")
ARCHS = ["smollm-360m-smoke", "gemma2-2b-smoke", "deepseek-moe-16b-smoke",
         "jamba-1.5-large-398b-smoke", "xlstm-350m-smoke", "whisper-tiny-smoke",
         "internvl2-26b-smoke", "llama4-scout-17b-a16e-smoke"]
B, T = 2, 32
LOSS_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


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


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
    if cfg.frontend:
        batch["frontend"] = (0.1 * rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    return batch


def _rel(got, want):
    return float(abs(got - want) / abs(want)) if want else float(abs(got))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_and_gradients_match_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch(cfg)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.forward_train(jcfg, p, b), has_aux=True))
    (jloss, jm), jgrads = grad_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})

    params = model.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    leaves = [p for _, p in tree_leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, m = model.forward_train(cfg, params, tb)
    grads = torch.autograd.grad(loss, leaves)

    for name, got, want in (("loss", loss, jloss), ("ce", m["ce"], jm["ce"]),
                            ("aux", m["aux"], jm["aux"])):
        assert _rel(float(got), float(want)) <= LOSS_RTOL, (arch, name, float(got), float(want))
    assert int(m["tokens"]) == int(jm["tokens"]) == B * (T - 1)
    if cfg.n_experts:
        assert float(m["aux"]) > 0.5                 # the load-balance term is live

    want_grads = model.params_from_jax(cfg, jax.tree.map(np.asarray, jgrads), device="cpu")
    flat_want = tree_leaves(want_grads)
    assert [p for p, _ in flat_want] == [p for p, _ in tree_leaves(params)]
    for (path, want), got in zip(flat_want, grads):
        wn, err = float(want.norm()), float((got - want).norm())
        if wn < 1e-6:
            assert err <= GRAD_ATOL, (arch, path, err)
        else:
            assert err / wn <= GRAD_RTOL, (arch, path, err / wn)

    loss2, _ = model.forward_train(cfg, params, tb, remat=False)
    grads2 = torch.autograd.grad(loss2, leaves)
    assert torch.equal(loss, loss2)
    for (path, _), a, b in zip(flat_want, grads, grads2):
        assert torch.equal(a, b), (arch, path)


def test_serving_entry_points_stay_no_grad():
    """The serving entry points build no graph even when params require
    grad (they run under ``torch.no_grad``)."""
    from repro_torch.configs.base import FreeKVConfig
    cfg = get_config("smollm-360m-smoke")
    params = model.init_params(cfg, seed=0, device="cpu")
    for _, p in tree_leaves(params):
        p.requires_grad_(True)
    fkv = FreeKVConfig(page_size=8, budget=64, n_sink=8, n_window=8)
    tokens = torch.from_numpy(_batch(cfg)["tokens"])
    logits, state = model.prefill(cfg, fkv, params, {"tokens": tokens}, max_len=64,
                                  state_dtype=torch.float32)
    assert not logits.requires_grad
    logits, _ = model.serve_step(cfg, fkv, params, state, tokens[:, -1:])
    assert not logits.requires_grad
