"""The port's sampler held against the reference's on the CPU.

Keys, random bits and categorical draws equal JAX's exactly
(``repro_torch.serving.sampling`` against ``jax.random`` under the
partitionable threefry2x32, the form this JAX runs), and sampled tokens
equal the reference engine's at temperature 0.8 on
``tests/test_async_decode.py``'s traffic, on both schedulers: the
continuous one crowded (one slot), alone (two slots), every host-read
cadence and the synchronous path; and the static one. Weights are carried
across with ``params_from_jax``; the JAX engines run once a module."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import FreeKVConfig as JFreeKVConfig
from repro.models import model as jmodel
from repro.serving import sampling as jsampling
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import FreeKVConfig
from repro_torch.models import model
from repro_torch.serving import sampling
from repro_torch.serving.engine import Request, ServeEngine

torch.set_float32_matmul_precision("highest")
SEEDS = (0, 1234)
UIDS = (0, 1, 7, 123456)


def test_jax_runs_the_partitionable_threefry():
    """The port reproduces this form of JAX's random numbers: a JAX whose
    defaults change fails here by name."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


def _np(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_equal_jax(seed):
    assert (sampling.PRNGKey(seed).numpy() == _np(jax.random.PRNGKey(seed))).all()
    for uid in UIDS:
        rk = sampling.request_key(seed, uid)
        assert (rk.numpy() == _np(jsampling.request_key(seed, uid))).all(), uid
        for data in (0, 5, 2 ** 31 - 1):
            assert (sampling.fold_in(rk, data).numpy()
                    == _np(jax.random.fold_in(jsampling.request_key(seed, uid), data))).all()
    keys = np.stack([_np(jsampling.request_key(seed, u)) for u in UIDS])
    counts = np.array([0, 3, 17, 255], np.int32)
    want = _np(jsampling.step_keys(jnp.asarray(keys.astype(np.uint32)), jnp.asarray(counts)))
    got = sampling.step_keys(torch.from_numpy(keys), torch.from_numpy(counts)).numpy()
    assert (got == want).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("width", [8, 16, 32])
def test_random_bits_equal_jax(seed, width):
    """One key over (B, V) and (V,), and one key a row over (V,) as
    ``sample_step``'s ``vmap`` draws."""
    udt = {8: jnp.uint8, 16: jnp.uint16, 32: jnp.uint32}[width]
    key = jsampling.request_key(seed, 3)
    for shape in ((4, 1536), (1536,)):
        want = np.asarray(jax.random.bits(key, shape, udt)).astype(np.int64)
        got = sampling.random_bits(torch.from_numpy(_np(key)), width, shape).numpy()
        assert (got == want).all(), shape
    keys = np.stack([_np(jsampling.request_key(seed, u)) for u in UIDS])
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (1536,), udt))(
        jnp.asarray(keys.astype(np.uint32)))).astype(np.int64)
    got = sampling.random_bits(torch.from_numpy(keys), width, (1536,)).numpy()
    assert (got == want).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_uniform_equal_jax(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    key = jsampling.request_key(0, 9)
    tiny = float(jnp.finfo(jdt).tiny)
    want = np.asarray(jax.random.uniform(key, (6, 700), jdt, minval=tiny, maxval=1.0)
                      .astype(jnp.float32))
    got = sampling.uniform(torch.from_numpy(_np(key)), (6, 700), tdt, tiny, 1.0).float().numpy()
    assert (got == want).all()


def _logits(dtype, rows, V, rng, scale, n_real):
    lg = (rng.normal(size=(rows, V)) * scale).astype(np.float32)
    jl = jnp.asarray(lg).astype(getattr(jnp, dtype))
    # padded-vocabulary lanes at finfo.min, as the model's head leaves them
    jl = jl.at[:, n_real:].set(jnp.finfo(jl.dtype).min)
    return jl, torch.from_numpy(np.array(jl.astype(jnp.float32))).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("temperature", [0.7, 1.0])
@pytest.mark.parametrize("top_p", [1.0, 0.9])
def test_categorical_ids_equal_jax(dtype, temperature, top_p):
    """``sample`` (one key, the (B, V) draw) and ``sample_step`` (a key a
    row) draw the reference's ids, logits at the dtype, logits scales from
    nearly flat to peaked, padded-vocabulary lanes included."""
    rng = np.random.default_rng(int(temperature * 10) + int(top_p * 100))
    jcfg = jsampling.SamplerConfig(temperature=temperature, top_p=top_p)
    cfg = sampling.SamplerConfig(temperature=temperature, top_p=top_p)
    for seed in SEEDS:
        for scale in (0.5, 3.0, 8.0):
            jl, tl = _logits(dtype, 6, 1536, rng, scale, 1000)
            keys = np.stack([_np(jsampling.request_key(seed, u)) for u in range(6)])
            want = np.asarray(jsampling.sample_step(jl, jcfg, jnp.asarray(keys.astype(np.uint32))))
            got = sampling.sample_step(tl, cfg, torch.from_numpy(keys)).numpy()
            assert (got == want).all(), (seed, scale, got, want)
            key = jsampling.request_key(seed, 99)
            want = np.asarray(jsampling.sample(jl, jcfg, key))
            got = sampling.sample(tl, cfg, torch.from_numpy(_np(key))).numpy()
            assert (got == want).all(), (seed, scale, got, want)
            if top_p == 1.0:
                assert (want < 1000).all()


def test_top_p_cumsum_is_xla_blocked_scan():
    """The top-p cutoff's cumulative sum rounds as XLA's does, at lengths
    that are and are not multiples of its 16-wide blocks, in both dtypes."""
    rng = np.random.default_rng(0)
    for dtype in ("float32", "bfloat16"):
        for n in (7, 100, 1536, 4100):
            x = np.sort(rng.exponential(size=(3, n)).astype(np.float32), 1)[:, ::-1]
            x = x / x.sum(1, keepdims=True)
            jx = jnp.asarray(x).astype(getattr(jnp, dtype))
            want = np.asarray(jnp.cumsum(jx, axis=-1).astype(jnp.float32))
            got = sampling._cumsum(torch.from_numpy(np.array(jx.astype(jnp.float32)))
                                   .to(getattr(torch, dtype))).float().numpy()
            assert (got == want).all(), (dtype, n)


# ---------------------------------------------------------------------------
# engines: sampled tokens equal the reference's
# ---------------------------------------------------------------------------
FKV = dict(method="freekv", page_size=8, budget=64, n_sink=8, n_window=8, tau=0.8)
SAMPLER = dict(temperature=0.8)


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jget_config("smollm-360m-smoke"), get_config("smollm-360m-smoke")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, model.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _prompt(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, n).astype(np.int32)


def _mk(cls, cfg, uids):
    prompt = _prompt(cfg, 64, seed=3)
    return [cls(uid=u, tokens=prompt, max_new_tokens=5) for u in uids]


@pytest.fixture(scope="module")
def reference(models):
    """The reference's tokens: continuous crowded (one slot), which its own
    ``test_rng_stream_stable_across_turnover`` holds equal to every other
    placement and cadence, and the static path."""
    jcfg, cfg, jp, _ = models
    out = {}
    for sched in ("continuous", "static"):
        eng = JServeEngine(jcfg, JFreeKVConfig(**FKV), jp, max_len=256,
                           batch_size=1 if sched == "continuous" else 2,
                           sampler=jsampling.SamplerConfig(**SAMPLER), prefill_bucket=64,
                           scheduler=sched)
        out[sched] = {o.uid: o.tokens for o in eng.generate(_mk(JRequest, cfg, [7, 8, 9]))}
    return out


def _run(models, uids, batch_size, scheduler="continuous", **kw):
    _, cfg, _, p = models
    eng = ServeEngine(cfg, FreeKVConfig(**{**FKV, **kw}), p, max_len=256,
                      batch_size=batch_size, sampler=sampling.SamplerConfig(**SAMPLER),
                      prefill_bucket=64, scheduler=scheduler, device="cpu")
    return {o.uid: o.tokens for o in eng.generate(_mk(Request, cfg, uids))}


@pytest.mark.parametrize("placement", ["crowded", "alone"])
def test_continuous_sampled_tokens_equal_reference(models, reference, placement):
    if placement == "crowded":
        assert _run(models, [7, 8, 9], batch_size=1) == reference["continuous"]
    else:
        for u in (7, 8, 9):
            assert _run(models, [u], batch_size=2) == {u: reference["continuous"][u]}


@pytest.mark.parametrize("mode", [dict(sync_interval=1), dict(sync_interval=8),
                                  dict(sample_on_device=False)],
                         ids=["k1", "k8", "sync"])
def test_sampled_tokens_independent_of_cadence(models, reference, mode):
    assert _run(models, [7, 8, 9], batch_size=2, **mode) == reference["continuous"]


def test_static_sampled_tokens_equal_reference(models, reference):
    """The static path chains ``fold_in(key, step)`` from ``PRNGKey(seed)``
    over its lockstep batches, as the reference's."""
    assert _run(models, [7, 8, 9], batch_size=2, scheduler="static") == reference["static"]
    assert reference["static"] != reference["continuous"]


def test_draws_are_not_greedy(models, reference):
    """The temperature changes the tokens (the streams are exercised)."""
    _, cfg, _, p = models
    eng = ServeEngine(cfg, FreeKVConfig(**FKV), p, max_len=256, batch_size=1,
                      prefill_bucket=64, device="cpu")
    greedy = {o.uid: o.tokens for o in eng.generate(_mk(Request, cfg, [7, 8, 9]))}
    assert greedy[7] == greedy[8] == greedy[9]
    assert greedy != reference["continuous"]
    assert len({tuple(t) for t in reference["continuous"].values()}) > 1


def test_sample_step_top_p_masks_all_when_cutoff_runs_out():
    """A cutoff past the last token reads NaN in the reference
    (``take_along_axis`` out of bounds), every token is masked and the draw
    is token 0: here bf16 rows whose rounded cumulative sum ends below
    top_p = 0.999 (rows 0 and 1) beside rows where it does not."""
    lg = np.random.default_rng(0).normal(size=(4, 4096)).astype(np.float32) * 0.5
    jl = jnp.asarray(lg).astype(jnp.bfloat16)
    keys = np.stack([_np(jsampling.request_key(0, u)) for u in range(4)])
    jcfg = jsampling.SamplerConfig(temperature=1.0, top_p=0.999)
    want = np.asarray(jsampling.sample_step(jl, jcfg, jnp.asarray(keys.astype(np.uint32))))
    tl = torch.from_numpy(np.asarray(jl.astype(jnp.float32))).to(torch.bfloat16)
    got = sampling.sample_step(tl, sampling.SamplerConfig(1.0, 0.999), torch.from_numpy(keys))
    assert (got.numpy() == want).all()
    assert (want[:2] == 0).all() and (want[2:] != 0).all()


def test_sampled_engine_config_is_kept(models):
    """A temperature no longer changes the continuous engine's setup."""
    _, cfg, _, p = models
    eng = ServeEngine(cfg, FreeKVConfig(**FKV), p, max_len=128,
                      batch_size=1, sampler=sampling.SamplerConfig(temperature=0.8),
                      device="cpu")
    assert eng.scheduler == "continuous" and eng.sampler.temperature == 0.8
