"""The port's radix prefix cache (``repro_torch/serving/prefix_cache.py``):
the reference's trie cases (``tests/test_prefix_cache.py``) on torch
payloads, and the engine's cache against the JAX engine's on the CPU
(llama31-8b-smoke cut to 2 layers, the reference's weights): a hit's
logits within 1e-4 and its reused span equal, a run's tokens, hits and
trie statistics exactly equal, evictions included."""
import dataclasses

import jax
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
from repro_torch.serving.prefix_cache import RadixPrefixCache, copy_parts

torch.set_float32_matmul_precision("highest")
FKV = dict(method="freekv", page_size=8, budget=64, n_sink=8, n_window=8, tau=0.8)
PARITY = dict(atol=1e-4, rtol=1e-4)        # the model parity tests' tolerance


def _payload(tokens, n_arrays=2, width=3):
    """Deterministic per-token payload so slices are checkable: tensor i
    holds token * 10 + i across the feature axis."""
    t = torch.as_tensor(tokens, dtype=torch.float32)
    return [(t * 10 + i)[:, None].expand(len(tokens), width).contiguous()
            for i in range(n_arrays)]


def _match(c, tokens):
    """(n_matched, payload): the matched pieces copied into fresh tensors
    as the engine copies them into its buffers (``match_parts`` then
    ``copy_parts``), payload None on a zero-length match."""
    n, parts = c.match_parts(tokens)
    if not n:
        return 0, None
    out = [torch.empty((n,) + a.shape[1:], dtype=a.dtype) for a in parts[0]]
    return n, copy_parts(parts, out)


def _check(payload, tokens):
    want = _payload(tokens)
    assert len(payload) == len(want)
    for a, b in zip(payload, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the trie (the reference's cases)
# ---------------------------------------------------------------------------
def test_insert_then_exact_match():
    c = RadixPrefixCache(1 << 20)
    seq = (5, 6, 7, 8)
    c.insert(seq, _payload(seq))
    n, payload = _match(c, seq)
    assert n == 4
    _check(payload, seq)
    assert c.total_tokens == 4


def test_partial_segment_match():
    """A match may stop mid-segment: the node is sliced, not split, and the
    payload covers exactly the matched span."""
    c = RadixPrefixCache(1 << 20)
    seq = (1, 2, 3, 4, 5, 6, 7, 8)
    c.insert(seq, _payload(seq))
    n, payload = _match(c, (1, 2, 3, 99))
    assert n == 3
    _check(payload, (1, 2, 3))
    assert c.total_tokens == 8


def test_shared_prefix_dedup_and_split():
    c = RadixPrefixCache(1 << 20)
    a = (1, 2, 3, 4, 5, 6)
    b = (1, 2, 3, 9, 9, 9)
    c.insert(a, _payload(a))
    c.insert(b, _payload(b))
    assert c.total_tokens == 9          # (1, 2, 3) stored once
    for seq in (a, b):
        n, payload = _match(c, seq)
        assert n == 6
        _check(payload, seq)


def test_match_across_split_nodes_concatenates_payload():
    c = RadixPrefixCache(1 << 20)
    a = (1, 2, 3, 4)
    b = (1, 2, 5, 6)
    c.insert(a, _payload(a))
    c.insert(b, _payload(b))           # splits (1,2,3,4) into (1,2)+(3,4)
    n, payload = _match(c, (1, 2, 3, 4, 7))
    assert n == 4
    _check(payload, a)


def test_zero_capacity_disables():
    c = RadixPrefixCache(0)
    assert c.insert((1, 2, 3), _payload((1, 2, 3))) == 0
    n, payload = _match(c, (1, 2, 3))
    assert n == 0 and payload is None


def test_lru_eviction_under_capacity():
    c = RadixPrefixCache(8)
    a, b, d = (1, 2, 3, 4), (5, 6, 7, 8), (9, 10, 11, 12)
    c.insert(a, _payload(a))
    c.insert(b, _payload(b))
    assert c.total_tokens == 8
    _match(c, a)                        # a is now the most recently used
    c.insert(d, _payload(d))            # over capacity: evicts the LRU leaf (b)
    assert c.total_tokens == 8 and c.evictions == 1
    assert _match(c, b)[0] == 0
    assert _match(c, a)[0] == 4
    assert _match(c, d)[0] == 4


def test_eviction_prefers_leaves():
    """Evicting a leaf does not take a shared ancestor with it."""
    c = RadixPrefixCache(7)
    a = (1, 2, 3, 4, 5)
    b = (1, 2, 3, 8, 9)                 # shares (1,2,3): 5 + 2 = 7 tokens
    c.insert(a, _payload(a))
    c.insert(b, _payload(b))
    assert c.total_tokens == 7
    _match(c, b)
    e = (7, 7)
    c.insert(e, _payload(e))            # evicts the LRU leaf (a's tail)
    assert c.total_tokens <= 7
    n, payload = _match(c, b)
    assert n == 5
    _check(payload, b)


def test_accounting_stats():
    c = RadixPrefixCache(1 << 20)
    seq = tuple(range(16))
    c.insert(seq, _payload(seq))
    _match(c, seq)
    _match(c, (99,))
    s = c.stats()
    assert s["hits"] == 1 and s["misses"] == 1
    assert s["hit_tokens"] == 16 and s["cached_tokens"] == 16
    assert s["nbytes"] == sum(a.numel() * a.element_size() for a in _payload(seq))


def test_insert_stores_copies_and_parts_copy_back():
    """An insert owns copies of its span (changing the caller's tensors
    changes nothing cached); ``match_parts`` hands out the pieces of a
    match across split nodes, and ``copy_parts`` writes them into the
    leading tokens of a buffer."""
    c = RadixPrefixCache(1 << 20)
    a, b = (1, 2, 3, 4, 5), (1, 2, 6, 7)
    pa = _payload(a)
    c.insert(a, pa)
    pa[0].fill_(-1)
    c.insert(b, _payload(b))
    n, parts = c.match_parts((1, 2, 3, 4, 9))
    assert n == 4 and [p[0].shape[0] for p in parts] == [2, 2]
    out = [torch.full((6, 3), float("nan")) for _ in range(2)]
    copy_parts(parts, out)
    _check([o[:4] for o in out], (1, 2, 3, 4))
    assert torch.isnan(out[0][4:]).all()
    assert c.stats()["hits"] == 1 and c.stats()["lookup_tokens"] == 5


# ---------------------------------------------------------------------------
# the engine's cache against the JAX engine's
# ---------------------------------------------------------------------------
def _llama2(get):
    return dataclasses.replace(get("llama31-8b-smoke"), n_layers=2, n_periods=2)


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = _llama2(jget_config), _llama2(get_config)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, model.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _shared_prompts(cfg, n_shared=48, tails=(16, 24, 16), seed=4):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, n_shared).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, cfg.vocab_size, t).astype(np.int32)])
            for t in tails]


def test_prefill_one_hit_matches_reference(models):
    """A second prompt sharing 48 tokens of the first: both engines reuse
    the same span, the suffix-only prefill's logits agree within 1e-4, and
    the whole prompt's K/V is cached beside the first's."""
    jcfg, cfg, jp, p = models
    jeng = JServeEngine(jcfg, JFreeKVConfig(**FKV), jp, max_len=128, batch_size=2,
                        prefill_bucket=8, prefix_cache_tokens=4096)
    eng = ServeEngine(cfg, FreeKVConfig(**FKV), p, max_len=128, batch_size=2,
                      prefill_bucket=8, prefix_cache_tokens=4096, device="cpu")
    prompts = _shared_prompts(cfg)
    for i, t in enumerate(prompts[:2]):
        jl, _, jhit, jpad = jeng.prefill_one(JRequest(uid=i, tokens=t, max_new_tokens=4))
        l, st, hit, pad = eng.prefill_one(Request(uid=i, tokens=t, max_new_tokens=4))
        np.testing.assert_allclose(l.numpy(), np.asarray(jl), **PARITY)
        assert (hit, pad) == (jhit, jpad) == ((48 if i else 0), len(t))
        assert st["pos"].tolist() == [len(t)]
    assert eng.prefix_cache.stats() == {**jeng.prefix_cache.stats(),
                                        "nbytes": eng.prefix_cache.stats()["nbytes"]}
    assert eng.prefix_cache.nbytes() == jeng.prefix_cache.nbytes()
    n, payload = _match(eng.prefix_cache, tuple(int(x) for x in prompts[1]))
    assert n == len(prompts[1]) and len(payload) == 2 * cfg.n_layers
    assert payload[0].shape == (n, cfg.n_kv_heads, cfg.d_head)


@pytest.mark.parametrize("capacity", [4096, 100])
def test_cached_run_matches_reference(models, capacity):
    """Three requests with a shared prefix over two slots, then the same
    three again on the same engines (the cache persists across runs, as
    the reference's): greedy tokens, per-request hit tokens and the
    summary's prefix_cache statistics exactly equal to the JAX engine's;
    at a capacity of 100 tokens the LRU evicts. Tokens equal a run without
    a cache."""
    jcfg, cfg, jp, p = models
    prompts = _shared_prompts(cfg)
    jeng = JServeEngine(jcfg, JFreeKVConfig(**FKV), jp, max_len=128, batch_size=2,
                        prefill_bucket=8, prefix_cache_tokens=capacity)
    eng = ServeEngine(cfg, FreeKVConfig(**FKV), p, max_len=128, batch_size=2,
                      prefill_bucket=8, prefix_cache_tokens=capacity, device="cpu")
    cold = ServeEngine(cfg, FreeKVConfig(**FKV), p, max_len=128, batch_size=2,
                       prefill_bucket=8, device="cpu")
    base = [o.tokens for o in cold.generate([Request(uid=i, tokens=t, max_new_tokens=6)
                                             for i, t in enumerate(prompts)])]
    for _ in range(2):
        jt = [o.tokens for o in jeng.generate([JRequest(uid=i, tokens=t, max_new_tokens=6)
                                               for i, t in enumerate(prompts)])]
        t = [o.tokens for o in eng.generate([Request(uid=i, tokens=t, max_new_tokens=6)
                                             for i, t in enumerate(prompts)])]
        assert t == jt == base
        em, jem = eng.last_metrics, jeng.last_metrics
        assert [m.prefix_hit_tokens for m in em.requests] == \
            [m.prefix_hit_tokens for m in jem.requests]
        assert em.steps == jem.steps
        s, js = em.summary()["prefix_cache"], jem.summary()["prefix_cache"]
        assert s == js
    assert (s["evictions"] > 0) == (capacity == 100)
    assert s["hits"] > 0
