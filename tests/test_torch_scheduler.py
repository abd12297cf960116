"""The port's continuous scheduler held against the reference's on the CPU:
llama31-8b-smoke at 2 layers with the reference's weights
(``params_from_jax``), page_size 8, budget 64. The same requests go through
``repro.serving.engine.ServeEngine(scheduler="continuous")`` and the port's:
greedy tokens exactly equal, the step and occupancy counters exactly equal,
per-request correction and speculative-hit rates within 1e-6. Then the
rest of the reference's ``tests/test_scheduler.py`` and
``tests/test_async_decode.py`` on the port alone (the sampled key streams
are not ported; the prefix cache, chunked prefill and preemption are held
in ``test_torch_chunked.py`` and ``test_torch_prefix_cache.py``)."""
import dataclasses
import math

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
from repro_torch.core import paging
from repro_torch.models import model
from repro_torch.obs import Observability
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.kv_slots import POOL_KEYS, SlotPool

torch.set_float32_matmul_precision("highest")
FKV = dict(method="freekv", page_size=8, budget=64, n_sink=8, n_window=8, tau=0.8)
MAX_LEN = 192


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


def _llama2(get):
    return dataclasses.replace(get("llama31-8b-smoke"), n_layers=2, n_periods=2)


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = _llama2(jget_config), _llama2(get_config)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, model.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _prompt(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, n).astype(np.int32)


# five requests over two slots: two prompt lengths (one not a page multiple),
# limits that make slots turn over while the other lane decodes
LENS, NEWS = (72, 101, 72, 101, 72), (9, 4, 12, 5, 7)


def _reqs(cfg, cls, eos=None):
    return [cls(uid=i, tokens=_prompt(cfg, n, seed=i), max_new_tokens=m,
                eos_token=(eos or {}).get(i))
            for i, (n, m) in enumerate(zip(LENS, NEWS))]


def _engine(cfg, params, batch_size=2, **kw):
    bucket = kw.pop("prefill_bucket", 1)
    return ServeEngine(cfg, FreeKVConfig(**{**FKV, **kw}), params, max_len=MAX_LEN,
                       batch_size=batch_size, prefill_bucket=bucket, device="cpu")


def _both(models, eos=None, prefill_bucket=1, **kw):
    jcfg, cfg, jp, p = models
    jeng = JServeEngine(jcfg, JFreeKVConfig(**{**FKV, **kw}), jp, max_len=MAX_LEN,
                        batch_size=2, prefill_bucket=prefill_bucket)
    jouts = jeng.generate(_reqs(cfg, JRequest, eos))
    eng = _engine(cfg, p, prefill_bucket=prefill_bucket, **kw)
    outs = eng.generate(_reqs(cfg, Request, eos))
    return jouts, jeng.last_metrics, outs, eng.last_metrics


def _syncs_bound(em, k):
    """Windows of at most k steps, plus one more per admission boundary."""
    return math.ceil(em.steps / k) + len(em.requests)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", ["freekv", "centroid"])
def test_ragged_serve_step_matches_reference(models, method):
    """Rows at different lengths in one batch, each completing a page on a
    different step, beside an idle empty row that steps from length 0:
    live rows' logits within 1e-4 of the reference's and every row's
    selected pages exactly equal, for ten steps."""
    jcfg, cfg, jp, p = models
    kw = {**FKV, "method": method}
    jeng = JServeEngine(jcfg, JFreeKVConfig(**kw), jp, max_len=128, batch_size=3)
    eng = ServeEngine(cfg, FreeKVConfig(**kw), p, max_len=128, batch_size=3, device="cpu")
    jpool, pool = jeng.make_slot_pool(3), eng.make_slot_pool(3)
    cur = np.zeros(3, np.int32)
    for slot, n in ((0, 61), (2, 92)):
        toks = _prompt(cfg, n, seed=slot)
        jl, js, _, _ = jeng.prefill_one(JRequest(uid=slot, tokens=toks, max_new_tokens=8))
        jpool.insert(js, slot)
        logits, st, _, _ = eng.prefill_one(Request(uid=slot, tokens=toks, max_new_tokens=8),
                                           pool, slot)
        pool.insert(st, slot)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        cur[slot] = int(np.argmax(np.asarray(jl)[0]))
    for _ in range(10):
        jlog, jpool.state, _ = jeng.step(jpool.state, jnp.asarray(cur[:, None]))
        logits, pool.state, _ = eng.step(pool.state, torch.from_numpy(cur[:, None]))
        np.testing.assert_allclose(logits.numpy()[[0, 2]], np.asarray(jlog)[[0, 2]],
                                   atol=1e-4, rtol=1e-4)
        for i in range(cfg.n_layers):
            np.testing.assert_array_equal(pool.state["layers"][i]["sel_idx"].numpy(),
                                          np.asarray(jpool.state["pattern"][0]["sel_idx"][i]))
        cur = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
        cur[1] = 0
    assert pool.state["pos_host"].tolist() == np.asarray(jpool.state["pos"]).tolist() \
        == [71, 10, 102]


CASES = {
    "bucket1": {},
    "bucket64": dict(prefill_bucket=64),
    "k1": dict(sync_interval=1),
    "k4": dict(sync_interval=4),
    "sync": dict(sample_on_device=False),
    # no head corrected: every page but the buffer hits goes through the
    # staged recall, and slot turnover drops staged pages in flight
    "staged": dict(tau=-1.0, prefill_bucket=64),
    "int8": dict(kv_quant="int8", prefill_bucket=64),
    "int4": dict(kv_quant="int4", quant_group_size=16, prefill_bucket=64),
    "shadowkv": dict(method="shadowkv", prefill_bucket=64),
    "centroid": dict(method="centroid", centroid_refresh_interval=1, prefill_bucket=64),
}


@pytest.mark.parametrize("case", list(CASES))
def test_continuous_matches_reference(models, case):
    """More requests than slots, mixed prompt lengths: the same greedy
    tokens, steps, active slot-steps, occupancy and recall page counts as
    the reference's continuous engine, per-request rates within 1e-6, and
    no more host reads than the windows and admissions need."""
    kw = CASES[case]
    jouts, jem, outs, em = _both(models, **kw)
    assert [o.tokens for o in outs] == [o.tokens for o in jouts]
    assert [len(o.tokens) for o in outs] == list(NEWS)
    assert em.steps == jem.steps
    assert em.active_slot_steps == jem.active_slot_steps
    assert em.slot_occupancy == jem.slot_occupancy
    assert em.sync_pages == jem.sync_pages and em.async_pages == jem.async_pages
    assert em.dropped_pages == jem.dropped_pages
    for o, jo in zip(outs, jouts):
        for k in ("correction_rate", "spec_hit_rate"):
            assert abs(o.stats.get(k, 0.0) - jo.stats.get(k, 0.0)) <= 1e-6, (o.uid, k)
    k = 1 if kw.get("sample_on_device") is False else kw.get("sync_interval", 8)
    assert em.host_syncs <= _syncs_bound(em, k)
    assert em.summary()["dispatch"]["nonsync_host_bytes"] == 0.0


def test_eos_mid_window_matches_reference(models):
    """An eos picked inside a window ends that request with the reference's
    tokens; the other requests are unchanged."""
    jcfg, cfg, jp, p = models
    full = [o.tokens for o in _engine(cfg, p).generate(_reqs(cfg, Request))]
    # request 2 (12 new tokens) stops at the first token it had not made
    # before, its third or later: read inside a window, not at admission
    cut = next(i for i, t in enumerate(full[2]) if i >= 2 and t not in full[2][:i]) + 1
    eos = full[2][cut - 1]
    jouts, jem, outs, em = _both(models, eos={2: eos})
    assert [o.tokens for o in outs] == [o.tokens for o in jouts]
    assert outs[2].tokens == full[2][:cut] and outs[2].tokens[-1] == eos
    assert [o.tokens for i, o in enumerate(outs) if i != 2] == \
        [t for i, t in enumerate(full) if i != 2]
    assert em.host_syncs <= _syncs_bound(em, 8)


# ---------------------------------------------------------------------------
# slot pool
# ---------------------------------------------------------------------------
def test_slot_pool_insert_extract_roundtrip(models):
    """A B=1 state written into a slot reads back bit for bit, its
    neighbours are untouched, and a freed slot is reset lazily, all but its
    pool pages (no reset clears those: see kv_slots.POOL_KEYS)."""
    _, cfg, _, p = models
    fkv = FreeKVConfig(**FKV)
    pool = SlotPool(cfg, fkv, num_slots=3, max_len=128, device="cpu")
    _, src = model.prefill(cfg, fkv, p, {"tokens": torch.from_numpy(_prompt(cfg, 61)[None]).long()},
                           128, state_dtype=torch.float32)
    empty = pool.extract(0)
    slot = pool.alloc(owner_uid=42)
    pool.insert(src, slot)
    got = pool.extract(slot)
    for i, layer in enumerate(src["layers"]):
        for k, t in layer.items():
            assert torch.equal(got["layers"][i][k], t.to(got["layers"][i][k].dtype)), k
    assert got["pos"].tolist() == got["pos_host"].tolist() == [61]
    other = pool.extract((slot + 1) % 3)
    for i, layer in enumerate(empty["layers"]):
        for k, t in layer.items():
            assert torch.equal(other["layers"][i][k], t), k
    pool.free(slot)
    assert pool.free_count == 3
    assert int(pool.extract(slot)["pos"][0]) == 61       # reset is lazy
    pool.flush_resets()
    reset = pool.extract(slot)
    assert reset["pos"].tolist() == reset["pos_host"].tolist() == [0]
    for i, layer in enumerate(empty["layers"]):
        for k, t in layer.items():
            want = got["layers"][i][k] if k in POOL_KEYS else t
            assert torch.equal(reset["layers"][i][k], want), k
    # claim empties a refilled row but for the pool pages, and hands out views
    pool.insert(src, slot)
    views = pool.claim(slot)
    claimed = pool.extract(slot)
    for i, layer in enumerate(empty["layers"]):
        for k, t in layer.items():
            want = src["layers"][i][k] if k in POOL_KEYS else t
            assert torch.equal(claimed["layers"][i][k], want), k
            assert views[i][k].data_ptr() == \
                paging.slot_read_leaf(pool.state["layers"][i][k], slot).data_ptr()


def test_slot_pool_reuse_across_request_waves(models):
    """More requests than slots: every slot is recycled and all complete."""
    _, cfg, _, p = models
    eng = _engine(cfg, p, prefill_bucket=64)
    reqs = [Request(uid=i, tokens=_prompt(cfg, 40 + i, seed=i), max_new_tokens=3)
            for i in range(5)]
    outs = eng.generate(reqs)
    assert [o.uid for o in outs] == [0, 1, 2, 3, 4]
    assert all(len(o.tokens) == 3 for o in outs)
    assert eng._pool.allocs == 5 > eng._pool.num_slots
    assert eng._pool.free_count == 2
    em = eng.last_metrics
    assert em.steps > 0 and 0.0 < em.slot_occupancy <= 1.0
    assert all(r.finish_t is not None for r in em.requests)
    # a second run on the same engine resets every row (its pool pages keep
    # the first run's bytes, past every new length) and gives the same tokens
    assert [o.tokens for o in eng.generate(reqs)] == [o.tokens for o in outs]


# ---------------------------------------------------------------------------
# scheduling
# ---------------------------------------------------------------------------
def test_short_requests_finish_before_long(models):
    """A short request beside a long one completes first, and its freed
    slot admits a queued request before the long one drains."""
    _, cfg, _, p = models
    eng = _engine(cfg, p)
    eng.generate([Request(uid=0, tokens=_prompt(cfg, 64, 0), max_new_tokens=16),
                  Request(uid=1, tokens=_prompt(cfg, 64, 1), max_new_tokens=2),
                  Request(uid=2, tokens=_prompt(cfg, 64, 2), max_new_tokens=2)])
    m = {r.uid: r for r in eng.last_metrics.requests}
    assert m[1].finish_step < m[0].finish_step
    assert m[2].finish_step < m[0].finish_step
    assert m[1].queue_wait_s <= m[2].queue_wait_s


def test_finished_slots_not_stepped(models):
    """1 long (16 new) + 1 short (2 new) on 2 slots takes 15 steps, and the
    active slot-steps are the requests' own decode steps."""
    _, cfg, _, p = models
    eng = _engine(cfg, p)
    eng.generate([Request(uid=0, tokens=_prompt(cfg, 64), max_new_tokens=16),
                  Request(uid=1, tokens=_prompt(cfg, 64), max_new_tokens=2)])
    em = eng.last_metrics
    assert em.steps == 15
    assert em.active_slot_steps == 15 + 1


def test_continuous_matches_static_greedy(models):
    _, cfg, _, p = models
    prompt = _prompt(cfg, 64, seed=3)            # bucket-aligned: no padding
    outs = {}
    for sched in ("continuous", "static"):
        eng = ServeEngine(cfg, FreeKVConfig(**FKV), p, max_len=MAX_LEN, batch_size=2,
                          scheduler=sched, device="cpu")
        outs[sched] = [o.tokens for o in eng.generate(
            [Request(uid=i, tokens=prompt, max_new_tokens=6) for i in range(2)])]
    assert outs["continuous"] == outs["static"]


def test_eos_token_stops_both_schedulers(models):
    _, cfg, _, p = models
    prompt = _prompt(cfg, 64, seed=5)

    def run(sched, eos=None):
        eng = ServeEngine(cfg, FreeKVConfig(**FKV), p, max_len=MAX_LEN, batch_size=1,
                          scheduler=sched, device="cpu")
        return eng.generate([Request(uid=0, tokens=prompt, max_new_tokens=8,
                                     eos_token=eos)])[0].tokens
    full = {s: run(s) for s in ("continuous", "static")}
    assert full["continuous"] == full["static"]
    eos = full["continuous"][2]
    cut = full["continuous"].index(eos) + 1
    assert cut <= 3
    for sched in ("continuous", "static"):
        out = run(sched, eos)
        assert out == full[sched][:cut] and out[-1] == eos


# ---------------------------------------------------------------------------
# host traffic
# ---------------------------------------------------------------------------
def test_zero_host_bytes_between_syncs(models):
    """With sampling on the card nothing crosses the host boundary between
    reads, and a long request takes 8 steps a read; the synchronous path
    reads once a step and moves more bytes a step."""
    _, cfg, _, p = models
    reqs = [Request(uid=0, tokens=_prompt(cfg, 64), max_new_tokens=16)]
    eng = _engine(cfg, p, sync_interval=8)
    eng.generate(reqs)
    em = eng.last_metrics
    d = em.summary()["dispatch"]
    assert d["nonsync_host_bytes"] == 0.0
    assert d["host_syncs"] == 2 and em.steps == 15          # 8 + 7
    assert d["steps_per_sync"] > 4
    eng = _engine(cfg, p, sample_on_device=False)
    eng.generate(reqs)
    ds = eng.last_metrics.summary()["dispatch"]
    assert ds["host_syncs"] == eng.last_metrics.steps == 15
    assert ds["host_bytes_per_step"] > d["host_bytes_per_step"]


def test_sync_path_metrics_match(models):
    """Step and occupancy accounting equal across the two dispatch modes."""
    _, cfg, _, p = models
    reqs = lambda: [Request(uid=0, tokens=_prompt(cfg, 64), max_new_tokens=16),  # noqa: E731
                    Request(uid=1, tokens=_prompt(cfg, 64), max_new_tokens=2)]
    ems = []
    for kw in (dict(sync_interval=8), dict(sample_on_device=False)):
        eng = _engine(cfg, p, **kw)
        eng.generate(reqs())
        ems.append(eng.last_metrics)
    a, b = ems
    assert a.steps == b.steps == 15
    assert a.active_slot_steps == b.active_slot_steps == 16
    assert a.sync_pages == b.sync_pages and a.async_pages == b.async_pages


def test_static_path_reads_twice_a_step(models):
    """The static engine fills ``last_metrics`` too: its steps, the two
    host reads a step (tokens, stats) plus one for the last tokens, and
    each request's measured prefill start, first token and finish."""
    _, cfg, _, p = models
    eng = ServeEngine(cfg, FreeKVConfig(**FKV), p, max_len=MAX_LEN, batch_size=2,
                      scheduler="static", device="cpu")
    outs = eng.generate([Request(uid=i, tokens=_prompt(cfg, 64, i), max_new_tokens=6)
                         for i in range(2)])
    em = eng.last_metrics
    assert em.scheduler == "static" and em.steps == 5
    assert em.host_syncs == 2 * em.steps + 1
    assert em.generated_tokens == sum(len(o.tokens) for o in outs) == 12
    assert eng.last_logits_finite
    for o, rm in zip(outs, em.requests):
        assert o.metrics is rm and rm.new_tokens == 6
        assert 0 <= rm.prefill_start_t < rm.first_token_t < rm.finish_t <= em.wall_s
        assert rm.ttft_s == rm.first_token_t


def test_observability_records_spans_and_histograms(models):
    """With ``Observability.full()`` the scheduler writes one window span a
    host read, the request lifecycles and the per-step histograms; the
    tokens are those of a run with it off."""
    _, cfg, _, p = models
    base = [o.tokens for o in _engine(cfg, p).generate(_reqs(cfg, Request))]
    eng = ServeEngine(cfg, FreeKVConfig(**FKV), p, max_len=MAX_LEN, batch_size=2,
                      obs=Observability.full(), device="cpu")
    outs = eng.generate(_reqs(cfg, Request))
    assert [o.tokens for o in outs] == base
    em = eng.last_metrics
    events = eng.obs.trace.chrome_trace()["traceEvents"]
    names = [e["name"] for e in events]
    assert names.count("engine/decode_window") == em.host_syncs
    assert names.count("engine/decode_step") == em.steps
    assert names.count("request/done") == len(LENS)
    s = em.summary()
    assert s["latency"]["decode_step_s"]["count"] == em.steps
    assert s["latency"]["ttft_s"]["count"] == len(LENS)
    assert s["completed"] == len(LENS) and s["generated_tokens"] == sum(NEWS)
    assert eng.recall_tracker.summary()["topup_pages"] == em.sync_pages
