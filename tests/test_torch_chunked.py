"""Chunked prefill and priority preemption in the port, held against the
reference on the CPU: llama31-8b-smoke cut to 2 layers with the reference's
weights (``params_from_jax``), page_size 8, budget 64.

* the extension's attention (``flash_prefill_ref`` with Tq < Tk and
  ``attention_prefill``) against the reference's ``attention_auto`` at an
  extension's positions, float32 within 2e-5;
* ``prefill_extend``, extending in place in buffers seeded with the
  reference's prefix K/V, against the reference's: logits and the suffix's
  K/V within 1e-4 (the parity tests' tolerance), integer state leaves
  equal, float ones within 1e-4;
* the continuous engine against the JAX engine for chunk budgets 0, 1, a
  page and 10**6, with and without the overlapped recall, and with a
  prefix-cache hit: greedy tokens, ``steps``, ``prefill_chunks`` and
  ``prefill_chunk_tokens`` exactly equal;
* the reference's preemption scenarios on the port's scheduler with a fake
  backend, a mixed-priority run of the real engine against the JAX
  engine's (tokens, preemptions, resumes, swap bytes equal), and the slot
  pool's swap round trip bit for bit under kv_quant none, int8 and int4.
"""
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import FreeKVConfig as JFreeKVConfig
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.prefix_cache import RadixPrefixCache as JRadixPrefixCache
from repro_torch.configs import get_config
from repro_torch.configs.base import FreeKVConfig
from repro_torch.kernels import ref
from repro_torch.models import attention as attn
from repro_torch.models import model
from repro_torch.models.model import DECODE_STAT_KEYS
from repro_torch.obs import Observability
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.scheduler import ContinuousScheduler

torch.set_float32_matmul_precision("highest")
FKV = dict(method="freekv", page_size=8, budget=64, n_sink=8, n_window=8, tau=0.8)
TOL = dict(atol=2e-5, rtol=2e-5)           # float32 attention, summation order only
PARITY = dict(atol=1e-4, rtol=1e-4)        # the model parity tests' tolerance
BUCKET = 8
MAX_NEW = 8


def _llama2(get):
    return dataclasses.replace(get("llama31-8b-smoke"), n_layers=2, n_periods=2)


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = _llama2(jget_config), _llama2(get_config)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, model.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _prompt(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, n).astype(np.int32)


def _jax_engines(jcfg, jp, batch_size):
    """JAX engines by (overlap, kv_quant), each compiled once: a run sets
    the scheduler's switches (chunk budget, preemption, which its compiled
    functions never read) and a fresh prefix cache on it."""
    cache = {}

    def get(overlap=True, kv_quant="none", chunk=0, preempt=False, prefix_tokens=0):
        key = (overlap, kv_quant)
        if key not in cache:
            fkv = JFreeKVConfig(**FKV, recall_overlap=overlap, kv_quant=kv_quant)
            cache[key] = JServeEngine(jcfg, fkv, jp, max_len=256, batch_size=batch_size,
                                      prefill_bucket=BUCKET)
        eng = cache[key]
        eng.fkv = dataclasses.replace(eng.fkv, prefill_chunk_tokens=chunk, preempt=preempt)
        eng.prefix_cache = JRadixPrefixCache(prefix_tokens) if prefix_tokens else None
        return eng
    return get


# ---------------------------------------------------------------------------
# the extension's attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Tp,S,window,softcap", [
    (32, 16, None, None), (40, 1, None, None), (7, 57, None, None), (96, 33, 24, None),
    (64, 20, None, 20.0), (100, 77, 50, 30.0),
])
def test_flash_prefill_ref_extension_matches_reference(Tp, S, window, softcap):
    """The plain flash_prefill with Tq = S queries over Tk = Tp + S keys,
    the causal mask aligned bottom-right, equals the reference's model
    attention at q_pos = Tp..Tp+S-1, kv_pos = 0..Tp+S-1 (float32, 2e-5)."""
    cfg = dataclasses.replace(jget_config("llama31-8b-smoke"), attn_logit_softcap=softcap)
    B, H, kv, d = 2, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    rng = np.random.default_rng(Tp + S)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, d), (B, Tp + S, kv, d), (B, Tp + S, kv, d)))
    q_pos = jnp.broadcast_to(jnp.arange(Tp, Tp + S), (B, S))
    kv_pos = jnp.broadcast_to(jnp.arange(Tp + S), (B, Tp + S))
    want = jattn.attention_auto(cfg, *map(jnp.asarray, (q, k, v)), q_pos, kv_pos,
                                causal=True, window=window)
    got = ref.flash_prefill_ref(*(torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)),
                                1.0 / d ** 0.5, True, window, softcap)
    assert got.shape == (B, H, S, d)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want), **TOL)


def test_flash_prefill_ref_extension_rows_equal_whole_prompt():
    """Query rows Tp.. of a whole prompt and the same rows as an extension
    over all the keys: one function, the same numbers to 2e-5."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, n, 100, 32)).astype(np.float32))
               for n in (4, 2, 2))
    whole = ref.flash_prefill_ref(q, k, v, 0.2, True, 30, None)
    ext = ref.flash_prefill_ref(q[:, :, 61:], k, v, 0.2, True, 30, None)
    torch.testing.assert_close(ext, whole[:, :, 61:], **TOL)


@pytest.mark.parametrize("Tp,S", [(24, 8), (0, 16), (57, 1), (4400, 1000)])
def test_attention_extend_matches_reference(Tp, S):
    """``attention_prefill`` at an extension's positions on the CPU against
    the reference's
    ``attention_auto`` at the same positions (the last case is past
    2048 x 2048 query-key pairs: the chunked path), float32 within 2e-5."""
    jcfg, cfg = _llama2(jget_config), _llama2(get_config)
    B, H, kv, d = 1, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    rng = np.random.default_rng(S)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, d), (B, Tp + S, kv, d), (B, Tp + S, kv, d)))
    q_pos, kv_pos = np.arange(Tp, Tp + S)[None], np.arange(Tp + S)[None]
    want = jattn.attention_auto(jcfg, *map(jnp.asarray, (q, k, v, q_pos, kv_pos)), causal=True)
    got = attn.attention_prefill(cfg, *map(torch.from_numpy, (q, k, v, q_pos, kv_pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# prefill_extend
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Tp,S", [(48, 24), (40, 1), (16, 77)])
def test_prefill_extend_matches_reference(models, Tp, S):
    """The reference prefills Tp tokens with ``return_kv`` and extends by S;
    the port extends the same tokens in place in buffers whose first Tp
    tokens hold the reference's prefix K/V and whose tail past Tp + S is
    NaN (never read): logits within 1e-4, the state's integer leaves
    (selected pages, ring positions, lengths, pos) equal and its float
    leaves within 1e-4, the suffix's K/V written into the buffers within
    1e-4 of the reference's and the prefix's left as it was."""
    jcfg, cfg, jp, p = models
    fkv, jfkv, max_len = FreeKVConfig(**FKV), JFreeKVConfig(**FKV), 160
    toks = _prompt(cfg, Tp + S, seed=Tp)[None]
    _, _, jkv = jmodel.prefill(jcfg, jfkv, jp, {"tokens": jnp.asarray(toks[:, :Tp])}, max_len,
                               state_dtype=jnp.float32, return_kv=True, build_state=False)
    jlog, jst, jsuf = jmodel.prefill_extend(jcfg, jfkv, jp, {"tokens": jnp.asarray(toks[:, Tp:])},
                                            jkv, max_len, state_dtype=jnp.float32)
    jk, jv = jkv["pattern"][0]
    bufs = []
    for i in range(cfg.n_layers):
        pair = tuple(torch.full((1, Tp + S + 5, cfg.n_kv_heads, cfg.d_head), float("nan"))
                     for _ in range(2))
        for buf, j in zip(pair, (jk, jv)):
            buf[:, :Tp] = torch.from_numpy(np.array(j[i]))
        bufs.append(pair)
    suffix = {"tokens": torch.from_numpy(toks[:, Tp:]).long()}
    log, st = model.prefill_extend(cfg, fkv, p, suffix, bufs, Tp, max_len,
                                   state_dtype=torch.float32)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **PARITY)
    assert st["pos"].tolist() == st["pos_host"].tolist() == np.asarray(jst["pos"]).tolist()
    for i in range(cfg.n_layers):
        jl = {k: np.asarray(a[i]) for k, a in jst["pattern"][0].items()}
        assert set(st["layers"][i]) == set(jl)
        for key, t in st["layers"][i].items():
            if t.dtype in (torch.int32, torch.int64, torch.int8):
                np.testing.assert_array_equal(t.numpy(), jl[key], err_msg=key)
            else:
                np.testing.assert_allclose(t.numpy(), jl[key], err_msg=key, **PARITY)
        for a, b, j in zip(bufs[i], jsuf["pattern"][0], (jk, jv)):
            np.testing.assert_array_equal(a[:, :Tp].numpy(), np.asarray(j[i]))
            np.testing.assert_allclose(a[:, Tp:Tp + S].numpy(), np.asarray(b[i]), **PARITY)


def test_prefill_returns_kv_and_skips_state(models):
    """``prefill(return_kv=True)`` hands back each layer's post-RoPE K/V,
    equal to the reference's; ``build_state=False`` returns no state, even
    for a prompt shorter than the window ring."""
    jcfg, cfg, jp, p = models
    fkv, jfkv = FreeKVConfig(**FKV), JFreeKVConfig(**FKV)
    toks = _prompt(cfg, 5, seed=2)[None]
    logits, state, kv = model.prefill(cfg, fkv, p, {"tokens": torch.from_numpy(toks).long()},
                                      64, state_dtype=torch.float32, return_kv=True,
                                      build_state=False)
    jlog, _, jkv = jmodel.prefill(jcfg, jfkv, jp, {"tokens": jnp.asarray(toks)}, 64,
                                  state_dtype=jnp.float32, return_kv=True, build_state=False)
    assert state is None and len(kv) == cfg.n_layers
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), **PARITY)
    for i, (k, v) in enumerate(kv):
        assert k.shape == (1, 5, cfg.n_kv_heads, cfg.d_head)
        np.testing.assert_allclose(k.numpy(), np.asarray(jkv["pattern"][0][0][i]), **PARITY)
        np.testing.assert_allclose(v.numpy(), np.asarray(jkv["pattern"][0][1][i]), **PARITY)


# ---------------------------------------------------------------------------
# the continuous engine with chunked prefill, against the JAX engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(models):
    """Each scenario of the reference's ``tests/test_chunked_prefill.py``
    through both engines, once."""
    jcfg, cfg, jp, p = models
    rng = np.random.default_rng(1)
    short = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (10, 12)]
    shared = rng.integers(0, cfg.vocab_size, 64).astype(np.int32)
    waves = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, 24).astype(np.int32)])
             for _ in range(2)]

    jax_engine = {b: _jax_engines(jcfg, jp, b) for b in (1, 2)}

    def gen(prompts, chunk=0, overlap=True, cache=0, batch=2):
        kw = dict(FKV, recall_overlap=overlap, prefill_chunk_tokens=chunk)
        jeng = jax_engine[batch](overlap, chunk=chunk, prefix_tokens=cache)
        eng = ServeEngine(cfg, FreeKVConfig(**kw), p, max_len=256, batch_size=batch,
                          prefill_bucket=BUCKET, prefix_cache_tokens=cache, device="cpu")
        out = []
        for e, R in ((jeng, JRequest), (eng, Request)):
            toks = [o.tokens for o in e.generate([R(uid=i, tokens=t, max_new_tokens=MAX_NEW)
                                                  for i, t in enumerate(prompts)])]
            out.append((toks, e.last_metrics))
        return out

    out = {f"short/{b}": gen(short, chunk=b) for b in (0, 1, BUCKET, 10 ** 6)}
    out["sync/0"] = gen(short, overlap=False)
    out[f"sync/{BUCKET}"] = gen(short, chunk=BUCKET, overlap=False)
    # serial admission: the second wave opens after the first's K/V is cached
    for b in (0, BUCKET):
        out[f"cache/{b}"] = gen(waves, chunk=b, cache=4096, batch=1)
    out["cache/cold"] = gen(waves, batch=1)
    return out


@pytest.mark.parametrize("case", ["short/0", "short/1", f"short/{BUCKET}", "short/1000000",
                                  "sync/0", f"sync/{BUCKET}", "cache/0", f"cache/{BUCKET}",
                                  "cache/cold"])
def test_chunked_engine_matches_reference(runs, case):
    """Greedy tokens, decode steps, active slot-steps, prefill_chunks,
    prefill_chunk_tokens and per-request prefix-hit tokens exactly equal to
    the JAX engine's."""
    (jtoks, jem), (toks, em) = runs[case]
    assert toks == jtoks
    assert [len(t) for t in toks] == [MAX_NEW] * len(toks)
    assert em.steps == jem.steps
    assert em.active_slot_steps == jem.active_slot_steps
    assert em.prefill_chunks == jem.prefill_chunks
    assert em.prefill_chunk_tokens == jem.prefill_chunk_tokens
    assert [m.prefix_hit_tokens for m in em.requests] == \
        [m.prefix_hit_tokens for m in jem.requests]
    assert [m.padded_prompt_tokens for m in em.requests] == \
        [m.padded_prompt_tokens for m in jem.requests]


def test_chunked_outputs_equal_whole_shot(runs):
    """In the port as in the reference: every budget gives the whole-shot
    tokens and the same decode work; every padded prompt token is chunked
    once, in ceil(padded / budget) chunks a request."""
    base, em0 = runs["short/0"][1]
    padded = [m.padded_prompt_tokens for m in em0.requests]
    assert em0.prefill_chunks == em0.prefill_chunk_tokens == 0
    for b in (1, BUCKET, 10 ** 6):
        toks, em = runs[f"short/{b}"][1]
        assert toks == base
        assert em.active_slot_steps == em0.active_slot_steps
        assert em.prefill_chunk_tokens == sum(padded)
        assert em.prefill_chunks == sum(-(-n // b) for n in padded)
    assert runs["short/1"][1][1].steps > em0.steps      # decode interleaves with the chunks
    assert runs[f"sync/{BUCKET}"][1][0] == runs["sync/0"][1][0] == base


def test_chunked_prefix_hit_chunks_only_the_suffix(runs):
    """A cache hit seeds the job with the cached span: tokens equal to the
    cold run, the second wave hits, and only the missed tokens are chunked;
    the summary's scheduling and prefix_cache sections say so."""
    cold, _ = runs["cache/cold"][1]
    whole, em0 = runs["cache/0"][1]
    chunked, em = runs[f"cache/{BUCKET}"][1]
    assert whole == cold == chunked
    hits = [m.prefix_hit_tokens for m in em.requests]
    assert hits == [m.prefix_hit_tokens for m in em0.requests] and hits[1] >= 64
    missed = sum(m.padded_prompt_tokens - m.prefix_hit_tokens for m in em.requests)
    s = em.summary()
    assert em.prefill_chunk_tokens == s["scheduling"]["prefill_chunk_tokens"] == missed
    assert s["prefix_cache"]["hits"] == 1 and s["prefix_cache"]["hit_tokens"] >= 64


def test_chunked_prefill_spans_and_gaps(models):
    """With observability on, each chunk is an ``engine/prefill_chunk``
    span with its tokens, and the token gaps are counted."""
    _, cfg, _, p = models
    eng = ServeEngine(cfg, FreeKVConfig(**FKV, prefill_chunk_tokens=16), p, max_len=128,
                      batch_size=2, prefill_bucket=BUCKET, obs=Observability.full(),
                      device="cpu")
    eng.generate([Request(uid=i, tokens=_prompt(cfg, n, seed=i), max_new_tokens=5)
                  for i, n in enumerate((40, 33, 20))])
    spans = [e for e in eng.obs.trace.chrome_trace()["traceEvents"]
             if e.get("name") == "engine/prefill_chunk"]
    em = eng.last_metrics
    assert len(spans) == em.prefill_chunks == 3 + 3 + 2
    assert sum(e["args"]["tokens"] for e in spans) == em.prefill_chunk_tokens == 40 + 40 + 24
    assert em.summary()["scheduling"]["token_gap_s"]["count"] == 3 * 4


# ---------------------------------------------------------------------------
# preemption: the scheduler with a fake backend
# ---------------------------------------------------------------------------
@dataclass
class FakeReq:
    uid: int
    tokens: np.ndarray
    max_new_tokens: int
    priority: int = 0
    eos_token: Optional[int] = None


def _tok(uid: int, count: int) -> int:
    """A token from (request, position) only, so neither placement nor
    preemption can change a request's stream."""
    return int((uid * 2654435761 + 12345 + count * 97) % 9973)


class FakeJob:
    def __init__(self, backend, req):
        self.backend, self.req = backend, req
        self.seq = tuple(int(t) for t in req.tokens)
        self.pos = 0
        self.result = None

    @property
    def done(self):
        return self.result is not None

    def advance(self, budget: int) -> int:
        assert not self.done and budget > 0
        n = min(int(budget), len(self.seq) - self.pos)
        self.pos += n
        if self.pos == len(self.seq):
            self.result = self.backend.prefill_one(self.req)
        return n


class FakePool:
    """The slot pool's surface the scheduler touches; a state is a uid and a
    payload whose size depends on the request, so swap bytes are checkable."""

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self.device = torch.device("cpu")
        self.state = {"slots": [None] * num_slots}
        self.owner: List[Optional[int]] = [None] * num_slots
        self._free = list(range(num_slots - 1, -1, -1))
        self.swaps = 0

    @property
    def free_count(self):
        return len(self._free)

    def alloc(self, uid, hold=False):
        slot = self._free.pop()
        assert self.owner[slot] is None, f"slot {slot} double-allocated"
        self.owner[slot] = uid
        return slot

    def free(self, slot):
        assert self.owner[slot] is not None
        self.owner[slot] = None
        self._free.append(slot)

    def flush_resets(self):
        pass

    def insert(self, src, slot):
        self.state["slots"][slot] = src

    def swap_out(self, slot):
        host = self.state["slots"][slot]
        assert host is not None
        self.state["slots"][slot] = None
        self.swaps += 1
        return host

    def swap_in(self, host, slot):
        self.state["slots"][slot] = host


@dataclass
class FakeBackend:
    """The synchronous path of the scheduler's backend protocol; a slot's
    logits carry its state's uid, and its tokens depend on (uid, count)."""
    prefill_chunk_tokens: int = 0
    preempt: bool = False
    page_block_bytes: int = 1024
    sync_interval: int = 1
    sample_on_device: bool = False
    obs: Observability = field(default_factory=Observability.off)
    states: dict = field(default_factory=dict)

    def __post_init__(self):
        from repro_torch.core.recall_pipeline import RecallFlightTracker
        self.recall_tracker = RecallFlightTracker()

    def prefill_one(self, req, pool=None, slot=None):
        st = {"uid": torch.full((1,), req.uid, dtype=torch.int64),
              "payload": torch.zeros((req.uid % 3 + 1, 4))}
        self.states[req.uid] = st
        return torch.full((1, 1), float(req.uid)), st, 0, len(req.tokens)

    def start_prefill_job(self, req, pool=None, slot=None):
        return FakeJob(self, req)

    def sample_slot(self, logits, key, count):
        return torch.tensor([_tok(int(logits[0, 0]), count)])

    def sample_lanes(self, logits, keys, counts):
        return torch.tensor([_tok(int(u), int(c)) for u, c in zip(logits[:, 0], counts)])

    def step(self, state, tokens):
        # every occupied slot still holds its own request's state
        uids = []
        for st in state["slots"]:
            if st is not None:
                assert st is self.states[int(st["uid"][0])]
            uids.append(-1 if st is None else int(st["uid"][0]))
        B = len(uids)
        stats = {k: torch.zeros(B) for k in DECODE_STAT_KEYS}
        return torch.tensor(uids, dtype=torch.float32)[:, None], state, stats


def _fake_run(reqs, num_slots, chunk, preempt):
    backend = FakeBackend(prefill_chunk_tokens=chunk, preempt=preempt)
    pool = FakePool(num_slots)
    done, em = ContinuousScheduler(backend, pool).run(
        [dataclasses.replace(r) for r in reqs])
    return done, em, pool


def _check_scenario(seed, n_req, num_slots, chunk, max_prio, preempt):
    """The reference's state-machine invariants (``tests/test_preemption.py``)."""
    rng = np.random.default_rng(seed)
    reqs = [FakeReq(uid=i, tokens=rng.integers(0, 5000, rng.integers(1, 20)).astype(np.int32),
                    max_new_tokens=int(rng.integers(0, 9)),
                    priority=int(rng.integers(0, max_prio + 1))) for i in range(n_req)]
    done, em, pool = _fake_run(reqs, num_slots, chunk, preempt)
    base, em0, _ = _fake_run(reqs, num_slots, 0, False)
    assert [tr.req.uid for tr in done] == [r.uid for r in reqs]
    for tr, r in zip(done, reqs):
        assert tr.state == "done" and tr.host_state is None
        assert tr.tokens == [_tok(r.uid, i) for i in range(r.max_new_tokens)]
    assert [tr.tokens for tr in done] == [tr.tokens for tr in base]
    admitted = [r for r in reqs if r.max_new_tokens > 0]
    assert em.active_slot_steps == em0.active_slot_steps == \
        sum(r.max_new_tokens - 1 for r in admitted)
    assert pool.free_count == pool.num_slots and all(o is None for o in pool.owner)
    assert em.preemptions == em.resumes == pool.swaps
    assert em.swap_out_bytes == em.swap_in_bytes
    assert sum(tr.metrics.preemptions for tr in done) == em.preemptions
    if not preempt or max_prio == 0:
        assert em.preemptions == 0
    if chunk > 0:
        assert em.prefill_chunk_tokens == sum(len(r.tokens) for r in admitted)
        assert em.prefill_chunks >= len(admitted)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("num_slots,chunk,max_prio,preempt", [
    (1, 0, 2, True), (2, 3, 2, True), (3, 1, 1, True), (2, 0, 0, True), (4, 6, 2, True),
    (2, 4, 0, False),
])
def test_scheduler_state_machine(seed, num_slots, chunk, max_prio, preempt):
    """Random traffic through the port's scheduler with admissions, chunks,
    preemptions and resumes interleaved: no slot held twice, every request
    finishes with the tokens of a run without chunks or preemption, and the
    counters conserve."""
    _check_scenario(seed, n_req=2 + (seed * 3 + num_slots) % 7, num_slots=num_slots,
                    chunk=chunk, max_prio=max_prio, preempt=preempt)


def test_priority_preempts_lowest_and_resumes():
    """The reference's directed scenario: a late high-priority request takes
    the slot of the lowest-priority running request, which resumes with an
    unchanged stream; equal priorities never preempt."""
    reqs = [FakeReq(0, np.arange(6, dtype=np.int32), 6, priority=0),
            FakeReq(1, np.arange(8, dtype=np.int32), 6, priority=1),
            FakeReq(2, np.arange(4, dtype=np.int32), 3, priority=2)]
    done, em, _ = _fake_run(reqs, num_slots=2, chunk=0, preempt=True)
    assert em.preemptions == 1
    by_uid = {tr.req.uid: tr for tr in done}
    assert [by_uid[u].metrics.preemptions for u in (0, 1, 2)] == [1, 0, 0]
    assert by_uid[2].metrics.finish_step <= by_uid[0].metrics.finish_step
    assert by_uid[2].metrics.priority == 2
    base, _, _ = _fake_run(reqs, num_slots=2, chunk=0, preempt=False)
    assert [tr.tokens for tr in done] == [tr.tokens for tr in base]
    same = [FakeReq(i, np.arange(4, dtype=np.int32), 4, priority=1) for i in range(3)]
    assert _fake_run(same, num_slots=2, chunk=0, preempt=True)[1].preemptions == 0


# ---------------------------------------------------------------------------
# preemption: the real engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def preempt_runs(models):
    """The reference's mixed-priority traffic (``tests/test_preemption.py``)
    through both engines."""
    jcfg, cfg, jp, p = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (40, 64, 24)]

    jax_engine = _jax_engines(jcfg, jp, 2)

    def gen(**kw):
        jeng = jax_engine(kv_quant=kw.get("kv_quant", "none"),
                          chunk=kw.get("prefill_chunk_tokens", 0),
                          preempt=kw.get("preempt", False))
        kw = dict(FKV, **kw)
        eng = ServeEngine(cfg, FreeKVConfig(**kw), p, max_len=256, batch_size=2,
                          prefill_bucket=BUCKET, device="cpu")
        out = []
        for e, R in ((jeng, JRequest), (eng, Request)):
            toks = [o.tokens for o in e.generate([R(uid=i, tokens=t, max_new_tokens=10,
                                                    priority=int(i == 2))
                                                  for i, t in enumerate(prompts)])]
            out.append((toks, e.last_metrics))
        return out

    runs = {"base/none": gen()}
    runs["pre/none"] = gen(preempt=True)
    runs["pre/int8"] = gen(preempt=True, kv_quant="int8")
    runs["both/none"] = gen(preempt=True, prefill_chunk_tokens=BUCKET)
    return runs


@pytest.mark.parametrize("case", ["pre/none", "pre/int8", "both/none"])
def test_preemption_matches_reference(preempt_runs, case):
    """Preemption fires; tokens, preemptions, resumes and the swapped bytes
    out and in exactly equal to the JAX engine's; the tokens equal the run
    without preemption; the urgent request is never the victim."""
    (jtoks, jem), (toks, em) = preempt_runs[case]
    assert toks == jtoks == preempt_runs["base/none"][1][0]
    assert em.preemptions == jem.preemptions >= 1
    assert em.resumes == jem.resumes == em.preemptions
    assert em.swap_out_bytes == em.swap_in_bytes == jem.swap_out_bytes > 0
    assert em.swap_in_bytes == jem.swap_in_bytes
    assert em.prefill_chunks == jem.prefill_chunks
    pm = {m.uid: m for m in em.requests}
    assert pm[2].preemptions == 0 and pm[0].preemptions + pm[1].preemptions == em.preemptions
    s = em.summary()["scheduling"]
    assert (s["preemptions"], s["resumes"], s["swap_out_bytes"]) == \
        (em.preemptions, em.resumes, em.swap_out_bytes)


@pytest.mark.parametrize("kv_quant", ["none", "int8", "int4"])
def test_slot_swap_roundtrip_exact(models, kv_quant):
    """``swap_out`` -> ``swap_in`` into another slot reproduces every leaf
    bit for bit at its stored dtype (the packed int8/int4 pool and its
    float32 scales move as stored), the selection buffers, qprev, rings,
    pos and pos_host included, after decode steps."""
    _, cfg, _, p = models
    kw = dict(FKV, kv_quant=kv_quant, quant_group_size=16 if kv_quant == "int4" else 0)
    eng = ServeEngine(cfg, FreeKVConfig(**kw), p, max_len=128, batch_size=2,
                      prefill_bucket=BUCKET, device="cpu")
    pool = eng.make_slot_pool(2)
    req = Request(uid=9, tokens=_prompt(cfg, 48, seed=3), max_new_tokens=4)
    logits, st, _, _ = eng.prefill_one(req, pool, 0)
    pool.insert(st, 0)
    cur = torch.argmax(logits, dim=-1).expand(2)[:, None].contiguous()
    for _ in range(3):
        logits, pool.state, _ = eng.step(pool.state, cur)
        cur = torch.argmax(logits, dim=-1)[:, None]
    before = pool.extract(0)
    host = pool.swap_out(0)
    for k in ("pos", "pos_host"):
        assert host[k].dtype == before[k].dtype
    for hl, bl in zip(host["layers"], before["layers"]):
        assert set(hl) == set(bl)
        for k in hl:
            assert hl[k].device.type == "cpu" and hl[k].dtype == bl[k].dtype, k
    if kv_quant != "none":
        assert host["layers"][0]["pool"].dtype == torch.int8
        assert host["layers"][0]["pool_scale"].dtype == torch.float32
    pool.swap_in(host, 1)
    after = pool.extract(1)
    for k in ("pos", "pos_host"):
        assert torch.equal(before[k], after[k])
    for bl, al in zip(before["layers"], after["layers"]):
        for k in bl:
            assert torch.equal(bl[k], al[k]), k
