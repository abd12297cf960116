"""The port's speculative decoding held against the reference's on the CPU
(``tests/test_spec_decode.py``'s setup: smollm-360m-smoke, page 8, budget
48, sink 8, window 8, tau 0.8, the reference's weights through
``params_from_jax``).

Tokens of ``draft_len`` 0, 2 and 4 equal the reference's synchronous
tokens for recall overlap on and off and ``kv_quant`` none and int8; an
eos accepted inside a drafted block truncates where the per-step path
stops; a rollback followed by a preempt-and-swap round trip resumes bit for
bit; a ``draft_hint`` raises the accept rate without changing a token;
unsupported configurations fall back to ``draft_len=0``; sampled tokens of
``draft_len`` 2 equal ``draft_len`` 0's and the reference's. The
``specdec`` counters equal the reference's: on the CPU the window stops
where the reference's loop does. Units: the drafter and the ring
snapshot/restore against the reference's, and a verify pass's rows
against single steps, bit for bit. The JAX engines run once a module."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import FreeKVConfig as JFreeKVConfig
from repro.core import drafter as jdrafter
from repro.core import retrieval as jretrieval
from repro.models import model as jmodel
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.sampling import SamplerConfig as JSamplerConfig
from repro_torch.configs import get_config
from repro_torch.configs.base import FreeKVConfig
from repro_torch.core import drafter, retrieval
from repro_torch.models import model
from repro_torch.obs import Observability
from repro_torch.obs.trace import SPAN_SPEC_VERIFY, TraceRecorder
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.sampling import SamplerConfig

torch.set_float32_matmul_precision("highest")
FKV = dict(method="freekv", page_size=8, budget=48, n_sink=8, n_window=8, tau=0.8)


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jget_config("smollm-360m-smoke"), get_config("smollm-360m-smoke")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, model.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _prompt(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, n).astype(np.int32)


def _turnover(cls, cfg, n=5):
    """Mixed lengths over two slots: slots turn over mid-run."""
    return [cls(uid=i, tokens=_prompt(cfg, 48 + 8 * (i % 2), seed=i),
                max_new_tokens=3 if i % 2 else 7) for i in range(n)]


def _jrun(models, reqs, batch_size=2, temperature=0.0, obs=None, **kw):
    jcfg, _, jp, _ = models
    eng = JServeEngine(jcfg, JFreeKVConfig(**{**FKV, **kw}), jp, max_len=256,
                       batch_size=batch_size, sampler=JSamplerConfig(temperature=temperature),
                       prefill_bucket=8, **({"obs": obs} if obs is not None else {}))
    return {o.uid: o.tokens for o in eng.generate(reqs)}, eng.last_metrics


def _run(models, reqs, batch_size=2, temperature=0.0, scheduler="continuous", obs=None,
         **kw):
    _, cfg, _, p = models
    eng = ServeEngine(cfg, FreeKVConfig(**{**FKV, **kw}), p, max_len=256,
                      batch_size=batch_size, sampler=SamplerConfig(temperature=temperature),
                      prefill_bucket=8, scheduler=scheduler, obs=obs, device="cpu")
    return {o.uid: o.tokens for o in eng.generate(reqs)}, eng.last_metrics, eng


def _spec(draft_len, **kw):
    return dict(draft_len=draft_len, sample_on_device=True, sync_interval=8, **kw)


@pytest.fixture(scope="module")
def sync_refs(models):
    """The reference's synchronous tokens a (recall_overlap, kv_quant)."""
    cfg = models[1]
    return {(ov, q): _jrun(models, _turnover(JRequest, cfg), recall_overlap=ov, kv_quant=q,
                           sample_on_device=False)[0]
            for ov in (True, False) for q in ("none", "int8")}


# ---------------------------------------------------------------------------
# tokens: draft_len 0/2/4 x overlap x kv_quant against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("draft_len", [0, 2, 4])
def test_spec_tokens_equal_reference(models, sync_refs, overlap, quant, draft_len):
    cfg = models[1]
    toks, em, eng = _run(models, _turnover(Request, cfg),
                         **_spec(draft_len, recall_overlap=overlap, kv_quant=quant))
    assert toks == sync_refs[(overlap, quant)]
    assert eng.spec_decode == (draft_len > 0)
    sd = em.summary()["specdec"]
    assert sd["draft_len"] == draft_len
    assert em.summary()["dispatch"]["nonsync_host_bytes"] == 0.0
    if draft_len:
        assert sd["verify_steps"] > 0 and sd["committed_tokens"] == sum(
            len(t) - 1 for t in toks.values())


def test_spec_counts_equal_reference(models, sync_refs):
    """draft_len 3 with telemetry on: the specdec counters and histogram
    equal the reference's (the CPU window stops where its loop stops, so
    no idle iteration runs), the conservation laws hold, and every verify
    iteration opened one ``engine/spec_verify`` span."""
    from repro.obs import Observability as JObs
    from repro.obs import TraceRecorder as JTrace
    cfg = models[1]
    jtoks, jem = _jrun(models, _turnover(JRequest, cfg), obs=JObs(enabled=True,
                                                                   trace=JTrace(enabled=True)),
                       **_spec(3))
    obs = Observability(enabled=True, trace=TraceRecorder(enabled=True))
    toks, em, eng = _run(models, _turnover(Request, cfg), obs=obs, **_spec(3))
    assert toks == jtoks == sync_refs[(True, "none")]
    sd, jsd = em.summary()["specdec"], jem.summary()["specdec"]
    for k in ("draft_len", "verify_steps", "proposed_tokens", "accepted_tokens",
              "committed_tokens", "accept_rate", "tokens_per_step"):
        assert sd[k] == jsd[k], k
    for k in ("count", "sum", "min", "max"):
        assert sd["tokens_per_step_hist"][k] == jsd["tokens_per_step_hist"][k], k
    assert sd["idle_iterations"] == 0
    assert sd["committed_tokens"] == sum(len(t) - 1 for t in toks.values())
    slot_steps = sd["proposed_tokens"] / 3
    assert sd["accepted_tokens"] == sd["committed_tokens"] - slot_steps
    spans = [e for e in obs.trace.events if e.get("name") == SPAN_SPEC_VERIFY]
    assert len(spans) == sd["verify_steps"]
    assert sum(s["args"]["committed"] for s in spans) == sd["committed_tokens"]
    # the steps follow the committed rows, as the reference's
    assert em.steps == jem.steps


def test_eos_accepted_mid_draft(models):
    cfg = models[1]
    prompt = _prompt(cfg, 64, seed=5)
    full, _ = _jrun(models, [JRequest(uid=0, tokens=prompt, max_new_tokens=8)], batch_size=1,
                    sample_on_device=False)
    eos = full[0][2]
    cut = full[0].index(eos) + 1
    toks, _, _ = _run(models, [Request(uid=0, tokens=prompt, max_new_tokens=8, eos_token=eos)],
                      batch_size=1, **_spec(4))
    assert toks[0] == full[0][:cut] and toks[0][-1] == eos


def test_rollback_then_preempt_roundtrip(models):
    """Preemption under spec decoding: the victim's state, its drafter
    table and post-rollback rings aboard, swaps to the host and resumes bit
    for bit; the swap counts the table's bytes both ways."""
    cfg = models[1]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (40, 64, 24)]

    def mk(cls):
        return [cls(uid=i, tokens=p, max_new_tokens=10, priority=(1 if i == 2 else 0))
                for i, p in enumerate(prompts)]
    base, _ = _jrun(models, mk(JRequest), sample_on_device=False)
    toks, em, eng = _run(models, mk(Request), **_spec(3, preempt=True))
    assert toks == base
    assert em.preemptions >= 1 and em.resumes == em.preemptions
    assert em.swap_out_bytes == em.swap_in_bytes > 0
    assert em.summary()["specdec"]["verify_steps"] > 0
    tab_bytes = eng._pool.state["draft_tab"][0].numel() * 4
    _, em0, _ = _run(models, mk(Request), **_spec(0, preempt=True))
    assert em.swap_out_bytes - em0.swap_out_bytes == em.preemptions * tab_bytes


def test_draft_hint_raises_accept_not_outputs(models):
    cfg = models[1]
    prompt = _prompt(cfg, 48, seed=11)

    def mk(hint=None):
        return [Request(uid=0, tokens=prompt, max_new_tokens=32, draft_hint=hint)]
    base, _ = _jrun(models, [JRequest(uid=0, tokens=prompt, max_new_tokens=32)], batch_size=1,
                    sample_on_device=False)
    cold, em_cold, _ = _run(models, mk(), batch_size=1, **_spec(4))
    hint = np.concatenate([prompt[-1:], np.asarray(base[0], np.int32)])
    warm, em_warm, _ = _run(models, mk(hint), batch_size=1, **_spec(4))
    assert cold == warm == base
    cold_acc = em_cold.summary()["specdec"]["accept_rate"]
    warm_acc = em_warm.summary()["specdec"]["accept_rate"]
    assert warm_acc > cold_acc, (cold_acc, warm_acc)
    assert em_warm.spec_verify_steps < em_cold.spec_verify_steps


def test_unsupported_configs_fall_back(models):
    """The static scheduler, host sampling and methods outside the FreeKV
    family serve draft_len=0, with no drafter lane."""
    _, cfg, _, p = models

    def eng(scheduler="continuous", **kw):
        return ServeEngine(cfg, FreeKVConfig(**{**FKV, **_spec(4), **kw}), p, max_len=128,
                           batch_size=2, scheduler=scheduler, device="cpu")
    assert model.supports_spec_decode(cfg, FreeKVConfig(**FKV, draft_len=4))
    e = eng()
    assert e.spec_decode and e.draft_len == 4 and "draft_tab" in e.make_slot_pool(2).state
    for e in (eng(scheduler="static"), eng(sample_on_device=False), eng(method="quest"),
              eng(method="centroid"), eng(method="shadowkv")):
        assert not e.spec_decode and e.draft_len == 0 and e.fkv.draft_len == 0
        assert "draft_tab" not in e.make_slot_pool(2).state
    for m in ("arkvale", "infinigen"):
        assert eng(method=m).spec_decode


def test_fallback_tokens_equal_reference(models):
    """The static scheduler with draft_len 4 serves draft_len=0, on
    equal-length traffic, equal to the reference's static tokens."""
    cfg = models[1]

    def mk(cls):
        return [cls(uid=i, tokens=_prompt(cfg, 48, seed=i), max_new_tokens=3 if i % 2 else 7)
                for i in range(5)]
    jcfg, _, jp, _ = models
    jeng = JServeEngine(jcfg, JFreeKVConfig(**FKV, draft_len=4), jp, max_len=256, batch_size=2,
                        sampler=JSamplerConfig(), prefill_bucket=8, scheduler="static")
    ref = {o.uid: o.tokens for o in jeng.generate(mk(JRequest))}
    toks, em, eng = _run(models, mk(Request), scheduler="static", **_spec(4))
    assert toks == ref and not eng.spec_decode


def test_sampled_spec_equals_draft_len_0(models):
    """Temperature 0.8: row j of a verify pass draws with ``fold_in(key,
    count + j)``, so draft_len 2 emits draft_len 0's tokens, which are the
    reference's synchronous ones."""
    cfg = models[1]
    ref, _ = _jrun(models, _turnover(JRequest, cfg), temperature=0.8, sample_on_device=False)
    t0, _, _ = _run(models, _turnover(Request, cfg), temperature=0.8, **_spec(0))
    t2, em, _ = _run(models, _turnover(Request, cfg), temperature=0.8, **_spec(2))
    assert t2 == t0 == ref
    assert em.summary()["specdec"]["verify_steps"] > 0


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------
def test_drafter_equals_reference():
    rng = np.random.default_rng(0)
    B, V = 3, 50
    prompt = rng.integers(0, V, 40)
    assert (drafter.seed_from_prompt(V, prompt) == jdrafter.seed_from_prompt(V, prompt)).all()
    tab = rng.integers(-1, V, (B, V)).astype(np.int32)
    cur = rng.integers(0, V, B).astype(np.int32)
    for L in (0, 1, 4):
        want = np.asarray(jdrafter.propose(jnp.asarray(tab), jnp.asarray(cur), L))
        got = drafter.propose(torch.from_numpy(tab), torch.from_numpy(cur), L).numpy()
        assert got.shape == want.shape and (got == want).all()
    for _ in range(5):
        toks = rng.integers(0, V, (B, 5)).astype(np.int32)
        toks[:, 2] = toks[:, 0]                    # a repeated source: the order matters
        emit = rng.random((B, 5)) < 0.6
        want = np.asarray(jdrafter.update(jnp.asarray(tab), jnp.asarray(toks), jnp.asarray(emit)))
        got = drafter.update(torch.from_numpy(tab.copy()), torch.from_numpy(toks),
                             torch.from_numpy(emit)).numpy()
        assert (got == want).all()
        tab = want.copy()


def test_ring_snapshot_restore_equal_reference():
    rng = np.random.default_rng(1)
    B, n_win, kv, d, S = 3, 16, 2, 4, 5
    st = {"win_k": rng.normal(size=(B, n_win, kv, d)).astype(np.float32),
          "win_v": rng.normal(size=(B, n_win, kv, d)).astype(np.float32),
          "win_pos": rng.integers(-1, 99, (B, n_win)).astype(np.int32),
          "length": np.array([14, 3, 30], np.int32)}
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    jsnap = jretrieval.ring_snapshot(jst, S)
    tsnap = retrieval.ring_snapshot(tst, S)
    for a, b in zip(jsnap, tsnap):
        assert (np.asarray(a) == b.numpy()).all()
    # the block writes every snapshotted slot, then some rows are rejected
    for key in ("win_k", "win_v"):
        new = rng.normal(size=(B, S, kv, d)).astype(np.float32)
        jst[key] = jst[key].at[jnp.arange(B)[:, None], jsnap[0]].set(new)
        tst[key][torch.arange(B)[:, None], tsnap[0]] = torch.from_numpy(new)
    keep = np.array([0, 2, 5], np.int32)
    jout = jretrieval.ring_restore(jst, jsnap, jnp.asarray(keep))
    tout = retrieval.ring_restore(tst, tsnap, torch.from_numpy(keep))
    for key in ("win_k", "win_v", "win_pos"):
        assert (np.asarray(jout[key]) == tout[key].numpy()).all(), key
    # the snapshot holds copies: the block's in-place writes did not reach it
    assert (tsnap[1].numpy() == st["win_k"][np.arange(B)[:, None], tsnap[0].numpy()]).all()


@pytest.mark.parametrize("method", ["freekv", "infinigen"])
def test_verify_rows_equal_single_steps(models, method):
    """Each row of a verify pass is bit for bit a ``serve_step`` from the
    same state (logits and stats), and rewinding every row committed
    leaves the state the steps leave."""
    _, cfg, _, p = models
    fkv = FreeKVConfig(**{**FKV, "method": method}, draft_len=3)
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 56))).long()}
    _, st0 = model.prefill(cfg, fkv, p, batch, max_len=128, state_dtype=torch.float32)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 4))).long()
    st_a = copy.deepcopy(st0)
    rows, srows = [], []
    for j in range(4):
        lg, st_a, s = model.serve_step(cfg, fkv, p, st_a, toks[:, j:j + 1], collect_stats=True)
        rows.append(lg)
        srows.append(s)
    st_b = copy.deepcopy(st0)
    logits, st_b, stats_rows, undo = model.serve_step_verify(cfg, fkv, p, st_b, toks)
    for j in range(4):
        assert torch.equal(logits[:, j], rows[j]), j
        for k in stats_rows:
            assert torch.equal(stats_rows[k][j], srows[j][k]), (j, k)
    st_b = model.rewind_state(cfg, fkv, st_b, undo, torch.full((2,), 4, dtype=torch.int32))
    assert torch.equal(st_b["pos"], st_a["pos"])
    for la, lb in zip(st_a["layers"], st_b["layers"]):
        for k in ("win_k", "win_v", "win_pos", "length", "sel_idx", "sel_k", "sel_v", "qprev",
                  "summ"):
            assert torch.equal(la[k], lb[k]), k


def test_rewind_restores_partial_commit(models):
    """Committing m < S rows leaves the state m single steps leave: rings,
    lengths and selection buffers (pool pages beyond the length may hold a
    rejected row's page). A lane with m = 0 (a finished one) gets its
    length and ring back; its selection lanes are row 0's, as in the
    reference, and nothing reads them."""
    _, cfg, _, p = models
    fkv = FreeKVConfig(**FKV, draft_len=4)
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 61))).long()}
    _, st0 = model.prefill(cfg, fkv, p, batch, max_len=128, state_dtype=torch.float32)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 5))).long()
    m = torch.tensor([1, 2, 5, 0], dtype=torch.int32)
    st_b = copy.deepcopy(st0)
    _, st_b, _, undo = model.serve_step_verify(cfg, fkv, p, st_b, toks)
    st_b = model.rewind_state(cfg, fkv, st_b, undo, m)
    for b in range(4):
        st_a = copy.deepcopy(st0)
        for j in range(int(m[b])):
            _, st_a = model.serve_step(cfg, fkv, p, st_a, toks[:, j:j + 1])
        assert int(st_b["pos"][b]) == 61 + int(m[b])
        keys = ("win_k", "win_v", "win_pos", "length") + (
            ("sel_idx", "sel_k", "sel_v", "qprev") if m[b] else ())
        for la, lb in zip(st_a["layers"], st_b["layers"]):
            for k in keys:
                assert torch.equal(la[k][b], lb[k][b]), (b, k)
