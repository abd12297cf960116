"""Live serving in the port, held against the reference on the CPU:
llama31-8b-smoke cut to 2 layers with the reference's weights
(``params_from_jax``), page_size 8, budget 64, prompts padded to 8-token
buckets, greedy.

* a scripted service, deterministic by scheduler round, submits requests
  over time and cancels them in the QUEUED, PREFILL (chunked budget 16),
  DECODE and SWAPPED (preempted) states; it drives both packages'
  ``ContinuousScheduler.run(service=...)``: the survivors' tokens, every
  request's terminal state and partial token count, and
  ``em.cancellations`` exactly equal;
* concurrent HTTP streams through the port's ``HttpFrontend`` give tokens
  equal to the JAX engine's direct ``generate`` of the same requests, with
  ``/healthz``, ``/metrics`` (Prometheus text) and ``/stats`` (the board's
  snapshot) answering while they run; a client that drops its socket is
  cancelled and its slot freed, the survivor's tokens unchanged; bad
  requests get 400 and 404;
* a worker failure reaches the waiting client as an ``error`` event and
  ``EngineService.stop()`` raises it; sixteen threads submitting and
  cancelling at once through one service (over the port's scheduler and a
  fake backend) lose no request and no token;
* the serve CLI's ``--metrics-out``/``--prom-out``/``--trace-out`` files
  pass the port's validators and the reference's ``tools/check_obs.py``.
"""
import dataclasses
import importlib.util
import json
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

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
from repro_torch.obs import (Observability, validate_chrome_trace, validate_snapshot,
                             validate_timeseries_snapshot)
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.frontend import (EngineService, http_generate, http_get_json,
                                          http_get_text, serve_http_background)
from repro_torch.serving.scheduler import CANCELLED

torch.set_float32_matmul_precision("highest")
ROOT = Path(__file__).resolve().parents[1]
FKV = dict(method="freekv", page_size=8, budget=64, n_sink=8, n_window=8, tau=0.8)
MAX_LEN, BUCKET, PROMPT = 256, 8, 48
# the scripted run: chunked prefill, preemption, two-step windows
SCRIPTED = dict(prefill_chunk_tokens=16, preempt=True, sync_interval=2)


def _llama2(get):
    return dataclasses.replace(get("llama31-8b-smoke"), n_layers=2, n_periods=2)


@pytest.fixture(scope="module")
def models():
    """The reference engine (compiled once; each run sets the scheduler's
    switches, which its compiled functions never read) and the port's
    weights."""
    jcfg, cfg = _llama2(jget_config), _llama2(get_config)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    jeng = JServeEngine(jcfg, JFreeKVConfig(**FKV, sync_interval=2), jp, max_len=MAX_LEN,
                        batch_size=2, prefill_bucket=BUCKET)
    params = model.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jeng, params


def _jax_engine(jeng, **switches):
    jeng.fkv = dataclasses.replace(jeng.fkv, prefill_chunk_tokens=switches.get(
        "prefill_chunk_tokens", 0), preempt=switches.get("preempt", False))
    return jeng


def _port_engine(cfg, params, obs=None, **kw):
    return ServeEngine(cfg, FreeKVConfig(**FKV, **kw), params, max_len=MAX_LEN, batch_size=2,
                       prefill_bucket=BUCKET, obs=obs, slo_ttft_ms=120_000.0,
                       slo_itl_ms=120_000.0, device="cpu")


def _prompt(cfg, uid):
    return np.random.default_rng(uid).integers(0, cfg.vocab_size, PROMPT).astype(np.int32)


def _direct(jeng, cfg, spec):
    """The reference engine's direct greedy tokens of (uid, max_new)."""
    reqs = [JRequest(uid=u, tokens=_prompt(cfg, u), max_new_tokens=m) for u, m in spec]
    return {c.uid: c.tokens for c in _jax_engine(jeng).generate(reqs, seed=0)}


# ---------------------------------------------------------------------------
# scheduled cancellations against the reference's scheduler
# ---------------------------------------------------------------------------
class ScriptedService:
    """The scheduler's service protocol, driven by round: ``script[r]``
    lists the ("submit", request) and ("cancel", uid) events of round r
    (a round is one ``poll``). No clock and no thread: both schedulers see
    the same events at the same rounds."""

    def __init__(self, script):
        self.script, self.round, self.last = script, 0, max(script)
        self.finish = {}
        self.tokens = {}

    def attach(self, em, t0):
        self.em = em

    def poll(self):
        self.round += 1
        return [x for kind, x in self.script.get(self.round - 1, ()) if kind == "submit"]

    def drain_cancels(self):
        return [x for kind, x in self.script.get(self.round - 1, ()) if kind == "cancel"]

    def wait(self, timeout):
        pass

    @property
    def closed(self):
        return self.round > self.last

    @property
    def pending(self):
        return any(r >= self.round for r in self.script)

    def emit_token(self, uid, index, token, t_rel, interpolated=False):
        got = self.tokens.setdefault(uid, [])
        assert index == len(got)
        got.append(token)

    def emit_finish(self, uid, tr):
        self.finish[uid] = {"state": tr.state, "tokens": list(tr.tokens),
                            "preemptions": tr.metrics.preemptions,
                            "prefill_started": tr.metrics.prefill_start_t is not None,
                            "cancelled": tr.metrics.cancelled}


def _script(cfg, cls):
    """Two slots. Request 2 arrives with both taken and is cancelled while
    QUEUED; priority-1 request 3 swaps request 1 out, which is cancelled
    while SWAPPED; request 0 is cancelled in DECODE, and request 4, admitted
    into its slot, while its chunked prefill runs; request 5 then reuses a
    cancelled request's slot. 3 and 5 survive."""
    def req(uid, m, prio=0):
        return cls(uid=uid, tokens=_prompt(cfg, uid), max_new_tokens=m, priority=prio)
    return {0: [("submit", req(0, 24)), ("submit", req(1, 24))],
            1: [("submit", req(2, 6))], 2: [("cancel", 2)],
            6: [("submit", req(3, 10, prio=1))], 8: [("cancel", 1)],
            9: [("submit", req(4, 8))], 11: [("cancel", 0)], 13: [("cancel", 4)],
            15: [("submit", req(5, 6))]}


@pytest.fixture(scope="module")
def scheduled(models):
    cfg, jeng, params = models
    jsvc = ScriptedService(_script(cfg, JRequest))
    jdone = _jax_engine(jeng, **SCRIPTED).serve_service(jsvc)
    jem = jeng.last_metrics
    eng = _port_engine(cfg, params, **SCRIPTED)
    svc = ScriptedService(_script(cfg, Request))
    outs = eng.serve_service(svc)
    return (jsvc, jdone, jem), (svc, outs, eng)


def test_scheduled_cancellations_match_reference(scheduled):
    (jsvc, jdone, jem), (svc, outs, eng) = scheduled
    em = eng.last_metrics
    assert svc.finish == jsvc.finish
    assert svc.tokens == jsvc.tokens
    assert [(c.uid, c.tokens) for c in outs] == [(c.uid, c.tokens) for c in jdone]
    assert em.cancellations == jem.cancellations == 4
    for key in ("steps", "preemptions", "resumes", "prefill_chunks", "host_syncs",
                "swap_out_bytes"):
        assert getattr(em, key) == getattr(jem, key), key
    assert em.summary()["completed"] == jem.summary()["completed"] == 2
    assert em.summary()["slo"]["cancelled"] == 4


def test_scheduled_cancellations_hit_every_state(scheduled):
    """Each cancelled request was cancelled in the state the script aims
    at, read off what it had when it ended: QUEUED (no prefill started),
    PREFILL (started, no token), DECODE (tokens, never swapped) and
    SWAPPED (tokens and a preemption); every slot is free at the end."""
    _, (svc, outs, eng) = scheduled
    f = svc.finish
    assert {u for u, r in f.items() if r["state"] == CANCELLED} == {0, 1, 2, 4}
    assert all(r["cancelled"] == (r["state"] == CANCELLED) for r in f.values())
    assert not f[2]["prefill_started"] and f[2]["tokens"] == []                  # QUEUED
    assert f[4]["prefill_started"] and f[4]["tokens"] == []                      # PREFILL
    assert len(f[0]["tokens"]) > 0 and f[0]["preemptions"] == 0                  # DECODE
    assert 0 < len(f[1]["tokens"]) < 24 and f[1]["preemptions"] == 1             # SWAPPED
    assert [len(f[u]["tokens"]) for u in (3, 5)] == [10, 6]
    assert eng._pool.owner == [None, None] and eng._pool.free_count == 2


def test_scheduled_survivors_equal_direct_run(models, scheduled):
    """The survivors' tokens equal the reference engine's direct run of the
    same requests, and a cancelled request's tokens are a prefix of its."""
    cfg, jeng, _ = models
    _, (svc, _, _) = scheduled
    direct = _direct(jeng, cfg, [(0, 24), (1, 24), (3, 10), (5, 6)])
    assert svc.tokens[3] == direct[3] and svc.tokens[5] == direct[5]
    for u in (0, 1):
        got = svc.finish[u]["tokens"]
        assert got == direct[u][:len(got)]


# ---------------------------------------------------------------------------
# HTTP front-end over the port's engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def http_engine(models):
    cfg, _, params = models
    return _port_engine(cfg, params, obs=Observability.full())


def _serve(eng):
    svc = EngineService(eng, seed=0).start()
    fe, stop, th = serve_http_background(svc)
    return svc, fe, stop, th


def _shutdown(svc, stop, th):
    stop.set()
    th.join(timeout=30)
    assert not th.is_alive()
    return svc.stop()


def _load_check_obs():
    spec = importlib.util.spec_from_file_location("check_obs", ROOT / "tools" / "check_obs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_http_streams_equal_reference_generate(models, http_engine):
    """Three concurrent streaming clients each get start -> token* -> done
    with in-order indexes, and tokens equal to the reference engine's direct
    ``generate`` of the same (uid, prompt, seed); ``/healthz``, ``/metrics``
    and ``/stats`` answer while they run."""
    cfg, jeng, _ = models
    eng = http_engine
    spec = [(0, 8), (1, 12), (2, 6)]
    svc, fe, stop, th = _serve(eng)
    results, errors = {}, []

    def client(uid, m):
        try:
            results[uid] = list(http_generate("127.0.0.1", fe.port, {
                "uid": uid, "tokens": _prompt(cfg, uid).tolist(), "max_new_tokens": m}))
        except Exception as e:                   # reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=s) for s in spec]
    for t in threads:
        t.start()
    deadline = time.time() + 60
    while svc.em is None and time.time() < deadline:
        time.sleep(0.01)                # the scheduler attaches its registry
    st, hz = http_get_json("127.0.0.1", fe.port, "/healthz")
    assert st == 200 and hz["ok"] is True and hz["engine_running"] is True
    st, prom = http_get_text("127.0.0.1", fe.port, "/metrics")
    assert st == 200 and "# TYPE" in prom
    assert _load_check_obs()._prometheus_lines(prom.splitlines(), "/metrics") == []
    st, stats = http_get_json("127.0.0.1", fe.port, "/stats")
    assert st == 200 and validate_timeseries_snapshot(stats) == []
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    _shutdown(svc, stop, th)
    assert errors == []
    em = eng.last_metrics
    assert em.registry.counter("requests_completed_total").value == 3
    slo = em.summary()["slo"]
    assert slo["tagged"] == 3 and slo["attainment"] == 1.0 and slo["goodput_tokens_per_s"] > 0
    direct = _direct(jeng, cfg, spec)
    for uid, m in spec:
        evs = results[uid]
        assert [e["event"] for e in evs] == ["start"] + ["token"] * m + ["done"]
        toks = evs[1:-1]
        assert [e["index"] for e in toks] == list(range(m))
        assert all("t" in e and "t_server" in e for e in toks)
        assert evs[-1]["tokens"] == [e["token"] for e in toks] == direct[uid]


def test_http_disconnect_cancels_and_frees_slot(models, http_engine):
    """A client that drops its socket mid-stream is cancelled: CANCELLED,
    its slot freed, ``sched_cancellations_total`` 1; a survivor admitted
    meanwhile gets the reference's tokens."""
    cfg, jeng, _ = models
    eng = http_engine
    svc, fe, stop, th = _serve(eng)
    body = json.dumps({"uid": 100, "tokens": _prompt(cfg, 100).tolist(),
                       "max_new_tokens": 160, "stream": True}).encode()
    s = socket.create_connection(("127.0.0.1", fe.port), timeout=60)
    s.sendall(b"POST /generate HTTP/1.1\r\nHost: t\r\nContent-Type: application/json\r\n"
              b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)
    buf = b""
    while buf.count(b'"event": "token"') < 2:
        chunk = s.recv(4096)
        assert chunk, "the server closed the stream early"
        buf += chunk
    s.close()                           # the client walks away
    evs = list(http_generate("127.0.0.1", fe.port, {
        "uid": 101, "tokens": _prompt(cfg, 101).tolist(), "max_new_tokens": 6}))
    assert evs[-1]["event"] == "done"
    deadline = time.time() + 30
    while svc.em.cancellations < 1 and time.time() < deadline:
        time.sleep(0.01)
    completions = _shutdown(svc, stop, th)
    em = eng.last_metrics
    assert em.cancellations == 1
    assert em.registry.snapshot()["counters"]["sched_cancellations_total"] == 1
    by_uid = {c.uid: c for c in completions}
    assert by_uid[100].metrics.cancelled is True and 2 <= len(by_uid[100].tokens) < 160
    assert by_uid[101].metrics.cancelled is False
    assert eng._pool.owner == [None, None]
    direct = _direct(jeng, cfg, [(100, 160), (101, 6)])
    assert evs[-1]["tokens"] == direct[101]
    assert by_uid[100].tokens == direct[100][:len(by_uid[100].tokens)]


@pytest.mark.parametrize("path,body,status", [
    ("/generate", {"tokens": []}, 400),
    ("/generate", {"tokens": [1] * 64, "max_new_tokens": 10_000}, 400),   # past max_len
    ("/generate", b"{not json", 400),
    ("/nope", None, 404),
])
def test_http_bad_requests(http_engine, path, body, status):
    import http.client
    svc, fe, stop, th = _serve(http_engine)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=30)
        if body is None:
            conn.request("GET", path)
        else:
            conn.request("POST", path, body=body if isinstance(body, bytes) else json.dumps(body),
                         headers={"Content-Type": "application/json"})
        assert conn.getresponse().status == status
        conn.close()
    finally:
        _shutdown(svc, stop, th)


class _FailingEngine:
    max_len = 64

    def serve_service(self, service, seed=0):
        while not service.pending:
            service.wait(0.01)
        raise RuntimeError("device lost")


def test_worker_failure_reaches_client_and_stop():
    svc = EngineService(_FailingEngine()).start()
    got = []
    done = threading.Event()
    svc.submit([1, 2, 3], 4, lambda kind, payload: (got.append((kind, payload)), done.set()))
    assert done.wait(30)
    assert got[0][0] == "error" and "device lost" in got[0][1]["error"]
    with pytest.raises(RuntimeError, match="engine worker failed"):
        svc.submit([1, 2, 3], 4, lambda *a: None)
    with pytest.raises(RuntimeError, match="device lost"):
        svc.stop()


class _FakeEngine:
    """The port's scheduler over ``test_torch_chunked``'s fake backend: a
    request's token i is ``_tok(uid, i)``, wherever it runs."""
    max_len = 1 << 20

    def __init__(self, num_slots):
        from test_torch_chunked import FakeBackend, FakePool
        self.backend, self.pool = FakeBackend(), FakePool(num_slots)

    def serve_service(self, service, seed=0):
        from repro_torch.serving.scheduler import ContinuousScheduler
        done, self.last_metrics = ContinuousScheduler(self.backend, self.pool).run(
            [], seed, service=service)
        return done


def test_service_concurrent_submit_and_cancel_loses_nothing():
    """Sixteen client threads at a 10 us switch interval submit ten
    requests each and cancel every third at once: every request ends
    exactly once, a finished one with all its tokens in order, a cancelled
    one with a prefix of them; the counts add up and every slot is free."""
    from test_torch_chunked import _tok
    eng = _FakeEngine(num_slots=3)
    svc = EngineService(eng).start()
    ends, errors = {}, []
    lock = threading.Lock()

    def client(k):
        rng = np.random.default_rng(k)
        for j in range(10):
            m = int(rng.integers(1, 6))
            got, end = [], threading.Event()

            def on_event(kind, payload, got=got, end=end):
                if kind == "token":
                    got.append(payload["token"])
                    return
                with lock:
                    if payload["uid"] in ends:
                        errors.append(("twice", payload["uid"]))
                    ends[payload["uid"]] = (kind, payload, list(got), m)
                end.set()

            uid = svc.submit([1, 2, 3], m, on_event)
            if j % 3 == 0:
                svc.cancel(uid)
            if not end.wait(60):
                errors.append(("no end", uid))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    done = svc.stop()
    assert errors == []
    assert sorted(ends) == list(range(160)) and len(done) == 160
    n_cancelled = 0
    for uid, (kind, payload, got, m) in ends.items():
        want = [_tok(uid, i) for i in range(m)]
        assert kind == "finish" and payload["tokens"] == got
        if payload["cancelled"]:
            n_cancelled += 1
            assert payload["state"] == CANCELLED and got == want[:len(got)]
        else:
            assert payload["state"] == "done" and got == want
    em = eng.last_metrics
    assert em.cancellations == n_cancelled and em.summary()["completed"] == 160 - n_cancelled
    assert eng.pool.free_count == 3


# ---------------------------------------------------------------------------
# the CLI's exported files
# ---------------------------------------------------------------------------
def test_serve_cli_exports_pass_validators(tmp_path, capsys):
    from repro_torch.launch import serve
    m, p, t = (tmp_path / n for n in ("m.jsonl", "m.prom", "t.json"))
    serve.main(["--device", "cpu", "--arch", "granite-3-8b-smoke", "--context", "64",
                "--new-tokens", "4", "--batch", "2", "--requests", "3", "--budget", "32",
                "--page-size", "8", "--slo-ttft-ms", "60000", "--metrics-out", str(m),
                "--prom-out", str(p), "--trace-out", str(t)])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["completed"] == 3 and summary["slo"]["tagged"] == 3
    assert validate_snapshot(json.loads(m.read_text())) == []
    trace = json.loads(t.read_text())
    assert validate_chrome_trace(trace) == []
    assert {"request/prefill", "engine/decode_window"} <= {e["name"] for e in trace["traceEvents"]}
    out = subprocess.run([sys.executable, str(ROOT / "tools" / "check_obs.py"), "--metrics",
                          str(m), "--prom", str(p), "--trace", str(t)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
