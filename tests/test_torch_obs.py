"""The port's observability held against the reference's on the CPU:

* the registry: the same counter, gauge and histogram operations give an
  equal ``snapshot()`` and the identical ``to_prometheus()`` text;
* the sliding-window board: the same seeded feed gives equal snapshots at
  several times across a window rotation; fed and read from many threads
  at once, it loses no event;
* the validators (``validate_snapshot``, ``validate_chrome_trace``,
  ``validate_timeseries_snapshot``) give the same problem lists on the
  reference tests' malformed inputs;
* SLO accounting: ``slo_check`` and ``summary()["slo"]`` equal on the same
  ``RequestMetrics``;
* the profiler spans: ``annotate`` marks ``recall/select``,
  ``recall/correction``, ``recall/topup``, ``recall/staged``,
  ``recall/reuse`` and ``attn/compute`` around a port ``serve_step`` under
  ``torch.profiler``, and opens no profiler range when none runs.
"""
import copy
import dataclasses
import json
import sys
import threading

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.obs.registry import MetricsRegistry as JMetricsRegistry
from repro.obs.timeseries import TimeSeriesBoard as JTimeSeriesBoard
from repro.obs.trace import TraceRecorder as JTraceRecorder
from repro.serving.metrics import EngineMetrics as JEngineMetrics
from repro.serving.metrics import RequestMetrics as JRequestMetrics
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.configs.base import FreeKVConfig
from repro_torch.models import model
from repro_torch.obs.registry import COUNT_BUCKETS, LATENCY_BUCKETS, RATE_BUCKETS, MetricsRegistry
from repro_torch.obs.timeseries import TimeSeriesBoard
from repro_torch.obs.trace import ANNOTATED_SPANS, TraceRecorder
from repro_torch.serving.metrics import EngineMetrics, RequestMetrics


def _drop_time(snap):
    snap = copy.deepcopy(snap)
    snap.pop("unix_time", None)
    return snap


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def _registry_ops(reg, seed):
    rng = np.random.default_rng(seed)
    reg.counter("req_total", "requests").inc(3)
    reg.counter("req_total").inc(2.5)
    reg.counter("odd-name.total", "sanitised for prometheus").inc()
    reg.gauge("occupancy", "live slots").set(0.75)
    reg.gauge("occupancy").inc(-0.25)
    reg.counter("never_touched")
    for name, buckets, xs in (("lat_seconds", LATENCY_BUCKETS, rng.exponential(0.01, 300)),
                              ("hit_rate", RATE_BUCKETS, rng.uniform(0, 1, 120)),
                              ("pages", COUNT_BUCKETS, rng.integers(0, 5000, 80)),
                              ("small", [0.1, 1.0], [0.05, 5.0, 1.0, 0.1])):
        h = reg.histogram(name, buckets, f"{name} help")
        for x in xs:
            h.observe(float(x))
    reg.histogram("empty", [1.0, 2.0])


@pytest.mark.parametrize("seed", [0, 1])
def test_registry_exporters_equal_reference(seed, tmp_path):
    reg, jreg = MetricsRegistry(), JMetricsRegistry()
    _registry_ops(reg, seed)
    _registry_ops(jreg, seed)
    assert reg.to_prometheus() == jreg.to_prometheus()
    extra = {"run": seed}
    assert _drop_time(reg.snapshot(extra)) == _drop_time(jreg.snapshot(extra))
    assert json.loads(reg.snapshot_line())["histograms"] == \
        json.loads(jreg.snapshot_line())["histograms"]
    path = tmp_path / "m.jsonl"
    reg.write_jsonl(str(path), extra=extra)
    reg.write_jsonl(str(path))
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(lines) == 2 and lines[0]["extra"] == extra
    assert all(obs.validate_snapshot(ln) == jobs.validate_snapshot(ln) == [] for ln in lines)


# ---------------------------------------------------------------------------
# sliding-window board
# ---------------------------------------------------------------------------
def _feed(board, clock, seed):
    """A seeded stream of serving series over 30 s, read at checkpoints."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0.0, 30.0, 400))
    out = []
    checkpoints = iter((4.0, 9.5, 12.0, 20.0, 30.0))
    nxt = next(checkpoints)
    for i, t in enumerate(ts):
        while nxt is not None and t > nxt:
            clock["t"] = nxt
            out.append(board.snapshot(extra={"i": i}))
            nxt = next(checkpoints, None)
        clock["t"] = float(t)
        board.observe("ttft_s", float(rng.lognormal(-3, 1)))
        board.observe("itl_s", float(rng.exponential(0.01)), t=float(t))
        board.event("tokens", 1.0)
        if i % 7 == 0:
            board.event("swap_bytes", float(rng.integers(1, 1 << 20)))
            board.observe("slot_occupancy", float(rng.uniform()))
    clock["t"] = 45.0                   # every sample rotated out, totals kept
    out.append(board.snapshot())
    return out


_PCT = ("p50", "p90", "p99")


@pytest.mark.parametrize("seed", [0, 3])
def test_board_snapshots_equal_reference(seed):
    """Equal snapshots; the percentiles within 1e-12 relative, since the
    port interpolates in numpy's arithmetic and the reference in its own
    (``_percentile_sorted``): the two round differently, by an ulp or so."""
    clock, jclock = {"t": 0.0}, {"t": 0.0}
    board = TimeSeriesBoard(window_s=5.0, clock=lambda: clock["t"])
    jboard = JTimeSeriesBoard(window_s=5.0, clock=lambda: jclock["t"])
    got, want = _feed(board, clock, seed), _feed(jboard, jclock, seed)
    strip = lambda snap: {**_drop_time(snap), "stats": {     # noqa: E731
        n: {k: v for k, v in e.items() if k not in _PCT} for n, e in snap["stats"].items()}}
    assert [strip(s) for s in got] == [strip(s) for s in want]
    for g, w in zip(got, want):
        for name, entry in g["stats"].items():
            np.testing.assert_allclose([entry[k] for k in _PCT],
                                       [w["stats"][name][k] for k in _PCT], rtol=1e-12)
    assert got[-1]["stats"]["ttft_s"]["count"] == 0
    assert got[-1]["rates"]["tokens"]["total_events"] == 400
    assert all(obs.validate_timeseries_snapshot(s) == [] for s in got)


@pytest.mark.parametrize("seed", range(3))
def test_window_percentiles_equal_numpy_and_stay_monotone(seed):
    """The port's rolling p50/p90/p99 are ``np.percentile``'s (linear) bit
    for bit on sliding slices, and a run of equal samples (a decode
    window's steps share one time) gives p50 == p90 == p99 == the sample,
    which ``validate_timeseries_snapshot``'s order check needs."""
    from repro_torch.obs.timeseries import WindowStat
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0.0, 30.0, 300))
    vs = np.where(rng.uniform(size=300) < 0.5, rng.lognormal(-3, 1, 300),
                  rng.choice(rng.uniform(0, 0.3, 4), 300))
    ws = WindowStat("x", window_s=4.0)
    idx = 0
    for now in (3.0, 7.5, 15.0, 22.0, 30.0):
        while idx < len(ts) and ts[idx] <= now:
            ws.observe(vs[idx], t=ts[idx])
            idx += 1
        inside = vs[(ts >= now - 4.0) & (ts <= now)]
        got = ws.summary(now=now)
        assert [got[k] for k in _PCT] == [float(np.percentile(inside, q)) for q in (50, 90, 99)]
    for v in rng.uniform(0, 0.3, 50):
        for n in (2, 3, 7, 8, 33):
            ws = WindowStat("same", window_s=10.0)
            for _ in range(n):
                ws.observe(float(v), t=1.0)
            got = ws.summary(now=1.0)
            assert got["p50"] == got["p90"] == got["p99"] == float(v)


def test_board_loses_no_event_under_concurrent_feed_and_snapshot():
    """Eight feeders and four readers at a 10 us switch interval: every
    event lands in the totals and every snapshot validates."""
    board = TimeSeriesBoard(window_s=60.0)
    n_feed, per = 8, 2000
    errors = []

    def feeder(k):
        for i in range(per):
            board.observe(f"s{k % 2}", 0.001 * (i % 5))
            board.event("tokens", 1.0)

    def reader():
        for _ in range(50):
            problems = obs.validate_timeseries_snapshot(board.snapshot())
            if problems:
                errors.append(problems)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = ([threading.Thread(target=feeder, args=(k,)) for k in range(n_feed)]
                   + [threading.Thread(target=reader) for _ in range(4)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    snap = board.snapshot()
    assert snap["rates"]["tokens"]["total_events"] == n_feed * per
    assert sum(snap["stats"][f"s{k}"]["count"] for k in (0, 1)) == n_feed * per


def test_observability_full_attaches_board():
    assert isinstance(obs.Observability.full().timeseries, TimeSeriesBoard)
    assert obs.Observability.full().trace.enabled
    assert obs.Observability.off().timeseries is None
    assert obs.Observability().timeseries is None


# ---------------------------------------------------------------------------
# validators on the reference tests' malformed inputs
# ---------------------------------------------------------------------------
def _good_snapshot():
    reg = JMetricsRegistry()
    reg.counter("a_total").inc(3)
    reg.gauge("b").set(1.5)
    reg.histogram("c", [1.0, 2.0]).observe(0.5)
    return json.loads(json.dumps(reg.snapshot()))


def _bad_snapshots():
    s1 = _good_snapshot()
    s1["histograms"]["c"]["bucket_counts"].append(9)
    s2 = _good_snapshot()
    s2["counters"]["a_total"] = "x"
    s3 = _good_snapshot()
    del s3["histograms"]["c"]["p90"]
    s3["histograms"]["c"]["count"] = 7
    s4 = _good_snapshot()
    s4["histograms"]["c"] = 1
    del s4["gauges"]
    return [_good_snapshot(), s1, s2, s3, s4, {"schema_version": 999}, {}, "nope"]


@pytest.mark.parametrize("i", range(8))
def test_validate_snapshot_equals_reference(i):
    snap = _bad_snapshots()[i]
    assert obs.validate_snapshot(snap) == jobs.validate_snapshot(snap)
    assert (obs.validate_snapshot(snap) == []) == (i == 0)


def _bad_traces():
    tr = JTraceRecorder(enabled=True)
    tr.complete("engine/decode_step", 1.0, 0.002, args={"steps": 1})
    tr.instant("recall/reuse", 1.001)
    tr.counter("speculation", 1.0, {"hit_rate": 0.5})
    good = tr.chrome_trace()
    return [good, {"no": "events"}, {"traceEvents": [{"ph": "X"}]},
            {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": -5}]},
            {"traceEvents": [{"name": "a", "ph": "i", "pid": 1}, 3, {"ph": "C", "pid": 1}]},
            {"traceEvents": "x"}, []]


@pytest.mark.parametrize("i", range(7))
def test_validate_chrome_trace_equals_reference(i):
    doc = _bad_traces()[i]
    assert obs.validate_chrome_trace(doc) == jobs.validate_chrome_trace(doc)
    assert (obs.validate_chrome_trace(doc) == []) == (i == 0)


def _bad_stats():
    clock = {"t": 0.0}
    board = JTimeSeriesBoard(clock=lambda: clock["t"])
    board.observe("x", 1.0)
    board.event("r", 1.0)
    good = board.snapshot()
    s1 = copy.deepcopy(good)
    s1["stats"]["x"]["p50"] = 99.0                  # breaks p50 <= p90
    s2 = copy.deepcopy(good)
    s2["stats"]["x"]["mean"] = float("nan")
    s3 = copy.deepcopy(good)
    s3["rates"]["r"]["total_events"] = 0
    s3["rates"]["r"]["events"] = 5
    s4 = copy.deepcopy(good)
    del s4["now"]
    s4["rates"] = []
    s5 = copy.deepcopy(good)
    s5["stats"]["x"] = "y"
    return [good, s1, s2, s3, s4, s5, {}, "nope"]


@pytest.mark.parametrize("i", range(8))
def test_validate_timeseries_snapshot_equals_reference(i):
    snap = _bad_stats()[i]
    assert obs.validate_timeseries_snapshot(snap) == jobs.validate_timeseries_snapshot(snap)
    assert (obs.validate_timeseries_snapshot(snap) == []) == (i == 0)


def test_trace_write_validates(tmp_path):
    tr = TraceRecorder(enabled=True)
    rm = RequestMetrics(uid=3, prompt_tokens=10, enqueue_t=0.0, prefill_start_t=0.1,
                        first_token_t=0.3, finish_t=0.9, new_tokens=5, prefix_hit_tokens=8)
    tr.request_lifecycle(rm)
    tr.recall_step(1.0, 0.01, sync_pages=2, async_pages=5, reused_pages=1,
                   page_block_bytes=4096)
    jtr = JTraceRecorder(enabled=True)
    jtr.request_lifecycle(rm)
    jtr.recall_step(1.0, 0.01, sync_pages=2, async_pages=5, reused_pages=1,
                    page_block_bytes=4096)
    assert tr.events == jtr.events
    path = tmp_path / "t.json"
    tr.write(str(path))
    doc = json.loads(path.read_text())
    assert obs.validate_chrome_trace(doc) == jobs.validate_chrome_trace(doc) == []


# ---------------------------------------------------------------------------
# SLO accounting
# ---------------------------------------------------------------------------
_REQS = [  # (ttft s, itl s, new tokens, request's slo ttft ms, request's slo itl ms)
    (0.10, 0.010, 8, None, None), (0.30, 0.010, 8, None, None), (0.10, 0.050, 8, None, None),
    (0.10, None, 1, None, None), (2.00, 0.010, 4, 5000.0, None), (0.10, 0.010, 6, None, 5.0),
    (None, None, 0, None, None), (0.05, 0.002, 12, 60.0, 3.0),
]


def _request_metrics(cls, i, ttft, itl, n, t_slo, i_slo):
    first = None if ttft is None else 0.5 + ttft
    finish = None if first is None else first + (itl or 0.0) * max(n - 1, 0)
    return cls(uid=i, enqueue_t=0.5, first_token_t=first, finish_t=finish, new_tokens=n,
               slo_ttft_ms=t_slo, slo_itl_ms=i_slo)


@pytest.mark.parametrize("engine_slo", [(None, None), (200.0, None), (None, 20.0),
                                        (200.0, 20.0)])
def test_slo_accounting_equals_reference(engine_slo):
    em = EngineMetrics(slo_ttft_ms=engine_slo[0], slo_itl_ms=engine_slo[1])
    jem = JEngineMetrics(slo_ttft_ms=engine_slo[0], slo_itl_ms=engine_slo[1])
    for i, r in enumerate(_REQS):
        rm, jrm = _request_metrics(RequestMetrics, i, *r), _request_metrics(JRequestMetrics, i, *r)
        assert em.slo_check(rm) == jem.slo_check(jrm)
        em.record_request(rm)
        jem.record_request(jrm)
        em.requests.append(rm)
        jem.requests.append(jrm)
    em.wall_s = jem.wall_s = 2.5
    em.cancellations = jem.cancellations = 1
    assert em.summary()["slo"] == jem.summary()["slo"]
    assert em.summary()["cancelled"] == jem.summary()["cancelled"] == 1
    assert em.summary()["completed"] == jem.summary()["completed"]
    assert em.slo_attainment == jem.slo_attainment
    assert em.goodput_tokens_per_s == jem.goodput_tokens_per_s


# ---------------------------------------------------------------------------
# profiler spans
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def decode_setup():
    cfg = dataclasses.replace(get_config("llama31-8b-smoke"), n_layers=2, n_periods=2)
    fkv = FreeKVConfig(method="freekv", page_size=8, budget=64, n_sink=8, n_window=8, tau=0.8)
    params = model.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 100)))
    return cfg, fkv, params, toks


def _steps(decode_setup, n=2):
    cfg, fkv, params, toks = decode_setup
    logits, state = model.prefill(cfg, fkv, params, {"tokens": toks}, 128)
    for _ in range(n):
        logits, state = model.serve_step(cfg, fkv, params, state,
                                         torch.argmax(logits, dim=-1)[:, None])
    return logits


def test_annotate_spans_under_profiler(decode_setup):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _steps(decode_setup)
    counts = {e.key: e.count for e in prof.key_averages()}
    layers = decode_setup[0].n_layers
    # two steps of two layers: each span opened once a layer a step
    assert {name: counts.get(name, 0) for name in ANNOTATED_SPANS} == \
        {name: 2 * layers for name in ANNOTATED_SPANS}


def test_annotate_opens_nothing_without_profiler(decode_setup, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    want = _steps(decode_setup)
    assert opened == []
    assert isinstance(obs.annotate("recall/select"), type(obs.annotate("attn/compute")))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        got = _steps(decode_setup)
    assert sorted(set(opened)) == sorted(ANNOTATED_SPANS)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_decode_profile_span_table(decode_setup):
    """``decode_profile``'s span names are the ones ``annotate`` opens, and
    its table reads each span once a layer a step, with host time; the
    device extent is the card's (None on the CPU: not measured)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import decode_profile
    assert decode_profile.SPANS == ANNOTATED_SPANS
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _steps(decode_setup, n=3)
    table = decode_profile.span_table(prof.key_averages(), steps=3)
    assert set(table) == set(ANNOTATED_SPANS)
    layers = decode_setup[0].n_layers
    for name, row in table.items():
        assert row["calls_per_step"] == layers and row["host_ms_per_step"] > 0
        assert row["device_ms_per_step"] is None
        assert row["stream"] == ("side" if name == "recall/staged" else "main")
    assert decode_profile.device_rows(prof.key_averages()) == []
