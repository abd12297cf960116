"""Where the prefill's and a decode step's time go on the card: the main
path's shapes (llama31-8b at full width, B=4, 8192-token needle prompts,
FreeKV defaults, recall_overlap=True, pool in pinned host memory), seeded
random bf16 weights, ``torch.profiler`` over one prefill and over a few
``serve_step`` calls after warm-up.

    PYTHONPATH=src python -m repro_torch.launch.decode_profile [--steps 4] \
        [--arch llama31-8b|qwen25-7b|gemma2-2b|smollm-360m|stablelm-3b|granite-3-8b|
                deepseek-moe-16b|xlstm-350m|whisper-tiny|internvl2-26b] \
        [--method freekv|arkvale|infinigen|quest|shadowkv|raas|streaming|centroid] \
        [--kv-quant none|int8|int4] [--quant-group-size 0] [--window 8] [--completion] \
        [--draft-len 4] [--main-runs] [--tp 2 [--tp-devices cuda:0,cuda:0]]

``--arch`` profiles another served arch at full width with the same
traffic (the default is the main path's llama31-8b); deepseek-moe-16b
(~33 GB of bf16 weights) is the MoE arch that fits the card; a frontend
arch gets zero embeddings, as the engine gives a request without its own
(whisper's 1500 frames to its encoder, internvl2's 1024 patches ahead of
each prompt, ~40 GB of bf16 weights).

Prints one JSON line: the prefill's wall s, device-busy s and top kernels;
per decode step the host wall ms, device-busy ms (sum of kernel and copy
time on the card), the busy share, the PyTorch ops the host dispatched and
the device operations (kernels, copies), the top kernels by device time,
the top host-side ops by self CPU time, the count of host-device
synchronisations, and the per-span table: host ms and device ms a step of
each profiler span the retrieval path opens (``obs.trace.annotate``:
``recall/select``, ``recall/correction``, ``recall/topup``,
``recall/staged`` on the side stream, ``recall/reuse``, ``attn/compute``;
a span's device ms is its extent on the card, ``span_table``); with ``--window k`` also a continuous-scheduler decode
window of k steps on the same state, beside k steps of the static engine
(``profile_window``: host ops, device operations, busy share and wall ms
per step; host syncs counted from the runtime calls in the trace); with
``--completion`` also one eager step in which every row completes a page
beside one in which none does (``profile_completion``: host ops, device
operations and device-busy ms of each); with ``--draft-len N`` also one
speculative verify iteration of 1 + N rows beside 1 + N eager steps on the
same state (``profile_verify``: host ops, device operations, busy share,
wall ms and host syncs of each side).
``--tp N`` profiles KV-head-group tensor-parallel decode
(``core/sharded_retrieval``) over N shards, on ``cuda:0`` .. ``cuda:N-1``
or the devices ``--tp-devices`` names (``cuda:0,cuda:0``: both on one
card); the backbone on ``cuda:0``.
``profile_decode`` gives the same for weights already on
the card (``chip_smoke.py`` phase 4). ``--main-runs`` gives the decode's
numbers for each of the five main-path runs on one set of weights; it uses
only the model's public functions, so another checkout is measured with
``PYTHONPATH=<other>/src python src/repro_torch/launch/decode_profile.py``.
Needs a card; exits non-zero without one.
"""
import argparse
import json
import sys
import time
from collections import Counter

import numpy as np
import torch

# the main path's shapes (chip_smoke.py phase 4)
ARCH, CONTEXT, BATCH, WARMUP = "llama31-8b", 8192, 4, 3
MAIN_RUNS = (("freekv", "none"), ("freekv", "int8"), ("shadowkv", "none"), ("shadowkv", "int8"),
             ("centroid", "none"))


# the runtime calls in which the host waits for the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
MEASURED = "decode_profile.measured"
PROFILER_MARGIN_S = 0.05
# the retrieval path's profiler spans (``obs.trace.ANNOTATED_SPANS``), named
# here so that another checkout's ``src`` can be profiled; ``recall/staged``
# opens on the side stream
SPANS = ("recall/select", "recall/correction", "recall/topup", "recall/staged",
         "recall/reuse", "attn/compute")


def dev_us(e):
    """A profiler row's own device time, in microseconds."""
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))


def device_rows(events):
    """The card's work rows (kernels, copies) of ``key_averages()``. A
    profiler range (a span, the measured range) also has a device-side row
    that spans the kernels inside it; those are left out, so that no kernel
    counts twice in the busy time. So is an aten op's row, which repeats the
    device time of the kernels it launched."""
    from torch.autograd import DeviceType
    return [e for e in events if e.device_type == DeviceType.CUDA and dev_us(e) > 0
            and e.key not in SPANS and e.key != MEASURED]


def span_table(events, steps):
    """Each span's host ms a step (its host-side row: the host's time inside
    it), device ms a step (its device-side row: its extent on the card,
    from the first kernel launched inside it to the end of the last, on the
    stream it ran on, gaps included; None where the profiler emitted no
    such row) and how often it opened a step. The extent, not the host-side
    row's device time, because kernels launched through ``ctypes`` (the
    port's own) are attributed to no host-side row."""
    from torch.autograd import DeviceType
    out = {}
    for e in events:
        if e.key not in SPANS:
            continue
        row = out.setdefault(e.key, {"host_ms_per_step": None, "device_ms_per_step": None,
                                     "calls_per_step": None,
                                     "stream": "side" if e.key == "recall/staged" else "main"})
        if e.device_type == DeviceType.CUDA:
            row["device_ms_per_step"] = dev_us(e) / 1e3 / steps
        else:
            row["host_ms_per_step"] = e.cpu_time_total / 1e3 / steps
            row["calls_per_step"] = e.count / steps
    return out


def profile_decode(cfg, fkv, params, toks, steps=4, trace_out=None, with_prefill=True,
                   window=0, completion=False, draft_len=0, mesh=None):
    """The numbers ``main`` prints, for ``params`` already on the card and
    prompts ``toks`` (B, T) on the card: the prefill's (when
    ``with_prefill``) and an eager decode step's, as one dict; with
    ``window`` > 0 also a continuous-scheduler window of that many steps,
    on the same state, in the same process (``profile_window``); with
    ``completion`` then a step that completes a page in every row beside
    one that completes none (``profile_completion``); with ``draft_len``
    > 0 then one verify iteration beside 1 + ``draft_len`` eager steps
    (``profile_verify``). ``mesh`` (``launch/mesh.make_tp_mesh``): the
    decode runs KV-head-group tensor-parallel over its shards."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.model import frontend_prefix, prefill, serve_step

    max_len = (frontend_prefix(cfg) + toks.shape[1] + 64 + WARMUP + 2 * steps + 6 * window
               + 2 * fkv.page_size + 6 * (draft_len + 1))
    # a frontend arch's stub embeddings: zeros, as the engine serves a
    # request without its own
    front = {} if cfg.frontend is None else {"frontend": torch.zeros(
        (toks.shape[0], cfg.n_frontend_tokens, cfg.d_model), device=toks.device)}

    prefill_out = None
    # warm-up prefill on a short prompt (builds and loads the kernels), the
    # timed one, then (with_prefill) one under the profiler
    prefill(cfg, fkv, params, {"tokens": toks[:, :512], **front}, max_len,
            state_dtype=torch.bfloat16, mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill(cfg, fkv, params, {"tokens": toks, **front}, max_len,
                            state_dtype=torch.bfloat16, mesh=mesh)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if with_prefill:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prefill(cfg, fkv, params, {"tokens": toks, **front}, max_len,
                    state_dtype=torch.bfloat16, mesh=mesh)
            torch.cuda.synchronize()
        pre_rows = device_rows(prof.key_averages())
        prefill_out = {
            "wall_s_unprofiled": prefill_s,
            "device_busy_s": sum(dev_us(e) for e in pre_rows) / 1e6,
            "top_device_s": [(e.key[:80], dev_us(e) / 1e6, e.count)
                             for e in sorted(pre_rows, key=dev_us, reverse=True)[:12]],
        }
        del prof

    def step(logits, state):
        cur = torch.argmax(logits, dim=-1)[:, None]
        return serve_step(cfg, fkv, params, state, cur, mesh=mesh)

    for _ in range(WARMUP):
        logits, state = step(logits, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, state = step(logits, state)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            logits, state = step(logits, state)
        torch.cuda.synchronize()
    if trace_out:
        prof.export_chrome_trace(trace_out)
    events = prof.key_averages()
    dev_events = device_rows(events)
    busy_ms = sum(dev_us(e) for e in dev_events) / 1e3 / steps
    top_dev = sorted(dev_events, key=dev_us, reverse=True)[:15]
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:15]
    syncs = {e.key: e.count // steps for e in events
             if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                          "cudaMemcpyAsync", "cudaEventSynchronize", "cudaLaunchKernel",
                          "cudaLaunchKernelExC", "cudaStreamWaitEvent",
                          "cudaPointerGetAttributes")}
    out = {
        "device": torch.cuda.get_device_name(0), "arch": cfg.name, "batch": toks.shape[0],
        "context": toks.shape[1], "method": fkv.method, "offload": fkv.offload,
        "kv_quant": fkv.kv_quant, "tp": 1 if mesh is None else mesh.shape["model"],
        "steps": steps, "prefill_s": prefill_s, "prefill": prefill_out,
        "wall_ms_per_step_unprofiled": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "cpu_ops_per_step": sum(e.count for e in events
                                if e.key.startswith("aten::")) // steps,
        "device_ops_per_step": sum(e.count for e in dev_events) / steps,
        "runtime_calls_per_step": syncs,
        "top_device_ms_per_step": [(e.key[:80], dev_us(e) / 1e3 / steps, e.count // steps)
                                   for e in top_dev],
        "top_self_cpu_ms_per_step": [(e.key[:80], e.self_cpu_time_total / 1e3 / steps,
                                      e.count // steps) for e in top_cpu],
        "spans": span_table(events, steps),
    }
    if window:
        out["window"] = profile_window(cfg, fkv, params, state, logits, window, mesh=mesh)
    if completion:
        out["completion"] = profile_completion(cfg, fkv, params, state, logits, mesh=mesh)
    if draft_len:
        out["verify"] = profile_verify(cfg, fkv, params, state, logits, draft_len, mesh=mesh)
    return out


def profile_completion(cfg, fkv, params, state, logits, mesh=None):
    """One eager decode step in which no row completes a page, then (after
    the plain steps that bring the rows to a page boundary) one in which
    every row does, each alone under the profiler: host ops, device
    operations and device-busy ms of the step. The rows share a length
    (``state["pos_host"]``, read on the host)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.model import serve_step

    p = fkv.page_size
    carry = {"state": state, "logits": logits}

    def step():
        cur = torch.argmax(carry["logits"], dim=-1)[:, None]
        carry["logits"], carry["state"] = serve_step(cfg, fkv, params, carry["state"], cur,
                                                     mesh=mesh)

    def completes():           # the next step's append takes each length L to L + 1
        return [(int(n) + 1) % p == 0 for n in carry["state"]["pos_host"]]

    def measure():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        events = prof.key_averages()
        dev = device_rows(events)
        return {"cpu_ops": sum(e.count for e in events if e.key.startswith("aten::")),
                "device_ops": sum(e.count for e in dev),
                "device_busy_ms": sum(dev_us(e) for e in dev) / 1e3}

    while any(completes()):
        step()
    out = {"non_completing": measure()}
    while not all(completes()):
        step()
    out["completing"] = measure()
    return out


def _measure(run, k):
    """Host ops, device operations, busy share, wall ms and host syncs of
    ``run`` per ``k`` (its steps): once to warm up, once timed, once under
    the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    wall_ms = 1e3 * (time.perf_counter() - t0) / k
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # idle margins keep the profiler's own synchronizes at start
        # and stop clear of the measured range: the runtime calls'
        # timestamps and the range's need not agree to the microsecond
        time.sleep(PROFILER_MARGIN_S)
        with record_function(MEASURED):
            run()
        time.sleep(PROFILER_MARGIN_S)
    events = prof.key_averages()
    dev_events = device_rows(events)
    busy_ms = sum(dev_us(e) for e in dev_events) / 1e3 / k
    # every wait of the host for the card, as the runtime saw it: a read
    # (.cpu(), .tolist(), .item()) and a copy from pageable memory each
    # make one stream synchronize. Only those inside the measured range
    # count: the profiler synchronizes the card itself when it stops.
    evs = prof.events()
    outer = next(e for e in evs if e.name == MEASURED)
    lo, hi = outer.time_range.start, outer.time_range.end
    inside = [e for e in evs if e.name in SYNC_CALLS and lo <= e.time_range.start <= hi]
    syncs = dict(Counter(e.name for e in inside))
    return {"steps": k, "host_syncs_per_step": sum(syncs.values()) / k,
            "sync_calls": syncs,
            # where each wait starts, in us from the range's start (of hi - lo)
            "sync_starts_us": [e.time_range.start - lo for e in inside],
            "range_us": hi - lo,
            "wall_ms_per_step_unprofiled": wall_ms, "device_busy_ms_per_step": busy_ms,
            "device_busy_share": busy_ms / wall_ms if wall_ms else None,
            "cpu_ops_per_step": sum(e.count for e in events
                                    if e.key.startswith("aten::")) // k,
            "device_ops_per_step": sum(e.count for e in dev_events) / k}


def profile_window(cfg, fkv, params, state, logits, k=8, mesh=None):
    """A continuous-scheduler decode window on the same state, beside the
    static engine's step, in the form of the eager step's numbers (per
    step). ``window``: ``k`` fused steps (decode with stats, greedy pick on
    the card, every lane live) and the one read of the token, valid and
    stat blocks at its end, as ``serving/scheduler.py`` runs it;
    ``static_step``: the static engine's step (decode with stats, greedy
    pick, the tokens' read and the stats' read), ``k`` times. Host syncs
    are counted from the runtime's synchronize calls in the trace, so one
    hidden anywhere in the step shows."""
    from repro_torch.models.model import DECODE_STAT_KEYS, decode_window, serve_step
    from repro_torch.serving.sampling import SamplerConfig

    B, dev = logits.shape[0], logits.device
    i32 = dict(dtype=torch.int32, device=dev)
    loop = {"cur": torch.argmax(logits, dim=-1).to(torch.int32),
            "key": torch.zeros((B, 2), dtype=torch.int64, device=dev),
            "count": torch.ones((B,), **i32),
            "limit": torch.full((B,), 1 << 30, **i32), "eos": torch.full((B,), -1, **i32),
            "fin": torch.zeros((B,), dtype=torch.bool, device=dev)}
    carry = {"state": state, "loop": loop, "cur": loop["cur"].long()}

    def window():
        st, lp, toks, valid, stats, finite = decode_window(
            cfg, fkv, params, carry["state"], carry["loop"], SamplerConfig(), k, mesh=mesh)
        blocks = [toks, valid, finite] + list(stats.values())
        torch.cat([b.reshape(-1).to(torch.float64) for b in blocks]).cpu()   # the one read
        carry.update(state=st, loop=lp)

    def static_steps():
        for _ in range(k):
            lg, st, stats = serve_step(cfg, fkv, params, carry["state"],
                                       carry["cur"][:, None], collect_stats=True, mesh=mesh)
            carry.update(state=st, cur=torch.argmax(lg, dim=-1))
            carry["cur"].tolist()                                            # read 1
            torch.stack([stats[key] for key in DECODE_STAT_KEYS]).cpu()      # read 2

    out = _measure(window, k)
    out["static_step"] = _measure(static_steps, k)
    return out


def profile_verify(cfg, fkv, params, state, logits, draft_len, mesh=None):
    """One speculative iteration (``serve_step_spec``: draft, verify pass of
    S = 1 + ``draft_len`` rows, sampling, rollback, drafter update, every
    lane live) beside S eager ``serve_step`` calls, on the same state, in
    the form of ``profile_window``'s numbers, per iteration (the eager side
    per S steps). Each side ends in one read of its tokens."""
    import dataclasses

    from repro_torch.core import drafter
    from repro_torch.models.model import serve_step, serve_step_spec
    from repro_torch.serving.sampling import SamplerConfig

    sfkv = dataclasses.replace(fkv, draft_len=draft_len)
    S = draft_len + 1
    B, dev = logits.shape[0], logits.device
    state.setdefault("draft_tab", drafter.init_draft_tab(B, cfg.vocab_size, dev))
    i32 = dict(dtype=torch.int32, device=dev)
    loop = {"cur": torch.argmax(logits, dim=-1).to(torch.int32),
            "key": torch.zeros((B, 2), dtype=torch.int64, device=dev),
            "count": torch.ones((B,), **i32), "limit": torch.full((B,), 1 << 30, **i32),
            "eos": torch.full((B,), -1, **i32),
            "fin": torch.zeros((B,), dtype=torch.bool, device=dev)}
    carry = {"state": state, "loop": loop, "cur": loop["cur"].long()}

    def verify():
        st, lp, toks, emit, _, _ = serve_step_spec(cfg, sfkv, params, carry["state"],
                                                   carry["loop"], SamplerConfig(), mesh=mesh)
        torch.stack([toks.to(torch.int64), emit.to(torch.int64)]).cpu()   # the one read
        carry.update(state=st, loop=lp)

    def eager_steps():
        for _ in range(S):
            lg, st = serve_step(cfg, fkv, params, carry["state"], carry["cur"][:, None],
                                mesh=mesh)
            carry.update(state=st, cur=torch.argmax(lg, dim=-1))
        carry["cur"].cpu()

    out = {"draft_len": draft_len, "rows": S, **_measure(verify, 1)}
    out["eager_steps"] = _measure(eager_steps, 1)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace of the profiled steps here")
    ap.add_argument("--arch", default=ARCH,
                    help="a served arch at full width: llama31-8b (the main path), "
                         "qwen25-7b, gemma2-2b, smollm-360m, stablelm-3b, granite-3-8b, "
                         "deepseek-moe-16b, xlstm-350m, whisper-tiny or internvl2-26b")
    ap.add_argument("--method", default="freekv",
                    help="retriever: any of core.retrieval.METHODS but full")
    ap.add_argument("--kv-quant", choices=("none", "int8", "int4"), default="none",
                    help="quantized host KV tier")
    ap.add_argument("--quant-group-size", type=int, default=0,
                    help="channels per quantization scale (0 = one per page half)")
    ap.add_argument("--window", type=int, default=0,
                    help="also profile a continuous-scheduler window of this many steps")
    ap.add_argument("--completion", action="store_true",
                    help="also profile a step where every row completes a page beside one "
                         "where none does")
    ap.add_argument("--draft-len", type=int, default=0,
                    help="also profile one speculative verify iteration of 1 + N rows beside "
                         "1 + N eager steps on the same state (profile_verify)")
    ap.add_argument("--main-runs", action="store_true",
                    help="the five runs of chip_smoke.py phase 4 (freekv none/int8, "
                         "shadowkv none/int8, centroid none) on one set of weights, "
                         "decode only: one JSON line each")
    ap.add_argument("--tp", type=int, default=1,
                    help="KV-head-group tensor parallelism over N shards")
    ap.add_argument("--tp-devices", default=None, metavar="DEV,DEV,...",
                    help="--tp: each shard's device, the first cuda:0 (e.g. cuda:0,cuda:0); "
                         "default cuda:0..N-1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_profile: needs a CUDA device", file=sys.stderr)
        return 1

    from repro_torch.configs import get_config
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.launch.mesh import make_tp_mesh
    from repro_torch.models.model import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    fkv = FreeKVConfig(method=args.method, offload="host", kv_quant=args.kv_quant,
                       quant_group_size=args.quant_group_size)
    params = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    stream = needle_stream(cfg.vocab_size, CONTEXT, fkv.page_size, seed=0)
    toks = torch.from_numpy(np.stack([next(stream).tokens for _ in range(BATCH)]))
    toks = toks.long().to(dev)
    mesh = None if args.tp == 1 and not args.tp_devices else make_tp_mesh(
        args.tp, args.tp_devices.split(",") if args.tp_devices else None)
    if not args.main_runs:
        print(json.dumps(profile_decode(cfg, fkv, params, toks, args.steps, args.trace_out,
                                        window=args.window, completion=args.completion,
                                        draft_len=args.draft_len, mesh=mesh)),
              flush=True)
        return 0
    for method, kv_quant in MAIN_RUNS:
        fkv = FreeKVConfig(method=method, offload="host", kv_quant=kv_quant)
        out = profile_decode(cfg, fkv, params, toks, args.steps, with_prefill=False,
                             window=args.window, completion=args.completion, mesh=mesh)
        keep = ("method", "kv_quant", "prefill_s", "wall_ms_per_step_unprofiled",
                "device_busy_ms_per_step", "device_busy_share", "cpu_ops_per_step",
                "device_ops_per_step", "runtime_calls_per_step", "spans", "window", "completion")
        print(json.dumps({k: out[k] for k in keep if k in out}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
