"""Serving launcher for the PyTorch port (reference ``repro/launch/serve.py``):

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
        --arch llama31-8b --context 8192 --new-tokens 40 --batch 4 \
        --requests 8 --page-size 32 --budget 2048 --offload host \
        --dtype bfloat16 --kv-quant int8 --method freekv

Same flags and defaults as the reference CLI where the feature is ported:
``--scheduler continuous`` (the default) serves ``--requests`` requests over
``--batch`` slots, prompts left-padded to ``--prefill-bucket``, up to
``--sync-interval`` decode steps per host read, with the radix prefix cache
(``--prefix-cache-tokens``), chunked prefill (``--prefill-chunk``) and
priority preemption (``--preempt``, the last request urgent) and
speculative decoding (``--draft-len``, off with ``--no-spec-decode``;
greedy or ``--temperature`` sampled, the tokens equal ``--draft-len 0``'s);
``--scheduler static`` is the lockstep fallback. ``--device``, ``--offload``, ``--dtype`` and
``--seed`` are the port's own. Weights are random, made from ``--seed``.

``--tp N`` serves with KV-head-group tensor parallelism (``ServeEngine(tp=N)``,
``core/sharded_retrieval``): each attention layer's retrieval state and step
split over N shards by KV head, the backbone on ``--device``; the tokens
equal ``--tp 1``'s. The shards take ``cuda:0`` .. ``cuda:N-1``, which must
exist, unless ``--tp-devices`` names them, its first being ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama31-8b \
        --context 8192 --new-tokens 40 --batch 4 --requests 8 --page-size 32 \
        --budget 2048 --offload host --dtype bfloat16 --tp 2 --tp-devices cuda:0,cuda:0

(two shards on one card; ``--device cpu --tp-devices cpu,cpu`` on the CPU).
Prints each request's tokens and timings, then ``EngineMetrics.summary()``
as one JSON line.

``--serve-http`` serves the HTTP front-end (``serving/frontend``) instead
of a fixed batch, until interrupted: ``POST /generate`` (a chunked NDJSON
token stream; a client that hangs up is cancelled), ``GET /metrics``
(Prometheus text), ``GET /stats`` (the sliding-window series) and ``GET
/healthz``; ``--port 0`` takes a free port, printed at start:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch granite-3-8b-smoke --serve-http --port 0

``--slo-ttft-ms``/``--slo-itl-ms`` tag the requests with the engine's SLOs
(the summary's ``slo`` section: attainment and goodput). After the run,
``--metrics-out`` appends a JSONL registry snapshot, ``--prom-out`` writes
the Prometheus text and ``--trace-out`` a Chrome trace of the request
lifecycle and recall spans; ``--no-obs`` turns the per-step histograms and
spans off (the registry's counters always run).
"""
import argparse
import json

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import FreeKVConfig
from repro_torch.data.synthetic import needle_stream
from repro_torch.models.model import frontend_prefix, init_params
from repro_torch.obs import Observability, TimeSeriesBoard, TraceRecorder
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.sampling import SamplerConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="granite-3-8b-smoke",
                    help="llama31-8b, qwen25-7b, gemma2-2b, smollm-360m, stablelm-3b, "
                         "granite-3-8b, deepseek-moe-16b, llama4-scout-17b-a16e, "
                         "jamba-1.5-large-398b, xlstm-350m, whisper-tiny or internvl2-26b, "
                         "each also as <arch>-smoke (jamba, xlstm, whisper and internvl2 "
                         "serve without chunked prefill and the prefix cache; whisper and "
                         "internvl2 with zero frontend embeddings, as the engine gives a "
                         "request without its own)")
    ap.add_argument("--method", default="freekv",
                    help="retriever: freekv, arkvale, infinigen, quest, shadowkv, raas, "
                         "streaming, full or centroid")
    ap.add_argument("--context", type=int, default=512)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--requests", type=int, default=0,
                    help="total requests (default: one per batch slot)")
    ap.add_argument("--budget", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--tau", type=float, default=0.8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--scheduler", choices=("continuous", "static"),
                    default="continuous")
    ap.add_argument("--prefill-bucket", type=int, default=64,
                    help="continuous: left-pad prompts to a multiple of this")
    ap.add_argument("--sync-interval", type=int, default=8,
                    help="continuous: decode steps per host read")
    ap.add_argument("--prefix-cache-tokens", type=int, default=0,
                    help="continuous: radix prefix cache capacity in tokens (0 = off)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="continuous: chunked prefill, at most N prompt tokens a scheduler "
                         "round between decode windows (0 = whole-shot)")
    ap.add_argument("--preempt", action="store_true",
                    help="continuous: priority preemption; the last request gets priority 1 "
                         "and swaps the lowest-priority running request's state to host")
    ap.add_argument("--draft-len", type=int, default=0,
                    help="speculative decoding: tokens the per-slot bigram drafter proposes a "
                         "verify step (0 = off); the verify pass commits the longest prefix "
                         "the model agrees with, so the tokens equal --draft-len 0's. Needs "
                         "the continuous scheduler and on-card sampling (else 0)")
    ap.add_argument("--no-spec-decode", action="store_true",
                    help="force draft_len=0 whatever --draft-len says; the same as "
                         "--draft-len 0, kept so the flags match the reference's CLI")
    ap.add_argument("--no-overlap", action="store_true",
                    help="disable the overlapped recall pipeline")
    ap.add_argument("--offload", choices=("sim", "host"), default="sim",
                    help="host = KV pool in pinned host memory")
    ap.add_argument("--kv-quant", choices=("none", "int8", "int4"), default="none",
                    help="quantized host KV tier (int8 / packed int4 + fp32 scales)")
    ap.add_argument("--quant-group-size", type=int, default=0,
                    help="channels per quantization scale (0 = one per page half)")
    ap.add_argument("--dtype", choices=tuple(_DTYPES), default="float32",
                    help="weights and decode state dtype")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tp", type=int, default=1,
                    help="KV-head-group tensor parallelism over N shards (must divide both "
                         "head counts; the tokens equal --tp 1's)")
    ap.add_argument("--tp-devices", default=None, metavar="DEV,DEV,...",
                    help="--tp: each shard's device, the first being --device (e.g. "
                         "cuda:0,cuda:0 puts two shards on one card); default cuda:0..N-1")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="append a JSONL snapshot of the metrics registry after the run")
    ap.add_argument("--prom-out", default=None, metavar="PATH",
                    help="write the Prometheus text exposition after the run")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace (request lifecycle and recall spans)")
    ap.add_argument("--no-obs", action="store_true",
                    help="no per-step histograms or spans (the registry's counters always run)")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="the engine's TTFT SLO in ms: the summary's slo section reports "
                         "attainment and goodput (tokens/s of the requests that meet it)")
    ap.add_argument("--slo-itl-ms", type=float, default=None,
                    help="the engine's mean inter-token latency SLO in ms")
    ap.add_argument("--serve-http", action="store_true",
                    help="serve the HTTP front-end instead of a fixed batch: POST /generate "
                         "(chunked NDJSON token stream), GET /metrics, /stats, /healthz; "
                         "Ctrl-C stops it")
    ap.add_argument("--host", default="127.0.0.1", help="--serve-http: bind address")
    ap.add_argument("--port", type=int, default=8008,
                    help="--serve-http: port (0 takes a free one)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    dtype = _DTYPES[args.dtype]
    params = init_params(cfg, seed=args.seed, device=args.device, dtype=dtype)
    fkv = FreeKVConfig(method=args.method, page_size=args.page_size,
                       budget=args.budget, n_sink=args.page_size * 2,
                       n_window=args.page_size * 2, tau=args.tau,
                       recall_overlap=not args.no_overlap, offload=args.offload,
                       kv_quant=args.kv_quant, quant_group_size=args.quant_group_size,
                       sync_interval=args.sync_interval, prefill_chunk_tokens=args.prefill_chunk,
                       preempt=args.preempt,
                       draft_len=0 if args.no_spec_decode else args.draft_len)
    mesh = None
    if args.tp_devices:
        from repro_torch.launch.mesh import make_tp_mesh
        mesh = make_tp_mesh(args.tp, args.tp_devices.split(","))
    if args.no_obs:
        obs = Observability.off()
    else:
        # the board feeds the front-end's /stats
        obs = Observability(enabled=True, trace=TraceRecorder(enabled=bool(args.trace_out)),
                            timeseries=TimeSeriesBoard() if args.serve_http else None)
    eng = ServeEngine(cfg, fkv, params,
                      max_len=frontend_prefix(cfg) + args.context + args.new_tokens + args.page_size
                      + args.prefill_bucket,
                      batch_size=args.batch,
                      sampler=SamplerConfig(temperature=args.temperature),
                      state_dtype=dtype, scheduler=args.scheduler,
                      prefill_bucket=args.prefill_bucket,
                      prefix_cache_tokens=args.prefix_cache_tokens, obs=obs,
                      slo_ttft_ms=args.slo_ttft_ms, slo_itl_ms=args.slo_itl_ms,
                      device=args.device, tp=1 if mesh is not None else args.tp, mesh=mesh)
    if args.serve_http:
        from repro_torch.serving.frontend import EngineService, serve_http_background
        svc = EngineService(eng, seed=args.seed).start()
        fe, stop, th = serve_http_background(svc, args.host, args.port)
        print(f"serving {args.arch}/{args.method} (tp {eng.tp}) on http://{args.host}:{fe.port} "
              "(POST /generate, GET /metrics /stats /healthz)", flush=True)
        try:
            while th.is_alive():
                th.join(0.5)            # a timed join lets Ctrl-C through
        except KeyboardInterrupt:
            pass
        finally:
            stop.set()
            th.join()
            svc.stop()
            if eng.last_metrics is not None:
                _finish_run(args, eng.last_metrics, obs)
        return
    n_req = args.requests or args.batch
    stream = needle_stream(cfg.vocab_size, args.context, args.page_size)
    reqs = [Request(uid=i, tokens=next(stream).tokens, max_new_tokens=args.new_tokens,
                    priority=int(args.preempt and i == n_req - 1)) for i in range(n_req)]
    for out in eng.generate(reqs):
        steps = max(out.steps, 1)
        print(f"req {out.uid}: {out.tokens}")
        print(f"  prefill {out.prefill_s*1e3:.1f} ms | "
              f"decode {out.decode_s/steps*1e3:.1f} ms/step | "
              f"corr_rate {out.stats.get('correction_rate', 0):.3f}")
    _finish_run(args, eng.last_metrics, obs)


def _finish_run(args, em, obs):
    """The end-of-run report of both modes: spec-decode and SLO lines, the
    summary as one JSON line, and the files asked for."""
    sd = em.specdec_summary()
    if sd["draft_len"] > 0:
        print(f"spec-decode (draft_len={sd['draft_len']}): accept rate {sd['accept_rate']:.3f} | "
              f"{sd['tokens_per_step']:.2f} tokens per target step over {sd['verify_steps']} "
              f"verify steps, {sd['idle_iterations']} idle")
    slo = em.slo_summary()
    if slo["tagged"]:
        print(f"SLO (ttft<={slo['ttft_ms']}ms, itl<={slo['itl_ms']}ms): {slo['attained']}/"
              f"{slo['tagged']} attained ({slo['attainment']:.1%}) | goodput "
              f"{slo['goodput_tokens_per_s']:.1f} tok/s (total {em.tokens_per_s:.1f} tok/s)")
    if args.metrics_out:
        em.registry.write_jsonl(args.metrics_out, extra={"arch": args.arch,
                                                         "method": args.method, "tp": em.tp})
        print(f"metrics snapshot appended to {args.metrics_out}")
    if args.prom_out:
        with open(args.prom_out, "w", encoding="utf-8") as f:
            f.write(em.registry.to_prometheus())
        print(f"prometheus exposition written to {args.prom_out}")
    if args.trace_out and obs.trace.enabled:
        obs.trace.write(args.trace_out)
        print(f"trace written to {args.trace_out} ({len(obs.trace.events)} events)")
    print(json.dumps(em.summary()), flush=True)


if __name__ == "__main__":
    main()
