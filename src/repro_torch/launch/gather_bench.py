"""The host-pool gathers on the card: their time from pinned host pools
beside the link's ceiling, at every lane valid and at other shares of valid
lanes, and what a gather on the staged-recall stream costs the decode's
attention on the main stream.

    PYTHONPATH=src python -m repro_torch.launch.gather_bench [--shares 1.0 0.1] \
        [--overlap-shares 1.0 0.062] [--rounds 5]

Shapes are the main path's: pools (4, 259, 8, 2, 32, 128) bf16, and int8
and int4 at group 0 with bf16 output; idx (4, 8, 56). Every time is
profiler device ms per call (``device_ms``: CUDA events behind a spin where
the profiler drops a session's device events three times), cycling through four selections whose pages are
disjoint per (request, KV head), so no call reads a page an earlier one left
in L2 (the card's L2 keeps system-memory reads). A share below 1 leaves each
lane valid with that probability and -1 otherwise. The link's ceiling is one
contiguous ``copy_`` of the same bytes from pinned host memory (the copy
engine), a yardstick the port never calls.

The overlap line times 32 ``paged_attention`` launches (one decode step's,
B=4, kv=8, G=4, d=128, 65 pages of 32 tokens a layer, K/V cycling through
copies larger than L2) on the main stream with CUDA events, alone and while
``recall_gather`` runs on ``recall_pipeline.side_stream``, at each share
of valid lanes given (``--overlap-shares``), and the gather alone and
beside them. A spin on the main stream holds both streams until the host
has queued everything, so the two start together and the host's launch
gaps stay out of the attention's time.

Only the public wrappers are used, so another checkout's kernels are
measured by putting its ``src`` first on the path:
``PYTHONPATH=<other>/src python src/repro_torch/launch/gather_bench.py``.
Prints the card's name and power limit and one JSON line. Needs a card and
nvcc.
"""
import argparse
import json
import statistics
import subprocess
import sys

import torch

B, KV, G, D, P = 4, 8, 4, 128, 32
N_PAGES, N_SEL, N_ATT = 259, 56, 65   # pool pages (8192-token context), selected, attended
LAYERS = 32
N_SETS = 4                            # 4 x 56 disjoint pages of the 259
SPIN_CYCLES = 30_000_000              # ~15 ms at the H100's clocks: longer than queueing a step


EVENT_TIMED = []                      # (iters, ms) of each device_ms that fell back to events


def device_ms(fn, args_list, iters=40, tries=3):
    """Device ms per call (kernels and copies), cycling through
    ``args_list``. Every call puts at least one operation on the card.

    The time is the sum of the card-side rows of a torch.profiler trace.
    A profiler session that recorded fewer operations than calls (the
    profiler sometimes drops a session's device events) runs again, up to
    ``tries`` times; after that the calls are timed with CUDA events
    behind a spin (``spin_event_ms``), which also holds the card's own
    launch gaps between calls (a microsecond or two each), and the time is
    appended to ``EVENT_TIMED`` and noted on stderr."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for a in args_list[:2]:
        fn(*a)
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*args_list[i % len(args_list)])
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if sum(e.count for e in rows) >= iters:
            return sum(e.self_device_time_total for e in rows) / 1e3 / iters
    ms = spin_event_ms(fn, args_list, iters)
    EVENT_TIMED.append((iters, ms))
    print(f"device_ms: torch.profiler lost the device events of {tries} sessions in a row; "
          f"timed with CUDA events behind a spin: {ms} ms a call", file=sys.stderr, flush=True)
    return ms


def spin_event_ms(fn, args_list, iters, spins=4):
    """CUDA-event ms per call over ``iters`` calls queued while a spin holds
    the stream, so the calls run back to back with none of the host's
    launch gaps. The spin doubles (up to ``spins`` times) until it is still
    running when the host has queued the last call; this raises if it
    never is."""
    cycles = SPIN_CYCLES
    for _ in range(spins):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        spun = torch.cuda.Event()
        spun.record()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
        stop.record()
        held = not spun.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(stop) / iters
        cycles *= 2
    raise RuntimeError(f"queueing {iters} calls outlasted a spin of {cycles // 2} cycles: "
                       "their CUDA-event time would hold the host's launch gaps")


def selections(gen, dev, share=1.0):
    """N_SETS idx (B, KV, N_SEL) int32 with disjoint pages per (request, KV
    head); each lane valid with probability ``share``, else -1."""
    perm = torch.stack([torch.randperm(N_PAGES, generator=gen, device=dev)
                        for _ in range(B * KV)]).reshape(B, KV, N_PAGES)
    out = []
    for i in range(N_SETS):
        idx = perm[..., i * N_SEL:(i + 1) * N_SEL].to(torch.int32)
        if share < 1.0:
            keep = torch.rand(idx.shape, generator=gen, device=dev) < share
            idx = torch.where(keep, idx, torch.full_like(idx, -1))
        out.append(idx.contiguous())
    return out


def link_ms(nbytes, dev):
    """The link's ceiling for ``nbytes``: device ms of one contiguous
    ``copy_`` from pinned host memory to the card, alternating two sources."""
    srcs = [torch.empty(nbytes, dtype=torch.uint8).pin_memory() for _ in range(2)]
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    return device_ms(lambda s: dst.copy_(s, non_blocking=True), [(s,) for s in srcs])


def gather_cases(ops, dev, gen):
    """name -> (call(idx), bytes over the link per valid lane) for the four
    gathers (the quantized ones at int8 and int4) from pinned host pools at
    the main path's shapes."""
    from repro_torch.quant.quantizers import quantize_block
    pool = torch.randn(B, N_PAGES, KV, 2, P, D, generator=gen, device=dev).to(torch.bfloat16)
    page = 2 * P * D * 2
    host = pool.cpu().pin_memory()
    cases = {"recall_gather": (lambda i: ops.recall_gather(host, i), page),
             "recall_values": (lambda i: ops.recall_values(host, i), page // 2)}
    for bits in (8, 4):
        q, s = quantize_block(pool.float(), bits, 0)
        hq, hs = q.cpu().pin_memory(), s.cpu().pin_memory()
        qpage = 2 * P * D * bits // 8 + 2 * s.shape[-1] * 4
        cases[f"recall_gather_quant int{bits}"] = (
            lambda i, hq=hq, hs=hs, bits=bits: ops.recall_gather_quant(
                hq, hs, i, bits=bits, out_dtype=torch.bfloat16), qpage)
        cases[f"recall_values_quant int{bits}"] = (
            lambda i, hq=hq, hs=hs, bits=bits: ops.recall_values_quant(
                hq, hs, i, bits=bits, out_dtype=torch.bfloat16), qpage // 2)
    return cases


def time_gathers(ops, dev, gen, shares=(1.0,)):
    """name -> {"link_ms": ceiling for the all-valid bytes, "full_bytes",
    "by_share": {share: {"ms", "valid_lanes", "moved_bytes"}}}."""
    cases = gather_cases(ops, dev, gen)
    sels = {s: selections(gen, dev, s) for s in shares}
    links, out = {}, {}
    for name, (call, per_lane) in cases.items():
        rows = {}
        for s, idx_sets in sels.items():
            valid = sum(int((i >= 0).sum()) for i in idx_sets) / len(idx_sets)
            rows[str(s)] = {"ms": device_ms(call, [(i,) for i in idx_sets]),
                            "valid_lanes": valid, "moved_bytes": valid * per_lane}
        full = B * KV * N_SEL * per_lane
        if full not in links:
            links[full] = link_ms(full, dev)
        out[name] = {"link_ms": links[full], "full_bytes": full, "by_share": rows}
    return out


def overlap(ops, dev, gen, rounds=5, gather=None, share=1.0):
    """-> medians over ``rounds``: attention_ms (32 paged_attention alone),
    attention_with_gather_ms, gather_ms (alone), gather_overlapped_ms (on
    the side stream beside the attention), and the attention's slowdown,
    with each lane of the gather valid at probability ``share``.
    ``gather(host_pool, idx)`` defaults to ``ops.recall_gather``."""
    gather = gather or ops.recall_gather
    from repro_torch.core.recall_pipeline import side_stream
    dt = torch.bfloat16
    attn = []
    for _ in range(4):                # 4 x 34 MB of K/V: the layers' cycle exceeds L2
        q = torch.randn(B, KV, G, D, generator=gen, device=dev).to(dt)
        k = torch.randn(B, KV, N_ATT, P, D, generator=gen, device=dev).to(dt)
        v = torch.randn(B, KV, N_ATT, P, D, generator=gen, device=dev).to(dt)
        pos = torch.arange(N_ATT * P, dtype=torch.int32, device=dev).reshape(1, 1, N_ATT, P)
        cur = torch.full((B,), N_ATT * P - 1, dtype=torch.int32, device=dev)
        attn.append((q, k, v, pos.expand(B, KV, -1, -1).contiguous(), cur))
    host = torch.randn(B, N_PAGES, KV, 2, P, D, generator=gen, device=dev).to(dt).cpu().pin_memory()
    sels = selections(gen, dev, share)
    main, side = torch.cuda.current_stream(dev), side_stream(dev)

    def one(i, with_attn, with_gather):
        torch.cuda.synchronize(dev)
        torch.cuda._sleep(SPIN_CYCLES)
        go = torch.cuda.Event()
        go.record(main)
        side.wait_event(go)
        a0, a1, g0, g1 = (torch.cuda.Event(enable_timing=True) for _ in range(4))
        if with_gather:
            with torch.cuda.stream(side):
                g0.record(side)
                gather(host, sels[i % len(sels)])
                g1.record(side)
        a0.record(main)
        if with_attn:
            for layer in range(LAYERS):
                ops.paged_attention(*attn[layer % len(attn)], scale=D ** -0.5)
        a1.record(main)
        torch.cuda.synchronize(dev)
        return (a0.elapsed_time(a1) if with_attn else None,
                g0.elapsed_time(g1) if with_gather else None)

    one(0, True, True)                                 # warm both up
    rows = {"attention_ms": [], "attention_with_gather_ms": [], "gather_ms": [],
            "gather_overlapped_ms": []}
    for i in range(rounds):
        rows["attention_ms"].append(one(i, True, False)[0])
        a, g = one(i, True, True)
        rows["attention_with_gather_ms"].append(a)
        rows["gather_overlapped_ms"].append(g)
        rows["gather_ms"].append(one(i, False, True)[1])
    out = {k: statistics.median(v) for k, v in rows.items()}
    out["attention_slowdown_ms"] = out["attention_with_gather_ms"] - out["attention_ms"]
    out["rounds"] = rounds
    out["valid_lanes"] = sum(int((i >= 0).sum()) for i in sels) / len(sels)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shares", type=float, nargs="+", default=[1.0])
    ap.add_argument("--overlap-shares", type=float, nargs="+", default=[1.0])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gather_bench: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    from repro_torch.kernels import ops
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    # the overlap first: a process whose profiler has run many sessions can
    # serialize the two streams
    res = {"device": smi, "ops": ops.__file__,
           "overlap": {str(s): overlap(ops, dev, gen, args.rounds, share=s)
                       for s in args.overlap_shares}}
    res["gathers"] = time_gathers(ops, dev, gen, tuple(args.shares))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
