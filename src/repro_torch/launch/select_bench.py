"""Page selection on the card as the retrievers call it: FreeKV's
``selection.select_pages`` and Centroid's ``centroid_index.centroid_select``
at the main path's shapes (llama31-8b widths: B=4, kv=8, G=4, d=128, the 259
pages of an 8192-token context, n_sel=56, 16 clusters, m=224; bf16), and the
designed inputs the card checks use (``select_inputs``).

    PYTHONPATH=src python -m repro_torch.launch.select_bench [--iters 200] \
        [--splits 1 2 4 8] [--lib other/libpage_scores.so]

For each: profiler device ms per call, CUDA-event ms per call back to back
(the host's launch gaps included), and per call the PyTorch ops the host
dispatched (``aten::`` rows) and the device operations (kernels and copies)
it ran. Only the public functions are used, so another checkout is measured
by putting its ``src`` first on the path:
``PYTHONPATH=<other>/src python src/repro_torch/launch/select_bench.py``.
``--splits`` also times the two fused kernels with each given number of
blocks a row; ``--lib`` times another build of ``csrc/page_scores.cu``. Prints the card's name and power limit and one JSON line.
Needs a card.
"""
import argparse
import json
import subprocess
import sys

import torch

B, KV, G, D, P = 4, 8, 4, 128, 32
N_PAGES, N_SEL, N_CENT = 259, 56, 16
N_SINK, N_WIN = 128, 128 + 32


def select_inputs(kind, B, kv, G, d, N, n_sel, dtype, g, dev, page_size=P, n_sink=N_SINK,
                  n_window=N_WIN):
    """q (B, kv, G, d), summ (B, N, kv, 2, d), length (B,) int32 (pages
    [n_sink / p, N - 2 - n_window / p) selectable) whose top n_sel pooled
    values are far apart ("distinct": 2 n_sel pages at levels 1 + j/64 over
    a floor of zeros), tie by construction ("tie": a sparse set of
    identical pages at the top and a second below it, spread over the whole
    row, the rest far below), tie at probability 0.0 ("underflow": ten pages
    on top, every other score so far below that its softmax probability
    underflows), or are random ("random"). q is positive in the designed
    kinds, so every query row's bound grows with a page's level; the levels
    are exact in bfloat16."""
    length = torch.full((B,), (N - 2) * page_size + 7, dtype=torch.int32, device=dev)
    if kind == "random":
        q = torch.randn(B, kv, G, d, generator=g, device=dev).to(dtype)
        summ = torch.sort(torch.randn(B, N, kv, 2, d, generator=g, device=dev), dim=3).values
        return q, summ.to(dtype), length
    q = (torch.randn(B, kv, G, d, generator=g, device=dev).abs() + 0.1).to(dtype)
    level = torch.zeros(B, N, kv, device=dev)
    first, last = n_sink // page_size, N - 2 - n_window // page_size
    pages = torch.arange(N, device=dev)
    if kind == "distinct":
        for b in range(B):
            for h in range(kv):
                pick = first + torch.randperm(last - first, generator=g, device=dev)[:2 * n_sel]
                level[b, pick, h] = 1.0 + torch.arange(len(pick), device=dev) / 64.0
    elif kind in ("tie", "underflow"):
        level[:] = -60.0
        if kind == "tie":
            level[:, pages % max(2, N // 40) == 1] = 2.0
            level[:, pages % max(3, N // 30) == 2] = 1.0
        else:
            level[:, pages % max(2, N // 10) == 3] = 2.0
    else:
        raise ValueError(f"unknown input kind {kind!r}")
    summ = level[..., None, None].expand(B, N, kv, 2, d)
    return q, summ.contiguous().to(dtype), length


def tie_aware_mismatch(idx, want_idx, want_pooled):
    """The check for random inputs, where near-ties may order differently
    between two summation orders: None when every row has as many valid
    ids as the plain version's, no id twice, and every chosen id's plain
    pooled value >= the plain k-th value less 2e-5 of it; else what
    differs."""
    if not torch.equal((idx >= 0).sum(-1), (want_idx >= 0).sum(-1)):
        return "valid id counts differ"
    n = idx.shape[-1]
    for row, wrow, prow in zip(idx.reshape(-1, n), want_idx.reshape(-1, n),
                               want_pooled.reshape(-1, want_pooled.shape[-1])):
        got, want = row[row >= 0].long(), wrow[wrow >= 0].long()
        if len(want) == 0:
            continue
        if len(set(got.tolist())) != len(got):
            return "an id chosen twice"
        kth = prow[want].min()
        if not bool((prow[got] >= kth - 2e-5 * kth.abs()).all()):
            return "a chosen page's plain pooled value is below the k-th"
    return None


def _profile(fn, iters):
    """(device ms, aten ops, device operations) per call over ``iters`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = prof.key_averages()
        rows = [e for e in ev if e.device_type == DeviceType.CUDA]
        n_dev = sum(e.count for e in rows)
        if n_dev >= iters:
            return (sum(e.self_device_time_total for e in rows) / 1e3 / iters,
                    sum(e.count for e in ev if e.key.startswith("aten::")) / iters,
                    n_dev / iters)
    raise RuntimeError("torch.profiler lost the device events of 3 sessions in a row")


def _event_ms(fn, iters):
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--splits", type=int, nargs="*", default=[],
                    help="also time the two kernels with this many blocks a row "
                         "(ops.select_split forced), MeanS and mean_qk")
    ap.add_argument("--lib", default=None,
                    help="a library built from another version of csrc/page_scores.cu "
                         "(same entry points) to time in place of this checkout's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("select_bench: needs a CUDA device", file=sys.stderr)
        return 1
    if args.lib:
        import ctypes

        from repro_torch.kernels import build
        lib = ctypes.CDLL(args.lib)
        for fn, argtypes in build.SIGNATURES["page_scores"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        build._LIBS["page_scores"] = lib
    import inspect

    from repro_torch.configs import get_config
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.core import centroid_index, selection

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    cfg = get_config("llama31-8b")
    fkv = FreeKVConfig(method="centroid")
    g = torch.Generator(device=dev).manual_seed(0)
    q, summ, length = select_inputs("random", B, KV, G, D, N_PAGES, N_SEL, torch.bfloat16, g,
                                    dev)
    q = q.reshape(B, KV * G, D)
    # the retrievers' call: no pooled scores where the function can leave them out
    kw = ({"with_pooled": False}
          if "with_pooled" in inspect.signature(selection.select_pages).parameters else {})
    state = {"summ": summ, "length": length}
    state.update(centroid_index.build(summ, length, N_CENT, P, summ.dtype))
    runs = {"freekv select_pages": lambda: selection.select_pages(cfg, fkv, q, summ, length,
                                                                  N_SEL, **kw),
            "centroid centroid_select": lambda: centroid_index.centroid_select(cfg, fkv, q, state,
                                                                               N_SEL)}
    out = {"device": torch.cuda.get_device_name(0), "smi": smi}
    for name, fn in runs.items():
        for _ in range(10):
            fn()
        dev_ms, aten_ops, dev_ops = _profile(fn, args.iters)
        out[name] = {"device_ms": dev_ms, "call_ms": _event_ms(fn, args.iters),
                     "aten_ops_per_call": aten_ops, "device_ops_per_call": dev_ops}
    if args.splits:
        out["splits"] = _splits(args.splits, q.reshape(B, KV, G, D), summ, length, state,
                                args.iters)
    print(json.dumps(out), flush=True)
    return 0


def _splits(splits, q, summ, length, state, iters):
    """Device ms of select_pages (MeanS and mean_qk) and centroid_candidates
    at the main shape with S blocks a row, for each S given."""
    from repro_torch.kernels import ops
    kw = dict(scale=1.0 / D ** 0.5, page_size=P, n_sink=N_SINK, n_window=N_WIN)
    runs = {f"select_pages {mode}": (lambda mode=mode: ops.select_pages(
        q, summ, length, n_sel=N_SEL, mode=mode, **kw)) for mode in ("mean_softmax", "mean_qk")}
    runs["centroid_candidates"] = lambda: ops.centroid_candidates(
        q, state["cent"], state["cent_count"], state["cent_assign"], length, m=4 * N_SEL, **kw)
    auto = ops.select_split
    out = {}
    try:
        for S in splits:
            ops.select_split = lambda N, rows, sms, S=S: min(S, N)
            out[str(S)] = {name: _profile(fn, iters)[0] for name, fn in runs.items()}
    finally:
        ops.select_split = auto
    return out


if __name__ == "__main__":
    sys.exit(main())
