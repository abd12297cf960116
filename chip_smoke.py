"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # every phase (what the check runs)
    python3 chip_smoke.py --kernels-only  # build + kernel phase only

Phases, each fatal on failure (nothing is caught):
  1. device: the card's name and power limit from nvidia-smi, its PCIe link
     (generation and width from nvidia-smi and sysfs, "not readable" where
     the machine hides them) and NUMA node; exits non-zero without CUDA.
  2. build: the six CUDA sources (nine kernel entry points) from this
     checkout, one nvcc per source, in parallel.
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes (B=4, kv=8, G=4, H=32, d=128, p=32, n_sel=56,
     L=2080, T=8192, the 259 pages of an 8192-token context, C=16
     clusters), in bfloat16 and float32, with the tolerances of TOL: the
     gathers (recall_gather and recall_values; recall_gather_quant and
     recall_values_quant at int8 and int4, groups 0/16/32) exact from a
     device pool and from a pinned host pool, page_summary exact,
     flash_prefill within TOL plus a sliding-window case and a softcap case,
     centroid_scores within 2e-5 with empty clusters at exactly -1e30;
     device times of the kernel, its plain version and one PyTorch call that
     computes the same function (a yardstick the port never calls), beside
     the bound; for the two attention kernels also the yardstick's own
     max |error| against the plain version and whether it is within TOL.
     The host-pool gathers are timed cycling four selections with disjoint
     pages (the card's L2 keeps system-memory reads), beside the link's
     ceiling: one contiguous copy_ of the same bytes from pinned memory,
     and each logs the grid it launches from a pinned and from a device pool.
  4. main path: ServeEngine(scheduler="static") serving llama31-8b at full
     width (32 layers, seeded random bf16 weights) with FreeKV defaults,
     recall_overlap=True and the KV pool in pinned host memory: 4 requests
     of 8192-token needle prompts, 40 greedy tokens each (so a page
     completes during decode), five times: method freekv with kv_quant none
     and int8, shadowkv with none and int8, centroid with none. Every
     kernel's launch count is zeroed just before each run and read just
     after; each kernel the run takes must rise. ShadowKV's low-rank key
     factorization is timed at one layer's shape. Then, in a fresh process
     (launch/gather_bench.py), the overlap line: 32 paged_attention (one
     decode step's) alone and beside recall_gather on the staged-recall
     stream; and the four gathers again at the valid share of freekv/none's
     top-up and staged recall launches (with --kernels-only: the overlap
     line only, after phase 3).
  5. kernel path == plain path: granite-3-8b-smoke at float32 gives the same
     greedy tokens on the card (kernels) and on the CPU (plain versions):
     freekv and shadowkv under kv_quant none, int8 and int4, centroid under
     none and int8 with a re-center at every completed page; and the
     centroid index kept step by step on the card equals its rebuild bit
     for bit.
Then one JSON line with the kernels' numbers and, last, the ok line.
"""
import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# card data sheet (H100 SXM): HBM rate, dense bf16 tensor-core peak (the
# timed inputs are bf16), PCIe Gen5 x16 per direction
HBM_BPS = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12}
PCIE_BPS = 64e9
L2_BYTES = 50 * 2 ** 20
# a kernel against its plain version on the same inputs, by OUTPUT dtype. The
# two compute in float32 and differ only in summation order; a bfloat16
# output is that result rounded once, so the two may land one bf16 step
# apart: rtol 2**-6 is two steps of bf16's 8-bit significand, and atol 1e-4
# is under 0.3% of paged_attention's typical output (~0.036 at L=2080).
# tests/test_kernels.py's 5e-2 is for bfloat16 against JAX's oracle, a
# different computation, and is not used here.
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=1e-4, rtol=2 ** -6)}


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def log(msg):
    print(msg, flush=True)


def time_ms(fn, args_list, iters=50):
    """(device ms, call ms) per call over ``iters`` calls cycling through
    ``args_list`` (copies of the inputs, sized so the cycle exceeds L2).

    Device ms sums the card-side rows (kernels, copies) of a torch.profiler
    trace of the calls: the time the card spends (launch/gather_bench.py
    device_ms, which runs a session again when the profiler drops its
    device events, and fails after three such sessions). Call ms is
    CUDA-event time per call, which also holds the gaps while the host
    launches the next call; for a kernel of a few microseconds that gap is
    most of it."""
    from repro_torch.launch.gather_bench import device_ms
    for a in args_list[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    stop.record()
    torch.cuda.synchronize()
    return device_ms(fn, args_list, iters), start.elapsed_time(stop) / iters


def copies_for(nbytes):
    return max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1)))


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def link_info(dev):
    """The card's PCIe link as nvidia-smi and sysfs report it, and its NUMA
    node; "not readable" where neither says (a machine may hide both)."""
    q = subprocess.run(["nvidia-smi", "--query-gpu=pcie.link.gen.current,pcie.link.width.current",
                        "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    gen_width = [x.strip() for x in q.stdout.strip().split(",")] if q.returncode == 0 else []
    pr = torch.cuda.get_device_properties(dev)
    bus = f"{pr.pci_domain_id:04x}:{pr.pci_bus_id:02x}:{pr.pci_device_id:02x}.0"
    sysfs = Path("/sys/bus/pci/devices") / bus

    def read(name):
        try:
            return (sysfs / name).read_text().strip()
        except OSError:
            return "not readable"
    return {"pci_bus": bus,
            "nvidia_smi_gen": gen_width[0] if gen_width else "not readable",
            "nvidia_smi_width": gen_width[1] if len(gen_width) > 1 else "not readable",
            "sysfs_speed": read("current_link_speed"), "sysfs_width": read("current_link_width"),
            "numa_node": read("numa_node")}


def run_gather_bench(share):
    """launch/gather_bench.py in a fresh process: the overlap line with
    every lane valid, and the four gathers likewise; when phase 4 measured
    the main path's valid shares, the gathers at both and the overlap line
    at the staged recall's too -> its JSON line."""
    root = Path(__file__).resolve().parent
    shares = ["1.0"] + ([repr(v) for v in share.values()] if share else [])
    overlap_shares = ["1.0"] + ([repr(share["staged"])] if share else [])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src")] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.gather_bench", "--shares",
                          *shares, "--overlap-shares", *overlap_shares], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    require(out.returncode == 0, f"gather_bench exited {out.returncode}:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def host_gather_grid(ops, source, dev, halves):
    """The grids a gather of csrc/<source>.cu launches at the main shape,
    from a pinned host pool (and the SMs' worth that is, by the runtime's
    occupancy) and from a device pool; ``halves`` units an item (2 for K and
    V, 1 for V only)."""
    bps = ops.gather_blocks_per_sm(source, dev.index)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = ops.gather_grid(halves * B * KV * N_SEL, sms, bps, True)
    return {"host_grid_blocks": grid, "blocks_per_sm": bps, "host_sms": grid / bps,
            "device_grid_blocks": ops.gather_grid(halves * B * KV * N_SEL, sms, bps, False)}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at the main path's shapes
# ---------------------------------------------------------------------------
B, KV, G, D, P, N_SEL = 4, 8, 4, 128, 32, 56
N_SINK, N_WIN = 128, 128 + 32
L = N_SINK + N_WIN + N_SEL * P            # 2080
CONTEXT, NEW_TOKENS = 8192, 40            # 40: the 32nd decode step completes a page
MAX_LEN = CONTEXT + 2 * NEW_TOKENS
N_PAGES = -(-MAX_LEN // P)                # 259
H = KV * G                                # 32 query heads
N_CENT = 16                               # FreeKVConfig.centroid_count


def _sdpa_paged_inputs(q, k, v, pos, cur):
    """Paged attention's inputs as SDPA takes them: K/V heads expanded to the
    G query heads and a boolean mask over the same keys."""
    n = k.shape[2] * k.shape[3]
    kk = k.reshape(B, KV, n, D).repeat_interleave(G, dim=1)
    vv = v.reshape(B, KV, n, D).repeat_interleave(G, dim=1)
    mask = ((pos >= 0) & (pos <= cur[:, None, None, None])).reshape(B, KV, 1, n)
    return q.reshape(B, KV * G, 1, D), kk, vv, mask.repeat_interleave(G, dim=1)


def _sdpa(q, k, v, mask, scale):
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)


def _library_precision(got, want, dt):
    """The yardstick's own max |error| against the plain version, and
    whether it lies within the TOL the kernel is held to."""
    return {"library_max_abs_err": (got.float() - want.float()).abs().max().item(),
            "library_within_tol": bool(torch.allclose(got.float(), want.float(), **TOL[dt]))}


def check_paged_attention(ops, ref, dev, gen):
    out = {}
    lib_prec = None
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn(B, KV, G, D, generator=gen, device=dev).to(dt)
        k = torch.randn(B, KV, L // P, P, D, generator=gen, device=dev).to(dt)
        v = torch.randn(B, KV, L // P, P, D, generator=gen, device=dev).to(dt)
        pos = torch.randint(-1, CONTEXT + 8, (B, KV, L // P, P), generator=gen,
                            device=dev, dtype=torch.int32)
        pos[:, :, 5] = -1                             # a fully masked page
        cur = torch.full((B,), CONTEXT, dtype=torch.int32, device=dev)  # some pos > cur
        scale = 1.0 / math.sqrt(D)
        got = ops.paged_attention(q, k, v, pos, cur, scale=scale)
        want = ref.paged_attention_ref(q, k, v, pos, cur, scale)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        require(torch.allclose(got.float(), want.float(), **TOL[dt]),
                f"paged_attention {dt}: max |err| {err} (max |want| "
                f"{want.float().abs().max().item()}), tolerance {TOL[dt]}")
        out[dt] = err
        if dt == torch.bfloat16:
            lib = _sdpa(*_sdpa_paged_inputs(q, k, v, pos, cur), scale).reshape(B, KV, G, D)
            lib_prec = _library_precision(lib, want, dt)
    # timing at bf16, the main path's dtype
    dt = torch.bfloat16
    n = copies_for(2 * B * KV * L * D * 2)
    args = []
    for _ in range(n):
        q = torch.randn(B, KV, G, D, generator=gen, device=dev).to(dt)
        k = torch.randn(B, KV, L // P, P, D, generator=gen, device=dev).to(dt)
        v = torch.randn(B, KV, L // P, P, D, generator=gen, device=dev).to(dt)
        pos = torch.arange(L, dtype=torch.int32, device=dev).reshape(1, 1, L // P, P)
        pos = pos.expand(B, KV, -1, -1).contiguous()
        cur = torch.full((B,), L - 1, dtype=torch.int32, device=dev)
        args.append((q, k, v, pos, cur))
    scale = 1.0 / math.sqrt(D)
    ms, call_ms = time_ms(lambda *a: ops.paged_attention(*a, scale=scale), args)
    plain_ms, _ = time_ms(lambda *a: ref.paged_attention_ref(*a, scale), args, iters=10)
    # yardstick: SDPA with a boolean mask over the same keys, timed on inputs
    # already expanded to the G query heads
    sdpa_args = [_sdpa_paged_inputs(*a) for a in args]
    lib_ms, _ = time_ms(lambda q, k, v, m: _sdpa(q, k, v, m, scale), sdpa_args)
    q, k, v, pos, cur = args[0]
    byts = nbytes(q, k, v, pos, cur, q)
    flops = 4 * B * KV * G * L * D
    return {"name": "paged_attention", "shape": f"q({B},{KV},{G},{D}) kv({B},{KV},{L // P},{P},{D})",
            "bound_bytes": byts, "bound_ops": flops,
            "bound_ms": 1e3 * max(byts / HBM_BPS, flops / PEAK_OPS[dt]),
            "bound_by": "bytes" if byts / HBM_BPS >= flops / PEAK_OPS[dt] else "operations",
            "max_abs_err": out[torch.bfloat16], "max_abs_err_fp32": out[torch.float32],
            "tol": TOL[torch.bfloat16], "tol_fp32": TOL[torch.float32],
            "kernel_ms": ms, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_call": "scaled_dot_product_attention(bool mask)",
            **lib_prec}


def check_page_scores(ops, ref, dev, gen):
    out = {}

    def inputs(dt):
        q = torch.randn(B, KV, G, D, generator=gen, device=dev).to(dt)
        summ = torch.sort(torch.randn(B, N_PAGES, KV, 2, D, generator=gen, device=dev),
                          dim=3).values.to(dt)
        return q, summ

    scale = 1.0 / math.sqrt(D)
    tol = TOL[torch.float32]          # the output is float32 for either input dtype
    for dt in (torch.float32, torch.bfloat16):
        q, summ = inputs(dt)
        got = ops.page_scores(q, summ, scale=scale)
        want = ref.page_scores_ref(q, summ, scale)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        require(torch.allclose(got, want, **tol),
                f"page_scores {dt}: max |err| {err}, tolerance {tol}")
        out[dt] = err
    dt = torch.bfloat16
    args = [inputs(dt) for _ in range(copies_for(B * N_PAGES * KV * 2 * D * 2))]
    ms, call_ms = time_ms(lambda q, s: ops.page_scores(q, s, scale=scale), args)
    plain_ms, _ = time_ms(lambda q, s: ref.page_scores_ref(q, s, scale), args, iters=10)
    # yardstick: relu(q) @ hi^T + min(q, 0) @ lo^T, two matmuls
    mm_args = [(torch.relu(q), torch.clamp(q, max=0),
                s[..., 1, :].permute(0, 2, 3, 1), s[..., 0, :].permute(0, 2, 3, 1))
               for q, s in args]
    lib_ms, _ = time_ms(lambda qp, qn, hi, lo: (torch.matmul(qp, hi) + torch.matmul(qn, lo)) * scale,
                        mm_args)
    q, summ = args[0]
    byts = nbytes(q, summ) + B * KV * G * N_PAGES * 4
    flops = 4 * B * KV * G * N_PAGES * D
    return {"name": "page_scores", "shape": f"q({B},{KV},{G},{D}) summ({B},{N_PAGES},{KV},2,{D})",
            "bound_bytes": byts, "bound_ops": flops,
            "bound_ms": 1e3 * max(byts / HBM_BPS, flops / PEAK_OPS[dt]),
            "bound_by": "bytes" if byts / HBM_BPS >= flops / PEAK_OPS[dt] else "operations",
            "max_abs_err": out[torch.bfloat16], "max_abs_err_fp32": out[torch.float32],
            "tol": tol, "tol_fp32": tol,
            "kernel_ms": ms, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_call": "2x torch.matmul"}


def check_recall_gather(ops, ref, dev, gen):
    errs = []
    for dt in (torch.float32, torch.bfloat16):
        pool = torch.randn(B, N_PAGES, KV, 2, P, D, generator=gen, device=dev).to(dt)
        idx = torch.randint(-1, N_PAGES, (B, KV, N_SEL), generator=gen, device=dev,
                            dtype=torch.int32)
        want = ref.recall_gather_ref(pool, idx)
        for src in (pool, pool.cpu().pin_memory()):
            got = ops.recall_gather(src, idx)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                err = (a.float() - b.float()).abs().max().item()
                require(torch.equal(a, b), f"recall_gather {dt} from {src.device}: "
                        f"not bit-exact (max |err| {err})")
                errs.append(err)
    # timing at bf16, every lane valid (the bound's worst case), from the
    # pinned pool cycling selections with disjoint pages (no call reads a
    # page an earlier one left in L2), beside the link's ceiling
    from repro_torch.launch import gather_bench
    dt = torch.bfloat16
    pool = torch.randn(B, N_PAGES, KV, 2, P, D, generator=gen, device=dev).to(dt)
    host = pool.cpu().pin_memory()
    sels = gather_bench.selections(gen, dev)
    idx = sels[0]
    ms_host, call_ms = time_ms(ops.recall_gather, [(host, i) for i in sels])
    ms_dev, _ = time_ms(ops.recall_gather, [(pool, idx)])
    plain_ms, _ = time_ms(ref.recall_gather_ref, [(pool, idx)])
    bI = torch.arange(B, device=dev)[:, None, None]
    kI = torch.arange(KV, device=dev)[None, :, None]
    lib_ms, _ = time_ms(lambda p_, i_: p_[bI, i_.long(), kI], [(pool, idx)])
    valid = int((idx >= 0).sum())
    moved = valid * 2 * P * D * 2
    written = 2 * B * KV * N_SEL * P * D * 2
    byts = moved + written + nbytes(idx)
    bound_host = 1e3 * max(moved / PCIE_BPS, (written + nbytes(idx)) / HBM_BPS)
    return {"name": "recall_gather", "shape": f"pool({B},{N_PAGES},{KV},2,{P},{D}) idx({B},{KV},{N_SEL})",
            "bound_bytes": byts, "bound_ops": 0, "bound_ms": bound_host, "bound_by": "bytes",
            "bound_link": "PCIe for the pinned host pool",
            "link_ms": gather_bench.link_ms(moved, dev), "moved_bytes": moved,
            **host_gather_grid(ops, "recall_gather", dev, 2),
            "max_abs_err": max(errs), "tol": 0.0,
            "kernel_ms": ms_host, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
            "device_pool_ms": ms_dev, "device_pool_bound_ms": 1e3 * byts / HBM_BPS,
            "library_ms": lib_ms, "library_call": "advanced indexing on a device pool"}


def check_recall_gather_quant(ops, ref, dev, gen):
    from repro_torch.quant.quantizers import quantize_block
    errs = []
    for bits, group in ((8, 0), (4, 0), (8, 32), (4, 16)):
        pool_f = torch.randn(B, N_PAGES, KV, 2, P, D, generator=gen, device=dev)
        pool_f[:, 3] = 0                              # zero pages: scale 1
        pool, scales = quantize_block(pool_f, bits, group)
        idx = torch.randint(-2, N_PAGES, (B, KV, N_SEL), generator=gen, device=dev,
                            dtype=torch.int32)        # -1 and -2 lanes
        for dt in (torch.float32, torch.bfloat16):
            want = ref.recall_gather_quant_ref(pool, scales, idx, bits, dt)
            for src, ssrc in ((pool, scales), (pool.cpu().pin_memory(), scales.cpu().pin_memory())):
                got = ops.recall_gather_quant(src, ssrc, idx, bits=bits, out_dtype=dt)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    err = (a.float() - b.float()).abs().max().item()
                    require(a.dtype == dt and torch.equal(a, b),
                            f"recall_gather_quant int{bits} g{group} {dt} from {src.device}: "
                            f"not bit-exact (max |err| {err})")
                    errs.append(err)
    # timing at the main path's settings (group 0, bf16 out), every lane
    # valid, from the pinned host pool cycling selections with disjoint pages
    from repro_torch.launch import gather_bench
    sels = gather_bench.selections(gen, dev)
    idx = sels[0]
    dt = torch.bfloat16
    row = {}
    for bits in (8, 4):
        pool, scales = quantize_block(torch.randn(B, N_PAGES, KV, 2, P, D, generator=gen,
                                                  device=dev), bits, 0)
        hp, hs = pool.cpu().pin_memory(), scales.cpu().pin_memory()
        fn = lambda p_, s_, i_: ops.recall_gather_quant(p_, s_, i_, bits=bits, out_dtype=dt)
        ms_host, call_ms = time_ms(fn, [(hp, hs, i) for i in sels])
        ms_dev, _ = time_ms(fn, [(pool, scales, idx)])
        plain_ms, _ = time_ms(lambda p_, s_, i_: ref.recall_gather_quant_ref(p_, s_, i_, bits, dt),
                              [(pool, scales, idx)], iters=10)
        valid = int((idx >= 0).sum())
        moved = valid * (2 * P * D * bits // 8 + 2 * scales.shape[-1] * 4)
        written = 2 * B * KV * N_SEL * P * D * 2
        row[bits] = {"ms": ms_host, "call_ms": call_ms, "device_pool_ms": ms_dev,
                     "plain_ms": plain_ms, "moved_bytes": moved,
                     "bound_ms": 1e3 * max(moved / PCIE_BPS, (written + nbytes(idx)) / HBM_BPS),
                     "device_pool_bound_ms": 1e3 * (moved + written + nbytes(idx)) / HBM_BPS,
                     "link_ms": gather_bench.link_ms(moved, dev)}
    r8 = row[8]
    return {"name": "recall_gather_quant", "link_ms": r8["link_ms"],
            "moved_bytes": r8["moved_bytes"],
            **host_gather_grid(ops, "recall_gather_quant", dev, 2),
            "shape": f"pool({B},{N_PAGES},{KV},2,{P},{D}*bits/8) int8, scales({B},{N_PAGES},{KV},2,1) "
                     f"idx({B},{KV},{N_SEL}) -> bf16",
            "bound_bytes": r8["moved_bytes"], "bound_ops": 0, "bound_ms": r8["bound_ms"],
            "bound_by": "bytes", "bound_link": "PCIe for the pinned host pool",
            "max_abs_err": max(errs), "tol": 0.0,
            "kernel_ms": r8["ms"], "kernel_call_ms": r8["call_ms"], "plain_ms": r8["plain_ms"],
            "device_pool_ms": r8["device_pool_ms"],
            "device_pool_bound_ms": r8["device_pool_bound_ms"],
            "int4": row[4], "library_ms": None,
            "library_call": "none: no single PyTorch call gathers and dequantizes"}


def _distinct_idx(gen, dev):
    """Every lane valid, distinct pages per (b, kv head): the bound's worst case."""
    return torch.stack([torch.randperm(N_PAGES, generator=gen, device=dev)[:N_SEL]
                        for _ in range(B * KV)]).reshape(B, KV, N_SEL).to(torch.int32)


def check_recall_values(ops, ref, dev, gen):
    errs = []
    for dt in (torch.float32, torch.bfloat16):
        pool = torch.randn(B, N_PAGES, KV, 2, P, D, generator=gen, device=dev).to(dt)
        idx = torch.randint(-1, N_PAGES, (B, KV, N_SEL), generator=gen, device=dev,
                            dtype=torch.int32)
        want = ref.recall_values_ref(pool, idx)
        for src in (pool, pool.cpu().pin_memory()):
            got = ops.recall_values(src, idx)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            require(got.dtype == dt and torch.equal(got, want),
                    f"recall_values {dt} from {src.device}: not bit-exact (max |err| {err})")
            errs.append(err)
    from repro_torch.launch import gather_bench
    dt = torch.bfloat16
    pool = torch.randn(B, N_PAGES, KV, 2, P, D, generator=gen, device=dev).to(dt)
    host = pool.cpu().pin_memory()
    sels = gather_bench.selections(gen, dev)          # disjoint pages, every lane valid
    idx = sels[0]
    valid = int((idx >= 0).sum())
    moved = valid * P * D * 2
    written = B * KV * N_SEL * P * D * 2
    ms_host, call_ms = time_ms(ops.recall_values, [(host, i) for i in sels])
    # from the device pool, selections cycled so the pages read are not L2-resident
    dev_args = [(pool, _distinct_idx(gen, dev)) for _ in range(copies_for(moved + written))]
    ms_dev, _ = time_ms(ops.recall_values, dev_args)
    plain_ms, _ = time_ms(ref.recall_values_ref, dev_args)
    bI = torch.arange(B, device=dev)[:, None, None]
    kI = torch.arange(KV, device=dev)[None, :, None]
    lib_ms, _ = time_ms(lambda p_, i_: p_[bI, i_.long(), kI, 1], dev_args)
    return {"name": "recall_values",
            "shape": f"pool({B},{N_PAGES},{KV},2,{P},{D}) idx({B},{KV},{N_SEL}) -> V only",
            "bound_bytes": moved + written + nbytes(idx), "bound_ops": 0,
            "bound_ms": 1e3 * max(moved / PCIE_BPS, (written + nbytes(idx)) / HBM_BPS),
            "bound_by": "bytes", "bound_link": "PCIe for the pinned host pool",
            "link_ms": gather_bench.link_ms(moved, dev), "moved_bytes": moved,
            **host_gather_grid(ops, "recall_gather", dev, 1),
            "max_abs_err": max(errs), "tol": 0.0,
            "kernel_ms": ms_host, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
            "device_pool_ms": ms_dev,
            "device_pool_bound_ms": 1e3 * (moved + written + nbytes(idx)) / HBM_BPS,
            "library_ms": lib_ms, "library_call": "advanced indexing of pool[..., 1, :, :] "
                                                  "on a device pool"}


def check_recall_values_quant(ops, ref, dev, gen):
    from repro_torch.quant.quantizers import quantize_block
    errs = []
    for bits, group in ((8, 0), (4, 0), (8, 16), (4, 16), (8, 32), (4, 32)):
        pool_f = torch.randn(B, N_PAGES, KV, 2, P, D, generator=gen, device=dev)
        pool_f[:, 3] = 0                              # zero pages: scale 1
        pool, scales = quantize_block(pool_f, bits, group)
        idx = torch.randint(-2, N_PAGES, (B, KV, N_SEL), generator=gen, device=dev,
                            dtype=torch.int32)        # -1 and -2 lanes
        for dt in (torch.float32, torch.bfloat16):
            want = ref.recall_values_quant_ref(pool, scales, idx, bits, dt)
            for src, ssrc in ((pool, scales), (pool.cpu().pin_memory(), scales.cpu().pin_memory())):
                got = ops.recall_values_quant(src, ssrc, idx, bits=bits, out_dtype=dt)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                require(got.dtype == dt and torch.equal(got, want),
                        f"recall_values_quant int{bits} g{group} {dt} from {src.device}: "
                        f"not bit-exact (max |err| {err})")
                errs.append(err)
    from repro_torch.launch import gather_bench
    sels = gather_bench.selections(gen, dev)          # disjoint pages, every lane valid
    idx = sels[0]
    dt = torch.bfloat16
    row = {}
    for bits in (8, 4):
        pool, scales = quantize_block(torch.randn(B, N_PAGES, KV, 2, P, D, generator=gen,
                                                  device=dev), bits, 0)
        hp, hs = pool.cpu().pin_memory(), scales.cpu().pin_memory()
        valid = int((idx >= 0).sum())
        moved = valid * (P * D * bits // 8 + scales.shape[-1] * 4)
        written = B * KV * N_SEL * P * D * 2
        fn = lambda p_, s_, i_: ops.recall_values_quant(p_, s_, i_, bits=bits, out_dtype=dt)
        ms_host, call_ms = time_ms(fn, [(hp, hs, i) for i in sels])
        dev_args = [(pool, scales, _distinct_idx(gen, dev))
                    for _ in range(copies_for(moved + written))]
        ms_dev, _ = time_ms(fn, dev_args)
        plain_ms, _ = time_ms(lambda p_, s_, i_: ref.recall_values_quant_ref(p_, s_, i_, bits, dt),
                              dev_args, iters=10)
        row[bits] = {"ms": ms_host, "call_ms": call_ms, "device_pool_ms": ms_dev,
                     "plain_ms": plain_ms, "moved_bytes": moved,
                     "bound_ms": 1e3 * max(moved / PCIE_BPS, (written + nbytes(idx)) / HBM_BPS),
                     "device_pool_bound_ms": 1e3 * (moved + written + nbytes(idx)) / HBM_BPS,
                     "link_ms": gather_bench.link_ms(moved, dev)}
    r8 = row[8]
    return {"name": "recall_values_quant", "link_ms": r8["link_ms"],
            "moved_bytes": r8["moved_bytes"],
            **host_gather_grid(ops, "recall_gather_quant", dev, 1),
            "shape": f"pool({B},{N_PAGES},{KV},2,{P},{D}*bits/8) int8, "
                     f"scales({B},{N_PAGES},{KV},2,1) idx({B},{KV},{N_SEL}) -> V only, bf16",
            "bound_bytes": r8["moved_bytes"], "bound_ops": 0, "bound_ms": r8["bound_ms"],
            "bound_by": "bytes", "bound_link": "PCIe for the pinned host pool",
            "max_abs_err": max(errs), "tol": 0.0,
            "kernel_ms": r8["ms"], "kernel_call_ms": r8["call_ms"], "plain_ms": r8["plain_ms"],
            "device_pool_ms": r8["device_pool_ms"],
            "device_pool_bound_ms": r8["device_pool_bound_ms"],
            "int4": row[4], "library_ms": None,
            "library_call": "none: no single PyTorch call gathers and dequantizes"}


def check_centroid_scores(ops, ref, dev, gen):
    out = {}

    def inputs(dt):
        q = torch.randn(B, KV, G, D, generator=gen, device=dev).to(dt)
        cent = torch.sort(torch.randn(B, N_CENT, KV, 2, D, generator=gen, device=dev),
                          dim=3).values.to(dt)
        count = torch.randint(0, 4, (B, N_CENT, KV), generator=gen, device=dev,
                              dtype=torch.int32)          # some empty clusters
        return q, cent, count

    scale = 1.0 / math.sqrt(D)
    tol = TOL[torch.float32]          # the output is float32 for either input dtype
    for dt in (torch.float32, torch.bfloat16):
        q, cent, count = inputs(dt)
        got = ops.centroid_scores(q, cent, count, scale=scale)
        want = ref.centroid_scores_ref(q, cent, count, scale)
        torch.cuda.synchronize()
        empty = (count == 0).permute(0, 2, 1)[:, :, None, :].expand_as(got)
        require(bool(empty.any()) and bool((got[empty] == -1e30).all()),
                f"centroid_scores {dt}: an empty cluster does not score exactly -1e30")
        err = (got - want).abs().max().item()
        require(torch.allclose(got, want, **tol),
                f"centroid_scores {dt}: max |err| {err}, tolerance {tol}")
        out[dt] = err
    dt = torch.bfloat16
    args = [inputs(dt) for _ in range(copies_for(B * N_CENT * KV * 2 * D * 2))]
    ms, call_ms = time_ms(lambda q, c, n: ops.centroid_scores(q, c, n, scale=scale), args)
    plain_ms, _ = time_ms(lambda q, c, n: ref.centroid_scores_ref(q, c, n, scale), args, iters=10)
    # yardstick: relu(q) @ hi^T + min(q, 0) @ lo^T, two matmuls, and the mask
    mm_args = [(torch.relu(q), torch.clamp(q, max=0), c[..., 1, :].permute(0, 2, 3, 1),
                c[..., 0, :].permute(0, 2, 3, 1), (n > 0).permute(0, 2, 1)[:, :, None, :])
               for q, c, n in args]
    lib_ms, _ = time_ms(lambda qp, qn, hi, lo, ok: torch.where(
        ok, (torch.matmul(qp, hi) + torch.matmul(qn, lo)) * scale, -1e30), mm_args)
    q, cent, count = args[0]
    byts = nbytes(q, cent, count) + B * KV * G * N_CENT * 4
    flops = 4 * B * KV * G * N_CENT * D
    return {"name": "centroid_scores",
            "shape": f"q({B},{KV},{G},{D}) cent({B},{N_CENT},{KV},2,{D}) count({B},{N_CENT},{KV})",
            "bound_bytes": byts, "bound_ops": flops,
            "bound_ms": 1e3 * max(byts / HBM_BPS, flops / PEAK_OPS[dt]),
            "bound_by": "bytes" if byts / HBM_BPS >= flops / PEAK_OPS[dt] else "operations",
            "max_abs_err": out[torch.bfloat16], "max_abs_err_fp32": out[torch.float32],
            "tol": tol, "tol_fp32": tol,
            "kernel_ms": ms, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_call": "2x torch.matmul + torch.where"}


def check_page_summary(ops, ref, dev, gen):
    for dt in (torch.float32, torch.bfloat16):
        for T, extra in ((CONTEXT, 40), (P, 0)):   # a prefill prefix view; one decode page
            full = torch.randn(B, T + extra, KV, D, generator=gen, device=dev).to(dt)
            k = full[:, :T]
            got = ops.page_summary(k, page_size=P)
            want = ref.page_summary_ref(k, P)
            torch.cuda.synchronize()
            require(got.dtype == dt and torch.equal(got, want),
                    f"page_summary {dt} T={T}: not exact (max |err| "
                    f"{(got.float() - want.float()).abs().max().item()})")
    dt = torch.bfloat16
    args = [(torch.randn(B, CONTEXT, KV, D, generator=gen, device=dev).to(dt),)
            for _ in range(copies_for(B * CONTEXT * KV * D * 2))]
    ms, call_ms = time_ms(lambda k: ops.page_summary(k, page_size=P), args)
    plain_ms, _ = time_ms(lambda k: ref.page_summary_ref(k, P), args, iters=10)
    lib_ms, _ = time_ms(lambda k: torch.aminmax(k.view(B, CONTEXT // P, P, KV, D), dim=2), args)
    byts = nbytes(args[0][0]) + B * (CONTEXT // P) * KV * 2 * D * 2
    return {"name": "page_summary", "shape": f"k({B},{CONTEXT},{KV},{D}) -> ({B},{CONTEXT // P},{KV},2,{D})",
            "bound_bytes": byts, "bound_ops": 0, "bound_ms": 1e3 * byts / HBM_BPS,
            "bound_by": "bytes", "max_abs_err": 0.0, "tol": 0.0,
            "kernel_ms": ms, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_call": "torch.aminmax over the page axis"}


def _prefill_inputs(gen, dev, dt, b, h, kv, t, d):
    """q, k, v as the model hands them over: (b, t, heads, d) tensors seen
    as (b, heads, t, d) views."""
    q = torch.randn(b, t, h, d, generator=gen, device=dev).to(dt).transpose(1, 2)
    k = torch.randn(b, t, kv, d, generator=gen, device=dev).to(dt).transpose(1, 2)
    v = torch.randn(b, t, kv, d, generator=gen, device=dev).to(dt).transpose(1, 2)
    return q, k, v


def check_flash_prefill(ops, ref, dev, gen):
    errs = {}
    lib_prec = None
    cases = [  # (name, B, H, kv, T, d, window, softcap)
        ("main", B, H, KV, CONTEXT, D, None, None),
        ("window", 1, 8, 2, 1000, D, 256, None),
        ("softcap", 2, 4, 2, 777, 64, None, 30.0),
    ]
    for name, b, h, kv, t, d, window, cap in cases:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = _prefill_inputs(gen, dev, dt, b, h, kv, t, d)
            scale = 1.0 / math.sqrt(d)
            got = ops.flash_prefill(q, k, v, scale=scale, causal=True, window=window, softcap=cap)
            want = ref.flash_prefill_ref(q, k, v, scale, True, window, cap)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            require(got.dtype == dt and torch.allclose(got.float(), want.float(), **TOL[dt]),
                    f"flash_prefill {name} {dt}: max |err| {err} (max |want| "
                    f"{want.float().abs().max().item()}), tolerance {TOL[dt]}")
            errs[(name, dt)] = err
            if name == "main" and dt == torch.bfloat16:
                sdpa = torch.nn.functional.scaled_dot_product_attention(
                    *(x.contiguous() for x in (q, k, v)), is_causal=True, scale=scale,
                    enable_gqa=True)
                lib_prec = _library_precision(sdpa, want, dt)
                del sdpa
            del q, k, v, got, want
    dt = torch.bfloat16
    scale = 1.0 / math.sqrt(D)
    args = [_prefill_inputs(gen, dev, dt, B, H, KV, CONTEXT, D)]
    ms, call_ms = time_ms(lambda q, k, v: ops.flash_prefill(q, k, v, scale=scale), args, iters=3)
    plain_ms, _ = time_ms(lambda q, k, v: ref.flash_prefill_ref(q, k, v, scale), args, iters=1)
    sdpa_args = [tuple(x.contiguous() for x in args[0])]
    lib_ms, _ = time_ms(lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale, enable_gqa=True), sdpa_args, iters=10)
    q, k, v = args[0]
    byts = nbytes(q, k, v, q)
    flops = 4 * B * H * D * (CONTEXT * (CONTEXT + 1) // 2)   # QK^T and PV over the causal pairs
    return {"name": "flash_prefill", "shape": f"q({B},{H},{CONTEXT},{D}) kv({B},{KV},{CONTEXT},{D}) causal",
            "bound_bytes": byts, "bound_ops": flops,
            "bound_ms": 1e3 * max(byts / HBM_BPS, flops / PEAK_OPS[dt]),
            "bound_by": "bytes" if byts / HBM_BPS >= flops / PEAK_OPS[dt] else "operations",
            "max_abs_err": errs[("main", torch.bfloat16)],
            "max_abs_err_fp32": errs[("main", torch.float32)],
            "max_abs_err_cases": {f"{n} {str(t).split('.')[-1]}": e for (n, t), e in errs.items()},
            "tol": TOL[torch.bfloat16], "tol_fp32": TOL[torch.float32],
            "kernel_ms": ms, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms,
            "library_call": "scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
            **lib_prec}


# ---------------------------------------------------------------------------
# phase 4 and 5
# ---------------------------------------------------------------------------
def llama_params(dev):
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = get_config("llama31-8b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"[main] llama31-8b params on the card: "
        f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, params


# the kernels each main-path run must launch (recall_gather reads the fp
# pool, recall_gather_quant the quantized one; ShadowKV's decode recalls V
# halves only; Centroid scores its cluster boxes every step)
_COMMON = ("paged_attention", "page_scores", "page_summary", "flash_prefill")
RUNS = {
    ("freekv", "none"): _COMMON + ("recall_gather",),
    ("freekv", "int8"): _COMMON + ("recall_gather_quant",),
    ("shadowkv", "none"): _COMMON + ("recall_values",),
    ("shadowkv", "int8"): _COMMON + ("recall_values_quant",),
    ("centroid", "none"): _COMMON + ("centroid_scores", "recall_gather"),
}


def main_path(dev, ops, cfg, params, method, kv_quant):
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.quant.accounting import page_block_bytes
    from repro_torch.serving.engine import Request, ServeEngine

    fkv = FreeKVConfig(method=method, offload="host", kv_quant=kv_quant)
    stream = needle_stream(cfg.vocab_size, CONTEXT, fkv.page_size, seed=0)
    reqs = [Request(uid=i, tokens=next(stream).tokens, max_new_tokens=NEW_TOKENS)
            for i in range(B)]
    eng = ServeEngine(cfg, fkv, params, max_len=MAX_LEN, batch_size=B,
                      state_dtype=torch.bfloat16, scheduler="static", device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    run = f"{method}/{kv_quant}"
    require(eng.last_logits_finite, f"non-finite logits on the main path ({run})")
    for o in outs:
        require(len(o.tokens) == NEW_TOKENS, f"request {o.uid}: {len(o.tokens)} tokens")
        require(all(0 <= t < cfg.vocab_size for t in o.tokens), f"request {o.uid}: bad token")
    for name in RUNS[(method, kv_quant)]:
        require(launches[name] > 0, f"{name} was never launched on the main path ({run})")
    # prefill summarises once per layer; more means a page completed (and
    # was quantized and summarised) during decode
    require(launches["page_summary"] > cfg.n_layers,
            f"no page completed during decode ({run}): page_summary launched "
            f"{launches['page_summary']} times for {cfg.n_layers} layers")
    steps = max(outs[0].steps, 1)
    info = {"arch": cfg.name, "method": method, "kv_quant": kv_quant, "requests": B,
            "prompt_tokens": CONTEXT, "tokens_per_request": [len(o.tokens) for o in outs],
            "prefill_s": outs[0].prefill_s, "decode_ms_per_step": 1e3 * outs[0].decode_s / steps,
            "decode_steps": steps, "wall_s": wall,
            "bytes_per_recalled_page": page_block_bytes(fkv, cfg.d_head, itemsize=2),
            "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "correction_rate": outs[0].stats.get("correction_rate"),
            "spec_hit_rate": outs[0].stats.get("spec_hit_rate"),
            "sync_pages_per_step": outs[0].stats.get("sync_pages", 0) / steps,
            # valid lanes of the critical-path top-up and of the staged gather,
            # each over every lane its launches carry (B x kv x n_sel a launch)
            "topup_valid_share": sum(o.stats.get("sync_pages", 0) for o in outs)
            / (B * steps * cfg.n_layers * KV * N_SEL),
            "staged_valid_share": sum(o.stats.get("async_pages", 0) for o in outs)
            / (B * steps * cfg.n_layers * KV * N_SEL),
            "launches": launches,
            "launches_per_decode_step": {k: v / steps for k, v in launches.items()},
            "first_tokens": outs[0].tokens[:8]}
    del eng, outs
    torch.cuda.empty_cache()
    return info, launches


def time_low_rank_keys(dev, cfg, gen):
    """ShadowKV's prefill factorization at one layer's shape (B x 8192 keys
    per KV head, d 128, full rank as at llama widths): the port's
    ``low_rank_keys`` and the other routes to the same factors, each in
    CUDA-event ms per layer with its largest reconstruction error against
    the keys (singular vectors differ in sign between routes; u @ w not)."""
    from repro_torch.core.retrieval import low_rank_keys
    k = torch.randn(B, CONTEXT, cfg.n_kv_heads, cfg.d_head, generator=gen,
                    device=dev).to(torch.bfloat16)
    kf = k.transpose(1, 2).float()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def tall_svd():
        u, s_, vt = torch.linalg.svd(kf, full_matrices=False)
        return u * s_[..., None, :], vt

    def qr_svd():
        qm, rm = torch.linalg.qr(kf)
        u, s_, vt = torch.linalg.svd(rm)
        return (qm @ u) * s_[..., None, :], vt

    def gram_eigh():
        v = torch.linalg.eigh(kf.mT @ kf).eigenvectors.flip(-1)
        return kf @ v, v.mT

    # the port's route is the SVD of K with the gesvda driver
    routes = {"port low_rank_keys": lambda: low_rank_keys(k, cfg.d_head),
              "thin QR + SVD of R": qr_svd, "eigh of K^T K": gram_eigh,
              "SVD of K (default driver)": tall_svd}
    out = {}
    for name, fn in routes.items():
        fn()
        torch.cuda.synchronize()
        start.record()
        u, w = fn()
        stop.record()
        torch.cuda.synchronize()
        out[name] = {"ms_per_layer": start.elapsed_time(stop),
                     "max_abs_reconstruction_err": (u @ w - kf).abs().max().item()}
    port = out["port low_rank_keys"]
    require(port["max_abs_reconstruction_err"] < 1e-3,
            f"low_rank_keys: full-rank reconstruction error {port['max_abs_reconstruction_err']}")
    return {"layers": cfg.n_layers, "port_s_per_prefill": port["ms_per_layer"] * cfg.n_layers / 1e3,
            "routes": out}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _smoke_fkv(method, kv_quant):
    from repro_torch.configs.base import FreeKVConfig
    # centroid: re-center at every completed page, so the re-center runs here
    return FreeKVConfig(method=method, page_size=8, budget=64, n_sink=8, n_window=8,
                        offload="host", kv_quant=kv_quant, centroid_refresh_interval=1)


def kernel_vs_plain_end_to_end(dev, method, kv_quant):
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = get_config("granite-3-8b-smoke")
    fkv = _smoke_fkv(method, kv_quant)
    params_gpu = init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    params_cpu = _tree_map(lambda t: t.cpu(), params_gpu)
    stream = needle_stream(cfg.vocab_size, 256, 8, seed=3)
    prompts = [next(stream).tokens for _ in range(2)]
    toks = {}
    for where, params in (("cuda", params_gpu), ("cpu", params_cpu)):
        eng = ServeEngine(cfg, fkv, params, max_len=320, batch_size=2,
                          state_dtype=torch.float32, scheduler="static",
                          device=dev if where == "cuda" else "cpu")
        outs = eng.generate([Request(uid=i, tokens=t, max_new_tokens=16)
                             for i, t in enumerate(prompts)])
        toks[where] = [o.tokens for o in outs]
    require(toks["cuda"] == toks["cpu"], f"greedy tokens differ ({method}/{kv_quant}): "
            f"card {toks['cuda']} vs cpu {toks['cpu']}")
    return toks["cuda"]


def centroid_index_equals_rebuild(dev):
    """The centroid index kept step by step on the card (granite-3-8b-smoke,
    float32, a re-center at every completed page) equals
    ``centroid_index.rebuild`` on the card bit for bit, in every layer."""
    from repro_torch.configs import get_config
    from repro_torch.core import centroid_index
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.models.model import init_params, prefill, serve_step

    cfg = get_config("granite-3-8b-smoke")
    fkv = _smoke_fkv("centroid", "none")
    params = init_params(cfg, seed=1, device=dev, dtype=torch.float32)
    stream = needle_stream(cfg.vocab_size, 252, 8, seed=4)   # an unaligned prompt
    toks = torch.from_numpy(np.stack([next(stream).tokens for _ in range(2)])).long().to(dev)
    logits, state = prefill(cfg, fkv, params, {"tokens": toks}, 320, state_dtype=torch.float32)
    recentered = 0
    for _ in range(20):
        before = state["layers"][0]["cent_mean"].clone()
        logits, state = serve_step(cfg, fkv, params, state, torch.argmax(logits, -1)[:, None])
        recentered += int(not torch.equal(before, state["layers"][0]["cent_mean"]))
    require(recentered > 0, "the centroid index never re-centered")
    for i, st in enumerate(state["layers"]):
        rb = centroid_index.rebuild(st, fkv.page_size)
        for key in ("cent", "cent_assign", "cent_count"):
            require(torch.equal(rb[key], st[key]),
                    f"layer {i}: the kept {key} differs from its rebuild on the card")
    return recentered


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


KERNEL_META = {   # name -> (source, the TPU kernel it replaces)
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:69"),
    "page_scores": ("src/repro_torch/kernels/csrc/page_scores.cu",
                    "src/repro/kernels/page_scores.py:36"),
    "recall_gather": ("src/repro_torch/kernels/csrc/recall_gather.cu",
                      "src/repro/kernels/recall_gather.py:228"),
    "recall_gather_quant": ("src/repro_torch/kernels/csrc/recall_gather_quant.cu",
                            "src/repro/kernels/recall_gather.py:185"),
    "page_summary": ("src/repro_torch/kernels/csrc/page_summary.cu",
                     "src/repro/kernels/page_summary.py:19"),
    "flash_prefill": ("src/repro_torch/kernels/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_prefill.py:73"),
    "recall_values": ("src/repro_torch/kernels/csrc/recall_gather.cu",
                      "src/repro/kernels/recall_gather.py:228 recall_gather(values_only=True)"),
    "recall_values_quant": ("src/repro_torch/kernels/csrc/recall_gather_quant.cu",
                            "src/repro/kernels/recall_gather.py:185 "
                            "recall_gather_quant(values_only=True)"),
    "centroid_scores": ("src/repro_torch/kernels/csrc/page_scores.cu",
                        "src/repro/kernels/centroid_scores.py:40"),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phase")
    args = ap.parse_args()

    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    log(smi)                                   # as nvidia-smi gives it
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build, ops, ref
    dev = torch.device("cuda", 0)
    log("[device] PCIe link " + json.dumps(link_info(dev)))

    # phase 2: build
    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.load(name)
    log(f"[build] {len(build.SOURCES)} sources ({len(ops.KERNELS)} kernels) built and "
        f"loaded in {time.perf_counter() - t0:.1f} s")
    for name, out in build.BUILD_LOG.items():
        for line in out.splitlines():
            if ("registers" in line or "spill" in line or "error" in line.lower()
                    or "Performance Loss" in line):
                log(f"[build] {name}: {line.strip()}")

    # phase 3: kernels
    gen = torch.Generator(device=dev).manual_seed(0)
    checks = {"paged_attention": check_paged_attention, "page_scores": check_page_scores,
              "recall_gather": check_recall_gather,
              "recall_gather_quant": check_recall_gather_quant,
              "page_summary": check_page_summary, "flash_prefill": check_flash_prefill,
              "recall_values": check_recall_values,
              "recall_values_quant": check_recall_values_quant,
              "centroid_scores": check_centroid_scores}
    require(set(checks) == {fn.__name__ for fn in ops.KERNELS} == set(KERNEL_META),
            "a kernel has no check")
    kernels = []
    for fn in ops.KERNELS:
        t0 = time.perf_counter()
        k = checks[fn.__name__](ops, ref, dev, gen)
        kernels.append(k)
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f} ms"
        if "library_max_abs_err" in k:
            lib += (f" (its max|err| {k['library_max_abs_err']:.3g}, within TOL: "
                    f"{k['library_within_tol']})")
        log(f"[kernel] {k['name']}: max|err| {k['max_abs_err']:.3g} | "
            f"{k['kernel_ms']:.4f} ms vs bound {k['bound_ms']:.4f} ms | plain "
            f"{k['plain_ms']:.4f} ms | library {lib} | {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    rows = {k["name"]: k for k in kernels}
    for name in ("recall_gather", "recall_values", "recall_gather_quant", "recall_values_quant"):
        k = rows[name]
        log(f"[kernel] {name} from the pinned pool: {k['kernel_ms']:.4f} ms, the link's "
            f"ceiling (copy_ of the same {k['moved_bytes']} B) {k['link_ms']:.4f} ms, ratio "
            f"{k['kernel_ms'] / k['link_ms']:.3f}; grid {k['host_grid_blocks']} blocks "
            f"({k['host_sms']:g} SMs at {k['blocks_per_sm']} an SM); "
            f"{k['device_grid_blocks']} blocks from a device pool")
    launches = {k["name"]: None for k in kernels}
    share = None
    if not args.kernels_only:
        # phase 4: main path at full width, every retriever and pool tier
        cfg, params = llama_params(dev)
        launches = {k["name"]: 0 for k in kernels}
        for method, kv_quant in RUNS:
            t0 = time.perf_counter()
            info, run = main_path(dev, ops, cfg, params, method, kv_quant)
            info["run_s"] = time.perf_counter() - t0
            log("[main] " + json.dumps(info))
            for name, n in run.items():
                launches[name] += n
            if (method, kv_quant) == ("freekv", "none"):
                share = {"topup": info["topup_valid_share"], "staged": info["staged_valid_share"]}
        del params
        torch.cuda.empty_cache()
        require(all(0 <= v <= 1 for v in share.values()), f"valid shares out of range: {share}")
        log("[main] shadowkv low-rank keys: " + json.dumps(time_low_rank_keys(dev, cfg, gen)))
    # the overlap line, and the gathers again at the valid share of freekv/none's
    # two recall launches, in a fresh process: one whose profiler has run many
    # sessions can lose device events and serialize the two streams
    bench = run_gather_bench(share)
    for s_, ovl in bench["overlap"].items():
        log(f"[overlap] 32 paged_attention alone and beside recall_gather (valid share {s_}) "
            "on the side stream: " + json.dumps(ovl))
    if share is not None:
        log(f"[kernel] gathers at freekv/none's valid share {json.dumps(share)}: "
            + json.dumps(bench["gathers"]))
        for name, r in bench["gathers"].items():
            base, _, bits = name.partition(" int")
            ms = {kind: r["by_share"][str(v)]["ms"] for kind, v in share.items()}
            target = rows[base]["int4"] if bits == "4" else rows[base]
            target.update(real_share=share, real_share_ms=ms)
    if not args.kernels_only:
        # phase 5: kernel path == plain path
        for method, kv_quant in (("freekv", "none"), ("freekv", "int8"), ("freekv", "int4"),
                                 ("shadowkv", "none"), ("shadowkv", "int8"),
                                 ("shadowkv", "int4"), ("centroid", "none"),
                                 ("centroid", "int8")):
            toks = kernel_vs_plain_end_to_end(dev, method, kv_quant)
            log(f"[equal] granite-3-8b-smoke fp32 {method} kv_quant={kv_quant}: card == cpu "
                f"greedy tokens, e.g. {toks[0][:8]}")
        n = centroid_index_equals_rebuild(dev)
        log(f"[equal] granite-3-8b-smoke fp32 centroid: the index kept on the card equals "
            f"its rebuild in every layer after 20 steps ({n} re-centers)")

    line = []
    for k in kernels:
        src, replaces = KERNEL_META[k["name"]]
        line.append({"name": k["name"], "route": "cuda", "source": src, "replaces": replaces,
                     "launches": launches[k["name"]], "max_abs_err": k["max_abs_err"],
                     "ms": k["kernel_ms"], **k})
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
