"""What each part of the two attention kernels and the two host-pool
gathers costs on the card.

Each variant is a kernel's source with a few textual edits: one part of the
work taken out (a product, the exponentials, the loads after the first
ring, the softmax and products of paged attention, the gather's stores), or
another ring depth, another number of loads in flight or a cache hint; the
gathers' grid sizes are launch-size variants of the as-built library.
Every variant is built beside the real kernel with the same nvcc flags and
timed at the main path's shapes, in turns with the others, for several
rounds. A variant that takes work out computes a wrong result on purpose:
it only says what that work costs; ``within_tol`` says which variants still
match the plain version.

    PYTHONPATH=src python -m repro_torch.launch.kernel_ablation [--rounds 3] \
        [--only attention|gathers]

flash_prefill: q (4, 32, 8192, 128), k/v (4, 8, 8192, 128) bf16 causal, as
the model hands them over (strided views), CUDA-event ms per launch over 10
launches. paged_attention: q (4, 8, 4, 128) over 65 pages of 32 tokens,
bf16, profiler device ms per launch over 40 launches cycling through inputs
larger than L2. recall_gather (bf16) and recall_gather_quant (int8, group
0, bf16 out): pools (4, 259, 8, 2, 32, 128) in pinned host memory, idx (4,
8, 56), profiler device ms per launch over 40 launches cycling four
selections with disjoint pages, every lane valid and at the main path's
valid shares (MAIN_PATH_SHARES), beside the link's ceiling (one contiguous
copy_ of the same bytes) in the same round; for recall_gather also how much
the variant, on the staged-recall stream, slows 32 paged_attention launches
(gather_bench.overlap), every lane valid and at the staged recall's share.
Prints the card's name and power limit, one line per variant and round, and
one JSON line. Needs a card and nvcc.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build, ops, ref
from repro_torch.launch import gather_bench
from repro_torch.launch.gather_bench import device_ms

TOL = dict(atol=1e-4, rtol=2 ** -6)          # chip_smoke.TOL for bfloat16 outputs

_NOMEM = [   # producer stops after the first ring; consumers stop waiting for data
    ("        mbar_wait(bar_empty + 8 * s, ((i / kS) & 1) ^ 1);", "        if (i >= kS) break;"),
    ("  auto phase = [&](int kb) { return (uint32_t)(((kb - kb_begin) / kS) & 1); };",
     "  auto phase = [&](int kb) {\n    return (uint32_t)(((kb - kb_begin) / kS) & 1) | "
     "(kb - kb_begin >= kS ? 2u : 0u);\n  };"),
    ("__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {\n"
     "  uint32_t done = 0;",
     "__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {\n"
     "  uint32_t done = parity > 1;"),
]
_NO_EXP = [('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));', "  y = x;")]
_NO_LO = [("        wgmma_rs_n128(o, pl[kk], dv);\n", "")]
FLASH_VARIANTS = {
    "as built": [],
    "no lo product": _NO_LO,
    "no exponentials": _NO_EXP,
    "no S product": [("      wgmma_ss_n64(sc, dq, dk, ks > 0);", "      sc[ks] += 1.f;")],
    "no lo, no exponentials": _NO_LO + _NO_EXP,
    "no refills after the first ring": _NOMEM,
    "no ping-pong": [
        ('    asm volatile("bar.sync %0, 256;\\n" ::"r"(1 + wg) : "memory");', ""),
        ('    asm volatile("bar.arrive %0, %1;\\n" ::"r"(alone ? 3 : 2 - wg), '
         '"r"(alone ? 128 : 256)\n                 : "memory");', ""),
        ('  asm volatile("bar.arrive %0, %1;\\n" ::"r"(wg == 1 ? 1 : 3), "r"(wg == 1 ? 256 : 128)\n'
         '               : "memory");', ""),
    ],
    "3-stage ring": [("static constexpr int kStages = D == 64 ? 6 : 5;",
                      "static constexpr int kStages = D == 64 ? 6 : 3;")],
}
PAGED_VARIANTS = {   # name -> (edits, blocks per SM for the split)
    "as built": ([], ops.BLOCKS_PER_SM),
    "loads only": ([("const bool live = i * stride < nt;", "const bool live = false;"),
                    ("      if (t < nt) {\n        float pg[kG];",
                     "      if (false) {\n        float pg[kG];")], ops.BLOCKS_PER_SM),
    "4-stage ring, 3 blocks an SM": ([("constexpr int kStages = 2;", "constexpr int kStages = 4;")],
                                     3),
    "16 KB stages, 3 blocks an SM": ([("constexpr int kStageBytes = 8192;",
                                       "constexpr int kStageBytes = 16384;")], 3),
}


_LD = "ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
_HINT = [(_LD, _LD.replace(".v4", ".L2::128B.v4"))]
_NO_STORES = "if (r[u].x == 0x7fc00123u && r[u].y == 0x1234567u) "   # never true: keeps the loads
GATHER_BUILDS = {   # source -> {build: edits}; a build missing here is not made for that source
    "recall_gather": {
        "as built": [],
        "half the loads in flight": [("constexpr int kLoads = 16;", "constexpr int kLoads = 8;")],
        "twice the loads in flight": [("constexpr int kLoads = 16;", "constexpr int kLoads = 32;")],
        "L2::128B prefetch hint": _HINT,
        "loads only (no stores)": [("        if (i < half_vec) out[i] = r[u];",
                                    "        if (i < half_vec) " + _NO_STORES + "out[i] = r[u];")],
    },
    "recall_gather_quant": {
        "as built": [],
        "half the loads in flight": [("constexpr int kLoads = 8;", "constexpr int kLoads = 4;")],
        "twice the loads in flight": [("constexpr int kLoads = 8;", "constexpr int kLoads = 16;")],
        "L2::128B prefetch hint": _HINT,
    },
}
# valid shares of freekv/none's top-up and staged recall launches on the
# main path (chip_smoke.py phase 4, NVIDIA H100 80GB HBM3, 700 W)
MAIN_PATH_SHARES = (0.0067, 0.062)
GATHER_VARIANTS = {   # name -> (build, SMs whose blocks the grid takes, or None: the whole card)
    **{f"grid of {n} SMs": ("as built", n) for n in (8, 16, 32)},
    "whole card": ("as built", None),
    **{b: (b, ops.HOST_GATHER_SMS) for b in GATHER_BUILDS["recall_gather"] if b != "as built"},
}


def variant_grid(n_units, sms, blocks_per_sm, grid_sms):
    """Blocks of a gather variant's launch: what ``grid_sms`` SMs hold (None:
    every SM), never more than the units fill, as ops.gather_grid does."""
    cap = (sms if grid_sms is None else min(grid_sms, sms)) * blocks_per_sm
    return max(1, min(cap, -(-n_units // ops.GATHER_WARPS)))


def build_variants(name, variants, out_dir):
    """One library per variant of csrc/<name>.cu (edits apply to the source
    and to common.cuh), all nvcc runs at once -> {variant: ctypes library
    with the source's entry points bound}."""
    src = (build.CSRC / f"{name}.cu").read_text()
    common = (build.CSRC / "common.cuh").read_text()
    procs = {}
    for i, (vname, edits) in enumerate(variants.items()):
        text, head = src, common
        for old, new in edits:
            if old not in text and old not in head:
                raise RuntimeError(f"{name} variant {vname!r}: edit does not match the source:\n{old}")
            text, head = text.replace(old, new), head.replace(old, new)
        d = out_dir / f"{name}-{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{name}.cu").write_text(text)
        (d / "common.cuh").write_text(head)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(d), "-o", str(d / "lib.so"),
               str(d / f"{name}.cu")]
        procs[vname] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for vname, (d, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} variant {vname!r} did not build:\n{out[-4000:]}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for entry, argtypes in build.SIGNATURES[name].items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[vname] = lib
    return libs


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def flash_call(lib, q, k, v, scale):
    out = torch.empty_like(q)
    B, H, T, d = q.shape
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *out.stride()[:3])
    build.check(lib.freekv_flash_prefill(_p(q), _p(k), _p(v), _p(out), B, H, H // k.shape[1], T,
                                         d, strides, float(scale), 0.0, 1, 0, 1, q.device.index,
                                         _stream()), "flash_prefill")
    return out


def paged_call(lib, n_split, tickets, q, k, v, pos, cur, scale):
    B, kv, G, d = q.shape
    N, p = k.shape[2], k.shape[3]
    part_m = torch.empty((B, kv, n_split, G), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, kv, n_split, G, d), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    build.check(lib.freekv_paged_attention(
        _p(q), _p(k), _p(v), _p(pos), _p(cur), _p(part_m), _p(part_l), _p(part_acc),
        _p(tickets), _p(out), B, kv, G, N, p, d, n_split, float(scale), 0.0, 1, q.device.index,
        _stream()), "paged_attention")
    return out


def gather_inputs(gen, dev):
    """The two gathers' calls at the main shape from pinned host pools:
    {source: (call(lib, blocks, idx) -> outputs, want(idx),
    bytes a valid lane moves)} and four all-valid selections with disjoint
    pages."""
    from repro_torch.launch import gather_bench as gb
    from repro_torch.quant.quantizers import quantize_block
    B, NP, KV, P, D = gb.B, gb.N_PAGES, gb.KV, gb.P, gb.D
    pool = torch.randn(B, NP, KV, 2, P, D, generator=gen, device=dev).to(torch.bfloat16)
    host = pool.cpu().pin_memory()
    qp, qs = quantize_block(pool.float(), 8, 0)
    hq, hs = qp.cpu().pin_memory(), qs.cpu().pin_memory()
    src, qsrc, ssrc = (ops._pool_pointer(t, dev) for t in (host, hq, hs))

    def fp(lib, grid, idx, pool_src=src):
        k = torch.empty((B, KV, gb.N_SEL, P, D), dtype=torch.bfloat16, device=dev)
        v = torch.empty_like(k)
        build.check(lib.freekv_recall_gather(pool_src, _p(idx), _p(k), _p(v), B, NP, KV,
                                             gb.N_SEL, P * D * 2, grid, dev.index, _stream()),
                    "recall_gather")
        return k, v

    def q8(lib, grid, idx):
        k = torch.empty((B, KV, gb.N_SEL, P, D), dtype=torch.bfloat16, device=dev)
        v = torch.empty_like(k)
        build.check(lib.freekv_recall_gather_quant(qsrc, ssrc, _p(idx), _p(k), _p(v), B, NP, KV,
                                                   gb.N_SEL, P, D, 1, 8, 1, grid, dev.index,
                                                   _stream()), "recall_gather_quant")
        return k, v

    fp.pools = q8.pools = (host, hq, hs)   # the mapped addresses stay valid while these live
    calls = {"recall_gather": (fp, lambda i: ref.recall_gather_ref(pool, i), 2 * P * D * 2),
             "recall_gather_quant": (q8, lambda i: ref.recall_gather_quant_ref(
                 qp, qs, i, 8, torch.bfloat16), 2 * P * D + 2 * 4)}
    return calls, gb.selections(gen, dev)


def blocks_per_sm(source, lib, dev):
    out = ctypes.c_int()
    build.check(getattr(lib, f"freekv_{source}_blocks_per_sm")(dev.index, ctypes.byref(out)),
                f"{source} occupancy")
    return out.value


def measured(timer, *args):
    """timer(*args) (device_ms, gather_bench.link_ms), or None, printed, when
    the profiler lost the session's device events: in a long run of
    sessions it sometimes does, and then the gather rows go on without it."""
    try:
        return timer(*args)
    except RuntimeError as err:
        print(f"not measured: {err}", flush=True)
        return None


def _f(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def event_ms(fn, args, iters):
    for _ in range(2):
        fn(*args)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out-dir", default=str(build.BUILD_DIR.parent / "ablation"))
    ap.add_argument("--only", choices=("attention", "gathers"),
                    help="ablate only the two attention kernels or only the two gathers")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ablation: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out_dir = Path(args.out_dir)
    flash, paged, gathers = {}, {}, {}
    if args.only != "gathers":
        flash = build_variants("flash_prefill", FLASH_VARIANTS, out_dir)
        paged = build_variants("paged_attention", {k: v[0] for k, v in PAGED_VARIANTS.items()},
                               out_dir)
    if args.only != "attention":
        gathers = {src: build_variants(src, builds, out_dir)
                   for src, builds in GATHER_BUILDS.items()}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    g_calls, g_sels = gather_inputs(gen, dev) if gathers else ({}, [])
    g_want = {src: want(g_sels[0]) for src, (_, want, _) in g_calls.items()}
    g_shares = {s: gather_bench.selections(gen, dev, s) for s in MAIN_PATH_SHARES}

    B, H, KV, T, D = 4, 32, 8, 8192, 128
    G, P, N = H // KV, 32, 65
    L = N * P
    paged_args = []
    if flash or paged:
        fq, fk, fv = (torch.randn(B, T, n, D, generator=gen, device=dev).to(torch.bfloat16)
                      .transpose(1, 2) for n in (H, KV, KV))
        f_want = ref.flash_prefill_ref(fq, fk, fv, D ** -0.5)
        for _ in range(4):          # 4 x 34 MB: the cycle exceeds L2
            q = torch.randn(B, KV, G, D, generator=gen, device=dev).to(torch.bfloat16)
            k = torch.randn(B, KV, N, P, D, generator=gen, device=dev).to(torch.bfloat16)
            v = torch.randn(B, KV, N, P, D, generator=gen, device=dev).to(torch.bfloat16)
            pos = torch.arange(L, dtype=torch.int32, device=dev).reshape(1, 1, N, P)
            paged_args.append((q, k, v, pos.expand(B, KV, -1, -1).contiguous(),
                               torch.full((B,), L - 1, dtype=torch.int32, device=dev)))
        p_want = ref.paged_attention_ref(*paged_args[0], D ** -0.5)
        tickets = torch.zeros(B * KV, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    rows = {}
    for rnd in range(args.rounds):
        for vname, lib in flash.items():
            got = flash_call(lib, fq, fk, fv, D ** -0.5)
            ok = bool(torch.allclose(got.float(), f_want.float(), **TOL))
            ms = event_ms(lambda: flash_call(lib, fq, fk, fv, D ** -0.5), (), 10)
            rows.setdefault(("flash_prefill", vname), {"within_tol": ok, "ms": []})["ms"].append(ms)
            print(f"round {rnd} flash_prefill {vname}: {ms:.4f} ms, within TOL {ok}", flush=True)
        for vname, lib in paged.items():
            bps = PAGED_VARIANTS[vname][1]
            n_split = ops.split_pages(N, B * KV, sms, bps)
            call = lambda *a: paged_call(lib, n_split, tickets, *a, D ** -0.5)
            ok = bool(torch.allclose(call(*paged_args[0]).float(), p_want.float(), **TOL))
            ms = device_ms(call, paged_args, 40)
            rows.setdefault(("paged_attention", vname), {"within_tol": ok, "ms": [],
                                                         "n_split": n_split})["ms"].append(ms)
            print(f"round {rnd} paged_attention {vname} (n_split {n_split}): {ms:.4f} ms, "
                  f"within TOL {ok}", flush=True)
        for src, (call, _, per_lane) in g_calls.items():
            moved = sum(int((i >= 0).sum()) for i in g_sels[:1]) * per_lane
            link = measured(gather_bench.link_ms, moved, dev)
            rows.setdefault((src, "link ceiling (copy_ of the same bytes)"),
                            {"ms": []})["ms"].append(link)
            print(f"round {rnd} {src} link ceiling ({moved} B): {_f(link)} ms", flush=True)
            for vname, (bname, grid_sms) in GATHER_VARIANTS.items():
                lib = gathers[src].get(bname)
                if lib is None:
                    continue
                bps = blocks_per_sm(src, lib, dev)
                nb = variant_grid(2 * B * KV * gather_bench.N_SEL, sms, bps, grid_sms)
                exact = all(torch.equal(a, b) for a, b in
                            zip(call(lib, nb, g_sels[0]), g_want[src]))
                ms = measured(device_ms, lambda i: call(lib, nb, i), [(i,) for i in g_sels])
                row = rows.setdefault((src, vname), {"exact": exact, "ms": [], "blocks": nb,
                                                     "blocks_per_sm": bps})
                row["ms"].append(ms)
                line = f"round {rnd} {src} {vname} ({nb} blocks, {bps} an SM): {_f(ms)} ms"
                for share, sels in g_shares.items():
                    sms_ = measured(device_ms, lambda i: call(lib, nb, i), [(i,) for i in sels])
                    row.setdefault(f"ms at share {share}", []).append(sms_)
                    line += f", {_f(sms_)} at share {share}"
                if src == "recall_gather":
                    # the overlap line with this variant (the attention kernels as built),
                    # every lane valid and at the staged recall's share
                    for share in (1.0, MAIN_PATH_SHARES[-1]):
                        ovl = gather_bench.overlap(
                            ops, dev, gen, rounds=3, share=share,
                            gather=lambda h, i: call(lib, nb, i, ops._pool_pointer(h, dev)))
                        row.setdefault(f"attention_slowdown_ms at share {share}", []).append(
                            ovl["attention_slowdown_ms"])
                        line += (f", at share {share} beside 32 paged_attention "
                                 f"({ovl['attention_ms']:.4f} ms alone) slows them by "
                                 f"{ovl['attention_slowdown_ms']:.4f} ms")
                print(line + f", exact {exact}", flush=True)
    print(json.dumps({"device": smi, "variants": [
        {"kernel": kname, "variant": vname, **r} for (kname, vname), r in rows.items()]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
