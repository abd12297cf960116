"""What each part of the two attention kernels costs on the card.

Each variant is a kernel's source with a few textual edits: one part of the
work taken out (a product, the exponentials, the loads after the first
ring, the softmax and products of paged attention), or another ring depth.
Every variant is built beside the real kernel with the same nvcc flags and
timed at the main path's shapes, in turns with the others, for several
rounds. A variant that takes work out computes a wrong result on purpose:
it only says what that work costs; ``within_tol`` says which variants still
match the plain version.

    PYTHONPATH=src python -m repro_torch.launch.kernel_ablation [--rounds 3]

flash_prefill: q (4, 32, 8192, 128), k/v (4, 8, 8192, 128) bf16 causal, as
the model hands them over (strided views), CUDA-event ms per launch over 10
launches. paged_attention: q (4, 8, 4, 128) over 65 pages of 32 tokens,
bf16, profiler device ms per launch over 40 launches cycling through inputs
larger than L2. Prints the card's name and power limit, one line per
variant and round, and one JSON line. Needs a card and nvcc.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build, ops, ref

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


def build_variants(name, variants, out_dir):
    """One library per variant of csrc/<name>.cu (edits apply to the source
    and to common.cuh), all nvcc runs at once -> {variant: C entry point}."""
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
    fns = {}
    for vname, (d, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} variant {vname!r} did not build:\n{out[-4000:]}")
        (entry, argtypes), = build.SIGNATURES[name].items()
        fn = getattr(ctypes.CDLL(str(d / "lib.so")), entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[vname] = fn
    return fns


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def flash_call(fn, q, k, v, scale):
    out = torch.empty_like(q)
    B, H, T, d = q.shape
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *out.stride()[:3])
    build.check(fn(_p(q), _p(k), _p(v), _p(out), B, H, H // k.shape[1], T, d, strides,
                   float(scale), 0.0, 1, 0, 1, q.device.index, _stream()), "flash_prefill")
    return out


def paged_call(fn, n_split, tickets, q, k, v, pos, cur, scale):
    B, kv, G, d = q.shape
    N, p = k.shape[2], k.shape[3]
    part_m = torch.empty((B, kv, n_split, G), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, kv, n_split, G, d), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    build.check(fn(_p(q), _p(k), _p(v), _p(pos), _p(cur), _p(part_m), _p(part_l), _p(part_acc),
                   _p(tickets), _p(out), B, kv, G, N, p, d, n_split, float(scale), 0.0, 1,
                   q.device.index, _stream()), "paged_attention")
    return out


def device_ms(fn, args_list, iters):
    """Profiler device ms per call, cycling through ``args_list``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / iters


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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ablation: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out_dir = Path(args.out_dir)
    flash = build_variants("flash_prefill", FLASH_VARIANTS, out_dir)
    paged = build_variants("paged_attention", {k: v[0] for k, v in PAGED_VARIANTS.items()},
                           out_dir)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    B, H, KV, T, D = 4, 32, 8, 8192, 128
    fq, fk, fv = (torch.randn(B, T, n, D, generator=gen, device=dev).to(torch.bfloat16)
                  .transpose(1, 2) for n in (H, KV, KV))
    f_want = ref.flash_prefill_ref(fq, fk, fv, D ** -0.5)
    G, P, N = H // KV, 32, 65
    L = N * P
    paged_args = []
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
        for vname, fn in flash.items():
            got = flash_call(fn, fq, fk, fv, D ** -0.5)
            ok = bool(torch.allclose(got.float(), f_want.float(), **TOL))
            ms = event_ms(lambda: flash_call(fn, fq, fk, fv, D ** -0.5), (), 10)
            rows.setdefault(("flash_prefill", vname), {"within_tol": ok, "ms": []})["ms"].append(ms)
            print(f"round {rnd} flash_prefill {vname}: {ms:.4f} ms, within TOL {ok}", flush=True)
        for vname, fn in paged.items():
            bps = PAGED_VARIANTS[vname][1]
            n_split = ops.split_pages(N, B * KV, sms, bps)
            call = lambda *a: paged_call(fn, n_split, tickets, *a, D ** -0.5)
            ok = bool(torch.allclose(call(*paged_args[0]).float(), p_want.float(), **TOL))
            ms = device_ms(call, paged_args, 40)
            rows.setdefault(("paged_attention", vname), {"within_tol": ok, "ms": [],
                                                         "n_split": n_split})["ms"].append(ms)
            print(f"round {rnd} paged_attention {vname} (n_split {n_split}): {ms:.4f} ms, "
                  f"within TOL {ok}", flush=True)
    print(json.dumps({"device": smi, "variants": [
        {"kernel": kname, "variant": vname, **r} for (kname, vname), r in rows.items()]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
