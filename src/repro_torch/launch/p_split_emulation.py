"""Why the bf16 flash_prefill splits P into bfloat16 hi + lo: a float32
emulation, on the CPU, of the kernel's arithmetic with P @ V fed three ways.

The kernel runs the online softmax over 64-key blocks in float32 and sums
the row totals from the unrounded probabilities; only the A operand of the
P @ V product is rounded to a 16-bit type, and the products are summed in
float32. The emulation does the same with P rounded to bfloat16, to
float16, or split into the bfloat16 rounding plus the bfloat16 rounding of
the remainder, and holds each result, rounded to bfloat16, against the
plain version (``kernels.ref.flash_prefill_ref``) at ``chip_smoke.TOL`` for
bfloat16 outputs. These are counts of elements from a CPU run, not device
measurements.

    PYTHONPATH=src python -m repro_torch.launch.p_split_emulation [--t 1024]

Prints one JSON line: per mode, the elements outside the tolerance and the
largest |error|.
"""
import argparse
import json

import numpy as np
import torch

from repro_torch.kernels import ref

TOL = dict(atol=1e-4, rtol=2 ** -6)          # chip_smoke.TOL for bfloat16 outputs
BLOCK = 64                                   # keys per tile, as the kernel


def _round_p(p, mode):
    if mode == "bf16":
        return p.bfloat16().float()
    if mode == "fp16":
        return p.half().float()
    hi = p.bfloat16().float()
    return hi + (p - hi).bfloat16().float()


def emulate(mode, q, k, v, scale):
    """Causal attention of q (H, T, d) over k, v (H, T, d), float32, the
    online softmax over BLOCK-key tiles with P rounded by ``mode``."""
    H, T, d = q.shape
    m = torch.full((H, T, 1), -1e30)
    l = torch.zeros(H, T, 1)
    acc = torch.zeros(H, T, d)
    rows = torch.arange(T)[:, None]
    for k0 in range(0, T, BLOCK):
        keys = torch.arange(k0, min(k0 + BLOCK, T))[None, :]
        s = torch.einsum("htd,hsd->hts", q, k[:, k0:k0 + BLOCK]) * scale
        s = torch.where(keys <= rows, s, torch.full((), -1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("hts,hsd->htd", _round_p(p, mode), v[:, k0:k0 + BLOCK])
        m = m_new
    return acc / l.clamp_min(1e-30)


def run(t=1024, d=128, heads=4, seed=0):
    """{mode: (elements outside TOL, max |error|, elements)} at one shape."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, heads, t, d), dtype=np.float32))
               .bfloat16() for _ in range(3))
    scale = d ** -0.5
    want = ref.flash_prefill_ref(q, k, v, scale).float()[0]
    out = {}
    for mode in ("bf16", "fp16", "hi+lo"):
        got = emulate(mode, q[0].float(), k[0].float(), v[0].float(), scale).bfloat16().float()
        bad = ~torch.isclose(got, want, **TOL)
        out[mode] = (int(bad.sum()), float((got - want).abs().max()), got.numel())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--t", type=int, default=1024)
    ap.add_argument("--heads", type=int, default=4)
    args = ap.parse_args(argv)
    res = run(t=args.t, heads=args.heads)
    print(json.dumps({"t": args.t, "d": 128, "heads": args.heads, "block": BLOCK,
                      "tol": TOL, "device": "cpu (an emulation, not a device measurement)",
                      "modes": {m: {"outside_tol": n, "max_abs_err": e, "elements": c}
                                for m, (n, e, c) in res.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
