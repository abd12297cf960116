"""Quickstart on the PyTorch port: FreeKV serving with a reduced model.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
        [--kv-quant int8] [--draft-len 4]

The port's form of ``examples/quickstart.py``: the same model, FreeKV
settings, prompts and flags, plus ``--device`` (default ``cuda``; ``cpu``
runs the kernels' plain PyTorch versions). ``--kv-quant`` stores the
offloaded KV pool at int8 / packed int4 with dequantization fused into the
recall; the run then prints the recall bytes saved, the cost model's
dequantization time and the host pool's compression from
``EngineMetrics.summary()["kv_quant"]``. ``--draft-len N`` turns on
speculative decoding: an on-device bigram drafter proposes N tokens a step
and one verify pass commits the longest greedy-consistent prefix; the tokens
equal ``--draft-len 0``'s, and the run prints the accept rate and tokens a
target step.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import FreeKVConfig
from repro_torch.models.model import init_params
from repro_torch.serving.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--kv-quant", choices=("none", "int8", "int4"), default="none",
                    help="quantized host KV tier for the offloaded pool")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="tag requests with a TTFT SLO (ms); prints the attainment and "
                         "goodput line from summary()['slo']")
    ap.add_argument("--slo-itl-ms", type=float, default=None,
                    help="mean inter-token-latency SLO (ms)")
    ap.add_argument("--draft-len", type=int, default=0,
                    help="speculative decoding: drafted tokens a verify step (0 = off; the "
                         "same tokens either way)")
    ap.add_argument("--no-spec-decode", action="store_true",
                    help="force draft_len=0 whatever --draft-len says")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config("smollm-360m-smoke")          # reduced llama-style model
    params = init_params(cfg, seed=0, device=args.device)
    fkv = FreeKVConfig(method="freekv", page_size=8, budget=64, n_sink=8, n_window=8,
                       tau=0.8, kv_quant=args.kv_quant,
                       draft_len=0 if args.no_spec_decode else args.draft_len)
    engine = ServeEngine(cfg, fkv, params, max_len=256, batch_size=2,
                         slo_ttft_ms=args.slo_ttft_ms, slo_itl_ms=args.slo_itl_ms,
                         device=args.device)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 80).astype(np.int32) for _ in range(2)]
    reqs = [Request(uid=i, tokens=p, max_new_tokens=16) for i, p in enumerate(prompts)]
    outs = engine.generate(reqs)
    for out in outs:
        print(f"request {out.uid}: {out.tokens}")
        print(f"  prefill {out.prefill_s * 1e3:.1f} ms, "
              f"decode {out.decode_s / max(out.steps, 1) * 1e3:.1f} ms/step, "
              f"correction_rate={out.stats['correction_rate']:.3f}, "
              f"query_similarity={out.stats['mean_similarity']:.3f}")
    sd = engine.last_metrics.specdec_summary()
    if sd["draft_len"] > 0:
        print(f"spec-decode (draft_len={sd['draft_len']}): accept rate "
              f"{sd['accept_rate']:.3f}, {sd['tokens_per_step']:.2f} tokens per target step")
    kq = engine.last_metrics.summary()["kv_quant"]
    if kq["mode"] != "none":
        print(f"kv_quant={kq['mode']}: block {kq['dense_block_bytes']} -> "
              f"{kq['page_block_bytes']} B, saved {kq['bytes_saved']:.0f} B transfer, "
              f"dequant {kq['dequant_overhead_s'] * 1e6:.1f} us (cost model), "
              f"pool compression {kq['pool_compression']:.2f}x")
    slo = engine.last_metrics.slo_summary()
    if slo["tagged"]:
        print(f"SLO (ttft<={slo['ttft_ms']}ms, itl<={slo['itl_ms']}ms): "
              f"{slo['attained']}/{slo['tagged']} attained ({slo['attainment']:.1%}), "
              f"goodput {slo['goodput_tokens_per_s']:.1f} tok/s")
    return outs


if __name__ == "__main__":
    main()
