"""End-to-end serving on the PyTorch port: batched long-context requests,
comparing KV retrieval methods (full / quest / arkvale / freekv) on the same
prompts — greedy tokens, decode ms a step, retrieval statistics — under the
continuous-batching scheduler (``--scheduler static`` for the lockstep path).

    PYTHONPATH=src python examples/torch_serve_longcontext.py [--device cpu] [--context 512]

The port's form of ``examples/serve_longcontext.py``, with its flags and
``--device`` (default ``cuda``).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import FreeKVConfig
from repro_torch.data.synthetic import needle_stream
from repro_torch.models.model import init_params
from repro_torch.serving.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--context", type=int, default=512)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--scheduler", choices=("continuous", "static"), default="continuous")
    ap.add_argument("--prefix-cache-tokens", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config("granite-3-8b-smoke")
    params = init_params(cfg, seed=0, device=args.device)
    page = 16
    needle = needle_stream(cfg.vocab_size, args.context, page, seed=1)
    prompts = [next(needle).tokens for _ in range(args.batch)]

    budget = max(96, args.context // 4 // page * page)
    methods = {
        "full": FreeKVConfig(method="full"),
        "quest": FreeKVConfig(method="quest", page_size=page, budget=budget,
                              n_sink=page * 2, n_window=page * 2),
        "arkvale": FreeKVConfig(method="arkvale", page_size=page, budget=budget,
                                n_sink=page * 2, n_window=page * 2),
        "freekv": FreeKVConfig(method="freekv", page_size=page, budget=budget,
                               n_sink=page * 2, n_window=page * 2, tau=0.8),
    }
    ref, results = None, {}
    for name, fkv in methods.items():
        eng = ServeEngine(cfg, fkv, params, max_len=args.context + args.new_tokens + page + 64,
                          batch_size=args.batch, scheduler=args.scheduler,
                          prefix_cache_tokens=args.prefix_cache_tokens, device=args.device)
        reqs = [Request(uid=i, tokens=p, max_new_tokens=args.new_tokens)
                for i, p in enumerate(prompts)]
        outs = eng.generate(reqs)
        toks = outs[0].tokens
        if name == "full":
            ref = toks
        agree = np.mean([a == b for a, b in zip(toks, ref)]) if ref else float("nan")
        o = outs[0]
        em = eng.last_metrics
        print(f"{name:8s} step={o.decode_s / max(o.steps, 1) * 1e3:7.1f} ms "
              f"match_vs_full={agree:.2f} "
              f"corr_rate={o.stats.get('correction_rate', 0):.3f} "
              f"occupancy={em.slot_occupancy if em else 0:.2f} "
              f"tokens={toks[:8]}...")
        results[name] = outs
    return results


if __name__ == "__main__":
    main()
