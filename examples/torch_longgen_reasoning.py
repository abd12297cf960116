"""Long generation on the PyTorch port (the paper's reasoning-model case): a
short prompt, a long sampled decode, the correction statistics under two
values of tau — speculative retrieval's correction at work.

    PYTHONPATH=src python examples/torch_longgen_reasoning.py [--device cpu]

The port's form of ``examples/longgen_reasoning.py``, plus ``--device``
(default ``cuda``).
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
from repro_torch.serving.sampling import SamplerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config("smollm-360m-smoke")
    params = init_params(cfg, seed=0, device=args.device)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, 48).astype(np.int32)
    outs = {}
    for tau in (0.8, 0.9):
        fkv = FreeKVConfig(method="freekv", page_size=8, budget=96, n_sink=16, n_window=16,
                           tau=tau)
        eng = ServeEngine(cfg, fkv, params, max_len=512, batch_size=1,
                          sampler=SamplerConfig(temperature=0.6, top_p=0.95),
                          device=args.device)
        out = eng.generate([Request(uid=0, tokens=prompt, max_new_tokens=96)])[0]
        print(f"tau={tau}: generated {len(out.tokens)} tokens, "
              f"correction_rate={out.stats['correction_rate']:.3f}, "
              f"mean_query_similarity={out.stats['mean_similarity']:.3f}, "
              f"{out.decode_s / max(out.steps, 1) * 1e3:.1f} ms/step")
        outs[tau] = out
    return outs


if __name__ == "__main__":
    main()
