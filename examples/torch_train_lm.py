"""Train a small LM on the PyTorch port with the synthetic pipeline for a
few hundred steps, then checkpoint it — the training example.

    PYTHONPATH=src python examples/torch_train_lm.py [--device cpu] --steps 200

The port's form of ``examples/train_lm.py``, with its flags plus
``--device`` (default ``cuda``). ``--ckpt`` writes ``{"params", "opt"}`` in
the reference's checkpoint layout (default ``build/torch_train_lm.npz`` in
the checkout).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.synthetic import lm_batches
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import AdamWConfig, tree_leaves
from repro_torch.training.train_step import init_train, make_train_step

DEFAULT_CKPT = os.path.join(os.path.dirname(__file__), "..", "build", "torch_train_lm.npz")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m-smoke")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    params, opt_state = init_train(cfg, opt, seed=0, device=dev)
    n_params = sum(x.numel() for _, x in tree_leaves(params))
    print(f"{cfg.name}: {n_params / 1e6:.1f}M params")
    step = make_train_step(cfg, opt)
    data = lm_batches(cfg.vocab_size, args.seq, args.batch, seed=0)
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        tokens = torch.from_numpy(next(data)).to(dev)
        params, opt_state, m = step(params, opt_state, {"tokens": tokens})
        if i % 20 == 0 or i == args.steps - 1:
            losses.append(float(m["loss"]))
            tput = args.batch * args.seq * (i + 1) / (time.time() - t0)
            print(f"step {i:4d} loss={losses[-1]:.3f} lr={float(m['lr']):.2e} "
                  f"grad_norm={float(m['grad_norm']):.2f} tok/s={tput:.0f}")
    checkpoint.save(args.ckpt, cfg, {"params": params, "opt": opt_state})
    print(f"checkpoint -> {args.ckpt}")
    return losses


if __name__ == "__main__":
    main()
