"""Training launcher CLI (reference ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch smollm-360m-smoke --steps 100 --batch 8 --seq 128

Seeded random params (``init_train``, seed 0), AdamW at ``--lr`` with a
warmup of ``steps // 10`` and a cosine over ``--steps``, the reference's
synthetic LM stream (``lm_batches``, seed 0), and a step line every
``--log-every`` steps and at the last, in the reference's format.
``--ckpt`` writes ``{"params", "opt"}`` in the reference's layout
(``training/checkpoint``). ``--device`` defaults to ``cuda`` and raises
without a card. One device only: ``--model-parallel`` above 1 raises.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.synthetic import lm_batches
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import init_train, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m-smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1: the port trains on one device; tensor parallelism is "
            "ROADMAP queue 1 item 2")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
    params, opt_state = init_train(cfg, opt, seed=0, device=dev)
    step = make_train_step(cfg, opt)
    data = lm_batches(cfg.vocab_size, args.seq, args.batch, seed=0)
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        tokens = torch.from_numpy(next(data)).to(dev)
        params, opt_state, m = step(params, opt_state, {"tokens": tokens})
        if i % args.log_every == 0 or i == args.steps - 1:
            loss = float(m["loss"])
            losses.append(loss)
            tput = args.batch * args.seq * (i + 1) / (time.time() - t0)
            print(f"step {i:5d} loss={loss:.4f} "
                  f"lr={float(m['lr']):.2e} tok/s={tput:.0f}", flush=True)
    if args.ckpt:
        checkpoint.save(args.ckpt, cfg, {"params": params, "opt": opt_state})
        print(f"checkpoint -> {args.ckpt}")
    return losses


if __name__ == "__main__":
    main()
