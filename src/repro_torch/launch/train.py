"""Training launcher CLI (reference ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch smollm-360m-smoke --steps 100 --batch 8 --seq 128

Seeded random params (``init_train``, seed 0), AdamW at ``--lr`` with a
warmup of ``steps // 10`` and a cosine over ``--steps``, the reference's
synthetic LM stream (``lm_batches``, seed 0), and a step line every
``--log-every`` steps and at the last, in the reference's format.
``--ckpt`` writes ``{"params", "opt"}`` in the reference's layout
(``training/checkpoint``). ``--device`` defaults to ``cuda`` and raises
without a card.

``--model-parallel N`` trains on a (n / N, N) ("data", "model") mesh
(``launch/mesh.make_host_mesh``) over every visible card, and raises unless
their count divides by N; ``--mesh-devices DEV,DEV,...`` names the shards'
devices instead, e.g. ``cuda:0,cuda:0`` for two shards on one card or
``cpu,cpu`` (with ``--device cpu``) on the CPU. The mesh's first device is
``--device``: a ``--device cpu`` mesh needs ``--mesh-devices``, and a mesh
whose first device is another raises. It never trains on one device in
place of a mesh.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.synthetic import lm_batches
from repro_torch.launch.mesh import indexed_device, make_host_mesh
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
    ap.add_argument("--mesh-devices", default=None,
                    help="comma-separated devices of the mesh's shards, row-major over "
                         "(data, model), e.g. cuda:0,cuda:0")
    args = ap.parse_args(argv)

    dev = indexed_device(resolve_device(args.device))
    mesh = None
    if args.model_parallel > 1 or args.mesh_devices:
        mp = args.model_parallel
        if args.mesh_devices:
            devices = args.mesh_devices.split(",")
        elif dev.type == "cuda":
            devices = None                  # every visible card
        else:
            raise RuntimeError(
                f"model_parallel={mp} needs {mp} devices, --device {dev} is one; name the "
                f"shards' devices with --mesh-devices {','.join([str(dev)] * mp)}")
        mesh = make_host_mesh(mp, devices)
        if mesh.primary != dev:
            raise ValueError(f"the mesh's first device {mesh.primary} is not --device {dev}")
        print(f"mesh {dict(mesh.shape)} on {[str(d) for r in mesh.devices for d in r]}",
              flush=True)
    cfg = get_config(args.arch)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
    params, opt_state = init_train(cfg, opt, seed=0, device=dev, mesh=mesh)
    step = make_train_step(cfg, opt, mesh=mesh)
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
