"""The serving engine's tensor-parallel mesh (reference
``repro/launch/mesh.py``): a 1-D ``("model",)`` axis over an explicit list
of devices, one a KV-head-group shard (``core/sharded_retrieval``).

The port runs one process that drives every shard (a single controller),
so a mesh is the shards' devices and nothing more: no process group, no
collective. The first device is the primary one, where the backbone runs.
Two shards on one card are asked for by name (``devices=("cuda:0",
"cuda:0")``), never taken in place of a missing card.
``make_host_mesh`` and ``make_production_mesh`` are not ported (ROADMAP
queue 1 item 2, ``--model-parallel``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device


@dataclass(frozen=True)
class TPMesh:
    """``devices[s]`` holds shard ``s``; ``shape["model"]`` is their count."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("model",)

    @property
    def shape(self) -> dict:
        return {"model": len(self.devices)}

    @property
    def primary(self) -> torch.device:
        return self.devices[0]


def make_tp_mesh(tp: int, devices: Optional[Sequence] = None) -> TPMesh:
    """A ``tp``-shard mesh. With no ``devices`` it takes ``cuda:0`` ..
    ``cuda:tp-1`` and raises when the machine has fewer cards (or none);
    ``devices`` names each shard's device, e.g. ``("cuda:0", "cuda:0")`` to
    put two shards on one card, or ``("cpu", "cpu")``."""
    if tp < 1:
        raise ValueError(f"tp={tp} must be at least 1")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < tp:
            raise RuntimeError(
                f"tp={tp} needs {tp} cuda devices, this machine has {have}; name the "
                "devices (devices=('cuda:0',) * tp puts every shard on one card)")
        devices = [f"cuda:{i}" for i in range(tp)]
    if len(devices) != tp:
        raise ValueError(f"tp={tp} shards but {len(devices)} devices: {list(devices)}")
    devs = tuple(indexed_device(resolve_device(d)) for d in devices)
    if len({d.type for d in devs}) != 1 or devs[0].type not in ("cuda", "cpu"):
        raise ValueError(f"a mesh is all cuda or all cpu devices, got {list(devs)}")
    for d in devs:
        if d.type == "cuda" and d.index >= torch.cuda.device_count():
            raise RuntimeError(f"{d} requested but this machine has "
                               f"{torch.cuda.device_count()} cuda devices")
    return TPMesh(devs)


def indexed_device(dev: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so that equal devices compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
