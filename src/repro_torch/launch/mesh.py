"""Meshes (reference ``repro/launch/mesh.py``).

  make_tp_mesh(tp, devices)            -> TPMesh, the serving engine's 1-D
                                          ("model",) axis, one KV-head-group
                                          shard a device (``core/sharded_retrieval``)
  make_host_mesh(model_parallel, devices)
                                       -> Mesh, the 2-D ("data", "model") compute
                                          mesh of training (``models/model
                                          .forward_train``) and serving
                                          (``ServeEngine(mesh=)``)
  make_production_mesh(multi_pod)      -> Mesh of shape only (16 x 16, or
                                          2 x 16 x 16 with a "pod" axis), no
                                          devices: what ``sharding/rules``' tests
                                          read the parameter rules at

The port runs one process that drives every shard (a single controller),
so a mesh is the shards' devices and nothing more: no process group, no
collective. Its first device, ``(0, 0)``, is the primary one, where the
step's inputs and scalars live. Shards that share a card are asked for by
name (``devices=("cuda:0", "cuda:0")``), never taken in place of a missing
card, and a mesh never falls back to fewer shards or to the CPU.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.sharding.transfer import Moved


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


@dataclass(frozen=True)
class Mesh:
    """A mesh of named axes. ``dims[a]`` is the size of ``axis_names[a]``;
    a placed ("data", "model") mesh also has ``devices[i][j]``, the device
    of data index i and model index j (devices may repeat), and ``moved``,
    the bytes its shards have moved between them (``sharding/transfer``).
    A shape-only mesh (``make_production_mesh``) has ``devices`` None."""
    axis_names: Tuple[str, ...]
    dims: Tuple[int, ...]
    devices: Optional[Tuple[Tuple[torch.device, ...], ...]] = None
    moved: Moved = field(default_factory=Moved, compare=False, hash=False, repr=False)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    def device(self, coord) -> torch.device:
        """The device of shard ``coord`` = (data index, model index)."""
        return self.devices[coord[0]][coord[1]]

    @property
    def primary(self) -> torch.device:
        return self.devices[0][0]


def is_compute_mesh(mesh) -> bool:
    """Whether ``mesh`` is a ("data", "model") compute mesh (``Mesh``, which
    the serving entry points run the backbone over), as opposed to serving
    TP's ``TPMesh`` (a "model" axis only) or no mesh."""
    return mesh is not None and "data" in getattr(mesh, "axis_names", ())


def make_host_mesh(model_parallel: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A (n // model_parallel, model_parallel) ("data", "model") mesh over
    ``devices`` in row-major order (reference ``make_host_mesh``). With no
    ``devices`` it takes every visible card, and raises when there is none
    or their count does not divide by ``model_parallel``. ``devices`` names
    each shard's device and may repeat one: ``("cuda:0",) * 4`` gives a
    (2, 2) mesh on one card at ``model_parallel`` 2, ``("cpu",) * 4`` the same
    on the CPU."""
    mp = model_parallel
    if mp < 1:
        raise ValueError(f"model_parallel={mp} must be at least 1")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have == 0 or have % mp:
            raise RuntimeError(
                f"model_parallel={mp} needs {mp} devices (or a multiple of {mp}), this "
                f"machine has {have} cuda devices; name the devices (devices=('cuda:0',) * "
                f"{mp} puts every shard on one card)")
        devices = [f"cuda:{i}" for i in range(have)]
    if not devices or len(devices) % mp:
        raise ValueError(f"model_parallel={mp} needs {mp} devices (or a multiple of {mp}), "
                         f"got {len(devices)}: {list(devices)}")
    devs = _check_devices(devices)
    n_data = len(devs) // mp
    grid = tuple(tuple(devs[i * mp:(i + 1) * mp]) for i in range(n_data))
    return Mesh(("data", "model"), (n_data, mp), grid)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh as a shape: 16 x 16 ("data",
    "model"), or 2 x 16 x 16 with a leading "pod" axis. It holds no
    devices."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def _check_devices(devices) -> Tuple[torch.device, ...]:
    devs = tuple(indexed_device(resolve_device(d)) for d in devices)
    if len({d.type for d in devs}) != 1 or devs[0].type not in ("cuda", "cpu"):
        raise ValueError(f"a mesh is all cuda or all cpu devices, got {list(devs)}")
    for d in devs:
        if d.type == "cuda" and d.index >= torch.cuda.device_count():
            raise RuntimeError(f"{d} requested but this machine has "
                               f"{torch.cuda.device_count()} cuda devices")
    return devs


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
    return TPMesh(_check_devices(devices))


def indexed_device(dev: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so that equal devices compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
