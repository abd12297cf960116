"""Checkpoints as flattened-path ``.npz`` files in the reference's layout
(``repro/training/checkpoint.py``), so that a file crosses both ways
between the two packages.

The state ``{"params": params, "opt": {"m", "v", "step"}}`` is written as
the reference's pytree: params (and the moments, which have their shape)
through ``params_to_numpy``, stacked per pattern position along the
periods; keys are the paths joined by "/" (``"params/pattern/0/mixer/wq"``,
``"opt/m/embed/tok"``, ``"opt/step"``). bfloat16 leaves are written as
float32 (exact) and cast back to the leaf's dtype on restore; a bfloat16
array written by the reference (numpy's 2-byte void) is read as its bits.
Writes are atomic: a ``.tmp.npz`` file, then ``os.replace``.

A state placed on a mesh (``init_train(mesh=)``) is gathered into the
unsharded layout as it is written, and ``restore`` cuts each leaf onto the
mesh of ``like``'s ``Sharded`` leaf, so a file crosses between meshes
(1 x 2 to 1 x 1 and back) and to the unsharded state bit for bit.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import params_from_jax, params_to_numpy
from repro_torch.sharding.rules import Sharded, gather_params, map_leaves
from repro_torch.training.optimizer import tree_leaves


def _is_params(tree):
    return isinstance(tree, dict) and "embed" in tree and "layers" in tree


def _to_reference(cfg, tree):
    if _is_params(tree):
        return params_to_numpy(cfg, tree)
    if isinstance(tree, dict):
        return {k: _to_reference(cfg, v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def _flatten(tree):
    return {"/".join(str(k) for k in path): leaf for path, leaf in tree_leaves(tree)}


def save(path: str, cfg: ArchConfig, tree) -> None:
    """Write ``tree`` (the port's ``{"params", "opt"}``, or any dict of such
    trees and tensors) to ``path`` in the reference's layout."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **_flatten(_to_reference(cfg, gather_params(tree, "cpu"))))
    os.replace(tmp, path)


def _array(a):
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:       # bfloat16 bits
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a


def _unflatten(data):
    """{"a/0/b": x} -> {"a": ({"b": x},)}: dicts whose keys are all digits
    become tuples, as the reference's prelude and pattern."""
    root = {}
    for key in data.files:
        *parents, last = key.split("/")
        node = root
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = _array(data[key])

    def seq(t):
        if not isinstance(t, dict):
            return t
        t = {k: seq(v) for k, v in t.items()}
        if t and all(k.isdigit() for k in t):
            return tuple(t[str(i)] for i in range(len(t)))
        return t
    return seq(root)


def _from_reference(cfg, np_tree, like):
    if _is_params(like):
        np_tree = dict(np_tree)
        np_tree.setdefault("prelude", ())
        got = params_from_jax(cfg, np_tree, device="cpu")
    elif isinstance(like, dict):
        return {k: _from_reference(cfg, np_tree[k], v) for k, v in like.items()}
    else:
        got = torch.from_numpy(np.array(np_tree))
    paths = lambda t: sorted(map(str, (p for p, _ in tree_leaves(t))))   # noqa: E731
    logical = map_leaves(lambda _, t: t.pieces[0] if isinstance(t, Sharded) else t, like)
    assert paths(got) == paths(logical), "the file's tree differs from the state's"
    return _cast_like(got, like)


def _cast_like(got, like, path=()):
    if isinstance(like, dict):
        return {k: _cast_like(got[k], v, path + (k,)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_cast_like(g, v, path + (i,)) for i, (g, v) in
                          enumerate(zip(got, like)))
    assert got.shape == like.shape, (path, tuple(got.shape), tuple(like.shape))
    if isinstance(like, Sharded):
        return Sharded.place(got.to(like.dtype), like.spec, like.mesh)
    return got.to(device=like.device, dtype=like.dtype)


def restore(path: str, cfg: ArchConfig, like):
    """The state in ``path`` in the structure of ``like`` (the port's tree
    that ``save`` takes), each leaf on ``like``'s device at its dtype, a
    ``Sharded`` leaf cut onto its mesh by its spec; shapes must match."""
    with np.load(path) as data:
        return _from_reference(cfg, _unflatten(data), like)
