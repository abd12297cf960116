"""Sharding rules (reference ``repro/sharding/rules.py``): the parameters'
and batches' specs over a ("data", "model") mesh and the placement that
follows them, and the retrieval state's KV-head axis under serving TP.

  param_spec(mesh, path, shape)      -> the reference's spec, one tuple of
                                        axis names a dim
  batch_shardings(cfg, mesh, batch)  -> {key: spec}
  shard_params(cfg, params, mesh)    -> params whose leaves are ``Sharded``
  gather_params(params, device)      -> the unsharded params
  tp_state_axis(key), join_state     -> serving TP's state layout

**Parameters.** A leaf's spec splits its trailing matrix dims, the input
dim over the FSDP axes ("data", with "pod" on the production mesh) and the
output dim over "model", where they divide; ``embed/tok`` puts the vocab
over "model"; a 3-D expert tensor (E, a, b) the experts over "model" and a
over the FSDP axes; 1-D leaves are replicated. The port's layers are not
stacked along a periods axis, so every layer's leaves take the rule as the
reference applies it to a prelude leaf: a pattern layer's norms are
replicated and its experts split by expert over "model" (the reference's
stacked pattern leaves split the period axis and leave the experts whole;
a difference by design, ROADMAP).

**Placement.** ``shard_params`` cuts each leaf into the blocks of its spec
and holds each block once: a ``Sharded`` leaf's piece lives on the shard
whose "data" and "model" indices are its block's along the dims split over
those axes, and on index 0 of an axis it is not split over (the reference
keeps a copy on every device of that axis; a second difference by design).
So AdamW sees every element once. Compute fetches the blocks it needs
(``Sharded.block``, through ``sharding/transfer``) and autograd brings the
gradients back to the pieces.

**Serving TP's state** (the KV-head branch of the reference's
``decode_state_spec``, ``repro/sharding/rules.py:145-173``). The shards of
``core/sharded_retrieval.TPGroupShardedRetriever`` do not read this table:
each builds its slice of every leaf itself, as the plain retriever of a
local config whose head counts are divided by tp, and holds it under
``"<shard>/<key>"``. The table says how those slices join back into the
unsharded layout (its KV heads, or for ``qprev`` its query heads; the
leaves with no such axis, lengths and ring positions, whole in every
shard): ``join_state`` does that join. The tests hold the table against
the reference's ``tp_state_specs`` and the joined state against the
unsharded retriever.
"""
from __future__ import annotations

import itertools
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.sharding import transfer

Spec = Tuple[Tuple[str, ...], ...]


# ---------------------------------------------------------------------------
# parameters and batches
# ---------------------------------------------------------------------------
def axsize(mesh, names) -> int:
    return math.prod(mesh.shape[n] for n in names)


def _div(n: int, mesh, names) -> bool:
    return bool(names) and all(a in mesh.axis_names for a in names) \
        and n % axsize(mesh, names) == 0


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def param_spec(mesh, path: str, shape: Sequence[int]) -> Spec:
    """The reference's ``param_spec`` for the leaf at ``path`` ("/"-joined
    keys) of ``shape``, as one tuple of axis names a dim (() where the dim
    is whole)."""
    nd = len(shape)
    fsdp = batch_axes(mesh)
    if nd <= 1:
        return ((),) * nd
    if "embed/tok" in path:
        # (V, d): the vocab over "model", so the tied head's logits come out
        # vocab-sharded for the vocab-parallel cross-entropy
        return (("model",) if _div(shape[0], mesh, ("model",)) else (),
                fsdp if _div(shape[1], mesh, fsdp) else ())
    if nd == 3 and any(k in path for k in ("wg", "wu", "wd")):    # (E, a, b)
        return (("model",) if _div(shape[0], mesh, ("model",)) else (),
                fsdp if _div(shape[1], mesh, fsdp) else (), ())
    if nd == 3 and "/R" in path:                                   # slstm (nh, 4dh, dh)
        return ((), (), ())
    # the two trailing matrix dims (a stacked period axis ahead stays whole)
    return ((),) * (nd - 2) + (fsdp if _div(shape[-2], mesh, fsdp) else (),
                               ("model",) if _div(shape[-1], mesh, ("model",)) else ())


def batch_shardings(cfg, mesh, batch) -> dict:
    """{key: spec} for a batch of arrays or shapes: the batch dim over the
    batch axes where it divides (reference ``batch_shardings``)."""
    ba = batch_axes(mesh)
    out = {}
    for key, leaf in batch.items():
        shape = tuple(getattr(leaf, "shape", leaf))
        out[key] = (ba if _div(shape[0], mesh, ba) else (),) + ((),) * (len(shape) - 1)
    return out


class Sharded:
    """A leaf of logical ``shape`` held as pieces over a ("data", "model")
    ``mesh`` by ``spec``: dim d is cut into ``grid[d]`` equal blocks, and
    ``pieces`` lists the blocks in row-major grid order, each on its owner
    shard's device (``owner``)."""
    __slots__ = ("pieces", "spec", "shape", "mesh", "grid")

    def __init__(self, pieces, spec: Spec, shape, mesh):
        self.pieces, self.spec, self.mesh = tuple(pieces), spec, mesh
        self.shape = torch.Size(shape)
        for axes in spec:
            assert len(axes) <= 1 and set(axes) <= {"data", "model"}, spec
        self.grid = tuple(axsize(mesh, axes) for axes in spec)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    def _coords(self, k: int):
        out = []
        for n in reversed(self.grid):
            out.append(k % n)
            k //= n
        return tuple(reversed(out))

    def owner(self, k: int) -> Tuple[int, int]:
        """The (data, model) shard that holds piece ``k``."""
        at = {"data": 0, "model": 0}
        for axes, c in zip(self.spec, self._coords(k)):
            for a in axes:
                at[a] = c
        return at["data"], at["model"]

    @classmethod
    def place(cls, full: torch.Tensor, spec: Spec, mesh) -> "Sharded":
        """``full`` cut by ``spec``, each piece copied to its owner's device."""
        s = cls((), spec, full.shape, mesh)
        pieces = []
        for k in range(math.prod(s.grid)):
            sl = tuple(slice(c * (n // g), (c + 1) * (n // g))
                       for c, n, g in zip(s._coords(k), full.shape, s.grid))
            pieces.append(full[sl].to(mesh.device(s.owner(k)), copy=True).contiguous())
        s.pieces = tuple(pieces)
        return s

    def like(self, pieces) -> "Sharded":
        """Other pieces (a gradient's, a moment's) in this leaf's layout."""
        return Sharded(pieces, self.spec, self.shape, self.mesh)

    def full(self, device=None) -> torch.Tensor:
        """A copy of the whole leaf on ``device`` (the mesh's primary by
        default), outside autograd's moves: checkpoints and tests."""
        device = self.mesh.primary if device is None else device
        return _join([p.detach().to(device, copy=True) for p in self.pieces], self.grid)

    def block(self, box, dst, kind: str) -> torch.Tensor:
        """The part of the leaf inside ``box`` (a (start, stop) a dim) on shard
        ``dst``: the pieces it meets, each sliced where it holds them and
        moved from its owner (``transfer.move``), joined along the grid. A
        box that is one whole piece held by ``dst`` is that piece itself."""
        spans = []
        for (a, b), n, g in zip(box, self.shape, self.grid):
            w = n // g
            spans.append([(c, max(a, c * w) - c * w, min(b, (c + 1) * w) - c * w)
                          for c in range(a // w, -(-b // w))])
        parts = []
        for sel in itertools.product(*spans):
            k = 0
            for (c, _, _), g in zip(sel, self.grid):
                k = k * g + c
            piece = self.pieces[k]
            if any(lo != 0 or hi != n for (_, lo, hi), n in zip(sel, piece.shape)):
                piece = piece[tuple(slice(lo, hi) for _, lo, hi in sel)]
            parts.append(transfer.move(self.mesh, piece, self.owner(k), dst, kind))
        return _join(parts, tuple(len(s) for s in spans))


def _join(parts, grid):
    """Blocks in row-major order over ``grid`` joined into one tensor."""
    if len(parts) == 1:
        return parts[0]
    for d in reversed(range(len(grid))):
        n = grid[d]
        if n > 1:
            parts = [torch.cat(parts[i:i + n], dim=d) for i in range(0, len(parts), n)]
    return parts[0]


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def map_leaves(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples, a
    ``Sharded`` leaf being one leaf."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def shard_params(cfg, params, mesh):
    """``params`` (the port's tree of tensors) with each leaf a ``Sharded``
    by ``param_spec`` of its "/"-joined path, placed on ``mesh``."""
    return map_leaves(lambda path, t: Sharded.place(
        t.detach(), param_spec(mesh, _path_str(path), t.shape), mesh), params)


def gather_params(params, device=None):
    """The inverse of ``shard_params``: every ``Sharded`` leaf whole on
    ``device`` (its mesh's primary by default); other leaves unchanged."""
    return map_leaves(lambda _, t: t.full(device) if isinstance(t, Sharded) else t, params)


# ---------------------------------------------------------------------------
# serving TP's retrieval state
# ---------------------------------------------------------------------------
# leaf key -> its KV-head axis (B leading; the port has no stacked periods)
_KV_AXIS = {
    # (B, n_pages, kv, ...): the pool, its quant scales, the page summaries
    "pool": 2, "pool_scale": 2, "summ": 2,
    # the centroid index, kv on axis 2 like summ (``core/centroid_index``)
    "cent": 2, "cent_mean": 2, "cent_assign": 2, "cent_count": 2,
    # (B, kv, n_sel, ...): the selection buffers
    "sel_k": 1, "sel_v": 1, "sel_idx": 1,
    # (B, T, kv, d): sink and window rings, the full cache, cross-attention
    "sink_k": 2, "sink_v": 2, "win_k": 2, "win_v": 2, "k": 2, "v": 2, "xk": 2, "xv": 2,
    # (B, kv, ...): ShadowKV's key factors, RaaS's kept pages
    "k_u": 1, "k_w": 1, "keep_k": 1, "keep_v": 1, "keep_idx": 1, "last_used": 1,
}
# leaf key -> its query-head axis
_HEAD_AXIS = {"qprev": 1}                         # (B, H, d)


def base_key(key: str) -> str:
    """A leaf's key without its shard prefix: ``"1/pool"`` -> ``"pool"``."""
    return key.rsplit("/", 1)[-1]


def tp_state_axis(key: str) -> Optional[int]:
    """The axis of retrieval-state leaf ``key`` that is split over the
    shards, or None for a leaf every shard holds whole."""
    key = base_key(key)
    return _KV_AXIS.get(key, _HEAD_AXIS.get(key))


def join_state(state: dict, tp: int, device="cpu") -> dict:
    """A layer's ``tp`` shards as one state in the unsharded layout, on
    ``device``: split leaves concatenated along ``tp_state_axis``, whole
    ones taken from shard 0."""
    out = {}
    for key in [k[2:] for k, t in state.items()
                if k.startswith("0/") and isinstance(t, torch.Tensor)]:
        parts = [state[f"{s}/{key}"].to(device) for s in range(tp)]
        axis = tp_state_axis(key)
        out[key] = parts[0] if axis is None else torch.cat(parts, dim=axis)
    return out
