"""Moves between the shards of a mesh, counted (the training side of the
collective term, ROADMAP queue 1 item 2).

One controller drives every shard of a ``launch/mesh.Mesh``, so what would
be a collective on several cards is a set of ``.to`` moves between the
shards' devices. Every such move goes through ``move``, one
``torch.autograd.Function`` whose forward moves the tensor to the
destination shard's device and whose backward moves the gradient back; both
add the tensor's bytes to the mesh's counter (``mesh.moved``, a ``Moved``)
under the move's kind. Bytes count when the two shards
differ, whether or not their devices do, so two shards on one card count
what two cards would send over NVLink. A rematerialised period's moves run
again in the backward and count again.

Kinds:
  weight_gather  a weight's pieces brought to the shard that computes with
                 them: the FSDP dim over "data", and the compute re-layout of
                 the reference's ``_gather_for_compute`` (training; serving
                 places its weights in the compute layout, so only its FSDP
                 form fetches)
  partial_sum    the row-parallel and input-dim-split reductions, with the
                 broadcast of their input to the model shards (an
                 all-reduce's two halves), the query-row attention's
                 moves and the mLSTM's all-gather of its inner input
  vocab          the vocab-parallel embedding, logits and cross-entropy
  expert_sum     the expert-parallel MoE's input broadcast and output sum
  data           batch blocks to their data group, and the loss's terms back
                 (serving: the step's tokens and positions out, the logits back)

and, serving under a mesh (``models/model``, ``core/sharded_retrieval``):
  attn_in        a decode step's query and new K/V brought to the shards
                 that attend with them (the page shards of the fused step,
                 or shard 0 where the heads were made on other shards)
  attn_out       the attention output handed back to the shards of a
                 row-parallel out projection
  lse            the fused step's (output, log-sum-exp) partials and the
                 selected ids its telemetry reads
  overselect     the fused step's candidate scores and kept masks
                 (``sharded_overselect``)
  state          retrieval state and K/V moved whole between shards at a
                 prefill (the fused step's page and slot ranges, K/V joined
                 for the prefix cache or split for an extension)
  stats          a decode step's retrieval counters brought to shard 0

``MeshRow`` is the model shards of one data group, with the moves the
model code makes inside it.
"""
from __future__ import annotations

from typing import Callable, List

import torch

KINDS = ("weight_gather", "partial_sum", "vocab", "expert_sum", "data", "attn_in", "attn_out",
         "lse", "overselect", "state", "stats")


class Moved:
    """Bytes moved between a mesh's shards, by kind (``bytes``). The train
    step resets it as it starts, so after a step it holds that step's."""

    def __init__(self):
        self.bytes = dict.fromkeys(KINDS, 0)

    def reset(self):
        self.bytes = dict.fromkeys(KINDS, 0)

    def add(self, kind: str, t: torch.Tensor):
        self.bytes[kind] += t.numel() * t.element_size()


class _Move(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dst, kind, moved):
        ctx.src, ctx.kind, ctx.moved = x.device, kind, moved
        moved.add(kind, x)
        return x.to(dst)

    @staticmethod
    def backward(ctx, g):
        ctx.moved.add(ctx.kind, g)
        return g.to(ctx.src), None, None, None


def move(mesh, x: torch.Tensor, src, dst, kind: str) -> torch.Tensor:
    """``x``, held by shard ``src`` = (data index, model index), on shard
    ``dst``'s device; counted in ``mesh.moved`` under ``kind`` when the
    shards differ."""
    if tuple(src) == tuple(dst):
        return x
    return _Move.apply(x, mesh.device(dst), kind, mesh.moved)


class MeshRow:
    """The ``m`` model shards of data group ``g``: shard j is ``(g, j)``, and
    shard 0 holds the group's activations between sublayers."""

    def __init__(self, mesh, g: int):
        self.mesh, self.g = mesh, g
        self.m = mesh.shape["model"]

    def device(self, j: int) -> torch.device:
        return self.mesh.device((self.g, j))

    def move(self, x, j_src: int, j_dst: int, kind: str):
        return move(self.mesh, x, (self.g, j_src), (self.g, j_dst), kind)

    def broadcast(self, x, kind: str) -> List[torch.Tensor]:
        """``x`` from shard 0 on every shard of the row."""
        return [self.move(x, 0, j, kind) for j in range(self.m)]

    def reduce(self, parts, kind: str, op: Callable = torch.add) -> torch.Tensor:
        """``op`` over the shards' ``parts`` (part j on shard j), in shard
        order, on shard 0; one part comes back as it is."""
        out = parts[0]
        for j in range(1, len(parts)):
            out = op(out, self.move(parts[j], j, 0, kind))
        return out

    def fetch(self, leaf, j: int, dim=None) -> torch.Tensor:
        """Shard j's compute block of a placed weight (``sharding/rules
        .Sharded``, ``Copies`` or ``Halves``): block j of ``m`` along
        ``dim``, or the whole leaf when ``dim`` is None."""
        box = [(0, n) for n in leaf.shape]
        if dim is not None:
            n = leaf.shape[dim] // self.m
            box[dim] = (j * n, (j + 1) * n)
        return leaf.block(box, (self.g, j), "weight_gather")

    def span(self, leaf, j: int, dim: int, lo: int, hi: int) -> torch.Tensor:
        """Elements [lo, hi) along ``dim`` of a placed weight, whole along
        its other dims, on shard j (one half's block of a fused (d, 2 n)
        projection)."""
        box = [(0, n) for n in leaf.shape]
        box[dim] = (lo, hi)
        return leaf.block(box, (self.g, j), "weight_gather")

    def whole(self, tree, j: int = 0):
        """Every leaf of a subtree of placed weights, whole on shard j."""
        if isinstance(tree, dict):
            return {k: self.whole(v, j) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.whole(v, j) for v in tree)
        return self.fetch(tree, j)
