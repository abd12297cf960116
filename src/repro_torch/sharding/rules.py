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


def param_spec(mesh, path: str, shape: Sequence[int], fsdp_shard: bool = True) -> Spec:
    """The reference's ``param_spec`` for the leaf at ``path`` ("/"-joined
    keys) of ``shape``, as one tuple of axis names a dim (() where the dim
    is whole). ``fsdp_shard=False`` (the serving layout under
    ``inference_fsdp`` False) splits no dim over the batch axes."""
    nd = len(shape)
    fsdp = batch_axes(mesh) if fsdp_shard else ()
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


def inference_fsdp(cfg, mesh, hbm_budget_frac: float = 0.25, hbm_bytes: float = None) -> bool:
    """The serving weight layout (reference ``rules.py:87-94``): True keeps
    the FSDP dim (a model's bf16 weights over its model shards exceed
    ``hbm_budget_frac`` of a device's ``hbm_bytes``), False stores them
    split over "model" only, a copy in every data group, so a decode step
    gathers no weight. The reference's budget is a TPU's 16e9 bytes; the
    port's default is the H100's ``roofline.CARD_BYTES``."""
    if hbm_bytes is None:
        from repro_torch.launch.roofline import CARD_BYTES
        hbm_bytes = CARD_BYTES
    mp = mesh.shape["model"] if "model" in mesh.axis_names else 1
    per_dev = cfg.param_counts()["total"] * 2 / mp
    return per_dev > hbm_budget_frac * hbm_bytes


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
    __slots__ = ("pieces", "spec", "shape", "mesh", "grid", "home")

    def __init__(self, pieces, spec: Spec, shape, mesh, home: int = 0):
        self.pieces, self.spec, self.mesh, self.home = tuple(pieces), spec, mesh, home
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
        at = {"data": self.home, "model": 0}
        for axes, c in zip(self.spec, self._coords(k)):
            for a in axes:
                at[a] = c
        return at["data"], at["model"]

    @classmethod
    def place(cls, full: torch.Tensor, spec: Spec, mesh, home: int = 0) -> "Sharded":
        """``full`` cut by ``spec``, each piece copied to its owner's device;
        a spec that does not split "data" puts every piece in data group
        ``home``."""
        s = cls((), spec, full.shape, mesh, home)
        pieces = []
        for k in range(math.prod(s.grid)):
            sl = tuple(slice(c * (n // g), (c + 1) * (n // g))
                       for c, n, g in zip(s._coords(k), full.shape, s.grid))
            pieces.append(full[sl].to(mesh.device(s.owner(k)), copy=True).contiguous())
        s.pieces = tuple(pieces)
        return s

    def like(self, pieces) -> "Sharded":
        """Other pieces (a gradient's, a moment's) in this leaf's layout."""
        return Sharded(pieces, self.spec, self.shape, self.mesh, self.home)

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


class Copies:
    """A serving weight that every model shard of data group ``home``
    computes with whole (the MoE router, which each expert shard routes
    with): one copy on each shard, so no step fetches it. ``block`` and
    ``full`` read like a ``Sharded`` leaf's."""
    __slots__ = ("pieces", "shape", "mesh", "home")

    def __init__(self, full: torch.Tensor, mesh, home: int):
        self.mesh, self.home, self.shape = mesh, home, full.shape
        self.pieces = tuple(full.to(mesh.device((home, j)), copy=True).contiguous()
                            for j in range(mesh.shape["model"]))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    def full(self, device=None) -> torch.Tensor:
        device = self.mesh.primary if device is None else device
        return self.pieces[0].detach().to(device, copy=True)

    def block(self, box, dst, kind: str) -> torch.Tensor:
        assert dst[0] == self.home, (dst, self.home)
        piece = self.pieces[dst[1]]
        if any(a != 0 or b != n for (a, b), n in zip(box, self.shape)):
            piece = piece[tuple(slice(a, b) for a, b in box)]
        return piece


class Halves:
    """A (d, 2 n) serving weight that two column halves make, Mamba's
    ``in_proj`` (``xm``, ``z``) or an mLSTM's ``up``, placed so that model
    shard j of data group ``home`` holds column block j of both halves: the
    d_inner- or head-split forms (``models/ssm``, ``models/xlstm``) then
    fetch nothing. ``param_spec``'s column split would give shard 0 the
    first half's columns only. ``block`` and ``full`` read like a
    ``Sharded`` leaf's."""
    __slots__ = ("halves", "shape", "mesh", "home")

    def __init__(self, full: torch.Tensor, mesh, home: int):
        n = full.shape[1] // 2
        cols = ((), ("model",))
        self.mesh, self.home, self.shape = mesh, home, full.shape
        self.halves = (Sharded.place(full[:, :n], cols, mesh, home),
                       Sharded.place(full[:, n:], cols, mesh, home))

    @property
    def pieces(self):
        return self.halves[0].pieces + self.halves[1].pieces

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self) -> torch.dtype:
        return self.halves[0].dtype

    def full(self, device=None) -> torch.Tensor:
        return torch.cat([h.full(device) for h in self.halves], dim=1)

    def block(self, box, dst, kind: str) -> torch.Tensor:
        n = self.shape[1] // 2
        (r0, r1), (a, b) = box
        parts = [h.block(((r0, r1), (max(a, off) - off, min(b, off + n) - off)), dst, kind)
                 for h, off in zip(self.halves, (0, n)) if a < off + n and b > off]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _mixer_kind(cfg, path: str):
    """The mixer a ``layers/<i>/mixer/...`` path belongs to (None for other
    paths: the encoder's layers and the cross-attention are attention)."""
    keys = path.split("/")
    if len(keys) > 2 and keys[0] == "layers" and keys[2] == "mixer":
        return cfg.layers[int(keys[1])][0]
    return None


def serving_spec(cfg, mesh, path: str, shape: Sequence[int]):
    """The layout a data group's model shards compute with the leaf at
    ``path`` in (the forward-only mesh forms of ``models/attention``,
    ``models/layers`` and ``models/moe``), where ``inference_fsdp`` is
    False: a ``Spec`` splitting over "model" the dim whose block j shard j
    multiplies by, whole (on shard 0) where the form computes with the whole
    leaf there, or "copies" where every shard computes with it whole. So a
    decode step fetches no weight. The reference stores by ``param_spec(
    fsdp_shard=False)`` and lets its compiler re-lay wo and down out for
    the row-parallel products; the port places them so once.

      attention wq/wk/wv  columns (KV-head groups, where m divides both head
                          counts), else rows (the input-dim split, where d
                          divides), else whole
      attention wo        rows where the heads or H * d_head divide, else whole
      MLP up/gate, down   columns, rows (the hidden width divides), else whole
      MoE wg/wu/wd        by expert (E divides), else whole; the router copies
      embed tok, head     by vocab row, column (the padded vocab divides),
                          else whole
      Mamba               in_proj "halves" (``Halves``), conv_w, dt_w by
                          column, x_proj, A_log, out_proj by row and
                          conv_b, dt_b, D by channel, where d_inner divides;
                          else whole
      mLSTM               up "halves", wq/wk/wv/wi/wf by column and bf by
                          head, down by row, where the heads divide; else
                          whole
      sLSTM               whole (it runs on the group's shard 0)
    The cross-attention's wq/wk/wv/wo and the encoder's layers take the
    attention and MLP rules. Other leaves take ``param_spec(fsdp_shard=
    False)`` (norms and 1-D biases: whole on shard 0)."""
    from repro_torch.configs.base import MAMBA, MLSTM, SLSTM
    from repro_torch.models.ssm import mamba_splits
    from repro_torch.models.xlstm import mlstm_splits
    m = mesh.shape["model"]
    nd = len(shape)
    key = path.rsplit("/", 1)[-1]
    whole = ((),) * nd
    rows = (("model",),) + ((),) * (nd - 1)
    cols = ((),) * (nd - 1) + (("model",),)
    mixer = _mixer_kind(cfg, path)
    if m > 1 and mixer in (MAMBA, MLSTM, SLSTM):
        split = {MAMBA: mamba_splits, MLSTM: mlstm_splits}.get(mixer, lambda *_: False)(cfg, m)
        if not split:
            return whole
        if key in ("in_proj", "up"):
            return "halves"
        by_col = ("conv_w", "dt_w") if mixer == MAMBA else ("wq", "wk", "wv", "wi", "wf")
        return cols if key in by_col else rows
    if m == 1 or nd < 2:
        return whole
    if ("mixer/" in path or "xattn/" in path) and key in ("wq", "wk", "wv", "wo"):
        if cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0:
            return rows if key == "wo" else cols
        return rows if shape[0] % m == 0 else whole
    if "ffn/" in path and key in ("up", "gate", "down"):
        hidden = shape[0] if key == "down" else shape[1]
        # a MoE whose experts do not divide runs whole, its shared experts too
        if hidden % m or ("ffn/shared/" in path and cfg.n_experts % m):
            return whole
        return rows if key == "down" else cols
    if "ffn/" in path and key in ("wg", "wu", "wd", "router"):
        if cfg.n_experts % m:
            return whole
        return "copies" if key == "router" else rows
    if path.startswith("embed/") and key in ("tok", "head"):
        if cfg.padded_vocab() % m:
            return whole
        return rows if key == "tok" else cols
    return param_spec(mesh, path, shape, fsdp_shard=False)


def place_serving_params(cfg, params, mesh, fsdp=None) -> list:
    """The serving layout of ``params`` (plain tensors) on ``mesh``: one
    tree a data group. ``fsdp`` None takes ``inference_fsdp(cfg, mesh)``.
    Without FSDP every data group holds its own copy on its own model shards
    (the reference's leaves are replicated over "data"), each leaf in the
    layout its shards compute with (``serving_spec``), so a step fetches no
    weight. With it the groups share one placement by ``param_spec``, each
    element held once, and a group fetches the blocks it lacks
    (``weight_gather``)."""
    if fsdp is None:
        fsdp = inference_fsdp(cfg, mesh)
    if fsdp:
        one = map_leaves(lambda path, t: Sharded.place(
            t.detach(), param_spec(mesh, _path_str(path), t.shape), mesh), params)
        return [one] * mesh.shape["data"]

    def place(home, path, t):
        spec = serving_spec(cfg, mesh, _path_str(path), t.shape)
        if spec == "copies":
            return Copies(t.detach(), mesh, home)
        if spec == "halves":
            return Halves(t.detach(), mesh, home)
        return Sharded.place(t.detach(), spec, mesh, home)
    return [map_leaves(lambda path, t: place(g, path, t), params)
            for g in range(mesh.shape["data"])]


def gather_params(params, device=None):
    """The inverse of ``shard_params``: every ``Sharded`` leaf whole on
    ``device`` (its mesh's primary by default); other leaves unchanged."""
    return map_leaves(lambda _, t: t.full(device) if isinstance(t, (Sharded, Copies, Halves))
                      else t, params)


# ---------------------------------------------------------------------------
# decode state under a mesh
# ---------------------------------------------------------------------------
def decode_state_spec(cfg, mesh, path: str, shape: Sequence[int], fkv=None) -> Spec:
    """The reference's ``decode_state_spec`` (``rules.py:113-186``) for the
    decode-state leaf at ``path`` ("/"-joined keys, the reference's stacked
    ``pattern`` leaves with their leading periods axis) of ``shape``, as
    one tuple of axis names a dim. Batch over the batch axes where it
    divides; under ``fkv.sharded_retrieval`` the pool, its scales and the
    summaries split by page and the selection buffers by slot over "model";
    otherwise the KV-head dim over "model" where it divides, else the page
    dim (over every axis at a batch that does not divide, the sequence-
    parallel form); the centroid index, ShadowKV's and RaaS's leaves, the
    rings and ``qprev`` by head; Mamba and the mLSTM by channel; the rest
    whole.

    The port stores by this table where its layout is the same: the
    KV-head groups of ``core/sharded_retrieval`` and the fused step's page
    and slot ranges. Where neither applies the port keeps a data group's
    retrieval state whole on its model shard 0 (a difference by design,
    ROADMAP)."""
    ba = batch_axes(mesh)
    shape = tuple(shape)
    nd = len(shape)
    lead = 0
    if "pattern" in path and nd >= 2:        # (n_periods, B, ...)
        lead, shape, nd = 1, shape[1:], nd - 1
    b_ok = _div(shape[0], mesh, ba)
    b_spec = ba if b_ok else ()

    def out(*rest):
        return ((),) * lead + (b_spec,) + tuple(() if r is None else
                                                (r,) if isinstance(r, str) else tuple(r)
                                                for r in rest)

    key = path.rsplit("/", 1)[-1]
    model = ("model",)
    kv_div = _div(cfg.n_kv_heads, mesh, model)
    kvm = "model" if kv_div else None
    if fkv is not None and fkv.sharded_retrieval:
        if key in ("pool", "pool_scale", "summ") and _div(shape[1], mesh, model):
            return out("model", *([None] * (nd - 2)))
        if key in ("sel_k", "sel_v") and _div(shape[2], mesh, model):
            return out(None, "model", None, None)
        if key == "sel_idx" and _div(shape[2], mesh, model):
            return out(None, "model")
    if key in ("pool", "pool_scale", "summ"):          # (B, n_pages, kv, ...)
        if kv_div:
            return out(None, "model", *([None] * (nd - 3)))
        page_axes = model if b_ok else tuple(a for a in ("pod", "data", "model")
                                             if a in mesh.axis_names)
        if _div(shape[1], mesh, page_axes):
            return out(page_axes, *([None] * (nd - 2)))
        return out(*([None] * (nd - 1)))
    if key in ("cent", "cent_mean", "cent_assign", "cent_count"):
        return out(None, kvm, *([None] * (nd - 3)))
    if key in ("sel_k", "sel_v"):                      # (B, kv, n_sel, p, d)
        return out(kvm, None, None, None)
    if key == "sel_idx":
        return out(kvm, None)
    if key in ("sink_k", "sink_v", "win_k", "win_v", "k", "v", "xk", "xv"):
        return out(None, kvm, None)                    # (B, T, kv, d)
    if key in ("k_u", "k_w"):                          # (B, kv, T, r)
        return out(kvm, None, None)
    if key in ("keep_k", "keep_v"):
        return out(kvm, None, None, None)
    if key in ("keep_idx", "last_used"):
        return out(kvm, None)
    if key == "qprev":                                 # (B, H, d)
        return out("model" if _div(cfg.n_heads, mesh, model) else None, None)
    if key == "h" and nd == 3:                         # mamba (B, di, ds)
        return out("model" if _div(shape[1], mesh, model) else None, None)
    if key == "conv":                                  # (B, dk-1, di)
        return out(None, "model" if _div(shape[2], mesh, model) else None)
    if key == "C":                                     # mlstm (B, nh, dqk, dv)
        return out(None, None, "model" if _div(shape[3], mesh, model) else None)
    if key == "n" and nd == 3:
        return out(None, None)
    # scalars and the rest (length, pos, m, win_pos, the sLSTM's h/c/n/m)
    return out(*([None] * (nd - 1)))


def model_block(spec: Spec, t: torch.Tensor, m: int, j: int) -> torch.Tensor:
    """Model shard j's block of ``t`` (one of ``m``) along the dim ``spec``
    splits over "model" (a ``decode_state_spec``); raises where none does."""
    dims = [d for d, axes in enumerate(spec) if "model" in axes]
    if len(dims) != 1:
        raise ValueError(f"spec {spec} splits no single dim over 'model'")
    n = t.shape[dims[0]] // m
    return t.narrow(dims[0], j * n, n)


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
