"""Model assembly for decoder stacks of attention, Mamba or xLSTM mixers
with dense, MoE or no FFNs, encoder-decoder stacks and a frontend prefix
(reference ``repro/models/model.py``), with the serving entry points:

  init_params(cfg, seed, device, dtype)            -> params
  params_from_jax(cfg, np_params, device, dtype)    -> params
  params_to_numpy(cfg, params)                      -> the reference's numpy pytree
  forward_train(cfg, params, batch, mesh, remat)    -> (loss, {"ce", "aux", "tokens"})
  prefill(cfg, fkv, params, batch, max_len)         -> (logits_last, state[, kv])
  prefill_extend(cfg, fkv, params, batch, kv, prefix_len, max_len)
                                                    -> (logits_last, state)
  serve_step(cfg, fkv, params, state, tokens)       -> (logits, state[, stats])
  serve_step_sampled(cfg, fkv, params, state, loop, sampler)
  decode_window(cfg, fkv, params, state, loop, sampler, n_steps)
  serve_step_verify(cfg, fkv, params, state, tokens)  -> (logits (B, S, V), ...)
  serve_step_spec(cfg, fkv, params, state, loop, sampler)
  decode_window_spec(cfg, fkv, params, state, loop, sampler, n_max)

Every serving entry point also takes ``mesh``. Serving TP's
(``launch/mesh.make_tp_mesh``): each attention layer's retrieval runs per
KV-head group on its shard's device (``core/sharded_retrieval``) and the
backbone runs once, on the params' device. A ("data", "model") compute mesh
(``launch/mesh.make_host_mesh``) with params placed by ``sharding/rules
.place_serving_params``: the backbone of each data group on its model
shards, forward only (the section "serving under a compute mesh" below).
``forward_train`` takes a compute mesh and params placed on it
(``rules.shard_params``): model-parallel training. Under a compute mesh
Mamba splits d_inner and the mLSTM its heads over a data group's model
shards, the sLSTM runs whole on the group's shard 0, and an
encoder-decoder's encoder and cross-attention split by KV-head group
(``_recurrent_forward``, ``_encode``, ``_cross_mp``), in training and in
serving.

Params are nested dicts of tensors, dense weights in the ``x @ W``
orientation ``(d_in, d_out)``: ``{"embed": {"tok", "head"?}, "final_norm":
{"w"}, "layers": [{"norm1", "mixer", "norm2", "ffn", "postnorm1"?,
"postnorm2"?}, ...]}`` with one entry per layer in ``cfg.layers`` order
(the post-block norms under ``cfg.post_block_norm``, gemma2). A layer's
``mixer`` is ``{wq, wk, wv, wo}`` for attention or, for ``MAMBA``,
``{in_proj, conv_w, conv_b, x_proj, dt_w, dt_b, A_log, D, out_proj}``
(``models/ssm``), for ``MLSTM`` ``{up, wq, wk, wv, wi, wf, bf, down}`` and
for ``SLSTM`` ``{up, W, R, b, down}`` (``models/xlstm``); its ``ffn`` is
``{up, gate, down}`` for ``DENSE`` or, for ``MOE``, ``{router (d, E), wg,
wu (E, d, de), wd (E, de, d), shared?: {up, gate, down}}`` (``models/moe``);
an xLSTM block (``NONE``) has no ``norm2`` and ``ffn``. ``router``,
``A_log`` and ``D``, and the xLSTM gates' ``wi``, ``wf``, ``bf``, ``W``,
``R`` and ``b``, are float32 whatever the other leaves' dtype
(``FLOAT32_KEYS``, ``XLSTM_FLOAT32_KEYS``), as in the reference.

An encoder-decoder config (whisper) adds ``params["encoder"] = {"layers":
[...], "final_norm"}``, ``n_encoder_layers`` attention + dense layers run
bidirectionally over the request's frontend frames (``_encode``), and each
decoder layer a cross-attention sublayer ``{"xnorm", "xattn": {wq, wk, wv,
wo}}`` after its self-attention: queries not RoPE'd over the encoder
output's K/V (``_enc_kv``, not RoPE'd either), which the decode state keeps
beside the retriever's leaves as ``xk``/``xv`` (B, F, kv, d_head). A
frontend config that is no encoder-decoder (internvl2) puts the request's
patch embeddings ahead of the prompt's (``_embed_inputs``); positions run
over the whole prefix and prompt.

Layers are global attention (``ATTN``, the retriever of ``fkv.method``),
sliding-window attention (``ATTN_LOCAL``, gemma2: a ``StreamingRetriever``
over the last ``cfg.sliding_window`` tokens, no sink, and the window in the
prefill's attention), as the reference's ``_retrievers``, or Mamba
(``MAMBA``, jamba: no retriever; its decode state is ``{"h", "conv"}``), or
xLSTM (``MLSTM``/``SLSTM``, xlstm-350m: no retriever; ``{"C", "n", "m"}``
and ``{"h", "c", "n", "m"}``, float32). Each decode layer hands its query
to the next attention layer's retriever as ``q_proxy`` (zeros for the
first), InfiniGen's proxy query; a recurrent layer passes it on
unchanged; only global layers count in the decode statistics. The FFN of every path (``prefill``, ``prefill_extend``,
``serve_step``) goes through ``_ffn``, which runs ``moe.apply_moe`` over the
call's flattened (B * T, d) tokens for a ``MOE`` layer.
The reference's ``lax.scan`` over stacked periods becomes a Python loop over
layers; the decode state is ``{"layers": [per-layer state], "pos": (B,)
int32 on the device, "pos_host": (B,) int32 on the CPU}`` (and, under
speculative decoding, ``"draft_tab"`` (B, vocab) int32, ``core/drafter``)
and ``serve_step`` updates it in place (the port's counterpart of buffer donation). Only the
centroid index's upkeep reads ``pos_host`` (``centroid_index
.update_on_append``); the paging reads the lengths on the card.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import (ATTN, ATTN_LOCAL, DENSE, MAMBA, MLSTM, MOE, NONE,
                                      SLSTM, ArchConfig, FreeKVConfig)
from repro_torch.core.retrieval import (SHARDED_PATHS, StreamingRetriever, make_retriever,
                                        use_sharded)
from repro_torch.core.sharded_retrieval import (PageShardedRetriever, TPGroupShardedRetriever,
                                                tp_group_size)
from repro_torch.launch.mesh import TPMesh, is_compute_mesh
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe, ssm, xlstm
from repro_torch.sharding import rules, transfer
from repro_torch.sharding.transfer import MeshRow

# per-step retrieval statistics the engine aggregates (reference model.py:774)
DECODE_STAT_KEYS = ("corrected", "kv_heads", "sync_pages", "async_pages",
                    "reused_pages", "sim_sum", "sim_cnt", "sel_pages",
                    "spec_hit_pages", "churn_pages")
# and, under serving TP, each KV-head-group shard's own transfer counts,
# each (tp, B) (``core/sharded_retrieval``)
SHARD_STAT_KEYS = ("shard_sync_pages", "shard_async_pages")


def stat_keys(mesh=None) -> tuple:
    """The keys of a decode step's stats: ``DECODE_STAT_KEYS``, each (B,),
    and under serving TP's mesh ``SHARD_STAT_KEYS``, each (tp, B)."""
    return DECODE_STAT_KEYS + (SHARD_STAT_KEYS if shard_stats(mesh) else ())


def shard_stats(mesh) -> bool:
    """Whether a step's stats carry each KV-head-group shard's counts:
    under serving TP's ``TPMesh``, not under a compute mesh."""
    return mesh is not None and not is_compute_mesh(mesh)

# leaves the reference keeps float32 whatever the params' dtype: the MoE
# router (``moe_init``) and Mamba's ``A_log`` and ``D`` (``mamba_init``)
FLOAT32_KEYS = ("router", "A_log", "D")
# and, inside an xLSTM mixer, its gates' weights and biases (``mlstm_init``,
# ``slstm_init``; ``b`` is also a LayerNorm's bias, which takes the dtype)
XLSTM_FLOAT32_KEYS = ("wi", "wf", "bf", "W", "R", "b")
RECURRENT = (MAMBA, MLSTM, SLSTM)
# the decode state's cross-attention K/V of an encoder-decoder layer
CROSS_KEYS = ("xk", "xv")


def check_supported(cfg: ArchConfig):
    for mixer, ffn in cfg.layers:
        if mixer not in (ATTN, ATTN_LOCAL) + RECURRENT or ffn not in (DENSE, MOE, NONE):
            raise NotImplementedError(
                f"{cfg.name}: layer ({mixer}, {ffn}) is not a layer of the reference; the "
                "port serves attention, Mamba, mLSTM or sLSTM mixers with dense, MoE or no "
                "FFNs")
    if cfg.is_encoder_decoder and any(m not in (ATTN, ATTN_LOCAL) for m, _ in cfg.layers):
        raise NotImplementedError(f"{cfg.name}: an encoder-decoder's decoder layers attend "
                                  "(the cross-attention K/V ride an attention layer's state)")


def frontend_prefix(cfg: ArchConfig) -> int:
    """Frontend tokens ahead of each prompt in the decode state: a
    frontend config that is no encoder-decoder (internvl2's patches,
    ``_embed_inputs``); 0 otherwise (whisper's frames feed its encoder)."""
    return cfg.n_frontend_tokens if cfg.frontend and not cfg.is_encoder_decoder else 0


def supports_kv_extend(cfg: ArchConfig) -> bool:
    """Whether every token's context lives in K/V form, so a prompt can be
    extended over cached K/V (reference ``model.py:550``): attention-only
    stacks with no encoder-decoder cross state and no frontend prefix. A
    recurrent layer (Mamba, xLSTM) compresses its history into a state that
    cannot be sliced per token, so chunked prefill and the prefix cache turn
    off (``serving/engine``)."""
    return (not cfg.is_encoder_decoder and cfg.frontend is None
            and all(m in (ATTN, ATTN_LOCAL) for m, _ in cfg.layers))


def retrievers(cfg: ArchConfig, fkv: FreeKVConfig, mesh=None) -> list:
    """One retriever a layer (reference ``model.py:98-115``): ``ATTN`` ->
    ``make_retriever``, ``ATTN_LOCAL`` -> the sliding window with no sink,
    a recurrent mixer -> None. Layers of one kind share one object. Under
    serving TP (``mesh``) both attention kinds run per KV-head group, the
    sliding window too. A compute mesh's retrievers are per data group
    and layout (``_retriever_table``, ``_spec_units``), not asked for
    here."""
    by_kind = {ATTN: make_retriever(cfg, fkv, mesh), MAMBA: None, MLSTM: None, SLSTM: None}
    if any(m == ATTN_LOCAL for m, _ in cfg.layers):
        def local(c):
            return StreamingRetriever(c, fkv, window=cfg.sliding_window, n_sink=0)
        by_kind[ATTN_LOCAL] = (TPGroupShardedRetriever(cfg, mesh, local)
                               if mesh is not None else local(cfg))
    return [by_kind[m] for m, _ in cfg.layers]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _norm(cfg, d, dtype, dev):
    p = {"w": torch.ones((d,), dtype=dtype, device=dev)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros((d,), dtype=dtype, device=dev)
    return p


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda", dtype=torch.float32):
    """Random parameters from a seeded ``torch.Generator`` on ``device``:
    normal(0, 1/d_in) dense weights as in the reference's init (not the same
    numbers: those come from ``params_from_jax``); the MoE, Mamba and xLSTM
    layers from ``moe.moe_init``, ``ssm.mamba_init`` and ``xlstm``'s
    ``mlstm_init``/``slstm_init``, their float32 leaves float32; an
    encoder-decoder's cross-attention sublayers and encoder after."""
    check_supported(cfg)
    dev = resolve_device(device)
    # meta tensors hold no numbers: no generator to seed there
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)

    def draw(shape, std):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev).mul_(std)

    def normal(shape, std):
        return draw(shape, std).to(dtype)

    def dense(d_in, d_out):
        return normal((d_in, d_out), 1.0 / math.sqrt(d_in))

    d, dh, vp = cfg.d_model, cfg.d_head, cfg.padded_vocab()
    embed = {"tok": normal((vp, d), 1.0 / math.sqrt(d))}
    if not cfg.tie_embeddings:
        embed["head"] = dense(d, vp)
    def attn_mixer():
        return {"wq": dense(d, cfg.n_heads * dh), "wk": dense(d, cfg.n_kv_heads * dh),
                "wv": dense(d, cfg.n_kv_heads * dh), "wo": dense(cfg.n_heads * dh, d)}

    def layer(mixer, ffn, cross=False):
        lp = {"norm1": _norm(cfg, d, dtype, dev)}
        if ffn == MOE:
            lp["ffn"] = moe.moe_init(cfg, draw, dtype)
        elif ffn == DENSE:
            lp["ffn"] = {"up": dense(d, cfg.d_ff), "down": dense(cfg.d_ff, d)}
            if cfg.gated_mlp:
                lp["ffn"]["gate"] = dense(d, cfg.d_ff)
        if mixer == MAMBA:
            lp["mixer"] = ssm.mamba_init(cfg, draw, dtype)
        elif mixer == MLSTM:
            lp["mixer"] = xlstm.mlstm_init(cfg, draw, dtype)
        elif mixer == SLSTM:
            lp["mixer"] = xlstm.slstm_init(cfg, draw, dtype)
        else:
            lp["mixer"] = attn_mixer()
        if cross:
            lp["xnorm"] = _norm(cfg, d, dtype, dev)
            lp["xattn"] = attn_mixer()
        if ffn != NONE:
            lp["norm2"] = _norm(cfg, d, dtype, dev)
        if cfg.post_block_norm:
            lp["postnorm1"] = _norm(cfg, d, dtype, dev)
            lp["postnorm2"] = _norm(cfg, d, dtype, dev)
        return lp

    cross = cfg.is_encoder_decoder
    params = {"embed": embed, "layers": [layer(m, f, cross) for m, f in cfg.layers]}
    params["final_norm"] = _norm(cfg, d, dtype, dev)
    if cross:
        params["encoder"] = {"layers": [layer(ATTN, DENSE) for _ in range(cfg.n_encoder_layers)],
                             "final_norm": _norm(cfg, d, dtype, dev)}
    return params


def params_from_jax(cfg: ArchConfig, np_params, device="cuda", dtype=None):
    """The port's params from the reference's ``init_params`` pytree given as
    numpy arrays (``jax.tree.map(np.asarray, params)``).

    Stacked ``pattern`` leaves of shape (n_periods, ...) are split per layer
    in ``cfg.layers`` order; dense weights keep the ``x @ W`` orientation
    (d_in, d_out) — nothing is transposed. ``dtype`` None keeps each leaf's;
    the ``FLOAT32_KEYS`` leaves (the MoE router, Mamba's ``A_log`` and
    ``D``) and an xLSTM mixer's ``XLSTM_FLOAT32_KEYS`` stay float32 whatever
    ``dtype`` is. An encoder-decoder's stacked encoder layers are split
    likewise into ``params["encoder"]["layers"]``."""
    check_supported(cfg)
    dev = resolve_device(device)

    def conv(tree, key=None, parent=None):
        if isinstance(tree, dict):
            return {k: conv(v, k, key) for k, v in tree.items()}
        arr = np.asarray(tree)
        if arr.dtype.name == "bfloat16":          # ml_dtypes: exact via float32
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, copy=True))
        f32 = key in FLOAT32_KEYS or (parent == "mixer" and key in XLSTM_FLOAT32_KEYS)
        to = torch.float32 if f32 else (dtype or t.dtype)
        return t.to(device=dev, dtype=to)

    def index(tree, i):
        if isinstance(tree, dict):
            return {k: index(v, i) for k, v in tree.items()}
        return tree[i]

    layers = [conv(lp) for lp in np_params["prelude"]]
    for i in range(cfg.n_periods):
        for stacked in np_params["pattern"]:
            layers.append(conv(index(stacked, i)))
    out = {"embed": conv(np_params["embed"]), "final_norm": conv(np_params["final_norm"]),
           "layers": layers}
    if cfg.is_encoder_decoder:
        enc = np_params["encoder"]
        out["encoder"] = {"layers": [conv(index(enc["layers"], i))
                                     for i in range(cfg.n_encoder_layers)],
                          "final_norm": conv(enc["final_norm"])}
    return out


def _numpy(t):
    """A leaf as a numpy copy on the host; bfloat16 as float32 (exact)."""
    t = t.detach()
    return t.to("cpu", torch.float32 if t.dtype == torch.bfloat16 else t.dtype,
                copy=True).numpy()


def params_to_numpy(cfg: ArchConfig, params):
    """The inverse of ``params_from_jax``: the port's per-layer params as the
    reference's pytree of numpy arrays, ``{"embed", "final_norm", "prelude":
    (layer, ...), "pattern": (stacked, ...)}`` with each pattern position's
    layers stacked along a leading (n_periods,) axis, and an
    encoder-decoder's ``{"encoder": {"layers": stacked, "final_norm"}}``.
    Leaves keep their dtype, bfloat16 ones come back as float32 (the
    reference's checkpoint restore casts to its own leaves' dtype). The
    optimizer's ``m`` and ``v`` have the params' structure and convert the
    same way."""
    def tree(t, fn):
        return {k: tree(v, fn) for k, v in t.items()} if isinstance(t, dict) else fn(t)

    def stack(lps):
        if isinstance(lps[0], dict):
            return {k: stack([lp[k] for lp in lps]) for k in lps[0]}
        return np.stack([_numpy(t) for t in lps])

    n_pre, n_pat = len(cfg.prelude), len(cfg.pattern)
    body = params["layers"][n_pre:]
    out = {"embed": tree(params["embed"], _numpy),
           "final_norm": tree(params["final_norm"], _numpy),
           "prelude": tuple(tree(lp, _numpy) for lp in params["layers"][:n_pre]),
           "pattern": tuple(stack(body[j::n_pat]) for j in range(n_pat))}
    if cfg.is_encoder_decoder:
        enc = params["encoder"]
        out["encoder"] = {"layers": stack(enc["layers"]),
                          "final_norm": tree(enc["final_norm"], _numpy)}
    return out


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------
def _train_layer(cfg, layer, lp, x, positions, enc, row=None, n_blocks=1):
    """One layer over the whole sequence for training (reference
    ``_apply_layer_seq``) -> (x, aux (B, T) or None). Attention is
    ``attention_auto`` on every device (the reference's jnp computation:
    dense up to 2048 x 2048 query-key pairs, chunked beyond), never the
    forward-only ``flash_prefill``; a recurrent mixer runs its forward over
    the sequence; an encoder-decoder layer adds its cross-attention over
    ``enc``, the encoder's output.

    Under ``row`` (one data group's model shards, ``sharding/transfer
    .MeshRow``) ``lp`` is placed and ``x`` lives on the row's shard 0: the
    attention is ``attn.attention_mp``, a recurrent mixer its model-parallel
    form or whole on shard 0 (``_recurrent_forward``), the cross-attention
    per KV-head group (``_cross_mp``), the FFN column/row- or
    expert-parallel (``_ffn_aux``), and the norms take their weights whole
    on shard 0."""
    h = L.apply_norm(cfg, _whole(row, lp["norm1"]), x)
    if layer[0] in RECURRENT:
        o = (_FORWARD[layer[0]](cfg, lp["mixer"], h) if row is None else
             _recurrent_forward(cfg, layer[0], lp["mixer"], h, row))
    elif row is not None:
        o = attn.attention_mp(cfg, lp["mixer"], h, _window(cfg, layer), row)
    else:
        q, k, v = attn.qkv_proj(cfg, lp["mixer"], h, positions)
        o = attn.attention_auto(cfg, q, k, v, positions, positions, causal=True,
                                window=_window(cfg, layer))
        o = attn.out_proj(cfg, lp["mixer"], o)
    x = _residual(cfg, lp, x, o, "1", row)
    if enc is not None:
        xks, xvs = _enc_kv_mp(cfg, lp, enc, row)
        x = _cross_mp(cfg, lp, x, positions, xks, xvs, row)
    return _ffn_aux(cfg, layer, lp, x, row, n_blocks)


def forward_train(cfg: ArchConfig, params, batch, mesh=None, remat=True):
    """The training loss (reference ``model.py:338``): batch ``{"tokens"
    (B, T) int, "loss_mask" (B, T) optional, "frontend" (B, F, d)
    optional}`` -> (loss, {"ce", "aux", "tokens"}), 0-dim tensors.

    ``ce`` is the mean next-token cross-entropy over the masked targets
    (float32 logsumexp over the padded vocabulary, whose padding
    ``L.lm_logits`` masks); a frontend prefix's positions (internvl2's
    patches) are left out of the logits. ``aux`` sums the MoE layers'
    load-balance terms as the reference does (each prelude layer's mean,
    plus the sum of each period's), and the loss is ``ce +
    cfg.router_aux_loss * aux``.

    ``remat`` recomputes each period of ``cfg.pattern`` in the backward
    (``torch.utils.checkpoint``, the counterpart of the reference's
    ``jax.checkpoint`` over its scan body): only a period's input is kept.
    The prelude layers and an encoder are not rematerialised, as in the
    reference.

    ``mesh`` (``launch/mesh.make_host_mesh``, n_data x m shards driven by
    one controller) takes params placed on it (``sharding/rules
    .shard_params``). The batch's rows are split over "data" as
    ``rules.batch_shardings`` splits them, where B divides (else every
    layer runs the whole batch on data group 0, as it does when the MoE's
    experts do not divide the model axis and its replicated branch routes
    the whole batch in one call); group g's activations live on shard
    (g, 0) between sublayers, and each sublayer runs on the group's model
    shards (``sharding/transfer.MeshRow``): the vocab-parallel embedding,
    the attention's Megatron or input-dim-split layouts
    (``attn.attention_mp``), the column/row-parallel MLP, the
    expert-parallel MoE and the vocab-parallel logits and cross-entropy. A
    MoE call is one data block of the flat tokens (n_data blocks where
    B * T divides), so the loss depends on the data axis as the reference's
    does. Mamba splits d_inner and the mLSTM its heads over the model
    shards (the sLSTM runs whole on shard 0), and an encoder-decoder's
    encoder runs on each group's shards over the group's frames, its
    cross-attention split by KV-head group. Each period is rematerialised
    with its moves inside; the loss's terms and each layer's ``aux`` come
    back to shard (0, 0). A 1 x 1 mesh gives the loss and gradients of no
    mesh bit for bit."""
    check_supported(cfg)
    tokens = batch["tokens"]
    B = tokens.shape[0]
    if mesh is None:
        rows, groups, n_data = [None], [batch], 1
    else:
        n_data = mesh.shape["data"]
        n_groups = rules.axsize(mesh, rules.batch_shardings(cfg, mesh, batch)["tokens"][0])
        if any(f == MOE for _, f in cfg.layers) and cfg.n_experts % mesh.shape["model"]:
            n_groups = 1
        rows = [MeshRow(mesh, g) for g in range(n_groups)]
        b = B // n_groups
        batch = {k: v.to(mesh.primary) for k, v in batch.items()}
        groups = [{k: transfer.move(mesh, v if n_groups == 1 else v[g * b:(g + 1) * b],
                                    HOME, (g, 0), "data") for k, v in batch.items()}
                  for g in range(n_groups)]
    embedded = [_embed_inputs(cfg, params, grp, row) for grp, row in zip(groups, rows)]
    xs, poss = [x for x, _ in embedded], [pos for _, pos in embedded]
    T = xs[0].shape[1]
    n_front = T - tokens.shape[1]
    # the MoE's data blocks in each group's flat tokens
    n_blocks = n_data // len(rows) if (B * T) % n_data == 0 else 1
    encs = ([_encode(cfg, params, grp["frontend"], train=True, row=row)
             for grp, row in zip(groups, rows)] if cfg.is_encoder_decoder else [None] * len(rows))
    layers = params["layers"]
    n_pre, n_pat = len(cfg.prelude), len(cfg.pattern)
    home = xs[0].device
    aux_total = torch.zeros((), dtype=torch.float32, device=home)

    def layer_step(layer, lp, xs):
        """One layer over every data group -> (xs, aux's mean on (0, 0) or None)."""
        outs = [_train_layer(cfg, layer, lp, x, pos, enc, row, n_blocks)
                for x, pos, enc, row in zip(xs, poss, encs, rows)]
        aux = None if outs[0][1] is None else _to_home(rows, [a for _, a in outs]).mean()
        return [x for x, _ in outs], aux

    for i in range(n_pre):
        xs, aux = layer_step(cfg.layers[i], layers[i], xs)
        if aux is not None:
            aux_total = aux_total + aux

    def period(xs, i0):
        aux_p = torch.zeros((), dtype=torch.float32, device=home)
        for j in range(n_pat):
            xs, aux = layer_step(cfg.pattern[j], layers[i0 + j], xs)
            if aux is not None:
                aux_p = aux_p + aux
        return xs, aux_p

    aux_periods = []
    for i0 in range(n_pre, cfg.n_layers, n_pat):
        if remat and torch.is_grad_enabled():
            xs, aux_p = checkpoint(period, xs, i0, use_reentrant=False)
        else:
            xs, aux_p = period(xs, i0)
        aux_periods.append(aux_p)
    aux_total = aux_total + torch.stack(aux_periods).sum()

    sums, counts = [], []
    for x, grp, row in zip(xs, groups, rows):
        x = L.apply_norm(cfg, _whole(row, params["final_norm"]), x)
        logits = L.lm_logits(cfg, params["embed"], x[:, n_front:], row=row)
        logits = [logits] if row is None else logits
        tok = grp["tokens"]
        per_tok = _cross_entropy([lg[:, :-1] for lg in logits], tok[:, 1:].long(), row)
        mask = grp.get("loss_mask")
        mask = (torch.ones_like(tok) if mask is None else mask)[:, 1:]
        at = HOME if row is None else (row.g, 0)
        sums.append(transfer.move(mesh, (per_tok * mask).sum(), at, HOME, "data"))
        counts.append(transfer.move(mesh, mask.sum(), at, HOME, "data"))
    n_tok = _sum(counts)
    ce = _sum(sums) / torch.clamp(n_tok, min=1)
    loss = ce + cfg.router_aux_loss * aux_total
    return loss, {"ce": ce, "aux": aux_total, "tokens": n_tok}


def _cross_entropy(logits, tgt, row=None):
    """Per-token cross-entropy (B, T) float32 (reference ``_cross_entropy``)
    from the list of ``L.lm_logits``' vocab blocks: one block (no mesh, or
    a head that is not vocab-parallel) gives logsumexp of the float32
    logits minus the target's. Several blocks, block j on shard j of
    ``row``, give the vocab-parallel form: the max over the shards of the
    detached logits (the shift cancels in the gradient), the shards' sums of
    exponentials added, and the target's logit taken from the shard whose
    block holds it; the result on shard 0."""
    if len(logits) == 1:
        lg = logits[0].float()
        return torch.logsumexp(lg, dim=-1) - lg.gather(-1, tgt[..., None])[..., 0]
    n = logits[0].shape[-1]
    lgs = [lg.float() for lg in logits]
    mx = row.reduce([lg.detach().amax(dim=-1) for lg in lgs], "vocab", op=torch.maximum)
    mxs = row.broadcast(mx, "vocab")
    s = row.reduce([torch.exp(lg - mxs[j][..., None]).sum(dim=-1) for j, lg in enumerate(lgs)],
                   "vocab")
    tgts = row.broadcast(tgt, "vocab")
    lls = []
    for j, lg in enumerate(lgs):
        rel = tgts[j] - j * n
        hit = (rel >= 0) & (rel < n)
        ll = lg.gather(-1, rel.clamp(0, n - 1)[..., None])[..., 0]
        lls.append(torch.where(hit, ll, torch.zeros((), dtype=ll.dtype, device=ll.device)))
    return mx + torch.log(s) - row.reduce(lls, "vocab")


# ---------------------------------------------------------------------------
# training under a ("data", "model") mesh
# ---------------------------------------------------------------------------
HOME = (0, 0)                  # the shard that holds the batch, the loss and aux


def _sum(ts):
    out = ts[0]
    for t in ts[1:]:
        out = out + t
    return out


def _to_home(rows, ts):
    """Per-group tensors (group g's on shard (g, 0)) joined along the batch
    on shard (0, 0); with no mesh the one tensor as it is."""
    if rows[0] is None:
        return ts[0]
    ts = [transfer.move(row.mesh, t, (row.g, 0), HOME, "data") for row, t in zip(rows, ts)]
    return ts[0] if len(ts) == 1 else torch.cat(ts)


def _whole(row, tree):
    """A subtree of params as plain tensors: itself with no mesh, else whole
    on the row's shard 0."""
    return tree if row is None else row.whole(tree)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------
def _residual(cfg, lp, x, out, which, row=None):
    """x + out, the block output normed first under ``cfg.post_block_norm``
    (reference ``model.py:132-135``); under ``row`` the norm's weight is
    fetched whole to the row's shard 0."""
    if cfg.post_block_norm:
        out = L.apply_norm(cfg, _whole(row, lp["postnorm" + which]), out)
    return x + out


def _ffn_aux(cfg, layer, lp, x, row=None, n_blocks=1):
    """The FFN sublayer of every path -> (x, aux): a ``MOE`` layer routes the
    call's flattened (B * T, d) tokens together (reference ``_apply_ffn``),
    so its capacity couples the call's rows, and returns its load-balance
    term (B, T) float32 as ``aux``; a dense FFN and an xLSTM block (``NONE``,
    no FFN) return None, the reference's zeros. Under ``row`` (training
    under a mesh) the MLP is column/row-parallel and the MoE
    expert-parallel over ``n_blocks`` data blocks of the call's tokens."""
    if layer[1] == NONE:
        return x, None
    h = L.apply_norm(cfg, _whole(row, lp["norm2"]), x)
    aux = None
    if layer[1] == MOE:
        out, aux = (moe.apply_moe(cfg, lp["ffn"], h) if row is None else
                    moe.apply_moe(cfg, lp["ffn"], h, row=row, n_blocks=n_blocks))
    else:
        out = L.apply_mlp(cfg, lp["ffn"], h, row=row)
    return _residual(cfg, lp, x, out, "2", row), aux


def _ffn(cfg, layer, lp, x):
    """``_ffn_aux`` for the serving paths, which drop the load-balance term."""
    return _ffn_aux(cfg, layer, lp, x)[0]


def _window(cfg, layer):
    return cfg.sliding_window if layer[0] == ATTN_LOCAL else None


def _recurrent_state(cfg, mixer, batch, dtype, dev):
    """A recurrent mixer's empty state: Mamba's ``h`` float32 and ``conv``
    at ``dtype``; the xLSTM states float32 whatever ``dtype`` is."""
    if mixer == MAMBA:
        return ssm.mamba_init_state(cfg, batch, dtype, dev)
    if mixer == MLSTM:
        return xlstm.mlstm_init_state(cfg, batch, dev)
    return xlstm.slstm_init_state(cfg, batch, dev)


# a recurrent mixer's prompt pass (-> y and its final state with
# ``return_state=True``) and decode step (its state updated in place)
_FORWARD = {MAMBA: ssm.mamba_forward, MLSTM: xlstm.mlstm_forward, SLSTM: xlstm.slstm_forward}
_DECODE_STEP = {MAMBA: ssm.mamba_decode_step, MLSTM: xlstm.mlstm_decode_step,
                SLSTM: xlstm.slstm_decode_step}
# their model-parallel forms over a data group's model shards
_FORWARD_MP = {MAMBA: ssm.mamba_forward_mp, MLSTM: xlstm.mlstm_forward_mp}
_DECODE_STEP_MP = {MAMBA: ssm.mamba_decode_step_mp, MLSTM: xlstm.mlstm_decode_step_mp}
# a split mixer's state: each leaf's dim over the model shards (the
# reference's ``decode_state_spec`` for Mamba; by head for the mLSTM)
_STATE_SPLIT = {MAMBA: {"h": 1, "conv": 2}, MLSTM: {"C": 1, "n": 1, "m": 1}}


def recurrent_shards(cfg: ArchConfig, mixer, m: int) -> int:
    """The model shards that hold a recurrent layer's state in a data group
    of m: m where its model-parallel form splits it (Mamba's d_inner, the
    mLSTM's heads), else 1, the group's shard 0 (the sLSTM always: its
    ``R`` and state are replicated in the reference)."""
    split = ((mixer == MAMBA and ssm.mamba_splits(cfg, m))
             or (mixer == MLSTM and xlstm.mlstm_splits(cfg, m)))
    return m if split else 1


def _recurrent_forward(cfg, mixer, p, h, row, return_state=False):
    """A recurrent mixer over a sequence under ``row``: its model-parallel
    form where it splits, else whole on shard 0 -> y on shard 0 [, the
    state, one dict a shard that holds it (``recurrent_shards``)]."""
    if recurrent_shards(cfg, mixer, row.m) > 1:
        return _FORWARD_MP[mixer](cfg, p, h, row, return_state=return_state)
    out = _FORWARD[mixer](cfg, row.whole(p), h, return_state=return_state)
    return (out[0], [out[1]]) if return_state else out


def _recurrent_step(cfg, mixer, p, h, states, row):
    """A recurrent mixer's decode step under ``row``, ``states`` one dict a
    shard that holds it, updated in place -> y (B, 1, d) on shard 0."""
    if len(states) > 1:
        return _DECODE_STEP_MP[mixer](cfg, p, h, states, row)[0]
    return _DECODE_STEP[mixer](cfg, row.whole(p), h, states[0])[0]


def _recurrent_state_blocks(cfg, mixer, batch, dtype, row):
    """A recurrent layer's empty state in a data group: shard j's block on
    its device, one dict a shard that holds it."""
    n = recurrent_shards(cfg, mixer, row.m)
    whole = _recurrent_state(cfg, mixer, batch, dtype, row.device(0))
    if n == 1:
        return [whole]
    dims = _STATE_SPLIT[mixer]
    return [{k: t.chunk(n, dims[k])[j].contiguous().to(row.device(j)) for k, t in whole.items()}
            for j in range(n)]


def _layer_state(cfg, layer, r, batch, max_len, dtype, dev):
    if r is None:
        return _recurrent_state(cfg, layer[0], batch, dtype, dev)
    st = r.init_state(batch, max_len, dtype, dev)
    if cfg.is_encoder_decoder:
        shape = (batch, cfg.n_frontend_tokens, cfg.n_kv_heads, cfg.d_head)
        for key in CROSS_KEYS:
            st[key] = torch.zeros(shape, dtype=dtype, device=dev)
    return st


def init_decode_state(cfg: ArchConfig, fkv: FreeKVConfig, batch_size: int,
                      max_len: int, dtype=torch.bfloat16, device="cuda", mesh=None):
    """The empty decode state at batch ``batch_size`` (reference
    ``model.py:441-476``): each attention layer's retriever state (with the
    cross-attention ``xk``/``xv`` zeros at ``dtype`` under an
    encoder-decoder), each recurrent layer's (``_recurrent_state``). Under
    serving TP (``mesh``) an attention layer's retriever state is its
    shards' (``core/sharded_retrieval``), each on its shard's device;
    everything else, ``xk``/``xv`` included, stays with the backbone on
    ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    if is_compute_mesh(mesh):
        return _init_mesh_state(cfg, fkv, batch_size, max_len, dtype, dev, mesh)
    out = {"layers": [_layer_state(cfg, layer, r, batch_size, max_len, dtype, dev)
                      for layer, r in zip(cfg.layers, retrievers(cfg, fkv, mesh))],
           "pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
           "pos_host": torch.zeros((batch_size,), dtype=torch.int32)}
    if fkv.draft_len > 0:               # the speculative drafter's lane
        from repro_torch.core import drafter
        out["draft_tab"] = drafter.init_draft_tab(batch_size, cfg.vocab_size, dev)
    return out


@torch.no_grad()
def prefill(cfg: ArchConfig, fkv: FreeKVConfig, params, batch, max_len: int,
            state_dtype=torch.bfloat16, into=None, return_kv=False, build_state=True,
            mesh=None, group=None):
    """batch {"tokens": (B, T) on the params' device} -> (last-position
    logits (B, padded_vocab), decode state). Each layer's retriever state is
    built right after the layer runs, so only one layer's K/V is alive.

    ``into`` (optional) is one empty state per layer to build into instead
    of fresh ones: the continuous scheduler passes the rows of a slot
    (``SlotPool.claim``), so the pool pages land in the slot's pinned rows
    and no admission copies them. Leaves the retriever replaces come back
    as new tensors, for ``SlotPool.insert`` to copy in.

    ``return_kv`` also returns every layer's post-RoPE K/V, a list with one
    ``(k, v)`` pair of (B, T, kv, dh) a layer (the reference's
    ``{"prelude", "pattern"}`` tree in the port's per-layer form), for the
    prefix cache and chunked prefill. ``build_state=False`` skips the
    retriever state and returns ``state=None``: a chunked prefill's opening
    chunk, whose state the final chunk rebuilds from the whole prompt's K/V
    (and which may be shorter than the sink and the window ring).

    A recurrent layer (Mamba, xLSTM) runs over the whole prompt and keeps
    its final state (new tensors, which ``SlotPool.insert`` copies into the
    slot); its ``kv`` entry is None.

    ``batch["frontend"]`` (B, F, d), a frontend config's stub embeddings:
    an encoder-decoder's encoder runs over them (``_encode``) and every
    decoder layer's cross-attention attends to its output, whose K/V the
    state keeps as ``xk``/``xv`` at ``state_dtype``; otherwise they sit
    ahead of the prompt (``_embed_inputs``) and the state's length counts
    them.

    ``mesh``: serving TP (``core/sharded_retrieval``). The backbone runs
    once, on the params' device; each attention layer's retriever state is
    built per KV-head group on its shard's device. A ("data", "model")
    compute mesh takes params placed by ``sharding/rules
    .place_serving_params`` and runs ``_prefill_mesh`` (``group``: the data
    group that runs a batch, a slot's; None splits the rows over "data"
    where they divide)."""
    check_supported(cfg)
    if is_compute_mesh(mesh):
        return _prefill_mesh(cfg, fkv, params, batch, max_len, state_dtype, into, return_kv,
                             build_state, mesh, group)
    x, positions = _embed_inputs(cfg, params, batch)
    B, T = x.shape[:2]
    dev = x.device
    enc = _encode(cfg, params, batch["frontend"]) if cfg.is_encoder_decoder else None
    retrs = retrievers(cfg, fkv, mesh)
    states, kvs = [], []
    for i, lp in enumerate(params["layers"]):
        layer = cfg.layers[i]
        h = L.apply_norm(cfg, lp["norm1"], x)
        if layer[0] in RECURRENT:
            o, st = _FORWARD[layer[0]](cfg, lp["mixer"], h, return_state=True)
            x = _ffn(cfg, layer, lp, _residual(cfg, lp, x, o, "1"))
            if build_state:
                states.append(st)
            if return_kv:
                kvs.append(None)
            continue
        q, k, v = attn.qkv_proj(cfg, lp["mixer"], h, positions)
        o = attn.attention_prefill(cfg, q, k, v, positions, positions,
                                   window=_window(cfg, layer))
        x = _residual(cfg, lp, x, attn.out_proj(cfg, lp["mixer"], o), "1")
        if enc is not None:
            xk, xv = _enc_kv(cfg, lp, enc)
            x = _cross(cfg, lp, x, positions, xk, xv)
        x = _ffn(cfg, layer, lp, x)
        if build_state:
            r = retrs[i]
            st = into[i] if into is not None else r.init_state(B, max_len, state_dtype, dev)
            # the retriever never sees the cross-attention leaves (reference
            # ``model.py:657-661``); a slot's rows take them in place
            rows = {key: st.pop(key) for key in CROSS_KEYS if key in st}
            st = r.prefill(st, k, v, q[:, -1].contiguous())
            if enc is not None:
                for key, t in zip(CROSS_KEYS, (xk, xv)):
                    st[key] = rows[key].copy_(t) if key in rows else t.to(state_dtype)
            states.append(st)
        if return_kv:
            kvs.append((k, v))
        del q, k, v, o, h
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.lm_logits(cfg, params["embed"], x[:, -1])
    state = _new_state(states, B, T, dev) if build_state else None
    if return_kv:
        return logits, state, kvs
    return logits, state


def _embed_inputs(cfg: ArchConfig, params, batch, row=None):
    """The prompt's embeddings and positions (reference ``model.py:321``):
    a frontend config that is no encoder-decoder (internvl2) puts
    ``batch["frontend"]`` (B, F, d), cast to the embeddings' dtype, ahead
    of the tokens' (B, T, d); positions run over the whole F + T. Under
    ``row`` the embedding is vocab-parallel (``L.embed_tokens``)."""
    x = L.embed_tokens(cfg, params["embed"], batch["tokens"], row=row)
    if frontend_prefix(cfg) and "frontend" in batch:
        x = torch.cat([batch["frontend"].to(x.dtype), x], dim=1)
    B, T = x.shape[:2]
    return x, torch.arange(T, device=x.device)[None].expand(B, T)


def _encode(cfg: ArchConfig, params, frontend, train=False, row=None):
    """The encoder (reference ``model.py:293``): RoPE'd bidirectional
    self-attention over the frontend's F frames at positions 0..F-1
    (``attention_prefill``, i.e. ``flash_prefill(causal=False)`` on the
    card, when serving; ``attention_auto`` in training, as the reference), a
    dense FFN, the encoder's final norm -> (B, F, d).

    Under ``row`` (one data group's model shards, ``params`` placed, the
    frames on shard 0) each layer's attention runs on the shards by KV-head
    group, each shard's heads bidirectional (``attn.attention_mp_prefill``
    serving, ``attn.attention_mp`` training), or by the input-dim split with
    query rows over the shards where the heads do not divide; the FFN is
    column/row-parallel; the output lives on shard 0.

    The frames are cast to the weights' dtype. The reference runs its
    encoder at the frames' dtype (float32 from the engine), promoting bf16
    weights; at float32 weights the two are the same computation."""
    enc = params["encoder"]
    x = frontend.to(params["embed"]["tok"].dtype)
    B, F_ = x.shape[:2]
    pos = torch.arange(F_, device=x.device)[None].expand(B, F_)
    for lp in enc["layers"]:
        h = L.apply_norm(cfg, _whole(row, lp["norm1"]), x)
        if row is not None:
            x = x + (attn.attention_mp(cfg, lp["mixer"], h, None, row, causal=False) if train
                     else attn.attention_mp_prefill(cfg, lp["mixer"], h, 0, None, row,
                                                    causal=False)[0])
        else:
            attention = attn.attention_auto if train else attn.attention_prefill
            q, k, v = attn.qkv_proj(cfg, lp["mixer"], h, pos)
            o = attention(cfg, q, k, v, pos, pos, causal=False)
            x = x + attn.out_proj(cfg, lp["mixer"], o)
            del q, k, v, o
        x = _ffn_aux(cfg, (ATTN, DENSE), lp, x, row)[0]
        del h
    return L.apply_norm(cfg, _whole(row, enc["final_norm"]), x)


def _enc_kv(cfg: ArchConfig, lp, enc):
    """One decoder layer's cross-attention K/V (B, F, kv, d_head) from the
    encoder's output, not RoPE'd (reference ``model.py:310``)."""
    B, F_ = enc.shape[:2]
    shape = (B, F_, cfg.n_kv_heads, cfg.d_head)
    return (enc @ lp["xattn"]["wk"]).reshape(shape), (enc @ lp["xattn"]["wv"]).reshape(shape)


def _cross_layer(row, lp):
    """The cross-attention sublayer's weights whole on the row's shard 0."""
    return {key: _whole(row, lp[key]) for key in ("xnorm", "xattn")}


def _enc_kv_mp(cfg: ArchConfig, lp, enc, row):
    """``_enc_kv`` under ``row`` (``enc`` on shard 0) -> (xks, xvs), one
    entry a shard that holds them: by KV-head group where the model axis
    divides both head counts (shard j's heads projected on shard j by its
    column blocks of wk/wv, the reference's ``decode_state_spec`` for
    ``xk``/``xv``), else whole on shard 0 by the input-dim split. With no
    mesh or one model shard, the whole K/V."""
    if row is None or row.m == 1:
        xk, xv = _enc_kv(cfg, _cross_layer(row, lp), enc)
        return [xk], [xv]
    p = lp["xattn"]
    B, F_ = enc.shape[:2]
    if attn.heads_divide(cfg, row.m):
        kvl = cfg.n_kv_heads // row.m
        encs = row.broadcast(enc, "partial_sum")
        return tuple([(encs[j] @ row.fetch(p[key], j, dim=1)).reshape(B, F_, kvl, cfg.d_head)
                      for j in range(row.m)] for key in ("wk", "wv"))
    xk, xv = attn.proj_split([p["wk"], p["wv"]], enc, row)
    shape = (B, F_, cfg.n_kv_heads, cfg.d_head)
    return [xk.reshape(shape)], [xv.reshape(shape)]


def _cross_mp(cfg: ArchConfig, lp, x, pos, xks, xvs, row):
    """``_cross`` under ``row`` over ``_enc_kv_mp``'s K/V, x on shard 0:
    each KV-head group's queries on its shard (column blocks of wq), its
    output through its row block of wo, the partial sums reduced on shard
    0; or, with the K/V whole on shard 0, the input-dim split of wq and wo
    around the attention there. With no mesh or one model shard, ``_cross``
    itself."""
    if row is None or row.m == 1:
        return _cross(cfg, _cross_layer(row, lp), x, pos, xks[0], xvs[0])
    p = lp["xattn"]
    h = L.apply_norm(cfg, row.whole(lp["xnorm"]), x)
    B, T = h.shape[:2]
    F_ = xks[0].shape[1]
    if len(xks) == 1:
        (q,) = attn.proj_split([p["wq"]], h, row)
        q = q.reshape(B, T, cfg.n_heads, cfg.d_head)
        epos = torch.arange(F_, device=h.device)[None].expand(B, F_)
        o = attn.attention_dense(cfg, q, xks[0], xvs[0], pos, epos, causal=False)
        return x + attn.out_split(cfg, p, [(0, o)], row)
    local = attn.local_cfg(cfg, row.m)
    hs = row.broadcast(h, "partial_sum")
    parts = []
    for j in range(row.m):
        dev = row.device(j)
        q = (hs[j] @ row.fetch(p["wq"], j, dim=1)).reshape(B, T, local.n_heads, cfg.d_head)
        epos = torch.arange(F_, device=dev)[None].expand(B, F_)
        # a bidirectional mask reads only the keys' positions
        qpos = torch.zeros((B, T), dtype=torch.long, device=dev)
        o = attn.attention_dense(local, q, xks[j], xvs[j], qpos, epos, causal=False)
        parts.append(attn.out_proj(local, {"wo": row.fetch(p["wo"], j, dim=0)}, o))
    return x + row.reduce(parts, "partial_sum")


def _cross(cfg: ArchConfig, lp, x, pos, xk, xv):
    """x + the cross-attention sublayer (reference ``model.py:279-285`` and
    ``:672-679``): queries at ``pos`` (B, T), not RoPE'd, over every one of
    the encoder's F keys. Torch ops, as the reference's plain jnp."""
    h = L.apply_norm(cfg, lp["xnorm"], x)
    B, T = h.shape[:2]
    q = (h @ lp["xattn"]["wq"]).reshape(B, T, cfg.n_heads, cfg.d_head)
    F_ = xk.shape[1]
    epos = torch.arange(F_, device=x.device)[None].expand(B, F_)
    o = attn.attention_dense(cfg, q, xk, xv, pos, epos, causal=False)
    return x + attn.out_proj(cfg, lp["xattn"], o)


def _new_state(states, B, length, dev):
    return {"layers": states,
            "pos": torch.full((B,), length, dtype=torch.int32, device=dev),
            "pos_host": torch.full((B,), length, dtype=torch.int32)}


# ---------------------------------------------------------------------------
# prefill extension: a prompt suffix over its prefix's K/V
# ---------------------------------------------------------------------------
@torch.no_grad()
def prefill_extend(cfg: ArchConfig, fkv: FreeKVConfig, params, batch, kv, prefix_len: int,
                   max_len: int, state_dtype=torch.bfloat16, build_state=True, into=None,
                   mesh=None, group=None):
    """Prefill ``batch["tokens"]`` (B, S) as the continuation of a prefix of
    Tp = ``prefix_len`` tokens (reference ``model.py:578``). ``kv`` holds
    the per-layer post-RoPE K/V, a list with one ``(k, v)`` pair a layer:
    buffers (B, >= Tp + S, kv, dh) whose first Tp tokens hold the prefix's.
    The suffix's K/V is written into them in place, so a chunked prefill
    never concatenates its growing K/V again (the reference concatenates;
    the result is the same).

    Only the suffix is embedded; each layer's queries at Tp..Tp+S-1 attend
    over the buffers' first Tp + S tokens (``attention.attention_prefill``),
    and the retriever state is rebuilt from the whole Tp + S tokens through
    the same ``retr.prefill`` as a whole prompt's (``fill_pages`` on the
    card), straight into ``into`` when given (a slot's rows, as
    ``prefill``). ``build_state=False`` skips it and returns ``state=None``
    (a chunked prefill's intermediate chunks).

    Returns (logits, state); the suffix's K/V is left in ``kv``. Only
    for ``supports_kv_extend`` stacks (no recurrent layer, encoder or
    frontend prefix). ``mesh`` and ``group`` as ``prefill``'s; under a
    compute mesh the buffers live on the group's model shard 0."""
    check_supported(cfg)
    if not supports_kv_extend(cfg):
        raise NotImplementedError(f"{cfg.name}: a recurrent state, a cross-attention state or "
                                  "a frontend prefix cannot be extended over cached K/V "
                                  "(supports_kv_extend)")
    if is_compute_mesh(mesh):
        return _prefill_mesh(cfg, fkv, params, batch, max_len, state_dtype, into, False,
                             build_state, mesh, group, kv=kv, prefix_len=prefix_len)
    tokens = batch["tokens"]
    x = L.embed_tokens(cfg, params["embed"], tokens)
    B, S = tokens.shape
    dev = x.device
    Tp = int(prefix_len)
    q_pos = torch.arange(Tp, Tp + S, device=dev)[None].expand(B, S)
    kv_pos = torch.arange(Tp + S, device=dev)[None].expand(B, Tp + S)
    retrs = retrievers(cfg, fkv, mesh)
    states = []
    for i, lp in enumerate(params["layers"]):
        h = L.apply_norm(cfg, lp["norm1"], x)
        q, k, v = attn.qkv_proj(cfg, lp["mixer"], h, q_pos)
        k_full, v_full = kv[i][0][:, :Tp + S], kv[i][1][:, :Tp + S]
        k_full[:, Tp:].copy_(k)
        v_full[:, Tp:].copy_(v)
        o = attn.attention_prefill(cfg, q, k_full, v_full, q_pos, kv_pos,
                                   window=_window(cfg, cfg.layers[i]))
        x = _residual(cfg, lp, x, attn.out_proj(cfg, lp["mixer"], o), "1")
        x = _ffn(cfg, cfg.layers[i], lp, x)
        if build_state:
            r = retrs[i]
            st = into[i] if into is not None else r.init_state(B, max_len, state_dtype, dev)
            states.append(r.prefill(st, k_full, v_full, q[:, -1].contiguous()))
        del q, k, v, o, h, k_full, v_full
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.lm_logits(cfg, params["embed"], x[:, -1])
    state = _new_state(states, B, Tp + S, dev) if build_state else None
    return logits, state


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def _info_stats(info, B, dev):
    f = torch.float32
    z = torch.zeros((B,), dtype=torch.int64, device=dev)
    return {"corrected": info["corrected"].sum(dim=1).to(f),
            "kv_heads": torch.full((B,), info["corrected"].shape[1], dtype=f, device=dev),
            "sync_pages": info["sync_pages"].to(f),
            "async_pages": info["async_pages"].to(f),
            "reused_pages": info.get("reused_pages", z).to(f),
            "sim_sum": info["similarity"].sum(dim=1).to(f),
            "sim_cnt": torch.full((B,), info["similarity"].shape[1], dtype=f, device=dev),
            "sel_pages": info.get("sel_pages", z).to(f),
            "spec_hit_pages": info.get("spec_hit_pages", z).to(f),
            "churn_pages": info.get("churn_pages", z).to(f),
            **{k: info[k].to(f) for k in SHARD_STAT_KEYS if k in info}}


@torch.no_grad()
def serve_step(cfg: ArchConfig, fkv: FreeKVConfig, params, state, tokens,
               collect_stats=False, mesh=None):
    """tokens (B, 1) -> (logits (B, padded_vocab), state[, stats]). One decode
    step through every layer; ``state`` is updated in place and returned.
    Each layer's retriever gets the previous attention layer's query as
    ``q_proxy`` (zeros for the first, reference ``model.py:647-664``; None
    for every method but InfiniGen, the one that reads it); a recurrent
    layer steps its state in place (``ssm.mamba_decode_step``,
    ``xlstm.mlstm_decode_step``/``slstm_decode_step``) and passes
    ``q_proxy`` on unchanged; an encoder-decoder layer's cross-attention
    follows its self-attention, over the state's ``xk``/``xv``; ``stats``
    sum the global (``ATTN``) layers' info only. Under serving TP
    (``mesh``) the backbone runs once, on the primary device, each
    attention layer's retrieval step runs per KV-head group
    (``core/sharded_retrieval``), its attention output gathered back, and
    ``stats`` also hold each shard's transfer counts (``stat_keys``). A
    compute mesh runs ``_serve_step_mesh``."""
    if is_compute_mesh(mesh):
        return _serve_step_mesh(cfg, fkv, params, state, tokens, collect_stats, mesh)
    x = L.embed_tokens(cfg, params["embed"], tokens)
    B = x.shape[0]
    dev = x.device
    pos = state["pos"]
    pos_host = state["pos_host"]
    retrs = retrievers(cfg, fkv, mesh)
    # only InfiniGen reads q_proxy; it selects from zeros at the first layer
    q_proxy = (torch.zeros((B, cfg.n_heads, cfg.d_head), dtype=x.dtype, device=dev)
               if fkv.method == "infinigen" else None)
    stats = {k: torch.zeros((B,) if k in DECODE_STAT_KEYS else (tp_group_size(mesh), B),
                            dtype=torch.float32, device=dev) for k in stat_keys(mesh)}
    for i, lp in enumerate(params["layers"]):
        layer = cfg.layers[i]
        h = L.apply_norm(cfg, lp["norm1"], x)
        if layer[0] in RECURRENT:
            o, _ = _DECODE_STEP[layer[0]](cfg, lp["mixer"], h, state["layers"][i])
            x = _ffn(cfg, layer, lp, _residual(cfg, lp, x, o, "1"))
            continue
        q, k, v = attn.qkv_proj(cfg, lp["mixer"], h, pos[:, None])
        q = q[:, 0].contiguous()
        st = state["layers"][i]
        cross = {key: st[key] for key in CROSS_KEYS if key in st}
        if cross:      # the retriever never sees them (reference model.py:657-661)
            st = {key: t for key, t in st.items() if key not in CROSS_KEYS}
        o, st, info = retrs[i].decode(st, q, k[:, 0], v[:, 0],
                                      length_host=pos_host, q_proxy=q_proxy)
        q_proxy = q
        st.update(cross)
        state["layers"][i] = st
        x = _residual(cfg, lp, x, attn.out_proj(cfg, lp["mixer"], o[:, None]), "1")
        if cross:
            x = _cross(cfg, lp, x, pos[:, None], cross["xk"], cross["xv"])
        x = _ffn(cfg, layer, lp, x)
        if collect_stats and cfg.layers[i][0] == ATTN:
            s = _info_stats(info, B, dev)
            stats = {key: stats[key] + s[key] for key in stats}
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.lm_logits(cfg, params["embed"], x[:, -1])
    state["pos"] = pos + 1
    state["pos_host"] = pos_host + 1
    if collect_stats:
        return logits, state, stats
    return logits, state


# ---------------------------------------------------------------------------
# decode window: on-card greedy sampling, several steps per host read
# ---------------------------------------------------------------------------
@torch.no_grad()
def serve_step_sampled(cfg: ArchConfig, fkv: FreeKVConfig, params, state, loop, sampler,
                       mesh=None):
    """One fused decode step (reference ``model.py:779``): ``serve_step``,
    sampling on the card and the finished mask; nothing is read back.

    ``loop`` is the decode-loop carry on the card, one lane per slot, each
    (B,) unless noted: ``cur`` int32 token fed to this step, ``key`` int64
    (B, 2) the request's key (``sampling.request_key``; token ``count`` is
    drawn with ``fold_in(key, count)``, unused by greedy sampling),
    ``count`` int32 tokens generated so far, ``limit`` int32 the request's
    max_new_tokens, ``eos`` int32 (-1 for none), ``fin`` bool finished or
    empty. Finished lanes keep stepping (rows are independent) and their
    tokens and stats are dropped by the scheduler.

    Returns (state, loop, tok (B,), valid (B,), stats, finite (B,)):
    ``valid[s]`` marks a lane live entering the step, ``finite[s]`` that its
    logits were finite (always True for a lane that was not live)."""
    from repro_torch.serving import sampling
    logits, state, stats = serve_step(cfg, fkv, params, state, loop["cur"][:, None].long(),
                                      collect_stats=True, mesh=mesh)
    tok = sampling.sample_counted(logits, sampler, loop["key"], loop["count"])
    valid = ~loop["fin"]
    count = loop["count"] + valid.to(torch.int32)
    fin = loop["fin"] | (count >= loop["limit"]) | (tok == loop["eos"])
    loop = dict(loop, cur=torch.where(valid, tok, loop["cur"]), count=count, fin=fin)
    finite = torch.isfinite(logits).all(dim=-1) | ~valid
    return state, loop, tok, valid, stats, finite


@torch.no_grad()
def decode_window(cfg: ArchConfig, fkv: FreeKVConfig, params, state, loop, sampler,
                  n_steps: int, stop_turnover: bool = False, read_finishes: bool = False,
                  mesh=None):
    """``n_steps`` fused decode steps with no host read (reference
    ``model.py:816``): the tokens, valid masks and per-step stats stay on
    the card in (n_steps, B) blocks for one read when the window ends.

    The reference's ``lax.while_loop`` decides on the card when to stop
    (every lane finished, or, with admissions queued, the first lane that
    finishes). A Python loop that read ``fin`` every step would bring back
    the per-step sync, so the caller fixes ``n_steps`` from its host copy
    of the lanes: finishes by ``limit`` are known there, and for windows
    without an eos finish the step count equals the reference's. An eos
    finish is seen only when the window ends: the lane is masked on the
    card from that step on (its later rows invalid), but the window runs
    to its planned end.

    ``read_finishes`` reads the lanes' finished flags after every step and
    stops where the reference's loop stops: every lane finished, or, with
    ``stop_turnover``, a lane live at the window's start finished. That is
    one host read a step, which the scheduler asks for only where rows meet
    (a MoE router's capacity couples a call's rows, ``models/moe``) and a
    live lane can end by eos: there an unplanned finish changes which
    requests share the following steps, and so their tokens.

    Returns (state, loop, toks (n, B) int32, valid (n, B) bool, stats {key:
    (n, B) float32, the ``SHARD_STAT_KEYS`` (n, tp, B)}, finite (B,) bool), n
    the steps run."""
    start_live = ~loop["fin"]
    toks, valid = [], []
    stats = {k: [] for k in stat_keys(mesh)}
    finite = torch.ones_like(loop["fin"])
    for _ in range(n_steps):
        state, loop, tok, ok, s, fin_ok = serve_step_sampled(cfg, fkv, params, state, loop,
                                                             sampler, mesh)
        toks.append(tok)
        valid.append(ok)
        for k in stats:
            stats[k].append(s[k])
        finite = finite & fin_ok
        if read_finishes and loop["fin"].device.type != "meta":
            stop = loop["fin"].all()
            if stop_turnover:
                stop = stop | (loop["fin"] & start_live).any()
            if bool(stop):
                break
    return (state, loop, torch.stack(toks), torch.stack(valid),
            {k: torch.stack(v) for k, v in stats.items()}, finite)


# ---------------------------------------------------------------------------
# speculative decoding: drafted-block verify and in-place rollback
# ---------------------------------------------------------------------------
SPEC_METHODS = ("freekv", "arkvale", "infinigen")


def supports_spec_decode(cfg: ArchConfig, fkv: FreeKVConfig) -> bool:
    """Whether ``draft_len`` can run exactly (reference ``model.py:864``):
    every drafted row must take the exact sequential retrieval step, so
    the retriever needs a rewindable selection buffer (the FreeKV family;
    the local layers of gemma2 are streaming rings), over a stack that
    ``supports_kv_extend`` (no recurrent layer, no encoder-decoder, no
    frontend prefix) with dense FFNs only; the page-sharded fused step keeps
    its own selection schedule and is excluded (``fkv.sharded_retrieval``)."""
    return (fkv.draft_len > 0 and fkv.method in SPEC_METHODS and not fkv.sharded_retrieval
            and supports_kv_extend(cfg) and all(f == DENSE for _, f in cfg.layers))


@torch.no_grad()
def serve_step_verify(cfg: ArchConfig, fkv: FreeKVConfig, params, state, tokens, mesh=None):
    """One target pass over a drafted block (reference ``model.py:924``):
    tokens (B, S), row 0 the committed current token and rows 1..S-1 the
    drafted continuation; every row is appended to ``state`` in place.

    Row j is the j-th of S ``serve_step`` calls, so its logits and stats
    are bit for bit a single step's. The reference runs the backbone once
    over the B * S rows, which is exact only where the GEMMs are
    row-independent; cuBLAS picks its kernel by M, so the port keeps each
    GEMM at the decode step's M = B. ``pos`` and ``pos_host`` are left at
    their pre-block values for ``rewind_state``.

    Returns (logits (B, S, V), state, stats_rows {key: (S, B)}, undo), undo
    a retrieval state's ``(ring_snapshot, [draft_probe of each row])`` in
    ``_spec_units``' order. Under a compute mesh each data group's
    retrievers snapshot and probe that group's rows on its shards."""
    S = tokens.shape[1]
    units = _spec_units(cfg, fkv, state, mesh)
    pos, pos_host = state["pos"], state["pos_host"]
    undo = [(r.ring_snapshot(view(state), S), []) for _, _, r, view, _ in units]
    logits, stats = [], []
    for j in range(S):
        lg, state, s = serve_step(cfg, fkv, params, state, tokens[:, j:j + 1],
                                  collect_stats=True, mesh=mesh)
        logits.append(lg)
        stats.append(s)
        for (_, _, r, view, _), (_, probes) in zip(units, undo):
            probes.append(r.draft_probe(view(state)))
    state["pos"], state["pos_host"] = pos, pos_host
    return (torch.stack(logits, dim=1), state,
            {k: torch.stack([s[k] for s in stats]) for k in stat_keys(mesh)}, undo)


def _spec_units(cfg: ArchConfig, fkv: FreeKVConfig, state, mesh):
    """The retrieval states speculative decoding rolls back, as (rows, at,
    retriever, view, put): ``rows`` the batch rows (a slice), ``at`` the
    shard their scalars go to, ``view(state)`` the state the retriever
    reads and ``put(state, sub)`` writes it back. One a layer without a
    compute mesh (``retrievers``); under one, one a layer and data group,
    the group's retriever in its layout (``_retriever_table``) over the
    group's entries, on its shard 0. (A speculative stack has only
    attention layers, ``supports_spec_decode``.)"""
    if not is_compute_mesh(mesh):
        return [(slice(None), HOME, r, lambda st, i=i: st["layers"][i],
                 lambda st, sub, i=i: st["layers"].__setitem__(i, sub))
                for i, r in enumerate(retrievers(cfg, fkv, mesh))]
    get = _retriever_table(cfg, fkv, mesh)
    m = mesh.shape["model"]
    groups = state_groups(state["layers"][0])
    b = state["pos"].shape[0] // len(groups)
    units = []
    for i, layer in enumerate(cfg.layers):
        for gi, g in enumerate(groups):
            def view(st, i=i, g=g):
                return _gsub(st["layers"][i], g)

            def put(st, sub, i=i, g=g):
                _gput(st["layers"][i], g, sub)
            r = get(g, layer[0], mesh_layout(cfg, fkv, layer, m, state=view(state)))
            units.append((slice(gi * b, (gi + 1) * b), (g, 0), r, view, put))
    return units


def rewind_state(cfg: ArchConfig, fkv: FreeKVConfig, state, undo, m, mesh=None):
    """Roll every layer back to its slot's ``m`` (B,) committed rows and
    advance ``pos`` by m, in place (reference ``_rewind_state``,
    ``model.py:978``): each layer's selection lanes come from its probe at
    the last committed row (one recall, ``draft_rewind``), and the ring
    writes of the rejected rows are undone (``ring_restore``). A slot with
    m = 0 (finished) keeps its pre-block state. Under serving TP
    (``mesh``) each shard's probes and ring are rolled back on its device;
    under a compute mesh each data group's, from its rows."""
    last = (m - 1).clamp(0, None).long()
    keep_len = state["pos"] + m
    for (rows, at, r, view, put), (snap, probes) in zip(_spec_units(cfg, fkv, state, mesh),
                                                         undo):
        lst, keep, m_g = (_to_group(mesh, t, rows, at) for t in (last, keep_len, m))
        bidx = torch.arange(lst.shape[0], device=lst.device)

        def pick(stacked):             # (S, b, ...) -> each slot's last committed row
            return stacked[lst.to(stacked.device), bidx.to(stacked.device)]
        probe = tuple(pick(torch.stack([p[c] for p in probes])) for c in range(len(probes[0])))
        st = r.draft_rewind(view(state), keep, probe)
        put(state, r.ring_restore(st, snap, m_g))
    state["pos"] = keep_len
    return state


@torch.no_grad()
def serve_step_spec(cfg: ArchConfig, fkv: FreeKVConfig, params, state, loop, sampler,
                    mesh=None):
    """One speculative iteration (reference ``model.py:1008``): draft ->
    verify -> accept the longest consistent prefix -> roll back in place
    -> fold the committed bigrams into the drafter; nothing is read back.

    The block is [cur, d_1..d_L] (S = 1 + ``draft_len`` rows). Row j is
    sampled with the key ``fold_in(request_key, count + j)`` the sequential
    path would use, and row j >= 1 is emitted iff every earlier row matched
    its draft, emitted no eos and the limit was not reached: the tokens m
    sequential steps emit, greedy or sampled.

    Returns (state, loop, toks (S, B) int32, emit (S, B) bool, stats
    {key: (S, B)}, finite (B,)): ``finite`` marks lanes whose emitted rows'
    logits were all finite."""
    from repro_torch.core import drafter
    from repro_torch.serving import sampling
    B = loop["cur"].shape[0]
    S = fkv.draft_len + 1
    cur = loop["cur"]
    tabs = _draft_tabs(state, mesh)
    drafted = _join_rows(mesh, [(at, drafter.propose(tab, _to_group(mesh, cur, sl, at),
                                                    fkv.draft_len)) for sl, at, tab in tabs])
    toks = torch.cat([cur[:, None], drafted], dim=1)                  # (B, S)
    logits, state, stats_rows, undo = serve_step_verify(cfg, fkv, params, state, toks.long(),
                                                        mesh)
    V = logits.shape[-1]
    counts = loop["count"][None, :] + torch.arange(S, dtype=loop["count"].dtype,
                                                   device=cur.device)[:, None]   # (S, B)
    e = sampling.sample_counted(logits.transpose(0, 1).reshape(S * B, V), sampler,
                                loop["key"].repeat(S, 1), counts.reshape(-1)).reshape(S, B)
    live0 = ~loop["fin"]
    emits = [live0]
    for j in range(1, S):
        prev = e[j - 1]
        cont = ((drafted[:, j - 1] == prev) & (prev != loop["eos"])
                & (loop["count"] + j < loop["limit"]))
        emits.append(emits[-1] & cont)
    emit = torch.stack(emits)                                          # (S, B)
    m = emit.sum(dim=0).to(torch.int32)
    state = rewind_state(cfg, fkv, state, undo, m, mesh)
    bidx = torch.arange(B, device=cur.device)
    e_last = e[(m - 1).clamp(0, None).long(), bidx]
    any_ = m > 0
    count = loop["count"] + m
    fin = loop["fin"] | (any_ & ((e_last == loop["eos"]) | (count >= loop["limit"])))
    finite = (torch.isfinite(logits).all(dim=-1) | ~emit.T).all(dim=1)
    loop = dict(loop, cur=torch.where(any_, e_last, cur), count=count, fin=fin)
    stream = torch.cat([cur[:, None], e.T], dim=1)                     # (B, S + 1)
    emit_ext = torch.cat([live0[:, None], emit.T], dim=1)
    for sl, at, tab in tabs:
        drafter.update(tab, _to_group(mesh, stream, sl, at), _to_group(mesh, emit_ext, sl, at))
    return state, loop, e, emit, stats_rows, finite


def _draft_tabs(state, mesh):
    """(rows, shard, table) of each drafter table: the one (B, vocab) table,
    or under a compute mesh each data group's on its shard 0."""
    tabs = state["draft_tab"]
    if not isinstance(tabs, dict):
        return [(slice(None), HOME, tabs)]
    n = len(tabs)
    b = state["pos"].shape[0] // n
    return [(slice(g * b, (g + 1) * b), (g, 0), tabs[f"{g}:0/draft_tab"]) for g in range(n)]


def _to_group(mesh, t, rows, at):
    """Rows ``rows`` of ``t`` (on the primary device) on shard ``at``."""
    return t[rows] if at == HOME else transfer.move(mesh, t[rows], HOME, at, "data")


def _join_rows(mesh, parts):
    """(shard, rows) parts back on the primary device, joined in order."""
    if len(parts) == 1 and parts[0][0] == HOME:
        return parts[0][1]
    return torch.cat([transfer.move(mesh, t, at, HOME, "data") for at, t in parts])


@torch.no_grad()
def decode_window_spec(cfg: ArchConfig, fkv: FreeKVConfig, params, state, loop, sampler,
                       n_max: int, stop_turnover: bool = False, mesh=None):
    """Up to ``n_max`` speculative iterations with no blocking host read
    (reference ``model.py:1070``): (n, S, B) token, emit and stat blocks
    stay on the card for one read when the window ends.

    Window rule. An iteration commits 1 to S tokens a live lane, so the
    host cannot know when a lane reaches its limit. The caller passes
    ``n_max`` = the iterations the lanes need if every draft is rejected
    (at most ``sync_interval``): enough for the reference's loop, which
    stops when every lane is finished or, with admissions queued
    (``stop_turnover``), when a lane live at the start finishes. After each
    iteration that stop flag is copied to pinned host memory without
    blocking, behind an event; before each iteration the host reads the
    newest flag whose event has completed (``Event.query``, which never
    waits) and stops if it is set. On the CPU the flag is read at once,
    so the loop stops exactly where the reference's does. On the card the
    host runs ahead of the card by a few iterations at most, and
    iterations launched after the stop are masked: every lane finished,
    nothing committed (``EngineMetrics.spec_idle_iterations`` counts them).
    Tokens never depend on the window's length.

    ``state["pos_host"]`` does not follow the rewinds; the caller advances
    it from the read emit blocks (only the centroid index reads it, and
    centroid runs no spec). Returns (state, loop, toks (n, S, B) int32,
    emit (n, S, B) bool, stats {key: (n, S, B)}, finite (B,))."""
    start_live = ~loop["fin"]
    toks, emits = [], []
    stats = {k: [] for k in stat_keys(mesh)}
    finite = torch.ones_like(loop["fin"])
    on_card = loop["fin"].is_cuda
    # on meta nothing can be read: every iteration runs, as on the card when
    # the host reads no finished flag in time
    meta = loop["fin"].device.type == "meta"
    flags = (torch.zeros((max(n_max, 1),), dtype=torch.bool, pin_memory=True)
             if on_card else None)
    events = []
    for it in range(n_max):
        if events:
            done = [j for j, ev in enumerate(events) if ev.query()]
            if done and bool(flags[done[-1]]):
                break
        state, loop, tok, emit, s, fin_ok = serve_step_spec(cfg, fkv, params, state, loop,
                                                            sampler, mesh)
        toks.append(tok)
        emits.append(emit)
        for k in stats:
            stats[k].append(s[k])
        finite = finite & fin_ok
        stop = ~(~loop["fin"]).any()
        if stop_turnover:
            stop = stop | (loop["fin"] & start_live).any()
        if on_card:
            flags[it:it + 1].copy_(stop[None], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            events.append(ev)
        elif not meta and bool(stop):
            break
    if not toks:
        B, S = loop["cur"].shape[0], fkv.draft_len + 1
        z = torch.zeros((0, S, B), dtype=torch.int32, device=loop["cur"].device)
        return (state, loop, z, z.bool(),
                {k: torch.zeros((0, S) + (() if k in DECODE_STAT_KEYS else (tp_group_size(mesh),))
                                + (B,), device=z.device) for k in stats}, finite)
    return (state, loop, torch.stack(toks), torch.stack(emits),
            {k: torch.stack(v) for k, v in stats.items()}, finite)


# ---------------------------------------------------------------------------
# serving under a ("data", "model") compute mesh
# ---------------------------------------------------------------------------
# A compute mesh (``launch/mesh.make_host_mesh``) runs the backbone of each
# data group on its model shards (``sharding/transfer.MeshRow``), with the
# params of ``sharding/rules.place_serving_params`` (one tree a data group,
# each weight held in the layout its shards compute with, so a step fetches
# none unless ``inference_fsdp`` keeps the FSDP dim).
# The batch's rows split over "data" where they divide (``serving_groups``),
# and group g's activations live on its shard (g, 0) between sublayers. The
# attention sublayer is Megatron's where the model axis divides both head
# counts (column-parallel wq/wk/wv, each shard its own heads, row-parallel
# wo), else the input-dim split of the reference's ``_gather_for_compute``
# with prefill attention over query rows split over "model"
# (``_maybe_seq_shard``); the MLP column/row-parallel, the MoE
# expert-parallel, the embedding and the logits vocab-parallel, as in
# training, forward only. Each attention layer's retrieval state takes one
# of three layouts in each data group (``mesh_layout``):
#   "groups"  KV-head groups, shard j the KV heads its projections made
#             (``TPGroupShardedRetriever.decode_parts``): nothing crosses
#             shards but the row-parallel sums;
#   "pages"   the page-sharded fused step (``PageShardedRetriever``) where
#             ``retrieval.use_sharded`` holds;
#   "whole"   the plain retriever on the group's shard 0, where the KV heads
#             do not divide the model axis (the reference stores such state
#             by page over "model" and lets its partitioner move it; a
#             difference by design).
# A recurrent layer's state sits on the shards of its model-parallel form
# (``recurrent_shards``: Mamba's d_inner blocks, the mLSTM's heads) or whole
# on shard 0 (the sLSTM); an encoder-decoder layer's cross-attention
# ``xk``/``xv`` by KV-head group where the heads divide, else whole on shard
# 0 (``_enc_kv_mp``). A layer's state is one flat dict keyed
# ``"<group>:<shard>/<leaf>"``; the positions stay whole on the primary
# device, and under speculative decoding each group's drafter table
# (``"<group>:0/draft_tab"``) on its shard 0. A 1 x 1 mesh computes what no
# mesh does, op for op: the same tokens, bit for bit.
def serving_groups(cfg: ArchConfig, mesh, batch_size: int) -> int:
    """The data groups a serving batch of ``batch_size`` rows runs on: all
    of "data" where the rows divide (``rules.batch_shardings``), else one,
    group 0 running every row (the reference replicates such a batch over
    "data"); one as well where a MoE's experts do not divide the model axis,
    whose replicated branch routes the call's rows together, as
    ``forward_train``."""
    n = mesh.shape["data"]
    if batch_size % n:
        return 1
    if any(f == MOE for _, f in cfg.layers) and cfg.n_experts % mesh.shape["model"]:
        return 1
    return n


def mesh_layout(cfg: ArchConfig, fkv: FreeKVConfig, layer, model_parallel: int,
                max_len: int = None, state=None) -> str:
    """An attention layer's retrieval layout in a data group of
    ``model_parallel`` shards ("groups", "pages" or "whole", see above),
    from ``max_len`` when its state is made, or from a group's ``state``
    (a page shard beyond 0 holds pages and no sink)."""
    m = model_parallel
    if layer[0] == ATTN:
        if state is not None and m > 1:
            fused = "1/pool" in state and "1/sink_k" not in state
        else:             # one shard divides any state: the flags alone decide
            fused = use_sharded(cfg, fkv, m, max_len or fkv.page_size)
        if fused:
            return "pages"
    return "groups" if attn.heads_divide(cfg, m) else "whole"


def _retriever_table(cfg: ArchConfig, fkv: FreeKVConfig, mesh):
    """``get(g, mixer, layout)``: the retriever of one layer kind in data
    group g under ``layout``, made once a call (as ``retrievers``' one a
    kind)."""
    table = {}

    def get(g, mixer, layout):
        key = (g, mixer, layout)
        if key not in table:
            table[key] = _make_mesh_retriever(cfg, fkv, mesh, g, mixer, layout)
        return table[key]
    return get


def _make_mesh_retriever(cfg, fkv, mesh, g, mixer, layout):
    row = MeshRow(mesh, g)
    if layout == "pages":
        return PageShardedRetriever(cfg, fkv, row, speculative=fkv.method == "freekv")
    devs = tuple(row.device(j) for j in range(row.m)) if layout == "groups" else (row.device(0),)

    def make(c):
        if mixer == ATTN_LOCAL:
            return StreamingRetriever(c, fkv, window=cfg.sliding_window, n_sink=0)
        return make_retriever(c, fkv)
    return TPGroupShardedRetriever(cfg, TPMesh(devs), make)


def _gsub(st, g):
    """Data group g's entries of a layer's state, its prefix dropped."""
    pre = f"{g}:"
    return {k[len(pre):]: v for k, v in st.items() if k.startswith(pre)}


def _gput(st, g, sub):
    """Group g's entries of ``st`` become ``sub``'s, in place."""
    pre = f"{g}:"
    for k in [k for k in st if k.startswith(pre) and k[len(pre):] not in sub]:
        del st[k]
    st.update({pre + k: v for k, v in sub.items()})


def state_groups(layer_state) -> list:
    """The data groups a layer's state under a compute mesh holds rows of."""
    return sorted({int(k.split(":", 1)[0]) for k in layer_state})


def _init_mesh_state(cfg, fkv, batch_size, max_len, dtype, dev, mesh):
    n_g = serving_groups(cfg, mesh, batch_size)
    b = batch_size // n_g
    m = mesh.shape["model"]
    retriever = _retriever_table(cfg, fkv, mesh)
    layers = []
    for layer in cfg.layers:
        st = {}
        for g in range(n_g):
            row = MeshRow(mesh, g)
            if layer[0] in RECURRENT:
                sub = {f"{j}/{k}": v for j, blk in enumerate(
                    _recurrent_state_blocks(cfg, layer[0], b, dtype, row)) for k, v in blk.items()}
            else:
                r = retriever(g, layer[0], mesh_layout(cfg, fkv, layer, m, max_len=max_len))
                sub = r.init_state(b, max_len, dtype, row.device(0))
                if cfg.is_encoder_decoder:
                    groups = attn.heads_divide(cfg, m)
                    shape = (b, cfg.n_frontend_tokens,
                             cfg.n_kv_heads // m if groups else cfg.n_kv_heads, cfg.d_head)
                    sub.update({f"{j}/{key}": torch.zeros(shape, dtype=dtype, device=row.device(j))
                                for j in range(m if groups else 1) for key in CROSS_KEYS})
            st.update({f"{g}:{k}": v for k, v in sub.items()})
        layers.append(st)
    out = {"layers": layers, "pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
           "pos_host": torch.zeros((batch_size,), dtype=torch.int32)}
    if fkv.draft_len > 0:               # each data group's drafter lanes
        from repro_torch.core import drafter
        out["draft_tab"] = {f"{g}:0/draft_tab": drafter.init_draft_tab(
            b, cfg.vocab_size, mesh.device((g, 0))) for g in range(n_g)}
    return out


def _pop_cross(st) -> dict:
    """A layer's cross-attention leaves (every shard's) taken out of its
    state, which the retriever never sees."""
    return {k: st.pop(k) for k in [k for k in st if k.rsplit("/", 1)[-1] in CROSS_KEYS]}


def _mesh_info(r, infos, row):
    """The KV-head groups' infos as one, on shard 0 (counters moved as
    ``stats``)."""
    moved = [infos[0]] + [{k: row.move(v, j, 0, "stats") if isinstance(v, torch.Tensor) else v
                           for k, v in info.items()} for j, info in enumerate(infos) if j]
    return r.merge_info(moved, row.device(0))


def _mesh_attn_decode(cfg, p, h, pos, r, layout, sub, row, length_host, q_proxy):
    """A decode step's attention sublayer in group ``row``: h (B, 1, d) and
    pos (B,) on shard 0, the group's retrieval state ``sub`` in place ->
    (out on shard 0, sub, info on shard 0, this layer's query whole on
    shard 0 for the next layer's ``q_proxy``, or None where none is read)."""
    m = row.m
    B = h.shape[0]
    H, dh = cfg.n_heads, cfg.d_head
    if attn.heads_divide(cfg, m):
        local = attn.local_cfg(cfg, m)
        hl = H // m
        hs = row.broadcast(h, "partial_sum")
        ws, qs, kns, vns = [], [], [], []
        for j in range(m):
            w = attn.megatron_weights(p, row, j)
            pj = pos if j == 0 else row.move(pos, 0, j, "attn_in")
            q, k, v = attn.qkv_proj(local, w, hs[j], pj[:, None])
            ws.append(w)
            qs.append(q[:, 0].contiguous())
            kns.append(k[:, 0])
            vns.append(v[:, 0])

        def joined(ts):
            return torch.cat([row.move(t, j, 0, "attn_in") for j, t in enumerate(ts)], dim=1)
        if layout == "pages":
            o, sub, info = r.decode(sub, joined(qs), joined(kns), joined(vns))
            outs = [row.move(o[:, j * hl:(j + 1) * hl], 0, j, "attn_out") for j in range(m)]
        else:
            qps = None if q_proxy is None else [
                row.move(q_proxy[:, j * hl:(j + 1) * hl].contiguous(), 0, j, "attn_in")
                for j in range(m)]
            outs, sub, infos = r.decode_parts(sub, qs, kns, vns, length_host=length_host,
                                              q_proxies=qps)
            info = _mesh_info(r, infos, row)
        out = row.reduce([attn.out_proj(local, ws[j], outs[j][:, None]) for j in range(m)],
                         "partial_sum")
        return out, sub, info, (joined(qs) if q_proxy is not None else None)
    q, k, v = attn.qkv_split(cfg, p, h, pos[:, None], row)
    q, kn, vn = q[:, 0].contiguous(), k[:, 0], v[:, 0]
    if layout == "pages":
        o, sub, info = r.decode(sub, q, kn, vn)
    else:
        outs, sub, infos = r.decode_parts(sub, [q], [kn], [vn], length_host=length_host,
                                          q_proxies=None if q_proxy is None else [q_proxy])
        o, info = outs[0], _mesh_info(r, infos, row)
    return attn.out_split(cfg, p, [(0, o.reshape(B, 1, H, dh))], row), sub, info, q


def _join_vocab(row, blocks):
    """``L.lm_logits``' vocab blocks (block j on shard j) as one tensor on
    shard 0."""
    return torch.cat([row.move(t, j, 0, "vocab") for j, t in enumerate(blocks)], dim=-1)


def _moe_blocks(mesh, n_groups, n_tokens) -> int:
    """A MoE call's data blocks in a group's flat tokens, as ``forward_train``."""
    n_data = mesh.shape["data"]
    return n_data // n_groups if (n_tokens * n_groups) % n_data == 0 else 1


def _prefill_mesh(cfg, fkv, params, batch, max_len, state_dtype, into, return_kv, build_state,
                  mesh, group, kv=None, prefix_len=0):
    """``prefill`` (``kv`` None) and ``prefill_extend`` under a compute mesh:
    each data group's rows through its model shards, its retrieval state
    built in the layer's layout on its shards, the logits back on the
    primary device and the K/V the caller keeps (per layer) there too, or
    on the group's shard 0 when one ``group`` ran."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    groups = [group] if group is not None else list(range(serving_groups(cfg, mesh, B)))
    b = B // len(groups)
    m = mesh.shape["model"]
    ext = kv is not None
    t0 = int(prefix_len)
    retriever = _retriever_table(cfg, fkv, mesh)
    states = [{} for _ in cfg.layers]
    kvs = [[] for _ in cfg.layers]
    logits_parts = []
    T = None
    for gi, g in enumerate(groups):
        row, prm, at = MeshRow(mesh, g), params[g], (g, 0)
        grp = {k: transfer.move(mesh, v if len(groups) == 1 else v[gi * b:(gi + 1) * b],
                                HOME, at, "data") for k, v in batch.items()}
        if ext:
            x = L.embed_tokens(cfg, prm["embed"], grp["tokens"], row=row)
        else:
            x, positions = _embed_inputs(cfg, prm, grp, row)
        S = x.shape[1]
        T = t0 + S
        n_blocks = _moe_blocks(mesh, len(groups), b * S)
        enc = _encode(cfg, prm, grp["frontend"], row=row) if cfg.is_encoder_decoder else None
        for i, lp in enumerate(prm["layers"]):
            layer = cfg.layers[i]
            h = L.apply_norm(cfg, _whole(row, lp["norm1"]), x)
            if layer[0] in RECURRENT:
                o, sts = _recurrent_forward(cfg, layer[0], lp["mixer"], h, row,
                                            return_state=True)
                x = _ffn_aux(cfg, layer, lp, _residual(cfg, lp, x, o, "1", row), row,
                             n_blocks)[0]
                if build_state:
                    states[i].update({f"{g}:{j}/{k}": v for j, st in enumerate(sts)
                                      for k, v in st.items()})
                kvs[i].append(None)
                continue
            buf = None
            if ext:
                buf = tuple(t if len(groups) == 1 else t[gi * b:(gi + 1) * b] for t in kv[i])
            out, ks, vs, qls, whole = attn.attention_mp_prefill(
                cfg, lp["mixer"], h, t0, _window(cfg, layer), row, buf,
                need_whole=return_kv and not ext)
            x = _residual(cfg, lp, x, out, "1", row)
            if enc is not None:
                xks, xvs = _enc_kv_mp(cfg, lp, enc, row)
                x = _cross_mp(cfg, lp, x, positions, xks, xvs, row)
            x = _ffn_aux(cfg, layer, lp, x, row, n_blocks)[0]
            kvs[i].append(whole)
            if not build_state:
                continue
            layout = mesh_layout(cfg, fkv, layer, m, max_len=max_len)
            r = retriever(g, layer[0], layout)
            st = _gsub(into[i], g) if into is not None else r.init_state(b, max_len, state_dtype,
                                                                         row.device(0))
            rows = _pop_cross(st)
            if layout == "pages":
                k, v, ql = (ts[0] if len(ts) == 1 else
                            torch.cat([row.move(t, j, 0, "state") for j, t in enumerate(ts)],
                                      dim=axis)
                            for ts, axis in ((ks, 2), (vs, 2), (qls, 1)))
                st = r.prefill(st, k, v, ql)
            else:
                st = r.prefill_parts(st, ks, vs, qls)
            if enc is not None:
                for j, pair in enumerate(zip(xks, xvs)):
                    for key, t in zip(CROSS_KEYS, pair):
                        k_ = f"{j}/{key}"
                        st[k_] = rows[k_].copy_(t) if k_ in rows else t.to(state_dtype)
            states[i].update({f"{g}:{k}": v for k, v in st.items()})
            del ks, vs, qls, h
        x = L.apply_norm(cfg, _whole(row, prm["final_norm"]), x)
        lg = _join_vocab(row, L.lm_logits(cfg, prm["embed"], x[:, -1], row=row))
        logits_parts.append(transfer.move(mesh, lg, at, HOME, "data"))
    logits = logits_parts[0] if len(groups) == 1 else torch.cat(logits_parts)
    state = _new_state(states, B, T, mesh.primary) if build_state else None
    if return_kv:
        if len(groups) > 1:
            kvs = [None if parts[0] is None else tuple(
                torch.cat([transfer.move(mesh, p_[c], (g, 0), HOME, "state")
                           for g, p_ in zip(groups, parts)]) for c in range(2))
                for parts in kvs]
        else:
            kvs = [parts[0] for parts in kvs]
        return logits, state, kvs
    return logits, state


def _serve_step_mesh(cfg, fkv, params, state, tokens, collect_stats, mesh):
    """``serve_step`` under a compute mesh: each data group's rows through
    its model shards, each attention layer's retrieval step in its layout,
    the logits and the stats back on the primary device."""
    B = tokens.shape[0]
    groups = state_groups(state["layers"][0])
    b = B // len(groups)
    m = mesh.shape["model"]
    pos, pos_host = state["pos"], state["pos_host"]
    infinigen = fkv.method == "infinigen"
    retriever = _retriever_table(cfg, fkv, mesh)
    logits_parts, stats_parts = [], []
    for gi, g in enumerate(groups):
        row, prm, at = MeshRow(mesh, g), params[g], (g, 0)
        sl = slice(gi * b, (gi + 1) * b)
        tok = transfer.move(mesh, tokens[sl], HOME, at, "data")
        pos_g = transfer.move(mesh, pos[sl], HOME, at, "data")
        x = L.embed_tokens(cfg, prm["embed"], tok, row=row)
        dev = x.device
        n_blocks = _moe_blocks(mesh, len(groups), b)
        q_proxy = (torch.zeros((b, cfg.n_heads, cfg.d_head), dtype=x.dtype, device=dev)
                   if infinigen else None)
        stats = {k: torch.zeros((b,), dtype=torch.float32, device=dev) for k in DECODE_STAT_KEYS}
        for i, lp in enumerate(prm["layers"]):
            layer = cfg.layers[i]
            st = state["layers"][i]
            sub = _gsub(st, g)
            h = L.apply_norm(cfg, _whole(row, lp["norm1"]), x)
            if layer[0] in RECURRENT:                     # updated in place
                n_sh = recurrent_shards(cfg, layer[0], m)
                recs = [{k.split("/", 1)[1]: v for k, v in sub.items() if k.startswith(f"{j}/")}
                        for j in range(n_sh)]
                o = _recurrent_step(cfg, layer[0], lp["mixer"], h, recs, row)
                x = _ffn_aux(cfg, layer, lp, _residual(cfg, lp, x, o, "1", row), row,
                             n_blocks)[0]
                continue
            cross = _pop_cross(sub)
            layout = mesh_layout(cfg, fkv, layer, m, state=sub)
            r = retriever(g, layer[0], layout)
            out, sub, info, q_now = _mesh_attn_decode(cfg, lp["mixer"], h, pos_g, r, layout, sub,
                                                      row, pos_host[sl], q_proxy)
            if infinigen:
                q_proxy = q_now
            sub.update(cross)
            _gput(st, g, sub)
            if layer[0] == ATTN and fkv.sharded_retrieval:
                SHARDED_PATHS["fused" if layout == "pages" else "fallback"] += 1
            x = _residual(cfg, lp, x, out, "1", row)
            if cross:
                n_x = len(cross) // 2
                x = _cross_mp(cfg, lp, x, pos_g[:, None], [cross[f"{j}/xk"] for j in range(n_x)],
                              [cross[f"{j}/xv"] for j in range(n_x)], row)
            x = _ffn_aux(cfg, layer, lp, x, row, n_blocks)[0]
            if collect_stats and layer[0] == ATTN:
                s = _info_stats(info, b, dev)
                stats = {key: stats[key] + s[key] for key in stats}
        x = L.apply_norm(cfg, _whole(row, prm["final_norm"]), x)
        lg = _join_vocab(row, L.lm_logits(cfg, prm["embed"], x[:, -1], row=row))
        logits_parts.append(transfer.move(mesh, lg, at, HOME, "data"))
        stats_parts.append({k: transfer.move(mesh, v, at, HOME, "stats")
                            for k, v in stats.items()})
    logits = logits_parts[0] if len(groups) == 1 else torch.cat(logits_parts)
    state["pos"] = pos + 1
    state["pos_host"] = pos_host + 1
    if collect_stats:
        stats = {k: (stats_parts[0][k] if len(groups) == 1 else
                     torch.cat([sp[k] for sp in stats_parts])) for k in DECODE_STAT_KEYS}
        return logits, state, stats
    return logits, state
