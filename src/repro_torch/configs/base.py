"""Config dataclasses for architectures, the cost model's input shapes and
FreeKV (own copy of the reference ``repro/configs/base.py``, without its
meshes).

Layer structure is ``prelude + pattern * n_periods``, each layer a
``(mixer, ffn)`` pair, exactly as in the reference; the port runs the layers
as a flat Python loop (``ArchConfig.layers``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.quant.quantizers import quant_bits

# mixer kinds
ATTN = "attn"
ATTN_LOCAL = "attn_local"
MAMBA = "mamba"
MLSTM = "mlstm"
SLSTM = "slstm"
# ffn kinds
DENSE = "dense"
MOE = "moe"
NONE = "none"

Layer = Tuple[str, str]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    source: str

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    prelude: Tuple[Layer, ...] = ()
    pattern: Tuple[Layer, ...] = ((ATTN, DENSE),)
    n_periods: int = 0               # 0 -> (n_layers - len(prelude)) / len(pattern)

    d_head: int = 0                  # 0 -> d_model // n_heads
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu | gelu
    gated_mlp: bool = True
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    sliding_window: int = 4096
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    post_block_norm: bool = False
    tie_embeddings: bool = False
    attn_scale: Optional[float] = None

    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_expert: int = 0                # routed-expert hidden dim (fine-grained MoE)
    router_aux_loss: float = 0.01    # the load-balance term's weight in the training loss

    # SSM (mamba)
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2

    # xLSTM (``models/xlstm``): the blocks' inner width d_model * proj_factor,
    # and the query/key width a fraction of it
    xlstm_qk_dim_factor: float = 0.5
    xlstm_proj_factor: float = 2.0

    # encoder-decoder (whisper: an encoder over the frontend's frames, a
    # cross-attention sublayer in every decoder layer) and a modality
    # frontend's stub embeddings (internvl2: patches ahead of the prompt)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    frontend: Optional[str] = None
    n_frontend_tokens: int = 0

    max_position_embeddings: int = 1 << 20

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_periods == 0:
            body = self.n_layers - len(self.prelude)
            assert body % len(self.pattern) == 0, (
                f"{self.name}: {body} layers not divisible by pattern "
                f"{len(self.pattern)}")
            object.__setattr__(self, "n_periods", body // len(self.pattern))
        assert len(self.prelude) + len(self.pattern) * self.n_periods == self.n_layers

    @property
    def group_size(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def layers(self) -> Tuple[Layer, ...]:
        return self.prelude + self.pattern * self.n_periods

    def has_mixer(self, kind: str) -> bool:
        return any(m == kind for m, _ in self.layers)

    @property
    def uses_attention(self) -> bool:
        return self.has_mixer(ATTN) or self.has_mixer(ATTN_LOCAL)

    @property
    def uses_moe(self) -> bool:
        return any(f == MOE for _, f in self.layers)

    def padded_vocab(self, multiple: int = 512) -> int:
        return ((self.vocab_size + multiple - 1) // multiple) * multiple

    def param_counts(self) -> dict:
        """{'total': N, 'active': N_active} (active counts the top-k routed
        experts), the reference's estimate (``repro/configs/base.py:126``)
        behind the roofline's MODEL_FLOPS = 6 N D."""
        d, dh = self.d_model, self.d_head
        emb = self.padded_vocab() * d * (1 if self.tie_embeddings else 2)
        total = active = emb
        for mixer, ffn in self.layers:
            if mixer in (ATTN, ATTN_LOCAL):
                p = d * dh * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * dh * d
            elif mixer == MAMBA:
                di = self.ssm_expand * d
                p = (d * di * 2 + di * self.ssm_d_conv
                     + di * (self.ssm_d_state * 2 + 2) + di * d)
            elif mixer in (MLSTM, SLSTM):
                di = int(self.xlstm_proj_factor * d)
                dqk = int(self.xlstm_qk_dim_factor * di)
                p = d * (2 * dqk + 2 * di) + di * d + 3 * di
            else:
                raise ValueError(mixer)
            total += p
            active += p
            if ffn == DENSE:
                f = d * self.d_ff * (3 if self.gated_mlp else 2)
                total += f
                active += f
            elif ffn == MOE:
                de = self.d_expert or self.d_ff
                per = d * de * (3 if self.gated_mlp else 2)
                total += per * (self.n_experts + self.n_shared_experts) + d * self.n_experts
                active += per * (self.moe_top_k + self.n_shared_experts) + d * self.n_experts
        if self.is_encoder_decoder:
            # encoder layers (attention + dense FFN) and each decoder layer's
            # cross-attention
            p = (d * dh * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * dh * d
                 + d * self.d_ff * (3 if self.gated_mlp else 2))
            total += p * self.n_encoder_layers
            active += p * self.n_encoder_layers
            xattn = (d * dh * (self.n_heads + 2 * self.n_kv_heads)
                     + self.n_heads * dh * d) * self.n_layers
            total += xattn
            active += xattn
        return {"total": total, "active": active}


@dataclass(frozen=True)
class ShapeConfig:
    """One input shape of the cost model (reference ``base.py:171``)."""
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclass(frozen=True)
class FreeKVConfig:
    """The FreeKV runtime knobs the port serves (reference
    ``repro/configs/base.py:191``). The kernels are chosen by the tensors'
    device, so there is no ``use_kernels`` flag: CUDA tensors launch the
    hand-written kernels, CPU tensors take their plain PyTorch versions."""
    method: str = "freekv"      # freekv | arkvale | infinigen | quest | shadowkv |
                                # raas | streaming | full | centroid
    retriever: str = ""         # alias for method; wins when given
    page_size: int = 32
    budget: int = 2048          # tokens resident on the device
    n_sink: int = 128
    n_window: int = 128
    tau: float = 0.8            # correction threshold
    group_pool: str = "mean_softmax"  # MeanS (paper) | max_softmax | mean_qk | max_qk
    offload: str = "sim"        # sim (pool on the card) | host (pinned host pool)
    recall_overlap: bool = True  # staged recall on a side stream
    # quantized host tier (``repro_torch/quant``): the pool holds int8 or
    # packed int4 with float32 scales per (page, KV head, K|V half, channel
    # group); pages quantize at offload and dequantize inside the recall
    kv_quant: str = "none"      # none | int8 | int4
    quant_group_size: int = 0   # channels per scale; 0 = one scale per page half
    # ShadowKV: rank of the keys' low-rank factors (capped at d_head)
    svd_rank: int = 160
    pool_pad_pages: int = 1
    # Centroid: clusters per (layer, KV head) over the page summaries, and
    # the re-center cadence in completed pages (``core/centroid_index``)
    centroid_count: int = 16
    centroid_refresh_interval: int = 4
    # dynamic page budget (reference ``base.py:281``): keep the shortest
    # prefix of the top-k whose pooled softmax mass reaches this (at least
    # one page); 0 = off, and only the *_softmax pooling modes use it
    select_top_p: float = 0.0
    # continuous scheduler (``serving/scheduler``): up to ``sync_interval``
    # decode steps between two host reads (``models.model.decode_window``),
    # greedy tokens picked on the card; ``sample_on_device=False`` is the
    # synchronous reference path (one host read a step). The same tokens
    # either way.
    sync_interval: int = 8
    sample_on_device: bool = True
    # continuous scheduler: chunked prefill's token budget a round (0 =
    # whole-shot prefill at admission) and priority preemption with the
    # slot's state swapped to host (``serving/scheduler``)
    prefill_chunk_tokens: int = 0
    preempt: bool = False
    # speculative decoding (reference ``base.py:322``): a per-slot bigram
    # drafter (``core/drafter``) proposes up to ``draft_len`` tokens a
    # window iteration, one target pass verifies the drafted block row by
    # row through the exact sequential decode (``models.model
    # .serve_step_verify``), the longest consistent prefix commits and the
    # rejected rows are rolled back in place. Tokens equal ``draft_len=0``'s;
    # the engine falls back to 0 where that cannot hold
    # (``models.model.supports_spec_decode``). 0 = off.
    draft_len: int = 0
    # the page-sharded fused decode step (reference ``base.py:285-293``)
    # under a ("data", "model") mesh: each model shard holds a page range
    # of the pool, selects its own top-(n_sel / model) pages, recalls and
    # attends them locally, and the partials merge by log-sum-exp
    # (``core/sharded_retrieval``). An approximation of the global top-k.
    # ``sharded_overselect`` > 1 over-selects that many times and re-ranks
    # the candidates' scores globally. Excludes ``method="centroid"`` and
    # KV-head-group TP.
    sharded_retrieval: bool = False
    sharded_overselect: int = 1

    def __post_init__(self):
        if self.retriever:
            object.__setattr__(self, "method", self.retriever)
        p = self.page_size
        if self.n_sink % p or self.n_window % p:
            raise ValueError(
                f"n_sink={self.n_sink} and n_window={self.n_window} must be "
                f"multiples of page_size={p}: the paged-attention kernel "
                "reads the sink, window and selected regions as whole pages")
        if self.offload not in ("sim", "host"):
            raise ValueError(f"offload must be 'sim' or 'host', got {self.offload!r}")
        if self.kv_quant not in ("none", "int8", "int4"):
            raise ValueError(f"kv_quant must be none, int8 or int4, got {self.kv_quant!r}")
        if self.sharded_overselect < 1:
            raise ValueError(f"sharded_overselect={self.sharded_overselect} must be at least 1")
        if self.sharded_retrieval and self.method == "centroid":
            # reference ``retrieval.py:455``
            raise ValueError("method='centroid' composes with KV-head-group TP, not "
                             "sharded_retrieval")

    @property
    def quant_bits(self) -> int:
        """Bits per stored pool element (0 = unquantized)."""
        return quant_bits(self.kv_quant)


def reduce_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Reduced variant of the same family for CPU smoke tests (the
    reference's rule): one period cut to at most two layers, one a distinct
    mixer, the MoE FFN preferred (jamba keeps a Mamba + MoE and an attention
    + dense layer, xlstm an mLSTM and an sLSTM block), 4 experts of width
    128, at most 2 encoder layers and 16 frontend tokens."""
    pat = cfg.pattern
    if len(pat) > 2:
        chosen, order = {}, []
        for m, f in pat:
            if m not in chosen:
                chosen[m] = f
                order.append(m)
            elif f == MOE:
                chosen[m] = f
        pat = tuple((m, chosen[m]) for m in order[:2])
    prelude = cfg.prelude[:1]
    n_layers = len(prelude) + len(pat)
    d_model = min(cfg.d_model, 256)
    n_heads = 4
    n_kv = max(1, min(cfg.n_kv_heads, 2))
    changes = dict(
        n_layers=n_layers, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
        d_head=d_model // n_heads, d_ff=max(cfg.d_ff and 512, 0) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 1024), prelude=prelude, pattern=pat,
        n_periods=1, sliding_window=64,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        n_frontend_tokens=min(cfg.n_frontend_tokens, 16) if cfg.n_frontend_tokens else 0,
        max_position_embeddings=1 << 16,
    )
    if cfg.n_experts:
        changes.update(n_experts=4, moe_top_k=min(cfg.moe_top_k, 2),
                       n_shared_experts=min(cfg.n_shared_experts, 1),
                       d_expert=128 if cfg.d_expert else 0)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **changes)
