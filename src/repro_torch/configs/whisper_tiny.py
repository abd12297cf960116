"""whisper-tiny [audio] — encoder-decoder [arXiv:2212.04356]. The conv/mel
frontend is a stub: a request carries precomputed frame embeddings (1500 x
d_model). LayerNorm, non-gated GELU MLP, MHA (6/6 heads). Positions are
RoPE'd, as in the reference (the published model uses sinusoidal and
learned positions, 448 decoder positions)."""
from repro_torch.configs.base import ATTN, DENSE, ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio", source="arXiv:2212.04356",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
    vocab_size=51865,
    pattern=((ATTN, DENSE),), n_periods=4,
    norm="layernorm", act="gelu", gated_mlp=False,
    is_encoder_decoder=True, n_encoder_layers=4,
    frontend="audio", n_frontend_tokens=1500,
)
