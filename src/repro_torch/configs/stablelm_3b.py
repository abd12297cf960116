"""stablelm-3b [dense] — MHA (kv=32), LayerNorm, partial rotary (25%)
[hf:stabilityai/stablelm-2-1_6b scaled per the reference's dims]."""
from repro_torch.configs.base import ATTN, DENSE, ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b", family="dense", source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
    vocab_size=50304,
    pattern=((ATTN, DENSE),), n_periods=32,
    norm="layernorm", rope_fraction=0.25, rope_theta=10000.0,
)
