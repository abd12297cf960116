"""llama4-scout-17b-a16e [moe] — 16 routed experts top-1 + 1 shared expert,
early fusion [hf:meta-llama/Llama-4-Scout-17B-16E]. All layers MoE (Scout)."""
from repro_torch.configs.base import ATTN, MOE, ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab_size=202048,
    pattern=((ATTN, MOE),), n_periods=48,
    n_experts=16, n_shared_experts=1, moe_top_k=1, d_expert=8192,
    rope_theta=500000.0,
)
