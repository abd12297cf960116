"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7 interleave, MoE every
other layer (16 experts top-2) [arXiv:2403.19887]. Period of 8 layers:
attention at position 4 (the middle of the Jamba block), MoE on odd
positions."""
from repro_torch.configs.base import ATTN, DENSE, MAMBA, MOE, ArchConfig

_PERIOD = tuple(
    (ATTN if i == 4 else MAMBA, MOE if i % 2 == 1 else DENSE) for i in range(8)
)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid", source="arXiv:2403.19887",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab_size=65536,
    pattern=_PERIOD, n_periods=9,
    n_experts=16, n_shared_experts=0, moe_top_k=2, d_expert=24576,
    rope_theta=10000.0,
    ssm_d_state=16, ssm_d_conv=4, ssm_expand=2,
)
