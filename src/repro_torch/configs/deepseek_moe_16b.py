"""deepseek-moe-16b [moe] — DeepSeekMoE: fine-grained experts, 2 shared + 64
routed top-6 [arXiv:2401.06066]. Layer 0 uses a dense FFN (the paper's
design); its d_ff=1408 is the routed-expert hidden dim, the reference's own
choice (not the published 10944)."""
from repro_torch.configs.base import ATTN, DENSE, MOE, ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe", source="arXiv:2401.06066",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=102400,
    prelude=((ATTN, DENSE),), pattern=((ATTN, MOE),), n_periods=27,
    n_experts=64, n_shared_experts=2, moe_top_k=6, d_expert=1408,
    rope_theta=10000.0,
)
