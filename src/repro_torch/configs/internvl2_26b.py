"""internvl2-26b [vlm] — InternViT + InternLM2 [arXiv:2404.16821]. The vision
encoder and MLP projector are a stub: a request carries precomputed patch
embeddings (n_frontend_tokens x d_model) that sit ahead of its prompt. This
is the InternLM2-20B-style language backbone (GQA 48/8, rmsnorm, silu)."""
from repro_torch.configs.base import ATTN, DENSE, ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm", source="arXiv:2404.16821",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=92553,
    pattern=((ATTN, DENSE),), n_periods=48,
    rope_theta=1000000.0, frontend="vision", n_frontend_tokens=1024,
)
