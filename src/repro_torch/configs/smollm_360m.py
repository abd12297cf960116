"""smollm-360m [dense] — llama-arch small, GQA 15H/kv5, tied embeddings
[hf:HuggingFaceTB/SmolLM-135M scaled per the reference's dims]."""
from repro_torch.configs.base import ATTN, DENSE, ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense", source="hf:HuggingFaceTB/SmolLM-135M",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_ff=2560,
    vocab_size=49152,
    pattern=((ATTN, DENSE),), n_periods=32,
    rope_theta=10000.0, tie_embeddings=True,
)
