"""llama31-8b — the paper's primary efficiency-evaluation model
(Llama-3.1-8B-Instruct) [arXiv:2407.21783]."""
from repro_torch.configs.base import ATTN, DENSE, ArchConfig

CONFIG = ArchConfig(
    name="llama31-8b", family="dense", source="arXiv:2407.21783",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=128256,
    pattern=((ATTN, DENSE),), n_periods=32,
    rope_theta=500000.0,
)
