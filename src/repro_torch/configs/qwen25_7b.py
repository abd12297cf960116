"""qwen25-7b — the paper's second efficiency-evaluation model
(Qwen-2.5-7B-Instruct) [arXiv:2412.15115]. As in the reference config, no
QKV bias."""
from repro_torch.configs.base import ATTN, DENSE, ArchConfig

CONFIG = ArchConfig(
    name="qwen25-7b", family="dense", source="arXiv:2412.15115",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab_size=152064,
    pattern=((ATTN, DENSE),), n_periods=28,
    rope_theta=1000000.0,
)
