"""granite-3-8b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base]. The vocab
(49155) is padded to ``padded_vocab()``; padded logits are masked."""
from repro_torch.configs.base import ATTN, DENSE, ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b", family="dense", source="hf:ibm-granite/granite-3.0-2b-base",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12800,
    vocab_size=49155,
    pattern=((ATTN, DENSE),), n_periods=40,
    rope_theta=10000.0, tie_embeddings=True,
)
