"""gemma2-2b [dense] — local+global alternating attention, logit softcaps,
pre+post block norms, d_head=256, tied embeddings [arXiv:2408.00118]."""
from repro_torch.configs.base import ATTN, ATTN_LOCAL, DENSE, ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b", family="dense", source="arXiv:2408.00118",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_ff=9216,
    vocab_size=256000, d_head=256,
    pattern=((ATTN_LOCAL, DENSE), (ATTN, DENSE)), n_periods=13,
    act="gelu", sliding_window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    post_block_norm=True, tie_embeddings=True,
    rope_theta=10000.0,
)
