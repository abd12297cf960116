"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517]. d_ff=0: the
xLSTM blocks carry their own up/down projections (``xlstm_proj_factor``), no
separate FFN. One sLSTM block in every 6 (the paper's sparse sLSTM
placement)."""
from repro_torch.configs.base import MLSTM, NONE, SLSTM, ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm", source="arXiv:2405.04517",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304,
    pattern=((MLSTM, NONE),) * 5 + ((SLSTM, NONE),), n_periods=4,
    norm="layernorm", act="gelu", gated_mlp=False,
    xlstm_proj_factor=2.0, xlstm_qk_dim_factor=0.5,
)
