"""Architecture config registry: ``get_config(name)``; ``<name>-smoke`` gives
the reduced variant. The port registers the reference's dense archs (gemma2-2b
with its sliding-window local layers), its MoE archs (deepseek-moe-16b,
llama4-scout-17b-a16e) and the Mamba + attention + MoE hybrid
jamba-1.5-large-398b; the xLSTM, encoder-decoder and vision archs are not
ported."""
from importlib import import_module

from repro_torch.configs.base import (  # noqa: F401
    ATTN, ATTN_LOCAL, DENSE, MAMBA, MLSTM, MOE, NONE, SLSTM,
    ArchConfig, FreeKVConfig, reduce_for_smoke,
)

_MODULES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "gemma2-2b": "gemma2_2b",
    "granite-3-8b": "granite_3_8b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "llama31-8b": "llama31_8b",
    "qwen25-7b": "qwen25_7b",
    "smollm-360m": "smollm_360m",
    "stablelm-3b": "stablelm_3b",
}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return reduce_for_smoke(get_config(name[: -len("-smoke")]))
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port serves {sorted(_MODULES)} and "
                       "their -smoke forms (xLSTM, encoder-decoder and vision archs: "
                       "ROADMAP queue 1, \"Other mixers, archs and tools\")")
    return import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG
