"""Architecture config registry: ``get_config(name)``; ``<name>-smoke`` gives
the reduced variant. The port registers every arch of the reference: the
dense archs (gemma2-2b with its sliding-window local layers), the MoE archs
(deepseek-moe-16b, llama4-scout-17b-a16e), the Mamba + attention + MoE hybrid
jamba-1.5-large-398b, the mLSTM + sLSTM stack xlstm-350m, the
encoder-decoder whisper-tiny and internvl2-26b, whose patch embeddings sit
ahead of the prompt. ``ASSIGNED`` and ``PAPER_MODELS`` are the reference's
arch pools, ``SHAPES`` the cost model's input shapes."""
from importlib import import_module

from repro_torch.configs.base import (  # noqa: F401
    ATTN, ATTN_LOCAL, DENSE, MAMBA, MLSTM, MOE, NONE, SLSTM,
    DECODE_32K, LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K,
    ArchConfig, FreeKVConfig, ShapeConfig, reduce_for_smoke,
)

_MODULES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "gemma2-2b": "gemma2_2b",
    "granite-3-8b": "granite_3_8b",
    "internvl2-26b": "internvl2_26b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "llama31-8b": "llama31_8b",
    "qwen25-7b": "qwen25_7b",
    "smollm-360m": "smollm_360m",
    "stablelm-3b": "stablelm_3b",
    "whisper-tiny": "whisper_tiny",
    "xlstm-350m": "xlstm_350m",
}

# the reference's arch pool (``repro/configs/__init__.py:31``): ASSIGNED are
# the archs assigned to the paper, PAPER_MODELS the models FreeKV evaluates on
ASSIGNED = (
    "deepseek-moe-16b", "xlstm-350m", "internvl2-26b", "llama4-scout-17b-a16e",
    "granite-3-8b", "whisper-tiny", "stablelm-3b", "gemma2-2b",
    "jamba-1.5-large-398b", "smollm-360m",
)
PAPER_MODELS = ("llama31-8b", "qwen25-7b")


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return reduce_for_smoke(get_config(name[: -len("-smoke")]))
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port serves {sorted(_MODULES)} and "
                       "their -smoke forms")
    return import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG


def list_archs():
    return list(_MODULES)
