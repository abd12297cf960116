"""Architecture config registry: ``get_config(name)``; ``<name>-smoke`` gives
the reduced variant. Only the dense archs the port serves are registered."""
from importlib import import_module

from repro_torch.configs.base import (  # noqa: F401
    ATTN, ATTN_LOCAL, DENSE, MAMBA, MLSTM, MOE, NONE, SLSTM,
    ArchConfig, FreeKVConfig, reduce_for_smoke,
)

_MODULES = {
    "granite-3-8b": "granite_3_8b",
    "llama31-8b": "llama31_8b",
}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return reduce_for_smoke(get_config(name[: -len("-smoke")]))
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port serves {sorted(_MODULES)} "
                       "(other archs: ROADMAP queue 1, item 9)")
    return import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG
