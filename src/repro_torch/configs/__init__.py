"""Architecture config registry: ``get_config(name)`` / ``ARCH_NAMES``
(every arch of the reference's registry)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    AnalogConfig,
    ArchConfig,
    MoEConfig,
    ParallelConfig,
    RGLRUConfig,
    SHAPES,
    SHAPES_BY_NAME,
    SSMConfig,
    ShapeConfig,
    TrainConfig,
    reduced,
    with_depth,
)

_MODULES = {
    "gemma3-1b": "gemma3_1b",
    "qwen1.5-110b": "qwen15_110b",
    "command-r-plus-104b": "command_r_plus_104b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "llama4-scout-17b-a16e": "llama4_scout",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "internvl2-76b": "internvl2_76b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
