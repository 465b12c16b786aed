"""Architecture config registry: ``get_config(name)`` / ``ARCH_NAMES``.

Only the families the port serves are registered; the reference's two
frontend archs raise ``NotImplementedError`` until their model code
arrives (ROADMAP A9c)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    AnalogConfig,
    ArchConfig,
    MoEConfig,
    ParallelConfig,
    RGLRUConfig,
    SSMConfig,
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
}
# the reference's archs whose model code is not ported yet, with what each
# lacks (ROADMAP A9c)
_NOT_PORTED = {
    "internvl2-76b": "the vision frontend",
    "seamless-m4t-large-v2": "the audio frontend, the encoder and the "
                             "decoder's cross-attention",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} needs {_NOT_PORTED[name]}, not ported yet "
            "(ROADMAP A9c: the frontend archs)")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port serves "
                       f"{sorted(_MODULES)} (frontend archs: ROADMAP A9c)")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
