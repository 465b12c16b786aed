"""Architecture config registry: ``get_config(name)`` / ``ARCH_NAMES``.

Only the families the port serves are registered; the reference's other
archs raise ``NotImplementedError`` until their model code arrives
(ROADMAP A9)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    AnalogConfig,
    ArchConfig,
    ParallelConfig,
    RGLRUConfig,
    SSMConfig,
    TrainConfig,
    reduced,
    with_depth,
)

_MODULES = {
    "gemma3-1b": "gemma3_1b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "falcon-mamba-7b": "falcon_mamba_7b",
}
# the reference's archs whose model code is not ported yet, with what each
# lacks (ROADMAP A9)
_NOT_PORTED = {
    "qwen1.5-110b": "qkv bias",
    "command-r-plus-104b": "layernorm and the parallel block",
    "phi3.5-moe-42b-a6.6b": "layernorm and mixture of experts",
    "llama4-scout-17b-a16e": "mixture of experts and chunked attention",
    "internvl2-76b": "the vision frontend",
    "seamless-m4t-large-v2": "layernorm, the audio frontend and the encoder",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} needs {_NOT_PORTED[name]}, not ported yet "
            "(ROADMAP A9: the other families)")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port serves "
                       f"{sorted(_MODULES)} (other families: ROADMAP A9)")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
