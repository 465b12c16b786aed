"""Architecture config registry: ``get_config(name)`` / ``ARCH_NAMES``.

Only the families the port serves are registered; the others arrive
with their model code (ROADMAP A9)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    AnalogConfig,
    ArchConfig,
    ParallelConfig,
    reduced,
    with_depth,
)

_MODULES = {
    "gemma3-1b": "gemma3_1b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port serves "
                       f"{sorted(_MODULES)} (other families: ROADMAP A9)")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
