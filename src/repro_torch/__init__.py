"""PyTorch/CUDA port of the SEMULATOR analog serving system.

The JAX package ``repro`` is the reference; this package mirrors its
subpackage layout (``configs``, ``core``, ``kernels``, ``models``,
``runtime``, ``launch``) so each module has one counterpart there.  It
imports ``torch`` and numpy only -- never ``jax`` and nothing of
``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the tests do); with no GPU and no explicit request they raise instead
of quietly running on the CPU (``resolve_device``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU
    only when asked for explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


def dtype_of(name: Optional[str]) -> torch.dtype:
    """``"bfloat16"``/``"float32"`` (the config spelling) -> torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            None: torch.float32}[name]
