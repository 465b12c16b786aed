"""Dispatcher for the emulator serving math (port of
``repro.kernels.emulator_block.ops.emulator_block_unified``).

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain version.  There is no fallback from one
to the other.  Block sizes come from fixed heuristics (the autotuner is
ROADMAP A4)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.emulator_block.emulator_block import (
    emulator_block_unified_cuda, emulator_block_unified_plain)


def emulator_block_unified(aux: dict, pre: dict, u01: torch.Tensor,
                           pos01: torch.Tensor, *,
                           shift: Optional[torch.Tensor] = None,
                           chunk: Optional[int] = None) -> torch.Tensor:
    """Both rails of every (row, crossbar block) pair, every corner.

    ``shift`` is the fc0 epilogue (``sfeat @ aux["f0_scen"]``; None at the
    ideal corner of a plain net); ``chunk`` is the plain version's row
    chunk.  Returns (2, M*NB*NO, O)."""
    if u01.device.type == "cuda":
        return emulator_block_unified_cuda(aux, pre, u01, pos01, shift=shift)
    if u01.device.type != "cpu":
        raise ValueError(f"no emulator kernel for device {u01.device}")
    return emulator_block_unified_plain(aux, pre, u01, pos01, shift=shift,
                                        chunk=2 if chunk is None else chunk)
