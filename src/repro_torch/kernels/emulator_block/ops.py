"""Dispatchers for the emulator's block evaluators (port of
``repro.kernels.emulator_block.ops``).

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain version; any other device raises.  There
is no fallback from one to the other.  Block sizes come from fixed
heuristics (the autotuner is ROADMAP A4)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.rram_ps32 import BlockGeometry
from repro_torch.kernels._build import on_cuda
from repro_torch.kernels.emulator_block.emulator_block import (
    emulator_block_cuda, emulator_block_grid_cuda, emulator_block_grid_plain,
    emulator_block_plain, emulator_block_unified_cuda,
    emulator_block_unified_plain)


def _on_cuda(t: torch.Tensor) -> bool:
    return on_cuda(t, "emulator")


def emulator_block(params: dict, x: torch.Tensor,
                   periph: Optional[torch.Tensor], geom: BlockGeometry, *,
                   block_n: Optional[int] = None) -> torch.Tensor:
    """Paper-faithful Conv4Xbar forward (B2).  x: (N, 2, D, H, W)
    normalized features; periph: (N, P) or None for a net without
    periph rows; -> (N, O)."""
    if _on_cuda(x):
        return emulator_block_cuda(params, x, periph, geom, block_n=block_n)
    return emulator_block_plain(params, x, periph)


def emulator_block_grid(params: dict, v01: torch.Tensor, g_norm: torch.Tensor,
                        geom: BlockGeometry, *,
                        block_m: Optional[int] = None) -> torch.Tensor:
    """Batched serving variant (B3).  v01: (M, NB, D, H) normalized
    voltages; g_norm: (NB*NO, D, H, W) shared normalized conductance
    features; the periph is the constant (1, 0, ...); -> (M, NB*NO, O)."""
    if _on_cuda(v01):
        return emulator_block_grid_cuda(params, v01, g_norm, geom,
                                        block_m=block_m)
    return emulator_block_grid_plain(params, v01, g_norm, geom)


def emulator_block_unified(aux: dict, pre: dict, u01: torch.Tensor,
                           pos01: torch.Tensor, *,
                           shift: Optional[torch.Tensor] = None,
                           chunk: Optional[int] = None,
                           compute_dtype=torch.float32) -> torch.Tensor:
    """Both rails of every (row, crossbar block) pair, every corner (B1).

    ``shift`` is the fc0 epilogue (``sfeat @ aux["f0_scen"]``; None at the
    ideal corner of a plain net); ``chunk`` is the plain version's row
    chunk.  ``compute_dtype=torch.bfloat16`` is the reference kernel's
    bf16 mode (bf16 GEMM operands, float32 accumulation), on the card and
    on the CPU alike; the reference dispatcher's XLA route ignores
    ``compute_dtype``, this one does not.  Returns (2, M*NB*NO, O)
    float32."""
    if _on_cuda(u01):
        return emulator_block_unified_cuda(aux, pre, u01, pos01, shift=shift,
                                           compute_dtype=compute_dtype)
    return emulator_block_unified_plain(aux, pre, u01, pos01, shift=shift,
                                        chunk=2 if chunk is None else chunk,
                                        compute_dtype=compute_dtype)
