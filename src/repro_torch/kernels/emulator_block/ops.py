"""Dispatchers for the emulator's block evaluators (port of
``repro.kernels.emulator_block.ops``).

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain version; any other device raises.  There
is no fallback from one to the other.  B1's row tile on the card and its
plain version's row chunk on the CPU come from the autotuner
(``kernels.autotune``) where sweeping is on, else from their defaults; B2
and B3 keep their fixed tile rules, as in the reference."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.rram_ps32 import BlockGeometry
from repro_torch.kernels import autotune
from repro_torch.kernels._build import on_cuda
from repro_torch.kernels.emulator_block.emulator_block import (
    default_block_m, emulator_block_cuda, emulator_block_grid_cuda,
    emulator_block_grid_plain, emulator_block_plain,
    emulator_block_unified_cuda, emulator_block_unified_plain)

# the reference's candidates: B1's row tile, the plain version's row chunk
BLOCK_M_CANDIDATES = (16, 32, 64, 128, 256)
CHUNK_CANDIDATES = (1, 2, 4, 8)
DEFAULT_CHUNK = 2


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


def block_m_candidates(M: int) -> tuple:
    """B1's row tiles a sweep at ``M`` rows times: the reference's
    candidates, and the default (``default_block_m``) where it is none of
    them, so a sweep can keep it."""
    d = default_block_m(M)
    return BLOCK_M_CANDIDATES + (() if d in BLOCK_M_CANDIDATES else (d,))


def unified_key(aux: dict, g_norm: torch.Tensor, u01: torch.Tensor,
                shift: Optional[torch.Tensor], compute_dtype) -> tuple:
    """The autotuner's key of one B1 call: its shapes, the shift's kind
    and the mode."""
    M = u01.shape[0]
    NB, NO, D, H, W = g_norm.shape
    k1, C0, _ = aux["w1k"].shape
    n_out = aux["fcs"][-1][0].shape[1]
    sh = "none" if shift is None else ("block" if shift.dim() == 2 else "flat")
    return (M, NB, NO, D, H, W, k1, C0, n_out, sh,
            str(compute_dtype).replace("torch.", ""))


def emulator_block_unified(aux: dict, g_norm: torch.Tensor,
                           u01: torch.Tensor, pos01: torch.Tensor, *,
                           shift: Optional[torch.Tensor] = None,
                           chunk: Optional[int] = None,
                           block_m: Optional[int] = None,
                           tune: bool = True,
                           compute_dtype=torch.float32) -> torch.Tensor:
    """Both rails of every (row, crossbar block) pair, every corner (B1).

    ``g_norm`` is the plan's (NB, NO, D, H, W) normalized conductances;
    the per-plan precompute is built from it inside the kernel (both
    modes) or by the plain version (CPU).  ``shift`` is the fc0 epilogue
    (``sfeat @ aux["f0_scen"]``; None at the ideal corner of a plain
    net).  ``block_m`` is the kernel's row tile, ``chunk`` the plain
    version's row chunk; left as None, each is resolved by the autotuner
    (``"emulator_unified"`` over ``block_m_candidates``, default
    ``default_block_m``; ``"blocklast_chunk"`` over ``CHUNK_CANDIDATES``,
    default 2), or, with ``tune=False``, set to its default directly --
    the executor's sharded forward evaluates lattice windows the tuner
    never measured.  The choice schedules the work only: the outputs are
    the same bits under every tile and chunk.
    ``compute_dtype=torch.bfloat16`` is the reference kernel's bf16 mode
    (bf16 GEMM operands, float32 accumulation), on the card and on the
    CPU alike; the reference dispatcher's XLA route ignores
    ``compute_dtype``, this one does not.  Returns (2, M*NB*NO, O)
    float32."""
    if _on_cuda(u01):
        if block_m is None and tune:
            block_m = autotune.best_config(
                "emulator_unified",
                unified_key(aux, g_norm, u01, shift, compute_dtype),
                [{"block_m": b} for b in block_m_candidates(u01.shape[0])],
                lambda cfg: emulator_block_unified_cuda(
                    aux, g_norm, u01, pos01, shift=shift,
                    block_m=cfg["block_m"], compute_dtype=compute_dtype),
                {"block_m": default_block_m(u01.shape[0])},
                device=u01.device)["block_m"]
        return emulator_block_unified_cuda(aux, g_norm, u01, pos01,
                                           shift=shift, block_m=block_m,
                                           compute_dtype=compute_dtype)
    if chunk is None and tune:
        chunk = autotune.best_config(
            "blocklast_chunk",
            unified_key(aux, g_norm, u01, shift, compute_dtype),
            [{"chunk": c} for c in CHUNK_CANDIDATES],
            lambda cfg: emulator_block_unified_plain(
                aux, g_norm, u01, pos01, shift=shift, chunk=cfg["chunk"],
                compute_dtype=compute_dtype),
            {"chunk": DEFAULT_CHUNK}, device=u01.device)["chunk"]
    return emulator_block_unified_plain(
        aux, g_norm, u01, pos01, shift=shift,
        chunk=DEFAULT_CHUNK if chunk is None else chunk,
        compute_dtype=compute_dtype)
