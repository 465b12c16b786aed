"""Parameter init and the serving step factories (port of the serving part
of ``repro.runtime.steps``; training comes with ROADMAP A13)."""
from __future__ import annotations

import torch

from repro_torch import DeviceLike, dtype_of
from repro_torch.configs.base import ArchConfig, ParallelConfig
from repro_torch.models import model as M
from repro_torch.models.common import init_params


def compute_dtype_of(pcfg: ParallelConfig) -> torch.dtype:
    return dtype_of(pcfg.compute_dtype)


def init_model_params(seed: int, cfg: ArchConfig, device: DeviceLike = None,
                      dtype=torch.float32):
    """The model's parameters from ``seed`` (``models.common.init_params``)."""
    return init_params(seed, M.model_schema(cfg), dtype=dtype, device=device)


def make_prefill_step(cfg: ArchConfig, pcfg: ParallelConfig):
    cdt = compute_dtype_of(pcfg)

    def prefill_step(params, batch):
        return M.prefill(params, batch["tokens"], cfg=cfg, pcfg=pcfg,
                         compute_dtype=cdt)

    return prefill_step


def make_decode_step(cfg: ArchConfig, pcfg: ParallelConfig):
    cdt = compute_dtype_of(pcfg)

    def decode_step(params, token, cache, pos):
        return M.decode_step(params, token, cache, pos, cfg=cfg, pcfg=pcfg,
                             compute_dtype=cdt)

    return decode_step
