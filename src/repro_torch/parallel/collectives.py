"""Gradient-compression collectives: an int8-quantized all-reduce over
``torch.distributed`` (port of ``repro.parallel.collectives``).

For the cross-replica gradient sync: quantize each tensor with a
per-tensor scale, sum the integers, dequantize.  Quantization is
deterministic (no stochastic rounding); error feedback is the caller's.
The reference's ``compressed_psum`` runs inside ``shard_map``; here
``compressed_all_reduce`` runs in every process of a process group.
The wire carries int32: ``torch.distributed`` sums in the tensor's own
dtype, and int8 would overflow where the reference upcasts at the
reduction.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_map


def int8_compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The int8-quantized sum of ``x`` over ``group``'s processes (every
    process calls it).  The scales are max-reduced first, so every
    process quantizes against the common scale and dequantizes alike."""
    _, scale = int8_compress(x)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    # requantize against the common scale so the sum is consistent
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.to(torch.float32) * scale


def compressed_grad_sync(grads, group=None):
    """The mean of a gradient tree over ``group`` with int8 compression;
    the identity without a process group or with one process."""
    if group is None or dist.get_world_size(group) == 1:
        return grads
    n = dist.get_world_size(group)
    return tree_map(lambda g: compressed_all_reduce(g, group) / n, grads)
