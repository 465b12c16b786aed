"""Public entry point of the linear-scan kernel (port of the JAX package's
``kernels/linear_scan/ops.py``), with its gradient.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain version; any other device raises.  The
scan is differentiable: ``_LinearScan`` runs the forward as one launch
and its backward as one more launch of the same kernel on reversed
inputs (the reference differentiates its associative scan; its Pallas
kernel has no backward)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import on_cuda
from repro_torch.kernels.linear_scan.linear_scan import (
    fold_h0, linear_scan_cuda, linear_scan_plain)


def _scan(a: torch.Tensor, b: torch.Tensor,
          b0: Optional[torch.Tensor]) -> torch.Tensor:
    if on_cuda(a, "linear_scan"):
        return linear_scan_cuda(a, b, b0)
    return linear_scan_plain(a, b, b0)


def reverse_inputs(a: torch.Tensor, gh: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward's scan inputs: with G = dL/dh, the adjoint
    ``g_t = G_t + a_{t+1} g_{t+1}`` is the forward recurrence run from the
    end, on ``flip(cat(a[:, 1:], 0))`` and ``flip(G)``."""
    a_next = torch.cat([a[:, 1:], a.new_zeros((a.shape[0], 1, a.shape[2]))],
                       dim=1)
    return a_next.flip(1), gh.to(a.dtype).flip(1)


class _LinearScan(torch.autograd.Function):
    """``h = scan(a, b, b0)`` with its adjoint on the same kernel.

    Backward, G = dL/dh (dL/dh_last is already in its last row: h_last is
    a view of h): ``g = flip(scan(reverse_inputs(a, G)))``, then
    ``db_t = g_t`` and ``da_t = g_t * h_{t-1}`` with h_{-1} = 0.  Where
    ``b0`` stands in for ``b[:, 0]``, ``db[:, 0]`` is zero and
    ``db0 = g_0``; the h0 fold that made b0 stays outside, in tracked
    ops, so autograd adds ``g_0 * h0`` to ``da_0`` and gives
    ``dh0 = a_0 * g_0``.  The flips cost three passes over (B, S, D)
    beside the launch (ROADMAP Queue B, B6: a reverse mode in the
    kernel)."""

    @staticmethod
    def forward(ctx, a, b, b0):
        h = _scan(a, b, b0)
        ctx.save_for_backward(a, h)
        ctx.has_b0 = b0 is not None
        return h

    @staticmethod
    def backward(ctx, gh):
        a, h = ctx.saved_tensors
        ar, gr = reverse_inputs(a, gh)
        g = _scan(ar, gr, None).flip(1)
        da = db = db0 = None
        if ctx.needs_input_grad[0]:
            da = torch.zeros_like(g)
            da[:, 1:] = g[:, 1:] * h[:, :-1]
        if ctx.needs_input_grad[1]:
            db = g
            if ctx.has_b0:
                db = g.clone()
                db[:, 0] = 0
        if ctx.has_b0 and ctx.needs_input_grad[2]:
            db0 = g[:, 0]
        return da, db, db0


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None, *, block_d: int = 512,
                block_s: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t * h_{t-1} + b_t``.  a, b: (B, S, D); h0: (B, D) or None.
    Returns ``(h, h[:, -1])``, h in a's dtype; differentiable in a, b and
    h0 (``_LinearScan``).

    h0 is folded exactly into the first step, in b's dtype, as the
    reference does (``b[:, 0] + a[:, 0] * h0``); the folded row is handed
    to the kernel beside b, so b is not copied.  ``block_d``/``block_s``
    are the TPU kernel's tile sizes, accepted for the reference's
    signature.  Neither version reads them: the CUDA kernel sizes its own
    column tiles and ring of stages (``launch_plan``), and the result
    does not depend on the tiling."""
    b0 = None if h0 is None else fold_h0(a, b, h0)
    h = _LinearScan.apply(a, b, b0)
    return h, h[:, -1]
