"""Public entry point of the linear-scan kernel (port of the JAX package's
``kernels/linear_scan/ops.py``).

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain version; any other device raises."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import on_cuda
from repro_torch.kernels.linear_scan.linear_scan import (
    fold_h0, linear_scan_cuda, linear_scan_plain)


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None, *, block_d: int = 512,
                block_s: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t * h_{t-1} + b_t``.  a, b: (B, S, D); h0: (B, D) or None.
    Returns ``(h, h[:, -1])``, h in a's dtype.

    h0 is folded exactly into the first step, in b's dtype, as the
    reference does (``b[:, 0] + a[:, 0] * h0``); the folded row is handed
    to the kernel beside b, so b is not copied.  ``block_d``/``block_s``
    are the TPU kernel's tile sizes, accepted for the reference's
    signature.  Neither version reads them: the CUDA kernel sizes its own
    column tiles and ring of stages (``launch_plan``), and the result
    does not depend on the tiling."""
    b0 = None if h0 is None else fold_h0(a, b, h0)
    if on_cuda(a, "linear_scan"):
        h = linear_scan_cuda(a, b, b0)
    else:
        h = linear_scan_plain(a, b, b0)
    return h, h[:, -1]
