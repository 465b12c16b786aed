"""The diagonal gated linear recurrence: a CUDA C++ kernel for Hopper and
its plain PyTorch version.

``linear_scan_cuda`` replaces the JAX package's
``kernels/linear_scan/linear_scan.py:linear_scan_pallas``
(``csrc/linear_scan.cu``): ``h_t = a_t * h_{t-1} + b_t`` over (B, S, D)
with a float32 carry and h in a's dtype.  ``linear_scan_plain`` is the
same recurrence as a sequential loop over S in plain PyTorch.  Both take
an optional first row ``b0`` (B, D) that stands in for ``b[:, 0]``.  The
source is built by ``kernels._build``; nothing is compiled or loaded at
import time.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "linear_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB: dict = {}


def _library():
    if "fn" not in _LIB:
        fn = _build.load(SOURCE).linear_scan
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB["fn"] = fn
    return _LIB["fn"]


def fold_h0(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
            ) -> torch.Tensor:
    """The first row that carries an initial state h0 (B, D) exactly:
    ``b[:, 0] + a[:, 0] * h0`` in b's dtype, each operation rounded there
    as the reference's in-place add rounds it."""
    return (b[:, 0] + (a[:, 0] * h0.to(b.dtype)).to(b.dtype)).contiguous()


def linear_scan_plain(a: torch.Tensor, b: torch.Tensor,
                      b0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a float32 carry stepped
    through S in order, each step's h rounded to a's dtype.  a, b: (B, S,
    D); b0: (B, D) or None -> h (B, S, D)."""
    h = torch.empty_like(a)
    carry = torch.zeros(a.shape[::2], dtype=torch.float32, device=a.device)
    for t in range(a.shape[1]):
        bt = b0 if t == 0 and b0 is not None else b[:, t]
        carry = a[:, t].float() * carry + bt.float()
        h[:, t] = carry.to(a.dtype)
    return h


def linear_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                     b0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on anything it does not
    take.  a, b: (B, S, D) and b0: (B, D) or None, all float32 or all
    bfloat16, contiguous, on one card -> h (B, S, D) in a's dtype."""
    if a.device.type != "cuda":
        raise ValueError("linear_scan_cuda takes CUDA tensors (got "
                         f"{a.device}); CPU tensors go to the plain version")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"a and b must both be (B, S, D); got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    B, S, D = a.shape
    ts = [("a", a), ("b", b)] + ([("b0", b0)] if b0 is not None else [])
    if b0 is not None and tuple(b0.shape) != (B, D):
        raise ValueError(f"b0 must be {(B, D)}; got {tuple(b0.shape)}")
    for name, t in ts:
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if t.dtype not in _DTYPES or t.dtype != a.dtype:
            raise TypeError("a, b and b0 must all be float32 or all bfloat16 "
                            f"(got {name} {t.dtype}, a {a.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(B, S, D) >= 2 ** 31 or -(-B * D // 128) >= 2 ** 31:
        raise ValueError(f"shape {(B, S, D)} exceeds the grid")
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _build.launched(_library()(
        _DTYPES[a.dtype], a.data_ptr(), b.data_ptr(),
        0 if b0 is None else b0.data_ptr(), h.data_ptr(), B, S, D, stream),
        "linear_scan")
    linear_scan_cuda.launches += 1
    return h


linear_scan_cuda.launches = 0
