"""The nonlinear crossbar MAC: a CUDA C++ kernel for Hopper and its plain
PyTorch version.

``xbar_mac_cuda`` replaces the JAX package's
``kernels/xbar_mac/xbar_mac.py:xbar_mac_pallas`` (``csrc/xbar_mac.cu``):
``v_sat * tanh(gain * (relu(v - v_th) * (1 + beta*v)) @ g / v_sat)`` with
v widened to float32 before the prologue, float32 accumulation and the
output in v's dtype.  ``xbar_mac_plain`` is the same function in plain
PyTorch.  The source is built by ``kernels._build``; nothing is compiled
or loaded at import time.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "xbar_mac.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB: dict = {}


def _library():
    if "fn" not in _LIB:
        fn = _build.load(SOURCE).xbar_mac
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 3 + [ctypes.c_float] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB["fn"] = fn
    return _LIB["fn"]


def xbar_mac_plain(v: torch.Tensor, g: torch.Tensor, *, v_th: float = 0.08,
                   beta: float = 0.6, gain: float = 3200.0,
                   v_sat: float = 1.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch.  v: (B, K); g: (K, N) ->
    (B, N) in v's dtype."""
    vf = v.float()
    drive = torch.clamp_min(vf - v_th, 0.0) * (1.0 + beta * vf)
    acc = drive @ g.float()
    return (v_sat * torch.tanh(gain * acc / v_sat)).to(v.dtype)


def xbar_mac_cuda(v: torch.Tensor, g: torch.Tensor, *, v_th: float = 0.08,
                  beta: float = 0.6, gain: float = 3200.0,
                  v_sat: float = 1.0) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on anything it does not
    take.  v: (B, K), g: (K, N), both float32 or both bfloat16, contiguous,
    on one card -> (B, N) in v's dtype."""
    if v.device.type != "cuda":
        raise ValueError("xbar_mac_cuda takes CUDA tensors (got "
                         f"{v.device}); CPU tensors go to the plain version")
    if g.device != v.device:
        raise ValueError(f"g is on {g.device}, v on {v.device}")
    if v.dim() != 2 or g.dim() != 2 or v.shape[1] != g.shape[0]:
        raise ValueError(f"v must be (B, K) and g (K, N); got {tuple(v.shape)} "
                         f"and {tuple(g.shape)}")
    if v.dtype not in _DTYPES or g.dtype != v.dtype:
        raise TypeError("v and g must both be float32 or both bfloat16 (got "
                        f"{v.dtype}, {g.dtype})")
    if not (v.is_contiguous() and g.is_contiguous()):
        raise ValueError("v and g must be contiguous")
    B, K = v.shape
    N = g.shape[1]
    if max(B, K, N) >= 2 ** 31 or -(-B // 64) > 65535:
        raise ValueError(f"shape ({B}, {K}) @ ({K}, {N}) exceeds the grid")
    out = torch.empty((B, N), dtype=v.dtype, device=v.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(v.device).cuda_stream
    _build.launched(_library()(_DTYPES[v.dtype], v.data_ptr(), g.data_ptr(),
                               out.data_ptr(), B, K, N, v_th, beta, gain,
                               v_sat, stream), "xbar_mac")
    xbar_mac_cuda.launches += 1
    return out


xbar_mac_cuda.launches = 0
