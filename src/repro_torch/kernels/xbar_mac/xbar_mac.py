"""The nonlinear crossbar MAC: a CUDA C++ kernel for Hopper and its plain
PyTorch version.

``xbar_mac_cuda`` replaces the JAX package's
``kernels/xbar_mac/xbar_mac.py:xbar_mac_pallas`` (``csrc/xbar_mac.cu``, a
tensor-core GEMM: bf16 ``mma.sync`` for bf16 inputs, 3xTF32 for float32
ones, K split across blocks where the output tiles alone would not fill
the card): ``v_sat * tanh(gain * (relu(v - v_th) * (1 + beta*v)) @ g /
v_sat)`` with v widened to float32 before the prologue, float32
accumulation and the output in v's dtype.  In bf16 the drive is rounded
to bf16 before the product, so that the product runs on the bf16 tensor
cores; before the output's own rounding that moves results by well under
one bf16 ulp of the output (``tests/test_torch_xbar_mac.py``).
``xbar_mac_plain`` is the same function in plain PyTorch.  The source is
built by ``kernels._build``; nothing is compiled or loaded at import
time.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "xbar_mac.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB: dict = {}
_COUNTERS: dict = {}


def _library():
    if "lib" not in _LIB:
        lib = _build.load(SOURCE)
        lib.xbar_mac.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                                 + [ctypes.c_int] * 3 + [ctypes.c_float] * 4
                                 + [ctypes.c_void_p] * 3)
        lib.xbar_mac.restype = ctypes.c_int
        lib.xbar_mac_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.xbar_mac_plan.restype = None
        _LIB["lib"] = lib
    return _LIB["lib"]


@functools.lru_cache(maxsize=1024)
def launch_plan(B: int, K: int, N: int) -> dict:
    """The kernel's launch plan at this shape, as the compiled library
    picks it: output tile, tiles along B and N, and the split of K;
    builds the library if needed."""
    out = (ctypes.c_int * 6)()
    _library().xbar_mac_plan(B, K, N, ctypes.addressof(out))
    return dict(zip(("tile_b", "tile_n", "tiles_b", "tiles_n", "splits",
                     "k_per_split"), out))


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """A zeroed int32 counter per output tile, kept per (card, stream):
    the kernel sets each back to 0, and calls on one stream run in order."""
    key = (device, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def xbar_mac_plain(v: torch.Tensor, g: torch.Tensor, *, v_th: float = 0.08,
                   beta: float = 0.6, gain: float = 3200.0,
                   v_sat: float = 1.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch.  v: (B, K); g: (K, N) ->
    (B, N) in v's dtype.  In bf16 the float32 drive is rounded to bf16
    before the product, as the kernel feeds it to the bf16 tensor cores."""
    vf = v.float()
    drive = torch.clamp_min(vf - v_th, 0.0) * (1.0 + beta * vf)
    if v.dtype == torch.bfloat16:
        drive = drive.to(torch.bfloat16).float()
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
    if max(B, K, N) >= 2 ** 31 or -(-B // 16) > 65535 or B * N >= 2 ** 31:
        raise ValueError(f"shape ({B}, {K}) @ ({K}, {N}) exceeds the grid")
    out = torch.empty((B, N), dtype=v.dtype, device=v.device)
    if out.numel() == 0:
        return out
    plan = launch_plan(B, K, N)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    # held until the launch is queued: the caching allocator may hand a
    # freed block to the next allocation on this stream
    partial = counters = None
    if plan["splits"] > 1:
        partial = torch.empty((plan["splits"], B, N), dtype=torch.float32,
                              device=v.device)
        counters = _counters(v.device, stream, plan["tiles_b"] * plan["tiles_n"])
    _build.launched(_library().xbar_mac(
        _DTYPES[v.dtype], v.data_ptr(), g.data_ptr(), out.data_ptr(), B, K, N,
        v_th, beta, gain, v_sat, None if partial is None else partial.data_ptr(),
        None if counters is None else counters.data_ptr(), stream), "xbar_mac")
    xbar_mac_cuda.launches += 1
    return out


xbar_mac_cuda.launches = 0
