"""Online-softmax (flash) attention: a CUDA C++ kernel for Hopper and its
plain PyTorch version.

``flash_attention_cuda`` replaces the JAX package's
``kernels/flash_attention/flash_attention.py:flash_attention_pallas``
(``csrc/flash_attention.cu``); ``flash_attention_plain`` is the same
blockwise online softmax in plain PyTorch.  Both follow the reference
kernel's numerics: q widened to float32 and scaled before the q.k^T
product, the finite mask value ``NEG_INF``, a float32 running max, sum
and accumulator, p rounded to v's dtype before the p.v product, and a
final division by ``max(l, 1e-20)``.  q/k/v: (BH, S, D); the output is in
v's dtype.  The source is built by ``kernels._build``; nothing is
compiled or loaded at import time.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
NEG_INF = -1e30
MAX_D = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB: dict = {}


def _library():
    if "lib" not in _LIB:
        lib = _build.load(SOURCE)
        lib.flash_attention.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
            + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int]
        for f in (lib.flash_attention, lib.flash_attention_smem_bytes):
            f.restype = ctypes.c_int
        _LIB["lib"] = lib
    return _LIB["lib"]


def smem_bytes(D: int) -> int:
    """Dynamic shared memory one thread block takes at head dim D, as the
    compiled library reckons it; builds the library if needed."""
    return int(_library().flash_attention_smem_bytes(D))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          block_kv: int = 128) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the online softmax over KV
    tiles of ``block_kv`` keys, every tile in order (a fully masked tile
    included, as in the reference kernel), all query rows at once.
    q/k/v: (BH, S, D) -> (BH, S, D) in v's dtype, scaled by D**-0.5."""
    BH, S, D = q.shape
    bk = min(block_kv, S)
    qf = q.float() * D ** -0.5
    m = torch.full((BH, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((BH, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((BH, S, D), dtype=torch.float32, device=q.device)
    q_pos = torch.arange(S, device=q.device)[:, None]
    for k0 in range(0, S, bk):
        k1 = min(S, k0 + bk)
        s = qf @ k[:, k0:k1].float().transpose(1, 2)          # (BH, S, bk)
        k_pos = torch.arange(k0, k1, device=q.device)[None, :]
        mask = torch.ones((S, k1 - k0), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window:
            mask &= (q_pos - k_pos) < window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        m = m_new
        pv = p.to(v.dtype).float() @ v[:, k0:k1].float()
        acc = acc * alpha[..., None] + pv
    return (acc / l.clamp_min(1e-20)[..., None]).to(v.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on anything it does not
    take.  q/k/v: (BH, S, D), one shape, all float32 or all bfloat16,
    contiguous, on one card, 1 <= D <= 256, window >= 0 -> (BH, S, D) in
    v's dtype, scaled by D**-0.5."""
    if q.device.type != "cuda":
        raise ValueError("flash_attention_cuda takes CUDA tensors (got "
                         f"{q.device}); CPU tensors go to the plain version")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must be one (BH, S, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError("q, k and v must all be float32 or all bfloat16 "
                            f"(got {name} {t.dtype}, q {q.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    BH, S, D = q.shape
    if not 1 <= D <= MAX_D:
        raise ValueError(f"head dim {D} outside the kernel's 1..{MAX_D}")
    if window < 0:
        raise ValueError(f"window must be >= 0 (got {window})")
    if BH >= 2 ** 31 or S >= 2 ** 31 or -(-S // 64) > 65535:
        raise ValueError(f"shape {(BH, S, D)} exceeds the grid")
    out = torch.empty_like(v)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launched(_library().flash_attention(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), BH, S, D, D ** -0.5, int(bool(causal)), int(window),
        stream), "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
