"""The diagonal gated linear recurrence: a CUDA C++ kernel for Hopper and
its plain PyTorch version.

``linear_scan_cuda`` replaces the JAX package's
``kernels/linear_scan/linear_scan.py:linear_scan_pallas``
(``csrc/linear_scan.cu``): ``h_t = a_t * h_{t-1} + b_t`` over (B, S, D)
with a float32 carry and h in a's dtype.  ``linear_scan_plain`` is the
same recurrence as a sequential loop over S in plain PyTorch; the kernel
steps each lane in the same order and is bit for bit equal to it.  Both
take an optional first row ``b0`` (B, D) that stands in for ``b[:, 0]``.
``launch_plan`` sizes the kernel's column tiles and its ring of stages
from the shape.  The source is built by ``kernels._build``; nothing is
compiled or loaded at import time.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Callable, Optional

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "linear_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB: dict = {}
# the launch plan's targets: bytes of a and b in flight on the card (at
# ~0.7 us of loaded latency, 3.35 TB/s asks for ~2.3 MB), the largest ring
# a thread block may hold, the ring's depth, and what an H100 SM offers a
# thread block of the kernel's 64 threads (228 KB of shared memory, 1 KB
# of it reserved per block; at most 32 blocks)
IN_FLIGHT = 3 << 20
RING_MAX = 48 << 10
STAGES = 4
RING_OFFSET = 128           # the kernel's mbarriers, before the ring
SMEM_PER_SM, SMEM_PER_BLOCK, BLOCKS_PER_SM = 228 << 10, 1 << 10, 32


def _library():
    if "fn" not in _LIB:
        lib = _build.load(SOURCE)
        fn = lib.linear_scan
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.linear_scan_resident.argtypes = [ctypes.c_int] * 2
        lib.linear_scan_resident.restype = ctypes.c_int
        _LIB["fn"], _LIB["resident"] = fn, lib.linear_scan_resident
    return _LIB["fn"]


def ring_bytes(C: int, R: int, K: int, itemsize: int,
               aligned: bool = True) -> int:
    """The kernel's dynamic shared memory: its mbarriers, then K stages of
    a tile of a and one of b, R rows each, padded to 128 B.  A row holds C
    lanes, and 16 B more where rows are not 16-byte aligned (``aligned``
    false), which arrive as the 16-byte chunks that hold them."""
    row = C * itemsize + (0 if aligned else 16)
    return RING_OFFSET + K * 2 * (-(-R * row // 128) * 128)


def _resident_model(nbytes: int) -> int:
    return min(BLOCKS_PER_SM, SMEM_PER_SM // (nbytes + SMEM_PER_BLOCK))


def launch_plan(B: int, D: int, itemsize: int, n_sm: int,
                per_sm: Optional[Callable[[int], int]] = None) -> dict:
    """The kernel's launch plan for B x D lanes: C lanes a column tile (one
    batch row's d0 .. d0+C-1), R rows a stage, K stages in the ring.  The
    sequence length only sets the stages a thread block walks.

    C is a multiple of 16 B / itemsize (a row of a tile, which the tensor
    copies need), at most 32 times that (16 B for each of the consumer
    warp's threads): the widest that still gives the grid of
    B * ceil(D / C) thread blocks two for each of the ``n_sm`` SMs, or the
    narrowest where none does.  R doubles from 4 up to 64 until the
    resident thread blocks' rings hold ``IN_FLIGHT`` bytes beyond the
    stage each is stepping, within ``RING_MAX`` a thread block.
    ``per_sm(bytes)`` is the thread blocks an SM keeps resident with that
    much dynamic shared memory (on the card, the runtime's occupancy; by
    default an H100's limits)."""
    V = 16 // itemsize
    C = 32 * V
    while C > V and B * -(-D // C) < 2 * n_sm:
        C //= 2
    blocks = B * -(-D // C)
    per_sm = per_sm or _resident_model
    row = 2 * C * itemsize
    aligned = D * itemsize % 16 == 0

    def smem(R):
        return ring_bytes(C, R, STAGES, itemsize, aligned)

    def in_flight(R):
        return min(blocks, n_sm * per_sm(smem(R))) * (STAGES - 1) * R * row

    R = 4
    while R < 64 and smem(2 * R) <= RING_MAX and in_flight(R) < IN_FLIGHT:
        R *= 2
    return dict(C=C, R=R, K=STAGES, blocks=blocks, smem=smem(R))


@functools.lru_cache(maxsize=256)
def _card_plan(B: int, D: int, itemsize: int, index: int) -> dict:
    """``launch_plan`` for card ``index``: its SM count and the runtime's
    occupancy of the kernel."""
    _library()
    dtype = 0 if itemsize == 4 else 1
    with torch.cuda.device(index):
        n_sm = torch.cuda.get_device_properties(index).multi_processor_count
        return launch_plan(B, D, itemsize, n_sm,
                           lambda nbytes: max(1, _LIB["resident"](dtype, nbytes)))


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


def check_inputs(a: torch.Tensor, b: torch.Tensor,
                 b0: Optional[torch.Tensor] = None) -> None:
    """Raise on what the kernel does not take: a and b (B, S, D), b0 (B, D)
    or None, all float32 or all bfloat16, contiguous, on a's device, each
    size below 2**31.  Any pitch and alignment is taken."""
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
    if max(B, S, D) >= 2 ** 31:
        raise ValueError(f"shape {(B, S, D)} exceeds the grid")


def linear_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                     b0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on anything it does not
    take.  a, b: (B, S, D) and b0: (B, D) or None, all float32 or all
    bfloat16, contiguous, on one card -> h (B, S, D) in a's dtype."""
    if a.device.type != "cuda":
        raise ValueError("linear_scan_cuda takes CUDA tensors (got "
                         f"{a.device}); CPU tensors go to the plain version")
    check_inputs(a, b, b0)
    B, S, D = a.shape
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    index = a.device.index if a.device.index is not None else (
        torch.cuda.current_device())
    plan = _card_plan(B, D, a.element_size(), index)
    if plan["blocks"] >= 2 ** 31:
        raise ValueError(f"shape {(B, S, D)} exceeds the grid")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _build.launched(_library()(
        _DTYPES[a.dtype], a.data_ptr(), b.data_ptr(),
        0 if b0 is None else b0.data_ptr(), h.data_ptr(), B, S, D,
        plan["C"], plan["R"], plan["K"], stream), "linear_scan")
    linear_scan_cuda.launches += 1
    return h


linear_scan_cuda.launches = 0
