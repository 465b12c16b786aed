"""The unified Conv4Xbar block evaluator: a CUDA C++ kernel for Hopper and
its plain PyTorch version.

``emulator_block_unified_cuda`` replaces the JAX package's
``kernels/emulator_block/emulator_block.py:emulator_block_unified_pallas``:
one launch per analog matmul evaluates both rails of every (row, crossbar
block) pair -- stage-1 window contraction, tail convs, W-stage, FC head
and the optional fc0 shift (the source note in
``csrc/emulator_block_unified.cu`` says what bounds it and how the design
answers).  ``emulator_block_unified_plain`` is the same function in plain
PyTorch (``conv4xbar.apply_blocklast``); the CPU tests use it and the
card run compares the kernel against it.

The kernel is compiled from ``csrc/`` with ``nvcc`` at first use into
``build/`` beside this file (a gitignored directory), as a shared library
with a plain C interface loaded through ``ctypes``.  Nothing is compiled
or loaded at import time, so this module imports on a machine without
``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.core.conv4xbar import apply_blocklast

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "emulator_block_unified.cu"
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# (D, W, O, fc0 rows) -> template id of the C entry point
_GEOMS = {(4, 2, 1, 128): 0, (2, 8, 4, 256): 1}
_TAIL = ((32, 4, 4), (32, 32, 8))      # (k*C_in, C_out, k) of stages 2, 3
_HEAD = (32, 16)


class _Weights(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "w0v", "w1k", "w2", "b2", "w3", "b3", "wst", "bst",
        "f0", "fb0", "f1", "fb1", "f2", "fb2")]


_LIB: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            path = str(cand)
    if path is None:
        raise RuntimeError("nvcc not found: the unified emulator kernel is "
                           "built from source on a machine with the CUDA "
                           "toolkit")
    return path


def build() -> Tuple[Path, str]:
    """Compile the kernel library (once per source version); returns its
    path and the compiler's output (``-Xptxas -v``: registers, spills)."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"libemulator_block_unified_{tag}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, res.stdout + res.stderr


def _library():
    if "fn" not in _LIB:
        path, _ = build()
        fn = ctypes.CDLL(str(path)).emulator_block_unified_f32
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int, ctypes.POINTER(_Weights),
                          ctypes.c_void_p] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB["fn"] = fn
    return _LIB["fn"]


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 (got {t.dtype}); the "
                        "kernel's bf16 mode is not ported (ROADMAP B1)")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def default_block_m(M: int) -> int:
    """Fixed row-tile heuristic (the autotuner is ROADMAP A4): one tile
    covers up to 128 rows, so the precompute is read once per call for
    decode and prefill batches alike."""
    return min(M, 128)


def launch_args(aux: dict, pre: dict, u01: torch.Tensor,
                pos01: torch.Tensor, shift: Optional[torch.Tensor] = None,
                block_m: Optional[int] = None) -> dict:
    """Validate one call against what the kernel takes and return the
    launch's scalar arguments and tensors; raises on anything else."""
    dev = u01.device
    g0k, celu0k, y0 = pre["g0k"], pre["celu0k"], pre["y0"]
    if g0k.dim() != 7 or u01.dim() != 4:
        raise ValueError("g0k must be (k1,NB,NO,D,W,G,C0) and u01 (M,NB,D,H)")
    k1, NB, NO, D, W, G, C0 = g0k.shape
    M, H = u01.shape[0], u01.shape[3]
    fcs = aux["fcs"]
    O = fcs[-1][0].shape[1]
    flat = fcs[0][0].shape[0]
    geom = _GEOMS.get((D, W, O, flat))
    if geom is None or (k1, G, C0, H) != (2, 32, 16, 64):
        raise ValueError(f"unsupported block geometry (D={D}, W={W}, O={O}, "
                         f"k1={k1}, G={G}, C0={C0}, H={H}, fc0 rows={flat})")
    if tuple((wk.shape[0], wk.shape[1], k) for wk, _, k in aux["hstages"][1:]) \
            != _TAIL or len(fcs) != 3 \
            or tuple(fw.shape[1] for fw, _ in fcs[:-1]) != _HEAD:
        raise ValueError("unsupported Conv4Xbar head/tail widths")
    _check("u01", u01, (M, NB, D, H), dev)
    _check("pos01", pos01, (M, NB, D, H), dev)
    _check("g0k", g0k, (k1, NB, NO, D, W, G, C0), dev)
    _check("celu0k", celu0k, (k1, NB, NO, D, W, G, C0), dev)
    _check("y0", y0, (NB * NO * D * W * G, 8), dev)
    per_block = 0
    if shift is not None:
        if shift.dim() == 2:
            _check("shift", shift, (NB * NO, _HEAD[0]), dev)
            per_block = 1
        else:
            _check("shift", shift, (_HEAD[0],), dev)
    (w2, b2, _), (w3, b3, _) = aux["hstages"][1:]
    wst, bst, _ = aux["wstage"]
    (f0, fb0), (f1, fb1), (f2, fb2) = fcs
    ws = dict(w0v=aux["w0v"], w1k=aux["w1k"], w2=w2, b2=b2, w3=w3, b3=b3,
              wst=wst, bst=bst, f0=f0, fb0=fb0, f1=f1, fb1=fb1, f2=f2,
              fb2=fb2)
    shapes = dict(w0v=(C0,), w1k=(k1, C0, 8), w2=(32, 4), b2=(4,),
                  w3=(32, 32), b3=(32,), wst=(64, 32), bst=(32,),
                  f0=(flat, 32), fb0=(32,), f1=(32, 16), fb1=(16,),
                  f2=(16, O), fb2=(O,))
    for name, t in ws.items():
        _check(name, t, shapes[name], dev)
    if NB * NO >= 2 ** 31:
        raise ValueError(f"{NB * NO} blocks exceed the grid's x dimension")
    bm = default_block_m(M) if block_m is None else int(block_m)
    if bm < 1 or -(-M // bm) > 65535:
        raise ValueError(f"block_m={bm} gives an invalid grid for M={M}")
    return dict(geom=geom, M=M, NB=NB, NO=NO, O=O, bm=bm,
                per_block=per_block, weights=ws)


def emulator_block_unified_cuda(aux: dict, pre: dict, u01: torch.Tensor,
                                pos01: torch.Tensor, *,
                                shift: Optional[torch.Tensor] = None,
                                block_m: Optional[int] = None
                                ) -> torch.Tensor:
    """Launch the unified kernel on CUDA tensors; raises on anything it
    does not take.  Same contract as ``emulator_block_unified_plain``:
    returns (2, M*NB*NO, O) float32."""
    if u01.device.type != "cuda":
        raise ValueError("emulator_block_unified_cuda takes CUDA tensors "
                         f"(got {u01.device}); CPU tensors go to the plain "
                         "version")
    a = launch_args(aux, pre, u01, pos01, shift, block_m)
    M, NB, NO = a["M"], a["NB"], a["NO"]
    out = torch.empty((2, M * NB * NO, a["O"]), dtype=torch.float32,
                      device=u01.device)
    wt = _Weights(**{k: v.data_ptr() for k, v in a["weights"].items()})
    fn = _library()
    stream = torch.cuda.current_stream(u01.device).cuda_stream
    err = fn(a["geom"], u01.data_ptr(), pos01.data_ptr(),
             pre["g0k"].data_ptr(), pre["celu0k"].data_ptr(),
             pre["y0"].data_ptr(), 0 if shift is None else shift.data_ptr(),
             a["per_block"], ctypes.byref(wt), out.data_ptr(), M, NB, NO,
             a["bm"], stream)
    if err != 0:
        raise RuntimeError(f"emulator_block_unified kernel launch failed "
                           f"(cudaError {err})")
    emulator_block_unified_cuda.launches += 1
    return out


emulator_block_unified_cuda.launches = 0


def emulator_block_unified_plain(aux: dict, pre: dict, u01: torch.Tensor,
                                 pos01: torch.Tensor, *,
                                 shift: Optional[torch.Tensor] = None,
                                 chunk: int = 2) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the chunked
    ``conv4xbar.apply_blocklast``.  Returns (2, M*NB*NO, O)."""
    return apply_blocklast(aux, pre, u01, pos01, chunk=chunk,
                           fc0_shift=shift)
