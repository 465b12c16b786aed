"""The Conv4Xbar block evaluators: CUDA C++ kernels for Hopper, each with
its plain PyTorch version.

* ``emulator_block_unified_cuda`` (B1) replaces the JAX package's
  ``kernels/emulator_block/emulator_block.py:emulator_block_unified_pallas``:
  one launch per analog matmul evaluates both rails of every (row,
  crossbar block) pair -- stage-1 window contraction, tail convs,
  W-stage, FC head and the optional fc0 shift
  (``csrc/emulator_block_unified.cu``).  ``compute_dtype=torch.bfloat16``
  is the reference kernel's bf16 mode: every GEMM takes bf16-rounded
  operands and accumulates in float32.  Its plain version is
  ``conv4xbar.apply_blocklast`` (with ``bf16_dot`` in bf16 mode).
* ``emulator_block_cuda`` (B2) replaces ``emulator_block_pallas``: the
  paper-faithful network on full (N, 2, D, H, W) features with a
  per-block periph.  Its plain version is ``conv4xbar.apply``.
* ``emulator_block_grid_cuda`` (B3) replaces ``emulator_block_grid_pallas``:
  the same network per (row, crossbar block), the (V, G) stack built on
  chip from the rows' drive and the blocks' shared conductances, periph
  (1, 0, ...).  Its plain version builds the broadcast stack in chunks of
  blocks and calls ``conv4xbar.apply``.
  B2 and B3 share one network in ``csrc/emulator_block.cu``.

Each source note says what bounds its kernel and how the design answers.
The CPU tests use the plain versions; the card run compares each kernel
with its plain version.  The sources are built by ``kernels._build``;
nothing is compiled or loaded at import time, so this module imports on a
machine without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.configs.rram_ps32 import BlockGeometry
from repro_torch.core import conv4xbar
from repro_torch.core.conv4xbar import apply_blocklast
from repro_torch.kernels import _build

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "emulator_block_unified.cu"      # B1
BLOCK_SOURCE = _HERE / "csrc" / "emulator_block.cu"         # B2, B3

# (D, W, O, fc0 rows) -> template id of the C entry point
_GEOMS = {(4, 2, 1, 128): 0, (2, 8, 4, 256): 1}
_TAIL = ((32, 4, 4), (32, 32, 8))      # (k*C_in, C_out, k) of stages 2, 3
_HEAD = (32, 16)


class _Weights(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "w0v", "w1k", "w2", "b2", "w3", "b3", "wst", "bst",
        "f0", "fb0", "f1", "fb1", "f2", "fb2")]


_LIB: dict = {}


def _library():
    if "fn" not in _LIB:
        fn = _build.load(SOURCE).emulator_block_unified
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
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
        raise TypeError(f"{name} must be float32 (got {t.dtype}); the bf16 "
                        "mode rounds GEMM operands inside the kernel")
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


_MODES = {torch.float32: 0, torch.bfloat16: 1}


def _mode(compute_dtype) -> int:
    if compute_dtype not in _MODES:
        raise TypeError(f"compute_dtype must be torch.float32 or "
                        f"torch.bfloat16 (got {compute_dtype})")
    return _MODES[compute_dtype]


def emulator_block_unified_cuda(aux: dict, pre: dict, u01: torch.Tensor,
                                pos01: torch.Tensor, *,
                                shift: Optional[torch.Tensor] = None,
                                block_m: Optional[int] = None,
                                compute_dtype=torch.float32) -> torch.Tensor:
    """Launch the unified kernel on CUDA tensors; raises on anything it
    does not take.  Same contract as ``emulator_block_unified_plain``:
    returns (2, M*NB*NO, O) float32."""
    mode = _mode(compute_dtype)
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
    err = fn(a["geom"], mode, u01.data_ptr(), pos01.data_ptr(),
             pre["g0k"].data_ptr(), pre["celu0k"].data_ptr(),
             pre["y0"].data_ptr(), 0 if shift is None else shift.data_ptr(),
             a["per_block"], ctypes.byref(wt), out.data_ptr(), M, NB, NO,
             a["bm"], stream)
    _build.launched(err, "emulator_block_unified")
    emulator_block_unified_cuda.launches += 1
    return out


emulator_block_unified_cuda.launches = 0


def bf16_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The bf16 mode's GEMM ``a @ b``: both operands rounded to bf16, then
    summed in float32 over the contraction index in order from zero.  A
    product of two bf16 values is exact in float32, so each step rounds
    once, as the kernel's FMA does; in the kernel's order the two agree
    bit for bit, and a bf16 rounding downstream cannot flip between them."""
    a = a.to(torch.bfloat16).float()
    b = b.to(torch.bfloat16).float()
    acc = torch.zeros(a.shape[:-1] + b.shape[1:], dtype=torch.float32,
                      device=a.device)
    for k in range(a.shape[-1]):
        acc = acc + a[..., k, None] * b[k]
    return acc


def emulator_block_unified_plain(aux: dict, pre: dict, u01: torch.Tensor,
                                 pos01: torch.Tensor, *,
                                 shift: Optional[torch.Tensor] = None,
                                 chunk: int = 2,
                                 compute_dtype=torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the chunked
    ``conv4xbar.apply_blocklast``, its GEMMs through ``bf16_dot`` in bf16
    mode.  Returns (2, M*NB*NO, O) float32."""
    dot = bf16_dot if _mode(compute_dtype) else None
    return apply_blocklast(aux, pre, u01, pos01, chunk=chunk,
                           fc0_shift=shift, dot=dot)


# --------------------------------------------------------------------------- #
# B2 and B3: the paper-faithful network per crossbar block
# --------------------------------------------------------------------------- #
# (D, W, O) -> template id of the C entry points; H is 64 in both
_NET_GEOMS = {(4, 2, 1): 0, (2, 8, 4): 1}
# conv{i}_w shapes of build_stages at H = 64 (conv4's depends on nothing)
_CONV_SHAPES = ((16, 2, 1, 1, 1), (8, 16, 1, 2, 1), (4, 8, 1, 4, 1),
                (32, 4, 1, 8, 1), (32, 32, 1, 1, 2))


def _block_library():
    if "block" not in _LIB:
        lib = _build.load(BLOCK_SOURCE)
        lib.emulator_block_f32.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 3
            + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p])
        lib.emulator_block_grid_f32.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 3
            + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4
            + [ctypes.c_void_p])
        lib.emulator_block_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        for f in (lib.emulator_block_f32, lib.emulator_block_grid_f32,
                  lib.emulator_block_smem_bytes):
            f.restype = ctypes.c_int
        _LIB["block"] = lib
    return _LIB["block"]


def pack_net_weights(params: dict, geom: BlockGeometry
                     ) -> Tuple[torch.Tensor, int, int]:
    """The network's weights in the order ``csrc/emulator_block.cu``
    (``Net``) reads them, as one float32 vector on the params' device:
    stage-0 (w0v, w0g, b0), each row-window stage as (k*C_in, C_out) and
    its bias, the W-stage likewise, fc0's bias, fc1, fc2, then fc0's rows
    -- the flatten rows in channels-last (d, w, c) order, then the P
    periph rows.  Returns (weights, geometry id, P); raises on a network
    or geometry the kernels do not take."""
    gid = _NET_GEOMS.get((geom.tiles, geom.cols, geom.outputs))
    if gid is None or (geom.features, geom.rows) != (2, 64):
        raise ValueError(f"unsupported block geometry {geom}")
    if conv4xbar._n_stages(params) != 5 or conv4xbar._n_fc(params) != 3:
        raise ValueError("unsupported Conv4Xbar depth")
    flat = conv4xbar.flat_features(geom)
    n_periph = conv4xbar.n_periph_of(params, geom)
    want = {f"conv{i}_w": s for i, s in enumerate(_CONV_SHAPES)}
    want.update({f"conv{i}_b": (s[0],) for i, s in enumerate(_CONV_SHAPES)})
    want.update(fc0_w=(flat + n_periph, 32), fc0_b=(32,), fc1_w=(32, 16),
                fc1_b=(16,), fc2_w=(16, geom.outputs), fc2_b=(geom.outputs,))
    for k, s in want.items():
        if tuple(params[k].shape) != s:
            raise ValueError(f"{k} has shape {tuple(params[k].shape)}, "
                             f"expected {s}")
    if n_periph < 0:
        raise ValueError("fc0 has fewer rows than the conv flatten")

    def window(i):            # (O, I, k) -> (k * I, O)
        w = params[f"conv{i}_w"]
        w = w[:, :, 0, :, 0] if i < 4 else w[:, :, 0, 0, :]
        return w.permute(2, 1, 0)

    w0 = params["conv0_w"][:, :, 0, 0, 0]
    d, h, wd = conv4xbar.conv_out_sizes(conv4xbar.build_stages(geom),
                                        geom.tiles, geom.rows, geom.cols)
    f0 = params["fc0_w"]
    f0_flat = f0[:flat].reshape(32, d, h, wd, -1).permute(1, 2, 3, 0, 4)
    parts = [w0[:, 0], w0[:, 1], params["conv0_b"]]
    for i in range(1, 5):
        parts += [window(i), params[f"conv{i}_b"]]
    parts += [params["fc0_b"], params["fc1_w"], params["fc1_b"],
              params["fc2_w"], params["fc2_b"], f0_flat, f0[flat:]]
    wpack = torch.cat([p.reshape(-1).float() for p in parts]).contiguous()
    return wpack, gid, n_periph


def block_smem_bytes(geom: BlockGeometry, n_periph: int) -> int:
    """Dynamic shared memory one thread block of B2/B3 takes for this
    geometry and periph width (weights, fc0 rows and activations), as the
    compiled library reckons it; builds the library if needed."""
    gid = _NET_GEOMS.get((geom.tiles, geom.cols, geom.outputs))
    if gid is None:
        raise ValueError(f"unsupported block geometry {geom}")
    return int(_block_library().emulator_block_smem_bytes(gid, n_periph))


def default_block_n(N: int) -> int:
    """Crossbar blocks per thread block of B2: at least ~1,000 thread
    blocks for a few thousand blocks, at most 32 blocks each."""
    return max(1, min(32, N // 1024))


def emulator_block_cuda(params: dict, x: torch.Tensor,
                        periph: Optional[torch.Tensor], geom: BlockGeometry,
                        *, block_n: Optional[int] = None) -> torch.Tensor:
    """Launch B2 on CUDA tensors; raises on anything it does not take.
    x: (N, 2, D, H, W) normalized features; periph: (N, P), or None when
    the net has no periph rows.  Returns (N, O) float32."""
    if x.device.type != "cuda":
        raise ValueError("emulator_block_cuda takes CUDA tensors (got "
                         f"{x.device}); CPU tensors go to the plain version")
    dev = x.device
    wpack, gid, P = pack_net_weights(params, geom)
    N = x.shape[0]
    _check("x", x, (N,) + geom.chw, dev)
    if P:
        if periph is None:
            raise ValueError(f"the net takes {P} periph features per block")
        _check("periph", periph, (N, P), dev)
    elif periph is not None and periph.numel():
        raise ValueError("the net has no periph rows")
    _check("weights", wpack, wpack.shape, dev)
    bn = default_block_n(N) if block_n is None else int(block_n)
    if bn < 1 or -(-N // bn) >= 2 ** 31:
        raise ValueError(f"block_n={bn} gives an invalid grid for N={N}")
    out = torch.empty((N, geom.outputs), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.launched(_block_library().emulator_block_f32(
        gid, x.data_ptr(), periph.data_ptr() if P else 0, wpack.data_ptr(), P,
        out.data_ptr(), N, bn, stream), "emulator_block")
    emulator_block_cuda.launches += 1
    return out


emulator_block_cuda.launches = 0


def emulator_block_plain(params: dict, x: torch.Tensor,
                         periph: Optional[torch.Tensor]) -> torch.Tensor:
    """B2's function in plain PyTorch: ``conv4xbar.apply``."""
    return conv4xbar.apply(params, x, periph)


def _grid_shapes(v01: torch.Tensor, g_norm: torch.Tensor):
    if v01.dim() != 4 or g_norm.dim() != 4:
        raise ValueError("v01 must be (M, NB, D, H) and g_norm (NB*NO, D, H, W)")
    M, NB = v01.shape[:2]
    nblk = g_norm.shape[0]
    if NB == 0 or nblk % NB:
        raise ValueError(f"{nblk} blocks do not split into {NB} block groups")
    return M, NB, nblk // NB


def emulator_block_grid_cuda(params: dict, v01: torch.Tensor,
                             g_norm: torch.Tensor, geom: BlockGeometry, *,
                             block_m: Optional[int] = None) -> torch.Tensor:
    """Launch B3 on CUDA tensors; raises on anything it does not take.
    v01: (M, NB, D, H) normalized drive; g_norm: (NB*NO, D, H, W) shared
    normalized conductances.  Returns (M, NB*NO, O) float32."""
    if v01.device.type != "cuda":
        raise ValueError("emulator_block_grid_cuda takes CUDA tensors (got "
                         f"{v01.device}); CPU tensors go to the plain version")
    dev = v01.device
    wpack, gid, P = pack_net_weights(params, geom)
    M, NB, NO = _grid_shapes(v01, g_norm)
    _, D, H, W = geom.chw
    _check("v01", v01, (M, NB, D, H), dev)
    _check("g_norm", g_norm, (NB * NO, D, H, W), dev)
    _check("weights", wpack, wpack.shape, dev)
    if NB * NO >= 2 ** 31:
        raise ValueError(f"{NB * NO} blocks exceed the grid's x dimension")
    bm = default_block_m(M) if block_m is None else int(block_m)
    if bm < 1 or -(-M // bm) > 65535:
        raise ValueError(f"block_m={bm} gives an invalid grid for M={M}")
    out = torch.empty((M, NB * NO, geom.outputs), dtype=torch.float32,
                      device=dev)
    if M == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.launched(_block_library().emulator_block_grid_f32(
        gid, v01.data_ptr(), g_norm.data_ptr(), wpack.data_ptr(), P,
        out.data_ptr(), M, NB, NO, bm, stream), "emulator_block_grid")
    emulator_block_grid_cuda.launches += 1
    return out


emulator_block_grid_cuda.launches = 0


def emulator_block_grid_plain(params: dict, v01: torch.Tensor,
                              g_norm: torch.Tensor, geom: BlockGeometry, *,
                              chunk_blocks: Optional[int] = None
                              ) -> torch.Tensor:
    """B3's function in plain PyTorch: the batch-broadcast (V, G) stack and
    the constant periph (1, 0, ...) through ``conv4xbar.apply``, built for
    ``chunk_blocks`` crossbar blocks at a time (default: about 65,536
    (row, block) pairs per chunk).  Returns (M, NB*NO, O)."""
    M, NB, NO = _grid_shapes(v01, g_norm)
    nblk, D, H, W = g_norm.shape
    P = conv4xbar.n_periph_of(params, geom)
    cb = chunk_blocks or max(1, 65536 // max(M, 1))
    outs = []
    for j0 in range(0, nblk, cb):
        j1 = min(nblk, j0 + cb)
        nc = j1 - j0
        nb = torch.arange(j0, j1, device=v01.device) // NO
        shp = (M, nc, D, H, W)
        x = torch.stack([v01[:, nb, :, :, None].expand(shp),
                         g_norm[None, j0:j1].expand(shp)], dim=2)
        periph = None
        if P:
            periph = torch.zeros((M * nc, P), dtype=x.dtype, device=x.device)
            periph[:, 0] = 1.0
        y = conv4xbar.apply(params, x.reshape(M * nc, 2, D, H, W), periph)
        outs.append(y.reshape(M, nc, -1))
    return torch.cat(outs, dim=1)
