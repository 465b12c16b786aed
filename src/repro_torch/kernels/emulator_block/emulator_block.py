"""The Conv4Xbar block evaluators: CUDA C++ kernels for Hopper, each with
its plain PyTorch version.

* ``emulator_block_unified_cuda`` (B1) replaces the JAX package's
  ``kernels/emulator_block/emulator_block.py:emulator_block_unified_pallas``:
  one launch per analog matmul evaluates both rails of every (row,
  crossbar block) pair -- stage-1 window contraction, tail convs,
  W-stage, FC head and the optional fc0 shift
  (``csrc/emulator_block_unified.cu``).  It takes the plan's ``g_norm``:
  the kernel folds the per-plan precompute (``conv4xbar.
  blocklast_precompute``) in, once per thread block, in both modes.
  ``compute_dtype=torch.bfloat16`` is the reference kernel's bf16 mode:
  every GEMM takes bf16-rounded operands and accumulates in float32.  The
  plain version is ``blocklast_precompute`` then ``conv4xbar.
  apply_blocklast``; in bf16 mode y0 goes through ``f32_dot`` and every
  GEMM through ``bf16_dot``, each summed in order, as the kernel sums.
* ``emulator_block_cuda`` (B2) replaces ``emulator_block_pallas``: the
  paper-faithful network on full (N, 2, D, H, W) features with a
  per-block periph, on B3's design and shared-memory layout
  (``pack_block_weights``: fc0's bias as it is, its periph rows after the
  weights).  Its plain version is ``conv4xbar.apply``.
* ``emulator_block_grid_cuda`` (B3) replaces ``emulator_block_grid_pallas``:
  the same network per (row, crossbar block), the (V, G) stack built on
  chip from the rows' drive and the blocks' shared conductances, periph
  (1, 0, ...), which ``pack_grid_weights`` folds into fc0's bias.  Its
  plain version builds the broadcast stack in chunks of blocks and calls
  ``conv4xbar.apply``.
  B2 and B3 are two kernels of ``csrc/emulator_block.cu`` sharing one
  tail and head.

Each source note says what bounds its kernel and how the design answers.
The CPU tests use the plain versions; the card run compares each kernel
with its plain version.  The sources are built by ``kernels._build``;
nothing is compiled or loaded at import time, so this module imports on a
machine without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import functools
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
        "f0", "fb0", "f1", "fb1", "f2", "fb2", "w0g", "b0", "b1")]


_LIB: dict = {}


def _library():
    if "unified" not in _LIB:
        lib = _build.load(SOURCE)
        tail = ([ctypes.c_int, ctypes.POINTER(_Weights), ctypes.c_void_p]
                + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.emulator_block_unified_f32.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + tail)
        lib.emulator_block_unified_bf16.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + tail)
        lib.emulator_block_unified_smem.argtypes = [ctypes.c_int] * 2
        for f in (lib.emulator_block_unified_f32,
                  lib.emulator_block_unified_bf16,
                  lib.emulator_block_unified_smem):
            f.restype = ctypes.c_int
        _LIB["unified"] = lib
    return _LIB["unified"]


def unified_smem_bytes(geom: int, compute_dtype=torch.float32) -> int:
    """Dynamic shared memory of one thread block of B1's kernel for
    template ``geom`` (0: CASE_A, 1: CASE_B) in the mode of
    ``compute_dtype``; builds the library if needed."""
    return int(_library().emulator_block_unified_smem(geom,
                                                      _mode(compute_dtype)))


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
    """The row tile where the autotuner does not sweep (the reference's
    heuristic default): one tile covers up to 128 rows, so the kernel
    folds each block's precompute once per call for decode and prefill
    batches alike."""
    return min(M, 128)


def launch_args(aux: dict, g_norm: torch.Tensor, u01: torch.Tensor,
                pos01: torch.Tensor, shift: Optional[torch.Tensor] = None,
                block_m: Optional[int] = None) -> dict:
    """Validate one call against what the kernel takes and return the
    launch's scalar arguments and tensors; raises on anything else.
    g_norm: (NB, NO, D, H, W), the plan's normalized conductances."""
    dev = u01.device
    if g_norm.dim() != 5 or u01.dim() != 4:
        raise ValueError("g_norm must be (NB,NO,D,H,W) and u01 (M,NB,D,H)")
    NB, NO, D, H, W = g_norm.shape
    M = u01.shape[0]
    fcs = aux["fcs"]
    O = fcs[-1][0].shape[1]
    flat = fcs[0][0].shape[0]
    geom = _GEOMS.get((D, W, O, flat))
    k1, C0, O1 = aux["w1k"].shape
    if geom is None or (k1, C0, O1, H) != (2, 16, 8, 64):
        raise ValueError(f"unsupported block geometry (D={D}, W={W}, O={O}, "
                         f"k1={k1}, C0={C0}, O1={O1}, H={H}, fc0 rows={flat})")
    if tuple((wk.shape[0], wk.shape[1], k) for wk, _, k in aux["hstages"][1:]) \
            != _TAIL or len(fcs) != 3 \
            or tuple(fw.shape[1] for fw, _ in fcs[:-1]) != _HEAD:
        raise ValueError("unsupported Conv4Xbar head/tail widths")
    _check("u01", u01, (M, NB, D, H), dev)
    _check("pos01", pos01, (M, NB, D, H), dev)
    _check("g_norm", g_norm, (NB, NO, D, H, W), dev)
    per_block = 0
    if shift is not None:
        if shift.dim() == 2:
            _check("shift", shift, (NB * NO, _HEAD[0]), dev)
            per_block = 1
        else:
            _check("shift", shift, (_HEAD[0],), dev)
    (_, b1, _), (w2, b2, _), (w3, b3, _) = aux["hstages"]
    wst, bst, _ = aux["wstage"]
    (f0, fb0), (f1, fb1), (f2, fb2) = fcs
    ws = dict(w0v=aux["w0v"], w1k=aux["w1k"], w2=w2, b2=b2, w3=w3, b3=b3,
              wst=wst, bst=bst, f0=f0, fb0=fb0, f1=f1, fb1=fb1, f2=f2,
              fb2=fb2, w0g=aux.get("w0g"), b0=aux.get("b0"), b1=b1)
    shapes = dict(w0v=(C0,), w1k=(k1, C0, O1), w2=(32, 4), b2=(4,),
                  w3=(32, 32), b3=(32,), wst=(64, 32), bst=(32,),
                  f0=(flat, 32), fb0=(32,), f1=(32, 16), fb1=(16,),
                  f2=(16, O), fb2=(O,), w0g=(C0,), b0=(C0,), b1=(O1,))
    for name, t in ws.items():
        if t is None:
            raise ValueError(f"aux has no {name} (stage 0's weights come "
                             "from conv4xbar.blocklast_weights)")
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


def emulator_block_unified_cuda(aux: dict, g_norm: torch.Tensor,
                                u01: torch.Tensor, pos01: torch.Tensor, *,
                                shift: Optional[torch.Tensor] = None,
                                block_m: Optional[int] = None,
                                compute_dtype=torch.float32) -> torch.Tensor:
    """Launch the unified kernel on CUDA tensors; raises on anything it
    does not take.  Same contract as ``emulator_block_unified_plain``:
    returns (2, M*NB*NO, O) float32.  Both modes fold the per-plan
    precompute into the kernel; nothing per plan is built here."""
    mode = _mode(compute_dtype)
    if u01.device.type != "cuda":
        raise ValueError("emulator_block_unified_cuda takes CUDA tensors "
                         f"(got {u01.device}); CPU tensors go to the plain "
                         "version")
    a = launch_args(aux, g_norm, u01, pos01, shift, block_m)
    M, NB, NO = a["M"], a["NB"], a["NO"]
    out = torch.empty((2, M * NB * NO, a["O"]), dtype=torch.float32,
                      device=u01.device)
    wt = _Weights(**{k: v.data_ptr() for k, v in a["weights"].items()})
    lib = _library()
    stream = torch.cuda.current_stream(u01.device).cuda_stream
    sh = 0 if shift is None else shift.data_ptr()
    tail = (sh, a["per_block"], ctypes.byref(wt), out.data_ptr(), M, NB, NO,
            a["bm"], stream)
    fn = (lib.emulator_block_unified_bf16 if mode
          else lib.emulator_block_unified_f32)
    err = fn(a["geom"], u01.data_ptr(), pos01.data_ptr(), g_norm.data_ptr(),
             *tail)
    _build.launched(err, "emulator_block_unified")
    emulator_block_unified_cuda.launches += 1
    return out


emulator_block_unified_cuda.launches = 0


def f32_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float32 summed over the contraction index in order from
    zero, each product and each sum rounded apart: the bf16 mode's y0, as
    the kernel's fold computes it (``torch.matmul`` sums in its library's
    own order, which differs between the CPU and the card)."""
    acc = torch.zeros(a.shape[:-1] + b.shape[1:], dtype=torch.float32,
                      device=a.device)
    for k in range(a.shape[-1]):
        acc = acc + a[..., k, None] * b[k]
    return acc


def bf16_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The bf16 mode's GEMM ``a @ b``: both operands rounded to bf16, then
    ``f32_dot``.  A product of two bf16 values is exact in float32, so each
    step rounds once, as the kernel's FMA does; in the kernel's order the
    two agree bit for bit, and a bf16 rounding downstream cannot flip
    between them."""
    return f32_dot(a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float())


def emulator_block_unified_plain(aux: dict, g_norm: torch.Tensor,
                                 u01: torch.Tensor, pos01: torch.Tensor, *,
                                 shift: Optional[torch.Tensor] = None,
                                 chunk: int = 2,
                                 compute_dtype=torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``conv4xbar.
    blocklast_precompute`` on ``g_norm``, then the chunked
    ``conv4xbar.apply_blocklast``; in bf16 mode y0 through ``f32_dot`` and
    the GEMMs through ``bf16_dot``.  Returns (2, M*NB*NO, O) float32."""
    bf16 = _mode(compute_dtype)
    pre = conv4xbar.blocklast_precompute(aux, g_norm,
                                         dot=f32_dot if bf16 else None)
    dot = bf16_dot if bf16 else None
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
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
            + [ctypes.c_void_p])
        lib.emulator_block_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.emulator_block_resident.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.emulator_block_grid_weights.argtypes = [ctypes.c_int]
        lib.emulator_block_grid_smem_bytes.argtypes = [ctypes.c_int]
        for f in (lib.emulator_block_f32, lib.emulator_block_grid_f32,
                  lib.emulator_block_smem_bytes,
                  lib.emulator_block_resident,
                  lib.emulator_block_grid_weights,
                  lib.emulator_block_grid_smem_bytes):
            f.restype = ctypes.c_int
        _LIB["block"] = lib
    return _LIB["block"]


def _gid(geom: BlockGeometry) -> int:
    """The C entry points' template id of a geometry B2/B3 take."""
    gid = _NET_GEOMS.get((geom.tiles, geom.cols, geom.outputs))
    if gid is None or (geom.features, geom.rows) != (2, 64):
        raise ValueError(f"unsupported block geometry {geom}")
    return gid


def _net_geometry(params: dict, geom: BlockGeometry) -> Tuple[int, int, int]:
    """(geometry id, FLAT, P) of a network the B2/B3 kernels take; raises
    on any other network or geometry."""
    gid = _gid(geom)
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
    return gid, flat, n_periph


def _window(params: dict, i: int) -> torch.Tensor:
    """conv{i}'s weight as (k * C_in, C_out): row k*C_in + c, window tap k."""
    w = params[f"conv{i}_w"]
    w = w[:, :, 0, :, 0] if i < 4 else w[:, :, 0, 0, :]
    return w.permute(2, 1, 0)


def _fc0_flat(params: dict, geom: BlockGeometry, flat: int) -> torch.Tensor:
    """fc0's flatten rows in channels-last (d, h, w, c) order."""
    d, h, wd = conv4xbar.conv_out_sizes(conv4xbar.build_stages(geom),
                                        geom.tiles, geom.rows, geom.cols)
    return params["fc0_w"][:flat].reshape(32, d, h, wd, -1).permute(1, 2, 3, 0, 4)


def _up4(n: int) -> int:
    return -(-n // 4) * 4


def grid_layout(geom: BlockGeometry) -> dict:
    """name -> (offset, shape) of each array in ``pack_grid_weights``'
    vector, which is the head of B3's shared memory (``Grid`` in
    ``csrc/emulator_block.cu``); ``"NW"`` -> (total floats, ()).  Every
    offset is a multiple of 4 floats (16 bytes)."""
    wo = 1 if geom.cols <= 2 else geom.cols // 2
    flat, O = geom.tiles * wo * 32, geom.outputs
    sizes = [("w1k", (2, 16, 8)), ("w0v", (16,)), ("w0g", (16,)), ("b0", (16,)),
             ("b1", (8,)), ("w2", (4, 36)), ("b2", (4,)), ("w3", (32, 32)),
             ("b3", (32,)), ("wst", (64, 32)), ("bst", (32,)),
             ("f0", (flat, 32)), ("fb0", (32,)), ("f1", (32, 16)),
             ("fb1", (16,)), ("f2", (_up4(16 * O),)), ("fb2", (4,))]
    out, at = {}, 0
    for name, shape in sizes:
        out[name] = (at, shape)
        at += _up4(int(torch.Size(shape).numel()))
    out["NW"] = (at, ())
    return out


def _pack(params: dict, geom: BlockGeometry, fold_periph: bool
          ) -> Tuple[torch.Tensor, int, int]:
    """The arrays of ``grid_layout`` in its order, each padded to 4 floats,
    then (unless ``fold_periph``, which adds fc0's periph row FLAT to its
    bias) fc0's P periph rows; returns (weights, geometry id, P)."""
    gid, flat, n_periph = _net_geometry(params, geom)
    w0 = params["conv0_w"][:, :, 0, 0, 0]
    f0 = params["fc0_w"]
    fb0 = params["fc0_b"]
    if fold_periph and n_periph:
        fb0 = fb0 + f0[flat]
    arrays = dict(
        w1k=_window(params, 1), w0v=w0[:, 0], w0g=w0[:, 1],
        b0=params["conv0_b"], b1=params["conv1_b"],
        w2=torch.nn.functional.pad(_window(params, 2).reshape(4, 32), (0, 4)),
        b2=params["conv2_b"], w3=_window(params, 3), b3=params["conv3_b"],
        wst=_window(params, 4), bst=params["conv4_b"],
        f0=_fc0_flat(params, geom, flat), fb0=fb0, f1=params["fc1_w"],
        fb1=params["fc1_b"], f2=params["fc2_w"], fb2=params["fc2_b"])
    parts = []
    for name, (_, shape) in grid_layout(geom).items():
        if name == "NW":
            continue
        a = arrays[name].reshape(-1).float()
        if a.numel() % 4:
            a = torch.nn.functional.pad(a, (0, _up4(a.numel()) - a.numel()))
        parts.append(a)
    if not fold_periph:
        parts.append(f0[flat:].reshape(-1).float())
    return torch.cat(parts).contiguous(), gid, n_periph


def pack_grid_weights(params: dict, geom: BlockGeometry
                      ) -> Tuple[torch.Tensor, int]:
    """B3's weights as its shared memory holds them (``grid_layout``), one
    float32 vector on the params' device: stage 1's window as (K1, C0,
    O1), stage 0 (w0v, w0g, b0), stage 1's bias, stage 2's window with
    each tap's (c, o) row padded from 32 to 36 floats (no bank conflict
    between the four lanes of a window), stages 3 and W, fc0's flatten
    rows in channels-last (d, w, c) order, fc0's bias, fc1, fc2, each
    array padded to 4 floats.  The slow path's periph is the constant
    (1, 0, ...): fc0's periph row FLAT is added to fc0's bias here, once
    per call, and no periph row is packed.  Returns (weights, geometry
    id); raises on a network or geometry the kernel does not take."""
    wpack, gid, _ = _pack(params, geom, fold_periph=True)
    return wpack, gid


def pack_block_weights(params: dict, geom: BlockGeometry
                       ) -> Tuple[torch.Tensor, int, int]:
    """B2's weights: ``grid_layout``'s arrays with fc0's bias as it is
    (not folded), then fc0's P periph rows as (P, 32), which the kernel
    keeps beside its activations and multiplies by each block's own periph
    features.  Returns (weights, geometry id, P); raises on a network or
    geometry the kernel does not take."""
    return _pack(params, geom, fold_periph=False)


def block_smem_bytes(geom: BlockGeometry, n_periph: int) -> int:
    """Dynamic shared memory one thread block of B2 takes for this
    geometry and periph width (B3's weights and activations, then fc0's
    periph rows), as the compiled library reckons it; builds the library
    if needed."""
    return int(_block_library().emulator_block_smem_bytes(_gid(geom), n_periph))


def grid_smem_bytes(geom: BlockGeometry) -> int:
    """Dynamic shared memory one thread block of B3 takes for this
    geometry, whatever its periph width; builds the library if needed."""
    return int(_block_library().emulator_block_grid_smem_bytes(_gid(geom)))


@functools.lru_cache(maxsize=None)
def _resident_per_sm(gid: int, n_periph: int, index: int) -> int:
    with torch.cuda.device(index):
        n = int(_block_library().emulator_block_resident(gid, n_periph))
    if n < 1:
        raise ValueError(f"B2 cannot keep a thread block resident with "
                         f"{n_periph} periph rows (runtime says {n})")
    return n


def block_slots(geom: BlockGeometry, n_periph: int, dev: torch.device) -> int:
    """Thread blocks of B2 the card ``dev`` keeps resident at once for this
    geometry and periph width: the runtime's occupancy for the kernel's
    registers, threads and dynamic shared memory, times the SMs (on an
    H100 at the periph widths in use, two an SM under CASE_A and one under
    CASE_B: 264 and 132).  Builds the library if needed."""
    dev = torch.device(dev)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return (_resident_per_sm(_gid(geom), n_periph, index)
            * torch.cuda.get_device_properties(index).multi_processor_count)


def default_block_n(N: int, geom: BlockGeometry, slots: int = 2 * 132) -> int:
    """Blocks per thread block of B2: ceil(N / ``slots``), so that the N
    blocks spread evenly over at most ``slots`` thread blocks (the wrapper
    passes ``block_slots``, those the card keeps resident), each copying
    the weights once and running ceil(bn / R) passes of R = D*W blocks.  Tiles
    of whole passes cost more wherever they leave resident thread blocks
    idle or give some of them a second round (tools/b2_variants.py times
    the alternatives in turns; PERF.md §6).  The output does not depend
    on the choice."""
    return max(1, -(-N // slots))


def emulator_block_cuda(params: dict, x: torch.Tensor,
                        periph: Optional[torch.Tensor], geom: BlockGeometry,
                        *, block_n: Optional[int] = None) -> torch.Tensor:
    """Launch B2 on CUDA tensors; raises on anything it does not take.
    x: (N, 2, D, H, W) normalized features; periph: (N, P), or None when
    the net has no periph rows.  ``block_n``: blocks per tile (default
    ``default_block_n``; any value >= 1, the output does not depend on
    it).  Returns (N, O) float32."""
    return launch_block(pack_block_weights(params, geom), x, periph, geom,
                        block_n=block_n)


def launch_block(packed: Tuple[torch.Tensor, int, int], x: torch.Tensor,
                 periph: Optional[torch.Tensor], geom: BlockGeometry, *,
                 block_n: Optional[int] = None) -> torch.Tensor:
    """``emulator_block_cuda`` on weights already packed
    (``pack_block_weights``' result for ``geom``, 16-byte aligned), for
    callers that evaluate one net many times; counts the launch.  Returns
    (N, O) float32."""
    if x.device.type != "cuda":
        raise ValueError("emulator_block_cuda takes CUDA tensors (got "
                         f"{x.device}); CPU tensors go to the plain version")
    wpack, gid, P = packed
    dev = x.device
    N = x.shape[0]
    _check("x", x, (N,) + geom.chw, dev)
    if P:
        if periph is None:
            raise ValueError(f"the net takes {P} periph features per block")
        _check("periph", periph, (N, P), dev)
    elif periph is not None and periph.numel():
        raise ValueError("the net has no periph rows")
    _check_pack(wpack, gid, geom, dev)
    if N >= 2 ** 30:
        raise ValueError(f"{N} blocks exceed the kernel's 32-bit bookkeeping")
    bn = (default_block_n(N, geom, block_slots(geom, P, dev))
          if block_n is None else int(block_n))
    if bn < 1:
        raise ValueError(f"block_n={bn} gives an invalid grid for N={N}")
    out = torch.empty((N, geom.outputs), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    bn = min(bn, N)
    lib = _block_library()
    if wpack.numel() != lib.emulator_block_grid_weights(gid) + 32 * P:
        raise ValueError(f"pack_block_weights gave {wpack.numel()} floats, the "
                         f"kernel takes {lib.emulator_block_grid_weights(gid)} "
                         f"+ 32 x {P}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.launched(lib.emulator_block_f32(
        gid, x.data_ptr(), periph.data_ptr() if P else 0, wpack.data_ptr(), P,
        out.data_ptr(), N, bn, stream), "emulator_block")
    emulator_block_cuda.launches += 1
    return out


emulator_block_cuda.launches = 0


def _check_pack(wpack: torch.Tensor, gid: int, geom: BlockGeometry,
                dev: torch.device) -> None:
    """Packed weights the kernels copy as float4: float32, contiguous, on
    ``dev``, packed for ``geom``, starting on a 16-byte boundary."""
    _check("weights", wpack, wpack.shape, dev)
    if gid != _gid(geom):
        raise ValueError(f"the weights were packed for geometry {gid}, "
                         f"not {geom.name}")
    if wpack.data_ptr() % 16:
        raise ValueError("packed weights must start on a 16-byte boundary "
                         "(float4 copies)")


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
    return launch_grid(pack_grid_weights(params, geom), v01, g_norm, geom,
                       block_m=block_m)


def launch_grid(packed: Tuple[torch.Tensor, int], v01: torch.Tensor,
                g_norm: torch.Tensor, geom: BlockGeometry, *,
                block_m: Optional[int] = None) -> torch.Tensor:
    """``emulator_block_grid_cuda`` on weights already packed
    (``pack_grid_weights``' result for ``geom``, 16-byte aligned); counts
    the launch.  Returns (M, NB*NO, O) float32."""
    if v01.device.type != "cuda":
        raise ValueError("emulator_block_grid_cuda takes CUDA tensors (got "
                         f"{v01.device}); CPU tensors go to the plain version")
    dev = v01.device
    wpack, gid = packed
    M, NB, NO = _grid_shapes(v01, g_norm)
    _, D, H, W = geom.chw
    _check("v01", v01, (M, NB, D, H), dev)
    _check("g_norm", g_norm, (NB * NO, D, H, W), dev)
    _check_pack(wpack, gid, geom, dev)
    if v01.data_ptr() % 8:
        raise ValueError("v01 must start on an 8-byte boundary (float2 reads)")
    if NB * NO >= 2 ** 31:
        raise ValueError(f"{NB * NO} blocks exceed the grid's x dimension")
    bm = default_block_m(M) if block_m is None else int(block_m)
    if bm < 1 or -(-M // bm) > 65535:
        raise ValueError(f"block_m={bm} gives an invalid grid for M={M}")
    out = torch.empty((M, NB * NO, geom.outputs), dtype=torch.float32,
                      device=dev)
    if M == 0:
        return out
    lib = _block_library()
    if wpack.numel() != lib.emulator_block_grid_weights(gid):
        raise ValueError(f"pack_grid_weights gave {wpack.numel()} floats, the "
                         f"kernel takes {lib.emulator_block_grid_weights(gid)}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.launched(lib.emulator_block_grid_f32(
        gid, v01.data_ptr(), g_norm.data_ptr(), wpack.data_ptr(),
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
