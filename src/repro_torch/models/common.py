"""Shared model infrastructure: parameter schemas, the dense hook, norms,
activations, RoPE (the port of ``repro.models.common``).

A module is (schema function, plain apply function over a dict of
tensors).  ``init_params`` materializes a schema with one
``torch.Generator`` per parameter, seeded from the seed and the crc32 of
the parameter's key path -- so a parameter's values do not depend on
which other parameters exist or on the interpreter's hash salt.
"""
from __future__ import annotations

import contextlib
import math
import threading
import zlib
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import DeviceLike, resolve_device


# --------------------------------------------------------------------------- #
# Parameter schemas
# --------------------------------------------------------------------------- #
class ParamSchema(NamedTuple):
    shape: Tuple[int, ...]
    init: str = "normal"        # normal | zeros | ones | embed
    scale: float = 1.0          # stddev for "normal"/"embed"
    dtype: Any = torch.float32


def dense_schema(d_in: int, d_out: int, *,
                 scale: Optional[float] = None) -> ParamSchema:
    s = scale if scale is not None else d_in ** -0.5
    return ParamSchema((d_in, d_out), "normal", s)


def is_schema_leaf(x) -> bool:
    return isinstance(x, ParamSchema)


def stack_schema(schema, n: int):
    """Add a leading stacked-layers dim of size n to every leaf."""
    if is_schema_leaf(schema):
        return schema._replace(shape=(n,) + tuple(schema.shape))
    return {k: stack_schema(v, n) for k, v in schema.items()}


def key_path(path: Tuple[str, ...]) -> str:
    """The reference's ``jax.tree_util.keystr`` spelling of a dict path."""
    return "".join(f"[{k!r}]" for k in path)


def fold_seed(seed: int, tag: str) -> int:
    """A 32-bit generator seed from ``seed`` and a path or purpose: the
    crc32 of both.  Every device's generator keeps all of it (the CPU's
    mt19937 keeps only the low 32 bits of a wider seed)."""
    return zlib.crc32(f"{int(seed)}:{tag}".encode())


def init_params(seed: int, schema, dtype=torch.float32,
                device: DeviceLike = None):
    """Materialize a schema: one generator per leaf, seeded by
    ``fold_seed(seed, key path)``; draws are float32, cast to ``dtype``."""
    dev = resolve_device(device)

    def init_one(path, p: ParamSchema):
        dt = p.dtype if p.dtype != torch.float32 else dtype
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dt, device=dev)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dt, device=dev)
        g = torch.Generator(device=dev)
        g.manual_seed(fold_seed(seed, key_path(path)))
        x = torch.randn(p.shape, generator=g, dtype=torch.float32, device=dev)
        return (x * p.scale).to(dt)

    def walk(node, path):
        if is_schema_leaf(node):
            return init_one(path, node)
        return {k: walk(v, path + (k,)) for k, v in node.items()}

    return walk(schema, ())


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# --------------------------------------------------------------------------- #
# Dense hook: routes matmuls through an alternative executor (the analog
# backend installs itself here; default is a plain einsum).
# --------------------------------------------------------------------------- #
class _HookState(threading.local):
    def __init__(self):
        self.fn = None


_HOOK = _HookState()


@contextlib.contextmanager
def use_dense_hook(fn):
    prev = _HOOK.fn
    _HOOK.fn = fn
    try:
        yield
    finally:
        _HOOK.fn = prev


def dense(x: torch.Tensor, w: torch.Tensor, tag: str = "") -> torch.Tensor:
    """y = x @ w over the last dim of x; interceptable by the analog backend."""
    if _HOOK.fn is not None:
        out = _HOOK.fn(x, w, tag)
        if out is not None:
            return out
    return torch.matmul(x, w.to(x.dtype))


# --------------------------------------------------------------------------- #
# Scan-states channel: the stack runner announces each stacked period so
# a site-keying provider (``core.analog._StateBinding``) keys its call
# sites ``"{group}.{period}:{tag}#{j}"`` like the reference's scan.
# --------------------------------------------------------------------------- #
class _ScanStatesState(threading.local):
    def __init__(self):
        self.provider = None


_SCAN_STATES = _ScanStatesState()


@contextlib.contextmanager
def use_scan_states(provider):
    prev = _SCAN_STATES.provider
    _SCAN_STATES.provider = provider
    try:
        yield provider
    finally:
        _SCAN_STATES.provider = prev


def scan_states_provider():
    return _SCAN_STATES.provider


# --------------------------------------------------------------------------- #
# Numerics
# --------------------------------------------------------------------------- #
def promote(*xs: torch.Tensor):
    """Cast tensors to their common dtype (jnp's implicit promotion)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return tuple(x.to(dt) for x in xs)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, *promote(a, b))


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(dt)


def norm_schema(d: int, kind: str):
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r}: only rmsnorm is ported "
                                  "(other families: ROADMAP A9)")
    return {"w": ParamSchema((d,), "ones")}


def apply_norm(params, x, kind: str):
    return rmsnorm(x, params["w"])


def celu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.celu`` with alpha 1: ``x`` above zero, ``expm1(x)`` below."""
    return torch.where(x > 0, x, torch.expm1(x))


# XLA's float32 tanh returns exactly +-1 for |x| >= this (its clamp);
# libm's tanh only rounds to +-1 past ~9.01
_XLA_TANH_SATURATION = 7.99881172180175781


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` with its default tanh approximation, op for op.

    Written out rather than ``F.gelu(approximate="tanh")`` to keep the
    reference's EXACT zeros: gate-overdrive biasing maps a zero drive to
    0 V but any nonzero one to at least v_th, so a gelu output of -1e-30
    where the reference has 0 changes an analog mlp.down by O(1).  The
    reference's zeros come from XLA's tanh saturating to -1 at
    |x| >= 7.9988; constants are cast to x's dtype first, as jax does."""
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype, device=x.device)
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    inner = c * (x + k * (x * x * x))
    t = torch.where(inner.abs() >= _XLA_TANH_SATURATION, torch.sign(inner),
                    torch.tanh(inner))
    return x * (0.5 * (1.0 + t))


def activation(name: str):
    return {"silu": F.silu, "gelu": gelu, "relu": F.relu, "celu": celu}[name]


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #
def rope_freqs(head_dim: int, base: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return base ** (-torch.arange(0, half, dtype=torch.float32,
                                  device=device) / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions broadcastable to (..., S).

    Split-half rotation; angles in fp32, products in x's dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, base, x.device)
    ang = positions[..., None].float() * freqs
    if x.dim() == ang.dim() + 1:                      # head axis present
        ang = ang[..., None, :]
    cos = torch.cos(ang).to(x.dtype)
    sin = torch.sin(ang).to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

