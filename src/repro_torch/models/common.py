"""Shared model infrastructure: parameter schemas, the dense hook, norms
(rmsnorm, layernorm), activations, RoPE (the port of
``repro.models.common``).

A module is (schema function, plain apply function over a dict of
tensors).  ``init_params`` materializes a schema with one
``torch.Generator`` per parameter, seeded from the seed and the crc32 of
the parameter's key path -- so a parameter's values do not depend on
which other parameters exist or on the interpreter's hash salt.

Each schema leaf carries the reference's partition spec (``P``;
``dense_schema`` is ``P(fsdp, tp)``).  On a mesh -- a ``torch.
distributed`` ``DeviceMesh`` over the ranks of a process group, or a
``MeshShape`` of axis names and sizes only -- ``sanitize_spec`` applies
the reference's rule (an axis absent from the mesh, or one that does not
divide the dim, leaves the dim replicated) and ``window`` is the slice
of a leaf a rank holds; ``parallel.train_mesh`` gathers a leaf from its
windows.  ``use_mesh`` puts the model's functions on a training mesh.
"""
from __future__ import annotations

import contextlib
import math
import threading
import zlib
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import DeviceLike, resolve_device


# --------------------------------------------------------------------------- #
# Placements: partition specs, the mesh context and a rank's window
# --------------------------------------------------------------------------- #
class P(tuple):
    """A partition spec (the reference's ``PartitionSpec``): one entry a
    dim, each None (replicated), a mesh axis name, or a tuple of names
    (the dim split over their product, the first name major).  Dims past
    the entries are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


class MeshShape(NamedTuple):
    """A mesh known by its axis names and sizes only, with this rank's
    coordinates: what the dry run places leaves on (a ``DeviceMesh`` of
    the production mesh's 256 or 512 ranks needs a live group of that
    size).  Holds no group: nothing can be gathered on it."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...] = ()


class _MeshState(threading.local):
    def __init__(self):
        self.mesh = None


_MESH = _MeshState()


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the model's functions on ``mesh`` (a training ``DeviceMesh``
    over the ranks of a process group) for the duration: the batch rows
    they see are this rank's over (pod, data), and the products split
    over model (``parallel.train_mesh``)."""
    prev = _MESH.mesh
    _MESH.mesh = mesh
    try:
        yield mesh
    finally:
        _MESH.mesh = prev


def current_mesh():
    return _MESH.mesh


def mesh_axes(mesh) -> Dict[str, int]:
    """axis name -> size of ``mesh`` (a ``DeviceMesh`` or a ``MeshShape``;
    {} for None)."""
    if mesh is None:
        return {}
    return {a: int(n) for a, n in zip(mesh.mesh_dim_names, mesh.shape)}


def mesh_coords(mesh) -> Dict[str, int]:
    """axis name -> this rank's coordinate on ``mesh``."""
    if mesh is None:
        return {}
    if isinstance(mesh, MeshShape):
        c = mesh.coords or (0,) * len(mesh.shape)
        return dict(zip(mesh.mesh_dim_names, c))
    return {a: int(mesh.get_local_rank(a)) for a in mesh.mesh_dim_names}


def dp_axes(mesh=None) -> Tuple[str, ...]:
    """The axes the global batch is sharded over."""
    mesh = current_mesh() if mesh is None else mesh
    names = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(name, mesh=None) -> int:
    """The size of a mesh axis, or the product of a tuple of axes (1 for
    an axis absent from the mesh, or without a mesh)."""
    mesh = current_mesh() if mesh is None else mesh
    if isinstance(name, (tuple, list)):
        n = 1
        for a in name:
            n *= axis_size(a, mesh)
        return n
    return mesh_axes(mesh).get(name, 1)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (none for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def sanitize_spec(shape: Tuple[int, ...], spec, mesh=None) -> P:
    """The reference's ``_sanitize_spec``: an axis absent from the mesh is
    dropped from its entry, and an entry whose axes do not divide the dim
    (or have size 1) leaves the dim replicated; trailing Nones go."""
    mesh = current_mesh() if mesh is None else mesh
    present = mesh_axes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, ent in zip(shape, entries):
        axes = tuple(a for a in entry_axes(ent) if a in present)
        n = axis_size(axes, mesh)
        if not axes or n <= 1 or dim % n:
            out.append(None)
        else:
            out.append(axes if len(axes) > 1 else axes[0])
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a (sanitized) spec shards over."""
    return tuple(a for ent in spec for a in entry_axes(ent))


def shard_shape(shape: Tuple[int, ...], spec, mesh=None) -> Tuple[int, ...]:
    """A rank's window shape of a leaf of ``shape`` under ``spec``
    (sanitized here): each sharded dim divided by its axes' size."""
    sp = sanitize_spec(shape, spec, mesh)
    return tuple(d // axis_size(e, mesh) if e is not None else d
                 for d, e in zip(shape, tuple(sp) + (None,) * len(shape)))


def window(shape: Tuple[int, ...], spec, mesh=None,
           coords: Optional[Dict[str, int]] = None) -> Tuple[slice, ...]:
    """This rank's window of a leaf of ``shape`` under ``spec`` (sanitized
    here): on a dim split over axes (a, b, ...), block number
    ``c_a * |b|... + c_b ...`` of the dim's ``|a| * |b| ...`` blocks.
    ``coords`` defaults to the rank's coordinates on ``mesh``."""
    mesh = current_mesh() if mesh is None else mesh
    sp = sanitize_spec(shape, spec, mesh)
    cs = mesh_coords(mesh) if coords is None else coords
    out = []
    for d, ent in zip(shape, tuple(sp) + (None,) * len(shape)):
        if ent is None:
            out.append(slice(0, d))
            continue
        idx = 0
        for a in entry_axes(ent):
            idx = idx * axis_size(a, mesh) + cs.get(a, 0)
        n = d // axis_size(ent, mesh)
        out.append(slice(idx * n, (idx + 1) * n))
    return tuple(out)


# --------------------------------------------------------------------------- #
# Parameter schemas
# --------------------------------------------------------------------------- #
class ParamSchema(NamedTuple):
    shape: Tuple[int, ...]
    init: str = "normal"        # normal | zeros | ones | embed
    scale: float = 1.0          # stddev for "normal"/"embed"
    dtype: Any = torch.float32
    spec: P = P()               # the reference's placement of the leaf


def dense_schema(d_in: int, d_out: int, *, fsdp="data", tp="model",
                 scale: Optional[float] = None) -> ParamSchema:
    """2-D (FSDP x TP) sharded projection weight: P(fsdp, tp)."""
    s = scale if scale is not None else d_in ** -0.5
    return ParamSchema((d_in, d_out), "normal", s, spec=P(fsdp, tp))


def is_schema_leaf(x) -> bool:
    return isinstance(x, ParamSchema)


def stack_schema(schema, n: int):
    """Add a leading stacked-layers dim of size n to every leaf (its spec
    gains a replicated entry)."""
    if is_schema_leaf(schema):
        return schema._replace(shape=(n,) + tuple(schema.shape),
                               spec=P(None, *schema.spec))
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
        return _draw(seed, path, p, dtype, dev)

    def walk(node, path):
        if is_schema_leaf(node):
            return init_one(path, node)
        return {k: walk(v, path + (k,)) for k, v in node.items()}

    return walk(schema, ())


def init_windows(seed: int, schema, mesh, dtype=torch.float32,
                 device: DeviceLike = None):
    """``init_params`` on a mesh: this rank's window of each leaf
    (``window``), a tensor of its own.  A drawn leaf is drawn whole, as
    ``init_params`` draws it, and its window kept: the unsharded init's
    values, bit for bit, one leaf whole at a time."""
    dev = resolve_device(device)

    def walk(node, path):
        if not is_schema_leaf(node):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        dt = node.dtype if node.dtype != torch.float32 else dtype
        shp = shard_shape(node.shape, node.spec, mesh)
        if node.init in ("zeros", "ones"):
            fill = torch.zeros if node.init == "zeros" else torch.ones
            return fill(shp, dtype=dt, device=dev)
        full = _draw(seed, path, node, dtype, dev)
        return full[window(node.shape, node.spec, mesh)].clone(
            memory_format=torch.contiguous_format)

    return walk(schema, ())


def _draw(seed, path, p: ParamSchema, dtype, dev):
    dt = p.dtype if p.dtype != torch.float32 else dtype
    g = torch.Generator(device=dev)
    g.manual_seed(fold_seed(seed, key_path(path)))
    x = torch.randn(p.shape, generator=g, dtype=torch.float32, device=dev)
    return (x * p.scale).to(dt)


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in ``jax.tree.leaves``' order (keys
    sorted at every level)."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    return [tree]


def tree_items(tree, path: Tuple[str, ...] = ()):
    """(key path, leaf) pairs in ``tree_leaves``' order; the path spelt as
    ``key_path`` spells it."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in tree_items(tree[k],
                                                             path + (k,))]
    return [(key_path(path), tree)]


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


def current_dense_hook():
    """The hook ``use_dense_hook`` installed on this thread (or None)."""
    return _HOOK.fn


def dense(x: torch.Tensor, w: torch.Tensor, tag: str = "") -> torch.Tensor:
    """y = x @ w over the last dim of x; interceptable by the analog backend.
    On a training mesh (``use_mesh``) with a model axis the product is
    split over it (``parallel.train_mesh.split_dense``)."""
    if _HOOK.fn is not None:
        out = _HOOK.fn(x, w, tag)
        if out is not None:
            return out
    mesh = current_mesh()
    if mesh is not None and axis_size("model", mesh) > 1:
        from repro_torch.parallel.train_mesh import split_dense
        return split_dense(x, w, tag, mesh)
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


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Statistics in float32 (mean, then the mean square of ``x - mu``),
    scale and shift in float32, the result in x's dtype."""
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def norm_schema(d: int, kind: str):
    if kind == "layernorm":
        return {"w": ParamSchema((d,), "ones", spec=P(None)),
                "b": ParamSchema((d,), "zeros", spec=P(None))}
    return {"w": ParamSchema((d,), "ones", spec=P(None))}


def apply_norm(params, x, kind: str):
    if kind == "layernorm":
        return layernorm(x, params["w"], params["b"])
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


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` op for op: ``1 / (1 + exp(-x))``, each operation
    rounded in x's dtype (``torch.sigmoid`` rounds once, and in bfloat16
    differs from the reference in about a third of its outputs)."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``, with the reference's sigmoid."""
    return x * sigmoid(x)


def activation(name: str):
    return {"silu": silu, "gelu": gelu, "relu": F.relu, "celu": celu}[name]


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

