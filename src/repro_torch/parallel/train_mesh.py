"""Training on a mesh: the collectives of a sharded train step (the
port's counterpart of what GSPMD inserts for the reference's
``PartitionSpec``s; ``runtime.steps.make_train_step(mesh=)``).

A training mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks
of a process group with axes ``data`` and ``model``
(``launch.mesh.make_mesh_for``), one process a rank.  Each rank holds
its window of every leaf of the train state (``models.common.window``
under the leaf's sanitized spec), and the step computes on the rank's
rows of the batch:

  * a leaf is gathered whole for the step (``gather_leaf``): its window
    written into negative zeros, then one ``all_reduce`` over the axes
    its spec shards -- adding -0.0 leaves every value as it was, so the
    gathered leaf is the unsharded one, bit for bit.  Its gradient comes
    back to the window: the rank's gradient is sliced to its model
    window, summed over ``data`` (each data rank's rows add their part)
    and sliced to its data window.
  * the model axis splits the dense products (``split_dense``): rank t
    computes the output columns of its block, writes them into negative
    zeros, and one ``all_reduce`` over ``model`` completes the product
    (the columns are concatenated, not summed).  The backward's input
    gradient is split the same way over the weight's rows, and its
    weight gradient is computed for the rank's model window of the leaf
    only: the columns of a ``P(data, model)`` weight, the rows of the
    output projections' ``P(model, data)`` ones (``ROW_SPLIT_TAGS``).
    Everything else -- norms, the attention core, the recurrences, the
    experts -- runs replicated over ``model`` on the rank's rows, so a
    gradient there is the whole gradient on every model rank.
  * ``data`` collectives: a row gather (``gather_rows``; an MoE mixer
    routes over the whole batch's tokens) and sums and maxima of
    statistics (``data_sum``, ``data_max``: the loss's mask count, the
    analog drive scale).
  * ``model`` sequence collectives for the sequence-sharded residual
    stream (``seq_gather``, ``seq_scatter``); a norm applied to a rank's
    block of the sequence has its weight's gradient summed over ``model``
    (``model_sum_grad``).

Gloo, which carries ranks that share a card, reduces CUDA tensors but
gathers none, so every collective here is an ``all_reduce``.  The
forward and backward run the same collectives in the same order on
every rank of a group; a rank that raises alone leaves the others
waiting in a collective (the trainer's faults are raised on every rank
at the same step; one rank failing alone needs a new group).

``collective_times()`` collects the synchronized milliseconds of every
collective while it is open.
"""
from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import torch

from repro_torch.models.common import (axis_size, dp_axes, entry_axes,
                                       mesh_axes, mesh_coords, spec_axes,
                                       tree_leaves, window)

DATA_AXIS = "data"
MODEL_AXIS = "model"
# dense() sites whose weight the schemas place P(model, data) (the
# output projections: attention's wo, the MLP's w_down); every other
# site's weight is P(data, model)
ROW_SPLIT_TAGS = ("attn.o", "mlp.down")

_TIMES: List[Optional[list]] = [None]


@contextlib.contextmanager
def collective_times():
    """Collect each collective's synchronized milliseconds into the list
    yielded, for the duration."""
    prev, _TIMES[0] = _TIMES[0], []
    try:
        yield _TIMES[0]
    finally:
        _TIMES[0] = prev


def _all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    import torch.distributed as dist
    op = dist.ReduceOp.SUM if op is None else op
    rec = _TIMES[0]
    if rec is None:
        dist.all_reduce(t, op=op, group=group)
        return t
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    dist.all_reduce(t, op=op, group=group)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    rec.append((time.perf_counter() - t0) * 1e3)
    return t


def _fill(shape, like: torch.Tensor) -> torch.Tensor:
    """Negative zeros (the float sum's identity) or integer zeros."""
    v = -0.0 if like.is_floating_point() else 0
    return torch.full(tuple(shape), v, dtype=like.dtype, device=like.device)


# --------------------------------------------------------------------------- #
# Mesh geometry
# --------------------------------------------------------------------------- #
def model_size(mesh) -> int:
    return axis_size(MODEL_AXIS, mesh)


def model_index(mesh) -> int:
    return mesh_coords(mesh).get(MODEL_AXIS, 0)


def data_size(mesh) -> int:
    return axis_size(dp_axes(mesh), mesh)


def data_index(mesh) -> int:
    """This rank's block of the batch over the (pod, data) axes."""
    cs, idx = mesh_coords(mesh), 0
    for a in dp_axes(mesh):
        idx = idx * axis_size(a, mesh) + cs[a]
    return idx


def axes_group(mesh, axes):
    """The process group of the ranks that differ only on ``axes`` (None:
    the default group, when ``axes`` are every axis of a mesh over the
    whole world)."""
    import torch.distributed as dist
    axes = tuple(dict.fromkeys(axes))
    names = tuple(mesh.mesh_dim_names)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if set(axes) == set(names) and mesh.size() == dist.get_world_size():
        return None
    raise NotImplementedError(f"a collective over axes {axes} of a mesh "
                              f"{names}")


def check_training_mesh(mesh) -> None:
    """A training mesh is a ``DeviceMesh`` over the whole process group
    whose axes are ``data`` and ``model`` (either may be absent)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"a training mesh is a DeviceMesh "
                        f"(launch.mesh.make_mesh_for), not {type(mesh)!r}")
    extra = set(mesh.mesh_dim_names) - {DATA_AXIS, MODEL_AXIS}
    if extra:
        raise ValueError(f"a training mesh has the axes data and model, not "
                         f"{sorted(extra)}")
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh holds {mesh.size()} ranks of a process "
                         f"group of {dist.get_world_size()}")


def batch_rows(global_batch: int, mesh, grad_accum: int = 1) -> torch.Tensor:
    """The global batch rows a rank holds, in order: microbatch i (rows
    ``[i * B/m, (i+1) * B/m)``, the unsharded step's) split over the data
    axes, so the rank's microbatch i is rows ``[i * B/(m*dp), ...)`` of
    its own.  Raises where the rows do not split."""
    dp, d, m = data_size(mesh), data_index(mesh), max(1, grad_accum)
    if global_batch % (dp * m):
        raise ValueError(f"a global batch of {global_batch} does not split "
                         f"into {m} microbatches over {dp} data ranks")
    n = global_batch // (dp * m)
    return torch.cat([torch.arange(n) + i * (global_batch // m) + d * n
                      for i in range(m)])


# --------------------------------------------------------------------------- #
# Leaves: gathered for the step, their gradients back to the window
# --------------------------------------------------------------------------- #
def gather_leaf(win: torch.Tensor, shape, spec, mesh) -> torch.Tensor:
    """The whole leaf of ``shape`` from each rank's ``win`` under the
    sanitized ``spec`` (every rank of the spec's axes calls it; no
    autograd)."""
    axes = spec_axes(spec)
    if not axes:
        return win
    z = _fill(shape, win)
    z[window(tuple(shape), spec, mesh)] = win
    return _all_reduce(z, axes_group(mesh, axes))


def reduce_leaf_grad(g: torch.Tensor, spec, mesh) -> torch.Tensor:
    """A rank's gradient of a whole leaf -> its window of the step's
    gradient: sliced to the model window (where the rank's gradient is
    whole), summed in float32 over the data axes, sliced to the data
    window.  Returned in ``g``'s dtype."""
    shape = tuple(g.shape)
    win = window(shape, spec, mesh)
    dp = dp_axes(mesh)
    ents = tuple(spec) + (None,) * len(shape)
    first = tuple(slice(None) if any(a in dp for a in entry_axes(e)) else w
                  for w, e in zip(win, ents))
    gm = g[first].to(torch.float32, copy=True).contiguous()
    if data_size(mesh) > 1:
        _all_reduce(gm, axes_group(mesh, dp))
    second = tuple(w if any(a in dp for a in entry_axes(e)) else slice(None)
                   for w, e in zip(win, ents))
    return gm[second].to(g.dtype).contiguous()


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, win, shape, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return gather_leaf(win, shape, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        return reduce_leaf_grad(g, ctx.spec, ctx.mesh), None, None, None


def gather_tree(windows, specs, shapes, mesh):
    """``gather_leaf`` over a tree, under autograd (``_GatherLeaf``)."""
    if isinstance(windows, dict):
        return {k: gather_tree(windows[k], specs[k], shapes[k], mesh)
                for k in windows}
    return _GatherLeaf.apply(windows, tuple(shapes), specs, mesh)


def global_norm(grads, specs, mesh) -> torch.Tensor:
    """The global norm of a tree of gradient windows: each rank adds the
    float32 squares of the windows it is the first holder of (its
    coordinate 0 on every axis the leaf's spec does not shard), and one
    ``all_reduce`` over the mesh adds the ranks'."""
    cs = mesh_coords(mesh)
    gs, sps = tree_leaves(grads), tree_leaves(specs)
    dev = gs[0].device
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    for g, sp in zip(gs, sps):
        used = set(spec_axes(sp))
        if all(cs[a] == 0 for a in mesh_axes(mesh) if a not in used):
            acc = acc + torch.sum(torch.square(g.float()))
    acc = acc.reshape(1)
    _all_reduce(acc, axes_group(mesh, tuple(mesh.mesh_dim_names)))
    return torch.sqrt(acc[0])


# --------------------------------------------------------------------------- #
# The model axis: split products, the sequence-sharded residual
# --------------------------------------------------------------------------- #
def _block(n: int, tp: int, t: int) -> Optional[slice]:
    if tp <= 1 or n % tp:
        return None
    k = n // tp
    return slice(t * k, (t + 1) * k)


class _SplitDense(torch.autograd.Function):
    """y = x @ w with the model axis splitting the columns of the
    product, the rows of the input gradient, and the weight gradient to
    the rank's model window (``row``: rows of w, else its columns)."""

    @staticmethod
    def forward(ctx, x, w, row, mesh):
        tp, t = model_size(mesh), model_index(mesh)
        wc = w.to(x.dtype)
        K, N = w.shape
        cols = _block(N, tp, t)
        grp = mesh.get_group(MODEL_AXIS)
        if cols is None:
            y = torch.matmul(x, wc)
        else:
            y = _fill(x.shape[:-1] + (N,), x.new_empty(()))
            y[..., cols] = torch.matmul(x, wc[:, cols])
            _all_reduce(y, grp)
        ctx.save_for_backward(x, w)
        ctx.row, ctx.mesh = row, mesh
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        mesh = ctx.mesh
        tp, t = model_size(mesh), model_index(mesh)
        grp = mesh.get_group(MODEL_AXIS)
        K, N = w.shape
        wc = w.to(gy.dtype)
        rows = _block(K, tp, t)
        if rows is None:
            gx = torch.matmul(gy, wc.T)
        else:
            gx = _fill(gy.shape[:-1] + (K,), gy.new_empty(()))
            gx[..., rows] = torch.matmul(gy, wc[rows].T)
            _all_reduce(gx, grp)
        x2 = x.reshape(-1, K).to(gy.dtype)
        g2 = gy.reshape(-1, N)
        gw = torch.zeros((K, N), dtype=gy.dtype, device=gy.device)
        blk = rows if ctx.row else _block(N, tp, t)
        if blk is None:
            gw = x2.T @ g2
        elif ctx.row:
            gw[blk] = x2[:, blk].T @ g2
        else:
            gw[:, blk] = x2.T @ g2[:, blk]
        return gx.to(x.dtype), gw.to(w.dtype), None, None


def split_dense(x: torch.Tensor, w: torch.Tensor, tag: str,
                mesh) -> torch.Tensor:
    """``x @ w`` of a dense() site on a training mesh's model axis
    (``_SplitDense``); ``tag`` says which window of w the rank's weight
    gradient covers (``ROW_SPLIT_TAGS``)."""
    return _SplitDense.apply(x, w, tag in ROW_SPLIT_TAGS, mesh)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        tp, t = model_size(mesh), model_index(mesh)
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * tp
        z = _fill(shape, x)
        z.narrow(dim, t * n, n).copy_(x)
        ctx.dim, ctx.n, ctx.t = dim, n, t
        return _all_reduce(z, mesh.get_group(MODEL_AXIS))

    @staticmethod
    def backward(ctx, g):
        # every model rank holds the whole (replicated) gradient
        return g.narrow(ctx.dim, ctx.t * ctx.n, ctx.n).contiguous(), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        tp, t = model_size(mesh), model_index(mesh)
        n = x.shape[dim] // tp
        ctx.dim, ctx.n, ctx.t, ctx.mesh = dim, n, t, mesh
        return x.narrow(dim, t * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        shape = list(g.shape)
        shape[ctx.dim] = ctx.n * model_size(ctx.mesh)
        z = _fill(shape, g)
        z.narrow(ctx.dim, ctx.t * ctx.n, ctx.n).copy_(g)
        return _all_reduce(z, ctx.mesh.get_group(MODEL_AXIS)), None, None


class _ModelSumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, mesh):
        ctx.mesh = mesh
        return p.view_as(p)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return _all_reduce(g, ctx.mesh.get_group(MODEL_AXIS)), None


def model_sum_grad(p: torch.Tensor, mesh) -> torch.Tensor:
    """``p`` as it is, its gradient summed over the model axis: a leaf
    used on each model rank's block of the sequence (a norm's weight on
    the sequence-sharded residual) has a part of its gradient on every
    rank."""
    return _ModelSumGrad.apply(p, mesh)


def seq_gather(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """The whole sequence from each model rank's block of it."""
    return _GatherSeq.apply(x, dim, mesh)


def seq_scatter(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """This model rank's block of a (replicated) sequence."""
    return _ScatterSeq.apply(x, dim, mesh)


# --------------------------------------------------------------------------- #
# The data axes
# --------------------------------------------------------------------------- #
class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        dp, d = data_size(mesh), data_index(mesh)
        n = x.shape[0]
        z = _fill((n * dp,) + tuple(x.shape[1:]), x)
        z[d * n:(d + 1) * n] = x
        ctx.n, ctx.d, ctx.mesh = n, d, mesh
        return _all_reduce(z, axes_group(mesh, dp_axes(mesh)))

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        _all_reduce(g, axes_group(ctx.mesh, dp_axes(ctx.mesh)))
        return g[ctx.d * ctx.n:(ctx.d + 1) * ctx.n], None


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every data rank's rows of ``x`` in batch order (each data rank's
    loss adds its part: the backward sums the row gradients over data and
    keeps the rank's own)."""
    if data_size(mesh) <= 1:
        return x
    return _GatherRows.apply(x, mesh)


def local_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This data rank's block of rows of a gathered ``x``."""
    dp, d = data_size(mesh), data_index(mesh)
    if dp <= 1:
        return x
    n = x.shape[0] // dp
    return x[d * n:(d + 1) * n]


def data_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``t`` over the data axes (a new tensor; no autograd)."""
    out = t.detach().clone()
    if data_size(mesh) > 1:
        _all_reduce(out, axes_group(mesh, dp_axes(mesh)))
    return out


def data_max(t: torch.Tensor, mesh) -> torch.Tensor:
    """The maximum of ``t`` over the data axes (a new tensor)."""
    import torch.distributed as dist
    out = t.detach().clone()
    if data_size(mesh) > 1:
        _all_reduce(out, axes_group(mesh, dp_axes(mesh)), dist.ReduceOp.MAX)
    return out


def model_reduce(t: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """``t`` summed (or maxed) over the model axis, in place."""
    import torch.distributed as dist
    if model_size(mesh) > 1:
        _all_reduce(t, mesh.get_group(MODEL_AXIS),
                    dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)
    return t
