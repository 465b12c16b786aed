"""Tensor-parallel partitioning of the analog serving plane (port of
``repro.parallel.sharding``).

A ``DeploymentState``'s conductance field ``gf`` -- by far its largest
leaf, ``(NB, NO, D, H, W)`` over the whole tile lattice -- need not live
in full in every process: on a ``(data, model)`` mesh of ranks each rank
keeps only its window of the lattice, and the executor's sharded forward
(``core.analog.AnalogExecutor._sharded_matmul``) evaluates that window
and completes the digital bitline accumulation with one ``all_reduce``.

Mesh axes (``serve_mesh(dp, tp)``, a ``torch.distributed`` ``DeviceMesh``
over the ranks of an initialized process group, rank ``r`` at
``(r // tp, r % tp)``):

  data   -- batch rows.  Bit-exact: rows are independent, and the drive
            scale is the max over the whole call, taken before the split.
  model  -- the tile lattice.  Two schemes (``lattice_scheme``):

    col -- the NO axis (output groups).  Each rank runs the FULL NB
           reduction of its own columns in the replicated path's order,
           writes them into an output of negative zeros elsewhere, and
           one ``all_reduce`` over ``model`` adds the ranks' outputs:
           adding -0.0 leaves every value, its sign and a NaN as they
           were, so col is BIT-IDENTICAL to the replicated path.
    row -- the NB axis (block groups).  Each rank sums its own block
           groups, the ``all_reduce`` hands every rank every rank's
           partial sums (each written into negative zeros), and each
           rank finishes the block-group sum.  Where each rank holds a
           power-of-two run of groups its partial is a node of the
           replicated path's summation tree (``core.crossbar.
           sum_block_groups``), so row is bit-identical too; otherwise
           the float32 sum is bracketed anew and row agrees to float
           tolerance.  The reference adds the partials in the
           collective (a ``psum``): float tolerance always, 1/tp of the
           bytes.

  ``lattice_scheme`` prefers ``col``; ``row`` when only NB divides the
  model axis; None (the lattice replicated over ``model``) otherwise.

Doctest (pure partition math; no process group needed):

    >>> lattice_scheme(nb=2, no=8, tp=4)
    'col'
    >>> lattice_scheme(nb=8, no=6, tp=4)
    'row'
    >>> lattice_scheme(nb=3, no=5, tp=4) is None
    True
    >>> local_lattice(nb=8, no=6, tp=4, scheme='row')
    (2, 6)
    >>> shard_output_slices(no=8, cols_per_group=1, tp=4)
    [(0, 2), (2, 4), (4, 6), (6, 8)]

The reference places each leaf with a ``PartitionSpec`` and lets
``device_put`` move whole arrays between meshes; here a rank holds only
its window, so ``state_pspecs`` is a table from each field to the lattice
axis it is sliced on, ``shard_deployment_state`` keeps this rank's window
of a full state, and ``gather_deployment_state`` rebuilds the full state
(an ``all_reduce`` of negative-zero-filled windows over ``model``) where a
full one is needed: to save it.  A deployment npz holds values, not
placements, so a state saved under one mesh shape loads onto any other.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


# --------------------------------------------------------------------------- #
# Pure partition math
# --------------------------------------------------------------------------- #
def lattice_scheme(nb: int, no: int, tp: int) -> Optional[str]:
    """Which lattice axis the ``model`` mesh axis shards for a plan with
    ``nb`` block groups (rows) x ``no`` output groups (columns).

    Prefers ``'col'`` (bit-identical to the replicated path) whenever NO
    divides ``tp``; falls back to ``'row'`` (one all_reduce on the
    bitline reduction, float-tolerance identity) when only NB divides;
    returns ``None`` -- replicate the lattice over ``model`` -- when
    neither does.  ``tp == 1`` always replicates."""
    if tp <= 1:
        return None
    if no % tp == 0:
        return "col"
    if nb % tp == 0:
        return "row"
    return None


def local_lattice(nb: int, no: int, tp: int,
                  scheme: Optional[str]) -> Tuple[int, int]:
    """Per-rank (NB_local, NO_local) under ``scheme``."""
    if scheme == "row":
        return nb // tp, no
    if scheme == "col":
        return nb, no // tp
    return nb, no


def shard_output_slices(no: int, cols_per_group: int,
                        tp: int) -> List[Tuple[int, int]]:
    """The [start, stop) output-column range each ``col``-scheme rank
    owns.  These ranges tile [0, no * cols_per_group) exactly -- no
    column dropped, duplicated or reordered."""
    assert no % tp == 0, (no, tp)
    w = (no // tp) * cols_per_group
    return [(s * w, (s + 1) * w) for s in range(tp)]


def lattice_window(nb: int, no: int, tp: int, scheme: Optional[str],
                   index: int) -> Tuple[slice, slice]:
    """(NB slice, NO slice) of the lattice that model-axis rank ``index``
    holds under ``scheme`` (the whole lattice when it replicates)."""
    nb_l, no_l = local_lattice(nb, no, tp, scheme)
    if scheme == "row":
        return slice(index * nb_l, (index + 1) * nb_l), slice(0, no)
    if scheme == "col":
        return slice(0, nb), slice(index * no_l, (index + 1) * no_l)
    return slice(0, nb), slice(0, no)


def keep_window(t: torch.Tensor, win: Tuple[slice, slice]) -> torch.Tensor:
    """The ``win`` window of a lattice field as a tensor of its own: a
    contiguous copy, never a view that would keep the whole field's
    storage alive (a slice of a one-block-group lattice is contiguous)."""
    return t[win].clone(memory_format=torch.contiguous_format)


def state_pspecs(scheme: Optional[str]) -> Dict[str, Optional[int]]:
    """field name -> the lattice axis of that ``DeploymentState`` field a
    rank keeps its window of (0: NB, 1: NO), or None to replicate it.

      gf         (NB, NO, D, H, W) -> row: 0, col: 1
      read_sigma (NB, NO)          -> the same axis
      read_key / out_perm / eparams / sfeat / cal_a / cal_b -> None

    ``out_perm`` and the calibration affine act on the full output after
    the reduction; ``read_key`` draws the whole field on every rank (the
    draw is mesh-invariant); ``eparams`` is shared; ``sfeat`` is small,
    and a per-tile one is windowed by the forward itself."""
    ax = {"row": 0, "col": 1}.get(scheme)
    return {"gf": ax, "read_sigma": ax, "read_key": None, "out_perm": None,
            "eparams": None, "sfeat": None, "cal_a": None, "cal_b": None}


# --------------------------------------------------------------------------- #
# Mesh
# --------------------------------------------------------------------------- #
def serve_mesh(dp: int = 1, tp: int = 1, device=None):
    """A (data, model) serving mesh over the ``dp * tp`` ranks of the
    initialized process group, on ``device``'s type (default: CUDA; the
    CPU when asked for).  Raises if the world size is not ``dp * tp``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import resolve_device
    if not dist.is_initialized():
        raise RuntimeError(
            f"serve_mesh({dp}, {tp}) needs an initialized process group "
            "(launch.mesh.launch starts one rank a process)")
    n, world = dp * tp, dist.get_world_size()
    if n != world:
        raise ValueError(f"serve_mesh({dp}, {tp}) needs {n} ranks, the "
                         f"process group has {world}")
    dev = resolve_device(device)
    return DeviceMesh(dev.type, torch.arange(n).reshape(dp, tp),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_shape(mesh) -> Tuple[int, int]:
    """(dp, tp) of a serving mesh (1, 1 when mesh is None); absent axes
    count as size 1."""
    if mesh is None:
        return 1, 1
    shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return int(shape.get(DATA_AXIS, 1)), int(shape.get(MODEL_AXIS, 1))


def mesh_coords(mesh) -> Tuple[int, int]:
    """This rank's (data, model) coordinates on ``mesh``."""
    if mesh is None:
        return 0, 0
    names = mesh.mesh_dim_names
    return tuple(int(mesh.get_local_rank(a)) if a in names else 0
                 for a in (DATA_AXIS, MODEL_AXIS))


def _window_key(mesh, scheme) -> Tuple[int, int, tuple]:
    """(tp, model index, window key) of this rank under ``scheme``."""
    _, tp = mesh_shape(mesh)
    _, t = mesh_coords(mesh)
    return tp, t, (scheme, tp, t)


def shard_deployment_state(st, mesh, scheme: Optional[str]):
    """Keep this rank's window of ``st``'s lattice fields
    (``state_pspecs``).  Idempotent; a state loaded from an npz, or
    materialized in full, is sliced anew.  A state that holds another
    mesh's window cannot be re-sliced here (the rest of its lattice lives
    in other processes): save it and load it under the new mesh."""
    if scheme is None:
        return st
    tp, t, key = _window_key(mesh, scheme)
    lat = st.window
    if lat is not None:
        if lat[:3] == key:
            return st
        raise ValueError(f"state holds the window {lat[:3]} of another mesh "
                         f"or scheme, not {key}; re-shard it through "
                         "save_deployment / load_deployment")
    nb, no = int(st.gf.shape[0]), int(st.gf.shape[1])
    snb, sno = lattice_window(nb, no, tp, scheme, t)
    new = st.replace(gf=keep_window(st.gf, (snb, sno)),
                     read_sigma=keep_window(st.read_sigma, (snb, sno)))
    new.known_noise(st.has_read_noise)       # the flag is the whole field's
    return new.in_window(key + (nb, no))


def gather_deployment_state(st, mesh):
    """The full state of a windowed one (``shard_deployment_state``):
    each lattice field written into negative zeros at its window, then
    one ``all_reduce`` over ``model`` (every rank of the axis calls it;
    the sum is exact).  A full state is returned as it is."""
    import torch.distributed as dist
    lat = st.window
    if lat is None:
        return st
    scheme, tp, t, nb, no = lat
    snb, sno = lattice_window(nb, no, tp, scheme, t)
    grp = mesh.get_group(MODEL_AXIS)
    full = {}
    for f in ("gf", "read_sigma"):
        v = getattr(st, f)
        z = torch.full((nb, no) + tuple(v.shape[2:]), -0.0, dtype=v.dtype,
                       device=v.device)
        z[snb, sno] = v
        dist.all_reduce(z, group=grp)
        full[f] = z
    return st.replace(**full).known_noise(st.has_read_noise)
