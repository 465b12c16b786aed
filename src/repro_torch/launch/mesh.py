"""Meshes and the rank launcher (port of ``repro.launch.mesh``).

The reference builds its meshes over the devices of one jax process;
here a mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of a
process group, one process a rank.  ``launch(fn, world)`` starts them:
``world`` processes (spawn start method), each with an initialized group,
calling ``fn(rank, world, device, *args)`` and returning its result to
the caller.

The transport follows the ranks: NCCL when every rank has a CUDA card of
its own, gloo when ranks share a card or run on the CPU.  Gloo reduces
and broadcasts CUDA tensors (it stages them through the host) but
gathers none, so every collective of the serving plane is an
``all_reduce`` or a ``broadcast``; a rank's tensors stay on its card to
compute.  Ranks that share a card share its memory and its time.

``make_production_mesh`` is the dry run's 256- and 512-chip mesh by its
axis names and sizes (``models.common.MeshShape``): a ``DeviceMesh`` of
that many ranks needs a live group of them, and the dry run places
leaves through the same functions as the trainer without one.
"""
from __future__ import annotations

import socket
import traceback
from typing import Callable, List, Optional

import torch

from repro_torch import DeviceLike, resolve_device


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 chips per pod, ``("data", "model")``; 2 pods = 512
    chips, ``("pod", "data", "model")``, when ``multi_pod``: the axis
    names and sizes (``MeshShape``), rank 0's coordinates."""
    from repro_torch.models.common import MeshShape
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_mesh_for(devices: Optional[int] = None, *, model_axis: int = 1,
                  device: DeviceLike = None):
    """(data, model) mesh over the process group's ranks (``devices``
    defaults to the world size): shape (devices // model_axis,
    model_axis)."""
    import torch.distributed as dist
    from repro_torch.parallel.sharding import serve_mesh
    n = devices if devices is not None else dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"{n} ranks do not split into a model axis of "
                         f"{model_axis}")
    return serve_mesh(n // model_axis, model_axis, device)


def make_serve_mesh(dp: int = 1, tp: int = 1, device: DeviceLike = None):
    """(data, model) serving mesh for the tensor-parallel analog plane
    (``repro_torch.parallel.sharding``; ``serve --mesh DP,TP``)."""
    from repro_torch.parallel.sharding import serve_mesh
    return serve_mesh(dp, tp, device)


def transport(world: int, device: DeviceLike = None) -> str:
    """``nccl`` when each of ``world`` ranks gets a card of its own,
    ``gloo`` when they share cards or run on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, backend: str,
               dev_type: str, threads: int, fn: Callable, args: tuple,
               conn) -> None:
    import torch.distributed as dist
    try:
        torch.set_num_threads(threads)
        if dev_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = torch.device(dev_type)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        try:
            conn.send((True, fn(rank, world, device, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:      # noqa: BLE001 -- reported to the launcher
        conn.send((False, traceback.format_exc()))
        raise
    finally:
        conn.close()


def launch(fn: Callable, world: int, args: tuple = (),
           device: DeviceLike = None) -> List[object]:
    """Run ``fn(rank, world, device, *args)`` in ``world`` spawned
    processes joined in one process group; returns the ranks' results in
    rank order, or raises if any rank fails.  ``device`` is the ranks'
    device type (CUDA by default: rank r on card ``r % cards``; the CPU
    when asked for).  Each rank gets this process's intra-op threads
    shared out.  On CUDA the kernel libraries are built here first, so
    the ranks load them instead of racing to build them."""
    import multiprocessing.connection as mpc

    dev = resolve_device(device)
    backend = transport(world, dev)
    print(f"ranks: {world} on {dev.type}, transport {backend}", flush=True)
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    threads = max(1, torch.get_num_threads() // world)
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs, conns = [], []
    for rank in range(world):
        recv, send = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_rank_main, args=(
            rank, world, port, backend, dev.type, threads, fn, args, send),
            daemon=False)
        p.start()
        send.close()
        procs.append(p)
        conns.append(recv)
    results: List[object] = [None] * world
    errors, pending = [], dict(enumerate(conns))
    try:
        while pending:
            ready = mpc.wait(list(pending.values())
                             + [procs[r].sentinel for r in pending])
            for rank, conn in list(pending.items()):
                if conn in ready or procs[rank].sentinel in ready:
                    try:
                        ok, res = conn.recv()
                    except EOFError:
                        ok, res = False, (f"rank {rank} exited with code "
                                          f"{procs[rank].exitcode} without "
                                          "a result")
                    del pending[rank]
                    if ok:
                        results[rank] = res
                    else:
                        errors.append(f"rank {rank}:\n{res}")
            if errors:
                break
    finally:
        for p in procs:
            p.join(timeout=None if not errors else 30)
            if p.is_alive():
                p.terminate()
                p.join()
    if errors:
        raise RuntimeError("a rank failed\n" + "\n".join(errors))
    return results
