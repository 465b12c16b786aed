"""Checkpoints of tensor trees in the reference's on-disk format (port of
``repro.checkpoint.manager``), so that each package restores the other's.

A checkpoint of step s is the directory ``step_%08d/`` holding
``arrays.npz`` -- one array per leaf, keyed by its path as
``jax.tree_util.keystr`` spells it (``['params']['embed']``) -- and
``MANIFEST.json`` (step, time, keys, shapes, dtypes, extra).  Every leaf
is saved as its full array, so a restore does not depend on how the
state was laid out.  Durability: the directory is written as ``.tmp``
and renamed (an atomic publish), the last ``keep`` are kept, and the
write may run on a background thread (the device-to-host copy is the
only synchronous part).  numpy has no bfloat16: such a leaf is saved
widened to float32 and restored to the template's dtype.

``last_save_s`` (the device-to-host copy), ``last_write_s`` (the
serialization) and ``last_restore_s`` (read, then copy to the device)
record the host seconds of the latest of each.

On a mesh (``CheckpointManager(mesh=, specs=)``: the training
``DeviceMesh`` and each leaf's sanitized spec in the state's shape,
``runtime.steps.train_state_specs``) checkpoints stay mesh-agnostic:
every rank calls ``save``, each leaf is gathered whole from the ranks'
windows
(``parallel.train_mesh.gather_leaf``) and rank 0 writes the npz an
unsharded trainer writes; ``restore`` takes each rank's window of the
saved arrays, so a checkpoint written under one mesh restores onto any
other, or into one process.  ``wait`` ends with a collective over the
mesh after rank 0's write, so every rank agrees on ``latest_step()``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.models.common import axis_size, key_path, tree_items


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that no later in-place update reaches (on the
    CPU ``.cpu()`` would hand back ``t``'s own memory, which the next
    optimizer step rewrites while an async write reads it)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True,
                 mesh=None, specs=None):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self.mesh = mesh
        self.specs = specs
        self.writer = True
        if mesh is not None:
            import torch.distributed as dist
            self.writer = dist.get_rank() == 0
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_save_s = self.last_write_s = self.last_restore_s = 0.0
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ #
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, d, "MANIFEST.json")):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------ #
    def save(self, state, step: int, extra: Optional[dict] = None):
        """Device-to-host now; the write possibly on a thread.  On a mesh
        every rank calls it."""
        t0 = time.perf_counter()
        if self.mesh is None:
            host = {k: _host(v) for k, v in tree_items(state)}
        else:
            host = self._gathered(state)
        self.last_save_s = time.perf_counter() - t0
        if self.async_save or self.mesh is not None:
            self.wait()
        if not self.writer:
            return
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(host, step, extra),
                daemon=True)
            self._thread.start()
        else:
            self._write(host, step, extra)

    def _gathered(self, state) -> Dict[str, np.ndarray]:
        """Each leaf whole, gathered from the ranks' windows one at a time;
        host copies on the writer only."""
        from repro_torch.parallel.train_mesh import gather_leaf
        spec_of = dict(tree_items(self.specs))
        host = {}
        for k, v in tree_items(state):
            sp = spec_of[k]
            shape = tuple(n * (axis_size(e, self.mesh) if e is not None else 1)
                          for n, e in zip(v.shape,
                                          tuple(sp) + (None,) * v.dim()))
            full = gather_leaf(v.detach(), shape, sp, self.mesh)
            if self.writer:
                host[k] = _host(full)
            del full
        return host

    def join(self):
        """Join this process's pending write, if any (no collective)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def wait(self):
        """Join the pending write; raise what it raised.  On a mesh every
        rank calls it, and it returns on every rank after the writer's
        write (a collective), raising on every rank if the write
        failed."""
        self.join()
        failed = self._error is not None
        if self.mesh is not None:
            import torch.distributed as dist
            dev = (torch.device("cuda", torch.cuda.current_device())
                   if dist.get_backend() == "nccl" else torch.device("cpu"))
            flag = torch.tensor([float(failed)], device=dev)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            if flag.item() and not failed:
                raise RuntimeError("the checkpoint write on rank 0 failed")
        if failed:
            err, self._error = self._error, None
            raise err

    def _write_guarded(self, host, step, extra):
        try:
            self._write(host, step, extra)
        except BaseException as e:          # re-raised by wait()
            self._error = e

    def _write(self, host: Dict[str, np.ndarray], step: int,
               extra: Optional[dict]):
        t0 = time.perf_counter()
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        manifest = {
            "step": step,
            "time": time.time(),
            "keys": sorted(host.keys()),
            "shapes": {k: list(v.shape) for k, v in host.items()},
            "dtypes": {k: str(v.dtype) for k, v in host.items()},
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic publish
        self._gc()
        self.last_write_s = time.perf_counter() - t0

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------ #
    def restore(self, template, step: Optional[int] = None,
                device: DeviceLike = None):
        """(state, step): the checkpoint of ``step`` (default the latest)
        in the shape of ``template``, a tree of tensors.  Each leaf lands
        on its template's dtype and device; a ``meta`` template leaf (the
        reference's ``ShapeDtypeStruct``) lands on ``device`` (default:
        the CUDA card, see ``resolve_device``).  On a mesh each leaf is
        this rank's window of the saved array (the manager's ``specs``),
        which the template's leaf is shaped like."""
        from repro_torch.models.common import window
        spec_of = (dict(tree_items(self.specs)) if self.mesh is not None
                   else {})
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        t0 = time.perf_counter()
        dev = None
        with np.load(os.path.join(self._step_dir(step), "arrays.npz")) as data:
            def put(path, tmpl: torch.Tensor) -> torch.Tensor:
                nonlocal dev
                arr = np.asarray(data[path])
                if path in spec_of:
                    arr = arr[window(arr.shape, spec_of[path], self.mesh)]
                if tuple(arr.shape) != tuple(tmpl.shape):
                    raise ValueError(f"{path}: checkpoint shape {arr.shape}, "
                                     f"template {tuple(tmpl.shape)}")
                where = tmpl.device
                if where.type == "meta":
                    if dev is None:
                        dev = resolve_device(device)
                    where = dev
                return torch.from_numpy(np.asarray(arr, order="C")).to(
                    device=where, dtype=tmpl.dtype)

            vals = {k: put(k, t) for k, t in tree_items(template)}
        self.last_restore_s = time.perf_counter() - t0
        return _rebuild(template, vals, ()), step


def _rebuild(node, vals: Dict[str, Any], path):
    if isinstance(node, dict):
        return {k: _rebuild(v, vals, path + (k,)) for k, v in node.items()}
    return vals[key_path(path)]
