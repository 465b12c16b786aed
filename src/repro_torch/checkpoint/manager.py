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
from repro_torch.models.common import key_path, tree_items


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that no later in-place update reaches (on the
    CPU ``.cpu()`` would hand back ``t``'s own memory, which the next
    optimizer step rewrites while an async write reads it)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
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
        """Device-to-host now; the write possibly on a thread."""
        t0 = time.perf_counter()
        host = {k: _host(v) for k, v in tree_items(state)}
        self.last_save_s = time.perf_counter() - t0
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write_guarded, args=(host, step, extra),
                daemon=True)
            self._thread.start()
        else:
            self._write(host, step, extra)

    def wait(self):
        """Join the pending write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
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
        the CUDA card, see ``resolve_device``)."""
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
                if tuple(arr.shape) != tuple(tmpl.shape):
                    raise ValueError(f"{path}: checkpoint shape {arr.shape}, "
                                     f"template {tuple(tmpl.shape)}")
                where = tmpl.device
                if where.type == "meta":
                    if dev is None:
                        dev = resolve_device(device)
                    where = dev
                return torch.from_numpy(arr).to(device=where,
                                                 dtype=tmpl.dtype)

            vals = {k: put(k, t) for k, t in tree_items(template)}
        self.last_restore_s = time.perf_counter() - t0
        return _rebuild(template, vals, ()), step


def _rebuild(node, vals: Dict[str, Any], path):
    if isinstance(node, dict):
        return {k: _rebuild(v, vals, path + (k,)) for k, v in node.items()}
    return vals[key_path(path)]
