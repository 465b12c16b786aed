"""Fault-tolerant training supervisor (port of ``repro.runtime.trainer``).

  * checkpoint/restart: atomic checkpoints every k steps; on a step
    failure the supervisor restores the latest checkpoint and resumes
    (the data pipeline is stateless-resumable, so no loader state is
    needed)
  * failure injection: a fault hook called with each step's index
  * straggler mitigation: a per-step wall-time EMA and z-score detector;
    slow steps are logged and counted
  * resume across instances: a new ``Trainer`` on the same directory
    continues from its latest checkpoint; a recovery waits for a save
    still being written, so a failure right after an async save resumes
    from it

  * elastic re-scale: checkpoints are mesh-agnostic -- ``remesh``
    returns a trainer on a new mesh (or none) over the same checkpoints

The step closure is built once per trainer; ``builds`` counts it (the
port's compiles are builds, ROADMAP "The sentinel watches builds").

On a mesh (``mesh=``, a ``DeviceMesh`` of ``data`` and ``model`` over
the ranks of a process group, ``launch.mesh.make_mesh_for``) every rank
runs its own ``Trainer`` on the same mesh, data and checkpoint
directory: each holds its window of the state and its rows of each
batch (``runtime.steps``), the metrics are the whole batch's on every
rank, each rank keeps its own straggler monitor, and rank 0 writes the
checkpoints and the log.  The fault hook is called with the step on
every rank, and a ``SimulatedFailure`` must be raised on every rank at
the same step: a rank that fails alone leaves the others waiting in a
collective, and recovering it needs a new process group.
"""
from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig, ParallelConfig, TrainConfig
from repro_torch.data import SyntheticLMData
from repro_torch.runtime import steps as S


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class StragglerMonitor:
    alpha: float = 0.2
    z_thresh: float = 3.0
    ema: float = 0.0
    var: float = 0.0
    n: int = 0
    events: List[dict] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        slow = False
        if self.n >= 5:
            sd = math.sqrt(max(self.var, 1e-12))
            if dt > self.ema + self.z_thresh * sd and dt > 1.2 * self.ema:
                slow = True
                self.events.append({"step": step, "dt": dt, "ema": self.ema})
        d = dt - self.ema
        self.ema += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        self.n += 1
        return slow


@dataclass
class Trainer:
    cfg: ArchConfig
    pcfg: ParallelConfig
    tcfg: TrainConfig
    mesh: Any
    data: SyntheticLMData
    ckpt_dir: str
    fault_hook: Optional[Callable[[int], None]] = None
    log_path: Optional[str] = None
    device: DeviceLike = None

    def __post_init__(self):
        self.rank, specs = 0, None
        if self.mesh is not None:
            import torch.distributed as dist
            from repro_torch.parallel.train_mesh import check_training_mesh
            check_training_mesh(self.mesh)
            self.rank = dist.get_rank()
            specs = S.train_state_specs(self.cfg, self.mesh)
        self.device = resolve_device(self.device)
        self.ckpt = CheckpointManager(self.ckpt_dir,
                                      keep=self.tcfg.keep_checkpoints,
                                      mesh=self.mesh, specs=specs)
        self.monitor = StragglerMonitor()
        self.restarts = 0
        self.builds = 0
        self._step = None
        self.metrics_log: List[dict] = []

    # ------------------------------------------------------------------ #
    def _build(self):
        self._step = S.make_train_step(self.cfg, self.pcfg, self.tcfg,
                                       mesh=self.mesh)
        self.builds += 1

    def _init_or_restore(self):
        # a save still being written is the latest checkpoint: wait for it
        # (the reference looks before it waits, and restarts from an older
        # checkpoint, or from step 0, when a failure overtakes an async
        # save)
        self.ckpt.wait()
        if self.ckpt.latest_step() is not None:
            state, at = self.ckpt.restore(
                S.abstract_train_state(self.cfg, self.mesh),
                device=self.device)
            return state, int(at)
        return S.init_train_state(self.tcfg.seed, self.cfg, self.device,
                                  mesh=self.mesh), 0

    def _put_batch(self, batch: Dict[str, np.ndarray]):
        """The batch on the device: on a mesh, this rank's rows
        (``train_mesh.batch_rows``)."""
        rows = None
        if self.mesh is not None:
            from repro_torch.parallel.train_mesh import batch_rows
            n = next(iter(batch.values())).shape[0]
            rows = batch_rows(n, self.mesh, self.pcfg.grad_accum).numpy()
        out = {}
        for k, v in batch.items():
            if rows is not None:
                v = v[rows]
            t = torch.from_numpy(np.ascontiguousarray(v))
            if k in ("tokens", "targets"):
                t = t.long()
            out[k] = t.to(self.device)
        return out

    # ------------------------------------------------------------------ #
    def run(self, steps: int) -> Dict[str, float]:
        """Run up to ``steps`` optimizer steps with automatic restart."""
        if self._step is None:
            self._build()
        state, start = self._init_or_restore()
        step = start
        while step < steps:
            try:
                t0 = time.time()
                if self.fault_hook is not None:
                    self.fault_hook(step)
                batch = self._put_batch(self.data.batch(step))
                state, metrics = self._step(state, batch)
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise RuntimeError(f"non-finite loss at step {step}")
                dt = time.time() - t0
                slow = self.monitor.observe(step, dt)
                rec = {"step": step, "loss": loss, "dt": round(dt, 4),
                       "gnorm": float(metrics["gnorm"]),
                       "lr": float(metrics["lr"]), "straggler": slow}
                self.metrics_log.append(rec)
                if self.log_path and self.rank == 0:
                    with open(self.log_path, "a") as f:
                        f.write(json.dumps(rec) + "\n")
                step += 1
                if step % self.tcfg.checkpoint_every == 0 or step == steps:
                    self.ckpt.save(state, step)
            except SimulatedFailure:
                self.restarts += 1
                state, step = self._recover()
            except KeyboardInterrupt:
                if self.mesh is None:    # a save on a mesh is collective
                    self.ckpt.save(state, step)
                raise
        self.ckpt.wait()
        return {"final_step": step, "restarts": self.restarts,
                "final_loss": self.metrics_log[-1]["loss"]
                if self.metrics_log else float("nan"),
                "straggler_events": len(self.monitor.events)}

    def _recover(self):
        """Restore from the latest checkpoint (or re-init at step 0)."""
        return self._init_or_restore()

    # ------------------------------------------------------------------ #
    def remesh(self, new_mesh) -> "Trainer":
        """Elastic re-scale: the same checkpoints on a new mesh, e.g. after
        losing ranks (every rank of the new mesh calls it), or on none
        (one process calls it).  The new trainer has no fault hook."""
        self.ckpt.join()
        return Trainer(cfg=self.cfg, pcfg=self.pcfg, tcfg=self.tcfg,
                       mesh=new_mesh, data=self.data, ckpt_dir=self.ckpt_dir,
                       fault_hook=None, log_path=self.log_path,
                       device=self.device)
