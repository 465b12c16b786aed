"""Training launcher (port of ``repro.launch.train``, flag for flag).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --steps 200 --reduced --backend digital

runs on the GPU; ``--device cpu`` runs on the CPU.  ``--reduced`` trains
the reference's tiny same-family config.  ``--backend`` is ``digital``
or an analog backend (``emulator``, ``analytic``, ``circuit``) on the
config's analog projections, with the straight-through digital gradient;
``--backend emulator`` first trains its Conv4Xbar emulator at the
reference's sizes (4,000 + 500 circuit-labelled blocks, 40 epochs).

``--devices N --model-axis T`` trains on a (N/T, T) ``(data, model)``
mesh of N ranks, one process each (``launch.mesh.launch``; NCCL when
each rank has a card of its own, gloo when they share one or run on the
CPU), each rank its own ``Trainer`` on the mesh; ``T`` must divide
``N``.  The emulator is trained once, here, and every rank serves it.
Prints the summary (rank 0's on a mesh) and, past 10 steps, the mean
loss of the first and last 10.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --reduced --steps 20 --devices 4 --model-axis 2 --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import tempfile
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--devices", type=int, default=0,
                    help="train on N ranks, one process each (0: one "
                         "process, no mesh)")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="the mesh's model axis (tensor parallelism); it "
                         "divides --devices")
    ap.add_argument("--backend", default="digital",
                    choices=["digital", "analytic", "circuit", "emulator"])
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--log", default="")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def _setup(args, device, eparams=None, mesh=None):
    """(cfg, pcfg, tcfg, data, dense hook or None) of the flags."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.data import SyntheticLMData

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(
        cfg, analog=dataclasses.replace(cfg.analog,
                                        enabled=args.backend != "digital",
                                        backend=args.backend))
    pcfg = ParallelConfig(attn_block_kv=min(1024, args.seq_len),
                          xent_chunk=min(2048, args.seq_len))
    tcfg = TrainConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 20),
                       checkpoint_every=max(10, args.steps // 5))
    data = SyntheticLMData(cfg, args.seq_len, args.global_batch)
    hook = None
    if cfg.analog.enabled:
        from repro_torch.configs.rram_ps32 import CASE_A
        from repro_torch.core.analog import AnalogExecutor
        ex = AnalogExecutor(acfg=cfg.analog, geom=CASE_A,
                            emulator_params=eparams, mesh=mesh)
        hook = ex.hook
    return cfg, pcfg, tcfg, data, hook


def _train(args, device, eparams=None, mesh=None):
    """The trainer of the flags, run under the analog hook; returns it and
    its summary."""
    from repro_torch.models.common import use_dense_hook
    from repro_torch.runtime.trainer import Trainer
    cfg, pcfg, tcfg, data, hook = _setup(args, device, eparams, mesh)
    trainer = Trainer(cfg=cfg, pcfg=pcfg, tcfg=tcfg, mesh=mesh, data=data,
                      ckpt_dir=args.ckpt_dir, log_path=args.log or None,
                      device=device)
    ctx = use_dense_hook(hook) if hook else contextlib.nullcontext()
    with ctx:
        summary = trainer.run(args.steps)
    return trainer, summary


def _rank_train(rank, world, device, args, npz):
    """One rank of ``--devices``: the trainer on the (N/T, T) mesh; the
    rank's summary and losses back to the launcher."""
    from repro_torch.launch.mesh import make_mesh_for
    eparams = None
    if npz is not None:
        from repro_torch.interop import load_emulator_npz
        eparams = load_emulator_npz(npz, device)
    mesh = make_mesh_for(world, model_axis=args.model_axis, device=device)
    trainer, summary = _train(args, device, eparams, mesh)
    return {"summary": summary,
            "losses": [m["loss"] for m in trainer.metrics_log]}


def main(argv: Optional[List[str]] = None):
    """Parse ``argv`` and train; returns (trainer, summary) -- on a mesh
    (``--devices``) (None, rank 0's summary)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.model_axis < 1 or args.devices < 0:
        ap.error("--devices and --model-axis count ranks")
    if args.devices and args.devices % args.model_axis:
        ap.error(f"--model-axis {args.model_axis} does not divide "
                 f"--devices {args.devices}")
    if not args.devices and args.model_axis != 1:
        ap.error("--model-axis needs --devices")

    from repro_torch import resolve_device
    device = resolve_device(args.device)
    eparams = None
    if args.backend == "emulator":
        from repro_torch.configs import get_config
        from repro_torch.configs.rram_ps32 import CASE_A, EmulatorTrainConfig
        from repro_torch.core.circuit import CircuitParams
        from repro_torch.core.emulator import train_emulator
        print("training emulator for the analog backend ...", flush=True)
        acfg = dataclasses.replace(get_config(args.arch).analog,
                                   enabled=True, backend=args.backend)
        res = train_emulator(0, CASE_A, acfg, CircuitParams(),
                             EmulatorTrainConfig(n_train=4000, n_test=500,
                                                 epochs=40,
                                                 lr_halve_at=(20, 30)),
                             device=device)
        eparams = res.params

    if args.devices:
        from repro_torch.launch.mesh import launch
        npz = None
        with tempfile.TemporaryDirectory() as tmp:
            if eparams is not None:
                # the ranks serve the one net trained here
                from repro_torch.interop import save_emulator_npz
                npz = os.path.join(tmp, "emulator.npz")
                save_emulator_npz(npz, eparams)
            res = launch(_rank_train, args.devices, args=(args, npz),
                         device=device)
        trainer, summary, losses = None, res[0]["summary"], res[0]["losses"]
    else:
        trainer, summary = _train(args, device, eparams)
        losses = [m["loss"] for m in trainer.metrics_log]
    print("SUMMARY:", summary)
    if len(losses) >= 10:
        print(f"loss first10 {sum(losses[:10])/10:.4f} "
              f"last10 {sum(losses[-10:])/10:.4f}")
    return trainer, summary


if __name__ == "__main__":
    main()
