"""Training launcher (port of ``repro.launch.train``, flag for flag).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --steps 200 --reduced --backend digital

runs on the GPU; ``--device cpu`` runs on the CPU.  ``--reduced`` trains
the reference's tiny same-family config.  ``--backend`` is ``digital``
or an analog backend (``emulator``, ``analytic``, ``circuit``) on the
config's analog projections, with the straight-through digital gradient;
``--backend emulator`` first trains its Conv4Xbar emulator at the
reference's sizes (4,000 + 500 circuit-labelled blocks, 40 epochs).
``--devices`` and ``--model-axis`` (a simulated pod, tensor parallelism)
raise ``NotImplementedError`` naming ROADMAP A11.  Prints the summary
and, past 10 steps, the mean loss of the first and last 10.
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
                    help="simulate N host devices (0 = real devices); "
                         "not ported (ROADMAP A11)")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="tensor-parallel width; not ported beyond 1 "
                         "(ROADMAP A11)")
    ap.add_argument("--backend", default="digital",
                    choices=["digital", "analytic", "circuit", "emulator"])
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--log", default="")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None):
    """Parse ``argv`` and train; returns (trainer, summary)."""
    args = build_parser().parse_args(argv)
    if args.devices:
        raise NotImplementedError("--devices is not ported yet (ROADMAP A11)")
    if args.model_axis != 1:
        raise NotImplementedError("--model-axis is not ported yet "
                                  "(ROADMAP A11)")

    from repro_torch import resolve_device
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.common import use_dense_hook
    from repro_torch.runtime.trainer import Trainer

    device = resolve_device(args.device)
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
        from repro_torch.configs.rram_ps32 import CASE_A, EmulatorTrainConfig
        from repro_torch.core.analog import AnalogExecutor
        from repro_torch.core.circuit import CircuitParams
        from repro_torch.core.emulator import train_emulator
        eparams = None
        if args.backend == "emulator":
            print("training emulator for the analog backend ...", flush=True)
            res = train_emulator(0, CASE_A, cfg.analog, CircuitParams(),
                                 EmulatorTrainConfig(n_train=4000, n_test=500,
                                                     epochs=40,
                                                     lr_halve_at=(20, 30)),
                                 device=device)
            eparams = res.params
        ex = AnalogExecutor(acfg=cfg.analog, geom=CASE_A,
                            emulator_params=eparams)
        hook = ex.hook

    trainer = Trainer(cfg=cfg, pcfg=pcfg, tcfg=tcfg, mesh=None, data=data,
                      ckpt_dir=args.ckpt_dir, log_path=args.log or None,
                      device=device)
    ctx = use_dense_hook(hook) if hook else contextlib.nullcontext()
    with ctx:
        summary = trainer.run(args.steps)
    print("SUMMARY:", summary)
    losses = [m["loss"] for m in trainer.metrics_log]
    if len(losses) >= 10:
        print(f"loss first10 {sum(losses[:10])/10:.4f} "
              f"last10 {sum(losses[-10:])/10:.4f}")
    return trainer, summary


if __name__ == "__main__":
    main()
