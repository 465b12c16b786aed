"""Quickstart: the SEMULATOR pipeline end to end (the port's counterpart of
``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

1. solve analog computing blocks with the circuit simulator (NR solver);
2. label a dataset with it, train a Conv4Xbar emulator on it and check
   Theorem 4.1;
3. deploy the emulator as the execution backend of a calibrated matmul
   and correlate it with the digital product.

Runs on the GPU unless given ``--device cpu``.  The defaults are the
reference quickstart's sizes; ``--n-train 50000 --n-test 5000`` is the
paper's Table 1 dataset.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.quickstart")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-train", type=int, default=4000)
    ap.add_argument("--n-test", type=int, default=500)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--lr-halve-at", type=int, nargs="*", default=[25, 35])
    ap.add_argument("--save-npz", default=None,
                    help="write the trained emulator params here (the "
                         "serve CLI's --emulator-params format)")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the three steps; returns ``{"label_s", "n_labelled", "train_s",
    "result" (EmulatorResult), "corr"}`` (seconds synchronized with the
    device)."""
    from repro_torch.configs.base import AnalogConfig
    from repro_torch.configs.rram_ps32 import CASE_A, EmulatorTrainConfig
    from repro_torch.core.analog import AnalogExecutor
    from repro_torch.core.circuit import CircuitParams, block_response
    from repro_torch.core.emulator import (generate_dataset,
                                           sample_block_inputs, train_emulator)
    from repro_torch.interop import save_emulator_npz

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    acfg, cp = AnalogConfig(), CircuitParams()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    # -- 1. the accurate (slow) circuit simulator -------------------------- #
    x, periph = sample_block_inputs(gen, 4, CASE_A, acfg)
    y = block_response(x, cp, periph)
    print(f"circuit block outputs (V): {y.ravel().tolist()}", flush=True)

    # -- 2. label a dataset, train the emulator against it ----------------- #
    tcfg = EmulatorTrainConfig(n_train=args.n_train, n_test=args.n_test,
                               epochs=args.epochs, lr=2e-3,
                               lr_halve_at=tuple(args.lr_halve_at),
                               batch_size=256, seed=args.seed)
    n = tcfg.n_train + tcfg.n_test
    _sync(dev)
    t0 = time.perf_counter()
    data = generate_dataset(gen, n, CASE_A, acfg, cp)
    _sync(dev)
    label_s = time.perf_counter() - t0
    print(f"circuit solver labelled {n} blocks in {label_s:.2f} s "
          f"({n / label_s:.0f} blocks/s) on {dev}", flush=True)
    t0 = time.perf_counter()
    res = train_emulator(args.seed, CASE_A, acfg, cp, tcfg,
                         log_every=10, data=data)
    _sync(dev)
    train_s = time.perf_counter() - t0
    print(f"emulator: test MSE {res.test_mse:.3e} "
          f"(MAE {res.test_mae * 1e3:.2f} mV), trained in {train_s:.1f} s",
          flush=True)
    print(f"Thm 4.1: bound(s=3, p=0.3) = {res.bound:.2e}; "
          f"P(|err|<0.5mV) = {res.sig_prob:.3f}; accepted = {res.accepted}",
          flush=True)
    print(f"  (paper protocol: 50k samples / 2000 epochs; this run: "
          f"{tcfg.n_train} / {tcfg.epochs})", flush=True)
    if args.save_npz:
        save_emulator_npz(args.save_npz, res.params)

    # -- 3. run a matmul on the emulated analog hardware ------------------- #
    ex = AnalogExecutor(acfg=AnalogConfig(backend="emulator"), geom=CASE_A,
                        cp=cp, emulator_params=res.params)
    w = torch.randn((128, 8), generator=gen, device=dev) * 0.2
    xin = torch.randn((4, 128), generator=gen, device=dev) * 0.5
    xc = torch.randn((256, 128), generator=gen, device=dev) * 0.5
    ex.calibrate(xc, w, "demo")
    with torch.no_grad():
        y_analog = ex.matmul(xin, w, "demo")
    y_digital = xin @ w
    corr = float(torch.corrcoef(torch.stack([y_analog.ravel(),
                                             y_digital.ravel()]))[0, 1])
    print(f"analog-emulated matmul vs digital: corr = {corr:.3f}", flush=True)
    return {"label_s": label_s, "n_labelled": n, "train_s": train_s,
            "result": res, "corr": corr}


if __name__ == "__main__":
    main()
