"""Seed bands of the emulated matmul's correlation with digital, for the
JAX package and its PyTorch port side by side, on the CPU.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/c2_seed_bands.py \
      [--seeds 0 1 2 3 4] [--n-train 10000] [--n-test 1000] [--epochs 30]

Per seed and side: label ``n_train + n_test`` CASE_A blocks with that
side's circuit solver, train a Conv4Xbar on them from that seed, then run
the reference bench protocol, (16, 512) @ (512, 32) calibrated on 256
probes, through that side's emulator fast path, and correlate the result
with the digital product.  The bench operands come from numpy (seed 0)
and the probes from ``jax.random.PRNGKey(1)``, the same on both sides.
A third side, "port on reference data", trains the port from the same
seed on the blocks the reference labelled for that seed (its own
``generate_dataset`` draw), which separates the training from the data.
Prints one line per run and a JSON summary with each side's band.
"""
from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import AnalogConfig as RefAnalogConfig
from repro.configs.rram_ps32 import CASE_A as REF_A
from repro.configs.rram_ps32 import EmulatorTrainConfig as RefTrainConfig
from repro.core.analog import AnalogExecutor as RefExecutor
from repro.core.circuit import CircuitParams as RefCircuitParams
from repro.core.emulator import generate_dataset as ref_dataset
from repro.core.emulator import train_emulator as ref_train
from repro_torch.configs.base import AnalogConfig
from repro_torch.configs.rram_ps32 import CASE_A, EmulatorTrainConfig
from repro_torch.core.analog import AnalogExecutor
from repro_torch.core.circuit import CircuitParams
from repro_torch.core.emulator import train_emulator


def bench_operands():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((512, 32)) * 0.2).astype(np.float32)
    x = (rng.standard_normal((16, 512)) * 0.5).astype(np.float32)
    xc = np.array(jax.random.normal(jax.random.PRNGKey(1), (256, 512)) * 0.5)
    return w, x, xc


def corr(a, b) -> float:
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def reference_run(seed, tcfg_kw, w, x):
    tcfg = RefTrainConfig(seed=seed, **tcfg_kw)
    res = ref_train(jax.random.PRNGKey(seed), REF_A, RefAnalogConfig(),
                    RefCircuitParams(), tcfg)
    ex = RefExecutor(RefAnalogConfig(backend="emulator"), geom=REF_A,
                     emulator_params=res.params)
    ex.calibrate(jax.random.PRNGKey(1), jnp.asarray(w), "bench")
    y = np.asarray(ex.matmul(jnp.asarray(x), jnp.asarray(w), "bench"))
    return float(res.test_mse), y


def reference_data(seed, tcfg_kw):
    """The blocks the reference's ``train_emulator`` labels for ``seed``."""
    kd = jax.random.split(jax.random.PRNGKey(seed), 3)[0]
    n = tcfg_kw["n_train"] + tcfg_kw["n_test"]
    X, Pf, Y = ref_dataset(kd, n, REF_A, RefAnalogConfig(), RefCircuitParams())
    return tuple(None if a is None else torch.from_numpy(np.array(a))
                 for a in (X, Pf, Y))


def port_run(seed, tcfg_kw, w, x, xc, data=None):
    tcfg = EmulatorTrainConfig(seed=seed, **tcfg_kw)
    res = train_emulator(seed, CASE_A, AnalogConfig(), CircuitParams(), tcfg,
                         data=data, device="cpu")
    ex = AnalogExecutor(AnalogConfig(backend="emulator"), geom=CASE_A,
                        emulator_params=res.params)
    tw = torch.from_numpy(w)
    ex.calibrate(torch.from_numpy(xc), tw, "bench")
    with torch.no_grad():
        y = ex.matmul(torch.from_numpy(x), tw, "bench").numpy()
    return float(res.test_mse), y


SIDES = ("reference", "port", "port on reference data")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--n-train", type=int, default=10_000)
    ap.add_argument("--n-test", type=int, default=1_000)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--sides", nargs="+", default=list(SIDES), choices=SIDES)
    args = ap.parse_args(argv)
    tcfg_kw = dict(n_train=args.n_train, n_test=args.n_test,
                   epochs=args.epochs, lr=2e-3,
                   lr_halve_at=(args.epochs * 3 // 5, args.epochs * 17 // 20),
                   batch_size=256)
    w, x, xc = bench_operands()
    y_dig = x @ w
    runs = {side: [] for side in args.sides}
    for seed in args.seeds:
        for side in runs:
            t0 = time.perf_counter()
            if side == "reference":
                mse, y = reference_run(seed, tcfg_kw, w, x)
            elif side == "port":
                mse, y = port_run(seed, tcfg_kw, w, x, xc)
            else:
                mse, y = port_run(seed, tcfg_kw, w, x, xc,
                                  reference_data(seed, tcfg_kw))
            c = corr(y, y_dig)
            runs[side].append({"seed": seed, "test_mse": mse, "corr": c})
            print(f"{side} seed {seed}: test MSE {mse:.4e} V^2, corr with "
                  f"digital {c:.4f} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
    bands = {side: [min(r["corr"] for r in rs), max(r["corr"] for r in rs)]
             for side, rs in runs.items()}
    out = {"budget": tcfg_kw, "runs": runs, "bands": bands}
    if "reference" in bands and "port" in bands:
        (rlo, rhi), (plo, phi) = bands["reference"], bands["port"]
        out["overlap"] = bool(plo <= rhi and rlo <= phi)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
