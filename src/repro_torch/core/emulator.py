"""Emulator lifecycle: generate circuit data -> train Conv4Xbar by MSE
regression -> accept via Theorem 4.1 -> deploy as an analog-matmul backend
(the port of ``repro.core.emulator``).

The paper's training protocol: Adam, lr halved at fixed epochs (Fig. 4),
50k samples (Table 1), train/test split, MAE reporting.  Gradients come
from torch autograd through the paper-faithful ``conv4xbar.apply``; the
no-grad evaluations (the test MSE per logged epoch and the final test
predictions) run through the per-block evaluator
``kernels.emulator_block.emulator_block`` -- the CUDA kernel for CUDA
tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import AnalogConfig
from repro_torch.configs.rram_ps32 import BlockGeometry, EmulatorTrainConfig
from repro_torch.core import conv4xbar, theory
from repro_torch.core.circuit import CircuitParams, _c, block_response
from repro_torch.kernels.emulator_block.ops import emulator_block
from repro_torch.models.common import init_params


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return lo + u * (hi - lo)


def sample_block_inputs(gen: torch.Generator, n: int, geom: BlockGeometry,
                        acfg: AnalogConfig, with_periph: bool = True):
    """Random (V, G) cell features + peripheral features on ``gen``'s
    device, shaped for the emulator: X (n, 2, D, H, W), periph (n, 2)."""
    v = _uniform(gen, (n, geom.tiles, geom.rows), 0.0, acfg.v_read)
    g = _uniform(gen, (n, geom.tiles, geom.rows, geom.cols),
                 acfg.g_min, acfg.g_max)
    x = torch.stack([v[..., None].expand(g.shape), g], dim=1)
    periph = None
    if with_periph:
        gain = _uniform(gen, (n, 1), 0.9, 1.1)
        off = _uniform(gen, (n, 1), -0.01, 0.01)
        periph = torch.cat([gain, off], dim=-1)
    return x, periph


def normalize_features(x: torch.Tensor, acfg: AnalogConfig) -> torch.Tensor:
    """Paper normalizes V and G channels to [0, 1]."""
    v = x[:, 0] / _c(acfg.v_read, x)
    g = (x[:, 1] - acfg.g_min) / _c(acfg.g_max - acfg.g_min, x)
    return torch.stack([v, g], dim=1)


@torch.no_grad()
def generate_dataset(gen: torch.Generator, n: int, geom: BlockGeometry,
                     acfg: AnalogConfig, cp: CircuitParams, batch: int = 2048,
                     with_periph: bool = True):
    """Label ``n`` random block inputs with the circuit solver, in batches
    of ``batch`` on ``gen``'s device.  Returns (X normalized, periph or
    None, Y volts)."""
    xs, ps, ys = [], [], []
    done = 0
    while done < n:
        b = min(batch, n - done)
        x, periph = sample_block_inputs(gen, b, geom, acfg, with_periph)
        ys.append(block_response(x, cp, periph))
        xs.append(normalize_features(x, acfg))
        ps.append(periph)
        done += b
    return (torch.cat(xs), torch.cat(ps) if with_periph else None,
            torch.cat(ys))


@dataclass
class EmulatorResult:
    params: dict
    history: Dict[str, List[float]]
    train_mse: float
    test_mse: float
    test_mae: float
    bound: float
    accepted: bool
    sig_prob: float


def _adam_step(p, m, v, grads, t: int, lr: float):
    """One Adam update over parallel tensor lists, in the reference's
    arithmetic: beta 0.9/0.999, eps 1e-8, bias correction in float32."""
    m[:] = torch._foreach_add(torch._foreach_mul(m, 0.9),
                              torch._foreach_mul(grads, 0.1))
    v[:] = torch._foreach_add(torch._foreach_mul(v, 0.999),
                              torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                 0.001))
    tf = np.float32(t)
    bc1 = float(np.float32(1) - np.float32(0.9) ** tf)
    bc2 = float(np.float32(1) - np.float32(0.999) ** tf)
    num = torch._foreach_mul(torch._foreach_div(m, bc1), lr)
    den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v, bc2)),
                             1e-8)
    torch._foreach_sub_(p, torch._foreach_div(num, den))


def adam_epoch(params: dict, state, t: int, data, perm: np.ndarray,
               bs: int, lr: float):
    """One epoch of Adam steps through the training forward
    ``conv4xbar.apply`` on the rows ``perm`` of ``data`` = (X, periph or
    None, Y) in batches of ``bs`` (a short last batch is dropped).
    ``state`` = (trained tensors, first moments, second moments), updated
    in place; returns the step count and the summed batch loss."""
    (p, m, v), (X, Pf, Y) = state, data
    steps = max(1, X.shape[0] // bs)
    idx = torch.from_numpy(perm[:steps * bs]).to(X.device)
    xb = X[idx].reshape((steps, bs) + X.shape[1:])
    yb = Y[idx].reshape((steps, bs) + Y.shape[1:])
    pb = (Pf[idx].reshape((steps, bs) + Pf.shape[1:])
          if Pf is not None else None)
    loss_sum = torch.zeros((), device=X.device)
    for s in range(steps):
        pred = conv4xbar.apply(params, xb[s],
                               pb[s] if pb is not None else None)
        loss = torch.mean(torch.square(pred - yb[s]))
        grads = torch.autograd.grad(loss, p)
        t += 1
        with torch.no_grad():
            _adam_step(p, m, v, list(grads), t, lr)
            loss_sum += loss
    return t, loss_sum


def train_emulator(seed: int, geom: BlockGeometry, acfg: AnalogConfig,
                   cp: CircuitParams, tcfg: EmulatorTrainConfig,
                   fused: bool = True, log_every: int = 0, data=None,
                   params: Optional[dict] = None,
                   device: DeviceLike = None) -> EmulatorResult:
    """Full paper protocol.  ``data`` = (X normalized, periph or None, Y)
    reuses a pregenerated set (else the circuit solver labels
    ``n_train + n_test`` blocks from ``seed``); ``params`` are optional
    initial emulator params (else ``init_params(seed, schema)``).  Tensors
    live on ``data``'s device, else on ``device``.

    Targets are standardized during optimization and the affine is folded
    exactly into the last FC layer afterwards (``unfold``), so the returned
    params predict raw volts.  ``fused`` is kept for the reference's
    signature and selects nothing: the port trains through
    ``conv4xbar.apply``, which the reference holds bit-equal to its
    ``apply_fused``."""
    del fused
    if data is None:
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        data = generate_dataset(gen, tcfg.n_train + tcfg.n_test, geom, acfg, cp)
    X, Pf, Y = data
    dev = X.device
    Xtr, Xte = X[:tcfg.n_train], X[tcfg.n_train:]
    Ytr, Yte = Y[:tcfg.n_train], Y[tcfg.n_train:]
    Ptr = Pf[:tcfg.n_train] if Pf is not None else None
    Pte = Pf[tcfg.n_train:] if Pf is not None else None
    n_periph = 0 if Pf is None else Pf.shape[-1]

    y_mean = torch.mean(Ytr, dim=0)
    y_std = torch.clamp_min(torch.std(Ytr, dim=0, correction=0), 1e-6)
    Ytr_n = (Ytr - y_mean) / y_std

    if params is None:
        params = init_params(seed, conv4xbar.conv4xbar_schema(
            geom, n_periph=n_periph), device=dev)
    params = {k: v.detach().to(dev, torch.float32).clone()
              for k, v in params.items()}
    # _meta gets no gradient, so the reference's update leaves it as it is
    p = [params[k].requires_grad_(True) for k in params if k != "_meta"]
    m = [torch.zeros_like(a) for a in p]
    v = [torch.zeros_like(a) for a in p]

    def unfold(q):
        """Fold target standardization into the last FC layer (exact)."""
        nf = conv4xbar._n_fc(q)
        q = dict(q)
        q[f"fc{nf-1}_w"] = q[f"fc{nf-1}_w"] * y_std[None, :]
        q[f"fc{nf-1}_b"] = q[f"fc{nf-1}_b"] * y_std + y_mean
        return q

    def predict(q):
        return emulator_block(q, Xte, Pte, geom)

    n = Xtr.shape[0]
    bs = min(tcfg.batch_size, n)
    steps_per_epoch = max(1, n // bs)
    hist = {"epoch": [], "train": [], "test": [], "lr": []}
    lr = tcfg.lr
    t = 0
    rng = np.random.default_rng(tcfg.seed)
    y_scale = float(torch.mean(y_std) ** 2)
    tr_loss = float("nan")
    for epoch in range(tcfg.epochs):
        if epoch in tcfg.lr_halve_at:
            lr *= 0.5
        t, loss_sum = adam_epoch(params, (p, m, v), t, (Xtr, Ptr, Ytr_n),
                                 rng.permutation(n), bs, lr)
        tr_loss = float(loss_sum / steps_per_epoch) * y_scale
        if log_every and (epoch % log_every == 0 or epoch == tcfg.epochs - 1):
            with torch.no_grad():
                te = float(torch.mean(torch.square(predict(unfold(params)) - Yte)))
            hist["epoch"].append(epoch)
            hist["train"].append(tr_loss)
            hist["test"].append(te)
            hist["lr"].append(lr)
            print(f"  epoch {epoch:5d} lr {lr:.2e} train {tr_loss:.3e} test {te:.3e}",
                  flush=True)

    with torch.no_grad():
        params = unfold({k: a.detach() for k, a in params.items()})
        err = predict(params) - Yte
        test_mse = float(torch.mean(torch.square(err)))
        test_mae = float(torch.mean(torch.abs(err)))
        sig = float(theory.significance_probability(err, tcfg.sig_bit))
    bound = theory.mse_bound(tcfg.sig_bit, tcfg.prob)
    return EmulatorResult(
        params=params, history=hist, train_mse=tr_loss, test_mse=test_mse,
        test_mae=test_mae, bound=bound,
        accepted=(test_mse < bound) and (sig > tcfg.prob), sig_prob=sig)
