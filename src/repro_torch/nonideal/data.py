"""Noise-aware emulator training data (port of ``repro.nonideal.data``).

The circuit solver is the ground truth for any device corner: perturb the
sampled per-cell conductances with a scenario (one device draw and one
read draw per sample) and label with the scenario-adjusted circuit.

  * ``train_noise_aware_emulator`` -- one net for one corner;
  * ``train_conditioned_emulator`` -- ONE net for the whole corner
    manifold: each sample draws its own scenario from a ``ScenarioSpace``
    and the scenario's encoding (``scenario_features``) is appended to
    the peripheral features, so one net serves any corner or age.

  * ``finetune_emulator`` -- warm-start adaptation of a serving net to
    an aged corner (the lifetime scheduler's retrainers).

All draws come from the caller's ``torch.Generator``, on its device, or
from a ``core.prng`` key.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import AnalogConfig
from repro_torch.configs.rram_ps32 import BlockGeometry, EmulatorTrainConfig
from repro_torch.core import prng
from repro_torch.core.circuit import CircuitParams, block_response
from repro_torch.core.emulator import (EmulatorResult, adam_epoch,
                                       normalize_features,
                                       sample_block_inputs, train_emulator)
from repro_torch.nonideal.perturb import (apply_read_noise,
                                          perturb_conductance,
                                          scenario_circuit_params)
from repro_torch.nonideal.scenario import (_LEAF_FIELDS, Scenario,
                                           _leaf_tensor,
                                           scenario_features_tiled)


def _rand(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device)


def _perturb_cells(g: torch.Tensor, acfg: AnalogConfig, scenario: Scenario,
                   gen: torch.Generator) -> torch.Tensor:
    """One device draw and one read draw of ``g`` (per-sample leaves,
    if any, align with its leading axis)."""
    eps = torch.randn(g.shape, generator=gen, device=gen.device)
    u = _rand(gen, g.shape)
    g = perturb_conductance(g, acfg, scenario, eps, u)
    er = torch.randn(g.shape, generator=gen, device=gen.device)
    return apply_read_noise(g, acfg, scenario.read_sigma, er)


@torch.no_grad()
def generate_dataset_nonideal(gen: torch.Generator, n: int,
                              geom: BlockGeometry, acfg: AnalogConfig,
                              cp: CircuitParams, scenario: Scenario,
                              batch: int = 2048, with_periph: bool = True):
    """Scenario-perturbed twin of ``emulator.generate_dataset``: each
    sample is its own device draw and read draw.  Returns (X normalized,
    periph or None, Y volts)."""
    cp_s = scenario_circuit_params(cp, scenario)
    xs, ps, ys = [], [], []
    done = 0
    while done < n:
        b = min(batch, n - done)
        x, periph = sample_block_inputs(gen, b, geom, acfg, with_periph)
        x = torch.stack([x[:, 0], _perturb_cells(x[:, 1], acfg, scenario,
                                                 gen)], dim=1)
        ys.append(block_response(x, cp_s, periph))
        xs.append(normalize_features(x, acfg))
        ps.append(periph)
        done += b
    return (torch.cat(xs), torch.cat(ps) if with_periph else None,
            torch.cat(ys))


# --------------------------------------------------------------------------- #
# Scenario-conditioned training: one emulator for the whole corner manifold
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ScenarioSpace:
    """The corner manifold a conditioned emulator trains over (the
    reference's defaults).  Each field is a ``(lo, hi)`` uniform range
    for the matching ``Scenario`` knob; drift ages are log-uniform over
    ``[60 s, drift_t_max]`` with a ``p_undrifted`` point mass at t = 0;
    ``n_levels`` is a choice set.  ``r_line_scale`` is absent: it
    rewrites the solver's ``CircuitParams`` and cannot vary per sample.

    Serving-statistics mixture: with probability ``p_serving_drive`` a
    sample's voltages are drawn as the executor drives them (rows zero
    with probability ``serve_sparsity``, the rest gate-overdriven into
    [v_th, v_read]); with probability ``p_weightlike`` its conductances
    are weight-derived differential pairs (one rail at g_min) at a
    log-uniform scale in ``weight_scale``."""
    prog_sigma: Tuple[float, float] = (0.0, 0.15)
    read_sigma: Tuple[float, float] = (0.0, 0.06)
    p_stuck_on: Tuple[float, float] = (0.0, 0.01)
    p_stuck_off: Tuple[float, float] = (0.0, 0.06)
    drift_nu: Tuple[float, float] = (0.0, 0.08)
    drift_t_max: float = 2_592_000.0          # one month
    p_undrifted: float = 0.25
    n_levels: Tuple[int, ...] = (0, 16, 32)
    p_serving_drive: float = 0.5
    serve_sparsity: float = 0.5
    p_weightlike: float = 0.5
    weight_scale: Tuple[float, float] = (0.05, 0.6)


def sample_scenarios(gen: torch.Generator, n: int,
                     space: Optional[ScenarioSpace] = None) -> Scenario:
    """One ``Scenario`` whose numeric leaves are ``(n,)`` tensors on
    ``gen``'s device: n independent corners drawn from ``space``."""
    space = space if space is not None else ScenarioSpace()

    def u(rng):
        return rng[0] + _rand(gen, (n,)) * (rng[1] - rng[0])

    lo, hi = math.log(60.0), math.log(max(space.drift_t_max, 61.0))
    leaves = dict(prog_sigma=u(space.prog_sigma),
                  read_sigma=u(space.read_sigma),
                  p_stuck_on=u(space.p_stuck_on),
                  p_stuck_off=u(space.p_stuck_off),
                  drift_nu=u(space.drift_nu))
    t_raw = torch.exp(lo + _rand(gen, (n,)) * (hi - lo))
    leaves["drift_t"] = torch.where(_rand(gen, (n,)) < space.p_undrifted,
                                    torch.zeros_like(t_raw), t_raw)
    choice = torch.randint(0, len(space.n_levels), (n,), generator=gen,
                           device=gen.device)
    leaves["n_levels"] = torch.tensor(space.n_levels, dtype=torch.int32,
                                      device=gen.device)[choice]
    # every leaf carries the batch axis (drift_t0 broadcast)
    base = Scenario(name="manifold")
    for f in _LEAF_FIELDS:
        if f not in leaves:
            leaves[f] = _leaf_tensor(getattr(base, f), f).to(
                gen.device).expand(n).contiguous()
    return Scenario(name="manifold", **leaves)


def _mix_serving(x: torch.Tensor, gen: torch.Generator, space: ScenarioSpace,
                 acfg: AnalogConfig, cp: CircuitParams) -> torch.Tensor:
    """Swap a fraction of samples onto serving statistics: drive rows
    sparse and overdriven into [v_th, v_read] (as ``_drive01`` drives
    them), conductances weight-derived differential pairs (as
    ``build_conductance_plan`` programs them)."""
    B = x.shape[0]
    vshape = (B,) + tuple(x.shape[2:4])                # (B, D, H)
    live = _rand(gen, vshape) >= space.serve_sparsity
    lvl = cp.v_th + _rand(gen, vshape) * (acfg.v_read - cp.v_th)
    v_serve = torch.where(live, lvl, torch.zeros_like(lvl))
    pick_v = _rand(gen, (B, 1, 1)) < space.p_serving_drive
    v = torch.where(pick_v, v_serve, x[:, 0, :, :, 0])
    vch = v[..., None].expand(x.shape[:1] + x.shape[2:])
    no = x.shape[4] // 2
    wshape = (B,) + tuple(x.shape[2:4]) + (no,)
    lo, hi = space.weight_scale
    s = torch.exp(math.log(lo) + _rand(gen, (B, 1, 1, 1))
                  * (math.log(hi) - math.log(lo)))
    wn = torch.clamp(torch.randn(wshape, generator=gen, device=gen.device)
                     * s, -1.0, 1.0)
    span = acfg.g_max - acfg.g_min
    gp = acfg.g_min + span * torch.clamp(wn, 0.0, 1.0)
    gn = acfg.g_min + span * torch.clamp(-wn, 0.0, 1.0)
    g_w = torch.stack([gp, gn], dim=-1).reshape(x.shape[:1] + x.shape[2:])
    pick_g = _rand(gen, (B, 1, 1, 1)) < space.p_weightlike
    return torch.stack([vch, torch.where(pick_g, g_w, x[:, 1])], dim=1)


@torch.no_grad()
def generate_dataset_conditioned(gen: torch.Generator, n: int,
                                 geom: BlockGeometry, acfg: AnalogConfig,
                                 cp: CircuitParams,
                                 space: Optional[ScenarioSpace] = None,
                                 batch: int = 2048):
    """Training data for the scenario-conditioned emulator: every sample
    draws its own corner from ``space``, then its own device and read
    draw under it, and its encoding is appended to the periph -- ``Pf``
    is ``(n, 2 + N_SCENARIO_FEATURES)``.  A ``p_serving_drive`` /
    ``p_weightlike`` fraction takes serving statistics
    (``_mix_serving``).  Labels come from the base circuit solver
    (``r_line_scale`` stays 1)."""
    space = space if space is not None else ScenarioSpace()
    xs, ps, ys = [], [], []
    done = 0
    while done < n:
        b = min(batch, n - done)
        x, periph = sample_block_inputs(gen, b, geom, acfg, True)
        x = _mix_serving(x, gen, space, acfg, cp)
        scen = sample_scenarios(gen, b, space)
        x = torch.stack([x[:, 0], _perturb_cells(x[:, 1], acfg, scen, gen)],
                        dim=1)
        sfeat = scenario_features_tiled(scen).to(x.device)   # (b, F)
        ys.append(block_response(x, cp, periph))
        xs.append(normalize_features(x, acfg))
        ps.append(torch.cat([periph, sfeat], dim=-1))
        done += b
    return torch.cat(xs), torch.cat(ps), torch.cat(ys)


def _generator(seed: int, device: DeviceLike) -> torch.Generator:
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return gen


def train_conditioned_emulator(seed: int, geom: BlockGeometry,
                               acfg: AnalogConfig, cp: CircuitParams,
                               tcfg: EmulatorTrainConfig,
                               space: Optional[ScenarioSpace] = None,
                               log_every: int = 0,
                               device: DeviceLike = None) -> EmulatorResult:
    """The paper's training protocol over the corner manifold: ONE
    corner- and age-aware Conv4Xbar (periph width 2 +
    N_SCENARIO_FEATURES)."""
    data = generate_dataset_conditioned(_generator(seed, device),
                                        tcfg.n_train + tcfg.n_test, geom,
                                        acfg, cp, space=space)
    return train_emulator(seed, geom, acfg, cp, tcfg, data=data,
                          log_every=log_every)


def train_noise_aware_emulator(seed: int, geom: BlockGeometry,
                               acfg: AnalogConfig, cp: CircuitParams,
                               tcfg: EmulatorTrainConfig, scenario: Scenario,
                               log_every: int = 0,
                               device: DeviceLike = None) -> EmulatorResult:
    """The paper's training protocol on scenario-perturbed circuit data."""
    data = generate_dataset_nonideal(_generator(seed, device),
                                     tcfg.n_train + tcfg.n_test, geom, acfg,
                                     cp, scenario)
    return train_emulator(seed, geom, acfg, cp, tcfg, data=data,
                          log_every=log_every)


def finetune_emulator(key, params: dict, geom: BlockGeometry,
                      acfg: AnalogConfig, cp: CircuitParams,
                      scenario: Scenario, n: int = 4096, epochs: int = 30,
                      batch_size: int = 512, lr: float = 2e-4, data=None,
                      perm_seed: Optional[int] = None) -> dict:
    """Warm-start adaptation of a trained emulator to a degraded corner:
    a few low-lr Adam epochs from the CURRENT params, so the net moves a
    short distance toward the aged response surface and nowhere else
    (retraining from scratch pays full model variance every checkpoint).

    ``data`` is an ``(X, Pf, Y)`` triple of normalized block features,
    peripheral features and raw-volt circuit labels (the field retrainers
    pass the fleet's own serving-distribution blocks); when None, ``n``
    noise-aware samples of ``scenario`` are labelled from
    ``fold_in(key, 0xF17E)`` on the params' device.  Steps run through
    ``emulator.adam_epoch`` (the training forward, the reference's Adam)
    at a constant ``lr``.  ``perm_seed`` seeds numpy's per-epoch
    permutations (default: derived from ``fold_in(key, 0x5EED)``; the
    reference derives its integer from its own key, which a test can hand
    over).  Returns fresh params; ``params`` is not mutated."""
    dev = next(iter(params.values())).device
    if data is None:
        data = generate_dataset_nonideal(
            prng.generator(prng.fold_in(prng.as_key(key), 0xF17E), dev), n,
            geom, acfg, cp, scenario)
    n = data[0].shape[0]
    q = {k: v.detach().to(dev, torch.float32).clone()
         for k, v in params.items()}
    # _meta gets no gradient, so the reference's update leaves it as it is
    p = [q[k].requires_grad_(True) for k in q if k != "_meta"]
    state = (p, [torch.zeros_like(a) for a in p],
             [torch.zeros_like(a) for a in p])
    if perm_seed is None:
        perm_seed = prng.seed_of(prng.fold_in(prng.as_key(key), 0x5EED)) \
            % (2 ** 31 - 1)
    rng = np.random.default_rng(int(perm_seed))
    t = 0
    for _ in range(epochs):
        t, _ = adam_epoch(q, state, t, data, rng.permutation(n),
                          min(batch_size, n), lr)
    return {k: a.detach() for k, a in q.items()}
