"""Conductance-level perturbation ops (port of
``repro.nonideal.perturb``).

Everything applies at the conductance-plan level -- raw conductances in
[g_min, g_max], any shape -- so one implementation serves the circuit,
analytic and emulator backends.

Composition order (device state, one draw per device key):
  quantize -> programming variation -> retention drift -> stuck faults -> clip
then per read cycle:
  read noise -> clip

Each random function is split in two: a draw (``perturb_draws``,
``fault_draw``, ``read_noise_draw``) from explicit keys
(``core.prng``) through ``torch.Generator``s, and a deterministic apply
(``sample_fault_masks``, ``perturb_conductance``, ``apply_read_noise``)
that takes the draws as tensors -- so the apply halves can be fed the
reference's own draws.  Each step is an exact identity at its ideal
value, and padded lattice sites (g == 0, no physical cell) are never
touched.

Per-tile heterogeneity: a tile-indexed scenario (leaves ``(NB, NO)``)
broadcasts its leaves over the plan's lattice; one draw covers the whole
plan.  Fault-aware remapping: ``remap_plan`` predicts the stuck-off mask a
``(plan, scenario, key)`` triple realizes (``realized_fault_masks``),
asks ``crossbar.fault_aware_group_perm``'s assignment for an output-group
permutation, and returns a permuted plan whose ``out_perm`` gather undoes
the move at assemble time.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import AnalogConfig
from repro_torch.core import prng
from repro_torch.core.circuit import CircuitParams
from repro_torch.core.crossbar import (ConductancePlan, _perm_candidates,
                                       finish_group_perm)
from repro_torch.nonideal.scenario import Scenario


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant in ``like``'s dtype and device (the reference
    casts a weak-typed scalar to the array's dtype before the op)."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _lv(v, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """A scenario leaf as a tensor on ``like``'s device that broadcasts
    against ``like``: a scalar is 0-d; an ``(NB, NO)`` or ``(n,)`` leaf
    aligns with ``like``'s leading axes."""
    t = torch.as_tensor(v, dtype=dtype).to(like.device) \
        if not isinstance(v, torch.Tensor) else v.to(like.device, dtype)
    if t.dim() and t.dim() < like.dim():
        t = t.reshape(t.shape + (1,) * (like.dim() - t.dim()))
    return t


# --------------------------------------------------------------------------- #
# Draws
# --------------------------------------------------------------------------- #
def perturb_draws(shape, key, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fabricated device's draws for ``perturb_conductance``: the
    programming noise ``eps`` (standard normal) and the fault draw ``u``
    (uniform), from the two halves of ``key``."""
    kp, kf = prng.split(prng.as_key(key))
    eps = torch.randn(shape, generator=prng.generator(kp, device),
                      device=device)
    return eps, fault_draw(shape, key, device)


def fault_draw(shape, key, device) -> torch.Tensor:
    """The uniform fault draw of ``perturb_draws`` alone (what
    ``realized_fault_masks`` needs)."""
    _, kf = prng.split(prng.as_key(key))
    return torch.rand(shape, generator=prng.generator(kf, device),
                      device=device)


def read_noise_draw(shape, key, device) -> torch.Tensor:
    """One read cycle's standard-normal draw for ``apply_read_noise``."""
    return torch.randn(shape, generator=prng.generator(prng.as_key(key),
                                                       device),
                       device=device)


# --------------------------------------------------------------------------- #
# Applies
# --------------------------------------------------------------------------- #
def sample_fault_masks(u: torch.Tensor, p_stuck_on, p_stuck_off
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(stuck_on, stuck_off) boolean masks from ONE uniform draw per cell:
    disjoint for p_on + p_off <= 1, and nested across rate sweeps (cells
    stuck at p = 0.001 stay stuck at p = 0.01)."""
    on = u < _lv(p_stuck_on, u)
    if isinstance(p_stuck_off, (int, float)):
        thr = _lv(1.0 - p_stuck_off, u)      # the reference's Python double
    else:
        thr = 1.0 - _lv(p_stuck_off, u)
    return on, u > thr


def drift_factor(scenario: Scenario) -> torch.Tensor:
    """Retention decay multiplier (t / t0)^-nu (float32, the leaves'
    shape); exactly 1.0 where drift is inactive."""
    return drift_factor_at_age(scenario, None)


def drift_factor_at_age(scenario: Scenario, age: Optional[float]
                        ) -> torch.Tensor:
    """``drift_factor`` with the scenario's ``drift_t`` replaced by
    ``age`` seconds (None: the scenario's own), on the device of the
    tensor leaves (the CPU for a scalar corner): a fleet's per-device
    leaves on the card age there, with no host round trip."""
    vals = (scenario.drift_t if age is None else age, scenario.drift_nu,
            scenario.drift_t0)
    dev = next((v.device for v in vals if isinstance(v, torch.Tensor)),
               torch.device("cpu"))
    return drift_multiplier(*(v.detach().to(dev, torch.float32)
                              if isinstance(v, torch.Tensor)
                              else torch.tensor(v, dtype=torch.float32,
                                                device=dev)
                              for v in vals))


def drift_multiplier(t: torch.Tensor, nu: torch.Tensor,
                     t0: torch.Tensor) -> torch.Tensor:
    """``(t / t0)^-nu`` on float32 tensors of one device, exactly 1.0
    where drift is inactive (nu == 0 or t <= 0)."""
    active = (nu != 0.0) & (t > 0.0)
    tt = torch.clamp_min(t, 1e-30) / t0
    return torch.where(active, torch.pow(tt, -nu),
                       torch.ones((), device=t.device))


def quantize_levels(g: torch.Tensor, acfg: AnalogConfig, n_levels
                    ) -> torch.Tensor:
    """Snap to n_levels equispaced programming levels over [g_min, g_max]
    (identity where n_levels < 2).  Float32 out, as in the reference."""
    span = acfg.g_max - acfg.g_min
    nl = _lv(n_levels, g, torch.int32)
    lm1 = torch.clamp_min(nl.float() - 1.0, 1.0)
    a = (g - _c(acfg.g_min, g)) / _c(span, g)            # g's own dtype
    b = torch.round(a.float() * lm1) / lm1               # float32 lm1 promotes
    gq = _c(acfg.g_min, b) + _c(span, b) * b
    return torch.where(nl >= 2, gq, g.float())


def perturb_conductance(g: torch.Tensor, acfg: AnalogConfig,
                        scenario: Scenario, eps: torch.Tensor,
                        u: torch.Tensor,
                        drift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Device-state perturbation (programming + retention + faults) of raw
    conductances, given the device's draws (``perturb_draws``).  Read
    noise is separate (per read cycle): ``apply_read_noise``.  ``drift``
    is the retention multiplier when the caller has it (default:
    ``drift_factor(scenario)``)."""
    live = g > 0.0
    gp = quantize_levels(g, acfg, scenario.n_levels)
    gp = gp * torch.exp(_lv(scenario.prog_sigma, g) * eps)
    gp = gp * _lv(drift_factor(scenario) if drift is None else drift, g)
    on, off = sample_fault_masks(u, _leaf_for(scenario.p_stuck_on, g),
                                 _leaf_for(scenario.p_stuck_off, g))
    gmax, gmin = _c(acfg.g_max, gp), _c(acfg.g_min, gp)
    gp = torch.where(on, gmax, gp)
    gp = torch.where(off, gmin, gp)
    return torch.where(live, torch.clamp(gp, gmin, gmax), g.float())


def _leaf_for(v, g: torch.Tensor):
    """A rate leaf for ``sample_fault_masks``: Python scalars stay Python
    (its threshold then rounds as the reference's does), tensors align
    with ``g``."""
    return v if isinstance(v, (int, float)) else _lv(v, g)


def apply_read_noise(g: torch.Tensor, acfg: AnalogConfig, read_sigma,
                     eps: torch.Tensor) -> torch.Tensor:
    """Cycle-to-cycle multiplicative read noise given the cycle's draw
    ``eps``.  ``read_sigma`` may be a scalar or an (NB, NO) per-tile
    tensor aligned with ``g``'s leading axes.  Padded sites stay zero."""
    rs = _lv(read_sigma, g)
    gn = g * (1.0 + rs * eps)
    return torch.where(g > 0.0, torch.clamp(gn, _c(acfg.g_min, gn),
                                            _c(acfg.g_max, gn)), g)


# --------------------------------------------------------------------------- #
# Plan level (scalar scenario or (NB, NO) per-tile batch)
# --------------------------------------------------------------------------- #
def _check_tile_shape(plan: ConductancePlan, scenario: Scenario):
    ts = scenario.tile_shape
    if ts is not None and ts != (plan.NB, plan.NO):
        raise ValueError(
            f"per-tile scenario batch shaped {ts} does not match the "
            f"plan's (NB, NO) = {(plan.NB, plan.NO)} tile lattice")
    return ts


def perturb_plan(plan: ConductancePlan, acfg: AnalogConfig,
                 scenario: Scenario, key) -> ConductancePlan:
    """Device-state-perturbed copy of a plan (layout unchanged).  One
    device key draws the whole plan; a tile-indexed scenario's leaves
    broadcast over the lattice, so tile (i, j) sees ``leaf[i, j]``."""
    _check_tile_shape(plan, scenario)
    g = plan.g_feat
    eps, u = perturb_draws(g.shape, key, g.device)
    return plan.with_g(perturb_conductance(g, acfg, scenario, eps, u), acfg)


def realized_fault_masks(plan: ConductancePlan, scenario: Scenario, key
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact (stuck_on, stuck_off) masks ``perturb_plan`` realizes
    for this (plan, scenario, key): they depend on shapes and the key,
    never on the conductances, which is what lets the remapper move
    weights without moving the faults."""
    _check_tile_shape(plan, scenario)
    g = plan.g_feat
    u = fault_draw(g.shape, key, g.device)
    return sample_fault_masks(u, _leaf_for(scenario.p_stuck_on, g),
                              _leaf_for(scenario.p_stuck_off, g))


def remap_plan(plan: ConductancePlan, acfg: AnalogConfig, scenario: Scenario,
               key, top_q: float = 0.9,
               horizon: Optional[Sequence[float]] = None
               ) -> Tuple[ConductancePlan, torch.Tensor]:
    """Stuck-fault-aware remapped copy of a plan: ``(remapped, out_perm)``.

    Predicts the stuck-off mask for ``(plan, scenario, key)``, computes
    the output-group permutation that keeps the top-``top_q``-quantile
    |w| cells off stuck-off cells, and returns the permuted plan with the
    ``out_perm`` gather.  Identity without stuck-off faults.  Perturb the
    result with the SAME key: the faults then land on the cells the
    permutation was planned against.  ``horizon`` (ages in seconds)
    switches to wear-aware selection: a second candidate is grown under
    the damage anticipated over the drift trajectory, and the candidate
    with the lower realized end-of-horizon deviation wins (instant on
    ties)."""
    dev = plan.g_feat.device
    if not scenario.has_stuck_off:
        return plan, torch.arange(plan.N, device=dev)
    _, off = realized_fault_masks(plan, scenario, key)
    g = plan.g_feat.double().cpu().numpy()
    hz = None
    if horizon is not None:
        hz = [drift_factor_at_age(scenario, t).cpu().numpy()
              for t in horizon]
    cands = _perm_candidates(g, off.cpu().numpy(), plan, acfg, top_q, hz,
                             device=dev)
    gperm = cands[0]
    if len(cands) > 1:
        scores = [_realized_horizon_score(plan, acfg, scenario, key, c,
                                          horizon) for c in cands]
        if scores[1] < scores[0]:                      # instant wins ties
            gperm = cands[1]
    out_perm, gperm, ginv = finish_group_perm(gperm, plan)
    ginv_t = torch.from_numpy(ginv.astype(np.int64)).to(dev)
    remapped = plan.with_g(torch.index_select(plan.g_feat, 1, ginv_t),
                           acfg).with_perm(
        torch.from_numpy(out_perm.astype(np.int64)).to(dev))
    return remapped, remapped.out_perm


def _realized_horizon_score(plan: ConductancePlan, acfg: AnalogConfig,
                            scenario: Scenario, key, gperm: np.ndarray,
                            ages: Sequence[float]) -> float:
    """Realized end-of-horizon weight deviation of a remap candidate: the
    candidate's plan perturbed with the deployment's (scenario, key) at
    each age, gathered back into logical order, and
    ``min_a ||W_young - a W_aged||_F^2`` over the real columns, averaged
    over the ages."""
    gperm = np.asarray(gperm)
    ginv = np.empty_like(gperm)
    ginv[gperm] = np.arange(gperm.shape[0], dtype=gperm.dtype)
    no = plan.no
    col = np.arange(plan.NO)[:, None] * no + np.arange(no)[None, :]
    vmask = (col < plan.N)[None, :, None, None, :].astype(np.float64)
    g = plan.g_feat.double().cpu().numpy()
    w_young = (g[..., 0::2] - g[..., 1::2]) * vmask
    idx = torch.from_numpy(ginv.astype(np.int64)).to(plan.g_feat.device)
    base = plan.with_g(torch.index_select(plan.g_feat, 1, idx), acfg)
    total = 0.0
    for t in ages:
        tt = (float(t) if scenario.tile_shape is None
              else torch.full(scenario.tile_shape, float(t)))
        aged = dataclasses.replace(scenario, drift_t=tt)
        eff = perturb_plan(base, acfg, aged, key).g_feat.double().cpu() \
            .numpy()[:, gperm]
        w_eff = (eff[..., 0::2] - eff[..., 1::2]) * vmask
        ee = float((w_eff * w_eff).sum())
        a = float((w_eff * w_young).sum()) / ee if ee > 0.0 else 1.0
        r = w_young - a * w_eff
        total += float((r * r).sum())
    return total / max(len(list(ages)), 1)


def scenario_circuit_params(cp: CircuitParams,
                            scenario: Scenario) -> CircuitParams:
    """Line-resistance scaling for the circuit solver."""
    if scenario.r_line_scale == 1.0:
        return cp
    return dataclasses.replace(cp, r_bl=cp.r_bl * scenario.r_line_scale)
