"""Predictive maintenance: per-device action timelines from a cost model
(port of ``repro.fleet.maintenance``; numpy, as the reference).

``MaintenancePlanner`` turns forecasts into schedules.  The action
vocabulary per device per checkpoint:

  none          -- serve on, risking the accuracy SLO;
  recalibrate   -- rewrite the array and refit the volts->logical
                   affine: a fresh programming draw for the epoch, the
                   retention-drift clock reset to zero (stuck cells
                   persist -- fab defects survive a rewrite).  Cohorts
                   are batched: every device maintained at a checkpoint
                   rides the same chunk pass;
  field_retrain -- recalibrate + field fine-tune of the emulator on the
                   device's own serving distribution.  Under a
                   scenario-conditioned emulator the fine-tune buys
                   nothing the feature operands don't already provide
                   (``retrain_gain = 1.0``), so the cost model discovers
                   what docs/emulator.md argues: the action is dominated
                   and never scheduled.  Unconditioned fleets can set
                   ``retrain_gain < 1`` from a measured probe cohort.
  retire        -- swap in a spare: one-time cost, no further SLO
                   exposure (the device leaves the error pool).

plus one fleet-level decision: whether deployment-time remapping should
be *wear-aware* (``remap_horizon``: score permutations against the whole
maintenance timeline's drift trajectory instead of the young device --
``nonideal.remap_plan(horizon=...)``).

Planning is per-device dynamic programming over (last-calibration
checkpoint, retrained?, retired?) states -- exact for the cost model,
vectorized over the population with numpy -- on error forecasts from
either the ``SurrogateRanker`` (default: cheap enough for a million
devices) or the exact chunk-replayed grid (``exact=True``).  The cost
model is additive per device:

  total = sum_checkpoints action_cost + slo_penalty * 1{err > slo}

``simulate_policy`` replays ANY action table (the planner's or a
baseline's) through the fleet's one built chunk step with the
realized per-device calibration ages, returning per-checkpoint realized
error, violations, cost, and the cost-adjusted accuracy
``mean(1 / (1 + err)) - acc_per_cost * cum_cost / n`` that
``benchmarks/bench_fleet.py`` gates on.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.fleet.forecast import SurrogateRanker
from repro_torch.fleet.population import Fleet
from repro_torch.obs import OBS

# action codes in the (n_devices, n_checkpoints) timeline tables
A_NONE, A_RECAL, A_RETRAIN, A_RETIRE = 0, 1, 2, 3
ACTION_NAMES: Tuple[str, ...] = ("none", "recalibrate", "field_retrain",
                                 "retire")


@dataclass(frozen=True)
class ActionCosts:
    """Unit costs of the maintenance cost model (arbitrary but common
    units; only ratios matter to the planner).

    ``slo_penalty`` prices one checkpoint of one device serving above
    the error SLO; ``acc_per_cost`` converts accumulated cost into
    accuracy points for the cost-adjusted accuracy report."""
    recalibrate: float = 1.0
    field_retrain: float = 8.0
    retire: float = 40.0
    slo_penalty: float = 25.0
    acc_per_cost: float = 0.002


@dataclass
class FleetPlan:
    """A materialized maintenance schedule.

    ``actions[d, i]`` is the action code for device ``d`` at checkpoint
    ``i`` of ``timeline``; ``expected_cost`` is the DP objective (per
    the forecasts); ``remap_horizon`` is the fleet-level wear-aware
    remap decision (None = instantaneous remapping)."""
    timeline: Tuple[float, ...]
    actions: np.ndarray
    expected_cost: float
    remap_horizon: Optional[Tuple[float, ...]] = None

    def cohorts(self, i: int) -> Dict[str, np.ndarray]:
        """Device-id cohorts per action at checkpoint ``i`` -- the
        batched-recalibration view: every id in one cohort shares the
        same traced calibration age, so the whole cohort is served by
        the same chunk step in one pass."""
        return {ACTION_NAMES[a]: np.where(self.actions[:, i] == a)[0]
                for a in (A_NONE, A_RECAL, A_RETRAIN, A_RETIRE)
                if np.any(self.actions[:, i] == a)}


def never_policy(n_devices: int, timeline: Sequence[float]) -> np.ndarray:
    """Baseline: deploy, calibrate once, never touch again."""
    return np.full((n_devices, len(timeline)), A_NONE, np.int8)


def always_recalibrate_policy(n_devices: int,
                              timeline: Sequence[float]) -> np.ndarray:
    """Baseline: recalibrate every device at every checkpoint."""
    return np.full((n_devices, len(timeline)), A_RECAL, np.int8)


def _realized_cal_ages(actions: np.ndarray,
                       timeline: Sequence[float]) -> np.ndarray:
    """(n, T) age of the last calibration in effect AT each checkpoint
    (recalibration at checkpoint i serves checkpoint i already)."""
    n, T = actions.shape
    cal = np.zeros((n, T), np.float32)
    last = np.zeros((n,), np.float32)
    for i, t in enumerate(timeline):
        did = (actions[:, i] == A_RECAL) | (actions[:, i] == A_RETRAIN)
        last = np.where(did, np.float32(t), last)
        cal[:, i] = last
    return cal


def simulate_policy(fleet: Fleet, x, timeline: Sequence[float],
                    actions: np.ndarray, costs: ActionCosts,
                    slo: float, retrain_gain: float = 1.0,
                    policy: str = "plan") -> List[dict]:
    """Replay an action table against the real (simulated) fleet.

    Retired devices leave the error pool from their retirement checkpoint
    on (a spare serves at ideal accuracy) but their one-time cost stays
    on the books.  Returns one record per checkpoint with the realized
    mean/p95 error, SLO violations, cumulative cost and the
    cost-adjusted accuracy the benchmark gates compare."""
    acts = np.asarray(actions, np.int8)
    n, T = acts.shape
    cal = _realized_cal_ages(acts, timeline)
    retired = np.zeros((n,), bool)
    gain = np.ones((n,), np.float32)
    cum_cost = 0.0
    out: List[dict] = []
    unit = np.array([0.0, costs.recalibrate, costs.field_retrain,
                     costs.retire], np.float64)
    for i, t in enumerate(timeline):
        newly_retired = (acts[:, i] == A_RETIRE) & ~retired
        retired |= newly_retired
        gain = np.where(acts[:, i] == A_RETRAIN,
                        np.float32(retrain_gain), gain)
        live = ~retired
        err = np.zeros((n,), np.float32)
        if live.any():
            ids = np.where(live)[0].astype(np.int32)
            err[ids] = fleet.evaluate(x, t, ids=ids,
                                      cal_age=cal[ids, i]) * gain[ids]
        viol = int(((err > slo) & live).sum())
        # devices retired at an earlier checkpoint act (and cost) nothing;
        # the retiring checkpoint itself books the one-time retire cost
        act_cost = float(unit[acts[live | newly_retired, i]].sum())
        cum_cost += act_cost + costs.slo_penalty * viol
        acc = np.where(live, 1.0 / (1.0 + err), 1.0)
        rec = {
            "t": float(t),
            "mean_err": float(err[live].mean()) if live.any() else 0.0,
            "p95_err": (float(np.quantile(err[live], 0.95))
                        if live.any() else 0.0),
            "violations": viol,
            "retired": int(retired.sum()),
            "action_cost": act_cost,
            "cum_cost": float(cum_cost),
            "mean_acc": float(acc.mean()),
            "cost_adjusted_acc": float(
                acc.mean() - costs.acc_per_cost * cum_cost / n),
        }
        out.append(rec)
        if OBS.enabled:
            OBS.counter("fleet_slo_violations_total",
                        "SLO-violating device-checkpoints per policy",
                        tag=fleet.tag, policy=policy).inc(float(viol))
            OBS.gauge("fleet_policy_cost_adjusted_acc",
                      "cost-adjusted accuracy at the latest checkpoint",
                      tag=fleet.tag, policy=policy
                      ).set(rec["cost_adjusted_acc"])
    return out


@dataclass
class MaintenancePlanner:
    """Cost-optimal per-device maintenance schedules.

    Builds on the ``LifetimeScheduler`` model of a fleet walk (deploy
    -> age -> mitigate at checkpoints; same mitigations, same drift
    timeline) but plans each DEVICE independently against forecasts
    instead of applying one policy fleet-wide.

    Attributes:
      fleet:        the population to plan for.
      timeline:     checkpoint ages in seconds (``t0 = 0`` deployment
                    calibration is implicit and free).
      costs:        the cost model.
      slo:          relative-error SLO a serving device must stay under.
      margin:       forecast safety margin: a device is treated as
                    at-risk when its predicted error exceeds
                    ``slo * (1 - margin)``.
      retrain_gain: multiplicative residual-error factor a field
                    retrain buys (1.0 under a conditioned emulator).
      exact:        plan on exact chunk-replayed forecasts instead of
                    the surrogate (small fleets / ground truth).
      n_probe:      surrogate probe-subsample size.
    """
    fleet: Fleet
    timeline: Sequence[float]
    costs: ActionCosts = field(default_factory=ActionCosts)
    slo: float = 0.1
    margin: float = 0.1
    retrain_gain: float = 1.0
    exact: bool = False
    n_probe: int = 128
    ranker: Optional[SurrogateRanker] = None

    def _forecast_grid(self, x) -> np.ndarray:
        """E[d, i, j]: predicted error at checkpoint i when last
        calibrated at checkpoint j (j <= i; j indexes ``[0] + timeline``
        so j = 0 is the deployment calibration).

        The surrogate grid is clamped from below by each device's
        MEASURED commissioning floor: the freshly-maintained residual at
        the first checkpoint, replayed exactly for the whole population
        (one chunk pass -- operationally free, it is the calibration
        probe's own residual).  The floor is a realization quantity
        (this device's programming draw and stuck cells), invisible to
        any feature-based surrogate; without the clamp the planner
        schedules futile recalibrations for devices whose floor already
        violates the SLO instead of retiring them."""
        ages = list(self.timeline)
        cals = [0.0] + ages
        n = self.fleet.spec.n_devices
        ids = np.arange(n, dtype=np.int32)
        E = np.full((n, len(ages), len(cals)), np.inf, np.float32)
        if self.exact:
            for j, c in enumerate(cals):
                for i, t in enumerate(ages):
                    if c <= t:
                        E[:, i, j] = self.fleet.evaluate(x, t, cal_age=c)
            return E
        if self.ranker is None:
            self.ranker = SurrogateRanker().fit(
                self.fleet, x, ages, n_probe=self.n_probe)
        for j, c in enumerate(cals):
            for i, t in enumerate(ages):
                if c <= t:
                    E[:, i, j] = self.ranker.predict(self.fleet, ids, t,
                                                     cal_age=c)
        floor = self.fleet.evaluate(x, ages[0], cal_age=ages[0])
        return np.maximum(E, floor[:, None, None])

    def _choose_remap_horizon(self) -> Optional[Tuple[float, ...]]:
        """Fleet-level wear-aware remap decision: when the base corner
        carries stuck-off faults AND drift, score deployment-time
        remapping against the whole maintenance timeline
        (``remap_plan(horizon=...)``); otherwise instantaneous remapping
        (or none) is already optimal."""
        base = self.fleet.spec.base
        if base.has_stuck_off and bool(np.any(np.asarray(base.drift_nu))):
            return tuple(float(t) for t in self.timeline)
        return None

    def plan(self, x) -> FleetPlan:
        """Exact DP over the cost model, vectorized across devices.

        Device state at checkpoint i: (last-calibration index j,
        retrained?) or retired.  ``slo * (1 - margin)`` thresholds the
        forecasts; the realized dominance is asserted downstream by
        ``simulate_policy`` (benchmarks/bench_fleet.py)."""
        E = self._forecast_grid(x)
        n, T, _ = E.shape
        thr = self.slo * (1.0 - self.margin)
        pen = self.costs.slo_penalty
        c_re, c_ft = self.costs.recalibrate, self.costs.field_retrain
        c_rt = self.costs.retire
        # value[d, s]: cost-to-go from checkpoint i with state s; states
        # 0..T = last-cal index (plain), T+1..2T+1 = last-cal index
        # (retrained), 2T+2 = retired
        S = 2 * (T + 1) + 1
        RET = S - 1
        val = np.zeros((n, S), np.float64)
        act = np.empty((T, n, S), np.int8)
        nxt = np.empty((T, n, S), np.int16)
        for i in range(T - 1, -1, -1):
            new = np.empty((n, S), np.float64)
            for s in range(S):
                if s == RET:
                    new[:, s] = val[:, RET]
                    act[i, :, s] = A_NONE
                    nxt[i, :, s] = RET
                    continue
                j = s if s <= T else s - (T + 1)
                g = 1.0 if s <= T else self.retrain_gain
                e_stay = E[:, i, j] * g
                e_recal = E[:, i, i + 1] * g
                e_ftr = E[:, i, i + 1] * self.retrain_gain
                s_recal = (i + 1) if s <= T else (T + 1) + (i + 1)
                s_ftr = (T + 1) + (i + 1)
                cand = np.stack([
                    pen * (e_stay > thr) + val[:, s],
                    c_re + pen * (e_recal > thr) + val[:, s_recal],
                    c_ft + pen * (e_ftr > thr) + val[:, s_ftr],
                    c_rt + val[:, RET],
                ], axis=1)
                best = cand.argmin(axis=1)
                new[:, s] = cand[np.arange(n), best]
                act[i, :, s] = best.astype(np.int8)
                nxt[i, :, s] = np.where(
                    best == A_NONE, s,
                    np.where(best == A_RECAL, s_recal,
                             np.where(best == A_RETRAIN, s_ftr, RET)))
            val = new
        # forward pass: extract each device's argmin timeline from s = 0
        actions = np.empty((n, T), np.int8)
        state = np.zeros((n,), np.int16)
        rows = np.arange(n)
        for i in range(T):
            actions[:, i] = act[i, rows, state]
            state = nxt[i, rows, state]
        expected = float(val[:, 0].sum())
        plan = FleetPlan(timeline=tuple(float(t) for t in self.timeline),
                         actions=actions, expected_cost=expected,
                         remap_horizon=self._choose_remap_horizon())
        if OBS.enabled:
            for a, name in enumerate(ACTION_NAMES):
                OBS.counter("fleet_plan_actions_total",
                            "actions scheduled by the maintenance "
                            "planner", tag=self.fleet.tag, action=name
                            ).inc(float((actions == a).sum()))
            OBS.gauge("fleet_plan_expected_cost",
                      "DP objective of the latest maintenance plan",
                      tag=self.fleet.tag).set(expected)
        return plan
