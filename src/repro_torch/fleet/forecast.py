"""Per-device accuracy forecasting across the drift timeline (port of
``repro.fleet.forecast``).

Two tiers, matching the two budgets a fleet operator has:

  * ``forecast_fleet`` -- EXACT trajectories: every requested device
    replayed through the fleet's chunk step at each (age, calibration
    age) pair.  Drift is deterministic given the fab draw, so the device
    at 1 month is computable today.  Cost: one population pass per grid
    point.
  * ``SurrogateRanker`` -- CHEAP scores for the whole population: a
    quantile-shifted linear regression from per-device scenario summary
    features (``Fleet.device_features``) and a drift-age encoding to the
    exact error, fitted on a small probed subsample.  At ``tau = 0.8`` it
    predicts a conservative upper quantile of the error, which is what a
    maintenance planner should rank by.  The fit is a closed-form ridge
    solve plus a tau-quantile intercept shift, in numpy as the reference
    does it.

Maintenance reprograms the array: a device maintained at ``cal_age =
tc`` and served at ``t`` carries ``t - tc`` seconds of drift on a fresh
write, so its error depends on the drift age alone; the surrogate's
features and age encoding are both evaluated at ``t - tc``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from repro_torch.fleet.population import Fleet
from repro_torch.obs import OBS

_AGE_SCALE = 16.0          # matches scenario._DRIFT_AGE_SCALE


def forecast_fleet(fleet: Fleet, x, ages: Sequence[float],
                   ids: Optional[np.ndarray] = None,
                   cal_age=0.0) -> np.ndarray:
    """Exact (n_devices, n_ages) relative-error trajectories; ``cal_age``
    is the age the affine was (or will be) fitted at, scalar or per
    device."""
    cols = [fleet.evaluate(x, t, ids=ids, cal_age=cal_age) for t in ages]
    return np.stack(cols, axis=1)


def _ranker_features(feats: np.ndarray, drift_age: np.ndarray) -> np.ndarray:
    """Design matrix: device summary features (evaluated AT the drift
    age), a drift-age encoding and an intercept."""
    d = np.broadcast_to(np.asarray(drift_age, np.float32),
                        (feats.shape[0],))
    enc = np.log1p(np.maximum(d, 0.0)) / _AGE_SCALE
    ones = np.ones((feats.shape[0], 1), np.float32)
    return np.concatenate([feats, enc[:, None], ones],
                          axis=1).astype(np.float64)


@dataclass
class SurrogateRanker:
    """Quantile-regression surrogate for per-device serving error.

    ``fit`` probes ``n_probe`` devices exactly over the (age, cal_age)
    grid, ridge-fits the conditional mean and shifts the intercept by the
    tau-quantile of the training residuals (a calibrated tau-quantile on
    the probe set by construction); ``predict`` then scores any device at
    any (age, cal_age) from its cheap features alone."""
    tau: float = 0.8
    coef: Optional[np.ndarray] = None
    train_pinball: float = field(default=float("nan"), init=False)

    def fit(self, fleet: Fleet, x, ages: Sequence[float],
            n_probe: int = 128, key: int = 0) -> "SurrogateRanker":
        """Probe an evenly-strided ``n_probe``-device subsample over every
        valid (age, cal_age <= age) pair and fit the quantile surface."""
        n = fleet.spec.n_devices
        stride = max(1, n // max(1, int(n_probe)))
        ids = np.arange(0, n, stride, dtype=np.int32)[:int(n_probe)]
        grid = [(t, c) for t in ages for c in [0.0] + list(ages) if c <= t]
        grid = list(dict.fromkeys(grid))      # dedupe, order kept
        Xs, ys = [], []
        for t, c in grid:
            err = fleet.evaluate(x, t, ids=ids, cal_age=c)
            drift = np.full(ids.shape, t - c, np.float32)
            Xs.append(_ranker_features(
                fleet.device_features(ids, drift), drift))
            ys.append(err.astype(np.float64))
        X = np.concatenate(Xs, axis=0)
        y = np.concatenate(ys, axis=0)
        # column scaling for a well-conditioned ridge solve
        scale = np.maximum(np.abs(X).max(axis=0), 1e-9)
        Xs_ = X / scale
        wvec = np.linalg.solve(Xs_.T @ Xs_ + 1e-6 * np.eye(X.shape[1]),
                               Xs_.T @ y)
        # the intercept column is last and of unit scale: shifting it moves
        # every prediction by the residuals' tau-quantile
        wvec[-1] += np.quantile(y - Xs_ @ wvec, self.tau)
        self.coef = wvec / scale
        r = y - X @ self.coef
        self.train_pinball = float(
            np.mean(np.where(r > 0, self.tau * r, (self.tau - 1.0) * r)))
        if OBS.enabled:
            OBS.gauge("fleet_surrogate_pinball",
                      "training pinball loss of the fitted forecast "
                      "surrogate", tag=fleet.tag).set(self.train_pinball)
        return self

    def predict(self, fleet: Fleet, ids: np.ndarray, age,
                cal_age=0.0) -> np.ndarray:
        """Predicted tau-quantile relative error for each device."""
        if self.coef is None:
            raise ValueError("SurrogateRanker.predict before fit")
        ids = np.asarray(ids, np.int32)
        n = ids.shape[0]
        age_a = np.broadcast_to(np.asarray(age, np.float32), (n,))
        cal_a = np.broadcast_to(np.asarray(cal_age, np.float32), (n,))
        drift = np.maximum(age_a - cal_a, 0.0)
        X = _ranker_features(fleet.device_features(ids, drift), drift)
        return (X @ self.coef).astype(np.float32)
