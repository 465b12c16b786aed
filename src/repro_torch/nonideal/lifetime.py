"""Fleet lifetime management: drift-scheduled recalibration / retraining
(port of ``repro.nonideal.lifetime``).

A deployed crossbar fleet ages: retention drift shrinks conductances as
``g * (t / t0)^-nu`` while the programming draw and the stuck cells fixed
at fabrication persist, so serving accuracy decays mostly because the
calibration and the emulator were fitted to the young device.
``LifetimeScheduler`` walks a drift timeline (``DEFAULT_TIMELINE``: 1h /
1d / 1mo) and at each checkpoint applies the mitigations the subsystem
provides:

  * remap       -- stuck-fault-aware column remapping
                   (``AnalogExecutor.deploy(remap=...)``);
  * recalibrate -- noise-aware affine refit against the aged device
                   (``AnalogExecutor.calibrate``); past deployment it
                   warm-starts from the previous affine on half the probe
                   budget (calibration transfer, recorded as ``calib_n``);
  * retrain     -- a callback returning fine-tuned emulator params,
                   hot-swapped with ``deploy(params=...)``:
                   ``make_noise_aware_retrainer`` (the corner's
                   distribution), ``make_field_retrainer`` (the fleet's
                   own aged blocks under its own drive), or, for a
                   scenario-conditioned net, the deployment-only
                   ``make_conditioned_field_calibrator`` -- the scheduler
                   then never retrains between checkpoints
                   (``prefer_conditioned``).

The fleet identity is the executor's ``scenario_key``: the scheduler ages
the scenario under a fixed key, so every checkpoint sees the same
fabricated devices, only older.  Every intervention is a new deployment
state of the same tags: the conductance plan of each tag is built once for
the whole walk (``AnalogExecutor.builds["plan"]``), as the reference's walk
compiles its forward once.  The reference draws its probes inside
``calibrate``; here they come from ``core.prng`` keys
(``analog.calibration_probes``) under the reference's key derivation.
Telemetry: the reference's ``lifetime_*`` gauges and counters.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.core import prng
from repro_torch.nonideal.scenario import Scenario, collapse_tiles
from repro_torch.obs import OBS

# Canonical drift checkpoints: (label, seconds since programming).
DEFAULT_TIMELINE: Tuple[Tuple[str, float], ...] = (
    ("1h", 3_600.0),
    ("1d", 86_400.0),
    ("1mo", 2_592_000.0),
)


def scenario_at_age(scenario: Scenario, t: float) -> Scenario:
    """The same device corner ``t`` seconds after programming: rewrites
    ``drift_t`` only (broadcast to the (NB, NO) lattice for a tiled
    batch)."""
    ts = scenario.tile_shape
    tt = float(t) if ts is None else torch.full(ts, float(t),
                                                dtype=torch.float32)
    return dataclasses.replace(scenario, drift_t=tt)


def make_noise_aware_retrainer(geom, acfg, cp, key, n: int = 4096,
                               epochs: int = 30,
                               lr: float = 2e-4) -> Callable:
    """Retrain callback: warm-start fine-tuning of the SERVING params on
    circuit data perturbed by the aged corner
    (``nonideal.data.finetune_emulator``).  A tiled corner is collapsed to
    its mean field (the data generator samples block tensors with no
    lattice to index).  The key is fixed across checkpoints: common
    random numbers keep the accuracy-vs-age curve free of data-draw
    jitter."""
    from repro_torch.nonideal.data import finetune_emulator

    def retrain(scenario: Scenario, t: float, ex, w, tag: str) -> dict:
        return finetune_emulator(key, ex.emulator_params, geom, acfg, cp,
                                 collapse_tiles(scenario), n=n,
                                 epochs=epochs, lr=lr)

    return retrain


def _probe_blocks(ex, plan, xc: torch.Tensor, solve):
    """Serving-exact probe blocks for field fine-tuning: the probe rows
    ``xc`` (n, K) driven through the plan's rail/tile path as the slow
    path drives them (dual rail, gate overdrive), labelled by ``solve``.
    Returns ``(X normalized, periph2, Y)`` -- every retrain/calibration
    callback shares this one construction, so the train and serve drives
    cannot drift apart."""
    from repro_torch.core.emulator import normalize_features

    x2 = xc.float()
    x_scale = torch.clamp_min(torch.max(torch.abs(x2)), 1e-9)
    rails = torch.cat([torch.clamp_min(x2, 0.0), torch.clamp_min(-x2, 0.0)],
                      dim=0)
    vb01 = plan.tile_v(ex._drive01(rails / x_scale), 1.0)
    xb = plan.build_x(vb01 * ex.acfg.v_read).float()
    n = xb.shape[0]
    periph = torch.cat([torch.ones((n, 1), device=xb.device),
                        torch.zeros((n, 1), device=xb.device)], dim=-1)
    return normalize_features(xb, ex.acfg), periph, solve(xb, periph)


def _solver(ex, scenario: Scenario):
    from repro_torch.core.circuit import block_response
    from repro_torch.nonideal.perturb import scenario_circuit_params
    cp_s = scenario_circuit_params(ex.cp, collapse_tiles(scenario))
    return lambda b, p: block_response(b, cp_s, p)


def make_field_retrainer(key, n: int = 192, epochs: int = 40,
                         batch_size: int = 512,
                         lr: float = 3e-4) -> Callable:
    """Serving-distribution retrain callback: fine-tune the emulator on
    the fleet's OWN aged blocks -- the executor's perturbed (and
    remapped) plan of the tag, driven by ``n`` calibration-style probes
    through the serving rail/tile path, labelled by the scenario's
    circuit solver.  Each probe contributes ``2 * n_blocks`` samples."""
    from repro_torch.core.analog import calibration_probes
    from repro_torch.nonideal.data import finetune_emulator

    def retrain(scenario: Scenario, t: float, ex, w, tag: str) -> dict:
        plan = ex._scenario_plan(tag, w)          # the fleet's aged devices
        xc = calibration_probes(prng.fold_in(prng.as_key(key), 0xF1E1D), n,
                                w.shape[0], plan.g_feat.device)
        data = _probe_blocks(ex, plan, xc, _solver(ex, scenario))
        return finetune_emulator(key, ex.emulator_params, ex.geom, ex.acfg,
                                 ex.cp, scenario, epochs=epochs,
                                 batch_size=batch_size, lr=lr, data=data)

    return retrain


def make_conditioned_field_calibrator(key,
                                      ages: Tuple[float, ...] = (
                                          0.0, 3_600.0, 86_400.0,
                                          604_800.0, 2_592_000.0),
                                      n: int = 96, epochs: int = 240,
                                      batch_size: int = 512,
                                      lr: float = 3e-4) -> Callable:
    """Deployment-only field calibration for a CONDITIONED emulator.

    Drift is deterministic given the fabrication draw, so the fleet's aged
    devices are predictable at t = 0: this callback fine-tunes once, on the
    realized device at every age in ``ages`` jointly -- each age's blocks
    carrying that age's scenario features in the peripheral vector (one
    vector a tile for a tiled corner, as serving feeds them) -- and returns
    None at every later checkpoint.  ``epochs`` is sized to the
    per-checkpoint fine-tunes' cumulative budget, paid once."""
    from repro_torch.core.analog import calibration_probes
    from repro_torch.nonideal.data import finetune_emulator
    from repro_torch.nonideal.scenario import (scenario_features,
                                               scenario_features_tiled)

    def retrain(scenario: Scenario, t: float, ex, w,
                tag: str) -> Optional[dict]:
        if t > 0.0:
            return None                   # deployment-only
        solve = _solver(ex, scenario)
        xs, ps, ys = [], [], []
        for i, ta in enumerate(ages):
            aged = scenario_at_age(scenario, ta)
            # the serving-exact aged plan: the same fabrication key and
            # remap policy the executor uses at this age
            ex.deploy(scenario=aged, key=ex.scenario_key)
            plan = ex._scenario_plan(tag, w)
            dev = plan.g_feat.device
            xc = calibration_probes(prng.fold_in(prng.as_key(key), i), n,
                                    w.shape[0], dev)
            X, periph2, y = _probe_blocks(ex, plan, xc, solve)
            if aged.tile_shape is not None:
                # build_x rows are lattice-innermost: one vector a tile,
                # repeated over the probe rows
                sf2 = scenario_features_tiled(aged).to(dev)
                sf2 = sf2.reshape(-1, sf2.shape[-1])
                sfr = sf2.repeat(X.shape[0] // sf2.shape[0], 1)
            else:
                sf = scenario_features(aged).to(dev)
                sfr = sf[None].expand(X.shape[0], sf.shape[0])
            xs.append(X)
            ps.append(torch.cat([periph2, sfr], dim=-1))
            ys.append(y)
        ex.deploy(scenario=scenario_at_age(scenario, 0.0),
                  key=ex.scenario_key)
        data = (torch.cat(xs), torch.cat(ps), torch.cat(ys))
        return finetune_emulator(key, ex.emulator_params, ex.geom, ex.acfg,
                                 ex.cp, scenario, epochs=epochs,
                                 batch_size=batch_size, lr=lr, data=data)

    return retrain


@dataclass
class LifetimeScheduler:
    """Walk an aging fleet through drift checkpoints, mitigating as it goes.

    Attributes:
      ex:          the serving ``AnalogExecutor`` to manage (mutated).
      scenario:    the fleet's corner at programming time (t = 0); scalar
                   or per-tile (``tile_scenarios``).
      timeline:    ``(label, seconds)`` checkpoints.
      remap:       stuck-fault-aware column remapping.
      recalibrate: refit the affine at every checkpoint.
      retrain:     optional ``(aged_scenario, t, ex, w, tag) -> params``
                   callback; returned params are hot-swapped.
      prefer_conditioned: with a scenario-conditioned net, run ``retrain``
                   at deployment only (one-time field calibration) and
                   never between checkpoints; False forces the
                   per-checkpoint fine-tunes (the accuracy baseline).
      key:         fleet fabrication key (fixed: the same devices age).
      calib_n:     cold calibration probe count.

    ``deploy`` programs the fleet at t = 0 and calibrates cold; ``step``
    ages it to one checkpoint, retrains, hot-swaps and warm-recalibrates
    (half budget); ``run`` does the whole walk and returns one record per
    checkpoint with the calibrated output ``y`` of ``x @ w``.
    """
    ex: "object"                       # AnalogExecutor (untyped: no cycle)
    scenario: Scenario
    timeline: Tuple[Tuple[str, float], ...] = DEFAULT_TIMELINE
    remap: bool = True
    recalibrate: bool = True
    retrain: Optional[Callable[..., Optional[dict]]] = None
    prefer_conditioned: bool = True
    key: Optional[object] = None
    calib_n: int = 128
    history: List[dict] = field(default_factory=list)

    def __post_init__(self):
        self.key = prng.as_key(0 if self.key is None else self.key)
        self._calib_used = 0

    @property
    def conditioned(self) -> bool:
        """True when the walk rides a scenario-conditioned emulator instead
        of per-checkpoint fine-tunes (see ``prefer_conditioned``)."""
        return self.prefer_conditioned \
            and getattr(self.ex, "emulator_conditioned", False)

    def _retrain(self, scenario: Scenario, t: float, w, tag: str) -> bool:
        """Run the callback under the conditioned-first policy; True iff
        params were hot-swapped."""
        if self.retrain is None or (self.conditioned and t > 0.0):
            return False
        params = self.retrain(scenario, t, self.ex, w, tag)
        if params is None:
            return False
        self.ex.deploy(params=params)
        return True

    def _calibrate(self, w, tag: str, step: int):
        """Refit the affine; past deployment a warm start from the previous
        fit on half the probe budget (calibration transfer)."""
        from repro_torch.core.analog import calibration_probes
        warm = step > 0
        k = prng.fold_in(prng.fold_in(self.key, 0xCA1), step)
        n = self.ex.calibration_budget(tag, self.calib_n, warm)
        xc = calibration_probes(k, n, w.shape[0], w.device)
        out = self.ex.calibrate(xc, w, tag, warm_start=warm)
        self._calib_used = self.ex._last_calib_n
        return out

    def _observe(self, tag: str, t: float, event: str, retrained: bool,
                 recalibrated: bool) -> None:
        """Fleet-health telemetry for one checkpoint: drift age and probe
        budget as gauges, every applied mitigation as an event counter."""
        OBS.gauge("lifetime_drift_age_seconds",
                  "drift age the fleet is currently deployed at",
                  tag=tag).set(t)
        OBS.gauge("lifetime_calib_probes",
                  "probe budget spent by the last calibration at this "
                  "checkpoint (0 = not recalibrated)",
                  tag=tag).set(self._calib_used)
        OBS.counter("lifetime_checkpoints_total",
                    "lifetime checkpoints walked", tag=tag).inc()
        events = [event]
        if event == "deploy" and self.remap:
            events.append("remap")
        if retrained:
            events.append("retrain")
        if recalibrated:
            events.append("recalibrate")
        for ev in events:
            OBS.counter("lifetime_events_total",
                        "mitigation events applied across the lifetime "
                        "walk (deploy/remap/retrain/recalibrate/"
                        "checkpoint)", tag=tag, event=ev).inc()

    def deploy(self, w, tag: str) -> Scenario:
        """Program the fleet (t = 0) and fit the initial calibration (cold,
        full budget); a ``retrain`` callback runs first -- field
        calibration of the emulator against the fresh hardware."""
        sc0 = scenario_at_age(self.scenario, 0.0)
        self.ex.deploy(scenario=sc0, key=self.key, remap=self.remap)
        retrained = self._retrain(sc0, 0.0, w, tag)
        self._calib_used = 0
        self._calibrate(w, tag, 0)
        self.history = [{"label": "t0", "t": 0.0, "retrained": retrained,
                         "conditioned": self.conditioned,
                         "calib_n": self._calib_used}]
        if OBS.enabled:
            self._observe(tag, 0.0, "deploy", retrained, True)
        return sc0

    def step(self, w, tag: str, label: str, t: float) -> Scenario:
        """Age the fleet to ``t`` seconds and apply the mitigations in the
        order retrain -> hot-swap -> recalibrate (the affine is fitted
        against the params that will serve); the fleet key and remap
        policy stay: the same devices, older."""
        aged = scenario_at_age(self.scenario, t)
        self.ex.deploy(scenario=aged, key=self.key)
        retrained = self._retrain(aged, t, w, tag)
        self._calib_used = 0
        if self.recalibrate:
            self._calibrate(w, tag, len(self.history))
        self.history.append({"label": label, "t": t, "retrained": retrained,
                             "conditioned": self.conditioned,
                             "calib_n": self._calib_used})
        if OBS.enabled:
            self._observe(tag, t, "checkpoint", retrained, self.recalibrate)
        return aged

    def run(self, w, tag: str, x) -> List[dict]:
        """Deploy, then walk every checkpoint; one record per checkpoint:
        ``{"label", "t", "retrained", "conditioned", "calib_n", "y"}``."""
        self.deploy(w, tag)
        records = [{**self.history[-1], "y": self.ex.matmul(x, w, tag)}]
        for label, t in self.timeline:
            self.step(w, tag, label, t)
            records.append({**self.history[-1],
                            "y": self.ex.matmul(x, w, tag)})
        return records
