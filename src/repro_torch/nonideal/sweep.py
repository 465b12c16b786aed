"""Multi-draw scenario sweeps (port of ``repro.nonideal.sweep``).

``ScenarioSweep`` evaluates one analog matmul under N independent device
draws of a scenario: each draw perturbs the tag's cached ideal plan with
its own key, and all N states run as one forward
(``AnalogExecutor.raw_matmul_many``: one B1 launch on the emulator's fast
path).  A whole accuracy-vs-sigma curve reuses one built step: the
reference compiles its vmapped forward once per leaf layout (scalar or
per-tile) and counts the traces; the port builds one step per layout and
counts the builds (``builds``, ``cache_size()``), which
``obs.RecompileSentinel(fns=(sweep,))`` watches.  A draw's result does not
depend on the others it runs beside, so a sweep of one draw at a time
gives the same bits (``run`` takes the draw keys).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import prng
from repro_torch.nonideal.perturb import (apply_read_noise, perturb_draws,
                                          perturb_conductance,
                                          read_noise_draw)
from repro_torch.nonideal.scenario import Scenario, scenario_features


class ScenarioSweep:
    """N-device-draw scenario evaluation of ``ex.matmul(x, w, tag)``.

    The executor's own deployment is bypassed: each draw perturbs the
    cached base conductance plan directly.  Static circuit parameters
    cannot vary per draw, so swept scenarios keep ``r_line_scale == 1.0``
    (enforced).  The tag's calibration (``ex.calibration[tag]``) is
    applied, so outputs are in logical units."""

    def __init__(self, ex, w: torch.Tensor, tag: str, n_draws: int = 8):
        self.ex = ex
        self.w = w.float()
        self.tag = tag
        self.n_draws = n_draws
        self.builds = 0
        self._steps: dict = {}

    def cache_size(self) -> int:
        """Built steps behind the sweep (one per scenario leaf layout; a
        whole curve holds it at 1)."""
        return len(self._steps)

    def _step(self, tiled: bool) -> dict:
        """The sweep's step for one leaf layout: the tag's ideal plan and
        the emulator params, resolved once."""
        st = self._steps.get(tiled)
        if st is None:
            ex = self.ex
            self.builds += 1
            st = {"plan": ex._whole(ex._plan_for(self.w, self.tag), self.w),
                  "ep": (ex.emulator_params
                         if ex.acfg.backend == "emulator" else None),
                  "conditioned": getattr(ex, "emulator_conditioned", False)}
            self._steps[tiled] = st
        return st

    def _draws(self, i: int, key, shape, device):
        """Draw ``i``'s device and read draws ``(eps, u, read eps)`` from
        its key: ``kd, kr = split(key)`` (the reference's derivation)."""
        kd, kr = prng.split(prng.as_key(key))
        eps, u = perturb_draws(shape, kd, device)
        return eps, u, read_noise_draw(shape, kr, device)

    def __call__(self, x: torch.Tensor, scenario: Scenario,
                 key=None) -> torch.Tensor:
        """x: (B, K) -> (n_draws, B, N) calibrated outputs, one device draw
        per row.  Fixing ``key`` across calls gives common random numbers
        over scenario parameters (monotone curves)."""
        keys = prng.split(prng.as_key(0 if key is None else key),
                          self.n_draws)
        return self.run(x, scenario, keys)

    @torch.no_grad()
    def run(self, x: torch.Tensor, scenario: Scenario,
            keys: Sequence) -> torch.Tensor:
        """The sweep over explicit draw keys: (len(keys), B, N)."""
        if scenario.r_line_scale != 1.0:
            raise ValueError(
                "ScenarioSweep sweeps the scenario's per-device fields only; "
                "r_line_scale rewrites CircuitParams for every draw at once "
                "-- use AnalogExecutor.deploy(scenario=...) for line-"
                "resistance corners")
        ex, w, tag = self.ex, self.w, self.tag
        st = self._step(scenario.tile_shape is not None)
        plan = st["plan"]
        g = plan.g_feat.float()
        reads = []
        for i, k in enumerate(keys):
            eps, u, er = self._draws(i, k, g.shape, g.device)
            gf = perturb_conductance(g, ex.acfg, scenario, eps, u)
            reads.append(apply_read_noise(gf, ex.acfg, scenario.read_sigma,
                                          er))
        sfeat = None
        if st["conditioned"]:
            sfeat = scenario_features(scenario).to(g.device)
        x2 = x.reshape(-1, x.shape[-1]).float()
        yv, xs = ex.raw_matmul_many(x2, w, tag, torch.stack(reads),
                                    eparams=st["ep"], sfeat=sfeat)
        a, b = (torch.tensor(float(v), device=g.device)
                for v in ex.calibration.get(tag, (1.0, 0.0)))
        return (a * yv + b) * xs
