"""Fleet aging (port of the part of ``repro.nonideal.lifetime`` that
``deploy(age=...)`` and ``serve --age`` need): the canonical drift
checkpoints and ``scenario_at_age``.  A fleet ages under a fixed device
key -- the same programming draw and stuck cells, only older.  The
drift-scheduled recalibration / retraining walk (``LifetimeScheduler``
and its retrainers) is not ported yet."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.nonideal.scenario import Scenario

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
