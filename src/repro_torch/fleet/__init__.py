"""repro_torch.fleet -- the fleet digital twin and predictive maintenance
(port of ``repro.fleet``).

A deployed crossbar product is a fleet of fabricated instances of the
same weights, each with its own programming draw, stuck cells, read noise
and drift rate:

  * ``population`` -- ``FleetSpec`` / ``Fleet``: N devices derived from
    per-device keys, evaluated in chunks of a fixed size through the
    executor's many-states forward (B1 runs a whole chunk in one launch);
    memory is bounded by the chunk, and results are bit-for-bit the same
    across chunk sizes and processes.
  * ``forecast`` -- exact per-device trajectories, and a quantile
    surrogate fitted on a probed subsample that ranks every device.
  * ``maintenance`` -- ``MaintenancePlanner``: per-device action
    timelines (recalibrate / field-retrain / retire, plus the fleet-level
    wear-aware remap decision) from an exact DP over a cost model;
    ``simulate_policy`` replays any action table through the fleet.
"""
from repro_torch.fleet.forecast import SurrogateRanker, forecast_fleet
from repro_torch.fleet.maintenance import (A_NONE, A_RECAL, A_RETIRE,
                                           A_RETRAIN, ACTION_NAMES,
                                           ActionCosts, FleetPlan,
                                           MaintenancePlanner,
                                           always_recalibrate_policy,
                                           never_policy, simulate_policy)
from repro_torch.fleet.population import Fleet, FleetSpec

__all__ = [
    "ACTION_NAMES", "A_NONE", "A_RECAL", "A_RETIRE", "A_RETRAIN",
    "ActionCosts", "Fleet", "FleetPlan", "FleetSpec",
    "MaintenancePlanner", "SurrogateRanker", "always_recalibrate_policy",
    "forecast_fleet", "never_policy", "simulate_policy",
]
