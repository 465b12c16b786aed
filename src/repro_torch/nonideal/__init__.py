"""repro_torch.nonideal -- the device non-ideality subsystem (port of
``repro.nonideal``).

Composable crossbar device corners (programming variation, read noise,
stuck cells, retention drift, line resistance, quantized levels) applied
at the conductance-plan level, so one implementation serves the circuit,
analytic and emulator backends.  Scenarios are scalar (one corner for the
whole plan) or ``(NB, NO)``-tile-indexed (``tile_scenarios``);
``remap_plan`` adds stuck-fault-aware column remapping;
``scenario_features`` encodes a corner for the conditioned emulator that
``train_conditioned_emulator`` trains over the whole corner manifold;
``lifetime`` schedules remapping, recalibration and retraining across a
drift timeline (``finetune_emulator`` adapts a serving net), and
``ScenarioSweep`` evaluates N device draws of a corner in one forward.
"""
from repro_torch.nonideal.data import (ScenarioSpace, finetune_emulator,
                                       generate_dataset_conditioned,
                                       generate_dataset_nonideal,
                                       sample_scenarios,
                                       train_conditioned_emulator,
                                       train_noise_aware_emulator)
from repro_torch.nonideal.lifetime import (DEFAULT_TIMELINE,
                                           LifetimeScheduler,
                                           make_conditioned_field_calibrator,
                                           make_field_retrainer,
                                           make_noise_aware_retrainer,
                                           scenario_at_age)
from repro_torch.nonideal.perturb import (apply_read_noise, drift_factor,
                                          drift_factor_at_age, fault_draw,
                                          perturb_conductance, perturb_draws,
                                          perturb_plan, quantize_levels,
                                          read_noise_draw,
                                          realized_fault_masks, remap_plan,
                                          sample_fault_masks,
                                          scenario_circuit_params)
from repro_torch.nonideal.scenario import (BUILTIN_SCENARIOS,
                                           N_SCENARIO_FEATURES,
                                           SCENARIO_FEATURE_NAMES, Scenario,
                                           collapse_tiles, get_scenario,
                                           list_scenarios, register_scenario,
                                           scenario_features,
                                           scenario_features_tiled,
                                           scenario_from_json,
                                           scenario_to_json, tile_scenarios)
from repro_torch.nonideal.sweep import ScenarioSweep

__all__ = [
    "BUILTIN_SCENARIOS", "DEFAULT_TIMELINE", "LifetimeScheduler",
    "N_SCENARIO_FEATURES", "SCENARIO_FEATURE_NAMES", "Scenario",
    "ScenarioSpace", "ScenarioSweep", "apply_read_noise", "collapse_tiles",
    "drift_factor", "drift_factor_at_age", "fault_draw",
    "finetune_emulator", "generate_dataset_conditioned",
    "generate_dataset_nonideal", "get_scenario", "list_scenarios",
    "make_conditioned_field_calibrator", "make_field_retrainer",
    "make_noise_aware_retrainer",
    "perturb_conductance", "perturb_draws", "perturb_plan",
    "quantize_levels", "read_noise_draw", "realized_fault_masks",
    "register_scenario", "remap_plan", "sample_fault_masks",
    "sample_scenarios", "scenario_at_age", "scenario_circuit_params",
    "scenario_features", "scenario_features_tiled", "scenario_from_json",
    "scenario_to_json", "tile_scenarios", "train_conditioned_emulator",
    "train_noise_aware_emulator",
]
