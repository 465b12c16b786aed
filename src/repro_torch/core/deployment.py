"""DeploymentState: everything one analog matmul needs about the deployed
device, as one immutable bundle of tensors (port of
``repro.core.deployment.DeploymentState``).

This slice serves the ideal corner only.  The reference's read-noise
sigma and key leaves come with the non-ideal slice (ROADMAP A8), and so
does the deployment npz round trip.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

# width of the scenario-feature encoding a conditioned emulator consumes
# (the reference's ``len(nonideal.scenario.SCENARIO_FEATURE_NAMES)``)
N_SCENARIO_FEATURES = 13


@dataclass(frozen=True)
class DeploymentState:
    """Per-site deployed-device state.

      gf          -- (NB, NO, D, H, W) raw conductances, float32
      out_perm    -- (N,) int64 logical->physical output gather
      eparams     -- emulator params (``{}`` for the digital backend)
      sfeat       -- (N_SCENARIO_FEATURES,) scenario encoding (zeros = ideal)
      cal_a/cal_b -- the volts->logical calibration affine

    ``ideal()`` leaves sit at their exact-identity values.
    """
    gf: torch.Tensor
    out_perm: torch.Tensor
    eparams: Dict[str, torch.Tensor]
    sfeat: torch.Tensor
    cal_a: torch.Tensor
    cal_b: torch.Tensor

    @classmethod
    def ideal(cls, plan, eparams: Optional[dict] = None,
              calibration: Tuple[float, float] = (1.0, 0.0),
              n_features: int = N_SCENARIO_FEATURES) -> "DeploymentState":
        dev = plan.g_feat.device
        f32 = dict(dtype=torch.float32, device=dev)
        return cls(
            # float32 whatever the weights' dtype, as in the reference
            gf=plan.g_feat.float(),
            out_perm=torch.arange(plan.N, device=dev),
            # the same dict, not a copy: the executor caches the emulator
            # weights' repack by the params' identity
            eparams=eparams if eparams else {},
            sfeat=torch.zeros((n_features,), **f32),
            cal_a=torch.tensor(float(calibration[0]), **f32),
            cal_b=torch.tensor(float(calibration[1]), **f32))

    def replace(self, **kw) -> "DeploymentState":
        return dataclasses.replace(self, **kw)

    def with_calibration(self, a, b) -> "DeploymentState":
        dev = self.gf.device
        return dataclasses.replace(
            self, cal_a=torch.as_tensor(a, dtype=torch.float32, device=dev),
            cal_b=torch.as_tensor(b, dtype=torch.float32, device=dev))
