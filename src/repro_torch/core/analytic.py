"""The 'human-expert analytical model' baseline the paper criticises
(Section 3.1), the port of ``repro.core.analytic``: the crossbar as an
ideal linear MAC plus a hand-written clipping nonlinearity for the
peripheral -- no access-transistor curvature, no IR drop.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.circuit import CircuitParams, _c, ordered_sum


def analytic_block_response(x: torch.Tensor, cp: CircuitParams,
                            periph: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """x: (B, 2, D, H, W) as in ``circuit.block_response``.  Linear cell
    ``i = g * 0.55 * relu(v - v_th)``, then the same integrator transfer
    with a hard clip at ``v_sat``."""
    v = x[:, 0, :, :, 0]                              # (B, D, H)
    g = x[:, 1]                                       # (B, D, H, W)
    v_eff = torch.clamp_min(v - cp.v_th, 0.0)         # knows the threshold...
    i = g * (0.55 * v_eff)[..., None]                 # ...but not the curvature
    i_cols = ordered_sum(i, (1, 2)).reshape(x.shape[0], -1)
    i_pos = i_cols[..., 0::2]
    i_neg = i_cols[..., 1::2]
    q = (i_pos - i_neg) * _c(cp.t_int, i_pos) / _c(cp.c_int, i_pos)
    if periph is None:
        return torch.clamp(q, -cp.v_sat, cp.v_sat)
    return torch.clamp(periph[:, 0:1] * q, -cp.v_sat, cp.v_sat) + periph[:, 1:2]
