"""Circuit constants the serving path reads.

Only the transistor threshold is needed here: the gate-overdrive drive
map (``AnalogExecutor._drive01``) clears it.  The Newton-Raphson circuit
solver itself is not ported yet (ROADMAP A7)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CircuitParams:
    v_th: float = 0.08            # transistor threshold (V) -- Fig.5 V_const
