"""The paper's two computing-block geometries (Table 1 / Table 2).

RRAM (1T1R cells) + PS32 peripheral:
  case A: input (C,D,H,W) = (2, 4, 64, 2) -> 1 output voltage
  case B: input (C,D,H,W) = (2, 2, 64, 8) -> 4 output voltages
50k samples each (Table 1), MAE ~= 1 mV against the circuit solver.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class BlockGeometry:
    """Geometry of one analog computing block (the emulator's input tensor)."""
    name: str
    features: int          # C: per-cell features (V applied, G programmed)
    tiles: int             # D: crossbar tiles accumulated into this block
    rows: int              # H: wordlines per tile
    cols: int              # W: bitlines per tile (2 per output: diff pair)
    outputs: int           # O: MAC output voltages

    @property
    def chw(self) -> Tuple[int, int, int, int]:
        return (self.features, self.tiles, self.rows, self.cols)


@dataclass(frozen=True)
class EmulatorTrainConfig:
    n_train: int = 50_000
    n_test: int = 5_000
    batch_size: int = 256
    epochs: int = 2000
    lr: float = 1e-3
    lr_halve_at: Tuple[int, ...] = (1000, 1500, 1800)   # paper Fig. 4
    sig_bit: int = 3                                    # Thm 4.1 "s"
    prob: float = 0.3                                   # Thm 4.1 "p"
    seed: int = 0


CASE_A = BlockGeometry("rram_ps32_a", features=2, tiles=4, rows=64, cols=2, outputs=1)
CASE_B = BlockGeometry("rram_ps32_b", features=2, tiles=2, rows=64, cols=8, outputs=4)

BLOCKS = {b.name: b for b in (CASE_A, CASE_B)}
