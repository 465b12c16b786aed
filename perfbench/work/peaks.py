"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit; a card set below it runs slower,
so every result carries the card's name and power limit beside it).

Every share of a peak in this benchmark takes ``FLOP_S`` as its rate of
operations: no arithmetic that meets an fp32 cell's limits runs faster
than the dense bf16 tensor-core rate, so a kernel redesigned onto the
tensor cores can never read above 100% of it (fp32 outside the tensor
cores peaks at 67 TFLOP/s).
"""

FLOP_S = 989e12          # dense bf16 / fp16 on the tensor cores
HBM_BYTES_S = 3.35e12    # HBM3


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take for ``flops`` operations that
    move ``nbytes``: the larger of the two times."""
    return max(nbytes / HBM_BYTES_S, flops / FLOP_S)
