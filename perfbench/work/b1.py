"""The operations and bytes of one call of the unified emulator-block
evaluator (B1): every (row, block) pair of an analog projection through
the Conv4Xbar network, both voltage rails.

``unified_work`` is a frozen copy of the count the port's B1 kernel was
designed and timed against (``chip_smoke.py``'s ``unified_work``, fp32
mode).  It is kept here, unchanged, so that a later change to the
program cannot change the yardstick.  Callers pass ``M`` as the rows of
live requests only: the rows a tick pads with dead slots are no work a
user asked for.
"""
from __future__ import annotations

from typing import Tuple

# Conv4Xbar on the paper's case-A block (C, D, H, W) = (2, 4, 64, 2): the
# stage-1 window's row groups, its taps, stage 0's and stage 1's widths
G, K1, C0, O1 = 32, 2, 16, 8
ROWS_A_BLOCK = 4 * 64          # D tiles of H wordlines: a block's K rows


def unified_work(M: int, NB: int, NO: int, D: int = 4, W: int = 2,
                 O: int = 1, flat: int = 128, shift: int = 0
                 ) -> Tuple[int, int, int]:
    """(bytes, GEMM operations, other operations) the unified block
    evaluator must move and do for one call on ``M`` rows of an (NB, NO)
    lattice: every input read once, the output written once; an FMA
    counts 2, an expm1 (inside CELU) 1, a bias starts its accumulator.
    The per-plan precompute (g0's multiply and add, celu0's expm1, the
    y0 product and bias) is counted once per block and call.  ``shift``
    is the element count of a conditioned net's fc0 shift (0 at the
    ideal corner)."""
    nblk = NB * NO
    P = D * W * G
    n_in = 2 * M * NB * D * G * K1                       # u, pos
    n_pre = nblk * P * K1 + 2 * C0 + O1                  # g_norm, w0g, b0, b1
    n_w = (C0 + K1 * C0 * O1 + 32 * 4 + 4 + 32 * 32 + 32 + 64 * 32 + 32
           + flat * 32 + 32 + 32 * 16 + 16 + 16 * O + O)
    n_out = 2 * M * nblk * O
    nbytes = 4 * (n_in + n_pre + n_w + shift + n_out)
    taps = P * K1
    wo = 1 if W <= 2 else W // 2
    gemm = taps * 2 * C0 * O1 + 2 * (
        (P // 4) * 2 * 32 * 4 + (P // 32) * 2 * 32 * 32 + D * wo * 2 * 64 * 32
        + 2 * flat * 32 + 2 * 32 * 16 + 2 * 16 * O)
    other = taps * (4 * C0 + 3 * O1) + P * 5 * O1 + 2 * (
        (P // 4) * 4 + (P // 32) * 32 + D * wo * 32 + 32
        + (32 if shift else 0) + 16)
    gemm_fold = nblk * P * K1 * C0 * O1 * 2
    other_fold = nblk * (taps * C0 * 3 + P * O1)
    return (nbytes, M * nblk * gemm + gemm_fold,
            M * nblk * other + other_fold)


def lattice(K: int, N: int) -> Tuple[int, int]:
    """(NB, NO) of a (K, N) weight on case-A blocks (one output a block)."""
    return -(-K // ROWS_A_BLOCK), N


def call_work(M: int, sites) -> Tuple[int, int]:
    """(bytes, operations) of one forward's B1 calls, one call a site, on
    ``M`` live rows; ``sites`` is an iterable of (K, N) weight shapes."""
    nbytes = flops = 0
    for K, N in sites:
        b, g, o = unified_work(M, *lattice(K, N))
        nbytes += b
        flops += g + o
    return nbytes, flops
