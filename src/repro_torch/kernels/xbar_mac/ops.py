"""Public entry point of the crossbar-MAC kernel (port of the JAX
package's ``kernels/xbar_mac/ops.py``).

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain version; any other device raises."""
from __future__ import annotations

import torch

from repro_torch.kernels._build import on_cuda
from repro_torch.kernels.xbar_mac.xbar_mac import xbar_mac_cuda, xbar_mac_plain


def xbar_mac(v: torch.Tensor, g: torch.Tensor, *, v_th: float = 0.08,
             beta: float = 0.6, gain: float = 3200.0, v_sat: float = 1.0,
             block_b: int = 128, block_n: int = 128,
             block_k: int = 128) -> torch.Tensor:
    """``v_sat * tanh(gain * (relu(v - v_th) * (1 + beta*v)) @ g / v_sat)``.
    v: (B, K) wordline voltages; g: (K, N) conductances -> (B, N) in v's
    dtype, any B, K, N.

    ``block_b``/``block_n``/``block_k`` are the TPU kernel's tile sizes,
    accepted for the reference's signature.  Neither version reads them:
    the CUDA kernel's tile is fixed (64 x 64 outputs, K in steps of 32, the
    ragged edges masked), and the result does not depend on the tile up to
    float32 summation order."""
    if on_cuda(v, "xbar_mac"):
        return xbar_mac_cuda(v, g, v_th=v_th, beta=beta, gain=gain, v_sat=v_sat)
    return xbar_mac_plain(v, g, v_th=v_th, beta=beta, gain=gain, v_sat=v_sat)
