"""Public entry point of the flash-attention kernel (port of the JAX
package's ``kernels/flash_attention/ops.py``).

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain version; any other device raises."""
from __future__ import annotations

import torch

from repro_torch.kernels._build import on_cuda
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda, flash_attention_plain)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, block_q: int = 128,
                    block_kv: int = 128) -> torch.Tensor:
    """Causal and/or sliding-window attention.  q/k/v: (B, H, S, D), any S;
    -> (B, H, S, D) in v's dtype, scaled by D**-0.5.

    (B, H) is flattened into one axis.  The reference wrapper's pad of D
    to 128 lanes is a TPU layout matter and is not ported.  ``block_kv``
    is the online softmax's step on the CPU (the plain version), as in
    the reference kernel; the CUDA kernel steps over 32 keys at a time,
    64 query rows per thread block (16 per warp), whatever
    ``block_q``/``block_kv`` say, and runs both products on the tensor
    cores (bf16 ``mma.sync`` for bf16, 3xTF32 for float32, fp32
    accumulation), which moves the result only by float32 rounding (and,
    in bf16, by where p is rounded)."""
    B, H, S, D = q.shape
    flat = [t.reshape(B * H, S, D) for t in (q, k, v)]
    if on_cuda(q, "flash_attention"):
        out = flash_attention_cuda(*flat, causal=causal, window=window)
    else:
        out = flash_attention_plain(*flat, causal=causal, window=window,
                                    block_kv=block_kv)
    return out.reshape(B, H, S, D)
