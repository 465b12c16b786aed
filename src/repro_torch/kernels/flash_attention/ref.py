"""Plain-PyTorch oracle: exact (softmax-once) attention with causal and/or
sliding-window masking (port of the JAX package's
``kernels/flash_attention/ref.py``).  q/k/v: (B, H, S, D)."""
import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=0):
    B, H, S, D = q.shape
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (D ** -0.5)
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window:
        mask &= (qi - ki) < window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
