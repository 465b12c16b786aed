"""State-space mixers: the Mamba-1 selective scan and the RG-LRU (griffin)
recurrent block (port of ``repro.models.ssm``).  Both reduce to the same
diagonal gated linear recurrence

    h_t = a_t * h_{t-1} + b_t

which ``chunked_recurrence`` hands to the linear-scan entry point
(``kernels.linear_scan.ops``): a CUDA tensor launches the hand-written
kernel (B6) or raises, a CPU tensor takes its plain version.  In
training its gradient is one more launch of the same kernel on reversed
inputs (``ops._LinearScan``).  The
reference runs an associative scan within chunks of its ``scan_chunk``
steps; the kernel walks the whole sequence with a float32 carry, so the
two sum in another order and agree within a tolerance, not bit for bit.
The port has no chunk: its result does not depend on a tiling.

The mixer projections are plain einsums, as in the reference: they are
no ``dense()`` call site and never run analog.  A single-token decode
step stays elementwise and launches no kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.linear_scan import ops as scan_ops
from repro_torch.models.common import (P, ParamSchema, dense_schema,
                                       einsum, gelu, sigmoid, silu)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``, op for op:
    ``max(x, 0) + log1p(exp(-|x|))`` (``F.softplus`` returns ``x`` past
    its threshold of 20 instead)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


# --------------------------------------------------------------------------- #
# Shared recurrence
# --------------------------------------------------------------------------- #
def chunked_recurrence(a, b, h0):
    """h_t = a_t * h_{t-1} + b_t along axis 1.

    a, b: (B, S, ...); h0: (B, ...) or None (a zero state, whose fold the
    entry point then skips).  Returns (h (B,S,...), h_last (B,...)).  The
    trailing axes are flattened into the scan's lanes."""
    B, S = a.shape[:2]
    lanes = a.shape[2:]
    h0 = None if h0 is None else h0.reshape(B, -1)
    h, h_last = scan_ops.linear_scan(a.reshape(B, S, -1).contiguous(),
                                     b.reshape(B, S, -1).contiguous(), h0)
    return h.reshape((B, S) + lanes), h_last.reshape((B,) + lanes)


def _causal_conv(x, w, b, state: Optional[torch.Tensor]):
    """Depthwise causal conv along seq. x: (B,S,Di); w: (K,Di).
    state: (B, K-1, Di) trailing inputs from the previous segment (or None).
    Returns (y (B,S,Di), new_state (B,K-1,Di)).  The taps are summed in the
    reference's order, each product in x's dtype."""
    K = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], K - 1, x.shape[-1]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)              # (B, S+K-1, Di)
    y = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(K))
    new_state = xp[:, -(K - 1):]
    return y + b.to(x.dtype), new_state


# --------------------------------------------------------------------------- #
# Mamba-1 mixer
# --------------------------------------------------------------------------- #
def mamba_dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    di = cfg.d_model * cfg.ssm.expand
    return di, cfg.ssm.d_state, cfg.ssm.d_conv, cfg.ssm.resolved_dt_rank(cfg.d_model)


def mamba_schema(cfg: ArchConfig):
    d = cfg.d_model
    di, n, k, dtr = mamba_dims(cfg)
    return {
        "in_proj": dense_schema(d, 2 * di),
        "conv_w": ParamSchema((k, di), "normal", k ** -0.5,
                              spec=P(None, "model")),
        "conv_b": ParamSchema((di,), "zeros", spec=P("model")),
        "x_proj": ParamSchema((di, dtr + 2 * n), "normal", di ** -0.5,
                              spec=P("model", None)),
        "dt_proj": ParamSchema((dtr, di), "normal", dtr ** -0.5,
                               spec=P(None, "model")),
        "dt_bias": ParamSchema((di,), "ones", spec=P("model")),
        "A_log": ParamSchema((di, n), "ones", spec=P("model", None)),
        "D": ParamSchema((di,), "ones", spec=P("model")),
        "out_proj": dense_schema(di, d, fsdp="model", tp="data"),
    }


def mamba_mixer(params, x, *, cfg: ArchConfig, pcfg, cache=None,
                mode: str = "train"):
    """x: (B,S,D). cache: {"conv": (B,K-1,Di), "h": (B,Di,N)} for decode.
    Returns (y (B,S,D), new_cache_or_None)."""
    _, N, _, dtr = mamba_dims(cfg)
    S = x.shape[1]
    f32 = torch.float32
    xz = einsum("bsd,de->bse", x, params["in_proj"].to(x.dtype))
    xin, z = torch.chunk(xz, 2, dim=-1)

    conv_state = cache["conv"] if cache is not None else None
    xc, new_conv = _causal_conv(xin, params["conv_w"], params["conv_b"],
                                conv_state)
    xc = silu(xc)

    dbc = einsum("bse,ef->bsf", xc, params["x_proj"].to(xc.dtype))
    dt, Bm, Cm = torch.split(dbc, [dtr, N, N], dim=-1)
    dt = einsum("bsr,re->bse", dt, params["dt_proj"].to(dt.dtype))
    dt = softplus(dt.to(f32) + params["dt_bias"].to(f32))
    A = -torch.exp(params["A_log"].to(f32))                      # (Di, N)

    a = torch.exp(dt[..., None] * A)                             # (B,S,Di,N) fp32
    b = (dt * xc.to(f32))[..., None] * Bm.to(f32)[:, :, None, :]

    h0 = cache["h"].to(f32) if cache is not None else None
    if mode == "decode" and S == 1:
        h = b[:, 0] if h0 is None else a[:, 0] * h0 + b[:, 0]    # (B,Di,N)
        y = (h * Cm.to(f32)[:, 0, None, :]).sum(-1)[:, None]
        h_last = h
    else:
        hs, h_last = chunked_recurrence(a, b, h0)
        y = (hs * Cm.to(f32)[:, :, None, :]).sum(-1)             # (B,S,Di)
    y = y + params["D"].to(f32) * xc.to(f32)
    y = y.to(x.dtype) * silu(z)
    out = einsum("bse,ed->bsd", y, params["out_proj"].to(y.dtype))

    new_cache = None
    if mode in ("prefill", "decode"):
        conv_dt = cache["conv"].dtype if cache is not None else new_conv.dtype
        new_cache = {"conv": new_conv.to(conv_dt), "h": h_last.to(f32)}
    return out, new_cache


def mamba_cache_schema(cfg: ArchConfig, batch: int, dtype=torch.bfloat16):
    di, N, K, _ = mamba_dims(cfg)
    return {"conv": ((batch, K - 1, di), dtype,
                     P(("pod", "data"), None, "model")),
            "h": ((batch, di, N), torch.float32, P(("pod", "data"), "model"))}


# --------------------------------------------------------------------------- #
# RG-LRU (griffin) recurrent block
# --------------------------------------------------------------------------- #
_RGLRU_C = 8.0


def rglru_schema(cfg: ArchConfig):
    d = cfg.d_model
    w = cfg.rglru.lru_width or d
    k = cfg.rglru.d_conv
    return {
        "in_x": dense_schema(d, w),
        "in_gate": dense_schema(d, w),
        "conv_w": ParamSchema((k, w), "normal", k ** -0.5,
                              spec=P(None, "model")),
        "conv_b": ParamSchema((w,), "zeros", spec=P("model")),
        "w_i": dense_schema(w, w),
        "b_i": ParamSchema((w,), "zeros", spec=P("model")),
        "w_r": dense_schema(w, w),
        "b_r": ParamSchema((w,), "zeros", spec=P("model")),
        "lam": ParamSchema((w,), "ones", spec=P("model")),
        "out": dense_schema(w, d, fsdp="model", tp="data"),
    }


def rglru_mixer(params, x, *, cfg: ArchConfig, pcfg, cache=None,
                mode: str = "train"):
    """Griffin recurrent block. cache: {"conv": (B,K-1,W), "h": (B,W)}."""
    S = x.shape[1]
    f32 = torch.float32
    xb = einsum("bsd,dw->bsw", x, params["in_x"].to(x.dtype))
    gate = einsum("bsd,dw->bsw", x, params["in_gate"].to(x.dtype))

    conv_state = cache["conv"] if cache is not None else None
    xc, new_conv = _causal_conv(xb, params["conv_w"], params["conv_b"],
                                conv_state)

    i_t = sigmoid(einsum("bsw,wv->bsv", xc, params["w_i"].to(xc.dtype))
                        + params["b_i"].to(xc.dtype))
    r_t = sigmoid(einsum("bsw,wv->bsv", xc, params["w_r"].to(xc.dtype))
                        + params["b_r"].to(xc.dtype))
    log_a = -_RGLRU_C * softplus(params["lam"].to(f32)) * r_t.to(f32)
    a = torch.exp(log_a)                                         # (B,S,W) fp32
    gated_x = (i_t * xc).to(f32)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * gated_x

    h0 = cache["h"].to(f32) if cache is not None else None
    if mode == "decode" and S == 1:
        h_last = b[:, 0] if h0 is None else a[:, 0] * h0 + b[:, 0]
        hs = h_last[:, None]
    else:
        hs, h_last = chunked_recurrence(a, b, h0)

    y = hs.to(x.dtype) * gelu(gate)
    out = einsum("bsw,wd->bsd", y, params["out"].to(y.dtype))

    new_cache = None
    if mode in ("prefill", "decode"):
        conv_dt = cache["conv"].dtype if cache is not None else new_conv.dtype
        new_cache = {"conv": new_conv.to(conv_dt), "h": h_last.to(f32)}
    return out, new_cache


def rglru_cache_schema(cfg: ArchConfig, batch: int, dtype=torch.bfloat16):
    w = cfg.rglru.lru_width or cfg.d_model
    k = cfg.rglru.d_conv
    return {"conv": ((batch, k - 1, w), dtype,
                     P(("pod", "data"), None, "model")),
            "h": ((batch, w), torch.float32, P(("pod", "data"), "model"))}
