"""SPICE stand-in: a batched Newton-Raphson solver for 1T1R crossbar tiles
with a PS32-style saturating integrator peripheral (the port of
``repro.core.circuit``).

It labels the emulator's training data and is the ``circuit`` backend of
``AnalogExecutor``.

Cell model (series 1T1R): a square-law access transistor (threshold
``v_th``, transconductance ``k_t``, channel-length modulation ``lam``)
gated by the wordline voltage, in series with a memristor of conductance
``g`` and quadratic nonlinearity ``beta``; the internal node is solved by
12 clipped NR steps, all cells at once.  The bitline's finite input
resistance ``r_bl`` feeds back as IR drop (3 fixed-point passes).  The
PS32 peripheral integrates the differential current over ``t_int`` onto
``c_int`` and saturates through ``tanh`` at ``v_sat``.

Every expression keeps the reference's operand order, and constants are
tensors of the operand's dtype and device (``_c``): on a CUDA tensor a
division by a Python scalar runs as a multiplication by its reciprocal,
which the reference never does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch


@dataclass(frozen=True)
class CircuitParams:
    v_th: float = 0.08            # transistor threshold (V) -- Fig.5 V_const
    k_t: float = 2.2e-3           # transconductance (A/V^2)
    lam: float = 0.05             # channel-length modulation (1/V)
    beta: float = 0.6             # memristor quadratic nonlinearity (1/V)
    r_bl: float = 400.0           # bitline/integrator input resistance (ohm)
    t_int: float = 3.2e-6         # integration time (s)  (32 pulses x 100ns)
    c_int: float = 1.0e-9         # integration cap (F)
    v_sat: float = 1.0            # op-amp saturation (V)
    nr_iters: int = 12
    ir_iters: int = 3


V_RAIL = 0.2                      # memristor top-electrode read rail (V)


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant as a 0-dim tensor of ``like``'s dtype and device
    (the reference's weak-typed scalar, cast to the array dtype)."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def ordered_sum(x: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    """Sum over the adjacent ``dims`` in the order the reference's float32
    reduction takes on its CPU backend: the last reduced axis, zero-padded
    evenly on both ends to a multiple of 32, is cut into chunks of 32;
    each chunk, with the other reduced axes, is summed sequentially
    (outer axes first); then the chunk sums are added in order.  The
    block outputs take the difference of two column currents times
    ``t_int / c_int`` = 3200, so the last ulp of a column sum shows in the
    volts; ``torch.sum`` associates differently."""
    dims = tuple(sorted(d % x.dim() for d in dims))
    if dims != tuple(range(dims[0], dims[-1] + 1)):
        raise ValueError(f"ordered_sum needs adjacent dims, got {dims}")
    lead, post = x.shape[:dims[0]], x.shape[dims[-1] + 1:]
    hn = x.shape[dims[-1]]
    nch = -(-hn // 32)
    xr = x.reshape(lead.numel(), -1, hn, post.numel())
    if nch > 1 and hn % 32:
        pad = 32 * nch - hn
        xr = torch.nn.functional.pad(xr, (0, 0, pad // 2, pad - pad // 2))
    xr = xr.reshape(xr.shape[0], xr.shape[1], nch, -1, xr.shape[-1])
    acc = None
    for r in range(xr.shape[1]):
        for h in range(xr.shape[3]):
            t = xr[:, r, :, h]
            acc = t if acc is None else acc + t
    out = acc[:, 0]
    for c in range(1, nch):
        out = out + acc[:, c]
    return out.reshape(lead + post)


def transistor_current(v_gs: torch.Tensor, v_ds: torch.Tensor,
                       cp: CircuitParams) -> torch.Tensor:
    """Square-law NMOS, smooth blend triode/saturation, cut off below V_th."""
    vov = torch.clamp_min(v_gs - cp.v_th, 0.0)
    v_ds = torch.clamp_min(v_ds, 0.0)
    vd_eff = torch.minimum(v_ds, vov)
    return cp.k_t * (vov * vd_eff - 0.5 * vd_eff * vd_eff) * (1.0 + cp.lam * v_ds)


def _transistor_gds(v_gs, v_ds, cp: CircuitParams):
    """d i_t / d v_ds (for NR)."""
    vov = torch.clamp_min(v_gs - cp.v_th, 0.0)
    v_ds = torch.clamp_min(v_ds, 0.0)
    triode = v_ds < vov
    g_tri = cp.k_t * (vov - v_ds) * (1.0 + cp.lam * v_ds) \
        + cp.k_t * (vov * v_ds - 0.5 * (v_ds * v_ds)) * cp.lam
    g_sat = cp.k_t * 0.5 * (vov * vov) * cp.lam
    return torch.where(triode, g_tri, g_sat) + 1e-9


def memristor_current(g: torch.Tensor, v_m: torch.Tensor, cp: CircuitParams):
    return g * v_m * (1.0 + cp.beta * v_m)


def _memristor_gm(g, v_m, cp: CircuitParams):
    return g * (1.0 + 2.0 * cp.beta * v_m) + 1e-12


def cell_current(v_wl: torch.Tensor, g: torch.Tensor, v_bl: torch.Tensor,
                 cp: CircuitParams) -> torch.Tensor:
    """Series 1T1R cell current via NR on the internal node v_x.

    v_wl: gate voltage; g: memristor conductance; v_bl: bitline voltage
    (IR drop); all broadcastable.  The memristor runs from the read rail
    to v_x, the transistor from v_x to the bitline."""
    v_lo = v_bl
    v_rail = _c(V_RAIL, g)
    shape = torch.broadcast_shapes(v_wl.shape, g.shape, v_lo.shape)
    v_x = (0.5 * (v_rail + v_lo)).expand(shape).float()
    v_gs = v_wl - v_lo
    for _ in range(cp.nr_iters):
        i_m = memristor_current(g, v_rail - v_x, cp)
        i_t = transistor_current(v_gs, v_x - v_lo, cp)
        f = i_m - i_t                                  # KCL at v_x
        df = -_memristor_gm(g, v_rail - v_x, cp) - _transistor_gds(
            v_gs, v_x - v_lo, cp)
        step = f / df
        v_new = v_x - torch.clamp(step, -0.1, 0.1)
        v_x = torch.minimum(torch.maximum(v_new, v_lo), v_rail)
    return transistor_current(v_gs, v_x - v_lo, cp)


def solve_tile_currents(v: torch.Tensor, g: torch.Tensor,
                        cp: CircuitParams) -> torch.Tensor:
    """Column currents with the bitline IR-drop fixed point.

    v: (..., H) wordline voltages; g: (..., H, W) conductances.
    Returns (..., W) column currents."""
    vv = v[..., :, None]
    i_col = ordered_sum(cell_current(vv, g, torch.zeros_like(g[..., :1, :]), cp),
                        (-2,))
    for _ in range(cp.ir_iters):
        v_bl = cp.r_bl * i_col[..., None, :]          # (..., 1, W)
        i_col = ordered_sum(cell_current(vv, g, v_bl, cp), (-2,))
    return i_col


def ps32_output(i_pos: torch.Tensor, i_neg: torch.Tensor, cp: CircuitParams,
                gain: Union[torch.Tensor, float] = 1.0,
                offset: Union[torch.Tensor, float] = 0.0) -> torch.Tensor:
    """Differential integrate + saturate: the computing block's output
    voltage.  gain/offset are the peripheral features (per block)."""
    q = (i_pos - i_neg) * _c(cp.t_int, i_pos) / _c(cp.c_int, i_pos)
    return cp.v_sat * torch.tanh(gain * q / _c(cp.v_sat, q)) + offset


def block_response(x: torch.Tensor, cp: CircuitParams,
                   periph: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full computing-block response for emulator input tensors.

    x: (B, 2, D, H, W) with channel 0 = wordline voltage, channel 1 =
    conductance, W = 2*n_out interleaved (G+, G-).
    periph: (B, 2) [gain, offset] or None.  Returns (B, n_out) volts."""
    v = x[:, 0, :, :, 0]                              # (B, D, H) -- same V per col
    g = x[:, 1]                                       # (B, D, H, W)
    i_cols = solve_tile_currents(v, g, cp)            # (B, D, W)
    i_cols = ordered_sum(i_cols, (1,))               # analog tile accumulation
    i_pos = i_cols[..., 0::2]
    i_neg = i_cols[..., 1::2]
    if periph is None:
        return ps32_output(i_pos, i_neg, cp)
    return ps32_output(i_pos, i_neg, cp, periph[:, 0:1], periph[:, 1:2])
