"""Analog projections, plainly: crossbar mapping + the Conv4Xbar network
on every (row, block) pair of both rails, in float32.

The network is written from its definition (Fig. 3 / Table 2 of the
paper, case A): on a block's (C, D, H, W) = (2, 4, 64, 2) input of
normalized wordline drive and normalized conductance,

  stage 0   1x1x1 conv 2 -> 16, CELU
  stage 1   (1,2,1) conv, stride 2 along H, 16 -> 8, CELU
  stage 2   (1,4,1) conv, stride 4, 8 -> 4, CELU
  stage 3   (1,8,1) conv, stride 8, 4 -> 32, CELU
  stage 4   (1,1,2) conv across the differential pair, 32 -> 32, CELU
  head      flatten (C, D, H, W) + the peripheral drive (1, 0), then
            FC 130 -> 32, CELU, 32 -> 16, CELU, 16 -> 1.

Each rail is evaluated as its own input; nothing of the kernels' dual-rail
factorization or folded precompute is used.  A conv of kernel (1, k, 1)
and stride k is a reshape and a matrix product on a channels-last layout
(D, W, H, C), in which H's windows are contiguous.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

# the paper's case-A block and the crossbar constants the configurations
# state (1T1R RRAM, PS32 periphery)
CROSSBAR = {"rows": 64, "tiles": 4, "g_min": 1e-6, "g_max": 1e-4,
            "v_read": 0.2, "v_th": 0.08, "wl_overdrive": True}


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, to nearest even): what
    a tensor-core product reads of each operand."""
    i = t.float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def conductances(w: torch.Tensor, xb: Dict = CROSSBAR) -> torch.Tensor:
    """(K, N) weight -> (NB, NO, D, H, 2) normalized conductances in
    float32: column j on the pair (G+, G-), w > 0 on G+, scaled by the
    largest |w| into [g_min, g_max], computed in the weight's own dtype;
    K padded with cells of no conductance (0 S) to NB blocks of D tiles
    of H wordlines; read (cells clamped into [g_min, g_max]) and
    normalized to (g - g_min) / (g_max - g_min) in float32."""
    K, N = w.shape
    H, D = xb["rows"], xb["tiles"]
    scale = torch.maximum(torch.max(torch.abs(w)), _const(1e-12, w))
    wn = w / scale
    span, gmin = _const(xb["g_max"] - xb["g_min"], w), _const(xb["g_min"], w)
    gp = gmin + span * torch.clamp(wn, 0.0, 1.0)
    gn = gmin + span * torch.clamp(-wn, 0.0, 1.0)
    g = torch.stack([gp, gn], dim=-1)                      # (K, N, 2)
    nb = -(-K // (H * D))
    g = F.pad(g, (0, 0, 0, 0, 0, nb * H * D - K))          # 0 S pad cells
    g = g.reshape(nb, D, H, N, 2).permute(0, 3, 1, 2, 4).float()
    g = torch.where(g > 0.0, torch.clamp(g, xb["g_min"], xb["g_max"]), g)
    return ((g - _const(xb["g_min"], g))
            / _const(xb["g_max"] - xb["g_min"], g)).contiguous()


def drive(x: torch.Tensor, xb: Dict = CROSSBAR):
    """(R, K) activations -> (u, positive, scale): the magnitude drive
    |x| / max|x| of the whole call, raised past the transistor's
    threshold (a nonzero drive maps into [v_th / v_read, 1], zero stays
    zero), and which rail each input drives."""
    x = x.float()
    scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-9)
    u = torch.abs(x) / scale
    if xb["wl_overdrive"]:
        t = xb["v_th"] / xb["v_read"]
        u = torch.where(u > 0.0, t + u * (1.0 - t), torch.zeros_like(u))
    return u, x > 0, scale


class Conv4Xbar:
    """The network's weights from the emulator's parameter dict (the
    names and layouts of ``conv4xbar_schema``), repacked for
    channels-last products."""

    def __init__(self, p: Dict[str, torch.Tensor], periph=(1.0, 0.0),
                 low: bool = False):
        f = {k: v.float() for k, v in p.items()}
        # ``low``: every product's operands rounded to TF32 (the control)
        self.r = tf32 if low else (lambda t: t)
        if low:
            f = {k: (self.r(v) if k.endswith("_w") else v)
                 for k, v in f.items()}
        self.w0 = f["conv0_w"][:, :, 0, 0, 0]              # (16, 2)
        self.b0 = f["conv0_b"]
        self.h = []                                        # H-stride stages
        for i in (1, 2, 3):
            w = f[f"conv{i}_w"][:, :, 0, :, 0]             # (O, I, k)
            k = w.shape[2]
            self.h.append((w.permute(2, 1, 0).reshape(k * w.shape[1],
                                                      w.shape[0]),
                           f[f"conv{i}_b"], k))
        w4 = f["conv4_w"][:, :, 0, 0, :]                   # (O, I, 2)
        self.w4 = w4.permute(2, 1, 0).reshape(2 * w4.shape[1], w4.shape[0])
        self.b4 = f["conv4_b"]
        fc0 = f["fc0_w"]
        c, d = w4.shape[0], 4
        flat = c * d
        # rows from the paper's (C, D) flatten order to (D, C); the
        # constant peripheral drive (gain 1, offset 0) joins the bias
        self.fc0 = fc0[:flat].reshape(c, d, -1).permute(1, 0, 2).reshape(
            flat, -1)
        pc = torch.zeros(fc0.shape[0] - flat, device=fc0.device)
        pc[:len(periph)] = torch.tensor(periph, device=fc0.device)
        self.fc0_b = f["fc0_b"] + pc @ fc0[flat:]
        n_fc = len([k for k in f if k.startswith("fc") and k.endswith("_w")])
        self.fcs = [(f[f"fc{i}_w"], f[f"fc{i}_b"]) for i in range(1, n_fc)]

    def blocks(self, v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """v: (R, NB, D, H) drive of R rail-rows; g: (NB, NO, D, H, 2)
        normalized conductances -> (R, NB, NO) block outputs (volts)."""
        R, NB, D, H = v.shape
        NO = g.shape[1]
        # stage 0's conductance term, then its drive term, channels last
        r = self.r
        gt = torch.addcmul(self.b0, r(g.permute(0, 1, 2, 4, 3))[..., None],
                           self.w0[:, 1])                  # (NB,NO,D,W,H,16)
        vv = r(v)[:, :, None, :, None, :, None]            # (R,NB,1,D,1,H,1)
        h = F.celu(torch.addcmul(gt[None], vv, self.w0[:, 0]),
                   inplace=True)
        lead = h.shape[:5]                                 # R, NB, NO, D, W
        for wk, b, k in self.h:                            # along H
            n = h.shape[-2] // k
            h = F.celu(torch.addmm(b, r(h.reshape(-1, wk.shape[0])), wk)
                       ).reshape(lead + (n, wk.shape[1]))
        h = h.reshape(R, NB, NO, D, -1)                    # (W, C) per tile
        h = F.celu(torch.addmm(self.b4, r(h.reshape(-1, self.w4.shape[0])),
                               self.w4)).reshape(R * NB * NO, -1)
        h = F.celu(torch.addmm(self.fc0_b, r(h), self.fc0))
        for i, (w, b) in enumerate(self.fcs):
            h = torch.addmm(b, r(h), w)
            if i < len(self.fcs) - 1:
                h = F.celu(h)
        return h.reshape(R, NB, NO)


class AnalogRef:
    """``matmul(x, w)``: the analog projection of (..., K) activations by
    a (K, N) weight, in the activations' dtype.  ``tf32`` reads every
    operand of the network's products at TF32 (the control: the nearest
    precision below the configuration's float32).  ``budget`` bounds the
    elements of stage 0's tensor: the lattice is evaluated in column
    chunks that fit.  Products run with TF32 off (``no_tf32`` around the
    call on the card)."""

    def __init__(self, emulator_params: Dict[str, torch.Tensor],
                 xb: Dict = CROSSBAR, tf32: bool = False,
                 budget: int = 1 << 28):
        self.net = Conv4Xbar(emulator_params, low=tf32)
        self.xb = xb
        self.budget = budget
        self._g: Dict[object, torch.Tensor] = {}

    def _cond(self, w: torch.Tensor, key) -> torch.Tensor:
        """Conductances of ``w``, kept under ``key`` (a site's name)."""
        if key is None:
            return conductances(w, self.xb)
        if key not in self._g:
            self._g[key] = conductances(w, self.xb)
        return self._g[key]

    @torch.no_grad()
    def matmul(self, x: torch.Tensor, w: torch.Tensor, key=None,
               rows=None) -> torch.Tensor:
        """``rows``: evaluate only these rows of the call (its drive scale
        is still the whole call's); the output then has those rows."""
        lead, K = x.shape[:-1], x.shape[-1]
        u, positive, scale = drive(x.reshape(-1, K), self.xb)
        if rows is not None:
            u, positive, lead = u[rows], positive[rows], (len(rows),)
        g = self._cond(w, key)
        NB, NO, D, H = g.shape[:4]
        u = F.pad(u, (0, NB * D * H - K))
        positive = F.pad(positive, (0, NB * D * H - K))
        rails = torch.cat([torch.where(positive, u, 0.0),
                           torch.where(positive, 0.0, u)])
        v = rails.reshape(-1, NB, D, H)
        R = v.shape[0]
        step = max(1, self.budget // (R * NB * D * H * 2 * 16))
        y = torch.cat([self.net.blocks(v, g[:, a:a + step]).sum(dim=1)
                       for a in range(0, NO, step)], dim=1)
        m = R // 2
        volts = y[:m] - y[m:]
        return (volts * scale).reshape(*lead, NO).to(x.dtype)

