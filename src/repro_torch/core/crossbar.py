"""Crossbar geometry: mapping real-valued weight matrices onto tiled
differential 1T1R crossbar arrays (the port of ``repro.core.crossbar``).

Layout:
  * a weight column j (output j) maps to a differential bitline pair
    (G+ holds w>0, G- holds -w<0), so W = 2 * outs_per_block columns/tile
  * the K input rows are split into tiles of ``rows``; ``tiles_per_block``
    tiles accumulate in analog inside one computing block; the remaining
    tiles go to further blocks summed digitally.

Every step runs in the weight's own dtype, in the reference's order, so a
bf16 weight rounds where the reference rounds.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import AnalogConfig
from repro_torch.configs.rram_ps32 import BlockGeometry


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant in ``like``'s dtype: jax casts a weak-typed
    scalar to the array's dtype BEFORE the op, so under bf16 weights the
    constants themselves are bf16-rounded (torch would keep them f32)."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def weights_to_conductance(w: torch.Tensor, acfg: AnalogConfig,
                           w_scale: torch.Tensor):
    """w: (K, N) real -> (g_pos, g_neg): (K, N) conductances in [g_min,g_max]."""
    span = _const(acfg.g_max - acfg.g_min, w)
    g_min = _const(acfg.g_min, w)
    wn = w / torch.maximum(w_scale, _const(1e-12, w))
    g_pos = g_min + span * torch.clamp(wn, 0.0, 1.0)
    g_neg = g_min + span * torch.clamp(-wn, 0.0, 1.0)
    return g_pos, g_neg


def pad_rows(x: torch.Tensor, rows: int, axis: int = 0) -> torch.Tensor:
    k = x.shape[axis]
    pad = (-k) % rows
    if pad == 0:
        return x
    widths = [0, 0] * x.dim()
    widths[2 * (x.dim() - 1 - axis) + 1] = pad        # F.pad counts from the end
    return F.pad(x, widths)


def tile_matrix(w: torch.Tensor, acfg: AnalogConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, N) -> (T, rows, N) tiles of G+/G- with zero padding."""
    K, N = w.shape
    w_scale = torch.max(torch.abs(w))
    g_pos, g_neg = weights_to_conductance(w, acfg, w_scale)
    g_pos = pad_rows(g_pos, acfg.rows)
    g_neg = pad_rows(g_neg, acfg.rows)
    T = g_pos.shape[0] // acfg.rows
    return (g_pos.reshape(T, acfg.rows, N), g_neg.reshape(T, acfg.rows, N))


@dataclass(frozen=True)
class MatmulPlan:
    """How a (K, N) matmul maps onto computing blocks."""
    K: int
    N: int
    rows: int
    tiles_per_block: int
    outs_per_block: int
    n_tiles: int
    n_block_groups: int


def plan_matmul(K: int, N: int, acfg: AnalogConfig,
                geom: BlockGeometry) -> MatmulPlan:
    n_tiles = -(-K // acfg.rows)
    d = geom.tiles
    return MatmulPlan(K=K, N=N, rows=acfg.rows, tiles_per_block=d,
                      outs_per_block=geom.outputs, n_tiles=n_tiles,
                      n_block_groups=-(-n_tiles // d))


def normalize_g(g_feat: torch.Tensor, acfg: AnalogConfig) -> torch.Tensor:
    return ((g_feat - _const(acfg.g_min, g_feat))
            / _const(acfg.g_max - acfg.g_min, g_feat))


@dataclass(frozen=True)
class ConductancePlan:
    """Precomputed block layout of one (K, N) weight matrix.

    ``g_feat`` is indexed by block (NB * NO blocks) and broadcast over the
    batch lazily by the consumer.  ``out_perm`` (optional) gathers the
    physical block outputs back into logical column order in
    ``assemble``."""
    K: int
    N: int
    rows: int                     # H: wordlines per tile
    D: int                        # tiles accumulated in analog per block
    NB: int                       # block groups over K (digital partial sums)
    NO: int                       # output groups over N
    no: int                       # outputs per block
    g_feat: torch.Tensor          # (NB, NO, D, H, W=2*no) raw conductances [S]
    g_norm: torch.Tensor          # same, normalized to [0, 1] for the emulator
    out_perm: Optional[torch.Tensor] = None   # (N,) logical col -> physical col

    @property
    def n_blocks(self) -> int:
        return self.NB * self.NO

    def with_perm(self, out_perm: Optional[torch.Tensor]) -> "ConductancePlan":
        return dataclasses.replace(self, out_perm=out_perm)

    def with_g(self, g_feat: torch.Tensor, acfg: AnalogConfig
               ) -> "ConductancePlan":
        """Same block layout, different conductances; g_norm rederived."""
        return dataclasses.replace(self, g_feat=g_feat,
                                   g_norm=normalize_g(g_feat, acfg))

    def tile_v(self, v01: torch.Tensor, v_read: float) -> torch.Tensor:
        """(M, K) wordline drive in [0,1] -> (M, NB, D, H) tile voltages."""
        M = v01.shape[0]
        v = pad_rows(v01, self.rows, axis=1)
        T = v.shape[1] // self.rows
        vt = v.reshape(M, T, self.rows) * v_read
        padT = self.NB * self.D - T
        if padT:
            vt = F.pad(vt, (0, 0, 0, padT))
        return vt.reshape(M, self.NB, self.D, self.rows)

    def build_x(self, vb: torch.Tensor) -> torch.Tensor:
        """vb: (M, NB, D, H) volts -> (M*NB*NO, 2, D, H, W) raw block-feature
        tensors (the layout the circuit/analytic backends and the
        paper-faithful emulator consume); rows M-major, block innermost."""
        M = vb.shape[0]
        shp = (M, self.NB, self.NO, self.D, self.rows, 2 * self.no)
        dt = torch.promote_types(vb.dtype, self.g_feat.dtype)
        v = vb.to(dt)[:, :, None, :, :, None].expand(shp)
        g = self.g_feat.to(dt)[None].expand(shp)
        x = torch.stack([v, g], dim=3)                # (M, NB, NO, 2, D, H, W)
        return x.reshape(M * self.n_blocks, 2, self.D, self.rows, 2 * self.no)

    def assemble(self, outs: torch.Tensor) -> torch.Tensor:
        """(M*NB*NO, no) block outputs -> (M, N) digital block-group sum."""
        M = outs.shape[0] // self.n_blocks
        if self.out_perm is None:
            y = outs.reshape(M, self.NB, self.NO * self.no)[:, :, :self.N]
            return y.sum(dim=1)
        y = outs.reshape(M, self.NB, self.NO * self.no).sum(dim=1)
        return torch.index_select(y, 1, self.out_perm)


def build_conductance_plan(w: torch.Tensor, acfg: AnalogConfig,
                           geom: BlockGeometry) -> ConductancePlan:
    """Tile + pad + interleave a (K, N) weight matrix once."""
    K, N = w.shape
    gp, gn = tile_matrix(w, acfg)                     # (T, H, N)
    T = gp.shape[0]
    D = geom.tiles
    padT = (-T) % D
    if padT:
        gp = F.pad(gp, (0, 0, 0, 0, 0, padT))
        gn = F.pad(gn, (0, 0, 0, 0, 0, padT))
    NB = (T + padT) // D
    no = geom.outputs
    padN = (-N) % no
    if padN:
        gp = F.pad(gp, (0, padN))
        gn = F.pad(gn, (0, padN))
    NO = (N + padN) // no
    H = acfg.rows
    gpb = gp.reshape(NB, D, H, NO, no)
    gnb = gn.reshape(NB, D, H, NO, no)
    g = torch.stack([gpb, gnb], dim=-1).reshape(NB, D, H, NO, 2 * no)
    g_feat = g.permute(0, 3, 1, 2, 4).contiguous()    # (NB, NO, D, H, W)
    return ConductancePlan(K=K, N=N, rows=H, D=D, NB=NB, NO=NO, no=no,
                           g_feat=g_feat, g_norm=normalize_g(g_feat, acfg))
