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
from typing import Optional, Sequence, Tuple

import numpy as np
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

    def with_lattice(self, g_feat: torch.Tensor, acfg: AnalogConfig, *,
                     NB: Optional[int] = None,
                     NO: Optional[int] = None,
                     g_norm: Optional[torch.Tensor] = None
                     ) -> "ConductancePlan":
        """A local view of this plan over a slice of the tile lattice:
        the same geometry, a reduced block-group (NB) and/or output-group
        (NO) count and the matching ``g_feat`` slice (``g_norm``, when
        given, is its normalization, else derived); the output
        permutation is dropped (the remap gather runs on full outputs)."""
        return dataclasses.replace(
            self, NB=self.NB if NB is None else NB,
            NO=self.NO if NO is None else NO, g_feat=g_feat,
            g_norm=normalize_g(g_feat, acfg) if g_norm is None else g_norm,
            out_perm=None)

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

    def group_sum(self, outs: torch.Tensor) -> torch.Tensor:
        """(M*NB*NO, no) block outputs -> (M, NO*no): each physical
        column summed over its NB block groups (``sum_block_groups``)."""
        M = outs.shape[0] // self.n_blocks
        return sum_block_groups(outs.reshape(M, self.NB, self.NO * self.no))

    def assemble(self, outs: torch.Tensor) -> torch.Tensor:
        """(M*NB*NO, no) block outputs -> (M, N) digital block-group sum."""
        y = self.group_sum(outs)
        if self.out_perm is None:
            return y[:, :self.N]
        return torch.index_select(y, 1, self.out_perm)


def sum_block_groups(y: torch.Tensor) -> torch.Tensor:
    """Sum ``y`` over axis 1 (the block groups) in a fixed order: adjacent
    groups added in pairs, level by level, an odd last one carried, so
    every partial sum covers a contiguous run of groups.  Each column is
    summed in the same order whatever the tensor's other extents, which
    ``torch.sum`` does not promise (its split follows the shape): a
    column window, a tensor-parallel rank's share, sums to the bits it
    has in the whole.  And a run of 2^k groups starting at a multiple of
    2^k is one node of the tree: a rank holding such a run of block
    groups sums it to the node's bits."""
    while y.shape[1] > 1:
        n = y.shape[1]
        pairs = y[:, 0:n - 1:2] + y[:, 1:n:2]
        y = torch.cat([pairs, y[:, n - 1:]], dim=1) if n % 2 else pairs
    return y[:, 0]


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


# --------------------------------------------------------------------------- #
# Stuck-fault-aware remapping (classic fault-tolerant mapping)
# --------------------------------------------------------------------------- #
# The assignment runs on the host in float64 numpy, as the reference's
# does, except its two (NO, C) x (C, NO) scoring products: those run as
# float64 ``torch.matmul`` on the plan's device (the reference's einsum
# over a bool operand does not reach BLAS, and at a full-width MLP tag it
# is ~1e11 multiply-adds).  The hit counts are integers, exact either way;
# the damage sums may differ from the einsum's in the last bits, which can
# flip the greedy only at near-ties.
def _by_group(a: np.ndarray, plan: ConductancePlan) -> np.ndarray:
    """(NB, NO, D, H, W) -> (NO, NB*D*H*W), NB outermost in the cell axis."""
    return a.transpose(1, 0, 2, 3, 4).reshape(plan.NO, -1)


def _group_product(fault: np.ndarray, x_g: np.ndarray, device) -> np.ndarray:
    """``einsum("pc,qc->qp", fault, x_g)`` as a float64 matmul on
    ``device``: ``out[q, p] = sum_c x_g[q, c] * fault[p, c]``."""
    f = torch.from_numpy(np.ascontiguousarray(fault)).to(device, torch.float64)
    x = torch.from_numpy(np.ascontiguousarray(x_g, np.float64)).to(device)
    return torch.matmul(x, f.T).cpu().numpy()


def _horizon_damage(g: np.ndarray, live: np.ndarray, fault: np.ndarray,
                    plan: ConductancePlan, acfg: AnalogConfig,
                    horizon: Sequence[np.ndarray]) -> np.ndarray:
    """Anticipated end-of-horizon damage ``dmg[q, p]`` averaged over a
    drift trajectory: the drifted stuck-off excess (a live cell of
    logical group q at physical position p holds ``clip(g * df_p(t))``,
    a stuck cell there reads g_min) plus the drift mismatch of the
    healthy cells against the fleet-mean decay.  An all-ones trajectory
    reduces it to the instantaneous matrix."""
    gg = _by_group(g, plan)
    lv = _by_group(live, plan)
    C = gg.shape[1]
    cells_per_nb = C // plan.NB
    dmg = np.zeros((plan.NO, plan.NO))
    horizon = list(horizon)
    for df in horizon:
        d = np.asarray(df, np.float64)
        if d.ndim == 0:
            dfc = np.broadcast_to(d, (plan.NO, C))
        elif d.shape == (plan.NB, plan.NO):
            # per-tile decay -> per (physical group, cell), NB outermost
            dfc = np.repeat(d.T, cells_per_nb, axis=1)
        else:
            raise ValueError(
                f"horizon drift factor shaped {d.shape}; expected a "
                f"scalar or (NB, NO) = {(plan.NB, plan.NO)}")
        dbar = dfc.mean(axis=0)
        for p in range(plan.NO):
            gd = np.clip(gg * dfc[p], acfg.g_min, acfg.g_max)
            ex = np.where(lv, (gd - acfg.g_min), 0.0)
            dmg[:, p] += ex @ fault[p]
            mis = np.where(lv, gg * np.abs(dfc[p] - dbar), 0.0)
            dmg[:, p] += mis @ (1.0 - fault[p])
    span = float(acfg.g_max - acfg.g_min)
    return dmg / (span * max(len(horizon), 1))


def _assignment_horizon_score(g: np.ndarray, off: np.ndarray,
                              gperm: np.ndarray, plan: ConductancePlan,
                              acfg: AnalogConfig,
                              horizon: Sequence[np.ndarray]) -> float:
    """End-of-horizon weight-space deviation of an assignment: stuck-off
    cells pinned at g_min at their physical positions, live cells decayed
    by their physical host's factor and clipped, folded into differential
    weights; ``min_a ||W_young - a W_eff||_F^2`` over the real columns,
    averaged over the horizon.  Lower is better."""
    gperm = np.asarray(gperm)
    off_at = off[:, gperm]
    live = g > 0.0
    no = plan.no
    col = (np.arange(plan.NO)[:, None] * no + np.arange(no)[None, :])
    vmask = (col < plan.N).astype(np.float64)[None, :, None, None, :]
    w_young = (g[..., 0::2] - g[..., 1::2]) * vmask
    total = 0.0
    horizon = list(horizon)
    for df in horizon:
        d = np.asarray(df, np.float64)
        if d.ndim == 0:
            dfq = np.broadcast_to(d, (plan.NB, plan.NO))
        elif d.shape == (plan.NB, plan.NO):
            dfq = d[:, gperm]
        else:
            raise ValueError(
                f"horizon drift factor shaped {d.shape}; expected a "
                f"scalar or (NB, NO) = {(plan.NB, plan.NO)}")
        aged = np.clip(g * dfq[:, :, None, None, None], acfg.g_min,
                       acfg.g_max)
        eff = np.where(off_at, acfg.g_min, np.where(live, aged, 0.0))
        w_eff = (eff[..., 0::2] - eff[..., 1::2]) * vmask
        ee = float((w_eff * w_eff).sum())
        a = float((w_eff * w_young).sum()) / ee if ee > 0.0 else 1.0
        r = w_young - a * w_eff
        total += float((r * r).sum())
    return total / max(len(horizon), 1)


def fault_aware_group_perm(g_feat: np.ndarray, stuck_off: np.ndarray,
                           plan: ConductancePlan, acfg: AnalogConfig,
                           top_q: float = 0.9,
                           horizon: Optional[Sequence[np.ndarray]] = None,
                           device=None
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Permute logical output groups across physical block positions so
    large-magnitude weights avoid stuck-at-G_off cells (the reference's
    assignment).  Lexicographic cost: first the top-``top_q``-quantile
    |w| cells landing on stuck-off sites, then the conductance excess
    landing there; greedy over logical groups in descending order of
    top-weight mass, staying home on ties (identity when fault-free).
    With ``horizon`` (drift factors, scalar or (NB, NO) by physical
    tile) a wear-aware candidate is grown under ``_horizon_damage`` and
    the lower ``_assignment_horizon_score`` wins, instant on ties.

    ``g_feat``/``stuck_off``: (NB, NO, D, H, W) base-plan conductances
    (logical layout) and the stuck-off mask at physical positions;
    ``device``: where the scoring products run (default: the CPU).
    Returns ``(out_perm, gperm, ginv)``: ``out_perm[j]`` the physical
    column of logical column j, ``gperm[q]`` the physical group of
    logical group q, ``ginv[p]`` the logical group at position p."""
    g = np.asarray(g_feat, np.float64)
    off = np.asarray(stuck_off, bool)
    cands = _perm_candidates(g, off, plan, acfg, top_q, horizon, device)
    gperm = cands[0]
    if len(cands) > 1:
        s_inst = _assignment_horizon_score(g, off, cands[0], plan, acfg,
                                           horizon)
        s_wear = _assignment_horizon_score(g, off, cands[1], plan, acfg,
                                           horizon)
        if s_wear < s_inst:                            # instant wins ties
            gperm = cands[1]
    return finish_group_perm(gperm, plan)


def finish_group_perm(gperm: np.ndarray, plan: ConductancePlan
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Expand a logical->physical group assignment into
    ``(out_perm, gperm, ginv)``."""
    ginv = np.empty_like(gperm)
    ginv[gperm] = np.arange(plan.NO, dtype=np.int32)
    cols = np.arange(plan.N, dtype=np.int32)
    out_perm = gperm[cols // plan.no] * plan.no + cols % plan.no
    return out_perm.astype(np.int32), gperm, ginv


def _perm_candidates(g: np.ndarray, off: np.ndarray, plan: ConductancePlan,
                     acfg: AnalogConfig, top_q: float,
                     horizon: Optional[Sequence[np.ndarray]],
                     device=None) -> list:
    """Candidate group assignments: the instantaneous greedy first, plus
    the wear-aware greedy when a ``horizon`` is given and it disagrees."""
    device = torch.device("cpu") if device is None else device
    span = float(acfg.g_max - acfg.g_min)
    live = g > 0.0
    # damage a stuck-off cell does = programmed excess over g_min, in
    # weight units; padded sites (no physical cell) carry none
    excess = np.where(live, (g - acfg.g_min) / span, 0.0)
    pos_excess = excess[excess > 0.0]
    if pos_excess.size == 0:
        return [np.arange(plan.NO, dtype=np.int32)]
    thr = np.quantile(pos_excess, top_q)
    top = (excess >= thr) & live
    fault = _by_group(off, plan)                       # physical positions
    excess_g = _by_group(excess, plan)                 # logical groups
    top_g = _by_group(top, plan).astype(np.float64)
    hits = _group_product(fault, top_g, device)
    # most-vulnerable logical groups pick first: top-decile cell count
    # first, then total excess
    vbig = excess_g.sum(axis=1).max() + 1.0
    vuln = top_g.sum(axis=1) * vbig + excess_g.sum(axis=1)
    order = np.argsort(-vuln, kind="stable")

    def greedy(dmg: np.ndarray) -> np.ndarray:
        big = dmg.max() + 1.0
        cost = hits * big + dmg                        # lexicographic
        gp = np.full(plan.NO, -1, dtype=np.int32)
        free = np.ones(plan.NO, bool)
        for q in order:
            c = np.where(free, cost[q], np.inf)
            best = c.min()
            # prefer staying home on ties -> identity when fault-free
            p = int(q) if (free[q] and c[q] <= best) else int(np.argmin(c))
            gp[q] = p
            free[p] = False
        return gp

    cands = [greedy(_group_product(fault, excess_g, device))]
    if horizon is not None:
        cand = greedy(_horizon_damage(g, live, fault, plan, acfg, horizon))
        if not np.array_equal(cand, cands[0]):
            cands.append(cand)
    return cands
