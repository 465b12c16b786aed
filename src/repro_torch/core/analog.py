"""AnalogExecutor: dense projections on emulated crossbar hardware (port of
``repro.core.analog`` at the ideal corner).

Weights are tiled onto differential 1T1R crossbars (``core.crossbar``);
activations drive the wordlines dual-rail (v+ = relu(x), v- = relu(-x));
blocks of D tiles accumulate in analog, block groups sum digitally; an
affine calibration (``calibrate``) maps volts back to logical units.  The
backward pass is the straight-through digital gradient (``_STMatmul``).

Backends and routes (``raw_matmul``):
  * emulator, ``fast_path=True``: both rails of every block in one pass
    (``kernels.emulator_block.emulator_block_unified``, B1);
  * emulator, ``fast_path=False`` -- the paper-faithful slow path: the
    rails stacked on the batch axis, each (row, block) through the
    Conv4Xbar network (``_eval_blocks``): B3 (``emulator_block_grid``)
    on the drive and the plan's shared conductances, or, for a
    scenario-conditioned net given scenario features, B2
    (``emulator_block``) on the ``build_x`` block tensors with their
    periph;
  * circuit and analytic: the rail-stacked ``build_x`` block tensors
    through ``circuit.block_response`` / ``analytic_block_response`` in
    plain PyTorch (the reference has no kernel for them).
Every kernel route runs its CUDA kernel for CUDA tensors and its plain
version for CPU tensors.

What the reference computes per call, this port computes per call too:
the conductance plan is cached per (tag, weight) and the emulator
weights' repack per params binding; the per-block precompute
(``blocklast_precompute``) is rebuilt from the plan's ``g_norm`` on every
call, as in the reference's serving trace -- inside B1's fp32 kernel on
the card, in plain PyTorch on the CPU and in the bf16 mode.

Not in this slice (each raises ``NotImplementedError`` naming its
ROADMAP item): non-ideal corners, read noise, remapping and
``deploy(...)`` (A8).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import AnalogConfig
from repro_torch.configs.rram_ps32 import BlockGeometry, CASE_A
from repro_torch.core import conv4xbar
from repro_torch.core.analytic import analytic_block_response
from repro_torch.core.circuit import CircuitParams, block_response
from repro_torch.core.crossbar import ConductancePlan, build_conductance_plan
from repro_torch.core.deployment import DeploymentState
from repro_torch.core.emulator import normalize_features
from repro_torch.kernels.emulator_block import (emulator_block_grid,
                                                emulator_block_unified)
from repro_torch.kernels.emulator_block.ops import emulator_block

BACKENDS = ("digital", "emulator", "circuit", "analytic")


class _STMatmul(torch.autograd.Function):
    """Calibrated analog forward, straight-through digital gradient."""

    @staticmethod
    def forward(ctx, ex: "AnalogExecutor", tag: str, x2: torch.Tensor,
                w: torch.Tensor, st: DeploymentState):
        ctx.save_for_backward(x2, w)
        plan = ex._plan_for(w, tag).with_g(ex._ideal_read(st.gf), ex.acfg) \
            .with_perm(st.out_perm)
        yv, xs = ex.raw_matmul(x2, w, tag, plan=plan,
                               eparams=st.eparams or None, sfeat=st.sfeat)
        return (st.cal_a * yv + st.cal_b) * xs

    @staticmethod
    def backward(ctx, ct):
        x2, w = ctx.saved_tensors
        gx = (ct @ w.to(ct.dtype).T).to(x2.dtype)
        gw = (x2.to(ct.dtype).T @ ct).to(w.dtype)
        return None, None, gx, gw, None


class _StateBinding:
    """Per-forward resolution of dense() call sites to DeploymentStates.

    Model tags repeat across layers, so the i-th call with tag T gets the
    site key ``"T#i"``; sites inside a stacked period ``p`` of group ``g``
    are keyed ``"{g}.{p}:{tag}#{j}"`` with ``j`` counted within the
    period -- the reference's keys.  In record mode the binding collects
    ``site_key -> weight`` and lets the call run digitally; in serve mode
    it routes each site through ``AnalogExecutor.matmul`` with its
    state."""

    def __init__(self, states: Optional[Dict[str, DeploymentState]] = None,
                 record: Optional[Dict[str, torch.Tensor]] = None):
        self.states = states
        self.record = record
        self._ordinals: Dict[str, int] = {}
        self._prefix = ""

    @property
    def recording(self) -> bool:
        return self.record is not None

    def site_key(self, tag: str) -> str:
        i = self._ordinals.get(tag, 0)
        self._ordinals[tag] = i + 1
        return f"{self._prefix}{tag}#{i}"

    @contextlib.contextmanager
    def scan_period(self, group: str, period: int):
        """Fresh within-period ordinals and key prefix for the duration."""
        saved = (self._ordinals, self._prefix)
        self._ordinals, self._prefix = {}, f"{group}.{period}:"
        try:
            yield
        finally:
            self._ordinals, self._prefix = saved

    def intercept(self, ex: "AnalogExecutor", x, w, tag: str):
        sk = self.site_key(tag)
        if self.record is not None:
            self.record[sk] = w
            return None
        st = self.states.get(sk) if self.states is not None else None
        if st is None:
            raise KeyError(
                f"no DeploymentState bound for call site {sk!r} (bound: "
                f"{sorted(self.states or ())}); states must be served with "
                "the model / layer configuration they were built for")
        return ex.matmul(x, w, sk, state=st)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item}); "
                               "the port serves the ideal corner only")


class AnalogExecutor:
    """Serving executor for analog matmuls (see module docstring).

    Owns, per weight ``tag``: the cached conductance plan and the ideal
    ``DeploymentState``.  ``emulator_params`` are tensors on the device
    the matmuls run on.  ``fast_path`` picks the emulator's route (see
    the module docstring).  The reference's ``fused_emulator`` has no
    counterpart: the port's slow path runs the paper-faithful network,
    which the reference holds bit-equal to its fused rewrite."""

    def __init__(self, acfg: AnalogConfig, geom: BlockGeometry = CASE_A,
                 cp: Optional[CircuitParams] = None,
                 emulator_params: Optional[dict] = None,
                 calibration: Optional[Dict[str, tuple]] = None,
                 fast_path: bool = True):
        if acfg.backend not in BACKENDS:
            raise ValueError(f"unknown analog backend {acfg.backend!r}")
        if acfg.scenario:
            raise _not_ported(f"scenario {acfg.scenario!r}", "A8")
        if acfg.backend == "emulator" and emulator_params is None:
            raise ValueError("the emulator backend needs Conv4Xbar params")
        self.acfg = acfg
        self.geom = geom
        self.cp = cp if cp is not None else CircuitParams()
        self.emulator_params = emulator_params
        self.calibration: Dict[str, tuple] = dict(calibration or {})
        self.fast_path = fast_path
        self._plans: Dict[str, Tuple[torch.Tensor, ConductancePlan]] = {}
        self._states: Dict[str, Tuple[ConductancePlan, DeploymentState]] = {}
        self._aux = None
        self._aux_src = None
        self._binding: Optional[_StateBinding] = None
        self._last_calib_n = 0

    # ------------------------------------------------------------------ #
    def deploy(self, **kw):
        raise _not_ported("deploy(...) (non-ideal corners, aging, remapping, "
                          "hot-swapped params)", "A8")

    @torch.no_grad()
    def calibrate(self, xc: torch.Tensor, w: torch.Tensor, tag: str,
                  warm_start: bool = False) -> Tuple[float, float]:
        """Fit the per-layer affine volts->logical map against digital on
        the probe matrix ``xc`` (n, K), through the same forward the
        tag's matmuls run, at unit affine.

        The reference draws ``xc`` itself (``normal * 0.5``, 256 rows
        cold, 128 warm); here the caller passes it, so both packages can
        fit on the same probes.  Read noise is not ported (A8), so one
        draw is the expected transfer.  ``warm_start=True`` transfers
        the previous affine: a ridge prior toward it, one synthetic row
        per parameter weighted at ~5% of the probes' leverage on that
        parameter (sum yv^2 for the scale, the row count for the
        offset); without a previous affine the fit is cold.  The probe
        count used is recorded in ``_last_calib_n``."""
        prev = self.calibration.get(tag) if warm_start else None
        xc = xc.float()
        st = self._base_state(tag, w)         # unit affine by construction
        ys = _STMatmul.apply(self, tag, xc, w, st)
        xs = torch.clamp_min(torch.max(torch.abs(xc)), 1e-9)
        yv_flat = (ys / xs).reshape(-1)
        yd_flat = ((xc @ w.float()) / xs).reshape(-1)
        A = torch.stack([yv_flat, torch.ones_like(yv_flat)], dim=1)
        rhs = yd_flat
        if prev is not None:
            la = torch.sqrt(0.05 * torch.sum(yv_flat * yv_flat) + 1e-12)
            lb = torch.sqrt(torch.tensor(0.05 * yv_flat.shape[0],
                                         device=A.device))
            prior = torch.zeros((2, 2), device=A.device)
            prior[0, 0], prior[1, 1] = la, lb
            A = torch.cat([A, prior], dim=0)
            rhs = torch.cat([rhs, torch.stack([la * prev[0], lb * prev[1]])])
        sol = torch.linalg.lstsq(A, rhs[:, None]).solution[:, 0]
        self.calibration[tag] = (float(sol[0]), float(sol[1]))
        self._last_calib_n = xc.shape[0]
        return self.calibration[tag]

    # ------------------------------------------------------------------ #
    def _plan_for(self, w: torch.Tensor, tag: str) -> ConductancePlan:
        """Tile/pad/interleave once per bound weight; rebuilt when the tag
        is rebound to a different tensor."""
        ent = self._plans.get(tag) if tag else None
        if ent is not None and ent[0] is w:
            return ent[1]
        with torch.no_grad():
            plan = build_conductance_plan(w.detach(), self.acfg, self.geom)
        if tag:
            self._plans[tag] = (w, plan)
        return plan

    def _blocklast_aux(self, eparams: Optional[dict] = None) -> dict:
        """Stage-collapsed emulator weights, cached per params binding."""
        params = self.emulator_params if eparams is None else eparams
        if self._aux is None or self._aux_src is not params:
            with torch.no_grad():
                self._aux = conv4xbar.blocklast_weights(params, self.geom)
            self._aux_src = params
        return self._aux

    def _base_state(self, tag: str, w: torch.Tensor) -> DeploymentState:
        """The ideal state for ``(tag, w)`` at unit affine, cached per plan."""
        plan = self._plan_for(w, tag)
        ent = self._states.get(tag)
        if ent is None or ent[0] is not plan:
            ep = self.emulator_params if self.acfg.backend == "emulator" else None
            ent = (plan, DeploymentState.ideal(plan, eparams=ep))
            self._states[tag] = ent
        return ent[1]

    def state_for(self, tag: str, w: torch.Tensor) -> DeploymentState:
        """The ideal state for ``(tag, w)``, stamped with the tag's
        calibration affine (unit by default)."""
        a, b = self.calibration.get(tag, (1.0, 0.0))
        return self._base_state(tag, w).with_calibration(a, b)

    def _ideal_read(self, g: torch.Tensor) -> torch.Tensor:
        """The reference's read-noise draw at sigma 0: an exact identity
        up to clamping the cells (g > 0) into [g_min, g_max], which a bf16
        weight's rounded conductances can leave."""
        return torch.where(g > 0.0, torch.clamp(g, self.acfg.g_min,
                                                self.acfg.g_max), g)

    def _drive01(self, u01: torch.Tensor) -> torch.Tensor:
        """Gate-overdrive wordline biasing: nonzero drives map into
        [v_th/v_read, 1]; zero stays exactly zero (the dual-rail delta
        factorization and the padded tiles depend on it)."""
        if not self.acfg.wl_overdrive:
            return u01
        t = self.cp.v_th / self.acfg.v_read
        return torch.where(u01 > 0.0, t + u01 * (1.0 - t),
                           torch.zeros_like(u01))

    # ------------------------------------------------------------------ #
    def _emulator_params(self, eparams: Optional[dict]) -> dict:
        return self.emulator_params if eparams is None else eparams

    def _backend_fn(self, eparams: Optional[dict] = None):
        """Block-response function ``f(x, periph)`` of the configured
        backend on raw-feature block tensors; ``eparams`` overrides the
        executor's emulator params."""
        b = self.acfg.backend
        cp = self.cp
        if b == "circuit":
            return lambda x, p: block_response(x, cp, p)
        if b == "analytic":
            return lambda x, p: analytic_block_response(x, cp, p)
        if b == "emulator":
            params = self._emulator_params(eparams)
            return lambda x, p: emulator_block(
                params, normalize_features(x, self.acfg), p, self.geom)
        raise ValueError(b)

    def block_outputs(self, x: torch.Tensor, eparams: Optional[dict] = None,
                      sfeat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (NBLK, 2, D, H, W) raw-feature block tensors -> (NBLK, O).

        The peripheral vector is the serving constant (gain 1, offset 0);
        a scenario-conditioned emulator's is widened with the scenario
        features (``sfeat=None``: the ideal corner's zeros; a per-tile
        ``(NB, NO, F)`` sfeat is tiled over the batch rows, whose blocks
        are lattice-innermost)."""
        n = x.shape[0]
        periph = torch.cat([torch.ones((n, 1), dtype=x.dtype, device=x.device),
                            torch.zeros((n, 1), dtype=x.dtype, device=x.device)],
                           dim=-1)
        if self.acfg.backend == "emulator":
            npf = conv4xbar.n_periph_of(self._emulator_params(eparams), self.geom)
            if npf > 2:
                if sfeat is None:
                    tail = torch.zeros((n, npf - 2), dtype=x.dtype,
                                       device=x.device)
                elif sfeat.dim() >= 2:
                    t2 = sfeat.reshape(-1, sfeat.shape[-1]).to(x.dtype)
                    tail = t2.repeat(n // t2.shape[0], 1)
                else:
                    tail = sfeat.to(x.dtype)[None].expand(n, npf - 2)
                periph = torch.cat([periph, tail], dim=-1)
        return self._backend_fn(eparams)(x, periph)

    def _eval_blocks(self, plan: ConductancePlan, vb01: torch.Tensor,
                     eparams: Optional[dict] = None,
                     sfeat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """vb01: (M, NB, D, H) wordline drive in [0, 1] -> (M*NB*NO, no).

        The emulator goes to B3 on the drive and the plan's shared
        conductances, unless a conditioned net is given scenario features
        (its periph then varies with them: B2 on the block tensors).  B3
        gets the V channel the reference's block tensors carry,
        ``(vb01 * v_read) / v_read``; its G channel is the plan's
        ``g_norm``, the same normalization of the same conductances."""
        if self.acfg.backend == "emulator":
            params = self._emulator_params(eparams)
            if sfeat is None or conv4xbar.n_periph_of(params, self.geom) <= 2:
                vr = torch.tensor(self.acfg.v_read, dtype=vb01.dtype,
                                  device=vb01.device)
                g = plan.g_norm.float().reshape(
                    plan.n_blocks, plan.D, plan.rows, 2 * plan.no)
                y = emulator_block_grid(params, ((vb01 * vr) / vr).contiguous(),
                                        g.contiguous(), self.geom)
                return y.reshape(-1, y.shape[-1])
        x = plan.build_x(vb01 * self.acfg.v_read)
        return self.block_outputs(x.float(), eparams, sfeat)

    def raw_matmul(self, x2d: torch.Tensor, w: torch.Tensor, tag: str = "",
                   plan: Optional[ConductancePlan] = None,
                   eparams: Optional[dict] = None,
                   sfeat: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Analog forward for (B,K) @ (K,N), in volts (uncalibrated), and
        the drive scale ``max|x|`` of the whole call."""
        if self.acfg.backend == "digital":
            raise ValueError("the digital backend has no analog forward")
        if plan is None:
            plan = self._plan_for(w, tag)
        B = x2d.shape[0]
        x2d = x2d.float()
        x_scale = torch.clamp_min(torch.max(torch.abs(x2d)), 1e-9)
        if self.acfg.backend == "emulator" and self.fast_path:
            aux = self._blocklast_aux(eparams)
            shift = None
            if sfeat is not None and "f0_scen" in aux:
                shift = sfeat @ aux["f0_scen"]
            u = plan.tile_v(self._drive01(torch.abs(x2d) / x_scale), 1.0)
            pos = plan.tile_v((x2d > 0).float(), 1.0)
            y2 = emulator_block_unified(aux, plan.g_norm.contiguous(),
                                        u.contiguous(), pos.contiguous(),
                                        shift=shift)
            return plan.assemble(y2[0]) - plan.assemble(y2[1]), x_scale
        rails = torch.cat([torch.clamp_min(x2d, 0.0),
                           torch.clamp_min(-x2d, 0.0)], dim=0)
        vb01 = plan.tile_v(self._drive01(rails / x_scale), 1.0)  # (2B,NB,D,H)
        y = plan.assemble(self._eval_blocks(plan, vb01.float(), eparams, sfeat))
        return y[:B] - y[B:], x_scale

    def matmul(self, x: torch.Tensor, w: torch.Tensor, tag: str = "",
               state: Optional[DeploymentState] = None) -> torch.Tensor:
        """Calibrated analog matmul with straight-through digital gradient;
        ``state`` overrides the tag's ideal state."""
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).float()
        st = state if state is not None else self.state_for(tag, w)
        y = _STMatmul.apply(self, tag, x2, w, st)
        return y.reshape(*lead, w.shape[1]).to(x.dtype)

    # ------------------------------------------------------------------ #
    @contextlib.contextmanager
    def bound_states(self, binding: _StateBinding):
        """Route dense() call sites through ``binding`` for the duration."""
        prev = self._binding
        self._binding = binding
        try:
            yield binding
        finally:
            self._binding = prev

    def hook(self, x: torch.Tensor, w: torch.Tensor, tag: str):
        """dense()-hook: route configured projections to the analog path."""
        if self.acfg.backend == "digital":
            return None
        if not any(tag.startswith(l) for l in self.acfg.layers):
            return None
        if self._binding is not None:
            return self._binding.intercept(self, x, w, tag)
        return self.matmul(x, w, tag)
