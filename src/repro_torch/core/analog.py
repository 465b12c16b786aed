"""AnalogExecutor: dense projections on emulated crossbar hardware (port of
``repro.core.analog``).

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

Deployment model: everything that distinguishes a deployed device from
the ideal hardware -- perturbed conductances, read sigma and key, the
fault-remap permutation, hot-swapped emulator params, the scenario
encoding a conditioned net consumes and the calibration affine -- is one
``core.deployment.DeploymentState`` per call site, derived from the
immutable spec ``deploy(scenario=, age=, remap=, params=, key=)`` builds
and cached per (tag, plan, deployment).  Read noise is drawn from the
state's read key (``nonideal.perturb.apply_read_noise`` on ``gf``, then
``with_g``), so the same state reads the same draw: the read plan is kept
per tag while the state stays the same (``_read_plan``), and a new state
-- a new generate, or a calibration draw -- reads a new cycle.  At sigma
0 the read is the identity up to clamping cells into [g_min, g_max].
``DeploymentState.ideal()`` reproduces the plain path bit for bit.

Tensor-parallel serving (``AnalogExecutor(mesh=serve_mesh(dp, tp))``,
``parallel.sharding``): one process a rank, each holding the full
activations (the digital model runs replicated) and only its window of
every plan's and state's tile lattice.  ``_sharded_matmul``, the one body
of ``raw_matmul`` (off a mesh its rows and window are the whole and no
collective runs), takes the drive scale of
the whole call, splits the rows over ``data`` and evaluates its window --
B1 on the local ``with_lattice`` view on the fast path, the generic
backends on both rails as one batch otherwise -- then one ``all_reduce``
over ``model`` completes the block-group sum: ``col`` writes the full NB
reduction of its columns into negative zeros (bit-identical), ``row``
shares each rank's partial sums and finishes the sum on every rank
(bit-identical where each rank holds a power-of-two run of block groups,
float tolerance otherwise).  Rows come back through an
``all_reduce`` of negative-zero-filled outputs over ``data`` (gloo, which
carries the ranks that share one card, reduces and broadcasts CUDA
tensors but gathers none), and the remap gather runs on the full
columns.  Read noise is mesh-invariant: a rank draws the whole field
from the state's key and keeps its window.  The reference's GSPMD concat
workaround answers a jax miscompilation and has no counterpart here.

Training on a mesh (``launch.train --devices``; the model's functions
run under ``models.common.use_mesh``): the digital model runs on each
rank's rows of the batch (``runtime.steps``), so while a training mesh
is installed the drive scale is the max over its ``data`` axis -- the
unsharded call's, since a row's output depends on its batch-mates
through it -- and a rank evaluates its window of the lattice on its own
rows; the ``model`` all_reduce completes the block-group sum as in
serving, and no row gather follows.  The straight-through backward runs
replicated over ``model``.

Many device states of one tag (a sweep's draws, a fleet's chunk of
devices) run as one forward, ``raw_matmul_many``: the drive depends only
on the rows and their scale, which every state shares, so the states'
conductances stack along the output-group axis and B1 evaluates them all
in one launch; each state's outputs are summed over block groups in a
fixed order, so a state's result does not depend on its batch-mates.
``pairwise_sum`` is the matching fixed-order reduction for per-state
statistics.  The reference's ``calibrate`` draws its own probes; here
``calibration_probes`` draws them from a ``core.prng`` key and
``calibration_budget`` applies the reference's cold/warm probe count.

Telemetry (``repro_torch.obs``, at the reference's names): the plan and
state caches' hits and misses (a plan-cache miss is a conductance-plan
build, the reference's per-(tag, weight) forward), the calibration fit,
each matmul's call count and its span ``analog_matmul`` (labelled by
``tag``: the host's time to enqueue the call's launches, and a record on
the clock a device trace is tied to), and ``analog_traces_total``, the
read-plan builds (what each newly served state costs) -- the port
compiles nothing.  ``builds`` and ``calls`` are the executor's own counts
of the same events, kept whether telemetry is on or off;
``RecompileSentinel(executor=...)`` watches ``builds``.  No instrument
reads a tensor or synchronizes the device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import zlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import AnalogConfig
from repro_torch.configs.rram_ps32 import BlockGeometry, CASE_A
from repro_torch.core import conv4xbar
from repro_torch.core.analytic import analytic_block_response
from repro_torch.core.circuit import CircuitParams, block_response
from repro_torch.core import prng
from repro_torch.core.crossbar import (ConductancePlan, build_conductance_plan,
                                       sum_block_groups)
from repro_torch.core.deployment import Deployment, DeploymentState
from repro_torch.core.emulator import normalize_features
from repro_torch.kernels.emulator_block import (emulator_block_grid,
                                                emulator_block_unified)
from repro_torch.kernels.emulator_block.ops import emulator_block
from repro_torch.nonideal.lifetime import scenario_at_age
from repro_torch.nonideal.perturb import (apply_read_noise, perturb_plan,
                                          read_noise_draw, remap_plan,
                                          scenario_circuit_params)
from repro_torch.nonideal.scenario import (Scenario, get_scenario,
                                           scenario_features,
                                           scenario_features_tiled)
from repro_torch.models.common import current_mesh
from repro_torch.obs import OBS
from repro_torch.parallel.sharding import (MODEL_AXIS, DATA_AXIS,
                                           gather_deployment_state,
                                           keep_window, lattice_scheme,
                                           lattice_window, local_lattice,
                                           mesh_coords, mesh_shape,
                                           shard_deployment_state)

BACKENDS = ("digital", "emulator", "circuit", "analytic")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _field_draw(g: torch.Tensor, key, lattice: Tuple[int, int],
                win: Optional[Tuple[slice, slice]]) -> torch.Tensor:
    """One read cycle's draw for ``g``, a ``win`` window of a field over
    the whole ``lattice`` (or the whole field for ``win=None``): the
    whole field is drawn and the window kept, so the noise a tile reads
    is the same on every mesh."""
    eps = read_noise_draw(lattice + tuple(g.shape[2:]), key, g.device)
    return eps if win is None else eps[win]


def _same_weight(a: torch.Tensor, version: int, b: torch.Tensor) -> bool:
    """``b`` holds the elements ``a`` held when its plan was built: ``a``
    itself or a view of the same elements (a stacked period's weight is a
    fresh view ``stack[p]`` on every forward), at the same ``_version``.
    An in-place update -- an optimizer step -- bumps the version counter
    that a tensor shares with its views and its base, so the next call
    rebuilds.  The cache holds ``a``, so its memory cannot be reused while
    the entry lives."""
    return (a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                       and a.stride() == b.stride() and a.dtype == b.dtype
                       and a.device == b.device)) and b._version == version


def calibration_probes(key, n: int, k: int, device) -> torch.Tensor:
    """The reference's calibration probes, ``normal * 0.5`` of shape (n,
    k), drawn from a ``core.prng`` key on ``device``."""
    return torch.randn((n, k), generator=prng.generator(prng.as_key(key),
                                                        device),
                       device=device) * 0.5


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed pairwise order: zero-padded to a
    power of two, then halves added until one column is left.  Each row's
    result depends only on that row (``torch.sum`` picks its split by the
    tensor's shape), so a device's statistics are the same whatever its
    chunk."""
    n = x.shape[-1]
    p = 1 << max(0, (n - 1).bit_length())
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def fc0_shift(sfeat: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
    """A conditioned net's fc0 shift ``sfeat @ f0``: flat for a (F,)
    encoding, one row a block (in lattice order) for a per-tile (..., F)
    one.  The products are summed over the features by ``pairwise_sum``,
    so each block's shift depends only on its own encoding (a cuBLAS
    product picks its kernel, and with it the summation order, by the row
    count: a device's shift would change with its chunk)."""
    acc = pairwise_sum((sfeat[..., None] * f0).transpose(-1, -2))
    return acc.reshape(-1, acc.shape[-1]) if acc.dim() > 2 else acc


class _STMatmul(torch.autograd.Function):
    """Calibrated analog forward, straight-through digital gradient: the
    backward's two products are plain matmuls (``ct @ w.T`` and
    ``x.T @ ct``), as in the reference, which computes them outside any
    kernel too."""

    @staticmethod
    def forward(ctx, ex: "AnalogExecutor", tag: str, x2: torch.Tensor,
                w: torch.Tensor, st: DeploymentState):
        ctx.save_for_backward(x2, w)
        plan = ex._read_plan(w, tag, st)
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


_UNSET = object()


class AnalogExecutor:
    """Serving executor for analog matmuls (see module docstring).

    Owns, per weight ``tag``: the cached conductance plan and the
    materialized device state of the active ``Deployment`` (an immutable
    spec built by ``deploy``).  ``emulator_params`` are tensors on the
    device the matmuls run on.  ``fast_path`` picks the emulator's route
    (see the module docstring).  The reference's ``fused_emulator`` has
    no counterpart: the port's slow path runs the paper-faithful network,
    which the reference holds bit-equal to its fused rewrite.
    ``materialize_s[tag]`` records the host seconds the last
    materialization of the tag's device state took, and the remap's part
    of them.

    ``mesh`` (``parallel.sharding.serve_mesh``) serves the analog plane
    tensor-parallel; ``shard_scheme`` is ``"auto"`` (``lattice_scheme``),
    or forces ``"col"``, ``"row"`` or ``"none"``.  While a training
    mesh is installed (``models.common.use_mesh``) a call's rows are this
    rank's share of the batch, already split over ``data``: the drive
    scale is their max taken over ``data`` (the unsharded call's), and
    the rows are neither split again nor gathered after.  ``mesh_times``, when a
    dict, collects the synchronized milliseconds of each sharded call's
    B1 launch (``"b1"``) and its collectives (``"all_reduce"``)."""

    def __init__(self, acfg: AnalogConfig, geom: BlockGeometry = CASE_A,
                 cp: Optional[CircuitParams] = None,
                 emulator_params: Optional[dict] = None,
                 calibration: Optional[Dict[str, tuple]] = None,
                 fast_path: bool = True,
                 scenario: Optional[Scenario] = None,
                 scenario_key=None, fault_remap: bool = False,
                 mesh=None, shard_scheme: str = "auto"):
        if acfg.backend not in BACKENDS:
            raise ValueError(f"unknown analog backend {acfg.backend!r}")
        if acfg.backend == "emulator" and emulator_params is None:
            raise ValueError("the emulator backend needs Conv4Xbar params")
        self.acfg = acfg
        self.geom = geom
        self.cp = cp if cp is not None else CircuitParams()
        self._base_params = emulator_params
        self.calibration: Dict[str, tuple] = dict(calibration or {})
        self.fast_path = fast_path
        self._plans: Dict[str, Tuple[torch.Tensor, int, ConductancePlan]] = {}
        # tag -> (plan, deployment, state, perturbed plan)
        self._state_cache: Dict[str, tuple] = {}
        # tag -> (plan, state, the plan one read cycle of the state gives)
        self._read_cache: Dict[str, tuple] = {}
        self._aux = None
        self._aux_src = None
        self._binding: Optional[_StateBinding] = None
        self._last_calib_n = 0
        self._read_calls = 0
        self._sfeat_ent: Optional[tuple] = None
        self.materialize_s: Dict[str, Tuple[float, float]] = {}
        # per kind (plan, state, read) and tag, the builds; per tag, matmuls
        self.builds: Dict[str, Dict[str, int]] = {"plan": {}, "state": {},
                                                  "read": {}}
        self.calls: Dict[str, int] = {}
        self.mesh = mesh
        self.shard_scheme = shard_scheme
        self.mesh_times: Optional[Dict[str, list]] = None
        if scenario is None and acfg.scenario:
            scenario = get_scenario(acfg.scenario)
        self._deployment = Deployment(
            scenario=scenario,
            key=prng.as_key(0 if scenario_key is None else scenario_key),
            remap=fault_remap)

    # ------------------------------------------------------------------ #
    # The immutable deployment
    # ------------------------------------------------------------------ #
    @property
    def deployment(self) -> Deployment:
        return self._deployment

    @property
    def scenario(self) -> Optional[Scenario]:
        return self._deployment.scenario

    @property
    def scenario_key(self):
        return self._deployment.key

    @property
    def fault_remap(self):
        return self._deployment.remap

    @property
    def emulator_params(self) -> Optional[dict]:
        """The deployment's hot-swapped params when set, else those bound
        at construction."""
        return (self._deployment.params if self._deployment.params is not None
                else self._base_params)

    def deploy(self, *, scenario=_UNSET, age: Optional[float] = None,
               remap=_UNSET, params=_UNSET, key=None,
               states=_UNSET) -> Deployment:
        """Activate (and return) a new immutable deployment; only the
        given fields change.  ``scenario=None`` clears the corner (a name
        resolves through the registry); ``age`` rewrites the scenario's
        ``drift_t`` (the fleet ages, it is not refabricated); ``remap`` is
        the stuck-fault-aware remapping policy (True = instantaneous, a
        sequence of ages in seconds = wear-aware); ``params`` hot-swaps
        emulator params; ``key`` (an int seed, a ``torch.Generator``'s
        seed or two key words) refabricates the fleet; ``states``
        installs preloaded per-site states (``load_deployment``).
        Invalidates the materialized device states and restarts the
        read-cycle sequence."""
        dep = self._deployment
        sc = dep.scenario if scenario is _UNSET else scenario
        if isinstance(sc, str):
            sc = get_scenario(sc)
        if age is not None:
            if sc is None:
                raise ValueError("deploy(age=...) needs a scenario to age")
            sc = scenario_at_age(sc, age)
        if remap is not _UNSET and isinstance(remap, (tuple, list)):
            remap = tuple(float(t) for t in remap)
        self._deployment = Deployment(
            scenario=sc,
            key=dep.key if key is None else prng.as_key(key),
            remap=(dep.remap if remap is _UNSET
                   else remap if isinstance(remap, tuple) else bool(remap)),
            params=dep.params if params is _UNSET else params,
            states=dep.states if states is _UNSET else states)
        self._state_cache.clear()
        self._read_cache.clear()
        self._sfeat_ent = None
        self._read_calls = 0
        return self._deployment

    @property
    def emulator_conditioned(self) -> bool:
        """True when the bound emulator params are scenario-conditioned
        (periph width > 2: fc0 has rows for ``scenario_features``)."""
        return (self.emulator_params is not None
                and conv4xbar.n_periph_of(self.emulator_params,
                                          self.geom) > 2)

    # ------------------------------------------------------------------ #
    # Device-state materialization
    # ------------------------------------------------------------------ #
    def _scenario_features(self, device) -> torch.Tensor:
        """The active scenario's encoding, once per Scenario object: the
        per-tile ``(NB, NO, F)`` lattice for a tiled corner, else the
        flat ``(F,)`` vector."""
        sc = self.scenario
        ent = self._sfeat_ent
        if ent is None or ent[0] is not sc or ent[1].device != device:
            v = (scenario_features_tiled(sc) if sc.tile_shape is not None
                 else scenario_features(sc))
            ent = (sc, v.to(device))
            self._sfeat_ent = ent
        return ent[1]

    def _tag_key(self, tag: str):
        """Per-tag device-draw key; crc32 keeps it stable across processes."""
        return prng.fold_in(self.scenario_key,
                            zlib.crc32(tag.encode()) & 0x7FFFFFFF)

    def _next_read_key(self):
        """A fresh key per read cycle; the sequence restarts at deploy()."""
        k = prng.fold_in(prng.fold_in(self.scenario_key, 0x5245AD),
                         self._read_calls)
        self._read_calls += 1
        return k

    def _materialize(self, tag: str, w: torch.Tensor) -> tuple:
        """``(plan, deployment, state, perturbed plan)`` for ``(tag, w)``:
        the scenario's perturbation (and, under ``remap``, the
        stuck-fault-aware permutation) drawn once per (tag, plan,
        deployment) and cached, at unit affine with a placeholder read
        key (``state_for`` stamps the serving ones)."""
        dep = self._deployment
        plan = self._plan_for(w, tag)
        ent = self._state_cache.get(tag) if tag else None
        if ent is not None and ent[0] is plan and ent[1] is dep:
            if OBS.enabled:
                OBS.counter("analog_state_cache_total",
                            "materialized device-state cache lookups",
                            tag=tag, event="hit").inc()
            return ent
        self._count_build("state", tag)
        if OBS.enabled:
            OBS.counter("analog_state_cache_total",
                        "materialized device-state cache lookups",
                        tag=tag or "<anon>", event="miss").inc()
        sc = dep.scenario
        ep = (self.emulator_params if self.acfg.backend == "emulator"
              else None)
        dev = plan.g_feat.device
        win = self._window(plan)
        with torch.no_grad():
            if sc is None or sc.is_ideal:
                # on a mesh the state's gf is the cached plan's window
                st = DeploymentState.ideal(plan, eparams=ep)
                if win is not None:
                    st = self._in_window(st.replace(
                        read_sigma=keep_window(st.read_sigma, win)
                    ).known_noise(False), plan)
                pplan = plan.with_perm(st.out_perm)
            else:
                t0 = time.perf_counter()
                key = self._tag_key(tag)
                # the draws and the remap cover the whole lattice (the
                # draw is mesh-invariant); a rank keeps its window below
                full = self._whole(plan, w)
                base, operm = full, torch.arange(plan.N, device=dev)
                if dep.remap and sc.has_stuck_off:
                    hz = dep.remap if isinstance(dep.remap, tuple) else None
                    base, operm = remap_plan(full, self.acfg, sc, key,
                                             horizon=hz)
                _sync(dev)
                t_remap = time.perf_counter() - t0
                pplan = perturb_plan(base, self.acfg, sc, key).with_perm(operm)
                rs = sc.read_sigma
                rsig = (rs.to(dev, torch.float32) if isinstance(rs, torch.Tensor)
                        else torch.tensor(rs, dtype=torch.float32, device=dev))
                sfeat = (self._scenario_features(dev)
                         if self.acfg.backend == "emulator"
                         and self.emulator_conditioned else None)
                st = DeploymentState.ideal(full, eparams=ep).replace(
                    gf=pplan.g_feat.float(),
                    read_sigma=rsig.expand(plan.NB, plan.NO).contiguous(),
                    out_perm=operm,
                    **({} if sfeat is None else {"sfeat": sfeat}))
                st.known_noise(sc.has_read_noise)
                if win is not None:
                    # this rank's window of the state, and of the
                    # perturbed plan (sharing the state's gf)
                    st = self.shard_state(st)
                    pplan = dataclasses.replace(
                        pplan, g_feat=st.gf,
                        g_norm=keep_window(pplan.g_norm, win))
                _sync(dev)
                self.materialize_s[tag] = (time.perf_counter() - t0, t_remap)
        ent = (plan, dep, st, pplan)
        if tag:
            self._state_cache[tag] = ent
        return ent

    def _base_state(self, tag: str, w: torch.Tensor) -> DeploymentState:
        """The deployment's device state for ``(tag, w)`` at unit affine."""
        return self._materialize(tag, w)[2]

    def _scenario_plan(self, tag: str, w: torch.Tensor) -> ConductancePlan:
        """The perturbed (and remapped) plan of ``_base_state``."""
        return self._materialize(tag, w)[3]

    def state_for(self, tag: str, w: torch.Tensor) -> DeploymentState:
        """The ready-to-serve state for ``(tag, w)``: the cached device
        state stamped with the tag's calibration affine and, when the
        corner draws read noise, a fresh read-cycle key.  Preloaded
        states (``deploy(states=...)``) are served verbatim."""
        dep = self._deployment
        if dep.states is not None and tag in dep.states:
            return self.shard_state(dep.states[tag])
        st = self._base_state(tag, w)
        a, b = self.calibration.get(tag, (1.0, 0.0))
        st = st.with_calibration(a, b)
        if dep.scenario is not None and dep.scenario.has_read_noise:
            st = st.with_read_key(self._next_read_key())
        return self.shard_state(st)

    def _read(self, st: DeploymentState) -> torch.Tensor:
        """One read cycle of the state's conductances: the read-noise draw
        of ``st.read_key`` applied to ``gf``.  Without read noise the draw
        is skipped -- the result is the same, the identity up to clamping
        the cells (g > 0) into [g_min, g_max], which a bf16 weight's
        rounded conductances can leave."""
        g = st.gf
        if not st.has_read_noise:
            return torch.where(g > 0.0, torch.clamp(g, self.acfg.g_min,
                                                    self.acfg.g_max), g)
        lat = st.window
        if lat is None:
            eps = _field_draw(g, st.read_key, tuple(g.shape[:2]), None)
        else:
            scheme, tp, t, nb, no = lat
            eps = _field_draw(g, st.read_key, (nb, no),
                              lattice_window(nb, no, tp, scheme, t))
        return apply_read_noise(g, self.acfg, st.read_sigma, eps)

    def _read_plan(self, w: torch.Tensor, tag: str,
                   st: DeploymentState) -> ConductancePlan:
        """The plan a matmul of ``tag`` serves ``st`` through: one read
        cycle of the state (``_read``) normalized by ``with_g``, with the
        state's output permutation.  It depends only on the tag's plan and
        the state, so the last one is kept per tag: the calls of one
        generate, which share a state and its read key, read it once."""
        plan = self._plan_for(w, tag)
        ent = self._read_cache.get(tag) if tag else None
        if ent is not None and ent[0] is plan and ent[1] is st:
            return ent[2]
        self._count_build("read", tag)
        if OBS.enabled:
            OBS.counter("analog_traces_total",
                        "read-plan builds of the per-tag forward (one per "
                        "newly served device state)", tag=tag or "<anon>").inc()
        rplan = plan.with_g(self._read(st), self.acfg).with_perm(st.out_perm)
        if tag:
            self._read_cache[tag] = (plan, st, rplan)
        return rplan

    # ------------------------------------------------------------------ #
    # Tensor-parallel serving
    # ------------------------------------------------------------------ #
    def _scheme_for(self, nb: int, no: int) -> Optional[str]:
        """Lattice-sharding scheme of a (NB, NO) plan on this executor's
        mesh: ``"auto"`` defers to ``lattice_scheme`` (col preferred); a
        forced scheme must divide the axis it shards."""
        _, tp = mesh_shape(self.mesh)
        if tp <= 1:
            return None
        if self.shard_scheme == "auto":
            return lattice_scheme(nb, no, tp)
        s = None if self.shard_scheme == "none" else self.shard_scheme
        if s not in (None, "row", "col"):
            raise ValueError(f"shard_scheme={self.shard_scheme!r} "
                             "(expected 'auto', 'row', 'col' or 'none')")
        if s == "col" and no % tp:
            raise ValueError(
                f"shard_scheme='col' needs NO % tp == 0 (NO={no}, tp={tp})")
        if s == "row" and nb % tp:
            raise ValueError(
                f"shard_scheme='row' needs NB % tp == 0 (NB={nb}, tp={tp})")
        return s

    def _window(self, plan: ConductancePlan) -> Optional[Tuple[slice, slice]]:
        """This rank's window of ``plan``'s lattice; None off a mesh or
        where the lattice replicates."""
        if self.mesh is None:
            return None
        scheme = self._scheme_for(plan.NB, plan.NO)
        if scheme is None:
            return None
        _, tp = mesh_shape(self.mesh)
        _, t = mesh_coords(self.mesh)
        return lattice_window(plan.NB, plan.NO, tp, scheme, t)

    def _in_window(self, st: DeploymentState,
                   plan: ConductancePlan) -> DeploymentState:
        """Mark ``st``, whose lattice fields already hold this rank's
        window of ``plan``'s lattice, as ``shard_state`` would."""
        _, tp = mesh_shape(self.mesh)
        _, t = mesh_coords(self.mesh)
        return st.in_window((self._scheme_for(plan.NB, plan.NO), tp, t,
                             plan.NB, plan.NO))

    def _whole(self, plan: ConductancePlan, w: torch.Tensor
               ) -> ConductancePlan:
        """The whole lattice's plan of a cached one: the plan itself, or,
        where a rank caches only its window, the weight tiled anew (kept
        only while a corner is drawn or a fleet resolves its base)."""
        if self._window(plan) is None:
            return plan
        with torch.no_grad():
            return build_conductance_plan(w.detach(), self.acfg, self.geom)

    def shard_state(self, st: DeploymentState) -> DeploymentState:
        """This rank's window of a state's lattice fields on the serving
        mesh (the state itself without one).  Idempotent, and a state
        loaded from an npz -- saved under any mesh shape, or none -- is
        sliced anew."""
        if self.mesh is None:
            return st
        lat = st.window
        nb, no = lat[3:] if lat is not None else tuple(st.gf.shape[:2])
        return shard_deployment_state(st, self.mesh,
                                      self._scheme_for(int(nb), int(no)))

    def shard_states(self, states: Dict[str, DeploymentState]
                     ) -> Dict[str, DeploymentState]:
        """``shard_state`` over a per-site state dict."""
        return {k: self.shard_state(v) for k, v in states.items()}

    def gather_states(self, states: Dict[str, DeploymentState]
                      ) -> Dict[str, DeploymentState]:
        """The full states of windowed ones (every rank of the model axis
        calls it): what ``save_deployment`` writes under a mesh."""
        if self.mesh is None:
            return states
        return {k: gather_deployment_state(v, self.mesh)
                for k, v in states.items()}

    @contextlib.contextmanager
    def _timed(self, name: str, device: torch.device):
        """Synchronized milliseconds of the block into ``mesh_times``."""
        if self.mesh_times is None:
            yield
            return
        _sync(device)
        t0 = time.perf_counter()
        yield
        _sync(device)
        self.mesh_times.setdefault(name, []).append(
            (time.perf_counter() - t0) * 1e3)

    def _sharded_matmul(self, x2d: torch.Tensor, x_scale: torch.Tensor,
                        plan: ConductancePlan, eparams: Optional[dict],
                        sfeat: Optional[torch.Tensor]) -> torch.Tensor:
        """``raw_matmul``'s body, on a (data, model) mesh or none: this
        rank's rows of ``x2d`` (zero rows pad the batch to a multiple of
        dp) on its window of the lattice, then the collectives.  Without
        a mesh the rows and the window are the whole and no collective
        runs.  ``plan`` holds the whole lattice's geometry; its fields may
        hold the whole lattice (sliced here) or this rank's window
        already (a cached plan or a sharded state's read plan).  The drive
        scale ``x_scale`` is the whole call's.  B1's tile is tuned off a
        mesh only: a rank's window is a shape the tuner never measured.
        Returns the volts (B, N), output permutation applied."""
        mesh = self.mesh
        dp, tp = mesh_shape(mesh)
        d, t = mesh_coords(mesh)
        scheme = self._scheme_for(plan.NB, plan.NO)
        nb_l, no_l = local_lattice(plan.NB, plan.NO, tp, scheme)
        win = lattice_window(plan.NB, plan.NO, tp, scheme, t)
        lp = plan                   # the lattice this rank evaluates
        if (nb_l, no_l) != (plan.NB, plan.NO):
            gf, gn = plan.g_feat, plan.g_norm
            if tuple(gf.shape[:2]) != (nb_l, no_l):
                gf, gn = gf[win], gn[win]
            lp = plan.with_lattice(gf.contiguous(), self.acfg, NB=nb_l,
                                   NO=no_l, g_norm=gn.contiguous())
        if sfeat is not None and sfeat.dim() == 3 \
                and tuple(sfeat.shape[:2]) != (nb_l, no_l):
            sfeat = sfeat[win]
        B, dev = x2d.shape[0], x2d.device
        if current_mesh() is not None:   # a training mesh: the rows are
            dp, d = 1, 0                 # this rank's already
        rl = -(-B // dp)
        xl = x2d[d * rl:(d + 1) * rl]
        if xl.shape[0] < rl:
            xl = torch.cat([xl, xl.new_zeros((rl - xl.shape[0], xl.shape[1]))])
        if self.acfg.backend == "emulator" and self.fast_path:
            u = plan.tile_v(self._drive01(torch.abs(xl) / x_scale), 1.0)
            pos = plan.tile_v((xl > 0).float(), 1.0)
            with self._timed("b1", dev):
                outs = self._b1(lp.g_norm, u[:, win[0]], pos[:, win[0]],
                                eparams, sfeat, tune=mesh is None)
            outs = outs.reshape(-1, outs.shape[-1])     # rails stacked
        else:
            rails = torch.cat([torch.clamp_min(xl, 0.0),
                               torch.clamp_min(-xl, 0.0)], dim=0)
            vb01 = plan.tile_v(self._drive01(rails / x_scale), 1.0)[:, win[0]]
            outs = self._eval_blocks(lp, vb01.float(), eparams, sfeat)
        # (rail, row, this rank's columns), its block groups summed: each
        # column in the same order whatever the rows (``sum_block_groups``)
        s = lp.group_sum(outs).reshape(2, rl, -1)
        if mesh is None:
            y = s[0] - s[1]
        else:
            y = self._collect(s, plan, scheme, B, rl, no_l)
        if plan.out_perm is not None:
            return torch.index_select(y, 1, plan.out_perm)
        return y[:, :plan.N]

    def _collect(self, s, plan: ConductancePlan, scheme: Optional[str],
                 B: int, rl: int, no_l: int) -> torch.Tensor:
        """The mesh's collectives on this rank's rail sums ``s``: the
        whole block-group sum of every column over ``model``, then every
        row over ``data`` -> the (B, NO*no) volts."""
        import torch.distributed as dist
        mesh, dev = self.mesh, s[0].device
        dp, tp = mesh_shape(mesh)
        d, t = mesh_coords(mesh)
        if current_mesh() is not None:
            dp = 1
        cols = plan.NO * plan.no
        with self._timed("all_reduce", dev):
            if scheme == "col":
                # -0.0 is the sum's identity: x + -0.0 is x, bit for bit
                y = torch.full((rl, cols), -0.0, device=dev)
                a = t * no_l * plan.no
                y[:, a:a + no_l * plan.no] = s[0] - s[1]
                dist.all_reduce(y, group=mesh.get_group(MODEL_AXIS))
            elif scheme == "row":
                # every rank's partial sums, then the tree's last levels
                # here: the bits of the whole sum when each rank holds a
                # power-of-two run of block groups (``sum_block_groups``)
                parts = torch.full((2, rl, tp, cols), -0.0, device=dev)
                parts[:, :, t] = s
                dist.all_reduce(parts, group=mesh.get_group(MODEL_AXIS))
                y = sum_block_groups(parts[0]) - sum_block_groups(parts[1])
            else:
                y = s[0] - s[1]
            if dp > 1:
                rows = torch.full((rl * dp, cols), -0.0, device=dev)
                rows[d * rl:(d + 1) * rl] = y
                dist.all_reduce(rows, group=mesh.get_group(DATA_AXIS))
                y = rows[:B]
        return y

    def _cp_effective(self) -> CircuitParams:
        """CircuitParams with the scenario's line-resistance scaling."""
        if self.scenario is not None:
            return scenario_circuit_params(self.cp, self.scenario)
        return self.cp

    # ------------------------------------------------------------------ #
    def calibration_budget(self, tag: str, n: int, warm_start: bool) -> int:
        """The reference's probe count for a fit of ``tag``: ``n`` cold,
        half of it (at least 8) when a warm start has a previous affine
        to transfer."""
        if warm_start and tag in self.calibration:
            return max(8, n // 2)
        return n

    @torch.no_grad()
    def calibrate(self, xc: torch.Tensor, w: torch.Tensor, tag: str,
                  warm_start: bool = False,
                  noise_draws: int = 4) -> Tuple[float, float]:
        """Fit the per-layer affine volts->logical map against digital on
        the probe matrix ``xc`` (n, K), through the same forward the
        tag's matmuls run, on the deployment's device state at unit
        affine.

        The reference draws ``xc`` itself (``normal * 0.5``, 256 rows
        cold, 128 warm); here the caller passes it, so both packages can
        fit on the same probes.  Noise-aware: under a corner with read
        noise the response is averaged over ``noise_draws`` read cycles,
        so the affine targets the expected transfer.  ``warm_start=True``
        transfers the previous affine: a ridge prior toward it, one
        synthetic row per parameter weighted at ~5% of the probes'
        leverage on that parameter (sum yv^2 for the scale, the row
        count for the offset); without a previous affine the fit is
        cold.  The probe count used is recorded in ``_last_calib_n``."""
        prev = self.calibration.get(tag) if warm_start else None
        xc = xc.float()
        st = self._base_state(tag, w)         # unit affine by construction
        sc = self.scenario
        draws = (max(1, noise_draws)
                 if sc is not None and sc.has_read_noise else 1)
        keys = prng.split(prng.fold_in(self.scenario_key, 0xCA11B), draws)
        ys = torch.stack([_STMatmul.apply(self, tag, xc, w,
                                          st.with_read_key(k))
                          for k in keys]).mean(dim=0)
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
        # on the CPU, torch's default LAPACK routine (gelsy) can round its
        # last bits differently on two calls with the same inputs; gelsd (an
        # SVD, as jnp.linalg.lstsq) does not.  CUDA has only gels.
        sol = torch.linalg.lstsq(
            A, rhs[:, None],
            driver="gelsd" if A.device.type == "cpu" else None).solution[:, 0]
        if OBS.enabled:
            # RMS residual of the fit over the probe rows (prior rows
            # excluded), read to the host with the affine in one transfer
            res = yv_flat * sol[0] + sol[1] - yd_flat
            a, b, rms = torch.cat([sol, torch.sqrt(torch.mean(res * res))[None]]
                                  ).tolist()
            OBS.gauge("analog_calibration_residual",
                      "RMS residual of the volts->logical affine fit",
                      tag=tag).set(rms)
            OBS.gauge("analog_calibration_probes",
                      "probe budget used by the last calibration fit",
                      tag=tag).set(xc.shape[0])
            OBS.counter("analog_calibrations_total",
                        "calibration fits per tag and start mode", tag=tag,
                        mode="warm" if prev is not None else "cold").inc()
        else:
            a, b = sol.tolist()
        self.calibration[tag] = (a, b)
        self._last_calib_n = xc.shape[0]
        return self.calibration[tag]

    # ------------------------------------------------------------------ #
    def _plan_for(self, w: torch.Tensor, tag: str) -> ConductancePlan:
        """Tile/pad/interleave once per bound weight; rebuilt when the tag
        is rebound to a different tensor or the weight was updated in
        place (another view of the same elements at the same version is
        the same weight, ``_same_weight``).  Where a mesh shards the
        tag's lattice, the cached plan holds only this rank's window of
        ``g_feat`` / ``g_norm`` (``_whole`` tiles the whole one again)."""
        ent = self._plans.get(tag) if tag else None
        if ent is not None and _same_weight(ent[0], ent[1], w):
            if OBS.enabled:
                OBS.counter("analog_plan_cache_total",
                            "conductance-plan cache lookups per weight tag",
                            tag=tag, event="hit").inc()
            return ent[2]
        self._count_build("plan", tag)
        if OBS.enabled:
            OBS.counter("analog_plan_cache_total",
                        "conductance-plan cache lookups per weight tag",
                        tag=tag or "<anon>", event="miss").inc()
        with torch.no_grad():
            plan = build_conductance_plan(w.detach(), self.acfg, self.geom)
            win = self._window(plan)
            if win is not None:
                # a rank keeps its window of the lattice (the geometry
                # stays the whole plan's)
                plan = dataclasses.replace(
                    plan, g_feat=keep_window(plan.g_feat, win),
                    g_norm=keep_window(plan.g_norm, win))
        if tag:
            self._plans[tag] = (w, w._version, plan)
        return plan

    def cache_bytes(self) -> Tuple[int, int]:
        """(bytes of the cached conductance plans, bytes of every tensor
        the plan, state and read-plan caches hold), each storage once."""
        seen, plans, total = set(), 0, 0
        caches = ((self._plans, lambda e: (e[2].g_feat, e[2].g_norm)),
                  (self._state_cache, lambda e: (e[2].gf, e[3].g_feat,
                                                 e[3].g_norm)),
                  (self._read_cache, lambda e: (e[2].g_feat, e[2].g_norm)))
        for i, (cache, tensors) in enumerate(caches):
            for ent in cache.values():
                for t in tensors(ent):
                    key = t.untyped_storage().data_ptr()
                    if key in seen:
                        continue
                    seen.add(key)
                    n = t.untyped_storage().nbytes()
                    total += n
                    plans += n if i == 0 else 0
        return plans, total

    def _count_build(self, kind: str, tag: str) -> None:
        per_tag = self.builds[kind]
        key = tag or "<anon>"
        per_tag[key] = per_tag.get(key, 0) + 1

    def _blocklast_aux(self, eparams: Optional[dict] = None) -> dict:
        """Stage-collapsed emulator weights, cached per params binding."""
        params = self.emulator_params if eparams is None else eparams
        if self._aux is None or self._aux_src is not params:
            with torch.no_grad():
                self._aux = conv4xbar.blocklast_weights(params, self.geom)
            self._aux_src = params
        return self._aux

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
        cp = self._cp_effective()
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

    def _b1(self, g_norm: torch.Tensor, u: torch.Tensor, pos: torch.Tensor,
            eparams: Optional[dict], sfeat: Optional[torch.Tensor],
            tune: bool = True) -> torch.Tensor:
        """B1 on both rails of every (row, block) of ``g_norm``, with a
        conditioned net's fc0 shift (``fc0_shift``) -> (2, M*blocks, O)."""
        aux = self._blocklast_aux(eparams)
        shift = None
        if sfeat is not None and "f0_scen" in aux:
            shift = fc0_shift(sfeat, aux["f0_scen"])
        return emulator_block_unified(aux, g_norm.contiguous(),
                                      u.contiguous(), pos.contiguous(),
                                      shift=shift, tune=tune)

    def _unified(self, plan: ConductancePlan, g_norm: torch.Tensor,
                 x2d: torch.Tensor, x_scale: torch.Tensor,
                 eparams: Optional[dict], sfeat: Optional[torch.Tensor]
                 ) -> torch.Tensor:
        """The fast path's B1 call on the plan's drive of ``x2d``."""
        u = plan.tile_v(self._drive01(torch.abs(x2d) / x_scale), 1.0)
        pos = plan.tile_v((x2d > 0).float(), 1.0)
        return self._b1(g_norm, u, pos, eparams, sfeat)

    def raw_matmul(self, x2d: torch.Tensor, w: torch.Tensor, tag: str = "",
                   plan: Optional[ConductancePlan] = None,
                   read_key=None, read_sigma=None,
                   eparams: Optional[dict] = None,
                   sfeat: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Analog forward for (B,K) @ (K,N), in volts (uncalibrated), and
        the drive scale ``max|x|`` of the whole call.

        ``plan`` overrides the tag's plan (the forward passes the
        deployment state's perturbed, possibly remapped, read plan); with
        ``plan=None`` and an active corner the tag's cached device draw is
        used, with the next read cycle's noise and, for a conditioned
        net, the corner's features.  ``read_key``/``read_sigma`` add one
        read-noise draw on top of the plan in effect.  ``sfeat`` is the
        scenario encoding a conditioned emulator consumes: a per-tile
        ``(NB, NO, F)`` lattice becomes one fc0 shift per block, in
        lattice order."""
        if self.acfg.backend == "digital":
            raise ValueError("the digital backend has no analog forward")
        if plan is None:
            plan = self._plan_for(w, tag)
            sc = self.scenario
            if sc is not None and not sc.is_ideal:
                plan = self._scenario_plan(tag, w)
                if read_key is None and sc.has_read_noise:
                    read_key, read_sigma = self._next_read_key(), sc.read_sigma
                if sfeat is None and self.acfg.backend == "emulator" \
                        and eparams is None and self.emulator_conditioned:
                    sfeat = self._scenario_features(plan.g_feat.device)
        if read_key is not None:
            g = plan.g_feat.float()
            rs = 0.0 if read_sigma is None else read_sigma
            win = (None if tuple(g.shape[:2]) == (plan.NB, plan.NO)
                   else self._window(plan))
            eps = _field_draw(g, read_key, (plan.NB, plan.NO), win)
            if win is not None and isinstance(rs, torch.Tensor) \
                    and rs.dim() == 2:
                rs = rs[win]
            plan = plan.with_g(apply_read_noise(g, self.acfg, rs, eps),
                               self.acfg)
        x2d = x2d.float()
        x_max = torch.max(torch.abs(x2d))
        if current_mesh() is not None:
            from repro_torch.parallel.train_mesh import data_max
            x_max = data_max(x_max, current_mesh())
        x_scale = torch.clamp_min(x_max, 1e-9)
        return self._sharded_matmul(x2d, x_scale, plan, eparams,
                                    sfeat), x_scale

    def raw_matmul_many(self, x2d: torch.Tensor, w: torch.Tensor, tag: str,
                        g_read: torch.Tensor,
                        eparams: Optional[dict] = None,
                        sfeat: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``raw_matmul`` of the same rows under C device states at once:
        ``g_read`` (C, NB, NO, D, H, W) holds each state's read
        conductances (after its read draw) on the tag's plan layout, with
        no output permutation.  The states stack along the output-group
        axis into one (NB, C*NO) lattice -- one B1 launch on the fast
        path -- and each state's block outputs are summed over block
        groups in a fixed order.  ``sfeat`` is a conditioned net's
        encoding: one (F,) for all states, or (C, NB, NO, F), one a tile
        of each.  Returns the volts (C, B, N) and ``max|x|``."""
        if self.acfg.backend == "digital":
            raise ValueError("the digital backend has no analog forward")
        plan = self._plan_for(w, tag)
        C, NB, NO = g_read.shape[0], plan.NB, plan.NO
        sp = plan.with_lattice(
            g_read.transpose(0, 1).reshape((NB, C * NO) + g_read.shape[3:]),
            self.acfg, NO=C * NO)
        if sfeat is not None and sfeat.dim() > 1:
            sfeat = sfeat.transpose(0, 1).reshape(NB, C * NO, sfeat.shape[-1])
        B = x2d.shape[0]
        x2d = x2d.float()
        x_scale = torch.clamp_min(torch.max(torch.abs(x2d)), 1e-9)
        if self.acfg.backend == "emulator" and self.fast_path:
            y2 = self._unified(plan, sp.g_norm, x2d, x_scale, eparams, sfeat)
            return (self._assemble_many(plan, y2[0], C)
                    - self._assemble_many(plan, y2[1], C)), x_scale
        rails = torch.cat([torch.clamp_min(x2d, 0.0),
                           torch.clamp_min(-x2d, 0.0)], dim=0)
        vb01 = plan.tile_v(self._drive01(rails / x_scale), 1.0)
        y = self._assemble_many(
            plan, self._eval_blocks(sp, vb01.float(), eparams, sfeat), C)
        return y[:, :B] - y[:, B:], x_scale

    @staticmethod
    def _assemble_many(plan: ConductancePlan, outs: torch.Tensor,
                       C: int) -> torch.Tensor:
        """(M*NB*C*NO, no) block outputs of C stacked states -> (C, M, N),
        block groups summed in ``plan.assemble``'s order."""
        M = outs.shape[0] // (plan.NB * C * plan.NO)
        y = outs.reshape(M, plan.NB, C, plan.NO * plan.no)[..., :plan.N]
        return sum_block_groups(y).transpose(0, 1)

    def matmul(self, x: torch.Tensor, w: torch.Tensor, tag: str = "",
               state: Optional[DeploymentState] = None) -> torch.Tensor:
        """Calibrated analog matmul with straight-through digital gradient;
        ``state`` overrides the tag's ideal state."""
        lead = x.shape[:-1]
        key = tag or "<anon>"
        # the port runs every call eagerly (mode "eager"); the span times
        # the host until the launches return, not the card: no
        # synchronization is added here
        with OBS.span("analog_matmul", "analog matmul host-side latency: "
                      "the host's time to enqueue the call's launches (no "
                      "device sync)", tag=key, mode="eager"):
            x2 = x.reshape(-1, x.shape[-1]).float()
            st = state if state is not None else self.state_for(tag, w)
            y = _STMatmul.apply(self, tag, x2, w, st)
            y = y.reshape(*lead, w.shape[1]).to(x.dtype)
        self.calls[key] = self.calls.get(key, 0) + 1
        if OBS.enabled:
            OBS.counter("analog_matmul_calls_total",
                        "analog matmul calls per tag and dispatch mode",
                        tag=key, mode="eager").inc()
        return y

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
