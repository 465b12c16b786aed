"""Device non-ideality scenarios (port of ``repro.nonideal.scenario``):
what can go wrong between the weights you wanted and the conductances
the crossbar actually reads.

A ``Scenario`` is a frozen dataclass.  Its numeric leaves are Python
floats (ints for ``n_levels``) for one corner of the whole plan, or
``(NB, NO)`` tensors -- one value per (block-group, output-group) tile of
a ``ConductancePlan`` (``tile_scenarios``) -- or ``(n,)`` tensors of n
sampled corners (``nonideal.data.sample_scenarios``).  ``name`` and
``r_line_scale`` are whole-plan values.

Fields (composition order as in ``nonideal.perturb``):
  n_levels     -- quantized programming levels over [g_min, g_max]
                  (0 or 1 = continuous programming)
  prog_sigma   -- lognormal programming variation g <- g * exp(sigma * eps)
  drift_nu     -- retention drift g <- g * (t / t0)^-nu (clipped to range)
  drift_t      -- seconds since programming (0 = no drift)
  drift_t0     -- drift reference time
  p_stuck_on   -- fraction of cells stuck at g_max
  p_stuck_off  -- fraction of cells stuck at g_min
  read_sigma   -- cycle-to-cycle multiplicative read noise, one draw per
                  read cycle (a ``DeploymentState``'s read key)
  r_line_scale -- bitline resistance multiplier (circuit solver only)

Every perturbation is an exact identity at its ideal value.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_LEAF_FIELDS: Tuple[str, ...] = (
    "prog_sigma", "read_sigma", "p_stuck_on", "p_stuck_off",
    "drift_nu", "drift_t", "drift_t0", "n_levels",
)


def _leaf_dtype(f: str) -> torch.dtype:
    return torch.int32 if f == "n_levels" else torch.float32


def _leaf_tensor(v, f: str) -> torch.Tensor:
    """A leaf value (scalar, list, numpy array or tensor) as a tensor of
    the leaf's dtype."""
    if isinstance(v, torch.Tensor):
        return v.to(_leaf_dtype(f))
    return torch.as_tensor(np.asarray(v), dtype=_leaf_dtype(f))


def _leaf_max(v) -> float:
    """Max of a leaf; a Python scalar stays pure Python (no device sync)."""
    if isinstance(v, (int, float)):
        return float(v)
    return float(v.max())


def _leaf_min(v) -> float:
    if isinstance(v, (int, float)):
        return float(v)
    return float(v.min())


@dataclass(frozen=True)
class Scenario:
    """One device non-ideality corner (see the module docstring).
    Frozen: derive variants with ``dataclasses.replace`` (e.g. aging by
    rewriting ``drift_t``, as ``lifetime.scenario_at_age`` does)."""
    name: str = "ideal"
    prog_sigma: float = 0.0
    read_sigma: float = 0.0
    p_stuck_on: float = 0.0
    p_stuck_off: float = 0.0
    drift_nu: float = 0.0
    drift_t: float = 0.0
    drift_t0: float = 1.0
    r_line_scale: float = 1.0
    n_levels: int = 0

    def __post_init__(self):
        # scalars become Python float / int, arrays tensors of the leaf's
        # dtype: Scenario(prog_sigma=0) equals Scenario(prog_sigma=0.0)
        for f in _LEAF_FIELDS:
            v = getattr(self, f)
            if isinstance(v, (torch.Tensor, np.ndarray, list, tuple)):
                object.__setattr__(self, f, _leaf_tensor(v, f))
            elif isinstance(v, (bool, int, float, np.number)):
                object.__setattr__(
                    self, f, int(v) if f == "n_levels" else float(v))
        object.__setattr__(self, "r_line_scale", float(self.r_line_scale))

    @property
    def tile_shape(self) -> Optional[Tuple[int, ...]]:
        """``(NB, NO)`` for a tile-indexed batch, None for a scalar corner.
        All non-scalar leaves must agree in shape."""
        shapes = {tuple(getattr(self, f).shape) for f in _LEAF_FIELDS
                  if isinstance(getattr(self, f), torch.Tensor)
                  and getattr(self, f).dim() > 0}
        if not shapes:
            return None
        if len(shapes) > 1:
            raise ValueError(f"inconsistent per-tile leaf shapes: "
                             f"{sorted(shapes)}")
        return shapes.pop()

    def _cached(self, name: str, fn):
        c = self.__dict__.get(name)
        if c is None:
            c = fn()
            object.__setattr__(self, name, c)
        return c

    @property
    def is_ideal(self) -> bool:
        """True iff every perturbation is an exact identity (at every
        tile); computed once per Scenario object."""
        return self._cached("_is_ideal", lambda: (
            _leaf_max(self.prog_sigma) == 0.0
            and _leaf_max(self.read_sigma) == 0.0
            and _leaf_max(self.p_stuck_on) == 0.0
            and _leaf_max(self.p_stuck_off) == 0.0
            and ((_leaf_max(self.drift_nu) == 0.0
                  and _leaf_min(self.drift_nu) == 0.0)
                 or _leaf_max(self.drift_t) <= 0.0)
            and self.r_line_scale == 1.0
            and _leaf_max(self.n_levels) < 2))

    @property
    def has_read_noise(self) -> bool:
        """True if any tile draws cycle-to-cycle read noise (cached)."""
        return self._cached("_has_read_noise",
                            lambda: _leaf_max(self.read_sigma) > 0.0)

    @property
    def has_stuck_off(self) -> bool:
        """True if any tile has a nonzero stuck-at-G_off rate (cached) --
        the trigger for fault-aware remapping."""
        return self._cached("_has_stuck_off",
                            lambda: _leaf_max(self.p_stuck_off) > 0.0)


# --------------------------------------------------------------------------- #
# Per-tile scenario batches
# --------------------------------------------------------------------------- #
def tile_scenarios(nb: int, no: int, base: Optional[Scenario] = None,
                   *, name: Optional[str] = None, **fields) -> Scenario:
    """A ``(nb, no)``-tile-indexed scenario batch: every numeric leaf
    broadcast to an ``(nb, no)`` tensor, one value per tile of a
    ``ConductancePlan``.  ``fields`` override ``base`` per leaf and may be
    scalars or anything broadcastable to ``(nb, no)``.  ``r_line_scale``
    stays a whole-plan value."""
    base = base if base is not None else Scenario(name="tiled")
    kw = {}
    for f in _LEAF_FIELDS:
        v = fields.pop(f, getattr(base, f))
        kw[f] = _leaf_tensor(v, f).expand(nb, no).contiguous()
    if fields:
        raise TypeError(f"unknown Scenario fields: {sorted(fields)}")
    return Scenario(name=name or base.name,
                    r_line_scale=base.r_line_scale, **kw)


def collapse_tiles(s: Scenario) -> Scenario:
    """Mean-field scalar Scenario from a tile-indexed batch (identity for
    a scalar scenario)."""
    if s.tile_shape is None:
        return s
    kw = {}
    for f in _LEAF_FIELDS:
        m = float(torch.mean(_f32(getattr(s, f))))
        kw[f] = int(round(m)) if f == "n_levels" else m
    return Scenario(name=s.name, r_line_scale=s.r_line_scale, **kw)


# --------------------------------------------------------------------------- #
# Scenario feature encoding (the conditioned emulator's corner descriptor)
# --------------------------------------------------------------------------- #
# The ordering is part of the trained-params contract: a conditioned
# Conv4Xbar's fc0 rows are bound to these positions (append-only).  Every
# feature is exactly 0.0 at the ideal corner.
SCENARIO_FEATURE_NAMES: Tuple[str, ...] = (
    "prog_sigma_mean", "prog_sigma_max",
    "read_sigma_mean", "read_sigma_max",
    "p_stuck_on_mean", "p_stuck_on_max",
    "p_stuck_off_mean", "p_stuck_off_max",
    "drift_nu_mean", "drift_nu_max",
    "drift_age",          # log1p(mean(drift_t / drift_t0)) / 16
    "r_line_scale_m1",    # r_line_scale - 1
    "quant_inv",          # 2 / n_levels for n_levels >= 2, else 0
)
N_SCENARIO_FEATURES = len(SCENARIO_FEATURE_NAMES)

# drift_age normalizer: log1p(1 month / 1 s) ~= 14.8
_DRIFT_AGE_SCALE = 16.0


def _f32(v, device=None) -> torch.Tensor:
    """A leaf as float32, on ``device`` (default: a tensor leaf's own)."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(device, torch.float32)
    return torch.tensor(v, dtype=torch.float32, device=device)


def _leaf_device(s: "Scenario") -> torch.device:
    """The device of the scenario's first tensor leaf; the CPU if it has
    none.  Its encodings are computed and returned there."""
    for f in _LEAF_FIELDS:
        v = getattr(s, f)
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def _quant(nl: torch.Tensor) -> torch.Tensor:
    return torch.where(nl >= 2.0, 2.0 / torch.clamp_min(nl, 2.0),
                       torch.zeros_like(nl))


def _age(t: torch.Tensor, t0: torch.Tensor) -> torch.Tensor:
    return torch.log1p(t / torch.clamp_min(t0, 1e-30)) / _DRIFT_AGE_SCALE


def scenario_features(s: Scenario) -> torch.Tensor:
    """The fixed-length ``(N_SCENARIO_FEATURES,)`` float32 vector a
    conditioned emulator consumes (layout: ``SCENARIO_FEATURE_NAMES``),
    on the device of the scenario's tensor leaves (the CPU for a scalar
    corner).  Per-tile leaves reduce to (mean, max); scalar leaves to
    themselves, so a scalar corner and its uniform tile batch encode
    identically.  The ideal scenario encodes to zeros."""
    dev = _leaf_device(s)

    def mean(v):
        return torch.mean(_f32(v, dev))

    def mx(v):
        return torch.max(_f32(v, dev))

    return torch.stack([
        mean(s.prog_sigma), mx(s.prog_sigma),
        mean(s.read_sigma), mx(s.read_sigma),
        mean(s.p_stuck_on), mx(s.p_stuck_on),
        mean(s.p_stuck_off), mx(s.p_stuck_off),
        mean(s.drift_nu), mx(s.drift_nu),
        _age(mean(s.drift_t), mean(s.drift_t0)),
        _f32(s.r_line_scale - 1.0, dev),
        _quant(mx(s.n_levels)),
    ])


def scenario_features_tiled(s: Scenario, nb: Optional[int] = None,
                            no: Optional[int] = None) -> torch.Tensor:
    """Per-tile feature operand: an ``(NB, NO, N_SCENARIO_FEATURES)``
    float32 lattice on the device of the scenario's tensor leaves, each
    tile encoded as a scalar corner of its own values (its mean equals its
    max).  Scalar scenarios broadcast to the
    lattice given ``nb``/``no``; the ideal corner encodes to zeros."""
    shape = s.tile_shape
    if shape is None:
        if nb is None or no is None:
            raise ValueError("scalar scenario needs explicit (nb, no)")
        shape = (int(nb), int(no))

    dev = _leaf_device(s)

    def bc(v):
        return _f32(v, dev).expand(shape)

    ps, rs = bc(s.prog_sigma), bc(s.read_sigma)
    on, off = bc(s.p_stuck_on), bc(s.p_stuck_off)
    nu = bc(s.drift_nu)
    rline = torch.full(shape, s.r_line_scale - 1.0, dtype=torch.float32,
                       device=dev)
    return torch.stack([ps, ps, rs, rs, on, on, off, off, nu, nu,
                        _age(bc(s.drift_t), bc(s.drift_t0)), rline,
                        _quant(bc(s.n_levels))], dim=-1)


# --------------------------------------------------------------------------- #
# String-keyed registry + JSON
# --------------------------------------------------------------------------- #
_REGISTRY: Dict[str, Scenario] = {}


def register_scenario(s: Scenario, overwrite: bool = False) -> Scenario:
    """Add ``s`` to the registry under ``s.name``; refuses a silent
    overwrite."""
    if s.name in _REGISTRY and not overwrite:
        raise ValueError(f"scenario {s.name!r} already registered "
                         f"(pass overwrite=True to replace)")
    _REGISTRY[s.name] = s
    return s


def get_scenario(name: str) -> Scenario:
    """A registered scenario by name (what ``AnalogConfig.scenario`` and
    ``serve --scenario`` resolve through)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def list_scenarios() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _json_default(o):
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().numpy().tolist()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def scenario_to_json(s: Scenario) -> str:
    """Canonical JSON (sorted keys; per-tile leaves as nested lists), the
    reference's encoding.  Inverse of ``scenario_from_json``."""
    d = {f.name: getattr(s, f.name) for f in dataclasses.fields(Scenario)}
    return json.dumps(d, sort_keys=True, default=_json_default)


def scenario_from_json(doc: str) -> Scenario:
    """Parse ``scenario_to_json`` output; rejects unknown fields.  Lists
    become per-tile tensor leaves."""
    d = json.loads(doc)
    known = {f.name for f in dataclasses.fields(Scenario)}
    bad = set(d) - known
    if bad:
        raise ValueError(f"unknown Scenario fields in JSON: {sorted(bad)}")
    return Scenario(**d)


# Built-in corners; "stressed" is the serving-overhead scenario.
BUILTIN_SCENARIOS: Tuple[Scenario, ...] = (
    Scenario(name="ideal"),
    Scenario(name="prog_mild", prog_sigma=0.03),
    Scenario(name="prog_heavy", prog_sigma=0.12),
    Scenario(name="read_noisy", read_sigma=0.05),
    Scenario(name="stuck_1pct", p_stuck_on=0.005, p_stuck_off=0.005),
    Scenario(name="quantized_16", n_levels=16),
    Scenario(name="drift_1day", drift_nu=0.05, drift_t=86_400.0),
    Scenario(name="ir_degraded", r_line_scale=4.0),
    Scenario(name="stressed", prog_sigma=0.08, read_sigma=0.03,
             p_stuck_on=0.002, p_stuck_off=0.005,
             drift_nu=0.03, drift_t=3_600.0, n_levels=32),
)
for _s in BUILTIN_SCENARIOS:
    register_scenario(_s)
del _s
