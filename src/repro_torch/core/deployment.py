"""DeploymentState: everything one analog matmul needs about the deployed
device, as one immutable bundle (port of ``repro.core.deployment``).

  * ``DeploymentState`` -- the per-site bundle the executor's forward
    consumes: perturbed conductances, read-noise sigma and key, the
    fault-remap permutation, emulator params, the scenario encoding and
    the calibration affine.  ``ideal()`` leaves sit at their
    exact-identity values.
  * ``Deployment`` -- the immutable executor-level spec (scenario, fleet
    key, remap policy, hot-swapped params, preloaded states) that
    ``AnalogExecutor.deploy`` builds.
  * ``save_deployment`` / ``load_deployment`` -- the reference's npz
    format (``<tag>::<field>``, ``__eparams::<k>``, ``__deployment_spec``),
    read and written by both packages.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import prng
from repro_torch.nonideal.scenario import N_SCENARIO_FEATURES

_STATE_FIELDS: Tuple[str, ...] = (
    "gf", "read_sigma", "read_key", "out_perm", "eparams", "sfeat",
    "cal_a", "cal_b",
)


@dataclass(frozen=True)
class DeploymentState:
    """Per-site deployed-device state.

      gf          -- (NB, NO, D, H, W) perturbed raw conductances, float32
                     (remapped group layout when ``out_perm`` moves groups)
      read_sigma  -- (NB, NO) per-tile read-noise sigma (zeros = identity)
      read_key    -- uint32[2] numpy key of this read cycle's draw
                     (``core.prng``; kept on the host)
      out_perm    -- (N,) int64 logical->physical output gather
      eparams     -- emulator params (``{}`` for the other backends)
      sfeat       -- (N_SCENARIO_FEATURES,) scalar-corner or
                     (NB, NO, N_SCENARIO_FEATURES) per-tile encoding
                     (zeros = ideal)
      cal_a/cal_b -- the volts->logical calibration affine
    """
    gf: torch.Tensor
    read_sigma: torch.Tensor
    read_key: np.ndarray
    out_perm: torch.Tensor
    eparams: Dict[str, torch.Tensor]
    sfeat: torch.Tensor
    cal_a: torch.Tensor
    cal_b: torch.Tensor

    @classmethod
    def ideal(cls, plan, eparams: Optional[dict] = None,
              calibration: Tuple[float, float] = (1.0, 0.0),
              n_features: int = N_SCENARIO_FEATURES) -> "DeploymentState":
        dev = plan.g_feat.device
        f32 = dict(dtype=torch.float32, device=dev)
        st = cls(
            # float32 whatever the weights' dtype, as in the reference
            gf=plan.g_feat.float(),
            read_sigma=torch.zeros((plan.NB, plan.NO), **f32),
            read_key=prng.key(0),
            out_perm=torch.arange(plan.N, device=dev),
            # the same dict, not a copy: the executor caches the emulator
            # weights' repack by the params' identity
            eparams=eparams if eparams else {},
            sfeat=torch.zeros((n_features,), **f32),
            cal_a=torch.tensor(float(calibration[0]), **f32),
            cal_b=torch.tensor(float(calibration[1]), **f32))
        return st.known_noise(False)

    def known_noise(self, has: bool) -> "DeploymentState":
        """Record whether ``read_sigma`` has a nonzero tile, so the
        forward need not read the tensor back (a device sync)."""
        object.__setattr__(self, "_has_read_noise", bool(has))
        return self

    @property
    def has_read_noise(self) -> bool:
        """True if any tile draws read noise (read once per state)."""
        c = self.__dict__.get("_has_read_noise")
        if c is None:
            c = bool((self.read_sigma != 0).any())
            object.__setattr__(self, "_has_read_noise", c)
        return c

    @property
    def window(self) -> Optional[tuple]:
        """``(scheme, tp, index, NB, NO)`` when ``gf`` and ``read_sigma``
        hold one tensor-parallel rank's window of an (NB, NO) lattice
        (``parallel.sharding``), else None: the state is whole."""
        return self.__dict__.get("_window")

    def in_window(self, window: tuple) -> "DeploymentState":
        """Record that the lattice fields hold ``window`` (see ``window``)."""
        object.__setattr__(self, "_window", tuple(window))
        return self

    def replace(self, **kw) -> "DeploymentState":
        """Immutable field update; keeps the read-noise flag unless
        ``read_sigma`` changes, and the window unless ``gf`` or
        ``read_sigma`` does."""
        new = dataclasses.replace(self, **kw)
        c = self.__dict__.get("_has_read_noise")
        if c is not None and "read_sigma" not in kw:
            new.known_noise(c)
        if self.window is not None and not {"gf", "read_sigma"} & set(kw):
            new.in_window(self.window)
        return new

    def with_read_key(self, key) -> "DeploymentState":
        """Same device, next read cycle."""
        return self.replace(read_key=prng.as_key(key))

    def with_calibration(self, a, b) -> "DeploymentState":
        dev = self.gf.device
        return self.replace(
            cal_a=torch.as_tensor(a, dtype=torch.float32, device=dev),
            cal_b=torch.as_tensor(b, dtype=torch.float32, device=dev))


@dataclass(frozen=True, eq=False)
class Deployment:
    """Immutable executor-level deployment spec (what ``ex.deploy``
    builds).  Per-site states derive from it lazily.

      scenario -- device corner (None = ideal hardware)
      key      -- uint32[2] fleet fabrication key (same key = same devices)
      remap    -- False/True (off / instantaneous) or a tuple of
                  checkpoint ages in seconds (wear-aware horizon scoring)
      params   -- emulator param override (None = the executor's)
      states   -- preloaded per-site states (``load_deployment``), served
                  verbatim
    """
    scenario: Optional[object] = None
    key: Optional[np.ndarray] = None
    remap: "bool | Tuple[float, ...]" = False
    params: Optional[dict] = None
    states: Optional[Dict[str, DeploymentState]] = None

    def replace(self, **kw) -> "Deployment":
        return dataclasses.replace(self, **kw)

    def spec_json(self) -> str:
        """Canonical JSON of the scenario, fleet key and remap policy,
        the reference's encoding."""
        from repro_torch.nonideal.scenario import scenario_to_json
        return json.dumps({
            "scenario": (None if self.scenario is None
                         else json.loads(scenario_to_json(self.scenario))),
            "key": (None if self.key is None
                    else np.asarray(self.key).tolist()),
            "remap": (list(self.remap)
                      if isinstance(self.remap, (tuple, list))
                      else bool(self.remap)),
        }, sort_keys=True)

    @classmethod
    def from_spec_json(cls, doc: str) -> "Deployment":
        """Inverse of ``spec_json`` (scenario, key, remap)."""
        from repro_torch.nonideal.scenario import scenario_from_json
        d = json.loads(doc)
        sc = d.get("scenario")
        key = d.get("key")
        rm = d.get("remap", False)
        return cls(
            scenario=(None if sc is None
                      else scenario_from_json(json.dumps(sc))),
            key=None if key is None else np.asarray(key, np.uint32),
            remap=tuple(rm) if isinstance(rm, list) else bool(rm))


# --------------------------------------------------------------------------- #
# npz: the reference's deployment format
# --------------------------------------------------------------------------- #
_SPEC_KEY = "__deployment_spec"
_EP_PREFIX = "__eparams::"


def _field_np(f: str, v) -> np.ndarray:
    """A state field in the reference's dtype: ``out_perm`` int32,
    ``read_key`` uint32[2], the rest float32."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        v = (v.float() if v.is_floating_point() else v).numpy()
    a = np.asarray(v)
    if f == "out_perm":
        return a.astype(np.int32)
    if f == "read_key":
        return a.astype(np.uint32)
    return a.astype(np.float32)


def save_deployment(path: str, states: Dict[str, DeploymentState],
                    deployment: Optional[Deployment] = None) -> str:
    """Serialize per-site states and the spec to one npz, the reference's
    format: every leaf under ``<tag>::<field>``, the one shared emulator
    param set under ``__eparams::<k>``, the spec JSON under
    ``__deployment_spec``."""
    arrs: Dict[str, np.ndarray] = {}
    eparams: Dict[str, torch.Tensor] = {}
    for tag, st in states.items():
        if st.window is not None:
            raise ValueError(
                f"save_deployment: the state of {tag!r} holds one rank's "
                "window of its lattice; gather it first "
                "(AnalogExecutor.gather_states)")
        for f in _STATE_FIELDS:
            if f == "eparams":
                if st.eparams:
                    if eparams and st.eparams is not eparams:
                        raise ValueError(
                            "save_deployment: per-tag states carry "
                            "different eparams dicts; the npz format "
                            "stores one shared emulator param set")
                    eparams = st.eparams
                continue
            arrs[f"{tag}::{f}"] = _field_np(f, getattr(st, f))
    for k, v in eparams.items():
        arrs[_EP_PREFIX + k] = _field_np(k, v)
    spec = (deployment or Deployment()).spec_json()
    np.savez(path, **{_SPEC_KEY: np.array(spec)}, **arrs)
    return path


def states_from_numpy(data: Dict[str, np.ndarray],
                      device: DeviceLike = None
                      ) -> Tuple[Dict[str, DeploymentState], Deployment]:
    """The arrays of a deployment npz (as numpy) -> ``(states,
    deployment)`` with the states on ``device`` and attached to the
    returned spec."""
    dev = resolve_device(device)

    def t(a, dtype=None):
        x = torch.from_numpy(np.array(a))       # a copy; 0-d stays 0-d
        return x.to(dev) if dtype is None else x.to(dev, dtype)

    eparams = {k[len(_EP_PREFIX):]: t(np.asarray(v, np.float32))
               for k, v in data.items() if k.startswith(_EP_PREFIX)}
    tags = sorted({k.split("::", 1)[0] for k in data
                   if "::" in k and not k.startswith("__")})
    states: Dict[str, DeploymentState] = {}
    for tag in tags:
        g = lambda f: np.asarray(data[f"{tag}::{f}"])
        states[tag] = DeploymentState(
            gf=t(g("gf").astype(np.float32)),
            read_sigma=t(g("read_sigma").astype(np.float32)),
            read_key=g("read_key").astype(np.uint32).reshape(2),
            out_perm=t(g("out_perm"), torch.int64),
            # one shared dict, as the executor's repack cache keys it
            eparams=eparams,
            sfeat=t(g("sfeat").astype(np.float32)),
            cal_a=t(g("cal_a").astype(np.float32)),
            cal_b=t(g("cal_b").astype(np.float32)))
    dep = Deployment.from_spec_json(str(np.asarray(data[_SPEC_KEY])))
    return states, dep.replace(states=states)


def load_deployment(path: str, device: DeviceLike = None, executor=None
                    ) -> Tuple[Dict[str, DeploymentState], Deployment]:
    """Inverse of ``save_deployment`` (a file either package wrote):
    ``(states, deployment)`` on ``device``, the states attached to the
    returned spec.  With ``executor`` (an ``AnalogExecutor``) on a
    serving mesh, each state keeps this rank's window of its lattice
    (``executor.shard_states``): the npz holds values, not placements, so
    a deployment saved under one mesh shape loads onto any other."""
    with np.load(path, allow_pickle=False) as data:
        states, dep = states_from_numpy({k: data[k] for k in data.files},
                                        device)
    if executor is not None:
        states = executor.shard_states(states)
        dep = dep.replace(states=states)
    return states, dep
