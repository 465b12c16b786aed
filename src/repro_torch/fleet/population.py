"""Fleet population: N fabricated devices from one key, evaluated in chunks
(port of ``repro.fleet.population``).

A fleet is a ``FleetSpec`` (population size, base corner, fab-spread
magnitudes) and one fabrication key.  Device ``d`` derives from
``fold_in(fleet_key, d)`` (``core.prng``), as in the reference:

  fab draw   -- per-tile lognormal multipliers on the base corner's
                programming sigma, read sigma, stuck-off rate and drift
                exponent (the (NB, NO) lattice, different per device);
  drift      -- the device at age ``t`` is the SAME draw with ``drift_t``
                rewritten, so trajectories are replays, not walks.

``Fleet.evaluate`` runs any slice of the population in chunks of a fixed
size (the last chunk padded by repeating its final device, the pads
dropped), with each device's maintenance epoch ``cal_age`` an operand:
``cal_age = tc`` means the array was reprogrammed at ``tc`` (a fresh
programming draw for that epoch, drift clock reset -- stuck cells
persist, they are fab defects) and its affine refitted right after the
write on the fleet's probe batch.  Serving at age ``t`` sees ``t - tc``
seconds of drift on that write.  Each device is scored by the relative
error of its calibrated output against the IDEAL device through the same
backend.

A chunk is two forwards of the executor's many-states path
(``AnalogExecutor.raw_matmul_many``): the probe fit and the serve, each
one B1 launch for the whole chunk on the emulator's fast path (the
reference vmaps its jitted forward over the chunk).  Every device's
draws come from counter-based streams keyed by its own keys
(``prng.stream_normal`` / ``stream_uniform``), computed on the card for
the whole chunk, and its fit and error use fixed-order sums
(``analog.pairwise_sum``), so a device's result is bit-for-bit the same
in any chunk size and any process.  The port compiles nothing: the
chunk step is built once per input shape (``builds``, ``cache_size()``;
``RecompileSentinel(fns=(fleet,))`` watches it).  The draws are the
port's own, held to the reference statistically; the CPU tests hand the
reference's draws in through ``_draws``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.analog import calibration_probes, pairwise_sum
from repro_torch.nonideal.perturb import (apply_read_noise,
                                          drift_multiplier,
                                          perturb_conductance,
                                          sample_fault_masks)
from repro_torch.nonideal.scenario import (_LEAF_FIELDS, _leaf_dtype,
                                           N_SCENARIO_FEATURES, Scenario,
                                           scenario_features_tiled)
from repro_torch.obs import OBS

@dataclass(frozen=True)
class FleetSpec:
    """Shape of a device population.

    Attributes:
      n_devices:    population size N.
      base:         the nominal corner every instance is drawn around
                    (scalar or per-tile ``tile_scenarios``).
      sigma_spread: lognormal spread of per-tile programming/read sigma
                    multipliers (0 = every device identical in sigma).
      nu_spread:    lognormal spread of per-tile drift exponents.
      fault_spread: lognormal spread of per-tile stuck-off rates.
      chunk:        devices per chunk (memory scales with it, never with
                    ``n_devices``).
    """
    n_devices: int
    base: Scenario
    sigma_spread: float = 0.25
    nu_spread: float = 0.25
    fault_spread: float = 0.25
    chunk: int = 256


class Fleet:
    """Chunked population evaluation of ``ex.matmul``-equivalent serving
    error for every device of a ``FleetSpec``.

    Like ``nonideal.ScenarioSweep``, the executor's own deployment is
    bypassed: each device's corner, conductance draw, read draws,
    scenario features and fitted affine are built per device from its
    keys.  The executor contributes the cached conductance plan, the
    (possibly conditioned) emulator params and the backend forward.
    Static circuit parameters cannot vary per device, so the base corner
    must keep ``r_line_scale == 1.0``."""

    def __init__(self, ex, w: torch.Tensor, tag: str, spec: FleetSpec,
                 key=None, n_probe: int = 16):
        if spec.base.r_line_scale != 1.0:
            raise ValueError(
                "Fleet populations vary the per-device scenario fields only; "
                "r_line_scale is a static of the circuit backend "
                "(see ScenarioSweep)")
        self.ex = ex
        self.w = w.float()
        self.tag = tag
        self.spec = spec
        self.key = prng.as_key(0 if key is None else key)
        self.n_probe = int(n_probe)
        self.builds = 0
        self._shapes: set = set()
        self._resolved: Optional[dict] = None
        self._refs: Optional[tuple] = None
        # the fit's probe batch is part of the fleet identity: fixed at
        # construction, the same for every device
        self._xp = calibration_probes(prng.fold_in(self.key, 0xF1EE7),
                                      self.n_probe, w.shape[0], w.device)
        if OBS.enabled:
            OBS.gauge("fleet_devices_total",
                      "population size of the active fleet",
                      tag=tag).set(float(spec.n_devices))

    def cache_size(self) -> int:
        """Built chunk steps (one per input shape; a whole campaign holds
        it at 1)."""
        return len(self._shapes)

    # ------------------------------------------------------------------ #
    # the built step and the per-device draws
    # ------------------------------------------------------------------ #
    def _base(self) -> dict:
        """The tag's plan, its live-cell mask, the base corner on the
        lattice and the emulator params, resolved once."""
        if self._resolved is None:
            ex = self.ex
            plan = ex._whole(ex._plan_for(self.w, self.tag), self.w)
            dev = plan.g_feat.device
            lat = (plan.NB, plan.NO)
            self._resolved = {
                "plan": plan, "g": plan.g_feat.float(),
                "live": plan.g_feat > 0.0,
                "base": {f: _lattice(getattr(self.spec.base, f), f, lat, dev)
                         for f in _LEAF_FIELDS},
                "ep": (ex.emulator_params if ex.acfg.backend == "emulator"
                       else None),
                "conditioned": getattr(ex, "emulator_conditioned", False)}
        return self._resolved

    def _step(self, shape: Tuple[int, ...]) -> dict:
        """The chunk step for inputs of ``shape``, counted once per shape
        (the reference compiles its chunk forward once per input
        shape)."""
        if shape not in self._shapes:
            self._shapes.add(shape)
            self.builds += 1
        return self._base()

    def _keys(self, ids: np.ndarray, cal_age: np.ndarray) -> np.ndarray:
        """(C, 8) stream words of the devices ``ids`` at maintenance epochs
        ``cal_age`` -- the four fab multipliers (prog sigma, read sigma,
        drift nu, stuck-off rate), the epoch's programming draw, the fault
        draw, the fit's and the serve's read draws -- by the reference's
        derivation:
        ``k = fold_in(fleet_key, id)``; the fab multipliers from
        ``split(k, 4)``; ``kd, kc, kr = split(fold_in(k, 7), 3)`` (fab /
        faults, the fit's read, the serve's read); the epoch's
        programming key ``fold_in(kd, int(cal_age))``."""
        k = prng.fold_in(self.key, ids)
        kd, kc, kr = np.moveaxis(prng.split(prng.fold_in(k, 7), 3), -2, 0)
        kp = prng.fold_in(kd, cal_age.astype(np.int32))
        keys = np.concatenate([prng.split(k, 4),
                               np.stack([kp, kd, kc, kr], axis=-2)], axis=-2)
        return prng.stream_keys(keys)

    def _draws(self, ids: np.ndarray, cal_age: np.ndarray,
               parts: Tuple[str, ...] = ("z", "eps", "u", "er_fit",
                                         "er_serve")) -> dict:
        """The chunk's draws on the card: ``z`` (4, C, NB, NO) standard
        normals of the fab multipliers, ``eps`` the epoch's programming
        noise and ``u`` the fault uniforms, ``er_fit`` / ``er_serve`` the
        two read cycles' normals, each (C, NB, NO, D, H, W)."""
        plan = self._base()["plan"]
        dev = plan.g_feat.device
        words = torch.from_numpy(self._keys(ids, cal_age))
        if dev.type == "cuda":
            words = words.pin_memory()
        words = words.to(dev, non_blocking=True)
        C = ids.shape[0]
        cells = (C,) + tuple(plan.g_feat.shape)
        n_cell = int(np.prod(cells[1:]))
        words = words.t()                      # (8, C): one row a stream
        out = {}
        if "z" in parts:
            out["z"] = prng.stream_normal(words[:4], plan.NB * plan.NO) \
                .reshape((4, C, plan.NB, plan.NO))
        if "u" in parts:
            out["u"] = prng.stream_uniform(words[5], n_cell).reshape(cells)
        # the normal streams of the cells in one batch of launches
        names = [n for n in ("eps", "er_fit", "er_serve") if n in parts]
        if names:
            cols = [{"eps": 4, "er_fit": 6, "er_serve": 7}[n] for n in names]
            z = prng.stream_normal(words[cols], n_cell)
            out.update({n: z[i].reshape(cells) for i, n in enumerate(names)})
        return out

    def _device_scenario(self, st: dict, z: torch.Tensor,
                         drift_ages: Tuple[torch.Tensor, ...]):
        """The fab draw of the chunk's devices at each drift age (C,) of
        ``drift_ages``: one ``(Scenario, drift multiplier)`` pair an age,
        every leaf (C, NB, NO).  Lognormal multipliers keep each leaf
        positive and the base corner the population median."""
        sp, b = self.spec, st["base"]
        C = z.shape[1]
        full = {f: v.expand((C,) + v.shape) for f, v in b.items()}

        def logn(s, j):
            return _per_device(lambda zz: torch.exp(s * zz), z[j])

        full.update(
            prog_sigma=b["prog_sigma"] * logn(sp.sigma_spread, 0),
            read_sigma=b["read_sigma"] * logn(sp.sigma_spread, 1),
            drift_nu=b["drift_nu"] * logn(sp.nu_spread, 2),
            p_stuck_off=torch.clamp(
                b["p_stuck_off"] * logn(sp.fault_spread, 3), 0.0, 0.5))
        out = []
        for age in drift_ages:
            leaves = dict(full, drift_t=age[:, None, None].expand(
                full["drift_t"].shape))
            drift = _per_device(drift_multiplier, leaves["drift_t"],
                                leaves["drift_nu"], leaves["drift_t0"])
            out.append((Scenario(name=sp.base.name, r_line_scale=1.0,
                                 **leaves), drift))
        return out

    def _read_state(self, st: dict, scen: Scenario, drift, eps, u, er):
        """The read conductances (C, NB, NO, D, H, W) of the devices'
        written state under ``scen``: programming noise ``eps`` of the
        epoch, the fab's stuck cells from ``u``, one read draw ``er``."""
        g = st["g"].expand(eps.shape)
        gf = perturb_conductance(g, self.ex.acfg, scen, eps, u, drift=drift)
        return apply_read_noise(gf, self.ex.acfg, scen.read_sigma, er)

    def _ideal_refs(self, st: dict, x: torch.Tensor) -> tuple:
        """The ideal device's calibrated outputs on the probes and on the
        rows of ``x`` through the same forward (unit affine, the ideal
        read, the ideal corner's all-zero encoding), kept while the caller
        passes the same ``x``."""
        if self._refs is not None and self._refs[0] is x:
            return self._refs
        x2 = x.reshape(-1, x.shape[-1]).float()
        g = st["g"]
        g0 = torch.where(g > 0.0, torch.clamp(g, self.ex.acfg.g_min,
                                              self.ex.acfg.g_max), g)[None]
        sf = (torch.zeros((N_SCENARIO_FEATURES,), device=g.device)
              if st["conditioned"] else None)
        outs = []
        for xx in (self._xp, x2):
            yv, xs = self.ex.raw_matmul_many(xx, self.w, self.tag, g0,
                                             eparams=st["ep"], sfeat=sf)
            outs.append(yv[0] * xs)
        self._refs = (x, outs[0], outs[1])
        return self._refs

    @torch.no_grad()
    def _errors(self, st: dict, x: torch.Tensor, d: dict,
                age: torch.Tensor, cal_age: torch.Tensor) -> torch.Tensor:
        """(C,) serving relative errors of one chunk given its draws."""
        ex, w, tag = self.ex, self.w, self.tag
        _, yp_ref, y_ref = self._ideal_refs(st, x)
        x2 = x.reshape(-1, x.shape[-1]).float()
        C = age.shape[0]
        (fresh, dr0), (aged, dr1) = self._device_scenario(
            st, d["z"], (torch.zeros_like(age), age - cal_age))
        feats = [_features(s) if st["conditioned"] else None
                 for s in (fresh, aged)]
        # the fit: the freshly written state's probe volts against the
        # ideal device's labels, in x_scale-normalized units
        g_fit = self._read_state(st, fresh, dr0, d["eps"], d["u"],
                                 d["er_fit"])
        yv, xsp = ex.raw_matmul_many(self._xp, w, tag, g_fit,
                                     eparams=st["ep"], sfeat=feats[0])
        L = yp_ref.numel()
        yv = ((yv * xsp) / xsp).reshape(C, L)
        yd = (yp_ref / xsp).reshape(1, L)
        vm = pairwise_sum(yv) / L
        dm = pairwise_sum(yd) / L
        dv = yv - vm[:, None]
        var = torch.clamp_min(pairwise_sum(dv * dv) / L, 1e-12)
        a = pairwise_sum(dv * (yd - dm[:, None])) / L / var
        b = dm - a * vm
        # the serve: the same write drifted for (age - cal_age) seconds,
        # under the epoch's affine, a fresh read
        g_srv = self._read_state(st, aged, dr1, d["eps"], d["u"],
                                 d["er_serve"])
        yv, xs = ex.raw_matmul_many(x2, w, tag, g_srv, eparams=st["ep"],
                                    sfeat=feats[1])
        y = (a[:, None, None] * yv + b[:, None, None]) * xs
        diff = (y - y_ref[None]).reshape(C, -1)
        num = torch.sqrt(pairwise_sum(diff * diff))
        den = torch.sqrt(pairwise_sum(y_ref.reshape(1, -1) ** 2))
        return num / torch.clamp_min(den, 1e-12)

    # ------------------------------------------------------------------ #
    # chunked evaluation (bounded memory, padded last chunk)
    # ------------------------------------------------------------------ #
    def _chunks(self, n: int):
        c = self.spec.chunk
        for lo in range(0, n, c):
            hi = min(lo + c, n)
            pad = c - (hi - lo)
            yield lo, hi, (lambda a: np.pad(a[lo:hi], (0, pad), mode="edge"))

    @torch.no_grad()
    def evaluate(self, x: torch.Tensor, age, ids: Optional[np.ndarray] = None,
                 cal_age=None) -> np.ndarray:
        """Per-device serving relative error at ``age`` seconds.

        ``ids`` selects a device subset (default: the whole population);
        ``age`` and ``cal_age`` are scalars or per-device arrays.
        ``cal_age`` is the device's last maintenance epoch (default 0.0:
        written at deployment, never maintained).  Work proceeds in chunks
        of ``spec.chunk`` devices; the results come back to the host once,
        after the last chunk."""
        ids = (np.arange(self.spec.n_devices, dtype=np.int32)
               if ids is None else np.asarray(ids, np.int32))
        n = ids.shape[0]
        age = np.broadcast_to(np.asarray(age, np.float32), (n,))
        cal = np.broadcast_to(
            np.asarray(0.0 if cal_age is None else cal_age, np.float32), (n,))
        st = self._step((int(np.prod(x.shape[:-1])), x.shape[-1]))
        dev = st["g"].device
        outs = []
        for lo, hi, sl in self._chunks(n):
            i_c, cal_c = sl(ids), sl(cal)
            ac = torch.from_numpy(np.stack([sl(age), cal_c]))
            if dev.type == "cuda":
                ac = ac.pin_memory()
            ac = ac.to(dev, non_blocking=True)
            d = self._draws(i_c, cal_c)
            outs.append(self._errors(st, x, d, ac[0], ac[1])[:hi - lo])
            if OBS.enabled:
                OBS.counter("fleet_chunk_evals_total",
                            "fleet chunk executions", tag=self.tag).inc()
        out = torch.cat(outs).cpu().numpy() if outs \
            else np.empty((0,), np.float32)
        if OBS.enabled:
            OBS.counter("fleet_eval_devices_total",
                        "devices evaluated across fleet campaigns",
                        tag=self.tag).inc(float(n))
            OBS.gauge("fleet_eval_rel_err",
                      "serving relative error of the last fleet "
                      "evaluation", tag=self.tag, stat="mean"
                      ).set(float(out.mean()))
            OBS.gauge("fleet_eval_rel_err",
                      "serving relative error of the last fleet "
                      "evaluation", tag=self.tag, stat="p95"
                      ).set(float(np.quantile(out, 0.95)))
        return out

    # ------------------------------------------------------------------ #
    # cheap per-device features (for the forecast surrogate)
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def device_features(self, ids: np.ndarray, age) -> np.ndarray:
        """(n, 2 * N_SCENARIO_FEATURES + 4) per-device summary features at
        drift age ``age``: mean and max over the tile lattice of each
        device's per-tile scenario encoding, plus its REALIZED stuck-cell
        fractions (mean / max over tiles of the live cells its fab draw
        stuck on / off) -- what separates a device's freshly-maintained
        error floor from its neighbours'.  No forward runs: the
        surrogate's input, cheap enough for the whole population."""
        ids = np.asarray(ids, np.int32)
        n = ids.shape[0]
        age = np.broadcast_to(np.asarray(age, np.float32), (n,))
        st = self._base()
        live = st["live"]
        dev = live.device
        cell_dims = tuple(range(2, live.dim()))
        n_live = torch.clamp_min(live.sum(dim=cell_dims).float(), 1.0)
        ncell = int(np.prod(live.shape[2:]))
        outs = []
        for lo, hi, sl in self._chunks(n):
            i_c = sl(ids)
            C = i_c.shape[0]
            t = torch.from_numpy(sl(age))
            if dev.type == "cuda":
                t = t.pin_memory()
            t = t.to(dev, non_blocking=True)
            d = self._draws(i_c, np.zeros((C,), np.float32), ("z", "u"))
            ((aged, _),) = self._device_scenario(st, d["z"], (t,))
            f = _features(aged).reshape(C, -1, N_SCENARIO_FEATURES)
            ntile = f.shape[1]
            on, off = sample_fault_masks(d["u"], aged.p_stuck_on,
                                         aged.p_stuck_off)
            fr = [pairwise_sum((live & m).reshape(C, -1, ncell).float())
                  / n_live.reshape(1, -1) for m in (on, off)]
            fmean = pairwise_sum(f.transpose(1, 2)) / ntile
            outs.append(torch.cat([
                fmean, f.max(dim=1).values,
                torch.stack([pairwise_sum(fr[0]) / ntile,
                             fr[0].max(dim=1).values,
                             pairwise_sum(fr[1]) / ntile,
                             fr[1].max(dim=1).values], dim=1)],
                dim=1)[:hi - lo])
        if not outs:
            return np.empty((0, 2 * N_SCENARIO_FEATURES + 4), np.float32)
        return torch.cat(outs).cpu().numpy()


def _per_device(fn, *xs: torch.Tensor) -> torch.Tensor:
    """``fn`` of per-device tensors (C, ...).  On the card every element
    runs the same instructions.  torch's CPU loops compute a tensor's last
    partial vector with scalar code, whose ``exp``, ``pow`` and ``log1p``
    can round differently: there ``fn`` runs one device at a time, so a
    device's bits do not depend on its place in the chunk."""
    if xs[0].device.type != "cpu":
        return fn(*xs)
    return torch.cat([fn(*(x[i:i + 1] for x in xs))
                      for i in range(xs[0].shape[0])])


def _features(scen: Scenario) -> torch.Tensor:
    """(C, NB, NO, F) per-tile encodings of a chunk's device scenarios
    (``scenario_features_tiled``), one device at a time on the CPU."""
    return _per_device(
        lambda *lv: scenario_features_tiled(Scenario(
            name=scen.name, r_line_scale=1.0, **dict(zip(_LEAF_FIELDS, lv)))),
        *(getattr(scen, f) for f in _LEAF_FIELDS))


def _lattice(v, f: str, lat: Tuple[int, int], dev) -> torch.Tensor:
    """A base-corner leaf as a (NB, NO) tensor of its dtype on ``dev``."""
    t = (v.detach() if isinstance(v, torch.Tensor)
         else torch.tensor(v)).to(dev, _leaf_dtype(f))
    return t.expand(lat).contiguous()
