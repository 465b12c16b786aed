"""Serving: batched prefill + greedy/temperature decode with a KV cache, as
a CLI and as a programmatic ``ServeSession`` (port of
``repro.launch.serve``).

CLI:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
      --layers 2 --batch 4 --prompt-len 32 --gen 8 \
      --analog-backend emulator --emulator-params emulator.npz

runs on the GPU (``--device cpu`` runs on the CPU).  ``--arch`` is
gemma3-1b, recurrentgemma-2b, falcon-mamba-7b, deepseek-coder-33b,
qwen1.5-110b, command-r-plus-104b, phi3.5-moe-42b-a6.6b or
llama4-scout-17b-a16e; the reference's two frontend archs raise
``NotImplementedError`` (ROADMAP A9c).  ``--reduced`` serves the
reference's tiny same-family config; ``--layers`` alone keeps the full
widths and cuts the depth.  ``--analog-backend`` is ``digital``,
``emulator`` (needs ``--emulator-params``), ``analytic`` or ``circuit``.
The MoE archs' experts never call dense(): their analog sites are the
attention projections, ``--analog-layers attn``.

Under a device corner (``nonideal``):

  python -m repro_torch.launch.serve --arch gemma3-1b --layers 2 \
      --analog-backend emulator --emulator-params emulator.npz \
      --scenario stressed --fault-remap --state-save dep.npz

``--scenario`` names a registered corner, ``--age`` ages it,
``--fault-remap`` remaps output columns off its stuck-off cells,
``--conditioned-emulator`` requires a scenario-conditioned net, and
``--state-save`` / ``--state-load`` write / serve the per-site device
states in the reference's deployment npz.  ``--analog-layers`` (a
port-only option, default ``mlp``) picks the projections that run
analog: a tiled corner needs sites that share one tile lattice (e.g.
``mlp.up,mlp.gate``).

``ServeSession`` builds the model once, discovers every analog dense()
call site (keys ``"<tag>#<ordinal>"`` for tail layers and
``"dec.<period>:<tag>#<ordinal>"`` for stacked periods, as in the
reference) and serves each site with its ``DeploymentState``.
``--telemetry [PATH]`` enables ``repro_torch.obs.OBS`` for the run and
writes its JSON snapshot to PATH (stdout for ``-`` or no PATH), the
generate watched by a ``RecompileSentinel``.  The reference's mesh and
device-count flags raise ``NotImplementedError`` naming their ROADMAP
item.  Many requests with their own lengths and arrivals are served one
level up, by ``launch.batching``.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import time
from typing import Dict, List, Optional

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.models.common import fold_seed
from repro_torch.obs import OBS

# per-process serving call-site ordinal: the telemetry series of two
# sessions of one arch stay apart
_SESSION_IDS = itertools.count()


def _derived_seed(seed: int, purpose: str) -> int:
    """Independent seed per stochastic purpose (init, prompt, sampling)."""
    return fold_seed(seed, purpose)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _splice(z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Write prefill cache ``c`` at the origin of generation cache ``z``
    (the reference's ``dynamic_update_slice`` at zeros).  A recurrent
    layer's conv and h states have the same shape in both and pass
    through, cast to ``z``'s dtype (h stays float32)."""
    c = c.to(z.dtype)
    if z.shape == c.shape:
        return c
    if z.dim() == c.dim() and (
            (z.shape[2:] == c.shape[2:] and z.shape[0] == c.shape[0])
            or (z.shape[3:] == c.shape[3:] and z.shape[:2] == c.shape[:2])):
        z[tuple(slice(0, s) for s in c.shape)] = c
    return z


def _splice_tree(z, c):
    if isinstance(z, dict):
        return {k: _splice_tree(v, c[k]) if k in c else v
                for k, v in z.items()}
    return _splice(z, c)


class ServeSession:
    """A reusable serving session over one model + one analog executor.

    ``generate()`` runs prefill + decode and returns tokens, per-step
    logits and timings.  With ``executor=None`` the session serves the
    plain digital model.  ``params``/``prompt`` override the seeded ones
    (the parity tests pass the reference's).

    ``prefill_traces`` / ``decode_traces`` stand for the reference's jit
    traces, which a ``RecompileSentinel(session=...)`` watches: the port
    compiles nothing, so each counts the one setup of its step at the
    first generate and stays at 1."""

    def __init__(self, arch: str, *, reduced: bool = True,
                 reduced_layers: Optional[int] = None, batch: int = 4,
                 prompt_len: int = 32, gen: int = 16,
                 temperature: float = 0.0, seed: int = 0, executor=None,
                 device: DeviceLike = None, params=None,
                 prompt: Optional[torch.Tensor] = None):
        from repro_torch.configs import get_config, reduced as reduce_cfg
        from repro_torch.configs.base import ParallelConfig, with_depth
        from repro_torch.models.common import tree_map
        from repro_torch.runtime import steps as S

        self.device = resolve_device(device)
        cfg = get_config(arch)
        if reduced:
            cfg = reduce_cfg(cfg, layers=reduced_layers)
        elif reduced_layers:
            cfg = with_depth(cfg, reduced_layers)
        self.cfg = cfg
        self.B, self.P, self.G = batch, prompt_len, gen
        self.temperature = temperature
        self.seed = seed
        self.ex = executor
        pcfg = ParallelConfig(attn_block_kv=min(1024, prompt_len))
        if params is None:
            params = S.init_model_params(_derived_seed(seed, "init"), cfg,
                                         self.device)
        self.params = tree_map(lambda v: v.to(self.device, torch.bfloat16),
                               params)
        if prompt is None:
            g = torch.Generator(device=self.device)
            g.manual_seed(_derived_seed(seed, "prompt"))
            prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                   generator=g, device=self.device)
        self.batch = {"tokens": prompt.to(self.device, torch.int64)}
        self._sample_gen = torch.Generator(device=self.device)
        self._sample_gen.manual_seed(_derived_seed(seed, "sample"))
        # telemetry identity of this serving call site: every
        # session-level metric series carries site=<this>
        self.site = f"{arch}#{next(_SESSION_IDS)}"
        self._prefill_step = S.make_prefill_step(cfg, pcfg)
        self._decode_step = S.make_decode_step(cfg, pcfg)
        self._sites: Optional[Dict[str, torch.Tensor]] = None
        self._last_states: Optional[dict] = None
        self._steps_built = False
        self.prefill_traces = 0
        self.decode_traces = 0

    # ------------------------------------------------------------------ #
    def sites(self) -> Dict[str, torch.Tensor]:
        """``site_key -> weight`` for every analog dense() call site,
        recorded on a one-token digital forward."""
        if self.ex is None:
            return {}
        if self._sites is None:
            from repro_torch.core.analog import _StateBinding
            from repro_torch.models.common import (use_dense_hook,
                                                   use_scan_states)
            rec: Dict[str, torch.Tensor] = {}
            binding = _StateBinding(record=rec)
            with torch.no_grad(), use_dense_hook(self.ex.hook), \
                    use_scan_states(binding), self.ex.bound_states(binding):
                self._prefill_step(self.params,
                                   {"tokens": self.batch["tokens"][:1, :1]})
            self._sites = rec
        return self._sites

    def states(self) -> Dict[str, object]:
        """One ``DeploymentState`` per call site."""
        sts = {sk: self.ex.state_for(sk, w) for sk, w in self.sites().items()}
        if OBS.enabled:
            for sk in sts:
                OBS.counter("serve_state_swaps_total",
                            "DeploymentStates materialized and served, per "
                            "analog call site",
                            site=self.site, call_site=sk).inc()
        return sts

    def calibrate(self, key=None, n: int = 16,
                  warm_start: bool = False) -> None:
        """Fit every call site's volts->logical affine against digital
        under the executor's active deployment, sites in sorted order, site
        ``i`` on probes drawn from ``fold_in(key, i)`` (default key:
        ``seed + 1``; ``analog.calibration_probes``), ``n`` rows cold and
        half of them warm (``AnalogExecutor.calibration_budget``)."""
        from repro_torch.core import analog, prng
        key = prng.key(self.seed + 1) if key is None else prng.as_key(key)
        for i, (sk, w) in enumerate(sorted(self.sites().items())):
            m = self.ex.calibration_budget(sk, n, warm_start)
            xc = analog.calibration_probes(prng.fold_in(key, i), m,
                                           w.shape[0], w.device)
            self.ex.calibrate(xc, w, sk, warm_start=warm_start)

    def save_deployment(self, path: str) -> str:
        """Write the last-served (or current) per-site states and the
        deployment spec to npz (``serve --state-save``)."""
        from repro_torch.core.deployment import save_deployment
        states = self._last_states if self._last_states else self.states()
        return save_deployment(path, states, self.ex.deployment)

    def _bound(self, states):
        if self.ex is None:
            return contextlib.nullcontext()
        from repro_torch.core.analog import _StateBinding
        from repro_torch.models.common import use_dense_hook, use_scan_states
        binding = _StateBinding(states=states)
        stack = contextlib.ExitStack()
        stack.enter_context(use_dense_hook(self.ex.hook))
        stack.enter_context(use_scan_states(binding))
        stack.enter_context(self.ex.bound_states(binding))
        return stack

    def _build_steps(self):
        """Count the steps' setup at the first generate (see the class
        docstring)."""
        for step in ("prefill", "decode"):
            setattr(self, f"{step}_traces",
                    getattr(self, f"{step}_traces") + 1)
            if OBS.enabled:
                OBS.counter("serve_traces_total",
                            "builds of the serving steps (a healthy sweep "
                            "holds this at 1 per step)",
                            site=self.site, step=step).inc()
        self._steps_built = True

    def _prefill(self, b, states):
        with self._bound(states):
            return self._prefill_step(self.params, b)

    def _decode(self, tok, cache, pos, states):
        with self._bound(states):
            return self._decode_step(self.params, tok, cache, pos)

    # ------------------------------------------------------------------ #
    def _next_token(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature > 0:
            p = torch.softmax(logits / self.temperature, dim=-1)
            return torch.multinomial(p, 1, generator=self._sample_gen)
        return torch.argmax(logits, dim=-1)[:, None]

    @torch.no_grad()
    def generate(self, states: Optional[dict] = None) -> dict:
        """One prefill + decode pass.  Returns ``{"tokens": (B, G) int
        array, "logits": (G, B, V) float32 array, "prefill_s",
        "decode_s"}`` (seconds, synchronized with the device)."""
        from repro_torch.models import model as M
        if not self._steps_built:
            self._build_steps()
        if states is None:
            states = self.states() if self.ex is not None else {}
        self._last_states = states
        B, P, G = self.B, self.P, self.G
        dev = self.device

        _sync(dev)
        t0 = time.perf_counter()
        logits, pcache = self._prefill(self.batch, states)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        if OBS.enabled:
            OBS.histogram("serve_prefill_seconds",
                          "full prefill wall clock (synchronized) per "
                          "serving call site", site=self.site,
                          arch=self.cfg.name).observe(t_prefill)

        cache = M.zeros_cache(M.model_cache_schema(self.cfg, B, P + G), dev)
        cache = _splice_tree(cache, pcache)
        del pcache
        tok = self._next_token(logits)
        out_tokens: List[torch.Tensor] = [tok]
        out_logits: List[torch.Tensor] = [logits]
        t0 = time.perf_counter()
        for i in range(G - 1):
            ts = time.perf_counter() if OBS.enabled else 0.0
            logits, cache = self._decode(tok, cache, P + i, states)
            if OBS.enabled:
                # the host's time until the step's launches return: no
                # device sync inside the loop (the synchronized total is
                # serve_decode_seconds)
                OBS.histogram("serve_decode_step_seconds",
                              "per-step decode latency, host side (no "
                              "device sync)", site=self.site,
                              arch=self.cfg.name).observe(
                                  time.perf_counter() - ts)
            tok = self._next_token(logits)
            out_tokens.append(tok)
            out_logits.append(logits)
        _sync(dev)
        t_decode = time.perf_counter() - t0
        if OBS.enabled:
            OBS.histogram("serve_decode_seconds",
                          "full decode-loop wall clock (synchronized) per "
                          "serving call site", site=self.site,
                          arch=self.cfg.name).observe(t_decode)
            OBS.counter("serve_tokens_total",
                        "tokens served (prompt + generated)",
                        site=self.site, arch=self.cfg.name).inc(B * (P + G))
        return {"tokens": torch.cat(out_tokens, dim=1).cpu().numpy(),
                "logits": torch.stack(out_logits).float().cpu().numpy(),
                "prefill_s": t_prefill, "decode_s": t_decode}


# --------------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------------- #
_NOT_PORTED = {"mesh": "A11", "devices": "A11"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="serve the tiny same-family config")
    ap.add_argument("--layers", type=int, default=None,
                    help="layer count: with --reduced, the reduced config's; "
                         "without, the full-width model cut to this depth")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--analog-backend", default="digital",
                    choices=["digital", "emulator", "analytic", "circuit"],
                    help="route MLP projections through the analog backend")
    ap.add_argument("--emulator-params", default=None,
                    help="npz with Conv4Xbar params (the reference's "
                         "emulator cache format); required for "
                         "--analog-backend=emulator")
    ap.add_argument("--analog-layers", default="mlp",
                    help="comma-separated tag prefixes of the projections "
                         "that run analog (default: mlp; the MoE archs' "
                         "analog sites are attn)")
    ap.add_argument("--scenario", default=None,
                    help="registered device corner (repro_torch.nonideal; "
                         "e.g. stressed); needs a non-digital backend")
    ap.add_argument("--age", type=float, default=None,
                    help="seconds since the fleet was programmed: ages the "
                         "scenario's drift_t")
    ap.add_argument("--fault-remap", action="store_true",
                    help="stuck-fault-aware column remapping (needs "
                         "--scenario)")
    ap.add_argument("--conditioned-emulator", action="store_true",
                    help="require --emulator-params to hold a scenario-"
                         "conditioned Conv4Xbar (periph width 2 + 13)")
    ap.add_argument("--state-save", default=None, metavar="NPZ",
                    help="after serving, write the per-site device states "
                         "and the spec to this npz")
    ap.add_argument("--state-load", default=None, metavar="NPZ",
                    help="serve the per-site device states of a deployment "
                         "npz (either package's) verbatim")
    ap.add_argument("--telemetry", nargs="?", const="-", default=None,
                    metavar="PATH",
                    help="enable the metrics registry for this run and write "
                         "its JSON snapshot on exit -- to PATH, or to stdout "
                         "when the flag is given bare or as '-'")
    # reference flags whose subsystems are not ported yet
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--devices", type=int, default=0)
    return ap


def main(argv: Optional[List[str]] = None):
    """Parse ``argv``, serve, print the timings; returns (session, output)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag) not in (None, False, 0):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet "
                f"(ROADMAP {item})")
    if args.telemetry is not None:
        OBS.enable()
    if args.scenario and args.analog_backend == "digital":
        ap.error("--scenario requires a non-digital --analog-backend")
    if (args.fault_remap or args.age is not None) and not args.scenario:
        ap.error("--fault-remap / --age require --scenario")
    if args.conditioned_emulator and args.analog_backend != "emulator":
        ap.error("--conditioned-emulator requires --analog-backend=emulator")
    if (args.state_save or args.state_load) \
            and args.analog_backend == "digital":
        ap.error("--state-save/--state-load require a non-digital "
                 "--analog-backend")
    device = resolve_device(args.device)
    ex = None
    loaded_states = None
    if args.analog_backend != "digital":
        from repro_torch.configs.base import AnalogConfig
        from repro_torch.configs.rram_ps32 import CASE_A
        from repro_torch.core.analog import AnalogExecutor
        from repro_torch.interop import load_emulator_npz
        eparams = None
        if args.analog_backend == "emulator":
            if not args.emulator_params:
                raise SystemExit("--analog-backend=emulator needs "
                                 "--emulator-params <npz>")
            eparams = load_emulator_npz(args.emulator_params, device)
        layers = tuple(l for l in args.analog_layers.split(",") if l)
        ex = AnalogExecutor(
            acfg=AnalogConfig(enabled=True, backend=args.analog_backend,
                              layers=layers),
            geom=CASE_A, emulator_params=eparams)
        if args.conditioned_emulator:
            from repro_torch.nonideal import (N_SCENARIO_FEATURES,
                                              SCENARIO_FEATURE_NAMES)
            if not ex.emulator_conditioned:
                raise SystemExit(
                    "--conditioned-emulator: the params are not scenario-"
                    f"conditioned (periph width must be 2 + "
                    f"{N_SCENARIO_FEATURES}; train with "
                    "nonideal.train_conditioned_emulator)")
            print(f"conditioned emulator: {N_SCENARIO_FEATURES} scenario "
                  f"features ({', '.join(SCENARIO_FEATURE_NAMES[:4])}, ...)")
        if args.state_load:
            from repro_torch.core.deployment import load_deployment
            loaded_states, dep = load_deployment(args.state_load, device)
            ex.deploy(scenario=dep.scenario, key=dep.key, remap=dep.remap,
                      states=dep.states)
            print(f"deployment restored: {len(loaded_states)} call sites "
                  f"from {args.state_load}")
        elif args.scenario:
            from repro_torch.core import prng
            from repro_torch.nonideal import get_scenario
            ex.deploy(scenario=get_scenario(args.scenario), age=args.age,
                      remap=args.fault_remap,
                      key=prng.fold_in(prng.key(args.seed), 0xDEF))
            print(f"analog scenario: {ex.scenario.name}"
                  f"{'' if args.age is None else f' at age {args.age:g} s'}"
                  f"{', fault remap' if args.fault_remap else ''}")
    sess = ServeSession(args.arch, reduced=args.reduced,
                        reduced_layers=args.layers, batch=args.batch,
                        prompt_len=args.prompt_len, gen=args.gen,
                        temperature=args.temperature, seed=args.seed,
                        executor=ex, device=device)
    from repro_torch.obs import RecompileSentinel
    with RecompileSentinel(session=sess, executor=ex, strict=False,
                           label="serve") as sent:
        out = sess.generate(states=loaded_states)
    B, P, G = args.batch, args.prompt_len, args.gen
    print(f"prefill {B}x{P}: {out['prefill_s'] * 1e3:.1f} ms "
          f"({B * P / out['prefill_s']:.0f} tok/s)")
    print(f"decode  {G - 1} steps: {out['decode_s'] * 1e3:.1f} ms "
          f"({B * (G - 1) / max(out['decode_s'], 1e-9):.0f} tok/s)")
    print("sample tokens[0]:", out["tokens"][0, :12].tolist())
    if args.state_save:
        path = sess.save_deployment(args.state_save)
        print(f"deployment saved: {len(sess._last_states)} call sites "
              f"-> {path}")
    if args.telemetry is not None:
        if not sent.ok:
            print(f"WARNING recompile sentinel tripped: {sent.violations}")
        from repro_torch.obs import snapshot, write_snapshot
        if args.telemetry == "-":
            print(json.dumps(snapshot(), indent=2, sort_keys=True))
        else:
            write_snapshot(args.telemetry)
            print(f"telemetry snapshot -> {args.telemetry}")
    return sess, out


if __name__ == "__main__":
    main()
