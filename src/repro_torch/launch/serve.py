"""Serving: batched prefill + greedy/temperature decode with a KV cache, as
a CLI and as a programmatic ``ServeSession`` (port of
``repro.launch.serve``).

CLI:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
      --layers 2 --batch 4 --prompt-len 32 --gen 8 \
      --analog-backend emulator --emulator-params emulator.npz

runs on the GPU (``--device cpu`` runs on the CPU).  ``--arch`` is
gemma3-1b, recurrentgemma-2b, falcon-mamba-7b, deepseek-coder-33b,
qwen1.5-110b, command-r-plus-104b, phi3.5-moe-42b-a6.6b,
llama4-scout-17b-a16e, internvl2-76b or seamless-m4t-large-v2.  The
frontends are the reference's stubs: internvl2-76b takes
``frontend_tokens`` random patch embeddings over the prompt's first
positions (through the ``frontend.proj`` site; the prompt must be at
least that long), seamless-m4t-large-v2 a random frame a prompt
position, which its encoder reads (sites ``enc.<period>:...``) and
every decoder layer cross-attends to.  ``--reduced`` serves the
reference's tiny same-family config; ``--layers`` alone keeps the full
widths and cuts the depth.  ``--analog-backend`` is ``digital``,
``emulator`` (needs ``--emulator-params``), ``analytic`` or ``circuit``.
The MoE archs' experts never call dense(): their analog sites are the
attention projections, ``--analog-layers attn``; internvl2-76b's
projection is ``--analog-layers frontend.proj,attn``.

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
generate watched by a ``RecompileSentinel``.

Tensor-parallel analog serving (``parallel.sharding``):

  python -m repro_torch.launch.serve --arch gemma3-1b --layers 2 \
      --analog-backend emulator --emulator-params emulator.npz --mesh 2,2

starts ``DP*TP`` ranks (``--devices``, which must equal it, by default;
``launch.mesh.launch``), each serving the whole digital model and its
window of every analog state on a ``(data, model)`` mesh; rank 0 prints
the tokens and timings.  ``--device cpu`` runs the ranks on the CPU.
``--mesh-times`` has each rank generate once more with the sharded
forward's B1 launches and collectives synchronized and timed, and print
their milliseconds a call.  ``main`` then returns ``(None, out)``, rank
0's output with each rank's figures under ``out["ranks"]``: among them
its states' ``gf`` bytes, every byte its executor caches
(``AnalogExecutor.cache_bytes``) and, on the card, its peak allocation
and what stays allocated after the generate.  Many
requests with their own lengths and arrivals are served one level up, by
``launch.batching``.
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
    plain digital model.  A vision arch's ``image_embeds`` (B,
    ``frontend_tokens``, D) and an encoder arch's ``enc_frames`` (B, P,
    D) are drawn in bf16, each from its own derived seed.
    ``params``/``prompt``/``image_embeds``/``enc_frames`` override the
    seeded ones (the parity tests pass the reference's).

    ``prefill_traces`` / ``decode_traces`` stand for the reference's jit
    traces, which a ``RecompileSentinel(session=...)`` watches: the port
    compiles nothing, so each counts the one setup of its step at the
    first generate and stays at 1."""

    def __init__(self, arch: str, *, reduced: bool = True,
                 reduced_layers: Optional[int] = None, batch: int = 4,
                 prompt_len: int = 32, gen: int = 16,
                 temperature: float = 0.0, seed: int = 0, executor=None,
                 device: DeviceLike = None, params=None,
                 prompt: Optional[torch.Tensor] = None,
                 image_embeds: Optional[torch.Tensor] = None,
                 enc_frames: Optional[torch.Tensor] = None):
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

        def frontend_input(given, purpose, n):
            if given is None:
                g = torch.Generator(device=self.device)
                g.manual_seed(_derived_seed(seed, purpose))
                given = torch.randn((batch, n, cfg.d_model), generator=g,
                                    device=self.device)
            return given.to(self.device, torch.bfloat16)

        if cfg.frontend == "vision":
            self.batch["image_embeds"] = frontend_input(
                image_embeds, "image", cfg.frontend_tokens)
        if cfg.encoder_layers:
            self.batch["enc_frames"] = frontend_input(enc_frames, "frames",
                                                      prompt_len)
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
        recorded on a digital prefill of one token (and one image
        embedding or one frame: each site of the frontend and the
        encoder runs once whatever the length)."""
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
                self._prefill_step(self.params, {
                    k: v[:1, :1] for k, v in self.batch.items()})
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

        cache = M.zeros_cache(M.model_cache_schema(
            self.cfg, B, P + G,
            cross_len=P if self.cfg.encoder_layers else 0), dev)
        cache = _splice_tree(cache, pcache)
        del pcache
        tok = self._next_token(logits)
        out_tokens: List[torch.Tensor] = [tok]
        out_logits: List[torch.Tensor] = [logits]
        t0 = time.perf_counter()
        for i in range(G - 1):
            # the host's time until the step's launches return: no device
            # sync inside the loop (the synchronized total is
            # serve_decode_seconds)
            with OBS.span("serve_decode_step", "per-step decode latency, "
                          "host side (no device sync)", site=self.site,
                          arch=self.cfg.name):
                logits, cache = self._decode(tok, cache, P + i, states)
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

def build_parser() -> argparse.ArgumentParser:
    from repro_torch.configs import ARCH_NAMES
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", required=True,
                    help="one of " + ", ".join(ARCH_NAMES))
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
    ap.add_argument("--mesh", default=None, metavar="DP,TP",
                    help="serve the analog plane tensor-parallel on a "
                         "(data, model) mesh of DP*TP ranks: each rank keeps "
                         "its window of every state's tile lattice and one "
                         "all_reduce completes each analog matmul; needs a "
                         "non-digital --analog-backend")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks to start for --mesh (must be DP*TP, its "
                         "default)")
    ap.add_argument("--mesh-times", action="store_true",
                    help="with --mesh: generate once more per rank with B1 "
                         "and the collectives timed (synchronized)")
    return ap


def _mesh_shape(ap, args):
    try:
        dp, tp = (int(v) for v in args.mesh.split(","))
    except ValueError:
        ap.error(f"--mesh expects DP,TP (got {args.mesh!r})")
    if dp < 1 or tp < 1:
        ap.error(f"--mesh expects positive DP,TP (got {args.mesh!r})")
    return dp, tp


def main(argv: Optional[List[str]] = None):
    """Parse ``argv``, serve, print the timings; returns (session, output),
    or ``(None, output)`` under ``--mesh`` (rank 0's output, each rank's
    figures under ``"ranks"``)."""
    ap = build_parser()
    args = ap.parse_args(argv)
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
    if args.mesh is None:
        if args.devices > 1:
            ap.error("--devices starts the ranks of --mesh DP,TP")
        if args.mesh_times:
            ap.error("--mesh-times requires --mesh")
        return _serve(args)
    if args.analog_backend == "digital":
        ap.error("--mesh shards the analog plane and requires a "
                 "non-digital --analog-backend")
    dp, tp = _mesh_shape(ap, args)
    if args.devices not in (0, dp * tp):
        ap.error(f"--devices {args.devices} != DP*TP = {dp * tp}")
    from repro_torch.launch.mesh import launch
    ranks = launch(_serve_rank, dp * tp, args=(args,), device=args.device)
    out = dict(ranks[0]["out"])
    out["ranks"] = [r["stats"] for r in ranks]
    return None, out


def _serve_rank(rank: int, world: int, device: torch.device, args):
    """One rank of ``serve --mesh``: the serve on this rank's device and
    window, and its figures."""
    import numpy as np
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.parallel.sharding import mesh_coords
    dp, tp = (int(v) for v in args.mesh.split(","))
    mesh = make_serve_mesh(dp, tp, device)
    if rank == 0:
        print(f"serving mesh: (data, model) = ({dp}, {tp})", flush=True)
    args.device = str(device)
    eb = None
    if device.type == "cuda":
        from repro_torch.kernels.emulator_block import emulator_block as eb
        eb.emulator_block_unified_cuda.launches = 0
    sess, out = _serve(args, mesh=mesh, verbose=rank == 0)
    gf = full = 0       # this rank's gf bytes, the whole lattice's
    for st in (sess._last_states or {}).values():
        lat = st.window
        cell = st.gf.element_size() * int(np.prod(st.gf.shape[2:]))
        gf += cell * int(np.prod(st.gf.shape[:2]))
        full += cell * int(np.prod(lat[3:] if lat else st.gf.shape[:2]))
    G = args.gen
    stats = {"rank": rank, "coords": mesh_coords(mesh),
             "b1_launches": (eb.emulator_block_unified_cuda.launches
                             if eb is not None else 0),
             "gf_bytes": gf, "full_gf_bytes": full,
             "cache_bytes": sess.ex.cache_bytes()[1],
             "peak_bytes": (torch.cuda.max_memory_allocated(device)
                            if device.type == "cuda" else 0),
             "resident_bytes": (torch.cuda.memory_allocated(device)
                                if device.type == "cuda" else 0),
             "prefill_ms": out["prefill_s"] * 1e3,
             "decode_ms_step": out["decode_s"] * 1e3 / max(G - 1, 1)}
    if args.mesh_times:
        sess.ex.mesh_times = {}
        sess.generate(states=sess._last_states)
        for k, v in sess.ex.mesh_times.items():
            stats[f"{k}_ms"] = sum(v) / len(v)
            stats[f"{k}_calls"] = len(v)
        sess.ex.mesh_times = None
    print(f"rank {rank} {stats['coords']}: " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in stats.items() if k not in ("rank", "coords")),
        flush=True)
    return {"out": out if rank == 0 else None, "stats": stats}


def _serve(args, mesh=None, verbose: bool = True):
    """The serve of ``main``'s parsed ``args`` in this process (one rank
    of ``mesh`` when given); returns (session, output)."""
    say = print if verbose else (lambda *a, **k: None)
    if args.telemetry is not None:
        OBS.enable()
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
            geom=CASE_A, emulator_params=eparams, mesh=mesh)
        if args.conditioned_emulator:
            from repro_torch.nonideal import (N_SCENARIO_FEATURES,
                                              SCENARIO_FEATURE_NAMES)
            if not ex.emulator_conditioned:
                raise SystemExit(
                    "--conditioned-emulator: the params are not scenario-"
                    f"conditioned (periph width must be 2 + "
                    f"{N_SCENARIO_FEATURES}; train with "
                    "nonideal.train_conditioned_emulator)")
            say(f"conditioned emulator: {N_SCENARIO_FEATURES} scenario "
                f"features ({', '.join(SCENARIO_FEATURE_NAMES[:4])}, ...)")
        if args.state_load:
            from repro_torch.core.deployment import load_deployment
            loaded_states, dep = load_deployment(args.state_load, device,
                                                 executor=ex)
            ex.deploy(scenario=dep.scenario, key=dep.key, remap=dep.remap,
                      states=dep.states)
            say(f"deployment restored: {len(loaded_states)} call sites "
                f"from {args.state_load}")
        elif args.scenario:
            from repro_torch.core import prng
            from repro_torch.nonideal import get_scenario
            ex.deploy(scenario=get_scenario(args.scenario), age=args.age,
                      remap=args.fault_remap,
                      key=prng.fold_in(prng.key(args.seed), 0xDEF))
            say(f"analog scenario: {ex.scenario.name}"
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
    say(f"prefill {B}x{P}: {out['prefill_s'] * 1e3:.1f} ms "
        f"({B * P / out['prefill_s']:.0f} tok/s)")
    say(f"decode  {G - 1} steps: {out['decode_s'] * 1e3:.1f} ms "
        f"({B * (G - 1) / max(out['decode_s'], 1e-9):.0f} tok/s)")
    say("sample tokens[0]:", out["tokens"][0, :12].tolist())
    if args.state_save:
        if mesh is None:
            path = sess.save_deployment(args.state_save)
        else:
            # every rank of the model axis gathers; rank 0 writes
            from repro_torch.core.deployment import save_deployment
            states = ex.gather_states(sess._last_states)
            path = args.state_save
            if verbose:
                save_deployment(path, states, ex.deployment)
        say(f"deployment saved: {len(sess._last_states)} call sites "
            f"-> {path}")
    if args.telemetry is not None and verbose:
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
