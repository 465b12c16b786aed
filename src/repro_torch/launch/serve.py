"""Serving: batched prefill + greedy/temperature decode with a KV cache, as
a CLI and as a programmatic ``ServeSession`` (port of
``repro.launch.serve``).

CLI:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
      --layers 2 --batch 4 --prompt-len 32 --gen 8 \
      --analog-backend emulator --emulator-params emulator.npz

runs on the GPU (``--device cpu`` runs on the CPU).  ``--reduced`` serves
the reference's tiny same-family config; ``--layers`` alone keeps the
full widths and cuts the depth.  ``--analog-backend`` is ``digital``,
``emulator`` (needs ``--emulator-params``), ``analytic`` or ``circuit``.

``ServeSession`` builds the model once, discovers every analog dense()
call site (keys ``"<tag>#<ordinal>"`` for tail layers and
``"dec.<period>:<tag>#<ordinal>"`` for stacked periods, as in the
reference) and serves each site with its ``DeploymentState``.  This
slice serves the ideal corner; the reference's scenario, aging, remap,
state save/load, mesh and telemetry flags raise ``NotImplementedError``
naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Dict, List, Optional

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.models.common import fold_seed


def _derived_seed(seed: int, purpose: str) -> int:
    """Independent seed per stochastic purpose (init, prompt, sampling)."""
    return fold_seed(seed, purpose)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _splice(z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Write prefill cache ``c`` at the origin of generation cache ``z``
    (the reference's ``dynamic_update_slice`` at zeros)."""
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
    (the parity tests pass the reference's)."""

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
        self._prefill_step = S.make_prefill_step(cfg, pcfg)
        self._decode_step = S.make_decode_step(cfg, pcfg)
        self._sites: Optional[Dict[str, torch.Tensor]] = None

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
        return {sk: self.ex.state_for(sk, w) for sk, w in self.sites().items()}

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
        if states is None:
            states = self.states() if self.ex is not None else {}
        B, P, G = self.B, self.P, self.G
        dev = self.device

        _sync(dev)
        t0 = time.perf_counter()
        with self._bound(states):
            logits, pcache = self._prefill_step(self.params, self.batch)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        cache = M.zeros_cache(M.model_cache_schema(self.cfg, B, P + G), dev)
        cache = _splice_tree(cache, pcache)
        del pcache
        tok = self._next_token(logits)
        out_tokens: List[torch.Tensor] = [tok]
        out_logits: List[torch.Tensor] = [logits]
        t0 = time.perf_counter()
        for i in range(G - 1):
            with self._bound(states):
                logits, cache = self._decode_step(self.params, tok, cache,
                                                  P + i)
            tok = self._next_token(logits)
            out_tokens.append(tok)
            out_logits.append(logits)
        _sync(dev)
        t_decode = time.perf_counter() - t0
        return {"tokens": torch.cat(out_tokens, dim=1).cpu().numpy(),
                "logits": torch.stack(out_logits).float().cpu().numpy(),
                "prefill_s": t_prefill, "decode_s": t_decode}


# --------------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------------- #
_NOT_PORTED = {
    "scenario": "A8", "age": "A8", "fault_remap": "A8",
    "conditioned_emulator": "A8", "state_save": "A1/A8",
    "state_load": "A1/A8", "mesh": "A11", "telemetry": "A10",
    "devices": "A11",
}


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
    # reference flags whose subsystems are not ported yet
    ap.add_argument("--scenario", default=None)
    ap.add_argument("--age", type=float, default=None)
    ap.add_argument("--fault-remap", action="store_true")
    ap.add_argument("--conditioned-emulator", action="store_true")
    ap.add_argument("--state-save", default=None)
    ap.add_argument("--state-load", default=None)
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--telemetry", nargs="?", const="-", default=None)
    ap.add_argument("--devices", type=int, default=0)
    return ap


def main(argv: Optional[List[str]] = None):
    """Parse ``argv``, serve, print the timings; returns (session, output)."""
    args = build_parser().parse_args(argv)
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag) not in (None, False, 0):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet "
                f"(ROADMAP {item}); this slice serves the ideal corner")
    device = resolve_device(args.device)
    ex = None
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
        ex = AnalogExecutor(
            acfg=AnalogConfig(enabled=True, backend=args.analog_backend,
                              layers=("mlp",)),
            geom=CASE_A, emulator_params=eparams)
    sess = ServeSession(args.arch, reduced=args.reduced,
                        reduced_layers=args.layers, batch=args.batch,
                        prompt_len=args.prompt_len, gen=args.gen,
                        temperature=args.temperature, seed=args.seed,
                        executor=ex, device=device)
    out = sess.generate()
    B, P, G = args.batch, args.prompt_len, args.gen
    print(f"prefill {B}x{P}: {out['prefill_s'] * 1e3:.1f} ms "
          f"({B * P / out['prefill_s']:.0f} tok/s)")
    print(f"decode  {G - 1} steps: {out['decode_s'] * 1e3:.1f} ms "
          f"({B * (G - 1) / max(out['decode_s'], 1e-9):.0f} tok/s)")
    print("sample tokens[0]:", out["tokens"][0, :12].tolist())
    return sess, out


if __name__ == "__main__":
    main()
