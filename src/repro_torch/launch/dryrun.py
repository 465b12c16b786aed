"""Production dry run (port of ``repro.launch.dryrun``): every (arch x
shape x mesh) cell's step built on ``meta`` tensors -- nothing is
allocated -- with each device's bytes of state, batch and cache taken
from the placements, and the step's FLOPs.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod|--both-meshes]

The mesh is ``launch.mesh.make_production_mesh``'s (16, 16) or (2, 16,
16) by its axis names and sizes: a ``DeviceMesh`` of 256 or 512 ranks
needs a live group of them, so the dry run places every leaf through
the trainer's own placement functions (``models.common.shard_shape``
under each leaf's sanitized spec) and launches no rank.

A cell's record (``results/dryrun/<arch>_<shape>_<mesh>[_tag].json``):
``default_pcfg``'s knobs; ``memory``, a device's bytes of params (float32
masters in training, bfloat16 in serving), AdamW's m and v, the batch
(as the port feeds it: int64 tokens, float32 mask and frontend
embeddings) and the KV / recurrent cache (bfloat16, a global layer's
sequence on ``model`` under ``decode_seq_shard``); ``flops``, the step's
FLOPs counted by ``torch.utils.flop_counter.FlopCounterMode`` over the
unsharded step at the cell's global shapes on ``meta`` tensors (remat's
recompute included), divided by the chips -- or, where an op of the arch
does not run on ``meta`` (the linear-scan entry point takes CUDA or CPU
tensors), the model-FLOPs formula of ``PERF.md`` §2 (6 N tokens a train
step, 2 N tokens a forward, N the active params); ``flops.source`` says
which.  An unsupported (arch, shape) writes the reference's ``skipped``
record.

The reference's ``lower_s``, ``compile_s``, ``xla_cost`` and
``hlo_analysis`` come from XLA's lowering and compiled module, which the
port does not have, and are left out; the port does not import
``benchmarks/``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Dict

import torch

from repro_torch.configs import ARCH_NAMES, SHAPES_BY_NAME, get_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.common import P, shard_shape, tree_leaves
from repro_torch.runtime import steps as S

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun")
DP = ("pod", "data")


def default_pcfg(cfg, shape, mesh_name, overrides=None):
    kw = dict(overrides or {})
    dp = 32 if mesh_name == "multi" else 16
    # Big global-attention KV caches don't fit per-device batch shards:
    # shard the cache sequence dim over the model axis (flash-decode).
    if shape.mode == "decode" and any(k == "G" for k in cfg.pattern):
        kv_bytes = (cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim
                    * shape.seq_len * 2 * shape.global_batch)
        if kv_bytes > 64e9:
            kw.setdefault("decode_seq_shard", True)
    # Sequence-parallel residual stream (Megatron-SP): the remat stash
    # shrinks to num_periods x (B_loc, S/tp, D) -> usually no microbatching.
    if shape.mode in ("train", "prefill"):
        kw.setdefault("residual_seq_shard", True)
    # Auto grad-accum: microbatch until one microbatch's stash fits ~5 GB.
    if shape.mode == "train":
        b_loc = shape.global_batch // dp
        tp = 16 if kw.get("residual_seq_shard") else 1
        stash = cfg.num_periods * b_loc * shape.seq_len * cfg.d_model * 2 / tp
        m = 1
        while stash / m > 5e9 and m < b_loc:
            m *= 2
        if cfg.moe is not None:
            m = max(m, 4)       # MoE dispatch buffers scale with microbatch
        if m > 1:
            kw.setdefault("grad_accum", m)
    return ParallelConfig(**kw)


def _nbytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype).element_size()


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _batch(cfg, shape) -> Dict[str, tuple]:
    """The cell's batch: name -> (global shape, dtype, spec)."""
    B, Sq = shape.global_batch, shape.seq_len
    f32 = torch.float32
    if shape.mode == "decode":
        return {"token": ((B, 1), torch.int64, P(DP, None))}
    b = {"tokens": ((B, Sq), torch.int64, P(DP, None))}
    if shape.mode == "train":
        b["targets"] = ((B, Sq), torch.int64, P(DP, None))
        b["mask"] = ((B, Sq), f32, P(DP, None))
    if cfg.frontend == "vision":
        b["image_embeds"] = ((B, cfg.frontend_tokens, cfg.d_model), f32,
                             P(DP, None, None))
    if cfg.encoder_layers:
        b["enc_frames"] = ((B, Sq, cfg.d_model), f32, P(DP, None, None))
        if shape.mode == "prefill":
            b["tokens"] = ((B, max(Sq // 32, 8)), torch.int64, P(DP, None))
    return b


def device_bytes(cfg, shape, pcfg, mesh) -> Dict[str, int]:
    """A device's bytes of the cell's state, batch and cache on ``mesh``
    (``shard_shape`` of each leaf's spec)."""
    out = {}
    if shape.mode == "train":
        st = S.abstract_train_state(cfg, mesh)
        for name, tree in (("params", st["params"]), ("opt_m", st["opt"]["m"]),
                           ("opt_v", st["opt"]["v"])):
            out[name] = sum(_nbytes(t.shape, t.dtype)
                            for t in tree_leaves(tree))
    else:
        out["params"] = sum(
            _nbytes(shard_shape(p.shape, p.spec, mesh), torch.bfloat16)
            for p in tree_leaves(M.model_schema(cfg)))
    out["batch"] = sum(_nbytes(shard_shape(s, sp, mesh), dt)
                       for s, dt, sp in _batch(cfg, shape).values())
    if shape.mode == "decode":
        cs = _cache_schema(cfg, shape, pcfg)
        out["cache"] = sum(_nbytes(shard_shape(leaf[0], leaf[2], mesh),
                                   leaf[1]) for leaf in _cache_leaves(cs))
    out["total"] = sum(out.values())
    return out


def _cache_schema(cfg, shape, pcfg):
    return M.model_cache_schema(
        cfg, shape.global_batch, shape.seq_len,
        seq_shard=pcfg.decode_seq_shard,
        cross_len=shape.seq_len if cfg.encoder_layers else 0)


def _cache_leaves(cs):
    if isinstance(cs, tuple):
        return [cs]
    return [leaf for k in sorted(cs) for leaf in _cache_leaves(cs[k])]


def _meta_cache(cs):
    if isinstance(cs, tuple):
        return _meta(cs[0], cs[1])
    return {k: _meta_cache(v) for k, v in cs.items()}


def run_step(cfg, shape, pcfg):
    """The cell's step once, unsharded, at its global shapes on ``meta``
    tensors (no memory)."""
    batch = {k: _meta(s, dt) for k, (s, dt, _) in _batch(cfg, shape).items()}
    if shape.mode == "train":
        state = S.abstract_train_state(cfg)
        step = S.make_train_step(cfg, pcfg, TrainConfig())
        return step(state, batch)
    params = _meta_params(M.model_schema(cfg))
    if shape.mode == "prefill":
        return S.make_prefill_step(cfg, pcfg)(params, batch)
    cache = _meta_cache(_cache_schema(cfg, shape, pcfg))
    return S.make_decode_step(cfg, pcfg)(params, batch["token"], cache,
                                         shape.seq_len - 1)


def _meta_params(schema):
    if isinstance(schema, dict):
        return {k: _meta_params(v) for k, v in schema.items()}
    return _meta(schema.shape, torch.bfloat16)


def formula_flops(cfg, shape) -> float:
    """``PERF.md`` §2's model FLOPs of the cell's step: 6 N tokens to
    train, 2 N tokens a forward (a decode step's tokens: the batch), N
    the active params."""
    n = cfg.active_param_count()
    if shape.mode == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.mode == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def step_flops(cfg, shape, pcfg) -> Dict[str, object]:
    """The step's FLOPs: counted over the meta step, or the formula where
    the step does not run on meta."""
    from torch.utils.flop_counter import FlopCounterMode
    try:
        with FlopCounterMode(display=False) as fc:
            run_step(cfg, shape, pcfg)
        return {"step": float(fc.get_total_flops()),
                "source": "FlopCounterMode over the unsharded step on meta "
                          "tensors"}
    except Exception as e:            # noqa: BLE001 -- recorded
        return {"step": formula_flops(cfg, shape),
                "source": "model-FLOPs formula (PERF.md section 2)",
                "meta_error": f"{type(e).__name__}: {e}"[:300]}


def _save(rec, arch, shape_name, mesh_name, tag):
    os.makedirs(RESULTS_DIR, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    path = os.path.join(RESULTS_DIR,
                        f"{arch}_{shape_name}_{mesh_name}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def run_cell(arch, shape_name, multi_pod, pcfg_overrides=None,
             save=True, tag=""):
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    if not cfg.supports_shape(shape):
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "skipped", "tag": tag,
               "reason": "full-attention arch: long-context decode has no "
                         "sub-quadratic structure (see DESIGN.md)"}
        if save:
            _save(rec, arch, shape_name, mesh_name, tag)
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod)
    pcfg = default_pcfg(cfg, shape, mesh_name, pcfg_overrides)
    n_chips = 1
    for n in mesh.shape:
        n_chips *= n
    t0 = time.time()
    flops = step_flops(cfg, shape, pcfg)
    flops["per_device"] = flops["step"] / n_chips
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
        "status": "ok", "n_chips": int(n_chips),
        "pcfg": {k: getattr(pcfg, k) for k in
                 ("remat", "decode_seq_shard", "residual_seq_shard",
                  "grad_accum", "attn_block_kv", "xent_chunk",
                  "grad_compression")},
        "build_s": round(time.time() - t0, 2),
        "memory": device_bytes(cfg, shape, pcfg, mesh),
        "flops": flops,
        "params": int(cfg.param_count()),
        "active_params": int(cfg.active_param_count()),
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "mode": shape.mode,
    }
    if save:
        _save(rec, arch, shape_name, mesh_name, tag)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCH_NAMES for s in SHAPES_BY_NAME]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            label = f"{arch} x {shape} x {'multi' if mp else 'single'}"
            try:
                rec = run_cell(arch, shape, mp, tag=args.tag)
                if rec["status"] == "skipped":
                    print(f"[SKIP] {label}: {rec['reason']}", flush=True)
                else:
                    mem = rec["memory"]
                    print(f"[OK]   {label}: build={rec['build_s']}s "
                          f"flops/dev={rec['flops']['per_device']:.3e} "
                          f"({rec['flops']['source']}) "
                          f"bytes/dev={mem['total'] / 1e9:.2f}GB", flush=True)
            except Exception as e:    # noqa: BLE001 -- counted, printed
                failures += 1
                print(f"[FAIL] {label}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
