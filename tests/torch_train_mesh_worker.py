"""The rank side of ``tests/test_torch_train_mesh.py``: every contract of
training on a mesh in one world of ranks over gloo on the CPU.  Imports
torch and the port only (each rank is a spawned process; the test holds
what the ranks return against the port's replicated step and the JAX
package).

``contracts(rank, world, device, payload)`` builds the (2, 2), (4, 1)
and (1, 4) meshes over the one world and returns, per rank, a dict of
numpy arrays and figures."""
import dataclasses
from contextlib import nullcontext

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import AnalogConfig, ParallelConfig, TrainConfig
from repro_torch.configs.rram_ps32 import CASE_A
from repro_torch.core.analog import AnalogExecutor
from repro_torch.data import SyntheticLMData
from repro_torch.interop import emulator_params_from_numpy
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models.common import (tree_items, use_dense_hook, use_mesh,
                                       window)
from repro_torch.parallel import train_mesh as TM
from repro_torch.runtime import steps as S
from repro_torch.runtime.trainer import SimulatedFailure, Trainer

MESHES = ((2, 2), (4, 1), (1, 4))
# (case, arch, reduced layers or None, extra ParallelConfig, analog)
CASES = (("qwen", "qwen1.5-110b", None, {}, False),
         ("moe", "phi3.5-moe-42b-a6.6b", None, {}, False),
         ("rglru", "recurrentgemma-2b", None, {}, False),
         ("emulator", "gemma3-1b", 2, {}, True),
         ("seq", "gemma3-1b", None, {"residual_seq_shard": True}, False),
         ("bf16", "qwen1.5-110b", None, {"compute_dtype": "bfloat16"}, False))
B, SEQ, LR = 8, 16, 1e-3
PCFG = dict(compute_dtype="float32", attn_block_kv=16, xent_chunk=16)
TCFG = TrainConfig(lr=LR, warmup_steps=2)
DECODE = dict(B=2, S_max=64, pos=37)
TRAIN = dict(steps=4, fail_at=3, every=2, more=7)


def case_setup(case):
    """(cfg, pcfg, data) of a ``CASES`` entry."""
    _, arch, layers, extra, analog = next(c for c in CASES if c[0] == case)
    cfg = reduced(get_config(arch), layers=layers)
    if analog:
        cfg = dataclasses.replace(cfg, analog=AnalogConfig(
            enabled=True, backend="emulator", layers=("mlp",)))
    pcfg = ParallelConfig(**{**PCFG, **extra})
    return cfg, pcfg, SyntheticLMData(cfg, SEQ, B)


def port_batch(batch, rows=None):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v if rows is None
                                                  else v[rows]))
        out[k] = t.long() if k in ("tokens", "targets") else t
    return out


def executor(eparams, mesh=None):
    return AnalogExecutor(AnalogConfig(enabled=True, backend="emulator",
                                       layers=("mlp",)), geom=CASE_A,
                          emulator_params=eparams, mesh=mesh)


def decode_inputs():
    """q and a gemma3 global layer's whole cache, from a seed."""
    cfg = reduced(get_config("gemma3-1b"))
    g = torch.Generator().manual_seed(29)
    shape = (DECODE["B"], DECODE["S_max"], cfg.num_kv_heads, cfg.head_dim)
    q = torch.randn((DECODE["B"], 1, cfg.num_heads, cfg.head_dim), generator=g)
    return cfg, q, torch.randn(shape, generator=g), torch.randn(shape,
                                                                generator=g)


def _np(t):
    return t.detach().cpu().numpy()


def _step(cfg, pcfg, data, mesh, hook=None):
    """One sharded step from the seed-0 state on batch 0: (metrics, the
    init windows, the new params' windows)."""
    st = S.init_train_state(0, cfg, "cpu", mesh=mesh)
    init = {k: _np(v).copy() for k, v in tree_items(st["params"])}
    rows = TM.batch_rows(B, mesh, pcfg.grad_accum).numpy()
    batch = port_batch(data.batch(0), rows)
    step = S.make_train_step(cfg, pcfg, TCFG, mesh=mesh)
    with use_dense_hook(hook) if hook is not None else nullcontext():
        st, met = step(st, batch)
    return ({k: float(v) for k, v in met.items()}, init,
            {k: _np(v) for k, v in tree_items(st["params"])})


def contracts(rank, world, device, payload):
    import torch.distributed as dist
    meshes = {m: make_mesh_for(world, model_axis=m[1], device=device)
              for m in MESHES}
    out = {"rank": dist.get_rank()}
    eparams = emulator_params_from_numpy(
        dict(np.load(payload["emulator"])), "cpu")

    # -- one sharded step per case and mesh ---------------------------------
    for case, *_ in CASES:
        cfg, pcfg, data = case_setup(case)
        for m, mesh in meshes.items():
            if case == "bf16" and m != (2, 2):
                continue
            hook = None
            shapes = []
            if case == "emulator":
                ex = executor(eparams, mesh)
                hook = ex.hook
            if case == "seq":
                real = M.apply_layer

                def spy(*a, **kw):
                    shapes.append((tuple(a[1].shape), kw.get("seq_shard")))
                    return real(*a, **kw)

                M.apply_layer = spy
            try:
                met, init, new = _step(cfg, pcfg, data, mesh, hook)
            finally:
                if case == "seq":
                    M.apply_layer = real
            out[f"{case}:{m}"] = dict(metrics=met, init=init, new=new,
                                      residual=shapes)
            if case == "emulator":
                out[f"{case}:{m}"]["calls"] = sum(ex.calls.values())

    # -- sharded flash-decode, and a decode step on a sequence-sharded cache
    cfg, q, ck, cv = decode_inputs()
    for m, mesh in meshes.items():
        n = DECODE["S_max"] // m[1]
        t = mesh.get_local_rank("model")
        sl = slice(t * n, (t + 1) * n)
        out[f"flash:{m}"] = _np(A.sharded_flash_decode(
            q, ck[:, sl], cv[:, sl], DECODE["pos"], cfg, mesh=mesh))
    out["decode"] = _decode_step(meshes[(1, 4)], payload)

    # -- the trainer: a fault on every rank, remesh, the uninterrupted run --
    out["trainer"] = _trainers(meshes, payload)
    return out


def _decode_step(mesh, payload):
    """Logits of one decode step of reduced gemma3-1b (one stacked period,
    its global layer's cache sequence-sharded) from a seeded cache."""
    cfg = reduced(get_config("gemma3-1b"))
    pcfg = ParallelConfig(compute_dtype="float32", decode_seq_shard=True)
    params = S.init_model_params(0, cfg, "cpu")
    cache = seeded_cache(cfg)
    sch = M.model_cache_schema(cfg, DECODE["B"], DECODE["S_max"],
                               seq_shard=True)
    mine = {}
    for (k, v), (_, leaf) in zip(tree_items(cache), tree_items(
            _as_leaves(sch))):
        mine[k] = v[window(tuple(v.shape), leaf[2], mesh)].clone()
    local = _rebuild(cache, mine)
    token = torch.tensor([[3], [250]])
    with use_mesh(mesh):
        logits, _ = M.decode_step(params, token, local, DECODE["pos"],
                                  cfg=cfg, pcfg=pcfg,
                                  compute_dtype=torch.float32)
    return _np(logits)


def seeded_cache(cfg):
    """A whole decode cache of reduced gemma3-1b, from a seed."""
    g = torch.Generator().manual_seed(31)
    sch = M.model_cache_schema(cfg, DECODE["B"], DECODE["S_max"],
                               dtype=torch.float32)

    def fill(node):
        if isinstance(node, tuple):
            return torch.randn(node[0], generator=g).to(node[1])
        return {k: fill(node[k]) for k in sorted(node)}

    return fill(sch)


class _Leaf(tuple):
    pass


def _as_leaves(node):
    if isinstance(node, tuple):
        return _Leaf(node)
    return {k: _as_leaves(v) for k, v in node.items()}


def _rebuild(like, flat, path=()):
    from repro_torch.models.common import key_path
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, path + (k,)) for k, v in like.items()}
    return flat[key_path(path)]


def _trainers(meshes, payload):
    """(2, 2): 4 steps, a checkpoint every 2, a SimulatedFailure on every
    rank at step 3 (once), then ``remesh`` onto (4, 1) to step 7; an
    uninterrupted (2, 2) run to step 6 in a directory of its own."""
    cfg, pcfg, data = case_setup("qwen")
    tcfg = TrainConfig(lr=LR, warmup_steps=2, total_steps=TRAIN["more"],
                       checkpoint_every=TRAIN["every"], keep_checkpoints=3)
    fired = []

    def hook(step):
        if step == TRAIN["fail_at"] and not fired:
            fired.append(step)
            raise SimulatedFailure(f"injected at step {step}")

    tr = Trainer(cfg=cfg, pcfg=pcfg, tcfg=tcfg, mesh=meshes[(2, 2)],
                 data=data, ckpt_dir=payload["ckpt_a"], fault_hook=hook,
                 device="cpu")
    s1 = tr.run(TRAIN["steps"])
    tr2 = tr.remesh(meshes[(4, 1)])
    s2 = tr2.run(TRAIN["more"])
    tru = Trainer(cfg=cfg, pcfg=pcfg, tcfg=tcfg, mesh=meshes[(2, 2)],
                  data=data, ckpt_dir=payload["ckpt_b"], device="cpu")
    s3 = tru.run(TRAIN["more"] - 1)

    def log(t):
        return [(r["step"], r["loss"], r["gnorm"]) for r in t.metrics_log]

    return dict(summaries=(s1, s2, s3), faulted=log(tr), remeshed=log(tr2),
                uninterrupted=log(tru), steps_a=tr2.ckpt.all_steps(),
                steps_b=tru.ckpt.all_steps(), builds=tr.builds)
