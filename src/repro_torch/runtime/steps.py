"""Step-function builders: the train step (AdamW on float32 masters, with
gradient accumulation), the prefill and decode steps, and the train
state's schema and placements (port of ``repro.runtime.steps``).

A train state is ``{"params", "opt": {"m", "v"}, "step"}``: float32
parameters, float32 moments, an int32 0-dim step.  ``abstract_train_state``
gives it as ``meta`` tensors (no memory), the template a checkpoint is
restored into.

On a mesh (``make_train_step(mesh=)``; a ``DeviceMesh`` of ``data`` and
``model``, ``parallel.train_mesh``) a rank holds its window of each leaf
of params, m and v (``train_state_specs``: the schema's spec, sanitized
on the mesh) and the batch rows ``train_mesh.batch_rows`` gives it.  The
step gathers each leaf whole for the forward (matrices cast to the
compute dtype first), splits the dense products over ``model``, and
brings each gradient back to the rank's window summed over ``data``;
AdamW updates the window, its clip norm summed over every rank's
windows.  The numbers are the replicated step's, to float tolerance.
``abstract_train_state`` and ``init_train_state`` take the mesh too; a
``MeshShape`` (axis names and sizes) serves the abstract state, which
is what the dry run places.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import DeviceLike, dtype_of, resolve_device
from repro_torch.configs.base import ArchConfig, ParallelConfig, TrainConfig
from repro_torch.models import model as M
from repro_torch.models.common import (P, ParamSchema, init_params,
                                       init_windows, sanitize_spec,
                                       shard_shape, tree_leaves,
                                       tree_map, use_mesh)
from repro_torch.optim.adamw import adamw_update, init_opt_state


def compute_dtype_of(pcfg: ParallelConfig) -> torch.dtype:
    return dtype_of(pcfg.compute_dtype)


def init_model_params(seed: int, cfg: ArchConfig, device: DeviceLike = None,
                      dtype=torch.float32):
    """The model's parameters from ``seed`` (``models.common.init_params``)."""
    return init_params(seed, M.model_schema(cfg), dtype=dtype, device=device)


def make_prefill_step(cfg: ArchConfig, pcfg: ParallelConfig):
    cdt = compute_dtype_of(pcfg)

    def prefill_step(params, batch):
        return M.prefill(params, batch["tokens"], cfg=cfg, pcfg=pcfg,
                         image_embeds=batch.get("image_embeds"),
                         enc_frames=batch.get("enc_frames"),
                         compute_dtype=cdt)

    return prefill_step


def make_decode_step(cfg: ArchConfig, pcfg: ParallelConfig):
    cdt = compute_dtype_of(pcfg)

    def decode_step(params, token, cache, pos):
        return M.decode_step(params, token, cache, pos, cfg=cfg, pcfg=pcfg,
                             compute_dtype=cdt)

    return decode_step


# --------------------------------------------------------------------------- #
# Train state
# --------------------------------------------------------------------------- #
def train_state_schema(cfg: ArchConfig) -> Dict[str, Any]:
    """``{"params", "opt": {"m", "v"}}`` schemas: m and v zeros shaped and
    placed like the params, float32."""
    ps = M.model_schema(cfg)
    zeros = tree_map(lambda p: ParamSchema(p.shape, "zeros", 0.0,
                                           torch.float32, p.spec), ps)
    return {"params": ps, "opt": {"m": zeros, "v": zeros}}


def train_state_specs(cfg: ArchConfig, mesh=None) -> Dict[str, Any]:
    """Each train-state leaf's spec sanitized on ``mesh`` (the step's is
    ``P()``)."""
    sch = train_state_schema(cfg)
    specs = tree_map(lambda p: sanitize_spec(p.shape, p.spec, mesh), sch)
    specs["step"] = P()
    return specs


def abstract_train_state(cfg: ArchConfig, mesh=None) -> Dict[str, Any]:
    """The train state as ``meta`` tensors of its shapes and dtypes: on a
    mesh, of a rank's window of each leaf (``shard_shape``)."""
    meta = tree_map(lambda s: torch.empty(
        shard_shape(s.shape, s.spec, mesh), dtype=s.dtype, device="meta"),
        train_state_schema(cfg))
    meta["step"] = torch.empty((), dtype=torch.int32, device="meta")
    return meta


def init_train_state(seed: int, cfg: ArchConfig, device: DeviceLike = None,
                     mesh=None):
    """Params from ``init_model_params(seed)``, zero moments, step 0; on a
    mesh, this rank's window of each (the unsharded values, bit for
    bit: ``models.common.init_windows``)."""
    dev = resolve_device(device)
    if mesh is None:
        params = init_model_params(seed, cfg, dev)
        opt = init_opt_state(params)
    else:
        sch = train_state_schema(cfg)
        params = init_windows(seed, sch["params"], mesh, device=dev)
        opt = init_opt_state(params)
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


# --------------------------------------------------------------------------- #
# Train step
# --------------------------------------------------------------------------- #
def make_grad_fn(cfg: ArchConfig, pcfg: ParallelConfig, tcfg: TrainConfig,
                 mesh=None):
    """``grad_fn(params, batch) -> (loss, {"xent", "aux"}, grads)``: the
    loss of ``models.model.lm_loss`` and its gradient with respect to the
    float32 masters (a tree shaped like ``params``), over
    ``pcfg.grad_accum`` microbatches (the grads accumulated in float32,
    the loss and its parts averaged).  ``batch`` holds ``tokens``,
    ``targets`` (B, S) integer tensors and ``mask`` (B, S) float32 on the
    params' device, and a frontend arch's ``image_embeds`` or
    ``enc_frames``.  On a ``mesh`` the params are the rank's windows, the
    batch its rows (``train_mesh.batch_rows``), the loss and its parts
    the whole batch's, and the grads the rank's windows of the step's."""
    cdt = compute_dtype_of(pcfg)
    if mesh is not None:
        from repro_torch.parallel.train_mesh import gather_tree
        specs = train_state_specs(cfg, mesh)["params"]
        shapes = tree_map(lambda p: tuple(p.shape), M.model_schema(cfg))

    def loss_of(params, batch):
        # matrices cast to the compute dtype once per step, before any
        # use (on a mesh before they are gathered); gradients flow back
        # through the casts to the f32 masters
        params = tree_map(
            lambda p: p.to(cdt)
            if (p.dim() >= 2 and p.dtype == torch.float32) else p, params)
        if mesh is not None:
            params = gather_tree(params, specs, shapes, mesh)
        return M.lm_loss(params, batch, cfg=cfg, pcfg=pcfg,
                         compute_dtype=cdt, z_coef=tcfg.z_loss)

    def value_and_grad(params, batch):
        # fresh leaves on the masters' storage: autograd's graph reaches
        # them, the caller's tensors stay plain
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad(), use_mesh(mesh):
            loss, parts = loss_of(live, batch)
            leaves = tree_leaves(live)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, gs)]
        parts = {k: v.detach() for k, v in parts.items()}
        if mesh is not None:
            # the rank's share was differentiated; the whole batch's loss
            loss = parts["xent"] + parts["aux"]
        return loss.detach(), parts, gs

    def grad_fn(params, batch):
        m = max(1, pcfg.grad_accum)
        if m == 1:
            loss, parts, grads = value_and_grad(params, batch)
            return loss, parts, _unflatten(params, grads)
        # microbatched accumulation: one microbatch's activations live at
        # a time; grads accumulate in fp32
        n = next(iter(batch.values())).shape[0] // m
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in tree_leaves(params)]
        loss = xent = aux = 0.0
        for i in range(m):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            l, p, g = value_and_grad(params, mb)
            for acc, gi in zip(grads, g):
                acc.add_(gi.float())
            loss, xent, aux = loss + l, xent + p["xent"], aux + p["aux"]
            del g
        grads = [g / m for g in grads]
        return (loss / m, {"xent": xent / m, "aux": aux / m},
                _unflatten(params, grads))

    return grad_fn


def make_train_step(cfg: ArchConfig, pcfg: ParallelConfig, tcfg: TrainConfig,
                    mesh=None):
    """``train_step(state, batch) -> (state, metrics)``: ``make_grad_fn``'s
    gradient, then ``adamw_update``.  The state is updated in place (its
    tensors keep their storage; ``step`` is a new tensor) and returned;
    metrics are 0-dim tensors ``loss``, ``xent``, ``aux``, ``gnorm`` and
    ``lr``, read by no one inside the step.  On a ``mesh`` the state is
    the rank's windows and the batch its rows (see the module
    docstring); every rank of the mesh calls the step."""
    grad_fn = make_grad_fn(cfg, pcfg, tcfg, mesh)
    specs = None if mesh is None else train_state_specs(cfg, mesh)["params"]

    def train_step(state, batch):
        loss, parts, grads = grad_fn(state["params"], batch)
        gnorm = None
        if mesh is not None:
            from repro_torch.parallel.train_mesh import global_norm
            gnorm = global_norm(grads, specs, mesh)
        _, _, om = adamw_update(state["params"], grads, state["opt"],
                                state["step"], tcfg, gnorm=gnorm)
        state["step"] = state["step"] + 1
        return state, {"loss": loss, **parts, **om}

    return train_step


def _unflatten(like, leaves):
    """``leaves`` (in ``tree_leaves(like)``' order) as a tree shaped like
    ``like``."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)

    return walk(like)
