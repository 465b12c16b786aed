"""Hand-rolled AdamW on tensor trees: a warmup-cosine schedule, global-norm
clipping, bias correction and decoupled weight decay on matrices (port of
``repro.optim.adamw``, op for op).

``torch.optim.AdamW`` is not used: it decays the weights before the
moment update and adds epsilon to the uncorrected root, where the
reference clips, bias-corrects, adds epsilon to the corrected root and
decays in the same step.  The update runs in place, one leaf at a time
(a leaf's temporaries are the only extra memory), and returns the same
trees; the reference's donated buffers are the same contract.  Scalars
(the clip factor, the learning rate, the bias corrections) stay float32
tensors on the parameters' device, so a step reads nothing back to the
host.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.common import tree_leaves, tree_map


def init_opt_state(params):
    """m and v: float32 zeros shaped like each parameter, on its device."""
    def z(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(z, params), "v": tree_map(z, params)}


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.float32)


def lr_schedule(step, tcfg: TrainConfig, device=None) -> torch.Tensor:
    """Linear warmup over ``warmup_steps``, then a cosine from ``lr`` down
    to a tenth of it at ``total_steps``; a float32 tensor."""
    step = _f32(step, device)
    warm = torch.clamp_max((step + 1.0) / max(tcfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - tcfg.warmup_steps)
                       / max(tcfg.total_steps - tcfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return tcfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    added in the reference's order (dict keys sorted)."""
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, opt, step, tcfg: TrainConfig, gnorm=None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  ``grads`` mirrors ``params`` (any float
    dtype); ``opt`` is ``{"m", "v"}`` of float32 trees; ``step`` the
    step's index (an int or a 0-dim tensor).  ``gnorm``, the clip's
    global norm, defaults to ``global_norm(grads)``; a sharded step
    passes the norm over every rank's windows
    (``parallel.train_mesh.global_norm``), each rank's trees being its
    windows.  Returns (params, opt, {"gnorm", "lr"}), the first two the
    trees passed in."""
    ps, gs = tree_leaves(params), tree_leaves(grads)
    ms, vs = tree_leaves(opt["m"]), tree_leaves(opt["v"])
    dev = ps[0].device
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = torch.clamp_max(_f32(tcfg.grad_clip, dev)
                           / torch.clamp_min(gnorm, 1e-9), 1.0)
    lr = lr_schedule(step, tcfg, dev)
    t = _f32(step, dev) + 1.0
    bc1 = 1.0 - torch.pow(_f32(tcfg.b1, dev), t)
    bc2 = 1.0 - torch.pow(_f32(tcfg.b2, dev), t)
    for p, g, m, v in zip(ps, gs, ms, vs):
        g = g.float() * clip
        m.mul_(tcfg.b1).add_((1 - tcfg.b1) * g)
        v.mul_(tcfg.b2).add_((1 - tcfg.b2) * torch.square(g))
        upd = (m / bc1) / (torch.sqrt(v / bc2) + tcfg.eps)
        if p.dim() >= 2:           # decoupled weight decay on matrices only
            upd = upd + tcfg.weight_decay * p.float()
        p.copy_(p.float() - lr * upd)
    return params, opt, {"gnorm": gnorm, "lr": lr}
