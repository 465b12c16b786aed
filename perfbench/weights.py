"""Weights from the seed, on the device, in the type they are served in.

All of a model's leaves are views of one flat bf16 buffer filled by ONE
normal draw of a ``torch.Generator`` on the device; each leaf is then
scaled in place: a projection by its schema's standard deviation, a norm
weight to 1 + 0.1 N(0, 1), a bias to 0.1 N(0, 1) (so the norms' scale
and shift paths carry values).  The emulator's parameters (a few
thousand floats) come the same way in float32.  The same seed gives the
same weights.
"""
from __future__ import annotations

from typing import Dict

import torch

from perfbench.loadgen import derive


def _leaves(schema, path=()):
    if isinstance(schema, dict):
        for k in sorted(schema):
            yield from _leaves(schema[k], path + (k,))
    else:
        yield path, schema


def _fill(schema, seed: int, purpose: str, dtype, device) -> Dict:
    leaves = list(_leaves(schema))
    total = sum(int(torch.Size(s.shape).numel()) for _, s in leaves)
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, purpose))
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(generator=g)
    views = {}
    at = 0
    for path, s in leaves:
        n = int(torch.Size(s.shape).numel())
        leaf = flat[at:at + n].view(s.shape)
        at += n
        if s.init == "zeros":
            leaf.mul_(0.1)
        elif s.init == "ones":
            leaf.mul_(0.1).add_(1.0)
        else:
            leaf.mul_(s.scale)
        views[path] = leaf

    def tree(node, path):
        if isinstance(node, dict):
            return {k: tree(v, path + (k,)) for k, v in node.items()}
        return views[path]

    return tree(schema, ())


def model_weights(cfg, seed: int, device) -> Dict:
    """The port's parameter tree for ``cfg`` (its own schema's shapes and
    scales), bf16 on ``device``."""
    from repro_torch.models.model import model_schema
    return _fill(model_schema(cfg), seed, "model", torch.bfloat16, device)


def emulator_weights(seed: int, device, n_periph: int = 2) -> Dict:
    """Conv4Xbar parameters of the paper's case-A block (random: B1's work
    does not depend on their values), float32 on ``device``."""
    from repro_torch.configs.rram_ps32 import CASE_A
    from repro_torch.core.conv4xbar import conv4xbar_schema
    p = _fill(conv4xbar_schema(CASE_A, n_periph), seed, "emulator",
              torch.float32, device)
    p["_meta"].zero_()
    return p
