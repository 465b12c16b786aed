"""Faults planted under the timed path, to show that the check sees
them (``tests/test_perfbench_faults.py`` on the CPU; on the card
``readings.py --fault <name>`` reads them at a cell's own size).  Each
takes the built ``cell.Program`` before its window and returns a
function that takes the fault out again.

* ``token``: every served token altered where the engine produces it
  (its argmax, plus one).
* ``state``: a decode step that returns its state unchanged (the tick
  runs on a copy of the KV cache; the engine keeps the old one).
* ``act``: the MLPs' activation altered where it is computed: GELU where
  the configuration says SiLU, in the dense and the expert MLPs alike.
"""
from __future__ import annotations

import torch


class _Torch:
    """``torch`` for the engine's module, with its argmax altered."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def argmax(x, dim=None, **kw):
        i = torch.argmax(x, dim=dim, **kw) if dim is not None \
            else torch.argmax(x, **kw)
        return (i + 1) % x.shape[-1]


def token(prog):
    from repro_torch.launch import batching
    batching.torch = _Torch()

    def undo():
        batching.torch = torch
    return undo


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def state(prog):
    eng = prog.engine
    dec = eng._decode_fn()

    def unchanged(tok, cache, pos, states):
        logits, _ = dec(tok, _clone(cache), pos, states)
        return logits, cache

    eng._decode = unchanged

    def undo():
        eng._decode = dec
    return undo


def act(prog):
    from repro_torch.models import blocks, common, moe
    right = common.activation

    def altered(name):
        return common.gelu if name == "silu" else right(name)

    blocks.activation = moe.activation = altered

    def undo():
        blocks.activation = moe.activation = right
    return undo


FAULTS = {"token": token, "state": state, "act": act}
