"""Weights carried across from the JAX package, as numpy arrays.

* ``params_from_numpy(tree)`` -- the JAX model's parameter pytree as
  nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``) ->
  the port's parameters, same key paths (``embed``, ``final_norm``,
  ``decoder.scan.p{i}`` stacked on a leading period axis,
  ``decoder.tail.t{i}``) and dtypes (bfloat16 included).
* ``emulator_params_from_numpy`` / ``load_emulator_npz`` /
  ``save_emulator_npz`` -- the emulator format the reference's serve CLI
  loads: one array per ``conv{i}_w/_b``, ``fc{i}_w/_b`` and ``_meta``;
  keys starting with ``__`` are skipped on load.
* ``deployment_from_numpy`` / ``load_deployment_npz`` /
  ``save_deployment_npz`` -- the reference's deployment npz
  (``<tag>::<field>``, ``__eparams::<k>``, ``__deployment_spec``): the
  realized per-site device states (``gf``, ``out_perm``, ``sfeat``, read
  sigma and key, the affine) and the spec, read by either package.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.deployment import load_deployment as load_deployment_npz
from repro_torch.core.deployment import save_deployment as save_deployment_npz
from repro_torch.core.deployment import states_from_numpy as deployment_from_numpy


def tensor_from_numpy(a, device: DeviceLike = None) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) -> torch tensor of the same dtype."""
    a = np.asarray(a)
    dev = resolve_device(device)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(dev)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy; bfloat16 widens to float32 (numpy has no bf16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_from_numpy(tree, device: DeviceLike = None):
    """Nested dicts of numpy arrays -> nested dicts of tensors."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return tensor_from_numpy(tree, dev)


def emulator_params_from_numpy(d, device: DeviceLike = None
                               ) -> Dict[str, torch.Tensor]:
    """Emulator param dict (numpy arrays) -> float32 tensors; ``__`` keys
    are metadata and skipped."""
    dev = resolve_device(device)
    return {k: tensor_from_numpy(np.asarray(v, np.float32), dev)
            for k, v in d.items() if not k.startswith("__")}


def load_emulator_npz(path: str, device: DeviceLike = None
                      ) -> Dict[str, torch.Tensor]:
    with np.load(path, allow_pickle=False) as data:
        return emulator_params_from_numpy({k: data[k] for k in data.files},
                                          device)


def save_emulator_npz(path: str, params: Dict[str, torch.Tensor]) -> str:
    np.savez(path, **{k: tensor_to_numpy(v) for k, v in params.items()})
    return path

