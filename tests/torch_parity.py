"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on the CPU as its own tests run it, and arrays cross as
numpy.  Emulator params come from the reference's ``init_params`` and
reach the port through ``repro_torch.interop``.
"""
from __future__ import annotations

import numpy as np


def to_np(x) -> np.ndarray:
    """jax array / torch tensor -> float-comparable numpy array."""
    try:
        import torch
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            if x.dtype == torch.bfloat16:
                x = x.float()
            return x.numpy()
    except ImportError:
        pass
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


def tree_np(tree):
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    return np.asarray(tree)


def ref_emulator_params(geom, n_periph: int = 0, seed: int = 0):
    """Reference-initialized Conv4Xbar params as a numpy dict, with
    nonzero biases so the bias paths are exercised too."""
    import jax
    from repro.core.conv4xbar import conv4xbar_schema
    from repro.models.common import init_params
    p = init_params(jax.random.PRNGKey(seed), conv4xbar_schema(geom, n_periph))
    rng = np.random.default_rng(seed + 100)
    out = {}
    for k, v in p.items():
        a = np.asarray(v, np.float32)
        if k.endswith("_b"):
            a = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        out[k] = a
    return out


def both_emulator_params(geom, n_periph: int = 0, seed: int = 0):
    """(jax dict, torch dict) of the same emulator params."""
    import jax.numpy as jnp
    from repro_torch.interop import emulator_params_from_numpy
    npp = ref_emulator_params(geom, n_periph, seed)
    return ({k: jnp.asarray(v) for k, v in npp.items()},
            emulator_params_from_numpy(npp, device="cpu"))


def assert_close(got, want, rtol, atol, what=""):
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)
