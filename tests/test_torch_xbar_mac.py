"""B4, the nonlinear crossbar MAC: the port's entry point on CPU tensors
(its plain version) against the JAX entry point (the Pallas kernel in
interpret mode, 64-wide tiles) and the JAX oracle, on the shapes of
``tests/test_kernels.py`` (the non-divisible ones included), at that
file's tolerances: 1e-5 in float32, 3e-2 in bfloat16.  The kernel itself
runs on the card, where ``chip_smoke.py`` holds it against the plain
version."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.xbar_mac import xbar_mac as ref_xbar_mac  # noqa: E402
from repro.kernels.xbar_mac.ref import xbar_mac_ref as jax_ref  # noqa: E402
from repro_torch.kernels.xbar_mac import xbar_mac  # noqa: E402
from repro_torch.kernels.xbar_mac.ref import xbar_mac_ref  # noqa: E402
from repro_torch.kernels.xbar_mac.xbar_mac import (  # noqa: E402
    xbar_mac_cuda, xbar_mac_plain)
from torch_parity import assert_close  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(B, K, N, dt):
    rng = np.random.default_rng(B + K + N)
    v = rng.uniform(0, 0.2, (B, K)).astype(np.float32)
    g = rng.uniform(1e-6, 1e-4, (K, N)).astype(np.float32)
    jd, td, _ = DTYPES[dt]
    return ((jnp.asarray(v, jd), jnp.asarray(g, jd)),
            (torch.from_numpy(v).to(td), torch.from_numpy(g).to(td)))


@pytest.mark.parametrize("B,K,N", [(128, 128, 128), (256, 384, 128),
                                   (128, 512, 256), (64, 64, 64),
                                   (100, 70, 130), (65, 64, 63)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_entry_point_matches_reference(B, K, N, dt):
    (jv, jg), (tv, tg) = _inputs(B, K, N, dt)
    tol = DTYPES[dt][2]
    xbar_mac_cuda.launches = 0
    got = xbar_mac(tv, tg, block_b=64, block_n=64, block_k=64)
    assert xbar_mac_cuda.launches == 0           # the CPU takes the plain version
    assert got.dtype == tv.dtype and tuple(got.shape) == (B, N)
    want = ref_xbar_mac(jv, jg, block_b=64, block_n=64, block_k=64)
    assert_close(got, want, tol, tol, "vs interpret-mode kernel")
    assert_close(got, jax_ref(jv, jg), tol, tol, "vs the JAX oracle")
    # the port's oracle is the JAX oracle (drive in v's dtype)
    assert_close(xbar_mac_ref(tv, tg), jax_ref(jv, jg), tol, tol, "oracle")


def test_plain_version_widens_v_before_the_prologue():
    """The kernel's semantics: v is cast to float32 before relu(v - v_th) *
    (1 + beta*v); the oracle computes the drive in v's dtype."""
    (_, _), (tv, tg) = _inputs(8, 16, 4, "bf16")
    vf = tv.float()
    drive = torch.clamp_min(vf - 0.08, 0.0) * (1.0 + 0.6 * vf)
    want = (torch.tanh(3200.0 * (drive @ tg.float()))).to(torch.bfloat16)
    assert torch.equal(xbar_mac_plain(tv, tg), want)


def test_cuda_entry_refuses_cpu_tensors():
    (_, _), (tv, tg) = _inputs(4, 8, 3, "f32")
    xbar_mac_cuda.launches = 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        xbar_mac_cuda(tv, tg)
    assert xbar_mac_cuda.launches == 0


def test_entry_point_refuses_other_devices():
    with pytest.raises(ValueError, match="no xbar_mac kernel"):
        xbar_mac(torch.empty((2, 4), device="meta"),
                 torch.empty((4, 3), device="meta"))

