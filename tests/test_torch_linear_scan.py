"""B6, the diagonal gated linear recurrence: the port's entry point on CPU
tensors (its plain version, a sequential float32 carry) against the JAX
entry point (the Pallas kernel in interpret mode, 64-wide tiles) and the
JAX oracle (an associative scan, which sums in another order), on the
shapes of ``tests/test_kernels.py``, with and without h0, at that file's
tolerances: 1e-4 in float32, 3e-2 in bfloat16.  The kernel itself runs on
the card, where ``chip_smoke.py`` holds it against the plain version."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.linear_scan import linear_scan as ref_linear_scan  # noqa: E402
from repro.kernels.linear_scan.ref import linear_scan_ref as jax_ref  # noqa: E402
from repro_torch.kernels.linear_scan import linear_scan  # noqa: E402
from repro_torch.kernels.linear_scan.ref import linear_scan_ref  # noqa: E402
from torch_parity import assert_close  # noqa: E402

ls = importlib.import_module("repro_torch.kernels.linear_scan.linear_scan")
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(B, S, D, with_h0, dt):
    rng = np.random.default_rng(S + D)
    a = rng.uniform(0.5, 0.999, (B, S, D)).astype(np.float32)
    b = (0.1 * rng.standard_normal((B, S, D))).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32) if with_h0 else None
    jd, td, _ = DTYPES[dt]
    j = [None if x is None else jnp.asarray(x, jd) for x in (a, b, h0)]
    t = [None if x is None else torch.from_numpy(x).to(td) for x in (a, b, h0)]
    return j, t


@pytest.mark.parametrize("B,S,D", [(2, 256, 512), (1, 128, 1024), (4, 512, 64)])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_entry_point_matches_reference(B, S, D, with_h0, dt):
    (ja, jb, jh0), (ta, tb, th0) = _inputs(B, S, D, with_h0, dt)
    tol = DTYPES[dt][2]
    ls.linear_scan_cuda.launches = 0
    h, h_last = linear_scan(ta, tb, th0, block_d=64, block_s=64)
    assert ls.linear_scan_cuda.launches == 0     # the CPU takes the plain version
    assert h.dtype == ta.dtype and tuple(h.shape) == (B, S, D)
    assert torch.equal(h_last, h[:, -1])
    wh, wl = ref_linear_scan(ja, jb, jh0, block_d=64, block_s=64)
    assert_close(h, wh, tol, tol, "vs interpret-mode kernel")
    assert_close(h_last, wl, tol, tol, "h_last vs interpret-mode kernel")
    f32 = [None if x is None else x.astype(jnp.float32) for x in (ja, jb, jh0)]
    rh, rl = jax_ref(*f32)
    assert_close(h, rh, tol, tol, "vs the JAX oracle")
    assert_close(h_last, rl, tol, tol, "h_last vs the JAX oracle")
    # the port's oracle (a log-depth scan) against the JAX oracle
    tf = [None if x is None else x.float() for x in (ta, tb, th0)]
    oh, ol = linear_scan_ref(*tf)
    assert_close(oh, rh, 1e-4, 1e-4, "oracle")
    assert_close(ol, rl, 1e-4, 1e-4, "oracle h_last")


def test_h0_is_folded_into_the_first_step_in_b_dtype():
    """``b[:, 0] + a[:, 0] * h0`` rounded to b's dtype, then the scan with
    h0 = 0: the entry point hands the folded row to the kernel beside b."""
    _, (ta, tb, th0) = _inputs(2, 16, 8, True, "bf16")
    h, _ = linear_scan(ta, tb, th0)
    b = tb.clone()
    b[:, 0] = b[:, 0] + ta[:, 0] * th0
    assert torch.equal(h, ls.linear_scan_plain(ta, b))
    assert torch.equal(h, ls.linear_scan_plain(ta, tb, b[:, 0].contiguous()))


def test_cuda_entry_refuses_cpu_tensors():
    _, (ta, tb, _) = _inputs(1, 4, 8, False, "f32")
    ls.linear_scan_cuda.launches = 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        ls.linear_scan_cuda(ta, tb)
    assert ls.linear_scan_cuda.launches == 0


def test_entry_point_refuses_other_devices():
    meta = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no linear_scan kernel"):
        linear_scan(meta, meta)

