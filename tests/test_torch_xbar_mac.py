"""B4, the nonlinear crossbar MAC: the port's entry point on CPU tensors
(its plain version) against the JAX entry point (the Pallas kernel in
interpret mode, 64-wide tiles) and the JAX oracle, on the shapes of
``tests/test_kernels.py`` (the non-divisible ones included), at that
file's tolerances: 1e-5 in float32, 3e-2 in bfloat16; the numerics the
kernel's design rests on (the bf16 drive rounding, 3xTF32 products).  The
kernel itself runs on the card, where ``chip_smoke.py`` holds it against
the plain version."""

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
    (1 + beta*v), and in bf16 that float32 drive is rounded to bf16 for
    the bf16 product; the oracle computes the drive in v's dtype."""
    (_, _), (tv, tg) = _inputs(8, 16, 4, "bf16")
    vf = tv.float()
    drive = torch.clamp_min(vf - 0.08, 0.0) * (1.0 + 0.6 * vf)
    drive = drive.to(torch.bfloat16).float()
    want = (torch.tanh(3200.0 * (drive @ tg.float()))).to(torch.bfloat16)
    assert torch.equal(xbar_mac_plain(tv, tg), want)


def _operating_point(B, K, N, seed=0):
    """chip_smoke.py's B4 inputs: v ~ U(0, 0.2), g ~ U(0, g_hi) with g_hi
    putting gain * acc / v_sat near 0.8, in tanh's working range."""
    rng = np.random.default_rng(seed)
    v = (0.2 * rng.random((B, K))).astype(np.float32)
    g_hi = 2 * 0.8 / (3200.0 * K * 0.0395)
    g = (g_hi * rng.random((K, N))).astype(np.float32)
    return v, g


@pytest.mark.parametrize("B,K,N", [(16, 256, 64), (100, 70, 130)])
def test_bf16_drive_rounding_matches_the_jax_entry_point(B, K, N):
    """The plain version's bf16 mode (the drive rounded to bf16) against
    the JAX entry point (interpret mode), which keeps the drive in
    float32, at the reference's bf16 tolerance."""
    v, g = _operating_point(B, K, N)
    tv, tg = (torch.from_numpy(x).to(torch.bfloat16) for x in (v, g))
    jv, jg = (jnp.asarray(x, jnp.bfloat16) for x in (v, g))
    got = xbar_mac_plain(tv, tg)
    want = ref_xbar_mac(jv, jg, block_b=64, block_n=64, block_k=64)
    assert_close(got, want, 3e-2, 3e-2, "bf16 mode vs interpret-mode kernel")


@pytest.mark.parametrize("B,K,N", [(128, 1152, 256), (32, 6912, 64),
                                   (100, 70, 130)])
def test_bf16_drive_rounding_gap_before_output_rounding(B, K, N):
    """Rounding the drive to bf16 moves the float32 output (before its own
    bf16 rounding) by at most 1e-3 at chip_smoke's operating point: under
    one bf16 ulp of an output near 0.66 (3.9e-3)."""
    v, g = _operating_point(B, K, N, seed=B + K + N)
    vf = torch.from_numpy(v).to(torch.bfloat16).float()
    gf = torch.from_numpy(g).to(torch.bfloat16).float()
    drive = torch.clamp_min(vf - 0.08, 0.0) * (1.0 + 0.6 * vf)
    exact = torch.tanh(3200.0 * (drive @ gf))
    rounded = torch.tanh(3200.0 * (drive.to(torch.bfloat16).float() @ gf))
    assert float(exact.abs().median()) > 0.3        # the working range
    assert float((rounded - exact).abs().max()) <= 1e-3


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 as cvt.rna.tf32.f32 does: 10 mantissa bits,
    to nearest, ties away from zero."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels' fp32 mode forms it: each operand split into
    tf32 hi + lo, and a_hi b_lo + a_lo b_hi + a_hi b_hi summed in fp32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bl + al @ bh + ah @ bh


@pytest.mark.parametrize("case", ["xbar mlp.up", "attention scores"])
def test_3xtf32_product_holds_the_fp32_gate(case):
    """The fp32 modes of B4 and B5 run their products as 3xTF32; on the
    CPU that split product stays within chip_smoke's fp32 gate (rtol 1e-4
    / atol 1e-5) of the float32 product, on B4's operating point through
    the saturation and on attention's unit-normal q.k^T, where one TF32
    product would not (at B4's point, all of whose terms are positive,
    one pass happens to hold it too)."""
    if case == "xbar mlp.up":
        v, g = _operating_point(8, 1152, 256, seed=3)
        vf = torch.from_numpy(v)
        a = torch.clamp_min(vf - 0.08, 0.0) * (1.0 + 0.6 * vf)
        b = torch.from_numpy(g)
        out = lambda acc: torch.tanh(3200.0 * acc)      # noqa: E731
    else:
        rng = np.random.default_rng(4)
        a = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32))
        out = lambda acc: acc * 256 ** -0.5              # noqa: E731
    want = out(a @ b)
    got = out(_matmul_3xtf32(a, b))
    assert_close(got, want, 1e-4, 1e-5, "3xTF32 vs float32")
    if case == "attention scores":
        one_pass = out(_tf32(a) @ _tf32(b))
        err = (one_pass - want).abs() - (1e-5 + 1e-4 * want.abs())
        assert float(err.max()) > 0, "one TF32 pass should miss the gate"


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

