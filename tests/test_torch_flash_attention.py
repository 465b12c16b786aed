"""B5, online-softmax attention: the port's entry point on CPU tensors
(its plain version, the same blockwise online softmax) against the JAX
entry point (the Pallas kernel in interpret mode, 128-wide tiles) and the
JAX oracle, causal, windowed and bidirectional, at the tolerances of
``tests/test_kernels.py``: 2e-5 in float32, 2e-2 in bfloat16.  The shapes
are that file's, with S cut from 512 to 256 in the third (interpret mode
costs S^2); one S that is not a multiple of 128 is held against the JAX
oracle only, since the Pallas entry point asserts on it.  The kernel
itself runs on the card, where ``chip_smoke.py`` holds it against the
plain version."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as ref_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from torch_parity import assert_close  # noqa: E402

fa = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(B, H, S, D, dt):
    rng = np.random.default_rng(S + D)
    qkv = [rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(3)]
    jd, td, _ = DTYPES[dt]
    return ([jnp.asarray(x, jd) for x in qkv],
            [torch.from_numpy(x).to(td) for x in qkv])


@pytest.mark.parametrize("B,H,S,D", [(2, 2, 256, 64), (1, 4, 128, 128),
                                     (2, 1, 256, 32)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 128), (False, 0)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_entry_point_matches_reference(B, H, S, D, causal, window, dt):
    jq, tq = _inputs(B, H, S, D, dt)
    tol = DTYPES[dt][2]
    fa.flash_attention_cuda.launches = 0
    got = flash_attention(*tq, causal=causal, window=window,
                          block_q=128, block_kv=128)
    assert fa.flash_attention_cuda.launches == 0  # the CPU takes the plain version
    assert got.dtype == tq[2].dtype and tuple(got.shape) == (B, H, S, D)
    want = ref_flash(*jq, causal=causal, window=window, block_q=128,
                     block_kv=128)
    assert_close(got, want, tol, tol, "vs interpret-mode kernel")
    assert_close(got, jax_ref(*jq, causal=causal, window=window), tol, tol,
                 "vs the JAX oracle")
    assert_close(attention_ref(*tq, causal=causal, window=window),
                 jax_ref(*jq, causal=causal, window=window), tol, tol, "oracle")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ragged_sequence_matches_the_oracle(dt):
    """S = 200 is no multiple of the 128-key step: the last step is short."""
    jq, tq = _inputs(1, 2, 200, 48, dt)
    tol = DTYPES[dt][2]
    for causal, window in ((True, 0), (True, 64), (False, 0)):
        got = flash_attention(*tq, causal=causal, window=window)
        assert_close(got, jax_ref(*jq, causal=causal, window=window), tol,
                     tol, f"causal={causal} window={window}")


def test_key_step_moves_only_rounding():
    """The CUDA kernel steps over 32 keys, the reference over 128: in
    float32 the online softmax's step changes nothing but rounding."""
    _, tq = _inputs(1, 2, 256, 64, "f32")
    flat = [t.reshape(2, 256, 64) for t in tq]
    for causal, window in ((True, 0), (True, 100), (False, 0)):
        a = fa.flash_attention_plain(*flat, causal=causal, window=window,
                                     block_kv=32)
        b = fa.flash_attention_plain(*flat, causal=causal, window=window,
                                     block_kv=128)
        assert_close(a, b, 2e-6, 2e-6, f"causal={causal} window={window}")


def _kernel_numerics(q, k, v, *, causal, window, block_kv=32):
    """The CUDA kernel's arithmetic in plain PyTorch: the score scaled
    after the q.k product, exp taken as exp2 with scale*log2(e) folded into
    one float32 factor, 32-key steps, p rounded to v's dtype for p.v."""
    BH, S, D = q.shape
    c = torch.tensor(D ** -0.5 * 1.4426950408889634, dtype=torch.float32)
    m = torch.full((BH, S), fa.NEG_INF)
    l = torch.zeros((BH, S))
    acc = torch.zeros((BH, S, D))
    qp = torch.arange(S)[:, None]
    for k0 in range(0, S, block_kv):
        k1 = min(S, k0 + block_kv)
        s = (q.float() @ k[:, k0:k1].float().transpose(1, 2)) * c
        kp = torch.arange(k0, k1)[None, :]
        live = torch.ones((S, k1 - k0), dtype=torch.bool)
        if causal:
            live &= kp <= qp
        if window:
            live &= (qp - kp) < window
        s = torch.where(live, s, fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp2(s - m_new[..., None])
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1)
        m = m_new
        acc = acc * alpha[..., None] + p.to(v.dtype).float() @ v[:, k0:k1].float()
    return (acc / l.clamp_min(1e-20)[..., None]).to(v.dtype)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_scale_after_product_and_exp2_move_only_rounding(dt):
    """The kernel scales q.k after the product and takes exp2 of
    log2(e)-scaled scores; against the plain version (q scaled first,
    exp) that moves results by float32 rounding, and in bf16 by at most
    one bf16 ulp where p's rounding flips."""
    _, tq = _inputs(1, 3, 200, 48, dt)
    flat = [t.reshape(3, 200, 48) for t in tq]
    tol = 2e-6 if dt == "f32" else DTYPES[dt][2]
    for causal, window in ((True, 0), (True, 64), (False, 0)):
        got = _kernel_numerics(*flat, causal=causal, window=window)
        want = fa.flash_attention_plain(*flat, causal=causal, window=window)
        assert_close(got, want, tol, tol, f"causal={causal} window={window}")


def test_cuda_entry_refuses_cpu_tensors():
    _, tq = _inputs(1, 1, 8, 4, "f32")
    fa.flash_attention_cuda.launches = 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(*[t[0] for t in tq])
    assert fa.flash_attention_cuda.launches == 0


def test_entry_point_refuses_other_devices():
    meta = torch.empty((1, 1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="no flash_attention kernel"):
        flash_attention(meta, meta, meta)

