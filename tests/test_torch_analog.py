"""The port's AnalogExecutor at the ideal corner against the reference
executor's emulator fast path (``use_pallas=False``: the plain
``apply_blocklast`` route), within 2e-5 of max |y|; straight-through
gradients equal the digital ``ct @ w.T`` and ``x.T @ ct``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AnalogConfig as RefAnalogConfig  # noqa: E402
from repro.configs.rram_ps32 import CASE_A as REF_A, CASE_B as REF_B  # noqa: E402
from repro.core.analog import AnalogExecutor as RefExecutor  # noqa: E402
from repro_torch.configs.base import AnalogConfig  # noqa: E402
from repro_torch.configs.rram_ps32 import CASE_A, CASE_B  # noqa: E402
from repro_torch.core.analog import AnalogExecutor, _StateBinding  # noqa: E402
from repro_torch.models.common import dense, use_dense_hook  # noqa: E402
from torch_parity import both_emulator_params, to_np  # noqa: E402

GEOMS = {"A": (REF_A, CASE_A), "B": (REF_B, CASE_B)}


def _executors(g, npf=0, seed=0):
    rg, tg = GEOMS[g]
    jp, tp = both_emulator_params(rg, npf, seed=seed)
    ref = RefExecutor(acfg=RefAnalogConfig(enabled=True, backend="emulator"),
                      geom=rg, emulator_params=jp, use_pallas=False)
    ex = AnalogExecutor(AnalogConfig(enabled=True, backend="emulator"),
                        geom=tg, emulator_params=tp)
    return ref, ex


@pytest.mark.parametrize("g,npf,K,N,B,wdt", [
    ("A", 0, 150, 7, 5, "float32"), ("A", 0, 150, 7, 5, "bfloat16"),
    ("B", 0, 130, 9, 3, "float32"), ("B", 0, 130, 9, 3, "bfloat16"),
    ("A", 15, 100, 4, 4, "float32")])
def test_matmul_matches_reference(g, npf, K, N, B, wdt):
    ref, ex = _executors(g, npf, seed=1)
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    x = rng.standard_normal((B, K)).astype(np.float32)
    x[0, :3] = 0.0                               # exact-zero drives
    jw = jnp.asarray(w).astype(jnp.bfloat16 if wdt == "bfloat16" else jnp.float32)
    tw = torch.from_numpy(w).to(getattr(torch, wdt))
    want = to_np(ref.matmul(jnp.asarray(x), jw, "mlp.up"))
    got = to_np(ex.matmul(torch.from_numpy(x), tw, "mlp.up"))
    assert got.shape == want.shape == (B, N)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * float(np.abs(want).max()))


def test_leading_dims_and_dtype_follow_input():
    ref, ex = _executors("A")
    rng = np.random.default_rng(3)
    w = rng.standard_normal((70, 3)).astype(np.float32)
    x = rng.standard_normal((2, 3, 70)).astype(np.float32)
    want = to_np(ref.matmul(jnp.asarray(x).astype(jnp.bfloat16),
                            jnp.asarray(w), "t"))
    got = ex.matmul(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), "t")
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 3, 3)
    np.testing.assert_allclose(to_np(got), want, rtol=0,
                               atol=1e-2 * float(np.abs(want).max()))


def test_straight_through_gradients():
    _, ex = _executors("A")
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((90, 5)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3, 90)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    w.requires_grad_(True)
    x.requires_grad_(True)
    y = ex.matmul(x, w, "mlp.up")
    y.backward(ct)
    assert torch.allclose(x.grad, ct @ w.detach().T, rtol=1e-6, atol=1e-6)
    assert torch.allclose(w.grad, x.detach().T @ ct, rtol=1e-6, atol=1e-6)


def test_plan_cache_keyed_by_weight_identity():
    _, ex = _executors("A")
    w = torch.randn(70, 3)
    p1 = ex._plan_for(w, "t")
    assert ex._plan_for(w, "t") is p1
    assert ex._plan_for(w.clone(), "t") is not p1


def test_hook_routes_mlp_sites_and_keys_them_like_the_reference():
    _, tp = both_emulator_params(REF_A, 0)
    ex = AnalogExecutor(AnalogConfig(enabled=True, backend="emulator",
                                     layers=("mlp",)),
                        geom=CASE_A, emulator_params=tp)
    w = torch.randn(70, 3)
    x = torch.randn(2, 70)
    rec = {}
    b = _StateBinding(record=rec)
    with use_dense_hook(ex.hook), ex.bound_states(b):
        dense(x, w, "attn.q")                   # not an mlp tag: digital
        dense(x, w, "mlp.up")
        with b.scan_period("dec", 1):
            dense(x, w, "mlp.up")
        dense(x, w, "mlp.up")
    assert sorted(rec) == ["dec.1:mlp.up#0", "mlp.up#0", "mlp.up#1"]
    states = {k: ex.state_for(k, v) for k, v in rec.items()}
    with use_dense_hook(ex.hook), ex.bound_states(_StateBinding(states=states)):
        y = dense(x, w, "mlp.up")
        with pytest.raises(KeyError, match="no DeploymentState"):
            dense(x, w, "mlp.gate")
    assert torch.allclose(y, ex.matmul(x, w, "mlp.up#0"))


def test_unported_corners_raise():
    _, ex = _executors("A")
    with pytest.raises(NotImplementedError, match="A8"):
        ex.deploy(scenario="stressed")
    with pytest.raises(NotImplementedError, match="A5"):
        ex.calibrate(None, torch.zeros(3, 3), "t")
    with pytest.raises(NotImplementedError, match="A7"):
        AnalogExecutor(AnalogConfig(backend="circuit"))
    with pytest.raises(NotImplementedError, match="A8"):
        AnalogExecutor(AnalogConfig(backend="digital", scenario="stressed"))
