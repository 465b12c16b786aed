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
from repro_torch.kernels.emulator_block import emulator_block as eb  # noqa: E402
from torch_parity import assert_close, both_emulator_params, to_np  # noqa: E402

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
    """Non-ideal corners are ported (``tests/test_torch_nonideal.py``):
    ``deploy`` and a config's scenario name now resolve through the
    registry; unknown backends and names still raise."""
    _, ex = _executors("A")
    assert ex.deploy(scenario="stressed").scenario.name == "stressed"
    assert AnalogExecutor(AnalogConfig(backend="digital", scenario="stressed")
                          ).scenario.name == "stressed"
    with pytest.raises(KeyError, match="unknown scenario"):
        ex.deploy(scenario="no_such_corner")
    with pytest.raises(ValueError, match="unknown analog backend"):
        AnalogExecutor(AnalogConfig(backend="spice"))
    with pytest.raises(ValueError, match="no analog forward"):
        AnalogExecutor(AnalogConfig(backend="digital")).raw_matmul(
            torch.zeros(2, 3), torch.zeros(3, 3))
    # the circuit and analytic backends and calibration are ported now
    for b in ("circuit", "analytic"):
        assert AnalogExecutor(AnalogConfig(backend=b)).acfg.backend == b


# --------------------------------------------------------------------------- #
# The paper-faithful slow path (fast_path=False), the circuit and analytic
# backends, and calibration, against the reference executor
# --------------------------------------------------------------------------- #
# (backend, rtol, atol): the emulator at the kernel-parity tolerance, the
# analytic model bit-close (its column sums follow the reference's order),
# the circuit solver at the labelling tolerance of tests/test_torch_circuit
SLOW_TOL = {"emulator": (2e-5, 2e-6), "analytic": (1e-6, 1e-8),
            "circuit": (1e-5, 1e-6)}


def _slow_pair(backend, g="A", npf=2, seed=0, fast_path=False):
    rg, tg = GEOMS[g]
    kw_r, kw_t = {}, {}
    if backend == "emulator":
        jp, tp = both_emulator_params(rg, npf, seed=seed)
        kw_r, kw_t = dict(emulator_params=jp), dict(emulator_params=tp)
    ref = RefExecutor(acfg=RefAnalogConfig(enabled=True, backend=backend),
                      geom=rg, fast_path=fast_path, use_pallas=False, **kw_r)
    ex = AnalogExecutor(AnalogConfig(enabled=True, backend=backend), geom=tg,
                        fast_path=fast_path, **kw_t)
    return ref, ex


def _wx(K, N, B, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.3).astype(np.float32)
    x = (rng.standard_normal((B, K)) * 0.5).astype(np.float32)
    x[0, :5] = 0.0
    return w, x


@pytest.mark.parametrize("backend,g,K,N,B", [
    ("emulator", "A", 150, 7, 3), ("emulator", "B", 130, 9, 2),
    ("analytic", "A", 150, 7, 3), ("analytic", "B", 130, 9, 2),
    ("circuit", "A", 150, 7, 3), ("circuit", "B", 130, 9, 2)])
def test_slow_path_raw_matmul_matches_reference(backend, g, K, N, B):
    ref, ex = _slow_pair(backend, g, seed=K)
    w, x = _wx(K, N, B, seed=K + N)
    eb.emulator_block_grid_cuda.launches = 0
    yr, xsr = ref.raw_matmul(jnp.asarray(x), jnp.asarray(w), "t")
    yt, xst = ex.raw_matmul(torch.from_numpy(x), torch.from_numpy(w), "t")
    assert float(xst) == float(xsr)
    rtol, atol = SLOW_TOL[backend]
    assert_close(yt, yr, rtol, atol)
    assert eb.emulator_block_grid_cuda.launches == 0     # CPU: plain version


def test_conditioned_slow_path_with_scenario_features_matches_reference():
    """A conditioned net (P = 2 + 13) given scenario features goes through
    ``build_x`` and the per-block periph (B2's route); without them it
    takes the grid route, whose periph is the ideal (1, 0, ...)."""
    ref, ex = _slow_pair("emulator", "A", npf=15, seed=5)
    w, x = _wx(140, 5, 2, seed=6)
    sf = (np.random.default_rng(7).standard_normal(13) * 0.5).astype(np.float32)
    for sfeat in (sf, np.zeros(13, np.float32)):
        yr, _ = ref.raw_matmul(jnp.asarray(x), jnp.asarray(w), "t",
                               sfeat=jnp.asarray(sfeat))
        yt, _ = ex.raw_matmul(torch.from_numpy(x), torch.from_numpy(w), "t",
                              sfeat=torch.from_numpy(sfeat))
        assert_close(yt, yr, 2e-5, 2e-6)
    y0, _ = ex.raw_matmul(torch.from_numpy(x), torch.from_numpy(w), "t")
    assert_close(y0, yt, 2e-6, 1e-7)             # zeros = the ideal corner


@pytest.mark.parametrize("g,npf,K,N,B", [("A", 2, 300, 10, 4), ("B", 2, 200, 12, 3),
                                         ("A", 15, 130, 6, 2)])
def test_slow_path_matches_fast_path(g, npf, K, N, B):
    """The reference's own fast/slow tolerance
    (tests/test_analog_fastpath.py)."""
    _, slow = _slow_pair("emulator", g, npf=npf, seed=1)
    fast = AnalogExecutor(AnalogConfig(enabled=True, backend="emulator"),
                          geom=GEOMS[g][1], emulator_params=slow.emulator_params)
    w, x = _wx(K, N, B, seed=2)
    ys, xs1 = slow.raw_matmul(torch.from_numpy(x), torch.from_numpy(w), "t")
    yf, xs2 = fast.raw_matmul(torch.from_numpy(x), torch.from_numpy(w), "t")
    assert float(xs1) == float(xs2)
    assert_close(yf, ys, 2e-4, 1e-5)


@pytest.mark.parametrize("backend,fast_path", [("emulator", True), ("emulator", False),
                                               ("analytic", False), ("circuit", False)])
def test_calibrate_matches_reference(backend, fast_path):
    import jax
    ref, ex = _slow_pair(backend, "A", seed=3, fast_path=fast_path)
    w, _ = _wx(128, 6, 1, seed=4)
    key = jax.random.PRNGKey(5)
    n = 32
    for warm in (False, True):
        n_eff = max(8, n // 2) if warm else n
        xc = np.array(jax.random.normal(key, (n_eff, w.shape[0])) * 0.5)
        a_r, b_r = ref.calibrate(key, jnp.asarray(w), "t", n=n, warm_start=warm)
        if warm:                       # the warm fit starts from each side's own
            ex.calibration["t"] = ref_cold   # cold affine; hold it to one
        a_t, b_t = ex.calibrate(torch.from_numpy(xc), torch.from_numpy(w), "t",
                                warm_start=warm)
        assert ex._last_calib_n == ref._last_calib_n == n_eff
        assert abs(a_t - a_r) <= 1e-5 * max(1.0, abs(a_r)), (warm, a_t, a_r)
        assert abs(b_t - b_r) <= 1e-5, (warm, b_t, b_r)
        ref_cold = (a_r, b_r)
    # the fitted affine is what matmul applies
    x = torch.from_numpy(_wx(128, 6, 3, seed=9)[1])
    yv, xs = ex.raw_matmul(x, torch.from_numpy(w), "t")
    y = ex.matmul(x, torch.from_numpy(w), "t")
    assert_close(y, (a_t * yv + b_t) * xs, 1e-5, 1e-6)


def test_calibrate_warm_without_previous_affine_is_cold():
    _, ex = _slow_pair("analytic")
    w, x = _wx(100, 4, 16, seed=1)
    cold = ex.calibrate(torch.from_numpy(x), torch.from_numpy(w), "t")
    ex.calibration.clear()
    warm = ex.calibrate(torch.from_numpy(x), torch.from_numpy(w), "t",
                        warm_start=True)
    assert cold == warm


@pytest.mark.parametrize("g,K,N,M,wdt", [("A", 150, 7, 3, "float32"),
                                         ("B", 130, 9, 2, "float32"),
                                         ("A", 100, 5, 2, "bfloat16")])
def test_build_x_bit_for_bit(g, K, N, M, wdt):
    from repro.core.crossbar import build_conductance_plan as ref_plan
    from repro_torch.core.crossbar import build_conductance_plan
    rg, tg = GEOMS[g]
    w, _ = _wx(K, N, 1, seed=K)
    rng = np.random.default_rng(M)
    jw = jnp.asarray(w).astype(jnp.bfloat16 if wdt == "bfloat16" else jnp.float32)
    tw = torch.from_numpy(w).to(getattr(torch, wdt))
    rp = ref_plan(jw, RefAnalogConfig(), rg)
    tpl = build_conductance_plan(tw, AnalogConfig(), tg)
    vb = rng.uniform(0, 0.2, (M, tpl.NB, tpl.D, tpl.rows)).astype(np.float32)
    want = rp.build_x(jnp.asarray(vb))
    got = tpl.build_x(torch.from_numpy(vb))
    assert tuple(got.shape) == (M * tpl.n_blocks, 2, tpl.D, tpl.rows, 2 * tpl.no)
    np.testing.assert_array_equal(to_np(got), to_np(want))


def test_slow_path_grid_operands_are_the_reference_block_tensors():
    """B3's operands rebuild ``normalize_features(build_x(...))`` bit for
    bit: the drive channel ``(v * v_read) / v_read`` and ``g_norm``."""
    from repro_torch.core.emulator import normalize_features
    _, ex = _slow_pair("emulator", "B", seed=2)
    w, x = _wx(130, 9, 2, seed=3)
    plan = ex._plan_for(torch.from_numpy(w), "t")
    vb = torch.rand(2, plan.NB, plan.D, plan.rows, generator=torch.Generator().manual_seed(0))
    xn = normalize_features(plan.build_x(vb * ex.acfg.v_read), ex.acfg)
    xn = xn.reshape(2, plan.n_blocks, 2, plan.D, plan.rows, 2 * plan.no)
    vr = torch.tensor(ex.acfg.v_read)
    assert torch.equal(xn[:, :, 0, ..., 0],
                       ((vb * vr) / vr)[:, :, None].expand(-1, -1, plan.NO, -1, -1)
                       .reshape(2, plan.n_blocks, plan.D, plan.rows))
    assert torch.equal(xn[0, :, 1], plan.g_norm.reshape(plan.n_blocks, plan.D,
                                                        plan.rows, 2 * plan.no))
