"""The scenario-conditioned emulator in the port against the JAX package:
the conditioned forward (B1's flat and per-block fc0 shift on the fast
path, B2's periph on the slow path) under scalar and tiled corners,
the ideal corner bit-identical to the plain forward, and the
conditioned training data and training.

Tolerances: the conditioned fast and slow paths against the reference's
at rtol 2e-5 / atol 2e-6 (its emulator parity tolerance, features bit
for bit from ``scenario_features``); the port's fast path against its
slow path at rtol 2e-4 / atol 2e-6 (``tests/test_conditioned.py``'s).
A tiled corner on a non-square lattice (NB != NO) catches a transposed
lattice order of the per-block shift.  The training data is held by
its shapes, ranges and the statistics of its corner draws (the draws
are the port's own).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.nonideal as R  # noqa: E402
from repro.configs.base import AnalogConfig as RefAnalogConfig  # noqa: E402
from repro.configs.rram_ps32 import CASE_A as REF_A  # noqa: E402
from repro.core.analog import AnalogExecutor as RefExecutor  # noqa: E402
import repro_torch.nonideal as T  # noqa: E402
from repro_torch.configs.base import AnalogConfig  # noqa: E402
from repro_torch.configs.rram_ps32 import CASE_A, EmulatorTrainConfig  # noqa: E402
from repro_torch.core import conv4xbar  # noqa: E402
from repro_torch.core.analog import AnalogExecutor  # noqa: E402
from repro_torch.core.circuit import CircuitParams  # noqa: E402
from repro_torch.core.deployment import DeploymentState  # noqa: E402
from repro_torch.kernels.emulator_block import emulator_block as eb  # noqa: E402
from torch_parity import assert_close, both_emulator_params  # noqa: E402

NF = T.N_SCENARIO_FEATURES
ACFG = AnalogConfig()


def _pair(fast_path, seed=7):
    jp, tp = both_emulator_params(REF_A, 2 + NF, seed=seed)
    ref = RefExecutor(acfg=RefAnalogConfig(backend="emulator"), geom=REF_A,
                      emulator_params=jp, use_pallas=False,
                      fast_path=fast_path)
    ex = AnalogExecutor(AnalogConfig(backend="emulator"), geom=CASE_A,
                        emulator_params=tp, fast_path=fast_path)
    return ref, ex


def _wx(K=600, N=5, B=3, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.3).astype(np.float32)
    x = (rng.standard_normal((B, K)) * 0.5).astype(np.float32)
    return w, x


def _tiled_pair(nb, no):
    rng = np.random.default_rng(3)
    f = dict(prog_sigma=rng.uniform(0, .15, (nb, no)),
             read_sigma=rng.uniform(0, .06, (nb, no)),
             p_stuck_off=rng.uniform(0, .06, (nb, no)),
             drift_nu=rng.uniform(0, .08, (nb, no)), drift_t=8.64e4,
             n_levels=rng.choice([0, 16, 32], (nb, no)))
    f = {k: np.asarray(v, np.int32 if k == "n_levels" else np.float32)
         for k, v in f.items()}
    return (R.tile_scenarios(nb, no, **{k: jnp.asarray(v) for k, v in f.items()}),
            T.tile_scenarios(nb, no, **f))


@pytest.mark.parametrize("fast_path", [True, False])
@pytest.mark.parametrize("corner", ["stressed", "drift_1day", "tiled"])
def test_conditioned_forward_matches_reference(fast_path, corner):
    ref, ex = _pair(fast_path)
    w, x = _wx()
    plan = ex._plan_for(torch.from_numpy(w), "t")
    assert plan.NB != plan.NO                         # (3, 5): not square
    if corner == "tiled":
        rs, ts = _tiled_pair(plan.NB, plan.NO)
        sf_r, sf_t = R.scenario_features_tiled(rs), T.scenario_features_tiled(ts)
    else:
        sf_r = R.scenario_features(R.get_scenario(corner))
        sf_t = T.scenario_features(T.get_scenario(corner))
    yr, xsr = ref.raw_matmul(jnp.asarray(x), jnp.asarray(w), "t",
                             sfeat=jnp.asarray(sf_t.numpy()))
    yt, xst = ex.raw_matmul(torch.from_numpy(x), torch.from_numpy(w), "t",
                            sfeat=sf_t)
    assert float(xst) == float(xsr)
    assert_close(yt, yr, 2e-5, 2e-6)
    # the corner visibly steers the net
    y0, _ = ex.raw_matmul(torch.from_numpy(x), torch.from_numpy(w), "t")
    assert not torch.allclose(yt, y0)
    np.testing.assert_array_equal(
        sf_t.numpy()[..., [i for i in range(NF)
                           if R.SCENARIO_FEATURE_NAMES[i] != "drift_age"]],
        np.asarray(sf_r)[..., [i for i in range(NF)
                               if R.SCENARIO_FEATURE_NAMES[i] != "drift_age"]])


def test_per_block_shift_is_in_lattice_order():
    """The tiled encoding's fc0 shift, flattened to (NB*NO, F1), puts
    tile (i, j) at block i*NO + j: B1's plain version fed it agrees with
    the slow path, whose per-block periph tiles the lattice row-major."""
    _, fast = _pair(True)
    slow = AnalogExecutor(AnalogConfig(backend="emulator"), geom=CASE_A,
                          emulator_params=fast.emulator_params,
                          fast_path=False)
    w, x = _wx(seed=2)
    plan = fast._plan_for(torch.from_numpy(w), "t")
    _, ts = _tiled_pair(plan.NB, plan.NO)
    sf = T.scenario_features_tiled(ts)
    yf, _ = fast.raw_matmul(torch.from_numpy(x), torch.from_numpy(w), "t",
                            sfeat=sf)
    ys, _ = slow.raw_matmul(torch.from_numpy(x), torch.from_numpy(w), "t",
                            sfeat=sf)
    assert_close(yf, ys, 2e-4, 2e-6)
    # the transposed order does not agree
    sf_t = sf.transpose(0, 1).reshape(plan.NB, plan.NO, NF)
    yx, _ = fast.raw_matmul(torch.from_numpy(x), torch.from_numpy(w), "t",
                            sfeat=sf_t)
    assert not torch.allclose(yx, ys, rtol=2e-4, atol=2e-6)


def test_conditioned_ideal_bit_identical_to_plain():
    _, ex0 = _pair(True)
    w, x = _wx(K=70, N=8)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    eb.emulator_block_unified_cuda.launches = 0
    y0 = ex0.matmul(tx, tw, "t")
    ex1 = AnalogExecutor(AnalogConfig(backend="emulator"), geom=CASE_A,
                         emulator_params=ex0.emulator_params,
                         fault_remap=True)
    ex1.deploy(scenario=T.Scenario(name="ideal"), key=9)
    assert torch.equal(ex1.matmul(tx, tw, "t"), y0)
    st = DeploymentState.ideal(ex1._plan_for(tw, "t"),
                               eparams=ex1.emulator_params)
    assert torch.equal(ex1.matmul(tx, tw, "t", state=st), y0)
    # a zero shift is bit-identical to none through B1's plain version
    plan = ex1._plan_for(tw, "t")
    aux = ex1._blocklast_aux()
    u = plan.tile_v(ex1._drive01(tx.abs() / tx.abs().max()), 1.0)
    pos = plan.tile_v((tx > 0).float(), 1.0)
    zero = torch.zeros((plan.n_blocks, aux["f0_scen"].shape[1]))
    assert torch.equal(
        eb.emulator_block_unified_plain(aux, plan.g_norm, u, pos, shift=zero),
        eb.emulator_block_unified_plain(aux, plan.g_norm, u, pos))
    assert eb.emulator_block_unified_cuda.launches == 0   # CPU: plain version


def test_n_periph_detection_and_corner_swaps():
    _, ex = _pair(True)
    assert ex.emulator_conditioned
    assert conv4xbar.n_periph_of(ex.emulator_params, CASE_A) == 2 + NF
    plain = both_emulator_params(REF_A, 2, seed=1)[1]
    assert not AnalogExecutor(AnalogConfig(backend="emulator"), geom=CASE_A,
                              emulator_params=plain).emulator_conditioned
    w, x = _wx(K=70, N=8)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    outs = []
    for sc in (T.get_scenario("stressed"),
               T.scenario_at_age(T.get_scenario("stressed"), 3.6e3),
               T.scenario_at_age(T.get_scenario("stressed"), 2.592e6)):
        ex.deploy(scenario=sc, key=1)
        st = ex.state_for("t", tw)
        np.testing.assert_array_equal(st.sfeat.numpy(),
                                      T.scenario_features(sc).numpy())
        outs.append(ex.matmul(tx, tw, "t", state=st))
    assert not torch.allclose(outs[1], outs[2])       # the net sees the age
    plan = ex._plan_for(tw, "t")
    ex.deploy(scenario=T.tile_scenarios(plan.NB, plan.NO, prog_sigma=0.06,
                                        drift_nu=0.05, drift_t=8.64e4),
              key=2)
    st = ex.state_for("t", tw)
    assert st.sfeat.shape == (plan.NB, plan.NO, NF)
    assert torch.isfinite(ex.matmul(tx, tw, "t", state=st)).all()


def test_sampled_scenarios_and_conditioned_dataset():
    gen = torch.Generator().manual_seed(0)
    space = T.ScenarioSpace()
    s = T.sample_scenarios(gen, 4000, space)
    assert s.prog_sigma.shape == (4000,) and s.drift_t0.shape == (4000,)
    assert s.n_levels.dtype == torch.int32
    assert set(s.n_levels.tolist()) == {0, 16, 32}
    t = s.drift_t
    frac0 = float((t == 0).float().mean())
    assert abs(frac0 - space.p_undrifted) < 4 * (0.25 * 0.75 / 4000) ** 0.5
    aged = t[t > 0]
    assert float(aged.min()) >= 60.0 * (1 - 1e-6)
    assert float(aged.max()) <= space.drift_t_max * (1 + 1e-6)
    for f in ("prog_sigma", "read_sigma", "p_stuck_on", "p_stuck_off",
              "drift_nu"):
        lo, hi = getattr(space, f)
        v = getattr(s, f)
        assert float(v.min()) >= lo and float(v.max()) <= hi
        assert abs(float(v.mean()) - (lo + hi) / 2) < 0.03 * hi
    X, Pf, Y = T.generate_dataset_conditioned(gen, 40, CASE_A, ACFG,
                                              CircuitParams(), batch=32)
    assert X.shape == (40,) + CASE_A.chw and Pf.shape == (40, 2 + NF)
    assert Y.shape == (40, CASE_A.outputs) and torch.isfinite(Y).all()
    assert float(X.min()) >= 0.0 and float(X.max()) <= 1.0
    Xn, Pn, Yn = T.generate_dataset_nonideal(gen, 24, CASE_A, ACFG,
                                             CircuitParams(),
                                             T.get_scenario("stressed"),
                                             batch=16)
    assert Xn.shape == (24,) + CASE_A.chw and Pn.shape == (24, 2)
    assert torch.isfinite(Yn).all()


def test_train_conditioned_emulator_runs_and_serves():
    tcfg = EmulatorTrainConfig(n_train=96, n_test=32, batch_size=32,
                               epochs=2, lr=1e-3, lr_halve_at=(1,))
    res = T.train_conditioned_emulator(0, CASE_A, ACFG, CircuitParams(),
                                       tcfg, device="cpu")
    assert conv4xbar.n_periph_of(res.params, CASE_A) == 2 + NF
    assert np.isfinite(res.test_mse)
    ex = AnalogExecutor(AnalogConfig(backend="emulator"), geom=CASE_A,
                        emulator_params=res.params)
    assert ex.emulator_conditioned
    ex.deploy(scenario="stressed", key=0)
    w, x = _wx(K=70, N=4)
    assert torch.isfinite(ex.matmul(torch.from_numpy(x),
                                    torch.from_numpy(w), "t")).all()
    res2 = T.train_noise_aware_emulator(0, CASE_A, ACFG, CircuitParams(),
                                        tcfg, T.get_scenario("read_noisy"),
                                        device="cpu")
    assert conv4xbar.n_periph_of(res2.params, CASE_A) == 2
