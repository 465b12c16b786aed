"""Fleet lifetime management and scenario sweeps in the port
(``repro_torch.nonideal.lifetime``, ``nonideal.sweep``,
``nonideal.data.finetune_emulator``, ``ServeSession.calibrate``) against
the JAX package, on the CPU at small shapes:

  * ``finetune_emulator`` given the reference's data and permutation
    seed: the loss after 2 epochs on 1,024 blocks within rtol 2e-2 of the
    reference's (the training tolerance of ``test_torch_emulator.py``);
    the input params are not mutated;
  * ``_probe_blocks`` given the reference's probes and perturbed plan:
    features, periph and circuit labels at the fp32 forward's rtol 2e-5 /
    atol 2e-6;
  * ``ServeSession.calibrate`` on reduced gemma3-1b, cold then warm,
    given the reference's probes: every site's affine within 1e-5 (the
    calibration tolerance of ``test_torch_analog.py``);
  * ``ScenarioSweep`` given the reference's draws: outputs at rtol 2e-5 /
    atol 2e-6 (analytic, plain and conditioned emulator); under the
    port's own draws, the invariants of ``tests/test_nonideal.py`` and
    ``tests/test_conditioned.py`` (one build for a curve, a monotone
    curve, independent draws, the ``r_line_scale`` check) and one draw
    at a time bit-equal to the batch;
  * the scheduler's invariants of ``tests/test_lifetime.py`` and
    ``tests/test_conditioned.py`` under the port's own draws: mitigation
    dominates the unmitigated walk, a field retrain hot-swaps with one
    plan build per tag, warm calibration uses half the probe budget, the
    conditioned net retrains at deployment only; the ``lifetime_*``
    telemetry.
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
from repro.core.circuit import CircuitParams as RefCP  # noqa: E402
import repro_torch.nonideal as T  # noqa: E402
from repro_torch.configs.base import AnalogConfig  # noqa: E402
from repro_torch.configs.rram_ps32 import CASE_A  # noqa: E402
from repro_torch.core import conv4xbar, prng  # noqa: E402
from repro_torch.core.analog import AnalogExecutor  # noqa: E402
from repro_torch.core.circuit import CircuitParams, block_response  # noqa: E402
from repro_torch.models.common import init_params  # noqa: E402
from repro_torch.nonideal import lifetime  # noqa: E402
from repro_torch.obs import OBS  # noqa: E402
from torch_parity import (assert_close, both_emulator_params,  # noqa: E402
                          executors, to_np, tree_np)

NF = T.N_SCENARIO_FEATURES


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Many tiny ops: beside the suite's other worker processes, more
    intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _executor(backend="analytic", conditioned=False, **kw):
    if backend == "emulator":
        kw.setdefault("emulator_params", init_params(
            7, conv4xbar.conv4xbar_schema(
                CASE_A, n_periph=2 + (NF if conditioned else 0)),
            device="cpu"))
    return AnalogExecutor(AnalogConfig(backend=backend), geom=CASE_A, **kw)


def _data(K=64, N=8, B=4, seed=0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.3)
                         .astype(np.float32))
    x = torch.from_numpy((rng.standard_normal((B, K)) * 0.5)
                         .astype(np.float32))
    return x, w


def _pair(backend, conditioned=False):
    if backend == "analytic":
        return (RefExecutor(acfg=RefAnalogConfig(backend="analytic"),
                            geom=REF_A),
                _executor("analytic"))
    jp, tp = both_emulator_params(REF_A, 2 + (NF if conditioned else 0),
                                  seed=7)
    return (RefExecutor(acfg=RefAnalogConfig(backend="emulator"), geom=REF_A,
                        emulator_params=jp, use_pallas=False),
            _executor("emulator", emulator_params=tp))


# --------------------------------------------------------------------------- #
# finetune_emulator, _probe_blocks
# --------------------------------------------------------------------------- #
def test_finetune_emulator_matches_reference():
    from repro.core import conv4xbar as rconv
    from repro.nonideal.data import (finetune_emulator as ref_finetune,
                                     generate_dataset_nonideal as ref_data)
    sc_r = R.Scenario(name="aged", prog_sigma=0.05, p_stuck_off=0.02,
                      drift_nu=0.05, drift_t=86_400.0)
    sc_t = T.Scenario(name="aged", prog_sigma=0.05, p_stuck_off=0.02,
                      drift_nu=0.05, drift_t=86_400.0)
    key = jax.random.PRNGKey(3)
    X, Pf, Y = ref_data(jax.random.PRNGKey(4), 1024, REF_A,
                        RefAnalogConfig(), RefCP(), sc_r)
    jp, tp = both_emulator_params(REF_A, 2, seed=5)
    before = {k: v.clone() for k, v in tp.items()}
    rp = ref_finetune(key, jp, REF_A, RefAnalogConfig(), RefCP(), sc_r,
                      epochs=2, data=(X, Pf, Y))
    seed = int(jax.random.randint(jax.random.fold_in(key, 0x5EED), (), 0,
                                  2 ** 31 - 1))
    data = tuple(torch.from_numpy(np.array(a)) for a in (X, Pf, Y))
    out = T.finetune_emulator(prng.key(3), tp, CASE_A, AnalogConfig(),
                              CircuitParams(), sc_t, epochs=2, data=data,
                              perm_seed=seed)
    for k in tp:
        assert torch.equal(tp[k], before[k]), k      # input not mutated
    loss_r = float(jnp.mean(jnp.square(rconv.apply(rp, X, Pf) - Y)))
    loss_0 = float(jnp.mean(jnp.square(rconv.apply(jp, X, Pf) - Y)))
    loss_t = float(torch.mean(torch.square(conv4xbar.apply(out, *data[:2])
                                           - data[2])))
    assert loss_r < loss_0                           # it did train
    assert abs(loss_t - loss_r) <= 2e-2 * loss_r, (loss_t, loss_r)


def test_probe_blocks_match_reference():
    from repro.core.circuit import block_response as ref_block
    from repro.nonideal.lifetime import _probe_blocks as ref_probe
    ref, ex = _pair("analytic")
    _, w = _data(K=100, N=6)
    sc = R.Scenario(name="s", prog_sigma=0.05, p_stuck_off=0.03)
    ref.deploy(scenario=sc, key=jax.random.PRNGKey(2), remap=True)
    rplan = ref._scenario_plan("t", jnp.asarray(w.numpy()))
    key = jax.random.PRNGKey(8)
    n = 12
    Xr, Pr, Yr = ref_probe(ref, rplan, key, n, jnp.asarray(w.numpy()),
                           jax.jit(lambda b, p: ref_block(b, RefCP(), p)))
    plan = ex._plan_for(w, "t").with_g(torch.from_numpy(
        np.array(rplan.g_feat)), ex.acfg)
    xc = torch.from_numpy(np.asarray(jax.random.normal(key, (n, 100)) * 0.5))
    Xt, Pt, Yt = lifetime._probe_blocks(
        ex, plan, xc, lambda b, p: block_response(b, CircuitParams(), p))
    assert_close(Xt, Xr, 2e-5, 2e-6)
    assert_close(Pt, Pr, 0, 0)
    assert_close(Yt, Yr, 2e-5, 2e-6)


# --------------------------------------------------------------------------- #
# ServeSession.calibrate
# --------------------------------------------------------------------------- #
def test_serve_session_calibrate_matches_reference(monkeypatch):
    from repro.launch.serve import ServeSession as RefSession
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.serve import ServeSession
    rex, tex = executors("emulator")
    rs = RefSession("gemma3-1b", reduced=True, reduced_layers=1, batch=2,
                    prompt_len=8, gen=2, seed=0, executor=rex)
    ts = ServeSession("gemma3-1b", reduced=True, reduced_layers=1, batch=2,
                      prompt_len=8, gen=2, seed=0, executor=tex, device="cpu",
                      params=params_from_numpy(tree_np(rs.params),
                                               device="cpu"))
    assert sorted(ts.sites()) == sorted(rs.sites())
    root = jax.random.PRNGKey(1)
    from repro_torch.core import analog
    own = analog.calibration_probes
    site = iter(())

    def reference_probes(key, n, k, device):
        """The reference's probes of the next site (the sites are
        calibrated in sorted order, site i on ``fold_in(root, i)``)."""
        return torch.from_numpy(np.asarray(jax.random.normal(
            jax.random.fold_in(root, next(site)), (n, k)) * 0.5))

    for warm in (False, True):
        rs.calibrate(key=root, n=16, warm_start=warm)
        if warm:                 # each side warm-starts from the same affine
            tex.calibration = dict(cold)
        site = iter(range(len(rs.sites())))
        monkeypatch.setattr(analog, "calibration_probes", reference_probes)
        ts.calibrate(n=16, warm_start=warm)
        monkeypatch.setattr(analog, "calibration_probes", own)
        assert tex._last_calib_n == rex._last_calib_n == (8 if warm else 16)
        for site, (a_r, b_r) in rex.calibration.items():
            a_t, b_t = tex.calibration[site]
            assert abs(a_t - a_r) <= 1e-5 * max(1.0, abs(a_r)), (site, warm)
            assert abs(b_t - b_r) <= 1e-5, (site, warm)
        cold = dict(rex.calibration)
    # the session's own probes: a cold fit of every site, deterministic
    tex.calibration.clear()
    ts.calibrate(n=16)
    first = dict(tex.calibration)
    tex.calibration.clear()
    ts.calibrate(n=16)
    assert tex.calibration == first and len(first) == len(rs.sites())


# --------------------------------------------------------------------------- #
# ScenarioSweep
# --------------------------------------------------------------------------- #
def _ref_sweep_draws(key, n_draws, shape):
    """The reference sweep's per-draw (eps, u, read eps) for a scalar
    corner: ``kd, kr = split(k)``, then ``perturb_conductance``'s ``kp,
    kf = split(kd)``."""
    out = []
    for k in jax.random.split(key, n_draws):
        kd, kr = jax.random.split(k)
        kp, kf = jax.random.split(kd)
        out.append(tuple(torch.from_numpy(np.asarray(a)) for a in (
            jax.random.normal(kp, shape, jnp.float32),
            jax.random.uniform(kf, shape),
            jax.random.normal(kr, shape, jnp.float32))))
    return out


@pytest.mark.parametrize("backend,conditioned", [
    ("analytic", False), ("emulator", False), ("emulator", True)])
def test_sweep_given_reference_draws_matches(backend, conditioned):
    ref, ex = _pair(backend, conditioned)
    x, w = _data(K=100, N=6, B=3)
    for e in (ref, ex):
        e.calibration["t"] = (1.3, -0.02)
    kw = dict(name="sw", prog_sigma=0.08, read_sigma=0.02, p_stuck_off=0.03,
              drift_nu=0.05, drift_t=3_600.0)
    key = jax.random.PRNGKey(11)
    yr = R.ScenarioSweep(ref, jnp.asarray(w.numpy()), "t", n_draws=3)(
        jnp.asarray(x.numpy()), R.Scenario(**kw), key)
    sweep = T.ScenarioSweep(ex, w, "t", n_draws=3)
    shape = tuple(ex._plan_for(w, "t").g_feat.shape)
    draws = _ref_sweep_draws(key, 3, shape)
    sweep._draws = lambda i, k, shp, dev: draws[i]
    yt = sweep(x, T.Scenario(**kw), 11)
    assert yt.shape == (3, 3, 6)
    assert_close(yt, yr, 2e-5, 2e-6)


def test_sweep_builds_once_and_is_monotone():
    x, w = _data(K=64, N=4, B=8)
    ex = _executor()
    ex.calibrate(torch.randn((32, 64), generator=torch.Generator()
                             .manual_seed(2)) * 0.5, w, "t")
    sweep = T.ScenarioSweep(ex, w, "t", n_draws=4)
    outs = [sweep(x, T.Scenario(name="sw", prog_sigma=s), 11).mean(dim=0)
            for s in (0.0, 0.05, 0.1, 0.2)]
    assert sweep.builds == 1 and sweep.cache_size() == 1
    errs = [float(torch.linalg.norm(o - outs[0])) for o in outs]
    assert errs[0] == 0.0 and errs[-1] > 0.0
    assert all(a <= b + 1e-9 for a, b in zip(errs, errs[1:])), errs
    # a tiled corner is the second leaf layout: one more build, then reused
    plan = ex._plan_for(w, "t")
    for s in (0.02, 0.1):
        sweep(x, T.tile_scenarios(plan.NB, plan.NO, prog_sigma=s), 3)
    assert sweep.builds == 2 and sweep.cache_size() == 2


def test_sweep_rejects_static_r_line_scale():
    x, w = _data(K=64, N=4, B=8)
    sweep = T.ScenarioSweep(_executor(), w, "t", n_draws=2)
    with pytest.raises(ValueError, match="r_line_scale"):
        sweep(x, T.get_scenario("ir_degraded"), 0)


@pytest.mark.parametrize("backend,conditioned", [
    ("analytic", False), ("emulator", True)])
def test_sweep_draws_independent_and_batch_invariant(backend, conditioned):
    x, w = _data(K=64, N=4, B=8)
    ex = _executor(backend, conditioned)
    sweep = T.ScenarioSweep(ex, w, "t", n_draws=3)
    sc = T.Scenario(name="sw", prog_sigma=0.2, read_sigma=0.02,
                    drift_nu=0.05, drift_t=3_600.0)
    ys = sweep(x, sc, 0)
    assert ys.shape[0] == 3
    assert not torch.allclose(ys[0], ys[1])
    assert not torch.allclose(ys[1], ys[2])
    keys = prng.split(prng.key(0), 3)
    for i, k in enumerate(keys):
        assert torch.equal(sweep.run(x, sc, [k])[0], ys[i])


# --------------------------------------------------------------------------- #
# The drift-timeline scheduler
# --------------------------------------------------------------------------- #
FLEET = dict(name="aging", prog_sigma=0.05, p_stuck_off=0.04, drift_nu=0.05)


def test_scheduler_mitigation_dominates_unmitigated():
    x, w = _data(K=64, N=8, B=4)
    kf = prng.key(11)
    exi = _executor()
    exi.calibrate(torch.randn((32, 64), generator=torch.Generator()
                              .manual_seed(9)) * 0.5, w, "t")
    ref = exi.matmul(x, w, "t").numpy()        # young ideal, calibrated

    def acc(y):
        return 1.0 / (1.0 + np.linalg.norm(to_np(y) - ref)
                      / np.linalg.norm(ref))

    un = T.LifetimeScheduler(_executor(), T.Scenario(**FLEET), remap=False,
                             recalibrate=False, key=kf, calib_n=32)
    ru = un.run(w, "t", x)
    mi = T.LifetimeScheduler(_executor(), T.Scenario(**FLEET), remap=True,
                             recalibrate=True, key=kf, calib_n=32)
    rm = mi.run(w, "t", x)
    assert [r["label"] for r in ru] == ["t0", "1h", "1d", "1mo"]
    accs_u = [acc(r["y"]) for r in ru]
    accs_m = [acc(r["y"]) for r in rm]
    assert all(a >= b - 1e-9 for a, b in zip(accs_u, accs_u[1:])), accs_u
    assert all(m > u for u, m in zip(accs_u[1:], accs_m[1:])), (accs_u,
                                                                 accs_m)
    # one conductance plan per tag for the whole walk: ages, remaps and
    # recalibrations are new device states of the same plan
    assert un.ex.builds["plan"] == mi.ex.builds["plan"] == {"t": 1}
    assert [r["calib_n"] for r in mi.history] == [32, 16, 16, 16]
    assert [r["calib_n"] for r in un.history] == [32, 0, 0, 0]


def test_scheduler_field_retrain_hot_swaps_with_one_plan_build():
    x, w = _data(K=64, N=8, B=4)
    ex = _executor("emulator")
    p0 = ex.emulator_params
    sched = T.LifetimeScheduler(
        ex, T.Scenario(name="aging", prog_sigma=0.05, p_stuck_off=0.03,
                       drift_nu=0.05),
        timeline=(("1h", 3_600.0), ("1d", 86_400.0)), remap=True,
        recalibrate=True, retrain=T.make_field_retrainer(prng.key(5), n=32,
                                                         epochs=2),
        key=prng.key(4), calib_n=16)
    recs = sched.run(w, "t", x)
    assert [r["retrained"] for r in recs] == [True, True, True]
    assert ex.emulator_params is not p0
    assert ex.builds["plan"] == {"t": 1}
    assert all(torch.isfinite(r["y"]).all() for r in recs)


def test_calibration_transfer_warm_start_halves_probe_budget():
    x, w = _data(K=64, N=8, B=4)
    fleet = T.Scenario(**FLEET)
    kf = prng.key(3)
    g = torch.Generator().manual_seed(9)
    xc0, xc1 = torch.randn((64, 64), generator=g) * 0.5, \
        torch.randn((64, 64), generator=g) * 0.5

    def aged_executor():
        ex = _executor()
        ex.deploy(scenario=T.scenario_at_age(fleet, 0.0), key=kf, remap=True)
        ex.calibrate(xc0, w, "t")               # deployment-time cold fit
        ex.deploy(scenario=T.scenario_at_age(fleet, 2.592e6))
        return ex

    cold = aged_executor()
    a_cold, _ = cold.calibrate(xc1, w, "t")
    warm = aged_executor()
    n = warm.calibration_budget("t", 64, True)
    assert n == 32
    a_warm, _ = warm.calibrate(xc1[:n], w, "t", warm_start=True)
    assert warm._last_calib_n == 32
    yd = (x @ w).numpy()
    e_cold = np.linalg.norm(cold.matmul(x, w, "t").numpy() - yd)
    e_warm = np.linalg.norm(warm.matmul(x, w, "t").numpy() - yd)
    assert e_warm <= 1.05 * e_cold + 1e-9
    assert abs(a_warm - a_cold) < 0.1 * max(1.0, abs(a_cold))
    fresh = _executor()
    assert fresh.calibration_budget("t", 64, True) == 64   # nothing to warm


def test_scheduler_conditioned_retrains_at_deploy_only():
    x, w = _data(K=64, N=8)
    calls = []

    def fake_retrain(sc, t, ex, w_, tag):
        calls.append(t)
        return None

    sc = T.Scenario(name="aging", prog_sigma=0.05, drift_nu=0.05)
    sched = T.LifetimeScheduler(_executor("emulator", True), sc,
                                timeline=(("1h", 3.6e3),),
                                retrain=fake_retrain, key=prng.key(3),
                                calib_n=16)
    recs = sched.run(w, "t", x)
    assert sched.conditioned and calls == [0.0]
    assert all(r["conditioned"] and not r["retrained"]
               for r in sched.history)
    assert all(torch.isfinite(r["y"]).all() for r in recs)
    calls.clear()
    T.LifetimeScheduler(_executor("emulator", True), sc,
                        timeline=(("1h", 3.6e3),), retrain=fake_retrain,
                        prefer_conditioned=False, key=prng.key(3),
                        calib_n=16).run(w, "t", x)
    assert calls == [0.0, 3.6e3]


@pytest.mark.parametrize("tiled", [False, True])
def test_conditioned_field_calibrator_deploy_only_and_hot_swaps(tiled):
    x, w = _data(K=64, N=8)
    ex = _executor("emulator", True, fault_remap=True)
    p0 = ex.emulator_params
    kw = dict(prog_sigma=0.05, p_stuck_off=0.03, drift_nu=0.05)
    plan = ex._plan_for(w, "t")
    sc = (T.tile_scenarios(plan.NB, plan.NO, name="aging", **kw) if tiled
          else T.Scenario(name="aging", **kw))
    cal = T.make_conditioned_field_calibrator(prng.key(5), ages=(0.0, 3.6e3),
                                              n=8, epochs=2)
    sched = T.LifetimeScheduler(ex, sc, timeline=(("1h", 3.6e3),),
                                retrain=cal, key=prng.key(4), calib_n=16)
    recs = sched.run(w, "t", x)
    assert [r["retrained"] for r in sched.history] == [True, False]
    assert ex.emulator_params is not p0
    assert ex.builds["plan"] == {"t": 1}
    assert all(torch.isfinite(r["y"]).all() for r in recs)


def test_noise_aware_retrainer_fine_tunes_the_serving_params():
    x, w = _data(K=64, N=8)
    ex = _executor("emulator")
    p0 = {k: v.clone() for k, v in ex.emulator_params.items()}
    rt = T.make_noise_aware_retrainer(CASE_A, AnalogConfig(), CircuitParams(),
                                      prng.key(2), n=256, epochs=1)
    sched = T.LifetimeScheduler(ex, T.Scenario(**FLEET),
                                timeline=(("1d", 86_400.0),), retrain=rt,
                                key=prng.key(1), calib_n=16)
    recs = sched.run(w, "t", x)
    assert [r["retrained"] for r in recs] == [True, True]
    assert any(not torch.equal(ex.emulator_params[k], p0[k]) for k in p0)
    assert all(torch.equal(ex._base_params[k], p0[k]) for k in p0)


def test_lifetime_telemetry_names_and_labels():
    x, w = _data(K=64, N=8)
    was = OBS.enabled
    OBS.reset()
    OBS.enable()
    try:
        T.LifetimeScheduler(_executor(), T.Scenario(**FLEET),
                            timeline=(("1h", 3_600.0),), key=prng.key(2),
                            calib_n=16).run(w, "life", x)
        met = OBS.snapshot()["metrics"]
    finally:
        OBS.reset()
        if not was:
            OBS.disable()
    assert met["lifetime_drift_age_seconds"]["series"][0]["value"] == 3600.0
    assert met["lifetime_calib_probes"]["series"][0]["value"] == 8.0
    assert met["lifetime_checkpoints_total"]["series"][0]["value"] == 2.0
    events = {s["labels"]["event"]: s["value"]
              for s in met["lifetime_events_total"]["series"]}
    assert events == {"deploy": 1.0, "remap": 1.0, "recalibrate": 2.0,
                      "checkpoint": 1.0}
    for name in ("lifetime_drift_age_seconds", "lifetime_calib_probes"):
        assert met[name]["kind"] == "gauge"
        assert met[name]["series"][0]["labels"] == {"tag": "life"}
