"""The fleet digital twin in the port (``repro_torch.fleet``) against the
JAX package, on the CPU at small shapes:

  * ``Fleet.evaluate`` given the reference's realized per-device states
    (its fab multipliers, programming, fault and read draws rebuilt with
    the reference's own keys, the reference's probe batch): per-device
    errors within the fp32 forward's rtol 2e-5 / atol 2e-6 of the
    reference's on the analytic backend and a plain emulator (measured:
    9e-7 and 8e-6); ``device_features`` given the same draws at rtol 1e-5
    / atol 1e-7;
  * the many-states forward (``AnalogExecutor.raw_matmul_many``) bit-equal
    to the single-state forward per state, every backend and route,
    plain and conditioned;
  * the determinism contract of ``tests/test_fleet.py`` under the port's
    own draws: bit-equal across chunk sizes, across a padded last chunk
    and across processes; one build across ages and cohorts; a
    maintained device beats a stale one; the ``r_line_scale`` check; the
    conditioned fleet's own determinism and one build;
  * ``SurrogateRanker`` given the same features and errors: the same
    coefficients and predictions; the planner and policy units of
    ``tests/test_fleet.py`` on their synthetic grids and on random grids:
    the port's actions equal the reference's exactly;
  * a tiny campaign under telemetry, its snapshot accepted by
    ``tools/check_telemetry.py --profile fleet``.
"""
import json
import os
import subprocess
import sys
import types
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.fleet as RF  # noqa: E402
from repro.configs.base import AnalogConfig as RefAnalogConfig  # noqa: E402
from repro.configs.rram_ps32 import CASE_A as REF_A  # noqa: E402
from repro.core.analog import AnalogExecutor as RefExecutor  # noqa: E402
from repro.fleet.maintenance import _realized_cal_ages as ref_cal_ages  # noqa: E402
from repro.nonideal import Scenario as RefScenario  # noqa: E402
from repro.nonideal.perturb import _tile_keys  # noqa: E402
import repro_torch.fleet as TF  # noqa: E402
from repro_torch.configs.base import AnalogConfig  # noqa: E402
from repro_torch.configs.rram_ps32 import CASE_A, CASE_B  # noqa: E402
from repro_torch.core import conv4xbar, prng  # noqa: E402
from repro_torch.core.analog import AnalogExecutor  # noqa: E402
from repro_torch.fleet.maintenance import _realized_cal_ages  # noqa: E402
from repro_torch.models.common import init_params  # noqa: E402
from repro_torch.nonideal import N_SCENARIO_FEATURES, Scenario  # noqa: E402
from repro_torch.obs import OBS, RecompileSentinel, write_snapshot  # noqa: E402
from torch_parity import both_emulator_params  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NF = N_SCENARIO_FEATURES
KW = dict(name="fleet-test", prog_sigma=0.04, read_sigma=0.01,
          p_stuck_off=0.05, drift_nu=0.03, drift_t=0.0)
BASE = Scenario(**KW)
AGES = (3_600.0, 86_400.0)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Many tiny ops: beside the suite's other worker processes, more
    intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _w(seed=0, K=32, N=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((K, N)) * 0.2).astype(np.float32)


def _x(seed=0, B=2, K=32):
    rng = np.random.default_rng(100 + seed)
    return torch.from_numpy((rng.standard_normal((B, K)) * 0.5)
                            .astype(np.float32))


def _executor(backend="analytic", conditioned=False, params=None):
    kw = {}
    if backend == "emulator":
        kw["emulator_params"] = params if params is not None else init_params(
            7, conv4xbar.conv4xbar_schema(
                CASE_A, n_periph=2 + (NF if conditioned else 0)),
            device="cpu")
    return AnalogExecutor(AnalogConfig(backend=backend), geom=CASE_A, **kw)


def _fleet(n=24, chunk=8, backend="analytic", conditioned=False, seed=0,
           n_probe=8):
    return TF.Fleet(_executor(backend, conditioned),
                    torch.from_numpy(_w(seed)), "twin",
                    TF.FleetSpec(n_devices=n, base=BASE, chunk=chunk),
                    key=prng.key(seed + 2), n_probe=n_probe)


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


# --------------------------------------------------------------------- #
# against the reference, given its realized per-device states
# --------------------------------------------------------------------- #
def _ref_pair(backend):
    """(reference fleet, port fleet) over the same weights, executor
    params and probe batch, the port's draws replaced by the reference's
    (the reference's keys: ``fold_in(fleet_key, id)``, its per-tile
    programming and fault keys, its read keys)."""
    w = _w(3)
    if backend == "emulator":
        jp, tp = both_emulator_params(REF_A, 2, seed=7)
        rex = RefExecutor(acfg=RefAnalogConfig(backend="emulator"),
                          geom=REF_A, emulator_params=jp, use_pallas=False)
        tex = _executor("emulator", params=tp)
    else:
        rex = RefExecutor(acfg=RefAnalogConfig(backend="analytic"),
                          geom=REF_A)
        tex = _executor()
    fkey = jax.random.PRNGKey(5)
    ref = RF.Fleet(rex, jnp.asarray(w), "twin",
                   RF.FleetSpec(n_devices=12, base=RefScenario(**KW),
                                chunk=12), key=fkey, n_probe=8)
    port = TF.Fleet(tex, torch.from_numpy(w), "twin",
                    TF.FleetSpec(n_devices=12, base=BASE, chunk=5),
                    key=prng.key(5), n_probe=8)
    port._xp = torch.from_numpy(np.array(ref._xp))
    shape = tuple(port._base()["plan"].g_feat.shape)
    nb, no = shape[:2]

    def draws(ids, cal_age, parts=()):
        z, eps, u, ef, es = [], [], [], [], []
        for i, tc in zip(ids, cal_age):
            k = jax.random.fold_in(fkey, int(i))
            kd, kc, kr = jax.random.split(jax.random.fold_in(k, 7), 3)
            z.append(np.stack([np.asarray(jax.random.normal(kk, (nb, no)))
                               for kk in jax.random.split(k, 4)]))
            kp = jax.random.fold_in(kd, jnp.asarray(tc).astype(jnp.int32))
            tp_, tf_ = (_tile_keys(kp, nb, no).reshape(-1, 2),
                        _tile_keys(kd, nb, no).reshape(-1, 2))
            eps.append(np.stack([np.asarray(jax.random.normal(
                jax.random.split(t)[0], shape[2:])) for t in tp_])
                .reshape(shape))
            u.append(np.stack([np.asarray(jax.random.uniform(
                jax.random.split(t)[1], shape[2:])) for t in tf_])
                .reshape(shape))
            ef.append(np.asarray(jax.random.normal(kc, shape)))
            es.append(np.asarray(jax.random.normal(kr, shape)))
        t = lambda a, ax=0: torch.from_numpy(np.stack(a, axis=ax))
        return {"z": t(z, 1), "eps": t(eps), "u": t(u), "er_fit": t(ef),
                "er_serve": t(es)}

    port._draws = draws
    return ref, port


@pytest.mark.parametrize("backend", ["analytic", "emulator"])
def test_fleet_given_reference_states_matches(backend):
    ref, port = _ref_pair(backend)
    x = _x(1)
    cal = np.array([0.0, 3_600.0] * 6, np.float32)
    for age, ca in ((0.0, None), (86_400.0, cal), (2_592_000.0, None)):
        want = ref.evaluate(jnp.asarray(x.numpy()), age, cal_age=ca)
        got = port.evaluate(x, age, cal_age=ca)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6,
                                   err_msg=f"age {age}")
        assert np.all(want > 1e-3)


def test_device_features_given_reference_draws_match():
    ref, port = _ref_pair("analytic")
    ids = np.arange(12, dtype=np.int32)
    for age in (0.0, 86_400.0):
        want = ref.device_features(ids, age)
        got = port.device_features(ids, age)
        assert got.shape == (12, 2 * NF + 4)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("backend,conditioned,fast", [
    ("analytic", False, True), ("circuit", False, True),
    ("emulator", False, True), ("emulator", False, False),
    ("emulator", True, True), ("emulator", True, False)])
@pytest.mark.parametrize("geom", ["A", "B"])
def test_many_states_forward_equals_each_state(backend, conditioned, fast,
                                               geom):
    g = CASE_A if geom == "A" else CASE_B
    kw = {}
    if backend == "emulator":
        kw["emulator_params"] = init_params(3, conv4xbar.conv4xbar_schema(
            g, n_periph=2 + (NF if conditioned else 0)), device="cpu")
    ex = AnalogExecutor(AnalogConfig(backend=backend), geom=g,
                        fast_path=fast, **kw)
    rng = np.random.default_rng(4)
    w = torch.from_numpy((rng.standard_normal((300, 11)) * 0.2)
                         .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3, 300)).astype(np.float32))
    plan = ex._plan_for(w, "t")
    C = 3
    noise = torch.from_numpy(rng.standard_normal((C,) + tuple(
        plan.g_feat.shape)).astype(np.float32))
    gs = torch.where(plan.g_feat > 0, torch.clamp(
        plan.g_feat * (1 + 0.05 * noise), ex.acfg.g_min, ex.acfg.g_max), 0.0)
    sf = (torch.from_numpy(rng.uniform(0, 0.1, (C, plan.NB, plan.NO, NF))
                           .astype(np.float32)) if conditioned else None)
    y, xs = ex.raw_matmul_many(x, w, "t", gs, sfeat=sf)
    assert y.shape == (C, 3, 11)
    for c in range(C):
        yc, xc = ex.raw_matmul(x, w, "t", plan=plan.with_g(gs[c], ex.acfg),
                               sfeat=None if sf is None else sf[c])
        assert torch.equal(y[c], yc) and float(xs) == float(xc)


# --------------------------------------------------------------------- #
# determinism and chunking (the port's own draws)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", ["analytic", "emulator"])
def test_chunk_size_bitwise_determinism(backend):
    x = _x()
    ref = _fleet(n=24, chunk=24, backend=backend).evaluate(x, AGES[0])
    for chunk in (8, 5, 17):
        out = _fleet(n=24, chunk=chunk, backend=backend).evaluate(x, AGES[0])
        assert _crc(out) == _crc(ref), f"chunk={chunk} diverged"


def test_padded_last_chunk_matches_subset_eval():
    fleet = _fleet(n=10, chunk=8)
    x = _x()
    full = fleet.evaluate(x, AGES[1])
    ids = np.array([3, 8, 9], np.int32)
    np.testing.assert_array_equal(fleet.evaluate(x, AGES[1], ids=ids),
                                  full[ids])


def test_cross_process_bitwise_determinism():
    snippet = (
        "import sys, zlib, numpy as np, torch\n"
        "sys.path[:0] = ['tests']\n"
        "from test_torch_fleet import _fleet, _x, _crc\n"
        "print(_crc(_fleet(n=12, chunk=5, backend='emulator')"
        ".evaluate(_x(), 3600.0)))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src"), env.get("PYTHONPATH", "")]).rstrip(
            os.pathsep)
    proc = subprocess.run([sys.executable, "-c", snippet], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    here = _crc(_fleet(n=12, chunk=5, backend="emulator").evaluate(_x(),
                                                                  3600.0))
    assert int(proc.stdout.strip().splitlines()[-1]) == here


def test_one_build_across_ages_and_cal_cohorts():
    fleet = _fleet(n=16, chunk=8)
    x = _x()
    rng = np.random.default_rng(0)
    with RecompileSentinel(fns=(fleet,), label="fleet") as sent:
        for t in (0.0,) + AGES:
            fleet.evaluate(x, t)
            fleet.evaluate(x, t, cal_age=t)
            fleet.evaluate(x, t, cal_age=rng.choice([0.0, t], size=16)
                           .astype(np.float32))
        fleet.device_features(np.arange(16), AGES[0])
    assert sent.ok and fleet.builds == 1 and fleet.cache_size() == 1
    assert fleet.ex.builds["plan"] == {"twin": 1}


def test_requires_unit_line_resistance():
    spec = TF.FleetSpec(n_devices=4, base=Scenario(name="ir",
                                                   r_line_scale=3.0), chunk=4)
    with pytest.raises(ValueError, match="r_line"):
        TF.Fleet(_executor(), torch.ones((32, 8)) * 0.1, "bad", spec,
                 key=prng.key(0))


def test_maintained_device_beats_stale_device():
    fleet = _fleet(n=32, chunk=16)
    x = _x()
    t = 2_592_000.0
    fresh = fleet.evaluate(x, t, cal_age=t)
    stale = fleet.evaluate(x, t, cal_age=0.0)
    floor = fleet.evaluate(x, 0.0)
    assert np.median(fresh) < np.median(stale)
    assert np.median(fresh) < 2.0 * np.median(floor)


def test_conditioned_fleet_runs_and_is_deterministic():
    fa = _fleet(n=8, chunk=8, backend="emulator", conditioned=True)
    fb = _fleet(n=8, chunk=3, backend="emulator", conditioned=True)
    assert fa.ex.emulator_conditioned
    x = _x()
    a, b = fa.evaluate(x, AGES[0]), fb.evaluate(x, AGES[0])
    assert _crc(a) == _crc(b) and np.isfinite(a).all()
    assert fa.builds == 1 and fa.cache_size() == 1
    # the devices' encodings steer the net: the same fleet under a plain
    # encoding (all-zero features) gives other errors
    plain = _fleet(n=8, chunk=8, backend="emulator", conditioned=True)
    plain._base()["conditioned"] = False
    assert not np.array_equal(plain.evaluate(x, AGES[0]), a)


def test_draws_are_the_ports_own_and_statistically_sound():
    """The counter-based draws: each device's from its own keys
    (independent of the chunk), standard normal and uniform moments."""
    fleet = _fleet(n=64, chunk=64)
    ids = np.arange(64, dtype=np.int32)
    cal = np.zeros(64, np.float32)
    d = fleet._draws(ids, cal)
    d2 = fleet._draws(ids[10:13], cal[10:13])
    for k in d:
        sub = d[k][:, 10:13] if k == "z" else d[k][10:13]
        assert torch.equal(sub, d2[k]), k
    for k in ("eps", "er_fit", "er_serve"):
        v = d[k].double()
        assert abs(float(v.mean())) < 0.01 and abs(float(v.std()) - 1) < 0.01
    assert abs(float(d["u"].double().mean()) - 0.5) < 0.005
    # a new maintenance epoch is a new programming draw, the faults stay
    d3 = fleet._draws(ids[:4], np.full(4, 3_600.0, np.float32))
    assert not torch.equal(d3["eps"], d["eps"][:4])
    assert torch.equal(d3["u"], d["u"][:4])
    assert not torch.allclose(d["er_fit"], d["er_serve"])


# --------------------------------------------------------------------- #
# forecasting surrogate and planner against the reference
# --------------------------------------------------------------------- #
def _stub_fleet(n, seed=0, tag="stub"):
    """A fleet stand-in whose ``evaluate`` / ``device_features`` return
    fixed arrays (the same for both packages' rankers)."""
    rng = np.random.default_rng(seed)
    feats = rng.uniform(0, 0.2, (n, 2 * NF + 4)).astype(np.float32)
    base = rng.uniform(0.02, 0.1, n).astype(np.float32)

    def evaluate(x, t, ids=None, cal_age=0.0):
        ids = np.arange(n) if ids is None else np.asarray(ids)
        d = np.maximum(np.asarray(t, np.float32)
                       - np.asarray(cal_age, np.float32), 0.0)
        return (base[ids] * (1 + 0.1 * np.log1p(d))).astype(np.float32)

    def device_features(ids, age):
        f = feats[np.asarray(ids)].copy()
        f[:, 10] = np.log1p(np.broadcast_to(np.asarray(age, np.float32),
                                            (f.shape[0],))) / 16.0
        return f

    return types.SimpleNamespace(
        spec=types.SimpleNamespace(n_devices=n, base=BASE), tag=tag,
        evaluate=evaluate, device_features=device_features)


def test_surrogate_ranker_matches_reference():
    stub = _stub_fleet(40)
    ages = list(AGES) + [2_592_000.0]
    rr = RF.SurrogateRanker().fit(stub, None, ages, n_probe=16)
    tr = TF.SurrogateRanker().fit(stub, None, ages, n_probe=16)
    np.testing.assert_array_equal(tr.coef, rr.coef)
    assert tr.train_pinball == rr.train_pinball
    ids = np.arange(40)
    for t, c in ((AGES[1], 0.0), (AGES[1], AGES[1]), (ages[-1], AGES[0])):
        np.testing.assert_array_equal(tr.predict(stub, ids, t, cal_age=c),
                                      rr.predict(stub, ids, t, cal_age=c))
    np.testing.assert_array_equal(
        TF.forecast_fleet(stub, None, ages), RF.forecast_fleet(stub, None,
                                                               ages))


def test_surrogate_ranker_fits_and_predicts_on_a_fleet():
    fleet = _fleet(n=16, chunk=8)
    x = _x()
    ranker = TF.SurrogateRanker().fit(fleet, x, list(AGES), n_probe=8)
    assert np.isfinite(ranker.train_pinball)
    ids = np.arange(16, dtype=np.int32)
    pred = ranker.predict(fleet, ids, AGES[1], cal_age=0.0)
    assert pred.shape == (16,) and np.isfinite(pred).all()
    fresh = ranker.predict(fleet, ids, AGES[1], cal_age=AGES[1])
    assert np.median(fresh) < np.median(pred)
    assert fleet.cache_size() == 1


def _planners(E, timeline=AGES, base=BASE, **kw):
    """The reference's and the port's planner over one synthetic grid."""
    out = []
    for mod, sc in ((RF, RefScenario(**KW) if base is BASE else base),
                    (TF, base)):
        stub = types.SimpleNamespace(
            spec=types.SimpleNamespace(n_devices=E.shape[0], base=sc),
            tag="stub")
        p = mod.MaintenancePlanner(fleet=stub, timeline=list(timeline), **kw)
        p._forecast_grid = lambda x: np.asarray(E, np.float32)
        out.append(p)
    return out


def _same_plan(E, **kw):
    rp, tp = _planners(E, **kw)
    a, b = rp.plan(None), tp.plan(None)
    np.testing.assert_array_equal(b.actions, a.actions)
    assert b.expected_cost == a.expected_cost
    assert b.remap_horizon == a.remap_horizon
    return b


def test_planner_healthy_device_does_nothing():
    plan = _same_plan(np.full((3, 2, 3), 0.01, np.float32), slo=0.1)
    assert (plan.actions == TF.A_NONE).all() and plan.expected_cost == 0.0


def test_planner_recalibrates_transient_drift():
    E = np.full((2, 2, 3), 0.5, np.float32)
    E[:, 0, 1] = E[:, 1, 2] = E[:, 1, 1] = 0.02
    plan = _same_plan(E, slo=0.1)
    assert (plan.actions[:, 0] == TF.A_RECAL).all()
    assert not (plan.actions == TF.A_RETIRE).any()
    assert plan.expected_cost == pytest.approx(2.0)


def test_planner_retires_persistent_violation():
    E = np.full((1, 3, 4), 0.9, np.float32)
    plan = _same_plan(E, timeline=(1.0, 2.0, 3.0), slo=0.1)
    assert plan.actions[0, 0] == TF.A_RETIRE
    assert plan.expected_cost == pytest.approx(TF.ActionCosts().retire)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("gain", [1.0, 0.5])
def test_planner_random_grids_match_reference(seed, gain):
    rng = np.random.default_rng(seed)
    T = 2 + seed % 3
    E = rng.uniform(0.0, 0.6, size=(64, T, T + 1)).astype(np.float32)
    plan = _same_plan(E, timeline=tuple(3_600.0 * (i + 1) for i in range(T)),
                      slo=0.1 + 0.05 * (seed % 2), retrain_gain=gain)
    if gain == 1.0:
        assert not (plan.actions == TF.A_RETRAIN).any()


def test_planner_wear_horizon_decision():
    plan = _same_plan(np.full((2, 2, 3), 0.01, np.float32), slo=0.1)
    assert plan.remap_horizon == AGES
    quiet = Scenario(name="nodrift", p_stuck_off=0.05)
    _, tp = _planners(np.zeros((2, 2, 3), np.float32), base=quiet)
    assert tp._choose_remap_horizon() is None


def test_realized_cal_ages_cohorts_and_baselines():
    acts = np.array([[TF.A_NONE, TF.A_RECAL, TF.A_NONE],
                     [TF.A_RECAL, TF.A_NONE, TF.A_RETRAIN],
                     [TF.A_NONE, TF.A_NONE, TF.A_NONE]], np.int8)
    tl = (10.0, 20.0, 30.0)
    cal = _realized_cal_ages(acts, tl)
    np.testing.assert_array_equal(cal, ref_cal_ages(acts, tl))
    np.testing.assert_array_equal(
        cal, np.array([[0, 20, 20], [10, 10, 30], [0, 0, 0]], np.float32))
    c0 = TF.FleetPlan(timeline=tl, actions=acts, expected_cost=0.0).cohorts(0)
    np.testing.assert_array_equal(c0["none"], [0, 2])
    np.testing.assert_array_equal(c0["recalibrate"], [1])
    assert "retire" not in c0
    nv, al = TF.never_policy(5, AGES), TF.always_recalibrate_policy(5, AGES)
    assert nv.shape == al.shape == (5, len(AGES))
    assert (nv == TF.A_NONE).all() and (al == TF.A_RECAL).all()


def test_simulate_policy_costs_and_retire_semantics():
    fleet = _fleet(n=8, chunk=8)
    x = _x()
    costs = TF.ActionCosts()
    acts = TF.never_policy(8, AGES)
    acts[0, 0] = TF.A_RETIRE
    acts[1, :] = TF.A_RECAL
    out = TF.simulate_policy(fleet, x, AGES, acts, costs, slo=1e9)
    assert len(out) == len(AGES)
    assert out[0]["retired"] == out[1]["retired"] == 1
    assert out[0]["action_cost"] == pytest.approx(costs.retire
                                                 + costs.recalibrate)
    assert out[1]["action_cost"] == pytest.approx(costs.recalibrate)
    assert out[1]["cum_cost"] == pytest.approx(costs.retire
                                               + 2 * costs.recalibrate)
    viol = TF.simulate_policy(fleet, x, AGES, TF.never_policy(8, AGES), costs,
                              slo=-1.0)
    assert viol[0]["violations"] == 8
    assert viol[0]["cum_cost"] == pytest.approx(8 * costs.slo_penalty)
    # the same replay through the reference's policy arithmetic, given
    # the port's realized errors
    stub = types.SimpleNamespace(
        tag="stub", evaluate=lambda x_, t, ids=None, cal_age=None:
        fleet.evaluate(x, t, ids=ids, cal_age=cal_age))
    want = RF.simulate_policy(stub, None, AGES, acts, costs, slo=0.3)
    got = TF.simulate_policy(fleet, x, AGES, acts, costs, slo=0.3)
    assert got == want


# --------------------------------------------------------------------- #
# telemetry: a tiny campaign through the fleet profile
# --------------------------------------------------------------------- #
def test_campaign_snapshot_passes_the_fleet_profile(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import check_telemetry
    was = OBS.enabled
    OBS.reset()
    OBS.enable()
    try:
        fleet = _fleet(n=24, chunk=8)
        x = _x()
        with RecompileSentinel(fns=(fleet,), label="fleet:chunk",
                               strict=False) as sent:
            floor = fleet.evaluate(x, AGES[0], cal_age=AGES[0])
            slo = 2.0 * float(np.median(floor))
            planner = TF.MaintenancePlanner(fleet, list(AGES), slo=slo,
                                            n_probe=8)
            plan = planner.plan(x)
            for name, acts in (("never", TF.never_policy(24, AGES)),
                               ("always",
                                TF.always_recalibrate_policy(24, AGES)),
                               ("plan", plan.actions)):
                TF.simulate_policy(fleet, x, AGES, acts, planner.costs, slo,
                                   policy=name)
        path = write_snapshot(str(tmp_path / "fleet.json"))
    finally:
        OBS.reset()
        if not was:
            OBS.disable()
    assert sent.ok and fleet.builds == 1
    with open(path) as f:
        snap = json.load(f)
    with open(os.path.join(REPO, "tools", "telemetry_schema.json")) as f:
        schema = json.load(f)
    errs = check_telemetry.check(snap, schema, profile="fleet")
    assert not errs, "\n".join(errs)
    met = snap["metrics"]
    assert met["fleet_devices_total"]["series"][0]["value"] == 24.0
    chunks = met["fleet_chunk_evals_total"]["series"][0]["value"]
    devices = met["fleet_eval_devices_total"]["series"][0]["value"]
    assert chunks >= devices / 8 and devices > 0
