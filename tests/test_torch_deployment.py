"""The port's deployment state, spec and npz (``repro_torch.core
.deployment``) against the JAX package's ``repro.core.deployment``.

* A reference-written npz of a stressed, remapped deployment (a plain
  net under the scalar corner, and a conditioned net under a tiled
  corner on a non-square lattice) loads into the port field by field,
  bit for bit, in the reference's dtypes and shapes; with ``read_sigma``
  zeroed the port serves the reference's outputs from it at rtol 2e-5 /
  atol 2e-6 (the reference's emulator parity tolerance), on the fast and
  the slow path.  (The draws differ between the packages; the npz carries
  the realized ``gf``, ``out_perm`` and ``sfeat``, so parity runs with
  read sigma zeroed.)
* A port-written npz is read by the reference's ``load_deployment`` in
  the same keys, dtypes and shapes, and the reference serves the port's
  states at the same tolerance.
* ``serve --state-save`` then ``--state-load`` gives equal tokens and
  bit-equal logits; the spec JSON is the reference's, character for
  character; the fluent `deploy(...)` and the invariants of
  ``tests/test_deployment_state.py`` that do not rest on PRNG bits.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.nonideal as R  # noqa: E402
from repro.configs.base import AnalogConfig as RefAnalogConfig  # noqa: E402
from repro.configs.rram_ps32 import CASE_A as REF_A  # noqa: E402
from repro.core import deployment as RD  # noqa: E402
from repro.core.analog import AnalogExecutor as RefExecutor  # noqa: E402
import repro_torch.nonideal as T  # noqa: E402
from repro_torch.configs.base import AnalogConfig  # noqa: E402
from repro_torch.configs.rram_ps32 import CASE_A  # noqa: E402
from repro_torch.core import deployment as TD  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.analog import AnalogExecutor  # noqa: E402
from repro_torch.interop import (deployment_from_numpy, load_deployment_npz,  # noqa: E402
                                 save_deployment_npz, save_emulator_npz)
from torch_parity import (assert_close, both_emulator_params,  # noqa: E402
                          ref_emulator_params, to_np)

FIELDS = ("gf", "read_sigma", "read_key", "out_perm", "sfeat", "cal_a", "cal_b")
K, N = 600, 7                      # NB = 3 block groups, NO = 7 output groups


def _wx(B=3, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    x = (rng.standard_normal((B, K)) * 0.5).astype(np.float32)
    x[0, :7] = 0.0
    return w, x


def _tiled(mod, base, nb, no):
    rng = np.random.default_rng(12)
    return mod.tile_scenarios(
        nb, no, base=base, name="tiled_stressed",
        prog_sigma=rng.uniform(0.02, 0.15, (nb, no)).astype(np.float32),
        read_sigma=rng.uniform(0.0, 0.06, (nb, no)).astype(np.float32))


def _pair(kind, fast_path):
    npf = 2 if kind == "plain" else 15
    jp, tp = both_emulator_params(REF_A, npf, seed=11)
    ref = RefExecutor(acfg=RefAnalogConfig(enabled=True, backend="emulator"),
                      geom=REF_A, emulator_params=jp, use_pallas=False,
                      fast_path=fast_path)
    ex = AnalogExecutor(AnalogConfig(enabled=True, backend="emulator"),
                        geom=CASE_A, emulator_params=tp, fast_path=fast_path)
    return ref, ex


def _corner(mod, kind, nb, no):
    st = mod.get_scenario("stressed")
    return st if kind == "plain" else _tiled(mod, st, nb, no)


def _zero_read(st, lib):
    return st.replace(read_sigma=lib.zeros_like(st.read_sigma))


@pytest.mark.parametrize("fast_path", [True, False])
@pytest.mark.parametrize("kind", ["plain", "conditioned_tiled"])
def test_reference_npz_loads_bit_for_bit_and_serves_its_outputs(
        tmp_path, kind, fast_path):
    ref, ex = _pair(kind, fast_path)
    w, x = _wx()
    jw = jnp.asarray(w)
    plan = ref._plan_for(jw, "t")
    assert (plan.NB, plan.NO) == (3, 7)
    ref.deploy(scenario=_corner(R, kind, plan.NB, plan.NO),
               key=jax.random.PRNGKey(5), remap=True)
    ref.calibrate(jax.random.PRNGKey(6), jw, "t", n=16)
    st = ref.state_for("t", jw)
    assert not np.array_equal(np.asarray(st.out_perm), np.arange(N))
    path = str(tmp_path / "ref.npz")
    RD.save_deployment(path, {"t": st}, ref.deployment)
    states, dep = load_deployment_npz(path, device="cpu")
    tst = states["t"]
    for f in FIELDS:
        want = np.asarray(getattr(st, f))
        got = getattr(tst, f)
        got = got if isinstance(got, np.ndarray) else got.numpy()
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert tst.out_perm.dtype == torch.int64 and tst.read_key.dtype == np.uint32
    assert sorted(tst.eparams) == sorted(st.eparams)
    for k, v in st.eparams.items():
        np.testing.assert_array_equal(tst.eparams[k].numpy(), np.asarray(v))
    assert dep.spec_json() == ref.deployment.spec_json()
    assert dep.remap is True and dep.states is states
    if kind != "plain":
        assert tst.sfeat.shape == (3, 7, 13)
    # the same arrays through numpy give the same states
    with np.load(path) as data:
        again, _ = deployment_from_numpy({k: data[k] for k in data.files},
                                         device="cpu")
    assert torch.equal(again["t"].gf, tst.gf)
    # with read sigma zeroed, the port serves the reference's outputs
    y_r = ref.matmul(jnp.asarray(x), jw, "t", state=_zero_read(st, jnp))
    y_t = ex.matmul(torch.from_numpy(x), torch.from_numpy(w), "t",
                    state=_zero_read(tst, torch))
    assert_close(y_t, y_r, 2e-5, 2e-6)


@pytest.mark.parametrize("kind", ["plain", "conditioned_tiled"])
def test_port_npz_is_read_by_the_reference(tmp_path, kind):
    ref, ex = _pair(kind, True)
    w, x = _wx(seed=1)
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    plan = ex._plan_for(tw, "t")
    ex.deploy(scenario=_corner(T, kind, plan.NB, plan.NO), key=5, remap=True)
    ex.calibrate(torch.from_numpy(np.random.default_rng(2).standard_normal(
        (16, K)).astype(np.float32) * 0.5), tw, "t")
    st = ex.state_for("t", tw)
    path = str(tmp_path / "port.npz")
    save_deployment_npz(path, {"t": st}, ex.deployment)
    loaded, dep = RD.load_deployment(path)
    # the reference's own file of a deployment of the same shape, for
    # the keys, dtypes and shapes
    ref.deploy(scenario=_corner(R, kind, plan.NB, plan.NO),
               key=jax.random.PRNGKey(5), remap=True)
    rpath = str(tmp_path / "ref.npz")
    RD.save_deployment(rpath, {"t": ref.state_for("t", jw)}, ref.deployment)
    with np.load(path) as a, np.load(rpath, allow_pickle=True) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k
    for f in FIELDS:
        got = getattr(st, f)
        got = got if isinstance(got, np.ndarray) else got.numpy()
        np.testing.assert_array_equal(np.asarray(getattr(loaded["t"], f)),
                                      got, err_msg=f)
    assert dep.spec_json() == ex.deployment.spec_json()
    assert dep.remap is True
    # the reference serves the port's states (read sigma zeroed)
    y_r = ref.matmul(jnp.asarray(x), jw, "t",
                     state=_zero_read(loaded["t"], jnp))
    y_t = ex.matmul(torch.from_numpy(x), tw, "t", state=_zero_read(st, torch))
    assert_close(y_t, y_r, 2e-5, 2e-6)


def test_spec_json_is_the_references():
    for remap in (False, True, (3.6e3, 8.64e4)):
        for name in ("stressed", "drift_1day"):
            r = RD.Deployment(scenario=R.get_scenario(name),
                              key=jax.random.PRNGKey(11), remap=remap)
            t = TD.Deployment(scenario=T.get_scenario(name), key=prng.key(11),
                              remap=remap)
            assert t.spec_json() == r.spec_json()
            back = TD.Deployment.from_spec_json(r.spec_json())
            assert back.spec_json() == r.spec_json()
            np.testing.assert_array_equal(back.key, np.asarray(r.key))
    empty = TD.Deployment.from_spec_json(TD.Deployment().spec_json())
    assert empty.scenario is None and not empty.remap
    assert TD.Deployment().spec_json() == RD.Deployment().spec_json()


def test_ideal_state_and_fluent_deploy():
    jp, tp = both_emulator_params(REF_A, 2, seed=3)
    ex = AnalogExecutor(AnalogConfig(backend="emulator"), geom=CASE_A,
                        emulator_params=tp)
    w, x = _wx(seed=4)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    ex.calibration["t"] = (2.0, 0.1)
    y = ex.matmul(tx, tw, "t")
    st = TD.DeploymentState.ideal(ex._plan_for(tw, "t"), eparams=tp,
                                  calibration=(2.0, 0.1))
    assert not st.has_read_noise
    assert torch.equal(ex.matmul(tx, tw, "t", state=st), y)
    sc = T.Scenario(name="fl", prog_sigma=0.05, drift_nu=0.05,
                    p_stuck_off=0.03)
    dep = ex.deploy(scenario=sc, key=4, remap=True)
    assert isinstance(dep, TD.Deployment) and ex.deployment is dep
    assert ex.scenario is sc and ex.fault_remap
    dep2 = ex.deploy(age=3.6e3)              # aging keeps key and remap
    assert dep2.remap and np.array_equal(dep2.key, prng.key(4))
    assert ex.scenario.drift_t == 3.6e3 and ex.scenario.prog_sigma == 0.05
    with pytest.raises(dataclasses.FrozenInstanceError):
        dep2.remap = False
    with pytest.raises(ValueError):
        AnalogExecutor(AnalogConfig(backend="analytic")).deploy(age=3.6e3)
    assert ex.deploy(scenario=None).scenario is None
    # hot-swapped params serve like a fresh executor bound to them
    new_p = both_emulator_params(REF_A, 2, seed=8)[1]
    ex.deploy(params=new_p)
    fresh = AnalogExecutor(AnalogConfig(backend="emulator"), geom=CASE_A,
                           emulator_params=new_p,
                           calibration={"t": (2.0, 0.1)})
    assert torch.equal(ex.matmul(tx, tw, "t"), fresh.matmul(tx, tw, "t"))
    # the corner -> age -> remap -> params sequence changes every output
    ex = AnalogExecutor(AnalogConfig(backend="emulator"), geom=CASE_A,
                        emulator_params=tp)
    outs = [ex.matmul(tx, tw, "t")]
    ex.deploy(scenario="stressed", key=1)
    outs.append(ex.matmul(tx, tw, "t"))
    ex.deploy(age=2.592e6)
    outs.append(ex.matmul(tx, tw, "t"))
    ex.deploy(remap=True)
    outs.append(ex.matmul(tx, tw, "t"))
    ex.deploy(params=new_p)
    outs.append(ex.matmul(tx, tw, "t"))
    for a, b in zip(outs, outs[1:]):
        assert not torch.equal(a, b)


def test_state_round_trip_through_a_fresh_executor(tmp_path):
    jp, tp = both_emulator_params(REF_A, 2, seed=3)
    ex = AnalogExecutor(AnalogConfig(backend="emulator"), geom=CASE_A,
                        emulator_params=tp)
    w, x = _wx(seed=5)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    ex.deploy(scenario=T.scenario_at_age(T.get_scenario("stressed"), 8.64e4),
              key=5, remap=True)
    ex.calibrate(torch.from_numpy(x), tw, "t")
    st = ex.state_for("t", tw)
    y = ex.matmul(tx, tw, "t", state=st)
    path = str(tmp_path / "dep.npz")
    TD.save_deployment(path, {"t": st}, ex.deployment)
    loaded, dep = TD.load_deployment(path, device="cpu")
    ex2 = AnalogExecutor(AnalogConfig(backend="emulator"), geom=CASE_A,
                         emulator_params=tp)
    ex2.deploy(scenario=dep.scenario, key=dep.key, remap=dep.remap,
               states=loaded)
    assert torch.equal(ex2.matmul(tx, tw, "t"), y)
    st3 = st.with_calibration(2.0, -0.5).with_read_key(9)
    assert float(st3.cal_a) == 2.0 and torch.equal(st3.gf, st.gf)
    assert st3.has_read_noise == st.has_read_noise


@pytest.fixture(scope="module")
def emulator_npz(tmp_path_factory):
    d = tmp_path_factory.mktemp("em")
    plain = str(d / "plain.npz")
    cond = str(d / "cond.npz")
    for path, npf in ((plain, 2), (cond, 15)):
        np.savez(path, **ref_emulator_params(REF_A, npf, seed=3))
    return plain, cond


def test_serve_state_save_then_load_is_bit_equal(tmp_path, emulator_npz):
    from repro_torch.launch import serve
    plain, cond = emulator_npz
    base = ["--arch", "gemma3-1b", "--reduced", "--layers", "2", "--device",
            "cpu", "--batch", "1", "--prompt-len", "4", "--gen", "3",
            "--analog-backend", "emulator"]
    path = str(tmp_path / "dep.npz")
    sess, out = serve.main(base + ["--emulator-params", plain, "--scenario",
                                   "stressed", "--fault-remap", "--age",
                                   "3600", "--state-save", path])
    _, ideal = serve.main(base + ["--emulator-params", plain])
    assert not np.array_equal(out["logits"], ideal["logits"])
    sess2, out2 = serve.main(base + ["--emulator-params", plain,
                                     "--state-load", path])
    np.testing.assert_array_equal(out2["tokens"], out["tokens"])
    np.testing.assert_array_equal(out2["logits"], out["logits"])
    # the reference reads the session's file under the same site keys
    loaded, dep = RD.load_deployment(path)
    assert sorted(loaded) == sorted(sess.sites())
    assert dep.scenario.name == "stressed" and dep.remap is True
    # a conditioned net is required where asked for, and served
    with pytest.raises(SystemExit):
        serve.main(base + ["--emulator-params", plain,
                           "--conditioned-emulator"])
    s3, out3 = serve.main(base + ["--emulator-params", cond,
                                  "--conditioned-emulator", "--scenario",
                                  "stressed"])
    assert s3.ex.emulator_conditioned and np.isfinite(out3["logits"]).all()
    st = next(iter(s3._last_states.values()))
    np.testing.assert_array_equal(
        to_np(st.sfeat), np.asarray(R.scenario_features(
            R.get_scenario("stressed"))))


def test_serve_analog_layers_serves_a_tiled_corner_on_one_lattice(
        monkeypatch, emulator_npz):
    """``--analog-layers`` (a port-only option) picks the projections that
    run analog: a tiled corner on ``mlp.up``/``mlp.gate``'s lattice
    serves on those sites alone, and the default ``mlp`` takes in
    ``mlp.down``, whose lattice differs, so the corner is refused."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.crossbar import build_conductance_plan
    from repro_torch.launch import serve
    from repro_torch.nonideal import scenario as TS
    _, cond = emulator_npz
    cfg = reduced(get_config("gemma3-1b"), layers=2)
    lat = build_conductance_plan(torch.zeros(cfg.d_model, cfg.d_ff),
                                 AnalogConfig(), CASE_A)
    sc = dataclasses.replace(
        _tiled(T, T.get_scenario("stressed"), lat.NB, lat.NO), name="cli_tiled")
    monkeypatch.setitem(TS._REGISTRY, "cli_tiled", sc)
    base = ["--arch", "gemma3-1b", "--reduced", "--layers", "2", "--device",
            "cpu", "--batch", "1", "--prompt-len", "4", "--gen", "2",
            "--analog-backend", "emulator", "--emulator-params", cond,
            "--conditioned-emulator", "--scenario", "cli_tiled"]
    sess, out = serve.main(base + ["--analog-layers", "mlp.up,mlp.gate"])
    assert sorted(sess.sites()) == ["mlp.gate#0", "mlp.gate#1", "mlp.up#0",
                                    "mlp.up#1"]
    assert np.isfinite(out["logits"]).all()
    st = sess._last_states["mlp.up#0"]
    assert tuple(st.sfeat.shape) == (lat.NB, lat.NO, T.N_SCENARIO_FEATURES)
    with pytest.raises(ValueError, match="tile lattice"):
        serve.main(base)
