"""The port's non-ideal subsystem (``repro_torch.nonideal``) against the
JAX package's ``repro.nonideal``.

The port cannot reproduce the reference's threefry draws, so it is held
in two ways:
  * the deterministic math, fed the reference's own draws: the apply
    halves of ``perturb_conductance``, ``apply_read_noise``,
    ``sample_fault_masks`` and ``quantize_levels``, and the remap
    permutation given the same stuck-off mask;
  * the port's own draws, statistically: stuck fractions within 4
    binomial sigma, the log-std of programming and read noise within 3%.

Tolerances: the scenario encoding of every builtin corner and the
per-tile encoding are bit for bit, except ``drift_age`` (a log1p) under
random tiled ages, held at 1 ulp (measured: 1 ulp); the flat (mean,
max) encoding of a random tiled corner holds its max features bit for
bit and its means at 4 ulp (measured: 3 ulp; float32 sums in another
order).  The apply halves are bit for bit where they are arithmetic;
``exp`` and ``pow`` inside ``perturb_conductance`` are held at rtol 3e-7
(measured below 2.4e-7).  Plus the reference tests' invariants that do
not rest on PRNG bits (``tests/test_nonideal.py``,
``tests/test_lifetime.py``).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.nonideal as R  # noqa: E402
from repro.configs.base import AnalogConfig as RefAnalogConfig  # noqa: E402
from repro.configs.rram_ps32 import CASE_A as REF_A, CASE_B as REF_B  # noqa: E402
from repro.core import crossbar as RX  # noqa: E402
from repro.nonideal.perturb import _tile_keys  # noqa: E402
import repro_torch.nonideal as T  # noqa: E402
from repro_torch.configs.base import AnalogConfig  # noqa: E402
from repro_torch.configs.rram_ps32 import CASE_A, CASE_B  # noqa: E402
from repro_torch.core import crossbar as TX  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.analog import AnalogExecutor  # noqa: E402
from torch_parity import both_emulator_params, to_np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACFG, RACFG = AnalogConfig(), RefAnalogConfig()
GEOMS = {"A": (REF_A, CASE_A), "B": (REF_B, CASE_B)}
BUILTINS = [s.name for s in R.BUILTIN_SCENARIOS]


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def _random_tiled(seed):
    """Random per-tile fields as numpy arrays, and the two packages'
    tile batches built from them."""
    rng = np.random.default_rng(seed)
    nb, no = int(rng.integers(1, 5)), int(rng.integers(2, 9))
    f = dict(
        prog_sigma=rng.uniform(0, .15, (nb, no)),
        read_sigma=rng.uniform(0, .06, (nb, no)),
        p_stuck_on=rng.uniform(0, .01, (nb, no)),
        p_stuck_off=rng.uniform(0, .06, (nb, no)),
        drift_nu=rng.uniform(0, .08, (nb, no)),
        drift_t=np.exp(rng.uniform(np.log(60), np.log(2.6e6), (nb, no))),
        n_levels=rng.choice([0, 16, 32], (nb, no)))
    f = {k: v.astype(np.int32 if k == "n_levels" else np.float32)
         for k, v in f.items()}
    rs = R.tile_scenarios(nb, no, name="rt",
                          **{k: jnp.asarray(v) for k, v in f.items()})
    ts = T.tile_scenarios(nb, no, name="rt",
                          **{k: torch.from_numpy(v) for k, v in f.items()})
    return f, rs, ts


def _plans(g="A", K=150, N=7, seed=0, wdt="float32"):
    rg, tg = GEOMS[g]
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.3).astype(np.float32)
    jw = jnp.asarray(w).astype(jnp.bfloat16 if wdt == "bfloat16"
                               else jnp.float32)
    tw = torch.from_numpy(w).to(getattr(torch, wdt))
    return (RX.build_conductance_plan(jw, RACFG, rg),
            TX.build_conductance_plan(tw, ACFG, tg))


# --------------------------------------------------------------------------- #
# Scenarios: registry, encoding, JSON
# --------------------------------------------------------------------------- #
def test_feature_layout_and_builtins_match_reference():
    assert T.SCENARIO_FEATURE_NAMES == R.SCENARIO_FEATURE_NAMES
    assert T.N_SCENARIO_FEATURES == R.N_SCENARIO_FEATURES == 13
    assert [s.name for s in T.BUILTIN_SCENARIOS] == BUILTINS
    assert T.DEFAULT_TIMELINE == R.DEFAULT_TIMELINE


@pytest.mark.parametrize("name", BUILTINS)
def test_scenario_features_bit_for_bit_on_builtins(name):
    rs, ts = R.get_scenario(name), T.get_scenario(name)
    want = np.asarray(R.scenario_features(rs))
    got = T.scenario_features(ts).numpy()
    assert got.dtype == np.float32 and got.shape == (13,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        T.scenario_features_tiled(ts, 2, 3).numpy(),
        np.asarray(R.scenario_features_tiled(rs, 2, 3)))
    # the JSON encoding is the reference's, character for character
    assert T.scenario_to_json(ts) == R.scenario_to_json(rs)
    for prop in ("is_ideal", "has_read_noise", "has_stuck_off"):
        assert getattr(ts, prop) == getattr(rs, prop), prop
    np.testing.assert_array_equal(T.drift_factor(ts).numpy(),
                                  np.asarray(R.drift_factor(rs)))


@pytest.mark.parametrize("seed", range(6))
def test_scenario_features_of_random_tiled_corners(seed):
    _, rs, ts = _random_tiled(seed)
    want = np.asarray(R.scenario_features_tiled(rs))
    got = T.scenario_features_tiled(ts).numpy()
    age = R.SCENARIO_FEATURE_NAMES.index("drift_age")
    rest = [i for i in range(13) if i != age]
    np.testing.assert_array_equal(got[..., rest], want[..., rest])
    assert _ulps(got[..., age], want[..., age]) <= 1
    want, got = np.asarray(R.scenario_features(rs)), T.scenario_features(ts).numpy()
    maxes = [i for i, n in enumerate(R.SCENARIO_FEATURE_NAMES)
             if n.endswith("_max") or n in ("r_line_scale_m1", "quant_inv")]
    np.testing.assert_array_equal(got[maxes], want[maxes])
    assert _ulps(got, want) <= 4
    assert T.scenario_to_json(ts) == R.scenario_to_json(rs)
    c_r, c_t = R.collapse_tiles(rs), T.collapse_tiles(ts)
    for f in ("prog_sigma", "read_sigma", "p_stuck_off", "drift_t", "n_levels"):
        assert getattr(c_t, f) == pytest.approx(getattr(c_r, f), rel=1e-6)


def test_scenario_features_stay_on_the_leaves_device():
    """The encodings are computed where the scenario's tensor leaves lie
    (corners sampled on the card are encoded there); a corner of Python
    scalars encodes on the CPU."""
    ps = torch.full((2, 3), 0.05, device="meta")
    ts = T.tile_scenarios(2, 3, base=T.get_scenario("stressed"), name="m",
                          prog_sigma=ps)
    assert T.scenario_features(ts).device.type == "meta"
    assert T.scenario_features_tiled(ts).device.type == "meta"
    assert T.scenario_features(T.get_scenario("stressed")).device.type == "cpu"


def test_registry_json_and_leaf_pinning():
    s = T.Scenario(name="t_rt", prog_sigma=0.07, read_sigma=0.01,
                   p_stuck_on=0.002, p_stuck_off=0.004, drift_nu=0.04,
                   drift_t=1234.5, r_line_scale=2.0, n_levels=16)
    T.register_scenario(s)
    assert T.get_scenario("t_rt") is s and "t_rt" in T.list_scenarios()
    assert T.scenario_from_json(T.scenario_to_json(s)) == s
    with pytest.raises(ValueError):
        T.register_scenario(T.Scenario(name="t_rt", prog_sigma=0.1))
    T.register_scenario(T.Scenario(name="t_rt", prog_sigma=0.1),
                        overwrite=True)
    assert T.get_scenario("t_rt").prog_sigma == 0.1
    with pytest.raises(KeyError):
        T.get_scenario("no_such_scenario")
    with pytest.raises(ValueError):
        T.scenario_from_json(json.dumps({"name": "x", "bogus_field": 1.0}))
    assert T.Scenario(name="x", prog_sigma=0) == T.Scenario(name="x",
                                                            prog_sigma=0.0)
    assert isinstance(T.Scenario(name="x", drift_t=100).drift_t, float)
    # tiled leaves round-trip as tensors of their dtype
    ts = T.tile_scenarios(2, 4, prog_sigma=np.linspace(0, .3, 4),
                          p_stuck_off=0.01, n_levels=16, name="tiled")
    back = T.scenario_from_json(T.scenario_to_json(ts))
    assert back.tile_shape == (2, 4) and back.n_levels.dtype == torch.int32
    assert torch.equal(back.prog_sigma, ts.prog_sigma)
    assert T.tile_scenarios(2, 4).is_ideal and not ts.is_ideal
    nu = np.zeros((2, 3))
    nu[1, 2] = -0.05                  # a growing tile is not ideal
    assert not T.tile_scenarios(2, 3, drift_nu=nu, drift_t=1e4).is_ideal
    assert T.collapse_tiles(ts).prog_sigma == pytest.approx(0.15)


def test_scenario_at_age_and_drift_age():
    sc = T.Scenario(name="fleet", prog_sigma=0.05, drift_nu=0.05)
    assert T.scenario_at_age(sc, 86_400.0).drift_t == 86_400.0
    assert T.scenario_at_age(sc, 86_400.0).prog_sigma == 0.05
    aged = T.scenario_at_age(T.tile_scenarios(2, 3, drift_nu=0.05), 3_600.0)
    assert aged.drift_t.shape == (2, 3) and float(aged.drift_t[0, 0]) == 3_600.0
    i = T.SCENARIO_FEATURE_NAMES.index("drift_age")
    ages = [float(T.scenario_features(T.scenario_at_age(sc, t))[i])
            for t in (0.0, 3.6e3, 8.64e4, 2.592e6)]
    assert ages[0] == 0.0 and all(a < b for a, b in zip(ages, ages[1:]))
    for t in (3.6e3, 8.64e4, 2.592e6):
        np.testing.assert_array_equal(
            T.scenario_features(T.scenario_at_age(sc, t)).numpy(),
            np.asarray(R.scenario_features(R.scenario_at_age(
                R.Scenario(name="fleet", prog_sigma=0.05, drift_nu=0.05), t))))


# --------------------------------------------------------------------------- #
# The apply halves, given the reference's draws
# --------------------------------------------------------------------------- #
def _ref_device_draws(key, shape):
    kp, kf = jax.random.split(key)
    return (np.array(jax.random.normal(kp, shape, jnp.float32)),
            np.array(jax.random.uniform(kf, shape)))


@pytest.mark.parametrize("name", ["stressed", "prog_heavy", "quantized_16",
                                  "drift_1day", "stuck_1pct", "hard"])
def test_perturb_conductance_given_the_reference_draws(name):
    hard = dict(prog_sigma=0.3, p_stuck_on=0.05, p_stuck_off=0.05,
                n_levels=4, drift_nu=0.1, drift_t=1e5)
    rs = (R.Scenario(name="hard", **hard) if name == "hard"
          else R.get_scenario(name))
    ts = (T.Scenario(name="hard", **hard) if name == "hard"
          else T.get_scenario(name))
    rp, tp = _plans(K=200, N=9, seed=1)            # padded rows and columns
    key = jax.random.PRNGKey(3)
    eps, u = _ref_device_draws(key, rp.g_feat.shape)
    want = np.asarray(R.perturb_conductance(rp.g_feat, RACFG, rs, key))
    got = T.perturb_conductance(tp.g_feat, ACFG, ts, torch.from_numpy(eps),
                                torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got == 0.0, want == 0.0)
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)
    # the masks alone are bit for bit
    on_r, off_r = R.sample_fault_masks(jax.random.split(key)[1],
                                       rp.g_feat.shape, rs.p_stuck_on,
                                       rs.p_stuck_off)
    on_t, off_t = T.sample_fault_masks(torch.from_numpy(u), ts.p_stuck_on,
                                       ts.p_stuck_off)
    np.testing.assert_array_equal(on_t.numpy(), np.asarray(on_r))
    np.testing.assert_array_equal(off_t.numpy(), np.asarray(off_r))


def test_per_tile_perturbation_given_the_reference_draws():
    """A tiled corner on a non-square lattice: each tile takes its own
    leaf values; fed the reference's per-tile draws, the port's broadcast
    over the lattice agrees with the reference's vmap."""
    rp, tp = _plans(g="A", K=600, N=5, seed=2)
    nb, no = tp.NB, tp.NO
    assert nb != no
    rng = np.random.default_rng(4)
    fields = dict(prog_sigma=rng.uniform(0, .2, (nb, no)),
                  p_stuck_off=rng.uniform(0, .1, (nb, no)),
                  p_stuck_on=rng.uniform(0, .05, (nb, no)),
                  drift_nu=rng.uniform(0, .1, (nb, no)), drift_t=5e4,
                  n_levels=rng.choice([0, 8, 32], (nb, no)))
    rs = R.tile_scenarios(nb, no, **{k: jnp.asarray(v) for k, v in fields.items()})
    ts = T.tile_scenarios(nb, no, **fields)
    key = jax.random.PRNGKey(9)
    keys = _tile_keys(key, nb, no)
    eps = np.zeros(rp.g_feat.shape, np.float32)
    u = np.zeros(rp.g_feat.shape, np.float32)
    for i in range(nb):
        for j in range(no):
            eps[i, j], u[i, j] = _ref_device_draws(keys[i, j],
                                                   rp.g_feat.shape[2:])
    want = np.asarray(R.perturb_plan(rp, RACFG, rs, key).g_feat)
    got = T.perturb_conductance(tp.g_feat, ACFG, ts, torch.from_numpy(eps),
                                torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)


@pytest.mark.parametrize("tiled", [False, True])
def test_apply_read_noise_bit_for_bit(tiled):
    rp, tp = _plans(K=150, N=6, seed=3)
    rsig = (np.random.default_rng(5).uniform(0, .1, (tp.NB, tp.NO))
            .astype(np.float32) if tiled else 0.05)
    key = jax.random.PRNGKey(4)
    eps = np.array(jax.random.normal(key, rp.g_feat.shape, jnp.float32))
    want = np.asarray(R.apply_read_noise(rp.g_feat, RACFG, jnp.asarray(rsig),
                                         key))
    got = T.apply_read_noise(tp.g_feat, ACFG, torch.as_tensor(rsig),
                             torch.from_numpy(eps)).numpy()
    np.testing.assert_array_equal(got, want)
    # sigma 0 is the identity
    assert torch.equal(T.apply_read_noise(tp.g_feat, ACFG, 0.0,
                                          torch.from_numpy(eps)), tp.g_feat)


@pytest.mark.parametrize("n_levels,wdt", [(4, "float32"), (16, "float32"),
                                          (32, "bfloat16"), (0, "float32")])
def test_quantize_levels_bit_for_bit(n_levels, wdt):
    rp, tp = _plans(K=130, N=5, seed=6, wdt=wdt)
    want = np.asarray(R.quantize_levels(rp.g_feat, RACFG, n_levels))
    got = T.quantize_levels(tp.g_feat, ACFG, n_levels)
    np.testing.assert_array_equal(to_np(got), want)
    if n_levels >= 2:
        lv = np.unique(to_np(got)[to_np(got) > 0])
        assert len(lv) <= n_levels


def test_ideal_perturbation_is_the_identity_and_keeps_padding():
    _, tp = _plans(K=70, N=3)
    g = tp.g_feat
    assert (g == 0).any()
    eps, u = T.perturb_draws(g.shape, 0, "cpu")
    assert torch.equal(T.perturb_conductance(g, ACFG, T.get_scenario("ideal"),
                                             eps, u), g)
    hard = T.Scenario(name="hard", prog_sigma=0.3, p_stuck_on=0.05,
                      p_stuck_off=0.05, n_levels=4, drift_nu=0.1, drift_t=1e5)
    gp = T.perturb_conductance(g, ACFG, hard, eps, u)
    gp = T.apply_read_noise(gp, ACFG, 0.2, T.read_noise_draw(g.shape, 1, "cpu"))
    assert torch.equal(gp == 0, g == 0)                # no phantom cells
    live = g > 0
    assert gp[live].min() >= ACFG.g_min and gp[live].max() <= ACFG.g_max


# --------------------------------------------------------------------------- #
# The port's draws, statistically
# --------------------------------------------------------------------------- #
def test_fault_masks_deterministic_disjoint_nested_and_binomial():
    shape = (256, 4096)
    n = shape[0] * shape[1]
    u = T.fault_draw(shape, 3, "cpu")
    assert torch.equal(u, T.fault_draw(shape, 3, "cpu"))
    assert not torch.equal(u, T.fault_draw(shape, 4, "cpu"))
    on, off = T.sample_fault_masks(u, 0.05, 0.1)
    assert not (on & off).any()
    on_hi, _ = T.sample_fault_masks(u, 0.2, 0.1)
    assert (on_hi | ~on).all()                         # nested
    for p, m in ((0.05, on), (0.1, off), (0.2, on_hi)):
        sd = (n * p * (1 - p)) ** 0.5
        assert abs(float(m.sum()) - n * p) <= 4 * sd, p
    # the reference's draws at the same rates, for scale
    on_r, off_r = R.sample_fault_masks(jax.random.PRNGKey(3), shape, 0.05, 0.1)
    for m_t, m_r, p in ((on, on_r, 0.05), (off, off_r, 0.1)):
        sd = (n * p * (1 - p)) ** 0.5
        assert abs(float(m_t.sum()) - float(jnp.sum(m_r))) <= 8 * sd


@pytest.mark.parametrize("what,sigma", [("prog", 0.08), ("prog", 0.12),
                                        ("read", 0.03), ("read", 0.05)])
def test_noise_draws_log_std(what, sigma):
    """Mid-range conductances (no clipping): log(g'/g) has std sigma for
    programming noise and ~sigma for small read noise, within 3% for the
    port's draws and the reference's alike."""
    shape = (512, 2048)
    g = torch.full(shape, 3e-5)
    if what == "prog":
        sc = T.Scenario(name="p", prog_sigma=sigma)
        eps, u = T.perturb_draws(shape, 7, "cpu")
        gp = T.perturb_conductance(g, ACFG, sc, eps, u)
        gr = R.perturb_conductance(jnp.asarray(g.numpy()), RACFG,
                                   R.Scenario(name="p", prog_sigma=sigma),
                                   jax.random.PRNGKey(7))
    else:
        gp = T.apply_read_noise(g, ACFG, sigma,
                                T.read_noise_draw(shape, 7, "cpu"))
        gr = R.apply_read_noise(jnp.asarray(g.numpy()), RACFG, sigma,
                                jax.random.PRNGKey(7))
    for out in (gp.numpy(), np.asarray(gr)):
        s = float(np.log(out.astype(np.float64) / 3e-5).std())
        assert abs(s / sigma - 1.0) < 0.03, (what, sigma, s)


def test_prng_keys_are_the_reference_layout():
    for seed in (0, 5, 2 ** 31 - 1):
        np.testing.assert_array_equal(prng.key(seed),
                                      np.asarray(jax.random.PRNGKey(seed)))
    k = prng.key(5)
    assert not np.array_equal(prng.fold_in(k, 1), prng.fold_in(k, 2))
    a, b = prng.split(k)
    assert not np.array_equal(a, b)
    assert np.array_equal(prng.as_key(torch.Generator().manual_seed(5)), k)
    assert np.array_equal(prng.as_key([0, 5]), k)
    # distinct keys give distinct CPU streams (both words reach the seed)
    g1, g2 = prng.generator(prng.key(1), "cpu"), prng.generator(
        prng.key(1 << 32), "cpu")
    assert not torch.equal(torch.rand(8, generator=g1),
                           torch.rand(8, generator=g2))


# --------------------------------------------------------------------------- #
# Remapping: the same permutation given the same masks
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("g,K,N,p_off,horizon", [
    ("A", 300, 16, 0.03, None), ("A", 200, 40, 0.06, None),
    ("B", 260, 30, 0.05, None), ("A", 300, 16, 0.05, "scalar"),
    ("A", 260, 24, 0.05, "tiled"), ("B", 200, 17, 0.08, "tiled")])
def test_remap_permutation_matches_reference(g, K, N, p_off, horizon):
    rp, tp = _plans(g, K, N, seed=K + N)
    rng = np.random.default_rng(N)
    off = rng.uniform(size=tp.g_feat.shape) < p_off
    hz = None
    if horizon == "scalar":
        hz = [np.float32(0.9), np.float32(0.7)]
    elif horizon == "tiled":
        hz = [rng.uniform(0.5, 1.0, (tp.NB, tp.NO)).astype(np.float32)
              for _ in range(2)]
    gf = np.asarray(rp.g_feat)
    want = RX.fault_aware_group_perm(gf, off, rp, RACFG, horizon=hz)
    got = TX.fault_aware_group_perm(tp.g_feat.numpy(), off, tp, ACFG,
                                    horizon=hz)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not np.array_equal(got[0], np.arange(N))    # it did remap


def test_remap_plan_invariants():
    rp, tp = _plans("A", 70, 16, seed=7)
    # identity without stuck-off faults
    same, operm = T.remap_plan(tp, ACFG, T.Scenario(name="c", prog_sigma=0.2), 0)
    assert same is tp and torch.equal(operm, torch.arange(tp.N))
    sc = T.Scenario(name="f", p_stuck_off=0.03)
    _, off = T.realized_fault_masks(tp, sc, 7)
    off = off.numpy()
    span = ACFG.g_max - ACFG.g_min

    def top_hits(g_feat):
        g = g_feat.numpy()
        excess = np.where(g > 0, (g - ACFG.g_min) / span, 0.0)
        thr = np.quantile(excess[excess > 0], 0.9)
        return int((off & (excess >= thr)).sum())

    remapped, operm = T.remap_plan(tp, ACFG, sc, 7)
    # fewer protected weights on stuck-off cells, and the reference's
    # assignment on this mask moves them the same way
    assert 0 < top_hits(tp.g_feat) and top_hits(remapped.g_feat) < top_hits(
        tp.g_feat)
    want = RX.fault_aware_group_perm(np.asarray(rp.g_feat), off, rp, RACFG)
    np.testing.assert_array_equal(operm.numpy(), want[0])
    # the gather undoes the move exactly
    assert torch.equal(remapped.g_feat[:, operm // tp.no], tp.g_feat)
    # padded sites travel with their group and stay zero when perturbed
    _, tp2 = _plans("A", 70, 13, seed=8)
    sc2 = T.Scenario(name="f", p_stuck_off=0.05, prog_sigma=0.1)
    rp2, _ = T.remap_plan(tp2, ACFG, sc2, 3)
    pp = T.perturb_plan(rp2, ACFG, sc2, 3)
    assert torch.equal(pp.g_feat == 0, rp2.g_feat == 0)
    assert int((pp.g_feat == 0).sum()) == int((tp2.g_feat == 0).sum())
    # wear-aware remapping runs and keeps a valid permutation
    _, operm_h = T.remap_plan(tp, ACFG, dataclasses.replace(
        sc, drift_nu=0.05), 7, horizon=(3.6e3, 8.64e4))
    assert sorted(operm_h.tolist()) == list(range(tp.N))


# --------------------------------------------------------------------------- #
# The executor under a corner (invariants of tests/test_nonideal.py and
# tests/test_lifetime.py that do not rest on PRNG bits)
# --------------------------------------------------------------------------- #
def _ex(backend="analytic", npf=2, **kw):
    ep = None
    if backend == "emulator":
        ep = both_emulator_params(REF_A, npf, seed=7)[1]
    return AnalogExecutor(AnalogConfig(backend=backend), geom=CASE_A,
                          emulator_params=ep, **kw)


def _xw(K=70, N=8, B=4, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy((rng.standard_normal((B, K)) * 0.5).astype(np.float32)),
            torch.from_numpy((rng.standard_normal((K, N)) * 0.3).astype(np.float32)))


def test_ideal_scenario_and_remap_bit_identical_to_plain_path():
    x, w = _xw()
    y0 = _ex("emulator").matmul(x, w, "t")
    ex = _ex("emulator", fault_remap=True)
    ex.deploy(scenario=T.get_scenario("ideal"), key=9)
    assert torch.equal(ex.matmul(x, w, "t"), y0)
    ex.deploy(scenario=T.Scenario(name="a", prog_sigma=0.1))
    ya = ex.matmul(x, w, "t")
    ex.deploy(scenario=None)
    assert torch.equal(ex.matmul(x, w, "t"), y0)
    assert not torch.allclose(ya, y0)


def test_device_draw_deterministic_and_keyed():
    x, w = _xw()
    sc = T.Scenario(name="det", prog_sigma=0.1)

    def draw(key):
        ex = _ex()
        ex.deploy(scenario=sc, key=key)
        return ex.matmul(x, w, "t")

    assert torch.equal(draw(5), draw(5))
    assert not torch.allclose(draw(5), draw(6))


def test_read_noise_cycle_to_cycle_and_reproducible():
    x, w = _xw()
    ex = _ex()
    sc = T.Scenario(name="rn", read_sigma=0.1)
    ex.deploy(scenario=sc, key=5)
    y1, y2 = ex.matmul(x, w, "t"), ex.matmul(x, w, "t")
    assert not torch.equal(y1, y2)                     # a fresh read cycle
    ex.deploy(scenario=sc, key=5)                      # restarts the sequence
    assert torch.equal(ex.matmul(x, w, "t"), y1)
    assert torch.equal(ex.matmul(x, w, "t"), y2)
    # one state reads the same draw every call
    st = ex.state_for("t", w)
    assert st.has_read_noise
    assert torch.equal(ex.matmul(x, w, "t", state=st),
                       ex.matmul(x, w, "t", state=st))


def test_read_plan_is_kept_while_the_state_stays(monkeypatch):
    x, w = _xw()
    ex = _ex()
    ex.deploy(scenario=T.Scenario(name="rk", prog_sigma=0.05,
                                  read_sigma=0.1), key=5)
    st = ex.state_for("t", w)
    real, reads = ex._read, []
    monkeypatch.setattr(ex, "_read", lambda s: reads.append(s) or real(s))
    y1 = ex.matmul(x, w, "t", state=st)
    y2 = ex.matmul(x, w, "t", state=st)
    assert len(reads) == 1 and torch.equal(y1, y2)
    # the kept plan is the one a fresh read of the state gives, bit for bit
    fresh = ex._plan_for(w, "t").with_g(real(st), ex.acfg) \
        .with_perm(st.out_perm)
    yv, xs = ex.raw_matmul(x, w, "t", plan=fresh, sfeat=st.sfeat)
    assert torch.equal((st.cal_a * yv + st.cal_b) * xs, y1)
    # the next read cycle is a new state: read again, and drawn anew
    y3 = ex.matmul(x, w, "t", state=ex.state_for("t", w))
    assert len(reads) == 2 and not torch.equal(y3, y1)
    ex.deploy(scenario=None)
    assert not ex._read_cache


def test_noise_aware_calibration_and_drift_and_line_resistance():
    x, w = _xw(K=64, N=4, B=8)
    ex = _ex()
    ex.deploy(scenario=T.Scenario(name="cal", prog_sigma=0.1,
                                  read_sigma=0.05), key=8)
    xc = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (32, 64)).astype(np.float32) * 0.5)
    a, b = ex.calibrate(xc, w, "t", noise_draws=3)
    assert np.isfinite(a) and np.isfinite(b)
    assert torch.isfinite(ex.matmul(x, w, "t")).all()
    # drift shrinks the served output monotonically
    norms = []
    for t in (0.0, 1e2, 1e4, 1e6):
        ex.deploy(scenario=T.Scenario(name="d", drift_nu=0.1, drift_t=t), key=0)
        norms.append(float(torch.linalg.norm(ex.raw_matmul(x, w, "t")[0])))
    assert all(b <= a + 1e-9 for a, b in zip(norms, norms[1:]))
    assert norms[-1] < 0.9 * norms[0]
    # line resistance reaches the circuit backend
    exc = _ex("circuit")
    x2, w2 = _xw(K=64, N=2, B=2)
    y0 = exc.raw_matmul(x2, w2, "t")[0]
    exc.deploy(scenario="ir_degraded", key=0)
    assert exc._cp_effective().r_bl == exc.cp.r_bl * 4.0
    assert not torch.allclose(y0, exc.raw_matmul(x2, w2, "t")[0])


def test_per_tile_perturbation_isolated_to_its_tile():
    _, w = _xw()
    ex = _ex()
    plan = ex._plan_for(w, "t")
    sig = np.zeros((plan.NB, plan.NO))
    sig[0, 3] = 0.2
    ts = T.tile_scenarios(plan.NB, plan.NO, prog_sigma=sig, name="one_tile")
    pp = T.perturb_plan(plan, ACFG, ts, 5)
    changed = (pp.g_feat != plan.g_feat).any(dim=(2, 3, 4))
    assert changed[0, 3]
    changed[0, 3] = False
    assert not changed.any()
    bad = T.tile_scenarios(plan.NB + 1, plan.NO, prog_sigma=0.1)
    with pytest.raises(ValueError, match="tile lattice"):
        T.perturb_plan(plan, ACFG, bad, 0)


def test_remap_toggle_invalidates_state_cache():
    x, w = _xw()
    ex = _ex()
    ex.deploy(scenario=T.Scenario(name="f", p_stuck_off=0.05), key=1)
    y_off = ex.matmul(x, w, "t")
    st_off = ex._state_cache["t"][2]
    ex.deploy(remap=True)
    y_on = ex.matmul(x, w, "t")
    st_on = ex._state_cache["t"][2]
    assert st_on is not st_off
    assert not torch.equal(st_on.out_perm, st_off.out_perm)
    assert not torch.allclose(y_on, y_off)
    assert ex.materialize_s["t"][1] > 0.0              # the remap's share
    ex.deploy(remap=False)
    assert torch.equal(ex.matmul(x, w, "t"), y_off)


def test_nonideal_imports_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, 'src'); import repro_torch.nonideal; "
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'repro')); print('BAD', bad)")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
