"""The port's Conv4Xbar against the reference, at the reference's own fp32
parity tolerance (rtol 2e-5 / atol 2e-6, tests/test_kernels.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.rram_ps32 import CASE_A as REF_A, CASE_B as REF_B  # noqa: E402
from repro.core import conv4xbar as ref  # noqa: E402
from repro.nonideal.scenario import N_SCENARIO_FEATURES  # noqa: E402
from repro_torch.configs.rram_ps32 import CASE_A, CASE_B  # noqa: E402
from repro_torch.core import conv4xbar  # noqa: E402
from repro_torch.core.deployment import N_SCENARIO_FEATURES as T_NSF  # noqa: E402
from torch_parity import assert_close, both_emulator_params  # noqa: E402

RTOL, ATOL = 2e-5, 2e-6
GEOMS = {"A": (REF_A, CASE_A), "B": (REF_B, CASE_B)}
NETS = {"plain": 0, "cond": 2 + N_SCENARIO_FEATURES}


def _inputs(geom, NB, NO, M, seed=0):
    """g_norm (with a zero-conductance pad tile), drive u and rail mask."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.0, 1.0, (NB, NO, geom.tiles, geom.rows, geom.cols))
    g[-1, :, -1] = -0.0101                    # padded tile: g_feat = 0
    u = rng.uniform(0.0, 1.0, (M, NB, geom.tiles, geom.rows))
    u = np.where(rng.uniform(size=u.shape) < 0.2, 0.0, 0.4 + 0.6 * u)
    u[:, -1, -1] = 0.0                        # padded wordlines drive zero
    pos = (rng.uniform(size=u.shape) < 0.5) & (u > 0)
    return (g.astype(np.float32), u.astype(np.float32),
            pos.astype(np.float32))


def _both(g):
    rg, tg = GEOMS[g]
    return rg, tg


def test_scenario_feature_width_matches():
    assert T_NSF == N_SCENARIO_FEATURES


@pytest.mark.parametrize("g", sorted(GEOMS))
def test_stages_and_schema_match(g):
    rg, tg = _both(g)
    assert [s.__dict__ for s in conv4xbar.build_stages(tg)] == \
        [s.__dict__ for s in ref.build_stages(rg)]
    assert conv4xbar.flat_features(tg) == ref.flat_features(rg)
    for npf in NETS.values():
        ts, rs = conv4xbar.conv4xbar_schema(tg, npf), ref.conv4xbar_schema(rg, npf)
        assert sorted(ts) == sorted(rs)
        for k in ts:
            assert tuple(ts[k].shape) == tuple(rs[k].shape), k
            assert ts[k].init == rs[k].init and ts[k].scale == rs[k].scale


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("g", sorted(GEOMS))
def test_blocklast_weights_and_precompute(g, net):
    rg, tg = _both(g)
    jp, tp = both_emulator_params(rg, NETS[net], seed=1)
    ra, ta = ref.blocklast_weights(jp, rg), conv4xbar.blocklast_weights(tp, tg)
    assert sorted(ra) == sorted(ta)
    for k in ("w0v", "w0g", "b0", "w1k") + (("f0_scen",) if net == "cond" else ()):
        assert_close(ta[k], ra[k], RTOL, ATOL, k)
    for (tw, tb, tk), (rw, rb, rk) in zip(ta["hstages"], ra["hstages"]):
        assert tk == rk
        assert_close(tw, rw, RTOL, ATOL)
        assert_close(tb, rb, RTOL, ATOL)
    assert ta["wstage"][2] == ra["wstage"][2]
    assert_close(ta["wstage"][0], ra["wstage"][0], RTOL, ATOL)
    for (tw, tb), (rw, rb) in zip(ta["fcs"], ra["fcs"]):
        assert_close(tw, rw, RTOL, ATOL)
        assert_close(tb, rb, RTOL, ATOL)
    gn, _, _ = _inputs(tg, 2, 3, 1)
    rpre = ref.blocklast_precompute(ra, jnp.asarray(gn))
    tpre = conv4xbar.blocklast_precompute(ta, torch.from_numpy(gn))
    for k in ("g0k", "celu0k", "y0"):
        assert_close(tpre[k], rpre[k], RTOL, ATOL, k)


CASES = [  # (geometry, net, NB, NO, M, chunk, shift)
    ("A", "plain", 2, 3, 5, 2, None),
    ("A", "plain", 3, 2, 7, 4, None),
    ("B", "plain", 2, 2, 3, 2, None),
    ("A", "cond", 2, 3, 5, 2, "flat"),
    ("B", "cond", 2, 2, 3, 2, "block"),
    ("A", "cond", 2, 2, 4, 3, "block"),
]


@pytest.mark.parametrize("g,net,NB,NO,M,chunk,shift", CASES)
def test_apply_blocklast(g, net, NB, NO, M, chunk, shift):
    rg, tg = _both(g)
    jp, tp = both_emulator_params(rg, NETS[net], seed=2)
    ra, ta = ref.blocklast_weights(jp, rg), conv4xbar.blocklast_weights(tp, tg)
    gn, u, pos = _inputs(tg, NB, NO, M, seed=3)
    rpre = ref.blocklast_precompute(ra, jnp.asarray(gn))
    tpre = conv4xbar.blocklast_precompute(ta, torch.from_numpy(gn))
    sh = None
    if shift is not None:
        rng = np.random.default_rng(4)
        f = ra["fcs"][0][0].shape[1]
        sh = (0.3 * rng.standard_normal((f,) if shift == "flat"
                                        else (NB * NO, f))).astype(np.float32)
    want = ref.apply_blocklast(ra, rpre, jnp.asarray(u), jnp.asarray(pos),
                               chunk=chunk,
                               fc0_shift=None if sh is None else jnp.asarray(sh))
    got = conv4xbar.apply_blocklast(
        ta, tpre, torch.from_numpy(u), torch.from_numpy(pos), chunk=chunk,
        fc0_shift=None if sh is None else torch.from_numpy(sh))
    assert tuple(got.shape) == (2, M * NB * NO, tg.outputs)
    assert_close(got, want, RTOL, ATOL)


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("g", sorted(GEOMS))
def test_apply_paper_faithful(g, net):
    rg, tg = _both(g)
    jp, tp = both_emulator_params(rg, NETS[net], seed=5)
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (6, 2, tg.tiles, tg.rows, tg.cols)).astype(np.float32)
    per = rng.uniform(0, 1, (6, NETS[net])).astype(np.float32) if NETS[net] \
        else None
    want = ref.apply(jp, jnp.asarray(x),
                     None if per is None else jnp.asarray(per))
    got = conv4xbar.apply(tp, torch.from_numpy(x),
                          None if per is None else torch.from_numpy(per))
    assert_close(got, want, RTOL, ATOL)
