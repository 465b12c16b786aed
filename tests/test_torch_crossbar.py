"""The port's crossbar plan equals the reference bit for bit: tiling,
padding and the (G+, G-) interleave are data movement plus one affine,
done in the weight's own dtype in the same order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AnalogConfig as RefAnalogConfig  # noqa: E402
from repro.configs.rram_ps32 import CASE_A as REF_A, CASE_B as REF_B  # noqa: E402
from repro.core import crossbar as ref  # noqa: E402
from repro_torch.configs.base import AnalogConfig  # noqa: E402
from repro_torch.configs.rram_ps32 import CASE_A, CASE_B  # noqa: E402
from repro_torch.core import crossbar  # noqa: E402
from torch_parity import to_np  # noqa: E402

# (K, N, geometry): the odd K=70/N=3 shape, a padT > 0 case and CASE_B
# with no=4 and padN > 0
CASES = [(70, 3, "A"), (200, 5, "A"), (300, 10, "B"), (64, 4, "B")]
GEOMS = {"A": (REF_A, CASE_A), "B": (REF_B, CASE_B)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _plans(K, N, g, dt, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32)
    rgeom, tgeom = GEOMS[g]
    jdt, tdt = DTYPES[dt]
    rp = ref.build_conductance_plan(jnp.asarray(w).astype(jdt),
                                    RefAnalogConfig(), rgeom)
    tp = crossbar.build_conductance_plan(torch.from_numpy(w).to(tdt),
                                         AnalogConfig(), tgeom)
    return rp, tp


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("K,N,g", CASES)
def test_build_conductance_plan_bit_equal(K, N, g, dt):
    rp, tp = _plans(K, N, g, dt)
    assert (tp.NB, tp.NO, tp.D, tp.rows, tp.no) == \
        (rp.NB, rp.NO, rp.D, rp.rows, rp.no)
    assert str(tp.g_feat.dtype).endswith(dt)
    np.testing.assert_array_equal(to_np(tp.g_feat), to_np(rp.g_feat))
    np.testing.assert_array_equal(to_np(tp.g_norm), to_np(rp.g_norm))
    # the serving order: g_feat pinned to f32, g_norm recomputed in f32
    acfg = AnalogConfig()
    rw = rp.with_g(rp.g_feat.astype(jnp.float32), RefAnalogConfig())
    tw = tp.with_g(tp.g_feat.float(), acfg)
    np.testing.assert_array_equal(to_np(tw.g_norm), to_np(rw.g_norm))


@pytest.mark.parametrize("K,N,g", CASES)
def test_tile_v_bit_equal(K, N, g):
    rp, tp = _plans(K, N, g, "float32")
    rng = np.random.default_rng(1)
    v = rng.uniform(0, 1, (5, K)).astype(np.float32)
    for v_read in (1.0, 0.2):
        np.testing.assert_array_equal(
            to_np(tp.tile_v(torch.from_numpy(v), v_read)),
            to_np(rp.tile_v(jnp.asarray(v), v_read)))


@pytest.mark.parametrize("perm", [False, True])
@pytest.mark.parametrize("K,N,g", CASES)
def test_assemble_bit_equal(K, N, g, perm):
    rp, tp = _plans(K, N, g, "float32")
    rng = np.random.default_rng(2)
    M = 3
    outs = rng.standard_normal((M * tp.n_blocks, tp.no)).astype(np.float32)
    if perm:
        rp = rp.with_perm(jnp.arange(N, dtype=jnp.int32))
        tp = tp.with_perm(torch.arange(N))
    np.testing.assert_array_equal(to_np(tp.assemble(torch.from_numpy(outs))),
                                  to_np(rp.assemble(jnp.asarray(outs))))


def test_plan_matmul_matches():
    for K, N, g in CASES:
        rgeom, tgeom = GEOMS[g]
        assert crossbar.plan_matmul(K, N, AnalogConfig(), tgeom).__dict__ == \
            ref.plan_matmul(K, N, RefAnalogConfig(), rgeom).__dict__
