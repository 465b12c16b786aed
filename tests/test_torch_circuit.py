"""The port's circuit solver, analytic baseline and Theorem 4.1 helpers
against the JAX package, on the same numpy-made inputs.

``block_response`` is held at rtol 1e-5 / atol 1e-6 (volts), with and
without the peripheral features, for CASE_A and CASE_B blocks; the
measured gap is at most 2.2e-7 V, from XLA contracting the jitted NR
loop's products into FMAs, which the port does not mirror.  The column
sums follow the reference's reduction order (``circuit.ordered_sum``),
so ``analytic_block_response``, held at rtol 1e-6 / atol 1e-8, comes
out bit for bit.  The acceptance bound ``mse_bound(3, 0.3)`` is held
within 1e-9 relative of the reference."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AnalogConfig as RefAnalogConfig  # noqa: E402
from repro.configs.rram_ps32 import CASE_A as REF_A, CASE_B as REF_B  # noqa: E402
from repro.core import analytic as ranalytic  # noqa: E402
from repro.core import circuit as rcircuit  # noqa: E402
from repro.core import theory as rtheory  # noqa: E402
from repro_torch.configs.base import AnalogConfig  # noqa: E402
from repro_torch.configs.rram_ps32 import CASE_A, CASE_B  # noqa: E402
from repro_torch.core import analytic, circuit, theory  # noqa: E402
from torch_parity import assert_close  # noqa: E402

GEOMS = {"A": (REF_A, CASE_A), "B": (REF_B, CASE_B)}


def _blocks(geom, n, seed, v_hi=None):
    """Raw (V, G) block tensors and periph rows, as the data generator
    draws them: V uniform in [0, v_read], G in [g_min, g_max]."""
    acfg = AnalogConfig()
    rng = np.random.default_rng(seed)
    hi = acfg.v_read if v_hi is None else v_hi
    v = rng.uniform(0.0, hi, (n, geom.tiles, geom.rows)).astype(np.float32)
    v[0, 0, :5] = 0.0                           # idle wordlines
    g = rng.uniform(acfg.g_min, acfg.g_max,
                    (n, geom.tiles, geom.rows, geom.cols)).astype(np.float32)
    x = np.stack([np.broadcast_to(v[..., None], g.shape), g], axis=1)
    periph = np.stack([rng.uniform(0.9, 1.1, n), rng.uniform(-0.01, 0.01, n)],
                      axis=1).astype(np.float32)
    return np.ascontiguousarray(x), periph


@pytest.mark.parametrize("g", ["A", "B"])
@pytest.mark.parametrize("with_periph", [False, True])
def test_block_response_matches_reference(g, with_periph):
    rg, tg = GEOMS[g]
    x, periph = _blocks(tg, 24, seed=1 + with_periph)
    cp_r, cp_t = rcircuit.CircuitParams(), circuit.CircuitParams()
    want = rcircuit.block_response(jnp.asarray(x), cp_r,
                                   jnp.asarray(periph) if with_periph else None)
    got = circuit.block_response(torch.from_numpy(x), cp_t,
                                 torch.from_numpy(periph) if with_periph else None)
    assert tuple(got.shape) == (24, tg.outputs)
    assert_close(got, want, 1e-5, 1e-6)


def test_tile_currents_match_reference_under_ir_drop():
    """Column currents through the 3 IR-drop passes, at a bitline
    resistance large enough that the feedback moves them."""
    rng = np.random.default_rng(3)
    acfg = AnalogConfig()
    v = rng.uniform(0.0, acfg.v_read, (6, 4, 64)).astype(np.float32)
    g = rng.uniform(acfg.g_min, acfg.g_max, (6, 4, 64, 2)).astype(np.float32)
    cp_r = rcircuit.CircuitParams(r_bl=4000.0)
    cp_t = circuit.CircuitParams(r_bl=4000.0)
    want = rcircuit.solve_tile_currents(jnp.asarray(v), jnp.asarray(g), cp_r)
    got = circuit.solve_tile_currents(torch.from_numpy(v), torch.from_numpy(g),
                                      cp_t)
    assert_close(got, want, 1e-5, 1e-12)


@pytest.mark.parametrize("fn", ["transistor_current", "_transistor_gds",
                                "memristor_current", "_memristor_gm"])
def test_device_equations_match_reference(fn):
    rng = np.random.default_rng(4)
    a = rng.uniform(-0.1, 0.4, 4096).astype(np.float32)
    b = rng.uniform(-0.1, 0.4, 4096).astype(np.float32)
    b[:64] = np.maximum(a[:64] - 0.08, 0.0)      # v_ds at the triode edge
    if fn.startswith("_memristor") or fn == "memristor_current":
        a = rng.uniform(1e-6, 1e-4, 4096).astype(np.float32)
    want = getattr(rcircuit, fn)(jnp.asarray(a), jnp.asarray(b),
                                 rcircuit.CircuitParams())
    got = getattr(circuit, fn)(torch.from_numpy(a), torch.from_numpy(b),
                               circuit.CircuitParams())
    assert_close(got, want, 1e-6, 1e-12)


def test_cell_current_matches_reference():
    rng = np.random.default_rng(5)
    acfg = AnalogConfig()
    v = rng.uniform(0.0, acfg.v_read, (256, 1)).astype(np.float32)
    g = rng.uniform(acfg.g_min, acfg.g_max, (256, 3)).astype(np.float32)
    vbl = rng.uniform(0.0, 0.02, (1, 3)).astype(np.float32)
    want = rcircuit.cell_current(jnp.asarray(v), jnp.asarray(g),
                                 jnp.asarray(vbl), rcircuit.CircuitParams())
    got = circuit.cell_current(torch.from_numpy(v), torch.from_numpy(g),
                               torch.from_numpy(vbl), circuit.CircuitParams())
    assert_close(got, want, 1e-5, 1e-12)


@pytest.mark.parametrize("g", ["A", "B"])
@pytest.mark.parametrize("with_periph", [False, True])
def test_analytic_block_response_matches_reference(g, with_periph):
    rg, tg = GEOMS[g]
    x, periph = _blocks(tg, 32, seed=7, v_hi=1.0)   # some blocks clip
    cp_r, cp_t = rcircuit.CircuitParams(), circuit.CircuitParams()
    want = ranalytic.analytic_block_response(
        jnp.asarray(x), cp_r, jnp.asarray(periph) if with_periph else None)
    got = analytic.analytic_block_response(
        torch.from_numpy(x), cp_t,
        torch.from_numpy(periph) if with_periph else None)
    assert_close(got, want, 1e-6, 1e-8)


@pytest.mark.parametrize("s,p", [(3, 0.3), (2, 0.5), (3, 0.9), (4, 0.1)])
def test_mse_bounds_match_reference(s, p):
    for name in ("mse_bound", "mse_bound_strict"):
        want = getattr(rtheory, name)(s, p)
        got = getattr(theory, name)(s, p)
        assert abs(got - want) <= 1e-9 * abs(want), (name, got, want)
    if (s, p) == (3, 0.3):
        assert abs(theory.mse_bound(3, 0.3) - 6.73e-6) < 0.01e-6


def test_significance_helpers_match_reference():
    rng = np.random.default_rng(8)
    err = (rng.standard_normal(5000) * 6e-4).astype(np.float32)
    want = float(rtheory.significance_probability(jnp.asarray(err), 3))
    got = float(theory.significance_probability(torch.from_numpy(err), 3))
    assert got == want
    for p in (0.3, 0.6, 0.9):
        assert theory.check_significance(torch.from_numpy(err), 3, p) == \
            rtheory.check_significance(jnp.asarray(err), 3, p)
    for mse in (1e-7, 6.7e-6, 1e-4):
        assert theory.predicted_probability(mse, 3) == \
            rtheory.predicted_probability(mse, 3)


def test_erfinv_matches_torch_away_from_the_bound():
    x = torch.linspace(-0.999, 0.999, 2001)
    np.testing.assert_allclose(theory.erfinv_f32(x).numpy(),
                               torch.special.erfinv(x).numpy(),
                               rtol=2e-6, atol=1e-7)


def test_circuit_normalization_constants_match_reference_config():
    r, t = RefAnalogConfig(), AnalogConfig()
    assert (r.v_read, r.g_min, r.g_max) == (t.v_read, t.g_min, t.g_max)
    assert rcircuit.CircuitParams() == rcircuit.CircuitParams(
        **{k: getattr(circuit.CircuitParams(), k)
           for k in circuit.CircuitParams.__dataclass_fields__})


@pytest.mark.parametrize("shape,dims", [((3, 4, 64, 2), (1, 2)), ((5, 64, 2), (-2,)),
                                        ((2, 4, 3), (1,)), ((2, 3, 70, 4), (1, 2)),
                                        ((6, 33), (1,))])
def test_ordered_sum_is_the_reference_reduction(shape, dims):
    """Bit for bit against the reference's own float32 sum, ragged last
    axes (padded chunks) included."""
    x = np.random.default_rng(len(shape)).uniform(0, 1e-5, shape).astype(np.float32)
    want = jnp.asarray(x).sum(axis=dims)
    got = circuit.ordered_sum(torch.from_numpy(x), dims)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ordered_sum_refuses_apart_dims():
    with pytest.raises(ValueError, match="adjacent"):
        circuit.ordered_sum(torch.zeros(2, 3, 4), (0, 2))
