"""The port's emulator lifecycle (``repro_torch.core.emulator``) against the
JAX package's: feature normalization bit for bit, and ``train_emulator``
from the same initial params on the same data.

Training parity: the reference draws its initial params from its own key
(``init_params(split(key, 3)[1], schema)``); the test hands that draw to
the port as numpy, with the same (X, periph, Y) and the same permutation
seed, so the two runs differ only in float association (the reference
trains through ``apply_fused``, the port through ``apply``).  Per-epoch
train loss and final test MSE/MAE agree within 2% relative; measured on
this test's three cases the gap is at most 2.8e-7 relative."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AnalogConfig as RefAnalogConfig  # noqa: E402
from repro.configs.rram_ps32 import CASE_A as REF_A, CASE_B as REF_B  # noqa: E402
from repro.configs.rram_ps32 import EmulatorTrainConfig as RefTrainConfig  # noqa: E402
from repro.core import circuit as rcircuit  # noqa: E402
from repro.core import conv4xbar as rconv  # noqa: E402
from repro.core import emulator as remulator  # noqa: E402
from repro.models.common import init_params as ref_init_params  # noqa: E402
from repro_torch.configs.base import AnalogConfig  # noqa: E402
from repro_torch.configs.rram_ps32 import CASE_A, CASE_B, EmulatorTrainConfig  # noqa: E402
from repro_torch.core import circuit, conv4xbar, emulator  # noqa: E402
from repro_torch.interop import emulator_params_from_numpy  # noqa: E402
from repro_torch.kernels.emulator_block import emulator_block as eb  # noqa: E402
from torch_parity import assert_close, to_np  # noqa: E402

GEOMS = {"A": (REF_A, CASE_A), "B": (REF_B, CASE_B)}


def _raw_blocks(geom, n, seed):
    acfg = AnalogConfig()
    rng = np.random.default_rng(seed)
    v = rng.uniform(0.0, acfg.v_read, (n, geom.tiles, geom.rows)).astype(np.float32)
    g = rng.uniform(acfg.g_min, acfg.g_max,
                    (n, geom.tiles, geom.rows, geom.cols)).astype(np.float32)
    x = np.ascontiguousarray(np.stack([np.broadcast_to(v[..., None], g.shape), g],
                                      axis=1))
    periph = np.stack([rng.uniform(0.9, 1.1, n), rng.uniform(-0.01, 0.01, n)],
                      axis=1).astype(np.float32)
    return x, periph


@pytest.mark.parametrize("g", ["A", "B"])
def test_normalize_features_bit_for_bit(g):
    _, tg = GEOMS[g]
    x, _ = _raw_blocks(tg, 16, seed=1)
    want = remulator.normalize_features(jnp.asarray(x), RefAnalogConfig())
    got = emulator.normalize_features(torch.from_numpy(x), AnalogConfig())
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


def _ref_data(geom, n, seed, with_periph=True):
    """(X normalized, periph, Y) labelled by the reference circuit solver,
    as numpy."""
    x, periph = _raw_blocks(geom, n, seed)
    y = rcircuit.block_response(jnp.asarray(x), rcircuit.CircuitParams(),
                                jnp.asarray(periph) if with_periph else None)
    xn = remulator.normalize_features(jnp.asarray(x), RefAnalogConfig())
    return (np.array(xn), periph if with_periph else None, np.array(y))


@pytest.mark.parametrize("g,with_periph", [("A", True), ("B", True), ("A", False)])
def test_train_emulator_matches_reference(g, with_periph, capsys):
    rg, tg = GEOMS[g]
    n_train, n_test = 128, 32
    X, P, Y = _ref_data(tg, n_train + n_test, seed=2, with_periph=with_periph)
    key = jax.random.PRNGKey(3)
    npf = 2 if with_periph else 0
    init = ref_init_params(jax.random.split(key, 3)[1],
                           rconv.conv4xbar_schema(rg, n_periph=npf))
    kw = dict(n_train=n_train, n_test=n_test, epochs=2, lr=2e-3,
              lr_halve_at=(1,), batch_size=32, seed=4)
    ref = remulator.train_emulator(
        key, rg, RefAnalogConfig(), rcircuit.CircuitParams(), RefTrainConfig(**kw),
        log_every=1, data=(jnp.asarray(X), None if P is None else jnp.asarray(P),
                           jnp.asarray(Y)))
    eb.emulator_block_cuda.launches = 0
    got = emulator.train_emulator(
        3, tg, AnalogConfig(), circuit.CircuitParams(), EmulatorTrainConfig(**kw),
        log_every=1, params=emulator_params_from_numpy(
            {k: np.asarray(v) for k, v in init.items()}, device="cpu"),
        data=(torch.from_numpy(X), None if P is None else torch.from_numpy(P),
              torch.from_numpy(Y)))
    assert eb.emulator_block_cuda.launches == 0      # CPU: the plain version
    assert got.history["epoch"] == ref.history["epoch"] == [0, 1]
    assert got.history["lr"] == ref.history["lr"] == [2e-3, 1e-3]
    np.testing.assert_allclose(got.history["train"], ref.history["train"], rtol=2e-2)
    np.testing.assert_allclose(got.history["test"], ref.history["test"], rtol=2e-2)
    for f in ("train_mse", "test_mse", "test_mae"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f), rtol=2e-2,
                                   err_msg=f)
    assert got.bound == ref.bound
    assert got.accepted == ref.accepted
    assert abs(got.sig_prob - ref.sig_prob) <= 1.0 / n_test
    assert sorted(got.params) == sorted(ref.params)
    for k in ref.params:
        assert_close(got.params[k], ref.params[k], 2e-2, 2e-4, what=k)
    # the returned params predict raw volts (the standardization is folded)
    pred = conv4xbar.apply(got.params, torch.from_numpy(X[n_train:]),
                           None if P is None else torch.from_numpy(P[n_train:]))
    mse = float(torch.mean(torch.square(pred - torch.from_numpy(Y[n_train:]))))
    np.testing.assert_allclose(mse, got.test_mse, rtol=1e-5)
    assert "epoch     1" in capsys.readouterr().out


def test_train_emulator_draws_its_own_data_and_params():
    tcfg = EmulatorTrainConfig(n_train=64, n_test=16, epochs=1, batch_size=32)
    res = emulator.train_emulator(0, CASE_A, AnalogConfig(), circuit.CircuitParams(),
                                  tcfg, device="cpu")
    assert np.isfinite(res.test_mse) and res.test_mse > 0
    assert res.history == {"epoch": [], "train": [], "test": [], "lr": []}
    assert conv4xbar.n_periph_of(res.params, CASE_A) == 2
    assert res.params["fc0_w"].device.type == "cpu"
    # the fused flag selects nothing: same seed, same run
    res2 = emulator.train_emulator(0, CASE_A, AnalogConfig(), circuit.CircuitParams(),
                                   tcfg, fused=False, device="cpu")
    for k in res.params:
        assert torch.equal(res.params[k], res2.params[k])


def test_generate_dataset_labels_with_the_circuit_solver():
    acfg, cp = AnalogConfig(), circuit.CircuitParams()
    gen = torch.Generator().manual_seed(5)
    X, P, Y = emulator.generate_dataset(gen, 10, CASE_B, acfg, cp, batch=4)
    assert tuple(X.shape) == (10,) + CASE_B.chw and tuple(P.shape) == (10, 2)
    assert tuple(Y.shape) == (10, CASE_B.outputs)
    assert float(X.min()) >= 0.0 and float(X.max()) <= 1.0
    # normalization inverts exactly enough to re-label the same blocks
    x = torch.stack([X[:, 0] * acfg.v_read,
                     X[:, 1] * (acfg.g_max - acfg.g_min) + acfg.g_min], dim=1)
    np.testing.assert_allclose(to_np(circuit.block_response(x, cp, P)), to_np(Y),
                               rtol=1e-4, atol=1e-6)
    # the draw is the generator's: the same seed gives the same set
    X2, P2, Y2 = emulator.generate_dataset(torch.Generator().manual_seed(5), 10,
                                           CASE_B, acfg, cp, batch=4)
    assert torch.equal(X, X2) and torch.equal(P, P2) and torch.equal(Y, Y2)


def test_sample_block_inputs_ranges_and_shared_wordline_drive():
    acfg = AnalogConfig()
    x, p = emulator.sample_block_inputs(torch.Generator().manual_seed(0), 50,
                                        CASE_A, acfg)
    assert tuple(x.shape) == (50,) + CASE_A.chw
    v, g = x[:, 0], x[:, 1]
    assert torch.equal(v[..., 0], v[..., 1])       # one drive per wordline
    assert float(v.min()) >= 0.0 and float(v.max()) <= acfg.v_read
    assert float(g.min()) >= acfg.g_min and float(g.max()) <= acfg.g_max
    assert float(p[:, 0].min()) >= 0.9 and float(p[:, 0].max()) <= 1.1
    assert float(p[:, 1].abs().max()) <= 0.01
    _, none = emulator.sample_block_inputs(torch.Generator().manual_seed(0), 5,
                                           CASE_A, acfg, with_periph=False)
    assert none is None


def test_train_config_matches_reference():
    assert RefTrainConfig() == RefTrainConfig(**vars(EmulatorTrainConfig()))


def test_quickstart_runs_on_the_cpu(tmp_path, capsys):
    """The port's quickstart, end to end at a smoke size: circuit blocks,
    labelling, training, a saved npz and a calibrated emulator matmul."""
    from repro_torch.interop import load_emulator_npz
    from repro_torch.launch import quickstart
    npz = tmp_path / "em.npz"
    out = quickstart.main(["--device", "cpu", "--n-train", "64", "--n-test", "16",
                           "--epochs", "2", "--lr-halve-at", "1",
                           "--save-npz", str(npz)])
    assert out["n_labelled"] == 80 and out["label_s"] > 0
    res = out["result"]
    assert res.history["epoch"] == [0, 1] and res.history["lr"] == [2e-3, 1e-3]
    assert np.isfinite(out["corr"])
    saved = load_emulator_npz(str(npz), device="cpu")
    assert sorted(saved) == sorted(res.params)
    text = capsys.readouterr().out
    assert "circuit block outputs (V)" in text and "corr =" in text
