"""The port's tensor-parallel analog serving plane
(``repro_torch.parallel.sharding``, ``AnalogExecutor(mesh=)``,
``launch.mesh``, ``serve --mesh``) on the CPU.

The partition math is held against the JAX package's functions on the
same integers.  The mesh contracts of the reference's
``tests/test_multidevice.py`` run in ONE world of 4 gloo ranks
(``tests/torch_mesh_worker.py``, one intra-op thread each), which builds
the (1, 4), (2, 2) and (4, 1) meshes: the sharded outputs are held bit
for bit against the port's replicated executor and, at the reference's
tolerances, against the JAX reference's ``AnalogExecutor.matmul``
without a mesh, computed here on the same params and data
(``use_pallas=False``; the reference's own sharded bit-identity test
fails on this jax).  Then the serve CLI on a (1, 2) mesh against the
unsharded serve.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.configs.base import AnalogConfig as RefAnalogConfig  # noqa: E402
from repro.configs.rram_ps32 import CASE_A as REF_A  # noqa: E402
from repro.core.analog import AnalogExecutor as RefExecutor  # noqa: E402
from repro.core.crossbar import (build_conductance_plan,  # noqa: E402
                                 fault_aware_group_perm)
from repro.core.deployment import _STATE_FIELDS as REF_FIELDS  # noqa: E402
from repro.parallel import sharding as ref  # noqa: E402
from repro_torch.core.crossbar import sum_block_groups  # noqa: E402
from repro_torch.core.deployment import _STATE_FIELDS  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from torch_parity import both_emulator_params, ref_emulator_params  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402

ACFG = RefAnalogConfig()
_K_PER_NB = REF_A.tiles * ACFG.rows
WORLD = 4
PROMPTS, GEN = ((3, 17, 250, 9, 41, 77), (100, 5, 60, 200, 7, 8)), 4
RTOL_COL, ATOL_COL = 2e-5, 2e-6          # the reference's fp32 parity
RTOL_ROW, ATOL_ROW = 1e-5, 2e-6          # its row-scheme tolerance


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# Partition math, against the reference's on the same integers
# --------------------------------------------------------------------------- #
@settings(max_examples=25, deadline=None)
@given(nb=st.integers(min_value=1, max_value=12),
       no=st.integers(min_value=1, max_value=12),
       tp=st.sampled_from([1, 2, 3, 4, 8]))
def test_lattice_scheme_factorizes_exactly(nb, no, tp):
    scheme = shd.lattice_scheme(nb, no, tp)
    assert scheme == ref.lattice_scheme(nb, no, tp)
    nb_l, no_l = shd.local_lattice(nb, no, tp, scheme)
    assert (nb_l, no_l) == ref.local_lattice(nb, no, tp, scheme)
    if scheme == "col":
        assert no % tp == 0 and (nb_l, no_l * tp) == (nb, no)
    elif scheme == "row":
        assert nb % tp == 0 and (nb_l * tp, no_l) == (nb, no)
    else:
        assert (nb_l, no_l) == (nb, no)
        assert tp <= 1 or (no % tp != 0 and nb % tp != 0)
    # the windows of the model axis tile the lattice exactly
    cells = np.zeros((nb, no), np.int64)
    for t in range(tp if scheme else 1):
        snb, sno = shd.lattice_window(nb, no, tp, scheme, t)
        assert cells[snb, sno].shape == (nb_l, no_l)
        cells[snb, sno] += 1
    assert (cells == 1).all()


@settings(max_examples=25, deadline=None)
@given(groups=st.integers(min_value=1, max_value=6),
       cpg=st.integers(min_value=1, max_value=4),
       tp=st.sampled_from([1, 2, 4]))
def test_shard_output_slices_tile_the_columns_exactly(groups, cpg, tp):
    no = groups * tp
    slices = shd.shard_output_slices(no, cpg, tp)
    assert slices == ref.shard_output_slices(no, cpg, tp)
    cols = [c for a, b in slices for c in range(a, b)]
    assert cols == list(range(no * cpg))


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10**9),
       nb=st.integers(min_value=1, max_value=3),
       groups=st.integers(min_value=1, max_value=3),
       tp=st.sampled_from([2, 4]))
def test_sharded_assembly_partitions_fault_aware_assembly(seed, nb, groups,
                                                          tp):
    """Integer block outputs through the port's block-group sum: the col
    windows and the row partial sums each partition the unsharded
    ``fault_aware_group_perm`` assembly exactly."""
    rng = np.random.default_rng(seed)
    n = groups * tp
    K = int(rng.integers((nb - 1) * _K_PER_NB + 1, nb * _K_PER_NB + 1))
    w = rng.normal(size=(K, n)).astype(np.float32) * 0.3
    plan = build_conductance_plan(jnp.asarray(w), ACFG, REF_A)
    assert (plan.NB, plan.NO) == (nb, n)
    stuck = rng.random(np.shape(plan.g_feat)) < 0.05
    out_perm, _, _ = fault_aware_group_perm(np.asarray(plan.g_feat), stuck,
                                            plan, ACFG)
    M = 3
    flat = rng.integers(-8, 9, size=(M, plan.NB, plan.NO * plan.no))
    want = flat.sum(axis=1)[:, out_perm]
    y = torch.from_numpy(flat.astype(np.float64))
    acc = torch.full((M, plan.NO * plan.no), -0.0, dtype=torch.float64)
    for a, b in shd.shard_output_slices(plan.NO, plan.no, tp):
        acc[:, a:b] += sum_block_groups(y[:, :, a:b])
    np.testing.assert_array_equal(acc.numpy()[:, out_perm], want)
    if nb % tp == 0:
        parts = [sum_block_groups(y[:, shd.lattice_window(
            nb, n, tp, "row", t)[0]]) for t in range(tp)]
        np.testing.assert_array_equal(sum(parts).numpy()[:, out_perm], want)


@pytest.mark.parametrize("scheme", [None, "row", "col"])
def test_state_pspecs_cover_every_deployment_state_field(scheme):
    specs = shd.state_pspecs(scheme)
    assert set(specs) == set(_STATE_FIELDS) == set(REF_FIELDS)
    axis = {None: None, "row": 0, "col": 1}[scheme]
    for f, spec in ref.state_pspecs(scheme).items():
        # the reference's PartitionSpec names the model axis at position
        # ``axis`` for the sliced fields and nothing for the replicated
        want = axis if len(spec) and spec[-1] == ref.MODEL_AXIS else None
        assert specs[f] == want, f


@pytest.mark.parametrize("nb", [1, 2, 3, 5, 12, 16, 27])
def test_block_group_sum_is_the_same_for_any_column_slice(nb):
    """The assembly's order does not follow the column count (torch.sum
    over a middle axis does on the CPU: the col scheme rests on this),
    and a rank's power-of-two run of block groups is a node of its tree
    (the row scheme's bit-identity rests on that)."""
    rng = np.random.default_rng(nb)
    y = torch.from_numpy((rng.standard_normal((4, nb, 48)) * 1e3)
                         .astype(np.float32))
    full = sum_block_groups(y)
    for a, b in ((0, 12), (12, 24), (0, 24), (24, 48), (5, 6)):
        assert torch.equal(sum_block_groups(y[:, :, a:b].contiguous()),
                           full[:, a:b])
    np.testing.assert_allclose(full.numpy(), y.sum(1).numpy(), rtol=1e-5,
                               atol=1e-2)
    for tp in (2, 4):
        nl = nb // tp
        if nb % tp or nl & (nl - 1):
            continue
        parts = torch.stack([sum_block_groups(y[:, t * nl:(t + 1) * nl])
                             for t in range(tp)], dim=1)
        assert torch.equal(sum_block_groups(parts), full)


def test_a_windowed_state_keeps_its_window_and_is_not_saved(tmp_path):
    """A state's window survives the serving stamps (affine, read key)
    and goes with a new ``gf``; a windowed state is not written as if it
    were whole."""
    from repro_torch.configs.base import AnalogConfig
    from repro_torch.configs.rram_ps32 import CASE_A
    from repro_torch.core.crossbar import build_conductance_plan as plan_of
    from repro_torch.core.deployment import DeploymentState, save_deployment
    plan = plan_of(torch.ones((70, 4)), AnalogConfig(), CASE_A)
    st = DeploymentState.ideal(plan)
    lat = ("col", 2, 1, 1, 8)
    assert st.window is None and st.in_window(lat) is st
    assert st.with_calibration(2.0, 0.5).with_read_key(3).window == lat
    assert st.replace(gf=st.gf).window is None
    with pytest.raises(ValueError, match="gather"):
        save_deployment(str(tmp_path / "d.npz"), {"t": st})


def test_module_doctest_holds():
    import doctest
    res = doctest.testmod(shd)
    assert res.failed == 0 and res.attempted == 5


def test_serve_mesh_needs_a_group_of_its_size():
    with pytest.raises(RuntimeError):
        shd.serve_mesh(1, 2, device="cpu")
    assert shd.mesh_shape(None) == (1, 1) and shd.mesh_coords(None) == (0, 0)


# --------------------------------------------------------------------------- #
# The mesh contracts: one world of 4 gloo ranks
# --------------------------------------------------------------------------- #
def _data(K, N, B, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((B, K)) * 0.5).astype(np.float32),
            (rng.standard_normal((K, N)) * 0.3).astype(np.float32))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(rank results, JAX reference outputs) of one 4-rank launch."""
    from repro_torch.launch.mesh import launch
    tmp = tmp_path_factory.mktemp("mesh")
    arrs = {f"ep:{k}": v for k, v in ref_emulator_params(REF_A, 2, 7).items()}
    arrs.update({f"ep2:{k}": v
                 for k, v in ref_emulator_params(REF_A, 2, 8).items()})
    refs = {}
    jp, _ = both_emulator_params(REF_A, 2, 7)
    for i, (case, K, N, B, _) in enumerate(worker.CASES):
        x, w = _data(K, N, B, i)
        arrs[f"{case}:x"], arrs[f"{case}:w"] = x, w
        for backend in ("emulator", "analytic") if case == "col" else (
                "emulator",):
            kw = dict(emulator_params=jp, use_pallas=False) \
                if backend == "emulator" else {}
            rex = RefExecutor(acfg=RefAnalogConfig(backend=backend),
                              geom=REF_A, **kw)
            refs[f"{case}:{backend}"] = np.asarray(
                rex.matmul(jnp.asarray(x), jnp.asarray(w), "t"))
    np.savez(tmp / "payload.npz", **arrs)
    results = launch(worker.contracts, WORLD, args=(dict(
        npz=str(tmp / "payload.npz"), tmp=str(tmp), prompts=PROMPTS,
        gen=GEN),), device="cpu")
    return results, refs


def test_ranks_sit_on_the_mesh_coordinates(world):
    results, _ = world
    for r, res in enumerate(results):
        assert res["shapes"] == {m: m for m in worker.MESHES}
        for (dp, tp), c in res["coords"].items():
            assert c == (r // tp, r % tp)


@pytest.mark.parametrize("mesh", worker.MESHES)
@pytest.mark.parametrize("case,backend", [("col", "emulator"),
                                          ("col", "analytic"),
                                          ("none", "emulator")])
def test_sharded_serve_bit_identical_to_replicated(world, case, backend, mesh):
    """col (NO = 8) and the lattice that neither axis divides (NB = 3,
    NO = 5) equal the port's replicated path bit for bit on every rank,
    and the JAX reference within its fp32 parity tolerance."""
    results, refs = world
    tp = mesh[1]
    want_scheme = {"col": "col" if tp > 1 else None, "none": None}[case]
    for res in results:
        assert res[f"{case}:{backend}:{mesh}:scheme"] == want_scheme
        np.testing.assert_array_equal(res[f"{case}:{backend}:{mesh}"],
                                      res[f"{case}:{backend}:rep"])
    np.testing.assert_allclose(results[0][f"{case}:{backend}:{mesh}"],
                               refs[f"{case}:{backend}"], rtol=RTOL_COL,
                               atol=ATOL_COL)


@pytest.mark.parametrize("mesh", worker.MESHES)
def test_forced_row_scheme_within_float_tolerance(world, mesh):
    """Row (K = 1024: NB = 4), forced: within the reference's row
    tolerance of the replicated path -- and, each rank holding a
    power-of-two run of block groups (4 / tp), equal to it bit for bit."""
    results, refs = world
    for res in results:
        assert res[f"row:emulator:{mesh}:scheme"] == ("row" if mesh[1] > 1
                                                     else None)
        np.testing.assert_allclose(res[f"row:emulator:{mesh}"],
                                   res["row:emulator:rep"], rtol=RTOL_ROW,
                                   atol=ATOL_ROW)
        np.testing.assert_array_equal(res[f"row:emulator:{mesh}"],
                                      res["row:emulator:rep"])
    np.testing.assert_allclose(results[0][f"row:emulator:{mesh}"],
                               refs["row:emulator"], rtol=RTOL_ROW,
                               atol=ATOL_ROW)


@pytest.mark.parametrize("mesh", worker.MESHES)
@pytest.mark.parametrize("case", ["col", "row", "none"])
def test_a_rank_caches_its_window_of_the_lattice(world, case, mesh):
    """Every byte an executor caches (its plans, states and read plans)
    is 1/tp of the unsharded executor's where the lattice is sharded:
    the cached plan holds the rank's window, the ideal state shares it."""
    results, _ = world
    tp = mesh[1]
    nb, no = {"col": (1, 8), "row": (4, 5), "none": (3, 5)}[case]
    k = tp if case != "none" else 1
    want = {"col": (nb, no // k), "row": (nb // k, no),
            "none": (nb, no)}[case]
    for res in results:
        rep = res[f"{case}:emulator:rep:bytes"]
        got = res[f"{case}:emulator:{mesh}:bytes"]
        assert res[f"{case}:emulator:{mesh}:plan"] == want
        assert rep[0] > 0 and got[0] * k == rep[0] and got[1] * k == rep[1]


def test_sharded_swap_sequence_builds_as_unsharded(world):
    """ideal -> stressed -> aged -> remapped -> params swap through a
    (2, 2) executor: the unsharded executor's builds, each swap changes
    y, every step is the unsharded step bit for bit, and the executor
    caches half the unsharded bytes (the perturbed plan shares the
    state's window)."""
    results, _ = world
    for res in results:
        assert res["builds:2,2"] == res["builds:rep"]
        assert 2 * res["swaps:2,2:bytes"][1] == res["swaps:rep:bytes"][1]
        ys = res["swaps:2,2"]
        for a, b in zip(ys, ys[1:]):
            assert not np.array_equal(a, b)
        for a, b in zip(ys, res["swaps:rep"]):
            np.testing.assert_array_equal(a, b)


def test_deployment_reshards_across_mesh_shapes(world):
    """Saved under (2, 2), loaded under (1, 4): each rank keeps its NO
    window of the saved field and serves the same bits."""
    results, _ = world
    for r, res in enumerate(results):
        assert res["reshard:lattice"] == ("col", 4, r % 4, 1, 8)
        assert res["reshard:gf_is_window"]
        np.testing.assert_array_equal(res["reshard:y2"], res["reshard:y1"])


def test_refresh_states_keeps_the_engine_tokens(world):
    results, _ = world
    for res in results:
        assert res["engine:windows"] and all(
            w == (nb, no // 4) for _, w, (nb, no) in res["engine:windows"])
        for a, b, c in zip(res["engine:rep"], res["engine:before"],
                           res["engine:after"]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(b, c)


# --------------------------------------------------------------------------- #
# The CLI
# --------------------------------------------------------------------------- #
def test_serve_cli_on_a_mesh_gives_the_unsharded_tokens(capsys):
    from repro_torch.launch import serve
    argv = ["--arch", "gemma3-1b", "--reduced", "--layers", "2", "--batch",
            "2", "--prompt-len", "8", "--gen", "4", "--device", "cpu",
            "--analog-backend", "analytic"]
    _, want = serve.main(argv)
    sess, got = serve.main(argv + ["--mesh", "1,2", "--devices", "2"])
    assert sess is None
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["logits"], want["logits"])
    assert [r["coords"] for r in got["ranks"]] == [(0, 0), (0, 1)]
    for r in got["ranks"]:
        assert 2 * r["gf_bytes"] == r["full_gf_bytes"] > 0
    assert "transport gloo" in capsys.readouterr().out


@pytest.mark.parametrize("argv,msg", [
    (["--mesh", "1,2"], "non-digital"),
    (["--mesh", "1,2", "--analog-backend", "analytic", "--devices", "3"],
     "DP*TP"),
    (["--devices", "2", "--analog-backend", "analytic"], "--mesh"),
    (["--mesh", "x", "--analog-backend", "analytic"], "DP,TP")])
def test_serve_cli_refuses_a_malformed_mesh(argv, msg, capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--arch", "gemma3-1b", "--reduced", "--device", "cpu"]
                   + argv)
    assert msg in capsys.readouterr().err
