"""Training on a mesh in the port (``runtime.steps.make_train_step(mesh=)``,
``parallel.train_mesh``, ``Trainer(mesh=)`` / ``remesh``, ``train
--devices/--model-axis``, the sequence-sharded residual and
``sharded_flash_decode``) on the CPU.

The contracts run in ONE world of 4 gloo ranks
(``tests/torch_train_mesh_worker.py``, one intra-op thread each), which
builds the (2, 2), (4, 1) and (1, 4) meshes.  Each rank's results are
held here against the port's replicated step on the same state and
batch, computed in this process: reduced qwen1.5-110b (the reference's
multi-device training script), phi3.5-moe-42b-a6.6b (routing over the
whole batch), recurrentgemma-2b (B6's plain version, forward and
backward), gemma3-1b on the emulator (B1's plain version, the drive
scale over ``data``) and with ``residual_seq_shard``, in float32
compute: loss, gnorm and new params within rtol 1e-4 / atol 1e-5; in
bfloat16 the loss within 1e-2.  Rank 0's qwen step is held against the
JAX package's single-device ``make_train_step`` on the same params.
Then ``sharded_flash_decode`` against the port's and the JAX package's
``decode_attention``, a decode step on a sequence-sharded cache, the
trainer's fault, remesh and restore, and the CLI.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.configs.base import ParallelConfig as RefPcfg  # noqa: E402
from repro.configs.base import TrainConfig as RefTcfg  # noqa: E402
from repro.configs.rram_ps32 import CASE_A as REF_A  # noqa: E402
from repro.data import SyntheticLMData as RefData  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.runtime import steps as RS  # noqa: E402
from repro_torch.interop import emulator_params_from_numpy  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.common import (MeshShape, tree_items,  # noqa: E402
                                       use_dense_hook, window)
from repro_torch.runtime import steps as S  # noqa: E402
from repro_torch.runtime.trainer import Trainer  # noqa: E402
from torch_parity import ref_emulator_params  # noqa: E402
import torch_train_mesh_worker as worker  # noqa: E402

WORLD = 4
RTOL, ATOL = 1e-4, 1e-5
BF16_LOSS = 1e-2
STEP_CASES = [(c, m) for c, *_ in worker.CASES if c != "bf16"
              for m in worker.MESHES]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' results of one 4-rank launch, and the emulator's params."""
    from repro_torch.launch.mesh import launch
    tmp = tmp_path_factory.mktemp("train_mesh")
    npp = ref_emulator_params(REF_A, 0, seed=3)
    np.savez(tmp / "emulator.npz", **npp)
    payload = dict(emulator=str(tmp / "emulator.npz"),
                   ckpt_a=str(tmp / "a"), ckpt_b=str(tmp / "b"))
    results = launch(worker.contracts, WORLD, args=(payload,), device="cpu")
    return results, npp, payload


_REPLICATED = {}


def replicated(case, npp):
    """The port's replicated step of a case (cached): metrics, new params."""
    if case not in _REPLICATED:
        cfg, pcfg, data = worker.case_setup(case)
        st = S.init_train_state(0, cfg, "cpu")
        batch = worker.port_batch(data.batch(0))
        hook = None
        if case == "emulator":
            hook = worker.executor(emulator_params_from_numpy(npp, "cpu")).hook
        step = S.make_train_step(cfg, pcfg, worker.TCFG)
        with use_dense_hook(hook) if hook else worker.nullcontext():
            st, met = step(st, batch)
        _REPLICATED[case] = ({k: float(v) for k, v in met.items()},
                             {k: v.numpy() for k, v in
                              tree_items(st["params"])}, cfg)
    return _REPLICATED[case]


def _specs(cfg):
    return dict(tree_items(S.train_state_schema(cfg)["params"]))


def _mesh_of(m, rank):
    return MeshShape(("data", "model"), m, (rank // m[1], rank % m[1]))


# --------------------------------------------------------------------------- #
# The sharded train step against the replicated one
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case,mesh", STEP_CASES)
def test_sharded_step_equals_the_replicated_step(world, case, mesh):
    """Every rank's loss and gnorm, and its window of the new params,
    within rtol 1e-4 / atol 1e-5 of the replicated step's."""
    results, npp, _ = world
    met, new, cfg = replicated(case, npp)
    specs = _specs(cfg)
    for r, res in enumerate(results):
        got = res[f"{case}:{mesh}"]
        for k in ("loss", "xent", "aux", "gnorm", "lr"):
            np.testing.assert_allclose(got["metrics"][k], met[k], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{k} rank {r}")
        for k, v in got["new"].items():
            w = window(new[k].shape, specs[k].spec, _mesh_of(mesh, r))
            np.testing.assert_allclose(v, new[k][w], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k} rank {r}")


def test_bf16_sharded_step_holds_the_loss(world):
    """bfloat16 compute on (2, 2): the loss within 1e-2 of the replicated
    step's, the new params finite."""
    results, npp, _ = world
    met, _, _ = replicated("bf16", npp)
    for res in results:
        got = res["bf16:(2, 2)"]
        assert abs(got["metrics"]["loss"] - met["loss"]) <= BF16_LOSS
        assert all(np.isfinite(v).all() for v in got["new"].values())


@pytest.mark.parametrize("mesh", worker.MESHES)
def test_windows_tile_the_state_and_hold_the_unsharded_init(world, mesh):
    """Each rank's init windows are the unsharded init's values there, bit
    for bit, and the ranks' windows of every leaf tile it: each element
    is held by world / (the leaf's shards) ranks, each shard by the same
    number; a leaf whose spec divides both axes is 1/(dp * tp) of it."""
    results, npp, _ = world
    cfg, _, _ = worker.case_setup("qwen")
    full = {k: v.numpy() for k, v in
            tree_items(S.init_train_state(0, cfg, "cpu")["params"])}
    specs = _specs(cfg)
    for k, v in full.items():
        count = np.zeros(v.shape, np.int64)
        for r, res in enumerate(results):
            w = window(v.shape, specs[k].spec, _mesh_of(mesh, r))
            np.testing.assert_array_equal(res[f"qwen:{mesh}"]["init"][k],
                                          v[w], err_msg=k)
            count[w] += 1
        assert count.min() == count.max() >= 1, k
        shards = WORLD // count.max()
        assert res[f"qwen:{mesh}"]["init"][k].size * shards == v.size, k
    emb = results[0][f"qwen:{mesh}"]["init"]["['embed']"]
    assert emb.size * WORLD == full["['embed']"].size


def test_a_rank_step_matches_the_jax_reference(world):
    """Rank 0's qwen step on (2, 2) against the JAX package's single-device
    ``make_train_step`` from the same params and batch: loss, xent and
    gnorm within rtol 1e-5, rank 0's window of the new params within 2 lr
    (Adam's first step moves a param by about lr * sign(g)) and within
    rtol 1e-4 / atol 1e-5 where the reference's update is larger than
    lr / 2."""
    results, _, _ = world
    cfg, _, _ = worker.case_setup("qwen")
    rcfg = ref_reduced(ref_get_config("qwen1.5-110b"))
    init = {k: v.numpy() for k, v in
            tree_items(S.init_train_state(0, cfg, "cpu")["params"])}
    rstate = RS.init_train_state(jax.random.PRNGKey(0), rcfg)
    flat, treedef = jax.tree_util.tree_flatten_with_path(rstate["params"])
    rstate["params"] = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(init[jax.tree_util.keystr(p)]) for p, _ in flat])
    rstate["opt"] = jax.tree.map(jnp.zeros_like, rstate["opt"])
    batch = RefData(rcfg, worker.SEQ, worker.B).batch(0)
    rp = RefPcfg(compute_dtype="float32", attn_block_kv=16, xent_chunk=16,
                 scan_chunk=8)
    new, met = jax.jit(RS.make_train_step(
        rcfg, rp, RefTcfg(lr=worker.LR, warmup_steps=2)))(
        rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    got = results[0]["qwen:(2, 2)"]
    for k in ("loss", "xent", "gnorm"):
        np.testing.assert_allclose(got["metrics"][k], float(met[k]),
                                   rtol=1e-5, err_msg=k)
    specs = _specs(cfg)
    rnew = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(new["params"])[0]}
    for k, v in got["new"].items():
        w = window(init[k].shape, specs[k].spec, _mesh_of((2, 2), 0))
        want, before = rnew[k][w], init[k][w]
        assert np.all(np.abs(v - want) <= 2 * worker.LR), k
        big = np.abs(want - before) > worker.LR / 2
        np.testing.assert_allclose(v[big], want[big], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("mesh", worker.MESHES)
def test_residual_stream_is_sequence_sharded(world, mesh):
    """Under ``residual_seq_shard`` a layer's residual input is (B_loc,
    S/tp, D) on every rank of a model axis (the whole stream on (4, 1),
    whose model axis is 1)."""
    results, _, _ = world
    cfg, _, _ = worker.case_setup("seq")
    dp, tp = mesh
    want = (worker.B // dp, worker.SEQ // tp, cfg.d_model)
    for res in results:
        seen = res[f"seq:{mesh}"]["residual"]
        assert seen and all(s == (want, tp > 1) for s in seen), seen


@pytest.mark.parametrize("mesh", worker.MESHES)
def test_emulator_step_runs_b1_on_every_rank(world, mesh):
    """The emulator case ran its MLP sites through the executor on every
    rank, once each as the replicated step does (3 sites x 2 layers, both
    in the unrematerialized tail)."""
    results, _, _ = world
    for res in results:
        assert res[f"emulator:{mesh}"]["calls"] == 6


# --------------------------------------------------------------------------- #
# Sharded flash-decode
# --------------------------------------------------------------------------- #
def _decode_want():
    cfg, q, ck, cv = worker.decode_inputs()
    valid = torch.arange(worker.DECODE["S_max"]) <= worker.DECODE["pos"]
    port = A.decode_attention(q, ck, cv, valid, cfg).numpy()
    rcfg = ref_reduced(ref_get_config("gemma3-1b"))
    ref = np.asarray(RA.decode_attention(
        jnp.asarray(q.numpy()), jnp.asarray(ck.numpy()),
        jnp.asarray(cv.numpy()), jnp.asarray(valid.numpy()), rcfg))
    return port, ref


@pytest.mark.parametrize("mesh", worker.MESHES)
def test_sharded_flash_decode_matches_decode_attention(world, mesh):
    """Each rank's combine of the partial softmaxes within rtol 1e-5 /
    atol 1e-6 of the port's and the JAX package's ``decode_attention``
    over the whole cache."""
    results, _, _ = world
    port, ref = _decode_want()
    for res in results:
        np.testing.assert_allclose(res[f"flash:{mesh}"], port, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(res[f"flash:{mesh}"], ref, rtol=1e-5,
                                   atol=1e-6)


def test_decode_step_on_a_sequence_sharded_cache(world):
    """A decode step with ``decode_seq_shard`` on (1, 4) -- each rank a
    quarter of the global layer's cache, the new key written by the rank
    that holds its slot -- within rtol 1e-4 / atol 1e-5 of the unsharded
    step's logits on the whole cache."""
    results, _, _ = world
    cfg = worker.reduced(worker.get_config("gemma3-1b"))
    params = S.init_model_params(0, cfg, "cpu")
    cache = worker.seeded_cache(cfg)
    pcfg = worker.ParallelConfig(compute_dtype="float32")
    want, _ = M.decode_step(params, torch.tensor([[3], [250]]), cache,
                            worker.DECODE["pos"], cfg=cfg, pcfg=pcfg,
                            compute_dtype=torch.float32)
    for res in results:
        np.testing.assert_allclose(res["decode"], want.numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_sharded_flash_decode_without_a_mesh_is_decode_attention():
    cfg, q, ck, cv = worker.decode_inputs()
    port, _ = _decode_want()
    np.testing.assert_array_equal(
        A.sharded_flash_decode(q, ck, cv, worker.DECODE["pos"], cfg).numpy(),
        port)


# --------------------------------------------------------------------------- #
# The trainer on a mesh
# --------------------------------------------------------------------------- #
def test_trainer_recovers_on_every_rank_and_remeshes(world):
    """A SimulatedFailure on every rank at step 3 restores the step-2
    checkpoint and replays step 2 to the same loss; ``remesh`` onto (4, 1)
    continues at step 4 within 0.8 of the last loss (the reference's
    continuity check) and equal (rtol 1e-4) to the uninterrupted (2, 2)
    run's steps 4 and 5; every rank logs the same metrics."""
    results, _, _ = world
    tr = results[0]["trainer"]
    s1, s2, s3 = tr["summaries"]
    assert s1["final_step"] == worker.TRAIN["steps"] and s1["restarts"] == 1
    assert s2["final_step"] == worker.TRAIN["more"] and s2["restarts"] == 0
    steps = [s for s, _, _ in tr["faulted"]]
    assert steps == [0, 1, 2, 2, 3]
    np.testing.assert_allclose(tr["faulted"][2][1], tr["faulted"][3][1],
                               rtol=1e-6)
    assert tr["remeshed"][0][0] == worker.TRAIN["steps"]
    assert abs(tr["remeshed"][0][1] - tr["faulted"][-1][1]) < 0.8
    unint = {s: (l, g) for s, l, g in tr["uninterrupted"]}
    for s, l, g in tr["remeshed"][:2]:
        np.testing.assert_allclose(l, unint[s][0], rtol=RTOL, err_msg=str(s))
        np.testing.assert_allclose(g, unint[s][1], rtol=RTOL, err_msg=str(s))
    assert tr["steps_a"][-1] == worker.TRAIN["more"]
    assert tr["steps_b"] == [2, 4, 6]
    for res in results[1:]:
        assert res["trainer"]["remeshed"] == tr["remeshed"]
        assert res["trainer"]["uninterrupted"] == tr["uninterrupted"]


def test_a_mesh_checkpoint_restores_into_an_unsharded_trainer(world):
    """The uninterrupted (2, 2) run's step-6 checkpoint restored by a
    trainer without a mesh: its step 6 within rtol 1e-4 of the remeshed
    (4, 1) run's step 6 (both from step-6 states of the same run)."""
    results, _, payload = world
    cfg, pcfg, data = worker.case_setup("qwen")
    tcfg = worker.TrainConfig(lr=worker.LR, warmup_steps=2,
                              total_steps=worker.TRAIN["more"],
                              checkpoint_every=worker.TRAIN["every"],
                              keep_checkpoints=3)
    tr = Trainer(cfg=cfg, pcfg=pcfg, tcfg=tcfg, mesh=None, data=data,
                 ckpt_dir=payload["ckpt_b"], device="cpu")
    tr.run(worker.TRAIN["more"])
    assert [r["step"] for r in tr.metrics_log] == [6]
    want = {s: l for s, l, _ in results[0]["trainer"]["remeshed"]}
    np.testing.assert_allclose(tr.metrics_log[0]["loss"], want[6], rtol=RTOL)


def test_trainer_refuses_a_mesh_that_is_not_a_device_mesh(tmp_path):
    cfg, pcfg, data = worker.case_setup("qwen")
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(cfg=cfg, pcfg=pcfg, tcfg=worker.TCFG, mesh=object(),
                data=data, ckpt_dir=str(tmp_path), device="cpu")


# --------------------------------------------------------------------------- #
# The CLI
# --------------------------------------------------------------------------- #
def test_train_cli_on_a_mesh_prints_the_summary(tmp_path, capsys):
    from repro_torch.launch import train
    trainer, summary = train.main([
        "--arch", "gemma3-1b", "--reduced", "--device", "cpu", "--steps",
        "3", "--seq-len", "16", "--global-batch", "4", "--devices", "4",
        "--model-axis", "2", "--ckpt-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert trainer is None
    assert "SUMMARY:" in out and "transport gloo" in out
    assert summary["final_step"] == 3 and np.isfinite(summary["final_loss"])
    assert (tmp_path / "ckpt" / "step_00000003").is_dir()


@pytest.mark.parametrize("argv,msg", [
    (["--devices", "4", "--model-axis", "3"], "does not divide"),
    (["--model-axis", "2"], "needs --devices")])
def test_train_cli_refuses_a_model_axis_that_does_not_divide(argv, msg,
                                                            capsys):
    from repro_torch.launch import train
    with pytest.raises(SystemExit):
        train.main(["--arch", "gemma3-1b", "--reduced", "--device", "cpu"]
                   + argv)
    assert msg in capsys.readouterr().err
