"""The fault-tolerant trainer, the checkpoint manager and the training CLI
of the port, on the CPU: the reference's ``tests/test_substrates.py``
trainer and checkpoint cases on reduced deepseek-coder-33b (the same
configs, steps and assertions), checkpoints crossing between the two
packages in both directions (arrays bit-equal), and ``launch.train``
with ``--reduced --device cpu``."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as RefManager  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.runtime import steps as RS  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.runtime import steps as S  # noqa: E402
from repro_torch.runtime.trainer import (SimulatedFailure,  # noqa: E402
                                         StragglerMonitor, Trainer)
from torch_parity import to_np, tree_np  # noqa: E402

PCFG = ParallelConfig(attn_block_kv=32, xent_chunk=32)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Many small ops: beside the suite's other worker processes, more
    intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_trainer(tmp_path, fault_hook=None, steps_total=30):
    cfg = reduced(get_config("deepseek-coder-33b"))
    tcfg = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=steps_total,
                       checkpoint_every=5, keep_checkpoints=2)
    data = SyntheticLMData(cfg, seq_len=32, global_batch=4)
    return Trainer(cfg=cfg, pcfg=PCFG, tcfg=tcfg, mesh=None, data=data,
                   ckpt_dir=str(tmp_path / "ckpt"), fault_hook=fault_hook,
                   device="cpu")


def _equal_trees(a, b):
    fa, fb = dict(tree_items(a)), dict(tree_items(b))
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(to_np(fa[k]), to_np(fb[k]), err_msg=k)


# --------------------------------------------------------------------------- #
# Checkpoint manager
# --------------------------------------------------------------------------- #
def test_checkpoint_roundtrip(tmp_path):
    cfg = reduced(get_config("gemma3-1b"))
    state = S.init_train_state(0, cfg, "cpu")
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    mgr.save(state, 7)
    restored, step = mgr.restore(S.abstract_train_state(cfg), device="cpu")
    assert step == 7
    assert restored["step"].dtype == torch.int32
    _equal_trees(state, restored)
    # a template of real tensors lands each leaf on its dtype and device
    again, _ = mgr.restore(state)
    _equal_trees(state, again)


def test_checkpoint_keep_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    state = {"w": torch.ones(4)}
    for s in (1, 2, 3, 4):
        mgr.save(state, s)
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    state = {"w": torch.arange(8.0)}
    mgr.save(state, 1)
    mgr.wait()
    assert mgr.latest_step() == 1
    got, _ = mgr.restore({"w": torch.empty(8, device="meta")}, device="cpu")
    assert torch.equal(got["w"], state["w"])


def test_async_checkpoint_holds_the_state_of_its_step(tmp_path,
                                                     monkeypatch):
    """An async save of step s whose write is still running while the
    next train step updates the state in place: the checkpoint holds the
    state of step s, bit for bit (a host copy that shared the tensors'
    memory would hold step s+1's, or a mix)."""
    import repro_torch.checkpoint.manager as mgr
    import time
    real = mgr.np.savez

    def slow_savez(*args, **kw):
        time.sleep(0.5)
        return real(*args, **kw)

    monkeypatch.setattr(mgr.np, "savez", slow_savez)
    cfg = reduced(get_config("deepseek-coder-33b"))
    tcfg = TrainConfig(lr=1e-3, warmup_steps=2)
    data = SyntheticLMData(cfg, seq_len=32, global_batch=4)
    step = S.make_train_step(cfg, PCFG, tcfg)

    def batch(t):
        return {k: torch.from_numpy(v).long() if k != "mask"
                else torch.from_numpy(v) for k, v in data.batch(t).items()}

    state, _ = step(S.init_train_state(0, cfg, "cpu"), batch(0))
    at_save = {k: v.clone() for k, v in tree_items(state)}
    ckpt = CheckpointManager(str(tmp_path), async_save=True)
    ckpt.save(state, 1)
    state, _ = step(state, batch(1))           # in place, during the write
    assert not torch.equal(state["params"]["embed"],
                           at_save["['params']['embed']"])
    restored, at = ckpt.restore(S.abstract_train_state(cfg), device="cpu")
    assert at == 1
    for k, v in tree_items(restored):
        assert torch.equal(v, at_save[k]), k


@pytest.mark.parametrize("knob", [{"grad_compression": "int8"},
                                  {"param_dtype": "bfloat16"}])
def test_unported_parallel_knobs_raise(knob):
    """Values no step of the reference reads raise, naming the queue item
    that struck their wiring (ROADMAP A11), instead of silently changing
    nothing."""
    with pytest.raises(NotImplementedError, match="A11"):
        ParallelConfig(**knob)


# --------------------------------------------------------------------------- #
# Trainer: loss goes down; failure injection recovers from checkpoint
# --------------------------------------------------------------------------- #
def test_trainer_loss_decreases(tmp_path):
    tr = small_trainer(tmp_path)
    summary = tr.run(30)
    assert summary["final_step"] == 30
    losses = [m["loss"] for m in tr.metrics_log]
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert tr.builds == 1


def test_trainer_failure_recovery(tmp_path):
    fails = {"armed": True}

    def hook(step):
        if step == 12 and fails["armed"]:
            fails["armed"] = False
            raise SimulatedFailure("node died")

    tr = small_trainer(tmp_path, fault_hook=hook)
    summary = tr.run(20)
    assert summary["final_step"] == 20
    assert summary["restarts"] == 1
    # recovery resumed from the last checkpoint (step 10), so step 10 and 11
    # were re-executed -> metrics log contains duplicates of step >= 10
    steps = [m["step"] for m in tr.metrics_log]
    assert steps.count(11) == 2
    assert tr.builds == 1


def test_trainer_recovers_from_a_save_still_being_written(tmp_path,
                                                          monkeypatch):
    """A failure right after a checkpoint whose async write is slow (as a
    multi-GB state's is): the recovery waits for that write and resumes
    from it, not from an older checkpoint or step 0."""
    import repro_torch.checkpoint.manager as mgr
    import time
    real = mgr.np.savez

    def slow_savez(*args, **kw):
        time.sleep(0.5)
        return real(*args, **kw)

    monkeypatch.setattr(mgr.np, "savez", slow_savez)
    fails = {"armed": True}

    def hook(step):
        if step == 5 and fails["armed"]:
            fails["armed"] = False
            raise SimulatedFailure("node died")

    tr = small_trainer(tmp_path, fault_hook=hook)
    summary = tr.run(7)
    assert summary["restarts"] == 1 and summary["final_step"] == 7
    assert [m["step"] for m in tr.metrics_log] == [0, 1, 2, 3, 4, 5, 6]


def test_trainer_resume_across_instances(tmp_path):
    tr = small_trainer(tmp_path)
    tr.run(10)
    tr2 = small_trainer(tmp_path)           # fresh process, same ckpt dir
    summary = tr2.run(15)
    assert summary["final_step"] == 15
    assert tr2.metrics_log[0]["step"] == 10  # resumed, not restarted


def test_trainer_mesh_and_remesh_raise(tmp_path):
    """A mesh is a ``DeviceMesh`` (training on one is
    ``tests/test_torch_train_mesh.py``'s): anything else raises, at
    construction and through ``remesh``; ``remesh(None)`` is a trainer
    without a mesh on the same checkpoints."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(cfg=reduced(get_config("gemma3-1b")), pcfg=PCFG,
                tcfg=TrainConfig(), mesh=object(), data=None,
                ckpt_dir=str(tmp_path), device="cpu")
    tr = small_trainer(tmp_path)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tr.remesh(object())
    tr2 = tr.remesh(None)
    assert tr2.mesh is None and tr2.ckpt_dir == tr.ckpt_dir


# --------------------------------------------------------------------------- #
# Straggler monitor
# --------------------------------------------------------------------------- #
def test_straggler_monitor_flags_outlier():
    mon = StragglerMonitor()
    for i in range(20):
        assert not mon.observe(i, 0.1 + 0.001 * (i % 3))
    assert mon.observe(20, 0.5)
    assert len(mon.events) == 1


def test_straggler_monitor_adapts():
    mon = StragglerMonitor()
    for i in range(10):
        mon.observe(i, 0.1)
    # a persistent slowdown stops being an outlier once the EMA adapts
    flags = [mon.observe(10 + i, 0.3) for i in range(20)]
    assert flags[0] is True
    assert not any(flags[-5:])


# --------------------------------------------------------------------------- #
# Checkpoints across the two packages
# --------------------------------------------------------------------------- #
def test_reference_checkpoint_restored_and_continued(tmp_path):
    """The reference's train state saved by its manager at step 5: the
    port restores it bit for bit (same keys, ``step`` int32) and its
    trainer continues from step 5."""
    rcfg = ref_reduced(ref_get_config("deepseek-coder-33b"))
    rstate = RS.init_train_state(jax.random.PRNGKey(2), rcfg)
    rstate["step"] = jnp.asarray(5, jnp.int32)
    RefManager(str(tmp_path / "ckpt"), async_save=False).save(rstate, 5)
    tr = small_trainer(tmp_path)
    state, step = tr.ckpt.restore(S.abstract_train_state(tr.cfg),
                                  device="cpu")
    assert step == 5 and int(state["step"]) == 5
    _equal_trees(state, tree_np(rstate))
    summary = tr.run(7)
    assert summary["final_step"] == 7
    assert [m["step"] for m in tr.metrics_log] == [5, 6]
    assert np.isfinite(summary["final_loss"])


def test_port_checkpoint_restored_by_reference(tmp_path):
    """The port's trainer state after 3 steps, restored by the reference's
    manager into its abstract train state: bit-equal, every key found."""
    tr = small_trainer(tmp_path)
    tr.run(3)                        # the last step is always saved
    rcfg = ref_reduced(ref_get_config("deepseek-coder-33b"))
    abstract = RS.abstract_train_state(rcfg, None)
    rstate, step = RefManager(str(tmp_path / "ckpt")).restore(abstract)
    assert step == 3 and int(rstate["step"]) == 3
    state, _ = tr.ckpt.restore(S.abstract_train_state(tr.cfg), device="cpu")
    _equal_trees(state, tree_np(rstate))
    with open(tmp_path / "ckpt" / "step_00000003" / "MANIFEST.json") as f:
        man = json.load(f)
    assert "['params']['embed']" in man["keys"]
    assert man["dtypes"]["['step']"] == "int32"


# --------------------------------------------------------------------------- #
# The CLI
# --------------------------------------------------------------------------- #
def test_train_cli_reduced_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    log = tmp_path / "log.jsonl"
    trainer, summary = train.main([
        "--arch", "gemma3-1b", "--reduced", "--device", "cpu", "--steps",
        "12", "--seq-len", "32", "--global-batch", "4", "--ckpt-dir",
        str(tmp_path / "ckpt"), "--log", str(log), "--lr", "1e-3"])
    out = capsys.readouterr().out
    assert "SUMMARY:" in out and "loss first10" in out
    assert summary["final_step"] == 12 and summary["restarts"] == 0
    assert len(log.read_text().splitlines()) == 12
    assert trainer.ckpt.all_steps() == [10, 12]
    assert os.path.isdir(tmp_path / "ckpt" / "step_00000012")
    base = ["--arch", "gemma3-1b", "--reduced", "--device", "cpu"]
    for flag in (["--devices", "3", "--model-axis", "2"],
                 ["--model-axis", "2"]):
        with pytest.raises(SystemExit):
            train.main(base + flag)
