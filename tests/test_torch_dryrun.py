"""The port's placements and dry run (``models.common`` specs and
``window``, ``runtime.steps.abstract_train_state(cfg, mesh)``,
``launch.mesh.make_production_mesh``, ``launch.dryrun``) against the JAX
package, on the CPU.

The reference's shardings need a jax mesh of that many devices, and its
dry-run module sets ``XLA_FLAGS`` when imported, so the comparison runs
in ONE ``run_multidevice`` subprocess with 256 host devices and no
compile: every train-state leaf's window shape equals the reference's
``abstract_train_state(cfg, mesh)`` leaf's ``sharding.shard_shape`` on a
(4, 2) mesh for every reduced arch, and for gemma3-1b at full width on
the 256-device production mesh; the port's ``default_pcfg`` equals the
reference's for every arch x shape x mesh.  The configs' counts and the
dry run's records are checked here.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from conftest import REPO_ROOT, run_multidevice  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import ParallelConfig as RefPcfg  # noqa: E402
from repro_torch.configs import (ARCH_NAMES, SHAPES,  # noqa: E402
                                 SHAPES_BY_NAME, get_config)
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models.common import (P, MeshShape, sanitize_spec,  # noqa: E402
                                       shard_shape, window)

PLACEMENT_SCRIPT = r"""
import dataclasses, json
import numpy as np
import jax
devs = jax.devices()
assert len(devs) >= 256, len(devs)
from jax.sharding import Mesh
import repro.launch.dryrun as rdry        # sets XLA_FLAGS: jax is up already
from repro.configs import ARCH_NAMES as RARCHS, SHAPES_BY_NAME as RSHAPES
from repro.configs import get_config as rget, reduced as rred
from repro.models.common import use_mesh
from repro.runtime import steps as RS
from repro_torch.configs import SHAPES_BY_NAME, get_config, reduced
from repro_torch.configs.base import ParallelConfig
from repro_torch.launch import dryrun as pdry
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.common import MeshShape, tree_items
from repro_torch.runtime import steps as S


def ref_windows(rcfg, mesh):
    with use_mesh(mesh):
        st = RS.abstract_train_state(rcfg, mesh)
    return {jax.tree_util.keystr(p): tuple(a.sharding.shard_shape(a.shape))
            for p, a in jax.tree_util.tree_flatten_with_path(st)[0]}


def port_windows(cfg, mesh):
    return {k: tuple(v.shape)
            for k, v in tree_items(S.abstract_train_state(cfg, mesh))}


bad, leaves = [], 0
m42 = Mesh(np.array(devs[:8]).reshape(4, 2), ("data", "model"))
cells = [(rred(rget(a)), reduced(get_config(a)), m42,
          MeshShape(("data", "model"), (4, 2))) for a in RARCHS]
cells.append((rget("gemma3-1b"), get_config("gemma3-1b"),
              Mesh(np.array(devs[:256]).reshape(16, 16), ("data", "model")),
              make_production_mesh()))
for rcfg, cfg, rmesh, pmesh in cells:
    r, p = ref_windows(rcfg, rmesh), port_windows(cfg, pmesh)
    if sorted(r) != sorted(p):
        bad.append([cfg.name, "keys", sorted(set(r) ^ set(p))])
    for k in r:
        leaves += 1
        if r[k] != p.get(k):
            bad.append([cfg.name, k, r[k], p.get(k)])
fields = [f.name for f in dataclasses.fields(ParallelConfig)]
n_pcfg = 0
for a in RARCHS:
    for s in RSHAPES:
        for mesh_name in ("single", "multi"):
            want = rdry.default_pcfg(rget(a), RSHAPES[s], mesh_name)
            got = pdry.default_pcfg(get_config(a), SHAPES_BY_NAME[s],
                                    mesh_name)
            n_pcfg += 1
            for f in fields:
                if getattr(want, f) != getattr(got, f):
                    bad.append([a, s, mesh_name, f, str(getattr(want, f)),
                                str(getattr(got, f))])
print("RESULT " + json.dumps({"bad": bad, "leaves": leaves,
                              "pcfg": n_pcfg}))
"""


def test_placements_and_default_pcfg_match_the_reference():
    """One subprocess: window shapes of every train-state leaf against the
    reference's shard shapes ((4, 2) for every reduced arch; gemma3-1b's
    train state on the (16, 16) production mesh), and ``default_pcfg``
    for every arch x shape x mesh."""
    out = run_multidevice(PLACEMENT_SCRIPT, n_devices=256, timeout=600)
    res = json.loads(next(line for line in out.splitlines()
                          if line.startswith("RESULT "))[len("RESULT "):])
    assert res["bad"] == []
    assert res["leaves"] > 500
    assert res["pcfg"] == len(ARCH_NAMES) * len(SHAPES) * 2


# --------------------------------------------------------------------------- #
# Configs and pure placement math
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_config_counts_and_shapes_match_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    assert cfg.sub_quadratic == rcfg.sub_quadratic
    for s, rs in zip(SHAPES, REF_SHAPES):
        assert (s.name, s.seq_len, s.global_batch, s.mode) == (
            rs.name, rs.seq_len, rs.global_batch, rs.mode)
        assert cfg.supports_shape(s) == rcfg.supports_shape(rs)


def test_parallel_config_has_the_reference_fields_and_defaults():
    """Every field of the reference's ParallelConfig but the scan knobs
    (the port's period loop and recurrence have none), same defaults."""
    ref = {f.name: f.default for f in dataclasses.fields(RefPcfg)}
    got = {f.name: f.default for f in dataclasses.fields(ParallelConfig)}
    assert set(ref) - set(got) == {"scan_layers", "scan_chunk"}
    assert set(got) <= set(ref)
    for k, v in got.items():
        assert ref[k] == v, k


def test_sanitize_and_window_follow_the_reference_rule():
    """An absent axis or one that does not divide leaves the dim
    replicated; a tuple entry splits over the product, the first axis
    major; windows of a leaf tile it."""
    mesh = MeshShape(("pod", "data", "model"), (2, 4, 3))
    assert sanitize_spec((8, 6), P("data", "model"), mesh) == P("data", "model")
    assert sanitize_spec((8, 5), P("data", "model"), mesh) == P("data")
    assert sanitize_spec((8, 6), P("fsdp", "model"), mesh) == P(None, "model")
    assert sanitize_spec((16, 6), P(("pod", "data"),), mesh) == P(("pod",
                                                                   "data"))
    assert sanitize_spec((4, 6), P(("pod", "data"),), mesh) == P()
    assert shard_shape((16, 6, 5), P(("pod", "data"), "model"), mesh) == (
        2, 2, 5)
    seen = set()
    for p in range(2):
        for d in range(4):
            w = window((16, 6), P(("pod", "data"), None),
                       mesh._replace(coords=(p, d, 0)))
            assert w[0] == slice((p * 4 + d) * 2, (p * 4 + d + 1) * 2)
            seen.add(w[0].start)
    assert seen == set(range(0, 16, 2))
    assert sanitize_spec((8, 6), P("data", "model"), None) == P()


def test_production_meshes():
    assert make_production_mesh() == MeshShape(("data", "model"), (16, 16))
    m = make_production_mesh(multi_pod=True)
    assert (m.mesh_dim_names, m.shape) == (("pod", "data", "model"),
                                           (2, 16, 16))


# --------------------------------------------------------------------------- #
# The dry run
# --------------------------------------------------------------------------- #
DRYRUN_SCRIPT = r"""
import json, resource, sys
from repro_torch.launch import dryrun
dryrun.RESULTS_DIR = sys.argv[1]
dryrun.main(["--arch", "gemma3-1b", "--shape", "train_4k"])
print("MAXRSS_KB", resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
"""


def test_dryrun_cli_writes_its_record_without_allocating(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch gemma3-1b --shape
    train_4k``'s record: a device's bytes of params, m and v are its
    windows' (every matrix divides both axes: 1/256 of the whole but
    the replicated norms), the FLOPs
    counted on meta tensors and at least the 6 N tokens formula's; the
    process peaks far below the 12 GB the state would take."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", DRYRUN_SCRIPT, str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=600,
                       cwd=REPO_ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[OK]   gemma3-1b x train_4k x single" in r.stdout
    rss_kb = int(r.stdout.split("MAXRSS_KB")[1].split()[0])
    assert rss_kb * 1024 < 3e9
    rec = json.loads((tmp_path / "gemma3-1b_train_4k_single.json").read_text())
    cfg = get_config("gemma3-1b")
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert rec["pcfg"]["residual_seq_shard"] is True
    mem = rec["memory"]
    assert mem["params"] == mem["opt_m"] == mem["opt_v"]
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_leaves
    leaves = tree_leaves(M.model_schema(cfg))
    whole = sum(4 * _numel(p.shape) for p in leaves)
    mine = sum(4 * _numel(shard_shape(p.shape, p.spec, make_production_mesh()))
               for p in leaves)
    assert mem["params"] == mine
    # every matrix divides both axes; the norms' weights are replicated
    assert whole / 256 <= mine < 1.05 * whole / 256
    assert rec["flops"]["source"].startswith("FlopCounterMode")
    assert rec["flops"]["per_device"] * 256 >= dryrun.formula_flops(
        cfg, SHAPES_BY_NAME["train_4k"])


def _numel(shape):
    n = 1
    for d in shape:
        n *= d
    return n


def test_dryrun_skips_what_the_reference_skips(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    rec = dryrun.run_cell("qwen1.5-110b", "long_500k", False)
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]
    assert json.loads((tmp_path / "qwen1.5-110b_long_500k_single.json")
                      .read_text())["status"] == "skipped"


def test_dryrun_falls_back_to_the_formula_where_meta_does_not_run():
    """recurrentgemma-2b's prefill recurrence (the linear-scan entry point
    takes CUDA or CPU tensors) does not run on meta: its FLOPs come from
    the model-FLOPs formula, and the record says so."""
    cfg, shape = get_config("recurrentgemma-2b"), SHAPES_BY_NAME["prefill_32k"]
    pcfg = dryrun.default_pcfg(cfg, shape, "single")
    fl = dryrun.step_flops(cfg, shape, pcfg)
    assert fl["source"].startswith("model-FLOPs formula")
    assert fl["step"] == dryrun.formula_flops(cfg, shape)
    assert "meta_error" in fl
