"""The port's block-size autotuner (``repro_torch.kernels.autotune``) and
its use by B1's dispatcher, on the CPU.

The lifecycle mirrors the reference's ``tests/test_kernels.py::
test_autotune_cache_and_report`` (sweep, memory hit, disk hit in a
"fresh process", the caller's default when disabled, losing candidates);
the disk file is read by the reference's own loader.  The dispatcher
sweeps the plain version's row chunk on the CPU: its output is the same
bits under every chunk candidate (and, where the dispatcher picks one,
under the tuned one)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import autotune as ref_autotune  # noqa: E402
from repro_torch.configs.base import AnalogConfig  # noqa: E402
from repro_torch.configs.rram_ps32 import CASE_A, CASE_B  # noqa: E402
from repro_torch.core import conv4xbar  # noqa: E402
from repro_torch.core.analog import AnalogExecutor  # noqa: E402
from repro_torch.interop import emulator_params_from_numpy  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels.emulator_block import ops  # noqa: E402
from repro_torch.obs import OBS, snapshot  # noqa: E402
from torch_parity import ref_emulator_params  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    autotune.clear()
    yield
    autotune.clear()
    torch.set_num_threads(n)


def test_autotune_cache_and_report(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    calls = []

    def measure(cfg):
        calls.append(cfg["b"])
        if cfg["b"] == 8:
            raise ValueError("refused")           # a losing candidate

    cands = [{"b": b} for b in (4, 8)]
    cfg = autotune.best_config("k", (1, 2), cands, measure, {"b": 16})
    assert cfg["b"] == 4 and 8 in calls
    rep = autotune.report()["k"]
    assert rep["source"] == "swept" and list(rep["ms"]) == ['{"b": 4}']
    assert rep["key"] == "k|torch:cpu|1|2"
    calls.clear()
    assert autotune.best_config("k", (1, 2), cands, measure, {"b": 16}) == cfg
    assert not calls and autotune.report()["k"]["source"] == "memory"
    autotune.clear()                              # "new process"
    assert autotune.best_config("k", (1, 2), cands, measure, {"b": 16}) == cfg
    assert not calls and autotune.report()["k"]["source"] == "disk"
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    autotune.clear(disk=True)
    assert autotune.best_config("k", (1, 2), cands, measure,
                                {"b": 16}) == {"b": 16}
    assert not calls and autotune.report()["k"]["source"] == "default"


def test_disk_format_is_the_references(tmp_path, monkeypatch):
    """The file holds the reference's version-1 document: its loader reads
    the port's entries (keys namespaced by torch and the device)."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    autotune.best_config("k", (3,), [{"b": 2}], lambda cfg: None, {"b": 1})
    doc = json.loads((tmp_path / "at.json").read_text())
    assert doc == {"version": 1, "entries": {"k|torch:cpu|3": {"b": 2}}}
    assert ref_autotune._load_disk() == doc["entries"]


@pytest.mark.parametrize("env,device,want", [
    (None, "cpu", False), (None, "cuda", True), ("1", "cpu", True),
    ("0", "cuda", False), ("false", "cuda", False), ("", "cuda", False)])
def test_sweeping_is_on_where_the_kernels_run(env, device, want,
                                              monkeypatch):
    if env is None:
        monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    else:
        monkeypatch.setenv("REPRO_AUTOTUNE", env)
    assert autotune.enabled(torch.device(device)) is want


@pytest.mark.parametrize("var,value,want", [
    ("REPRO_AUTOTUNE_CACHE", "/x/y.json", "/x/y.json"),
    ("REPRO_CACHE_DIR", "/c", "/c/autotune.json"),
    ("XDG_CACHE_HOME", "/h", "/h/repro/autotune.json")])
def test_cache_path_resolution(var, value, want, monkeypatch):
    for v in ("REPRO_AUTOTUNE_CACHE", "REPRO_CACHE_DIR", "XDG_CACHE_HOME"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv(var, value)
    assert autotune.cache_path() == want == ref_autotune.cache_path()


def test_telemetry_at_the_references_names(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    OBS.reset()
    OBS.enable()
    try:
        autotune.best_config("k", (5,), [{"b": 2}], lambda cfg: None, {"b": 1})
        autotune.best_config("k", (5,), [{"b": 2}], lambda cfg: None, {"b": 1})
        snap = json.dumps(snapshot())
    finally:
        OBS.reset()
        OBS.disable()
    for name in ("autotune_resolutions_total", "autotune_sweep_seconds",
                 "autotune_cache_path_info"):
        assert name in snap
    assert '"swept"' in snap and '"memory"' in snap


def _b1_inputs(geom, npf, M, K, N, shift, seed=0):
    params = emulator_params_from_numpy(ref_emulator_params(geom, npf, seed),
                                        device="cpu")
    aux = conv4xbar.blocklast_weights(params, geom)
    ex = AnalogExecutor(AnalogConfig(backend="emulator"), geom=geom,
                        emulator_params=params)
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.2)
                         .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    plan = ex._plan_for(w, "t")
    xs = x.abs().max()
    u = plan.tile_v(ex._drive01(x.abs() / xs), 1.0).contiguous()
    pos = plan.tile_v((x > 0).float(), 1.0).contiguous()
    sh = None
    if shift:
        f = aux["fcs"][0][0].shape[1]
        shp = (f,) if shift == "flat" else (plan.n_blocks, f)
        sh = torch.from_numpy((rng.standard_normal(shp) * 0.2)
                              .astype(np.float32))
    return aux, plan.g_norm.contiguous(), u, pos, sh


@pytest.mark.parametrize("geom,npf,M,K,N,shift,dt", [
    (CASE_A, 0, 5, 300, 3, None, torch.float32),
    (CASE_A, 15, 9, 200, 4, "block", torch.float32),
    (CASE_B, 2, 6, 130, 5, "flat", torch.float32),
    (CASE_A, 0, 3, 150, 2, None, torch.bfloat16)])
def test_b1_plain_is_bit_equal_over_every_chunk(geom, npf, M, K, N, shift,
                                                dt, monkeypatch):
    """Every chunk candidate, and the tuned dispatcher under
    ``REPRO_AUTOTUNE=1``, gives the default chunk's bits; ``report()``
    records the sweep of ``blocklast_chunk``."""
    aux, gn, u, pos, sh = _b1_inputs(geom, npf, M, K, N, shift)
    want = ops.emulator_block_unified(aux, gn, u, pos, shift=sh,
                                      tune=False, compute_dtype=dt)
    assert autotune.report() == {}
    for c in ops.CHUNK_CANDIDATES:
        got = ops.emulator_block_unified(aux, gn, u, pos, shift=sh, chunk=c,
                                         compute_dtype=dt)
        assert torch.equal(got, want), c
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    got = ops.emulator_block_unified(aux, gn, u, pos, shift=sh,
                                     compute_dtype=dt)
    assert torch.equal(got, want)
    rep = autotune.report()["blocklast_chunk"]
    assert rep["source"] == "swept"
    assert rep["config"]["chunk"] in ops.CHUNK_CANDIDATES
    assert len(rep["ms"]) == len(ops.CHUNK_CANDIDATES)
    ops.emulator_block_unified(aux, gn, u, pos, shift=sh, compute_dtype=dt)
    assert autotune.report()["blocklast_chunk"]["source"] == "memory"


def test_dispatcher_resolves_the_default_when_not_sweeping(monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    aux, gn, u, pos, _ = _b1_inputs(CASE_A, 0, 4, 100, 3, None)
    ops.emulator_block_unified(aux, gn, u, pos)
    rep = autotune.report()["blocklast_chunk"]
    assert rep["source"] == "default" and rep["config"] == {"chunk": 2}
    assert rep["key"].startswith("blocklast_chunk|torch:cpu|4|")
    autotune.clear()
    ops.emulator_block_unified(aux, gn, u, pos, tune=False)
    assert autotune.report() == {}                # tune=False asks nothing


def test_a_default_resolution_is_kept_while_sweeping_is_off(monkeypatch):
    """Not sweeping, a key resolves to the caller's default once: later
    calls neither read the disk file again nor change the source; with
    sweeping turned on the key sweeps."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    reads = []
    load = autotune._load_disk
    monkeypatch.setattr(autotune, "_load_disk",
                        lambda: reads.append(1) or load())
    for _ in range(3):
        assert autotune.best_config("k", (7,), [{"b": 2}], lambda cfg: None,
                                    {"b": 1}) == {"b": 1}
        assert autotune.report()["k"]["source"] == "default"
    assert len(reads) == 1
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    assert autotune.best_config("k", (7,), [{"b": 2}], lambda cfg: None,
                                {"b": 1}) == {"b": 2}
    assert autotune.report()["k"]["source"] == "swept"


@pytest.mark.parametrize("M,extra", [(1, 1), (4, 4), (8, 8), (16, None),
                                     (100, 100), (128, None), (300, None)])
def test_b1_tile_candidates_hold_the_default(M, extra):
    """A sweep times the reference's tiles and the default where it is
    none of them, so it can keep the default."""
    from repro_torch.kernels.emulator_block.emulator_block import (
        default_block_m)
    c = ops.block_m_candidates(M)
    assert c[:5] == ops.BLOCK_M_CANDIDATES and default_block_m(M) in c
    assert c[5:] == (() if extra is None else (extra,))


def test_unified_key_names_shape_shift_and_mode():
    aux, gn, u, _, sh = _b1_inputs(CASE_A, 15, 3, 200, 4, "block")
    k = ops.unified_key(aux, gn, u, sh, torch.bfloat16)
    assert k[:6] == (3,) + tuple(gn.shape) and k[-2:] == ("block",
                                                          "bfloat16")
    assert ops.unified_key(aux, gn, u, None, torch.float32)[-2:] == (
        "none", "float32")
