"""The plain reference against the port at a tiny size of both
configurations, on the CPU, and what the benchmark's modules import."""
import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import cell as C
from perfbench.reference.decoder import Decoder
from perfbench.reference.emulator import AnalogRef, conductances

BENCH = Path(C.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    """Top-level names compared whole: ``repro_torch`` is not ``repro``."""
    names = set(_imports(path))
    assert not names & FORBIDDEN, (path, names & FORBIDDEN)
    if path.parent.name == "reference":
        assert "repro_torch" not in names and "perfbench" not in names, path


def _program(name, seed=3):
    cell = C.load_cell(name)
    prog = C.Program(cell, seed, torch.device("cpu"), reduced=True)
    return cell, prog


@pytest.mark.parametrize("name", ["phi35moe.chat", "cmdrplus.batch"])
def test_reference_agrees_with_the_port(name):
    """Every analog site's output, a prefill's logits and cache, and a
    decode step of a batch, the reference's own emulator throughout."""
    cell, prog = _program(name)
    xb = cell.config["crossbar"]
    states = prog.sess.states()
    ana = AnalogRef(prog.eparams, xb)
    g = torch.Generator().manual_seed(5)
    for sk, w in prog.sess.sites().items():
        plan = prog.ex._read_plan(w, sk, states[sk])
        assert torch.equal(plan.g_norm, conductances(w, xb)), sk
        x = torch.randn(6, w.shape[0], generator=g).to(torch.bfloat16)
        want = ana.matmul(x, w)
        got = prog.ex.matmul(x, w, sk, state=states[sk])
        assert (got.float() - want.float()).abs().max() <= \
            2 ** -7 * want.float().abs().max(), sk
    ref = Decoder(prog.ref_cfg, prog.params, ana)
    V = prog.ref_cfg["vocab_size"]
    tok = torch.randint(0, V, (1, 12), generator=g)
    with torch.no_grad():
        lp, pc = prog.sess._prefill({"tokens": tok}, states)
    lr, kvr = ref.prefill(tok)
    sd = lr[0, :V].std()
    assert (lp[0, :V] - lr[0, :V]).abs().max() <= 0.02 * sd
    kp = pc["scan"]["p0"]["attn"]["k"]
    for i, (k, _) in enumerate(kvr):
        assert (kp[i].float() - k.float()).abs().max() <= \
            2 ** -6 * k.float().abs().max()
    # one decode step of 4 rows at their own positions over that cache
    from repro_torch.models import model as M
    cache = M.zeros_cache(M.model_cache_schema(prog.cfg, 4, 20),
                          torch.device("cpu"))
    att = cache["scan"]["p0"]["attn"]
    for r in range(4):
        att["k"][:, r, :12] = kp[:, 0]
        att["v"][:, r, :12] = pc["scan"]["p0"]["attn"]["v"][:, 0]
    k0, v0 = att["k"].clone(), att["v"].clone()
    step_tok = torch.randint(0, V, (4, 1), generator=g)
    pos = torch.tensor([12, 12, 5, 0])
    with torch.no_grad():
        ld, _ = prog.sess._decode(step_tok, cache, pos, states)
    n = k0.shape[0]
    lr2 = ref.decode(step_tok, [(k0[i], v0[i]) for i in range(n)], pos)
    assert (ld[:, :V] - lr2[:, :V]).abs().max() <= 0.02 * lr2[:, :V].std()
    rows = torch.arange(4)
    assert torch.equal(att["k"][:, rows, pos], k0[:, rows, pos])


def test_the_control_reads_lower_precision():
    """The control's roundings: TF32 keeps 10 mantissa bits, fp8 (e4m3)
    three, each scaled by its tensor's largest magnitude."""
    from perfbench.reference.decoder import fp8
    from perfbench.reference.emulator import tf32
    x = torch.randn(1000, generator=torch.Generator().manual_seed(1))
    r = (tf32(x) - x).abs() / x.abs()
    assert 0 < float(r.max()) <= 2 ** -11 * 1.001
    assert torch.equal(tf32(tf32(x)), tf32(x))
    f = fp8(x.to(torch.bfloat16)).float()
    assert float(((f - x).abs() / x.abs())[x.abs() > 0.1].max()) <= 2 ** -3
    assert len(np.unique(f.numpy())) < 260


def test_configuration_settings_are_data(monkeypatch):
    """What a configuration file sets reaches the program without an edit
    of the harness: the digital backend serves without the executor and
    checks correct; a device corner is deployed, and the decoder
    reference, which models the ideal corner only, refuses it by name;
    ``autotune`` sets the tuner's switch, its file inside the checkout."""
    from perfbench.tests.test_perfbench_faults import SECONDS, _small
    cell = _small("phi35moe.chat")
    cell.config = dict(cell.config, backend="digital")
    out, _ = C.run_once(cell, 2**31 + 9, SECONDS, False, torch.device("cpu"),
                        reduced=True)
    assert out["correct"] and out["checks"]["site_err"]["value"] == 0.0, \
        out["checks"]
    with pytest.raises(SystemExit, match="corner"):
        C.port_config(dict(cell.config, backend="emulator",
                           corner={"scenario": "stressed"}), reduced=True)
    for k in ("REPRO_AUTOTUNE", "REPRO_AUTOTUNE_CACHE"):
        monkeypatch.setenv(k, "")
    for on, want in ((True, "1"), (False, "0")):
        C.program_env(dict(cell.config, autotune=on))
        assert os.environ["REPRO_AUTOTUNE"] == want
    assert os.environ["REPRO_AUTOTUNE_CACHE"].startswith(str(BENCH))
