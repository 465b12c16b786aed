"""The slice as a whole against the JAX package.

(a) Model level in float32 (params and compute): reduced gemma3-1b with 2
    layers (tail only) and 6 layers (one stacked period, global layer
    included), digital and emulator backends -- prefill logits and 3
    greedy decode steps vs ``repro.models.model.prefill/decode_step`` on
    converted params, tokens equal, logits within rtol 1e-4 (atol 1e-4 of
    the logits' scale).
(b) ``ServeSession`` end to end on the CPU in bfloat16, on the
    reference session's own params and prompt.
(c) Import hygiene: the port and chip_smoke.py import neither jax nor
    the JAX package.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.serve import ServeSession  # noqa: E402
from torch_parity import BF16_REL, model_parity_f32, serve_parity_bf16  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# prompt 32 = 2 windows of the reduced config (the chunked sliding-window
# prefill path); prompts 16 and 8 fit in one window (the masked blockwise
# path).  The emulator runs on the 6-layer model (every MLP of a stacked
# period, the global layer's included) with a short prompt: its plain
# CPU evaluation is the slow part of this file.  The 2-layer tail path is
# layer-for-layer the same code, held digitally here and on the emulator
# by case (b).
@pytest.mark.parametrize("layers,P,backend", [
    (2, 16, "digital"), (6, 8, "emulator"), (6, 32, "digital")])
def test_model_prefill_decode_match_reference_f32(layers, P, backend):
    model_parity_f32("gemma3-1b", layers, P, backend)


@pytest.mark.parametrize("backend", sorted(BF16_REL))
def test_serve_session_end_to_end_bf16(backend):
    serve_parity_bf16("gemma3-1b", 2, backend)


def test_serve_cli_flags_of_unported_subsystems_raise():
    """No serve flag is unported any more: the mesh and device-count
    flags (``tests/test_torch_sharding.py`` serves them), ``--telemetry``
    (``tests/test_torch_obs.py``) and the non-ideal flags
    (``tests/test_torch_deployment.py``) keep the reference's argument
    checks: on the digital backend each is an argparse error."""
    from repro_torch.launch import serve
    base = ["--arch", "gemma3-1b", "--reduced", "--device", "cpu"]
    assert not hasattr(serve, "_NOT_PORTED")
    for flag in (["--mesh", "1,2"], ["--devices", "2"],
                 ["--scenario", "stressed"], ["--fault-remap"],
                 ["--age", "10"], ["--conditioned-emulator"],
                 ["--state-save", "x.npz"], ["--state-load", "x.npz"]):
        with pytest.raises(SystemExit):          # argparse's error exit
            serve.main(base + flag)


def test_entry_points_refuse_the_cpu_unless_asked():
    from repro_torch import resolve_device
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        ServeSession("gemma3-1b", reduced=True, reduced_layers=2)
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_neither_jax_nor_the_jax_package():
    code = r"""
import importlib, pkgutil, sys
sys.path.insert(0, 'src')
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):
    importlib.import_module(m.name)
import runpy
runpy.run_path('chip_smoke.py', run_name='not_main')
bad = sorted(k for k in sys.modules
             if k == 'jax' or k.startswith('jax.') or k == 'repro'
             or k.startswith('repro.'))
print('BAD', bad)
print('N', sum(1 for k in sys.modules if k.startswith('repro_torch')))
print('MISSING', [m for m in NEW if m not in sys.modules])
"""
    new = ["repro_torch.core." + m for m in ("circuit", "analytic", "theory",
                                              "emulator")]
    new += ["repro_torch.nonideal." + m for m in ("scenario", "perturb",
                                                  "lifetime", "data",
                                                  "sweep")]
    new += ["repro_torch.fleet" + m for m in ("", ".population", ".forecast",
                                              ".maintenance")]
    new += ["repro_torch.nonideal", "repro_torch.core.prng",
            "repro_torch.core.deployment", "repro_torch.launch.quickstart",
            "repro_torch.kernels.emulator_block.ops",
            "repro_torch.kernels._build", "repro_torch.models.ssm",
            "repro_torch.models.moe", "repro_torch.configs.qwen15_110b",
            "repro_torch.configs.command_r_plus_104b",
            "repro_torch.configs.phi35_moe", "repro_torch.configs.llama4_scout",
            "repro_torch.launch.batching", "repro_torch.launch.train",
            "repro_torch.runtime.trainer", "repro_torch.optim.adamw",
            "repro_torch.checkpoint.manager", "repro_torch.data.pipeline",
            "repro_torch.parallel.collectives",
            "repro_torch.parallel.sharding", "repro_torch.launch.mesh",
            "repro_torch.kernels.autotune", "repro_torch.parallel.train_mesh",
            "repro_torch.launch.dryrun"]
    new += ["repro_torch.obs" + m for m in ("", ".trace", ".registry",
                                            ".export", ".sentinel")]
    new += [f"repro_torch.kernels.{k}.{m}"
            for k in ("xbar_mac", "flash_attention", "linear_scan")
            for m in ("ops", "ref", k)]
    code = f"NEW = {new!r}\n" + code
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n = int(out.stdout.split("N ")[1].split()[0])
    assert n >= 25
    assert "MISSING []" in out.stdout, out.stdout


@pytest.mark.parametrize("backend", ["analytic", "circuit"])
def test_serve_cli_takes_the_analytic_and_circuit_backends(backend):
    """``--analog-backend analytic|circuit`` serves without an emulator
    npz, through the executor's block tensors (no kernel on the CPU)."""
    from repro_torch.launch import serve
    argv = ["--arch", "gemma3-1b", "--reduced", "--layers", "1", "--device",
            "cpu", "--batch", "1", "--prompt-len", "4", "--gen", "2"]
    _, dig = serve.main(argv)
    sess, out = serve.main(argv + ["--analog-backend", backend])
    assert sess.ex.acfg.backend == backend
    assert out["tokens"].shape == (1, 2)
    assert np.isfinite(out["logits"]).all()
    assert not np.array_equal(out["logits"], dig["logits"])   # analog ran
