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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config, reduced as ref_reduced  # noqa: E402
from repro.configs.base import AnalogConfig as RefAnalogConfig, ParallelConfig as RefPcfg  # noqa: E402
from repro.configs.rram_ps32 import CASE_A as REF_A  # noqa: E402
from repro.core.analog import AnalogExecutor as RefExecutor  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.common import init_params as ref_init_params, use_dense_hook as ref_hook  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import AnalogConfig, ParallelConfig  # noqa: E402
from repro_torch.configs.rram_ps32 import CASE_A  # noqa: E402
from repro_torch.core.analog import AnalogExecutor  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.serve import ServeSession, _splice_tree  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.common import use_dense_hook  # noqa: E402
from torch_parity import both_emulator_params, tree_np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_splice(z, c):
    """The reference ServeSession's prefill-cache splice."""
    c = c.astype(z.dtype)
    if z.shape == c.shape:
        return c
    if z.ndim == c.ndim and ((z.shape[2:] == c.shape[2:] and z.shape[0] == c.shape[0])
                             or (z.shape[3:] == c.shape[3:]
                                 and z.shape[:2] == c.shape[:2])):
        return jax.lax.dynamic_update_slice(z, c, (0,) * c.ndim)
    return z


def _executors(backend):
    if backend == "digital":
        return None, None
    jp, tp = both_emulator_params(REF_A, 0, seed=3)
    ref = RefExecutor(acfg=RefAnalogConfig(enabled=True, backend="emulator",
                                           layers=("mlp",)),
                      geom=REF_A, emulator_params=jp, use_pallas=False)
    ex = AnalogExecutor(AnalogConfig(enabled=True, backend="emulator",
                                     layers=("mlp",)),
                        geom=CASE_A, emulator_params=tp)
    return ref, ex


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
    B, G = 2, 3
    rcfg = ref_reduced(ref_get_config("gemma3-1b"), layers=layers)
    tcfg = reduced(get_config("gemma3-1b"), layers=layers)
    assert tcfg == type(tcfg)(**{f: getattr(rcfg, f) for f in tcfg.__dataclass_fields__
                                 if f != "analog"}, analog=tcfg.analog)
    rp = ref_init_params(jax.random.PRNGKey(0), RM.model_schema(rcfg))
    tp = params_from_numpy(tree_np(rp), device="cpu")
    rpc = RefPcfg(compute_dtype="float32", attn_block_kv=min(1024, P))
    tpc = ParallelConfig(compute_dtype="float32", attn_block_kv=min(1024, P))
    tokens = np.random.default_rng(1).integers(0, rcfg.vocab_size, (B, P))
    rex, tex = _executors(backend)
    rctx = ref_hook(rex.hook) if rex else ref_hook(None)
    tctx = use_dense_hook(tex.hook) if tex else use_dense_hook(None)

    with rctx:
        pf = jax.jit(lambda t: RM.prefill(rp, t, cfg=rcfg, pcfg=rpc,
                                          compute_dtype=jnp.float32))
        dec = jax.jit(lambda t, c, pos: RM.decode_step(
            rp, t, c, pos, cfg=rcfg, pcfg=rpc, compute_dtype=jnp.float32))
        rl, rcache = pf(jnp.asarray(tokens, jnp.int32))
        cache = RM.zeros_cache(RM.model_cache_schema(rcfg, B, P + G,
                                                     dtype=jnp.float32))
        cache = jax.tree.map(_ref_splice, cache, rcache)
        r_logits, r_toks = [np.asarray(rl)], [np.asarray(jnp.argmax(rl, -1))]
        tok = jnp.argmax(rl, -1)[:, None].astype(jnp.int32)
        for i in range(G):
            rl, cache = dec(tok, cache, jnp.asarray(P + i, jnp.int32))
            r_logits.append(np.asarray(rl))
            r_toks.append(np.asarray(jnp.argmax(rl, -1)))
            tok = jnp.argmax(rl, -1)[:, None].astype(jnp.int32)

    with torch.no_grad(), tctx:
        tl, tcache = TM.prefill(tp, torch.from_numpy(tokens), cfg=tcfg,
                                pcfg=tpc, compute_dtype=torch.float32)
        cache = TM.zeros_cache(TM.model_cache_schema(tcfg, B, P + G,
                                                     dtype=torch.float32), "cpu")
        cache = _splice_tree(cache, tcache)
        t_logits, t_toks = [tl.numpy()], [tl.argmax(-1).numpy()]
        tok = tl.argmax(-1)[:, None]
        for i in range(G):
            tl, cache = TM.decode_step(tp, tok, cache, P + i, cfg=tcfg,
                                       pcfg=tpc, compute_dtype=torch.float32)
            t_logits.append(tl.numpy())
            t_toks.append(tl.argmax(-1).numpy())
            tok = tl.argmax(-1)[:, None]

    for step, (g, w) in enumerate(zip(t_logits, r_logits)):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=f"step {step}")
    np.testing.assert_array_equal(np.stack(t_toks), np.stack(r_toks))


# bf16 end to end: both packages round activations to bf16 after every op,
# but a matmul's f32 result can round to the neighbouring bf16 value when
# the two frameworks sum in another order.  Digitally that stays an ulp
# (measured: at most 0.0067 of the logits' max |value| over 3 steps and 2
# seeds).  On the emulator backend one such ulp is amplified: the
# gate-overdrive drive map sends a zero activation to 0 V and any nonzero
# one to at least v_th (0.4 of full scale), and a bf16 gelu output that is
# exactly 0 on one side and tiny on the other (tanh saturating at a
# threshold an ulp away) moves that row's analog mlp.down output by O(1).
# Measured: at most 0.37 of the logits' max |value| over the same steps
# and seeds, with identical tokens.  The bounds are those measurements
# rounded up; f32 parity of the same path is case (a).
BF16_REL = {"digital": 0.02, "emulator": 0.5}


@pytest.mark.parametrize("backend", sorted(BF16_REL))
def test_serve_session_end_to_end_bf16(backend):
    from repro.launch.serve import ServeSession as RefSession
    rex, tex = _executors(backend)
    rs = RefSession("gemma3-1b", reduced=True, reduced_layers=2, batch=2,
                    prompt_len=16, gen=3, seed=0, executor=rex)
    rout = rs.generate()
    ts = ServeSession("gemma3-1b", reduced=True, reduced_layers=2, batch=2,
                      prompt_len=16, gen=3, seed=0, executor=tex,
                      device="cpu", params=params_from_numpy(
                          tree_np(rs.params), device="cpu"),
                      prompt=torch.tensor(np.asarray(rs.batch["tokens"])))
    assert sorted(ts.sites()) == sorted(rs.sites())
    tout = ts.generate()
    assert tout["tokens"].shape == rout["tokens"].shape == (2, 3)
    assert tout["logits"].shape == rout["logits"].shape
    assert np.isfinite(tout["logits"]).all()
    # the first token comes from the prefill logits alone
    np.testing.assert_array_equal(tout["tokens"][:, 0], rout["tokens"][:, 0])
    scale = float(np.abs(rout["logits"]).max())
    err = float(np.abs(tout["logits"] - rout["logits"]).max())
    assert err <= BF16_REL[backend] * scale, (err, scale)


def test_serve_cli_flags_of_unported_subsystems_raise():
    """Only the mesh, device-count and telemetry flags are unported; the
    non-ideal flags are ported and keep the reference's argument checks
    (``tests/test_torch_deployment.py`` serves them)."""
    from repro_torch.launch import serve
    base = ["--arch", "gemma3-1b", "--reduced", "--device", "cpu"]
    for flag in (["--mesh", "1,2"], ["--telemetry"], ["--devices", "2"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            serve.main(base + flag)
    assert sorted(serve._NOT_PORTED) == ["devices", "mesh", "telemetry"]
    for flag in (["--scenario", "stressed"], ["--fault-remap"],
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
                                                  "lifetime", "data")]
    new += ["repro_torch.nonideal", "repro_torch.core.prng",
            "repro_torch.core.deployment", "repro_torch.launch.quickstart",
            "repro_torch.kernels.emulator_block.ops",
            "repro_torch.kernels._build"]
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
