"""The unified emulator dispatcher on CPU tensors against the reference
dispatcher's plain route (``use_pallas=False``, that is
``apply_blocklast``), at rtol 2e-5 / atol 2e-6; and the kernel module's
CPU-side contract (imports without nvcc, refuses CPU tensors, counts no
launch on the CPU).  The kernel itself runs on the card, where
``chip_smoke.py`` holds it against the plain version."""
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.rram_ps32 import CASE_A as REF_A, CASE_B as REF_B  # noqa: E402
from repro.core import conv4xbar as rconv  # noqa: E402
from repro.kernels.emulator_block import emulator_block_unified as ref_unified  # noqa: E402
from repro_torch.configs.rram_ps32 import CASE_A, CASE_B  # noqa: E402
from repro_torch.core import conv4xbar  # noqa: E402
from repro_torch.kernels.emulator_block import emulator_block as eb  # noqa: E402
from repro_torch.kernels.emulator_block import emulator_block_unified  # noqa: E402
from torch_parity import assert_close, both_emulator_params  # noqa: E402

GEOMS = {"A": (REF_A, CASE_A), "B": (REF_B, CASE_B)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(g, npf, NB, NO, M, seed=0):
    rg, tg = GEOMS[g]
    jp, tp = both_emulator_params(rg, npf, seed=seed)
    ra, ta = rconv.blocklast_weights(jp, rg), conv4xbar.blocklast_weights(tp, tg)
    rng = np.random.default_rng(seed)
    gn = rng.uniform(0, 1, (NB, NO, tg.tiles, tg.rows, tg.cols)).astype(np.float32)
    u = rng.uniform(0, 1, (M, NB, tg.tiles, tg.rows)).astype(np.float32)
    u = np.where(u < 0.2, 0.0, u).astype(np.float32)
    pos = ((rng.uniform(size=u.shape) < 0.5) & (u > 0)).astype(np.float32)
    rpre = rconv.blocklast_precompute(ra, jnp.asarray(gn))
    tpre = conv4xbar.blocklast_precompute(ta, torch.from_numpy(gn))
    return (ra, rpre, jnp.asarray(u), jnp.asarray(pos)), \
        (ta, tpre, torch.from_numpy(u), torch.from_numpy(pos))


@pytest.mark.parametrize("g,npf,NB,NO,M,shift", [
    ("A", 0, 2, 3, 5, None), ("B", 0, 2, 2, 3, None),
    ("A", 15, 2, 2, 3, "flat"), ("B", 15, 3, 2, 4, "block")])
def test_dispatcher_cpu_matches_reference(g, npf, NB, NO, M, shift):
    eb.emulator_block_unified_cuda.launches = 0
    (ra, rpre, ru, rp), (ta, tpre, tu, tp) = _setup(g, npf, NB, NO, M)
    sh = None
    if shift:
        f = ta["fcs"][0][0].shape[1]
        shp = (f,) if shift == "flat" else (NB * NO, f)
        sh = (0.2 * np.random.default_rng(9).standard_normal(shp)).astype(np.float32)
    want = ref_unified(ra, rpre, ru, rp, use_pallas=False, tune=False,
                       shift=None if sh is None else jnp.asarray(sh))
    got = emulator_block_unified(ta, tpre, tu, tp,
                                 shift=None if sh is None else torch.from_numpy(sh))
    assert_close(got, want, 2e-5, 2e-6)
    # on the CPU the wrapper takes the plain version; the kernel never runs
    assert eb.emulator_block_unified_cuda.launches == 0


def test_chunk_choice_is_neutral():
    _, (ta, tpre, tu, tp) = _setup("A", 0, 2, 2, 7)
    outs = [emulator_block_unified(ta, tpre, tu, tp, chunk=c) for c in (1, 2, 3, 7)]
    for o in outs[1:]:
        assert_close(o, outs[0], 2e-6, 1e-7)


def test_kernel_module_imports_without_nvcc():
    code = ("import shutil, sys; assert shutil.which('nvcc') is None; "
            "import repro_torch.kernels.emulator_block.emulator_block as m; "
            "assert 'jax' not in sys.modules; print(m.SOURCE.name)")
    env = dict(os.environ, PATH="", PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "emulator_block_unified.cu"
    assert eb.SOURCE.exists()


def test_cuda_entry_refuses_cpu_tensors():
    _, (ta, tpre, tu, tp) = _setup("A", 0, 1, 2, 2)
    eb.emulator_block_unified_cuda.launches = 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        eb.emulator_block_unified_cuda(ta, tpre, tu, tp)
    assert eb.emulator_block_unified_cuda.launches == 0


def test_plain_version_is_apply_blocklast():
    _, (ta, tpre, tu, tp) = _setup("B", 0, 2, 2, 3)
    a = eb.emulator_block_unified_plain(ta, tpre, tu, tp, chunk=2)
    b = conv4xbar.apply_blocklast(ta, tpre, tu, tp, chunk=2)
    assert torch.equal(a, b)


def test_dispatcher_module_reload_is_side_effect_free():
    mod = importlib.import_module("repro_torch.kernels.emulator_block.emulator_block")
    assert "fn" not in mod._LIB          # nothing built or loaded on import


@pytest.mark.parametrize("g,npf,shift", [("A", 0, None), ("B", 0, None),
                                         ("A", 15, "flat"), ("B", 15, "block")])
def test_launch_args_accept_serving_shapes(g, npf, shift):
    _, (ta, tpre, tu, tp) = _setup(g, npf, 2, 3, 5)
    sh = None
    if shift == "flat":
        sh = torch.zeros(32)
    elif shift == "block":
        sh = torch.zeros(6, 32)
    a = eb.launch_args(ta, tpre, tu, tp, sh, 2)
    assert (a["geom"], a["M"], a["NB"], a["NO"], a["bm"]) == \
        ({"A": 0, "B": 1}[g], 5, 2, 3, 2)
    assert a["per_block"] == (shift == "block")
    assert a["O"] == GEOMS[g][1].outputs


def test_launch_args_refuse_what_the_kernel_does_not_take():
    _, (ta, tpre, tu, tp) = _setup("A", 0, 2, 3, 5)
    with pytest.raises(TypeError, match="float32"):
        eb.launch_args(ta, tpre, tu.double(), tp)
    with pytest.raises(ValueError, match="contiguous"):
        eb.launch_args(ta, tpre, tu.transpose(2, 3).contiguous().transpose(2, 3), tp)
    with pytest.raises(ValueError, match="shape"):
        eb.launch_args(ta, tpre, tu[:, :1], tp)
    with pytest.raises(ValueError, match="shape"):
        eb.launch_args(ta, tpre, tu, tp, torch.zeros(5, 32))
    with pytest.raises(ValueError, match="grid"):
        eb.launch_args(ta, tpre, tu, tp, None, 0)
