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


# B1's bf16 mode (GEMM operands rounded to bf16, float32 accumulation): the
# port's plain version against the reference's interpret-mode kernel in
# bf16 mode at atol 1e-2 -- a bf16 rounding of one GEMM operand can flip
# where the two packages' float32 inputs to it differ in the last bit
# (measured 3.4e-3 on CASE_A, 0 on CASE_B and 1.2e-7 on the conditioned
# net, on outputs of magnitude 3.5) -- and against the port's own float32 mode at
# the ROADMAP B1 gate, atol 5e-2 (measured 0.023, 0.039 and 0.030).
@pytest.mark.parametrize("g,npf,NB,NO,M,shift", [
    ("A", 0, 2, 3, 5, None), ("B", 0, 2, 2, 3, None),
    ("A", 15, 2, 2, 3, "flat")])
def test_bf16_mode_matches_reference_kernel(g, npf, NB, NO, M, shift):
    eb.emulator_block_unified_cuda.launches = 0
    (ra, rpre, ru, rp), (ta, tpre, tu, tp) = _setup(g, npf, NB, NO, M)
    sh = None
    if shift:
        f = ta["fcs"][0][0].shape[1]
        sh = (0.2 * np.random.default_rng(9).standard_normal(f)).astype(np.float32)
    want = ref_unified(ra, rpre, ru, rp, use_pallas=True, interpret=True,
                       tune=False, compute_dtype=jnp.bfloat16,
                       shift=None if sh is None else jnp.asarray(sh))
    tsh = None if sh is None else torch.from_numpy(sh)
    got = emulator_block_unified(ta, tpre, tu, tp, shift=tsh,
                                 compute_dtype=torch.bfloat16)
    assert eb.emulator_block_unified_cuda.launches == 0
    assert got.dtype == torch.float32
    assert_close(got, want, 0.0, 1e-2, "vs the reference kernel's bf16 mode")
    f32 = emulator_block_unified(ta, tpre, tu, tp, shift=tsh)
    assert_close(got, f32, 0.0, 5e-2, "bf16 mode vs float32 mode")
    assert not torch.equal(got, f32)


def test_bf16_dot_rounds_both_operands():
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.standard_normal((5, 16)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    want = a.to(torch.bfloat16).double() @ b.to(torch.bfloat16).double()
    got = eb.bf16_dot(a, b)
    assert got.dtype == torch.float32
    assert_close(got, want, 1e-6, 1e-6)


def test_compute_dtype_is_float32_or_bf16():
    _, (ta, tpre, tu, tp) = _setup("A", 0, 1, 2, 2)
    for fn in (emulator_block_unified, eb.emulator_block_unified_cuda):
        with pytest.raises(TypeError, match="compute_dtype"):
            fn(ta, tpre, tu, tp, compute_dtype=torch.float16)


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


# --------------------------------------------------------------------------- #
# B2 (emulator_block) and B3 (emulator_block_grid): the dispatchers on CPU
# tensors take the plain versions, held against the reference's
# ``conv4xbar.apply`` and its interpret-mode Pallas kernels at rtol 2e-5 /
# atol 2e-6, with N % block_n != 0 and M % block_m != 0 on the reference side
# --------------------------------------------------------------------------- #
from repro.kernels.emulator_block import (  # noqa: E402
    emulator_block as ref_block, emulator_block_grid as ref_grid)
from repro_torch.kernels.emulator_block import ops  # noqa: E402


def _block_inputs(g, npf, N, seed):
    rg, tg = GEOMS[g]
    jp, tp = both_emulator_params(rg, npf, seed=seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.uniform(0, 1, (N,) + tg.chw).astype(np.float32)
    x[0, 0, :, :3] = 0.0                         # idle wordlines
    periph = rng.uniform(-1, 1, (N, npf)).astype(np.float32)
    return jp, tp, x, periph


@pytest.mark.parametrize("g,npf,N,bn", [("A", 2, 5, 2), ("B", 2, 3, 8),
                                        ("A", 15, 6, 4), ("B", 15, 4, 3)])
def test_block_dispatcher_cpu_matches_reference(g, npf, N, bn):
    rg, tg = GEOMS[g]
    jp, tp, x, periph = _block_inputs(g, npf, N, seed=npf + N)
    eb.emulator_block_cuda.launches = 0
    got = ops.emulator_block(tp, torch.from_numpy(x), torch.from_numpy(periph), tg)
    assert eb.emulator_block_cuda.launches == 0
    assert tuple(got.shape) == (N, tg.outputs)
    want_apply = rconv.apply(jp, jnp.asarray(x), jnp.asarray(periph))
    want_pallas = ref_block(jp, jnp.asarray(x), jnp.asarray(periph), rg, block_n=bn)
    assert_close(got, want_apply, 2e-5, 2e-6, "vs apply")
    assert_close(got, want_pallas, 2e-5, 2e-6, "vs interpret-mode kernel")


@pytest.mark.parametrize("g,npf,M,NB,NO,bm", [("A", 2, 3, 2, 3, 2), ("B", 2, 5, 1, 2, 2),
                                              ("A", 15, 4, 2, 2, 3), ("B", 0, 3, 2, 2, 2)])
def test_grid_dispatcher_cpu_matches_reference(g, npf, M, NB, NO, bm):
    rg, tg = GEOMS[g]
    jp, tp = both_emulator_params(rg, npf, seed=M + NB)
    rng = np.random.default_rng(M)
    D, H, W = tg.tiles, tg.rows, tg.cols
    v = rng.uniform(0, 1, (M, NB, D, H)).astype(np.float32)
    v[0, 0, 0, :7] = 0.0
    gn = rng.uniform(0, 1, (NB * NO, D, H, W)).astype(np.float32)
    eb.emulator_block_grid_cuda.launches = 0
    got = ops.emulator_block_grid(tp, torch.from_numpy(v), torch.from_numpy(gn), tg)
    assert eb.emulator_block_grid_cuda.launches == 0
    assert tuple(got.shape) == (M, NB * NO, tg.outputs)
    want_pallas = ref_grid(jp, jnp.asarray(v), jnp.asarray(gn), rg, block_m=bm)
    assert_close(got, want_pallas, 2e-5, 2e-6, "vs interpret-mode kernel")
    # the broadcast (V, G) stack with the constant periph through apply
    x = np.stack(np.broadcast_arrays(
        v[:, :, None, :, :, None], gn.reshape(NB, NO, D, H, W)[None]), axis=3)
    x = x.reshape(M * NB * NO, 2, D, H, W)
    per = None
    if npf:
        per = np.zeros((x.shape[0], npf), np.float32)
        per[:, 0] = 1.0
    want_apply = rconv.apply(jp, jnp.asarray(x),
                             None if per is None else jnp.asarray(per))
    assert_close(got.reshape(-1, tg.outputs), want_apply, 2e-5, 2e-6, "vs apply")


@pytest.mark.parametrize("chunk", [1, 2, 5, None])
def test_grid_plain_chunking_is_neutral(chunk):
    _, tp = both_emulator_params(REF_A, 2, seed=1)
    rng = np.random.default_rng(2)
    v = torch.from_numpy(rng.uniform(0, 1, (3, 2) + CASE_A.chw[1:3]).astype(np.float32))
    gn = torch.from_numpy(rng.uniform(0, 1, (6,) + CASE_A.chw[1:]).astype(np.float32))
    full = eb.emulator_block_grid_plain(tp, v, gn, CASE_A, chunk_blocks=6)
    got = eb.emulator_block_grid_plain(tp, v, gn, CASE_A, chunk_blocks=chunk)
    assert_close(got, full, 1e-6, 1e-7)


def test_plain_versions_are_apply():
    jp, tp, x, periph = _block_inputs("B", 2, 3, seed=0)
    a = eb.emulator_block_plain(tp, torch.from_numpy(x), torch.from_numpy(periph))
    assert torch.equal(a, conv4xbar.apply(tp, torch.from_numpy(x),
                                          torch.from_numpy(periph)))


def test_block_and_grid_cuda_entries_refuse_cpu_tensors():
    _, tp, x, periph = _block_inputs("A", 2, 2, seed=0)
    eb.emulator_block_cuda.launches = eb.emulator_block_grid_cuda.launches = 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        eb.emulator_block_cuda(tp, torch.from_numpy(x), torch.from_numpy(periph), CASE_A)
    with pytest.raises(ValueError, match="CUDA tensors"):
        eb.emulator_block_grid_cuda(tp, torch.zeros(1, 1, 4, 64), torch.zeros(2, 4, 64, 2),
                                    CASE_A)
    assert eb.emulator_block_cuda.launches == eb.emulator_block_grid_cuda.launches == 0


def test_dispatchers_refuse_other_devices():
    _, tp = both_emulator_params(REF_A, 2)
    meta = torch.empty((2,) + CASE_A.chw, device="meta")
    with pytest.raises(ValueError, match="no emulator kernel"):
        ops.emulator_block(tp, meta, torch.empty((2, 2), device="meta"), CASE_A)
    with pytest.raises(ValueError, match="no emulator kernel"):
        ops.emulator_block_grid(tp, torch.empty((1, 1, 4, 64), device="meta"),
                                torch.empty((2, 4, 64, 2), device="meta"), CASE_A)


@pytest.mark.parametrize("g,npf", [("A", 0), ("A", 2), ("B", 2), ("B", 15)])
def test_pack_net_weights_layout(g, npf):
    """The packed vector the kernels read: fixed part, then fc0's rows
    (flatten rows channels-last, then the periph rows), as the source's
    ``Net`` offsets lay them out."""
    rg, tg = GEOMS[g]
    _, tp = both_emulator_params(rg, npf, seed=3)
    w, gid, P = eb.pack_net_weights(tp, tg)
    assert (gid, P) == ({"A": 0, "B": 1}[g], npf)
    flat = conv4xbar.flat_features(tg)
    fixed = (16 * 3 + (2 * 16 * 8 + 8) + (4 * 8 * 4 + 4) + (8 * 4 * 32 + 32)
             + (2 * 32 * 32 + 32) + 32 + (32 * 16 + 16) + (16 * tg.outputs + tg.outputs))
    assert w.numel() == fixed + (flat + npf) * 32
    assert torch.equal(w[:16], tp["conv0_w"][:, 0, 0, 0, 0])
    assert torch.equal(w[w.numel() - npf * 32:].reshape(npf, 32), tp["fc0_w"][flat:])
    aux = conv4xbar.blocklast_weights(tp, tg)
    f0 = w[fixed:fixed + flat * 32].reshape(flat, 32)
    assert torch.equal(f0, aux["fcs"][0][0])      # the fast path's permutation


def test_pack_net_weights_refuses_other_nets():
    _, tp = both_emulator_params(REF_A, 2)
    bad = dict(tp, fc1_w=torch.zeros(32, 8))
    with pytest.raises(ValueError, match="fc1_w"):
        eb.pack_net_weights(bad, CASE_A)
    with pytest.raises(ValueError, match="geometry"):
        eb.pack_net_weights(tp, CASE_A.__class__("x", 2, 4, 32, 2, 1))
