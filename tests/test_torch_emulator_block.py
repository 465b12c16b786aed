"""The unified emulator dispatcher on CPU tensors, given the plan's
``g_norm``, against the reference dispatcher's plain route
(``use_pallas=False``, that is ``apply_blocklast``) given the reference's
own ``blocklast_precompute``, at rtol 2e-5 / atol 2e-6; and the kernel module's
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
    return (ra, rpre, jnp.asarray(u), jnp.asarray(pos)), \
        (ta, torch.from_numpy(gn), torch.from_numpy(u), torch.from_numpy(pos))


@pytest.mark.parametrize("g,npf,NB,NO,M,shift", [
    ("A", 0, 2, 3, 5, None), ("B", 0, 2, 2, 3, None),
    ("A", 15, 2, 2, 3, "flat"), ("B", 15, 3, 2, 4, "block"),
    ("A", 15, 1, 3, 7, "block"), ("B", 15, 2, 1, 9, "flat")])
def test_dispatcher_cpu_matches_reference(g, npf, NB, NO, M, shift):
    eb.emulator_block_unified_cuda.launches = 0
    (ra, rpre, ru, rp), (ta, tgn, tu, tp) = _setup(g, npf, NB, NO, M)
    sh = None
    if shift:
        f = ta["fcs"][0][0].shape[1]
        shp = (f,) if shift == "flat" else (NB * NO, f)
        sh = (0.2 * np.random.default_rng(9).standard_normal(shp)).astype(np.float32)
    want = ref_unified(ra, rpre, ru, rp, use_pallas=False, tune=False,
                       shift=None if sh is None else jnp.asarray(sh))
    got = emulator_block_unified(ta, tgn, tu, tp,
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
    (ra, rpre, ru, rp), (ta, tgn, tu, tp) = _setup(g, npf, NB, NO, M)
    sh = None
    if shift:
        f = ta["fcs"][0][0].shape[1]
        sh = (0.2 * np.random.default_rng(9).standard_normal(f)).astype(np.float32)
    want = ref_unified(ra, rpre, ru, rp, use_pallas=True, interpret=True,
                       tune=False, compute_dtype=jnp.bfloat16,
                       shift=None if sh is None else jnp.asarray(sh))
    tsh = None if sh is None else torch.from_numpy(sh)
    got = emulator_block_unified(ta, tgn, tu, tp, shift=tsh,
                                 compute_dtype=torch.bfloat16)
    assert eb.emulator_block_unified_cuda.launches == 0
    assert got.dtype == torch.float32
    assert_close(got, want, 0.0, 1e-2, "vs the reference kernel's bf16 mode")
    f32 = emulator_block_unified(ta, tgn, tu, tp, shift=tsh)
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


# B1's bf16 mode sums every contraction in order from index 0, the kernel
# and its plain version alike, so that the two agree bit for bit on the
# card: y0 through ``f32_dot`` (float32, each product and sum rounded
# apart), the GEMMs through ``bf16_dot``.  ``f32_dot`` is checked against
# a float32 loop bit for bit and against ``torch.matmul`` at 1e-6, on
# operands at y0's scale (celu0 in (-1, 1), fan-in-scaled weights: sums of
# magnitude ~1, a few float32 roundings apart).
@pytest.mark.parametrize("shape", [(7, 32, 8), (3, 5, 32, 8), (4, 1, 3)])
def test_f32_dot_is_an_ordered_float32_loop(shape):
    rng = np.random.default_rng(11)
    a = rng.uniform(-1, 1, shape[:-1]).astype(np.float32)
    b = (rng.standard_normal(shape[-2:]) * shape[-2] ** -0.5).astype(np.float32)
    acc = np.zeros(shape[:-2] + shape[-1:], np.float32)
    for k in range(shape[-2]):
        prod = (a[..., k, None] * b[k]).astype(np.float32)
        acc = (acc + prod).astype(np.float32)
    got = eb.f32_dot(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), acc)
    assert_close(got, torch.from_numpy(a) @ torch.from_numpy(b), 0.0, 1e-6)


@pytest.mark.parametrize("g", ["A", "B"])
def test_precompute_dot_defaults_to_matmul(g):
    """``blocklast_precompute(dot=None)`` is the fp32 mode's, bit for bit:
    y0 = celu(g0) @ w1 + b1 through ``torch.matmul``; with ``f32_dot`` only
    y0 moves, by float32 roundings."""
    _, (ta, tgn, _, _) = _setup(g, 0, 2, 3, 1)
    pre = conv4xbar.blocklast_precompute(ta, tgn)
    same = conv4xbar.blocklast_precompute(ta, tgn, dot=torch.matmul)
    w1, b1, _ = ta["hstages"][0]
    celu0 = conv4xbar.celu(conv4xbar.stage0_conductance(ta, tgn))
    y0 = celu0.reshape(-1, w1.shape[0]) @ w1 + b1
    for k in ("g0k", "celu0k", "y0"):
        assert torch.equal(pre[k], same[k]), k
    assert torch.equal(pre["y0"], y0)
    seq = conv4xbar.blocklast_precompute(ta, tgn, dot=eb.f32_dot)
    assert torch.equal(seq["g0k"], pre["g0k"])
    assert torch.equal(seq["celu0k"], pre["celu0k"])
    assert torch.equal(seq["y0"], eb.f32_dot(celu0.reshape(-1, w1.shape[0]), w1) + b1)
    assert_close(seq["y0"], pre["y0"], 0.0, 1e-6)


@pytest.mark.parametrize("g,npf,shift", [("A", 0, None), ("B", 15, "block")])
def test_bf16_plain_version_sums_y0_in_order(g, npf, shift):
    """The bf16 mode's plain version is ``apply_blocklast`` on the
    precompute with ``f32_dot``'s y0 and ``bf16_dot`` GEMMs, bit for bit;
    the fp32 mode's keeps ``torch.matmul``."""
    _, (ta, tgn, tu, tp) = _setup(g, npf, 2, 2, 5)
    sh = None
    if shift:
        sh = torch.from_numpy((0.2 * np.random.default_rng(9).standard_normal(
            (4, 32))).astype(np.float32))
    got = eb.emulator_block_unified_plain(ta, tgn, tu, tp, shift=sh,
                                          compute_dtype=torch.bfloat16)
    pre = conv4xbar.blocklast_precompute(ta, tgn, dot=eb.f32_dot)
    want = conv4xbar.apply_blocklast(ta, pre, tu, tp, chunk=2, fc0_shift=sh,
                                     dot=eb.bf16_dot)
    assert torch.equal(got, want)
    f32 = eb.emulator_block_unified_plain(ta, tgn, tu, tp, shift=sh)
    pre = conv4xbar.blocklast_precompute(ta, tgn)
    assert torch.equal(f32, conv4xbar.apply_blocklast(ta, pre, tu, tp, chunk=2,
                                                      fc0_shift=sh))


# The bf16 mode against the fp32 mode at the ROADMAP B1 gate (atol 5e-2),
# at the shapes test_bf16_mode_matches_reference_kernel leaves out: both
# shift forms on both geometries and ragged row counts.
@pytest.mark.parametrize("g,npf,NB,NO,M,shift", [
    ("A", 15, 1, 3, 7, "block"), ("B", 15, 2, 1, 9, "flat"),
    ("B", 15, 3, 2, 4, "block")])
def test_bf16_mode_within_gate_of_fp32_mode(g, npf, NB, NO, M, shift):
    _, (ta, tgn, tu, tp) = _setup(g, npf, NB, NO, M)
    shp = (32,) if shift == "flat" else (NB * NO, 32)
    sh = torch.from_numpy((0.2 * np.random.default_rng(9).standard_normal(
        shp)).astype(np.float32))
    got = emulator_block_unified(ta, tgn, tu, tp, shift=sh,
                                 compute_dtype=torch.bfloat16)
    f32 = emulator_block_unified(ta, tgn, tu, tp, shift=sh)
    assert_close(got, f32, 0.0, 5e-2, "bf16 mode vs float32 mode")
    assert not torch.equal(got, f32)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_stage2_stash_sums_in_the_plain_order(seed):
    """The bf16 kernel's stage 2 of one column, emulated: lane g stores its
    8 rounded channels at stash[(g//4)*36 + (g%4)*8 + c], w2 goes to shared
    memory as w2s[o*36 + k] = w2[k, o], and lane g sums output (g//4, g%4)
    as one float32 chain over stash[(g//4)*36 + k], k = 0..31.  That is
    ``bf16_dot`` of the plain version's (G/4, 32) reshape, bit for bit."""
    rng = np.random.default_rng(seed)
    h1 = rng.standard_normal((32, 8)).astype(np.float32)   # (g, c) of a column
    w2 = rng.standard_normal((32, 4)).astype(np.float32)
    stash = np.zeros(8 * 36, np.float32)
    w2s = np.zeros(4 * 36, np.float32)
    for g in range(32):
        stash[(g // 4) * 36 + (g % 4) * 8:(g // 4) * 36 + (g % 4) * 8 + 8] = _bf16(h1[g])
    flat = w2.reshape(-1)
    for i in range(32 * 4):
        w2s[(i % 4) * 36 + i // 4] = _bf16(flat[i])
    lanes = np.zeros(32, np.float32)
    for g in range(32):
        acc = np.float32(0.0)
        for k in range(32):
            acc = np.float32(acc + np.float32(stash[(g // 4) * 36 + k] * w2s[(g % 4) * 36 + k]))
        lanes[g] = acc
    want = eb.bf16_dot(torch.from_numpy(h1).reshape(8, 32), torch.from_numpy(w2))
    # lane g holds output row g // 4, channel g % 4: stage 3's input g
    np.testing.assert_array_equal(lanes, want.reshape(-1).numpy())


def test_compute_dtype_is_float32_or_bf16():
    _, (ta, tgn, tu, tp) = _setup("A", 0, 1, 2, 2)
    for fn in (emulator_block_unified, eb.emulator_block_unified_cuda):
        with pytest.raises(TypeError, match="compute_dtype"):
            fn(ta, tgn, tu, tp, compute_dtype=torch.float16)


def test_chunk_choice_is_neutral():
    _, (ta, tgn, tu, tp) = _setup("A", 0, 2, 2, 7)
    outs = [emulator_block_unified(ta, tgn, tu, tp, chunk=c) for c in (1, 2, 3, 7)]
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
    _, (ta, tgn, tu, tp) = _setup("A", 0, 1, 2, 2)
    eb.emulator_block_unified_cuda.launches = 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        eb.emulator_block_unified_cuda(ta, tgn, tu, tp)
    assert eb.emulator_block_unified_cuda.launches == 0


def test_plain_version_is_apply_blocklast():
    _, (ta, tgn, tu, tp) = _setup("B", 0, 2, 2, 3)
    a = eb.emulator_block_unified_plain(ta, tgn, tu, tp, chunk=2)
    pre = conv4xbar.blocklast_precompute(ta, tgn)
    b = conv4xbar.apply_blocklast(ta, pre, tu, tp, chunk=2)
    assert torch.equal(a, b)


def test_dispatcher_module_reload_is_side_effect_free():
    mod = importlib.import_module("repro_torch.kernels.emulator_block.emulator_block")
    assert "unified" not in mod._LIB     # nothing built or loaded on import


@pytest.mark.parametrize("g,npf,shift", [("A", 0, None), ("B", 0, None),
                                         ("A", 15, "flat"), ("B", 15, "block")])
def test_launch_args_accept_serving_shapes(g, npf, shift):
    _, (ta, tgn, tu, tp) = _setup(g, npf, 2, 3, 5)
    sh = None
    if shift == "flat":
        sh = torch.zeros(32)
    elif shift == "block":
        sh = torch.zeros(6, 32)
    a = eb.launch_args(ta, tgn, tu, tp, sh, 2)
    assert (a["geom"], a["M"], a["NB"], a["NO"], a["bm"]) == \
        ({"A": 0, "B": 1}[g], 5, 2, 3, 2)
    assert a["per_block"] == (shift == "block")
    assert a["O"] == GEOMS[g][1].outputs


def test_launch_args_refuse_what_the_kernel_does_not_take():
    _, (ta, tgn, tu, tp) = _setup("A", 0, 2, 3, 5)
    with pytest.raises(TypeError, match="float32"):
        eb.launch_args(ta, tgn, tu.double(), tp)
    with pytest.raises(ValueError, match="contiguous"):
        eb.launch_args(ta, tgn, tu.transpose(2, 3).contiguous().transpose(2, 3), tp)
    with pytest.raises(ValueError, match="shape"):
        eb.launch_args(ta, tgn, tu[:, :1], tp)
    with pytest.raises(ValueError, match="shape"):
        eb.launch_args(ta, tgn, tu, tp, torch.zeros(5, 32))
    with pytest.raises(ValueError, match="grid"):
        eb.launch_args(ta, tgn, tu, tp, None, 0)


@pytest.mark.parametrize("bad", ["g_norm rank", "g_norm blocks", "g_norm H",
                                 "w0g", "b0", "w0g shape"])
def test_launch_args_refuse_a_wrong_g_norm_or_stage0_weight(bad):
    """The fp32 kernel folds the precompute from ``g_norm`` and stage 0's
    weights, so ``launch_args`` holds both to the kernel's shapes."""
    _, (ta, tgn, tu, tp) = _setup("A", 0, 2, 3, 5)
    ta = dict(ta)
    if bad == "g_norm rank":
        tgn = tgn.reshape(6, 4, 64, 2)
    elif bad == "g_norm blocks":
        tgn = tgn[:1].contiguous()
    elif bad == "g_norm H":
        tgn = tgn[:, :, :, :32].contiguous()
    elif bad == "w0g shape":
        ta["w0g"] = ta["w0g"][:8]
    else:
        del ta[bad]
    with pytest.raises(ValueError, match="g_norm|shape|geometry|aux has no"):
        eb.launch_args(ta, tgn, tu, tp)


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


def _block_layout(geom, n_periph):
    """name -> (offset, shape) in ``pack_block_weights``' vector:
    ``grid_layout``'s arrays, then ``"fp"``, fc0's P periph rows."""
    lay = eb.grid_layout(geom)
    nw = lay["NW"][0]
    return dict(lay, fp=(nw, (n_periph, 32)), NW=(nw + 32 * n_periph, ()))


@pytest.mark.parametrize("g,npf", [("A", 0), ("A", 2), ("B", 2), ("B", 15)])
def test_pack_block_weights_layout(g, npf):
    """The vector B2 copies into its shared memory: B3's arrays at their
    ``grid_layout`` offsets on 16-byte boundaries, fc0's bias as it is
    (not folded), then fc0's P periph rows."""
    rg, tg = GEOMS[g]
    _, tp = both_emulator_params(rg, npf, seed=3)
    w, gid, P = eb.pack_block_weights(tp, tg)
    lay = _block_layout(tg, npf)
    assert (gid, P) == ({"A": 0, "B": 1}[g], npf)
    nw = {"A": 8272, "B": 12416}[g]
    assert w.numel() == lay["NW"][0] == nw + 32 * npf
    assert all(at % 4 == 0 for at, _ in lay.values())
    assert lay["fp"] == (nw, (npf, 32))

    def at(name):
        o, shp = lay[name]
        return w[o:o + int(torch.Size(shp).numel())].reshape(shp)

    flat = conv4xbar.flat_features(tg)
    assert torch.equal(at("fb0"), tp["fc0_b"])               # unfolded
    assert torch.equal(at("fp"), tp["fc0_w"][flat:])
    aux = conv4xbar.blocklast_weights(tp, tg)
    assert torch.equal(at("f0"), aux["fcs"][0][0])
    assert torch.equal(at("w1k"), aux["w1k"]) and torch.equal(at("w0g"), aux["w0g"])
    grid, _ = eb.pack_grid_weights(tp, tg)                   # B3's: folded
    fb0 = eb.grid_layout(tg)["fb0"][0]
    assert torch.equal(w[:fb0], grid[:fb0]) and torch.equal(w[fb0 + 32:nw],
                                                             grid[fb0 + 32:])
    assert torch.equal(grid[fb0:fb0 + 32],
                       tp["fc0_b"] + tp["fc0_w"][flat] if npf else tp["fc0_b"])


@pytest.mark.parametrize("kernel", ["block", "grid"])
def test_launch_refuses_a_misaligned_or_foreign_pack(kernel):
    """B2 and B3 copy their packed weights as float4: a pack that does not
    start on a 16-byte boundary, or was packed for another geometry, is
    refused before any launch."""
    _, tp = both_emulator_params(REF_A, 2)
    pack = getattr(eb, f"pack_{kernel}_weights")
    w, gid = pack(tp, CASE_A)[:2]
    dev = w.device
    eb._check_pack(w, gid, CASE_A, dev)
    with pytest.raises(ValueError, match="16-byte"):
        eb._check_pack(torch.cat([w, w[:4]])[1:1 + w.numel()], gid, CASE_A, dev)
    with pytest.raises(ValueError, match="packed for geometry"):
        eb._check_pack(w, gid, CASE_B, dev)


def test_pack_block_weights_refuses_other_nets():
    _, tp = both_emulator_params(REF_A, 2)
    with pytest.raises(ValueError, match="fc1_w"):
        eb.pack_block_weights(dict(tp, fc1_w=torch.zeros(32, 8)), CASE_A)
    with pytest.raises(ValueError, match="geometry"):
        eb.pack_block_weights(tp, CASE_A.__class__("x", 2, 4, 32, 2, 1))
    with pytest.raises(ValueError, match="depth"):
        eb.pack_block_weights({k: v for k, v in tp.items() if k != "fc2_w"}, CASE_A)
    with pytest.raises(ValueError, match="fewer rows"):
        eb.pack_block_weights(dict(tp, fc0_w=torch.zeros(100, 32)), CASE_A)


@pytest.mark.parametrize("g", ["A", "B"])
def test_default_block_n_rule(g):
    """B2's tiles: ceil(N / slots) blocks each, one tile a thread block, so
    that N spreads evenly over at most ``slots`` resident thread blocks
    (two an SM under CASE_A, one under CASE_B); training's 5,000 blocks
    and the headline's 2,048 and 65,536 fill every slot but a few.  The
    slots are an H100's (``block_slots`` asks the runtime on the card)."""
    _, tg = GEOMS[g]
    slots = {"A": 264, "B": 132}[g]
    for N in (1, 9, 100, 2048, 5000, 65536, 10 ** 6):
        bn = eb.default_block_n(N, tg, slots)
        blocks = -(-N // bn)
        assert blocks <= slots                               # one round
        assert bn == 1 or -(-N // (bn - 1)) > slots          # the smallest such tile
        assert bn * blocks - N < bn                          # only the last tile short
    for N in (2048, 5000, 65536):
        blocks = -(-N // eb.default_block_n(N, tg, slots))
        assert blocks >= slots - slots // 32, (N, blocks)    # no SM left idle
    assert eb.default_block_n(2048, CASE_A, 264) == 8        # one pass of R
    assert eb.default_block_n(65536, CASE_A, 264) == 249     # 31 passes and 1 block


# B2's kernel (``block_warp_kernel``) reads ``pack_block_weights``' vector:
# B3's arrays, fc0's bias unfolded, fc0's P periph rows after them.  It
# computes in its own order: stage 0 as celu(v*w0v + (g*w0g + b0)), both
# FMAs, every CELU as exp2(x*log2e) - 1, each contraction an FMA chain in
# the kernel's order (stage 1 over k = kk*16 + c; stage 2's four lanes'
# partial chains reduce-scattered as (p0 + p2) + (p1 + p3); fc0 in four
# partial chains over the flatten, the periph features continuing chain
# i % 4, summed as (c0 + c1) + (c2 + c3) before the bias; fc1 in two
# chains over even and odd k).  Emulated here in float32 torch ops (an FMA
# as a float64 product and sum rounded once), the weights read from the
# packed vector at ``_block_layout``'s offsets: the emulation stays within
# the card's gate (rtol 1e-4 / atol 1e-5, chip_smoke.py phase 2) of the
# plain version and of the reference's ``conv4xbar.apply``.
def _chain(x, w, acc, ks):
    """acc + sum over ks of x[..., k] * w[k], one FMA at a time in order."""
    for k in ks:
        acc = _fma(x[..., k, None], w[k], acc)
    return acc


def _block_kernel_order(params, x, periph, geom):
    """B2's function in the kernel's order of operations; (N, O)."""
    wpack, _, P = eb.pack_block_weights(params, geom)
    lay = _block_layout(geom, P)

    def take(name, shape=None):
        at, shp = lay[name]
        shp = shp if shape is None else shape
        return wpack[at:at + int(torch.Size(shp).numel())].reshape(shp)

    N, _, D, H, W = x.shape
    G, WO, O = H // 2, W // 2, geom.outputs
    lead = (N, D, W)
    v, c = (x[:, i].permute(0, 1, 3, 2)[..., None] for i in (0, 1))  # (N, D, W, H, 1)
    h = _celu_ex2(_fma(v, take("w0v"), _fma(c, take("w0g"), take("b0"))))
    h = h.reshape(lead + (G, 32))                          # k = kk*16 + c
    h = _celu_ex2(_chain(h, take("w1k").reshape(32, 8), torch.zeros(lead + (G, 8)),
                         range(32)) + take("b1"))
    # stage 2: lane g = 4j + a sums its 8 channels against tap a's rows
    w2 = take("w2")[:, :32].reshape(4, 8, 4)
    h = h.reshape(lead + (G // 4, 4, 8))
    p = [_chain(h[..., a, :], w2[a], torch.zeros(lead + (G // 4, 4)), range(8))
         for a in range(4)]
    h = _celu_ex2(((p[0] + p[2]) + (p[1] + p[3])) + take("b2"))
    h = h.reshape(lead + (32,))                            # stage 3's input g
    h = _celu_ex2(_chain(h, take("w3"), torch.zeros(lead + (32,)), range(32))
                  + take("b3"))
    h = h.reshape(N, D, WO, 64)                            # column pairs
    h = _celu_ex2(_chain(h, take("wst"), torch.zeros(N, D, WO, 32), range(64))
                  + take("bst"))
    h = h.reshape(N, -1)                                   # (d, w, c) flatten
    f0 = take("f0")
    chains = [_chain(h, f0, torch.zeros(N, 32), range(i, h.shape[1], 4))
              for i in range(4)]
    if P:
        fp = take("fp")
        for i in range(P):
            chains[i % 4] = _fma(periph[:, i, None], fp[i], chains[i % 4])
    h = _celu_ex2(((chains[0] + chains[1]) + (chains[2] + chains[3])) + take("fb0"))
    f1 = take("f1")
    e = [_chain(h, f1, torch.zeros(N, 16), range(i, 32, 2)) for i in (0, 1)]
    h = _celu_ex2((e[0] + e[1]) + take("fb1"))
    y = _chain(h, take("f2", (16 * O,)).reshape(16, O), torch.zeros(N, O), range(16))
    return y + take("fb2", (O,))


@pytest.mark.parametrize("g,npf", [("A", 0), ("A", 2), ("A", 15),
                                   ("B", 2), ("B", 15)])
def test_block_kernel_order_holds_the_card_gate(g, npf):
    rg, tg = GEOMS[g]
    jp, tp, x, periph = _block_inputs(g, npf, 6 if g == "A" else 4, seed=50 + npf)
    tx, tper = torch.from_numpy(x), torch.from_numpy(periph)
    got = _block_kernel_order(tp, tx, tper, tg)
    want = eb.emulator_block_plain(tp, tx, tper if npf else None)
    assert not torch.equal(got, want)
    assert_close(got, want, 1e-4, 1e-5, "kernel order vs plain version")
    want_ref = rconv.apply(jp, jnp.asarray(x), jnp.asarray(periph) if npf else None)
    assert_close(got, want_ref, 1e-4, 1e-5, "kernel order vs the reference's apply")


# B1's fp32 kernel takes every CELU as exp(x) - 1 from the hardware exp2
# (``celu_ex2``: x * log2(e) rounded to float32, then 2^t, less 1) where the
# plain version takes expm1.  Emulated here with float32 torch ops: the
# plain version with that CELU stays within the card's gate (rtol 1e-4 /
# atol 1e-5, chip_smoke.py phase 2) of the plain version itself.
@pytest.mark.parametrize("g,npf,NB,NO,M,shift", [
    ("A", 0, 2, 3, 5, None), ("B", 15, 2, 2, 3, "block")])
def test_exp2_celu_of_the_fp32_kernel_holds_the_card_gate(g, npf, NB, NO, M,
                                                          shift, monkeypatch):
    _, (ta, tgn, tu, tp) = _setup(g, npf, NB, NO, M)
    sh = None
    if shift:
        sh = torch.from_numpy((0.2 * np.random.default_rng(9).standard_normal(
            (NB * NO, 32))).astype(np.float32))
    want = eb.emulator_block_unified_plain(ta, tgn, tu, tp, shift=sh)
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)

    def celu_ex2(x):
        return torch.where(x > 0, x, torch.exp2(x * log2e) - 1.0)

    monkeypatch.setattr(conv4xbar, "celu", celu_ex2)
    got = eb.emulator_block_unified_plain(ta, tgn, tu, tp, shift=sh)
    assert not torch.equal(got, want)
    assert_close(got, want, 1e-4, 1e-5, "exp2 CELU vs expm1 CELU")


# --------------------------------------------------------------------------- #
# B3's kernel (``grid_warp_kernel``) reads ``pack_grid_weights``' vector, in
# which fc0's periph row is folded into fc0's bias, and computes in its own
# order: the fold's g0 = g*w0g + b0 rounded apart, stage 0 as one FMA on it,
# every CELU as exp2(x*log2e) - 1, fc0 in four partial chains over the
# flatten (k % 4) summed as (c0 + c1) + (c2 + c3) before the bias.  Emulated
# here in float32 torch ops (an FMA as a float64 product and sum rounded
# once), the weights read from the packed vector at ``grid_layout``'s
# offsets: the emulation stays within the card's gate (rtol 1e-4 / atol
# 1e-5, chip_smoke.py phase 2) of the plain version and of the reference's
# ``conv4xbar.apply`` on the broadcast stack.
# --------------------------------------------------------------------------- #
_LOG2E = 1.4426950408889634


def _celu_ex2(x):
    return torch.where(x > 0, x, torch.exp2(x * torch.tensor(_LOG2E, dtype=x.dtype)) - 1.0)


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _grid_kernel_order(params, v, gn, geom):
    """B3's function in the kernel's order of operations; (M, NB*NO, O)."""
    wpack, _ = eb.pack_grid_weights(params, geom)
    lay = eb.grid_layout(geom)

    def take(name, shape=None):
        at, shp = lay[name]
        shp = shp if shape is None else shape
        return wpack[at:at + int(torch.Size(shp).numel())].reshape(shp)

    M, NB, D, H = v.shape
    nblk, _, _, W = gn.shape
    NO, G, WO, O = nblk // NB, H // 2, W // 2, geom.outputs
    g0 = gn[..., None] * take("w0g") + take("b0")          # (nblk, D, H, W, 16)
    vb = v[:, torch.arange(nblk) // NO]                    # (M, nblk, D, H)
    h = _celu_ex2(_fma(vb[..., None, None], take("w0v"), g0[None]))
    h = h.reshape(M, nblk, D, G, 2, W, 16).permute(0, 1, 2, 5, 3, 4, 6)
    h = _celu_ex2(h.reshape(M, nblk, D, W, G, 32) @ take("w1k").reshape(32, 8)
                  + take("b1"))                            # (.., G, 8)
    w2 = take("w2")[:, :32].reshape(32, 4)
    h = _celu_ex2(h.reshape(M, nblk, D, W, G // 4, 32) @ w2 + take("b2"))
    h = _celu_ex2(h.reshape(M, nblk, D, W, 32) @ take("w3") + take("b3"))
    h = _celu_ex2(h.reshape(M, nblk, D, WO, 64) @ take("wst") + take("bst"))
    x = h.reshape(M * nblk, -1)                            # (d, w, c) flatten
    f0 = take("f0")
    chains = []
    for i in range(4):
        acc = torch.zeros(x.shape[0], 32)
        for k in range(i, x.shape[1], 4):
            acc = _fma(x[:, k, None], f0[k], acc)
        chains.append(acc)
    h = _celu_ex2(((chains[0] + chains[1]) + (chains[2] + chains[3])) + take("fb0"))
    h = _celu_ex2(h @ take("f1") + take("fb1"))
    y = h @ take("f2", (16 * O,)).reshape(16, O) + take("fb2", (O,))
    return y.reshape(M, nblk, O)


@pytest.mark.parametrize("g,npf", [("A", 0), ("A", 2), ("A", 15),
                                   ("B", 0), ("B", 2), ("B", 15)])
def test_grid_kernel_order_holds_the_card_gate(g, npf):
    rg, tg = GEOMS[g]
    jp, tp = both_emulator_params(rg, npf, seed=5 + npf)
    rng = np.random.default_rng(40 + npf)
    M, NB, NO = (5, 2, 3) if g == "A" else (3, 2, 2)
    D, H, W = tg.tiles, tg.rows, tg.cols
    v = rng.uniform(0, 1, (M, NB, D, H)).astype(np.float32)
    v[0, 0, 0, :7] = 0.0                                   # idle wordlines
    gn = rng.uniform(0, 1, (NB * NO, D, H, W)).astype(np.float32)
    got = _grid_kernel_order(tp, torch.from_numpy(v), torch.from_numpy(gn), tg)
    want = eb.emulator_block_grid_plain(tp, torch.from_numpy(v),
                                        torch.from_numpy(gn), tg)
    assert not torch.equal(got, want)
    assert_close(got, want, 1e-4, 1e-5, "kernel order vs plain version")
    x = np.stack(np.broadcast_arrays(
        v[:, :, None, :, :, None], gn.reshape(NB, NO, D, H, W)[None]), axis=3)
    per = None
    if npf:
        per = np.zeros((M * NB * NO, npf), np.float32)
        per[:, 0] = 1.0
    want_ref = rconv.apply(jp, jnp.asarray(x.reshape(M * NB * NO, 2, D, H, W)),
                           None if per is None else jnp.asarray(per))
    assert_close(got.reshape(-1, tg.outputs), want_ref, 1e-4, 1e-5,
                 "kernel order vs the reference's apply")


@pytest.mark.parametrize("g,npf", [("A", 0), ("A", 2), ("B", 2), ("B", 15)])
def test_pack_grid_weights_layout(g, npf):
    """The vector B3 copies into its shared memory: each array at its
    ``grid_layout`` offset on a 16-byte boundary, stage 2's taps padded to
    36 floats, fc0's flatten rows channels-last (as the fast path's
    permutation) and fc0's bias carrying its periph row FLAT."""
    rg, tg = GEOMS[g]
    _, tp = both_emulator_params(rg, npf, seed=3)
    w, gid = eb.pack_grid_weights(tp, tg)
    lay = eb.grid_layout(tg)
    assert gid == {"A": 0, "B": 1}[g]
    assert w.numel() == lay["NW"][0] == {"A": 8272, "B": 12416}[g]
    assert all(at % 4 == 0 for at, _ in lay.values())

    def at(name):
        o, shp = lay[name]
        return w[o:o + int(torch.Size(shp).numel())].reshape(shp)

    aux = conv4xbar.blocklast_weights(tp, tg)
    assert torch.equal(at("w1k"), aux["w1k"])
    assert torch.equal(at("w0v"), aux["w0v"]) and torch.equal(at("w0g"), aux["w0g"])
    assert torch.equal(at("b0"), tp["conv0_b"]) and torch.equal(at("b1"), tp["conv1_b"])
    (w2, b2, _), (w3, b3, _) = aux["hstages"][1:]
    assert torch.equal(at("w2")[:, :32].reshape(32, 4), w2)
    assert not at("w2")[:, 32:].any()
    assert torch.equal(at("w3"), w3) and torch.equal(at("b3"), b3)
    assert torch.equal(at("wst"), aux["wstage"][0])
    flat = conv4xbar.flat_features(tg)
    assert torch.equal(at("f0"), aux["fcs"][0][0])
    want_fb0 = tp["fc0_b"] + tp["fc0_w"][flat] if npf else tp["fc0_b"]
    assert torch.equal(at("fb0"), want_fb0)
    O = tg.outputs
    assert torch.equal(at("f2")[:16 * O].reshape(16, O), tp["fc2_w"])
    assert torch.equal(at("fb2")[:O], tp["fc2_b"])


def test_pack_grid_weights_refuses_other_nets():
    _, tp = both_emulator_params(REF_A, 2)
    with pytest.raises(ValueError, match="fc1_w"):
        eb.pack_grid_weights(dict(tp, fc1_w=torch.zeros(32, 8)), CASE_A)
    with pytest.raises(ValueError, match="geometry"):
        eb.pack_grid_weights(tp, CASE_A.__class__("x", 2, 4, 32, 2, 1))
    with pytest.raises(ValueError, match="depth"):
        eb.pack_grid_weights({k: v for k, v in tp.items() if k != "fc2_w"}, CASE_A)
    with pytest.raises(ValueError, match="fewer rows"):
        eb.pack_grid_weights(dict(tp, fc0_w=torch.zeros(100, 32)), CASE_A)
