"""B6, the diagonal gated linear recurrence: the port's entry point on CPU
tensors (its plain version, a sequential float32 carry) against the JAX
entry point (the Pallas kernel in interpret mode, 64-wide tiles) and the
JAX oracle (an associative scan, which sums in another order), on the
shapes of ``tests/test_kernels.py``, with and without h0, at that file's
tolerances: 1e-4 in float32, 3e-2 in bfloat16.  The kernel itself runs on
the card, where ``chip_smoke.py`` holds it bit for bit against the plain
version; here its launch plan (``launch_plan``: column tiles, stages of R
rows, a ring of K) is checked over the shapes it meets, and its walk is
emulated on the CPU and held bit for bit against the plain version."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.linear_scan import linear_scan as ref_linear_scan  # noqa: E402
from repro.kernels.linear_scan.ref import linear_scan_ref as jax_ref  # noqa: E402
from repro_torch.kernels.linear_scan import linear_scan  # noqa: E402
from repro_torch.kernels.linear_scan.ref import linear_scan_ref  # noqa: E402
from torch_parity import assert_close  # noqa: E402

ls = importlib.import_module("repro_torch.kernels.linear_scan.linear_scan")
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(B, S, D, with_h0, dt):
    rng = np.random.default_rng(S + D)
    a = rng.uniform(0.5, 0.999, (B, S, D)).astype(np.float32)
    b = (0.1 * rng.standard_normal((B, S, D))).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32) if with_h0 else None
    jd, td, _ = DTYPES[dt]
    j = [None if x is None else jnp.asarray(x, jd) for x in (a, b, h0)]
    t = [None if x is None else torch.from_numpy(x).to(td) for x in (a, b, h0)]
    return j, t


@pytest.mark.parametrize("B,S,D", [(2, 256, 512), (1, 128, 1024), (4, 512, 64)])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_entry_point_matches_reference(B, S, D, with_h0, dt):
    (ja, jb, jh0), (ta, tb, th0) = _inputs(B, S, D, with_h0, dt)
    tol = DTYPES[dt][2]
    ls.linear_scan_cuda.launches = 0
    h, h_last = linear_scan(ta, tb, th0, block_d=64, block_s=64)
    assert ls.linear_scan_cuda.launches == 0     # the CPU takes the plain version
    assert h.dtype == ta.dtype and tuple(h.shape) == (B, S, D)
    assert torch.equal(h_last, h[:, -1])
    wh, wl = ref_linear_scan(ja, jb, jh0, block_d=64, block_s=64)
    assert_close(h, wh, tol, tol, "vs interpret-mode kernel")
    assert_close(h_last, wl, tol, tol, "h_last vs interpret-mode kernel")
    f32 = [None if x is None else x.astype(jnp.float32) for x in (ja, jb, jh0)]
    rh, rl = jax_ref(*f32)
    assert_close(h, rh, tol, tol, "vs the JAX oracle")
    assert_close(h_last, rl, tol, tol, "h_last vs the JAX oracle")
    # the port's oracle (a log-depth scan) against the JAX oracle
    tf = [None if x is None else x.float() for x in (ta, tb, th0)]
    oh, ol = linear_scan_ref(*tf)
    assert_close(oh, rh, 1e-4, 1e-4, "oracle")
    assert_close(ol, rl, 1e-4, 1e-4, "oracle h_last")


def test_h0_is_folded_into_the_first_step_in_b_dtype():
    """``b[:, 0] + a[:, 0] * h0`` rounded to b's dtype, then the scan with
    h0 = 0: the entry point hands the folded row to the kernel beside b."""
    _, (ta, tb, th0) = _inputs(2, 16, 8, True, "bf16")
    h, _ = linear_scan(ta, tb, th0)
    b = tb.clone()
    b[:, 0] = b[:, 0] + ta[:, 0] * th0
    assert torch.equal(h, ls.linear_scan_plain(ta, b))
    assert torch.equal(h, ls.linear_scan_plain(ta, tb, b[:, 0].contiguous()))


def test_cuda_entry_refuses_cpu_tensors():
    _, (ta, tb, _) = _inputs(1, 4, 8, False, "f32")
    ls.linear_scan_cuda.launches = 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        ls.linear_scan_cuda(ta, tb)
    assert ls.linear_scan_cuda.launches == 0


def test_entry_point_refuses_other_devices():
    meta = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no linear_scan kernel"):
        linear_scan(meta, meta)


# (B, S, D): chip_smoke.py's phase-8 shapes (falcon-mamba-7b's scan state,
# recurrentgemma-2b's RG-LRU, the ragged ones), this file's, and small
# ones: B*D below a warp, S = 1, S not a multiple of any R, odd pitches
PLAN_SHAPES = [(1, 2048, 131072), (4, 2048, 2560), (3, 37, 1000),
               (3, 37, 1001), (2, 256, 512), (1, 128, 1024), (4, 512, 64),
               (1, 5, 7), (2, 1, 3), (1, 1, 1), (5, 37, 24), (64, 3, 1001)]
N_SM = 132                                   # an H100's SMs


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("B,S,D", PLAN_SHAPES)
def test_launch_plan_covers_every_lane_once(B, S, D, itemsize):
    plan = ls.launch_plan(B, D, itemsize, N_SM)
    C, R, K = plan["C"], plan["R"], plan["K"]
    V = 16 // itemsize                       # 16 B: a tile row's least width
    assert C % V == 0 and V <= C <= 32 * V and (C * itemsize) % 16 == 0
    assert C <= 32 or C % 32 == 0            # C / 32 lanes a consumer thread
    assert 4 <= R <= 64 and K >= 2
    aligned = D * itemsize % 16 == 0         # else rows arrive as 16 B chunks
    assert plan["smem"] == ls.ring_bytes(C, R, K, itemsize, aligned) <= ls.RING_MAX
    # thread block (bi, j) owns lanes j*C .. min(D, (j+1)*C) of batch row bi
    tiles = -(-D // C)
    assert plan["blocks"] == B * tiles
    seen = np.zeros((B, D), np.int64)
    for blk in range(plan["blocks"]):
        bi, d0 = blk // tiles, (blk % tiles) * C
        seen[bi, d0:min(D, d0 + C)] += 1
    assert (seen == 1).all()
    # two thread blocks an SM wherever the lanes allow it, at the widest C
    if B * -(-D // V) >= 2 * N_SM:
        assert plan["blocks"] >= 2 * N_SM
    if C < 32 * V:
        assert B * -(-D // (2 * C)) < 2 * N_SM
    # the ring keeps IN_FLIGHT bytes in flight unless R met its cap
    row = 2 * C * itemsize
    resident = min(plan["blocks"], N_SM * ls._resident_model(plan["smem"]))
    if R < 64 and ls.ring_bytes(C, 2 * R, K, itemsize, aligned) <= ls.RING_MAX:
        assert resident * (K - 1) * R * row >= ls.IN_FLIGHT
    if R > 4:
        half = ls.ring_bytes(C, R // 2, K, itemsize, aligned)
        assert (min(plan["blocks"], N_SM * ls._resident_model(half))
                * (K - 1) * (R // 2) * row < ls.IN_FLIGHT)


@pytest.mark.parametrize("itemsize,want", [
    (4, {(1, 2048, 131072): (128, 4), (4, 2048, 2560): (32, 16)}),
    (2, {(1, 2048, 131072): (256, 4), (4, 2048, 2560): (32, 32)})])
def test_launch_plan_at_the_head_shapes(itemsize, want):
    """falcon-mamba-7b: 1,024 (fp32) / 512 (bf16) thread blocks of 512 B
    rows; RG-LRU: 320 thread blocks of 128 B / 64 B rows, the ring deep
    enough for ~4 MB in flight."""
    for (B, S, D), (C, R) in want.items():
        plan = ls.launch_plan(B, D, itemsize, N_SM)
        assert (plan["C"], plan["R"], plan["K"]) == (C, R, 4)


def kernel_walk(a, b, b0, plan):
    """The kernel's walk on the CPU, in numpy float32: thread block (bi, j)
    takes lanes d0 = j*C .. of batch row bi and steps stages of R rows in
    order, b0 (if any) read once and taken in place of b's first row in
    the first step, each step's product and sum rounded apart, h rounded
    to a's dtype as it is stored."""
    B, S, D = a.shape
    C, R = plan["C"], plan["R"]
    af, bf = a.float().numpy(), b.float().numpy()
    b0f = None if b0 is None else b0.float().numpy()
    h = torch.empty_like(a)
    for blk in range(plan["blocks"]):
        tiles = -(-D // C)
        bi, d0 = blk // tiles, (blk % tiles) * C
        cols = slice(d0, min(D, d0 + C))
        carry = np.zeros(cols.stop - d0, np.float32)
        first = bf[bi, 0, cols] if b0f is None else b0f[bi, cols]
        out = np.empty((S, cols.stop - d0), np.float32)
        for s0 in range(0, S, R):
            sa = af[bi, s0:s0 + R, cols]
            sb = bf[bi, s0:s0 + R, cols]
            for r in range(sa.shape[0]):
                bv = first if s0 + r == 0 else sb[r]
                carry = np.add(np.multiply(sa[r], carry), bv)
                out[s0 + r] = carry
        h[bi, :, cols] = torch.from_numpy(out).to(a.dtype)
    return h


@pytest.mark.parametrize("B,S,D", [(2, 256, 512), (1, 128, 1024), (4, 512, 64),
                                   (3, 37, 1001)])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_kernel_walk_is_bit_equal_to_plain(B, S, D, with_h0, dt):
    (ja, jb, jh0), (ta, tb, th0) = _inputs(B, S, D, with_h0, dt)
    b0 = None if th0 is None else ls.fold_h0(ta, tb, th0)
    # the card's plan, and one with wider tiles and a shallower stage
    plans = [ls.launch_plan(B, D, ta.element_size(), N_SM),
             dict(C=32 * 16 // ta.element_size(), R=5, K=2,
                  blocks=B * -(-D // (32 * 16 // ta.element_size())))]
    want = ls.linear_scan_plain(ta, tb, b0)
    for plan in plans:
        h = kernel_walk(ta, tb, b0, plan)
        assert torch.equal(h, want), plan
    tol = DTYPES[dt][2]
    # the interpret-mode kernel tiles D and S evenly: a ragged D is one tile
    wh, _ = ref_linear_scan(ja, jb, jh0, block_d=64 if D % 64 == 0 else D,
                            block_s=64 if S % 64 == 0 else S)
    assert_close(h, wh, tol, tol, "walk vs interpret-mode kernel")
    f32 = [None if x is None else x.astype(jnp.float32) for x in (ja, jb, jh0)]
    rh, _ = jax_ref(*f32)
    assert_close(h, rh, tol, tol, "walk vs the JAX oracle")


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,D", [(3, 37, 1001), (1, 1, 1), (2, 5, 3)])
def test_wrapper_takes_an_odd_pitch(B, S, D, dt):
    """Every pitch is taken: rows of D * size bytes that are not a
    multiple of 16 arrive as the 16-byte chunks that hold them, in tile
    rows 16 B wider."""
    a, b = torch.zeros((B, S, D), dtype=dt), torch.zeros((B, S, D), dtype=dt)
    ls.check_inputs(a, b, torch.zeros((B, D), dtype=dt))
    ls.check_inputs(a, b)
    plan = ls.launch_plan(B, D, a.element_size(), N_SM)
    assert plan["blocks"] == B * -(-D // plan["C"])
    assert plan["smem"] == ls.ring_bytes(plan["C"], plan["R"], plan["K"],
                                         a.element_size(), aligned=False)


@pytest.mark.parametrize("case", ["rank", "shape", "b0 shape", "mixed dtype",
                                  "float16", "strided", "strided b0"])
def test_wrapper_refuses_what_it_refused(case):
    a = torch.zeros((2, 5, 8))
    b, b0, err = a.clone(), torch.zeros((2, 8)), ValueError
    if case == "rank":
        a = b = a[0]
    elif case == "shape":
        b = torch.zeros((2, 5, 9))
    elif case == "b0 shape":
        b0 = torch.zeros((2, 9))
    elif case == "mixed dtype":
        b, err = b.bfloat16(), TypeError
    elif case == "float16":
        a, b, b0, err = a.half(), b.half(), b0.half(), TypeError
    elif case == "strided":
        b = torch.zeros((2, 8, 5)).transpose(1, 2)
    else:
        b0 = torch.zeros((8, 2)).t()
    with pytest.raises(err):
        ls.check_inputs(a, b, b0)
