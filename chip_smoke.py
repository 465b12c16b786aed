#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports nothing of
JAX or of the JAX package.  Phases (any failure exits non-zero):

  0. the card's name and power limit (nvidia-smi), torch and CUDA versions
  1. build every kernel from ``src/repro_torch`` (one nvcc per source, in
     parallel): B1 (unified evaluator), B2 (per-block network), B3 (grid
     network), B4 (crossbar MAC), B5 (flash attention), B6 (linear scan);
     ptxas registers / shared memory / spills (B1's kernel per mode and
     geometry and B3's per geometry on lines of their own, beside their
     dynamic shared memory; B2's beside B3's, and the thread blocks of
     B2 the card keeps resident, which B2's tile rule spreads N over);
     the tensor-core
     instructions (HMMA, HGMMA) in each library's SASS, which B4 and B5
     must have
  2. the emulator kernels against their plain PyTorch versions on the
     card, fp32 with TF32 off, at small shapes (ragged tiles, CASE_A and
     CASE_B, plain and conditioned periph widths; B1 in both modes, given
     the plan's g_norm, which its kernel folds into the per-plan
     precompute itself, with passes of rows cut short and one row a tile;
     B3 likewise: M = R + 1 and one row a tile; B2 with passes of one
     block, tiles that are not whole passes, P = 0, 2, 15 and 40) and at
     the full-width gemma3-1b MLP shapes; outputs compared at rtol 1e-4 /
     atol 1e-5
  3. the emulator lifecycle at the paper's sizes through the port's
     quickstart: label the Table 1 dataset (50,000 + 5,000 CASE_A blocks)
     with the circuit solver, train a Conv4Xbar on it (B2 evaluates the
     test set), save it; then the serving CLI on gemma3-1b at full width,
     depth cut to 2 layers, MLP projections on that trained emulator (B1,
     which must run without a host-side ``blocklast_precompute``); plus
     the analog matmul on the card against the port's CPU path
  4. B1's times at full-width ``mlp.up`` and ``mlp.down`` (CUDA events)
     beside the least time the card could take; B1's bf16 mode driven
     through the dispatcher at the same shapes, held against its plain
     version (rtol 1e-4 / atol 1e-5; its max abs error, by design 0, is
     printed) and against the fp32 mode (atol 5e-2), timed, and failed if
     its call builds the per-plan precompute on the host
  5. the paper's headline: time per CASE_A block for the circuit solver,
     the analytic model, the plain network and B2, at 2,048 and 65,536
     blocks; B2's kernel alone (weights packed once) and its whole call
     (the host's weight pack, checks, launch), in turns
  6. the executor's slow path: the reference bench protocol (16 x 512 @
     512 x 32, calibrated) per backend (circuit, analytic, emulator slow
     path = B3, emulator fast path = B1); full-width ``mlp.up`` through
     B3 against B1 at rtol 2e-4 / atol 1e-5; a conditioned net given
     scenario features through B2; B3's kernel alone (weights packed
     once) and its whole call, in turns, each with its share of the bound
  7. the kernels' own entry points, each launched through its ``ops``
     function at full model widths and at a ragged shape, fp32 and bf16:
     B4 ``xbar_mac`` (gemma3-1b's ``mlp.up``/``mlp.down`` as one crossbar
     MAC), B5 ``flash_attention`` (gemma3-1b's global and local layers,
     recurrentgemma-2b's local layers), B6 ``linear_scan`` (falcon-mamba-
     7b's selective-scan state, recurrentgemma-2b's RG-LRU, and ragged
     shapes with h0, one of an odd row pitch, D = 1001); B4 and B5 held
     against their plain versions (fp32 rtol 1e-4 / atol 1e-5, bf16 rtol
     1e-2 / atol 1e-2), B6 bit for bit (``torch.equal``); each timed
     beside its bound and, where one PyTorch call computes the same
     function, that call (``library_ms``, timed in turns with the kernel,
     the median of 7 event pairs each) and the ratio to it; B4's and B5's
     fp32 rows, which run as 3xTF32, carry a bound at three TF32 passes
     beside the one at fp32's CUDA-core rate; B6's rows carry, timed in
     turns, the kernel alone (on b0 folded once), the call (the h0 fold
     included) and ``torch.add(a, b, out=h)`` (``copy_ms``: what the card
     achieves for the same traffic, no library call for the scan)
  8. a JSON ``kernels`` line, then the card line, then the result line.
     The B2, B3 and B6 rows' ``ms`` is the kernel alone (B2, B3 on weights
     packed once); their ``call_ms`` is the whole call a user makes, which
     also packs the weights on the host (B2, B3) or folds h0 (B6).  Every
     other row's ``ms`` is the call.
"""
from __future__ import annotations

import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RTOL, ATOL = 1e-4, 1e-5
BF16_RTOL, BF16_ATOL = 1e-2, 1e-2     # bf16 outputs: about one bf16 ulp
B1_BF16_ATOL = 5e-2          # B1 bf16 mode vs fp32 mode (ROADMAP B1 gate)
SLOW_RTOL, SLOW_ATOL = 2e-4, 1e-5     # slow path vs fast path (reference's)
HBM_BYTES_S = 3.35e12        # H100 SXM HBM3
FP32_FLOP_S = 67e12          # H100 SXM fp32 outside the tensor cores
BF16_FLOP_S = 989e12         # H100 SXM dense bf16 on the tensor cores
TF32X3_FLOP_S = 495e12 / 3   # fp32 as three TF32 tensor-core products
GEMMA = dict(d_model=1152, d_ff=6912)
# the emulator's training budget on the card: 50 epochs on the Table 1
# set, lr 2e-3 halved at the quickstart's points stretched to 50 epochs
# (about 80 s on an H100 with the labelling; the paper trains 2,000
# epochs, see PERF.md)
TRAIN = dict(n_train=50_000, n_test=5_000, epochs=50, lr_halve_at=(31, 44))
# B3's phase-2 cases: (label, geometry name, P, M, NB, NO, block_m); R =
# D*W rows a pass (8 under CASE_A, 16 under CASE_B), so M = R + 1 ends on a
# pass of one row, and block_m = 1 gives every tile a single row
B3_CASES = [
    ("A P=2 M%bm", "A", 2, 5, 3, 7, 2), ("A no periph", "A", 0, 3, 2, 4, None),
    ("B P=15 M%bm", "B", 15, 5, 2, 5, 3), ("B P=2", "B", 2, 130, 1, 3, None),
    ("A P=0 M=R+1", "A", 0, 9, 2, 3, None), ("B P=2 M=R+1", "B", 2, 17, 2, 2, None),
    ("A P=15 M=13 bm=1", "A", 15, 13, 2, 2, 1),
    ("B P=0 M=13 bm=1", "B", 0, 13, 1, 3, 1)]
# B2's phase-2 cases: (label, geometry name, P, N, block_n); R = D*W blocks
# a pass (8 under CASE_A, 16 under CASE_B): N = 1, 9 and 17 end on a pass
# of one block; block_n 3, 7 and 32 and the default rule's tiles (N = 5,000
# and 65,536) are not whole passes; N = 3,001 with block_n 3 launches more
# thread blocks than the card keeps resident; P = 40 reads periph features
# past one warp's 32
B2_CASES = [
    ("A P=2 N%bn", "A", 2, 1001, 32), ("A no periph", "A", 0, 64, None),
    ("A P=15", "A", 15, 77, 8), ("B P=2 N%bn", "B", 2, 515, 16),
    ("B P=15 (>48 KB smem)", "B", 15, 300, None),
    ("A P=2 N=1", "A", 2, 1, None), ("A P=0 N=9", "A", 0, 9, None),
    ("B P=15 N=17", "B", 15, 17, None), ("A P=15 N=37 bn=3", "A", 15, 37, 3),
    ("B P=2 N=100 bn=7", "B", 2, 100, 7), ("A P=2 N=3001 bn=3", "A", 2, 3001, 3),
    ("A P=40 N=50", "A", 40, 50, None), ("A P=2 N=5000", "A", 2, 5000, None),
    ("B P=15 N=5000", "B", 15, 5000, None), ("A P=2 N=65536", "A", 2, 65536, None)]
# B2's kernel per geometry, as ptxas names its template instances
B2_TEMPLATES = {"CASE_A": "block_warp_kernelILi4ELi2ELi1E",
                "CASE_B": "block_warp_kernelILi2ELi8ELi4E"}
# B1's kernel per geometry and mode, as ptxas names its template instances
B1_TEMPLATES = {"CASE_A": "fused_kernelILi4ELi2ELi1E",
                "CASE_B": "fused_kernelILi2ELi8ELi4E"}
B1_MODES = {"fp32": "Lb0E", "bf16": "Lb1E"}
# B3's kernel per geometry, as ptxas names its template instances
B3_TEMPLATES = {"CASE_A": "grid_warp_kernelILi4ELi2ELi1E",
                "CASE_B": "grid_warp_kernelILi2ELi8ELi4E"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def rand_params(geom, n_periph, seed, dev):
    """Conv4Xbar params from ``seed`` on ``dev``, with nonzero biases so
    that every bias path is exercised."""
    import torch
    from repro_torch.core import conv4xbar
    from repro_torch.models.common import init_params
    p = init_params(seed, conv4xbar.conv4xbar_schema(geom, n_periph), device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(11 + seed)
    for k in p:
        if k.endswith("_b"):
            p[k] = 0.1 * torch.randn(p[k].shape, generator=g, device=dev)
    return p


def unified_work(M, NB, NO, D, W, O, flat, shift, bf16=False):
    """(bytes, GEMM operations, other operations) the unified block
    evaluator must move and do for one call: every input read once, the
    output written once; an FMA counts 2, an expm1 (inside CELU) 1, a bias
    starts its accumulator (as ``net_flops`` counts).  The GEMM operations
    are the products of the stage-1 window contraction, the tail stages,
    the W-stage and the FC head (bf16 operands in the bf16 mode).  The
    kernel reads the plan's g_norm and stage 0's weights and computes the
    per-plan precompute once per block (g0's multiply and add, celu0's
    expm1, the y0 product and bias), in both modes; ``bf16``: the y0
    product, whose operands stay fp32 in the bf16 mode, counts with the
    other operations."""
    G, K1, C0, O1 = 32, 2, 16, 8
    nblk = NB * NO
    P = D * W * G
    n_in = 2 * M * NB * D * G * K1                       # u, pos
    n_pre = nblk * P * K1 + 2 * C0 + O1                  # g_norm, w0g, b0, b1
    n_w = (C0 + K1 * C0 * O1 + 32 * 4 + 4 + 32 * 32 + 32 + 64 * 32 + 32
           + flat * 32 + 32 + 32 * 16 + 16 + 16 * O + O)
    n_sh = 0 if shift is None else shift.numel()
    n_out = 2 * M * nblk * O
    nbytes = 4 * (n_in + n_pre + n_w + n_sh + n_out)
    taps = P * K1
    wo = 1 if W <= 2 else W // 2
    gemm = taps * 2 * C0 * O1 + 2 * (
        (P // 4) * 2 * 32 * 4 + (P // 32) * 2 * 32 * 32 + D * wo * 2 * 64 * 32
        + 2 * flat * 32 + 2 * 32 * 16 + 2 * 16 * O)
    # per tap: u*w0v + g0 (FMA), expm1, - celu0; the rail mask's product
    # and two sums; per position: y0 + each rail, the rail difference, two
    # expm1; per rail the tail's expm1s and the optional fc0 shift
    other = taps * (4 * C0 + 3 * O1) + P * 5 * O1 + 2 * (
        (P // 4) * 4 + (P // 32) * 32 + D * wo * 32 + 32
        + (32 if shift is not None else 0) + 16)
    gemm_fold = nblk * P * K1 * C0 * O1 * 2
    other_fold = nblk * (taps * C0 * 3 + P * O1)
    if bf16:
        gemm_fold, other_fold = 0, other_fold + gemm_fold
    return (nbytes, M * nblk * gemm + gemm_fold,
            M * nblk * other + other_fold)


def net_layers(geom, P):
    """(outputs, multiply-adds per output) of each layer of the
    paper-faithful network (B2/B3): stage 0 first, fc2 last."""
    D, H, W, O = geom.tiles, geom.rows, geom.cols, geom.outputs
    wo = 1 if W <= 2 else W // 2
    return [(D * H * W * 16, 2), (D * (H // 2) * W * 8, 32),
            (D * (H // 8) * W * 4, 32), (D * (H // 64) * W * 32, 32),
            (D * wo * 32, 64), (32, D * wo * 32 + P), (16, 32), (O, 16)]


def net_flops(geom, P):
    """fp32 operations of one network evaluation on its own (B2): per
    output element 2 per multiply-add, the bias being the accumulator's
    start, and 1 for CELU's expm1 (every layer but fc2)."""
    layers = net_layers(geom, P)
    (n_out, k_out) = layers[-1]
    return sum(n * (2 * k + 1) for n, k in layers[:-1]) + n_out * 2 * k_out


def net_weight_floats(geom, P):
    D, W, O = geom.tiles, geom.cols, geom.outputs
    flat = D * (1 if W <= 2 else W // 2) * 32
    return (16 * 3 + 2 * 16 * 8 + 8 + 32 * 4 + 4 + 32 * 32 + 32 + 64 * 32 + 32
            + (flat + P) * 32 + 32 + 32 * 16 + 16 + 16 * O + O)


def block_work(geom, N, P):
    """(bytes, operations) of one B2 call on N blocks."""
    feat = 2 * geom.tiles * geom.rows * geom.cols
    nbytes = 4 * (N * (feat + P + geom.outputs) + net_weight_floats(geom, P))
    return nbytes, N * net_flops(geom, P)


def grid_work(geom, M, NB, NO, P):
    """(bytes, operations) of one B3 call: the drive and the shared
    conductances read once, the (M, NB*NO, O) output written once."""
    D, H, W, O = geom.tiles, geom.rows, geom.cols, geom.outputs
    nbytes = 4 * (M * NB * D * H + NB * NO * D * H * W + M * NB * NO * O
                  + net_weight_floats(geom, P))
    # stage 0's conductance term w0g*g + b0 is the same for every row of a
    # block: one FMA per stage-0 output per block; each row then adds
    # w0v*v (one FMA) and takes the expm1, 3 operations where a network
    # on its own spends 2*2 + 1
    n0 = net_layers(geom, P)[0][0]
    per_row = net_flops(geom, P) - n0 * (2 * 2 + 1) + n0 * 3
    return nbytes, M * NB * NO * per_row + NB * NO * n0 * 2


def bound_ms(nbytes, *work):
    """The least time the card could take: the larger of the bytes over
    the memory rate and each (operations, peak rate) pair's time; the
    pairs' units may run at once, so their times do not add."""
    tb = nbytes / HBM_BYTES_S * 1e3
    to = max((ops / peak * 1e3 for ops, peak in work), default=0.0)
    return (tb, "bytes") if tb >= to else (to, "operations")


def cuda_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def paired_ms(fns, iters, reps=7, warmup=2):
    """Median time of each of ``fns`` over ``reps`` event pairs of
    ``iters`` calls each, the functions taking turns within a rep: a
    stall of the card or the host weighs on one pair, not on a whole
    reading, and not on one function more than another."""
    import statistics
    import torch
    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    pairs = [[] for _ in fns]
    for _ in range(reps):
        for fn, ps in zip(fns, pairs):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(iters):
                fn()
            b.record()
            ps.append((a, b))
    torch.cuda.synchronize()
    return [statistics.median(a.elapsed_time(b) / iters for a, b in ps)
            for ps in pairs]


def host_ms(fn, iters, warmup=1):
    """Host clock around calls that end in a synchronize (a whole matmul
    through the executor, host work included)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def compare(label, got, want, rtol=RTOL, atol=ATOL):
    """Hold ``got`` against ``want``; print, fail on disagreement, return
    the max abs error."""
    import torch
    if got.shape != want.shape:
        fail(f"[{label}] shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = (got - want).abs()
    mabs = float(err.max()) if err.numel() else 0.0
    rel = float((err / want.abs().clamp_min(1e-30)).max()) if err.numel() else 0.0
    # the largest share of its allowance (atol + rtol * |want|) an element uses
    use = float((err / (atol + rtol * want.abs())).max()) if err.numel() else 0.0
    ok = bool((err <= atol + rtol * want.abs()).all()) and bool(
        torch.isfinite(got).all())
    print(f"[kernel vs plain] {label}: max_abs={mabs:.3e} max_rel={rel:.3e} "
          f"gate use {use:.2f} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"[{label}] disagrees beyond rtol {rtol} / atol {atol}")
    return mabs


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        fail(f"the port's package src/repro_torch is missing next to {__file__}")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    BF16 = torch.bfloat16
    t_start = time.perf_counter()

    # ---- phase 0 --------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    print(card, flush=True)

    from repro_torch.configs.rram_ps32 import CASE_A, CASE_B
    from repro_torch.configs.base import AnalogConfig
    from repro_torch.core import conv4xbar
    from repro_torch.core.analog import AnalogExecutor
    from repro_torch.core.crossbar import build_conductance_plan
    from repro_torch.interop import save_emulator_npz
    from repro_torch.kernels import _build
    from repro_torch.kernels.emulator_block import emulator_block as eb
    from repro_torch.kernels.emulator_block.ops import emulator_block_unified
    from repro_torch.models.common import init_params

    # ---- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] {len(built)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for src, (lib, log) in built.items():
        print(f"[build] {src.name} -> {lib.name}", flush=True)
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill",
                                       "error")):
                print(f"[build]   {line.strip()}", flush=True)
    b1_src = next(src for src in built if src.name == "emulator_block_unified.cu")
    b1_stats = ptxas_stats(built[b1_src][1])
    for gid, name in enumerate(("CASE_A", "CASE_B")):
        for mode, dt in (("fp32", torch.float32), ("bf16", BF16)):
            stats = [v for k, v in b1_stats.items()
                     if B1_TEMPLATES[name] + B1_MODES[mode] in k]
            print(f"[build] B1 fused_kernel {mode} {name}: "
                  f"{stats[0] if stats else 'no ptxas output (library cached)'}"
                  f"; dynamic shared memory {eb.unified_smem_bytes(gid, dt)} B",
                  flush=True)
    b3_src = next(src for src in built if src.name == "emulator_block.cu")
    b3_stats = ptxas_stats(built[b3_src][1])
    for name, geom in (("CASE_A", CASE_A), ("CASE_B", CASE_B)):
        for kid, templates, smem in (
                ("B2 block_warp_kernel", B2_TEMPLATES,
                 f"{eb.block_smem_bytes(geom, 2)} B at P=2"),
                ("B3 grid_warp_kernel", B3_TEMPLATES,
                 f"{eb.grid_smem_bytes(geom)} B")):
            stats = [v for k, v in b3_stats.items() if templates[name] in k]
            print(f"[build] {kid} {name}: "
                  f"{stats[0] if stats else 'no ptxas output (library cached)'}"
                  f"; dynamic shared memory {smem}", flush=True)
    for geom in (CASE_A, CASE_B):
        for P in (0, 2, 15):
            print(f"[build] B2 dynamic shared memory {geom.name} P={P}: "
                  f"{eb.block_smem_bytes(geom, P)} B; resident thread blocks "
                  f"(the runtime's occupancy x SMs) {eb.block_slots(geom, P, dev)}",
                  flush=True)
    tensor_core_counts(built)
    fa = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
    for D in (64, 128, 256):
        print(f"[build] B5 dynamic shared memory D={D}: fp32 "
              f"{fa.smem_bytes(D)} B, bf16 {fa.smem_bytes(D, BF16)} B",
              flush=True)

    # ---- phase 2: kernel vs plain ---------------------------------------
    acfg = AnalogConfig(enabled=True, backend="emulator", layers=("mlp",))
    nets = {}

    def net(geom, n_periph):
        key = (geom.name, n_periph)
        if key not in nets:
            p = rand_params(geom, n_periph, 7 + n_periph, dev)
            nets[key] = (p, conv4xbar.blocklast_weights(p, geom))
        return nets[key]

    def inputs(geom, K, N, M, seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        w = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
        x = torch.randn((M, K), generator=g, device=dev)
        plan = build_conductance_plan(w, acfg, geom)
        ex = AnalogExecutor(acfg, geom=geom, emulator_params={})
        xs = x.abs().max()
        u = plan.tile_v(ex._drive01(x.abs() / xs), 1.0).contiguous()
        pos = plan.tile_v((x > 0).float(), 1.0).contiguous()
        return plan, u, pos

    cases = [  # (label, geom, n_periph, K, N, M, block_m, shift)
        ("A ideal M%bm", CASE_A, 0, 300, 3, 5, 2, None),
        ("A flat shift", CASE_A, 15, 256, 4, 3, None, "flat"),
        ("A block shift", CASE_A, 15, 200, 5, 6, 4, "block"),
        ("B ideal", CASE_B, 0, 200, 10, 5, 3, None),
        ("B block shift", CASE_B, 15, 130, 12, 4, None, "block"),
        ("mlp.up M=4", CASE_A, 0, GEMMA["d_model"], GEMMA["d_ff"], 4, None, None),
        ("mlp.up M=128", CASE_A, 0, GEMMA["d_model"], GEMMA["d_ff"], 128, None, None),
        ("mlp.down M=4", CASE_A, 0, GEMMA["d_ff"], GEMMA["d_model"], 4, None, None),
        ("mlp.down M=128", CASE_A, 0, GEMMA["d_ff"], GEMMA["d_model"], 128, None, None),
        # B1 passes R = D*W/2 rows (4 under CASE_A, 8 under CASE_B)
        ("A ideal M=9 bm=1", CASE_A, 0, 150, 3, 9, 1, None),
        ("B flat shift M=R+1", CASE_B, 15, 130, 5, 9, None, "flat"),
    ]
    max_abs = {"B1": 0.0, "B1 bf16": 0.0, "B2": 0.0, "B3": 0.0}
    timed = {}
    for i, (label, geom, npf, K, N, M, bm, sh) in enumerate(cases):
        params, aux = net(geom, npf)
        plan, u, pos = inputs(geom, K, N, M, 100 + i)
        gn = plan.g_norm.contiguous()
        shift = None
        if sh is not None:
            f = aux["fcs"][0][0].shape[1]
            g = torch.Generator(device=dev)
            g.manual_seed(200 + i)
            shp = (f,) if sh == "flat" else (plan.n_blocks, f)
            shift = 0.2 * torch.randn(shp, generator=g, device=dev)
        got = eb.emulator_block_unified_cuda(aux, gn, u, pos, shift=shift,
                                             block_m=bm)
        torch.cuda.synchronize()
        want = eb.emulator_block_unified_plain(aux, gn, u, pos, shift=shift)
        torch.cuda.synchronize()
        max_abs["B1"] = max(max_abs["B1"], compare(
            f"B1 {label}: NB={plan.NB} NO={plan.NO} M={M}", got, want))
        if not label.startswith("mlp."):    # bf16 mode: full widths in phase 4
            got = eb.emulator_block_unified_cuda(aux, gn, u, pos, shift=shift,
                                                 block_m=bm, compute_dtype=BF16)
            torch.cuda.synchronize()
            want = eb.emulator_block_unified_plain(aux, gn, u, pos, shift=shift,
                                                   compute_dtype=BF16)
            max_abs["B1 bf16"] = max(max_abs["B1 bf16"], compare(
                f"B1 bf16 mode {label}: NB={plan.NB} NO={plan.NO} M={M}", got,
                want))
        if label.startswith("mlp."):
            timed[(label.split()[0], M)] = (aux, gn, u, pos, plan)
        del got, want
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev)
    gen.manual_seed(300)
    for label, gname, P, N, bn in B2_CASES:
        geom = {"A": CASE_A, "B": CASE_B}[gname]
        p = rand_params(geom, P, 20 + P, dev)
        x = torch.rand((N,) + geom.chw, generator=gen, device=dev)
        per = torch.rand((N, P), generator=gen, device=dev) * 2 - 1 if P else None
        got = eb.emulator_block_cuda(p, x, per, geom, block_n=bn)
        torch.cuda.synchronize()
        want = eb.emulator_block_plain(p, x, per)
        max_abs["B2"] = max(max_abs["B2"], compare(f"B2 {label}", got, want))
        del x, got, want
    for label, gname, P, M, NB, NO, bm in B3_CASES:
        geom = {"A": CASE_A, "B": CASE_B}[gname]
        p = rand_params(geom, P, 30 + P, dev)
        v = torch.rand((M, NB, geom.tiles, geom.rows), generator=gen, device=dev)
        gn = torch.rand((NB * NO,) + geom.chw[1:], generator=gen, device=dev)
        got = eb.emulator_block_grid_cuda(p, v, gn, geom, block_m=bm)
        torch.cuda.synchronize()
        want = eb.emulator_block_grid_plain(p, v, gn, geom)
        max_abs["B3"] = max(max_abs["B3"], compare(f"B3 {label}", got, want))
    p_grid = rand_params(CASE_A, 2, 32, dev)
    for (tag, M), (_, _, u, _, plan) in sorted(timed.items()):
        if M != 4:
            continue
        # the slow path's operands: both rails stacked (2M rows), g_norm
        v = torch.cat([u, u.flip(0)]).contiguous()
        gn = plan.g_norm.reshape(plan.n_blocks, plan.D, plan.rows, 2 * plan.no)
        got = eb.emulator_block_grid_cuda(p_grid, v, gn.contiguous(), CASE_A)
        torch.cuda.synchronize()
        want = eb.emulator_block_grid_plain(p_grid, v, gn, CASE_A)
        max_abs["B3"] = max(max_abs["B3"], compare(
            f"B3 {tag} M=4 (8 rail rows): NB={plan.NB} NO={plan.NO}", got, want))
        del got, want
    torch.cuda.empty_cache()

    # ---- phase 3: the emulator lifecycle, then serve the trained net ----
    from repro_torch.launch import quickstart, serve
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    npz = build / "chip_smoke_conv4xbar_a.npz"
    eb.emulator_block_cuda.launches = 0
    qs = quickstart.main([
        "--seed", "0", "--n-train", str(TRAIN["n_train"]),
        "--n-test", str(TRAIN["n_test"]), "--epochs", str(TRAIN["epochs"]),
        "--lr-halve-at", *[str(e) for e in TRAIN["lr_halve_at"]],
        "--save-npz", str(npz)])
    b2_launches = eb.emulator_block_cuda.launches
    res = qs["result"]
    n_lab = qs["n_labelled"]
    print(f"[lifecycle] circuit solver labelled {n_lab} CASE_A blocks in "
          f"{qs['label_s']:.3f} s ({n_lab / qs['label_s']:.0f} blocks/s) [{card}]",
          flush=True)
    print(f"[lifecycle] trained {TRAIN['epochs']} epochs on {TRAIN['n_train']} "
          f"blocks in {qs['train_s']:.1f} s: test MSE {res.test_mse:.4e} V^2, "
          f"MAE {res.test_mae * 1e3:.3f} mV, Thm 4.1 bound {res.bound:.3e}, "
          f"sig_prob {res.sig_prob:.4f}, accepted {res.accepted} [{card}]",
          flush=True)
    print(f"[lifecycle] calibrated 4x128 @ 128x8 emulator matmul vs digital: "
          f"corr {qs['corr']:.4f}; B2 launches {b2_launches}", flush=True)
    if not (np_isfinite(res.test_mse) and np_isfinite(res.test_mae)):
        fail("non-finite emulator test error")
    if not res.history["test"][-1] < res.history["test"][0]:
        fail(f"training did not lower the test MSE: {res.history['test']}")
    want_b2 = len(res.history["epoch"]) + 1      # logged epochs + final eval
    if b2_launches != want_b2:
        fail(f"B2 launched {b2_launches} times in training, expected {want_b2}")
    trained, test_mse = res.params, res.test_mse
    del qs, res
    torch.cuda.empty_cache()

    # the fp32 fast path folds the precompute into B1: count any host-side
    # build of it while serving
    pre_calls = [0]
    host_precompute = conv4xbar.blocklast_precompute

    def counted_precompute(*a, **k):
        pre_calls[0] += 1
        return host_precompute(*a, **k)

    conv4xbar.blocklast_precompute = counted_precompute
    eb.emulator_block_unified_cuda.launches = 0
    sess, out = serve.main([
        "--arch", "gemma3-1b", "--layers", "2", "--batch", "4",
        "--prompt-len", "32", "--gen", "8", "--seed", "0",
        "--analog-backend", "emulator", "--emulator-params", str(npz)])
    b1_launches = eb.emulator_block_unified_cuda.launches
    conv4xbar.blocklast_precompute = host_precompute
    if pre_calls[0]:
        fail(f"serving built the per-plan precompute on the host "
             f"{pre_calls[0]} times (B1's fp32 kernel folds it in)")
    n_fwd = 1 + (8 - 1)
    want_launches = 3 * 2 * n_fwd
    cfg = sess.cfg
    print(f"[serve] {cfg.name}: d_model={cfg.d_model} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} layers={cfg.num_layers} sites="
          f"{len(sess.sites())} trained emulator {npz.name}, kernel launches="
          f"{b1_launches}, host-side precompute builds {pre_calls[0]}",
          flush=True)
    if (cfg.d_model, cfg.d_ff, cfg.vocab_size) != (1152, 6912, 262144):
        fail("serve did not run gemma3-1b at full width")
    if b1_launches != want_launches:
        fail(f"kernel launched {b1_launches} times in serving, expected "
             f"{want_launches} (3 projections x 2 layers x {n_fwd} forwards)")
    if not np_isfinite(out["logits"]):
        fail("non-finite logits")
    if out["tokens"].shape != (4, 8):
        fail(f"tokens shape {out['tokens'].shape} != (4, 8)")
    pre_ms, dec_ms = out["prefill_s"] * 1e3, out["decode_s"] * 1e3
    print(f"[serve] prefill 4x32: {pre_ms:.1f} ms ({4 * 32 / out['prefill_s']:.1f} "
          f"tok/s); decode 7 steps: {dec_ms:.1f} ms "
          f"({4 * 7 / out['decode_s']:.1f} tok/s) [{card}]", flush=True)
    del sess, out
    torch.cuda.empty_cache()

    # small-input agreement: the analog matmul through the kernel on the
    # card vs the port's CPU path (the path the CPU tests hold against the
    # JAX package)
    p_cpu = init_params(3, conv4xbar.conv4xbar_schema(CASE_A), device="cpu")
    g = torch.Generator().manual_seed(5)
    w = torch.randn((200, 24), generator=g) * 0.1
    x = torch.randn((6, 200), generator=g)
    ys = []
    for d in ("cpu", dev):
        ex = AnalogExecutor(acfg, geom=CASE_A, emulator_params={
            k: v.to(d) for k, v in p_cpu.items()})
        ys.append(ex.matmul(x.to(d), w.to(d), "mlp.check").cpu())
    rel = float((ys[1] - ys[0]).abs().max() / ys[0].abs().max())
    print(f"[serve] analog matmul card vs CPU path: max rel err {rel:.3e}",
          flush=True)
    if not rel < 1e-4:
        fail("analog matmul on the card disagrees with the CPU path")

    # ---- phase 4: B1 times; B1's bf16 mode ---------------------------------
    b1_shapes, b1_bf16_shapes = [], []
    b1_bf16_launches, bf16_vs_f32 = 0, 0.0
    pre_calls[0] = 0
    for (tag, M), (aux, gn, u, pos, plan) in sorted(timed.items()):
        nbytes, gemm, other = unified_work(M, plan.NB, plan.NO, plan.D,
                                           2 * plan.no, 1, 128, None)
        bms, by = bound_ms(nbytes, (gemm + other, FP32_FLOP_S))
        ms = cuda_ms(lambda: eb.emulator_block_unified_cuda(aux, gn, u, pos),
                     iters=10 if M <= 8 else 5)
        pms = cuda_ms(lambda: eb.emulator_block_unified_plain(aux, gn, u, pos),
                      iters=3 if M <= 8 else 1, warmup=1)
        b1_shapes.append(dict(shape=f"{tag} K={plan.K} N={plan.N} M={M}", ms=ms,
                              plain_ms=pms, bound_ms=bms, bound_by=by,
                              bytes=nbytes, flops=gemm + other, peak="fp32"))
        print(f"[time] B1 {tag} M={M}: kernel {ms:.3f} ms (the precompute "
              f"folded in), plain {pms:.3f} ms, bound {bms:.3f} ms ({by}: "
              f"{nbytes / 1e9:.3f} GB, {(gemm + other) / 1e9:.2f} GFLOP at "
              f"fp32) [{card}]", flush=True)
        # the bf16 mode through the dispatcher, as a caller asks for it;
        # any host-side build of the precompute is counted
        nbytes, gemm, other = unified_work(M, plan.NB, plan.NO, plan.D,
                                           2 * plan.no, 1, 128, None,
                                           bf16=True)

        def bf16_call():
            conv4xbar.blocklast_precompute = counted_precompute
            try:
                return emulator_block_unified(aux, gn, u, pos,
                                              compute_dtype=BF16)
            finally:
                conv4xbar.blocklast_precompute = host_precompute

        eb.emulator_block_unified_cuda.launches = 0
        got = bf16_call()
        torch.cuda.synchronize()
        b1_bf16_launches += eb.emulator_block_unified_cuda.launches
        want = eb.emulator_block_unified_plain(aux, gn, u, pos,
                                               compute_dtype=BF16)
        max_abs["B1 bf16"] = max(max_abs["B1 bf16"], compare(
            f"B1 bf16 mode {tag} M={M}", got, want))
        f32 = eb.emulator_block_unified_cuda(aux, gn, u, pos)
        d = compare(f"B1 bf16 mode vs fp32 mode {tag} M={M}", got, f32, 0.0,
                    B1_BF16_ATOL)
        bf16_vs_f32 = max(bf16_vs_f32, d)
        del got, want, f32
        bms, by = bound_ms(nbytes, (gemm, BF16_FLOP_S), (other, FP32_FLOP_S))
        ms = cuda_ms(bf16_call, iters=10 if M <= 8 else 5)
        pms = cuda_ms(lambda: eb.emulator_block_unified_plain(
            aux, gn, u, pos, compute_dtype=BF16), iters=3 if M <= 8 else 1,
            warmup=1)
        b1_bf16_shapes.append(dict(
            shape=f"{tag} K={plan.K} N={plan.N} M={M} bf16 mode", ms=ms,
            plain_ms=pms, bound_ms=bms, bound_by=by, bytes=nbytes,
            flops=gemm + other, peak="GEMM bf16, the rest fp32"))
        print(f"[time] B1 bf16 mode {tag} M={M}: kernel {ms:.3f} ms (the "
              f"precompute folded in), plain {pms:.3f} ms, bound {bms:.3f} ms "
              f"({by}: {nbytes / 1e9:.3f} GB; "
              f"{gemm / 1e9:.2f} GFLOP GEMM at bf16, {other / 1e9:.2f} GFLOP "
              f"other at fp32) [{card}]", flush=True)
    print(f"[B1 bf16] launches through the dispatcher {b1_bf16_launches}; max "
          f"|bf16 mode - fp32 mode| {bf16_vs_f32:.4e} (gate {B1_BF16_ATOL}); "
          f"max |kernel - plain| {max_abs['B1 bf16']:.3e} (gate rtol {RTOL} "
          f"/ atol {ATOL}; 0 by design); host-side precompute builds "
          f"{pre_calls[0]}", flush=True)
    if b1_bf16_launches != len(timed):
        fail(f"B1's bf16 mode launched {b1_bf16_launches} times for "
             f"{len(timed)} dispatcher calls")
    if pre_calls[0]:
        fail(f"B1's bf16 mode built the per-plan precompute on the host "
             f"{pre_calls[0]} times (its kernel folds it in)")
    up_plan = timed[("mlp.up", 4)][4]
    down_plan = timed[("mlp.down", 4)][4]
    del timed
    torch.cuda.empty_cache()

    # ---- phase 5: the paper's headline, per block --------------------------
    from repro_torch.core.analytic import analytic_block_response
    from repro_torch.core.circuit import CircuitParams, block_response
    from repro_torch.core.emulator import normalize_features, sample_block_inputs
    cp = CircuitParams()
    b2_shapes = []
    per_block = {}
    for N in (2048, 65536):
        gb = torch.Generator(device=dev)
        gb.manual_seed(N)
        xr, per = sample_block_inputs(gb, N, CASE_A, acfg)
        xn = normalize_features(xr, acfg).contiguous()
        per = per.contiguous()
        it = 5 if N <= 2048 else 2
        routes = {
            "circuit": lambda: block_response(xr, cp, per),
            "analytic": lambda: analytic_block_response(xr, cp, per),
            "plain apply": lambda: eb.emulator_block_plain(trained, xn, per),
            "B2": lambda: eb.emulator_block_cuda(trained, xn, per, CASE_A),
        }
        row = {name: cuda_ms(fn, iters=it, warmup=1) for name, fn in routes.items()}
        # B2's kernel alone (the weights packed once) and its whole call
        # (pack, checks, launch), in turns
        pk = eb.pack_block_weights(trained, CASE_A)
        b2_kernel, b2_call = paired_ms(
            [lambda: eb.launch_block(pk, xn, per, CASE_A), routes["B2"]],
            iters=20 if N <= 2048 else 5)
        if N == 2048:
            # the repo's own structural check (tests/test_system.py): a
            # trained emulator tracks the circuit on its training
            # distribution
            yc, ye = routes["circuit"]().ravel(), routes["B2"]().ravel()
            corr_ce = float(torch.corrcoef(torch.stack([yc, ye]))[0, 1])
            print(f"[headline] circuit vs trained emulator (B2) on {N} fresh "
                  f"blocks: circuit |V| mean {float(yc.abs().mean()) * 1e3:.3f} "
                  f"mV; emulator MAE {float((ye - yc).abs().mean()) * 1e3:.3f} "
                  f"mV, corr {corr_ce:.4f}", flush=True)
            if test_mse <= 1.5e-3 and not corr_ce > 0.8:
                fail(f"the trained emulator tracks the circuit at corr {corr_ce:.3f}")
        per_block[N] = {k: v * 1e3 / N for k, v in row.items()}     # us/block
        nbytes, flops = block_work(CASE_A, N, 2)
        bms, by = bound_ms(nbytes, (flops, FP32_FLOP_S))
        b2_shapes.append(dict(shape=f"CASE_A N={N} P=2", ms=b2_kernel,
                              call_ms=b2_call, plain_ms=row["plain apply"],
                              bound_ms=bms, bound_by=by, bytes=nbytes,
                              flops=flops, bound_share=bms / b2_kernel))
        print(f"[headline] N={N} CASE_A blocks, us per block: " + ", ".join(
            f"{k} {v:.5f}" for k, v in per_block[N].items())
            + f"; circuit / B2 = {row['circuit'] / row['B2']:.1f}x (the call), "
            f"{row['circuit'] / b2_kernel:.1f}x (the kernel alone) [{card}]",
            flush=True)
        print(f"[time] B2 N={N}: kernel {b2_kernel:.4f} ms, call (pack, "
              f"checks, launch) {b2_call:.4f} ms, plain "
              f"{row['plain apply']:.3f} ms, bound {bms:.4f} ms ({by}: "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
              f"{100 * bms / b2_kernel:.1f}% of the bound [{card}]", flush=True)
        del xr, xn, per, routes, pk
        torch.cuda.empty_cache()

    # ---- phase 6: the executor's slow path ----------------------------------
    import dataclasses
    eb.emulator_block_grid_cuda.launches = 0
    b3_calls = 0
    gs = torch.Generator(device=dev)
    gs.manual_seed(0)
    w = torch.randn((512, 32), generator=gs, device=dev) * 0.2
    xin = torch.randn((16, 512), generator=gs, device=dev) * 0.5
    xc = torch.randn((256, 512), generator=gs, device=dev) * 0.5
    y_dig = xin @ w
    y_circ = None
    base = AnalogConfig()
    for name, backend, fast in (("circuit", "circuit", True),
                                ("analytic", "analytic", True),
                                ("emulator slow path (B3)", "emulator", False),
                                ("emulator fast path (B1)", "emulator", True)):
        ex = AnalogExecutor(dataclasses.replace(base, backend=backend),
                            geom=CASE_A, cp=cp, fast_path=fast,
                            emulator_params=trained if backend == "emulator"
                            else None)
        ex.calibrate(xc, w, "bench")
        iters = 3
        ms = host_ms(lambda: ex.matmul(xin, w, "bench"), iters=iters)
        y = ex.matmul(xin, w, "bench")
        if backend == "emulator" and not fast:
            b3_calls += 1 + 1 + iters + 1      # calibrate, warm-up, timed, last
        corr = float(torch.corrcoef(torch.stack([y.ravel(), y_dig.ravel()]))[0, 1])
        if y_circ is None:
            y_circ = y
        corr_c = float(torch.corrcoef(torch.stack([y.ravel(), y_circ.ravel()]))[0, 1])
        print(f"[slow path] bench (16, 512) @ (512, 32) {name}: corr with "
              f"digital {corr:.4f}, with the circuit backend {corr_c:.4f}, "
              f"{ms:.3f} ms per calibrated matmul [{card}]", flush=True)
        # nonlinear hardware: correlated with the digital product, not
        # equal to it (tests/test_system.py's bound for the physical models)
        if not (corr > 0.3 if backend != "emulator" else corr == corr):
            fail(f"{name} correlates {corr:.3f} with digital")
    # the trained emulator against the circuit on the bench matmul's own
    # blocks (both rails, ideal periph), next to the training
    # distribution of phase 5
    ex = AnalogExecutor(base, geom=CASE_A, cp=cp, emulator_params=trained)
    plan = build_conductance_plan(w, base, CASE_A)
    rails = torch.cat([xin.clamp_min(0), (-xin).clamp_min(0)])
    xb = plan.build_x(plan.tile_v(ex._drive01(rails / xin.abs().max()),
                                  base.v_read))
    per = torch.tensor([1.0, 0.0], device=dev).expand(xb.shape[0], 2).contiguous()
    yc = block_response(xb, cp, per).ravel()
    ye = eb.emulator_block_cuda(trained, normalize_features(xb, base).contiguous(),
                                per, CASE_A).ravel()
    corr_b = float(torch.corrcoef(torch.stack([yc, ye]))[0, 1])
    print(f"[slow path] bench blocks ({xb.shape[0]}): circuit |V| mean "
          f"{float(yc.abs().mean()) * 1e3:.3f} mV; trained emulator MAE "
          f"{float((ye - yc).abs().mean()) * 1e3:.3f} mV, corr {corr_b:.4f}",
          flush=True)
    b3_shapes = []
    slow_err = 0.0
    for tag, K, N in (("mlp.up", GEMMA["d_model"], GEMMA["d_ff"]),):
        g = torch.Generator(device=dev)
        g.manual_seed(400)
        w = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
        slow = AnalogExecutor(acfg, geom=CASE_A, emulator_params=trained,
                              fast_path=False)
        fast = AnalogExecutor(acfg, geom=CASE_A, emulator_params=trained)
        for M in (4, 128):
            x = torch.randn((M, K), generator=g, device=dev)
            ys, _ = slow.raw_matmul(x, w, tag)
            b3_calls += 1
            yf, _ = fast.raw_matmul(x, w, tag)
            torch.cuda.synchronize()
            slow_err = max(slow_err, compare(
                f"slow path (B3) vs fast path (B1) {tag} M={M}", ys, yf,
                SLOW_RTOL, SLOW_ATOL))
            del ys, yf
    b3_launches = eb.emulator_block_grid_cuda.launches
    print(f"[slow path] B3 launches {b3_launches}, slow-path emulator calls "
          f"{b3_calls}", flush=True)
    if b3_launches != b3_calls:
        fail(f"B3 launched {b3_launches} times for {b3_calls} slow-path calls")

    # a conditioned net given scenario features takes B2 with its periph
    pc = rand_params(CASE_A, 15, 50, dev)
    sfeat = 0.5 * torch.randn(13, generator=gs, device=dev)
    w = torch.randn((200, 6), generator=gs, device=dev) * 0.1
    x = torch.randn((3, 200), generator=gs, device=dev)
    cond = []
    for d in (dev, "cpu"):
        n2, n3 = eb.emulator_block_cuda.launches, eb.emulator_block_grid_cuda.launches
        ex = AnalogExecutor(acfg, geom=CASE_A, fast_path=False,
                            emulator_params={k: v.to(d) for k, v in pc.items()})
        cond.append(ex.raw_matmul(x.to(d), w.to(d), "cond", sfeat=sfeat.to(d))[0])
        if d == dev and (eb.emulator_block_cuda.launches - n2,
                         eb.emulator_block_grid_cuda.launches - n3) != (1, 0):
            fail("a conditioned net with scenario features did not take B2")
    compare("conditioned slow path with sfeat (B2) card vs CPU", cond[0].cpu(),
            cond[1], 1e-4, 1e-6)

    # B3 times at the slow path's full-width shapes
    for tag, plan in (("mlp.up", up_plan), ("mlp.down", down_plan)):
        gn = plan.g_norm.reshape(plan.n_blocks, plan.D, plan.rows,
                                 2 * plan.no).contiguous()
        for M in (4, 128):
            rows = 2 * M
            v = torch.rand((rows, plan.NB, plan.D, plan.rows), generator=gs,
                           device=dev)
            nbytes, flops = grid_work(CASE_A, rows, plan.NB, plan.NO, 2)
            bms, by = bound_ms(nbytes, (flops, FP32_FLOP_S))
            pk = eb.pack_grid_weights(trained, CASE_A)
            ms, call_ms = paired_ms(
                [lambda: eb.launch_grid(pk, v, gn, CASE_A),
                 lambda: eb.emulator_block_grid_cuda(trained, v, gn, CASE_A)],
                iters=5 if M <= 8 else 2, reps=5, warmup=1)
            pms = None
            if M <= 8:
                pms = cuda_ms(lambda: eb.emulator_block_grid_plain(
                    trained, v, gn, CASE_A), iters=1, warmup=1)
            b3_shapes.append(dict(shape=f"{tag} K={plan.K} N={plan.N} M={M} "
                                  f"({rows} rail rows)", ms=ms,
                                  call_ms=call_ms, plain_ms=pms,
                                  bound_ms=bms, bound_by=by, bytes=nbytes,
                                  flops=flops, bound_share=bms / ms))
            print(f"[time] B3 {tag} M={M} ({rows} rail rows): kernel {ms:.3f} ms, "
                  f"call (pack, checks, launch) {call_ms:.3f} ms, "
                  f"plain {'not timed' if pms is None else f'{pms:.3f} ms'}, "
                  f"bound {bms:.3f} ms ({by}: {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.1f} GFLOP), {100 * bms / ms:.1f}% of the "
                  f"bound [{card}]", flush=True)
    torch.cuda.empty_cache()

    # ---- phase 7: the kernels' own entry points ---------------------------
    t7 = time.perf_counter()
    b4, b5, b6 = entry_points_phase(dev, card)
    print(f"[entry points] phase 7 took {time.perf_counter() - t7:.1f} s",
          flush=True)

    # ---- phase 8: the kernels line ---------------------------------------
    ebk = "emulator_block/emulator_block.py:"
    b1_head = next(r for r in b1_shapes if r["shape"].startswith("mlp.up")
                   and r["shape"].endswith(" M=4"))
    b1_bf16_head = next(r for r in b1_bf16_shapes if r["shape"].startswith(
        "mlp.up") and r["shape"].endswith(" M=4 bf16 mode"))
    src = "emulator_block/csrc/"
    kernels = [
        entry("emulator_block_unified", src + "emulator_block_unified.cu",
              ebk + "295", b1_launches, max_abs["B1"], b1_head, b1_shapes),
        entry("emulator_block_unified (bf16 mode)",
              src + "emulator_block_unified.cu", ebk + "295", b1_bf16_launches,
              max_abs["B1 bf16"], b1_bf16_head, b1_bf16_shapes),
        entry("emulator_block", src + "emulator_block.cu", ebk + "182",
              b2_launches, max_abs["B2"], b2_shapes[-1], b2_shapes),
        entry("emulator_block_grid", src + "emulator_block.cu", ebk + "137",
              b3_launches, max_abs["B3"], b3_shapes[0], b3_shapes),
        b4, b5, b6,
    ]
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def ptxas_stats(log):
    """``kernel -> "registers, spills"`` from an ``-Xptxas -v`` log."""
    import re
    stats, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = m.group(1)
            continue
        if kernel and ("registers" in line or "spill" in line):
            stats[kernel] = (stats.get(kernel, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return stats


def tensor_core_counts(built):
    """Print the count of tensor-core instructions (HMMA, HGMMA) in each
    built library's SASS; fail if B4's or B5's library has none."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for src, (lib, _) in built.items():
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=300)
        if sass.returncode != 0:
            fail(f"cuobjdump -sass {lib.name} failed: {sass.stderr.strip()}")
        # as grep -cE 'HMMA|HGMMA' counts them: lines that hold either
        counts[src.stem] = sum(1 for line in sass.stdout.splitlines()
                               if "HMMA" in line or "HGMMA" in line)
        print(f"[build] {lib.name}: {counts[src.stem]} tensor-core "
              f"instructions (HMMA|HGMMA) in its SASS", flush=True)
    for stem in ("xbar_mac", "flash_attention"):
        if not counts.get(stem):
            fail(f"{stem}'s library has no tensor-core instruction")


def entry(name, source, replaces, launches, err, head, shapes):
    """One kernel's record of the ``kernels`` line: ``source`` under the
    port's kernels, ``replaces`` under the JAX package's; ``head`` is the
    shape whose numbers stand at the top level."""
    row = {"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/" + source,
           "replaces": "src/repro/kernels/" + replaces, "launches": launches,
           "max_abs_err": err, "ms": head["ms"], "plain_ms": head["plain_ms"],
           "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
           "library_ms": head.get("library_ms"), "shapes": shapes}
    if "call_ms" in head:         # ms is the kernel alone, call_ms the call
        row["call_ms"] = head["call_ms"]
    if "copy_ms" in head:         # B6's yardstick: torch.add(a, b, out=h)
        row["copy_ms"] = head["copy_ms"]
    return row


def attention_pairs(S, causal, window):
    """Unmasked (query, key) pairs of one head of length S."""
    import numpy as np
    q = np.arange(S)
    hi = q + 1 if causal else np.full(S, S)                   # keys k < hi
    lo = np.maximum(0, q - window + 1) if window else np.zeros(S, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def entry_points_phase(dev, card):
    """Phase 7: B4, B5 and B6 launched through their ``ops`` entry points
    at full model widths and at a ragged shape, fp32 and bf16, with the
    launch counts set to 0 just before each call and read just after;
    each output held against the plain version, then timed.  Returns the
    three kernels' records for the ``kernels`` line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.linear_scan.ops import linear_scan
    from repro_torch.kernels.xbar_mac.ops import xbar_mac
    xm = importlib.import_module("repro_torch.kernels.xbar_mac.xbar_mac")
    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    lsm = importlib.import_module("repro_torch.kernels.linear_scan.linear_scan")
    gen = torch.Generator(device=dev)
    gen.manual_seed(700)
    dtypes = (("fp32", torch.float32, RTOL, ATOL, FP32_FLOP_S),
              ("bf16", torch.bfloat16, BF16_RTOL, BF16_ATOL, BF16_FLOP_S))

    def shape_row(shape, dname, ms, pms, lms, nbytes, ops, peak,
                  fp32_rate=None, **extra):
        """One timed shape, with its ratio to the library call where there
        is one.  ``fp32_rate``: the rate the kernel's fp32 mode runs its
        products at (3xTF32 for B4 and B5); the fp32 row's bound is taken
        at that rate, with the one at fp32's CUDA-core rate beside it."""
        tf32x3 = fp32_rate is not None and dname == "fp32"
        rate = fp32_rate if tf32x3 else peak
        bms, by = bound_ms(nbytes, (ops, rate))
        note = ""
        if tf32x3:
            extra["bound_rate"] = "3xTF32, 495/3 = 165 TFLOP/s"
            extra["bound_ms_fp32_cores"] = bound_ms(nbytes, (ops, peak))[0]
            note = (f"; at fp32's CUDA-core {peak / 1e12:.0f} TFLOP/s "
                    f"{extra['bound_ms_fp32_cores']:.4f} ms")
        if lms is not None:
            extra["vs_library"] = ms / lms
            note += f"; kernel / library {ms / lms:.2f}x"
        print(f"[time] {shape} {dname}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
              f"library {'none' if lms is None else f'{lms:.4f} ms'}, bound "
              f"{bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} "
              f"GFLOP at {rate / 1e12:.0f} TFLOP/s{note}) [{card}]", flush=True)
        return dict(shape=shape, dtype=dname, ms=ms, plain_ms=pms,
                    library_ms=lms, bound_ms=bms, bound_by=by, bytes=nbytes,
                    flops=ops, peak_tflop_s=rate / 1e12, **extra)

    # -- B4: a gemma3-1b MLP projection as one nonlinear crossbar MAC ------
    d_model, d_ff = GEMMA["d_model"], GEMMA["d_ff"]
    cases = [("ragged", 100, 70, 130),
             ("ragged, split K, element-wise staging", 5, 1001, 77),
             ("ragged, split K", 100, d_model, 1000),
             ("gemma3-1b mlp.up", 4, d_model, d_ff),
             ("gemma3-1b mlp.up", 128, d_model, d_ff),
             ("gemma3-1b mlp.up", 2048, d_model, d_ff),
             ("gemma3-1b mlp.down", 128, d_ff, d_model)]
    launches, err, shapes = 0, 0.0, []
    for dname, dt, rtol, atol, peak in dtypes:
        for label, M, K, N in cases:
            # v ~ U(0, 0.2) drives relu(v - 0.08) * (1 + 0.6 v) = 0.0395 on
            # average; g ~ U(0, g_hi) puts gain * acc / v_sat near 0.8, in
            # tanh's working range rather than its saturation
            v = (0.2 * torch.rand((M, K), generator=gen, device=dev)).to(dt)
            g_hi = 2 * 0.8 / (3200.0 * K * 0.0395)
            g = (g_hi * torch.rand((K, N), generator=gen, device=dev)).to(dt)
            xm.xbar_mac_cuda.launches = 0
            got = xbar_mac(v, g)
            torch.cuda.synchronize()
            launches += xm.xbar_mac_cuda.launches
            want = xm.xbar_mac_plain(v, g)
            shape = f"B4 {label} ({M}, {K}) @ ({K}, {N})"
            plan = xm.launch_plan(M, K, N)
            if dname == "fp32":
                print(f"[B4] {shape}: launch plan {plan}", flush=True)
            err = max(err, compare(f"{shape} {dname}", got.float(), want.float(),
                                   rtol, atol))
            vf = v.float()
            drive = torch.clamp_min(vf - 0.08, 0.0) * (1.0 + 0.6 * vf)
            med = float((3200.0 * (drive @ g.float())).abs().median())
            print(f"[B4] {shape} {dname}: median |gain * acc / v_sat| {med:.3f}",
                  flush=True)
            it = 20 if M * K * N < 1e9 else 5
            dl = drive.to(dt)
            ms, lms = paired_ms([lambda: xbar_mac(v, g),
                                 lambda: torch.matmul(dl, g)], iters=it)
            pms = cuda_ms(lambda: xm.xbar_mac_plain(v, g), iters=it)
            shapes.append(shape_row(
                shape, dname, ms, pms, lms,
                (M * K + K * N + M * N) * v.element_size(),
                2 * M * K * N + 5 * M * K + 4 * M * N, peak,
                fp32_rate=TF32X3_FLOP_S,
                median_gain_acc=med, plan=plan,
                library="torch.matmul(drive, g): cuBLAS, the product alone"))
            del v, g, got, want, drive, dl
    head = next(r for r in shapes if r["shape"].startswith("B4 gemma3-1b mlp.up "
                                                           "(128,")
                and r["dtype"] == "fp32")
    b4 = entry("xbar_mac", "xbar_mac/csrc/xbar_mac.cu", "xbar_mac/xbar_mac.py:36",
               launches, err, head, shapes)
    torch.cuda.empty_cache()

    # -- B5: attention of gemma3-1b and recurrentgemma-2b at full width ----
    cases = [("gemma3-1b global", 4, 4096, 256, True, 0),
             ("gemma3-1b local", 4, 4096, 256, True, 512),
             ("recurrentgemma-2b local", 10, 4096, 256, True, 2048),
             ("ragged bidirectional", 2, 1000, 100, False, 0),
             ("ragged window", 3, 333, 64, True, 100)]
    launches, err, shapes = 0, 0.0, []
    for dname, dt, rtol, atol, peak in dtypes:
        for label, H, S, D, causal, window in cases:
            q, k, v = (torch.randn((1, H, S, D), generator=gen, device=dev).to(dt)
                       for _ in range(3))
            fa.flash_attention_cuda.launches = 0
            got = flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            launches += fa.flash_attention_cuda.launches
            flat = [t.reshape(H, S, D) for t in (q, k, v)]
            want = fa.flash_attention_plain(*flat, causal=causal, window=window)
            shape = (f"B5 {label} H={H} S={S} D={D} causal={causal} "
                     f"window={window}")
            err = max(err, compare(f"{shape} {dname}", got.reshape(H, S, D).float(),
                                   want.float(), rtol, atol))
            del got, want
            it = 5 if S >= 4096 else 20
            pms = cuda_ms(lambda: fa.flash_attention_plain(
                *flat, causal=causal, window=window),
                iters=2, warmup=1)
            if window:
                qi = torch.arange(S, device=dev)[:, None]
                ki = torch.arange(S, device=dev)[None, :]
                band = (qi - ki) < window
                if causal:
                    band &= ki <= qi
                sdpa = dict(attn_mask=band)
            else:
                sdpa = dict(is_causal=causal)
            ms, lms = paired_ms(
                [lambda: flash_attention(q, k, v, causal=causal, window=window),
                 lambda: F.scaled_dot_product_attention(q, k, v, **sdpa)],
                iters=it)
            del sdpa
            pairs = H * attention_pairs(S, causal, window)
            shapes.append(shape_row(
                shape, dname, ms, pms, lms, 4 * H * S * D * q.element_size(),
                4 * D * pairs, peak, fp32_rate=TF32X3_FLOP_S, pairs=pairs,
                library="F.scaled_dot_product_attention (causal flag or a "
                        "boolean band mask)"))
            del q, k, v, flat
    head = next(r for r in shapes if r["shape"].startswith("B5 gemma3-1b global")
                and r["dtype"] == "fp32")
    b5 = entry("flash_attention", "flash_attention/csrc/flash_attention.cu",
               "flash_attention/flash_attention.py:65", launches, err, head,
               shapes)
    torch.cuda.empty_cache()

    # -- B6: falcon-mamba-7b's selective-scan state, recurrentgemma's RG-LRU
    # (D = 1001: a row pitch that is not a multiple of 16 B, whose rows the
    # kernel copies as the 16-byte chunks that hold them)
    cases = [("falcon-mamba-7b selective scan", 1, 2048, 8192 * 16, False),
             ("falcon-mamba-7b selective scan", 1, 2048, 8192 * 16, True),
             ("recurrentgemma-2b RG-LRU", 4, 2048, 2560, False),
             ("ragged", 3, 37, 1000, True),
             ("ragged, odd pitch", 3, 37, 1001, True)]
    launches, err, shapes = 0, 0.0, []
    for dname, dt, rtol, atol, peak in dtypes:
        for label, B, S, D, with_h0 in cases:
            a = (0.5 + 0.499 * torch.rand((B, S, D), generator=gen,
                                          device=dev)).to(dt)
            b = (0.1 * torch.randn((B, S, D), generator=gen, device=dev)).to(dt)
            h0 = (torch.randn((B, D), generator=gen, device=dev).to(dt)
                  if with_h0 else None)
            lsm.linear_scan_cuda.launches = 0
            h, h_last = linear_scan(a, b, h0)
            torch.cuda.synchronize()
            launches += lsm.linear_scan_cuda.launches
            b0 = None if h0 is None else lsm.fold_h0(a, b, h0)
            want = lsm.linear_scan_plain(a, b, b0)
            shape = f"B6 {label} B={B} S={S} D={D}{' h0' if with_h0 else ''}"
            plan = lsm._card_plan(B, D, a.element_size(), dev.index or 0)
            fill = ("tensor copies" if D * a.element_size() % 16 == 0
                    else "16-byte chunks by cp.async")
            # the gate is bit-equality: the kernel steps each lane as the
            # plain version does
            mabs = float((h.float() - want.float()).abs().max())
            equal = torch.equal(h, want)
            print(f"[kernel vs plain] {shape} {dname}: max_abs={mabs:.3e} "
                  f"bit-equal {equal}; plan C={plan['C']} R={plan['R']} "
                  f"K={plan['K']}, {plan['blocks']} thread blocks, "
                  f"{plan['smem']} B of shared memory, {fill}", flush=True)
            if not equal:
                fail(f"[{shape} {dname}] B6 is not bit-equal to its plain version")
            err = max(err, mabs)
            if not torch.equal(h_last, h[:, -1]):
                fail(f"[{shape}] h_last is not h[:, -1]")
            del h, h_last, want
            # in turns: the kernel alone (on a b0 folded once), the call
            # (the fold included), and the yardstick torch.add(a, b, out=),
            # which moves the same 3 elements per element
            it = 10 if B * S * D > 1e6 else 50
            out = torch.empty_like(a)
            ms, call_ms, copy_ms = paired_ms(
                [lambda: lsm.linear_scan_cuda(a, b, b0),
                 lambda: linear_scan(a, b, h0),
                 lambda: torch.add(a, b, out=out)], iters=it)
            pms = cuda_ms(lambda: lsm.linear_scan_plain(a, b, b0), iters=1,
                          warmup=1)
            nbytes = (3 * B * S * D + (B * D if with_h0 else 0)) * a.element_size()
            print(f"[time] {shape} {dname}: call {call_ms:.4f} ms, "
                  f"torch.add(a, b, out=) {copy_ms:.4f} ms", flush=True)
            shapes.append(shape_row(shape, dname, ms, pms, None, nbytes,
                                    2 * B * S * D, peak, call_ms=call_ms,
                                    copy_ms=copy_ms, plan=plan, fill=fill))
            del a, b, h0, b0, out
            torch.cuda.empty_cache()
    head = next(r for r in shapes if r["shape"].startswith("B6 falcon")
                and r["dtype"] == "fp32")
    b6 = entry("linear_scan", "linear_scan/csrc/linear_scan.cu",
               "linear_scan/linear_scan.py:45", launches, err, head, shapes)
    for rec in (b4, b5, b6):
        if rec["launches"] != len(rec["shapes"]):
            fail(f"{rec['name']} launched {rec['launches']} times for "
                 f"{len(rec['shapes'])} entry-point calls")
    return b4, b5, b6


def np_isfinite(a) -> bool:
    import numpy as np
    return bool(np.isfinite(a).all())


if __name__ == "__main__":
    main()
