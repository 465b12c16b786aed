#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports nothing of
JAX or of the JAX package.  Phases (any failure exits non-zero):

  0. the card's name and power limit (nvidia-smi), torch and CUDA versions
  1. build every kernel from ``src/repro_torch`` (one nvcc per source, in
     parallel): B1 (unified evaluator), B2 (per-block network), B3 (grid
     network); ptxas registers / shared memory / spills
  2. each kernel against its plain PyTorch version on the card, fp32 with
     TF32 off, at small shapes (ragged tiles, CASE_A and CASE_B, plain and
     conditioned periph widths) and at the full-width gemma3-1b MLP
     shapes; outputs compared at rtol 1e-4 / atol 1e-5
  3. the emulator lifecycle at the paper's sizes through the port's
     quickstart: label the Table 1 dataset (50,000 + 5,000 CASE_A blocks)
     with the circuit solver, train a Conv4Xbar on it (B2 evaluates the
     test set), save it; then the serving CLI on gemma3-1b at full width,
     depth cut to 2 layers, MLP projections on that trained emulator (B1);
     plus the analog matmul on the card against the port's CPU path
  4. B1's times at full-width ``mlp.up`` and ``mlp.down`` (CUDA events)
     beside the least time the card could take
  5. the paper's headline: time per CASE_A block for the circuit solver,
     the analytic model, the plain network and B2, at 2,048 and 65,536
     blocks
  6. the executor's slow path: the reference bench protocol (16 x 512 @
     512 x 32, calibrated) per backend (circuit, analytic, emulator slow
     path = B3, emulator fast path = B1); full-width ``mlp.up`` through
     B3 against B1 at rtol 2e-4 / atol 1e-5; a conditioned net given
     scenario features through B2; B2 and B3 times
  7. a JSON ``kernels`` line, then the card line, then the result line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RTOL, ATOL = 1e-4, 1e-5
SLOW_RTOL, SLOW_ATOL = 2e-4, 1e-5     # slow path vs fast path (reference's)
HBM_BYTES_S = 3.35e12        # H100 SXM HBM3
FP32_FLOP_S = 67e12          # H100 SXM fp32 outside the tensor cores
GEMMA = dict(d_model=1152, d_ff=6912)
# the emulator's training budget on the card: 50 epochs on the Table 1
# set, lr 2e-3 halved at the quickstart's points stretched to 50 epochs
# (about 80 s on an H100 with the labelling; the paper trains 2,000
# epochs, see PERF.md)
TRAIN = dict(n_train=50_000, n_test=5_000, epochs=50, lr_halve_at=(31, 44))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def unified_work(M, NB, NO, D, W, O, flat, shift):
    """(bytes, fp32 operations) the unified block evaluator must move and
    do for one call: every input read once, the output written once; an
    FMA counts 2, an expm1 (inside CELU) 1."""
    G, K1, C0, O1 = 32, 2, 16, 8
    nblk = NB * NO
    P = D * W * G
    n_in = 2 * M * NB * D * G * K1                       # u, pos
    n_pre = 2 * nblk * K1 * P * C0 + nblk * P * O1       # g0k, celu0k, y0
    n_w = (C0 + K1 * C0 * O1 + 32 * 4 + 4 + 32 * 32 + 32 + 64 * 32 + 32
           + flat * 32 + 32 + 32 * 16 + 16 + 16 * O + O)
    n_sh = 0 if shift is None else shift.numel()
    n_out = 2 * M * nblk * O
    nbytes = 4 * (n_in + n_pre + n_w + n_sh + n_out)
    taps = P * K1
    stage1 = taps * (4 * C0 + 2 * C0 * O1 + 3 * O1) + P * 5 * O1
    wo = 1 if W <= 2 else W // 2
    rail = ((P // 4) * (2 * 32 * 4 + 2 * 4) + (P // 32) * (2 * 32 * 32 + 64)
            + D * wo * (2 * 64 * 32 + 64) + 2 * flat * 32 + 64
            + (32 if shift is not None else 0) + 2 * 32 * 16 + 32
            + 2 * 16 * O + O)
    return nbytes, M * nblk * (stage1 + 2 * rail)


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


def bound_ms(nbytes, flops):
    tb, to = nbytes / HBM_BYTES_S * 1e3, flops / FP32_FLOP_S * 1e3
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
    ok = bool((err <= atol + rtol * want.abs()).all()) and bool(
        torch.isfinite(got).all())
    print(f"[kernel vs plain] {label}: max_abs={mabs:.3e} max_rel={rel:.3e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
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
    from repro_torch.kernels.emulator_block import emulator_block as eb
    from repro_torch.models.common import init_params

    # ---- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    built = eb.build_all()
    print(f"[build] {len(built)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for src, (lib, log) in built.items():
        print(f"[build] {src.name} -> {lib.name}", flush=True)
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill",
                                       "error")):
                print(f"[build]   {line.strip()}", flush=True)
    for geom in (CASE_A, CASE_B):
        for P in (0, 2, 15):
            print(f"[build] B2/B3 dynamic shared memory {geom.name} P={P}: "
                  f"{eb.block_smem_bytes(geom, P)} B", flush=True)

    # ---- phase 2: kernel vs plain ---------------------------------------
    acfg = AnalogConfig(enabled=True, backend="emulator", layers=("mlp",))
    nets = {}

    def rand_params(geom, n_periph, seed):
        p = init_params(seed, conv4xbar.conv4xbar_schema(geom, n_periph),
                        device=dev)
        g = torch.Generator(device=dev)
        g.manual_seed(11 + seed)
        for k in p:           # nonzero biases exercise every bias path
            if k.endswith("_b"):
                p[k] = 0.1 * torch.randn(p[k].shape, generator=g, device=dev)
        return p

    def net(geom, n_periph):
        key = (geom.name, n_periph)
        if key not in nets:
            p = rand_params(geom, n_periph, 7 + n_periph)
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
    ]
    max_abs = {"B1": 0.0, "B2": 0.0, "B3": 0.0}
    timed = {}
    for i, (label, geom, npf, K, N, M, bm, sh) in enumerate(cases):
        params, aux = net(geom, npf)
        plan, u, pos = inputs(geom, K, N, M, 100 + i)
        pre = conv4xbar.blocklast_precompute(aux, plan.g_norm)
        shift = None
        if sh is not None:
            f = aux["fcs"][0][0].shape[1]
            g = torch.Generator(device=dev)
            g.manual_seed(200 + i)
            shp = (f,) if sh == "flat" else (plan.n_blocks, f)
            shift = 0.2 * torch.randn(shp, generator=g, device=dev)
        got = eb.emulator_block_unified_cuda(aux, pre, u, pos, shift=shift,
                                             block_m=bm)
        torch.cuda.synchronize()
        want = eb.emulator_block_unified_plain(aux, pre, u, pos, shift=shift)
        torch.cuda.synchronize()
        max_abs["B1"] = max(max_abs["B1"], compare(
            f"B1 {label}: NB={plan.NB} NO={plan.NO} M={M}", got, want))
        if label.startswith("mlp."):
            timed[(label.split()[0], M)] = (aux, pre, u, pos, plan)
        else:
            del pre
        del got, want
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev)
    gen.manual_seed(300)
    b2_cases = [  # (label, geom, P, N, block_n)
        ("A P=2 N%bn", CASE_A, 2, 1001, 32), ("A no periph", CASE_A, 0, 64, None),
        ("A P=15", CASE_A, 15, 77, 8), ("B P=2 N%bn", CASE_B, 2, 515, 16),
        ("B P=15 (>48 KB smem)", CASE_B, 15, 300, None),
        ("A P=2 N=65536", CASE_A, 2, 65536, None)]
    for label, geom, P, N, bn in b2_cases:
        p = rand_params(geom, P, 20 + P)
        x = torch.rand((N,) + geom.chw, generator=gen, device=dev)
        per = torch.rand((N, P), generator=gen, device=dev) * 2 - 1 if P else None
        got = eb.emulator_block_cuda(p, x, per, geom, block_n=bn)
        torch.cuda.synchronize()
        want = eb.emulator_block_plain(p, x, per)
        max_abs["B2"] = max(max_abs["B2"], compare(f"B2 {label}", got, want))
        del x, got, want
    b3_cases = [  # (label, geom, P, M, NB, NO, block_m)
        ("A P=2 M%bm", CASE_A, 2, 5, 3, 7, 2), ("A no periph", CASE_A, 0, 3, 2, 4, None),
        ("B P=15 M%bm", CASE_B, 15, 5, 2, 5, 3), ("B P=2", CASE_B, 2, 130, 1, 3, None)]
    for label, geom, P, M, NB, NO, bm in b3_cases:
        p = rand_params(geom, P, 30 + P)
        v = torch.rand((M, NB, geom.tiles, geom.rows), generator=gen, device=dev)
        gn = torch.rand((NB * NO,) + geom.chw[1:], generator=gen, device=dev)
        got = eb.emulator_block_grid_cuda(p, v, gn, geom, block_m=bm)
        torch.cuda.synchronize()
        want = eb.emulator_block_grid_plain(p, v, gn, geom)
        max_abs["B3"] = max(max_abs["B3"], compare(f"B3 {label}", got, want))
    p_grid = rand_params(CASE_A, 2, 32)
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

    eb.emulator_block_unified_cuda.launches = 0
    sess, out = serve.main([
        "--arch", "gemma3-1b", "--layers", "2", "--batch", "4",
        "--prompt-len", "32", "--gen", "8", "--seed", "0",
        "--analog-backend", "emulator", "--emulator-params", str(npz)])
    b1_launches = eb.emulator_block_unified_cuda.launches
    n_fwd = 1 + (8 - 1)
    want_launches = 3 * 2 * n_fwd
    cfg = sess.cfg
    print(f"[serve] {cfg.name}: d_model={cfg.d_model} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} layers={cfg.num_layers} sites="
          f"{len(sess.sites())} trained emulator {npz.name}, kernel launches="
          f"{b1_launches}", flush=True)
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

    # ---- phase 4: B1 times -------------------------------------------------
    b1_shapes = []
    for (tag, M), (aux, pre, u, pos, plan) in sorted(timed.items()):
        nbytes, flops = unified_work(M, plan.NB, plan.NO, plan.D,
                                     2 * plan.no, 1, 128, None)
        bms, by = bound_ms(nbytes, flops)
        ms = cuda_ms(lambda: eb.emulator_block_unified_cuda(aux, pre, u, pos),
                     iters=10 if M <= 8 else 5)
        pms = cuda_ms(lambda: eb.emulator_block_unified_plain(aux, pre, u, pos),
                      iters=3 if M <= 8 else 1, warmup=1)
        b1_shapes.append(dict(shape=f"{tag} K={plan.K} N={plan.N} M={M}", ms=ms,
                              plain_ms=pms, bound_ms=bms, bound_by=by,
                              bytes=nbytes, flops=flops))
        print(f"[time] B1 {tag} M={M}: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
              f"bound {bms:.3f} ms ({by}: {nbytes / 1e9:.3f} GB, "
              f"{flops / 1e9:.1f} GFLOP) [{card}]", flush=True)
    for tag in ("mlp.up", "mlp.down"):
        aux, _, _, _, plan = timed[(tag, 4)]
        pre_ms = cuda_ms(lambda: conv4xbar.blocklast_precompute(aux, plan.g_norm),
                         iters=5)
        print(f"[time] {tag} blocklast_precompute (per call, plain PyTorch): "
              f"{pre_ms:.3f} ms [{card}]", flush=True)
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
        bms, by = bound_ms(nbytes, flops)
        b2_shapes.append(dict(shape=f"CASE_A N={N} P=2", ms=row["B2"],
                              plain_ms=row["plain apply"], bound_ms=bms,
                              bound_by=by, bytes=nbytes, flops=flops))
        print(f"[headline] N={N} CASE_A blocks, us per block: " + ", ".join(
            f"{k} {v:.5f}" for k, v in per_block[N].items())
            + f"; circuit / B2 = {row['circuit'] / row['B2']:.1f}x [{card}]",
            flush=True)
        print(f"[time] B2 N={N}: kernel {row['B2']:.3f} ms, plain "
              f"{row['plain apply']:.3f} ms, bound {bms:.4f} ms ({by}: "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) [{card}]",
              flush=True)
        del xr, xn, per, routes
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
    pc = rand_params(CASE_A, 15, 50)
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
            bms, by = bound_ms(nbytes, flops)
            ms = cuda_ms(lambda: eb.emulator_block_grid_cuda(trained, v, gn, CASE_A),
                         iters=5 if M <= 8 else 2, warmup=1)
            pms = None
            if M <= 8:
                pms = cuda_ms(lambda: eb.emulator_block_grid_plain(
                    trained, v, gn, CASE_A), iters=1, warmup=1)
            b3_shapes.append(dict(shape=f"{tag} K={plan.K} N={plan.N} M={M} "
                                  f"({rows} rail rows)", ms=ms, plain_ms=pms,
                                  bound_ms=bms, bound_by=by, bytes=nbytes,
                                  flops=flops))
            print(f"[time] B3 {tag} M={M} ({rows} rail rows): kernel {ms:.3f} ms, "
                  f"plain {'not timed' if pms is None else f'{pms:.3f} ms'}, "
                  f"bound {bms:.3f} ms ({by}: {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.1f} GFLOP) [{card}]", flush=True)
    torch.cuda.empty_cache()

    # ---- phase 7: the kernels line ---------------------------------------
    src = "src/repro_torch/kernels/emulator_block/csrc/"
    ref = "src/repro/kernels/emulator_block/emulator_block.py:"

    def entry(name, source, replaces, launches, err, head, shapes):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": ref + replaces, "launches": launches,
                "max_abs_err": err, "ms": head["ms"],
                "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"], "library_ms": None,
                "shapes": shapes}

    b1_head = next(r for r in b1_shapes if r["shape"].startswith("mlp.up")
                   and r["shape"].endswith(" M=4"))
    kernels = [
        entry("emulator_block_unified", "emulator_block_unified.cu", "295",
              b1_launches, max_abs["B1"], b1_head, b1_shapes),
        entry("emulator_block", "emulator_block.cu", "182", b2_launches,
              max_abs["B2"], b2_shapes[-1], b2_shapes),
        entry("emulator_block_grid", "emulator_block.cu", "137", b3_launches,
              max_abs["B3"], b3_shapes[0], b3_shapes),
    ]
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def np_isfinite(a) -> bool:
    import numpy as np
    return bool(np.isfinite(a).all())


if __name__ == "__main__":
    main()
