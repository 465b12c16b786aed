#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports nothing of
JAX or of the JAX package.  Phases (any failure exits non-zero):

  0. the card's name and power limit (nvidia-smi), torch and CUDA versions
  1. build every kernel of the serving path from ``src/repro_torch``
  2. each kernel against its plain PyTorch version on the card, fp32 with
     TF32 off, at small shapes and at the full-width gemma3-1b MLP shapes;
     raw rail outputs compared at rtol 1e-4 / atol 1e-5
  3. the port's serving CLI on gemma3-1b at full width, depth cut to 2
     layers, MLP projections on the emulator backend with a Conv4Xbar
     drawn by the port's initializer: launch counts, finite logits, token
     shape; plus the analog matmul on the card against the port's CPU
     path on a small input
  4. kernel and plain-version times (CUDA events) at the main path's
     shapes beside the least time the card could take
  5. a JSON ``kernels`` line, then the card line, then the result line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RTOL, ATOL = 1e-4, 1e-5
HBM_BYTES_S = 3.35e12        # H100 SXM HBM3
FP32_FLOP_S = 67e12          # H100 SXM fp32 outside the tensor cores
GEMMA = dict(d_model=1152, d_ff=6912)


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
    lib, log = eb.build()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"[build] {line.strip()}", flush=True)

    # ---- phase 2: kernel vs plain ---------------------------------------
    acfg = AnalogConfig(enabled=True, backend="emulator", layers=("mlp",))
    nets = {}

    def net(geom, n_periph):
        key = (geom.name, n_periph)
        if key not in nets:
            p = init_params(7 + n_periph, conv4xbar.conv4xbar_schema(
                geom, n_periph), device=dev)
            g = torch.Generator(device=dev)
            g.manual_seed(11)
            for k in p:       # nonzero biases exercise every bias path
                if k.endswith("_b"):
                    p[k] = 0.1 * torch.randn(p[k].shape, generator=g,
                                             device=dev)
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
    max_abs = 0.0
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
        if got.shape != want.shape:
            fail(f"[{label}] shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = (got - want).abs()
        rel = float((err / want.abs().clamp_min(1e-30)).max())
        mabs = float(err.max())
        ok = bool((err <= ATOL + RTOL * want.abs()).all()) and bool(
            torch.isfinite(got).all())
        print(f"[kernel vs plain] {label}: NB={plan.NB} NO={plan.NO} M={M} "
              f"max_abs={mabs:.3e} max_rel={rel:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"[{label}] kernel disagrees with its plain version beyond "
                 f"rtol {RTOL} / atol {ATOL}")
        max_abs = max(max_abs, mabs)
        if label.startswith("mlp.up"):
            timed[M] = (aux, pre, u, pos, plan)
        else:
            del pre
        del got, want, err
    torch.cuda.empty_cache()

    # ---- phase 3: serve through the CLI's code ---------------------------
    from repro_torch.launch import serve
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    npz = build / "chip_smoke_conv4xbar_a.npz"
    save_emulator_npz(str(npz), init_params(0, conv4xbar.conv4xbar_schema(CASE_A),
                                            device=dev))
    eb.emulator_block_unified_cuda.launches = 0
    sess, out = serve.main([
        "--arch", "gemma3-1b", "--layers", "2", "--batch", "4",
        "--prompt-len", "32", "--gen", "8", "--seed", "0",
        "--analog-backend", "emulator", "--emulator-params", str(npz)])
    launches = eb.emulator_block_unified_cuda.launches
    n_fwd = 1 + (8 - 1)
    want_launches = 3 * 2 * n_fwd
    cfg = sess.cfg
    print(f"[serve] {cfg.name}: d_model={cfg.d_model} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} layers={cfg.num_layers} sites="
          f"{len(sess.sites())} kernel launches={launches}", flush=True)
    if (cfg.d_model, cfg.d_ff, cfg.vocab_size) != (1152, 6912, 262144):
        fail("serve did not run gemma3-1b at full width")
    if launches != want_launches:
        fail(f"kernel launched {launches} times in serving, expected "
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

    # ---- phase 4: times --------------------------------------------------
    shapes = []
    for M, (aux, pre, u, pos, plan) in sorted(timed.items()):
        nbytes, flops = unified_work(M, plan.NB, plan.NO, plan.D,
                                     2 * plan.no, 1, 128, None)
        bms, by = bound_ms(nbytes, flops)
        ms = cuda_ms(lambda: eb.emulator_block_unified_cuda(aux, pre, u, pos),
                     iters=10 if M <= 8 else 5)
        pms = cuda_ms(lambda: eb.emulator_block_unified_plain(aux, pre, u, pos),
                      iters=3 if M <= 8 else 1, warmup=1)
        shapes.append(dict(shape=f"mlp.up K=1152 N=6912 M={M}", ms=ms,
                           plain_ms=pms, bound_ms=bms, bound_by=by,
                           bytes=nbytes, flops=flops))
        print(f"[time] mlp.up M={M}: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
              f"bound {bms:.3f} ms ({by}: {nbytes / 1e9:.3f} GB, "
              f"{flops / 1e9:.1f} GFLOP) [{card}]", flush=True)
    # the per-call work around the kernel on the serving path: the
    # precompute the reference rebuilds on every call (plain PyTorch)
    aux, _, _, _, plan = timed[4]
    pre_ms = cuda_ms(lambda: conv4xbar.blocklast_precompute(aux, plan.g_norm),
                     iters=5)
    print(f"[time] mlp.up blocklast_precompute (per call, plain PyTorch): "
          f"{pre_ms:.3f} ms [{card}]", flush=True)
    head = shapes[0]
    kernels = [{
        "name": "emulator_block_unified",
        "route": "cuda",
        "source": "src/repro_torch/kernels/emulator_block/csrc/emulator_block_unified.cu",
        "replaces": "src/repro/kernels/emulator_block/emulator_block.py:295",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "shapes": shapes,
    }]
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
