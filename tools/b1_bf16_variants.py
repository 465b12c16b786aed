"""B1's bf16 mode against its variants on one CUDA card, in one process.

  python3 tools/b1_bf16_variants.py [--parent OLD.cu]

Builds, from ``src/repro_torch/kernels/emulator_block/csrc/
emulator_block_unified.cu``: the kernel as it is (the bf16 mode's CELU is
``expm1f``, the plain version's bits) and a variant with the hardware exp2
in that CELU (``__expf(x) - 1``, as the fp32 mode takes it), which is not
kept; and, given ``--parent``, an earlier B1 source whose C entry point
``emulator_block_unified_bf16(geom, u, pos, g0k, celu0k, y0, ...)`` reads
the host-built precompute.  Prints each build's ptxas lines for B1, holds
each bf16 build against the plain version at chip_smoke.py's phase-2 cases
and full-width gemma3-1b ``mlp.up`` / ``mlp.down`` (the kept kernel and the
parent must hold rtol 1e-4 / atol 1e-5; every build's max |kernel - plain|
is printed; the parent reads a precompute whose y0 comes from
``torch.matmul``, so its plain version takes that y0 too), then times
the full-width shapes at M = 4 and 128, the versions taking turns (median
of event pairs): the bf16 mode of each build (the parent with and without
building its precompute) and the fp32 mode of the kept source and of the
parent.  Needs ``nvcc`` and a card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EXPM1 = "return x > 0.f ? x : expm1f(x);"
EXP2 = "return x > 0.f ? x : __expf(x) - 1.f;"


def build(sources: dict, out_dir: Path, nvcc: str, nvcc_flags, stats) -> dict:
    """name -> library path; one nvcc per source, all started together;
    prints each B1 kernel's ptxas registers and spills."""
    procs = {}
    for name, path in sources.items():
        lib = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *nvcc_flags, "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed on {sources[name]}:\n{log}")
        for kernel, line in stats(log).items():
            if "fused_kernel" in kernel or "unified_kernel" in kernel:
                print(f"[build] {name} {kernel}: {line}", flush=True)
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    import chip_smoke as cs
    from repro_torch.configs.base import AnalogConfig
    from repro_torch.configs.rram_ps32 import CASE_A, CASE_B
    from repro_torch.core import conv4xbar
    from repro_torch.core.analog import AnalogExecutor
    from repro_torch.core.crossbar import build_conductance_plan
    from repro_torch.kernels import _build
    from repro_torch.kernels.emulator_block import emulator_block as eb
    from repro_torch.models.common import init_params

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    BF16 = torch.bfloat16
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)

    tmp = Path(tempfile.mkdtemp(prefix="b1_bf16_variants_"))
    src = eb.SOURCE.read_text()
    if src.count(EXPM1) != 1:
        sys.exit("the source's expm1f CELU is not where this tool expects it")
    (tmp / "exp2.cu").write_text(src.replace(EXPM1, EXP2))
    sources = {"kept": eb.SOURCE, "exp2": tmp / "exp2.cu"}
    if args.parent:
        sources["parent"] = args.parent
    libs = build(sources, tmp, _build._nvcc(), _build.NVCC_FLAGS,
                 cs.ptxas_stats)
    cdll = {name: ctypes.CDLL(str(lib)) for name, lib in libs.items()}
    tail_types = ([ctypes.c_int, ctypes.POINTER(eb._Weights), ctypes.c_void_p]
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    entry = {}
    for name, lib in cdll.items():
        for mode in ("f32", "bf16"):
            if name == "exp2" and mode == "f32":
                continue          # the variant changes only the bf16 mode
            fn = getattr(lib, f"emulator_block_unified_{mode}")
            n_in = 6 if (name == "parent" and mode == "bf16") else 4
            fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * n_in + tail_types
            fn.restype = ctypes.c_int
            entry[(name, mode)] = fn

    def call(name, mode, aux, gn, u, pos, shift=None, bm=None, pre=None):
        """One launch of ``name``'s kernel in ``mode``; the parent's bf16
        mode builds its precompute here unless ``pre`` is given."""
        a = eb.launch_args(aux, gn, u, pos, shift, bm)
        out = torch.empty((2, a["M"] * a["NB"] * a["NO"], a["O"]), device=dev)
        wt = eb._Weights(**{k: v.data_ptr() for k, v in a["weights"].items()})
        if name == "parent" and mode == "bf16":
            if pre is None:
                pre = conv4xbar.blocklast_precompute(aux, gn)
            ins = (pre["g0k"].data_ptr(), pre["celu0k"].data_ptr(),
                   pre["y0"].data_ptr())
        else:
            ins = (gn.data_ptr(),)
        _build.launched(entry[(name, mode)](
            a["geom"], u.data_ptr(), pos.data_ptr(), *ins,
            0 if shift is None else shift.data_ptr(), a["per_block"],
            ctypes.byref(wt), out.data_ptr(), a["M"], a["NB"], a["NO"],
            a["bm"], torch.cuda.current_stream().cuda_stream),
            f"{name} {mode}")
        return out

    def check(label, got, want, must_hold):
        err = (got - want).abs()
        allow = cs.ATOL + cs.RTOL * want.abs()
        mabs, use = float(err.max()), float((err / allow).max())
        ok = bool((err <= allow).all()) and bool(torch.isfinite(got).all())
        print(f"[kernel vs plain] {label}: max_abs={mabs:.3e} gate use "
              f"{use:.2f} {'ok' if ok else 'outside the gate'}", flush=True)
        if must_hold and not ok:
            sys.exit(f"[{label}] disagrees beyond rtol {cs.RTOL} / atol "
                     f"{cs.ATOL}")
        return mabs

    acfg = AnalogConfig(enabled=True, backend="emulator", layers=("mlp",))
    gemma = cs.GEMMA
    cases = [("A ideal M%bm", CASE_A, 0, 300, 3, 5, 2, None),
             ("A flat shift", CASE_A, 15, 256, 4, 3, None, "flat"),
             ("A block shift", CASE_A, 15, 200, 5, 6, 4, "block"),
             ("B ideal", CASE_B, 0, 200, 10, 5, 3, None),
             ("B block shift", CASE_B, 15, 130, 12, 4, None, "block"),
             ("A ideal M=9 bm=1", CASE_A, 0, 150, 3, 9, 1, None),
             ("B flat shift M=R+1", CASE_B, 15, 130, 5, 9, None, "flat")]
    cases += [(f"{t} M={M}", CASE_A, 0, K, N, M, None, None)
              for t, K, N in (("mlp.up", gemma["d_model"], gemma["d_ff"]),
                              ("mlp.down", gemma["d_ff"], gemma["d_model"]))
              for M in (4, 128)]
    worst = {name: 0.0 for name in libs}
    timed = {}
    for i, (label, geom, npf, K, N, M, bm, sh) in enumerate(cases):
        p = init_params(7 + npf, conv4xbar.conv4xbar_schema(geom, npf),
                        device=dev)
        g = torch.Generator(device=dev)
        g.manual_seed(18 + npf)
        for k in p:
            if k.endswith("_b"):
                p[k] = 0.1 * torch.randn(p[k].shape, generator=g, device=dev)
        aux = conv4xbar.blocklast_weights(p, geom)
        g.manual_seed(100 + i)
        w = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
        x = torch.randn((M, K), generator=g, device=dev)
        plan = build_conductance_plan(w, acfg, geom)
        ex = AnalogExecutor(acfg, geom=geom, emulator_params={})
        u = plan.tile_v(ex._drive01(x.abs() / x.abs().max()), 1.0).contiguous()
        pos = plan.tile_v((x > 0).float(), 1.0).contiguous()
        gn = plan.g_norm.contiguous()
        shift = None
        if sh is not None:
            shp = (32,) if sh == "flat" else (plan.n_blocks, 32)
            shift = 0.2 * torch.randn(shp, generator=g, device=dev)
        want = eb.emulator_block_unified_plain(aux, gn, u, pos, shift=shift,
                                               compute_dtype=BF16)
        for name in libs:
            ref = want
            if name == "parent":
                ref = conv4xbar.apply_blocklast(
                    aux, conv4xbar.blocklast_precompute(aux, gn), u, pos,
                    chunk=2, fc0_shift=shift, dot=eb.bf16_dot)
            got = call(name, "bf16", aux, gn, u, pos, shift, bm)
            torch.cuda.synchronize()
            worst[name] = max(worst[name], check(
                f"{name} bf16 {label}: NB={plan.NB} NO={plan.NO}", got, ref,
                must_hold=name != "exp2"))
            del got, ref
        del want
        if label.startswith("mlp."):
            timed[label] = (aux, gn, u, pos)
    print("[max |kernel - plain|, bf16 mode] " + ", ".join(
        f"{n} {e:.3e}" for n, e in worst.items()), flush=True)
    for label, (aux, gn, u, pos) in timed.items():
        it = 10 if u.shape[0] <= 8 else 3
        fns, names = [], []

        def add(tag, *a, **k):
            fns.append(lambda: call(*a, aux, gn, u, pos, **k))
            names.append(tag)

        add("kept bf16", "kept", "bf16")
        add("exp2 bf16 (not kept)", "exp2", "bf16")
        if args.parent:
            pre = conv4xbar.blocklast_precompute(aux, gn)
            add("parent bf16 call (precompute + kernel)", "parent", "bf16")
            add("parent bf16 kernel", "parent", "bf16", pre=pre)
            add("parent fp32", "parent", "f32")
        add("kept fp32", "kept", "f32")
        ms = cs.paired_ms(fns, iters=it, reps=5)
        print(f"[time] {label}: " + ", ".join(
            f"{n} {t:.3f} ms" for n, t in zip(names, ms)) + f" [{card}]",
            flush=True)


if __name__ == "__main__":
    main()
