"""B1's fp32 kernel against its variants on one CUDA card, in one process.

  python3 tools/b1_fp32_variants.py [--parent OLD.cu]

Builds, from ``src/repro_torch/kernels/emulator_block/csrc/
emulator_block_unified.cu``: the kernel as it is (every CELU of the fp32
kernel from the hardware exp2), a variant with ``expm1f`` in that CELU,
and, given ``--parent``, an earlier B1 source with the two-mode C entry
point ``emulator_block_unified(geom, bf16, u, pos, g0k, celu0k, y0, ...)``
that reads the host-built precompute.  Holds each against the plain
version at chip_smoke.py's phase-2 cases (rtol 1e-4 / atol 1e-5), then
times full-width gemma3-1b ``mlp.up`` / ``mlp.down`` at M = 4 and 128,
the versions taking turns (median of event pairs); the parent is timed
with and without building its precompute.  Needs ``nvcc`` and a card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EXP2 = "return x > 0.f ? x : __expf(x) - 1.f;"
EXPM1 = "return x > 0.f ? x : expm1f(x);"


def build(sources: dict, out_dir: Path, nvcc: str, nvcc_flags) -> dict:
    """name -> library path; one nvcc per source, all started together."""
    procs = {}
    for name, path in sources.items():
        lib = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *nvcc_flags, "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if "fused_kernel" in line or ("unified_kernel" in line
                                          and "Lb0E" in line):
                print(f"[build] {name}: {line.strip()[:160]}", flush=True)
            elif "registers" in line or "spill" in line or "error" in line:
                print(f"[build] {name}:   {line.strip()}", flush=True)
        if proc.returncode:
            sys.exit(f"nvcc failed on {sources[name]}:\n{log}")
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
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)

    tmp = Path(tempfile.mkdtemp(prefix="b1_variants_"))
    src = eb.SOURCE.read_text()
    if src.count(EXP2) != 1:
        sys.exit("the source's exp2 CELU is not where this tool expects it")
    (tmp / "expm1f.cu").write_text(src.replace(EXP2, EXPM1))
    sources = {"exp2": eb.SOURCE, "expm1f": tmp / "expm1f.cu"}
    if args.parent:
        sources["parent"] = args.parent
    libs = build(sources, tmp, _build._nvcc(), _build.NVCC_FLAGS)

    def use(name):
        eb._LIB.pop("unified", None)
        _build._LOADED[eb.SOURCE] = ctypes.CDLL(str(libs[name]))
        eb._library()

    parent = None
    if args.parent:
        parent = ctypes.CDLL(str(libs["parent"])).emulator_block_unified
        parent.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                           + [ctypes.c_int, ctypes.POINTER(eb._Weights),
                              ctypes.c_void_p] + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
        parent.restype = ctypes.c_int

    def parent_call(aux, gn, u, pos, shift=None, pre=None):
        a = eb.launch_args(aux, gn, u, pos, shift)
        if pre is None:
            pre = conv4xbar.blocklast_precompute(aux, gn)
        out = torch.empty((2, a["M"] * a["NB"] * a["NO"], a["O"]), device=dev)
        # the parent's Weights struct is this one's first 14 fields
        wt = eb._Weights(**{k: v.data_ptr() for k, v in a["weights"].items()})
        _build.launched(parent(
            a["geom"], 0, u.data_ptr(), pos.data_ptr(), pre["g0k"].data_ptr(),
            pre["celu0k"].data_ptr(), pre["y0"].data_ptr(),
            0 if shift is None else shift.data_ptr(), a["per_block"],
            ctypes.byref(wt), out.data_ptr(), a["M"], a["NB"], a["NO"],
            a["bm"], torch.cuda.current_stream().cuda_stream), "parent")
        return out

    acfg = AnalogConfig(enabled=True, backend="emulator", layers=("mlp",))
    gemma = cs.GEMMA
    cases = [("A ideal M%bm", CASE_A, 0, 300, 3, 5, 2, None),
             ("A flat shift", CASE_A, 15, 256, 4, 3, None, "flat"),
             ("A block shift", CASE_A, 15, 200, 5, 6, 4, "block"),
             ("B ideal", CASE_B, 0, 200, 10, 5, 3, None),
             ("B block shift", CASE_B, 15, 130, 12, 4, None, "block"),
             ("B ideal M=37", CASE_B, 0, 300, 20, 37, None, None)]
    cases += [(f"{t} M={M}", CASE_A, 0, K, N, M, None, None)
              for t, K, N in (("mlp.up", gemma["d_model"], gemma["d_ff"]),
                              ("mlp.down", gemma["d_ff"], gemma["d_model"]))
              for M in (4, 128)]
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
        want = eb.emulator_block_unified_plain(aux, gn, u, pos, shift=shift)
        for name in libs:
            if name == "parent":
                got = parent_call(aux, gn, u, pos, shift)
            else:
                use(name)
                got = eb.emulator_block_unified_cuda(aux, gn, u, pos,
                                                     shift=shift, block_m=bm)
            torch.cuda.synchronize()
            cs.compare(f"{name} {label}: NB={plan.NB} NO={plan.NO}", got, want)
        if label.startswith("mlp."):
            timed[label] = (aux, gn, u, pos)
    for label, (aux, gn, u, pos) in timed.items():
        it = 10 if u.shape[0] <= 8 else 3
        fns, names = [], []
        for name in ("exp2", "expm1f"):
            use(name)
            fn = eb._LIB["unified"].emulator_block_unified_f32

            def call(fn=fn):
                a = eb.launch_args(aux, gn, u, pos)
                out = torch.empty((2, a["M"] * a["NB"] * a["NO"], a["O"]),
                                  device=dev)
                wt = eb._Weights(**{k: v.data_ptr()
                                    for k, v in a["weights"].items()})
                _build.launched(fn(
                    a["geom"], u.data_ptr(), pos.data_ptr(), gn.data_ptr(),
                    0, 0, ctypes.byref(wt), out.data_ptr(), a["M"], a["NB"],
                    a["NO"], a["bm"], torch.cuda.current_stream().cuda_stream),
                    name)
            fns.append(call)
            names.append(name)
        if parent is not None:
            pre = conv4xbar.blocklast_precompute(aux, gn)
            fns += [lambda: parent_call(aux, gn, u, pos),
                    lambda pre=pre: parent_call(aux, gn, u, pos, pre=pre)]
            names += ["parent call (precompute + kernel)", "parent kernel"]
        ms = cs.paired_ms(fns, iters=it, reps=5)
        print(f"[time] {label}: " + ", ".join(
            f"{n} {t:.3f} ms" for n, t in zip(names, ms)) + f" [{card}]",
            flush=True)


if __name__ == "__main__":
    main()
