"""B3 (the slow path's per-(row, block) kernel) against its variants on one
CUDA card, in one process.

  python3 tools/b3_variants.py [--parent OLD.cu]

Builds, from ``src/repro_torch/kernels/emulator_block/csrc/
emulator_block.cu``: the kernel as it is (two rows a stage-0+1 pass, every
CELU from the hardware exp2), a variant with one row a stage-0+1 pass, a
variant with ``expm1f`` in that CELU, and, given ``--parent``, an earlier
source with the same C entry point ``emulator_block_grid_f32(geom, v01,
g_norm, wpack, out, M, NB, NO, bm, stream)`` on ``pack_grid_weights``'
vector.  Prints each build's ptxas lines for B3, holds each version
against the plain version at chip_smoke.py's phase-2 B3 cases and at
full-width gemma3-1b ``mlp.up`` with 8 rail rows (rtol 1e-4 / atol
1e-5), then times full-width ``mlp.up`` / ``mlp.down`` at M = 4 and 128
(8 and 256 rail rows), the versions taking turns (median of event pairs;
each call packs its weights as the wrapper does).  Needs ``nvcc`` and a
card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROWS2 = "constexpr int S1ROWS = 2;"
ROWS1 = "constexpr int S1ROWS = 1;"
EXP2 = "return x > 0.f ? x : __expf(x) - 1.f;"
EXPM1 = "return x > 0.f ? x : expm1f(x);"


def build(sources: dict, out_dir: Path, nvcc: str, nvcc_flags,
          kernels=("grid",)) -> dict:
    """name -> library path; one nvcc per source, all started together.
    Prints the ptxas lines of the kernels whose names hold one of
    ``kernels``."""
    procs = {}
    for name, path in sources.items():
        lib = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *nvcc_flags, "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        show = False
        for line in log.splitlines():
            if "Compiling entry" in line:
                show = any(k in line for k in kernels)
                if show:
                    print(f"[build] {name}: {line.strip()[:160]}", flush=True)
            elif show and ("registers" in line or "spill" in line):
                print(f"[build] {name}:   {line.strip()}", flush=True)
            elif "error" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
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
    from repro_torch.core.crossbar import build_conductance_plan
    from repro_torch.kernels import _build
    from repro_torch.kernels.emulator_block import emulator_block as eb

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)

    tmp = Path(tempfile.mkdtemp(prefix="b3_variants_"))
    src = eb.BLOCK_SOURCE.read_text()
    if src.count(ROWS2) != 1 or src.count(EXP2) != 1:
        sys.exit("the source's S1ROWS or exp2 CELU is not where this tool "
                 "expects it")
    (tmp / "rows1.cu").write_text(src.replace(ROWS2, ROWS1))
    (tmp / "expm1f.cu").write_text(src.replace(EXP2, EXPM1))
    sources = {"new": eb.BLOCK_SOURCE, "rows1": tmp / "rows1.cu",
               "expm1f": tmp / "expm1f.cu"}
    if args.parent:
        sources["parent"] = args.parent
    libs = build(sources, tmp, _build._nvcc(), _build.NVCC_FLAGS)
    fns = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).emulator_block_grid_f32
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn

    def call(name, p, v, gn, geom, bm=None):
        """One launch of version ``name``, packing its weights first."""
        M, NB = v.shape[:2]
        NO = gn.shape[0] // NB
        bm = eb.default_block_m(M) if bm is None else bm
        out = torch.empty((M, NB * NO, geom.outputs), device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        wpack, gid = eb.pack_grid_weights(p, geom)
        _build.launched(fns[name](gid, v.data_ptr(), gn.data_ptr(),
                                  wpack.data_ptr(), out.data_ptr(), M, NB, NO,
                                  bm, stream), name)
        return out

    gen = torch.Generator(device=dev)
    gen.manual_seed(300)
    geoms = {"A": CASE_A, "B": CASE_B}
    for label, gname, P, M, NB, NO, bm in cs.B3_CASES:
        geom = geoms[gname]
        p = cs.rand_params(geom, P, 30 + P, dev)
        v = torch.rand((M, NB, geom.tiles, geom.rows), generator=gen, device=dev)
        gn = torch.rand((NB * NO,) + geom.chw[1:], generator=gen, device=dev)
        want = eb.emulator_block_grid_plain(p, v, gn, geom)
        for name in libs:
            got = call(name, p, v, gn, geom, bm)
            torch.cuda.synchronize()
            cs.compare(f"{name} B3 {label}", got, want)

    # full-width gemma3-1b: the plans' g_norm as the slow path hands it over
    acfg = AnalogConfig(enabled=True, backend="emulator", layers=("mlp",))
    p = cs.rand_params(CASE_A, 2, 32, dev)
    timed = []
    for tag, K, N in (("mlp.up", cs.GEMMA["d_model"], cs.GEMMA["d_ff"]),
                      ("mlp.down", cs.GEMMA["d_ff"], cs.GEMMA["d_model"])):
        w = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
        plan = build_conductance_plan(w, acfg, CASE_A)
        gn = plan.g_norm.reshape(plan.n_blocks, plan.D, plan.rows,
                                 2 * plan.no).contiguous()
        for M in (4, 128):
            v = torch.rand((2 * M, plan.NB, plan.D, plan.rows), generator=gen,
                           device=dev)
            if tag == "mlp.up" and M == 4:
                want = eb.emulator_block_grid_plain(p, v, gn, CASE_A)
                for name in libs:
                    got = call(name, p, v, gn, CASE_A)
                    torch.cuda.synchronize()
                    cs.compare(f"{name} B3 {tag} M={M} (8 rail rows)", got, want)
                del got, want
            timed.append((tag, M, plan, v, gn))
    for tag, M, plan, v, gn in timed:
        nbytes, flops = cs.grid_work(CASE_A, 2 * M, plan.NB, plan.NO, 2)
        bms, _ = cs.bound_ms(nbytes, (flops, cs.FP32_FLOP_S))
        names = list(libs)
        ms = cs.paired_ms([lambda n=n: call(n, p, v, gn, CASE_A) for n in names],
                          iters=5 if M <= 8 else 2, reps=5)
        print(f"[time] B3 {tag} M={M} ({2 * M} rail rows), bound {bms:.3f} ms: "
              + ", ".join(f"{n} {t:.3f} ms ({100 * bms / t:.1f}%)"
                          for n, t in zip(names, ms)) + f" [{card}]", flush=True)


if __name__ == "__main__":
    main()
