"""B1's fp32 kernel against its variants and its parent on one CUDA card,
in one process.

  python3 tools/b1_fp32_variants.py [--parent OLD.cu] [--quick]

Builds, from ``src/repro_torch/kernels/emulator_block/csrc/
emulator_block_unified.cu``: the kernel as it is (persistent thread blocks
walking the (block, row tile) items, every CELU of the fp32 kernel from
the hardware exp2), a variant with ``expm1f`` in that CELU, and, given
``--parent``, an earlier B1 source with the entry point
``emulator_block_unified_f32(geom, u, pos, g_norm, shift, shift_per_block,
wt, out, M, NB, NO, bm, stream)`` (one thread block an item, before the
thread blocks stayed resident), e.g. ``git show <rev>:src/repro_torch/
kernels/emulator_block/csrc/emulator_block_unified.cu >
build/b1_parent.cu``.  Prints each build's
ptxas lines for B1, then:

* holds each build against the plain version at chip_smoke.py's phase-2
  cases (rtol 1e-4 / atol 1e-5);
* at the benchmark's sites -- command-r-plus's gate/up (48, 33792) and down
  (132, 12288) blocks at M = 1, 2, 4, 8, 20, 32, phi3.5-moe's q/o (16,
  4096) and k/v (16, 1024) at M = 8, 32, 128 -- on random drive and
  conductances, holds the kernel bit for bit (``torch.equal``) against the
  parent in fp32 at every M and in bf16 at some, and against itself
  launched one item a thread block; the same at two row tiles below M;
* times, the versions taking turns (median of event pairs): the kernel,
  the kernel launched one item a thread block, and the parent, at each
  site and M; and prints each site's least-squares fit of ns a block
  against M, time = blocks x (fixed + M x row), for each version;
* times full-width gemma3-1b ``mlp.up`` / ``mlp.down`` at M = 4 and 128:
  the kernel, the ``expm1f`` variant and the parent.

``--quick`` keeps the cmdr sites to M = 8 (about a third of the time).
Needs ``nvcc`` and a card; about 3 minutes with ``--parent``.
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
# (label, NB, NO, row counts timed): the benchmark's B1 sites
SITES = [("cmdr gate/up", 48, 33792, (1, 2, 4, 8, 20, 32)),
         ("cmdr down", 132, 12288, (1, 2, 4, 8, 20, 32)),
         ("phi q/o", 16, 4096, (8, 32, 128)),
         ("phi k/v", 16, 1024, (8, 32, 128))]
# (M, block_m) of the bit checks with several row tiles a block
TILED = ((20, 8), (37, 16))


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
            if "fused_kernel" in kernel:
                print(f"[build] {name} {kernel}: {line}", flush=True)
        libs[name] = lib
    return libs


def fit(ms_by_m: dict, blocks: int):
    """(fixed, row) ns a block of time = blocks x (fixed + M x row), least
    squares over the row counts timed."""
    xs = list(ms_by_m)
    ys = [ms_by_m[m] * 1e6 / blocks for m in xs]
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    row = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
           / sum((x - mx) ** 2 for x in xs))
    return my - row * mx, row


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--quick", action="store_true")
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

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    BF16 = torch.bfloat16
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)

    tmp = Path(tempfile.mkdtemp(prefix="b1_variants_"))
    src = eb.SOURCE.read_text()
    if src.count(EXP2) != 1:
        sys.exit("the source's exp2 CELU is not where this tool expects it")
    (tmp / "expm1f.cu").write_text(src.replace(EXP2, EXPM1))
    sources = {"kernel": eb.SOURCE, "expm1f": tmp / "expm1f.cu"}
    if args.parent:
        sources["parent"] = args.parent
    libs = build(sources, tmp, _build._nvcc(), _build.NVCC_FLAGS,
                 cs.ptxas_stats)
    tail = ([ctypes.c_int, ctypes.POINTER(eb._Weights), ctypes.c_void_p]
            + [ctypes.c_int] * 4)
    entry = {}
    for name, lib in libs.items():
        cdll = ctypes.CDLL(str(lib))
        for mode in ("f32", "bf16"):
            fn = getattr(cdll, f"emulator_block_unified_{mode}")
            grid = [] if name == "parent" else [ctypes.c_int, ctypes.c_void_p]
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + tail + grid
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            entry[(name, mode)] = fn
    # the kernel's own library serves the wrapper (unified_slots)
    _build._LOADED[eb.SOURCE] = ctypes.CDLL(str(libs["kernel"]))
    eb._LIB.pop("unified", None)

    def launcher(name, aux, gn, u, pos, shift=None, bm=None, dt=torch.float32,
                 one_each=False):
        """A function of no arguments that launches ``name``'s kernel once
        on these inputs and returns its output; the arguments are checked
        once, here.  ``one_each``: one item a thread block (the grid the
        parent launches), for the kernel of this source."""
        a = eb.launch_args(aux, gn, u, pos, shift, bm, dt,
                           slots=2 ** 31 - 1 if one_each else None)
        wt = eb._Weights(**{k: v.data_ptr() for k, v in a["weights"].items()})
        fn = entry[(name, "bf16" if dt == BF16 else "f32")]
        stream = torch.cuda.current_stream().cuda_stream
        grid = () if name == "parent" else (
            a["ctas"], eb.unified_ticket(dev, stream).data_ptr())
        shape = (2, a["M"] * a["NB"] * a["NO"], a["O"])

        def run():
            out = torch.empty(shape, device=dev)
            _build.launched(fn(
                a["geom"], u.data_ptr(), pos.data_ptr(), gn.data_ptr(),
                0 if shift is None else shift.data_ptr(), a["per_block"],
                ctypes.byref(wt), out.data_ptr(), a["M"], a["NB"], a["NO"],
                a["bm"], *grid, stream), name)
            return out
        run.grid = (a["items"], a["items"] if name == "parent" else a["ctas"])
        return run

    def same(label, runs):
        """Every run's output bit for bit equal to the first's."""
        outs = [r() for r in runs]
        torch.cuda.synchronize()
        for r, o in zip(runs[1:], outs[1:]):
            eq = torch.equal(o, outs[0])
            print(f"[bits] {label}: {r.label} {'equal' if eq else 'DIFFER'} "
                  f"(items {r.grid[0]}, thread blocks {r.grid[1]})", flush=True)
            if not eq:
                sys.exit(f"[{label}] {r.label} is not bit-equal")

    def versions(aux, gn, u, pos, bm=None, dt=torch.float32):
        runs = [launcher("kernel", aux, gn, u, pos, bm=bm, dt=dt),
                launcher("kernel", aux, gn, u, pos, bm=bm, dt=dt,
                         one_each=True)]
        runs[0].label, runs[1].label = "kernel", "kernel one item a block"
        if args.parent:
            runs.append(launcher("parent", aux, gn, u, pos, bm=bm, dt=dt))
            runs[-1].label = "parent"
        return runs

    # ---- against the plain version --------------------------------------
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
        p = cs.rand_params(geom, npf, 7 + npf, dev)
        aux = conv4xbar.blocklast_weights(p, geom)
        g = torch.Generator(device=dev)
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
            got = launcher(name, aux, gn, u, pos, shift, bm)()
            torch.cuda.synchronize()
            cs.compare(f"{name} {label}: NB={plan.NB} NO={plan.NO}", got, want)
        if label.startswith("mlp."):
            timed[label] = (aux, gn, u, pos)

    # ---- the benchmark's sites: bits, then times in turns ---------------
    aux = conv4xbar.blocklast_weights(cs.rand_params(CASE_A, 0, 7, dev), CASE_A)
    g = torch.Generator(device=dev)
    fits = []
    for s, (label, NB, NO, ms) in enumerate(SITES):
        if args.quick and label.startswith("cmdr"):
            ms = (8,)
        g.manual_seed(500 + s)
        gn = torch.rand((NB, NO, 4, 64, 2), generator=g, device=dev)
        big = max(ms + tuple(m for m, _ in TILED))
        u0 = torch.rand((big, NB, 4, 64), generator=g, device=dev)
        u0 = torch.where(u0 < 0.2, torch.zeros_like(u0), u0)
        pos0 = ((torch.rand(u0.shape, generator=g, device=dev) < 0.5)
                & (u0 > 0)).float()
        times = {}
        for M in ms:
            u, pos = u0[:M].contiguous(), pos0[:M].contiguous()
            runs = versions(aux, gn, u, pos)
            same(f"{label} fp32 M={M}", runs)
            if M in (1, 8, 128):
                same(f"{label} bf16 M={M}",
                     versions(aux, gn, u, pos, dt=BF16))
            it = 3 if NB * NO * M < 2 ** 22 else 1
            t = cs.paired_ms(runs, iters=it, reps=5, warmup=1)
            times[M] = t
            print(f"[time] {label} (NB={NB}, NO={NO}) M={M}: " + ", ".join(
                f"{r.label} {x:.3f} ms ({x * 1e6 / (NB * NO):.1f} ns a block)"
                for r, x in zip(runs, t)) + f" [{card}]", flush=True)
        for M, bm in TILED:
            u, pos = u0[:M].contiguous(), pos0[:M].contiguous()
            same(f"{label} fp32 M={M} block_m={bm}",
                 versions(aux, gn, u, pos, bm=bm))
        if len(ms) > 1:
            names = [r.label for r in runs]
            for k, name in enumerate(names):
                fixed, row = fit({M: times[M][k] for M in ms}, NB * NO)
                fits.append((label, name, fixed, row))
                print(f"[fit] {label} {name}: fixed {fixed:.2f} ns a block, "
                      f"{row:.3f} ns a row a block (M = {ms})", flush=True)
        del gn, u0, pos0, runs
        torch.cuda.empty_cache()

    # ---- gemma3-1b's full-width sites: the kernel, expm1f, the parent ----
    for label, (aux, gn, u, pos) in timed.items():
        runs = [launcher(name, aux, gn, u, pos) for name in libs]
        ms = cs.paired_ms(runs, iters=10 if u.shape[0] <= 8 else 3, reps=5)
        print(f"[time] {label}: " + ", ".join(
            f"{n} {t:.3f} ms" for n, t in zip(libs, ms)) + f" [{card}]",
            flush=True)


if __name__ == "__main__":
    main()
