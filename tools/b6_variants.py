"""B6 (the linear-scan kernel) against its parent and its variants, on one
CUDA card in one process.

  python3 tools/b6_variants.py [--parent OLD.cu]

Builds, from ``src/repro_torch/kernels/linear_scan/csrc/linear_scan.cu``:

* the kernel as it is (column tiles walked through a ring of stages that
  one tensor copy a stage and array fills where the rows are 16-byte
  aligned);
* variants made by patching that source here (``VARIANTS``): the
  odd-pitch path (each row copied as the 16-byte chunks that hold it, by
  the producer warp's cp.async) at every shape; that path with plain
  16-byte loads and stores in place of cp.async, or with one bulk copy a
  row issued by one thread; the tensor copies replaced by one bulk copy a
  row and array, issued by one thread or by the producer warp's 32;
* given ``--parent``, an earlier source whose entry point is
  ``linear_scan(dtype, a, b, b0, h, B, S, D, stream)`` (the earlier
  design: one thread per lane, 8 steps loaded ahead).

Other column widths C, stage heights R and ring depths K are launch
arguments of the kept build (``plans`` below).  Prints each build's
ptxas lines, holds every build and plan bit for bit against the plain
version (``torch.equal``) at chip_smoke.py's phase-8 B6 cases (timing
the kept kernel against the parent's there, in turns, launched one by
one and replayed from a CUDA graph, which leaves the host's launch
overhead out), then times, the versions taking turns (median of 5 event
pairs), at the four head shapes (falcon-mamba-7b's scan state and
recurrentgemma-2b's RG-LRU, fp32 and bf16): without h0, every build's
kernel and the kept build at other plans, beside ``torch.add(a, b,
out=h)`` (the same traffic); with h0, each build's kernel alone (on b0
folded once) and its call (``fold_h0`` then the kernel), and the fold
alone.

Needs ``nvcc`` and a card.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the producer's two tensor copies a stage, and the per-row bulk copies
# that replace them in the row-copy variants
BOXES = ("        bar_expect(&full[k], 2u * R * C * sizeof(T));\n"
         "        box_copy(sa, &ma, d0, i * R, bi, &full[k]);\n"
         "        box_copy(sb, &mb, d0, i * R, bi, &full[k]);\n")
ROWS = ("        const int rows = min(R, S - i * R);\n"
        "        const long long g = col + (long long)i * R * D;\n"
        "        {EXPECT}bar_expect(&full[k], 2u * rows * cw * sizeof(T));\n"
        "        {SYNC}for (int r = {FIRST}; r < rows; r += {STEP}) {{\n"
        "          bulk_copy(sa + r * C, a + g + (long long)r * D, cw * sizeof(T), &full[k]);\n"
        "          bulk_copy(sb + r * C, b + g + (long long)r * D, cw * sizeof(T), &full[k]);\n"
        "        }}\n")
BULK_COPY = r"""// bytes (a multiple of 16) from 16-byte aligned global to shared memory
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem(dst)), "l"(src), "r"(bytes),
      "r"(smem(bar)) : "memory");
}

template <int BYTES> struct Word;"""
WORD = "template <int BYTES> struct Word;"
LONE = "    if (BULK && lane != 0) return;\n"
FULL = ("      bar_init(&full[k], BULK ? 1 : CONSUMERS);\n",
        "      bar_init(&full[k], 1);\n")
# the odd-pitch path: the producer warp's cp.async of a row's 16-byte
# chunks, replaced by plain 16-byte loads and stores, or by one bulk copy
# a row issued by one thread
CP_ASYNC = ("            cp_async16(reinterpret_cast<char*>((x ? sb : sa) + r * pitch) + q * 16,\n"
            "                       reinterpret_cast<const char*>(p - skew(p)) + q * 16);\n")
PLAIN = ("            *reinterpret_cast<uint4*>(reinterpret_cast<char*>((x ? sb : sa) + r * pitch) + q * 16) =\n"
         "                *reinterpret_cast<const uint4*>(reinterpret_cast<const char*>(p - skew(p)) + q * 16);\n")
ARRIVE = ("        cp_async_arrive(&full[k]);\n", "        bar_arrive(&full[k]);\n")
ODD_WARP = ("        const int per = C * (int)sizeof(T) / 16 + 1;   // chunks a row spans\n"
            "        for (int e = lane; e < 2 * rows * per; e += CONSUMERS) {\n"
            "          const int q = e % per, r = e / per % rows, x = e / (per * rows);\n"
            "          const T* p = (x ? gb : ga) + (long long)r * D;\n"
            "          if (q * 16 < (int)chunks(p, cw))\n" + CP_ASYNC + "        }\n"
            "        cp_async_arrive(&full[k]);\n")
ODD_BULK = ("        unsigned tx = 0;\n"
            "        for (int r = 0; r < rows; ++r)\n"
            "          tx += chunks(ga + (long long)r * D, cw) + chunks(gb + (long long)r * D, cw);\n"
            "        bar_expect(&full[k], tx);\n"
            "        for (int r = 0; r < rows; ++r) {\n"
            "          const T* pa = ga + (long long)r * D;\n"
            "          const T* pb = gb + (long long)r * D;\n"
            "          bulk_copy(sa + r * pitch, pa - skew(pa), chunks(pa, cw), &full[k]);\n"
            "          bulk_copy(sb + r * pitch, pb - skew(pb), chunks(pb, cw), &full[k]);\n"
            "        }\n")
ODD_EVERYWHERE = ("  const bool bulk = (D * sizeof(T)) % 16 == 0 && any % 16 == 0;\n",
                  "  const bool bulk = false && any;\n")
VARIANTS = {
    # the odd-pitch path (each row as its 16-byte chunks) at every shape
    "chunks_everywhere": [ODD_EVERYWHERE],
    # that path with plain 16-byte loads and stores in place of cp.async
    "plain_loads": [ODD_EVERYWHERE, (CP_ASYNC, PLAIN), ARRIVE],
    # that path with one bulk copy a row and array, issued by one thread
    "chunk_bulk_copies": [ODD_EVERYWHERE, (WORD, BULK_COPY), (ODD_WARP, ODD_BULK),
                          (LONE, "    if (lane != 0) return;\n"), FULL],
    # one bulk copy a row and array in place of the tensor copies, all
    # issued by one thread
    "row_copies": [
        (WORD, BULK_COPY),
        (BOXES, ROWS.format(EXPECT="", SYNC="", FIRST="0", STEP="1"))],
    # the same copies spread over the producer warp's 32 lanes
    "warp_row_copies": [
        (WORD, BULK_COPY), (LONE, ""),
        (BOXES, ROWS.format(EXPECT="if (lane == 0) ", SYNC="__syncwarp();\n        ",
                            FIRST="lane", STEP="CONSUMERS"))],
}
CASES = [("falcon-mamba-7b", 1, 2048, 8192 * 16, False),
         ("falcon-mamba-7b", 1, 2048, 8192 * 16, True),
         ("RG-LRU", 4, 2048, 2560, False),
         ("ragged", 3, 37, 1000, True),
         ("ragged, odd pitch", 3, 37, 1001, True)]
HEADS = [("falcon-mamba-7b", 1, 2048, 8192 * 16), ("RG-LRU", 4, 2048, 2560)]


def plans(plan):
    """The kept build's plan beside other ring depths, stage heights and
    column widths that the kernel takes."""
    C, R, K = plan["C"], plan["R"], plan["K"]
    V = 16 // plan["itemsize"]
    out = {"rule": (C, R, K)}
    for k in (2, 3, 6, 8):
        out[f"K={k}"] = (C, R, k)
    for r in (R // 2, 2 * R):
        if r >= 1:
            out[f"R={r}"] = (C, r, K)
    for c in (C // 2, 2 * C):
        if V <= c <= 32 * V:
            out[f"C={c}"] = (c, R, K)
    return out


def graph_ms(torch, cs, fns, iters):
    """Each of ``fns`` captured ``iters`` times into a CUDA graph, the
    graphs replayed in turns (median of 5 event pairs): the time per call
    on the card, without the host's launch overhead."""
    graphs = []
    for fn in fns:
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        graphs.append(g)
    return [t / iters for t in cs.paired_ms([g.replay for g in graphs],
                                            iters=1, reps=5)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]
    import torch
    import chip_smoke as cs
    from b2_variants import patched
    from b3_variants import build
    from repro_torch.kernels import _build
    lsm = importlib.import_module("repro_torch.kernels.linear_scan.linear_scan")
    from repro_torch.kernels.linear_scan.ops import linear_scan

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)

    tmp = Path(tempfile.mkdtemp(prefix="b6_variants_"))
    src = lsm.SOURCE.read_text()
    sources = {"kept": lsm.SOURCE}
    for name, patches in VARIANTS.items():
        (tmp / f"{name}.cu").write_text(patched(src, patches))
        sources[name] = tmp / f"{name}.cu"
    if args.parent:
        sources["parent"] = args.parent
    libs = build(sources, tmp, _build._nvcc(), _build.NVCC_FLAGS,
                 kernels=("scan_kernel",))
    fns = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).linear_scan
        n_int = 3 if name == "parent" else 6
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * n_int + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn

    def run(name, a, b, b0, h, plan=None):
        """One launch of build ``name`` (the rule's plan unless given)."""
        B, S, D = a.shape
        dt = 0 if a.dtype == torch.float32 else 1
        ptrs = (a.data_ptr(), b.data_ptr(), 0 if b0 is None else b0.data_ptr(),
                h.data_ptr())
        stream = torch.cuda.current_stream().cuda_stream
        if name == "parent":
            err = fns[name](dt, *ptrs, B, S, D, stream)
        else:
            C, R, K = plan or rule(a)[:3]
            err = fns[name](dt, *ptrs, B, S, D, C, R, K, stream)
        _build.launched(err, name)
        return h

    def rule(a):
        B, _, D = a.shape
        p = lsm._card_plan(B, D, a.element_size(), 0)
        return p["C"], p["R"], p["K"], p

    gen = torch.Generator(device=dev)
    gen.manual_seed(600)

    def inputs(B, S, D, dt, with_h0):
        a = (0.5 + 0.499 * torch.rand((B, S, D), generator=gen,
                                      device=dev)).to(dt)
        b = (0.1 * torch.randn((B, S, D), generator=gen, device=dev)).to(dt)
        h0 = (torch.randn((B, D), generator=gen, device=dev).to(dt)
              if with_h0 else None)
        return a, b, h0

    dtypes = (("fp32", torch.float32), ("bf16", torch.bfloat16))
    for dname, dt in dtypes:
        for label, B, S, D, with_h0 in CASES:
            a, b, h0 = inputs(B, S, D, dt, with_h0)
            b0 = None if h0 is None else lsm.fold_h0(a, b, h0)
            want = lsm.linear_scan_plain(a, b, b0)
            p = rule(a)[3]
            checks = [(n, None) for n in libs]
            checks += [("kept", pl) for n, pl in
                       plans(dict(p, itemsize=a.element_size())).items()
                       if n != "rule"]
            bad = []
            for name, pl in checks:
                got = run(name, a, b, b0, torch.empty_like(a), pl)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    bad.append(f"{name} {pl or ''}")
            print(f"[check] B6 {label} B={B} S={S} D={D}"
                  f"{' h0' if with_h0 else ''} {dname}: {len(checks)} "
                  f"builds / plans, bit-equal to the plain version: "
                  f"{'all' if not bad else 'NOT ' + ', '.join(bad)}", flush=True)
            if bad:
                sys.exit(1)
            out = torch.empty_like(a)
            names = [n for n in ("kept", "parent") if n in libs]
            pl = rule(a)[:3]                  # looked up once: the parent has no plan
            calls = [lambda n=n: run(n, a, b, b0, out, pl) for n in names]
            it = 10 if B * S * D > 1e6 else 50
            for how, ms in (
                    ("launched one by one", cs.paired_ms(calls, iters=it, reps=5)),
                    (f"as a CUDA graph of {it} launches", graph_ms(torch, cs, calls, it))):
                print(f"[time] B6 {label} B={B} S={S} D={D}"
                      f"{' h0' if with_h0 else ''} {dname}, {how}: "
                      + ", ".join(f"{n} {t:.4f} ms" for n, t in zip(names, ms))
                      + (f"; kept / parent {ms[0] / ms[1]:.4f}" if len(ms) == 2 else "")
                      + f" [{card}]", flush=True)
            del out
            del a, b, h0, b0, want
            torch.cuda.empty_cache()

    for dname, dt in dtypes:
        for label, B, S, D in HEADS:
            for with_h0 in (False, True):
                a, b, h0 = inputs(B, S, D, dt, with_h0)
                out = torch.empty_like(a)
                C, R, K, p = rule(a)
                nbytes = (3 * B * S * D + (B * D if with_h0 else 0)) * a.element_size()
                bms, _ = cs.bound_ms(nbytes)
                timed = {}
                if not with_h0:
                    for name in libs:
                        timed[name] = lambda n=name: run(n, a, b, None, out, (C, R, K))
                    for name, pl in plans(dict(p, itemsize=a.element_size())).items():
                        if name != "rule":
                            timed[f"kept {name}"] = (
                                lambda pl=pl: run("kept", a, b, None, out, pl))
                    timed["kept call"] = lambda: linear_scan(a, b)
                else:
                    b0 = lsm.fold_h0(a, b, h0)
                    for name in libs:
                        timed[f"{name} kernel (b0)"] = (
                            lambda n=name: run(n, a, b, b0, out, (C, R, K)))
                        timed[f"{name} call (fold, kernel)"] = (
                            lambda n=name: run(n, a, b, lsm.fold_h0(a, b, h0), out,
                                               (C, R, K)))
                    timed["kept call"] = lambda: linear_scan(a, b, h0)
                    timed["fold alone"] = lambda: lsm.fold_h0(a, b, h0)
                timed["torch.add(a, b, out=)"] = lambda: torch.add(a, b, out=out)
                it = 10 if label.startswith("falcon") else 40
                ms = cs.paired_ms(list(timed.values()), iters=it, reps=5)
                print(f"[time] B6 {label} B={B} S={S} D={D}"
                      f"{' h0' if with_h0 else ''} {dname} (rule: C={C} R={R} "
                      f"K={K}, {p['blocks']} thread blocks), bound {bms:.4f} ms: "
                      + ", ".join(f"{n} {t:.4f} ms ({100 * bms / t:.1f}%)"
                                  for n, t in zip(timed, ms))
                      + f" [{card}]", flush=True)
                del a, b, h0, out
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
