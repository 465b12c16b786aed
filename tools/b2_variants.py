"""B2 (the paper's per-block Conv4Xbar kernel) against its variants, and
B3 (which shares B2's tail and head) against its parent, on one CUDA card
in one process.

  python3 tools/b2_variants.py [--parent OLD.cu]

Builds, from ``src/repro_torch/kernels/emulator_block/csrc/
emulator_block.cu``: the kernel as it is (the next stage-0+1 pass's
features prefetched into registers, their position a 32-bit offset), and
three variants made by patching that source here (``VARIANTS``): one
that loads the features where the pass starts, one that copies the next
pass's with ``cp.async`` into a per-thread ring in shared memory (16 KB
more a thread block under CASE_A, 32 KB under CASE_B), one that holds
their position as a 64-bit pointer; and, given ``--parent``, an earlier
source whose B2 entry
point ``emulator_block_f32(geom, x, periph, wpack, n_periph, out, N, bn,
stream)`` reads the earlier packing (``parent_pack`` below) and whose B3
has its own tail.  Prints each build's ptxas lines for B2 and B3, holds
every version against the plain version at chip_smoke.py's phase-2 B2 and
B3 cases (rtol 1e-4 / atol 1e-5), then times, the versions taking turns
(median of 5 event pairs):

* B2 at CASE_A P=2 with N = 2,048, 5,000 and 65,536 and at CASE_B P=15
  with N = 65,536: each version's kernel alone (weights packed once) and
  the kept version's whole call (``emulator_block_cuda``: pack, checks,
  launch), the pack alone on the host clock, and the kept kernel at other
  tile sizes (``block_n``: tiles of whole passes, and one block a tile
  fewer than ``default_block_n``'s);
* B3 at full-width gemma3-1b ``mlp.up`` / ``mlp.down`` with M = 4 and 128
  (8 and 256 rail rows), the kept source against the parent.

Needs ``nvcc`` and a card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the kept kernel's feature prefetch: the first pass's before the loop,
# the next pass's while this one computes
PROLOGUE = ("  Feat nxt;                                     // the next pass's features\n"
            "  fetch<D, W>(nxt, x + xo, n0, n1 - 1);\n")
NEXT = "      const int ne = r + S1ROWS < nr ? mg + r + S1ROWS : mg + R;\n"
TAKE = ("      const Feat f = nxt;\n"
        "      if (ne < n1) fetch<D, W>(nxt, x + xo, ne, n1 - 1);\n")
# the cp.async ring: this thread copies its features of the next pass into
# its slot of a two-slot ring after fc0's periph rows (float i of a slot
# at ring[i * NT]) and reads them back after the copy's group completes
RING_FNS = r"""template <int D, int W>
__device__ __forceinline__ void fetch_async(float* ring, const float* __restrict__ xp,
                                            int e, int last) {
  constexpr int DHW = D * H * W, NT = D * W * G;
#pragma unroll
  for (int q = 0; q < S1ROWS; ++q) {
    const float* p = xp + (long long)min(e + q, last) * (2 * DHW);
    const float* src[4] = {p, p + W, p + DHW, p + DHW + W};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned a = static_cast<unsigned>(
          __cvta_generic_to_shared(ring + (4 * q + i) * NT));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(src[i]));
    }
  }
}

template <int D, int W>
__device__ __forceinline__ void take_async(Feat& f, const float* ring) {
  constexpr int NT = D * W * G;
#pragma unroll
  for (int q = 0; q < S1ROWS; ++q) {
    f.v[q] = make_float2(ring[(4 * q) * NT], ring[(4 * q + 1) * NT]);
    f.c[q] = make_float2(ring[(4 * q + 2) * NT], ring[(4 * q + 3) * NT]);
  }
}

"""
B2_HEAD = "// B2: thread block b evaluates"
BYTES = "    return (FLOATS + up4(p) * F1) * 4;\n"
VARIANTS = {
    "fetch_at_use": [
        (PROLOGUE, ""),
        (NEXT + TAKE, "      Feat f;\n      fetch<D, W>(f, x + xo, mg + r, n1 - 1);\n")],
    "cp_async_ring": [
        (B2_HEAD, RING_FNS + B2_HEAD),
        (BYTES, "    return (FLOATS + up4(p) * F1 + 2 * S1ROWS * 4 * NT) * 4;\n"),
        (PROLOGUE, "  float* ring = s + L::FP + up4(P) * F1 + tid;\n"
                   "  int slot = 0;\n"
                   "  fetch_async<D, W>(ring, x + xo, n0, n1 - 1);\n"
                   "  asm volatile(\"cp.async.commit_group;\\n\" ::);\n"),
        (TAKE, "      Feat f;\n"
               "      if (ne < n1) fetch_async<D, W>(ring + (slot ^ 1) * (4 * S1ROWS * NT),"
               " x + xo, ne, n1 - 1);\n"
               "      asm volatile(\"cp.async.commit_group;\\n\" ::);\n"
               "      asm volatile(\"cp.async.wait_group 1;\\n\" ::: \"memory\");\n"
               "      take_async<D, W>(f, ring + slot * (4 * S1ROWS * NT));\n"
               "      slot ^= 1;\n")],
    # a 64-bit pointer held across the pass (ptxas then spills)
    "feature_pointer": [
        ("  const int xo = (d * H + g * K1) * W + w;\n",
         "  const float* xp = x + ((long long)d * H + g * K1) * W + w;\n"),
        (", x + xo, ", ", xp, ")],
}


def patched(src: str, patches) -> str:
    """``src`` with each (old, new) of ``patches`` replaced; exits if an
    ``old`` is not in it."""
    for old, new in patches:
        if old not in src:
            sys.exit(f"the source no longer holds {old.strip()!r}; "
                     "update this tool's patches")
        src = src.replace(old, new)
    return src


def parent_pack(params, geom):
    """The earlier B2 kernel's weight vector: stage 0 (w0v, w0g, b0), each
    row-window stage as (k*C_in, C_out) and its bias, the W-stage likewise,
    fc0's bias, fc1, fc2, then fc0's flatten rows channels-last and its P
    periph rows.  Returns (weights, geometry id, P)."""
    import torch
    from repro_torch.kernels.emulator_block import emulator_block as eb
    gid, flat, n_periph = eb._net_geometry(params, geom)
    w0 = params["conv0_w"][:, :, 0, 0, 0]
    parts = [w0[:, 0], w0[:, 1], params["conv0_b"]]
    for i in range(1, 5):
        parts += [eb._window(params, i), params[f"conv{i}_b"]]
    parts += [params["fc0_b"], params["fc1_w"], params["fc1_b"],
              params["fc2_w"], params["fc2_b"], eb._fc0_flat(params, geom, flat),
              params["fc0_w"][flat:]]
    return torch.cat([p.reshape(-1).float() for p in parts]).contiguous(), gid, n_periph


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]
    import torch
    import chip_smoke as cs
    from b3_variants import build
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

    tmp = Path(tempfile.mkdtemp(prefix="b2_variants_"))
    src = eb.BLOCK_SOURCE.read_text()
    sources = {"kept": eb.BLOCK_SOURCE}
    for name, patches in VARIANTS.items():
        (tmp / f"{name}.cu").write_text(patched(src, patches))
        sources[name] = tmp / f"{name}.cu"
    if args.parent:
        sources["parent"] = args.parent
    libs = build(sources, tmp, _build._nvcc(), _build.NVCC_FLAGS,
                 kernels=("block_warp", "block_kernel", "grid"))
    b2, b3, smem = {}, {}, {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        fn = lib.emulator_block_f32
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        b2[name] = fn
        fn = lib.emulator_block_grid_f32
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        b3[name] = fn
        lib.emulator_block_smem_bytes.argtypes = [ctypes.c_int] * 2
        smem[name] = lib.emulator_block_smem_bytes
    for name in libs:
        print(f"[build] {name}: B2 dynamic shared memory CASE_A P=2 "
              f"{smem[name](0, 2)} B, CASE_B P=15 {smem[name](1, 15)} B",
              flush=True)

    def packed(name, p, geom):
        return parent_pack(p, geom) if name == "parent" else eb.pack_block_weights(p, geom)

    def launch(name, pk, x, per, out, bn=None):
        """One B2 launch of version ``name`` on pre-packed weights."""
        wpack, gid, P = pk
        N = x.shape[0]
        geom = CASE_A if gid == 0 else CASE_B
        if name == "parent":            # the parent's own rule
            bn = bn or max(1, min(32, N // 1024))
        else:
            bn = min(N, bn or eb.default_block_n(N, geom, eb.block_slots(geom, P, dev)))
        _build.launched(b2[name](gid, x.data_ptr(), per.data_ptr() if P else 0,
                                 wpack.data_ptr(), P, out.data_ptr(), N, bn,
                                 torch.cuda.current_stream().cuda_stream), name)
        return out

    gen = torch.Generator(device=dev)
    gen.manual_seed(300)
    geoms = {"A": CASE_A, "B": CASE_B}
    for label, gname, P, N, bn in cs.B2_CASES:
        geom = geoms[gname]
        p = cs.rand_params(geom, P, 20 + P, dev)
        x = torch.rand((N,) + geom.chw, generator=gen, device=dev)
        per = torch.rand((N, P), generator=gen, device=dev) * 2 - 1 if P else None
        want = eb.emulator_block_plain(p, x, per)
        for name in libs:
            out = torch.empty((N, geom.outputs), device=dev)
            got = launch(name, packed(name, p, geom), x, per, out,
                         None if name == "parent" else bn)
            torch.cuda.synchronize()
            cs.compare(f"{name} B2 {label}", got, want)
        del x, per, want
    for label, gname, P, M, NB, NO, bm in cs.B3_CASES:
        geom = geoms[gname]
        p = cs.rand_params(geom, P, 30 + P, dev)
        v = torch.rand((M, NB, geom.tiles, geom.rows), generator=gen, device=dev)
        gn = torch.rand((NB * NO,) + geom.chw[1:], generator=gen, device=dev)
        want = eb.emulator_block_grid_plain(p, v, gn, geom)
        for name in libs:
            got = grid_call(b3[name], eb, p, v, gn, geom, bm, dev)
            torch.cuda.synchronize()
            cs.compare(f"{name} B3 {label}", got, want)
    torch.cuda.empty_cache()

    # ---- B2 times -----------------------------------------------------------
    for gname, P, N in (("A", 2, 2048), ("A", 2, 5000), ("A", 2, 65536),
                        ("B", 15, 65536)):
        geom = geoms[gname]
        p = cs.rand_params(geom, P, 60 + P, dev)
        x = torch.rand((N,) + geom.chw, generator=gen, device=dev)
        per = torch.rand((N, P), generator=gen, device=dev) * 2 - 1
        out = torch.empty((N, geom.outputs), device=dev)
        nbytes, flops = cs.block_work(geom, N, P)
        bms, _ = cs.bound_ms(nbytes, (flops, cs.FP32_FLOP_S))
        fns = {f"{n} kernel": (lambda n=n, pk=packed(n, p, geom):
                               launch(n, pk, x, per, out)) for n in libs}
        fns["kept call"] = lambda: eb.emulator_block_cuda(p, x, per, geom)
        # the rule's tile beside tiles of whole passes of R (1, 2 and 3
        # passes, the fewest passes that leave no thread block a second
        # round) and one block fewer than the rule's
        slots = eb.block_slots(geom, P, dev)
        R = geom.tiles * geom.cols
        rule = eb.default_block_n(N, geom, slots)
        pk = packed("kept", p, geom)
        for bn in sorted({R, 2 * R, 3 * R, R * -(-N // (slots * R)),
                          max(1, rule - 1)} - {rule}):
            fns[f"kept kernel bn={bn} ({-(-N // bn)} thread blocks)"] = (
                lambda bn=bn: launch("kept", pk, x, per, out, bn))
        it = 20 if N <= 5000 else 5
        ms = cs.paired_ms(list(fns.values()), iters=it, reps=5)
        t0 = time.perf_counter()
        for _ in range(50):
            eb.pack_block_weights(p, geom)
        torch.cuda.synchronize()
        pack_host = (time.perf_counter() - t0) / 50 * 1e3
        print(f"[time] B2 {geom.name} P={P} N={N} (rule: block_n {rule}, "
              f"{-(-N // rule)} thread blocks), bound {bms:.4f} ms: "
              + ", ".join(f"{n} {t:.4f} ms" + (f" ({100 * bms / t:.1f}%)"
                                               if "kernel" in n else "")
                          for n, t in zip(fns, ms))
              + f"; the pack on the host clock {pack_host:.4f} ms [{card}]", flush=True)
        del x, per, out
        torch.cuda.empty_cache()

    # ---- B3 times: the shared tail against the parent's own ---------------
    if "parent" not in libs:
        return
    acfg = AnalogConfig(enabled=True, backend="emulator", layers=("mlp",))
    p = cs.rand_params(CASE_A, 2, 32, dev)
    for tag, K, Nw in (("mlp.up", cs.GEMMA["d_model"], cs.GEMMA["d_ff"]),
                       ("mlp.down", cs.GEMMA["d_ff"], cs.GEMMA["d_model"])):
        w = torch.randn((K, Nw), generator=gen, device=dev) * K ** -0.5
        plan = build_conductance_plan(w, acfg, CASE_A)
        gn = plan.g_norm.reshape(plan.n_blocks, plan.D, plan.rows,
                                 2 * plan.no).contiguous()
        for M in (4, 128):
            v = torch.rand((2 * M, plan.NB, plan.D, plan.rows), generator=gen,
                           device=dev)
            nbytes, flops = cs.grid_work(CASE_A, 2 * M, plan.NB, plan.NO, 2)
            bms, _ = cs.bound_ms(nbytes, (flops, cs.FP32_FLOP_S))
            names = ["kept", "parent"]
            ms = cs.paired_ms([lambda n=n: grid_call(b3[n], eb, p, v, gn, CASE_A,
                                                     None, dev) for n in names],
                              iters=5 if M <= 8 else 2, reps=5)
            print(f"[time] B3 {tag} M={M} ({2 * M} rail rows), bound {bms:.3f} ms: "
                  + ", ".join(f"{n} {t:.3f} ms ({100 * bms / t:.1f}%)"
                              for n, t in zip(names, ms))
                  + f"; kept / parent {ms[0] / ms[1]:.4f} [{card}]", flush=True)
            del v


def grid_call(fn, eb, p, v, gn, geom, bm, dev):
    """One B3 launch through ``fn`` (a library's emulator_block_grid_f32),
    packing its weights first as the wrapper does."""
    import torch
    from repro_torch.kernels import _build
    M, NB = v.shape[:2]
    NO = gn.shape[0] // NB
    bm = eb.default_block_m(M) if bm is None else bm
    out = torch.empty((M, NB * NO, geom.outputs), device=dev)
    wpack, gid = eb.pack_grid_weights(p, geom)
    _build.launched(fn(gid, v.data_ptr(), gn.data_ptr(), wpack.data_ptr(),
                       out.data_ptr(), M, NB, NO, bm,
                       torch.cuda.current_stream().cuda_stream), "grid")
    return out


if __name__ == "__main__":
    main()
