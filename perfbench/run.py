"""Run one cell of BENCHMARK.json once:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It needs as many CUDA cards as the cell asks for, and prints as the last
line of its standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, each number the correctness check
compared beside its limit (also the last lines of standard error).
See perfbench/README.md.
"""
import time

T_START = time.monotonic()

import argparse                                               # noqa: E402
import json                                                   # noqa: E402
import sys                                                    # noqa: E402
from pathlib import Path                                      # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# run as a script, this folder would shadow top-level modules: import the
# benchmark as the package ``perfbench`` from the checkout's root instead
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from perfbench import cell as C

    cell = C.load_cell(args.workload)
    C.program_env(cell.config)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {found}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    from repro_torch.kernels import _build
    _build.build_all()
    out, note = C.run_once(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the process loaded {bad}: the benchmark runs "
              "the PyTorch port alone", file=sys.stderr)
        return 3
    print(note, file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
