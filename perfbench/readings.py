"""The readings a correctness limit is set from: for each seed, the
cell's program for a short window at the cell's own load, then the
numbers ``cell.check`` compares, of the program (the lower reading is
their largest over the seeds) and, for the first ``--control`` seeds,
of the control, the reference at the precision below the
configuration's in the program's place (the upper reading is their
smallest).  Every seed in one process:

    python3 perfbench/readings.py --workload phi35moe.chat \\
        --seeds 11,12,13 --seconds 12 --control 3

One JSON line a seed, then the largest program reading and the smallest
control reading of each number.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]


def main(argv=None) -> int:
    import torch
    from perfbench import cell as C, loadgen
    ap = argparse.ArgumentParser(prog="perfbench/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--fault", default=None, choices=("token", "state", "act"),
                    help="plant a fault under the timed path "
                         "(perfbench/faults.py) and read what it reads")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the port's tiny config (a CPU rehearsal)")
    args = ap.parse_args(argv)
    cell = C.load_cell(args.workload)
    C.program_env(cell.config)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    lim = cell.limits
    hi, lo = {}, {}
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        prog = C.Program(cell, seed, dev, reduced=args.reduced)
        prog.warm()
        reqs = loadgen.make_requests(cell.traffic, seed, args.seconds,
                                     prog.ref_cfg["vocab_size"])
        picks, times = C.pick_sample(cell, reqs, seed, args.seconds)
        undo = None
        if args.fault:
            from perfbench.faults import FAULTS
            undo = FAULTS[args.fault](prog)
        win = C.Window(prog, reqs, picks, times)
        rec = C.Record(cell=cell.name, cfg=prog.ref_cfg, sites=prog.sites,
                       max_slots=prog.engine.max_slots, setup_s=0.0,
                       start=0.0, end=0.0, requests=[])
        with torch.no_grad():
            win.lead_in(rec, cell.traffic)
        t_setup = time.monotonic() - t0
        with torch.no_grad():
            win.run(rec, args.seconds, cell.traffic)
        if undo is not None:
            undo()
        caps, params, eparams, cfg = win.caps, prog.params, prog.eparams, \
            prog.ref_cfg
        del win
        prog.free()
        kw = dict(site_rows=int(lim.get("site_rows", 0)), seed=seed,
                  reference=cell.config["reference"])
        row = {"seed": seed, "setup_s": t_setup}
        with C.no_tf32():
            t1 = time.monotonic()
            row["program"] = C.check(caps, params, eparams, cfg,
                                     cell.config["crossbar"], **kw)
            row["check_s"] = time.monotonic() - t1
            if n < args.control:
                row["control"] = C.check(caps, params, eparams, cfg,
                                         cell.config["crossbar"],
                                         control=True, **kw)
        for k in C.NUMBERS:
            hi[k] = max(hi.get(k, 0.0), row["program"][k])
            if "control" in row:
                lo[k] = min(lo.get(k, float("inf")), row["control"][k])
        print(json.dumps(row), flush=True)
        del caps, params, eparams
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"lower": hi, "upper": lo}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
