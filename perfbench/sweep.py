"""Find a traffic mix's knee: the highest Poisson rate at which the
engine keeps no growing backlog.  One process builds the cell's program
once and offers the mix at each rate for a window:

    python3 perfbench/sweep.py --workload phi35moe.chat --seed 7 \\
        --seconds 40 --rates 1.5,2,2.5,3,3.5

For each rate it prints the requests due and completed in the window,
the mean number waiting for a slot in the window's first and last
thirds, and the latencies.  A cell stores the rates it runs at in its
traffic file; this tool is how they were found.
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
    ap = argparse.ArgumentParser(prog="perfbench/sweep.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--rates", required=True)
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
    prog = C.Program(cell, args.seed, dev, reduced=args.reduced)
    prog.warm()
    rows = []
    for rate in [float(r) for r in args.rates.split(",")]:
        tr = dict(cell.traffic, rate_per_s=rate, drain_first_tokens=False)
        reqs = loadgen.make_requests(tr, args.seed, args.seconds,
                                     prog.ref_cfg["vocab_size"])
        win = C.Window(prog, reqs, [], [])
        rec = C.Record(cell=cell.name, cfg=prog.ref_cfg, sites=prog.sites,
                       max_slots=prog.engine.max_slots, setup_s=0.0,
                       start=0.0, end=0.0, requests=[])
        with torch.no_grad():
            win.run(rec, args.seconds, tr)
        win.uninstall()
        third = rec.seconds / 3
        q1 = [n for t, n in rec.queue if t < rec.start + third]
        q3 = [n for t, n in rec.queue if t >= rec.end - third]
        due = rec.due_in_window()
        done = [r for r in due if r.done and r.times[-1] <= rec.end]
        first = [(r.times[0] - r.due) * 1e3 for r in due if r.times]
        gaps = [(b - a) * 1e3 for r in rec.requests
                for a, b in zip(r.times, r.times[1:]) if b <= rec.end]
        row = {"rate": rate, "due": len(due), "done": len(done),
               "done_per_s": len(done) / rec.seconds,
               "waiting_first_third": sum(q1) / max(1, len(q1)),
               "waiting_last_third": sum(q3) / max(1, len(q3)),
               "ttft_p50_ms": loadgen.percentile(first, 50) if first else None,
               "ttft_p90_ms": loadgen.percentile(first, 90) if first else None,
               "itl_p95_ms": loadgen.percentile(gaps, 95) if gaps else None,
               "steps": len(rec.steps)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        eng = prog.engine                      # an empty engine for the next
        for rid, req in list(eng.requests.items()):
            if not req.done:
                eng.cancel(rid)
        time.sleep(1.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
