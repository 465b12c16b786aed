"""The program's own spans over a traced run's device trace.

    python3 -m perfbench.progtrace --workload <cell> --seed <n> \
        --seconds <s>

runs one cell as ``perfbench/run.py --trace 1`` does, with the program's
telemetry (``repro_torch.obs``) on from before the program is built: the
engine and the analog executor then record every span on
``time.monotonic_ns()``, the clock ``devtrace.mark`` ties the card's to.
It prints the run's own result line, then one JSON object: ``summarize``'s
numbers over the window, the two idle shares and the p90 wait before a
request's own prefill.  ``summarize`` reads, from the profiler's device
events, the marker's host time, the program's span records and the
window:

* the card's idle time in the window -- before its first device op and
  after its last included -- cut at the spans' boundaries, each part put
  on the innermost span the host was in then (``outside``: in none, the
  harness's loop), and grouped: inside the forwards
  (``serve_prefill_forward``, ``serve_decode_forward`` and the spans
  under them: the host launching the model's ops), the engine's
  turnaround (its other spans: admission, splice, the host reads, the
  decode's inputs, a step's own bookkeeping), and outside;
* B1's launches: the kernels of B1 in the trace against the program's
  own count (``emulator_block_unified_cuda.launches``, read before the
  profiler starts and after it stops), so that a trace that dropped
  events shows;
* each request's wait before its own bulk prefill, from its submit.

``perfbench/run.py`` does not import this module: its result line holds
none of these numbers.
"""
from __future__ import annotations

import argparse
import bisect
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from perfbench import devtrace
from perfbench.loadgen import percentile

FORWARD = ("serve_prefill_forward", "serve_decode_forward")
ENGINE = ("serve_step", "serve_admit", "serve_bulk_prefill", "serve_splice",
          "serve_first_token_read", "serve_decode", "serve_decode_inputs",
          "serve_token_read")
OUTSIDE = "outside"


def start_program_spans() -> None:
    """The program's telemetry on, its registry and span buffer empty."""
    from repro_torch.obs import OBS
    OBS.reset()
    OBS.enable()


def take_program_spans() -> Optional[list]:
    """The program's span records since ``start_program_spans`` (None for
    a program that keeps none), its telemetry off again."""
    from repro_torch.obs import OBS
    take = getattr(OBS, "take_spans", None)
    spans = take() if take is not None else None
    OBS.disable()
    return spans


def b1_launches() -> int:
    """B1's launches so far, as the program counts them."""
    from repro_torch.kernels.emulator_block import emulator_block
    return int(emulator_block.emulator_block_unified_cuda.launches)


def _segments(spans: Sequence, w0: int, w1: int) -> List[Tuple[int, int,
                                                               object]]:
    """(a, b, span) tiling [w0, w1] in ns: in each part the innermost span
    open (the deepest; of spans on several threads, the latest opened),
    or None."""
    by_id = {r.id: r for r in spans}
    depth: Dict[int, int] = {}
    for r in spans:
        n, p = 0, r.parent
        while p in by_id and n < len(by_id):
            n, p = n + 1, by_id[p].parent
        depth[r.id] = n
    ev = []
    for r in spans:
        a, b = max(r.t0_ns, w0), min(r.t1_ns, w1)
        if a < b:
            ev.append((a, 1, r))
            ev.append((b, 0, r))
    ev.sort(key=lambda e: (e[0], e[1]))          # ends first at one time
    out: List[Tuple[int, int, object]] = []
    live: Dict[int, object] = {}
    t, cur = w0, None
    for at, opens, r in ev:
        if at > t:
            out.append((t, at, cur))
            t = at
        if opens:
            live[r.id] = r
        else:
            del live[r.id]
        cur = (max(live.values(), key=lambda q: (depth[q.id], q.t0_ns))
               if live else None)
    if t < w1:
        out.append((t, w1, cur))
    return out


def _group(spans: Sequence) -> Dict[int, str]:
    """Each span's group: ``forward`` (a forward or under one),
    ``turnaround`` (the engine's other spans), else ``other``."""
    by_id = {r.id: r for r in spans}
    out: Dict[int, str] = {}
    for r in spans:
        q, seen = r, 0
        while q is not None and q.name not in FORWARD and seen <= len(by_id):
            q, seen = by_id.get(q.parent), seen + 1
        out[r.id] = ("forward" if q is not None else
                     "turnaround" if r.name in ENGINE else "other")
    return out


def split_idle(busy: List[Tuple[int, int]], spans: Sequence, w0: int,
               w1: int) -> Dict:
    """The idle time of [w0, w1] (host ns) by innermost span and by group,
    and the window's two edges; ``busy``: the device's busy intervals on
    the host's clock, merged and in order."""
    kept = [(max(a, w0), min(b, w1)) for a, b in busy]
    kept = [(a, b) for a, b in kept if b > a]
    edges = [w0] + [t for ab in kept for t in ab] + [w1]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    segs = _segments(spans, w0, w1)
    group = _group(spans)
    by_span: Dict[str, float] = {}
    by_group = {"forward": 0.0, "turnaround": 0.0, OUTSIDE: 0.0,
                "other": 0.0}
    starts = [a for a, _, _ in segs]
    for a, b in idle:
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(segs) and segs[i][0] < b:
            s0, s1, r = segs[i]
            d = (min(b, s1) - max(a, s0)) * 1e-9
            if d > 0:
                name = OUTSIDE if r is None else r.name
                by_span[name] = by_span.get(name, 0.0) + d
                by_group[OUTSIDE if r is None else group[r.id]] += d
            i += 1
    head = (kept[0][0] if kept else w1) - w0
    tail = w1 - kept[-1][1] if kept else 0
    return {"window_s": (w1 - w0) * 1e-9,
            "busy_s": sum(b - a for a, b in kept) * 1e-9,
            "idle_s": sum(b - a for a, b in idle) * 1e-9,
            "idle": by_span, "groups": by_group,
            "edges_s": [head * 1e-9, tail * 1e-9]}


def summarize(prof, start: float, end: float, mark_ns: int,
              spans: Optional[Sequence], launches: Tuple[int, int],
              submits: Dict[int, float]) -> Optional[Dict]:
    """The split of ``prof``'s trace over the window [start, end] (host
    monotonic seconds) by the program's ``spans``: ``split_idle``'s
    numbers, ``forward_s`` / ``turnaround_s`` / ``outside_s``, ``b1``
    (launches in the trace and by the program's count: ``launches``,
    before and after the trace; ``missing``, the count less the trace's),
    ``spans`` (how many the program
    recorded) and ``prefill_wait_s`` (each request's first bulk prefill's
    start less its ``submits`` time).  None without the clock marker."""
    offset, dev, n_b1 = None, [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name, a = e.name(), e.start_ns()
        if devtrace.MARKER in name:
            offset = a - mark_ns if offset is None else offset
            continue
        n_b1 += devtrace.B1_KERNEL in name
        dev.append((a, a + e.duration_ns()))
    if offset is None:
        return None
    spans = list(spans or ())
    busy = devtrace._union([(a - offset, b - offset) for a, b in dev])
    out = split_idle(busy, spans, int(start * 1e9), int(end * 1e9))
    g = out["groups"]
    counted = launches[1] - launches[0]
    out.update(forward_s=g["forward"], turnaround_s=g["turnaround"],
               outside_s=g[OUTSIDE], spans=len(spans),
               b1={"trace": n_b1, "program": counted,
                   "missing": counted - n_b1})
    wait: Dict[int, float] = {}
    for r in sorted(spans, key=lambda r: r.t0_ns):
        rid = r.attrs.get("rid") if r.name == "serve_bulk_prefill" else None
        if rid is not None and rid not in wait and rid in submits:
            wait[rid] = r.t0_ns * 1e-9 - submits[rid]
    out["prefill_wait_s"] = wait
    return out


def note(pt: Optional[Dict]) -> str:
    """One line for standard error: the idle split and B1's launches."""
    if pt is None:
        return "perfbench: progtrace: no clock marker in the trace"
    g, (head, tail) = pt["groups"], pt["edges_s"]
    spans = ", ".join(f"{k} {v:.3f}" for k, v in
                      sorted(pt["idle"].items(), key=lambda kv: -kv[1]))
    return (f"perfbench: idle {pt['idle_s']:.3f} s of {pt['window_s']:.3f}: "
            f"forward {g['forward']:.3f}, turnaround {g['turnaround']:.3f}, "
            f"outside {g[OUTSIDE]:.3f}, other {g['other']:.3f} (edges "
            f"{head:.3f} / {tail:.3f}; by span: {spans}); {pt['spans']} "
            f"program spans; B1 "
            f"launches in the trace {pt['b1']['trace']}, counted "
            f"{pt['b1']['program']}"
            + (f" ({pt['b1']['missing']} missing from the trace)"
               if pt["b1"]["missing"] else ""))


def shares(pt: Optional[Dict]) -> Dict[str, float]:
    """The card's idle time inside the forwards and in the engine's
    turnaround, each over the window, in percent (empty where the program
    recorded no spans)."""
    if pt is None or not pt["spans"] or pt["window_s"] <= 0:
        return {}
    return {"idle_forward_share": 100.0 * pt["forward_s"] / pt["window_s"],
            "idle_turnaround_share":
                100.0 * pt["turnaround_s"] / pt["window_s"]}


def prefill_wait_p90_ms(pt: Optional[Dict], due) -> Optional[float]:
    """For every request ``due`` in the window (``Record.due_in_window``),
    its submit to the start of its own ``serve_bulk_prefill``, the 90th
    percentile (nearest rank) in ms.  A request never prefilled counts as
    infinitely late; None where the program recorded no spans or the p90
    is such a request."""
    if pt is None or not pt["spans"] or not due:
        return None
    wait = pt["prefill_wait_s"]
    v = percentile([wait[r.rid] * 1e3 if r.rid in wait else math.inf
                    for r in due], 90)
    return v if math.isfinite(v) else None


def run(cell, seed: int, seconds: float, device: torch.device,
        reduced: bool = False):
    """``cell.run_once`` traced, with the program's spans recorded over
    it: (the run's result line object, its note, ``summarize``'s numbers
    with ``shares`` and ``prefill_wait_p90_ms`` added, or None).

    ``run_once`` is left as it is: for the one call, its ``Record`` is
    kept as it is made, B1's count is read just before the profiler
    starts and just after it stops (before the window's drain), and
    ``devtrace.summarize``, handed the stopped profiler, hands it here
    too."""
    from perfbench import cell as C
    held: Dict = {"launches": []}
    make_record, make_profiler, trace_summary = (C.Record, devtrace.profiler,
                                                 devtrace.summarize)

    def record(**kw):
        held["rec"] = make_record(**kw)
        return held["rec"]

    def profiler():
        prof = make_profiler()
        start, stop = prof.start, prof.stop

        def started():
            held["launches"].append(b1_launches())
            start()

        def stopped():
            stop()
            held["launches"].append(b1_launches())

        prof.start, prof.stop = started, stopped
        return prof

    def summarized(prof, window_s, mark_ns, spans):
        rec, reqs = held["rec"], held["prog"].engine.requests
        held["pt"] = summarize(
            prof, rec.start, rec.end, mark_ns, take_program_spans(),
            tuple(held["launches"]),
            {rid: r.t_submit for rid, r in reqs.items()})
        return trace_summary(prof, window_s, mark_ns, spans)

    C.Record, devtrace.profiler, devtrace.summarize = (record, profiler,
                                                       summarized)
    start_program_spans()
    try:
        out, note = C.run_once(cell, seed, seconds, True, device,
                               reduced=reduced,
                               underneath=lambda p: held.update(prog=p))
    finally:
        from repro_torch.obs import OBS
        OBS.disable()
        C.Record, devtrace.profiler, devtrace.summarize = (
            make_record, make_profiler, trace_summary)
    pt = held.get("pt")
    if pt is not None:
        pt.update(shares(pt), prefill_wait_p90_ms=prefill_wait_p90_ms(
            pt, held["rec"].due_in_window()))
    return out, note, pt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.progtrace")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
    from perfbench import cell as C
    cell = C.load_cell(args.workload)
    C.program_env(cell.config)
    if not torch.cuda.is_available():
        print("perfbench.progtrace: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    from repro_torch.kernels import _build
    _build.build_all()
    out, run_note, pt = run(cell, args.seed, args.seconds,
                            torch.device("cuda", 0))
    print(run_note, file=sys.stderr)
    print(note(pt), file=sys.stderr)
    print(json.dumps(out))
    if pt is not None:
        pt = {k: v for k, v in pt.items() if k != "prefill_wait_s"}
    print(json.dumps({"progtrace": pt}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
