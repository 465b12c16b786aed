"""The program's spans over the device trace (``progtrace``): idle time
cut at span boundaries and put on the innermost span, the window's edges
included; B1's launches in the trace against the program's count; and,
on the CPU at a tiny size, a window whose program spans the harness
reads back, and a whole traced run through ``progtrace.run``."""
import re
import time
import types

import pytest
import torch

from perfbench import cell as C, devtrace, loadgen, progtrace
from perfbench.tests.test_perfbench_faults import SECONDS, _small
from repro_torch.obs import SpanRecord

CUDA = torch.autograd.DeviceType.CUDA
MS = 1_000_000                              # ns


def _span(i, parent, name, a, b, **attrs):
    return SpanRecord(name, a * MS, b * MS, i, parent, {}, attrs)


# two ticks, times in ms: a decode, then an admission with a bulk prefill
SPANS = [_span(3, 2, "serve_decode_inputs", 150, 200),
         _span(5, 4, "analog_matmul", 250, 300),
         _span(4, 2, "serve_decode_forward", 200, 400),
         _span(6, 2, "serve_token_read", 400, 480),
         _span(2, 1, "serve_decode", 150, 480, tick=0, live=1),
         _span(1, 0, "serve_step", 100, 500, tick=0),
         _span(10, 9, "serve_prefill_forward", 610, 650),
         _span(9, 8, "serve_bulk_prefill", 610, 690, rid=4, P=12),
         _span(8, 7, "serve_admit", 600, 700),
         _span(7, 0, "serve_step", 600, 900, tick=1)]
BUSY = [(120, 260), (320, 420), (450, 630), (660, 950)]


def test_idle_is_cut_at_span_boundaries_edges_included():
    s = progtrace.split_idle([(a * MS, b * MS) for a, b in BUSY], SPANS,
                             0, 1000 * MS)
    assert s["window_s"] == pytest.approx(1.0)
    assert s["busy_s"] == pytest.approx(0.71)
    assert s["idle_s"] == pytest.approx(1.0 - 0.71)
    # the parts add up to the window less the busy time
    assert sum(s["idle"].values()) == pytest.approx(s["idle_s"])
    assert sum(s["groups"].values()) == pytest.approx(s["idle_s"])
    assert s["edges_s"] == pytest.approx([0.12, 0.05])
    # 0-100 before any span and 950-1000 after the last; 100-120 a step's
    # own; 260-300 in an analog call, 300-320 in the forward; 420-450 the
    # token read; 630-660 crosses the prefill forward's end at 650
    assert s["idle"] == pytest.approx({
        "outside": 0.15, "serve_step": 0.02, "analog_matmul": 0.04,
        "serve_decode_forward": 0.02, "serve_token_read": 0.03,
        "serve_prefill_forward": 0.02, "serve_bulk_prefill": 0.01})
    assert s["groups"] == pytest.approx({"forward": 0.08, "turnaround": 0.06,
                                         "outside": 0.15, "other": 0.0})


def test_a_busy_window_and_an_empty_one():
    s = progtrace.split_idle([(-5, 2000 * MS)], SPANS, 0, 1000 * MS)
    assert s["idle_s"] == 0 and s["edges_s"] == [0, 0]
    s = progtrace.split_idle([], [], 0, 1000 * MS)
    assert s["idle"] == pytest.approx({"outside": 1.0})
    assert s["edges_s"] == pytest.approx([1.0, 0.0])


def _ev(name, a, b):
    return types.SimpleNamespace(name=lambda: name, device_type=lambda: CUDA,
                                 start_ns=lambda: a, duration_ns=lambda: b - a)


def _prof(evs):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))


def test_summarize_reports_a_launch_count_mismatch():
    off, mark = 7_000 * MS, 50 * MS      # the trace's clock less the host's
    evs = [_ev(devtrace.MARKER, mark + off, mark + off + 1000)]
    evs += [_ev("void fused_kernel<4, 2, 1, false>(...)" if i < 2 else "gemm",
                a * MS + off, b * MS + off) for i, (a, b) in enumerate(BUSY)]
    pt = progtrace.summarize(_prof(evs), 0.0, 1.0, mark, SPANS, (10, 13),
                             {4: 0.55})
    assert pt["b1"] == {"trace": 2, "program": 3, "missing": 1}
    assert "1 missing from the trace" in progtrace.note(pt)
    assert pt["forward_s"] == pytest.approx(0.08)
    assert pt["turnaround_s"] == pytest.approx(0.06)
    assert pt["outside_s"] == pytest.approx(0.15)
    assert pt["prefill_wait_s"] == pytest.approx({4: 0.61 - 0.55})
    assert pt["spans"] == len(SPANS)
    full = progtrace.summarize(_prof(evs), 0.0, 1.0, mark, SPANS, (0, 2), {})
    assert full["b1"]["missing"] == 0
    assert "missing" not in progtrace.note(full)
    # a program that keeps no spans: its idle is all outside
    bare = progtrace.summarize(_prof(evs), 0.0, 1.0, mark, None, (0, 2), {})
    assert bare["spans"] == 0 and bare["outside_s"] == pytest.approx(0.29)
    # no marker: the trace cannot be placed on the host's clock
    assert progtrace.summarize(_prof(evs[1:]), 0.0, 1.0, mark, SPANS,
                               (0, 2), {}) is None


def _due(*rids):
    return [types.SimpleNamespace(rid=r) for r in rids]


@pytest.mark.parametrize("waits,due,p90", [
    # the p90 of 20 is the 18th: 170 ms
    ({r: r * 0.01 for r in range(20)}, _due(*range(20)), 170.0),
    # 2 of 20 never prefilled: the 18th is still the last one served
    ({r: r * 0.01 for r in range(18)}, _due(*range(20)), 170.0),
    # 3 of 20 never prefilled: the p90 falls on one, infinitely late
    ({r: r * 0.01 for r in range(17)}, _due(*range(20)), None),
], ids=["all", "two-unserved", "p90-unserved"])
def test_the_shares_and_the_prefill_wait(waits, due, p90):
    """The idle shares are the groups over the window, and the p90 wait
    (nearest rank) counts a request never prefilled as infinitely late."""
    pt = {"spans": 9, "window_s": 4.0, "forward_s": 0.2, "turnaround_s": 0.1,
          "prefill_wait_s": waits}
    assert progtrace.shares(pt) == pytest.approx(
        {"idle_forward_share": 5.0, "idle_turnaround_share": 2.5})
    got = progtrace.prefill_wait_p90_ms(pt, due)
    assert got == (None if p90 is None else pytest.approx(p90))
    assert progtrace.prefill_wait_p90_ms(pt, []) is None
    assert progtrace.shares(dict(pt, spans=0)) == {}
    assert progtrace.prefill_wait_p90_ms(dict(pt, spans=0), due) is None

def test_a_window_records_the_program_spans():
    """On the CPU at a tiny size, a window with the program's telemetry on
    (as a ``--trace 1`` run has it): every harness step holds one
    ``serve_step``, a trace with no device op leaves the whole window
    idle and split among the spans, and the new readers read it."""
    cell = _small("phi35moe.chat")
    progtrace.start_program_spans()
    try:
        prog = C.Program(cell, 7, torch.device("cpu"), reduced=True)
        prog.warm()
        reqs = loadgen.make_requests(cell.traffic, 7, SECONDS,
                                     prog.ref_cfg["vocab_size"])
        picks, times = C.pick_sample(cell, reqs, 7, SECONDS)
        win = C.Window(prog, reqs, picks, times)
        rec = C.Record(cell=cell.name, cfg=prog.ref_cfg, sites=prog.sites,
                       max_slots=2, setup_s=0.0, start=0.0, end=0.0,
                       requests=[])
        with torch.no_grad():
            win.run(rec, SECONDS, cell.traffic)
    finally:
        spans = progtrace.take_program_spans()
    from repro_torch.obs import OBS
    assert not OBS.enabled
    steps = [r for r in spans if r.name == "serve_step"
             and rec.start <= r.t0_ns * 1e-9 and r.t1_ns * 1e-9 <= rec.end]
    inside = [(a, b) for a, b in rec.steps if b <= rec.end]
    assert len(steps) == len(inside) > 0
    for (a, b), r in zip(inside, steps):
        assert a <= r.t0_ns * 1e-9 <= r.t1_ns * 1e-9 <= b
    mark = 10 * MS
    rec.spans = spans
    rec.progtrace = progtrace.summarize(
        _prof([_ev(devtrace.MARKER, mark, mark + 1000)]), rec.start, rec.end,
        mark, spans, (0, 0), {rid: r.t_submit
                              for rid, r in prog.engine.requests.items()})
    pt = rec.progtrace
    assert pt["idle_s"] == pytest.approx(rec.seconds)
    assert sum(pt["groups"].values()) == pytest.approx(rec.seconds)
    assert pt["forward_s"] > 0 and pt["turnaround_s"] > 0
    sh = progtrace.shares(pt)
    fwd, turn = sh["idle_forward_share"], sh["idle_turnaround_share"]
    assert 0 < fwd and 0 < turn and fwd + turn <= 100.0 + 1e-9
    wait = progtrace.prefill_wait_p90_ms(pt, rec.due_in_window())
    assert wait is not None and wait >= 0
    assert set(pt["prefill_wait_s"]) >= {r.rid for r in rec.due_in_window()}
    assert progtrace.shares(None) == {}
    assert progtrace.prefill_wait_p90_ms(None, rec.due_in_window()) is None


class _CpuTrace:
    """A profiler for the CPU: no device op, only the clock marker, which
    ``mark`` below places 3 ms after its host time."""

    def __init__(self):
        self.profiler = types.SimpleNamespace(
            kineto_results=types.SimpleNamespace(events=self.events))

    def start(self):
        _CpuTrace.on = [time.monotonic_ns()]

    def stop(self):
        _CpuTrace.on.append(time.monotonic_ns())

    def events(self):
        t = _CpuTrace.mark_ns + 3 * MS
        return [_ev(devtrace.MARKER, t, t + 1000)]


def _cpu_mark(device):
    _CpuTrace.mark_ns = time.monotonic_ns()
    return _CpuTrace.mark_ns


def test_run_splits_a_traced_window_and_leaves_the_harness_as_it_was(
        monkeypatch):
    """``progtrace.run`` on the CPU at a tiny size (the profiler and the
    clock marker stood in for): the run's own result is whole and
    correct, the split covers the window, every request due in it has
    its wait, and the harness and the program's telemetry are as before."""
    from repro_torch.obs import OBS
    monkeypatch.setattr(devtrace, "profiler", _CpuTrace)
    monkeypatch.setattr(devtrace, "mark", _cpu_mark)
    # B1 runs on the card alone: here its "count" is the host's clock, so
    # the two reads show where they fall (just around the profiler's
    # start and stop, not after the drain that follows the window)
    monkeypatch.setattr(progtrace, "b1_launches", time.monotonic_ns)
    record, summarize = C.Record, devtrace.summarize
    cell = _small("phi35moe.chat")
    out, note, pt = progtrace.run(cell, 2**31 + 77, SECONDS,
                                  torch.device("cpu"), reduced=True)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert out["device"]["busy_s"] == 0
    assert pt["idle_s"] == pytest.approx(pt["window_s"])
    assert pt["window_s"] == pytest.approx(out["device"]["window_s"])
    assert sum(pt["groups"].values()) == pytest.approx(pt["idle_s"])
    assert pt["spans"] > 0 and pt["b1"]["trace"] == 0
    on = _CpuTrace.on[1] - _CpuTrace.on[0]
    assert on <= pt["b1"]["program"] <= on + 5 * MS
    assert pt["window_s"] * 1e9 <= on
    assert pt["idle_forward_share"] > 0 and pt["idle_turnaround_share"] > 0
    assert pt["prefill_wait_p90_ms"] is not None
    assert C.Record is record and devtrace.summarize is summarize
    assert devtrace.profiler is _CpuTrace and not OBS.enabled


@pytest.mark.card
def test_a_traced_chat_run_reads_the_program_spans(card):
    """A short traced run of the chat cell reads the split and the wait
    from the program's spans, and its idle split covers the idle time
    ``idle_share`` reads, to 0.1 point of the window."""
    from repro_torch.kernels import _build
    _build.build_all()
    cell = C.load_cell("phi35moe.chat")
    out, _, pt = progtrace.run(cell, 2**31 + 321, 8.0, card)
    assert out["correct"], out["checks"]
    for k in ("idle_forward_share", "idle_turnaround_share",
              "prefill_wait_p90_ms"):
        assert pt[k] is not None, (k, pt)
    line = progtrace.note(pt)
    idle, window = map(float, re.search(r"idle ([\d.]+) s of ([\d.]+)",
                                        line).groups())
    dev = out["device"]
    assert abs(idle - (dev["window_s"] - dev["busy_s"])) <= 1e-3 * window
    assert re.search(r"B1 launches in the trace \d+, counted \d+", line)
    assert pt["b1"]["missing"] == 0, pt["b1"]
    torch.cuda.empty_cache()
