"""The device trace's reduction (``devtrace.summarize``) on a stand-in
trace: busy time is the union of the card's intervals, B1's time its
kernels', and each idle gap goes to the harness span the host was in."""
import types

import pytest
import torch

from perfbench import devtrace

CUDA = torch.autograd.DeviceType.CUDA


def _ev(name, a, b):
    """A kineto event: the methods ``summarize`` reads, and no others."""
    return types.SimpleNamespace(name=lambda: name, device_type=lambda: CUDA,
                                 start_ns=lambda: a, duration_ns=lambda: b - a)


def test_summarize_a_stand_in_trace():
    off = 5_000_000_000                # the trace's clock less the host's
    mark = 1_000_000_000
    evs = [_ev(devtrace.MARKER, mark + off, mark + off + 1000),
           _ev("void fused_kernel<4, 2, 1, false>(...)",
               off + 1_100_000_000, off + 1_300_000_000),
           _ev("nvjet_gemm", off + 1_250_000_000, off + 1_400_000_000),
           _ev("elementwise", off + 1_500_000_000, off + 1_600_000_000),
           _ev("fused_kernel<4, 2, 1, false>",
               off + 1_900_000_000, off + 2_000_000_000)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    spans = [("prefill", 1.38, 1.55), ("decode", 1.58, 1.95),
             ("step", 1.35, 2.0), ("loadgen", 1.0, 2.0)]
    s = devtrace.summarize(prof, 1.0, mark, spans)
    assert s["busy_s"] == pytest.approx(0.3 + 0.1 + 0.1)
    assert s["b1_s"] == pytest.approx(0.2 + 0.1)
    assert s["device_s"] == pytest.approx(0.2 + 0.15 + 0.1 + 0.1)
    # idle 1.4-1.5 s begins in a prefill, 1.6-1.9 s in a decode tick
    assert s["gaps"] == pytest.approx({"prefill": 0.1, "decode": 0.3})
    top = devtrace.breakdown(s)
    assert top["device_ops"][0] == ["void fused_kernel<4, 2, 1, false>(...)",
                                    pytest.approx(0.2)]
    assert [n for n, _ in top["idle_gaps"]] == ["decode", "prefill"]
    # without the marker the gaps cannot be placed: "host"
    s = devtrace.summarize(types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(
            events=lambda: evs[1:]))), 1.0, mark, spans)
    assert s["gaps"] == pytest.approx({"host": 0.4})
