"""The device trace of a ``--trace 1`` run, reduced to what the per-layer
readers need: every device operation's interval and name (the trace
holds the card's activity only: kernels, copies, sets), and from them
the busy time (the union of the device's intervals), each kernel's
time, B1's time and the device's idle gaps labelled by what the host
was doing then (the harness's own spans on the host's clock: a bulk
prefill, a decode tick, the rest of an engine step, or waiting for
arrivals).

Only the card's activity is traced: tracing the host's operators as well
slowed a phi3.5-moe tick from ~100 to 134 ms on an H100.  A marker
kernel launched just after a synchronize at a known host time ties the
two clocks.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Tuple

import torch

# the kernels of B1, the unified emulator-block evaluator
B1_KERNEL = "fused_kernel<"


MARKER = "spin_kernel"            # torch.cuda._sleep's kernel


def profiler():
    """A profiler of the card's activity, not started."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA], record_shapes=False,
                   with_stack=False)


def mark(device) -> int:
    """Launch the clock marker on an idle card; the host's monotonic ns
    just before the launch."""
    torch.cuda.synchronize(device)
    t = time.monotonic_ns()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize(device)
    return t


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(prof, window_s: float, mark_ns: int, spans) -> Dict:
    """The trace's summary: ``window_s`` (the traced window, host clock),
    ``busy_s``, ``b1_s``, ``device_s`` (every device op's time),
    ``kernels`` (name -> seconds), ``gaps`` (label -> idle seconds).
    ``spans``: (label, t0, t1) host monotonic seconds, the innermost
    first; ``mark_ns``: ``mark``'s host time."""
    dev: List[Tuple[int, int, str]] = []
    offset = None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name()
        a = e.start_ns()
        if MARKER in name:
            offset = a - mark_ns if offset is None else offset
            continue
        dev.append((a, a + e.duration_ns(), name))
    kernels: Dict[str, float] = {}
    for a, b, n in dev:
        kernels[n] = kernels.get(n, 0.0) + (b - a) * 1e-9
    busy = _union([(a, b) for a, b, _ in dev])
    gaps: Dict[str, float] = {}
    by_kind: Dict[str, List[Tuple[int, int]]] = {}
    order: List[str] = []
    for label, t0, t1 in spans:
        if label not in by_kind:
            order.append(label)
        by_kind.setdefault(label, []).append((int(t0 * 1e9), int(t1 * 1e9)))
    starts = {k: sorted(v) for k, v in by_kind.items()}
    keys = {k: [a for a, _ in v] for k, v in starts.items()}
    for (_, b0), (a1, _) in zip(busy, busy[1:]):
        label = "host"
        if offset is not None:
            h = b0 - offset
            for k in order:
                i = bisect.bisect_right(keys[k], h) - 1
                if i >= 0 and starts[k][i][1] > h:
                    label = k
                    break
        gaps[label] = gaps.get(label, 0.0) + (a1 - b0) * 1e-9
    return {"window_s": window_s,
            "busy_s": sum(b - a for a, b in busy) * 1e-9,
            "b1_s": sum(s for n, s in kernels.items() if B1_KERNEL in n),
            "device_s": sum(kernels.values()),
            "kernels": kernels, "gaps": gaps, "n_ops": len(dev)}


def breakdown(summary: Dict) -> Dict:
    """The result line's ``breakdown``: the ten device ops that took most
    time, and the idle time by what the host was doing."""
    top = sorted(summary["kernels"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:200], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}
