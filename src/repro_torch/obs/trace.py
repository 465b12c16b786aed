"""Trace spans: wall-clock timing of a code region into a histogram (port
of ``repro.obs.trace``).

On exit a span records the elapsed seconds into the owning registry's
``<name>_seconds`` histogram (span names therefore use underscores, so
the derived metric name is Prometheus-legal as it is).  With the
registry's ``profiler`` flag set the span also enters a
``torch.profiler.record_function`` of the same name, so serving spans
show up on a ``torch.profiler`` trace next to the kernels they wrap.

A span never synchronizes the device: around an asynchronous CUDA launch
it times the host side (the call site says so).  When telemetry is
disabled, ``Telemetry.span`` returns the shared ``NULL_SPAN`` -- two
empty method calls, no allocation, no clock read.
"""
from __future__ import annotations

import time


class NullSpan:
    """No-op context manager handed out while telemetry is disabled."""

    __slots__ = ()

    def __enter__(self) -> "NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = NullSpan()


class Span:
    """Times a with-block into ``<name>_seconds`` on ``registry``."""

    __slots__ = ("_registry", "name", "help", "labels", "_t0", "_annotation")

    def __init__(self, registry, name: str, help: str = "",
                 labels: dict | None = None):
        self._registry = registry
        self.name = name
        self.help = help
        self.labels = labels or {}
        self._t0 = 0.0
        self._annotation = None

    def __enter__(self) -> "Span":
        if getattr(self._registry, "profiler", False):
            import torch.profiler

            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter() - self._t0
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        self._registry.histogram(self.name + "_seconds", self.help,
                                 **self.labels).observe(dt)
        return False
