"""Trace spans: timing of a code region into a histogram and a span record
(port of ``repro.obs.trace``, with the record added).

On exit a span records the elapsed seconds into the owning registry's
``<name>_seconds`` histogram (span names therefore use underscores, so
the derived metric name is Prometheus-legal as it is), labelled by its
low-cardinality ``labels`` (``site``, ``tag``, ``step``) only.  It also
hands the owning ``Telemetry`` one ``SpanRecord``: its name, start and
end on ``time.monotonic_ns()`` (the clock a device trace is tied to, and
the one ``Request``'s stamps use), its id, the id of the span that
encloses it on the same thread (0 for none), its labels, and its
``attrs``: the values that identify one request or one tick (``rid``,
``tick``, ``live``, ``P``), which never become histogram labels, so a
long serve does not grow a series per request.  With the registry's
``profiler`` flag set the span also enters a
``torch.profiler.record_function`` of the same name.

A span never synchronizes the device: around an asynchronous CUDA launch
it times the host side (the call site says so).  When telemetry is
disabled, ``Telemetry.span`` returns the shared ``NULL_SPAN`` -- two
empty method calls, no allocation, no clock read.
"""
from __future__ import annotations

import time
from typing import NamedTuple


class NullSpan:
    """No-op context manager handed out while telemetry is disabled."""

    __slots__ = ()

    def __enter__(self) -> "NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = NullSpan()


class SpanRecord(NamedTuple):
    """One finished span, as ``Telemetry.take_spans()`` returns it."""
    name: str
    t0_ns: int                  # time.monotonic_ns() at entry
    t1_ns: int                  # ... and at exit
    id: int
    parent: int                 # the enclosing span on the thread; 0: none
    labels: dict
    attrs: dict


class Span:
    """Times a with-block into ``<name>_seconds`` on ``registry`` (a
    ``Telemetry``) and into its span records."""

    __slots__ = ("_registry", "name", "help", "labels", "attrs", "id",
                 "parent", "_t0", "_annotation")

    def __init__(self, registry, name: str, help: str = "",
                 labels: dict | None = None, attrs: dict | None = None):
        self._registry = registry
        self.name = name
        self.help = help
        self.labels = labels or {}
        self.attrs = attrs or {}
        self.id = self.parent = 0
        self._t0 = 0
        self._annotation = None

    def __enter__(self) -> "Span":
        if getattr(self._registry, "profiler", False):
            import torch.profiler

            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self._registry._enter_span(self)
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.monotonic_ns()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        self._registry.histogram(self.name + "_seconds", self.help,
                                 **self.labels).observe((t1 - self._t0) * 1e-9)
        self._registry._exit_span(SpanRecord(self.name, self._t0, t1, self.id,
                                             self.parent, self.labels,
                                             self.attrs))
        return False
