"""Process-local metrics registry: counters, gauges, histograms + labels
(port of ``repro.obs.registry``; the same names, buckets and snapshot).

The serving path is instrumented against ONE module-level ``Telemetry``
instance, ``OBS``.  The contract every instrumentation point follows
follows:

  * **zero overhead when disabled** -- every hook is gated as
    ``if OBS.enabled: ...``, i.e. one attribute check on the shared
    singleton; no handle lookup, no allocation, no clock read.  Spans
    come back as the shared ``NULL_SPAN`` when disabled.
  * **bit-neutral** -- instruments record host-side Python floats only;
    they read no tensor and launch no kernel, so enabling telemetry
    cannot change a served number and adds no device synchronization.
  * **build-neutral** -- the port compiles nothing; its counters of
    "traces" count the builds of what it would otherwise rebuild (the
    serving step closures, the executor's conductance plans, device
    states and read plans; ``obs.sentinel``).  A test asserts those
    build counts are identical with telemetry on and off.

Metric naming is Prometheus-legal as written (``[a-z0-9_]``, counters
end in ``_total``, histograms in ``_seconds`` for latencies).
Everything is thread-safe: one lock per metric guards its label series
(asserted under a ``ThreadPoolExecutor`` in tests/test_torch_obs.py).
"""
from __future__ import annotations

import bisect
import collections
import itertools
import math
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.trace import NULL_SPAN, Span, SpanRecord

# Latency-oriented default buckets (seconds): 100 us .. 10 s, roughly
# log-spaced, wide enough for both a fused-kernel dispatch and a full
# prefill on a cold CPU host.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0)

_KINDS = ("counter", "gauge", "histogram")

# span records a Telemetry keeps (an engine tick leaves ~14: a 45 s window
# of phi3.5-moe's chat serve on an H100 left ~7,600)
MAX_SPANS = 1 << 16


class _HistSeries:
    """One labeled histogram series: bucket counts + running stats."""

    __slots__ = ("counts", "sum", "count", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)   # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf


class Metric:
    """One named metric and all of its label series (thread-safe)."""

    __slots__ = ("name", "kind", "help", "buckets", "_series", "_lock")

    def __init__(self, name: str, kind: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None):
        assert kind in _KINDS, kind
        self.name = name
        self.kind = kind
        self.help = help
        self.buckets = (tuple(buckets) if buckets is not None
                        else DEFAULT_BUCKETS) if kind == "histogram" else None
        self._series: Dict[tuple, object] = {}
        self._lock = threading.Lock()

    # -- series mutation (all under the metric lock) -------------------- #
    def _add(self, key: tuple, v: float) -> None:
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + v

    def _set(self, key: tuple, v: float) -> None:
        with self._lock:
            self._series[key] = v

    def _observe(self, key: tuple, v: float) -> None:
        with self._lock:
            h = self._series.get(key)
            if h is None:
                h = self._series[key] = _HistSeries(len(self.buckets))
            h.counts[bisect.bisect_left(self.buckets, v)] += 1
            h.sum += v
            h.count += 1
            h.min = v if v < h.min else h.min
            h.max = v if v > h.max else h.max

    def snapshot_series(self) -> list:
        """Label series as JSON-ready dicts, deterministically ordered."""
        with self._lock:
            items = sorted(self._series.items())
        out = []
        for key, val in items:
            row: dict = {"labels": dict(key)}
            if self.kind == "histogram":
                row.update(count=val.count, sum=val.sum,
                           min=(None if val.count == 0 else val.min),
                           max=(None if val.count == 0 else val.max),
                           bucket_counts=list(val.counts))
            else:
                row["value"] = val
            out.append(row)
        return out


class _Counter:
    __slots__ = ("_metric", "_key")

    def __init__(self, metric: Metric, key: tuple):
        self._metric, self._key = metric, key

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a gauge")
        self._metric._add(self._key, n)


class _Gauge:
    __slots__ = ("_metric", "_key")

    def __init__(self, metric: Metric, key: tuple):
        self._metric, self._key = metric, key

    def set(self, v: float) -> None:
        self._metric._set(self._key, float(v))

    def add(self, n: float = 1.0) -> None:
        self._metric._add(self._key, n)


class _Histogram:
    __slots__ = ("_metric", "_key")

    def __init__(self, metric: Metric, key: tuple):
        self._metric, self._key = metric, key

    def observe(self, v: float) -> None:
        self._metric._observe(self._key, float(v))


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """A set of named metrics; the unit every exporter consumes.

    ``counter`` / ``gauge`` / ``histogram`` get-or-create the named
    metric and return a handle bound to one label set; re-using a name
    with a different kind raises.  ``snapshot()`` is the canonical
    JSON-ready export (``obs.export`` adds Prometheus text + diffs).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _metric(self, name: str, kind: str, help: str,
                buckets: Optional[Sequence[float]] = None) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = self._metrics[name] = Metric(name, kind, help,
                                                     buckets)
        if m.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {kind}")
        return m

    def counter(self, name: str, help: str = "", **labels) -> _Counter:
        m = self._metric(name, "counter", help)
        return _Counter(m, _label_key(labels))

    def gauge(self, name: str, help: str = "", **labels) -> _Gauge:
        m = self._metric(name, "gauge", help)
        return _Gauge(m, _label_key(labels))

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  **labels) -> _Histogram:
        m = self._metric(name, "histogram", help, buckets)
        return _Histogram(m, _label_key(labels))

    def snapshot(self) -> dict:
        """JSON-ready view of every metric (schema in export.py)."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        out = {}
        for name, m in metrics:
            entry: dict = {"kind": m.kind, "help": m.help,
                           "series": m.snapshot_series()}
            if m.kind == "histogram":
                entry["buckets"] = list(m.buckets)
            out[name] = entry
        return {"schema": 1, "enabled": getattr(self, "enabled", True),
                "metrics": out}

    def reset(self) -> None:
        """Drop every metric (tests / between benchmark phases)."""
        with self._lock:
            self._metrics.clear()


class Telemetry(MetricsRegistry):
    """The process-local registry plus the master enable switch.

    Instrumentation points gate on ``OBS.enabled`` (one attribute
    check); ``span(name, ...)`` returns the shared no-op ``NULL_SPAN``
    while disabled.  ``profiler=True`` additionally wraps every span in
    a ``torch.profiler.record_function`` so spans land on profiler
    traces.

    While enabled, every finished span also appends a ``SpanRecord`` to
    a buffer of at most ``max_spans`` (``MAX_SPANS``) records;
    ``take_spans()`` returns them and empties it.  A full buffer drops
    its oldest record and counts it in ``obs_spans_dropped_total``.  A
    span's parent is the span open around it on the same thread (the
    ``AsyncBatchServer`` steps its engine on a thread of its own).
    """

    def __init__(self, enabled: bool = False, profiler: bool = False):
        super().__init__()
        self.enabled = enabled
        self.profiler = profiler
        self.max_spans = MAX_SPANS
        self._spans: collections.deque = collections.deque()
        self._spans_lock = threading.Lock()
        self._span_ids = itertools.count(1)
        self._open = threading.local()          # each thread's open span ids

    def enable(self, profiler: Optional[bool] = None) -> "Telemetry":
        self.enabled = True
        if profiler is not None:
            self.profiler = profiler
        return self

    def disable(self) -> "Telemetry":
        self.enabled = False
        return self

    def span(self, name: str, help: str = "",
             attrs: Optional[dict] = None, **labels):
        """A span timing its with-block into ``<name>_seconds`` under
        ``labels``; ``attrs`` go into its record alone."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, help, labels, attrs)

    def _enter_span(self, span: Span) -> None:
        stack = getattr(self._open, "ids", None)
        if stack is None:
            stack = self._open.ids = []
        span.id = next(self._span_ids)
        span.parent = stack[-1] if stack else 0
        stack.append(span.id)

    def _exit_span(self, rec: SpanRecord) -> None:
        stack = getattr(self._open, "ids", [])
        if stack and stack[-1] == rec.id:
            stack.pop()
        elif rec.id in stack:                  # left out of order
            stack.remove(rec.id)
        with self._spans_lock:
            full = len(self._spans) >= self.max_spans
            if full:
                self._spans.popleft()
            self._spans.append(rec)
        if full:
            self.counter("obs_spans_dropped_total",
                         "span records dropped from a full buffer, the "
                         "oldest first").inc()

    def take_spans(self) -> List[SpanRecord]:
        """The buffered span records, oldest first; the buffer emptied."""
        with self._spans_lock:
            out = list(self._spans)
            self._spans.clear()
        return out

    def reset(self) -> None:
        """Drop every metric and every buffered span record."""
        super().reset()
        self.take_spans()


def _env_enabled() -> bool:
    return os.environ.get("REPRO_TELEMETRY", "") not in ("", "0", "false")


#: THE process-local telemetry instance every instrumentation point and
#: exporter defaults to.  Disabled unless ``REPRO_TELEMETRY=1`` (or a
#: caller -- ``serve --telemetry``, a benchmark, a test -- enables it).
OBS = Telemetry(enabled=_env_enabled())
