"""Serving telemetry: metrics registry, trace spans, exporters, sentinels
(port of ``repro.obs``).

Everything hangs off the process-local ``OBS`` singleton:

    from repro_torch.obs import OBS

    if OBS.enabled:                              # one attribute check
        OBS.counter("analog_plan_cache_total", tag=tag, event="hit").inc()

    with OBS.span("serve_bulk_prefill", site=site,     # NULL_SPAN when
                  attrs={"rid": rid, "P": P}):        # disabled
        ...

    records = OBS.take_spans()                   # SpanRecords, buffer emptied

Disabled (the default) every hook costs one attribute check and records
nothing; enabled (``REPRO_TELEMETRY=1``, ``OBS.enable()``, or ``serve
--telemetry``) it feeds the JSON / Prometheus exporters and the
``RecompileSentinel`` build-once checks, and every span leaves a record
(name, start and end on ``time.monotonic_ns()``, id, parent, labels,
attributes) in a bounded buffer.  A span's histogram and record time the
host: around CUDA launches that is the time to enqueue them, which a
device trace on the same clock turns into where the card waited.
Instrumentation is bit-neutral and build-neutral: no instrument reads a
tensor, launches a kernel or synchronizes the device
(tests/test_torch_obs.py).
"""
from repro_torch.obs.export import (diff_snapshots, parse_prometheus,
                                    snapshot, to_prometheus, write_snapshot)
from repro_torch.obs.registry import (DEFAULT_BUCKETS, OBS, MetricsRegistry,
                                      Telemetry)
from repro_torch.obs.sentinel import RecompileError, RecompileSentinel
from repro_torch.obs.trace import NULL_SPAN, Span, SpanRecord

__all__ = [
    "OBS", "Telemetry", "MetricsRegistry", "DEFAULT_BUCKETS",
    "Span", "SpanRecord", "NULL_SPAN",
    "snapshot", "write_snapshot", "to_prometheus", "parse_prometheus",
    "diff_snapshots",
    "RecompileSentinel", "RecompileError",
]
