"""RecompileSentinel: the build-once invariant as a reusable check (port of
``repro.obs.sentinel``).

The reference's sentinel watches jit caches: a block of serving must not
compile anything past its first compile.  The port compiles nothing (no
``torch.compile``, no CUDA graphs), so counting recompiles would always
read zero.  What the port would have to *rebuild* is what its sentinel
watches instead, and what a "trace" means in the port:

  * ``session``  -- a ``ServeSession`` or a ``ContinuousBatchEngine``:
    ``prefill_traces`` and ``decode_traces``, the builds of its prefill
    and decode step closures;
  * ``executor`` -- an ``AnalogExecutor``: per tag, the builds of its
    conductance plan (``executor.plan[tag]``), of its materialized
    device state (``executor.state[tag]``) and of its read plan
    (``executor.read[tag]``) -- ``AnalogExecutor.builds``; a tag created
    inside the block counts from zero;
  * ``fns``      -- any callables that expose a build count as an int
    attribute ``builds``.

    with RecompileSentinel(session=eng, executor=ex, label="serve") as s:
        eng.run(prompts, max_new=16)
    assert s.ok          # strict=True (default) raises instead

``max_traces`` is the per-counter budget of NEW builds inside the block
(default 1: the block may pay its first build, never a rebuild).  On
exit the outcome lands in the metrics registry when telemetry is enabled
(``obs_sentinel_checks_total{label, outcome}`` and, per watched counter,
``obs_sentinel_new_traces{label, watch}``), which lets
``tools/check_telemetry.py`` fail a serve on ``outcome="violation"``
straight from the exported snapshot.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from repro_torch.obs.registry import OBS


class RecompileError(AssertionError):
    """A watched build counter grew past the sentinel's budget."""


class RecompileSentinel:
    """Context manager asserting nothing was rebuilt beyond budget
    (see module docstring)."""

    def __init__(self, *, session=None, executor=None, fns: Sequence = (),
                 max_traces: int = 1, label: str = "", strict: bool = True):
        self.session = session
        self.executor = executor
        self.fns = tuple(fns)
        self.max_traces = max_traces
        self.label = label
        self.strict = strict
        self.ok: Optional[bool] = None
        self.new_counts: Dict[str, int] = {}
        self.violations: Dict[str, int] = {}
        self._base: Dict[str, int] = {}

    def counts(self) -> Dict[str, int]:
        """Current absolute counts of every watched counter."""
        c: Dict[str, int] = {}
        if self.session is not None:
            c["session.prefill_traces"] = self.session.prefill_traces
            c["session.decode_traces"] = self.session.decode_traces
        if self.executor is not None:
            for kind, per_tag in self.executor.builds.items():
                for tag, n in per_tag.items():
                    c[f"executor.{kind}[{tag}]"] = n
        for i, fn in enumerate(self.fns):
            c[f"fn[{i}]"] = int(fn.builds)
        return c

    def __enter__(self) -> "RecompileSentinel":
        self._base = self.counts()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            return False               # don't mask the original error
        end = self.counts()
        self.new_counts = {k: v - self._base.get(k, 0)
                           for k, v in end.items()}
        self.violations = {k: v for k, v in self.new_counts.items()
                           if v > self.max_traces}
        self.ok = not self.violations
        if OBS.enabled:
            OBS.counter(
                "obs_sentinel_checks_total",
                "RecompileSentinel outcomes (violation = a watched build "
                "counter grew past the budget)",
                label=self.label or "<unlabeled>",
                outcome="ok" if self.ok else "violation").inc()
            for k, v in self.new_counts.items():
                OBS.gauge(
                    "obs_sentinel_new_traces",
                    "new builds per watched counter in the last sentinel "
                    "block",
                    label=self.label or "<unlabeled>", watch=k).set(v)
        if self.strict and not self.ok:
            raise RecompileError(
                f"recompile sentinel {self.label or ''!s} tripped: "
                f"{self.violations} new builds exceed the budget of "
                f"{self.max_traces} (all watched: {self.new_counts})")
        return False
