"""Exporters for a ``MetricsRegistry`` snapshot (port of
``repro.obs.export``; the JSON is the same, so ``tools/check_telemetry.py``
validates a port snapshot).

Two wire formats:

  * **JSON snapshot** -- ``snapshot()``: the canonical machine-readable
    dump (``{"schema": 1, "enabled": ..., "metrics": {...}}``).  This is
    what ``serve --telemetry`` writes and what
    ``tools/check_telemetry.py`` validates.
  * **Prometheus text format** -- ``to_prometheus(snap)``: the standard
    exposition format (``# HELP`` / ``# TYPE`` + samples; histograms as
    cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``), so a node
    exporter sidecar or a pushgateway can scrape a serving process
    without any new dependency.  ``parse_prometheus`` is the minimal
    inverse used by the round-trip test.

``diff_snapshots(a, b)`` subtracts counter values and histogram series
(b - a; gauges take b's value): two snapshots around a workload yield
exactly that workload's metrics.
"""
from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

from repro_torch.obs.registry import OBS, MetricsRegistry


def snapshot(registry: Optional[MetricsRegistry] = None) -> dict:
    """JSON-ready snapshot of ``registry`` (default: the process ``OBS``)."""
    return (registry if registry is not None else OBS).snapshot()


def write_snapshot(path: str,
                   registry: Optional[MetricsRegistry] = None) -> str:
    with open(path, "w") as f:
        json.dump(snapshot(registry), f, indent=2, sort_keys=True)
        f.write("\n")
    return path


# --------------------------------------------------------------------------- #
# Prometheus text exposition format
# --------------------------------------------------------------------------- #
def _fmt(v: float) -> str:
    """Integral floats render as integers (counters read naturally)."""
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels_text(labels: Dict[str, str], extra: Tuple[str, str] = None) -> str:
    items = sorted(labels.items())
    if extra is not None:
        items = items + [extra]
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_esc(str(v))}"' for k, v in items) + "}"


def to_prometheus(snap: dict) -> str:
    """Render a snapshot in the Prometheus text exposition format."""
    lines = []
    for name, m in sorted(snap.get("metrics", {}).items()):
        if m.get("help"):
            lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} {m['kind']}")
        for s in m.get("series", []):
            labels = s.get("labels", {})
            if m["kind"] == "histogram":
                cum = 0
                for le, c in zip(list(m["buckets"]) + ["+Inf"],
                                 s["bucket_counts"]):
                    cum += c
                    lines.append(
                        f"{name}_bucket"
                        f"{_labels_text(labels, ('le', _fmt(le) if le != '+Inf' else '+Inf'))}"
                        f" {cum}")
                lines.append(f"{name}_sum{_labels_text(labels)}"
                             f" {repr(float(s['sum']))}")
                lines.append(f"{name}_count{_labels_text(labels)}"
                             f" {s['count']}")
            else:
                lines.append(f"{name}{_labels_text(labels)}"
                             f" {_fmt(s['value'])}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[Tuple[str, frozenset], float]:
    """Minimal inverse of ``to_prometheus`` (round-trip testing): maps
    ``(sample_name, frozenset(label_items))`` to the sample value."""
    out: Dict[Tuple[str, frozenset], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        if "{" in head:
            name, _, rest = head.partition("{")
            body = rest.rstrip("}")
            labels = []
            for part in _split_labels(body):
                k, _, v = part.partition("=")
                labels.append((k, v.strip('"').replace('\\"', '"')
                               .replace("\\n", "\n").replace("\\\\", "\\")))
            key = (name, frozenset(labels))
        else:
            key = (head, frozenset())
        out[key] = float(value)
    return out


def _split_labels(body: str) -> list:
    """Split ``k1="v1",k2="v2"`` on commas outside quotes."""
    parts, cur, in_q, prev = [], [], False, ""
    for ch in body:
        if ch == '"' and prev != "\\":
            in_q = not in_q
        if ch == "," and not in_q:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
        prev = ch
    if cur:
        parts.append("".join(cur))
    return [p for p in parts if p]


# --------------------------------------------------------------------------- #
# Snapshot diffs
# --------------------------------------------------------------------------- #
def _series_map(m: dict) -> dict:
    return {tuple(sorted(s.get("labels", {}).items())): s
            for s in m.get("series", [])}


def diff_snapshots(base: dict, snap: dict) -> dict:
    """``snap - base``: counters and histograms subtract per series
    (series absent from ``base`` count from zero; series that only exist
    in ``base`` are dropped), gauges pass through ``snap``'s value."""
    out = {"schema": snap.get("schema", 1), "enabled": snap.get("enabled"),
           "diff": True, "metrics": {}}
    for name, m in snap.get("metrics", {}).items():
        b = _series_map(base.get("metrics", {}).get(name, {}))
        series = []
        for s in m.get("series", []):
            key = tuple(sorted(s.get("labels", {}).items()))
            prev = b.get(key)
            if m["kind"] == "counter" and prev is not None:
                d = dict(s)
                d["value"] = s["value"] - prev["value"]
                series.append(d)
            elif m["kind"] == "histogram" and prev is not None:
                d = dict(s)
                d["count"] = s["count"] - prev["count"]
                d["sum"] = s["sum"] - prev["sum"]
                d["bucket_counts"] = [x - y for x, y in
                                      zip(s["bucket_counts"],
                                          prev["bucket_counts"])]
                # min/max are not recoverable for the window; keep snap's
                series.append(d)
            else:
                series.append(dict(s))
        entry = {"kind": m["kind"], "help": m.get("help", ""),
                 "series": series}
        if "buckets" in m:
            entry["buckets"] = m["buckets"]
        out["metrics"][name] = entry
    return out
