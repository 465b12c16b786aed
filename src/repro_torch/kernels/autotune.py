"""Block-size autotuner for the serving kernels (port of
``repro.kernels.autotune``).

On first use of a (kernel, device, dtype, shape) combination the
candidate configs are timed on the call's own operands and the winner is
cached

  * in-process (``_MEM``), so one sweep serves the whole run, and
  * on disk (``cache_dir()/autotune.json`` -- ``$REPRO_CACHE_DIR``,
    else ``$XDG_CACHE_HOME/repro``, else ``~/.cache/repro``; the file
    itself overridable with ``$REPRO_AUTOTUNE_CACHE``), so repeat runs
    skip the sweep.  The file's format is the reference's (version 1);
    keys are namespaced ``torch:<cuda device name>`` or ``torch:cpu``
    where the reference puts jax's backend.

Every resolution is counted into the telemetry registry when it is on
(``autotune_resolutions_total{kernel, source}``, the sweep-duration
histogram ``autotune_sweep_seconds`` and the cache-path gauge
``autotune_cache_path_info``) and recorded for ``report()``, with each
swept candidate's milliseconds.

``REPRO_AUTOTUNE=1``/``0`` forces sweeping on or off; unset, a miss
sweeps exactly where the kernels run for real: on a CUDA tensor (the
reference's "on TPU").  With sweeping off a miss resolves to the caller's
default, and the key keeps it while sweeping stays off (every eager call
resolves; the reference resolves once per trace).  A candidate that
raises loses the sweep.  On the card each
candidate is timed with CUDA events after a synchronize, the median of
five runs after one warm-up run; on the CPU with the host clock.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.obs import OBS

_MEM: Dict[str, dict] = {}
_DEFAULTS: Dict[str, dict] = {}       # keys resolved to the caller's default
_REPORT: Dict[str, dict] = {}
_DISK_VERSION = 1
# every eager call resolves (the reference resolves once per trace), so
# the file is parsed again only when it changes, and device names are
# asked for once
_DISK: Dict[str, tuple] = {}
_NAMES: Dict[int, str] = {}


def cache_dir() -> str:
    """Root of the repro disk caches: ``REPRO_CACHE_DIR``, else
    ``XDG_CACHE_HOME``/repro, else ``~/.cache/repro``."""
    env = os.environ.get("REPRO_CACHE_DIR")
    if env:
        return env
    xdg = os.environ.get("XDG_CACHE_HOME")
    base = xdg if xdg else os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(base, "repro")


def cache_path() -> str:
    """Autotune disk-cache file (``REPRO_AUTOTUNE_CACHE`` overrides the
    whole path; otherwise it lives under ``cache_dir()``)."""
    env = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(cache_dir(), "autotune.json")


def enabled(device: Optional[torch.device] = None) -> bool:
    """Whether a miss sweeps (else the caller's default is used).
    ``REPRO_AUTOTUNE`` forces it; unset, sweeping is on for a CUDA
    ``device`` only."""
    env = os.environ.get("REPRO_AUTOTUNE")
    if env is not None:
        return env not in ("0", "false", "")
    return device is not None and torch.device(device).type == "cuda"


def backend(device: Optional[torch.device] = None) -> str:
    """The key namespace of ``device``: ``torch:<cuda device name>`` or
    ``torch:cpu``."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda":
        return "torch:" + dev.type
    i = torch.cuda.current_device() if dev.index is None else dev.index
    if i not in _NAMES:
        _NAMES[i] = torch.cuda.get_device_name(i)
    return "torch:" + _NAMES[i]


def _load_disk() -> dict:
    path = cache_path()
    try:
        st = os.stat(path)
    except OSError:
        return {}
    sig = (st.st_mtime_ns, st.st_size)
    if path in _DISK and _DISK[path][0] == sig:
        return _DISK[path][1]
    entries = {}
    try:
        with open(path) as f:
            doc = json.load(f)
        if isinstance(doc, dict) and doc.get("version") == _DISK_VERSION:
            entries = doc.get("entries", {})
    except (OSError, json.JSONDecodeError, ValueError):
        pass
    _DISK[path] = (sig, entries)
    return entries


def _store_disk(key: str, cfg: dict) -> None:
    path = cache_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        entries = dict(_load_disk())
        entries[key] = cfg
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": _DISK_VERSION, "entries": entries}, f,
                      indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass                      # the cache is best-effort; memory holds


def _key(kernel: str, key_parts: Sequence, device) -> str:
    return "|".join([kernel, backend(device)] + [str(p) for p in key_parts])


def _measure_median(measure: Callable[[dict], object], cfg: dict, device,
                    reps: int = 5) -> float:
    """Median milliseconds of ``measure(cfg)`` after one warm-up run."""
    cuda = device is not None and torch.device(device).type == "cuda"
    measure(cfg)
    ts = []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize(device)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            measure(cfg)
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            measure(cfg)
            ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    return ts[len(ts) // 2]


def best_config(kernel: str, key_parts: Sequence, candidates: List[dict],
                measure: Optional[Callable[[dict], object]], default: dict,
                device: Optional[torch.device] = None) -> dict:
    """Resolve the config for one (kernel, device, shape) combination.

    ``measure(cfg)`` runs the kernel once under ``cfg`` on ``device``
    (timed here); candidates that raise are skipped.  With sweeping off
    (``enabled(device)``) or no ``measure``, ``default`` is returned
    (and recorded as such)."""
    key = _key(kernel, key_parts, device)
    if key in _MEM:
        _record(kernel, key, _MEM[key], "memory")
        return _MEM[key]
    sweep = enabled(device) and measure is not None
    if not sweep and key in _DEFAULTS:
        _record(kernel, key, _DEFAULTS[key], "default")
        return _DEFAULTS[key]
    disk = _load_disk()
    if key in disk:
        _MEM[key] = disk[key]
        _record(kernel, key, disk[key], "disk")
        return disk[key]
    if not sweep:
        _DEFAULTS[key] = default
        _record(kernel, key, default, "default")
        return default
    t_sweep = time.perf_counter()
    best, best_t, times = default, float("inf"), {}
    for cfg in candidates:
        try:
            t = _measure_median(measure, cfg, device)
        except Exception:         # noqa: BLE001 -- losing candidates is fine
            continue
        times[json.dumps(cfg, sort_keys=True)] = t
        if t < best_t:
            best, best_t = cfg, t
    if OBS.enabled:
        OBS.histogram("autotune_sweep_seconds",
                      "wall-clock of one candidate sweep (launches "
                      "included)", kernel=kernel).observe(
                          time.perf_counter() - t_sweep)
    _MEM[key] = best
    _store_disk(key, best)
    _record(kernel, key, best, "swept", times)
    return best


def _record(kernel: str, key: str, cfg: dict, source: str,
            times: Optional[dict] = None) -> None:
    _REPORT[kernel] = {"key": key, "config": dict(cfg), "source": source}
    if times is not None:
        _REPORT[kernel]["ms"] = dict(times)
    if OBS.enabled:
        OBS.counter("autotune_resolutions_total",
                    "block-size resolutions per kernel and source "
                    "(memory/disk cache hit, fresh sweep, or the "
                    "caller's default)", kernel=kernel, source=source).inc()
        OBS.gauge("autotune_cache_path_info",
                  "constant 1; the label carries the active autotune "
                  "disk-cache path", path=cache_path()).set(1)


def report() -> Dict[str, dict]:
    """Last resolution per kernel in this process: the chosen config and
    where it came from (``memory`` / ``disk`` / ``swept`` / ``default``);
    a sweep also records each candidate's milliseconds (``ms``)."""
    return {k: dict(v) for k, v in _REPORT.items()}


def clear(memory: bool = True, disk: bool = False) -> None:
    """Test/bench hook: drop the in-process (and optionally disk) cache."""
    if memory:
        _MEM.clear()
        _DEFAULTS.clear()
        _REPORT.clear()
        _DISK.clear()
    if disk:
        try:
            os.remove(cache_path())
        except OSError:
            pass
