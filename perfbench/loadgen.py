"""The one traffic generator: it reads a traffic mix's parameters (a data
file under ``perfbench/traffic/``) and makes the requests of one run.

Two arrival kinds:

* ``"open"``: independent users; requests are due on a Poisson-like
  schedule at ``rate_per_s`` (``arrivals``), whether or not earlier ones
  have finished, and each is timed from its due time.
* ``"closed"``: ``clients`` callers, each sending its next request when
  its last one completes.

Lengths are drawn from ``prompt`` and ``output``, each ``{"dist":
"uniform", "min", "max"}`` or ``{"dist": "lognormal", "median", "sigma",
"min", "max"}`` (clipped).  The sizes and the arrival times come from the
mix's own ``base_seed``, each from a generator of its own, in the order
drawn; the run's ``--seed`` draws the prompts' token ids.  So every seed
offers the same work at the same times: the seed changes what the
requests say, not how much they ask.

A closed loop with ``"steady_start": true`` starts as if it had been
running: each client's first request is sent and prefilled before the
window opens (``cell.Window.lead_in``), and is part-way through its
output, client ``c`` of ``n`` having ``(c + 1/2) / n`` of its drawn
output left, so that requests finish, and the next ones arrive, all
through the window as they do in a loop that has run a while.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


def derive(seed: int, purpose: str) -> int:
    """A 63-bit seed from any whole number and a purpose."""
    h = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


@dataclass
class Req:
    index: int                   # position in the run's request list
    prompt: np.ndarray           # (P,) int64 token ids
    max_new: int
    due: Optional[float] = None  # open loop: seconds after the window starts
    client: int = -1             # closed loop: the caller that sends it


def _lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "uniform":
        return rng.integers(lo, hi + 1, size=n)
    if spec["dist"] == "lognormal":
        x = rng.lognormal(math.log(spec["median"]), spec["sigma"], size=n)
        return np.clip(np.rint(x), lo, hi).astype(np.int64)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def pool_size(traffic: dict, seconds: float) -> int:
    """Requests a run draws: enough for the window and what follows it."""
    if traffic["kind"] == "open":
        return int(math.ceil(traffic["rate_per_s"] * seconds * 1.25)) + 16
    return int(traffic["clients"]) * int(traffic.get("per_client", 64))


def arrivals(rate: float, n: int, base_seed: int,
             block: int = 16) -> np.ndarray:
    """``n`` due times of a Poisson-like schedule at ``rate``: in each block
    of ``block`` arrivals the gaps are the exponential distribution's
    quantiles at (j + 1/2) / block, scaled to a mean of exactly 1 / rate
    and put in an order drawn from ``base_seed``.  Gaps are exponential
    as a Poisson process's are, bursts included, but every block of
    arrivals spans the same time, so a window holds the rate's number of
    requests to within a few."""
    q = -np.log1p(-(np.arange(block) + 0.5) / block)
    q *= block / q.sum() / rate
    rng = np.random.default_rng(derive(base_seed, "arrivals"))
    gaps = np.concatenate([q[rng.permutation(block)]
                           for _ in range(-(-n // block))])[:n]
    return np.cumsum(gaps)


def make_requests(traffic: dict, seed: int, seconds: float,
                  vocab: int) -> List[Req]:
    """The run's requests, in the order they are due (open loop) or, per
    client, in the order each client sends them (closed loop).  The i-th
    request's sizes and due time do not depend on ``seconds``."""
    n = pool_size(traffic, seconds)
    base = int(traffic["base_seed"])
    p_len = _lengths(traffic["prompt"], n,
                     np.random.default_rng(derive(base, "prompt")))
    o_len = _lengths(traffic["output"], n,
                     np.random.default_rng(derive(base, "output")))
    toks = np.random.default_rng(derive(seed, "tokens"))
    reqs = [Req(i, toks.integers(0, vocab, size=int(p_len[i]),
                                 dtype=np.int64), int(o_len[i]))
            for i in range(n)]
    if traffic["kind"] == "open":
        for r, t in zip(reqs, arrivals(traffic["rate_per_s"], n, base)):
            r.due = float(t)
    elif traffic["kind"] == "closed":
        n_c = int(traffic["clients"])
        for r in reqs:
            r.client = r.index % n_c
        if traffic.get("steady_start"):
            for r in reqs[:n_c]:
                r.max_new = max(1, math.ceil((r.client + 0.5) / n_c
                                             * r.max_new))
    else:
        raise ValueError(f"unknown arrival kind {traffic['kind']!r}")
    return reqs


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least ``q``% of the values at or below it (a value that occurred)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]
