"""The traffic generator and the window's timing arithmetic, on the CPU:
the generator's determinism, open-loop timing from the due time, and the
tail's treatment of a request that never got its first token."""
import collections
import math
import time
import types

import numpy as np
import pytest
import torch

from perfbench import cell as C
from perfbench import loadgen

CHAT = {"kind": "open", "rate_per_s": 2.4, "base_seed": 5,
        "prompt": {"dist": "lognormal", "median": 32, "sigma": 0.6,
                   "min": 16, "max": 128},
        "output": {"dist": "uniform", "min": 8, "max": 32}}
BATCH = {"kind": "closed", "clients": 8, "per_client": 4, "base_seed": 5,
         "prompt": {"dist": "uniform", "min": 8, "max": 32},
         "output": {"dist": "uniform", "min": 64, "max": 128}}


def _sig(reqs):
    return [(r.index, r.prompt.tolist(), r.max_new, r.due, r.client)
            for r in reqs]


@pytest.mark.parametrize("traffic", [CHAT, BATCH], ids=["open", "closed"])
def test_same_seed_same_requests(traffic):
    a = loadgen.make_requests(traffic, 2**31 + 77, 45, 32064)
    b = loadgen.make_requests(traffic, 2**31 + 77, 45, 32064)
    assert _sig(a) == _sig(b)
    c = loadgen.make_requests(traffic, 2**31 + 78, 45, 32064)
    # another seed: the same sizes at the same times, other token ids
    assert [(r.prompt.size, r.max_new, r.due) for r in a] == \
        [(r.prompt.size, r.max_new, r.due) for r in c]
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))
    lo, hi = traffic["prompt"]["min"], traffic["prompt"]["max"]
    assert all(lo <= r.prompt.size <= hi for r in a)
    assert all(0 <= int(r.prompt.max()) < 32064 for r in a)


def test_request_does_not_depend_on_the_window():
    a = loadgen.make_requests(CHAT, 9, 10, 1000)
    b = loadgen.make_requests(CHAT, 9, 45, 1000)
    assert _sig(a) == _sig(b[:len(a)])


def test_a_steady_start_staggers_the_first_outputs():
    """Client c of n starts with (c + 1/2) / n of its first output left;
    every later request keeps its drawn length."""
    plain = loadgen.make_requests(BATCH, 3, 45, 1000)
    steady = loadgen.make_requests(dict(BATCH, steady_start=True), 3, 45,
                                   1000)
    n = BATCH["clients"]
    for a, b in zip(plain[:n], steady[:n]):
        assert b.max_new == math.ceil((a.client + 0.5) / n * a.max_new)
        assert b.prompt.size == a.prompt.size and b.max_new <= a.max_new
    assert _sig(plain[n:]) == _sig(steady[n:])


def test_arrivals_hold_the_rate():
    due = loadgen.arrivals(2.4, 400, 5)
    assert np.all(np.diff(due) > 0)
    for w in (45, 90, 150):
        assert abs(int((due < w).sum()) - 2.4 * w) <= 16
    gaps = np.diff(due[:160])
    assert gaps.min() < 0.05 / 2.4 and gaps.max() > 2.5 / 2.4   # bursts


def test_percentile_nearest_rank():
    v = list(range(1, 101))
    assert loadgen.percentile(v, 90) == 90
    assert loadgen.percentile(v, 95) == 95
    assert loadgen.percentile([3.0], 99) == 3.0
    assert loadgen.percentile(v[:87], 90) == 79


# --------------------------------------------------------------------------- #
# The window's loop on a stand-in engine (no model): what it times
# --------------------------------------------------------------------------- #
class FakeEngine:
    """One token a live request a step, ``tick`` seconds a step; step
    ``stall_at`` (0-based) takes ``stall`` seconds more."""

    def __init__(self, slots=4, tick=0.01, stall_at=None, stall=0.0):
        self.max_slots, self.tick = slots, tick
        self.stall_at, self.stall, self.n = stall_at, stall, 0
        self.queue, self.requests = collections.deque(), {}
        self.slots = [None] * slots
        self._prefill = lambda b, states: (None, None)
        self._decode = lambda tok, cache, pos, states: (None, cache)

    def _prefill_fn(self):
        return self._prefill

    def _decode_fn(self):
        return self._decode

    def submit(self, prompt, max_new):
        rid = len(self.requests)
        self.requests[rid] = types.SimpleNamespace(
            rid=rid, prompt=np.asarray(prompt), max_new=max_new, out=[],
            t_first=None, done=False, slot=-1, next_pos=0)
        self.queue.append(rid)
        return rid

    def _bulk_prefill(self, req):
        self._prefill(None, None)
        req.out.append(0)
        req.t_first = time.monotonic()
        req.next_pos = req.prompt.size

    @property
    def busy(self):
        return bool(self.queue) or any(s is not None for s in self.slots)

    def step(self):
        for i, s in enumerate(self.slots):
            if s is None and self.queue:
                rid = self.queue.popleft()
                self.slots[i] = rid
                self._bulk_prefill(self.requests[rid])
        time.sleep(self.tick + (self.stall if self.n == self.stall_at else 0))
        self.n += 1
        if any(s is not None for s in self.slots):
            self._decode(None, None, None, None)
        for i, rid in enumerate(self.slots):
            if rid is None:
                continue
            r = self.requests[rid]
            r.out.append(0)
            r.next_pos += 1
            if len(r.out) >= r.max_new:
                r.done, self.slots[i] = True, None
        return []


def _window(engine, traffic, seconds):
    reqs = [r for r in loadgen.make_requests(traffic, 1, seconds, 100)]
    prog = types.SimpleNamespace(engine=engine, device=torch.device("cpu"),
                                 ex=types.SimpleNamespace(matmul=None),
                                 kv_layers=None)
    win = C.Window(prog, reqs, [], [])
    rec = C.Record(cell="t", cfg={}, sites=[], max_slots=engine.max_slots,
                   setup_s=0.0, start=0.0, end=0.0, requests=[])
    win.run(rec, seconds, traffic)
    return rec


FAST = dict(CHAT, rate_per_s=40.0, drain_first_tokens=True,
            prompt={"dist": "uniform", "min": 4, "max": 4},
            output={"dist": "uniform", "min": 2, "max": 2})


def test_open_loop_times_from_the_due_time():
    """A stall of the engine shows in the TTFT of every request due while
    it lasted: each is timed from when it was due, not when it was sent."""
    rec = _window(FakeEngine(slots=8, tick=0.005, stall_at=20, stall=0.3),
                  FAST, 1.2)
    steps = rec.steps
    t0, t1 = max(steps, key=lambda s: s[1] - s[0])
    assert t1 - t0 >= 0.3
    during = [r for r in rec.requests if t0 + 0.01 < r.due < t1 - 0.01]
    assert len(during) >= 5
    for r in during:
        assert r.sent >= t1 - 1e-3                 # sent after the stall
        assert r.times[0] - r.due >= t1 - r.due - 1e-3
    ttft = C.metric_reader("ttft_p90_ms")(rec)
    assert ttft >= 0.9 * min(1e3 * (r.times[0] - r.due) for r in during)
    lag = C.metric_reader("send_lag_p99_ms.chat")(rec)
    assert lag >= 1e3 * (t1 - during[-1].due) - 1.0
    assert C.metric_reader("tokens_per_s")(rec) > 0
    assert C.metric_reader("itl_p95_ms")(rec) > 0


def test_a_missing_request_counts_against_the_tail():
    """A request with no first token sorts as infinitely late: one pushes
    the p90 up, and once more than a tenth are missing it reads none."""
    rec = _window(FakeEngine(slots=8, tick=0.005), FAST, 0.6)
    due = sorted(rec.due_in_window(), key=lambda r: r.times[0] - r.due)
    assert len(due) >= 10 and all(r.times for r in due)
    base = C.metric_reader("ttft_p90_ms")(rec)
    due[0].times = []                       # the fastest request goes missing
    assert C.metric_reader("ttft_p90_ms")(rec) >= base
    for r in due[1:math.ceil(0.1 * len(due)) + 1]:
        r.times = []
    assert C.metric_reader("ttft_p90_ms")(rec) is None
