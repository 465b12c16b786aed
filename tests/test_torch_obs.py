"""The port's telemetry (``repro_torch.obs``) against the invariants of the
reference's ``tests/test_obs.py``:

  * registry semantics: label series, gauge set/add, inclusive histogram
    bucket edges, negative-increment and kind-conflict refusal, thread
    safety under a ``ThreadPoolExecutor``;
  * disabled mode records nothing: the shared ``NULL_SPAN``, and the
    instrumented executor path leaves the registry empty;
  * the span records: ids, parents on each thread's own stack, times on
    ``time.monotonic_ns()``, attributes kept out of the histogram's
    labels, the bounded buffer and its drop counter;
  * the exporters: JSON round trip, Prometheus round trip,
    ``diff_snapshots``;
  * neutrality: with telemetry on, a deploy -> calibrate -> matmul -> age
    sequence on the analytic backend, and an engine's serve through it,
    give the same bits and the same builds as with it off; the counters
    equal the executor's own build and call counts;
  * ``RecompileSentinel`` over the port's build counters;
  * a ``ServeSession`` snapshot, a ``ContinuousBatchEngine`` snapshot and
    the ``serve --telemetry`` CLI's snapshot pass
    ``tools/check_telemetry.py`` (its ``session`` and ``serve``
    profiles).
"""
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.obs import (DEFAULT_BUCKETS, NULL_SPAN, OBS,  # noqa: E402
                             MetricsRegistry, RecompileError,
                             RecompileSentinel, Telemetry, diff_snapshots,
                             parse_prometheus, snapshot, to_prometheus,
                             write_snapshot)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Tiny ops only: one intra-op thread keeps them from contending with
    the suite's other worker processes (as in test_torch_batching.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _schema():
    with open(os.path.join(REPO, "tools", "telemetry_schema.json")) as f:
        return json.load(f)


@pytest.fixture
def obs_enabled():
    """Enable the process singleton for one test, then restore it to the
    disabled default."""
    OBS.reset()
    OBS.enable()
    yield OBS
    OBS.reset()
    OBS.disable()


# --------------------------------------------------------------------------- #
# registry semantics
# --------------------------------------------------------------------------- #
def test_same_buckets_as_the_reference():
    assert DEFAULT_BUCKETS == (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2,
                               2.5e-2, 5e-2, 1e-1, 2.5e-1, 5e-1, 1.0, 2.5,
                               5.0, 10.0)


def test_counter_labels_and_aggregation():
    reg = MetricsRegistry()
    reg.counter("req_total", "requests", site="a").inc()
    reg.counter("req_total", site="a").inc(2)
    reg.counter("req_total", site="b").inc()
    series = reg.snapshot()["metrics"]["req_total"]["series"]
    assert {s["labels"]["site"]: s["value"] for s in series} == \
        {"a": 3.0, "b": 1.0}


def test_counter_rejects_negative():
    with pytest.raises(ValueError):
        MetricsRegistry().counter("n_total").inc(-1)


def test_gauge_set_and_add():
    reg = MetricsRegistry()
    g = reg.gauge("age_seconds", tag="t")
    g.set(5.0)
    g.add(2.0)
    g.set(3.5)
    (s,) = reg.snapshot()["metrics"]["age_seconds"]["series"]
    assert s["value"] == 3.5


def test_histogram_bucket_edges_inclusive():
    """Prometheus ``le``: a value on a bucket boundary counts into it."""
    reg = MetricsRegistry()
    h = reg.histogram("lat_seconds", buckets=(0.1, 1.0))
    for v in (0.05, 0.1, 0.5, 1.0, 99.0):
        h.observe(v)
    (s,) = reg.snapshot()["metrics"]["lat_seconds"]["series"]
    assert s["bucket_counts"] == [2, 2, 1]       # le=0.1, le=1.0, +Inf
    assert s["count"] == 5
    assert s["min"] == 0.05 and s["max"] == 99.0
    assert s["sum"] == pytest.approx(100.65)


def test_kind_conflict_raises():
    reg = MetricsRegistry()
    reg.counter("x_total").inc()
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x_total")


def test_thread_safety_under_pool():
    """Threads hammering one counter and one histogram series lose no
    increment (one lock per metric)."""
    reg = MetricsRegistry()
    n_threads, per_thread = 8, 500

    def work(i):
        for _ in range(per_thread):
            reg.counter("hits_total", worker="shared").inc()
            reg.histogram("t_seconds", worker="shared").observe(1e-3)
        return i

    with ThreadPoolExecutor(n_threads) as pool:
        list(pool.map(work, range(n_threads)))
    met = reg.snapshot()["metrics"]
    (c,) = met["hits_total"]["series"]
    (h,) = met["t_seconds"]["series"]
    assert c["value"] == n_threads * per_thread
    assert h["count"] == n_threads * per_thread
    assert h["sum"] == pytest.approx(n_threads * per_thread * 1e-3)


def test_span_records_seconds_and_enters_the_profiler():
    """An enabled span times its block into ``<name>_seconds``; with
    ``profiler=True`` it also shows on a ``torch.profiler`` trace."""
    t = Telemetry(enabled=True, profiler=True)
    with torch.profiler.profile() as prof:
        with t.span("serve_tick", site="s#0"):
            torch.ones(4).sum()
    (s,) = t.snapshot()["metrics"]["serve_tick_seconds"]["series"]
    assert s["count"] == 1 and s["labels"] == {"site": "s#0"}
    assert "serve_tick" in {e.key for e in prof.key_averages()}


# --------------------------------------------------------------------------- #
# disabled mode
# --------------------------------------------------------------------------- #
def test_disabled_span_is_shared_null():
    t = Telemetry(enabled=False)
    s = t.span("anything", site="x")
    assert s is NULL_SPAN
    with s:
        pass
    assert t.snapshot()["metrics"] == {}


# --------------------------------------------------------------------------- #
# span records
# --------------------------------------------------------------------------- #
def test_span_records_ids_parents_times_and_attributes():
    """Each finished span leaves one record: a fresh id, the enclosing
    span's id as parent, start and end on ``time.monotonic_ns()``, its
    labels, and its attributes, which never label the histogram."""
    import time
    t = Telemetry(enabled=True)
    lo = time.monotonic_ns()
    with t.span("serve_step", site="s#0", attrs={"tick": 7}):
        with t.span("serve_bulk_prefill", site="s#0",
                    attrs={"rid": 3, "P": 12}):
            pass
        with t.span("serve_decode", site="s#0", attrs={"tick": 7, "live": 2}):
            pass
    hi = time.monotonic_ns()
    pre, dec, step = t.take_spans()                 # in the order they end
    assert [r.name for r in (pre, dec, step)] == [
        "serve_bulk_prefill", "serve_decode", "serve_step"]
    assert len({pre.id, dec.id, step.id}) == 3 and 0 not in (pre.id, dec.id)
    assert step.parent == 0 and pre.parent == dec.parent == step.id
    assert lo <= step.t0_ns <= pre.t0_ns <= pre.t1_ns <= dec.t0_ns \
        <= dec.t1_ns <= step.t1_ns <= hi
    assert pre.attrs == {"rid": 3, "P": 12} and pre.labels == {"site": "s#0"}
    met = t.snapshot()["metrics"]
    for name in ("serve_step", "serve_bulk_prefill", "serve_decode"):
        (h,) = met[name + "_seconds"]["series"]
        assert h["labels"] == {"site": "s#0"} and h["count"] == 1
    (h,) = met["serve_step_seconds"]["series"]
    assert h["sum"] == pytest.approx((step.t1_ns - step.t0_ns) * 1e-9)
    assert t.take_spans() == []                     # taken: the buffer empty


def test_span_parents_follow_each_thread():
    """A span opened on another thread while one is open here is that
    thread's root, and a span opened inside it there is its child."""
    import threading
    t = Telemetry(enabled=True)
    inside, done = threading.Event(), threading.Event()

    def other():
        inside.wait(10)
        with t.span("loop_tick"):
            with t.span("loop_read"):
                pass
        done.set()

    th = threading.Thread(target=other)
    th.start()
    with t.span("main_step"):
        inside.set()
        assert done.wait(10)
    th.join(10)
    assert not th.is_alive()
    by = {r.name: r for r in t.take_spans()}
    assert by["main_step"].parent == 0 and by["loop_tick"].parent == 0
    assert by["loop_read"].parent == by["loop_tick"].id


def test_span_buffer_is_bounded_and_counts_what_it_drops():
    t = Telemetry(enabled=True)
    t.max_spans = 3
    for i in range(5):
        with t.span("tick", attrs={"tick": i}):
            pass
    assert [r.attrs["tick"] for r in t.take_spans()] == [2, 3, 4]
    (d,) = t.snapshot()["metrics"]["obs_spans_dropped_total"]["series"]
    assert d["value"] == 2
    with t.span("tick"):
        pass
    t.reset()                                       # records go with metrics
    assert t.take_spans() == [] and t.snapshot()["metrics"] == {}


def test_disabled_spans_leave_no_record():
    t = Telemetry(enabled=False)
    assert t.span("serve_step", site="x", attrs={"tick": 0}) is NULL_SPAN
    with t.span("serve_step"):
        pass
    t.enable()
    t.disable()
    with t.span("serve_step"):
        pass
    assert t.take_spans() == [] and t.snapshot()["metrics"] == {}


def test_disabled_hot_path_records_nothing():
    assert not OBS.enabled                        # the suite's default
    OBS.reset()
    ex = _executor()
    x, w = _data()
    ex.calibrate(_probes(), w, "quiet")
    ex.matmul(x, w, "quiet")
    assert OBS.snapshot()["metrics"] == {}


# --------------------------------------------------------------------------- #
# exporters
# --------------------------------------------------------------------------- #
def _sample_registry():
    reg = MetricsRegistry()
    reg.counter("req_total", "requests served", site="a#0").inc(3)
    reg.gauge("age_seconds", "drift age", tag='t"x').set(42.5)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.01, 0.1),
                      site="a#0")
    for v in (0.005, 0.05, 5.0):
        h.observe(v)
    return reg


def test_json_snapshot_roundtrip(tmp_path):
    reg = _sample_registry()
    path = tmp_path / "snap.json"
    write_snapshot(str(path), registry=reg)
    doc = json.loads(path.read_text())
    assert doc == reg.snapshot() == snapshot(reg)
    assert doc["schema"] == 1


def test_prometheus_roundtrip():
    """JSON snapshot -> text exposition -> parsed samples, a label value
    with an embedded quote and cumulative histogram buckets included."""
    vals = parse_prometheus(to_prometheus(_sample_registry().snapshot()))
    assert vals[("req_total", frozenset({("site", "a#0")}))] == 3.0
    assert vals[("age_seconds", frozenset({("tag", 't"x')}))] == 42.5
    by_le = {dict(k[1])["le"]: v for k, v in vals.items()
             if k[0] == "lat_seconds_bucket"}
    assert by_le == {"0.01": 1.0, "0.1": 2.0, "+Inf": 3.0}
    assert vals[("lat_seconds_count", frozenset({("site", "a#0")}))] == 3.0
    assert vals[("lat_seconds_sum",
                 frozenset({("site", "a#0")}))] == pytest.approx(5.055)


def test_diff_snapshots_zeroes_counters():
    reg = _sample_registry()
    base = reg.snapshot()
    reg.counter("req_total", site="a#0").inc(2)
    reg.counter("req_total", site="b#1").inc()       # absent from base
    d = diff_snapshots(base, reg.snapshot())
    assert d["diff"] is True
    by_site = {s["labels"]["site"]: s["value"]
               for s in d["metrics"]["req_total"]["series"]}
    assert by_site == {"a#0": 2.0, "b#1": 1.0}
    (h,) = d["metrics"]["lat_seconds"]["series"]
    assert h["count"] == 0 and h["bucket_counts"] == [0, 0, 0]
    (g,) = d["metrics"]["age_seconds"]["series"]
    assert g["value"] == 42.5                        # gauges pass through


# --------------------------------------------------------------------------- #
# neutrality: telemetry on or off changes neither builds nor bits
# --------------------------------------------------------------------------- #
def _executor(backend="analytic"):
    from repro_torch.configs.base import AnalogConfig
    from repro_torch.configs.rram_ps32 import CASE_A
    from repro_torch.core.analog import AnalogExecutor
    return AnalogExecutor(AnalogConfig(backend=backend), geom=CASE_A)


def _data(K=70, N=8, B=4, seed=0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.3).astype(np.float32))
    x = torch.from_numpy((rng.standard_normal((B, K)) * 0.5).astype(np.float32))
    return x, w


def _probes(n=4, K=70, seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((n, K)) * 0.5)
                            .astype(np.float32))


def _exercise(ex, x, w):
    """deploy -> calibrate -> matmul -> age over every instrumented analog
    path; returns (outputs, the executor's builds)."""
    from repro_torch.nonideal import Scenario, scenario_at_age
    ys = []
    ex.calibrate(_probes(), w, "par")
    ys.append(ex.matmul(x, w, "par"))
    sc = Scenario(name="par", prog_sigma=0.05, read_sigma=0.01)
    ex.deploy(scenario=sc, key=5)
    ex.calibrate(_probes(), w, "par", warm_start=True)
    ys.append(ex.matmul(x, w, "par"))
    ex.deploy(scenario=scenario_at_age(sc, 3600.0))
    ys.append(ex.matmul(x, w, "par"))
    return ys, {k: dict(v) for k, v in ex.builds.items()}


ENGINE_SPANS = {"serve_step", "serve_admit", "serve_bulk_prefill",
                "serve_prefill_forward", "serve_splice",
                "serve_first_token_read", "serve_decode",
                "serve_decode_inputs", "serve_decode_forward",
                "serve_token_read", "analog_matmul"}


def _serve(ex):
    """A short engine serve through ``ex``: (tokens, engine builds)."""
    from repro_torch.launch.batching import ContinuousBatchEngine
    from repro_torch.launch.serve import ServeSession
    sess = ServeSession("gemma3-1b", reduced=True, reduced_layers=1,
                        batch=1, prompt_len=6, gen=3, seed=0, executor=ex,
                        device="cpu")
    eng = ContinuousBatchEngine(sess, max_slots=2, max_len=9)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, sess.cfg.vocab_size, (n,)) for n in (6, 4, 5)]
    return (eng.run(prompts, max_new=3),
            (eng.prefill_traces, eng.decode_traces, eng.ticks))


def test_telemetry_is_build_and_bit_neutral(obs_enabled):
    """Identical executor and engine builds and bit-identical outputs with
    telemetry on and off; on, every span of the engine and the executor
    left its record."""
    x, w = _data()
    OBS.disable()
    ys_off, builds_off = _exercise(_executor(), x, w)
    ex_off = _executor()
    toks_off, eng_off = _serve(ex_off)
    assert OBS.snapshot()["metrics"] == {}          # really was off
    assert OBS.take_spans() == []
    OBS.enable()
    ys_on, builds_on = _exercise(_executor(), x, w)
    ex_on = _executor()
    toks_on, eng_on = _serve(ex_on)
    assert builds_on == builds_off
    assert builds_on["state"]["par"] == 3           # ideal, corner, aged
    for a, b in zip(ys_off, ys_on):
        assert torch.equal(a, b)
    assert eng_on == eng_off and ex_on.builds == ex_off.builds
    for a, b in zip(toks_off, toks_on):
        np.testing.assert_array_equal(a, b)
    assert {r.name for r in OBS.take_spans()} == ENGINE_SPANS
    met = OBS.snapshot()["metrics"]
    for name in ("analog_plan_cache_total", "analog_state_cache_total",
                 "analog_matmul_calls_total", "analog_matmul_seconds",
                 "analog_traces_total", "analog_calibration_residual",
                 "analog_calibration_probes", "analog_calibrations_total",
                 "serve_request_queue_seconds"):
        assert name in met, name
    assert {s["labels"]["tag"] for s in met["analog_matmul_seconds"][
        "series"]} >= {"par"}
    modes = {s["labels"]["mode"]: s["value"]
             for s in met["analog_calibrations_total"]["series"]}
    assert modes == {"cold": 1.0, "warm": 1.0}


def test_enabled_counters_match_the_executor(obs_enabled):
    """analog_traces_total / the plan cache's misses / the call counter
    equal the executor's own read-plan builds, plan builds and calls; the
    cache counters split hits from misses."""
    x, w = _data()
    ex = _executor()
    for _ in range(3):
        ex.matmul(x, w, "ct")
    met = OBS.snapshot()["metrics"]

    def total(name, **labels):
        return sum(s["value"] for s in met[name]["series"]
                   if all(s["labels"].get(k) == v for k, v in labels.items()))

    assert total("analog_traces_total", tag="ct") == ex.builds["read"]["ct"] == 3
    assert total("analog_plan_cache_total", tag="ct", event="miss") == \
        ex.builds["plan"]["ct"] == 1
    assert total("analog_matmul_calls_total", tag="ct", mode="eager") == \
        ex.calls["ct"] == 3
    assert total("analog_plan_cache_total", tag="ct", event="hit") >= 3
    assert total("analog_state_cache_total", tag="ct", event="miss") == \
        ex.builds["state"]["ct"] == 1
    # B1's thread blocks and items, counted where the kernel launches: on
    # the CPU the plain version runs and both stay 0
    assert total("analog_b1_ctas_total", tag="ct") == \
        total("analog_b1_items_total", tag="ct") == 0


def test_b1_walk_counters_follow_the_kernel_per_tag(obs_enabled, monkeypatch):
    """analog_b1_ctas_total / analog_b1_items_total add what the kernel's
    own ``.ctas`` / ``.items`` gained during each call to the call's tag:
    here a stand-in launch of 264 thread blocks over 6,144 items a call
    (a decode call at command-r-plus's sites on an H100)."""
    from repro_torch.core import analog
    from repro_torch.kernels.emulator_block.emulator_block import \
        emulator_block_unified_cuda as b1
    real = analog._STMatmul.apply

    def launched(*args):
        b1.ctas += 264
        b1.items += 6144
        return real(*args)

    monkeypatch.setattr(analog._STMatmul, "apply", launched)
    monkeypatch.setattr(b1, "ctas", b1.ctas)
    monkeypatch.setattr(b1, "items", b1.items)
    x, w = _data()
    ex = _executor()
    for tag, n in (("up", 3), ("down", 2)):
        for _ in range(n):
            ex.matmul(x, w, tag)
    met = OBS.snapshot()["metrics"]
    got = {(name, s["labels"]["tag"]): s["value"]
           for name in ("analog_b1_ctas_total", "analog_b1_items_total")
           for s in met[name]["series"]}
    assert got == {("analog_b1_ctas_total", "up"): 3 * 264,
                   ("analog_b1_ctas_total", "down"): 2 * 264,
                   ("analog_b1_items_total", "up"): 3 * 6144,
                   ("analog_b1_items_total", "down"): 2 * 6144}


def test_the_plan_cache_keeps_a_view_of_the_same_weight():
    """A stacked period's weight is a new view ``stack[p]`` on every
    forward: it is the same weight, and the plan is built once."""
    x, _ = _data()
    stack = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 70, 8)).astype(np.float32))
    ex = _executor()
    for _ in range(3):
        ex.matmul(x, stack[1], "stacked")
    assert ex.builds["plan"]["stacked"] == 1
    ex.matmul(x, stack[0], "stacked")               # another weight: rebuilt
    assert ex.builds["plan"]["stacked"] == 2


# --------------------------------------------------------------------------- #
# RecompileSentinel
# --------------------------------------------------------------------------- #
class _Built:
    """A callable that exposes its build count."""

    def __init__(self):
        self.builds = 0

    def __call__(self, rebuild=False):
        if rebuild or not self.builds:
            self.builds += 1


def test_sentinel_passes_a_build_once_block():
    fn = _Built()
    with RecompileSentinel(fns=[fn], label="ok") as sent:
        for _ in range(5):
            fn()
    assert sent.ok and sent.new_counts == {"fn[0]": 1}


def test_sentinel_strict_raises_and_non_strict_records():
    fn = _Built()
    with pytest.raises(RecompileError, match="fn\\[0\\]"):
        with RecompileSentinel(fns=[fn], label="churn"):
            fn()
            fn(rebuild=True)
    fn2 = _Built()
    with RecompileSentinel(fns=[fn2], strict=False) as sent:
        fn2()
        fn2(rebuild=True)
    assert sent.ok is False
    assert sent.violations == {"fn[0]": 2}


def test_sentinel_watches_executor_tags_created_inside():
    x, w = _data()
    ex = _executor()
    ex.matmul(x, w, "old")
    with RecompileSentinel(executor=ex, label="exec") as sent:
        ex.matmul(x, w, "old")
        ex.matmul(x, w, "new_tag")                # a tag born in the block
    assert sent.ok
    assert sent.new_counts == {
        "executor.plan[old]": 0, "executor.state[old]": 0,
        "executor.read[old]": 1,      # a new ideal state each call: one read
        "executor.plan[new_tag]": 1, "executor.state[new_tag]": 1,
        "executor.read[new_tag]": 1}


def test_sentinel_records_outcome_metric(obs_enabled):
    fn = _Built()
    with RecompileSentinel(fns=[fn], strict=False, label="ci"):
        fn()
        fn(rebuild=True)
    met = OBS.snapshot()["metrics"]
    (s,) = [r for r in met["obs_sentinel_checks_total"]["series"]
            if r["labels"]["label"] == "ci"]
    assert s["labels"]["outcome"] == "violation" and s["value"] == 1.0
    (g,) = met["obs_sentinel_new_traces"]["series"]
    assert g["labels"] == {"label": "ci", "watch": "fn[0]"} and g["value"] == 2


# --------------------------------------------------------------------------- #
# end to end: snapshots that validate against the reference's schema
# --------------------------------------------------------------------------- #
def test_session_snapshot_validates_against_schema(obs_enabled, tmp_path):
    """A short port ``ServeSession`` on the analytic backend, watched by a
    sentinel, exports a snapshot that passes the ``session`` profile."""
    import check_telemetry
    from repro_torch.launch.serve import ServeSession
    ex = _executor()
    sess = ServeSession("gemma3-1b", reduced=True, reduced_layers=2,
                        batch=2, prompt_len=8, gen=4, seed=0, executor=ex,
                        device="cpu")
    with RecompileSentinel(session=sess, executor=ex, label="test-serve") \
            as sent:
        sess.generate()
    # a generate serves new states (its read cycle): one read plan each
    with RecompileSentinel(session=sess, executor=ex, label="again") as again:
        sess.generate()
    assert sent.ok and again.ok
    assert sess.prefill_traces == sess.decode_traces == 1
    assert set(again.new_counts.values()) == {0, 1}
    assert all(v == (k.startswith("executor.read")) for k, v in
               again.new_counts.items())
    path = tmp_path / "snap.json"
    write_snapshot(str(path))
    snap = json.loads(path.read_text())
    errs = check_telemetry.check(snap, _schema())
    assert not errs, "\n".join(errs)
    met = snap["metrics"]
    for name in ("serve_prefill_seconds", "serve_decode_seconds"):
        (s,) = met[name]["series"]
        assert s["count"] == 2 and s["labels"]["site"] == sess.site
    (s,) = [r for r in met["serve_decode_step_seconds"]["series"]]
    assert s["count"] == 2 * (4 - 1)
    (t,) = met["serve_tokens_total"]["series"]
    assert t["value"] == 2 * 2 * (8 + 4)
    events = {s["labels"]["event"]
              for s in met["analog_plan_cache_total"]["series"]}
    assert events == {"hit", "miss"}
    assert len(met["serve_state_swaps_total"]["series"]) == len(sess.sites())


def test_engine_snapshot_validates_against_serve_profile(obs_enabled):
    """A ``ContinuousBatchEngine`` serve passes the ``serve`` profile, and
    a sentinel violation recorded in it fails both profiles."""
    import check_telemetry
    from repro_torch.launch.batching import ContinuousBatchEngine
    from repro_torch.launch.serve import ServeSession
    sess = ServeSession("gemma3-1b", reduced=True, reduced_layers=2,
                        batch=1, prompt_len=6, gen=4, seed=0, device="cpu")
    eng = ContinuousBatchEngine(sess, max_slots=2, max_len=10, page_size=4)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, sess.cfg.vocab_size, (n,)) for n in (6, 3, 5)]
    with RecompileSentinel(session=eng, label="engine") as sent:
        eng.run(prompts, max_new=4)
    assert sent.ok and eng.decode_traces == eng.prefill_traces == 1
    snap = snapshot()
    assert not check_telemetry.check(snap, _schema(), profile="serve")
    met = snap["metrics"]
    kinds = {s["labels"]["kind"]: s["value"]
             for s in met["serve_engine_tokens_total"]["series"]}
    assert kinds == {"prefill": 6 + 3 + 5, "decode": 3 * (4 - 1)}
    (r,) = met["serve_requests_total"]["series"]
    assert r["labels"]["outcome"] == "done" and r["value"] == 3
    (o,) = met["serve_batch_occupancy"]["series"]
    assert o["labels"]["slots"] == "2" and o["max"] <= 2
    with RecompileSentinel(fns=[_Built()], strict=False, label="bad") as bad:
        bad.fns[0]()
        bad.fns[0](rebuild=True)
    errs = check_telemetry.check(snapshot(), _schema(), profile="serve")
    assert any("forbidden" in e for e in errs)


def test_serve_cli_telemetry_writes_a_valid_snapshot(tmp_path, capsys):
    """``serve --telemetry PATH --device cpu`` enables telemetry and writes
    a snapshot ``tools/check_telemetry.py`` accepts; a bare flag prints
    it."""
    import check_telemetry
    from repro_torch.launch import serve
    path = tmp_path / "snap.json"
    base = ["--arch", "gemma3-1b", "--reduced", "--layers", "1", "--device",
            "cpu", "--batch", "1", "--prompt-len", "4", "--gen", "2",
            "--analog-backend", "analytic"]
    try:
        OBS.reset()
        serve.main(base + ["--telemetry", str(path)])
        assert OBS.enabled
        assert check_telemetry.main([str(path)]) == 0
        OBS.reset()
        capsys.readouterr()
        serve.main(base + ["--telemetry"])
        out = capsys.readouterr().out
        doc = json.loads(out[out.index("{"):out.rindex("}") + 1])
        assert not check_telemetry.check(doc, _schema())
    finally:
        OBS.reset()
        OBS.disable()
