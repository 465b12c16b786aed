"""The port's serving plane (``repro_torch.launch.batching``) against the
invariants of the reference's ``tests/test_serve_loop.py``, on the CPU at
reduced gemma3-1b (P = 8, G = 8):

  * batched serving equals sequential batch-1 port sessions token for
    token, with staggered admission and slot reuse; at the analytic
    ideal corner too, under a ``RecompileSentinel``;
  * packed prefill equals packed-solo runs, with one decode build and no
    prefill build;
  * the page pool's unit test and its invariants through the request
    lifecycle, the queue's backpressure (``QueueFull``), cancel, and
    ``AsyncBatchServer`` equal to solo runs;
  * the scheduler and pool property tests, with the reference's seeds;
  * parity with the reference: the same converted params and prompts
    through the reference's engine and the port's give the same tokens,
    in fp32 compute and in bf16 at ``torch_parity``'s short horizon;
  * decode at a (B,) position vector equals the scalar path row by row
    (global and local attention, recurrentgemma's RG-LRU rows);
  * recurrentgemma-2b through the engine, bulk and packed (the recurrent
    splice and the zeroed row at admission).
"""
import asyncio

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro_torch.launch.batching import (AsyncBatchServer,  # noqa: E402
                                         ContinuousBatchEngine, KVPagePool,
                                         QueueFull)
from repro_torch.launch.serve import ServeSession  # noqa: E402
from repro_torch.obs import RecompileSentinel  # noqa: E402

ARCH = "gemma3-1b"
P, G = 8, 8


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """These tests run many tiny ops: beside the suite's other worker
    processes, more intra-op threads only contend (measured: 202 s with
    the default threads against 20 s with one, on a loaded 8-core CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(n, length, vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, length) for _ in range(n)]


def _session(arch=ARCH, **kw):
    kw.setdefault("prompt_len", P)
    kw.setdefault("gen", G)
    return ServeSession(arch, reduced=True, batch=1, seed=0, device="cpu",
                        **kw)


def _sequential_reference(sess, prompts, gen=G, states=None):
    """Sequential batch-1 generates through one session."""
    outs = []
    for p in prompts:
        sess.batch = {"tokens": torch.as_tensor(p[None])}
        sess.P, sess.G = len(p), gen
        outs.append(sess.generate(states=states)["tokens"][0])
    return outs


@pytest.fixture(scope="module")
def digital():
    """A shared digital session, a 4-slot engine and each prompt's tokens
    served alone through it."""
    sess = _session()
    eng = ContinuousBatchEngine(sess, max_slots=4, max_len=P + G)
    prompts = _prompts(6, P, sess.cfg.vocab_size)
    expected = [eng.run([p], max_new=G)[0] for p in prompts]
    return sess, eng, prompts, expected


# --------------------------------------------------------------------------- #
# Batched against sequential sessions
# --------------------------------------------------------------------------- #
def test_batched_bit_identical_to_sequential_sessions(digital):
    sess, eng, prompts, _ = digital
    refs = _sequential_reference(_session(), prompts[:4])
    outs = eng.run(prompts[:4], max_new=G)
    for r, o in zip(refs, outs):
        np.testing.assert_array_equal(r, o)
    eng.pool.check()


def test_staggered_admission_and_slot_reuse_bit_identical(digital):
    """More requests than slots, of several lengths: waves and slot reuse
    leak no previous occupant's cache into a new request."""
    sess, _, _, _ = digital
    prompts = [p[:n] for p, n in zip(_prompts(6, P, sess.cfg.vocab_size, 2),
                                     (8, 3, 5, 8, 1, 6))]
    eng2 = ContinuousBatchEngine(sess, max_slots=2, max_len=P + G)
    outs = eng2.run(prompts, max_new=G)
    refs = _sequential_reference(_session(), prompts)
    for r, o in zip(refs, outs):
        np.testing.assert_array_equal(r, o)
    eng2.pool.check()


def test_batched_bit_identical_ideal_corner_analog():
    """At the analytic ideal corner, batched serving with the per-site
    states equals sequential batch-1 sessions, with one build of each
    step, plan, state and read plan."""
    from repro_torch.configs.base import AnalogConfig
    from repro_torch.configs.rram_ps32 import CASE_A
    from repro_torch.core.analog import AnalogExecutor

    def mk():
        return AnalogExecutor(AnalogConfig(backend="analytic",
                                           layers=("mlp",)), geom=CASE_A)

    Ga = 4
    ref_sess = _session(gen=Ga, executor=mk())
    prompts = _prompts(2, P, ref_sess.cfg.vocab_size)
    refs = _sequential_reference(ref_sess, prompts, gen=Ga)

    ex = mk()
    sess = _session(gen=Ga, executor=ex)
    eng = ContinuousBatchEngine(sess, max_slots=2, max_len=P + Ga)
    with RecompileSentinel(session=eng, executor=ex, label="serve-loop") \
            as sent:
        outs = eng.run(prompts, max_new=Ga)
    for r, o in zip(refs, outs):
        np.testing.assert_array_equal(r, o)
    assert eng.decode_traces == 1 and eng.prefill_traces == 1
    assert sent.new_counts and set(sent.new_counts.values()) == {1}
    # the sessions served through the same states: no new build at all
    with RecompileSentinel(executor=ex, max_traces=0, label="again"):
        _sequential_reference(sess, prompts, gen=Ga, states=eng._st())


def test_a_tick_with_a_bulk_prefill_records_the_span_tree():
    """With telemetry on, one ``step()`` that admits a request records the
    engine's span tree -- the admission's bulk prefill (forward, splice,
    first-token read), then the decode (inputs, forward, token read) --
    with an ``analog_matmul`` under both forwards; the request's stamps
    are ordered submit <= admit <= first token."""
    from repro_torch.configs.base import AnalogConfig
    from repro_torch.configs.rram_ps32 import CASE_A
    from repro_torch.core.analog import AnalogExecutor
    from repro_torch.obs import OBS

    ex = AnalogExecutor(AnalogConfig(backend="analytic", layers=("mlp",)),
                        geom=CASE_A)
    sess = _session(gen=4, executor=ex)
    eng = ContinuousBatchEngine(sess, max_slots=2, max_len=P + 4)
    prompt = _prompts(1, 5, sess.cfg.vocab_size)[0]
    rid = eng.submit(prompt, max_new=4)
    OBS.reset()
    OBS.enable()
    try:
        eng.step()
        recs = OBS.take_spans()
        met = OBS.snapshot()["metrics"]
    finally:
        OBS.reset()
        OBS.disable()
    kids = {}
    for r in recs:
        kids.setdefault(r.parent, []).append(r)
    for v in kids.values():
        v.sort(key=lambda r: r.t0_ns)

    def names(r, skip=()):
        return [c.name for c in kids.get(r.id, []) if c.name not in skip]

    (step,) = kids[0]
    assert step.name == "serve_step" and step.attrs == {"tick": 0}
    admit, dec = kids[step.id]
    assert (admit.name, dec.name) == ("serve_admit", "serve_decode")
    (bulk,) = kids[admit.id]
    assert bulk.name == "serve_bulk_prefill"
    assert bulk.attrs == {"rid": rid, "P": 5}
    assert names(bulk) == ["serve_prefill_forward", "serve_splice",
                           "serve_first_token_read"]
    assert dec.attrs == {"tick": 0, "live": 1}
    assert names(dec) == ["serve_decode_inputs", "serve_decode_forward",
                          "serve_token_read"]
    for fwd in (kids[bulk.id][0], kids[dec.id][1]):
        mm = names(fwd)
        assert mm and set(mm) == {"analog_matmul"}
    for r in recs:                                 # children inside parents
        if r.parent:
            (p,) = [q for q in recs if q.id == r.parent]
            assert p.t0_ns <= r.t0_ns <= r.t1_ns <= p.t1_ns
    req = eng.requests[rid]
    assert req.t_submit <= req.t_admit <= req.t_first
    assert bulk.t0_ns * 1e-9 <= req.t_first + 1e-6
    (q,) = met["serve_request_queue_seconds"]["series"]
    assert q["count"] == 1 and set(q["labels"]) == {"site", "arch"}
    (h,) = met["serve_bulk_prefill_seconds"]["series"]
    assert h["labels"] == {"site": eng.site}        # rid and P: records only


# --------------------------------------------------------------------------- #
# Packed prefill: mixed prefill and decode rows, one decode build
# --------------------------------------------------------------------------- #
def test_mixed_prefill_decode_compile_once_packed(digital):
    sess, _, prompts, _ = digital
    eng = ContinuousBatchEngine(sess, max_slots=4, max_len=P + G,
                                prefill_mode="packed")
    with RecompileSentinel(session=eng, label="packed") as sent:
        r0 = eng.submit(prompts[0], G)
        r1 = eng.submit(prompts[1], G)
        for _ in range(P // 2):          # r0/r1 mid-prefill...
            eng.step()
        r2 = eng.submit(prompts[2], G)   # ...r2/r3 admitted mid-flight
        r3 = eng.submit(prompts[3], G)
        eng.drain()
    assert sent.ok
    assert eng.decode_traces == 1 and eng.prefill_traces == 0
    solo = [eng.run([p], max_new=G)[0] for p in prompts[:4]]
    for rid, exp in zip((r0, r1, r2, r3), solo):
        np.testing.assert_array_equal(eng.result(rid), exp)
    assert eng.decode_traces == 1


def test_a_dropped_session_or_engine_frees_at_once():
    """No reference cycle keeps a served session or engine (and with it
    the params, plans and caches on the device) alive until the cyclic
    collector runs."""
    import gc
    import weakref
    gc.disable()
    try:
        sess = _session(gen=2)
        sess.generate()
        eng = ContinuousBatchEngine(sess, max_slots=2, max_len=P + 2)
        eng.run(_prompts(2, P, sess.cfg.vocab_size), max_new=2)
        refs = weakref.ref(sess), weakref.ref(eng)
        del sess, eng
        assert refs[0]() is None and refs[1]() is None
    finally:
        gc.enable()


# --------------------------------------------------------------------------- #
# KV page pool
# --------------------------------------------------------------------------- #
def test_page_pool_unit():
    pool = KVPagePool(n_slots=3, max_seq=16, page_size=4)
    assert pool.total_pages == 12 and pool.pages_for(16) == 4
    assert pool.reserve(0, 16) and pool.reserve(1, 9)
    pool.check()
    assert pool.in_use() == 4 + 3
    assert not pool.reserve(0, 4), "slot already owns pages"
    assert not pool.reserve(2, 24), "over capacity refuses whole request"
    pool.check()
    freed = pool.release(0)
    assert len(freed) == 4 and pool.release(0) == []
    pool.check()
    small = KVPagePool(n_slots=4, max_seq=16, page_size=4, total_pages=6)
    assert small.reserve(0, 16)
    assert not small.can_admit(16) and not small.reserve(1, 16)
    small.check()


def test_kv_page_invariants_through_lifecycle(digital):
    """admit / finish / cancel never leak or double-assign a page, and
    occupancy never exceeds the slots."""
    sess, _, prompts, _ = digital
    eng = ContinuousBatchEngine(sess, max_slots=2, max_len=P + G)
    rids = [eng.submit(p, max_new=2 + i % 3) for i, p in enumerate(prompts)]
    cancelled = rids[3]
    n_busy = 0
    while eng.busy:
        eng.step()
        live = [r for r in eng.slots if r is not None]
        assert len(live) <= eng.max_slots
        assert len(set(live)) == len(live), "request in two slots"
        assert set(eng.pool.owned) == {eng.requests[r].slot for r in live}
        eng.pool.check()
        n_busy += 1
        if n_busy == 2 and not eng.requests[cancelled].done:
            eng.cancel(cancelled)
            eng.pool.check()
    assert eng.pool.in_use() == 0
    assert len(eng.pool.free) == eng.pool.total_pages
    assert eng.requests[cancelled].status == "cancelled"
    for rid in rids:
        if rid != cancelled:
            assert len(eng.result(rid)) == eng.requests[rid].max_new


def test_pool_refuses_what_it_cannot_hold_and_the_queue_waits(digital):
    """A pool smaller than the slots' need: admission stops at the pool
    (the rest wait in the queue) and every request still completes."""
    sess, _, prompts, expected = digital
    pool = KVPagePool(2, 8, page_size=8)
    assert pool.reserve(0, 8) and not pool.can_admit(24)
    eng = ContinuousBatchEngine(sess, max_slots=4, max_len=P + G,
                                page_size=4, total_pages=8)   # 2 requests
    rids = [eng.submit(p, G) for p in prompts[:4]]
    assert eng.try_admit() == 2 and len(eng.queue) == 2
    eng.drain()
    for rid, exp in zip(rids, expected):
        np.testing.assert_array_equal(eng.result(rid), exp)


def test_engine_queue_backpressure(digital):
    sess, _, prompts, _ = digital
    eng = ContinuousBatchEngine(sess, max_slots=1, max_len=P + G,
                                max_queue=2)
    eng.submit(prompts[0], 2)
    eng.submit(prompts[1], 2)
    with pytest.raises(QueueFull):
        eng.submit(prompts[2], 2)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(prompts[2][:4], P + G)
    eng.cancel(1)                                    # a queued request
    assert list(eng.queue) == [0] and eng.requests[1].status == "cancelled"
    eng.drain()
    assert eng.result(1).size == 0 and eng.result(0).size == 2


# --------------------------------------------------------------------------- #
# Property tests
# --------------------------------------------------------------------------- #
@settings(max_examples=10, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10**9))
def test_scheduler_never_drops_dups_or_reorders(digital, seed):
    """Random admit / step / cancel interleavings: a finished request's
    tokens equal its solo run; a cancelled one holds a prefix of it."""
    sess, eng, prompts, expected = digital
    assert not eng.busy
    rng = np.random.default_rng(seed)
    n_req = int(rng.integers(1, len(prompts) + 1))
    order = rng.permutation(len(prompts))[:n_req]
    rids = {}
    for j, pi in enumerate(order):
        rids[int(pi)] = eng.submit(prompts[pi], max_new=G)
        for _ in range(int(rng.integers(0, 4))):
            eng.step()
            eng.pool.check()
        if rng.random() < 0.25:
            victim = int(rng.choice(order[:j + 1]))
            if not eng.requests[rids[victim]].done:
                eng.cancel(rids[victim])
    eng.drain()
    for pi, rid in rids.items():
        got, exp = eng.result(rid), expected[pi]
        if eng.requests[rid].status == "done":
            np.testing.assert_array_equal(got, exp)
        else:
            np.testing.assert_array_equal(got, exp[:len(got)])
    assert eng.pool.in_use() == 0


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10**9))
def test_page_pool_random_ops_hold_invariants(seed):
    rng = np.random.default_rng(seed)
    pool = KVPagePool(n_slots=4, max_seq=32,
                      page_size=int(rng.integers(1, 9)),
                      total_pages=int(rng.integers(4, 20)))
    for _ in range(50):
        slot = int(rng.integers(0, 4))
        if rng.random() < 0.5:
            pool.reserve(slot, int(rng.integers(1, 40)))
        else:
            pool.release(slot)
        pool.check()
        assert pool.in_use() + len(pool.free) == pool.total_pages


# --------------------------------------------------------------------------- #
# Async facade
# --------------------------------------------------------------------------- #
def test_async_server_matches_solo(digital):
    sess, eng, prompts, expected = digital

    async def go():
        with AsyncBatchServer(eng) as srv:
            return await asyncio.gather(
                *[srv.generate(p, G) for p in prompts[:4]])

    outs = asyncio.run(go())
    for o, exp in zip(outs, expected[:4]):
        np.testing.assert_array_equal(o, exp)
    assert eng.pool.in_use() == 0


def test_async_server_under_many_submitting_threads(digital):
    """More submitting threads than cores, with a short switch interval:
    every future resolves to its prompt's solo tokens."""
    import os
    import sys
    import threading
    sess, eng, prompts, expected = digital
    n = 2 * (os.cpu_count() or 4)
    futs = [None] * n
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with AsyncBatchServer(eng) as srv:
            def submit(i):
                futs[i] = srv.submit(prompts[i % len(prompts)], G)
            threads = [threading.Thread(target=submit, args=(i,))
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
            outs = [f.result(timeout=600) for f in futs]
    finally:
        sys.setswitchinterval(old)
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, expected[i % len(prompts)])
    assert eng.pool.in_use() == 0 and not eng.busy


def test_async_server_loop_runs_without_grad_and_reports_failures(digital):
    """The loop thread serves under ``no_grad`` (grad mode is per thread),
    and a failing tick fails its futures and ``stop()``."""
    sess, eng, prompts, _ = digital
    seen = []
    real = sess._decode_step

    def spy(*a):
        seen.append(torch.is_grad_enabled())
        return real(*a)

    sess._decode_step = spy
    try:
        with AsyncBatchServer(eng) as srv:
            srv.submit(prompts[0], 3).result(timeout=300)
    finally:
        sess._decode_step = real
    assert seen and not any(seen)
    eng2 = ContinuousBatchEngine(sess, max_slots=2, max_len=P + G)
    eng2._decode = lambda *a: (_ for _ in ()).throw(RuntimeError("tick"))
    srv = AsyncBatchServer(eng2).start()
    fut = srv.submit(prompts[0], 3)
    with pytest.raises(RuntimeError, match="tick"):
        fut.result(timeout=300)
    with pytest.raises(RuntimeError, match="tick"):
        srv.stop()


# --------------------------------------------------------------------------- #
# Parity with the reference's engine
# --------------------------------------------------------------------------- #
def _both_engines(compute, Gp, n=3, slots=2):
    """The reference's and the port's engine on the reference session's
    params (converted through ``interop``) and the same prompts; in
    ``compute`` (float32 or bfloat16) with params of that dtype."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ParallelConfig as RefPcfg
    from repro.launch.batching import ContinuousBatchEngine as RefEngine
    from repro.launch.serve import ServeSession as RefSession
    from repro.runtime import steps as RS
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.interop import params_from_numpy
    from repro_torch.runtime import steps as S
    from torch_parity import tree_np

    rs = RefSession(ARCH, reduced=True, batch=1, prompt_len=P, gen=Gp,
                    seed=0)
    ts = _session(gen=Gp, params=params_from_numpy(tree_np(rs.params),
                                                   device="cpu"))
    if compute == "float32":
        rs.params = jax.tree.map(lambda v: v.astype(jnp.float32), rs.params)
        rpc = RefPcfg(compute_dtype="float32", attn_block_kv=P,
                      xent_chunk=128, scan_chunk=P)
        rs._prefill_step = RS.make_prefill_step(rs.cfg, rpc)
        rs._decode_step = RS.make_decode_step(rs.cfg, rpc)
        ts.params = params_from_numpy(tree_np(rs.params), device="cpu")
        tpc = ParallelConfig(compute_dtype="float32", attn_block_kv=P)
        ts._prefill_step = S.make_prefill_step(ts.cfg, tpc)
        ts._decode_step = S.make_decode_step(ts.cfg, tpc)
    prompts = _prompts(n, P, rs.cfg.vocab_size, seed=5)
    ref = RefEngine(rs, max_slots=slots, max_len=P + Gp).run(
        [p.astype(np.int32) for p in prompts], max_new=Gp)
    port = ContinuousBatchEngine(ts, max_slots=slots, max_len=P + Gp).run(
        prompts, max_new=Gp)
    return ref, port


@pytest.mark.parametrize("compute,Gp,horizon", [("float32", G, G),
                                                ("bfloat16", 3, 1)])
def test_engine_matches_the_reference_engine(compute, Gp, horizon):
    """The reference's ``ContinuousBatchEngine`` and the port's, on the
    same converted params and prompts, give the same tokens: in fp32 all
    G of them; in bf16 (the serving default) over ``torch_parity``'s
    3-token serve, whose tokens it holds at the first (a later one can
    flip on a bf16 rounding of the two frameworks' sums, within
    ``BF16_REL`` of the logits)."""
    ref, port = _both_engines(compute, Gp)
    for r, t in zip(ref, port):
        assert len(r) == len(t) == Gp
        np.testing.assert_array_equal(np.asarray(r)[:horizon], t[:horizon])


# --------------------------------------------------------------------------- #
# Decode at per-row positions
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,layers", [("gemma3-1b", 6),
                                         ("recurrentgemma-2b", 3)])
def test_decode_at_a_position_vector_equals_the_scalar_path(arch, layers):
    """Rows decoding from a zero cache, each at its own position (a (B,)
    ``pos``), past the local window's wrap: row r equals the scalar path
    at row r's positions, bit for bit, in a batch of the same size (every
    row of it row r, so the kernels see the same shapes); a row alone at
    a (1,) vector equals it alone at the scalar."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as S
    cfg = reduced(get_config(arch), layers=layers)
    pcfg = ParallelConfig(attn_block_kv=8)
    params = S.init_model_params(0, cfg, "cpu", dtype=torch.bfloat16)
    starts, T, B = (0, 3, 7), cfg.window + 6, 3
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T)))
    s_max = max(starts) + T

    def run(rows, pos_of):
        cache = M.zeros_cache(M.model_cache_schema(cfg, len(rows), s_max),
                              "cpu")
        out = []
        with torch.no_grad():
            for t in range(T):
                lg, cache = M.decode_step(params, toks[rows, t:t + 1], cache,
                                          pos_of(rows, t), cfg=cfg, pcfg=pcfg)
                out.append(lg)
        return torch.stack(out)

    def vector(rows, t):
        return torch.tensor([starts[r] + t for r in rows])

    def scalar(rows, t):
        return starts[rows[0]] + t

    batched = run([0, 1, 2], vector)
    for r in range(B):
        assert torch.equal(batched[:, r], run([r] * B, scalar)[:, 0]), r
        assert torch.equal(run([r], vector), run([r], scalar)), r


# --------------------------------------------------------------------------- #
# A recurrent family through the engine
# --------------------------------------------------------------------------- #
def test_recurrentgemma_engine_bulk_and_packed():
    """recurrentgemma-2b (one (R, R, L) period) through a 2-slot engine:
    bulk prefill equals sequential sessions (the recurrent conv and h
    rows spliced whole); packed prefill with slot reuse equals
    packed-solo runs (the row zeroed at admission)."""
    sess = _session("recurrentgemma-2b")
    prompts = [p[:n] for p, n in zip(_prompts(4, P, sess.cfg.vocab_size, 3),
                                     (8, 5, 8, 2))]
    eng = ContinuousBatchEngine(sess, max_slots=2, max_len=P + G)
    outs = eng.run(prompts, max_new=G)
    refs = _sequential_reference(_session("recurrentgemma-2b"), prompts)
    for r, o in zip(refs, outs):
        np.testing.assert_array_equal(r, o)
    packed = ContinuousBatchEngine(sess, max_slots=2, max_len=P + G,
                                   prefill_mode="packed")
    pouts = packed.run(prompts, max_new=G)
    solo = [packed.run([p], max_new=G)[0] for p in prompts]
    for s, o in zip(solo, pouts):
        np.testing.assert_array_equal(s, o)
    # admission zeroes the slot's row of every leaf and no other row
    before = {k: v.clone() for k, v in _leaves(packed._cache)}
    assert any(v[:, 1].abs().sum() > 0 for k, v in before.items()
               if k.startswith("scan")), "no recurrent state to clear"
    packed._reset_slot(1)
    for k, v in _leaves(packed._cache):
        row = v[:, 1] if k.startswith("scan") else v[1]
        kept = v[:, 0] if k.startswith("scan") else v[0]
        was = before[k][:, 0] if k.startswith("scan") else before[k][0]
        assert not row.any() and torch.equal(kept, was), k


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else k)
    else:
        yield path, tree
