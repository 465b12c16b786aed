"""Continuous batching: many concurrent requests through ONE batched decode
call a tick (port of ``repro.launch.batching``, with its interface).

``ServeSession`` (``launch.serve``) serves one fixed batch at a time.
This module is the serving plane above it:

  * ``ContinuousBatchEngine`` -- a fixed-slot batch scheduler over a
    session's model.  Each of ``max_slots`` request slots owns one row
    of a shared KV cache; every scheduler tick decodes all ``max_slots``
    rows (each live row at its OWN sequence position, the dead ones at
    position 0) in one batched decode call, so admitting and finishing
    requests never changes a shape.  With an analog executor, the
    per-site ``DeploymentState``s are served through every call exactly
    as in ``ServeSession``; the engine exposes ``prefill_traces`` /
    ``decode_traces`` (the builds of its step closures) like a session,
    so it plugs into ``RecompileSentinel(session=engine)``.

  * ``KVPagePool`` -- page-granular bookkeeping of the KV budget.
    Admission reserves every page a request can touch (``prompt +
    max_new``); a full pool makes ``try_admit`` stop and requests wait
    in the queue -- the backpressure signal.  The physical cache stays a
    dense row per slot; the pool is the allocator surface the invariant
    tests drive (no page leaked, none double-assigned).

  * ``AsyncBatchServer`` -- an async facade: ``await server.generate()``
    from many tasks; a background thread runs the engine loop and
    resolves futures as requests finish.

Prefill runs in one of two modes:

  * ``"bulk"`` (default): an admitted request prefills its whole prompt
    in one (1, P) call and the resulting cache row is written into its
    slot's row.  A row's arithmetic is that of a batch-1 ``ServeSession``
    wherever the kernels round each row on its own (tests/
    test_torch_batching.py holds batched serving to sequential serving
    on the CPU, token for token).

  * ``"packed"``: prompt tokens are fed one per tick through the SAME
    batched decode call as everyone else's decode steps (mixed prefill
    and decode rows, no prefill call).  A slot's row is zeroed at
    admission (``_reset_slot``): it may hold the previous occupant's
    recurrent state.  Token-level attention equals the prefill's in
    exact arithmetic, not bit for bit, so packed mode is held to
    packed-solo runs.

Sampling is greedy (argmax), as ``ServeSession`` at ``temperature=0``.
A tick reads its argmax to the host (one device sync a tick, as in the
reference); a bulk prefill reads its first token the same way.
"""
from __future__ import annotations

import collections
import itertools
import queue as _queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.obs import OBS

_ENGINE_IDS = itertools.count()

QUEUED, PREFILL, RUNNING, DONE, CANCELLED = (
    "queued", "prefill", "running", "done", "cancelled")


class QueueFull(RuntimeError):
    """Backpressure: the engine's admission queue is at capacity."""


# --------------------------------------------------------------------------- #
# KV page pool
# --------------------------------------------------------------------------- #
class KVPagePool:
    """Page-granular allocator over the per-slot KV budget.

    ``total_pages`` pages of ``page_size`` cache positions each.  A
    request slot reserves ``ceil(max_seq / page_size)`` pages at
    admission and returns them all on finish/cancel -- reserving up
    front (rather than faulting pages in mid-decode) means a decode step
    can never fail on allocation, so backpressure acts only at the
    admission edge.  Invariants (``check()``; property-tested):

      * every page is either free or owned by exactly one slot;
      * ``len(free) + sum(owned) == total_pages`` (nothing leaks);
      * no page id appears twice anywhere.
    """

    def __init__(self, n_slots: int, max_seq: int, page_size: int = 16,
                 total_pages: Optional[int] = None):
        self.page_size = max(1, int(page_size))
        self.pages_per_slot = -(-int(max_seq) // self.page_size)
        self.total_pages = (int(total_pages) if total_pages is not None
                            else n_slots * self.pages_per_slot)
        self.free: set = set(range(self.total_pages))
        self.owned: Dict[int, List[int]] = {}

    def pages_for(self, seq_len: int) -> int:
        return -(-max(0, int(seq_len)) // self.page_size)

    def can_admit(self, seq_len: int) -> bool:
        return len(self.free) >= self.pages_for(seq_len)

    def reserve(self, slot: int, seq_len: int) -> bool:
        """All-or-nothing reservation for a request of ``seq_len``."""
        n = self.pages_for(seq_len)
        if slot in self.owned or len(self.free) < n:
            return False
        pages = [self.free.pop() for _ in range(n)]
        self.owned[slot] = pages
        return True

    def release(self, slot: int) -> List[int]:
        pages = self.owned.pop(slot, [])
        self.free.update(pages)
        return pages

    def in_use(self) -> int:
        return sum(len(p) for p in self.owned.values())

    def check(self) -> None:
        seen: List[int] = sorted(self.free)
        for pages in self.owned.values():
            seen.extend(pages)
        assert len(seen) == len(set(seen)), "page double-assigned"
        assert sorted(seen) == list(range(self.total_pages)), "page leaked"


# --------------------------------------------------------------------------- #
# Requests
# --------------------------------------------------------------------------- #
@dataclass
class Request:
    rid: int
    prompt: np.ndarray                      # (P,) int64
    max_new: int
    status: str = QUEUED
    slot: int = -1
    next_pos: int = 0                       # next cache position to write
    out: List[int] = field(default_factory=list)
    t_submit: float = 0.0
    t_first: Optional[float] = None         # time-to-first-token edge
    t_done: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.status in (DONE, CANCELLED)

    def tokens(self) -> np.ndarray:
        return np.asarray(self.out, np.int32)


def _rows(tree, fn):
    """Apply ``fn(leaf, row_axis)`` to every leaf of an engine cache: the
    stacked periods' leaves are (n_periods, B, ...), the tail's (B, ...)."""
    def walk(node, axis):
        if isinstance(node, dict):
            for v in node.values():
                walk(v, axis)
        else:
            fn(node, axis)
    walk(tree["scan"], 1)
    walk(tree["tail"], 0)


# --------------------------------------------------------------------------- #
# Engine
# --------------------------------------------------------------------------- #
class ContinuousBatchEngine:
    """Fixed-slot continuous-batching scheduler over a ``ServeSession``.

    The session supplies the model (params, step functions, analog
    executor and its per-site states); the engine owns the multi-request
    cache, the slot scheduler and the page pool.  Typical use::

        sess = ServeSession("gemma3-1b", executor=ex, batch=1, ...)
        eng = ContinuousBatchEngine(sess, max_slots=8)
        rids = [eng.submit(p, max_new=16) for p in prompts]
        eng.drain()
        tokens = [eng.result(r) for r in rids]

    ``step()`` is one scheduler tick: admit from the queue while pages
    and slots allow, then run ONE batched decode over all ``max_slots``
    rows.  Every call keeps its shapes as requests come and go, and the
    step closures are built once (``decode_traces`` stays 1).
    """

    def __init__(self, session, *, max_slots: int = 8,
                 max_len: Optional[int] = None, page_size: int = 16,
                 total_pages: Optional[int] = None,
                 prefill_mode: str = "bulk", max_queue: int = 256):
        cfg = session.cfg
        assert cfg.frontend != "vision" and not cfg.encoder_layers, \
            "continuous batching serves token-only decoder models"
        assert prefill_mode in ("bulk", "packed"), prefill_mode
        self.session = session
        self.cfg = cfg
        self.device = session.device
        self.max_slots = int(max_slots)
        self.max_len = int(max_len if max_len is not None
                           else session.P + session.G)
        self.prefill_mode = prefill_mode
        self.max_queue = int(max_queue)
        self.pool = KVPagePool(self.max_slots, self.max_len,
                               page_size=page_size, total_pages=total_pages)
        self.site = f"batch:{cfg.name}#{next(_ENGINE_IDS)}"

        self._rid = itertools.count()
        self.requests: Dict[int, Request] = {}
        self.queue: collections.deque = collections.deque()
        self.slots: List[Optional[int]] = [None] * self.max_slots   # rid
        self.prefill_traces = 0
        self.decode_traces = 0
        self._prefill = None
        self._decode = None
        self._states: Optional[dict] = None
        self._fresh_cache()

    # ------------------------------------------------------------------ #
    # Step closures (built once each, on first use; shapes stable in
    # max_slots)
    # ------------------------------------------------------------------ #
    def _count_build(self, step: str) -> None:
        if OBS.enabled:
            OBS.counter("serve_traces_total",
                        "builds of the serving steps (a healthy sweep holds "
                        "this at 1 per step)", site=self.site,
                        step=step).inc()

    def _decode_fn(self):
        if self._decode is None:
            sess = self.session

            def run_decode(tok, cache, pos, states):
                with torch.no_grad(), sess._bound(states):
                    return sess._decode_step(sess.params, tok, cache, pos)

            self.decode_traces += 1
            self._count_build("batch_decode")
            self._decode = run_decode
        return self._decode

    def _prefill_fn(self):
        if self._prefill is None:
            sess = self.session

            def run_prefill(b, states):
                with torch.no_grad(), sess._bound(states):
                    return sess._prefill_step(sess.params, b)

            self.prefill_traces += 1
            self._count_build("bulk_prefill")
            self._prefill = run_prefill
        return self._prefill

    def _fresh_cache(self):
        from repro_torch.models import model as M
        self._cache = M.zeros_cache(
            M.model_cache_schema(self.cfg, self.max_slots, self.max_len),
            self.device)

    def _splice(self, pcache, slot: int) -> None:
        """Write a (1, ...) prefill cache into row ``slot``, each leaf at
        the origin of the row (``serve._splice``'s prefix rule: a
        prompt's keys fill positions [0, P), a local layer's last
        min(W, P) keys the ring's first slots, a recurrent layer's conv
        and h states the whole row)."""
        def walk(z, c, axis):
            if isinstance(z, dict):
                for k, v in z.items():
                    if k in c:
                        walk(v, c[k], axis)
                return
            zr, cr = z.select(axis, slot), c.select(axis, 0)
            zr[tuple(slice(0, s) for s in cr.shape)] = cr.to(z.dtype)

        walk(self._cache["scan"], pcache["scan"], 1)
        walk(self._cache["tail"], pcache["tail"], 0)

    def _reset_slot(self, slot: int) -> None:
        """Zero a slot's row (packed admission: the row may hold the
        previous occupant's recurrent state)."""
        _rows(self._cache, lambda z, axis: z.select(axis, slot).zero_())

    # ------------------------------------------------------------------ #
    # States (the analog device states, as in ServeSession)
    # ------------------------------------------------------------------ #
    def refresh_states(self, states: Optional[dict] = None) -> None:
        """Re-materialize the per-site ``DeploymentState``s from the
        session's executor (call after ``ex.deploy(...)`` mid-run: the
        swap applies from the next tick), or install ``states`` (e.g.
        from ``load_deployment``), each kept to this rank's window of its
        lattice on the executor's serving mesh (``ex.shard_states``)."""
        if states is not None:
            ex = self.session.ex
            self._states = ex.shard_states(states) if ex is not None else states
        else:
            self._states = (self.session.states()
                            if self.session.ex is not None else {})

    def _st(self) -> dict:
        if self._states is None:
            self.refresh_states()
        return self._states

    # ------------------------------------------------------------------ #
    # Request lifecycle
    # ------------------------------------------------------------------ #
    def submit(self, prompt, max_new: int) -> int:
        """Enqueue a request; returns its rid.  Raises ``QueueFull``
        past ``max_queue`` waiting requests (backpressure)."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size + max_new > self.max_len:
            raise ValueError(f"prompt+max_new {prompt.size + max_new} > "
                             f"max_len {self.max_len}")
        if len(self.queue) >= self.max_queue:
            raise QueueFull(f"admission queue at capacity {self.max_queue}")
        rid = next(self._rid)
        self.requests[rid] = Request(rid=rid, prompt=prompt,
                                     max_new=int(max_new),
                                     t_submit=time.monotonic())
        self.queue.append(rid)
        if OBS.enabled:
            OBS.gauge("serve_queue_depth",
                      "requests waiting for a slot (admission backlog)",
                      site=self.site).set(len(self.queue))
        return rid

    def cancel(self, rid: int) -> None:
        """Drop a request.  Queued: removed; live: its slot and pages
        free immediately (tokens produced so far are kept)."""
        req = self.requests[rid]
        if req.done:
            return
        if req.status == QUEUED:
            self.queue.remove(rid)
        else:
            self.slots[req.slot] = None
            self.pool.release(req.slot)
        req.status = CANCELLED
        req.t_done = time.monotonic()
        self._account_finish(req, outcome="cancelled")

    def result(self, rid: int) -> np.ndarray:
        req = self.requests[rid]
        assert req.done, f"request {rid} still {req.status}"
        return req.tokens()

    def _account_finish(self, req: Request, outcome: str) -> None:
        if not OBS.enabled:
            return
        OBS.counter("serve_requests_total",
                    "requests leaving the engine, by outcome",
                    site=self.site, outcome=outcome).inc()
        OBS.histogram("serve_request_latency_seconds",
                      "submit -> last token, per request",
                      site=self.site, arch=self.cfg.name).observe(
                          (req.t_done or 0.0) - req.t_submit)
        if req.t_first is not None:
            OBS.histogram("serve_request_ttft_seconds",
                          "submit -> first generated token, per request",
                          site=self.site, arch=self.cfg.name).observe(
                              req.t_first - req.t_submit)
        OBS.gauge("serve_kv_pages_in_use",
                  "KV pages currently reserved by live request slots",
                  site=self.site).set(self.pool.in_use())

    # ------------------------------------------------------------------ #
    # Scheduler tick
    # ------------------------------------------------------------------ #
    def _free_slot(self) -> int:
        for i, rid in enumerate(self.slots):
            if rid is None:
                return i
        return -1

    def try_admit(self) -> int:
        """Admit queued requests while a slot AND pages are available.
        Returns the number admitted this tick."""
        n = 0
        while self.queue:
            slot = self._free_slot()
            if slot < 0:
                break
            req = self.requests[self.queue[0]]
            need = req.prompt.size + req.max_new
            if not self.pool.reserve(slot, need):
                break                      # backpressure: pool exhausted
            self.queue.popleft()
            self.slots[slot] = req.rid
            req.slot, req.next_pos = slot, 0
            if self.prefill_mode == "bulk":
                self._bulk_prefill(req)
            else:
                self._reset_slot(slot)
                req.status = PREFILL
            n += 1
        if OBS.enabled and n:
            OBS.gauge("serve_queue_depth",
                      "requests waiting for a slot (admission backlog)",
                      site=self.site).set(len(self.queue))
        return n

    def _bulk_prefill(self, req: Request) -> None:
        P = req.prompt.size
        tokens = torch.from_numpy(req.prompt[None, :]).to(self.device)
        logits, pcache = self._prefill_fn()({"tokens": tokens}, self._st())
        self._splice(pcache, req.slot)
        del pcache
        req.out.append(int(torch.argmax(logits[0])))     # host sync
        req.next_pos = P
        req.t_first = time.monotonic()
        req.status = RUNNING
        if OBS.enabled:
            OBS.counter("serve_engine_tokens_total",
                        "tokens through the engine (prompt + generated)",
                        site=self.site, kind="prefill").inc(P)
        if len(req.out) >= req.max_new:
            self._finish(req)

    def _finish(self, req: Request) -> None:
        self.slots[req.slot] = None
        self.pool.release(req.slot)
        req.status = DONE
        req.t_done = time.monotonic()
        self._account_finish(req, outcome="done")

    def step(self) -> List[Request]:
        """One scheduler tick: admit, then one batched decode over all
        slots.  Returns the requests that finished this tick."""
        self.try_admit()
        live = [(i, self.requests[rid]) for i, rid in enumerate(self.slots)
                if rid is not None]
        if not live:
            return []
        tok = np.zeros((self.max_slots, 1), np.int64)
        pos = np.zeros((self.max_slots,), np.int64)
        for i, req in live:
            if req.status == PREFILL:
                tok[i, 0] = req.prompt[req.next_pos]
            else:
                tok[i, 0] = req.out[-1]
            pos[i] = req.next_pos
        if OBS.enabled:
            OBS.gauge("serve_slots_active",
                      "live request slots this tick", site=self.site) \
                .set(len(live))
            OBS.histogram("serve_batch_occupancy",
                          "live slots per batched decode tick "
                          "(out of max_slots)", site=self.site,
                          slots=str(self.max_slots)).observe(len(live))
        dev = self.device
        logits, self._cache = self._decode_fn()(
            torch.from_numpy(tok).to(dev), self._cache,
            torch.from_numpy(pos).to(dev), self._st())
        largs = torch.argmax(logits, dim=-1).cpu().numpy()  # the tick's sync

        finished: List[Request] = []
        n_dec = 0
        for i, req in live:
            req.next_pos += 1
            if req.status == PREFILL:
                if req.next_pos >= req.prompt.size:   # prompt consumed:
                    req.out.append(int(largs[i]))     # first generated tok
                    req.t_first = time.monotonic()
                    req.status = RUNNING
                    n_dec += 1
            else:
                req.out.append(int(largs[i]))
                n_dec += 1
            if req.status == RUNNING and len(req.out) >= req.max_new:
                self._finish(req)
                finished.append(req)
        if OBS.enabled and n_dec:
            OBS.counter("serve_engine_tokens_total",
                        "tokens through the engine (prompt + generated)",
                        site=self.site, kind="decode").inc(n_dec)
        return finished

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def drain(self) -> None:
        while self.busy:
            self.step()

    def run(self, prompts: Sequence, max_new: int) -> List[np.ndarray]:
        """Convenience: submit all, drain, collect in submit order."""
        rids = [self.submit(p, max_new) for p in prompts]
        self.drain()
        return [self.result(r) for r in rids]


# --------------------------------------------------------------------------- #
# Async facade
# --------------------------------------------------------------------------- #
class AsyncBatchServer:
    """Async request front-end over a ``ContinuousBatchEngine``.

    A single background thread owns the engine (one thread launches on
    the card); callers hand prompts over a bounded thread-safe queue and
    get back futures::

        server = AsyncBatchServer(engine)
        server.start()
        toks = await server.generate(prompt, max_new=16)   # asyncio
        toks = server.submit(prompt, 16).result()          # threads
        server.stop()

    A full intake queue raises ``QueueFull`` -- backpressure propagates
    to the caller rather than growing unbounded buffers.  The loop
    thread enters ``torch.no_grad()`` itself (grad mode is per thread),
    and the engine binds the session's dense hook and states around each
    call, in the thread that makes it.  An exception in the loop fails
    every pending future and ``stop()`` re-raises it.
    """

    def __init__(self, engine: ContinuousBatchEngine,
                 intake: Optional[int] = None, idle_sleep: float = 0.002):
        import concurrent.futures as _f
        self._futures = _f
        self.engine = engine
        self._intake: _queue.Queue = _queue.Queue(
            maxsize=intake if intake is not None else engine.max_queue)
        self._pending: Dict[int, object] = {}       # rid -> Future
        self._idle_sleep = idle_sleep
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def start(self) -> "AsyncBatchServer":
        assert self._thread is None, "already started"
        self._stop.clear()
        self._error = None
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-batch-loop", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            raise self._error

    def __enter__(self) -> "AsyncBatchServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def submit(self, prompt, max_new: int):
        """Thread-safe submit; returns a ``concurrent.futures.Future``
        resolving to the request's generated tokens (np.int32)."""
        fut = self._futures.Future()
        try:
            self._intake.put_nowait((np.asarray(prompt, np.int64), max_new,
                                     fut))
        except _queue.Full:
            raise QueueFull("server intake queue full") from None
        return fut

    async def generate(self, prompt, max_new: int):
        import asyncio
        return await asyncio.wrap_future(self.submit(prompt, max_new))

    def _loop(self) -> None:
        eng = self.engine
        try:
            with torch.no_grad():
                while not self._stop.is_set():
                    moved = False
                    while True:                    # intake -> engine queue
                        try:
                            prompt, max_new, fut = self._intake.get_nowait()
                        except _queue.Empty:
                            break
                        try:
                            rid = eng.submit(prompt, max_new)
                            self._pending[rid] = fut
                            moved = True
                        except Exception as e:     # backpressure / bad request
                            fut.set_exception(e)
                    if eng.busy:
                        for req in eng.step():
                            fut = self._pending.pop(req.rid, None)
                            if fut is not None:
                                fut.set_result(req.tokens())
                    elif not moved:
                        time.sleep(self._idle_sleep)
        except Exception as e:            # a failed tick fails the waiters
            self._error = e
            for fut in self._pending.values():
                fut.set_exception(e)
            self._pending.clear()
            return
        # resolve what we can on shutdown; cancel the rest
        for rid, fut in list(self._pending.items()):
            req = eng.requests.get(rid)
            if req is not None and req.done:
                fut.set_result(req.tokens())
            else:
                fut.cancel()
        self._pending.clear()
