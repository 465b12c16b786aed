"""One run of one cell: set-up, the measured window, the check of what
the window produced.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); its correctness limits and how many of the
window's calls the check compares are in ``limits/<cell>.json``.  The
system under test is ``repro_torch``'s serving plane: a
``ContinuousBatchEngine`` over a batch-1 ``ServeSession`` whose analog
projections run on an ``AnalogExecutor``.  What the configuration file
sets, each with its default: ``backend`` (``"emulator"``, the fp32 fast
path, the B1 kernel; ``"digital"`` serves without the executor),
``corner`` (none, the ideal corner; else ``{"scenario", "remap",
"age"}``, deployed from the seed), ``autotune`` (false: B1 keeps its
default row tile) and ``reference`` (the module of
``perfbench/reference/`` that checks it, and that refuses what it does
not model).

Set-up (counted in ``setup_s``) builds or loads the kernels, makes the
weights from the seed, builds the executor's plans and states and warms
the shapes the traffic uses (a prefill at the shortest and the longest
prompt, decode ticks).  The window then offers the traffic for
``seconds`` and records, on the host's monotonic clock, every request's
due time, send time and token times, and every engine call.  A seeded
sample of the window's calls is kept for the check: bulk prefills (the
engine's logits, the first token served, the cache rows the prefill
wrote) and decode ticks (the cache before the tick, the tick's inputs,
its logits, the tokens served, the cache entries the tick wrote).
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import devtrace, loadgen

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent


# --------------------------------------------------------------------------- #
# The cell's files
# --------------------------------------------------------------------------- #
@dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    limits: Dict
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and its files, each
    found by the name the manifest gives."""
    man = _json(root / "BENCHMARK.json")
    w = {c["name"]: c for c in man["workloads"]}.get(name)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have "
                         f"{sorted(c['name'] for c in man['workloads'])})")
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    moved = {m["name"] for m in e2e}
    per = [m for m in man["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in moved)]
    return Cell(name=name, config=_json(root / conf["file"]),
                traffic=_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                limits=_json(BENCH / "limits" / f"{name}.json"),
                chips=int(w["chips"]), end_to_end=e2e, per_layer=per)


# --------------------------------------------------------------------------- #
# The configuration as the port runs it, and as the reference reads it
# --------------------------------------------------------------------------- #
# keys of a configuration file (the published config's names) -> the
# port's ArchConfig fields; every one is checked against the port's
WIDTHS = {"hidden_size": "d_model", "intermediate_size": "d_ff",
          "num_attention_heads": "num_heads",
          "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
          "vocab_size": "vocab_size", "num_hidden_layers": "num_layers",
          "rope_theta": "rope_base", "tie_word_embeddings": "tie_embeddings"}


def port_config(conf: Dict, reduced: bool = False):
    """(the port's ArchConfig, the reference's plain dict of sizes) of a
    configuration file; ``reduced`` takes the port's tiny same-family
    config at the file's depth (CPU tests)."""
    from repro_torch.configs import get_config, reduced as tiny, with_depth
    base = get_config(conf["arch"])
    n = int(conf["num_hidden_layers"])
    cfg = tiny(base, layers=n) if reduced else with_depth(base, n)
    if not reduced:
        bad = {k: (conf[k], getattr(cfg, f)) for k, f in WIDTHS.items()
               if k in conf and conf[k] != getattr(cfg, f)}
        moe = conf.get("num_local_experts")
        if moe is not None and (cfg.moe is None or (
                moe, conf["num_experts_per_tok"]) != (cfg.moe.num_experts,
                                                      cfg.moe.top_k)):
            bad["experts"] = (moe, cfg.moe)
        if bad:
            raise SystemExit(f"{conf['name']}: the port's config differs "
                             f"from the file: {bad}")
    return cfg, reference(conf).plain_config(cfg, conf)


def reference(conf: Dict):
    """The module of ``perfbench/reference/`` that the configuration names."""
    return importlib.import_module(f"perfbench.reference.{conf['reference']}")


def program_env(conf: Dict) -> None:
    """The environment the program reads for this configuration: the B1
    tuner on or off (``autotune``), and its file inside the checkout."""
    os.environ["REPRO_AUTOTUNE"] = "1" if conf.get("autotune") else "0"
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(BENCH / ".state"
                                             / "autotune.json")


# --------------------------------------------------------------------------- #
# The system under test
# --------------------------------------------------------------------------- #
class Program:
    """``repro_torch``'s engine for one cell, built from the seed."""

    def __init__(self, cell: Cell, seed: int, device: torch.device,
                 reduced: bool = False):
        from perfbench import weights
        from repro_torch.configs.base import AnalogConfig
        from repro_torch.configs.rram_ps32 import CASE_A
        from repro_torch.core.analog import AnalogExecutor
        from repro_torch.core.circuit import CircuitParams
        from repro_torch.launch.batching import ContinuousBatchEngine
        from repro_torch.launch.serve import ServeSession
        conf, tr = cell.config, cell.traffic
        self.cfg, self.ref_cfg = port_config(conf, reduced)
        xb = conf["crossbar"]
        self.params = weights.model_weights(self.cfg, seed, device)
        self.eparams = weights.emulator_weights(seed, device)
        backend = conf.get("backend", "emulator")
        self.ex = None if backend == "digital" else AnalogExecutor(
            acfg=AnalogConfig(enabled=True, backend=backend,
                              layers=tuple(conf["analog_layers"]),
                              rows=xb["rows"], g_min=xb["g_min"],
                              g_max=xb["g_max"], v_read=xb["v_read"],
                              wl_overdrive=xb["wl_overdrive"]),
            geom=CASE_A, cp=CircuitParams(v_th=xb["v_th"]),
            emulator_params=self.eparams if backend == "emulator" else None)
        corner = conf.get("corner")
        if corner:
            self.ex.deploy(scenario=corner["scenario"], age=corner.get("age"),
                           remap=corner.get("remap", False),
                           key=loadgen.derive(seed, "corner"))
        self.p_lo, self.p_hi = tr["prompt"]["min"], tr["prompt"]["max"]
        g_hi = tr["output"]["max"]
        self.sess = ServeSession(
            conf["arch"], reduced=reduced,
            reduced_layers=int(conf["num_hidden_layers"]), batch=1,
            prompt_len=self.p_hi, gen=g_hi, seed=0, executor=self.ex,
            device=device, params=self.params,
            prompt=torch.zeros((1, self.p_hi), dtype=torch.int64))
        assert self.sess.cfg == self.cfg
        self.engine = ContinuousBatchEngine(
            self.sess, max_slots=tr["engine"]["max_slots"],
            max_len=self.p_hi + g_hi,
            prefill_mode=tr["engine"]["prefill_mode"])
        self.sites = [tuple(w.shape) for w in self.sess.sites().values()]
        self.kv_layers = reference(conf).kv_layers
        self.device = device

    def warm(self) -> None:
        """Plans and states of every site, both prefill lengths' shapes,
        decode ticks; the step closures built."""
        eng = self.engine
        for n in (self.p_hi, self.p_lo):
            eng.submit(np.zeros(n, np.int64), max_new=3)
        eng.drain()
        eng._prefill_fn()
        eng._decode_fn()
        sync(self.device)

    def free(self) -> None:
        for k in ("engine", "sess", "ex"):
            setattr(self, k, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --------------------------------------------------------------------------- #
# The window's records
# --------------------------------------------------------------------------- #
@dataclass
class ReqRec:
    index: int
    prompt_len: int
    max_new: int
    due: float                          # absolute (monotonic) due time
    sent: float = math.nan
    rid: int = -1
    times: List[float] = field(default_factory=list)   # each token's time
    done: bool = False


@dataclass
class Record:
    """What a run measured, for the metric readers (``perfbench/metrics``)."""
    cell: str
    cfg: Dict                           # the reference's plain sizes
    sites: List                         # (K, N) of every analog call site
    max_slots: int
    setup_s: float
    start: float                        # the window, monotonic seconds
    end: float
    requests: List[ReqRec]
    ticks: List[tuple] = field(default_factory=list)    # (t0, t1, positions)
    prefills: List[tuple] = field(default_factory=list)  # (t0, t1, P)
    steps: List[tuple] = field(default_factory=list)     # (t0, t1)
    queue: List[tuple] = field(default_factory=list)     # (t, waiting)
    trace: Optional[Dict] = None        # the device trace's summary

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def due_in_window(self) -> List[ReqRec]:
        return [r for r in self.requests if self.start <= r.due < self.end]


@dataclass
class Captures:
    prefills: List[Dict] = field(default_factory=list)
    ticks: List[Dict] = field(default_factory=list)


class Window:
    """Drives the engine for one window and keeps the sample the check
    compares.  ``prefill_pick``: the request indices whose bulk prefill
    is kept; ``tick_times``: seconds into the window after which the
    next tick is kept."""

    def __init__(self, prog: Program, reqs, prefill_pick, tick_times):
        self.prog, self.reqs = prog, reqs
        self.eng = prog.engine
        self.clients: Dict[int, List] = {}        # closed loop: each queue
        for r in reqs:
            if r.client >= 0:
                self.clients.setdefault(r.client, []).append(r)
        self.lead: Dict[int, ReqRec] = {}         # sent before the window
        self.prefill_pick = set(prefill_pick)
        self.tick_times = sorted(tick_times)
        self.caps = Captures()
        self.prompts = {r.index: r.prompt for r in reqs}
        self.by_rid: Dict[int, ReqRec] = {}
        self.rec: Optional[Record] = None
        self._cur = None
        self._install()

    # -- the engine's calls, wrapped (host reads and device copies only) --
    def _install(self):
        eng, ex = self.eng, self.prog.ex
        bulk, pre, dec = eng._bulk_prefill, eng._prefill_fn(), eng._decode_fn()
        mm = ex.matmul if ex is not None else None
        kv = self.prog.kv_layers
        w = self
        w._sites = None

        def matmul(x, weight, tag="", state=None):
            y = mm(x, weight, tag, state=state)
            if w._sites is not None:
                w._sites.append((tag, x.clone(), weight, y.clone()))
            return y

        def bulk_prefill(req):
            w._cur = req
            t0 = time.monotonic()
            bulk(req)
            t1 = time.monotonic()
            w._cur = None
            w.rec.prefills.append((t0, t1, int(req.prompt.size)))
            rr = w.by_rid.get(req.rid)
            if rr is not None and rr.index in w.prefill_pick \
                    and w._pending is not None:
                cap, w._pending = w._pending, None
                P = int(req.prompt.size)
                k, v = kv(eng._cache)
                cap.update(index=rr.index, first=int(req.out[0]),
                           want=torch.from_numpy(
                               w.prompts[rr.index][None]).to(
                                   cap["tokens"].device),
                           k=k[:, req.slot, :P].clone(),
                           v=v[:, req.slot, :P].clone())
                w.caps.prefills.append(cap)

        def prefill(b, states):
            rr = w.by_rid.get(w._cur.rid) if w._cur is not None else None
            keep = rr is not None and rr.index in w.prefill_pick
            w._sites = [] if keep else None
            logits, pcache = pre(b, states)
            if keep:
                w._pending = {"logits": logits.clone(),
                              "tokens": b["tokens"].clone(),
                              "sites": w._sites}
            w._sites = None
            return logits, pcache

        def decode(tok, cache, pos, states):
            t0 = time.monotonic()
            live = [(i, eng.requests[rid]) for i, rid in enumerate(eng.slots)
                    if rid is not None]
            keep = (w._ti < len(w.tick_times)
                    and t0 >= w.rec.start + w.tick_times[w._ti])
            if keep:
                w._ti += 1
                k, v = kv(cache)
                cap = {"k0": k.clone(), "v0": v.clone(),
                       "tok": tok.clone(), "pos": pos.clone(),
                       "rows": [i for i, _ in live],
                       "want_tok": [int(r.out[-1]) for _, r in live],
                       "want_pos": [int(r.prompt.size + len(r.out) - 1)
                                    for _, r in live],
                       "served": [(r.rid, len(r.out)) for _, r in live]}
            w._sites = [] if keep else None
            logits, cache = dec(tok, cache, pos, states)
            if keep:
                cap["sites"], w._sites = w._sites, None
                rows = torch.arange(tok.shape[0], device=tok.device)
                k, v = kv(cache)
                cap.update(logits=logits.clone(),
                           k1=k[:, rows, pos].clone(),
                           v1=v[:, rows, pos].clone())
                w.caps.ticks.append(cap)
            w.rec.ticks.append((t0, None, [int(r.next_pos) for _, r in live]))
            return logits, cache

        self._orig = (bulk, pre, dec, mm)
        eng._bulk_prefill = bulk_prefill
        eng._prefill = prefill
        eng._decode = decode
        if ex is not None:
            ex.matmul = matmul
        self._pending = None
        self._ti = 0

    def uninstall(self) -> None:
        """The engine's own calls back in place."""
        eng = self.eng
        _, eng._prefill, eng._decode, _ = self._orig
        del eng._bulk_prefill               # the class's methods again
        if self.prog.ex is not None:
            del self.prog.ex.matmul

    # -- the loop --
    def _send(self, r, now):
        rr = ReqRec(r.index, int(r.prompt.size), r.max_new,
                    due=now if r.due is None else self.rec.start + r.due)
        rr.sent = time.monotonic()
        rr.rid = self.eng.submit(r.prompt, r.max_new)
        self.by_rid[rr.rid] = rr
        self.rec.requests.append(rr)
        return rr

    def _step(self, active: List[ReqRec]):
        t0 = time.monotonic()
        self.eng.step()
        t1 = time.monotonic()
        self.rec.steps.append((t0, t1))
        self.rec.queue.append((t1, len(self.eng.queue)))
        if self.rec.ticks and self.rec.ticks[-1][1] is None:
            t, _, p = self.rec.ticks[-1]
            self.rec.ticks[-1] = (t, t1, p)
        for rr in active:
            req = self.eng.requests[rr.rid]
            n = len(req.out)
            if n > len(rr.times):
                if not rr.times and req.t_first is not None:
                    rr.times.append(req.t_first)
                rr.times.extend([t1] * (n - len(rr.times)))
            rr.done = req.done

    def lead_in(self, rec: Record, traffic: Dict) -> None:
        """A closed loop's steady start (``steady_start`` in the mix), part
        of set-up: each client's first request sent, and the engine
        stepped until every one of them is admitted and prefilled.  What
        the engine did meanwhile is not the window's."""
        if not traffic.get("steady_start"):
            return
        self.rec, rec.start = rec, math.inf     # no tick is kept before it
        for c, q in self.clients.items():
            self.lead[c] = self._send(q.pop(0), time.monotonic())
        while self.eng.queue:
            self._step(list(self.lead.values()))
        for spans in (rec.ticks, rec.prefills, rec.steps, rec.queue):
            spans.clear()

    def run(self, rec: Record, seconds: float, traffic: Dict,
            profiler=None) -> Record:
        self.rec = rec
        reqs = self.reqs
        closed = traffic["kind"] == "closed"
        queues = self.clients
        busy = {c: r for c, r in self.lead.items() if not r.done}
        nxt, active = 0, list(busy.values())
        rec.start = time.monotonic()
        end = rec.start + seconds
        self.mark_ns = 0
        if profiler is not None:
            profiler.start()
            self.mark_ns = devtrace.mark(self.prog.device)
            rec.start = time.monotonic()
            end = rec.start + seconds
        while True:
            now = time.monotonic()
            if now >= end:
                break
            if closed:
                for c, q in queues.items():
                    if c not in busy and q:
                        busy[c] = self._send(q.pop(0), now)
                        active.append(busy[c])
            else:
                while nxt < len(reqs) and rec.start + reqs[nxt].due <= now:
                    active.append(self._send(reqs[nxt], now))
                    nxt += 1
            if self.eng.busy:
                self._step(active)
                active = [r for r in active if not r.done]
                if closed:
                    busy = {c: r for c, r in busy.items() if not r.done}
            else:
                wake = (rec.start + reqs[nxt].due if nxt < len(reqs) else end)
                time.sleep(max(0.0, min(wake, end) - time.monotonic()))
        rec.end = time.monotonic()
        drain = traffic.get("drain_first_tokens")
        while not closed and nxt < len(reqs) \
                and rec.start + reqs[nxt].due < rec.end:
            r = reqs[nxt]                   # due in the window, not sent yet
            if drain:
                active.append(self._send(r, rec.end))
            else:
                rec.requests.append(ReqRec(r.index, int(r.prompt.size),
                                           r.max_new, rec.start + r.due))
            nxt += 1
        if profiler is not None:
            sync(self.prog.device)
            profiler.stop()
        if drain:
            # every request due in the window gets its first token, however
            # late (a minute at most): its latency counts the wait
            due = [r for r in rec.requests if r.due < rec.end]
            stop = time.monotonic() + 60.0
            while any(not r.times for r in due) and self.eng.busy \
                    and time.monotonic() < stop:
                self._step(active)
                active = [r for r in active if not r.done]
        for cap in self.caps.ticks:            # the tokens each tick served
            cap["served"] = [self._served(rid, j) for rid, j in cap["served"]]
        return rec

    def _served(self, rid, j):
        out = self.eng.requests[rid].out
        return int(out[j]) if j < len(out) else -1


def host_spans(rec: Record):
    """What the host was doing, innermost first: the engine's bulk
    prefills and decode ticks, the rest of its steps, and between steps
    the load generator (sending, or waiting for arrivals)."""
    out = [("prefill", a, b) for a, b, _ in rec.prefills]
    out += [("decode", a, b) for a, b, _ in rec.ticks if b is not None]
    out += [("step", a, b) for a, b in rec.steps]
    out.append(("loadgen", rec.start, rec.end))
    return out


def pick_sample(cell: Cell, reqs, seed: int, seconds: float):
    """(prefill request indices, tick times) of the check's sample, from
    the seed: the request with the longest prompt among those due in the
    first 90% of the window (closed loop: each client's first request
    sent in the window, its second after a steady start) and others
    drawn at random; tick times drawn over the window."""
    n_pre, n_tick = int(cell.limits["prefills"]), int(cell.limits["ticks"])
    rng = np.random.default_rng(loadgen.derive(seed, "sample"))
    if cell.traffic["kind"] == "open":
        cand = [r for r in reqs if r.due < 0.9 * seconds]
    else:
        n = int(cell.traffic["clients"])
        lo = n if cell.traffic.get("steady_start") else 0
        cand = [r for r in reqs if lo <= r.index < lo + n]
    longest = max(cand, key=lambda r: (r.prompt.size, -r.index))
    rest = [r.index for r in cand if r.index != longest.index]
    picks = [longest.index] + list(rng.choice(
        rest, size=min(len(rest), n_pre - 1), replace=False))
    times = rng.uniform(0.05 * seconds, 0.95 * seconds, size=n_tick)
    return picks, sorted(float(t) for t in times)


# --------------------------------------------------------------------------- #
# The check: the reference over the kept calls, stage by stage
# --------------------------------------------------------------------------- #
def _rms_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """RMS of a - b over the RMS of b."""
    a, b = a.float(), b.float()
    return float(torch.sqrt(torch.mean((a - b) ** 2))
                 / torch.sqrt(torch.mean(b * b)).clamp_min(1e-30))


def _row_numbers(lp: torch.Tensor, lr: torch.Tensor, served: int, V: int):
    """(logit error, gap) of one row over the reference row's standard
    deviation: the RMS of program - reference over the vocabulary, and
    the reference's best logit less that of the served token."""
    lp, lr = lp[:V].float(), lr[:V].float()
    sd = float(lr.std().clamp_min(1e-30))
    err = float(torch.sqrt(torch.mean((lp - lr) ** 2))) / sd
    gap = (float(lr.max() - lr[served]) / sd if 0 <= served < V
           else math.inf)
    return err, gap


class Replay:
    """The analog projections of one kept engine call as the program
    computed them, handed to the reference's digital model in the
    program's order; each site's input the reference computed is held
    against the program's (``act_err``)."""

    def __init__(self, sites):
        self.sites, self.i, self.act_err, self.xs = sites, 0, 0.0, []

    def matmul(self, x, w, key):
        layer, tag = key
        name, xp, wp, yp = self.sites[self.i]
        self.i += 1
        if (wp is not w and (wp.data_ptr(), wp.shape) != (w.data_ptr(),
                                                         w.shape)) \
                or f".{layer}:{tag}#" not in name:
            raise AssertionError(f"site {self.i - 1}: the program ran {name}"
                                 f" where the reference runs layer {layer} "
                                 f"{tag}")
        self.act_err = max(self.act_err, _rms_rel(xp, x))
        self.xs.append(x)
        return yp

    def done(self) -> None:
        if self.i != len(self.sites):
            raise AssertionError(f"the program ran {len(self.sites)} analog "
                                 f"calls, the reference {self.i}")


NUMBERS = ("site_err", "act_err", "logit_err", "kv_err", "gap", "sched_err")


@torch.no_grad()
def check(caps: Captures, params: Dict, eparams: Dict, ref_cfg: Dict,
          crossbar: Dict, control: bool = False, site_rows: int = 0,
          seed: int = 0, reference: str = "decoder") -> Dict[str, float]:
    """The numbers compared, each the worst over the kept calls:

    * ``site_err``: every analog projection's output (B1) against the
      reference's emulator on the program's own input rows (RMS of the
      difference over the reference's RMS), on ``site_rows`` rows of each
      call (every row for 0; the drive scale is the whole call's either
      way), spread evenly over the call's rows from an offset drawn from
      ``seed`` that moves on by one row a call, so that successive calls
      of one shape cover every row;
    * ``act_err``: every analog projection's input as the program fed it
      against the reference's digital model (norms, attention, MoE,
      residuals) run on the program's analog outputs, the same unit;
    * ``logit_err``: each compared row's logits against that model's,
      RMS over the vocabulary over the reference row's standard
      deviation; ``gap``: how far below the reference's best logit the
      served token's lies, the same unit;
    * ``kv_err``: the cache entries the call wrote, the RMS unit;
    * ``sched_err``: inputs of a call other than the request's own
      prompt, tokens and positions (a count).

    A tick is followed from the program's cache before it: a row's output
    depends on its batch-mates (the drive scale is the whole call's, an
    expert's capacity is shared), and the program's last-bit roundings
    move that scale and the routing, so a reference run on its own
    history agrees only on most rows.  ``control``: the reference at the
    precision below the configuration's stands in the program's place
    (TF32 operands in the emulator's products, fp8 in the digital
    model's).  ``reference`` names the configuration's model, a module
    of ``perfbench/reference/``."""
    from perfbench.reference.emulator import AnalogRef
    Decoder = importlib.import_module(
        f"perfbench.reference.{reference}").Decoder
    ana = AnalogRef(eparams, crossbar)
    low_ana = AnalogRef(eparams, crossbar, tf32=True) if control else None
    V = ref_cfg["vocab_size"]
    out = dict.fromkeys(NUMBERS, 0.0)
    out.update(sched_err=0, prefills=len(caps.prefills),
               ticks=len(caps.ticks), rows=0, sites=0)

    def worst(k, v):
        out[k] = max(out[k], v)

    offset = [int(np.random.default_rng(
        loadgen.derive(seed, "site rows")).integers(1 << 30))]

    def sites(cap):
        for name, x, w, y in cap["sites"]:
            x2, y2 = x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1])
            n = x2.shape[0]
            rows = None
            if site_rows and site_rows < n:
                rows = torch.sort((offset[0] + (n // site_rows) * torch.arange(
                    site_rows, device=x.device)) % n).values
                offset[0] += 1
            yr = ana.matmul(x2, w, key=name, rows=rows)
            got = (y2 if rows is None else y2[rows]) if low_ana is None \
                else low_ana.matmul(x2, w, key=name, rows=rows)
            worst("site_err", _rms_rel(got, yr))
            out["sites"] += 1

    def digital(cap, run):
        """(reference, program or control) outputs of ``run(decoder)``
        on the program's analog outputs."""
        rp = Replay(cap["sites"])
        r = run(Decoder(ref_cfg, params, rp))
        rp.done()
        if not control:
            worst("act_err", rp.act_err)
            return r, None
        lp = Replay(cap["sites"])
        low = run(Decoder(ref_cfg, params, lp, low=True))
        for a, b in zip(lp.xs, rp.xs):
            worst("act_err", _rms_rel(a, b))
        return r, low

    for cap in caps.prefills:
        out["sched_err"] += int(not torch.equal(cap["tokens"], cap["want"]))
        sites(cap)
        (lr, kvr), low = digital(cap, lambda d: d.prefill(cap["want"]))
        kr = torch.stack([k[0] for k, _ in kvr])
        vr = torch.stack([v[0] for _, v in kvr])
        if low is None:
            lp, kp, vp, served = (cap["logits"][0], cap["k"], cap["v"],
                                  cap["first"])
        else:
            lp = low[0][0]
            kp = torch.stack([k[0] for k, _ in low[1]])
            vp = torch.stack([v[0] for _, v in low[1]])
            served = int(lp[:V].argmax())
        err, gap = _row_numbers(lp, lr[0], served, V)
        worst("logit_err", err)
        worst("gap", gap)
        worst("kv_err", max(_rms_rel(kp, kr), _rms_rel(vp, vr)))
        out["rows"] += 1
    for cap in caps.ticks:
        rows = cap["rows"]
        got_tok = cap["tok"][rows, 0].tolist()
        got_pos = cap["pos"][rows].tolist()
        out["sched_err"] += sum(a != b for a, b in zip(got_tok,
                                                       cap["want_tok"]))
        out["sched_err"] += sum(a != b for a, b in zip(got_pos,
                                                       cap["want_pos"]))
        sites(cap)

        def step(dec):
            n = cap["k0"].shape[0]
            kc, vc = cap["k0"].clone(), cap["v0"].clone()
            lg = dec.decode(cap["tok"], [(kc[i], vc[i]) for i in range(n)],
                            cap["pos"])
            r = torch.arange(kc.shape[1], device=kc.device)
            return lg, kc[:, r, cap["pos"]], vc[:, r, cap["pos"]]

        (lr, kr, vr), low = digital(cap, step)
        if low is None:
            lp, kp, vp = cap["logits"], cap["k1"], cap["v1"]
            served = cap["served"]
        else:
            lp, kp, vp = low
            served = [int(lp[i, :V].argmax()) for i in rows]
        for j, i in enumerate(rows):
            err, gap = _row_numbers(lp[i], lr[i], served[j], V)
            worst("logit_err", err)
            worst("gap", gap)
            worst("kv_err", max(_rms_rel(kp[:, i], kr[:, i]),
                                _rms_rel(vp[:, i], vr[:, i])))
            out["rows"] += 1
    return out


def verdict(numbers: Dict, limits: Dict):
    """(correct, each number compared beside its limit)."""
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in limits.items()}
    ok = numbers["rows"] > 0 and all(
        numbers[k] <= lim for k, lim in limits.items())
    return ok, checks


@contextlib.contextmanager
def no_tf32():
    """The configurations' float32 is float32: TF32 off for matmuls and
    convolutions while the reference runs."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


# --------------------------------------------------------------------------- #
# One run
# --------------------------------------------------------------------------- #
def metric_reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, else the file
    of its stem (the part before the first dot), so that one quantity's
    variants (``mfu.chat``, ``mfu.tput``) share it."""
    for stem in (name, name.split(".")[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(
                f"perfbench.metrics.{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise SystemExit(f"no reader for metric {name!r} under "
                     f"{BENCH / 'metrics'}")


def run_once(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, reduced: bool = False,
             t_start: Optional[float] = None, underneath=None):
    """Set-up, the window, the check: (the result line's object, a note
    for standard error).  ``underneath(prog)``, when given, is called
    before the window (tests break the program there)."""
    t_start = time.monotonic() if t_start is None else t_start
    prog = Program(cell, seed, device, reduced)
    prog.warm()
    reqs = loadgen.make_requests(cell.traffic, seed, seconds,
                                 prog.ref_cfg["vocab_size"])
    picks, times = pick_sample(cell, reqs, seed, seconds)
    if underneath is not None:
        underneath(prog)
    win = Window(prog, reqs, picks, times)
    rec = Record(cell=cell.name, cfg=prog.ref_cfg, sites=prog.sites,
                 max_slots=prog.engine.max_slots, setup_s=0.0, start=0.0,
                 end=0.0, requests=[])
    with torch.no_grad():
        win.lead_in(rec, cell.traffic)
    prof = devtrace.profiler() if trace else None
    sync(device)
    rec.setup_s = time.monotonic() - t_start
    with torch.no_grad():
        win.run(rec, seconds, cell.traffic, profiler=prof)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if prof is not None:
        rec.trace = devtrace.summarize(prof, rec.seconds, win.mark_ns,
                                       host_spans(rec))
        del prof

    # the check, once the program's state is freed
    caps, params, eparams = win.caps, prog.params, prog.eparams
    del win
    prog.free()
    t_ref = time.monotonic()
    with no_tf32():
        nums = check(caps, params, eparams, prog.ref_cfg,
                     cell.config["crossbar"],
                     site_rows=int(cell.limits.get("site_rows", 0)), seed=seed,
                     reference=cell.config["reference"])
    t_ref = time.monotonic() - t_ref
    correct, checks = verdict(nums, cell.limits["limits"])

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = metric_reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    due = (rec.due_in_window() if cell.traffic["kind"] == "open" else
           [r for r in rec.requests if r.sent < rec.end])
    failed = (sum(1 for r in due if not r.times)
              if cell.traffic.get("drain_first_tokens") else 0)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if rec.trace is not None:
        dev["busy_s"] = rec.trace["busy_s"]
        dev["window_s"] = rec.trace["window_s"]
    out = {"correct": bool(correct), "attempted": len(due), "failed": failed,
           "metrics": metrics, "device": dev}
    if rec.trace is not None:
        out["breakdown"] = devtrace.breakdown(rec.trace)
    out["checks"] = checks
    note = (f"perfbench: {cell.name} seed {seed}: setup {rec.setup_s:.1f} s, "
            f"window {rec.seconds:.1f} s, {len(rec.requests)} requests sent, "
            f"{len(rec.steps)} steps; check of {nums['prefills']} prefills "
            f"and {nums['ticks']} ticks ({nums['rows']} rows) in {t_ref:.1f} s")
    return out, note
