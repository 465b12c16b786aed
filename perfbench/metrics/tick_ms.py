"""tick_ms: the mean engine step inside the window (admission with its
bulk prefills, then one batched decode; it ends in the argmax's host
read), from the harness's span around ``engine.step()``: the steps'
seconds over their count."""


def read(rec):
    d = [t1 - t0 for t0, t1 in rec.steps if rec.start <= t0 and t1 <= rec.end]
    return sum(d) / len(d) * 1e3 if d else None
