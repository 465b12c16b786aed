"""b1_roofline: B1's share of its roofline in the traced window: the
least time the card could take for the B1 work the traffic needed (the
live rows of each call at every analog site, ``work.b1``, against the
peaks of ``work.peaks``) over the device time of B1's kernels in the
trace.  None when no B1 kernel ran."""
from perfbench.work import b1, peaks


def read(rec):
    tr = rec.trace
    if tr is None or tr["b1_s"] <= 0:
        return None
    bound = 0.0
    for m in calls(rec):
        nbytes, flops = b1.call_work(m, rec.sites)
        bound += peaks.bound_s(nbytes, flops)
    return 100.0 * bound / tr["b1_s"]


def calls(rec):
    """Rows of each engine call inside the traced window: a tick's live
    rows, a prefill's prompt."""
    for t0, t1, pos in rec.ticks:
        if t1 is not None and rec.start <= t0 and t1 <= rec.end and pos:
            yield len(pos)
    for t0, t1, n in rec.prefills:
        if rec.start <= t0 and t1 <= rec.end:
            yield n
