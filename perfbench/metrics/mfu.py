"""mfu: the whole step's share of the card's peak: the work the traffic
needed in the traced window (B1's, ``work.b1``, for live rows only, and
the digital model's, ``work.digital``) over the window times the peak
rate of ``work.peaks``, in percent."""
from perfbench.work import b1, digital, peaks


def read(rec):
    tr = rec.trace
    if tr is None or tr["window_s"] <= 0:
        return None
    flops = 0
    for t0, t1, pos in rec.ticks:
        if t1 is not None and rec.start <= t0 and t1 <= rec.end and pos:
            flops += b1.call_work(len(pos), rec.sites)[1]
            flops += digital.decode_flops(rec.cfg, pos)
    for t0, t1, n in rec.prefills:
        if rec.start <= t0 and t1 <= rec.end:
            flops += b1.call_work(n, rec.sites)[1]
            flops += digital.prefill_flops(rec.cfg, n)
    return 100.0 * flops / (tr["window_s"] * peaks.FLOP_S)
