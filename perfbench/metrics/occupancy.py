"""occupancy: live slots per decode tick over the engine's slots, the
mean over the window's ticks, in percent (what the engine's
``serve_batch_occupancy`` histogram counts)."""


def read(rec):
    n = [len(p) for t0, t1, p in rec.ticks
         if t1 is not None and rec.start <= t0 and t1 <= rec.end]
    return 100.0 * sum(n) / (len(n) * rec.max_slots) if n else None
