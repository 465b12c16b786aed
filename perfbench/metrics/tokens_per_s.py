"""tokens_per_s: prompt tokens prefilled plus tokens generated, all
inside the window, over the window's seconds."""


def read(rec):
    prompt = sum(p for t0, t1, p in rec.prefills
                 if rec.start <= t0 and t1 <= rec.end)
    out = sum(1 for r in rec.requests for t in r.times
              if rec.start <= t <= rec.end)
    return (prompt + out) / rec.seconds
