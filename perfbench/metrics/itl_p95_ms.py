"""itl_p95_ms: the gaps between consecutive output tokens of every
request, both tokens inside the window, the 95th percentile (nearest
rank)."""
from perfbench.loadgen import percentile


def read(rec):
    gaps = [(b - a) * 1e3 for r in rec.requests
            for a, b in zip(r.times, r.times[1:])
            if rec.start <= a and b <= rec.end]
    return percentile(gaps, 95) if gaps else None
