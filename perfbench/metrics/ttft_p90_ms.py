"""ttft_p90_ms: time to first token of every request due in the window,
from its due time (an open loop's schedule, not its send), the 90th
percentile (nearest rank).  A request that never got a first token
counts as infinitely late."""
import math

from perfbench.loadgen import percentile


def read(rec):
    due = rec.due_in_window()
    if not due:
        return None
    v = percentile([(r.times[0] - r.due) * 1e3 if r.times else math.inf
                    for r in due], 90)
    return v if math.isfinite(v) else None
