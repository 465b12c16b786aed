"""send_lag_p99_ms: how late the load generator sent each request due in
the window, against its due time (host clock), the 99th percentile.  A
send waits for the engine call in progress."""
from perfbench.loadgen import percentile


def read(rec):
    lag = [(r.sent - r.due) * 1e3 for r in rec.due_in_window()]
    return percentile(lag, 99) if lag else None
