"""idle.encode: the share of the profiled encode calls' summed latency in
which no operation ran on the device (the think time between calls left
out); percent."""


def read(r):
    tr = getattr(r, "trace", None)
    if tr is None or not r.traced_call_s:
        return None
    return 100.0 * max(0.0, 1.0 - tr.busy_s() / sum(r.traced_call_s))
