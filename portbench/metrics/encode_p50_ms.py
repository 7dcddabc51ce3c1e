"""encode_p50_ms: the median latency of the traced run's encode calls
outside the profiled ones, from the call to the returned states (host
clock); milliseconds."""

import statistics


def read(r):
    lat = getattr(r, "latencies_s", None)
    return 1e3 * statistics.median(lat) if lat else None
