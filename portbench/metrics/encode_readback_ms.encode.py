"""encode_readback_ms.encode: host milliseconds a profiled encode call
spent in the port's span ``srl.encode.readback`` (the wait for the
states, their copy back and their concatenation;
srl_zoo_tpu_torch/inference.py), from the spans in the trace, over the
profiled calls. Moves ``encode_p95_ms``."""

NAME = "srl.encode.readback"


def read(r):
    tr = getattr(r, "trace", None)
    calls = getattr(r, "traced_call_s", None)
    if tr is None or not calls:
        return None
    found = [e - s for s, e, n in tr.host if n == NAME]
    return sum(found) / 1e6 / len(calls) if found else None
