"""encode_replayed_share.encode: percent of the profiled encode chunks
that ran as one replay of a captured CUDA graph: the port's spans
``srl.encode.replay`` (each inside a chunk's ``srl.encode.launch``;
srl_zoo_tpu_torch/inference.py) over its ``srl.encode.launch`` spans, in
the trace. A port whose ``StateEncoder`` has no graph route (no
``counts()``) gives no number; one that has it and replayed no chunk
reads 0. Moves ``encode_p95_ms``."""

REPLAY, LAUNCH = "srl.encode.replay", "srl.encode.launch"


def read(r):
    tr = getattr(r, "trace", None)
    if tr is None:
        return None
    names = [n for _, _, n in tr.host]
    launches = names.count(LAUNCH)
    if not launches or not _has_graph_route():
        return None
    return 100.0 * names.count(REPLAY) / launches


def _has_graph_route():
    from srl_zoo_tpu_torch.inference import StateEncoder
    return hasattr(StateEncoder, "counts")
