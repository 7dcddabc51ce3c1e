"""The reader of ``encode_replayed_share.encode``: the share of the
profiled encode chunks that replayed a captured CUDA graph, on
hand-built traces of the port's ``srl.encode.launch`` spans, each with
an ``srl.encode.replay`` span inside it where the chunk replayed."""

from types import SimpleNamespace

import pytest

from portbench.harness import core
from portbench.harness.trace import Trace

MS = 1_000_000  # ns
METRIC = "encode_replayed_share.encode"


def _read(readings):
    return core.load_reader(METRIC)(readings)


def _chunks(replayed):
    """One encode chunk a flag: its launch span, and inside it a replay
    span where the flag is set."""
    host = []
    for i, rep in enumerate(replayed):
        t = i * MS
        host.append((t, t + 500_000, "srl.encode.launch"))
        if rep:
            host.append((t + 100_000, t + 200_000, "srl.encode.replay"))
    return Trace(device=[(0, 10, "k")], host=sorted(host))


@pytest.mark.parametrize("replayed,share", [
    ([True] * 4, 100.0), ([True, False] * 3, 50.0), ([False] * 2, 0.0)])
def test_encode_replayed_share_by_hand(replayed, share, monkeypatch):
    """Replay spans over launch spans: every chunk replayed reads 100,
    half of them 50, none 0; a port whose encoder has no graph route (no
    ``counts()``, as before it) and no trace read nothing."""
    from srl_zoo_tpu_torch.inference import StateEncoder
    r = SimpleNamespace(trace=_chunks(replayed),
                        traced_call_s=[1e-3] * len(replayed))
    assert _read(r) == pytest.approx(share)
    assert _read(SimpleNamespace(trace=None)) is None
    assert _read(SimpleNamespace()) is None
    monkeypatch.delattr(StateEncoder, "counts")
    assert _read(r) is None

