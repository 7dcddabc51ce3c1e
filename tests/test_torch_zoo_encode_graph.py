"""``StateEncoder.encode``'s graph route (srl_zoo_tpu_torch/inference.py):
each chunk one replay of its row count's captured CUDA graph, over static
buffers.

On the CPU stand-ins take the place of the CUDA objects: of the capture
(``_build.capture``: the body runs once at the capture, as a capture's
Python does, and once a replay), the eager warm-up on the side stream
(``_build.run_on``), the current stream, and the static buffers with the
stream and the event (``StateEncoder._allocate``, here on the CPU). An
encoder of a CUDA device whose model lies on the CPU then takes the
graph route, so the bookkeeping runs here: capture at the first chunk of
a row count, replays after, a graph a chunk size, states that are the
call's own, threads, the eager route where it stays, the spans and the
launch tally. The tests marked ``chip`` hold the real graphs to the
eager route bit for bit on a CUDA device (one of them on a device other
than the thread's current one, with two cards) and skip without one;
this file imports no JAX, so on the card it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -q -m chip \\
        tests/test_torch_zoo_encode_graph.py
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading

import numpy as np
import pytest
import torch

from srl_zoo_tpu_torch import inference
from srl_zoo_tpu_torch.utils import spans

IMG = 32


@pytest.fixture(autouse=True)
def _clean_registry():
    spans.reset()
    yield
    spans.reset()


@contextlib.contextmanager
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _cfg(img=IMG, state_dim=4, **kw):
    from srl_zoo_tpu_torch.config import SRLConfig
    fields = {"state_dim": state_dim, "img_height": img, "img_width": img,
              "batch_size": 16, "n_actions": 4, "n_reward_classes": 3,
              "seed": 3, "losses": (("autoencoder", 1.0),),
              "split_dims": (("autoencoder", -1),)}
    return SRLConfig(**(fields | kw))


def _encoder(device="cpu", max_batch=32, cfg=None, model=None):
    """An encoder of ``device`` around a model on the CPU (the graph
    route's stand-ins run it there)."""
    from srl_zoo_tpu_torch.models.srl_modules import SRLModules
    cfg = cfg or _cfg()
    torch.manual_seed(0)
    model = model or SRLModules(cfg).eval()
    return inference.StateEncoder(cfg, model, torch.device(device),
                                  max_batch)


CUDA = "cuda:0"  # an encoder's device with the stand-ins in place


def _frames(n, seed=0, img=IMG, channels=3):
    return np.random.default_rng(seed).integers(
        0, 256, (n, img, img, channels), dtype=np.uint8)


class StandIn:
    """Where ``torch.cuda.CUDAGraph`` would be: the body runs at the
    capture (as a capture's Python does) and again at each replay, whose
    launches, as a real replay's, pass no wrapper's counter (they go to
    a tally thrown away)."""

    def __init__(self, body):
        self.body = body
        self.replays = 0

    def replay(self):
        from srl_zoo_tpu_torch.ops import _build
        self.replays += 1
        with _build.tally_launches():
            self.body()


class Event:
    """Where ``torch.cuda.Event`` would be: holds the stream recorded
    on (the work before a CPU stand-in's record is done when it
    returns)."""

    def __init__(self):
        self.streams = []

    def record(self, stream):
        self.streams.append(stream)

    def synchronize(self):
        assert self.streams, "waited on an event never recorded"


@pytest.fixture
def graphs(monkeypatch):
    """Stand-ins for the graph route's CUDA objects; yields the list of
    graphs captured; the calls of the gather each graph body makes are
    counted on ``graphs.gathers``, and the encoders' events are on
    ``graphs.events``."""
    from srl_zoo_tpu_torch.ops import _build
    captured = type("Graphs", (list,), {})()
    side, main, pool = object(), object(), object()

    def allocate(self):
        shape = (self.max_batch,) + tuple(self.cfg.img_shape)
        self._static = (torch.empty(shape, dtype=torch.uint8),
                        torch.empty(shape, dtype=torch.uint8),
                        torch.arange(self.max_batch),
                        torch.empty((self.max_batch, self.cfg.state_dim)))
        self._stream, self._done, self._pool = side, Event(), pool
        captured.events.append(self._done)

    def run_on(stream, body):
        assert stream is side
        body()

    def capture(body, stream, pool_=None, generators=()):
        assert stream is side and pool_ is pool and generators == ()
        with _build.tally_launches() as tally:
            body()
        captured.append(StandIn(body))
        return captured[-1], tally

    def current_stream(device=None):
        assert torch.device(device) == torch.device(CUDA)
        return main
    gathers = []
    plain = inference.gather_normalize_device

    def gather(frames, idx, mode):
        gathers.append(len(idx))
        return plain(frames, idx, mode)
    monkeypatch.setattr(inference.StateEncoder, "_allocate", allocate)
    monkeypatch.setattr(_build, "run_on", run_on)
    monkeypatch.setattr(_build, "capture", capture)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(inference, "gather_normalize_device", gather)
    captured.gathers, captured.events, captured.main = gathers, [], main
    return captured


def _eager_states(model, frames, max_batch=32):
    """The same frames through a CPU encoder of the same model: the
    eager route."""
    enc = _encoder(model=model, max_batch=max_batch)
    out = enc.encode(frames)
    assert enc.counts()["replays"] == 0
    return out


# ---------------------------------------------------------------------------
# capture, replay and the graphs' sizes
# ---------------------------------------------------------------------------

def test_first_call_of_a_row_count_warms_and_captures_later_calls_replay(
        graphs):
    """The first 16-row call runs the body eagerly once (the warm-up),
    captures it and replays it; the next 16-row calls replay only; a
    1-row call captures its own graph; the states are the eager
    route's, bit for bit."""
    frames = _frames(16)
    with _one_torch_thread():
        enc = _encoder(CUDA)
        first = enc.encode(frames)
        assert enc.counts() == {"replays": 1, "captures": 1,
                                "eager_chunks": 0}
        # warm-up, capture, replay
        assert graphs.gathers == [16, 16, 16]
        for _ in range(3):
            again = enc.encode(frames)
            np.testing.assert_array_equal(again, first)
        assert enc.counts() == {"replays": 4, "captures": 1,
                                "eager_chunks": 0}
        assert graphs.gathers == [16] * 6
        assert len(graphs) == 1 and graphs[0].replays == 4
        # each replay's event on the current stream of the encoder's device
        assert graphs.events[0].streams == [graphs.main] * 4
        one = enc.encode(frames[3])
        assert one.shape == (4,) and one.dtype == np.float32
        assert enc.counts() == {"replays": 5, "captures": 2,
                                "eager_chunks": 0}
        assert len(graphs) == 2
        np.testing.assert_array_equal(one, _eager_states(enc.model,
                                                         frames[3]))
        np.testing.assert_array_equal(first,
                                      _eager_states(enc.model, frames))


def test_forty_rows_take_two_graphs(graphs):
    """With ``max_batch`` 32 a 40-row call is a 32-row and an 8-row
    chunk: two graphs, one replay each, and the rows in order."""
    frames = _frames(40, seed=1)
    with _one_torch_thread():
        enc = _encoder(CUDA, max_batch=32)
        got = enc.encode(frames)
        assert got.shape == (40, 4)
        assert sorted(enc._graphs) == [8, 32]
        assert enc.counts() == {"replays": 2, "captures": 2,
                                "eager_chunks": 0}
        enc.encode(frames)
        assert enc.counts() == {"replays": 4, "captures": 2,
                                "eager_chunks": 0}
        np.testing.assert_array_equal(got, _eager_states(enc.model, frames))


def test_returned_states_are_not_changed_by_the_next_call(graphs):
    """A call's states are a fresh array: the static output buffer is
    rewritten by the next call of the same size, and of another size."""
    a, b = _frames(16, seed=2), _frames(16, seed=3)
    with _one_torch_thread():
        enc = _encoder(CUDA)
        got_a = enc.encode(a)
        kept = got_a.copy()
        got_b = enc.encode(b)
        enc.encode(b[:5])
        np.testing.assert_array_equal(got_a, kept)
        assert not np.array_equal(got_a, got_b)
        assert not np.shares_memory(got_a, got_b)
        assert not np.shares_memory(got_a, enc._static[3].numpy())


def test_threads_each_get_their_own_states(graphs):
    """More threads than cores, switching often, each encoding its own
    frames at its own row count: every call returns its own states."""
    n_threads = 2 * (os.cpu_count() or 4)
    inputs = [_frames(1 + t % 5, seed=10 + t) for t in range(n_threads)]
    old = sys.getswitchinterval()
    with _one_torch_thread():
        enc = _encoder(CUDA)
        want = [enc.encode(x) for x in inputs]
        wrong = []

        def work(t):
            for _ in range(10):
                if not np.array_equal(enc.encode(inputs[t]), want[t]):
                    wrong.append(t)
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=work, args=(t,))
                       for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            assert not any(th.is_alive() for th in threads)
        finally:
            sys.setswitchinterval(old)
    assert wrong == []
    assert enc.counts()["replays"] == 11 * n_threads
    assert enc.counts()["captures"] == 5


# ---------------------------------------------------------------------------
# where the route is not taken
# ---------------------------------------------------------------------------

def test_training_mode_and_the_cpu_stay_eager(graphs, monkeypatch):
    """A CUDA encoder whose model is in training mode stays on the eager
    route (run here with its upload kept on the CPU), and so does a CPU
    encoder in eval mode; ``counts()`` says so, and neither allocates
    the graph route's buffers."""
    frames = _frames(20, seed=4)
    eager = inference.StateEncoder._eager_chunk

    def on_the_cpu(self, obs):
        self.device, device = torch.device("cpu"), self.device
        try:
            return eager(self, obs)
        finally:
            self.device = device
    with _one_torch_thread():
        with monkeypatch.context() as m:
            m.setattr(inference.StateEncoder, "_eager_chunk", on_the_cpu)
            enc = _encoder(CUDA, max_batch=16)
            enc.model.train()
            enc.encode(frames)
        assert enc.counts() == {"replays": 0, "captures": 0,
                                "eager_chunks": 2}
        assert graphs == [] and graphs.gathers == []
        assert enc._static is None
        cpu = _encoder(max_batch=16)
        cpu.encode(frames)
        assert cpu.counts() == {"replays": 0, "captures": 0,
                                "eager_chunks": 2}
        assert graphs == [] and cpu._static is None


# ---------------------------------------------------------------------------
# spans and launch counters
# ---------------------------------------------------------------------------

def test_replay_span_nests_in_launch_and_the_children_tile_the_call(
        graphs):
    """Under a CPU profiler each replayed chunk is an
    ``srl.encode.replay`` range inside its ``srl.encode.launch``. The
    upload, launch and readback spans tile each of the three calls: they
    lie inside its ``srl.encode`` range, one after another without
    overlap, in the order of the call's stages (the call's checks, then
    each chunk's upload, launch and readback, then the concatenation),
    and every operation the profiler records inside the call lies inside
    one of them. The tiling is read from the ranges, not from host
    seconds, so a busy host cannot move it."""
    from torch.profiler import ProfilerActivity, profile
    frames = _frames(20, seed=5)
    with _one_torch_thread():
        enc = _encoder(CUDA, max_batch=16)
        enc.encode(frames)  # the captures
        spans.reset()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                enc.encode(frames)
    events = sorted((ev.start_ns(), ev.end_ns(), ev.name())
                    for ev in prof.profiler.kineto_results.events())
    ranges = {}
    for s, e, name in events:
        ranges.setdefault(name, []).append((s, e))
    launches, replays = ranges["srl.encode.launch"], \
        ranges["srl.encode.replay"]
    assert len(launches) == len(replays) == 6
    for s, e in replays:
        assert sum(ls <= s and e <= le for ls, le in launches) == 1
    calls = ranges["srl.encode"]
    assert len(calls) == 3
    stages = ("srl.encode.upload", "srl.encode.launch", "srl.encode.readback")
    for cs, ce in calls:
        inside = [(s, e, name) for s, e, name in events
                  if cs <= s and e <= ce and name != "srl.encode"]
        tiles = [(s, e, name) for s, e, name in inside if name in stages]
        assert [name[11:] for _, _, name in tiles] == \
            ["upload"] + ["upload", "launch", "readback"] * 2 + ["readback"]
        assert all(e1 <= s2 for (_, e1, _), (s2, _, _) in zip(tiles,
                                                              tiles[1:]))
        for s, e, name in inside:
            assert any(ts <= s and e <= te for ts, te, _ in tiles), name
    t = spans.totals()
    assert t["srl.encode"][0] == 3 and t["srl.encode.replay"][0] == 6
    assert t["srl.encode.replay"][1] <= t["srl.encode.launch"][1]


def test_launches_count_once_a_replay(graphs, monkeypatch):
    """A launch inside the graph body counts at the warm-up, not at the
    capture (it goes to the capture's tally), and once at each
    replay."""
    from srl_zoo_tpu_torch.ops import _build

    def counter():
        pass
    counter.launches = 0
    plain = inference.gather_normalize_device

    def gather(frames, idx, mode):
        _build.count(counter, launches=1)
        return plain(frames, idx, mode)
    monkeypatch.setattr(inference, "gather_normalize_device", gather)
    frames = _frames(4, seed=6)
    with _one_torch_thread():
        enc = _encoder(CUDA)
        enc.encode(frames)
        assert counter.launches == 2  # the warm-up and the replay
        for _ in range(5):
            enc.encode(frames)
    assert counter.launches == 7


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _eager_on(enc, frames):
    """The eager route's states of ``frames`` on ``enc``'s device, chunk
    by chunk as ``encode`` splits them."""
    with torch.inference_mode():
        return np.concatenate([
            enc._eager_chunk(frames[s:s + enc.max_batch])
            for s in range(0, len(frames), enc.max_batch)])


def _graph_against_eager(device, model_type="custom_cnn", channels=3):
    """256 calls at 1, 16, 32 and 40 rows on ``device``: each call's
    states from the graph route and from the eager route, bit for bit,
    with one replay a chunk and one capture a chunk size; the static
    buffers are those of ``max_batch`` rows, pinned on the host."""
    from srl_zoo_tpu_torch.models.srl_modules import SRLModules
    from srl_zoo_tpu_torch.utils.device import use_strict_float32
    use_strict_float32()
    cfg = _cfg(img=224, state_dim=200, model_type=model_type,
               multi_view=channels == 6)
    torch.manual_seed(0)
    model = SRLModules(cfg).to(device).eval()
    enc = inference.StateEncoder(cfg, model, device, max_batch=32)
    sizes = (1, 16, 32, 40)
    pool = _frames(64, seed=7, img=224, channels=channels)
    rng = np.random.default_rng(8)
    chunks = 0
    for i in range(256):
        rows = sizes[i % len(sizes)]
        start = int(rng.integers(0, len(pool) - rows + 1))
        frames = pool[start:start + rows]
        got = enc.encode(frames)
        want = _eager_on(enc, frames)
        assert got.shape == want.shape == (rows, 200)
        assert np.array_equal(got, want), (i, rows, float(
            np.abs(got - want).max()))
        chunks += -(-rows // 32)
    assert enc.counts() == {"replays": chunks, "captures": 4,
                            "eager_chunks": chunks}
    host_in, dev_in, idx, host_out = enc._static
    assert host_in.shape[0] == dev_in.shape[0] == idx.shape[0] == \
        host_out.shape[0] == 32
    assert host_in.is_pinned() and host_out.is_pinned()
    assert dev_in.device == idx.device == device


@pytest.mark.chip
@pytest.mark.parametrize("model_type,channels", [("custom_cnn", 3),
                                                 ("resnet", 6)])
def test_graph_route_equals_eager_on_the_card(cuda, model_type, channels):
    """On the thread's current CUDA device: the graph route equals the
    eager route bit for bit (float32, TF32 off)."""
    _graph_against_eager(cuda, model_type, channels)


@pytest.mark.chip
def test_graph_route_on_another_card_than_the_current_one(cuda):
    """An encoder of the second card, called from a thread whose current
    device is the first: the replay runs on the second card's current
    stream, and the wait is on that stream, so every call's states are
    its own and equal the eager route's bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.cuda.set_device(cuda)
    _graph_against_eager(torch.device("cuda", 1))
    assert torch.cuda.current_device() == cuda.index
