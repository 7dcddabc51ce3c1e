"""The readers of the port's spans: each trace reader's arithmetic on a
hand-built trace (device intervals and the launching thread's ``srl.``
spans, the answers worked by hand), the registry readers on the port's
span registry, and a traced CPU run of a resident cell that reports the
registry readers."""

import sys
from types import SimpleNamespace

import pytest

from portbench.harness import core
from portbench.harness.trace import Trace
from portbench.tests.helpers import run_tiny

MS = 1_000_000  # ns


def _read(metric, readings):
    return core.load_reader(metric)(readings)


def _train_trace():
    """An epoch of 0.5 ms: three idle gaps of at least 20 us between
    device operations, and one shorter. The first gap's middle (75,050)
    lies in ``srl.learn.stack``, the second's (225,100) in a replay, the
    third's (350,025) outside any ``srl.`` span."""
    device = [(0, 100, "k1"), (150_000, 150_100, "k2"),
              (150_110, 150_200, "k3"), (300_000, 300_050, "k4"),
              (400_000, 400_010, "k5")]
    host = sorted([
        (0, 340_000, "srl.learn.epoch"),
        (60_000, 90_000, "srl.learn.stack"),
        (95_000, 97_000, "srl.runner.load"),
        (98_000, 99_000, "srl.learn.metrics"),
        (200_000, 260_000, "srl.runner.replay"),
        (270_000, 271_000, "srl.checkpoint.submit"),
        (280_000, 280_500, "srl.checkpoint.submit"),
        (340_000, 360_000, "aten::copy_"),
    ])
    return Trace(device=device, host=host)


def test_train_trace_readers_by_hand():
    r = SimpleNamespace(trace=_train_trace(), traced_s=500_000 / 1e9,
                        epoch_s=[0.0005])
    # stack 30,000 ns and load 2,000 ns
    assert _read("stack_upload_ms.train", r) == pytest.approx(0.032)
    # two submits, 1,000 and 500 ns
    assert _read("checkpoint_submit_ms.train", r) == pytest.approx(0.0015)
    # the first gap alone, 149,900 ns of 500,000
    assert _read("idle_between_phases.train", r) == pytest.approx(29.98)


def test_a_gap_in_a_replay_nested_in_a_phase_is_left_out():
    """The replay excludes its gaps however deep it sits in other
    ``srl.`` spans, and a gap under 20 us counts nowhere."""
    device = [(0, 10, "k"), (100_000, 100_010, "k"), (100_020, 100_030, "k"),
              (200_000, 200_010, "k")]
    host = sorted([(0, 300_000, "srl.learn.epoch"),
                   (0, 150_000, "srl.learn.phase"),
                   (20_000, 140_000, "srl.runner.replay")])
    r = SimpleNamespace(trace=Trace(device=device, host=host),
                        traced_s=300_000 / 1e9, epoch_s=[])
    # the first gap (mid 50,005) is a replay's; the last (mid 150,015)
    # lies in the epoch: 99,970 ns of 300,000
    assert _read("idle_between_phases.train", r) == \
        pytest.approx(100 * 99_970 / 300_000)


def test_encode_trace_readers_by_hand():
    """Two profiled calls: upload 0.3 and 0.2 ms, launch 0.7 and 0.5 ms,
    readback 0.1 ms and 0.1 + 0.02 ms; per call."""
    host = sorted([
        (0, 1_120 * 1000, "srl.encode"),
        (0, 300_000, "srl.encode.upload"),
        (300_000, 1_000_000, "srl.encode.launch"),
        (400_000, 500_000, "aten::convolution"),
        (1_000_000, 1_100_000, "srl.encode.readback"),
        (1_100_000, 1_120_000, "srl.encode.readback"),
        (5 * MS, 5 * MS + 200_000, "srl.encode.upload"),
        (5 * MS + 200_000, 5 * MS + 700_000, "srl.encode.launch"),
        (5 * MS + 700_000, 5 * MS + 800_000, "srl.encode.readback"),
    ])
    r = SimpleNamespace(trace=Trace(device=[(0, 10, "k")], host=host),
                        traced_call_s=[0.0012, 0.0009])
    assert _read("encode_upload_ms.encode", r) == pytest.approx(0.25)
    assert _read("encode_launch_ms.encode", r) == pytest.approx(0.6)
    assert _read("encode_readback_ms.encode", r) == pytest.approx(0.11)


TRACE_READERS = ["stack_upload_ms.train", "checkpoint_submit_ms.train",
                 "idle_between_phases.train", "encode_upload_ms.encode",
                 "encode_launch_ms.encode", "encode_readback_ms.encode",
                 "encode_replayed_share.encode"]


@pytest.mark.parametrize("metric", TRACE_READERS)
def test_trace_reader_without_spans_reads_nothing(metric):
    """A trace without the port's spans (a port that emits none, or a
    CPU run, whose host events are not kept) gives no number."""
    r = SimpleNamespace(trace=Trace(device=[(0, 10, "k"), (50_000, 50_010,
                                                          "k")],
                                    host=[(0, 60_000, "aten::mm")]),
                        traced_s=1e-4, traced_call_s=[1e-4], epoch_s=[])
    assert _read(metric, r) is None


@pytest.fixture
def registry():
    from srl_zoo_tpu_torch.utils import spans
    spans.reset()
    yield spans
    spans.reset()


def test_registry_readers(registry, monkeypatch):
    r = SimpleNamespace(epoch_s=[])
    assert _read("store_upload_s.train", r) is None
    assert _read("runner_setup_s.train", r) is None
    for name in ("srl.store.upload", "srl.runner.warm", "srl.runner.warm",
                 "srl.runner.capture", "srl.learn.stack"):
        with registry.span(name):
            pass
    t = registry.totals()
    assert _read("store_upload_s.train", r) == t["srl.store.upload"][1] > 0
    assert _read("runner_setup_s.train", r) == pytest.approx(
        t["srl.runner.warm"][1] + t["srl.runner.capture"][1])
    # not a training run's readings
    assert _read("store_upload_s.train", SimpleNamespace()) is None
    # a port without the span module (the parent of the spans' change)
    import srl_zoo_tpu_torch.utils
    monkeypatch.delattr(srl_zoo_tpu_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "srl_zoo_tpu_torch.utils.spans", None)
    assert _read("store_upload_s.train", r) is None
    assert _read("runner_setup_s.train", r) is None


def test_traced_cpu_run_reports_the_registry_readers(registry):
    """A traced CPU run of a resident cell: the store's upload and the
    runner's warm-up (the CPU captures nothing) are read after the run."""
    _, res = run_tiny("cnn_ae.resident", trace=True)
    assert res["correct"], res["checks"]
    for name in ("store_upload_s.train", "runner_setup_s.train"):
        assert res["metrics"][name]["value"] > 0
        assert res["metrics"][name]["unit"] == "s"
