"""The port's host spans (``srl_zoo_tpu_torch/utils/spans.py``): the
registry, the profiler as their only switch, the spans of a CPU ``learn``
epoch and of ``StateEncoder.encode`` in a CPU trace, the learner's
``phase_log`` timed through them, the encode call's tiling, the per-epoch
``spans.jsonl`` and the ``--profile`` summary's span table."""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from srl_zoo_tpu_torch.utils import spans

BS = 16
# every span a CPU epoch of a whole store and an encode call end
CPU_SPANS = {"srl.store.upload", "srl.learn.epoch", "srl.learn.phase",
             "srl.learn.stack", "srl.runner.load", "srl.runner.warm",
             "srl.learn.metrics", "srl.learn.validate",
             "srl.checkpoint.submit", "srl.encode", "srl.encode.upload",
             "srl.encode.launch", "srl.encode.readback"}


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


def _cfg(**kw):
    from srl_zoo_tpu_torch.config import SRLConfig
    fields = {"state_dim": 4, "img_height": 32, "img_width": 32,
              "batch_size": BS, "n_actions": 4, "n_reward_classes": 3,
              "epochs": 2, "seed": 3, "learning_rate": 1e-3, "num_cpu": 2,
              "training_set_size": 48,
              "losses": (("autoencoder", 1.0),),
              "split_dims": (("autoencoder", -1),)}
    return SRLConfig(**(fields | kw))


def _learner(cfg, log, time_phases=False):
    from srl_zoo_tpu_torch.training.learner import SRL4robotics
    learner = SRL4robotics(cfg, log_folder=log, device="cpu")
    learner.time_phases = time_phases
    return learner


# ---------------------------------------------------------------------------
# the registry and its switch
# ---------------------------------------------------------------------------

def test_registry_counts_nested_seconds_and_resets():
    with spans.span("srl.test.outer") as outer:
        for _ in range(3):
            with spans.span("srl.test.inner"):
                sum(range(1000))
    got = spans.totals()
    assert got["srl.test.outer"][0] == 1 and got["srl.test.inner"][0] == 3
    assert 0 < got["srl.test.inner"][1] <= got["srl.test.outer"][1]
    assert got["srl.test.outer"][1] == outer.seconds > 0
    since = spans.totals()
    with spans.span("srl.test.inner"):
        pass
    assert list(spans.delta(since)) == ["srl.test.inner"]
    assert spans.delta(since)["srl.test.inner"][0] == 1
    with pytest.raises(KeyError):
        with spans.span("srl.test.raises"):
            raise KeyError("x")
    assert spans.totals()["srl.test.raises"][0] == 1
    spans.reset()
    assert spans.totals() == {}


def test_record_function_only_while_a_profiler_records(monkeypatch):
    """With no profiler running a span never enters ``record_function``;
    under one, each span enters it once."""
    entered = []

    class Counting:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(spans, "record_function", Counting)
    for _ in range(5):
        with spans.span("srl.test.off"):
            pass
    assert entered == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("srl.test.on"):
            pass
    assert entered == ["srl.test.on"]


def test_registry_loses_no_update_across_threads():
    """More threads than cores, switching often: every span is counted."""
    n_threads, n = 2 * (os.cpu_count() or 4), 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with spans.span("srl.test.threads"):
                    pass
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert spans.totals()["srl.test.threads"][0] == n_threads * n


# ---------------------------------------------------------------------------
# the spans of a learn epoch and of an encode call, in a CPU trace
# ---------------------------------------------------------------------------

def _srl_events(prof):
    """(srl. span names, their thread ids, the thread id of the marker
    range that the test thread recorded)."""
    names, tids, marker = [], set(), None
    for ev in prof.profiler.kineto_results.events():
        if ev.name() == "test.marker":
            marker = ev.start_thread_id()
        elif ev.name().startswith("srl."):
            names.append(ev.name())
            tids.add(ev.start_thread_id())
    return names, tids, marker


def test_spans_of_an_epoch_and_an_encode_show_in_the_trace(
        synthetic_dataset, tmp_path):
    """Under a CPU profiler every span of a learn epoch (the store's
    upload, the phase, stacking, the runner's load and warm-up, metrics,
    validation, the checkpoint submits) and of an encode call is a host
    event of the calling thread, as many as the registry counted."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.inference import StateEncoder
    learner = _learner(_cfg(epochs=1), str(tmp_path / "run"),
                       time_phases=True)
    dataset = load_dataset(synthetic_dataset.data_folder)
    with _one_torch_thread(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.marker"):
            pass
        learner.learn(dataset)
        encoder = StateEncoder(learner.cfg, learner.model.eval(),
                               torch.device("cpu"), max_batch=BS)
        encoder.encode(np.asarray(dataset.frames[:20]))
    names, tids, marker = _srl_events(prof)
    assert set(names) == CPU_SPANS
    assert tids == {marker}
    counted = {k: c for k, (c, _) in spans.totals().items()}
    assert {k: names.count(k) for k in set(names)} == counted
    # two chunks of at most BS rows: an upload of the checks and one a
    # chunk, a readback a chunk and one of the concatenation
    assert counted["srl.encode.launch"] == 2
    assert counted["srl.encode.upload"] == counted["srl.encode.readback"] \
        == 3


def test_encode_children_tile_the_call(synthetic_dataset):
    """The upload, launch and readback spans hold at least 90% of the
    call's host time."""
    from srl_zoo_tpu_torch.inference import StateEncoder
    from srl_zoo_tpu_torch.models.srl_modules import SRLModules
    cfg = _cfg()
    encoder = StateEncoder(cfg, SRLModules(cfg).eval(), torch.device("cpu"))
    frames = np.asarray(synthetic_dataset.frames[:16])
    with _one_torch_thread():
        for _ in range(20):
            encoder.encode(frames)
    t = spans.totals()
    parts = sum(t[f"srl.encode.{k}"][1]
                for k in ("upload", "launch", "readback"))
    assert t["srl.encode"][0] == 20
    assert parts >= 0.9 * t["srl.encode"][1]
    assert parts <= t["srl.encode"][1]


# ---------------------------------------------------------------------------
# phase_log through the spans, and the per-epoch export
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store", ["whole", "hybrid"])
def test_time_phases_writes_the_phase_log(store, synthetic_dataset,
                                          tmp_path, monkeypatch):
    """``time_phases`` logs each phase (and a hybrid store's adoptions and
    advance) with the keys, names and rows it always had, its seconds
    those of the ``srl.learn.phase`` span; without it nothing is
    logged."""
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.training.learner import split_indices
    kw = {}
    if store == "hybrid":
        kw = {"device_cache": "hybrid"}
        monkeypatch.setenv("SRL_ZOO_CACHE_BUDGET_MB",
                           str(40.5 * 32 * 32 * 3 / 2**20))
    cfg = _cfg(**kw)
    dataset = load_dataset(synthetic_dataset.data_folder)
    learner = _learner(cfg, str(tmp_path / "run"), time_phases=True)
    with _one_torch_thread():
        learner.learn(dataset)
    log = learner.phase_log
    assert log and all(list(p) == ["epoch", "what", "rows", "s"]
                       and p["s"] >= 0 for p in log)
    assert spans.totals()["srl.learn.phase"][0] == len(log)
    assert sum(p["s"] for p in log) == pytest.approx(
        spans.totals()["srl.learn.phase"][1])
    _, val = split_indices(dataset, cfg)
    for epoch in range(cfg.epochs):
        whats = [p["what"] for p in log if p["epoch"] == epoch]
        rows = {w: sum(p["rows"] for p in log if p["epoch"] == epoch
                       and p["what"] == w) for w in whats}
        if store == "whole":
            assert whats == ["train cached", "val cached"]
            assert rows["val cached"] == len(val)
        else:
            assert [w for w in whats if w != "adopt"] == [
                "train hot", "train cold", "val hot", "val cold", "advance"]
            assert "adopt" in whats
            assert rows["val hot"] + rows["val cold"] == len(val)
        assert rows[whats[0]] > 0
    quiet = _learner(cfg, str(tmp_path / "quiet"))
    with _one_torch_thread():
        quiet.learn(dataset)
    assert quiet.phase_log == []


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_spans_jsonl_holds_each_epochs_spans_and_runner_counts(
        synthetic_dataset, tmp_path):
    """One record an epoch in ``spans.jsonl``: each ``srl.`` span the
    epoch ended in ms (the warm-up in the first epoch only: the second
    runs the same programs) and the runner's counts of the epoch; a
    resumed run writes the epochs it runs again once."""
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.training.learner import split_indices
    cfg = _cfg()
    dataset = load_dataset(synthetic_dataset.data_folder)
    run = str(tmp_path / "run")
    with _one_torch_thread():
        _learner(cfg, run).learn(dataset)
    recs = _records(os.path.join(run, "spans.jsonl"))
    assert [r["epoch"] for r in recs] == [0, 1]
    train, val = split_indices(dataset, cfg)
    steps = -(-len(train) // BS) + -(-len(val) // BS)
    for r in recs:
        assert all(k.startswith("srl.") and v >= 0
                   for k, v in r["host_ms"].items())
        assert r["host_ms"]["srl.learn.epoch"] >= \
            r["host_ms"]["srl.learn.validate"] > 0
        assert r["runner"] == {"eager_steps": steps, "replays": 0,
                               "captures": 0}
    assert "srl.runner.warm" in recs[0]["host_ms"]
    assert "srl.runner.warm" not in recs[1]["host_ms"]
    # metrics.jsonl keeps its keys
    assert all("host_ms" not in r for r in
               _records(os.path.join(run, "metrics.jsonl")))
    resumed = str(tmp_path / "resumed")
    with _one_torch_thread():
        _learner(_cfg(epochs=1), resumed).learn(dataset)
        _learner(cfg, resumed).learn(dataset, resume=True)
    assert [r["epoch"] for r in _records(
        os.path.join(resumed, "spans.jsonl"))] == [0, 1]


def test_profile_summary_sums_span_times(tmp_path):
    """The ``--profile`` summary's span table: the host time of each
    ``srl.`` user annotation, summed by name, largest first."""
    from srl_zoo_tpu_torch.utils import profiling
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "srl.learn.stack",
         "pid": 1, "tid": 1, "ts": 0.0, "dur": 2000.0},
        {"ph": "X", "cat": "user_annotation", "name": "srl.learn.stack",
         "pid": 1, "tid": 1, "ts": 5000.0, "dur": 1000.0},
        {"ph": "X", "cat": "user_annotation", "name": "srl.runner.replay",
         "pid": 1, "tid": 1, "ts": 3000.0, "dur": 6000.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "srl.runner.replay",
         "pid": 0, "tid": 7, "ts": 3000.0, "dur": 6000.0},
        {"ph": "X", "cat": "user_annotation", "name": "other",
         "pid": 1, "tid": 1, "ts": 0.0, "dur": 9000.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
         "tid": 1, "ts": 0.0, "dur": 50.0},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    rows = profiling.span_times(str(path))
    assert [(r.name, r.ms, r.calls) for r in rows] == [
        ("srl.runner.replay", 6.0, 1), ("srl.learn.stack", 3.0, 2)]
    assert [r.pct for r in rows] == [100.0, 50.0]
