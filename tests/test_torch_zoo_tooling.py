"""The PyTorch port's tooling (ROADMAP.md A9): the synthetic dataset
generator (``data/synthetic.py``) byte for byte against the JAX
package's, ``--profile`` and its summary (``utils/profiling.py``), and the
environment doctor (``utils/doctor.py``), on the CPU at 32 px."""

from __future__ import annotations

import json
import os
import threading
import time

import pytest
import torch

# (n_episodes, episode_len, img_size, seed, save_jpgs, multi_view, task,
# background_drift): between them every option of the generator
GENERATOR_ARGS = [
    (3, 10, 32, 0, False, False, "navigation", 0.0),
    (2, 12, 32, 4, True, True, "navigation", 0.0),
    (3, 8, 24, 1, False, True, "kuka", 0.5),
    (4, 6, 32, 2, True, False, "kuka", 1.0),
    (1, 5, 16, 3, True, True, "navigation", 0.25),
]


def _files(folder):
    out = {}
    for root, _, names in os.walk(folder):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, folder)] = f.read()
    return out


@pytest.mark.parametrize("args", GENERATOR_ARGS)
def test_generate_dataset_writes_the_jax_generators_files(args, tmp_path,
                                                          monkeypatch):
    """The same arguments give the same files, byte for byte: the frame
    memmaps, both npz files and the JPEGs. The npz files are zip archives
    that stamp each member with the wall clock, so the clock is held
    still while both generators run."""
    from srl_zoo_tpu.data.synthetic import generate_dataset as jax_generate
    from srl_zoo_tpu_torch.data.synthetic import generate_dataset
    n_ep, ep_len, size, seed, jpgs, mv, task, drift = args
    kw = dict(n_episodes=n_ep, episode_len=ep_len, img_size=size, seed=seed,
              save_jpgs=jpgs, multi_view=mv, task=task,
              background_drift=drift)
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    assert generate_dataset(str(tmp_path / "port"), **kw) == \
        str(tmp_path / "port")
    jax_generate(str(tmp_path / "jax"), **kw)
    port, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == sorted(want)
    assert ("frames_2.npy" in port) == mv
    assert any(k.endswith(".jpg") for k in port) == jpgs
    for name, data in want.items():
        assert port[name] == data, name


def test_generate_dataset_refuses_an_unknown_task(tmp_path):
    from srl_zoo_tpu_torch.data.synthetic import generate_dataset
    with pytest.raises(ValueError, match="Unknown synthetic task"):
        generate_dataset(str(tmp_path / "ds"), task="walk")


# ---------------------------------------------------------------------------
# --profile and its summary
# ---------------------------------------------------------------------------

def _train(data_folder, run, *extra):
    from srl_zoo_tpu_torch.train import main
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return main(["--data-folder", data_folder, "--losses",
                     "autoencoder", "--state-dim", "4", "-bs", "16",
                     "--epochs", "1", "--log-folder", run, "--device",
                     "cpu", *extra])
    finally:
        torch.set_num_threads(n)


def test_profile_writes_a_trace_that_the_summary_reads(synthetic_dataset,
                                                        tmp_path, capsys):
    """``--profile --device cpu`` writes a torch.profiler trace of the
    epoch into ``<log>/profile``; the summary sums CPU self time (a trace
    without CUDA activity), its table is non-empty with rows that sum to
    at most 100%, the convolutions among them, and the CLI prints it."""
    from srl_zoo_tpu_torch.utils import profiling
    run = _train(synthetic_dataset.data_folder, str(tmp_path / "run"),
                 "--profile")
    traces = os.listdir(os.path.join(run, "profile"))
    assert traces == ["epoch_0.pt.trace.json"]
    basis, rows = profiling.summarize_profile_dir(
        os.path.join(run, "profile"), top=1000)
    assert basis == profiling.CPU_SELF_TIME
    assert rows and all(r.ms >= 0 and r.calls > 0 for r in rows)
    assert sum(r.pct for r in rows) <= 100.0 + 1e-6
    assert any("convolution" in r.name for r in rows)
    capsys.readouterr()
    printed = profiling.main(["--log-folder", run, "--top", "5"])
    out = capsys.readouterr().out
    assert len(printed) == 5 and "% CPU self time" in out
    # the top-5 table, then the profiled training's srl. spans by host time
    table, span_table = out.split("\n\n")
    assert table.count("\n") == 5
    names = [line.split()[-1] for line in span_table.splitlines()[1:]]
    assert "% of longest span" in span_table
    assert {"srl.learn.stack", "srl.runner.load",
            "srl.learn.metrics"} <= set(names)
    assert all(n.startswith("srl.") for n in names)


def test_summary_of_a_device_trace(tmp_path):
    """A trace with CUDA activity is summed by device time (kernels,
    copies, memsets) with each kernel's share of it, whatever the CPU
    did; a FLOP count is shown where an event carries one, else n/a. A
    CPU-only trace sums each operator's self time: its time less its
    children's."""
    from srl_zoo_tpu_torch.utils import profiling
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "pid": 1,
         "tid": 1, "ts": 0.0, "dur": 10.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::convolution", "pid": 1,
         "tid": 1, "ts": 1.0, "dur": 4.0, "args": {"flops": 2e9}},
        {"ph": "X", "cat": "kernel", "name": "relu_max_pool_fwd_vec",
         "ts": 2.0, "dur": 3.0},
        {"ph": "X", "cat": "kernel", "name": "relu_max_pool_fwd_vec",
         "ts": 6.0, "dur": 3.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 9.0,
         "dur": 2.0},
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 2.0},
    ]
    path = tmp_path / "profile" / "a.pt.trace.json"
    path.parent.mkdir()
    path.write_text(json.dumps({"traceEvents": ev}))
    basis, rows = profiling.summarize_profile_dir(str(path.parent))
    assert basis == profiling.DEVICE_TIME
    assert [(r.name, r.calls) for r in rows] == [
        ("relu_max_pool_fwd_vec", 2), ("Memcpy HtoD", 1)]
    assert rows[0].pct == pytest.approx(75.0) and rows[0].flops is None
    path.write_text(json.dumps({"traceEvents": ev[:2]}))
    basis, rows = profiling.summarize_trace(str(path))
    assert basis == profiling.CPU_SELF_TIME
    got = {r.name: (r.ms, r.flops) for r in rows}
    assert got == {"aten::conv2d": (pytest.approx(0.006), None),
                   "aten::convolution": (pytest.approx(0.004), 2e9)}
    assert "2.000" in profiling.format_table(basis, rows)


def test_summary_of_a_device_trace_by_host_time(tmp_path):
    """``basis=CPU_SELF_TIME`` sums a CUDA trace's operators by CPU self
    time, as a CPU-only trace is summed, and leaves its kernels out."""
    from srl_zoo_tpu_torch.utils import profiling
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1,
         "tid": 1, "ts": 0.0, "dur": 8.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "pid": 1,
         "tid": 1, "ts": 1.0, "dur": 2.0},
        {"ph": "X", "cat": "kernel", "name": "add_kernel", "ts": 9.0,
         "dur": 30.0},
    ]
    path = tmp_path / "a.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    basis, rows = profiling.summarize_trace(
        str(path), basis=profiling.CPU_SELF_TIME)
    assert basis == profiling.CPU_SELF_TIME
    assert {r.name: r.ms for r in rows} == {
        "aten::add": pytest.approx(0.006), "aten::empty": pytest.approx(0.002)}
    basis, rows = profiling.summarize_trace(str(path))
    assert basis == profiling.DEVICE_TIME
    assert [r.name for r in rows] == ["add_kernel"]


def test_summary_of_a_folder_without_a_trace_raises(tmp_path):
    from srl_zoo_tpu_torch.utils import profiling
    (tmp_path / "profile").mkdir()
    with pytest.raises(FileNotFoundError, match="--profile"):
        profiling.summarize_profile_dir(str(tmp_path / "profile"))
    with pytest.raises(FileNotFoundError):
        profiling.main(["--log-folder", str(tmp_path)])


# ---------------------------------------------------------------------------
# the doctor
# ---------------------------------------------------------------------------

def _open_store_kind(dataset, batch_size):
    """The kind of store ``open_store`` opens with ``--device-cache
    auto`` at the current budget."""
    from srl_zoo_tpu_torch.config import SRLConfig
    from srl_zoo_tpu_torch.data.device_cache import open_store
    cfg = SRLConfig(img_height=32, img_width=32, batch_size=batch_size)
    store, hot = open_store(dataset, cfg, torch.device("cpu"))
    if store is None:
        return "streaming"
    return "hybrid store" if hot is not None else "whole store"


@pytest.mark.parametrize("budget_rows", [None, 40.5, 20.5])
def test_doctor_names_the_mode_open_store_opens(synthetic_dataset,
                                                monkeypatch, capsys,
                                                budget_rows):
    """rc 0 on the synthetic dataset, with the host copy measured; the
    mode it reports is the one ``open_store`` opens at that budget: the
    whole store (no budget), a hybrid store of 40 rows, streaming (20
    rows, fewer than two batches of 16)."""
    from srl_zoo_tpu_torch.utils import doctor
    if budget_rows is not None:
        monkeypatch.setenv("SRL_ZOO_CACHE_BUDGET_MB",
                           str(budget_rows * 32 * 32 * 3 / 2**20))
    rc = doctor.main(["--data-folder", synthetic_dataset.data_folder,
                      "--img-size", "32", "-bs", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "device: cpu" in out and "MB/s" in out and "dataset: 96" in out
    mode = out.split("mode: ")[1].split(" (")[0].split(" of ")[0]
    assert mode == _open_store_kind(synthetic_dataset, 16)
    assert mode == {None: "whole store", 40.5: "hybrid store",
                    20.5: "streaming"}[budget_rows]
    if budget_rows == 40.5:
        assert "hybrid store of 40/96 rows" in out


def test_doctor_diagnoses_a_hung_transfer(monkeypatch, capsys):
    """A bandwidth probe that never returns is cut at the bound: the
    doctor prints the diagnosis and exits with code 2."""
    from srl_zoo_tpu_torch.utils import doctor
    release = threading.Event()
    monkeypatch.setattr(doctor, "measure_link_bandwidth",
                        lambda device: release.wait(60))
    monkeypatch.setattr(doctor, "LINK_TIMEOUT_S", 0.2)
    try:
        rc = doctor.main(["--device", "cpu"])
    finally:
        release.set()
    out = capsys.readouterr().out
    assert rc == 2
    assert "MEASUREMENT HUNG" in out and "diagnosis" in out


def test_run_bounded_returns_and_raises():
    from srl_zoo_tpu_torch.utils.doctor import run_bounded
    assert run_bounded(lambda: 7, 5.0, "x") == 7
    with pytest.raises(KeyError):
        run_bounded(lambda: {}["k"], 5.0, "x")
