"""The data-parallel kind's launcher on the CPU (two gloo ranks): a rank
that hangs or dies ends the run within its deadline, with every rank
ended and waited for; the readings for ``calibrate.py`` are taken in one
process group; a machine with fewer devices than the cell asks for
exits with code 2 and prints no result; the readers of the group's
collectives and NCCL time."""

import subprocess
import time

import pytest
import torch

from portbench.harness import check, core, dp_cell
from portbench.tests.helpers import tiny_cell, workloads

CELL = "cnn_ae.dp4_sharded"
SETUP_LIMIT_S = 20


@pytest.fixture
def started(monkeypatch):
    """The processes the launcher starts."""
    procs = []

    class Recorded(subprocess.Popen):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            procs.append(self)
    monkeypatch.setattr(subprocess, "Popen", Recorded)
    return procs


@pytest.mark.parametrize("plant,reason", [("hang", "deadline"),
                                          ("die", "exited with code 1")])
def test_a_rank_that_hangs_or_dies_ends_the_run(plant, reason, started,
                                                monkeypatch):
    monkeypatch.setattr(dp_cell, "SETUP_LIMIT_S", SETUP_LIMIT_S)
    cell = tiny_cell(CELL)
    t = time.perf_counter()
    with dp_cell.planted(plant), pytest.raises(RuntimeError, match=reason):
        core.run_cell(cell)
    assert time.perf_counter() - t < SETUP_LIMIT_S + 30
    assert len(started) == 2
    assert all(p.returncode is not None for p in started)
    if plant == "hang":
        assert started[1].returncode == -9


def test_readings_are_taken_in_one_group(started):
    """A sound reading and one with a rank's gradient left out, in one
    launch of two ranks."""
    cells = [tiny_cell(CELL, seed=s) for s in (3, 4)]
    sound, fault = dp_cell.readings([(cells[0], None),
                                     (cells[1], "rank_left_out")])
    assert len(started) == 2
    limits = cells[0].config["limits"][dp_cell.LIMITS]
    assert check.passed(check.judge(sound, limits)), sound
    assert not check.passed(check.judge(fault, limits)), fault


def test_fewer_devices_than_the_cell_asks_for_exit_2(monkeypatch, capsys):
    manifest = core.load_manifest()
    manifest["workloads"] = workloads(manifest)
    monkeypatch.setattr(core, "load_manifest", lambda: manifest)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    code = core.main(["--workload", CELL, "--seed", "5", "--seconds", "1"])
    assert code == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs 4 CUDA device(s)" in out.err


def test_the_group_readers_by_hand():
    """``collectives_per_step.dp``: the window's collectives over its
    train steps; ``nccl_share.dp``: the union of NCCL's kernels over the
    traced epoch's wall time; neither reads a run without them."""
    from types import SimpleNamespace
    from portbench.harness.trace import Trace
    r = SimpleNamespace(
        counts={"replays": 0, "loop_steps": 40, "collective.all_reduce": 60,
                "collective.reduce_scatter": 20, "collective.all_gather": 4},
        steps={"train": 10, "eval": 2}, epoch_s=[1.0, 1.0],
        traced_s=1e-3,
        trace=Trace(device=[(0, 100_000, "ncclDevKernel_AllReduce"),
                            (50_000, 150_000, "ncclDevKernel_AllGather"),
                            (200_000, 300_000, "conv")]))
    assert core.load_reader("collectives_per_step.dp")(r) == 84 / 20
    assert core.load_reader("nccl_share.dp")(r) == pytest.approx(15.0)
    plain = SimpleNamespace(counts={"replays": 5}, steps={"train": 10},
                            epoch_s=[1.0], traced_s=1e-3,
                            trace=Trace(device=[(0, 10, "conv")]))
    for metric in ("collectives_per_step.dp", "nccl_share.dp"):
        assert core.load_reader(metric)(plain) is None
        assert core.load_reader(metric)(SimpleNamespace()) is None

