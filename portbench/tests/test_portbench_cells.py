"""Whole runs of every cell on the CPU at a size a test can hold: the
harness's run but its look for a CUDA device. A sound run is correct and
reports its metrics; the control (the program's bfloat16 path) and each
fault that a cell's kind plants (``FAULTS`` of ``harness/<kind>_cell.py``)
make ``correct`` come out false. Every test here asks the cell's kind
module, so a kind added as a file is run by them unedited."""

import pytest

from portbench.harness import core, train_cell
from portbench.tests.helpers import run_tiny, workloads

MANIFEST = core.load_manifest()
CELLS = [w["name"] for w in workloads(MANIFEST)]


def kind_of(cell: str):
    """The module of the cell's traffic kind."""
    entry = core.find(workloads(MANIFEST), cell, "workload")
    return core.load_kind(core.load_traffic(entry["traffic"])["kind"])


TRAIN = [c for c in CELLS if kind_of(c) is train_cell]
FAULT_CASES = [(c, f) for c in CELLS for f in sorted(kind_of(c).FAULTS)]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, trace):
    out, res = run_tiny(cell, trace=trace)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    names = [m["name"] for m in (core.layer_metrics(MANIFEST, cell) if trace
                                 else core.e2e_metrics(MANIFEST, cell))]
    if not trace:
        assert list(res["metrics"]) == names
        assert all(m["value"] > 0 for m in res["metrics"].values())
    else:
        # the CPU has no device trace: only host readings are there
        assert set(res["metrics"]) <= set(names)
        assert "breakdown" in res


@pytest.mark.parametrize("cell", TRAIN)
def test_streamed_traffic_runs_from_its_file_alone(cell):
    """A traffic mix added as a file alone (``traffic/streamed.json``:
    no store on the device) runs a training cell through the streamed
    per-step path, correct, and its half batch fault is caught there
    too."""
    out, res = run_tiny(cell, traffic="streamed")
    assert res["correct"], res["checks"]
    assert out.readings.counts["loop_steps"] > 0
    assert out.readings.counts["replays"] == 0
    assert out.readings.counts["eager_steps"] == 0
    with train_cell.half_batch():
        _, res = run_tiny(cell, traffic="streamed")
    assert not res["correct"], res["checks"]


def test_a_new_kind_is_found_by_its_name(monkeypatch):
    """A traffic kind is the module ``harness/<kind>_cell.py``: adding
    one edits no file of the harness."""
    import sys
    import types
    seen = []
    module = types.ModuleType("portbench.harness.echo_cell")
    module.run = seen.append
    monkeypatch.setitem(sys.modules, "portbench.harness.echo_cell", module)
    cell = core.Cell(name="x", config={}, traffic={"kind": "echo"},
                     arch=None, seed=1, seconds=1.0, trace=False,
                     device=None, t0=0.0)
    core.run_cell(cell)
    assert seen == [cell]


@pytest.mark.parametrize("cell,fault", FAULT_CASES)
def test_fault_is_not_correct(cell, fault):
    with kind_of(cell).FAULTS[fault]():
        _, res = run_tiny(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The program's own lower-precision path in the program's place."""
    _, res = run_tiny(cell, compute_dtype="bfloat16")
    assert not res["correct"], res["checks"]


def test_seed_gives_the_same_inputs():
    import torch
    from portbench.harness import data
    dev = torch.device("cpu")
    cfg = dict(core.load_config(MANIFEST, "cnn_ae_224"), n_frames=64,
               img_height=32, img_width=32)
    a = data.make_dataset(cfg, 2 ** 31 + 5, dev)
    b = data.make_dataset(cfg, 2 ** 31 + 5, dev)
    c = data.make_dataset(cfg, 2 ** 31 + 6, dev)
    assert (a.frames == b.frames).all() and (a.actions == b.actions).all()
    assert not (a.frames == c.frames).all()
    assert data.program_seed(2 ** 31 + 5) == 5


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell, cuda):
    """The control at the cell's own size on the card, three seeds:
    every reading fails a limit."""
    import time
    import torch
    from portbench import calibrate
    from portbench.harness import check
    entry = core.find(workloads(MANIFEST), cell, "workload")
    if torch.cuda.device_count() < entry["chips"]:
        pytest.skip(f"needs {entry['chips']} CUDA devices")
    config = dict(core.load_config(MANIFEST, entry["config"]),
                  compute_dtype="bfloat16")
    traffic = core.load_traffic(entry["traffic"])
    kind = kind_of(cell)
    cells = [core.Cell(name=cell, config=config, traffic=traffic,
                       arch=core.load_arch(config["arch"]),
                       seed=calibrate.SEED0 + 104729 * i, seconds=3.0,
                       trace=False, device=cuda, t0=time.perf_counter(),
                       chips=entry["chips"]) for i in range(3)]
    limits = dict(config["limits"][kind.LIMITS])
    for numbers in kind.readings([(c, None) for c in cells]):
        assert not check.passed(check.judge(numbers, limits)), numbers
