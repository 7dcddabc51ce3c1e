"""A traffic kind is a file of its own, ``harness/<kind>_cell.py``, that
names its faults, its readings for ``calibrate.py``, its key in a
configuration's ``limits`` and its cut to the tests' size: a stub kind
added as a file, with a cell, a traffic mix and one fault of its own, is
run by the generic cell tests and by ``calibrate.py``, none of them
edited."""

import json
import os
import shutil
import subprocess
import sys

from portbench.harness import core

STUB = '''"""A stub kind: a run reads one number, 0, or 1 where its fault is
planted or the configuration leaves float32."""

import contextlib

from portbench.harness import check, core
from portbench.harness.trace import Trace

LIMITS = "stub"
_fault = [False]


@contextlib.contextmanager
def off_by_one():
    _fault[0] = True
    try:
        yield
    finally:
        _fault[0] = False


FAULTS = {"off_by_one": off_by_one}


def tiny(cell):
    cell.traffic["cut"] = True


def reading(cell):
    gap = float(_fault[0] or cell.config["compute_dtype"] != "float32"
                or not cell.traffic.get("cut"))
    return {"stub_gap": gap}


def readings(items):
    return core.planted_readings(reading, FAULTS, items)


def run(cell):
    return core.Outcome(
        e2e={"setup_s": 1.0}, readings=None,
        checks=check.judge(reading(cell), cell.config["limits"][LIMITS]),
        attempted=1, failed=0, memory_peak_bytes=0,
        trace=Trace() if cell.trace else None, traced_s=1.0)
'''


def _checkout_with_a_stub(tmp_path):
    """A copy of the benchmark (BENCHMARK.json and portbench/) with the
    stub kind, its traffic mix, its limit and its cell added as files and
    entries."""
    root = tmp_path / "checkout"
    shutil.copytree(core.BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "portbench" / "harness" / "stub_cell.py").write_text(STUB)
    (root / "portbench" / "traffic" / "stub.json").write_text(
        json.dumps({"kind": "stub"}))
    manifest = core.load_manifest()
    manifest["workloads"].append(
        {"name": "stub.cell", "config": "cnn_ae_224", "traffic": "stub",
         "chips": 1, "why": "a stub kind"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    entry = core.find(manifest["configs"], "cnn_ae_224", "configuration")
    config = core.load_config(manifest, "cnn_ae_224")
    config["limits"]["stub"] = {"stub_gap": 0.5}
    (root / entry["file"]).write_text(json.dumps(config))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), str(core.ROOT)]))
    return root, env


def test_a_kind_added_as_a_file_runs_in_the_generic_tests(tmp_path):
    root, env = _checkout_with_a_stub(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p",
         "no:cacheprovider", "-k", "stub",
         "portbench/tests/test_portbench_cells.py"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    passed = [line for line in out.stdout.splitlines()
              if line.startswith("PASSED")]
    for test in ("test_sound_run_is_correct[stub.cell-False]",
                 "test_sound_run_is_correct[stub.cell-True]",
                 "test_control_is_not_correct[stub.cell]",
                 "test_fault_is_not_correct[stub.cell-off_by_one]"):
        assert any(line.endswith(test) for line in passed), out.stdout


def test_calibrate_takes_the_readings_of_a_kind_added_as_a_file(tmp_path):
    root, env = _checkout_with_a_stub(tmp_path)
    out = subprocess.run(
        [sys.executable, "portbench/calibrate.py", "--workload", "stub.cell",
         "--cpu", "--seeds", "2", "--control-seeds", "1", "--fault-seeds",
         "1"], cwd=root, env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(x) for x in out.stdout.splitlines()]
    assert [(x["mode"], x["numbers"]["stub_gap"]) for x in lines] == [
        ("sound", 0.0), ("sound", 0.0), ("control", 1.0),
        ("off_by_one", 1.0)]
