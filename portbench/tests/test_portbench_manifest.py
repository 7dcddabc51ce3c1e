"""BENCHMARK.json against the benchmark's schema and limits, and the lookup by
name of every configuration, traffic mix, reference and metric reader."""

import json
import re

import pytest

from portbench.harness import core
from portbench.tests.helpers import workloads

MANIFEST = core.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
LAYER_METRICS = [m["name"] for m in MANIFEST["per_layer"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert (core.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_run_length_fits_24_cells():
    """A full check of 24 cells (2 + 14 runs a cell, each allowed
    run_seconds + 60 s, 180 s a cell to compile, 1200 s spare) fits in
    12 hours."""
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_unique_and_well_formed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), group
    metrics = [m["name"] for m in MANIFEST["end_to_end"]
               + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_configs():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = set()
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        cfg = core.load_config(MANIFEST, c["name"])
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg and key in cfg["reduced"]
            assert not key.endswith(("_dim", "_rank"))
        assert set(cfg["reduced"]) == set(c["reduced"])


def test_workloads():
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    # at most a quarter of the cells (rounded down) ask for four chips,
    # and one always may
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert m["moves"] in [x["name"] for x in
                                  core.e2e_metrics(MANIFEST, cell)]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])


def test_every_cell_reports_enough():
    for cell in CELLS:
        names = [m["name"] for m in core.e2e_metrics(MANIFEST, cell)]
        assert "setup_s" in names and len(names) >= 2
        assert core.layer_metrics(MANIFEST, cell)


@pytest.mark.parametrize("cell", [w["name"] for w in workloads(MANIFEST)])
def test_cell_finds_its_files_by_name(cell):
    """A cell, or a planned one, needs only its own configuration,
    traffic mix, reference and readers, each found by its name."""
    w = core.find(workloads(MANIFEST), cell, "workload")
    cfg = core.load_config(MANIFEST, w["config"])
    traffic = core.load_traffic(w["traffic"])
    kind = core.load_kind(traffic["kind"])
    for fn in ("run", "readings", "tiny"):
        assert callable(getattr(kind, fn)), fn
    assert kind.FAULTS and all(callable(f) for f in kind.FAULTS.values())
    arch = core.load_arch(cfg["arch"])
    assert arch.param_spec(cfg)
    assert kind.LIMITS in cfg["limits"]
    for m in core.layer_metrics(MANIFEST, cell):
        assert callable(core.load_reader(m["name"]))


@pytest.mark.parametrize("metric", LAYER_METRICS)
def test_reader_finds_nothing_in_nothing(metric):
    """A reader with nothing to read returns nothing (never a 0)."""
    class Empty:
        pass
    assert core.load_reader(metric)(Empty()) is None


def test_manifest_is_plain_json():
    json.loads((core.ROOT / "BENCHMARK.json").read_text())
