"""One run of one cell: the manifest (``BENCHMARK.json``), the lookups by
name, the run, and the result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own that this module finds by the name
``BENCHMARK.json`` gives:

* ``portbench/configs/<config>.json``: the sizes as run, and the limits
  of the numbers that decide ``correct`` (the configuration entry's
  ``file`` names it);
* ``portbench/traffic/<traffic>.json``: a traffic mix's parameters; its
  ``kind`` names the module that runs it, ``harness/<kind>_cell.py``
  (``train_cell.py``, ``encode_cell.py``, ``dp_cell.py``), which holds
  everything of the kind (portbench/README.md, "A kind"): ``run(cell)``,
  its planted faults (``FAULTS``), its readings for ``calibrate.py``
  (``readings``), its key in a configuration's ``limits`` (``LIMITS``)
  and its cut to the tests' size (``tiny``);
* ``portbench/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(readings) -> float | None``;
* ``portbench/reference/<arch>.py``: the plain reference of the
  configuration's ``arch``.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"


# ---- the manifest and the lookups -------------------------------------------
def load_manifest(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(manifest: Dict, name: str, root: Path = ROOT) -> Dict:
    entry = find(manifest["configs"], name, "configuration")
    with open(root / entry["file"]) as f:
        return json.load(f)


def load_traffic(name: str, bench: Path = BENCH) -> Dict:
    with open(bench / "traffic" / f"{name}.json") as f:
        return json.load(f)


def load_kind(kind: str):
    """The module that runs a traffic mix of ``kind``:
    ``harness/<kind>_cell.py``, with ``run(cell) -> Outcome``."""
    return importlib.import_module(f"portbench.harness.{kind}_cell")


def planted_readings(reading, faults: Dict, items):
    """``reading(cell)`` of each ``(cell, fault)`` item, in this process,
    with the fault (a name of ``faults``, or None) planted around it: the
    ``readings`` of a kind whose run is one process."""
    for cell, fault in items:
        with faults[fault]() if fault else contextlib.nullcontext():
            yield reading(cell)


def load_arch(arch: str):
    return importlib.import_module(f"portbench.reference.{arch}")


def load_reader(metric: str, bench: Path = BENCH):
    """The ``read`` function of ``metrics/<metric>.py`` (a metric's name
    may hold dots, so the file is loaded by its path)."""
    path = bench / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def e2e_metrics(manifest: Dict, cell: str) -> List[Dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in manifest["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def layer_metrics(manifest: Dict, cell: str) -> List[Dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric it reports."""
    moves = {m["name"] for m in e2e_metrics(manifest, cell)}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moves)]


# ---- a run -------------------------------------------------------------------
@dataclass
class Cell:
    """What a kind's module runs: one cell at one seed."""
    name: str
    config: Dict
    traffic: Dict
    arch: object
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float  # the host clock at process start
    chips: int = 1


@dataclass
class Outcome:
    """What a run measured and checked."""
    e2e: Dict[str, float]
    readings: object
    checks: Dict[str, Dict[str, float]]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: object = None       # harness.trace.Trace of the traced part
    traced_s: float = 0.0      # its length on the host clock
    # a run of several processes: the per-layer metrics, read where the
    # program ran, and the name of its devices
    layer_values: Optional[Dict[str, float]] = None
    device_kind: Optional[str] = None


def stage(cell: Cell, what: str) -> None:
    """A set-up stage's end on the host clock since process start, on
    standard error."""
    print(f"portbench: {what} at {time.perf_counter() - cell.t0:.3f} s",
          file=sys.stderr, flush=True)


def run_cell(cell: Cell) -> Outcome:
    return load_kind(cell.traffic["kind"]).run(cell)


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def result_line(manifest: Dict, cell: Cell, out: Outcome) -> Dict:
    """The result object: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with a trace ``breakdown``, and last the
    compared numbers beside their limits."""
    import torch
    from portbench.harness import check
    metrics = {}
    if not cell.trace:
        for m in e2e_metrics(manifest, cell.name):
            metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                  "unit": m["unit"]}
    else:
        values = out.layer_values
        for m in layer_metrics(manifest, cell.name):
            v = load_reader(m["name"])(out.readings) if values is None \
                else values.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    cuda = cell.device.type == "cuda"
    kind = out.device_kind or (torch.cuda.get_device_name(cell.device)
                               if cuda else "cpu")
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind,
              "count": cell.chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    res = {"correct": check.passed(out.checks),
           "attempted": out.attempted, "failed": out.failed,
           "metrics": metrics, "device": device}
    if cell.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s()
        device["window_s"] = out.traced_s
        res["breakdown"] = out.trace.breakdown()
    res["checks"] = {k: {"value": _finite(c["value"]),
                         "limit": _finite(c["limit"])}
                     for k, c in out.checks.items()}
    return res


def card_line() -> Optional[str]:
    """nvidia-smi's name and power limit of the card (None without it)."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="One run of one cell of the "
                                "srl_zoo_tpu_torch benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse_args(argv)
    manifest = load_manifest()
    entry = find(manifest["workloads"], args.workload, "workload")
    config = load_config(manifest, entry["config"])
    traffic = load_traffic(entry["traffic"])
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from portbench.harness import check, guard
    cell = Cell(name=args.workload, config=config, traffic=traffic,
                arch=load_arch(config["arch"]), seed=args.seed,
                seconds=args.seconds, trace=bool(args.trace),
                device=torch.device("cuda", 0), t0=t0,
                chips=entry["chips"])
    out = run_cell(cell)
    res = result_line(manifest, cell, out)
    found = guard.loaded_forbidden()
    if found:
        print(f"portbench: the run loaded forbidden modules: {found}",
              file=sys.stderr)
        return 3
    card = card_line()
    if card:
        print(f"card: {card}", file=sys.stderr)
    check.print_checks(out.checks)
    sys.stdout.flush()
    print(json.dumps(res), flush=True)
    return 0
