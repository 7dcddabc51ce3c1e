"""Runs of a cell on the CPU at a size a test can hold: the harness's
whole run but its look for a CUDA device (the kernels' plain versions
stand in for them)."""

from __future__ import annotations

import copy
import time

import torch

from portbench.harness import core

# the tests' cut: frames and dataset, never a width (each configuration
# keeps its state width and its loss splits)
TINY = {"img_height": 32, "img_width": 32, "n_frames": 384,
        "episode_len": 96}
# cells whose harness is here and tested, in BENCHMARK.json's form, that
# BENCHMARK.json does not hold yet (PERF.md, Open questions)
PLANNED = [{"name": "cnn_ae.dp4_sharded", "config": "cnn_ae_224",
            "traffic": "dp4_sharded", "chips": 4}]


def workloads(manifest):
    """BENCHMARK.json's cells and the planned ones."""
    return manifest["workloads"] + PLANNED


def tiny_cell(name: str, seed: int = 7, seconds: float = 0.5,
              trace: bool = False, traffic: str = None,
              **config) -> core.Cell:
    """The cell ``name`` of BENCHMARK.json or ``PLANNED`` cut to ``TINY``
    (and ``config``'s further keys), on the CPU, and its traffic cut as its
    kind cuts it (``tiny`` of ``harness/<kind>_cell.py``); with
    ``traffic``, under that traffic mix (``traffic/<traffic>.json``)
    instead of its own."""
    manifest = core.load_manifest()
    entry = core.find(workloads(manifest), name, "workload")
    cfg = copy.deepcopy(core.load_config(manifest, entry["config"]))
    cfg.update(TINY, **config)
    traffic = core.load_traffic(traffic or entry["traffic"])
    cell = core.Cell(name=name, config=cfg, traffic=traffic,
                     arch=core.load_arch(cfg["arch"]), seed=seed,
                     seconds=seconds, trace=trace,
                     device=torch.device("cpu"), t0=time.perf_counter(),
                     chips=entry["chips"])
    core.load_kind(traffic["kind"]).tiny(cell)
    return cell


def run_tiny(name: str, **kw):
    """(outcome, result line) of a tiny CPU run of cell ``name``."""
    cell = tiny_cell(name, **kw)
    out = core.run_cell(cell)
    return out, core.result_line(core.load_manifest(), cell, out)
