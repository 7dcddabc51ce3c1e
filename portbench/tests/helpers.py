"""Runs of a cell on the CPU at a size a test can hold: the harness's
whole run but its look for a CUDA device (the kernels' plain versions
stand in for them)."""

from __future__ import annotations

import copy
import time

import torch

from portbench.harness import core

TINY = {"img_height": 32, "img_width": 32, "n_frames": 384,
        "episode_len": 96, "state_dim": 16}
TINY_TRAFFIC = {"pool_frames": 64, "warm_calls": 2, "trace_calls": [3, 6],
                "check_calls": 8, "schedule": 2000, "think_ms": [0.0, 0.1]}


def tiny_cell(name: str, seed: int = 7, seconds: float = 0.5,
              trace: bool = False, traffic: str = None,
              **config) -> core.Cell:
    """The cell ``name`` of BENCHMARK.json cut to ``TINY`` (and
    ``config``'s further keys), on the CPU; with ``traffic``, under that
    traffic mix (``traffic/<traffic>.json``) instead of its own."""
    manifest = core.load_manifest()
    entry = core.find(manifest["workloads"], name, "workload")
    cfg = copy.deepcopy(core.load_config(manifest, entry["config"]))
    cfg.update(TINY, **config)
    traffic = core.load_traffic(traffic or entry["traffic"])
    if traffic["kind"] == "encode":
        traffic.update(TINY_TRAFFIC)
    return core.Cell(name=name, config=cfg, traffic=traffic,
                     arch=core.load_arch(cfg["arch"]), seed=seed,
                     seconds=seconds, trace=trace,
                     device=torch.device("cpu"), t0=time.perf_counter())


def run_tiny(name: str, **kw):
    """(outcome, result line) of a tiny CPU run of cell ``name``."""
    cell = tiny_cell(name, **kw)
    out = core.run_cell(cell)
    return out, core.result_line(core.load_manifest(), cell, out)
