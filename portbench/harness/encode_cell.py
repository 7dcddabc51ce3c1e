"""The encode cells: one RL loop in closed loop around the port's
``StateEncoder.encode``, the hand-off that downstream RL calls at every
env step (the port's ``inference.py``).

Set-up makes the weights from the seed, writes them as a run folder of
the port (``exp_config.json``, ``srl_model.pth``) and loads it with
``StateEncoder.load``, as an RL user does; it makes a pool of uint8
observations in host memory and, from the seed, the whole schedule: each
call's observations (``batch`` consecutive frames of the pool, one step
of a vectorised env) and the env's think time after it (uniform over
``think_ms``). It warms the encoder at the window's batch. The window then
calls, waits for the states, "steps the env" for the think time (the
host busy, as in a physics step) and repeats, until ``--seconds`` have passed; a call's latency runs from the
call to the returned states.

With ``--trace 1`` the profiler records the calls
``trace_calls[0]``..``trace_calls[1] - 1``; the latencies the readers
take are the other calls'.

Once the window has closed, a sample of the window's calls drawn from the
seed is encoded by the plain reference, from the same weights and
observations, and each returned state row is held to it
(harness/check.py ``state_gap``).

As a kind (core.py): the limits are the configuration's
``limits.encode``; the planted faults are one returned state element
altered and half of a call's states left out; a reading for
``calibrate.py`` is a run of ``--encode-seconds``.
"""

from __future__ import annotations

import contextlib
import gc
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.harness import check, core, data
from portbench.harness import trace as tracing
from portbench.harness.core import Cell, Outcome, stage
from portbench.harness.train_cell import load_weights, srl_config

REFERENCE_CHUNK = 256  # frames a reference forward
LIMITS = "encode"
# the tests' cut of the traffic: a small pool and few calls
TINY = {"pool_frames": 64, "warm_calls": 2, "trace_calls": [3, 6],
        "check_calls": 8, "schedule": 2000, "think_ms": [0.0, 0.1]}


@dataclass
class EncodeReadings:
    """What the per-layer readers of an encode cell read."""
    config: Dict
    arch: object
    batch: int
    latencies_s: List[float]          # the calls outside the traced ones
    traced_call_s: List[float] = field(default_factory=list)
    traced_s: float = 0.0
    trace: Optional[tracing.Trace] = None


def schedule(traffic: Dict, seed: int, pool: int):
    """(pool offsets, think seconds) of ``traffic["schedule"]`` calls."""
    rng = np.random.default_rng(seed % data.TORCH_SEED_MOD)
    n = traffic["schedule"]
    offsets = rng.integers(0, pool - traffic["batch"] + 1, n)
    lo, hi = traffic["think_ms"]
    return offsets, rng.uniform(lo, hi, n) / 1e3


def run(cell: Cell) -> Outcome:
    from srl_zoo_tpu_torch import checkpoint as ckpt
    from srl_zoo_tpu_torch.inference import StateEncoder
    from srl_zoo_tpu_torch.models.srl_modules import SRLModules
    from portbench.reference.common import strict_float32
    c, t = cell.config, cell.traffic
    batch = t["batch"]
    folder = tempfile.mkdtemp(prefix="portbench_run_")
    try:
        cfg = srl_config(cell, folder)
        shape = (c["img_height"], c["img_width"], c["channels"])
        pool = data.make_frames(t["pool_frames"], shape, cell.seed,
                                cell.device, salt=1)
        weights = data.make_weights(cell.arch.param_spec(c), cell.seed,
                                    cell.device)
        model = SRLModules(cfg)
        load_weights(model, {k: v.cpu() for k, v in weights.items()})
        ckpt.save_srl_model(folder, model)
        del model
        stage(cell, "weights made and written")
        encoder = StateEncoder.load(folder, max_batch=t["max_batch"],
                                    device=cell.device)
        stage(cell, "encoder loaded")
        offsets, thinks = schedule(t, cell.seed, len(pool))
        for i in range(t["warm_calls"]):
            encoder.encode(pool[offsets[i]:offsets[i] + batch])
        lo, hi = t["trace_calls"] if cell.trace else (-1, -1)
        prof, prof_t0, traced_s, collected = None, 0.0, 0.0, None
        latencies, states = [], []
        start = time.perf_counter()
        i = 0
        while True:
            if i == lo:
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU]
                if cell.device.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
                prof.start()
                prof_t0 = time.perf_counter()
            o = offsets[i % len(offsets)]
            a = time.perf_counter()
            states.append(encoder.encode(pool[o:o + batch]))
            b = time.perf_counter()
            latencies.append(b - a)
            i += 1
            if i == hi:
                prof.stop()
                traced_s = time.perf_counter() - prof_t0
                collected = tracing.collect(prof)
                prof = None
            if b - start >= cell.seconds and (hi < 0 or i >= hi):
                break
            # the env's step is CPU work (a physics step), not a sleep
            deadline = b + thinks[(i - 1) % len(thinks)]
            while time.perf_counter() < deadline:
                pass
        peak = torch.cuda.max_memory_allocated(cell.device) \
            if cell.device.type == "cuda" else 0
        del encoder
        gc.collect()
        if cell.device.type == "cuda":
            torch.cuda.empty_cache()
        # the reference, after the window and with the program freed
        strict_float32()
        rng = np.random.default_rng((cell.seed + 1) % data.TORCH_SEED_MOD)
        sample = rng.choice(len(states), min(t["check_calls"], len(states)),
                            replace=False)
        frames = np.concatenate([pool[offsets[j % len(offsets)]:
                                      offsets[j % len(offsets)] + batch]
                                 for j in sample])
        got = torch.from_numpy(np.concatenate([states[j] for j in sample]))
        ref = torch.cat([cell.arch.encode_frames(
            weights, torch.from_numpy(frames[k:k + REFERENCE_CHUNK]).to(
                cell.device), c).cpu()
            for k in range(0, len(frames), REFERENCE_CHUNK)])
        numbers = {"state_gap": check.state_gap(got, ref)}
        traced = set(range(lo, hi)) if cell.trace else set()
        readings = EncodeReadings(
            config=c, arch=cell.arch, batch=batch,
            latencies_s=[x for k, x in enumerate(latencies)
                         if k not in traced],
            traced_call_s=[latencies[k] for k in sorted(traced)],
            traced_s=traced_s, trace=collected)
        e2e = {"setup_s": start - cell.t0,
               "encode_p95_ms": float(np.percentile(latencies, 95)) * 1e3}
        return Outcome(e2e=e2e, readings=readings,
                       checks=check.judge(numbers, c["limits"][LIMITS]),
                       attempted=len(latencies), failed=0,
                       memory_peak_bytes=peak, trace=collected,
                       traced_s=traced_s)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


# ---- the kind's faults, readings and test size ------------------------------
@contextlib.contextmanager
def encode_fault(kind: str):
    """``altered``: one element of each call's states changed by 1;
    ``half_answer``: the second half of each call's states zeroed."""
    from srl_zoo_tpu_torch.inference import StateEncoder
    orig = StateEncoder.encode

    def encode(self, obs):
        s = orig(self, obs).copy()
        if kind == "altered":
            s[0, 0] += 1.0
        else:
            s[len(s) // 2:] = 0.0
        return s
    StateEncoder.encode = encode
    try:
        yield
    finally:
        StateEncoder.encode = orig


FAULTS = {"altered": lambda: encode_fault("altered"),
          "half_answer": lambda: encode_fault("half_answer")}


def reading(cell: Cell) -> Dict[str, float]:
    """The compared numbers of a run of the cell."""
    return {k: c["value"] for k, c in run(cell).checks.items()}


def readings(items):
    return core.planted_readings(reading, FAULTS, items)


def tiny(cell: Cell) -> None:
    cell.traffic.update(TINY)
