"""The data-parallel training cells: ``SRL4robotics.learn`` in a process
group of ``ranks`` processes, one a device, as the port's ``train.py``
runs it with ``--num-processes`` (parallel/mesh.py). Every rank draws the
same global batch of ``rows_per_rank`` x ``ranks`` rows and computes its
block of it, BatchNorm takes the global batch's statistics and the
optimizer averages the gradients over the ranks. The frame store is the
traffic's ``device_cache`` (``sharded``: each rank holds a block of the
rows, and a batch's rows are gathered by a reduce-scatter).

The process that ``run.py`` starts is the launcher, which runs none of
the program. It starts the ranks (``python -m
portbench.harness.dp_cell``, each seeing its own device alone) and waits
for them under a deadline: ``SETUP_LIMIT_S`` from the launch until rank 0
opens the window, then the window's seconds and ``AFTER_S``. Where a rank
exits with an error or the group passes its deadline, the launcher kills
every rank, waits for each and fails with the reason.

Each rank runs the training cell's run (train_cell.py ``measure``) on its
device: the same inputs from the seed, the learner, its probe (the
validation pass and three train steps through the group's own store,
feed and call), then ``learn``'s epochs. Rank 0 decides at each epoch's
end whether the window closes, and every rank follows (``GroupWindow``).
``train_images_per_s`` counts the global batch's rows; ``setup_s`` runs
from the launcher's start to the window's start on rank 0 (the host's
monotonic clock, which every process reads alike). With ``--trace 1``
every rank profiles the window's first epoch and ``busy_s`` is their
mean; rank 0 reads the per-layer metrics in its own process, where the
port's span registry and collective counts are, and gives the
breakdown. The peak memory is the largest rank's, counted from the end
of set-up's input making (each rank draws every frame on its device once
before it keeps its block).

After the window every rank frees its learner and leaves the group; rank
0 then runs the plain reference on its device over the probe's global
batches: global BatchNorm and averaged gradients make the group's step
the single process's step.

As a kind (core.py): the limits are the configuration's ``limits.dp``;
the planted faults are the training kind's two and one rank's gradient
left out of the average, each planted in every rank; the readings for
``calibrate.py`` are all taken in one process group, each set-up's probe
against the reference with no window.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import torch

from portbench.harness import core, guard, train_cell
from portbench.harness.core import Cell, Outcome

LIMITS = "dp"
# the launcher's deadlines: from the launch until rank 0 opens the window;
# after the window's seconds, for its last epoch and the reference; for
# each calibration reading
SETUP_LIMIT_S = 200
AFTER_S = 100
READING_LIMIT_S = 120
# the tests' cut of the traffic: two ranks of 16 rows
TINY = {"ranks": 2, "rows_per_rank": 16}
# the plant that the ranks started next get (a name of RANK_PLANTS)
_planted: List[Optional[str]] = [None]


@contextlib.contextmanager
def planted(name: str):
    """Every rank that the launcher starts inside this block plants
    ``name`` (``RANK_PLANTS``) around its run."""
    _planted[0] = name
    try:
        yield
    finally:
        _planted[0] = None


@contextlib.contextmanager
def rank_left_out(rank: int, world: int):
    """One rank's gradient left out of the average: the last rank adds
    zeros to the sum that every rank divides by the world size."""
    from srl_zoo_tpu_torch.parallel import mesh
    orig = mesh.average_gradients

    def average(params):
        params = list(params)
        if rank == world - 1:
            for p in params:
                if p.grad is not None:
                    p.grad.zero_()
        orig(params)
    mesh.average_gradients = average
    try:
        yield
    finally:
        mesh.average_gradients = orig


@contextlib.contextmanager
def _hang(rank: int, world: int):
    """The last rank never reaches the group's first collective."""
    if rank == world - 1:
        time.sleep(10 ** 6)
    yield


@contextlib.contextmanager
def _die(rank: int, world: int):
    """The last rank exits with an error before the first collective."""
    if rank == world - 1:
        os._exit(1)
    yield


RANK_PLANTS = {
    "half_batch": lambda rank, world: train_cell.half_batch(),
    "unchanged_state": lambda rank, world: train_cell.unchanged_state(),
    "rank_left_out": rank_left_out,
    "hang": _hang, "die": _die}
FAULTS = {name: (lambda name=name: planted(name))
          for name in ("half_batch", "unchanged_state", "rank_left_out")}


def tiny(cell: Cell) -> None:
    cell.traffic.update(TINY)
    cell.chips = TINY["ranks"]


# ---- the launcher ------------------------------------------------------------
@dataclass
class _Traced:
    """The traced epoch as the result line reads it: the ranks' mean
    busy seconds and rank 0's breakdown."""
    busy: float
    summary: Dict

    def busy_s(self) -> float:
        return self.busy

    def breakdown(self) -> Dict:
        return self.summary


def run(cell: Cell) -> Outcome:
    results, _ = _launch(cell, "run", [(cell, _planted[0])])
    first = results[0]
    traced = None
    if cell.trace:
        busy = [r["busy_s"] for r in results]
        traced = _Traced(sum(busy) / len(busy), first["breakdown"])
    return Outcome(e2e=first["e2e"], readings=None, checks=first["checks"],
                   attempted=first["attempted"], failed=first["failed"],
                   memory_peak_bytes=max(r["peak"] for r in results),
                   trace=traced, traced_s=first["traced_s"],
                   layer_values=first["layer_values"],
                   device_kind=first["device_kind"])


def readings(items):
    """The compared numbers of each ``(cell, fault)`` item, all taken in
    one process group (the items share the first one's traffic)."""
    items = list(items)
    _, numbers = _launch(items[0][0], "readings", items)
    return numbers


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _terminated(signum, frame):
    raise SystemExit(128 + signum)


def _launch(cell: Cell, mode: str, items):
    """Each rank's result and, in ``readings`` mode, rank 0's numbers of
    each item: the ranks started, waited for under the deadline, and
    ended."""
    t = cell.traffic
    world = t["ranks"]
    work = Path(tempfile.mkdtemp(prefix="portbench_dp_"))
    spec = {"mode": mode, "name": cell.name, "traffic": t,
            "seconds": cell.seconds, "trace": cell.trace, "t0": cell.t0,
            "device": cell.device.type, "port": _free_port(),
            # the launcher's compute threads, shared out over the ranks
            "threads": torch.get_num_threads() // world,
            "work": str(work),
            "items": [{"seed": c.seed, "config": c.config, "plant": p}
                      for c, p in items]}
    (work / "spec.json").write_text(json.dumps(spec))
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    devices = visible.split(",") if visible else \
        [str(i) for i in range(world)]
    main = threading.current_thread() is threading.main_thread()
    old = signal.signal(signal.SIGTERM, _terminated) if main else None
    procs: List[subprocess.Popen] = []
    try:
        for r in range(world):
            env = dict(os.environ)
            if cell.device.type == "cuda":
                env["CUDA_VISIBLE_DEVICES"] = devices[r]
            # a rank's standard output goes to standard error: the
            # launcher's last line of standard output is the result
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "portbench.harness.dp_cell",
                 "--spec", str(work / "spec.json"), "--rank", str(r)],
                cwd=str(core.ROOT), env=env, stdout=2,
                start_new_session=True))
        _wait(procs, work, cell, mode, len(items))
        results = [json.loads((work / f"rank{r}.json").read_text())
                   for r in range(world)]
        numbers = None
        if mode == "readings":
            lines = (work / "readings.jsonl").read_text().splitlines()
            numbers = [json.loads(x)["numbers"] for x in lines]
    finally:
        _stop(procs)
        if main:
            signal.signal(signal.SIGTERM, old)
        shutil.rmtree(work, ignore_errors=True)
    found = sorted({n for res in results for n in res["forbidden"]})
    if found:
        raise RuntimeError(f"a rank loaded forbidden modules: {found}")
    return results, numbers


def _wait(procs, work: Path, cell: Cell, mode: str, n_items: int) -> None:
    """Until every rank has exited with code 0; raises where one exits
    otherwise or the group passes its deadline."""
    deadline = time.perf_counter() + SETUP_LIMIT_S
    if mode == "readings":
        deadline += n_items * READING_LIMIT_S
    opened = False
    while True:
        codes = [p.poll() for p in procs]
        for r, code in enumerate(codes):
            if code not in (None, 0):
                raise RuntimeError(f"rank {r} of {len(procs)} exited with "
                                   f"code {code}: every rank is ended")
        if all(code == 0 for code in codes):
            return
        now = time.perf_counter()
        if mode == "run" and not opened and (work / "opened").exists():
            opened = True
            deadline = now + cell.seconds + AFTER_S
        if now > deadline:
            what = ("the readings" if mode == "readings" else
                    "the window and the reference" if opened else
                    "set-up (the window never opened)")
            raise RuntimeError(f"the group passed its deadline in {what}: "
                               f"a rank hangs or is too slow; every rank "
                               f"is killed")
        time.sleep(0.1)


def _stop(procs) -> None:
    """Every rank still running killed, with what it started, and each
    waited for."""
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


# ---- a rank ------------------------------------------------------------------
class GroupWindow(train_cell.Window):
    """The training window of a rank: rank 0 decides at each epoch's end
    whether it closes, and every rank follows (a broadcast from rank 0);
    rank 0 marks the window's opening for the launcher (``opened``). The
    counts add the collectives the port issued (``mesh.counts``)."""

    def __init__(self, *args, opened: Optional[Path] = None):
        super().__init__(*args)
        self.opened = opened

    @staticmethod
    def counts(learner) -> Dict[str, int]:
        from srl_zoo_tpu_torch.parallel import mesh
        return dict(train_cell.Window.counts(learner),
                    **{f"collective.{k}": n for k, n in mesh.counts.items()})

    def __call__(self, learner, epoch, train_metrics, val_metrics):
        opening = self.start is None
        super().__call__(learner, epoch, train_metrics, val_metrics)
        if opening and self.opened is not None:
            self.opened.touch()

    def _closes(self, now: float) -> bool:
        import torch.distributed as dist
        flag = torch.tensor([float(super()._closes(now))],
                            device=self.device)
        dist.broadcast(flag, 0)
        return bool(flag.item())


def _cell(spec: Dict, item: Dict, device, world: int) -> Cell:
    t = spec["traffic"]
    config = dict(item["config"], batch_size=t["rows_per_rank"] * world)
    return Cell(name=spec["name"], config=config, traffic=t,
                arch=core.load_arch(config["arch"]), seed=item["seed"],
                seconds=spec["seconds"], trace=spec["trace"], device=device,
                t0=spec["t0"], chips=world)


def _plant(item: Dict, rank: int, world: int):
    name = item["plant"]
    return RANK_PLANTS[name](rank, world) if name else \
        contextlib.nullcontext()


def _rank_run(spec: Dict, rank: int, world: int, device) -> Dict:
    """A rank's run of the cell: rank 0 returns the result's numbers,
    every rank its peak memory and busy seconds."""
    import torch.distributed as dist
    from srl_zoo_tpu_torch.parallel import mesh
    work = Path(spec["work"])
    item = spec["items"][0]
    cell = _cell(spec, item, device, world)
    first = rank == 0
    window = GroupWindow(cell.seconds, device, cell.trace, cell.t0,
                         opened=work / "opened" if first else None)

    def settled():
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

    def freed():
        dist.barrier()
        mesh.shutdown()
    with _plant(item, rank, world):
        out = train_cell.measure(cell, str(work / "log"), window,
                                 ranks=world, settled=settled, freed=freed,
                                 judged=first)
    res = {"peak": out.memory_peak_bytes, "traced_s": out.traced_s,
           "busy_s": out.trace.busy_s() if out.trace is not None else 0.0}
    if first:
        values = None
        if cell.trace:
            manifest = core.load_manifest()
            values = {}
            for m in core.layer_metrics(manifest, cell.name):
                v = core.load_reader(m["name"])(out.readings)
                if v is not None:
                    values[m["name"]] = v
        res.update(
            e2e=out.e2e, checks=out.checks, attempted=out.attempted,
            failed=out.failed, layer_values=values,
            breakdown=out.trace.breakdown() if out.trace is not None
            else None,
            device_kind=torch.cuda.get_device_name(device)
            if device.type == "cuda" else "cpu")
    return res


def _rank_readings(spec: Dict, rank: int, world: int, device) -> Dict:
    """A rank's readings of every item: set-up and the probe on every
    rank, the reference on rank 0 while the others wait."""
    import torch.distributed as dist
    from srl_zoo_tpu_torch.parallel import mesh
    work = Path(spec["work"])
    for k, item in enumerate(spec["items"]):
        cell = _cell(spec, item, device, world)
        with _plant(item, rank, world):
            cfg, dataset, weights, learner = train_cell.setup(
                cell, str(work / f"log{k}"))
            got = train_cell.probe(learner, dataset, cfg)
            del learner
            train_cell.free(device)
            if rank == 0:
                numbers = train_cell.numbers(cell, dataset, weights, got)
                with open(work / "readings.jsonl", "a") as f:
                    f.write(json.dumps({"item": k, "numbers": numbers})
                            + "\n")
                print(f"portbench: reading {k + 1} of "
                      f"{len(spec['items'])}: {numbers}", file=sys.stderr,
                      flush=True)
        dist.barrier()
    mesh.shutdown()
    return {}


def rank_main(argv=None) -> None:
    p = argparse.ArgumentParser(description="One rank of a data-parallel "
                                "cell (started by its launcher)")
    p.add_argument("--spec", required=True)
    p.add_argument("--rank", type=int, required=True)
    args = p.parse_args(argv)
    spec = json.loads(Path(args.spec).read_text())
    world = spec["traffic"]["ranks"]
    # each rank on a block of the host's cores of its own, which its
    # compute threads fill: a rank's spinning threads then take no core
    # that another rank's launching thread needs
    cores = sorted(os.sched_getaffinity(0))
    block = len(cores) // world
    if block:
        os.sched_setaffinity(0, cores[args.rank * block:
                                      (args.rank + 1) * block])
    torch.set_num_threads(max(1, min(block, spec["threads"])))
    # each rank sees its own device alone (CUDA_VISIBLE_DEVICES)
    device = torch.device("cuda", 0) if spec["device"] == "cuda" \
        else torch.device("cpu")
    from srl_zoo_tpu_torch.parallel import mesh
    mesh.initialize_distributed(f"localhost:{spec['port']}", world,
                                args.rank, device)
    rank_run = _rank_run if spec["mode"] == "run" else _rank_readings
    res = rank_run(spec, args.rank, world, device)
    res["forbidden"] = guard.loaded_forbidden()
    path = Path(spec["work"]) / f"rank{args.rank}.json"
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(res))
    tmp.rename(path)


if __name__ == "__main__":
    rank_main()
