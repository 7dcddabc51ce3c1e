"""The readings that the limits of ``correct`` are set from, on the chip
at a cell's own size (the benchmark's runs do not run this):

* ``sound``: the program as the configuration states it, one reading a
  seed;
* ``control``: the program's own lower-precision path
  (``compute_dtype="bfloat16"``) against the float32 reference;
* each fault that the cell's kind plants (``FAULTS`` of
  ``harness/<kind>_cell.py``: for training a half batch and an unchanged
  state; for encoding an altered element and half an answer left out;
  for data parallelism those of training and one rank's gradient left
  out of the average).

The kind's ``readings`` takes the readings: a training reading drives
set-up's probe (the validation pass and three train steps) and the
reference, with no window; an encode reading runs the cell for
``--encode-seconds``; the data-parallel kind takes every reading in one
process group.

    python3 portbench/calibrate.py --workload cnn_ae.resident \\
        --seeds 12 --control-seeds 3 --fault-seeds 3

Each reading is one JSON line on standard output (and in ``--out``).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEED0 = 3_000_000_000


def main(argv=None):
    import torch
    from portbench.harness import core
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--encode-seconds", type=float, default=3.0)
    p.add_argument("--seed0", type=int, default=SEED0)
    p.add_argument("--out", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="rehearse on the CPU at the tests' tiny size")
    args = p.parse_args(argv)
    if args.cpu:
        from portbench.tests.helpers import tiny_cell

        def make(seed, **cfg):
            return tiny_cell(args.workload, seed=seed,
                             seconds=args.encode_seconds, **cfg)
    else:
        manifest = core.load_manifest()
        entry = core.find(manifest["workloads"], args.workload, "workload")

        def make(seed, **cfg):
            config = dict(core.load_config(manifest, entry["config"]), **cfg)
            return core.Cell(
                name=args.workload, config=config,
                traffic=core.load_traffic(entry["traffic"]),
                arch=core.load_arch(config["arch"]), seed=seed,
                seconds=args.encode_seconds, trace=False,
                device=torch.device("cuda", 0), t0=time.perf_counter(),
                chips=entry["chips"])
    kind = core.load_kind(make(0).traffic["kind"])
    plan = [("sound", i, None, {}) for i in range(args.seeds)]
    plan += [("control", i, None, {"compute_dtype": "bfloat16"})
             for i in range(args.control_seeds)]
    plan += [(name, i, name, {}) for name in sorted(kind.FAULTS)
             for i in range(args.fault_seeds)]
    items = [(make(args.seed0 + 7919 * i, **cfg), fault)
             for _, i, fault, cfg in plan]
    out = open(args.out, "a") if args.out else None
    try:
        t = time.perf_counter()
        for (mode, _, _, _), (cell, _), nums in zip(
                plan, items, kind.readings(items)):
            line = json.dumps({"workload": args.workload, "mode": mode,
                               "seed": cell.seed, "numbers": nums,
                               "s": time.perf_counter() - t})
            t = time.perf_counter()
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()


if __name__ == "__main__":
    main()
