"""The readings that the limits of ``correct`` are set from, on the chip
at a cell's own size (the benchmark's runs do not run this):

* ``sound``: the program as the configuration states it, one reading a
  seed;
* ``control``: the program's own lower-precision path
  (``compute_dtype="bfloat16"``) against the float32 reference;
* ``half_batch`` (training): half of each batch left out of the loss, the
  mean taken over the rest (planted under the train step's inputs);
* ``altered`` and ``half_answer`` (encoding): one returned state element
  altered, or the second half of a call's states left out.

A training reading drives set-up's probe (the validation pass and three
train steps) and the reference, with no window; an encode reading runs the cell for ``--encode-seconds``.

    python3 portbench/calibrate.py --workload cnn_ae.resident \\
        --seeds 12 --control-seeds 3 --fault-seeds 3

Each reading is one JSON line on standard output (and in ``--out``).
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEED0 = 3_000_000_000


@contextlib.contextmanager
def half_batch():
    """Half of every train and eval batch's rows left out of the loss."""
    import torch
    from srl_zoo_tpu_torch.training import train_step as ts
    orig = ts._draws

    def draws(model, images, tensors, valid, generator, corruption):
        keep = torch.ones_like(valid)
        keep[valid.shape[0] // 2:] = 0
        return orig(model, images, tensors, valid * keep, generator,
                    corruption)
    ts._draws = draws
    try:
        yield
    finally:
        ts._draws = orig


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


def train_reading(cell):
    import shutil
    import tempfile
    from portbench.harness import train_cell
    folder = tempfile.mkdtemp(prefix="portbench_calib_")
    try:
        cfg, dataset, weights, learner = train_cell.setup(cell, folder)
        got = train_cell.probe(learner, dataset, cfg)
        del learner
        train_cell.free(cell.device)
        return train_cell.numbers(cell, dataset, weights, got)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def encode_reading(cell):
    from portbench.harness import encode_cell
    out = encode_cell.run(cell)
    return {k: c["value"] for k, c in out.checks.items()}


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
                device=torch.device("cuda", 0), t0=time.perf_counter())
    kind = make(0).traffic["kind"]
    reading = train_reading if kind == "train" else encode_reading
    faults = {"train": {"half_batch": half_batch},
              "encode": {"altered": lambda: encode_fault("altered"),
                         "half_answer": lambda: encode_fault("half_answer")}
              }[kind]
    plan = [("sound", i, contextlib.nullcontext, {})
            for i in range(args.seeds)]
    plan += [("control", i, contextlib.nullcontext,
              {"compute_dtype": "bfloat16"})
             for i in range(args.control_seeds)]
    plan += [(name, i, fault, {}) for name, fault in faults.items()
             for i in range(args.fault_seeds)]
    out = open(args.out, "a") if args.out else None
    try:
        for mode, i, ctx, cfg in plan:
            seed = args.seed0 + 7919 * i
            t = time.perf_counter()
            with ctx():
                nums = reading(make(seed, **cfg))
            line = json.dumps({"workload": args.workload, "mode": mode,
                               "seed": seed, "numbers": nums,
                               "s": time.perf_counter() - t})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()


if __name__ == "__main__":
    main()
