"""End-to-end pipeline: check the dataset, train a grid of experiments,
evaluate each (port of the JAX package's root ``pipeline.py``).

Each cell of the grid (loss group x state dim x model type x seed) is
trained by the train CLI into its own run folder
``logs/<dataset>/<timestamp>_<model>_<losses>_d<dim>_s<seed>``, then scored
in process: KNN-MSE with its neighbour image grids (``knn_images``), the
reward probe (``predict_reward``) and the GTC the train CLI wrote. The
report ``logs/<dataset>/pipeline_report.json`` is rewritten after every
cell; a cell of several seeds reports each metric's mean and std.

    python -m srl_zoo_tpu_torch.pipeline --data-folder data/<ds> \\
        --losses autoencoder --losses vae priors --state-dims 8 32 \\
        --model-types custom_cnn [--seeds 1 2] [--device cpu]
    python -m srl_zoo_tpu_torch.pipeline --exp-config grid.json

It runs on CUDA unless ``--device cpu`` is given (passed on to the train
CLI and ``knn_images``); without a GPU it raises before it writes
anything. A folder of recorded ``record_*`` episodes is preprocessed
first, and a missing or stale ``frames.npy`` (at ``--img-size``) is
rebuilt (``check_dataset``).
"""

from __future__ import annotations

import argparse
import datetime
import itertools
import json
import os

import numpy as np

from srl_zoo_tpu_torch.utils.device import resolve_device
from srl_zoo_tpu_torch.utils.misc import (parseDataFolder, printGreen,
                                          printRed, printYellow)

def check_dataset(data_folder: str, img_size: int,
                  multi_view: bool = False) -> None:
    """Make the dataset folder trainable at ``img_size``: preprocess its
    ``record_*`` episodes where ``preprocessed_data.npz`` is missing, and
    (re)build each frames cache that is missing or stale (view 2's too
    where the dataset records a second camera or ``multi_view``). A cache
    that cannot be built (no recorded images) is reported and left out:
    training then streams what it can."""
    from srl_zoo_tpu_torch.preprocessing.preprocess import (
        preprocess_folder, refresh_frames_caches)
    if not os.path.isdir(data_folder):
        raise FileNotFoundError(
            f"Dataset folder {data_folder} not found — record or download a "
            "dataset first")
    if not os.path.exists(os.path.join(data_folder, "preprocessed_data.npz")):
        printYellow("preprocessed_data.npz missing: running preprocessing")
        preprocess_folder(data_folder)
    try:
        refresh_frames_caches(data_folder, img_size, multi_view)
    except Exception as e:  # a dataset without its images keeps working
        printYellow(f"frames cache not built: {e}")


def _cell_log_folder(dataset_name: str, model_type: str, losses,
                     state_dim: int, seed: int) -> str:
    """A run folder per cell that no other cell shares: the cell's
    coordinates are in its name, and a numeric suffix separates two cells
    of the same second (a timestamp alone has 1 s resolution)."""
    ts = datetime.datetime.now().strftime("%y-%m-%d_%Hh%M_%S")
    base = os.path.join(
        "logs", dataset_name,
        f"{ts}_{model_type}_{'_'.join(losses)}_d{state_dim}_s{seed}")
    folder, k = base, 1
    while os.path.exists(folder):
        k += 1
        folder = f"{base}_{k}"
    return folder


def run_experiment(data_folder: str, losses, state_dim: int, model_type: str,
                   args, seed: int) -> dict:
    """One grid cell: train, then KNN-MSE and the reward probe, in
    process."""
    from srl_zoo_tpu_torch import train as train_cli
    from srl_zoo_tpu_torch.evaluation import knn_images, predict_reward

    dataset_name = os.path.basename(parseDataFolder(data_folder))
    device = ["--device", args.device] if args.device else []
    flags = ["--data-folder", data_folder,
             "--losses", *losses,
             "--state-dim", str(state_dim),
             "--model-type", model_type,
             "--epochs", str(args.epochs),
             "-bs", str(args.batch_size),
             "--seed", str(seed),
             "--val-size", str(args.val_size),
             "--training-set-size", str(args.training_set_size),
             "--log-folder", _cell_log_folder(dataset_name, model_type,
                                              losses, state_dim, seed),
             *device]
    if args.multi_view:
        flags.append("--multi-view")
    if args.dtype != "float32":
        flags += ["--dtype", args.dtype]
    if args.device_cache != "auto":
        flags += ["--device-cache", args.device_cache]
    log_folder = train_cli.main(flags)

    knn = knn_images.main(["--log-folder", log_folder,
                           "--n-grids", "0" if args.no_grids else "3",
                           *device])
    acc = predict_reward.main(["--log-folder", log_folder])
    with open(os.path.join(log_folder, "gtc.txt")) as f:
        gtc = float(f.read().strip())
    ips = 0.0
    with open(os.path.join(log_folder, "metrics.jsonl")) as f:
        for line in f:
            ips = max(ips, json.loads(line).get("images_per_sec", 0.0))
    return {"log_folder": log_folder, "losses": list(losses),
            "state_dim": state_dim, "model_type": model_type, "seed": seed,
            "knn_mse": knn, "gtc": gtc, "reward_accuracy": acc,
            "images_per_sec": round(ips, 1)}


def _normalize_loss_groups(groups):
    """An exp-config's ``losses`` as a list of loss groups (lists of
    names). Accepted spellings:

      [["autoencoder"], ["vae", "priors"]]   canonical
      ["autoencoder", "vae priors"]          strings: one group each,
                                             whitespace-split
      "autoencoder"                          one group of one

    Anything else exits before any training."""
    if isinstance(groups, str):
        groups = [groups]
    if not isinstance(groups, list) or not groups:
        raise SystemExit(f"exp-config: 'losses' must be a non-empty list of "
                         f"loss groups, got {groups!r}")
    out = []
    for g in groups:
        if isinstance(g, str):
            g = g.split()
        if not (isinstance(g, list) and g
                and all(isinstance(x, str) for x in g)):
            raise SystemExit(f"exp-config: each 'losses' entry must be a "
                             f"loss-group list or string, got {g!r}")
        out.append(g)
    return out


def _coerce_grid_value(action, value):
    """One exp-config JSON value as the argparse type of its option, so a
    bad grid fails when the config loads: "50" becomes 50, a scalar where
    a list is expected becomes a list of one, and a non-numeric value or
    an unknown choice raises ValueError naming the problem."""
    if action is None:
        return value
    if isinstance(action, (argparse._StoreTrueAction,
                           argparse._StoreFalseAction,
                           argparse.BooleanOptionalAction)):
        if isinstance(value, bool):
            return value
        if value in (0, 1):
            return bool(value)
        raise ValueError(f"expected true/false, got {value!r}")
    typ = action.type or str

    def one(v):
        if typ is int and isinstance(v, float) and v != int(v):
            raise ValueError(f"expected an integer, got {v!r}")
        out = v if (typ is str and isinstance(v, str)) else typ(v)
        if action.choices is not None and out not in action.choices:
            raise ValueError(f"{out!r} not one of {sorted(action.choices)}")
        return out

    if action.nargs in ("+", "*"):
        seq = value if isinstance(value, (list, tuple)) else [value]
        return [one(v) for v in seq]
    return one(value)


def aggregate_seeds(per_seed: list) -> dict:
    """One grid cell over its seeds: each metric's mean and std."""
    agg = dict(per_seed[0])
    agg.pop("seed", None)
    agg["seeds"] = [r["seed"] for r in per_seed]
    agg["log_folders"] = [r["log_folder"] for r in per_seed]
    agg.pop("log_folder", None)
    for key in ("knn_mse", "gtc", "reward_accuracy", "images_per_sec"):
        vals = np.asarray([r[key] for r in per_seed], float)
        agg[key] = float(vals.mean())
        agg[f"{key}_std"] = float(vals.std())
    return agg


def main(argv=None):
    p = argparse.ArgumentParser(description="SRL experiment pipeline "
                                            "(PyTorch + CUDA port)")
    p.add_argument("--data-folder", type=str, default="")
    p.add_argument("--losses", nargs="+", action="append", default=None,
                   help="One experiment per --losses group, e.g. "
                        "--losses autoencoder --losses vae priors")
    p.add_argument("--state-dims", nargs="+", type=int, default=[8])
    p.add_argument("--model-types", nargs="+", type=str,
                   default=["custom_cnn"])
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("-bs", "--batch-size", type=int, default=32)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seeds", nargs="+", type=int, default=None,
                   help="Run each experiment with several seeds and report "
                        "mean and std (overrides --seed)")
    p.add_argument("--val-size", type=float, default=0.2)
    p.add_argument("--training-set-size", type=int, default=-1)
    p.add_argument("--multi-view", action="store_true")
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--device-cache", type=str, default="auto",
                   choices=["auto", "on", "off", "hybrid", "sharded"])
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--no-grids", action="store_true",
                   help="Skip neighbour image grids")
    p.add_argument("--exp-config", type=str, default="",
                   help="JSON grid config (overrides the flags above)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the train CLI and knn_images "
                        "(default cuda)")
    args = p.parse_args(argv)

    if args.exp_config:
        with open(args.exp_config) as f:
            grid = json.load(f)
        # every flag is a JSON key (dash or underscore spelling)
        known = {name.replace("_", "-"): name for name in vars(args)}
        by_dest = {a.dest: a for a in p._actions}
        loss_groups = _normalize_loss_groups(grid.pop("losses",
                                                      [["autoencoder"]]))
        for key, value in grid.items():
            name = known.get(key) or known.get(key.replace("_", "-"))
            if name is None:
                printYellow(f"exp-config: unknown key {key!r} ignored "
                            f"(known: {sorted(known)})")
                continue
            try:
                value = _coerce_grid_value(by_dest.get(name), value)
            except (TypeError, ValueError) as e:
                printRed(f"exp-config: bad value for key {key!r}: {e}")
                raise SystemExit(1)
            setattr(args, name, value)
    else:
        loss_groups = args.losses or [["autoencoder"]]

    if not args.data_folder:
        printRed("--data-folder (or --exp-config with data-folder) required")
        raise SystemExit(1)
    resolve_device(args.device)  # no GPU: raise before any write

    dataset_name = os.path.basename(parseDataFolder(args.data_folder))
    data_folder = args.data_folder if os.path.isdir(args.data_folder) \
        else os.path.join("data", dataset_name)
    check_dataset(data_folder, args.img_size, args.multi_view)

    seeds = args.seeds or [args.seed]
    report_dir = os.path.join("logs", dataset_name)
    os.makedirs(report_dir, exist_ok=True)
    report_path = os.path.join(report_dir, "pipeline_report.json")
    results = []
    for losses, state_dim, model_type in itertools.product(
            loss_groups, args.state_dims, args.model_types):
        printGreen(f"\n=== Experiment: {model_type} dim={state_dim} "
                   f"losses={losses} seeds={seeds} ===")
        per_seed = [run_experiment(data_folder, losses, state_dim,
                                   model_type, args, seed)
                    for seed in seeds]
        results.append(aggregate_seeds(per_seed) if len(per_seed) > 1
                       else per_seed[0])
        # after every cell: a crash in a later cell keeps the finished ones
        with open(report_path, "w") as f:
            json.dump(results, f, indent=2)
    printGreen("\n=== Pipeline summary (KNN-MSE lower is better) ===")
    for r in sorted(results, key=lambda r: r["knn_mse"]):
        printGreen(f"  {r['model_type']:>10} dim={r['state_dim']:<4} "
                   f"{'+'.join(r['losses']):<30} knn={r['knn_mse']:.5f} "
                   f"gtc={r['gtc']:.3f} rew_acc={r['reward_accuracy']:.3f}")
    printGreen(f"Report: {report_path}")
    return results


if __name__ == "__main__":
    main()
