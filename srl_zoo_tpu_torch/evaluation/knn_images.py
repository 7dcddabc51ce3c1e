"""KNN-MSE evaluation CLI (port of ``srl_zoo_tpu/evaluation/knn_images.py``).

Loads a run's ``states_rewards.npz`` and its dataset's ground truth, scores
KNN-MSE (neighbours in the learned space, squared error in the ground
truth's; the fused distance + top-k kernel on the GPU), writes
``knn_mse.json`` and the neighbour image grids
``NearestNeighbors/knn_grid_<g>.png``.

    python -m srl_zoo_tpu_torch.evaluation.knn_images \\
        --log-folder logs/<run> [--data-folder data/<ds>] [-k 5] \\
        [--n-samples 100] [--device cpu]

It runs on CUDA unless ``--device cpu`` is given; without a GPU it raises.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from srl_zoo_tpu_torch.data.schema import load_dataset
from srl_zoo_tpu_torch.evaluation.knn import knn_mse, save_neighbor_grids
from srl_zoo_tpu_torch.utils.device import resolve_device
from srl_zoo_tpu_torch.utils.misc import printGreen


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description="KNN-MSE evaluation")
    p.add_argument("--log-folder", type=str, required=True)
    p.add_argument("--data-folder", type=str, default="",
                   help="Defaults to the data folder in exp_config.json")
    p.add_argument("-k", "--n-neighbors", type=int, default=5)
    p.add_argument("--n-samples", type=int, default=-1,
                   help="Number of query samples (-1 = all)")
    p.add_argument("--n-grids", type=int, default=5,
                   help="Neighbour image grids to save (0 = none)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # no GPU: raise before any write

    states = np.load(os.path.join(args.log_folder,
                                  "states_rewards.npz"))["states"]
    data_folder = args.data_folder
    if not data_folder:
        with open(os.path.join(args.log_folder, "exp_config.json")) as f:
            data_folder = json.load(f)["data-folder"]
    dataset = load_dataset(data_folder)
    if len(dataset.ground_truth_states) != len(states):
        raise ValueError(
            f"{len(states)} exported states vs "
            f"{len(dataset.ground_truth_states)} ground-truth entries")

    n_samples = None if args.n_samples <= 0 else args.n_samples
    score, queries, neighbors = knn_mse(
        states, dataset.ground_truth_states, k=args.n_neighbors,
        n_samples=n_samples, seed=args.seed, device=device)
    printGreen(f"KNN-MSE: {score:.6f}")
    with open(os.path.join(args.log_folder, "knn_mse.json"), "w") as f:
        json.dump({"knn_mse": score, "k": args.n_neighbors}, f)
    if args.n_grids > 0:
        save_neighbor_grids(data_folder, dataset.images_path, queries,
                            neighbors,
                            os.path.join(args.log_folder, "NearestNeighbors"),
                            n_grids=args.n_grids)
    return score


if __name__ == "__main__":
    main()
