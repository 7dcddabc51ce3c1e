"""KNN-MSE, the zoo's headline quality metric, and its neighbour image
grids (port of ``srl_zoo_tpu/evaluation/knn.py`` ``knn_mse`` and
``save_neighbor_grids``).

For each (sampled) query, take its k nearest neighbours in the LEARNED
state space and average the squared error between their ground-truth
states and the query's. Low = the learned space keeps ground-truth
neighbourhoods. The neighbour search is the fused distance + top-k kernel
(ops/knn_topk.py); in a process group of more than one rank the
reference set is split over the ranks (``knn_topk_sharded``), as JAX's
single-host multi-chip route splits it over its mesh.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from srl_zoo_tpu_torch.ops.knn_topk import knn_topk_sharded
from srl_zoo_tpu_torch.utils.device import resolve_device, use_strict_float32


def score_neighbors(idx: np.ndarray, queries: np.ndarray, gt: np.ndarray,
                    k: int) -> Tuple[float, np.ndarray]:
    """Drop each query's self match from its k+1 nearest indices (else the
    (k+1)-th) and score: (knn_mse, neighbor indices (Q, k))."""
    keep = idx != queries[:, None]
    order = np.argsort(~keep, axis=1, kind="stable")  # kept cols first,
    neighbor_idx = np.take_along_axis(idx, order[:, :k], axis=1)  # dist order
    gt_q = gt[queries][:, None, :]          # (Q, 1, d)
    gt_n = gt[neighbor_idx]                 # (Q, k, d)
    return float(np.mean(np.square(gt_q - gt_n))), neighbor_idx


def centre(states: torch.Tensor) -> torch.Tensor:
    """States minus their mean. The kernel's distances are |q|^2 + |r|^2 -
    2 q.r; centring moves no distance but keeps the norms near the
    distances, so states far from the origin do not lose their neighbour
    order to float32 cancellation."""
    return states - states.mean(0, dtype=torch.float64).to(states.dtype)


def sample_queries(n: int, n_samples: Optional[int], seed: int) -> np.ndarray:
    if n_samples is not None and n_samples < n:
        return np.random.RandomState(seed).choice(n, size=n_samples,
                                                  replace=False)
    return np.arange(n)


def knn_mse(learned_states: np.ndarray, ground_truth_states: np.ndarray,
            k: int = 5, n_samples: Optional[int] = None, seed: int = 0,
            device=None) -> Tuple[float, np.ndarray, np.ndarray]:
    """Returns (knn_mse, query_indices, neighbor_indices (Q, k)).

    ``n_samples`` limits the number of queries (None = every point), drawn
    with ``np.random.RandomState(seed)`` as the JAX package draws them.
    On a GPU the kernel takes k + 1 <= 64 (``knn_topk.MAX_K``); the CPU
    path takes any k."""
    device = resolve_device(device)
    use_strict_float32()
    learned = np.asarray(learned_states, np.float32)
    gt = np.asarray(ground_truth_states, np.float32)
    n = len(learned)
    if n < 2:
        raise ValueError("knn_mse needs at least 2 samples")
    k = min(k, n - 1)  # tiny datasets: at most n-1 non-self neighbours
    queries = sample_queries(n, n_samples, seed)
    refs = centre(torch.from_numpy(learned).to(device))
    q_all = torch.from_numpy(queries).to(device)
    # one rank (or too few states a rank) takes the plain kernel call
    idx = knn_topk_sharded(refs.index_select(0, q_all), refs,
                           k + 1)[1].cpu().numpy()
    score, neighbor_idx = score_neighbors(idx, queries, gt, k)
    return score, queries, neighbor_idx



def save_neighbor_grids(data_folder: str, images_path: np.ndarray,
                        queries: np.ndarray, neighbor_idx: np.ndarray,
                        out_folder: str, n_grids: int = 5) -> None:
    """``knn_grid_<g>.png`` for the first ``n_grids`` queries: the query's
    recorded image and its k neighbours' (224 x 224, decoded with cv2); an
    image that cannot be read draws "no image"."""
    from srl_zoo_tpu_torch.data.loader import decode_resize
    from srl_zoo_tpu_torch.data.schema import resolve_image_path
    from srl_zoo_tpu_torch.plotting import raster

    os.makedirs(out_folder, exist_ok=True)
    k = neighbor_idx.shape[1]
    for g in range(min(n_grids, len(queries))):
        images = []
        for i in [queries[g]] + list(neighbor_idx[g]):
            path = resolve_image_path(data_folder, str(images_path[i]))
            try:
                images.append(decode_resize(path, (224, 224)))
            except FileNotFoundError:
                images.append(None)
        titles = ["query"] + [f"nn{j + 1}" for j in range(k)]
        raster.save_png(raster.image_grid([images], [titles], 160),
                        os.path.join(out_folder, f"knn_grid_{g}.png"))
