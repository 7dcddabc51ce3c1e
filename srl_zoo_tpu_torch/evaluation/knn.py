"""KNN-MSE, the zoo's headline quality metric (port of
``srl_zoo_tpu/evaluation/knn.py`` ``knn_mse``).

For each (sampled) query, take its k nearest neighbours in the LEARNED
state space and average the squared error between their ground-truth
states and the query's. Low = the learned space keeps ground-truth
neighbourhoods. The neighbour search is the fused distance + top-k kernel
(ops/knn_topk.py); the reference set sharded over several GPUs waits for
the multi-GPU slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from srl_zoo_tpu_torch.ops.knn_topk import knn_topk
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
    idx = knn_topk(refs.index_select(0, q_all), refs, k + 1).cpu().numpy()
    score, neighbor_idx = score_neighbors(idx, queries, gt, k)
    return score, queries, neighbor_idx

