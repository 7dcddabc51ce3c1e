"""Ground-truth correlation (port of ``srl_zoo_tpu/evaluation/gtc.py``).

The Pearson correlation matrix between learned state dims and ground-truth
dims; the GTC score is the mean over ground-truth dims of the largest
|corr| across learned dims. numpy, float64, on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def correlation_matrix(learned_states: np.ndarray,
                       ground_truth_states: np.ndarray) -> np.ndarray:
    """(D_learned, D_gt) Pearson correlation matrix; a constant dim has
    correlation 0."""
    s = np.asarray(learned_states, np.float64)
    g = np.asarray(ground_truth_states, np.float64)
    s = s - s.mean(axis=0)
    g = g - g.mean(axis=0)
    s_std = s.std(axis=0)
    g_std = g.std(axis=0)
    s_std[s_std == 0] = 1.0
    g_std[g_std == 0] = 1.0
    return (s.T @ g) / (len(s) * np.outer(s_std, g_std))


def ground_truth_correlation(learned_states: np.ndarray,
                             ground_truth_states: np.ndarray
                             ) -> Tuple[float, np.ndarray]:
    """(gtc score, correlation matrix)."""
    corr = correlation_matrix(learned_states, ground_truth_states)
    return float(np.mean(np.max(np.abs(corr), axis=0))), corr
