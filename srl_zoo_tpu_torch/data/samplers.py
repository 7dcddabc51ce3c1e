"""Pair samplers of the robotic priors and the episode prior, the
triplet's negatives and the balanced reward sampling (a copy of the six
functions of ``srl_zoo_tpu/data/samplers.py``), host-side in numpy.

Each minibatch row gets one partner index and a 0/1 mask (0: no partner
exists, the pair counts for nothing), a partner and a same-episode label,
or one negative row, drawn from the loader's ``RandomState`` so that both
packages draw the same for a seed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _sample_true_per_row(allowed: np.ndarray, rng: np.random.RandomState
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """One uniformly drawn True column of each row of a (B, B) boolean
    matrix: (choice (B,) int32, mask (B,) float32, 0 for all-False rows).
    One uniform per row picks a rank among the row's True columns."""
    counts = allowed.sum(axis=1)
    ranks = (rng.rand(len(allowed)) * np.maximum(counts, 1)).astype(np.int64)
    choice = np.argmax(np.cumsum(allowed, axis=1) > ranks[:, None], axis=1)
    return choice.astype(np.int32), (counts > 0).astype(np.float32)


def find_same_action_pairs(actions: np.ndarray, rng: np.random.RandomState
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """A partner j != i with the same action, for each row i (the
    proportionality and repeatability priors)."""
    a = np.asarray(actions)
    allowed = a[:, None] == a[None, :]
    np.fill_diagonal(allowed, False)
    return _sample_true_per_row(allowed, rng)


def find_dissimilar_pairs(actions: np.ndarray, reward_classes: np.ndarray,
                          rng: np.random.RandomState
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """A partner j != i with the same action and a different reward class,
    for each row i (the causality prior)."""
    a = np.asarray(actions)
    r = np.asarray(reward_classes)
    allowed = (a[:, None] == a[None, :]) & (r[:, None] != r[None, :])
    np.fill_diagonal(allowed, False)
    return _sample_true_per_row(allowed, rng)


def episode_prior_pairs(episode_ids: np.ndarray, rng: np.random.RandomState
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """A partner j for each row i and the label 1 if the two come from one
    episode, else 0: a coin per row asks for a same-episode partner or
    another episode's, and a row that has none of the kind asked for
    takes the other (reference: episodePriorLoss). Returns (partners (B,)
    int32, labels (B,) float32)."""
    ep = np.asarray(episode_ids)
    b = len(ep)
    same = ep[:, None] == ep[None, :]
    np.fill_diagonal(same, False)
    diff = ep[:, None] != ep[None, :]
    want_same = rng.rand(b) < 0.5
    same_choice, same_ok = _sample_true_per_row(same, rng)
    diff_choice, diff_ok = _sample_true_per_row(diff, rng)
    # a row with neither kind of partner exists only at b == 1
    if b > 1:
        any_choice = np.zeros(b, np.int64)
    else:
        any_choice, _ = _sample_true_per_row(~np.eye(b, dtype=bool), rng)
    use_same = (want_same & (same_ok > 0)) | (diff_ok == 0)
    partners = np.where(use_same & (same_ok > 0), same_choice,
                        np.where(diff_ok > 0, diff_choice, any_choice))
    labels = (ep[partners] == ep).astype(np.float32)
    return partners.astype(np.int32), labels


def triplet_negatives(indices: np.ndarray, episode_ids_all: np.ndarray,
                      pool: np.ndarray, rng: np.random.RandomState,
                      min_gap: int = 10) -> np.ndarray:
    """A negative dataset row for each anchor row, drawn from ``pool``: a
    frame of another episode or at least ``min_gap`` steps away, redrawn up
    to 20 times (the anchor is view 1, the positive view 2 of the same
    frame)."""
    idx = np.asarray(indices)
    pool = np.asarray(pool)
    b = len(idx)
    negs = pool[rng.randint(len(pool), size=b)]
    for _ in range(20):
        bad = ((episode_ids_all[negs] == episode_ids_all[idx])
               & (np.abs(negs.astype(np.int64) - idx.astype(np.int64))
                  < min_gap))
        if not bad.any():
            break
        resample = pool[rng.randint(len(pool), size=int(bad.sum()))]
        negs = negs.copy()
        negs[bad] = resample
    return negs.astype(np.int32)


def balanced_reward_indices(indices: np.ndarray, reward_classes: np.ndarray,
                            rng: np.random.RandomState) -> np.ndarray:
    """``--balanced-sampling``: an epoch of ``len(indices)`` entries of
    ``indices`` in which every reward class appears equally often (each
    class drawn with replacement where it has fewer rows than its share).
    The concatenation is shuffled before it is cut to length, so the cut
    does not fall on the last class alone."""
    classes = reward_classes[indices]
    uniq = np.unique(classes)
    n_per = int(np.ceil(len(indices) / len(uniq)))
    out = np.concatenate([
        rng.choice(indices[classes == c], size=n_per,
                   replace=int((classes == c).sum()) < n_per)
        for c in uniq])
    rng.shuffle(out)
    return out[:len(indices)].astype(np.int32)
