"""Reward-prediction probe: how much of the reward do the learned states
tell? (port of ``srl_zoo_tpu/evaluation/predict_reward.py``).

A linear classifier trained on the states of a stratified share of the
rows predicts the discretized reward of the rest; the accuracy goes to
``reward_accuracy.json``. Host-side numpy and scipy, no device.

The JAX package calls scikit-learn's ``train_test_split`` and
``LogisticRegression``. The port does not depend on scikit-learn, so it
carries both with the same definitions:

* the split draws its rows from ``RandomState(seed)`` exactly as
  scikit-learn's ``StratifiedShuffleSplit`` (or ``ShuffleSplit`` where a
  class has a single row) does, so it picks the same rows;
* the classifier minimises scikit-learn's objective for its defaults
  (C = 1, lbfgs, intercept unpenalised): the mean log loss plus
  ||W||^2 / (2 C n), binomial for two classes and multinomial above,
  with scipy's L-BFGS-B from zero weights at scikit-learn's settings.

    python -m srl_zoo_tpu_torch.evaluation.predict_reward \\
        --log-folder logs/<run>
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Tuple

import numpy as np

from srl_zoo_tpu_torch.data.schema import discretize_rewards
from srl_zoo_tpu_torch.utils.misc import printGreen

# scikit-learn's LogisticRegression as the JAX package calls it
C = 1.0
MAX_ITER = 2000
TOL = 1e-4


def _approximate_mode(counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """Rows per class of a stratified draw of ``n_draws``: the floor of
    each class's share, then one more for the largest remainders, ties
    broken at random (scikit-learn's ``_approximate_mode``)."""
    continuous = counts / counts.sum() * n_draws
    floored = np.floor(continuous)
    need = int(n_draws - floored.sum())
    if need > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add = min(len(inds), need)
            floored[rng.choice(inds, size=add, replace=False)] += 1
            need -= add
            if need == 0:
                break
    return floored.astype(int)


def split_rows(classes: np.ndarray, test_size: float, seed: int,
               stratify: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(train rows, test rows) of ``train_test_split(..., test_size,
    random_state=seed, stratify=classes if stratify else None)``."""
    n = len(classes)
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    rng = np.random.RandomState(seed)
    if not stratify:
        perm = rng.permutation(n)
        return perm[n_test:n_test + n_train], perm[:n_test]
    uniq, inverse, counts = np.unique(classes, return_inverse=True,
                                      return_counts=True)
    for what, size in (("train", n_train), ("test", n_test)):
        if size < len(uniq):
            raise ValueError(f"The {what}_size = {size} should be greater "
                             f"or equal to the number of classes = "
                             f"{len(uniq)}")
    by_class = np.split(np.argsort(inverse, kind="stable"),
                        np.cumsum(counts)[:-1])
    n_i = _approximate_mode(counts, n_train, rng)
    t_i = _approximate_mode(counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(uniq)):
        rows = by_class[i].take(rng.permutation(counts[i]), mode="clip")
        train.extend(rows[:n_i[i]])
        test.extend(rows[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def _loss_and_grad(w: np.ndarray, x: np.ndarray, y: np.ndarray,
                   n_classes: int, l2: float):
    """Mean log loss + l2/2 ||W||^2 and its gradient; ``w`` holds the
    weights then the intercepts, one row per class (one row for two
    classes)."""
    n, d = x.shape
    rows = 1 if n_classes == 2 else n_classes
    w = w.reshape(rows, d + 1)
    coef, intercept = w[:, :d], w[:, d]
    raw = x @ coef.T + intercept
    if n_classes == 2:
        z = raw[:, 0]
        # log(1 + e^z) - y z, and its derivative sigmoid(z) - y
        loss = np.mean(np.logaddexp(0.0, z) - y * z)
        err = (1.0 / (1.0 + np.exp(-z)) - y)[:, None] / n
    else:
        top = raw.max(axis=1, keepdims=True)
        lse = top[:, 0] + np.log(np.exp(raw - top).sum(axis=1))
        loss = np.mean(lse - raw[np.arange(n), y])
        err = np.exp(raw - lse[:, None])
        err[np.arange(n), y] -= 1.0
        err /= n
    grad = np.concatenate([err.T @ x + l2 * coef, err.sum(0)[:, None]], 1)
    return loss + 0.5 * l2 * float(np.sum(coef * coef)), grad.ravel()


class LogisticProbe:
    """L2-regularized logistic regression (``C``) fitted by L-BFGS-B."""

    def fit(self, x: np.ndarray, y: np.ndarray) -> "LogisticProbe":
        from scipy.optimize import minimize
        self.classes, y_idx = np.unique(y, return_inverse=True)
        k = len(self.classes)
        x = np.asarray(x, np.float64)
        rows = 1 if k == 2 else k
        target = (y_idx == 1).astype(np.float64) if k == 2 else y_idx
        res = minimize(_loss_and_grad, np.zeros(rows * (x.shape[1] + 1)),
                       args=(x, target, k, 1.0 / (C * len(x))),
                       method="L-BFGS-B", jac=True,
                       options={"maxiter": MAX_ITER, "maxls": 50,
                                "gtol": TOL,
                                "ftol": 64 * np.finfo(float).eps})
        self.w = res.x.reshape(rows, x.shape[1] + 1)
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        raw = np.asarray(x, np.float64) @ self.w[:, :-1].T + self.w[:, -1]
        idx = (raw[:, 0] > 0).astype(int) if len(self.classes) == 2 \
            else raw.argmax(axis=1)
        return self.classes[idx]

    def score(self, x: np.ndarray, y: np.ndarray) -> float:
        return float(np.mean(self.predict(x) == y))


def predict_reward_accuracy(states: np.ndarray, rewards: np.ndarray,
                            test_size: float = 0.2, seed: int = 0) -> float:
    """Test accuracy of the probe on the reward classes; 1.0 for a dataset
    of a single reward class."""
    classes = discretize_rewards(rewards)
    if len(np.unique(classes)) < 2:
        return 1.0
    train, test = split_rows(classes, test_size, seed,
                             stratify=np.min(np.bincount(classes)) > 1)
    states = np.asarray(states)
    probe = LogisticProbe().fit(states[train], classes[train])
    return probe.score(states[test], classes[test])


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description="Train a reward classifier on "
                                            "learned states")
    p.add_argument("--log-folder", type=str, required=True)
    p.add_argument("--test-size", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    sr = np.load(os.path.join(args.log_folder, "states_rewards.npz"))
    acc = predict_reward_accuracy(sr["states"], sr["rewards"],
                                  args.test_size, args.seed)
    printGreen(f"Reward prediction accuracy: {acc:.4f}")
    with open(os.path.join(args.log_folder, "reward_accuracy.json"), "w") as f:
        json.dump({"accuracy": acc}, f)
    return acc


if __name__ == "__main__":
    main()
