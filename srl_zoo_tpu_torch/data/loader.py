"""Index-only minibatch loader (port of ``srl_zoo_tpu/data/loader.py``
``DataLoader`` with ``emit_images=False``).

The frames live on the device (data/device_cache.py), so a batch is only
row indices and their metadata; the train step gathers the pixels with
the gather kernel. There is no decode and no thread. The batches are the
JAX loader's for the same seed:

* an epoch's order is a permutation drawn from ``RandomState(seed +
  epoch)`` for training (``shuffle=True``) and the split's own order for
  eval, whose generator is ``RandomState(seed)`` every epoch;
* the last partial batch wraps around to the epoch's start (training) or
  is padded with row 0 and masked by ``valid`` (eval);
* a split smaller than one batch is tiled (training) or padded (eval).

Each batch is ``{"indices", "valid", "actions", "reward_classes",
"rewards"}``; the rewards of transition i are those of row i + 1. With
``priors`` a batch also carries the robotic priors' pairs
(``same_action_partners`` / ``_mask``, ``dissimilar_partners`` / ``_mask``),
drawn from the epoch's generator after its permutation, same-action pairs
first, batch by batch, as the JAX loader draws them. With ``triplet`` a
batch carries ``neg_indices``, the triplet's negative rows, drawn from the
loader's own indices (the JAX loader's default pool) before the priors'
pairs, as the JAX loader draws them.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

from srl_zoo_tpu_torch.data import samplers
from srl_zoo_tpu_torch.data.schema import Dataset


def decode_resize(path: str, hw) -> np.ndarray:
    """An image file as (H, W, 3) RGB uint8, resized to ``hw`` with
    cv2's area filter where its size differs; FileNotFoundError if cv2
    cannot read it."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"Could not read image: {path}")
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.shape[:2] != tuple(hw):
        img = cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_AREA)
    return img


def batch_flags(cfg) -> Dict[str, bool]:
    """The DataLoader flags of the metadata that a config's losses read."""
    return {"priors": cfg.use_priors, "triplet": cfg.use_triplet,
            "episode_prior": cfg.use_episode_prior,
            "supervised": cfg.use_supervised}


class DataLoader:
    def __init__(self, dataset: Dataset, indices: np.ndarray,
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 wraparound: bool = True, priors: bool = False,
                 triplet: bool = False, episode_prior: bool = False,
                 supervised: bool = False):
        self.ds = dataset
        self.indices = np.asarray(indices, np.int32)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.wraparound = wraparound
        self.priors = priors
        self.triplet = triplet
        self.episode_prior = episode_prior
        self.supervised = supervised
        # epochs iterated so far; a resumed run sets it to its start epoch
        self.epoch = 0

    def __len__(self) -> int:
        b, n = self.batch_size, len(self.indices)
        return 1 if n <= b else (n + b - 1) // b

    def _make_batch(self, idx: np.ndarray, valid: np.ndarray,
                    rng: np.random.RandomState) -> Dict[str, np.ndarray]:
        ds = self.ds
        nxt = np.minimum(idx + 1, ds.n_samples - 1)
        batch = {"indices": idx.astype(np.int32),
                 "valid": valid.astype(np.float32),
                 "actions": ds.actions[idx],
                 "reward_classes": ds.reward_classes[nxt],
                 "rewards": ds.rewards[nxt]}
        if self.triplet:
            batch["neg_indices"] = samplers.triplet_negatives(
                idx, ds.episode_ids, self.indices, rng)
        if self.priors:
            (batch["same_action_partners"],
             batch["same_action_mask"]) = samplers.find_same_action_pairs(
                ds.actions[idx], rng)
            (batch["dissimilar_partners"],
             batch["dissimilar_mask"]) = samplers.find_dissimilar_pairs(
                ds.actions[idx], ds.reward_classes[nxt], rng)
        if self.episode_prior:
            (batch["episode_partners"],
             batch["episode_labels"]) = samplers.episode_prior_pairs(
                ds.episode_ids[idx], rng)
        if self.supervised:
            batch["gt_states"] = ds.ground_truth_states[idx]
        return batch

    def batch_indices(self, order: np.ndarray
                      ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """[(indices, valid)] of one epoch over ``order``."""
        b, n = self.batch_size, len(order)
        if n == 0:
            raise ValueError("DataLoader got an empty index set: dataset "
                             "too small for the train/val split?")
        n_full = n // b
        out = [(order[k * b:(k + 1) * b], np.ones(b))
               for k in range(n_full)]
        rem = n - n_full * b
        if rem and not self.wraparound:
            pad = np.zeros(b - rem, order.dtype)
            out.append((np.concatenate([order[n_full * b:], pad]),
                        np.concatenate([np.ones(rem), np.zeros(b - rem)])))
        elif rem and n >= b:
            out.append((np.concatenate([order[n_full * b:],
                                        order[:b - rem]]), np.ones(b)))
        elif n < b:  # training split smaller than one batch: tile it
            out = [(np.tile(order, -(-b // n))[:b], np.ones(b))]
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # eval keeps one generator across epochs (the same pairs in every
        # validation pass); training draws anew
        rng = np.random.RandomState(
            self.seed + (self.epoch if self.shuffle else 0))
        self.epoch += 1
        order = self.indices
        if self.shuffle:
            order = order[rng.permutation(len(order))]
        for idx, valid in self.batch_indices(order):
            yield self._make_batch(idx, valid, rng)
