"""Dataset folder schema (port of ``srl_zoo_tpu/data/schema.py``).

A dataset folder holds ``preprocessed_data.npz`` (actions, rewards,
episode_starts), ``ground_truth.npz`` (ground_truth_states, images_path,
and images_path_2 for a second camera) and the per-episode ``record_*``
image folders (preprocessing/preprocess.py writes the two npz files from
them). ``frames.npy`` (N, H, W, C) uint8 is the decode cache, memory-mapped
here; a two-camera dataset (multi-view, triplet) holds the second view's
in ``frames_2.npy``. Without a cache at the training resolution the loader
decodes the recorded images (data/loader.py).

Reward convention: ``rewards[t]`` is the reward upon ARRIVING at frame t,
so transition t = (frame t, action t, frame t+1) reads ``rewards[t + 1]``.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional

import numpy as np


def discretize_rewards(rewards: np.ndarray) -> np.ndarray:
    """Raw rewards -> contiguous class ids 0..K-1 by sorted unique value."""
    uniq = np.unique(rewards)
    return np.searchsorted(uniq, rewards).astype(np.int32)


@dataclasses.dataclass
class Dataset:
    data_folder: str
    actions: np.ndarray              # (N,) int32
    rewards: np.ndarray              # (N,) float32
    ground_truth_states: np.ndarray  # (N, d) float32
    frames: Optional[np.ndarray] = None  # (N, H, W, C) uint8 memmap
    # (N,) bool; None means one episode that starts at row 0
    episode_starts: Optional[np.ndarray] = None
    # (N,) int32 discretized rewards; None derives them from ``rewards``
    reward_classes: Optional[np.ndarray] = None
    # the second camera view, (N, H, W, C) uint8 memmap
    frames_2: Optional[np.ndarray] = None
    # (N,) str, the recorded image of each row (``resolve_image_path``)
    images_path: Optional[np.ndarray] = None
    # (N,) str, the second camera's recorded image of each row
    images_path_2: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.episode_starts is None:
            self.episode_starts = np.zeros(len(self.actions), bool)
            self.episode_starts[:1] = True
        if self.reward_classes is None:
            self.reward_classes = discretize_rewards(self.rewards)

    @property
    def n_samples(self) -> int:
        return len(self.actions)

    @property
    def n_actions(self) -> int:
        return int(self.actions.max()) + 1

    @property
    def n_reward_classes(self) -> int:
        return int(self.reward_classes.max()) + 1

    @property
    def episode_ids(self) -> np.ndarray:
        """(N,) int32 episode index of each row, from episode_starts."""
        return np.cumsum(self.episode_starts.astype(np.int32)) - 1

    def training_indices(self) -> np.ndarray:
        """Rows i for which (i, i+1) is a within-episode transition: the
        last frame of each episode is dropped."""
        valid = np.ones(self.n_samples, dtype=bool)
        valid[-1] = False
        valid[:-1] &= ~self.episode_starts[1:]
        return np.nonzero(valid)[0].astype(np.int32)


def resolve_image_path(data_folder: str, rel: str) -> str:
    """A recorded image path: datasets store them relative to the dataset
    folder or to its parent (``data/<ds>/record_x/...``); a path found in
    neither is returned as it is."""
    for base in (data_folder, os.path.dirname(data_folder.rstrip("/"))):
        p = os.path.join(base, rel)
        if os.path.exists(p):
            return p
    return rel


def _load_frames_checked(path: str, n: int) -> Optional[np.ndarray]:
    """mmap the frames cache; a cache whose length differs from the dataset
    (a stale file from an earlier recording) is dropped with a warning."""
    try:
        arr = np.load(path, mmap_mode="r")
    except (ValueError, OSError) as e:
        print(f"{os.path.basename(path)} is unreadable ({e}); ignoring it",
              file=sys.stderr)
        return None
    if len(arr) != n:
        print(f"{os.path.basename(path)} holds {len(arr)} frames but the "
              f"dataset has {n} samples: stale cache ignored; re-run "
              "preprocessing to rebuild it", file=sys.stderr)
        return None
    return arr


def load_dataset(data_folder: str) -> Dataset:
    pre = np.load(os.path.join(data_folder, "preprocessed_data.npz"))
    gt = np.load(os.path.join(data_folder, "ground_truth.npz"),
                 allow_pickle=True)
    actions = pre["actions"].astype(np.int32)
    rewards = pre["rewards"].astype(np.float32)
    episode_starts = pre["episode_starts"].astype(bool)
    gts = gt["ground_truth_states"].astype(np.float32)
    images_path = np.asarray(gt["images_path"]).astype(str)
    images_path_2 = np.asarray(gt["images_path_2"]).astype(str) \
        if "images_path_2" in gt else None
    n = len(actions)
    for name, arr in [("rewards", rewards), ("episode_starts", episode_starts),
                      ("ground_truth_states", gts),
                      ("images_path", images_path)]:
        if len(arr) != n:
            raise ValueError(f"Dataset field '{name}' has length {len(arr)}, "
                             f"expected {n} (actions)")
    frames = {}
    for name in ("frames", "frames_2"):
        fpath = os.path.join(data_folder, f"{name}.npy")
        frames[name] = _load_frames_checked(fpath, n) \
            if os.path.exists(fpath) else None
    return Dataset(data_folder=data_folder, actions=actions, rewards=rewards,
                   ground_truth_states=gts, episode_starts=episode_starts,
                   reward_classes=discretize_rewards(rewards),
                   images_path=images_path, images_path_2=images_path_2,
                   **frames)


def save_states_rewards(log_folder: str, states: np.ndarray,
                        rewards: np.ndarray) -> str:
    """Write the ``states_rewards.npz`` hand-off artifact for downstream RL."""
    os.makedirs(log_folder, exist_ok=True)
    path = os.path.join(log_folder, "states_rewards.npz")
    np.savez(path, states=np.asarray(states, np.float32),
             rewards=np.asarray(rewards, np.float32))
    return path
