"""Dataset folder schema (port of ``srl_zoo_tpu/data/schema.py``).

A dataset folder holds ``preprocessed_data.npz`` (actions, rewards,
episode_starts), ``ground_truth.npz`` (ground_truth_states, images_path)
and, for the device-resident path, the ``frames.npy`` (N, H, W, C) uint8
decode cache. This slice reads frames only from that cache: JPEG decode
(cv2) waits for a later slice.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Dataset:
    data_folder: str
    actions: np.ndarray              # (N,) int32
    rewards: np.ndarray              # (N,) float32
    ground_truth_states: np.ndarray  # (N, d) float32
    frames: Optional[np.ndarray] = None  # (N, H, W, C) uint8 memmap

    @property
    def n_samples(self) -> int:
        return len(self.actions)


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
    gts = gt["ground_truth_states"].astype(np.float32)
    images_path = np.asarray(gt["images_path"]).astype(str)
    n = len(actions)
    for name, arr in [("rewards", rewards), ("ground_truth_states", gts),
                      ("images_path", images_path)]:
        if len(arr) != n:
            raise ValueError(f"Dataset field '{name}' has length {len(arr)}, "
                             f"expected {n} (actions)")
    fpath = os.path.join(data_folder, "frames.npy")
    frames = _load_frames_checked(fpath, n) if os.path.exists(fpath) else None
    return Dataset(data_folder=data_folder, actions=actions, rewards=rewards,
                   ground_truth_states=gts, frames=frames)


def save_states_rewards(log_folder: str, states: np.ndarray,
                        rewards: np.ndarray) -> str:
    """Write the ``states_rewards.npz`` hand-off artifact for downstream RL."""
    os.makedirs(log_folder, exist_ok=True)
    path = os.path.join(log_folder, "states_rewards.npz")
    np.savez(path, states=np.asarray(states, np.float32),
             rewards=np.asarray(rewards, np.float32))
    return path
