"""Episode recorder (port of ``srl_zoo_tpu/data/record.py``): writes the
raw on-disk format that preprocessing reads (preprocessing/preprocess.py).

    rec = DatasetRecorder("data/my_robot")
    for ep in range(n_episodes):
        rec.new_episode()
        obs = env.reset()
        for t in range(T):
            action = policy(obs)
            next_obs, reward, done, info = env.step(action)
            rec.record(obs, action, reward, info["state"])
            obs = next_obs
    rec.close()

Each episode is a ``record_<e>`` folder of ``frame<t>.jpg`` files (and
``frame<t>_2.jpg`` for a second camera) and an ``episode_data.npz`` of
actions, rewards (of acting at frame t) and ground-truth states.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class DatasetRecorder:
    def __init__(self, data_folder: str, jpeg_quality: int = 90):
        self.data_folder = data_folder
        self.jpeg_quality = jpeg_quality
        os.makedirs(data_folder, exist_ok=True)
        self._episode = -1
        self._t = 0
        self._actions: list = []
        self._rewards: list = []
        self._states: list = []

    @property
    def _record_dir(self) -> str:
        return os.path.join(self.data_folder, f"record_{self._episode:03d}")

    def new_episode(self) -> None:
        self._flush_episode()
        self._episode += 1
        self._t = 0
        os.makedirs(self._record_dir, exist_ok=True)

    def record(self, obs: np.ndarray, action: int, reward: float,
               ground_truth_state: Optional[np.ndarray] = None,
               obs_2: Optional[np.ndarray] = None) -> None:
        """``obs``: (H, W, 3) RGB uint8; ``obs_2`` the second camera's view
        (write it every step or never)."""
        if self._episode < 0:
            raise RuntimeError("call new_episode() before record()")
        import cv2

        def write(img, suffix=""):
            path = os.path.join(self._record_dir,
                                f"frame{self._t:06d}{suffix}.jpg")
            cv2.imwrite(path, np.asarray(img)[:, :, ::-1],
                        [cv2.IMWRITE_JPEG_QUALITY, self.jpeg_quality])

        write(obs)
        if obs_2 is not None:
            write(obs_2, suffix="_2")
        self._actions.append(int(action))
        self._rewards.append(float(reward))
        self._states.append(
            np.zeros(1, np.float32) if ground_truth_state is None
            else np.asarray(ground_truth_state, np.float32))
        self._t += 1

    def _flush_episode(self) -> None:
        if self._episode >= 0 and self._t > 0:
            np.savez(os.path.join(self._record_dir, "episode_data.npz"),
                     actions=np.asarray(self._actions, np.int32),
                     rewards=np.asarray(self._rewards, np.float32),
                     ground_truth_states=np.stack(self._states))
        self._actions, self._rewards, self._states = [], [], []

    def close(self) -> None:
        """Write the last episode (preprocessing is a separate step)."""
        self._flush_episode()
