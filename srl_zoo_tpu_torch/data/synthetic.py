"""Deterministic synthetic dataset generator (port of
``srl_zoo_tpu/data/synthetic.py`` ``generate_dataset``; numpy only).

An agent moves on a 2D plane under 4 discrete actions; the reward is +1 at
the target, -1 at a wall and 0 otherwise; the ground-truth state is the
agent's (x, y) position. Frames are flat-coloured squares on a background
ramp, enough signal for an autoencoder or the priors to recover the
position. The folder gets the ``frames.npy`` memmap (and ``frames_2.npy``
with ``multi_view``), ``ground_truth.npz`` and ``preprocessed_data.npz``
in the training schema (data/schema.py), and with ``save_jpgs`` the
``record_*/frame*.jpg`` images the paths name. For the same arguments it
writes the same files, byte for byte, as the JAX package's generator.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def _render_frame(pos: np.ndarray, target: np.ndarray, size: int,
                  view: int = 0, bg_shift: int = 0) -> np.ndarray:
    """One (size, size, 3) uint8 frame. ``view`` 1 mirrors the scene and
    changes the palette (the second camera of a two-view dataset);
    ``bg_shift`` brightens the background's R and G channels."""
    base = (40 if view == 0 else 70) + int(bg_shift)
    img = np.full((size, size, 3), min(base, 230), dtype=np.uint8)
    ramp = np.linspace(0, 60, size, dtype=np.uint8)
    img[:, :, 2] = (40 if view == 0 else 70) + ramp[None, :]

    def draw(center_xy, half, color):
        cx = int(center_xy[0] * (size - 1))
        cy = int(center_xy[1] * (size - 1))
        x0, x1 = max(cx - half, 0), min(cx + half + 1, size)
        y0, y1 = max(cy - half, 0), min(cy + half + 1, size)
        img[y0:y1, x0:x1] = color

    tgt = target if view == 0 else np.array([1.0 - target[0], target[1]])
    agent = pos if view == 0 else np.array([1.0 - pos[0], pos[1]])
    draw(tgt, max(size // 16, 2), (220, 60, 60) if view == 0 else (60, 220, 60))
    draw(agent, max(size // 12, 3), (60, 120, 220) if view == 0 else (220, 220, 60))
    return img


def generate_dataset(
    data_folder: str,
    n_episodes: int = 5,
    episode_len: int = 40,
    img_size: int = 64,
    seed: int = 0,
    save_jpgs: bool = False,
    multi_view: bool = False,
    task: str = "navigation",
    background_drift: float = 0.0,
) -> str:
    """Write a synthetic dataset into ``data_folder`` and return the path;
    the same seed gives the same files.

    ``task`` "navigation" walks toward a fixed target at (0.85, 0.85);
    "kuka" puts the target at the centre with a smaller radius (a sparser
    reward, like the Kuka button-pushing data). ``background_drift`` in
    [0, 1] brightens the background across episodes, from 0 in the first
    to ``drift * 160`` in the last: structure over time that the 2D ground
    truth does not show."""
    rng = np.random.RandomState(seed)
    os.makedirs(data_folder, exist_ok=True)

    step = 0.08
    moves = np.array([[step, 0], [-step, 0], [0, step], [0, -step]], np.float32)
    if task == "navigation":
        target = np.array([0.85, 0.85], np.float32)
    elif task == "kuka":
        target = np.array([0.5, 0.5], np.float32)
    else:
        raise ValueError(f"Unknown synthetic task: {task}")

    actions, rewards, episode_starts, states = [], [], [], []
    images_path, images_path_2 = [], []

    # the frames stream into .npy memmaps (a temporary name, renamed when
    # complete), so a large dataset is written in bounded memory
    n_total = n_episodes * episode_len
    from numpy.lib.format import open_memmap
    fpath = os.path.join(data_folder, "frames.npy")
    frames = open_memmap(fpath + ".tmp", mode="w+", dtype=np.uint8,
                         shape=(n_total, img_size, img_size, 3))
    frames_2 = None
    if multi_view:
        f2path = os.path.join(data_folder, "frames_2.npy")
        frames_2 = open_memmap(f2path + ".tmp", mode="w+", dtype=np.uint8,
                               shape=(n_total, img_size, img_size, 3))

    try:
        _generate_into(frames, frames_2, rng, moves, target, task,
                       n_episodes, episode_len, img_size, multi_view,
                       actions, rewards, episode_starts, states,
                       images_path, images_path_2, background_drift)

        actions = np.asarray(actions, np.int32)
        rewards = np.asarray(rewards, np.float32)
        episode_starts = np.asarray(episode_starts, bool)
        states = np.asarray(states, np.float32)

        # the frames go into place first, then ground_truth.npz, and
        # preprocessed_data.npz last: every loader and regeneration check
        # keys on it, so an interrupted run never leaves it beside stale
        # or missing frames
        frames.flush()
        os.rename(fpath + ".tmp", fpath)
        if multi_view:
            frames_2.flush()
            os.rename(f2path + ".tmp", f2path)

        def _savez_atomic(fname: str, **arrs) -> None:
            path = os.path.join(data_folder, fname)
            np.savez(path + ".tmp.npz", **arrs)
            os.rename(path + ".tmp.npz", path)

        _savez_atomic("ground_truth.npz",
                      ground_truth_states=states,
                      images_path=np.asarray(images_path),
                      **({"images_path_2": np.asarray(images_path_2)}
                         if multi_view else {}),
                      target_positions=target[None])
        _savez_atomic("preprocessed_data.npz",
                      actions=actions, rewards=rewards,
                      episode_starts=episode_starts)
    finally:
        # no temporary file is left behind on an error
        for tmp in ([fpath + ".tmp"]
                    + ([f2path + ".tmp"] if multi_view else [])
                    + [os.path.join(data_folder, f + ".tmp.npz")
                       for f in ("ground_truth.npz",
                                 "preprocessed_data.npz")]):
            if os.path.exists(tmp):
                os.remove(tmp)

    if save_jpgs:
        import cv2
        all_paths: Tuple = (zip(images_path, frames),)
        if multi_view:
            all_paths = all_paths + (zip(images_path_2, frames_2),)
        for pairs in all_paths:
            for rel, frame in pairs:
                path = os.path.join(data_folder, rel)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                # cv2 writes BGR; the frames are RGB
                cv2.imwrite(path, frame[:, :, ::-1])
    return data_folder


def _generate_into(frames, frames_2, rng, moves, target, task,
                   n_episodes, episode_len, img_size, multi_view,
                   actions, rewards, episode_starts, states,
                   images_path, images_path_2,
                   background_drift: float = 0.0) -> None:
    """Roll out the episodes into the memmaps and the metadata lists."""
    i = 0
    for ep in range(n_episodes):
        bg_shift = int(round(background_drift * 160.0 * ep
                             / max(n_episodes - 1, 1)))
        pos = rng.uniform(0.1, 0.9, size=2).astype(np.float32)
        # rewards[t] is the reward received on arriving at frame t (0 at an
        # episode's start): the loader reads rewards[idx + 1] as the reward
        # of transition idx
        prev_r = 0.0
        for t in range(episode_len):
            a = int(rng.randint(4))
            new_pos = pos + moves[a]
            hit_wall = bool(np.any(new_pos < 0.02) or np.any(new_pos > 0.98))
            new_pos = np.clip(new_pos, 0.02, 0.98)
            radius = 0.1 if task == "navigation" else 0.06
            at_target = bool(np.linalg.norm(new_pos - target) < radius)
            r = 1.0 if at_target else (-1.0 if hit_wall else 0.0)

            episode_starts.append(t == 0)
            actions.append(a)
            rewards.append(prev_r)
            states.append(pos.copy())
            prev_r = r
            frames[i] = _render_frame(pos, target, img_size, view=0,
                                      bg_shift=bg_shift)
            images_path.append(f"record_{ep:03d}/frame{t:06d}.jpg")
            if multi_view:
                frames_2[i] = _render_frame(pos, target, img_size, view=1,
                                            bg_shift=bg_shift)
                images_path_2.append(f"record_{ep:03d}/frame{t:06d}_2.jpg")
            pos = new_pos
            i += 1
