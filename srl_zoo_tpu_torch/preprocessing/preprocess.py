"""Offline dataset preprocessing (port of
``srl_zoo_tpu/preprocessing/preprocess.py``).

``preprocess_folder`` walks the per-episode ``record_*`` folders of a
recorded dataset (data/record.py) and writes the training schema:
``preprocessed_data.npz`` (actions, rewards, episode_starts) and
``ground_truth.npz`` (ground_truth_states, images_path and, for a second
camera, images_path_2). ``build_frames_cache`` decodes every image once at
the training resolution into the ``frames.npy`` uint8 memmap
(``frames_2.npy`` for the second camera), with the loader's decoder chain
(the native runtime's libjpeg, else cv2), so that cached and streamed
pixels agree on one host.

    python -m srl_zoo_tpu_torch.preprocessing.preprocess \\
        --data-folder data/<ds> [--img-size 224] [--no-frames-cache]
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional

import numpy as np

from srl_zoo_tpu_torch import native
from srl_zoo_tpu_torch.data.loader import decode_images
from srl_zoo_tpu_torch.data.schema import resolve_image_path
from srl_zoo_tpu_torch.utils.misc import printGreen, printYellow

CHUNK = 256  # images decoded per call (bounds the host memory)


def _frame_files(rec: str, suffix: str):
    """The sorted ``frame*{suffix}.jpg/png`` files of a record folder; the
    first view's pattern leaves out the ``_2`` files."""
    out = []
    for ext in ("jpg", "png"):
        out += glob.glob(os.path.join(rec, f"frame*{suffix}.{ext}"))
    if not suffix:
        out = [f for f in out
               if not os.path.basename(f).split(".")[0].endswith("_2")]
    return sorted(out)


def preprocess_folder(data_folder: str) -> None:
    """Concatenate the ``record_*/episode_data.npz`` files (``actions``
    (T,), ``rewards`` (T,), ``ground_truth_states`` (T, d)) and their
    frames into the training schema.

    A recording stores the reward of acting at frame t; the schema stores
    the reward of arriving at frame t (the loader reads ``rewards[i + 1]``
    for transition i). So each episode's rewards shift right by one: 0 at
    the episode's start, and the last reward, which arrives at no frame,
    is dropped."""
    records = sorted(glob.glob(os.path.join(data_folder, "record_*")))
    if not records:
        raise FileNotFoundError(f"No record_* folders in {data_folder}")
    actions, rewards, starts, states, images, images_2 = [], [], [], [], \
        [], []
    for rec in records:
        ep_file = os.path.join(rec, "episode_data.npz")
        if not os.path.exists(ep_file):
            printYellow(f"Skipping {rec} (no episode_data.npz)")
            continue
        ep = np.load(ep_file)
        frames, frames_2 = _frame_files(rec, ""), _frame_files(rec, "_2")
        t = len(ep["actions"])
        if len(frames) < t:
            raise ValueError(f"{rec}: {len(frames)} frames for {t} steps")
        actions.append(np.asarray(ep["actions"], np.int32))
        ep_rewards = np.asarray(ep["rewards"], np.float32)
        rewards.append(np.concatenate([[0.0], ep_rewards[:-1]])
                       .astype(np.float32))
        first = np.zeros(t, bool)
        first[0] = True
        starts.append(first)
        states.append(np.asarray(ep["ground_truth_states"], np.float32))
        images.extend(os.path.relpath(f, data_folder) for f in frames[:t])
        if frames_2:
            if len(frames_2) < t:
                raise ValueError(f"{rec}: {len(frames_2)} view-2 frames for "
                                 f"{t} steps (record obs_2 every step or "
                                 "never)")
            images_2.extend(os.path.relpath(f, data_folder)
                            for f in frames_2[:t])
    if images_2 and len(images_2) != len(images):
        raise ValueError("some episodes have view-2 frames and some don't: "
                         "a multi-view dataset needs both views everywhere")
    np.savez(os.path.join(data_folder, "preprocessed_data.npz"),
             actions=np.concatenate(actions),
             rewards=np.concatenate(rewards),
             episode_starts=np.concatenate(starts))
    np.savez(os.path.join(data_folder, "ground_truth.npz"),
             ground_truth_states=np.concatenate(states),
             images_path=np.asarray(images),
             **({"images_path_2": np.asarray(images_2)} if images_2 else {}))
    printGreen(f"Wrote preprocessed_data.npz + ground_truth.npz "
               f"({len(images)} samples, {len(records)} episodes"
               f"{', multi-view' if images_2 else ''})")


def frames_cache_stale(path: str, img_size: int,
                       n_expected: Optional[int] = None) -> bool:
    """Whether a frames cache must be (re)built: missing, unreadable,
    recorded at another resolution than ``img_size``, or holding another
    number of frames than the dataset."""
    if not os.path.exists(path):
        return True
    try:
        shape = np.load(path, mmap_mode="r").shape
    except (ValueError, OSError) as e:
        printYellow(f"{os.path.basename(path)} is unreadable ({e}): "
                    "rebuilding")
        return True
    if shape[1:3] != (img_size, img_size):
        printYellow(f"{os.path.basename(path)} is {shape[1]}x{shape[2]} "
                    f"but --img-size is {img_size}: rebuilding")
        return True
    if n_expected is not None and shape[0] != n_expected:
        printYellow(f"{os.path.basename(path)} holds {shape[0]} frames but "
                    f"the dataset has {n_expected} samples: rebuilding")
        return True
    return False


def dataset_length(data_folder: str) -> Optional[int]:
    """Rows of ``ground_truth.npz``'s images_path (what the frames cache is
    built from), or None without it."""
    path = os.path.join(data_folder, "ground_truth.npz")
    if not os.path.exists(path):
        return None
    try:
        return len(np.load(path, allow_pickle=True)["images_path"])
    except (ValueError, OSError, KeyError):
        return None


def has_second_view(data_folder: str) -> bool:
    path = os.path.join(data_folder, "ground_truth.npz")
    return os.path.exists(path) and \
        "images_path_2" in np.load(path, allow_pickle=True)


def build_frames_cache(data_folder: str, img_size: int = 224,
                       view_suffix: str = "") -> str:
    """Decode every image of a view (``view_suffix`` "" or "_2") once into
    ``frames{view_suffix}.npy``, (N, img_size, img_size, 3) uint8. It is
    written to a temporary file and renamed on success, so a failed
    rebuild keeps the old cache."""
    gt = np.load(os.path.join(data_folder, "ground_truth.npz"),
                 allow_pickle=True)
    paths = [resolve_image_path(data_folder, p) for p in
             np.asarray(gt["images_path" + view_suffix]).astype(str)]
    out_path = os.path.join(data_folder, f"frames{view_suffix}.npy")
    tmp_path = f"{out_path}.{os.getpid()}.tmp"
    n = len(paths)
    out = np.lib.format.open_memmap(tmp_path, mode="w+", dtype=np.uint8,
                                    shape=(n, img_size, img_size, 3))
    threads = min(16, (os.cpu_count() or 1) * 4)
    try:
        for s in range(0, n, CHUNK):
            out[s:s + CHUNK] = decode_images(paths[s:s + CHUNK],
                                             (img_size, img_size), threads)
        out.flush()
        del out  # the memmap's handle goes before the rename
        os.replace(tmp_path, out_path)
    except BaseException:
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        raise
    decoder = "libjpeg" if native.jpeg_available() else "cv2"
    printGreen(f"Wrote {out_path} ({n} frames @ {img_size}x{img_size}, "
               f"{decoder} where every file is a JPEG)")
    return out_path


def refresh_frames_caches(data_folder: str, img_size: int,
                          multi_view: bool = False) -> None:
    """(Re)build each stale frames cache of the folder: view 1's, and view
    2's where the dataset records a second camera or ``multi_view``."""
    n = dataset_length(data_folder)
    views = [""] + (["_2"] if multi_view or has_second_view(data_folder)
                    else [])
    for suffix in views:
        if frames_cache_stale(os.path.join(data_folder,
                                           f"frames{suffix}.npy"),
                              img_size, n_expected=n):
            build_frames_cache(data_folder, img_size, view_suffix=suffix)


def main(argv=None):
    p = argparse.ArgumentParser(description="Preprocess a recorded dataset")
    p.add_argument("--data-folder", type=str, required=True)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--no-frames-cache", action="store_true",
                   help="Skip building the frames.npy decode cache")
    p.add_argument("--multi-view", action="store_true",
                   help="Also build the second view's frames_2.npy cache")
    args = p.parse_args(argv)
    if not os.path.exists(os.path.join(args.data_folder,
                                       "preprocessed_data.npz")):
        preprocess_folder(args.data_folder)
    else:
        printYellow("preprocessed_data.npz already present: skipping the "
                    "episode concatenation")
    if not args.no_frames_cache:
        refresh_frames_caches(args.data_folder, args.img_size,
                              args.multi_view)


if __name__ == "__main__":
    main()
