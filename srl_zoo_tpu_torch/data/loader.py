"""Minibatch loader (port of ``srl_zoo_tpu/data/loader.py`` ``DataLoader``).

Two modes, as in the JAX package:

* index-only (``emit_images=False``): the frames live on the device
  (data/device_cache.py, data/hybrid.py), so a batch is row indices and
  their metadata and the train step gathers the pixels with the gather
  kernel. With ``slot_map`` (the rotating hybrid store) a batch also
  carries the store slots of its rows (``cache_slots``, and
  ``next_cache_slots`` / ``neg_cache_slots`` where they are read).
* images (``emit_images=True``): a batch carries uint8 NHWC pixels
  (``obs``, ``next_obs``, ``pos_obs``, ``neg_obs``) fetched on the host:
  gathered from the ``frames.npy`` memmap by the native runtime
  (srl_zoo_tpu_torch/native), resized where the cache has another size,
  or, without a cache, decoded from the recorded JPEGs (the native
  decoder, else cv2 on one process-wide thread pool). A producer thread
  assembles the batches into a bounded queue while the device computes;
  with ``pin_memory`` the pixels land in pinned host memory, ready for a
  non-blocking copy (data/transfer.py). In a process group
  (parallel/mesh.py) a batch carries the pixels of this rank's positions
  only (``mesh.shard_slice``: ``obs`` and ``next_obs`` of those rows,
  ``pos_obs`` and ``neg_obs`` of their partners), so each rank decodes
  and uploads B/world rows; the metadata stays the global batch's, which
  the train step reads whole. (The JAX learner fetches every row and
  keeps a slice of it: the same batch for a world-th of the host work.)

The batches are the JAX loader's for the same seed, draw for draw:

* an epoch's order is a permutation drawn from ``RandomState(seed +
  epoch)`` for training (``shuffle=True``) and the split's own order for
  eval, whose generator is ``RandomState(seed)`` every epoch; with
  ``balanced`` a training epoch instead oversamples the reward classes of
  the transitions' next rows to equal counts (``balanced_reward_indices``);
* the last partial batch wraps around to the epoch's start (training) or
  is padded with row 0 and masked by ``valid`` (eval);
* a split smaller than one batch is tiled (training) or padded (eval).

Each batch is ``{"indices", "valid", "actions", "reward_classes",
"rewards"}``; the rewards of transition i are those of row i + 1. The
triplet's negatives are drawn first (from ``neg_pool``, by default the
loader's own rows), then the robotic priors' pairs (``same_action_partners``
/ ``_mask``, ``dissimilar_partners`` / ``_mask``), then the episode
prior's, batch by batch from the epoch's generator. The 6-channel ``obs``
of a config that stacks both views holds view 1's channels first; the
triplet's ``pos_obs`` is the anchor's view 2 and ``neg_obs`` its
negatives' view 1.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from srl_zoo_tpu_torch import native
from srl_zoo_tpu_torch.data import samplers
from srl_zoo_tpu_torch.data.schema import Dataset, resolve_image_path
from srl_zoo_tpu_torch.parallel import mesh

IMAGE_KEYS = ("obs", "next_obs", "pos_obs", "neg_obs")
PREFETCH = 3  # image batches the producer thread assembles ahead
_SENTINEL = object()

# one process-wide cv2 decode pool, shared by every loader: a pool per
# loader would leave its threads behind for every loader a pipeline grid
# builds. It grows (never shrinks) to the largest ``num_threads`` asked for.
_CV2_POOL: Optional[ThreadPoolExecutor] = None
_CV2_POOL_LOCK = threading.Lock()


def _cv2_pool(num_threads: int) -> ThreadPoolExecutor:
    """The shared pool, with room for ``num_threads`` workers. Growing sets
    the executor's ceiling in place (it starts threads lazily up to it):
    shutting the live pool down would fail another loader's map()."""
    global _CV2_POOL
    with _CV2_POOL_LOCK:
        if _CV2_POOL is not None and _CV2_POOL._max_workers < num_threads:
            _CV2_POOL._max_workers = num_threads
        if _CV2_POOL is None:
            _CV2_POOL = ThreadPoolExecutor(max_workers=num_threads,
                                           thread_name_prefix="cv2-decode")
        return _CV2_POOL


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


def decode_images(paths: List[str], hw, num_threads: int) -> np.ndarray:
    """(len(paths), H, W, 3) uint8 of image files at ``hw``: the native
    decoder (libjpeg's DCT scaling, then bilinear) where every file is a
    JPEG and the library has it, else cv2 (area filter) on the shared
    pool. The frames cache is built by the same chain
    (preprocessing/preprocess.py), so cached and streamed pixels agree on
    one host."""
    if native.jpeg_available() and all(p.endswith((".jpg", ".jpeg"))
                                       for p in paths):
        try:
            return native.decode_jpeg_batch(paths, *hw,
                                            n_threads=num_threads)
        except FileNotFoundError:
            pass  # cv2 reads what libjpeg refused, or names the file
    imgs = list(_cv2_pool(num_threads).map(
        lambda p: decode_resize(p, hw), paths))
    native.counts["jpeg_cv2"] += len(paths)
    return np.stack(imgs)


def batch_flags(cfg) -> Dict:
    """The DataLoader options of a config: the metadata its losses read,
    the pixels it reads in image mode, its balanced sampling and its
    decode threads."""
    return {"priors": cfg.use_priors, "triplet": cfg.use_triplet,
            "episode_prior": cfg.use_episode_prior,
            "supervised": cfg.use_supervised,
            "next_obs": cfg.needs_next_obs, "stack_views": cfg.stack_views,
            "balanced": cfg.balanced_sampling,
            "img_hw": (cfg.img_height, cfg.img_width),
            "num_threads": cfg.num_cpu}


class DataLoader:
    def __init__(self, dataset: Dataset, indices: np.ndarray,
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 wraparound: bool = True, priors: bool = False,
                 triplet: bool = False, episode_prior: bool = False,
                 supervised: bool = False, next_obs: bool = False,
                 stack_views: bool = False, balanced: bool = False,
                 img_hw: Optional[Tuple[int, int]] = None,
                 num_threads: Optional[int] = None,
                 emit_images: bool = False, pin_memory: bool = False,
                 neg_pool: Optional[np.ndarray] = None,
                 slot_map: Optional[np.ndarray] = None):
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
        self.next_obs = next_obs
        self.stack_views = stack_views
        self.balanced = balanced
        self.emit_images = emit_images
        self.pin_memory = pin_memory
        self.num_threads = num_threads or native.default_threads()
        if emit_images and img_hw is None:
            raise ValueError("an image-mode DataLoader needs img_hw")
        self.hw = tuple(img_hw) if img_hw is not None else None
        self.neg_pool = self.indices if neg_pool is None \
            else np.asarray(neg_pool, np.int32)
        # a copy: the hybrid store changes its map at each epoch's end, and
        # a producer thread that runs late must not see the change
        self.slot_map = None if slot_map is None \
            else np.array(slot_map, np.int32)
        # epochs iterated so far; a resumed run sets it to its start epoch
        self.epoch = 0

    def __len__(self) -> int:
        b, n = self.batch_size, len(self.indices)
        return 1 if n <= b else (n + b - 1) // b

    # ---- pixels ------------------------------------------------------------
    def _fetch_images(self, idx: np.ndarray, view: int = 0) -> np.ndarray:
        """uint8 (B, H, W, 3) of one camera view of rows ``idx``."""
        frames = self.ds.frames if view == 0 else self.ds.frames_2
        if frames is not None:
            out = native.gather_frames(frames, idx)
            if out.shape[1:3] != self.hw:
                out = native.resize_batch(out, *self.hw)
            return out
        paths = self.ds.images_path if view == 0 else self.ds.images_path_2
        if paths is None:
            raise ValueError(f"{self.ds.data_folder} has no view-{view + 1} "
                             "images (neither a frames cache nor recorded "
                             "image paths)")
        return decode_images([resolve_image_path(self.ds.data_folder,
                                                 paths[i]) for i in idx],
                             self.hw, self.num_threads)

    def _observation(self, idx: np.ndarray) -> np.ndarray:
        """The encoder's uint8 input: view 1, or both views stacked on the
        channel axis."""
        obs = self._fetch_images(idx, view=0)
        if self.stack_views:
            obs = np.concatenate([obs, self._fetch_images(idx, view=1)],
                                 axis=-1)
        return obs

    def _slots(self, idx: np.ndarray) -> np.ndarray:
        """Store slots of rows; a cold row (-1, only ever a masked pad row)
        reads slot 0."""
        return np.maximum(self.slot_map[idx], 0).astype(np.int32)

    # ---- batches -----------------------------------------------------------
    def _make_batch(self, idx: np.ndarray, valid: np.ndarray,
                    rng: np.random.RandomState) -> Dict:
        ds = self.ds
        nxt = np.minimum(idx + 1, ds.n_samples - 1)
        batch = {"indices": idx.astype(np.int32),
                 "valid": valid.astype(np.float32),
                 "actions": ds.actions[idx],
                 "reward_classes": ds.reward_classes[nxt],
                 "rewards": ds.rewards[nxt]}
        if self.emit_images:
            # this rank's positions of the batch, whose pixels it fetches
            own = mesh.shard_slice(len(idx))
            batch["obs"] = self._observation(idx[own])
            if self.next_obs:
                batch["next_obs"] = self._observation(nxt[own])
        elif self.slot_map is not None:
            batch["cache_slots"] = self._slots(idx)
            if self.next_obs:
                batch["next_cache_slots"] = self._slots(nxt)
        if self.triplet:
            negs = samplers.triplet_negatives(idx, ds.episode_ids,
                                              self.neg_pool, rng)
            if self.emit_images:
                batch["pos_obs"] = self._fetch_images(idx[own], view=1)
                batch["neg_obs"] = self._fetch_images(negs[own], view=0)
            elif self.slot_map is not None:
                batch["neg_cache_slots"] = self._slots(negs)
            else:
                batch["neg_indices"] = negs
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
        if self.pin_memory:
            import torch
            for k in IMAGE_KEYS:
                if k in batch:
                    pinned = torch.empty(batch[k].shape, dtype=torch.uint8,
                                         pin_memory=True)
                    pinned.numpy()[...] = batch[k]
                    batch[k] = pinned
        return batch

    def epoch_order(self, rng: np.random.RandomState) -> np.ndarray:
        """The epoch's rows in order: a permutation (training), balanced
        reward classes (training with ``balanced``; by the reward class of
        the transition's next row, as the batches read it), or the split's
        order (eval)."""
        idx = self.indices
        if self.balanced and self.shuffle:
            rc = self.ds.reward_classes[np.minimum(idx + 1,
                                                   self.ds.n_samples - 1)]
            return idx[samplers.balanced_reward_indices(
                np.arange(len(idx), dtype=np.int32), rc, rng)]
        if self.shuffle:
            return idx[rng.permutation(len(idx))]
        return idx

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

    def __iter__(self) -> Iterator[Dict]:
        # eval keeps one generator across epochs (the same pairs in every
        # validation pass); training draws anew
        rng = np.random.RandomState(
            self.seed + (self.epoch if self.shuffle else 0))
        self.epoch += 1
        batches = self.batch_indices(self.epoch_order(rng))
        if not self.emit_images:
            for idx, valid in batches:
                yield self._make_batch(idx, valid, rng)
            return
        yield from self._produced(batches, rng)

    def _produced(self, batches, rng) -> Iterator[Dict]:
        """The image batches, assembled by a producer thread into a queue
        of ``PREFETCH`` batches. A consumer that stops early sets ``stop``,
        which ends the producer (its puts give up) instead of leaving it
        blocked on a full queue with its batches."""
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        errors: list = []
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for idx, valid in batches:
                    if stop.is_set() or not put(
                            self._make_batch(idx, valid, rng)):
                        return
            except Exception as err:  # raised again in the consumer
                errors.append(err)
            finally:
                put(_SENTINEL)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    break
                yield item
            thread.join()
            if errors:
                raise errors[0]
        finally:
            stop.set()
