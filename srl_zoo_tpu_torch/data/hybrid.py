"""Rotating hybrid frame store (port of ``srl_zoo_tpu/data/hybrid.py``
``RotatingHotStore``), for a dataset whose frames exceed the device budget.

``hot_n`` rows stay resident on the device and the rest (the cold rows)
stream once per epoch. The resident set is a window ``[start, start +
hot_n) (mod n)`` of the dataset's rows that moves on by the cold count
every epoch, so every row is resident ``hot_n / cold_n`` epochs of a cycle
and cold one: the hot phase's samples and triplet negatives cover the
whole dataset across epochs. ``rotate=False`` (``--no-hybrid-rotation``)
pins the window at the first ``hot_n`` rows.

The rotation adds no upload of the rows that train: the rows that enter
the next window are this epoch's cold rows, whose uint8 pixels reach the
device for their step anyway. ``maybe_adopt`` copies those rows of a
streamed batch (still on the device) into the slots of the rows that
leave. Entering rows that never streamed this epoch (outside both splits,
cut by ``--training-set-size``, skipped by the balanced sampling) are
uploaded from the ``frames.npy`` memmap at ``advance`` (the sweep).

``slot_of`` maps a row to its store slot (-1: cold); the windows wrap, so
no formula gives the slot. Loaders ship ``cache_slots`` /
``next_cache_slots`` / ``neg_cache_slots`` and the train step gathers by
slot (training/train_step.py).

An epoch (training/learner.py)::

    begin_epoch()     # the entering and leaving rows, and their slots
    hold(val rows)    # slots validation's hot phase still reads
    hot phase         # gathers by this window's slots
    cold phase        # maybe_adopt() after each streamed step
    validation        # hot, release(), then cold (adopting too)
    advance()         # the sweep, then the new window

Adoption writes only the slots of leaving rows. A leaving training row is
last read in the training hot phase, before the first cold batch, and on
one stream the copy is ordered after that read. A leaving validation row
is read again in validation's hot phase, after the training cold phase:
``hold`` keeps its slot from adoption until ``release``, and an entering
row that would have taken it is swept instead. (The JAX package has no
hold: its validation hot phase reads such slots after the training cold
phase has written other rows into them.) After ``advance`` the map and the
bytes agree again.

In a process group (parallel/mesh.py) every rank holds the whole store,
as JAX replicates it over its mesh, and the same bookkeeping: the window,
the slot map and the entering, leaving, adopted, held and swept rows are
host arithmetic on the global batches, which every rank draws alike. A
rank's streamed batch holds only its own rows' pixels (data/loader.py),
so ``maybe_adopt`` gathers the batch's frames from every rank before it
copies the entering ones; each rank sweeps from its own memmap.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from srl_zoo_tpu_torch import native
from srl_zoo_tpu_torch.data.device_cache import build_cache
from srl_zoo_tpu_torch.data.schema import Dataset
from srl_zoo_tpu_torch.parallel import mesh
from srl_zoo_tpu_torch.utils.device import upload

SWEEP_CHUNK = 256  # rows per sweep upload (bounds the host staging)


class RotatingHotStore:
    """The hybrid store: ``cache`` ({"frames", "frames_2"} uint8 tensors of
    ``hot_n`` rows) and its slot bookkeeping."""

    def __init__(self, dataset: Dataset, device: torch.device, cfg,
                 hot_n: int, rotate: bool = True,
                 second_view: Optional[bool] = None):
        self.ds = dataset
        self.n = int(dataset.n_samples)
        self.hot_n = int(hot_n)
        self.cold_n = self.n - self.hot_n
        if not 0 < self.hot_n < self.n:
            raise ValueError(f"a hybrid store needs 0 < hot_n < n, got "
                             f"hot_n {self.hot_n} of {self.n}")
        self.rotate = bool(rotate)
        self.needs_view2 = bool(cfg.needs_second_view if second_view is None
                                else second_view)
        self.needs_next = bool(cfg.needs_next_obs)
        # where a streamed batch carries view 2: the triplet's pos_obs, else
        # the second half of the 6-channel obs
        self._view2_from_pos = bool(cfg.use_triplet)
        self.start = 0
        self.epoch = 0  # advances committed (replay_to counts them)
        self.slot_of = np.full(self.n, -1, np.int32)
        self.slot_of[:self.hot_n] = np.arange(self.hot_n, dtype=np.int32)
        self._pending_slot: Optional[np.ndarray] = None
        self._adopted: Optional[np.ndarray] = None
        self._entering: Optional[np.ndarray] = None
        self._leaving: Optional[np.ndarray] = None
        self._held = np.zeros(self.hot_n, bool)  # slots kept from adoption
        self.cache: Dict[str, torch.Tensor] = build_cache(
            dataset, device, self.needs_view2, hot_n=self.hot_n)
        # rows adopted from streamed batches and swept from the memmap
        self.adopted_rows = 0
        self.swept_rows = 0

    # ---- window membership -------------------------------------------------
    def _in_window(self, idx, start: Optional[int] = None) -> np.ndarray:
        s = self.start if start is None else start
        return ((np.asarray(idx, np.int64) - s) % self.n) < self.hot_n

    def resident_mask(self, idx) -> np.ndarray:
        """Rows whose pixels the store holds (an encode reads the row)."""
        return self._in_window(idx)

    def trainable_mask(self, idx) -> np.ndarray:
        """Rows a training gather can take from the store: the row, and its
        successor ``min(i + 1, n - 1)`` where the config reads next_obs."""
        idx = np.asarray(idx)
        m = self._in_window(idx)
        if self.needs_next:
            m &= self._in_window(np.minimum(idx + 1, self.n - 1))
        return m

    def slots(self, idx) -> np.ndarray:
        """Store slots of rows; a cold row reads slot 0 (callers gather
        only rows the masks allow, and pads are masked by ``valid``)."""
        return np.maximum(self.slot_of[np.asarray(idx)], 0).astype(np.int32)

    # ---- the epoch ---------------------------------------------------------
    def _next_window(self):
        """(entering rows, leaving rows, next start) of one rotation."""
        nxt_start = (self.start + self.cold_n) % self.n
        rows = np.arange(self.n)
        cur, nxt = self._in_window(rows), self._in_window(rows, nxt_start)
        return (np.nonzero(nxt & ~cur)[0].astype(np.int32),
                np.nonzero(cur & ~nxt)[0].astype(np.int32), nxt_start)

    def begin_epoch(self) -> None:
        """Pick this epoch's entering and leaving rows, each entering row
        paired with a leaving row's slot (both in ascending order)."""
        if not self.rotate or self._pending_slot is not None:
            return
        self._entering, self._leaving, _ = self._next_window()
        self._pending_slot = np.full(self.n, -1, np.int32)
        self._pending_slot[self._entering] = self.slot_of[self._leaving]
        self._adopted = np.zeros(self.n, bool)

    def hold(self, rows) -> None:
        """Keep the slots of the leaving rows among ``rows`` from adoption
        until ``release``: a later phase of this epoch reads them."""
        if self._pending_slot is None:
            return
        rows = np.asarray(rows)
        leaving = rows[np.isin(rows, self._leaving)]
        self._held[self.slot_of[leaving]] = True

    def release(self) -> None:
        self._held[:] = False

    def _write(self, slots: np.ndarray, view1: torch.Tensor,
               view2: Optional[torch.Tensor]) -> None:
        """store[slots] = rows, in place, per view."""
        dev = self.cache["frames"].device
        s = upload(slots, dev, torch.int64)
        self.cache["frames"].index_copy_(0, s, view1)
        if self.needs_view2:
            self.cache["frames_2"].index_copy_(0, s, view2)

    def maybe_adopt(self, host_idx, device_batch: Dict) -> None:
        """Copy a streamed batch's entering rows (not adopted yet) into
        their slots. ``host_idx`` is the global batch's rows;
        ``device_batch`` holds this rank's rows of its uint8 pixels on the
        device (data/transfer.py; all rows without a process group), and
        nothing crosses the host link. No-op outside a rotation or for a
        batch with no entering row.

        In a process group the batch's pixels are gathered from every rank
        first (one uint8 all-gather a view read, ``all_gather_frames`` in
        ``mesh.counts``). Every rank computes the mask of entering rows
        from the same host state, so all ranks enter the gather or none
        does."""
        if self._pending_slot is None:
            return
        host_idx = np.asarray(host_idx)
        pend = self._pending_slot[host_idx]
        m = (pend >= 0) & ~self._adopted[host_idx]
        m[m] = ~self._held[pend[m]]
        if not m.any():
            return
        # one batch may hold a row twice (a wrapped or padded batch)
        rows, first = np.unique(host_idx[m], return_index=True)
        pos = np.nonzero(m)[0][first]
        dev = self.cache["frames"].device
        p = upload(pos, dev, torch.int64)
        # the gathers are queued on the compute stream (an nccl collective
        # waits for the stream's earlier work, and the stream for it), as
        # are the copies below: they stay ordered after the hot phase's
        # last K2 read of the slots they write
        obs = mesh.all_gather_rows(device_batch["obs"], "all_gather_frames")
        v1 = obs[..., :3] if obs.shape[-1] == 6 else obs
        v2 = None
        if self.needs_view2:
            v2 = mesh.all_gather_rows(device_batch["pos_obs"],
                                      "all_gather_frames") \
                if self._view2_from_pos else obs[..., 3:]
            v2 = v2.index_select(0, p)
        self._write(self._pending_slot[rows], v1.index_select(0, p), v2)
        self._adopted[rows] = True
        self.adopted_rows += len(rows)

    def _host_rows(self, rows: np.ndarray, view: int) -> torch.Tensor:
        frames = self.ds.frames if view == 0 else self.ds.frames_2
        return upload(native.gather_frames(frames, rows),
                      self.cache["frames"].device)

    def _upload_rows(self, rows: np.ndarray, slots: np.ndarray,
                     chunk: int) -> None:
        for k in range(0, len(rows), chunk):
            r = rows[k:k + chunk]
            self._write(slots[k:k + chunk], self._host_rows(r, 0),
                        self._host_rows(r, 1) if self.needs_view2 else None)

    def advance(self) -> None:
        """Commit the rotation: upload the entering rows no streamed batch
        brought (the sweep), then move the slot map and the window."""
        if self._pending_slot is None:
            return
        sweep = self._entering[~self._adopted[self._entering]]
        self._upload_rows(sweep, self._pending_slot[sweep], SWEEP_CHUNK)
        self.swept_rows += len(sweep)
        self.slot_of[self._entering] = self.slot_of[self._leaving]
        self.slot_of[self._leaving] = -1
        self.start = (self.start + self.cold_n) % self.n
        self.epoch += 1
        self._pending_slot = self._adopted = None
        self._entering = self._leaving = None
        self.release()

    def replay_to(self, epoch: int) -> None:
        """Move the bookkeeping on to ``epoch`` committed rotations (host
        arithmetic only), then upload the whole window once: the resume
        path. It lands on the slot map that ``epoch`` advances give."""
        if not self.rotate or epoch <= self.epoch:
            return
        while self.epoch < epoch:
            entering, leaving, self.start = self._next_window()
            self.slot_of[entering] = self.slot_of[leaving]
            self.slot_of[leaving] = -1
            self.epoch += 1
        resident = np.nonzero(self._in_window(np.arange(self.n)))[0]
        self._upload_rows(resident, self.slot_of[resident], SWEEP_CHUNK * 4)
