"""The frame store split over the ranks of a process group (port of
``srl_zoo_tpu/ops/sharded_store.py`` ``shard_frames``, ``gather_sharded``
and ``build_sharded_cache``).

The whole store (data/device_cache.py) puts every frame on every device.
The sharded store gives each rank a contiguous block of the rows instead,
the row count zero-padded to a multiple of the world size, so that the
ranks together hold world x the rows one device holds. A batch gather
(``gather_sharded``), with every rank holding the global batch's index:

  1. each rank copies the batch rows it owns from its block into a
     zero-filled (B, H, W, C) uint8 buffer (every global row has one owner);
  2. a reduce-scatter sums the buffers and leaves each rank its B/world
     rows of the batch, still uint8 (a zero row would normalize to -1 in
     "tf" mode, so the sum must come before the normalize);
  3. the gather kernel (K2, ops/gather_norm.py) normalizes them over the
     identity index, as it normalizes a streamed batch.

Each batch row crosses the interconnect once. The copy in step 1 is
``index_select`` and ``index_copy_``, as JAX's is a ``jnp.take`` outside
any Pallas kernel. Without a process group a store of one rank gathers
with K2 directly, as JAX's one-device mesh takes a plain ``take``; a group
of world size 1 takes the collective path.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from srl_zoo_tpu_torch.ops.gather_norm import (check_host_index,
                                               gather_normalize,
                                               gather_normalize_device)
from srl_zoo_tpu_torch.parallel import mesh
from srl_zoo_tpu_torch.utils.device import upload

UPLOAD_ROWS = 1024  # rows a host staging copy holds


def shard_frames(frames: np.ndarray, device: torch.device) -> torch.Tensor:
    """This rank's block of ceil(N / world) rows of ``frames`` (N, H, W,
    C) uint8 on ``device``; the last rank's block is zero-padded."""
    w, r = mesh.world(), mesh.rank()
    n_local = -(-frames.shape[0] // w)
    lo, hi = r * n_local, min((r + 1) * n_local, frames.shape[0])
    local = torch.zeros((n_local,) + frames.shape[1:], dtype=torch.uint8,
                        device=device)
    for s in range(lo, hi, UPLOAD_ROWS):  # bounded host staging
        e = min(s + UPLOAD_ROWS, hi)
        local[s - lo:e - lo].copy_(torch.from_numpy(np.array(frames[s:e])))
    return local


def gather_sharded(local: torch.Tensor, idx, n_rows: int) -> torch.Tensor:
    """This rank's B/world rows of ``frames[idx]`` as uint8, from the
    ranks' blocks ``local`` of a store of ``n_rows`` rows; ``idx`` is the
    global batch's host index (1-d, every entry in [0, n_rows))."""
    idx = check_host_index(idx, n_rows)
    if not mesh.active():
        return local.index_select(0, upload(idx, local.device))
    mesh.check_batch_size(len(idx), "a sharded gather of")
    n_local = local.shape[0]
    rel = idx - mesh.rank() * n_local
    owned = np.flatnonzero((rel >= 0) & (rel < n_local))
    contrib = torch.zeros((len(idx),) + tuple(local.shape[1:]),
                          dtype=torch.uint8, device=local.device)
    if len(owned):
        rows = local.index_select(0, upload(rel[owned], local.device))
        contrib.index_copy_(0, upload(owned, local.device), rows)
    return mesh.reduce_scatter_rows(contrib)


class ShardedStore:
    """Each camera view's block of rows on this rank (``views``), and the
    store's row count before padding (``rows``)."""

    def __init__(self, views: Dict[str, torch.Tensor], rows: int):
        self.views = views
        self.rows = rows

    @property
    def device(self) -> torch.device:
        return self.views["frames"].device

    def gather(self, view: str, idx, mode: str) -> torch.Tensor:
        """This rank's rows of the normalized frames ``idx`` (the global
        batch's host index) of ``view``: the gather, then K2 over the
        identity index; without a process group, K2 from the block (which
        then holds every row), by a device index too (``gather_view``)."""
        local = self.views[view]
        if not mesh.active():
            if isinstance(idx, torch.Tensor):
                return gather_normalize_device(local, idx, mode)
            return gather_normalize(local, idx, mode)
        u8 = gather_sharded(local, idx, self.rows)
        return gather_normalize(u8, np.arange(u8.shape[0]), mode)


def build_sharded_cache(dataset, device: torch.device,
                        second_view: bool) -> ShardedStore:
    """The sharded store of ``dataset``'s ``frames.npy`` (and
    ``frames_2.npy`` with ``second_view``) on this rank."""
    names = ("frames", "frames_2") if second_view else ("frames",)
    views = {}
    for name in names:
        arr = getattr(dataset, name)
        if arr is None:
            raise ValueError(f"{dataset.data_folder} has no usable "
                             f"{name}.npy cache to shard")
        views[name] = shard_frames(arr, device)
    return ShardedStore(views, dataset.n_samples)
