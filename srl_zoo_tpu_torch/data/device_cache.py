"""Device-resident frame store (port of ``srl_zoo_tpu/data/device_cache.py``).

The ``frames.npy`` cache is uploaded once as a uint8 (N, H, W, C) tensor,
and with ``second_view`` the second camera's ``frames_2.npy`` beside it;
export and training batches are then host index arrays that the gather
kernel reads from it (ops/gather_norm.py). The store's budget is
``FREE_MEMORY_SHARE`` of the device's free memory, or
``SRL_ZOO_CACHE_BUDGET_MB`` where that is set (read at each call; a
fraction of a MiB is allowed, so that a small dataset can be made to go
hybrid). ``--device-cache`` picks the mode (``open_store``):

* ``auto``: the whole store where it fits; else a hybrid store
  (data/hybrid.py) when the budget holds at least two batches of rows;
  else streaming;
* ``on``: the whole store, or an error when it does not fit;
* ``off``: streaming (the loader's uint8 batches, data/transfer.py);
* ``hybrid``: the hybrid store, whose size is the budget's;
* ``sharded``: the store split over the ranks of a process group
  (ops/sharded_store.py), each rank holding its block of rows; its budget
  is the sum of the ranks' (one rank without a group holds all rows).

``plan`` makes the choice, which ``utils/doctor.py`` reports. In a
process group every mode runs, and every rank must open the same store:
``group_budget`` agrees on the least of the ranks' budgets before
``plan`` runs, so that two cards with different free memory cannot pick
two stores (one rank would then wait forever in a collective that the
other never issues) or two hybrid sizes (their slot maps, and so their
gathers, would part). A streamed batch then carries each rank's rows of
its pixels (data/loader.py); the hybrid store is held whole on every rank
(data/hybrid.py).

A store is only built from a cache at the training resolution (both views
where the config reads the second); any other dataset streams. The gathers
(``gather_view``, ``gather_obs``) take the global batch's index and give
this rank's rows of it (parallel/mesh.py; all rows without a group).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from srl_zoo_tpu_torch.data.schema import Dataset
from srl_zoo_tpu_torch.ops.gather_norm import (gather_normalize,
                                               gather_normalize_device)
from srl_zoo_tpu_torch.ops.sharded_store import (ShardedStore,
                                                 build_sharded_cache)
from srl_zoo_tpu_torch.parallel import mesh
from srl_zoo_tpu_torch.utils.misc import printGreen, printYellow
from srl_zoo_tpu_torch.utils.spans import span

# share of the device's free memory that the store may take
FREE_MEMORY_SHARE = 0.8
BUDGET_ENV = "SRL_ZOO_CACHE_BUDGET_MB"
UPLOAD_ROWS = 1024


def budget_bytes(device: torch.device) -> Optional[int]:
    """Bytes the store may take on ``device``: ``SRL_ZOO_CACHE_BUDGET_MB``
    MiB where it is set, else ``FREE_MEMORY_SHARE`` of a CUDA device's free
    memory; None (no limit) on the CPU."""
    env = os.environ.get(BUDGET_ENV)
    if env:
        return int(float(env) * 2**20)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(FREE_MEMORY_SHARE * free)
    return None


def group_budget(device: torch.device) -> Optional[int]:
    """The budget every rank plans with: the least ``budget_bytes`` over
    the process group's ranks (None only where no rank has a limit); this
    rank's own without a group."""
    return mesh.min_over_ranks(budget_bytes(device), device)


def _views(second_view: bool) -> Tuple[str, ...]:
    return ("frames", "frames_2") if second_view else ("frames",)


def cache_nbytes(dataset: Dataset, second_view: bool) -> Optional[int]:
    """Bytes of the store that ``build_cache`` would upload (the second
    view only where the config reads it), or None without a frames
    cache."""
    if dataset.frames is None:
        return None
    return sum(getattr(dataset, name).nbytes for name in _views(second_view)
               if getattr(dataset, name) is not None)


def views_cacheable(dataset: Dataset, hw, second_view: bool) -> bool:
    """Whether every view the store would hold has a frames cache at the
    training resolution ``hw`` (another size streams, resized per batch)."""
    return all(getattr(dataset, name) is not None
               and tuple(getattr(dataset, name).shape[1:3]) == tuple(hw)
               for name in _views(second_view))


def fits(dataset: Dataset, hw, second_view: bool,
         max_bytes: Optional[int]) -> bool:
    """Whether the whole store can be built within ``max_bytes`` (None: no
    limit)."""
    if not views_cacheable(dataset, hw, second_view):
        return False
    return max_bytes is None or cache_nbytes(dataset, second_view) \
        <= max_bytes


def hybrid_hot_n(dataset: Dataset, hw, second_view: bool,
                 max_bytes: Optional[int]) -> int:
    """Rows of a hybrid store within ``max_bytes``: 0 where the views are
    not cacheable; all rows where there is no limit."""
    if not views_cacheable(dataset, hw, second_view):
        return 0
    per = int(np.prod(dataset.frames.shape[1:])) * len(_views(second_view))
    if max_bytes is None:
        return dataset.n_samples
    return int(min(dataset.n_samples, max_bytes // per))


def build_cache(dataset: Dataset, device: torch.device,
                second_view: bool = False,
                hot_n: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """{"frames": uint8 (N, H, W, C) tensor on ``device``}, and "frames_2"
    of the same shape with ``second_view``; with ``hot_n`` the first
    ``hot_n`` rows only (the hybrid store's first window)."""
    arrays = {name: getattr(dataset, name) for name in _views(second_view)}
    for name, arr in arrays.items():
        if arr is None:
            raise ValueError(f"{dataset.data_folder} has no usable "
                             f"{name}.npy cache to upload (run "
                             "preprocessing, or use --device-cache off)")
    if second_view and arrays["frames_2"].shape != arrays["frames"].shape:
        raise ValueError(f"frames_2.npy {arrays['frames_2'].shape} and "
                         f"frames.npy {arrays['frames'].shape} differ in "
                         f"{dataset.data_folder}")
    store = {}
    with span("srl.store.upload"):
        for name, arr in arrays.items():
            n = len(arr) if hot_n is None else hot_n
            frames = torch.empty((n,) + arr.shape[1:], dtype=torch.uint8,
                                 device=device)
            for s in range(0, n, UPLOAD_ROWS):  # bounded host staging
                frames[s:s + UPLOAD_ROWS].copy_(torch.from_numpy(
                    np.array(arr[s:min(s + UPLOAD_ROWS, n)])))
            store[name] = frames
    return store


def plan(dataset: Dataset, hw, second_view: bool, mode: str,
         batch_size: int, budget: Optional[int], world: int = 1
         ) -> Tuple[str, int]:
    """(kind, rows) of the store ``mode`` opens for ``dataset`` at ``hw``
    within ``budget`` bytes a device (None: no limit) on ``world`` ranks:
    ("whole", N), ("sharded", N), ("hybrid", resident rows) or ("stream",
    0). Raises where the mode cannot be met. Only the sharded store
    depends on ``world``: every other mode holds its rows on each rank.
    In a process group ``budget`` must be the same on every rank
    (``group_budget``)."""
    n = dataset.n_samples
    if mode == "sharded":
        total = None if budget is None else budget * world
        if not fits(dataset, hw, second_view, total):
            raise ValueError(
                f"--device-cache sharded, but the dataset exceeds the "
                f"{world}-rank budget or has no frames.npy at the training "
                "resolution")
        return "sharded", n
    if mode == "off":
        return "stream", 0
    if mode != "hybrid" and fits(dataset, hw, second_view, budget):
        return "whole", n
    if mode == "on":
        raise ValueError("--device-cache on, but the dataset does not fit "
                         "the device budget or has no frames.npy at the "
                         "training resolution")
    hot_n = hybrid_hot_n(dataset, hw, second_view, budget)
    if mode == "hybrid" and hot_n == 0:
        raise ValueError("--device-cache hybrid, but the dataset has no "
                         "frames.npy at the training resolution")
    if hot_n >= n:
        # a forced hybrid store that holds every row is the whole store
        return "whole", n
    if hot_n >= 2 * batch_size:
        return "hybrid", hot_n
    return "stream", 0


def open_store(dataset: Dataset, cfg, device: torch.device,
               second_view: Optional[bool] = None):
    """(store, hot_store) of ``cfg.device_cache`` (see the module note):
    (whole store, None), (``ShardedStore``, None), (the hybrid store's
    tensors, its ``RotatingHotStore``) or (None, None) to stream. The
    store holds the second view where ``second_view`` says (default: where
    training reads it; an export reads it only where the views are
    stacked)."""
    hw = (cfg.img_height, cfg.img_width)
    second = cfg.needs_second_view if second_view is None else second_view
    kind, rows = plan(dataset, hw, second, cfg.device_cache, cfg.batch_size,
                      group_budget(device), mesh.world())
    if kind == "whole":
        nbytes = cache_nbytes(dataset, second)
        printGreen(f"Caching dataset on {device} ({nbytes / 2**20:.0f} MiB)")
        return build_cache(dataset, device, second), None
    if kind == "sharded":
        nbytes = cache_nbytes(dataset, second)
        w = mesh.world()
        printGreen(f"Sharding dataset over {w} rank(s) ({nbytes / 2**20:.0f} "
                   f"MiB in all, {nbytes / w / 2**20:.0f} MiB a rank)")
        return build_sharded_cache(dataset, device, second), None
    if kind == "hybrid":
        from srl_zoo_tpu_torch.data.hybrid import RotatingHotStore
        how = "rotating residency" if cfg.hybrid_rotation \
            else "static prefix (--no-hybrid-rotation)"
        printGreen(f"Hybrid device cache: {rows}/{dataset.n_samples} frames "
                   f"resident ({how}), the rest streams each epoch")
        hot = RotatingHotStore(dataset, device, cfg, rows,
                               rotate=cfg.hybrid_rotation, second_view=second)
        return hot.cache, hot
    if cfg.device_cache != "off":
        printYellow("the device budget holds fewer than two batches of "
                    "frames (or the dataset has no frames.npy at the "
                    "training resolution): streaming")
    return None, None


def store_rows(store) -> int:
    """Rows of a store: the dataset's for a whole or sharded store, the
    slots of a hybrid one."""
    if isinstance(store, ShardedStore):
        return store.rows
    return store["frames"].shape[0]


def gather_view(store, view: str, idx, mode: str) -> torch.Tensor:
    """This rank's rows of the normalized frames ``idx`` (a host index of
    the global batch) of one camera view: K2 from a whole or hybrid store,
    or the sharded store's gather. ``idx`` may also be an int64 tensor on
    the store's device whose entries were range-checked before it went up
    (a captured step's: K2's device-index form)."""
    if isinstance(store, ShardedStore):
        return store.gather(view, idx, mode)
    if isinstance(idx, torch.Tensor):
        return gather_normalize_device(store[view], mesh.shard_rows(idx),
                                       mode)
    return gather_normalize(store[view], mesh.shard_rows(idx), mode)


def gather_obs(store, idx, cfg) -> torch.Tensor:
    """The encoder's normalized input (B, H, W, C) of the store rows
    ``idx`` (a host index, or a device index as ``gather_view`` takes it;
    in a process group, this rank's rows of it):
    the first view's frames, with the second view's stacked on the channel
    axis when the config stacks both. Each view is one gather of its own
    store; "image_net" mode repeats the 3-channel statistics, so the two
    halves are the 6-channel normalize."""
    obs = gather_view(store, "frames", idx, cfg.normalize_mode)
    if not cfg.stack_views:
        return obs
    return torch.cat([obs, gather_view(store, "frames_2", idx,
                                       cfg.normalize_mode)], dim=-1)
