"""Device-resident frame store (port of ``srl_zoo_tpu/data/device_cache.py``,
full mode).

The whole ``frames.npy`` cache is uploaded once as a uint8 (N, H, W, C)
tensor, and with ``second_view`` the second camera's ``frames_2.npy``
beside it; export and training batches are then host index arrays that the
gather kernel reads from it (ops/gather_norm.py). The store must fit the
device's free memory with room to spare for the model and its activations.
The streaming and hybrid modes for larger datasets wait for a later slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from srl_zoo_tpu_torch.data.schema import Dataset
from srl_zoo_tpu_torch.ops.gather_norm import gather_normalize

# share of the device's free memory that the store may take
FREE_MEMORY_SHARE = 0.8
UPLOAD_ROWS = 1024


def build_cache(dataset: Dataset, device: torch.device,
                second_view: bool = False) -> Dict[str, torch.Tensor]:
    """{"frames": uint8 (N, H, W, C) tensor on ``device``}, and
    "frames_2" of the same shape with ``second_view``."""
    names = ("frames", "frames_2") if second_view else ("frames",)
    arrays = {name: getattr(dataset, name) for name in names}
    for name, arr in arrays.items():
        if arr is None:
            raise ValueError(f"{dataset.data_folder} has no usable "
                             f"{name}.npy cache; JPEG decode is not ported "
                             "yet")
    if second_view and arrays["frames_2"].shape != arrays["frames"].shape:
        raise ValueError(f"frames_2.npy {arrays['frames_2'].shape} and "
                         f"frames.npy {arrays['frames'].shape} differ in "
                         f"{dataset.data_folder}")
    nbytes = sum(arr.nbytes for arr in arrays.values())
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        if nbytes > FREE_MEMORY_SHARE * free:
            raise MemoryError(
                f"frame store of {nbytes / 2**30:.2f} GiB exceeds "
                f"{FREE_MEMORY_SHARE:.0%} of the {free / 2**30:.2f} GiB free "
                f"on {device}; streaming mode is not ported yet")
    store = {}
    for name, arr in arrays.items():
        frames = torch.empty(arr.shape, dtype=torch.uint8, device=device)
        for s in range(0, len(frames), UPLOAD_ROWS):  # bounded host staging
            frames[s:s + UPLOAD_ROWS].copy_(torch.from_numpy(
                np.array(arr[s:s + UPLOAD_ROWS])))
        store[name] = frames
    return store


def gather_obs(store: Dict[str, torch.Tensor], idx, cfg) -> torch.Tensor:
    """The encoder's normalized input (B, H, W, C) of the store rows
    ``idx`` (a host index): the first view's frames, with the second
    view's stacked on the channel axis when the config stacks both. Each
    view is one gather kernel launch on its own store; "image_net" mode
    repeats the 3-channel statistics, so the two halves are the 6-channel
    normalize."""
    obs = gather_normalize(store["frames"], idx, cfg.normalize_mode)
    if not cfg.stack_views:
        return obs
    return torch.cat([obs, gather_normalize(store["frames_2"], idx,
                                            cfg.normalize_mode)], dim=-1)
