"""Device-resident frame store (port of ``srl_zoo_tpu/data/device_cache.py``,
full mode).

The whole ``frames.npy`` cache is uploaded once as a uint8 (N, H, W, C)
tensor; export batches are then int64 index arrays that the gather kernel
reads from it (ops/gather_norm.py). The store must fit the device's free
memory with room to spare for the model and its activations. The streaming
and hybrid modes for larger datasets wait for a later slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from srl_zoo_tpu_torch.data.schema import Dataset

# share of the device's free memory that the store may take
FREE_MEMORY_SHARE = 0.8
UPLOAD_ROWS = 1024


def build_cache(dataset: Dataset, device: torch.device
                ) -> Dict[str, torch.Tensor]:
    """{"frames": uint8 (N, H, W, C) tensor on ``device``}."""
    if dataset.frames is None:
        raise ValueError(f"{dataset.data_folder} has no usable frames.npy "
                         "cache; JPEG decode is not ported yet")
    nbytes = dataset.frames.nbytes
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        if nbytes > FREE_MEMORY_SHARE * free:
            raise MemoryError(
                f"frame store of {nbytes / 2**30:.2f} GiB exceeds "
                f"{FREE_MEMORY_SHARE:.0%} of the {free / 2**30:.2f} GiB free "
                f"on {device}; streaming mode is not ported yet")
    frames = torch.empty(dataset.frames.shape, dtype=torch.uint8,
                         device=device)
    for s in range(0, len(frames), UPLOAD_ROWS):  # bounded host staging
        frames[s:s + UPLOAD_ROWS].copy_(torch.from_numpy(
            np.array(dataset.frames[s:s + UPLOAD_ROWS])))
    return {"frames": frames}
