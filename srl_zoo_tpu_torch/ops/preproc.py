"""Image normalization (port of ``srl_zoo_tpu/ops/preproc.py``).

Two modes, as in the reference's preprocessing: "tf" maps uint8 to [-1, 1]
(x * 2/255 - 1), "image_net" subtracts the ImageNet mean and divides by its
std per channel, repeated for the 6-channel stacks of multi-view runs. Both
are one affine map per channel, which is how the gather kernel applies them
(ops/gather_norm.py).
"""

from __future__ import annotations

import numpy as np
import torch

# ImageNet statistics (RGB), as in torchvision / the reference "image_net" mode
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def affine_params(mode: str, n_channels: int) -> tuple[np.ndarray, np.ndarray]:
    """(scale, offset), float32 of shape (C,): normalized = x*scale + offset."""
    if mode == "tf":
        return (np.full(n_channels, 2.0 / 255.0, np.float32),
                np.full(n_channels, -1.0, np.float32))
    if mode == "image_net":
        if n_channels % 3:
            raise ValueError(f"image_net mode needs 3 or 6 channels, got "
                             f"{n_channels}")
        reps = n_channels // 3
        mean = np.asarray(IMAGENET_MEAN * reps, np.float64)
        std = np.asarray(IMAGENET_STD * reps, np.float64)
        return ((1.0 / (255.0 * std)).astype(np.float32),
                (-mean / std).astype(np.float32))
    raise ValueError(f"Unknown normalize mode: {mode}")


def normalize_images(obs: torch.Tensor, mode: str = "tf") -> torch.Tensor:
    """uint8 NHWC (3 or 6 channels) -> float32 NHWC."""
    scale, offset = affine_params(mode, obs.shape[-1])
    return (obs.to(torch.float32) * torch.from_numpy(scale).to(obs.device)
            + torch.from_numpy(offset).to(obs.device))
