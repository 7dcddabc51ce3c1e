"""Image normalization and the denoising autoencoder's corruption (port
of ``srl_zoo_tpu/ops/preproc.py``).

Two modes, as in the reference's preprocessing: "tf" maps uint8 to [-1, 1]
(x * 2/255 - 1), "image_net" subtracts the ImageNet mean and divides by its
std per channel, repeated for the 6-channel stacks of multi-view runs. Both
are one affine map per channel, which is how the gather kernel applies them
(ops/gather_norm.py).

The DAE corrupts the normalized frames: ``occlude`` zeroes one square
patch per frame (mid-grey in "tf" mode), ``gaussian_noise`` adds noise.
Each takes its random draw as an argument (the patch corners, the noise
tensor); ``draw_occlusion`` and ``draw_gaussian_noise`` take the draws
from a ``torch.Generator``. The corrupted frames keep the NHWC layout of
the frames they come from.
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


def occlusion_side(n: int, occlusion_percentage: float) -> int:
    """The patch's side along an image axis of ``n`` pixels:
    ``n * sqrt(p)`` in float32, truncated, as the JAX package computes it
    (in float64 some (n, p) truncate one pixel higher)."""
    return int(np.float32(n) * np.sqrt(np.float32(occlusion_percentage)))


def draw_occlusion(generator: torch.Generator, batch: int, h: int, w: int,
                   occlusion_percentage: float, device
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y0, x0), each (batch,) int64: a patch corner per frame, uniform
    over the corners whose patch lies inside the frame (the last one
    touches the bottom or right edge)."""
    ends = [max(n - occlusion_side(n, occlusion_percentage) + 1, 1)
            for n in (h, w)]
    return tuple(torch.randint(0, end, (batch,), generator=generator,
                               device=device) for end in ends)


def occlude(obs: torch.Tensor, corners: tuple[torch.Tensor, torch.Tensor],
            occlusion_percentage: float) -> torch.Tensor:
    """Normalized (B, H, W, C) frames with the patch at ``corners``
    (``draw_occlusion``) set to 0 in each."""
    _, h, w, _ = obs.shape
    y0, x0 = (c.view(-1, 1, 1) for c in corners)
    rows = torch.arange(h, device=obs.device).view(1, h, 1)
    cols = torch.arange(w, device=obs.device).view(1, 1, w)
    inside = ((rows >= y0) & (rows < y0 + occlusion_side(
        h, occlusion_percentage)) & (cols >= x0)
        & (cols < x0 + occlusion_side(w, occlusion_percentage)))
    return torch.where(inside[..., None], torch.zeros((), dtype=obs.dtype,
                                                      device=obs.device),
                       obs)


def draw_gaussian_noise(generator: torch.Generator, shape, device
                        ) -> torch.Tensor:
    """A unit normal of the frames' shape."""
    return torch.randn(tuple(shape), generator=generator, device=device)


def gaussian_noise(x: torch.Tensor, noise: torch.Tensor,
                   stddev: float) -> torch.Tensor:
    """x + stddev * noise (the reference's GaussianNoise layer)."""
    return x + stddev * noise


def denormalize_images(x: torch.Tensor, mode: str = "tf") -> torch.Tensor:
    """Inverse of "tf" ``normalize_images``, as floats clipped to [0, 1]
    (to draw a decoder's output: a run with a decoder normalizes "tf")."""
    if mode != "tf":
        raise ValueError(f"no inverse of normalize mode {mode!r} here")
    return ((x + 1.0) * 0.5).clamp(0.0, 1.0)
