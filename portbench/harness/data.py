"""Inputs made from the seed: the frames, their episodes and metadata,
and the model's weights. The same seed gives the same inputs.

Frames are uniform uint8 noise, drawn on the device in one call a camera
view and copied to host memory, where the port's loader and store read
them (no frames file is written). Weights are drawn in one normal draw on
the device and cut into the architecture's tensors
(``reference/<arch>.py`` ``param_spec``): a weight N(0, 1/fan_in) (flax's
lecun normal, untruncated), a bias N(0, 0.01^2), BatchNorm's scale 1 +
N(0, 0.1^2), shift and running mean N(0, 0.1^2), running variance
exp(N(0, 0.2^2)), so that eval mode reads statistics that are not the
identity. Metadata (actions, rewards, ground truth) comes from numpy's
generator of the same seed.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

# torch generators take seeds below 2**64, numpy's below 2**128; the
# port's loader seeds numpy's RandomState (below 2**32) with its seed plus
# the epoch
TORCH_SEED_MOD = 2 ** 63
PROGRAM_SEED_MOD = 2 ** 31


def program_seed(seed: int) -> int:
    """The seed the port's config gets: its loader draws its split and
    batch order from ``RandomState(seed + epoch)``."""
    return seed % PROGRAM_SEED_MOD


def generator(seed: int, device: torch.device, salt: int = 0
              ) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + salt) % TORCH_SEED_MOD)


def make_frames(n: int, shape, seed: int, device: torch.device,
                salt: int) -> np.ndarray:
    """(n, *shape) uint8 noise in host memory, drawn on ``device``."""
    g = generator(seed, device, salt)
    t = torch.randint(0, 256, (n, *shape), dtype=torch.uint8, generator=g,
                      device=device)
    return t.cpu().numpy()


def make_dataset(cfg: Dict, seed: int, device: torch.device):
    """The configuration's dataset (``n_frames`` frames in episodes of
    ``episode_len``, ``views`` camera views) as the port's ``Dataset``."""
    from srl_zoo_tpu_torch.data.schema import Dataset
    n = cfg["n_frames"]
    shape = (cfg["img_height"], cfg["img_width"], cfg["channels"])
    rng = np.random.default_rng(seed % TORCH_SEED_MOD)
    starts = np.zeros(n, bool)
    starts[::cfg["episode_len"]] = True
    rewards = rng.integers(0, cfg["n_reward_classes"], n).astype(np.float32)
    frames = make_frames(n, shape, seed, device, salt=1)
    frames_2 = make_frames(n, shape, seed, device, salt=2) \
        if cfg["views"] > 1 else None
    return Dataset(data_folder="", actions=rng.integers(
                       0, cfg["n_actions"], n).astype(np.int32),
                   rewards=rewards,
                   ground_truth_states=rng.standard_normal(
                       (n, 2)).astype(np.float32),
                   frames=frames, frames_2=frames_2, episode_starts=starts)


def make_weights(spec, seed: int, device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """Every tensor of ``spec`` ((name, shape, kind, fan_in) entries),
    float32 on ``device``, cut from one normal draw."""
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    flat = torch.randn(sum(sizes), generator=generator(seed, device, 3),
                       device=device)
    out, at = {}, 0
    for (name, shape, kind, fan_in), size in zip(spec, sizes):
        z = flat[at:at + size].reshape(shape)
        at += size
        if kind == "weight":
            t = z / math.sqrt(fan_in)
        elif kind == "bias":
            t = 0.01 * z
        elif kind == "bn_weight":
            t = 1.0 + 0.1 * z
        elif kind in ("bn_bias", "bn_mean"):
            t = 0.1 * z
        elif kind == "bn_var":
            t = torch.exp(0.2 * z)
        else:
            raise ValueError(f"unknown kind {kind!r} of {name}")
        out[name] = t.contiguous()
    return out
