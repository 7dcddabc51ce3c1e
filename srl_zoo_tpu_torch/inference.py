"""Inference API: encode observations with a trained SRL model.

Port of ``srl_zoo_tpu/inference.py`` ``StateEncoder``, the hand-off surface
that downstream RL calls per observation:

    enc = StateEncoder.load("logs/<run>")      # on the GPU
    state = enc.encode(obs)                    # (H, W, C) or (B, H, W, C) uint8

Each chunk of at most ``max_batch`` rows is uploaded as uint8 and
normalized on the device by the gather kernel (identity index), then
encoded. A run whose encoder stacks both camera views takes (H, W, 6)
observations, view 1's channels first; the chunk goes through the kernel
as one upload of 6-channel frames, on its vector path where a frame is a
whole number of 4-byte groups (224 x 224 x 6 is). Eager PyTorch does not
recompile per batch size, so nothing is padded to ``max_batch``.

A call is the span ``srl.encode`` (utils/spans.py), tiled by its host
stages: ``srl.encode.upload`` (the checks, the staging and the upload),
``srl.encode.launch`` (the gather kernel and the model's forward, queued)
and ``srl.encode.readback`` (the wait for the states, the copy back and
their concatenation).
"""

from __future__ import annotations

import numpy as np
import torch

from srl_zoo_tpu_torch import checkpoint as ckpt
from srl_zoo_tpu_torch.config import SRLConfig
from srl_zoo_tpu_torch.models.srl_modules import SRLModules
from srl_zoo_tpu_torch.ops.gather_norm import gather_normalize
from srl_zoo_tpu_torch.utils.device import resolve_device, use_strict_float32
from srl_zoo_tpu_torch.utils.spans import span


class StateEncoder:
    """Deterministic obs -> state encoder around a trained model."""

    def __init__(self, cfg: SRLConfig, model: SRLModules,
                 device: torch.device, max_batch: int = 32):
        self.cfg = cfg
        self.model = model
        self.device = device
        self.max_batch = max_batch

    @classmethod
    def load(cls, log_folder: str, max_batch: int = 32,
             device=None) -> "StateEncoder":
        device = resolve_device(device)
        use_strict_float32()
        cfg, model = ckpt.load_srl_model(log_folder, device)
        return cls(cfg, model, device, max_batch)

    def encode(self, obs: np.ndarray) -> np.ndarray:
        """uint8 (H, W, C) or (B, H, W, C) -> float32 (state_dim,) or
        (B, state_dim)."""
        with span("srl.encode"), torch.inference_mode():
            with span("srl.encode.upload"):
                obs = np.asarray(obs, np.uint8)
                single = obs.ndim == 3
                if single:
                    obs = obs[None]
                expected = self.cfg.img_shape
                if obs.ndim != 4 or obs.shape[1:] != expected:
                    raise ValueError(
                        f"expected uint8 observations of shape {expected} "
                        f"(or batched (B, *{expected})), got {obs.shape}")
                if len(obs) == 0:
                    return np.zeros((0, self.cfg.state_dim), np.float32)
            out = []
            for start in range(0, len(obs), self.max_batch):
                with span("srl.encode.upload"):
                    chunk = torch.from_numpy(np.require(
                        obs[start:start + self.max_batch],
                        requirements="CW")).to(self.device)
                with span("srl.encode.launch"):
                    ident = np.arange(len(chunk))
                    x = gather_normalize(chunk, ident,
                                         self.cfg.normalize_mode)
                    states = self.model.encode(x)
                with span("srl.encode.readback"):
                    out.append(states.cpu().numpy())
            with span("srl.encode.readback"):
                states = np.concatenate(out).astype(np.float32, copy=False)
                return states[0] if single else states
