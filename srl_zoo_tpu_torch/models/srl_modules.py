"""The SRL model's encode path (port of ``srl_zoo_tpu/models/srl_modules.py``
``encode`` / ``_encode_raw``).

The encoder's output is the state; with the VAE loss active the encoder
emits (mu, logvar) and the deterministic state is mu. The decoder and the
forward/inverse/reward/discriminator heads wait for the training slice
(ROADMAP.md queue A).
"""

from __future__ import annotations

import torch
from torch import nn

from srl_zoo_tpu_torch.config import SRLConfig
from srl_zoo_tpu_torch.models.encoders import CustomCNN


class SRLModules(nn.Module):
    def __init__(self, cfg: SRLConfig):
        super().__init__()
        self.cfg = cfg
        out_dim = 2 * cfg.state_dim if cfg.use_vae else cfg.state_dim
        self.encoder = CustomCNN(out_dim, cfg.n_channels, cfg.img_height,
                                 cfg.img_width)

    def encode(self, obs: torch.Tensor) -> torch.Tensor:
        """Normalized float (B, H, W, C) -> deterministic state (B, d)."""
        out = self.encoder(obs)
        return out[:, :self.cfg.state_dim] if self.cfg.use_vae else out

    forward = encode
