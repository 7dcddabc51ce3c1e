"""The SRL model (port of ``srl_zoo_tpu/models/srl_modules.py``
``SRLModules``), for the losses the port trains.

``encode`` is the export / serving path: the deterministic state (mu with
the VAE loss active, whose encoder emits (mu, logvar)). ``forward`` is the
training apply of the decoder losses: it returns ``state``, ``mu`` and
``recon``, the decoder's reconstruction of the reconstruction losses' state
slice. Train or eval mode (BatchNorm statistics) follows ``.train()`` /
``.eval()``. The forward/inverse/reward/discriminator heads and the VAE's
sampling wait for ROADMAP.md queue A item 3.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from srl_zoo_tpu_torch.config import SRLConfig
from srl_zoo_tpu_torch.models.decoders import CNNDecoder
from srl_zoo_tpu_torch.models.encoders import CustomCNN


def slice_state(state: torch.Tensor, sl) -> torch.Tensor:
    """The SRL-splits slice ``(start, size)`` of the last axis."""
    start, size = sl
    return state[..., start:start + size]


class SRLModules(nn.Module):
    def __init__(self, cfg: SRLConfig):
        super().__init__()
        self.cfg = cfg
        out_dim = 2 * cfg.state_dim if cfg.use_vae else cfg.state_dim
        self.encoder = CustomCNN(out_dim, cfg.n_channels, cfg.img_height,
                                 cfg.img_width, cfg.bn_momentum)
        if cfg.use_decoder:
            self.recon_slice = cfg.recon_slice
            self.decoder = CNNDecoder(self.recon_slice[1], cfg.img_height,
                                      cfg.img_width, cfg.n_channels,
                                      cfg.bn_momentum)

    def encode(self, obs: torch.Tensor) -> torch.Tensor:
        """Normalized float (B, H, W, C) -> deterministic state (B, d)."""
        out = self.encoder(obs)
        return out[:, :self.cfg.state_dim] if self.cfg.use_vae else out

    def forward(self, obs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Normalized float (B, H, W, C) -> {"state", "mu", "recon"}; recon
        is (B, H, W, C), the NHWC view of the decoder's output."""
        if self.cfg.use_vae:
            raise NotImplementedError(
                "VAE training is not ported yet: ROADMAP.md queue A item 3 "
                "'Configs 2-4 and the rest of the loss zoo'")
        state = self.encoder(obs)
        out = {"state": state, "mu": state}
        if self.cfg.use_decoder:
            recon = self.decoder(slice_state(state, self.recon_slice))
            out["recon"] = recon.permute(0, 2, 3, 1)
        return out
