"""The SRL model (port of ``srl_zoo_tpu/models/srl_modules.py``
``SRLModules``).

``encode`` is the export / serving path: the deterministic state (mu with
the VAE loss active, whose encoder emits (mu, logvar)). ``forward`` is the
training apply: it encodes the observation (and the next one, when given),
and returns every output the active losses read: ``state``, ``mu``
(``logvar`` with the VAE), ``next_state``, ``recon`` (the decoder's
reconstruction of the reconstruction losses' slice) and the heads'
``forward_pred``, ``inverse_logits`` and ``reward_logits``, each head on
its own slice of ``state`` and ``next_state``. With the triplet loss it
also encodes the positive (the second camera view of the same frame) and
the negative (a distant frame) into ``pos_state`` and ``neg_state``: mu,
never sampled. With the denoising autoencoder the caller passes the
corrupted frames as ``obs`` (the next frames stay clean) and holds the
reconstruction to the clean ones. With the episode prior the model holds
the ``discriminator`` head, which ``discriminate(s1, s2)`` applies; the
train step calls it (JAX's ``disc_probe`` output, which only makes flax
create the head's parameters, has no counterpart).

The encoder passes run in the JAX module's order: obs, next obs, positive,
negative. In train mode each pass folds its batch statistics into
BatchNorm's running averages, so the order decides the exported states.

In train mode the VAE samples ``z = mu + exp(logvar / 2) * eps`` on its
slice only; the other slices stay ``mu``. ``eps`` comes in through
``noise`` (``{"state": ..., "next_state": ...}``, each (B, state_dim)),
drawn by the caller, so the module itself is deterministic. Eval mode
uses ``mu``. Train or eval mode (BatchNorm statistics, sampling) follows
``.train()`` / ``.eval()``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from srl_zoo_tpu_torch.config import SRLConfig
from srl_zoo_tpu_torch.models.decoders import CNNDecoder
from srl_zoo_tpu_torch.models.encoders import make_encoder
from srl_zoo_tpu_torch.models.heads import (Discriminator, ForwardModel,
                                            InverseModel, RewardModel)


def slice_state(state: torch.Tensor, sl) -> torch.Tensor:
    """The SRL-splits slice ``(start, size)`` of the last axis."""
    start, size = sl
    return state[..., start:start + size]


class SRLModules(nn.Module):
    def __init__(self, cfg: SRLConfig):
        super().__init__()
        self.cfg = cfg
        out_dim = 2 * cfg.state_dim if cfg.use_vae else cfg.state_dim
        self.encoder = make_encoder(cfg.model_type, out_dim, cfg.n_channels,
                                    cfg.img_height, cfg.img_width,
                                    cfg.bn_momentum)
        slices = cfg.slices
        if cfg.use_decoder:
            self.recon_slice = cfg.recon_slice
            self.decoder = CNNDecoder(self.recon_slice[1], cfg.img_height,
                                      cfg.img_width, cfg.n_channels,
                                      cfg.bn_momentum)
        mlp = cfg.inverse_model_type == "mlp"
        if cfg.use_forward:
            self.forward_model = ForwardModel(slices["forward"][1],
                                              cfg.n_actions, mlp)
        if cfg.use_inverse:
            self.inverse_model = InverseModel(slices["inverse"][1],
                                              cfg.n_actions, mlp)
        if cfg.use_reward:
            self.reward_model = RewardModel(slices["reward"][1],
                                            cfg.n_reward_classes)
        if cfg.use_episode_prior:
            self.discriminator = Discriminator(slices["episode-prior"][1])

    def _encode_raw(self, obs: torch.Tensor):
        """(mu, logvar) with the VAE active, else (state, None)."""
        out = self.encoder(obs)
        if self.cfg.use_vae:
            d = self.cfg.state_dim
            return out[:, :d], out[:, d:]
        return out, None

    def _sample(self, mu: torch.Tensor, logvar: Optional[torch.Tensor],
                eps: Optional[torch.Tensor]) -> torch.Tensor:
        """z on the VAE's slice in train mode; mu elsewhere."""
        if not (self.cfg.use_vae and self.training):
            return mu
        if eps is None:
            raise ValueError("a train-mode VAE forward needs its noise")
        start, size = self.cfg.slices["vae"]
        z = mu + torch.exp(0.5 * logvar) * eps
        cols = torch.arange(mu.shape[-1], device=mu.device)
        return torch.where((cols >= start) & (cols < start + size), z, mu)

    def encode(self, obs: torch.Tensor) -> torch.Tensor:
        """Normalized float (B, H, W, C) -> deterministic state (B, d)."""
        return self._encode_raw(obs)[0]

    def discriminate(self, s1: torch.Tensor, s2: torch.Tensor
                     ) -> torch.Tensor:
        """The episode prior's (B,) same-episode logits of state pairs."""
        return self.discriminator(s1, s2)

    def forward(self, obs: torch.Tensor,
                next_obs: Optional[torch.Tensor] = None,
                actions: Optional[torch.Tensor] = None,
                noise: Optional[Dict[str, torch.Tensor]] = None,
                pos_obs: Optional[torch.Tensor] = None,
                neg_obs: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """Normalized float (B, H, W, C) frames -> the outputs the losses
        read; ``recon`` is (B, H, W, C), the NHWC view of the decoder's
        output. ``pos_obs`` and ``neg_obs`` are the triplet's frames."""
        cfg = self.cfg
        noise = noise or {}
        mu, logvar = self._encode_raw(obs)
        state = self._sample(mu, logvar, noise.get("state"))
        out = {"state": state, "mu": mu}
        if logvar is not None:
            out["logvar"] = logvar
        if next_obs is not None:
            next_mu, next_logvar = self._encode_raw(next_obs)
            out["next_state"] = self._sample(next_mu, next_logvar,
                                             noise.get("next_state"))
        if cfg.use_decoder:
            recon = self.decoder(slice_state(state, self.recon_slice))
            out["recon"] = recon.permute(0, 2, 3, 1)
        if cfg.use_forward:
            out["forward_pred"] = self.forward_model(
                slice_state(state, cfg.slices["forward"]), actions)
        for name, head in (("inverse", "inverse_model"),
                           ("reward", "reward_model")):
            if name in cfg.loss_names:
                sl = cfg.slices[name]
                out[f"{name}_logits"] = getattr(self, head)(
                    slice_state(state, sl),
                    slice_state(out["next_state"], sl))
        if cfg.use_triplet:
            out["pos_state"] = self._encode_raw(pos_obs)[0]
            out["neg_state"] = self._encode_raw(neg_obs)[0]
        return out
