"""The model and optimizer a run trains (port of
``srl_zoo_tpu/training/state.py``).

``make_model`` builds SRLModules with flax's initialization drawn from a
``torch.Generator`` seeded with the config's seed, channels_last on the
device. ``make_optimizer`` is optax's ``adam(lr, b1=0.9, b2=0.999,
eps=1e-8)``, which torch's Adam computes up to rounding: both divide the
bias-corrected first moment by sqrt of the bias-corrected second moment
plus eps.
"""

from __future__ import annotations

import torch

from srl_zoo_tpu_torch.config import LOSS_ZOO_ITEM, SRLConfig
from srl_zoo_tpu_torch.models.init import init_like_flax_
from srl_zoo_tpu_torch.models.srl_modules import SRLModules


def make_model(cfg: SRLConfig, device: torch.device) -> SRLModules:
    model = SRLModules(cfg)
    init_like_flax_(model, torch.Generator().manual_seed(cfg.seed))
    return model.to(device=device, memory_format=torch.channels_last)


def make_optimizer(cfg: SRLConfig, model: torch.nn.Module
                   ) -> torch.optim.Optimizer:
    if cfg.grad_accum > 1:
        raise NotImplementedError(f"--grad-accum > 1 is not ported yet: "
                                  f"{LOSS_ZOO_ITEM}")
    return torch.optim.Adam(model.parameters(), lr=cfg.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)
