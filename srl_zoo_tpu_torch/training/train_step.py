"""Train and eval steps over the device-resident frame store (port of
``srl_zoo_tpu/training/train_step.py`` ``_loss_fn`` / ``train_step`` /
``eval_step``, cached mode).

A batch is the loader's index batch (data/loader.py). The gather kernel
(K2) reads its rows from the uint8 store and normalizes them; the model
runs forward (the pools' K1 forward writes the argmax plane), the loss is
taken, the backward runs (K1's backward at each pool) and Adam steps. The
JAX package pads an epoch's step axis to a bucket to reuse compiled
programs and skips the padded steps; here only the real steps run.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from srl_zoo_tpu_torch.losses.registry import compute_total_loss
from srl_zoo_tpu_torch.models.srl_modules import SRLModules
from srl_zoo_tpu_torch.ops.gather_norm import gather_normalize


def _inputs(model: SRLModules, frames: torch.Tensor,
            batch: Dict[str, np.ndarray]):
    dev = frames.device
    idx = torch.from_numpy(batch["indices"].astype(np.int64)).to(dev)
    valid = torch.from_numpy(batch["valid"].astype(np.float32)).to(dev)
    obs = gather_normalize(frames, idx, model.cfg.normalize_mode)
    return obs, valid


def _loss(model: SRLModules, obs: torch.Tensor, valid: torch.Tensor):
    outputs = model(obs)
    return compute_total_loss(model.cfg, outputs, obs, valid,
                              model.parameters())


def train_step(model: SRLModules, optimizer: torch.optim.Optimizer,
               frames: torch.Tensor, batch: Dict[str, np.ndarray]
               ) -> Dict[str, torch.Tensor]:
    """One update in train mode (BatchNorm batch statistics, running
    averages updated). Returns the batch's metrics, on the device."""
    model.train()
    obs, valid = _inputs(model, frames, batch)
    total, metrics = _loss(model, obs, valid)
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


def eval_step(model: SRLModules, frames: torch.Tensor,
              batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The batch's metrics in eval mode (running statistics), no update."""
    model.eval()
    with torch.no_grad():
        obs, valid = _inputs(model, frames, batch)
        return _loss(model, obs, valid)[1]
