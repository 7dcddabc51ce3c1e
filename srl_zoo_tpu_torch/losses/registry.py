"""Weighted loss assembly (port of ``srl_zoo_tpu/losses/registry.py``
``compute_total_loss`` / ``recompose_epoch_means``) for the losses the
port trains: the autoencoder and the l1/l2 regularizers.

``compute_total_loss`` returns ``(total, metrics)``; ``metrics`` holds each
term, ``total`` and ``_n_valid`` (the batch's valid-row count, by which the
learner weights its epoch means), all as 0-d tensors on the device.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

from srl_zoo_tpu_torch.config import SRLConfig
from srl_zoo_tpu_torch.losses import functions as F


def compute_total_loss(cfg: SRLConfig, outputs: Dict[str, torch.Tensor],
                       target_obs: torch.Tensor,
                       valid: Optional[torch.Tensor],
                       params: Iterable[torch.Tensor]):
    """``outputs`` of SRLModules.forward, the clean normalized frames the
    decoder reconstructs, the (B,) 0/1 validity mask of a padded eval
    batch (None = all rows count) and the model's parameters."""
    weights = cfg.loss_dict
    metrics: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), dtype=torch.float32, device=target_obs.device)

    def add(name: str, value: torch.Tensor) -> None:
        nonlocal total
        metrics[name] = value
        total = total + weights[name] * value

    if "autoencoder" in weights:
        add("autoencoder", F.autoencoder_loss(outputs["recon"], target_obs,
                                              valid))
    if cfg.l1_reg > 0 or cfg.l2_reg > 0:
        params = list(params)
    if cfg.l1_reg > 0:
        metrics["l1_reg"] = F.l1_regularization(params)
        total = total + cfg.l1_reg * metrics["l1_reg"]
    if cfg.l2_reg > 0:
        metrics["l2_reg"] = F.l2_regularization(params)
        total = total + cfg.l2_reg * metrics["l2_reg"]
    metrics["total"] = total
    metrics["_n_valid"] = (valid.sum() if valid is not None else
                           torch.tensor(float(outputs["state"].shape[0]),
                                        device=target_obs.device))
    return total, metrics


def recompose_epoch_means(cfg: SRLConfig,
                          means: Dict[str, float]) -> Dict[str, float]:
    """Rebuild ``total`` of an epoch from its exactly averaged components,
    with the arithmetic compute_total_loss uses per batch."""
    out = dict(means)
    total = 0.0
    for name, w in cfg.loss_dict.items():
        if name in out:
            total += w * out[name]
    if cfg.l1_reg > 0 and "l1_reg" in out:
        total += cfg.l1_reg * out["l1_reg"]
    if cfg.l2_reg > 0 and "l2_reg" in out:
        total += cfg.l2_reg * out["l2_reg"]
    out["total"] = float(total)
    return out
