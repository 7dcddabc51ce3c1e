"""Loss functions (port of ``srl_zoo_tpu/losses/functions.py``) for the
objectives the port trains: the autoencoder's pixel MSE and the l1/l2
parameter regularizers. The reductions are the JAX package's: a mean over
each sample's elements, then a mean over the valid rows of the batch.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (values * mask).sum() / mask.sum().clamp_min(1.0)


def _batch_mean(per_sample: torch.Tensor,
                valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over the batch axis, over the valid rows when a mask is given
    (the padded rows of a partial eval batch must not count)."""
    if valid is None:
        return per_sample.mean()
    return _masked_mean(per_sample, valid)


def mse(a: torch.Tensor, b: torch.Tensor,
        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    sq = (a.float() - b.float()).square()
    return _batch_mean(sq.reshape(sq.shape[0], -1).mean(dim=1), valid)


def autoencoder_loss(recon: torch.Tensor, target: torch.Tensor,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pixel MSE between the reconstruction and the clean normalized
    frame (reference: autoEncoderLoss)."""
    return mse(recon, target, valid)


def l1_regularization(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """Mean |p| over every element of every parameter (not the buffers:
    the JAX ``params`` tree holds no BatchNorm statistics). |p| is taken
    as ``where(p >= 0, p, -p)``: its gradient at 0 is 1, as ``jnp.abs``'s
    is, where ``torch.abs``'s is 0. The zero-initialized biases then get
    the same first update in both packages."""
    params = list(params)
    total = sum(torch.where(p >= 0, p, -p).sum() for p in params)
    return total / sum(p.numel() for p in params)


def l2_regularization(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """Mean p^2 over every element of every parameter."""
    params = list(params)
    total = sum(p.square().sum() for p in params)
    return total / sum(p.numel() for p in params)
