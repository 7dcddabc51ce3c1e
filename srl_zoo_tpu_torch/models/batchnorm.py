"""BatchNorm of the port's encoders, eval mode only.

Port of ``srl_zoo_tpu/models/batchnorm.py`` for inference: normalization by
the running statistics with eps 1e-5, which is ``nn.BatchNorm2d``'s eval
forward. The reference's BN is torch-exact in train mode as well (running
var folds the unbiased batch variance, momentum 0.9 on the flax convention
= torch's 0.1); that, and the momentum of configs recorded before it, waits
for the training slice, so train mode raises here.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.BatchNorm2d):
    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm is not ported yet (ROADMAP.md queue A, "
                "training slice); call .eval() on the model")
        return super().forward(x)
