"""BatchNorm of the port's models (port of
``srl_zoo_tpu/models/batchnorm.py``).

The JAX class is torch-exact by design: in train mode it normalizes with
the biased batch variance and folds the unbiased one into the running
variance, with eps 1e-5. That is ``nn.BatchNorm2d`` itself. Only the
momentum convention differs: the JAX package takes flax's (ra = m*ra +
(1-m)*batch), torch the complement, so flax 0.9 is torch 0.1 and a config
recorded before the ``bn-momentum`` key existed (flax 0.99) is torch 0.01.
"""

from __future__ import annotations

from torch import nn


class BatchNorm(nn.BatchNorm2d):
    def __init__(self, num_features: int, flax_momentum: float = 0.9):
        super().__init__(num_features, eps=1e-5, momentum=1.0 - flax_momentum)
