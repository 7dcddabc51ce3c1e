"""flax's default initialization, from an explicit ``torch.Generator``.

torch's default (kaiming-uniform) would train a different model from the
first step. The JAX package's layers use flax's defaults:

* Conv, ConvTranspose and Dense kernels: ``lecun_normal``, i.e. variance
  scaling 1.0 over fan-in with a normal truncated at two standard
  deviations, whose scale is corrected (/0.8796...) so the truncated
  distribution keeps variance 1/fan_in;
* biases: zero;
* BatchNorm: scale 1, bias 0, running mean 0, running var 1.

fan_in is the kernel's receptive field times its input features: k*k*in
for a convolution and for flax's ConvTranspose (kernel (k, k, in, out)),
``in`` for a Dense layer. The ResNet-18 encoder takes the same: its stem
kernel is ``lecun_normal`` explicitly in the JAX module, and its block
convolutions and ``fc`` are flax's default Conv and Dense.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# std of a unit normal truncated to [-2, 2] (flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def init_like_flax_(model: nn.Module, generator: torch.Generator) -> None:
    """Re-initialize every Conv2d, ConvTranspose2d, Linear and BatchNorm2d
    of ``model`` in module order, as flax initializes its layers."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            k = m.kernel_size[0] * m.kernel_size[1]
            lecun_normal_(m.weight, k * m.in_channels, generator)
        elif isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
            continue
        else:
            continue
        if m.bias is not None:
            nn.init.zeros_(m.bias)
