"""Image encoders (port of ``srl_zoo_tpu/models/encoders.py``): CustomCNN
and the ``make_encoder`` factory of ``--model-type`` (custom_cnn, resnet;
ResNet-18 is in models/resnet.py).

CustomCNN:

Three blocks of [conv 64, kernel 7/3/3, stride 2, no bias -> BatchNorm
(flax momentum ``bn_momentum``) -> relu + 3x3/2 max-pool], flatten, Dense
to ``state_dim``. Two details keep the JAX weights lined up:

* XLA 'SAME' pads are asymmetric (at 224 px the 7x7 conv pads (2, 3)), which
  ``conv2d(padding=)`` cannot express, so they are applied with ``F.pad``.
  The pool takes its SAME pads itself (ops/fused_pool.py).
* The flatten runs in NHWC order (H, W, C), the order of flax's reshape.

Activations stay channels_last in memory: the NHWC view that the fused
relu + pool kernel reads is then the conv output itself, with no copy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from srl_zoo_tpu_torch.models.batchnorm import BatchNorm
from srl_zoo_tpu_torch.models.resnet import ResNet18
from srl_zoo_tpu_torch.ops.fused_pool import relu_max_pool, same_pads

KERNEL_SIZES = (7, 3, 3)
WIDTH = 64


def flat_features(img_height: int, img_width: int) -> int:
    """Dense input width: each conv and each pool divides H and W by 2."""
    h, w = img_height, img_width
    for _ in range(2 * len(KERNEL_SIZES)):
        h, w = -(-h // 2), -(-w // 2)
    return h * w * WIDTH


class CustomCNN(nn.Module):
    def __init__(self, state_dim: int, in_channels: int, img_height: int,
                 img_width: int, bn_momentum: float = 0.9):
        super().__init__()
        self.convs = nn.ModuleList()
        self.bns = nn.ModuleList()
        c = in_channels
        for k in KERNEL_SIZES:
            self.convs.append(nn.Conv2d(c, WIDTH, k, stride=2, bias=False))
            self.bns.append(BatchNorm(WIDTH, bn_momentum))
            c = WIDTH
        self.fc = nn.Linear(flat_features(img_height, img_width), state_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: normalized float (B, H, W, C) -> (B, state_dim). The pools
        are differentiable (ops/fused_pool.py): in training their backward
        reads the forward's argmax plane."""
        x = x.permute(0, 3, 1, 2)  # NCHW view of channels_last memory
        for conv, bn, k in zip(self.convs, self.bns, KERNEL_SIZES):
            (t, b), (l, r) = (same_pads(x.shape[2], k, 2),
                              same_pads(x.shape[3], k, 2))
            x = bn(conv(F.pad(x, (l, r, t, b))))
            y = relu_max_pool(x.permute(0, 2, 3, 1).contiguous())
            x = y.permute(0, 3, 1, 2)
        return self.fc(y.reshape(y.shape[0], -1))


def make_encoder(model_type: str, state_dim: int, in_channels: int,
                 img_height: int, img_width: int,
                 bn_momentum: float = 0.9) -> nn.Module:
    """The encoder of a ``--model-type``: NHWC frames -> (B, state_dim).
    SRLConfig refuses the types that are not ported yet."""
    if model_type == "custom_cnn":
        return CustomCNN(state_dim, in_channels, img_height, img_width,
                         bn_momentum)
    if model_type == "resnet":
        return ResNet18(state_dim, in_channels, bn_momentum)
    raise ValueError(f"Unknown model type: {model_type}")
