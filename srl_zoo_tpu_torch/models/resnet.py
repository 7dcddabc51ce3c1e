"""ResNet-18 encoder (port of ``srl_zoo_tpu/models/resnet.py`` ResNet18).

    stem: conv 7x7/2 pads (3, 3), 64 -> BatchNorm -> relu + max-pool 3x3/2
          pads (1, 1)
    layer1..layer4: two BasicBlocks each, widths 64 128 256 512; the first
          block of layers 2-4 has stride 2 and a 1x1/2 conv + BatchNorm
          shortcut (``downsample``)
    global mean over H and W -> fc to ``state_dim``

The modules carry torchvision's names and layouts (``conv1``, ``bn1``,
``layer{1..4}.{0,1}.conv1/bn1/conv2/bn2/downsample.{0,1}``, ``fc``), so a
torchvision ``resnet18`` state dict loads key for key
(models/torch_port.py). BatchNorm takes the flax momentum convention
(models/batchnorm.py). The pads are torch's explicit ones, as in the JAX
module: the stem pool's (1, 1) is not XLA's 'SAME', which at 112 px pads
(0, 1) and gives the same 56 x 56 output from other windows.

The JAX package runs its stem either as the 7x7/2 conv ("direct") or as the
same convolution regrouped space-to-depth for the TPU's matrix unit
("s2d"), both from one ``Conv_0/kernel``; the port runs the direct conv for
either. Activations stay channels_last in memory, so the stem pool (the
fused relu + pool kernel, ops/fused_pool.py) reads the BatchNorm output in
place.

At the compute dtype bfloat16 (models/precision.py) every convolution
casts its input and kernel, BatchNorm returns bfloat16, the residual sum,
the stem pool and the global mean run on bfloat16, and ``fc`` promotes its
input to float32, as the JAX module's ``dtype=jnp.float32`` Dense does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from srl_zoo_tpu_torch.models.batchnorm import BatchNorm
from srl_zoo_tpu_torch.models.precision import conv, dense_f32
from srl_zoo_tpu_torch.ops.fused_pool import relu_max_pool

STEM_POOL_PADS = ((1, 1), (1, 1))
WIDTHS = (64, 128, 256, 512)
BLOCKS_PER_LAYER = 2


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, width: int, stride: int,
                 bn_momentum: float = 0.9,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, width, 3, stride=stride,
                               padding=1, bias=False)
        self.bn1 = BatchNorm(width, bn_momentum)
        self.conv2 = nn.Conv2d(width, width, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(width, bn_momentum)
        # the JAX block adds a shortcut conv where the shape changes, which
        # in ResNet-18 is where the width does
        self.downsample = nn.Sequential(
            nn.Conv2d(in_channels, width, 1, stride=stride, bias=False),
            BatchNorm(width, bn_momentum)) if in_channels != width else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.relu(self.bn1(conv(self.conv1, x, dt)))
        y = self.bn2(conv(self.conv2, y, dt))
        residual = x if self.downsample is None else self.downsample[1](
            conv(self.downsample[0], x, dt))
        return F.relu(y + residual)


class ResNet18(nn.Module):
    def __init__(self, state_dim: int, in_channels: int = 3,
                 bn_momentum: float = 0.9,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, WIDTHS[0], 7, stride=2,
                               padding=3, bias=False)
        self.bn1 = BatchNorm(WIDTHS[0], bn_momentum)
        c = WIDTHS[0]
        for i, width in enumerate(WIDTHS):
            blocks = []
            for b in range(BLOCKS_PER_LAYER):
                stride = 2 if i > 0 and b == 0 else 1
                blocks.append(BasicBlock(c, width, stride, bn_momentum,
                                         dtype))
                c = width
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(c, state_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: normalized float (B, H, W, C) -> (B, state_dim). The stem pool
        is differentiable (ops/fused_pool.py): in training its backward
        reads the forward's argmax plane."""
        x = self.bn1(conv(self.conv1, x.permute(0, 3, 1, 2),
                          self.compute_dtype))
        y = relu_max_pool(x.permute(0, 2, 3, 1).contiguous(),
                          padding=STEM_POOL_PADS)
        x = y.permute(0, 3, 1, 2)
        for i in range(len(WIDTHS)):
            x = getattr(self, f"layer{i + 1}")(x)
        return dense_f32(self.fc, x.mean(dim=(2, 3)))
