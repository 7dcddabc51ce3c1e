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

``stem`` selects how the stem convolution runs, as the JAX module's field
of that name does, both from the one ``conv1.weight`` (64, C, 7, 7), so
torchvision keys, ``--pretrained-weights`` and the bridge hold for either:

* "direct" (the default): the 7x7/2 convolution, pads (3, 3).
* "s2d": the same convolution on 2x2 space-to-depth cells. The NHWC input
  is regrouped to (B, H/2, W/2, 4C), channel order (ph, pw, c); the
  kernel is padded by one at the front of each spatial axis to 8x8 and
  regrouped to (64, 4C, 4, 4) in the same order; a stride-1 convolution
  with cell pads (2, 1) on each axis then gives the same sums, since
  ``out[i] = sum_u w[u] x[2i + u - 3]`` with ``u + 1 = 2 cell + parity``.
  A side of odd length falls back to the direct convolution, as in JAX.

The JAX package builds its ResNet with "s2d", which fills the TPU's
128-wide contraction where a 3-channel input does not. ``make_encoder``
builds the port's with "direct": on the H100 the choice waits for the
card's own measurement (chip_smoke.py phase 2c, PERF.md §6). Activations
stay channels_last in memory, so the stem pool (the fused relu + pool
kernel, ops/fused_pool.py) reads the BatchNorm output in place.

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
STEMS = ("direct", "s2d")


def s2d_stem(conv1: nn.Conv2d, x: torch.Tensor,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``conv1`` (7x7, stride 2, pads 3, no bias) on NHWC ``x`` (even H
    and W) as a stride-1 convolution over 2x2 cells, at the compute dtype
    ``dtype``; NCHW out, in the input's memory order."""
    b, h, w, c = x.shape
    cells = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    cells = cells.reshape(b, h // 2, w // 2, 4 * c).permute(0, 3, 1, 2)
    f = conv1.weight.shape[0]
    # (F, C, 8, 8) -> (F, C, kh, ph, kw, pw) -> (F, ph, pw, C, kh, kw)
    k = F.pad(conv1.weight, (1, 0, 1, 0)).reshape(f, c, 4, 2, 4, 2)
    k = k.permute(0, 3, 5, 1, 2, 4).reshape(f, 4 * c, 4, 4)
    if dtype is not None:
        cells, k = cells.to(dtype), k.to(dtype)
    return F.conv2d(F.pad(cells, (2, 1, 2, 1)), k)


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
                 dtype: Optional[torch.dtype] = None, stem: str = "direct"):
        super().__init__()
        if stem not in STEMS:
            raise ValueError(f"stem must be one of {STEMS}, got {stem!r}")
        self.compute_dtype = dtype
        self.stem = stem
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
        if self.stem == "s2d" and x.shape[1] % 2 == 0 and \
                x.shape[2] % 2 == 0:
            x = s2d_stem(self.conv1, x, self.compute_dtype)
        else:
            x = conv(self.conv1, x.permute(0, 3, 1, 2), self.compute_dtype)
        x = self.bn1(x)
        y = relu_max_pool(x.permute(0, 2, 3, 1).contiguous(),
                          padding=STEM_POOL_PADS)
        x = y.permute(0, 3, 1, 2)
        for i in range(len(WIDTHS)):
            x = getattr(self, f"layer{i + 1}")(x)
        return dense_f32(self.fc, x.mean(dim=(2, 3)))
