"""Image encoders (port of ``srl_zoo_tpu/models/encoders.py``): CustomCNN,
DenseEncoder, LinearEncoder and the ``make_encoder`` factory of
``--model-type`` (custom_cnn, resnet, mlp, linear; ResNet-18 is in
models/resnet.py). Each takes the compute dtype of ``--dtype``
(models/precision.py): bfloat16 or None (float32).

CustomCNN:

Three blocks of [conv 64, kernel 7/3/3, stride 2, no bias -> BatchNorm
(flax momentum ``bn_momentum``) -> relu + 3x3/2 max-pool], flatten, Dense
to ``state_dim``. Two details keep the JAX weights lined up:

* XLA 'SAME' pads are asymmetric (at 224 px the 7x7 conv pads (2, 3)), which
  ``conv2d(padding=)`` cannot express, so they are applied with ``F.pad``.
  The pool takes its SAME pads itself (ops/fused_pool.py).
* The flatten runs in NHWC order (H, W, C), the order of flax's reshape.

Activations stay channels_last in memory: the NHWC view that the fused
relu + pool kernel reads is then the conv output itself, with no copy. In
bfloat16 the convolutions cast their input and kernel, BatchNorm takes
the bfloat16 conv output (models/batchnorm.py) and returns bfloat16, the
pools run on bfloat16, and the Dense promotes its input to float32.

DenseEncoder (flatten -> Dense 64 -> relu -> Dense 64 -> relu -> Dense
``state_dim``) and LinearEncoder (flatten -> Dense ``state_dim``) flatten
the NHWC frame in (H, W, C) order, flax's reshape, which is the input's
own memory order. Their hidden layers compute at the compute dtype and
the last Dense in float32 (models/mlp.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from srl_zoo_tpu_torch.models.batchnorm import BatchNorm
from srl_zoo_tpu_torch.models.mlp import MLP
from srl_zoo_tpu_torch.models.precision import cast, conv, dense_f32
from srl_zoo_tpu_torch.models.resnet import ResNet18
from srl_zoo_tpu_torch.ops.fused_pool import relu_max_pool, same_pads

KERNEL_SIZES = (7, 3, 3)
WIDTH = 64
DENSE_HIDDEN = (64, 64)


def flat_features(img_height: int, img_width: int) -> int:
    """Dense input width: each conv and each pool divides H and W by 2."""
    h, w = img_height, img_width
    for _ in range(2 * len(KERNEL_SIZES)):
        h, w = -(-h // 2), -(-w // 2)
    return h * w * WIDTH


class CustomCNN(nn.Module):
    def __init__(self, state_dim: int, in_channels: int, img_height: int,
                 img_width: int, bn_momentum: float = 0.9,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
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
        dt = self.compute_dtype
        # NCHW view of channels_last memory
        x = cast(x, dt).permute(0, 3, 1, 2)
        for layer, bn, k in zip(self.convs, self.bns, KERNEL_SIZES):
            (t, b), (l, r) = (same_pads(x.shape[2], k, 2),
                              same_pads(x.shape[3], k, 2))
            x = bn(conv(layer, F.pad(x, (l, r, t, b)), dt))
            y = relu_max_pool(x.permute(0, 2, 3, 1).contiguous())
            x = y.permute(0, 3, 1, 2)
        return dense_f32(self.fc, y.reshape(y.shape[0], -1))


class DenseEncoder(MLP):
    """flatten -> two relu Dense layers of 64 -> Dense ``state_dim``."""

    def __init__(self, state_dim: int, in_features: int,
                 dtype: Optional[torch.dtype] = None,
                 hidden: Sequence[int] = DENSE_HIDDEN):
        super().__init__([in_features, *hidden, state_dim], dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: normalized float (B, H, W, C) -> (B, state_dim)."""
        return super().forward(x.reshape(x.shape[0], -1))


class LinearEncoder(DenseEncoder):
    """flatten -> Dense ``state_dim``: no hidden layer, so float32 whatever
    the compute dtype (the JAX module's one Dense is its last)."""

    def __init__(self, state_dim: int, in_features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(state_dim, in_features, dtype, hidden=())


def make_encoder(model_type: str, state_dim: int, in_channels: int,
                 img_height: int, img_width: int, bn_momentum: float = 0.9,
                 dtype: Optional[torch.dtype] = None) -> nn.Module:
    """The encoder of a ``--model-type``: NHWC frames -> (B, state_dim),
    computing at ``dtype`` (None: float32)."""
    if model_type == "custom_cnn":
        return CustomCNN(state_dim, in_channels, img_height, img_width,
                         bn_momentum, dtype)
    if model_type == "resnet":
        return ResNet18(state_dim, in_channels, bn_momentum, dtype)
    pixels = img_height * img_width * in_channels
    if model_type == "mlp":
        return DenseEncoder(state_dim, pixels, dtype)
    if model_type == "linear":
        return LinearEncoder(state_dim, pixels, dtype)
    raise ValueError(f"Unknown model type: {model_type}")
