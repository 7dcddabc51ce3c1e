"""CNNDecoder and DenseDecoder (port of ``srl_zoo_tpu/models/decoders.py``).

CNNDecoder:

    Dense(state slice -> (H/32)(W/32)64) -> relu -> reshape NHWC
    4 x [ConvTranspose(4, stride 2) -> BatchNorm -> relu], widths 64 64 32 16
    ConvTranspose(4, stride 2) to the image channels -> tanh

flax's ConvTranspose (``transpose_kernel=False``, SAME padding) dilates the
input by the stride, pads it by (2, 2) and *correlates* it with the kernel
as stored (``srl_zoo_tpu/ops/subpixel.py``). torch's ConvTranspose2d with
``padding=1`` dilates and pads by k - 1 - 1 = 2 as well, but correlates
with the spatially *flipped* kernel, in (in, out, kh, kw) layout. So the
two agree when the torch weight is the flax kernel (kh, kw, in, out)
permuted to (in, out, kh, kw) and flipped on both spatial axes
(:func:`deconv_weight_from_flax`); both give 2H x 2W. The deconvolutions
keep their bias, as flax's do by default.

``deconv`` selects how each deconvolution runs, as the JAX module's field
of that name does: "conv_transpose" (the default, cuDNN's transposed
convolution) or "subpixel" (one stride-1 convolution and a depth-to-space,
ops/subpixel.py). Both read the same ConvTranspose2d weight and bias, so
one state dict loads into either; PERF.md §6 records them against each
other on the card, and tests/test_torch_zoo_card_kernels.py holds them
to each other there. On "conv_transpose", the last deconvolution with its
bias and tanh runs as one hand-written kernel each way
(ops/deconv_out.py) wherever its input and layer take it (``fits``: a
CUDA float32 input, at most 8 output and 64 input channels); the CPU,
float64 reference runs and wider layers keep the layer and ``torch.tanh``.

DenseDecoder, the decoder of the mlp and linear model types:

    Dense(state slice -> 64) -> relu -> Dense(64 -> H W C) -> reshape NHWC
    -> tanh

Both outputs are NCHW in channels_last memory; ``.permute(0, 2, 3, 1)`` is
their NHWC view, the layout of the reconstruction target. At the compute
dtype bfloat16 (models/precision.py) the Dense layers and deconvolutions
but the last run in bfloat16, CNNDecoder's BatchNorms return bfloat16, and
each decoder's last layer (ConvTranspose_4, Dense_1) promotes its input to
float32, as the JAX modules build it: the reconstruction is float32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from srl_zoo_tpu_torch.models.batchnorm import BatchNorm
from srl_zoo_tpu_torch.models.mlp import MLP
from srl_zoo_tpu_torch.models.precision import at_least_f32, dense
from srl_zoo_tpu_torch.models.precision import deconv as conv_transpose
from srl_zoo_tpu_torch.ops import deconv_out
from srl_zoo_tpu_torch.ops.subpixel import subpixel_deconv

WIDTHS = (64, 64, 32, 16)
SEED_CHANNELS = 64
# the formulations of a deconvolution, each (layer, x, compute dtype) -> y
DECONVS = {"conv_transpose": conv_transpose, "subpixel": subpixel_deconv}


def deconv_weight_from_flax(kernel: torch.Tensor) -> torch.Tensor:
    """flax ConvTranspose kernel (kh, kw, in, out) -> ConvTranspose2d
    weight (in, out, kh, kw), flipped on both spatial axes."""
    return kernel.permute(2, 3, 0, 1).flip(2, 3).contiguous()


class CNNDecoder(nn.Module):
    def __init__(self, in_dim: int, img_height: int, img_width: int,
                 out_channels: int = 3, bn_momentum: float = 0.9,
                 dtype: Optional[torch.dtype] = None,
                 deconv: str = "conv_transpose"):
        super().__init__()
        if deconv not in DECONVS:
            raise ValueError(f"deconv must be one of {tuple(DECONVS)}, "
                             f"got {deconv!r}")
        self.compute_dtype = dtype
        self._deconv = DECONVS[deconv]
        self.h0, self.w0 = img_height // 32, img_width // 32
        if self.h0 * 32 != img_height or self.w0 * 32 != img_width:
            raise ValueError("CNNDecoder needs image sides divisible by 32, "
                             f"got {img_height}x{img_width}")
        self.fc = nn.Linear(in_dim, self.h0 * self.w0 * SEED_CHANNELS)
        self.deconvs = nn.ModuleList()
        self.bns = nn.ModuleList()
        c = SEED_CHANNELS
        for width in WIDTHS:
            self.deconvs.append(nn.ConvTranspose2d(c, width, 4, stride=2,
                                                   padding=1))
            self.bns.append(BatchNorm(width, bn_momentum))
            c = width
        self.deconvs.append(nn.ConvTranspose2d(c, out_channels, 4, stride=2,
                                               padding=1))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, d) -> reconstruction (B, C, H, W), channels_last, in
        [-1, 1]."""
        dt = self.compute_dtype
        x = torch.relu(dense(self.fc, z, dt))
        # flax reshapes to NHWC: the NCHW view of that is channels_last
        x = x.reshape(z.shape[0], self.h0, self.w0, SEED_CHANNELS
                      ).permute(0, 3, 1, 2)
        for layer, bn in zip(self.deconvs, self.bns):
            x = torch.relu(bn(self._deconv(layer, x, dt)))
        x, last = at_least_f32(x), self.deconvs[-1]
        if self._deconv is conv_transpose and deconv_out.fits(last, x):
            return deconv_out.deconv_out_tanh(x, last.weight, last.bias)
        return torch.tanh(self._deconv(last, x, None))


class DenseDecoder(MLP):
    def __init__(self, in_dim: int, img_height: int, img_width: int,
                 out_channels: int = 3, hidden: int = 64,
                 dtype: Optional[torch.dtype] = None):
        super().__init__([in_dim, hidden,
                          img_height * img_width * out_channels], dtype)
        self.shape = (img_height, img_width, out_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, d) -> reconstruction (B, C, H, W), channels_last, in
        [-1, 1]."""
        x = super().forward(z).reshape(z.shape[0], *self.shape)
        return torch.tanh(x).permute(0, 3, 1, 2)
