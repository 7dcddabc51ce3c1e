"""CNNDecoder (port of ``srl_zoo_tpu/models/decoders.py`` CNNDecoder).

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

The output is NCHW in channels_last memory; ``.permute(0, 2, 3, 1)`` is its
NHWC view, the layout of the reconstruction target.
"""

from __future__ import annotations

import torch
from torch import nn

from srl_zoo_tpu_torch.models.batchnorm import BatchNorm

WIDTHS = (64, 64, 32, 16)
SEED_CHANNELS = 64


def deconv_weight_from_flax(kernel: torch.Tensor) -> torch.Tensor:
    """flax ConvTranspose kernel (kh, kw, in, out) -> ConvTranspose2d
    weight (in, out, kh, kw), flipped on both spatial axes."""
    return kernel.permute(2, 3, 0, 1).flip(2, 3).contiguous()


class CNNDecoder(nn.Module):
    def __init__(self, in_dim: int, img_height: int, img_width: int,
                 out_channels: int = 3, bn_momentum: float = 0.9):
        super().__init__()
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
        x = torch.relu(self.fc(z))
        # flax reshapes to NHWC: the NCHW view of that is channels_last
        x = x.reshape(z.shape[0], self.h0, self.w0, SEED_CHANNELS
                      ).permute(0, 3, 1, 2)
        for deconv, bn in zip(self.deconvs, self.bns):
            x = torch.relu(bn(deconv(x)))
        return torch.tanh(self.deconvs[-1](x))
