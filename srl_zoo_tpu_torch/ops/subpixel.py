"""The decoder's stride-2 deconvolution as a sub-pixel convolution (port of
``srl_zoo_tpu/ops/subpixel.py``).

``ConvTranspose2d(k=4, stride=2, padding=1)`` with weight W (in, out, 4, 4)
computes, along one axis, ``y[o] = sum over o = 2i - 1 + a of W[a] x[i]``:

    y[2m]     = W[3] x[m-1] + W[1] x[m]
    y[2m + 1] = W[2] x[m]   + W[0] x[m+1]

With K = W flipped (flax's kernel, whose taps correlate as stored) that is
``y[2m] = K0 x[m-1] + K2 x[m]`` and ``y[2m+1] = K1 x[m] + K3 x[m+1]``:
each output parity is a 2-tap correlation over x. Embedded in one 3-tap
kernel over (x[m-1], x[m], x[m+1]) that is ``K_even = [K0, K2, 0]`` and
``K_odd = [0, K1, K3]``; in 2-D the four parities (pi, pj) take the outer
product of those tap maps. So the deconvolution is one stride-1, pad-1
convolution to 4 x out channels, ordered (out, pi, pj), followed by a
depth-to-space (``F.pixel_shuffle(z, 2)``) and the bias per output
channel. It does 9/4 the multiply-adds of the transposed convolution.

The parameter stays the ConvTranspose2d weight and bias: state dicts,
checkpoints and the bridge are the same for both formulations. The
convolution kernel is built from it on every call by slices and pads, in
the weight's dtype, and gradients flow back through them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def subpixel_kernel(weight: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d weight (in, out, 4, 4) -> Conv2d weight
    (4 out, in, 3, 3), output channels ordered (out, pi, pj)."""
    if weight.shape[2:] != (4, 4):
        raise ValueError(f"subpixel_kernel expects a 4x4 kernel, got "
                         f"{tuple(weight.shape)}")
    cin, cout = weight.shape[:2]
    k = weight.flip(2, 3)
    # rows (in, out, pi, a, 4): [K0, K2, 0] and [0, K1, K3]
    k = torch.stack([F.pad(k[:, :, 0::2], (0, 0, 0, 1)),
                     F.pad(k[:, :, 1::2], (0, 0, 1, 0))], dim=2)
    # then columns: (in, out, pi, a, pj, b)
    k = torch.stack([F.pad(k[..., 0::2], (0, 1)),
                     F.pad(k[..., 1::2], (1, 0))], dim=4)
    return k.permute(1, 2, 4, 0, 3, 5).reshape(4 * cout, cin, 3, 3)


def subpixel_deconv(layer: nn.ConvTranspose2d, x: torch.Tensor,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``layer`` (kernel 4, stride 2, padding 1) applied to NCHW ``x`` as a
    sub-pixel convolution, at the compute dtype ``dtype``
    (models/precision.py): the kernel is built at the weight's dtype and
    cast, and the bias is added after the rounded product, as
    ``precision.deconv`` does for ConvTranspose2d."""
    if (layer.kernel_size, layer.stride, layer.padding) != ((4, 4), (2, 2),
                                                            (1, 1)):
        raise NotImplementedError(
            "subpixel_deconv takes the decoder's geometry only (kernel 4, "
            "stride 2, padding 1)")
    k = subpixel_kernel(layer.weight)
    if dtype is not None:
        x, k = x.to(dtype), k.to(dtype)
    z = F.pixel_shuffle(F.conv2d(x, k, padding=1), 2)
    return z + layer.bias.to(z.dtype).view(1, -1, 1, 1)
