"""The compute dtype of the port's layers (the ``dtype`` field of the JAX
package's flax modules, set by ``--dtype``).

A flax layer built with ``dtype=bfloat16`` casts its input and its float32
parameters to bfloat16, computes, and returns bfloat16; a Dense adds its
bias after the product is rounded, so the result is rounded twice. A layer
built with ``dtype=float32`` (each model's last Dense, the decoder's last
deconvolution) promotes a bfloat16 input to float32. The port casts at the
same places, explicitly: ``torch.autocast`` would pick other operations
(BatchNorm in float32, the last Dense in bfloat16) and compute another
function. Parameters, their gradients (the backward of a cast returns the
parameter's dtype), Adam's state and checkpoints stay float32.

A compute dtype of None is the float32 configuration: each layer computes
in its input's dtype, so a model moved to float64 (a reference run) stays
float64 throughout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def compute_dtype(name: str) -> Optional[torch.dtype]:
    """The ``compute-dtype`` of a config as the dtype its layers cast to:
    bfloat16, or None for float32."""
    return torch.bfloat16 if name == "bfloat16" else None


def cast(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` at a layer's compute dtype (unchanged for None)."""
    return x if dtype is None else x.to(dtype)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """A float32 layer's input: half types go up, float64 stays."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)`` with ``layer``'s parameters: at a
    half dtype the product is rounded, then the bias is added and the sum
    rounded again (``F.linear`` with a bias may round once)."""
    if dtype is None:
        return layer(x)
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + \
        layer.bias.to(dtype)


def dense_f32(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Dense(dtype=float32)``: a half input promoted."""
    return layer(at_least_f32(x))


def conv(layer: nn.Conv2d, x: torch.Tensor,
         dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A bias-free ``nn.Conv(dtype=dtype)``: input and kernel cast."""
    if dtype is None:
        return layer(x)
    return layer._conv_forward(x.to(dtype), layer.weight.to(dtype), None)


def deconv(layer: nn.ConvTranspose2d, x: torch.Tensor,
           dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax ``nn.ConvTranspose(dtype=dtype)`` with a bias, as ``dense``:
    at a half dtype the bias is added after the rounded product."""
    if dtype is None:
        return layer(x)
    y = F.conv_transpose2d(x.to(dtype), layer.weight.to(dtype), None,
                           layer.stride, layer.padding)
    return y + layer.bias.to(dtype).view(1, -1, 1, 1)
