"""A stack of Dense layers with relu between them (the shape of the JAX
package's heads, ``DenseEncoder``, ``LinearEncoder`` and ``DenseDecoder``).

``layers.i`` is the JAX module's ``Dense_i``. The hidden layers compute at
the model's compute dtype (models/precision.py) and the last one in
float32, as each JAX module builds its last Dense with
``dtype=jnp.float32``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from srl_zoo_tpu_torch.models.precision import dense, dense_f32


class MLP(nn.Module):
    def __init__(self, widths: Sequence[int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(widths, widths[1:]))
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.relu(dense(layer, x, self.compute_dtype))
        return dense_f32(self.layers[-1], x)
