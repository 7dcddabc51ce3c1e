"""Heads on state slices (port of ``srl_zoo_tpu/models/heads.py``
``ForwardModel``, ``InverseModel``, ``RewardModel`` and the episode
prior's ``Discriminator``).

Each head is a stack of Dense layers with relu between them; ``layers.i``
is the JAX head's ``Dense_i``. The input widths, which flax infers at its
first call, are given here from the loss's state slice.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class _MLP(nn.Module):
    def __init__(self, widths: Sequence[int]):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(widths, widths[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)


class ForwardModel(_MLP):
    """(state slice, one-hot action) -> next state slice; ``mlp`` adds a
    64-wide hidden layer."""

    def __init__(self, state_dim: int, n_actions: int, mlp: bool = False):
        super().__init__([state_dim + n_actions] + ([64] if mlp else [])
                         + [state_dim])
        self.n_actions = n_actions

    def forward(self, state: torch.Tensor,
                action: torch.Tensor) -> torch.Tensor:
        a = F.one_hot(action.long(), self.n_actions).to(state.dtype)
        return super().forward(torch.cat([state, a], dim=-1))


class _PairHead(_MLP):
    def forward(self, state: torch.Tensor,
                next_state: torch.Tensor) -> torch.Tensor:
        return super().forward(torch.cat([state, next_state], dim=-1))


class InverseModel(_PairHead):
    """(state slice, next state slice) -> action logits; ``mlp`` adds a
    128-wide hidden layer."""

    def __init__(self, state_dim: int, n_actions: int, mlp: bool = False):
        super().__init__([2 * state_dim] + ([128] if mlp else [])
                         + [n_actions])


class RewardModel(_PairHead):
    """(state slice, next state slice) -> reward-class logits, two hidden
    layers of 64."""

    def __init__(self, state_dim: int, n_reward_classes: int):
        super().__init__([2 * state_dim, 64, 64, n_reward_classes])


class Discriminator(_PairHead):
    """(state slice, state slice) -> (B,) logits that the two states come
    from one episode, two hidden layers of 64."""

    def __init__(self, state_dim: int):
        super().__init__([2 * state_dim, 64, 64, 1])

    def forward(self, s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
        return super().forward(s1, s2)[..., 0]
