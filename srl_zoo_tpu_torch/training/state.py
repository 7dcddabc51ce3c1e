"""The model and optimizer a run trains (port of
``srl_zoo_tpu/training/state.py``).

``make_model`` builds SRLModules with flax's initialization drawn from a
``torch.Generator`` seeded with the config's seed, channels_last on the
device. ``make_optimizer`` is optax's ``adam(lr, b1=0.9, b2=0.999,
eps=1e-8)``, which torch's Adam computes up to rounding: both divide the
bias-corrected first moment by sqrt of the bias-corrected second moment
plus eps. With ``--episode-prior-optimizer separate`` the discriminator's
parameters get an Adam of their own (optax's ``multi_transform``); Adam
is elementwise, so the two modes give equal updates. With ``--grad-accum
k`` the Adams step once every k micro-steps with the mean of their
gradients (optax's ``MultiSteps``).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from srl_zoo_tpu_torch.config import SRLConfig
from srl_zoo_tpu_torch.models.init import init_like_flax_
from srl_zoo_tpu_torch.models.srl_modules import SRLModules


def make_model(cfg: SRLConfig, device: torch.device) -> SRLModules:
    model = SRLModules(cfg)
    init_like_flax_(model, torch.Generator().manual_seed(cfg.seed))
    return model.to(device=device, memory_format=torch.channels_last)


class AccumulatingAdam:
    """One Adam over the model's parameters, or two (``discriminator.*``
    and the rest), stepped every ``grad_accum`` micro-steps.

    ``backward(total)`` adds the gradient of ``total / grad_accum`` to
    each ``.grad``, so after k micro-steps ``.grad`` holds the mean of
    their gradients (optax's running mean, to rounding). ``step()`` counts
    the micro-step on the host, and on the k-th steps the Adams and clears
    the gradients: the parameters and Adam's own step count move only
    then, and the decision reads nothing from the device. The count and
    the accumulated gradients carry across epochs and, through
    ``state_dict``, across a resume."""

    def __init__(self, cfg: SRLConfig, model: torch.nn.Module):
        named = list(model.named_parameters())
        self.params = [p for _, p in named]
        groups: List[list] = [self.params]
        if cfg.use_episode_prior and cfg.episode_prior_optimizer == \
                "separate":
            disc = [n.startswith("discriminator.") for n, _ in named]
            groups = [[p for (_, p), d in zip(named, disc) if not d],
                      [p for (_, p), d in zip(named, disc) if d]]
        self.adams = [torch.optim.Adam(g, lr=cfg.learning_rate,
                                       betas=(0.9, 0.999), eps=1e-8)
                      for g in groups]
        self.every = cfg.grad_accum
        self.micro_step = 0

    def backward(self, total: torch.Tensor) -> None:
        (total / self.every if self.every > 1 else total).backward()

    def step(self) -> bool:
        """Count a micro-step; on the k-th, step the Adams and clear the
        gradients. Returns whether the parameters moved."""
        self.micro_step += 1
        if self.micro_step < self.every:
            return False
        for adam in self.adams:
            adam.step()
            adam.zero_grad(set_to_none=True)
        self.micro_step = 0
        return True

    def state_dict(self) -> Dict:
        """Each Adam's state, the micro-step count and, between two
        steps, the accumulated gradients (in the model's parameter
        order)."""
        return {"adams": [a.state_dict() for a in self.adams],
                "micro_step": self.micro_step,
                "grads": [p.grad for p in self.params]
                if self.micro_step else []}

    def load_state_dict(self, state: Dict) -> None:
        if len(state["adams"]) != len(self.adams):
            raise ValueError(f"{len(state['adams'])} Adam states for "
                             f"{len(self.adams)} Adams")
        for adam, s in zip(self.adams, state["adams"]):
            adam.load_state_dict(s)
        self.micro_step = int(state["micro_step"])
        grads = state["grads"] or [None] * len(self.params)
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} accumulated gradients for "
                             f"{len(self.params)} parameters")
        for p, g in zip(self.params, grads):
            p.grad = None if g is None else g.to(p.device)


def make_optimizer(cfg: SRLConfig, model: torch.nn.Module
                   ) -> AccumulatingAdam:
    return AccumulatingAdam(cfg, model)
