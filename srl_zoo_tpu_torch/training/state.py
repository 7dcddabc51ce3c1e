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
gradients (optax's ``MultiSteps``). In a process group the gradients are
averaged over the ranks before each Adam step (``mesh.average_gradients``;
training/train_step.py says why), so every rank's Adams take one step.

On a CUDA device the Adams are ``capturable``: each keeps its step count
on the device and takes its bias corrections there, so that an eager step
and a step captured into a CUDA graph (training/epoch.py) compute one
arithmetic, and the gradients are cleared by ``zero_()``, in place: a
graph reads and writes them at fixed addresses. On the CPU the count
stays a host-side tensor and the gradients are set to None.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from srl_zoo_tpu_torch.config import SRLConfig
from srl_zoo_tpu_torch.models.init import init_like_flax_
from srl_zoo_tpu_torch.models.srl_modules import SRLModules
from srl_zoo_tpu_torch.parallel import mesh


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
        self.capturable = self.params[0].device.type == "cuda"
        self.adams = [torch.optim.Adam(g, lr=cfg.learning_rate,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       capturable=self.capturable)
                      for g in groups]
        self.every = cfg.grad_accum
        self.micro_step = 0

    def backward(self, total: torch.Tensor) -> None:
        (total / self.every if self.every > 1 else total).backward()

    def step(self) -> bool:
        """Count a micro-step; on the k-th, step the Adams and clear the
        gradients. Returns whether the parameters moved."""
        moves = self.advance()
        if moves:
            self.apply()
        return moves

    def advance(self) -> bool:
        """Count a micro-step on the host: whether it is the k-th, on
        which the Adams step (the count then starts again)."""
        self.micro_step += 1
        if self.micro_step < self.every:
            return False
        self.micro_step = 0
        return True

    def apply(self) -> None:
        """Step the Adams on the accumulated gradients and clear them:
        the device work of a stepping micro-step, which a graph captures."""
        self.average_gradients()
        for adam in self.adams:
            adam.step()
        if self.capturable:
            torch._foreach_zero_([p.grad for p in self.params
                                  if p.grad is not None])
        else:
            for adam in self.adams:
                adam.zero_grad(set_to_none=True)

    def average_gradients(self) -> None:
        """The accumulated gradients averaged over the ranks of a process
        group (nothing without one). Every rank calls it before a resume
        checkpoint taken mid-cycle, so that the saved gradients are every
        rank's; averaging again at the step keeps them right."""
        mesh.average_gradients(self.params)

    def state_dict(self) -> Dict:
        """Each Adam's state, the micro-step count and, between two
        steps, the accumulated gradients (in the model's parameter
        order)."""
        return {"adams": [a.state_dict() for a in self.adams],
                "micro_step": self.micro_step,
                "grads": [p.grad for p in self.params]
                if self.micro_step else []}

    def load_state_dict(self, state: Dict) -> None:
        """A state of either form (a capturable Adam's, or a CPU Adam's,
        as a run on the other device or before the runner saved it).
        Adam's own load takes the saved groups' options, ``capturable``
        among them: the Adams keep their own form instead, with each step
        count a float32 scalar on the parameters' device where they are
        capturable and on the host where they are not."""
        if len(state["adams"]) != len(self.adams):
            raise ValueError(f"{len(state['adams'])} Adam states for "
                             f"{len(self.adams)} Adams")
        for adam, s in zip(self.adams, state["adams"]):
            adam.load_state_dict(s)
            for group in adam.param_groups:
                group["capturable"] = self.capturable
                for p in group["params"]:
                    st = adam.state.get(p)
                    if st and "step" in st:
                        st["step"] = st["step"].to(
                            dtype=torch.float32,
                            device=p.device if self.capturable else "cpu")
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
