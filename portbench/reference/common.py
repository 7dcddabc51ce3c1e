"""Pieces every plain reference shares: float32 without TF32, the frames'
"tf" normalization, train- and eval-mode batch normalization, XLA's SAME
pads, relu + 3x3/2 max-pool and optax's Adam, written out in plain
PyTorch. Nothing here imports the port or JAX.

Weights come in as a dict of named tensors, named and laid out as the
port's ``state_dict`` (the benchmark makes them once from the seed and
hands the same dict to both sides): a Conv2d weight (out, in, kh, kw), a
Linear weight (out, in), BatchNorm's weight, bias, running_mean and
running_var.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def strict_float32() -> None:
    """float32 products and convolutions in full float32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def normalize_tf(frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, C) -> float32 in [-1, 1]: x * 2/255 - 1."""
    return frames_u8.float() * (2.0 / 255.0) - 1.0


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA 'SAME' (lo, hi) pads of one axis: out = ceil(size / s)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def batch_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str,
               train: bool) -> torch.Tensor:
    """NCHW batch normalization: the batch's biased statistics in train
    mode, the running ones in eval mode; eps 1e-5."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = (x - mean[None, :, None, None]).square().mean(dim=(0, 2, 3))
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    inv = torch.rsqrt(var + BN_EPS)
    return ((x - mean[None, :, None, None]) * inv[None, :, None, None]
            * p[f"{name}.weight"][None, :, None, None]
            + p[f"{name}.bias"][None, :, None, None])


def relu_max_pool(x: torch.Tensor, pads) -> torch.Tensor:
    """relu, then a 3x3 stride-2 max-pool of NCHW ``x`` with pads
    ((top, bottom), (left, right)) that no window maximum can come from."""
    (t, b), (l, r) = pads
    xp = F.pad(torch.relu(x), (l, r, t, b), value=-math.inf)
    return F.max_pool2d(xp, kernel_size=3, stride=2)


def dense(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str
          ) -> torch.Tensor:
    return x @ p[f"{name}.weight"].t() + p[f"{name}.bias"]


def adam_steps(params: Dict[str, torch.Tensor], trainable: List[str],
               loss_fn, steps: List, lr: float) -> Dict[str, object]:
    """optax's ``adam(lr, 0.9, 0.999, eps=1e-8)`` of the ``trainable``
    leaves of ``params`` over ``steps``: ``loss_fn(params, step)`` gives
    a step's scalar loss. Returns the losses, the first step's gradients
    and the trainable leaves after the last step (``params`` itself is
    not changed)."""
    p = {k: params[k].detach().clone().requires_grad_(True)
         for k in trainable}
    fixed = {k: v for k, v in params.items() if k not in p}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first_grads = [], None
    for t, step in enumerate(steps, start=1):
        loss = loss_fn({**fixed, **p}, step)
        grads = torch.autograd.grad(loss, list(p.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p[k]) if g is None else g
                 for k, g in zip(p, grads)}
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, g in grads.items():
                m[k].mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
                v2[k].mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
                mhat = m[k] / (1 - ADAM_B1 ** t)
                vhat = v2[k] / (1 - ADAM_B2 ** t)
                p[k].sub_(lr * mhat / (vhat.sqrt() + ADAM_EPS))
    return {"losses": losses, "grads": first_grads,
            "params": {k: t.detach() for k, t in p.items()}}


def bn_spec(name: str, c: int) -> List[tuple]:
    """Spec entries of one BatchNorm's four tensors."""
    return [(f"{name}.weight", (c,), "bn_weight", 0),
            (f"{name}.bias", (c,), "bn_bias", 0),
            (f"{name}.running_mean", (c,), "bn_mean", 0),
            (f"{name}.running_var", (c,), "bn_var", 0)]


TRAINABLE = ("weight", "bias", "bn_weight", "bn_bias")


def trainable(spec) -> List[str]:
    """The names of a spec's trained tensors (not the running
    statistics)."""
    return [name for name, _, kind, _ in spec if kind in TRAINABLE]
