"""BatchNorm of the port's models (port of
``srl_zoo_tpu/models/batchnorm.py``).

The JAX class is torch-exact by design: in train mode it normalizes with
the biased batch variance and folds the unbiased one into the running
variance, with eps 1e-5. That is ``nn.BatchNorm2d`` itself. Only the
momentum convention differs: the JAX package takes flax's (ra = m*ra +
(1-m)*batch), torch the complement, so flax 0.9 is torch 0.1 and a config
recorded before the ``bn-momentum`` key existed (flax 0.99) is torch 0.01.

At the compute dtype bfloat16 the input is the bfloat16 conv output, and
the parameters and running statistics stay float32. flax (0.12, its
``force_float32_reductions``) then takes the batch statistics in float32
from the bfloat16 input, computes ``(x - mean) * rsqrt(var + eps) * scale
+ bias`` in float32 and rounds to bfloat16 once. ``nn.BatchNorm2d`` takes
that mixed input on the CPU and on CUDA and does the same: float32
statistics and arithmetic, a bfloat16 output in the input's memory format
(channels_last stays channels_last), float32 running statistics.

In a process group (parallel/mesh.py) each rank holds B/world rows of the
global batch, and JAX's BatchNorm over a sharded batch takes its train-mode
statistics over the global batch. So does this one there: the mean is the
sum over the ranks of the rows' sums over the global count, then the
variance the same of the squared deviations from it (two passes, as
``nn.BatchNorm2d`` computes it), one all-reduce each; the running
statistics take the global ones. Its backward is written out (the
gradient of batch normalization through global statistics), so that it
takes one all-reduce, of the per-channel sums of dy and dy * xhat, and a
few whole-tensor passes, where autograd through the forward's operators
took two all-reduces and a pass per operator.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.autograd.function import once_differentiable

from srl_zoo_tpu_torch.models.precision import at_least_f32
from srl_zoo_tpu_torch.parallel import mesh


def _c(t: torch.Tensor) -> torch.Tensor:
    """A per-channel (C,) tensor as (1, C, 1, 1)."""
    return t[None, :, None, None]


class _GlobalBatchNorm(torch.autograd.Function):
    """(y, mean, biased variance) of train-mode batch normalization of
    this rank's NCHW rows ``x`` by the statistics of the global batch of
    ``n`` rows' elements a channel."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, n):
        dims = (0, 2, 3)
        mean = mesh.all_reduce_sum(x.sum(dims)) / n
        xhat = x - _c(mean)
        var = mesh.all_reduce_sum(xhat.square().sum(dims)) / n
        invstd = torch.rsqrt(var + eps)
        xhat.mul_(_c(invstd))
        ctx.save_for_backward(xhat, invstd, weight)
        ctx.n = n
        ctx.mark_non_differentiable(mean, var)
        return torch.addcmul(_c(bias), xhat, _c(weight)), mean, var

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, _mean, _var):
        xhat, invstd, weight = ctx.saved_tensors
        dims = (0, 2, 3)
        # this rank's sums are its parameters' gradients; the input's
        # gradient reads the global batch's
        db = dy.sum(dims)
        dw = (dy * xhat).sum(dims)
        means = mesh.all_reduce_sum(torch.cat([db, dw])) / ctx.n
        c = weight.shape[0]
        dx = (dy - _c(means[:c]) - xhat * _c(means[c:])) \
            * _c(weight * invstd)
        return dx, dw, db, None, None


class BatchNorm(nn.BatchNorm2d):
    def __init__(self, num_features: int, flax_momentum: float = 0.9):
        super().__init__(num_features, eps=1e-5, momentum=1.0 - flax_momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and mesh.active()):
            return super().forward(x)
        return self._global_batch_norm(x)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        xf = at_least_f32(x)
        n = xf.numel() // xf.shape[1] * mesh.world()
        y, mean, var = _GlobalBatchNorm.apply(xf, self.weight, self.bias,
                                              self.eps, n)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), m)
            self.running_var.lerp_((var * (n / max(n - 1, 1))).to(
                self.running_var.dtype), m)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)
