"""Pairwise squared L2 distances, the (N, M) matrix written out.

Kernel: ``csrc/pairwise.cu``, which replaces the TPU kernel
``srl_zoo_tpu/ops/pairwise.py`` ``_pairwise_pallas`` (``_pairwise_kernel``).
It is bound by float32 operations on the H100 (2*N*M*D multiply-adds); the
source note says how the design meets that.

    out[i, j] = max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0)     (N, M) float32

It feeds the ``full`` neighbour route of ``ops/knn_topk.py``. The formula
cancels for near points, so two correct versions agree to a tolerance
relative to |x_i|^2 + |y_j|^2, not to the distance.
"""

from __future__ import annotations

import torch

from srl_zoo_tpu_torch.ops import _build


def pairwise_sqdist_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in float32."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    xx = (x * x).sum(1, keepdim=True)
    yy = (y * y).sum(1)
    return torch.clamp(xx + yy[None, :] - 2.0 * (x @ y.T), min=0.0)


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x (N, D), y (M, D) -> (N, M) float32 squared distances.

    CUDA tensors launch the kernel; CPU tensors take
    :func:`pairwise_sqdist_plain`; any other device raises."""
    if x.device != y.device:
        raise ValueError(f"pairwise_sqdist: x on {x.device}, y on {y.device}")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"pairwise_sqdist: expected (N, D) and (M, D), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.device.type == "cpu":
        return pairwise_sqdist_plain(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"pairwise_sqdist: no kernel for device {x.device}")
    x = x.to(torch.float32).contiguous()
    y = y.to(torch.float32).contiguous()
    n, d = x.shape
    m = y.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _build.entry("pairwise")(x.data_ptr(), y.data_ptr(),
                                        out.data_ptr(), n, m, d, stream)
    _build.check(code, "pairwise_sqdist")
    pairwise_sqdist.launches += 1
    return out


pairwise_sqdist.launches = 0
