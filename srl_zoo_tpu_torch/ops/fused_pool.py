"""Fused relu + 3x3 stride-2 max-pool over NHWC, with an int8 argmax plane.

Kernel: ``csrc/fused_pool.cu``, which replaces the TPU kernel
``srl_zoo_tpu/ops/fused_pool.py`` ``_fwd_pallas`` (``_fwd_kernel``). It is
bound by bytes on the H100 (one read of x, one write of y); the source
note says how the design meets that.

    y   = max_pool_3x3_stride2(relu(x))          NHWC, pads (lo, hi) per axis
    idx = raster position 0..8 of the first window maximum, 9 when the
          window maximum is <= 0 (relu kills the gradient)

The kernel takes float32, bfloat16 and float16, any H and W, and any pads,
including the odd 7x7 pool of CustomCNN at 224 px that the JAX package
sends to XLA. The argmax plane is written only on request: inference
needs none, and the backward of the training slice will read it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from srl_zoo_tpu_torch.ops import _build

SENTINEL = 9
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA 'SAME' (lo, hi) pads of one spatial axis: out = ceil(size/s),
    total = max((out-1)*s + k - size, 0), lo = total // 2."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _resolve_pads(h: int, w: int, padding):
    if padding == "SAME":
        return same_pads(h, 3, 2), same_pads(w, 3, 2)
    (ph, pw) = padding
    return (int(ph[0]), int(ph[1])), (int(pw[0]), int(pw[1]))


def _out_size(size: int, pad) -> int:
    return (size + pad[0] + pad[1] - 3) // 2 + 1


def relu_max_pool_plain(x: torch.Tensor, padding="SAME",
                        with_index: bool = False):
    """Plain PyTorch version of the kernel, NHWC in and out."""
    (pt, pb), (pl, pr) = _resolve_pads(x.shape[1], x.shape[2], padding)
    xp = F.pad(F.relu(x.permute(0, 3, 1, 2)), (pl, pr, pt, pb),
               value=-float("inf"))
    y = F.max_pool2d(xp, kernel_size=3, stride=2)
    if not with_index:
        return y.permute(0, 2, 3, 1).contiguous()
    oh, ow = y.shape[2], y.shape[3]
    idx = torch.full(y.shape, SENTINEL, dtype=torch.int8, device=x.device)
    for k in range(9):  # raster order: the first window maximum wins
        dy, dx = divmod(k, 3)
        v = xp[:, :, dy:dy + 2 * oh - 1:2, dx:dx + 2 * ow - 1:2]
        idx = torch.where((idx == SENTINEL) & (v == y) & (y > 0),
                          torch.tensor(k, dtype=torch.int8,
                                       device=x.device), idx)
    return (y.permute(0, 2, 3, 1).contiguous(),
            idx.permute(0, 2, 3, 1).contiguous())


def relu_max_pool(x: torch.Tensor, padding="SAME", with_index: bool = False):
    """relu then 3x3/2 max pool of an NHWC tensor ``(B, H, W, C)``.

    ``padding`` is "SAME" or ``((top, bottom), (left, right))``. Returns y,
    or ``(y, idx)`` with ``with_index``. A CUDA tensor launches the kernel;
    a CPU tensor takes :func:`relu_max_pool_plain`; any other device
    raises."""
    if x.device.type == "cpu":
        return relu_max_pool_plain(x, padding, with_index)
    if x.device.type != "cuda":
        raise ValueError(f"relu_max_pool: no kernel for device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"relu_max_pool: expected a 4-d float32/bfloat16/"
                         f"float16 NHWC tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        # an NCHW view of a channels_last tensor is contiguous once permuted
        # to NHWC; anything else would be read with the wrong strides
        raise ValueError("relu_max_pool: x must be a contiguous (B, H, W, C) "
                         "tensor (permute a channels_last NCHW tensor with "
                         ".permute(0, 2, 3, 1))")
    b, h, w, c = x.shape
    pads = _resolve_pads(h, w, padding)
    oh, ow = _out_size(h, pads[0]), _out_size(w, pads[1])
    if oh < 1 or ow < 1 or min(pads[0] + pads[1]) < 0 or \
            max(pads[0] + pads[1]) > 2:
        raise ValueError(f"relu_max_pool: unsupported pads {pads} for "
                         f"{h}x{w}")
    y = torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device)
    idx = torch.empty((b, oh, ow, c), dtype=torch.int8, device=x.device) \
        if with_index else None
    if y.numel() == 0:
        return (y, idx) if with_index else y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _build.entry("fused_pool")(
            x.data_ptr(), y.data_ptr(),
            idx.data_ptr() if idx is not None else None,
            _DTYPES[x.dtype], b, h, w, c, oh, ow, pads[0][0], pads[1][0],
            stream)
    _build.check(code, "relu_max_pool")
    relu_max_pool.launches += 1
    return (y, idx) if with_index else y


relu_max_pool.launches = 0
