"""Fused relu + 3x3 stride-2 max-pool over NHWC, with an int8 argmax plane,
and its backward.

Kernels: ``csrc/fused_pool.cu`` (forward), which replaces the TPU kernel
``srl_zoo_tpu/ops/fused_pool.py`` ``_fwd_pallas`` (``_fwd_kernel``), and
``csrc/fused_pool_bwd.cu`` (backward), which replaces ``_bwd_pallas``
(``_bwd_kernel``). Both are bound by bytes on the H100; the source notes
say how the designs meet that.

    y   = max_pool_3x3_stride2(relu(x))          NHWC, pads (lo, hi) per axis
    idx = raster position 0..8 of the first window maximum, 9 when the
          window maximum is <= 0 (relu kills the gradient)
    dx  = each g routed to its window's argmax, summed where windows overlap

The kernels take float32, bfloat16 and float16, any H and W, and any pads
in [0, 2], including the odd 7x7 pool of CustomCNN at 224 px that the JAX
package sends to XLA. :func:`relu_max_pool` is differentiable: when a
gradient is needed, the forward also writes the argmax plane and the
backward reads it; inference writes no plane. The gradient is XLA's
select-and-scatter gradient of ``max_pool(relu(x))``: ties go to the first
maximum in raster order, and nothing flows where the window maximum is
<= 0.

Each kernel has a vector path, taken when C times the element size is a
multiple of 16 bytes and the tensors start 16-byte aligned (the main
path's C = 64 in channels_last memory), and a scalar path in the same
source for any other shape. Each wrapper counts its launches
(``launches``) and, beside them, its vector-path launches
(``vector_launches``) and its bfloat16 launches (``bf16_launches``: the
``--dtype bfloat16`` models' pools), a launch captured into a CUDA graph
once for each replay (ops/_build.py ``count``).
"""

from __future__ import annotations

import functools

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
    """Plain PyTorch version of the forward kernel, NHWC in and out."""
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


def relu_max_pool_bwd_plain(g: torch.Tensor, idx: torch.Tensor, x_shape,
                            padding="SAME") -> torch.Tensor:
    """Plain PyTorch version of the backward kernel: scatter ``g`` (B, OH,
    OW, C) by the argmax plane ``idx`` into dx of ``x_shape`` (B, H, W, C).

    The nine window positions are added in raster order into an f32 buffer
    over the padded input, which is the kernel's order of summation, so the
    two agree bit for bit; the pad border receives nothing (the forward
    never picks a pad) and is cut off."""
    b, h, w, c = x_shape
    (pt, pb), (pl, pr) = _resolve_pads(h, w, padding)
    oh, ow = g.shape[1], g.shape[2]
    buf = torch.zeros((b, h + pt + pb, w + pl + pr, c), dtype=torch.float32,
                      device=g.device)
    gf = g.float()
    zero = torch.zeros((), dtype=torch.float32, device=g.device)
    for k in range(9):
        dy, dx = divmod(k, 3)
        buf[:, dy:dy + 2 * oh - 1:2, dx:dx + 2 * ow - 1:2] += torch.where(
            idx == k, gf, zero)
    return buf[:, pt:pt + h, pl:pl + w].to(g.dtype).contiguous()


def _check_cuda(fn: str, t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {t.device}")
    if t.dim() != 4 or t.dtype not in _DTYPES:
        raise ValueError(f"{fn}: expected a 4-d float32/bfloat16/float16 "
                         f"NHWC {what}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        # an NCHW view of a channels_last tensor is contiguous once permuted
        # to NHWC; anything else would be read with the wrong strides
        raise ValueError(f"{fn}: {what} must be a contiguous (B, H, W, C) "
                         "tensor (permute a channels_last NCHW tensor with "
                         ".permute(0, 2, 3, 1))")


def _key(padding):
    """``padding`` as a hashable key of :func:`_geometry`."""
    if padding == "SAME":
        return padding
    (ph, pw) = padding
    return (int(ph[0]), int(ph[1])), (int(pw[0]), int(pw[1]))


@functools.lru_cache(maxsize=256)
def _geometry(h: int, w: int, padding):
    """(pads, oh, ow) of an h x w pool for the kernels, computed once per
    shape; raises on pads outside [0, 2] or an empty output."""
    pads = _resolve_pads(h, w, padding)
    oh, ow = _out_size(h, pads[0]), _out_size(w, pads[1])
    if oh < 1 or ow < 1 or min(pads[0] + pads[1]) < 0 or \
            max(pads[0] + pads[1]) > 2:
        raise ValueError(f"relu_max_pool: unsupported pads {pads} for "
                         f"{h}x{w}")
    return pads, oh, ow


def _vector_ok(t: torch.Tensor, c: int, extra_ptr: int = 0) -> bool:
    """Whether the kernels' vector path reads ``t``: whole 16-byte vectors
    of channels from a 16-byte aligned start (a slice at an odd storage
    offset takes the scalar path)."""
    es = t.element_size()
    return (c * es) % 16 == 0 and t.data_ptr() % 16 == 0 and \
        extra_ptr % (16 // es) == 0


def _fwd_kernel(x: torch.Tensor, padding, with_index: bool):
    """Launch the forward kernel on a CUDA tensor: (y, idx or None)."""
    _check_cuda("relu_max_pool", x, "x")
    b, h, w, c = x.shape
    pads, oh, ow = _geometry(h, w, _key(padding))
    y = torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device)
    idx = torch.empty((b, oh, ow, c), dtype=torch.int8, device=x.device) \
        if with_index else None
    if y.numel() == 0:
        return y, idx
    vector = _vector_ok(x, c)
    code = _build.launch(_build.entry("fused_pool"), x,
                         x.data_ptr(), y.data_ptr(),
                         idx.data_ptr() if idx is not None else None,
                         _DTYPES[x.dtype], b, h, w, c, oh, ow, pads[0][0],
                         pads[1][0], int(vector))
    _build.check(code, "relu_max_pool")
    _build.count(relu_max_pool, launches=1, vector_launches=vector,
                 bf16_launches=x.dtype == torch.bfloat16)
    return y, idx


def relu_max_pool_bwd(g: torch.Tensor, idx: torch.Tensor, x_shape,
                      padding="SAME") -> torch.Tensor:
    """dx (``x_shape``, NHWC) of :func:`relu_max_pool` from the output
    gradient ``g`` (B, OH, OW, C) and the forward's argmax plane ``idx``.

    A CUDA tensor launches the backward kernel; a CPU tensor takes
    :func:`relu_max_pool_bwd_plain`; any other device raises."""
    if g.device != idx.device:
        raise ValueError(f"relu_max_pool_bwd: g on {g.device}, idx on "
                         f"{idx.device}")
    if g.device.type == "cpu":
        return relu_max_pool_bwd_plain(g, idx, x_shape, padding)
    _check_cuda("relu_max_pool_bwd", g, "g")
    b, h, w, c = (int(s) for s in x_shape)
    pads, oh, ow = _geometry(h, w, _key(padding))
    if g.shape != (b, oh, ow, c) or idx.shape != (b, oh, ow, c) \
            or idx.dtype != torch.int8 or not idx.is_contiguous():
        raise ValueError(f"relu_max_pool_bwd: expected g and a contiguous "
                         f"int8 idx of shape {(b, oh, ow, c)}, got "
                         f"{tuple(g.shape)} and {idx.dtype} "
                         f"{tuple(idx.shape)}")
    dx = torch.empty((b, h, w, c), dtype=g.dtype, device=g.device)
    if dx.numel() == 0:
        return dx
    vector = _vector_ok(g, c, idx.data_ptr())
    code = _build.launch(_build.entry("fused_pool_bwd"), g,
                         g.data_ptr(), idx.data_ptr(), dx.data_ptr(),
                         _DTYPES[g.dtype], b, h, w, c, oh, ow, pads[0][0],
                         pads[1][0], int(vector))
    _build.check(code, "relu_max_pool_bwd")
    _build.count(relu_max_pool_bwd, launches=1, vector_launches=vector,
                 bf16_launches=g.dtype == torch.bfloat16)
    return dx


class _ReluMaxPool(torch.autograd.Function):
    """relu + pool with the argmax-plane backward: the forward returns
    ``(y, idx)`` and keeps idx for the backward."""

    @staticmethod
    def forward(ctx, x, pads):
        if x.device.type == "cpu":
            y, idx = relu_max_pool_plain(x, pads, True)
        else:
            y, idx = _fwd_kernel(x, pads, True)
        ctx.save_for_backward(idx)
        ctx.pads = pads
        ctx.x_shape = tuple(x.shape)
        ctx.mark_non_differentiable(idx)
        return y, idx

    @staticmethod
    def backward(ctx, g, _g_idx=None):
        (idx,) = ctx.saved_tensors
        # g arrives as the NHWC view of a channels_last tensor, or as any
        # other layout: the kernel reads contiguous NHWC
        return relu_max_pool_bwd(g.contiguous(), idx, ctx.x_shape,
                                 ctx.pads), None


def relu_max_pool(x: torch.Tensor, padding="SAME", with_index: bool = False):
    """relu then 3x3/2 max pool of an NHWC tensor ``(B, H, W, C)``.

    ``padding`` is "SAME" or ``((top, bottom), (left, right))``. Returns y,
    or ``(y, idx)`` with ``with_index``; y is differentiable in x. A CUDA
    tensor launches the kernels; a CPU tensor takes the plain versions; any
    other device raises. Without a gradient to take and without the index,
    the kernel is called directly: no autograd node, no argmax plane."""
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"relu_max_pool: no kernel for device {x.device}")
    if not with_index and not (x.requires_grad and torch.is_grad_enabled()):
        if kind == "cpu":
            return relu_max_pool_plain(x, padding)
        return _fwd_kernel(x, padding, False)[0]
    pads = _resolve_pads(x.shape[1], x.shape[2], padding)
    y, idx = _ReluMaxPool.apply(x, pads)
    return (y, idx) if with_index else y


relu_max_pool.launches = 0
relu_max_pool.vector_launches = 0
relu_max_pool.bf16_launches = 0
relu_max_pool_bwd.launches = 0
relu_max_pool_bwd.vector_launches = 0
relu_max_pool_bwd.bf16_launches = 0
