"""The CNN decoder's last deconvolution with its bias and tanh (K5), forward
and backward.

Kernels: ``csrc/deconv_out.cu``. It replaces no TPU kernel: the JAX
package leaves ``ConvTranspose`` and ``tanh`` to XLA. On the H100, cuDNN
ran this layer (16 -> 3 channels, 112^2 -> 224^2 at config 1) in generic
engines between layout transposes, far from its bound, and tanh and its
backward made two more passes over the reconstruction. The kernels are
bound by bytes; the source notes say how the design meets that.

    y  = tanh(conv_transpose2d(x, W, b, stride=2, padding=1))
         x (B, Cin, H, W) -> y (B, C, 2H, 2W), W (Cin, C, 4, 4) as
         ``nn.ConvTranspose2d`` keeps it: output row 2 i - 1 + kh
    gp = g (1 - y^2);  dx, dW, db of gp, never stored

Both tensors are NCHW in channels_last memory, the decoder's layout: the
kernels read and write their NHWC views. The kernels take float32, C up to
:data:`MAX_OUT` and Cin up to :data:`MAX_IN`; :func:`fits` says whether a
layer and its input take them, and ``CNNDecoder`` routes its last layer
here only then (models/decoders.py). The backward's weight and bias
gradients are sums over every position of the batch, done without float
atomics in a fixed order (a grid of as many blocks as the card holds at
once, one row of partials a block, then a second kernel that adds the
rows), so a call gives the same bits every time and a CUDA-graph replay
equals an eager call.

:func:`deconv_out_tanh` is differentiable in x, W and b. A CUDA tensor
launches the kernels; a CPU tensor takes :func:`deconv_out_tanh_plain`
and :func:`deconv_out_tanh_bwd_plain`, which compute the same function by
the four output parities' 2 x 2 taps; any other device raises. Each
wrapper counts its calls (``launches`` on :func:`deconv_out_tanh` and on
:func:`deconv_out_tanh_bwd`, whose two kernels count as one), a call
captured into a CUDA graph once for each replay (ops/_build.py
``count``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from srl_zoo_tpu_torch.ops import _build

MAX_OUT = 8  # output channels the kernels take (a multi-view frame is 6)
MAX_IN = 64  # input channels the kernels take
# (x row offset into the input padded by 1, kernel row) of each output
# parity: output 2m reads x rows m - 1 (kh 3) and m (kh 1), output 2m + 1
# rows m (kh 2) and m + 1 (kh 0); the same of columns
TAPS = (((0, 3), (1, 1)), ((1, 2), (2, 0)))


def fits(layer: nn.ConvTranspose2d, x: torch.Tensor) -> bool:
    """Whether ``layer`` applied to ``x`` runs on the kernels: a CUDA
    float32 input and layer, the decoder's geometry (kernel 4, stride 2,
    padding 1, a bias), at most MAX_OUT output and MAX_IN input channels.
    Everything else (the CPU, float64 reference runs, wider layers) keeps
    cuDNN's deconvolution and ``torch.tanh``."""
    return (x.is_cuda and x.dtype == torch.float32 and x.dim() == 4
            and layer.weight.dtype == torch.float32
            and layer.bias is not None
            and layer.out_channels <= MAX_OUT
            and layer.in_channels <= MAX_IN
            and layer.kernel_size == (4, 4) and layer.stride == (2, 2)
            and layer.padding == (1, 1) and layer.output_padding == (0, 0)
            and layer.dilation == (1, 1) and layer.groups == 1)


def deconv_out_tanh_plain(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel, NCHW in and out: each
    output parity (pi, pj) is the sum of its 2 x 2 taps over shifted
    slices of x padded by one position."""
    b, _, h, w = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    y = x.new_empty((b, weight.shape[1], 2 * h, 2 * w))
    for pi in range(2):
        for pj in range(2):
            y[:, :, pi::2, pj::2] = sum(
                torch.einsum("bihw,io->bohw",
                             xp[:, :, r:r + h, c:c + w], weight[:, :, kh, kw])
                for r, kh in TAPS[pi] for c, kw in TAPS[pj])
    return torch.tanh(y + bias.view(1, -1, 1, 1)).contiguous(
        memory_format=torch.channels_last)


def deconv_out_tanh_bwd_plain(g: torch.Tensor, y: torch.Tensor,
                              x: torch.Tensor, weight: torch.Tensor):
    """Plain PyTorch version of the backward kernels, NCHW: (dx, dW, db)
    of :func:`deconv_out_tanh_plain` at input ``x`` and output ``y`` for
    the output gradient ``g``. With gp = g (1 - y^2) padded by one
    output, tap (kh, kw) reads gp at rows 2m - 1 + kh, columns
    2n - 1 + kw."""
    _, _, h, w = x.shape
    gp = F.pad(g * (1 - y * y), (1, 1, 1, 1))
    dx = torch.zeros_like(x)
    dw = torch.empty_like(weight)
    for kh in range(4):
        for kw in range(4):
            gs = gp[:, :, kh:kh + 2 * h:2, kw:kw + 2 * w:2]
            dx = dx + torch.einsum("bchw,ic->bihw", gs, weight[:, :, kh, kw])
            dw[:, :, kh, kw] = torch.einsum("bihw,bchw->ic", x, gs)
    db = gp.sum((0, 2, 3))
    return dx.contiguous(memory_format=torch.channels_last), dw, db


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """The contiguous NHWC view of an NCHW tensor: no copy for one in
    channels_last memory."""
    return t.permute(0, 2, 3, 1).contiguous()


def _check_cuda(fn: str, **tensors) -> None:
    for what, t in tensors.items():
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"{fn}: expected a float32 CUDA {what}, got "
                             f"{t.dtype} on {t.device}")


def _check_layer(x: torch.Tensor, weight: torch.Tensor, bias) -> None:
    cin, c = weight.shape[:2]
    if x.dim() != 4 or x.shape[1] != cin or weight.shape[2:] != (4, 4) \
            or bias is None or bias.shape != (c,) or not 1 <= c <= MAX_OUT \
            or not 1 <= cin <= MAX_IN:
        raise ValueError(f"deconv_out_tanh: takes x (B, Cin, H, W), W (Cin, "
                         f"C, 4, 4) and b (C) with C <= {MAX_OUT}, Cin <= "
                         f"{MAX_IN}; got {tuple(x.shape)}, "
                         f"{tuple(weight.shape)}, "
                         f"{None if bias is None else tuple(bias.shape)}")


def _fwd_kernel(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel: y (B, C, 2H, 2W), channels_last."""
    _check_cuda("deconv_out_tanh", x=x, weight=weight, bias=bias)
    b, cin, h, w = x.shape
    c = weight.shape[1]
    # the launch's operands stay referenced until it is queued
    xh, wc, bc = _nhwc(x), weight.contiguous(), bias.contiguous()
    y = torch.empty((b, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    if y.numel():
        grid = _plan(x.get_device(), b, h, w, cin, c)[0]
        code = _build.launch(_build.entry("deconv_out"), x, xh.data_ptr(),
                             wc.data_ptr(), bc.data_ptr(), y.data_ptr(), b,
                             h, w, cin, c, grid)
        _build.check(code, "deconv_out_tanh")
        _build.count(deconv_out_tanh, launches=1)
    return y.permute(0, 3, 1, 2)


@functools.lru_cache(maxsize=64)
def _plan(device_index: int, b: int, h: int, w: int, cin: int, c: int):
    """(forward grid, backward grid, floats of a row of the backward's
    partials) at these shapes on a device, asked of the kernels' source
    once: as many blocks as fit on the device at once."""
    grid = _build.entry("deconv_out", "srl_deconv_out_grid")
    with torch.cuda.device(device_index):
        sms = _build.sm_count(device_index)
        fwd, bwd = (grid(b, h, w, cin, c, sms, backward)
                    for backward in (0, 1))
    if min(fwd, bwd) < 1:
        raise _build.KernelLaunchError(
            f"deconv_out_tanh: no grid for {(b, cin, h, w)} -> {c} (CUDA "
            f"error {-min(fwd, bwd)})")
    row = _build.entry("deconv_out", "srl_deconv_out_partials")(cin, c)
    return fwd, bwd, row


def deconv_out_tanh_bwd(g: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                        weight: torch.Tensor):
    """(dx, dW, db) of :func:`deconv_out_tanh` at input ``x`` and output
    ``y`` for the output gradient ``g``, all NCHW; dx channels_last.

    A CUDA tensor launches the backward kernels; a CPU tensor takes
    :func:`deconv_out_tanh_bwd_plain`; any other device raises."""
    if g.device.type == "cpu":
        return deconv_out_tanh_bwd_plain(g, y, x, weight)
    _check_cuda("deconv_out_tanh_bwd", g=g, y=y, x=x, weight=weight)
    b, cin, h, w = x.shape
    c = weight.shape[1]
    if g.shape != y.shape or y.shape != (b, c, 2 * h, 2 * w):
        raise ValueError(f"deconv_out_tanh_bwd: expected g and y of shape "
                         f"{(b, c, 2 * h, 2 * w)}, got {tuple(g.shape)} and "
                         f"{tuple(y.shape)}")
    dx = torch.empty((b, h, w, cin), dtype=x.dtype, device=x.device)
    dw = torch.empty_like(weight, memory_format=torch.contiguous_format)
    db = weight.new_empty(c)
    if dx.numel() == 0:
        return dx.permute(0, 3, 1, 2), dw.zero_(), db.zero_()
    _, grid, row = _plan(x.get_device(), b, h, w, cin, c)
    part = torch.empty((grid, row), dtype=torch.float32, device=x.device)
    gh, yh, xh, wc = _nhwc(g), _nhwc(y), _nhwc(x), weight.contiguous()
    code = _build.launch(_build.entry("deconv_out", "srl_deconv_out_tanh_bwd"),
                         x, gh.data_ptr(), yh.data_ptr(), xh.data_ptr(),
                         wc.data_ptr(), dx.data_ptr(), part.data_ptr(),
                         dw.data_ptr(), db.data_ptr(), b, h, w, cin, c, grid)
    _build.check(code, "deconv_out_tanh_bwd")
    _build.count(deconv_out_tanh_bwd, launches=1)
    return dx.permute(0, 3, 1, 2), dw, db


class _DeconvOutTanh(torch.autograd.Function):
    """y = tanh(conv_transpose2d(x, W, b)); keeps x, W and y for the
    backward."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        if x.device.type == "cpu":
            y = deconv_out_tanh_plain(x, weight, bias)
        else:
            y = _fwd_kernel(x, weight, bias)
        ctx.save_for_backward(x, weight, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, y = ctx.saved_tensors
        return deconv_out_tanh_bwd(g, y, x, weight)


def deconv_out_tanh(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """tanh of the stride-2, padding-1, 4 x 4 transposed convolution of
    NCHW ``x`` (B, Cin, H, W) by ``weight`` (Cin, C, 4, 4) plus ``bias``
    (C): (B, C, 2H, 2W) in channels_last memory, differentiable in all
    three. A CUDA tensor launches the kernels; a CPU tensor takes the plain
    versions; any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"deconv_out_tanh: no kernel for device {x.device}")
    _check_layer(x, weight, bias)
    return _DeconvOutTanh.apply(x, weight, bias)


deconv_out_tanh.launches = 0
deconv_out_tanh_bwd.launches = 0
