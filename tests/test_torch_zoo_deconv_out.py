"""The decoder's last deconvolution with its bias and tanh (K5,
``srl_zoo_tpu_torch/ops/deconv_out.py``) on the CPU: the routing that sends
``CNNDecoder``'s last layer to it, its plain versions against
``ConvTranspose2d`` + ``tanh`` and their autograd gradients, and against
the JAX package's ``ConvTranspose`` + ``tanh``. The CUDA kernels run only
on a GPU: tests/test_torch_zoo_card_kernels.py holds them against
float64 there.

Tolerances: the plain versions in float64 within 1e-12 of each result's
largest magnitude (the same products, summed by parity); against flax in
float32 within 1e-5 (two libraries' summation orders).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from srl_zoo_tpu_torch.models import decoders
from srl_zoo_tpu_torch.models.decoders import (CNNDecoder,
                                               deconv_weight_from_flax)
from srl_zoo_tpu_torch.ops import deconv_out
from srl_zoo_tpu_torch.ops.deconv_out import (deconv_out_tanh,
                                              deconv_out_tanh_bwd,
                                              deconv_out_tanh_bwd_plain,
                                              deconv_out_tanh_plain, fits)

# (B, Cin, H, W, C): config 1's last layer at 32 px, a multi-view frame's
# 6 channels, an odd batch over a non-square input, a Cin that is no
# multiple of 4, one output channel
SHAPES = [(2, 16, 16, 16, 3), (2, 16, 8, 8, 6), (3, 16, 6, 10, 3),
          (1, 5, 4, 7, 8), (2, 16, 3, 3, 1)]


def _close(got, want, rtol: float) -> None:
    got, want = got.detach(), want.detach()
    err = float((got - want).abs().max())
    scale = max(float(want.abs().max()), 1e-30)
    assert err <= rtol * scale, (err, scale)


def _layer_and_input(shape, seed: int = 0, dtype=torch.float64):
    b, cin, h, w, c = shape
    torch.manual_seed(seed)
    layer = nn.ConvTranspose2d(cin, c, 4, stride=2, padding=1).to(dtype)
    with torch.no_grad():
        layer.weight.mul_(4.0)  # pre-activations well into tanh's bend
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, cin, h, w)).to(dtype).contiguous(
        memory_format=torch.channels_last)
    g = torch.from_numpy(rng.randn(b, c, 2 * h, 2 * w)).to(dtype)
    return layer, x, g


class _Stand:
    """What ``fits`` reads of an input: its device kind, dtype and rank."""

    def __init__(self, is_cuda=True, dtype=torch.float32, ndim=4):
        self.is_cuda, self.dtype, self._ndim = is_cuda, dtype, ndim

    def dim(self):
        return self._ndim


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cin,c,x,want", [
    (16, 3, _Stand(), True),                        # config 1
    (16, 6, _Stand(), True),                        # multi-view frames
    (64, 8, _Stand(), True),                        # the widest it takes
    (16, 9, _Stand(), False),                       # too many outputs
    (65, 3, _Stand(), False),                       # too many inputs
    (32, 64, _Stand(), False),                      # an inner deconvolution
    (16, 3, _Stand(is_cuda=False), False),          # the CPU
    (16, 3, _Stand(dtype=torch.float64), False),    # a float64 reference
    (16, 3, _Stand(dtype=torch.bfloat16), False),   # a half input
    (16, 3, _Stand(ndim=3), False),
])
def test_fits_takes_cuda_float32_narrow_layers_only(cin, c, x, want):
    assert fits(nn.ConvTranspose2d(cin, c, 4, stride=2, padding=1), x) \
        is want


@pytest.mark.parametrize("layer", [
    nn.ConvTranspose2d(16, 3, 4, stride=1, padding=1),
    nn.ConvTranspose2d(16, 3, 3, stride=2, padding=1),
    nn.ConvTranspose2d(16, 3, 4, stride=2, padding=0),
    nn.ConvTranspose2d(16, 3, 4, stride=2, padding=1, output_padding=1),
    nn.ConvTranspose2d(16, 3, 4, stride=2, padding=1, bias=False),
    nn.ConvTranspose2d(16, 3, 4, stride=2, padding=1).double(),
], ids=["stride", "kernel", "padding", "output_padding", "no_bias",
        "float64_weight"])
def test_fits_takes_the_decoders_geometry_only(layer):
    assert not fits(layer, _Stand())


def _spy(monkeypatch, fits_says: bool) -> list:
    """Calls of ``deconv_out_tanh`` from the decoder, with ``fits``
    answering ``fits_says``."""
    calls = []

    def spy(x, weight, bias):
        calls.append(tuple(x.shape))
        return deconv_out_tanh(x, weight, bias)
    monkeypatch.setattr(deconv_out, "fits", lambda layer, x: fits_says)
    monkeypatch.setattr(deconv_out, "deconv_out_tanh", spy)
    return calls


@pytest.mark.parametrize("deconv", ["conv_transpose", "subpixel"])
def test_decoder_routes_its_last_layer_by_fits(monkeypatch, deconv):
    """The decoder's last layer goes to K5 exactly when ``fits`` says so
    on the ``conv_transpose`` formulation; its reconstruction is then the
    layer's and tanh's within 1e-12 in float64. On the CPU ``fits`` says
    no, so nothing changes there."""
    torch.manual_seed(0)
    dec = CNNDecoder(8, 32, 64, deconv=deconv).double().eval()
    z = torch.randn(3, 8, dtype=torch.float64)
    assert not fits(dec.deconvs[-1], torch.zeros(1, 16, 16, 32))
    plain = dec(z)
    calls = _spy(monkeypatch, True)
    routed = dec(z)
    assert calls == ([(3, 16, 16, 32)] if deconv == "conv_transpose" else [])
    _close(routed, plain, 1e-12)
    assert routed.is_contiguous(memory_format=torch.channels_last)


def test_decoder_keeps_the_layer_where_fits_says_no(monkeypatch):
    calls = _spy(monkeypatch, False)
    CNNDecoder(8, 32, 32).eval()(torch.randn(2, 8))
    assert calls == []
    assert decoders.deconv_out is deconv_out


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_against_conv_transpose_and_tanh(shape):
    layer, x, _ = _layer_and_input(shape)
    with torch.no_grad():
        want = torch.tanh(layer(x))
        got = deconv_out_tanh_plain(x, layer.weight, layer.bias)
    assert got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    _close(got, want, 1e-12)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_against_autograd(shape):
    """``deconv_out_tanh_bwd_plain`` against autograd's gradients of
    ``ConvTranspose2d`` + ``tanh``, and the differentiable op on the CPU
    (the plain forward and backward in a Function) against the same."""
    layer, x, g = _layer_and_input(shape)
    xg = x.clone().requires_grad_()
    y = torch.tanh(layer(xg))
    want = torch.autograd.grad(y, (xg, layer.weight, layer.bias), g)
    got = deconv_out_tanh_bwd_plain(g, y.detach(), x, layer.weight.detach())
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b, 1e-12)
    before = deconv_out_tanh.launches, deconv_out_tanh_bwd.launches
    xo = x.clone().requires_grad_()
    yo = deconv_out_tanh(xo, layer.weight, layer.bias)
    _close(yo, y, 1e-12)
    for a, b in zip(torch.autograd.grad(yo, (xo, layer.weight, layer.bias),
                                        g), want):
        _close(a, b, 1e-12)
    # the CPU runs no kernel
    assert (deconv_out_tanh.launches,
            deconv_out_tanh_bwd.launches) == before


def test_op_passes_gradcheck_on_the_cpu():
    layer, x, _ = _layer_and_input((2, 3, 3, 4, 2))
    xg = x.clone().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, w, b: deconv_out_tanh(a, w, b),
        (xg, layer.weight, layer.bias))


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_plain_forward_against_flax(shape):
    """The plain forward with the torch weight bridged from a flax kernel
    against flax's ``ConvTranspose`` (SAME, stride 2) + tanh, the JAX
    decoder's last layer, in float32."""
    import flax.linen as fnn
    b, cin, h, w, c = shape
    rng = np.random.RandomState(1)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    kernel = (rng.randn(4, 4, cin, c) * 0.3).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    layer = fnn.ConvTranspose(c, (4, 4), strides=(2, 2), padding="SAME")
    want = np.array(jnp.tanh(layer.apply(
        {"params": {"kernel": kernel, "bias": bias}}, x)))
    got = deconv_out_tanh_plain(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        deconv_weight_from_flax(torch.from_numpy(kernel)),
        torch.from_numpy(bias)).permute(0, 2, 3, 1)
    _close(got, torch.from_numpy(want), 1e-5)


@pytest.mark.parametrize("call", [
    lambda: deconv_out_tanh(torch.zeros(1, 16, 4, 4, device="meta"),
                            torch.zeros(16, 3, 4, 4, device="meta"),
                            torch.zeros(3, device="meta")),
    lambda: deconv_out_tanh(torch.zeros(1, 16, 4, 4),
                            torch.zeros(16, 9, 4, 4), torch.zeros(9)),
    lambda: deconv_out_tanh(torch.zeros(1, 16, 4, 4),
                            torch.zeros(16, 3, 3, 3), torch.zeros(3)),
    lambda: deconv_out_tanh(torch.zeros(1, 8, 4, 4),
                            torch.zeros(16, 3, 4, 4), torch.zeros(3)),
], ids=["device", "too_many_outputs", "kernel_3", "channels_disagree"])
def test_op_refuses_what_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()
