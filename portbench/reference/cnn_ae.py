"""Plain reference of BASELINE config 1 (araffin/srl-zoo ``train.py
--losses autoencoder --model-type custom_cnn``): the CustomCNN encoder,
the CNN decoder, the autoencoder's pixel MSE and Adam, in float32.

    encoder: 3 x [conv 64 (7/3/3, stride 2, SAME, no bias) -> BatchNorm
             -> relu -> 3x3/2 max-pool (SAME)] -> flatten (H, W, C) ->
             Dense state_dim
    decoder: Dense -> relu -> reshape (H/32, W/32, 64) -> 4 x
             [ConvTranspose 4/2 (64 64 32 16) -> BatchNorm -> relu] ->
             ConvTranspose 4/2 to the image channels -> tanh
    loss:    mean over the batch of each frame's mean squared error to
             its own normalized pixels

The pads are XLA's SAME pads, which are asymmetric (at 224 px the 7x7
conv pads (2, 3)). The deconvolution is flax's ``ConvTranspose``
(``transpose_kernel=False``, SAME): the input dilated by the stride, padded
by (2, 2) and correlated with the kernel as flax stores it (kh, kw, in,
out). The weights come in the port's layout, a torch ConvTranspose2d
weight (in, out, kh, kw), which is flax's kernel flipped on both spatial
axes; :func:`flax_deconv` flips it back. Departures from the published
model: none in the arithmetic; the reference computes each layer in
NCHW, unfused, where the port fuses relu and pool and keeps NHWC memory.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.reference.common import (adam_steps, batch_norm, bn_spec,
                                        dense, normalize_tf, relu_max_pool,
                                        trainable,
                                        same_pads)

KERNELS = (7, 3, 3)
WIDTH = 64
DECONV_WIDTHS = (64, 64, 32, 16)
DECONV_K = 4
# encoder passes of one sample in a train step and in an eval step
ENCODER_PASSES = 1
# the inputs of a step that the loss reads (harness/train_cell.py
# ``reference_step``)
INPUTS = ("obs",)


def _down(n: int) -> int:
    return -(-n // 2)


def encoder_sizes(cfg) -> List[tuple]:
    """(conv input H, W, C, kernel) of each encoder block."""
    h, w, c = cfg["img_height"], cfg["img_width"], cfg["channels"]
    out = []
    for k in KERNELS:
        out.append((h, w, c, k))
        h, w, c = _down(_down(h)), _down(_down(w)), WIDTH
    return out


def flat_size(cfg) -> int:
    h, w = cfg["img_height"], cfg["img_width"]
    for _ in range(2 * len(KERNELS)):
        h, w = _down(h), _down(w)
    return h * w * WIDTH


def param_spec(cfg) -> List[tuple]:
    """(name, shape, kind, fan_in) of every tensor of the port's model."""
    d = cfg["state_dim"]
    spec = []
    for i, (_, _, c, k) in enumerate(encoder_sizes(cfg)):
        spec.append((f"encoder.convs.{i}.weight", (WIDTH, c, k, k),
                     "weight", k * k * c))
    for i in range(len(KERNELS)):
        spec += bn_spec(f"encoder.bns.{i}", WIDTH)
    flat = flat_size(cfg)
    spec += [("encoder.fc.weight", (d, flat), "weight", flat),
             ("encoder.fc.bias", (d,), "bias", 0)]
    h0, w0 = cfg["img_height"] // 32, cfg["img_width"] // 32
    spec += [("decoder.fc.weight", (h0 * w0 * WIDTH, d), "weight", d),
             ("decoder.fc.bias", (h0 * w0 * WIDTH,), "bias", 0)]
    c = WIDTH
    for i, width in enumerate(DECONV_WIDTHS + (cfg["channels"],)):
        spec += [(f"decoder.deconvs.{i}.weight", (c, width, DECONV_K,
                                                  DECONV_K),
                  "weight", DECONV_K * DECONV_K * c),
                 (f"decoder.deconvs.{i}.bias", (width,), "bias", 0)]
        c = width
    for i, width in enumerate(DECONV_WIDTHS):
        spec += bn_spec(f"decoder.bns.{i}", width)
    return spec


def encode(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
           train: bool) -> torch.Tensor:
    """Normalized NHWC frames -> (B, state_dim)."""
    y = x.permute(0, 3, 1, 2)
    for i, k in enumerate(KERNELS):
        (t, b), (l, r) = (same_pads(y.shape[2], k, 2),
                          same_pads(y.shape[3], k, 2))
        y = F.conv2d(F.pad(y, (l, r, t, b)), p[f"encoder.convs.{i}.weight"],
                     stride=2)
        y = batch_norm(y, p, f"encoder.bns.{i}", train)
        y = relu_max_pool(y, (same_pads(y.shape[2], 3, 2),
                              same_pads(y.shape[3], 3, 2)))
    flat = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)
    return dense(flat, p, "encoder.fc")


def flax_deconv(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """flax ConvTranspose(4, stride 2, SAME) of NCHW ``x``; ``weight`` in
    torch's ConvTranspose2d layout (flax's kernel, flipped)."""
    b, c, h, w = x.shape
    dil = x.new_zeros((b, c, 2 * h - 1, 2 * w - 1))
    dil[:, :, ::2, ::2] = x
    kernel = weight.flip(2, 3).permute(1, 0, 2, 3)  # (out, in, kh, kw)
    return F.conv2d(F.pad(dil, (2, 2, 2, 2)), kernel) + \
        bias[None, :, None, None]


def decode(p: Dict[str, torch.Tensor], z: torch.Tensor, cfg,
           train: bool) -> torch.Tensor:
    """(B, state_dim) -> reconstruction, NHWC in [-1, 1]."""
    h0, w0 = cfg["img_height"] // 32, cfg["img_width"] // 32
    y = torch.relu(dense(z, p, "decoder.fc"))
    y = y.reshape(z.shape[0], h0, w0, WIDTH).permute(0, 3, 1, 2)
    for i in range(len(DECONV_WIDTHS)):
        y = flax_deconv(y, p[f"decoder.deconvs.{i}.weight"],
                        p[f"decoder.deconvs.{i}.bias"])
        y = torch.relu(batch_norm(y, p, f"decoder.bns.{i}", train))
    last = len(DECONV_WIDTHS)
    y = flax_deconv(y, p[f"decoder.deconvs.{last}.weight"],
                    p[f"decoder.deconvs.{last}.bias"])
    return torch.tanh(y).permute(0, 2, 3, 1)


def loss(p: Dict[str, torch.Tensor], step: Dict[str, torch.Tensor],
         cfg, train: bool = True) -> torch.Tensor:
    """The autoencoder's loss of one step (in eval mode with ``train``
    False): ``step["obs"]`` is the batch's uint8 frames."""
    x = normalize_tf(step["obs"])
    recon = decode(p, encode(p, x, cfg, train), cfg, train)
    return (recon - x).square().reshape(x.shape[0], -1).mean(1).mean()


def train_steps(p: Dict[str, torch.Tensor], steps: List[Dict], cfg
                ) -> Dict[str, object]:
    """Adam over ``steps`` from the weights ``p`` (adam_steps' result)."""
    return adam_steps(p, trainable(param_spec(cfg)),
                      lambda q, s: loss(q, s, cfg), steps,
                      cfg["learning_rate"])


def encode_frames(p: Dict[str, torch.Tensor], frames_u8: torch.Tensor,
                  cfg) -> torch.Tensor:
    """The eval-mode states of uint8 NHWC frames (the encode cell)."""
    with torch.no_grad():
        return encode(p, normalize_tf(frames_u8), cfg, False)


def pool_inputs(cfg) -> List[tuple]:
    """(H, W, C) of each relu + pool input of one encoder pass, NHWC."""
    out = []
    for h, w, _, k in encoder_sizes(cfg):
        out.append((_down(h), _down(w), WIDTH))
    return out


def macs(cfg) -> Dict[str, List[tuple]]:
    """Multiply-adds of one sample's pass through each part: (layer,
    MACs, whether its input takes a gradient in training)."""
    enc = []
    for i, (h, w, c, k) in enumerate(encoder_sizes(cfg)):
        enc.append((f"conv{i}", _down(h) * _down(w) * c * WIDTH * k * k,
                    i > 0))
    flat, d = flat_size(cfg), cfg["state_dim"]
    enc.append(("fc", flat * d, True))
    h, w = cfg["img_height"] // 32, cfg["img_width"] // 32
    dec = [("fc", d * h * w * WIDTH, True)]
    c = WIDTH
    for i, width in enumerate(DECONV_WIDTHS + (cfg["channels"],)):
        # a transposed convolution's MACs: every input pixel times the
        # kernel, into every output channel
        dec.append((f"deconv{i}", h * w * c * width * DECONV_K * DECONV_K,
                    True))
        h, w, c = 2 * h, 2 * w, width
    return {"encoder": enc, "decoder": dec}


def step_parts(cfg) -> List[str]:
    """The parts one sample runs through in a train or eval step."""
    return ["encoder", "decoder"]
