"""Plain reference of BASELINE config 5 (araffin/srl-zoo ``train.py
--losses triplet --model-type resnet --multi-view``): a ResNet-18 encoder
(He et al., arXiv:1512.03385, widths 64 128 256 512) to ``state_dim``,
the triplet loss over two camera views and Adam, in float32.

    stem:    conv 7x7/2 pads (3, 3), 64, no bias -> BatchNorm -> relu ->
             max-pool 3x3/2 pads (1, 1)
    layers:  two BasicBlocks a width; the first block of widths 128-512
             strides 2 and adds a 1x1/2 conv + BatchNorm shortcut
    head:    mean over H and W -> Dense state_dim
    loss:    max(0, |a - p| - |a - n| + 1), euclidean, each norm
             sqrt(sum + 1e-12); a: the frame's view 1, p: its view 2, n:
             another frame's view 1 (the loader's negative)

Each of the three encoder passes of a train step takes its own batch
statistics. The pads are torch's explicit ones, as in the JAX module (the
stem pool's (1, 1) is not SAME). The reference computes each layer in
NCHW, unfused; the weights come in the port's (torchvision's) names and
layouts.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.reference.common import (adam_steps, batch_norm, bn_spec,
                                        dense, normalize_tf, relu_max_pool,
                                        trainable)

WIDTHS = (64, 128, 256, 512)
BLOCKS = 2
STEM_POOL_PADS = ((1, 1), (1, 1))
MARGIN = 1.0
# encoder passes of one sample in a train step and in an eval step:
# anchor, positive, negative
ENCODER_PASSES = 3
# the inputs of a step that the loss reads (harness/train_cell.py
# ``reference_step``)
INPUTS = ("obs", "pos", "neg")


def _blocks():
    """(prefix, in width, width, stride) of each BasicBlock."""
    c = WIDTHS[0]
    for i, width in enumerate(WIDTHS):
        for b in range(BLOCKS):
            stride = 2 if i > 0 and b == 0 else 1
            yield f"encoder.layer{i + 1}.{b}", c, width, stride
            c = width


def param_spec(cfg) -> List[tuple]:
    """(name, shape, kind, fan_in) of every tensor of the port's model."""
    c = cfg["channels"]
    spec = [("encoder.conv1.weight", (WIDTHS[0], c, 7, 7), "weight",
             49 * c)]
    spec += bn_spec("encoder.bn1", WIDTHS[0])
    for pre, cin, width, _ in _blocks():
        spec.append((f"{pre}.conv1.weight", (width, cin, 3, 3), "weight",
                     9 * cin))
        spec += bn_spec(f"{pre}.bn1", width)
        spec.append((f"{pre}.conv2.weight", (width, width, 3, 3), "weight",
                     9 * width))
        spec += bn_spec(f"{pre}.bn2", width)
        if cin != width:
            spec.append((f"{pre}.downsample.0.weight", (width, cin, 1, 1),
                         "weight", cin))
            spec += bn_spec(f"{pre}.downsample.1", width)
    d = cfg["state_dim"]
    spec += [("encoder.fc.weight", (d, WIDTHS[-1]), "weight", WIDTHS[-1]),
             ("encoder.fc.bias", (d,), "bias", 0)]
    return spec


def encode(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
           train: bool) -> torch.Tensor:
    """Normalized NHWC frames -> (B, state_dim)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["encoder.conv1.weight"], stride=2,
                 padding=3)
    y = relu_max_pool(batch_norm(y, p, "encoder.bn1", train),
                      STEM_POOL_PADS)
    for pre, cin, width, stride in _blocks():
        h = F.conv2d(y, p[f"{pre}.conv1.weight"], stride=stride, padding=1)
        h = torch.relu(batch_norm(h, p, f"{pre}.bn1", train))
        h = F.conv2d(h, p[f"{pre}.conv2.weight"], padding=1)
        h = batch_norm(h, p, f"{pre}.bn2", train)
        if cin != width:
            y = batch_norm(F.conv2d(y, p[f"{pre}.downsample.0.weight"],
                                    stride=stride),
                           p, f"{pre}.downsample.1", train)
        y = torch.relu(h + y)
    return dense(y.mean(dim=(2, 3)), p, "encoder.fc")


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.square().sum(-1) + 1e-12)


def loss(p: Dict[str, torch.Tensor], step: Dict[str, torch.Tensor],
         cfg, train: bool = True) -> torch.Tensor:
    """The triplet loss of one step (in eval mode with ``train`` False):
    ``step["obs"]`` the anchors' view-1 frames, ``step["pos"]`` their
    view-2 frames, ``step["neg"]`` the negatives' view-1 frames, all
    uint8."""
    a, pos, neg = (encode(p, normalize_tf(step[k]), cfg, train)
                   for k in ("obs", "pos", "neg"))
    return torch.clamp_min(_norm(a - pos) - _norm(a - neg) + MARGIN,
                           0.0).mean()


def train_steps(p: Dict[str, torch.Tensor], steps: List[Dict], cfg
                ) -> Dict[str, object]:
    """Adam over ``steps`` from the weights ``p`` (adam_steps' result)."""
    return adam_steps(p, trainable(param_spec(cfg)),
                      lambda q, s: loss(q, s, cfg), steps,
                      cfg["learning_rate"])


def encode_frames(p: Dict[str, torch.Tensor], frames_u8: torch.Tensor,
                  cfg) -> torch.Tensor:
    """The eval-mode states of uint8 NHWC frames."""
    with torch.no_grad():
        return encode(p, normalize_tf(frames_u8), cfg, False)


def _conv_out(n: int, k: int, s: int, pad: int) -> int:
    return (n + 2 * pad - k) // s + 1


def pool_inputs(cfg) -> List[tuple]:
    """(H, W, C) of the stem pool's input, NHWC (the only pool)."""
    return [(_conv_out(cfg["img_height"], 7, 2, 3),
             _conv_out(cfg["img_width"], 7, 2, 3), WIDTHS[0])]


def macs(cfg) -> Dict[str, List[tuple]]:
    """Multiply-adds of one encoder pass: (layer, MACs, whether its input
    takes a gradient in training)."""
    h = _conv_out(cfg["img_height"], 7, 2, 3)
    w = _conv_out(cfg["img_width"], 7, 2, 3)
    out = [("conv1", h * w * cfg["channels"] * WIDTHS[0] * 49, False)]
    h, w = _conv_out(h, 3, 2, 1), _conv_out(w, 3, 2, 1)
    for pre, cin, width, stride in _blocks():
        h2, w2 = _conv_out(h, 3, stride, 1), _conv_out(w, 3, stride, 1)
        out.append((f"{pre}.conv1", h2 * w2 * cin * width * 9, True))
        out.append((f"{pre}.conv2", h2 * w2 * width * width * 9, True))
        if cin != width:
            out.append((f"{pre}.downsample", h2 * w2 * cin * width, True))
        h, w = h2, w2
    out.append(("fc", WIDTHS[-1] * cfg["state_dim"], True))
    return {"encoder": out}


def step_parts(cfg) -> List[str]:
    """The parts one sample runs through in a train or eval step."""
    return ["encoder"] * ENCODER_PASSES
