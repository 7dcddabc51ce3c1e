"""Export a trained run of the port as a self-contained torch encoder (port
of ``srl_zoo_tpu/export/torch_export.py``).

A torch RL policy that loads the port's ``srl_model.pth`` needs this
package, and on a GPU the package builds its kernels with nvcc at first
use. The export writes an encoder that needs torch only:

    python -m srl_zoo_tpu_torch.export.torch_export --log-folder logs/<run>
    # then, anywhere torch runs:
    enc = torch.jit.load("logs/<run>/encoder_torch.pt").eval()
    states = enc(torch.from_numpy(obs_u8).float())   # NHWC, 0..255

* The encoder takes float NHWC in [0, 255] and applies the run's own
  normalization ("tf" or "image_net") inside, as ``(x - shift) / scale``
  with the JAX export's constants.
* It is built from torch's own layers, in float32 whatever the run's
  ``--dtype`` (a bfloat16 run's parameters are float32, and the JAX export
  builds the same float32 module from them): Conv2d, BatchNorm2d in eval
  mode, Linear, and pools that take relu, pad with -inf and run
  ``F.max_pool2d``, as the JAX export builds them. It never calls the
  port's fused relu + pool (ops/fused_pool.py), whose CUDA extension
  cannot be serialised; the port's own models keep it.
* custom_cnn takes XLA's 'SAME' pads, precomputed from the run's image
  size (``F.pad``, then an unpadded conv or pool); the flatten before the
  Dense runs in NHWC order, flax's. ResNet-18 has torchvision's explicit
  pads and names, whichever stem the run trained with (the "s2d" stem is
  the same convolution): ``--state-dict`` writes its weights under
  torchvision resnet18's keys, without the normalizer buffers, so they
  load into ``torchvision.models.resnet18(num_classes=<fc width>)`` (the
  fc width is state_dim, or 2 x state_dim for a VAE run: mu, then logvar).
* A VAE run's encoder returns mu, the first ``state_dim`` columns, as
  ``StateEncoder`` does.
* TorchScript by ``torch.jit.trace`` of a CPU copy of the weights (all
  control flow is fixed by the run's image size), so the artifact loads
  anywhere with ``torch.jit.load(path, map_location=...)``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from srl_zoo_tpu_torch.models.encoders import KERNEL_SIZES, WIDTH
from srl_zoo_tpu_torch.models.resnet import BLOCKS_PER_LAYER, WIDTHS
from srl_zoo_tpu_torch.ops.fused_pool import same_pads
from srl_zoo_tpu_torch.ops.preproc import IMAGENET_MEAN, IMAGENET_STD

ARTIFACT = "encoder_torch.pt"


def normalizer(mode: str, n_channels: int):
    """(shift, scale), float32 (1, C, 1, 1): x_norm = (x - shift) / scale
    for x in [0, 255]."""
    if mode == "tf":
        shift = scale = np.full(n_channels, 127.5, np.float32)
    elif mode == "image_net":
        reps = n_channels // 3
        shift = np.asarray(IMAGENET_MEAN * reps, np.float32) * 255.0
        scale = np.asarray(IMAGENET_STD * reps, np.float32) * 255.0
    else:
        raise ValueError(f"Unknown normalize mode: {mode}")
    return (torch.from_numpy(shift.reshape(1, -1, 1, 1).copy()),
            torch.from_numpy(scale.reshape(1, -1, 1, 1).copy()))


class _Normalized(nn.Module):
    """The normalizer buffers; ``normalize`` takes float NHWC in [0, 255]
    to normalized NCHW."""

    def __init__(self, cfg):
        super().__init__()
        shift, scale = normalizer(cfg.normalize_mode, cfg.n_channels)
        self.register_buffer("shift", shift)
        self.register_buffer("scale", scale)
        self.state_dim = cfg.state_dim

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return (x.permute(0, 3, 1, 2) - self.shift) / self.scale


class CustomCNNExport(_Normalized):
    """models/encoders.py CustomCNN with torch's layers, 'SAME' pads fixed
    from the run's image size."""

    def __init__(self, cfg, out_dim: int):
        super().__init__(cfg)
        self.convs = nn.ModuleList()
        self.bns = nn.ModuleList()
        self.conv_pads, self.pool_pads = [], []
        c, h, w = cfg.n_channels, cfg.img_height, cfg.img_width
        for k in KERNEL_SIZES:
            self.convs.append(nn.Conv2d(c, WIDTH, k, stride=2, bias=False))
            self.bns.append(nn.BatchNorm2d(WIDTH))
            # F.pad order: left, right, top, bottom
            self.conv_pads.append(same_pads(w, k, 2) + same_pads(h, k, 2))
            h, w = -(-h // 2), -(-w // 2)
            self.pool_pads.append(same_pads(w, 3, 2) + same_pads(h, 3, 2))
            h, w, c = -(-h // 2), -(-w // 2), WIDTH
        self.fc = nn.Linear(h * w * WIDTH, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.normalize(x)
        for conv, bn, cp, pp in zip(self.convs, self.bns, self.conv_pads,
                                    self.pool_pads):
            x = torch.relu(bn(conv(F.pad(x, cp))))
            x = F.max_pool2d(F.pad(x, pp, value=float("-inf")), 3, stride=2)
        x = x.permute(0, 2, 3, 1).flatten(1)  # flax flattens NHWC
        return self.fc(x)[:, :self.state_dim]


class _Block(nn.Module):
    def __init__(self, c_in: int, width: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, width, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.downsample: nn.Module = nn.Identity()
        if c_in != width:
            self.downsample = nn.Sequential(
                nn.Conv2d(c_in, width, 1, stride=stride, bias=False),
                nn.BatchNorm2d(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + self.downsample(x))


class ResNet18Export(_Normalized):
    """models/resnet.py ResNet18 (the direct stem) under torchvision
    resnet18's names."""

    def __init__(self, cfg, out_dim: int):
        super().__init__(cfg)
        self.conv1 = nn.Conv2d(cfg.n_channels, WIDTHS[0], 7, stride=2,
                               padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(WIDTHS[0])
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        c = WIDTHS[0]
        for i, width in enumerate(WIDTHS):
            blocks = []
            for b in range(BLOCKS_PER_LAYER):
                blocks.append(_Block(c, width, 2 if i > 0 and b == 0 else 1))
                c = width
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(c, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(self.normalize(x))))
        x = self.maxpool(x)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(x.mean(dim=(2, 3)))[:, :self.state_dim]


class DenseExport(_Normalized):
    """models/encoders.py DenseEncoder or LinearEncoder: flatten NHWC, a
    Dense stack with relu between."""

    def __init__(self, cfg, widths):
        super().__init__(cfg)
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(widths, widths[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.normalize(x).permute(0, 2, 3, 1).flatten(1)
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)[:, :self.state_dim]


def build_torch_encoder(cfg, state_dict: Dict[str, torch.Tensor]
                        ) -> nn.Module:
    """The run's encoder as a float32 module of torch layers on the CPU,
    in eval mode: float NHWC in [0, 255] -> (B, state_dim), mu for a VAE
    run. ``state_dict`` is the port's SRLModules state dict (its
    ``encoder.`` entries are read)."""
    sd = {k[len("encoder."):]: v.detach().to("cpu", torch.float32)
          if v.is_floating_point() else v.detach().cpu()
          for k, v in state_dict.items() if k.startswith("encoder.")}
    out_dim = 2 * cfg.state_dim if cfg.use_vae else cfg.state_dim
    if cfg.model_type == "custom_cnn":
        module = CustomCNNExport(cfg, out_dim)
    elif cfg.model_type == "resnet":
        module = ResNet18Export(cfg, out_dim)
    elif cfg.model_type in ("mlp", "linear"):
        n = len([k for k in sd if k.endswith(".weight")])
        module = DenseExport(cfg, [sd[f"layers.{i}.weight"].shape[1]
                                   for i in range(n)] + [out_dim])
    else:
        raise ValueError(f"Unknown model type: {cfg.model_type}")
    sd |= {"shift": module.shift, "scale": module.scale}
    module.load_state_dict(sd)
    return module.eval()


def export_torch_encoder(log_folder: str, out_path: str | None = None,
                         torchscript: bool = True, device=None) -> str:
    """Load the port run ``log_folder`` on ``device`` (default cuda) and
    write ``encoder_torch.pt`` (and its ``.json`` meta) from a CPU copy of
    its encoder: TorchScript (loadable with ``torch.jit.load`` alone) or,
    with ``torchscript=False``, a bare state dict without the normalizer
    buffers (torchvision's keys for resnet), whose user normalizes as the
    meta says."""
    from srl_zoo_tpu_torch import checkpoint as ckpt
    from srl_zoo_tpu_torch.utils.device import resolve_device

    cfg, model = ckpt.load_srl_model(log_folder, resolve_device(device))
    module = build_torch_encoder(cfg, model.state_dict())
    out_path = out_path or os.path.join(log_folder, ARTIFACT)
    if torchscript:
        example = torch.zeros((1, cfg.img_height, cfg.img_width,
                               cfg.n_channels))
        with torch.no_grad():
            torch.jit.trace(module, example).save(out_path)
    else:
        sd = module.state_dict()
        sd.pop("shift")
        sd.pop("scale")
        torch.save(sd, out_path)
    meta = {"input": "float32 NHWC in [0, 255] "
                     f"({cfg.img_height}x{cfg.img_width}x{cfg.n_channels})",
            "output": f"float32 (B, {cfg.state_dim}) states",
            "normalization": ("applied inside" if torchscript else
                              "NOT applied — apply yourself") +
                             f" ({cfg.normalize_mode})",
            "model_type": cfg.model_type,
            "torchscript": torchscript}
    with open(out_path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    return out_path


def main(argv=None) -> str:
    from srl_zoo_tpu_torch.utils.misc import printGreen
    p = argparse.ArgumentParser(
        description="Export a trained SRL encoder as a self-contained torch "
                    "module")
    p.add_argument("--log-folder", type=str, required=True)
    p.add_argument("--out", type=str, default=None,
                   help=f"Output path (default <log-folder>/{ARTIFACT})")
    p.add_argument("--state-dict", action="store_true",
                   help="Save a plain state_dict instead of TorchScript")
    p.add_argument("--device", type=str, default=None,
                   help="torch device the run loads on (default cuda)")
    args = p.parse_args(argv)
    path = export_torch_encoder(args.log_folder, args.out,
                                torchscript=not args.state_dict,
                                device=args.device)
    printGreen(f"Exported {path}")
    return path


if __name__ == "__main__":
    main()
