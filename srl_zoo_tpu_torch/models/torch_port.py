"""torchvision ResNet-18 weights for the port's encoder (port of
``srl_zoo_tpu/models/torch_port.py``).

The reference's ``--model-type resnet`` is torchvision's ImageNet-pretrained
ResNet-18 with its fc replaced by a ``state_dim`` head. Nothing is
downloaded: the user supplies a ``resnet18`` state dict (docs/PRETRAINED.md),
saved with ``torch.save`` (.pth) or ``numpy.savez`` (.npz). The port's
ResNet18 (models/resnet.py) has torchvision's names and layouts, so the
keys map one to one. ``fc`` is never taken: the encoder keeps its own
``state_dim`` head.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def load_ported_resnet18(path: str) -> Dict[str, torch.Tensor]:
    """A saved torchvision resnet18 state dict (.npz of arrays, or a .pth
    read with ``weights_only=True``) as a state dict of ResNet18, without
    ``fc``."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            sd = {k: torch.from_numpy(np.array(f[k])) for k in f.files}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in sd.items() if not k.startswith("fc.")}
