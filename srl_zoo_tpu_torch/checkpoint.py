"""The trained-model contract of a run folder: ``srl_model.pth`` (the
``torch.save`` of the SRLModules state dict, the reference's file name) and
``exp_config.json``. Port of ``srl_zoo_tpu/training/checkpoint.py``
``save_srl_model`` / ``load_srl_model``; full-state resume checkpoints wait
for the training slice.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

from srl_zoo_tpu_torch.config import SRLConfig
from srl_zoo_tpu_torch.models.srl_modules import SRLModules

MODEL_FILE = "srl_model.pth"


def write_state_dict(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """Atomic: a server loading the file never sees a torn write."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, path)


def save_srl_model(log_folder: str, model: SRLModules) -> str:
    os.makedirs(log_folder, exist_ok=True)
    model.cfg.save(log_folder)
    path = os.path.join(log_folder, MODEL_FILE)
    write_state_dict(path, model.state_dict())
    return path


def load_srl_model(log_folder: str, device: torch.device
                   ) -> Tuple[SRLConfig, SRLModules]:
    """Rebuild the model from exp_config.json and load its weights, in eval
    mode on ``device`` with channels_last activations."""
    cfg = SRLConfig.load(log_folder)
    model = SRLModules(cfg)
    sd = torch.load(os.path.join(log_folder, MODEL_FILE), map_location="cpu",
                    weights_only=True)
    model.load_state_dict(sd)
    model = model.to(device=device, memory_format=torch.channels_last)
    return cfg, model.eval()
